"""Fault-tolerant checkpoints (the counterpart of ``repro.checkpoint``)."""
