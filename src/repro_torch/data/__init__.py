"""Deterministic synthetic data (the counterpart of ``repro.data``)."""
