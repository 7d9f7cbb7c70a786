"""Sharding rules and pipeline parallelism over a mesh: the counterpart of
``repro.distributed``."""
