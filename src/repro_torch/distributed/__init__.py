"""Checkpointing and fault tolerance on one card: ``checkpoint``,
``fault_tolerance`` and ``compression``."""
