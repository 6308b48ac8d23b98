"""Checkpointing, fault tolerance and sharding: ``checkpoint``,
``fault_tolerance``, ``compression`` and ``sharding`` (the rules that
place parameters, caches and batches on a mesh's ranks)."""
