"""Durable index store: atomic segment snapshots, a CRC-framed
delta-buffer WAL, recover-on-start, and the fault-injection harness that
proves every fsync/rename boundary by enumeration — the port of
``repro.store``, with the JAX package's on-disk format."""

from .atomic import (atomic_write_bytes, atomic_write_dir, atomic_write_json,
                     fsync_dir, read_json, sweep_stale_tmp)
from .faults import CrashPoint, FaultInjector
from .store import CollectionStore, StackBinding
from .wal import (OP_DELETE, OP_INSERT, WriteAheadLog, decode_delete,
                  decode_insert, encode_delete, encode_insert, read_wal)

__all__ = [
    "CollectionStore", "StackBinding", "WriteAheadLog", "read_wal",
    "OP_INSERT", "OP_DELETE", "encode_insert", "decode_insert",
    "encode_delete", "decode_delete", "CrashPoint", "FaultInjector",
    "atomic_write_bytes", "atomic_write_json", "atomic_write_dir",
    "fsync_dir", "read_json", "sweep_stale_tmp",
]
