"""Append-only, CRC-framed, fsync-batched write-ahead log for the delta
buffer — a copy of ``repro.store.wal``: the same framing, so a journal
written by either package replays in the other, byte for byte.

The mutable delta buffer is the only part of a segmented index that is
not an immutable on-disk snapshot, and it is exactly WAL-shaped: a short
ordered run of ``insert``/``delete`` records since the last flush.  The
log is truncated (whole-file, atomically) only at checkpoints where every
delta buffer in the collection is empty, so recovery never needs a
sequence watermark: manifest segments + full WAL replay reconstructs the
exact pre-crash state (replay filters inserts whose ids already landed in
a sealed segment, and deletes are idempotent).

On-disk framing (little-endian)::

    header:  magic  "bSTW" | version u8 | base_seq u64
    record:  magic u32 | seq u64 | op u8 | payload_len u32 | crc32 u32
             | payload

``crc32`` covers ``seq || op || payload``.  A torn or corrupt tail —
short header, bad record magic, truncated payload, CRC mismatch, or a
sequence break — ends replay at the last good record: dropped, never
crashed on.  That is the correct durability contract: a record the OS
never fully persisted was never acknowledged as synced.

Writes are buffered *in Python memory* and only reach the OS at sync
points (every ``fsync_every`` records, or an explicit :meth:`sync`).
This makes the fault-injection harness honest: a simulated crash between
syncs genuinely loses the unsynced tail, exactly like power loss.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from .atomic import atomic_write_bytes, fsync_dir

_FILE_MAGIC = b"bSTW"
_VERSION = 1
_HEADER = struct.Struct("<4sBQ")           # magic, version, base_seq
_FRAME = struct.Struct("<IQBII")           # magic, seq, op, len, crc
_REC_MAGIC = 0x57A17EC5

OP_INSERT = 1
OP_DELETE = 2
OP_INSERT_PAYLOAD = 3      # insert carrying re-rank payload bitmaps


def _crc(seq: int, op: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(struct.pack("<QB", seq, op)))


def encode_insert(ids: np.ndarray, sk: np.ndarray) -> bytes:
    """``insert`` payload: n u32 | L u16 | ids int64[n] | sketches u8[n,L]."""
    ids = np.ascontiguousarray(ids, np.int64)
    sk = np.ascontiguousarray(sk, np.uint8)
    n, L = sk.shape
    return struct.pack("<IH", n, L) + ids.tobytes() + sk.tobytes()


def decode_insert(payload: bytes) -> Tuple[np.ndarray, np.ndarray]:
    n, L = struct.unpack_from("<IH", payload)
    off = 6
    ids = np.frombuffer(payload, np.int64, n, off)
    sk = np.frombuffer(payload, np.uint8, n * L, off + 8 * n).reshape(n, L)
    return ids.copy(), sk.copy()


def encode_insert_payload(ids: np.ndarray, sk: np.ndarray,
                          pay: np.ndarray) -> bytes:
    """``insert`` payload with re-rank bitmaps: n u32 | L u16 | Wp u16 |
    ids int64[n] | sketches u8[n,L] | bitmaps u32[n,Wp]."""
    ids = np.ascontiguousarray(ids, np.int64)
    sk = np.ascontiguousarray(sk, np.uint8)
    pay = np.ascontiguousarray(pay, np.uint32)
    n, L = sk.shape
    Wp = pay.shape[1]
    return (struct.pack("<IHH", n, L, Wp) + ids.tobytes() + sk.tobytes()
            + pay.tobytes())


def decode_insert_payload(
        payload: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    n, L, Wp = struct.unpack_from("<IHH", payload)
    off = 8
    ids = np.frombuffer(payload, np.int64, n, off)
    off += 8 * n
    sk = np.frombuffer(payload, np.uint8, n * L, off).reshape(n, L)
    off += n * L
    pay = np.frombuffer(payload, np.uint32, n * Wp, off).reshape(n, Wp)
    return ids.copy(), sk.copy(), pay.copy()


def encode_delete(ids: np.ndarray) -> bytes:
    ids = np.ascontiguousarray(ids, np.int64)
    return struct.pack("<I", len(ids)) + ids.tobytes()


def decode_delete(payload: bytes) -> np.ndarray:
    (n,) = struct.unpack_from("<I", payload)
    return np.frombuffer(payload, np.int64, n, 4).copy()


def read_wal(path: str) -> Tuple[int, List[Tuple[int, int, bytes]], int]:
    """Scan a WAL file.  Returns ``(base_seq, records, dropped_bytes)``
    where ``records`` is ``[(seq, op, payload), ...]`` in order and
    ``dropped_bytes`` counts the torn/corrupt tail that was discarded."""
    if not os.path.exists(path):
        return 0, [], 0
    with open(path, "rb") as f:
        blob = f.read()
    if len(blob) < _HEADER.size:
        return 0, [], len(blob)
    magic, version, base_seq = _HEADER.unpack_from(blob)
    if magic != _FILE_MAGIC or version != _VERSION:
        return 0, [], len(blob)
    records: List[Tuple[int, int, bytes]] = []
    off = _HEADER.size
    expect = base_seq
    while off + _FRAME.size <= len(blob):
        magic, seq, op, length, crc = _FRAME.unpack_from(blob, off)
        end = off + _FRAME.size + length
        if (magic != _REC_MAGIC or seq != expect or end > len(blob)):
            break
        payload = blob[off + _FRAME.size:end]
        if _crc(seq, op, payload) != crc:
            break
        records.append((seq, op, payload))
        expect = seq + 1
        off = end
    return base_seq, records, len(blob) - off


class WriteAheadLog:
    """Durable insert/delete journal for one collection's delta buffers.

    ``fsync_every=1`` gives per-record durability (the fault harness uses
    this so every acknowledged op is recoverable); the serving default
    batches fsyncs, trading a bounded acknowledged-but-lost window for
    ingest throughput.
    """

    def __init__(self, path: str, *, fsync_every: int = 64, faults=None):
        self.path = path
        self.fsync_every = max(1, int(fsync_every))
        self.faults = faults
        self._buf = bytearray()
        self._pending = 0
        self._fh = None
        base, records, dropped = read_wal(path)
        self.base_seq = base
        self.next_seq = records[-1][0] + 1 if records else base
        self.dropped_bytes = dropped
        if not os.path.exists(path):
            self._rewrite_header(0)
        elif dropped:
            # cut the torn/corrupt tail so new appends extend the good
            # prefix (a crash mid-truncate just leaves a shorter tail
            # that the next replay drops again)
            good = os.path.getsize(path) - dropped
            if good < _HEADER.size:
                self._rewrite_header(0)
            else:
                with open(path, "r+b") as f:
                    f.truncate(good)
                    f.flush()
                    os.fsync(f.fileno())

    # -- write path ----------------------------------------------------

    def append(self, op: int, payload: bytes) -> int:
        """Frame and buffer one record; syncs every ``fsync_every``
        records.  Returns the record's sequence number."""
        seq = self.next_seq
        self.next_seq += 1
        self._buf += _FRAME.pack(_REC_MAGIC, seq, op, len(payload),
                                 _crc(seq, op, payload))
        self._buf += payload
        self._pending += 1
        if self._pending >= self.fsync_every:
            self.sync()
        return seq

    def sync(self) -> None:
        """Write buffered records and fsync.  Crash points:
        ``wal:pre-write``, ``wal:pre-fsync``, ``wal:post-fsync``."""
        if not self._buf:
            return
        if self.faults is not None:
            self.faults.hit("wal:pre-write")
        if self._fh is None:
            self._fh = open(self.path, "ab")
        self._fh.write(bytes(self._buf))
        self._fh.flush()
        if self.faults is not None:
            self.faults.hit("wal:pre-fsync")
        os.fsync(self._fh.fileno())
        if self.faults is not None:
            self.faults.hit("wal:post-fsync")
        self._buf.clear()
        self._pending = 0

    def reset(self) -> None:
        """Truncate: atomically replace the log with a fresh header whose
        ``base_seq`` continues the sequence (so seqs never repeat across
        truncations).  Called only when every delta buffer is empty and
        persisted — buffered-but-unsynced records are dropped with it."""
        self._buf.clear()
        self._pending = 0
        self._rewrite_header(self.next_seq)

    def _rewrite_header(self, base_seq: int) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self.base_seq = base_seq
        self.next_seq = base_seq
        atomic_write_bytes(self.path,
                           _HEADER.pack(_FILE_MAGIC, _VERSION, base_seq),
                           faults=self.faults, label="wal-reset")

    # -- observability ---------------------------------------------------

    def size_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0

    def close(self) -> None:
        self.sync()
        if self._fh is not None:
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None
        d = os.path.dirname(os.path.abspath(self.path))
        if os.path.isdir(d):
            fsync_dir(d)
