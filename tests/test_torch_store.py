"""The port's durable store (``repro_torch.store``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_durability.py`` on the port — WAL framing (round
trip, torn tail, CRC corruption, reset, garbage header), snapshot and
restore on every backend, truncation once the deltas seal, the stale-tmp
and orphan sweep, the registry's ``open`` — and adds where the two
packages meet:

  * **cross-package recovery** in both directions: a data directory
    written by one package's ``CollectionRegistry`` opens in the other's
    and answers top-k, range and the Jaccard re-rank exactly as the
    writer's index did (ids, distances, τ*, float32 score bits);
  * **byte-identical files**: the journal of one op sequence, and every
    segment's ``arrays.npz`` / ``live.npy``, are the same bytes in both
    packages.

The crash-at-every-point enumeration (``tests/test_torch_store_crash.py``)
holds each recovered index against the port's own never-crashed one.
Tolerance: bit-exact; every output is an integer, a bool or a float32
bit pattern.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro import serving as jserving
from repro import store as jstore
from repro.core import segments as jseg
from repro_torch import serving as tserving
from repro_torch.core.hamming import pack_sets
from repro_torch.core.segments import SegmentedIndex, ShardedSegmentedIndex
from repro_torch.serving import CollectionConfig, CollectionRegistry
from repro_torch.store import (OP_DELETE, OP_INSERT, CollectionStore,
                               WriteAheadLog, decode_delete, decode_insert,
                               encode_delete, encode_insert, read_wal)

L, B = 8, 2
ROWS = np.random.default_rng(7).integers(0, 1 << B, size=(32, L),
                                         dtype=np.uint8)


def _stacks(index):
    return list(index.shards) if hasattr(index, "shards") else [index]


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# WAL framing
# ---------------------------------------------------------------------------

def _fill_wal(path, n=5):
    wal = WriteAheadLog(path, fsync_every=1)
    for i in range(n):
        if i % 3 == 2:
            wal.append(OP_DELETE,
                       encode_delete(np.arange(i, dtype=np.int64)))
        else:
            ids = np.arange(i * 3, i * 3 + 3, dtype=np.int64)
            wal.append(OP_INSERT, encode_insert(ids, ROWS[:3]))
    wal.close()


def test_wal_roundtrip_same_bytes_as_jax(tmp_path):
    path = str(tmp_path / "wal.log")
    _fill_wal(path)
    base, records, dropped = read_wal(path)
    assert (base, dropped) == (0, 0)
    assert [seq for seq, _, _ in records] == [0, 1, 2, 3, 4]
    ids, sk = decode_insert(records[0][2])
    np.testing.assert_array_equal(ids, [0, 1, 2])
    np.testing.assert_array_equal(sk, ROWS[:3])
    assert records[2][1] == OP_DELETE
    np.testing.assert_array_equal(decode_delete(records[2][2]), [0, 1])
    # the JAX package writes the same bytes and reads the port's log
    jpath = str(tmp_path / "jwal.log")
    wal = jstore.WriteAheadLog(jpath, fsync_every=1)
    for i in range(5):
        if i % 3 == 2:
            wal.append(jstore.OP_DELETE,
                       jstore.encode_delete(np.arange(i, dtype=np.int64)))
        else:
            wal.append(jstore.OP_INSERT, jstore.encode_insert(
                np.arange(i * 3, i * 3 + 3, dtype=np.int64), ROWS[:3]))
    wal.close()
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    assert jstore.read_wal(path)[1] == records


def test_wal_torn_tail_dropped_and_cut(tmp_path):
    path = str(tmp_path / "wal.log")
    _fill_wal(path)
    with open(path, "r+b") as f:            # tear the last record
        f.truncate(os.path.getsize(path) - 7)
    base, records, dropped = read_wal(path)
    assert len(records) == 4 and dropped > 0
    wal = WriteAheadLog(path, fsync_every=1)
    assert wal.dropped_bytes > 0 and wal.next_seq == 4
    wal.append(OP_DELETE, encode_delete(np.asarray([9], np.int64)))
    wal.close()
    _, records, dropped = read_wal(path)
    assert [seq for seq, _, _ in records] == [0, 1, 2, 3, 4]
    assert dropped == 0
    np.testing.assert_array_equal(decode_delete(records[-1][2]), [9])


def test_wal_crc_corruption_ends_replay(tmp_path):
    path = str(tmp_path / "wal.log")
    _fill_wal(path)
    _, records, _ = read_wal(path)
    frame = 21                              # <IQBII> record frame bytes
    off = 13                                # <4sBQ> file header bytes
    for seq, _, payload in records[:2]:
        off += frame + len(payload)
    with open(path, "r+b") as f:            # flip a byte in record 2's
        f.seek(off + frame + 1)             # payload: CRC must reject it
        byte = f.read(1)
        f.seek(off + frame + 1)
        f.write(bytes([byte[0] ^ 0xFF]))
    _, records, dropped = read_wal(path)
    assert [seq for seq, _, _ in records] == [0, 1]
    assert dropped > 0


def test_wal_reset_continues_sequence(tmp_path):
    path = str(tmp_path / "wal.log")
    wal = WriteAheadLog(path, fsync_every=1)
    for i in range(3):
        wal.append(OP_DELETE, encode_delete(np.asarray([i], np.int64)))
    wal.reset()
    base, records, dropped = read_wal(path)
    assert (base, records, dropped) == (3, [], 0)
    assert wal.append(OP_DELETE,
                      encode_delete(np.asarray([7], np.int64))) == 3
    wal.close()
    _, records, _ = read_wal(path)
    assert [seq for seq, _, _ in records] == [3]   # seqs never repeat


def test_wal_garbage_header_dropped(tmp_path):
    path = str(tmp_path / "wal.log")
    with open(path, "wb") as f:
        f.write(b"not a wal at all")
    base, records, dropped = read_wal(path)
    assert (base, records) == (0, []) and dropped > 0
    wal = WriteAheadLog(path, fsync_every=1)   # rewrites a fresh header
    assert wal.next_seq == 0 and wal.dropped_bytes > 0
    wal.append(OP_DELETE, encode_delete(np.asarray([1], np.int64)))
    wal.close()
    assert len(read_wal(path)[1]) == 1


# ---------------------------------------------------------------------------
# snapshot/restore round-trip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["bst", "multi", "sharded", "stacks"])
def test_snapshot_restore_roundtrip(tmp_path, kind):
    def mk():
        if kind == "stacks":
            return ShardedSegmentedIndex(L, B, 2, delta_cap=8, device="cpu")
        return SegmentedIndex(L, B, delta_cap=8, backend=kind, device="cpu")

    d = str(tmp_path / "c")
    store = CollectionStore(d, fsync_every=4)
    index = store.attach(mk())
    ids = index.insert(ROWS[:30])
    index.delete(ids[::5])
    index.insert(ROWS[30:])                 # leaves unsealed delta rows
    store.wal.sync()
    qs = ROWS[:3]
    pre = index.topk_batch(qs, 3)
    pre_serials = [tuple(s.serial for s in st.segments)
                   for st in _stacks(index)]
    pre_ledger = index.space_ledger()       # after the warm query
    # hard kill: abandon the store without close()

    store2 = CollectionStore(d, fsync_every=4)
    rec = store2.recover(mk())
    post = rec.topk_batch(qs, 3)
    np.testing.assert_array_equal(np_(pre.ids), np_(post.ids))
    np.testing.assert_array_equal(np_(pre.dists), np_(post.dists))
    assert pre.tau == post.tau
    assert rec.n_ids == index.n_ids and rec.n_live == index.n_live
    assert store2.counters["replayed_records"] > 0
    # segment serials are restored verbatim from the manifests
    assert [tuple(s.serial for s in st.segments)
            for st in _stacks(rec)] == pre_serials
    assert rec.space_ledger() == pre_ledger

    # the id allocator resumes collision-free ...
    n0 = rec.n_ids
    new_ids = rec.insert(ROWS[:2])
    np.testing.assert_array_equal(new_ids, [n0, n0 + 1])
    # ... and so does the serial counter: freshly sealed segments must
    # never reuse a recovered serial (the cache-key invariant)
    top = max(s for serials in pre_serials for s in serials)
    rec.flush()
    fresh = [s.serial for st in _stacks(rec) for s in st.segments
             if s.serial not in {x for ser in pre_serials for x in ser}]
    assert fresh and min(fresh) > top
    store2.close()


# ---------------------------------------------------------------------------
# checkpoint / truncation / sweep mechanics
# ---------------------------------------------------------------------------

def test_wal_truncated_once_deltas_seal(tmp_path):
    store = CollectionStore(str(tmp_path / "c"), fsync_every=1)
    index = store.attach(SegmentedIndex(L, B, delta_cap=8, device="cpu"))
    index.insert(ROWS[:16])                 # flush seals everything
    assert store.counters["wal_truncations"] >= 1
    header_only = store.wal.size_bytes()
    assert store.wal.base_seq >= 1          # seqs never restart at 0
    index.insert(ROWS[16:19])               # unsealed rows journal again
    store.wal.sync()
    assert store.wal.size_bytes() > header_only
    store.close()


def test_store_sweeps_stale_tmp_and_orphan_segments(tmp_path):
    d = str(tmp_path / "c")
    store = CollectionStore(d, fsync_every=1)
    index = store.attach(SegmentedIndex(L, B, delta_cap=8, device="cpu"))
    index.insert(ROWS[:12])
    store.close()
    # a crash between a segment rename and its manifest write leaves an
    # orphan segment dir; a crash mid-write leaves a stale tmp file
    orphan = os.path.join(d, "seg_000000009999")
    os.makedirs(orphan)
    with open(os.path.join(orphan, "junk.bin"), "wb") as f:
        f.write(b"x" * 32)
    with open(os.path.join(d, "MANIFEST.json.tmp-999"), "w") as f:
        f.write("{")
    store2 = CollectionStore(d, fsync_every=1)
    assert store2.counters["swept_tmp"] == 1
    rec = store2.recover(SegmentedIndex(L, B, delta_cap=8, device="cpu"))
    assert not os.path.exists(orphan)
    assert rec.n_live == 12
    store2.close()


def test_registry_open_recovers_collections(tmp_path):
    d = str(tmp_path / "data")
    reg = CollectionRegistry(data_dir=d, fsync_every=4, device="cpu")
    alpha = reg.create("alpha", CollectionConfig(L=L, b=B, delta_cap=8))
    beta = reg.create("beta.2",
                      CollectionConfig(L=L, b=B, delta_cap=4, n_stacks=2))
    ids = alpha.index.insert(ROWS[:20])
    alpha.index.delete(ids[:4])
    beta.index.insert(ROWS[:10])
    pre = alpha.index.topk_batch(ROWS[:3], 3)
    reg.close()

    reg2 = CollectionRegistry.open(d, device="cpu")
    assert reg2.names() == ["alpha", "beta.2"]
    a2 = reg2.get("alpha")
    assert a2.config == alpha.config        # config round-trips via json
    assert a2.index.device == torch.device("cpu")
    post = a2.index.topk_batch(ROWS[:3], 3)
    np.testing.assert_array_equal(np_(pre.ids), np_(post.ids))
    np.testing.assert_array_equal(np_(pre.dists), np_(post.dists))
    assert a2.index.n_live == 16
    assert reg2.get("beta.2").index.n_live == 10
    with pytest.raises(ValueError):         # durable names hit the disk
        reg2.create("bad/name", CollectionConfig(L=L, b=B))
    reg2.close()


def test_registry_device_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CollectionRegistry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CollectionRegistry.open(str(tmp_path / "none"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CollectionConfig(L=L, b=B).create()


# ---------------------------------------------------------------------------
# where the packages meet: cross-package recovery, identical bytes
# ---------------------------------------------------------------------------

XL, XB, VOCAB = 16, 2, 64
WP = (VOCAB + 31) // 32


def _x_corpus(seed=3, n=260):
    rng = np.random.default_rng(seed)
    sk = rng.integers(0, 1 << XB, size=(n, XL), dtype=np.uint8)
    sk[-20:] = sk[:20]                      # ties at distance 0
    sets = [rng.choice(VOCAB, size=int(rng.integers(2, 14)), replace=False)
            for _ in range(n)]
    return sk, pack_sets(sets, VOCAB)


def _x_config(pkg, kind):
    kw = dict(L=XL, b=XB, delta_cap=48, payload_words=WP)
    if kind == "stacks":
        kw["n_stacks"] = 2
    elif kind != "bst":
        kw["backend"] = kind
    return pkg.CollectionConfig(**kw)


def _x_workload(index, sk, pays):
    """Inserts that seal, merge and leave a live delta; deletes in sealed
    segments and in the delta; one compaction."""
    for lo in range(0, 200, 40):
        index.insert(sk[lo:lo + 40], payloads=pays[lo:lo + 40])
    index.delete(np.arange(0, 200, 9))
    index.compact(min_dead_frac=0.05)
    index.insert(sk[200:206], payloads=pays[200:206])   # a live delta
    index.delete(np.asarray([3, 203, 205], np.int64))


def _x_answers(index, sk, pays):
    qs, qp = sk[[0, 5, 77, 203, 259]], pays[[0, 5, 77, 203, 259]]
    top = index.topk_batch(qs, 6)
    rng = index.search_batch(qs, 3)
    rr = index.topk_batch(qs, 6, rerank="jaccard", q_payloads=qp)
    return {"ids": np_(top.ids), "dists": np_(top.dists), "tau": top.tau,
            "mask": np_(rng.mask), "dist": np_(rng.dist),
            "r_ids": np_(rr.ids), "r_dists": np_(rr.dists), "r_tau": rr.tau,
            "r_score_bits": np_(rr.scores).view(np.int32)}


@pytest.mark.parametrize("kind", ["bst", "stacks", "multi"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cross_package_recovery(tmp_path, writer, kind):
    """One package writes a durable collection and is killed (no
    close); the other opens the directory and answers exactly as the
    writer's index did; the next insert takes the next id."""
    sk, pays = _x_corpus()
    d = str(tmp_path / "data")
    if writer == "jax":
        wreg = jserving.CollectionRegistry(d, fsync_every=1)
        wcfg = _x_config(jserving, kind)
    else:
        wreg = CollectionRegistry(d, fsync_every=1, device="cpu")
        wcfg = _x_config(tserving, kind)
    coll = wreg.create("c", wcfg)
    _x_workload(coll.index, sk, pays)
    want = _x_answers(coll.index, sk, pays)
    n_ids, n_live = coll.index.n_ids, coll.index.n_live
    delta = sum(len(st._delta_ids) for st in _stacks(coll.index))
    assert delta > 0                        # the journal carries rows
    coll.store.wal.sync()                   # then a hard kill: no close()

    reg = (CollectionRegistry.open(d, device="cpu") if writer == "jax"
           else jserving.CollectionRegistry.open(d))
    rec = reg.get("c")
    assert dataclasses.asdict(rec.config) == dataclasses.asdict(wcfg)
    assert rec.store.counters["replayed_records"] > 0
    assert (rec.index.n_ids, rec.index.n_live) == (n_ids, n_live)
    got = _x_answers(rec.index, sk, pays)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    new = rec.index.insert(sk[:1], payloads=pays[:1])
    assert int(new[0]) == n_ids
    reg.close()


def _segment_files(root):
    """(arrays.npz members, live.npy) of every segment, in manifest
    order, with the manifest's non-serial fields."""
    man = json.load(open(os.path.join(root, "MANIFEST.json")))
    out = []
    for ent in man["segments"]:
        d = os.path.join(root, f"seg_{ent['serial']:012d}")
        with np.load(os.path.join(d, "arrays.npz")) as arr:
            out.append({k: arr[k] for k in sorted(arr.files)})
        out[-1]["live"] = np.load(os.path.join(d, "live.npy"))
        meta = json.load(open(os.path.join(d, "meta.json")))
        out[-1]["meta"] = (meta["n"], meta["L"], meta["b"])
    return man["n_ids"], [(e["n"], e["n_dead"]) for e in man["segments"]], \
        out


def test_journal_and_snapshots_byte_identical(tmp_path):
    """The same op sequence journals the same bytes in both packages —
    checked after every op, before and after each truncation — and
    snapshots the same segment arrays."""
    sk, pays = _x_corpus(seed=11, n=150)
    roots = {p: str(tmp_path / p) for p in ("jax", "torch")}
    jst = jstore.CollectionStore(roots["jax"], fsync_every=1)
    jidx = jst.attach(jseg.SegmentedIndex(XL, XB, delta_cap=32,
                                          payload_words=WP))
    tst = CollectionStore(roots["torch"], fsync_every=1)
    tidx = tst.attach(SegmentedIndex(XL, XB, delta_cap=32, payload_words=WP,
                                     device="cpu"))
    ops = []
    for lo in range(0, 150, 25):
        ops.append(("insert", lo, lo + 25))
        ops.append(("delete", np.arange(lo, lo + 25, 6)))
    ops.append(("compact",))
    checked = 0
    for op in ops:
        for idx in (jidx, tidx):
            if op[0] == "insert":
                idx.insert(sk[op[1]:op[2]], payloads=pays[op[1]:op[2]])
            elif op[0] == "delete":
                idx.delete(op[1])
            else:
                idx.compact()
        a = open(os.path.join(roots["jax"], "wal.log"), "rb").read()
        b = open(os.path.join(roots["torch"], "wal.log"), "rb").read()
        assert a == b, op
        checked += len(a) > 13               # records past the header
    assert checked >= 4 and jst.counters["wal_truncations"] >= 2
    assert tst.counters == jst.counters
    jn, jsegs, jfiles = _segment_files(roots["jax"])
    tn, tsegs, tfiles = _segment_files(roots["torch"])
    assert (tn, tsegs) == (jn, jsegs) and len(tfiles) >= 2
    for jf, tf in zip(jfiles, tfiles):
        assert jf.keys() == tf.keys()
        for key in jf:
            if key == "meta":
                assert tf[key] == jf[key]
            else:
                assert tf[key].dtype == jf[key].dtype
                np.testing.assert_array_equal(tf[key], jf[key])
