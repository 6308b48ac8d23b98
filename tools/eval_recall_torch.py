#!/usr/bin/env python3
"""Recall eval harness for two-stage retrieval on the PyTorch / CUDA
port: ``tools/eval_recall.py`` through ``repro_torch.core.SegmentedIndex``.

Builds a seeded synthetic token-set corpus with *known exact-Jaccard
ground truth*, sketches it with b-bit minwise hashing for b in {1, 2, 4}
(the Li & König accuracy/space trade-off curve), and measures recall@k
through the real index for both stages:

  * ``sketch``   — stage 1 only: top-k by sketch Hamming distance
  * ``reranked`` — two-stage: same trie survivors, exact-Jaccard
                   re-rank (``topk_batch(rerank="jaccard")``)

Ground truth is the exact Jaccard top-k over the whole corpus (ties
broken by id, the same order the re-rank select uses).  The corpus, the
sketches and the ground truth are the JAX tool's, so the report's
``sketch``, ``reranked`` and ``tau_star`` equal its numbers.

Usage::

    PYTHONPATH=src python tools/eval_recall_torch.py [--smoke] [--check]
        [--out recall.json] [--device cuda|cpu]

``--check`` exits non-zero unless, for every b, reranked recall@k >=
sketch-only recall@k and reranked recall@k >= the fixed floor.  On
``cuda`` the verify, scan and re-rank run through the hand-written
kernels; on ``cpu`` through their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from repro_torch.core import SegmentedIndex
from repro_torch.core.hamming import pack_sets

# the gate: two-stage recall@10 on the smoke corpus must not sink below
# this floor (seeded corpus -> deterministic up to f32 scoring)
RECALL_FLOOR = 0.60

_MERSENNE = (1 << 61) - 1


def build_corpus(rng, n_docs, vocab, set_min=8, set_max=40):
    """Token-id sets with planted near-duplicate structure: each doc is
    a fresh random set, queries are perturbed copies (drop + add a few
    tokens) so exact-Jaccard neighbourhoods are non-trivial."""
    return [rng.choice(vocab, size=int(rng.integers(set_min, set_max)),
                       replace=False) for _ in range(n_docs)]


def perturb(rng, s, vocab, frac=0.25):
    s = set(int(t) for t in s)
    n_swap = max(1, int(len(s) * frac))
    drop = rng.choice(sorted(s), size=min(n_swap, len(s) - 1),
                      replace=False)
    s -= set(int(t) for t in drop)
    while len(drop):
        s.add(int(rng.integers(0, vocab)))
        if len(s) >= n_swap:
            break
    return np.array(sorted(s), np.int64)


def minhash_sketch(sets, L, b, vocab, seed=0):
    """b-bit minwise hashing: L independent universal hash functions,
    keep the low b bits of each min-hash (Li & König)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, size=L, dtype=np.int64)
    c = rng.integers(0, _MERSENNE, size=L, dtype=np.int64)
    out = np.zeros((len(sets), L), np.uint8)
    for i, s in enumerate(sets):
        t = np.asarray(s, np.int64)[:, None]                 # (|s|, 1)
        h = (t * a[None, :] + c[None, :]) % _MERSENNE        # (|s|, L)
        out[i] = (h.min(axis=0) & ((1 << b) - 1)).astype(np.uint8)
    return out


def exact_jaccard_topk(q_pays, doc_pays, k):
    """Ground truth: exact Jaccard over payload bitmaps, (score desc,
    id asc) — the re-rank select's exact ordering."""
    def pop(x):
        return np.unpackbits(np.ascontiguousarray(x, np.uint32)
                             .view(np.uint8), axis=-1).sum(axis=-1)
    inter = pop(q_pays[:, None, :] & doc_pays[None, :, :]).astype(np.float64)
    union = (pop(q_pays).astype(np.float64)[:, None]
             + pop(doc_pays).astype(np.float64)[None, :] - inter)
    jac = np.where(union > 0, inter / np.maximum(union, 1), 0.0)
    n = doc_pays.shape[0]
    order = np.lexsort((np.arange(n)[None, :].repeat(len(q_pays), 0),
                        -jac))                               # score desc, id asc
    return order[:, :k]


def recall_at_k(retrieved, truth):
    """Mean |retrieved ∩ truth| / k over queries (−1 pads never match)."""
    hits = sum(len(set(map(int, r)) & set(map(int, t)))
               for r, t in zip(retrieved, truth))
    return hits / float(truth.size)


def evaluate(n_docs=2000, n_queries=40, vocab=256, L=48, bs=(1, 2, 4),
             k=10, seed=0, delta_cap=512, cand_mult=10, device="cuda"):
    """Run the sweep on ``device``; returns ``{"k": k, "rows": [{b,
    sketch, reranked, tau_star}, ...]}``.

    The two-stage path uses the candidate-pool knob: stage 1 runs the
    ladder until ``cand_mult * k`` survivors, stage 2 exact-scores every
    survivor, and the report keeps the top k, so reranked recall@k
    equals the survivor-coverage ceiling."""
    rng = np.random.default_rng(seed)
    docs = build_corpus(rng, n_docs, vocab)
    queries = [perturb(rng, docs[int(rng.integers(0, n_docs))], vocab)
               if i % 2 == 0 else build_corpus(rng, 1, vocab)[0]
               for i in range(n_queries)]
    doc_pays = pack_sets(docs, vocab)
    q_pays = pack_sets(queries, vocab)
    truth = exact_jaccard_topk(q_pays, doc_pays, k)
    Wp = doc_pays.shape[1]
    rows = []
    for b in bs:
        sk = minhash_sketch(docs, L, b, vocab, seed=seed + 1)
        qk = minhash_sketch(queries, L, b, vocab, seed=seed + 1)
        idx = SegmentedIndex(L, b, delta_cap=delta_cap, payload_words=Wp,
                             device=device)
        ids = idx.insert(sk, payloads=doc_pays)
        assert np.array_equal(ids, np.arange(n_docs))
        plain = idx.topk_batch(qk, k)
        kc = min(cand_mult * k, n_docs)
        rer = idx.topk_batch(qk, kc, rerank="jaccard", q_payloads=q_pays)
        rer_ids = rer.ids.cpu().numpy()[:, :k]
        rows.append({
            "b": int(b),
            "sketch": round(recall_at_k(plain.ids.cpu().numpy(), truth), 4),
            "reranked": round(recall_at_k(rer_ids, truth), 4),
            "tau_star": int(rer.tau),
        })
    return {"k": int(k), "n_docs": int(n_docs), "L": int(L),
            "vocab": int(vocab), "seed": int(seed), "rows": rows}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny corpus (seconds, same assertions)")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless reranked >= sketch-only "
                         f"and reranked >= {RECALL_FLOOR} for every b")
    ap.add_argument("--out", default=None, help="write JSON report here")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    kw = dict(n_docs=600, n_queries=20, L=32, delta_cap=256) \
        if args.smoke else {}
    report = evaluate(k=args.k, device=args.device, **kw)
    print(f"# recall@{report['k']} on n={report['n_docs']} docs, "
          f"L={report['L']}, vocab={report['vocab']}, {args.device}")
    print("b,sketch_only,reranked,tau_star")
    for row in report["rows"]:
        print(f"{row['b']},{row['sketch']:.4f},{row['reranked']:.4f},"
              f"{row['tau_star']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
        print(f"# wrote {args.out}")
    if args.check:
        bad = [r for r in report["rows"]
               if r["reranked"] < r["sketch"]
               or r["reranked"] < RECALL_FLOOR]
        if bad:
            print(f"RECALL GATE FAILED (floor {RECALL_FLOOR}): {bad}",
                  file=sys.stderr)
            return 1
        print(f"# recall gate passed: reranked >= sketch-only and >= "
              f"{RECALL_FLOOR} for every b")
    return 0


if __name__ == "__main__":
    sys.exit(main())
