"""Serving entry point: batched autoregressive generation, plus the
paper's sketch-retrieval plane — the port of the JAX package's
``launch/serve.py``.  Every mode runs on ``--device`` (default ``cuda``;
raises without a card; ``--device cpu`` runs the plain kernels).

``python -m repro_torch.launch.serve --arch smollm-135m --smoke
--device cpu`` — prefill a batch of prompts and decode N tokens
(greedy), reporting tokens/s.  Weights are random, drawn from
``--seed``; prompts are uniform token ids from ``--seed``.  On the card
the matrices compute in bf16 from f32 masters and the prefill attention
goes through the CUDA flash kernel; on the CPU everything is f32.

Generation runs under the host mesh (``launch.mesh.make_host_mesh``:
every rank on a "data" axis), as the JAX package's does.  Under
``python -m torch.distributed.run --standalone --nproc-per-node N -m
repro_torch.launch.serve ...`` each rank prefills and decodes its B/N
rows (nccl when every rank has a card of its own, gloo when they share
one or run on the CPU) and rank 0 gathers the tokens and prints them;
one process is a mesh of one rank.  ``--model-ranks M`` lays the N ranks
out as a (N / M, M) mesh over ("data", "model") instead: each rank
computes on its slices of the placement (``distributed.sharding``: the
dense layers' heads, ffn and vocabulary over "model", where M divides
them; the experts), cut from the whole parameters as views
(``models.model._gathered``), and runs the dense layers tensor parallel.

``--retrieval`` additionally runs the retrieval plane: the requests'
last-step logits, mixed over the embedding table, are 0-bit-CWS-sketched
and submitted as *individual* range and top-k requests to the serving
scheduler (``repro_torch.serving``), which coalesces them into
shape-bucketed dispatches.  The CWS draws come from the host generator
``torch.Generator().manual_seed(7)`` on every device (the JAX package
draws from ``PRNGKey(7)``, so the two packages' sketches differ unless
the draws are carried across).

``--ingest`` serves the *dynamic* retrieval plane (DESIGN.md §4 + §5):
a scheduler-fronted collection absorbs streaming document inserts and
deletes while answering top-k queries mid-stream, and ends with the
``/stats``-style metrics dump.  ``--data-dir`` makes the collection
durable (segment snapshots + WAL, DESIGN.md §8) in the JAX package's
on-disk format; ``--recover`` rebuilds what that directory holds — on
the device — before serving.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config
from ..core.hamming import pack_sets, resolve_device
from ..core.sketch import cws_params, zbit_cws
from ..distributed.sharding import use_mesh
from ..kernels.ops import DEFAULT_BLOCK_M
from ..models import model as M
from ..obs import SlowQueryLog, Tracer
from ..serving import (AdmissionConfig, BreakerConfig, CollectionConfig,
                       CollectionRegistry, DegradePolicy, Scheduler,
                       SchedulerConfig)
from ..train.steps import cast_for_compute, make_decode_step, make_prefill_step
from .mesh import (batch_coord, dp_shards, init_distributed, make_host_mesh,
                   shutdown_distributed)


@torch.no_grad()
def _generate(params, cfg, prompts: torch.Tensor, gen_len: int, *,
              s_max: int | None = None, compute_dtype=torch.bfloat16):
    """``generate`` plus the last step's logits (the prefill's when
    ``gen_len`` is 1)."""
    s_max = s_max or prompts.shape[1] + gen_len
    params_c = cast_for_compute(params, compute_dtype)   # once, not per step
    prefill = make_prefill_step(cfg, s_max=s_max, compute_dtype=compute_dtype)
    decode = make_decode_step(cfg, compute_dtype=compute_dtype)
    first, cache, cache_len = prefill(params_c, {"tokens": prompts})
    logits = first
    tok = torch.argmax(first, dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    for i in range(gen_len - 1):
        logits, cache = decode(params_c, tok, cache, cache_len + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        generated.append(tok)
    return torch.cat(generated, dim=1), first, logits


def generate(params, cfg, prompts: torch.Tensor, gen_len: int, *,
             s_max: int | None = None, compute_dtype=torch.bfloat16):
    """Prefill ``prompts`` (B, S) and decode ``gen_len`` greedy tokens.
    ``params`` are f32 masters, cast once to ``compute_dtype``.  Returns
    ((B, gen_len) int32 tokens, the prefill's last-position logits)."""
    tokens, first, _ = _generate(params, cfg, prompts, gen_len, s_max=s_max,
                                 compute_dtype=compute_dtype)
    return tokens, first


# ---------------------------------------------------------------------------
# serving-runtime helpers (shared by --ingest and --retrieval)
# ---------------------------------------------------------------------------

def make_scheduler(args, L: int, b: int, name: str = "docs") -> Scheduler:
    """One scheduler fronting one collection with the CLI's knobs, on
    ``args.device``.

    ``--data-dir`` makes the collection durable (segment snapshots + WAL,
    DESIGN.md §8); ``--recover`` additionally rebuilds whatever that
    directory already holds before serving."""
    device = getattr(args, "device", "cuda")
    data_dir = getattr(args, "data_dir", None)
    if data_dir and getattr(args, "recover", False):
        registry = CollectionRegistry.open(data_dir, device=device)
    else:
        registry = CollectionRegistry(data_dir=data_dir or None,
                                      device=device)
    tracer = slowlog = None
    trace_dir = getattr(args, "trace_dir", None)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        tracer = Tracer()
        slowlog = SlowQueryLog(
            path=os.path.join(trace_dir, "slow_queries.jsonl"))
    # overload control plane (DESIGN.md §12): --degrade-policy standard
    # turns on cost-budget admission + the degradation ladder;
    # --breaker adds the per-collection circuit breaker
    degrade_policy = getattr(args, "degrade_policy", "off")
    admission = degrade = None
    if degrade_policy and degrade_policy != "off":
        admission = AdmissionConfig()
        degrade = DegradePolicy()
    breaker = BreakerConfig() if getattr(args, "breaker", False) else None
    sched = Scheduler(registry=registry, config=SchedulerConfig(
        max_batch=args.max_batch, max_queue=args.max_queue,
        max_wait_ms=args.max_wait_ms,
        slow_ms=getattr(args, "slow_ms", None),
        admission=admission, degrade=degrade, breaker=breaker,
        default_deadline_ms=getattr(args, "deadline_ms", None)),
        tracer=tracer, slowlog=slowlog)
    if name not in registry.names():
        # --rerank provisions the exact re-rank plane (DESIGN.md §10):
        # the collection stores per-row token-set bitmaps alongside the
        # sketch columns
        payload_words = ((args.vocab + 31) // 32
                         if getattr(args, "rerank", None) else None)
        sched.create_collection(name, CollectionConfig(
            L=L, b=b, delta_cap=args.delta_cap,
            block_m=args.block_m or DEFAULT_BLOCK_M,
            payload_words=payload_words))
    return sched


def dump_trace(sched: Scheduler, args) -> None:
    """--trace-dir epilogue: write the Chrome trace-event JSON (Perfetto
    and ``chrome://tracing`` read it) and note the slow-query log."""
    trace_dir = getattr(args, "trace_dir", None)
    if not trace_dir or sched.tracer is None:
        return
    path = sched.tracer.write_chrome(os.path.join(trace_dir, "trace.json"))
    print(f"wrote {len(sched.tracer)} request traces to {path}")
    if sched.slowlog is not None and len(sched.slowlog):
        print(f"  {len(sched.slowlog)} slow requests "
              f"(>= {args.slow_ms} ms) in {sched.slowlog.path}")


def run_ingest(args) -> int:
    """--ingest mode: stream synthetic document sketches through the
    scheduler's insert/delete surface and serve top-k queries mid-stream,
    ending with the /stats metrics dump."""
    L, b = 32, 4
    rng = np.random.default_rng(args.seed)
    n = args.index_size
    docs = rng.integers(0, 1 << b, size=(n, L), dtype=np.uint8)
    pays = None
    if args.rerank:
        # synthetic token sets behind the sketches — the exact stage's
        # source of truth
        sets = [rng.choice(args.vocab, size=int(rng.integers(4, 24)),
                           replace=False) for _ in range(n)]
        pays = pack_sets(sets, args.vocab)
    sched = make_scheduler(args, L, b).start()
    coll = sched.registry.get("docs")
    index = coll.index

    if getattr(args, "recover", False) and coll.store is not None \
            and index.n_live:
        # recovered a previous --data-dir run (possibly killed mid-
        # stream): report what came back and serve queries against it
        st = coll.stats()                # index stats + the "store" block
        sst = st["store"]
        print(f"recovered 'docs' from {args.data_dir} on {index.device}: "
              f"{st['n_live']} live docs, {st['n_segments']} segments + "
              f"{st['delta_rows']} delta rows "
              f"({sst['recovered_segments']} segment snapshots, "
              f"{sst['replayed_records']} WAL records replayed)")
        qs = docs[rng.integers(0, max(index.n_ids, 1), args.batch)]
        futs = [sched.submit_topk("docs", q, args.topk) for q in qs]
        nn = [f.result() for f in futs]
        for r in range(min(args.batch, 4)):
            print(f"  request {r}: top-{args.topk} docs {nn[r].ids} "
                  f"at distances {nn[r].dists} (tau*={nn[r].tau})")
        sched.stop()
        sched.registry.close()
        dump_trace(sched, args)
        print("--- /stats ---")
        print(sched.render_stats())
        return 0

    chunk = max(64, n // 16)
    t0 = time.time()
    id_futs = []
    for lo in range(0, n, chunk):
        id_futs.append(sched.submit_insert(
            "docs", docs[lo:lo + chunk],
            payloads=pays[lo:lo + chunk] if pays is not None else None))
        if lo == chunk * 4:   # mid-stream query traffic, coalesced by the
            # scheduler into shape-bucketed dispatches between inserts
            futs = [sched.submit_topk("docs", q, args.topk)
                    for q in docs[rng.integers(0, lo, args.batch)]]
            nn = [f.result() for f in futs]
            st = index.stats()
            print(f"mid-stream topk over {st['n_live']} live docs "
                  f"({st['n_segments']} segments + {st['delta_rows']} "
                  f"delta rows): tau*={nn[0].tau}")
    ids = np.concatenate([f.result() for f in id_futs])
    dt = time.time() - t0
    print(f"ingested {n} docs on {index.device} in {dt:.2f}s "
          f"({n / dt:.0f} inserts/s, {index.counters['merges']} background "
          f"merges)")

    removed = sched.submit_delete(
        "docs", ids[rng.choice(n, n // 8, replace=False)]).result()
    index.flush()
    index.maybe_merge()
    index.compact(min_dead_frac=0.25)
    st = index.stats()
    print(f"deleted {removed}; stack now {st['segments']} "
          f"(space {st['space_bits'] / 8 / 1024:.1f} KiB incl. tombstones, "
          f"{st['tombstones']} tombstones held)")

    if getattr(args, "warmup", False):
        w = sched.warmup(ks=(args.topk,), taus=(args.tau,),
                         reranks=(args.rerank,) if args.rerank else ())
        print(f"warmup: {w['calls']} calls over {w['buckets']} shape "
              f"buckets absorbed {w['traces']} program builds")

    rows = rng.integers(0, n, args.batch)
    qs = docs[rows]
    t0 = time.time()
    if args.rerank:
        futs = [sched.submit_topk("docs", q, args.topk, rerank=args.rerank,
                                  q_payload=pays[row])
                for q, row in zip(qs, rows)]
    else:
        futs = [sched.submit_topk("docs", q, args.topk) for q in qs]
    nn = [f.result() for f in futs]
    dt = time.time() - t0
    for r in range(min(args.batch, 4)):
        extra = (f", {args.rerank} scores "
                 f"{np.round(np.asarray(nn[r].scores), 3)}"
                 if nn[r].scores is not None else "")
        print(f"  request {r}: top-{args.topk} docs {nn[r].ids} "
              f"at distances {nn[r].dists} (tau*={nn[r].tau}{extra})")
    print(f"post-merge scheduled topk: {dt / args.batch * 1e3:.1f} "
          f"ms/query (batch-fill "
          f"{sched.metrics.batch_fill_ratio():.2f})")
    sched.stop()
    sched.registry.close()              # sync durable stores (--data-dir)
    dump_trace(sched, args)
    print("--- /stats ---")
    print(sched.render_stats())
    return 0


def run_retrieval(args, params, logits: torch.Tensor, rng, dev) -> None:
    """--retrieval: the paper's technique as the retrieval plane.  The
    requests' last-step ``logits`` (B, vocab), mixed over the embedding
    table, are 0-bit-CWS-sketched (L 32, b 4) against ``--index-size``
    random 64-dimensional documents drawn from ``rng``; each request
    submits its own range and top-k lookup, and the scheduler coalesces
    them into shape-bucketed dispatches."""
    L, b = 32, 4
    # drawn on the host generator, then moved: the same draws on any
    # device
    cws = tuple(p.to(dev) for p in cws_params(
        L, 64, torch.Generator().manual_seed(7)))
    docs = rng.random((args.index_size, 64)).astype(np.float32)
    doc_sk = zbit_cws(cws, torch.from_numpy(docs).to(dev), L=L, b=b)
    sched = make_scheduler(args, L, b)
    sched.submit_insert("docs", doc_sk.cpu().numpy())
    # query: final hidden state of each request, hashed the same way
    table = params["embed" if "embed" in params else "lm_head"].float()
    h = torch.softmax(logits.float(), dim=-1) @ table
    q = (h[:, :64].abs() if h.shape[-1] >= 64 else torch.nn.functional.pad(
        h.abs(), (0, 64 - h.shape[-1])))
    q_sk = zbit_cws(cws, q, L=L, b=b).cpu().numpy()
    range_futs = [sched.submit_search("docs", qr, args.tau) for qr in q_sk]
    topk_futs = [sched.submit_topk("docs", qr, args.topk) for qr in q_sk]
    sched.pump()     # synchronous drive on the serving thread
    hits = np.array([f.result().mask.sum() for f in range_futs])
    print(f"retrieval: tau={args.tau} hits per request: {hits} "
          f"(scheduler batch-fill "
          f"{sched.metrics.batch_fill_ratio():.2f})")
    for r, f in enumerate(topk_futs):
        nn = f.result()
        print(f"  request {r}: top-{args.topk} docs {nn.ids} "
              f"at distances {nn.dists} (tau*={nn.tau})")
    dump_trace(sched, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--ingest", action="store_true",
                    help="streaming-ingest retrieval plane: scheduler-"
                         "fronted dynamic segmented index (model-free; "
                         "see DESIGN.md §4-§5)")
    ap.add_argument("--delta-cap", type=int, default=2048,
                    help="delta-buffer rows before a segment seals "
                         "(--ingest)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="most queries the scheduler coalesces into one "
                         "read dispatch")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="per-collection queue bound (overload rejects)")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="partial-batch flush deadline")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="default end-to-end latency budget per request; "
                         "requests expiring in queue fail with "
                         "DeadlineExceeded before any dispatch "
                         "(DESIGN.md §12)")
    ap.add_argument("--degrade-policy", default="off",
                    choices=["off", "standard"],
                    help="overload control plane: 'standard' enables "
                         "cost-budget admission + the graceful-"
                         "degradation ladder (rerank_off -> shrink_k -> "
                         "cheap_tau -> reject)")
    ap.add_argument("--breaker", action="store_true",
                    help="per-collection circuit breaker over deadline "
                         "outcomes (open/half-open probing)")
    ap.add_argument("--warmup", action="store_true",
                    help="run every power-of-two shape bucket once after "
                         "ingest so first-request builds never pollute "
                         "serving p99")
    ap.add_argument("--index-size", type=int, default=4096)
    ap.add_argument("--tau", type=int, default=3)
    ap.add_argument("--topk", type=int, default=3,
                    help="k nearest documents returned per request")
    ap.add_argument("--rerank", default=None,
                    choices=["jaccard", "cosine", "containment"],
                    help="--ingest: store token-set payload bitmaps and "
                         "serve the final query round through the exact "
                         "two-stage rerank= contract (DESIGN.md §10)")
    ap.add_argument("--vocab", type=int, default=256,
                    help="token vocabulary of the synthetic payload sets "
                         "(--ingest --rerank)")
    ap.add_argument("--block-m", type=int, default=None,
                    help="query-tile size of the batched verify kernel "
                         "(default: kernels.ops.DEFAULT_BLOCK_M)")
    ap.add_argument("--data-dir", default=None,
                    help="durable collection root: segment snapshots + "
                         "delta-buffer WAL (DESIGN.md §8), in the JAX "
                         "package's on-disk format")
    ap.add_argument("--recover", action="store_true",
                    help="with --data-dir: rebuild collections persisted "
                         "there (manifest segments + WAL replay) before "
                         "serving")
    ap.add_argument("--trace-dir", default=None,
                    help="record per-request span traces and write them "
                         "here: trace.json (Chrome trace-event JSON) plus "
                         "slow_queries.jsonl")
    ap.add_argument("--slow-ms", type=float, default=None,
                    help="slow-query threshold (end-to-end ms): requests "
                         "at or above it dump their span tree to the "
                         "slow-query log")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="ranks on the \"model\" axis (tensor parallelism "
                         "of the dense layers); the rest on \"data\"")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if args.ingest:
        return run_ingest(args)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.causal or cfg.inputs_embeds:
        print(f"{args.arch} is encoder-only: no autoregressive serving "
              "(see DESIGN.md §Arch-applicability)")
        return 0
    started = init_distributed(dev)
    clean = False
    try:
        rc = serve_generation(args, cfg, dev)
        clean = True
    finally:
        if started:
            shutdown_distributed(clean=clean)
    return rc


def serve_generation(args, cfg, dev) -> int:
    """Generation (and ``--retrieval``) under the host mesh: this rank's
    rows of the batch, gathered on every rank; rank 0 prints."""
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16
    mesh = make_host_mesh(args.model_ranks)
    n, r = dp_shards(mesh), batch_coord(mesh)
    lead = mesh.size == 1 or torch.distributed.get_rank() == 0
    if args.batch % n:
        raise SystemExit(f"--batch {args.batch} does not split over {n} "
                         "data ranks")
    rows = slice(r * args.batch // n, (r + 1) * args.batch // n)

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32)).to(dev)
    s_max = args.prompt_len + args.gen_len

    params = M.init_params(torch.Generator().manual_seed(args.seed), cfg,
                           device=dev)
    t0 = time.perf_counter()
    with use_mesh(mesh):
        out, _, logits = _generate(params, cfg, prompts[rows], args.gen_len,
                                   s_max=s_max, compute_dtype=dtype)
    out = mesh.all_gather(out, "data").cpu()       # waits for the device
    logits = mesh.all_gather(logits.contiguous(), "data")
    dt = time.perf_counter() - t0
    if not lead:
        return 0
    total_tokens = args.batch * args.gen_len
    ranks = f" over {n} data ranks" if n > 1 else ""
    if args.model_ranks > 1:
        ranks += f" x {args.model_ranks} model ranks"
    print(f"served {args.batch} requests x {args.gen_len} tokens on {dev}"
          f"{ranks} in {dt:.2f}s ({total_tokens / dt:.1f} tok/s incl. "
          "first-call set-up)")
    print("sample continuation ids:", out[0][:12].numpy())
    print("continuation ids:", out.tolist())
    if args.retrieval:
        run_retrieval(args, params, logits, rng, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
