"""Serving entry point: batched autoregressive generation — the generation
mode of the JAX package's ``launch/serve.py``.

``python -m repro_torch.launch.serve --arch smollm-135m --smoke
--device cpu`` — prefill a batch of prompts and decode N tokens
(greedy), reporting tokens/s.  Weights are random, drawn from
``--seed``; prompts are uniform token ids from ``--seed``.  On the card
the matrices compute in bf16 from f32 masters and the prefill attention
goes through the CUDA flash kernel; on the CPU everything is f32.

``--retrieval`` and ``--ingest`` (the sketch-retrieval plane) are not
ported yet.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs.registry import ARCH_IDS, get_config
from ..core.hamming import resolve_device
from ..models import model as M
from ..train.steps import cast_for_compute, make_decode_step, make_prefill_step


@torch.no_grad()
def generate(params, cfg, prompts: torch.Tensor, gen_len: int, *,
             s_max: int | None = None, compute_dtype=torch.bfloat16):
    """Prefill ``prompts`` (B, S) and decode ``gen_len`` greedy tokens.
    ``params`` are f32 masters, cast once to ``compute_dtype``.  Returns
    ((B, gen_len) int32 tokens, the prefill's last-position logits)."""
    s_max = s_max or prompts.shape[1] + gen_len
    params_c = cast_for_compute(params, compute_dtype)   # once, not per step
    prefill = make_prefill_step(cfg, s_max=s_max, compute_dtype=compute_dtype)
    decode = make_decode_step(cfg, compute_dtype=compute_dtype)
    first, cache, cache_len = prefill(params_c, {"tokens": prompts})
    tok = torch.argmax(first, dim=-1).to(torch.int32)[:, None]
    generated = [tok]
    for i in range(gen_len - 1):
        logits, cache = decode(params_c, tok, cache, cache_len + i)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        generated.append(tok)
    return torch.cat(generated, dim=1), first


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list(ARCH_IDS))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--retrieval", action="store_true",
                    help="not ported yet (needs zbit_cws and the Scheduler)")
    ap.add_argument("--ingest", action="store_true",
                    help="not ported yet (needs the Scheduler)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.ingest or args.retrieval:
        raise NotImplementedError(
            "--retrieval and --ingest need zbit_cws and the serving "
            "Scheduler, not ported yet (ROADMAP Queue 1 items 4 and 8)")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if not cfg.causal or cfg.inputs_embeds:
        print(f"{args.arch} is encoder-only: no autoregressive serving "
              "(see DESIGN.md §Arch-applicability)")
        return 0
    dtype = torch.float32 if dev.type == "cpu" else torch.bfloat16

    rng = np.random.default_rng(args.seed)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))
        .astype(np.int32)).to(dev)
    s_max = args.prompt_len + args.gen_len

    params = M.init_params(torch.Generator().manual_seed(args.seed), cfg,
                           device=dev)
    t0 = time.perf_counter()
    out, _ = generate(params, cfg, prompts, args.gen_len, s_max=s_max,
                      compute_dtype=dtype)
    out = out.cpu()                                # waits for the device
    dt = time.perf_counter() - t0
    total_tokens = args.batch * args.gen_len
    print(f"served {args.batch} requests x {args.gen_len} tokens on {dev} "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s incl. first-call set-up)")
    print("sample continuation ids:", out[0][:12].numpy())
    return 0


if __name__ == "__main__":
    sys.exit(main())
