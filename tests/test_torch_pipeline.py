"""The port's sketch-dedup data pipeline: the five tests of
``tests/test_dedup.py`` on the CPU, and the port held against the JAX
package's ``SketchDedupPipeline`` bit for bit — tokens, targets, embeds
and ``stats`` — over steps that rebuild the history bST and reject
against it, with the JAX package's hash parameters handed in.  On the
CPU the history search runs the verify kernel's plain version."""

import jax
import numpy as np
import pytest
import torch

from repro.core.sketch import _hash_params as jhash_params
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SketchDedupPipeline as JPipeline
from repro_torch.core.hamming import hamming_pairwise_naive
from repro_torch.core.sketch import hash_params, sketch_tokens
from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline
from repro_torch.kernels import ops


def pipe(cfg, **kw):
    return SketchDedupPipeline(cfg, device="cpu", **kw)


def test_determinism_across_instances():
    cfg = DataConfig(vocab=1000, batch=4, seq=32, seed=7)
    a, b = pipe(cfg), pipe(cfg)
    for step in (0, 3, 11):
        ba, bb = a.batch_for_step(step), b.batch_for_step(step)
        assert torch.equal(ba["tokens"], bb["tokens"])
        assert torch.equal(ba["targets"], bb["targets"])


def test_targets_are_shifted_tokens():
    cfg = DataConfig(vocab=1000, batch=2, seq=16, seed=0)
    b = pipe(cfg).batch_for_step(0)
    assert b["tokens"].shape == (2, 16) and b["targets"].shape == (2, 16)
    assert b["tokens"].dtype == torch.int32 and b["tokens"].is_contiguous()
    assert torch.equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_dedup_rejects_near_duplicates():
    cfg = DataConfig(vocab=500, batch=8, seq=64, seed=1, dedup=True,
                     oversample=2, dup_frac=0.5, dedup_tau=2)
    p = pipe(cfg)
    for step in range(5):
        p.batch_for_step(step)
    assert p.stats["rejected_in_batch"] > 0, p.stats
    assert p.stats["rejected_history"] >= 0
    assert p.stats["candidates"] == 5 * 16


def test_dedup_batch_internally_distant():
    """Within a kept batch, no two documents' sketches are within tau."""
    cfg = DataConfig(vocab=500, batch=4, seq=64, seed=2, dedup=True,
                     oversample=4, dup_frac=0.3, dedup_tau=1)
    b = pipe(cfg).batch_for_step(0)
    params = hash_params(cfg.dedup_L,
                         torch.Generator().manual_seed(cfg.seed ^ 0x5E7C))
    sk = sketch_tokens(params, b["tokens"], L=cfg.dedup_L, b=cfg.dedup_b)
    d = hamming_pairwise_naive(sk, sk).numpy().copy()
    np.fill_diagonal(d, 99)
    assert d.min() > cfg.dedup_tau, d


def test_embeds_pipeline():
    cfg = DataConfig(vocab=64, batch=2, seq=8, embeds_dim=16)
    b = pipe(cfg).batch_for_step(0)
    assert b["embeds"].shape == (2, 8, 16)
    assert b["embeds"].dtype == torch.float32
    assert b["targets"].shape == (2, 8)
    assert int(b["targets"].max()) < 64


def _jax_params(cfg):
    a, c = jhash_params(jax.random.PRNGKey(cfg.seed ^ 0x5E7C), cfg.dedup_L)
    return np.asarray(a), np.asarray(c)


@pytest.mark.parametrize("kw", [
    # a small vocabulary: documents share most tokens, so the history
    # search rejects candidates of later steps
    dict(vocab=40, batch=6, seq=48, seed=3, dedup=True, oversample=3,
         dup_frac=0.3, dedup_tau=2),
    dict(vocab=5000, batch=8, seq=32, seed=4, dedup=True, oversample=2,
         dup_frac=0.5, dedup_tau=3, dedup_L=32, dedup_b=1),
    dict(vocab=5000, batch=3, seq=16, seed=5),
])
def test_batches_match_jax_bit_for_bit(kw):
    """Six steps (history rebuilds at steps 0, 1 and 3) equal the JAX
    package's tokens, targets and counters."""
    cfg = DataConfig(**kw)
    port = pipe(cfg, sketch_params=_jax_params(cfg))
    ref = JPipeline(JDataConfig(**kw))
    ops.reset_kernel_stats()
    for step in range(6):
        got, want = port.batch_for_step(step), ref.batch_for_step(step)
        for key in ("tokens", "targets"):
            assert got[key].dtype == torch.int32
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
        assert port.stats == ref.stats, step
    if cfg.dedup:
        assert port.rebuilds == 3
        assert np.array_equal(port._history, ref._history)
        assert ops.kernel_stats().get("sparse_verify_batch:ref", 0) == 5
    if kw["vocab"] == 40:
        assert port.stats["rejected_history"] > 0


def test_embeds_match_jax_bit_for_bit():
    kw = dict(vocab=64, batch=2, seq=8, embeds_dim=16, seed=9)
    port, ref = pipe(DataConfig(**kw)), JPipeline(JDataConfig(**kw))
    for step in (0, 4):
        got, want = port.batch_for_step(step), ref.batch_for_step(step)
        for key in ("embeds", "targets"):
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SketchDedupPipeline(DataConfig(vocab=10, batch=1, seq=4))
