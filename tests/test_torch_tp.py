"""Tensor parallelism of the dense layers over "model" — the JAX
package's placement (``param_specs``) and the program GSPMD derives from
it and from its ``constrain`` annotations, written out for one rank —
held against the JAX package and against the port's one-rank run.

Eight SMOKE configs, each with the JAX package's parameters carried
across (``params_from_jax``) and numpy-seeded inputs, in groups of gloo
CPU ranks at meshes (1, 2) and (2, 2), every rank on its shards of the
placement (``shard_state``) and its rows of the batch:

  * smollm-135m: H 3 stays whole (the divisibility fallback), the ffn
    and the vocabulary split;
  * yi-9b: the q heads split, its one KV head stays whole (each rank
    reads the KV head its q heads map to), the sequence-split decode;
  * gemma2-27b: post-norms, both softcaps, local and global layers;
  * granite-moe-3b-a800m: attention over "model" beside expert
    parallelism;
  * mamba2-1.3b: the SSM block on the rank's heads, the gated norm
    summed over "model";
  * zamba2-2.7b: the hybrid's shared attention block;
  * hubert-xlarge: frame embeddings in, bidirectional, an untied head;
  * command-r-35b: the sequence-split decode with the KV heads split
    too (each rank's q, new keys and values gathered before it);

and two SMOKE variants for the fallbacks no registry config reaches at
m = 2: smollm with 6 heads over 3 KV heads (each rank's three q heads
map to KV heads 0, 0, 1 and 1, 2, 2: one KV head per q head, gathered by
index) and mamba2 at d_model 48 with head dim 32 (3 SSM heads: d_inner
96 splits, the heads do not, so the block's d_inner leaves are gathered
whole and every rank runs it whole).

Tolerances (the figures of ``test_torch_mesh.py`` and
``test_torch_train_mesh.py``, the logits' taken relative to their
largest magnitude, as float32 sums in another order err in proportion
to their largest terms): the forward and prefill logits within 1e-5 of
the port's one-rank float32 run (the sums split over ranks run in
another order) and 1e-4 of JAX's; the three teacher-forced decode steps
within 1e-5 of one rank and 2e-2 of JAX (they read bf16 caches, the JAX
package's own prefill/decode test's); one float32 train step's
loss within 1e-6 and gradient norm within 1e-5 (relative) of one rank,
every leaf's gradient within 1e-5 of its largest magnitude and every
updated leaf within 1e-5 (absolute) of one rank's, except where one
rank's clipped |g| lies within ten eps (Adam's update there is
ill-conditioned, ``test_three_train_steps_match_jax``'s exemption).

The SSM cases' conv windows and scan states after a float32-cached
prefill (every SSM layer) equal the one-rank run's on each rank's heads
(the state's heads, conv_x's d_inner channels; conv_B and conv_C whole;
every head where the heads do not split) within 1e-5 of the largest
magnitude, the logits' rule.

Each rank holds exactly 1/m of every dense leaf whose dimension the
"model" axis divides and the whole leaf where it does not; ``Mesh.stats``
counts the sums over "model" of a forward that the design predicts (one
per tensor-parallel attention, MLP, MoE and embedding, two per SSM
block, one gather of the logits); a checkpoint saved at (2, 2) restores
with no mesh bit for bit, and at (1, 2) as that mesh's shards.
"""

import numpy as np
import pytest
import torch

from _torch_ranks import run_ranks

# name -> (registry arch, SMOKE overrides)
CASES = {
    "smollm-135m": ("smollm-135m", {}),
    "yi-9b": ("yi-9b", {}),
    "gemma2-27b": ("gemma2-27b", {}),
    "granite-moe-3b-a800m": ("granite-moe-3b-a800m", {}),
    "mamba2-1.3b": ("mamba2-1.3b", {}),
    "zamba2-2.7b": ("zamba2-2.7b", {}),
    "hubert-xlarge": ("hubert-xlarge", {}),
    "command-r-35b": ("command-r-35b", {}),
    "smollm-gqa-6-3": ("smollm-135m", {"n_heads": 6, "n_kv": 3}),
    "mamba2-3-heads": ("mamba2-1.3b", {"d_model": 48, "ssm_head_dim": 32}),
}
ARCHS = list(CASES)
MESHES = [(1, 2), (2, 2)]
B, S, GEN = 4, 12, 3
S_MAX = S + GEN + 1
HYPER = dict(base_lr=1e-3, total_steps=10, warmup_steps=1)
CKPT_ARCHS = ["yi-9b", "mamba2-1.3b"]
SSM_ARCHS = ["mamba2-1.3b", "zamba2-2.7b", "mamba2-3-heads"]


def _config(name, get_config):
    """The case's config from a package's registry (``get_config``)."""
    import dataclasses
    arch, overrides = CASES[name]
    return dataclasses.replace(get_config(arch, smoke=True), **overrides)


def _serves(cfg) -> bool:
    return cfg.causal and not cfg.inputs_embeds


def _inputs(cfg, seed: int) -> dict:
    """The global batch: tokens (or frame embeddings), targets, and the
    tokens the decode steps are fed."""
    rng = np.random.default_rng(seed)
    out = {"targets": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.inputs_embeds:
        out["embeds"] = rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)
    else:
        toks = rng.integers(0, cfg.vocab, (B, S + GEN)).astype(np.int32)
        out["tokens"], out["fed"] = toks[:, :S].copy(), toks[:, S:].copy()
    return out


def _numpy(tree):
    return {n: p.detach().numpy().copy() for n, p in tree.items()}


def _ssm_states(M, params, cfg, tokens) -> dict:
    """{(unit, layer): {field: array}} of every SSM cache of a prefill
    with float32 caches (conv windows and the scan's state)."""
    _, cache, _ = M.prefill(params, cfg, {"tokens": tokens}, s_max=S_MAX,
                            cache_dtype=torch.float32)
    return {(u, name): {f: t.numpy() for f, t in zip(c._fields, c)}
            for u, unit in enumerate(cache) for name, c in unit.items()
            if hasattr(c, "_fields")}


# ---------------------------------------------------------------------------
# the ranks' side: torch and the port only (the JAX package never enters)
# ---------------------------------------------------------------------------

def tp_worker(payload) -> dict:
    """Every case under ``payload["mesh"]``: this rank's shard shapes,
    forward logits and the forward's collectives, prefill and decode
    logits, the gradients of the loss and one train step (gathered whole
    on every rank), and the checkpoint ``payload`` asks to save or
    restore."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.checkpoint import AsyncCheckpointer
    from repro_torch.distributed.fault_tolerance import resume_or_init
    from repro_torch.distributed.sharding import (gather_whole, shard_state,
                                                  use_mesh)
    from repro_torch.launch.mesh import batch_coord, dp_shards, make_mesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import Hyper, abstract_opt_state, adamw_init
    from repro_torch.train.steps import _reduce_grads, make_train_step

    mesh = make_mesh(payload["mesh"], ("data", "model"))
    n, c = dp_shards(mesh), batch_coord(mesh)

    def rows(a):
        k = a.shape[0] // n
        return torch.from_numpy(a[c * k:(c + 1) * k].copy())

    out = {"coords": dict(mesh.coords), "rank": dist.get_rank()}
    for case in payload["cases"]:
        arch = case["arch"]
        cfg = _config(arch, get_config)
        whole = M.params_from_jax(case["params"], cfg, device="cpu")
        mine = shard_state(whole, mesh)
        specs, _ = M.placement(cfg, mesh)
        data = {k: rows(v) for k, v in case["batch"].items()}
        key = "embeds" if cfg.inputs_embeds else "tokens"
        res = {"shapes": {k: tuple(p.shape)
                          for k, p in mine.named_parameters()}}
        with use_mesh(mesh):
            mesh.stats.clear()
            res["forward"] = M.forward(mine, cfg, {key: data[key]}).numpy()
            res["forward_stats"] = {k: v[0] for k, v in mesh.stats.items()}
            if _serves(cfg):
                logits, cache, n_len = M.prefill(
                    mine, cfg, {"tokens": data["tokens"]}, s_max=S_MAX)
                steps = [logits.numpy()]
                for i in range(GEN):
                    logits, cache = M.decode_step(
                        mine, cfg, data["fed"][:, i:i + 1], cache, n_len + i)
                    steps.append(logits.numpy())
                res["steps"] = steps
                if cfg.ssm:
                    res["states"] = _ssm_states(M, mine, cfg, data["tokens"])
            train = {k: v for k, v in data.items() if k != "fed"}
            names = [k for k, _ in mine.named_parameters()]
            mine.requires_grad_(True)
            loss = M.loss_fn(mine, cfg, train, remat=True)
            grads = torch.autograd.grad(loss, list(mine.parameters()),
                                        allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(mine.parameters(), grads)]
            grads, _ = _reduce_grads(cfg, mesh, names, grads)
            res["grads"] = {k: gather_whole(g, specs[k], mesh).numpy()
                            for k, g in zip(names, grads)}
            mine.requires_grad_(False)
            step = make_train_step(cfg, Hyper(**payload["hyper"]),
                                   compute_dtype=torch.float32)
            opt = adamw_init(mine)
            mine, opt, m = step(mine, opt, train)
            res["loss"], res["norm"] = float(m["loss"]), float(m["grad_norm"])
            res["updated"] = {k: gather_whole(p.detach(), specs[k],
                                              mesh).numpy()
                              for k, p in mine.named_parameters()}
        if arch in payload.get("save", {}):
            ck = AsyncCheckpointer(payload["save"][arch], mesh=mesh)
            ck.save(1, {"params": mine, "opt": opt}, specs)
            ck.wait()
        if arch in payload.get("restore", {}):
            abstract = M.abstract_params(cfg)
            tree, at = resume_or_init(
                payload["restore"][arch],
                {"params": abstract, "opt": abstract_opt_state(abstract)},
                lambda: None, device="cpu", mesh=mesh)
            res["restored"] = {"step": at,
                               "params": _numpy(dict(
                                   tree["params"].named_parameters()))}
        out[arch] = res
    return out


# ---------------------------------------------------------------------------
# the parent's side: the JAX package and the port's one-rank run
# ---------------------------------------------------------------------------

def _one_rank(cfg, params, inputs) -> dict:
    """The port with no mesh: forward, prefill and decode logits, the
    loss's gradients, one train step."""
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step

    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    key = "embeds" if cfg.inputs_embeds else "tokens"
    out = {"forward": M.forward(params, cfg, {key: t[key]}).numpy()}
    if _serves(cfg):
        logits, cache, n_len = M.prefill(params, cfg, {"tokens": t["tokens"]},
                                         s_max=S_MAX)
        steps = [logits.numpy()]
        for i in range(GEN):
            logits, cache = M.decode_step(params, cfg,
                                          t["fed"][:, i:i + 1], cache,
                                          n_len + i)
            steps.append(logits.numpy())
        out["steps"] = steps
        if cfg.ssm:
            out["states"] = _ssm_states(M, params, cfg, t["tokens"])
    batch = {k: v for k, v in t.items() if k != "fed"}
    params.requires_grad_(True)
    loss = M.loss_fn(params, cfg, batch, remat=True)
    grads = torch.autograd.grad(loss, list(params.parameters()))
    out["grads"] = {k: g.numpy() for (k, _), g in
                    zip(params.named_parameters(), grads)}
    params.requires_grad_(False)
    step = make_train_step(cfg, Hyper(**HYPER), compute_dtype=torch.float32)
    p2, _, m = step(params, adamw_init(params), batch)
    out["loss"], out["norm"] = float(m["loss"]), float(m["grad_norm"])
    out["updated"] = _numpy(dict(p2.named_parameters()))
    return out


def _jax_run(arch, jparams, inputs) -> dict:
    """JAX's forward logits and its prefill / decode steps (float32)."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_config as jget_config
    from repro.models import model as JM
    from repro.train.steps import make_decode_step as jdecode_step
    from repro.train.steps import make_prefill_step as jprefill_step

    jcfg = _config(arch, jget_config)
    key = "embeds" if jcfg.inputs_embeds else "tokens"
    out = {"forward": np.asarray(jax.jit(
        lambda p, x: JM.forward(p, jcfg, {key: x}))(
            jparams, jnp.asarray(inputs[key])))}
    if jcfg.causal and not jcfg.inputs_embeds:
        pre = jax.jit(jprefill_step(jcfg, s_max=S_MAX,
                                    compute_dtype=jnp.float32))
        dec = jax.jit(jdecode_step(jcfg, compute_dtype=jnp.float32))
        jl, jcache, jlen = pre(jparams,
                               {"tokens": jnp.asarray(inputs["tokens"])})
        steps = [np.asarray(jl)]
        for i in range(GEN):
            jl, jcache = dec(jparams, jnp.asarray(inputs["fed"][:, i:i + 1]),
                             jcache, jlen + i)
            steps.append(np.asarray(jl))
        out["steps"] = steps
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{arch: (inputs, JAX's run, the one-rank run)} and {mesh: the ranks'
    results}: four ranks at (2, 2) first (they save the checkpoints),
    then two at (1, 2) (they restore them)."""
    import jax

    from repro.configs.registry import get_config as jget_config
    from repro.models import model as JM
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M

    tmp = tmp_path_factory.mktemp("tp")
    cases, ref = [], {}
    for i, arch in enumerate(ARCHS):
        jcfg = _config(arch, jget_config)
        jparams = jax.tree_util.tree_map(
            np.asarray, JM.init_params(jax.random.PRNGKey(i), jcfg))
        cfg = _config(arch, get_config)
        inputs = _inputs(cfg, 100 + i)
        one = _one_rank(cfg, M.params_from_jax(jparams, cfg, device="cpu"),
                        inputs)
        ref[arch] = (inputs, _jax_run(arch, jparams, inputs), one)
        cases.append(dict(arch=arch, params=jparams, batch=inputs))
    base = dict(cases=cases, hyper=HYPER)
    ckpt = {a: str(tmp / f"ckpt_{a}") for a in CKPT_ARCHS}
    ranks = {(2, 2): run_ranks(tp_worker, 4, tmp,
                               dict(base, mesh=(2, 2), save=ckpt),
                               timeout=240),
             (1, 2): run_ranks(tp_worker, 2, tmp,
                               dict(base, mesh=(1, 2), restore=ckpt),
                               timeout=240)}
    return ref, ranks, ckpt


def _close(got, want, tol, what=""):
    """Within ``tol`` of ``want``'s largest magnitude (float32 sums in
    another order err in proportion to the largest terms, not to each
    logit)."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale,
                               err_msg=what)


def _rows(ranks, field, step=None):
    """The ranks' rows of ``field`` put back together (data-major), after
    checking that the model ranks of each data coordinate agree bit for
    bit."""
    by_data = {}
    for r in ranks:
        x = r[field] if step is None else r[field][step]
        d = r["coords"]["data"]
        if d in by_data:
            np.testing.assert_array_equal(x, by_data[d])
        by_data[d] = x
    return np.concatenate([by_data[d] for d in sorted(by_data)])


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_one_rank_and_jax(arch, mesh, runs):
    ref, ranks, _ = runs
    _, jax_run, one = ref[arch]
    got = _rows([r[arch] | {"coords": r["coords"]} for r in ranks[mesh]],
                "forward")
    _close(got, one["forward"], 1e-5, "one rank")
    _close(got, jax_run["forward"], 1e-4, "JAX")


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if CASES[a][0] != "hubert-xlarge"])
def test_prefill_decode_match_one_rank_and_jax(arch, mesh, runs):
    ref, ranks, _ = runs
    _, jax_run, one = ref[arch]
    per = [r[arch] | {"coords": r["coords"]} for r in ranks[mesh]]
    for step in range(GEN + 1):
        got = _rows(per, "steps", step)
        _close(got, one["steps"][step], 1e-5, f"step {step}, one rank")
        _close(got, jax_run["steps"][step], 1e-4 if step == 0 else 2e-2,
               f"step {step}, JAX")


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_states_after_prefill_match_one_rank_on_rank_heads(arch, mesh,
                                                               runs):
    """Each rank's conv windows and scan states after the prefill against
    the one-rank run's on the rank's rows and heads: a head split the
    ranks got wrong (the wrong slice, or a gated norm summed over too few
    ranks feeding the next layer) shows as a state off by O(1)."""
    from repro_torch.configs.registry import get_config
    cfg = _config(arch, get_config)
    ref, ranks, _ = runs
    one = ref[arch][2]["states"]
    dp, m = mesh
    H, P = cfg.n_ssm_heads, cfg.ssm_head_dim
    h = H // m if H % m == 0 else H
    for r in ranks[mesh]:
        got, c = r[arch]["states"], r["coords"]
        assert sorted(got) == sorted(one)
        rows = slice(c["data"] * B // dp, (c["data"] + 1) * B // dp)
        h0 = c["model"] * h if h < H else 0
        for key, fields in one.items():
            for f, want in fields.items():
                want = want[rows]
                if f == "state":
                    want = want[:, h0:h0 + h]
                elif f == "conv_x":
                    want = want[..., h0 * P:(h0 + h) * P]
                assert got[key][f].shape == want.shape, (key, f)
                _close(got[key][f], want, 1e-5, f"{key} {f}")


def _ill(one, name) -> np.ndarray:
    """Where one rank's clipped |g| lies within ten of AdamW's eps."""
    from repro_torch.optim.adamw import Hyper
    clip = min(1.0, Hyper().clip_norm / one["norm"])
    return np.abs(one["grads"][name]) * clip < 10 * Hyper().eps


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_one_rank(arch, mesh, runs):
    """The global loss and norm, every leaf's reduced gradient (gathered
    whole) and every updated leaf against one rank's: a leaf whose
    gradient the ranks failed to sum over "model" (or summed twice)
    is m times off."""
    ref, ranks, _ = runs
    one = ref[arch][2]
    for r in ranks[mesh]:
        got = r[arch]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["norm"], one["norm"], rtol=1e-5)
        for name, want in one["grads"].items():
            scale = float(np.abs(want).max()) or 1.0
            np.testing.assert_allclose(got["grads"][name], want, rtol=0,
                                       atol=1e-5 * scale, err_msg=name)
        for name, want in one["updated"].items():
            off = np.abs(got["updated"][name] - want) > 1e-5
            assert not (off & ~_ill(one, name)).any(), name


def _dense_split(name, cfg, shape, m) -> list:
    """(dim, whole size) of every dimension the placement puts over
    "model" on a dense leaf (MoE leaves excluded)."""
    from repro_torch.distributed.sharding import leaf_logical
    if ".moe." in name:
        return []
    rule = leaf_logical(name, len(shape))
    return [(d, shape[d]) for d, e in enumerate(rule) if e == "model"]


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_slice_of_every_dense_leaf(arch, mesh, runs):
    """1/m of a dense leaf on each dimension "model" divides (1/dp more
    on the one "data" divides), the whole dimension where it does not;
    and at least one leaf of every family is split over "model"."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    cfg = _config(arch, get_config)
    whole = {k: tuple(p.shape)
             for k, p in M.abstract_params(cfg).named_parameters()}
    dp, m = mesh
    _, ranks, _ = runs
    split = 0
    for r in ranks[mesh]:
        for name, shape in r[arch]["shapes"].items():
            for dim, size in _dense_split(name, cfg, whole[name], m):
                want = size // m if size % m == 0 else size
                split += want != size
                assert shape[dim] == want, (name, shape, whole[name])
            assert np.prod(shape) <= np.prod(whole[name])
    assert split > 0


def _predicted(cfg, m: int) -> dict:
    """The collectives over "model" of one forward under tensor
    parallelism: a sum per attention layer whose heads split (after
    ``wo``), per MLP whose ffn splits (after ``w_down``), per MoE block
    (the expert-parallel combine), two per SSM block whose heads split
    (its gated norm's squares, ``out_proj``), one for the embedding
    whose vocabulary splits; one gather of the logits, and four per SSM
    block whose d_inner splits but whose heads do not (its d_inner
    leaves, gathered whole)."""
    def attn_layer():
        return (cfg.n_heads % m == 0) + (
            1 if cfg.n_experts else cfg.d_ff % m == 0)

    ssm_split = cfg.ssm and cfg.n_ssm_heads % m == 0
    ssm_gathered = cfg.ssm and not ssm_split and cfg.d_inner % m == 0
    per_unit = 0
    for pos in range(cfg.period):
        per_unit += 2 * ssm_split if cfg.ssm else attn_layer()
    if cfg.ssm and cfg.shared_attn_every:
        per_unit += attn_layer()
    vocab = cfg.vocab % m == 0
    out = {"all_reduce_sum:model": per_unit * cfg.n_units
           + (vocab and not cfg.inputs_embeds)}
    gathers = vocab + 4 * ssm_gathered * cfg.num_layers
    if gathers:
        out["all_gather:model"] = gathers
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=str)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_collectives_over_model_are_the_design_s(arch, mesh, runs):
    from repro_torch.configs.registry import get_config
    cfg = _config(arch, get_config)
    _, ranks, _ = runs
    want = _predicted(cfg, mesh[1])
    for r in ranks[mesh]:
        got = {k: v for k, v in r[arch]["forward_stats"].items()
               if k.endswith(":model")}
        assert got == want


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_tp_checkpoint_restores_whole_and_on_another_mesh(arch, runs):
    """Saved by four ranks at (2, 2) after the train step: restored with
    no mesh it is the ranks' updated parameters, gathered, bit for bit;
    restored at (1, 2) each rank holds that mesh's slices of it."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.checkpoint import restore_checkpoint
    from repro_torch.distributed.sharding import local_shard, train_specs
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import abstract_opt_state

    _, ranks, ckpt = runs
    cfg = _config(arch, get_config)
    abstract = M.abstract_params(cfg)
    whole = restore_checkpoint(ckpt[arch], 1, {
        "params": abstract, "opt": abstract_opt_state(abstract)},
        device="cpu")
    saved = ranks[(2, 2)][0][arch]["updated"]
    for name, p in whole["params"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), saved[name],
                                      err_msg=name)
    assert int(whole["opt"].step) == 1

    class Rank(AbstractMesh):
        def __init__(self, coords):
            super().__init__((1, 2), ("data", "model"))
            self.coords = coords

        def coord(self, axis):
            return self.coords[axis]

    specs = train_specs(whole["params"], Rank({"data": 0, "model": 0}))
    assert any("model" in s for s in specs.values())
    for r in ranks[(1, 2)]:
        got = r[arch]["restored"]
        assert got["step"] == 1
        where = Rank(r["coords"])
        for name, p in whole["params"].named_parameters():
            np.testing.assert_array_equal(
                got["params"][name],
                local_shard(p.detach(), specs[name], where).numpy(),
                err_msg=name)
