"""The port's sharding rules (``repro_torch.distributed.sharding``) and
meshes (``repro_torch.launch.mesh``) against the JAX package's, leaf by
leaf.

Every registry config at full size, its parameters and caches abstract
on both sides (JAX's ``eval_shape``, the port's ``meta`` device: nothing
is allocated), on stand-in meshes of (16, 16), (2, 16, 16), (2, 2) and
(1, 1): an object with ``shape`` and ``axis_names``, which is all
``_resolve`` reads.  The JAX package's spec functions wrap each spec in
a ``NamedSharding``, which needs a real mesh of that many devices; the
tests hand them one that returns the bare spec instead.  The port's
parameters and caches are unstacked, so a unit leaf's spec is the JAX
leaf's without its leading ``n_units`` entry.  Specs are compared
exactly.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_IDS as JARCH_IDS
from repro.configs.registry import get_config as jget_config
from repro.distributed import sharding as JS
from repro.launch import mesh as JMESH
from repro.models import model as JM
from repro.models.config import SHAPES as JSHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.distributed import sharding as TS
from repro_torch.launch import mesh as TMESH
from repro_torch.models import io as TIO
from repro_torch.models import model as TM
from repro_torch.models.config import SHAPES


class StandIn:
    """A mesh as ``_resolve`` reads it, and ``local_shard`` (coords)."""

    def __init__(self, shape, axes, coords=None):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.coords = dict(zip(axes, coords or (0,) * len(axes)))

    def coord(self, axis):
        return self.coords[axis]


MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "1x1": ((1, 1), ("data", "model")),
}


class Bare:
    """What the JAX package's spec functions return under ``bare_specs``:
    the spec's content, a leaf of their pytrees."""

    def __init__(self, mesh, spec):
        self.spec = tuple(spec)

    def __eq__(self, other):
        return self.spec == other


@pytest.fixture
def bare_specs(monkeypatch):
    """The JAX package's spec functions, returning the spec itself."""
    monkeypatch.setattr(JS, "NamedSharding", Bare)


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    return JM.abstract_params(jget_config(arch))


def _jax_key(path):
    return tuple(JS._path_names(path))


def test_registry_is_the_reference_s():
    assert tuple(ARCH_IDS) == tuple(JARCH_IDS)
    assert TS._LOGICAL == JS._LOGICAL
    assert SHAPES.keys() == JSHAPES.keys()


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, mesh, bare_specs):
    m = StandIn(*MESHES[mesh])
    want = {_jax_key(path): bare.spec for path, bare in
            jax.tree_util.tree_leaves_with_path(
                JS.param_specs(_jax_abstract(arch), m))}
    got = TS.param_specs(TM.abstract_params(get_config(arch)), m)
    seen = set()
    for name, spec in got.items():
        parts = name.split(".")
        if parts[0] == "units":               # unit u: the stack's entry off
            key = tuple(["units"] + parts[2:])
            assert spec == want[key][1:], (name, spec, want[key])
        else:
            key = tuple(parts)
            assert spec == want[key], (name, spec, want[key])
        seen.add(key)
    assert seen == want.keys()


def test_param_logical_is_the_reference_rule():
    """The rule itself on every name it knows, at the unstacked rank and
    with extra leading axes."""
    names = ["embed", "lm_head", "wq", "wk", "wv", "wo", "router", "w_gate",
             "w_up", "w_down", "wz", "wx", "wB", "wC", "wdt", "out_proj",
             "conv_x", "ln1", "A_log"]
    for name in names:
        for prefix in ((), ("units", "l0"), ("units", "l0", "moe"),
                       ("units", "l0", "moe", "shared")):
            for ndim in (1, 2, 3, 4):
                path = prefix + (name,)
                assert (TS._param_logical(path, ndim)
                        == tuple(JS._param_logical(path, ndim))), (path, ndim)


@pytest.mark.parametrize("kv_shard", ["heads", "seq"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_specs_match_jax(arch, kv_shard, bare_specs):
    """Decode caches at decode_32k (batch 128) and long_500k (batch 1:
    the batch falls back to whole) on every mesh."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for shape in ("decode_32k", "long_500k"):
        B, S = SHAPES[shape].global_batch, SHAPES[shape].seq_len
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S))
        cache = TM.init_cache(cfg, B, S, device="meta")
        for mesh in MESHES.values():
            m = StandIn(*mesh)
            want = [bare.spec for bare in jax.tree_util.tree_leaves(
                JS.cache_specs(jcache, m, kv_shard))]
            got = TS.cache_specs(cache, m, kv_shard)
            per_unit = len(want)
            units = list(got.items())
            assert len(units) == cfg.n_units * per_unit
            for u in range(cfg.n_units):
                mine = [spec for _, spec in
                        units[u * per_unit:(u + 1) * per_unit]]
                assert mine == [w[1:] for w in want], (shape, mesh, u)


@pytest.mark.parametrize("mesh", MESHES)
def test_batch_specs_match_jax(mesh, bare_specs):
    m = StandIn(*MESHES[mesh])
    for arch in ("smollm-135m", "hubert-xlarge"):
        for shape in SHAPES.values():
            for batch in (shape.global_batch, 3):
                specs = TIO.batch_specs_for(get_config(arch), batch,
                                            shape.seq_len, True)
                want = JS.batch_specs({k: jax.ShapeDtypeStruct(
                    tuple(v.shape), np.int32) for k, v in specs.items()}, m)
                assert TS.batch_specs(specs, m) == {
                    k: v.spec for k, v in want.items()}


def test_resolve_divisibility_fallback():
    m = StandIn((2, 16, 16), ("pod", "data", "model"))
    for spec, shape in (((("batch",), "model"), (64, 48)),
                        (("batch", "model"), (1, 32)),
                        (("data", None, "expert"), (16, 3, 40)),
                        (("fsdp", "model"), (48, 7))):
        assert TS._resolve(spec, m, shape) == tuple(
            JS._resolve(spec, m, shape))
    assert TS.replicated(m) == tuple(JS.P())


def test_local_shard_tiles_the_tensor():
    """Every rank's slice, placed back by its coordinates, rebuilds the
    tensor; a tuple of axes splits major-to-minor."""
    x = torch.arange(8 * 6 * 4).reshape(8, 6, 4)
    axes = ("pod", "data", "model")
    spec = (("pod", "data"), None, "model")
    rebuilt = torch.zeros_like(x)
    for p in range(2):
        for d in range(2):
            for mm in range(2):
                m = StandIn((2, 2, 2), axes, (p, d, mm))
                s = TS.local_shard(x, spec, m)
                i = p * 2 + d
                rebuilt[i * 2:(i + 1) * 2, :, mm * 2:(mm + 1) * 2] = s
    assert torch.equal(rebuilt, x)
    with pytest.raises(ValueError, match="does not split"):
        TS.local_shard(torch.zeros(3, 2), ("data", None),
                       StandIn((2,), ("data",)))


def test_batch_coord_picks_the_rows_batch_specs_give_a_rank():
    """``batch_coord`` (pod-major) is the block of rows that a batch's
    resolved spec hands this rank, ``dp_shards`` the number of blocks;
    the model axis takes no part."""
    x = torch.arange(8 * 3).reshape(8, 3)
    axes = ("pod", "data", "model")
    for p in range(2):
        for d in range(2):
            for mm in range(2):
                m = StandIn((2, 2, 2), axes, (p, d, mm))
                n, i = TS.dp_shards(m), TS.batch_coord(m)
                spec = TS.batch_specs({"tokens": x}, m)["tokens"]
                assert n == 4 and i == p * 2 + d
                assert torch.equal(TS.local_shard(x, spec, m),
                                   x[i * 2:(i + 1) * 2])
    assert TS.dp_shards(StandIn((3,), ("model",))) == 1


def test_use_mesh_restores_the_previous_mesh():
    a, b = StandIn((1,), ("data",)), StandIn((1, 1), ("data", "model"))
    assert TS.get_global_mesh() is None
    with TS.use_mesh(a):
        with TS.use_mesh(b):
            assert TS.get_global_mesh() is b
        assert TS.get_global_mesh() is a
    assert TS.get_global_mesh() is None


def test_meshes_match_the_reference_s():
    """The production meshes' shapes and axes; dp_shards; the host mesh of
    a process with no group is one rank on ("data",)."""
    for multi in (False, True):
        mine = TMESH.make_production_mesh(multi_pod=multi)
        shape = (2, 16, 16) if multi else (16, 16)
        axes = ("pod", "data", "model") if multi else ("data", "model")
        assert mine.axis_names == axes
        assert tuple(mine.shape.values()) == shape
        assert TMESH.dp_shards(mine) == JMESH.dp_shards(
            StandIn(shape, axes))
        assert mine.size == int(np.prod(shape))
    host = TMESH.make_host_mesh()
    assert host.axis_names == ("data",) and host.shape == {"data": 1}
    assert host.device_mesh is None and TMESH.dp_shards(host) == 1
    x = torch.ones(3)
    assert host.all_reduce(x, "data") is x
    assert host.all_gather(x, "data") is x and host.stats == {}
    with pytest.raises(RuntimeError, match="process group"):
        TMESH.make_mesh((2,), ("data",))


def test_init_distributed_outside_the_launcher(monkeypatch):
    """A process the launcher did not start starts no group."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert TMESH.init_distributed("cpu") is False
    assert not torch.distributed.is_initialized()
    assert TMESH.default_backend(torch.device("cpu"), 2) == "gloo"
