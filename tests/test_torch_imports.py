"""The port stands alone: importing it (its ``obs``, ``store`` and
``serving`` copies and the mesh layer included) pulls in neither jax nor
the JAX package, the mesh layer starts no process group on import,
no source of it (nor of its tools and examples) names ``repro``, its
entry points (and those of its tools and examples) refuse a missing CUDA
device instead of running on the CPU, and ``chip_smoke.py`` fails
without a card."""

import importlib.util
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import (HmSearch, LinearScan, MIH,
                              ShardedSegmentedIndex, build_bst,
                              build_fst_style, build_louds, build_multi_index,
                              build_sharded_bst, multi_index_from_numpy,
                              sharded_bst_from_numpy)
from repro_torch.configs.registry import get_config
from repro_torch.core.bst import index_from_numpy
from repro_torch.data.pipeline import DataConfig, SketchDedupPipeline
from repro_torch.launch import serve, train
from repro_torch.models.io import synthetic_batch
from repro_torch.models.model import (init_cache, init_params,
                                      params_from_jax, ssm_cfg)
from repro_torch.models.ssm import ssm_cache_init
from repro_torch.serving import CollectionConfig, CollectionRegistry, Scheduler

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
# the port's tools and examples: every *_torch.py beside a JAX one
TOOLS = sorted((ROOT / "tools").glob("*_torch.py"))
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def _load(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_import_pulls_in_no_jax_and_no_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    assert "repro_torch.core.search" in names and "repro_torch.kernels.ops" in names
    for name in ("repro_torch.models.model", "repro_torch.models.flash",
                 "repro_torch.models.moe", "repro_torch.models.ssm",
                 "repro_torch.configs.registry", "repro_torch.train.steps",
                 "repro_torch.launch.serve", "repro_torch.obs",
                 "repro_torch.obs.trace", "repro_torch.obs.explain",
                 "repro_torch.obs.prom", "repro_torch.obs.slowlog",
                 "repro_torch.core.multi_index",
                 "repro_torch.core.distributed_search",
                 "repro_torch.core.baselines",
                 "repro_torch.store", "repro_torch.store.store",
                 "repro_torch.store.wal", "repro_torch.store.atomic",
                 "repro_torch.store.faults", "repro_torch.serving",
                 "repro_torch.serving.scheduler",
                 "repro_torch.serving.collections",
                 "repro_torch.serving.metrics",
                 "repro_torch.serving.overload",
                 "repro_torch.serving.batching",
                 "repro_torch.data.pipeline", "repro_torch.optim.adamw",
                 "repro_torch.distributed.checkpoint",
                 "repro_torch.distributed.fault_tolerance",
                 "repro_torch.distributed.compression",
                 "repro_torch.launch.train") + MESH_MODULES + DRYRUN_MODULES:
        assert name in names, name
    code = ("import importlib, sys\n"
            f"for name in ['repro_torch'] + {names!r}:\n"
            "    importlib.import_module(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr


MESH_MODULES = ("repro_torch.launch.mesh", "repro_torch.distributed.sharding",
                "repro_torch.models.io", "repro_torch.models.moe_sharded",
                "repro_torch.models.decode_sp")


def test_mesh_modules_start_nothing_on_import():
    """The mesh layer's five modules import neither jax nor the JAX
    package, and importing them starts no process group, initialises no
    card and leaves no mesh set."""
    code = ("import sys, torch, torch.distributed as dist\n"
            f"for name in {list(MESH_MODULES)!r}:\n"
            "    __import__(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n"
            "from repro_torch.distributed.sharding import get_global_mesh\n"
            "assert get_global_mesh() is None\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr


DRYRUN_MODULES = ("repro_torch.launch.op_cost",
                  "repro_torch.launch.op_analysis",
                  "repro_torch.launch.dryrun",
                  "repro_torch.launch.dryrun_search",
                  "repro_torch.launch.profile_cell")


def test_dryrun_modules_start_nothing_on_import():
    """The five dry-run modules import neither jax nor the JAX package
    (nor set ``XLA_FLAGS``, as the reference's do), start no process
    group, initialise no card and leave no counter active; a counting
    mesh's collectives start no group either."""
    code = ("import os, sys, torch, torch.distributed as dist\n"
            f"for name in {list(DRYRUN_MODULES)!r}:\n"
            "    __import__(name)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n"
            "assert 'XLA_FLAGS' not in os.environ\n"
            "from repro_torch.kernels import ops\n"
            "assert ops._COUNTER is None\n"
            "from repro_torch.launch.mesh import CountingMesh\n"
            "m = CountingMesh((2, 16, 16), ('pod', 'data', 'model'))\n"
            "x = torch.empty((4, 8), device='meta')\n"
            "assert m.all_gather(x, 'data', dim=1).shape == (4, 128)\n"
            "assert m.all_reduce(x, ('pod', 'data')) is x\n"
            "assert m.stats == {'all_gather:data': [1, 2048, 0.0],"
            " 'all_reduce_sum:pod': [1, 128, 0.0],"
            " 'all_reduce_sum:data': [1, 128, 0.0]}, m.stats\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "XLA_FLAGS"):
        env.pop(var, None)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120, env=env)
    assert proc.returncode == 0, proc.stderr


_REPRO_IMPORT = re.compile(r"^\s*(import\s+repro(\.|\s|$)|from\s+repro(\.|\s+import))",
                           re.MULTILINE)
_JAX_IMPORT = re.compile(r"^\s*(import|from)\s+jax\b", re.MULTILINE)


def test_no_source_imports_repro_or_jax():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + TOOLS + EXAMPLES)
    assert len(files) > 10
    for f in files:
        text = f.read_text()
        assert not _REPRO_IMPORT.search(text), f
        assert not _JAX_IMPORT.search(text), f


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = np.random.default_rng(0).integers(0, 4, size=(50, 8)).astype(np.uint8)
    for build in (build_bst, build_louds, build_fst_style, LinearScan.build):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build(db, 2)
    index = build_bst(db, 2, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.to("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index_from_numpy({}, [])
    for build in (lambda: build_multi_index(db, 2, 2),
                  lambda: build_sharded_bst(db, 2, 2),
                  lambda: MIH.build(db, 2, 2), lambda: HmSearch.build(db, 2, 1),
                  lambda: multi_index_from_numpy({}, []),
                  lambda: sharded_bst_from_numpy({}, []),
                  lambda: ShardedSegmentedIndex(8, 2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build()
    cfg = get_config("smollm-135m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        synthetic_batch(cfg, 1, 8, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ssm_cache_init(1, ssm_cfg(get_config("mamba2-1.3b", smoke=True)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SketchDedupPipeline(DataConfig(vocab=8, batch=1, seq=4))
    for entry in (CollectionRegistry, Scheduler,
                  lambda: CollectionRegistry.open("no-such-dir"),
                  lambda: CollectionConfig(L=8, b=2).create(),
                  lambda: serve.main(["--ingest"]),
                  lambda: serve.main(["--retrieval", "--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_tools_and_examples_pull_in_no_jax():
    names = {p.name for p in TOOLS + EXAMPLES}
    for want in ("eval_recall_torch.py", "capacity_smoke_torch.py",
                 "recovery_smoke_torch.py", "overload_smoke_torch.py",
                 "retrieval_serve_torch.py", "train_smollm_torch.py"):
        assert want in names, want
    code = ("import importlib.util, sys\n"
            f"for path in {[str(p) for p in TOOLS + EXAMPLES]!r}:\n"
            "    spec = importlib.util.spec_from_file_location('m', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
            " or m == 'repro' or m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("script,argv", [
    ("tools/eval_recall_torch.py", ["--smoke"]),
    ("tools/capacity_smoke_torch.py", ["64"]),
    ("tools/recovery_smoke_torch.py", ["64"]),
    ("tools/overload_smoke_torch.py", ["--smoke"]),
    ("examples/retrieval_serve_torch.py", []),
    ("examples/train_smollm_torch.py", ["--smoke", "--steps", "1"]),
])
def test_tools_and_examples_default_to_cuda(monkeypatch, script, argv):
    """``--device`` defaults to cuda: without a card each one raises
    instead of running on the CPU."""
    mod = _load(ROOT / script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """A copy standing alone, away from the repository, exits nonzero and
    prints no result line; so does the script itself without CUDA."""
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    scripts = [alone] + ([] if torch.cuda.is_available()
                         else [ROOT / "chip_smoke.py"])
    for script in scripts:
        proc = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
