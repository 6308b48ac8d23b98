"""Groups of CPU ranks for the port's multi-rank tests.

``run_ranks(worker, world, tmp_path, payload)`` spawns ``world``
processes; each starts a gloo process group through a file under
``tmp_path`` (so parallel test workers never race for a port), calls
``worker(payload)`` — a function of an importable module, run under the
group — and saves what it returns.  The parent waits up to ``timeout``
seconds for the group, kills every rank on expiry, and raises if a rank
failed; it returns the ranks' results in rank order.  Workers import
torch and the port only: the JAX package never enters a rank.

``run_cli(cmd)`` runs one command line of the port's drivers (one
interpreter, or ``python -m torch.distributed.run`` and its ranks) as
the CLI tests launch them, and returns its standard output.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import signal
import subprocess
import time
import traceback
from pathlib import Path

import torch

GROUP_TIMEOUT_S = 60.0
# A launch of a driver takes 7-20 s on an 8-core CPU host, 9-31 s there
# beside the rest of the suite under ``-n 6``; the limit is a hang's, not
# a slow host's.
CLI_TIMEOUT_S = 300.0


def _child(worker, rank: int, world: int, tmp: str, payload) -> None:
    from repro_torch.launch.mesh import init_distributed, shutdown_distributed

    torch.set_num_threads(1)
    out = Path(tmp) / f"rank{rank}.pt"
    try:
        init_distributed("cpu", rank=rank, world_size=world,
                         init_method=f"file://{tmp}/group",
                         timeout_s=GROUP_TIMEOUT_S)
        clean = False
        try:
            result = worker(payload)
            clean = True
        finally:
            shutdown_distributed(clean=clean)
        torch.save({"ok": result}, out)
    except BaseException:                  # reported by the parent
        torch.save({"error": traceback.format_exc()}, out)
        raise


def run_ranks(worker, world: int, tmp_path, payload=None,
              timeout: float = GROUP_TIMEOUT_S) -> list:
    tmp = Path(tmp_path) / f"ranks{world}_{worker.__name__}"
    tmp.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child, args=(worker, r, world, str(tmp),
                                              payload), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.1))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
    if alive:
        raise TimeoutError(f"{len(alive)} of {world} ranks still running "
                           f"after {timeout} s; killed")
    results = []
    for r, p in enumerate(procs):
        f = tmp / f"rank{r}.pt"
        got = torch.load(f, weights_only=False) if f.exists() else {}
        if p.exitcode != 0 or "ok" not in got:
            raise RuntimeError(f"rank {r} exited {p.exitcode}:\n"
                               f"{got.get('error', '(no report)')}")
        results.append(got["ok"])
    return results


def env_with_src() -> dict:
    """The environment for a child interpreter: ``src`` on its path."""
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


def run_cli(cmd: list, timeout: float = CLI_TIMEOUT_S) -> str:
    """Run ``cmd`` with ``src`` on its path and return its standard
    output.  Every process of it runs one intra-op thread (what
    ``torch.distributed.run`` gives its ranks, so a one-rank run and the
    ranks it is held against share the arithmetic and the host is not
    oversubscribed beside the suite's workers), one ``PYTHONHASHSEED``
    (F10), and glibc's resolver one 1-s try a lookup: c10d reverse-
    resolves every store connection of a launch (its "hostname of the
    client socket cannot be retrieved" warnings), a v4-mapped address
    that ``/etc/hosts`` does not name, so each lookup asks the DNS
    resolver, however long it takes to answer.  ``cmd`` runs
    in a session of its own: on ``timeout`` the whole session is killed,
    the launcher's ranks too.  A nonzero exit or a timeout raises with
    the exit code, the seconds and the tails of both streams."""
    env = dict(env_with_src(), OMP_NUM_THREADS="1", PYTHONHASHSEED="0",
               RES_OPTIONS="timeout:1 attempts:1")
    t0 = time.monotonic()
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        what = f"exited {proc.returncode}"
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        what = f"timed out after {timeout:g} s (session killed)"
    if what != "exited 0":
        raise AssertionError(
            f"{' '.join(cmd[1:])} {what} in {time.monotonic() - t0:.1f} s\n"
            f"--- stdout (tail):\n{out[-2000:]}\n--- stderr (tail):\n"
            f"{err[-3000:]}")
    return out


# ---------------------------------------------------------------------------
# workers: each runs under the group and returns numpy arrays
# ---------------------------------------------------------------------------

def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    else:
        yield prefix[:-1], tree


def leave_after_collective_worker(payload) -> float:
    """One all_reduce, then rank 1 returns at once while rank 0 sleeps
    ``payload`` seconds first: ``_child``'s teardown
    (``launch.mesh.shutdown_distributed``) must hold rank 1 at its
    barrier until rank 0 is done, and neither rank may abort."""
    import torch.distributed as dist
    x = torch.full((1024,), float(dist.get_rank() + 1))
    dist.all_reduce(x)
    if dist.get_rank() == 0:
        time.sleep(payload)
    return float(x[0])


def moe_sharded_worker(payload) -> list:
    """``moe_apply_sharded`` on this rank's shards and rows for every mesh
    and case of ``payload``: per (mesh, case) the output rows and, where
    the case asks, the gradients of the global sum on the shards and the
    rows."""
    from repro_torch.launch.mesh import batch_coord, dp_shards, make_mesh
    from repro_torch.models.moe_sharded import (moe_apply_sharded,
                                                shard_moe_params)
    out = []
    for shape in payload["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        n, d = dp_shards(mesh), batch_coord(mesh)
        for case in payload["cases"]:
            x = torch.from_numpy(case["x"])
            rows = x.shape[0] // n
            x = x[d * rows:(d + 1) * rows].clone().requires_grad_(
                case["grad"])
            shards = shard_moe_params(_tensors(case["params"]), mesh)
            for _, leaf in _leaves(shards):
                leaf.requires_grad_(case["grad"])
            y = moe_apply_sharded(shards, x, mesh, top_k=2, act="silu",
                                  capacity_factor=case["cf"])
            res = {"y": y.detach().numpy()}
            if case["grad"]:
                y.sum().backward()
                res["dx"] = x.grad.numpy()
                res["grads"] = {k: v.grad.numpy()
                                for k, v in _leaves(shards)}
            out.append(res)
    return out


def moe_data_parallel_worker(payload) -> list:
    """``moe_apply`` with one group over the global batch on a ("data",)
    mesh of every rank: this rank's output rows and kept mask; and the
    model's MoE dispatch under that mesh at each of ``payload``'s
    ``moe_groups``: this rank's rows, or the error it raises."""
    from types import SimpleNamespace

    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.launch.mesh import batch_coord, make_host_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe
    mesh = make_host_mesh()
    n, r = mesh.shape["data"], batch_coord(mesh)
    out = []
    for case in payload["cases"]:
        x = torch.from_numpy(case["x"])
        rows = x.shape[0] // n
        mine = x[r * rows:(r + 1) * rows]
        y = moe.moe_apply(_tensors(case["params"]), mine,
                          top_k=2, act="silu", capacity_factor=case["cf"],
                          mesh=mesh)
        idx = torch.from_numpy(case["idx"])
        t = idx.shape[1] // n
        keep = moe._capacity_plan(idx[:, r * t:(r + 1) * t], case["E"],
                                  case["cf"], mesh=mesh)[0]
        cfg = SimpleNamespace(top_k=2, act="silu",
                              capacity_factor=case["cf"])
        grouped = {}
        for g in payload["moe_groups"]:
            try:
                with use_mesh(mesh):
                    grouped[g] = M._moe_dispatch(_tensors(case["params"]),
                                                 mine, cfg, g).numpy()
            except ValueError as e:
                grouped[g] = str(e)
        out.append({"y": y.numpy(), "keep": keep.numpy(),
                    "grouped": grouped})
    return out


def decode_sp_worker(payload) -> list:
    """``decode_attention_seq_sharded`` on this rank's slices of each
    case's caches: the attention output and the slices after the write."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.decode_sp import decode_attention_seq_sharded
    out = []
    for shape in payload["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        m, i = mesh.shape["model"], mesh.coord("model")
        for case in payload["cases"]:
            kc, vc = (torch.from_numpy(case[k]) for k in ("kc", "vc"))
            n = kc.shape[1] // m
            kc, vc = (c[:, i * n:(i + 1) * n].clone() for c in (kc, vc))
            att, kc, vc = decode_attention_seq_sharded(
                *(torch.from_numpy(case[k]) for k in ("q", "kn", "vn")),
                kc, vc, case["clen"], mesh, cap=case["cap"])
            out.append({"out": att.numpy(), "kc": kc.numpy(),
                        "vc": vc.numpy(), "stats": dict(mesh.stats)})
    return out


def model_worker(payload) -> list:
    """Prefill and teacher-forced decode of a SMOKE model (the JAX
    package's parameters, carried across) under each mesh of
    ``payload``: per (arch, mesh) this rank's logits of every step and
    its caches after the prefill."""
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import shard_state, use_mesh
    from repro_torch.launch.mesh import batch_coord, dp_shards, make_mesh
    from repro_torch.models import model as M
    out = []
    for case in payload["cases"]:
        cfg = get_config(case["arch"], smoke=True)
        params = M.params_from_jax(case["params"], cfg, device="cpu")
        for shape in payload["meshes"]:
            mesh = make_mesh(shape, ("data", "model"))
            n, d = dp_shards(mesh), batch_coord(mesh)
            toks = torch.from_numpy(case["toks"])
            rows = toks.shape[0] // n
            toks = toks[d * rows:(d + 1) * rows]
            fed = torch.from_numpy(case["fed"])[d * rows:(d + 1) * rows]
            mine = shard_state(params, mesh)
            with use_mesh(mesh):
                logits, cache, n_len = M.prefill(
                    mine, cfg, {"tokens": toks}, s_max=case["s_max"])
                caches = [[t.float().numpy().copy() for t in layer]
                          for unit in cache for layer in unit.values()]
                steps = [logits.numpy()]
                for i in range(fed.shape[1]):
                    logits, cache = M.decode_step(mine, cfg, fed[:, i:i + 1],
                                                  cache, n_len + i)
                    steps.append(logits.numpy())
            out.append({"logits": steps, "caches": caches,
                        "stats": dict(mesh.stats)})
    return out


def _mesh_of(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data",) if len(shape) == 1
                     else ("data", "model"))


def _rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global numpy batch, as tensors."""
    from repro_torch.launch.mesh import batch_coord, dp_shards
    n, c = dp_shards(mesh), batch_coord(mesh)
    return {k: torch.from_numpy(v[c * (v.shape[0] // n):
                                  (c + 1) * (v.shape[0] // n)].copy())
            for k, v in batch.items()}


def _train_runs(payload, mesh) -> list:
    """Three float32 train steps of every case under ``mesh``: each step's
    loss and gradient norm, the gathered parameters (on rank 0) and the
    mesh's collectives; returns the runs and {arch: its final state}."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.sharding import (gather_state, shard_state,
                                                  use_mesh)
    from repro_torch.launch.mesh import dp_shards
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import Hyper, adamw_init
    from repro_torch.train.steps import make_train_step
    runs, state = [], {}
    for case in payload["cases"]:
        cfg = get_config(case["arch"], smoke=True)
        params = shard_state(M.params_from_jax(case["params"], cfg,
                                               device="cpu"), mesh)
        opt = adamw_init(params)
        groups = dp_shards(mesh) if cfg.n_experts else 1
        step = make_train_step(cfg, Hyper(**payload["hyper"]),
                               moe_groups=groups,
                               compute_dtype=torch.float32)
        specs, _ = M.placement(cfg, mesh)
        losses, norms = [], []
        with use_mesh(mesh):
            for b in case["batches"]:
                params, opt, m = step(params, opt, _rows(b, mesh))
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        whole = gather_state(params, mesh, specs)
        run = {"loss": losses, "norm": norms}
        if dist.get_rank() == 0:
            run["params"] = {n: p.detach().numpy().copy()
                             for n, p in whole.named_parameters()}
        runs.append(run)
        state[case["arch"]] = (params, opt, specs)
    return runs, state


def train_mesh_worker(payload) -> dict:
    """The port's train step under each mesh of ``payload`` (every case);
    at four ranks also the elastic save of the last case's state at mesh
    (2, 2) (``elastic_arch``); at two ranks also the uneven-mask loss, the restart drill
    through ``launch.train.main`` and the elastic restores at (1, 2) and
    (2, 1) of ``payload["elastic_dir"]``."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed.checkpoint import AsyncCheckpointer
    from repro_torch.distributed.fault_tolerance import resume_or_init
    from repro_torch.distributed.sharding import shard_state, use_mesh
    from repro_torch.launch import train as T
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import abstract_opt_state
    out = {"runs": {}}
    for shape in payload["meshes"]:
        mesh = _mesh_of(shape)
        out["runs"][tuple(shape)], state = _train_runs(payload, mesh)
        out.setdefault("stats", {})[tuple(shape)] = dict(mesh.stats)
    if payload.get("save_dir"):
        params, opt, specs = state[payload["elastic_arch"]]
        ck = AsyncCheckpointer(payload["save_dir"], mesh=mesh)
        ck.save(3, {"params": params, "opt": opt}, specs)
        ck.wait()
    if "uneven" in payload:
        u = payload["uneven"]
        cfg = get_config(u["arch"], smoke=True)
        mesh = _mesh_of((2,))
        params = shard_state(M.params_from_jax(u["params"], cfg,
                                               device="cpu"), mesh)
        with use_mesh(mesh):
            out["uneven"] = float(M.loss_fn(params, cfg,
                                            _rows(u["batch"], mesh)))
    if "drill" in payload:
        d = payload["drill"]
        argv = ["--smoke", "--device", "cpu", "--steps", "6", "--seq", "64",
                "--ckpt-every", "2", "--log-every", "100"]
        losses = {}

        def record(tag):
            return lambda step, m: losses.setdefault(tag, {}).__setitem__(
                step, float(m["loss"]))
        out["drill"] = [
            T.main(argv + ["--ckpt-dir", d["a"], "--fail-at", "4"]),
            T.main(argv + ["--ckpt-dir", d["a"]], on_step=record("resumed")),
            T.main(argv + ["--ckpt-dir", d["b"]], on_step=record("straight"))]
        out["drill_losses"] = losses
    if "elastic_dir" in payload:
        arch = payload["elastic_arch"]
        cfg = get_config(arch, smoke=True)
        abstract = M.abstract_params(cfg)
        state_abs = {"params": abstract, "opt": abstract_opt_state(abstract)}
        out["elastic"] = {}
        for shape in ((1, 2), (2, 1)):
            mesh = _mesh_of(shape)
            tree, step = resume_or_init(payload["elastic_dir"], state_abs,
                                        lambda: None, device="cpu",
                                        mesh=mesh)
            out["elastic"][shape] = {
                "step": step, "coords": dict(mesh.coords),
                "params": {n: p.detach().numpy().copy() for n, p in
                           tree["params"].named_parameters()},
                "mu": {n: p.detach().numpy().copy() for n, p in
                       tree["opt"].mu.named_parameters()}}
    return out


def moe_stats_worker(payload) -> dict:
    """``moe_apply_sharded``'s forward and backward under each mesh of
    ``payload`` on this rank's shards and rows: ``Mesh.stats`` (calls
    and bytes) of each."""
    from repro_torch.launch.mesh import batch_coord, dp_shards, make_mesh
    from repro_torch.models.moe_sharded import (moe_apply_sharded,
                                                shard_moe_params)
    out = {}
    for shape in payload["meshes"]:
        mesh = make_mesh(shape, ("data", "model"))
        n, d = dp_shards(mesh), batch_coord(mesh)
        x = torch.from_numpy(payload["x"])
        rows = x.shape[0] // n
        x = x[d * rows:(d + 1) * rows].clone().requires_grad_(True)
        shards = shard_moe_params(_tensors(payload["params"]), mesh)
        for _, leaf in _leaves(shards):
            leaf.requires_grad_(True)
        moe_apply_sharded(shards, x, mesh, top_k=2, act="silu",
                          capacity_factor=payload["cf"]).sum().backward()
        out[tuple(shape)] = {k: v[:2] for k, v in mesh.stats.items()}
    return out
