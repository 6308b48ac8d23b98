"""Counting one rank's work op by op — the port's counterpart of the JAX
package's ``launch/hlo_cost.py``.

The JAX package lowers a step and walks XLA's HLO.  Eager PyTorch has no
such graph, so ``OpCounter`` (a ``TorchDispatchMode``) watches the step
run — on the ``meta`` device for a dry-run cell, where nothing is
computed, or on real tensors — and tallies each ATen op:

  * FLOPs: 2·M·N·K for a matrix product (``hlo_cost._dot_flops``' rule:
    2 × the result's elements × the contracted size), 2 × the result's
    elements × (in-channels / groups × kernel size) for a convolution,
    one per output element for any other op that computes (hlo_cost's
    rule for a generic op); views, allocations and detaches are free;
  * bytes: each op's tensor operands plus its results.  Eager PyTorch
    fuses nothing, so this is an upper bound on the memory traffic, not
    XLA's post-fusion figure (``Cost.bytes_note`` says so in a record);
  * the live bytes' high-water mark: every storage an op allocates,
    freed when the last tensor over it dies (``weakref.finalize``);
    tensors made before the counter started (parameters, batch) are the
    arguments and are not counted;
  * the hand-written kernels by formula: ``kernels.ops``' wrappers report
    their operations and bytes from their arguments' shapes through
    ``kernel()`` and the ops they run inside are not tallied
    (``kernels/ops.py``), so a count on ``meta`` reads the kernel's work,
    never the plain version's loops;
  * the collectives that a ``launch.mesh.CountingMesh`` records, by kind
    (``finish``): calls and bytes in ``Mesh.stats``' convention (an
    all-gather's result bytes, an all-reduce's operand), and, as
    hlo_cost adds them to the memory traffic, operand plus result bytes.

``scopes=True`` also tallies FLOPs and bytes by the chain of
``repro_torch`` functions on the Python stack (the JAX package's op
names' role, for ``profile_cell``).
"""

from __future__ import annotations

import dataclasses
import sys
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..kernels import ops as kops

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")
# ``Mesh.stats`` op names -> the HLO collective kinds of hlo_cost
_STAT_KINDS = {"all_gather": "all-gather", "all_reduce_sum": "all-reduce",
               "all_reduce_max": "all-reduce"}

_aten = torch.ops.aten
_MATMUL = {_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
           _aten.baddbmm.default, _aten.addbmm.default}
_CONV = {_aten.convolution.default}
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.new_empty.default, _aten.new_empty_strided.default,
         _aten.empty_like.default, _aten.detach.default, _aten.alias.default,
         _aten.lift_fresh.default, _aten.resize_.default,
         _aten._unsafe_view.default}


@dataclasses.dataclass
class Cost:
    """Per-rank totals, with the fields of ``hlo_cost.Cost``."""
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    coll_count: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    peak_bytes: int = 0
    kernels: Dict[str, list] = dataclasses.field(default_factory=dict)
    by_op: Dict[str, list] = dataclasses.field(default_factory=dict)
    scopes: Dict[Tuple[str, ...], list] = dataclasses.field(
        default_factory=dict)
    coll_by_axis: Dict[str, float] = dataclasses.field(default_factory=dict)
    bytes_note: str = ("eager ops, unfused: operands + results of every op "
                       "(an upper bound on the memory traffic)")

    @property
    def total_coll_bytes(self) -> float:
        return sum(self.coll_bytes.values())

    @property
    def census(self) -> Dict[str, int]:
        """Calls of each ATen op and each counted kernel."""
        return {k: v[0] for k, v in self.by_op.items()}

    @staticmethod
    def extrapolate(a: "Cost", b: "Cost", k: int, peak: str) -> "Cost":
        """The count ``k`` steps past ``a`` along an axis that ``a`` and
        ``b`` are one step apart on (microbatches, or identical units),
        when every tally is linear in it: a + k·(b - a).  The peak is the
        larger of the two (``peak="max"``: reached within a microbatch)
        or linear too (``"linear"``: the remat stash grows with the
        units)."""
        def lin(x, y):
            return x + k * (y - x)

        def lin_map(x: dict, y: dict) -> dict:
            out = {}
            for key in set(x) | set(y):
                u, v = x.get(key), y.get(key)
                if isinstance(u if u is not None else v, list):
                    u = u or [0] * len(v)
                    v = v or [0] * len(u)
                    out[key] = [lin(p, q) for p, q in zip(u, v)]
                else:
                    out[key] = lin(u or 0.0, v or 0.0)
            return out

        return Cost(flops=lin(a.flops, b.flops), bytes=lin(a.bytes, b.bytes),
                    coll_bytes=lin_map(a.coll_bytes, b.coll_bytes),
                    coll_count=lin_map(a.coll_count, b.coll_count),
                    peak_bytes=(max(a.peak_bytes, b.peak_bytes)
                                if peak == "max"
                                else lin(a.peak_bytes, b.peak_bytes)),
                    kernels=lin_map(a.kernels, b.kernels),
                    by_op=lin_map(a.by_op, b.by_op),
                    scopes=lin_map(a.scopes, b.scopes),
                    coll_by_axis=lin_map(a.coll_by_axis, b.coll_by_axis))

    def _add_op(self, name: str, flops: float, nbytes: float) -> None:
        rec = self.by_op.setdefault(name, [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += flops
        rec[2] += nbytes
        self.flops += flops
        self.bytes += nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _storage_key(t: torch.Tensor) -> Optional[int]:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def _op_flops(func, args, outs) -> float:
    if func in _MATMUL:
        a = args[1] if func in (_aten.addmm.default, _aten.baddbmm.default,
                                _aten.addbmm.default) else args[0]
        return 2.0 * sum(o.numel() for o in outs) * a.shape[-1]
    if func in _CONV:
        w = args[1]
        per = w.shape[1]
        for d in w.shape[2:]:
            per *= d
        return 2.0 * sum(o.numel() for o in outs) * per
    return float(sum(o.numel() for o in outs))


class OpCounter(TorchDispatchMode):
    """The counting mode (module doc).  ``with OpCounter() as c: step()``
    then ``c.finish(mesh)`` -> ``Cost``."""

    def __init__(self, scopes: bool = False):
        super().__init__()
        self.cost = Cost()
        self._scopes = scopes
        self._inside = 0                     # depth of kernel() regions
        self._live: Dict[int, list] = {}     # storage -> [bytes, tensors]
        self._now = 0
        self._prev_counter = None

    # -- the kernels' formula path (kernels/ops.py) ------------------------
    def kernel(self, name: str, ops_: float, nbytes: float):
        counter = self

        class _Region:
            def __enter__(self):
                counter._inside += 1
                k = counter.cost.kernels.setdefault(name, [0, 0.0, 0.0])
                k[0] += 1
                k[1] += ops_
                k[2] += nbytes
                counter.cost._add_op(name, ops_, nbytes)
                counter._scope_add(ops_, nbytes)

            def __exit__(self, *exc):
                counter._inside -= 1
        return _Region()

    def allocated(self, out) -> None:
        """Register a kernel wrapper's outputs as live allocations."""
        for t in _tensors(out):
            self._track(t, new=True)

    # -- live bytes ----------------------------------------------------------
    def _track(self, t: torch.Tensor, new: bool) -> None:
        key = _storage_key(t)
        if key is None:
            return
        rec = self._live.get(key)
        if rec is None:
            if not new:
                return
            rec = self._live[key] = [t.untyped_storage().nbytes(), 0]
            self._now += rec[0]
            self.cost.peak_bytes = max(self.cost.peak_bytes, self._now)
        rec[1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        rec = self._live.get(key)
        if rec is None:
            return
        rec[1] -= 1
        if rec[1] == 0:
            self._now -= rec[0]
            del self._live[key]

    # -- scopes --------------------------------------------------------------
    def _scope_add(self, flops: float, nbytes: float) -> None:
        if not self._scopes:
            return
        names = []
        f = sys._getframe(2)
        while f is not None:
            mod = f.f_globals.get("__name__", "")
            if mod.startswith("repro_torch.") and not mod.endswith(
                    ("op_cost", "kernels.ops")):
                names.append(f.f_code.co_name)
            f = f.f_back
        key = tuple(reversed(names)) or ("(no repro_torch frame)",)
        rec = self.cost.scopes.setdefault(key, [0.0, 0.0])
        rec[0] += flops
        rec[1] += nbytes

    # -- the mode ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside:
            return out
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        in_keys = {_storage_key(t) for t in ins}
        for t in outs:
            self._track(t, new=_storage_key(t) not in in_keys)
        if func.is_view or func in _FREE:
            return out
        flops = _op_flops(func, args, outs)
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.cost._add_op(func.overloadpacket.__name__, flops, nbytes)
        self._scope_add(flops, nbytes)
        return out

    def __enter__(self):
        self._prev_counter = kops.set_counter(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kops.set_counter(self._prev_counter)
        return super().__exit__(*exc)

    def finish(self, mesh=None) -> Cost:
        """The totals, with the collectives ``mesh`` (a ``CountingMesh``)
        recorded while the counter ran."""
        for op, axis, operand, result, _ in getattr(mesh, "calls", ()):
            kind = _STAT_KINDS[op]
            stat = result if op == "all_gather" else operand
            self.cost.coll_bytes[kind] += stat
            self.cost.coll_count[kind] += 1
            self.cost.coll_by_axis[axis] = self.cost.coll_by_axis.get(
                axis, 0.0) + stat
            self.cost.bytes += operand + result
        return self.cost
