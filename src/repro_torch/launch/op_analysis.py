"""Collective statistics, the op census and the roofline of one rank — the
port's counterpart of the JAX package's ``launch/hlo_analysis.py``.

The JAX package parses the partitioned HLO; here the numbers come from
``launch/op_cost.py``'s counter and ``launch.mesh.CountingMesh``'s record
of the collectives.  The roofline's constants are the NVIDIA H100 SXM's
published peaks; the reference's TPU constants (``hlo_analysis.py``'s
``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW_PER_LINK``) are not carried
over.  Ranks are laid out row-major over the mesh's axes (as
``launch.mesh.Mesh`` lays out a process group's ranks), eight to a node:
a collective over an axis whose ranks stay inside one node moves at
NVLink's rate, one whose ranks span nodes at the cross-node rate.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

# NVIDIA H100 SXM5 datasheet: 989 TFLOP/s dense bf16 tensor core, 3.35 TB/s
# HBM3, NVLink 4 at 900 GB/s a card (450 GB/s each way) among a node's 8
PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9
NODE_CARDS = 8
# between nodes: one ConnectX-7 NDR InfiniBand port of 400 Gb/s per card
# (NVIDIA DGX H100 system: eight single-port ConnectX-7 for the compute
# fabric), 50 GB/s each way
CROSS_NODE_BYTES_PER_S = 50e9
HBM_CAPACITY_BYTES = 80e9          # an H100 80GB's memory


def axis_rate(mesh, axis: str) -> float:
    """Bytes/s of a collective over ``axis`` of ``mesh``: NVLink when its
    ranks (stride × size consecutive ranks, row-major) fit in one node,
    the cross-node rate otherwise."""
    stride = 1
    for a in reversed(mesh.axis_names):
        if a == axis:
            break
        stride *= mesh.shape[a]
    return (NVLINK_BYTES_PER_S if stride * mesh.shape[axis] <= NODE_CARDS
            else CROSS_NODE_BYTES_PER_S)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    largest: List[Tuple[str, int, str]]   # (kind, bytes, result shape)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collective_stats(mesh, top_n: int = 10) -> CollectiveStats:
    """A ``CountingMesh``'s calls by kind (``Mesh.stats``' bytes: an
    all-gather's result, an all-reduce's operand), and the largest single
    calls."""
    from .op_cost import _STAT_KINDS, COLLECTIVE_KINDS
    by_kind = {k: 0 for k in COLLECTIVE_KINDS}
    count = {k: 0 for k in COLLECTIVE_KINDS}
    largest = []
    for op, axis, operand, result, shape in getattr(mesh, "calls", ()):
        kind = _STAT_KINDS[op]
        stat = result if op == "all_gather" else operand
        by_kind[kind] += stat
        count[kind] += 1
        largest.append((f"{kind}:{axis}", stat, str(list(shape))))
    largest.sort(key=lambda t: -t[1])
    return CollectiveStats(by_kind, count, largest[:top_n])


def op_census(cost) -> Dict[str, int]:
    """Calls of each ATen op (and each counted kernel) in the step."""
    return dict(cost.census)


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    hbm_bytes_per_device: float
    collective_bytes_by_axis: Dict[str, float]
    axis_rates: Dict[str, float]

    @property
    def collective_bytes_per_device(self) -> float:
        return sum(self.collective_bytes_by_axis.values())

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_per_device / HBM_BYTES_PER_S

    @property
    def t_collective(self) -> float:
        return sum(b / self.axis_rates[a]
                   for a, b in self.collective_bytes_by_axis.items())

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    def summary(self) -> Dict[str, float]:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": (self.t_compute / self.t_bound
                                  if self.t_bound > 0 else 0.0),
        }
