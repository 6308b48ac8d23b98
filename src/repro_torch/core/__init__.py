"""The paper's contribution on PyTorch: b-bit sketch trie similarity
search, with the verify and scan kernels written in CUDA for Hopper."""

from .baselines import LinearScan
from .bitvector import BitVector
from .bst import SketchIndex, build_bst, build_fst_style, build_louds, index_from_numpy
from .cost_model import cost_multi, cost_single, frontier_capacities, sigs
from .hamming import pack_vertical, pack_vertical_torch, unpack_vertical
from .search import (SearchResult, TopKResult, bucket_m, clear_searcher_cache,
                     get_searcher, make_batch_searcher, make_searcher, search,
                     searcher_cache_info, topk, topk_batch)

__all__ = [
    "BitVector", "SketchIndex", "build_bst", "build_louds", "build_fst_style",
    "index_from_numpy", "LinearScan",
    "SearchResult", "make_searcher", "make_batch_searcher", "search",
    "TopKResult", "topk", "topk_batch", "get_searcher", "bucket_m",
    "searcher_cache_info", "clear_searcher_cache",
    "sigs", "cost_single", "cost_multi", "frontier_capacities",
    "pack_vertical", "pack_vertical_torch", "unpack_vertical",
]
