"""The paper's contribution on PyTorch: b-bit sketch trie similarity
search, the segmented index on the tiered suffix column store, b-bit
minhash and 0-bit CWS, with the verify, scan and re-rank kernels written
in CUDA for Hopper."""

from .baselines import LinearScan
from .bitvector import BitVector
from .bst import SketchIndex, build_bst, build_fst_style, build_louds, index_from_numpy
from .column_store import (ColumnStore, SuffixGeometry, geometry_for,
                           reset_tier_stats, tier_stats)
from .cost_model import cost_multi, cost_single, frontier_capacities, sigs
from .hamming import (hamming_naive, hamming_pairwise_naive,
                      hamming_vertical, hamming_vertical_many, pack_sets,
                      pack_suffix_words, pack_suffix_words_torch,
                      pack_vertical, pack_vertical_torch, unpack_vertical)
from .search import (SearchResult, TopKResult, bucket_m, clear_searcher_cache,
                     get_searcher, make_batch_searcher, make_searcher, search,
                     searcher_cache_info, topk, topk_batch)
from .segments import (ColumnSearchResult, Segment, SegmentedIndex,
                       SegmentedSearchResult, clear_fused_cache,
                       dispatch_stats, reset_dispatch_stats, tombstone_bits)
from .sketch import (bbit_minhash, cws_params, hash_params, jaccard,
                     minmax_kernel, sketch_tokens, zbit_cws)

__all__ = [
    "BitVector", "SketchIndex", "build_bst", "build_louds", "build_fst_style",
    "index_from_numpy", "LinearScan",
    "SearchResult", "make_searcher", "make_batch_searcher", "search",
    "TopKResult", "topk", "topk_batch", "get_searcher", "bucket_m",
    "searcher_cache_info", "clear_searcher_cache",
    "sigs", "cost_single", "cost_multi", "frontier_capacities",
    "pack_vertical", "pack_vertical_torch", "unpack_vertical",
    "Segment", "SegmentedIndex", "SegmentedSearchResult",
    "ColumnSearchResult", "tombstone_bits", "dispatch_stats",
    "reset_dispatch_stats", "clear_fused_cache",
    "ColumnStore", "SuffixGeometry", "geometry_for", "tier_stats",
    "reset_tier_stats", "pack_suffix_words", "pack_suffix_words_torch",
    "pack_sets", "hamming_naive", "hamming_pairwise_naive",
    "hamming_vertical", "hamming_vertical_many",
    "bbit_minhash", "hash_params", "jaccard", "sketch_tokens",
    "zbit_cws", "cws_params", "minmax_kernel",
]
