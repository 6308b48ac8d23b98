"""The paper's contribution on PyTorch: b-bit sketch trie similarity
search (single-index, MI-bST and the sharded bST), the segmented index
on the tiered suffix column store and its sharded stacks, b-bit minhash
and 0-bit CWS, the paper's baselines, with the verify, scan and re-rank
kernels written in CUDA for Hopper."""

from .baselines import HmSearch, LinearScan, MIH, SIH, enumerate_signatures
from .bitvector import BitVector
from .bst import SketchIndex, build_bst, build_fst_style, build_louds, index_from_numpy
from .column_store import (ColumnStore, SuffixGeometry, geometry_for,
                           reset_tier_stats, tier_stats)
from .cost_model import cost_multi, cost_single, frontier_capacities, sigs
from .distributed_search import (ShardedBST, build_sharded_bst, gather_ids,
                                 gather_topk, make_sharded_searcher,
                                 sharded_bst_from_numpy)
from .hamming import (hamming_naive, hamming_pairwise_naive,
                      hamming_vertical, hamming_vertical_many, pack_sets,
                      pack_suffix_words, pack_suffix_words_torch,
                      pack_vertical, pack_vertical_torch, unpack_vertical)
from .multi_index import (MultiIndex, build_multi_index, choose_plan,
                          clear_mi_searcher_cache, make_mi_searcher,
                          mi_search, mi_search_batch, multi_index_from_numpy)
from .search import (SearchResult, TopKResult, bucket_m, clear_searcher_cache,
                     get_searcher, make_batch_searcher, make_searcher, search,
                     searcher_cache_info, topk, topk_batch)
from .segments import (ColumnSearchResult, Segment, SegmentedIndex,
                       SegmentedSearchResult, ShardedSegmentedIndex,
                       clear_fused_cache, dispatch_stats,
                       reset_dispatch_stats, tombstone_bits)
from .sketch import (bbit_minhash, cws_params, hash_params, jaccard,
                     minmax_kernel, sketch_tokens, zbit_cws)

__all__ = [
    "BitVector", "SketchIndex", "build_bst", "build_louds", "build_fst_style",
    "index_from_numpy", "LinearScan", "SIH", "MIH", "HmSearch",
    "enumerate_signatures",
    "SearchResult", "make_searcher", "make_batch_searcher", "search",
    "TopKResult", "topk", "topk_batch", "get_searcher", "bucket_m",
    "searcher_cache_info", "clear_searcher_cache",
    "MultiIndex", "build_multi_index", "mi_search", "mi_search_batch",
    "make_mi_searcher", "clear_mi_searcher_cache", "choose_plan",
    "multi_index_from_numpy",
    "ShardedBST", "build_sharded_bst", "make_sharded_searcher",
    "gather_ids", "gather_topk", "sharded_bst_from_numpy",
    "sigs", "cost_single", "cost_multi", "frontier_capacities",
    "pack_vertical", "pack_vertical_torch", "unpack_vertical",
    "Segment", "SegmentedIndex", "SegmentedSearchResult",
    "ColumnSearchResult", "ShardedSegmentedIndex", "tombstone_bits",
    "dispatch_stats", "reset_dispatch_stats", "clear_fused_cache",
    "ColumnStore", "SuffixGeometry", "geometry_for", "tier_stats",
    "reset_tier_stats", "pack_suffix_words", "pack_suffix_words_torch",
    "pack_sets", "hamming_naive", "hamming_pairwise_naive",
    "hamming_vertical", "hamming_vertical_many",
    "bbit_minhash", "hash_params", "jaccard", "sketch_tokens",
    "zbit_cws", "cws_params", "minmax_kernel",
]
