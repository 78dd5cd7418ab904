"""Core library of the port: statistic functions, hashing, bottom-k
primitives, predicates, estimators and the MultiSketch slab."""
from .funcs import COUNT, SUM, StatFn, cap, combo, moment, thresh
from .hashing import hash_u32, ppswor_rank, rank_of, uniform01
from .bottomk import conditional_prob, f_seed, kth_and_tau
from .estimators import cv_bound, estimate_many
from .predicates import (EVERYTHING, SegmentPredicate, encode_predicates,
                         hash31, hash_fraction, key_mask, key_range,
                         never_row, pad_table, predicate_matrix)
from .multi_sketch import (MultiSketch, MultiSketchSpec, multisketch_absorb,
                           multisketch_absorb_inline,
                           multisketch_absorb_into,
                           multisketch_absorb_slabs, multisketch_build,
                           multisketch_empty, multisketch_estimate_batch,
                           multisketch_finalize, multisketch_merge,
                           multisketch_merge_stacked, multisketch_overflow,
                           multisketch_query_many, multisketch_select,
                           multisketch_slab_bytes, quarantine_chunk)

__all__ = [
    "StatFn", "COUNT", "SUM", "cap", "thresh", "moment", "combo",
    "hash_u32", "uniform01", "ppswor_rank", "rank_of",
    "conditional_prob", "f_seed", "kth_and_tau",
    "estimate_many", "cv_bound",
    "SegmentPredicate", "EVERYTHING", "key_range", "key_mask",
    "hash_fraction", "encode_predicates", "pad_table", "never_row",
    "hash31", "predicate_matrix",
    "MultiSketch", "MultiSketchSpec", "multisketch_absorb",
    "multisketch_absorb_inline", "multisketch_absorb_into",
    "multisketch_absorb_slabs", "multisketch_build", "multisketch_empty",
    "multisketch_estimate_batch", "multisketch_finalize",
    "multisketch_merge", "multisketch_merge_stacked",
    "multisketch_overflow", "multisketch_query_many", "multisketch_select",
    "multisketch_slab_bytes", "quarantine_chunk",
]
