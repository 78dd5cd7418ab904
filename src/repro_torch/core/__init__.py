"""Core library of the port: statistic functions, hashing, bottom-k
primitives, predicates, estimators, the MultiSketch slab, and the metric
tier's service-cost wire format and universal metric samples."""
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
from .metric_domains import (MetricSample, MetricSketch,
                             estimate_ball_density, estimate_centrality,
                             farthest_point_anchors, metric_sample_sketch,
                             universal_metric_sample)
from .costs import (MODE_BALL, MODE_COST, CostTable, ServiceCostQuery,
                    ball_query, cost_query, cost_table, encode_cost_queries,
                    estimate_service_costs, exact_service_costs,
                    pad_cost_table, service_cost_values)

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
    "MetricSample", "MetricSketch", "universal_metric_sample",
    "metric_sample_sketch", "farthest_point_anchors", "estimate_centrality",
    "estimate_ball_density",
    "CostTable", "ServiceCostQuery", "MODE_COST", "MODE_BALL",
    "cost_query", "ball_query", "cost_table", "encode_cost_queries",
    "pad_cost_table", "service_cost_values", "estimate_service_costs",
    "exact_service_costs",
]
