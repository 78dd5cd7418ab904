"""Hand-written CUDA kernels K1-K6, each beside its plain PyTorch
version. A wrapper dispatches on its input's device: CPU tensors take the
plain version, CUDA tensors launch the kernel (or raise). ``ops`` composes
them into the paper's sampling operations; ``ref`` holds the oracles.

K1 ``seeds``        fused_seeds_fvals      (repro/kernels/seeds.py)
K2 ``blockselect``  batched_bottomk_select (select.cu, the global route)
                    batched_block_bottomk  (blockselect.cu, per span)
                                           (repro/kernels/blockselect.py)
K3 ``compact``      retention_priority     (repro/kernels/compact.py)
K4 ``segquery``     segment_query_slab     (repro/kernels/segquery.py)
K5 ``servicecost``  service_cost_slab      (repro/kernels/servicecost.py)
K6 ``rankcount``    rank_counts            (repro/kernels/rankcount.py)
K7 ``attention``    attention_forward/_backward (none: the reference's
                    attention is plain JAX; its forward and backward
                    launches counted together in
                    ``attention.launch.launches``, apart from K1-K6's)
K8 ``moe_slots``    expert_slots (none: the reference's MoE slot count is
                    plain JAX; counted in ``expert_slots.launches``, apart
                    from K1-K6's)
"""
from .blockselect import (batched_block_bottomk, batched_bottomk_select,
                          block_bottomk, bottomk_select)
from .compact import compact_take, retention_priority
from .rankcount import rank_counts
from .seeds import fused_seeds, fused_seeds_fvals
from .segquery import segment_query_slab
from .servicecost import service_cost_slab
from . import ops, ref

# kernel name -> the wrapper whose ``launches`` counts its CUDA launches
COUNTED = {"seeds": fused_seeds_fvals,
           "blockselect": batched_block_bottomk,
           "compact": retention_priority,
           "segquery": segment_query_slab,
           "servicecost": service_cost_slab,
           "rankcount": rank_counts}


def launch_counts() -> dict:
    """{kernel name: CUDA launches since the last reset}."""
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_launch_counts():
    for fn in COUNTED.values():
        fn.launches = 0


__all__ = ["fused_seeds", "fused_seeds_fvals", "batched_block_bottomk",
           "batched_bottomk_select", "block_bottomk", "bottomk_select",
           "compact_take", "retention_priority", "segment_query_slab",
           "service_cost_slab", "rank_counts", "COUNTED", "launch_counts",
           "reset_launch_counts", "ops", "ref"]
