"""Hand-written CUDA kernels of the main path, each beside its plain
PyTorch version. A wrapper dispatches on its input's device: CPU tensors
take the plain version, CUDA tensors launch the kernel (or raise).

K1 ``seeds``        fused_seeds_fvals      (repro/kernels/seeds.py)
K2 ``blockselect``  batched_block_bottomk  (repro/kernels/blockselect.py)
K3 ``compact``      retention_priority     (repro/kernels/compact.py)
K4 ``segquery``     segment_query_slab     (repro/kernels/segquery.py)
"""
from .blockselect import (batched_block_bottomk, batched_bottomk_select,
                          block_bottomk, bottomk_select)
from .compact import compact_take, retention_priority
from .seeds import fused_seeds, fused_seeds_fvals
from .segquery import segment_query_slab

# kernel name -> the wrapper whose ``launches`` counts its CUDA launches
COUNTED = {"seeds": fused_seeds_fvals,
           "blockselect": batched_block_bottomk,
           "compact": retention_priority,
           "segquery": segment_query_slab}


def launch_counts() -> dict:
    """{kernel name: CUDA launches since the last reset}."""
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_launch_counts():
    for fn in COUNTED.values():
        fn.launches = 0


__all__ = ["fused_seeds", "fused_seeds_fvals", "batched_block_bottomk",
           "batched_bottomk_select", "block_bottomk", "bottomk_select",
           "compact_take", "retention_priority", "segment_query_slab",
           "COUNTED", "launch_counts", "reset_launch_counts"]
