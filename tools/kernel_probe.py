#!/usr/bin/env python3
"""Measure on one CUDA card what bounds the K4 and K5 designs.

    python3 tools/kernel_probe.py

Builds ``tools/kernel_probe.cu`` with nvcc (the package's flags: sm_90a,
-O3, --fmad=false) into ``build/tools/`` and prints the card's name and
power limit, then:
- the fp32 rate (TFLOP/s, 2 per FMA) of K5's register tile of 4 slots x 8
  centers with its operands in registers, and read from shared memory as
  K5 reads them (dim 68: 17 steps of 4 dimensions, row stride 68 words),
  plus the 8 x 8 and 4 x 4 tiles, at 132 and 264 blocks of 128 threads
  (one and two warps per scheduler);
- how many SMs clusters of 8 blocks can use at once, one block per SM
  (``cudaOccupancyMaxActiveClusters`` x 8).
Exits non-zero without a card.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._util import NVCC_FLAGS, _nvcc
    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    lib_path = out / "libkernel_probe.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(lib_path),
                    str(ROOT / "tools" / "kernel_probe.cu")], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.probe_tile.restype = ctypes.c_float
    lib.probe_tile.argtypes = [ctypes.c_int] * 5
    lib.probe_clusters.restype = ctypes.c_int
    lib.probe_clusters.argtypes = [ctypes.c_int] * 2
    nd4, st = 17, 68
    cases = ((0, "registers 4x8", 4, 8, 20000, 1),
             (1, "shared 4x8 (K5's loop)", 4, 8, 400, nd4),
             (2, "shared 8x8", 8, 8, 400, nd4),
             (3, "shared 4x4", 4, 4, 400, nd4))
    for which, name, r, g, iters, steps in cases:
        rates = []
        for blocks in (132, 264):
            ms = lib.probe_tile(which, blocks, iters, nd4, st)
            if ms <= 0:
                raise SystemExit(f"kernel_probe: {name} failed ({ms})")
            fma = blocks * 128 * iters * steps * 4 * r * g
            rates.append(f"{blocks} blocks {2 * fma / ms / 1e9:.1f}")
        print(f"fp32 tile, {name}: TFLOP/s " + ", ".join(rates), flush=True)
    n = lib.probe_clusters(8, 120 * 1024)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"clusters of 8, one block per SM: {n} resident at once = "
          f"{8 * n} of {sms} SMs", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
