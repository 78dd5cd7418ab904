"""Helpers shared by the kernel wrappers: padding, launch checks and the
lazy ``nvcc`` build of ``csrc/*.cu`` into one ctypes-loaded library.

The build runs at the first kernel launch (never at import), into
``build/repro_torch/`` under the repository root, keyed by a hash of the
sources and flags so an edited source rebuilds. One ``nvcc`` process per
source runs in parallel, then one link step.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# no --use_fast_math: log1pf, powf, IEEE division and denormals stay exact;
# --fmad=false keeps every a*b+c rounded as written (the plain versions run
# the same arithmetic as separate PyTorch ops)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_lib = None
_lib_lock = threading.Lock()


def round_up(n: int, multiple: int) -> int:
    """n rounded up to the next multiple."""
    return n + (-n) % multiple


def pad_tail(x: torch.Tensor, npad: int, fill) -> torch.Tensor:
    """Pad the last axis of x to length npad with an inert fill value."""
    pad = npad - x.shape[-1]
    if not pad:
        return x
    return torch.nn.functional.pad(x, (0, pad), value=fill)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit needed to build the "
                       "repro_torch kernels)")


def _build() -> Path:
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    tag = digest.hexdigest()[:16]
    lib_path = BUILD_DIR / f"librepro_torch_{tag}.so"
    if lib_path.exists():
        return lib_path
    obj_dir = BUILD_DIR / f"obj_{tag}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources:
        obj = obj_dir / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o",
             str(obj)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for src, _, p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            errors.append(f"{src.name}:\n{out.decode(errors='replace')}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    tmp = obj_dir / lib_path.name
    link = subprocess.run(
        [nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
         *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(tmp, lib_path)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return lib_path


_VP, _I, _U32, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32,
                     ctypes.c_float)
# C entry points of csrc/*.cu: every pointer (and the stream) is c_void_p;
# each returns cudaGetLastError() after its launch
_SIGNATURES = {
    # keys, w, active, seeds, fvals, n, nf, kinds*, params*, seed, ppswor,
    # stream
    "repro_seeds": (_VP, _VP, _VP, _VP, _VP, _I, _I, _VP, _VP, _U32, _I,
                    _VP),
    # seeds, vals, idx, nf, n, span, kb, stream
    "repro_blockselect": (_VP, _VP, _VP, _I, _I, _I, _I, _VP),
    # keys, member, keep, w, pri, n, stream
    "repro_priority": (_VP, _VP, _VP, _VP, _VP, _I, _VP),
    # keys, w, p, member, table, out, scratch, tickets, c, b, slices,
    # slice_len, nf, kinds*, params*, stream
    "repro_segquery": (_VP,) * 8 + (_I,) * 5 + (_VP, _VP, _VP),
    # pts, probs, member, pw (or NULL), centers, cvalid, mu, param, mode,
    # out, scratch, tickets, c, dim, q, cmax, slices, slice_len, rows,
    # stages, cpcap, smem bytes, stream
    "repro_servicecost": (_VP,) * 12 + (_I,) * 10 + (_VP,),
    # int[3] out: registers, local bytes, static shared bytes
    "repro_segquery_attrs": (_VP,),
    "repro_servicecost_attrs": (_VP,),
    # w, s_h, s_l, active, h, l, n, stream
    "repro_rankcount": (_VP,) * 6 + (_I, _VP),
}


def kernel_lib() -> ctypes.CDLL:
    """The built kernel library (building it on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


_tickets: dict = {}


def tile_tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least n zeroed int32 tickets for kernels that split a tile's
    reduction over blocks (``last_block_of_tile`` in common.cuh): one
    buffer per (card, stream), made once; every launch leaves the tickets
    it used at zero again."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    key = (idx, torch.cuda.current_stream(idx).cuda_stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32,
                          device=torch.device("cuda", idx))
        _tickets[key] = buf
    return buf


def kernel_attrs(name: str) -> dict:
    """Registers per thread, local (spill) bytes and static shared-memory
    bytes of a kernel, from ``cudaFuncGetAttributes`` (``name``: a kernel
    with a ``repro_<name>_attrs`` entry point)."""
    vals = (ctypes.c_int * 3)()
    raise_on_error(name, getattr(kernel_lib(), f"repro_{name}_attrs")(
        ctypes.addressof(vals)))
    return dict(regs=vals[0], local_bytes=vals[1], static_smem=vals[2])


def check_cuda(name: str, x: torch.Tensor, dtype: torch.dtype,
               shape=None) -> torch.Tensor:
    """Validate a kernel operand: on CUDA, of ``dtype``, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if shape is not None and tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    return x


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on_error(name: str, code: int):
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {code}")


def objective_arrays(objectives):
    """(kind, param) pairs -> ctypes int/float arrays (F <= 8, by value in
    the kernel's argument block)."""
    nf = len(objectives)
    if not 1 <= nf <= 8:
        raise ValueError(f"kernels take 1..8 objectives, got {nf}")
    kinds = (ctypes.c_int * nf)(*(int(k) for k, _ in objectives))
    params = (ctypes.c_float * nf)(*(float(p) for _, p in objectives))
    return kinds, params
