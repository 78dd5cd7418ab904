"""K7's rules that a CPU can hold (``kernels/attention.py``): CPU and meta
tensors take the plain loop and never the kernel library; the kernel's
input contract (bf16, head dim up to 256, padded to 64 / 128 / 256)
raises before any launch; the three-part split of an fp32 operand into
bf16 parts (the device code's, stated here in PyTorch) is exact, and so
is each part's product with a bf16 value.
The kernel itself is held against the plain loop on the card
(``tests/test_torch_attention_gpu.py``), through ``chip_smoke``'s gate,
whose power is shown here on the plain loop alone."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention as KA
from repro_torch.models import layers as L

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)


def _qkv(rng, B=2, S=32, H=4, K=2, hd=16, dtype=torch.float32):
    mk = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)).to(dtype)
    return mk(B, S, H, hd), mk(B, S, K, hd), mk(B, S, K, hd)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_takes_the_plain_loop(monkeypatch, dtype):
    """chunked_attention on CPU tensors, forward and backward, never
    reaches the kernel library; its output is the plain loop's, bit for
    bit, and no launch is counted."""
    def no_library():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(KA, "kernel_lib", no_library)
    monkeypatch.setattr(KA.launch, "launches", 0)
    q, k, v = _qkv(np.random.default_rng(0), dtype=dtype)
    q.requires_grad_()
    out = L.chunked_attention(q, k, v, causal=True, chunk=16)
    out.float().sum().backward()
    want, _ = KA.attention_forward_plain(q.detach(), k, v, True, 16, 16, 0,
                                         None)
    assert torch.equal(out.detach(), want)
    assert q.grad is not None and KA.launch.launches == 0


def test_meta_takes_the_plain_loop():
    """Meta tensors (the dry run's) take the plain loop too: shapes out,
    nothing launched."""
    q, k, v = (torch.empty(s, device="meta") for s in
               ((1, 32, 4, 16), (1, 32, 2, 16), (1, 32, 2, 16)))
    out, lse = KA.attention_forward(q, k, v, True, 16, 16, 0, None)
    assert out.shape == (1, 32, 4, 16) and out.device.type == "meta"
    assert lse.shape == (1, 2, 16, 2, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_kernel_refuses_another_dtype(dtype):
    q, k, v = _qkv(np.random.default_rng(1), dtype=dtype)
    with pytest.raises(TypeError, match="bfloat16"):
        KA.attention_forward_kernel(q, k, v, True)
    with pytest.raises(TypeError, match="bfloat16"):
        KA.attention_backward_kernel(q, k, v, q, None, q, True)


@pytest.mark.parametrize("hd", [257, 320, 512])
def test_kernel_refuses_a_head_dim_over_256(hd):
    q, k, v = _qkv(np.random.default_rng(2), hd=hd, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="over 256"):
        KA.attention_forward_kernel(q, k, v, True)


@pytest.mark.parametrize("hd,padded", [(8, 64), (32, 64), (64, 64),
                                       (80, 128), (96, 128), (128, 128),
                                       (200, 256), (256, 256)])
def test_kernel_head_dims(hd, padded):
    assert KA.kernel_head_dim(hd) == padded
    q, k, v = _qkv(np.random.default_rng(3), S=4, hd=hd,
                   dtype=torch.bfloat16)
    assert KA.check_kernel_inputs(q, k, v) == padded


def test_kernel_refuses_mismatched_heads_and_shapes():
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, H=6, K=4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="kv heads"):
        KA.check_kernel_inputs(q, k, v)
    q, k, v = _qkv(rng, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="shapes"):
        KA.check_kernel_inputs(q, k, v[..., :8])


def split3(x: torch.Tensor):
    """fp32 x -> (hi, mid, lo) bf16 with hi + mid + lo == x exactly (for
    |x| >= 2^-110; below it lo loses bits to bf16's subnormals). It
    mirrors ``split3`` in ``csrc/attention.cu``, the split the kernel
    applies to its fp32 operand (P or dS) before the three exact bf16
    products that replace one fp32 product: rounding to nearest, the
    remainder taken in fp32."""
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def _split_inputs():
    """Random fp32 over many binades, values next to 0 (down to 2^-100)
    and next to 1 (1 +- a few ulps, the largest p), both signs."""
    rng = np.random.default_rng(5)
    normal = rng.standard_normal(20000).astype(np.float32)
    spread = (rng.uniform(-1, 1, 20000)
              * np.exp2(rng.uniform(-100, 8, 20000))).astype(np.float32)
    one = np.float32(1.0)
    near_one = np.array([np.nextafter(one, np.float32(2), dtype=np.float32),
                         np.nextafter(one, np.float32(0), dtype=np.float32)]
                        + list(1 - rng.uniform(0, 1e-3, 2000)), np.float32)
    tiny = np.exp2(-np.arange(1, 101, dtype=np.float32))
    ulp_steps = one + np.arange(-300, 300, dtype=np.float32) * np.float32(
        2 ** -23)
    x = np.concatenate([normal, spread, near_one, -near_one, tiny, -tiny,
                        ulp_steps, np.zeros(3, np.float32)])
    return torch.from_numpy(x)


def test_split3_is_exact():
    """hi + mid + lo == x exactly (summed in float64) for every input,
    each part a bf16 value, and the parts ordered: |mid| <= ulp_bf16(hi)
    / 2, |lo| <= ulp_bf16(mid) / 2."""
    x = _split_inputs()
    hi, mid, lo = split3(x)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    total = hi.double() + mid.double() + lo.double()
    assert torch.equal(total, x.double())
    big = hi.double() != 0
    assert bool((mid.double().abs()[big]
                 <= hi.double().abs()[big] * 2.0 ** -8).all())
    mb = mid.double() != 0
    assert bool((lo.double().abs()[mb]
                 <= mid.double().abs()[mb] * 2.0 ** -8).all())


def test_split_products_are_exact():
    """Each part times a bf16 value is exact in fp32 (8 x 8 significant
    bits), so the three products sum to the fp32 operand's product with
    no rounding but that of the sum: the kernel's dV, dK and dQ take the
    reference's fp32 P and dS at full precision."""
    x = _split_inputs()
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        x.numel()).astype(np.float32)).to(torch.bfloat16)
    for part in split3(x):
        p32 = part.float() * b.float()
        assert torch.equal(p32.double(), part.double() * b.double())
    exact = x.double() * b.double()
    parts = sum(p.double() * b.double() for p in split3(x))
    assert torch.equal(parts, exact)


@pytest.mark.parametrize("fault", [None, "diagonal", "last_tile", "hi_only"])
def test_gate_passes_reordered_sums_and_catches_planted_faults(fault):
    """The card's gate (``chip_smoke.attn_gate``) on the plain loop alone:
    the loop at 64-key chunks against itself at 256 (other fp32 sums, p
    rounded to bf16 at other running maxima, as the kernel differs)
    passes; each planted fault (the diagonal kv tile skipped from row
    128, the last kv tile skipped, the split's mid and lo parts dropped)
    breaks it."""
    case = (1, 512, 512, 4, 2, 64, True, 0, None, 256)
    g = torch.Generator().manual_seed(8)
    q, k, v, do = (torch.randn(*s, generator=g).to(torch.bfloat16)
                   for s in ((1, 512, 4, 64), (1, 512, 2, 64),
                             (1, 512, 2, 64), (1, 512, 4, 64)))
    want = CS.attention_plain(KA, case, q, k, v, do)
    if fault is None:
        got = CS.attention_plain(KA, case[:9] + (64,), q, k, v, do)
    else:
        with CS.attn_faults(torch, KA, 512, start=128)[fault]():
            got = CS.attention_plain(KA, case, q, k, v, do)
    broken = CS.attn_gate({n: CS.attn_gaps(torch, a, b) for n, a, b in
                           zip(CS.ATTN_NAMES, got, want)})
    assert bool(broken) == (fault is not None), broken
