"""K7, the attention kernels (``kernels/attention.py``,
``csrc/attention.cu``), against their plain loop on the card, bf16 in and
out. Imports neither JAX nor the reference:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_attention_gpu.py

Every test carries the ``gpu`` marker and skips where there is no card.

The gate is ``chip_smoke.attn_gate``, the one its phase 14 applies, on
each of out, dq, dk, dv: every tile of 64 positions of one (batch, head)
within ATTN_TILE_GAP of the plain loop in norm, and at most the tensor's
ATTN_ULP_SHARE of the elements more than one bf16 ulp apart. Both sides
compute the same fp32 values in another order and round each result to
bf16; besides, the plain loop rounds p to bf16 at the running maximum of
its 64..512-key chunks and the kernel at that of its 64-key tiles. So a
tile's norm moves by a few 2^-9 at most and few elements by more than an
ulp, while a skipped kv tile moves whole tiles by a tenth or more and a
dropped split part puts a large share of dq, dk, dv an ulp off: three such
faults, planted in the plain loop at granite's shape, must break the
gate."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import attention as KA                # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

pytestmark = pytest.mark.gpu
# (B, Sq, Sk, H, K, hd, causal, q_offset, kv_valid_len, chunk): granite-moe,
# head dims 80 (zamba2), 96 (phi3, MHA), 128 (qwen2, G 6), 256 (gemma, MQA),
# hubert's non-causal, offset + valid len, valid len with Sq < Sk, ragged
# with Sq != Sk, a smoke head dim
CASES = CS.ATTN_CASES


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


def _gaps(got, want):
    return {name: CS.attn_gaps(torch, a, b)
            for name, a, b in zip(CS.ATTN_NAMES, got, want)}


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_kernel_matches_plain_loop(cuda, case):
    q, k, v, do = CS.attn_inputs(torch, cuda, case, 1000 + CASES.index(case))
    got, want = CS.attention_pair(KA, case, q, k, v, do)
    for name, a, b in zip(CS.ATTN_NAMES, got, want):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
    assert CS.attn_gate(_gaps(got, want)) == []


@pytest.mark.parametrize("fault", ["diagonal", "last_tile", "hi_only"])
def test_planted_faults_break_the_gate(cuda, fault):
    """At granite's shape a fault planted in the plain loop (the diagonal
    kv tile skipped from row 1,024 on, the last kv tile skipped, or the
    split's mid and lo parts dropped) breaks the gate that the kernel
    passes."""
    case = CASES[0]
    q, k, v, do = CS.attn_inputs(torch, cuda, case, 17)
    want = CS.attention_plain(KA, case, q, k, v, do)
    with CS.attn_faults(torch, KA, case[2])[fault]():
        bad = CS.attention_plain(KA, case, q, k, v, do)
    assert CS.attn_gate(_gaps(bad, want))


def test_rows_that_see_no_key_are_zero(cuda):
    """With kv_valid_len 0 no row sees a key: out and every gradient
    are 0, as the plain loop's clamps make them."""
    case = (1, 64, 128, 4, 2, 64, True, 0, 0, 64)
    q, k, v, do = CS.attn_inputs(torch, cuda, case, 7)
    got, _ = CS.attention_pair(KA, case, q, k, v, do)
    for t in got:
        assert not bool(t.any())


def test_two_runs_give_the_same_bits(cuda):
    for case in (CASES[0], CASES[3], CASES[8]):
        q, k, v, do = CS.attn_inputs(torch, cuda, case, 11)
        a, _ = CS.attention_pair(KA, case, q, k, v, do)
        b, _ = CS.attention_pair(KA, case, q, k, v, do)
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_launch_counts_and_autograd(cuda):
    """chunked_attention on bf16 CUDA tensors runs the kernels (one
    forward and one backward launch counted), with gradients that pass
    the gate against the plain loop; an fp32 CUDA tensor raises."""
    from repro_torch.models import layers as L
    case = CASES[3]
    q, k, v, do = CS.attn_inputs(torch, cuda, case, 13)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    KA.launch.launches = 0
    out = L.chunked_attention(qg, kg, vg, causal=True, chunk=128)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert KA.launch.launches == 2
    want = CS.attention_plain(KA, case, q, k, v, do)
    assert CS.attn_gate(_gaps((out.detach(), *grads), want)) == []
    with pytest.raises(TypeError, match="bfloat16"):
        L.chunked_attention(q.float(), k.float(), v.float(), causal=True,
                            chunk=128)


def test_traced_granite_step_counts_every_attention_call(cuda):
    """A granite-moe train step (24 layers, 2 microbatches) under a
    profiler: 144 ``attn.kernel`` counts, 24 x 2 x (forward, remat's
    recompute, backward), and as many kernel launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model
    from repro_torch.optim import adamw
    from repro_torch.telemetry import spans
    cfg = get_config("granite-moe-1b-a400m")
    mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=cuda)
    step, _ = make_train_step(cfg, adamw.OptConfig(), mesh, microbatch=2)
    params, _ = init_model(cfg, seed=0, device=cuda)
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    del params
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 256)).astype(np.int32)).to(cuda)
    KA.launch.launches = 0
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        state, m = step(state, {"tokens": toks})
        torch.cuda.synchronize()
    counted = sum(int(c.value) for c in spans.counts()
                  if c.name == "attn.kernel")
    spans.reset()
    assert counted == 24 * 2 * 3
    assert KA.launch.launches == counted
    assert np.isfinite(float(m["loss"]))
