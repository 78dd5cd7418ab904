"""K8, the MoE's slot count (``kernels/moe_slots.py``,
``csrc/moe_slots.cu``), on the card. Imports neither JAX nor the
reference:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_moe_slots_gpu.py

Every test carries the ``gpu`` marker and skips where there is no card.
The outputs are integers, so the kernel must equal its plain version to
the bit on every ``chip_smoke.SLOT_CASES`` row, run after run, and a
train step must give the same loss through either."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_smoke_config     # noqa: E402
from repro_torch.kernels import moe_slots as KS                # noqa: E402
from repro_torch.launch.mesh import Mesh                        # noqa: E402
from repro_torch.launch.steps import make_train_step            # noqa: E402
from repro_torch.models import moe as TMOE                      # noqa: E402
from repro_torch.models.model import init_model                 # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.telemetry import spans                         # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
CS = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(CS)

pytestmark = pytest.mark.gpu
ARCH = "granite-moe-1b-a400m"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the hand-written kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("case", CS.SLOT_CASES, ids=lambda c: c[0])
def test_kernel_equals_plain_to_the_bit(cuda, case):
    _, B, S, k, E, C, _ = case
    flat_e = CS.slot_inputs(torch, cuda, case, 300 + CS.SLOT_CASES.index(case))
    got = KS.expert_slots_kernel(flat_e, E, C)
    again = KS.expert_slots_kernel(flat_e, E, C)
    want = KS.expert_slots_plain(flat_e, E, C)
    for a, c, w in zip(got, again, want):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.equal(a, w)
        assert torch.equal(a, c)
    if case[-1] == "one":                 # all but C choices overflow
        assert int(got[1].sum()) == B * C


def _smoke_step(dev):
    cfg = get_smoke_config(ARCH)
    step, _ = make_train_step(cfg, adamw.OptConfig(),
                              Mesh((1, 1, 1), CS.AX3, device=dev),
                              microbatch=2)
    params, _ = init_model(cfg, seed=0, device=dev)
    state = {"params": params, "opt": adamw.init_opt_state(params)}
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        1, cfg.vocab_size, (4, 256)).astype(np.int32)).to(dev)
    return cfg, step, state, {"tokens": toks}


def test_traced_step_counts_one_call_per_forward_and_recompute(cuda):
    """Remat recomputes each layer in backward: a layer's route runs twice
    a microbatch, one K8 call each (its count pass and write pass
    together)."""
    cfg, step, state, batch = _smoke_step(cuda)
    assert cfg.remat
    KS.expert_slots.launches = 0
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(state, batch)
        torch.cuda.synchronize()
    counted = sum(int(c.value) for c in spans.counts()
                  if c.name == "moe.slots_kernel")
    spans.reset()
    assert counted == KS.expert_slots.launches == cfg.num_layers * 2 * 2


def test_step_loss_equals_the_plain_slot_count(cuda, monkeypatch):
    _, step, state, batch = _smoke_step(cuda)
    KS.expert_slots.launches = 0
    _, metrics = step(state, batch)
    assert KS.expert_slots.launches > 0
    _, step, state, batch = _smoke_step(cuda)
    monkeypatch.setattr(TMOE, "expert_slots", KS.expert_slots_plain)
    KS.expert_slots.launches = 0
    _, plain = step(state, batch)
    assert KS.expert_slots.launches == 0
    assert torch.equal(torch.as_tensor(metrics["loss"]),
                       torch.as_tensor(plain["loss"]))
