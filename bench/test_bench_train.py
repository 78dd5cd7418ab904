"""The train runner against the plain reference at smoke widths on the
CPU: sound runs of every cell come out correct (``bench/smoke.py``'s
limits), and a seed draws its own weights and batches."""
import math

import pytest
import torch

from bench import smoke
from bench.runners import train as R

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11          # past 32 signed bits, as the driver's are


def _run(name, seed=SEED):
    cell = smoke.cell(name)
    return R.run(cell, seed=seed, seconds=0.5, trace=False, device=CPU,
                 t_start=0.0)


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m.train_4k",
                                  "zamba2-2.7b.train_4k",
                                  "granite-moe-1b-a400m.train_4k-dense"])
def test_sound_run_is_correct(name):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["window_steps"] >= 1
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"train_tokens_per_s", "setup_s"}
    if "dense" not in name:
        assert out["checks"]["sample_miss"]["value"] == 0


def test_seed_changes_the_weights_and_the_batches():
    cell = smoke.cell("granite-moe-1b-a400m.train_4k-dense")
    a = R.Program(cell, 1, CPU)
    b = R.Program(cell, 2, CPU)
    assert not torch.equal(a.batch()["tokens"], b.batch()["tokens"])
    wa = a.state["params"]["emb"]["tok"]
    wb = b.state["params"]["emb"]["tok"]
    assert not torch.equal(wa, wb)
    assert math.isfinite(float(wa.sum()))


def test_traced_run_reads_the_host_spans():
    """With ``--trace 1`` the line carries the per-layer metrics that a CPU
    run can read (the host spans), none of the end-to-end ones, and the
    trace's breakdown; the device metrics stay silent without a card."""
    cell = smoke.cell("granite-moe-1b-a400m.train_4k")
    out = R.run(cell, seed=SEED, seconds=0.5, trace=True, device=CPU,
                t_start=0.0)
    assert out["correct"], out["checks"]
    assert {"loader_ms.train", "dispatch_ms.train"} <= set(out["metrics"])
    assert "train_tokens_per_s" not in out["metrics"]
    assert "train_mfu" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
