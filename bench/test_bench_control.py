"""The control, kept at a size a test run holds: the reference with its
matrix products in float8 e4m3 (the precision below the configuration's
bfloat16), put in the program's place, reads well above the bf16 program
against the float32 reference, and so does the half-batch fault, which the
cell's own comparison (``check.judge`` under the smoke limits) calls not
correct while the program's run passes. At this size the control's gaps
overlap the program's on other seeds (``bench/smoke.py``), so its verdict
is held at each cell's own size on the card: ``bench/calibrate.py``
prints it beside every reading (PERF.md, section 4)."""
import pytest
import torch

from bench import calibrate, smoke

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m.train_4k",
                                  "zamba2-2.7b.train_4k"])
def test_control_and_half_batch_read_above_the_program(name):
    r = calibrate.readings(smoke.cell(name), 2 ** 31 + 3, CPU, True, True)
    prog = r["program"]
    nums = ("loss_gap", "grad_gap", "change_gap")
    assert max(r["control"][k] / prog[k] for k in nums) >= 3
    assert max(r["half"][k] / prog[k] for k in nums) >= 10
    assert prog["sample_miss"] == 0
    assert r["correct"], prog
    assert not r["half"]["correct"], r["half"]
