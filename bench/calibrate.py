"""The readings that a cell's correctness limits are set from, on the card
at the cell's own size:

  program  the numbers of ``check.py`` for sound runs of the program (its
           first three steps against the reference), one per seed;
  control  the reference computed with its matrix products in float8
           e4m3 (the precision below the configuration's bfloat16), put
           in the program's place;
  half     a fault: the reference with half of each microbatch's rows
           left out, the mean taken over the rest, in the program's place;
  frozen   a fault: the reference with steps that return its state
           unchanged (it reads change_gap 1 by the measure itself; the run
           gives the other numbers).

Each reading carries "correct": the verdict of ``check.judge`` on its
numbers under the cell's limits, as a run would print it.

Every seed's program and reference run in this one process:

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--control 3] [--half 3] [--frozen 1] [--no-program] \\
        [--out chiprun_out/calibrate.json]

The first ``--control``, ``--half`` and ``--frozen`` seeds also get those
readings.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from bench import check as Chk  # noqa: E402
from bench import harness as H  # noqa: E402
from bench.reference import lm  # noqa: E402
from bench.runners import train as R  # noqa: E402


def in_place_of_program(ref: dict, ref_fp32: dict, limits: dict) -> dict:
    """The numbers of a reference run put in the program's place, with
    the verdict of the cell's own comparison on them ("correct")."""
    out = {"loss_gap": Chk.loss_gap(ref["loss"], ref_fp32["loss"]),
           "grad_gap": Chk.grad_gap(ref["grad_clipped"], ref_fp32),
           "grad_med": Chk.grad_med(ref["grad_clipped"], ref_fp32),
           "change_gap": Chk.change_gap(ref["change"], ref_fp32)}
    out["correct"] = Chk.judge(out, limits)[0]
    out["detail"] = detail(ref["loss"], ref["grad_clipped"], ref["change"],
                           ref_fp32)
    return out


def detail(losses, grad, change, ref: dict) -> dict:
    """Each step's loss gap and the three worst leaves of each number,
    with the median leaf's gap."""
    def top(gaps):
        worst = sorted(gaps.items(), key=lambda x: -x[1])[:3]
        vals = sorted(gaps.values())
        return {"worst": worst, "median": vals[len(vals) // 2]}
    return {"loss_steps": [abs(a - b) / abs(b)
                           for a, b in zip(losses, ref["loss"])],
            "grad": top(Chk.leaf_gaps(grad, ref["grad_clipped"],
                                      list(ref["grad_clipped"]))),
            "change": top(Chk.leaf_gaps(change, ref["change"],
                                        Chk.counted(ref)))}


def readings(cell, seed: int, device, control: bool, half: bool,
             frozen: bool = False, program: bool = True) -> dict:
    """One seed's readings; without ``program`` only the loader's batches
    are taken from the program and the reference's runs compared."""
    prog = R.Program(cell, seed, device)
    if program:
        got = R.check_steps(prog)
    else:
        got = {"tokens": [prog.batch()["tokens"].cpu()
                          for prog.step in range(R.CHECK_STEPS)]}
    prog.free()
    ref = R.reference(cell, prog.shapes, seed, got, device)
    out = {"seed": seed}
    if program:
        nums = R.numbers(prog, got, ref, device)
        out.update(program=nums, correct=Chk.judge(nums, cell.limits)[0],
                   loss=got["loss"], ref_loss=ref["loss"],
                   detail=detail(got["loss"], got["grad_clipped"],
                                 got["change"], ref))
    if control:
        fp8 = R.reference(cell, prog.shapes, seed, got, device, quant=lm.fp8)
        out["control"] = in_place_of_program(fp8, ref, cell.limits)
    if half:
        rows = prog.rows // cell.config["microbatch"]
        bad = R.reference(cell, prog.shapes, seed, got, device,
                          keep_rows=max(rows // 2, 1))
        out["half"] = in_place_of_program(bad, ref, cell.limits)
    if frozen:
        still = R.reference(cell, prog.shapes, seed, got, device,
                            frozen=True)
        out["frozen"] = in_place_of_program(still, ref, cell.limits)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--half", type=int, default=3)
    ap.add_argument("--frozen", type=int, default=1)
    ap.add_argument("--no-program", action="store_true",
                    help="the reference's readings alone")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = H.resolve(args.workload)
    dev = torch.device("cuda")
    print(f"# {H.power_limit()}", flush=True)
    rows = []
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        r = readings(cell, seed, dev, i < args.control, i < args.half,
                     i < args.frozen, not args.no_program)
        r["seconds"] = time.perf_counter() - t0
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
