"""The comparison that decides a training cell's ``correct``: the numbers
read from the program's first steps against the plain reference's, each
held to its limit (``bench/limits/<workload>.json``).

  loss_gap    the largest |loss - reference loss| / reference loss over
              the first steps;
  grad_gap    the first step's clipped gradient as the optimizer got it,
              leaf by leaf (the program's worked out from its first
              moment: |m_1| / (1 - b1)): the largest gap of the two norms,
              over the larger of the reference leaf's norm and the median
              leaf's;
  grad_med    the same leaf gaps' median: the worst leaf is as a rule the
              MoE router or a key projection, whose gradient moves with
              the routing choices that bf16 logits flip, so grad_gap swings
              from seed to seed; the median leaf's gap is steady and is
              the number that separates float8 from bfloat16;
  change_gap  each leaf's change over the first steps, |p_t - p_0|, the
              same way; leaves whose reference gradient is under a
              thousandth of the median leaf's are left out (they move by
              round-off alone under Adam);
  tel_miss    the telemetry sketch after the first steps: the expected
              keys (step * 2^16 + row, each once) that it lacks, plus the
              keys it holds and should not; limit 0. Its weights are each
              step's loss, which loss_gap holds to the reference;
  sample_miss the exchange's wire slab of every sampled leaf at the first
              step against the plain sample of the same gradient: slots
              whose key, validity or weight differs, or whose probability
              differs by more than 1e-6 of it, plus one for each leaf whose
              seed differs; a leaf not sampled reads as all its slots.
"""
from __future__ import annotations

import math
import statistics
from collections import Counter

TINY = 1e-3


def leaf_gaps(prog: dict, ref: dict, leaves) -> dict:
    """{leaf: |prog - ref| / max(ref, the median leaf's ref)}."""
    med = statistics.median(ref[p] for p in ref)
    return {p: abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
            for p in leaves}


def _worst(prog: dict, ref: dict, leaves) -> float:
    return max(leaf_gaps(prog, ref, leaves).values(), default=0.0)


def loss_gap(prog_losses, ref_losses) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog_losses, ref_losses))


def grad_gap(prog: dict, ref: dict) -> float:
    return _worst(prog, ref["grad_clipped"], list(ref["grad_clipped"]))


def grad_med(prog: dict, ref: dict) -> float:
    gaps = leaf_gaps(prog, ref["grad_clipped"], list(ref["grad_clipped"]))
    return statistics.median(gaps.values())


def counted(ref: dict) -> list:
    """The leaves whose change is compared."""
    med = statistics.median(ref["grad_norm"].values())
    return [p for p, g in ref["grad_norm"].items() if g >= TINY * med]


def change_gap(prog: dict, ref: dict) -> float:
    return _worst(prog, ref["change"], counted(ref))


def tel_miss(keys, steps: int, rows: int) -> int:
    """keys: the valid slots' keys of the program's sketch."""
    want = Counter(s * (1 << 16) + r for s in range(steps)
                   for r in range(rows))
    got = Counter(keys)
    return sum(((want - got) + (got - want)).values())


def slab_misses(prog: dict, ref: dict) -> int:
    """Slots of one leaf's wire slab that differ (tensors on one device)."""
    if prog["keys"].shape != ref["keys"].shape:
        return int(ref["keys"].numel())
    bad = (prog["keys"] != ref["keys"]) | (prog["valid"] != ref["valid"])
    bad |= prog["weights"].view(-1) != ref["weights"].view(-1)
    bad |= (prog["probs"] - ref["probs"]).abs() > 1e-6 * ref["probs"].abs()
    return int(bad.sum())


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
