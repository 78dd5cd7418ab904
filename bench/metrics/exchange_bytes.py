"""The bytes and launches of K1 (``seeds_kernel``) and K2 (``select.cu``)
in one train step, counted from the shapes the configuration and traffic
fix: each input read once, each output written once (PERF.md's kernel
table uses the same rule).

  exchange, per leaf of n >= min_size rows (F = 3, seeds only; k = 257
  selected):
    K1 reads keys (int32), weights (fp32), active (bool), writes 3 seeds:
      n (4 + 4 + 1 + 3 x 4) = 21 n
    K2 reads the seeds, 12 n, writes the 257 smallest of each row as
      values and indices and the three taus: 3 x 257 x 8 + 3 x 4
  telemetry fold, over n_f = 196 + rows slots (the trainer's sketch:
  3 objectives of k 64, capacity 3 x 64 + 3 + 1):
    K1 with f-values: n_f (4 + 4 + 1) + 2 x 3 x 4 n_f = 33 n_f
    K2 select of 65: 12 n_f + 3 x 65 x 8 + 3 x 4
    K2 compaction (one row, 196 taken): 4 n_f + 196 x 8 + 4
K1 launches per step: sampled leaves + 1; K2: sampled leaves + 2.
"""
import math

KERNELS = {"k1": ("seeds_kernel",),
           "k2": ("select_hist_kernel", "select_count_kernel",
                  "select_write_kernel", "select_rank_kernel")}
TEL_SLOTS = 196


def sampled(run) -> list:
    ex = run.cell.traffic.get("exchange")
    if ex is None:
        return []
    return [math.prod(s) for _, s in sorted(run.shapes.items())
            if math.prod(s) >= ex["min_size"]]


def per_step(run, kernel: str) -> tuple:
    """(bytes, launches) of one step's ``kernel`` ("k1" or "k2")."""
    leaves = sampled(run)
    nf = TEL_SLOTS + run.tokens_per_step // run.cell.traffic["seq_len"]
    if kernel == "k1":
        return sum(21 * n for n in leaves) + 33 * nf, len(leaves) + 1
    k = run.cell.traffic["exchange"]["k"] + 1 if leaves else 0
    ex = sum(12 * n + 3 * k * 8 + 12 for n in leaves)
    fold = (12 * nf + 3 * 65 * 8 + 12) + (4 * nf + TEL_SLOTS * 8 + 4)
    return ex + fold, len(leaves) + 2


def roofline(run, kernel: str, counter: str):
    """100 x (bytes at the card's HBM rate) / the kernel's device time over
    the traced steps; None without a trace, a table entry for the card, or
    when the program's launch counter disagrees with the count above."""
    from bench.metrics.common import peak
    rate = peak(run, "hbm_bytes_per_s")
    if run.trace is None or rate is None or not sampled(run):
        return None
    nbytes, launches = per_step(run, kernel)
    if run.launches_per_step is None or \
            run.launches_per_step.get(counter) != launches:
        return None
    names = KERNELS[kernel]
    secs, _ = run.trace.kernel_time(lambda n: any(k in n for k in names))
    if secs <= 0:
        return None
    return 100.0 * nbytes * run.trace.steps / rate / secs
