"""idle_share.train (%), layer "device": the share of an untraced step in
which the device runs nothing, 100 x (1 - the device's busy seconds per
traced step / the mean wall of the window's untraced steps). The busy
seconds are the union of the device operations' intervals in the trace;
the wall is taken on the host's clock in the same run, outside the
profiler, whose own host cost would otherwise count as the device's
wait. Moves train_tokens_per_s."""
from bench.metrics.common import untraced


def read(run):
    steps = untraced(run)
    if run.trace is None or not run.trace.device or not steps:
        return None
    busy = run.trace.busy_s() / run.trace.steps
    wall = sum(d - a for a, _, _, d, _ in steps) / len(steps)
    return 100.0 * (1.0 - busy / wall)
