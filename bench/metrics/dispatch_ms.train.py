"""dispatch_ms.train (ms), layer "train step": the mean host time per
window step from the step call to its return, before the benchmark
synchronises (the host's dispatch of the step; the device may still be
working when it returns); steps under the profiler left out. Moves
train_tokens_per_s."""
from bench.metrics.common import untraced


def read(run):
    steps = untraced(run)
    if not steps:
        return None
    return 1e3 * sum(c - b for _, b, c, *_ in steps) / len(steps)
