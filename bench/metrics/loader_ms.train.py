"""loader_ms.train (ms), layer "trainer and data": the mean host time per
window step of the loader's batch and its move to the card
(``Loader.batch`` + ``launch.train.make_batch``), from the benchmark's own
span around those calls; steps under the profiler left out. Moves
train_tokens_per_s."""
from bench.metrics.common import untraced


def read(run):
    steps = untraced(run)
    if not steps:
        return None
    return 1e3 * sum(b - a for a, b, *_ in steps) / len(steps)
