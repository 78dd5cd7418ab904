"""exchange_ms.train (ms), layer "train step": the stream time of the
program's ``exchange`` spans per traced step, the sum of their CUDA-
event intervals (device idle inside an interval counts). The span covers
the sampled exchange (around ``exchange_grads`` in
``distopt/compression.py``'s step wrapper): K1, K2, members and slab of
every sampled leaf, the gather, the dense reduce of the small leaves,
the merge. Only in the exchange's cells. Moves train_tokens_per_s."""
from bench.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, "exchange")
