"""k1_roofline.train (%), layer "kernels": K1's (``seeds_kernel``) share
of its bound over the traced steps: the step's K1 bytes (the exchange's
sampled leaves and the telemetry fold, ``exchange_bytes``) at 3.35 TB/s,
over the K1 kernels' device time in the trace. Only in the exchange's
cells. Moves train_tokens_per_s."""
from bench.metrics.exchange_bytes import roofline


def read(run):
    return roofline(run, "k1", "seeds")
