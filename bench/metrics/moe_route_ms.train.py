"""moe_route_ms.train (ms), layer "train step": the stream time of the
program's ``moe.route`` spans per traced step, the sum of their CUDA-
event intervals (device idle inside an interval counts). The span covers
the MoE router, softmax, stable sort and the slot count's ``cumsum``
(around ``route`` in ``models/moe.py`` ``apply_moe``), in the forward
and in remat's recompute. Moves train_tokens_per_s."""
from bench.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, "moe.route")
