"""update_ms.train (ms), layer "train step": the stream time of the
program's ``train.update`` spans per traced step, the sum of their CUDA-
event intervals (device idle inside an interval counts). The span covers
the global norm, the clip, AdamW over every leaf and the telemetry fold
(``launch/steps.py``). Moves train_tokens_per_s."""
from bench.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, "train.update")
