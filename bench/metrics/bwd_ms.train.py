"""bwd_ms.train (ms), layer "train step": the stream time of the program's
``train.backward`` spans per traced step, the sum of their CUDA-event
intervals (device idle inside an interval counts). The span covers one
microbatch's backward (``torch.autograd.grad`` in ``grads_once``),
remat's recompute inside, two a step. Moves train_tokens_per_s."""
from bench.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, "train.backward")
