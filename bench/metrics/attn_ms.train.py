"""attn_ms.train (ms), layer "train step": the stream time of the program's
``attn`` spans per traced step, the sum of their CUDA-event intervals
(device idle inside an interval counts). The span covers the attention
tile loops (``models/layers.py`` ``_FlashAttention.forward`` and
``.backward``): the forward, remat's recompute and the backward. Moves
train_tokens_per_s."""
from bench.metrics.program_spans import device_ms


def read(run):
    return device_ms(run, "attn")
