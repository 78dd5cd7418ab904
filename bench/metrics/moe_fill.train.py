"""moe_fill.train (%), layer "train step": the expert buffers' useful
rows over the rows computed in the traced steps' forwards, 100 x the
program's ``moe.kept`` (choices that found a slot) / ``moe.slots`` (B x
experts x capacity per MoE layer). Moves train_tokens_per_s."""
from bench.metrics.program_spans import counted


def read(run):
    kept, slots = counted(run, "moe.kept"), counted(run, "moe.slots")
    if not slots:
        return None
    return 100.0 * kept / slots
