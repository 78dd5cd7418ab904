"""host_waits.train (count), layer "train step": the host's waits on the
device inside the program's ``train.step`` per traced step, as the
program's ``host_waits`` counter holds them: each synchronizing operation
that CUDA's sync debug mode reports, plus the allocator's ``cudaFree``
calls and retries. Moves train_tokens_per_s."""
from bench.metrics.program_spans import counted


def read(run):
    n = counted(run, "host_waits")
    return None if n is None else n / run.trace.steps
