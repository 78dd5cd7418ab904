"""exchange_idle_ms.train (ms), layer "device": the device's idle time
inside the host's ``exchange`` spans per traced step, the gaps in the
trace's busy intervals that fall inside each span, on the trace's clock.
Only in the exchange's cells. Moves train_tokens_per_s."""
from bench.metrics.program_spans import idle_ms


def read(run):
    return idle_ms(run, "exchange")
