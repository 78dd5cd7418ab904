"""peak_hbm_gib.train (GiB), layer "device": the allocator's peak
(``torch.cuda.max_memory_allocated``) over the window, its statistics
reset when the window opens. Moves train_tokens_per_s (the batch and
recomputation that fit)."""


def read(run):
    if not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
