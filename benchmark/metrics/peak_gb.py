"""Peak device memory over the window (torch.cuda.max_memory_allocated,
reset after the warm-up sort), in 10^9 bytes; the fullest card's."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
