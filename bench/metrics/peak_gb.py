"""The program's peak device memory over the window, in GB:
``max_memory_allocated`` (its statistics reset at the window's start) less
the bytes of the answers the harness keeps for its check, which the card
holds through every multiply once the sample is full."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
