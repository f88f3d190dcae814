"""Set-up: seconds from the process's start to the first timed multiply
(imports, the kernels' build or load, the inputs made from the seed, the
tiling, the cold plan and the warm-up)."""


def read(run):
    return run.setup_s
