"""setup_s: from the process's start to the window's: imports, the
model and the engine built from the seed, the traffic made, the kernels
built and every shape warmed up (host clock)."""


def read(run):
    return run.setup_s
