"""setup_s: from the process's start to the window's, less the making
of the traffic's pool: imports and CUDA, the model and the engine built
from the seed, the kernels built and every shape warmed up (host
clock).  The pool is the benchmark's own work, which no user pays and no
change to the program can move; the log line prints its seconds."""


def read(run):
    return run.setup_s
