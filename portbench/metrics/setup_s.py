"""setup_s: seconds from the harness's start to the window's: imports,
the CUDA context, the kernel library (built on a checkout's first run),
the solver's host build of the operator and the warm-up solve."""


def read(run):
    return run.setup_s
