"""Seconds from the process's start to the window's first unit: imports,
the CUDA context, the kernels loaded (built on a checkout's first run),
the weights made, the checked steps and the warm-up."""


def read(run):
    return run.setup_s
