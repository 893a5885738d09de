"""Seconds from the start of the process to the window: imports, CUDA
start-up, the kernel library, the pairs made from the seed, the warm-up."""


def read(run):
    return run.setup_s
