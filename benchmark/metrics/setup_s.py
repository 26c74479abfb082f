"""Seconds from process start to the first timed step: the torch import,
the kernel library's load (and its nvcc build on a checkout's first
run), construction and warm-up."""


def read(run):
    return run["setup_s"]
