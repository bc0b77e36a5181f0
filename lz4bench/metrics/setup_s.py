"""Set-up: process start to the first timed request, on the host clock:
imports, CUDA start, corpora, the frozen encoder's build (first run) and
frames, the kernels' build (first run) or load, warm-up."""


def read(window):
    return window.setup_s
