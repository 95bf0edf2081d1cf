"""setup_s: the interpreter's start, torch's import and the card's CUDA
context excluded, to the first timed call (the program's import and
kernels, the pool, the warm-up), host clock."""


def read(run):
    return run.setup_s
