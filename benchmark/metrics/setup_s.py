"""Set-up time: the process's start to the window's start (import, CUDA
context, kernel libraries loaded or built, inputs from the seed, the
warm-up of the cell's own shapes)."""


def read(ctx):
    return ctx["setup_s"]
