"""setup_s: seconds from the process's start to the window's start: imports,
data made on the card, the index build, warm-up and captures (and, in a
checkout's first run, the kernels' nvcc build)."""


def read(ctx):
    return ctx["setup_s"]
