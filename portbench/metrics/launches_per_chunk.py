"""Graph (`GraphedStep` replay): the program's device kernels per chunk in
the profiled sub-window's trace; copies, sets and the kernels the
benchmark's own feed and readback launch (the kernel table's "harness"
layer) are not counted."""


def read(run):
    tr = run.trace
    if tr is None or not tr.chunks:
        return None
    n = tr.count("kernel", skip=run.kernel_layers["harness"])
    return n / tr.chunks if n else None
