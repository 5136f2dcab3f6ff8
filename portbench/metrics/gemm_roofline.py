"""Products: the sum of each fp32 matrix product's least time at the
data-sheet peaks (counted from the chunk's shapes, `counts.py`) over the
device time per chunk of the kernels the kernel table places in this
layer, in %."""

from portbench import counts


def read(run):
    tr = run.trace
    if tr is None or not tr.chunks:
        return None
    us = tr.layer_us(run.kernel_layers["products"]) / tr.chunks
    if us <= 0:
        return None
    least = sum(counts.bound_seconds(f, b) for _, f, b in run.products)
    return 100.0 * least / (us / 1e6)
