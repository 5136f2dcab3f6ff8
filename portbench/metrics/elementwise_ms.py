"""Bookkeeping: device ms per chunk of the kernels that are neither K1,
nor products, nor copies, nor the benchmark's own (the kernel table's
"bookkeeping" layer)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.chunks:
        return None
    us = tr.layer_us(run.kernel_layers["bookkeeping"])
    return us / tr.chunks / 1e3 if us > 0 else None
