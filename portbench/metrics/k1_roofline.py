"""DTW scorer K1: the least time K1's chunk could take at the data-sheet
peaks (its FLOPs at the gate decisions of the profiled chunks' inputs, its
bytes each read or written once: `counts.py`), over its device time per
chunk by kernel name, in %."""

from portbench import counts


def read(run):
    tr = run.trace
    flops = run.flops.get("k1", 0.0)
    if tr is None or not tr.chunks or flops <= 0:
        return None
    us = tr.layer_us(run.kernel_layers["k1"]) / tr.chunks
    if us <= 0:
        return None
    return 100.0 * counts.bound_seconds(flops, run.k1_bytes) / (us / 1e6)
