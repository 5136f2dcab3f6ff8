"""Chunk step: the useful fp32 FLOPs of the window's chunks over the
window's seconds, as a share of the card's data-sheet fp32 peak, in %. The
FLOPs per chunk are the benchmark's counts from the shapes (`counts.py`):
the front-end's, the CMN means' and the NN's matrix products, and K1's work
at the gate decisions of the profiled chunks' inputs. The card's power
limit is printed beside it in the result line."""

from portbench import counts


def read(run):
    w = run.window
    flops = sum(run.flops.values())
    if not w.chunks or w.seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops * w.chunks / (w.seconds * counts.PEAK_FP32_FLOPS)
