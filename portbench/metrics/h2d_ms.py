"""Host feed: device ms per chunk of the host-to-device copies, from the
profiled sub-window's trace (the kernel table's "feed" layer)."""


def read(run):
    tr = run.trace
    if tr is None or not tr.chunks:
        return None
    us = tr.layer_us(run.kernel_layers["feed"])
    return us / tr.chunks / 1e3 if us > 0 else None
