"""Device: the share of the measured window in which the card has no work,
in %: 1 - (the card's busy time per chunk in the profiled sub-window, the
union of its kernels, copies and sets) x the window's chunks / the window's
seconds. The busy time comes from the trace and the window from the
untraced run, because profiling stretches a served chunk's host work (by
the profiler's tracing of the card's activity, with or without the host's
operators) while the card's own work keeps its length."""


def read(run):
    tr, w = run.trace, run.window
    if tr is None or not tr.chunks or not w.chunks or w.seconds <= 0:
        return None
    busy_s = tr.busy_us() / tr.chunks / 1e6
    return 100.0 * (1.0 - busy_s * w.chunks / w.seconds)
