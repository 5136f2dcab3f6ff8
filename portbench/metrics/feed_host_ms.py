"""Host feed (`BatchedDetector._frames`): host ms per chunk of the program's
`rustpotter.feed` span, the frames' synchronous conversion to a device
tensor, in the profiled sub-window. The program opens its spans as
torch.profiler annotations, so they lie in the trace on the card's clock;
the profiler's own cost per runtime call is inside them. None where the
program records no such span."""


def read(run):
    tr = run.trace
    if tr is None or not tr.chunks:
        return None
    us = sum(b - a for name, a, b in tr.host
             if name == "rustpotter.feed" and tr.start <= a < tr.end)
    return us / tr.chunks / 1e3 if us > 0 else None
