"""The port's tracer: spans and counters recorded where the work happens.

One process-wide switch, off by default: `enable()`, `disable()`,
`enabled()`. `reset()` drops what was recorded and zeroes the counters;
`snapshot()` returns it; nothing else reads it out of memory;
`utils/profiling.trace` is the exporter.

Spans (`span(name)`, a context manager). Off, `span` tests two flags and
returns one shared no-op context: no clock read, no allocation. On, a span
records its name, its start and end (`time.perf_counter_ns`), its parent
(the innermost span open when it opened) and its chunk id. A root span
passes `chunk=`, the per-detector count of chunks handed over; a span
without one takes its parent's, plus `offset` (a `process_sequence` call's
per-chunk spans carry their own chunk's id). Whenever a `torch.profiler`
profile is active, on or off, a span also opens
`torch.profiler.record_function(name)`: the span then lies in the profile's
Chrome trace as a `user_annotation`, on the clock of the card's kernels and
copies. So a profile names the program's layers, and an idle gap of the
card the host span it falls in, with tracing off too; in memory a span is
recorded only with tracing on. One thread: spans nest as a stack.

Memory. The spans are kept in a ring of the newest `MAX_SPANS` (about 50 MB
at most): some 6 spans a `process_chunk` call and some 70 a 33-chunk
`process_sequence` call, so the ring holds the last ~40,000 served chunks.
Older spans are dropped and counted (`snapshot()["dropped"]`); a span whose
parent was dropped reads parent None. A reader that wants every span of a
window calls `reset()` at its start and `snapshot()` before the ring fills.

The spans, by layer (the layers of PERF.md §3):
  - `rustpotter.process_chunk`, `rustpotter.process_sequence`: the API
    (`BatchedDetector`), the root of a chunk's spans;
  - `rustpotter.bundle`: a `BatchedDetector`'s bundle build, at set-up and
    at every rebuild (`add_wakeword`, `remove_wakeword`, `update_*config`);
  - `rustpotter.feed`: the frames' conversion to a device tensor
    (`BatchedDetector._frames`, a synchronous host-to-device copy);
  - `rustpotter.graph`: a `GraphedStep` call, around the five below;
  - `rustpotter.graph.key`: the capture key and its compare;
  - `rustpotter.graph.replay`: the input buffer's copy and the replay, one a
    chunk (the replay count);
  - `rustpotter.graph.clone`: the Event's clones, or a sequence's per-chunk
    copies;
  - `rustpotter.graph.eager`: the eager call before a capture (on the CPU,
    every call);
  - `rustpotter.graph.capture`: a capture (the capture count).

Counters. Host counters are plain ints (`count`). Device counters are one
int64 tensor per card (`device_counters`), slots `DEVICE_COUNTERS`, made at
their first use with tracing on, which is the eager call before a capture
and never inside one; a kernel adds to them on the card. `snapshot` reads
them, one read per card, and adds the host counters of the same names
(the plain versions count there). K1's gated launch counts, over its blocks
of 32 streams x 3 shifts of one template pair: the lanes whose avg gate is
open, the lanes decided, the blocks that did the work (a lane open) and the
blocks launched; and the first two of these by DTW wakeword d, for d below
`K1_WAKEWORDS`: `k1.lanes_open.w<d>` and `k1.blocks_run.w<d>`, which add
up to `k1.lanes_open` and `k1.blocks_run`. Beside each card's tensor
the tracer keeps the most wakewords a K1 launch there has counted on their
own (set by `device_counters`), and `snapshot` names that card's
per-wakeword slots up to it. Neither `enable` nor `reset` clears it: a
captured graph adds to those slots with no call to `device_counters`.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# the first slots of each card's counter tensor, in order; then two per
# wakeword (`k1_wakeword_names`) for K1_WAKEWORDS wakewords
DEVICE_COUNTERS = ("k1.lanes_open", "k1.lanes", "k1.blocks_run", "k1.blocks")
K1_WAKEWORDS = 32


def k1_wakeword_names(d: int) -> tuple:
    """The names of DTW wakeword d's two K1 counters, in slot order."""
    return f"k1.lanes_open.w{d}", f"k1.blocks_run.w{d}"


MAX_SPANS = 1 << 18  # the ring's length; read at each reset()

_on = False
_clock = time.perf_counter_ns
_spans: Deque[list] = deque(maxlen=MAX_SPANS)  # [name, start_ns, end_ns or None, parent record, chunk]
_opened = 0  # spans recorded since the last reset, the dropped ones included
_stack: List[list] = []  # the open spans' records, innermost last
_host: Dict[str, int] = {}
_device: Dict[int, torch.Tensor] = {}  # card index -> (SLOTS,) int64
_k1_wakewords: Dict[int, int] = {}  # card index -> the most wakewords K1 counted there
SLOTS = len(DEVICE_COUNTERS) + 2 * K1_WAKEWORDS


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "chunk", "offset", "rec", "rf")

    def __init__(self, name: str, chunk: Optional[int], offset: int):
        self.name, self.chunk, self.offset = name, chunk, offset
        self.rec = self.rf = None

    def __enter__(self):
        global _opened
        parent = _stack[-1] if _stack else None
        chunk = self.chunk
        if chunk is None and parent is not None and parent[4] is not None:
            chunk = parent[4] + self.offset
        if _autograd_profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.rec = [self.name, _clock(), None, parent, chunk]
        _spans.append(self.rec)
        _opened += 1
        _stack.append(self.rec)
        return None

    def __exit__(self, *exc):
        self.rec[2] = _clock()
        if _stack and _stack[-1] is self.rec:  # a reset() inside the span cleared it
            _stack.pop()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, chunk: Optional[int] = None, offset: int = 0):
    """A context manager around one layer's work (see the module docstring)."""
    if _on:
        return _Span(name, chunk, offset)
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def enable() -> None:
    """Turn tracing on. A `GraphedStep` captures again at its next call:
    the tracer's state is part of the capture key (the K1 counter's pointer
    is baked into the graph)."""
    global _on
    _on = True


def disable() -> None:
    """Turn tracing off (what was recorded is kept until `reset`)."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Drop the spans and zero every counter; the device counters are zeroed
    in place (on the card's current stream), so a captured graph keeps
    adding to them."""
    global _spans, _stack, _opened
    _spans, _stack, _opened = deque(maxlen=MAX_SPANS), [], 0
    _host.clear()
    for t in _device.values():
        t.zero_()


def count(name: str, n: int) -> None:
    """Add n to the host counter `name` (with tracing on)."""
    if _on:
        _host[name] = _host.get(name, 0) + int(n)


def device_counters(device: torch.device, k1_wakewords: int) -> torch.Tensor:
    """The (SLOTS,) int64 counter tensor of `device`'s card, made at its
    first use, for a K1 launch of `k1_wakewords` DTW wakewords. It is never
    made during a capture: a graph must read an address that outlives it,
    and the eager call before every capture makes it first. K1 counts
    min(k1_wakewords, K1_WAKEWORDS) wakewords on their own."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    t = _device.get(index)
    if t is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the device counters are made before a capture, not inside one")
        t = _device[index] = torch.zeros(SLOTS, dtype=torch.int64,
                                         device=torch.device("cuda", index))
        _k1_wakewords[index] = 0
    _k1_wakewords[index] = max(_k1_wakewords[index], min(k1_wakewords, K1_WAKEWORDS))
    return t


def snapshot() -> dict:
    """What was recorded since the last `reset`: `spans`, a list of
    {name, start_ns, end_ns, parent (index into the list, or None), chunk,
    self_ns} in the order they opened (end_ns and self_ns None while open;
    the ring's newest `MAX_SPANS`), `dropped`, the older spans the ring let
    go, and `counters` by name (the device counters read now, one read per
    card, plus the host counters of the same names)."""
    index = {id(rec): i for i, rec in enumerate(_spans)}
    child_ns = [0] * len(_spans)
    spans = []
    for rec in _spans:
        name, start, end, parent, chunk = rec
        p = index.get(id(parent)) if parent is not None else None
        if p is not None and end is not None:
            child_ns[p] += end - start
        spans.append({"name": name, "start_ns": start, "end_ns": end, "parent": p,
                      "chunk": chunk})
    for s, kids in zip(spans, child_ns):
        s["self_ns"] = None if s["end_ns"] is None else s["end_ns"] - s["start_ns"] - kids
    counters = dict(_host)
    for index, t in _device.items():
        names = DEVICE_COUNTERS + tuple(
            n for d in range(_k1_wakewords[index]) for n in k1_wakeword_names(d))
        for name, v in zip(names, t.tolist()):
            counters[name] = counters.get(name, 0) + v
    return {"spans": spans, "dropped": _opened - len(_spans), "counters": counters}

