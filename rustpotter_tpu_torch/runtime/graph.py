"""CUDA graphs of the stream steps: the counterpart of the JAX package's
`jax.jit(fn, donate_argnums=(1,))` over a step fn(params, states, x) ->
(states, Event) (`rustpotter_tpu/runtime/batch.py:210`,
`rustpotter_tpu/runtime/detector.py:103`) and of its jitted `lax.scan` over
T inputs (`batch.py:155-162,211`, `detector.py:105-112`).

`GraphedStep(fn)` wraps such a step, one that updates `states` in place
(`stream_step.make_batched_chunk`, `stream_step.make_step`):
  - on CPU tensors it calls fn: CPU runs stay eager;
  - on the card, everything runs with x's card as the current device: the
    kernel wrappers and ATen launch on the current stream of the card their
    tensors lie on, so a capture on any other card's stream would record
    nothing while the step ran for real;
  - the first call with a new capture key runs fn eagerly and returns that
    call's result. The eager call does the first-use work that a capture
    must not see: it builds the parameter set's constants, loads the
    kernels' libraries, sets their shared-memory attributes on first
    launch on the card, and builds the resampler's matrix (a host-to-device
    copy). Then fn is captured in a `torch.cuda.CUDAGraph`, reading an input
    buffer of its own; the Event it returns is the graph's output. Every
    later call with that key copies x into the input buffer, replays the
    graph on the current stream and returns a clone of each Event field:
    eight device copies outside the graph, the input's and the seven
    fields'.
  - the eager call and the capture both run on one side stream per card
    (`capture_stream`), ordered after the current stream's work and before
    its next. cuBLAS keeps a workspace per handle and stream, made at a
    handle's first GEMM on a stream (the autograd engine's thread has a
    handle of its own): made by the eager call on the one capture stream,
    it is made once per card and handle, in the allocator's ordinary pool.
    Made during a capture, on a new stream each time, it would land in that
    graph's private pool and hold the pool after the graph is dropped (64
    MiB more per `trainer.fit` on an H100, PERF.md).

The capture key (`capture_key`) is the identity of `params` (an immutable
object, held while its graph lives), the address, shape, strides and dtype
of every state tensor, x's shape and dtype, and whether tracing is on
(`utils/tracing.py`): with tracing on, K1 is launched with a pointer to the
card's counters, and a graph bakes its launches' arguments in, so turning
tracing on or off captures again at the next call. A graph reads and writes
the addresses it captured: a new state set (a second `init_states()`, the
fresh tensors of `batch.migrate_states`) is captured again, an in-place reset
is not. One graph is kept: a call with another key drops it and captures
anew, so two state sets used in turns stay correct and capture at every turn.

Spans (`utils/tracing.py`): `rustpotter.graph` around each call, and in it
`rustpotter.graph.key` (the key and its compare), `rustpotter.graph.replay`
(the input copy and the replay, one per input), `rustpotter.graph.clone`
(the Event's clones; a sequence's per-input copies), and at a new key
`rustpotter.graph.eager` (the eager call) and `rustpotter.graph.capture`. On
the CPU each call of fn is a `rustpotter.graph.eager` span. A sequence's
per-input spans carry their input's chunk id (the parent's plus t). The
replays and captures are counted from these spans; `captures` counts the
graphs captured as before.

The capture calls `CUDAGraph.capture_begin` and `capture_end` itself: the
`torch.cuda.graph` context also synchronizes the device and empties the
allocator's caches, on a serving process that other detectors share.

No fallback: a capture or a replay that fails raises. The eager call that
precedes a capture has then advanced `states` by one input.

Launch counts: the kernel wrappers count a launch in Python, which runs at
capture and never at replay. The capture's increments are taken back, and
added again at every replay: a count is derived from the capture, one per
kernel the capture's Python launched. That the graph holds those kernels
is measured by profiling replays (`tests/test_torch_graph_cuda.py`
`replays_run`, `tests/test_torch_tracing_cuda.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..ops import banded_dtw, biquad, frontend, fused_dtw
from ..utils import tracing

# the launch counts of the kernel wrappers a step reaches
_COUNTERS = (fused_dtw.LAUNCHES, banded_dtw.LAUNCHES, biquad.LAUNCHES, frontend.LAUNCHES)


_capture_streams: dict = {}


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of `device`'s card that every first eager call and
    capture runs on (see the module docstring), made at its first use."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    stream = _capture_streams.get(index)
    if stream is None:
        stream = _capture_streams[index] = torch.cuda.Stream(index)
    return stream


def capture_key(params, states, x: torch.Tensor) -> tuple:
    """What a capture of fn(params, states, x) depends on: equal keys replay
    the same graph."""
    return (
        id(params),
        tuple((t.data_ptr(), tuple(t.shape), t.stride(), t.dtype) for t in states),
        tuple(x.shape),
        x.dtype,
        tracing.enabled(),
    )


class GraphedStep:
    """fn(params, states, x) -> (states, Event), replayed from a CUDA graph on
    the card and called as it is on the CPU (see the module docstring).
    `fn` is the eager step; `captures` counts the graphs captured."""

    def __init__(self, fn):
        self.fn = fn
        self.captures = 0
        self._params = self._key = self._graph = self._x = self._out = None
        self._launches = []

    def __call__(self, params, states, x: torch.Tensor):
        with tracing.span("rustpotter.graph"):
            if x.device.type != "cuda":
                with tracing.span("rustpotter.graph.eager"):
                    return self.fn(params, states, x)
            with torch.cuda.device(x.device):
                first = self._ready(params, states, x)
                if first is not None:
                    return first
                self._replay(x)
                with tracing.span("rustpotter.graph.clone"):
                    return states, type(self._out)(*[f.clone() for f in self._out])

    def sequence(self, params, states, xs: torch.Tensor):
        """xs (T, ...): T calls in order. Returns the states and the Events
        stacked on a leading (T,) axis. On the card: one replay and one copy
        per Event field per input, nothing read on the host."""
        with tracing.span("rustpotter.graph"):
            if xs.device.type != "cuda":
                events = []
                for t in range(xs.shape[0]):
                    with tracing.span("rustpotter.graph.eager", offset=t):
                        states, ev = self.fn(params, states, xs[t])
                    events.append(ev)
                return states, type(events[0])(*[torch.stack(f) for f in zip(*events)])
            with torch.cuda.device(xs.device):
                first = self._ready(params, states, xs[0])
                out = [torch.empty((xs.shape[0], *f.shape), dtype=f.dtype, device=f.device)
                       for f in self._out]
                if first is not None:
                    with tracing.span("rustpotter.graph.clone"):
                        for dst, src in zip(out, first[1]):
                            dst[0].copy_(src)
                for t in range(0 if first is None else 1, xs.shape[0]):
                    self._replay(xs[t], t)
                    with tracing.span("rustpotter.graph.clone", offset=t):
                        for dst, src in zip(out, self._out):
                            dst[t].copy_(src)
            return states, type(self._out)(*out)

    def _ready(self, params, states, x) -> Optional[tuple]:
        """None if the graph holds this key; else the result of an eager call,
        after which the graph is captured for the key."""
        with tracing.span("rustpotter.graph.key"):
            key = capture_key(params, states, x)
            held = params is self._params and key == self._key
        if held:
            return None
        # drop the old graph (and its memory pool) before the new one
        self._params = self._key = self._graph = self._x = self._out = None
        current, side = torch.cuda.current_stream(x.device), capture_stream(x.device)
        side.wait_stream(current)
        try:
            with torch.cuda.stream(side):
                with tracing.span("rustpotter.graph.eager"):
                    result = self.fn(params, states, x)
                with tracing.span("rustpotter.graph.capture"):
                    self._capture(params, states, x)
        finally:
            current.wait_stream(side)
        self._params, self._key = params, key
        return result

    def _capture(self, params, states, x) -> None:
        """Captures fn on the current stream (the card's capture stream)."""
        xbuf = torch.empty(x.shape, dtype=x.dtype, device=x.device)
        graph = torch.cuda.CUDAGraph()
        before = [dict(c) for c in _COUNTERS]
        try:
            graph.capture_begin()
            try:
                _, out = self.fn(params, states, xbuf)
            finally:
                graph.capture_end()
        finally:
            launches = [(c, k, c[k] - b.get(k, 0)) for c, b in zip(_COUNTERS, before)
                        for k in c if c[k] != b.get(k, 0)]
            for counts, name, n in launches:
                counts[name] -= n
        self.captures += 1
        self._graph, self._x, self._out, self._launches = graph, xbuf, out, launches

    def _replay(self, x: torch.Tensor, t: int = 0) -> None:
        """Replay on x, the sequence's input t (for its span's chunk id)."""
        with tracing.span("rustpotter.graph.replay", offset=t):
            self._x.copy_(x)
            self._graph.replay()
        for counts, name, n in self._launches:
            counts[name] += n
