"""Reading torch.profiler's Chrome trace of a profiled sub-window.

The device's events (kernels, copies, sets) and the host's (operators,
runtime calls, the benchmark's own `record_function` spans) share one
clock in the trace. Each device event is placed in a layer by the
benchmark's kernel-name table (`portbench/kernels/*.json`): by its name,
and for a table entry with `spans`, by the benchmark's span around the
runtime call that launched it (matched by the trace's correlation id).
"""
from __future__ import annotations

import json
import os
import re
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "copy", "gpu_memset": "set"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}
WINDOW_SPAN = "portbench.window"


@dataclass
class DeviceEvent:
    name: str
    kind: str  # kernel, copy or set
    start: float  # us
    end: float
    span: str = ""  # the benchmark's span around the launching call
    layer: str = ""


@dataclass
class Trace:
    events: List[DeviceEvent]
    host: List[Tuple[str, float, float]]  # (name, start, end) of host spans, us
    start: float  # the profiled window, us
    end: float
    chunks: int  # chunks handed over inside the window

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device events' intervals inside the window."""
        spans = sorted((max(e.start, self.start), min(e.end, self.end)) for e in self.events
                       if e.end > self.start and e.start < self.end)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def layer_us(self, layer: str) -> float:
        return sum(e.end - e.start for e in self.events if e.layer == layer)

    def count(self, kind: str, skip: str = "") -> int:
        """Device events of `kind`, those of layer `skip` left out."""
        return sum(1 for e in self.events if e.kind == kind and e.layer != skip)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the innermost host span that covers its start."""
        by_name: Dict[str, float] = {}
        for e in self.events:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.end - e.start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        gaps = sorted(gaps, key=lambda ab: ab[0] - ab[1])[:top]
        return {"device_ops": [[_short(n), s] for n, s in ops],
                "idle_gaps": [[self._host_at(a), (b - a) / 1e6] for a, b in gaps]}

    def _host_at(self, t: float) -> str:
        return _short(_innermost(self.host, t) or "no host span")


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def load_layers(kernels_dir: str) -> List[Tuple[int, str, List[re.Pattern], tuple]]:
    """The kernel-name table: every `*.json` under kernels_dir holds a
    layer, its name patterns (regular expressions, searched in a device
    event's name), a priority (lower ones are tried first) and optionally
    `spans`: the benchmark's spans whose launches alone it takes."""
    table = []
    for fn in sorted(os.listdir(kernels_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(kernels_dir, fn)) as f:
                d = json.load(f)
            table.append((int(d["priority"]), d["layer"],
                          [re.compile(p, re.I) for p in d["match"]], tuple(d.get("spans", ()))))
    return sorted(table, key=lambda t: t[0])


def layer_of(name: str, span: str, table) -> str:
    for _, layer, pats, spans in table:
        if (not spans or span in spans) and any(p.search(name) for p in pats):
            return layer
    return "unplaced"


def _innermost(spans: List[Tuple[str, float, float]], t: float) -> str:
    inner = None
    for name, a, b in spans:
        if a <= t < b and (inner is None or b - a < inner[2] - inner[1]):
            inner = (name, a, b)
    return inner[0] if inner else ""


def parse(path: str, table) -> Trace:
    with open(path) as f:
        doc = json.load(f)
    evs = doc["traceEvents"] if isinstance(doc, dict) else doc
    device, host, window, launch = [], [], None, {}
    for e in evs:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        kind = DEVICE_CATS.get(e.get("cat", ""))
        corr = (e.get("args") or {}).get("correlation")
        if kind:
            device.append((DeviceEvent(e["name"], kind, a, a + d), corr))
        elif e.get("cat") in HOST_CATS:
            host.append((e["name"], a, a + d))
            if e["name"] == WINDOW_SPAN:
                window = (a, a + d)
            if e.get("cat") == "cuda_runtime" and corr is not None:
                launch[corr] = a
    ours = [h for h in host if h[0].startswith("portbench.") and h[0] != WINDOW_SPAN]
    for ev, corr in device:
        ev.span = _innermost(ours, launch[corr]) if corr in launch else ""
        ev.layer = layer_of(ev.name, ev.span, table)
    device = [ev for ev, _ in device]
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    inside = [e for e in device if window[0] <= e.start < window[1]]
    return Trace(inside, host, window[0], window[1], 0)


def profile(fn, table) -> Trace:
    """Run fn() under torch.profiler inside a `portbench.window` span and
    read its trace; the trace file lives in the temporary directory and is
    removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile as _profile

    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return parse(path, table)
    finally:
        os.remove(path)
