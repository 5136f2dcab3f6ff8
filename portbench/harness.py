"""One run of one cell: set-up, the measured window, the profiled
sub-window (with `--trace 1`), then the comparison with the reference.

Everything a cell is made of is found by name from BENCHMARK.json: its
configuration file, its traffic file (`portbench/traffic/<traffic>.json`),
its limits (`portbench/limits/<cell>.json`), the kernel-name table
(`portbench/kernels/*.json`) and the per-layer metrics' readers
(`portbench/metrics/<metric>.py`, or for a name with a dot in it the
reader of the part before the first dot, each with `read(run)` returning a
number or None).

Traffic modes:
  - "sequence": a closed loop of `BatchedDetector.process_sequence` calls
    of `chunks_per_call` chunks from the card-resident ring; each call's
    events are copied to the host behind it and taken in while the next
    call runs, the last before the window closes;
  - "chunk": a closed loop of `BatchedDetector.process_chunk` calls, each
    handed a pinned host tensor from the ring (copied to pinned memory at
    set-up); each chunk's events are read to the host before the next is
    handed over.
The window starts at the first timed chunk and closes at the end of the
call in which `seconds` have passed. Every chunk the detector is handed, from the first
warm-up chunk on, is compared for the sampled streams, and their window
rows every `window_every` chunks.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from . import check, counts, synth, trace, wakewords
from .reference import detector as refdet

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
REALTIME_S = 0.03  # audio per chunk


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    spec: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def cell(name: str) -> Cell:
    bench = load_json(ROOT, "BENCHMARK.json")
    spec = next(w for w in bench["workloads"] if w["name"] == name)
    conf = next(c for c in bench["configs"] if c["name"] == spec["config"])
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved else [])]
    return Cell(name, spec, load_json(ROOT, conf["file"]),
                load_json(BENCH_DIR, "traffic", spec["traffic"] + ".json"),
                load_json(BENCH_DIR, "limits", name + ".json")["limits"], e2e, layer)


class Recorder:
    """The host copies of the events: `fired`, `ww` and `score` of every
    stream, copied into pinned host buffers each call, every stream's
    reports counted, and the sampled streams' fields kept; and the sampled
    streams' window rows, oldest first, when `snapshot` is called.

    `launch` and `snapshot` enqueue their copies behind the calls already
    on the card's stream; `land(keep)` waits for all but the newest `keep`
    of them and takes them in on the host, in order. Each (T, B) shape has
    two sets of pinned buffers, used in turn, so a sequence call's copies
    can be in flight while the previous call's are taken in."""

    def __init__(self, sampled: torch.Tensor, smax: int):
        self.idx = sampled
        self.idx_h = sampled.cpu().numpy()
        self.S, self.smax = len(sampled), smax
        self.parts: List[np.ndarray] = []
        self.fires = 0
        self.bufs: Dict[tuple, List[List[torch.Tensor]]] = {}
        self.turn: Dict[tuple, int] = {}
        self.pending: List[tuple] = []  # (event or None, take-in function)
        self.windows: List[tuple] = []  # (chunks handed, (S, F, C))

    def _copy(self, src: List[torch.Tensor], bufs: List[torch.Tensor]):
        cuda = src[0].device.type == "cuda"
        for dst, t in zip(bufs, src):
            dst.copy_(t, non_blocking=cuda)
        if not cuda:
            return None
        done = torch.cuda.Event()
        done.record()
        return done

    def snapshot(self, states, handed: int) -> None:
        """Enqueue a copy of the sampled streams' window and its cursor."""
        src = [states.win[:, :, self.idx], states.rot.reshape(1)]  # (F, C, S), (1,)
        cuda = src[0].device.type == "cuda"
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda) for t in src]
        done = self._copy(src, bufs)

        def take() -> None:
            win, rot = bufs
            F = win.shape[0]
            phys = (int(rot[0]) + 1 + torch.arange(F)) % F
            self.windows.append((handed, win[phys].permute(2, 0, 1).double().numpy()))

        self.pending.append((done, take))

    def launch(self, ev, T: int, B: int) -> None:
        """Enqueue three copies of the whole fleet's fields and one of the
        sampled streams' avg score, counter and scores."""
        i = self.idx
        samp = torch.cat([ev.avg_score.reshape(T, B)[:, i],
                          ev.counter.reshape(T, B)[:, i].to(torch.float32),
                          ev.scores.reshape(T, B, -1)[:, i].reshape(T, -1)], dim=1)
        src = [ev.fired.reshape(T, B), ev.ww.reshape(T, B), ev.score.reshape(T, B), samp]
        cuda = samp.device.type == "cuda"
        if (T, B) not in self.bufs:
            self.bufs[(T, B)] = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                                  for t in src] for _ in range(2)]
            self.turn[(T, B)] = 0
        bufs = self.bufs[(T, B)][self.turn[(T, B)]]
        self.turn[(T, B)] ^= 1
        done = self._copy(src, bufs)

        def take() -> None:
            fired, ww, score, samp_h = (b.numpy() for b in bufs)
            self.fires += int(fired.sum())
            i_h = self.idx_h
            self.parts.append(np.concatenate([fired[:, i_h], ww[:, i_h], score[:, i_h], samp_h],
                                             axis=1).astype(np.float64))

        self.pending.append((done, take))

    def land(self, keep: int = 0) -> None:
        """Wait for all but the newest `keep` enqueued copies; take them in."""
        while len(self.pending) > keep:
            done, take = self.pending.pop(0)
            if done is not None:
                done.synchronize()
            take()

    def read(self, ev, T: int, B: int) -> None:
        """`launch`, then wait for it."""
        self.launch(ev, T, B)
        self.land()

    def fields(self) -> Dict[str, np.ndarray]:
        """The sampled streams' reports, (S, chunks) each."""
        a = np.concatenate(self.parts)  # (chunks, 5S + S smax)
        S = self.S
        col = lambda k: a[:, k * S:(k + 1) * S].T
        return {"fired": col(0) > 0.5, "ww": col(1).astype(np.int64), "score": col(2),
                "avg_score": col(3), "counter": col(4).astype(np.int64),
                "scores": a[:, 5 * S:].reshape(-1, S, self.smax).transpose(1, 0, 2)}

@dataclass
class Window:
    chunks: int = 0
    seconds: float = 0.0
    latency_ms: List[float] = field(default_factory=list)
    api_ms: List[float] = field(default_factory=list)


@dataclass
class RunData:
    """What a per-layer metric's reader gets."""

    cell: Cell
    window: Window
    trace: Optional[trace.Trace]  # the profiled sub-window
    flops: Dict[str, float]  # per chunk: useful FLOPs by part
    products: List[counts.Product]  # the chunk's matrix products
    k1_bytes: float
    power_limit_w: Optional[float]
    kernel_layers: Dict[str, str]  # role -> layer name in the kernel table


def sample_streams(fleet: synth.Fleet, tr: dict, gen: torch.Generator) -> torch.Tensor:
    """Stream 0 and the last utterance stream, then utterance streams up to
    `check_utterance`, near streams up to `check_near` and noise streams up
    to `check_streams` in all, each drawn from the seed across the fleet."""
    B = tr["streams"]
    utt = fleet.utt.tolist()
    picks = [utt[0], utt[-1]]
    order = torch.randperm(B, generator=torch.Generator().manual_seed(
        int(torch.randint(0, 2 ** 62, (1,), generator=gen, device=gen.device))))
    want = {"utterance": tr["check_utterance"], "near": tr["check_near"]}
    want["noise"] = tr["check_streams"] - want["utterance"] - want["near"]
    have = {"utterance": len(set(picks)), "near": 0, "noise": 0}
    for s, cls in zip(order.tolist(), fleet.classes(order.tolist())):
        if s not in picks and have[cls] < want[cls]:
            picks.append(s)
            have[cls] += 1
    return torch.tensor(sorted(set(picks)))


def power_limit() -> Optional[float]:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _products(config: dict, ww: wakewords.Wakewords, B: int) -> List[counts.Product]:
    C, F = config["mfcc_size"], wakewords.window_frames(config)
    out = counts.frontend_products(B, C)
    dtw = [w for w in ww.reference if isinstance(w, refdet.DtwWakeword)]
    if dtw:
        P = sum(len(w.templates) + (w.avg is not None) for w in dtw)
        out += counts.cmn_products(B, C, F, P)
    for spec in ww.specs:
        if spec["kind"] == "nn":
            out += counts.nn_products(B, C, F, spec["train_size"], spec["layers"])
    return out


def inputs(config: dict, tr: dict, seed: int, dev: torch.device):
    """What the seed makes, in this order: the wakewords, the fleet's
    streams, the sampled streams."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ww = wakewords.build(config, gen, dev)
    first = next(s for s in ww.specs if s["kind"] == "dtw" or s.get("firing_unit"))
    spec = first["utterances"] if first["kind"] == "dtw" else first["firing_unit"]["utterances"]
    fleet = synth.make_fleet(tr, tr["streams"], wakewords.window_frames(config), spec, gen, dev)
    sampled = sample_streams(fleet, tr, gen)
    return ww, fleet, sampled


def run(name: str, seed: int, seconds: float, traced: bool, t0: float,
        device: str = "cuda", traffic: Optional[dict] = None, detector_cls=None) -> dict:
    """One run; returns the result's fields (see run.py). `traffic`
    (entries that replace the traffic file's) and `detector_cls` (in place
    of `BatchedDetector`) are for tests."""
    phases = {"start": time.perf_counter() - t0}  # set-up's parts, seconds from t0
    c = cell(name)
    tr, config = {**c.traffic, **(traffic or {})}, c.config
    B = tr["streams"]
    dev = torch.device(device)
    ww, fleet, sampled = inputs(config, tr, seed, dev)
    phases["inputs"] = time.perf_counter() - t0
    F = wakewords.window_frames(config)
    smax = refdet.smax_of(ww.reference)
    import rustpotter_tpu_torch as rp

    objs, cfg = wakewords.for_program(ww, config)
    det = (detector_cls or rp.BatchedDetector)(objs, config=cfg, batch_size=B, device=dev)
    states = det.init_states()
    rec = Recorder(sampled.to(dev), smax)
    phases["detector"] = time.perf_counter() - t0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    chunk_mode = tr["mode"] == "chunk"
    handed = 0  # chunks handed to the detector so far
    every = tr["window_every"]

    if chunk_mode:
        pool = torch.empty(fleet.ring.shape, pin_memory=dev.type == "cuda")
        pool.copy_(fleet.ring)
        sp, loops, loop_of, phase = (t.cpu() for t in (fleet.special, fleet.loops,
                                                       fleet.loop_of, fleet.phase))

        def step(win: Optional[Window]) -> None:
            nonlocal states, handed
            with torch.profiler.record_function("portbench.feed"):
                x = pool[handed % fleet.R]
                x[sp] = loops[loop_of, (phase + handed) % loops.shape[1]]
            a = time.perf_counter()
            with torch.profiler.record_function("portbench.process_chunk"):
                states, ev = det.process_chunk(det.params, states, x)
            b = time.perf_counter()
            with torch.profiler.record_function("portbench.readback"):
                rec.read(ev, 1, B)
            e = time.perf_counter()
            handed += 1
            if handed % every == 0:
                with torch.profiler.record_function("portbench.readback"):
                    rec.snapshot(states, handed)
                    rec.land()
            if win is not None:
                win.chunks += 1
                win.api_ms.append((b - a) * 1e3)
                win.latency_ms.append((e - a) * 1e3)
    else:
        T = tr["chunks_per_call"]
        if T != fleet.R:
            raise ValueError("a sequence call takes one ring: chunks_per_call == ring_chunks")
        xs = fleet.ring

        def step(win: Optional[Window]) -> None:
            nonlocal states, handed
            with torch.profiler.record_function("portbench.feed"):
                xs.index_copy_(1, fleet.special, fleet.special_chunks(handed, T))
            with torch.profiler.record_function("portbench.process_sequence"):
                states, ev = det.process_sequence(det.params, states, xs)
            with torch.profiler.record_function("portbench.readback"):
                before = len(rec.pending)
                rec.launch(ev, T, B)
                if (handed + T) // every > handed // every:
                    rec.snapshot(states, handed + T)
                # the previous call's copies landed while this call runs
                rec.land(keep=len(rec.pending) - before)
            handed += T
            if win is not None:
                win.chunks += T

    phases["feed"] = time.perf_counter() - t0
    for _ in range(tr["warmup_steps"]):
        step(None)
    rec.land()
    sync()
    t_start = time.perf_counter()
    phases["warmup"] = t_start - t0
    setup_s = t_start - t0
    win = Window()
    while True:
        step(win)
        if time.perf_counter() - t_start >= seconds:
            break
    with torch.profiler.record_function("portbench.readback"):
        rec.land()
    win.seconds = time.perf_counter() - t_start

    prof = None
    if traced:
        before = handed

        def sub_window() -> None:
            for _ in range(tr["profile_steps"]):
                step(None)
            with torch.profiler.record_function("portbench.readback"):
                rec.land()

        prof = trace.profile(sub_window, trace.load_layers(os.path.join(BENCH_DIR, "kernels")))
        prof.chunks = handed - before

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if not rec.windows or rec.windows[-1][0] != handed:
        rec.snapshot(states, handed)
        rec.land()
    port = rec.fields()
    port["windows"] = rec.windows
    fires = rec.fires
    pcm = fleet.stream_pcm(sampled.tolist(), handed)
    classes = fleet.classes(sampled.tolist())
    n_of = {"utterance": len(fleet.utt), "near": len(fleet.near)}
    n_of["noise"] = B - sum(n_of.values())
    del det, states, fleet, rec
    if chunk_mode:
        del pool
    else:
        del xs
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = refdet.run_streams(pcm, ww.reference, wakewords.settings(config),
                             config["mfcc_size"], "f64")
    reference_s = time.perf_counter() - t_ref
    numbers = check.compare(port, ref)
    checks = check.judge(numbers, c.limits)
    correct = all(v["ok"] for v in checks.values())

    out = {"correct": correct, "attempted": int(port["fired"].size),
           "failed": int(numbers["event_mismatch"]), "fires": fires,
           "chunks": handed, "reference_s": reference_s, "setup_phases": phases}
    if not traced:
        rate = B * win.chunks * REALTIME_S / win.seconds
        values = {"streams_rt": rate, "streams_rt.serve": rate,
                  "chunk_ms_p95": float(np.percentile(win.latency_ms, 95)) if win.latency_ms else None,
                  "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                          for m in c.end_to_end if values.get(m["name"]) is not None}
    else:
        products = _products(config, ww, B)
        flops = {"products": sum(p[1] for p in products)}
        C, band = config["mfcc_size"], config["detector"]["band_size"]
        k1_bytes, lens = 0.0, []
        for j, w in enumerate(ww.reference):
            if not isinstance(w, refdet.DtwWakeword):
                continue
            # the profiled chunks' gate decisions of the sampled streams
            gates = ref.gates[:, :, j].reshape(len(classes), -1, 3)[:, -prof.chunks:]
            pat = counts.gate_patterns(gates, n_of, classes)
            tl = [len(t) for _, t in w.templates]
            flops["k1"] = flops.get("k1", 0.0) + counts.k1_flops(tl, len(w.avg), band, C, B, pat)
            lens += tl + [len(w.avg)]
        if lens:
            k1_bytes = counts.k1_bytes(F, C, B, len(lens), max(lens))
        data = RunData(c, win, prof, flops, products, k1_bytes,
                       power_limit() if dev.type == "cuda" else None,
                       {d["role"]: d["layer"] for d in (load_json(BENCH_DIR, "kernels", f)
                        for f in sorted(os.listdir(os.path.join(BENCH_DIR, "kernels"))))})
        vals = {}
        for m in c.per_layer:
            v = read_metric(m["name"], data)
            if v is not None:
                vals[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = vals
        out["breakdown"] = prof.breakdown()
        out["busy_s"] = prof.busy_us() / 1e6
        out["window_s"] = prof.window_us / 1e6
        out["power_limit_w"] = data.power_limit_w
    out["memory_peak_bytes"] = int(peak)
    out["checks"] = checks
    return out


def read_metric(name: str, data: RunData):
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.isfile(path):
        path = os.path.join(BENCH_DIR, "metrics", name.split(".")[0] + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(data)
