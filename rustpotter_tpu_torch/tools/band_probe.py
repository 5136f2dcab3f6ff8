"""Time the serving paths of a checkout of the port at a wide band on the
card: the graphed per-shift step (`make_step` in a `GraphedStep`) and the
graphed batched chunk (`BatchedDetector.process_chunk`) at B = 8192 streams
on the bench wakeword (Lm = 100, C = 16), with `band_size` set to each band.
Past K1's and K2's rings (w > 20) the bundle routes both paths to K4, three
launches per chunk.

    python3 rustpotter_tpu_torch/tools/band_probe.py [--root DIR] [--w N ...]   # needs a card

DIR (default: the checkout that holds this file) is the root of the checkout
whose package is timed: a copy of this tree with a variant of a kernel, or an
earlier commit unpacked by `git archive`. Run it once per checkout, in turns,
to compare two designs by the same code on one card; for that reason it
imports nothing of the checkout that holds it. Per band and path it runs one
chunk of noise (the graph's capture), checks that the chunk launched K4 three
times and no other DTW kernel, then times TIMED_WINDOWS windows of
TIMED_CHUNKS chunks: the host clock per chunk (median window) and the graph's
device time per chunk (CUDA events around each window, median). The last
line is one JSON object of these numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

B = 8192
BANDS = (21, 24)
TIMED_CHUNKS, TIMED_WINDOWS = 34, 5


def windows(process, states, noise):
    """(host ms, device ms) per chunk of process(states, frames): the medians
    of TIMED_WINDOWS windows of TIMED_CHUNKS chunks after one warm-up chunk."""
    states, _ = process(states, noise)
    host, device = [], []
    for _ in range(TIMED_WINDOWS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        for _ in range(TIMED_CHUNKS):
            states, _ = process(states, noise)
        b.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / TIMED_CHUNKS)
        device.append(a.elapsed_time(b) / TIMED_CHUNKS)
    return float(np.median(host)), float(np.median(device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout whose package is timed")
    ap.add_argument("--w", type=int, nargs="+", default=list(BANDS), help="bands (> 20)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("band_probe: no CUDA device", file=sys.stderr)
        return 2
    if min(args.w) <= 20:
        ap.error("the bands must pass K1's and K2's rings (w > 20), where K4 serves")
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
    from rustpotter_tpu_torch.ops import fused_dtw as fd
    from rustpotter_tpu_torch.runtime.batch import BatchedDetector
    from rustpotter_tpu_torch.runtime.bundle import build_bundle
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.runtime.state import init_state
    from rustpotter_tpu_torch.runtime.stream_step import make_step
    from rustpotter_tpu_torch.synthetic import build_bench_wakeword

    if not Path(fd.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {fd.__file__}, not the checkout at {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else "not read"
    dev = torch.device("cuda")
    ww, _ = build_bench_wakeword(device=dev)
    noise = torch.tensor(np.random.default_rng(0).normal(0, 0.05, (B, 480)).astype(np.float32),
                         device=dev)
    result = {}
    for band in args.w:
        cfg = RustpotterConfig()
        cfg.detector.score_mode = ScoreMode.MAX
        cfg.detector.avg_threshold = 0.2
        cfg.detector.band_size = band
        static, params = build_bundle([("w", ww)], cfg, dev)
        det = BatchedDetector([("w", ww)], cfg, batch_size=B, device=dev)
        step = GraphedStep(make_step(static))
        paths = {
            "make_step": (lambda s, f: step(params, s, f), lambda: init_state(static, B, dev)),
            "batched_chunk": (lambda s, f: det.process_chunk(det.params, s, f),
                              det.init_states),
        }
        for path, (process, make_states) in paths.items():
            states = make_states()
            states, _ = process(states, noise)  # the eager first call and the capture
            torch.cuda.synchronize()
            before = dict(fd.LAUNCHES)
            process(states, noise)
            torch.cuda.synchronize()
            launched = {k: fd.LAUNCHES[k] - before[k] for k in fd.LAUNCHES}
            if launched["fused_dtw_v2"] != 3 or sum(launched.values()) != 3:
                raise AssertionError(f"w={band} {path}: a chunk launched {launched}, not K4 x 3")
            host_ms, device_ms = windows(process, make_states(), noise)
            result[f"{path}_w{band}"] = {"host_ms": host_ms, "graph_device_ms": device_ms}
            print(f"band_probe {root.name} w={band} {path} at B={B}: {host_ms:.4f} ms per chunk "
                  f"host clock, {device_ms:.4f} ms graph device (K4 x 3 per chunk) [{card}]",
                  flush=True)
    print(json.dumps({"root": str(root), "card": card, "B": B, "paths": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
