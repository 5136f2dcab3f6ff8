"""Time the audio front-end kernel (csrc/biquad.cu) of a checkout of the port
at the serving chunk's shape: B = 8192 streams of 480 samples, the gain
window of the bench wakeword (W = 33), the 80-400 Hz band-pass.

    python3 rustpotter_tpu_torch/tools/front_probe.py [--root DIR]   # needs a CUDA card

DIR (default: the checkout that holds this file) is the root of the checkout
whose `rustpotter_tpu_torch.ops.biquad` is timed: a copy of this tree with a
variant of the kernel, or an earlier commit unpacked by `git archive`. Run
it once per checkout, in turns, to compare two designs by the same code on
one card; for that reason it imports nothing of the checkout that holds it.
Per form it first holds the kernel bit for bit against the checkout's plain
version on a CPU copy of the inputs, then prints the kernel's device time
(launches back to back replayed from a CUDA graph), the time of a wrapper
call (CUDA events around calls back to back: the host's enqueue is in it
where it is the longer) and the host time of a wrapper call. The band-pass alone runs through `biquad(coeffs,
state, signal)`, which every checkout since the kernel's port has; the gain
normalizer's forms through `front`, where the checkout has it, with the
window, count, gain and taps written in place as the stream steps write
them. The last line is one JSON object of these numbers.
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

B, N, W = 8192, 480, 33


def graph_ms(fn, samples: int = 20, per: int = 10) -> float:
    """ms per call of fn's device work: `per` calls captured in a CUDA graph,
    the median over `samples` replays timed by CUDA events."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    times = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def events_ms(fn, samples: int = 20, per: int = 10) -> float:
    """ms per call by CUDA events around `per` calls back to back."""
    times = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def host_us(fn, samples: int = 20, per: int = 10) -> float:
    """µs of the host's clock per call, `per` calls back to back unsynchronized."""
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        times.append((time.perf_counter() - t0) * 1e6 / per)
        torch.cuda.synchronize()
    return float(np.median(times))


def inputs(dev, seed: int = 3):
    """One chunk: per stream a level log-uniform in [0.04, 8] gives the
    window's entries and the rms (ref 0.25: gains over the steps 0.1-1.0),
    counts 0 .. W, N(0, 0.3) samples."""
    rng = np.random.default_rng(seed)
    level = np.exp(rng.uniform(np.log(0.04), np.log(8.0), B))
    rms = (level * rng.uniform(0.5, 1.5, B)).astype(np.float32)
    win = (level[:, None] * rng.uniform(0.5, 1.5, (B, W))).astype(np.float32)
    count = rng.integers(0, W + 1, B).astype(np.int32)
    x = rng.normal(0, 0.3, (B, N)).astype(np.float32)
    return [torch.tensor(a, device=dev) for a in (rms, win, count, x)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout whose kernel is timed")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("front_probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from rustpotter_tpu_torch.audio.filters import band_pass_coefficients
    from rustpotter_tpu_torch.ops import biquad

    if not Path(biquad.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {biquad.__file__}, not the checkout at {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else "not read"
    dev = torch.device("cuda")
    coeffs = band_pass_coefficients(16000.0, 80.0, 400.0)
    forms = ("band_pass", "both", "gain") if hasattr(biquad, "front") else ("band_pass",)

    def call(form, rms, win, count, x, taps, ref, **outs):
        """One launch of `form`; on CPU tensors the wrapper runs the plain version."""
        if form == "band_pass":
            return tuple(biquad.biquad(coeffs, taps, x))
        bp = form == "both"
        return tuple(biquad.front(x, biquad.GainIn(rms, ref, 0.1, 1.0, win, count),
                                  coeffs if bp else None, taps if bp else None, **outs))

    card_in = inputs(dev) + [torch.zeros(B, 4, device=dev),
                             torch.tensor(np.float32(0.25), device=dev)]
    for form in forms:
        got = call(form, *(t.clone() for t in card_in))
        want = call(form, *(t.cpu() for t in card_in))
        if not all(k is p is None or torch.equal(k.cpu(), p) for k, p in zip(got, want)):
            raise AssertionError(f"{form}: the kernel differs from its plain version")
    print(f"front_probe {root.name}: the kernel is bit-equal to its plain version in the "
          f"forms {', '.join(forms)}", flush=True)
    rms, win, count, x, taps, ref = card_in
    outs = dict(win_out=win, count_out=count, gain_out=torch.zeros(B, device=dev),
                taps_out=taps)  # the state written in place, as the stream steps do
    runs = {form: (lambda f=form: call(f, *card_in, **({} if f == "band_pass" else outs)))
            for form in forms}
    result = {}
    for form, fn in runs.items():
        result[form] = {"graph_ms": graph_ms(fn), "events_ms": events_ms(fn),
                        "host_us": host_us(fn)}
        print(f"front_probe {root.name} {form} at {B} x {N}: "
              f"{result[form]['graph_ms']:.4f} ms on the device (CUDA graph), "
              f"{result[form]['events_ms']:.4f} ms a wrapper call (CUDA events), "
              f"{result[form]['host_us']:.2f} us of host time a call [{card}]", flush=True)
    print(json.dumps({"root": str(root), "card": card, "forms": result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
