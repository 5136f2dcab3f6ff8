"""Time the audio front-end kernel (csrc/biquad.cu) of a checkout of the port
at the serving chunk's shape: B = 8192 streams of 480 samples, the gain
window of the bench wakeword (W = 33), the 80-400 Hz band-pass; or with
--mfcc the batched chunk's MFCC front-end.

    python3 rustpotter_tpu_torch/tools/front_probe.py [--root DIR] [--mfcc]   # needs a CUDA card

DIR (default: the checkout that holds this file) is the root of the checkout
whose `rustpotter_tpu_torch.ops.biquad` is timed: a copy of this tree with a
variant of the kernel, or an earlier commit unpacked by `git archive`. Run
it once per checkout, in turns, to compare two designs on one card; it
imports nothing of the checkout that holds it, and times with that
checkout's `utils/profiling` timers. Two runs in turns are comparable only
where those timers are the same: each run prints a digest of their source
(`timers`), which must be equal across the runs compared.
Per form it first holds the kernel bit for bit against the checkout's plain
version on a CPU copy of the inputs, then prints the kernel's device time
(launches back to back replayed from a CUDA graph: `time_cuda_graph`), the
time of a wrapper call (CUDA events around calls back to back, `time_cuda`:
the host's enqueue is in it where it is the longer) and the host time of a
wrapper call (`host_ms_per_call`). The band-pass alone runs through `biquad(coeffs,
state, signal)`, which every checkout since the kernel's port has; the gain
normalizer's forms through `front`, where the checkout has it, with the
window, count, gain and taps written in place as the stream steps write
them. The last line is one JSON object of these numbers.

--mfcc times the batched chunk's MFCC front-end at B = 65536 and 8192 streams
(16 coefficients): from the chunk's samples and the extractor buffer to the
rms, the new buffer and the (3, 16, B) MFCCs in the window's layout. Where the
checkout has csrc/mfcc_front.cu (`frontend.prologue`), that is the prologue,
the windowed-DFT sgemm and the epilogue, each also timed alone, first held
against their plain versions on a CPU copy at B = 8192 (frames and buffer bit
for bit, MFCCs at rtol 1e-5 / atol 1e-4), with ptxas's registers, spill
stores and static shared memory of both kernels (`ptxas_resources`); else the
torch composition the batched chunk ran before them
(rms, pre-emphasis, cat, unfold, mfcc_from_frames, the buffer's copy, the
permute). Device time by CUDA graph as above, the chain's kernels by
torch.profiler, and the byte bound of the kernels' work at 3.35 TB/s.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

B, N, W = 8192, 480, 33
TIMERS = ("time_cuda_graph", "time_cuda", "host_ms_per_call", "device_kernels",
          "ptxas_resources")  # of the checkout's utils/profiling


def timers_digest() -> str:
    """12 hex digits of the sha256 of the source of the checkout's TIMERS
    (those it has)."""
    from rustpotter_tpu_torch.utils import profiling

    src = "".join(inspect.getsource(getattr(profiling, n)) for n in TIMERS
                  if hasattr(profiling, n))
    return hashlib.sha256(src.encode()).hexdigest()[:12]


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


C = 16  # MFCC coefficients of the --mfcc chain: the bench wakeword's
HBM_BYTES_S = 3.35e12


def mfcc_bytes(B: int) -> dict:
    """Bytes the kernels' work reads and writes once: the prologue's samples,
    buffer in and out, packed frames and rms; the epilogue's spectrum and
    MFCCs."""
    pro = B * 4 * (480 + 480 + 3 * 480 + 480 + 1)
    epi = 3 * B * 4 * (480 + C)
    return {"prologue": pro, "epilogue": epi, "both": pro + epi}


def mfcc_main(root: Path, card: str, timers: str) -> int:
    from rustpotter_tpu_torch import _build
    from rustpotter_tpu_torch.ops import frontend
    from rustpotter_tpu_torch.utils.profiling import (
        device_kernels,
        ptxas_resources,
        time_cuda_graph,
    )

    dev = torch.device("cuda")
    kernels = hasattr(frontend, "prologue")
    n = C + 1

    def inputs(B, seed=7):
        rng = np.random.default_rng(seed)
        return [torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32), device=dev)
                for _ in range(2)]

    if kernels:  # held against the plain versions on a CPU copy first
        x, buf = inputs(8192)
        buf_p = buf.cpu()
        frames, _ = frontend.prologue(x, buf, True)
        want, _ = frontend.prologue_plain(x.cpu(), buf_p, True)
        got = frontend.mfcc_from_frames(frames, n, window=True)
        if not (torch.equal(frames.cpu(), want) and torch.equal(buf.cpu(), buf_p)):
            raise AssertionError("mfcc_prologue differs from its plain version")
        torch.testing.assert_close(got.cpu(), frontend.mfcc_from_frames(want, n, window=True),
                                   rtol=1e-5, atol=1e-4)
        print(f"front_probe {root.name}: the prologue is bit-equal to its plain version, the "
              f"epilogue within rtol 1e-5 / atol 1e-4 of its", flush=True)
    result = {}
    for B in (65536, 8192):
        x, buf = inputs(B)
        dft = frontend.device_constants(n, dev).dft
        if kernels:
            def chain():
                frames, rms = frontend.prologue(x, buf, True)
                return frontend.mfcc_from_frames(frames, n, window=True), rms

            frames, _ = frontend.prologue(x, buf.clone(), True)
            spec = torch.matmul(frames, dft)
            parts = {"prologue": lambda: frontend.prologue(x, buf, True),
                     "dft": lambda: torch.matmul(frames, dft),
                     "epilogue": lambda: frontend.epilogue(spec, n, True)}
        else:
            def chain():
                rms = frontend.rms_level(x)
                shifts = frontend.pre_emphasis(x.reshape(B, 3, 160))
                cat = torch.cat([buf, shifts.reshape(B, 480)], dim=1)
                mfcc3 = frontend.mfcc_from_frames(cat.unfold(1, 480, 160)[:, :3], n)
                buf.copy_(cat[:, 480:])  # the chunk's commit
                return mfcc3.permute(1, 2, 0).contiguous(), rms

            frames = torch.empty(B, 3, 480, device=dev)
            parts = {"dft": lambda: torch.matmul(frames, dft)}
        r = {"chain_ms": time_cuda_graph(chain),
             "parts_ms": {k: time_cuda_graph(f) for k, f in parts.items()},
             "chain_kernels": [(round(ms, 4), c, name[:90]) for ms, c, name
                               in device_kernels(chain, 10)],
             "bytes": mfcc_bytes(B)}
        if kernels:
            kern_ms = r["parts_ms"]["prologue"] + r["parts_ms"]["epilogue"]
            r["bound_ms"] = {k: v / HBM_BYTES_S * 1e3 for k, v in r["bytes"].items()}
            r["bound_share"] = {"prologue": r["bound_ms"]["prologue"] / r["parts_ms"]["prologue"],
                                "epilogue": r["bound_ms"]["epilogue"] / r["parts_ms"]["epilogue"],
                                "both": r["bound_ms"]["both"] / kern_ms}
        out = chain()[0]
        r["checksum"] = float(out.double().abs().sum())
        result[B] = r
        print(f"front_probe {root.name} mfcc at B = {B}: chain {r['chain_ms']:.4f} ms, parts "
              f"{ {k: round(v, 4) for k, v in r['parts_ms'].items()} } ms on the device (CUDA "
              f"graph); bound shares {r.get('bound_share')}; {len(r['chain_kernels'])} kernels "
              f"[{card}]", flush=True)
        for row in r["chain_kernels"]:
            print(f"  {row}", flush=True)
    regs = {}
    if kernels:  # the prologue's build, and the epilogue's at n bands
        for defines, kernel in (({}, "mfcc_prologue"), ({"RP_N": n}, "mfcc_epilogue")):
            log = _build.build_log(frontend.SOURCE, defines)
            for flag, bit in (("true", 1), ("false", 0)):  # the template's bool
                regs[f"{kernel}<{flag}>"] = ptxas_resources(log, f"{kernel}ILb{bit}E")
        print(f"front_probe {root.name}: ptxas {regs}", flush=True)
    print(json.dumps({"root": str(root), "card": card, "timers": timers, "mfcc": result,
                      "ptxas": regs}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="root of the checkout whose kernel is timed")
    ap.add_argument("--mfcc", action="store_true",
                    help="time the batched chunk's MFCC front-end instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("front_probe: no CUDA device", file=sys.stderr)
        return 2
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from rustpotter_tpu_torch.audio.filters import band_pass_coefficients
    from rustpotter_tpu_torch.ops import biquad
    from rustpotter_tpu_torch.utils.profiling import host_ms_per_call, time_cuda, time_cuda_graph

    if not Path(biquad.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {biquad.__file__}, not the checkout at {root}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    card = card.strip().splitlines()[0] if card.strip() else "not read"
    timers = timers_digest()
    print(f"front_probe {root.name}: timers {timers}", flush=True)
    if args.mfcc:
        return mfcc_main(root, card, timers)
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
        result[form] = {"graph_ms": time_cuda_graph(fn), "events_ms": time_cuda(fn),
                        "host_us": 1e3 * host_ms_per_call(fn)}
        print(f"front_probe {root.name} {form} at {B} x {N}: "
              f"{result[form]['graph_ms']:.4f} ms on the device (CUDA graph), "
              f"{result[form]['events_ms']:.4f} ms a wrapper call (CUDA events), "
              f"{result[form]['host_us']:.2f} us of host time a call [{card}]", flush=True)
    print(json.dumps({"root": str(root), "card": card, "timers": timers, "forms": result}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
