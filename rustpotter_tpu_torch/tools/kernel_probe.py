"""Time one DTW kernel alone at the bench shapes (B, Lm=100, C=16, w=5, P=6),
on the card: the counterpart of the JAX package's tools/kernel_probe.py.

    python -m rustpotter_tpu_torch.tools.kernel_probe [B] [iters] [--v1|--v2|--v4|--k3|--mixed]
        [--gate] [--w=N]

The default is K2 (`fused_dtw_batch_v3`); --v1 is K5 and --v2 K4
(`fused_dtw_batch(variant=1 or 2)`), --v4 is K1 (`fused_dtw_chunk_v4`, all 3
shifts of a chunk), --k3 is K3 (`banded_dtw_kernel` over N = 6B DPs of the
bench pair lengths, L = 100, costs drawn uniform in [0, 2)). --gate sets a
gate bound that no random stream passes (K1 and K2 then score the avg pairs
only; K3 has no gate and refuses it). --mixed is K1 at the `mixed` cell's
shapes (`MIXED`: three wakewords of 8 templates, 100 ... 46 frames, and
their avg pairs, P = 27, in a window of F = 168 frames, C = 16, w = 5; time
it at B = 65536, the cell's fleet). --w=N sets the band (default 5): K4
takes its column form past `fused_dtw.K4_W_MAX` (its row form past w = 75 at
C = 16: `fused_dtw.k4_form`), as the bundle routes a band past K1's and K2's
rings (F1). It prints:
  - the launch alone, its template set and layouts prepared outside it:
    CUDA events, the median of 20 samples of 10 back-to-back launches (K1
    and K2 also with the gate closed);
  - the device kernels of `iters` calls of the whole wrapper by name and
    time (torch.profiler), in place of the JAX tool's perfetto trace;
  - the bound at the card's data-sheet peaks (utils/profiling.py).
The TPU scheduling knobs of the JAX tool (--jch, --dpg, --dik) do not exist
here and are refused. Without a card it exits non-zero: a plain version
never runs in the kernel's place.
"""
from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from ..ops import banded_dtw as bd
from ..ops import fused_dtw as fd
from ..utils import profiling

LM, C, W = 100, 16, 5
LENS = (100, 98, 96, 94, 92, 97)  # one wakeword: 5 templates + its avg pair
VARIANTS = {"--v1": 1, "--v2": 2, "--v4": 4, "--k3": 0}  # 3 (K2) is the default
FLAGS = (*VARIANTS, "--gate", "--mixed")


class Shapes(NamedTuple):
    """K1's pair lengths (templates, then the avg pairs), wakewords D,
    templates per wakeword K and window length F."""

    lens: tuple
    D: int
    K: int
    F: int


BENCH = Shapes(LENS, 1, 5, LM)
# the `mixed` cell's DTW wakewords (portbench/configs/mixed.json): 8 templates
# each of 100-86, 80-66 and 60-46 frames, then their avg pairs
MIXED = Shapes(tuple(range(100, 85, -2)) + tuple(range(80, 65, -2)) + tuple(range(60, 45, -2))
               + (100, 80, 60), 3, 8, 168)


def parse(argv):
    """(B, iters, variant, gate) from the command line (the band: `band`,
    the shapes: `shapes`); ValueError on anything else."""
    args = [a for a in argv if not a.startswith("--")]
    opts = [a for a in argv if a.startswith("--") and not a.startswith("--w=")]
    bad = [o for o in opts if o not in FLAGS]
    chosen = [VARIANTS[o] for o in opts if o in VARIANTS] + [4] * ("--mixed" in opts)
    gate = "--gate" in opts
    if bad or len(args) > 2 or len(chosen) > 1 or (gate and chosen == [0]):
        raise ValueError(f"unknown arguments {bad or args[2:] or opts}: usage [B] [iters] "
                         "[--v1|--v2|--v4|--k3|--mixed] [--gate] (--k3 has no gate)")
    B = int(args[0]) if args else 8192
    iters = int(args[1]) if len(args) > 1 else 20
    return B, iters, chosen[0] if chosen else 3, gate


def band(argv) -> int:
    """The band of --w=N (default W); ValueError unless one integer >= 2."""
    given = [a[len("--w="):] for a in argv if a.startswith("--w=")]
    if len(given) > 1 or (given and not (given[0].isdigit() and int(given[0]) >= 2)):
        raise ValueError(f"bad band {given}: usage --w=N with one integer N >= 2")
    return int(given[0]) if given else W


def shapes(argv) -> Shapes:
    """MIXED with --mixed, else BENCH."""
    return MIXED if "--mixed" in argv else BENCH


def inputs(B: int, variant: int, device, w: int = W, at: Shapes = BENCH) -> dict:
    """The JAX tool's inputs (seed 0, the same draws in the same order; at
    other shapes than BENCH, K1's alone)."""
    rng = np.random.default_rng(0)
    P = len(at.lens)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    if variant == 0:  # K3: the band costs of B streams x P pairs
        return dict(costs=t(rng.uniform(0, 2, (B * P, LM, 2 * w))),
                    lens=torch.tensor(np.tile(np.array(LENS, np.int32), B), device=device))
    x = dict(win=t(rng.normal(0, 1, (B, at.F, C))), means=t(rng.normal(0, 0.2, (B, P, C))),
             templates=t(rng.normal(0, 1, (P, LM, C))))
    x["tnorms"] = torch.sum(x["templates"] * x["templates"], dim=-1)
    if variant == 4:
        x["new"] = t(rng.normal(0, 1, (3, C, B)))
        x["means3"] = t(rng.normal(0, 0.2, (3, P, C, B)))
    return x


def calls(x: dict, variant: int, gate: bool, w: int = W, at: Shapes = BENCH):
    """(the whole wrapper call, the launch alone, what it scores) at band w
    and K1's shapes `at`: two functions of no arguments, and (flops, bytes)
    of the work."""
    if variant == 0:
        k3 = lambda: bd.banded_dtw_kernel(x["costs"], x["lens"], w)
        return k3, k3, profiling.k3_work(x["lens"].cpu().numpy(), w, LM)
    B = x["win"].shape[0]
    lens, D, K, F = at
    P = len(lens)
    dev = x["win"].device
    bounds = torch.full((D,), -1.0 if gate else np.inf, dtype=torch.float32, device=dev)
    tset = fd.prepare_templates(x["templates"], x["tnorms"], lens, w)
    win_t = x["win"].permute(1, 2, 0).contiguous()  # (F, C, B)
    means_t = x["means"].permute(1, 2, 0).contiguous()  # (P, C, B)
    # the pairs scored: with --gate only the avg pairs pass the K1/K2 gate
    scored = lens[D * K:] if gate and variant in (3, 4) else lens
    if variant == 4:
        rot0 = torch.tensor(F - 2, dtype=torch.int32, device=dev)
        whole = lambda: fd.fused_dtw_chunk_v4(win_t, x["new"], x["means3"], x["templates"],
                                              x["tnorms"], bounds, lens, w, D, K, rot0)
        alone = lambda: fd.score_chunk(win_t, x["new"], x["means3"], tset, bounds, D, K, rot0)
        dots, rest = profiling.k1_work(scored, w, C, B)
        return whole, alone, (dots + rest, profiling.k1_bytes(F, C, B, P, LM))
    if variant == 3:
        rot = torch.tensor(LM - 1, dtype=torch.int32, device=dev)  # a linear window
        whole = lambda: fd.fused_dtw_batch_v3(x["win"], x["means"], x["templates"],
                                              x["tnorms"], bounds, LENS, w, D, K)
        dotm = torch.einsum("plc,pcb->plb", tset.tp, means_t).contiguous()
        alone = lambda: fd.launch_v3(win_t, means_t, dotm, tset, bounds, D, K, rot)
        flops = B * sum(profiling.dp_work(n, w, C, False) for n in scored)
        return whole, alone, (flops, profiling.shift_bytes(LM, C, B, P, D))
    whole = lambda: fd.fused_dtw_batch(x["win"], x["means"], x["templates"], x["tnorms"],
                                       LENS, w, variant=variant)
    alone = lambda: fd.score_linear(win_t, means_t, tset, variant=variant)
    flops = B * sum(profiling.dp_work(n, w, C, True) for n in scored)
    return whole, alone, (flops, profiling.linear_bytes(LM, C, B, P))


NAMES = {0: "K3 banded_dtw (6B DPs)", 1: "K5 fused_dtw_v1", 2: "K4 fused_dtw_v2",
         3: "K2 fused_dtw_v3", 4: "K1 fused_dtw_v4 (time = 3 shifts)"}


def measure(B: int, iters: int, variant: int, gate: bool, device, w: int = W,
            at: Shapes = BENCH) -> dict:
    """Time the launch alone (CUDA events) and list the device kernels of
    `iters` whole wrapper calls (torch.profiler), on the card, at band w and
    K1's shapes `at`. A dict of B, variant, gate, w, mixed, ms, bound_ms,
    bound_by, flops, bytes and kernels."""
    x = inputs(B, variant, device, w, at)
    whole, alone, (flops, nbytes) = calls(x, variant, gate, w, at)
    ms = profiling.time_cuda(alone)
    # K1 and K2 have a gate: their gate-closed launch is timed beside
    ms_closed = None
    if variant in (3, 4):
        ms_closed = ms if gate else profiling.time_cuda(calls(x, variant, True, w, at)[1])
    bound_ms, by = profiling.bound(flops, nbytes)
    return dict(B=B, variant=variant, gate=gate, w=w, mixed=at is MIXED, ms=ms,
                ms_gate_closed=ms_closed,
                bound_ms=bound_ms, bound_by=by, flops=flops, bytes=nbytes,
                kernels=profiling.device_kernels(whole, iters))


def report(r: dict) -> list:
    """The lines main prints for a `measure` result."""
    lines = [f"variant={r['variant']} {NAMES[r['variant']]} B={r['B']} w={r.get('w', W)} "
             f"gate={r['gate']}{' at the mixed shapes' if r.get('mixed') else ''}: "
             f"{r['ms'] * 1e3:10.1f} us per launch; bound {r['bound_ms'] * 1e3:.1f} us by "
             f"{r['bound_by']} ({r['flops'] / 1e9:.4f} GFLOP, {r['bytes'] / 1e6:.2f} MB) = "
             f"{r['ms'] / r['bound_ms']:.1f}x"
             + (f"; gate closed {r['ms_gate_closed'] * 1e3:.1f} us per launch"
                if r["ms_gate_closed"] is not None else "")]
    for k_ms, count, name in r["kernels"][:10]:
        lines.append(f"{k_ms * 1e3:10.1f} us/call  {count:4.1f} launches/call  {name[:90]}")
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        B, iters, variant, gate = parse(argv)
        w = band(argv)
    except ValueError as e:
        print(f"kernel_probe: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("kernel_probe: no CUDA device; the kernels run only on the card",
              file=sys.stderr)
        return 2
    for line in report(measure(B, iters, variant, gate, torch.device("cuda"), w,
                               shapes(argv))):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
