"""Microbenchmark the fp32 primitives the DTW kernels are built from, on the
card: V1-V6, the counterparts of the TPU probe kernels in tools/vpu_probe.py.

    python -m rustpotter_tpu_torch.tools.fma_probe    # needs a CUDA card

For each probe it prints the kernel's time (CUDA events), its FMA steps per
µs over the whole grid and its TFLOP/s, counting 2 FLOPs per step only where
the compiled rep loop's steps are FFMAs (read from the library's SASS with
cuobjdump), and 1 where they are FADDs. V1 with 32 independent chains gives
the card's measured fp32 FMA rate (`ChipSpec.fp32_fma_tflops_measured`),
printed beside the data-sheet peak; it is the measured denominator of the
DTW kernels' rooflines.

`probe` is the wrapper of the CUDA kernels in csrc/fma_probe.cu: on a CPU
tensor it runs the probe's plain version, on a CUDA tensor it launches the
kernel (a failed build or launch raises). `plain` holds the plain versions:
the TPU kernels' loops in torch, with the additions in the same order. V5
(sload) takes one warp per tile, SLOAD_LANES lanes per thread; the others
one lane per thread.
"""
from __future__ import annotations

import ctypes
import dataclasses
import sys
from collections import Counter
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..utils import profiling

SOURCE = "fma_probe.cu"
# probe name: (kernel index in csrc/fma_probe.cu, the TPU kernel it replaces)
KERNELS = {
    "fma": (0, "tools/vpu_probe.py:35"),
    "fma_dep": (1, "tools/vpu_probe.py:46"),
    "dynload": (2, "tools/vpu_probe.py:59"),
    "dynload_cheap": (3, "tools/vpu_probe.py:74"),
    "sload": (4, "tools/vpu_probe.py:89"),
    "smemload": (5, "tools/vpu_probe.py:106"),
}
REPS = 2000  # steps of the rep loop per run (tools/vpu_probe.py's REPS)
STREAMS = 8  # chains, or steps per rep (its STREAMS)
ROWS = 64  # rows of x (its n_in)
TILE = (8, 128)
TILES_PER_SM = 16  # the grid: 16 tiles of 1024 lanes per SM, many waves
# V5's grid (csrc/fma_probe.cu's SLOAD_LANES and SLOAD_BLOCK): thread t of
# block g takes lanes t + SLOAD_BLOCK * j (j < SLOAD_LANES) of tile g
SLOAD_LANES = 32
SLOAD_BLOCK = TILE[0] * TILE[1] // SLOAD_LANES
# V5 and V6 against their plain versions, by (reps, S): the kernels fuse into
# one FMA the product s*x that the plain version rounds first, so they differ
# by a few rounding steps. Largest max|d|/|plain| on an NVIDIA H100 80GB HBM3
# (700 W; the inputs are fixed, so it repeats): 3.717e-7 at reps 13-33,
# 1.947e-6 at reps 2000 and S = 8, 4.504e-6 at S = 32. Each rtol is about
# twice the largest, far under the worst case of 2*reps*S*2^-24 (1.9e-3 at
# reps 2000, S = 8) for sums of terms of one sign.
PROBE_RTOL = {**{(reps, S): 1e-6 for reps in (13, 16, 31, 33) for S in (8, 32)},
              (2000, 8): 4e-6, (2000, 32): 1e-5}
# the runs of tools/vpu_probe.py's __main__: (label, probe, S)
RUNS = (
    ("fma", "fma", 8),
    ("fma32", "fma", 32),
    ("fma_dep", "fma_dep", 8),
    ("dynload", "dynload", 8),
    ("dynload_ch", "dynload_cheap", 8),
    ("sload", "sload", 8),
    ("smemload", "smemload", 8),
)

# Launch count of every probe kernel: one per launch, nowhere else
# (the card tests read it around a call).
LAUNCHES = {name: 0 for name in KERNELS}


def inputs(device) -> tuple:
    """x (64, 8, 128) and s (32, 16), as tools/vpu_probe.py makes them."""
    x = np.random.default_rng(0).normal(0, 1, (ROWS, *TILE)).astype(np.float32)
    s = np.arange(32 * 16, dtype=np.float32).reshape(32, 16)
    return torch.tensor(x, device=device), torch.tensor(s, device=device)


def plain(name: str, x: torch.Tensor, s: torch.Tensor, reps: int, streams: int) -> torch.Tensor:
    """The plain version of probe `name`: (1, 8, 128), on x's device."""
    if name == "fma":
        accs = [x[i] * (1.0 + i) for i in range(streams)]
        step = 0.5 * x[streams]  # exact, as every 0.5 * tile below
        for _ in range(reps):
            accs = [a + step for a in accs]
        return sum(accs)[None]
    if name == "fma_dep":
        acc, step = x[0], 0.5 * x[1]
        for _ in range(reps * streams):
            acc = acc + step
        return acc[None]
    acc = x[0] * 0.0
    if name in ("dynload", "dynload_cheap"):
        for r in range(reps):
            for i in range(streams):
                idx = (r * streams + i) % x.shape[0] if name == "dynload" else (r & 31) + i
                acc = acc + 0.5 * x[idx]
        return acc[None]
    if name in ("sload", "smemload"):
        sv, wt = s.tolist(), x[1]
        for r in range(reps):
            for i in range(streams):
                acc = acc + sv[r & 31][i % 16] * wt
        return acc[None]
    raise ValueError(f"unknown probe {name!r}")


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, {})
    fn = lib.rp_fma_probe
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float]
    fn.restype = ctypes.c_int
    return lib


def probe(name: str, x: torch.Tensor, s: torch.Tensor, reps: int, streams: int,
          tiles: int) -> torch.Tensor:
    """Probe `name` on `tiles` tiles: (tiles, 8, 128), each tile the TPU
    kernel's output for x. CPU tensors run the plain version; CUDA tensors
    launch the kernel (a failed build or launch raises); V6 first copies s
    into the library's constant bank on the same stream, as the TPU kernel
    has s copied into its scalar memory."""
    if name not in KERNELS:
        raise ValueError(f"unknown probe {name!r}: one of {sorted(KERNELS)}")
    if tuple(x.shape) != (ROWS, *TILE) or tuple(s.shape) != (32, 16):
        raise ValueError(f"x must be {(ROWS, *TILE)} and s (32, 16)")
    if streams not in (8, 32):
        raise ValueError(f"streams must be 8 or 32, got {streams}")
    if x.device.type == "cpu":
        return plain(name, x, s, reps, streams).expand(tiles, *TILE)
    if x.device.type != "cuda":
        raise ValueError(f"fma_probe: unsupported device {x.device}")
    dev = x.device
    for nm, t in (("x", x), ("s", s)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{nm} must be a contiguous float32 tensor on {dev}")
    out = torch.empty((tiles, *TILE), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().rp_fma_probe(KERNELS[name][0], streams, x.data_ptr(), s.data_ptr(),
                                  out.data_ptr(), stream, tiles, reps, ROWS, 0.5)
    if err != 0:
        raise RuntimeError(f"fma_probe {name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def default_tiles(device) -> int:
    return TILES_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def sass_listing() -> str:
    """`cuobjdump -sass` of the built probe library."""
    return profiling.sass_listing(_build.build(SOURCE, {}), _build.nvcc())


def sass_opcodes() -> dict:
    """{(probe, S): Counter of FFMA / FADD / FMUL} in the rep loop of each
    compiled kernel, from `cuobjdump -sass` of the built library."""
    return loop_opcodes(sass_listing())


FP_OPS = ("FFMA", "FADD", "FMUL")


def _probe_key(function: str):
    """(probe, S) of a probe kernel's mangled name, or None."""
    for name in KERNELS:
        ident = f"probe_{name}"
        for S in (8, 32):
            # the mangled name: length-prefixed identifier, then <S>
            if f"{len(ident)}{ident}ILi{S}E" in function:
                return name, S
    return None


def rep_loop_facts(sass: str) -> dict:
    """`profiling.loop_facts` of the rep loop of each probe kernel in a
    `cuobjdump -sass` listing, keyed (probe, S). A loop is the span from a
    backward branch's target to the branch; the rep loop is the innermost
    loop that holds floating-point work. Instructions before or after it
    (the chains' set-up, the final sum) do not count. Raises unless each
    kernel has exactly one such loop."""
    out = {}
    for function, insns in profiling.sass_functions(sass).items():
        key = _probe_key(function)
        if key is None:
            continue
        try:
            lo, hi = profiling.innermost_loop(insns, FP_OPS)
        except ValueError as e:
            raise ValueError(f"probe {key}: {e} (floating-point work) in the SASS") from None
        out[key] = profiling.loop_facts(insns, lo, hi)
    return out


def rep_loops(sass: str) -> dict:
    """Every opcode in the rep loop of each probe kernel (`rep_loop_facts`),
    as a Counter keyed (probe, S)."""
    return {key: facts["ops"] for key, facts in rep_loop_facts(sass).items()}


def sload_ffma_per_load(streams: int) -> int:
    """FFMAs per shared load in V5's rep loop: a rep reads its row's
    min(S, 16) values of s as LDS.128 and feeds each value to the thread's
    SLOAD_LANES chains at every one of the S steps that use it."""
    return SLOAD_LANES * streams // (min(streams, 16) // 4)


def loop_opcodes(sass: str) -> dict:
    """The FFMA, FADD and FMUL instructions of each probe kernel's rep loop
    (`rep_loops`), keyed (probe, S)."""
    return {key: Counter({o: ops[o] for o in FP_OPS if ops[o]})
            for key, ops in rep_loops(sass).items()}


def flops_per_step(opcodes: Counter, streams: int) -> int:
    """FLOPs per step from the rep loop's opcodes: 2 where its steps are
    FFMAs alone, 1 where they are FADDs alone, each a whole multiple of S (an
    unrolled loop holds several reps). Raises on any other mix."""
    for op, flops in (("FFMA", 2), ("FADD", 1)):
        n = opcodes[op]
        if n and n % streams == 0 and sum(opcodes[o] for o in FP_OPS) == n:
            return flops
    raise ValueError(f"the rep loop of S={streams} steps holds {dict(opcodes)}: "
                     "neither FFMAs alone nor FADDs alone, in multiples of S")


def measure(device, reps: int = REPS, tiles: int | None = None):
    """Time every run of RUNS on the card. Returns (rows, ChipSpec with the
    measured fp32 FMA rate of V1 at 32 chains); a row is a dict of label,
    probe, S, ms, steps per µs, FLOPs per step, TFLOP/s, flops, bytes and
    the rep loop's SASS opcode counts."""
    x, s = inputs(device)
    tiles = tiles or default_tiles(device)
    sass = sass_opcodes()
    rows = []
    for label, name, S in RUNS:
        ms = profiling.time_cuda(lambda: probe(name, x, s, reps, S, tiles), samples=5, per=3,
                                 warmup=1)
        steps = tiles * TILE[0] * TILE[1] * reps * S
        ops = sass[(name, S)]
        fps = flops_per_step(ops, S)
        rows.append(dict(label=label, probe=name, S=S, ms=ms, steps_per_us=steps / (ms * 1e3),
                         flops_per_step=fps, tflops=steps * fps / (ms * 1e-3) / 1e12,
                         flops=steps * fps, bytes=4 * (x.numel() + s.numel() + tiles * 1024),
                         sass=dict(ops)))
    rate = next(r["tflops"] for r in rows if r["label"] == "fma32")
    return rows, dataclasses.replace(profiling.H100, fp32_fma_tflops_measured=rate)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        print(f"fma_probe: takes no arguments, got {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fma_probe: no CUDA device; the probes run only on the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    rows, chip = measure(dev)
    for r in rows:
        print(f"{r['label']:10s} {r['ms'] * 1e3:10.1f} us/call  {r['steps_per_us']:12.1f} "
              f"steps/us  {r['flops_per_step']} FLOP/step  {r['tflops']:7.3f} TFLOP/s  "
              f"SASS {r['sass']}", flush=True)
    print(f"measured fp32 FMA rate {chip.fp32_fma_tflops_measured:.3f} TFLOP/s (fma32), "
          f"data-sheet peak {chip.fp32_tflops:.0f} TFLOP/s ({chip.name}); "
          f"{torch.cuda.get_device_name(dev)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
