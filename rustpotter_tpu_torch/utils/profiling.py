"""Profiling, timing and roofline accounting for the port on an NVIDIA H100.

The counterpart of `rustpotter_tpu.utils.profiling`:
  - `trace(log_dir)`: the port's exporter, a torch.profiler context with
    tracing on that writes a Chrome trace and the tracer's spans and
    counters;
  - `ChipSpec`: the card's data-sheet peaks, and a measured fp32 FMA rate
    (None until `tools/fma_probe.py` has run on the card);
  - `step_roofline(static)`: the JAX package's count of one detector step's
    FLOPs and bytes per stream, and `streams_speed_of_light`;
  - the kernel timing and bound helpers of the tools and the card tests:
    `time_cuda`, `time_cuda_graph`, `host_ms_per_call`, `device_kernels`,
    `profiled_launches` (the port's kernels in a profile, by wrapper), the
    work and byte counts of the fused DTW kernels (`k1_work`, `k1_executed`,
    `k1_bytes`, `dp_work`, `k2_executed`, `k4_executed`,
    `k4_column_executed`, `linear_bytes`, `shift_bytes`) and `bound`;
  - `ptxas_resources` and `resident_warps`: a kernel's registers, spills and
    shared memory from its build log, and the warps per SM they allow;
  - `sass_listing`, `sass_functions`, `sass_loops`, `innermost_loop`,
    `loop_facts` and `immediate_ops`: a built library's SASS, its loops, what
    a loop holds and which instructions take an immediate.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import time
from collections import Counter
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..runtime.bundle import StepStatic
from ..wakewords.files import ModelType
from ..wakewords.nn import layer_sizes
from . import tracing


@contextlib.contextmanager
def trace(log_dir: str):
    """The port's exporter. Traces the enclosed computation and profiles it
    (host, and the card when there is one): tracing (`utils/tracing.py`) is
    reset and turned on for it, and turned off after it unless it was on
    before, so a `GraphedStep` captures again at its first call inside and
    after. Writes log_dir/trace.json, the Chrome trace, which holds the
    program's spans as `user_annotation` events on the card's clock, and
    log_dir/spans.json: the tracer's snapshot (`spans`, `dropped`,
    `counters`) and a copy of the kernel wrappers' `LAUNCHES` under
    `launches`. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from ..ops import banded_dtw, biquad, frontend, fused_dtw

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = tracing.enabled()
    tracing.reset()
    tracing.enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
        snap = tracing.snapshot()
    finally:
        if not was_on:
            tracing.disable()
    snap["launches"] = {m.__name__.rsplit(".", 1)[-1]: dict(m.LAUNCHES)
                        for m in (fused_dtw, banded_dtw, biquad, frontend)}
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(snap, f)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass(frozen=True)
class ChipSpec:
    """Peak rates for roofline bounds.

    fp32_tflops and hbm_gbps are NVIDIA's data-sheet values for the H100 SXM
    (dense, at its 700 W limit): fp32 on the CUDA cores, outside the tensor
    cores, and HBM3 bandwidth. A card set below 700 W runs slower under load.
    fp32_fma_tflops_measured is the fp32 FMA rate that
    `rustpotter_tpu_torch.tools.fma_probe` measures on the card (V1, 32
    independent chains); None until it has run."""

    name: str = "H100 SXM"
    fp32_tflops: float = 67.0  # data sheet
    hbm_gbps: float = 3350.0  # data sheet
    fp32_fma_tflops_measured: Optional[float] = None


H100 = ChipSpec()


@dataclass
class StepCost:
    """FLOPs and bytes of one 30 ms step per stream. gemm_flops are the
    matrix products (the JAX model's MXU work), vector_flops the rest (its
    VPU work). On the H100 both run in fp32 on the CUDA cores: TF32 is off."""

    gemm_flops: float
    vector_flops: float
    hbm_bytes: float

    def seconds_bound(self, chip: ChipSpec = H100) -> float:
        return max(
            (self.gemm_flops + self.vector_flops) / (chip.fp32_tflops * 1e12),
            self.hbm_bytes / (chip.hbm_gbps * 1e9),
        )


def step_roofline(static: StepStatic) -> StepCost:
    """Per-stream cost of one 30 ms step (3 MFCC shifts + 3 detections) on
    the fused per-shift path (circular window, K2), counted as the JAX model
    counts it: the cost band and rwn stay on chip (no HBM charge), CMN means
    and dot(T', m) are matrix products, the window is written one row per
    shift; each NN wakeword adds its MLP's products per shift."""
    C = static.mfcc_size
    nc = C + 1
    F = static.max_mfcc_frames
    L = max(static.lmax, static.la_max)
    w = static.band_size
    pairs = static.n_dtw * static.kmax + static.n_dtw
    shifts = 3

    # MFCC: windowed DFT (480x240 x2) + mel (240 x nc) + DCT (nc x nc)
    gemm = shifts * 2 * (480 * 240 * 2 + 240 * nc + nc * nc)
    # CMN means (pairs x F over C) + dotm (pairs x L over C)
    gemm += shifts * 2 * (pairs * F * C + pairs * L * C)
    # band costs: pairs x L x 2w dot products over C (+ epilogue)
    vec = shifts * pairs * L * 2 * w * (2 * C + 4)
    # rwn: pairs x L columns x ~3C ops
    vec += shifts * pairs * L * 3 * C
    # DP: pairs x L rows x 2w slots x ~6 ops
    vec += shifts * pairs * L * 2 * w * 6
    for meta in static.nn_meta:
        sizes = layer_sizes(ModelType(meta.m_type), meta.train_size * C, C, len(meta.labels))
        gemm += shifts * 2 * sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))
    # window read by the kernel + one-row write + dotm write and read
    hbm = shifts * 4 * (F * C + C + 2 * pairs * L)
    return StepCost(gemm_flops=float(gemm), vector_flops=float(vec), hbm_bytes=float(hbm))


def streams_speed_of_light(static: StepStatic, chip: ChipSpec = H100) -> float:
    """Upper bound on realtime streams per card for this op structure."""
    return 0.03 / step_roofline(static).seconds_bound(chip)


# ------------------------------------------------------------------ timing

def time_cuda(fn, samples: int = 20, per: int = 10, warmup: int = 2) -> float:
    """ms per call: the median over `samples` of the CUDA-event time of `per`
    back-to-back calls, divided by `per` (the host's enqueue of one call
    overlaps the device's run of the one before)."""
    for _ in range(warmup):
        fn()
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


def time_cuda_graph(fn, samples: int = 20, per: int = 10, warmup: int = 2) -> float:
    """ms per call of fn's device work alone: `per` calls captured once in a
    CUDA graph, the median over `samples` replays timed by CUDA events,
    divided by `per`. Unlike `time_cuda`, the host's enqueue is not in it, so
    a kernel shorter than its wrapper's Python is timed, not the wrapper;
    fn must launch on the current stream and read nothing on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per)
    return float(np.median(times))


def host_ms_per_call(fn, samples: int = 20, per: int = 10, warmup: int = 2) -> float:
    """ms of the host's clock per call of fn: `per` calls back to back with
    no synchronization between them, the median over `samples`. Where fn's
    device work is shorter than its host work (a wrapper's Python and its
    launch), this is what a call costs the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(per):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / per)
        torch.cuda.synchronize()
    return float(np.median(times))


def device_kernels(fn, n: int):
    """torch.profiler over `n` calls of fn: [(ms per call, launches per call,
    kernel name)] of the device kernels, longest first. Empty when the
    profiler records no device time. The device-side ranges of the program's
    spans (`record_function` annotations, `utils/tracing.py`) are not
    kernels and are left out."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return sorted(
        ((e.self_device_time_total / n / 1e3, e.count / n, e.key)
         for e in prof.key_averages()
         if "CUDA" in str(e.device_type) and e.self_device_time_total > 0
         and not getattr(e, "is_user_annotation", False)),
        reverse=True,
    )


# the kernel wrappers' launch counts (their `LAUNCHES` keys) by the name of
# the kernel each launches
_WRAPPER_OF = (
    (re.compile(r"\bscore_pairs\b"), "fused_dtw_v4"),
    (re.compile(r"\bscore_pairs_v3\b"), "fused_dtw_v3"),
    (re.compile(r"\bscore_pairs_v2(_cols|_rows)?\b"), "fused_dtw_v2"),
    (re.compile(r"\bscore_pairs_v1\b"), "fused_dtw_v1"),
    (re.compile(r"\bbanded_dp\b"), "banded_dtw"),
    (re.compile(r"\bfront_(bulk|simple)\b"), "biquad"),
    (re.compile(r"\bmfcc_prologue\b"), "mfcc_prologue"),
    (re.compile(r"\bmfcc_epilogue\b"), "mfcc_epilogue"),
)


def _readings(fn, n: int, readings: int):
    """`readings` profiles of n calls of fn: [{kernel name: launches per call}]."""
    return [{name: count for _, count, name in device_kernels(fn, n)}
            for _ in range(readings)]


def profiled_kernels(fn, n: int, readings: int = 3) -> Dict[str, int]:
    """torch.profiler (CUPTI) over n calls of fn, `readings` times: {device
    kernel or copy name: launches per call, the median of the readings (a
    name missing from a reading counts 0 there) rounded to whole launches,
    without the names that round to none}: a profile may drop a record (5
    of the 6 copies of 3 replays read on an H100). Through a CUDA graph's
    replays it names the kernels the graph holds."""
    reads = _readings(fn, n, readings)
    names = sorted(set().union(*reads))
    counts = {k: round(float(np.median([r.get(k, 0.0) for r in reads]))) for k in names}
    return {k: v for k, v in counts.items() if v}


def is_copy(name: str) -> bool:
    """Whether a profiler row is a device-to-device copy: a copy engine's
    (`Memcpy DtoD`), or the kernel that a CUDA graph runs for a small copy
    node (`memcpy32_post` for the 4-byte loss writes of the trainer's graph
    on an H100)."""
    return name.startswith("Memcpy DtoD") or re.fullmatch(r"memcpy\d+_post", name) is not None


def split_copies(kernels: Dict[str, int]) -> Tuple[Dict[str, int], int]:
    """({kernel: launches} without the copies, the copies' launches)."""
    return ({k: v for k, v in kernels.items() if not is_copy(k)},
            sum(v for k, v in kernels.items() if is_copy(k)))


def profiled_launches(fn, n: int, readings: int = 3):
    """torch.profiler (CUPTI) over n calls of fn, `readings` times: ({the
    launches per call of each of the port's kernels the device ran, keyed as
    its wrapper's LAUNCHES (K1's and K2's wrappers launch their kernel twice
    when a chunk holds ungated and gated templates)}, the device kernels and
    copies per call), each the median of the readings (a profile may drop
    records, or take in some that the one before it left; 4 of 5 launches of
    a kernel were read from a replay on an H100), the first rounded to whole
    launches per call and without the kernels that round to none. Through a
    CUDA graph's replays it counts the kernels the graph holds."""
    keyed, totals = [], []
    for rows in _readings(fn, n, readings):
        counts = Counter()
        for name, count in rows.items():
            for pattern, key in _WRAPPER_OF:
                if pattern.search(name):
                    counts[key] += count
        keyed.append(counts)
        totals.append(sum(rows.values()))
    keys = sorted(set().union(*keyed))
    launches = {k: round(float(np.median([c[k] for c in keyed]))) for k in keys}
    return {k: v for k, v in launches.items() if v}, float(np.median(totals))


# ------------------------------------------------- work of the DTW kernels

def k1_work(lens, w, C, B):
    """(FLOPs of the cost-band dots, FLOPs of the rest) that K1 needs with
    the gate open: every stream scores every pair at all 3 shifts. Per
    stream, pair of length n and shift: rwn over n columns (sub + FMA per
    coefficient, one rsqrt), and per DP row r < n the dotm chain (2C), the
    mean correction of every valid band cell (sub, mul, 1 -) and the DP (add
    + min per slot, then the add + min chain). The dot T'[r-1].W[c] does not
    depend on the shift's mean, and shift s+1's column c is shift s's column
    c+1, so the dots of row r count once per distinct window column over the
    3 shifts (2C each)."""
    dots = rest = 0
    for n in lens:
        rest += 3 * n * (3 * C + 1)
        for r in range(1, n):
            cols = [r - w + j for j in range(2 * w) if 1 <= r - w + j <= min(n, r + w - 1)]
            dots += 2 * C * len({c + s for c in cols for s in range(3)})
            rest += 3 * (2 * C + 3 * len(cols) + 2 * (2 * w) + 2 * (2 * w - 1))
    return dots * B, rest * B


def k1_executed(lens, w, C, B):
    """FLOPs that K1's design (csrc/fused_dtw_v4.cu) executes with the gate
    open, counted as `k1_work` counts them. Per stream and pair of length n
    >= 2, each of the 3 shift threads takes ceil((n+w)/2) steps of two
    columns (an odd n+w computes one column past the end), and each step is
    unguarded: two dotm chains (2C each), two rwn (3C+1 each) and 2 NR dots,
    NR = ceil((2w+2)/3) (2C each); and per DP row (n-1 per shift) the mean
    correction of all 2w band slots (the invalid ones are then replaced by
    +inf) and the DP."""
    nr = (2 * w + 2 + 2) // 3
    step = 2 * (2 * C) + 2 * (3 * C + 1) + 2 * nr * 2 * C
    row = 3 * (2 * w) + 2 * (2 * w) + 2 * (2 * w - 1)
    return B * sum(3 * (-(-(n + w) // 2) * step + (n - 1) * row) for n in lens if n >= 2)


def k1_bytes(F, C, B, P, Lm):
    """K1's bytes, each read or written once: window, new rows, means, T'
    and its (P, Lm) row norms, and the sims."""
    return 4 * (F * C * B + 3 * C * B + 3 * P * C * B + P * Lm * C + P * Lm + B * 3 * P)


def dp_work(n, w, C, dotm):
    """FLOPs one (stream, pair) of length n needs in the per-shift kernels:
    rwn over n columns (sub + FMA per coefficient, one rsqrt), and per DP row
    r < n the dot of every valid band cell (2C), its mean correction (sub,
    mul, 1 -) and the DP (add + min per slot, then the add + min chain);
    `dotm` adds the T'[r-1].m chain (2C) per row, which K4 and K5 compute and
    K2 reads from its input."""
    f = n * (3 * C + 1) if n >= 2 else 0
    for r in range(1, n):
        cells = sum(1 for j in range(2 * w) if 1 <= r - w + j <= min(n, r + w - 1))
        f += 2 * C * cells + 3 * cells + 2 * (2 * w) + 2 * (2 * w - 1) + (2 * C if dotm else 0)
    return f


def k2_executed(lens, w, C, B):
    """FLOPs that K2's design (csrc/fused_dtw_v3.cu) executes with the gate
    open, counted as `dp_work` counts them. Per stream and pair of length n
    >= 2, the producer warps take its n+w-2 columns, each with rwn (3C+1)
    and the 2w band costs of the column, unguarded: a dot (2C) and the mean
    correction (sub, mul, 1 -) each, the invalid cells included; and the DP
    warp takes its n-1 DP rows (add + min per slot, then the add + min
    chain)."""
    col = 3 * C + 1 + 2 * w * (2 * C + 3)
    row = 2 * (2 * w) + 2 * (2 * w - 1)
    return B * sum((n + w - 2) * col + (n - 1) * row for n in lens if n >= 2)


def k4_executed(lens, w, C, B):
    """FLOPs that K4's ring form (csrc/fused_dtw_v2.cu, w <= 19) executes,
    counted as `dp_work(..., dotm=True)` counts them. Per stream and pair of
    length n >= 2: the dotm prologue's 2w + Q - 1 rows (2C each); the n+w-2
    column steps of the producer warps, each with one dotm row (2C), rwn
    (3C+1) and the 2w band costs of the column, unguarded (a dot, 2C, and
    the mean correction, 3, each, the invalid cells included); and the DP
    warp's n-1 DP rows (add + min per slot, then the add + min chain)."""
    col = 2 * C + 3 * C + 1 + 2 * w * (2 * C + 3)
    row = 2 * (2 * w) + 2 * (2 * w - 1)
    prologue = (2 * w + 4 - 1) * 2 * C  # Q = 4 producer warps
    return B * sum(prologue + (n + w - 2) * col + (n - 1) * row for n in lens if n >= 2)


def k4_column_executed(lens, w, C, B, rows):
    """FLOPs that K4's column form (csrc/fused_dtw_v2.cu, `rows` = CF_RS DP
    rows per step) executes, counted as `dp_work(..., dotm=True)` counts
    them. A block row takes up to 8 pairs; its loop runs the steps of its
    longest pair, nmax: ceil((nmax - 1) / rows). Every (stream, pair) of
    it makes the rwn (3C + 1) of the 2w + rows - 1 columns of the first span
    and of `rows` new columns per later step; and in each step in which its
    own pair has rows left, the dotm of `rows` rows (2C each) and their 2w
    band cells each, every cell computed (a dot, 2C, the mean correction, 3,
    and the DP: add + min per slot, then the add + min chain), rows past
    n - 1 in the pair's last step included."""
    lens = list(lens)
    jy = min(len(lens), 8)
    cell = 2 * C + 3
    row = 2 * C + 2 * w * cell + 2 * (2 * w) + 2 * (2 * w - 1)
    total = 0
    for g in range(0, len(lens), jy):
        group = lens[g:g + jy]
        nmax = max(group)
        steps = len(range(1, nmax, rows))
        columns = 2 * w + rows - 1 + rows * max(steps - 1, 0)
        for n in group:
            total += columns * (3 * C + 1) + len(range(1, n, rows)) * rows * row
    return B * total


def linear_bytes(Lm, C, B, P):
    """K4's and K5's bytes: linear window, means, T', lengths, sims."""
    return 4 * (Lm * C * B + P * C * B + P * Lm * C + P + P * B)


def shift_bytes(Lm, C, B, P, D):
    """K2's bytes: the Lm window rows read, means, dotm, T', lengths, gate
    bounds, sims."""
    return 4 * (Lm * C * B + P * C * B + P * Lm * B + P * Lm * C + P + D + P * B)


def k3_work(lens, w, L):
    """(FLOPs, bytes) of K3 over DPs of these lengths: each DP needs rows 1
    .. min(n-1, L), each row the DP's add + min per slot and the add + min
    chain, and reads that row's 2w costs; plus the lengths read and the sims
    written."""
    rows = int(np.minimum(np.asarray(lens, np.int64) - 1, L).clip(min=0).sum())
    flops = rows * (2 * (2 * w) + 2 * (2 * w - 1))
    return flops, 4 * (rows * 2 * w + 2 * len(lens))


def bound(flops, nbytes, chip: ChipSpec = H100):
    """(bound ms, what bounds it: "operations" or "bytes") at the chip's
    data-sheet peaks."""
    t_ops = flops / (chip.fp32_tflops * 1e12) * 1e3
    t_bytes = nbytes / (chip.hbm_gbps * 1e9) * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------- compiled resources

# An sm_90 SM's limits (CUDA C++ Programming Guide, compute capability 9.0):
# 64K 32-bit registers, allocated per warp in units of 256; 64 resident warps
# and 32 resident blocks; 228 KB of shared memory, of which the runtime
# reserves 1 KB per block.
SM90_REGISTERS, SM90_REG_UNIT, SM90_WARPS, SM90_BLOCKS = 65536, 256, 64, 32
SM90_SMEM, SM90_SMEM_PER_BLOCK = 228 * 1024, 1024


def ptxas_resources(log: str, kernel: Optional[str] = None) -> dict:
    """Registers per thread, spill-store bytes per thread and static shared
    bytes per block of one kernel in an `nvcc -Xptxas -v` build log: the
    log's one kernel, or the entry function whose mangled name holds
    `kernel` (e.g. "probe_dynloadILi8E")."""
    if kernel is not None:
        parts = [part for part in log.split("Compiling entry function")[1:]
                 if kernel in part.split("\n", 1)[0]]
        if len(parts) != 1:
            raise ValueError(f"expected one entry function named like {kernel!r}, "
                             f"found {len(parts)}")
        log = parts[0]
    regs = re.findall(r"Used (\d+) registers", log)
    spills = re.findall(r"(\d+) bytes spill stores", log)
    if len(regs) != 1 or len(spills) != 1:
        raise ValueError(f"expected one kernel's ptxas report, found {len(regs)}")
    smem = re.search(r"(\d+) bytes smem", log)
    return {"registers": int(regs[0]), "spill_bytes": int(spills[0]),
            "static_smem": int(smem.group(1)) if smem else 0}


def resident_warps(registers: int, threads: int, smem_bytes: int) -> int:
    """Warps per sm_90 SM of blocks of `threads` threads that take
    `registers` registers per thread and `smem_bytes` of shared memory."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // SM90_REG_UNIT) * SM90_REG_UNIT
    blocks = min(SM90_REGISTERS // per_warp // warps, SM90_WARPS // warps, SM90_BLOCKS,
                 SM90_SMEM // (smem_bytes + SM90_SMEM_PER_BLOCK))
    return blocks * warps


# ------------------------------------------------------------------- SASS

# /*addr*/ [@predicate] OPCODE[.modifiers] operands ;
SASS_INSN = re.compile(r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P\w+\s+)?([A-Z0-9]+)(\S*)\s*([^;]*);")
_BLOCK_ENDS = ("BRA", "BRX", "EXIT", "RET", "JMP")


def sass_listing(library, nvcc: str) -> str:
    """`cuobjdump -sass` of a built library, with the cuobjdump beside `nvcc`."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True,
                          check=True).stdout


def sass_functions(sass: str) -> dict:
    """{mangled function name: [(address, opcode, modifiers, operands,
    predicated)]} of a `cuobjdump -sass` listing."""
    out, current = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            current = out.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        m = SASS_INSN.match(line)
        if current is not None and m:
            current.append((int(m.group(1), 16), m.group(3), m.group(4), m.group(5).strip(),
                            m.group(2) is not None))
    return out


def _target(operands: str) -> Optional[int]:
    m = re.fullmatch(r"(?:`\()?0x([0-9a-f]+)\)?", operands)
    return int(m.group(1), 16) if m else None


def sass_loops(insns) -> list:
    """Every loop of a function's instructions: the (first, last) addresses
    from a backward branch's target to the branch."""
    return [(t, addr) for addr, op, _, operands, _ in insns
            if op == "BRA" and (t := _target(operands)) is not None and t < addr]


def innermost_loop(insns, holds) -> tuple:
    """The innermost loop that holds an instruction whose opcode is in
    `holds`; raises unless there is exactly one."""
    loops = [(lo, hi) for lo, hi in sass_loops(insns)
             if any(lo <= a <= hi and op in holds for a, op, *_ in insns)]
    inner = [(lo, hi) for lo, hi in loops
             if not any(lo <= lo2 and hi2 <= hi and (lo2, hi2) != (lo, hi) for lo2, hi2 in loops)]
    if len(inner) != 1:
        raise ValueError(f"{len(inner)} innermost loops holding {'/'.join(holds)}, expected 1")
    return inner[0]


def immediate_ops(insns, value: str) -> Counter:
    """The instructions that take the immediate `value` as an operand, by
    opcode (e.g. value "1": the FFMAs and FADDs of a 1 - x * y)."""
    pattern = re.compile(rf"(^|, )-?{re.escape(value)}(,|$)")
    return Counter(op for _, op, _, operands, _ in insns if pattern.search(operands))


def loop_facts(insns, lo: int, hi: int) -> dict:
    """What the span lo ... hi of a function holds: its instructions, their
    opcodes (`ops`; `full_ops` with their modifiers, e.g. LDS.128, IMAD.HI),
    its conditional branches and its basic blocks (a block starts at lo, at
    a branch target inside the span and after a branch or exit)."""
    span = [i for i in insns if lo <= i[0] <= hi]
    leaders = {lo}
    for k, (addr, op, _, operands, _) in enumerate(span):
        if op in _BLOCK_ENDS:
            t = _target(operands)
            if t is not None and lo <= t <= hi:
                leaders.add(t)
            if k + 1 < len(span):
                leaders.add(span[k + 1][0])
    return {"insns": len(span), "ops": Counter(op for _, op, *_ in span),
            "full_ops": Counter(op + mods for _, op, mods, *_ in span),
            "conditional_branches": sum(op == "BRA" and pred for _, op, _, _, pred in span),
            "basic_blocks": len(leaders)}
