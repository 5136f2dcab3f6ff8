"""The fused band-cost + banded-DTW scorers: K1, K2, K4 and K5.

`fused_dtw_chunk_v4` (K1) scores all 3 MFCC shifts of a 30 ms chunk for every
stream against every template pair: the function of the TPU kernel
`rustpotter_tpu/ops/fused_dtw.py::_kernel_v4` (called through `fused_dtw_chunk_v4`),
in the port's stream-minor layout. `fused_dtw_batch_v3_t` (K2, `_kernel_v3`)
scores one shift's circular window, and `fused_dtw_batch` one linear window
with no gate: variant 2 is K4 (`_kernel_v2`), variant 1 K5 (`_kernel`, the
same function in one row loop); both sit further down. On a CUDA tensor each
wrapper launches its Hopper kernel from csrc/ (built at first use) or raises;
on a CPU tensor it runs its plain version (`*_ref`). They all compute one
function, `_band_sims`, on differently made windows.

K1, per stream and shift s (ns = s+1 new rows visible); K2, K4 and K5 take
steps 2-6 on their one window, K4 and K5 without step 6:
  1. the virtual window is linearized: logical column i is new row
     i-(F-ns) when that index is >= 0, else win[(rot0+ns+1+i) % F];
  2. templates are pre-normalized, T' = T·rsqrt(|T|²), zero rows kept zero;
  3. rwn = rsqrt(|W-m|²) per column, or 0 when the squared norm is 0. The
     two norms are guarded separately — a deliberate divergence from the
     reference's guard on the product of the norms, which only differs when
     both norms are below ~1e-19 (unreachable with log-mel MFCCs);
  4. cost band: 1 - (dot(T'[r-1], W[c]) - dot(T'[r-1], m))·rwn[c] with
     c = r-w+j-1 — the CMN subtraction is algebraic, dot(T', m) is an fp32
     FMA chain;
  5. banded DP: new_j = cost_j + min(prev_{j+1}, prev_j), then strictly left
     to right new_j = min(new_j, cost_j + new_{j-1}); a cell is valid iff
     1 <= r-w+j <= min(n, r+w-1); the similarity is slot w+1 of row n-1
     (the reference's padded [m-1][n] cell, kept on purpose);
  6. gate: each wakeword's avg pair (index D·K+d) runs first; its template
     pairs run only where avg sim <= gate_bounds[d], else they are +inf. The
     gate is decided per stream (the TPU decided per (8, 128) tile).

K1's design (csrc/fused_dtw_v4.cu; its header has the details and the
bound): the three virtual windows are slices of one extended sequence E of
n+2 columns (shift s's logical column i is E[i+s]), and the dot T'[t]·E[k]
does not depend on the CMN mean, so one pass over E serves all 3 shifts:
each column is dotted once with the 2w+2 template rows that any shift's band
holds, while rwn, dotm, the mean correction and the DP stay per shift. Three
threads per (stream, pair), one per shift, share a step of two columns: each
computes a third of the two columns' dots (each T' row loaded once for both)
into a ring in shared memory (2w+2 columns × 2w+2 diagonals × 32 streams,
its indices compile-time), one barrier, then each takes its shift's two DP
steps from the ring. The shift warps stage E's columns and the pair's T'
rows into shared memory a step ahead with cp.async, so the column loop loads
nothing from device memory. Its shared memory grows with C: K1 takes w <= 20
at C <= 8 and w <= 19 at C = 16 (`k1_smem_bytes`; the bundle routes wider
bands to K4).
The step before the barrier is branch-free (clamped indices, predicated
stores), so that its independent FMA chains overlap inside the warp. A block
is 32 streams × 3 shifts of one pair; two launches, the avg pairs then the
gated template pairs, and a block whose gates are all closed does no work.
Given the card's tracing counters (tracing on), each block of the gated
launch adds its open lanes, its lanes, 1 if it works and 1 to them, and its
open lanes and the 1 if it works to its wakeword's two counters
(`k1_gate_counts` is the count from the decisions). At the bench shapes it
executes 4.1233 GFLOP per chunk by the design's count
(`utils.profiling.k1_executed`, not a measurement) of the 3.8724 the
function needs (`k1_work`).

Precision: every product here is true fp32. dotm feeds
cost = 1 - (dot - dotm)·rwn, and on a near-silent window |W - m| ~ 1e-4, so
the absolute error of dotm is amplified ~1e4x into the cosine; a 3-pass bf16
dotm produced false detections on silence in the JAX package, and TF32 is
coarser still (TF32 is switched off at package import).
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple

import torch

from .. import _build
from ..utils import tracing

SOURCE = "fused_dtw_v4.cu"  # K1; K2, K4 and K5 name theirs beside their wrappers
INF = float("inf")

# Launch count of every kernel wrapper in this module: one per launch of the
# kernel, nowhere else (the card tests read it around a call).
LAUNCHES = {"fused_dtw_v4": 0, "fused_dtw_v3": 0, "fused_dtw_v2": 0, "fused_dtw_v1": 0}


def _check_band(band: int) -> None:
    """The DP harvests the similarity at band slot w+1 (the padded [m-1][n]
    cell), which exists inside the 2w-wide band only for w >= 2."""
    if band < 2:
        raise ValueError(
            f"fused DTW kernels require band_size >= 2 (got {band}): the "
            "[m-1][n] similarity cell lies outside a width-2 frontier"
        )


# Shared memory of the kernels' rings, mirroring the .cu constants; a CUDA
# launch whose ring passes the sm_90 opt-in raises ValueError before any build.
LANES, MAX_JOBS = 32, 8  # streams per block; K5's and K4's column form's pairs per block


def k1_smem_bytes(band: int, C: int) -> int:
    """K1's rings (csrc/fused_dtw_v4.cu RING_BYTES): the dot ring of 2w+2
    columns x 2w+2 diagonals x LANES floats, E's two tiles of 2 columns x C
    x LANES floats and the T' ring of 2w+5 rows and NR = ceil((2w+2)/3)
    mirrored rows x C floats."""
    nr = -(-(2 * band + 2) // 3)
    return 4 * ((2 * band + 2) ** 2 * LANES + 2 * 2 * C * LANES + (2 * band + 5 + nr) * C)


def k2_producers(band: int) -> int:
    """K2's producer warps (csrc/fused_dtw_v3.cu Q): 4, and 3 at w = 20,
    where a ring for 4 would pass the opt-in."""
    return 4 if band <= 19 else 3


def k2_smem_bytes(band: int, C: int) -> int:
    """K2's cost ring (csrc/fused_dtw_v3.cu RING_BYTES): 2w + 2Q - 1 rows x
    2w band slots x LANES floats, whatever C."""
    return 4 * (2 * band + 2 * k2_producers(band) - 1) * (2 * band) * LANES


K4_W_MAX = 19  # K4's ring form takes w <= 19, its column form the wider bands
K4_PRODUCERS = 4  # the ring form's producer warps (csrc/fused_dtw_v2.cu Q)
K4_CF_REGS = 214  # the column form's registers for its arrays (CF_REGS)
K4_CF_RS = 5  # the column form's most DP rows per step


def k4_column_plan(band: int, C: int):
    """(streams per block, DP rows per step) of K4's column form
    (csrc/fused_dtw_v2.cu CF_STREAMS, CF_RS), None where its registers allow
    no row (the row form's bands). RS: 5, fewer where 2w + (RS + 3) C would
    pass K4_CF_REGS; 32 streams while a ring of 2w + 2RS - 1 slots for them
    fits the opt-in with 2 rows per step (1 where the registers allow 1),
    fewer rows where it fits no more; else 16. (Floor division differs from
    the .cu's truncation only where a count is negative: no row fits.)"""
    regs = min((K4_CF_REGS - 2 * band) // C - 3, K4_CF_RS)
    fit = {s: (_build.SMEM_OPTIN // (s * 4 * (C + MAX_JOBS)) - 2 * band + 1) // 2
           for s in (32, 16)}
    streams = 32 if fit[32] >= min(regs, 2) else 16
    rows = min(regs, fit[streams])
    return (streams, rows) if rows >= 1 else None


def k4_form(band: int, C: int) -> str:
    """The form K4's build takes at (band, C) (csrc/fused_dtw_v2.cu
    RING_FORM, COLUMN_FORM, chosen from RP_W and RP_C alone): "ring" up to
    K4_W_MAX, the largest band whose shared rings fit the opt-in; "column"
    beyond, while `k4_column_plan` has a plan (w <= 75 at C = 16, 91 at
    C = 8); "row" past that."""
    if band <= K4_W_MAX:
        return "ring"
    return "column" if k4_column_plan(band, C) else "row"


def k4_smem_bytes(band: int, C: int) -> int:
    """K4's shared memory (csrc/fused_dtw_v2.cu SMEM_BYTES): in the ring
    form the cost ring and the dotm ring, 2w + 2Q - 1 rows x (2w + 1) x
    LANES floats, whatever C; in the column form the column ring and the rwn
    ring, 2w + 2RS - 1 slots x (C + MAX_JOBS) floats per stream; none in the
    row form."""
    form = k4_form(band, C)
    if form == "ring":
        return 4 * (2 * band + 2 * K4_PRODUCERS - 1) * (2 * band + 1) * LANES
    if form == "row":
        return 0
    streams, rows = k4_column_plan(band, C)
    return (2 * band + 2 * rows - 1) * 4 * (C + MAX_JOBS) * streams


def k5_rows_per_step(band: int, C: int) -> int:
    """K5's DP rows per step (csrc/fused_dtw_v1.cu RS): 3, but 2 at
    6 <= w <= 12 and w > 28, and fewer where that ring would pass the opt-in."""
    want = 3 if band <= 5 or 13 <= band <= 28 else 2
    for rows in range(want, 1, -1):
        if _k5_ring_bytes(band, C, rows) <= _build.SMEM_OPTIN:
            return rows
    return 1


def _k5_ring_bytes(band: int, C: int, rows: int) -> int:
    return 4 * (2 * band + 2 * rows - 1) * (C + MAX_JOBS) * LANES


def k5_smem_bytes(band: int, C: int) -> int:
    """K5's column ring and rwn ring (csrc/fused_dtw_v1.cu SMEM_BYTES):
    2w + 2RS - 1 slots x (C + MAX_JOBS) x LANES floats."""
    return _k5_ring_bytes(band, C, k5_rows_per_step(band, C))


def _check_smem(name: str, nbytes: int, band: int, C: int) -> None:
    if nbytes > _build.SMEM_OPTIN:
        raise ValueError(
            f"{name} at band_size {band}, C = {C} needs {nbytes} B of shared memory, "
            f"more than the {_build.SMEM_OPTIN} B a block can opt into")


def normalize_templates(templates: torch.Tensor, tnorms: torch.Tensor) -> torch.Tensor:
    """T' = T·rsqrt(|T|²) per row; zero rows stay zero."""
    return templates * torch.where(tnorms == 0.0, 0.0, torch.rsqrt(tnorms))[..., None]


def virtual_windows(win: torch.Tensor, new: torch.Tensor, rot0: torch.Tensor,
                    Lm: int) -> torch.Tensor:
    """(3, Lm, C, B): the first Lm logical columns of each shift's virtual
    window (the pre-chunk circular window with the first s+1 new rows
    written at the slots after rot0)."""
    F = win.shape[0]
    dev = win.device
    i = torch.arange(Lm, device=dev)
    ns = torch.arange(1, 4, device=dev)
    rot_s = (rot0.long() + ns) % F  # (3,)
    phys = (rot_s[:, None] + 1 + i[None, :]) % F  # (3, Lm)
    nj = i[None, :] - (F - ns[:, None])  # (3, Lm) new-row index, valid >= 0
    return torch.where(
        (nj >= 0)[..., None, None], new[nj.clamp(0, 2)], win[phys]
    )


def _check_args(win, new, means3, tp, gate_bounds, lens, band, D, K, rot0):
    """Shapes of K1's arguments; tp is the (P, Lm, C) template set (raw or T')."""
    _check_band(band)
    if win.dim() != 3:
        raise ValueError(f"win must be (F, C, B), got {tuple(win.shape)}")
    F, C, B = win.shape
    P, Lm = tp.shape[0], tp.shape[1]
    want = {
        "new": (new, (3, C, B)),
        "means3": (means3, (3, P, C, B)),
        "templates": (tp, (P, Lm, C)),
        "gate_bounds": (gate_bounds, (D,)),
    }
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if P != D * K + D:
        raise ValueError(f"P={P} pairs but D={D}, K={K} need {D * K + D}")
    if len(lens) != P or not all(1 <= int(n) <= Lm for n in lens):
        raise ValueError(f"lens must be {P} pair lengths in [1, {Lm}], got {lens}")
    if F < Lm or F < 3:
        raise ValueError(f"window length F={F} must be >= max(Lm={Lm}, 3)")
    if rot0.dim() != 0 or rot0.dtype not in (torch.int32, torch.int64):
        raise ValueError("rot0 must be a 0-d integer tensor")


def _check_tnorms(templates: torch.Tensor, tnorms: torch.Tensor) -> None:
    if tuple(tnorms.shape) != tuple(templates.shape[:2]):
        raise ValueError(
            f"tnorms must be {tuple(templates.shape[:2])}, got {tuple(tnorms.shape)}"
        )


class TemplateSet(NamedTuple):
    """The fused kernels' template operand, built once per parameter set by
    `prepare_templates` (it depends on no stream)."""

    tp: torch.Tensor  # (P, Lm, C) T' = T·rsqrt(|T|²), zero rows kept zero
    # T' with `band` zero rows before and after: the kernel reads the rows of
    # every band slot without bounds checks
    padded: torch.Tensor  # (P, band + Lm + band, C)
    lens: tuple  # the P pair lengths
    lens_t: torch.Tensor  # (P,) int32, on tp's device
    band: int


def prepare_templates(templates: torch.Tensor, tnorms: torch.Tensor, lens: tuple,
                      band: int) -> TemplateSet:
    """T' and its padded copy from raw templates (P, Lm, C) and their squared
    row norms tnorms (P, Lm)."""
    _check_band(band)
    _check_tnorms(templates, tnorms)
    tp = normalize_templates(templates, tnorms).contiguous()
    lens = tuple(int(x) for x in lens)
    return TemplateSet(
        tp=tp,
        padded=torch.nn.functional.pad(tp, (0, 0, band, band)).contiguous(),
        lens=lens,
        lens_t=torch.tensor(lens, dtype=torch.int32, device=tp.device),
        band=band,
    )


def fused_dtw_chunk_v4_ref(
    win: torch.Tensor,
    new: torch.Tensor,
    means3: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    gate_bounds: torch.Tensor,
    lens: tuple,
    band: int,
    D: int,
    K: int,
    rot0: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version of K1 (same arguments, any device). Returns
    sims (B, 3, P)."""
    _check_args(win, new, means3, templates, gate_bounds, lens, band, D, K, rot0)
    _check_tnorms(templates, tnorms)
    return _plain(win, new, means3, normalize_templates(templates, tnorms),
                  gate_bounds, lens, band, D, K, rot0)


def _plain(win, new, means3, tp, gate_bounds, lens, band, D, K, rot0):
    """K1's function on T' (P, Lm, C). Returns (B, 3, P). With tracing on it
    adds K1's gate counts to the tracer's host counters, as the kernel adds
    them on the card (`k1_gate_counts`)."""
    lin = virtual_windows(win, new, rot0, tp.shape[1])  # (3, Lm, C, B)
    sims, gate_open = _gated(_band_sims(lin, means3, tp, lens, band), gate_bounds, D, K)
    if tracing.enabled():
        for name, n in zip(tracing.DEVICE_COUNTERS, k1_gate_counts(gate_open, lens[:D * K])):
            tracing.count(name, n)
        for name, n in k1_wakeword_counts(gate_open, lens[:D * K], K).items():
            tracing.count(name, n)
    return sims.permute(2, 0, 1)


def k1_gate_counts(gate_open: torch.Tensor, lens) -> tuple:
    """K1's counts of its gated launch from the gate decisions gate_open
    (3, D·K, B) of the template pairs of lengths `lens`: the lanes (stream,
    shift, pair) whose gate is open, the lanes decided, the blocks that do
    the work (a block is 32 streams x 3 shifts of one pair; it works if a
    lane is open and the pair is 2 rows or longer) and the blocks launched."""
    S, DK, B = gate_open.shape
    nb = -(-B // 32)
    padded = torch.zeros((S, DK, nb * 32), dtype=torch.bool, device=gate_open.device)
    padded[:, :, :B] = gate_open
    works = padded.reshape(S, DK, nb, 32).any(dim=3).any(dim=0)  # (D·K, nb)
    long_enough = torch.tensor([int(n) >= 2 for n in lens], device=gate_open.device)
    return (int(gate_open.sum()), S * DK * B, int((works & long_enough[:, None]).sum()),
            DK * nb)


def k1_wakeword_counts(gate_open: torch.Tensor, lens, K: int) -> dict:
    """K1's open lanes and blocks that work of each wakeword d below
    `tracing.K1_WAKEWORDS` (its K template pairs d·K ... d·K + K - 1), by
    the tracer's names (`tracing.k1_wakeword_names`)."""
    out = {}
    for d in range(min(gate_open.shape[1] // K, tracing.K1_WAKEWORDS)):
        pairs = slice(d * K, (d + 1) * K)
        lanes_open, _, blocks_run, _ = k1_gate_counts(gate_open[:, pairs], lens[pairs])
        out.update(zip(tracing.k1_wakeword_names(d), (lanes_open, blocks_run)))
    return out


def _band_sims(lin, means, tp, lens, band, gate=None):
    """The function every fused kernel computes, on linear windows: lin
    (S, Lm, C, B), CMN means (S, P, C, B) and T' (P, Lm, C) → sims (S, P, B).
    gate = (gate_bounds (D,), D, K) gates each wakeword's template pairs on
    its avg pair (+inf where avg > bound or NaN); None scores every pair.
    Windows, pairs and streams are tensor dimensions; the Python loop runs
    over DP rows only."""
    w, W2 = band, 2 * band
    P, Lm, C = tp.shape
    S, B = lin.shape[0], lin.shape[3]
    dev = lin.device
    diff = lin[:, None] - means[:, :, None]  # (S, P, Lm, C, B)
    wn2 = torch.sum(diff * diff, dim=3)  # (S, P, Lm, B)
    rwn = torch.where(wn2 == 0.0, 0.0, torch.rsqrt(wn2))
    dotm = torch.einsum("plc,spcb->splb", tp, means)  # (S, P, Lm, B)
    n = torch.tensor([int(x) for x in lens], device=dev)  # (P,)
    js = torch.arange(W2, device=dev)
    # the DP frontier as 2w band slots of (S, P, B) each
    inf = torch.full((S, P, B), INF, device=dev)
    prev = [torch.zeros_like(inf) if j == w else inf for j in range(W2)]
    result = inf
    for r in range(1, max(int(x) for x in lens)):
        cdp = r - w + js  # (2w,) DP column of each band slot
        valid = (cdp[None, :] >= 1) & (cdp[None, :] <= n.clamp(max=r + w - 1)[:, None])
        wc = (cdp - 1).clamp(0, Lm - 1)
        dot = torch.einsum("pc,sjcb->spjb", tp[:, r - 1], lin[:, wc])  # (S, P, 2w, B)
        cost = 1.0 - (dot - dotm[:, :, r - 1, None]) * rwn[:, :, wc]
        cost = torch.where(valid[None, :, :, None], cost, INF).unbind(2)
        cur = [cost[j] + torch.minimum(prev[j + 1] if j + 1 < W2 else inf, prev[j])
               for j in range(W2)]
        for j in range(1, W2):
            cur[j] = torch.minimum(cur[j], cost[j] + cur[j - 1])
        result = torch.where((n == r + 1)[None, :, None], cur[w + 1], result)
        prev = cur
    if gate is None:
        return result
    return _gated(result, *gate)[0]


def _gated(result, gate_bounds, D, K):
    """The gate on sims (S, P, B): each wakeword's template pairs are +inf
    where its avg pair's sim is above gate_bounds[d] or NaN. Returns the
    gated sims and the gate decisions (S, D·K, B)."""
    avg = result[:, D * K:]  # (S, D, B)
    gate_open = (avg <= gate_bounds[None, :, None]).repeat_interleave(K, dim=1)
    return torch.cat([torch.where(gate_open, result[:, : D * K], INF), avg], dim=1), gate_open


@lru_cache(maxsize=None)
def _library(C: int, band: int) -> ctypes.CDLL:
    lib = _build.load(SOURCE, {"RP_C": C, "RP_W": band})
    fn = lib.rp_fused_dtw_v4
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    fn.restype = ctypes.c_int
    return lib


def score_chunk(
    win: torch.Tensor,
    new: torch.Tensor,
    means3: torch.Tensor,
    tset: TemplateSet,
    gate_bounds: torch.Tensor,
    D: int,
    K: int,
    rot0: torch.Tensor,
) -> torch.Tensor:
    """K1 on a prepared template set (see `fused_dtw_chunk_v4` for the
    arguments). CPU tensors run the plain version; CUDA tensors launch the
    kernel (a failed build or launch raises). The serving chunk calls this
    with a TemplateSet built once per parameter set. With tracing on, the
    kernel adds its gate counts to the card's counters (`utils/tracing.py`),
    and the plain version to the host's; off, it is given no counter and
    executes no atomic."""
    _check_args(win, new, means3, tset.tp, gate_bounds, tset.lens, tset.band, D, K, rot0)
    if win.device.type == "cpu":
        return _plain(win, new, means3, tset.tp, gate_bounds, tset.lens, tset.band, D, K, rot0)
    if win.device.type != "cuda":
        raise ValueError(f"fused_dtw_chunk_v4: unsupported device {win.device}")
    dev = win.device
    for name, t in (("win", win), ("new", new), ("means3", means3),
                    ("templates", tset.padded), ("gate_bounds", gate_bounds)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
    if rot0.device != dev or tset.lens_t.device != dev:
        raise ValueError(f"rot0 and the template set must be on {dev}")
    F, C, B = win.shape
    _check_smem("K1", k1_smem_bytes(tset.band, C), tset.band, C)
    P, Lm, _ = tset.tp.shape
    rot = rot0.to(torch.int32)  # a no-op for the stream state's int32 cursor
    out = torch.empty((3, P, B), dtype=torch.float32, device=dev)
    lib = _library(C, tset.band)
    counts = tracing.device_counters(dev, D).data_ptr() if tracing.enabled() else None
    with torch.cuda.device(dev):  # a library launches on the current card
        err = lib.rp_fused_dtw_v4(
            win.data_ptr(), new.data_ptr(), means3.data_ptr(), tset.padded.data_ptr(),
            tset.lens_t.data_ptr(), gate_bounds.data_ptr(), rot.data_ptr(),
            out.data_ptr(), counts, torch.cuda.current_stream(dev).cuda_stream,
            min(D, tracing.K1_WAKEWORDS), B, F, Lm, D, K,
        )
    if err != 0:
        raise RuntimeError(f"fused_dtw_v4 kernel launch failed: CUDA error {err}")
    LAUNCHES["fused_dtw_v4"] += 1
    return out.permute(2, 0, 1)


def fused_dtw_chunk_v4(
    win: torch.Tensor,
    new: torch.Tensor,
    means3: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    gate_bounds: torch.Tensor,
    lens: tuple,
    band: int,
    D: int,
    K: int,
    rot0: torch.Tensor,
) -> torch.Tensor:
    """K1. win (F, C, B) = pre-chunk circular window with cursor rot0 (0-d
    integer tensor, read on the device: no host sync); new (3, C, B) = the
    chunk's new MFCC rows; means3 (3, P, C, B) = per-shift CMN means over the
    virtual windows; templates (P, Lm, C) raw, tnorms (P, Lm) their squared
    row norms; gate_bounds (D,) sim-domain avg-gate bounds (+inf = open);
    lens the P pair lengths. Returns sims (B, 3, P).

    CPU tensors run `fused_dtw_chunk_v4_ref`; CUDA tensors prepare T' and
    launch the kernel through `score_chunk`."""
    _check_args(win, new, means3, templates, gate_bounds, lens, band, D, K, rot0)
    if win.device.type == "cpu":
        return fused_dtw_chunk_v4_ref(
            win, new, means3, templates, tnorms, gate_bounds, lens, band, D, K, rot0
        )
    return score_chunk(win, new, means3, prepare_templates(templates, tnorms, lens, band),
                       gate_bounds, D, K, rot0)


# ------------------------------------------------------------------ common

def linear_window(win: torch.Tensor, rot: torch.Tensor, Lm: int) -> torch.Tensor:
    """(Lm, C, B): the first Lm logical columns of the circular window win
    (F, C, B) with cursor rot (0-d integer tensor; logical column i lives at
    physical row (rot + 1 + i) % F). A gather on the device: no host sync."""
    phys = (rot.long() + 1 + torch.arange(Lm, device=win.device)) % win.shape[0]
    return win[phys]


def _launch_operands(dev: torch.device, **tensors) -> None:
    """Kernel operands must be contiguous float32 tensors on `dev`."""
    for name, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")


# ---------------------------------------------------------------------- K2
#
# `fused_dtw_batch_v3_t` scores ONE shift's circular window for every stream
# against every template pair: the function of the TPU kernel
# `rustpotter_tpu/ops/fused_dtw.py::_kernel_v3` (called through
# `fused_dtw_batch_v3_t`). dotm = T'·m is a true-fp32 einsum outside the
# kernel, as in the JAX wrapper. The gate is decided per stream, as K1's.

SOURCE_V3 = "fused_dtw_v3.cu"


def _check_args_v3(win_t, means_t, tp, gate_bounds, lens, band, D, K, rot):
    """Shapes of K2's arguments; tp is the (P, Lm, C) template set."""
    _check_band(band)
    if win_t.dim() != 3:
        raise ValueError(f"win_t must be (F, C, B), got {tuple(win_t.shape)}")
    F, C, B = win_t.shape
    P, Lm = tp.shape[0], tp.shape[1]
    for name, t, shape in (("means_t", means_t, (P, C, B)), ("templates", tp, (P, Lm, C)),
                           ("gate_bounds", gate_bounds, (D,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if P != D * K + D:
        raise ValueError(f"P={P} pairs but D={D}, K={K} need {D * K + D}")
    if len(lens) != P or not all(1 <= int(n) <= Lm for n in lens):
        raise ValueError(f"lens must be {P} pair lengths in [1, {Lm}], got {lens}")
    if F < Lm:
        raise ValueError(f"window length F={F} must be >= Lm={Lm}")
    if rot.dim() != 0 or rot.dtype not in (torch.int32, torch.int64):
        raise ValueError("rot must be a 0-d integer tensor")


def fused_dtw_batch_v3_ref(
    win_t: torch.Tensor,
    means_t: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    gate_bounds: torch.Tensor,
    lens: tuple,
    band: int,
    D: int,
    K: int,
    rot: torch.Tensor,
) -> torch.Tensor:
    """The plain PyTorch version of K2 (same arguments, any device). Returns
    sims (B, P)."""
    _check_args_v3(win_t, means_t, templates, gate_bounds, lens, band, D, K, rot)
    _check_tnorms(templates, tnorms)
    return _plain_v3(win_t, means_t, normalize_templates(templates, tnorms),
                     gate_bounds, lens, band, D, K, rot)


def _plain_v3(win_t, means_t, tp, gate_bounds, lens, band, D, K, rot):
    lin = linear_window(win_t, rot, tp.shape[1])
    return _band_sims(lin[None], means_t[None], tp, lens, band, (gate_bounds, D, K))[0].T


@lru_cache(maxsize=None)
def _library_v3(C: int, band: int) -> ctypes.CDLL:
    lib = _build.load(SOURCE_V3, {"RP_C": C, "RP_W": band})
    fn = lib.rp_fused_dtw_v3
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    return lib


def score_shift(
    win_t: torch.Tensor,
    means_t: torch.Tensor,
    tset: TemplateSet,
    gate_bounds: torch.Tensor,
    D: int,
    K: int,
    rot: torch.Tensor,
) -> torch.Tensor:
    """K2 on a prepared template set (see `fused_dtw_batch_v3_t` for the
    arguments). CPU tensors run the plain version; CUDA tensors compute dotm
    and launch the kernel (a failed build or launch raises). The per-shift
    step calls this with a TemplateSet built once per parameter set."""
    _check_args_v3(win_t, means_t, tset.tp, gate_bounds, tset.lens, tset.band, D, K, rot)
    if win_t.device.type == "cpu":
        return _plain_v3(win_t, means_t, tset.tp, gate_bounds, tset.lens, tset.band, D, K, rot)
    if win_t.device.type != "cuda":
        raise ValueError(f"fused_dtw_batch_v3: unsupported device {win_t.device}")
    # T'[t]·m per (pair, row, stream): true fp32 (TF32 is off), stream-minor
    dotm = torch.einsum("plc,pcb->plb", tset.tp, means_t).contiguous()
    return launch_v3(win_t, means_t, dotm, tset, gate_bounds, D, K, rot)


def launch_v3(
    win_t: torch.Tensor,
    means_t: torch.Tensor,
    dotm: torch.Tensor,
    tset: TemplateSet,
    gate_bounds: torch.Tensor,
    D: int,
    K: int,
    rot: torch.Tensor,
) -> torch.Tensor:
    """The K2 launch alone, on CUDA tensors: `score_shift` with dotm
    (P, Lm, B) = T'·m given. Returns sims (B, P)."""
    dev = win_t.device
    if dev.type != "cuda":
        raise ValueError(f"launch_v3 launches the CUDA kernel: {dev} is not a CUDA device")
    F, C, B = win_t.shape
    P, Lm, _ = tset.tp.shape
    _launch_operands(dev, win_t=win_t, means_t=means_t, dotm=dotm, templates=tset.padded,
                     gate_bounds=gate_bounds)
    if tuple(dotm.shape) != (P, Lm, B):
        raise ValueError(f"dotm must be {(P, Lm, B)}, got {tuple(dotm.shape)}")
    if rot.device != dev or tset.lens_t.device != dev:
        raise ValueError(f"rot and the template set must be on {dev}")
    _check_smem("K2", k2_smem_bytes(tset.band, C), tset.band, C)
    rot32 = rot.to(torch.int32)  # a no-op for the stream state's int32 cursor
    out = torch.empty((P, B), dtype=torch.float32, device=dev)
    lib = _library_v3(C, tset.band)
    with torch.cuda.device(dev):  # a library launches on the current card
        err = lib.rp_fused_dtw_v3(
            win_t.data_ptr(), means_t.data_ptr(), dotm.data_ptr(), tset.padded.data_ptr(),
            tset.lens_t.data_ptr(), gate_bounds.data_ptr(), rot32.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, B, F, Lm, D, K,
        )
    if err != 0:
        raise RuntimeError(f"fused_dtw_v3 kernel launch failed: CUDA error {err}")
    LAUNCHES["fused_dtw_v3"] += 1
    return out.T


def fused_dtw_batch_v3_t(
    win_t: torch.Tensor,
    means_t: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    gate_bounds: torch.Tensor,
    lens: tuple,
    band: int,
    D: int,
    K: int,
    rot: torch.Tensor,
) -> torch.Tensor:
    """K2, stream-minor. win_t (F, C, B) = circular window with cursor rot
    (0-d integer tensor, read on the device: no host sync), F >= Lm;
    means_t (P, C, B) = per-pair CMN means; templates (P, Lm, C) raw, tnorms
    (P, Lm) their squared row norms; gate_bounds (D,) sim-domain avg-gate
    bounds (+inf = open); lens the P pair lengths, templates (D*K) then avg
    pairs (D). Returns sims (B, P).

    CPU tensors run `fused_dtw_batch_v3_ref`; CUDA tensors prepare T' and
    launch the kernel through `score_shift`."""
    _check_args_v3(win_t, means_t, templates, gate_bounds, lens, band, D, K, rot)
    if win_t.device.type == "cpu":
        return fused_dtw_batch_v3_ref(win_t, means_t, templates, tnorms, gate_bounds,
                                      lens, band, D, K, rot)
    return score_shift(win_t, means_t, prepare_templates(templates, tnorms, lens, band),
                       gate_bounds, D, K, rot)


def fused_dtw_batch_v3(
    win: torch.Tensor,
    means: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    gate_bounds: torch.Tensor,
    lens: tuple,
    band: int,
    D: int,
    K: int,
    rot=None,
) -> torch.Tensor:
    """K2 for the (B, F, C) layout: win (B, F, C), means (B, P, C). `rot` is
    the circular cursor; None means the window is linear (oldest first),
    i.e. rot = F - 1. Returns sims (B, P)."""
    if rot is None:
        rot = torch.tensor(win.shape[1] - 1, dtype=torch.int32, device=win.device)
    return fused_dtw_batch_v3_t(
        win.permute(1, 2, 0).contiguous(), means.permute(1, 2, 0).contiguous(),
        templates, tnorms, gate_bounds, lens, band, D, K, torch.as_tensor(rot),
    )


# ------------------------------------------------------------------ K4, K5
#
# `fused_dtw_batch` scores a LINEAR window for every stream against every
# pair, with no gate: variant 2 (K4) is the function of the TPU kernel
# `rustpotter_tpu/ops/fused_dtw.py::_kernel_v2`, variant 1 (K5) that of
# `_kernel` (both called through `fused_dtw_batch`). The two TPU kernels
# compute one function in different loop orders, so K4 and K5 share their
# plain version and their C interface; rwn and dotm are computed in the
# kernel.

# variant: (source, C entry point, launch count key)
_LINEAR = {
    2: ("fused_dtw_v2.cu", "rp_fused_dtw_v2", "fused_dtw_v2"),
    1: ("fused_dtw_v1.cu", "rp_fused_dtw_v1", "fused_dtw_v1"),
}


def _check_args_v2(win_t, means_t, tp, lens, band):
    """Shapes of K4's and K5's stream-minor arguments: win_t (Lm, C, B),
    means_t (P, C, B), tp the (P, Lm, C) template set."""
    _check_band(band)
    if win_t.dim() != 3:
        raise ValueError(f"win must be (Lm, C, B), got {tuple(win_t.shape)}")
    Lm, C, B = win_t.shape
    P = tp.shape[0]
    for name, t, shape in (("means", means_t, (P, C, B)), ("templates", tp, (P, Lm, C))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} (stream-minor), got {tuple(t.shape)}")
    if len(lens) != P or not all(1 <= int(n) <= Lm for n in lens):
        raise ValueError(f"lens must be {P} pair lengths in [1, {Lm}], got {lens}")


def _variant(variant: int) -> None:
    if variant not in _LINEAR:
        raise ValueError(f"fused_dtw_batch: unknown variant {variant} (1 or 2)")


def _stream_minor(win: torch.Tensor, means: torch.Tensor):
    if win.dim() != 3 or means.dim() != 3:
        raise ValueError("win must be (B, Lm, C) and means (B, P, C)")
    return win.permute(1, 2, 0).contiguous(), means.permute(1, 2, 0).contiguous()


def fused_dtw_batch_ref(
    win: torch.Tensor,
    means: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    lens: tuple,
    band: int,
) -> torch.Tensor:
    """The plain PyTorch version of K4 and K5 (any device): win (B, Lm, C),
    means (B, P, C). Returns sims (B, P)."""
    win_t, means_t = _stream_minor(win, means)
    _check_args_v2(win_t, means_t, templates, lens, band)
    _check_tnorms(templates, tnorms)
    return _plain_v2(win_t, means_t, normalize_templates(templates, tnorms), lens, band)


def _plain_v2(win_t, means_t, tp, lens, band):
    return _band_sims(win_t[None], means_t[None], tp, lens, band)[0].T


@lru_cache(maxsize=None)
def _library_linear(variant: int, C: int, band: int) -> ctypes.CDLL:
    source, entry, _ = _LINEAR[variant]
    lib = _build.load(source, {"RP_C": C, "RP_W": band})
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return lib


def score_linear(win_t: torch.Tensor, means_t: torch.Tensor, tset: TemplateSet,
                 variant: int = 2) -> torch.Tensor:
    """K4 (variant 2) or K5 (variant 1) on a prepared template set,
    stream-minor: win_t (Lm, C, B) linear window, means_t (P, C, B). Returns
    sims (B, P). CPU tensors run the plain version; CUDA tensors launch the
    variant's kernel (a failed build or launch raises)."""
    _variant(variant)
    _check_args_v2(win_t, means_t, tset.tp, tset.lens, tset.band)
    if win_t.device.type == "cpu":
        return _plain_v2(win_t, means_t, tset.tp, tset.lens, tset.band)
    if win_t.device.type != "cuda":
        raise ValueError(f"fused_dtw_batch: unsupported device {win_t.device}")
    dev = win_t.device
    _launch_operands(dev, win=win_t, means=means_t, templates=tset.padded)
    if tset.lens_t.device != dev:
        raise ValueError(f"the template set must be on {dev}")
    Lm, C, B = win_t.shape
    if variant == 1:
        _check_smem("K5", k5_smem_bytes(tset.band, C), tset.band, C)
    P = tset.tp.shape[0]
    _, entry, key = _LINEAR[variant]
    out = torch.empty((P, B), dtype=torch.float32, device=dev)
    launch = getattr(_library_linear(variant, C, tset.band), entry)
    with torch.cuda.device(dev):  # a library launches on the current card
        err = launch(
            win_t.data_ptr(), means_t.data_ptr(), tset.padded.data_ptr(), tset.lens_t.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, B, Lm, P,
        )
    if err != 0:
        raise RuntimeError(f"{key} kernel launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    return out.T


def fused_dtw_batch(
    win: torch.Tensor,
    means: torch.Tensor,
    templates: torch.Tensor,
    tnorms: torch.Tensor,
    lens: tuple,
    band: int,
    variant: int = 2,
) -> torch.Tensor:
    """K4 (variant 2) or K5 (variant 1). win (B, Lm, C) = linear window
    (oldest first); means (B, P, C); templates (P, Lm, C) raw, tnorms (P, Lm)
    their squared row norms; lens the P pair lengths. Returns sims (B, P).

    CPU tensors run `fused_dtw_batch_ref` (both variants compute its
    function); CUDA tensors take the window stream-minor, prepare T' and
    launch the variant's kernel through `score_linear`."""
    _variant(variant)
    if win.device.type == "cpu":
        return fused_dtw_batch_ref(win, means, templates, tnorms, lens, band)
    win_t, means_t = _stream_minor(win, means)
    return score_linear(win_t, means_t, prepare_templates(templates, tnorms, lens, band),
                        variant)
