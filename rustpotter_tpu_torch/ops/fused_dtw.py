"""K1: the whole-chunk fused band-cost + banded-DTW scorer.

`fused_dtw_chunk_v4` scores all 3 MFCC shifts of a 30 ms chunk for every
stream against every template pair: the function of the TPU kernel
`rustpotter_tpu/ops/fused_dtw.py::_kernel_v4` (called through `fused_dtw_chunk_v4`),
in the port's stream-minor layout. On a CUDA tensor it launches the Hopper
kernel in csrc/fused_dtw_v4.cu (built at first use) or raises; on a CPU
tensor it runs the plain version `fused_dtw_chunk_v4_ref`.

Per stream and shift s (ns = s+1 new rows visible):
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

SOURCE = "fused_dtw_v4.cu"
INF = float("inf")

# Launch count of every kernel wrapper in this module: one per launch of the
# kernel, nowhere else (chip_smoke.py resets and reads it).
LAUNCHES = {"fused_dtw_v4": 0}


def _check_band(band: int) -> None:
    """The DP harvests the similarity at band slot w+1 (the padded [m-1][n]
    cell), which exists inside the 2w-wide band only for w >= 2."""
    if band < 2:
        raise ValueError(
            f"fused DTW kernels require band_size >= 2 (got {band}): the "
            "[m-1][n] similarity cell lies outside a width-2 frontier"
        )


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
    """K1's template operand, built once per parameter set by
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
    """K1's function on T' (P, Lm, C): shifts, pairs and streams are tensor
    dimensions, and the Python loop runs over DP rows only."""
    w, W2 = band, 2 * band
    P, Lm, C = tp.shape
    B = win.shape[2]
    dev = win.device
    lin = virtual_windows(win, new, rot0, Lm)  # (3, Lm, C, B)
    diff = lin[:, None] - means3[:, :, None]  # (3, P, Lm, C, B)
    wn2 = torch.sum(diff * diff, dim=3)  # (3, P, Lm, B)
    rwn = torch.where(wn2 == 0.0, 0.0, torch.rsqrt(wn2))
    dotm = torch.einsum("plc,spcb->splb", tp, means3)  # (3, P, Lm, B)
    n = torch.tensor([int(x) for x in lens], device=dev)  # (P,)
    js = torch.arange(W2, device=dev)
    prev = torch.full((3, P, W2, B), INF, device=dev)
    prev[:, :, w] = 0.0
    result = torch.full((3, P, B), INF, device=dev)
    inf_col = torch.full((3, P, 1, B), INF, device=dev)
    for r in range(1, max(int(x) for x in lens)):
        cdp = r - w + js  # (2w,) DP column of each band slot
        valid = (cdp[None, :] >= 1) & (cdp[None, :] <= n.clamp(max=r + w - 1)[:, None])
        wc = (cdp - 1).clamp(0, Lm - 1)
        dot = torch.einsum("pc,sjcb->spjb", tp[:, r - 1], lin[:, wc])  # (3, P, 2w, B)
        cost = 1.0 - (dot - dotm[:, :, r - 1, None]) * rwn[:, :, wc]
        cost = torch.where(valid[None, :, :, None], cost, INF)
        ins = torch.cat([prev[:, :, 1:], inf_col], dim=2)
        cur = cost + torch.minimum(ins, prev)
        for j in range(1, W2):
            cur[:, :, j] = torch.minimum(cur[:, :, j], cost[:, :, j] + cur[:, :, j - 1])
        result = torch.where((n == r + 1)[None, :, None], cur[:, :, w + 1], result)
        prev = cur
    avg = result[:, D * K:]  # (3, D, B)
    gate_open = (avg <= gate_bounds[None, :, None]).repeat_interleave(K, dim=1)
    out = torch.cat([torch.where(gate_open, result[:, : D * K], INF), avg], dim=1)
    return out.permute(2, 0, 1)


@lru_cache(maxsize=None)
def _library(C: int, band: int) -> ctypes.CDLL:
    lib = _build.load(SOURCE, {"RP_C": C, "RP_W": band})
    fn = lib.rp_fused_dtw_v4
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
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
    with a TemplateSet built once per parameter set."""
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
    P, Lm, _ = tset.tp.shape
    rot = rot0.to(torch.int32)  # a no-op for the stream state's int32 cursor
    out = torch.empty((3, P, B), dtype=torch.float32, device=dev)
    lib = _library(C, tset.band)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.rp_fused_dtw_v4(
        win.data_ptr(), new.data_ptr(), means3.data_ptr(), tset.padded.data_ptr(),
        tset.lens_t.data_ptr(), gate_bounds.data_ptr(), rot.data_ptr(),
        out.data_ptr(), stream, B, F, Lm, D, K,
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
