"""The audio front-end's filters over a batch of streams: the gain normalizer,
then the band-pass biquad, in one kernel launch per chunk.

`front` is the function of the JAX package's `prepare_chunk` between the rms
and the pre-emphasis (`rustpotter_tpu/runtime/stream_step.py`): the gain
normalizer (a rolling window of the chunk rms values, its mean over the
entries in use, the gain rounded to a 0.1 step and clamped, the samples
scaled and clipped to [-1, 1]) and the band-pass (an order-2 IIR in direct
form I, taps [x1, x2, y1, y2] carried from chunk to chunk; a `lax.scan`
there, `audio/filters.py` `band_pass_step`). Neither is a Pallas kernel. In
PyTorch they are ~60 small launches (the gain) and a loop of ~10 elementwise
launches per sample (~4,800 per chunk: the biquad), so on a CUDA tensor
`front` launches the hand-written kernel of csrc/biquad.cu once, in one of
three forms (gain and band-pass, gain only, band-pass only), built at first
use, or raises; on a CPU tensor it runs the plain version, `front_plain`.
`biquad` is the band-pass-only form.

The two agree bit for bit:
- the window is summed in index order, oldest first, zeros included, as the
  reference's queue and the host oracle sum it (a fixed order of fp32 adds:
  a reduction would differ by a last bit, and `floor(x·10 + 0.5)` turns that
  into a 0.1 step);
- the gain is floor(ref / sqrt(mean) · 10 + 0.5) · GAIN_STEP, each step
  rounded to fp32;
- the biquad evaluates y = a0·x + a1·x1 + a2·x2 − b1·y1 − b2·y2 left to right
  with every product and sum rounded to fp32 (the kernel through __fmul_rn,
  __fadd_rn and __fsub_rn, which the compiler never contracts into an FMA),
  so the plain version also equals the host oracle `audio.filters.BandPassFilter`.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import _build

SOURCE = "biquad.cu"

# The gain's step. The JAX package writes floor(g·10 + 0.5) / 10.0, and XLA
# compiles the division by a constant into a product with fl32(0.1), which
# rounds differently from a division for 399 of k = 0..2000 (k = 9 first:
# 0.90000004, not 0.9). The port multiplies by that fp32 value on every
# device: a Python float holding it exactly, so torch's CPU and CUDA
# products and the kernel's __fmul_rn give the same bits. The host classes
# (`audio.filters.GainNormalizerFilter`, as JAX's) divide.
GAIN_STEP = float(np.float32(1) / np.float32(10))

# Launch count of the kernel wrapper: one per launch, nowhere else
# (the card tests read it around a call).
LAUNCHES = {"biquad": 0}


class GainIn(NamedTuple):
    """The gain normalizer's inputs for one chunk of B streams."""

    rms: torch.Tensor  # (B,) f32 the chunk's rms level
    ref_sqrt: torch.Tensor  # () f32 sqrt of the wakeword's rms level; NaN if none
    lo: float  # gain_min
    hi: float  # gain_max
    win: torch.Tensor  # (B, W) f32 rolling rms window, newest last
    count: torch.Tensor  # (B,) i32 entries of the window in use


class Front(NamedTuple):
    """What `front` writes; None for the parts of a filter that is off."""

    out: torch.Tensor  # (B, n) the filtered samples
    win: Optional[torch.Tensor]  # (B, W) the window after this chunk
    count: Optional[torch.Tensor]  # (B,) i32
    gain: Optional[torch.Tensor]  # (B,) the chunk's gain
    taps: Optional[torch.Tensor]  # (B, 4) [x1, x2, y1, y2] after this chunk


def window_mean(gwin: torch.Tensor, gcount: torch.Tensor) -> torch.Tensor:
    """Mean of the last `gcount` (B,) entries of each row of the (B, W) shift
    register, the newest last, summed in index order, oldest first."""
    W = gwin.shape[1]
    keep = torch.arange(W, device=gwin.device)[None, :] >= W - gcount[:, None]
    masked = torch.where(keep, gwin, 0.0)
    total = masked[:, 0]
    for i in range(1, W):
        total = total + masked[:, i]
    return total / gcount.to(torch.float32)


def biquad_plain(coeffs, state: torch.Tensor, signal: torch.Tensor):
    """The plain biquad: state (B, 4), signal (B, n) → (state', out (B, n))."""
    a0, a1, a2, b1, b2 = (float(c) for c in coeffs)
    x1, x2, y1, y2 = state.unbind(-1)
    out = []
    for x in signal.unbind(-1):
        y = a0 * x + a1 * x1 + a2 * x2 - b1 * y1 - b2 * y2
        x2, x1, y2, y1 = x1, x, y1, y
        out.append(y)
    return torch.stack([x1, x2, y1, y2], dim=-1), torch.stack(out, dim=-1)


def front_plain(samples: torch.Tensor, gain: Optional[GainIn] = None, coeffs=None,
                taps: Optional[torch.Tensor] = None) -> Front:
    """The plain version of `front`: the JAX package's torch composition,
    into new tensors."""
    win = count = g = None
    if gain is not None:
        W = gain.win.shape[1]
        apply = ~torch.isnan(gain.ref_sqrt) & (gain.rms != 0.0)
        gwin = torch.cat([gain.win[:, 1:], gain.rms[:, None]], dim=1)
        gcount = torch.clamp(gain.count + 1, max=W)
        mean = window_mean(gwin, gcount)
        # Rust f32::round is half-away-from-zero; the gain is positive
        g = torch.clamp(
            torch.floor(gain.ref_sqrt / torch.sqrt(mean) * 10.0 + 0.5) * GAIN_STEP,
            gain.lo, gain.hi,
        )
        g = torch.where(apply, g, 1.0)
        win = torch.where(apply[:, None], gwin, gain.win)
        count = torch.where(apply, gcount, gain.count).to(torch.int32)
        samples = torch.where((g != 1.0)[:, None],
                              torch.clamp(samples * g[:, None], -1.0, 1.0), samples)
    if coeffs is not None:
        taps, samples = biquad_plain(coeffs, taps, samples)
    return Front(samples, win, count, g, taps)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, {})
    fn = lib.rp_front
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7 + [ctypes.c_float] * 2
                   + [ctypes.c_int] + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 5
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2)
    fn.restype = ctypes.c_int
    return lib


def _check(samples: torch.Tensor, gain: Optional[GainIn], coeffs, taps) -> None:
    if samples.dim() != 2:
        raise ValueError(f"signal must be (B, n), got {tuple(samples.shape)}")
    B = samples.shape[0]
    if coeffs is not None:
        if taps is None or taps.shape != (B, 4):
            raise ValueError(f"state must be ({B}, 4), got "
                             f"{None if taps is None else tuple(taps.shape)}")
        if len(coeffs) != 5:
            raise ValueError(f"coeffs must be (a0, a1, a2, b1, b2), got {len(coeffs)} values")
    if gain is not None:
        W = gain.win.shape[-1]
        if (gain.rms.shape != (B,) or gain.ref_sqrt.dim() != 0 or gain.win.shape != (B, W)
                or gain.count.shape != (B,) or W < 1):
            raise ValueError(
                f"gain: rms ({B},), ref_sqrt (), win ({B}, W >= 1) and count ({B},) expected, "
                f"got {tuple(gain.rms.shape)}, {tuple(gain.ref_sqrt.shape)}, "
                f"{tuple(gain.win.shape)} and {tuple(gain.count.shape)}")


def _dest(t: Optional[torch.Tensor], like: Optional[torch.Tensor], name: str):
    """`t`, the tensor an output goes to, checked against the input it
    replaces; None where it is not given or its filter is off."""
    if like is None or t is None or t is like:
        return None if like is None else t
    if (t.shape != like.shape or t.dtype != like.dtype or t.device != like.device
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous tensor like the input it replaces")
    return t


def front(samples: torch.Tensor, gain: Optional[GainIn] = None, coeffs=None,
          taps: Optional[torch.Tensor] = None, *, win_out: Optional[torch.Tensor] = None,
          count_out: Optional[torch.Tensor] = None, gain_out: Optional[torch.Tensor] = None,
          taps_out: Optional[torch.Tensor] = None) -> Front:
    """The gain normalizer (`gain`, None for off), then the band-pass biquad
    (`coeffs` (a0, a1, a2, b1, b2) exact fp32 values and `taps` (B, 4), None
    for off) over samples (B, n). The filtered samples are a new tensor. The
    window, count, gain and taps are written into `win_out`, `count_out`,
    `gain_out` and `taps_out` where they are given (they may be the inputs
    themselves: the stream steps update their state where it lies), else
    into new tensors; those of a filter that is off are left alone. With
    both filters off, nothing runs and `out` is `samples`."""
    _check(samples, gain, coeffs, taps)
    if gain is None and coeffs is None:
        return Front(samples, None, None, None, None)
    on, bp = gain is not None, coeffs is not None
    likes = ((gain.win, gain.count, gain.rms) if on else (None,) * 3) + (taps if bp else None,)
    dests = [_dest(t, like, name) for t, like, name in
             zip((win_out, count_out, gain_out, taps_out), likes,
                 ("win_out", "count_out", "gain_out", "taps_out"))]
    if samples.device.type == "cpu":
        f = front_plain(samples, gain, coeffs, taps)
        return Front(f.out, *(n if d is None else d.copy_(n) for d, n in zip(dests, f[1:])))
    if samples.device.type != "cuda":
        raise ValueError(f"biquad: unsupported device {samples.device}")
    dev, f32 = samples.device, torch.float32
    named = [("signal", samples, f32)]
    if bp:
        named.append(("state", taps, f32))
    if on:
        named += [("rms", gain.rms, f32), ("ref_sqrt", gain.ref_sqrt, f32),
                  ("win", gain.win, f32), ("count", gain.count, torch.int32)]
    for name, t, dtype in named:
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {str(dtype)[6:]} tensor on {dev}")
    B, n = samples.shape
    out = torch.empty_like(samples)
    win_o, count_o, gain_o, taps_o = (torch.empty_like(like) if d is None and like is not None
                                      else d for d, like in zip(dests, likes))
    if on:
        g_ptrs = (gain.rms.data_ptr(), gain.ref_sqrt.data_ptr(), gain.win.data_ptr(),
                  gain.count.data_ptr(), win_o.data_ptr(), count_o.data_ptr(), gain_o.data_ptr())
        g_args = (float(gain.lo), float(gain.hi), gain.win.shape[1])
    else:
        g_ptrs, g_args = (None,) * 7, (0.0, 0.0, 1)
    lib = _library()
    with torch.cuda.device(dev):  # a library launches on the current card
        err = lib.rp_front(
            int(on), int(bp), *g_ptrs, *g_args,
            taps.data_ptr() if bp else None, taps_o.data_ptr() if bp else None,
            *(float(c) for c in (coeffs if bp else (0.0,) * 5)),
            samples.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream, B, n,
        )
    if err != 0:
        raise RuntimeError(f"biquad kernel launch failed: CUDA error {err}")
    LAUNCHES["biquad"] += 1
    return Front(out, win_o, count_o, gain_o, taps_o)


def biquad(coeffs, state: torch.Tensor, signal: torch.Tensor):
    """The band-pass alone: coeffs (a0, a1, a2, b1, b2) exact fp32 values,
    state (B, 4) taps, signal (B, n) → (state' (B, 4), filtered (B, n)),
    both new tensors."""
    r = front(signal, None, coeffs, state)
    return r.taps, r.out
