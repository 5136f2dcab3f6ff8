"""The band-pass biquad over a batch of streams: one kernel launch per chunk.

`biquad` is the function of the JAX package's band-pass scan
(`rustpotter_tpu/runtime/stream_step.py` `prepare_chunk`, and
`rustpotter_tpu/audio/filters.py` `band_pass_step`): an order-2 IIR in
direct form I over each stream's samples, taps [x1, x2, y1, y2] carried from
chunk to chunk. It is a `lax.scan` there, not a Pallas kernel; in PyTorch
the scan would be ~10 elementwise launches per sample (~4,800 per chunk), so
on a CUDA tensor `biquad` launches the hand-written kernel of csrc/biquad.cu
(one thread per stream, built at first use) or raises; on a CPU tensor it
runs the plain version, `biquad_plain`, a loop over the samples.

Both evaluate y = a0·x + a1·x1 + a2·x2 − b1·y1 − b2·y2 left to right with
every product and sum rounded to fp32 (the kernel through __fmul_rn,
__fadd_rn and __fsub_rn, which the compiler never contracts into an FMA), so
the kernel equals the plain version bit for bit, and the plain version
equals the host oracle `audio.filters.BandPassFilter`.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build

SOURCE = "biquad.cu"

# Launch count of the kernel wrapper: one per launch, nowhere else
# (chip_smoke.py resets and reads it).
LAUNCHES = {"biquad": 0}


def biquad_plain(coeffs, state: torch.Tensor, signal: torch.Tensor):
    """The plain version: state (B, 4), signal (B, n) → (state', out (B, n))."""
    a0, a1, a2, b1, b2 = (float(c) for c in coeffs)
    x1, x2, y1, y2 = state.unbind(-1)
    out = []
    for x in signal.unbind(-1):
        y = a0 * x + a1 * x1 + a2 * x2 - b1 * y1 - b2 * y2
        x2, x1, y2, y1 = x1, x, y1, y
        out.append(y)
    return torch.stack([x1, x2, y1, y2], dim=-1), torch.stack(out, dim=-1)


@lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, {})
    fn = lib.rp_biquad
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_float] * 5 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return lib


def biquad(coeffs, state: torch.Tensor, signal: torch.Tensor):
    """coeffs (a0, a1, a2, b1, b2) exact fp32 values, state (B, 4) taps,
    signal (B, n) → (state' (B, 4), filtered (B, n)), both new tensors."""
    if signal.dim() != 2:
        raise ValueError(f"signal must be (B, n), got {tuple(signal.shape)}")
    B = signal.shape[0]
    if tuple(state.shape) != (B, 4):
        raise ValueError(f"state must be ({B}, 4), got {tuple(state.shape)}")
    if len(coeffs) != 5:
        raise ValueError(f"coeffs must be (a0, a1, a2, b1, b2), got {len(coeffs)} values")
    if signal.device.type == "cpu":
        return biquad_plain(coeffs, state, signal)
    if signal.device.type != "cuda":
        raise ValueError(f"biquad: unsupported device {signal.device}")
    dev = signal.device
    for name, t in (("signal", signal), ("state", state)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
    out = torch.empty_like(signal)
    state_out = torch.empty_like(state)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
    err = _library().rp_biquad(
        state.data_ptr(), signal.data_ptr(), state_out.data_ptr(), out.data_ptr(),
        *(float(c) for c in coeffs), stream, B, signal.shape[1],
    )
    if err != 0:
        raise RuntimeError(f"biquad kernel launch failed: CUDA error {err}")
    LAUNCHES["biquad"] += 1
    return state_out, out
