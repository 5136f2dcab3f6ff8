"""Per-stream detector state, batched over streams, as tensors.

The reference's hidden mutability — sliding sample buffer, MFCC window, VAD
ring, gain window, IIR taps, partial detection, countdown (reference
src/detector.rs:34-91) — is explicit state. The counterpart of
`rustpotter_tpu.runtime.state` in its batched serving layout: every
per-stream field has the stream axis first, except the window, which is
stream-minor (F, C, B), and the shared cursor `rot`. The serving chunk
updates these tensors in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import SAMPLES_PER_FRAME
from .bundle import StepStatic

VAD_WINDOW = 50
VAD_VOICE_FRAMES = 500


class StreamState(NamedTuple):
    ext_buf: torch.Tensor  # (B, 480) pre-emphasized sample buffer
    ext_count: torch.Tensor  # (B,) i32: 0..480 (warm-up fill level)
    win: torch.Tensor  # (F, C, B) live MFCC window — CIRCULAR: see `rot`
    win_count: torch.Tensor  # (B,) i32
    vad_win: torch.Tensor  # (B, 50) energy shift-register (NaN = unfilled)
    vad_countdown: torch.Tensor  # (B,) i32
    rs_overlap: torch.Tensor  # (B, 480) in-graph resampler overlap-add state
    gain_win: torch.Tensor  # (B, Wg) rolling rms window, newest last
    gain_count: torch.Tensor  # (B,) i32
    gain: torch.Tensor  # (B,) f32: gain applied to latest frame
    rms_level: torch.Tensor  # (B,) f32: latest frame rms (pre-gain)
    bp: torch.Tensor  # (B, 4) biquad taps x1 x2 y1 y2
    partial_active: torch.Tensor  # (B,) bool
    partial_ww: torch.Tensor  # (B,) i32 wakeword index
    partial_score: torch.Tensor  # (B,) f32
    partial_avg: torch.Tensor  # (B,) f32
    partial_counter: torch.Tensor  # (B,) i32
    partial_gain: torch.Tensor  # (B,) f32
    partial_scores: torch.Tensor  # (B, Smax)
    countdown: torch.Tensor  # (B,) i32
    # ONE circular-window write cursor shared by all streams, a 0-d i32
    # tensor on the device (reading it needs no host sync). rot = physical
    # index of the NEWEST frame; logical frame i (0 = oldest) lives at
    # physical (rot + 1 + i) % F. Every stream advances in lockstep; writes
    # are per stream, and scoring is masked until win_count == F, so stale
    # slots are never read.
    rot: torch.Tensor


class Event(NamedTuple):
    fired: torch.Tensor  # (B,) bool
    ww: torch.Tensor  # (B,) i32
    score: torch.Tensor  # (B,) f32
    avg_score: torch.Tensor  # (B,) f32
    counter: torch.Tensor  # (B,) i32
    gain: torch.Tensor  # (B,) f32
    scores: torch.Tensor  # (B, Smax)


def init_state(static: StepStatic, batch_size: int, device: torch.device) -> StreamState:
    """Fresh state of `batch_size` streams, window stream-minor."""
    F, C = static.max_mfcc_frames, static.mfcc_size
    B = batch_size

    def z(shape, dtype=torch.float32, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=device)

    return StreamState(
        ext_buf=z((B, SAMPLES_PER_FRAME)),
        ext_count=z((B,), torch.int32),
        win=z((F, C, B)),
        win_count=z((B,), torch.int32),
        vad_win=z((B, VAD_WINDOW), fill=float("nan")),
        vad_countdown=z((B,), torch.int32),
        rs_overlap=z((B, SAMPLES_PER_FRAME)),
        gain_win=z((B, static.gain_window_size)),
        gain_count=z((B,), torch.int32),
        gain=z((B,), fill=1.0),
        rms_level=z((B,)),
        bp=z((B, 4)),
        partial_active=z((B,), torch.bool, False),
        partial_ww=z((B,), torch.int32),
        partial_score=z((B,)),
        partial_avg=z((B,)),
        partial_counter=z((B,), torch.int32),
        partial_gain=z((B,), fill=float("nan")),
        partial_scores=z((B, static.smax)),
        countdown=z((B,), torch.int32),
        rot=z((), torch.int32, F - 1),
    )
