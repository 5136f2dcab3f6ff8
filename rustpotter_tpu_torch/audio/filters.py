"""Audio filters: band-pass biquad and gain normalizer.

Parity: the reference's src/audio/band_pass_filter.rs (order-2 IIR, direct
form I — coefficient derivation :31-54, filter loop :19-30) and
src/audio/gain_normalizer_filter.rs (rolling-RMS gain with 0.1-step rounding
and ±1 clamping — :14-38). The counterpart of `rustpotter_tpu.audio.filters`:
  - host classes (numpy f32, sequential), copies of the JAX package's: the
    oracles of the stream steps' filters;
  - `band_pass_step`, the biquad over a batch of streams: on a CUDA tensor
    the hand-written kernel of `ops.biquad` (its band-pass-only form), on a
    CPU tensor its plain version. The stream steps run the gain normalizer
    and the band-pass together, `ops.biquad.front`.
The gain rounding is half-away-from-zero (floor(x·10+0.5), matching Rust
f32::round for positive gains) in both. The host class divides the rounded
value by 10, as the reference and the JAX package's host class do; the
stream steps multiply it by fl32(0.1) (`ops.biquad.GAIN_STEP`), as the JAX
package's compiled step does: the two differ at 0.9 (0.9 against 0.90000004).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..constants import DETECTOR_INTERNAL_SAMPLE_RATE
from ..ops import biquad


def band_pass_coefficients(
    sample_rate: float, low_cutoff: float, high_cutoff: float
) -> tuple[np.float32, ...]:
    """(a0, a1, a2, b1, b2) in f32, derived exactly like the reference."""
    omega_low = np.float32(2.0 * math.pi) * np.float32(low_cutoff) / np.float32(sample_rate)
    omega_high = np.float32(2.0 * math.pi) * np.float32(high_cutoff) / np.float32(sample_rate)
    cos_low = np.cos(omega_low, dtype=np.float32)
    cos_high = np.cos(omega_high, dtype=np.float32)
    alpha_low = np.sin(omega_low, dtype=np.float32) / np.float32(2.0)
    alpha_high = np.sin(omega_high, dtype=np.float32) / np.float32(2.0)
    a0 = np.float32(1.0) / (np.float32(1.0) + alpha_high - alpha_low)
    a1 = np.float32(-2.0) * cos_low * a0
    a2 = (np.float32(1.0) - alpha_high - alpha_low) * a0
    b1 = np.float32(-2.0) * cos_high * a0
    b2 = (np.float32(1.0) - alpha_high + alpha_low) * a0
    return a0, a1, a2, b1, b2


def band_pass_step(coeffs, state: torch.Tensor,
                   signal: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The biquad over a frame of B streams: state (B, 4) = [x1, x2, y1, y2],
    signal (B, n) → (state', filtered (B, n)). The counterpart of the JAX
    package's `band_pass_step` (a lax.scan over the samples)."""
    return biquad.biquad(coeffs, state, signal)


class BandPassFilter:
    """Stateful host-side filter (oracle)."""

    def __init__(self, sample_rate=DETECTOR_INTERNAL_SAMPLE_RATE, low_cutoff=80.0, high_cutoff=400.0):
        self.coeffs = band_pass_coefficients(float(sample_rate), low_cutoff, high_cutoff)
        self.x1 = self.x2 = self.y1 = self.y2 = np.float32(0.0)

    def filter(self, signal: np.ndarray) -> np.ndarray:
        a0, a1, a2, b1, b2 = self.coeffs
        out = np.empty_like(signal, dtype=np.float32)
        x1, x2, y1, y2 = self.x1, self.x2, self.y1, self.y2
        for i, x in enumerate(signal.astype(np.float32)):
            y = a0 * x + a1 * x1 + a2 * x2 - b1 * y1 - b2 * y2
            x2, x1, y2, y1 = x1, x, y1, y
            out[i] = y
        self.x1, self.x2, self.y1, self.y2 = x1, x2, y1, y2
        return out


class GainNormalizerFilter:
    """Stateful host-side gain normalizer (oracle)."""

    def __init__(self, min_gain=0.1, max_gain=1.0, fixed_rms_level: Optional[float] = None):
        self.min_gain = np.float32(min_gain)
        self.max_gain = np.float32(max_gain)
        self.fixed = fixed_rms_level is not None
        self.rms_level_ref = np.float32(fixed_rms_level if self.fixed else np.nan)
        self.rms_level_sqrt = np.float32(
            math.sqrt(fixed_rms_level) if self.fixed else np.nan
        )
        self.window: list[float] = []
        self.window_size = 1

    def set_rms_level_ref(self, rms_level: float, window_size: int) -> None:
        if not self.fixed:
            self.rms_level_ref = np.float32(rms_level)
            self.rms_level_sqrt = np.float32(math.sqrt(rms_level)) if rms_level >= 0 else np.float32(np.nan)
        self.window_size = window_size if window_size != 0 else 1

    @staticmethod
    def get_rms_level(signal: np.ndarray) -> np.float32:
        s = np.float32(0.0)
        for v in signal.astype(np.float32):
            s += v * v
        return np.sqrt(np.float32(s / np.float32(len(signal))))

    def filter(self, signal: np.ndarray, rms_level: float) -> tuple[np.ndarray, np.float32]:
        if np.isnan(self.rms_level_ref) or rms_level == 0.0:
            return signal, np.float32(1.0)
        self.window.append(np.float32(rms_level))
        if len(self.window) > self.window_size:
            self.window.pop(0)
        acc = np.float32(0.0)
        for v in self.window:
            acc += np.float32(v)
        frame_rms = np.float32(acc / np.float32(len(self.window)))
        gain = np.float32(self.rms_level_sqrt / np.sqrt(frame_rms))
        # Rust f32::round is half-away-from-zero; gain > 0 so floor(x+0.5)
        # matches exactly (gain_normalizer_filter.rs:27), as in the stream
        # steps: not banker's rounding.
        gain = np.float32(
            np.clip(
                np.floor(gain * np.float32(10.0) + np.float32(0.5)) / np.float32(10.0),
                self.min_gain,
                self.max_gain,
            )
        )
        if gain != 1.0:
            signal = np.clip(signal.astype(np.float32) * gain, -1.0, 1.0)
        return signal, gain
