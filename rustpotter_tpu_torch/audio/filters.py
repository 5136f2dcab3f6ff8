"""Band-pass filter coefficients.

Parity: the reference's src/audio/band_pass_filter.rs:31-54 (coefficient
derivation of the order-2 IIR). Only the coefficients are ported so far:
`runtime.bundle.build_bundle` records them. The filter itself (and the gain
normalizer) in the serving chunk is ROADMAP M7.
"""
from __future__ import annotations

import math

import numpy as np


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
