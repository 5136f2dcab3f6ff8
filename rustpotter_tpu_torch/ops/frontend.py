"""MFCC front-end ops: pre-emphasis, framing, windowed DFT, mel filterbank, DCT.

The frame→MFCC pipeline is GEMMs plus elementwise ops (GEMM-native DFT — the
power spectrum is |frame·W_cos + i·frame·W_sin|², the mel projection is a
fixed (240, n_coeff) matrix, and the DCT is an (n, n) matrix), batched over
any leading axes of frames (and, in the runtime, streams). The GEMMs are plain
`torch.matmul` in true fp32 (TF32 is switched off at package import).

Semantics parity (values, not code) with the reference extractor
src/mfcc/extractor.rs:
  - pre-emphasis 0.97 applied per 160-sample shift with the carry reset to 0 at
    each shift boundary (extractor.rs:87-97)
  - Hamming window 0.54 - 0.46 cos(2πs/(N-1)) (extractor.rs:115-120)
  - 480-pt DFT, first 240 magnitude bins (extractor.rs:101-114)
  - triangular mel filterbank with integer-floored centre indices applied to
    squared magnitudes (extractor.rs:135-145,164-198)
  - ln(x + f32::MIN_POSITIVE) (extractor.rs:128)
  - DCT-II scaled by 2, coefficient 0 dropped (extractor.rs:146-163)

The constant builders are numpy copies of `rustpotter_tpu.ops.frontend`.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..constants import (
    DETECTOR_INTERNAL_SAMPLE_RATE,
    MAGNITUDE_SPECTRUM_SIZE,
    MFCCS_EXTRACTOR_PRE_EMPHASIS,
    SAMPLES_PER_FRAME,
    SAMPLES_PER_SHIFT,
)

F32_MIN_POSITIVE = np.float32(1.1754943508222875e-38)  # f32::MIN_POSITIVE


def hamming_window(n: int = SAMPLES_PER_FRAME) -> np.ndarray:
    s = np.arange(n, dtype=np.float32)
    return (
        np.float32(0.54)
        - np.float32(0.46) * np.cos(np.float32(2.0 * math.pi) * (s / np.float32(n - 1)))
    ).astype(np.float32)


def _frequency_to_mel(frequency: float) -> float:
    return 1127.0 * math.log(1.0 + frequency / 700.0)


def mel_filter_bank(
    sample_rate: int,
    magnitude_spectrum_size: int,
    num_coefficients: int,
    min_frequency: int = 0,
    max_frequency: int | None = None,
) -> np.ndarray:
    """(num_coefficients, magnitude_spectrum_size) triangular filterbank.

    Centre bins use the reference's exact floor-based construction
    (extractor.rs:174-181), including its idiosyncratic inverse-mel constant
    computed from ln(1 + 1000/700)/1000.
    """
    if max_frequency is None:
        max_frequency = sample_rate // 2
    max_mel = math.floor(np.float32(_frequency_to_mel(max_frequency)))
    min_mel = math.floor(np.float32(_frequency_to_mel(min_frequency)))
    centre_indices = []
    for i in range(num_coefficients + 2):
        f = np.float32(i) * (np.float32(max_mel) - np.float32(min_mel)) / np.float32(
            num_coefficients + 1
        ) + np.float32(min_mel)
        tmp = np.float32(math.log(np.float32(1.0 + 1000.0 / 700.0)) / 1000.0)
        tmp = (np.exp(np.float32(f * tmp), dtype=np.float32) - np.float32(1.0)) / (
            np.float32(sample_rate) / np.float32(2.0)
        )
        centre_indices.append(
            int(
                math.floor(
                    np.float32(0.5)
                    + np.float32(700.0) * np.float32(magnitude_spectrum_size) * tmp
                )
            )
        )
    fb = np.zeros((num_coefficients, magnitude_spectrum_size), dtype=np.float32)
    for i in range(num_coefficients):
        begin, centre, end = centre_indices[i], centre_indices[i + 1], centre_indices[i + 2]
        up = centre - begin
        down = end - centre
        for k in range(begin, centre):
            fb[i, k] = np.float32(k - begin) / np.float32(up)
        for k in range(centre, end):
            fb[i, k] = np.float32(end - k) / np.float32(down)
    return fb


def dct_matrix(n: int) -> np.ndarray:
    """(n, n) matrix D with out = D @ x: out[k] = 2 Σ_j x[j] cos(π/n (j+0.5) k)."""
    pi_over_n = np.float32(math.pi) / np.float32(n)
    k = np.arange(n, dtype=np.float32)[:, None]
    j = np.arange(n, dtype=np.float32)[None, :]
    return (np.float32(2.0) * np.cos(pi_over_n * (j + np.float32(0.5)) * k)).astype(
        np.float32
    )


def dft_matrices(n: int = SAMPLES_PER_FRAME, bins: int = MAGNITUDE_SPECTRUM_SIZE):
    """Real-DFT as two GEMM weight matrices (n, bins): cos and -sin parts.

    X[k] = Σ_j x[j] e^{-2πi jk/n}; re = x @ C, im = x @ S.
    Built in float64 then rounded to f32 so the twiddles carry < 1 ulp error.
    """
    j = np.arange(n, dtype=np.float64)[:, None]
    k = np.arange(bins, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * j * k / float(n)
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


class FrontendConstants:
    """Precomputed constant matrices (numpy) for a given mfcc output size."""

    def __init__(self, num_coefficients: int, sample_rate: int = DETECTOR_INTERNAL_SAMPLE_RATE):
        self.num_coefficients = num_coefficients
        self.hamming = hamming_window(SAMPLES_PER_FRAME)
        self.mel_fb_t = mel_filter_bank(
            sample_rate, MAGNITUDE_SPECTRUM_SIZE, num_coefficients
        ).T.copy()  # (240, n)
        self.dct_t = dct_matrix(num_coefficients).T.copy()  # (n, n)
        cos_m, sin_m = dft_matrices()
        # fold the Hamming window into the DFT weights: one GEMM does window+DFT
        self.dft_cos = (self.hamming[:, None] * cos_m).astype(np.float32)  # (480, 240)
        self.dft_sin = (self.hamming[:, None] * sin_m).astype(np.float32)


@lru_cache(maxsize=8)
def get_constants(num_coefficients: int) -> FrontendConstants:
    return FrontendConstants(num_coefficients)


class DeviceConstants:
    """The GEMM weights of `FrontendConstants` as fp32 tensors on one device.
    The cos and sin DFT weights sit side by side in one (480, 480) matrix, so
    the windowed DFT is a single GEMM."""

    def __init__(self, consts: FrontendConstants, device: torch.device):
        self.num_coefficients = consts.num_coefficients
        self.dft = torch.from_numpy(
            np.concatenate([consts.dft_cos, consts.dft_sin], axis=1)
        ).to(device)
        self.mel_fb_t = torch.from_numpy(consts.mel_fb_t).to(device)
        self.dct_t = torch.from_numpy(consts.dct_t).to(device)
        self.bins = consts.dft_cos.shape[1]


@lru_cache(maxsize=16)
def device_constants(num_coefficients: int, device: torch.device) -> DeviceConstants:
    return DeviceConstants(get_constants(num_coefficients), torch.device(device))


def pre_emphasis(shifts: torch.Tensor) -> torch.Tensor:
    """shifts: (..., SAMPLES_PER_SHIFT). Carry resets to 0 at every shift
    boundary (reference quirk, extractor.rs:87-97)."""
    prev = torch.nn.functional.pad(shifts[..., :-1], (1, 0))
    return shifts - prev * MFCCS_EXTRACTOR_PRE_EMPHASIS


def mfcc_from_frames(frames: torch.Tensor, num_coefficients: int) -> torch.Tensor:
    """frames: (..., 480) pre-emphasized sample frames → (..., n-1) MFCCs.

    One GEMM for the windowed DFT (cos | sin), a mel GEMM, log, and a DCT
    GEMM, all fp32. The first cepstral coefficient is dropped
    (extractor.rs:84-85).

    Frames made by `unfold` overlap in memory; cuBLAS multiplies such a view
    with a far slower fp32 kernel than a packed copy (chip_smoke.py's
    profile names both), so the frames are packed first."""
    k = device_constants(num_coefficients, frames.device)
    spec = torch.matmul(frames.contiguous(), k.dft)
    re, im = spec[..., : k.bins], spec[..., k.bins :]
    power = re * re + im * im  # |X[k]|^2 — reference squares the magnitude again
    mel = torch.matmul(power, k.mel_fb_t)
    logmel = torch.log(mel + F32_MIN_POSITIVE)
    mfcc = torch.matmul(logmel, k.dct_t)
    return mfcc[..., 1:]


def frames_from_shifts(pre_shifts: torch.Tensor) -> torch.Tensor:
    """(num_shifts, 160) pre-emphasized shifts → (num_shifts-3, 480) frames.

    Frame t (t ≥ 0) is shifts [t+1, t+2, t+3]: the reference's sliding buffer
    emits its first frame on the 4th shift (extractor.rs:69-79), skewing the
    stream by one shift (160 samples) relative to naive framing.
    """
    flat = pre_shifts.reshape(-1)[SAMPLES_PER_SHIFT:]
    return flat.unfold(0, SAMPLES_PER_FRAME, SAMPLES_PER_SHIFT)


def cmn(frames: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Cepstral mean normalization: subtract per-coefficient mean over frames
    (reference src/mfcc/normalizer.rs:3-31)."""
    return frames - torch.mean(frames, dim=axis, keepdim=True)


def rms_level(samples: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """√(mean(x²)) — reference src/audio/gain_normalizer_filter.rs:49-55."""
    return torch.sqrt(torch.mean(torch.square(samples), dim=axis))
