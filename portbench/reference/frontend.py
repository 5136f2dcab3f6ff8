"""MFCC front-end of rustpotter's detector, in plain PyTorch.

The extractor of rustpotter v3 (src/mfcc/extractor.rs) as the benchmark
reads it: 16 kHz audio in shifts of 160 samples; pre-emphasis 0.97 with the
carry reset to 0 at every shift; a frame is the last 480 pre-emphasized
samples (three shifts, the buffer starting as zeros); Hamming window
0.54 - 0.46 cos(2 pi s / 479); the first 240 bins of a 480-point DFT,
squared magnitudes; a triangular mel filter bank whose centre bins are
floored in float32 arithmetic; ln(x + f32::MIN_POSITIVE); a DCT-II scaled by
2; coefficient 0 dropped. The DFT, the mel bank and the DCT are matrix
products (`products.matmul`), so the control's precision reaches them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .products import dtype_of, matmul

SAMPLE_RATE = 16000
SHIFT = 160
FRAME = 480
BINS = 240
PRE_EMPHASIS = 0.97
F32_MIN_POSITIVE = 1.1754943508222875e-38


def hamming() -> np.ndarray:
    s = np.arange(FRAME, dtype=np.float64)
    return 0.54 - 0.46 * np.cos(2.0 * math.pi * s / (FRAME - 1))


def mel_bank(num_coefficients: int) -> np.ndarray:
    """(num_coefficients, 240) triangular filters over 0 .. 8 kHz, the
    centre bins computed in float32 as the Rust code computes them."""
    f32 = np.float32

    def mel(freq: float) -> float:
        return 1127.0 * math.log(1.0 + freq / 700.0)

    top = math.floor(f32(mel(SAMPLE_RATE // 2)))
    bottom = math.floor(f32(mel(0)))
    step = f32(math.log(f32(1.0 + 1000.0 / 700.0)) / 1000.0)
    centres = []
    for i in range(num_coefficients + 2):
        m = f32(i) * (f32(top) - f32(bottom)) / f32(num_coefficients + 1) + f32(bottom)
        hz = (np.exp(f32(m * step), dtype=f32) - f32(1.0)) / (f32(SAMPLE_RATE) / f32(2.0))
        centres.append(int(math.floor(f32(0.5) + f32(700.0) * f32(BINS) * hz)))
    bank = np.zeros((num_coefficients, BINS))
    for i in range(num_coefficients):
        lo, mid, hi = centres[i], centres[i + 1], centres[i + 2]
        for k in range(lo, mid):
            bank[i, k] = (k - lo) / (mid - lo)
        for k in range(mid, hi):
            bank[i, k] = (hi - k) / (hi - mid)
    return bank


def dct(n: int) -> np.ndarray:
    """(n, n): out[k] = 2 sum_j x[j] cos(pi / n (j + 0.5) k)."""
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    return 2.0 * np.cos(math.pi / n * (j + 0.5) * k)


class Frontend:
    """The front-end's matrices for `mfcc_size` coefficients (the extractor
    computes mfcc_size + 1 and drops the first), on one device."""

    def __init__(self, mfcc_size: int, device, precision: str):
        self.precision = precision
        dt = dtype_of(precision)
        n = mfcc_size + 1
        j = np.arange(FRAME, dtype=np.float64)[:, None]
        k = np.arange(BINS, dtype=np.float64)[None, :]
        ang = -2.0 * math.pi * j * k / FRAME
        win = hamming()[:, None]
        dft = np.concatenate([win * np.cos(ang), win * np.sin(ang)], axis=1)  # (480, 480)
        t = lambda a: torch.tensor(a, dtype=dt, device=device)
        self.dft = t(dft)
        self.mel = t(mel_bank(n).T)  # (240, n)
        self.dct = t(dct(n).T)  # (n, n)

    def mfcc(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (..., 480) pre-emphasized samples -> (..., mfcc_size)."""
        p = self.precision
        lead = frames.shape[:-1]
        spec = matmul(frames.reshape(-1, FRAME), self.dft, p)
        power = spec[:, :BINS] ** 2 + spec[:, BINS:] ** 2
        logmel = torch.log(matmul(power, self.mel, p) + F32_MIN_POSITIVE)
        out = matmul(logmel, self.dct, p)[:, 1:]
        return out.reshape(*lead, out.shape[-1])


def pre_emphasis(pcm: torch.Tensor) -> torch.Tensor:
    """pcm (..., G * 160) -> (..., G, 160): per shift, x[i] - 0.97 x[i-1]
    with x[-1] = 0."""
    shifts = pcm.reshape(*pcm.shape[:-1], -1, SHIFT)
    prev = torch.nn.functional.pad(shifts[..., :-1], (1, 0))
    return shifts - PRE_EMPHASIS * prev


def stream_frames(pre: torch.Tensor) -> torch.Tensor:
    """pre (S, G, 160) -> (S, G, 480): the frame at shift g holds shifts
    g - 2, g - 1 and g, the buffer starting as zeros."""
    padded = torch.nn.functional.pad(pre, (0, 0, 2, 0))
    return torch.cat([padded[:, :-2], padded[:, 1:-1], padded[:, 2:]], dim=-1)


def stream_mfccs(pcm: torch.Tensor, front: Frontend, block: int = 1 << 15) -> torch.Tensor:
    """pcm (S, G * 160) of streams that start from an empty extractor ->
    (S, G, C): the MFCCs of every shift's frame, computed in blocks of
    `block` frames."""
    frames = stream_frames(pre_emphasis(pcm.to(front.dft.dtype)))
    S, G = frames.shape[:2]
    flat = frames.reshape(S * G, FRAME)
    out = torch.cat([front.mfcc(flat[i:i + block]) for i in range(0, S * G, block)])
    return out.reshape(S, G, -1)


def offline_mfccs(samples: torch.Tensor, front: Frontend, cmn: bool = True) -> torch.Tensor:
    """A recording's MFCCs as a wakeword file holds them (rustpotter
    src/mfcc/wav_file_extractor.rs): samples (G * 160,) -> (G - 3, C), frame
    t holding shifts t + 1 .. t + 3 (the extractor emits its first frame at
    the fourth shift), then the per-coefficient mean over the recording
    subtracted."""
    frames = stream_frames(pre_emphasis(samples.to(front.dft.dtype))[None])[0, 3:]
    m = front.mfcc(frames)
    return m - m.mean(dim=0, keepdim=True) if cmn else m
