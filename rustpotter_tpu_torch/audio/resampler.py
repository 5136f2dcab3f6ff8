"""FFT-overlap-add fixed-ratio resampler: the host resampler and the GEMM form.

A copy of `rustpotter_tpu.audio.resampler` (numpy), capability parity with
the reference's `rubato::FftFixedInOut<f32>` (the reference's
src/audio/encoder.rs:1,72-78): fixed input/output chunk sizes derived from
the rate ratio, an anti-aliasing low-pass applied in the frequency domain,
one chunk of overlap-add state.

  fft_size_in  = chunk_in  (1440 for 48k→16k at 30 ms)
  fft_size_out = chunk_out (480)
  filter_t[n]  = W[n]·sinc((n - N_in/2)·cutoff) / Σ / (2·N_in),  n < N_in
                 where W = (periodic 4-term Blackman-Harris over N_in)²
  cutoff       = calculate_cutoff(N_in, N_out)
  per chunk: X = rfft([chunk, 0…], 2N_in) · rfft(filter_t)
             Y = X[:N_out+1]  (spectrum truncation = resampling)
             y = irfft(Y, 2N_out) · 2N_out  (unnormalized inverse)
             out = y[:N_out] + overlap;  overlap' = y[N_out:]

The resampler adds N_out/2 output samples of latency (the filter's group
delay), as the reference's streaming resampler does.

The cutoff law is rubato's `base^(16/fft_size_in)` (scaled by
fft_size_out/fft_size_in when downsampling) with the base identified from
the reference's golden waveforms at (1440, 480), the one shape they use;
other ratios follow the same law. For (1440, 480) the host resampler runs
the f32 rustfft/realfft oracle (`rustfft_f32`) with the filter table
identified from those goldens (`rubato_table_48k16k.npz`, a copy of the JAX
package's); every other shape, or RUSTPOTTER_RESAMPLER=f64, runs the f64
FFT-OLA. The JAX package reads the same variable, so both choose alike.

`make_torch_resampler` is the in-graph form (the counterpart of the JAX
package's `make_jax_resampler`): the whole chunk transform is linear, so
it is one fp32 GEMM against the precomposed (n_in, 2·n_out) matrix of
`resample_matrix`, built once per shape and device.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

# base such that base^(16/1440) == 0.97161147, the cutoff (relative to the
# output Nyquist) identified from the reference goldens at the f32 noise floor.
CUTOFF_BASE = 0.97161147 ** 90.0  # == 0.07489553...
TABLE = os.path.join(os.path.dirname(__file__), "rubato_table_48k16k.npz")


def calculate_cutoff(fft_size_in: int, fft_size_out: int) -> float:
    """Anti-aliasing cutoff of the windowed-sinc prototype, relative to the
    input Nyquist (parity: rubato FftResampler::new's cutoff computation,
    with the identified base)."""
    k = CUTOFF_BASE ** (16.0 / fft_size_in)
    if fft_size_in > fft_size_out:
        return k * fft_size_out / fft_size_in
    return k


def _blackman_harris_periodic(n: int) -> np.ndarray:
    m = np.arange(n, dtype=np.float64)
    a = 2.0 * math.pi * m / n
    return 0.35875 - 0.48829 * np.cos(a) + 0.14128 * np.cos(2 * a) - 0.01168 * np.cos(3 * a)


def design_filter(fft_size_in: int, fft_size_out: int) -> np.ndarray:
    """Time-domain anti-aliasing filter, length 2*fft_size_in (second half 0)."""
    n = np.arange(fft_size_in, dtype=np.float64)
    cutoff = calculate_cutoff(fft_size_in, fft_size_out)
    w = _blackman_harris_periodic(fft_size_in) ** 2
    s = w * np.sinc((n - fft_size_in / 2.0) * cutoff)
    s = s / s.sum()
    filter_t = np.zeros(2 * fft_size_in, dtype=np.float64)
    filter_t[:fft_size_in] = s / (2.0 * fft_size_in)
    return filter_t


def chunk_sizes(sample_rate_in: int, sample_rate_out: int, chunk_size_out: int) -> tuple[int, int]:
    """Input/output chunk lengths for a fixed-ratio resampler: 30 ms at 48k
    → 1440 in / 480 out (encoder.rs:72-85 via rubato's input_frames_next)."""
    g = math.gcd(sample_rate_in, sample_rate_out)
    min_out = sample_rate_out // g
    fft_chunks = -(-chunk_size_out // min_out)  # ceil
    out = fft_chunks * min_out
    inp = fft_chunks * (sample_rate_in // g)
    return inp, out


def _load_identified_table(fft_size_in: int, fft_size_out: int):
    """The f32 filter table (re, im) identified from the reference's golden
    waveforms, for the one shape it covers, (1440, 480); else None."""
    if (fft_size_in, fft_size_out) != (1440, 480) or not os.path.exists(TABLE):
        return None
    t = np.load(TABLE)
    return t["filter_re"], t["filter_im"]


@dataclass
class FftResampler:
    """Stateful host resampler of one stream: the f32 oracle with the
    identified table for (1440, 480) unless RUSTPOTTER_RESAMPLER=f64, the
    f64 FFT-OLA with the designed filter otherwise."""

    fft_size_in: int
    fft_size_out: int

    def __post_init__(self):
        self.filter_f = np.fft.rfft(design_filter(self.fft_size_in, self.fft_size_out))
        self.overlap = np.zeros(self.fft_size_out, dtype=np.float64)
        self._oracle = None
        if os.environ.get("RUSTPOTTER_RESAMPLER") != "f64":
            table = _load_identified_table(self.fft_size_in, self.fft_size_out)
            if table is not None:
                from .rustfft_f32 import RubatoOracle

                self._oracle = RubatoOracle(*table)

    def reset(self) -> None:
        self.overlap[:] = 0.0
        if self._oracle is not None:
            self._oracle.reset()

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """chunk: (fft_size_in,) float → (fft_size_out,) float32."""
        if self._oracle is not None:
            return self._oracle.process(np.asarray(chunk, dtype=np.float32))
        y, self.overlap = resample_chunk_np(
            np.asarray(chunk, dtype=np.float64), self.overlap, self.filter_f,
            self.fft_size_out,
        )
        return y.astype(np.float32)


def resample_chunk_np(
    chunk: np.ndarray, overlap: np.ndarray, filter_f: np.ndarray, n_out: int
) -> tuple[np.ndarray, np.ndarray]:
    """One chunk of the f64 FFT-OLA: (output, next overlap)."""
    n_in = len(chunk)
    buf = np.zeros(2 * n_in, dtype=np.float64)
    buf[:n_in] = chunk
    spec = np.fft.rfft(buf) * filter_f
    trunc = spec[: n_out + 1].copy()
    y = np.fft.irfft(trunc, 2 * n_out) * (2.0 * n_out)
    return y[:n_out] + overlap, y[n_out:].copy()


def resample_matrix(fft_size_in: int, fft_size_out: int) -> np.ndarray:
    """The per-chunk FFT-OLA as ONE dense (2·n_out, n_in) f64 matrix: the
    chain (forward FFT, spectral filter, truncation, inverse FFT,
    un-normalization) is linear in the chunk, so pushing the identity basis
    through it composes it. Uses the identified table where the shape has
    one (as the host oracle does), else the designed filter."""
    n_in, n_out = fft_size_in, fft_size_out
    table = _load_identified_table(n_in, n_out)
    if table is not None:
        filter_f = table[0].astype(np.float64) + 1j * table[1].astype(np.float64)
    else:
        filter_f = np.fft.rfft(design_filter(n_in, n_out))
    basis = np.zeros((n_in, 2 * n_in))
    np.fill_diagonal(basis, 1.0)
    spec = np.fft.rfft(basis) * filter_f[None, :]
    y = np.fft.irfft(spec[:, : n_out + 1], 2 * n_out) * (2.0 * n_out)
    return y.T.copy()  # (2*n_out, n_in): y_full = M @ chunk


@lru_cache(maxsize=None)
def _matrix_t(fft_size_in: int, fft_size_out: int, device: torch.device) -> torch.Tensor:
    """resample_matrix transposed, (n_in, 2·n_out) fp32 on `device`: built
    in f64 on the host once per shape and device, never per chunk."""
    m = resample_matrix(fft_size_in, fft_size_out).T.astype(np.float32)
    return torch.tensor(m, device=device)


def make_torch_resampler(fft_size_in: int, fft_size_out: int, device):
    """In-graph resampler for the stream steps: returns
    resample(overlap (B, n_out), chunk (B, n_in)) -> (overlap', out (B, n_out)).

    One fp32 torch.matmul of the chunk against the precomposed matrix (TF32
    is off in this package), then the overlap-add. The JAX package computes
    this product outside any Pallas kernel."""
    m_t = _matrix_t(fft_size_in, fft_size_out, torch.device(device))
    n_out = fft_size_out

    def resample(overlap: torch.Tensor, chunk: torch.Tensor):
        y = torch.matmul(chunk, m_t)
        return y[..., n_out:], y[..., :n_out] + overlap

    return resample
