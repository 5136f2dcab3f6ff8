"""f32 oracle of the reference's resampler stack: rustfft 6.1.0 (scalar) +
realfft 3.3.0 + rubato 0.14.1 `FftFixedInOut<f32>`, for the 48 kHz->16 kHz
path (fft_size_in 1440 / fft_size_out 480; real FFTs of 2880 and 960).

A copy of `rustpotter_tpu.audio.rustfft_f32` (numpy only), with the JAX
package's plan-identification switches left out: the port keeps the one
plan and arithmetic that the JAX package's host resampler runs, so both
packages resample 48 kHz input to the same bits. `audio.resampler`'s
`FftResampler` uses it, with the identified filter table, for (1440, 480).

Why an f32 oracle: the reference's resampler rounds in f32 in its own plan
order, and 1e-7 of waveform noise moves an NN logit visibly, so the host
resampler re-derives every f32 op of that plan.

Plan derivation (rustfft 6.1.0 scalar planner, versions pinned by the
reference's Cargo.lock):
  complex 1440 = 2^5 * 45, trailing_zeros 5 >= MIN_RADIX4_BITS
    -> MixedRadix { width: Butterfly32, height: plan(45) }
  45 -> butterfly-pair search -> GoodThomasAlgorithmSmall { Butterfly5,
        Butterfly9 } (gcd 1; Butterfly9 = 3x3 mixed radix)
  complex 480 (inverse) = MixedRadix { Butterfly32, GoodThomasSmall(3, 5) }
        with FftDirection::Inverse twiddles.
realfft 3.3.0 RealToComplexEven(2880) / ComplexToRealEven(960) wrap those
complex FFTs with split/merge twiddle passes re-derived below.

All blocks carry (B, n) float32 re/im planes; complex multiplies follow
num_complex's (a.re*b.re - a.im*b.im, a.re*b.im + a.im*b.re) with no FMA
contraction, matching Rust scalar builds.
"""
from __future__ import annotations

import math

import numpy as np

F32 = np.float32


def tw(index: int, fft_len: int, fwd: bool = True) -> tuple[np.float32, np.float32]:
    """rustfft twiddles::compute_twiddle: f64 angle, f32 result; the inverse
    direction conjugates (twiddles.rs computes forward then conjugates)."""
    angle = -2.0 * math.pi * (index % fft_len) / fft_len
    if not fwd:
        angle = -angle
    return F32(math.cos(angle)), F32(math.sin(angle))


def cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def rot90(re, im, fwd: bool):
    """twiddles::rotate_90: forward z*(-i), inverse z*(+i). The passthrough
    component is copied — callers assign the result back into the same
    arrays (bf8), and a view would read already-overwritten data."""
    return (im.copy(), -re) if fwd else (-im, re.copy())


# ------------------------------------------------------------- butterflies

def bf2(re, im, fwd: bool):
    return (
        np.stack([re[:, 0] + re[:, 1], re[:, 0] - re[:, 1]], 1),
        np.stack([im[:, 0] + im[:, 1], im[:, 0] - im[:, 1]], 1),
    )


def bf3(re, im, fwd: bool):
    twr, twi = tw(1, 3, fwd)
    xpr = re[:, 1] + re[:, 2]
    xpi = im[:, 1] + im[:, 2]
    xnr = re[:, 1] - re[:, 2]
    xni = im[:, 1] - im[:, 2]
    sumr = re[:, 0] + xpr
    sumi = im[:, 0] + xpi
    tar = re[:, 0] + twr * xpr
    tai = im[:, 0] + twr * xpi
    tbr = -twi * xni
    tbi = twi * xnr
    return (
        np.stack([sumr, tar + tbr, tar - tbr], 1),
        np.stack([sumi, tai + tbi, tai - tbi], 1),
    )


def bf4(re, im, fwd: bool):
    t0r, t0i = re[:, 0] + re[:, 2], im[:, 0] + im[:, 2]
    t1r, t1i = re[:, 0] - re[:, 2], im[:, 0] - im[:, 2]
    t2r, t2i = re[:, 1] + re[:, 3], im[:, 1] + im[:, 3]
    t3r, t3i = re[:, 1] - re[:, 3], im[:, 1] - im[:, 3]
    t3r, t3i = rot90(t3r, t3i, fwd)
    return (
        np.stack([t0r + t2r, t1r + t3r, t0r - t2r, t1r - t3r], 1),
        np.stack([t0i + t2i, t1i + t3i, t0i - t2i, t1i - t3i], 1),
    )


def bf5(re, im, fwd: bool):
    t1r, t1i = tw(1, 5, fwd)
    t2r, t2i = tw(2, 5, fwd)
    x14pr, x14pi = re[:, 1] + re[:, 4], im[:, 1] + im[:, 4]
    x14nr, x14ni = re[:, 1] - re[:, 4], im[:, 1] - im[:, 4]
    x23pr, x23pi = re[:, 2] + re[:, 3], im[:, 2] + im[:, 3]
    x23nr, x23ni = re[:, 2] - re[:, 3], im[:, 2] - im[:, 3]
    sumr = re[:, 0] + x14pr + x23pr
    sumi = im[:, 0] + x14pi + x23pi
    b14re_a = re[:, 0] + t1r * x14pr + t2r * x23pr
    b14re_b = t1i * x14ni + t2i * x23ni
    b14im_a = im[:, 0] + t1r * x14pi + t2r * x23pi
    b14im_b = t1i * x14nr + t2i * x23nr
    b23re_a = re[:, 0] + t2r * x14pr + t1r * x23pr
    b23re_b = t2i * x14ni - t1i * x23ni
    b23im_a = im[:, 0] + t2r * x14pi + t1r * x23pi
    b23im_b = t2i * x14nr - t1i * x23nr
    return (
        np.stack([sumr, b14re_a - b14re_b, b23re_a - b23re_b,
                  b23re_a + b23re_b, b14re_a + b14re_b], 1),
        np.stack([sumi, b14im_a + b14im_b, b23im_a + b23im_b,
                  b23im_a - b23im_b, b14im_a - b14im_b], 1),
    )


ROOT2 = F32(math.sqrt(0.5))


def bf8(re, im, fwd: bool):
    er, ei = bf4(re[:, 0::2], im[:, 0::2], fwd)
    orr, oi = bf4(re[:, 1::2], im[:, 1::2], fwd)
    orr = orr.copy(); oi = oi.copy()
    r1, i1 = rot90(orr[:, 1], oi[:, 1], fwd)
    orr[:, 1], oi[:, 1] = (orr[:, 1] + r1) * ROOT2, (oi[:, 1] + i1) * ROOT2
    orr[:, 2], oi[:, 2] = rot90(orr[:, 2], oi[:, 2], fwd)
    r3, i3 = rot90(orr[:, 3], oi[:, 3], fwd)
    orr[:, 3], oi[:, 3] = (r3 - orr[:, 3]) * ROOT2, (i3 - oi[:, 3]) * ROOT2
    outr = np.concatenate([er + orr, er - orr], 1)
    outi = np.concatenate([ei + oi, ei - oi], 1)
    return outr, outi


def bf9(re, im, fwd: bool):
    """rustfft Butterfly9: 3x3 mixed radix (three column Butterfly3s,
    twiddles at (row, col) in {1,2}x{1,2} with indices row*col mod 9, three
    row Butterfly3s)."""
    B = re.shape[0]
    # columns [0,3,6], [1,4,7], [2,5,8]
    cr = [re[:, c::3] for c in range(3)]
    ci = [im[:, c::3] for c in range(3)]
    for c in range(3):
        cr[c], ci[c] = bf3(cr[c], ci[c], fwd)
    tws = {1: tw(1, 9, fwd), 2: tw(2, 9, fwd), 4: tw(4, 9, fwd)}
    for col in (1, 2):
        for row in (1, 2):
            twr, twi = tws[(row * col) % 9 if (row * col) != 4 else 4]
            r, i = cmul(cr[col][:, row], ci[col][:, row], twr, twi)
            cr[col][:, row], ci[col][:, row] = r, i
    # row FFTs across columns: row r -> [col0[r], col1[r], col2[r]]
    outr = np.empty((B, 9), F32)
    outi = np.empty((B, 9), F32)
    for row in range(3):
        rr = np.stack([cr[c][:, row] for c in range(3)], 1)
        ri = np.stack([ci[c][:, row] for c in range(3)], 1)
        rr, ri = bf3(rr, ri, fwd)
        # output: X[row + 3*j] = rowfft[j]
        for j in range(3):
            outr[:, row + 3 * j] = rr[:, j]
            outi[:, row + 3 * j] = ri[:, j]
    return outr, outi


def _split_radix(re, im, half_fn, quarter_fn, n, fwd):
    q = n // 4
    er, ei = half_fn(re[:, 0::2], im[:, 0::2], fwd)
    o1r, o1i = quarter_fn(re[:, 1::4], im[:, 1::4], fwd)
    idx3 = [(4 * k - 1) % n for k in range(q)]
    o3r, o3i = quarter_fn(re[:, idx3], im[:, idx3], fwd)
    outr = np.empty_like(re)
    outi = np.empty_like(im)
    for k in range(q):
        twr, twi = tw(k, n, fwd)
        t1r, t1i = cmul(o1r[:, k], o1i[:, k], twr, twi)
        t3r, t3i = cmul(o3r[:, k], o3i[:, k], twr, -twi)
        sr, si = t1r + t3r, t1i + t3i
        dr, di = t1r - t3r, t1i - t3i
        dr, di = rot90(dr, di, fwd)
        outr[:, k] = er[:, k] + sr
        outi[:, k] = ei[:, k] + si
        outr[:, k + 2 * q] = er[:, k] - sr
        outi[:, k + 2 * q] = ei[:, k] - si
        outr[:, k + q] = er[:, k + q] + dr
        outi[:, k + q] = ei[:, k + q] + di
        outr[:, k + 3 * q] = er[:, k + q] - dr
        outi[:, k + 3 * q] = ei[:, k + q] - di
    return outr, outi


def bf16(re, im, fwd: bool):
    return _split_radix(re, im, bf8, bf4, 16, fwd)


def bf32(re, im, fwd: bool):
    return _split_radix(re, im, bf16, bf8, 32, fwd)


# -------------------------------------------------- composite algorithms

def good_thomas_small(re, im, width_fn, width, height_fn, height, fwd):
    n = width * height
    gather = np.empty((height, width), np.int64)
    for h in range(height):
        for w in range(width):
            gather[h, w] = (w * height + h * width) % n
    B = re.shape[0]
    xr = re[:, gather.reshape(-1)].reshape(B, height, width)
    xi = im[:, gather.reshape(-1)].reshape(B, height, width)
    xr2, xi2 = width_fn(xr.reshape(B * height, width), xi.reshape(B * height, width), fwd)
    xr = xr2.reshape(B, height, width)
    xi = xi2.reshape(B, height, width)
    xr = np.swapaxes(xr, 1, 2).reshape(B * width, height)
    xi = np.swapaxes(xi, 1, 2).reshape(B * width, height)
    xr, xi = height_fn(xr, xi, fwd)
    xr = np.swapaxes(xr.reshape(B, width, height), 1, 2)
    xi = np.swapaxes(xi.reshape(B, width, height), 1, 2)
    out_rows = np.arange(n) % height
    out_cols = np.arange(n) % width
    return xr[:, out_rows, out_cols], xi[:, out_rows, out_cols]


_MR_TW_CACHE: dict = {}


def _mr_twiddles(width: int, height: int, fwd: bool):
    key = (width, height, fwd)
    if key not in _MR_TW_CACHE:
        n = width * height
        twr = np.empty((width, height), np.float32)
        twi = np.empty((width, height), np.float32)
        for x in range(width):
            for y in range(height):
                twr[x, y], twi[x, y] = tw(x * y, n, fwd)
        _MR_TW_CACHE[key] = (twr, twi)
    return _MR_TW_CACHE[key]


def mixed_radix(re, im, width_fn, width, height_fn, height, fwd):
    B, n = re.shape
    assert n == width * height
    xr = np.swapaxes(re.reshape(B, height, width), 1, 2)
    xi = np.swapaxes(im.reshape(B, height, width), 1, 2)
    xr2, xi2 = height_fn(xr.reshape(B * width, height), xi.reshape(B * width, height), fwd)
    xr = xr2.reshape(B, width, height)
    xi = xi2.reshape(B, width, height)
    twr, twi = _mr_twiddles(width, height, fwd)
    xr, xi = cmul(xr, xi, twr[None], twi[None])
    xr = np.swapaxes(xr, 1, 2)
    xi = np.swapaxes(xi, 1, 2)
    xr2, xi2 = width_fn(xr.reshape(B * height, width), xi.reshape(B * height, width), fwd)
    xr = xr2.reshape(B, height, width)
    xi = xi2.reshape(B, height, width)
    outr = np.swapaxes(xr, 1, 2).reshape(B, n)
    outi = np.swapaxes(xi, 1, 2).reshape(B, n)
    return outr, outi


def fft15(re, im, fwd: bool):
    return good_thomas_small(re, im, bf3, 3, bf5, 5, fwd)


def fft45(re, im, fwd: bool):
    """GoodThomasAlgorithmSmall { Butterfly5, Butterfly9 }."""
    return good_thomas_small(re, im, bf5, 5, bf9, 9, fwd)


def fft480(re, im, fwd: bool):
    return mixed_radix(re, im, bf32, 32, fft15, 15, fwd)


def fft1440(re, im, fwd: bool):
    return mixed_radix(re, im, bf32, 32, fft45, 45, fwd)


# --------------------------------------------------------------- realfft

def r2c_even(x: np.ndarray, cfft, n: int):
    """realfft 3.3 RealToComplexEven::process for even length n: pack pairs
    into a complex FFT of n/2, then the split pass. x: (B, n) f32 ->
    (re, im) each (B, n/2 + 1). Twiddle k = compute_twiddle(k, n) * 0.5
    (f64 angle -> f32, then the 0.5 fold); the loop computes
      X[k]    = 0.5*sum + tw(x)diff   (component form below)
      X[N-k]  = conj(0.5*sum - tw(x)diff)
    validated against np.fft.rfft by validate_structure()."""
    B = x.shape[0]
    N = n // 2
    zr = x[:, 0::2].copy()
    zi = x[:, 1::2].copy()
    zr, zi = cfft(zr, zi, True)
    outr = np.empty((B, N + 1), F32)
    outi = np.zeros((B, N + 1), F32)
    outr[:, 0] = zr[:, 0] + zi[:, 0]
    outr[:, N] = zr[:, 0] - zi[:, 0]
    outi[:, 0] = 0.0
    outi[:, N] = 0.0
    half = F32(0.5)
    twiddle_count = N // 2 if N % 2 == 0 else N // 2 + 1
    ks = np.arange(1, twiddle_count)
    key = ("r2c", n)
    if key not in _MR_TW_CACHE:
        ang = -2.0 * math.pi * ks.astype(np.float64) / n
        _MR_TW_CACHE[key] = (
            np.cos(ang).astype(F32) * half, np.sin(ang).astype(F32) * half
        )
    twr, twi = _MR_TW_CACHE[key]
    xkr, xki = zr[:, ks], zi[:, ks]
    xnkr, xnki = zr[:, N - ks], zi[:, N - ks]
    sumr, sumi = xkr + xnkr, xki - xnki
    diffr, diffi = xkr - xnkr, xki + xnki
    # tw' = tw * (-i) folded: out = 0.5*sum + (tw*(-i))*diff where the
    # component products each round once (realfft's loop arithmetic)
    ar = twi * diffr + twr * diffi
    ai = twi * diffi - twr * diffr
    outr[:, ks] = half * sumr + ar
    outi[:, ks] = half * sumi + ai
    outr[:, N - ks] = half * sumr - ar
    outi[:, N - ks] = ai - half * sumi
    if N % 2 == 0:
        # middle element: X[N/2] = conj(Z[N/2])
        outr[:, N // 2] = zr[:, N // 2]
        outi[:, N // 2] = -zi[:, N // 2]
    return outr, outi


def c2r_even(sr: np.ndarray, si: np.ndarray, cifft, n: int):
    """realfft 3.3 ComplexToRealEven::process for even n: merge pass into a
    complex INVERSE FFT of n/2, unpack pairs. (B, n/2+1) spectrum ->
    (B, n) f32, UNnormalized (ifft(fft(x)) == (n/2)*x per rustfft's inverse;
    the overall 1/n normalization lives in rubato's filter scaling)."""
    B = sr.shape[0]
    N = n // 2
    zr = np.empty((B, N), F32)
    zi = np.empty((B, N), F32)
    zr[:, 0] = sr[:, 0] + sr[:, N]
    zi[:, 0] = sr[:, 0] - sr[:, N]
    twiddle_count = N // 2 if N % 2 == 0 else N // 2 + 1
    ks = np.arange(1, twiddle_count)
    key = ("c2r", n)
    if key not in _MR_TW_CACHE:
        ang = -2.0 * math.pi * ks.astype(np.float64) / n
        _MR_TW_CACHE[key] = (np.cos(ang).astype(F32), np.sin(ang).astype(F32))
    twr, twi = _MR_TW_CACHE[key]
    xkr, xki = sr[:, ks], si[:, ks]
    xnkr, xnki = sr[:, N - ks], si[:, N - ks]
    sumr, sumi = xkr + xnkr, xki - xnki
    diffr, diffi = xkr - xnkr, xki + xnki
    # Z[k] = sum + (i*conj(tw))*diff ; Z[N-k] = conj(sum - (i*conj(tw))*diff)
    ar = twi * diffr - twr * diffi
    ai = twi * diffi + twr * diffr
    zr[:, ks] = sumr + ar
    zi[:, ks] = sumi + ai
    zr[:, N - ks] = sumr - ar
    zi[:, N - ks] = ai - sumi
    if N % 2 == 0:
        zr[:, N // 2] = F32(2.0) * sr[:, N // 2]
        zi[:, N // 2] = F32(-2.0) * si[:, N // 2]
    zr, zi = cifft(zr, zi, False)
    out = np.empty((B, n), F32)
    out[:, 0::2] = zr
    out[:, 1::2] = zi
    return out


def rfft2880(x):
    return r2c_even(x, fft1440, 2880)


def irfft960(sr, si):
    return c2r_even(sr, si, fft480, 960)


# --------------------------------------------------- rubato resample loop

class RubatoOracle:
    """rubato 0.14.1 FftFixedInOut<f32> for 1440 -> 480, f32 op-for-op,
    given the frequency-domain filter table (filter_f re/im, (1441,) f32).

    resample_unit (synchro.rs): copy chunk into the zero-padded scratch,
    forward real FFT (2880), per-bin complex multiply with filter_f,
    spectrum truncation to 481 bins, inverse real FFT (960), overlap-add
    the first 480, stash the last 480 as the next overlap."""

    def __init__(self, filter_fr: np.ndarray, filter_fi: np.ndarray):
        self.fr = filter_fr.astype(F32)
        self.fi = filter_fi.astype(F32)
        self.overlap = np.zeros(480, F32)

    def reset(self):
        self.overlap[:] = 0

    def process(self, chunk: np.ndarray) -> np.ndarray:
        assert chunk.shape == (1440,)
        buf = np.zeros((1, 2880), F32)
        buf[0, :1440] = chunk
        sr, si = rfft2880(buf)
        mr, mi = cmul(sr[0], si[0], self.fr, self.fi)
        tr = mr[:481][None].astype(F32)
        ti = mi[:481][None].astype(F32)
        y = irfft960(tr, ti)[0]
        out = y[:480] + self.overlap
        self.overlap = y[480:].copy()
        return out
