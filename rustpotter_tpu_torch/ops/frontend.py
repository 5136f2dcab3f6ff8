"""MFCC front-end ops: pre-emphasis, framing, windowed DFT, mel filterbank, DCT.

The frame→MFCC pipeline is GEMMs plus elementwise ops (GEMM-native DFT — the
power spectrum is |frame·W_cos + i·frame·W_sin|², the mel projection is a
fixed (240, n_coeff) matrix, and the DCT is an (n, n) matrix), batched over
any leading axes of frames (and, in the runtime, streams). The DFT GEMM is a
plain `torch.matmul` in true fp32 (TF32 is switched off at package import);
so are the mel and DCT GEMMs of the plain version.

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

On a CUDA tensor the elementwise work around the windowed-DFT product runs
in the two hand-written kernels of csrc/mfcc_front.cu, built at first use:
`prologue` (pre-emphasis, the extractor buffer and the packed frames of the
batched chunk, and its rms) and `epilogue` (power, mel, log and DCT of every
`mfcc_from_frames`). On a CPU tensor each runs its plain version, the torch
composition (`prologue_plain`, `epilogue_plain`); there is no fallback.
"""
from __future__ import annotations

import ctypes
import math
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..constants import (
    DETECTOR_INTERNAL_SAMPLE_RATE,
    MAGNITUDE_SPECTRUM_SIZE,
    MFCCS_EXTRACTOR_PRE_EMPHASIS,
    SAMPLES_PER_FRAME,
    SAMPLES_PER_SHIFT,
)

F32_MIN_POSITIVE = np.float32(1.1754943508222875e-38)  # f32::MIN_POSITIVE

SOURCE = "mfcc_front.cu"
# The most mel bands (MFCC coefficients + 1) the epilogue takes: RP_N's
# bound in csrc/mfcc_front.cu.
N_MAX = 64
# Launch counts of the kernel wrappers: one per launch, nowhere else.
LAUNCHES = {"mfcc_prologue": 0, "mfcc_epilogue": 0}


def hamming_window(n: int = SAMPLES_PER_FRAME) -> np.ndarray:
    s = np.arange(n, dtype=np.float32)
    return (
        np.float32(0.54)
        - np.float32(0.46) * np.cos(np.float32(2.0 * math.pi) * (s / np.float32(n - 1)))
    ).astype(np.float32)


def _frequency_to_mel(frequency: float) -> float:
    return 1127.0 * math.log(1.0 + frequency / 700.0)


def mel_centres(
    sample_rate: int,
    magnitude_spectrum_size: int,
    num_coefficients: int,
    min_frequency: int = 0,
    max_frequency: int | None = None,
) -> list:
    """The num_coefficients + 2 centre bins of the triangular filterbank:
    filter i rises over [c_i, c_{i+1}) and falls over [c_{i+1}, c_{i+2}).

    The reference's exact floor-based construction (extractor.rs:174-181),
    including its idiosyncratic inverse-mel constant computed from
    ln(1 + 1000/700)/1000.
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
    return centre_indices


def mel_filter_bank(
    sample_rate: int,
    magnitude_spectrum_size: int,
    num_coefficients: int,
    min_frequency: int = 0,
    max_frequency: int | None = None,
) -> np.ndarray:
    """(num_coefficients, magnitude_spectrum_size) triangular filterbank over
    the centres of `mel_centres`."""
    centre_indices = mel_centres(sample_rate, magnitude_spectrum_size, num_coefficients,
                                 min_frequency, max_frequency)
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
        self.tables = epilogue_tables(
            self.mel_fb_t, mel_centres(sample_rate, MAGNITUDE_SPECTRUM_SIZE, num_coefficients),
            self.dct_t.T)


def epilogue_tables(mel_fb_t: np.ndarray, centres: list, dct: np.ndarray) -> dict:
    """The fields of csrc/mfcc_front.cu's `Tables` for the filterbank mel_fb_t
    (bins, n) over `centres` (n + 2) and the DCT matrix dct (n, n): per bin k
    its weight in the band rising over it (`wr`) and in the band falling
    over it (`wf`), the centres at k (`cut`, uint8), the DCT's rows 1 ..
    n - 1 (`dct`), and each of those rows' sum, correctly rounded to float64
    (`dsum`: a constant row's DCT is its value times that sum). Raises if the
    filterbank has a weight outside those two bands. `pack_tables` lays them
    out as the kernel's build says."""
    bins, n = mel_fb_t.shape
    c = np.asarray(centres)
    if len(c) != n + 2 or np.any(np.diff(c) < 0) or c[0] < 0 or c[-1] > bins:
        raise ValueError(f"centres must be {n + 2} ascending bins in [0, {bins}]")
    k = np.arange(bins)
    seg = np.searchsorted(c, k, side="right") - 1  # c[seg] <= k < c[seg + 1]
    rise, fall = (seg >= 0) & (seg < n), (seg >= 1) & (seg <= n)
    wr, wf = np.zeros(bins, np.float32), np.zeros(bins, np.float32)
    wr[rise] = mel_fb_t[k[rise], seg[rise]]
    wf[fall] = mel_fb_t[k[fall], seg[fall] - 1]
    rest = mel_fb_t.copy()
    rest[k[rise], seg[rise]] = 0
    rest[k[fall], seg[fall] - 1] = 0
    if np.any(rest != 0):
        raise ValueError("the filterbank has weights outside its triangles")
    cut = np.bincount(c[c < bins], minlength=bins).astype(np.uint8)
    rows = np.ascontiguousarray(dct[1:], np.float32)
    dsum = np.array([math.fsum(r) for r in rows.astype(np.float64)])
    return {"wr": wr, "wf": wf, "cut": cut, "dct": rows, "dsum": dsum}


TABLE_FIELDS = ("wr", "wf", "cut", "dct", "dsum")  # the order of rp_mfcc_tables_layout


def pack_tables(fields: dict, layout) -> np.ndarray:
    """The bytes of csrc/mfcc_front.cu's `Tables` from the fields of
    `epilogue_tables`, by `layout`: the offset and size of each of
    TABLE_FIELDS, then the struct's size, as rp_mfcc_tables_layout reports
    them. Raises unless each field fills its place exactly and no two
    places overlap."""
    *places, size = (int(v) for v in layout)
    out = np.zeros(size, np.uint8)
    taken = np.zeros(size, bool)
    for name, off, nbytes in zip(TABLE_FIELDS, places[0::2], places[1::2]):
        raw = np.ascontiguousarray(fields[name]).view(np.uint8).ravel()
        if raw.size != nbytes or off < 0 or off + nbytes > size or taken[off:off + nbytes].any():
            raise RuntimeError(f"{SOURCE}: Tables.{name} takes {nbytes} bytes at {off} of "
                               f"{size}; epilogue_tables gives {raw.size}")
        out[off:off + nbytes] = raw
        taken[off:off + nbytes] = True
    return out


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


def _check(name: str, t: torch.Tensor, shape: tuple) -> None:
    if t.dtype != torch.float32 or t.shape[len(t.shape) - len(shape):] != shape:
        raise ValueError(f"{name} must be float32 (..., {', '.join(map(str, shape))}), "
                         f"got {t.dtype} {tuple(t.shape)}")


def _card_ready(device: torch.device, *named) -> None:
    """Raises unless the device is a card and every tensor a contiguous one
    on it at a 16-byte address (the kernels move float4s and 16-byte chunks)."""
    if device.type != "cuda":
        raise ValueError(f"mfcc_front: unsupported device {device}")
    for name, t in named:
        if t.device != device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous tensor on {device} at a "
                             f"16-byte aligned address")


@lru_cache(maxsize=None)
def _prologue_library() -> ctypes.CDLL:
    lib = _build.load(SOURCE, {})
    lib.rp_mfcc_prologue.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]
    lib.rp_mfcc_prologue.restype = ctypes.c_int
    return lib


@lru_cache(maxsize=None)
def _epilogue_library(n: int):
    """The epilogue for n mel bands (its tables' shape is built in), and the
    bytes of its tables, laid out as the build reports."""
    lib = _build.load(SOURCE, {"RP_N": n})
    lib.rp_mfcc_epilogue.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
    lib.rp_mfcc_epilogue.restype = ctypes.c_int
    lib.rp_mfcc_tables_layout.argtypes = [ctypes.c_void_p]
    lib.rp_mfcc_tables_layout.restype = None
    layout = np.zeros(2 * len(TABLE_FIELDS) + 1, np.int32)
    lib.rp_mfcc_tables_layout(layout.ctypes.data)
    return lib, pack_tables(get_constants(n).tables, layout)


def prologue_plain(samples: torch.Tensor, ext_buf: torch.Tensor, rms: bool):
    """The plain version of `prologue`: the torch composition."""
    B = samples.shape[0]
    shifts = pre_emphasis(samples.reshape(B, 3, SAMPLES_PER_SHIFT))
    cat = torch.cat([ext_buf, shifts.reshape(B, SAMPLES_PER_FRAME)], dim=1)
    frames = cat.unfold(1, SAMPLES_PER_FRAME, SAMPLES_PER_SHIFT)[:, :3].contiguous()
    ext_buf.copy_(cat[:, SAMPLES_PER_FRAME:])
    return frames, rms_level(samples) if rms else None


def prologue(samples: torch.Tensor, ext_buf: torch.Tensor, rms: bool):
    """The batched chunk's front-end before the DFT product, for B streams:
    samples (B, 480), one chunk; ext_buf (B, 480), the extractor buffer: the
    last three pre-emphasized shifts. Returns (frames (B, 3, 480), packed:
    frame s is [ext_buf, the chunk's shifts][160 s, 160 s + 480), so frame 0
    is the buffer (the batched chunk hears a shift late); the chunk's rms
    level (B,) if `rms`, else None) and writes the new buffer, the chunk's
    pre-emphasized shifts, over ext_buf."""
    _check("samples", samples, (SAMPLES_PER_FRAME,))
    _check("ext_buf", ext_buf, (SAMPLES_PER_FRAME,))
    if samples.dim() != 2 or ext_buf.shape != samples.shape:
        raise ValueError(f"samples (B, 480) and ext_buf (B, 480) expected, got "
                         f"{tuple(samples.shape)} and {tuple(ext_buf.shape)}")
    if samples.device.type == "cpu":
        return prologue_plain(samples, ext_buf, rms)
    dev = samples.device
    _card_ready(dev, ("samples", samples), ("ext_buf", ext_buf))
    B = samples.shape[0]
    frames = torch.empty((B, 3, SAMPLES_PER_FRAME), device=dev)
    level = torch.empty((B,), device=dev) if rms else None
    with torch.cuda.device(dev):  # a library launches on the current card
        err = _prologue_library().rp_mfcc_prologue(
            samples.data_ptr(), ext_buf.data_ptr(), frames.data_ptr(),
            level.data_ptr() if rms else None, torch.cuda.current_stream(dev).cuda_stream, B)
    if err != 0:
        raise RuntimeError(f"mfcc_prologue launch failed: CUDA error {err}")
    LAUNCHES["mfcc_prologue"] += 1
    return frames, level


def epilogue_plain(spec: torch.Tensor, num_coefficients: int, window: bool = False):
    """The plain version of `epilogue`: the torch composition."""
    k = device_constants(num_coefficients, spec.device)
    re, im = spec[..., : k.bins], spec[..., k.bins :]
    power = re * re + im * im  # |X[k]|^2 — reference squares the magnitude again
    mel = torch.matmul(power, k.mel_fb_t)
    logmel = torch.log(mel + F32_MIN_POSITIVE)
    mfcc = torch.matmul(logmel, k.dct_t)[..., 1:]
    return mfcc.permute(1, 2, 0).contiguous() if window else mfcc


def epilogue(spec: torch.Tensor, num_coefficients: int, window: bool = False):
    """The MFCCs of the windowed DFT's spectrum spec (..., 480) = [re | im]:
    power, mel bank, log, DCT, the first coefficient dropped, over
    num_coefficients mel bands. Returns (..., num_coefficients - 1), or with
    `window`, for spec (B, S, 480), (S, num_coefficients - 1, B). The kernel
    sums in another order than the plain version (held at rtol 1e-5 / atol
    1e-5 to it); for a row whose logs are all equal (a silent frame), where
    the DCT's terms cancel and an fp32 sum leaves order-dependent noise, it
    writes the exact value rounded once (ROADMAP F5)."""
    _check("spec", spec, (SAMPLES_PER_FRAME,))
    if window and spec.dim() != 3:
        raise ValueError(f"the window layout takes spec (B, S, 480), got {tuple(spec.shape)}")
    if spec.device.type == "cpu":
        return epilogue_plain(spec, num_coefficients, window)
    dev, n = spec.device, num_coefficients
    if not 2 <= n <= N_MAX:
        raise ValueError(f"the epilogue takes 2 to {N_MAX} mel bands, got {n}")
    _card_ready(dev, ("spec", spec))
    lead = spec.shape[:-1]
    S = lead[1] if window else 1
    out = torch.empty((S, n - 1, lead[0]) if window else lead + (n - 1,), device=dev)
    M = spec.numel() // SAMPLES_PER_FRAME
    if M == 0:
        return out
    lib, tables = _epilogue_library(n)  # the tables are held while the launcher copies them
    with torch.cuda.device(dev):
        err = lib.rp_mfcc_epilogue(
            tables.ctypes.data, spec.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream, M, S, int(window))
    if err != 0:
        raise RuntimeError(f"mfcc_epilogue launch failed: CUDA error {err}")
    LAUNCHES["mfcc_epilogue"] += 1
    return out


def mfcc_from_frames(frames: torch.Tensor, num_coefficients: int,
                     window: bool = False) -> torch.Tensor:
    """frames: (..., 480) pre-emphasized sample frames → (..., n-1) MFCCs,
    or with `window`, for frames (B, S, 480), (S, n-1, B): the window's layout.

    One GEMM for the windowed DFT (cos | sin), then the `epilogue` (power,
    mel, log, DCT), all fp32. The first cepstral coefficient is dropped
    (extractor.rs:84-85).

    Frames made by `unfold` overlap in memory; cuBLAS multiplies such a view
    with a far slower fp32 kernel than a packed copy (torch.profiler on an
    H100 names both; `tools/front_probe.py --mfcc` lists the packed chain's
    kernels), so the frames are packed first."""
    k = device_constants(num_coefficients, frames.device)
    spec = torch.matmul(frames.contiguous(), k.dft)
    return epilogue(spec, num_coefficients, window)


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
