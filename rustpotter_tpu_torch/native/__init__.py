"""ctypes bindings for the host ingest library (csrc/ingest.cpp).

The counterpart of `rustpotter_tpu.native`: PCM decode, WAV header parse, a
polyphase fixed-ratio resampler and frame RMS, in C++ on the host. The
library is built with the host C++ compiler at first use into _build/
(`_build.py`); a failed build raises. The JAX package's binding falls back to
its Python code when the library is missing; this one does not.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np

from .. import _build

SOURCE = "ingest.cpp"
_FMT = {"i8": 0, "i16": 1, "i32": 2, "f32": 3}
_BYTES = {"i8": 1, "i16": 2, "i32": 4, "f32": 4}
_F32P = ctypes.POINTER(ctypes.c_float)


class WavInfo(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits_per_sample", ctypes.c_int32),
        ("is_float", ctypes.c_int32),
        ("data_offset", ctypes.c_int64),
        ("data_bytes", ctypes.c_int64),
    ]


@lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The ingest library, built on first use (a failed build raises)."""
    lib = _build.load(SOURCE, {})
    lib.rp_decode_pcm.restype = ctypes.c_int64
    lib.rp_decode_pcm.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
                                  ctypes.c_int, _F32P]
    lib.rp_downmix_first.restype = None
    lib.rp_downmix_first.argtypes = [_F32P, ctypes.c_int64, ctypes.c_int, _F32P]
    lib.rp_wav_parse.restype = ctypes.c_int
    lib.rp_wav_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(WavInfo)]
    lib.rp_resampler_new.restype = ctypes.c_void_p
    lib.rp_resampler_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.rp_resampler_free.restype = None
    lib.rp_resampler_free.argtypes = [ctypes.c_void_p]
    lib.rp_resampler_reset.restype = None
    lib.rp_resampler_reset.argtypes = [ctypes.c_void_p]
    lib.rp_resampler_process.restype = None
    lib.rp_resampler_process.argtypes = [ctypes.c_void_p, _F32P, _F32P]
    lib.rp_rms_level.restype = ctypes.c_float
    lib.rp_rms_level.argtypes = [_F32P, ctypes.c_int64]
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises
    instead of returning False."""
    return load_library() is not None


def decode_pcm(data: bytes, fmt: str, big_endian: bool = False) -> np.ndarray:
    """PCM bytes → f32 samples, integers scaled by 1/T::MAX (fmt i8, i16, i32
    or f32; i8 has no byte order)."""
    if fmt not in _FMT:
        raise ValueError(f"unknown sample format {fmt!r}: one of {sorted(_FMT)}")
    out = np.empty(len(data) // _BYTES[fmt], np.float32)
    n = load_library().rp_decode_pcm(data, len(data), _FMT[fmt], 1 if big_endian else 0,
                                     out.ctypes.data_as(_F32P))
    return out[:n]


def wav_parse(data: bytes) -> WavInfo:
    """The fmt and data chunks of a RIFF/WAVE file (plain or
    WAVE_FORMAT_EXTENSIBLE); ValueError if it is not one."""
    info = WavInfo()
    if load_library().rp_wav_parse(data, len(data), ctypes.byref(info)) != 0:
        raise ValueError("not a RIFF/WAVE file")
    return info


class NativeResampler:
    """Fixed-ratio resampler, n_in samples in, n_out out per chunk: the
    anti-aliasing filter of the JAX package's FFT overlap-add resampler
    (audio/resampler.py design_filter), evaluated as a time-domain
    convolution. For bulk ingest; not the golden-identified table."""

    def __init__(self, n_in: int, n_out: int):
        if n_in <= 0 or n_out <= 0 or n_in % n_out:
            raise ValueError(f"n_in ({n_in}) must be a positive multiple of n_out ({n_out})")
        self._lib = load_library()
        self._handle = self._lib.rp_resampler_new(n_in, n_out)
        self.n_in, self.n_out = n_in, n_out

    def process(self, chunk: np.ndarray) -> np.ndarray:
        chunk = np.ascontiguousarray(chunk, np.float32)
        if chunk.shape != (self.n_in,):
            raise ValueError(f"chunk must be ({self.n_in},), got {chunk.shape}")
        out = np.empty(self.n_out, np.float32)
        self._lib.rp_resampler_process(self._handle, chunk.ctypes.data_as(_F32P),
                                       out.ctypes.data_as(_F32P))
        return out

    def reset(self) -> None:
        self._lib.rp_resampler_reset(self._handle)

    def close(self) -> None:
        if self._handle:
            self._lib.rp_resampler_free(self._handle)
            self._handle = None

    def __del__(self):
        if getattr(self, "_handle", None):
            self.close()


def rms_level(x: np.ndarray) -> float:
    """sqrt(mean(x²)) with f64 accumulation."""
    x = np.ascontiguousarray(x, np.float32)
    return float(load_library().rp_rms_level(x.ctypes.data_as(_F32P), len(x)))
