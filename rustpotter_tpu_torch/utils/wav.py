"""Minimal host-side RIFF/WAVE reader and writer.

Parity: the reference uses the `hound` crate for WAV IO
(src/mfcc/wav_file_extractor.rs:23-24). This module provides the same
capability surface: PCM int 8/16/32 and IEEE float32, mono/multi-channel,
plain and WAVE_FORMAT_EXTENSIBLE headers. A copy of `rustpotter_tpu.utils.wav`,
with the writer's bytes also given in memory (`wav_bytes`); host-side only.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Union

import numpy as np

WAVE_FORMAT_PCM = 1
WAVE_FORMAT_IEEE_FLOAT = 3
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


@dataclass
class WavSpec:
    sample_rate: int
    channels: int
    bits_per_sample: int
    is_float: bool


def read_wav(data_or_path: Union[bytes, str]) -> tuple[np.ndarray, WavSpec]:
    """Parse a WAV file. Returns (interleaved raw samples as numpy array, spec).

    Integer samples are returned with their native integer dtype, floats as
    float32 — conversion to the internal f32 representation is the encoder's
    job (audio/encoder.py), mirroring the reference split between hound and
    AudioEncoder.
    """
    if isinstance(data_or_path, (bytes, bytearray)):
        data = bytes(data_or_path)
    else:
        with open(data_or_path, "rb") as f:
            data = f.read()
    if len(data) < 12 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            tag, channels, sample_rate = struct.unpack("<HHI", body[0:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if tag == WAVE_FORMAT_EXTENSIBLE:
                # sub-format GUID: first 2 bytes are the real format tag
                tag = struct.unpack("<H", body[24:26])[0]
            fmt = (tag, channels, sample_rate, bits)
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError("missing fmt or data chunk")
    tag, channels, sample_rate, bits = fmt
    is_float = tag == WAVE_FORMAT_IEEE_FLOAT
    if is_float and bits == 32:
        samples = np.frombuffer(raw, dtype="<f4")
    elif not is_float and bits == 16:
        samples = np.frombuffer(raw, dtype="<i2")
    elif not is_float and bits == 32:
        samples = np.frombuffer(raw, dtype="<i4")
    elif not is_float and bits == 8:
        samples = np.frombuffer(raw, dtype="<i1")
    else:
        raise ValueError(f"Unsupported wav format: tag={tag} bits={bits}")
    return samples, WavSpec(sample_rate, channels, bits, is_float)


def wav_bytes(samples: np.ndarray, sample_rate: int) -> bytes:
    """Mono float32 or int16 samples as the bytes of a minimal WAV file."""
    samples = np.asarray(samples)
    if samples.dtype == np.float32:
        tag, bits = WAVE_FORMAT_IEEE_FLOAT, 32
        raw = samples.astype("<f4").tobytes()
    elif samples.dtype == np.int16:
        tag, bits = WAVE_FORMAT_PCM, 16
        raw = samples.astype("<i2").tobytes()
    else:
        raise ValueError("a WAV holds float32 or int16 samples")
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    fmt = struct.pack(
        "<HHIIHH", tag, 1, sample_rate, sample_rate * bits // 8, bits // 8, bits
    )
    hdr += b"fmt " + struct.pack("<I", len(fmt)) + fmt
    hdr += b"data" + struct.pack("<I", len(raw))
    return hdr + raw


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    """Write mono float32 or int16 samples as a minimal WAV file."""
    data = wav_bytes(samples, sample_rate)
    with open(path, "wb") as f:
        f.write(data)
