"""The port's host ingest binding (rustpotter_tpu_torch.native, built from
csrc/ingest.cpp with the host C++ compiler) against the port's Python code
and the JAX package's resampler:

- decode_pcm equals audio/encoder.decode_bytes exactly, every format, both
  byte orders;
- wav_parse finds the fmt and data chunks utils/wav.read_wav finds;
- NativeResampler(1440, 480) agrees with the JAX package's f64 FFT
  overlap-add (`resample_chunk_np`) on the designed filter (`design_filter`,
  the taps ingest.cpp mirrors) within 1e-5: the taps are rounded to f32 and
  the dot products summed in 16 f32 partial sums;
- rms_level agrees with numpy's f64 rms to f32 rounding.
"""
import struct

import numpy as np
import pytest

from rustpotter_tpu.audio.resampler import design_filter, resample_chunk_np
from rustpotter_tpu_torch import Endianness, SampleFormat
from rustpotter_tpu_torch import native
from rustpotter_tpu_torch.audio.encoder import decode_bytes
from rustpotter_tpu_torch.utils.wav import read_wav, write_wav

FORMATS = {"i8": (SampleFormat.I8, "i1"), "i16": (SampleFormat.I16, "i2"),
           "i32": (SampleFormat.I32, "i4"), "f32": (SampleFormat.F32, "f4")}


def test_library_builds_and_loads():
    assert native.available()


def test_library_is_keyed_on_the_compiler(monkeypatch):
    """A library built by another compiler (another path or --version) is
    never the one loaded: its key differs."""
    from rustpotter_tpu_torch import _build

    built = _build.build(native.SOURCE, {})
    assert built == _build.library_path(native.SOURCE, {}) and built.exists()
    compiler = _build.cxx()
    ident = _build.compiler_identity(compiler)
    assert ident.startswith(compiler + "\n") and len(ident) > len(compiler) + 1
    monkeypatch.setitem(_build._identities, compiler, ident + "another release\n")
    assert _build.library_path(native.SOURCE, {}) != built


@pytest.mark.parametrize("big_endian", [False, True])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_decode_pcm_equals_decode_bytes(fmt, big_endian):
    sf, code = FORMATS[fmt]
    rng = np.random.default_rng(len(fmt))
    if fmt == "f32":
        vals = rng.normal(0, 0.5, 999).astype(np.float32)
    else:
        info = np.iinfo(code)
        vals = np.concatenate([[0, 1, -1, info.max, info.min],
                               rng.integers(info.min, info.max, 994, endpoint=True)])
    order = ">" if big_endian and fmt != "i8" else "<"
    data = vals.astype(order + code).tobytes()
    got = native.decode_pcm(data, fmt, big_endian)
    want = decode_bytes(data, sf, Endianness.BIG if big_endian else Endianness.LITTLE)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def _extensible_wav(samples: np.ndarray, rate: int, channels: int) -> bytes:
    """A WAVE_FORMAT_EXTENSIBLE float32 file, with an odd-sized chunk before
    the data chunk."""
    body = samples.astype("<f4").tobytes()
    fmt = struct.pack("<HHIIHHHHIH14s", 0xFFFE, channels, rate, rate * 4 * channels,
                      4 * channels, 32, 22, 32, 0, 3, b"\x00" * 14)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"LIST" + struct.pack("<I", 3) + b"abc\x00"
              + b"data" + struct.pack("<I", len(body)) + body)
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE" + chunks


@pytest.mark.parametrize("kind", ["i16", "f32", "extensible"])
def test_wav_parse_agrees_with_read_wav(tmp_path, kind):
    rng = np.random.default_rng(5)
    if kind == "extensible":
        data = _extensible_wav(rng.normal(0, 0.3, 2 * 333).astype(np.float32), 48000, 2)
    else:
        samples = rng.normal(0, 0.3, 777).astype(np.float32)
        if kind == "i16":
            samples = (samples * 32767).astype(np.int16)
        write_wav(str(tmp_path / "a.wav"), samples, 16000)
        data = (tmp_path / "a.wav").read_bytes()
    info = native.wav_parse(data)
    raw, spec = read_wav(data)
    assert (info.sample_rate, info.channels, info.bits_per_sample, bool(info.is_float)) == (
        spec.sample_rate, spec.channels, spec.bits_per_sample, spec.is_float)
    body = data[info.data_offset:info.data_offset + info.data_bytes]
    fmt = "f32" if spec.is_float else f"i{spec.bits_per_sample}"
    np.testing.assert_array_equal(native.decode_pcm(body, fmt),
                                  decode_bytes(raw.tobytes(), FORMATS[fmt][0],
                                               Endianness.LITTLE))
    with pytest.raises(ValueError, match="RIFF"):
        native.wav_parse(b"RIFX" + data[4:])


def test_resampler_agrees_with_the_fft_overlap_add():
    n_in, n_out = 1440, 480
    filter_f = np.fft.rfft(design_filter(n_in, n_out))
    rng = np.random.default_rng(0)
    t = np.arange(40 * n_in) / 48000.0
    src = (0.3 * np.sin(2 * np.pi * (200 + 3000 * t) * t)
           + 0.05 * rng.normal(size=t.size)).astype(np.float32)
    res = native.NativeResampler(n_in, n_out)
    overlap = np.zeros(n_out)
    for c in range(40):
        chunk = src[c * n_in:(c + 1) * n_in]
        want, overlap = resample_chunk_np(chunk.astype(np.float64), overlap, filter_f, n_out)
        np.testing.assert_allclose(res.process(chunk), want, rtol=0, atol=1e-5)
    res.reset()  # a reset resampler starts from silence again
    want, _ = resample_chunk_np(src[:n_in].astype(np.float64), np.zeros(n_out), filter_f, n_out)
    np.testing.assert_allclose(res.process(src[:n_in]), want, rtol=0, atol=1e-5)
    res.close()
    with pytest.raises(ValueError, match="multiple"):
        native.NativeResampler(1440, 500)


def test_rms_level_agrees_with_numpy():
    x = np.random.default_rng(2).normal(0, 0.2, 480).astype(np.float32)
    want = np.sqrt(np.mean(x.astype(np.float64) ** 2))
    assert native.rms_level(x) == pytest.approx(want, rel=1e-7)
    assert native.rms_level(np.ones(480, np.float32)) == 1.0
