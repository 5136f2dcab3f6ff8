"""The resampler of the PyTorch port against the JAX package's on the CPU.

The host pieces are numpy in both packages and must be equal bit for bit at
48, 44.1, 22.05 and 8 kHz: `chunk_sizes`, `calculate_cutoff`,
`design_filter`, `resample_matrix`, `FftResampler` (the f32 rustfft oracle
with the identified table at 48 kHz, the f64 FFT-OLA elsewhere and under
RUSTPOTTER_RESAMPLER=f64), and the `AudioEncoder` built on them; the port's
copy of the identified table equals the JAX package's. The in-graph form
`make_torch_resampler` (one fp32 GEMM) is held to `make_jax_resampler` on the
CPU at rtol 1e-5 / atol 1e-6: the two products sum 1440 terms in different
orders.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu.audio import resampler as jax_rs
from rustpotter_tpu.audio.encoder import AudioEncoder as JaxAudioEncoder
from rustpotter_tpu.config import AudioFmt as JaxAudioFmt
from rustpotter_tpu.config import SampleFormat as JaxSampleFormat
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import AudioFmt, RustpotterConfig, SampleFormat
from rustpotter_tpu_torch.audio import resampler as rs
from rustpotter_tpu_torch.audio.encoder import AudioEncoder
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.wakewords.files import WakewordRef

torch.set_num_threads(2)

RATES = (48000, 44100, 22050, 8000)


def _chunks(n_in, count=3, seed=0):
    return np.random.default_rng(seed).normal(0, 0.2, (count, n_in)).astype(np.float32)


@pytest.mark.parametrize("rate", RATES)
def test_sizes_cutoff_and_filter_equal_jax(rate):
    sizes = rs.chunk_sizes(rate, 16000, 480)
    assert sizes == jax_rs.chunk_sizes(rate, 16000, 480)
    assert rs.calculate_cutoff(*sizes) == jax_rs.calculate_cutoff(*sizes)
    np.testing.assert_array_equal(rs.design_filter(*sizes), jax_rs.design_filter(*sizes))
    assert rs.CUTOFF_BASE == jax_rs.CUTOFF_BASE


def test_chunk_sizes_of_the_common_rates():
    assert rs.chunk_sizes(48000, 16000, 480) == (1440, 480)
    assert rs.chunk_sizes(44100, 16000, 480) == (1323, 480)
    assert rs.chunk_sizes(8000, 16000, 480) == (240, 480)


@pytest.mark.parametrize("rate", RATES)
def test_resample_matrix_equals_jax(rate):
    n_in = rs.chunk_sizes(rate, 16000, 480)[0]
    np.testing.assert_array_equal(rs.resample_matrix(n_in, 480),
                                  jax_rs.resample_matrix(n_in, 480))


def test_identified_table_is_the_jax_packages():
    mine = np.load(rs.TABLE)
    theirs = np.load(os.path.join(os.path.dirname(jax_rs.__file__), "rubato_table_48k16k.npz"))
    assert sorted(mine.files) == sorted(theirs.files) == ["filter_im", "filter_re"]
    for k in mine.files:
        assert mine[k].dtype == theirs[k].dtype
        np.testing.assert_array_equal(mine[k], theirs[k])
    got = rs._load_identified_table(1440, 480)
    np.testing.assert_array_equal(got[0], theirs["filter_re"])
    assert rs._load_identified_table(1323, 480) is None


@pytest.mark.parametrize("backend", ["default", "f64"])
@pytest.mark.parametrize("rate", RATES)
def test_fft_resampler_equals_jax(rate, backend, monkeypatch):
    """Three chunks with the overlap carried, then a reset and one more."""
    if backend == "f64":
        monkeypatch.setenv("RUSTPOTTER_RESAMPLER", "f64")
    else:
        monkeypatch.delenv("RUSTPOTTER_RESAMPLER", raising=False)
    n_in, n_out = rs.chunk_sizes(rate, 16000, 480)
    mine, theirs = rs.FftResampler(n_in, n_out), jax_rs.FftResampler(n_in, n_out)
    assert (mine._oracle is None) == (theirs._oracle is None)
    assert (mine._oracle is not None) == (rate == 48000 and backend == "default")
    x = _chunks(n_in, 4, seed=rate)
    for i, chunk in enumerate(x):
        if i == 3:
            mine.reset()
            theirs.reset()
        got, want = mine.process(chunk), theirs.process(chunk)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_resample_chunk_np_equals_jax():
    n_in = 1323
    f = np.fft.rfft(rs.design_filter(n_in, 480))
    x = _chunks(n_in, 2, seed=1).astype(np.float64)
    y1, o1 = rs.resample_chunk_np(x[0], np.zeros(480), f, 480)
    y2, o2 = jax_rs.resample_chunk_np(x[0], np.zeros(480), f, 480)
    np.testing.assert_array_equal(y1, y2)
    np.testing.assert_array_equal(o1, o2)


@pytest.mark.parametrize("rate", RATES)
def test_torch_resampler_matches_jax_resampler(rate):
    """Three (B = 5, n_in) chunks with the overlap carried."""
    n_in = rs.chunk_sizes(rate, 16000, 480)[0]
    mine = rs.make_torch_resampler(n_in, 480, "cpu")
    theirs = jax_rs.make_jax_resampler(n_in, 480)
    ov, jov = torch.zeros(5, 480), jnp.zeros((5, 480))
    for c in range(3):
        x = np.random.default_rng(c).normal(0, 0.3, (5, n_in)).astype(np.float32)
        ov, out = mine(ov, torch.tensor(x))
        jov, jout = theirs(jov, jnp.asarray(x))
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ov.numpy(), np.asarray(jov), rtol=1e-5, atol=1e-6)


def test_torch_resampler_builds_its_matrix_once(monkeypatch):
    """The (n_in, 2·n_out) matrix is built once per shape and device, never
    per chunk or per resampler."""
    calls = []
    real = rs.resample_matrix
    monkeypatch.setattr(rs, "resample_matrix", lambda *a: calls.append(a) or real(*a))
    rs._matrix_t.cache_clear()
    try:
        for _ in range(2):
            f = rs.make_torch_resampler(882, 480, "cpu")
            for _ in range(2):
                f(torch.zeros(2, 480), torch.zeros(2, 882))
        assert calls == [(882, 480)]
        assert rs._matrix_t(882, 480, torch.device("cpu")).dtype == torch.float32
    finally:
        rs._matrix_t.cache_clear()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("rate", RATES)
def test_audio_encoder_at_other_rates_equals_jax(rate, channels):
    """int16 input: frame lengths, then 4 frames resampled bit for bit."""
    fmt = AudioFmt(sample_rate=rate, sample_format=SampleFormat.I16, channels=channels)
    jfmt = JaxAudioFmt(sample_rate=rate, sample_format=JaxSampleFormat.I16, channels=channels)
    enc, jenc = AudioEncoder(fmt), JaxAudioEncoder(jfmt)
    for name in ("get_input_frame_length", "get_output_frame_length", "get_input_byte_length"):
        assert getattr(enc, name)() == getattr(jenc, name)(), name
    n = enc.get_input_frame_length()
    rng = np.random.default_rng(rate + channels)
    for i in range(4):
        x = rng.integers(-20000, 20000, n).astype("<i2")
        if i % 2:
            got, want = enc.encode_and_resample(x.tobytes()), jenc.encode_and_resample(x.tobytes())
        else:
            got, want = enc.rencode_and_resample(x), jenc.rencode_and_resample(x)
        np.testing.assert_array_equal(got, want)
    enc.reset()
    jenc.reset()
    np.testing.assert_array_equal(enc.rencode_and_resample(x), jenc.rencode_and_resample(x))


@pytest.mark.parametrize("rate, samples", [(16000, 480), (48000, 1440), (44100, 1323)])
def test_in_graph_resample_sizes_the_chunk_as_jax(rate, samples):
    feats = {"a": np.ones((6, 5), np.float32)}
    ww = WakewordRef(name="x", samples_features=feats, rms_level=0.05)
    jww = JaxWakewordRef(name="x", samples_features=feats, rms_level=0.05)
    cfg, jcfg = RustpotterConfig(), JaxConfig()
    cfg.fmt.sample_rate = jcfg.fmt.sample_rate = rate
    static, _ = build_bundle([("w", ww)], cfg, "cpu", in_graph_resample=True)
    jstatic, _ = jax_build_bundle([("w", jww)], jcfg, in_graph_resample=True)
    assert (static.input_samples, static.input_rate) == (jstatic.input_samples,
                                                         jstatic.input_rate)
    assert static.input_samples == samples
    plain, _ = build_bundle([("w", ww)], cfg, "cpu")
    assert (plain.input_samples, plain.input_rate) == (480, 16000)
