"""Bundle, wakeword files and the score-mode reduction of the PyTorch port
against the JAX package on the CPU: equal static configuration, equal
parameter arrays, byte-equal .rpw files, and equal reductions."""
import os
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu import VADMode as JaxVADMode
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.runtime.stream_step import _reduce_mode as jax_reduce_mode
from rustpotter_tpu.runtime.stream_step import sort_last_axis as jax_sort_last_axis
from rustpotter_tpu.wakewords.files import save_wakeword as jax_save_wakeword
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode, VADMode
from rustpotter_tpu_torch.runtime.bundle import StepParams, build_bundle
from rustpotter_tpu_torch.runtime.stream_step import _reduce_mode, sort_last_axis
from rustpotter_tpu_torch.wakewords.files import (
    WakewordRef,
    load_wakeword,
    save_wakeword,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def bench_ww():
    jww, _ = bench.build_bench_wakeword()
    return jww


def _port_ref(jww, cls=WakewordRef, **override):
    """A copy of a JAX WakewordRef as `cls` (default: the port's)."""
    kw = dict(
        name=jww.name, samples_features=dict(jww.samples_features),
        avg_features=jww.avg_features, threshold=jww.threshold,
        avg_threshold=jww.avg_threshold, rms_level=jww.rms_level,
    )
    return cls(**{**kw, **override})


@pytest.mark.parametrize("vad", [None, "medium"])
def test_build_bundle_matches_jax(bench_ww, vad):
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    for c in (jcfg, cfg):
        c.detector.avg_threshold = 0.2
        c.detector.min_scores = 3
    jcfg.detector.score_mode = JaxScoreMode.P75
    cfg.detector.score_mode = ScoreMode.P75
    if vad:
        jcfg.detector.vad_mode = JaxVADMode(vad)
        cfg.detector.vad_mode = VADMode(vad)
    other = JaxWakewordRef(
        name="other",
        samples_features={f"o{i}.wav": np.full((20 + i, 16), i, np.float32) for i in range(3)},
        avg_features=None, threshold=0.6, rms_level=0.1,
    )
    jstatic, jparams = jax_build_bundle([("w", bench_ww), ("o", other)], jcfg)
    static, params = build_bundle(
        [("w", _port_ref(bench_ww)), ("o", _port_ref(other))], cfg, device="cpu"
    )
    assert static.dtw_k4_for_band is False  # the port's record of the band's kernel
    for f in fields(static):
        if f.name == "dtw_k4_for_band":
            continue
        want = getattr(jstatic, f.name)
        got = getattr(static, f.name)
        if f.name == "score_mode":
            want, got = want.value, got.value
        assert got == want, f.name
    assert params.nn_params == jparams.nn_params == ()  # no NN wakeword here
    for f in fields(StepParams):
        if f.name == "nn_params":
            continue
        want = np.asarray(getattr(jparams, f.name))
        got = getattr(params, f.name).numpy()
        assert got.dtype == want.dtype, f.name
        np.testing.assert_array_equal(got, want, err_msg=f.name)


def test_wakeword_file_bytes_equal_and_round_trip(bench_ww, tmp_path):
    jpath, path = os.path.join(tmp_path, "j.rpw"), os.path.join(tmp_path, "t.rpw")
    jax_save_wakeword(_port_ref(bench_ww, JaxWakewordRef, threshold=0.55), jpath)
    ww = _port_ref(bench_ww, threshold=0.55)
    save_wakeword(ww, path)
    assert open(path, "rb").read() == open(jpath, "rb").read()
    back = load_wakeword(path)
    assert isinstance(back, WakewordRef)
    assert (back.name, back.mfcc_size, back.avg_threshold) == ("bench", 16, None)
    assert back.threshold == pytest.approx(0.55)
    for k, m in ww.samples_features.items():
        np.testing.assert_array_equal(back.samples_features[k], m)
    np.testing.assert_array_equal(back.avg_features, ww.avg_features)
    with pytest.raises(ValueError, match="Unable to decode wakeword file"):
        load_wakeword(b"\xff\x00garbage")


@pytest.mark.parametrize("mode", ["max", "average", "p75", "median"])
def test_reduce_mode_matches_jax(mode):
    rng = np.random.default_rng(2)
    scores = rng.uniform(0, 1, (9, 3, 5)).astype(np.float32)  # (B, D, K)
    kvalid = np.array([5, 3, 1], np.int32)
    got = _reduce_mode(torch.tensor(scores), torch.tensor(kvalid), ScoreMode(mode)).numpy()
    jmode = JaxScoreMode(mode)
    for b in range(scores.shape[0]):
        want = np.asarray(jax_reduce_mode(jnp.asarray(scores[b]), jnp.asarray(kvalid), jmode))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-7, err_msg=mode)


def test_sort_network_matches_jax():
    rng = np.random.default_rng(0)
    for k in range(1, 10):
        x = np.where(rng.random((65, k)) < 0.2, np.inf, rng.normal(size=(65, k))).astype(np.float32)
        np.testing.assert_array_equal(
            sort_last_axis(torch.tensor(x)).numpy(), np.asarray(jax_sort_last_axis(jnp.asarray(x)))
        )


def test_in_graph_resample_at_16k_keeps_the_480_sample_bundle(bench_ww):
    """At the detector's own rate the flag changes nothing, as in the JAX
    package (tests/test_torch_resample.py sizes the other rates)."""
    static, params = build_bundle([("w", _port_ref(bench_ww))], RustpotterConfig(),
                                  device="cpu", in_graph_resample=True)
    jstatic, _ = jax_build_bundle([("w", bench_ww)], JaxConfig(), in_graph_resample=True)
    assert (static.input_samples, static.input_rate) == (480, 16000)
    assert (jstatic.input_samples, jstatic.input_rate) == (480, 16000)
    plain, plain_params = build_bundle([("w", _port_ref(bench_ww))], RustpotterConfig(),
                                       device="cpu")
    assert static == plain
    for f in fields(StepParams):
        if f.name != "nn_params":
            torch.testing.assert_close(getattr(params, f.name), getattr(plain_params, f.name),
                                       rtol=0, atol=0, equal_nan=True, msg=f.name)
