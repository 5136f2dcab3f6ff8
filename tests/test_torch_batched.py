"""The slice end to end: the PyTorch port's BatchedDetector (device="cpu",
where K1 runs its plain version) against the JAX BatchedDetector on the CPU,
chunk by chunk, on the bench wakeword and the audio of bench.correctness_pass
(stream 0 plays the utterance, the other streams seeded noise).

Detection decisions must be equal (fired, ww, counter); scores are compared
where an event fired at rtol 2e-5 / atol 2e-5 (the two sides differ in fp32
summation order: MFCC GEMMs, CMN means, K1's cost band vs the JAX scan path).
"""
import dataclasses
from dataclasses import fields

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu import VADMode as JaxVADMode
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode, VADMode
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime import stream_step
from rustpotter_tpu_torch.runtime.bundle import StepParams
from rustpotter_tpu_torch.runtime.convert import (
    params_from_numpy,
    states_from_numpy,
    states_to_numpy,
)
from rustpotter_tpu_torch.runtime.state import StreamState
from rustpotter_tpu_torch.synthetic import correctness_stream
from rustpotter_tpu_torch.wakewords.files import WakewordRef

torch.set_num_threads(2)

B = 4
EV_TOL = dict(rtol=2e-5, atol=2e-5)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)  # MFCC rows, |mfcc| up to ~30
EXACT_STATE = ("win_count", "ext_count", "partial_active", "partial_ww",
               "partial_counter", "countdown", "vad_countdown", "rot")
CLOSE_STATE = ("partial_score", "partial_avg", "partial_scores", "rms_level")


@pytest.fixture(scope="module")
def workload():
    """(JAX bench wakeword, the port's copy of it, frames (T, B, 480))."""
    jww, utterance = bench.build_bench_wakeword()
    ww = WakewordRef(name=jww.name, samples_features=dict(jww.samples_features),
                     avg_features=jww.avg_features, rms_level=jww.rms_level)
    stream0 = correctness_stream(max(len(m) for m in jww.samples_features.values()), utterance)
    rng = np.random.default_rng(5)
    frames = rng.normal(0, 0.05, (len(stream0), B, 480)).astype(np.float32)
    frames[:, 0] = stream0
    return jww, ww, frames


def _configs(vad=None):
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    if vad is not None:
        jcfg.detector.vad_mode, cfg.detector.vad_mode = JaxVADMode(vad), VADMode(vad)
    return jcfg, cfg


def _jax_numpy(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


def _run_jax(jww, frames, vad=None):
    """Per-chunk events and states (numpy dicts) of the JAX detector, plus
    the detector itself."""
    det = JaxBatchedDetector([("w", jww)], _configs(vad)[0], batch_size=B)
    states = det.init_states()
    events, snaps = [], []
    for t in range(frames.shape[0]):
        states, ev = det.process_chunk(det.params, states, jnp.asarray(frames[t]))
        events.append(_jax_numpy(ev))
        snaps.append(_jax_numpy(states))
    return det, events, snaps


@pytest.fixture(scope="module")
def jax_run(workload):
    jww, _, frames = workload
    return _run_jax(jww, frames)


def _assert_event_equal(got, want, t):
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    fired = want["fired"]
    for f in ("score", "avg_score", "scores", "gain"):
        np.testing.assert_allclose(got[f][fired], want[f][fired], **EV_TOL,
                                   err_msg=f"chunk {t} {f}")


def _assert_state_equal(got, want, t):
    for f in EXACT_STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    for f in CLOSE_STATE:
        np.testing.assert_allclose(got[f], want[f], **EV_TOL, err_msg=f"chunk {t} {f}")
    np.testing.assert_allclose(got["win"], want["win"], **WIN_TOL, err_msg=f"chunk {t} win")
    np.testing.assert_array_equal(np.isnan(got["vad_win"]), np.isnan(want["vad_win"]))


def _compare_runs(det, states, frames, events, snaps, t0=0, params=None):
    params = det.params if params is None else params
    fired0 = 0
    for t in range(t0, frames.shape[0]):
        states, ev = det.process_chunk(params, states, frames[t])
        got = events_to_numpy(ev)._asdict()
        _assert_event_equal(got, events[t], t)
        _assert_state_equal(states_to_numpy(states), snaps[t], t)
        fired0 += int(got["fired"][0])
    return fired0


@pytest.mark.parametrize("vad", [None, "easy"])
def test_batched_detector_matches_jax_chunk_by_chunk(workload, jax_run, vad):
    jww, ww, frames = workload
    _, events, snaps = jax_run if vad is None else _run_jax(jww, frames, vad)
    det = BatchedDetector([("w", ww)], _configs(vad)[1], batch_size=B, device="cpu")
    fired0 = _compare_runs(det, det.init_states(), frames, events, snaps)
    assert fired0 >= 1  # stream 0 fires in both (events are equal)


def test_continue_from_jax_states(workload, jax_run):
    """JAX states after N chunks, carried into the port, give the events
    JAX gives when it continues."""
    _, _, frames = workload
    jdet, events, snaps = jax_run
    n = 60  # before the utterance's detection
    params = params_from_numpy(
        {f.name: np.asarray(getattr(jdet.params, f.name)) for f in fields(StepParams)},
        device="cpu",
    )
    states = states_from_numpy(snaps[n - 1], device="cpu")
    back = states_to_numpy(states)
    for f in StreamState._fields:
        np.testing.assert_array_equal(back[f], snaps[n - 1][f], err_msg=f)
    det = BatchedDetector([("w", _port_ww(jdet))], _configs()[1], batch_size=B, device="cpu")
    assert _params_equal(params, det.params)
    assert _compare_runs(det, states, frames, events, snaps, t0=n, params=params) >= 1


def _port_ww(jdet):
    jww = jdet._wakewords[0][1]
    return WakewordRef(name=jww.name, samples_features=dict(jww.samples_features),
                       avg_features=jww.avg_features, rms_level=jww.rms_level)


def _params_equal(a: StepParams, b: StepParams) -> bool:
    nn = lambda p: [t for layer in p.nn_params for wb in layer for t in wb]
    return len(nn(a)) == len(nn(b)) and all(torch.equal(x, y) for x, y in zip(nn(a), nn(b))) \
        and all(torch.equal(getattr(a, f.name), getattr(b, f.name))
                for f in fields(StepParams) if f.name != "nn_params")


def test_process_sequence_equals_process_chunk(workload):
    _, ww, frames = workload
    det = BatchedDetector([("w", ww)], _configs()[1], batch_size=B, device="cpu")
    n = 12
    s1, chunk_events = det.init_states(), []
    for t in range(n):
        s1, ev = det.process_chunk(det.params, s1, frames[t])
        chunk_events.append(ev)
    s2, seq_events = det.process_sequence(det.params, det.init_states(), frames[:n])
    for f, got in zip(seq_events._fields, seq_events):
        torch.testing.assert_close(got, torch.stack([getattr(e, f) for e in chunk_events]),
                                   rtol=0, atol=0, equal_nan=True)
    for a, b in zip(s1, s2):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_chunk_constants_built_once_per_parameter_set(workload, monkeypatch):
    """The template set and gate bounds are built when a parameter set is
    first seen, not per chunk; an equal new StepParams object rebuilds them
    and gives the same events."""
    _, ww, frames = workload
    built = []
    real = stream_step.chunk_constants
    monkeypatch.setattr(stream_step, "chunk_constants",
                        lambda static, params: built.append(params) or real(static, params))
    det = BatchedDetector([("w", ww)], _configs()[1], batch_size=B, device="cpu")
    _, ev1 = det.process_sequence(det.params, det.init_states(), frames[:4])
    assert built == [det.params]
    params = dataclasses.replace(det.params)
    _, ev2 = det.process_sequence(params, det.init_states(), frames[:4])
    assert len(built) == 2 and built[1] is params
    for a, b in zip(ev1, ev2):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def test_reset_streams_clears_masked_streams(workload):
    _, ww, frames = workload
    det = BatchedDetector([("w", ww)], _configs()[1], batch_size=B, device="cpu")
    states = det.init_states()
    for t in range(40):
        states, _ = det.process_chunk(det.params, states, frames[t])
    before = states_to_numpy(states)
    mask = np.array([True, False, True, False])
    out = det.reset_streams(states, mask)
    assert out is states  # in place
    after, fresh = states_to_numpy(states), states_to_numpy(det.init_states())
    for f in StreamState._fields:
        if f in ("win", "rot"):  # stale window on purpose; shared cursor
            np.testing.assert_array_equal(after[f], before[f])
            continue
        np.testing.assert_array_equal(after[f][mask], fresh[f][mask], err_msg=f)
        np.testing.assert_array_equal(after[f][~mask], before[f][~mask], err_msg=f)
    assert before["ext_count"][mask].min() > 0  # the reset changed something


def test_default_device_is_cuda_and_never_falls_back(workload, monkeypatch):
    _, ww, _ = workload
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        BatchedDetector([("w", ww)], _configs()[1], batch_size=B)


@pytest.mark.parametrize("what", ["gain", "band_pass", "resample"])
def test_filter_and_resample_configs_match_jax(workload, what):
    """The configs the port once refused: the gain normalizer, the
    band-pass, and in_graph_resample at 16 kHz (which keeps the 480-sample
    chunk, as in the JAX package), over 12 chunks against the JAX detector.
    tests/test_torch_filters.py and tests/test_torch_front_48k.py hold them
    over whole streams."""
    jww, ww, frames = workload
    jcfg, cfg = _configs()
    kw = {}
    if what == "gain":
        jcfg.filters.gain_normalizer.enabled = cfg.filters.gain_normalizer.enabled = True
    elif what == "band_pass":
        jcfg.filters.band_pass.enabled = cfg.filters.band_pass.enabled = True
    else:
        kw["in_graph_resample"] = True
    jdet = JaxBatchedDetector([("w", jww)], jcfg, batch_size=B, **kw)
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device="cpu", **kw)
    assert det.static.input_samples == jdet.static.input_samples == 480
    jstates, states = jdet.init_states(), det.init_states()
    for t in range(12):
        jstates, jev = jdet.process_chunk(jdet.params, jstates, jnp.asarray(frames[t]))
        states, ev = det.process_chunk(det.params, states, frames[t])
        _assert_event_equal(events_to_numpy(ev)._asdict(), _jax_numpy(jev), t)
        got, want = states_to_numpy(states), _jax_numpy(jstates)
        _assert_state_equal(got, want, t)
        np.testing.assert_array_equal(got["gain"], want["gain"])
        # the JAX package's scan contracts products into FMAs: see
        # tests/test_torch_filters.py
        np.testing.assert_allclose(got["bp"], want["bp"], rtol=0, atol=1e-5)
