"""NN wakewords in the batched serving chunk and the per-shift step of the
PyTorch port (device="cpu") against the JAX package on the CPU, chunk by
chunk: an NN-only bundle of a random SMALL model (train_size 30), an
NN-only bundle of the firing MEDIUM model (`synthetic.build_firing_nn_wakeword`,
train_size 168), and `mixed`, the bench DTW wakeword beside the firing
model. Stream 0 plays the bench utterance (`correctness_stream`), the other
streams seeded noise. Also: a JAX `mixed` fleet's parameters and states,
carried across as numpy (`runtime.convert`), continue in the port with the
JAX run's events, and neither the chunk nor the step reads a tensor back to
the host (`torch.Tensor.item` patched to raise).

Events must be equal (fired, ww, counter); scores where an event fired, and
the partial scores and logits of every chunk, within rtol 1e-4 / atol 1e-3
(measured on the CPU in the batched runs: max |d| 9.2e-5 of the event
scores and the logits, on logits up to 40). The random SMALL model never
fires here, so its bundle pins the no-event path and the window.
"""
from dataclasses import fields

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.runtime.bundle import StepParams as JaxStepParams
from rustpotter_tpu.runtime.bundle import build_bundle as jax_build_bundle
from rustpotter_tpu.runtime.state import init_state as jax_init_state
from rustpotter_tpu.runtime.state import state_batch_axes
from rustpotter_tpu.runtime.stream_step import make_step as jax_make_step
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.convert import (
    params_from_numpy,
    states_from_numpy,
    states_to_numpy,
)
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_step
from rustpotter_tpu_torch.synthetic import build_firing_nn_wakeword, correctness_stream
from rustpotter_tpu_torch.wakewords import nn
from rustpotter_tpu_torch.wakewords.files import ModelType, WakewordModel, WakewordRef
from test_torch_nn import jax_model

torch.set_num_threads(2)

B = 4
NN_TOL = dict(rtol=1e-4, atol=1e-3)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)
EXACT_STATE = ("win_count", "ext_count", "partial_active", "partial_ww",
               "partial_counter", "countdown", "vad_countdown", "rot")
CLOSE_STATE = ("partial_score", "partial_avg", "partial_scores", "rms_level")


@pytest.fixture(scope="module")
def words():
    """{name: (port wakeword, JAX wakeword)} and the bench utterance."""
    jww, utterance = bench.build_bench_wakeword()
    ww = WakewordRef(name=jww.name, samples_features=dict(jww.samples_features),
                     avg_features=jww.avg_features, rms_level=jww.rms_level)
    firing = build_firing_nn_wakeword(utterance, device="cpu")
    params = nn.init_params(ModelType.SMALL, 30 * 16, 16, 3, seed=21)
    small = WakewordModel(labels=["x", "none", "y"], train_size=30, mfcc_size=16,
                          m_type=ModelType.SMALL, weights=nn.params_to_tensor_data(params),
                          rms_level=0.05)
    out = {"dtw": (ww, jww)}
    out.update({k: (m, jax_model(m)) for k, m in (("firing", firing), ("small", small))})
    return out, utterance


BUNDLES = {"nn_small": ("small",), "nn_firing": ("firing",), "mixed": ("dtw", "firing")}


def _configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    return jcfg, cfg


def _frames(F, utterance, seed=5):
    stream0 = correctness_stream(F, utterance)
    frames = np.random.default_rng(seed).normal(0, 0.05, (len(stream0), B, 480))
    frames = frames.astype(np.float32)
    frames[:, 0] = stream0
    return frames


def _numpy(nt) -> dict:
    return {f: np.asarray(getattr(nt, f)) for f in nt._fields}


@pytest.fixture(scope="module")
def jax_runs(words):
    """Per bundle: (JAX detector, frames, per-chunk events, per-chunk states)."""
    wws, utterance = words
    out = {}
    for name, keys in BUNDLES.items():
        det = JaxBatchedDetector([(k, wws[k][1]) for k in keys], _configs()[0], batch_size=B)
        frames = _frames(det.static.max_mfcc_frames, utterance)
        states = det.init_states()
        events, snaps = [], []
        for t in range(frames.shape[0]):
            states, ev = det.process_chunk(det.params, states, jnp.asarray(frames[t]))
            events.append(_numpy(ev))
            snaps.append(_numpy(states))
        out[name] = (det, frames, events, snaps)
    return out


def _assert_event_equal(got, want, t):
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    fired = want["fired"]
    for f in ("score", "avg_score", "scores", "gain"):
        np.testing.assert_allclose(got[f][fired], want[f][fired], **NN_TOL,
                                   err_msg=f"chunk {t} {f}")


def _assert_state_equal(got, want, t):
    for f in EXACT_STATE:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
    for f in CLOSE_STATE:
        np.testing.assert_allclose(got[f], want[f], **NN_TOL, err_msg=f"chunk {t} {f}")
    np.testing.assert_allclose(got["win"], want["win"], **WIN_TOL, err_msg=f"chunk {t} win")


def _compare(process, states, frames, events, snaps, t0=0):
    """Runs process(states, frames[t]) from chunk t0 on, holding every chunk
    to the JAX run. Returns the events' (chunk, stream, score) where fired."""
    fires = []
    for t in range(t0, frames.shape[0]):
        states, ev = process(states, torch.tensor(frames[t]))
        got = events_to_numpy(ev)._asdict()
        _assert_event_equal(got, events[t], t)
        _assert_state_equal(states_to_numpy(states), snaps[t], t)
        fires += [(t, b, float(got["score"][b])) for b in np.nonzero(got["fired"])[0]]
    return fires


def _assert_fires_clear_threshold(fires, stream0_fires=1):
    """Stream 0 fires; every fired score clears the 0.5 threshold by more
    than 10 times the score tolerance."""
    assert sum(b == 0 for _, b, _ in fires) == stream0_fires
    for t, b, score in fires:
        assert score - 0.5 > 10 * (NN_TOL["atol"] + NN_TOL["rtol"] * abs(score)), (t, b, score)


@pytest.mark.parametrize("bundle", list(BUNDLES))
def test_batched_detector_matches_jax(words, jax_runs, bundle):
    wws, _ = words
    jdet, frames, events, snaps = jax_runs[bundle]
    det = BatchedDetector([(k, wws[k][0]) for k in BUNDLES[bundle]], _configs()[1],
                          batch_size=B, device="cpu")
    assert det.wakeword_names == jdet.wakeword_names
    assert det.static.smax == jdet.static.smax
    before = dict(fd.LAUNCHES)
    fires = _compare(lambda s, f: det.process_chunk(det.params, s, f), det.init_states(),
                     frames, events, snaps)
    assert fd.LAUNCHES == before  # plain versions on the CPU
    if bundle != "nn_small":
        _assert_fires_clear_threshold(fires)
        # the NN wakeword names the event: its score beats the DTW one
        assert {det.wakeword_names[int(events[t]["ww"][b])] for t, b, _ in fires} == {"firing"}


@pytest.mark.parametrize("bundle", ["nn_firing", "mixed"])
def test_make_step_matches_jax_vmapped_step(words, jax_runs, bundle):
    """The per-shift step against `jax.vmap(make_step(static))`, chunk by
    chunk: it is held to its own counterpart, since the batched chunk's
    window rows lag the per-shift step's by one shift in both packages."""
    wws, _ = words
    keys = BUNDLES[bundle]
    _, frames, _, _ = jax_runs[bundle]
    jstatic, jparams = jax_build_bundle([(k, wws[k][1]) for k in keys], _configs()[0])
    jparams = jax.tree_util.tree_map(jnp.asarray, jparams)
    axes = state_batch_axes()
    jstep = jax.jit(jax.vmap(jax_make_step(jstatic), in_axes=(None, axes, 0),
                             out_axes=(axes, 0)))
    jstates = jax_init_state(jstatic, (B,))
    static, params = build_bundle([(k, wws[k][0]) for k in keys], _configs()[1], "cpu")
    step = make_step(static)
    states = init_state(static, B, "cpu")
    fires = []
    for t in range(frames.shape[0]):
        jstates, jev = jstep(jparams, jstates, jnp.asarray(frames[t]))
        states, ev = step(params, states, torch.tensor(frames[t]))
        got = events_to_numpy(ev)._asdict()
        _assert_event_equal(got, _numpy(jev), t)
        want = _numpy(jstates)
        want["win"] = np.transpose(want["win"], (1, 2, 0))
        _assert_state_equal(states_to_numpy(states), want, t)
        fires += [(t, b, float(got["score"][b])) for b in np.nonzero(got["fired"])[0]]
    _assert_fires_clear_threshold(fires)


def test_continue_from_jax_mixed_states(words, jax_runs):
    """A JAX mixed fleet's StepParams (NN weights included) and states after
    N chunks, carried into the port as numpy, give the events JAX gives when
    it continues."""
    wws, _ = words
    jdet, frames, events, snaps = jax_runs["mixed"]
    n = 70  # the window is full, the utterance not yet detected
    d = {f: np.asarray(getattr(jdet.params, f)) for f in JaxStepParams._FIELDS
         if f != "nn_params"}
    d["nn_params"] = [[(np.asarray(w), np.asarray(b)) for w, b in layers]
                      for layers in jdet.params.nn_params]
    params = params_from_numpy(d, device="cpu")
    det = BatchedDetector([(k, wws[k][0]) for k in BUNDLES["mixed"]], _configs()[1],
                          batch_size=B, device="cpu")
    for layers, mine in zip(params.nn_params, det.params.nn_params):
        for (w, b), (w2, b2) in zip(layers, mine):
            assert torch.equal(w, w2) and torch.equal(b, b2)
    for f in fields(params):
        if f.name != "nn_params":
            assert torch.equal(getattr(params, f.name), getattr(det.params, f.name)), f.name
    states = states_from_numpy(snaps[n - 1], device="cpu")
    assert not snaps[n - 1]["partial_active"].any()
    fires = _compare(lambda s, f: det.process_chunk(params, s, f), states, frames, events,
                     snaps, t0=n)
    _assert_fires_clear_threshold(fires)


def test_chunk_and_step_never_read_back_to_the_host(words, monkeypatch):
    """One chunk and one step of `mixed` with Tensor.item raising: the
    cursor, the NN rotation index and the slots stay on the device."""
    wws, utterance = words
    det = BatchedDetector([(k, wws[k][0]) for k in BUNDLES["mixed"]], _configs()[1],
                          batch_size=B, device="cpu")
    step = make_step(det.static)
    frames = _frames(det.static.max_mfcc_frames, utterance)
    s1, s2 = det.init_states(), init_state(det.static, B, "cpu")

    def item(self):
        raise AssertionError("a host read inside the chunk or the step")

    monkeypatch.setattr(torch.Tensor, "item", item)
    for t in (0, 1):  # the first call builds the parameter set's constants
        det.process_chunk(det.params, s1, frames[t])
        step(det.params, s2, torch.tensor(frames[t]))
    with pytest.raises(AssertionError, match="host read"):
        s1.rot.item()
