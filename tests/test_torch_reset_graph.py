"""`BatchedDetector.reset_streams` of the PyTorch port (`runtime/batch.py`
`make_reset`) on the CPU, against the JAX package's jitted `_reset_streams`
(`rustpotter_tpu/runtime/batch.py:212,339-364`):

  (a) after 20 chunks of the bench correctness audio at B = 4, the port's
      reset and JAX's `reset_streams` on the same states (the port's, as
      numpy) give every field but `win` bit for bit, and `win` is left as
      it was; a mixed mask, an all-true mask and an all-false mask;
  (b) a CPU call runs eagerly: no graph is kept and nothing is captured,
      the states keep their storage, and no `init_state` runs per call (the
      fresh values are made once per bundle);
  (c) the reset reads nothing on the host, as a capture needs.
The graph itself runs on the card: tests/test_torch_lifecycle_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.runtime.state import StreamState as JaxStreamState
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.runtime import batch
from rustpotter_tpu_torch.runtime.batch import BatchedDetector
from rustpotter_tpu_torch.runtime.convert import states_to_numpy
from rustpotter_tpu_torch.runtime.state import StreamState
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

torch.set_num_threads(2)

B = 4
CHUNKS = 20
MASKS = {"mixed": [True, False, True, False], "all": [True] * B, "none": [False] * B}


@pytest.fixture(scope="module")
def workload():
    """(the port's 30-frame bench wakeword, the JAX package's copy, frames
    (T, B, 480): stream 0 the utterance, the rest seeded noise)."""
    ww, utterance = build_bench_wakeword(device="cpu", longest=30)
    jww = JaxWakewordRef(name=ww.name, samples_features=dict(ww.samples_features),
                         avg_features=ww.avg_features, rms_level=ww.rms_level)
    stream0 = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(11).normal(0, 0.05, (len(stream0), B, 480)).astype(np.float32)
    frames[:, 0] = stream0
    return ww, jww, frames


def _configs():
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    return jcfg, cfg


def _played(ww, frames):
    det = BatchedDetector([("w", ww)], _configs()[1], batch_size=B, device="cpu")
    states = det.init_states()
    for t in range(CHUNKS):
        states, _ = det.process_chunk(det.params, states, frames[t])
    return det, states


@pytest.mark.parametrize("mask", list(MASKS))
def test_reset_streams_matches_jax(workload, mask):
    ww, jww, frames = workload
    det, states = _played(ww, frames)
    before = states_to_numpy(states)
    m = np.array(MASKS[mask])
    jdet = JaxBatchedDetector([("w", jww)], _configs()[0], batch_size=B)
    jstates = JaxStreamState(**{f: jnp.asarray(v) for f, v in before.items()})
    want = {f: np.asarray(v) for f, v in zip(JaxStreamState._fields,
                                             jdet.reset_streams(jstates, jnp.asarray(m)))}
    assert det.reset_streams(states, m) is states
    got = states_to_numpy(states)
    for f in StreamState._fields:
        assert got[f].dtype == want[f].dtype, f
        if got[f].dtype.kind == "f":  # bits: NaN (unfilled VAD, partial gain) included
            got[f], want[f] = got[f].view(np.int32), want[f].view(np.int32)
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    np.testing.assert_array_equal(got["win"], before["win"].view(np.int32))
    changed = [f for f in StreamState._fields if not np.array_equal(
        states_to_numpy(states)[f], before[f], equal_nan=True)]
    assert bool(changed) == m.any(), changed  # 20 chunks left something to clear


def test_a_cpu_reset_runs_eagerly_and_keeps_no_graph(workload, monkeypatch):
    ww, _, frames = workload
    det, states = _played(ww, frames)
    made = []
    real = batch.init_state
    monkeypatch.setattr(batch, "init_state", lambda *a: made.append(a) or real(*a))
    ptrs = [t.data_ptr() for t in states]
    for mask in MASKS.values():
        det.reset_streams(states, np.array(mask))
    assert made == []  # the fresh values were made once, with the bundle
    assert [t.data_ptr() for t in states] == ptrs
    assert det._reset.captures == 0 and det._reset._graph is None
    fresh = det.init_states()
    for f, a, b in zip(StreamState._fields, states, fresh):
        if f not in ("win", "rot"):
            assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                               b.view(torch.int32) if b.dtype == torch.float32 else b), f
    # a rebuild makes a new reset, with the new bundle's fresh values
    old, n = det._reset, len(made)
    states = det.add_wakeword("v", ww, states)
    assert det._reset is not old and len(made) == n + 2  # migrate_states and make_reset


def test_the_reset_reads_nothing_on_the_host(workload, monkeypatch):
    ww, _, frames = workload
    det, states = _played(ww, frames)
    reset = batch.make_reset(det.static, torch.device("cpu"))
    mask = torch.tensor(MASKS["mixed"])

    def host_read(self, *args, **kwargs):
        raise AssertionError("a host read inside the reset")

    for name in ("item", "tolist", "numpy", "__bool__", "__int__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    assert reset(det.params, states, mask) == (states, ())
