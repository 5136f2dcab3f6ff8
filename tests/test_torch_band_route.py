"""The band → DTW kernel choice of the PyTorch port's bundle, on the CPU.

K1's and K2's rings and K3's tile grow with the band; where the requested
mode's kernels cannot take it, `build_bundle` takes K4 (fused, variant 2),
whose column and row forms take every band past its ring form. The choice is static, so the CPU runs the
mode it chose through K4's plain version, and the events are the JAX
package's (which serves every band): BatchedDetector and make_step at band
21 and 24 against JAX, events equal and scores at rtol 2e-5 / atol 2e-5 (the
DTW event tolerance of test_torch_batched.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu import ScoreMode as JaxScoreMode
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.wakewords.files import WakewordRef as JaxWakewordRef
from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch import _build
from rustpotter_tpu_torch.mfcc.averager import average_templates
from rustpotter_tpu_torch.mfcc.offline import mfcc_pipeline
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.bundle import build_bundle, choose_dtw_kernels
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_step
from rustpotter_tpu_torch.synthetic import correctness_stream
from rustpotter_tpu_torch.wakewords.files import WakewordRef

torch.set_num_threads(2)

B = 4
EV_TOL = dict(rtol=2e-5, atol=2e-5)
BANDS = (2, 5, 19, 20, 21, 24, 75, 76, 120)


def _k1_k2_fit(w, c):
    return max(fd.k1_smem_bytes(w, c), fd.k2_smem_bytes(w, c)) <= _build.SMEM_OPTIN


@pytest.mark.parametrize("c", [5, 8, 16, 40])
def test_band_chooses_the_kernels_that_take_it(c):
    # the limits as the byte functions give them: K2 to w = 20 at every C
    # (its ring does not depend on C), K1 to w = 20 at C = 5 and 8, 19 at C
    # = 16 and 18 at C = 40 (its staged E tiles and T' rows grow with C), K3
    # to w = 75
    limit = {5: 20, 8: 20, 16: 19, 40: 18}[c]
    assert max(w for w in range(2, 200) if _k1_k2_fit(w, c)) == limit
    assert bd.W_MAX == 75
    for w in BANDS:
        k4 = (True, 2, True)
        assert choose_dtw_kernels(w, c, None, 3) == ((None, 3, False) if w <= limit else k4)
        assert choose_dtw_kernels(w, c, True, 3) == ((True, 3, False) if w <= limit else k4)
        assert choose_dtw_kernels(w, c, None, 2) == (None, 2, False)
        assert choose_dtw_kernels(w, c, False, 3) == ((False, 3, False) if w <= 75 else k4)


@pytest.mark.parametrize("env,band,want", [
    ({}, 20, (None, 3, False)),
    ({}, 21, (True, 2, True)),
    ({"RUSTPOTTER_FUSED": "0"}, 75, (False, 3, False)),
    ({"RUSTPOTTER_FUSED": "0"}, 76, (True, 2, True)),
    ({"RUSTPOTTER_FUSED_VARIANT": "2"}, 24, (None, 2, False)),
])
def test_build_bundle_records_the_choice(env, band, want, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RustpotterConfig()
    cfg.detector.band_size = band
    ww = WakewordRef(name="x", samples_features={"a": np.ones((30, 8), np.float32)},
                     rms_level=0.05)
    static, _ = build_bundle([("x", ww)], cfg, "cpu")
    assert (static.dtw_fused, static.dtw_fused_variant, static.dtw_k4_for_band) == want


def _chirps():
    """3 seeded chirp utterances of 20, 18 and 16 MFCC frames (the
    per-shift test's small wakeword: the JAX package's CPU scan path costs
    seconds per chunk at the bench wakeword's 100-frame templates and band
    24)."""
    words = []
    for i in range(3):
        n = (20 - 2 * i + 3) * 160
        t = np.arange(n) / 16000.0
        rng = np.random.default_rng(200 + i)
        sig = 0.35 * np.sin(2 * np.pi * np.cumsum(300 + 1200 * t / t[-1]) / 16000.0)
        words.append((sig + 0.02 * rng.normal(size=n)).astype(np.float32))
    return words


@pytest.fixture(scope="module")
def workload():
    """(JAX wakeword, the port's copy, frames (T, B, 480)): stream 0 plays
    the utterance, the others seeded noise."""
    words = _chirps()
    feats = {f"s{i}.wav": mfcc_pipeline(w, 9, "cpu") for i, w in enumerate(words)}
    avg = average_templates([feats[k] for k in sorted(feats)])
    ww = WakewordRef(name="chirp", samples_features=feats, avg_features=avg, rms_level=0.05)
    jww = JaxWakewordRef(name="chirp", samples_features=dict(feats), avg_features=avg,
                         rms_level=0.05)
    stream0 = correctness_stream(20, words[0])
    frames = np.random.default_rng(5).normal(0, 0.05, (len(stream0), B, 480))
    frames = frames.astype(np.float32)
    frames[:, 0] = stream0
    return jww, ww, frames


def _configs(band):
    jcfg, cfg = JaxConfig(), RustpotterConfig()
    jcfg.detector.score_mode, cfg.detector.score_mode = JaxScoreMode.MAX, ScoreMode.MAX
    jcfg.detector.avg_threshold = cfg.detector.avg_threshold = 0.2
    jcfg.detector.band_size = cfg.detector.band_size = band
    return jcfg, cfg


@pytest.mark.parametrize("band", [21, 24])
def test_wide_bands_serve_with_the_jax_events(workload, band):
    """BatchedDetector and make_step at a band past K1's and K2's limits:
    both route to K4's plain version here and give the JAX batched
    detector's events (the per-shift step is held to them where they fire:
    the batched chunk's window lags its own by one shift, so its counters
    may differ)."""
    jww, ww, frames = workload
    jcfg, cfg = _configs(band)
    jdet = JaxBatchedDetector([("w", jww)], jcfg, batch_size=B)
    det = BatchedDetector([("w", ww)], cfg, batch_size=B, device="cpu")
    assert det.static.dtw_k4_for_band and det.static.dtw_fused_variant == 2
    step = make_step(det.static)
    jst, st, st1 = jdet.init_states(), det.init_states(), init_state(det.static, B, "cpu")
    before = {**fd.LAUNCHES, **bd.LAUNCHES}
    fired, step_fired = [], []
    for t in range(frames.shape[0]):
        jst, jev = jdet.process_chunk(jdet.params, jst, jnp.asarray(frames[t]))
        st, ev = det.process_chunk(det.params, st, frames[t])
        st1, ev1 = step(det.params, st1, torch.tensor(frames[t]))
        got = events_to_numpy(ev)._asdict()
        want = {f: np.asarray(getattr(jev, f)) for f in jev._fields}
        for f in ("fired", "ww", "counter"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f"chunk {t} {f}")
        m = want["fired"]
        for f in ("score", "avg_score", "scores"):
            np.testing.assert_allclose(got[f][m], want[f][m], **EV_TOL, err_msg=f"chunk {t} {f}")
        fired += [(t, b) for b in np.nonzero(m)[0]]
        step_fired += [(t, b) for b in np.nonzero(ev1.fired.numpy())[0]]
    assert {**fd.LAUNCHES, **bd.LAUNCHES} == before  # plain versions on the CPU
    assert (0 in {b for _, b in fired}) and [b for _, b in step_fired] == [b for _, b in fired]
