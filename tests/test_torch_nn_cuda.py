"""The port's NN wakewords and its wide-band routing on a CUDA card, against
the same calls on the CPU. Every test here needs a card (and nvcc, which
builds the DTW kernels at first use); without one they skip. The file
imports no JAX:

    python -m pytest tests/test_torch_nn_cuda.py -m cuda --noconftest -q

  - `nn_medium` (the firing MEDIUM classifier alone) and `mixed` (the bench
    DTW wakeword beside it): BatchedDetector chunks at B = 64 on the card,
    streams 0-3 against a B = 4 run on the CPU; K1 launches once per chunk
    with the DTW wakeword and never without it;
  - bands 21 and 24, past K1's and K2's shared-memory rings (K4's column
    form): BatchedDetector, make_step and Rustpotter on the card, each
    graphed, route to K4 (3 launches per chunk or frame, no K1 or K2) and
    give the CPU run's events (B = 64 on a 30-frame bench wakeword, and
    make_step at the bench's B = 8192 on the 100-frame one).

Events equal (fired, ww, counter); scores rtol 1e-4 / atol 1e-3 with an NN
wakeword (its logits), rtol 2e-5 / atol 2e-5 for DTW alone.
"""
import copy

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import Rustpotter, RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector
from rustpotter_tpu_torch.runtime.graph import GraphedStep
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_step
from rustpotter_tpu_torch.synthetic import (
    build_bench_wakeword,
    build_firing_nn_wakeword,
    correctness_stream,
)

NN_TOL = dict(rtol=1e-4, atol=1e-3)
DTW_TOL = dict(rtol=2e-5, atol=2e-5)
B_CARD = 64
BENCH_B = 8192  # the bench's streams


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no CPU build")
    return torch.device("cuda")


def _config(band=5):
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    cfg.detector.band_size = band
    return cfg


def _run(process, static, b, device, stream0):
    """Events (numpy, (T, 4)) of streams 0-3: stream 0 plays stream0, the
    others seeded noise."""
    noise = np.random.default_rng(0).normal(0, 0.05, (b, 480)).astype(np.float32)
    states = init_state(static, b, device)
    out = []
    for t in range(stream0.shape[0]):
        frames = noise.copy()
        frames[0] = stream0[t]
        states, ev = process(states, torch.tensor(frames, device=device))
        out.append([f[:4].cpu().numpy() for f in ev])
    return [np.stack(f) for f in zip(*out)]


def _assert_events_equal(got, want, tol):
    for j in (0, 1, 4):  # fired, ww, counter
        np.testing.assert_array_equal(got[j], want[j])
    fired = want[0]
    assert fired[:, 0].any(), "stream 0 did not fire"
    for j in (2, 3, 6):  # score, avg_score, scores
        np.testing.assert_allclose(got[j][fired], want[j][fired], **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["nn_medium", "mixed"])
def test_nn_chunks_on_card_match_cpu(cuda_device, cell):
    ww, utterance = build_bench_wakeword(device="cpu")
    firing = build_firing_nn_wakeword(utterance, device="cpu")
    wws = [("n", firing)] if cell == "nn_medium" else [("w", ww), ("n", firing)]
    stream0 = correctness_stream(firing.train_size, utterance)
    events = {}
    for dev, b in ((cuda_device, B_CARD), ("cpu", 4)):
        det = BatchedDetector(wws, _config(), batch_size=b, device=dev)
        before = fd.LAUNCHES["fused_dtw_v4"]
        events[str(dev)] = _run(lambda s, f: det.process_chunk(det.params, s, f), det.static,
                                b, dev, stream0)
        if dev != "cpu":
            torch.cuda.synchronize()
            k1 = fd.LAUNCHES["fused_dtw_v4"] - before
            assert k1 == (len(stream0) if cell == "mixed" else 0)
    _assert_events_equal(events["cuda"], events["cpu"], NN_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("path, b", [pytest.param(p, B_CARD, id=p)
                                     for p in ("BatchedDetector", "make_step", "Rustpotter")]
                         + [pytest.param("make_step", BENCH_B, id=f"make_step-{BENCH_B}")])
@pytest.mark.parametrize("band", [21, 24])
def test_wide_bands_route_to_k4_on_card(cuda_device, band, path, b):
    longest = 30 if b == B_CARD else 100
    ww, utterance = build_bench_wakeword(device="cpu", longest=longest)
    cfg = _config(band)
    stream0 = correctness_stream(longest, utterance)
    results = {}
    for dev, b in ((cuda_device, b), ("cpu", 4)):
        before = dict(fd.LAUNCHES)
        if path == "Rustpotter":
            rp = Rustpotter(copy.deepcopy(cfg), device=dev)
            rp.add_wakeword("w", ww)
            assert rp._static.dtw_k4_for_band
            results[str(dev)] = [(i, d.counter, d.score) for i, frame in enumerate(stream0)
                                 if (d := rp.process_samples(frame)) is not None]
        else:
            det = BatchedDetector([("w", ww)], cfg, batch_size=b, device=dev)
            assert det.static.dtw_k4_for_band and det.static.dtw_fused_variant == 2
            process = (lambda s, f: det.process_chunk(det.params, s, f)) \
                if path == "BatchedDetector" else \
                (lambda s, f, step=GraphedStep(make_step(det.static)): step(det.params, s, f))
            results[str(dev)] = _run(process, det.static, b, dev, stream0)
        if dev != "cpu":
            torch.cuda.synchronize()
            launched = {k: v - before[k] for k, v in fd.LAUNCHES.items()}
            assert launched == {"fused_dtw_v4": 0, "fused_dtw_v3": 0,
                                "fused_dtw_v2": 3 * len(stream0), "fused_dtw_v1": 0}
    if path == "Rustpotter":
        got, want = results["cuda"], results["cpu"]
        assert want and [g[:2] for g in got] == [w[:2] for w in want]
        np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], **DTW_TOL)
    else:
        _assert_events_equal(results["cuda"], results["cpu"], DTW_TOL)
