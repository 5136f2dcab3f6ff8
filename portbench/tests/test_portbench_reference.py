"""The reference against the program on the CPU, at small sizes."""
import numpy as np
import pytest
import torch

from portbench import harness, synth, wakewords
from portbench.reference import detector as refdet
from portbench.reference.dtw import banded_dtw

TINY = {"streams": 8, "utterance_every": 4, "check_streams": 6, "check_utterance": 2,
        "check_near": 2, "profile_steps": 1}
STEPS = {"backlog": 5, "serve": 200}


def run_cpu(cell, seed=20261018, traced=False, **kw):
    traffic = dict(TINY, warmup_steps=STEPS[cell.split(".")[1]])
    return harness.run(cell, seed, 0.01, traced, 0.0, device="cpu", traffic=traffic, **kw)


@pytest.mark.parametrize("cell", ["dtw_bench.backlog", "nn_medium.backlog",
                                  "dtw_bench.serve", "nn_medium.serve"])
def test_program_matches_the_reference(cell):
    """Every sampled stream's reports and window rows, a firing stream among
    them, within the cell's limits; the run's fields are all there."""
    res = run_cpu(cell)
    assert res["checks"]["reference_fires"]["value"] >= 1
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] == 6 * res["chunks"]
    want = {"setup_s", "streams_rt.serve", "chunk_ms_p95"} if "serve" in cell else {"setup_s", "streams_rt"}
    assert set(res["metrics"]) == want


def test_traced_run_reads_its_metrics_without_a_card():
    res = run_cpu("dtw_bench.serve", traced=True)
    assert res["correct"]
    assert "api_host_ms.serve" in res["metrics"]
    assert "k1_roofline" not in res["metrics"]  # no device time on the CPU
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def numpy_banded(a, b, band):
    """rustpotter's banded DTW as a plain matrix loop."""
    m, n = len(a), len(b)
    w = max(band, abs(m - n))
    dp = np.full((m + 1, n + 1), np.inf)
    dp[0, 0] = 0.0
    for r in range(1, m + 1):
        for c in range(max(1, r - w), min(n + 1, r + w)):
            x, y = a[r - 1], b[c - 1]
            mag = np.sqrt(np.dot(x, x) * np.dot(y, y))
            cost = 1.0 - (0.0 if mag == 0 else np.dot(x, y) / mag)
            dp[r, c] = cost + min(dp[r - 1, c], dp[r, c - 1], dp[r - 1, c - 1])
    return dp[m - 1, n]


@pytest.mark.parametrize("n,band", [(12, 2), (20, 5), (9, 8)])
def test_banded_dtw_against_the_matrix_loop(n, band):
    rng = np.random.default_rng(n)
    t = rng.normal(size=(n, 6))
    win = rng.normal(size=(3, n, 6))
    win[1, 4] = 0.0  # a zero frame: cost 1
    got = banded_dtw(torch.tensor(t), torch.tensor(win), band, "f64").numpy()
    want = [numpy_banded(t, win[i], band) for i in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _streams():
    c = harness.cell("dtw_bench.serve")
    ww = wakewords.build(c.config, torch.Generator().manual_seed(3), torch.device("cpu"))
    utt = synth.utterances(c.config["wakewords"][0]["utterances"])[0]
    loop = torch.tensor(synth.correctness_stream(100, utt))[:120]
    g = torch.Generator().manual_seed(4)
    noise = 0.02 * torch.randn((2, 120 * 480), generator=g)
    pcm = torch.cat([loop.reshape(1, -1), noise])
    return c, ww, pcm


def test_the_batched_chunk_lags_one_shift_and_the_per_shift_step_does_not():
    """The witness for the reference's BATCHED_CHUNK_LAG_SHIFTS = 1: the
    program's per-shift step (`make_step`, the single-stream path) agrees
    with the reference fed the stream on time, its batched chunk with the
    reference fed the stream one shift late, and not on time."""
    import rustpotter_tpu_torch as rp
    from rustpotter_tpu_torch.runtime.graph import GraphedStep
    from rustpotter_tpu_torch.runtime.stream_step import make_step

    c, ww, pcm = _streams()
    objs, cfg = wakewords.for_program(ww, c.config)
    s = wakewords.settings(c.config)
    windows = {}
    for path in ("batched", "per_shift"):
        det = rp.BatchedDetector(objs, config=cfg, batch_size=3, device="cpu")
        if path == "per_shift":
            det._chunk = GraphedStep(make_step(det.static))
        st = det.init_states()
        fired = []
        for t in range(120):
            st, ev = det.process_chunk(det.params, st, pcm[:, t * 480:(t + 1) * 480])
            fired.append(ev.fired.numpy())
        F = det.static.max_mfcc_frames
        phys = (int(st.rot) + 1 + torch.arange(F)) % F
        windows[path] = (np.array(fired).T, st.win[phys].permute(2, 0, 1).double().numpy())
    assert refdet.BATCHED_CHUNK_LAG_SHIFTS == 1
    refs = [refdet.run_streams(pcm.double(), ww.reference, s, 16, "f64", lag) for lag in (0, 1)]
    for path, lag in (("per_shift", 0), ("batched", 1)):
        fired, win = windows[path]
        assert (fired == refs[lag].fired).all() and fired[0].any(), path
        # the per-shift step skips the row writes of the shifts after a
        # report (never scored), so its windows are held where nothing fired
        keep = slice(None) if path == "batched" else slice(1, None)
        assert np.abs(win[keep] - refs[lag].window(120)[keep]).max() < 1e-2, path
    gap = [np.abs(windows["batched"][1] - r.window(120)).max() for r in refs]
    assert gap[0] > 100 * gap[1]
