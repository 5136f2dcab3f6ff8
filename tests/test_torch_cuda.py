"""The port on a CUDA card: K1 (csrc/fused_dtw_v4.cu) against its plain
version, and the batched detector on the card against the same detector on
the CPU. Every test here needs a card (and nvcc, which builds K1 at first
use); without one they skip. The file imports no JAX, so it runs where only
PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: sims rtol 3e-6 / atol 2e-4 (the JAX kernel tests' own); event
scores rtol 2e-5 / atol 2e-5 (the CPU slice test's).
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.synthetic import build_bench_wakeword, correctness_stream

RTOL, ATOL = 3e-6, 2e-4
D, K = 2, 2
P = D * K + D
B, LM, C, W = 30, 40, 8, 5
LENS = (40, 31, 28, 37) + (35, 40)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 is a CUDA kernel with no CPU build")
    return torch.device("cuda")


def _args(F: int, device, gate=(np.inf, np.inf)):
    rng = np.random.default_rng(6 + F)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    templates = rng.normal(0, 1, (P, LM, C))
    return (
        t(rng.normal(0, 1, (F, C, B))), t(rng.normal(0, 1, (3, C, B))),
        t(rng.normal(0, 0.2, (3, P, C, B))), t(templates),
        t(np.sum(templates.astype(np.float32) ** 2, axis=-1)), t(gate), LENS, W, D, K,
        torch.tensor(F - 2, dtype=torch.int32, device=device),
    )


def _assert_sims_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [LM, LM + 2, LM + 9])
def test_kernel_matches_plain_version_on_card(cuda_device, F):
    args = _args(F, cuda_device)
    avg = fd.fused_dtw_chunk_v4_ref(*args)[:, :, D * K].flatten().sort().values
    mid = float((avg[avg.numel() // 2 - 1] + avg[avg.numel() // 2]) / 2)
    for gate in ((np.inf, np.inf), (float(avg[0]) - 1.0, np.inf), (mid, np.inf)):
        args = _args(F, cuda_device, gate)
        before = fd.LAUNCHES["fused_dtw_v4"]
        got = fd.fused_dtw_chunk_v4(*args)
        torch.cuda.synchronize()
        assert fd.LAUNCHES["fused_dtw_v4"] == before + 1
        _assert_sims_close(got, fd.fused_dtw_chunk_v4_ref(*args))


@pytest.mark.cuda
def test_batched_detector_on_card_matches_cpu(cuda_device):
    ww, utterance = build_bench_wakeword(device=cuda_device)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    n = 4
    stream0 = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(5).normal(0, 0.05, (len(stream0), n, 480)).astype(np.float32)
    frames[:, 0] = stream0
    runs = []
    for dev in (cuda_device, "cpu"):
        det = BatchedDetector([("w", ww)], cfg, batch_size=n, device=dev)
        before = fd.LAUNCHES["fused_dtw_v4"]
        _, ev = det.process_sequence(det.params, det.init_states(), frames)
        runs.append((events_to_numpy(ev), fd.LAUNCHES["fused_dtw_v4"] - before))
    (gpu, launches), (cpu, cpu_launches) = runs
    assert (launches, cpu_launches) == (len(frames), 0)
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    fired = cpu.fired
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(getattr(gpu, f)[fired], getattr(cpu, f)[fired],
                                   rtol=2e-5, atol=2e-5, err_msg=f)
    fired0 = int(cpu.fired[:, 0].sum())
    assert fired0 >= 1
