"""The audio front-end of the port on a CUDA card: the biquad kernel
(csrc/biquad.cu) against its plain version, and the filtered and the 48 kHz
`BatchedDetector` on the card against the same on the CPU. Every test here
needs a card (and nvcc, which builds the kernel at first use); without one
they skip. The file imports no JAX:

    python -m pytest tests/test_torch_front_cuda.py -m cuda --noconftest -q

Tolerances: the kernel rounds every product and sum as the plain version
does (no FMA contraction), so bit-equal; event scores rtol 2e-5 / atol 2e-5
(the CPU slice test's).
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import AudioFmt, RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.audio.filters import band_pass_coefficients
from rustpotter_tpu_torch.audio.resampler import chunk_sizes
from rustpotter_tpu_torch.ops import biquad
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.synthetic import (
    bench_utterances,
    build_bench_wakeword,
    correctness_stream,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B, n", [(1, 480), (4, 480), (8192, 480), (1000, 480), (37, 477)])
def test_biquad_kernel_bit_equal_to_plain(cuda_device, B, n):
    """Three chunks with the taps carried; n = 477 takes the scalar loads."""
    coeffs = band_pass_coefficients(16000.0, 80.0, 400.0)
    rng = np.random.default_rng(B + n)
    state_k = state_p = torch.zeros(B, 4, device=cuda_device)
    before = biquad.LAUNCHES["biquad"]
    for c in range(3):
        x = torch.tensor(rng.normal(0, 0.3, (B, n)).astype(np.float32), device=cuda_device)
        state_k, out_k = biquad.biquad(coeffs, state_k, x)
        state_p, out_p = biquad.biquad_plain(coeffs, state_p, x)
        torch.cuda.synchronize()
        assert torch.equal(out_k, out_p), c
        assert torch.equal(state_k, state_p), c
    assert biquad.LAUNCHES["biquad"] - before == 3


@pytest.mark.cuda
def test_biquad_kernel_refuses_a_strided_signal(cuda_device):
    coeffs = band_pass_coefficients(16000.0, 80.0, 400.0)
    x = torch.zeros(4, 482, device=cuda_device)[:, 1:481]
    with pytest.raises(ValueError, match="contiguous float32"):
        biquad.biquad(coeffs, torch.zeros(4, 4, device=cuda_device), x)


def _card_and_cpu(cuda_device, cfg, frames, in_graph_resample=False):
    """BatchedDetector on the card and on the CPU over frames (T, 4, n):
    events of both, and the biquad and K1 launches of each run."""
    ww, _ = build_bench_wakeword(device="cpu", longest=30)
    runs = []
    for dev in (cuda_device, "cpu"):
        det = BatchedDetector([("w", ww)], cfg, batch_size=frames.shape[1], device=dev,
                              in_graph_resample=in_graph_resample)
        before = (biquad.LAUNCHES["biquad"], fd.LAUNCHES["fused_dtw_v4"])
        _, ev = det.process_sequence(det.params, det.init_states(), frames)
        after = (biquad.LAUNCHES["biquad"], fd.LAUNCHES["fused_dtw_v4"])
        runs.append((events_to_numpy(ev), tuple(a - b for a, b in zip(after, before))))
    (gpu, launches), (cpu, cpu_launches) = runs
    for f in ("fired", "ww", "counter", "gain"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    fired = cpu.fired
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(getattr(gpu, f)[fired], getattr(cpu, f)[fired],
                                   rtol=2e-5, atol=2e-5, err_msg=f)
    assert cpu_launches == (0, 0)
    assert int(fired[:, 0].sum()) == 1
    return launches


def _config(rate=16000):
    cfg = RustpotterConfig(fmt=AudioFmt(sample_rate=rate))
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    return cfg


@pytest.mark.cuda
def test_filtered_batched_detector_on_card_matches_cpu(cuda_device):
    cfg = _config()
    cfg.filters.gain_normalizer.enabled = cfg.filters.band_pass.enabled = True
    stream0 = correctness_stream(30, bench_utterances(30)[0])
    frames = np.random.default_rng(5).normal(0, 0.05, (len(stream0), 4, 480)).astype(np.float32)
    frames[:, 0] = stream0
    assert _card_and_cpu(cuda_device, cfg, frames) == (len(frames), len(frames))


@pytest.mark.cuda
def test_48k_batched_detector_on_card_matches_cpu(cuda_device):
    n_in = chunk_sizes(48000, 16000, 480)[0]
    stream0 = correctness_stream(30, bench_utterances(30, 48000)[0], n_in)
    frames = np.random.default_rng(6).normal(0, 0.05, (len(stream0), 4, n_in))
    frames = frames.astype(np.float32)
    frames[:, 0] = stream0
    launches = _card_and_cpu(cuda_device, _config(48000), frames, in_graph_resample=True)
    assert launches == (0, len(frames))
