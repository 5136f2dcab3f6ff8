"""The MFCC front-end's kernels (csrc/mfcc_front.cu) on a CUDA card, against
their plain versions (`ops/frontend.py` prologue_plain, epilogue_plain), and
the batched detector that runs them against the same on the CPU. Every test
here needs a card (and nvcc, which builds the kernels at first use); without
one they skip. The file imports no JAX:

    python -m pytest tests/test_torch_mfcc_front_cuda.py -m cuda --noconftest -q

Tolerances: the prologue rounds the pre-emphasis as the plain version does,
so its frames and buffer are bit-equal; its rms sums in another order than
torch's reduction (rtol 2e-6). The epilogue's mel and DCT sums run in
another order than cuBLAS may (rtol 1e-5 / atol 1e-5); on a silent frame,
where cuBLAS's DCT sums cancel to rounding noise, the kernel writes the
exact value rounded once. The detectors' scores as tests/test_torch_nn_cuda.py
holds them; the windows at tests/test_torch_frontend.py's MFCC tolerance (rtol
1e-5 / atol 1e-4). The shapes reach the backlog cells' B = 65536.
"""
import math

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.ops import frontend as fe
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.synthetic import (
    build_bench_wakeword,
    build_firing_nn_wakeword,
    correctness_stream,
)

EPI_TOL = dict(rtol=1e-5, atol=1e-5)
WIN_TOL = dict(rtol=1e-5, atol=1e-4)
SCORE_TOL = {"dtw": dict(rtol=2e-5, atol=2e-5), "nn": dict(rtol=1e-4, atol=1e-3)}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no CPU build")
    return torch.device("cuda")


def chunk(B, dev, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32), device=dev)
    buf = torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32), device=dev)
    return x, buf


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 8192, 65536])
@pytest.mark.parametrize("rms", [True, False])
def test_prologue_bit_equal_to_plain(cuda_device, B, rms):
    """Stream 0 silent where B > 1."""
    x, buf = chunk(B, cuda_device, B)
    if B > 1:
        x[0], buf[0] = 0.0, 0.0
    buf_p = buf.cpu()
    want_frames, want_rms = fe.prologue_plain(x.cpu(), buf_p, rms)
    before = fe.LAUNCHES["mfcc_prologue"]
    frames, level = fe.prologue(x, buf, rms)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["mfcc_prologue"] == before + 1
    assert torch.equal(frames.cpu(), want_frames)
    assert torch.equal(buf.cpu(), buf_p)  # the new buffer, in place
    if rms:
        torch.testing.assert_close(level.cpu(), want_rms, rtol=2e-6, atol=0)
    else:
        assert level is None


def spectrum(lead, dev, seed):
    rng = np.random.default_rng(seed)
    frames = torch.tensor(rng.normal(0, 0.3, lead + (480,)).astype(np.float32), device=dev)
    return torch.matmul(frames, fe.device_constants(17, dev).dft)


@pytest.mark.cuda
@pytest.mark.parametrize("lead, window", [((8192,), False), ((4096, 3), False),
                                          ((4096, 3), True), ((1,), False), ((), False),
                                          ((5, 3), True), ((65536, 3), True)])
@pytest.mark.parametrize("n", [6, 17])
def test_epilogue_matches_the_composition(cuda_device, lead, window, n):
    """Against the torch composition on the card (cuBLAS's mel and DCT)."""
    spec = spectrum(lead, cuda_device, len(lead) + n)
    before = fe.LAUNCHES["mfcc_epilogue"]
    got = fe.epilogue(spec, n, window)
    want = fe.epilogue_plain(spec, n, window)
    torch.cuda.synchronize()
    assert fe.LAUNCHES["mfcc_epilogue"] == before + 1
    assert got.shape == want.shape and got.is_contiguous()
    torch.testing.assert_close(got, want, **EPI_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [False, True])
def test_epilogue_on_a_silent_frame(cuda_device, window):
    """Stream 0 silent, the others not. mel = 0 in every band of a silent
    frame: log(f32::MIN_POSITIVE) = L, and DCT rows 1..n-1 of a constant
    vector cancel to rounding noise, which depends on the order of the sum.
    The kernel writes the exact L * sum_j D[c][j] rounded once to fp32 there
    (ROADMAP F5); the composition's rows (cuBLAS) are held to the exact value
    within the fp32 error bound of a 17-term dot product, gamma_17 * sum_j
    |L D[c][j]|. The other rows are held to the composition at rtol 1e-5 /
    atol 1e-5."""
    spec = torch.zeros(64, 3, 480, device=cuda_device)
    spec[1:] = spectrum((63, 3), cuda_device, 1)
    got = fe.epilogue(spec, 17, window)
    want = fe.epilogue_plain(spec, 17, window)
    loud = (slice(None), slice(None), slice(1, None)) if window else slice(1, None)
    torch.testing.assert_close(got[loud], want[loud], **EPI_TOL)
    silent = (slice(None), slice(None), 0) if window else 0
    L = np.float64(np.log(fe.F32_MIN_POSITIVE))  # the fp32 log, as both compute it
    D = fe.dct_matrix(17)[1:].astype(np.float64)  # (16, 17)
    exact = torch.tensor([L * math.fsum(row) for row in D])
    u = 2.0 ** -24
    bound = torch.tensor(17 * u / (1 - 17 * u) * np.abs(L * D).sum(axis=1))
    rounded = torch.tensor(exact.numpy().astype(np.float32))
    assert torch.equal(got[silent].cpu().reshape(3, 16), rounded.expand(3, 16))
    for rows in (got[silent].cpu().double(), want[silent].cpu().double()):
        rows = rows.reshape(3, 16)
        assert torch.isfinite(rows).all()
        assert ((rows - exact).abs() <= bound).all(), (rows - exact).abs().max()


@pytest.mark.cuda
def test_prologue_and_epilogue_replay_in_a_cuda_graph(cuda_device):
    """The batched chunk's front-end captured once, replayed over three
    chunks with the buffer carried in place: the eager calls' results bit for
    bit."""
    B = 256
    x, buf0 = chunk(B, cuda_device, 4)
    chunks = [chunk(B, cuda_device, 5 + i)[0] for i in range(3)]

    def front(buf):
        frames, level = fe.prologue(x, buf, True)
        return fe.mfcc_from_frames(frames, 17, window=True), level

    front(buf0.clone())  # the builds and the shared-memory attribute, outside the capture
    torch.cuda.synchronize()
    graphed, eager = buf0.clone(), buf0.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = front(graphed)
    graphed.copy_(buf0)  # the capture ran nothing; start both from one buffer
    for i, c in enumerate(chunks):
        x.copy_(c)
        graph.replay()
        out_e = front(eager)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out_g, out_e)), i
        assert torch.equal(graphed, eager), i


def _config():
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dtw", "nn"])
def test_batched_detector_on_card_matches_cpu(cuda_device, kind):
    """The bench DTW wakeword (132 chunks) and the firing MEDIUM NN wakeword
    (198): stream 0 the utterance, streams 1-63 noise; the card's events of
    streams 0-3 equal a CPU run's at B = 4, its final window rows allclose;
    one prologue and one epilogue launch per chunk."""
    ww, utterance = build_bench_wakeword(device="cpu")
    if kind == "nn":
        ww = build_firing_nn_wakeword(utterance, device="cpu")
    stream0 = correctness_stream(ww.train_size if kind == "nn" else 100, utterance)
    assert len(stream0) >= 131
    frames = np.random.default_rng(7).normal(0, 0.05, (len(stream0), 64, 480)).astype(np.float32)
    frames[:, 0] = stream0
    runs = {}
    for dev, b in ((cuda_device, 64), ("cpu", 4)):
        det = BatchedDetector([("w", ww)], _config(), batch_size=b, device=dev)
        before = dict(fe.LAUNCHES)
        st, ev = det.process_sequence(det.params, det.init_states(),
                                      torch.tensor(frames[:, :b], device=dev))
        launched = {k: fe.LAUNCHES[k] - before[k] for k in before}
        runs[str(dev)] = (events_to_numpy(ev), st.win[..., :4].cpu(), launched)
    (gpu, win, launched), (cpu, cpu_win, cpu_launched) = runs["cuda"], runs["cpu"]
    assert launched == {"mfcc_prologue": len(frames), "mfcc_epilogue": len(frames)}
    assert cpu_launched == {"mfcc_prologue": 0, "mfcc_epilogue": 0}
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(getattr(gpu, f)[:, :4], getattr(cpu, f), err_msg=f)
    fired = cpu.fired
    assert fired[:, 0].any(), "stream 0 did not fire"
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(getattr(gpu, f)[:, :4][fired], getattr(cpu, f)[fired],
                                   **SCORE_TOL[kind], err_msg=f)
    torch.testing.assert_close(win, cpu_win, **WIN_TOL)


@pytest.mark.cuda
def test_the_kernels_refuse_strided_or_misshapen_tensors(cuda_device):
    x, buf = chunk(8, cuda_device)
    wide = torch.zeros(8, 482, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous tensor"):
        fe.prologue(wide[:, 1:481], buf, True)
    with pytest.raises(ValueError, match="contiguous tensor"):
        fe.prologue(x, wide[:, 2:482], True)
    with pytest.raises(ValueError, match="ext_buf must be"):
        fe.prologue(x, buf[:, :320].contiguous(), True)
    spec = spectrum((8, 3), cuda_device, 2)
    with pytest.raises(ValueError, match="contiguous tensor"):
        fe.epilogue(spec.transpose(0, 1), 17)
    with pytest.raises(ValueError, match="contiguous tensor"):
        fe.epilogue(torch.zeros(8 * 480 + 1, device=cuda_device)[1:].view(8, 480), 17)  # 4 B off
    with pytest.raises(ValueError, match=r"\(B, S, 480\)"):
        fe.epilogue(spec.reshape(24, 480), 17, window=True)
    with pytest.raises(ValueError, match="2 to 64 mel bands"):
        fe.epilogue(spec, 65)
