"""The audio front-end of the port on a CUDA card: the front-end kernel
(csrc/biquad.cu: the gain normalizer and the band-pass biquad, in each of
its three forms) against its plain version run on a CPU copy of the inputs,
the filtered and the 48 kHz `BatchedDetector` on the card against the
same on the CPU, and the launches the filters add to a chunk. Every test here
needs a card (and nvcc, which builds the kernel at first use); without one
they skip. The file imports no JAX:

    python -m pytest tests/test_torch_front_cuda.py -m cuda --noconftest -q

Tolerances: the kernel rounds every product, quotient, root and sum as the
plain version does (no FMA contraction), so bit-equal (a NaN only where the
plain version has one: its payload is the device's); event scores rtol 2e-5
/ atol 2e-5 (the CPU slice test's); the gains bit-equal.
"""
import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import AudioFmt, RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.audio.filters import band_pass_coefficients
from rustpotter_tpu_torch.audio.resampler import chunk_sizes
from rustpotter_tpu_torch.ops import biquad
from rustpotter_tpu_torch.ops.biquad import GAIN_STEP
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.bundle import build_bundle
from rustpotter_tpu_torch.runtime.state import init_state
from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk, make_step
from rustpotter_tpu_torch.synthetic import (
    bench_utterances,
    build_bench_wakeword,
    correctness_stream,
)
from rustpotter_tpu_torch.utils.profiling import device_kernels


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


FORMS = {"gain": (True, False), "band_pass": (False, True), "both": (True, True)}
GAIN_09 = np.float32(9) * np.float32(0.1)  # the steps' gain at k = 9, 0x3F666667
STEPS = {np.float32(np.float32(k) * np.float32(GAIN_STEP)) for k in range(1, 11)}


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Equal bits where `want` is a number, NaN where it is NaN."""
    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return False
    if want.dtype != torch.float32:
        return torch.equal(got, want)
    return torch.equal(got.view(torch.int32)[~nan], want.view(torch.int32)[~nan])


def front_inputs(rng, B, n, W, chunk):
    """One chunk of the gain's and the biquad's inputs, numpy: per stream a
    level L log-uniform in [0.04, 8] gives window entries and an rms within
    x0.5-1.5 of it (ref 0.25: gains over every step 0.1 .. 1.0), counts
    0 .. W (windows still filling), every 16th stream exact silence (rms 0,
    samples 0), samples N(0, 0.3) with an impulse of 3.0 (clipped once
    scaled), and stream 3 a NaN sample (so a NaN rms) in chunk 1."""
    level = np.exp(rng.uniform(np.log(0.04), np.log(8.0), B))
    rms = (level * rng.uniform(0.5, 1.5, B)).astype(np.float32)
    win = (level[:, None] * rng.uniform(0.5, 1.5, (B, W))).astype(np.float32)
    count = rng.integers(0, W + 1, B).astype(np.int32)
    x = rng.normal(0, 0.3, (B, n)).astype(np.float32)
    x[np.arange(B), rng.integers(0, n, B)] = 3.0
    silent = np.arange(B) % 16 == 5
    rms[silent], x[silent] = 0.0, 0.0
    if B > 3 and chunk == 1:
        x[3, 10] = rms[3] = np.nan
    return rms, win, count, x


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("B, n", [(1, 480), (4, 480), (1000, 480), (8192, 480), (37, 477)])
def test_front_kernel_bit_equal_to_plain(cuda_device, B, n, form):
    """Three chunks with the window, count and taps carried (the rms, ref
    and samples fresh each chunk; the ref NaN in chunk 2): the kernel against
    its plain version on a CPU copy, bit for bit; one launch per chunk;
    every step 0.1 .. 1.0 reached at B >= 1000."""
    gain_on, bp_on = FORMS[form]
    W = 33
    coeffs = band_pass_coefficients(16000.0, 80.0, 400.0) if bp_on else None
    rng = np.random.default_rng(B + n)
    _, win, count, _ = front_inputs(rng, B, n, W, 0)
    card = {"win": torch.tensor(win, device=cuda_device),
            "count": torch.tensor(count, device=cuda_device),
            "taps": torch.zeros(B, 4, device=cuda_device)}
    cpu = {k: v.cpu() for k, v in card.items()}
    gains = set()
    before = biquad.LAUNCHES["biquad"]
    for c in range(3):
        rms, _, _, x = front_inputs(rng, B, n, W, c)
        ref = np.float32(np.nan if c == 2 else 0.25)
        outs = []
        for dev, st in ((cuda_device, card), ("cpu", cpu)):
            gain = None
            if gain_on:
                gain = biquad.GainIn(torch.tensor(rms, device=dev), torch.tensor(ref, device=dev),
                                     0.1, 1.0, st["win"], st["count"])
            f = biquad.front(torch.tensor(x, device=dev), gain, coeffs,
                             st["taps"] if bp_on else None)
            outs.append(f)
            if gain_on:
                st["win"], st["count"] = f.win, f.count
            if bp_on:
                st["taps"] = f.taps
        torch.cuda.synchronize()
        for name in ("out", "win", "count", "gain", "taps"):
            k, p = getattr(outs[0], name), getattr(outs[1], name)
            assert (k is None) == (p is None), name
            if k is not None:
                assert same_bits(k, p), (c, name)
        if gain_on:
            gains.update(outs[1].gain.numpy().tolist())
    assert biquad.LAUNCHES["biquad"] - before == 3
    if gain_on and B >= 1000:
        assert STEPS <= gains, sorted(STEPS - gains)
        assert GAIN_09 in gains and 1.0 in gains and any(g != g for g in gains)


@pytest.mark.cuda
def test_front_kernel_replays_in_a_cuda_graph(cuda_device):
    """The kernel reads the ref by pointer and nothing on the host, so a CUDA
    graph captures a launch: three replays with the state carried in place
    give three eager launches' results bit for bit, also after the ref
    changes on the card (NaN: the gain off) between them."""
    B, n, W = 64, 480, 33
    coeffs = band_pass_coefficients(16000.0, 80.0, 400.0)
    rms, win, count, x = front_inputs(np.random.default_rng(9), B, n, W, 0)
    t = lambda a: torch.tensor(a, device=cuda_device)
    xs, r, ref = t(x), t(rms), t(np.float32(0.25))

    def state():
        return [t(win), t(count), torch.zeros(B, device=cuda_device),
                torch.zeros(B, 4, device=cuda_device)]

    def run(st):
        return biquad.front(xs, biquad.GainIn(r, ref, 0.1, 1.0, st[0], st[1]), coeffs, st[3],
                            win_out=st[0], count_out=st[1], gain_out=st[2], taps_out=st[3])

    run(state())  # the build and the shared-memory attribute, outside the capture
    torch.cuda.synchronize()
    graphed, eager = state(), state()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out_g = run(graphed)
    for i in range(3):
        if i == 2:
            ref.fill_(float("nan"))
        graph.replay()
        out_e = run(eager)
        torch.cuda.synchronize()
        assert same_bits(out_g.out, out_e.out), i
        for a, b in zip(graphed, eager):
            assert same_bits(a, b), i
    assert (eager[2] == 1.0).all()  # the NaN ref turned the gain off


def _card_and_cpu(cuda_device, cfg, frames, in_graph_resample=False):
    """BatchedDetector on the card and on the CPU over frames (T, 4, n):
    events of both, the biquad and K1 launches of the card's run, and the
    gains of the card's final states, bit-equal to the CPU's."""
    ww, _ = build_bench_wakeword(device="cpu", longest=30)
    runs = []
    for dev in (cuda_device, "cpu"):
        det = BatchedDetector([("w", ww)], cfg, batch_size=frames.shape[1], device=dev,
                              in_graph_resample=in_graph_resample)
        before = (biquad.LAUNCHES["biquad"], fd.LAUNCHES["fused_dtw_v4"])
        st, ev = det.process_sequence(det.params, det.init_states(), frames)
        after = (biquad.LAUNCHES["biquad"], fd.LAUNCHES["fused_dtw_v4"])
        runs.append((events_to_numpy(ev), tuple(a - b for a, b in zip(after, before)),
                     st.gain.cpu()))
    (gpu, launches, gains), (cpu, cpu_launches, cpu_gains) = runs
    assert same_bits(gains, cpu_gains), (gains, cpu_gains)
    for f in ("fired", "ww", "counter", "gain"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    fired = cpu.fired
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(getattr(gpu, f)[fired], getattr(cpu, f)[fired],
                                   rtol=2e-5, atol=2e-5, err_msg=f)
    assert cpu_launches == (0, 0)
    assert int(fired[:, 0].sum()) == 1
    return launches, gains.numpy()


def _config(rate=16000):
    cfg = RustpotterConfig(fmt=AudioFmt(sample_rate=rate))
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    return cfg


@pytest.mark.cuda
def test_filtered_batched_detector_on_card_matches_cpu(cuda_device):
    """Stream 1 at noise 0.062 settles at the gain 0.9 of the steps."""
    cfg = _config()
    cfg.filters.gain_normalizer.enabled = cfg.filters.band_pass.enabled = True
    stream0 = correctness_stream(30, bench_utterances(30)[0])
    frames = np.random.default_rng(5).normal(0, 0.05, (len(stream0), 4, 480)).astype(np.float32)
    frames[:, 0] = stream0
    frames[:, 1] *= np.float32(0.062 / 0.05)
    launches, gains = _card_and_cpu(cuda_device, cfg, frames)
    assert launches == (len(frames), len(frames))
    assert gains[1].view(np.uint32) == GAIN_09.view(np.uint32) == 0x3F666667


@pytest.mark.cuda
def test_48k_batched_detector_on_card_matches_cpu(cuda_device):
    n_in = chunk_sizes(48000, 16000, 480)[0]
    stream0 = correctness_stream(30, bench_utterances(30, 48000)[0], n_in)
    frames = np.random.default_rng(6).normal(0, 0.05, (len(stream0), 4, n_in))
    frames = frames.astype(np.float32)
    frames[:, 0] = stream0
    launches, _ = _card_and_cpu(cuda_device, _config(48000), frames, in_graph_resample=True)
    assert launches == (0, len(frames))


RMS_LAUNCHES = 3  # frontend.rms_level: square, mean, sqrt
PROFILED_CHUNKS = 5


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["BatchedDetector", "make_step"])
def test_the_filters_add_one_launch_a_chunk(cuda_device, path):
    """The eager chunk at B = 8192 with the gain normalizer and the band-pass
    on launches at most one kernel more than the same path with them off (the
    front-end kernel: no torch kernel of the filters is left), and the
    batched chunk also the rms's launches, which its MFCC prologue takes
    where no filter ran (with a filter on, the rms is of the samples before
    it). Each side is the median of 5 torch.profiler readings taken in turns:
    a profile may drop records, or take in some that the one before it left."""
    ww, _ = build_bench_wakeword(device="cpu")
    noise = torch.tensor(np.random.default_rng(0).normal(0, 0.05, (8192, 480)).astype(
        np.float32), device=cuda_device)

    def chunk(filters):
        cfg = _config()
        cfg.filters.gain_normalizer.enabled = cfg.filters.band_pass.enabled = filters
        if path == "BatchedDetector":
            det = BatchedDetector([("w", ww)], cfg, batch_size=8192, device=cuda_device)
            fn, params, states = make_batched_chunk(det.static), det.params, det.init_states()
        else:
            static, params = build_bundle([("w", ww)], cfg, cuda_device)
            fn, states = make_step(static), init_state(static, 8192, cuda_device)
        return lambda: fn(params, states, noise)

    def launches(fn):  # in PROFILED_CHUNKS chunks, a whole number
        rows = device_kernels(fn, PROFILED_CHUNKS)
        return round(PROFILED_CHUNKS * sum(count for _, count, _ in rows))

    on, off = chunk(True), chunk(False)
    got, ref = zip(*[(launches(on), launches(off)) for _ in range(5)])
    extra = 1 + (RMS_LAUNCHES if path == "BatchedDetector" else 0)
    print(f"{path}: launches in {PROFILED_CHUNKS} chunks with the filters {got}, without {ref}")
    assert min(ref) > 0, "the profiler recorded no device kernels"
    assert np.median(got) <= np.median(ref) + extra * PROFILED_CHUNKS, (got, ref)
