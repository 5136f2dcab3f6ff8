"""The last two compiled dispatches of the port on a card, each against its
eager function, and the memory that management calls keep. Every test here
needs a card (and nvcc, which builds K1 at first use); without one they
skip. The file imports no JAX:

    python -m pytest tests/test_torch_lifecycle_cuda.py -m cuda --noconftest -q -s

  - the offline MFCC extraction (`mfcc/offline.py`, a CUDA graph per shape):
    the graphed `mfcc_pipeline` equals `mfcc_features` bit for bit at 3
    lengths x 2 coefficient counts, at every call of a key (the eager first
    call, the capture, replays, new samples); 80 recordings of one length
    capture once and 5 of 5 lengths never; the bench wakeword built from WAV
    bytes (4 lengths, one repeated) captures once and equals the eager
    pipeline's build bit for bit (templates, average, rms) and the CPU's
    build at the MFCC tolerance (rtol 1e-5 / atol 1e-4); the cache drops the
    least recently used key past its bound;
  - `BatchedDetector.reset_streams` (a CUDA graph of `make_reset`): bit for
    bit the eager reset on every field, with a mixed, an all-true and an
    all-false mask, at its capture and at replays, at B = 64 and 8192; the
    chunk after it replays without a capture and gives the eager chunk's
    events;
  - ten management calls at B = 8192 (`add_wakeword` of an NN wakeword, then
    `remove_wakeword`, in turns), each followed by a graphed chunk, which
    captures: the memory allocated, and the memory reserved after
    `empty_cache`, do not grow over the calls.
"""
import gc
import weakref

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch import RustpotterConfig, ScoreMode
from rustpotter_tpu_torch.constants import DETECTOR_INTERNAL_SAMPLE_RATE, SAMPLES_PER_SHIFT
from rustpotter_tpu_torch.mfcc import offline
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, make_reset
from rustpotter_tpu_torch.runtime.state import StreamState
from rustpotter_tpu_torch.runtime.stream_step import make_batched_chunk
from rustpotter_tpu_torch.synthetic import (
    bench_utterances,
    build_bench_wakeword,
    build_firing_nn_wakeword,
    correctness_stream,
    training_wavs,
)
from rustpotter_tpu_torch.utils.wav import wav_bytes
from rustpotter_tpu_torch.wakewords.builder import build_wakeword_ref_from_buffers

B = 64
FLEET = 8192  # the bench's B
MASKS = {"mixed": lambda b: np.arange(b) % 3 == 0, "all": lambda b: np.ones(b, bool),
         "none": lambda b: np.zeros(b, bool)}  # of the streams, at B = b


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the kernels have no CPU build")
    return torch.device("cuda")


@pytest.fixture
def graphs(monkeypatch):
    """A fresh key cache in place of the module's."""
    g = offline.ShapeGraphs()
    monkeypatch.setattr(offline, "GRAPHS", g)
    return g


def _bits(a):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _eager(samples, n, device):
    return offline.mfcc_features(torch.as_tensor(samples, device=device), n).cpu().numpy()


def _samples(frames, seed):
    return np.random.default_rng(seed).normal(
        0, 0.1, (frames + 3) * SAMPLES_PER_SHIFT).astype(np.float32)


def _config():
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    return cfg


@pytest.mark.cuda
def test_graphed_mfccs_equal_eager_bit_for_bit(cuda_device, graphs):
    for frames in (20, 57, 168):
        for n in (7, 17):
            samples = _samples(frames, frames + n)
            want = _bits(_eager(samples, n, cuda_device))
            for call in range(4):  # eager, then the capture, then replays
                got = offline.mfcc_pipeline(samples, n, cuda_device)
                assert got.shape == (frames, n - 1)
                np.testing.assert_array_equal(_bits(got), want, err_msg=f"{frames} {n} {call}")
            other = _samples(frames, 1000 + frames + n)  # a replay reads its new input
            np.testing.assert_array_equal(_bits(offline.mfcc_pipeline(other, n, cuda_device)),
                                          _bits(_eager(other, n, cuda_device)))
    assert graphs.captures == 6 and len(graphs.keys()) == 6


@pytest.mark.cuda
def test_80_equal_lengths_capture_once_and_5_distinct_lengths_never(cuda_device, graphs):
    wavs = training_wavs(168, 80, seed=0)
    for wav in wavs.values():
        samples, _ = offline.encode_wav(wav)
        got, _ = offline.compute_mfccs(wav, 16, cuda_device)
        np.testing.assert_array_equal(_bits(got), _bits(_eager(samples, 17, cuda_device)))
    assert graphs.captures == 1 and len(graphs.keys()) == 1
    for frames in (150, 153, 156, 159, 162):  # 5 lengths, 5 whole numbers of 30 ms chunks
        wav = next(iter(training_wavs(frames, 1, seed=frames).values()))
        got, _ = offline.compute_mfccs(wav, 16, cuda_device)
        np.testing.assert_array_equal(
            _bits(got), _bits(_eager(offline.encode_wav(wav)[0], 17, cuda_device)))
    assert graphs.captures == 1 and len(graphs.keys()) == 6


@pytest.mark.cuda
def test_the_bench_templates_built_from_wavs_equal_eager(cuda_device, graphs, monkeypatch):
    """The 5 bench utterances as WAV bytes: the host encoder keeps whole 30 ms
    chunks, so their 103/101/99/97/95 shifts give 99/96/96/93/90 frames, and
    the second 96-frame file is its key's second call: one capture."""
    buffers = {f"s{i}.wav": wav_bytes(w, DETECTOR_INTERNAL_SAMPLE_RATE)
               for i, w in enumerate(bench_utterances(100))}
    ww = build_wakeword_ref_from_buffers("bench", buffers, 16, device=cuda_device)
    assert [len(ww.samples_features[k]) for k in buffers] == [99, 96, 96, 93, 90]
    assert graphs.captures == 1 and len(graphs.keys()) == 4
    for key, buf in buffers.items():
        samples, _ = offline.encode_wav(buf)
        np.testing.assert_array_equal(_bits(ww.samples_features[key]),
                                      _bits(_eager(samples, 17, cuda_device)))
    cpu = build_wakeword_ref_from_buffers("bench", buffers, 16, device="cpu")
    monkeypatch.setattr(offline, "mfcc_pipeline", lambda x, n, device=None: _eager(x, n, device))
    eager = build_wakeword_ref_from_buffers("bench", buffers, 16, device=cuda_device)
    np.testing.assert_array_equal(_bits(ww.avg_features), _bits(eager.avg_features))
    for key in buffers:
        np.testing.assert_allclose(ww.samples_features[key], cpu.samples_features[key],
                                   rtol=1e-5, atol=1e-4, err_msg=key)
    np.testing.assert_allclose(ww.avg_features, cpu.avg_features, rtol=1e-5, atol=1e-4)
    assert ww.rms_level == eager.rms_level == cpu.rms_level


@pytest.mark.cuda
def test_the_least_recently_used_graph_is_dropped_on_the_card(cuda_device, graphs):
    graphs.bound = 3
    lengths = (20, 21, 22, 23)
    for frames in lengths[:3]:
        for _ in range(2):  # each key captured
            offline.mfcc_pipeline(_samples(frames, frames), 17, cuda_device)
    assert graphs.captures == 3
    oldest = weakref.ref(graphs._steps[graphs.keys()[0]])
    offline.mfcc_pipeline(_samples(23, 0), 17, cuda_device)  # a fourth key drops 20 frames
    assert [k[1] for k in graphs.keys()] == [24, 25, 26]  # shifts: frames + 3
    gc.collect()
    assert oldest() is None  # its graph and pool with it
    samples = _samples(20, 5)  # 20 frames again: eager, then captured anew
    for _ in range(3):
        np.testing.assert_array_equal(_bits(offline.mfcc_pipeline(samples, 17, cuda_device)),
                                      _bits(_eager(samples, 17, cuda_device)))
    assert graphs.captures == 4 and len(graphs.keys()) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("b", [B, FLEET])
@pytest.mark.parametrize("mask", list(MASKS))
def test_graphed_reset_equals_eager_and_keeps_the_chunks_graph(cuda_device, mask, b):
    ww, utterance = build_bench_wakeword(device="cpu", longest=30)
    det = BatchedDetector([("w", ww)], _config(), batch_size=b, device=cuda_device)
    stream0 = correctness_stream(det.static.max_mfcc_frames, utterance)
    frames = np.random.default_rng(2).normal(0, 0.05, (len(stream0), b, 480)).astype(np.float32)
    frames[:, 0] = stream0
    frames = torch.tensor(frames, device=cuda_device)
    states = det.init_states()
    for t in range(20):
        states, _ = det.process_chunk(det.params, states, frames[t])
    base = [t.clone() for t in states]
    ptrs = [t.data_ptr() for t in states]
    eager_reset, eager_chunk = make_reset(det.static, cuda_device), make_batched_chunk(det.static)
    m = torch.tensor(MASKS[mask](b), device=cuda_device)
    chunk_captures = det._chunk.captures
    for call in range(3):  # the eager call and the capture, then replays
        for t, b in zip(states, base):
            t.copy_(b)
        assert det.reset_streams(states, m) is states
        want = StreamState(*[b.clone() for b in base])
        eager_reset(det.params, want, m)
        for f, a, b in zip(StreamState._fields, states, want):
            assert torch.equal(torch.as_tensor(_bits(a)), torch.as_tensor(_bits(b))), (f, call)
    assert det._reset.captures == 1 and [t.data_ptr() for t in states] == ptrs
    changed = [f for f, a, b in zip(StreamState._fields, states, base)
               if not np.array_equal(_bits(a), _bits(b))]
    assert bool(changed) == bool(m.any()), changed
    for t in range(20, 24):  # the chunk's graph reads the reset states in place
        states, ev = det.process_chunk(det.params, states, frames[t])
        want, ev_e = eager_chunk(det.params, want, frames[t])
        for f, a, b in zip(ev._fields, ev, ev_e):
            if a.dtype.is_floating_point:  # the graph replays the eager kernels
                torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5, equal_nan=True)
                print(f"{mask} chunk {t} {f}: bit-equal {np.array_equal(_bits(a), _bits(b))}")
            else:
                assert torch.equal(a, b), (f, t)
    assert det._chunk.captures == chunk_captures


@pytest.mark.cuda
def test_management_calls_keep_no_memory(cuda_device):
    ww, utterance = build_bench_wakeword(device=cuda_device)
    firing = build_firing_nn_wakeword(utterance, device=cuda_device)
    det = BatchedDetector([("w", ww)], _config(), batch_size=FLEET, device=cuda_device)
    noise = torch.tensor(np.random.default_rng(0).normal(0, 0.05, (FLEET, 480)).astype(
        np.float32), device=cuda_device)
    states = det.init_states()
    states, _ = det.process_chunk(det.params, states, noise)
    readings = []
    for call in range(10):
        if call % 2 == 0:
            states = det.add_wakeword("n", firing, states)
        else:
            states = det.remove_wakeword("n", states)
        states, _ = det.process_chunk(det.params, states, noise)  # captures
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        readings.append((torch.cuda.memory_allocated(cuda_device),
                         torch.cuda.memory_reserved(cuda_device)))
    print(f"memory allocated and reserved after empty_cache, per call: {readings} B")
    assert det._chunk.captures == 1
    # no growth: each call's readings at most the largest of the first four
    # calls of its bundle (the allocator's placement differs by a fraction
    # of a MiB from one call of a bundle to the next, with no trend)
    for later in range(4, 10):
        first = [readings[i] for i in range(later % 2, 4, 2)]
        assert readings[later][0] <= max(r[0] for r in first), readings
        assert readings[later][1] <= max(r[1] for r in first), readings
