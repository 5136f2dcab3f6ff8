"""The bench wakewords and their correctness audio, built with the port alone.

`build_bench_wakeword` is the counterpart of `bench.build_bench_wakeword`:
a 5-template DTW wakeword from synthesized utterances (chirp + noise), lengths
100/98/96/94/92 × mfcc_size frames, with real audio behind it so detection is
testable. `correctness_stream` is the stream-0 audio of `bench.correctness_pass`.

`build_bench_nn_wakeword` is the `nn_medium` recipe of tools/bench_suite.py
(a MEDIUM classifier with seeded random weights: it never fires), and
`build_firing_nn_wakeword` a MEDIUM classifier of the same shapes that
fires on the bench utterance and stays silent on noise and silence.

`training_wavs` is a labelled training set for `wakewords.trainer`: WAV
bytes named "[bench]…" (the bench chirp in noise) and "none…" (noise,
silence, a falling chirp), at any length and file count from one seed.
"""
from __future__ import annotations

import numpy as np
import torch

from .constants import DETECTOR_INTERNAL_SAMPLE_RATE, SAMPLES_PER_FRAME, SAMPLES_PER_SHIFT
from .device import DeviceLike, resolve_device
from .mfcc.averager import average_templates
from .mfcc.offline import mfcc_pipeline
from .ops import frontend
from .utils.wav import wav_bytes
from .wakewords.files import ModelType, WakewordModel, WakewordRef
from .wakewords.nn import init_params, params_to_tensor_data

NN_TRAIN_SIZE = 168  # the nn_medium scenario's train_size (frames)
NN_LABELS = ("bench", "none")


def bench_utterances(longest: int = 100, rate: int = DETECTOR_INTERNAL_SAMPLE_RATE) -> list:
    """The 5 synthesized utterances of longest, longest - 2, ... MFCC frames,
    longest first (numpy, seeded), sampled at `rate`: the same chirp law
    (250 → 1150 Hz) and noise level at every rate."""
    words = []
    for i in range(5):
        frames = longest - 2 * i
        n = (frames + 3) * SAMPLES_PER_SHIFT * rate // DETECTOR_INTERNAL_SAMPLE_RATE
        rng = np.random.default_rng(100 + i)
        t = np.arange(n) / float(rate)
        sig = 0.35 * np.sin(
            2 * np.pi * np.cumsum(250 + 900 * t / t[-1]) / float(rate)
        ) + 0.02 * rng.normal(size=n)
        words.append(sig.astype(np.float32))
    return words


def build_bench_wakeword(mfcc_size: int = 16, device: DeviceLike = None,
                         longest: int = 100):
    """Returns (WakewordRef, utterance of template 0). MFCCs are computed on
    `device` (default: the CUDA card). `longest` shortens the utterances
    (and so the templates) where a run needs a short window."""
    words = bench_utterances(longest)
    feats = {
        f"s{i}.wav": mfcc_pipeline(w, mfcc_size + 1, device)
        for i, w in enumerate(words)
    }
    items = sorted(feats.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    avg = average_templates([m for _, m in items])
    ww = WakewordRef(
        name="bench", samples_features=feats, avg_features=avg, rms_level=0.05
    )
    return ww, words[0]


def correctness_stream(F: int, utterance: np.ndarray,
                       chunk: int = SAMPLES_PER_FRAME) -> np.ndarray:
    """(n_chunks, chunk): silence prefill + the utterance + a silence tail
    that outlasts the F-frame window plus the F/2 countdown, in chunks of
    `chunk` samples (480 at 16 kHz; 1440 for an utterance at 48 kHz)."""
    prefill = (F // 3 + 4) * chunk
    tail = ((F + F // 2 + 30) // 3) * chunk
    s = np.concatenate(
        [np.zeros(prefill, np.float32), utterance, np.zeros(tail, np.float32)]
    )
    n = len(s) // chunk
    return s[: n * chunk].reshape(n, chunk)


def build_bench_nn_wakeword(mfcc_size: int = 16) -> WakewordModel:
    """The `nn_medium` wakeword: MEDIUM, train_size 168, labels
    ["bench", "none"], weights from init_params(seed 3), so its layers are
    2688 → 56 → 28 → 2 at mfcc_size 16."""
    params = init_params(ModelType.MEDIUM, NN_TRAIN_SIZE * mfcc_size, mfcc_size,
                         len(NN_LABELS), seed=3)
    return WakewordModel(labels=list(NN_LABELS), train_size=NN_TRAIN_SIZE,
                         mfcc_size=mfcc_size, m_type=ModelType.MEDIUM,
                         weights=params_to_tensor_data(params), rms_level=0.05)


def build_firing_nn_wakeword(utterance: np.ndarray, mfcc_size: int = 16,
                             train_size: int = NN_TRAIN_SIZE,
                             device: DeviceLike = None) -> WakewordModel:
    """A MEDIUM classifier that fires on `correctness_stream(train_size,
    utterance)`: first-layer unit 0 is the CMN'd MFCC window that ends just
    after the utterance, scaled to give 1 there (a normalized correlation);
    layer 2's unit 0 passes max(0, 10·(h0 - 0.6)); the "bench" logit is 10×
    that and the "none" logit a constant 1. Every other weight comes from
    init_params(seed 4) and reaches no logit. MFCCs are computed on `device`
    (default: the CUDA card)."""
    F, C = train_size, mfcc_size
    stream = correctness_stream(F, utterance).reshape(-1)
    x = torch.as_tensor(stream, device=resolve_device(device))
    frames = frontend.frames_from_shifts(frontend.pre_emphasis(x.reshape(-1, SAMPLES_PER_SHIFT)))
    mfcc = frontend.mfcc_from_frames(frames, C + 1).cpu().numpy().astype(np.float64)
    end = (F // 3 + 4) * 3 + len(utterance) // SAMPLES_PER_SHIFT + 2  # frames
    tpl = mfcc[end - F:end] - mfcc[end - F:end].mean(axis=0)
    params = init_params(ModelType.MEDIUM, F * C, C, len(NN_LABELS), seed=4)
    (w1, b1), (w2, b2), (w3, b3) = params
    w1[0] = (tpl.reshape(-1) / np.sum(tpl * tpl)).astype(np.float32)
    b1[0] = 0.0
    w2[0] = 0.0
    w2[0, 0], b2[0] = 10.0, -6.0
    w3[:] = 0.0
    w3[0, 0] = 10.0
    b3[:] = (0.0, 1.0)
    return WakewordModel(labels=list(NN_LABELS), train_size=F, mfcc_size=C,
                         m_type=ModelType.MEDIUM, weights=params_to_tensor_data(params),
                         rms_level=0.05)


def training_wavs(frames: int, n_files: int, seed: int = 0) -> dict:
    """{file name: 16 kHz float32 WAV bytes} of `n_files` recordings of
    `frames` MFCC frames each (frames % 3 == 0, so the file is whole 30 ms
    chunks), the first one "[bench]", then alternating "none".

    "[bench]_{i}.wav": one of the 5 bench utterances of
    `bench_utterances(frames * 100 // 168)` (so 100 frames in a 168-frame
    file, the `nn_medium` window), at a gain in [0.6, 1.4] and a seeded
    offset, in noise of std 0.02. "none_{kind}_{i}.wav", by turns: noise of
    std 0.01-0.08, digital silence, or a falling 1500 → 400 Hz chirp of the
    utterance's length at a gain in [0.3, 1.0] in noise."""
    if frames % 3 or frames < 12:
        raise ValueError(f"frames must be a multiple of 3 and at least 12, got {frames}")
    n = (frames + 3) * SAMPLES_PER_SHIFT
    rate = float(DETECTOR_INTERNAL_SAMPLE_RATE)
    words = bench_utterances(frames * 100 // 168)
    rng = np.random.default_rng(seed)
    out = {}
    for i in range(n_files):
        sig = np.zeros(n, np.float64)
        if i % 2 == 0:
            word = words[rng.integers(len(words))] * rng.uniform(0.6, 1.4)
            at = rng.integers(0, n - len(word) + 1)
            sig += 0.02 * rng.normal(size=n)
            sig[at:at + len(word)] += word
            name = f"[bench]_{i:03d}.wav"
        else:
            kind = ("noise", "silence", "chirp")[(i // 2) % 3]
            if kind == "noise":
                sig += rng.uniform(0.01, 0.08) * rng.normal(size=n)
            elif kind == "chirp":
                m = len(words[0])
                t = np.arange(m) / rate
                chirp = np.sin(2 * np.pi * np.cumsum(1500 - 1100 * t / t[-1]) / rate)
                at = rng.integers(0, n - m + 1)
                sig += 0.02 * rng.normal(size=n)
                sig[at:at + m] += 0.35 * rng.uniform(0.3, 1.0) * chirp
            name = f"none_{kind}_{i:03d}.wav"
        out[name] = wav_bytes(sig.astype(np.float32), DETECTOR_INTERNAL_SAMPLE_RATE)
    return out
