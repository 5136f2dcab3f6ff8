"""The bench wakeword and its correctness audio, built with the port alone.

`build_bench_wakeword` is the counterpart of `bench.build_bench_wakeword`:
a 5-template DTW wakeword from synthesized utterances (chirp + noise), lengths
100/98/96/94/92 × mfcc_size frames, with real audio behind it so detection is
testable. `correctness_stream` is the stream-0 audio of `bench.correctness_pass`.
"""
from __future__ import annotations

import numpy as np

from .device import DeviceLike
from .mfcc.averager import average_templates
from .mfcc.offline import mfcc_pipeline
from .wakewords.files import WakewordRef


def bench_utterances() -> list:
    """The 5 synthesized utterances, longest first (numpy, seeded)."""
    words = []
    for i in range(5):
        frames = 100 - 2 * i
        n = (frames + 3) * 160
        rng = np.random.default_rng(100 + i)
        t = np.arange(n) / 16000.0
        sig = 0.35 * np.sin(
            2 * np.pi * np.cumsum(250 + 900 * t / t[-1]) / 16000.0
        ) + 0.02 * rng.normal(size=n)
        words.append(sig.astype(np.float32))
    return words


def build_bench_wakeword(mfcc_size: int = 16, device: DeviceLike = None):
    """Returns (WakewordRef, utterance of template 0). MFCCs are computed on
    `device` (default: the CUDA card)."""
    words = bench_utterances()
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


def correctness_stream(F: int, utterance: np.ndarray) -> np.ndarray:
    """(n_chunks, 480): silence prefill + the utterance + a silence tail that
    outlasts the F-frame window plus the F/2 countdown."""
    prefill = (F // 3 + 4) * 480
    tail = ((F + F // 2 + 30) // 3) * 480
    s = np.concatenate(
        [np.zeros(prefill, np.float32), utterance, np.zeros(tail, np.float32)]
    )
    n = len(s) // 480
    return s[: n * 480].reshape(n, 480)
