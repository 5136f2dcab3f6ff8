"""Offline WAV → MFCC extraction (wakeword building).

Parity: the reference's src/mfcc/wav_file_extractor.rs:18-91 — wav parse,
re-encode and resample in exact frame chunks (the host encoder: a WAV at
44.1 or 48 kHz goes through `audio.resampler.FftResampler`), per-chunk RMS
collected with the median taken, MFCC extraction, cepstral mean
normalization — over all shifts of a recording at once, through the same
front-end ops as the streaming runtime (ops/frontend.py).

On the card `mfcc_pipeline` replays a CUDA graph per shape, the counterpart
of the JAX package's `jax.jit` of `_mfcc_pipeline` per coefficient count
with jit's cache of one executable per WAV length
(`rustpotter_tpu/mfcc/offline.py:38-60`). `GRAPHS`, a `ShapeGraphs`,
keys a graph on (card, number of shifts, number of coefficients):
  - a key's first call runs `mfcc_features` eagerly and captures nothing:
    recordings differ in length (the bench wakeword's 5 templates are
    100/98/96/94/92 frames), and a graph captured at every new length
    would never be replayed;
  - its second call makes a `runtime.graph.GraphedStep` for the key, which
    runs the pipeline eagerly on the card's capture stream (the cuBLAS
    workspace and the constants are made there, outside any graph's pool)
    and then captures it;
  - later calls copy the samples into the graph's input buffer, replay it
    and read the features back once. The graph runs the eager call's
    kernels on the same shapes, so its output equals the eager one bit for
    bit.
At most `MAX_GRAPHS` keys are kept, the least recently used dropped first,
graph and memory pool with it. On the CPU the pipeline runs eagerly and
nothing is kept.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..audio.encoder import AudioEncoder
from ..config import AudioFmt, Endianness, SampleFormat
from ..constants import SAMPLES_PER_SHIFT
from ..device import DeviceLike, resolve_device
from ..ops import frontend
from ..runtime.graph import GraphedStep
from ..utils.wav import WavSpec, read_wav

# keys kept by `GRAPHS`, each with its CUDA graph once called twice. One
# graph's memory pool holds 4.0 MiB at 168 frames, the trainer's recordings
# (reserved memory after `empty_cache` with the graph and without it, on an
# NVIDIA H100 80GB HBM3, 700.00 W; `tests/test_torch_lifecycle_cuda.py`
# holds the captures and the eviction)
MAX_GRAPHS = 8


def audio_fmt_from_spec(spec: WavSpec) -> AudioFmt:
    if spec.is_float and spec.bits_per_sample == 32:
        fmt = SampleFormat.F32
    else:
        fmt = SampleFormat.int_of_size(spec.bits_per_sample)
        if fmt is None:
            raise ValueError("Unsupported wav format")
    return AudioFmt(
        sample_rate=spec.sample_rate,
        sample_format=fmt,
        channels=spec.channels,
        endianness=Endianness.LITTLE,
    )


class Features(NamedTuple):
    """What the pipeline's graph step returns beside its (empty) state."""
    mfccs: torch.Tensor


def mfcc_features(x: torch.Tensor, num_coefficients: int) -> torch.Tensor:
    """The eager pipeline: x (n_shifts*160,) f32 @16k on its device →
    (n_shifts-3, n-1) MFCCs + CMN, on the same device."""
    shifts = x.reshape(-1, SAMPLES_PER_SHIFT)
    pre = frontend.pre_emphasis(shifts)
    frames = frontend.frames_from_shifts(pre)
    mfcc = frontend.mfcc_from_frames(frames, num_coefficients)
    return frontend.cmn(mfcc, axis=0)


def _graph_step(consts: frontend.DeviceConstants, states: tuple, x: torch.Tensor):
    """`mfcc_features` in the `GraphedStep` form fn(params, states, x) ->
    (states, out): the parameters are the card's constants, which a graph
    holds while it lives, and there is no state."""
    return states, Features(mfcc_features(x, consts.num_coefficients))


class ShapeGraphs:
    """The keys seen, least recently used first, each with its GraphedStep
    once it was called twice; at most `bound` keys (see the module
    docstring). `make_step()` makes a key's GraphedStep; `captures` counts
    the steps made, each of which captures at its first call."""

    def __init__(self, bound: int = MAX_GRAPHS, make_step=lambda: GraphedStep(_graph_step)):
        self.bound = bound
        self.make_step = make_step
        self.captures = 0
        self._steps: "OrderedDict[tuple, Optional[GraphedStep]]" = OrderedDict()

    def keys(self) -> list:
        return list(self._steps)

    def clear(self) -> None:
        self._steps.clear()

    def step(self, key: tuple) -> Optional[GraphedStep]:
        """None at a key's first call (run it eagerly), else its GraphedStep;
        the key becomes the most recently used, and the least recently used
        past the bound is dropped."""
        seen = key in self._steps
        step = self._steps.pop(key, None)
        if seen and step is None:
            step = self.make_step()
            self.captures += 1
        self._steps[key] = step
        while len(self._steps) > self.bound:
            self._steps.popitem(last=False)
        return step


GRAPHS = ShapeGraphs()


def mfcc_pipeline(
    samples: np.ndarray, num_coefficients: int, device: DeviceLike = None
) -> np.ndarray:
    """samples: (n_shifts*160,) mono f32 @16k → (n_shifts-3, n-1) MFCCs + CMN,
    computed on `device` (default: the CUDA card; from a shape's second call
    there, replayed from its CUDA graph) and returned as numpy after one read
    of the device."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(samples, np.float32), device=dev)
    step = None
    if x.device.type == "cuda":
        step = GRAPHS.step((x.device.index, x.shape[0] // SAMPLES_PER_SHIFT, num_coefficients))
    if step is None:
        return mfcc_features(x, num_coefficients).cpu().numpy()
    _, (mfccs,) = step(frontend.device_constants(num_coefficients, x.device), (), x)
    return mfccs.cpu().numpy()


def encode_wav(path_or_bytes) -> tuple[np.ndarray, float]:
    """The host part of `compute_mfccs`: WAV → (16 kHz f32 samples, a whole
    number of shifts; median RMS level of the encoder's output chunks)."""
    raw, spec = read_wav(path_or_bytes)
    encoder = AudioEncoder(audio_fmt_from_spec(spec))
    in_len = encoder.get_input_frame_length()
    chunks_out = []
    rms_levels = []
    for c in range(len(raw) // in_len):
        out = encoder.rencode_and_resample(raw[c * in_len : (c + 1) * in_len])
        rms_levels.append(float(np.sqrt(np.mean(np.square(out.astype(np.float64))))))
        chunks_out.append(out)
    rms_level = 0.0
    if rms_levels:
        s = np.sort(np.array(rms_levels, dtype=np.float32))
        rms_level = float(s[len(s) // 2])
    samples = np.concatenate(chunks_out) if chunks_out else np.zeros(0, np.float32)
    # The reference feeds the extractor in output-frame chunks; sizes are exact
    # multiples of the shift so flattening is equivalent (wav_file_extractor.rs:59-66)
    n_shifts = len(samples) // SAMPLES_PER_SHIFT
    return samples[: n_shifts * SAMPLES_PER_SHIFT], rms_level


def compute_mfccs(path_or_bytes, mfcc_size: int,
                  device: DeviceLike = None) -> tuple[np.ndarray, float]:
    """WAV → (CMN-normalized MFCC matrix (frames, mfcc_size), median RMS
    level), the MFCCs computed on `device` (default: the CUDA card).

    num_coefficients = mfcc_size + 1 since coefficient 0 is dropped
    (wav_file_extractor.rs:36-40)."""
    samples, rms_level = encode_wav(path_or_bytes)
    return mfcc_pipeline(samples, mfcc_size + 1, device), rms_level
