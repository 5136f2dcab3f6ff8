"""rustpotter_tpu_torch — the PyTorch/CUDA port of rustpotter_tpu.

A streaming wakeword spotter: PCM audio in → MFCC features → banded-DTW
template scoring → debounced detection events, batched over streams. This
package is written in PyTorch for one NVIDIA H100; its kernels are written by
hand for Hopper (csrc/) and built at first use. It imports neither `jax` nor
the JAX package, which stays the reference it is held against.

Ported so far (ROADMAP.md), for DTW wakewords: the batched serving chunk
(`runtime.batch.BatchedDetector`) with its kernel K1 (`ops.fused_dtw`); the
per-shift stream step (`runtime.stream_step.make_step`) with K2 and K4
(`ops.fused_dtw`) and K3 (`ops.banded_dtw`); the single-stream `Rustpotter`
API on it; NN wakewords; the audio front-end of both steps (the gain
normalizer and the band-pass biquad, one kernel of `ops.biquad`, input at any rate resampled
on the host or in the graph); the wakeword builder from WAV files; NN
training (`wakewords.trainer`); and stream sharding over
`torch.distributed` (`parallel`: one process per card, the streams split
over the ranks, detections merged by collectives).

Entry points run on the CUDA card unless the caller passes device="cpu".
"""

import torch

# fp32 means fp32: the DTW cost is 1 - (dot - dotm)·rwn, and on near-silent
# windows rwn = 1/|W - m| amplifies the absolute error of dotm ~1e4 times. A
# 3-pass bf16 dotm already produced false detections on silence in the JAX
# package; TF32 keeps ~3 decimal digits, coarser still. So neither cuBLAS nor
# cuDNN may use TF32 for float32 inputs.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import (  # noqa: E402
    AudioFmt,
    BandPassConfig,
    DetectorConfig,
    Endianness,
    FiltersConfig,
    GainNormalizationConfig,
    RustpotterConfig,
    SampleFormat,
    ScoreMode,
    VADMode,
)
from .runtime.batch import BatchedDetector  # noqa: E402
from .runtime.detector import Rustpotter, RustpotterDetection  # noqa: E402
from .wakewords.builder import (  # noqa: E402
    build_wakeword_ref_from_buffers,
    build_wakeword_ref_from_files,
)
from .wakewords.files import (  # noqa: E402
    ModelType,
    TensorData,
    WakewordModel,
    WakewordRef,
    WakewordV2,
    load_wakeword,
    save_wakeword,
)
from .wakewords.trainer import (  # noqa: E402
    WakewordModelTrainOptions,
    train_from_buffers,
    train_from_dirs,
)

__version__ = "0.1.0"

__all__ = [
    "AudioFmt",
    "BandPassConfig",
    "BatchedDetector",
    "DetectorConfig",
    "Endianness",
    "FiltersConfig",
    "GainNormalizationConfig",
    "ModelType",
    "Rustpotter",
    "RustpotterConfig",
    "RustpotterDetection",
    "SampleFormat",
    "ScoreMode",
    "TensorData",
    "VADMode",
    "WakewordModel",
    "WakewordRef",
    "WakewordModelTrainOptions",
    "WakewordV2",
    "build_wakeword_ref_from_buffers",
    "build_wakeword_ref_from_files",
    "load_wakeword",
    "save_wakeword",
    "train_from_buffers",
    "train_from_dirs",
    "__version__",
]
