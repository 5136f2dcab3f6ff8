"""Offline samples → MFCC extraction (wakeword building).

Parity: the reference's src/mfcc/wav_file_extractor.rs:18-91 — MFCC
extraction then cepstral mean normalization, over all shifts of a recording
at once, through the same front-end ops as the streaming runtime
(ops/frontend.py). The wav/encoder path is ROADMAP M10.
"""
from __future__ import annotations

import numpy as np
import torch

from ..constants import SAMPLES_PER_SHIFT
from ..device import DeviceLike, resolve_device
from ..ops import frontend


def mfcc_pipeline(
    samples: np.ndarray, num_coefficients: int, device: DeviceLike = None
) -> np.ndarray:
    """samples: (n_shifts*160,) mono f32 @16k → (n_shifts-3, n-1) MFCCs + CMN,
    computed on `device` (default: the CUDA card) and returned as numpy."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(samples, np.float32), device=dev)
    shifts = x.reshape(-1, SAMPLES_PER_SHIFT)
    pre = frontend.pre_emphasis(shifts)
    frames = frontend.frames_from_shifts(pre)
    mfcc = frontend.mfcc_from_frames(frames, num_coefficients)
    return frontend.cmn(mfcc, axis=0).cpu().numpy()
