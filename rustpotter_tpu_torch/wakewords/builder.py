"""WakewordRef builder: record WAV samples → template wakeword.

Parity: the reference's src/wakewords/comp/wakeword_ref_build.rs —
new_from_sample_files (:42-88, median RMS across files), new_from_sample_buffers
(:8-41, max RMS), avg computation ordering longest-first with name tie-break
(:90-110). A copy of `rustpotter_tpu.wakewords.builder`; the MFCCs are computed
on `device` (default: the CUDA card).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from ..device import DeviceLike
from ..mfcc.averager import average_templates
from ..mfcc.offline import compute_mfccs
from .files import WakewordRef


def _compute_avg(samples_features: Dict[str, np.ndarray]) -> Optional[np.ndarray]:
    if len(samples_features) <= 1:
        return None
    items = sorted(samples_features.items(), key=lambda kv: (-len(kv[1]), kv[0]))
    return average_templates([m for _, m in items])


def build_wakeword_ref_from_files(
    name: str,
    sample_paths: List[str],
    mfcc_size: int = 16,
    threshold: Optional[float] = None,
    avg_threshold: Optional[float] = None,
    device: DeviceLike = None,
) -> WakewordRef:
    samples_features: Dict[str, np.ndarray] = {}
    rms_levels: List[float] = []
    for path in sample_paths:
        if not os.path.isfile(path):
            raise FileNotFoundError("File not found: " + path)
        mfccs, rms = compute_mfccs(path, mfcc_size, device)
        samples_features[os.path.basename(path)] = mfccs
        rms_levels.append(rms)
    rms_sorted = np.sort(np.array(rms_levels, dtype=np.float32))
    rms_level = float(rms_sorted[len(rms_sorted) // 2])
    return WakewordRef(
        name=name,
        samples_features=samples_features,
        avg_features=_compute_avg(samples_features),
        threshold=threshold,
        avg_threshold=avg_threshold,
        rms_level=rms_level,
    )


def build_wakeword_ref_from_buffers(
    name: str,
    samples: Dict[str, bytes],
    mfcc_size: int = 16,
    threshold: Optional[float] = None,
    avg_threshold: Optional[float] = None,
    device: DeviceLike = None,
) -> WakewordRef:
    samples_features: Dict[str, np.ndarray] = {}
    rms_level = 0.0
    for key, buffer in samples.items():
        mfccs, rms = compute_mfccs(buffer, mfcc_size, device)
        samples_features[key] = mfccs
        if rms > rms_level:
            rms_level = rms
    return WakewordRef(
        name=name,
        samples_features=samples_features,
        avg_features=_compute_avg(samples_features),
        threshold=threshold,
        avg_threshold=avg_threshold,
        rms_level=rms_level,
    )
