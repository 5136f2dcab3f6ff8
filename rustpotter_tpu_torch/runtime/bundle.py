"""Detector bundle: static configuration + padded parameter tensors.

All DTW wakewords are padded into dense (D, K, L, C) tensors scored in one
batched pass; per-wakeword thresholds are resolved at build (wakeword
overrides ride in the file — reference wakeword_ref.rs:16-17, applied at
wakeword_comp.rs:83,95). The counterpart of `rustpotter_tpu.runtime.bundle`,
DTW wakewords only: NN wakewords (ROADMAP M9) and in-graph resampling
(ROADMAP M8) raise NotImplementedError.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..audio.filters import band_pass_coefficients
from ..config import RustpotterConfig, ScoreMode
from ..constants import DETECTOR_INTERNAL_SAMPLE_RATE
from ..device import DeviceLike, resolve_device
from ..wakewords.files import WakewordModel, WakewordRef


@dataclass(frozen=True)
class StepStatic:
    """Hashable static configuration of the serving chunk."""

    mfcc_size: int
    max_mfcc_frames: int  # F: live window length
    band_size: int
    score_mode: ScoreMode
    eager: bool
    min_scores: int
    score_ref: float
    vad_enabled: bool
    vad_factor: float
    gain_enabled: bool
    gain_min: float
    gain_max: float
    gain_window_size: int
    bp_enabled: bool
    bp_coeffs: Tuple[float, ...]
    n_dtw: int
    kmax: int
    lmax: int
    la_max: int
    # static per-pair DP lengths: all template lengths (padded with 1s to
    # kmax per wakeword, in order) followed by per-wakeword avg lengths
    dtw_pair_lens: Tuple[int, ...] = ()
    smax: int = 1  # width of the per-detection scores payload
    names: Tuple[str, ...] = ()
    dtw_template_names: Tuple[Tuple[str, ...], ...] = ()
    input_samples: int = 480
    input_rate: int = DETECTOR_INTERNAL_SAMPLE_RATE
    # DTW kernel selection, resolved at bundle build. None or True = fused:
    # K1 in the batched chunk, and in the per-shift step K2 (variant >= 3)
    # or K4 (variant 2); False = band_costs then the banded DP, K3. The
    # tensor's device picks kernel or plain version, so None means fused on
    # every device.
    dtw_fused: Optional[bool] = None
    dtw_fused_variant: int = 3


@dataclass(frozen=True)
class StepParams:
    """Parameter tensors of the serving chunk (shared by all streams)."""

    dtw_templates: torch.Tensor  # (D, K, L, C) f32
    dtw_lens: torch.Tensor  # (D, K) i32
    dtw_kvalid: torch.Tensor  # (D,) i32
    dtw_avg: torch.Tensor  # (D, La, C) f32
    dtw_avg_len: torch.Tensor  # (D,) i32
    dtw_has_avg: torch.Tensor  # (D,) bool
    dtw_threshold: torch.Tensor  # (D,) f32, resolved
    dtw_avg_threshold: torch.Tensor  # (D,) f32, resolved
    gain_ref_sqrt: torch.Tensor  # () f32 (sqrt of target rms level; NaN if none)
    threshold: torch.Tensor  # () f32 (global)
    avg_threshold: torch.Tensor  # () f32 (global)

    @staticmethod
    def from_numpy(d: dict, device: DeviceLike = None) -> "StepParams":
        """From numpy arrays keyed by field name (extra keys are ignored)."""
        dev = resolve_device(device)
        return StepParams(**{
            f.name: torch.tensor(np.asarray(d[f.name]), device=dev)
            for f in fields(StepParams)
        })


def rust_f32_max(a: float, b: float) -> float:
    """Rust f32::max ignores NaN operands (detector.rs:333)."""
    if np.isnan(a):
        return b
    if np.isnan(b):
        return a
    return max(a, b)


def build_bundle(
    wakewords: List[Tuple[str, WakewordRef]],
    config: RustpotterConfig,
    device: DeviceLike = None,
    in_graph_resample: bool = False,
    dtw_fused: Optional[bool] = None,
) -> Tuple[StepStatic, StepParams]:
    """(StepStatic, StepParams on `device`) for DTW wakewords. With
    dtw_fused None, RUSTPOTTER_FUSED ("1" or "0") decides if it is set;
    RUSTPOTTER_FUSED_VARIANT sets the fused variant (default 3), as in the
    JAX package."""
    if in_graph_resample:
        raise NotImplementedError("in-graph resampling: ROADMAP M8")
    if any(isinstance(w, WakewordModel) for _, w in wakewords):
        raise NotImplementedError("NN wakewords: ROADMAP M9")
    if dtw_fused is None and "RUSTPOTTER_FUSED" in os.environ:
        dtw_fused = os.environ["RUSTPOTTER_FUSED"] == "1"
    fused_variant = int(os.environ.get("RUSTPOTTER_FUSED_VARIANT", "3"))
    det = config.detector
    refs = list(wakewords)
    if not refs:
        raise ValueError("no wakewords")
    mfcc_size = refs[0][1].mfcc_size
    for _, w in refs:
        if w.mfcc_size != mfcc_size:
            raise ValueError(
                "Usage of wakewords with different mfcc size is not supported"
            )

    # max window length and gain target (detector.rs:328-346)
    max_frames = 0
    target_rms = float("nan")
    for _, w in refs:
        max_frames = max(max_frames, max(len(m) for m in w.samples_features.values()))
        target_rms = rust_f32_max(target_rms, w.rms_level)

    D = len(refs)
    kmax = max(len(w.samples_features) for _, w in refs)
    lmax = max(len(m) for _, w in refs for m in w.samples_features.values())
    la_max = max(
        (len(w.avg_features) for _, w in refs if w.avg_features is not None), default=1
    )
    C = mfcc_size

    d_templates = np.zeros((D, kmax, lmax, C), np.float32)
    d_lens = np.ones((D, kmax), np.int32)
    d_kvalid = np.ones((D,), np.int32)
    d_avg = np.zeros((D, la_max, C), np.float32)
    d_avg_len = np.ones((D,), np.int32)
    d_has_avg = np.zeros((D,), bool)
    d_th = np.zeros((D,), np.float32)
    d_avg_th = np.zeros((D,), np.float32)
    template_names: List[Tuple[str, ...]] = []
    for i, (_, w) in enumerate(refs):
        items = sorted(w.samples_features.items())  # deterministic order
        template_names.append(tuple(k for k, _ in items))
        d_kvalid[i] = len(items)
        for j, (_, m) in enumerate(items):
            d_lens[i, j] = len(m)
            d_templates[i, j, : len(m)] = m
        if w.avg_features is not None:
            d_has_avg[i] = True
            d_avg_len[i] = len(w.avg_features)
            d_avg[i, : len(w.avg_features)] = w.avg_features
        d_th[i] = w.threshold if w.threshold is not None else det.threshold
        d_avg_th[i] = (
            w.avg_threshold if w.avg_threshold is not None else det.avg_threshold
        )

    static = StepStatic(
        mfcc_size=mfcc_size,
        max_mfcc_frames=max_frames,
        band_size=det.band_size,
        score_mode=det.score_mode,
        eager=det.eager,
        min_scores=det.min_scores,
        score_ref=det.score_ref,
        vad_enabled=det.vad_mode is not None,
        vad_factor=det.vad_mode.value_factor if det.vad_mode is not None else 2.0,
        gain_enabled=config.filters.gain_normalizer.enabled,
        gain_min=config.filters.gain_normalizer.min_gain,
        gain_max=config.filters.gain_normalizer.max_gain,
        gain_window_size=max(max_frames // 3, 1),
        bp_enabled=config.filters.band_pass.enabled,
        bp_coeffs=tuple(
            float(c)
            for c in band_pass_coefficients(
                float(DETECTOR_INTERNAL_SAMPLE_RATE),
                config.filters.band_pass.low_cutoff,
                config.filters.band_pass.high_cutoff,
            )
        ),
        n_dtw=D,
        kmax=int(kmax),
        lmax=int(lmax),
        la_max=int(la_max),
        dtw_pair_lens=tuple(int(x) for x in d_lens.reshape(-1)) + tuple(int(x) for x in d_avg_len),
        smax=int(d_kvalid.max()),
        names=tuple(k for k, _ in refs),
        dtw_template_names=tuple(template_names),
        dtw_fused=dtw_fused,
        dtw_fused_variant=fused_variant,
    )
    fixed_gain_ref = config.filters.gain_normalizer.gain_ref
    gain_ref = fixed_gain_ref if fixed_gain_ref is not None else target_rms
    params = StepParams.from_numpy(
        dict(
            dtw_templates=d_templates,
            dtw_lens=d_lens,
            dtw_kvalid=d_kvalid,
            dtw_avg=d_avg,
            dtw_avg_len=d_avg_len,
            dtw_has_avg=d_has_avg,
            dtw_threshold=d_th,
            dtw_avg_threshold=d_avg_th,
            gain_ref_sqrt=np.float32(
                np.sqrt(gain_ref) if gain_ref == gain_ref and gain_ref >= 0 else np.nan
            ),
            threshold=np.float32(det.threshold),
            avg_threshold=np.float32(det.avg_threshold),
        ),
        device,
    )
    return static, params
