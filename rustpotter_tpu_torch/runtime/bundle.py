"""Detector bundle: static configuration + padded parameter tensors.

All DTW wakewords are padded into dense (D, K, L, C) tensors scored in one
batched pass; NN wakewords keep one (W, b) tuple per model, scored one model
after another (distinct architectures). Per-wakeword thresholds are resolved
at build (wakeword overrides ride in the file — reference
wakeword_ref.rs:16-17, applied at wakeword_comp.rs:83,95). The counterpart
of `rustpotter_tpu.runtime.bundle`. With `in_graph_resample` and input at
another rate than 16 kHz, the stream steps take `input_samples` raw samples
per chunk (`chunk_sizes`: 1440 at 48 kHz, 1323 at 44.1 kHz) and resample them
on the device; at 16 kHz the flag changes nothing, as in the JAX package.

The DTW kernels are chosen here, from the band and the MFCC size: where the
requested mode's kernels cannot take the band (K1's and K2's rings pass the
shared-memory opt-in from w = 21, K3's tile from w = 76), the bundle takes
K4, whose column and row forms take every band past its ring form. The choice is static and the same on
every device, so the CPU runs the same mode through K4's plain version.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, fields
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import _build
from ..audio.filters import band_pass_coefficients
from ..audio.resampler import chunk_sizes
from ..config import RustpotterConfig, ScoreMode
from ..constants import DETECTOR_INTERNAL_SAMPLE_RATE, SAMPLES_PER_FRAME
from ..device import DeviceLike, resolve_device
from ..ops import banded_dtw
from ..ops.fused_dtw import k1_smem_bytes, k2_smem_bytes
from ..wakewords.files import WakewordModel, WakewordRef
from ..wakewords.nn import params_from_tensor_data

Wakeword = Union[WakewordRef, WakewordModel]


@dataclass(frozen=True)
class NNMeta:
    train_size: int
    labels: Tuple[str, ...]
    none_idx: int  # -1 if "none" not among labels
    m_type: str = "tiny"  # ModelType value


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
    nn_meta: Tuple[NNMeta, ...] = ()
    # static per-pair DP lengths: all template lengths (padded with 1s to
    # kmax per wakeword, in order) followed by per-wakeword avg lengths
    dtw_pair_lens: Tuple[int, ...] = ()
    smax: int = 1  # width of the per-detection scores payload
    names: Tuple[str, ...] = ()  # wakeword keys, DTW first then NN
    dtw_template_names: Tuple[Tuple[str, ...], ...] = ()
    input_samples: int = SAMPLES_PER_FRAME  # raw samples per chunk
    input_rate: int = DETECTOR_INTERNAL_SAMPLE_RATE
    # DTW kernel selection, resolved at bundle build. None or True = fused:
    # K1 in the batched chunk, and in the per-shift step K2 (variant >= 3)
    # or K4 (variant 2); False = band_costs then the banded DP, K3. The
    # tensor's device picks kernel or plain version, so None means fused on
    # every device. dtw_k4_for_band is True where the band passed the
    # requested mode's kernels and the bundle took K4 (`choose_dtw_kernels`).
    dtw_fused: Optional[bool] = None
    dtw_fused_variant: int = 3
    dtw_k4_for_band: bool = False


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
    nn_params: Tuple  # per NN wakeword: a tuple of (W (out, in), b (out,)) f32
    gain_ref_sqrt: torch.Tensor  # () f32 (sqrt of target rms level; NaN if none)
    threshold: torch.Tensor  # () f32 (global, the NN wakewords' threshold)
    avg_threshold: torch.Tensor  # () f32 (global, the NN wakewords' threshold)

    @staticmethod
    def from_numpy(d: dict, device: DeviceLike = None) -> "StepParams":
        """From numpy arrays keyed by field name (extra keys are ignored);
        `nn_params` is a sequence, per NN wakeword, of (W, b) pairs (absent
        means none)."""
        dev = resolve_device(device)
        t = lambda a: torch.tensor(np.asarray(a), device=dev)
        out = {f.name: t(d[f.name]) for f in fields(StepParams) if f.name != "nn_params"}
        out["nn_params"] = tuple(
            tuple((t(np.asarray(w, np.float32)), t(np.asarray(b, np.float32))) for w, b in model)
            for model in d.get("nn_params", ())
        )
        return StepParams(**out)


def rust_f32_max(a: float, b: float) -> float:
    """Rust f32::max ignores NaN operands (detector.rs:333)."""
    if np.isnan(a):
        return b
    if np.isnan(b):
        return a
    return max(a, b)


def choose_dtw_kernels(band: int, mfcc_size: int, dtw_fused: Optional[bool],
                       variant: int) -> Tuple[Optional[bool], int, bool]:
    """(dtw_fused, variant, k4_for_band): the requested mode where its kernels
    take the band, else K4 (fused, variant 2). Fused variant >= 3 runs K1 in
    the batched chunk and K2 in the per-shift step, whose rings must fit the
    shared-memory opt-in (`k1_smem_bytes`, `k2_smem_bytes`); dtw_fused False
    runs K3, which takes w <= banded_dtw.W_MAX. K4 takes every band >= 2."""
    if dtw_fused is False:
        fits = band <= banded_dtw.W_MAX
    elif variant >= 3:
        fits = max(k1_smem_bytes(band, mfcc_size),
                   k2_smem_bytes(band, mfcc_size)) <= _build.SMEM_OPTIN
    else:
        fits = True
    if fits:
        return dtw_fused, variant, False
    return True, 2, True


def build_bundle(
    wakewords: List[Tuple[str, Wakeword]],
    config: RustpotterConfig,
    device: DeviceLike = None,
    in_graph_resample: bool = False,
    dtw_fused: Optional[bool] = None,
) -> Tuple[StepStatic, StepParams]:
    """(StepStatic, StepParams on `device`) for DTW and NN wakewords (DTW
    first in `names`, then NN, each in the order given). With dtw_fused
    None, RUSTPOTTER_FUSED ("1" or "0") decides if it is set;
    RUSTPOTTER_FUSED_VARIANT sets the fused variant (default 3), as in the
    JAX package; then `choose_dtw_kernels` checks the band. With
    `in_graph_resample` and input at another rate than 16 kHz, the steps
    take chunks of `input_samples` samples at `input_rate`."""
    input_samples, input_rate = SAMPLES_PER_FRAME, DETECTOR_INTERNAL_SAMPLE_RATE
    if in_graph_resample and config.fmt.sample_rate != DETECTOR_INTERNAL_SAMPLE_RATE:
        input_samples, _ = chunk_sizes(
            config.fmt.sample_rate, DETECTOR_INTERNAL_SAMPLE_RATE, SAMPLES_PER_FRAME)
        input_rate = config.fmt.sample_rate
    if dtw_fused is None and "RUSTPOTTER_FUSED" in os.environ:
        dtw_fused = os.environ["RUSTPOTTER_FUSED"] == "1"
    fused_variant = int(os.environ.get("RUSTPOTTER_FUSED_VARIANT", "3"))
    det = config.detector
    refs = [(k, w) for k, w in wakewords if isinstance(w, WakewordRef)]
    models = [(k, w) for k, w in wakewords if isinstance(w, WakewordModel)]
    if not refs and not models:
        raise ValueError("no wakewords")
    mfcc_size = (refs + models)[0][1].mfcc_size
    for _, w in refs + models:
        if w.mfcc_size != mfcc_size:
            raise ValueError(
                "Usage of wakewords with different mfcc size is not supported"
            )
    dtw_fused, fused_variant, k4_for_band = choose_dtw_kernels(
        det.band_size, mfcc_size, dtw_fused, fused_variant)

    # max window length and gain target (detector.rs:328-346)
    max_frames = 0
    target_rms = float("nan")
    for _, w in refs:
        max_frames = max(max_frames, max(len(m) for m in w.samples_features.values()))
        target_rms = rust_f32_max(target_rms, w.rms_level)
    for _, w in models:
        max_frames = max(max_frames, w.train_size)
        target_rms = rust_f32_max(target_rms, w.rms_level)

    # the DTW arrays keep one (unused) row when there is no DTW wakeword
    D = len(refs)
    Dp = max(D, 1)
    kmax = max((len(w.samples_features) for _, w in refs), default=1)
    lmax = max((len(m) for _, w in refs for m in w.samples_features.values()), default=1)
    la_max = max(
        (len(w.avg_features) for _, w in refs if w.avg_features is not None), default=1
    )
    C = mfcc_size

    d_templates = np.zeros((Dp, kmax, lmax, C), np.float32)
    d_lens = np.ones((Dp, kmax), np.int32)
    d_kvalid = np.ones((Dp,), np.int32)
    d_avg = np.zeros((Dp, la_max, C), np.float32)
    d_avg_len = np.ones((Dp,), np.int32)
    d_has_avg = np.zeros((Dp,), bool)
    d_th = np.zeros((Dp,), np.float32)
    d_avg_th = np.zeros((Dp,), np.float32)
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

    nn_meta = []
    nn_params = []
    for _, w in models:
        labels = tuple(w.labels)
        nn_meta.append(NNMeta(
            train_size=w.train_size, labels=labels,
            none_idx=labels.index("none") if "none" in labels else -1,
            m_type=w.m_type.value,
        ))
        nn_params.append(params_from_tensor_data(w.weights))
    smax = max([int(d_kvalid.max()) if D else 1] + [len(m.labels) for m in nn_meta])

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
        nn_meta=tuple(nn_meta),
        dtw_pair_lens=tuple(int(x) for x in d_lens.reshape(-1)) + tuple(int(x) for x in d_avg_len),
        smax=int(smax),
        names=tuple([k for k, _ in refs] + [k for k, _ in models]),
        dtw_template_names=tuple(template_names),
        input_samples=input_samples,
        input_rate=input_rate,
        dtw_fused=dtw_fused,
        dtw_fused_variant=fused_variant,
        dtw_k4_for_band=k4_for_band,
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
            nn_params=nn_params,
            gain_ref_sqrt=np.float32(
                np.sqrt(gain_ref) if gain_ref == gain_ref and gain_ref >= 0 else np.nan
            ),
            threshold=np.float32(det.threshold),
            avg_threshold=np.float32(det.avg_threshold),
        ),
        device,
    )
    return static, params
