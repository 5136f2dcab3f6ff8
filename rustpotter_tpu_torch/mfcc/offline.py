"""Offline WAV → MFCC extraction (wakeword building).

Parity: the reference's src/mfcc/wav_file_extractor.rs:18-91 — wav parse,
re-encode and resample in exact frame chunks (the host encoder: a WAV at
44.1 or 48 kHz goes through `audio.resampler.FftResampler`), per-chunk RMS
collected with the median taken, MFCC extraction, cepstral mean
normalization — over all shifts of a recording at once, through the same
front-end ops as the streaming runtime (ops/frontend.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..audio.encoder import AudioEncoder
from ..config import AudioFmt, Endianness, SampleFormat
from ..constants import SAMPLES_PER_SHIFT
from ..device import DeviceLike, resolve_device
from ..ops import frontend
from ..utils.wav import WavSpec, read_wav


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


def compute_mfccs(path_or_bytes, mfcc_size: int,
                  device: DeviceLike = None) -> tuple[np.ndarray, float]:
    """WAV → (CMN-normalized MFCC matrix (frames, mfcc_size), median RMS
    level), the MFCCs computed on `device` (default: the CUDA card).

    num_coefficients = mfcc_size + 1 since coefficient 0 is dropped
    (wav_file_extractor.rs:36-40)."""
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
    samples = samples[: n_shifts * SAMPLES_PER_SHIFT]
    return mfcc_pipeline(samples, mfcc_size + 1, device), rms_level
