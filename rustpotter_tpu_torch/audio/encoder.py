"""Audio encoder: byte decode, first-channel downmix, sample-rate conversion.

Capability parity with the reference's src/audio/encoder.rs (AudioEncoder) and
src/audio/audio_types.rs (Sample scaling by T::MAX — audio_types.rs:102-122).
A copy of `rustpotter_tpu.audio.encoder`, host-side numpy: input at another
rate than the target is cut into `chunk_sizes` frames and resampled by the
host `FftResampler` (1440 → 480 samples at 48 kHz). The stream steps can
resample in the graph instead (`build_bundle(..., in_graph_resample=True)`).
"""
from __future__ import annotations

import numpy as np

from ..config import AudioFmt, Endianness, SampleFormat
from ..constants import DETECTOR_INTERNAL_SAMPLE_RATE, MFCCS_EXTRACTOR_FRAME_LENGTH_MS
from .resampler import FftResampler, chunk_sizes

_INT_SCALE = {
    SampleFormat.I8: np.float32(127.0),
    SampleFormat.I16: np.float32(32767.0),
    SampleFormat.I32: np.float32(2147483647.0),
}

_NP_DTYPES = {
    SampleFormat.I8: "i1",
    SampleFormat.I16: "i2",
    SampleFormat.I32: "i4",
    SampleFormat.F32: "f4",
}


def decode_bytes(buffer: bytes, fmt: SampleFormat, endianness: Endianness) -> np.ndarray:
    """Raw PCM bytes → f32 samples; int samples scaled by 1/T::MAX."""
    if endianness == Endianness.LITTLE:
        order = "<"
    elif endianness == Endianness.BIG:
        order = ">"
    else:
        order = "="
    arr = np.frombuffer(buffer, dtype=np.dtype(order + _NP_DTYPES[fmt]))
    return samples_to_f32(arr, fmt)


def samples_to_f32(samples: np.ndarray, fmt: SampleFormat) -> np.ndarray:
    if fmt == SampleFormat.F32:
        return samples.astype(np.float32)
    return samples.astype(np.float32) / _INT_SCALE[fmt]


class AudioEncoder:
    """Fixed-frame re-encoder: bytes/samples → mono f32 @ the target rate.

    Parity: encoder.rs:63-102 (sizing), :26-62 (decode → downmix → resample)."""

    def __init__(
        self,
        fmt: AudioFmt,
        frame_length_ms: int = MFCCS_EXTRACTOR_FRAME_LENGTH_MS,
        target_sample_rate: int = DETECTOR_INTERNAL_SAMPLE_RATE,
    ):
        self.fmt = fmt
        out_frame = target_sample_rate * frame_length_ms // 1000
        if fmt.sample_rate != target_sample_rate:
            in_frame, out_frame = chunk_sizes(fmt.sample_rate, target_sample_rate, out_frame)
            self.resampler = FftResampler(in_frame, out_frame)
            self.input_samples_per_frame = in_frame * fmt.channels
        else:
            self.resampler = None
            self.input_samples_per_frame = (
                fmt.sample_rate * frame_length_ms // 1000 * fmt.channels
            )
        self.output_samples_per_frame = out_frame

    def get_input_frame_length(self) -> int:
        return self.input_samples_per_frame

    def get_output_frame_length(self) -> int:
        return self.output_samples_per_frame

    def get_input_byte_length(self) -> int:
        return self.input_samples_per_frame * self.fmt.sample_format.bytes_per_sample

    def reset(self) -> None:
        if self.resampler is not None:
            self.resampler.reset()

    def encode_and_resample(self, buffer: bytes) -> np.ndarray:
        samples = decode_bytes(buffer, self.fmt.sample_format, self.fmt.endianness)
        return self.reencode_to_mono_with_sample_rate(samples)

    def rencode_and_resample(self, samples: np.ndarray) -> np.ndarray:
        return self.reencode_to_mono_with_sample_rate(
            samples_to_f32(np.asarray(samples), self.fmt.sample_format)
        )

    def reencode_to_mono_with_sample_rate(self, samples: np.ndarray) -> np.ndarray:
        if self.fmt.channels != 1:
            samples = samples[:: self.fmt.channels]  # first-channel downmix
        if self.resampler is None:
            return samples.astype(np.float32)
        return self.resampler.process(samples)
