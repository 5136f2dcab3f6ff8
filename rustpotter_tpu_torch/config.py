"""Configuration tree for the wakeword spotter.

Parity: the reference's src/config.rs (same option surface, Python dataclasses).
A copy of `rustpotter_tpu.config`: plain dataclasses with reference-matching
defaults, using only the standard library and `constants`.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

from .constants import (
    COMPARATOR_DEFAULT_BAND_SIZE,
    DETECTOR_DEFAULT_AVG_THRESHOLD,
    DETECTOR_DEFAULT_MIN_SCORES,
    DETECTOR_DEFAULT_REFERENCE,
    DETECTOR_DEFAULT_THRESHOLD,
    DETECTOR_INTERNAL_SAMPLE_RATE,
)


class SampleFormat(enum.Enum):
    """Sample type/size of the input audio bytes (reference src/audio/audio_types.rs:4-36)."""

    I8 = "i8"
    I16 = "i16"
    I32 = "i32"
    F32 = "f32"

    @property
    def bits_per_sample(self) -> int:
        return {SampleFormat.I8: 8, SampleFormat.I16: 16, SampleFormat.I32: 32, SampleFormat.F32: 32}[self]

    @property
    def bytes_per_sample(self) -> int:
        return self.bits_per_sample // 8

    @staticmethod
    def int_of_size(bit_size: int) -> Optional["SampleFormat"]:
        return {8: SampleFormat.I8, 16: SampleFormat.I16, 32: SampleFormat.I32}.get(bit_size)

    @staticmethod
    def float_of_size(bit_size: int) -> Optional["SampleFormat"]:
        return {32: SampleFormat.F32}.get(bit_size)

    def __str__(self) -> str:
        return self.value


class Endianness(enum.Enum):
    """Byte order of the input audio stream (reference src/audio/audio_types.rs:52-56)."""

    BIG = "big"
    LITTLE = "little"
    NATIVE = "native"


class ScoreMode(enum.Enum):
    """How per-template scores reduce to one score (reference src/config.rs:86-96)."""

    AVERAGE = "average"
    MAX = "max"
    MEDIAN = "median"
    P25 = "p25"
    P50 = "p50"
    P75 = "p75"
    P80 = "p80"
    P90 = "p90"
    P95 = "p95"

    @staticmethod
    def from_str(s: str) -> "ScoreMode":
        try:
            return ScoreMode(s.lower())
        except ValueError:
            raise ValueError("Unknown score mode") from None

    def __str__(self) -> str:
        return self.value


class VADMode(enum.Enum):
    """Voice-activity detector sensibility (reference src/config.rs:134-147)."""

    EASY = "easy"
    MEDIUM = "medium"
    HARD = "hard"

    @property
    def value_factor(self) -> float:
        return {VADMode.EASY: 2.0, VADMode.MEDIUM: 2.5, VADMode.HARD: 3.0}[self]

    @staticmethod
    def from_str(s: str) -> "VADMode":
        try:
            return VADMode(s.lower())
        except ValueError:
            raise ValueError("Unknown vad mode") from None

    def __str__(self) -> str:
        return self.value


@dataclass
class AudioFmt:
    """Input wav format (reference src/config.rs:10-29)."""

    sample_rate: int = DETECTOR_INTERNAL_SAMPLE_RATE
    sample_format: SampleFormat = SampleFormat.F32
    channels: int = 1
    endianness: Endianness = Endianness.LITTLE


@dataclass
class GainNormalizationConfig:
    """Gain-normalizer filter config (reference src/config.rs:32-52)."""

    enabled: bool = False
    gain_ref: Optional[float] = None
    min_gain: float = 0.1
    max_gain: float = 1.0


@dataclass
class BandPassConfig:
    """Band-pass filter config (reference src/config.rs:55-71)."""

    enabled: bool = False
    low_cutoff: float = 80.0
    high_cutoff: float = 400.0


@dataclass
class FiltersConfig:
    """Audio filters config (reference src/config.rs:75-84)."""

    gain_normalizer: GainNormalizationConfig = field(default_factory=GainNormalizationConfig)
    band_pass: BandPassConfig = field(default_factory=BandPassConfig)


@dataclass
class DetectorConfig:
    """Detection scoring behavior (reference src/config.rs:172-208)."""

    avg_threshold: float = DETECTOR_DEFAULT_AVG_THRESHOLD
    threshold: float = DETECTOR_DEFAULT_THRESHOLD
    min_scores: int = DETECTOR_DEFAULT_MIN_SCORES
    eager: bool = False
    score_ref: float = DETECTOR_DEFAULT_REFERENCE
    band_size: int = COMPARATOR_DEFAULT_BAND_SIZE
    score_mode: ScoreMode = ScoreMode.MAX
    vad_mode: Optional[VADMode] = None
    record_path: Optional[str] = None


@dataclass
class RustpotterConfig:
    """Top-level config (reference src/config.rs:212-219)."""

    fmt: AudioFmt = field(default_factory=AudioFmt)
    detector: DetectorConfig = field(default_factory=DetectorConfig)
    filters: FiltersConfig = field(default_factory=FiltersConfig)
