"""Wakeword (.rpw) file formats: WakewordRef, WakewordModel, legacy WakewordV2.

Parity: the reference's src/wakewords/wakeword_ref.rs:12-20,
wakeword_model.rs:11-18,68-73, wakeword_v2.rs:8-16, wakeword_file.rs:10-42.
Files are CBOR maps of the struct fields; loading uses the same try-chain
V2 → Ref → Model (detector.rs:152-176). A copy of
`rustpotter_tpu.wakewords.files`, byte-compatible through utils/cbor, except
that undecodable bytes also raise the unified ValueError.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, List, Optional

import numpy as np

from ..utils import cbor


class ModelType(Enum):
    TINY = "tiny"
    SMALL = "small"
    MEDIUM = "medium"
    LARGE = "large"

    @staticmethod
    def from_str(s: str) -> "ModelType":
        try:
            return ModelType(s.lower())
        except ValueError:
            raise ValueError("Unknown model type") from None

    @property
    def cbor_name(self) -> str:
        return self.value.capitalize()  # serde serializes the variant name


@dataclass
class TensorData:
    bytes: bytes
    dims: List[int]
    d_type: str = "f32"

    def to_numpy(self) -> np.ndarray:
        dt = {"f32": "<f4", "f64": "<f8", "u32": "<u4", "u8": "u1", "i64": "<i8"}[self.d_type]
        return np.frombuffer(bytes(self.bytes), dtype=dt).reshape(self.dims)

    @staticmethod
    def from_numpy(arr: np.ndarray) -> "TensorData":
        arr = np.ascontiguousarray(arr.astype("<f4"))
        return TensorData(bytes=arr.tobytes(), dims=list(arr.shape), d_type="f32")


@dataclass
class WakewordRef:
    """Template wakeword (DTW path)."""

    name: str
    samples_features: Dict[str, np.ndarray]  # file name → (frames, mfcc_size) f32
    avg_features: Optional[np.ndarray] = None
    threshold: Optional[float] = None
    avg_threshold: Optional[float] = None
    rms_level: float = 0.0
    mfcc_size: int = 0

    def __post_init__(self):
        if self.mfcc_size == 0 and self.samples_features:
            first = next(iter(self.samples_features.values()))
            self.mfcc_size = int(np.asarray(first).shape[1])

    def to_cbor_obj(self) -> dict:
        return {
            "name": self.name,
            "avg_features": _matrix_out(self.avg_features),
            "samples_features": {k: _matrix_out(v) for k, v in self.samples_features.items()},
            "threshold": _f32_opt(self.threshold),
            "avg_threshold": _f32_opt(self.avg_threshold),
            "rms_level": cbor.Float32(self.rms_level),
            "mfcc_size": int(self.mfcc_size),
        }

    @staticmethod
    def from_cbor_obj(obj: dict) -> "WakewordRef":
        _expect_keys(obj, {"name", "avg_features", "samples_features", "threshold", "avg_threshold", "rms_level", "mfcc_size"})
        return WakewordRef(
            name=obj["name"],
            samples_features={k: _matrix_in(v) for k, v in obj["samples_features"].items()},
            avg_features=_matrix_in(obj["avg_features"]) if obj["avg_features"] is not None else None,
            threshold=obj["threshold"],
            avg_threshold=obj["avg_threshold"],
            rms_level=float(obj["rms_level"]),
            mfcc_size=int(obj["mfcc_size"]),
        )


@dataclass
class WakewordV2:
    """Deprecated v2 format; converts into WakewordRef (wakeword_v2.rs:18-30)."""

    name: str
    samples_features: Dict[str, np.ndarray]
    avg_features: Optional[np.ndarray]
    threshold: Optional[float]
    avg_threshold: Optional[float]
    rms_level: float
    enabled: bool = True

    def to_ref(self) -> WakewordRef:
        return WakewordRef(
            name=self.name,
            samples_features=self.samples_features,
            avg_features=self.avg_features,
            threshold=self.threshold,
            avg_threshold=self.avg_threshold,
            rms_level=self.rms_level,
        )

    @staticmethod
    def from_cbor_obj(obj: dict) -> "WakewordV2":
        _expect_keys(obj, {"name", "avg_features", "samples_features", "threshold", "avg_threshold", "rms_level", "enabled"})
        return WakewordV2(
            name=obj["name"],
            samples_features={k: _matrix_in(v) for k, v in obj["samples_features"].items()},
            avg_features=_matrix_in(obj["avg_features"]) if obj["avg_features"] is not None else None,
            threshold=obj["threshold"],
            avg_threshold=obj["avg_threshold"],
            rms_level=float(obj["rms_level"]),
            enabled=bool(obj["enabled"]),
        )


@dataclass
class WakewordModel:
    """Classifier-NN wakeword."""

    labels: List[str]
    train_size: int
    mfcc_size: int
    m_type: ModelType
    weights: Dict[str, TensorData] = field(default_factory=dict)
    rms_level: float = float("nan")

    def to_cbor_obj(self) -> dict:
        return {
            "labels": list(self.labels),
            "train_size": int(self.train_size),
            "mfcc_size": int(self.mfcc_size),
            "m_type": self.m_type.cbor_name,
            "weights": {
                k: {"bytes": list(v.bytes), "dims": list(v.dims), "d_type": v.d_type}
                for k, v in self.weights.items()
            },
            "rms_level": cbor.Float32(self.rms_level),
        }

    @staticmethod
    def from_cbor_obj(obj: dict) -> "WakewordModel":
        _expect_keys(obj, {"labels", "train_size", "mfcc_size", "m_type", "weights", "rms_level"})
        return WakewordModel(
            labels=list(obj["labels"]),
            train_size=int(obj["train_size"]),
            mfcc_size=int(obj["mfcc_size"]),
            m_type=ModelType.from_str(obj["m_type"]),
            weights={
                k: TensorData(bytes=bytes(v["bytes"]), dims=list(v["dims"]), d_type=v["d_type"])
                for k, v in obj["weights"].items()
            },
            rms_level=float(obj["rms_level"]),
        )


def _expect_keys(obj: dict, keys: set) -> None:
    if not isinstance(obj, dict) or set(obj.keys()) != keys:
        raise ValueError("wakeword file field mismatch")


def _matrix_in(rows: list) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32)


def _matrix_out(m: Optional[np.ndarray]):
    if m is None:
        return None
    return [[cbor.Float32(x) for x in row] for row in np.asarray(m, dtype=np.float32).tolist()]


def _f32_opt(v: Optional[float]):
    return None if v is None else cbor.Float32(v)


def load_wakeword(path_or_buffer) -> object:
    """Try-chain V2 → WakewordRef → WakewordModel, like detector.rs:152-176.
    Bytes that are not CBOR raise the same ValueError as a field mismatch."""
    if isinstance(path_or_buffer, (bytes, bytearray)):
        data = bytes(path_or_buffer)
    else:
        with open(path_or_buffer, "rb") as f:
            data = f.read()
    try:
        obj = cbor.loads(data)
    except (ValueError, IndexError, struct.error):
        raise ValueError("Unable to decode wakeword file") from None
    for cls in (WakewordV2, WakewordRef, WakewordModel):
        try:
            w = cls.from_cbor_obj(obj)
            return w.to_ref() if isinstance(w, WakewordV2) else w
        except (ValueError, KeyError, TypeError, AttributeError):
            continue
    raise ValueError("Unable to decode wakeword file")


def save_wakeword(wakeword, path: str) -> None:
    with open(path, "wb") as f:
        cbor.dump(wakeword.to_cbor_obj(), f)
