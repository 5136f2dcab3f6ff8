"""Classifier-NN wakeword models: architecture zoo, forward pass, weight IO.

The counterpart of `rustpotter_tpu.wakewords.nn`. Parity: the reference's
src/wakewords/nn/wakeword_nn.rs:274-389 (Tiny/Small/Medium/Large MLPs with
the exact hidden-size formulas; ReLU between Linear layers) and :225-259
(TensorData raw-byte weight de/serialization).

Weights are numpy on the host (`init_params` draws them with the JAX
package's `default_rng` sequence, so a seed gives bit-equal weights);
`forward` and `forward_tail` run on tensors in fp32 (the package disables
TF32), the products as `torch.matmul`.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..constants import MFCCS_EXTRACTOR_OUT_SHIFTS
from .files import ModelType, TensorData

Params = List[Tuple[np.ndarray, np.ndarray]]


def layer_sizes(m_type: ModelType, input_size: int, mfcc_size: int, labels_size: int) -> List[int]:
    """[input, hidden..., labels] — formulas from wakeword_nn.rs:305-389.
    train_frames = input_size / mfcc_size; OUT_SHIFTS = 3."""
    frames = input_size // mfcc_size
    s = MFCCS_EXTRACTOR_OUT_SHIFTS
    if m_type == ModelType.TINY:
        return [input_size, frames // (s * 5), labels_size]
    if m_type == ModelType.SMALL:
        h1 = frames // (s * 2)
        return [input_size, h1, h1 // 2, labels_size]
    if m_type == ModelType.MEDIUM:
        return [input_size, frames // s, frames // (s * 2), labels_size]
    return [input_size, (frames // s) * 2, frames // (s * 2), labels_size]


def weight_names(n_layers: int) -> List[str]:
    names = []
    for i in range(1, n_layers):
        names.append(f"ln{i}.weight")
        names.append(f"ln{i}.bias")
    return names


def params_from_tensor_data(weights: Dict[str, TensorData]) -> Params:
    """[(W(out,in), b(out,)), ...] ordered by layer index."""
    n = len(weights) // 2
    return [
        (
            weights[f"ln{i}.weight"].to_numpy().astype(np.float32),
            weights[f"ln{i}.bias"].to_numpy().astype(np.float32),
        )
        for i in range(1, n + 1)
    ]


def params_to_tensor_data(params: Params) -> Dict[str, TensorData]:
    out: Dict[str, TensorData] = {}
    for i, (w, b) in enumerate(params, start=1):
        out[f"ln{i}.weight"] = TensorData.from_numpy(np.asarray(w))
        out[f"ln{i}.bias"] = TensorData.from_numpy(np.asarray(b))
    return out


def init_params(
    m_type: ModelType, input_size: int, mfcc_size: int, labels_size: int, seed: int = 0
) -> Params:
    """Kaiming-normal weights / uniform(-1/√in, 1/√in) biases like candle's
    `linear` default init (candle-nn 0.2.2) — the reference's training start."""
    sizes = layer_sizes(m_type, input_size, mfcc_size, labels_size)
    rng = np.random.default_rng(seed)
    params = []
    for i in range(len(sizes) - 1):
        fan_in, fan_out = sizes[i], sizes[i + 1]
        std = np.sqrt(2.0 / fan_in)
        w = rng.normal(0.0, std, size=(fan_out, fan_in)).astype(np.float32)
        bound = 1.0 / np.sqrt(fan_in)
        b = rng.uniform(-bound, bound, size=(fan_out,)).astype(np.float32)
        params.append((w, b))
    return params


def forward(params: Sequence[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """x: (..., input_size) → logits (..., labels). ReLU between layers,
    none after the last (wakeword_nn.rs:318-322)."""
    n = len(params)
    for i, (w, b) in enumerate(params):
        x = torch.matmul(x, w.T) + b
        if i < n - 1:
            x = torch.relu(x)
    return x


def forward_tail(params: Sequence[Tuple[torch.Tensor, torch.Tensor]], x: torch.Tensor) -> torch.Tensor:
    """Layers after the first, given the first layer's PRE-activation output
    (the stream steps compute layer 0 themselves with rotation-folded
    weights). Same ReLU placement as `forward`."""
    for w, b in params[1:]:
        x = torch.matmul(torch.relu(x), w.T) + b
    return x
