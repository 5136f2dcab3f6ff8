"""Score maps.

Parity: the reference's src/mfcc/comparator.rs:15-26 (logistic cost→score
map) and src/wakewords/nn/wakeword_nn.rs:161-163 (inverse similarity). The
ScoreMode reduction lives in runtime/stream_step._reduce_mode.
"""
from __future__ import annotations

import torch


def cost_to_score(normalized_cost: torch.Tensor, score_ref: float) -> torch.Tensor:
    """1 / (1 + e^((cost - ref)/ref)) — maps DTW cost into (0, 1)."""
    ref = torch.tensor(score_ref, dtype=torch.float32)
    return 1.0 / (1.0 + torch.exp((normalized_cost - ref) / ref))


def nn_inverse_similarity(n1: torch.Tensor, n2: torch.Tensor,
                          reference: torch.Tensor) -> torch.Tensor:
    """1 - 1/(1 + e^(((n1-n2) - ref)/ref)) — NN logit pair → score."""
    return 1.0 - (1.0 / (1.0 + torch.exp(((n1 - n2) - reference) / reference)))
