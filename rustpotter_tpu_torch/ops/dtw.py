"""Dynamic time warping: build-time host DTW and the plain banded DP.

Reference semantics (the reference's src/mfcc/dtw.rs):
  - full O(mn) DP with cosine distance + optimal-path backtrack (dtw.rs:11-55,
    106-138) — used only at wakeword build time by the averager, so it stays a
    host (numpy) routine with dynamic shapes.
  - Sakoe-Chiba banded DP with window = max(band, |m-n|) (dtw.rs:56-105). The
    reference pads the matrix to (m+1)x(n+1), then resizes dropping column 0 and
    reads the similarity at [m-1][n-1] of the RESIZED matrix — i.e. padded cell
    [m-1][n]. This off-by-one is reproduced exactly: `banded_dtw_*` returns
    padded dp[m-1][n].

The numpy helpers are copies of `rustpotter_tpu.ops.dtw`. `band_costs` and
`banded_dtw_batch` are its band-coordinate DP in torch: for row r the band
covers columns c ∈ [r-w, r+w), stored as a 2w vector with offset
j = c - (r - w). They are the plain reference that the fused chunk kernel
(ops/fused_dtw.py) is held against.
"""
from __future__ import annotations

import numpy as np
import torch

INF = np.float32(np.inf)


# --------------------------------------------------------------------- host

def cosine_distance_np(a: np.ndarray, b: np.ndarray) -> np.float32:
    """1 - cosine_similarity, f32, with the magnitude==0 → similarity 0 guard
    (reference src/mfcc/comparator.rs:28-48)."""
    a = a.astype(np.float32)
    b = b.astype(np.float32)
    dot_ab = np.float32(np.dot(a, b))
    dot_a = np.float32(np.dot(a, a))
    dot_b = np.float32(np.dot(b, b))
    magnitude = np.float32(np.sqrt(np.float32(dot_a * dot_b)))
    sim = np.float32(0.0) if magnitude == 0.0 else np.float32(dot_ab / magnitude)
    return np.float32(1.0) - sim


def full_dtw_np(a: np.ndarray, b: np.ndarray) -> tuple[np.float32, np.ndarray]:
    """Unbanded DTW (dtw.rs:11-55). a: (m, c), b: (n, c) float32.

    Returns (similarity = dp[m-1][n-1], dp matrix) for path backtracking.
    """
    m, n = len(a), len(b)
    an = a / np.linalg.norm(a, axis=1, keepdims=True).clip(min=np.finfo(np.float32).tiny)
    bn = b / np.linalg.norm(b, axis=1, keepdims=True).clip(min=np.finfo(np.float32).tiny)
    # distance matrix in one shot; zero-magnitude rows → similarity 0
    sims = (an @ bn.T).astype(np.float32)
    a_zero = (a == 0).all(axis=1)
    b_zero = (b == 0).all(axis=1)
    sims[a_zero, :] = 0.0
    sims[:, b_zero] = 0.0
    cost = (np.float32(1.0) - sims).astype(np.float32)
    dp = np.full((m, n), INF, dtype=np.float32)
    dp[0, 0] = cost[0, 0]
    for i in range(1, m):
        dp[i, 0] = cost[i, 0] + dp[i - 1, 0]
    for j in range(1, n):
        dp[0, j] = cost[0, j] + dp[0, j - 1]
    for i in range(1, m):
        # dp[i, j] = cost + min(dp[i-1,j], dp[i-1,j-1], dp[i,j-1])
        up = dp[i - 1, 1:]
        diag = dp[i - 1, :-1]
        best = np.minimum(up, diag)
        row = dp[i]
        acc = row[0]
        c = cost[i]
        for j in range(1, n):
            acc = c[j] + min(best[j - 1], acc)
            row[j] = acc
    return dp[m - 1, n - 1], dp


def retrieve_optimal_path_np(dp: np.ndarray) -> list[tuple[int, int]]:
    """Backtrack (dtw.rs:106-138): greedy min of (up, left, diag) with the
    reference's priority matches > insertion > deletion on ties."""
    m, n = dp.shape
    i, j = m - 1, n - 1
    path = [(0, 0)] * min(i, j)  # reference pre-fills min(m-1,n-1) zero entries
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            insertion = dp[i - 1, j]
            deletion = dp[i, j - 1]
            matches = dp[i - 1, j - 1]
            mn = min(insertion, deletion, matches)
            if mn == matches:
                i, j = i - 1, j - 1
            elif mn == insertion:
                i -= 1
            else:
                j -= 1
        elif i > 0:
            i -= 1
        else:
            j -= 1
        path.append((i, j))
    path.reverse()
    return path


def banded_dtw_np(a: np.ndarray, b: np.ndarray, band: int) -> np.float32:
    """Reference-shaped banded DTW on host (golden oracle)."""
    m, n = len(a), len(b)
    w = max(band, abs(m - n))
    dp = np.full((m + 1, n + 1), INF, dtype=np.float32)
    dp[0, 0] = np.float32(0.0)
    for r in range(1, m + 1):
        start = max(1, r - w)
        for c in range(start, min(n + 1, r + w)):
            cost = cosine_distance_np(a[r - 1], b[c - 1])
            dp[r, c] = cost + min(dp[r - 1, c], dp[r, c - 1], dp[r - 1, c - 1])
    return dp[m - 1, n]


# -------------------------------------------------------------------- torch

def band_costs(templates: torch.Tensor, windows: torch.Tensor, band: int) -> torch.Tensor:
    """Cosine-distance costs restricted to the DP band.

    templates: (..., L, C) — rows r = 0..L-1 (DP row r+1)
    windows:   (..., L, C) — cols c = 0..L-1 (DP col c+1)
    returns    (..., L, 2w) where [..., r, j] = dist(T[r], W[r - w + j])
               (wrapping at the ends; out-of-range cells are masked in the DP).
    """
    w = band
    t_norm = torch.sum(templates * templates, dim=-1)  # (..., L)
    w_norm = torch.sum(windows * windows, dim=-1)
    cols = []
    for j in range(2 * w):
        shift = j - w  # c = r + shift
        rolled = torch.roll(windows, -shift, dims=-2)
        rolled_norm = torch.roll(w_norm, -shift, dims=-1)
        dot = torch.sum(templates * rolled, dim=-1)  # (..., L)
        mag = torch.sqrt(t_norm * rolled_norm)
        zero = mag == 0.0
        sim = torch.where(zero, 0.0, dot / torch.where(zero, 1.0, mag))
        cols.append(1.0 - sim)
    return torch.stack(cols, dim=-1)  # (..., L, 2w)


def banded_dtw_batch(costs: torch.Tensor, lengths: torch.Tensor, band: int) -> torch.Tensor:
    """Batched band-coordinate DP.

    costs:   (B, L, 2w) band costs from `band_costs`.
    lengths: (B,) actual sequence lengths (≤ L); rows beyond are ignored.
    returns  (B,) similarity = padded dp[m-1][n] (the reference off-by-one),
             harvested at offset j = w + 1 of row m-1.
    """
    B, L, W2 = costs.shape
    w = band
    assert W2 == 2 * w
    dev = costs.device
    inf = torch.tensor(float("inf"), device=dev)
    prev = torch.full((B, W2), float("inf"), device=dev)
    prev[:, w] = 0.0
    result = torch.full((B,), float("inf"), device=dev)
    js = torch.arange(W2, device=dev)
    lens = lengths.to(dev).long()
    for r in range(1, L + 1):
        c = r - w + js  # (2w,) absolute column per lane
        valid = (c >= max(1, r - w)) & (c <= torch.clamp(lens[:, None], max=r + w - 1))
        ins = torch.cat([prev[:, 1:], torch.full((B, 1), float("inf"), device=dev)], dim=1)
        base = torch.minimum(ins, prev)
        cost = torch.where(valid, costs[:, r - 1], inf)
        cur = cost + base
        # deletion chain, strictly left to right (the reference's f32 order)
        for j in range(1, W2):
            cur[:, j] = torch.minimum(cur[:, j], cost[:, j] + cur[:, j - 1])
        cur = torch.where(valid, cur, inf)
        result = torch.where(lens - 1 == r, cur[:, w + 1], result)
        prev = cur
    return result
