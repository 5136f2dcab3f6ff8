"""Banded DTW of rustpotter's comparator, and its full DTW for averaging.

Banded (rustpotter src/mfcc/dtw.rs, the detector's scorer): a template of m
frames against a window of n frames, cost = 1 - cosine similarity (0 where
the product of the two squared norms is 0), a (m+1) x (n+1) matrix of +inf
with dp[0][0] = 0, and for each row r = 1 .. m the columns c from
max(1, r - w) to min(n + 1, r + w) (exclusive), w = max(band, |m - n|):
dp[r][c] = cost(r - 1, c - 1) + min(dp[r-1][c], dp[r][c-1], dp[r-1][c-1]).
The similarity is dp[m-1][n], the cell the Rust code reads after dropping
column 0 of the matrix.

Full (dtw.rs, used when a wakeword's templates are averaged): the unbanded
matrix over every cell and its greedy backtrack, which pre-fills
min(m-1, n-1) pairs (0, 0), matches before insertions before deletions.
"""
from __future__ import annotations

import numpy as np
import torch

from .products import matmul

INF = float("inf")


def cosine_costs(rows: torch.Tensor, cols: torch.Tensor, precision: str) -> torch.Tensor:
    """rows (C,) one template frame, cols (M, k, C) window frames ->
    (M, k) costs 1 - cos."""
    M, k, C = cols.shape
    dot = matmul(cols.reshape(M * k, C), rows.reshape(C, 1), precision).reshape(M, k)
    mag = torch.sqrt(torch.dot(rows, rows) * torch.sum(cols * cols, dim=-1))
    sim = torch.where(mag == 0, torch.zeros_like(dot), dot / torch.where(mag == 0, 1.0, mag))
    return 1.0 - sim


def banded_dtw(template: torch.Tensor, windows: torch.Tensor, band: int,
               precision: str) -> torch.Tensor:
    """template (m, C) against windows (M, n, C) -> similarities (M,)."""
    m, n = template.shape[0], windows.shape[1]
    w = max(band, abs(m - n))
    M = windows.shape[0]
    prev = torch.full((M, n + 1), INF, dtype=windows.dtype, device=windows.device)
    prev[:, 0] = 0.0
    for r in range(1, m):  # rows past m - 1 do not reach dp[m-1][n]
        lo, hi = max(1, r - w), min(n + 1, r + w)
        cost = cosine_costs(template[r - 1], windows[:, lo - 1:hi - 1], precision)
        cur = torch.full_like(prev, INF)
        left = cur[:, lo - 1]
        for i, c in enumerate(range(lo, hi)):
            left = cost[:, i] + torch.minimum(torch.minimum(prev[:, c], prev[:, c - 1]), left)
            cur[:, c] = left
        prev = cur
    return prev[:, n]


def full_dtw(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The unbanded DP matrix (m, n) of a (m, C) against b (n, C)."""
    an = np.sqrt(np.sum(a * a, axis=1))[:, None]
    bn = np.sqrt(np.sum(b * b, axis=1))[None, :]
    mag = np.sqrt(an ** 2 * bn ** 2)
    dot = a @ b.T
    cost = 1.0 - np.where(mag == 0, 0.0, dot / np.where(mag == 0, 1.0, mag))
    m, n = cost.shape
    dp = np.full((m, n), np.inf)
    dp[0, 0] = cost[0, 0]
    for j in range(1, n):
        dp[0, j] = cost[0, j] + dp[0, j - 1]
    for i in range(1, m):
        dp[i, 0] = cost[i, 0] + dp[i - 1, 0]
        for j in range(1, n):
            dp[i, j] = cost[i, j] + min(dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1])
    return dp


def optimal_path(dp: np.ndarray) -> list:
    m, n = dp.shape
    i, j = m - 1, n - 1
    path = [(0, 0)] * min(i, j)
    while i > 0 or j > 0:
        if i > 0 and j > 0:
            best = min(dp[i - 1, j], dp[i, j - 1], dp[i - 1, j - 1])
            if best == dp[i - 1, j - 1]:
                i, j = i - 1, j - 1
            elif best == dp[i - 1, j]:
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


def average_templates(templates: list) -> np.ndarray:
    """rustpotter src/mfcc/averager.rs: templates longest first; each is
    aligned onto the running average by full DTW and averaged along the
    path into the average's frames."""
    origin = np.asarray(templates[0], np.float64)
    for frames in templates[1:]:
        frames = np.asarray(frames, np.float64)
        sums, counts = origin.copy(), np.ones(len(origin))
        for x, y in optimal_path(full_dtw(origin, frames)):
            sums[x] += frames[y]
            counts[x] += 1.0
        origin = sums / counts[:, None]
    return origin
