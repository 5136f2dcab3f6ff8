"""Template averaging via full-DTW alignment (wakeword build time, host-side).

Parity: the reference's src/mfcc/averager.rs:5-37 plus the path quirk of
dtw.rs:106-138: `retrieve_optimal_path` PRE-FILLS min(m-1, n-1) [0,0] entries,
so after the reverse the path carries that many spurious (0,0) pairs at the
END — each one pushes frames[0] into the position-0 average again. A copy of
`rustpotter_tpu.mfcc.averager`, reproducing that quirk exactly.
"""
from __future__ import annotations

import numpy as np

from ..ops.dtw import full_dtw_np, retrieve_optimal_path_np


def average_templates(templates: list[np.ndarray]) -> np.ndarray | None:
    """templates: list of (frames, coeffs) f32, already sorted longest-first.

    Iteratively DTW-aligns each template onto the running origin and averages
    features along the optimal path (f32 sums like the reference).
    """
    if not templates:
        return None
    origin = templates[0].astype(np.float32)
    for frames in templates[1:]:
        _, dp = full_dtw_np(origin, frames)
        path = retrieve_optimal_path_np(dp)
        # avgs[x][c] = [origin[x][c], frames[y][c] for each path entry (x, y)]
        counts = np.ones(len(origin), dtype=np.float32)
        sums = origin.astype(np.float32).copy()
        for x, y in path:
            sums[x] += frames[y]
            counts[x] += 1.0
        origin = (sums / counts[:, None]).astype(np.float32)
    return origin
