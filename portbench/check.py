"""The comparison that decides `correct`.

The program's reports for the sampled streams (every chunk the detector
was handed, set-up and profiled chunks included) and their window rows,
read every `window_every` chunks and after the last, are held to the
reference's (`reference.detector`):
  - `event_mismatch`: chunks whose `fired` differs, plus chunks fired on
    both sides whose wakeword index or candidate count differs (exact);
  - `score_gap`: the widest gap of a reported detection's score, avg
    score or per-template scores, over the chunks fired on both sides;
  - `mfcc_gap`: the widest gap of the window's MFCC rows, over every
    reading of the window;
  - `reference_fires`: the reference's reports on the sampled streams,
    which must not be none (the check would then read no scores).
Each number's limit is in `portbench/limits/<cell>.json`, with the
readings it was set from.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

NUMBERS = ("event_mismatch", "score_gap", "mfcc_gap")


def compare(port: Dict[str, np.ndarray], ref) -> Dict[str, float]:
    fp, fr = port["fired"], ref.fired
    both = fp & fr
    mismatch = int(np.sum(fp != fr))
    mismatch += int(np.sum(both & (port["ww"] != ref.ww)))
    mismatch += int(np.sum(both & (port["counter"] != ref.counter)))
    gap = 0.0
    if both.any():
        gap = max(float(np.max(np.abs(port["score"][both] - ref.score[both]))),
                  float(np.max(np.abs(port["avg_score"][both] - ref.avg_score[both]))),
                  float(np.max(np.abs(port["scores"][both] - ref.scores[both]))))
    return {
        "event_mismatch": float(mismatch),
        "score_gap": gap,
        "mfcc_gap": max(float(np.max(np.abs(w - ref.window(n)))) for n, w in port["windows"]),
        "reference_fires": float(np.sum(fr)),
    }


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number beside its limit; `ok` where it is within it."""
    out = {}
    for k in NUMBERS:
        v = numbers[k]
        out[k] = {"value": v, "limit": limits[k], "ok": bool(v <= limits[k])}
    v = numbers["reference_fires"]
    out["reference_fires"] = {"value": v, "limit": ">= 1", "ok": bool(v >= 1)}
    return out
