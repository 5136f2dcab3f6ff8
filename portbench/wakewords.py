"""A configuration's wakewords as arrays, made by the benchmark.

Both sides get the same arrays: the program as its wakeword objects, the
reference as `reference.detector` wakewords.

  - A DTW wakeword's templates are the MFCCs (less their mean) of its
    utterances, worked out by the reference's front-end in float64 on the
    host, and its averaged template the reference's average of them; all
    stored as float32, as a wakeword file holds them. They do not depend
    on the seed.
  - An NN wakeword's weights are drawn from the seed on the card by a
    `torch.Generator` (normal with std sqrt(2 / fan_in), biases uniform in
    +-1 / sqrt(fan_in)), one call per tensor. Where the configuration asks
    for a firing unit, first-layer unit 0 is the CMN'd MFCC window that ends
    just after the utterance in the correctness stream, scaled to give 1
    there; layer 2's unit 0 passes max(0, gain2 * h0 + bias2); the
    wakeword's logit is gain3 times that and the other label's logit a
    constant: the recipe of the program's `synthetic.build_firing_nn_wakeword`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .reference import detector as ref
from .reference.dtw import average_templates
from .reference.frontend import Frontend, offline_mfccs, stream_frames, pre_emphasis
from .synth import SHIFT, correctness_stream, utterances


@dataclass
class Wakewords:
    names: List[str]
    reference: list  # reference.detector wakewords, in the same order
    specs: list  # the configuration's wakeword entries


def window_frames(config: dict) -> int:
    return max(max(w["utterances"]["frames"]) if w["kind"] == "dtw" else w["train_size"]
               for w in config["wakewords"])


def _dtw(spec: dict, C: int, det: dict) -> ref.DtwWakeword:
    front = Frontend(C, "cpu", "f64")
    feats = {f"s{i}.wav": offline_mfccs(torch.from_numpy(u), front).numpy()
             for i, u in enumerate(utterances(spec["utterances"]))}
    longest_first = [m for _, m in sorted(feats.items(), key=lambda kv: (-len(kv[1]), kv[0]))]
    avg = average_templates(longest_first).astype(np.float32) if spec["average"] else None
    return ref.DtwWakeword(
        templates=[(k, v.astype(np.float32)) for k, v in sorted(feats.items())],
        avg=avg, threshold=det["threshold"], avg_threshold=det["avg_threshold"])


def _nn(spec: dict, C: int, gen: torch.Generator, device) -> ref.NnWakeword:
    sizes = spec["layers"]
    layers = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        w = torch.randn((fan_out, fan_in), generator=gen, device=device) * (2.0 / fan_in) ** 0.5
        b = (torch.rand((fan_out,), generator=gen, device=device) * 2 - 1) / fan_in ** 0.5
        layers.append([w.cpu().numpy(), b.cpu().numpy()])
    fire = spec.get("firing_unit")
    if fire:
        ts = spec["train_size"]
        utt = utterances(fire["utterances"])[0]
        x = torch.from_numpy(correctness_stream(ts, utt).reshape(-1))
        front = Frontend(C, "cpu", "f64")
        frames = stream_frames(pre_emphasis(x.double())[None])[0, 3:]
        mfcc = front.mfcc(frames).numpy()
        end = (ts // 3 + 4) * 3 + len(utt) // SHIFT + 2
        tpl = mfcc[end - ts:end] - mfcc[end - ts:end].mean(axis=0)
        (w1, b1), (w2, b2), (w3, b3) = layers
        w1[0] = tpl.reshape(-1) / np.sum(tpl * tpl)
        b1[0] = 0.0
        w2[0] = 0.0
        w2[0, 0], b2[0] = fire["gain2"], fire["bias2"]
        w3[:] = 0.0
        w3[0, 0] = fire["gain3"]
        b3[:] = fire["logit_biases"]
    return ref.NnWakeword(labels=list(spec["labels"]), train_size=spec["train_size"],
                          layers=[(w.astype(np.float32), b.astype(np.float32)) for w, b in layers])


def build(config: dict, gen: torch.Generator, device) -> Wakewords:
    """The configuration's wakewords, DTW ones first (the detector scores
    DTW wakewords before NN ones)."""
    C, det = config["mfcc_size"], config["detector"]
    specs = sorted(config["wakewords"], key=lambda w: w["kind"] != "dtw")
    out = [_dtw(s, C, det) if s["kind"] == "dtw" else _nn(s, C, gen, device) for s in specs]
    return Wakewords([s["name"] for s in specs], out, specs)


def settings(config: dict) -> ref.Settings:
    d = config["detector"]
    if d["score_mode"] != "max" or d["vad_mode"] is not None:
        raise ValueError("the reference detector runs MAX score mode without VAD")
    return ref.Settings(threshold=d["threshold"], avg_threshold=d["avg_threshold"],
                        min_scores=d["min_scores"], eager=d["eager"],
                        score_ref=d["score_ref"], band=d["band_size"])


def for_program(ww: Wakewords, config: dict):
    """The program's wakeword objects and configuration for these arrays."""
    import rustpotter_tpu_torch as rp

    C, d = config["mfcc_size"], config["detector"]
    objs = []
    for name, spec, w in zip(ww.names, ww.specs, ww.reference):
        if isinstance(w, ref.DtwWakeword):
            objs.append((name, rp.WakewordRef(
                name=name, samples_features=dict(w.templates), avg_features=w.avg,
                rms_level=spec["rms_level"])))
        else:
            weights = {}
            for i, (W, b) in enumerate(w.layers, start=1):
                weights[f"ln{i}.weight"] = rp.TensorData.from_numpy(W)
                weights[f"ln{i}.bias"] = rp.TensorData.from_numpy(b)
            objs.append((name, rp.WakewordModel(
                labels=list(w.labels), train_size=w.train_size, mfcc_size=C,
                m_type=rp.ModelType(spec["model"]), weights=weights,
                rms_level=spec["rms_level"])))
    cfg = rp.RustpotterConfig(detector=rp.DetectorConfig(
        avg_threshold=d["avg_threshold"], threshold=d["threshold"],
        min_scores=d["min_scores"], eager=d["eager"], score_ref=d["score_ref"],
        band_size=d["band_size"], score_mode=rp.ScoreMode(d["score_mode"]), vad_mode=None))
    return objs, cfg
