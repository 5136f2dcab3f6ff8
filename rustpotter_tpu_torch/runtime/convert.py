"""Carry parameters and stream state across from numpy.

A serving fleet that moves from the JAX runtime to this one keeps its live
streams: take the JAX `StepParams` and batched `StreamState` leaves as numpy
arrays (keyed by field name; the window already in the serving layout
(F, C, B), `rot` a scalar, `nn_params` per NN wakeword a sequence of (W, b)
pairs), build the port's tensors from them, and continue. `states_to_numpy`
goes the other way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .bundle import StepParams
from .state import StreamState


def params_from_numpy(d: dict, device: DeviceLike = None) -> StepParams:
    """The port's StepParams from numpy arrays keyed by field name, the NN
    weights under `nn_params` (per model, its (W, b) pairs in layer order)."""
    return StepParams.from_numpy(d, device)


def states_from_numpy(d: dict, device: DeviceLike = None) -> StreamState:
    """The port's StreamState from numpy arrays keyed by field name: window
    (F, C, B), `rot` a 0-d integer, per-stream fields with the stream axis
    first. Every tensor is a fresh copy on `device`."""
    dev = resolve_device(device)
    out = {}
    for f in StreamState._fields:
        a = np.asarray(d[f])
        if a.dtype == np.int64 or f == "rot":
            a = a.astype(np.int32)
        out[f] = torch.tensor(a, device=dev)
    if out["rot"].dim() != 0:
        raise ValueError("rot must be a scalar: one cursor shared by all streams")
    return StreamState(**out)


def states_to_numpy(states: StreamState) -> dict:
    """Host numpy copies of every field, keyed by field name. They are copies
    on every device: the serving chunk updates the state tensors in place."""
    return {f: getattr(states, f).cpu().numpy().copy() for f in StreamState._fields}
