"""Banded-DTW backend dispatch: the counterpart of
`rustpotter_tpu.ops.dtw_dispatch`.

The JAX package chose between its Pallas kernel and the lax.scan DP by
backend (or RUSTPOTTER_PALLAS) and flattened a vmapped batch into one kernel
batch. Here the tensor's device chooses (`ops.banded_dtw.banded_dtw_kernel`:
K3 on a CUDA tensor, the plain DP on a CPU one), and callers pass the
flattened (N, L, 2w) batch themselves.
"""
from __future__ import annotations

from functools import partial

from .banded_dtw import banded_dtw_kernel


def get_banded_dtw(band: int):
    """fn(costs (N, L, 2w), lengths (N,)) -> (N,) similarities."""
    return partial(banded_dtw_kernel, band=band)
