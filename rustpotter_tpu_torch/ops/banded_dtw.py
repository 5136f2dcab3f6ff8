"""K3: the banded-DTW dynamic program over precomputed band costs.

`banded_dtw_kernel` is the function of the TPU kernel
`rustpotter_tpu/ops/pallas_dtw.py::_dtw_kernel` (called through
`banded_dtw_pallas`): costs (N, L, 2w) from `ops.dtw.band_costs` and lengths
(N,) → similarities (N,), the padded [m-1][n] cell of each DP. On a CUDA
tensor it launches the Hopper kernel in csrc/banded_dtw.cu (built at first
use) or raises; on a CPU tensor it runs the plain version,
`ops.dtw.banded_dtw_batch`. The DP is adds and mins in the same order in
both, so the kernel equals the plain version bit for bit.

The kernel streams the costs through per-warp stages in shared memory sized
from the band; `smem_bytes` mirrors the .cu's SMEM_BYTES, and bands beyond
W_MAX (whose tile passes the sm_90 opt-in) raise ValueError on a CUDA tensor
before any build. The plain version takes any band >= 2.
"""
from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .. import _build
from .dtw import banded_dtw_batch

SOURCE = "banded_dtw.cu"
# the .cu's tile: LANES entries per warp, WARPS warps per block, STAGES
# buffers per warp
LANES, WARPS, STAGES = 32, 4, 3


def rows_per_stage(band: int) -> int:
    """DP rows per stage: ~5 KB of costs per warp and stage, 1 to 8 rows."""
    return max(1, min(8, 40 // (2 * band)))


def smem_bytes(band: int) -> int:
    """Bytes of dynamic shared memory one K3 block takes at this band:
    STAGES buffers per warp of LANES entries at a stride of 2*(ROWS*w | 1)
    floats."""
    stride = 2 * ((rows_per_stage(band) * band) | 1)
    return 4 * WARPS * STAGES * LANES * stride


# the largest band whose tile fits the opt-in (smem_bytes grows with the band)
W_MAX = max(w for w in range(2, 1024) if smem_bytes(w) <= _build.SMEM_OPTIN)


def check_band(band: int) -> None:
    """ValueError unless the kernel takes this band: 2 <= band <= W_MAX."""
    if band < 2:
        raise ValueError(f"the banded DP needs band_size >= 2 (got {band})")
    if band > W_MAX:
        raise ValueError(
            f"K3 takes band_size <= {W_MAX} (got {band}): its tile of "
            f"{smem_bytes(band)} B passes the {_build.SMEM_OPTIN} B shared-memory opt-in")


# Launch count of the kernel wrapper: one per launch, nowhere else
# (the card tests read it around a call).
LAUNCHES = {"banded_dtw": 0}


@lru_cache(maxsize=None)
def _library(band: int) -> ctypes.CDLL:
    lib = _build.load(SOURCE, {"RP_W": band})
    fn = lib.rp_banded_dtw
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2
    fn.restype = ctypes.c_int
    return lib


def banded_dtw_kernel(costs: torch.Tensor, lengths: torch.Tensor, band: int) -> torch.Tensor:
    """K3. costs (N, L, 2w) band costs, lengths (N,) pair lengths in [1, L]
    → (N,) similarities (+inf where the length is below 2)."""
    if costs.dim() != 3 or costs.shape[2] != 2 * band:
        raise ValueError(f"costs must be (N, L, {2 * band}), got {tuple(costs.shape)}")
    N, L, _ = costs.shape
    if tuple(lengths.shape) != (N,):
        raise ValueError(f"lengths must be ({N},), got {tuple(lengths.shape)}")
    if costs.device.type == "cpu":
        return banded_dtw_batch(costs, lengths, band)
    if costs.device.type != "cuda":
        raise ValueError(f"banded_dtw_kernel: unsupported device {costs.device}")
    check_band(band)
    dev = costs.device
    if costs.dtype != torch.float32 or not costs.is_contiguous():
        raise ValueError(f"costs must be a contiguous float32 tensor on {dev}")
    if costs.data_ptr() % 8:
        raise ValueError("costs must be 8-byte aligned: the kernel copies 8-byte units")
    if lengths.device != dev:
        raise ValueError(f"lengths must be on {dev}")
    lens = lengths.to(torch.int32).contiguous()
    out = torch.empty((N,), dtype=torch.float32, device=dev)
    lib = _library(band)
    with torch.cuda.device(dev):  # a library launches on the current card
        err = lib.rp_banded_dtw(costs.data_ptr(), lens.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream, N, L)
    if err != 0:
        raise RuntimeError(f"banded_dtw kernel launch failed: CUDA error {err}")
    LAUNCHES["banded_dtw"] += 1
    return out
