"""How the reference multiplies matrices.

Every matrix product of the reference goes through `matmul`, in one of two
precisions:
  - "f64": float64 operands and accumulation, the precision the benchmark
    judges the program against (the configurations state float32);
  - "tf32": TF32 arithmetic, the control: each operand rounded to the
    nearest value with TF32's 10-bit mantissa, then an fp32 product with
    TF32 off (fp32 accumulation), on any device. Done by hand rather than
    by cuBLAS's TF32 switch, whose kernels vary with the shape, so that the
    control reads the same on the card and on the CPU.
"""
from __future__ import annotations

import contextlib

import torch

PRECISIONS = ("f64", "tf32")


def dtype_of(precision: str) -> torch.dtype:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    return torch.float64 if precision == "f64" else torch.float32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to the nearest value with a 10-bit mantissa (ties
    away from zero); infinities and NaNs pass unchanged."""
    bits = x.contiguous().view(torch.int32)
    rounded = (bits + 0x1000) & ~0x1FFF
    return torch.where(torch.isfinite(x), rounded.view(torch.float32), x)


@contextlib.contextmanager
def _fp32():
    """cuBLAS's fp32 products with TF32 off, whatever the process set."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in `precision`; the result is in that precision's dtype."""
    dt = dtype_of(precision)
    a, b = a.to(dt), b.to(dt)
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    with _fp32():
        return a @ b
