#!/usr/bin/env python3
"""Check the PyTorch/CUDA port (rustpotter_tpu_torch) on this machine's CUDA card.

    python3 chip_smoke.py    # no arguments; needs a card and nvcc

Prints the card's name and power limit, then runs every card test of the
port (`-m cuda`) in one pytest process and exits with pytest's code; exits
2 at once where PyTorch sees no card, since every card test would skip. The
kernels build with nvcc at their first launch. The card-test files import no
JAX, so they run without `tests/conftest.py`, which sets JAX up.

README's "On the card" says what each file holds. Nothing here is timed: the
kernels are timed by `rustpotter_tpu_torch/tools/` (`kernel_probe`,
`band_probe`, `front_probe`, `fma_probe`), the serving paths by the benchmark
(`portbench/`).
"""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
CARD_TESTS = (
    "tests/test_torch_cuda.py",
    "tests/test_torch_nn_cuda.py",
    "tests/test_torch_front_cuda.py",
    "tests/test_torch_mfcc_front_cuda.py",
    "tests/test_torch_train_cuda.py",
    "tests/test_torch_lifecycle_cuda.py",
    "tests/test_torch_tracing_cuda.py",
    "tests/test_torch_mixed_fleet.py",
    "tests/test_torch_graph_cuda.py",  # last: its final test fails a capture on purpose
)


def main() -> int:
    if not torch.cuda.is_available():
        print("PyTorch sees no CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    return int(pytest.main([os.path.join(ROOT, f) for f in CARD_TESTS]
                           + ["-m", "cuda", "--noconftest", "-q", "-rs"]))


if __name__ == "__main__":
    sys.exit(main())
