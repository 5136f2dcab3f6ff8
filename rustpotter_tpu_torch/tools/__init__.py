"""The port's kernel tools, run as modules on the card:

    python -m rustpotter_tpu_torch.tools.kernel_probe [B] [iters] [--v1|--v2|--v4] [--gate]
    python -m rustpotter_tpu_torch.tools.kernel_parity [B]
    python -m rustpotter_tpu_torch.tools.fma_probe

the counterparts of the JAX package's tools/kernel_probe.py,
tools/tpu_kernel_parity.py and tools/vpu_probe.py.
"""
