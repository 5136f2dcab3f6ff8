"""V1-V6 of the PyTorch port (rustpotter_tpu_torch.tools.fma_probe,
csrc/fma_probe.cu) against the JAX package on the CPU: each plain version
against its TPU probe kernel from tools/vpu_probe.py run through
`pl.pallas_call(..., interpret=True)`, at reps = 16 and S in {8, 32}; the
wrapper's CPU dispatch; and the SASS opcode count that decides FLOPs per
step. The hand-written kernels are held against the plain versions on the
card in tests/test_torch_cuda.py.

Tolerance: rtol 1e-6 (sums of up to 512 fp32 steps; V1-V4 add exact halves,
V5 and V6 products of small integers and a tile).
"""
import os
import sys
from collections import Counter
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rustpotter_tpu_torch.tools import fma_probe

TOOLS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
REPS = 16

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def vpu_probe():
    """The JAX probe kernels (tools/vpu_probe.py imports tools/kernel_probe.py
    as a top-level module)."""
    sys.path.insert(0, TOOLS)
    try:
        import vpu_probe
    finally:
        sys.path.remove(TOOLS)
    return vpu_probe


# probe: (kernel in tools/vpu_probe.py, memory space of s or None)
JAX_KERNELS = {
    "fma": ("k_fma", None),
    "fma_dep": ("k_fma_dep", None),
    "dynload": ("k_dynload", None),
    "dynload_cheap": ("k_dynload_cheap", None),
    "sload": ("k_sload", "vmem"),
    "smemload": ("k_smemload", "smem"),
}


def _jax_probe(vpu_probe, name, x, s, streams):
    """The TPU kernel's (1, 8, 128) output in interpret mode, with the
    in_specs of tools/vpu_probe.py's run()."""
    kern, space = JAX_KERNELS[name]
    in_specs = [pl.BlockSpec(memory_space=pltpu.VMEM)]
    args = (jnp.asarray(x),)
    if space:
        mem = pltpu.SMEM if space == "smem" else pltpu.VMEM
        in_specs = [pl.BlockSpec(memory_space=mem)] + in_specs
        args = (jnp.asarray(s), jnp.asarray(x))
    fn = pl.pallas_call(
        partial(getattr(vpu_probe, kern), REPS, streams),
        out_shape=jax.ShapeDtypeStruct((1, 8, 128), jnp.float32),
        in_specs=in_specs,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )
    return np.asarray(fn(*args))


@pytest.mark.parametrize("streams", [8, 32])
@pytest.mark.parametrize("name", list(fma_probe.KERNELS))
def test_plain_version_matches_jax_probe_kernel_interpret(vpu_probe, name, streams):
    x, s = fma_probe.inputs("cpu")
    want = _jax_probe(vpu_probe, name, x.numpy(), s.numpy(), streams)
    got = fma_probe.plain(name, x, s, REPS, streams).numpy()
    assert got.shape == (1, 8, 128)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_probe_on_cpu_is_the_plain_version_on_every_tile():
    x, s = fma_probe.inputs("cpu")
    before = dict(fma_probe.LAUNCHES)
    for name in fma_probe.KERNELS:
        got = fma_probe.probe(name, x, s, REPS, 8, tiles=3)
        assert got.shape == (3, 8, 128)
        want = fma_probe.plain(name, x, s, REPS, 8)
        torch.testing.assert_close(got, want.expand(3, 8, 128), rtol=0, atol=0)
    assert fma_probe.LAUNCHES == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="streams"):
        fma_probe.probe("fma", x, s, REPS, 16, tiles=1)
    with pytest.raises(ValueError, match="unknown probe"):
        fma_probe.probe("fmax", x, s, REPS, 8, tiles=1)


# probe_fma<8>: 7 FMULs and 8 FFMAs of set-up, a rep loop of 8 FFMAs, then
# the final sum in FADDs. probe_fma_dep<8>: 8 FFMAs of set-up (which fooled a
# count over the whole kernel into 2 FLOPs per step) and a rep loop of 8 FADDs
# nested in an outer loop with no floating-point work of its own.
SASS = """
	code for sm_90a
		Function : _ZN12_GLOBAL__N_19probe_fmaILi8EEEvNS_4ArgsE
""" + "".join(f"        /*{0x100 + 16 * i:04x}*/                   FMUL R{i}, R{i}, 3 ;\n"
              for i in range(7)) + "".join(
    f"        /*{0x180 + 16 * i:04x}*/                   FFMA R{i}, R2, R3, R{i} ;\n"
    for i in range(8)) + """        /*0200*/                   UIADD3 UR4, UR4, 0x1, URZ ;
""" + "".join(f"        /*{0x210 + 16 * i:04x}*/                   FFMA R{i}, R4.reuse, UR5, R{i} ;\n"
              for i in range(8)) + """        /*0290*/              @!P0 BRA 0x200 ;
        /*02a0*/                   FADD R6, R6, R13 ;
        /*02b0*/                   FADD.FTZ R7, R6, R7 ;
        /*02c0*/                   EXIT ;
        /*02d0*/                   BRA 0x2d0;
		Function : _ZN12_GLOBAL__N_113probe_fma_depILi8EEEvNS_4ArgsE
""" + "".join(f"        /*{0x100 + 16 * i:04x}*/                   FFMA R{i}, R2, R3, R{i} ;\n"
              for i in range(8)) + """        /*0180*/                   IADD3 R9, R9, 0x1, RZ ;
""" + "".join(f"        /*{0x190 + 16 * i:04x}*/                   FADD R5, R5, R3 ;\n"
              for i in range(8)) + """        /*0210*/               @P1 BRA 0x190 ;
        /*0220*/               @P0 BRA 0x180 ;
        /*0230*/                   EXIT ;
"""


def test_sass_opcode_count_and_flops_per_step():
    counts = fma_probe.loop_opcodes(SASS)
    assert counts == {("fma", 8): Counter(FFMA=8), ("fma_dep", 8): Counter(FADD=8)}
    assert fma_probe.flops_per_step(counts[("fma", 8)], 8) == 2
    assert fma_probe.flops_per_step(counts[("fma_dep", 8)], 8) == 1
    assert fma_probe.flops_per_step(Counter(FFMA=16), 8) == 2  # a loop unrolled twice


@pytest.mark.parametrize("ops", [Counter(FFMA=8, FADD=8), Counter(FFMA=6), Counter(FMUL=8),
                                 Counter(FADD=8, FMUL=8), Counter()])
def test_flops_per_step_refuses_a_mixed_or_short_loop(ops):
    with pytest.raises(ValueError, match="rep loop"):
        fma_probe.flops_per_step(ops, 8)


def test_loop_opcodes_needs_one_floating_point_loop():
    straight = SASS.split("\t\tFunction : _ZN12_GLOBAL__N_113probe_fma_dep")[0].replace(
        "@!P0 BRA 0x200", "NOP")
    with pytest.raises(ValueError, match="0 innermost loops"):
        fma_probe.loop_opcodes(straight)


def test_dynload_refuses_an_x_of_another_row_count():
    """V3's row count is a compile-time constant (64, the TPU kernel's static
    shape): the wrapper refuses any other before it looks at the device."""
    x, s = fma_probe.inputs("cpu")
    with pytest.raises(ValueError, match=r"x must be \(64, 8, 128\)"):
        fma_probe.probe("dynload", x[:32].contiguous(), s, REPS, 8, tiles=1)
    assert fma_probe.ROWS == 64


def test_rep_loops_list_every_opcode_of_the_loop():
    """`rep_loops` keeps the integer and memory instructions of the rep loop
    (a V3 loop must hold no LDG or LDL); `loop_opcodes` keeps its FP ones."""
    loops = fma_probe.rep_loops(SASS)
    assert loops[("fma", 8)] == Counter(FFMA=8, UIADD3=1, BRA=1)
    assert loops[("fma_dep", 8)] == Counter(FADD=8, BRA=1)
    with_load = SASS.replace("UIADD3 UR4, UR4, 0x1, URZ", "LDG.E R9, desc[UR6][R2.64]")
    assert fma_probe.rep_loops(with_load)[("fma", 8)]["LDG"] == 1
    assert fma_probe.loop_opcodes(with_load)[("fma", 8)] == Counter(FFMA=8)
