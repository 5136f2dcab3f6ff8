"""K3's schedule (csrc/banded_dtw.cu) on the CPU: a numpy transcription of the
kernel's loop, held bit for bit against the plain version `banded_dtw_batch`
and against the JAX Pallas kernel `banded_dtw_pallas` in interpret mode.

The transcription follows the .cu step for step: blocks of WARPS warps, a
warp of 32 lanes that owns 32 consecutive entries, the per-warp stop rule
(__reduce_max_sync of min(n-1, L)), STAGES buffers of ROWS rows at the padded
stride 2*(ROWS*w | 1), the copy loop of 8-byte units (unit i of a stage to
lane i mod 32, each entry copying only the rows its DP needs), one commit
group per stage, wait_group(STAGES - 1) before a stage's DP, and the DP of
each row out of the buffer. The buffers start as NaN and copies land either
as early as they can (when started, the worst order for a buffer that is written
again while it is read) or as late as wait_group allows (the worst order for
a read of a stage that has not landed): a stage read from the wrong buffer,
a row that was not copied, or a wait that lets a stage be read before it
lands turns a similarity into NaN or another value and fails the comparison.

It also pins the shared-memory arithmetic of the wrappers (K3 `smem_bytes`,
K1 `k1_smem_bytes`, K2 `k2_smem_bytes`, K5 `k5_smem_bytes`) to the .cu
constants, evaluated by the host C++ compiler, for every band up to each
kernel's limit, and K2's producer warps and band limit.

Tolerance: none. K3 is adds and mins only, so every result is bit-exact.
"""
import re
import subprocess
import tempfile
from collections import deque
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu.ops.pallas_dtw import banded_dtw_pallas
from rustpotter_tpu_torch import _build
from rustpotter_tpu_torch.ops import banded_dtw as bd
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.ops.dtw import banded_dtw_batch

LANES = 32


def k3_schedule(costs, lens, w, land):
    """The kernel's similarities (N,) and the 8-byte units it copied.
    `land` is "early" (a copy lands when started) or "late" (at the wait that
    forces it)."""
    N, L, W2 = costs.shape
    flat = costs.reshape(-1)
    rows_ps = bd.rows_per_stage(w)
    units = rows_ps * w
    stride = 2 * (units | 1)
    assert (stride // 2) % 2 == 1  # odd in 8-byte units: conflict-free LDS.64
    stage_floats = LANES * stride
    per_block = bd.WARPS * LANES
    out = np.full(N, np.nan, np.float32)
    inf = np.float32(np.inf)
    copied = 0
    lane = np.arange(LANES)

    for bx in range(-(-N // per_block)):
        for warp in range(bd.WARPS):
            e0 = (bx * bd.WARPS + warp) * LANES
            e = e0 + lane
            n = np.where(e < N, lens[np.minimum(e, N - 1)], 1)
            last = np.minimum(n - 1, L)
            wlast = int(last.max())  # __reduce_max_sync
            nst = (wlast - 1) // rows_ps + 1 if wlast >= 1 else 0
            tile = np.full(bd.STAGES * stage_floats, np.nan, np.float32)
            pending = deque()  # commit groups not yet landed, oldest first

            def fetch(s):
                nonlocal copied
                r0 = 1 + s * rows_ps
                base = (s % bd.STAGES) * stage_floats
                writes = []
                for it in range(units):
                    idx = lane + it * LANES
                    ent, k = idx // units, idx % units
                    rows = np.minimum(last[ent] - r0 + 1, rows_ps)  # __shfl_sync
                    ok = k < rows * w
                    src = ((e0 + ent) * L + (r0 - 1)) * W2 + 2 * k
                    dst = base + ent * stride + 2 * k
                    assert (src[ok] % 2 == 0).all() and (dst % 2 == 0).all()  # 8-byte aligned
                    assert (src[ok] + 2 <= flat.size).all()
                    writes += [(d, s_) for d, s_ in zip(dst[ok], src[ok])]
                copied += len(writes)
                return writes

            def apply(writes):
                for d, s_ in writes:
                    tile[d:d + 2] = flat[s_:s_ + 2]

            def commit(writes):
                if land == "early":
                    apply(writes)
                    writes = []
                pending.append(writes)

            def wait():  # cp.async.wait_group STAGES - 1
                while len(pending) > bd.STAGES - 1:
                    apply(pending.popleft())

            prev = np.stack([np.zeros(LANES, np.float32) if j == w else np.full(LANES, inf)
                             for j in range(W2)])
            result = np.full(LANES, inf)
            for s in range(bd.STAGES - 1):
                commit(fetch(s) if s < nst else [])
            for s in range(nst):
                commit(fetch(s + bd.STAGES - 1) if s + bd.STAGES - 1 < nst else [])
                wait()
                mine = (s % bd.STAGES) * stage_floats + lane * stride
                for rr in range(rows_ps):
                    r = 1 + s * rows_ps + rr
                    if r > wlast:
                        break
                    hi = np.minimum(n, r + w - 1)
                    cost, cur = [], []
                    for j in range(W2):
                        cdp = r - w + j
                        valid = (cdp >= 1) & (cdp <= hi)
                        cost.append(np.where(valid, tile[mine + rr * W2 + j], inf))
                        ins = prev[j + 1] if j + 1 < W2 else np.full(LANES, inf)
                        cur.append(cost[j] + np.minimum(ins, prev[j]))
                    for j in range(1, W2):
                        cur[j] = np.minimum(cur[j], cost[j] + cur[j - 1])
                    for j in range(W2):
                        cdp = r - w + j
                        cur[j] = np.where((cdp >= 1) & (cdp <= hi), cur[j], inf)
                    prev = np.stack(cur)
                    result = np.where(r == n - 1, prev[w + 1], result)
            live = e < N
            out[e[live]] = result[live]
    return out, copied


def _inputs(N, L, w, seed):
    rng = np.random.default_rng(seed)
    costs = rng.uniform(0, 2, (N, L, 2 * w)).astype(np.float32)
    lens = rng.integers(1, L + 1, N).astype(np.int32)
    lens[:6] = (1, 2, L, L - 1, 3, L)
    lens[32:64] = rng.integers(1, 6, 32)  # block 0's second warp stops early
    costs[4, 1, w] = np.nan  # a NaN cost in a valid cell of a harvested DP
    return costs, lens


# N = 150: two blocks of 128 entries, the second with 22 live entries in its
# first warp and none in the other three. L*w is odd at (3, 13), (5, 13),
# (13, 13) and (75, 13). ROWS = 1 from w = 11 up to W_MAX = 75, the band range
# whose 2w frontier is widest.
@pytest.mark.parametrize("land", ["early", "late"])
@pytest.mark.parametrize("w,L", [(2, 13), (3, 13), (5, 13), (5, 12), (6, 13), (8, 13),
                                 (13, 13), (20, 13), (75, 13)])
def test_schedule_is_bit_exact(w, L, land):
    N = 150
    costs, lens = _inputs(N, L, w, seed=10 * w + L)
    got, copied = k3_schedule(costs, lens, w, land)
    want = banded_dtw_batch(torch.tensor(costs), torch.tensor(lens), w).numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(banded_dtw_pallas(jnp.asarray(costs), jnp.asarray(lens), w,
                                          interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert np.isnan(got[4]) and np.isinf(got[lens < 2]).all()
    # the kernel copies the rows each DP needs, and nothing else: the bytes of
    # its bound
    assert copied * 8 == 4 * 2 * w * int(np.minimum(lens - 1, L).clip(min=0).sum())


# ---------------------------------------------- shared memory of the kernels

def _cu_constants(source, wanted, bands, C):
    """{band: {name: value}} of the .cu's compile-time constants at (band,
    C), evaluated by the host C++ compiler: the `constexpr` and `using`
    lines of the source's anonymous namespace become members of a class
    template over (RP_W, RP_C), beside csrc/smem.cuh's SMEM_OPTIN."""
    text = (_build.CSRC / source).read_text()
    body = text[text.index("namespace {"):]
    lines = [ln for ln in body.splitlines()
             if ln.startswith(("constexpr ", "using "))]
    members = "\n".join(("static " + ln) if ln.startswith("constexpr") else ln
                        for ln in lines)
    prints = "\n".join(
        f'  std::printf("{w} {name} %lld\\n", (long long)K<{w}, {C}>::{name});'
        for w in bands for name in wanted)
    cpp = (f"#include <cstdio>\nconstexpr int SMEM_OPTIN = {_build.SMEM_OPTIN};  // csrc/smem.cuh\n"
           f"template <int RP_W, int RP_C> struct K {{\n{members}\n}};\n"
           f"int main() {{\n{prints}\n  return 0;\n}}\n")
    # a directory of its own: test files that read one source run in parallel
    with tempfile.TemporaryDirectory() as tmp:
        exe = Path(tmp) / f"constants_{source.split('.')[0]}_{C}"
        src = exe.with_suffix(".cpp")
        src.write_text(cpp)
        subprocess.run([_build.cxx(), "-std=c++17", "-o", str(exe), str(src)], check=True)
        res = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout
    got = {}
    for w, name, value in (ln.split() for ln in res.splitlines()):
        got.setdefault(int(w), {})[name] = int(value)
    return got


def test_k3_smem_bytes_follow_the_cu_up_to_w_max():
    consts = _cu_constants(bd.SOURCE, ("SMEM_BYTES", "W_MAX", "ROWS", "WARPS",
                                       "STAGES", "LANES"), range(2, bd.W_MAX + 2), 16)
    for w, c in consts.items():
        assert c["SMEM_BYTES"] == bd.smem_bytes(w), w
        assert (c["W_MAX"], c["ROWS"]) == (bd.W_MAX, bd.rows_per_stage(w)), w
        assert (c["WARPS"], c["STAGES"], c["LANES"]) == (bd.WARPS, bd.STAGES, LANES)
        assert (bd.smem_bytes(w) <= _build.SMEM_OPTIN) == (w <= bd.W_MAX), w
    assert bd.W_MAX == 75 and bd.smem_bytes(5) == 64_512
    assert _build.SMEM_OPTIN == 232_448  # sm_90's opt-in, read from csrc/smem.cuh
    for w in (2, bd.W_MAX):
        bd.check_band(w)
    for w in (1, bd.W_MAX + 1):
        with pytest.raises(ValueError, match="band_size"):
            bd.check_band(w)


@pytest.mark.parametrize("kernel,source,name,C,limit", [
    ("K1", fd.SOURCE, "RING_BYTES", 16, 19),
    ("K1", fd.SOURCE, "RING_BYTES", 8, 20),
    ("K2", fd.SOURCE_V3, "RING_BYTES", 16, 20),
    ("K5", "fused_dtw_v1.cu", "SMEM_BYTES", 16, 37),
    ("K5", "fused_dtw_v1.cu", "SMEM_BYTES", 8, 56),
])
def test_fused_smem_bytes_follow_the_cu(kernel, source, name, C, limit):
    fn = {"K1": fd.k1_smem_bytes, "K2": fd.k2_smem_bytes, "K5": fd.k5_smem_bytes}[kernel]
    consts = _cu_constants(source, (name,), range(2, limit + 2), C)
    for w, c in consts.items():
        assert c[name] == fn(w, C), (w, C)
        assert (fn(w, C) <= _build.SMEM_OPTIN) == (w <= limit), (w, C)
    fd._check_smem(kernel, fn(limit, C), limit, C)
    with pytest.raises(ValueError, match="shared memory"):
        fd._check_smem(kernel, fn(limit + 1, C), limit + 1, C)


def test_k2_constants_follow_the_cu():
    """K2's producer warps (`fused_dtw.k2_producers`, which `k2_smem_bytes`
    counts), its ring rows and its band limit W_MAX, the largest band whose
    ring fits."""
    consts = _cu_constants(fd.SOURCE_V3, ("Q", "WARPS", "R", "W_MAX"), range(2, 22), 16)
    for w, c in consts.items():
        assert (c["Q"], c["WARPS"], c["W_MAX"]) == (fd.k2_producers(w), c["Q"] + 1, 20), w
        assert c["R"] == 2 * w + 2 * c["Q"] - 1, w
    assert fd.k2_producers(5) == 4 and fd.k2_producers(20) == 3
    text = (_build.CSRC / fd.SOURCE_V3).read_text()
    assert re.search(r"static_assert\(W <= W_MAX && RING_BYTES <= SMEM_OPTIN", text)


def test_k3_static_asserts_name_the_limit():
    text = (_build.CSRC / bd.SOURCE).read_text()
    assert re.search(r"static_assert\(W <= W_MAX && SMEM_BYTES <= SMEM_OPTIN", text)
    assert f"W_MAX = {bd.W_MAX} is the largest band" in text
