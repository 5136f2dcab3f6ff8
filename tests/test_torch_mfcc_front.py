"""The MFCC front-end's kernel wrappers on the CPU (csrc/mfcc_front.cu runs
only on a card; tests/test_torch_mfcc_front_cuda.py holds it there):

- the plain versions `prologue_plain` and `epilogue_plain` are the torch
  composition the port ran before the kernels, bit for bit, over the leading
  shapes the callers use, in both output layouts;
- `prologue`, `epilogue` and `mfcc_from_frames` take the plain versions for
  CPU tensors and launch nothing;
- the wrappers refuse wrong shapes and types before any build;
- numpy transcriptions of the kernels' index maps: the prologue's four stores
  per thread rebuild the plain frames and buffer, and the epilogue's bin walk
  over `epilogue_tables` sums each mel band over exactly its triangle, in
  ascending bin order; `pack_tables` puts each field where the kernel's
  build reports it, and refuses a layout that does not fit.
"""
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from rustpotter_tpu_torch.ops import frontend as fe

CU = Path(fe.__file__).resolve().parents[1] / "csrc" / "mfcc_front.cu"


def chunk(B, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32))
    buf = torch.tensor(rng.normal(0, 0.3, (B, 480)).astype(np.float32))
    return x, buf


def composed_chunk(x, buf):
    """The batched chunk's front-end as the port composed it before the kernels."""
    B = x.shape[0]
    shifts = fe.pre_emphasis(x.reshape(-1, 3, 160))
    cat = torch.cat([buf, shifts.reshape(B, 3 * 160)], dim=1)
    frames3 = cat.unfold(1, 480, 160)[:, :3]
    return frames3.contiguous(), cat[:, 480:], fe.rms_level(x)


def composed_mfcc(frames, n):
    """mfcc_from_frames as the port composed it before the kernels."""
    k = fe.device_constants(n, frames.device)
    spec = torch.matmul(frames.contiguous(), k.dft)
    re_, im = spec[..., : k.bins], spec[..., k.bins:]
    power = re_ * re_ + im * im
    mel = torch.matmul(power, k.mel_fb_t)
    logmel = torch.log(mel + fe.F32_MIN_POSITIVE)
    return torch.matmul(logmel, k.dct_t)[..., 1:]


@pytest.mark.parametrize("B", [1, 7, 64])
@pytest.mark.parametrize("rms", [True, False])
def test_prologue_plain_is_the_composed_chunk(B, rms):
    x, buf = chunk(B, B)
    want_frames, want_buf, want_rms = composed_chunk(x, buf.clone())
    before = dict(fe.LAUNCHES)
    frames, level = fe.prologue(x, buf, rms=rms)
    assert fe.LAUNCHES == before
    assert frames.shape == (B, 3, 480) and frames.is_contiguous()
    assert torch.equal(frames, want_frames)
    assert torch.equal(buf, want_buf)  # written in place
    assert (level is None) if not rms else torch.equal(level, want_rms)


@pytest.mark.parametrize("lead", [(5,), (4, 3), (31,), ()])
@pytest.mark.parametrize("n", [6, 17])
def test_epilogue_plain_is_the_composed_mfcc(lead, n):
    rng = np.random.default_rng(len(lead) + n)
    frames = torch.tensor(rng.normal(0, 0.3, lead + (480,)).astype(np.float32))
    before = dict(fe.LAUNCHES)
    got = fe.mfcc_from_frames(frames, n)
    assert fe.LAUNCHES == before
    assert got.shape == lead + (n - 1,)
    assert torch.equal(got, composed_mfcc(frames, n))


@pytest.mark.parametrize("B", [1, 9])
def test_window_layout_is_the_permuted_rows(B):
    """The batched chunk's (3, C, B) MFCCs: the rows' (B, 3, C) permuted, as
    the chunk copied them before; a silent stream included."""
    x, buf = chunk(B, 3)
    x[0] = 0.0
    buf[0] = 0.0
    frames, _ = fe.prologue(x, buf, rms=False)
    got = fe.mfcc_from_frames(frames, 17, window=True)
    assert got.shape == (3, 16, B) and got.is_contiguous()
    assert torch.equal(got, composed_mfcc(frames, 17).permute(1, 2, 0).contiguous())
    spec = torch.matmul(frames, fe.device_constants(17, frames.device).dft)
    assert torch.equal(fe.epilogue(spec, 17, window=True), got)


def test_the_batched_chunk_takes_the_window_rows_for_its_vad():
    """vad_is_voice packs a strided (B, C) view first: its mean is the
    contiguous rows' bit for bit."""
    from rustpotter_tpu_torch.runtime import stream_step

    rng = np.random.default_rng(5)
    rows = torch.tensor(rng.normal(0, 3, (64, 3, 16)).astype(np.float32))
    window = rows.permute(1, 2, 0).contiguous()
    src = Path(stream_step.__file__).read_text()
    assert "torch.mean(torch.abs(mfcc.contiguous()), dim=-1)" in src
    for s in range(3):
        assert torch.equal(torch.mean(torch.abs(window[s].T.contiguous()), dim=-1),
                           torch.mean(torch.abs(rows[:, s]), dim=-1))


@pytest.mark.parametrize("call, match", [
    (lambda: fe.prologue(torch.zeros(4, 479), torch.zeros(4, 480), True), "samples must be"),
    (lambda: fe.prologue(torch.zeros(4, 480), torch.zeros(4, 320), True), "ext_buf must be"),
    (lambda: fe.prologue(torch.zeros(4, 480), torch.zeros(3, 480), True), r"\(B, 480\)"),
    (lambda: fe.prologue(torch.zeros(2, 4, 480), torch.zeros(2, 4, 480), True), r"\(B, 480\)"),
    (lambda: fe.prologue(torch.zeros(4, 480, dtype=torch.float64), torch.zeros(4, 480), True),
     "float32"),
    (lambda: fe.epilogue(torch.zeros(4, 240), 17), "spec must be"),
    (lambda: fe.epilogue(torch.zeros(4, 3, 480, dtype=torch.float64), 17), "float32"),
    (lambda: fe.epilogue(torch.zeros(12, 480), 17, window=True), r"\(B, S, 480\)"),
    (lambda: fe.mfcc_from_frames(torch.zeros(12, 480), 17, window=True), r"\(B, S, 480\)"),
])
def test_wrappers_refuse_wrong_shapes_and_types(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_the_card_checks_refuse_a_strided_tensor_and_a_cpu_device():
    spec = torch.zeros(4, 482)[:, 1:481]
    with pytest.raises(ValueError, match="contiguous tensor on cuda"):
        fe._card_ready(torch.device("cuda"), ("spec", spec))
    with pytest.raises(ValueError, match="unsupported device"):
        fe._card_ready(torch.device("meta"), ("spec", spec))


def prologue_transcription(x: np.ndarray, buf: np.ndarray):
    """csrc/mfcc_front.cu mfcc_prologue's stores, thread by thread: thread u
    of stream b takes float4 u of the chunk and of the buffer."""
    B = x.shape[0]
    frames = np.full((B, 3 * 480), np.nan, np.float32)
    new_buf = buf.copy()
    shift, c = 160, np.float32(0.97)
    for b in range(B):
        for u in range(120):
            j = 4 * u
            v = x[b, j:j + 4]
            prev = np.float32(0) if j % shift == 0 else x[b, j - 1]
            prevs = np.concatenate([[prev], v[:3]]).astype(np.float32)
            e = (v - prevs * c).astype(np.float32)  # two fp32 roundings
            old = new_buf[b, j:j + 4].copy()
            new_buf[b, j:j + 4] = e
            frames[b, j:j + 4] = old
            if j >= shift:
                frames[b, 480 + j - shift:480 + j - shift + 4] = old
            else:
                frames[b, 480 + 2 * shift + j:480 + 2 * shift + j + 4] = e
            if j >= 2 * shift:
                frames[b, 960 + j - 2 * shift:960 + j - 2 * shift + 4] = old
            else:
                frames[b, 960 + shift + j:960 + shift + j + 4] = e
    return frames.reshape(B, 3, 480), new_buf


def test_the_prologues_stores_rebuild_the_plain_frames_and_buffer():
    x, buf = chunk(5, 11)
    frames, new_buf = prologue_transcription(x.numpy(), buf.numpy())
    want_frames, _ = fe.prologue_plain(x, buf, rms=False)
    assert np.array_equal(frames, want_frames.numpy())  # every element written
    assert np.array_equal(new_buf, buf.numpy())


def walk(tables: dict, n: int, power: np.ndarray):
    """csrc/mfcc_front.cu mfcc_epilogue's bin walk over one row's power, in
    float64: (the n bands, the bins each band summed, in order)."""
    wr, wf, cut = tables["wr"], tables["wf"], tables["cut"]
    mel, rise, fall = [None] * n, (0.0, []), (0.0, [])
    j = 0

    def transition():
        nonlocal rise, fall, j
        if j >= 2:
            mel[j - 2] = fall
        fall, rise = rise, (0.0, [])
        j += 1

    for k in range(240):
        for _ in range(cut[k]):
            transition()
        rise = (rise[0] + power[k] * float(wr[k]), rise[1] + [k])
        fall = (fall[0] + power[k] * float(wf[k]), fall[1] + [k])
    while j < n + 2:
        transition()
    return np.array([m[0] for m in mel]), [m[1] for m in mel]


@pytest.mark.parametrize("n", [2, 6, 17, 30, 64])
def test_the_epilogues_walk_sums_each_band_over_its_triangle(n):
    consts = fe.get_constants(n)
    tables, fb = consts.tables, consts.mel_fb_t.astype(np.float64)
    assert {k: (v.dtype, v.shape) for k, v in tables.items()} == {
        "wr": (np.float32, (240,)), "wf": (np.float32, (240,)), "cut": (np.uint8, (240,)),
        "dct": (np.float32, (n - 1, n)), "dsum": (np.float64, (n - 1,))}
    assert np.array_equal(tables["dct"], fe.dct_matrix(n)[1:])
    exact = [sum(Fraction(float(v)) for v in row) for row in fe.dct_matrix(n)[1:]]
    assert [Fraction(float(v)) for v in tables["dsum"]] == [
        Fraction(float(e)) for e in exact]  # each the nearest double to the exact sum
    power = np.random.default_rng(n).uniform(0, 2, 240)
    mel, order = walk(tables, n, power)
    np.testing.assert_allclose(mel, power @ fb, rtol=1e-12, atol=0)
    centres = fe.mel_centres(16000, 240, n)
    for i in range(n):
        assert order[i] == list(range(centres[i], centres[i + 2])), i
        assert not np.any(fb[:centres[i], i]) and not np.any(fb[centres[i + 2]:, i])


def c_layout(n, order=fe.TABLE_FIELDS):
    """A layout as rp_mfcc_tables_layout reports one: the fields of
    `Tables` back to back in `order` (offset, size each), then the size."""
    sizes = {"wr": 960, "wf": 960, "cut": 240, "dct": 4 * n * (n - 1), "dsum": 8 * (n - 1)}
    offsets, at = {}, 0
    for name in order:
        offsets[name], at = at, at + sizes[name]
    return [v for name in fe.TABLE_FIELDS for v in (offsets[name], sizes[name])] + [at]


@pytest.mark.parametrize("order", [fe.TABLE_FIELDS, ("dsum", "dct", "cut", "wf", "wr")])
def test_pack_tables_places_each_field_where_the_layout_says(order):
    tables = fe.get_constants(17).tables
    layout = c_layout(17, order)
    raw = fe.pack_tables(tables, layout)
    assert raw.size == layout[-1] == 2160 + 4 * 17 * 16 + 8 * 16
    for i, name in enumerate(fe.TABLE_FIELDS):
        off, nbytes = layout[2 * i], layout[2 * i + 1]
        assert np.array_equal(raw[off:off + nbytes], tables[name].view(np.uint8).ravel()), name


def test_pack_tables_refuses_a_layout_that_does_not_fit():
    tables = fe.get_constants(17).tables
    layout = c_layout(17)
    for bad in (lambda l: l.__setitem__(1, 956),  # wr's size
                lambda l: l.__setitem__(2, 956),  # wf over wr's end
                lambda l: l.__setitem__(10, l[10] - 8),  # the struct's size
                lambda l: l.__setitem__(8, l[8] - 4),  # dsum over dct's end
                lambda l: l.__setitem__(7, 4 * 17 * 17),  # dct at another n
                lambda l: l.__setitem__(9, 4 * 16)):  # dsum as floats
        wrong = list(layout)
        bad(wrong)
        with pytest.raises(RuntimeError, match="Tables"):
            fe.pack_tables(tables, wrong)


def test_epilogue_tables_refuse_weights_outside_the_triangles():
    consts = fe.get_constants(17)
    fb = consts.mel_fb_t.copy()
    centres = fe.mel_centres(16000, 240, 17)
    fe.epilogue_tables(fb, centres, fe.dct_matrix(17))
    fb[centres[5] + 1, 1] = 0.5
    with pytest.raises(ValueError, match="outside its triangles"):
        fe.epilogue_tables(fb, centres, fe.dct_matrix(17))
    with pytest.raises(ValueError, match="ascending"):
        fe.epilogue_tables(consts.mel_fb_t, centres[::-1], fe.dct_matrix(17))


def test_the_band_limit_is_the_kernels():
    text = CU.read_text()
    assert re.search(r"static_assert\(N >= 2 && N <= (\d+),", text).group(1) == str(fe.N_MAX)
    with pytest.raises(ValueError, match="2 to 64 mel bands"):
        fe.epilogue(torch.zeros(1, 480, device="meta"), fe.N_MAX + 1)
