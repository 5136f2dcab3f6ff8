"""The benchmark's counts against brute-force counts at tiny shapes."""
import pytest
import torch

from portbench import counts


def brute_pair(n, w, C, shifts):
    """K1's need for one pair, cell by cell from rustpotter's banded loop:
    row r covers columns max(1, r - w) .. min(n + 1, r + w) - 1."""
    if not shifts:
        return 0
    flops = len(shifts) * n * (3 * C + 1)
    for r in range(1, n):
        cols = list(range(max(1, r - w), min(n + 1, r + w)))
        seen = set()
        for s in shifts:
            seen.update(c + s for c in cols)
        flops += 2 * C * len(seen)
        flops += len(shifts) * (2 * C + 3 * len(cols) + 4 * w + 2 * (2 * w - 1))
    return flops


@pytest.mark.parametrize("n,w", [(2, 2), (7, 2), (12, 5), (30, 5), (9, 20)])
@pytest.mark.parametrize("shifts", [(), (0,), (1, 2), (0, 2), (0, 1, 2)])
def test_k1_pair_against_the_banded_loop(n, w, shifts):
    assert counts._k1_pair(n, w, 4, shifts) == brute_pair(n, w, 4, shifts)


def test_k1_open_gate_equals_the_programs_count():
    """With every gate open, the copy counts what the program's k1_work counts."""
    from rustpotter_tpu_torch.utils.profiling import k1_work

    lens, avg, w, C, B = [100, 98, 96, 94, 92], 100, 5, 16, 3
    dots, rest = k1_work(lens + [avg], w, C, B)
    assert counts.k1_flops(lens, avg, w, C, B, {(0, 1, 2): B}) == dots + rest


def test_gate_patterns_scale_each_class():
    g = torch.zeros((3, 2, 3), dtype=torch.bool).numpy()
    g[0, 0] = [True, True, True]  # utterance stream, chunk 0 open
    g[1, 1, 2] = True  # noise stream, one shift open in chunk 1
    pat = counts.gate_patterns(g, {"utterance": 4, "noise": 100}, ["utterance", "noise", "noise"])
    assert pat[(0, 1, 2)] == pytest.approx(2.0)
    assert pat[(2,)] == pytest.approx(25.0)
    assert pat[()] == pytest.approx(2.0 + 75.0)


def _chunk_flops(config_name, B):
    """FLOPs of the matrix products of the program's batched chunk on the
    CPU, read by torch's FlopCounterMode (the second chunk: the first
    builds the parameter set's constants)."""
    from torch.utils.flop_counter import FlopCounterMode

    import rustpotter_tpu_torch as rp
    from portbench import harness, wakewords

    c = harness.cell(f"{config_name}.serve")
    ww = wakewords.build(c.config, torch.Generator().manual_seed(1), torch.device("cpu"))
    objs, cfg = wakewords.for_program(ww, c.config)
    det = rp.BatchedDetector(objs, config=cfg, batch_size=B, device="cpu")
    st = det.init_states()
    x = 0.02 * torch.randn((B, 480), generator=torch.Generator().manual_seed(2))
    st, _ = det.process_chunk(det.params, st, x)
    with FlopCounterMode(display=False) as fc:
        det.process_chunk(det.params, st, x)
    return fc.get_total_flops(), c.config, ww, det.static


def test_nn_products_against_the_flop_counter():
    B = 4
    total, config, ww, static = _chunk_flops("nn_medium", B)
    spec = config["wakewords"][0]
    want = counts.frontend_products(B, 16) + counts.nn_products(
        B, 16, static.max_mfcc_frames, spec["train_size"], spec["layers"])
    assert total == sum(p[1] for p in want)


def test_dtw_products_against_the_flop_counter():
    """The DTW chunk's products, plus what K1's plain version multiplies on
    the CPU (its T'.m and its per-row dots, every band slot)."""
    B = 4
    total, config, ww, static = _chunk_flops("dtw_bench", B)
    w = ww.reference[0]
    P, C, band = len(w.templates) + 1, 16, static.band_size
    Lm = max(static.lmax, static.la_max)
    want = counts.frontend_products(B, C) + counts.cmn_products(B, C, static.max_mfcc_frames, P)
    plain_k1 = 2 * 3 * P * Lm * C * B + (max(static.dtw_pair_lens) - 1) * 2 * 3 * P * 2 * band * C * B
    assert total == sum(p[1] for p in want) + plain_k1
