"""NN training and the NCCL-sharded detector of the port on a CUDA card,
against the same calls on the CPU. Every test here needs a card (and nvcc,
which builds K1 at first use); without one they skip. The file imports no
JAX:

    python -m pytest tests/test_torch_train_cuda.py -m cuda --noconftest -q

  - training on the card against training on the CPU (the synthetic set,
    MEDIUM: at 42 frames over 60 epochs, and at the `nn_medium` width, 168
    frames, 2688 -> 56 -> 28 -> 2, 64 + 16 files over 200 epochs): the losses
    at `tests/test_training_torch_crosscheck.py`'s tolerances (the first 10
    epochs rtol 2e-4 / atol 2e-5, all rtol 5e-3 / atol 5e-4), the final
    weights at the late tolerance, the test accuracy equal;
  - that model trained on the card at the `nn_medium` width (trained once
    for both checks) comes back from `save_wakeword` / `load_wakeword` byte
    for byte, and served at B = 4 it gives the CPU's events (scores rtol
    1e-4 / atol 1e-3);
  - training graphed (on the card: a CUDA graph of test_epochs epochs
    replayed per chunk) against the eager epochs (the same call with
    `trainer.GraphedStep` substituted by the bare function), with
    a shorter last chunk and as a fine-tune from a prior model: losses,
    weights and test accuracy bit for bit, the verbose lines equal, one
    capture per call, and the graph and its memory dropped when the call
    returns (the memory reserved after `empty_cache` does not grow over
    three calls);
  - a replay of the epochs' graph runs the eager chunk's device kernels
    (torch.profiler, `utils/profiling.profiled_kernels`), and its copies
    plus two outside the graph, the input's and the output's clone (the
    graph's 4-byte loss writes run as `memcpy32_post` kernels);
  - a BatchedDetector sharded over a world-1 NCCL group, at B = 64 and at
    the bench's B = 8192, gives the unsharded detector's events and scores
    on the card bit for bit (the same kernels
    on the same shapes), K1 launching once per chunk, and the collectives
    return the local values;
  - `parallel.dryrun.dryrun_multigpu` over every card, one NCCL rank each.
"""
import functools
import gc
import weakref

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rustpotter_tpu_torch import RustpotterConfig, ScoreMode, load_wakeword, save_wakeword
from rustpotter_tpu_torch.ops import fused_dtw as fd
from rustpotter_tpu_torch.parallel import dryrun
from rustpotter_tpu_torch.parallel.collectives import fleet_detection_count, gather_detections
from rustpotter_tpu_torch.parallel.mesh import make_stream_group, multihost_initialize
from rustpotter_tpu_torch.runtime import graph
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.synthetic import (
    NN_TRAIN_SIZE,
    bench_utterances,
    build_bench_wakeword,
    correctness_stream,
    training_wavs,
)
from rustpotter_tpu_torch.utils.profiling import profiled_kernels, split_copies
from rustpotter_tpu_torch.wakewords import trainer as tr
from rustpotter_tpu_torch.wakewords.files import ModelType
from rustpotter_tpu_torch.wakewords.nn import init_params
from rustpotter_tpu_torch.wakewords.trainer import WakewordModelTrainOptions, train_from_buffers

EARLY = dict(rtol=2e-4, atol=2e-5)
LATE = dict(rtol=5e-3, atol=5e-4)
NN_TOL = dict(rtol=1e-4, atol=1e-3)
B_CARD = 64
BENCH_B = 8192  # the bench's streams
# (training frames and files, test frames and files, epochs, the MEDIUM
# model's weight shapes at that width)
SIZES = {"small": ((42, 12), (45, 6), 60, [[14, 672], [7, 14], [2, 7]]),
         "nn_medium": ((NN_TRAIN_SIZE, 64), (NN_TRAIN_SIZE, 16), 200,
                       [[56, 2688], [28, 56], [2, 28]])}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA kernels with no CPU build")
    return torch.device("cuda")


@functools.cache
def _trained(size, device):
    """(the model, the loss history) of the synthetic set of SIZES[size]
    trained on `device` ("cuda" or "cpu"); each trained once per process."""
    (frames, files), (test_frames, test_files), epochs, _ = SIZES[size]
    hist = {}
    model = train_from_buffers(WakewordModelTrainOptions(epochs=epochs),
                               training_wavs(frames, files, seed=0),
                               training_wavs(test_frames, test_files, seed=1),
                               device=device, verbose=False, history_out=hist)
    return model, hist


@pytest.mark.cuda
@pytest.mark.parametrize("size", list(SIZES))
def test_training_on_card_matches_cpu(cuda_device, size):
    (mg, hg), (mc, hc) = _trained(size, "cuda"), _trained(size, "cpu")
    dims = SIZES[size][3]
    assert mg.labels == mc.labels and mg.train_size == mc.train_size
    assert [mg.weights[f"ln{i}.weight"].dims for i in (1, 2, 3)] == dims
    np.testing.assert_allclose(hg["loss"][:10], hc["loss"][:10], **EARLY)
    np.testing.assert_allclose(hg["loss"], hc["loss"], **LATE)
    assert hg["test_accuracy"] == hc["test_accuracy"]
    for k in mc.weights:
        np.testing.assert_allclose(mg.weights[k].to_numpy(), mc.weights[k].to_numpy(),
                                   **LATE, err_msg=k)


@pytest.mark.cuda
def test_a_card_trained_model_round_trips_and_serves_as_on_the_cpu(cuda_device, tmp_path):
    model, _ = _trained("nn_medium", "cuda")
    assert model.train_size == NN_TRAIN_SIZE
    path = str(tmp_path / "trained.rpw")
    save_wakeword(model, path)
    back = load_wakeword(path)
    assert back.labels == model.labels and back.train_size == model.train_size
    for k, v in model.weights.items():
        assert back.weights[k].bytes == v.bytes and back.weights[k].dims == v.dims, k
    stream0 = correctness_stream(NN_TRAIN_SIZE, bench_utterances(100)[0])
    x = np.random.default_rng(0).normal(0, 0.05, (len(stream0), 4, 480)).astype(np.float32)
    x[:, 0] = stream0
    events = {}
    for dev in (cuda_device, "cpu"):
        det = BatchedDetector([("t", back)], RustpotterConfig(), batch_size=4, device=dev)
        _, ev = det.process_sequence(det.params, det.init_states(), torch.tensor(x, device=dev))
        events[str(dev)] = events_to_numpy(ev)
    gpu, cpu = events["cuda"], events["cpu"]
    for f in ("fired", "ww", "counter"):
        np.testing.assert_array_equal(getattr(gpu, f), getattr(cpu, f), err_msg=f)
    for f in ("score", "avg_score", "scores"):
        np.testing.assert_allclose(getattr(gpu, f)[cpu.fired], getattr(cpu, f)[cpu.fired],
                                   **NN_TOL, err_msg=f)
    print(f"the trained model served: stream 0 fired {int(cpu.fired[:, 0].sum())}x, streams "
          f"1-3 {int(cpu.fired[:, 1:].sum())}x")


def _captures(monkeypatch):
    """A list that gets a weak reference to each GraphedStep of the epochs
    (`trainer.sgd_epochs`) at its capture; the MFCC extraction's graphs
    (`mfcc/offline.py`, one per recording length) are not counted."""
    seen = []
    capture = graph.GraphedStep._capture

    def counted(self, *args):
        capture(self, *args)
        if self.fn is tr.sgd_epochs:
            seen.append(weakref.ref(self))

    monkeypatch.setattr(graph.GraphedStep, "_capture", counted)
    return seen


def _f32_bits(values):
    return np.asarray(values, np.float32).view(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["remainder", "finetune"])
def test_graphed_training_equals_eager_bit_for_bit(cuda_device, case, monkeypatch, capsys):
    samples, tests = training_wavs(42, 12, seed=0), training_wavs(45, 6, seed=1)
    prior = None
    if case == "finetune":
        prior = train_from_buffers(WakewordModelTrainOptions(epochs=30), samples, tests,
                                   device="cpu", verbose=False)
        samples, tests = training_wavs(39, 8, seed=3), training_wavs(39, 4, seed=4)
    opts = WakewordModelTrainOptions(epochs=65)  # 6 chunks of 10, then 5 epochs
    seen = _captures(monkeypatch)
    runs = {}
    for graphed in (True, False):
        if not graphed:  # the eager yardstick: every chunk calls sgd_epochs
            monkeypatch.setattr(tr, "GraphedStep", lambda fn: fn)
        hist = {}
        model = train_from_buffers(opts, samples, tests, prior, device=cuda_device,
                                   history_out=hist)
        runs[graphed] = (model, hist, capsys.readouterr().out.splitlines())
        assert len(seen) == 1, (graphed, len(seen))  # the graphed call's one capture
        gc.collect()
        assert seen[0]() is None  # dropped, with its graph, when the call returned
    (mg, hg, lg), (me, he, le) = runs[True], runs[False]
    assert len(hg["loss"]) == 65 and len(lg) == 7
    np.testing.assert_array_equal(_f32_bits(hg["loss"]), _f32_bits(he["loss"]))
    assert hg["test_accuracy"] == he["test_accuracy"] and lg == le
    assert mg.labels == me.labels and mg.train_size == me.train_size
    for k in me.weights:
        assert mg.weights[k].bytes == me.weights[k].bytes, k
    print(f"{case}: graphed training equals eager bit for bit over 65 epochs, "
          f"final loss {hg['loss'][-1]:.6f}")


@pytest.mark.cuda
def test_training_keeps_no_graph_memory_across_calls(cuda_device):
    samples, tests = training_wavs(42, 12, seed=0), training_wavs(45, 6, seed=1)
    opts = WakewordModelTrainOptions(epochs=40)
    reserved = []
    for _ in range(3):
        train_from_buffers(opts, samples, tests, device=cuda_device, verbose=False)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved.append(torch.cuda.memory_reserved(cuda_device))
    print(f"memory reserved after each call and empty_cache: {reserved} B")
    assert reserved[2] <= reserved[0], reserved


@pytest.mark.cuda
def test_a_replay_runs_the_eager_chunks_kernels(cuda_device):
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (64, 2688)).astype(np.float32), device=cuda_device)
    y = torch.tensor(np.arange(64) % 2, device=cuda_device)
    host = init_params(ModelType.MEDIUM, 2688, 16, 2, 0)
    consts = (y, torch.tensor(0.017, dtype=torch.float32, device=cuda_device))
    step = graph.GraphedStep(tr.sgd_epochs)
    sg, se = tr.epoch_state(host, 10, cuda_device), tr.epoch_state(host, 10, cuda_device)
    sg, _ = step(consts, sg, x)  # eager, then the capture
    se, _ = tr.sgd_epochs(consts, se, x)
    got = profiled_kernels(lambda: step(consts, sg, x), 3)
    want = profiled_kernels(lambda: tr.sgd_epochs(consts, se, x), 3)
    assert step.captures == 1
    (kg, cg), (ke, ce) = split_copies(got), split_copies(want)
    print(f"a replay runs {sum(kg.values())} device kernels and {cg} copies, an eager "
          f"chunk {sum(ke.values())} and {ce}")
    assert kg == ke
    # the graph's 10 loss writes, then outside it the input's copy and the
    # loss buffer's clone
    assert cg - ce == 2, (cg, ce)
    for a, b in zip(sg, se):  # the same epochs, the same bits
        assert torch.equal(a.detach().view(torch.int32), b.detach().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [B_CARD, BENCH_B])
def test_world1_nccl_sharded_chunk_equals_unsharded(cuda_device, tmp_path, b):
    ww, utterance = build_bench_wakeword(device="cpu", longest=30)
    cfg = RustpotterConfig()
    cfg.detector.score_mode = ScoreMode.MAX
    cfg.detector.avg_threshold = 0.2
    stream = correctness_stream(max(len(m) for m in ww.samples_features.values()), utterance)
    frames = np.random.default_rng(0).normal(0, 0.05, (len(stream), b, 480))
    frames = torch.tensor(frames.astype(np.float32), device=cuda_device)
    frames[:, 0] = torch.tensor(stream, device=cuda_device)
    multihost_initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0, device=cuda_device)
    try:
        sharding = make_stream_group()
        events = {}
        for name, sh in (("unsharded", None), ("sharded", sharding)):
            det = BatchedDetector([("w", ww)], cfg, batch_size=b, device=cuda_device,
                                  sharding=sh)
            states = det.init_states()
            before = fd.LAUNCHES["fused_dtw_v4"]
            evs = []
            for t in range(frames.shape[0]):
                states, ev = det.process_chunk(det.params, states, frames[t])
                evs.append([f.clone() for f in ev])
            torch.cuda.synchronize()
            assert fd.LAUNCHES["fused_dtw_v4"] - before == frames.shape[0]
            events[name] = evs
        for t, (a, b) in enumerate(zip(events["sharded"], events["unsharded"])):
            for f, g in zip(a, b):  # bit for bit (the gain is NaN, the normalizer off)
                if f.dtype.is_floating_point:
                    f, g = f.view(torch.int32), g.view(torch.int32)
                assert torch.equal(f, g), t
        fired = torch.stack([ev[0] for ev in events["sharded"]])
        assert fired[:, 0].any() and not fired[:, 1:].any()
        last = events["sharded"][-1]
        g_fired, g_score = gather_detections(sharding, last[0], last[2])
        assert torch.equal(g_fired, last[0]) and torch.equal(g_score, last[2])
        count = fleet_detection_count(sharding, fired[int(fired[:, 0].nonzero()[0])])
        assert int(count) == 1
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_dryrun_multigpu_over_every_card(cuda_device, tmp_path):
    n = torch.cuda.device_count()
    out = dryrun.dryrun_multigpu(n, "cuda", timeout_s=300, workdir=str(tmp_path))
    assert [r["rank"] for r in out] == list(range(n))
    for r in out:
        assert r["world"] == n and r["local_batch"] == dryrun.STREAMS_PER_RANK
        assert r["gathered"] == dryrun.STREAMS_PER_RANK * n
        assert r["device"] == f"cuda:{r['rank']}"
