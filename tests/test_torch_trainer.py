"""NN training in the PyTorch port (`wakewords.trainer`, device="cpu")
against the JAX package's trainer on the same WAV bytes and seed.

The data is `synthetic.training_wavs`: MEDIUM at 42 frames × 16 (672 → 14
→ 7 → 2), 12 training files and 6 test files of 45 frames (truncated to the
training length), 60 epochs in chunks of 10.

  (a) train_from_buffers: labels and their order, m_type, train_size and
      mfcc_size equal; rms_level rtol 1e-6; the loss history and the final
      weights at `tests/test_training_torch_crosscheck.py`'s tolerances (the
      first 10 epochs rtol 2e-4 / atol 2e-5, all rtol 5e-3 / atol 5e-4);
      test accuracy and the verbose lines' epochs and accuracies equal;
  (b) fine-tuning from a prior model (39-frame files, zero-padded to the
      prior's 42): labels frozen, the same trajectory; a foreign label
      raises JAX's ValueError; (a) and (b) also with a shorter last chunk
      (25 or 65 epochs in chunks of 10, 60 in chunks of 7);
  (c) no training data, no test data, a single label: JAX's errors;
  (d) train_from_dirs on one directory, whose os.listdir order fixes the
      labels in both packages;
  (e) the trained model served by the port's BatchedDetector gives the JAX
      BatchedDetector's events over the correctness stream (NN scores rtol
      1e-4 / atol 1e-3), also with the JAX detector's parameters carried
      across by `runtime.convert`.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustpotter_tpu import RustpotterConfig as JaxConfig
from rustpotter_tpu.runtime.batch import BatchedDetector as JaxBatchedDetector
from rustpotter_tpu.runtime.bundle import StepParams as JaxStepParams
from rustpotter_tpu.wakewords import trainer as jt
from rustpotter_tpu_torch import RustpotterConfig
from rustpotter_tpu_torch.runtime.batch import BatchedDetector, events_to_numpy
from rustpotter_tpu_torch.runtime.convert import params_from_numpy
from rustpotter_tpu_torch.synthetic import bench_utterances, correctness_stream, training_wavs
from rustpotter_tpu_torch.wakewords import trainer as pt
from rustpotter_tpu_torch.wakewords.files import ModelType
from test_torch_nn import jax_model

torch.set_num_threads(2)

FRAMES = 42
EPOCHS = 60
EARLY = dict(rtol=2e-4, atol=2e-5)
LATE = dict(rtol=5e-3, atol=5e-4)
NN_TOL = dict(rtol=1e-4, atol=1e-3)
B = 4


def _opts(pkg, **kw):
    kw.setdefault("epochs", EPOCHS)
    return pkg.WakewordModelTrainOptions(**kw)


def _train(samples, tests, capsys, prior=None, **kw):
    """(port model, port history, port lines, JAX model, JAX history, JAX lines)."""
    hp, hj = {}, {}
    mp = pt.train_from_buffers(_opts(pt, **kw), samples, tests, prior, device="cpu",
                               history_out=hp)
    lp = capsys.readouterr().out.splitlines()
    mj = jt.train_from_buffers(_opts(jt, **kw), samples, tests,
                               jax_model(prior) if prior else None, history_out=hj)
    lj = capsys.readouterr().out.splitlines()
    return mp, hp, lp, mj, hj, lj


def _assert_same_training(mp, hp, lp, mj, hj, lj, epochs=EPOCHS, test_epochs=10):
    assert mp.labels == mj.labels
    assert mp.m_type.value == mj.m_type.value
    assert (mp.train_size, mp.mfcc_size) == (mj.train_size, mj.mfcc_size)
    np.testing.assert_allclose(mp.rms_level, mj.rms_level, rtol=1e-6)
    lossp, lossj = np.array(hp["loss"]), np.array(hj["loss"])
    assert lossp.shape == lossj.shape == (epochs,)
    np.testing.assert_allclose(lossp[:10], lossj[:10], **EARLY)
    np.testing.assert_allclose(lossp, lossj, **LATE)
    assert lossp[-1] < lossp[0] * 0.5  # genuinely trained
    assert hp["test_accuracy"] == hj["test_accuracy"]
    assert list(mp.weights) == list(mj.weights)
    for k in mj.weights:
        assert mp.weights[k].dims == mj.weights[k].dims, k
        np.testing.assert_allclose(mp.weights[k].to_numpy(), mj.weights[k].to_numpy(),
                                   **LATE, err_msg=k)
    # verbose: one line per chunk (a shorter last one too); epochs and
    # accuracies equal, losses close
    pat = re.compile(r"^ *(\d+) train loss: +(\S+) test acc: +(\S+)%$")
    assert len(lp) == len(lj) == -(-epochs // test_epochs)
    for a, b in zip(lp, lj):
        ma, mb = pat.match(a), pat.match(b)
        assert ma and mb, (a, b)
        assert (ma[1], ma[3]) == (mb[1], mb[3])
        np.testing.assert_allclose(float(ma[2]), float(mb[2]), atol=2e-5 + 5e-3 * float(mb[2]))


@pytest.fixture(scope="module")
def data():
    return training_wavs(FRAMES, 12, seed=0), training_wavs(FRAMES + 3, 6, seed=1)


@pytest.fixture(scope="module")
def trained(data):
    """The port's model trained on `data` (the prior of (b), served in (e))."""
    return pt.train_from_buffers(_opts(pt), *data, device="cpu", verbose=False)


def test_options_defaults_match_jax():
    a, b = pt.WakewordModelTrainOptions(), jt.WakewordModelTrainOptions()
    assert a.m_type.value == b.m_type.value == "medium"
    assert (a.learning_rate, a.epochs, a.test_epochs, a.mfcc_size) == (
        b.learning_rate, b.epochs, b.test_epochs, b.mfcc_size) == (0.017, 1000, 10, 16)


def test_no_device_means_the_card(data):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: no device means that card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pt.train_from_buffers(_opts(pt), *data)


def test_train_from_buffers_matches_jax(data, capsys):
    mp, hp, lp, mj, hj, lj = _train(*data, capsys)
    assert mp.labels == ["bench", "none"]
    assert mp.train_size == FRAMES and mp.m_type == ModelType.MEDIUM
    assert [mp.weights[f"ln{i}.weight"].dims for i in (1, 2, 3)] == [
        [14, 672], [7, 14], [2, 7]]
    _assert_same_training(mp, hp, lp, mj, hj, lj)


def test_finetune_from_prior_matches_jax(trained, capsys):
    samples = training_wavs(FRAMES - 3, 8, seed=3)
    tests = training_wavs(FRAMES - 3, 4, seed=4)
    mp, hp, lp, mj, hj, lj = _train(samples, tests, capsys, prior=trained,
                                    m_type=ModelType.SMALL, mfcc_size=8)
    # the prior's shape and labels, not the options'
    assert mp.labels == trained.labels and mp.train_size == trained.train_size
    assert mp.m_type == ModelType.MEDIUM and mp.mfcc_size == 16
    _assert_same_training(mp, hp, lp, mj, hj, lj)


# a shorter last chunk (epochs % test_epochs), which the port runs eagerly
# after the graphed chunks on the card
REMAINDERS = [(25, 10), (65, 10), (60, 7)]


@pytest.mark.parametrize("epochs,test_epochs", REMAINDERS)
def test_a_shorter_last_chunk_matches_jax(data, capsys, epochs, test_epochs):
    mp, hp, lp, mj, hj, lj = _train(*data, capsys, epochs=epochs, test_epochs=test_epochs)
    _assert_same_training(mp, hp, lp, mj, hj, lj, epochs, test_epochs)
    assert int(lp[-1].split()[0]) == epochs


@pytest.mark.parametrize("epochs,test_epochs", REMAINDERS[:2])
def test_finetune_with_a_shorter_last_chunk_matches_jax(trained, capsys, epochs, test_epochs):
    samples = training_wavs(FRAMES, 8, seed=3)
    tests = training_wavs(FRAMES, 4, seed=4)
    mp, hp, lp, mj, hj, lj = _train(samples, tests, capsys, prior=trained, epochs=epochs,
                                    test_epochs=test_epochs)
    assert mp.labels == trained.labels and mp.train_size == trained.train_size
    _assert_same_training(mp, hp, lp, mj, hj, lj, epochs, test_epochs)


@pytest.mark.parametrize("where", ["train", "test"])
def test_finetune_foreign_label_raises_as_jax(trained, where):
    samples, tests = training_wavs(FRAMES, 2, seed=5), training_wavs(FRAMES, 2, seed=6)
    foreign = next(iter(samples.values()))
    (samples if where == "train" else tests)["[other]_000.wav"] = foreign
    with pytest.raises(ValueError) as ej:
        jt.train_from_buffers(_opts(jt), samples, tests, jax_model(trained), verbose=False)
    with pytest.raises(ValueError) as ep:
        pt.train_from_buffers(_opts(pt), samples, tests, trained, device="cpu", verbose=False)
    assert str(ep.value) == str(ej.value)
    assert "Forbidden label 'other'" in str(ep.value)


def _none_only(files):
    return {k: v for k, v in files.items() if k.startswith("none")}


@pytest.mark.parametrize("case", ["no_training_data", "no_test_data", "single_label"])
def test_errors_match_jax(data, case):
    samples, tests = {
        "no_training_data": ({}, data[1]),
        "no_test_data": (data[0], {}),
        "single_label": (_none_only(data[0]), _none_only(data[1])),
    }[case]
    with pytest.raises(ValueError) as ej:
        jt.train_from_buffers(_opts(jt), samples, tests, verbose=False)
    with pytest.raises(ValueError) as ep:
        pt.train_from_buffers(_opts(pt), samples, tests, device="cpu", verbose=False)
    assert str(ep.value) == str(ej.value)


def test_train_from_dirs_matches_jax(data, tmp_path, capsys):
    for sub, files in zip(("train", "test"), data):
        (tmp_path / sub).mkdir()
        for name, raw in files.items():
            (tmp_path / sub / name).write_bytes(raw)
    (tmp_path / "train" / "notes.txt").write_text("not a wav")
    hp, hj = {}, {}
    mp = pt.train_from_dirs(_opts(pt), str(tmp_path / "train"), str(tmp_path / "test"),
                            device="cpu", history_out=hp)
    lp = capsys.readouterr().out.splitlines()
    mj = jt.train_from_dirs(_opts(jt), str(tmp_path / "train"), str(tmp_path / "test"),
                            history_out=hj)
    lj = capsys.readouterr().out.splitlines()
    assert list(pt._files_data_map(str(tmp_path / "train"))) == list(
        jt._files_data_map(str(tmp_path / "train")))
    _assert_same_training(mp, hp, lp, mj, hj, lj)


def test_trained_model_serves_as_in_jax(trained):
    utterance = bench_utterances(FRAMES * 100 // 168)[0]
    stream = correctness_stream(trained.train_size, utterance)
    frames = np.random.default_rng(7).normal(0, 0.05, (len(stream), B, 480)).astype(np.float32)
    frames[:, 0] = stream
    jdet = JaxBatchedDetector([("t", jax_model(trained))], JaxConfig(), batch_size=B)
    _, jev = jdet.process_sequence(jdet.params, jdet.init_states(), jnp.asarray(frames))
    want = {f: np.asarray(getattr(jev, f)) for f in jev._fields}
    det = BatchedDetector([("t", trained)], RustpotterConfig(), batch_size=B, device="cpu")
    d = {f: np.asarray(getattr(jdet.params, f)) for f in JaxStepParams._FIELDS
         if f != "nn_params"}
    d["nn_params"] = [[(np.asarray(w), np.asarray(b)) for w, b in layers]
                      for layers in jdet.params.nn_params]
    for params in (det.params, params_from_numpy(d, device="cpu")):
        _, ev = det.process_sequence(params, det.init_states(), frames)
        got = events_to_numpy(ev)._asdict()
        for f in ("fired", "ww", "counter"):
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        fired = want["fired"]
        for f in ("score", "avg_score", "scores", "gain"):
            np.testing.assert_allclose(got[f][fired], want[f][fired], **NN_TOL, err_msg=f)
    assert want["fired"][:, 0].sum() >= 1  # the trained model detects the utterance
    assert want["fired"][:, 1:].sum() == 0  # and stays silent on noise
