"""Classifier-NN wakeword training.

The counterpart of `rustpotter_tpu.wakewords.trainer`. Parity: the
reference's src/wakewords/nn/wakeword_model_train.rs — labels parsed from
"[label]" in the file name else "none" (:289-339), input length = longest
training sample or the prior model's (:108-111), zero pad/truncate
(:117-120), full-batch SGD with NLL(log_softmax) loss (:197-208), periodic
test-set accuracy reporting (:210-218,252-273), fine-tuning from a prior
model with the label set frozen (:65-79,310-318).

Data preparation is host-side (the MFCCs on `device`); the epochs run on
`device` as fp32 tensors under autograd, the products `torch.matmul` (the
package disables TF32). The update is JAX's `p - lr * g` with `lr` an fp32
scalar, written in place as `p.sub_(lr * g)` (the same rounding), not
`torch.optim.SGD` (its `add_(g, alpha=-lr)` rounds otherwise).

Epochs run in chunks of `test_epochs` (`fit`); each chunk's losses stay on
the device and are read on the host once per chunk. `sgd_epochs` runs one
chunk on one set of parameter tensors, updated in place, and reads nothing
on the host: on the card `fit` replays it from a CUDA graph
(`runtime/graph.py` `GraphedStep`, captured after one eager chunk), the
counterpart of the JAX package's jitted `sgd_step` under `lax.scan`; a
shorter last chunk runs eagerly, and so does every chunk on the CPU. The
graph and its memory pool are dropped when `fit` returns. The test-set
accuracy is an eager call, per chunk when verbose and once at the end.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import NN_NONE_LABEL
from ..device import DeviceLike, resolve_device
from ..mfcc.offline import compute_mfccs
from ..runtime.graph import GraphedStep
from .files import ModelType, WakewordModel
from .nn import forward, init_params, params_from_tensor_data, params_to_tensor_data

Params = List[Tuple[torch.Tensor, torch.Tensor]]
# the tensors `sgd_epochs` updates in place: each layer's weight and bias
# (leaf tensors with requires_grad), then the (n,) loss buffer of n epochs
EpochState = Tuple[torch.Tensor, ...]


@dataclass
class WakewordModelTrainOptions:
    m_type: ModelType = ModelType.MEDIUM
    learning_rate: float = 0.017
    epochs: int = 1000
    test_epochs: int = 10
    mfcc_size: int = 16


def _label_from_filename(name: str) -> str:
    start = name.find("[")
    end = name.find("]")
    if start != -1 and end != -1 and start < end:
        return name[start + 1 : end].lower()
    return NN_NONE_LABEL


def _get_mfccs_labeled(
    samples: Dict[str, bytes],
    labels: List[str],
    new_labels: bool,
    mfcc_size: int,
    device: DeviceLike = None,
) -> Tuple[List[Tuple[np.ndarray, int]], float]:
    """[(flattened MFCCs, label index)] in the order of `samples`, and the
    running average of the labelled (not "none") samples' rms levels.
    Appends unseen labels to `labels` when `new_labels`, else raises."""
    labeled = []
    rms_level = float("nan")
    for name, buffer in samples.items():
        label = _label_from_filename(name)
        if label not in labels:
            if new_labels:
                labels.append(label)
            else:
                raise ValueError(
                    f"Forbidden label '{label}', it doesn't exists on the training "
                    "data or in the model you are training from."
                )
        mfccs, rms = compute_mfccs(buffer, mfcc_size, device)
        if label != NN_NONE_LABEL:
            rms_level = rms if np.isnan(rms_level) else (rms_level + rms) / 2.0
        labeled.append((mfccs.reshape(-1).astype(np.float32), labels.index(label)))
    return labeled, rms_level


def _files_data_map(dir_path: str) -> Dict[str, bytes]:
    """{file name: bytes} of the .wav files in `dir_path`, in os.listdir
    order (which fixes the label indices, as in the JAX package)."""
    out = {}
    for fn in os.listdir(dir_path):
        if fn.endswith(".wav"):
            with open(os.path.join(dir_path, fn), "rb") as f:
                out[fn] = f.read()
    return out


def _stack(rows: Sequence[Tuple[np.ndarray, int]], input_len: int):
    """(N, input_len) features, zero-padded or truncated, and (N,) labels."""
    feats = np.zeros((len(rows), input_len), np.float32)
    labs = np.zeros((len(rows),), np.int64)
    for i, (f, l) in enumerate(rows):
        n = min(len(f), input_len)
        feats[i, :n] = f[:n]
        labs[i] = l
    return feats, labs


def nll_loss(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """NLL(log_softmax(forward(x))) averaged over the batch (candle's
    loss::nll)."""
    logp = torch.log_softmax(forward(params, x), dim=-1)
    return -torch.mean(torch.gather(logp, 1, y[:, None]))


class Losses(NamedTuple):
    """What `sgd_epochs` returns beside its state: the chunk's (n,) losses."""
    loss: torch.Tensor


def epoch_state(host: Sequence[Tuple[np.ndarray, np.ndarray]], n: int,
                device: torch.device) -> EpochState:
    """The state of `sgd_epochs` for n epochs per call, from the host
    weights [(W, b), ...]."""
    flat = [torch.tensor(a, device=device).requires_grad_() for wb in host for a in wb]
    return (*flat, torch.empty(n, dtype=torch.float32, device=device))


def layers(state: EpochState) -> Params:
    """The [(weight, bias), ...] of a state (its loss buffer left out)."""
    flat = state[:-1]
    return list(zip(flat[0::2], flat[1::2]))


def sgd_epochs(consts: Tuple[torch.Tensor, torch.Tensor], state: EpochState,
               x: torch.Tensor) -> Tuple[EpochState, Losses]:
    """n = len(state[-1]) full-batch SGD epochs on the rows x and their
    labels y, consts = (y, lr). Updates the parameters in place and writes
    the loss before each update into the loss buffer; returns the state and
    the buffer. Creates no leaf tensor and reads nothing on the host: the
    `GraphedStep` contract fn(params, states, x) -> (states, out)."""
    y, lr = consts
    flat, losses = state[:-1], state[-1]
    params = layers(state)
    for e in range(losses.shape[0]):
        loss = nll_loss(params, x, y)
        grads = torch.autograd.grad(loss, flat)
        with torch.no_grad():
            for p, g in zip(flat, grads):
                p.sub_(lr * g)
            losses[e] = loss
    return state, Losses(losses)


def accuracy(params: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Share of rows whose argmax logit (the first maximum) is the label,
    an fp32 tensor on the device."""
    with torch.no_grad():
        return (torch.argmax(forward(params, x), dim=-1) == y).to(torch.float32).mean()


def fit(
    host: Sequence[Tuple[np.ndarray, np.ndarray]],
    x: torch.Tensor,
    y: torch.Tensor,
    x_test: torch.Tensor,
    y_test: torch.Tensor,
    learning_rate: float,
    epochs: int,
    test_epochs: int,
    verbose: bool = True,
) -> Tuple[Params, List[float]]:
    """`epochs` SGD epochs from the host weights [(W, b), ...] on the rows x
    and labels y (on the device they lie on), in chunks of `test_epochs`,
    the losses read once per chunk; verbose prints the last loss and the
    test-set accuracy per chunk. On the card each full chunk replays a CUDA
    graph of `sgd_epochs` (one capture per call, after an eager chunk; a
    capture that fails raises); on the CPU every chunk runs eagerly. Returns
    the trained [(weight, bias), ...] and the loss of every epoch."""
    chunk = max(1, test_epochs)
    consts = (y, torch.tensor(learning_rate, dtype=torch.float32, device=x.device))
    state = epoch_state(host, chunk, x.device)
    step = GraphedStep(sgd_epochs)
    epoch = 0
    loss_history: List[float] = []
    while epoch < epochs:
        n = min(chunk, epochs - epoch)
        if n < chunk:  # the shorter last chunk, eagerly
            state = (*state[:-1], torch.empty(n, dtype=torch.float32, device=x.device))
            state, (losses,) = sgd_epochs(consts, state, x)
        else:
            state, (losses,) = step(consts, state, x)
        epoch += n
        chunk_losses = losses.tolist()
        loss_history.extend(chunk_losses)
        if verbose:
            acc = float(accuracy(layers(state), x_test, y_test))
            print(f"{epoch:4} train loss: {chunk_losses[-1]:8.5f} test acc: {100.0 * acc:5.2f}%")
    return layers(state), loss_history


def train_from_buffers(
    options: WakewordModelTrainOptions,
    samples: Dict[str, bytes],
    test_samples: Dict[str, bytes],
    prior_model: Optional[WakewordModel] = None,
    seed: int = 0,
    verbose: bool = True,
    history_out: Optional[dict] = None,
    device: DeviceLike = None,
) -> WakewordModel:
    """Train on `device` (default: the CUDA card; RuntimeError without one).
    history_out (optional dict) receives {'loss': [per-epoch train loss],
    'test_accuracy': final test-set accuracy} — the telemetry the reference
    prints during training (wakeword_model_train.rs:210-218). The epochs
    run as in `fit`."""
    dev = resolve_device(device)
    if not samples:
        raise ValueError("No training data provided")
    if not test_samples:
        raise ValueError("No test data provided")
    labels: List[str] = list(prior_model.labels) if prior_model else []
    m_type = prior_model.m_type if prior_model else options.m_type
    mfcc_size = prior_model.mfcc_size if prior_model else options.mfcc_size
    labeled, rms_level = _get_mfccs_labeled(samples, labels, prior_model is None,
                                            mfcc_size, dev)
    test_labeled, _ = _get_mfccs_labeled(test_samples, labels, False, mfcc_size, dev)
    if len(labels) < 2:
        raise ValueError("Your training data need to contain at least two labels")
    input_len = (
        prior_model.train_size * mfcc_size
        if prior_model
        else max(len(f) for f, _ in labeled)
    )
    x_train, y_train = (torch.tensor(a, device=dev) for a in _stack(labeled, input_len))
    x_test, y_test = (torch.tensor(a, device=dev) for a in _stack(test_labeled, input_len))

    if prior_model is not None:
        host = params_from_tensor_data(prior_model.weights)
    else:
        host = init_params(m_type, input_len, mfcc_size, len(labels), seed)
    params, loss_history = fit(host, x_train, y_train, x_test, y_test,
                               options.learning_rate, options.epochs, options.test_epochs,
                               verbose)
    if history_out is not None:
        history_out["loss"] = loss_history
        history_out["test_accuracy"] = float(accuracy(params, x_test, y_test))

    weights = params_to_tensor_data(
        [(w.detach().cpu().numpy(), b.detach().cpu().numpy()) for w, b in params]
    )
    return WakewordModel(
        labels=labels,
        m_type=m_type,
        train_size=input_len // mfcc_size,
        mfcc_size=mfcc_size,
        weights=weights,
        rms_level=rms_level,
    )


def train_from_dirs(
    options: WakewordModelTrainOptions,
    train_dir: str,
    test_dir: str,
    prior_model: Optional[WakewordModel] = None,
    **kw,
) -> WakewordModel:
    """train_from_buffers on the .wav files of two directories; `kw` as
    there (seed, verbose, history_out, device)."""
    return train_from_buffers(
        options, _files_data_map(train_dir), _files_data_map(test_dir), prior_model, **kw
    )
