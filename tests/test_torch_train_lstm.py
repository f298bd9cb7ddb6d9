"""LSTM training: the port's ``Trainer`` with ``model.rnn_type="lstm"``
against the JAX package's ``make_train_step`` from one set of numpy
weights and one ragged batch, in float32, with the JAX side on its
Pallas LSTM kernels in interpret mode (``model.rnn_impl="pallas"``:
``lstm_scan_pallas`` and its VJP). Models: a 3-layer ds2_small-lstm
shape (the resident kernels, K12/K13) and a 7-layer ds2_full-lstm shape
with the JAX side forced onto its blocked kernels (K14/K15) by setting
``rnn_pallas._VMEM_WEIGHT_BUDGET`` to 0 inside the test, both at H=32
with 4 conv channels. Also the train CLI on an LSTM.

On the CPU the port runs its plain versions; chip_smoke.py holds the
CUDA kernels to those on the card at the full width. Tolerances
(tests/test_torch_full.py's): gradients and parameters after a step
1e-4 relative and absolute of each leaf's largest value, BN statistics
1e-5, the loss and the gradient norm 1e-5 relative.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.ops import ctc_loss_mean as jax_ctc_loss_mean
from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, SyntheticPipeline
from deepspeech_tpu_torch.data.synthetic import synthetic_batch
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops import lstm
from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean
from deepspeech_tpu_torch.train import Trainer
from test_torch_model import random_flax_variables
from test_torch_train import _assert_trees_close, _jax_step

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The child's torch (OpenMP, MKL) holds to one thread, as this process does.
ONE_THREAD = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
NARROW = {"model.rnn_type": "lstm", "model.rnn_hidden": "32",
          "model.conv_channels": "4,4", "model.dtype": "float32",
          "model.rnn_impl": "pallas", "data.batch_size": "4",
          "train.checkpoint_dir": "", "train.optimizer": "sgd",
          "train.learning_rate": "0.001", "train.warmup_steps": "2",
          "train.grad_clip_norm": "50"}
LAYERS = {"ds2_small": 3, "ds2_full": 7}


def _setup(preset, seed):
    """Configs, random flax variables from numpy and a ragged batch."""
    jcfg = jax_apply_overrides(jax_get_config(preset), NARROW)
    tcfg = apply_overrides(get_config(preset), NARROW)
    assert tcfg.model.rnn_layers == jcfg.model.rnn_layers == LAYERS[preset]
    batch, _ = synthetic_batch(tcfg, 4, 48, 5, seed=seed, frames_per_label=6)
    batch["feat_lens"][1:] = [40, 31, 22]
    model = jax_create_model(jcfg.model)
    params, stats = random_flax_variables(
        model, jnp.asarray(batch["features"]),
        jnp.asarray(batch["feat_lens"]), np.random.default_rng(seed))
    assert params["rnn"]["rnn0"]["wh_fw"].shape == (32, 128)
    return jcfg, tcfg, model, params, stats, batch


@pytest.mark.parametrize("preset,blocked", [("ds2_small", False),
                                            ("ds2_full", True)])
def test_lstm_gradients_bn_stats_and_one_sgd_step_match_jax(
        monkeypatch, preset, blocked):
    """One forward in train mode and one backward: every parameter's
    gradient and the updated BN statistics; then one SGD step through
    ``make_train_step`` on a one-device mesh against
    ``Trainer.train_step``: parameters, statistics, loss, gradient norm.
    The port's layers go through ``LSTMFunction`` (one taped forward and
    one backward per layer)."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert rnn_pallas._use_blocked(32, jnp.float32, n_gates=4) is blocked
    jcfg, tcfg, jmodel, params, stats, batch = _setup(preset, 2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_of(p):
        (logits, lens), mut = jmodel.apply(
            {"params": p, "batch_stats": stats}, jb["features"],
            jb["feat_lens"], train=True, mutable=["batch_stats"])
        return (jax_ctc_loss_mean(logits, jb["labels"], lens,
                                  jb["label_lens"]), mut["batch_stats"])

    (ref_loss, ref_stats), ref_grads = jax.jit(
        jax.value_and_grad(loss_of, has_aux=True))(params)
    port = DeepSpeech2(tcfg.model)
    port.load_state_dict(bridge.from_flax(params, stats))
    port.train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    calls = []
    real_bwd = lstm.lstm_bwd
    monkeypatch.setattr(lstm, "lstm_bwd",
                        lambda *a: calls.append(a[-1]) or real_bwd(*a))
    logits, lens = port(tb["features"], tb["feat_lens"].long())
    loss = ctc_loss_mean(logits, tb["labels"], lens, tb["label_lens"])
    loss.backward()
    assert calls == [(False, True)] * LAYERS[preset]
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=1e-5)
    grads, _ = bridge.to_flax({k: p.grad
                               for k, p in port.named_parameters()})
    _assert_trees_close(grads, ref_grads)
    _assert_trees_close(bridge.to_flax(port.state_dict())[1], ref_stats,
                        rtol=1e-5, atol=1e-6)

    ref_state, ref_metrics = _jax_step(jcfg, params, stats, batch, 1)
    trainer = Trainer(tcfg, SyntheticPipeline(tcfg, 4),
                      CharTokenizer.english(), device="cpu", params=params,
                      batch_stats=stats)
    got = {k: float(v) for k, v in trainer.train_step(batch).items()}
    np.testing.assert_allclose(got["loss"], ref_metrics[0]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], ref_metrics[0]["grad_norm"],
                               rtol=1e-5)
    got_params, got_stats = bridge.to_flax(trainer.model.state_dict())
    _assert_trees_close(got_params, ref_state.params)
    _assert_trees_close(got_stats, ref_state.batch_stats, rtol=1e-5,
                        atol=1e-6)


def test_train_cli_trains_an_lstm():
    cmd = [sys.executable, "-m", "deepspeech_tpu_torch.train",
           "--config=ds2_small", "--model.rnn_type=lstm", "--synthetic=4",
           "--device=cpu", "--train.checkpoint_dir=",
           "--model.rnn_hidden=16", "--model.conv_channels=4,4",
           "--data.batch_size=2", "--train.epochs=1"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=ONE_THREAD)
    assert out.returncode == 0, out.stderr
    last = json.loads(out.stdout.strip().splitlines()[-1])
    assert last["event"] == "done" and last["steps"] == 2
    assert np.isfinite(last["loss"]) and np.isfinite(last["grad_norm"])
