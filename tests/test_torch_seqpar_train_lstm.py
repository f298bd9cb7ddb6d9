"""The port's sequence-parallel training of LSTM models (``sp_loss`` and
``Trainer`` with ``train.sequence_parallel`` for ``rnn_type="lstm"``:
each direction of each layer one D=1 ``LSTMFunction`` call a shard from
the carried ``(h, c)``, ``(dh0, dc0)`` relayed back) on eight CPU shards
against the JAX package's on the 8-device CPU mesh (``make_mesh((8,
1))``, whose relay runs ``lstm_scan(..., hc0=carry,
return_final=True)``) and against its offline train-mode forward: the
same weights (JAX's tree through ``bridge.from_flax``), features and
labels, tests/test_seqpar.py's model, init and data
(tests/test_torch_seqpar_train.py's helpers: dev_slice at 2 layers of 32
units, 4+4 conv channels, V=16, f32, T=256 with lengths (256, 199)),
bidirectional and not.

Tolerances are tests/test_torch_seqpar_train.py's (JAX
``test_sp_loss_matches_offline_grads``'s): the loss within 1e-6
relative, the gradients within rtol 1e-4 and atol 5e-4 of each leaf's
largest magnitude, the BN statistics within 1e-5; a ``Trainer`` step's
loss within 1e-5 relative and its parameters within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.ops.ctc import ctc_loss_ref as jax_ctc_loss_ref
from deepspeech_tpu.parallel import make_mesh as jax_make_mesh
from deepspeech_tpu.parallel import seqpar as jax_seqpar
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean
from deepspeech_tpu_torch.parallel import seqpar
from deepspeech_tpu_torch.train import Trainer
from test_torch_seqpar import CPU8, _over
from test_torch_seqpar_train import (GRAD_ATOL, GRAD_RTOL, LOSS_RTOL,
                                     STATS_ATOL, _Batches, _close, _labels,
                                     _momentum, _port, _Quiet, _setup,
                                     _trainer_configs)

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mesh():
    return jax_make_mesh((8, 1))


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm_sp_loss_matches_jax_sp_loss(mesh, bidirectional):
    """Port against JAX ``sp_loss`` under ``jax.value_and_grad`` on the
    (8, 1) mesh: the loss, every gradient and the BN statistics."""
    jcfg, tcfg = _over(rnn_type="lstm", bidirectional=bidirectional)
    variables, feats, lens = _setup(jcfg, 21 + bidirectional)
    labels, label_lens = _labels(21)

    def sp(p):
        return jax_seqpar.sp_loss(
            jcfg.model, {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), jnp.asarray(lens), jnp.asarray(labels),
            jnp.asarray(label_lens), mesh)

    (ref_loss, ref_stats), ref_grads = jax.jit(
        jax.value_and_grad(sp, has_aux=True))(variables["params"])
    loss, grads, raw = _port(tcfg, variables, feats, lens, labels,
                             label_lens)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=LOSS_RTOL)
    _close(grads, ref_grads, GRAD_RTOL, GRAD_ATOL, scaled=True)
    _close(raw, ref_stats, 0, STATS_ATOL)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_lstm_sp_loss_matches_jax_offline_train_step(bidirectional):
    """The port's ``sp_loss`` over eight shards against JAX's offline
    train-mode ``model.apply`` and the mean ``ctc_loss_ref``: the loss,
    the gradients and the BN statistics after the momentum."""
    jcfg, tcfg = _over(rnn_type="lstm", bidirectional=bidirectional)
    variables, feats, lens = _setup(jcfg, 31 + bidirectional)
    labels, label_lens = _labels(31)
    model = jax_create_model(jcfg.model)

    def off(p):
        (logits, clens), mut = model.apply(
            {"params": p, "batch_stats": variables["batch_stats"]},
            jnp.asarray(feats), jnp.asarray(lens), train=True,
            mutable=["batch_stats"])
        return (jnp.mean(jax_ctc_loss_ref(logits, jnp.asarray(labels), clens,
                                          jnp.asarray(label_lens))),
                mut["batch_stats"])

    (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(
        off, has_aux=True))(variables["params"])
    loss, grads, raw = _port(tcfg, variables, feats, lens, labels,
                             label_lens)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=LOSS_RTOL)
    _close(grads, ref_grads, GRAD_RTOL, GRAD_ATOL, scaled=True)
    _close(_momentum(variables["batch_stats"], raw), ref_stats, 0,
           STATS_ATOL)


@pytest.mark.parametrize("shards", [1, 2])
def test_lstm_few_shards_are_the_offline_step(shards):
    """Over one shard ``sp_loss`` is the port's offline LSTM train step
    bit for bit (loss, gradients, BN running statistics through
    ``MaskedBatchNorm.update``): no carry enters or leaves a chunk, so
    every ``LSTMFunction`` call is the offline one's direction. Over two
    the carry crosses once each way; the gradients then hold the
    offline step's within the bounds above."""
    jcfg, tcfg = _over(rnn_type="lstm")
    variables, feats, lens = _setup(jcfg, 41)
    labels, label_lens = _labels(41)
    models = []
    for _ in range(2):
        m = DeepSpeech2(tcfg.model)
        m.load_state_dict(bridge.from_flax(variables["params"],
                                           variables["batch_stats"]))
        models.append(m.train())
    sp_model, model = models
    args = [torch.from_numpy(x) for x in (feats, lens, labels, label_lens)]
    loss, stats = seqpar.sp_loss(tcfg.model, sp_model, *args, CPU8[:shards])
    loss.backward()
    for name, (mean, var) in stats.items():
        sp_model.get_submodule(name).update(mean, var)
    logits, clens = model(args[0], args[1])
    ref = ctc_loss_mean(logits, args[2], clens, args[3])
    ref.backward()
    if shards == 1:
        assert torch.equal(loss, ref)
        for (name, p), (_, q) in zip(sp_model.named_parameters(),
                                     model.named_parameters()):
            assert torch.equal(p.grad, q.grad), name
        for (name, b), (_, c) in zip(sp_model.named_buffers(),
                                     model.named_buffers()):
            assert torch.equal(b, c), name
        return
    np.testing.assert_allclose(float(loss.detach()), float(ref.detach()),
                               rtol=LOSS_RTOL)
    got, _ = bridge.to_flax({k: p.grad for k, p in
                             sp_model.named_parameters()})
    want, _ = bridge.to_flax({k: p.grad for k, p in model.named_parameters()})
    _close(got, want, GRAD_RTOL, GRAD_ATOL, scaled=True)


def test_lstm_trainer_step_matches_jax_sp_trainer(mesh):
    """One ``Trainer`` step of an LSTM model with
    ``train.sequence_parallel=True`` over eight CPU shards against JAX's
    ``Trainer`` on the (8, 1) mesh, from JAX's init and on JAX's
    synthetic batch: the loss and every parameter after the optimizer
    step."""
    import dataclasses as dc

    from deepspeech_tpu.data import CharTokenizer as JaxTokenizer
    from deepspeech_tpu.parallel import shard_batch
    from deepspeech_tpu.train import Trainer as JaxTrainer
    from deepspeech_tpu.train import _SyntheticPipeline
    from deepspeech_tpu.utils.logging import JsonlLogger
    from deepspeech_tpu_torch.config import apply_overrides

    jcfg, tcfg = _trainer_configs()
    jcfg = dc.replace(jcfg, model=dc.replace(jcfg.model, rnn_type="lstm"))
    tcfg = apply_overrides(tcfg, {"model.rnn_type": "lstm"})
    pipe = _SyntheticPipeline(jcfg, n_utts=2, frames=256, label_len=6)
    jtr = JaxTrainer(jcfg, pipe, JaxTokenizer.english(),
                     logger=JsonlLogger(echo=False), mesh=mesh)
    batch = {k: np.asarray(v) for k, v in next(iter(pipe.epoch(0))).items()}
    params = jax.tree.map(np.asarray, jtr.state.params)
    stats = jax.tree.map(np.asarray, jtr.state.batch_stats)
    j_state, j_metrics = jtr.train_step(
        jtr.state, shard_batch(jtr.mesh, batch, time_sharded=True))
    tr = Trainer(tcfg, _Batches([batch]), CharTokenizer.english(),
                 logger=_Quiet(), device="cpu", params=params,
                 batch_stats=stats, sp_devices=CPU8)
    metrics = tr.train_step(batch)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(j_metrics["loss"]), rtol=1e-5)
    got, _ = bridge.to_flax(tr.model.state_dict())
    _close(got, jax.tree.map(np.asarray, j_state.params), rtol=0, atol=1e-5)
