"""The port's sequence-parallel training (``parallel/seqpar.py``'s
``sp_loss``, ``Trainer`` with ``train.sequence_parallel``) on eight CPU
shards against the JAX package's on the 8-device CPU mesh
(``make_mesh((8, 1))``, as tests/test_seqpar.py runs it) and against its
offline train-mode forward: the same weights (JAX's tree through
``bridge.from_flax``), features and labels, tests/test_seqpar.py's
model, init and data (its ``_cfg`` and ``_setup``: dev_slice at 2 GRU
layers of 32 units, 4+4 conv channels, V=16, f32, T=256 with lengths
(256, 199)).

Tolerances are JAX ``test_sp_loss_matches_offline_grads``'s own: the loss
within 1e-6 relative, the gradients within rtol 1e-4 and atol 5e-4 (the
relay and the shards' BN sums add in another order than one device),
the atol taken of each leaf's largest magnitude, as
tests/test_torch_train.py scales its bound between the two frameworks
(the port's offline step already lands 1.6 times the unscaled atol from
JAX's offline step on conv0's kernel, whose entries reach ~3), the BN
statistics within 1e-5; a ``Trainer`` step's loss within 1e-5 relative
and its parameters within 1e-5 (tests/test_seqpar.py's). The JAX
``sp_loss`` and ``Trainer`` cases run once each (a ``shard_map``
compile each); the rest hold the port to the offline JAX model.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.models.layers import BN_MOMENTUM
from deepspeech_tpu.ops.ctc import ctc_loss_ref as jax_ctc_loss_ref
from deepspeech_tpu.parallel import make_mesh as jax_make_mesh
from deepspeech_tpu.parallel import seqpar as jax_seqpar
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.parallel import seqpar
from deepspeech_tpu_torch.train import Trainer
from test_seqpar import _setup as jax_setup
from test_torch_seqpar import CPU8, _over

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 5e-4
STATS_ATOL = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return jax_make_mesh((8, 1))


def _labels(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 16, size=(2, 12)).astype(np.int32),
            np.array([12, 7], np.int32))


def _setup(jcfg, seed):
    """tests/test_seqpar.py's init (running statistics perturbed) and
    features, as numpy: (variables, features, lengths)."""
    _, variables, feats, lens = jax_setup(jcfg, seed=seed)
    return (jax.tree.map(np.array, variables), np.array(feats),
            np.array(lens))


def _port(tcfg, variables, feats, lens, labels, label_lens,
          devices=CPU8):
    """The port's ``sp_loss`` on a train-mode model holding
    ``variables``: (loss, gradients and raw BN statistics as flax
    trees)."""
    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(bridge.from_flax(variables["params"],
                                           variables["batch_stats"]))
    model.train()
    loss, stats = seqpar.sp_loss(
        tcfg.model, model, torch.from_numpy(feats), torch.from_numpy(lens),
        torch.from_numpy(labels), torch.from_numpy(label_lens), devices)
    loss.backward()
    grads, _ = bridge.to_flax({k: p.grad for k, p in
                               model.named_parameters()})
    _, raw = bridge.to_flax({f"{name}.{k}": v for name, (m, var) in
                             stats.items() for k, v in (("mean", m),
                                                        ("var", var))})
    return float(loss.detach()), grads, raw


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(got, ref, rtol, atol, scaled=False):
    """Each leaf within ``rtol`` and ``atol`` (times the leaf's largest
    magnitude, at least 1, when ``scaled``)."""
    got, ref = _flat(got), _flat(ref)
    assert sorted(got) == sorted(ref)
    for k in ref:
        scale = max(float(np.abs(ref[k]).max()), 1.0) if scaled else 1.0
        np.testing.assert_allclose(got[k], ref[k], err_msg=k, rtol=rtol,
                                   atol=atol * scale)


def _momentum(old, raw):
    return jax.tree.map(lambda o, b: BN_MOMENTUM * o + (1 - BN_MOMENTUM) * b,
                        old, raw)


def test_sp_loss_matches_jax_sp_loss(mesh):
    """JAX ``test_sp_loss_matches_offline_grads``'s case, port against
    JAX ``sp_loss`` under ``jax.value_and_grad`` on the (8, 1) mesh."""
    jcfg, tcfg = _over()
    variables, feats, lens = _setup(jcfg, 9)
    labels, label_lens = _labels(9)

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
def test_sp_loss_matches_jax_offline_train_step(bidirectional):
    """The port's ``sp_loss`` over eight shards against JAX's offline
    train-mode ``model.apply`` and the mean ``ctc_loss_ref``: the loss,
    the gradients and the BN statistics after the momentum."""
    jcfg, tcfg = _over(bidirectional=bidirectional)
    variables, feats, lens = _setup(jcfg, 11 + bidirectional)
    labels, label_lens = _labels(11)
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


def test_one_shard_is_the_offline_step_bit_for_bit():
    """Over one shard ``sp_loss`` is the port's offline train step: the
    same loss and gradients, and its statistics through
    ``MaskedBatchNorm.update`` the running ones the offline forward
    leaves, bit for bit (f32 on the CPU)."""
    from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean

    jcfg, tcfg = _over()
    variables, feats, lens = _setup(jcfg, 13)
    labels, label_lens = _labels(13)
    models = []
    for _ in range(2):
        m = DeepSpeech2(tcfg.model)
        m.load_state_dict(bridge.from_flax(variables["params"],
                                           variables["batch_stats"]))
        models.append(m.train())
    sp_model, model = models
    args = [torch.from_numpy(x) for x in (feats, lens, labels, label_lens)]
    loss, stats = seqpar.sp_loss(tcfg.model, sp_model, *args, CPU8[:1])
    loss.backward()
    for name, (mean, var) in stats.items():
        sp_model.get_submodule(name).update(mean, var)
    logits, clens = model(args[0], args[1])
    ref = ctc_loss_mean(logits, args[2], clens, args[3])
    ref.backward()
    assert torch.equal(loss, ref)
    for (name, p), (_, q) in zip(sp_model.named_parameters(),
                                 model.named_parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, b), (_, c) in zip(sp_model.named_buffers(),
                                 model.named_buffers()):
        assert torch.equal(b, c), name


class _Batches:
    """A pipeline of fixed global batches (the Trainer's duck type)."""

    def __init__(self, batches):
        self.batches = batches

    def peek(self):
        return self.batches[0]

    def epoch(self, e, start=0):
        return iter(self.batches[start:])

    def eval_epoch(self):
        return iter([(b, len(b["feat_lens"])) for b in self.batches])

    def batches_per_epoch(self, e):
        return len(self.batches)


def _trainer_configs(sp=True, **over):
    """tests/test_seqpar.py ``test_sp_trainer_step_matches_offline``'s
    config for both packages (the port's CTC is its kernels: no
    ``loss_impl``)."""
    import dataclasses as dc

    jcfg, tcfg = _over()
    jcfg = dc.replace(
        jcfg, data=dc.replace(jcfg.data, batch_size=2, bucket_frames=(256,),
                              max_label_len=8),
        train=dc.replace(jcfg.train, checkpoint_dir="", loss_impl="jnp",
                         sequence_parallel=sp))
    tcfg = apply_overrides(tcfg, {
        "data.batch_size": "2", "data.bucket_frames": "256",
        "data.max_label_len": "8", "train.checkpoint_dir": "",
        "train.sequence_parallel": str(sp).lower(), **over})
    return jcfg, tcfg


def test_trainer_step_matches_jax_sp_trainer(mesh):
    """One ``Trainer`` step with ``train.sequence_parallel=True`` over
    eight CPU shards against JAX's ``Trainer`` on the (8, 1) mesh, from
    JAX's init and on JAX's synthetic batch: the loss and every parameter
    after the optimizer step."""
    from deepspeech_tpu.data import CharTokenizer as JaxTokenizer
    from deepspeech_tpu.parallel import shard_batch
    from deepspeech_tpu.train import Trainer as JaxTrainer
    from deepspeech_tpu.train import _SyntheticPipeline
    from deepspeech_tpu.utils.logging import JsonlLogger

    jcfg, tcfg = _trainer_configs()
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


class _Quiet:
    def log(self, event, **fields):
        pass


def test_trainer_takes_the_sp_branch_and_the_guarded_step():
    """The port's Trainer with ``sequence_parallel`` over eight shards
    against the same Trainer without it (its offline step) on one batch:
    two steps each, plain and guarded, within the gradient bound; the
    guarded step stands and moves the BN running statistics."""
    _, tcfg = _trainer_configs(sp=False)
    _, scfg = _trainer_configs()
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(2, 256, 161)).astype(np.float32)
    feats[1, 199:] = 0.0
    labels, label_lens = _labels(3)
    batch = {"features": feats, "feat_lens": np.array([256, 199], np.int32),
             "labels": labels[:, :8], "label_lens": np.minimum(label_lens, 8)}
    runs = {}
    for name, cfg, guard in (("offline", tcfg, False), ("sp", scfg, False),
                             ("sp_guarded", scfg, True)):
        if guard:
            cfg = apply_overrides(cfg, {"train.guardian": "true"})
        tr = Trainer(cfg, _Batches([batch]), CharTokenizer.english(),
                     logger=_Quiet(), device="cpu", sp_devices=CPU8)
        assert (tr.sp_devices is None) == (name == "offline")
        before = {k: v.clone() for k, v in tr.model.named_buffers()}
        losses = []
        for _ in range(2):
            m = tr.train_step(batch)
            if guard:
                assert bool(m["applied"])
                tr.commit_step(True)
            losses.append(float(m["loss"]))
        assert all(not torch.equal(before[k], v) for k, v in
                   tr.model.named_buffers() if k.endswith(".mean"))
        runs[name] = (losses, bridge.to_flax(tr.model.state_dict()))
    for name in ("sp", "sp_guarded"):
        np.testing.assert_allclose(runs[name][0], runs["offline"][0],
                                   rtol=1e-5)
        for got, ref in zip(runs[name][1], runs["offline"][1]):
            _close(got, ref, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("case,over,exc,match", [
    ("bucket", {"data.bucket_frames": "250"}, ValueError, "divide"),
    ("accum", {"train.accum_steps": "2"}, ValueError, "accum_steps>1"),
    ("pipelined", {"model.pipeline_stages": "2"}, ValueError,
     "pipeline_stages>1"),
    # The id is the case's from when an LSTM model raised (item 14b-ii).
    pytest.param("lstm", {"model.rnn_type": "lstm"}, None, None,
                 id="lstm-over3-NotImplementedError-14b-ii"),
])
def test_trainer_refuses_what_jax_refuses(case, over, exc, match):
    """JAX's guards (``train.py:437-456``, tests/test_seqpar.py's
    ``divide``) with its messages. An LSTM model passes them, as in JAX:
    its SP Trainer takes a step over eight CPU shards with a finite
    loss."""
    _, tcfg = _trainer_configs(**over)
    if exc is None:
        tr = Trainer(tcfg, _Batches([{}]), CharTokenizer.english(),
                     logger=_Quiet(), device="cpu", sp_devices=CPU8)
        assert tr.sp_devices == CPU8 and tcfg.model.rnn_type == "lstm"
        rng = np.random.default_rng(4)
        labels, label_lens = _labels(4)
        batch = {"features": rng.normal(size=(2, 256, 161)).astype(
            np.float32), "feat_lens": np.array([256, 199], np.int32),
            "labels": labels[:, :8], "label_lens": np.minimum(label_lens, 8)}
        assert np.isfinite(float(tr.train_step(batch)["loss"]))
        return
    with pytest.raises(exc, match=match):
        Trainer(tcfg, _Batches([{}]), CharTokenizer.english(),
                logger=_Quiet(), device="cpu", sp_devices=CPU8)


def test_trainer_refuses_a_multi_rank_group(monkeypatch):
    from deepspeech_tpu_torch import train

    monkeypatch.setattr(train, "process_count", lambda: 2)
    _, tcfg = _trainer_configs()
    with pytest.raises(ValueError, match="single-process"):
        Trainer(tcfg, _Batches([{}]), CharTokenizer.english(),
                logger=_Quiet(), device="cpu", sp_devices=CPU8)


def test_sp_loss_refuses_lstm_and_lookahead():
    """An LSTM model trains sequence-parallel now (item 14b-ii): a finite
    loss and a nonzero gradient on every recurrent weight. A lookahead
    model is still refused, as JAX refuses it."""
    jcfg, tcfg = _over(rnn_type="lstm")
    variables, feats, lens = _setup(jcfg, 5)
    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(bridge.from_flax(variables["params"],
                                           variables["batch_stats"]))
    model.train()
    labels, label_lens = _labels(5)
    args = (torch.from_numpy(feats), torch.from_numpy(lens),
            torch.from_numpy(labels), torch.from_numpy(label_lens), CPU8)
    loss, _ = seqpar.sp_loss(tcfg.model, model, *args)
    loss.backward()
    assert np.isfinite(float(loss.detach()))
    for name, p in model.named_parameters():
        if ".wh_" in name:
            assert float(p.grad.abs().max()) > 0, name
    cfg = dataclasses.replace(tcfg.model, rnn_type="gru",
                              bidirectional=False, lookahead_context=8)
    with pytest.raises(ValueError, match="stream"):
        seqpar.sp_loss(cfg, DeepSpeech2(cfg), *args)
