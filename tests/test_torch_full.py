"""ds2_full (2 conv, 7 BiGRU layers) through the port against the JAX
package, at a shrunk width (H=32, 4 conv channels, f32), with the JAX
side forced onto its blocked Pallas GRU kernels (``_gru_kernel_blocked``
and ``_gru_bwd_kernel_blocked``, K8/K9, run per direction as
models/rnn.py:287 runs them when a BiGRU misses the budget) by setting
``rnn_pallas._VMEM_WEIGHT_BUDGET`` to 0 inside each test, as
tests/test_pallas.py does. The Pallas kernels run in interpret mode.

On the CPU the port runs its plain versions; chip_smoke.py holds the
streamed CUDA kernels to those on the card at the full width. Tolerances:
logits 1e-4 absolute; gradients and parameters after a step 1e-4
relative and absolute of each leaf's largest value, BN statistics 1e-5
(tests/test_torch_train.py's); greedy transcripts identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.decode.greedy import greedy_decode as jax_greedy_decode
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.ops import ctc_loss_mean as jax_ctc_loss_mean
from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, SyntheticPipeline
from deepspeech_tpu_torch.data.synthetic import synthetic_batch
from deepspeech_tpu_torch.decode.greedy import ids_to_texts
from deepspeech_tpu_torch.infer import Inferencer
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops.ctc import ctc_loss_mean
from deepspeech_tpu_torch.train import Trainer
from test_torch_model import random_flax_variables
from test_torch_train import _assert_trees_close, _jax_step

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

NARROW = {"model.rnn_hidden": "32", "model.conv_channels": "4,4",
          "model.dtype": "float32", "model.rnn_impl": "pallas",
          "data.batch_size": "4", "train.checkpoint_dir": "",
          "train.optimizer": "sgd", "train.learning_rate": "0.001",
          "train.warmup_steps": "2", "train.grad_clip_norm": "50"}


@pytest.fixture
def force_blocked(monkeypatch):
    monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    assert not rnn_pallas.bigru_fits_vmem(32, 4)
    assert rnn_pallas._use_blocked(32, jnp.float32)


def _setup(seed=0):
    """Configs, random flax variables from numpy and a ragged batch."""
    jcfg = jax_apply_overrides(jax_get_config("ds2_full"), NARROW)
    tcfg = apply_overrides(get_config("ds2_full"), NARROW)
    assert tcfg.model.rnn_layers == jcfg.model.rnn_layers == 7
    batch, _ = synthetic_batch(tcfg, 4, 48, 5, seed=seed, frames_per_label=6)
    batch["feat_lens"][1:] = [40, 31, 22]
    model = jax_create_model(jcfg.model)
    params, stats = random_flax_variables(
        model, jnp.asarray(batch["features"]),
        jnp.asarray(batch["feat_lens"]), np.random.default_rng(seed))
    return jcfg, tcfg, model, params, stats, batch


def test_logits_and_greedy_transcripts_match_jax(force_blocked):
    jcfg, tcfg, jmodel, params, stats, batch = _setup(1)
    # Spread the logits so no frame's argmax is a near tie.
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    ref, ref_lens = jax.jit(lambda v, x, n: jmodel.apply(v, x, n, False))(
        {"params": params, "batch_stats": stats},
        jnp.asarray(batch["features"]), jnp.asarray(batch["feat_lens"]))
    port = DeepSpeech2(tcfg.model)
    port.load_state_dict(bridge.from_flax(params, stats))
    with torch.no_grad():
        got, got_lens = port.eval()(torch.from_numpy(batch["features"]),
                                    torch.from_numpy(batch["feat_lens"])
                                    .long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    assert float(np.abs(got.numpy() - np.asarray(ref)).max()) < 1e-4

    tok = CharTokenizer.english()
    ref_texts = ids_to_texts(*jax_greedy_decode(ref, ref_lens), tok)
    inf = Inferencer(tcfg, tok, params, stats, device="cpu")
    texts = inf.decode_batch({"features": batch["features"],
                              "feat_lens": batch["feat_lens"]})
    assert texts == ref_texts and any(texts)


def test_gradients_bn_stats_and_one_sgd_step_match_jax(force_blocked):
    """One forward in train mode and one backward: every parameter's
    gradient and the updated BN statistics; then one SGD step through
    ``make_train_step`` on a one-device mesh against
    ``Trainer.train_step``: parameters, statistics, loss, gradient norm."""
    jcfg, tcfg, jmodel, params, stats, batch = _setup(2)
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
    logits, lens = port(tb["features"], tb["feat_lens"].long())
    loss = ctc_loss_mean(logits, tb["labels"], lens, tb["label_lens"])
    loss.backward()
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


def test_bridge_round_trips_the_seven_layer_tree():
    _, tcfg, _, params, stats, _ = _setup(3)
    assert sum(k.startswith("rnn") for k in params["rnn"]) == 7
    sd = bridge.from_flax(params, stats)
    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(sd)  # strict: every key maps, none left over
    back_p, back_s = bridge.to_flax(model.state_dict())
    for got, ref in ((back_p, params), (back_s, stats)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    init_p, init_s = bridge.init_params(tcfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(np.shape, init_p) == jax.tree.map(np.shape, params)
    assert jax.tree.map(np.shape, init_s) == jax.tree.map(np.shape, stats)


def test_full_width_tree_matches_jax_shapes():
    """At ds2_full's own width (H=1760) the port's modules hold the JAX
    package's tree leaf for leaf, conv kernels as OIHW: shapes only, the
    JAX tree from ``jax.eval_shape`` and the port's on the meta device,
    so nothing of the 1 GB of weights is made."""
    jcfg, tcfg = jax_get_config("ds2_full"), get_config("ds2_full")
    jmodel = jax_create_model(jcfg.model)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 161)),
        jnp.array([32]), train=False))
    want = {".".join(p.key for p in path): tuple(s.shape)
            for tree in (shapes["params"], shapes["batch_stats"])
            for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]}
    with torch.device("meta"):
        port = DeepSpeech2(tcfg.model)
    got = {}
    for key, t in port.state_dict().items():
        shape = tuple(t.shape)
        if key.startswith("conv.") and key.endswith(".weight"):
            key, shape = key[:-len("weight")] + "kernel", (
                shape[2], shape[3], shape[1], shape[0])
        got[key] = shape
    assert got == want
    h = 1760
    for i in range(7):
        assert got[f"rnn.rnn{i}.wh_fw"] == got[f"rnn.rnn{i}.wh_bw"] == \
            (h, 3 * h)
        assert got[f"rnn.rnn{i}.wx.kernel"][1] == 3 * h
