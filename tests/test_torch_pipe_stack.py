"""A tree stacked for pipeline stages (``model.pipeline_stages > 1``:
``rnn0`` and ``rnn_pipe/{wx_kernel, ...}`` ``[L-1, ...]``) in the port:
its names and shapes against the JAX package's ``create_model``, its
eval forward (``models/pipe_stack.py``'s sequential path) against JAX
``model.apply`` with no mesh (the path a pipeline-trained checkpoint is
served on, JAX pipe_stack.py:247-251), within 1e-5 in float32; the bridge,
``params.npz`` and an orbax step the JAX package's manager wrote; the
``Inferencer``'s greedy texts and its int8 regime against JAX's; the
training guards (a pipelined tree trains on a mesh with a pipe axis,
``tests/test_torch_pipeline.py``), and the sequential path under a
gradient, the standard tree's step bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.utils.quantize import kernel_regime as jax_kernel_regime
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.infer import Inferencer
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.data import SyntheticPipeline
from deepspeech_tpu_torch.train import Trainer, check_supported
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

TOL = 1e-5


def _cfgs(**model_kw):
    """tests/test_pipeline_pp.py's model: dev_slice at 3 layers of 32
    units (layers 1-2 stacked), 4+4 conv channels, V=16, float32, two
    stages of two microbatches."""
    base = {"rnn_layers": 3, "rnn_hidden": 32, "conv_channels": (4, 4),
            "vocab_size": 16, "dtype": "float32", "pipeline_stages": 2,
            "pipeline_microbatches": 2, **model_kw}
    jcfg = jax_get_config("dev_slice")
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               **base))
    tcfg = apply_overrides(get_config("dev_slice"), {
        f"model.{k}": ",".join(map(str, v)) if isinstance(v, tuple)
        else str(v).lower() if isinstance(v, bool) else str(v)
        for k, v in base.items()})
    return jcfg, tcfg


def _inputs(b=4, t=64, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 161)).astype(np.float32)
    lens = rng.integers(t // 2, t + 1, size=b).astype(np.int32)
    lens[0] = t
    return feats, lens


def _variables(jcfg, feats, lens, seed=0):
    return random_flax_variables(jax_create_model(jcfg.model),
                                 jnp.asarray(feats[:1]),
                                 jnp.asarray(lens[:1]),
                                 np.random.default_rng(seed))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.mark.parametrize("over", [{}, {"bidirectional": False},
                                  {"rnn_type": "lstm"},
                                  {"rnn_batch_norm": False}],
                         ids=["bigru", "gru", "lstm", "no_bn"])
def test_stacked_tree_names_and_shapes_equal_jax(over):
    """The port's init (``bridge.init_params``) has JAX ``create_model``'s
    leaves, names and shapes (tests/test_pipeline_pp.py:55-65), its
    stacked ``wh_*`` orthogonal layer by layer."""
    jcfg, tcfg = _cfgs(**over)
    feats, lens = _inputs(b=1)
    shapes = jax.eval_shape(lambda: jax_create_model(jcfg.model).init(
        jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(lens),
        train=False))
    params, stats = bridge.init_params(tcfg, torch.Generator().manual_seed(0))
    for got, want in ((params, shapes["params"]),
                      (stats, shapes.get("batch_stats", {}))):
        got, want = _flat(got), _flat(jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), dict(want)))
        assert {k: v.shape for k, v in got.items()} == \
            {k: v.shape for k, v in want.items()}
    h = tcfg.model.rnn_hidden
    for key in ("wh_fw", "wh_bw"):
        for w in params["rnn_pipe"].get(key, ()):
            np.testing.assert_allclose(w @ w.T, np.eye(h), atol=1e-5)
    if tcfg.model.rnn_batch_norm:
        np.testing.assert_array_equal(params["rnn_pipe"]["bn_scale"], 1.0)
        np.testing.assert_array_equal(stats["rnn_pipe"]["var"], 1.0)


@pytest.mark.parametrize("over", [{}, {"rnn_batch_norm": False},
                                  {"rnn_type": "lstm"},
                                  {"bidirectional": False}],
                         ids=["bn", "no_bn", "lstm", "unidirectional"])
def test_eval_logits_equal_jax_sequential_path(over):
    jcfg, tcfg = _cfgs(**over)
    feats, lens = _inputs(seed=1)
    params, stats = _variables(jcfg, feats, lens, seed=1)
    ref, ref_lens = jax_create_model(jcfg.model).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(feats),
        jnp.asarray(lens), train=False)
    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(bridge.from_flax(params, stats))
    with torch.no_grad():
        got, got_lens = model.eval()(torch.from_numpy(feats),
                                     torch.from_numpy(lens).long())
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


def _unstacked(params, stats, layers):
    """The pipelined tree as the standard one with the same weights."""
    pipe, pstats = params["rnn_pipe"], stats.get("rnn_pipe", {})
    rnn = {"rnn0": params["rnn0"]}
    rstats = {"rnn0": stats["rnn0"]} if "rnn0" in stats else {}
    for i in range(1, layers):
        layer = {"wx": {"kernel": pipe["wx_kernel"][i - 1],
                        "bias": pipe["wx_bias"][i - 1]}}
        for k in ("wh_fw", "bh_fw", "wh_bw", "bh_bw"):
            if k in pipe:
                layer[k] = pipe[k][i - 1]
        if "bn_scale" in pipe:
            layer["bn"] = {"scale": pipe["bn_scale"][i - 1],
                           "bias": pipe["bn_bias"][i - 1]}
            rstats[f"rnn{i}"] = {"bn": {k: pstats[k][i - 1]
                                        for k in ("mean", "var")}}
        rnn[f"rnn{i}"] = layer
    p = {k: v for k, v in params.items() if k not in ("rnn0", "rnn_pipe")}
    s = {k: v for k, v in stats.items() if k not in ("rnn0", "rnn_pipe")}
    p["rnn"] = rnn
    if rstats:
        s["rnn"] = rstats
    return p, s


@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_pipelined_equals_the_standard_tree_bit_for_bit(rnn_type):
    """The same weights stacked and unstacked run the same calls on the
    same inputs: equal logits, bit for bit (chip_smoke.py holds the same
    on the card at ds2_full's width)."""
    jcfg, tcfg = _cfgs(rnn_type=rnn_type)
    feats, lens = _inputs(seed=2)
    params, stats = _variables(jcfg, feats, lens, seed=2)
    std = apply_overrides(tcfg, {"model.pipeline_stages": "1"})
    out = []
    for cfg, (p, s) in ((tcfg, (params, stats)),
                        (std, _unstacked(params, stats, 3))):
        model = DeepSpeech2(cfg.model)
        model.load_state_dict(bridge.from_flax(p, s))
        with torch.no_grad():
            out.append(model.eval()(torch.from_numpy(feats),
                                    torch.from_numpy(lens).long())[0])
    assert torch.equal(out[0], out[1])


def test_bridge_npz_and_an_orbax_step_round_trip(tmp_path):
    """``from_flax``/``to_flax``, ``save_npz``/``load_npz`` and the port's
    checkpoint manager give the stacked leaves back bit for bit, and
    ``import_orbax_step`` reads them from an orbax step the JAX package's
    manager wrote."""
    from deepspeech_tpu.checkpoint import CheckpointManager as JaxManager
    from deepspeech_tpu_torch.checkpoint import CheckpointManager
    from deepspeech_tpu_torch.checkpoint_import import import_orbax_step

    jcfg, tcfg = _cfgs()
    feats, lens = _inputs(b=1, seed=3)
    params, stats = _variables(jcfg, feats, lens, seed=3)
    want = _flat({"params": params, "batch_stats": stats})

    def same(p, s):
        got = _flat({"params": p, "batch_stats": s})
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want)

    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(bridge.from_flax(params, stats))
    same(*bridge.to_flax(model.state_dict()))
    bridge.save_npz(str(tmp_path / "p.npz"), params, stats)
    same(*bridge.load_npz(str(tmp_path / "p.npz")))
    mgr = CheckpointManager(str(tmp_path / "port"))
    mgr.save(1, {"params": params, "batch_stats": stats})
    mgr.wait()
    raw = mgr.restore()
    same(raw["params"], raw["batch_stats"])
    jmgr = JaxManager(str(tmp_path / "jax"))
    jmgr.save(3, {"state": {"step": jnp.asarray(3, jnp.int32),
                            "params": jax.tree.map(jnp.asarray, params),
                            "batch_stats": jax.tree.map(jnp.asarray,
                                                        stats)},
                  "epoch": 1})
    jmgr.wait()
    jmgr.close()
    p, s, step, epoch = import_orbax_step(str(tmp_path / "jax"))
    assert (step, epoch) == (3, 1)
    same(p, s)


@pytest.mark.parametrize("quantize", ["", "int8"])
def test_inferencer_on_a_pipelined_tree_equals_jax(quantize):
    """Greedy texts of the port's and the JAX Inferencer on one pipelined
    tree; with int8 both report the "fp" regime (keep_recurrent_q is
    None for a pipelined tree: every leaf is dequantized at init, the
    int8 values JAX dequantizes at the forward's entry)."""
    over = {"vocab_size": 29}
    jcfg, tcfg = _cfgs(**over)
    feats, lens = _inputs(seed=4)
    params, stats = _variables(jcfg, feats, lens, seed=4)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    batch = {"features": feats, "feat_lens": lens}
    ref = JaxInferencer(jcfg, JaxCharTokenizer.english(), params, stats,
                        quantize=quantize)
    got = Inferencer(tcfg, CharTokenizer.english(), params, stats,
                     device="cpu", quantize=quantize)
    assert got.decode_batch(batch) == ref.decode_batch(batch)
    if quantize:
        assert got.kernel_regime == ref.kernel_regime == "fp"
        assert jax_kernel_regime(jcfg.model, True) == "fp"
        assert got.quantize_calls == 1
        assert not any(t.dtype == torch.int8
                       for t in got.model.state_dict().values())
    lp_ref, _ = ref._forward(ref.params, ref.batch_stats,
                             jnp.asarray(feats), jnp.asarray(lens))
    lp, _ = got.forward(feats, lens)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), atol=TOL,
                               rtol=TOL)


# The ids are the cases' names from when both raised naming items 14c
# and 14b. Since item 14c a pipelined GRU or LSTM model trains on a mesh
# with a pipe axis: ``check_supported`` passes, and a ``Trainer`` on a
# mesh without one raises JAX's ``ValueError`` naming the pipe axis.
@pytest.mark.parametrize("over,match", [
    pytest.param({"model.pipeline_stages": "2"}, "pipe",
                 id="over0-item 14c"),
    pytest.param({"model.pipeline_stages": "2", "model.rnn_type": "lstm"},
                 "pipe", id="over1-item 14b")])
def test_training_refusals_name_their_items(over, match):
    cfg = apply_overrides(get_config("ds2_small"),
                          {"train.checkpoint_dir": "", **over})
    check_supported(cfg)
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, SyntheticPipeline(cfg, 1), CharTokenizer.english(),
                device="cpu")


def _check_sequential_step(rnn_type, dtype):
    """One train-mode forward and backward of a pipelined tree with no
    pipe group against the standard tree with the same weights."""
    jcfg, tcfg = _cfgs(rnn_type=rnn_type, dtype=dtype)
    feats, lens = _inputs(seed=5)
    params, stats = _variables(jcfg, feats, lens, seed=5)
    std = apply_overrides(tcfg, {"model.pipeline_stages": "1"})
    out = []
    for cfg, (p, s) in ((tcfg, (params, stats)),
                        (std, _unstacked(params, stats, 3))):
        model = DeepSpeech2(cfg.model)
        model.load_state_dict(bridge.from_flax(p, s))
        model.train()
        logits, _ = model(torch.from_numpy(feats),
                          torch.from_numpy(lens).long())
        logits.square().mean().backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        out.append((logits.detach(), bridge.to_flax(grads)[0],
                    bridge.to_flax(model.state_dict())[1]))
    (got, got_g, got_s), (ref, ref_g, ref_s) = out
    assert torch.equal(got, ref)
    # The pipelined tree's gradients and statistics, unstacked.
    for mine, want in ((_unstacked(got_g, got_s, 3)[0], ref_g),
                       (_unstacked(params, got_s, 3)[1], ref_s)):
        mine, want = _flat(mine), _flat(want)
        assert mine.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(mine[k], want[k], err_msg=k)


def test_a_pipelined_forward_that_may_need_a_gradient_raises():
    """A pipelined forward that may need a gradient once raised; with no
    pipe group it is now JAX's sequential oracle (pipe_stack.py:247-251):
    in train mode the standard tree holding the same weights unstacked
    gives its logits, gradients and BN statistics bit for bit, GRU and
    LSTM, f32 and bf16 (where the gradients of a BN's statistics and of
    its arithmetic must add in f32 before the cast, as in
    ``MaskedBatchNorm``). An int8 pipelined tree is still refused (JAX
    quantizes it as fp)."""
    for rnn_type, dtype in (("gru", "float32"), ("lstm", "float32"),
                            ("gru", "bfloat16"), ("lstm", "bfloat16")):
        _check_sequential_step(rnn_type, dtype)
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="full precision"):
        DeepSpeech2(tcfg.model, quantized=True)
    with pytest.raises(ValueError, match="must divide"):
        DeepSpeech2(apply_overrides(tcfg, {"model.rnn_layers": "4"}).model)
