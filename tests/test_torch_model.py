"""DeepSpeech2 logits of the port against the JAX package's, from the
same weights through the bridge, for ds2_small (BiGRU, the fused
two-direction kernel) and ds2_streaming (uni-GRU + lookahead), shrunk
to H=32 and 2 layers. The JAX side runs its Pallas GRU kernels in
interpret mode (rnn_impl="pallas"). Tolerances: 1e-4 absolute in
float32; 5e-2 of the largest logit in bf16, where the two frameworks
round activations at different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu_torch.bridge import from_flax
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.models import DeepSpeech2

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

B, T = 3, 40
SMALL = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
         "model.conv_channels": "4,4", "model.rnn_impl": "pallas"}


def random_flax_variables(model, feats, lens, rng):
    """Flax ``(params, batch_stats)`` for ``model`` with random values
    from numpy: kernels ~ N(0, 1/fan_in), small biases, BN scales near
    1 and running statistics away from their init. The tree comes from
    ``jax.eval_shape``, so nothing is compiled to make it."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), feats, lens, train=False))

    def leaf(path, s):
        name = path[-1].key
        if name == "mean":
            v = rng.normal(size=s.shape) * 0.5
        elif name == "var":
            v = rng.uniform(0.5, 2.0, size=s.shape)
        elif name == "scale":
            v = rng.uniform(0.5, 1.5, size=s.shape)
        elif name == "bias" or name.startswith("bh_"):
            v = rng.normal(size=s.shape) * 0.1
        else:
            v = rng.normal(size=s.shape) / np.sqrt(np.prod(s.shape[:-1]))
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return dict(v["params"]), dict(v["batch_stats"])


def _model_inputs(preset, dtype, seed=0):
    over = dict(SMALL, **{"model.dtype": dtype})
    jcfg = jax_apply_overrides(jax_get_config(preset), over)
    tcfg = apply_overrides(get_config(preset), over)
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, T, 161)).astype(np.float32)
    lens = np.array([T, 31, 17], np.int32)
    model = jax_create_model(jcfg.model)
    params, stats = random_flax_variables(model, jnp.asarray(feats),
                                      jnp.asarray(lens), rng)
    return jcfg, tcfg, model, params, stats, feats, lens


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_logits_match_jax(preset, dtype):
    jcfg, tcfg, jmodel, params, stats, feats, lens = _model_inputs(
        preset, dtype)
    ref, ref_lens = jax.jit(lambda v, x, n: jmodel.apply(v, x, n, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(feats),
        jnp.asarray(lens))
    ref = np.asarray(ref)

    model = DeepSpeech2(tcfg.model, tcfg.features.num_features)
    model.load_state_dict(from_flax(params, stats))
    model.eval()
    with torch.no_grad():
        got, got_lens = model(torch.from_numpy(feats),
                              torch.from_numpy(lens).long())
    assert got.dtype == torch.float32
    assert got.shape == ref.shape == (B, T // 2, 29)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    err = float(np.abs(got.numpy() - ref).max())
    if dtype == "float32":
        assert err < 1e-4, err
    else:
        assert err / float(np.abs(ref).max()) < 5e-2, err


@pytest.mark.parametrize("preset,reverse", [
    ("ds2_small", (False, True)), ("ds2_streaming", (False,))])
@pytest.mark.parametrize("impl", ["auto", "pallas"])
def test_every_layer_calls_gru_fwd_once(preset, reverse, impl, monkeypatch):
    """Each GRU layer makes one gru_fwd call holding all its directions,
    whichever accepted rnn_impl name the config carries: a bidirectional
    layer (False, True), a streaming layer (False,)."""
    import deepspeech_tpu_torch.ops.gru as gru_mod
    _, tcfg, _, params, stats, feats, lens = _model_inputs(
        preset, "float32", seed=1)
    calls = []

    def recording(xp, mask, w, b, h0, reverse):
        calls.append((tuple(w.shape), h0, tuple(reverse)))
        return gru_mod.gru_fwd_plain(xp, mask, w, b, h0, reverse)

    monkeypatch.setattr(gru_mod, "gru_fwd", recording)
    cfg = apply_overrides(tcfg, {"model.rnn_impl": impl})
    model = DeepSpeech2(cfg.model)
    model.load_state_dict(from_flax(params, stats))
    with torch.no_grad():
        model.eval()(torch.from_numpy(feats), torch.from_numpy(lens).long())
    h = cfg.model.rnn_hidden
    assert calls == [((len(reverse), h, 3 * h), None, reverse)] * \
        cfg.model.rnn_layers


# The ids are the cases' names from when all four raised.
@pytest.mark.parametrize("over,exc", [
    ({"model.rnn_type": "lstm", "quantized": True}, RuntimeError),
    ({"model.pipeline_stages": "2"}, None),
    ({"model.rnn_impl": "cudnn"}, ValueError),
    ({"model.rnn_impl": "xla"}, ValueError),
], ids=["over0-RuntimeError", "over1-NotImplementedError",
        "over2-ValueError", "over3-ValueError"])
def test_unported_model_options_raise(over, exc):
    """What the port does not run raises, when the model is built or
    when it first runs a forward that may need a gradient: an int8 model
    (here an LSTM; ``quantized``) serves without one, as the JAX int8
    kernels have no VJP. A pipelined tree (``pipeline_stages=2``) once
    raised there too; with no pipe group it now runs JAX's sequential
    path, and a gradient reaches every stacked leaf."""
    over = dict(over)
    quantized = over.pop("quantized", False)
    cfg = apply_overrides(get_config("ds2_small"),
                          {"model.rnn_hidden": "8", **over}).model
    if exc is None:
        model = DeepSpeech2(cfg).train()
        logits, _ = model(torch.randn(2, 16, 161), torch.tensor([16, 12]))
        assert torch.isfinite(logits).all()
        logits.square().mean().backward()
        for name, p in model.rnn_pipe.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
        return
    with pytest.raises(exc):
        DeepSpeech2(cfg, quantized=quantized)(torch.zeros(1, 16, 161),
                                              torch.tensor([16]))
