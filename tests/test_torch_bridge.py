"""Weight bridge: flax trees <-> the port's state_dict."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.models import DeepSpeech2
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

OVER = {"model.rnn_hidden": "24", "model.rnn_layers": "2",
        "model.conv_channels": "3,5"}


def _jax_vars(preset):
    cfg = jax_apply_overrides(jax_get_config(preset), OVER)
    return random_flax_variables(jax_create_model(cfg.model),
                             jnp.zeros((2, 16, 161)), jnp.array([16, 9]),
                             np.random.default_rng(0))


def _assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming"])
def test_round_trip_is_exact(preset):
    params, stats = _jax_vars(preset)
    sd = bridge.from_flax(params, stats)
    model = DeepSpeech2(apply_overrides(get_config(preset), OVER).model)
    model.load_state_dict(sd)  # strict: every key maps, none left over
    assert sd["conv.conv0.weight"].shape == (3, 1, 11, 41)  # OIHW
    back = bridge.to_flax(model.state_dict())
    _assert_same_tree(back[0], params)
    _assert_same_tree(back[1], stats)


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming"])
def test_init_params_has_the_flax_layout(preset, tmp_path):
    cfg = apply_overrides(get_config(preset), OVER)
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(3))
    ref_p, ref_s = _jax_vars(preset)
    assert (jax.tree.map(np.shape, params) == jax.tree.map(np.shape, ref_p))
    assert (jax.tree.map(np.shape, stats) == jax.tree.map(np.shape, ref_s))
    again = bridge.init_params(cfg, torch.Generator().manual_seed(3))
    _assert_same_tree(again[0], params)
    path = str(tmp_path / "w.npz")
    bridge.save_npz(path, params, stats)
    loaded = bridge.load_npz(path)
    _assert_same_tree(loaded[0], params)
    _assert_same_tree(loaded[1], stats)
