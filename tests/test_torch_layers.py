"""The port's masked batch-norm and conv frontend against the JAX
package's, on the same numpy inputs and bridged weights (float32)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models.conv import ConvFrontend as JaxConvFrontend
from deepspeech_tpu.models.conv import conv_out_lens as jax_conv_out_lens
from deepspeech_tpu.models.layers import MaskedBatchNorm as JaxBN
from deepspeech_tpu_torch.bridge import from_flax
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.models.conv import ConvFrontend, conv_out_lens
from deepspeech_tpu_torch.models.layers import MaskedBatchNorm

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

TOL = 1e-5


def _bn_vars(rng, c):
    return ({"scale": rng.normal(size=c).astype(np.float32),
             "bias": rng.normal(size=c).astype(np.float32)},
            {"mean": rng.normal(size=c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, size=c).astype(np.float32)})


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("extra_axis", [False, True])
def test_masked_batchnorm_matches_jax(train, extra_axis):
    rng = np.random.default_rng(0)
    c = 6
    shape = (3, 10, 4, c) if extra_axis else (3, 10, c)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    mask = (np.arange(10)[None] < np.array([10, 4, 7])[:, None]
            ).astype(np.float32)
    params, stats = _bn_vars(rng, c)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, upd = JaxBN().apply(variables, jnp.asarray(x),
                                 jnp.asarray(mask), True,
                                 mutable=["batch_stats"])
        ref_stats = upd["batch_stats"]
    else:
        ref = JaxBN().apply(variables, jnp.asarray(x), jnp.asarray(mask),
                            False)
        ref_stats = stats
    bn = MaskedBatchNorm(c)
    bn.load_state_dict(from_flax(params, stats))
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(ref_stats[k]), atol=TOL,
                                   rtol=TOL)


def _frontend_cfgs():
    over = dict(conv_channels=(4, 5), dtype="float32")
    return (dataclasses.replace(jax_get_config("ds2_small").model, **over),
            dataclasses.replace(get_config("ds2_small").model, **over))


@pytest.mark.parametrize("t,train", [(33, False), (34, True)])
def test_conv_frontend_matches_jax(t, train):
    """Odd and even T: the explicit asymmetric time padding keeps the
    sampling grid, and F 161 -> 81 -> 41 with channel-fastest flatten."""
    jcfg, tcfg = _frontend_cfgs()
    rng = np.random.default_rng(t)
    x = rng.normal(size=(3, t, 161)).astype(np.float32)
    lens = np.array([t, t - 5, 9], np.int32)
    variables = JaxConvFrontend(jcfg).init(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(lens), False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = {f"bn{i}": _bn_vars(rng, ch)[1]
             for i, ch in enumerate(jcfg.conv_channels)}
    variables = {"params": params, "batch_stats": stats}
    if train:
        (ref, ref_lens), _ = JaxConvFrontend(jcfg).apply(
            variables, jnp.asarray(x), jnp.asarray(lens), True,
            mutable=["batch_stats"])
    else:
        ref, ref_lens = JaxConvFrontend(jcfg).apply(
            variables, jnp.asarray(x), jnp.asarray(lens), False)

    front = ConvFrontend(tcfg)
    sd = from_flax({"conv": params}, {"conv": stats})
    front.load_state_dict({k[len("conv."):]: v for k, v in sd.items()})
    front.train(train)
    with torch.no_grad():
        got, got_lens = front(torch.from_numpy(x),
                              torch.from_numpy(lens).long())
    assert got.shape == ref.shape == (3, -(-t // 2), 41 * 5)
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(ref_lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("n", [1, 2, 33, 34, 1700])
def test_conv_out_lens_matches_jax(n):
    jcfg, tcfg = _frontend_cfgs()
    lens = np.array([n, max(n - 1, 1)])
    np.testing.assert_array_equal(
        conv_out_lens(torch.from_numpy(lens), tcfg).numpy(),
        np.asarray(jax_conv_out_lens(jnp.asarray(lens), jcfg)))
