"""The port's weight-only int8 PTQ (``utils/quantize.py``), its serving
ladder (``serving/ladder.py``) and the bridge of a quantized tree,
against the JAX package's ``utils/quantize.py`` and ``serving/ladder.py``
on the same numpy trees.

Tolerances: the int8 values, the scales and the report must be equal,
as must the dequantized leaves (the same f32 product); the
quantization error, a float64 norm ratio, within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.serving import ladder as jax_ladder
from deepspeech_tpu.utils import quantize as jax_quantize
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops import gru
from deepspeech_tpu_torch.serving import ladder
from deepspeech_tpu_torch.utils import quantize
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

NARROW = {"model.rnn_hidden": "32", "model.conv_channels": "4,4",
          "model.dtype": "float32", "model.rnn_impl": "pallas"}
SMALL_CARD = (66, gru.H100_SMEM_PER_BLOCK, gru.H100_SMEM_PER_SM)


def _tree(preset="ds2_small", seed=0):
    """A JAX-model-shaped (params, batch_stats) tree of numpy arrays at a
    narrow width, plus a pipeline-stacked [L, d, C] recurrent leaf, a
    stacked wx_kernel and an all-zero kernel (scale 0 -> 1)."""
    jcfg = jax_apply_overrides(jax_get_config(preset), NARROW)
    rng = np.random.default_rng(seed)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((2, 40, 161)),
        jnp.array([40, 30]), rng)
    params = jax.tree.map(np.asarray, params)
    params["pipe"] = {
        "wh_fw": rng.normal(size=(3, 8, 24)).astype(np.float32),
        "wx_kernel": rng.normal(size=(3, 16, 24)).astype(np.float32),
        "zero": {"kernel": np.zeros((4, 6), np.float32)}}
    return params, stats


def _flat(tree):
    return {"/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming",
                                    "ds2_full"])
def test_quantize_params_is_bit_equal_to_jax(preset):
    params, _ = _tree(preset)
    calls = quantize.QUANTIZE_CALLS
    qtree, report = quantize.quantize_params(params)
    ref_q, ref_report = jax_quantize.quantize_params(params)
    assert quantize.QUANTIZE_CALLS == calls + 1
    assert report == ref_report
    got, ref = _flat(qtree), _flat(ref_q)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert qtree["pipe"]["wh_fw"]["scale"].shape == (3, 1, 24)
    assert qtree["pipe"]["wx_kernel"]["scale"].shape == (3, 1, 24)
    np.testing.assert_array_equal(qtree["pipe"]["zero"]["kernel"]["scale"],
                                  np.ones(6, np.float32))
    assert report["quantized"] == sum(k.endswith("/q") for k in got)


@pytest.mark.parametrize("keep", [False, True])
def test_dequantize_params_matches_jax(keep):
    params, _ = _tree(seed=1)
    qtree, _ = quantize.quantize_params(params)
    ref_q, _ = jax_quantize.quantize_params(params)
    pred = (lambda path: path.endswith(("wh_fw", "wh_bw"))) if keep else None
    got = _flat(quantize.dequantize_params(qtree, keep=pred))
    ref = _flat(jax_quantize.dequantize_params(ref_q, keep=pred))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    kept = [k for k in got if k.endswith("/q")]
    assert bool(kept) is keep
    assert all(k.split("/")[-2] in ("wh_fw", "wh_bw") for k in kept)


def test_quantization_error_matches_jax():
    params, _ = _tree(seed=2)
    qtree, _ = quantize.quantize_params(params)
    ref_q, _ = jax_quantize.quantize_params(params)
    err = quantize.quantization_error(params, qtree)
    assert 0 < err < 0.02
    assert abs(err - jax_quantize.quantization_error(params, ref_q)) < 1e-6


@pytest.mark.parametrize("x,want", [
    ({"q": 1, "scale": 2}, True), ({"q": 1}, False),
    ({"q": 1, "scale": 2, "x": 3}, False), (np.zeros(3), False),
    ([1, 2], False)])
def test_is_qleaf_matches_jax(x, want):
    assert quantize.is_qleaf(x) is jax_quantize.is_qleaf(x) is want


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_streaming",
                                    "ds2_full"])
def test_regime_of_the_presets_on_an_h100(preset):
    """Every preset's int8 recurrence is resident on an H100 (K10), as
    it is on the TPU by ``fits_vmem(h, 1)``; unquantized it is "fp"; the
    keep predicate threads exactly the recurrent matrices."""
    m = get_config(preset).model
    assert quantize.kernel_regime(m, True) == "resident-q"
    assert quantize.kernel_regime(m, True, streaming=True) == "resident-q"
    assert quantize.kernel_regime(m, False) == "fp"
    jm = jax_apply_overrides(jax_get_config(preset),
                             {"model.rnn_impl": "pallas"}).model
    assert jax_quantize.kernel_regime(jm, True) == "resident-q"
    keep = quantize.keep_recurrent_q(m)
    jkeep = jax_quantize.keep_recurrent_q(jm)
    for path in ("rnn/rnn0/wh_fw", "rnn/rnn6/wh_bw", "rnn/rnn0/wx/kernel",
                 "head/kernel", "conv/conv0/kernel"):
        assert keep(path) == jkeep(path) == path.endswith(("wh_fw",
                                                           "wh_bw"))


def test_regime_reads_the_card():
    """On a card with half an H100's SMs ds2_full's 220 int8 blocks (two
    an SM) are not all resident: the batch path streams (K11) and the
    carried-state path, resident-only as in the JAX package, stays
    unquantized; ds2_small's 100 blocks still fit."""
    full = get_config("ds2_full").model
    assert quantize.kernel_regime(full, True, card=SMALL_CARD) == "blocked-q"
    assert quantize.kernel_regime(full, True, streaming=True,
                                  card=SMALL_CARD) == "fp"
    assert quantize.keep_recurrent_q(full, streaming=True,
                                     card=SMALL_CARD) is None
    small = get_config("ds2_small").model
    assert quantize.kernel_regime(small, True, card=SMALL_CARD) == \
        "resident-q"
    # The LSTM (four gates) reads the card by its own kernel's rule:
    # ds2_small's 100 int8 blocks, two an SM, fit half an H100 too.
    lstm = apply_overrides(get_config("ds2_small"),
                           {"model.rnn_type": "lstm"}).model
    assert quantize.kernel_regime(lstm, True) == "resident-q"
    assert quantize.kernel_regime(lstm, True, card=(49,) + SMALL_CARD[1:]) \
        == "blocked-q"


# ---------------------------------------------------------------------------
# serving/ladder.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_bytes", [0, 1000, 278_000_000,
                                         864_000_000])
@pytest.mark.parametrize("per_row", [1, 7, 3_000_000])
@pytest.mark.parametrize("ceiling", [1, 32, 1024])
def test_max_batch_for_budget_matches_jax(param_bytes, per_row, ceiling):
    for budget in (0, 500, 10_000, 300_000_000, 2_000_000_000):
        assert ladder.max_batch_for_budget(
            param_bytes, per_row, budget, ceiling=ceiling) == \
            jax_ladder.max_batch_for_budget(param_bytes, per_row, budget,
                                            ceiling=ceiling)


def test_ladder_errors_and_tiers_match_jax():
    for args in ((-1, 1, 10), (0, 0, 10)):
        with pytest.raises(ValueError):
            ladder.max_batch_for_budget(*args)
        with pytest.raises(ValueError):
            jax_ladder.max_batch_for_budget(*args)
    report = {"bytes_before": 864_000_000, "bytes_after": 278_000_000}
    for budget in (900_000_000, 2_000_000_000, 16_000_000_000):
        for stream in (None, {"premium": 37_171_200, "bulk": 0}):
            kw = dict(ceiling=256, stream_bytes=stream)
            assert ladder.tier_max_batches(report, 3_000_000, budget,
                                           **kw) == \
                jax_ladder.tier_max_batches(report, 3_000_000, budget, **kw)


@pytest.mark.parametrize("h,wb,d,same", [
    (800, 2, 2, True),     # ds2_small bf16: resident on both
    (1760, 2, 2, True),    # ds2_full bf16: streamed on both
    (1760, 1, 2, True),    # ds2_full int8: resident on both
    (1888, 1, 2, False),   # int8 past the TPU's 1-byte budget, fits here
    (1280, 2, 2, False),   # bf16 inside the TPU budget, 160 groups here
    (1536, 2, 1, False),   # bf16 past the TPU budget, 96 groups fit here
])
def test_recurrent_stream_bytes_follows_the_hopper_rule(h, wb, d, same):
    """0 where the port's resident kernel holds the matrices, the stored
    width otherwise; ``same`` says whether the TPU's ``fits_vmem`` gives
    the same answer (the JAX ladder prices residency per matrix against
    10 MB of VMEM, the port per grid against the card)."""
    kind = "fwd_q" if wb == 1 else "fwd"
    dtype = torch.bfloat16 if wb == 2 else torch.float32
    resident = gru.resident_fits(kind, d, h, 32, dtype)
    got = ladder.recurrent_stream_bytes(h, 3, wb, layers=7, directions=d)
    assert got == (0 if resident else 3 * h * h * wb * 7 * d)
    ref = jax_ladder.recurrent_stream_bytes(h, 3, wb, layers=7,
                                            directions=d)
    assert (got == ref) is same
    assert ladder.recurrent_stream_bytes(
        h, 3, wb, layers=7, directions=d,
        card=(1, gru.H100_SMEM_PER_BLOCK, gru.H100_SMEM_PER_SM)) == \
        3 * h * h * wb * 7 * d
    # Four gates (the LSTM) price by the LSTM kernels' own rule.
    lstm_kind = "lstm_fwd_q" if wb == 1 else "lstm_fwd"
    lstm_resident = gru.resident_fits(lstm_kind, d, h, 1, dtype)
    assert ladder.recurrent_stream_bytes(h, 4, wb, layers=7,
                                         directions=d) == \
        (0 if lstm_resident else 4 * h * h * wb * 7 * d)
    with pytest.raises(ValueError):
        ladder.recurrent_stream_bytes(h, 5, wb)
    with pytest.raises(ValueError):
        ladder.recurrent_stream_bytes(h, 3, 3)


# ---------------------------------------------------------------------------
# The bridge of a quantized tree.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("preset", ["ds2_small", "ds2_full"])
def test_bridge_round_trips_a_qtree(preset):
    """A qtree loads strictly into the quantized model: int8 ``.q`` and
    f32 ``.scale`` entries, the conv ``q`` as OIHW with its scale per
    output channel, so the dequantized conv weight is the JAX one
    transposed; ``to_flax`` gives the qtree back exactly."""
    params, stats = _tree(preset, seed=3)
    del params["pipe"]
    qtree, _ = quantize.quantize_params(params)
    sd = bridge.from_flax(qtree, stats)
    tcfg = apply_overrides(get_config(preset), NARROW)
    model = DeepSpeech2(tcfg.model, quantized=True)
    model.load_state_dict(sd)
    conv_q = qtree["conv"]["conv0"]["kernel"]
    w = model.conv.conv0.weight
    assert w.q.dtype == torch.int8 and w.scale.dtype == torch.float32
    assert tuple(w.q.shape) == conv_q["q"].transpose(3, 2, 0, 1).shape
    deq = conv_q["q"].astype(np.float32) * conv_q["scale"]
    np.testing.assert_array_equal(w.dequantize().numpy(),
                                  deq.transpose(3, 2, 0, 1))
    rnn0 = model.rnn.rnn0
    np.testing.assert_array_equal(rnn0.wh_fw.q.numpy(),
                                  qtree["rnn"]["rnn0"]["wh_fw"]["q"])
    back_p, back_s = bridge.to_flax(model.state_dict())
    for got, ref in ((back_p, qtree), (back_s, stats)):
        g, r = _flat(got), _flat(ref)
        assert g.keys() == r.keys()
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
