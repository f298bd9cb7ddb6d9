"""Int8 serving: the port's ``Inferencer(quantize="int8")`` against the
JAX package's, on the same numpy weights, with the JAX side on its
Pallas int8 GRU kernels in interpret mode (``model.rnn_impl="pallas"``:
``gru_scan_pallas_q``, resident ``_gru_kernel_q``, or blocked
``_gru_kernel_blocked_q`` with ``rnn_pallas._VMEM_WEIGHT_BUDGET`` set to
0 inside the test). Models: ds2_small-shaped (3 BiGRU), ds2_streaming
decoded offline (5 uni-GRU + lookahead) and ds2_full-shaped (7 BiGRU),
at H=32 with 4 conv channels.

Tolerances: log-probs 1e-4 absolute in f32 and identical greedy
transcripts; in bf16, a smoke, 3e-2 of the largest log-prob magnitude
(the frameworks round activations at different places).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.infer import Inferencer as JaxInferencer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.ops import rnn_pallas
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.infer import Inferencer, main
from test_torch_infer import _request
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

OVER = {"model.rnn_hidden": "32", "model.conv_channels": "4,4",
        "model.dtype": "float32", "model.rnn_impl": "pallas",
        "data.batch_size": "2", "data.bucket_frames": "24,40"}
LAYERS = {"ds2_small": 3, "ds2_streaming": 5, "ds2_full": 7}


def _engines(preset, dtype="float32", seed=4):
    over = dict(OVER, **{"model.dtype": dtype})
    jcfg = jax_apply_overrides(jax_get_config(preset), over)
    tcfg = apply_overrides(get_config(preset), over)
    assert tcfg.model.rnn_layers == LAYERS[preset]
    batch = _request(tcfg)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(batch["features"]),
        jnp.asarray(batch["feat_lens"]), np.random.default_rng(seed))
    params = jax.tree.map(np.asarray, params)
    # Spread the logits so no frame's argmax is a near tie.
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    ref = JaxInferencer(jcfg, JaxCharTokenizer.english(), params, stats,
                        quantize="int8")
    inf = Inferencer(tcfg, CharTokenizer.english(), params, stats,
                     device="cpu", quantize="int8")
    return ref, inf, batch


def _logprobs(ref, inf, batch):
    want, want_lens = ref._forward(ref.params, ref.batch_stats,
                                   batch["features"], batch["feat_lens"])
    got, got_lens = inf.forward(batch["features"], batch["feat_lens"])
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("preset,blocked", [
    ("ds2_small", False), ("ds2_streaming", False), ("ds2_full", False),
    ("ds2_full", True)])
def test_int8_inferencer_matches_jax(monkeypatch, preset, blocked):
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    ref, inf, batch = _engines(preset)
    assert ref.kernel_regime == ("blocked-q" if blocked else "resident-q")
    # The Hopper rule does not read the TPU's budget: H=32 is resident.
    assert inf.kernel_regime == "resident-q"
    assert inf.quantize_calls == ref.quantize_calls == 1
    assert inf.quantize_report == ref.quantize_report
    got, want = _logprobs(ref, inf, batch)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    texts = inf.decode_batch_bucketed(batch)
    assert texts == ref.decode_batch_bucketed(batch)
    assert any(texts)
    wq = inf.model.rnn.rnn0.wh_fw
    assert wq.q.dtype == torch.int8 and wq.q.shape == (32, 96)


def test_int8_bf16_smoke():
    ref, inf, batch = _engines("ds2_small", "bfloat16", seed=5)
    got, want = _logprobs(ref, inf, batch)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=3e-2 * max(1.0, np.abs(want).max()))


def test_model_holds_int8_and_runs_only_without_gradient():
    """The quantized leaves live int8 on the device (the report's bytes
    after), the others f32; a forward that could need a gradient
    raises."""
    _, inf, batch = _engines("ds2_small", seed=6)
    held = sum(t.numel() * t.element_size()
               for k, t in inf.model.state_dict().items()
               if not k.endswith((".mean", ".var")))
    assert held == inf.quantize_report["bytes_after"]
    assert inf.model.head.kernel.q.dtype == torch.int8
    feats = torch.from_numpy(batch["features"])
    lens = torch.from_numpy(batch["feat_lens"]).long()
    with pytest.raises(RuntimeError, match="inference only"):
        inf.model(feats, lens)
    with torch.no_grad():
        logits, _ = inf.model(feats, lens)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("over,err,match", [
    ({"decode.mode": "sp_greedy"}, ValueError, "offline decode modes"),
    ({"decode.mode": "sp_beam"}, ValueError, "offline decode modes"),
    ({"decode.mode": "streaming"}, ValueError, "unidirectional"),
    ({"decode.mode": "rnnt_greedy"}, NotImplementedError, "slice 9")])
def test_mode_guards(over, err, match):
    cfg = apply_overrides(get_config("ds2_small"), {**OVER, **over})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(err, match=match):
        Inferencer(cfg, CharTokenizer.english(), params, stats,
                   device="cpu", quantize="int8")


def test_only_int8_and_no_quantize_is_fp():
    cfg = apply_overrides(get_config("ds2_small"), OVER)
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="only 'int8'"):
        Inferencer(cfg, CharTokenizer.english(), params, stats,
                   device="cpu", quantize="int4")
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    assert inf.kernel_regime == "fp" and inf.quantize_calls == 0
    assert inf.quantize_report is None


def test_cli_quantized(capsys):
    main(["--config=ds2_full", "--synthetic=4", "--device=cpu",
          "--quantize-weights=int8", "--model.rnn_layers=2",
          *[f"--{k}={v}" for k, v in OVER.items()
            if k != "data.bucket_frames"], "--data.bucket_frames=48"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{"event": "done"')
    assert sum('"event": "utt"' in ln for ln in lines) == 4
