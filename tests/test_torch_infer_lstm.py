"""LSTM serving: the port's ``Inferencer`` with ``model.rnn_type="lstm"``
against the JAX package's on the same numpy weights, with the JAX side
on its Pallas LSTM kernels in interpret mode (``model.rnn_impl=
"pallas"``: ``lstm_scan_pallas``, or with ``quantize="int8"``
``lstm_scan_pallas_q``; resident, or blocked with
``rnn_pallas._VMEM_WEIGHT_BUDGET`` set to 0 inside the test). Models:
ds2_small-shaped (3 BiLSTM) and ds2_full-shaped (7 BiLSTM) at H=32 with
4 conv channels. Also the bridge of a qtree with ``[H, 4H]`` leaves, an
LSTM under a gradient (it trains; int8 raises), and the infer CLI.

Tolerances: log-probs 1e-4 absolute in f32 and identical greedy
transcripts.
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
from deepspeech_tpu.utils import quantize as jax_quantize
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer, SyntheticPipeline
from deepspeech_tpu_torch.infer import Inferencer, main
from deepspeech_tpu_torch.models import DeepSpeech2
from deepspeech_tpu_torch.ops import lstm
from deepspeech_tpu_torch.train import Trainer
from deepspeech_tpu_torch.utils import quantize
from test_torch_infer import _request
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

OVER = {"model.rnn_type": "lstm", "model.rnn_hidden": "32",
        "model.conv_channels": "4,4", "model.dtype": "float32",
        "model.rnn_impl": "pallas", "data.batch_size": "2",
        "data.bucket_frames": "24,40"}
LAYERS = {"ds2_small": 3, "ds2_full": 7}


def _weights(preset, seed):
    jcfg = jax_apply_overrides(jax_get_config(preset), OVER)
    tcfg = apply_overrides(get_config(preset), OVER)
    assert tcfg.model.rnn_layers == LAYERS[preset]
    batch = _request(tcfg)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(batch["features"]),
        jnp.asarray(batch["feat_lens"]), np.random.default_rng(seed))
    params = jax.tree.map(np.asarray, params)
    # Spread the logits so no frame's argmax is a near tie.
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    assert params["rnn"]["rnn0"]["wh_fw"].shape == (32, 128)
    return jcfg, tcfg, params, stats, batch


def _engines(preset, quantize_mode="", seed=7):
    jcfg, tcfg, params, stats, batch = _weights(preset, seed)
    ref = JaxInferencer(jcfg, JaxCharTokenizer.english(), params, stats,
                        quantize=quantize_mode)
    inf = Inferencer(tcfg, CharTokenizer.english(), params, stats,
                     device="cpu", quantize=quantize_mode)
    return ref, inf, batch


def _logprobs(ref, inf, batch):
    want, want_lens = ref._forward(ref.params, ref.batch_stats,
                                   batch["features"], batch["feat_lens"])
    got, got_lens = inf.forward(batch["features"], batch["feat_lens"])
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("preset,blocked", [
    ("ds2_small", False), ("ds2_full", False), ("ds2_full", True)])
def test_lstm_inferencer_matches_jax(monkeypatch, preset, blocked):
    """The f32 engines: log-probs and transcripts, the JAX side on
    ``lstm_scan_pallas`` (K12, or K14 with the budget at 0); each layer
    makes one ``lstm_fwd`` call with both directions."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    ref, inf, batch = _engines(preset)
    assert inf.kernel_regime == ref.kernel_regime == "fp"
    calls = []
    real = lstm.lstm_fwd

    def recording(xp, mask, w, b, reverse):
        calls.append((tuple(w.shape), tuple(reverse)))
        return real(xp, mask, w, b, reverse)

    monkeypatch.setattr(lstm, "lstm_fwd", recording)
    got, want = _logprobs(ref, inf, batch)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert calls == [((2, 32, 128), (False, True))] * LAYERS[preset]
    texts = inf.decode_batch_bucketed(batch)
    assert texts == ref.decode_batch_bucketed(batch)
    assert any(texts)


@pytest.mark.parametrize("preset,blocked", [
    ("ds2_small", False), ("ds2_full", False), ("ds2_full", True)])
def test_int8_lstm_inferencer_matches_jax(monkeypatch, preset, blocked):
    """The int8 engines: the JAX side on ``lstm_scan_pallas_q`` resident
    (K16) or blocked (K17); the port's ``kernel_regime`` by the Hopper
    rule (H=32 is resident on an H100), its recurrent leaves int8 in
    ``lstm_fwd_q``."""
    if blocked:
        monkeypatch.setattr(rnn_pallas, "_VMEM_WEIGHT_BUDGET", 0)
    ref, inf, batch = _engines(preset, "int8", seed=8)
    assert ref.kernel_regime == ("blocked-q" if blocked else "resident-q")
    assert inf.kernel_regime == "resident-q"
    assert inf.quantize_report == ref.quantize_report
    got, want = _logprobs(ref, inf, batch)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    texts = inf.decode_batch_bucketed(batch)
    assert texts == ref.decode_batch_bucketed(batch)
    assert any(texts)
    wq = inf.model.rnn.rnn0.wh_bw
    assert wq.q.dtype == torch.int8 and wq.q.shape == (32, 128)


def test_lstm_regime_at_the_full_widths():
    """ds2_small-lstm int8 holds W (K16) and ds2_full-lstm int8 streams
    it (K17) on an H100, as the TPU's ``fits_vmem(h, 1, 4)`` says; the
    keep predicate threads the recurrent matrices as for the GRU."""
    for preset, regime in (("ds2_small", "resident-q"),
                           ("ds2_full", "blocked-q")):
        m = apply_overrides(get_config(preset),
                            {"model.rnn_type": "lstm"}).model
        assert quantize.kernel_regime(m, True) == regime
        assert quantize.kernel_regime(m, False) == "fp"
        jm = jax_apply_overrides(jax_get_config(preset), {
            "model.rnn_type": "lstm", "model.rnn_impl": "pallas"}).model
        assert jax_quantize.kernel_regime(jm, True) == regime
        keep = quantize.keep_recurrent_q(m)
        assert keep("rnn/rnn6/wh_bw") and not keep("rnn/rnn0/wx/kernel")


def test_bridge_loads_an_lstm_qtree():
    """A qtree with ``[H, 4H]`` leaves loads strictly into the quantized
    LSTM model and comes back exactly."""
    _, tcfg, params, stats, _ = _weights("ds2_small", seed=9)
    qtree, _ = quantize.quantize_params(params)
    assert qtree["rnn"]["rnn1"]["wh_fw"]["q"].shape == (32, 128)
    assert qtree["rnn"]["rnn1"]["wh_fw"]["scale"].shape == (128,)
    model = DeepSpeech2(tcfg.model, quantized=True)
    model.load_state_dict(bridge.from_flax(qtree, stats))
    np.testing.assert_array_equal(model.rnn.rnn1.wh_fw.q.numpy(),
                                  qtree["rnn"]["rnn1"]["wh_fw"]["q"])
    np.testing.assert_array_equal(model.rnn.rnn1.wh_fw.scale.numpy(),
                                  qtree["rnn"]["rnn1"]["wh_fw"]["scale"])
    back, _ = bridge.to_flax(model.state_dict())
    np.testing.assert_array_equal(back["rnn"]["rnn2"]["wx"]["kernel"]["q"],
                                  qtree["rnn"]["rnn2"]["wx"]["kernel"]["q"])


@pytest.mark.parametrize("quantized", [False, True])
def test_lstm_under_grad_raises(quantized):
    """An LSTM forward that could need a gradient runs through
    ``LSTMFunction`` and gives finite gradients to every recurrent
    parameter; an int8 LSTM raises there (``lstm_scan_pallas_q`` has no
    VJP). Without a gradient both run."""
    cfg = apply_overrides(get_config("ds2_small"), OVER)
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    if quantized:
        params, _ = quantize.quantize_params(params)
    model = DeepSpeech2(cfg.model, quantized=quantized)
    model.load_state_dict(bridge.from_flax(params, stats))
    feats = torch.randn(2, 24, 161)
    lens = torch.tensor([24, 17])
    if quantized:
        with pytest.raises(RuntimeError, match="inference only"):
            model.eval()(feats, lens)
    else:
        logits, _ = model.eval()(feats, lens)
        logits.float().square().mean().backward()
        for name, p in model.named_parameters():
            assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert model.rnn.rnn1.wh_bw.grad.abs().max() > 0
    with torch.no_grad():
        logits, _ = model(feats, lens)
    assert torch.isfinite(logits).all()


def test_trainer_refuses_an_lstm_before_any_step():
    """``Trainer`` no longer refuses an LSTM: it takes a step on the CPU,
    with a finite loss and gradient norm, and the recurrent weights
    move."""
    cfg = apply_overrides(get_config("ds2_small"),
                          {**OVER, "train.checkpoint_dir": ""})
    pipe = SyntheticPipeline(cfg, 2)
    trainer = Trainer(cfg, pipe, CharTokenizer.english(), device="cpu")
    before = trainer.model.rnn.rnn0.wh_fw.detach().clone()
    metrics = trainer.train_step(next(iter(pipe.epoch(0))))
    assert trainer.step == 1
    assert all(torch.isfinite(v) for v in metrics.values())
    assert not torch.equal(trainer.model.rnn.rnn0.wh_fw, before)


@pytest.mark.parametrize("quantize_mode", ["", "int8"])
def test_cli_lstm(capsys, quantize_mode):
    main(["--config=ds2_small", "--synthetic=4", "--device=cpu",
          f"--quantize-weights={quantize_mode}",
          *[f"--{k}={v}" for k, v in OVER.items()
            if k != "data.bucket_frames"], "--data.bucket_frames=48"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{"event": "done"')
    assert sum('"event": "utt"' in ln for ln in lines) == 4
