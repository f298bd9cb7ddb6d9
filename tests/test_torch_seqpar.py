"""The port's sequence-parallel decoding (``parallel/seqpar.py``, the
Inferencer's ``sp_greedy`` and ``sp_beam``) against the JAX package's on
the 8-device CPU mesh (``make_mesh((8, 1))``, as tests/test_seqpar.py
runs it), the port on eight CPU shards: the same weights (JAX's tree
through ``bridge.from_flax``), the same features.

Tolerances: logits within 1e-5 in float32 (the two packages sum in
other orders; the port's relay gives its own offline forward's bits on
the CPU, which the test holds too); ids, beam prefixes and lengths
equal; beam scores within 1e-4 (the log-sum-exp of scores built from
logits 1e-5 apart). The refusals are JAX ``_validate``'s and
``_sp_setup``'s, with the same exception types and messages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.parallel import make_mesh as jax_make_mesh
from deepspeech_tpu.parallel import seqpar as jax_seqpar
from deepspeech_tpu_torch import bridge
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.infer import Inferencer
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.parallel import distributed, seqpar
from test_torch_beam import tables
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8
LOGIT_TOL = 1e-5
SCORE_TOL = 1e-4


def _over(**model_kw):
    """tests/test_seqpar.py's model: dev_slice at 2 layers of 32 units,
    4+4 conv channels, V=16, float32."""
    base = {"rnn_layers": 2, "rnn_hidden": 32, "conv_channels": (4, 4),
            "vocab_size": 16, "dtype": "float32", **model_kw}
    jcfg = jax_get_config("dev_slice")
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               **base))
    tcfg = apply_overrides(get_config("dev_slice"), {
        f"model.{k}": ",".join(map(str, v)) if isinstance(v, tuple)
        else str(v).lower() if isinstance(v, bool) else str(v)
        for k, v in base.items()})
    return jcfg, tcfg


def _setup(jcfg, tcfg, t=256, b=2, seed=0):
    """Features [B, T, 161] with lengths (T, T-57), JAX variables from
    numpy (the head x8: no near-tie decides an id) and the port's model
    holding them."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, t, 161)).astype(np.float32)
    lens = np.array([t, t - 57][:b], np.int32)
    for i, n in enumerate(lens):
        feats[i, n:] = 0.0
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.asarray(feats[:1, :64]),
        jnp.asarray([64]), rng)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    model = DeepSpeech2(tcfg.model)
    model.load_state_dict(bridge.from_flax(params, stats))
    model.eval()
    return {"params": params, "batch_stats": stats}, model, feats, lens


@pytest.fixture(scope="module")
def mesh():
    return jax_make_mesh((8, 1))


def _port_logits(tcfg, model, feats, lens, devices=CPU8):
    shards, out_lens = seqpar.sp_forward(tcfg.model, model,
                                         torch.from_numpy(feats),
                                         torch.from_numpy(lens), devices)
    assert len(shards) == len(devices)
    return torch.cat(shards, dim=1).numpy(), out_lens.numpy()


@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("rnn_type", ["gru", "lstm"])
def test_sp_forward_matches_jax(mesh, rnn_type, bidirectional):
    jcfg, tcfg = _over(rnn_type=rnn_type, bidirectional=bidirectional)
    variables, model, feats, lens = _setup(jcfg, tcfg, seed=1)
    ref, ref_lens = jax.jit(lambda f, n: jax_seqpar.sp_forward(
        jcfg.model, variables, f, n, mesh))(jnp.asarray(feats),
                                           jnp.asarray(lens))
    got, got_lens = _port_logits(tcfg, model, feats, lens)
    np.testing.assert_array_equal(got_lens, np.asarray(ref_lens))
    np.testing.assert_allclose(got, np.asarray(ref), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    # On the CPU the relay is the offline forward, bit for bit.
    with torch.no_grad():
        off, off_lens = model(torch.from_numpy(feats),
                              torch.from_numpy(lens).long())
    assert np.array_equal(got, off.numpy())
    assert np.array_equal(got_lens, off_lens.numpy())


def test_sp_greedy_ids_match_jax(mesh):
    jcfg, tcfg = _over()
    variables, model, feats, lens = _setup(jcfg, tcfg, seed=2)
    ref_ids, ref_lens = jax_seqpar.sp_greedy_decode(
        jcfg.model, variables, jnp.asarray(feats), jnp.asarray(lens), mesh)
    ids, out_lens = seqpar.sp_greedy_decode(tcfg.model, model, feats, lens,
                                            CPU8)
    assert ids.dtype == np.int32
    np.testing.assert_array_equal(out_lens, ref_lens)
    for i, n in enumerate(out_lens):
        np.testing.assert_array_equal(ids[i, :n], ref_ids[i, :n])


@pytest.mark.parametrize("table", [None, "dense", "hashed"])
def test_sp_beam_matches_jax(mesh, tmp_path, table):
    """The relayed beam state over eight shards against JAX
    ``sp_beam_search`` (tests/test_seqpar.py:128-182), without an LM and
    with a dense and a hashed fusion table of one character trigram
    (V=5), each package's own table of the same ARPA; and against the
    port's offline ``beam_search`` on its own log-probs."""
    from deepspeech_tpu_torch.decode.beam import beam_search

    jcfg, tcfg = _over(vocab_size=5)
    variables, model, feats, lens = _setup(jcfg, tcfg, seed=7)
    t_lm, j_lm = tables(tmp_path, table) if table else (None, None)
    kw = {"beam_width": 8, "prune_top_k": 4, "max_len": 32}
    ref = jax_seqpar.sp_beam_search(jcfg.model, variables,
                                    jnp.asarray(feats), jnp.asarray(lens),
                                    mesh, lm_table=j_lm, **kw)
    got = seqpar.sp_beam_search(tcfg.model, model, feats, lens, CPU8,
                                lm_table=t_lm, **kw)
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(ref[2]),
                               atol=SCORE_TOL, rtol=SCORE_TOL)
    with torch.no_grad():
        logits, out_lens = model(torch.from_numpy(feats),
                                 torch.from_numpy(lens).long())
    off = beam_search(torch.log_softmax(logits, -1), out_lens,
                      lm_table=t_lm, **kw)
    for g, o in zip(got, off):
        assert torch.equal(g, o)


def _inferencer(tcfg, params, stats, **over):
    cfg = apply_overrides(tcfg, {"model.vocab_size": "29", **over})
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    inf.sp_devices = CPU8
    return inf


@pytest.mark.parametrize("t", [250, 40], ids=["ragged", "short"])
def test_inferencer_sp_modes_equal_the_offline_modes(mesh, t):
    """``decode.mode="sp_greedy"`` and ``"sp_beam"`` through the
    Inferencer on eight CPU shards: greedy's and beam's texts, and
    sp_greedy's equal to the JAX Inferencer's. 250 frames pads to the
    shard multiple; 40 frames (5 a shard) is below the conv halo's
    minimum on 8 shards and pads up to ``sp_min_frames``."""
    from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
    from deepspeech_tpu.infer import Inferencer as JaxInferencer

    jcfg, tcfg = _over(vocab_size=29)
    variables, _, feats, lens = _setup(jcfg, tcfg, t=t, seed=8)
    assert t % seqpar.sp_frame_multiple(tcfg.model, 8) or \
        t < seqpar.sp_min_frames(tcfg.model, 8)
    batch = {"features": feats, "feat_lens": lens}
    p, s = variables["params"], variables["batch_stats"]
    texts = {mode: _inferencer(tcfg, p, s, **{
        "decode.mode": mode, "decode.beam_width": "8",
        "decode.prune_top_k": "5"}).decode_batch(batch)
        for mode in ("greedy", "sp_greedy", "beam", "sp_beam")}
    assert texts["sp_greedy"] == texts["greedy"]
    assert texts["sp_beam"] == texts["beam"]
    assert any(texts["sp_greedy"])
    jax_sp = JaxInferencer(dataclasses.replace(
        jcfg, decode=dataclasses.replace(jcfg.decode, mode="sp_greedy")),
        JaxCharTokenizer.english(), p, s)
    assert jax_sp.decode_batch(batch) == texts["sp_greedy"]


@pytest.mark.parametrize("mode", ["sp_greedy", "sp_beam"])
def test_inferencer_keeps_its_replicas(mode):
    """The sp modes build the model's ``seqpar.Replicas`` at the first
    decode and reuse them (and, for sp_beam, each device's LM table)
    for every later batch; a new ``sp_devices`` list builds new ones,
    and replicas of another device list are refused."""
    _, tcfg = _over(vocab_size=29)
    cfg = apply_overrides(tcfg, {"decode.mode": mode})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    batch = {"features": np.random.default_rng(3).normal(
        size=(1, 64, 161)).astype(np.float32),
        "feat_lens": np.array([64], np.int32)}
    first = inf.decode_batch(batch)
    replicas = inf._sp_replicas[1]
    assert replicas.models == [inf.model]
    assert inf.decode_batch(batch) == first
    assert inf._sp_replicas[1] is replicas
    inf.sp_devices = [torch.device("cpu")] * 2
    assert inf.decode_batch(batch) == first
    assert inf._sp_replicas[1] is not replicas
    assert len(inf._sp_replicas[1]) == 2
    with pytest.raises(ValueError, match="another"):
        seqpar.sp_forward(cfg.model, inf.model, batch["features"],
                          batch["feat_lens"], [torch.device("cpu")],
                          inf._sp_replicas[1])


@pytest.mark.parametrize("preset", ["ds2_small", "ds2_full", "dev_slice"])
@pytest.mark.parametrize("shards", [1, 4, 8])
def test_frame_rules_equal_jax(preset, shards):
    jm, tm = jax_get_config(preset).model, get_config(preset).model
    assert seqpar.sp_frame_multiple(tm, shards) == \
        jax_seqpar.sp_frame_multiple(jm, shards)
    assert seqpar.sp_min_frames(tm, shards) == \
        jax_seqpar.sp_min_frames(jm, shards)
    for kt, _, st, _ in tm.conv_layers:
        assert seqpar._conv_halo(kt, st) == jax_seqpar._conv_halo(kt, st)


def _refusal(case, mesh):
    """``(port call, JAX call, exception, match)`` of a refusal case."""
    over = {"lookahead": {"bidirectional": False, "lookahead_context": 8},
            "pipelined": {"rnn_layers": 3, "pipeline_stages": 2}}.get(
                case, {})
    jcfg, tcfg = _over(**over)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(2, 256, 161)).astype(np.float32)
    lens = np.array([256, 199], np.int32)
    model = DeepSpeech2(tcfg.model).eval()
    if case == "misaligned":
        feats = feats[:, :250]
    elif case == "halo":
        # 2 frames a shard on 8, below the 11-tap, stride-2 first
        # layer's 5-frame halo.
        assert 16 % seqpar.sp_frame_multiple(tcfg.model, 8) == 0
        feats, lens = feats[:, :16], np.minimum(lens, 16)
    match = {"lookahead": "stream", "pipelined": "non-pipelined",
             "misaligned": "divide", "halo": "halo"}[case]
    return (lambda: seqpar.sp_forward(tcfg.model, model, feats, lens, CPU8),
            lambda: jax_seqpar.sp_forward(jcfg.model, None,
                                          jnp.asarray(feats),
                                          jnp.asarray(lens), mesh),
            ValueError, match)


@pytest.mark.parametrize("case", ["lookahead", "misaligned", "halo",
                                  "pipelined"])
def test_sp_refusals_equal_jax(mesh, case):
    port, ref, exc, match = _refusal(case, mesh)
    with pytest.raises(exc, match=match):
        ref()
    with pytest.raises(exc, match=match):
        port()


@pytest.mark.parametrize("mode", ["sp_greedy", "sp_beam"])
def test_inferencer_refuses_int8_and_a_multi_rank_group(monkeypatch, mode):
    """The sp modes thread full-precision params: int8 raises at init as
    JAX's does (infer.py:205-209); under a group of more than one rank
    the decode raises, as JAX's refuses ``process_count() > 1``."""
    _, tcfg = _over(vocab_size=29)
    cfg = apply_overrides(tcfg, {"decode.mode": mode})
    params, stats = bridge.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="offline decode modes"):
        Inferencer(cfg, CharTokenizer.english(), params, stats,
                   device="cpu", quantize="int8")
    inf = Inferencer(cfg, CharTokenizer.english(), params, stats,
                     device="cpu")
    assert inf.sp_devices == [torch.device("cpu")]
    batch = {"features": np.zeros((1, 64, 161), np.float32),
             "feat_lens": np.array([64], np.int32)}
    assert isinstance(inf.decode_batch(batch)[0], str)
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="single-process"):
        inf.decode_batch(batch)


def test_sp_greedy_cli_on_the_cpu(capsys):
    from deepspeech_tpu_torch.infer import main

    main(["--config=ds2_small", "--synthetic=2", "--device=cpu",
          "--model.rnn_hidden=32", "--model.conv_channels=4,4",
          "--data.batch_size=2", "--decode.mode=sp_greedy"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1].startswith('{"event": "done"')
    assert sum('"event": "utt"' in ln for ln in lines) == 2
