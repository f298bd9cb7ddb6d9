"""The port's ``serve`` loops with the controllers and the second pass
(slices 4b and 6b) against the JAX package's, on the same f32 weights
and WAVs as ``tests/test_torch_serve.py``, the JAX side on its Pallas GRU
kernels in interpret mode:

- ``--lm-rescore``: ``serve_files`` and ``serve_files_pooled`` with a
  ``RescoringPool`` print the JAX loops' lines, the ``{"revision"}`` and
  ``{"rescoring"}`` lines included (every field but the wall-clock
  ``ms`` and ``rescore_latency_ms``), greedy and beam;
- ``--swap-checkpoint``: a rolling swap to the same weights finishes with
  finals bit-identical to a run without the swap, and one to other
  weights under guardrail 0 rolls back with the same finals; one whose
  last v1 replica drains while its sessions play re-pins them by drain
  into two segments; the ``{"rollout"}`` lines and finals equal the JAX
  loop's;
- ``--autoscale``: a forced ``slo_burn_rate`` makes one scale-up and one
  scale-down, the ``{"autoscale"}`` lines equal the JAX loop's, and the
  finals are those of a fixed pool;
- ``--models`` / ``--tenant-config``: ``serve_files_multimodel`` prints
  the JAX loop's ``model_map``, ``tenant_map``, ``{"shed"}``, chunk,
  ``tenants``, final and revision lines; ``main`` does so from two port
  checkpoints, with ``--status-port=0`` and ``--timeline``;
- ``main --decode=beam --lm-rescore`` on a vocabulary without a space
  prints the JAX ``main``'s lines, revisions included.

The pool's clock is a counter (each read advances it) and its drain
window 0 on both sides, so every controller decision falls on the same
call in both runs and the controllers' events compare with their times.
"""

import json
import os

import numpy as np
import pytest
import torch

import deepspeech_tpu.serving as jax_serving
import deepspeech_tpu_torch.serving as port_serving
from deepspeech_tpu import serve as jax_serve
from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.decode.ngram import load_lm as jax_load_lm
from deepspeech_tpu_torch import serve
from deepspeech_tpu_torch.checkpoint import CheckpointManager
from deepspeech_tpu_torch.config import apply_overrides
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.decode.ngram import load_lm, rescore_nbest
from test_torch_ngram import write_char_arpa
from test_torch_serve import BEAM, OVER, setup  # noqa: F401 (fixture)

torch.set_num_threads(1)

SERVING = {"jax": jax_serving, "port": port_serving}
LM = {"jax": jax_load_lm, "port": load_lm}


class CountClock:
    """Each read advances the clock by ``step`` seconds."""

    def __init__(self, step=0.01):
        self.t = 0.0
        self.step = step

    def __call__(self):
        self.t += self.step
        return self.t


def _forced_burn(side):
    """A pool registry whose ``slo_burn_rate`` is 2 (over budget) until
    the first horizontal scale-up, 0 until the first scale-down, then
    0.5 (inside the hysteresis band)."""
    base = SERVING[side].ServingTelemetry

    class ForcedBurn(base):
        def __init__(self):
            super().__init__()
            self.gauge("slo_burn_rate", 2.0, labels={"window": "5m"})

        def count(self, name, n=1, labels=None, **kw):
            super().count(name, n, labels=labels, **kw)
            if name == "autoscale_events" and labels \
                    and labels.get("actuator") == "horizontal":
                self.gauge("slo_burn_rate",
                           0.0 if labels["direction"] == "up" else 0.5,
                           labels={"window": "5m"})

    return ForcedBurn()


@pytest.fixture
def det_pools(monkeypatch):
    """Both packages' serve loops build their pools with a counter clock
    and a drain window of 0 (and, when asked, a given registry)."""
    def install(telemetry=None):
        for side, mod in SERVING.items():
            real, clock = mod.ReplicaPool, CountClock()

            def make(reps, real=real, clock=clock, side=side, **kw):
                kw.update(clock=clock, drain_window_s=0.0)
                if telemetry is not None:
                    kw["telemetry"] = telemetry(side)
                return real(reps, **kw)

            monkeypatch.setattr(mod, "ReplicaPool", make)
    return install


def _clean(text):
    """The JSONL records, less their wall-clock fields."""
    out = []
    for line in text.strip().splitlines():
        rec = json.loads(line)
        rec.pop("ms", None)
        if "revision" in rec:
            rec["revision"].pop("rescore_latency_ms")
        out.append(rec)
    return out


def assert_lines_equal(got, want):
    """Equal records; the revisions' ``score_delta`` (a difference of
    f32 beam scores) within 1e-4."""
    def split(lines):
        deltas, rest = [], []
        for rec in lines:
            if "revision" in rec:
                rec = {"revision": dict(rec["revision"])}
                deltas.append(rec["revision"].pop("score_delta"))
            rest.append(rec)
        return rest, deltas

    (g, gd), (w, wd) = split(got), split(want)
    assert g == w
    np.testing.assert_allclose(gd, wd, atol=1e-4, rtol=0)


def _beam(setup):
    """The setup with the beam search narrowed (``BEAM``)."""
    jcfg, tcfg, *rest = setup
    return (jax_apply_overrides(jcfg, BEAM), apply_overrides(tcfg, BEAM),
            *rest)


def _rescorer(side, arpa, **kw):
    return SERVING[side].RescoringPool(
        lm=LM[side](arpa), alpha=kw.pop("alpha", 2.0),
        beta=kw.pop("beta", 0.5), to_lm_text=lambda t: " ".join(t), **kw)


def _both(setup, tmp_path, fn, jkw=None, tkw=None, **kw):
    jcfg, tcfg, params, stats, paths = setup
    outs = {}
    for side, mod, cfg, tok, extra in (
            ("jax", jax_serve, jcfg, JaxCharTokenizer, jkw or {}),
            ("port", serve, tcfg, CharTokenizer,
             {"device": "cpu", **(tkw or {})})):
        path = tmp_path / f"{side}.jsonl"
        with open(path, "w") as fh:
            finals = getattr(mod, fn)(cfg, tok.english(), params, stats,
                                      paths, out=fh, **kw, **extra)
        outs[side] = (finals, _clean(path.read_text()))
    return outs["jax"], outs["port"]


@pytest.fixture(scope="module")
def arpa(tmp_path_factory):
    return write_char_arpa(tmp_path_factory.mktemp("lm"), with_unk=True)


@pytest.mark.parametrize("fn,kw", [
    ("serve_files", {}),
    ("serve_files", {"decode": "beam"}),
    ("serve_files_pooled", {"replicas": 2}),
    ("serve_files_pooled", {"replicas": 2, "decode": "beam",
                            "migrate_sessions": True})],
    ids=["greedy", "beam", "pooled", "pooled-beam"])
def test_lm_rescore_matches_jax(setup, tmp_path, arpa, fn, kw):
    if kw.get("decode") == "beam":
        setup = _beam(setup)
    (want, want_lines), (got, got_lines) = _both(
        setup, tmp_path, fn, jkw={"rescorer": _rescorer("jax", arpa)},
        tkw={"rescorer": _rescorer("port", arpa)}, **kw)
    assert got == want and any(got)
    assert_lines_equal(got_lines, want_lines)
    final_at = [i for i, r in enumerate(got_lines) if "final" in r][0]
    stats = got_lines[-1]["rescoring"]
    assert stats["submitted"] == stats["completed"] == 3
    revisions = [r["revision"] for r in got_lines if "revision" in r]
    assert all(got_lines.index({"revision": r}) > final_at
               for r in revisions)
    if kw.get("decode") == "beam":
        assert stats["revised"] == len(revisions)
    else:  # greedy feeds 1-best lists: accounted, never revised
        assert revisions == [] and stats["revised"] == 0


def test_beam_revisions_equal_host_rescore(setup, tmp_path, arpa):
    """Each ``{"revision"}`` of ``serve_files --decode=beam
    --lm-rescore`` is host ``rescore_nbest``'s pick over that stream's
    final n-best."""
    _, tcfg, params, stats, paths = _beam(setup)
    from deepspeech_tpu_torch.serving.session import \
        StreamingSessionManager

    captured = {}
    real_final_nbest = StreamingSessionManager.final_nbest

    def spy(self, sid):
        captured[sid] = real_final_nbest(self, sid)
        return captured[sid]

    pool = _rescorer("port", arpa)
    with open(tmp_path / "out.jsonl", "w") as fh:
        StreamingSessionManager.final_nbest = spy
        try:
            finals = serve.serve_files(tcfg, CharTokenizer.english(),
                                       params, stats, paths, out=fh,
                                       decode="beam", rescorer=pool,
                                       device="cpu")
        finally:
            StreamingSessionManager.final_nbest = real_final_nbest
    lines = _clean((tmp_path / "out.jsonl").read_text())
    lm = load_lm(arpa)
    picks = {sid: rescore_nbest(nb, lm, 2.0, 0.5,
                                to_lm_text=lambda t: " ".join(t))[0][0]
             for sid, nb in captured.items()}
    assert set(captured) == {"0", "1", "2"}
    revised = {r["revision"]["rid"]: r["revision"] for r in lines
               if "revision" in r}
    for s, sid in enumerate(["0", "1", "2"]):
        if sid in revised:
            assert revised[sid]["new_text"] == picks[sid] != finals[s]
            assert revised[sid]["old_text"] == finals[s]
        else:
            assert picks[sid] == finals[s]


def _other_weights(params):
    other = {k: dict(v) if isinstance(v, dict) else v
             for k, v in params.items()}
    other["head"] = {k: np.asarray(v) * -1.0
                     for k, v in params["head"].items()}
    return other


@pytest.mark.parametrize("case", ["same", "other", "same-midstream"])
def test_swap_matches_jax(setup, tmp_path, det_pools, case):
    """``same-midstream`` cuts the streams into chunks of 32 frames, so
    that the last v1 replica drains while its sessions play: a snapshot
    never crosses versions, so they re-pin by drain and end as two
    segments, as in the JAX loop."""
    det_pools()
    params, stats = setup[2], setup[3]
    swap = params if case != "other" else _other_weights(params)
    extra = {"chunk_frames": 32} if case == "same-midstream" else {}
    kw = {"replicas": 2, "migrate_sessions": True, "swap_params": swap,
          "swap_batch_stats": stats, "swap_at_chunk": 1, **extra}
    (want, want_lines), (got, got_lines) = _both(
        setup, tmp_path, "serve_files_pooled", **kw)
    assert got == want
    assert got_lines == want_lines
    (base, _), _ = _both(setup, tmp_path, "serve_files_pooled",
                         replicas=2, migrate_sessions=True, **extra)
    actions = [r["rollout"]["action"] for r in got_lines if "rollout" in r]
    if case == "other":
        assert actions[-1] == "rollback" and "swap" not in actions
    else:
        assert actions.count("swap") == 2 and actions[-1] == "done"
    if case == "same-midstream":
        assert got != base and all(got)
    else:
        assert got == base and any(got)


def test_autoscale_matches_jax(setup, tmp_path, det_pools):
    det_pools(telemetry=_forced_burn)
    kw = {"replicas": 2, "migrate_sessions": True, "autoscale": True,
          "autoscale_min": 1, "autoscale_max": 3,
          "autoscale_cooldown": 0.05, "chunk_frames": 32}
    (want, want_lines), (got, got_lines) = _both(
        setup, tmp_path, "serve_files_pooled", **kw)
    assert got == want
    assert got_lines == want_lines
    events = [r["autoscale"] for r in got_lines if "autoscale" in r]
    acts = [e["action"] for e in events]
    assert acts.count("scale_up") == 1 and acts.count("scale_down") == 1
    (base, _), _ = _both(setup, tmp_path, "serve_files_pooled",
                         replicas=2, migrate_sessions=True,
                         chunk_frames=32)
    assert got == base and any(got)


def _tenants_file(tmp_path):
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps({"tenants": [
        {"tenant": "gold", "quota": 1, "priority": "realtime",
         "weight": 2.0},
        {"tenant": "bulk", "quota": 1, "priority": "batch"}]}))
    return str(path)


def _multimodel(side, setup, tmp_path, arpa, out,
                stream_tenants=("gold", "bulk", "gold"), **kw):
    jcfg, tcfg, params, stats, paths = setup
    mod, cfg, tok = ((jax_serve, jcfg, JaxCharTokenizer) if side == "jax"
                     else (serve, tcfg, CharTokenizer))
    tenancy = SERVING[side].AdmissionController.from_file(
        _tenants_file(tmp_path))
    extra = {} if side == "jax" else {"device": "cpu"}
    return mod.serve_files_multimodel(
        cfg, tok.english(),
        {"a": (params, stats), "b": (_other_weights(params), stats)},
        paths, ["a", "b", "a"], tenancy=tenancy,
        stream_tenants=list(stream_tenants), out=out,
        rescorer=_rescorer(side, arpa), **kw, **extra)


@pytest.mark.parametrize("kw", [{}, {"replicas": 2, "decode": "beam"}],
                         ids=["greedy", "beam-two-replicas"])
def test_multimodel_matches_jax(setup, tmp_path, arpa, kw):
    if kw.get("decode") == "beam":
        setup = _beam(setup)
    lines = {}
    for side in ("jax", "port"):
        path = tmp_path / f"{side}.jsonl"
        with open(path, "w") as fh:
            _multimodel(side, setup, tmp_path, arpa, fh, **kw)
        lines[side] = _clean(path.read_text())
    got = lines["port"]
    assert_lines_equal(got, lines["jax"])
    (shed,) = [r["shed"] for r in got if "shed" in r]
    assert shed["stream"] == 2 and shed["tenant"] == "gold"
    assert {"model_map": {"0": "a", "1": "b", "2": "a"}} in got
    assert {"tenant_map": {"0": "gold", "1": "bulk", "2": "gold"}} in got
    final = [r["final"] for r in got if "final" in r][0]
    assert final[2] == "" and final[0] and final[1]
    assert got[-1]["rescoring"]["submitted"] == 2


def test_main_models_from_port_checkpoints(setup, tmp_path, arpa, capsys):
    """``serve --models --tenant-config --lm-rescore --status-port=0
    --timeline`` from two port checkpoints prints the JAX
    ``serve_files_multimodel``' lines, and the timeline file holds the
    run's events."""
    jcfg, tcfg, params, stats, paths = setup
    cks = []
    for name, p in (("ck_a", params), ("ck_b", _other_weights(params))):
        mgr = CheckpointManager(str(tmp_path / name))
        mgr.save(1, {"params": p, "batch_stats": stats})
        mgr.wait()
        cks.append(str(tmp_path / name))
    # serve assigns the file's tenants round-robin, in their order.
    names = port_serving.AdmissionController.from_file(
        _tenants_file(tmp_path)).tenants()
    with open(tmp_path / "jax.jsonl", "w") as fh:
        _multimodel("jax", setup, tmp_path, arpa, fh,
                    stream_tenants=[names[s % 2] for s in range(3)])
    timeline = tmp_path / "timeline.jsonl"
    serve.main([f"--models=a={cks[0]},b={cks[1]}",
                f"--tenant-config={_tenants_file(tmp_path)}",
                "--lm-rescore", f"--decode.lm_path={arpa}",
                "--decode.lm_alpha=2.0", "--decode.lm_beta=0.5",
                "--status-port=0", f"--timeline={timeline}",
                "--device=cpu", *paths]
               + [f"--{k}={v}" for k, v in OVER.items()])
    cap = capsys.readouterr()
    got = _clean(cap.out)
    want = _clean((tmp_path / "jax.jsonl").read_text())
    assert_lines_equal(got, want)
    assert [r["shed"]["stream"] for r in got if "shed" in r] == [2]
    status = json.loads(cap.err.strip().splitlines()[-1])
    assert status["status_server"].startswith("http://127.0.0.1:")
    assert os.path.exists(timeline)
    for line in timeline.read_text().splitlines():
        assert json.loads(line)["event"] == "timeline"


def test_main_checks_controller_flags(setup, tmp_path):
    """The JAX serve's flag checks: --tenant-config needs --models,
    --swap-checkpoint and --autoscale need --replicas >= 2, --models
    refuses endpointing, --lm-rescore needs decode.lm_path."""
    _, _, params, stats, paths = setup
    npz = str(tmp_path / "w.npz")
    from deepspeech_tpu_torch import bridge
    bridge.save_npz(npz, params, stats)
    for argv, match in (
            (["--tenant-config=t.json"], "needs --models"),
            (["--swap-checkpoint=x"], "needs --replicas >= 2"),
            (["--autoscale"], "needs --replicas >= 2"),
            (["--models=a=x", "--endpoint-silence-ms=500"],
             "does not compose"),
            (["--lm-rescore"], "needs decode.lm_path"),
            (["--models=a"], "model_id=ckpt_dir")):
        with pytest.raises(ValueError, match=match):
            serve.main([f"--params={npz}", "--device=cpu", *argv,
                        paths[0]] + [f"--{k}={v}" for k, v in OVER.items()])
    assert serve.parse_models_flag("a=x, b=y,") == {"a": "x", "b": "y"}
    with pytest.raises(ValueError, match="duplicate"):
        serve.parse_models_flag("a=x,a=y")


def test_main_lm_rescore_on_a_spaceless_vocab_matches_jax(
        setup, tmp_path, arpa, monkeypatch, capsys):
    """``serve --decode=beam --lm-rescore`` on a vocabulary without a
    space (English's alphabet with "_" for the space, ``--vocab``)
    scores the LM on space-joined characters, as the JAX serve does: both
    ``main``s, on one JAX checkpoint, print the same lines, and the
    character LM revises at least one transcript."""
    from deepspeech_tpu.checkpoint import CheckpointManager as JaxManager

    _, _, params, stats, paths = setup
    mgr = JaxManager(str(tmp_path / "ck"))
    mgr.save(1, {"state": {"params": params, "batch_stats": stats,
                           "step": np.asarray(1, np.int32)}})
    mgr.wait()
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("".join(("_" if c == " " else c) + "\n"
                             for c in CharTokenizer.english().chars))
    argv = [f"--checkpoint-dir={tmp_path / 'ck'}", "--replicas=2",
            "--decode=beam", "--lm-rescore", f"--vocab={vocab}",
            f"--decode.lm_path={arpa}", "--decode.lm_alpha=2.0",
            "--decode.lm_beta=0.5", *paths,
            *[f"--{k}={v}" for k, v in {**OVER, **BEAM}.items()]]
    jax_serve.main(argv)
    want = _clean(capsys.readouterr().out)
    serve.main([*argv, "--device=cpu"])
    got = _clean(capsys.readouterr().out)
    assert_lines_equal(got, want)
    revisions = [r["revision"] for r in got if "revision" in r]
    assert revisions and got[-1]["rescoring"]["revised"] == len(revisions)
    assert all(" " not in r["new_text"] for r in revisions)
