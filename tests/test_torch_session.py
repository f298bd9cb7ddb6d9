"""The port's ``StreamingSessionManager`` (greedy) against the JAX
package's, fed the same join/step/leave/export/import script on the same
numpy weights, with the JAX side on its Pallas GRU kernel in interpret
mode; then the manager's contracts, as the JAX package's
tests/test_serving.py and tests/test_migration.py state them: slot reuse
and capacity growth, a mid-flight join, a tail, step validation, export
into cold and warm targets, a draining session refused, a fingerprint
mismatch, and snapshots of host numpy arrays.

Equalities are of transcripts (partials and finals), as the JAX tests
demand them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeech_tpu.config import apply_overrides as jax_apply_overrides
from deepspeech_tpu.config import get_config as jax_get_config
from deepspeech_tpu.data import CharTokenizer as JaxCharTokenizer
from deepspeech_tpu.models import create_model as jax_create_model
from deepspeech_tpu.serving.session import \
    StreamingSessionManager as JaxSessionManager
from deepspeech_tpu_torch.config import apply_overrides, get_config
from deepspeech_tpu_torch.data import CharTokenizer
from deepspeech_tpu_torch.serving.migration import (SnapshotIncompatible,
                                                    StreamSnapshot)
from deepspeech_tpu_torch.serving.session import StreamingSessionManager
from test_torch_model import random_flax_variables

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

NF = 32
OVER = {"model.rnn_hidden": "32", "model.rnn_layers": "2",
        "model.conv_channels": "4,4", "model.lookahead_context": "4",
        "model.dtype": "float32", "model.rnn_impl": "pallas",
        "features.num_features": str(NF)}


@pytest.fixture(scope="module")
def tiny():
    """(jax cfg, port cfg, params, batch_stats) from numpy, the head
    scaled so that the greedy transcripts are not empty."""
    jcfg = jax_apply_overrides(jax_get_config("ds2_streaming"), OVER)
    tcfg = apply_overrides(get_config("ds2_streaming"), OVER)
    params, stats = random_flax_variables(
        jax_create_model(jcfg.model), jnp.zeros((1, 64, NF), jnp.float32),
        jnp.full((1,), 64, jnp.int32), np.random.default_rng(7))
    params = jax.tree.map(np.asarray, params)
    params["head"]["kernel"] = params["head"]["kernel"] * 8.0
    return jcfg, tcfg, params, stats


def _mgr(tiny, **kw):
    _, tcfg, params, stats = tiny
    return StreamingSessionManager(tcfg, params, stats,
                                   CharTokenizer.english(), chunk_frames=64,
                                   device="cpu", **kw)


def _chunks(f, k=64):
    n = f.shape[0] // k
    return [f[i * k:(i + 1) * k] for i in range(n)], f[n * k:]


def _feat(n, seed):
    return np.random.default_rng(seed).standard_normal((n, NF)).astype(
        np.float32)


def _solo(tiny, feat):
    """The never-migrated reference: one manager, one slot, same chunks."""
    mgr = _mgr(tiny, capacity=1)
    mgr.join("ref")
    chunks, tail = _chunks(feat)
    for c in chunks:
        mgr.step({"ref": c})
    mgr.leave("ref", tail=tail if tail.shape[0] else None)
    mgr.flush()
    return mgr.final("ref")


def _script(make, with_nbest=False):
    """One join/step/leave/export/import script over two managers made by
    ``make(capacity)``; returns every partial and final it saw (and,
    ``with_nbest``, each session's ``final_nbest``)."""
    fa, fb, fc = _feat(64 * 4 + 20, 1), _feat(64 * 3, 2), _feat(64 * 3, 3)
    (ca, ta), (cb, _), (cc, _) = _chunks(fa), _chunks(fb), _chunks(fc)
    src, dst = make(1), make(2)
    seen = []
    src.join("a")
    seen.append(src.step({"a": ca[0]}))
    src.join("b")                            # grows 1 -> 2 at clock 64
    seen.append(src.step({"a": ca[1], "b": cb[0]}))
    dst.join("c")
    seen.append(dst.step({"c": cc[0]}))
    snap = src.export_session("b")           # b moves to a warm target
    dst.import_session(snap)
    seen.append(dst.step({"c": cc[1], "b": cb[1]}))
    seen.append(src.step({"a": ca[2]}))
    src.leave("a", tail=None)
    src.join("d", raw_len=100)               # reuses a free slot
    seen.append(src.step({"d": fc[:64]}))
    seen.append(dst.step({"c": cc[2], "b": cb[2]}))
    dst.leave("c")
    dst.leave("b")
    src.leave("d", tail=fc[64:100])
    src.flush()
    dst.flush()
    seen.append({sid: m.final(sid) for m, sids in ((src, "ad"), (dst, "bc"))
                 for sid in sids})
    seen.append((src.stats(), dst.stats()))
    if with_nbest:
        seen.append({sid: m.final_nbest(sid)
                     for m, sids in ((src, "ad"), (dst, "bc"))
                     for sid in sids})
    return seen


def test_manager_matches_jax_on_one_script(tiny):
    jcfg, tcfg, params, stats = tiny
    want = _script(lambda cap: JaxSessionManager(
        jcfg, params, stats, JaxCharTokenizer.english(), chunk_frames=64,
        capacity=cap))
    got = _script(lambda cap: _mgr(tiny, capacity=cap))
    assert got == want
    assert any(want[-2].values())


def test_slot_reuse_and_capacity_grow(tiny):
    mgr = _mgr(tiny, capacity=1)
    f = _feat(64, 2)
    assert mgr.join("a") == 0 and mgr.capacity == 1
    mgr.step({"a": f})
    # A second concurrent session outgrows capacity: the rung doubles.
    assert mgr.join("b") == 1
    assert mgr.capacity == 2 and mgr.grows == 1
    assert mgr.grow_events[0]["to_capacity"] == 2
    mgr.step({"a": f, "b": f})
    # "a" leaves; the NEXT session reuses its slot — no new rung.
    mgr.leave("a")
    while "a" not in mgr._finals:
        mgr.step({"b": f})
    assert mgr.join("c") == 0
    assert mgr.capacity == 2 and mgr.grows == 1 and mgr.reuses == 1
    stats = mgr.stats()
    assert stats["slot_reuses"] == 1 and stats["capacity"] == 2
    assert mgr.telemetry.counter("capacity_grows") == 1
    assert mgr.telemetry.counter("slot_reuses") == 1
    assert mgr.final_nbest("a") == [(mgr.final("a"), 0.0)]


def test_join_midflight_decodes_as_solo(tiny):
    fa, fb = _feat(256, 3), _feat(128, 4)
    (ca, _), (cb, _) = _chunks(fa), _chunks(fb)
    mgr = _mgr(tiny, capacity=2)
    mgr.join("a")
    mgr.step({"a": ca[0]})
    mgr.step({"a": ca[1]})
    mgr.join("b")                  # mid-flight: clock is 128, not 0
    assert mgr._sessions["b"].raw_start == 128
    mgr.step({"a": ca[2], "b": cb[0]})
    mgr.step({"a": ca[3], "b": cb[1]})
    mgr.leave("a")
    mgr.leave("b")
    mgr.flush()
    assert mgr.final("a") == _solo(tiny, fa)
    assert mgr.final("b") == _solo(tiny, fb)
    assert mgr.final("a") and mgr.final("b")


def test_leave_with_tail_then_join_before_flush(tiny):
    fa, fb = _feat(100, 5), _feat(128, 6)  # a: 64 + a tail of 36
    (ca, tail), (cb, _) = _chunks(fa), _chunks(fb)
    mgr = _mgr(tiny, capacity=1)
    mgr.join("a")
    parts = mgr.step({"a": ca[0]})
    assert set(parts) == {"a"}
    mgr.leave("a", tail=tail)      # draining with its tail in flight
    mgr.join("b")                  # must grow, not take a's slot
    assert mgr.capacity == 2
    mgr.step({"b": cb[0]})
    mgr.step({"b": cb[1]})
    mgr.leave("b")
    mgr.flush()
    assert mgr.final("a") == _solo(tiny, fa)
    assert mgr.final("b") == _solo(tiny, fb)
    assert mgr.stats()["active"] == 0


def test_step_validates_active_set_and_shapes(tiny):
    mgr = _mgr(tiny, capacity=1)
    mgr.join("a")
    with pytest.raises(ValueError, match="active sessions"):
        mgr.step({})
    with pytest.raises(ValueError, match="must be"):
        mgr.step({"a": _feat(32, 1)})
    with pytest.raises(ValueError, match="already attached"):
        mgr.join("a")
    with pytest.raises(ValueError, match="tail"):
        mgr.leave("a", tail=_feat(64, 1))
    with pytest.raises(ValueError, match="live sessions"):
        mgr.flush()
    with pytest.raises(KeyError, match="not finalized"):
        mgr.final("a")


def test_export_import_cold_target(tiny):
    """Into a FRESH manager (clock 0 < fed): the re-based raw_start goes
    negative and the continuation decodes as the never-migrated one."""
    f = _feat(256, 10)
    chunks, _ = _chunks(f)
    src, dst = _mgr(tiny, capacity=2), _mgr(tiny, capacity=2)
    src.join("x")
    src.step({"x": chunks[0]})
    src.step({"x": chunks[1]})
    snap = src.export_session("x")
    assert src.stats()["active"] == 0 and src.stats()["draining"] == 0
    assert dst.clock == 0 and snap.fed == 128
    dst.import_session(snap)
    assert dst._sessions["x"].raw_start == -128
    dst.step({"x": chunks[2]})
    dst.step({"x": chunks[3]})
    dst.leave("x")
    dst.flush()
    assert dst.final("x") == _solo(tiny, f)
    assert src.telemetry.counter("sessions_exported") == 1
    assert dst.telemetry.counter("sessions_imported") == 1


def test_export_import_warm_target_with_tail(tiny):
    """Into a manager whose clock is AHEAD of the source, then a tail."""
    f, g = _feat(64 * 3 + 37, 11), _feat(64 * 4, 12)
    (chunks, tail), (gchunks, _) = _chunks(f), _chunks(g)
    src, dst = _mgr(tiny, capacity=2), _mgr(tiny, capacity=2)
    dst.join("w")
    dst.step({"w": gchunks[0]})
    dst.step({"w": gchunks[1]})             # dst.clock = 128
    src.join("x")
    src.step({"x": chunks[0]})              # src.clock = 64
    dst.import_session(src.export_session("x"))
    assert dst._sessions["x"].raw_start == 128 - 64
    dst.step({"x": chunks[1], "w": gchunks[2]})
    dst.step({"x": chunks[2], "w": gchunks[3]})
    dst.leave("x", tail=tail)
    dst.leave("w")
    dst.flush()
    assert dst.final("x") == _solo(tiny, f)
    assert dst.final("w") == _solo(tiny, g)


def test_export_refuses_draining_session(tiny):
    f = _feat(128, 14)
    chunks, _ = _chunks(f)
    mgr = _mgr(tiny, capacity=1)
    mgr.join("x")
    for c in chunks:
        mgr.step({"x": c})
    mgr.leave("x")
    with pytest.raises(ValueError, match="draining"):
        mgr.export_session("x")
    mgr.flush()
    assert mgr.final("x") == _solo(tiny, f)


def test_import_fingerprint_mismatch_rejects(tiny):
    src = _mgr(tiny, capacity=1)
    dst = StreamingSessionManager(tiny[1], tiny[2], tiny[3],
                                  CharTokenizer.english(), chunk_frames=128,
                                  device="cpu")
    src.join("x")
    src.step({"x": _feat(64, 15)})
    snap = src.export_session("x")
    with pytest.raises(SnapshotIncompatible, match="fingerprint"):
        dst.import_session(snap)
    assert dst.stats()["active"] == 0


def test_snapshot_holds_host_numpy(tiny):
    mgr = _mgr(tiny, capacity=1)
    mgr.join("x")
    mgr.step({"x": _feat(64, 16)})
    snap = mgr.snapshot_session("x")
    assert isinstance(snap, StreamSnapshot)
    leaves = [snap.acoustic["raw_hist"], snap.acoustic["la_buf"],
              *snap.acoustic["h"]]
    assert all(isinstance(a, np.ndarray) for a in leaves)
    assert snap.nbytes() == sum(a.nbytes for a in leaves) + len(
        snap.text.encode())
    # A copy: the slot streaming on does not move the snapshot.
    before = snap.acoustic["h"][0].copy()
    mgr.step({"x": _feat(64, 17)})
    assert np.array_equal(snap.acoustic["h"][0], before)


@pytest.mark.parametrize("kw,match", [
    ({"decode": "beam", "journal": object()}, "slice 4c"),
    ({"journal": object()}, "slice 4")])
def test_later_slices_refused(tiny, kw, match):
    with pytest.raises(NotImplementedError, match=match):
        _mgr(tiny, **kw)


# -- beam decoding ----------------------------------------------------------

BEAM = {"decode.beam_width": "8", "data.max_label_len": "64"}


def _beam_table(tmp_path, port: bool):
    """The character trigram fixture as a dense table over the English
    vocabulary (V=29), the port's or the JAX package's."""
    from deepspeech_tpu.decode import ngram as jax_ngram
    from deepspeech_tpu_torch.decode import ngram
    from test_torch_ngram import write_char_arpa

    path = write_char_arpa(tmp_path, with_unk=True)
    tok = CharTokenizer.english()
    mod = ngram if port else jax_ngram
    table, _ = mod.dense_fusion_table(mod.NGramLM.from_arpa(path),
                                      lambda i: tok.decode([i]), 29, 0.7,
                                      0.5)
    return torch.from_numpy(table) if port else jnp.asarray(table)


def _beam_mgr(tiny, capacity=1, **kw):
    _, tcfg, params, stats = tiny
    return StreamingSessionManager(apply_overrides(tcfg, BEAM), params,
                                   stats, CharTokenizer.english(),
                                   chunk_frames=64, decode="beam",
                                   capacity=capacity, device="cpu", **kw)


@pytest.mark.parametrize("lm", [False, True])
def test_beam_manager_matches_jax_on_one_script(tiny, tmp_path, lm):
    """``decode="beam"``: the stable partials, finals and stats of the
    script equal the JAX beam manager's; each ``final_nbest`` has the
    same texts, scores within 1e-4."""
    jcfg, _, params, stats = tiny
    jcfg = jax_apply_overrides(jcfg, BEAM)
    jtable = _beam_table(tmp_path, port=False) if lm else None
    table = _beam_table(tmp_path, port=True) if lm else None
    want = _script(lambda cap: JaxSessionManager(
        jcfg, params, stats, JaxCharTokenizer.english(), chunk_frames=64,
        decode="beam", lm_table=jtable, capacity=cap), with_nbest=True)
    got = _script(lambda cap: _beam_mgr(tiny, cap, lm_table=table),
                  with_nbest=True)
    assert got[:-1] == want[:-1]
    assert any(want[-3].values())
    for sid, nb in got[-1].items():
        ref = want[-1][sid]
        assert [t for t, _ in nb] == [t for t, _ in ref]
        np.testing.assert_allclose([x for _, x in nb], [x for _, x in ref],
                                   atol=1e-4, rtol=0)
        assert nb[0][0] == got[-3][sid]
        assert len({t for t, _ in nb}) == len(nb)  # each text once


def test_beam_export_import_continues_bit_identically(tiny):
    """A beam session exported after two chunks and imported into a cold
    manager ends with the never-migrated session's n-best, texts and
    scores bit for bit (equal shapes: capacity 2, slot 0)."""
    f = _feat(64 * 4 + 20, 10)
    chunks, tail = _chunks(f)

    def finish(mgr, sid, rest):
        for c in rest:
            mgr.step({sid: c})
        mgr.leave(sid, tail=tail)
        mgr.flush()
        return mgr.final_nbest(sid)

    solo = _beam_mgr(tiny, 2)
    solo.join("x")
    want = finish(solo, "x", chunks)
    src, dst = _beam_mgr(tiny, 2), _beam_mgr(tiny, 2)
    src.join("x")
    for c in chunks[:2]:
        src.step({"x": c})
    snap = src.export_session("x")
    assert dst.import_session(snap) == 0
    got = finish(dst, "x", chunks[2:])
    assert got == want and want[0][0]
    assert dst.final("x") == want[0][0]


def test_beam_snapshot_rows_and_geometry(tiny):
    from deepspeech_tpu_torch.decode.beam import BeamState

    mgr = _beam_mgr(tiny, 1)
    mgr.join("x")
    mgr.step({"x": _feat(64, 16)})
    snap = mgr.snapshot_session("x")
    assert isinstance(snap.decoder, BeamState)
    assert all(isinstance(r, np.ndarray) for r in snap.decoder)
    assert snap.decoder.prefixes.shape == (8, 64)
    assert snap.prev_ids is None and snap.text is None
    assert snap.nbytes() == sum(a.nbytes for a in (
        snap.acoustic["raw_hist"], snap.acoustic["la_buf"],
        *snap.acoustic["h"], *snap.decoder))
    assert "beam=8x64" in mgr.snapshot_fingerprint()
    wide = StreamingSessionManager(
        apply_overrides(tiny[1], {**BEAM, "decode.beam_width": "16"}),
        tiny[2], tiny[3], CharTokenizer.english(), chunk_frames=64,
        decode="beam", device="cpu")
    with pytest.raises(SnapshotIncompatible, match="fingerprint"):
        wide.import_session(snap)
    other = _beam_mgr(tiny, 1)
    bad = dataclasses.replace(snap, decoder=snap.decoder._replace(
        prefixes=snap.decoder.prefixes[:, :32]))
    with pytest.raises(SnapshotIncompatible, match="beam rows"):
        other.import_session(bad)
    assert other.stats()["active"] == 0
    other.import_session(snap)
    assert other.stats()["active"] == 1


def test_beam_reset_decoders_restarts_one_slot(tiny):
    mgr = _beam_mgr(tiny, 2)
    mgr.join("a")
    mgr.join("b")
    for i in range(3):
        mgr.step({"a": _feat(64, 30 + i), "b": _feat(64, 40 + i)})
    before = mgr.current_texts()
    assert before[0] and before[1]
    mgr.reset_decoders(["a"])
    assert mgr.current_texts() == ["", before[1]]
    assert mgr.partials()["a"] == ""
