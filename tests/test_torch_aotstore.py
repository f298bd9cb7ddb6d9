"""The port's rung store (``deepspeech_tpu_torch/utils/aotstore.py``)
against the JAX package's ``utils/aotstore.py``:

- ``StoreKey`` filenames and ``parse_filename`` equal JAX's, letter for
  letter, unsafe components included;
- ``put``/``lookup`` give the same hit / reject / miss sequence as JAX's
  on the same script (a foreign fingerprint a reject, the portable
  fallback a hit, a corrupt entry a miss), and ``keys``/``rungs`` agree;
- an entry the JAX store wrote in the same root is a reject for the
  port's store and its payload is never read; a JAX-format entry copied
  under the port's fingerprint does not deserialize (``ValueError``);
- the fingerprints, ``module_signature`` and the recipe codec.
"""

import json

import numpy as np
import pytest
import torch

from deepspeech_tpu.utils import aotstore as jax_aot
from deepspeech_tpu_torch.config import get_config
from deepspeech_tpu_torch.models.ds2 import DeepSpeech2
from deepspeech_tpu_torch.utils import aotstore as port_aot

torch.set_num_threads(1)

KEYS = [("dev_slice", "fp", "base", 8, 1700),
        ("ds2_small", "premium", "v2", 32, 400),
        ("pre set/x", "", "ckpt:42", 1, 64),
        ("a-b", "bulk", "v-1", 2, 800),
        ("", "int8", "", 16, 1200),
        ("ds2_small", "tier with spaces", "run#7/step 9", 4, 64)]


@pytest.mark.parametrize("key", KEYS, ids=[k[0] + "|" + k[2] for k in KEYS])
def test_storekey_filename_and_parse_match_jax(key):
    jk, pk = jax_aot.StoreKey(*key), port_aot.StoreKey(*key)
    assert pk.filename() == jk.filename()
    assert pk.rung == jk.rung
    want = jax_aot.parse_filename(jk.filename())
    got = port_aot.parse_filename(pk.filename())
    assert (got.preset, got.tier, got.version, got.batch, got.frames) == (
        want.preset, want.tier, want.version, want.batch, want.frames)


@pytest.mark.parametrize("name", [
    "not-an-entry.bin", "p--fp--base--b8xt1700.wse",
    "p--fp--base--b8x1700.wse", "a-b--c-d--e-f--b1xt2.wse",
    "p--fp--base--b8xt1700.wse.tmp", "--fp--base--b1xt1.wse"])
def test_parse_filename_matches_jax(name):
    want, got = jax_aot.parse_filename(name), port_aot.parse_filename(name)
    assert (got is None) == (want is None)
    if want is not None:
        assert got.filename() == want.filename()


def _script(aot, root, fmt):
    """The JAX test's lookup script on one package's store: returns the
    statuses, payloads, meta fields, keys and rungs it observed."""
    key = aot.StoreKey("p", "fp", "base", 2, 64)
    other = aot.StoreKey("p", "fp", "base", 4, 64)
    a = aot.AotStore(root + "/a", fingerprint="fp-A")
    a.put(key, b"payload-bytes", fmt, sig="s1")
    out = []
    for store, k in ((a, key), (aot.AotStore(root + "/a",
                                             fingerprint="fp-B"), key),
                     (a, other), (aot.AotStore(root + "/a",
                                               fingerprint="fp-B"), other)):
        st, meta, payload = store.lookup(k)
        out.append((st, payload, meta and (meta["sig"],
                                           meta["fingerprint"])))
    out.append([k.filename() for k in a.keys()])
    out.append(a.rungs("p", "fp", "base"))
    # The portable fallback is a hit; without it the entry rejects.
    emitter = aot.AotStore(root + "/b", fingerprint="portable")
    emitter.put(key, b"portable-bytes", fmt)
    runtime = aot.AotStore(root + "/b", fingerprint="host",
                           fallback_fingerprints=("portable",))
    out.append(runtime.lookup(key)[::2])
    out.append(aot.AotStore(root + "/b", fingerprint="host").lookup(
        key)[::2])
    # A corrupt entry is a miss, never a crash.
    c = aot.AotStore(root + "/c", fingerprint="fp-A")
    path = c.put(key, b"ok", fmt)
    with open(path, "wb") as fh:
        fh.write(b"\x00not json at all")
    out.append((c.lookup(key)[0], c.get(key)))
    with pytest.raises(ValueError):
        c.put(key, b"x", "elf")
    return out


def test_put_lookup_script_matches_jax(tmp_path):
    want = _script(jax_aot, str(tmp_path / "jax"), jax_aot.FORMAT_EXECUTABLE)
    got = _script(port_aot, str(tmp_path / "port"), port_aot.FORMAT_GRAPH)
    assert got == want
    assert [s for s, _, _ in got[:4]] == ["hit", "reject", "miss", "miss"]
    assert got[6] == ("hit", b"portable-bytes") and got[7][0] == "reject"
    assert got[8] == ("miss", None)


def test_put_writes_fingerprint_marker_and_meta(tmp_path):
    store = port_aot.AotStore(str(tmp_path), fingerprint="fp-A")
    key = port_aot.StoreKey("p", "fp", "base", 1, 64)
    path = store.put(key, b"{}", port_aot.FORMAT_GRAPH, sig="s", extra=3)
    with open(tmp_path / port_aot._fp_hash("fp-A") / "FINGERPRINT") as fh:
        assert fh.read() == "fp-A\n"
    with open(path, "rb") as fh:
        meta = json.loads(fh.readline())
        assert fh.read() == b"{}"
    assert {k: meta[k] for k in ("format", "preset", "tier", "version",
                                 "batch", "frames", "fingerprint", "sig",
                                 "extra")} == {
        "format": "cuda_graph", "preset": "p", "tier": "fp",
        "version": "base", "batch": 1, "frames": 64,
        "fingerprint": "fp-A", "sig": "s", "extra": 3}
    assert not [p for p in tmp_path.rglob("*.tmp")]


def test_jax_entry_in_the_same_root_is_a_reject_never_read(tmp_path,
                                                           monkeypatch):
    """An entry the JAX store wrote (under its own fingerprint) is only
    a meta line away: the port's lookup rejects it and reads no byte of
    its payload."""
    root = str(tmp_path / "store")
    jkey = jax_aot.StoreKey("ds2_small", "fp", "base", 2, 64)
    jstore = jax_aot.AotStore(root)
    jpath = jstore.put(jkey, b"\x80jax-executable" * 64,
                       jax_aot.FORMAT_EXECUTABLE, sig="jsig")
    read = []
    real = port_aot.AotStore._read_entry.__func__

    def spy(cls, path):
        read.append(path)
        return real(cls, path)

    monkeypatch.setattr(port_aot.AotStore, "_read_entry",
                        classmethod(spy))
    store = port_aot.AotStore(root)
    key = port_aot.StoreKey("ds2_small", "fp", "base", 2, 64)
    assert store.fingerprint != jstore.fingerprint
    status, meta, payload = store.lookup(key)
    assert (status, payload) == ("reject", None)
    assert meta["format"] == "xc" and meta["sig"] == "jsig"
    assert jpath not in read
    assert store.keys() == [] and store.get(key) is None


@pytest.mark.parametrize("fmt", ["xc", "hlo", "elf", None])
def test_foreign_format_does_not_deserialize(tmp_path, fmt):
    """A JAX ``"xc"``/``"hlo"`` entry copied under the port's own
    fingerprint is a hit at lookup; ``deserialize_entry`` refuses it
    (the warm store counts that as a reject)."""
    store = port_aot.AotStore(str(tmp_path), fingerprint="fp")
    key = port_aot.StoreKey("p", "fp", "base", 1, 64)
    path = store.put(key, b"payload", port_aot.FORMAT_GRAPH)
    with open(path, "rb") as fh:
        meta = json.loads(fh.readline())
    meta["format"] = fmt
    with open(path, "wb") as fh:
        fh.write(json.dumps(meta).encode() + b"\n" + b"\x80pickled")
    status, meta, payload = store.lookup(key)
    assert status == "hit"
    with pytest.raises(ValueError, match="unknown store format"):
        port_aot.deserialize_entry(meta, payload)


def test_recipe_codec_round_trip():
    recipe = {"args": [[[2, 64, 13], "float32"], [[2], "int64"]],
              "kernel_regime": "fp", "kernels": {"gru_fwd": 3},
              "pool_bytes": 1463812096}
    blob = port_aot.serialize_recipe(recipe)
    meta = {"format": port_aot.FORMAT_GRAPH}
    assert port_aot.deserialize_entry(meta, blob) == recipe
    for bad in (b"[1, 2]", b"\xff\xfe", b"{torn"):
        with pytest.raises(ValueError):
            port_aot.deserialize_entry(meta, bad)


def test_fingerprints_on_the_cpu():
    host = port_aot.host_fingerprint()
    assert host.startswith(f"torch={torch.__version__}|")
    assert "plat=cpu" in host and "machine=" in host
    portable = port_aot.fingerprint_for("cuda")
    assert "plat=cuda" in portable and "kernels=" in portable
    for axis in ("driver=", "device=", "sms=", "machine="):
        assert axis not in portable
    assert port_aot.fingerprint_for("cpu") != portable
    # The kernel digest moves with a kernel source's name (its hash).
    assert port_aot._kernels_digest() == port_aot._kernels_digest()


def test_module_signature_tracks_names_shapes_dtypes():
    sig = port_aot.module_signature
    t1 = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    t2 = {"w": torch.ones(3, 4), "b": torch.full((4,), 7.0)}
    t3 = {"w": torch.zeros(3, 5), "b": torch.zeros(4)}
    t4 = {"w": torch.zeros(3, 4, dtype=torch.int8), "b": torch.zeros(4)}
    t5 = {"v": torch.zeros(3, 4), "b": torch.zeros(4)}
    assert sig(t1) == sig(t2)           # values don't matter
    assert len({sig(t1), sig(t3), sig(t4), sig(t5)}) == 4
    cfg = get_config("dev_slice")
    fp = DeepSpeech2(cfg.model, 13).state_dict()
    q = DeepSpeech2(cfg.model, 13, quantized=True).state_dict()
    assert sig(fp) != sig(q)            # the int8 leaves count
    assert any(v.dtype == torch.int8 for v in q.values())
    assert sig(fp) == sig({k: v.clone() for k, v in fp.items()})
    np.testing.assert_equal(len(sig(fp)), 16)
