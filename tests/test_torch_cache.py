"""The port's ``utils/cache.py`` against the JAX package's: the same
``note`` sequence (on-ladder and off-ladder shapes, a labelled ledger,
preloaded rungs, evictions) gives equal stats, usage scores, hits and
``compiles{rung,replica}`` counters; the rung-usage sidecar written by
either package reads back equal in the other, torn lines skipped; and
``seed_usage`` seeds the same working set.
"""

import json

import pytest
import torch

import deepspeech_tpu.obs as jax_obs
import deepspeech_tpu_torch.obs as port_obs
from deepspeech_tpu.utils import cache as jax_cache
from deepspeech_tpu_torch.utils import cache as port_cache

# One CPU thread for torch: parallel test workers share the machine's
# cores, and a thread pool in each worker oversubscribes them.
torch.set_num_threads(1)

NOTES = [(4, 400, 1200), (4, 400, 900), (8, 800, 5000), (4, 400, 1600),
         (2, 1700, 3000), (16, 1200, 9000), (1, 3400, 2900),
         (8, 800, 6000), (32, 400, 12000), (2, 1700, 2500),
         (4, 400, 1000), (1, 3400, 3300)]


def _ledger(m, obs):
    """Run the note sequence; returns what the comparison reads, with
    the process registry's ``compiles`` counters this run added."""
    before = dict(obs.registry().counters)
    c = m.ShapeBucketCache(max_shapes=4, half_life=3)
    c.labels = {"replica": "r7"}
    added = c.preload([(32, 400), (4, 400)])
    hits = [c.note(*n) for n in NOTES]
    after = obs.registry().counters
    compiles = {k: after[k] - before.get(k, 0) for k in after
                if k.startswith("compiles") and after[k] != before.get(k, 0)}
    return (added, hits, c.stats(), c.rung_usage(), c.compiles,
            c.preloaded, round(c.padding_waste, 12), compiles)


def test_ledger_matches_jax():
    want = _ledger(jax_cache, jax_obs)
    got = _ledger(port_cache, port_obs)
    assert got == want
    added, hits, stats, usage, compiles, *_ = got
    assert stats["evictions"] > 0 and any(hits) and not all(hits)
    assert got[-1] and all('replica="r7"' in k for k in got[-1])


@pytest.mark.parametrize("writer,reader", [(port_cache, jax_cache),
                                           (jax_cache, port_cache)],
                         ids=["port-to-jax", "jax-to-port"])
def test_usage_sidecar_round_trips(tmp_path, writer, reader):
    path = str(tmp_path / "sub" / writer.USAGE_SIDECAR)
    c = writer.ShapeBucketCache(max_shapes=8)
    for n in NOTES[:6]:
        c.note(*n)
    writer.save_rung_usage(c, path, era=1)
    for n in NOTES[6:]:
        c.note(*n)
    rec = writer.save_rung_usage(c, path, era=2)
    with open(path, "a") as fh:
        fh.write('{"event": "rung_usage", "usage": {"4x4')   # a torn tail
    assert json.loads(open(path).readlines()[1])["era"] == 2
    loaded = reader.load_rung_usage(path)
    assert loaded == writer.load_rung_usage(path)
    assert loaded == {tuple(int(x) for x in k.split("x")): v
                      for k, v in rec["usage"].items()}
    seeded = []
    for m in (port_cache, jax_cache):
        fresh = m.ShapeBucketCache(max_shapes=3)
        fresh.note(4, 400, 100)
        seeded.append((m.seed_usage(fresh, loaded), fresh.rung_usage(),
                       fresh.compiles))
    assert seeded[0] == seeded[1]
    assert reader.load_rung_usage(str(tmp_path / "absent.jsonl")) == {}


def test_sidecar_path_stays_in_the_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("DS2_COMPILE_CACHE_DIR", raising=False)
    path = port_cache.usage_sidecar_path()
    assert path.endswith("build/serving/" + port_cache.USAGE_SIDECAR)
    monkeypatch.setenv("DS2_COMPILE_CACHE_DIR", str(tmp_path))
    assert port_cache.usage_sidecar_path() == str(
        tmp_path / port_cache.USAGE_SIDECAR)
    assert port_cache.usage_sidecar_path("x") == "x/" + \
        port_cache.USAGE_SIDECAR
