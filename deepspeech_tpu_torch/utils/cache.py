"""Compiled-shape accounting for the bucketed infer path.

The port's own copy of the JAX package's ``utils/cache.py``
``ShapeBucketCache`` and its rung-usage sidecar (stdlib only). The JAX
package's persistent XLA compile cache has no counterpart: nothing here
compiles per shape. In the port a "compile" is a rung's first use —
cuDNN and cuBLAS plan for the new ``(B, T)`` and the caching allocator
grows for it — so the ledger counts first uses, and the serving plane
reads the same counters, labels and usage feedback from either package.
"""

from __future__ import annotations

import json
import logging
import os
import time

logger = logging.getLogger(__name__)

# The sidecar's default home: ``build/serving`` beside the package, a
# directory ``.gitignore`` lists.
_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "build", "serving")


def resolve_cache_dir(cache_dir: "str | None" = None) -> str:
    """The sidecar directory: ``cache_dir``, else
    ``DS2_COMPILE_CACHE_DIR``, else ``build/serving`` beside the
    package."""
    return (cache_dir or os.environ.get("DS2_COMPILE_CACHE_DIR")
            or _DEFAULT_DIR)


class ShapeBucketCache:
    """Rung ledger for the bucketed infer path.

    It gives the serving loop (a) visibility — how many rungs this
    engine has warmed and how much of the computed volume was padding —
    and (b) a bound — a caller feeding off-ladder shapes turns the shape
    ladder into a stream of first uses, each a cuDNN/cuBLAS plan and an
    allocator growth. ``note()`` before every forward call records the
    ``(B, T)`` shape and the real-frame count, and when the
    distinct-shape set exceeds ``max_shapes`` (the planner's ladder
    size) it warns once per offending shape — loud enough to catch a
    planner bypass, non-fatal so overflow rungs (long audio beyond the
    largest edge) still serve.

    The working set is additionally *time-decayed* on a logical clock
    (one tick per ``note``): each shape's usage score halves every
    ``half_life`` calls since it was last seen, and when the working
    set outgrows ``max_shapes`` the COLDEST shape is evicted from it
    (and the warning fires, as before). Eviction is ledger-side only —
    nothing gets freed — so ``compiles``/``hits`` stay cumulative
    truths while ``rung_usage()``/``live_shapes`` describe the
    *recently hot* ladder, the feedback signal the serving gateway's
    rung chooser reads (serving/scheduler.warm_rung_chooser).

    Counters:
      compiles       distinct shapes ever seen (each one's first use)
      hits           calls that reused an already-seen shape
      evictions      cold shapes dropped from the working set
      padded_frames  total B*T frames computed
      valid_frames   real (pre-padding) frames among them
      padding_waste  1 - valid/padded, the headline waste fraction
    """

    def __init__(self, max_shapes: int = 0, half_life: int = 256):
        if half_life <= 0:
            raise ValueError(f"half_life must be positive, got {half_life}")
        self.max_shapes = max_shapes
        self.half_life = half_life
        # Extra labels merged into every compile event this ledger
        # reports — a pooled replica sets {"replica": rid} so compiles
        # attribute per replica (serving/replica.py).
        self.labels: "dict[str, str] | None" = None
        # First-use hook: called as ``export_hook(batch, frames)`` right
        # after a fresh shape is recorded, before that shape's first
        # forward (the JAX warm store's export point). The port's warm
        # store exports from ``Inferencer.export_hook`` instead, once
        # that forward's launches are tallied; ``preload`` below marks
        # the rungs it captured (serving/warmstore.py). Never fatal
        # (see note()).
        self.export_hook = None
        self._tick = 0
        self._use: "dict[tuple, float]" = {}   # decayed usage score
        self._last: "dict[tuple, int]" = {}    # last-seen tick
        self._ever: "set[tuple]" = set()
        # Shapes warmed BEFORE any traffic: they are hits from call
        # one and never fire a compile event — but they are not
        # counted in ``compiles`` either, because no first use
        # happened at run time (the whole point of preloading).
        self._preloaded: "set[tuple]" = set()
        self.hits = 0
        self.evictions = 0
        self.padded_frames = 0
        self.valid_frames = 0

    def _decayed(self, key: tuple) -> float:
        return self._use[key] * 0.5 ** (
            (self._tick - self._last[key]) / self.half_life)

    def note(self, batch: int, frames: int, valid_frames: int) -> bool:
        """Record one forward call; returns True on a shape hit."""
        key = (int(batch), int(frames))
        self._tick += 1
        hit = key in self._ever or key in self._preloaded
        if hit:
            self.hits += 1
        else:
            self._ever.add(key)
            # First sight of this (B, T) == one first use: attribute it
            # (rung + labels) via the observability layer. Never fatal:
            # the ledger must keep counting even if obs is mid-teardown.
            try:
                from .. import obs

                obs.compile_event(*key, labels=self.labels)
            except Exception:
                pass
            if self.export_hook is not None:
                try:
                    self.export_hook(*key)
                except Exception:
                    logger.debug("shape-cache export hook failed for "
                                 "B=%d T=%d", *key, exc_info=True)
        self._use[key] = (self._decayed(key) if key in self._use
                          else 0.0) + 1.0
        self._last[key] = self._tick
        if self.max_shapes and len(self._use) > self.max_shapes:
            cold = min((k for k in self._use if k != key),
                       key=self._decayed)
            logger.warning(
                "infer shape cache grew past the ladder: %d shapes > "
                "max_shapes=%d (new shape B=%d T=%d) — off-ladder "
                "batches re-plan; route requests through "
                "data/infer_bucket.plan_infer_buckets "
                "(evicting cold rung B=%d T=%d, usage %.3f)",
                len(self._use), self.max_shapes, *key, *cold,
                self._decayed(cold))
            del self._use[cold]
            del self._last[cold]
            self.evictions += 1
        self.padded_frames += int(batch) * int(frames)
        self.valid_frames += int(valid_frames)
        return hit

    def preload(self, shapes, score: float = 1.0) -> int:
        """Mark ``(B, T)`` shapes as already warmed: their first
        ``note()`` is a hit, fires no compile event, and ``compiles``
        stays at the number of first uses at run time — zero for a
        fully preloaded ladder. Returns how many shapes were newly marked."""
        added = 0
        for b, t in shapes:
            key = (int(b), int(t))
            if key in self._preloaded or key in self._ever:
                continue
            self._preloaded.add(key)
            if key not in self._use:
                self._use[key] = float(score)
                self._last[key] = self._tick
            added += 1
        return added

    @property
    def compiles(self) -> int:
        return len(self._ever)

    @property
    def preloaded(self) -> int:
        return len(self._preloaded)

    @property
    def padding_waste(self) -> float:
        if not self.padded_frames:
            return 0.0
        return 1.0 - self.valid_frames / self.padded_frames

    def rung_usage(self) -> "dict[tuple, float]":
        """Decayed usage score per live ``(B, T)`` rung — the warm-set
        feedback the gateway's rung chooser consumes."""
        return {k: round(self._decayed(k), 6) for k in self._use}

    def stats(self) -> dict:
        """JSONL-ready counter snapshot."""
        return {
            "compiles": self.compiles,
            "hits": self.hits,
            "evictions": self.evictions,
            "preloaded": self.preloaded,
            "max_shapes": self.max_shapes,
            "shapes": sorted(self._ever),
            "live_shapes": sorted(self._use),
            "padded_frames": self.padded_frames,
            "valid_frames": self.valid_frames,
            "padding_waste": round(self.padding_waste, 6),
        }


# -- rung-usage persistence (warm_rung_chooser restart seeding) ----------

USAGE_SIDECAR = "rung_usage.jsonl"


def usage_sidecar_path(cache_dir: "str | None" = None) -> str:
    """The rung-usage sidecar's path under :func:`resolve_cache_dir`."""
    return os.path.join(resolve_cache_dir(cache_dir), USAGE_SIDECAR)


def save_rung_usage(cache: ShapeBucketCache, path: str,
                    **extra) -> dict:
    """Append one JSONL snapshot of ``cache.rung_usage()`` — a restart
    seeds ``warm_rung_chooser`` from it (:func:`load_rung_usage`) so
    the hot-rung routing signal survives the process. Appending (not
    rewriting) keeps earlier eras readable for forensics; the loader
    merges last-wins."""
    usage = {f"{b}x{t}": score
             for (b, t), score in cache.rung_usage().items()}
    rec = {"event": "rung_usage", "ts": round(time.time(), 3),
           "usage": usage, **extra}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return rec


def load_rung_usage(path: str) -> "dict[tuple, float]":
    """Merged ``{(B, T): score}`` from a sidecar, newest era winning
    per rung. Tolerant by contract: an absent file, a torn tail line,
    or mixed-era records (an older writer's shapes) must never block a
    restart — unreadable lines are skipped, unparseable rungs dropped.
    """
    usage: "dict[tuple, float]" = {}
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return usage
    for line in lines:
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict) \
                or not isinstance(rec.get("usage"), dict):
            continue
        for rung, score in rec["usage"].items():
            try:
                b, t = str(rung).split("x", 1)
                usage[(int(b), int(t))] = float(score)
            except (TypeError, ValueError):
                continue
    return usage


def seed_usage(cache: ShapeBucketCache,
               usage: "dict[tuple, float]") -> int:
    """Seed a fresh ledger's working set from persisted usage — the
    routing signal ONLY: seeded rungs are not marked warmed (their first
    use still happens and must be counted), they
    just rank as warm for the chooser. Bounded by ``max_shapes`` (top
    scores win) so a stale fat sidecar can't trigger evictions."""
    ranked = sorted(usage.items(), key=lambda kv: -kv[1])
    if cache.max_shapes:
        ranked = ranked[:cache.max_shapes]
    seeded = 0
    for (b, t), score in ranked:
        key = (int(b), int(t))
        if key in cache._use:
            continue
        cache._use[key] = float(score)
        cache._last[key] = cache._tick
        seeded += 1
    return seeded
