"""Warm restarts: make the rung ladder ready from a warm store.

The port's own copy of the JAX package's ``serving/warmstore.py``. A
process restart, an autoscale scale-up and a rolling-swap re-admission
all serve their first request on each ``(B, T)`` rung with the rung's
first-use cost (cuDNN and cuBLAS plans, the caching allocator's growth,
the lazy loading of each kernel). :class:`WarmStore` closes that gap
against a :class:`~..utils.aotstore.AotStore`:

- **preload** (:meth:`preload_replica`) — at ``Replica.from_inferencer``
  (and again at autoscale scale-up and rollout re-admission), look up
  every rung of the replica's ``(preset, tier, version)`` under the host
  fingerprint, and for each hit capture the rung's CUDA graph
  (``Inferencer.compile_rung``, ``utils/rung_graph.py``), largest rung
  first into the Inferencer's one graph pool, and install it on the
  Inferencer (``Inferencer.preloaded_forwards``) BEFORE admission. The
  entry's recipe checks the capture: a capture that launched other
  kernels than the recipe records, or another argument shape or kernel
  regime, is a reject and installs nothing. Every rung is counted
  ``compile_cache_{hit,miss,reject}{rung=...,tier=...,replica=...}`` — a
  *reject* is an entry that exists only under a foreign fingerprint, one
  whose argument signature no longer matches, one of another format, or
  one whose capture failed or disagreed. Misses and rejects run the
  eager forward on the card, as the JAX package falls back to jit;
  preload is never fatal. A ``warm_pct`` gauge, one
  ``kind="warm_start"`` postmortem (numeric ``warm_pct`` and
  ``compiles_avoided``; linted by ``tools/check_obs_schema.py``) and a
  ``warm_preload`` timeline event record how warm the replica came up.
- **export** (:meth:`install_export_hook`) — ``Inferencer.export_hook``
  fires once each rung's first eager forward has run and been tallied
  (the JAX store hangs on ``ShapeBucketCache.export_hook``, which fires
  before that forward, when the kernels are not known yet); the rung's
  recipe (``Inferencer.rung_recipe``: the kernels that forward
  launched) is written to the store. No capture in the live process; the next process captures at
  preload. On a background thread by default (``background=False``
  for deterministic runs and tests; call :meth:`flush` either way
  before asserting on the store's contents). :meth:`export_ladder`
  captures the whole ladder offline and records each rung's pool bytes
  too.

The store's tier key is the replica's quality tier when it has one
(``premium``/``bulk``); untiered replicas key by numeric family —
``int8`` for a quantized Inferencer, ``fp`` otherwise — so an int8
recipe is never loaded into a full-precision replica or the other way
round. ``DS2_WARMSTORE_DIR`` (or ``serve.py --warm-store``) makes a
store the process default: ``Replica.from_inferencer`` preloads and
exports through it with no further wiring.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref
from typing import Dict, List, Optional, Tuple

from ..data.infer_bucket import ladder_shapes
from ..obs import timeline as _timeline
from ..resilience import postmortem
from ..utils import aotstore
from ..utils.aotstore import AotStore, StoreKey

logger = logging.getLogger(__name__)

DEFAULT_VERSION = "base"


def store_tier(inferencer, tier: Optional[str]) -> str:
    """The store/counter tier key (module docstring): the replica's
    quality tier, else the numeric family of its backend."""
    if tier:
        return str(tier)
    return "int8" if getattr(inferencer, "_quantized", False) else "fp"


def default_store() -> Optional["WarmStore"]:
    """Process-default store from ``DS2_WARMSTORE_DIR`` (None when
    unset) — the env hook ``serve.py --warm-store`` sets."""
    root = os.environ.get("DS2_WARMSTORE_DIR")
    return WarmStore(root) if root else None


def _platform() -> str:
    import torch

    return "cuda" if torch.cuda.is_available() else "cpu"


def _mismatch(recipe: Dict, graph, inf, b: int, t: int) -> Optional[str]:
    """Why a capture does not meet its entry's recipe, or None."""
    args = [[list(s), d] for s, d in inf.forward_arg_shapes(b, t)]
    if recipe.get("args") != args:
        return f"arguments {recipe.get('args')} != {args}"
    if recipe.get("kernel_regime") != inf.kernel_regime:
        return (f"kernel_regime {recipe.get('kernel_regime')!r} != "
                f"{inf.kernel_regime!r}")
    if recipe.get("kernels") != graph.kernels:
        return f"kernels {recipe.get('kernels')} != captured {graph.kernels}"
    return None


class WarmStore:
    """See module docstring."""

    def __init__(self, root: str, *, preset: str = "",
                 fingerprint: Optional[str] = None,
                 background: bool = True,
                 postmortem_fn=postmortem.record):
        # Entries an offline writer made for THIS platform live under
        # the portable (device-free) fingerprint — accept them as hits
        # rather than rejecting over the missing device axes.
        portable = aotstore.fingerprint_for(_platform())
        self.store = AotStore(root, fingerprint=fingerprint,
                              fallback_fingerprints=(portable,))
        # Preset key override; '' = each inferencer's own cfg.preset.
        self.preset = preset
        self.background = background
        self._postmortem = postmortem_fn
        self._threads: List[threading.Thread] = []
        self._lock = threading.Lock()

    # -- key helpers -----------------------------------------------------
    def _preset_of(self, inferencer) -> str:
        return self.preset or getattr(inferencer.cfg, "preset", "") \
            or "default"

    def _key(self, inferencer, tier: Optional[str],
             version: Optional[str], b: int, t: int) -> StoreKey:
        return StoreKey(self._preset_of(inferencer),
                        store_tier(inferencer, tier),
                        version or DEFAULT_VERSION, int(b), int(t))

    @staticmethod
    def _labels(replica, tier_key: str, rung: str) -> Dict[str, str]:
        # The compile_cache_* family ALWAYS carries rung + tier (the
        # schema lint rejects bare series) — tierless replicas carry
        # their numeric-family tier key, never an empty label.
        lab = dict(replica.labels)
        lab["tier"] = tier_key
        lab["rung"] = rung
        return lab

    @staticmethod
    def _eligible(inf) -> bool:
        return inf is not None and hasattr(inf, "preloaded_forwards")

    # -- preload ---------------------------------------------------------
    def _capture(self, inf, key: StoreKey, recipe: Dict):
        """The rung's graph, captured and held to its recipe, or None
        (logged) where the capture fails or disagrees."""
        b, t = key.batch, key.frames
        try:
            graph = inf.compile_rung(b, t)
        except Exception as e:
            logger.warning("warm store: capture failed for %s (%s: %s) — "
                           "the rung runs the eager forward",
                           key.filename(), type(e).__name__, e)
            return None
        why = _mismatch(recipe, graph, inf, b, t)
        if why is not None:
            logger.warning("warm store: %s does not match its recipe (%s) "
                           "— the rung runs the eager forward",
                           key.filename(), why)
            return None
        return graph

    def preload_replica(self, replica, *, trigger: str = "replica_init",
                        shapes: Optional[List[Tuple[int, int]]] = None
                        ) -> dict:
        """Make the replica's ladder ready from the store before
        admission.

        Returns a summary dict (also written as the ``warm_start``
        postmortem). Replicas without an offline Inferencer backend
        (streaming session factories, streaming-mode Inferencers,
        synthetic test replicas) are ineligible and skipped silently —
        this hook must be safe to call on any replica the autoscaler or
        rollout hands it."""
        inf = getattr(replica, "inferencer", None)
        if not self._eligible(inf):
            return {"eligible": False, "hits": 0}
        if shapes is None:
            shapes = ladder_shapes(inf.cfg.data.bucket_frames,
                                   inf.cfg.data.batch_size)
        tier_key = store_tier(inf, replica.tier)
        version = replica.version or DEFAULT_VERSION
        sig = inf.forward_signature()
        status: Dict[Tuple[int, int], str] = {}
        recipes: Dict[Tuple[int, int], Tuple[StoreKey, Dict]] = {}
        for b, t in shapes:
            key = self._key(inf, replica.tier, version, b, t)
            st, meta, payload = self.store.lookup(key)
            if st == "hit" and meta is not None \
                    and meta.get("sig") and meta["sig"] != sig:
                # Same version label, other weights' shapes or dtypes:
                # reject like a fingerprint mismatch.
                st, payload = "reject", None
            if st == "hit":
                try:
                    recipes[(int(b), int(t))] = (
                        key, aotstore.deserialize_entry(meta, payload))
                except ValueError as e:
                    logger.warning(
                        "warm store: %s is not a recipe (%s) — the rung "
                        "runs the eager forward", key.filename(), e)
                    st = "reject"
            status[(int(b), int(t))] = st
        # Largest rung first: the one graph pool is sized by it, and the
        # smaller rungs reuse its memory.
        loaded: List[Tuple[int, int]] = []
        for rung in sorted(recipes, key=lambda r: (r[0] * r[1], r),
                           reverse=True):
            graph = self._capture(inf, *recipes[rung])
            if graph is None:
                status[rung] = "reject"
                continue
            inf.preloaded_forwards[rung] = graph
            loaded.append(rung)
        hits = misses = rejects = 0
        for b, t in shapes:
            st = status[(int(b), int(t))]
            rung = self._key(inf, replica.tier, version, b, t).rung
            if st == "hit":
                hits += 1
            elif st == "reject":
                rejects += 1
            else:
                st = "miss"
                misses += 1
            replica.telemetry.count(
                f"compile_cache_{st}",
                labels=self._labels(replica, tier_key, rung))
        if loaded:
            inf.shape_cache.preload(loaded)
        warm_pct = round(100.0 * hits / max(len(shapes), 1), 3)
        gauge_labels = dict(replica.labels)
        gauge_labels["tier"] = tier_key
        replica.telemetry.gauge("warm_pct", warm_pct,
                                labels=gauge_labels)
        summary = {"eligible": True, "replica": replica.rid,
                   "tier": tier_key, "version": version,
                   "rungs": len(shapes), "hits": hits,
                   "misses": misses, "rejects": rejects,
                   "warm_pct": warm_pct, "compiles_avoided": hits}
        self._postmortem(
            "warm_start", trigger=trigger, replica=replica.rid,
            tier=tier_key, version=version, rungs=len(shapes),
            warm_pct=warm_pct, compiles_avoided=hits,
            misses=misses, rejects=rejects)
        _timeline.publish(
            "warm_preload", "warmstore", replica=replica.rid,
            tier=tier_key, cause_seq=_timeline.last_for(replica.rid),
            trigger=trigger, warm_pct=warm_pct,
            compiles_avoided=hits, rungs=len(shapes))
        return summary

    # -- export ----------------------------------------------------------
    def install_export_hook(self, replica) -> bool:
        """First use -> recipe: arm the replica's ``Inferencer.export_hook``
        so the recipe of every rung first used at run time lands in the
        store (the next restart preloads it)."""
        inf = getattr(replica, "inferencer", None)
        if not self._eligible(inf):
            return False
        # Weak: the Inferencer holds the hook and the replica holds the
        # Inferencer, so a strong reference would leave a retired
        # replica's weights and graph pool to the cyclic GC.
        ref = weakref.ref(replica)

        def write(b: int, t: int) -> None:
            rep = ref()
            if rep is None:
                return
            if self.background:
                th = threading.Thread(
                    target=self._export_rung, args=(rep, b, t),
                    name=f"warmstore-export-{b}x{t}", daemon=True)
                with self._lock:
                    self._threads.append(th)
                th.start()
            else:
                self._export_rung(rep, b, t)

        inf.export_hook = write
        return True

    def _export_rung(self, replica, b: int, t: int, graph=None) -> None:
        """Write one rung's recipe: the first use's tally, or, with
        ``graph`` (``export_ladder``), the capture's kernels and pool
        bytes."""
        inf = getattr(replica, "inferencer", None)
        if inf is None:
            return
        tier_key = store_tier(inf, replica.tier)
        key = self._key(inf, replica.tier,
                        replica.version or DEFAULT_VERSION, b, t)
        try:
            recipe = inf.rung_recipe(b, t)
            if graph is not None:
                recipe["kernels"] = dict(graph.kernels)
                recipe["pool_bytes"] = graph.pool_bytes
            if recipe["kernels"] is None:
                raise ValueError("the rung has not been used")
            self.store.put(key, aotstore.serialize_recipe(recipe),
                           aotstore.FORMAT_GRAPH,
                           sig=inf.forward_signature())
        except Exception as e:
            # Export is opportunistic: a full disk must never take the
            # serving path down.
            logger.warning("warm store: export failed for %s (%s: %s)",
                           key.filename(), type(e).__name__, e)
            return
        replica.telemetry.count(
            "compile_cache_export",
            labels=self._labels(replica, tier_key, key.rung))

    def export_ladder(self, replica,
                      shapes: Optional[List[Tuple[int, int]]] = None
                      ) -> int:
        """Capture and record a replica's whole ladder offline, largest
        rung first (the runtime populate). The graphs are not installed.
        Returns how many rungs were written."""
        inf = getattr(replica, "inferencer", None)
        if not self._eligible(inf):
            return 0
        if shapes is None:
            shapes = ladder_shapes(inf.cfg.data.bucket_frames,
                                   inf.cfg.data.batch_size)
        n0 = len(self.store.keys())
        for b, t in sorted(shapes, key=lambda r: (r[0] * r[1], r),
                           reverse=True):
            self._export_rung(replica, b, t, graph=inf.compile_rung(b, t))
        return len(self.store.keys()) - n0

    def flush(self, timeout: float = 60.0) -> None:
        """Join pending background exports (runs and tests that assert
        on the store's contents; the serving loop never needs to)."""
        with self._lock:
            threads, self._threads = self._threads, []
        for th in threads:
            th.join(timeout)
