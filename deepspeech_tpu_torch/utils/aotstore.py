"""Fingerprinted on-disk store of the serving ladder's rung recipes.

The port's own copy of the JAX package's ``utils/aotstore.py``: the same
key schema, fingerprint directories, meta line, ``sig`` and hit / reject /
miss contract, so a restarted (or freshly scaled-up) replica can make
its whole ``(B, T)`` rung ladder ready before admission instead of
paying each rung's first use on a live request
(``serving/warmstore.py`` is the runtime plane on top).

Key schema — one entry per ``(preset, tier, model version, rung (B,
T))`` under a *fingerprint* directory::

    <root>/<fp-hash>/<preset>--<tier>--<version>--b{B}xt{T}.wse
    <root>/<fp-hash>/FINGERPRINT          # the full fingerprint string

The fingerprint (:func:`host_fingerprint`) carries the torch and CUDA
versions, the driver, the device's name, capability and SM count, and
the digests of the kernel libraries ``ops/_build.py`` builds: an entry
written under another card, toolchain or kernel source lives in another
directory, and a lookup counts it as a *reject* without reading it.

Entry file format: one JSON meta line, ``\\n``, then the payload::

    {"format": "cuda_graph", "preset": ..., "tier": ..., "version": ...,
     "batch": B, "frames": T, "fingerprint": ..., "sig": ...}

The one format, ``"cuda_graph"``, holds a **capture recipe**, not an
executable: a CUDA graph cannot be written to disk, and the ctypes
kernel calls (``ops/gru.py``) are opaque to ``torch.export``. The recipe
(JSON) records the rung's argument shapes and dtypes, the model's
``kernel_regime``, the kernels one forward at that rung launched with
their counts, and the graph pool's bytes where the writer captured the
rung. Reading it is cheap; the work is done at load, where the
warm store captures the rung's graph (``utils/rung_graph.py``) before
the replica takes traffic and holds the capture to the recipe. This is
the JAX ``"hlo"`` format's contract: deserialize is cheap, the first
use of the shape pays at load. An entry of another format (the JAX
package's ``"xc"`` or ``"hlo"``) makes :func:`deserialize_entry` raise
``ValueError``, which the warm store counts as a reject.

``sig`` is a hash of the model's state-dict names, shapes and dtypes
(:func:`module_signature`): a checkpoint that changed shape under an
unchanged version label is rejected, not captured.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import platform
import re
import tempfile
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

ENTRY_SUFFIX = ".wse"
FORMAT_GRAPH = "cuda_graph"

_SAFE = re.compile(r"[^A-Za-z0-9_.-]+")


def _safe(part: str) -> str:
    """Filename-safe key component ('' -> 'none': the key positions
    are structural, an empty component would make names unparseable)."""
    part = _SAFE.sub("_", str(part))
    return part or "none"


def _kernels_digest() -> str:
    """One digest over the kernel libraries' names ``ops/_build.py``
    would build (``lib<name>-<hash>.so``: each hash covers the source,
    its headers and the nvcc flags). Reads the sources, compiles
    nothing."""
    from ..ops import _build

    names = [os.path.basename(_build._target(n))
             for n in _build.all_sources()]
    return hashlib.sha256(",".join(names).encode()).hexdigest()[:16]


def _driver_version() -> str:
    """The CUDA driver's version (``cuDriverGetVersion``), or
    "unknown"."""
    import ctypes

    try:
        lib = ctypes.CDLL("libcuda.so.1")
        v = ctypes.c_int()
        if lib.cuDriverGetVersion(ctypes.byref(v)) == 0:
            return str(v.value)
    except OSError:
        pass
    return "unknown"


def _versions() -> str:
    import torch

    return f"torch={torch.__version__}|cuda={torch.version.cuda or 'none'}"


def host_fingerprint(device=None) -> str:
    """The fingerprint of this process's host for the store's entries.

    On a card (``device``, default the current CUDA device): the torch
    and CUDA versions, the driver, the device's name, capability and SM
    count, and the kernel libraries' digests. Without CUDA: the versions,
    ``plat=cpu`` and the machine type."""
    import torch

    if not torch.cuda.is_available():
        return (_versions() + f"|plat=cpu|machine={platform.machine()}")
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if device is None else torch.device(device)
    p = torch.cuda.get_device_properties(dev)
    return (_versions() + f"|driver={_driver_version()}|plat=cuda"
            f"|device={p.name}|cc={p.major}.{p.minor}"
            f"|sms={p.multi_processor_count}|kernels={_kernels_digest()}")


def fingerprint_for(platform_name: str) -> str:
    """The portable fingerprint of a *target* platform ("cuda" or
    "cpu"): the versions and the platform, without the driver or device
    axes — the entries an offline writer made for that platform, which
    the warm store registers as a fallback hit. The kernel digests stay
    on "cuda": a recipe names the kernels a forward launches."""
    fp = _versions() + f"|plat={platform_name}"
    if platform_name == "cuda":
        fp += f"|kernels={_kernels_digest()}"
    return fp


def _fp_hash(fp: str) -> str:
    return hashlib.sha256(fp.encode()).hexdigest()[:16]


def module_signature(state) -> str:
    """Names, shapes and dtypes of a state dict (the int8 leaves'
    ``q``/``scale`` included), hashed — cheap (no device reads), and
    exactly what a captured forward's calling convention needs."""
    blob = ";".join(f"{name}:{tuple(t.shape)}:{str(t.dtype)}"
                    for name, t in state.items())
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclass(frozen=True)
class StoreKey:
    """One rung's identity (the fingerprint is the directory, not part
    of the key)."""

    preset: str
    tier: str
    version: str
    batch: int
    frames: int

    @property
    def rung(self) -> str:
        return f"{self.batch}x{self.frames}"

    def filename(self) -> str:
        return (f"{_safe(self.preset)}--{_safe(self.tier)}--"
                f"{_safe(self.version)}--b{int(self.batch)}x"
                f"t{int(self.frames)}{ENTRY_SUFFIX}")


_FNAME = re.compile(
    r"^(?P<preset>[^-]+(?:-[^-]+)*?)--(?P<tier>[^-]+(?:-[^-]+)*?)--"
    r"(?P<version>[^-]+(?:-[^-]+)*?)--b(?P<batch>\d+)xt(?P<frames>\d+)"
    + re.escape(ENTRY_SUFFIX) + "$")


def parse_filename(name: str) -> Optional[StoreKey]:
    m = _FNAME.match(name)
    if not m:
        return None
    return StoreKey(m.group("preset"), m.group("tier"),
                    m.group("version"), int(m.group("batch")),
                    int(m.group("frames")))


class AotStore:
    """Directory-backed recipe store (see module docstring).

    ``lookup`` and ``rungs`` never raise where the serving path calls
    them: a corrupt or half-written entry is a miss, never a crash —
    restarts must not be hostage to the store.
    """

    def __init__(self, root: str, fingerprint: Optional[str] = None,
                 fallback_fingerprints: Tuple[str, ...] = ()):
        self.root = str(root)
        self.fingerprint = fingerprint or host_fingerprint()
        self.fp_dir = os.path.join(self.root, _fp_hash(self.fingerprint))
        # Additional fingerprints a lookup treats as hits (the warm
        # store registers its platform's portable fingerprint). Writes
        # only ever land under the primary fingerprint.
        self.fallback_dirs = [
            os.path.join(self.root, _fp_hash(fp))
            for fp in fallback_fingerprints
            if fp and fp != self.fingerprint]

    # -- writing ---------------------------------------------------------
    def put(self, key: StoreKey, payload: bytes, fmt: str,
            sig: str = "", **meta_extra) -> str:
        """Atomically write one entry; returns its path. The meta line
        restates the key and the full fingerprint so an entry is
        self-describing even when moved between roots."""
        if fmt != FORMAT_GRAPH:
            raise ValueError(f"unknown store format {fmt!r}")
        os.makedirs(self.fp_dir, exist_ok=True)
        marker = os.path.join(self.fp_dir, "FINGERPRINT")
        if not os.path.exists(marker):
            with open(marker, "w") as fh:
                fh.write(self.fingerprint + "\n")
        meta = {"format": fmt, "preset": key.preset, "tier": key.tier,
                "version": key.version, "batch": int(key.batch),
                "frames": int(key.frames),
                "fingerprint": self.fingerprint, "sig": sig,
                "created": round(time.time(), 3), **meta_extra}
        path = os.path.join(self.fp_dir, key.filename())
        fd, tmp = tempfile.mkstemp(dir=self.fp_dir,
                                   suffix=ENTRY_SUFFIX + ".tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(json.dumps(meta).encode() + b"\n")
                fh.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    # -- reading ---------------------------------------------------------
    @staticmethod
    def _read_meta(fh) -> Optional[dict]:
        meta = json.loads(fh.readline().decode())
        return meta if isinstance(meta, dict) else None

    @classmethod
    def _read_entry(cls, path: str) -> Optional[Tuple[dict, bytes]]:
        try:
            with open(path, "rb") as fh:
                meta = cls._read_meta(fh)
                return None if meta is None else (meta, fh.read())
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    @classmethod
    def _read_header(cls, path: str) -> Optional[dict]:
        """The meta line alone: a foreign entry's payload is never
        read."""
        try:
            with open(path, "rb") as fh:
                return cls._read_meta(fh)
        except (OSError, ValueError, UnicodeDecodeError):
            return None

    def get(self, key: StoreKey) -> Optional[Tuple[dict, bytes]]:
        """(meta, payload) for ``key`` under THIS fingerprint, or
        None."""
        return self._read_entry(os.path.join(self.fp_dir,
                                             key.filename()))

    def lookup(self, key: StoreKey
               ) -> Tuple[str, Optional[dict], Optional[bytes]]:
        """('hit', meta, payload) | ('reject', meta, None) |
        ('miss', None, None).

        A *reject* means the entry exists under a DIFFERENT fingerprint
        only — the card, toolchain or kernels it was recorded for are not
        this process's: the caller falls back to the eager forward and
        counts it, and only the foreign entry's meta line is read."""
        got = self.get(key)
        if got is not None:
            return "hit", got[0], got[1]
        for d in self.fallback_dirs:
            entry = self._read_entry(os.path.join(d, key.filename()))
            if entry is not None:
                return "hit", entry[0], entry[1]
        try:
            subdirs = (os.listdir(self.root)
                       if os.path.isdir(self.root) else [])
        except OSError:
            subdirs = []
        for sub in sorted(subdirs):
            d = os.path.join(self.root, sub)
            if (d == self.fp_dir or d in self.fallback_dirs
                    or not os.path.isdir(d)):
                continue
            p = os.path.join(d, key.filename())
            if os.path.exists(p):
                return "reject", self._read_header(p), None
        return "miss", None, None

    def keys(self) -> List[StoreKey]:
        """Every parseable entry under this fingerprint."""
        try:
            names = sorted(os.listdir(self.fp_dir))
        except OSError:
            return []
        out = []
        for name in names:
            key = parse_filename(name)
            if key is not None:
                out.append(key)
        return out

    def rungs(self, preset: str, tier: str, version: str
              ) -> List[Tuple[int, int]]:
        """Stored ``(B, T)`` rungs for one (preset, tier, version)."""
        return sorted((k.batch, k.frames) for k in self.keys()
                      if (k.preset, k.tier, k.version)
                      == (_safe(preset), _safe(tier), _safe(version)))


# -- the recipe codec ------------------------------------------------------

def serialize_recipe(recipe: Dict) -> bytes:
    """``"cuda_graph"``: a rung's capture recipe as JSON bytes."""
    return json.dumps(recipe, sort_keys=True).encode()


def deserialize_entry(meta: dict, payload: bytes) -> Dict:
    """Format-dispatched deserialize -> the entry's recipe dict. Raises
    ``ValueError`` for another format or a payload that is not a
    recipe."""
    fmt = meta.get("format")
    if fmt != FORMAT_GRAPH:
        raise ValueError(f"unknown store format {fmt!r}")
    recipe = json.loads(payload.decode())
    if not isinstance(recipe, dict):
        raise ValueError("a cuda_graph entry holds a recipe object")
    return recipe
