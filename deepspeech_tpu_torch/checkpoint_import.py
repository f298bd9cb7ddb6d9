"""Read a training step written by the JAX package's orbax
``CheckpointManager``, so a model trained by the reference can be served
by the port.

The JAX trainer saves ``{"state": TrainState, "epoch": e}`` with
``ocp.args.StandardSave`` (JAX ``train.py:570-574``) under
``<dir>/<step>/default/``: an OCDBT key-value store
(``_METADATA`` says ``"use_ocdbt": true``) of zarr arrays whose keys
are the tree paths joined by dots (``state.params.head.kernel/.zarray``,
``epoch/0``), every file zstd-framed. ``_METADATA``'s ``tree_metadata``
lists the paths. The arrays are read through ``tensorstore``, which is
imported inside ``import_orbax_step`` only, so the rest of the port
never needs it; neither ``jax`` nor ``orbax`` is imported.

Where ``tensorstore`` is missing (the card's machine), convert on a
host that has it and carry the weights as an ``.npz``:

    python -m deepspeech_tpu_torch.checkpoint_import \\
        --checkpoint-dir=JAXDIR --out=x.npz [--step=N]

which ``python -m deepspeech_tpu_torch.infer --params=x.npz`` reads.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from .bridge import _nest

_log = logging.getLogger(__name__)

Tree = Dict[str, object]


def orbax_steps(checkpoint_dir: str) -> List[int]:
    """The steps of an orbax directory, oldest first."""
    return sorted(int(n) for n in os.listdir(checkpoint_dir)
                  if n.isdigit() and os.path.isfile(os.path.join(
                      checkpoint_dir, n, "_CHECKPOINT_METADATA")))


def is_orbax_dir(checkpoint_dir: str) -> bool:
    """Whether ``checkpoint_dir`` holds steps of orbax's layout."""
    return os.path.isdir(checkpoint_dir) and bool(orbax_steps(checkpoint_dir))


def _read_step(ts, checkpoint_dir: str, step: int
               ) -> Tuple[Tree, Tree, int, int]:
    """One step through the ``tensorstore`` module ``ts``."""
    item = os.path.join(os.path.abspath(checkpoint_dir), str(step),
                        "default")
    meta_path = os.path.join(item, "_METADATA")
    if not os.path.isfile(meta_path):
        raise FileNotFoundError(
            f"checkpoint step {step} has no 'default' item at {item}: a "
            "partial or corrupt save")
    with open(meta_path) as fh:
        meta = json.load(fh)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{meta_path}: only orbax's OCDBT + zarr (v2) "
                         "layout is read")

    def read(path: str) -> np.ndarray:
        spec = {"driver": "zarr",
                "kvstore": {"driver": "ocdbt", "base": f"file://{item}/",
                            "path": f"{path}/"}}
        return np.asarray(ts.open(spec, read=True).result().read().result())

    trees: Dict[str, Dict[str, np.ndarray]] = {"params": {},
                                              "batch_stats": {}}
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        value = entry["value_metadata"]
        if (len(keys) > 2 and keys[0] == "state" and keys[1] in trees
                and not value.get("skip_deserialize", False)):
            trees[keys[1]][".".join(keys[2:])] = read(".".join(keys))
    if not trees["params"]:
        raise ValueError(f"{meta_path}: no state.params arrays")
    epoch = int(read("epoch")) if any(
        [k["key"] for k in e["key_metadata"]] == ["epoch"]
        for e in meta["tree_metadata"].values()) else 0
    saved_step = int(read("state.step"))
    return _nest(trees["params"]), _nest(trees["batch_stats"]), \
        saved_step, epoch


def _rejected(checkpoint_dir: str) -> set:
    try:
        with open(os.path.join(checkpoint_dir, "rejected_steps.json")) as fh:
            return set(int(s) for s in json.load(fh))
    except (OSError, ValueError):
        return set()


def import_orbax_step(checkpoint_dir: str, step: Optional[int] = None
                      ) -> Tuple[Tree, Tree, int, int]:
    """``(params, batch_stats, step, epoch)`` of a step the JAX trainer
    saved, as flax-layout trees of numpy arrays (``bridge.from_flax``
    takes them). Without ``step``: the newest step that reads and is not
    in ``rejected_steps.json``, walking back past the others with a
    warning, as the JAX package's ``restore`` does; an explicit step
    raises instead. Raises ``ImportError`` where ``tensorstore`` is not
    installed."""
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            f"reading the orbax checkpoint {checkpoint_dir!r} needs "
            "tensorstore, which is not installed here; convert it on a "
            "host that has it with `python -m "
            "deepspeech_tpu_torch.checkpoint_import --checkpoint-dir=DIR "
            "--out=x.npz` and pass --params=x.npz") from e
    if step is not None:
        return _read_step(ts, checkpoint_dir, int(step))
    steps = orbax_steps(checkpoint_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir!r}")
    rejected = _rejected(checkpoint_dir)
    candidates = [s for s in reversed(steps) if s not in rejected] \
        or [steps[-1]]
    last_err: Optional[BaseException] = None
    for s in candidates:
        try:
            return _read_step(ts, checkpoint_dir, s)
        except Exception as e:
            last_err = e
            _log.warning(
                "checkpoint step %s failed to restore (%s: %s); falling "
                "back to the previous intact step", s, type(e).__name__, e)
    raise last_err


def main(argv=None) -> None:
    import argparse

    from .bridge import save_npz

    parser = argparse.ArgumentParser(
        prog="deepspeech_tpu_torch.checkpoint_import")
    parser.add_argument("--checkpoint-dir", required=True,
                        help="the JAX trainer's train.checkpoint_dir")
    parser.add_argument("--out", required=True, help=".npz to write")
    parser.add_argument("--step", type=int, default=None,
                        help="default: the newest intact step")
    args = parser.parse_args(argv)
    params, batch_stats, step, epoch = import_orbax_step(
        args.checkpoint_dir, args.step)
    save_npz(args.out, params, batch_stats)
    print(json.dumps({"event": "done", "out": args.out, "step": step,
                      "epoch": epoch}))


if __name__ == "__main__":
    main()
