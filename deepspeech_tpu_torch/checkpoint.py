"""Checkpoints of the port's training state, and checkpoint averaging.

The contract and method names of the JAX package's ``checkpoint.py``
(``save``, ``restore``, ``latest_step``, ``all_steps``, ``wait``,
``close``, ``mark_rejected`` / ``rejected_steps``, ``save_last_good`` /
``restore_last_good`` / ``last_good_steps``, ``average_checkpoints``)
on the port's own format. A step is a directory:

- ``<dir>/<step>/params.npz``: the model's ``params`` and
  ``batch_stats`` in the flax layout (``bridge.save_npz``), so
  ``bridge.load_npz`` and ``infer --params`` read it as it is;
- ``optimizer.pt``: the optimizer's ``state_dict`` (``torch.save``);
- ``meta.json``: ``step``, ``epoch`` and the config's name.

A step is written into ``<dir>/<step>.tmp`` and committed by renaming
it; the oldest steps past ``keep`` are then deleted. ``save`` copies
the state to host memory before it returns (``optimizer.step()``
changes parameters and buffers in place) and writes the files on a
thread, as orbax's asynchronous save does; ``wait`` joins it.

``restore`` without a step walks back from the newest step, newest
first, past steps that fail to load (a save cut off mid-write) and past
steps marked rejected (``rejected_steps.json``), with a warning for each
skip. An explicit ``step`` or ``strict=True`` raises instead.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import threading
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from .bridge import _flatten, _nest, load_npz, save_npz

_log = logging.getLogger(__name__)

PARAMS = "params.npz"
OPTIMIZER = "optimizer.pt"
META = "meta.json"


def _to_host(obj: Any) -> Any:
    """A host copy of ``obj`` that later in-place updates of the
    original cannot reach: tensors and arrays copied, containers
    rebuilt, anything else deep-copied."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict) or hasattr(obj, "items"):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return copy.deepcopy(obj)


def _np_tree(tree) -> Dict:
    """A flax-layout tree as numpy leaves (tensors converted)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v))
            for k, v in _flatten(tree or {}).items()}


class CheckpointManager:
    """Saves and restores training states under ``directory``.

    A state is a dict: ``params`` and ``batch_stats`` (flax-layout
    trees), ``opt_state`` (an optimizer's ``state_dict``, optional),
    ``epoch`` (int) and ``config`` (the config's name, optional).
    ``restore`` returns the same keys and ``step``.
    """

    def __init__(self, directory: str, keep: int = 3,
                 last_good_keep: int = 2):
        from .checkpoint_import import is_orbax_dir

        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        if is_orbax_dir(directory):
            raise ValueError(
                f"{directory!r} holds the JAX package's orbax checkpoints; "
                "infer.restore_params reads them (checkpoint_import.py), "
                "and the port's trainer needs a directory of its own")
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = keep
        self._last_good: deque = deque(maxlen=max(last_good_keep, 1))
        self._rejected_path = os.path.join(self._dir, "rejected_steps.json")
        self._rejected = self._load_rejected()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    @property
    def directory(self) -> str:
        return self._dir

    # -- rejected steps ----------------------------------------------------
    def _load_rejected(self) -> set:
        try:
            with open(self._rejected_path) as fh:
                return set(int(s) for s in json.load(fh))
        except (OSError, ValueError):
            return set()

    def mark_rejected(self, step: int) -> None:
        """Exclude ``step`` from later default restores; persisted, so
        a restarted process keeps the judgment."""
        step = int(step)
        if step in self._rejected:
            return
        self._rejected.add(step)
        try:
            tmp = self._rejected_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump(sorted(self._rejected), fh)
            os.replace(tmp, self._rejected_path)
        except OSError as e:
            _log.warning("could not persist rejected steps: %s", e)

    def rejected_steps(self) -> Tuple[int, ...]:
        return tuple(sorted(self._rejected))

    # -- last-good ring ----------------------------------------------------
    def save_last_good(self, step: int, state: Any,
                       meta: Optional[dict] = None) -> None:
        """Push a host copy of ``state`` into the bounded in-memory ring
        (synchronous: a rollback must not wait on the disk writer)."""
        self._last_good.append((int(step), _to_host(state), meta))

    def restore_last_good(self) -> Optional[Tuple[int, Any,
                                                  Optional[dict]]]:
        """Newest ring entry as ``(step, host_state, meta)``, or None."""
        return self._last_good[-1] if self._last_good else None

    def last_good_steps(self) -> Tuple[int, ...]:
        return tuple(s for s, _, _ in self._last_good)

    # -- save --------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any]) -> bool:
        """Snapshot ``state`` to host memory now and write it as step
        ``step`` on a thread. A step at or below the newest one is not
        saved (returns False), as orbax's manager skips it."""
        step = int(step)
        self.wait()
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return False
        snap = {
            "params": {k: v.copy() for k, v in
                       _np_tree(state["params"]).items()},
            "batch_stats": {k: v.copy() for k, v in
                            _np_tree(state.get("batch_stats")).items()},
            "opt_state": _to_host(state.get("opt_state")),
            "meta": {"step": step, "epoch": int(state.get("epoch", 0)),
                     "config": state.get("config", "")},
        }
        self._writer = threading.Thread(target=self._write,
                                        args=(step, snap), daemon=True)
        self._writer.start()
        return True

    def _write(self, step: int, snap: Dict[str, Any]) -> None:
        try:
            final = os.path.join(self._dir, str(step))
            tmp = final + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            save_npz(os.path.join(tmp, PARAMS), _nest(snap["params"]),
                     _nest(snap["batch_stats"]))
            if snap["opt_state"] is not None:
                torch.save(snap["opt_state"], os.path.join(tmp, OPTIMIZER))
            with open(os.path.join(tmp, META), "w") as fh:
                json.dump(snap["meta"], fh)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for old in self.all_steps()[:-self._keep]:
                shutil.rmtree(os.path.join(self._dir, str(old)),
                              ignore_errors=True)
        except Exception as e:  # raised by the next wait()
            self._write_error = e

    def wait(self) -> None:
        """Join the writer of the last save; raise its error, if any."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def close(self) -> None:
        self.wait()

    # -- steps and restore -------------------------------------------------
    def all_steps(self) -> List[int]:
        """The committed steps, oldest first."""
        return sorted(int(n) for n in os.listdir(self._dir)
                      if n.isdigit()
                      and os.path.isdir(os.path.join(self._dir, n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None,
                strict: bool = False) -> Optional[Dict[str, Any]]:
        """Restore a step (default: the newest that loads and is not
        rejected). None when no step was ever saved."""
        explicit = step is not None
        step = self.latest_step() if step is None else int(step)
        if step is None:
            return None
        candidates = [step] if (explicit or strict) else \
            [s for s in reversed(self.all_steps())
             if s <= step and s not in self._rejected] or [step]
        last_err: Optional[BaseException] = None
        for s in candidates:
            try:
                return self._restore_step(s)
            except Exception as e:
                if explicit or strict:
                    raise
                last_err = e
                _log.warning(
                    "checkpoint step %s failed to restore (%s: %s); "
                    "falling back to the previous intact step",
                    s, type(e).__name__, e)
        raise last_err

    def _restore_step(self, step: int) -> Dict[str, Any]:
        d = os.path.join(self._dir, str(step))
        with open(os.path.join(d, META)) as fh:
            meta = json.load(fh)
        params, batch_stats = load_npz(os.path.join(d, PARAMS))
        opt_path = os.path.join(d, OPTIMIZER)
        opt_state = (torch.load(opt_path, map_location="cpu",
                                weights_only=True)
                     if os.path.exists(opt_path) else None)
        return {"step": int(meta["step"]), "epoch": int(meta["epoch"]),
                "config": meta.get("config", ""), "params": params,
                "batch_stats": batch_stats, "opt_state": opt_state}


def average_params(pairs: Iterable[Tuple[Any, Any]]):
    """``(params, batch_stats)`` of an iterable of such pairs, oldest
    first, consumed one at a time: the elementwise mean of the params,
    summed in float64 and cast back to each leaf's dtype, and the last
    pair's batch_stats."""
    acc: Dict[str, np.ndarray] = {}
    dtypes: Dict[str, np.dtype] = {}
    n, stats = 0, {}
    for params, stats in pairs:
        n += 1
        for k, v in _np_tree(params).items():
            if k in acc:
                acc[k] += v.astype(np.float64)
            else:
                dtypes[k] = v.dtype
                acc[k] = v.astype(np.float64)
    return (_nest({k: (a / n).astype(dtypes[k]) for k, a in acc.items()}),
            stats)


def average_checkpoints(directory: str, last_k: int = 0):
    """The mean of the ``params`` of the last ``last_k`` saved steps (0
    or 1: the newest alone) and the newest step's ``batch_stats``
    (``average_params``), as ``infer.restore_params`` returns them."""
    mgr = CheckpointManager(directory)
    steps = mgr.all_steps()
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    take = steps[-max(last_k, 1):]
    if len(take) < last_k:
        _log.warning(
            "average_checkpoints: only %d checkpoints on disk (requested "
            "%d; train.keep_checkpoints bounds retention)", len(take), last_k)
    return average_params((raw["params"], raw["batch_stats"])
                          for raw in map(mgr.restore, take))
