"""Preemption-safe training: SIGTERM -> emergency checkpoint.

The port's copy of the JAX package's ``resilience/preempt.py``. A
managed fleet preempts with a signal and a grace window. The training
loop already has what it needs to survive that (a deterministic sampler,
checkpoints, and a mid-epoch resume that skips the consumed batch
prefix); :class:`PreemptionGuard` is the trigger. It latches the signal
(the handler stays microscopic: the *loop* saves, at a safe point
between steps), ``Trainer.fit`` polls ``requested()`` once a step, writes
an emergency checkpoint and returns cleanly, and the resumed run ends
bit-identical to an uninterrupted one.

Signal handlers install only from the main thread (a CPython rule);
``install()`` raises elsewhere. ``trigger()`` requests preemption without
a real signal.
"""

from __future__ import annotations

import signal
import threading
from typing import Dict, Optional, Tuple

from .. import obs


class PreemptionGuard:
    """Latches preemption signals; poll with :meth:`requested`.

    Use as a context manager (installs on enter, restores the previous
    handlers on exit) or via explicit ``install()``/``uninstall()``.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,),
                 registry=None):
        self.signals = tuple(signals)
        self._registry = registry
        self._requested = threading.Event()
        self._prev: Dict[int, object] = {}
        self._signum: Optional[int] = None

    def _reg(self):
        return self._registry if self._registry is not None \
            else obs.registry()

    def install(self) -> "PreemptionGuard":
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._on_signal)
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame) -> None:
        self._signum = signum
        self.trigger()

    def trigger(self) -> None:
        """Request preemption (signal handler body; also a test hook)."""
        if not self._requested.is_set():
            self._requested.set()
            self._reg().count("preemptions")

    def requested(self) -> bool:
        return self._requested.is_set()

    def reset(self) -> None:
        self._requested.clear()
        self._signum = None

    @property
    def signum(self) -> Optional[int]:
        return self._signum
