"""JSONL structured logging, a windowed utterances/sec counter, and
TensorBoard scalars.

The port's copy of the JAX package's ``utils/logging.py``. Step logs are
``{"event": "train_step", "step": n, "loss": ..., ...}`` lines. For
counters and timers prefer ``obs`` (the process-wide registry and spans);
:class:`JsonlLogger` stays for free-form event lines.
"""

from __future__ import annotations

import collections
import json
import time
from typing import IO, Optional


class JsonlLogger:
    """One ``{"event", "time", ...}`` JSON object a line, echoed to
    stdout and appended to ``path`` when one is given."""

    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self._fh: Optional[IO] = open(path, "a") if path else None
        self._echo = echo

    def log(self, event: str, **fields) -> None:
        rec = {"event": event, "time": round(time.time(), 3), **fields}
        line = json.dumps(rec, ensure_ascii=False)
        if self._echo:
            print(line, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()


class Throughput:
    """Windowed utterances/sec/chip counter.

    The rate is computed over at most the last ``window`` updates, so the
    steady state shows once the window slides past the first steps (a
    rate since construction would average the warm-up in forever).
    """

    def __init__(self, n_chips: int, window: int = 50):
        self.n_chips = max(n_chips, 1)
        self._events: collections.deque = collections.deque(
            maxlen=window + 1)
        self._total = 0
        self.reset()

    def update(self, batch_utts: int) -> None:
        self._total += batch_utts
        self._events.append((time.perf_counter(), self._total))

    def rate_per_chip(self) -> float:
        if len(self._events) < 2:
            return 0.0
        t0, u0 = self._events[0]
        t1, u1 = self._events[-1]
        dt = t1 - t0
        return (u1 - u0) / dt / self.n_chips if dt > 0 else 0.0

    def reset(self) -> None:
        self._events.clear()
        self._events.append((time.perf_counter(), self._total))


class TensorBoardLogger:
    """Scalar curves for TensorBoard (``train.tensorboard_dir``).

    ``torch.utils.tensorboard`` is imported here, when a log directory is
    configured; where the ``tensorboard`` package is not installed that
    import raises ``ImportError``, and so does the constructor."""

    def __init__(self, logdir: str):
        from torch.utils.tensorboard import SummaryWriter

        self._writer = SummaryWriter(log_dir=logdir)

    def scalars(self, step: int, **values) -> None:
        for key, val in values.items():
            self._writer.add_scalar(key, float(val), global_step=step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()
