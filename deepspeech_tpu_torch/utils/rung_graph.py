"""One ``(B, T)`` rung of an ``Inferencer``'s offline forward as a CUDA
graph.

The warm store (``serving/warmstore.py``) captures each stored rung of a
replica's ladder before the replica takes traffic, so its first request
on that rung pays no first use: the cuDNN and cuBLAS plans, the caching
allocator's growth and the lazy loading of each kernel happened at the
capture. A :class:`RungGraph`:

- holds the rung's static inputs, ``features [B, T, F]`` f32 and
  ``feat_lens [B]`` int64, as views of one buffer its :class:`GraphPool`
  sizes for the largest rung (replays never overlap, so the rungs share
  it);
- warms the forward up on the pool's side stream (twice), then captures
  ``model(features, feat_lens)`` and the ``log_softmax`` under
  ``inference_mode`` into the pool's memory, with
  ``capture_error_mode="thread_local"``: another replica's thread may
  synchronize or allocate while this one captures. One pool serves every
  rung of one ``Inferencer``, and one side stream captures them all (the
  caching allocator reuses a freed block only on the stream that freed
  it); capturing the largest rung first makes the pool about one rung's
  peak, not the ladder's sum;
- counts the wrapper launches the capture recorded
  (``ops.gru.launch_tally(captured=True)``: recorded, not run, so not in
  the wrappers' ``launches``) in :attr:`kernels`, and each replay in
  :attr:`replays`; a replay runs ``kernels`` once more;
- replays on the caller's current stream (a replica's own): under the
  pool's lock it waits for the previous replay's outputs to be copied
  out (an event, so replays on other streams stay ordered on the card),
  ``copy_``s the request into the static inputs, replays, and returns
  copies of the static outputs, so no caller holds a tensor of the pool.

On the CPU there is no graph: the rung is the eager forward, run once
at construction, which keeps the store's contract testable there. A
capture that fails raises; it is never turned into an eager rung here
(the warm store counts it as a reject and leaves the rung eager, on the
card).
"""

from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.gru import launch_tally

WARMUP = 2    # eager forwards on the side stream before a capture


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


class GraphPool:
    """What every :class:`RungGraph` of one ``Inferencer`` shares: the
    CUDA graph memory pool and the side stream that captures into it,
    the lock that keeps captures and replays one at a time, the event of
    the last replay's copies, and the static input buffer."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.lock = threading.Lock()
        self.done: Optional[torch.cuda.Event] = None
        self._feats: Optional[torch.Tensor] = None
        self._lens: Optional[torch.Tensor] = None

    def inputs(self, b: int, t: int, nf: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Views ``[b, t, nf]`` f32 and ``[b]`` int64 of the shared
        input buffers, grown when a rung needs more (a graph keeps the
        buffer it was captured on)."""
        if self._feats is None or self._feats.numel() < b * t * nf:
            self._feats = torch.zeros(b * t * nf, dtype=torch.float32,
                                      device=self.device)
        if self._lens is None or self._lens.numel() < b:
            self._lens = torch.zeros(b, dtype=torch.int64,
                                     device=self.device)
        return (self._feats[:b * t * nf].view(b, t, nf),
                self._lens[:b])

    def reserved_bytes(self) -> Optional[int]:
        """Bytes of the caching allocator's segments in this pool, or
        None where the snapshot does not name the pools."""
        if self.handle is None:
            return 0
        named, total = False, 0
        for seg in torch.cuda.memory_snapshot():
            if "segment_pool_id" not in seg:
                continue
            named = True
            if tuple(seg["segment_pool_id"]) == tuple(self.handle):
                total += int(seg["total_size"])
        return total if named else None


class RungGraph:
    """See module docstring. ``forward(features, feat_lens) -> (log-probs,
    out lens)`` is the ``Inferencer``'s eager forward on device tensors,
    a bound method; ``pool`` the ``Inferencer``'s :class:`GraphPool`."""

    def __init__(self, forward: Callable, b: int, t: int, nf: int,
                 pool: GraphPool):
        self.shape = (int(b), int(t))
        self.device = pool.device
        self.pool = pool
        # Weak: the Inferencer holds this rung (``preloaded_forwards``),
        # and a strong reference back would leave a retired Inferencer,
        # its weights and its graph pool to the cyclic GC instead of
        # freeing them when the last replica lets go.
        self._forward = weakref.WeakMethod(forward)
        self.replays = 0
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        t0 = time.perf_counter()
        if self.device.type != "cuda":
            with torch.inference_mode(), launch_tally() as used:
                forward(torch.zeros((b, t, nf), dtype=torch.float32,
                                    device=self.device),
                        torch.full((b,), t, dtype=torch.int64,
                                   device=self.device))
            self.kernels: Dict[str, int] = dict(used)
            self.pool_bytes: Optional[int] = 0
            self.capture_s = time.perf_counter() - t0
            return
        with pool.lock, torch.inference_mode():
            before = pool.reserved_bytes()
            self.feats, self.lens = pool.inputs(b, t, nf)
            self.feats.zero_()
            self.lens.fill_(t)
            side = pool.stream
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    forward(self.feats, self.lens)
                graph = torch.cuda.CUDAGraph()
                with launch_tally(captured=True) as used:
                    graph.capture_begin(pool=pool.handle,
                                        capture_error_mode="thread_local")
                    try:
                        self.lp, self.out_lens = forward(self.feats,
                                                         self.lens)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except RuntimeError:
                            pass
                        raise
                    graph.capture_end()
            torch.cuda.current_stream(self.device).wait_stream(side)
            side.synchronize()
            after = pool.reserved_bytes()
        self.graph = graph
        self.kernels = dict(used)
        self.pool_bytes = (None if before is None or after is None
                           else after - before)
        self.capture_s = time.perf_counter() - t0

    def __call__(self, features, feat_lens
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(log-probs [B, T', V] f32, out lens [B]) of one request at
        this rung, on the device; the tensors are the caller's own."""
        b, t = self.shape
        if tuple(features.shape[:2]) != (b, t):
            raise ValueError(f"rung {b}x{t} got features of shape "
                             f"{tuple(features.shape)}")
        if self.graph is None:
            forward = self._forward()
            if forward is None:
                raise RuntimeError(f"rung {b}x{t}: its Inferencer is gone")
            with torch.inference_mode():
                return forward(
                    _host_tensor(features).to(self.device, torch.float32),
                    _host_tensor(feat_lens).to(self.device, torch.int64))
        pool = self.pool
        with pool.lock, torch.inference_mode():
            stream = torch.cuda.current_stream(self.device)
            if pool.done is not None:
                stream.wait_event(pool.done)
            self.feats.copy_(_host_tensor(features))
            self.lens.copy_(_host_tensor(feat_lens))
            self.graph.replay()
            lp, lens = self.lp.clone(), self.out_lens.clone()
            pool.done = torch.cuda.Event()
            pool.done.record(stream)
            self.replays += 1
        return lp, lens
