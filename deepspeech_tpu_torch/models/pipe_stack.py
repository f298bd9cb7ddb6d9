"""The pipeline-stacked RNN middle of a DS2 model: its sequential path
and the GPipe schedule over ``torch.distributed``.

The JAX package's ``models/pipe_stack.py`` stacks layers 1..L-1 of the
RNN stack (homogeneous ``[B,T,H] -> [B,T,H]`` blocks: masked BN, input
projection, (bi)directional recurrence) along a leading layer axis so
that a mesh's ``pipe`` axis can shard them for GPipe training.
``PipelinedRNNStack`` holds that tree under its JAX names,

  params ``rnn_pipe/{wx_kernel, wx_bias, wh_fw, bh_fw[, wh_bw, bh_bw]
  [, bn_scale, bn_bias]}``, each ``[L-1, ...]``;
  batch stats ``rnn_pipe/{mean, var}`` ``[L-1, H]`` (with
  ``rnn_batch_norm``),

or, on a mesh with a pipe axis of P stages (``parallel/mesh.py``), this
rank's stage of it: layers ``[p L', (p + 1) L')`` with ``L' = (L-1)/P``,
each leaf ``[L', ...]`` (``bridge.from_flax`` slices them, ``to_flax``
gathers them back). Each layer is the masked BN (``layers.normalize``
on the batch's statistics over the data group in train mode, the
running ones in eval mode) and then ``rnn.layer_body`` (``wx``, the
recurrence: K4/K6 at a resident width, K8 beyond, K12/K14 for an LSTM;
the mask) on the layer's slices, the functions ``rnn.RNNLayer``
computes through, so that the tree and a standard one holding the same
weights unstacked give the same bits.

Without a pipe group (no mesh, or a mesh without a pipe axis) the
forward is JAX's sequential path (JAX ``pipe_stack.py:247-251``): every
layer in order on the whole batch, in train mode with the batch's own
statistics, the running ones updated once with them. It serves a
pipeline-trained checkpoint on one device and is the oracle of the
pipelined one.

With a pipe group the forward is JAX ``_pipe_fn``'s GPipe schedule
(``:117-165``) on M microbatches (``pipeline_microbatches``, default
P): row i of this rank's batch goes to microbatch ``i % M`` (JAX
``:258-264``; the batch divides by M times the data size, so this is
this rank's share of the global microbatch). Each rank runs its stage on
each microbatch in order: stage 0 on the input, every other stage on
what the stage before sent it; its output goes to the stage after, and
the last stage keeps it. Consecutive stages overlap as JAX's rounds do,
``M + P - 1`` of them; the pipe is a line, so JAX's wrap-around hop is
not sent. A hop is a ``broadcast`` over the two stages' own group,
which gloo runs on CPU and CUDA tensors alike (its point-to-point
``send``/``recv`` takes CPU tensors only) and NCCL too, in f32 as JAX's
activations cross its boundary. The last stage's output for every
microbatch then reaches every rank of the pipe group (a ``broadcast``
from it, JAX's ``psum``), where the head and the loss run on it.

The backward (``_GPipe``, one autograd function over the schedule, as
JAX differentiates its scan) keeps only each microbatch's stage input.
Each stage takes the microbatches in reverse order, as JAX's transposed
scan does: it recomputes the stage under ``enable_grad`` (JAX's
``jax.checkpoint``), takes ``autograd.grad`` for the input and its
layers, and hands the input's gradient to the stage before. Stage 0's
input gradient reaches every pipe rank (a ``broadcast``), so every rank
runs ``rnn0``'s and the conv's backward on the same cotangent and the
replicated leaves' gradients are the same bits on every pipe rank, with
no all-reduce over ``pipe``.

Train-mode BN (JAX ``:26-33``): each microbatch is normalized by its
own statistics, over the data group; the running statistics are updated
once a step with the mean of the per-microbatch statistics (``:162-164``,
``:282-286``); the recompute updates nothing. With M = 1 this is the
sequential path's arithmetic. Eval mode on a pipe mesh runs the same
schedule forward-only on the running statistics, since a rank holds
only its stage.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..config import ModelConfig
from .layers import (BN_MOMENTUM, length_mask, masked_bn_stats,
                     normalize)
from .rnn import _N_GATES, _check_impl, layer_body

# The stacked leaves and their per-layer shapes, for H units and G gates.
STACKED_PARAMS = ("wx_kernel", "wx_bias", "wh_fw", "bh_fw", "wh_bw",
                  "bh_bw", "bn_scale", "bn_bias")

# One stacked layer's leaves by name.
Layer = Dict[str, torch.Tensor]


def _split(t: torch.Tensor, m: int) -> List[torch.Tensor]:
    """Rows ``k::m`` of ``t`` for each microbatch k (views: a stage sees
    its input in the layout a layer's output has)."""
    return [t[k::m] for k in range(m)]


def _time_major(x: torch.Tensor) -> torch.Tensor:
    """``x [B,T,H]`` f32 as the contiguous ``[T,B,H]`` a hop carries (no
    copy for a layer's output, which is time-major in memory)."""
    return x.float().transpose(0, 1).contiguous()


class PipelinedRNNStack(nn.Module):
    """Layers 1..rnn_layers-1 of the RNN stack, stacked (JAX
    ``PipelinedRNNStack``). Used by ``DeepSpeech2`` when
    ``cfg.pipeline_stages > 1``; layer 0 (the conv-width input) stays an
    ``RNNLayer`` named ``rnn0`` beside it. ``mesh`` (a ``parallel.Mesh``)
    with a pipe axis of more than one stage gives this rank its stage's
    layers and the schedule (module docstring); ``group`` is the data
    group the train-mode statistics are taken over (None: this rank's
    rows)."""

    def __init__(self, cfg: ModelConfig, mesh=None):
        super().__init__()
        n_layers = cfg.rnn_layers - 1
        if n_layers < 1 or n_layers % cfg.pipeline_stages:
            raise ValueError(
                f"pipeline_stages={cfg.pipeline_stages} must divide "
                f"rnn_layers-1={n_layers}")
        if cfg.rnn_type not in _N_GATES:
            raise ValueError(f"rnn_type={cfg.rnn_type!r}: 'gru' or 'lstm'")
        _check_impl(cfg.rnn_impl)
        self.cfg = cfg
        self.group = None
        self.mesh = None
        self.pipe_group = None
        self.stage, self.n_stages = 0, 1
        if mesh is not None and mesh.stages > 1:
            if mesh.stages != cfg.pipeline_stages:
                raise ValueError(f"mesh pipe axis {mesh.stages} != "
                                 f"pipeline_stages {cfg.pipeline_stages}")
            if mesh.pipe_group is None:
                raise ValueError(f"a pipe axis of {mesh.stages} stages "
                                 "needs a process group")
            self.mesh, self.pipe_group = mesh, mesh.pipe_group
            self.stage, self.n_stages = mesh.pipe_index, mesh.stages
        # This rank's layers: all of them without a pipe group.
        self.n_layers = n_layers // self.n_stages
        h = cfg.rnn_hidden
        g = _N_GATES[cfg.rnn_type] * h
        self.dirs = ["fw", "bw"] if cfg.bidirectional else ["fw"]
        n = self.n_layers
        shapes = {"wx_kernel": (n, h, g), "wx_bias": (n, g)}
        for s in self.dirs:
            shapes[f"wh_{s}"] = (n, h, g)
            shapes[f"bh_{s}"] = (n, g)
        if cfg.rnn_batch_norm:
            shapes["bn_scale"] = (n, h)
            shapes["bn_bias"] = (n, h)
            self.register_buffer("mean", torch.zeros(n, h))
            self.register_buffer("var", torch.ones(n, h))
        self.names = [k for k in STACKED_PARAMS if k in shapes]
        for name in self.names:
            fill = torch.ones if name == "bn_scale" else torch.zeros
            self.register_parameter(name, nn.Parameter(fill(shapes[name])))

    def _may_need_grad(self, x: torch.Tensor) -> bool:
        return torch.is_grad_enabled() and (x.requires_grad or any(
            p.requires_grad for p in self.parameters()))

    def _layers(self, leaves: List[torch.Tensor]) -> List[Layer]:
        """Each layer's slices of ``leaves`` (``self.names`` order)."""
        return [{k: leaf[i] for k, leaf in zip(self.names, leaves)}
                for i in range(self.n_layers)]

    def _stage_apply(self, x: torch.Tensor, mask: torch.Tensor,
                     layers: List[Layer], train: bool, grad: bool):
        """``layers`` in order on ``x`` (JAX ``_stage_apply``): returns the
        output and, in train mode with BN, each layer's batch statistics
        ``(mean, var)``."""
        cfg = self.cfg
        stats = []
        for i, p in enumerate(layers):
            if cfg.rnn_batch_norm:
                # One f32 copy for the statistics and the arithmetic, as
                # MaskedBatchNorm takes it: their gradients add in f32.
                x32 = x.float()
                if train:
                    mean, var = masked_bn_stats(x32, mask, self.group)
                    stats.append((mean, var))
                else:
                    mean, var = self.mean[i], self.var[i]
                x = normalize(x32, mean, var, p["bn_scale"],
                              p["bn_bias"]).to(x.dtype)
            whs = [p[f"wh_{s}"] for s in self.dirs]
            bh = torch.stack([p[f"bh_{s}"] for s in self.dirs])
            x = layer_body(cfg, x, mask, p["wx_kernel"], p["wx_bias"], whs,
                           bh, grad)
        return x, stats

    @torch.no_grad()
    def _update(self, stats) -> None:
        """The running statistics' momentum update with each layer's
        ``(mean, var)`` (``MaskedBatchNorm.update``'s arithmetic)."""
        mean = torch.stack([s[0] for s in stats])
        var = torch.stack([s[1] for s in stats])
        self.mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
        self.var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)

    def forward(self, x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        mask = length_mask(lens, x.shape[1])
        train = self.training
        leaves = [getattr(self, k) for k in self.names]
        if self.pipe_group is None:
            x, stats = self._stage_apply(x, mask, self._layers(leaves),
                                         train, self._may_need_grad(x))
        else:
            m = cfg.pipeline_microbatches or cfg.pipeline_stages
            if x.shape[0] % m:
                raise ValueError(f"batch {x.shape[0]} not divisible by "
                                 f"pipeline_microbatches {m}")
            if self._may_need_grad(x):
                out: List = []
                x = _GPipe.apply(self, x, mask, m, train, out, *leaves)
                stats = out[0]
            else:
                x, stats = self._schedule(x, mask, m, train, leaves)
        if train and cfg.rnn_batch_norm:
            self._update(stats)
        return x

    # -- the GPipe schedule ------------------------------------------------

    def _hop(self, t: torch.Tensor, src: int, group) -> None:
        """``t`` from stage ``src`` to the other rank of ``group`` (a
        two-rank hop or the pipe group), in place."""
        dist.broadcast(t, src=self.mesh.stage_rank(src), group=group)

    def _recv(self, like: torch.Tensor, src: int, group) -> torch.Tensor:
        """What stage ``src`` hops to this rank over ``group`` (a
        ``_time_major`` tensor): shaped as ``like``, in its dtype, in a
        layer output's layout."""
        b, t, h = like.shape
        buf = torch.empty((t, b, h), dtype=torch.float32,
                          device=like.device)
        self._hop(buf, src, group)
        return buf.transpose(0, 1).to(like.dtype)

    def _gather(self, parts: List, shape, dtype: torch.dtype,
                device: torch.device, src: int) -> torch.Tensor:
        """Microbatch ``k``'s rows ``parts[k]`` on stage ``src`` as one
        ``shape [B,T,H]`` tensor on every rank of the pipe group (f32
        across it), in ``dtype`` and in a layer output's layout, so that
        the layers after it reduce in the order they would on one
        device."""
        b, t, h = shape
        whole = torch.empty((t, b, h), dtype=torch.float32, device=device)
        if self.stage == src:
            for k, part in enumerate(parts):
                whole.transpose(0, 1)[k::len(parts)] = part.float()
        self._hop(whole, src, self.pipe_group)
        return whole.transpose(0, 1).to(dtype)

    def _schedule(self, x: torch.Tensor, mask: torch.Tensor, m: int,
                  train: bool, leaves: List[torch.Tensor],
                  saved: Optional[List[torch.Tensor]] = None):
        """The schedule's forward (no gradient): returns the stack's
        output on every pipe rank and, in train mode with BN, each of
        this stage's layers' statistics averaged over the microbatches.
        ``saved`` collects each microbatch's stage input."""
        layers = self._layers([leaf.detach() for leaf in leaves])
        before, after = self.mesh.hops
        last = self.n_stages - 1
        xm, maskm = _split(x, m), _split(mask, m)
        ys, total = [], None
        with torch.no_grad():
            for k in range(m):
                xin = (xm[k] if self.stage == 0
                       else self._recv(xm[k], self.stage - 1, before))
                if saved is not None:
                    saved.append(xin)
                y, stats = self._stage_apply(xin, maskm[k], layers, train,
                                             False)
                # JAX sums the valid rounds' statistics from zeros.
                total = stats if total is None else [
                    (a + s, b + t) for (a, b), (s, t) in zip(total, stats)]
                if self.stage == last:
                    ys.append(y)
                else:
                    self._hop(_time_major(y), self.stage, after)
            out = self._gather(ys, x.shape, x.dtype, x.device, last)
        return out, [(a / m, b / m) for a, b in total]

    def _schedule_backward(self, dout: torch.Tensor, mask: torch.Tensor,
                           m: int, train: bool, saved, leaves,
                           dtype: torch.dtype):
        """The schedule's backward: each microbatch's stage recomputed
        under a gradient, in reverse order; returns the gradients of
        ``leaves`` and of the stack's input (in ``dtype``) on every pipe
        rank."""
        before, after = self.mesh.hops
        last = self.n_stages - 1
        maskm = _split(mask, m)
        dym = _split(dout, m) if self.stage == last else None
        grads: List[List[torch.Tensor]] = [[] for _ in leaves]
        dxs = [None] * m
        for k in reversed(range(m)):
            dy = (dym[k] if self.stage == last
                  else self._recv(saved[k], self.stage + 1, after))
            with torch.enable_grad():
                xin = saved[k].detach().requires_grad_(True)
                layers = [{n: t.detach().requires_grad_(True)
                           for n, t in layer.items()}
                          for layer in self._layers(leaves)]
                y, _ = self._stage_apply(xin, maskm[k], layers, train, True)
                wrt = [xin] + [layer[n] for n in self.names
                               for layer in layers]
                got = torch.autograd.grad(y, wrt, dy.to(y.dtype),
                                          allow_unused=True)
            for j, n in enumerate(self.names):
                for i, layer in enumerate(layers):
                    g = got[1 + j * self.n_layers + i]
                    if g is None:
                        g = torch.zeros_like(layer[n])
                    if k == m - 1:
                        grads[j].append(g)
                    else:
                        grads[j][i] = grads[j][i] + g
            if self.stage == 0:
                dxs[k] = got[0]
            else:
                self._hop(_time_major(got[0]), self.stage, before)
        dx = self._gather(dxs, dout.shape, dtype, dout.device, 0)
        return [torch.stack(g) for g in grads], dx


class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd function: ``apply(stack, x,
    mask, m, train, stats_out, *leaves)`` -> the stack's output; the
    averaged statistics are appended to ``stats_out``. The backward
    recomputes each stage (``_schedule_backward``)."""

    @staticmethod
    def forward(ctx, stack, x, mask, m, train, stats_out, *leaves):
        saved: List[torch.Tensor] = []
        out, stats = stack._schedule(x, mask, m, train, list(leaves), saved)
        stats_out.append(stats)
        ctx.stack, ctx.m, ctx.train = stack, m, train
        ctx.n_saved, ctx.dtype = len(saved), x.dtype
        ctx.save_for_backward(mask, *saved, *leaves)
        return out

    @staticmethod
    def backward(ctx, dout):
        mask, *rest = ctx.saved_tensors
        saved, leaves = rest[:ctx.n_saved], rest[ctx.n_saved:]
        grads, dx = ctx.stack._schedule_backward(
            dout.contiguous(), mask, ctx.m, ctx.train, saved, leaves,
            ctx.dtype)
        return (None, dx, None, None, None, None, *grads)
