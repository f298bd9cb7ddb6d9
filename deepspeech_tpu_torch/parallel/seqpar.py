"""Sequence-parallel long-audio inference: the serving half of the JAX
package's ``parallel/seqpar.py``.

A bidirectional offline model needs the whole utterance at once, so the
activations of a long recording must fit one device. This module shards
the TIME axis over a list of devices, one shard an entry, and runs the
encoder shard by shard (JAX ``seqpar.py:1-37`` does it over a mesh, one
``shard_map``):

- conv frontend: shard ``k`` holds its slice of the feature frames and,
  for each conv layer, copies its neighbours' boundary frames (left halo
  = the layer's left pad, right halo = kt - stride - left), then runs a
  VALID conv in time: the sampling grid of the offline explicit-pad conv
  (``models/conv.py``). An edge shard takes zeros, which are the offline
  zero padding.
- recurrences: the carry RELAYS across shards. Each direction of each
  layer is its own D=1 call (``models/rnn.chunk_recurrence``: ``gru_fwd``
  with its ``h0`` or ``lstm_fwd`` with its ``(h0, c0)``, the final state
  out); the forward direction runs shard 0, 1, ..., S-1, each from the
  carry the one before handed over, the backward direction S-1, ..., 0.
  A bidirectional layer is two such relays, not one D=2 call: shard k
  would need both carries at once, and they arrive from opposite ends.
  A shard runs its chunk once, when its carry is there (the JAX relay
  runs every shard every round and keeps one round's work); the two
  relays are issued interleaved, round r taking the forward chunk of
  shard r and the backward chunk of shard S-1-r, and nothing waits on
  the host between them, so on shards that sit on different devices the
  two wavefronts overlap. Each shard's work runs under its device.
- BN reads running statistics (time-local); the head and the argmax are
  local to each shard: ``sp_greedy_decode`` gathers only the int32 ids,
  never the ``[T', V]`` logits.

``sp_loss`` is the training half (JAX ``seqpar.py:347-452``): the same
forward in train mode, with a gradient. Each masked BN takes this
batch's statistics over every shard (each shard's mask-weighted partial
sums added on the home device in shard order, ``layers.masked_bn_stats``
over the list) and returns them for the caller's momentum update. Each
direction of each GRU layer is one D=1 ``GRUFunction`` call a shard
with ``h0`` the carry the shard before handed over, ``ys`` at its
scan's last row moved by a differentiable copy, so ``backward`` relays
``dh0`` the other way by itself (K6/K8 forward, K7/K9 backward with
``h0`` and ``dh0``); of each LSTM layer one D=1 ``LSTMFunction`` call
with ``(h0, c0)``, the carry out being ``ys``'s last row and the
function's final c, so the backward relays ``(dh0, dc0)`` (K12/K14
taped forward, K13/K15 backward with ``(h0, c0)``, ``dcfin`` and
``(dh0, dc0)``). The log-softmax and the CTC stay on each shard:
``ops/ctc.py``'s ``sp_ctc_loss`` relays the ``[B, S]`` alpha band shard
to shard and the beta band back (K1, K2). A shard on another device
than the model reaches its parameters through differentiable copies
made in the step (``_TrainShards``), so their gradients sum into the
home parameters, as JAX psums the replicated cotangents; the
``Replicas`` of decoding are not used (their weights would go stale
after an optimizer step).

``sp_beam_search`` relays the beam state the same way: shard k advances
``decode/beam.py``'s ``BeamState`` over its own log-probs with
``beam_search_chunk`` and hands it to shard k+1; the last shard's state is
finalized (``beam_finalize``). Chunks scanned in order give the offline
search's bits, so the result is the offline search's.

``devices`` may repeat an entry: ``[cpu] * 8`` runs eight shards on the
CPU (the plain versions), ``[cuda:0] * 4`` four on one card (the
kernels). The functions take the port's ``DeepSpeech2`` (the standard
tree, in eval mode) where JAX takes ``(params, batch_stats)``, and run
it through ``Replicas``: one copy of the model on each distinct device
of the list besides its own, made when the ``Replicas`` is. A call
without ``replicas`` makes them for itself; the Inferencer keeps one
for its device list, as JAX keeps its ``_sp_mesh``.
"""

from __future__ import annotations

import contextlib
import copy
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import ModelConfig
from ..models.layers import (clipped_relu, masked_bn_stats, normalize,
                             weight)
from ..models.rnn import chunk_recurrence, layer_input, layer_output
from ..ops.ctc import sp_ctc_loss
from ..ops.gru import current_device as _on

Devices = Sequence[torch.device]


def sp_frame_multiple(cfg: ModelConfig, n_shards: int) -> int:
    """Feature-frame count must divide by this for an SP forward: every
    shard takes an equal slice whose length divides the conv stride."""
    return n_shards * cfg.time_stride


def _conv_halo(kt: int, st: int) -> Tuple[int, int]:
    """(left, right) halo frames a conv layer needs from its neighbours,
    the split ``_conv_sp`` copies; shared with ``_validate``."""
    pt = (kt - st) // 2
    return pt, kt - st - pt


def sp_min_frames(cfg: ModelConfig, n_shards: int) -> int:
    """Smallest total feature-frame count an SP forward accepts on
    ``n_shards``: every shard's slice must cover each conv layer's halo
    and divide the stride chain. Callers that own the padding (the
    Inferencer's sp modes) zero-pad short utterances up to this; padding
    frames are masked, so outputs stay exact."""
    need = 1  # >=1 post-conv frame per shard
    for (kt, _, st, _) in reversed(cfg.conv_layers):
        need = max(need * st, max(_conv_halo(kt, st)), 1)
    stride = cfg.time_stride
    need = -(-need // stride) * stride  # align to the stride chain
    return need * n_shards


def _validate(cfg: ModelConfig, devices: Devices, t: int) -> int:
    """The entry guards (JAX ``_validate``); returns the shard count."""
    if cfg.lookahead_context > 0:
        raise ValueError("lookahead models stream natively "
                         "(streaming.py); sequence parallelism targets "
                         "bidirectional offline models")
    if cfg.pipeline_stages > 1:
        raise ValueError("sequence parallelism expects the standard "
                         "(non-pipelined) parameter tree")
    n_shards = len(devices)
    if n_shards < 1:
        raise ValueError("sequence parallelism needs at least one device")
    mult = sp_frame_multiple(cfg, n_shards)
    if t % mult:
        raise ValueError(f"frames {t} must divide by {mult} "
                         f"(= shards * time_stride); zero-pad the tail")
    # A halo reaches one neighbour only, so every shard's slice must
    # cover each layer's halo; short of that the copied halo would hold
    # fewer frames than the conv reads, and the logits would misalign.
    tl = t // n_shards
    for i, (kt, kf, st, sf) in enumerate(cfg.conv_layers):
        halo = max(_conv_halo(kt, st))
        if tl < halo:
            raise ValueError(
                f"too many sequence shards for this utterance length: "
                f"conv layer {i} needs a {halo}-frame halo but each of "
                f"the {n_shards} shards holds only {tl} frames at that "
                f"layer; use fewer shards or longer (padded) inputs")
        tl //= st
    return n_shards


def _indexed(device) -> torch.device:
    """``device`` with its index: a bare "cuda" is the current card."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Replicas:
    """The model on each shard's device: one replica on each distinct
    device of ``devices`` (the model itself where it already lies), made
    once, and the LM fusion table of ``sp_beam_search`` on each, copied
    at its first use there. A caller that decodes many batches over one
    device list (the Inferencer's sp modes) builds this once and passes
    it to each call as ``replicas``."""

    def __init__(self, model, devices: Devices):
        self.model = model
        self.devices = [_indexed(d) for d in devices]
        home = next(model.parameters()).device
        by_dev: Dict[torch.device, torch.nn.Module] = {}
        for d in self.devices:
            if d not in by_dev:
                by_dev[d] = model if d == home else \
                    copy.deepcopy(model).to(d).eval()
        self.models = [by_dev[d] for d in self.devices]
        self._tables: Dict[torch.device, tuple] = {}

    def __len__(self) -> int:
        return len(self.devices)

    def table(self, lm_table, device: torch.device):
        """``lm_table`` on ``device``, copied there once."""
        held = self._tables.get(device)
        if held is None or held[0] is not lm_table:
            held = (lm_table, lm_table.to(device))
            self._tables[device] = held
        return held[1]


def _replicas(model, devices: Devices, replicas) -> Replicas:
    """``replicas`` when it holds ``model`` over ``devices``, else raise;
    new ones when None."""
    if replicas is None:
        return Replicas(model, devices)
    if replicas.model is not model or replicas.devices != [
            _indexed(d) for d in devices]:
        raise ValueError("replicas were built for another model or another "
                         "device list")
    return replicas


# Each model's skeletons on other devices (``_TrainShards``), made once.
_SKELETONS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class _TrainShards:
    """Each shard's view of the home model for one train step, with the
    interface ``_forward_shards`` reads (``devices``, ``models``): the
    model itself on its own device; on another device a skeleton (a copy
    of the model made there once, kept for the model) whose parameters
    are bound, for this step, to ``p.to(device)`` of the home ones:
    differentiable copies, so each shard's gradient sums into the home
    parameter. Where every shard is on the home device (one card, the
    CPU) nothing is copied."""

    def __init__(self, model, devices: Devices):
        self.devices = [_indexed(d) for d in devices]
        home = next(model.parameters()).device
        named = list(model.named_parameters())
        views: Dict[torch.device, torch.nn.Module] = {}
        for d in self.devices:
            if d in views:
                continue
            if d == home:
                views[d] = model
                continue
            skeletons = _SKELETONS.setdefault(model, {})
            if d not in skeletons:
                skeletons[d] = copy.deepcopy(model).to(d)
            view = skeletons[d]
            for name, p in named:
                owner, _, leaf = name.rpartition(".")
                view.get_submodule(owner)._parameters[leaf] = p.to(d)
            views[d] = view
        self.models = [views[d] for d in self.devices]

    def __len__(self) -> int:
        return len(self.devices)


def _bn(shards, name: str, xs, masks, train: bool, stats: Optional[dict]):
    """The masked BN ``name`` (a submodule path, e.g. ``conv.bn0``) of
    each shard's model over its ``xs[k]`` ``[B, T, ..., C]``: the running
    statistics (time-local), or in ``train`` this batch's over every
    shard (``masked_bn_stats`` over the list: partial sums added on the
    first shard's device in shard order), each shard normalising with its
    copy of them; those go into ``stats[name]`` as ``(mean, var)``."""
    bns = [m.get_submodule(name) for m in shards.models]
    if not train:
        return [bn.running(x) for bn, x in zip(bns, xs)]
    mean, var = masked_bn_stats([x.float() for x in xs], masks)
    stats[name] = (mean, var)
    return [normalize(x.float(), mean.to(x.device), var.to(x.device),
                      bn.scale, bn.bias, bn.eps).to(x.dtype)
            for bn, x in zip(bns, xs)]


def _mask(t_off: int, t: int, lens: torch.Tensor) -> torch.Tensor:
    """[B, t] f32: 1 where the global frame ``t_off + i`` is valid."""
    gidx = t_off + torch.arange(t, device=lens.device)
    return (gidx[None, :] < lens[:, None]).float()


def _conv_sp(cfg: ModelConfig, shards, xs: List[torch.Tensor],
             lens: List[torch.Tensor], train: bool = False,
             stats: Optional[dict] = None):
    """``models/conv.ConvFrontend``, time-sharded. ``xs[k]`` is shard k's
    feature slice ``[B, Tl, F]``; ``lens[k]`` the utterance lengths on its
    device. Returns each shard's ``[B, Tl', F'*C]``, its conv lengths and
    its offset in conv frames. ``train`` takes each BN's statistics over
    the shards (``_bn``)."""
    dtype = getattr(torch, cfg.dtype)
    s = len(shards)
    tl = xs[0].shape[1]
    xs = [x.to(dtype)[:, None] for x in xs]  # NCHW: [B, 1, Tl, F]
    offs = [k * tl for k in range(s)]
    for i, (kt, kf, st, sf) in enumerate(cfg.conv_layers):
        halo_l, halo_r = _conv_halo(kt, st)
        # Every shard's neighbours' boundary frames, copied before any
        # shard computes this layer; an edge shard's are zeros.
        lefts, rights = [], []
        for k, dev in enumerate(shards.devices):
            b, c, t, f = xs[k].shape
            lefts.append(xs[k - 1][:, :, t - halo_l:].to(dev) if k > 0
                         else xs[k].new_zeros((b, c, halo_l, f)))
            rights.append(xs[k + 1][:, :, :halo_r].to(dev) if k < s - 1
                          else xs[k].new_zeros((b, c, halo_r, f)))
        convs, masks = [], []
        for k, dev in enumerate(shards.devices):
            with _on(dev):
                fe = shards.models[k].conv
                x = torch.cat([lefts[k], xs[k], rights[k]], dim=2)
                fdim = x.shape[3]
                pf_total = (-(-fdim // sf) - 1) * sf + kf - fdim
                pf = pf_total // 2
                x = F.pad(x, (pf, pf_total - pf, 0, 0))
                x = F.conv2d(x, getattr(fe, f"conv{i}").weight.to(dtype),
                             stride=(st, sf))
                lens[k] = -(-lens[k] // st)
                offs[k] //= st
                masks.append(_mask(offs[k], x.shape[2], lens[k]))
                convs.append(x.permute(0, 2, 3, 1))
        ys = _bn(shards, f"conv.bn{i}", convs, masks, train, stats)
        xs = []
        for y, mask in zip(ys, masks):
            y = clipped_relu(y, cfg.relu_clip)
            y = y * mask[:, :, None, None].to(y.dtype)
            xs.append(y.permute(0, 3, 1, 2))
    flat = []
    for x in xs:
        b, c, t, f = x.shape
        # [B, T', F', C] channel-fastest, as the offline frontend.
        flat.append(x.permute(0, 2, 3, 1).reshape(b, t, f * c))
    return flat, lens, offs


def _relay(cfg: ModelConfig, shards, xps, masks, layer: int,
           train: bool = False):
    """One layer's recurrence with the carry relayed across shards: each
    direction's chunks in relay order (forward 0 -> S-1, backward
    S-1 -> 0), issued interleaved so that the two relays overlap on
    distinct devices. ``xps[k]`` ``[Tl, B, GH]`` and ``masks[k]`` ``[Tl,
    B]`` are shard k's; returns each shard's summed ``[Tl, B, H]`` f32
    outputs (forward + backward, the offline order). ``train`` makes each
    chunk a ``GRUFunction`` or ``LSTMFunction`` call
    (``chunk_recurrence``'s ``grad``), the carry (``h``, or the LSTM's
    ``(h, c)``) a differentiable copy."""
    s = len(shards)
    dirs = ["fw", "bw"] if cfg.bidirectional else ["fw"]
    ys: Dict[Tuple[str, int], torch.Tensor] = {}
    carry = {d: None for d in dirs}
    for r in range(s):
        for sfx in dirs:
            k = r if sfx == "fw" else s - 1 - r
            dev = shards.devices[k]
            lay = getattr(shards.models[k].rnn, f"rnn{layer}")
            with _on(dev):
                c = carry[sfx]
                if c is not None:
                    c = (c.to(dev) if isinstance(c, torch.Tensor)
                         else tuple(x.to(dev) for x in c))
                ys[sfx, k], carry[sfx] = chunk_recurrence(
                    cfg, xps[k], masks[k], getattr(lay, f"wh_{sfx}"),
                    getattr(lay, f"bh_{sfx}"), sfx == "bw", c, train)
    out = []
    for k in range(s):
        with _on(shards.devices[k]):
            y = ys["fw", k]
            if cfg.bidirectional:
                y = y + ys["bw", k]
            out.append(y)
    return out


def _forward_shards(cfg: ModelConfig, shards, features, feat_lens,
                    train: bool = False):
    """Each shard's logits ``[B, T'/S, V]`` f32 on its device, the conv
    lengths ``[B]`` (on the first shard's device) and the BN statistics
    (``{BN submodule path: (mean, var)}``, this batch's over every shard
    in ``train``, else empty). ``shards`` is a ``Replicas`` (decoding,
    under ``torch.inference_mode``) or a ``_TrainShards`` (``train``,
    under autograd)."""
    s = len(shards)
    feats = torch.as_tensor(features)
    lens0 = torch.as_tensor(feat_lens).long()
    tl = feats.shape[1] // s
    xs, lens = [], []
    for k, dev in enumerate(shards.devices):
        xs.append(feats[:, k * tl:(k + 1) * tl].to(dev, torch.float32))
        lens.append(lens0.to(dev))
    dtype = getattr(torch, cfg.dtype)
    stats: dict = {}
    with contextlib.nullcontext() if train else torch.inference_mode():
        xs, lens, offs = _conv_sp(cfg, shards, xs, lens, train, stats)
        masks = [_mask(offs[k], xs[k].shape[1], lens[k])
                 for k in range(s)]
        masks_t = [m.t().contiguous() for m in masks]
        for i in range(cfg.rnn_layers):
            if cfg.rnn_batch_norm:
                xs = _bn(shards, f"rnn.rnn{i}.bn", xs, masks, train, stats)
            xps = []
            for k, dev in enumerate(shards.devices):
                with _on(dev):
                    lay = getattr(shards.models[k].rnn, f"rnn{i}")
                    xps.append(layer_input(cfg, xs[k], weight(lay.wx.kernel),
                                           lay.wx.bias))
            outs = _relay(cfg, shards, xps, masks_t, i, train)
            for k, dev in enumerate(shards.devices):
                with _on(dev):
                    xs[k] = layer_output(cfg, outs[k], masks[k])
        xs = _bn(shards, "bn_out", xs, masks, train, stats)
        logits = []
        for k, dev in enumerate(shards.devices):
            with _on(dev):
                logits.append(shards.models[k].head(xs[k], dtype).float())
    return logits, lens[0], stats


def sp_forward(cfg: ModelConfig, model, features, feat_lens,
               devices: Devices, replicas: Optional[Replicas] = None
               ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Sequence-parallel offline forward: logits for utterances whose
    activations would not fit one device.

    ``model`` is the port's ``DeepSpeech2`` (standard tree, eval mode);
    ``features [B, T, F]`` with T % ``sp_frame_multiple(cfg, S)`` == 0
    (zeros past ``feat_lens``: padding frames are masked as offline);
    ``devices`` one entry a shard; ``replicas`` the model's
    ``Replicas`` over them when the caller keeps them (else made for this
    call). Returns (each shard's logits ``[B,
    T'/S, V]`` f32 on its device, in shard order, and the conv lengths
    ``[B]``): the offline forward's logits, split along T'.

    What sharding buys is memory: activations and logits live ``[T/S]``
    a shard. The recurrence does not split: each layer's two relays run
    the whole T in order (the chunks of one direction wait for each
    other); the conv, projections, BN and head split S ways.
    """
    _validate(cfg, devices, torch.as_tensor(features).shape[1])
    logits, lens, _ = _forward_shards(
        cfg, _replicas(model, devices, replicas), features, feat_lens)
    return logits, lens


def sp_greedy_decode(cfg: ModelConfig, model, features, feat_lens,
                     devices: Devices, replicas: Optional[Replicas] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy CTC ids for long audio: SP forward, argmax on each shard,
    only the int32 ids gathered (never the ``[T', V]`` logits). Returns
    numpy ``(ids [B, T'] int32, lens [B])``."""
    logits, lens = sp_forward(cfg, model, features, feat_lens, devices,
                              replicas)
    ids = [torch.argmax(l, dim=-1).to(torch.int32).cpu() for l in logits]
    return torch.cat(ids, dim=1).numpy(), lens.cpu().numpy()


def sp_beam_search(cfg: ModelConfig, model, features, feat_lens,
                   devices: Devices, beam_width: int, prune_top_k: int,
                   max_len: int, lm_table=None, merge_impl: str = "auto",
                   replicas: Optional[Replicas] = None):
    """Exact CTC prefix beam search over time-sharded long audio.

    ``beam_search_chunk`` scanned over chunks gives one offline scan's
    bits (``decode/beam.py``), and the relay hands the state across the
    shards once, in shard order: shard k advances ``BeamState`` over its
    own log-probs (with the fusion table ``lm_table`` on its device,
    ``Replicas.table``, when given) and hands the state to shard k+1;
    the last shard's state is finalized. The ``[T', V]`` log-probs never leave
    their shard. Returns ``beam_search``'s ``(prefixes [B, W, Lmax],
    lens [B, W], scores [B, W])`` on the last shard's device."""
    from ..decode.beam import beam_finalize, beam_init, beam_search_chunk

    _validate(cfg, devices, torch.as_tensor(features).shape[1])
    shards = _replicas(model, devices, replicas)
    logits, clens, _ = _forward_shards(cfg, shards, features, feat_lens)
    b, tl, _ = logits[0].shape
    state = None
    with torch.inference_mode():
        for k, dev in enumerate(shards.devices):
            with _on(dev):
                if state is None:
                    state = beam_init(b, beam_width, max_len, device=dev)
                else:
                    state = type(state)(*(f.to(dev) for f in state))
                table = (None if lm_table is None
                         else shards.table(lm_table, dev))
                lp = torch.log_softmax(logits[k].float(), dim=-1)
                valid = _mask(k * tl, tl, clens.to(dev)) > 0
                state = beam_search_chunk(state, lp, valid,
                                          prune_top_k=prune_top_k,
                                          lm_table=table,
                                          merge_impl=merge_impl)
        return beam_finalize(state)


def sp_loss(cfg: ModelConfig, model, features, feat_lens, labels,
            label_lens, devices: Devices):
    """Mean CTC loss of a TRAIN-mode forward with the time axis sharded
    (JAX ``sp_loss``): activations, logits and the loss recursion all
    live ``[T/S]`` a shard. ``model`` is the port's ``DeepSpeech2`` (a
    GRU or LSTM model, the standard tree), its parameters on the home
    device;
    ``features [B, T, F]`` with T % ``sp_frame_multiple(cfg, S)`` == 0,
    ``feat_lens [B]``, ``labels [B, L]``, ``label_lens [B]``; ``devices``
    one entry a shard (``[cpu] * 8``: eight shards on the CPU, the plain
    versions; ``[cuda:0] * 4``: four on one card, the kernels).

    Returns ``(loss, batch_stats)``: the batch-mean loss on the home
    device, whose ``backward()`` leaves in each parameter's ``.grad`` the
    gradient of the offline step, and each masked BN's statistics of
    this batch, ``{BN submodule path: (mean, var)}`` on the home device
    (the caller applies the momentum, ``MaskedBatchNorm.update``, as
    JAX's step does). The BN running buffers are not read or written.
    Per layer and direction each shard runs one ``gru_fwd`` (K6, or K8)
    and, in the backward, one ``gru_bwd`` (K7, or K9) at D=1; an LSTM
    model one taped ``lstm_fwd`` (K12 at ds2_small's H=800, or K14 at
    ds2_full's H=1760) and one ``lstm_bwd`` (K13, or K15) at D=1, both
    with the carry; the loss one taped ``ctc_alpha`` (K1) and one
    ``ctc_beta`` (K2) a shard."""
    feats = torch.as_tensor(features)
    _validate(cfg, devices, feats.shape[1])
    home = next(model.parameters()).device
    logits, clens, stats = _forward_shards(
        cfg, _TrainShards(model, devices), feats, feat_lens, train=True)
    per_utt = sp_ctc_loss(logits, torch.as_tensor(labels).to(home),
                          clens.to(home), torch.as_tensor(label_lens).to(home))
    return per_utt.mean(), {k: (m.to(home), v.to(home))
                            for k, (m, v) in stats.items()}
