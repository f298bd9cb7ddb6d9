"""Weight-only int8 post-training quantization for inference.

The port's copy of ``deepspeech_tpu/utils/quantize.py``, on the
flax-layout nested dicts of numpy arrays that ``bridge`` reads: the
same leaves quantize (every matmul/conv kernel and the recurrent
matrices, by path suffix, 2-D and up), symmetric absmax per output
channel (the last axis; pipeline-stacked ``[L, d, C]`` leaves per layer
and channel), ``rint``, clip to +-127, a zero scale replaced by 1, and
the same report. Run on the same numpy tree, ``quantize_params`` gives
the JAX package's int8 values and scales bit for bit.

What stays f32: biases, BN scales, biases and statistics, the lookahead
weights, anything 1-D. The model (``models/``) holds the quantized
leaves int8 on the device and dequantizes them as ``q * scale`` in f32
where the forward uses them, except the recurrent matrices, which go
int8 into ``ops/gru.py``'s ``gru_fwd_q`` (GRU) or ``ops/lstm.py``'s
``lstm_fwd_q`` (LSTM).

``keep_recurrent_q`` and ``kernel_regime`` answer by the Hopper
residency rule (``ops/gru.py`` ``resident_fits("fwd_q", ...)``, or
``"lstm_fwd_q"`` for an LSTM), not by the TPU's 10 MB VMEM budget:
``csrc/gru_fwd_q.cu`` (K10) / ``csrc/lstm_fwd_q.cu`` (K16) hold int8 W
(K16 with bf16 dots as Q^T widened to bf16) where the grid's shared
memory can, ``csrc/gru_fwd_q_stream.cu`` (K11) /
``csrc/lstm_fwd_q_stream.cu`` (K17) stream it elsewhere.
"""

from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..ops import gru

# Kernel-bearing leaves: flax Dense/Conv kernels, the recurrent
# matrices, and the stacked pipelined variants.
_QUANT_SUFFIXES = re.compile(r"(kernel|wh_fw|wh_bw|wx_kernel)$")
# Pipeline-stacked RNN leaves ([L, d, G]): per-(layer, channel) scales.
_STACKED_SUFFIXES = re.compile(r"(wh_fw|wh_bw|wx_kernel)$")

_INT8_MAX = 127.0

# How many times PTQ ran in this process: once per engine at init, never
# per request.
QUANTIZE_CALLS = 0


def should_quantize(path: str, leaf) -> bool:
    return (_QUANT_SUFFIXES.search(path) is not None
            and getattr(leaf, "ndim", 0) >= 2)


def is_qleaf(x) -> bool:
    """A weight-only int8 leaf: a mapping with exactly ``q`` and
    ``scale``."""
    return isinstance(x, Mapping) and set(x) == {"q", "scale"}


def _map(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """``tree`` with ``fn(path, leaf)`` applied to each leaf; a qleaf is
    a leaf. Paths join keys with "/", as the JAX package's do."""
    if isinstance(tree, Mapping) and not is_qleaf(tree):
        return {k: _map(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    return fn(prefix[:-1], tree)


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, Mapping) and not is_qleaf(tree):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def quantize_params(params) -> Tuple[Dict[str, Any], Dict[str, int]]:
    """params -> (qtree, report).

    ``qtree`` mirrors ``params`` except that each quantized leaf becomes
    ``{"q": int8 [..., C], "scale": f32 [C]}`` (``[L, 1, C]`` for a
    stacked ``[L, d, C]`` leaf), numpy arrays. ``report`` counts the
    quantized and kept leaves and the bytes before and after.
    """
    global QUANTIZE_CALLS
    QUANTIZE_CALLS += 1
    report = {"quantized": 0, "kept": 0, "bytes_before": 0,
              "bytes_after": 0}

    def one(path, leaf):
        arr = np.asarray(leaf)
        report["bytes_before"] += arr.nbytes
        if not should_quantize(path, arr):
            report["kept"] += 1
            report["bytes_after"] += arr.nbytes
            return leaf
        if arr.ndim == 3 and _STACKED_SUFFIXES.search(path):
            absmax = np.max(np.abs(arr), axis=1, keepdims=True)
        else:
            absmax = np.max(np.abs(arr.reshape(-1, arr.shape[-1])),
                            axis=0)
        scale = (absmax / _INT8_MAX).astype(np.float32)
        scale = np.where(scale == 0.0, 1.0, scale)
        q = np.clip(np.rint(arr / scale), -127, 127).astype(np.int8)
        report["quantized"] += 1
        report["bytes_after"] += q.nbytes + scale.nbytes
        return {"q": q, "scale": scale}

    return _map(one, params), report


def dequantize_params(qtree, dtype=np.float32,
                      keep: Optional[Callable[[str], bool]] = None):
    """qtree -> params with each quantized leaf ``q * scale`` in
    ``dtype``; a leaf whose path ``keep`` accepts stays ``{"q",
    "scale"}``."""

    def one(path, x):
        if not is_qleaf(x):
            return x
        if keep is not None and keep(path):
            return dict(x)
        return (np.asarray(x["q"]).astype(dtype)
                * np.asarray(x["scale"]).astype(dtype))

    return _map(one, qtree)


def quantization_error(params, qtree) -> float:
    """Max relative L2 error over quantized leaves (diagnostics)."""
    deq = dict(_leaves(dequantize_params(qtree)))
    errs = []
    for path, a in _leaves(params):
        a, b = np.asarray(a, np.float64), np.asarray(deq[path], np.float64)
        denom = np.linalg.norm(a)
        if should_quantize(path, a) and denom > 0:
            errs.append(float(np.linalg.norm(a - b) / denom))
    return max(errs) if errs else 0.0


_Q_KIND = {"gru": "fwd_q", "lstm": "lstm_fwd_q"}


def _resident(model_cfg, card: Tuple[int, ...]) -> bool:
    """The Hopper residency rule for the int8 recurrence of this model,
    on a card with ``card``'s (sms, smem_per_block, smem_per_sm), an
    H100's by default: ``csrc/gru_fwd_q.cu`` (GRU) holds D x ceil(H/16)
    int8 slices; ``csrc/lstm_fwd_q.cu`` (LSTM) with bf16 dots (the
    model's dtype) and H % 8 == 0 holds Q^T widened to bf16 in K12's
    tensor-core groups (H up to 1056 at D=2 and 1216 at D=1, whatever
    the batch), else D x ceil(H/16) int8 slices beside the cell state.
    Judged at one batch row: only the LSTM's CUDA-core kernel reads the
    batch, its cell state adding 64 bytes a row to a block."""
    d = 2 if model_cfg.bidirectional else 1
    return gru.resident_fits(_Q_KIND[model_cfg.rnn_type], d,
                             model_cfg.rnn_hidden, 1,
                             getattr(torch, model_cfg.dtype), *card)


def keep_recurrent_q(model_cfg, streaming: bool = False,
                     card: Tuple[int, ...] = ()
                     ) -> Optional[Callable[[str], bool]]:
    """The ``keep`` predicate for ``dequantize_params`` when the engine
    threads the recurrent matrices int8 into ``gru_fwd_q``, else None
    (every leaf dequantized). The port's GRU and LSTM layers always run
    the q kernels (its ``rnn_impl`` "auto" and "pallas" both mean them),
    for a non-pipelined model; ``streaming=True`` (the chunked engine,
    which carries ``h0``) also needs the resident kernel, as the JAX
    package's carried-state q kernel is resident-only (its rule,
    utils/quantize.py:160-167, with the card in place of the budget).
    ``card`` as ``_resident`` takes it."""
    if (model_cfg.rnn_type in _Q_KIND and model_cfg.pipeline_stages == 1
            and (not streaming or _resident(model_cfg, card))):
        return lambda path: path.endswith(("wh_fw", "wh_bw"))
    return None


def kernel_regime(model_cfg, quantized: bool, streaming: bool = False,
                  card: Tuple[int, ...] = ()) -> str:
    """Which recurrent-kernel regime an engine's forward runs in:
    ``"resident-q"`` (int8 W held in shared memory, K10 / K16),
    ``"blocked-q"`` (int8 W streamed every step, K11 / K17) or
    ``"fp"``."""
    if not quantized or keep_recurrent_q(model_cfg, streaming,
                                         card) is None:
        return "fp"
    return "resident-q" if _resident(model_cfg, card) else "blocked-q"
