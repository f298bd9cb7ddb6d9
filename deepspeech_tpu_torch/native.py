"""ctypes bindings of the port's C++ host decoder (``csrc/host``).

The port's copy of the decoder part of the JAX package's
``native/bindings.py``. Each wrapper has the signature and return value
of its pure-Python oracle, so the two are interchangeable:

  NativeNGram               <-> decode.ngram.NGramLM
  beam_search_native        <-> decode.beam_host.prefix_beam_search_host
  beam_search_batch_native  -> one threaded C++ call over a batch

The library is built with ``g++`` at first use (``ops/_build.py``
``load_host``). ``available()`` says whether it built and loaded;
``build_error()`` why not. ``beam_search_batch_native.calls`` counts
the batched searches, so a caller can show that the C++ search ran.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_int32_p = ctypes.POINTER(ctypes.c_int32)
_c_char_pp = ctypes.POINTER(ctypes.c_char_p)
_ABI_VERSION = 1

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _load():
    """The configured library, or None with the reason in ``_error``."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        from .ops import _build

        try:
            lib = _build.load_host()
            lib.ds2n_abi_version.restype = ctypes.c_int
            got = lib.ds2n_abi_version()
            if got != _ABI_VERSION:
                raise RuntimeError(f"host decoder ABI {got} != expected "
                                   f"{_ABI_VERSION}")
            _configure(lib)
            _lib = lib
        except (OSError, RuntimeError) as e:
            _error = str(e)
        return _lib


def _configure(lib) -> None:
    lib.ds2n_lm_load.restype = ctypes.c_void_p
    lib.ds2n_lm_load.argtypes = [ctypes.c_char_p]
    lib.ds2n_lm_free.argtypes = [ctypes.c_void_p]
    lib.ds2n_lm_order.restype = ctypes.c_int
    lib.ds2n_lm_order.argtypes = [ctypes.c_void_p]
    lib.ds2n_lm_score_word.restype = ctypes.c_double
    lib.ds2n_lm_score_word.argtypes = [
        ctypes.c_void_p, _c_char_pp, ctypes.c_int, ctypes.c_char_p,
        ctypes.c_int]
    lib.ds2n_lm_score_sentence.restype = ctypes.c_double
    lib.ds2n_lm_score_sentence.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ds2n_beam_search.restype = ctypes.c_int
    lib.ds2n_beam_search.argtypes = [
        _c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, _c_char_pp, _c_int32_p, _c_int32_p, _c_float_p,
        ctypes.c_int, ctypes.c_int]
    lib.ds2n_beam_search_batch.restype = ctypes.c_int
    lib.ds2n_beam_search_batch.argtypes = [
        _c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _c_int32_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_float, ctypes.c_int, _c_char_pp,
        _c_int32_p, _c_int32_p, _c_float_p, _c_int32_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int]
    lib.ds2n_last_error.restype = ctypes.c_char_p


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _error


def _lib_or_raise():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"host decoder unavailable: {_error}")
    return lib


def _last_error(lib) -> str:
    msg = lib.ds2n_last_error()
    return msg.decode("utf-8", "replace") if msg else ""


def _as_float32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _str_array(strings: Sequence[str]):
    arr = (ctypes.c_char_p * len(strings))()
    arr[:] = [s.encode("utf-8") for s in strings]
    return arr


class NativeNGram:
    """C++ ARPA n-gram LM; the scoring interface of
    ``decode.ngram.NGramLM``."""

    def __init__(self, arpa_path: str):
        self._lib = _lib_or_raise()
        self._handle = self._lib.ds2n_lm_load(arpa_path.encode("utf-8"))
        if not self._handle:
            raise ValueError(
                f"failed to load ARPA LM: {_last_error(self._lib)}")
        self.order = self._lib.ds2n_lm_order(self._handle)

    def score_word(self, history_words: Sequence[str], word: str,
                   eos: bool = False) -> float:
        hist = _str_array([w for w in history_words])
        return self._lib.ds2n_lm_score_word(
            self._handle, hist, len(hist), word.encode("utf-8"),
            1 if eos else 0)

    def score_sentence(self, sentence: str, include_eos: bool = True
                       ) -> float:
        return self._lib.ds2n_lm_score_sentence(
            self._handle, sentence.encode("utf-8"), 1 if include_eos else 0)

    @property
    def handle(self) -> int:
        return self._handle

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.ds2n_lm_free(handle)
            self._handle = None


def _vocab_strings(id_to_char, v: int) -> List[str]:
    return [id_to_char(i) for i in range(v)]


def beam_search_native(
    log_probs: np.ndarray,
    beam_width: int = 64,
    blank_id: int = 0,
    prune_log_prob: float = -float("inf"),
    lm: Optional[NativeNGram] = None,
    lm_alpha: float = 0.5,
    lm_beta: float = 1.0,
    space_id: Optional[int] = None,
    id_to_char=None,
    nbest: Optional[int] = None,
    max_len: Optional[int] = None,
) -> List[Tuple[Tuple[int, ...], float]]:
    """One-utterance CTC prefix beam search in C++: the arguments and
    return value of ``decode.beam_host.prefix_beam_search_host``; ``lm``
    must be a ``NativeNGram`` (the C++ engine scores inside the loop)."""
    lib = _lib_or_raise()
    lp = _as_float32(log_probs)
    t, v = lp.shape
    nbest = beam_width if nbest is None else nbest
    max_len = max(t if max_len is None else max_len, 1)
    tok = None
    if lm is not None:
        if id_to_char is None:
            raise ValueError("LM fusion needs id_to_char")
        tok = _str_array(_vocab_strings(id_to_char, v))
    out_ids = np.zeros((nbest, max_len), dtype=np.int32)
    out_lens = np.zeros((nbest,), dtype=np.int32)
    out_scores = np.zeros((nbest,), dtype=np.float32)
    n = lib.ds2n_beam_search(
        lp.ctypes.data_as(_c_float_p), t, v, beam_width, blank_id,
        ctypes.c_float(prune_log_prob),
        lm.handle if lm is not None else None,
        ctypes.c_float(lm_alpha), ctypes.c_float(lm_beta),
        -1 if space_id is None else space_id, tok,
        out_ids.ctypes.data_as(_c_int32_p),
        out_lens.ctypes.data_as(_c_int32_p),
        out_scores.ctypes.data_as(_c_float_p), nbest, max_len)
    if n < 0:
        raise RuntimeError(f"ds2n_beam_search: {_last_error(lib)}")
    return [(tuple(int(x) for x in out_ids[i, :out_lens[i]]),
             float(out_scores[i])) for i in range(n)]


def beam_search_batch_native(
    log_probs: np.ndarray,
    feat_lens: Optional[np.ndarray] = None,
    beam_width: int = 64,
    blank_id: int = 0,
    prune_log_prob: float = -float("inf"),
    lm: Optional[NativeNGram] = None,
    lm_alpha: float = 0.5,
    lm_beta: float = 1.0,
    space_id: Optional[int] = None,
    id_to_char=None,
    nbest: int = 1,
    max_len: Optional[int] = None,
    n_threads: int = 0,
) -> List[List[Tuple[Tuple[int, ...], float]]]:
    """Batched threaded decode: log_probs [B, T, V] -> per-utterance
    n-best lists (each as ``beam_search_native`` returns it)."""
    lib = _lib_or_raise()
    lp = _as_float32(log_probs)
    b, t, v = lp.shape
    lens = (np.full((b,), t, np.int32) if feat_lens is None
            else np.ascontiguousarray(feat_lens, np.int32))
    max_len = max(t if max_len is None else max_len, 1)
    tok = None
    if lm is not None:
        if id_to_char is None:
            raise ValueError("LM fusion needs id_to_char")
        tok = _str_array(_vocab_strings(id_to_char, v))
    out_ids = np.zeros((b, nbest, max_len), dtype=np.int32)
    out_lens = np.zeros((b, nbest), dtype=np.int32)
    out_scores = np.zeros((b, nbest), dtype=np.float32)
    out_counts = np.zeros((b,), dtype=np.int32)
    rc = lib.ds2n_beam_search_batch(
        lp.ctypes.data_as(_c_float_p), b, t, v,
        lens.ctypes.data_as(_c_int32_p), beam_width, blank_id,
        ctypes.c_float(prune_log_prob),
        lm.handle if lm is not None else None,
        ctypes.c_float(lm_alpha), ctypes.c_float(lm_beta),
        -1 if space_id is None else space_id, tok,
        out_ids.ctypes.data_as(_c_int32_p),
        out_lens.ctypes.data_as(_c_int32_p),
        out_scores.ctypes.data_as(_c_float_p),
        out_counts.ctypes.data_as(_c_int32_p), nbest, max_len, n_threads)
    if rc != 0:
        raise RuntimeError(f"ds2n_beam_search_batch: {_last_error(lib)}")
    beam_search_batch_native.calls += 1
    return [
        [(tuple(int(x) for x in out_ids[i, k, :out_lens[i, k]]),
          float(out_scores[i, k])) for k in range(out_counts[i])]
        for i in range(b)
    ]


beam_search_batch_native.calls = 0
