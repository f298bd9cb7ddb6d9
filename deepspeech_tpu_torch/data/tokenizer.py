"""Character tokenizers for CTC.

English: blank + 26 letters + space + apostrophe = 29 symbols.
Mandarin: blank + a character inventory from a vocab file or corpus.
Blank id is always 0. ``resolve_tokenizer`` is the one policy train
and infer share (the JAX package's, in the same order).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Optional, Sequence

BLANK_ID = 0

_EN_CHARS = " 'abcdefghijklmnopqrstuvwxyz"


class CharTokenizer:
    """Maps text <-> int label sequences. Index 0 is reserved for blank."""

    def __init__(self, chars: Sequence[str]):
        self.chars = list(chars)
        self._to_id = {c: i + 1 for i, c in enumerate(self.chars)}
        self.blank_id = BLANK_ID

    @property
    def vocab_size(self) -> int:
        """Number of CTC classes including blank."""
        return len(self.chars) + 1

    def encode(self, text: str) -> List[int]:
        return [self._to_id[c] for c in self.normalize(text) if c in self._to_id]

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == self.blank_id:
                continue
            out.append(self.chars[i - 1])
        return "".join(out)

    def normalize(self, text: str) -> str:
        return text.lower()

    @classmethod
    def english(cls) -> "CharTokenizer":
        return cls(list(_EN_CHARS))

    @classmethod
    def from_vocab_file(cls, path: str) -> "CharTokenizer":
        """One character per line; line order defines ids 1..N."""
        with open(path, encoding="utf-8") as f:
            chars = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        return cls(chars)

    @classmethod
    def from_corpus(cls, texts: Iterable[str]) -> "CharTokenizer":
        """Character inventory in first-appearance order."""
        seen = {}
        for t in texts:
            for c in t:
                if c not in seen:
                    seen[c] = len(seen)
        return cls(sorted(seen, key=seen.get))

    def save_vocab(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for c in self.chars:
                f.write(c + "\n")

    @classmethod
    def synthetic_zh(cls, n: int = 100) -> "CharTokenizer":
        """N distinct CJK characters (tests and smoke runs of the
        Mandarin path without a corpus)."""
        return cls([chr(0x4E00 + i) for i in range(n)])


def resolve_tokenizer(cfg, utterances=None, synthetic: bool = False,
                      vocab_override: str = "", for_training: bool = False):
    """Build the tokenizer, persist a derived vocab, and resize
    ``cfg.model.vocab_size`` to match. In order:

      1. an explicit vocab file (``vocab_override`` or
         ``cfg.data.vocab_path``);
      2. ``<checkpoint_dir>/vocab.txt`` saved by a training run;
      3. the English alphabet;
      4. the synthetic zh inventory (``synthetic``);
      5. training only: a zh inventory from the ``utterances``'
         transcripts, saved to ``<checkpoint_dir>/vocab.txt``.
         Inference never derives one from its (eval) transcripts: their
         first-appearance order would permute the id->char map, so it
         raises instead.

    Returns ``(tokenizer, cfg)``; build pipelines and models from the
    returned cfg.
    """
    ckpt_vocab = (os.path.join(cfg.train.checkpoint_dir, "vocab.txt")
                  if cfg.train.checkpoint_dir else "")
    vocab = vocab_override or cfg.data.vocab_path
    if not vocab and ckpt_vocab and os.path.exists(ckpt_vocab):
        vocab = ckpt_vocab
    if vocab:
        tok = CharTokenizer.from_vocab_file(vocab)
    elif cfg.data.language == "en":
        tok = CharTokenizer.english()
    elif synthetic:
        tok = CharTokenizer.synthetic_zh()
    elif utterances is not None and for_training:
        tok = CharTokenizer.from_corpus(u.text for u in utterances)
        if ckpt_vocab:
            os.makedirs(cfg.train.checkpoint_dir, exist_ok=True)
            tok.save_vocab(ckpt_vocab)
    else:
        raise ValueError(
            f"language {cfg.data.language!r} needs a vocab file, a saved "
            f"checkpoint vocab ({ckpt_vocab or '<no checkpoint dir>'}), or "
            "(training only) corpus transcripts to derive one from")
    if tok.vocab_size != cfg.model.vocab_size:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, vocab_size=tok.vocab_size))
    return tok, cfg


def get_tokenizer(language: str, vocab_path: str = "",
                  corpus_texts: Optional[Iterable[str]] = None
                  ) -> CharTokenizer:
    """The tokenizer for a language: a vocab file wins; English has a
    fixed alphabet; Mandarin needs a vocab file or corpus transcripts."""
    if vocab_path:
        return CharTokenizer.from_vocab_file(vocab_path)
    if language == "en":
        return CharTokenizer.english()
    if language == "zh":
        if corpus_texts is not None:
            return CharTokenizer.from_corpus(corpus_texts)
        raise ValueError(
            "language 'zh' needs a vocab file or corpus transcripts "
            "(pass vocab_path or corpus_texts)")
    raise ValueError(f"unknown language {language!r}")
