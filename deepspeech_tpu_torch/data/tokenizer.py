"""Character tokenizers for CTC.

English: blank + 26 letters + space + apostrophe = 29 symbols.
Mandarin: blank + a character inventory from a vocab file or corpus.
Blank id is always 0.
"""

from __future__ import annotations

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
