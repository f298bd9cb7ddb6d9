"""Dataset manifests: JSON lines, one utterance a line.

Each line: ``{"audio": "/path/x.wav", "text": "the transcript",
"duration": 3.2}`` (duration in seconds). The port's own copy of the
JAX package's ``data/manifest.py``: the same fields, bounds and error
messages, so one manifest feeds both.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List


@dataclass(frozen=True)
class Utterance:
    audio: str
    text: str
    duration: float


def load_manifest(path: str, min_duration_s: float = 0.0,
                  max_duration_s: float = float("inf")) -> List[Utterance]:
    """The utterances of ``path`` whose duration lies within the
    bounds; raises ``ValueError`` on a bad line or when none is left."""
    utts: List[Utterance] = []
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                utt = Utterance(rec["audio"], rec["text"],
                                float(rec["duration"]))
            except (json.JSONDecodeError, KeyError, ValueError) as e:
                raise ValueError(f"{path}:{ln}: bad manifest line") from e
            if min_duration_s <= utt.duration <= max_duration_s:
                utts.append(utt)
    if not utts:
        raise ValueError(f"{path}: no utterances within duration bounds")
    return utts


def save_manifest(path: str, utts: List[Utterance]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for u in utts:
            f.write(json.dumps(
                {"audio": u.audio, "text": u.text, "duration": u.duration},
                ensure_ascii=False) + "\n")
