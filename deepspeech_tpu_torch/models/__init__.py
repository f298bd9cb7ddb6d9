"""DS2 model family in PyTorch."""

from .ds2 import DeepSpeech2

__all__ = ["DeepSpeech2"]
