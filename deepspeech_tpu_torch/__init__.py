"""PyTorch/CUDA port of deepspeech_tpu, for NVIDIA Hopper (H100).

The JAX package ``deepspeech_tpu`` is the reference; this package keeps
its module layout and names so each module's counterpart is easy to
find, and imports nothing from it (nor ``jax``/``flax``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``). Every kernel wrapper launches its
hand-written CUDA kernel for a CUDA tensor and runs its plain PyTorch
version only for a CPU tensor.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
