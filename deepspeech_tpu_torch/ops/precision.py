"""Float32 matrix products at full float32 precision.

The JAX package forms the GRU's dW and the CTC vocab fold in f32 at
``Precision.HIGHEST``. On the card a float32 ``torch.matmul`` may run in
TF32 (about three decimal digits) when
``torch.backends.cuda.matmul.allow_tf32`` is set, so the port turns it
off around those products and restores the caller's setting after.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32_matmul():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
