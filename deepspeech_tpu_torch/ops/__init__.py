"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (``gru.py``), and their build (``_build.py``)."""
