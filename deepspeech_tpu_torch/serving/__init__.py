"""The port's copy of the serving plane's jax-free pieces: the tier-aware
rung ladder (``ladder.py``)."""
