"""Utilities of the port: weight-only int8 quantization (``quantize.py``)."""
