"""CTC decoding (greedy so far: ``greedy.py``)."""
