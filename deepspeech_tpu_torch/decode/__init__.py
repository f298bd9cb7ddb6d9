"""CTC decoding: greedy (``greedy.py``), the on-device prefix beam
search (``beam.py``) with dense or hashed LM fusion tables
(``ngram.py``, ``hashed_lm.py``), and the host prefix beam search
(``beam_host.py``)."""

from .beam import (beam_finalize, beam_init, beam_search,
                   beam_search_chunk)
from .beam_host import exhaustive_ctc_best, prefix_beam_search_host
from .greedy import greedy_decode, ids_to_texts
from .ngram import (NGramLM, dense_fusion_table,
                    fusion_table_for, load_lm, rescore_nbest)

__all__ = [
    "beam_finalize",
    "beam_init",
    "beam_search",
    "beam_search_chunk",
    "dense_fusion_table",
    "fusion_table_for",
    "exhaustive_ctc_best",
    "greedy_decode",
    "ids_to_texts",
    "load_lm",
    "NGramLM",
    "prefix_beam_search_host",
    "rescore_nbest",
]
