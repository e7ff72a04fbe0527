"""fast_ctc_decode_tpu — a CTC decoding engine on JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
nanoporetech/fast-ctc-decode (reference mounted at /root/reference):
viterbi, CTC prefix beam search, CRF greedy/beam decoders, and 2-D duplex
pair-consensus decoding — as batched, shardable device kernels with a
reference-parity single-read API on top.

Public surface mirrors the reference module (src/lib.rs:617-628):
beam_search, beam_search_duplex, viterbi_search, crf_greedy_search,
crf_beam_search, crf_beam_search_duplex, __version__.
"""

from .api import (
    beam_search,
    beam_search_duplex,
    crf_beam_search,
    crf_beam_search_duplex,
    crf_greedy_search,
    viterbi_search,
)
from .errors import SearchError

__version__ = "0.1.0"

__all__ = [
    "beam_search",
    "beam_search_duplex",
    "viterbi_search",
    "crf_greedy_search",
    "crf_beam_search",
    "crf_beam_search_duplex",
    "SearchError",
    "__version__",
]
