"""Quantization of the port: fixed-point Q-formats, the pow2 codebook,
4-bit code packing, and the Fig. 3 bit-width exploration
(``bitwidth_search``)."""
from repro_torch.core.quant.bitwidth_search import (
    BitwidthSearchResult,
    search_bitwidth,
    search_plan_bitwidths,
)

__all__ = ["BitwidthSearchResult", "search_bitwidth", "search_plan_bitwidths"]
