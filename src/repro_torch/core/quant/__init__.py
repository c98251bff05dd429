"""Quantization of the port: fixed-point Q-formats, the pow2 codebook,
4-bit code packing, and the Fig. 3 bit-width exploration
(``bitwidth_search``). Exports what ``repro.core.quant`` exports."""
from repro_torch.core.quant.fixed_point import (
    FixedPointSpec,
    quantize_fixed,
    dequantize_fixed,
    fake_quant,
    fake_quant_ste,
)
from repro_torch.core.quant.pow2 import (
    ParamClassStats,
    classify_params,
    project_pow2,
    pow2_codes,
    decode_pow2,
    POW2_ZERO_CODE,
)
from repro_torch.core.quant.packing import pack_codes_u4, unpack_codes_u4
from repro_torch.core.quant.bitwidth_search import (
    BitwidthSearchResult,
    search_bitwidth,
    search_plan_bitwidths,
)

__all__ = [
    "FixedPointSpec",
    "quantize_fixed",
    "dequantize_fixed",
    "fake_quant",
    "fake_quant_ste",
    "ParamClassStats",
    "classify_params",
    "project_pow2",
    "pow2_codes",
    "decode_pow2",
    "POW2_ZERO_CODE",
    "pack_codes_u4",
    "unpack_codes_u4",
    "BitwidthSearchResult",
    "search_bitwidth",
    "search_plan_bitwidths",
]
