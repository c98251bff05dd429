"""Model-level quantization analysis shared by benchmarks and examples."""
from __future__ import annotations

import torch

from repro_torch.core.quant.fixed_point import FixedPointSpec, quantize_fixed
from repro_torch.core.quant.pow2 import ParamClassStats, classify_params


def classify_model(params: dict, bits: int) -> ParamClassStats:
    """Aggregate zero/one/pow2/other fractions over a CNN's conv stack
    (paper Table 1)."""
    counts = {"zero": 0.0, "one": 0.0, "pow2": 0.0, "other": 0.0, "total": 0}
    for layer in params["conv"]:
        w = torch.as_tensor(layer["w"])
        spec = FixedPointSpec.for_tensor(w, bits)
        stats = classify_params(quantize_fixed(w, spec), spec.frac_bits)
        for k in ("zero", "one", "pow2", "other"):
            counts[k] += getattr(stats, k) * stats.total
        counts["total"] += stats.total
    t = counts["total"]
    return ParamClassStats(
        zero=counts["zero"] / t,
        one=counts["one"] / t,
        pow2=counts["pow2"] / t,
        other=counts["other"] / t,
        total=t,
    )
