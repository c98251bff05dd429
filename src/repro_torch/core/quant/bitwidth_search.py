"""Bit-width exploration (paper Fig. 3).

The paper selects each network's fixed-point width by sweeping bit-widths and
keeping the smallest one whose (optionally fine-tuned) accuracy stays within
an acceptable drop of the float baseline (3 bits for LeNet5, 6 for
SVHN/CIFAR10). This harness is model-agnostic: callers supply

  eval_quantized(bits)  -> accuracy of the model quantized at ``bits``
                           (the callable decides whether to fine-tune, mirror
                           the paper's footnote-2 retraining, etc.)

and the float baseline accuracy.

The counterpart of ``repro.core.quant.bitwidth_search``. The compiler
knob, :func:`search_plan_bitwidths`, compiles ``repro_torch`` plans: on
the card (the default device) an ``int8_compute`` sweep runs the int8
kernels; ``device="cpu"`` among the compile keywords runs the plain
versions.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence


@dataclasses.dataclass(frozen=True)
class BitwidthSearchResult:
    float_accuracy: float
    accuracy_by_bits: Mapping[int, float]
    selected_bits: int
    max_drop: float

    def curve(self) -> list:
        """(bits, accuracy) pairs, ascending bits — the Fig. 3 curve."""
        return sorted(self.accuracy_by_bits.items())


def search_bitwidth(
    eval_quantized: Callable[[int], float],
    *,
    float_accuracy: float,
    bit_range: Sequence[int] = (2, 3, 4, 5, 6, 7, 8),
    max_drop: float = 0.04,
) -> BitwidthSearchResult:
    """Sweep bit-widths ascending; select the smallest within ``max_drop``
    (absolute accuracy drop) of the float baseline.

    The full curve is evaluated (not early-stopped) because the paper reports
    the whole exploration, and the curve is itself a deliverable (Fig. 3).
    """
    accs = {int(b): float(eval_quantized(int(b))) for b in bit_range}
    selected = max(bit_range)
    for b in sorted(accs):
        if float_accuracy - accs[b] <= max_drop:
            selected = b
            break
    return BitwidthSearchResult(
        float_accuracy=float(float_accuracy),
        accuracy_by_bits=accs,
        selected_bits=int(selected),
        max_drop=float(max_drop),
    )


def search_plan_bitwidths(
    topo,
    params: dict,
    evaluate: Callable,
    *,
    float_accuracy: float,
    bit_range: Sequence[int] = (2, 3, 4, 5, 6, 7, 8),
    max_drop: float = 0.04,
    int8_compute: bool = False,
    **compile_kw,
):
    """The Fig. 3 sweep as a COMPILER knob: each candidate width compiles
    to a real :class:`~repro_torch.core.dhm.compiler.CompiledDHM` (weights and
    feature-stream quantization baked at that width) and ``evaluate(plan)``
    scores it; the selected width lands on the returned plan as a
    ``QuantSpec.per_layer_bits`` attribute — a compile-time plan property
    the cost model and invariants can see, not an offline note.

    ``int8_compute=True`` restricts the sweep to widths <= 8 and compiles
    the candidates (and the final plan) on the true-integer path.

    Returns ``(BitwidthSearchResult, CompiledDHM)`` — the curve plus the
    plan compiled at the selected width.
    """
    from repro_torch.core.dhm.compiler import QuantSpec, compile_dhm

    bits = [int(b) for b in bit_range]
    if int8_compute:
        bits = [b for b in bits if b <= 8]
        if not bits:
            raise ValueError(
                f"int8_compute sweep needs widths <= 8, got {bit_range}"
            )

    def _plan(b: int):
        return compile_dhm(
            topo,
            params,
            quant=QuantSpec(
                weight_bits=b, act_bits=b, int8_compute=int8_compute
            ),
            **compile_kw,
        )

    result = search_bitwidth(
        lambda b: evaluate(_plan(b)),
        float_accuracy=float_accuracy,
        bit_range=bits,
        max_drop=max_drop,
    )
    b = result.selected_bits
    final = compile_dhm(
        topo,
        params,
        quant=QuantSpec(
            weight_bits=b,
            act_bits=b,
            int8_compute=int8_compute,
            per_layer_bits=(b,) * len(topo.conv_layers),
        ),
        **compile_kw,
    )
    return result, final
