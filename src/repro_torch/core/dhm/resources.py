"""FPGA resource model for DHM (paper §4.2, Tables 2-3).

Three multiplier-implementation strategies:

  DSP        : every multiplier uses one hardwired DSP block.
  LE         : every multiplier synthesized from logic elements (ALMs) —
               the paper's measured cost at 5 bits is exactly 17 ALMs per
               multiplier (433,500 ALMs / 25,500 multipliers), which pins the
               quadratic coefficient of the classic AND-gate + half-adder-
               tree construction [Altera app-note]: cost(b) = 0.68 * b^2.
  LE_CONST   : constant-coefficient specialization (the paper's tactic):
               x0 multipliers vanish, x1 are wires, x(2^k) are fixed shifts
               (routing, no logic); only "other" constants burn a generic
               LE multiplier. Adder trees shrink too: a zero weight removes
               its adder-tree input.

The model is calibrated against the paper's three published LeNet5@5bit
points (Table 2) and the cross-network proportions of Table 3. It consumes
parameter-class fractions (zero/one/pow2/other) either from the paper's
Table 1 or measured from a trained+quantized model via
``repro_torch.core.quant.pow2.classify_params``.

The counterpart of ``repro.core.dhm.resources``, pure Python and held for
equality with it. Every number here is the paper's FPGA's (Cyclone V,
Zynq-7045), not the card's.
"""
from __future__ import annotations

import dataclasses
import enum


class MultiplierStrategy(enum.Enum):
    DSP = "dsp"
    LE = "le"
    LE_CONST = "le_const"


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    """An FPGA device resource envelope."""

    name: str
    logic_cells: int  # ALMs (Intel) or slices (Xilinx)
    dsp_blocks: int
    bram_bits: int
    # Xilinx slices hold ~2x the logic of an Intel ALM for this construction;
    # the paper's LeNet5 pair (8067 ALMs vs 25031 slices incl. different FC
    # mapping) fixes the conversion factor per-device.
    logic_per_alm: float = 1.0


# Intel Cyclone V 5CGXFC9E7: 113,560 ALMs, 342 DSP blocks, 12,200 Kb M10K.
CYCLONE_V_5CGXFC9E7 = DeviceModel(
    name="cyclone_v_5cgxfc9e7",
    logic_cells=113_560,
    dsp_blocks=342,
    bram_bits=12_200 * 1024,
)

# Xilinx Zynq-7045 (XC7Z045, Kintex-7 fabric): 218,600 LUTs, 900 DSP48,
# 19.2 Mb BRAM. The paper's Table 3-b "Slices" percentages only make sense
# against the LUT count (172,219/218,600 = 79%), so the device is modeled in
# LUTs. The paper's own cross-device pairs give the LUT-per-ALM conversion:
# 25,031/8,067 = 3.10 (LeNet5), 172,219/51,276 = 3.36 (Cifar10),
# 136,675/39,513 = 3.46 (SVHN) -> 3.3.
KINTEX7_XC7Z045 = DeviceModel(
    name="kintex7_xc7z045",
    logic_cells=218_600,  # LUTs
    dsp_blocks=900,
    bram_bits=19_200 * 1024,
    logic_per_alm=3.3,
)


@dataclasses.dataclass(frozen=True)
class ParamClassFractions:
    zero: float
    one: float
    pow2: float
    other: float

    def __post_init__(self):
        tot = self.zero + self.one + self.pow2 + self.other
        if abs(tot - 1.0) > 1e-3:
            raise ValueError(f"fractions must sum to 1, got {tot}")


# Paper Table 1 fractions (percent -> fraction).
PAPER_TABLE1 = {
    "lenet5": ParamClassFractions(zero=0.8859, one=0.0631, pow2=0.0005, other=0.0505),
    "cifar10": ParamClassFractions(zero=0.3378, one=0.4532, pow2=0.1640, other=0.0450),
    "svhn": ParamClassFractions(zero=0.3714, one=0.4650, pow2=0.1362, other=0.0274),
}


@dataclasses.dataclass(frozen=True)
class ResourceReport:
    strategy: MultiplierStrategy
    device: DeviceModel
    logic_used: int
    dsp_used: int
    memory_bits: int

    @property
    def logic_utilization(self) -> float:
        return self.logic_used / self.device.logic_cells

    @property
    def dsp_utilization(self) -> float:
        return self.dsp_used / max(1, self.device.dsp_blocks)

    @property
    def fits(self) -> bool:
        return self.logic_utilization <= 1.0 and self.dsp_utilization <= 1.0

    def summary(self) -> str:
        return (
            f"{self.device.name:>22s} {self.strategy.value:>8s}: "
            f"logic {self.logic_used:>8d} ({100 * self.logic_utilization:5.1f}%) "
            f"dsp {self.dsp_used:>6d} ({100 * self.dsp_utilization:6.1f}%) "
            f"mem {self.memory_bits:>8d} bits "
            f"{'FITS' if self.fits else 'DOES NOT FIT'}"
        )


# Calibrated constants (see module docstring). The LE coefficient is pinned *exactly* by the paper's
# Table 2 (433,500 ALMs / 25,500 multipliers @5 bits = 17 = 0.68 * 25).
# The constant-specialized path models what the synthesis tool does after
# specialization: surviving "other" constants are CSD-recoded (~b/3 nonzero
# signed digits -> that many adders), and the per-engine accumulation uses
# carry-save compressor trees whose cost per live input bit is far below a
# ripple adder. ALM_PER_ADDER_BIT is fitted to Table 3 (the absolute post-
# fit numbers embed Quartus' multiple-constant-multiplication sharing, which
# a closed-form model can only approximate — deviations are reported, the
# qualitative fit/no-fit claims all reproduce).
ALM_PER_MULT_COEFF = 0.68  # cost(b) = coeff * b^2 ALMs (generic LE mult)
ALM_PER_ADDER_BIT = 0.08  # carry-save compressor tree, per live input bit
ACT_ALM = 24  # tanh LUT actor (b-bit in/out lookup + interp)


def _alm_per_mult(bits: int) -> float:
    return ALM_PER_MULT_COEFF * bits * bits


def _csd_adds(bits: int) -> int:
    """Canonical-signed-digit recoding: expected nonzero digits of a random
    b-bit constant ~ b/3; each nonzero digit costs one adder."""
    return max(1, round(bits / 3))


def estimate_resources(
    graph,
    device: DeviceModel,
    *,
    bits: int,
    strategy: MultiplierStrategy,
    fractions: ParamClassFractions | None = None,
) -> ResourceReport:
    """Resource estimate for a DPN expanded by ``cnn_to_dpn``.

    ``fractions`` (zero/one/pow2/other) is required for LE_CONST — it decides
    how many multipliers survive specialization and how many adder-tree
    inputs disappear (zero weights feed nothing).
    """
    from repro_torch.core.dhm.graph import ActorKind

    n_mult = graph.total_multipliers()
    n_addtree = graph.total_adders()  # adder-tree/neuron-sum actors
    n_act = graph.count(ActorKind.ACTIVATION)
    acc_bits = 2 * bits + 4  # accumulate across K*K*C with headroom

    mem_bits = graph.total_line_buffer_bits()

    if strategy == MultiplierStrategy.DSP:
        logic = int(
            n_addtree * acc_bits * ALM_PER_ADDER_BIT + n_act * ACT_ALM
        )
        return ResourceReport(
            strategy=strategy,
            device=device,
            logic_used=int(logic * device.logic_per_alm),
            dsp_used=n_mult,
            memory_bits=mem_bits,
        )

    if strategy == MultiplierStrategy.LE:
        # The paper's 433,500-ALM point = 17 ALM/mult at 5 bits with the
        # adder tree folded into the per-multiplier constant.
        logic = n_mult * _alm_per_mult(bits)
        logic += n_act * ACT_ALM
        return ResourceReport(
            strategy=strategy,
            device=device,
            logic_used=int(logic * device.logic_per_alm),
            dsp_used=0,
            memory_bits=mem_bits,
        )

    if strategy == MultiplierStrategy.LE_CONST:
        if fractions is None:
            raise ValueError("LE_CONST needs parameter-class fractions")
        # Surviving "other" constants are CSD-recoded into a few adders;
        # zero weights vanish, ones are wires, pow2s are fixed shifts.
        other_mults = fractions.other * n_mult
        logic = other_mults * _csd_adds(bits) * (2 * bits) * ALM_PER_ADDER_BIT
        # Adder trees keep one slot per live (non-zero) product, at product
        # width, compressor-tree packed.
        live_inputs = (1.0 - fractions.zero) * n_mult
        logic += live_inputs * (2 * bits) * ALM_PER_ADDER_BIT
        logic += n_act * ACT_ALM
        return ResourceReport(
            strategy=strategy,
            device=device,
            logic_used=int(logic * device.logic_per_alm),
            dsp_used=0,
            memory_bits=mem_bits,
        )

    raise ValueError(strategy)
