"""The port's FPGA resource model (paper Tables 2-3) and bit-width search
(paper Fig. 3), held for equality with the reference's.

- ``estimate_resources`` equals the reference's for every strategy, bit
  width, device and topology of ``tests/test_dhm.py``'s resource tests
  (LeNet5 at 5 bits on the Cyclone V; LeNet5 at 3, Cifar10 and SVHN at 6
  on both devices), and over a wider grid; ``PAPER_TABLE1`` and the device
  models are the reference's. Every number is the paper's FPGA's.
- ``search_bitwidth`` on the same evaluation gives the same curve and
  width; ``search_plan_bitwidths`` on lenet5, with a seeded evaluation
  (agreement of each plan's argmax with the fp32 plan's on seeded
  frames), selects the same width and curve as the reference, in fake
  quant and on the int8 path, and its final plan carries the selected
  width per layer.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402
import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm import graph as jgraph  # noqa: E402
from repro.core.dhm import resources as jres  # noqa: E402
from repro.core.quant import bitwidth_search as jbw  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compile_dhm  # noqa: E402
from repro_torch.core.dhm import graph as tgraph  # noqa: E402
from repro_torch.core.dhm import resources as tres  # noqa: E402
from repro_torch.core.quant import bitwidth_search as tbw  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES  # noqa: E402

STRATEGIES = ("DSP", "LE", "LE_CONST")
DEVICES = ("CYCLONE_V_5CGXFC9E7", "KINTEX7_XC7Z045")
# (topology, bits, Table-1 fractions) of tests/test_dhm.py's resource tests.
CASES = (("lenet5", 5, "lenet5"), ("lenet5", 3, "lenet5"), ("cifar10", 6, "cifar10"),
         ("cifar10", 6, "svhn"))


def _report(mod, graph_mod, topos, name, bits, strategy, device, fractions):
    g = graph_mod.cnn_to_dpn(topos[name], bits=bits)
    return mod.estimate_resources(
        g, getattr(mod, device), bits=bits, strategy=mod.MultiplierStrategy[strategy],
        fractions=None if fractions is None else mod.PAPER_TABLE1[fractions],
    )


def _fields(rep):
    return (rep.strategy.value, dataclasses.asdict(rep.device), rep.logic_used, rep.dsp_used,
            rep.memory_bits, rep.logic_utilization, rep.dsp_utilization, rep.fits, rep.summary())


def test_paper_table1_and_devices_are_the_references():
    assert {k: dataclasses.asdict(v) for k, v in tres.PAPER_TABLE1.items()} == \
        {k: dataclasses.asdict(v) for k, v in jres.PAPER_TABLE1.items()}
    for dev in DEVICES:
        assert dataclasses.asdict(getattr(tres, dev)) == dataclasses.asdict(getattr(jres, dev))
    assert [s.value for s in tres.MultiplierStrategy] == [s.value for s in jres.MultiplierStrategy]
    assert (tres.ALM_PER_MULT_COEFF, tres.ALM_PER_ADDER_BIT, tres.ACT_ALM) == \
        (jres.ALM_PER_MULT_COEFF, jres.ALM_PER_ADDER_BIT, jres.ACT_ALM)
    with pytest.raises(ValueError, match="sum to 1"):
        tres.ParamClassFractions(zero=0.5, one=0.5, pow2=0.5, other=0.0)


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_estimate_resources_equals_the_references(case, strategy):
    name, bits, frac = CASES[case]
    for dev in DEVICES:
        fr = frac if strategy == "LE_CONST" else None
        got = _report(tres, tgraph, ALL_TOPOLOGIES, name, bits, strategy, dev, fr)
        want = _report(jres, jgraph, JAX_TOPOLOGIES, name, bits, strategy, dev, fr)
        assert _fields(got) == _fields(want)


@pytest.mark.parametrize("name", sorted(JAX_TOPOLOGIES))
def test_estimate_resources_over_every_width_and_topology(name):
    for bits in range(2, 9):
        for strategy in STRATEGIES:
            for frac in (("lenet5", "cifar10", "svhn") if strategy == "LE_CONST" else (None,)):
                got = _report(tres, tgraph, ALL_TOPOLOGIES, name, bits, strategy, DEVICES[0], frac)
                want = _report(jres, jgraph, JAX_TOPOLOGIES, name, bits, strategy, DEVICES[0], frac)
                assert _fields(got) == _fields(want)
    g = tgraph.cnn_to_dpn(ALL_TOPOLOGIES[name], bits=6)
    with pytest.raises(ValueError, match="fractions"):
        tres.estimate_resources(g, tres.CYCLONE_V_5CGXFC9E7, bits=6,
                                strategy=tres.MultiplierStrategy.LE_CONST)


def test_the_papers_table2_and_table3_claims_hold():
    """The reference test's claims on the port's model: DSP LeNet5
    overflows ~72x, LE needs ~433,500 ALMs, constant-specialized fits at
    <= 8.6x less logic, all three CNNs fit both devices with zero DSPs."""
    lenet = ALL_TOPOLOGIES["lenet5"]
    g = tgraph.cnn_to_dpn(lenet, bits=5)
    dsp = tres.estimate_resources(g, tres.CYCLONE_V_5CGXFC9E7, bits=5,
                                  strategy=tres.MultiplierStrategy.DSP)
    le = tres.estimate_resources(g, tres.CYCLONE_V_5CGXFC9E7, bits=5,
                                 strategy=tres.MultiplierStrategy.LE)
    const = tres.estimate_resources(g, tres.CYCLONE_V_5CGXFC9E7, bits=5,
                                    strategy=tres.MultiplierStrategy.LE_CONST,
                                    fractions=tres.PAPER_TABLE1["lenet5"])
    assert not dsp.fits and 60 < dsp.dsp_utilization < 80
    assert not le.fits and le.logic_used == pytest.approx(433_500, rel=0.02)
    assert const.fits and le.logic_used / const.logic_used >= 8.6
    for name, bits, frac in (("lenet5", 3, "lenet5"), ("cifar10", 6, "cifar10"),
                             ("cifar10", 6, "svhn")):
        g = tgraph.cnn_to_dpn(ALL_TOPOLOGIES[name], bits=bits)
        for dev in (tres.CYCLONE_V_5CGXFC9E7, tres.KINTEX7_XC7Z045):
            rep = tres.estimate_resources(g, dev, bits=bits,
                                          strategy=tres.MultiplierStrategy.LE_CONST,
                                          fractions=tres.PAPER_TABLE1[frac])
            assert rep.fits and rep.dsp_used == 0 and rep.memory_bits < 0.02 * dev.bram_bits


# ---------------------------------------------------------------------------
# bit-width search


def test_search_bitwidth_equals_the_references():
    curve = {2: 0.31, 3: 0.72, 4: 0.88, 5: 0.93, 6: 0.955, 7: 0.97, 8: 0.975}
    for float_acc in (0.98, 0.90):
        for max_drop in (0.0, 0.01, 0.04, 0.5):
            for rng in ((2, 3, 4, 5, 6, 7, 8), (8, 4, 6), (3,)):
                got = tbw.search_bitwidth(lambda b: curve[b], float_accuracy=float_acc,
                                          bit_range=rng, max_drop=max_drop)
                want = jbw.search_bitwidth(lambda b: curve[b], float_accuracy=float_acc,
                                           bit_range=rng, max_drop=max_drop)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.curve() == want.curve()


N_EVAL = 32


@functools.lru_cache(maxsize=None)
def _lenet_setup():
    topo = JAX_TOPOLOGIES["lenet5"]
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), topo))
    x = np.random.default_rng(11).normal(size=(N_EVAL, 28, 28, 1)).astype(np.float32)
    return params, x


def _searches(int8_compute):
    """(reference result, port result, port final plan) of the lenet5
    sweep, each package's evaluation its plans' argmax agreement with its
    own fp32 plan's on the same seeded frames."""
    params, x = _lenet_setup()
    jfp32 = jcompiler.compile_dhm(JAX_TOPOLOGIES["lenet5"], params, backend="ref")
    jlabels = np.asarray(jfp32(jnp.asarray(x))).argmax(-1)
    tparams = params_from_numpy(params, "cpu")
    tfp32 = compile_dhm(ALL_TOPOLOGIES["lenet5"], tparams, device="cpu")
    with torch.no_grad():
        tlabels = tfp32(x).numpy().argmax(-1)
    assert (jlabels == tlabels).all()

    def jeval(plan):
        return float((np.asarray(plan(jnp.asarray(x))).argmax(-1) == jlabels).mean())

    def teval(plan):
        with torch.no_grad():
            return float((plan(x).numpy().argmax(-1) == tlabels).mean())

    kw = dict(float_accuracy=1.0, bit_range=(2, 3, 4, 5, 6, 7, 8), max_drop=0.1,
              int8_compute=int8_compute)
    jres_, _ = jbw.search_plan_bitwidths(JAX_TOPOLOGIES["lenet5"], params, jeval,
                                         backend="ref", **kw)
    tres_, tplan = tbw.search_plan_bitwidths(ALL_TOPOLOGIES["lenet5"], tparams, teval,
                                             device="cpu", **kw)
    return jres_, tres_, tplan


@pytest.mark.parametrize("int8_compute", [False, True])
def test_search_plan_bitwidths_selects_the_references_width_and_curve(int8_compute):
    jres_, tres_, tplan = _searches(int8_compute)
    assert tres_.selected_bits == jres_.selected_bits
    assert tres_.curve() == jres_.curve()
    assert dataclasses.asdict(tres_) == dataclasses.asdict(jres_)
    b = tres_.selected_bits
    assert tplan.quant.per_layer_bits == (b,) * len(ALL_TOPOLOGIES["lenet5"].conv_layers)
    assert tplan.quant.int8_compute == int8_compute
    assert tplan.device == torch.device("cpu")


def test_search_plan_bitwidths_int8_needs_widths_up_to_8():
    params, _ = _lenet_setup()
    with pytest.raises(ValueError, match="widths <= 8"):
        tbw.search_plan_bitwidths(ALL_TOPOLOGIES["lenet5"], params_from_numpy(params, "cpu"),
                                  lambda p: 1.0, float_accuracy=1.0, bit_range=(9, 10),
                                  int8_compute=True, device="cpu")
