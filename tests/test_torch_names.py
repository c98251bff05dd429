"""Public names of the reference that the port's ported modules had left
out, held against the reference on the CPU:

- ``CNNTopology.n_multipliers`` (the multipliers a full DHM instantiation
  needs): LeNet5's 25,500 (``tests/test_cnn.py``), equal to the compiled
  plan's DPN count, and every topology's equal to the reference's;
- ``export_cnn_specs``: the per-tensor ``FixedPointSpec`` tree of the
  same numpy params, field for field;
- ``repro_torch.core.quant`` exports every name ``repro.core.quant``
  exports;
- ``repro_torch.analysis.invariants.by_scope`` (its IDs per scope are
  held in ``test_torch_analysis.py``).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.quant as jquant  # noqa: E402
import repro_torch.core.quant as tquant  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.analysis import invariants as tinvariants  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compile_dhm  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402


def test_lenet5_needs_25500_multipliers_as_its_plan_counts():
    assert tcnn.LENET5.n_multipliers() == 25500
    params = tcnn.init_cnn(torch.Generator().manual_seed(0), tcnn.LENET5, device="cpu")
    plan = compile_dhm(tcnn.LENET5, params, device="cpu")
    assert plan.graph.total_multipliers() == tcnn.LENET5.n_multipliers()


@pytest.mark.parametrize("name", sorted(jcnn.ALL_TOPOLOGIES))
def test_n_multipliers_is_the_references(name):
    assert tcnn.ALL_TOPOLOGIES[name].n_multipliers() == jcnn.ALL_TOPOLOGIES[name].n_multipliers()


@pytest.mark.parametrize("bits", [3, 6, 8])
@pytest.mark.parametrize("name", ["lenet5", "cifar10"])
def test_export_cnn_specs_is_the_references(name, bits):
    jparams = jcnn.init_cnn(jax.random.PRNGKey(1), jcnn.ALL_TOPOLOGIES[name])
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    # one zero tensor: the all-zero branch of FixedPointSpec.for_tensor
    np_params["conv"][0]["b"] = np.zeros_like(np_params["conv"][0]["b"])
    want = jcnn.export_cnn_specs(jax.tree_util.tree_map(jnp.asarray, np_params), bits)
    got = tcnn.export_cnn_specs(params_from_numpy(np_params, "cpu"), bits)
    assert set(got) == set(want)
    for group in want:
        assert len(got[group]) == len(want[group])
        for g, w in zip(got[group], want[group]):
            assert {k: dataclasses.asdict(v) for k, v in g.items()} == {
                k: dataclasses.asdict(v) for k, v in w.items()}


def test_core_quant_exports_every_reference_name():
    assert set(jquant.__all__) <= set(tquant.__all__)
    for name in jquant.__all__:
        assert getattr(tquant, name) is not None, name
    assert tquant.POW2_ZERO_CODE == jquant.POW2_ZERO_CODE


def test_by_scope_filters_the_registry():
    assert tinvariants.by_scope() == []
    assert {inv.scope for inv in tinvariants.by_scope("resource", "plan")} == {"resource", "plan"}
    assert len(tinvariants.by_scope(*tinvariants.SCOPES)) == len(tinvariants.REGISTRY)
