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
  held in ``test_torch_analysis.py``);
- every reference module has its port, and every public name of it (its
  top-level functions, classes and assignments, the names a package's
  ``__init__`` imports, and each public class's methods, read from the
  source with ``ast``) is an attribute of the port's module or class,
  but for the absences by design in ``BY_DESIGN``.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import ast  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import pathlib  # noqa: E402

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


# ---------------------------------------------------------------------------
# Every public name of the reference, in its port.

REF_ROOT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
# Reference modules with no port: the jaxpr walkers (the port traces no
# jaxpr) and the XLA rendering of the conv (the port's plain versions are
# in ref.py).
ABSENT_MODULES = {"analysis/jaxpr_utils.py", "kernels/stream_conv/xla.py"}
# Names absent by design, per reference module ("*": all of them): the
# Pallas entry points (each kernel's CUDA wrapper takes their place), the
# JAX backend names (the port picks the kernel or its plain version by
# the tensor's device), and the verifier's jaxpr accessors (the port
# runs its probes).
BY_DESIGN = {
    "kernels/backends.py": {"*"},
    "kernels/pow2_matmul/pow2.py": {"pow2_matmul_pallas"},
    "kernels/ssm_scan/scan.py": {"ssm_scan_pallas"},
    "kernels/stream_conv/conv.py": {"stream_conv_fused_pallas", "stream_conv_pyramid_pallas"},
    "kernels/stream_conv/legacy.py": {"stream_conv2d_pallas_seed"},
    "kernels/stream_conv/__init__.py": {"stream_conv2d_pallas_seed"},
    "analysis/verify.py": {"ProbeContext.features_jaxpr", "ProbeContext.forward_jaxpr"},
}
REF_MODULES = sorted(str(p.relative_to(REF_ROOT)) for p in REF_ROOT.rglob("*.py"))


def _public(name: str) -> bool:
    return not name.startswith("_")


def _reference_names(rel: str) -> set:
    tree = ast.parse((REF_ROOT / rel).read_text())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if not _public(node.name):
                continue
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out.update(f"{node.name}.{m.name}" for m in node.body
                           if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                           and _public(m.name))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name) and _public(t.id))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if _public(node.target.id):
                out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and rel.endswith("__init__.py"):
            out.update(a.asname or a.name for a in node.names if _public(a.asname or a.name))
    return out


def _port_has(rel: str, name: str) -> bool:
    parts = pathlib.PurePosixPath(rel).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    if parts[-1:] == ("__main__",):
        # Importing a __main__ runs it: read its source instead.
        src = (REF_ROOT.parent / "repro_torch" / rel).read_text()
        return name in {n.name for n in ast.parse(src).body
                        if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    obj = importlib.import_module(".".join(("repro_torch",) + parts))
    for attr in name.split("."):
        if not hasattr(obj, attr):
            return False
        obj = getattr(obj, attr)
    return True


@pytest.mark.parametrize("rel", REF_MODULES)
def test_every_public_name_of_the_reference_module_is_ported(rel):
    if rel in ABSENT_MODULES:
        assert not (REF_ROOT.parent / "repro_torch" / rel).exists()
        return
    assert (REF_ROOT.parent / "repro_torch" / rel).exists(), f"no port of {rel}"
    skip = BY_DESIGN.get(rel, set())
    if "*" in skip:
        return
    missing = sorted(n for n in _reference_names(rel) - skip if not _port_has(rel, n))
    assert missing == [], f"{rel}: the port lacks {missing}"


def test_the_by_design_absences_are_still_absent_and_named_by_the_reference():
    """The list stays true: each name it excuses is the reference's and
    is missing from the port (a name ported later leaves the list)."""
    for rel, names in BY_DESIGN.items():
        assert rel in REF_MODULES
        for name in names - {"*"}:
            assert name in _reference_names(rel), (rel, name)
            assert not _port_has(rel, name), (rel, name)
