"""The port as a package: it imports neither JAX nor the reference, and
its device policy — the card unless the caller asks for the CPU, never a
quiet fallback."""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import ast  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import Engine, compile_dhm  # noqa: E402
from repro_torch.kernels.backends import resolve_device  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import ops as kops  # noqa: E402
from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry  # noqa: E402
from repro_torch.models.cnn import LENET5, ConvLayerSpec, init_cnn  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _top(name: str) -> str:
    return name.split(".")[0]


def test_importing_every_port_module_loads_no_jax_and_no_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(mods), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split(maxsplit=1)
    assert int(out[0]) >= 20  # every module of the slice was imported
    assert out[1].strip() == "[]"


def test_no_port_source_imports_jax_or_the_reference():
    files = sorted((SRC / "repro_torch").rglob("*.py"))
    assert files
    files += [SRC.parent / "chip_smoke.py", SRC.parent / "chip_phases.py"]
    examples = sorted((SRC.parent / "examples" / "torch").glob("*.py"))
    assert [p.name for p in examples] == ["dhm_cnn.py", "quickstart.py", "serve.py",
                                          "serve_cnn.py", "train_lm.py"]
    files += examples
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                assert _top(name) not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def _lenet_tree():
    rng = np.random.default_rng(0)
    params = init_cnn(torch.Generator().manual_seed(0), LENET5, device="cpu")
    return {g: [{k: rng.normal(size=tuple(t.shape)).astype(np.float32) for k, t in p.items()}
                for p in layers] for g, layers in params.items()}


def test_entry_points_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = _lenet_tree()
    cpu_params = params_from_numpy(tree, "cpu")
    for call in (
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: params_from_numpy(tree),
        lambda: init_cnn(torch.Generator().manual_seed(0), LENET5),
        lambda: compile_dhm(LENET5, cpu_params),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ValueError, match="unknown device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    plan = compile_dhm(LENET5, cpu_params, device="cpu")
    assert plan.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for p in plan.conv_params for t in p.values())
    eng = Engine(plan, microbatch=2)
    x = np.random.default_rng(1).normal(size=(3, 28, 28, 1)).astype(np.float32)
    out = eng.infer(x)
    assert out.device.type == "cpu" and out.shape == (3, 10)


def test_kernel_wrappers_follow_the_tensor_and_never_fall_back():
    """A CPU tensor takes the plain version and launches nothing; the
    kernels' own wrappers refuse anything but CUDA tensors; a tensor on
    any other device is refused by the dispatch."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1, 12, 12, 3)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(3, 3, 3, 4)).astype(np.float32))
    w2 = torch.from_numpy(rng.normal(size=(3, 3, 4, 4)).astype(np.float32))
    b = torch.zeros(4)
    before = dict(kconv.LAUNCHES)
    kops.stream_conv_block(x, w, b, padding="SAME", act="relu", pool=2)
    spec = ConvLayerSpec(n_out=4, kernel=3, padding="SAME")
    kops.stream_conv_pyramid(x, [w, w2], [b, b], layers=[spec, spec])
    assert kconv.LAUNCHES == before
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kconv.stream_conv_fused_cuda(x, w, b)
    geom = group_geometry(12, 12, 3, as_pyramid_layers([spec]), (3,), (4,))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kconv.stream_conv_pyramid_cuda(x, [w], [b], geom=geom, act_bits=(None,))
    with pytest.raises(ValueError, match="unsupported device"):
        kops.stream_conv_block(x.to("meta"), w.to("meta"), b.to("meta"), padding="SAME")
    assert kconv.LAUNCHES == before


@pytest.mark.parametrize("sub", ["optim", "data", "checkpoint", "runtime", "paper"])
def test_the_training_subpackages_are_walked_and_import_no_jax(sub):
    """The training slice's subpackages sit at the reference's paths with
    its public names; the package walk above imports them and the source
    scan reads them."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"import repro_torch.{sub} as pkg\n"
        f"mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'repro_torch.{sub}.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len(mods), bad, sorted(getattr(pkg, '__all__', [])))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout
    n, rest = out.split(maxsplit=1)
    assert int(n) >= 1 and rest.startswith("[] ")
    ref = SRC / "repro" / sub / "__init__.py"
    names = [n.value for node in ast.walk(ast.parse(ref.read_text())) if isinstance(node, ast.Assign)
             and any(getattr(t, "id", "") == "__all__" for t in node.targets) for n in node.value.elts]
    assert all(f"'{name}'" in rest for name in names), (sub, names, rest)
    assert (SRC / "repro_torch" / sub).is_dir() and sorted(
        p.name for p in (SRC / "repro" / sub).glob("*.py")) == sorted(
        p.name for p in (SRC / "repro_torch" / sub).glob("*.py"))


def test_the_launch_subpackage_is_walked_and_imports_no_jax():
    """``launch/``: every module of the reference's but its XLA dry-run
    tools, imported with no JAX and no reference module loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch.launch as pkg\n"
        "mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, 'repro_torch.launch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(sorted(mods), bad)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout
    dry_run = {"dryrun.py", "hlo_analysis.py", "optflags.py", "reanalyze.py"}
    want = sorted(p.name for p in (SRC / "repro" / "launch").glob("*.py"))
    got = sorted(p.name for p in (SRC / "repro_torch" / "launch").glob("*.py"))
    assert got == [n for n in want if n not in dry_run]
    assert out.strip() == str(sorted(f"repro_torch.launch.{n[:-3]}" for n in got
                                     if n != "__init__.py")) + " []"
