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
