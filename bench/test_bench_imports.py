"""Nothing the harness runs loads JAX or the JAX package, the reference
loads nothing of the port, and a run with no card fails without a result."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

LOADED = """
import json, sys, time
sys.path[:0] = [{src!r}, {root!r}]
{body}
print(json.dumps(sorted(sys.modules)))
"""


def _modules(body: str) -> set:
    code = LOADED.format(src=str(ROOT / "src"), root=str(ROOT), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _top(names: set) -> set:
    """Top-level names, compared whole: ``repro_torch`` is not ``repro``."""
    return {n.split(".")[0] for n in names}


def test_harness_and_a_run_load_no_jax():
    body = """
from bench import harness, control
from bench.reference import cnn
spec = harness.load_spec()
for name, sizes in [("cifar10-q6.infer", {"frames_per_request": 4, "pool_batches": 1,
                                          "warmup_seconds": 0.05}),
                    ("lenet5-q3.train", {"batch": 4, "n_train_per_class": 1,
                                         "warmup_seconds": 0.05})]:
    cell = harness.make_cell(spec, name, seed=1, seconds=0.05, trace=False, device="cpu",
                             t_start=time.perf_counter(), sizes=sizes)
    harness.run(spec, cell)
"""
    top = _top(_modules(body))
    assert "repro_torch" in top
    assert not (top & FORBIDDEN), top & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    top = _top(_modules("from bench.reference import cnn"))
    assert not (top & (FORBIDDEN | {"repro_torch"}))


@pytest.mark.parametrize("path", sorted((ROOT / "bench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_plain_modules_only(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    assert names <= {"__future__", "math", "torch"}, names


def test_no_card_fails_without_a_result():
    """On a machine without CUDA the harness exits non-zero and prints no
    result line: it never falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "cifar10-q6.infer", "--seed",
         str(2**31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr
