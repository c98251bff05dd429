"""The port's AST lint, held against the reference's
(``tests/test_analysis.py::TestLintRules``).

- the registry: the port's rule IDs and names are the reference's;
- the reference's sixteen seeded fixtures, restated in PyTorch source:
  each hazard fires its rule at its ``file:line``, each fix and each
  source outside a rule's path scope stays clean;
- the paths a rule skips (the kernels' plain versions for DHM005) and
  the port's own sources, which lint clean (``run_lint() == []``);
- the sites the restated rules first found in the port, before and
  after their repair.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro.analysis import ast_lint as jlint  # noqa: E402
from repro_torch.analysis import RULES, lint_source  # noqa: E402
from repro_torch.analysis.cli import run_lint  # noqa: E402
from repro_torch.analysis.findings import has_errors  # noqa: E402

_ENGINE_PATH = "src/repro_torch/core/dhm/engine.py"
_PIPELINE_PATH = "src/repro_torch/core/dhm/pipeline.py"
_BENCH_PATH = "benchmarks/torch/my_bench.py"


def _ids(findings):
    return sorted({f.rule for f in findings})


def test_rule_ids_and_names_are_the_references():
    assert {r.id: r.name for r in RULES.values()} == {
        r.id: r.name for r in jlint.RULES.values()}
    for r in RULES.values():
        assert r.doc.strip(), f"{r.id} has no doc"


class TestLintRules:
    def test_eager_concat_is_DHM001(self):
        src = (
            "import torch\n"
            "def flush(frames):\n"
            "    return torch.cat(frames, dim=0)\n"
        )
        assert _ids(lint_source(src, _ENGINE_PATH)) == ["DHM001"]

    def test_numpy_pack_is_clean(self):
        src = (
            "import numpy as np\n"
            "def flush(frames):\n"
            "    return np.concatenate(frames, axis=0)\n"
        )
        assert lint_source(src, _ENGINE_PATH) == []

    def test_stack_inside_jit_is_DHM002(self):
        src = (
            "import torch\n"
            "@torch.compile\n"
            "def fwd(leaves, x):\n"
            "    w = torch.stack(leaves, dim=0)\n"
            "    return x @ w\n"
        )
        assert _ids(lint_source(src, _ENGINE_PATH)) == ["DHM002"]

    def test_jax_jit_by_reference_is_DHM002(self):
        """A body passed by name to a capture (``torch.jit.script`` here),
        and one captured into a CUDA graph."""
        src = (
            "import torch\n"
            "def fwd(leaves, x):\n"
            "    return x @ torch.stack(leaves)\n"
            "fwd_s = torch.jit.script(fwd)\n"
        )
        assert _ids(lint_source(src, _PIPELINE_PATH)) == ["DHM002"]
        src = (
            "import torch\n"
            "def capture(g, leaves, x):\n"
            "    with torch.cuda.graph(g):\n"
            "        y = x @ torch.cat(leaves)\n"
            "    return y\n"
        )
        assert _ids(lint_source(src, _PIPELINE_PATH)) == ["DHM002"]

    def test_eager_stack_outside_jit_in_pipeline_is_clean(self):
        src = (
            "import torch\n"
            "def box(params):\n"
            "    return torch.stack(params, dim=0)\n"
        )
        assert lint_source(src, _PIPELINE_PATH) == []

    def test_timing_without_block_is_DHM003(self):
        src = (
            "import time\n"
            "import torch\n"
            "def bench(a, b):\n"
            "    t0 = time.perf_counter()\n"
            "    y = torch.matmul(a, b)\n"
            "    return time.perf_counter() - t0, y\n"
        )
        assert _ids(lint_source(src, _BENCH_PATH)) == ["DHM003"]

    def test_timing_with_block_is_clean(self):
        for sync in ("torch.cuda.synchronize()", "y.cpu()", "float(y.sum().item())"):
            src = (
                "import time\n"
                "import torch\n"
                "def bench(a, b):\n"
                "    t0 = time.perf_counter()\n"
                "    y = torch.matmul(a, b)\n"
                f"    {sync}\n"
                "    return time.perf_counter() - t0, y\n"
            )
            assert lint_source(src, _BENCH_PATH) == [], sync
        # a sync after the window closes does not time the work
        src = (
            "import time\n"
            "import torch\n"
            "def bench(a, b):\n"
            "    t0 = time.perf_counter()\n"
            "    y = torch.matmul(a, b)\n"
            "    dt = time.perf_counter() - t0\n"
            "    torch.cuda.synchronize()\n"
            "    return dt, y\n"
        )
        assert _ids(lint_source(src, _BENCH_PATH)) == ["DHM003"]
        # events time the card, not the host
        src = (
            "import torch\n"
            "def bench(a, b):\n"
            "    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)\n"
            "    t0.record()\n"
            "    y = torch.matmul(a, b)\n"
            "    t1.record()\n"
            "    t1.synchronize()\n"
            "    return t0.elapsed_time(t1), y\n"
        )
        assert lint_source(src, _BENCH_PATH) == []

    def test_bare_except_is_DHM004(self):
        src = (
            "def drain(q):\n"
            "    try:\n"
            "        q.get()\n"
            "    except:\n"
            "        pass\n"
        )
        assert _ids(lint_source(src, _ENGINE_PATH)) == ["DHM004"]

    def test_swallowed_request_error_is_DHM004(self):
        src = (
            "from repro_torch.core.dhm.engine import DeadlineExceeded\n"
            "def flush(req):\n"
            "    try:\n"
            "        req.complete()\n"
            "    except DeadlineExceeded:\n"
            "        pass\n"
        )
        assert _ids(lint_source(src, _ENGINE_PATH)) == ["DHM004"]

    def test_handled_request_error_is_clean(self):
        src = (
            "from repro_torch.core.dhm.engine import DeadlineExceeded\n"
            "def flush(req):\n"
            "    try:\n"
            "        req.complete()\n"
            "    except DeadlineExceeded as e:\n"
            "        req.fail(e)\n"
        )
        assert lint_source(src, _ENGINE_PATH) == []

    def test_float64_cast_is_DHM005(self):
        src = (
            "import torch\n"
            "def widen(x):\n"
            "    return x.double() + torch.zeros((), dtype=torch.float64)\n"
            "def widen2(x):\n"
            "    return x.to(torch.double) + torch.zeros((), dtype='float64')\n"
        )
        findings = lint_source(src, "src/repro_torch/core/dhm/anything.py")
        assert _ids(findings) == ["DHM005"]
        assert len(findings) == 4  # the .double(), the two torch dtypes and the string
        # host-side numpy float64 is not the device path
        src = "import numpy as np\ndef acc(x):\n    return np.asarray(x, np.float64)\n"
        assert lint_source(src, "src/repro_torch/core/dhm/anything.py") == []

    def test_unbounded_background_thread_is_DHM006(self):
        src = (
            "import threading\n"
            "def start(loop):\n"
            "    t = threading.Thread(target=loop, daemon=True)\n"
            "    t.start()\n"
            "    return t\n"
        )
        assert _ids(lint_source(src, _ENGINE_PATH)) == ["DHM006"]
        assert _ids(lint_source(src, "src/repro_torch/core/dhm/multitenant.py")) == ["DHM006"]

    def test_bounded_join_is_clean_DHM006(self):
        src = (
            "import threading\n"
            "def start(loop):\n"
            "    t = threading.Thread(target=loop, daemon=True)\n"
            "    t.start()\n"
            "    return t\n"
            "def stop(t):\n"
            "    t.join(timeout=30.0)\n"
            "    if t.is_alive():\n"
            "        raise RuntimeError('wedged')\n"
        )
        assert lint_source(src, _ENGINE_PATH) == []

    def test_str_join_does_not_satisfy_DHM006(self):
        src = (
            "import threading\n"
            "def start(loop, msgs):\n"
            "    t = threading.Thread(target=loop)\n"
            "    t.start()\n"
            "    return '; '.join(msgs)\n"
        )
        assert _ids(lint_source(src, _ENGINE_PATH)) == ["DHM006"]

    def test_rules_are_scoped_by_path(self):
        src = (
            "import torch\n"
            "def kernel(taps):\n"
            "    return torch.stack(taps, dim=2)\n"
        )
        assert lint_source(src, "src/repro_torch/kernels/stream_conv/conv.py") == []
        src = (
            "import threading\n"
            "def watch(fn):\n"
            "    threading.Thread(target=fn, daemon=True).start()\n"
        )
        assert lint_source(src, _PIPELINE_PATH) == []
        # the kernels' plain versions, which only CPU tensors reach, may
        # sum integer codes in float64; the same line elsewhere fires
        src = "import torch\ndef acc(q, w):\n    return torch.matmul(q.to(torch.float64), w)\n"
        for ref in ("src/repro_torch/kernels/stream_conv/ref.py",
                    "src/repro_torch/kernels/pow2_matmul/ref.py"):
            assert lint_source(src, ref) == []
        assert _ids(lint_source(src, "src/repro_torch/kernels/stream_conv/ops.py")) == ["DHM005"]

    def test_findings_carry_file_and_line(self):
        src = (
            "import torch\n"
            "def flush(frames):\n"
            "    return torch.stack(frames)\n"
        )
        (f,) = lint_source(src, _ENGINE_PATH)
        assert f.where == f"{_ENGINE_PATH}:3"
        assert has_errors([f])


def test_the_port_lints_clean():
    assert run_lint() == []


def test_the_engines_old_logit_concat_was_a_DHM001_finding():
    """The engine packed its micro-batches' logits with ``torch.cat`` until
    the restated DHM001 found it; it packs them with numpy now, as the
    reference does."""
    old = (
        "import torch\n"
        "class Engine:\n"
        "    def _flush(self, outs, n):\n"
        "        return torch.cat(outs, dim=0)[:n]\n"
    )
    (f,) = lint_source(old, _ENGINE_PATH)
    assert f.rule == "DHM001" and f.where == f"{_ENGINE_PATH}:4"


def test_numpy_packing_gives_the_concat_bit_for_bit():
    from repro_torch.core.dhm.engine import _pack_logits

    outs = [torch.randn((4, 10), generator=torch.Generator().manual_seed(i)) for i in range(3)]
    assert torch.equal(_pack_logits(outs, 10), torch.cat(outs)[:10])
    assert torch.equal(_pack_logits(outs[:1], 3), outs[0][:3])
