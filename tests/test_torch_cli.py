"""``python -m repro_torch.analysis``, the port's static gate, on the CPU
(the reference's ``tests/test_analysis.py::TestCLI``).

- ``all --topology lenet5 --device cpu --format json --no-pipeline``
  exits 0 with no error, and ``--out`` holds the report stdout prints;
- the report has the reference CLI's keys, and the full verify matrix
  (five topologies x fp32 / quant / int8, with the pipelined probes) is
  clean on the CPU;
- a defective plan or a seeded lint hazard makes the CLI exit 1;
- the CLI's variants and bit widths are the reference's.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from repro.analysis import cli as jcli  # noqa: E402
from repro_torch.analysis import cli  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cli_clean_run_exits_zero(tmp_path):
    out = tmp_path / "findings.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "all", "--topology", "lenet5",
         "--device", "cpu", "--format", "json", "--out", str(out), "--no-pipeline"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    rep = json.loads(proc.stdout)
    assert set(rep) == {"command", "findings", "errors", "warnings"}
    assert rep["command"] == "all" and rep["errors"] == 0 and rep["findings"] == []
    assert json.loads(out.read_text()) == rep


def test_the_full_verify_matrix_is_clean_on_the_cpu():
    from repro_torch.models.cnn import ALL_TOPOLOGIES

    traces = []
    assert cli.run_verify(ALL_TOPOLOGIES, device="cpu", traces=traces) == []
    assert len(traces) == 3 * len(ALL_TOPOLOGIES)
    assert all(tr.launches == [] for tr in traces)  # the CPU launches nothing


def test_a_defective_plan_makes_the_cli_exit_one(monkeypatch, capsys):
    real = tcompiler.compile_dhm

    def inflated(*args, **kwargs):
        plan = real(*args, **kwargs)
        st = plan.stages[0]
        g = dataclasses.replace(st.groups[0], working_set=10**9)
        return dataclasses.replace(plan, stages=(
            dataclasses.replace(st, groups=(g,) + st.groups[1:]),) + plan.stages[1:])

    monkeypatch.setattr(tcompiler, "compile_dhm", inflated)
    rc = cli.main(["verify", "--topology", "lenet5", "--quant", "fp32", "--device", "cpu",
                   "--format", "json", "--no-pipeline"])
    rep = json.loads(capsys.readouterr().out)
    assert rc == 1 and rep["errors"] == 2
    assert sorted(f["rule"] for f in rep["findings"]) == ["V201", "V202"]


def test_a_seeded_lint_hazard_makes_the_cli_exit_one(tmp_path, capsys):
    bad = tmp_path / "core" / "dhm" / "engine.py"
    bad.parent.mkdir(parents=True)
    bad.write_text("import torch\ndef flush(frames):\n    return torch.cat(frames)\n")
    assert cli.main(["lint", "--paths", str(bad), "--format", "text"]) == 1
    out = capsys.readouterr().out
    assert "[DHM001]" in out and "engine.py:3" in out and "1 error(s)" in out
    assert cli.main(["lint", "--format", "json"]) == 0


def test_variants_and_bit_widths_are_the_references():
    assert cli.PAPER_BITS == jcli.PAPER_BITS
    assert cli._MAX_PIPELINE_STAGES == jcli._MAX_PIPELINE_STAGES
    args = cli._parse_args(["all"])
    assert args.device == "cuda" and args.topology == "all" and args.quant == "all"
    root, roots = cli._repo_paths()
    assert roots[0] == os.path.join(root, "src", "repro_torch")
