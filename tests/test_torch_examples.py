"""The port's CNN examples, ``examples/torch/dhm_cnn.py`` and
``examples/torch/serve_cnn.py``, run on the CPU at a smoke size (the
trained LeNet5 cached in the test's temporary directory): each ends with
``OK``, and the numbers the deterministic host models print (the DPN,
resources under the three multiplier strategies, DHM throughput, the
stage balance and the pipelined stages' geometry and cost) are the
reference functions' values for the same topology and, for the
resources, the same trained parameters.
"""
import pytest

torch = pytest.importorskip("torch")

import os  # noqa: E402
import pickle  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.dhm import (  # noqa: E402
    CYCLONE_V_5CGXFC9E7,
    MultiplierStrategy,
    QuantSpec,
    balance_report,
    cnn_to_dpn,
    compile_dhm,
    dhm_throughput_gops,
    estimate_resources,
)
from repro.core.dhm.resources import ParamClassFractions  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES, LENET5, init_cnn  # noqa: E402
from repro.paper.analysis import classify_model  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(example: str, *args, results_dir) -> list:
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "examples", "torch", example), "--device", "cpu",
         *args],
        capture_output=True, text=True, timeout=240, cwd=REPO,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src"),
             "REPRO_RESULTS_DIR": str(results_dir), "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert lines[-1] == "OK", proc.stdout[-2000:]
    return lines


def test_dhm_cnn_runs_and_prints_the_references_numbers(tmp_path):
    lines = _run("dhm_cnn.py", "--steps", "10", results_dir=tmp_path)
    assert os.path.exists(tmp_path / "cnn" / "lenet5.torch.pkl")  # the cache, not the repo
    with open(tmp_path / "cnn" / "lenet5.torch.pkl", "rb") as f:
        params = jax.tree_util.tree_map(jnp.asarray, pickle.load(f)["params"])
    bits = 3
    stats = classify_model(params, bits)
    assert (f"param classes @ {bits}b: zero={100*stats.zero:.1f}% "
            f"one={100*stats.one:.1f}% pow2={100*stats.pow2:.1f}% "
            f"other={100*stats.other:.1f}% -> "
            f"{100*stats.multiplierless:.1f}% multiplierless") in lines
    g = cnn_to_dpn(LENET5, bits=bits)
    assert (f"DPN: {len(g.actors)} actors, {g.total_multipliers()} multipliers,"
            f" {g.total_line_buffer_bits()} line-buffer bits") in lines
    fr = ParamClassFractions(stats.zero, stats.one, stats.pow2, stats.other)
    for strat in MultiplierStrategy:
        rep = estimate_resources(g, CYCLONE_V_5CGXFC9E7, bits=bits, strategy=strat,
                                 fractions=fr)
        assert "  " + rep.summary() in lines
    assert "  " + dhm_throughput_gops(LENET5, 65.71).summary() in lines
    plan = compile_dhm(LENET5, params, quant=QuantSpec(weight_bits=bits, act_bits=bits),
                       n_stages=2, backend="ref")
    br = balance_report([s.cost_flops for s in plan.stages], plan.n_stages, n_microbatches=8)
    assert (f"  {plan.n_stages} stages over {len(plan.conv_params)} conv "
            f"layers: boundaries {plan.assignment.boundaries}, bottleneck "
            f"{plan.assignment.bottleneck/1e3:.0f}k flops, pipeline "
            f"efficiency {br.pipeline_efficiency:.2f}") in lines
    for st in plan.stages:
        assert f"  stage {st.index}: {st.io.in_shape} -> {st.io.out_shape}" in lines
    text = "\n".join(lines)
    assert "matches fake-quant reference=True" in text
    assert "quantized plan matches reference=True" in text
    assert "matches single-device plan=True" in text
    assert "served 5 requests" in text


def test_serve_cnn_runs_every_section(tmp_path):
    lines = _run("serve_cnn.py", "--requests", "8", results_dir=tmp_path)
    text = "\n".join(lines)
    for want in ("requests met their SLO", "injected failures by retry",
                 "now serving on rung 'per_layer'", "breaker 'open'", "the bulkhead held",
                 "swap to incompatible plan refused: SwapRejected",
                 "rollback 'cifar': v1 weights answering again", "(rung: mesh)"):
        assert want in text, want
    topo = ALL_TOPOLOGIES["cifar10"]
    plan = compile_dhm(topo, init_cnn(jax.random.PRNGKey(0), topo), n_stages=3,
                       backend="ref")
    for st in plan.stages:
        assert (f"  stage {st.index}: {st.io.in_shape} -> {st.io.out_shape} "
                f"({st.cost_flops / 1e6:.2f} Mflop)") in lines
