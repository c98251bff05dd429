"""The port's examples run on the CPU at a smoke size, each ending with
``OK``. The CNN examples, ``examples/torch/dhm_cnn.py`` and
``serve_cnn.py`` (the trained LeNet5 cached in the test's temporary
directory): the numbers the deterministic host models print (the DPN,
resources under the three multiplier strategies, DHM throughput, the
stage balance and the pipelined stages' geometry and cost) are the
reference functions' values for the same topology and, for the
resources, the same trained parameters. The LM examples,
``quickstart.py``, ``serve.py`` and ``train_lm.py``: the parameter
count, the token stream's loss floor and the pow2-packed stack's bytes
are the reference's; the loss falls; a run with an injected failure
restarts from its checkpoint and ends where the clean run ends.
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
from repro.configs import get_arch  # noqa: E402
from repro.configs.base import ArchConfig  # noqa: E402
from repro.core.dhm.resources import ParamClassFractions  # noqa: E402
from repro.data import TokenStreamConfig  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.models.accounting import param_count  # noqa: E402
from repro.models.layers import pack_params_pow2  # noqa: E402
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


# ---------------------------------------------------------------------------
# The LM examples


def _stack_mb(tree) -> float:
    return sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(tree)) / 1e6


def test_quickstart_trains_and_serves(tmp_path):
    lines = _run("quickstart.py", results_dir=tmp_path)
    assert f"token stream loss floor: {TokenStreamConfig(512, 64, 16).loss_floor:.3f} nats" in lines
    losses = [float(ln.split()[-1]) for ln in lines if ln.startswith("step ")]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert any(ln.startswith("greedy continuation: [") for ln in lines)


@pytest.mark.parametrize("pow2", [False, True])
def test_serve_prefills_and_decodes(tmp_path, pow2):
    lines = _run("serve.py", *(["--pow2", "--temperature", "0.8"] if pow2 else []),
                 results_dir=tmp_path)
    text = "\n".join(lines)
    assert "prefill: batch=4 len=32" in text and "decode: 16 tokens x 4 seqs" in text
    if pow2:
        cfg = get_arch("qwen2.5-3b").scaled_down(n_layers=4, d_model=128, vocab_size=1024)
        stack = jax.eval_shape(lambda k: jT.init_params(k, cfg)["stack"], jax.random.PRNGKey(0))
        packed = jax.eval_shape(pack_params_pow2, stack)
        before, after = _stack_mb(stack), _stack_mb(packed)
        assert (f"pow2-packed stack: {before:.1f} MB -> {after:.1f} MB "
                f"({before / after:.2f}x)") in lines


def _ref_train_cfg(preset):
    """``examples/train_lm.py``'s config for ``preset`` (its PRESETS row)."""
    layers, d, h, kv, ff, v = {"smoke": (2, 128, 4, 2, 256, 512)}[preset]
    return ArchConfig(name=f"lm-{preset}", family="dense", n_layers=layers, d_model=d,
                      n_heads=h, n_kv_heads=kv, d_ff=ff, vocab_size=v, dtype="float32",
                      remat="none")


def test_train_lm_restarts_from_its_checkpoint(tmp_path):
    args = ("--steps", "12", "--ckpt-every", "5")
    clean = _run("train_lm.py", *args, "--ckpt-dir", str(tmp_path / "clean"),
                 results_dir=tmp_path)
    faulted = _run("train_lm.py", *args, "--ckpt-dir", str(tmp_path / "faulted"),
                   "--inject-failure-at", "7", results_dir=tmp_path)
    cfg = _ref_train_cfg("smoke")
    assert f"model: 2L d=128 -> {param_count(cfg) / 1e6:.1f}M params on cpu" in clean
    assert f"stream loss floor: {TokenStreamConfig(512, 64, 8).loss_floor:.3f} nats" in clean
    done = [ln for ln in clean if ln.startswith("done:")][0]
    done_f = [ln for ln in faulted if ln.startswith("done:")][0]
    assert "restarts=0" in done and "restarts=1" in done_f
    # Bitwise replay from the step-4 checkpoint: the same final loss.
    assert done.split("final loss ")[1].split()[0] == done_f.split("final loss ")[1].split()[0]
    assert sorted(os.listdir(tmp_path / "faulted")) == ["step_11", "step_9"]

