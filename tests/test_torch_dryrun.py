"""The port's dry run on the CPU (``repro_torch.launch``: ``dryrun``,
``hlo_analysis``, ``optflags``, ``reanalyze``) held against the
reference's ``repro.launch``.

- FLOP parity (the helpers here; the tests in
  ``test_torch_dryrun_flops_{dense,mixed,moe_ssm}.py``, so that no file's
  XLA compiles take half a minute): each cell's step traced on ``meta`` at
  ``scaled_down()``, B=2, S=64, counted from the op log, against the
  reference's ``analyze_hlo`` of the same step compiled by XLA on one CPU
  device (``tests/test_launch.py``'s way). falcon-mamba's train step is
  off by a stated term (ROADMAP Queue 3): the scan's recomputed
  contraction, and the outer product in that contraction's backward,
  which PyTorch runs as a ``bmm`` of contraction 1 and XLA as a
  broadcast multiply.
- The reference's ``TestHLOAnalysis`` cases restated for an eager log.
- The log: its FLOPs equal ``FlopCounterMode``'s total on every cell; its
  text reads back to the same ops and the same analysis; the same step
  run on CPU tensors gives the same ops, counts and peak as on ``meta``.
- The per-device argument bytes on the 16 x 16 mesh against the
  reference's own ``param_specs``, ``batch_specs`` and ``cache_specs``.
- The CLI and ``reanalyze`` in subprocesses (no JAX, no reference module
  loaded), the recorded errors, ``OptFlags``' names, the scan op.

This file never imports ``repro.launch.dryrun``: it sets ``XLA_FLAGS``
when imported. Tolerances: FLOPs rtol 1e-6 (the counts are integers in
float64); everything else equal.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.launch import optflags as joptflags  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo as j_analyze_hlo  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro.optim import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.configs import get_arch, list_archs  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as kssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch import optflags  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models.accounting import param_count  # noqa: E402
from repro_torch.tree_util import tree_leaves  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
B, S = 2, 64
KINDS = ("prefill", "train", "decode")
MESH = make_production_mesh(device="cpu")  # 16 x 16 slots on the CPU


class FakeMesh:
    """The reference mesh's sizes and axis names: what its rules read."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


def _shape(kind):
    return ShapeConfig("t", S, B, kind)


@functools.lru_cache(maxsize=None)
def port_trace(name, kind):
    """The port's cell traced on ``meta`` (cached: several tests read it)."""
    return D.trace_cell(get_arch(name).scaled_down(), _shape(kind), MESH)


def ref_tree(name, kind):
    """(reference config, {argument name: ShapeDtypeStruct tree}) of a cell."""
    cfg = jconfigs.get_arch(name).scaled_down()
    sds = jax.ShapeDtypeStruct
    params = jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0), cfg))
    dt = jnp.dtype(cfg.dtype)
    out = {"params": params}
    if kind == "decode":
        out["cache"] = jax.eval_shape(lambda: jT.init_stack_cache(cfg, cfg.n_layers, B, S))
        out["token"] = sds((B, 1), jnp.int32)
        return cfg, out
    batch = {"tokens": sds((B, S + 1 if kind == "train" else S), jnp.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = sds((B, cfg.n_prefix_tokens, cfg.d_model), dt)
    if cfg.family == "encdec":
        batch["encoder_frames"] = sds((B, cfg.encoder_seq, cfg.d_model), dt)
    if kind == "train":
        out["opt"] = jax.eval_shape(lambda p: j_adamw_init(p, JAdamWConfig()), params)
    out["batch"] = batch
    return cfg, out


def ref_flops(name, kind) -> float:
    """The reference's ``analyze_hlo`` FLOPs of the cell's compiled step."""
    cfg, t = ref_tree(name, kind)
    if kind == "train":
        lowered = jax.jit(jsteps.make_train_step(cfg, None)).lower(t["params"], t["opt"],
                                                                    t["batch"])
    elif kind == "prefill":
        lowered = jax.jit(jsteps.make_prefill_step(cfg, _shape(kind))).lower(t["params"],
                                                                              t["batch"])
    else:
        lowered = jax.jit(jsteps.make_decode_step(cfg)).lower(
            t["params"], t["cache"], t["token"], jax.ShapeDtypeStruct((), jnp.int32))
    return j_analyze_hlo(lowered.compile().as_text()).flops


def assert_flop_parity(name, kind):
    """The port's op log counts the reference's FLOPs; falcon-mamba's
    exactly (its train step included: the scan and its gradient are one
    op each, charged the contractions XLA's autodiff keeps)."""
    want = ref_flops(name, kind)
    got = H.analyze_hlo(port_trace(name, kind).instrs)
    assert got.flops == pytest.approx(want, rel=1e-6), (name, kind, got.flops, want)
    if name == "falcon-mamba-7b":
        assert got.flops == want, (name, kind, got.flops, want)
    assert (got.collective_bytes, got.collective_counts, got.unknown_trip_whiles) == (0.0, {}, 0)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list_archs())
def test_log_flops_equal_the_flop_counter_and_the_text_round_trips(name, kind):
    """The log's FLOPs are ``FlopCounterMode``'s; its text reads back to
    the same ops and the same analysis."""
    tr = port_trace(name, kind)
    a = H.analyze_hlo(tr.instrs)
    assert a.flops == tr.counter_flops
    text = H.format_log(tr.instrs)
    assert text.count("\n") == len(tr.instrs)
    assert H.parse_computations(text) == tr.instrs
    assert H.analyze_hlo(text) == a


# ---------------------------------------------------------------------------
# the reference's TestHLOAnalysis, restated for an eager log


def _analyze(fn, *args):
    _, rec, counter = H.record(fn, *args, device="meta")
    a = H.analyze_hlo(rec.instrs)
    assert a.flops == counter
    return a


def test_python_loop_flops():
    def f(c):
        for _ in range(7):
            c = torch.tanh(c @ c)
        return c

    assert _analyze(f, torch.empty((128, 128), device="meta")).flops == 7 * 2 * 128 ** 3


def test_nested_loops_multiply():
    def f(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    assert _analyze(f, torch.empty((32, 32), device="meta")).flops == 15 * 2 * 32 ** 3


def test_plain_matmul_flops_and_bytes():
    a = _analyze(lambda x, y: x @ y, torch.empty((64, 64), device="meta"),
                 torch.empty((64, 64), device="meta"))
    assert a.flops == 2 * 64 ** 3
    assert a.hbm_bytes == 3 * 64 * 64 * 4  # 2 reads + 1 write


def test_slice_update_counts_the_update_not_the_base():
    def f(base, upd):
        base[:4] = upd
        return base

    a = _analyze(f, torch.empty((4096, 4096), device="meta"),
                 torch.empty((4, 4096), device="meta"))
    assert a.hbm_bytes < 4096 * 4096 * 4 / 2
    assert a.hbm_bytes == 2 * 4 * 4096 * 4


def test_views_cost_nothing_and_gathers_their_result():
    def f(table, ids):
        v = table.reshape(-1)[:10].unsqueeze(0).expand(3, 10)
        return v, torch.embedding(table, ids)

    ids = torch.empty((5,), dtype=torch.int64, device="meta")
    a = _analyze(f, torch.empty((100, 8), device="meta"), ids)
    assert a.hbm_bytes == 2 * 5 * 8 * 4


def test_peak_live_bytes_counts_what_the_step_creates():
    def f(x):
        a = x + 1  # 4,000 B live
        b = a * 2  # 8,000
        del a  # 4,000
        c = b[:10].unsqueeze(0)  # a view: nothing new
        return torch.cat([b, c[0], b])  # 4,000 + 8,040 = 12,040

    x = torch.empty((1000,), device="meta")  # an argument: never counted
    out, rec, _ = H.record(f, x, device="meta")
    assert rec.peak_live_bytes == 12_040
    assert rec.live_bytes == 8_040  # b freed when f returned
    del out
    assert rec.live_bytes == 0


def test_top_contributors_rank_bytes_by_op_and_site():
    tr = port_trace("qwen2.5-3b", "prefill")
    top = H.top_contributors(tr.instrs, n=5)
    assert len(top) == 5 and [t["bytes"] for t in top] == sorted((t["bytes"] for t in top),
                                                                   reverse=True)
    assert all(t["site"] != "?" and t["op"].startswith("aten.") for t in top)
    assert H.top_contributors(H.format_log(tr.instrs), n=5) == top


# ---------------------------------------------------------------------------
# the same step on CPU tensors: the same log as on meta


@pytest.mark.parametrize("name,kind,remat", [
    ("falcon-mamba-7b", "train", "full"), ("qwen2.5-3b", "prefill", "none"),
    ("llama4-scout-17b-a16e", "train", "dots"), ("whisper-base", "decode", "none"),
])
def test_a_cpu_run_logs_the_meta_runs_ops_counts_and_peak(name, kind, remat):
    """What phase 5k checks on the card, on the CPU: the step run for real
    logs the ops the dry run counted (MoE's one-hot and AdamW's constants
    are written so that every device runs the same ops), the same FLOPs,
    bytes and peak live bytes."""
    cfg = dataclasses.replace(get_arch(name).scaled_down(), remat=remat)
    tr = D.trace_cell(cfg, _shape(kind), MESH)
    step, args, _ = D.cell_step(cfg, _shape(kind), MESH)
    real = D.cell_args(cfg, _shape(kind), torch.Generator().manual_seed(0))
    assert ([(tuple(t.shape), t.dtype) for t in tree_leaves(real) if isinstance(t, torch.Tensor)]
            == [(tuple(t.shape), t.dtype) for t in tree_leaves(args)
                if isinstance(t, torch.Tensor)])
    out, rec, counter = H.record(step, *real, device="cpu")
    assert H.op_counts(rec.instrs) == H.op_counts(tr.instrs)
    assert H.analyze_hlo(rec.instrs) == H.analyze_hlo(tr.instrs)
    assert counter == tr.counter_flops
    assert rec.peak_live_bytes == tr.peak_live_bytes
    assert all(bool(torch.isfinite(t).all()) for t in tree_leaves(out)
               if isinstance(t, torch.Tensor) and t.dtype.is_floating_point)


# ---------------------------------------------------------------------------
# per-device bytes on the 16 x 16 mesh


def _ref_shard_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for leaf, spec in zip(leaves, spec_leaves):
        dims = list(leaf.shape)
        for i, entry in enumerate(spec):
            for ax in (entry if isinstance(entry, tuple) else (entry,)):
                if ax is not None:
                    dims[i] //= mesh.shape[ax]
        total += math.prod(dims) * jnp.dtype(leaf.dtype).itemsize
    return total


def ref_argument_bytes(name, kind) -> int:
    """One device's argument bytes under the reference's own specs (the
    train step's ``OptState`` as ``jit_train_step`` lays it out: the step
    counter replicated, the moments as the parameters)."""
    cfg, t = ref_tree(name, kind)
    mesh = FakeMesh(data=16, model=16)
    total = _ref_shard_bytes(t["params"], jsh.param_specs(t["params"], mesh, fsdp=True), mesh)
    if kind == "decode":
        total += _ref_shard_bytes(t["cache"], jsh.cache_specs(t["cache"], mesh, cfg), mesh)
        return total + _ref_shard_bytes({"token": t["token"]},
                                        jsh.batch_specs({"token": t["token"]}, mesh), mesh)
    if kind == "train":
        opt = t["opt"]
        total += 4 + sum(_ref_shard_bytes(m, jsh.param_specs(m, mesh, fsdp=True), mesh)
                         for m in (opt.m, opt.v))
    return total + _ref_shard_bytes(t["batch"], jsh.batch_specs(t["batch"], mesh), mesh)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ("qwen2.5-3b", "whisper-base", "internvl2-2b",
                                  "recurrentgemma-9b", "llama4-scout-17b-a16e",
                                  "falcon-mamba-7b"))
def test_argument_bytes_per_device_follow_the_references_specs(name, kind):
    tr = port_trace(name, kind)
    assert D.tree_bytes(tr.args, tr.arg_specs, MESH) == ref_argument_bytes(name, kind)
    assert D.tree_bytes(tr.args) > D.tree_bytes(tr.args, tr.arg_specs, MESH)


# ---------------------------------------------------------------------------
# the CLI and reanalyze


REF_KEYS = {"arch", "shape", "mesh", "opt", "status", "n_devices", "lower_s", "compile_s",
            "memory", "cost", "analysis", "collectives", "hlo_bytes", "params",
            "active_params", "model_flops"}
MEM_KEYS = {"generated_code_size_in_bytes", "argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "temp_size_in_bytes"}
ANALYSIS_KEYS = {"flops_per_device", "hbm_bytes_per_device", "collective_bytes_per_device",
                 "collective_counts", "unknown_trip_whiles"}
LOADED = ("import sys\n"
          "print('LOADED', sorted({m.split('.')[0] for m in sys.modules} & "
          "{'jax', 'jaxlib', 'repro', 'zstandard'}))\n")


def _run_module(module, argv, results):
    code = (f"import runpy, sys\nsys.argv = {[module] + argv!r}\n"
            f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n" + LOADED)
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(PYTHONPATH=SRC, REPRO_RESULTS_DIR=str(results))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "LOADED []" in out.stdout
    return out.stdout


def test_cli_writes_the_references_record_and_reanalyze_rederives_it(tmp_path, monkeypatch):
    """A full-size cell on meta (whisper-base, the smallest config): the
    reference's keys (``trace_s`` for ``lower_s``), the per-device fields,
    the log beside the record; a second run skips the cached cell; then
    ``reanalyze`` rewrites a spoiled ``analysis`` from the log alone."""
    argv = ["--arch", "whisper-base", "--shape", "decode_32k"]
    out = _run_module("repro_torch.launch.dryrun", argv, tmp_path)
    assert "-> ok" in out
    path = tmp_path / "dryrun_torch" / "whisper-base__decode_32k__16x16.json"
    rec = json.loads(path.read_text())
    assert set(rec) == (REF_KEYS - {"lower_s"}) | {"trace_s", "step"}
    assert set(rec["memory"]) == MEM_KEYS and set(rec["analysis"]) == ANALYSIS_KEYS | {
        "per_device"}
    assert (rec["status"], rec["n_devices"], rec["compile_s"], rec["collectives"]) == (
        "ok", 256, None, None)
    assert rec["memory"]["alias_size_in_bytes"] == 0 and rec["memory"]["temp_size_in_bytes"] is None
    assert 0 < rec["memory"]["argument_size_in_bytes"] < rec["step"]["argument_bytes"]
    a, step = rec["analysis"], rec["step"]
    assert a["per_device"] == "even_split" and a["collective_bytes_per_device"] is None
    assert a["flops_per_device"] == step["flops"] / 256 == rec["cost"]["flops_per_device"]
    assert a["hbm_bytes_per_device"] == step["hbm_bytes"] / 256
    assert step["flops"] == step["flop_counter_flops"]
    assert rec["params"] == param_count(get_arch("whisper-base"))
    log = path.with_name(path.name.replace(".json", ".ops.xz"))
    assert log.exists() and rec["hlo_bytes"] > log.stat().st_size

    with monkeypatch.context() as m:
        m.setattr(D, "RESULTS_DIR", str(tmp_path))
        m.setattr(D, "run_cell", None)  # a cached cell is not traced again
        D.main(argv)
    assert json.loads(path.read_text()) == rec
    spoiled = dict(rec, analysis={}, step=dict(step, flops=0.0, hbm_bytes=0.0))
    path.write_text(json.dumps(spoiled))
    out = _run_module("repro_torch.launch.reanalyze", [], tmp_path)
    assert "re-analyzed 1 cells" in out
    assert json.loads(path.read_text()) == rec


def test_a_failing_cell_is_recorded_and_the_command_fails(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("boom")

    monkeypatch.setattr(D, "RESULTS_DIR", str(tmp_path))
    monkeypatch.setattr(D, "run_cell", broken)
    with pytest.raises(SystemExit, match="1 cells failed"):
        D.main(["--arch", "qwen2.5-3b", "--shape", "train_4k", "--opt", "mb=4", "ce_remat"])
    rec = json.loads((tmp_path / "dryrun_torch" /
                      "qwen2.5-3b__train_4k__16x16__ceremat+mb4.json").read_text())
    assert rec["status"] == "error" and rec["error"] == "RuntimeError: boom"
    assert "traceback" in rec and rec["opt"] == "ceremat+mb4"


def test_long_context_on_a_full_attention_arch_is_skipped_as_the_reference_skips_it():
    rec = D.run_cell("qwen2.5-3b", "long_500k")
    assert rec["status"] == "skipped" and "long_500k" in rec["reason"]
    assert D.cell_path("qwen2.5-3b", "long_500k", True, "bf16ssm").endswith(
        os.path.join("dryrun_torch", "qwen2.5-3b__long_500k__2x16x16__bf16ssm.json"))


# ---------------------------------------------------------------------------
# OptFlags


def test_optflags_are_the_references():
    fields = [(f.name, f.default) for f in dataclasses.fields(optflags.OptFlags)]
    assert fields == [(f.name, f.default) for f in dataclasses.fields(joptflags.OptFlags)]
    assert dataclasses.asdict(optflags.OPTIMIZED) == dataclasses.asdict(joptflags.OPTIMIZED)
    assert optflags.BASELINE.name == joptflags.BASELINE.name == "baseline"
    for words in (["ALL"], [], ["mb=8", "bf16_ssm"], ["tp_serving_params", "seq_sharded_cache",
                                                    "no_f32_cast_attn", "cf=2.0"],
                  ["ce_remat", "shard_attn_batch"]):
        kw = {}
        for w in words:
            if w.startswith("mb="):
                kw["microbatches"] = int(w[3:])
            elif w.startswith("cf="):
                kw["capacity_factor"] = float(w[3:])
            elif w != "ALL":
                kw[w] = True
        want = joptflags.OPTIMIZED if words == ["ALL"] else joptflags.OptFlags(**kw)
        assert D.parse_opt(words).name == want.name


def test_opt_flags_reach_the_config():
    cfg = D.apply_opt(get_arch("qwen3-moe-235b-a22b"), optflags.OptFlags(
        no_f32_cast_attn=True, ce_remat=True, bf16_ssm=True, shard_attn_batch=True,
        capacity_factor=2.0))
    assert (cfg.opt_no_f32_cast_attn, cfg.opt_ce_remat, cfg.opt_bf16_ssm,
            cfg.opt_shard_attn_batch, cfg.capacity_factor) == (True, True, True, True, 2.0)
    assert D.apply_opt(get_arch("qwen3-moe-235b-a22b"), optflags.BASELINE).capacity_factor == 1.25


def test_every_config_has_a_cell_for_every_shape():
    assert list_archs() == jconfigs.list_archs()
    assert {s: (v.seq_len, v.global_batch, v.kind) for s, v in D.SHAPES.items()} == {
        s: (v.seq_len, v.global_batch, v.kind) for s, v in jbase.SHAPES.items()}


# ---------------------------------------------------------------------------
# the scan as a registered op


def _scan_args(h0: bool, dtype=torch.float32):
    g = torch.Generator().manual_seed(3)
    bz, s, d, n = 2, 5, 6, 4
    args = [torch.randn((bz, s, d), generator=g).to(dtype), torch.rand((bz, s, d), generator=g),
            torch.randn((bz, s, n), generator=g).to(dtype),
            torch.randn((bz, s, n), generator=g).to(dtype),
            -torch.rand((d, n), generator=g), torch.randn((d,), generator=g)]
    return (*args, torch.randn((bz, d, n), generator=g) if h0 else None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0", [False, True])
def test_scan_op_passes_opcheck(h0, dtype):
    torch.library.opcheck(kssm_ops.scan_op, _scan_args(h0, dtype),
                          test_utils=("test_schema", "test_faketensor"))


def test_scan_op_is_one_node_charged_its_contraction():
    """On ``meta`` the scan is one op of the log: 2 Bz S D N FLOPs (for
    ``FlopCounterMode`` too), its inputs and outputs read and written
    once; on the CPU it runs the plain version and launches nothing."""
    args = [None if t is None else t.to("meta") for t in _scan_args(True)]
    (y, h_last), rec, counter = H.record(kssm_ops.scan_op, *args, device="meta")
    assert [i.op for i in rec.instrs] == ["repro_torch.ssm_scan.default"]
    assert (tuple(y.shape), tuple(h_last.shape), y.dtype) == ((2, 5, 6), (2, 6, 4), torch.float32)
    assert H.analyze_hlo(rec.instrs).flops == counter == 2 * 2 * 5 * 6 * 4
    io = 4 * (2 * 60 + 2 * 40 + 24 + 6 + 48) + 4 * (60 + 48)  # read inputs, write y, h_last
    assert H.analyze_hlo(rec.instrs).hbm_bytes == io
    before = dict(kscan.LAUNCHES)
    cpu = kssm_ops.scan_op(*_scan_args(True))
    assert kscan.LAUNCHES == before
    for got, want in zip(cpu, kssm_ops.ssm_scan_ref(*_scan_args(True))):
        assert torch.equal(got, want)
