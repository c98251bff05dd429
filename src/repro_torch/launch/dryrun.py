"""Dry run: trace every (architecture x input shape x mesh) cell on the
``meta`` device and record the FLOPs, bytes and memory of its step — the
counterpart of ``repro.launch.dryrun``.

The reference lowers and compiles each cell's jitted step for 256 or 512
fake devices and reads XLA's memory and cost analyses and its HLO. The
port compiles nothing: it runs the cell's step eagerly on ``meta``
tensors (the stand-ins of ``launch/specs.py``, shapes only, nothing
allocated) under ``hlo_analysis.OpRecorder``, and counts the op log with
the reference's charging rules. What that gives, and what it cannot:

- ``step``: the one-card eager step: FLOPs and HBM bytes from the log,
  the peak of the live bytes it creates, its arguments' bytes.
- ``analysis``: the step's FLOPs and bytes split evenly over the mesh's
  ``n_devices`` (``"per_device": "even_split"``); the port runs no SPMD
  program, so ``collective_bytes_per_device`` and ``collectives`` are
  null and ``collective_counts`` is empty.
- ``memory``: ``argument_size_in_bytes`` and ``output_size_in_bytes``
  per device, exact: each leaf's shard under ``launch/sharding.py``'s
  specs; ``alias_size_in_bytes`` 0 (no donation);
  ``temp_size_in_bytes`` null; ``generated_code_size_in_bytes`` 0.
- ``cost``: ``FlopCounterMode``'s total over the same run, split as
  above (the counterpart of XLA's own cost model; it equals the log's).
- ``trace_s`` in place of ``lower_s``; ``compile_s`` is null.

Run it as its own process (it sets no ``XLA_FLAGS`` and imports no JAX;
any process may import it):

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records land in ``$REPRO_RESULTS_DIR/dryrun_torch/<arch>__<shape>__<mesh>
[__<opt>].json`` (never over a reference record), the op log beside each
as ``.ops.xz`` (``lzma``); ``python -m repro_torch.launch.reanalyze``
re-derives ``analysis`` from the logs.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import lzma
import math
import os
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_arch, list_archs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.hlo_analysis import analyze_hlo, format_log, record
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.optflags import BASELINE, OPTIMIZED, OptFlags
from repro_torch.launch.sharding import P, batch_specs, cache_specs, constrain_spec, param_specs
from repro_torch.launch.specs import cache_shapes, input_specs, params_shapes
from repro_torch.launch.steps import jit_train_step, make_decode_step, make_prefill_step
from repro_torch.models.accounting import active_param_count, model_flops, param_count
from repro_torch.models.transformer import init_params, init_stack_cache
from repro_torch.optim import AdamWConfig, OptState, adamw_init
from repro_torch.tree_util import tree_leaves

RESULTS_DIR = os.environ.get("REPRO_RESULTS_DIR", "results")


def apply_opt(cfg: ArchConfig, opt: OptFlags) -> ArchConfig:
    """The config under ``opt``'s model flags, as the reference's run_cell."""
    return dataclasses.replace(
        cfg,
        opt_no_f32_cast_attn=opt.no_f32_cast_attn,
        opt_ce_remat=opt.ce_remat,
        opt_bf16_ssm=opt.bf16_ssm,
        opt_shard_attn_batch=opt.shard_attn_batch,
        **({"capacity_factor": opt.capacity_factor} if opt.capacity_factor else {}),
    )


def cell_step(cfg: ArchConfig, shape: ShapeConfig, mesh, opt: OptFlags = BASELINE):
    """(step, meta arguments, their spec tree) of one cell: the train step
    of ``jit_train_step`` with ``opt.microbatches``, or the prefill or
    decode step; decode takes the host int ``shape.seq_len - 1`` as its
    index (not an argument: it has no bytes)."""
    params, _, p_specs = params_shapes(
        cfg, mesh, fsdp=shape.kind == "train" or not opt.tp_serving_params)
    inputs = input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        step, opt_state = jit_train_step(cfg, mesh, params, inputs,
                                         microbatches=opt.microbatches)
        o_specs = OptState(step=P(), m=param_specs(opt_state.m, mesh, fsdp=True),
                           v=param_specs(opt_state.v, mesh, fsdp=True), master=None)
        return step, (params, opt_state, inputs), (p_specs, o_specs, batch_specs(inputs, mesh))
    if shape.kind == "prefill":
        return (make_prefill_step(cfg, shape), (params, inputs),
                (p_specs, batch_specs(inputs, mesh)))
    cache, _, c_specs = cache_shapes(cfg, shape, mesh, seq_sharded=opt.seq_sharded_cache)
    return (make_decode_step(cfg), (params, cache, inputs["token"], shape.seq_len - 1),
            (p_specs, c_specs, batch_specs(inputs, mesh)["token"], None))


def output_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, out, arg_specs,
                 opt: OptFlags = BASELINE):
    """The spec tree of a step's outputs, as the reference's out_shardings:
    the train step's parameters and optimizer state as its arguments,
    replicated metrics; the serve steps' logits over (data, model) and
    their caches under ``cache_specs``."""
    if shape.kind == "train":
        return (arg_specs[0], arg_specs[1], {k: P() for k in out[2]})
    da = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    logits, cache = out
    return (constrain_spec(P(da, "model"), tuple(logits.shape), mesh),
            cache_specs(cache, mesh, cfg, seq_sharded=opt.seq_sharded_cache))


def _leaf_pairs(tree, specs):
    """(tensor, spec) pairs of a tree (dicts, lists, tuples, ``OptState``;
    ``None`` and host ints hold no tensor) and its spec tree."""
    if isinstance(tree, torch.Tensor):
        yield tree, specs
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_pairs(v, specs[k])
    elif isinstance(tree, (list, tuple)):
        for v, s in zip(tree, specs):
            yield from _leaf_pairs(v, s)


def shard_bytes(t: torch.Tensor, spec, mesh) -> int:
    """The bytes of one device's shard of ``t`` under ``spec``."""
    dims = list(t.shape)
    for i, entry in enumerate(spec):
        if entry is not None:
            dims[i] //= math.prod(mesh.shape[a] for a in
                                  (entry if isinstance(entry, tuple) else (entry,)))
    return math.prod(dims) * t.element_size()


def tree_bytes(tree, specs=None, mesh=None) -> int:
    """The bytes of a tree's tensors: per device under ``specs`` on
    ``mesh``, whole without them."""
    if specs is None:
        return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
                   if isinstance(t, torch.Tensor))
    return sum(shard_bytes(t, s, mesh) for t, s in _leaf_pairs(tree, specs))


def cell_args(cfg: ArchConfig, shape: ShapeConfig, generator: torch.Generator) -> tuple:
    """A cell's arguments drawn for real on ``generator``'s device, the
    trees of ``cell_step``'s stand-ins: the parameters from the model's
    initializer, AdamW's zero state, token ids uniform over the
    vocabulary, prefix embeddings and encoder frames N(0, 1), a zero
    cache; decode's index the same host int."""
    dev = generator.device
    b, s = shape.global_batch, shape.seq_len
    params = init_params(generator, cfg, device=dev)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (b, n), generator=generator, device=dev,
                             dtype=torch.int32)

    if shape.kind not in ("train", "prefill"):
        return params, init_stack_cache(cfg, cfg.n_layers, b, s, device=dev), tokens(1), s - 1
    batch = {"tokens": tokens(s + 1 if shape.kind == "train" else s)}
    dt = getattr(torch, cfg.dtype)
    for key, n, family in (("prefix_embeds", cfg.n_prefix_tokens, "vlm"),
                           ("encoder_frames", cfg.encoder_seq, "encdec")):
        if cfg.family == family:
            batch[key] = torch.randn((b, n, cfg.d_model), generator=generator,
                                     device=dev).to(dt)
    if shape.kind == "train":
        return params, adamw_init(params, AdamWConfig()), batch
    return params, batch


@dataclasses.dataclass
class Trace:
    """One cell's step run on ``meta``: the op log, the step's output, the
    arguments and their specs, ``FlopCounterMode``'s total, the live
    bytes' peak and the seconds it took."""

    instrs: list
    out: object
    args: tuple
    arg_specs: tuple
    counter_flops: float
    peak_live_bytes: int
    trace_s: float


def trace_cell(cfg: ArchConfig, shape: ShapeConfig, mesh, opt: OptFlags = BASELINE) -> Trace:
    """Run one cell's step (``cfg`` already under ``opt``'s flags) on its
    meta stand-ins under the recorder."""
    t0 = time.time()
    step, args, arg_specs = cell_step(cfg, shape, mesh, opt)
    out, rec, counter = record(step, *args, device="meta")
    return Trace(rec.instrs, out, args, arg_specs, float(counter), rec.peak_live_bytes,
                 time.time() - t0)


def analysis_dict(a, n_devices: int) -> dict:
    """The record's ``analysis``: the step's counts split evenly."""
    return {
        "flops_per_device": a.flops / n_devices,
        "hbm_bytes_per_device": a.hbm_bytes / n_devices,
        "collective_bytes_per_device": None,
        "collective_counts": a.collective_counts,
        "unknown_trip_whiles": a.unknown_trip_whiles,
        "per_device": "even_split",
    }


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False, opt=None) -> dict:
    opt = opt or BASELINE
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    if not cfg.supports_shape(shape):
        return {
            "arch": arch, "shape": shape_name, "mesh": _mesh_name(multi_pod),
            "opt": opt.name,
            "status": "skipped",
            "reason": "full-attention arch; long_500k needs sub-quadratic "
                      "attention (DESIGN.md §Arch-applicability)",
        }
    cfg = apply_opt(cfg, opt)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n = mesh.size
    result = {
        "arch": arch, "shape": shape_name, "mesh": "x".join(map(str, mesh.shape.values())),
        "opt": opt.name, "status": "ok", "n_devices": n,
    }
    tr = trace_cell(cfg, shape, mesh, opt)
    result["trace_s"] = round(tr.trace_s, 2)
    result["compile_s"] = None
    out_specs = output_specs(cfg, shape, mesh, tr.out, tr.arg_specs, opt)
    result["memory"] = {
        "generated_code_size_in_bytes": 0,
        "argument_size_in_bytes": tree_bytes(tr.args, tr.arg_specs, mesh),
        "output_size_in_bytes": tree_bytes(tr.out, out_specs, mesh),
        "alias_size_in_bytes": 0,
        "temp_size_in_bytes": None,
    }
    a = analyze_hlo(tr.instrs)
    result["cost"] = {"flops_per_device": tr.counter_flops / n,
                      "bytes_accessed_per_device": None}
    result["analysis"] = analysis_dict(a, n)
    result["collectives"] = None
    log = format_log(tr.instrs)
    result["hlo_bytes"] = len(log)
    result["step"] = {"flops": a.flops, "hbm_bytes": a.hbm_bytes,
                      "flop_counter_flops": tr.counter_flops,
                      "peak_live_bytes": tr.peak_live_bytes,
                      "argument_bytes": tree_bytes(tr.args), "ops": len(tr.instrs)}
    _save_log(arch, shape_name, multi_pod, log, opt.name)
    result["params"] = param_count(cfg)
    result["active_params"] = active_param_count(cfg)
    result["model_flops"] = model_flops(cfg, shape)
    return result


def cell_path(arch: str, shape_name: str, multi_pod: bool, opt_name: str = "baseline") -> str:
    suffix = "" if opt_name == "baseline" else f"__{opt_name}"
    return os.path.join(RESULTS_DIR, "dryrun_torch",
                        f"{arch}__{shape_name}__{_mesh_name(multi_pod)}{suffix}.json")


def log_path(json_path: str) -> str:
    return json_path[: -len(".json")] + ".ops.xz"


def _save_log(arch: str, shape_name: str, multi_pod: bool, log: str,
              opt_name: str = "baseline") -> None:
    """The op log, compressed, beside the record, so the analysis can be
    re-derived without a re-trace."""
    path = log_path(cell_path(arch, shape_name, multi_pod, opt_name))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with lzma.open(path, "wt", preset=1) as f:
        f.write(log)


def parse_opt(flags) -> OptFlags:
    """``--opt``'s words: flag names, ``mb=<n>``, ``cf=<x>`` or ``ALL``."""
    if list(flags) == ["ALL"]:
        return OPTIMIZED
    kw: dict = {}
    for o in flags:
        if o.startswith("mb="):
            kw["microbatches"] = int(o[3:])
        elif o.startswith("cf="):
            kw["capacity_factor"] = float(o[3:])
        else:
            kw[o] = True
    return OptFlags(**kw) if kw else BASELINE


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument(
        "--opt", nargs="*", default=[],
        help="optimization flags: tp_serving_params seq_sharded_cache "
             "no_f32_cast_attn ce_remat bf16_ssm mb=<n> cf=<x> | ALL",
    )
    args = ap.parse_args(argv)
    opt = parse_opt(args.opt)

    if args.all:
        cells = [(a, s) for a in list_archs() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(os.path.join(RESULTS_DIR, "dryrun_torch"), exist_ok=True)
    failures = 0
    for arch, shape_name in cells:
        path = cell_path(arch, shape_name, args.multi_pod, opt.name)
        if os.path.exists(path) and not args.force:
            print(f"[skip cached] {path}")
            continue
        print(f"[dryrun] {arch} x {shape_name} ({_mesh_name(args.multi_pod)}, {opt.name}) ...",
              flush=True)
        try:
            res = run_cell(arch, shape_name, multi_pod=args.multi_pod, opt=opt)
        except Exception as e:  # noqa: BLE001 — record and continue
            res = {
                "arch": arch, "shape": shape_name, "mesh": _mesh_name(args.multi_pod),
                "opt": opt.name,
                "status": "error",
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
            failures += 1
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        print(f"  -> {res['status']}"
              + (f" (trace {res['trace_s']}s)" if res["status"] == "ok" else ""), flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
