"""``python -m repro_torch.analysis [verify|lint|all]`` — the static gate.

The counterpart of ``repro.analysis.cli``: the same commands, flags,
variants and JSON report, plus ``--device`` (the card unless ``cpu``).

``verify`` compiles each requested topology in three variants (fp32,
fake-quant at the paper's bit widths, int8) on the device and runs two
artifacts per combination against the invariant registry:

- the single-device plan (plan, structure and resource scopes). On the
  card it stands in for both of the reference's artifacts, the plan and
  its ``pallas_interpret`` probe: the port's structure probe sees every
  kernel dispatch and launch, and the resource scope the shared memory
  each launch requested;
- the pipelined plan on ``min(conv layers, 4)`` stream slots of the
  device (plan and pipeline scopes: the EdgePlan's transfers). A mesh
  of slots on one device needs no forced device count.

``lint`` runs the DHM rule set over ``src/repro_torch`` (and
``benchmarks/torch`` where it exists). Exit status 1 iff any
error-severity finding.
"""

from __future__ import annotations

import argparse
import json
import sys

# Per-network paper bitwidths for the "quant" variant — the reference
# CLI's (its e2e bench's PAPER_BITS).
PAPER_BITS = {
    "lenet5": 3, "cifar10": 6, "svhn": 6,
    "cifar10_full": 6, "cifar10_strided": 6,
}
_DEFAULT_BITS = 6
_MAX_PIPELINE_STAGES = 4


def _parse_args(argv):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="DHM static analysis: plan verifier + AST lint",
    )
    p.add_argument(
        "command", choices=("verify", "lint", "all"),
        help="verify compiled plans, lint sources, or both",
    )
    p.add_argument(
        "--topology", default="all",
        help="comma-separated topology names, or 'all' (default)",
    )
    p.add_argument(
        "--quant", default="all", choices=("all", "fp32", "quant", "int8"),
        help="which quantization variants to verify (default all)",
    )
    p.add_argument(
        "--format", default="text", choices=("text", "json"),
        dest="fmt", help="report format on stdout",
    )
    p.add_argument(
        "--out", default=None,
        help="also write the JSON findings report to this path",
    )
    p.add_argument(
        "--paths", nargs="*", default=None,
        help="lint roots (default: src/repro_torch and benchmarks/torch)",
    )
    p.add_argument(
        "--no-pipeline", action="store_true",
        help="skip the pipelined-plan probe (single-device quick mode)",
    )
    p.add_argument(
        "--batch", type=int, default=2,
        help="frames per probe run",
    )
    p.add_argument(
        "--device", default="cuda",
        help="where the plans run: the card (default) or cpu",
    )
    return p.parse_args(argv)


def _repo_paths():
    """(repo_root, default lint roots) derived from the installed
    package, so the CLI works from any cwd."""
    import os

    import repro_torch

    pkg_dir = os.path.abspath(list(repro_torch.__path__)[0])
    repo_root = os.path.dirname(os.path.dirname(pkg_dir))
    roots = [pkg_dir]
    bench = os.path.join(repo_root, "benchmarks", "torch")
    if os.path.isdir(bench):
        roots.append(bench)
    return repo_root, roots


def _select_topologies(spec: str):
    from repro_torch.models.cnn import ALL_TOPOLOGIES

    if spec == "all":
        return dict(ALL_TOPOLOGIES)
    out = {}
    for name in spec.split(","):
        name = name.strip()
        if name not in ALL_TOPOLOGIES:
            raise SystemExit(
                f"unknown topology {name!r}; have {sorted(ALL_TOPOLOGIES)}"
            )
        out[name] = ALL_TOPOLOGIES[name]
    return out


def run_verify(
    topologies, *, quants="all", batch=2, pipeline=True, device=None,
    log=lambda s: None, traces=None,
):
    """Verify every requested topology x quant on ``device`` (the card
    unless ``"cpu"``); returns findings. Each structure probe's trace is
    appended to ``traces`` where a list is given."""
    import torch

    from repro_torch.analysis.verify import make_pipeline_probe, verify_plan
    from repro_torch.core.dhm.compiler import QuantSpec, compile_dhm
    from repro_torch.models.cnn import init_cnn

    findings = []
    for name, topo in topologies.items():
        params = init_cnn(torch.Generator().manual_seed(0), topo, device=device)
        bits = PAPER_BITS.get(name, _DEFAULT_BITS)
        variants = [
            ("fp32", QuantSpec()),
            ("quant", QuantSpec(weight_bits=bits, act_bits=bits)),
            (
                "int8",
                QuantSpec(
                    weight_bits=min(bits, 8),
                    act_bits=min(bits, 8),
                    int8_compute=True,
                ),
            ),
        ]
        if quants != "all":
            variants = [v for v in variants if v[0] == quants]
        for qlabel, qs in variants:
            where = f"{name}/{qlabel}"
            log(f"verify {where}")
            plan = compile_dhm(topo, params, quant=qs, device=device)
            findings += verify_plan(
                plan,
                scopes=("plan", "structure", "resource"),
                where=where,
                batch=batch,
                traces=traces,
            )
            if pipeline:
                S = min(len(topo.conv_layers), _MAX_PIPELINE_STAGES)
                if S >= 2:
                    pipe_plan = compile_dhm(
                        topo, params, quant=qs, n_stages=S, device=device
                    )
                    probe = make_pipeline_probe(pipe_plan, microbatch=batch)
                    findings += verify_plan(
                        pipe_plan,
                        scopes=("plan", "pipeline"),
                        where=f"{where}/pipelined",
                        batch=batch,
                        pipeline=probe,
                    )
    return findings


def run_lint(paths=None):
    from repro_torch.analysis.ast_lint import lint_paths

    root, default_roots = _repo_paths()
    return lint_paths(paths or default_roots, root=root)


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    from repro_torch.analysis.findings import render_report

    log = (lambda s: print(s, file=sys.stderr)) if args.fmt == "text" else (
        lambda s: None
    )
    findings = []
    if args.command in ("verify", "all"):
        findings += run_verify(
            _select_topologies(args.topology),
            quants=args.quant,
            batch=args.batch,
            pipeline=not args.no_pipeline,
            device=args.device,
            log=log,
        )
    if args.command in ("lint", "all"):
        findings += run_lint(args.paths)

    n_err = sum(1 for f in findings if f.is_error)
    report = {
        "command": args.command,
        "findings": [f.to_json() for f in findings],
        "errors": n_err,
        "warnings": len(findings) - n_err,
    }
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    if args.fmt == "json":
        print(json.dumps(report, indent=2))
    else:
        print(render_report(
            findings, header=f"== repro_torch.analysis {args.command} =="
        ))
    return 1 if n_err else 0
