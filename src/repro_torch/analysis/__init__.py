"""Static analysis for DHM plans of the port: a plan verifier (the
reference registry's invariants, ``invariants.py``, over ``CompiledDHM``
plans run on their own device, ``verify.py``) and an AST linter (the
reference's DHM0xx rules restated for PyTorch, ``ast_lint.py``).

The counterpart of ``repro.analysis``. CLI: ``python -m
repro_torch.analysis [verify|lint|all] --topology all``. The reference's
jaxpr counters have no counterpart: the kernels' per-thread log
(``repro_torch.kernels.probe``) stands in for them.

Exports resolve lazily, as in the reference.
"""

_EXPORTS = {
    "Finding": "repro_torch.analysis.findings",
    "render_report": "repro_torch.analysis.findings",
    "Invariant": "repro_torch.analysis.invariants",
    "REGISTRY": "repro_torch.analysis.invariants",
    "PipelineProbe": "repro_torch.analysis.verify",
    "ProbeContext": "repro_torch.analysis.verify",
    "make_pipeline_probe": "repro_torch.analysis.verify",
    "verify_plan": "repro_torch.analysis.verify",
    "check_plan": "repro_torch.analysis.verify",
    "RULES": "repro_torch.analysis.ast_lint",
    "lint_paths": "repro_torch.analysis.ast_lint",
    "lint_source": "repro_torch.analysis.ast_lint",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
