"""The plan verifier of the port: the reference registry's ``plan``,
``structure`` and ``pipeline`` invariants (``invariants.py``) over
``CompiledDHM`` plans, run on the plan's own device (``verify.py``).

The counterpart of ``repro.analysis``. Its ``resource`` scope, the AST
linter and the CLI are not ported yet; asking ``verify_plan`` for that
scope raises.

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
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name]), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
