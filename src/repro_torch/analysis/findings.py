"""Finding: the record type the plan verifier emits.

The counterpart of ``repro.analysis.findings``, unchanged: the same
fields, severities and renderings, so a finding of the port reads like
one of the reference.
"""

from __future__ import annotations

import dataclasses

SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic from the plan verifier.

    ``rule`` is the stable ID of the reference's registry (``V0xx`` for
    structure, ``V3xx`` for plan invariants); ``where`` locates it (the
    topology's name, or what the caller passed).
    """

    rule: str
    name: str
    severity: str  # "error" | "warning"
    message: str
    where: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(
                f"severity must be one of {SEVERITIES}, got {self.severity!r}"
            )

    @property
    def is_error(self) -> bool:
        return self.severity == "error"

    def render(self) -> str:
        loc = f"{self.where}: " if self.where else ""
        return f"{loc}{self.severity.upper()} [{self.rule}] {self.message}"

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def has_errors(findings) -> bool:
    return any(f.is_error for f in findings)


def render_report(findings, *, header: str = "") -> str:
    """Human-readable multi-line report (``--format text``)."""
    lines = [header] if header else []
    for f in findings:
        lines.append(f.render())
    n_err = sum(1 for f in findings if f.is_error)
    n_warn = len(findings) - n_err
    lines.append(f"{n_err} error(s), {n_warn} warning(s)")
    return "\n".join(lines)
