"""AST lint: the reference's DHM sharp edges restated for PyTorch.

The counterpart of ``repro.analysis.ast_lint``: the same rule IDs, names,
``Rule`` / ``rule`` / ``RULES`` registry and ``lint_source`` /
``lint_paths`` entry points, with each rule's bug class as it shows in
PyTorch on the card:

- ``DHM001`` ``torch.cat`` / ``torch.stack`` of per-request tensors on
  the serving host path — every flush allocates and copies through
  PyTorch (on the card, a launch and a caching-allocator block per
  distinct shape); pack on the host with numpy, as the reference does.
- ``DHM002`` parameter stacking inside a body handed to
  ``torch.cuda.graph``, ``torch.compile`` or ``torch.jit`` — the capture
  bakes one stacked copy of the parameters into the graph, so a later
  update of the resident leaves never reaches it; stack eagerly and
  pass the resident leaves in.
- ``DHM003`` a host clock window around CUDA work with no
  ``torch.cuda.synchronize()``, ``Event.synchronize()`` /
  ``elapsed_time`` or host read inside it — launches return before the
  work runs, so the window measures the enqueue.
- ``DHM004`` bare ``except:`` or a swallowed ``RequestError`` in the
  degradation ladder — failures must demote or surface, never vanish.
- ``DHM005`` float64 on the device path (``torch.float64``,
  ``torch.double``, ``.double()``, ``dtype="float64"``) — the card's
  float64 rate is half its float32 rate, the bytes double, and the
  numbers leave the float32 contract the kernels hold.
- ``DHM006`` a background thread created in serving code with no
  timeout-bounded ``join`` anywhere in the module — a wedged dispatch
  leaks the thread past interpreter shutdown; shutdown paths must join
  with a timeout and fail loudly.

Rules are scoped by path pattern (``fnmatch``; ``*`` crosses
directories): ``path_globs`` says where a rule applies and
``skip_globs`` where, within that, its bug class cannot occur (each
rule's docstring says why). The module imports no torch: pure ``ast``.
"""

from __future__ import annotations

import ast
import dataclasses
import fnmatch
import os
from typing import Callable, Dict, List, Tuple

from repro_torch.analysis.findings import Finding

# Names under which the degradation ladder's structured request errors
# travel (engine.py) — swallowing one hides a serving failure (DHM004).
_REQUEST_ERRORS = {
    "RequestError", "DeadlineExceeded", "Rejected", "Shed",
    "InvalidRequest", "BatchFailed", "CircuitOpen",
}

_TIME_CALLS = {
    "time.time", "time.perf_counter", "time.monotonic",
    "perf_counter", "monotonic",
}

_CONCATS = {"torch.cat", "torch.concat", "torch.concatenate", "torch.stack"}

# Calls that make the host wait for the card (DHM003): a device-wide or
# event sync, an event's elapsed time (valid only once both events ran),
# or a read of a device value to the host.
_SYNC_ATTRS = {"synchronize", "elapsed_time", "item", "cpu", "tolist", "numpy"}

# Entry points that capture or compile a Python body (DHM002).
_CAPTURE_CALLS = (
    "torch.compile", "torch.jit.script", "torch.jit.trace",
    "torch.cuda.make_graphed_callables",
)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    doc: str
    path_globs: tuple  # fnmatch patterns against the posix relpath
    fn: Callable  # (ast.Module, src: str, relpath: str) -> [(line, msg)]
    skip_globs: tuple = ()  # paths within path_globs the bug class cannot reach

    def applies_to(self, relpath: str) -> bool:
        p = relpath.replace(os.sep, "/")
        return (any(fnmatch.fnmatch(p, g) for g in self.path_globs)
                and not any(fnmatch.fnmatch(p, g) for g in self.skip_globs))


RULES: Dict[str, Rule] = {}


def rule(id: str, *, name: str, path_globs, skip_globs=()):
    def deco(fn):
        if id in RULES:
            raise ValueError(f"duplicate rule id {id!r}")
        RULES[id] = Rule(
            id=id, name=name, doc=fn.__doc__ or "",
            path_globs=tuple(path_globs), fn=fn, skip_globs=tuple(skip_globs),
        )
        return fn

    return deco


# ---------------------------------------------------------------------------
# shared AST helpers


def _dotted(node) -> str:
    """Best-effort dotted source name of a call target ('torch.stack',
    'time.perf_counter', 'torch.cuda.synchronize', ...); '' when not
    name-shaped."""
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _parent_functions(tree) -> Dict[ast.AST, ast.AST]:
    """Map every node to its innermost enclosing function def (or None)."""
    owner: Dict[ast.AST, ast.AST] = {}

    def walk(node, fn):
        for child in ast.iter_child_nodes(node):
            owner[child] = fn
            walk(
                child,
                child
                if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
                else fn,
            )

    walk(tree, None)
    return owner


def _is_capture(nm: str) -> bool:
    return nm.endswith(_CAPTURE_CALLS)


def _captured_nodes(tree) -> set:
    """Nodes that run inside a captured or compiled body: every node of a
    function decorated with ``torch.compile`` / ``torch.jit.script`` (or
    ``partial(torch.compile, ...)``) or passed by name to one of the
    ``_CAPTURE_CALLS``, and every node inside a ``with
    torch.cuda.graph(...)`` block."""
    fns = set()
    by_name: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            by_name.setdefault(node.name, []).append(node)
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                nm = _dotted(target)
                if _is_capture(nm):
                    fns.add(node)
                elif nm.endswith("partial") and isinstance(dec, ast.Call):
                    if any(_is_capture(_dotted(a)) for a in dec.args):
                        fns.add(node)
    roots = list(fns)
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and _dotted(node.func).endswith(_CAPTURE_CALLS):
            for arg in node.args[:1]:
                roots += by_name.get(_dotted(arg), [])
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            isinstance(it.context_expr, ast.Call)
            and _dotted(it.context_expr.func).endswith("cuda.graph")
            for it in node.items
        ):
            roots += node.body
    return {n for root in roots for n in ast.walk(root)}


# ---------------------------------------------------------------------------
# rules


@rule(
    "DHM001",
    name="eager-concat-on-host-path",
    path_globs=("*core/dhm/engine.py", "*serve*.py"),
)
def _eager_concat(tree, src, relpath):
    """``torch.cat`` / ``torch.stack`` of per-request tensors in serving
    code, outside any captured body: every flush allocates and copies
    through PyTorch — on the card a copy launch and a caching-allocator
    block per distinct batch shape, on the dispatch thread. Pack frames
    and logits with numpy on the host (one staging buffer, one copy), as
    the reference packs them."""
    captured = _captured_nodes(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or node in captured:
            continue  # inside a capture: DHM002's domain
        nm = _dotted(node.func)
        if nm in _CONCATS:
            out.append((
                node.lineno,
                f"eager {nm} on the serving host path allocates and copies per "
                "flush — pack with np.concatenate/np.stack instead",
            ))
    return out


@rule(
    "DHM002",
    name="param-stack-inside-jit",
    path_globs=(
        "*core/dhm/pipeline.py", "*core/dhm/engine.py",
        "*core/dhm/compiler.py",
    ),
)
def _stack_inside_capture(tree, src, relpath):
    """``torch.stack`` / ``torch.cat`` inside a body handed to
    ``torch.cuda.graph``, ``torch.compile`` or ``torch.jit``: the capture
    records one stacked copy of the parameters, so an update of the
    resident leaves (a hot swap, a training step) never reaches the
    replayed graph. Stack eagerly outside the capture and pass the
    resident leaves in. The port captures and compiles nothing today
    (``CompiledDHM`` runs eagerly; a CUDA-graph forward is queued perf
    work), so this rule finds nothing in it; the eager stacks of
    ``pipeline.py`` (the last stage's outputs, ``stack_stage_params``)
    are the fix the rule asks for, not its bug."""
    captured = _captured_nodes(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or node not in captured:
            continue
        nm = _dotted(node.func)
        if nm in _CONCATS:
            out.append((
                node.lineno,
                f"{nm} inside a captured or compiled body — stack params "
                "eagerly outside the capture and pass the resident leaves in",
            ))
    return out


@rule(
    "DHM003",
    name="timing-without-block",
    path_globs=("*bench*.py", "*benchmarks/*"),
)
def _timing_without_sync(tree, src, relpath):
    """A host clock window around CUDA work (a ``torch.*`` call between
    two clock reads) with no ``torch.cuda.synchronize()``, event
    ``synchronize()`` / ``elapsed_time`` or host read (``.item()``,
    ``.cpu()``, ``.tolist()``, ``.numpy()``) inside it: launches return
    before the card runs them, so the window measures the enqueue."""
    owner = _parent_functions(tree)
    out = []
    fns = [
        n for n in ast.walk(tree)
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    ]
    for fn in fns:
        time_lines, dispatches, syncs = [], [], []
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            if owner.get(node) is not fn:
                continue  # a call inside a nested def belongs to that def
            nm = _dotted(node.func)
            attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
            if nm in _TIME_CALLS:
                time_lines.append(node.lineno)
            elif attr in _SYNC_ATTRS:
                syncs.append(node.lineno)
            elif nm.startswith("torch.") and not nm.startswith("torch.cuda.Event"):
                dispatches.append(node)
        if len(time_lines) < 2:
            continue
        lo, hi = min(time_lines), max(time_lines)
        if any(lo <= line <= hi for line in syncs):
            continue
        for node in dispatches:
            if lo < node.lineno < hi:
                out.append((
                    node.lineno,
                    f"CUDA work {_dotted(node.func)} timed on the host clock with "
                    "no torch.cuda.synchronize() or host read in the window — "
                    "the launch returns before the work runs",
                ))
    return out


@rule(
    "DHM004",
    name="swallowed-request-error",
    path_globs=("*core/dhm/*.py",),
)
def _swallowed_errors(tree, src, relpath):
    """Bare ``except:`` or a RequestError-family handler whose body only
    passes: a degradation-ladder failure silently vanishes instead of
    demoting or surfacing."""
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if node.type is None:
            out.append((
                node.lineno,
                "bare except: swallows every failure including "
                "KeyboardInterrupt — name the exception",
            ))
            continue
        types = (
            node.type.elts if isinstance(node.type, ast.Tuple)
            else [node.type]
        )
        names = {_dotted(t).rsplit(".", 1)[-1] for t in types}
        if not (names & _REQUEST_ERRORS):
            continue
        body_is_noop = all(
            isinstance(stmt, (ast.Pass, ast.Continue))
            or (
                isinstance(stmt, ast.Expr)
                and isinstance(stmt.value, ast.Constant)
            )
            for stmt in node.body
        )
        if body_is_noop:
            out.append((
                node.lineno,
                f"swallowed {sorted(names & _REQUEST_ERRORS)} — a request "
                "failure must demote, complete the request, or re-raise",
            ))
    return out


@rule(
    "DHM005",
    name="float64-on-device-path",
    path_globs=("*.py",),
    skip_globs=("*kernels/*/ref.py",),
)
def _float64(tree, src, relpath):
    """float64 on the device path (``torch.float64``, ``torch.double``,
    ``.double()``, a ``dtype="float64"``): the card runs float64 at half
    its float32 rate with twice the bytes, and the numbers leave the
    float32 contract the kernels and the reference hold. Stay in float32.
    The kernels' plain versions (``kernels/*/ref.py``) are skipped: a
    wrapper sends a CUDA tensor to its kernel and only a CPU tensor to
    the plain version, whose float64 sums of integer codes are exact and
    never run on the card."""
    out = []
    for node in ast.walk(tree):
        if (
            isinstance(node, ast.Attribute)
            and node.attr in ("float64", "double")
            and _dotted(node.value).endswith("torch")
        ):
            out.append((
                node.lineno,
                f"torch.{node.attr} on the device path — the card runs float64 "
                "at half its float32 rate; stay in float32",
            ))
        if isinstance(node, ast.Call):
            if isinstance(node.func, ast.Attribute) and node.func.attr == "double" \
                    and not node.args and not _dotted(node.func.value).endswith("torch"):
                out.append((
                    node.lineno,
                    ".double() widens a device value to float64 — stay in float32",
                ))
            for kw in node.keywords:
                if kw.arg == "dtype" and isinstance(kw.value, ast.Constant) \
                        and kw.value.value == "float64":
                    out.append((
                        kw.value.lineno,
                        '"float64" dtype on a device value — stay in float32',
                    ))
    return out


@rule(
    "DHM006",
    name="unbounded-background-thread",
    path_globs=(
        "*core/dhm/engine.py", "*core/dhm/multitenant.py", "*serve*.py",
    ),
)
def _unbounded_background_thread(tree, src, relpath):
    """A serving module that constructs ``threading.Thread`` must also
    contain a timeout-bounded ``.join(...)`` — an unbounded (or absent)
    join lets a dispatch wedged past the watchdog leak the thread into
    interpreter shutdown. Bound the join and fail loudly on expiry."""
    thread_ctors = []
    bounded_join = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        nm = _dotted(node.func)
        if nm in ("threading.Thread", "Thread"):
            thread_ctors.append(node)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "join"
            # a str.join ('; '.join(...)) is not a thread join
            and not (
                isinstance(node.func.value, ast.Constant)
                and isinstance(node.func.value.value, str)
            )
            and (
                node.args
                or any(kw.arg == "timeout" for kw in node.keywords)
            )
        ):
            bounded_join = True
    if bounded_join:
        return []
    return [
        (
            node.lineno,
            "background thread created but the module has no "
            "timeout-bounded .join(...) — a wedged dispatch leaks the "
            "thread past shutdown; join with a timeout and fail loudly",
        )
        for node in thread_ctors
    ]


# ---------------------------------------------------------------------------
# linting files


def lint_source(
    src: str, relpath: str, rules=None
) -> List[Finding]:
    """Lint one file's source; returns findings (never raises on a
    syntactically valid file)."""
    if rules is None:
        active = list(RULES.values())
    elif isinstance(rules, dict):
        active = list(rules.values())
    else:
        active = list(rules)
    tree = ast.parse(src)
    findings = []
    for r in active:
        if not r.applies_to(relpath):
            continue
        for line, msg in r.fn(tree, src, relpath):
            findings.append(Finding(
                rule=r.id, name=r.name, severity="error", message=msg,
                where=f"{relpath}:{line}",
            ))
    return findings


def lint_paths(paths, *, root: str = ".", rules=None) -> List[Finding]:
    """Walk ``paths`` (files or directories) and lint every ``.py`` file;
    ``where`` carries paths relative to ``root``."""
    findings: List[Finding] = []
    files: List[Tuple[str, str]] = []
    for p in paths:
        if os.path.isfile(p):
            files.append((p, os.path.relpath(p, root)))
        else:
            for dirpath, _dirnames, filenames in os.walk(p):
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        full = os.path.join(dirpath, fn)
                        files.append((full, os.path.relpath(full, root)))
    for full, rel in files:
        with open(full, encoding="utf-8") as fh:
            src = fh.read()
        try:
            findings.extend(lint_source(src, rel, rules=rules))
        except SyntaxError as e:
            findings.append(Finding(
                rule="DHM000", name="syntax-error", severity="error",
                message=f"file does not parse: {e}", where=f"{rel}:{e.lineno}",
            ))
    return findings
