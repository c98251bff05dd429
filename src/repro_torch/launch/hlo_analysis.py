"""The op log of one eager step and its analysis — the counterpart of
``repro.launch.hlo_analysis``.

The reference counts FLOPs, HBM bytes and collective bytes from XLA's
post-optimization HLO. The port compiles nothing, so its "HLO" is its own
**op log**: :class:`OpRecorder` (a ``TorchDispatchMode``) writes one
:class:`Instr` for each op the step dispatches below autograd (aten ops,
and the selective scan and its gradient as the ops ``repro_torch.ssm_scan``
and ``repro_torch.ssm_scan_bwd``), with each
operand's and result's shape, dtype, storage identity, base (storage)
bytes and whether it is a view. The log's text form is one line per op
(:func:`format_log`); :func:`parse_computations` reads it back. An eager
log unrolls every loop, so no trip count is needed. The recorder also
tracks the bytes of the live storages the step created, to give their
peak.

The reference's charging rules, restated for an eager program:

  flops            ``mm``, ``addmm``, ``bmm``, ``baddbmm`` and
                   ``convolution`` at 2 x output elements x contraction,
                   plus 2 Bz S D N for the scan op and for its
                   gradient's (``kernels/ssm_scan/ops.py``): the total
                   ``FlopCounterMode`` gives
  hbm_bytes        one entry per op. Eager PyTorch fuses nothing, so this
                   is the traffic the card does: an op reads its operands
                   (at most their base bytes: an expanded view is read
                   once) and writes its results. Views cost nothing; an
                   in-place write of an update (``copy_``, ``index_put_``,
                   ``slice_scatter``, ``index_copy_``, ``scatter_``,
                   ``scatter_add_``, ``index_add_``) is charged the update
                   twice, not its base (the reference's dynamic-update-
                   slice rule); ``index_select``, ``embedding`` and
                   ``gather`` are charged result-sized reads and their
                   write; ``empty`` costs 0 and a fill its write
  collective_bytes none: one card runs no collective (the c10d
                   functional ops of ``C10D_COLLECTIVES`` would be
                   counted, ``dryrun.parse_collectives``)

All counts are for the whole step on one card; the dry run
(``launch/dryrun.py``) splits them over a mesh.
"""
from __future__ import annotations

import dataclasses
import math
import os
import re
import sys
import weakref
from collections import namedtuple
from typing import Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# The reference's HLO dtype names where there is one, by torch's name.
_SHORT = {"bool": "pred", "int8": "s8", "uint8": "u8", "int16": "s16", "int32": "s32",
          "int64": "s64", "float16": "f16", "bfloat16": "bf16", "float32": "f32",
          "float64": "f64", "complex64": "c64", "complex128": "c128"}
_DTYPES = [d for d in vars(torch).values() if isinstance(d, torch.dtype)]
DTYPE_NAMES = {d: _SHORT.get(str(d)[6:], str(d)[6:]) for d in _DTYPES}  # str(d): "torch.<name>"
_DTYPE_BYTES = {DTYPE_NAMES[d]: d.itemsize for d in _DTYPES}

# Ops that only re-describe a storage. Most say so in their schema (an
# aliased return, :func:`_kind`); these do not.
_VIEW_OPS = {"aten._unsafe_view", "aten.lift_fresh"}
_EMPTY_OPS = {"aten.empty", "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided",
              "aten.empty_like"}
_FILL_OPS = {"aten.fill_", "aten.zero_", "aten.fill", "aten.zeros", "aten.ones", "aten.full",
             "aten.zeros_like", "aten.ones_like", "aten.full_like", "aten.new_zeros",
             "aten.new_ones", "aten.new_full", "aten.scalar_tensor"}
# Writes of an update into a base; the update is the last tensor operand
# (a scalar scatter's is its index, one element a write).
_UPDATE_OPS = {"aten.copy_", "aten.index_put_", "aten.slice_scatter", "aten.index_copy_",
               "aten.scatter_", "aten.scatter_add_", "aten.index_add_"}
# Slice-like reads: they touch only their result-sized region.
_SLICE_READ_OPS = {"aten.index_select", "aten.embedding", "aten.gather"}
# Contractions: the operand index of the left factor.
_CONTRACT_OPS = {"aten.mm": 0, "aten.bmm": 0, "aten.addmm": 1, "aten.baddbmm": 1}
SCAN_OP = "repro_torch.ssm_scan"
SCAN_BWD_OP = "repro_torch.ssm_scan_bwd"
# The reference's collective kinds (XLA's op names), and the c10d
# functional ops an op log records for each
# (``torch.distributed._functional_collectives``). A permute is
# point-to-point: its sends are charged, as the reference charges what
# each device contributes. Waits (``_c10d_functional.wait_tensor``), the
# ends of async pairs, and receives are not counted. One card runs none
# of these.
COLLECTIVE_OPS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
C10D_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_out": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_reduce_coalesced_": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_out": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.isend": "collective-permute",
}

# One operand or result: shape, dtype name, storage identity (unique in
# the log), the storage's bytes, and whether the tensor is a view.
Val = namedtuple("Val", "shape dtype storage base view")


@dataclasses.dataclass
class Instr:
    """One op of the log: its overload (``aten.mm.default``), its kind
    (``op``, ``view`` or ``inplace``, from its schema), its tensor operands
    and results in order, and its site (the innermost ``repro_torch``
    frame, ``models/ssm.py:134``)."""

    name: str
    op: str
    kind: str
    operands: tuple
    results: tuple
    site: str = "?"

    @property
    def packet(self) -> str:
        """The op without its overload: ``aten.mm``."""
        return self.op.rsplit(".", 1)[0]


def val_bytes(v: Val) -> int:
    return math.prod(v.shape) * _DTYPE_BYTES[v.dtype]


def _read_bytes(v: Val) -> int:
    return min(val_bytes(v), v.base)


# ---------------------------------------------------------------------------
# Recording


_OPS: dict = {}  # overload -> (its name, its kind)


def _op(func) -> tuple:
    """(``aten.mm.default``, kind) of an overload, kind from its schema."""
    entry = _OPS.get(func)
    if entry is None:
        schema = func._schema
        if any(a.alias_info is not None and a.alias_info.is_write for a in schema.arguments):
            kind = "inplace"
        elif any(r.alias_info is not None for r in schema.returns):
            kind = "view"
        else:
            kind = "op"
        entry = _OPS[func] = (str(func), kind)
    return entry


def _tensors(values):
    """The tensors among an op's arguments or results, in order (aten
    takes tensors alone or in one flat list)."""
    for v in values:
        if isinstance(v, torch.Tensor):
            yield v
        elif isinstance(v, (list, tuple)):
            for x in v:
                if isinstance(x, torch.Tensor):
                    yield x


_PKG = os.sep + "repro_torch" + os.sep
_SELF = os.path.abspath(__file__)


def _site() -> str:
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        i = fn.rfind(_PKG)
        if i >= 0 and fn != _SELF:
            return f"{fn[i + len(_PKG):]}:{f.f_lineno}"
        f = f.f_back
    return "?"


class OpRecorder(TorchDispatchMode):
    """Record the op log of what runs inside the ``with`` block.

    ``instrs`` is the log. ``live_bytes`` is the bytes of the storages
    that ops inside the block created (on ``device``'s type, every
    device when None) and that are still alive; ``peak_live_bytes`` its
    largest value, taken as each op's results appear (the operands are
    still alive then). A storage is forgotten when it is freed, through a
    weak reference to it; storages that existed before the block
    (arguments) are never counted. Enter it inside any other mode
    (``FlopCounterMode``), so the log does not depend on that mode."""

    def __init__(self, device=None):
        super().__init__()
        self.device = None if device is None else torch.device(device).type
        self.instrs: list = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._storages: dict = {}  # StorageImpl address -> (id, counted bytes, weak ref)
        self._next = 0

    def _freed(self, key, _ref=None) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live_bytes -= entry[1]

    def _val(self, t: torch.Tensor, created: bool) -> Val:
        st = t.untyped_storage()
        key = st._cdata
        entry = self._storages.get(key)
        if entry is None:
            counted = st.nbytes() if created and self.device in (None, t.device.type) else 0
            entry = (self._next, counted, weakref.ref(st, lambda r, k=key: self._freed(k)))
            self._storages[key] = entry
            self._next += 1
            self.live_bytes += counted
        return Val(tuple(t.shape), DTYPE_NAMES[t.dtype], entry[0], st.nbytes(), t._is_view())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        operands = tuple(self._val(t, False) for t in _tensors((*args, *kwargs.values())))
        out = func(*args, **kwargs)
        results = tuple(self._val(t, True) for t in _tensors((out,)))
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        self.instrs.append(Instr(f"%{len(self.instrs)}", *_op(func), operands, results, _site()))
        return out


# ---------------------------------------------------------------------------
# Text form


def _val_text(v: Val) -> str:
    return (f"{v.dtype}[{','.join(map(str, v.shape))}]#{v.storage}:{v.base}"
            + ("v" if v.view else ""))


def format_log(instrs) -> str:
    """The log as text, one line per op:
    ``%3 = aten.mm.default op (f32[64,64]#0:16384, f32[64,64]#1:16384) ->
    (f32[64,64]#2:16384) @ models/layers.py:40`` (``v`` after a view)."""
    return "".join(f"{i.name} = {i.op} {i.kind} ({', '.join(map(_val_text, i.operands))}) -> "
                   f"({', '.join(map(_val_text, i.results))}) @ {i.site}\n" for i in instrs)


_LINE = re.compile(r"^(?P<name>%\d+) = (?P<op>\S+) (?P<kind>op|view|inplace) "
                   r"\((?P<ins>[^)]*)\) -> \((?P<outs>[^)]*)\) @ (?P<site>.*)$")
_VAL = re.compile(r"(?P<dtype>[\w]+)\[(?P<dims>[0-9,]*)\]#(?P<sid>\d+):(?P<base>\d+)(?P<view>v?)")


def _vals(text: str) -> tuple:
    return tuple(Val(tuple(int(d) for d in m["dims"].split(",") if d), m["dtype"],
                     int(m["sid"]), int(m["base"]), bool(m["view"]))
                 for m in _VAL.finditer(text))


def parse_computations(text: str) -> list:
    """The :class:`Instr` list of a log's text (one computation: the
    eager step; lines that are not ops are skipped)."""
    out = []
    for line in text.splitlines():
        m = _LINE.match(line)
        if m:
            out.append(Instr(m["name"], m["op"], m["kind"], _vals(m["ins"]), _vals(m["outs"]),
                             m["site"]))
    return out


# ---------------------------------------------------------------------------
# Analysis


def instr_flops(i: Instr) -> int:
    """FLOPs of one op (0 but for contractions, convolutions, the scan and
    its gradient)."""
    p = i.packet
    if p in _CONTRACT_OPS:
        return 2 * math.prod(i.results[0].shape) * i.operands[_CONTRACT_OPS[p]].shape[-1]
    if p == "aten.convolution":
        return 2 * math.prod(i.results[0].shape) * math.prod(i.operands[1].shape[1:])
    if p in (SCAN_OP, SCAN_BWD_OP):
        bz, s, d = i.operands[0].shape
        return 2 * bz * s * d * i.operands[2].shape[-1]
    return 0


def instr_bytes(i: Instr) -> int:
    """HBM bytes of one op under the rules of the module docstring."""
    p = i.packet
    if i.kind == "view" or p in _VIEW_OPS or p in _EMPTY_OPS:
        return 0
    if p in _FILL_OPS:
        return sum(val_bytes(v) for v in i.results)
    if p in _UPDATE_OPS:
        return 2 * val_bytes(i.operands[-1])
    if p in _SLICE_READ_OPS:
        return 2 * sum(val_bytes(v) for v in i.results)
    return sum(map(_read_bytes, i.operands)) + sum(val_bytes(v) for v in i.results)


@dataclasses.dataclass
class Analysis:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_counts: dict = dataclasses.field(default_factory=dict)
    unknown_trip_whiles: int = 0


def _instrs(log: Union[str, list]) -> list:
    return parse_computations(log) if isinstance(log, str) else log


def analyze_hlo(log: Union[str, list]) -> Analysis:
    """FLOPs and HBM bytes of an op log (its text or its :class:`Instr`
    list); no collectives, and no loop of unknown trip count (an eager
    log is unrolled)."""
    instrs = _instrs(log)
    return Analysis(flops=float(sum(map(instr_flops, instrs))),
                    hbm_bytes=float(sum(map(instr_bytes, instrs))))


def top_contributors(log: Union[str, list], n: int = 12) -> list:
    """Ranked (bytes, op, site, shape) HBM-traffic contributors, under the
    charging rules of :func:`analyze_hlo`; the shape is the first
    result's."""
    contrib: dict = {}
    for i in _instrs(log):
        b = instr_bytes(i)
        if b:
            shape = _val_text(i.results[0]).split("#")[0] if i.results else ""
            key = (i.op, i.site, shape)
            contrib[key] = contrib.get(key, 0) + b
    ranked = sorted(contrib.items(), key=lambda kv: -kv[1])[:n]
    return [{"bytes": v, "op": k[0], "site": k[1], "shape": k[2]} for k, v in ranked]


def op_counts(log: Union[str, list]) -> dict:
    """How many times each overload appears in the log."""
    counts: dict = {}
    for i in _instrs(log):
        counts[i.op] = counts.get(i.op, 0) + 1
    return counts


def record(fn, *args, device=None):
    """Run ``fn(*args)`` under an :class:`OpRecorder` inside a
    ``FlopCounterMode``. Returns (output, recorder, the counter's total
    FLOPs)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter, rec = FlopCounterMode(display=False), OpRecorder(device)
    with counter, rec:
        out = fn(*args)
    return out, rec, counter.get_total_flops()
