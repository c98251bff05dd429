"""One capture sequence for every CUDA graph of the port.

The port's counterparts of the reference's ``jax.jit`` closures (the
plan's forward, ``core/dhm/engine.py`` ``JittedForward``; the LM decode
step, ``launch/steps.py`` ``JittedDecode``; the LM and the CNN train
steps, :class:`JittedTrainStep` here, which ``launch/steps.py`` and
``paper/train_cnn.py`` ``jit_train_step`` build) record their kernels
into a ``torch.cuda.CUDAGraph`` with :func:`capture`:

1. ``fn()`` runs once eagerly on a side stream that has waited for the
   caller's: the warm-up builds the kernels, sets their shared memory and
   allocates the library workspaces outside the capture. Its launches are
   real and counted, and its output is returned. It runs under the lock
   of step 3: the side stream comes from PyTorch's pool and may be one
   that another thread is capturing on.
2. Where the caller asks (``release``: the train steps), as
   ``torch.cuda.graph`` does, the card is synchronized, Python's garbage
   collected and the allocator's cached blocks given back
   (``torch.cuda.empty_cache``): a capture allocates from its private
   pool alone and can neither use nor free the blocks the default pool
   caches, so a train step's warm-up (a falcon-mamba step leaves
   gigabytes cached) would otherwise leave the capture no room and it
   would run out of memory. A serving graph's warm-up caches its
   activations only, and the release would lengthen each new key's
   first call (a falcon-mamba decode key's on an H100, ``chip_smoke.py``
   phase 6 measures it), so the serving graphs do not ask. Then
   the collector is off until the capture has ended: a graph freed by a
   collection on the capturing thread (a plan and its cached closures
   form a reference cycle) tears down inside the capture and voids it.
3. Under one process-wide lock (PyTorch captures one graph at a time;
   a router's engines capture from their own threads), with a fresh
   ``kernels/probe.py`` log open on the calling thread and registered for
   the side stream (``probe.capturing``: a launch onto that stream from
   any thread lands in it), ``fn()`` is captured in ``thread_local`` mode
   into a private memory pool; the launches the wrappers logged are taken
   back from the counts (``probe.uncount``), since a capture launches
   nothing. The launches and the pipeline's edge transfers the log holds
   are what each replay logs again (``probe.replayed``).
4. A capture that raises is ended and the first error raised: nothing
   falls back to the eager ``fn``.

The caller's stream then waits for the side stream.

Each capture is given an id and leaves one :class:`GraphRecord` in the
registry (:func:`graphs`), which nothing on a call's path reads: its
owner and key, the host seconds of the warm-up, the release, the capture
and (written by the owner, :func:`first_call_done`) the key's whole first
call, and, for a capture that names its owner (the plan's graph and the
train step's), the graph's **phase table**. That capture's log counts the
device operations (kernel, memcpy and memset nodes) its graph holds,
through the CUDA driver (:class:`_GraphNodes`), whenever a
``kernels/probe.py`` span opens or closes inside it; the table cuts the
graph's operations, which one stream runs in capture order, by those
marks (``probe.phase_table``), and the record keeps each operation's
name as the profiler's device trace names it. A reader of a profiled
replay charges its operations, in order, to the phases. The whole of
it runs during the capture, never at a replay.

A captured train step holds a backward. ``torch.autograd.grad`` runs it
on autograd's device thread, each node on the stream of its forward op:
the side stream, under capture, so its kernels are recorded (in
``thread_local`` mode a launch from another thread onto the capturing
stream is captured, and the caching allocator sends its allocations to
the graph's pool by the stream's capture). The stream-conv groups'
backward kernels (``kernels/stream_conv/ops.py`` ``_GroupGrad``: a
recompute, dx and dW of each layer and one reduction, all on the card
and with no float atomics) run there too, as does the head's cuBLAS
backward; the warm-up allocates that thread's cuBLAS workspace for the
side stream. One warm-up is enough: on an H100 every key of
``chip_smoke.py`` phase 5n captured at its first call and replays bit
for bit the eager step. A hand-written kernel launched on that thread
(the stream-conv backward, the scan of a remat recompute,
``torch.utils.checkpoint`` unpacking a saved tensor inside the
backward) is logged by its stream, the side stream's, and the
stream-conv backward in its forward caller's log too (``probe.attached``,
the capture's own): it is uncounted and replayed like the forward's.

PyTorch hands out the streams of its pool in turn, so a stream under
capture may be one that other code uses too (a mesh's slot streams are
shared by every runner built on the mesh). Eager work that the port
enqueues on such a stream holds :data:`CAPTURE_LOCK`, so no capture
records it: the warm-up here, the pipeline runner
(``core/dhm/pipeline.py``) and the loader's copies onto slot streams
(``data/loader.py``). The lock is re-entrant: a runner captured takes it
again inside the capture.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import gc
import itertools
import threading
import time
from typing import Callable, Optional

import torch

from repro_torch.kernels import probe
from repro_torch.tree_util import tree_flatten, tree_map

CAPTURE_LOCK = threading.RLock()


@dataclasses.dataclass
class GraphRecord:
    """One capture, as plain data. ``phases``: ((span path, operations),
    ...) in capture order (``probe.phase_table``); ``ops``: each device
    operation's name as the profiler's trace gives it ("Memcpy" and
    "Memset" for the copies and fills, a kernel's demangled name, "" where
    libcuda gave none); both empty for a capture that names no owner or
    where libcuda could not be read (``unread`` then names the libcuda
    call that failed). Host seconds: the warm-up, the release (0 where
    not asked), the capture, and the key's whole first call (0 until its
    owner ends it). ``launch_table``: what the owner says one replay
    launches (the plan's graph: its ``compiler.CardLaunch`` per conv
    fusion group), () where it says nothing."""

    id: int
    owner: str
    key: str
    phases: tuple
    ops: tuple
    warmup_s: float
    release_s: float
    capture_s: float
    first_call_s: float = 0.0
    unread: str = ""
    launch_table: tuple = ()

    @property
    def n_ops(self) -> int:
        return len(self.ops)


_IDS = itertools.count(1)
_GRAPHS: collections.deque = collections.deque(maxlen=1024)


def graphs() -> list:
    """The registry: the :class:`GraphRecord` of each capture of the
    process (the last 1,024), oldest first."""
    return list(_GRAPHS)


def first_call_done(record: GraphRecord, t_call: float) -> None:
    """Write the host seconds of a key's first call, from ``t_call`` (the
    ``time.perf_counter()`` at its start) to now, into its record."""
    record.first_call_s = time.perf_counter() - t_call


class _KernelParams(ctypes.Structure):
    """libcuda's ``CUDA_KERNEL_NODE_PARAMS_v2``."""

    _fields_ = [("func", ctypes.c_void_p), ("grid", ctypes.c_uint * 3),
                ("block", ctypes.c_uint * 3), ("smem", ctypes.c_uint),
                ("params", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


_P = ctypes.POINTER
_LIBCUDA_CALLS = {  # name -> argument types; each returns a CUresult
    "cuStreamGetCaptureInfo_v2": [ctypes.c_void_p, _P(ctypes.c_int), _P(ctypes.c_uint64),
                                  _P(ctypes.c_void_p), _P(ctypes.c_void_p),
                                  _P(ctypes.c_size_t)],
    "cuGraphGetNodes": [ctypes.c_void_p, _P(ctypes.c_void_p), _P(ctypes.c_size_t)],
    "cuGraphNodeGetType": [ctypes.c_void_p, _P(ctypes.c_int)],
    "cuGraphKernelNodeGetParams_v2": [ctypes.c_void_p, _P(_KernelParams)],
    "cuFuncGetName": [_P(ctypes.c_char_p), ctypes.c_void_p],
    "cuKernelGetName": [_P(ctypes.c_char_p), ctypes.c_void_p],
}


@functools.cache
def _libcuda() -> dict:
    """The CUDA driver API calls this module makes, by name ({} without
    ``libcuda``); a call libcuda lacks is left out."""
    try:
        cu = ctypes.CDLL("libcuda.so.1")
    except OSError:
        return {}
    calls = {}
    for name, args in _LIBCUDA_CALLS.items():
        f = getattr(cu, name, None)
        if f is not None:
            f.argtypes, f.restype = args, ctypes.c_int
            calls[name] = f
    return calls


@functools.cache
def _cxx() -> Optional[tuple]:
    """The C++ runtime's ``__cxa_demangle`` and the C library's ``free``
    (None where either cannot be loaded)."""
    try:
        demangle = ctypes.CDLL("libstdc++.so.6").__cxa_demangle
        free = ctypes.CDLL(None).free
    except (OSError, AttributeError):
        return None
    demangle.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, _P(ctypes.c_int)]
    demangle.restype = ctypes.c_void_p
    free.argtypes, free.restype = [ctypes.c_void_p], None
    return demangle, free


def _demangle(raw: bytes) -> str:
    """``raw`` as the profiler names a kernel: demangled by the C++
    runtime's ``__cxa_demangle`` where it is a mangled name and the
    runtime loads, as it is otherwise."""
    name = raw.decode(errors="replace")
    cxx = _cxx() if raw.startswith(b"_Z") else None
    if cxx is None:
        return name
    demangle, free = cxx
    status = ctypes.c_int()
    out = demangle(raw, None, None, ctypes.byref(status))
    if status.value != 0 or not out:
        return name
    try:
        return ctypes.string_at(out).decode(errors="replace")
    finally:
        free(out)


class _GraphNodes:
    """The device operations a stream's capture graph holds, read through
    the CUDA driver: each call adds the nodes new since the last to
    ``ops``, in the order the capture added them (a chain's order on one
    stream), and returns their count; -1, and nothing read after, once a
    libcuda call the count needs fails (``failed`` says which)."""

    _KERNEL, _MEMCPY, _MEMSET = 0, 1, 2

    def __init__(self, stream: int):
        self.stream = stream
        self.ops: list = []
        self.failed = ""
        self._seen: set = set()

    def _call(self, fn: str, *args) -> bool:
        if not self.failed:
            f = _libcuda().get(fn)
            rc = -1 if f is None else f(*args)
            if rc != 0:
                self.failed = f"{fn}: {'missing' if f is None else f'CUresult {rc}'}"
        return not self.failed

    @staticmethod
    def _kernel_name(node: int) -> str:
        """The kernel's name, "" where libcuda gives none (one older
        than CUDA 12.3 has no ``cuFuncGetName``): only the count needs
        it."""
        cu, p, got = _libcuda(), _KernelParams(), ctypes.c_char_p()
        get = cu.get("cuGraphKernelNodeGetParams_v2")
        if get is None or get(node, ctypes.byref(p)) != 0:
            return ""
        name, handle = ((cu.get("cuFuncGetName"), p.func) if p.func
                        else (cu.get("cuKernelGetName"), p.kern))
        if name is None or not handle or name(ctypes.byref(got), handle) != 0:
            return ""
        return _demangle(got.value) if got.value else ""

    def __call__(self) -> int:
        status, graph, n = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_size_t()
        if not (self._call("cuStreamGetCaptureInfo_v2", self.stream, ctypes.byref(status),
                           None, ctypes.byref(graph), None, None)
                and self._call("cuGraphGetNodes", graph, None, ctypes.byref(n))):
            return -1
        if n.value == 0:
            return len(self.ops)
        nodes, kind = (ctypes.c_void_p * n.value)(), ctypes.c_int()
        if not self._call("cuGraphGetNodes", graph, nodes, ctypes.byref(n)):
            return -1
        for node in nodes[:n.value]:
            if node in self._seen:
                continue
            self._seen.add(node)
            if not self._call("cuGraphNodeGetType", node, ctypes.byref(kind)):
                return -1
            if kind.value == self._KERNEL:
                self.ops.append(self._kernel_name(node))
            elif kind.value == self._MEMCPY:
                self.ops.append("Memcpy")
            elif kind.value == self._MEMSET:
                self.ops.append("Memset")
        return len(self.ops)


@dataclasses.dataclass
class Capture:
    """A captured ``fn``: the graph, its static output, the launches one
    replay makes ((kernel name, shared-memory bytes) each), the edge
    transfers it makes ((edge class, (src, dst) stages, buffer shape)
    each), the warm-up call's own output and the capture's record in the
    registry."""

    graph: object  # torch.cuda.CUDAGraph
    out: object
    launches: tuple
    transfers: tuple
    warm: object
    record: GraphRecord


def capture(fn: Callable, device, side, *, release: bool = False, owner: str = "",
            key=None) -> Capture:
    """Warm ``fn`` up on the stream ``side`` and capture it there (the
    module's sequence; ``release`` its step 2) and record it in the
    registry under ``owner`` and ``key``; only a capture that names its
    owner reads its graph's operations and phases. ``fn`` takes no
    argument: it reads and writes static buffers the caller owns."""
    caller = torch.cuda.current_stream(device)
    side.wait_stream(caller)
    t0 = time.perf_counter()
    with CAPTURE_LOCK:
        with torch.cuda.stream(side):
            warm = fn()  # the warm-up: real launches, counted
        t1 = time.perf_counter()
        if release:
            torch.cuda.synchronize(device)
            gc.collect()
            torch.cuda.empty_cache()
        t2 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        nodes = _GraphNodes(side.cuda_stream) if owner else None
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with (torch.cuda.stream(side), probe.recording() as log,
                  probe.capturing(side.cuda_stream, log, nodes)):
                graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
                    total = nodes() if nodes is not None else -1
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is void already; the first error says why
                    raise
                finally:
                    probe.uncount(log.launches)
                graph.capture_end()
        finally:
            if gc_on:
                gc.enable()
    caller.wait_stream(side)
    t3 = time.perf_counter()
    read = total >= 0 and all(n >= 0 for *_, n in log.marks)
    record = GraphRecord(
        id=next(_IDS), owner=owner, key=repr(key),
        phases=probe.phase_table(log.marks, total) if read else (),
        ops=tuple(nodes.ops) if read else (),
        unread=nodes.failed if nodes is not None else "",
        warmup_s=t1 - t0, release_s=t2 - t1, capture_s=t3 - t2)
    _GRAPHS.append(record)
    return Capture(graph=graph, out=out, warm=warm,
                   launches=tuple((name, smem) for _, name, smem in log.launches),
                   transfers=tuple(log.transfers), record=record)


def copy_leaves(dsts: list, srcs: list) -> None:
    """``dst.copy_(src)`` for each pair, as one multi-tensor copy per
    dtype: how a graph's caller stages its trees into the static ones."""
    groups: dict = {}
    for d, s in zip(dsts, srcs):
        pair = groups.setdefault(d.dtype, ([], []))
        pair[0].append(d)
        pair[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def clone_leaves(leaves: list) -> list:
    """New tensors with ``leaves``' values (multi-tensor copies): a
    replay's static outputs handed to the caller."""
    out = [torch.empty_like(t) for t in leaves]
    copy_leaves(out, leaves)
    return out


@dataclasses.dataclass
class _TrainGraph:
    """One key of a :class:`JittedTrainStep`: its static params, optimizer
    state, batch and 0-d int32 step, the static leaves of the params and
    state (``leaves``) and of the batch, the output trees' structures the
    step gave, and on the card the graph, its static outputs (the metrics'
    leaves, and without donation the new params' and state's first), the
    launches one replay makes ((name, shared-memory bytes) each) and the
    event after the last call's output copies."""

    params: object
    opt_state: object
    batch: object
    step: torch.Tensor
    leaves: list
    batch_leaves: list
    defs: tuple = ()  # (params, opt_state, metrics) tree structures of the step's output
    graph: Optional[object] = None  # torch.cuda.CUDAGraph
    out: list = dataclasses.field(default_factory=list)
    launches: tuple = ()
    done: Optional[object] = None  # torch.cuda.Event


class JittedTrainStep:
    """``step(params, opt_state, batch, step=0) -> (params, opt_state,
    metrics)``, a train step as one captured executable per (batch,
    trees): the counterpart of ``jax.jit`` of a train step, with the
    parameters and optimizer state donated (``donate=True``, the
    reference's ``donate_argnums=(0, 1)``, ``launch/steps.py``
    ``jit_train_step``) or not (the LM examples' bare ``jax.jit``; the
    CNN's, ``paper/train_cnn.py`` ``jit_train_step``).

    ``fn(params, opt_state, batch, step)`` is the eager step on tensor
    trees: ``batch`` a tree of tensors (a dict), ``step`` a 0-d int32
    tensor on the params' device, which ``fn`` may ignore or turn into a
    learning rate on the device (``sched(step)``). ``eager`` is the step
    a caller traces in place of the graph (the dry run, ``launch/dryrun.py``
    ``cell_step``); ``fn`` unless given.

    The key is the device and the structures, shapes and dtypes of the
    params, the optimizer state (an ``OptState``, its ``master`` tree
    included) and the batch. Each key holds static params, state, batch
    (on the params' device) and step. Every call copies the caller's trees
    and batch in (one multi-tensor copy per dtype; ``staged`` counts the
    param and state leaves copied) and sets the step, a host int by a
    device-side ``fill_``, a tensor by a device copy: it is never read on
    the host.

    On the card, the first call of a key runs the step once eagerly on a
    side stream (that call's result), then captures it (:func:`capture`,
    the allocator's cache released after the warm-up):
    the forward, ``torch.autograd.grad`` (the backward runs on autograd's
    device thread on the capture's stream, a remat recompute's scan
    kernel with it, logged by its stream, ``kernels/probe.py``), clipping
    and AdamW. Every later call replays the graph. The kernels run in the
    same order on the same shapes as the eager ``fn``, so the results are
    its bit for bit where ``fn``'s own ops are reproducible. A capture
    that fails raises: nothing falls back to the eager step. A replay runs
    no wrapper, so the launches the capture logged are counted again at
    each replay. ``captures`` and ``replays`` count both. A key's first
    call leaves its seconds in the capture's record (:func:`graphs`).

    Metrics are always new tensors. With ``donate=True`` the graph ends by
    writing the new params and state over the static ones (one
    multi-tensor copy per dtype inside the graph; the step must return
    trees of the shapes it was given), and every call returns the key's
    static params and state trees, valid until the next call. A caller
    that hands those trees back gets a replay with no copy of them; any
    other tree is copied in and left as it was. With ``donate=False`` the
    params and state come back as new tensors too, so the caller's trees
    are never written and the trees a call returns stay valid after later
    calls (``ResilientTrainer`` restarts from the state it was given).

    On the CPU and on ``meta``, each call is the eager ``fn`` on the same
    static buffers (same surface; ``_cache_size()`` counts the keys run).

    The static buffers are shared: ``lock`` (reentrant) is held around
    staging, the step and the output copies.
    """

    def __init__(self, fn, *, donate: bool, eager=None):
        self.fn, self.donate = fn, donate
        self.eager = fn if eager is None else eager
        self.lock = threading.RLock()
        self.staged = self.captures = self.replays = 0
        self._graphs: dict = {}  # key -> _TrainGraph
        self._stream = None  # the side stream of warm-ups and captures

    def _cache_size(self) -> int:
        """The keys captured (on the CPU: run) so far."""
        return len(self._graphs)

    def _run(self, entry: _TrainGraph) -> list:
        """The step on ``entry``'s static inputs: the metrics' leaves,
        after the new params' and state's unless they are donated, in which
        case they are written over the static ones."""
        params, opt_state, metrics = self.fn(entry.params, entry.opt_state, entry.batch,
                                             entry.step)
        p_leaves, p_def = tree_flatten(params)
        s_leaves, s_def = tree_flatten(opt_state)
        m_leaves, m_def = tree_flatten(metrics)
        entry.defs = (p_def, s_def, m_def)
        new = p_leaves + s_leaves
        if not self.donate:
            return new + m_leaves
        if ((p_def, s_def) != (tree_flatten(entry.params)[1], tree_flatten(entry.opt_state)[1])
                or [(t.shape, t.dtype) for t in new] != [(t.shape, t.dtype) for t in entry.leaves]):
            raise ValueError("a donated train step must return params and optimizer state of "
                             "the structures, shapes and dtypes it was given")
        copy_leaves(entry.leaves, new)
        return m_leaves

    def __call__(self, params, opt_state, batch, step=0):
        t_call = time.perf_counter()
        with self.lock, torch.inference_mode(False), torch.enable_grad():
            p_leaves, p_def = tree_flatten(params)
            s_leaves, s_def = tree_flatten(opt_state)
            b_leaves, b_def = tree_flatten(batch)
            dev = p_leaves[0].device
            key = (dev, p_def, s_def, b_def,
                   tuple((tuple(t.shape), t.dtype) for t in p_leaves + s_leaves + b_leaves))
            on_card = dev.type == "cuda"
            entry = self._graphs.get(key)
            fresh = entry is None
            if fresh:
                static_p = tree_map(torch.empty_like, params)
                static_s = tree_map(torch.empty_like, opt_state)
                static_b = tree_map(
                    lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev), batch)
                entry = _TrainGraph(
                    params=static_p, opt_state=static_s, batch=static_b,
                    step=torch.zeros((), dtype=torch.int32, device=dev),
                    leaves=tree_flatten(static_p)[0] + tree_flatten(static_s)[0],
                    batch_leaves=tree_flatten(static_b)[0])
            stream = torch.cuda.current_stream(dev) if on_card else None
            if entry.done is not None:
                stream.wait_event(entry.done)
            pairs = [(d, s_) for d, s_ in zip(entry.leaves, p_leaves + s_leaves)
                     if not (self.donate and d is s_)]
            self.staged += len(pairs)
            copy_leaves([d for d, _ in pairs] + entry.batch_leaves,
                        [s_ for _, s_ in pairs] + b_leaves)
            if isinstance(step, torch.Tensor):
                entry.step.copy_(step.reshape(()))
            else:
                entry.step.fill_(int(step))

            record = None
            if not on_card:
                outs = self._run(entry)
            elif entry.graph is None:
                if self._stream is None:
                    self._stream = torch.cuda.Stream(dev)
                cap = capture(lambda: self._run(entry), dev, self._stream, release=True,
                              owner="JittedTrainStep",
                              key=tuple((tuple(t.shape), t.dtype) for t in b_leaves))
                entry.graph, entry.out, entry.launches = cap.graph, cap.out, cap.launches
                record = cap.record
                self.captures += 1
                outs = cap.warm
                for t in outs:
                    t.record_stream(stream)
            else:
                entry.graph.replay()
                probe.replayed(entry.launches)
                self.replays += 1
                outs = clone_leaves(entry.out)
            if fresh:
                self._graphs[key] = entry
            if on_card:
                if entry.done is None:
                    entry.done = torch.cuda.Event()
                entry.done.record(stream)
            if record is not None:
                first_call_done(record, t_call)
            out_p, out_s, out_m = entry.defs
            if self.donate:
                return entry.params, entry.opt_state, out_m.unflatten(outs)
            n_p, n_s = out_p.num_leaves, out_s.num_leaves
            return (out_p.unflatten(outs[:n_p]), out_s.unflatten(outs[n_p:n_p + n_s]),
                    out_m.unflatten(outs[n_p + n_s:]))
