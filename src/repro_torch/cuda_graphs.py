"""One capture sequence for every CUDA graph of the port.

The port's counterparts of the reference's ``jax.jit`` closures (the
plan's forward, ``core/dhm/engine.py`` ``JittedForward``; the LM decode
step, ``launch/steps.py`` ``JittedDecode``; the CNN train step,
``paper/train_cnn.py`` ``JittedTrainStep``) record their kernels into a
``torch.cuda.CUDAGraph`` with :func:`capture`:

1. ``fn()`` runs once eagerly on a side stream that has waited for the
   caller's: the warm-up builds the kernels, sets their shared memory and
   allocates the library workspaces outside the capture. Its launches are
   real and counted, and its output is returned. It runs under the lock
   of step 3: the side stream comes from PyTorch's pool and may be one
   that another thread is capturing on.
2. Python's garbage collector is off until the capture has ended: a
   graph freed by a collection on the capturing thread (a plan and its
   cached closures form a reference cycle) tears down inside the capture
   and voids it.
3. Under one process-wide lock (PyTorch captures one graph at a time;
   a router's engines capture from their own threads), with a fresh
   ``kernels/probe.py`` log open, ``fn()`` is captured in
   ``thread_local`` mode into a private memory pool; the launches the
   wrappers logged are taken back from the counts (``probe.uncount``),
   since a capture launches nothing. The launches and the pipeline's edge
   transfers the log holds are what each replay logs again
   (``probe.replayed``).
4. A capture that raises is ended and the first error raised: nothing
   falls back to the eager ``fn``.

The caller's stream then waits for the side stream.

A captured train step holds a backward. ``torch.autograd.grad`` runs it
on autograd's device thread, each node on the stream of its forward op:
the side stream, under capture, so its kernels are recorded (in
``thread_local`` mode a launch from another thread onto the capturing
stream is captured, and the caching allocator sends its allocations to
the graph's pool by the stream's capture). The stream-conv groups'
backward, a nested ``torch.autograd.grad`` of the recomputed plain
composition under ``kernels/backends.py`` ``backward_numerics``
(PyTorch's own convolution: im2col and cuBLAS), runs there too; the
warm-up allocates that thread's cuBLAS workspace for the side stream.
One warm-up is enough: on an H100 every key of ``chip_smoke.py`` phase
5n captured at its first call and replays bit for bit the eager step.

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

import dataclasses
import gc
import threading
from typing import Callable

import torch

from repro_torch.kernels import probe

CAPTURE_LOCK = threading.RLock()


@dataclasses.dataclass
class Capture:
    """A captured ``fn``: the graph, its static output, the launches one
    replay makes ((kernel name, shared-memory bytes) each), the edge
    transfers it makes ((edge class, (src, dst) stages, buffer shape)
    each) and the warm-up call's own output."""

    graph: object  # torch.cuda.CUDAGraph
    out: object
    launches: tuple
    transfers: tuple
    warm: object


def capture(fn: Callable, device, side) -> Capture:
    """Warm ``fn`` up on the stream ``side`` and capture it there (the
    module's sequence). ``fn`` takes no argument: it reads and writes
    static buffers the caller owns."""
    caller = torch.cuda.current_stream(device)
    side.wait_stream(caller)
    with CAPTURE_LOCK:
        with torch.cuda.stream(side):
            warm = fn()  # the warm-up: real launches, counted
        graph = torch.cuda.CUDAGraph()
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.stream(side), probe.recording() as log:
                graph.capture_begin(pool=torch.cuda.graph_pool_handle(),
                                    capture_error_mode="thread_local")
                try:
                    out = fn()
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
    return Capture(graph=graph, out=out, warm=warm,
                   launches=tuple((name, smem) for _, name, smem in log.launches),
                   transfers=tuple(log.transfers))
