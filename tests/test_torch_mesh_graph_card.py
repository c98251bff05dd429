"""The Engine's ``mesh`` rung on the card: one CUDA graph of the pipelined
stage bodies, their edge hand-offs and the head (``engine._mesh_forward``).

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit (the kernels are built with nvcc at first
use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_mesh_graph_card.py

This file imports no JAX: the machine with the card has none.

A replay runs the kernels the eager runner runs, on the same shapes and
buffers, and no stream-conv or pow2 kernel sums with atomics, so every
replay is held bit for bit to the eager closure (``JittedForward.fn``:
the runner plus the head) and to the plan on the whole group (each
frame's conv features are computed on their own, and the head sees the
same shape). Covered on cifar10's 3-stage plans, fp32 and plan (b)
(int8 convs, the integer pow2 head): exact and boxed edges, serial and
overlapped, and a (3, 2) (stage, data) mesh; a replay's launches and
transfers; the donated buffer; the graph's pool over 100 replays; eager
runs on the same mesh from other threads during the capture, drawing
streams through the whole of PyTorch's pool, and a loader's copies onto
the mesh's slot streams (each waits for the capture on its lock); the
collector guard; a capture that fails; the verifier's pipeline scope on
the graph.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402
import gc  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.analysis.invariants import planned_launches  # noqa: E402
from repro_torch.analysis.verify import (  # noqa: E402
    PipelineProbe,
    _OpLog,
    make_pipeline_probe,
    verify_plan,
)
from repro_torch.core.dhm import Engine, QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.engine import (  # noqa: E402
    JittedForward,
    _mesh_forward,
    build_plan_pipeline,
    forward,
)
from repro_torch.core.dhm.pipeline import PipelineConfig  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import quantize_stream, stream_quant_spec  # noqa: E402
from repro_torch.data.loader import _shard  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

pytestmark = pytest.mark.card

TOPO = ALL_TOPOLOGIES["cifar10"]
KINDS = {
    "fp32": QuantSpec(),
    "b": QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8)),
}
S, M, MB = 3, 4, 16
# (edge mode, overlap, data columns)
LAYOUTS = {
    "exact": ("exact", False, 1),
    "exact_overlap": ("exact", True, 1),
    "boxed": ("boxed", False, 1),
    "boxed_overlap": ("boxed", True, 1),
    "stage3_data2": ("auto", False, 2),
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _plan(kind, card, seed=0):
    params = init_cnn(torch.Generator().manual_seed(seed), TOPO, device=card)
    return compile_dhm(TOPO, params, quant=KINDS[kind], n_stages=S, device=card)


def _mesh(data=1):
    if data > 1:
        return make_mesh((S, data), ("stage", "data"))
    return make_mesh((S,), ("stage",))


def _rung(plan, layout="exact", donate=False, mb=MB):
    """The mesh rung's (runner, JittedForward) as the Engine builds it."""
    edge_mode, overlap, data = LAYOUTS[layout]
    cfg = PipelineConfig(S, M, data_axis="data" if data > 1 else None, overlap=overlap,
                         edge_mode=edge_mode)
    return _mesh_forward(plan, _mesh(data), cfg, mb * data, donate=donate)


def _frames(n, seed, card=None, grid=False):
    h, w = TOPO.input_shape
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, h, w, TOPO.input_channels)).astype(np.float32))
    if grid:
        x = quantize_stream(x, 8).to(torch.float32) * stream_quant_spec(8).scale
    return x if card is None else x.to(card)


def _eager(fn, x):
    with torch.no_grad():
        return fn(x)


def _counts():
    return {**kconv.LAUNCHES, **kpow2.LAUNCHES}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_replays_equal_the_eager_runner_plus_head_and_the_plan(card, kind, layout):
    plan = _plan(kind, card)
    _, fwd = _rung(plan, layout)
    assert isinstance(fwd, JittedForward) and fwd.on_card
    group = M * MB * LAYOUTS[layout][2]
    for seed in (1, 2, 3):  # the capture's call, then replays alone
        x = _frames(group, seed, card, grid=kind == "b")
        kept = x.clone()
        got = fwd(x)
        torch.cuda.synchronize()
        assert torch.equal(got, _eager(fwd.fn, x)), (kind, layout, seed)
        assert torch.equal(got, _eager(lambda xb: forward(plan, xb), x)), (kind, layout, seed)
        assert torch.equal(x, kept)
    assert fwd._cache_size() == 1


@pytest.mark.parametrize("layout", ["exact_overlap", "stage3_data2"])
def test_a_replay_counts_the_captures_launches_and_logs_its_transfers(card, layout):
    plan = _plan("b", card)
    _, fwd = _rung(plan, layout)
    d = LAYOUTS[layout][2]
    x = _frames(M * MB * d, 4, card, grid=True)
    before = _counts()
    with probe.recording() as eager_log:
        _eager(fwd.fn, x)
    torch.cuda.synchronize()
    eager = _delta(before)
    assert sum(n for k, n in eager.items() if k.startswith("stream_conv")) == \
        d * M * planned_launches(plan)
    assert eager.get("pow2_matmul_int", 0) > 0
    before = _counts()
    fwd(x)  # warm-up (real launches) + capture (none) + replay
    torch.cuda.synchronize()
    assert _delta(before) == {k: 2 * v for k, v in eager.items()}
    for _ in range(2):
        before = _counts()
        with probe.recording() as log:
            fwd(x)
        torch.cuda.synchronize()
        assert _delta(before) == eager
        assert sorted(n for _, n, _ in log.launches) == sorted(n for _, n, _ in eager_log.launches)
        assert log.transfers == eager_log.transfers
        assert len(log.transfers) == (S - 1) * M * d


def test_a_donated_buffer_is_replayed_with_no_device_copy(card):
    plan = _plan("b", card)
    _, fwd = _rung(plan, donate=True)
    x = _frames(M * MB, 5, card, grid=True)
    want = _eager(fwd.fn, x)
    for _ in range(2):  # the capture, then a replay alone
        with fwd.lock:
            buf = fwd.input_buffer(tuple(x.shape))
            buf.copy_(x)
            with probe.recording() as log, _OpLog(log) as ops:
                got = fwd(buf)
        assert [op.name for op in ops.ops if op.name == "aten::copy_"] == []
        assert torch.equal(got, want)
    eng = Engine(plan, mesh=_mesh(), microbatch=MB, n_microbatches=M, donate=True)
    assert isinstance(eng._fwd, JittedForward) and eng._fwd.donate
    with eng._fwd.lock:
        staged = eng._stage(x.cpu().numpy(), eng._fwd)
        assert staged is eng._fwd.input_buffer(tuple(x.shape))
    assert torch.equal(eng.infer(x.cpu().numpy()), want.cpu())
    assert eng._fwd._cache_size() == 1


def test_the_graphs_pool_is_flat_over_100_replays(card):
    plan = _plan("fp32", card)
    _, fwd = _rung(plan, "boxed_overlap")
    x = _frames(M * MB, 6, card)
    fwd(x)
    torch.cuda.synchronize()
    allocated, reserved = torch.cuda.memory_allocated(card), torch.cuda.memory_reserved(card)
    for _ in range(100):
        out = fwd(x)
        del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) == allocated
    assert torch.cuda.memory_reserved(card) <= reserved


def _hooked_in_capture(fn, hook):
    """``fn`` with ``hook()`` run first when it is called under a capture."""

    def hooked(*args):
        if torch.cuda.is_current_stream_capturing():
            hook()
        return fn(*args)

    return hooked


def test_an_eager_run_on_the_same_mesh_from_another_thread_during_the_capture(card,
                                                                              monkeypatch):
    """While the Engine's mesh rung is being captured, 24 threads each build
    an overlapped runner on the rung's own mesh and run it eagerly. Their
    builds draw 48 copy streams, more than PyTorch's pool holds (32 a
    device, handed out in turn), so among them the rung's slot streams and
    its capture stream; their runs then wait on the capture lock until the
    capture has ended. Nothing of theirs is recorded into the graph: each
    answer, theirs and the Engine's, is bit for bit the plan's."""
    plan = _plan("fp32", card)
    mesh = _mesh()
    mbs = _frames(M * MB, 7, card).reshape((M, MB) + tuple(_frames(1, 0).shape[1:]))
    with torch.no_grad():
        want_feats = plan.features(mbs.reshape((M * MB,) + tuple(mbs.shape[2:])))
    n_threads = 24
    traffic_ids, drawn, outs, errors = set(), [], [], []
    in_capture, built = threading.Event(), threading.Semaphore(0)
    seen = {}
    real = torch.cuda.Stream

    class Drawn(real):
        def __new__(cls, *args, **kwargs):
            stream = real.__new__(cls, *args, **kwargs)
            if "stream_id" not in kwargs and threading.get_ident() in traffic_ids:
                drawn.append(stream.cuda_stream)
            return stream

    def traffic():
        traffic_ids.add(threading.get_ident())
        try:
            assert in_capture.wait(120.0)
            with torch.cuda.device(card), torch.no_grad():
                runner = build_plan_pipeline(plan, mesh=mesh, cfg=PipelineConfig(
                    S, M, overlap=True), microbatch=MB)
                built.release()
                outs.append(runner(mbs).reshape(want_feats.shape).cpu())
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)
            built.release()

    def during_capture():
        in_capture.set()
        seen["built"] = sum(built.acquire(timeout=120.0) for _ in range(n_threads))
        time.sleep(0.5)  # the runs now wait at the capture lock
        seen["done"] = len(outs)

    monkeypatch.setattr(torch.cuda, "Stream", Drawn)
    hooked = dataclasses.replace(plan, head_fn=_hooked_in_capture(plan.head_fn, during_capture))
    threads = [threading.Thread(target=traffic) for _ in range(n_threads)]
    for t in threads:
        t.start()
    try:
        eng = Engine(hooked, mesh=mesh, microbatch=MB, n_microbatches=M, overlap=True)
    finally:
        in_capture.set()
        for t in threads:
            t.join(120.0)
    assert errors == [] and len(outs) == n_threads
    assert seen == {"built": n_threads, "done": 0}
    assert len(drawn) == n_threads * (S - 1)
    rung_streams = {sl.stream.cuda_stream for sl in mesh.slots} | {eng._fwd._stream.cuda_stream}
    assert rung_streams <= set(drawn)
    assert eng.rung == "mesh" and eng.demotions == []
    for seed in (8, 9):
        x = _frames(M * MB, seed)
        got = eng.infer(x.numpy())
        assert torch.equal(got, _eager(lambda xb: forward(plan, xb), x.to(card)).cpu())
    assert eng._fwd._cache_size() == 1
    for out in outs:
        assert torch.equal(out, want_feats.cpu())


def test_a_loaders_copy_onto_a_slot_stream_waits_for_the_capture(card):
    """A loader's copy onto the slot streams of the mesh the rung is being
    captured on, started from another thread during the capture, waits on
    the capture lock: it lands in the loader's tensors, not in the graph."""
    plan = _plan("b", card)
    mesh = _mesh()
    array = np.random.default_rng(3).normal(size=(8, 5)).astype(np.float32)
    pieces, seen = [], {}

    def load():
        pieces.extend(_shard(array, mesh))

    def during_capture():
        t = threading.Thread(target=load)
        t.start()
        t.join(0.5)
        seen["loaded"] = len(pieces)
        seen["thread"] = t

    _, fwd = _mesh_forward(plan, mesh, PipelineConfig(S, M), MB)
    captured = JittedForward(_hooked_in_capture(fwd.fn, during_capture), card)
    x = _frames(M * MB, 4, card, grid=True)
    got = captured(x)
    seen["thread"].join(60.0)
    torch.cuda.synchronize()
    assert seen["loaded"] == 0 and len(pieces) == mesh.size
    for piece in pieces:
        assert torch.equal(piece.cpu(), torch.from_numpy(array))
    want = _eager(fwd.fn, x)
    assert torch.equal(got, want) and torch.equal(captured(x), want)


def test_a_collection_inside_the_mesh_capture_voids_nothing(card):
    """A graph that becomes garbage while the mesh rung is captured, under
    ``gc.set_threshold(1)``: without the collector guard of the capture
    sequence the capture fails (the capture was invalidated)."""
    plan = _plan("b", card, seed=1)
    old = _plan("fp32", card, seed=3)
    parked = [JittedForward(lambda xb: forward(old, xb), card)]
    parked[0](_frames(8, 9, card))
    _, rung = _rung(plan, "exact_overlap")
    calls = [0]

    def fn(xb):
        calls[0] += 1
        if calls[0] == 2 and parked:  # the capture: the first call is the warm-up
            cycle = [parked.pop()]
            cycle.append(cycle)
        return rung.fn(xb)

    fwd = JittedForward(fn, card)
    x = _frames(M * MB, 2, card, grid=True)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        got, again = fwd(x), fwd(x)
    finally:
        gc.set_threshold(*thresholds)
    want = _eager(rung.fn, x)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert fwd._cache_size() == 1 and calls[0] == 2


def test_a_failed_capture_demotes_with_cudas_message_and_nothing_runs_eagerly(card):
    """A stage body that reads the host at the mesh rung's µbatch size runs
    eagerly but cannot be captured: the mesh rung's warmup fails with the
    capture's error recorded, the fused rung (the whole group, no host
    read) serves, and the mesh closure never runs again."""
    plan = _plan("fp32", card)
    st = plan.stages[0]
    at_mb = [0]

    def reads_host(params, x, _f=st.fn):
        if x.shape[0] == MB:
            at_mb[0] += 1
            float(x.sum())
        return _f(params, x)

    bad = dataclasses.replace(plan, stages=(dataclasses.replace(st, fn=reads_host),)
                              + tuple(plan.stages[1:]))
    eng = Engine(bad, mesh=_mesh(), microbatch=MB, n_microbatches=M)
    assert eng.rung == "fused" and [d["rung"] for d in eng.demotions] == ["mesh"]
    assert "captur" in eng.demotions[0]["reason"].lower()
    assert at_mb[0] == M + 1  # the warm-up's M µbatches, then the capture's first
    for seed in (10, 11, 12):
        x = _frames(M * MB, seed)
        assert torch.equal(eng.infer(x.numpy()), _eager(lambda xb: forward(plan, xb),
                                                        x.to(card)).cpu())
    assert at_mb[0] == M + 1 and eng.rung == "fused"


@pytest.mark.parametrize("edge_mode", ["exact", "boxed"])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_the_pipeline_scope_on_the_graphs_probe_finds_what_it_finds_eagerly(card, kind,
                                                                            edge_mode):
    plan = _plan(kind, card)
    graph = make_pipeline_probe(plan, n_microbatches=M, microbatch=MB, edge_mode=edge_mode)
    runner, fwd = _rung(plan, "exact" if edge_mode == "exact" else "boxed")
    with probe.recording() as log:
        _eager(fwd.fn, torch.zeros((M * MB,) + tuple(_frames(1, 0).shape[1:]), device=card))
    torch.cuda.synchronize()
    eager = PipelineProbe(transfers=list(log.transfers), launches=list(log.launches),
                          edge_plan=runner.edge_plan, cfg=graph.cfg, mb_local=MB)
    assert graph.transfers == eager.transfers and len(graph.transfers) == (S - 1) * M
    assert sorted(graph.launches) == sorted(eager.launches)
    got = verify_plan(plan, scopes=("pipeline",), pipeline=graph)
    want = verify_plan(plan, scopes=("pipeline",), pipeline=eager)
    assert [f.render() for f in got] == [f.render() for f in want]
    assert [(f.rule, f.severity) for f in got] == (
        [("V103", "warning")] if edge_mode == "boxed" else [])
