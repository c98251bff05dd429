"""The spatial pipeline on the card: the stages of a DHM plan on their own
streams of one H100, held against the same plan run in sequence.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit (the kernels are built with nvcc at first
use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_pipeline_card.py

This file imports no JAX: the machine with the card has none.

Each frame's conv features are computed on their own by the kernels (a
CTA per row block and image), so the pipelined features are held bit for
bit against ``plan.features`` on the whole batch, and the Engine's answers
against a direct call of the plan on the frames padded to the group, as
the engine pads them (the same shapes, so the same GEMMs).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.analysis.verify import make_pipeline_probe, verify_plan  # noqa: E402
from repro_torch.analysis.invariants import planned_launches  # noqa: E402
from repro_torch.core.dhm import (  # noqa: E402
    DeviceLoss,
    Engine,
    FaultPlan,
    QuantSpec,
    StalledDispatch,
    compile_dhm,
)
from repro_torch.core.dhm import pipeline as tpipeline  # noqa: E402
from repro_torch.core.dhm.pipeline import PipelineConfig, join_watchdogs  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import quantize_stream, stream_quant_spec  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

pytestmark = pytest.mark.card

TOPO = ALL_TOPOLOGIES["cifar10"]
Q_INT8 = QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8))
M, MB = 4, 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _plans(card):
    p = init_cnn(torch.Generator().manual_seed(0), TOPO, device=card)
    return {"fp32": compile_dhm(TOPO, p, n_stages=3), "int8": compile_dhm(TOPO, p, quant=Q_INT8,
                                                                       n_stages=3)}


def _mbs(card, m=M, mb=MB, seed=1, grid=False):
    h, w = TOPO.input_shape
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(m, mb, h, w, TOPO.input_channels)).astype(np.float32)).to(card)
    if grid:
        x = quantize_stream(x, 8).to(torch.float32) * stream_quant_spec(8).scale
    return x


def test_pipelined_equals_sequential_on_the_cards_streams(card):
    mesh = make_mesh((3,), ("stage",))
    assert len({sl.stream.cuda_stream for sl in mesh.slots}) == 3
    assert {str(d) for d in mesh.devices} == {"cuda:0"}
    mesh2 = make_mesh((3, 2), ("stage", "data"))
    for quant, plan in _plans(card).items():
        assert len(plan.fusion_groups) == 3
        mbs = _mbs(card, grid=quant == "int8")
        with torch.inference_mode():
            want = plan.features(mbs.reshape((M * MB,) + tuple(mbs.shape[2:])))
            want = want.reshape((M, MB) + tuple(want.shape[1:]))
            per_call = planned_launches(plan)
            for edge_mode in ("exact", "boxed"):
                for overlap in (False, True):
                    kconv.reset_launch_counts()
                    out = plan.run_pipelined(mbs, mesh=mesh, edge_mode=edge_mode, overlap=overlap)
                    torch.cuda.synchronize()
                    assert torch.equal(out, want), (quant, edge_mode, overlap)
                    # S x M stage launches a call; fill and drain launch nothing.
                    assert sum(kconv.LAUNCHES.values()) == M * per_call
            kconv.reset_launch_counts()
            out = plan.run_pipelined(mbs, mesh=mesh2, data_axis="data")
            torch.cuda.synchronize()
            assert torch.equal(out, want)
            assert sum(kconv.LAUNCHES.values()) == 2 * M * per_call


def test_record_stream_keeps_a_slow_readers_input_alive(card):
    """The reader stage sleeps on its stream before it reads its input
    while the writer stage, ahead on its own stream, allocates blocks of
    the same size and fills them with NaN: without ``record_stream`` the
    caching allocator would hand the writer the block the reader is about
    to read. Repeated over several calls, with the allocator's cache
    emptied between them."""
    plan = _plans(card)["fp32"]
    fns, params, ios = plan.pipeline_spec()

    def writer(s, fn):
        def body(p, x):
            y = fn(p, x)
            junk = [torch.full_like(y, float("nan")) for _ in range(4)]
            del junk
            return y
        return body

    def reader(fn):
        def body(p, x):
            torch.cuda._sleep(2_000_000)
            return fn(p, x)
        return body

    stage_fns = [writer(0, fns[0]), reader(writer(1, fns[1])), reader(fns[2])]
    mbs = _mbs(card, m=6)
    with torch.inference_mode():
        want = torch.stack([plan.features(mbs[m]) for m in range(6)])
        for overlap in (False, True):
            runner = tpipeline.build_pipeline(stage_fns, params, mesh=make_mesh((3,), ("stage",)),
                                              cfg=PipelineConfig(3, 6, overlap=overlap),
                                              io_specs=ios)
            for _ in range(3):
                torch.cuda.empty_cache()
                out = runner(mbs)
                torch.cuda.synchronize()
                assert torch.equal(out, want), overlap


def test_pipeline_scope_on_the_card(card):
    for kind, plan in _plans(card).items():
        probe_ = make_pipeline_probe(plan, microbatch=MB)
        assert verify_plan(plan, scopes=("pipeline",), pipeline=probe_) == []
        assert len(probe_.transfers) == 2 * probe_.cfg.n_microbatches
        # The probe replays the mesh rung's graph: the stage bodies, then the head.
        stage = [n for _, n, _ in probe_.launches if n.startswith("stream_conv")]
        head = [n for _, n, _ in probe_.launches if not n.startswith("stream_conv")]
        assert len(stage) == probe_.cfg.n_microbatches * planned_launches(plan)
        assert head == (["pow2_matmul_int"] * 2 if kind == "int8" else [])
        boxed = make_pipeline_probe(plan, microbatch=MB, edge_mode="boxed")
        findings = verify_plan(plan, scopes=("pipeline",), pipeline=boxed)
        assert [(f.rule, f.severity) for f in findings] == [("V103", "warning")]


def _padded(plan, x, group):
    xp = np.concatenate([x, np.zeros((-x.shape[0] % group,) + x.shape[1:], np.float32)])
    with torch.inference_mode():
        return torch.cat([plan(torch.from_numpy(xp[i:i + group]).cuda()).cpu()
                          for i in range(0, xp.shape[0], group)])[: x.shape[0]]


def _frames(n, seed):
    h, w = TOPO.input_shape
    return np.random.default_rng(seed).normal(size=(n, h, w, TOPO.input_channels)).astype(np.float32)


def test_engine_mesh_rung_and_its_demotions_on_the_card(card):
    plan = _plans(card)["fp32"]
    mesh = make_mesh((3,), ("stage",))
    eng = Engine(plan, microbatch=MB, mesh=mesh, n_microbatches=M)
    assert eng.rung == "mesh"
    for n, seed in ((1, 1), (64, 2), (70, 3)):
        x = _frames(n, seed)
        assert torch.equal(eng.infer(x), _padded(plan, x, M * MB))
    assert eng.rung == "mesh" and eng.demotions == []

    eng = Engine(plan, microbatch=MB, mesh=mesh, n_microbatches=M, retry_backoff_s=1e-4,
                 fault_plan=FaultPlan([DeviceLoss(at=0, times=None, rung="mesh")]))
    x = _frames(5, 4)
    assert torch.equal(eng.infer(x), _padded(plan, x, M * MB))
    assert eng.rung == "fused" and [d["rung"] for d in eng.demotions] == ["mesh"]
    assert eng.stats().n_retries == 0

    eng = Engine(plan, microbatch=MB, mesh=mesh, n_microbatches=M, dispatch_timeout_s=1.0,
                 fault_plan=FaultPlan([StalledDispatch(at=0, times=1, stall_s=30.0, rung="mesh")]))
    calls, mesh_fwd = [], eng._fwd
    eng._fwd = lambda xb: calls.append(1) or mesh_fwd(xb)
    x = _frames(7, 5)
    t0 = time.perf_counter()
    kconv.reset_launch_counts()
    got = eng.infer(x)
    assert join_watchdogs(10.0) == 0 and time.perf_counter() - t0 < 10.0
    torch.cuda.synchronize()  # no error left behind by the abandoned attempt
    assert calls == [] and eng.rung == "fused"
    assert "did not complete" in eng.demotions[0]["reason"]
    # Only the fused rung's own launches, its warmup and this request: the
    # abandoned attempt on the mesh launched nothing.
    assert sum(kconv.LAUNCHES.values()) == 2 * planned_launches(plan)
    assert torch.equal(got, _padded(plan, x, M * MB))
