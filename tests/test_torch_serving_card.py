"""Fault-injected, multi-tenant serving of the DHM plans on the card, and
the verifier's plan and structure scopes over the card's plans.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit (the kernels are built with nvcc at first
use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_serving_card.py

This file imports no JAX: the machine with the card has none.

Answers are held bit for bit against a direct call, on the card, of the
plan and rung that served them, on the request's frames padded to the
micro-batch as the engine pads them (the same shapes, so the same
kernels and GEMM configurations; each frame's row is computed on its
own). The NaN -> integer-code results on the card are held equal to the
CPU's.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis.verify import ProbeContext, verify_plan  # noqa: E402
from repro_torch.core.dhm import (  # noqa: E402
    DispatchError,
    Engine,
    FaultPlan,
    NaNActivation,
    QuantSpec,
    Router,
    StalledDispatch,
    SwapRejected,
    compile_dhm,
    emit_conv_stage,
)
from repro_torch.core.dhm.pipeline import join_watchdogs  # noqa: E402
from repro_torch.core.quant.fixed_point import FixedPointSpec, quantize_fixed  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import stream_conv_block  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import quantize_stream  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

pytestmark = pytest.mark.card

MB = 16
TOPO = ALL_TOPOLOGIES["cifar10"]
Q_INT8 = QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _params(topo, seed, device):
    return init_cnn(torch.Generator().manual_seed(seed), topo, device=device)


def _frames(n, seed, topo=TOPO):
    h, w = topo.input_shape
    return np.random.default_rng(seed).normal(
        size=(n, h, w, topo.input_channels)).astype(np.float32)


def _direct(fwd, f, mb=MB):
    """``fwd`` on ``f`` padded to the micro-batch, on the card."""
    x = np.concatenate([f, np.zeros((mb - f.shape[0],) + f.shape[1:], np.float32)])
    with torch.inference_mode():
        out = fwd(torch.from_numpy(x).cuda()).cpu()
    return out[: f.shape[0]]


def test_fault_injected_engine_on_the_card(card):
    """A dispatch error heals on retry; a stall past the watchdog demotes
    to per_layer. The abandoned attempt wakes when its watchdog gives up,
    launches nothing, and leaves no CUDA error behind."""
    plan = compile_dhm(TOPO, _params(TOPO, 0, card))
    eng = Engine(plan, microbatch=MB, dispatch_timeout_s=2.0, retry_backoff_s=1e-4,
                 fault_plan=FaultPlan([DispatchError(at=0, times=1),
                                       StalledDispatch(at=2, times=1, stall_s=30.0, rung="fused")]))
    x1, x2 = _frames(5, 1), _frames(MB, 2)
    assert torch.equal(eng.infer(x1), _direct(plan, x1))
    assert eng.stats().n_retries == 1 and eng.rung == "fused"
    calls, fused = [], eng._fwd
    eng._fwd = lambda xb: calls.append(1) or fused(xb)
    t0 = time.perf_counter()
    got = eng.infer(x2)
    assert join_watchdogs(10.0) == 0
    assert time.perf_counter() - t0 < 10.0
    assert calls == [] and eng.rung == "per_layer"
    assert [d["rung"] for d in eng.demotions] == ["fused"]
    assert torch.equal(got, _direct(eng._build_unfused_fwd(), x2))
    torch.cuda.synchronize()  # no error left behind by the abandoned attempt
    x3 = _frames(3, 3)
    assert torch.equal(eng.infer(x3), _direct(eng._build_unfused_fwd(), x3))
    assert torch.isfinite(plan(x3)).all()


def test_nan_codes_on_the_card_equal_the_cpus(card):
    vals = torch.tensor([float("nan"), -float("nan"), float("inf"), -float("inf"), 1.0, -0.3, 7.9])
    spec = FixedPointSpec(bits=8, frac_bits=4)
    assert torch.equal(quantize_fixed(vals.to(card), spec).cpu(), quantize_fixed(vals, spec))
    assert torch.equal(quantize_stream(vals.to(card), 8).cpu(), quantize_stream(vals, 8))
    assert quantize_fixed(vals, spec)[0] == 0
    p = _params(TOPO, 0, "cpu")
    plan_cpu = compile_dhm(TOPO, p, quant=Q_INT8, device="cpu")
    plan_card = compile_dhm(TOPO, {k: [{kk: vv.to(card) for kk, vv in d.items()} for d in v]
                                   for k, v in p.items()}, quant=Q_INT8)
    feats = torch.full((3,) + tuple(TOPO.feature_shape()), float("nan"))
    with torch.inference_mode():
        on_card = plan_card.head_fn(feats.to(card)).cpu()
        on_cpu = plan_cpu.head_fn(feats)
    assert torch.isfinite(on_card).all() and torch.equal(on_card, on_cpu)
    # NaNActivation on the integer head goes undetected, on the card as
    # on the CPU: the engine serves the same corrupted logits, no retry.
    served = {}
    for which, plan_ in (("card", plan_card), ("cpu", plan_cpu)):
        eng = Engine(plan_, microbatch=4, fault_plan=FaultPlan([NaNActivation(at=0, times=1)]))
        served[which] = eng.infer(_frames(4, 9))
        assert eng.stats().n_retries == 0 and eng.demotions == []
    assert torch.equal(served["card"], served["cpu"])


def test_two_tenant_router_on_the_card(card):
    """An fp32 and an int8 tenant behind one Router, with a stall that
    demotes the int8 tenant, a hot swap of the fp32 tenant with requests
    queued, a rollback and a refused swap: every answer equals a direct
    call of the plan and rung that served it."""
    p0 = _params(TOPO, 0, card)
    plans = {"fp32": compile_dhm(TOPO, p0), "int8": compile_dhm(TOPO, p0, quant=Q_INT8),
             "fp32 seed 1": compile_dhm(TOPO, _params(TOPO, 1, card))}
    served_on, complete = {}, Engine._complete

    def recording(self, req, logits, done):
        served_on[id(req)] = self.rung
        return complete(self, req, logits, done)

    Engine._complete = recording
    try:
        faults = FaultPlan([StalledDispatch(at=1, times=1, stall_s=30.0, rung="fused",
                                            tenant="int8")])
        r = Router(microbatch=MB, fault_plan=faults, join_timeout_s=60.0)
        r.add("fp32", plans["fp32"])
        r.add("int8", plans["int8"], weight=3.0, dispatch_timeout_s=2.0)
        old = r.engine("fp32")
        reqs = []
        with r:
            for i in range(6):
                for t in ("fp32", "int8"):
                    f = _frames(1 + (7 * i) % MB, 10 * i + len(t))
                    reqs.append((r.submit(t, f), f))
            r.swap("fp32", plans["fp32 seed 1"])
            for i in range(3):
                f = _frames(MB, 100 + i)
                reqs.append((r.submit("fp32", f), f))
            answers = [req.result(timeout=60.0) for req, _ in reqs]
            new = r.engine("fp32")
            r.rollback("fp32")
            with pytest.raises(SwapRejected, match="serving surface"):
                lenet = ALL_TOPOLOGIES["lenet5"]
                r.swap("fp32", compile_dhm(lenet, _params(lenet, 0, card)))
            assert r.engine("fp32") is old
    finally:
        Engine._complete = complete
    assert join_watchdogs(10.0) == 0
    for (req, f), got in zip(reqs, answers):
        eng = req._engine
        fwd = eng.plan if served_on[id(req)] == "fused" else eng._build_unfused_fwd()
        assert torch.equal(got, _direct(fwd, f))
    assert {served_on[id(req)] for req, _ in reqs if req._engine.name == "int8"} == {
        "fused", "per_layer"}
    assert any(req._engine is old for req, _ in reqs) and any(req._engine is new for req, _ in reqs)
    assert new.stats().n_errors == old.stats().n_errors == 0


@pytest.mark.parametrize("name", sorted(ALL_TOPOLOGIES))
def test_card_plans_verify_clean(card, name):
    topo = ALL_TOPOLOGIES[name]
    p = _params(topo, 0, card)
    n = len(topo.conv_layers)
    for quant in (QuantSpec(), QuantSpec(weight_bits=6, act_bits=6),
                  QuantSpec(weight_bits=8, act_bits=8, int8_compute=True),
                  QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True,
                            per_layer_bits=(8,) * n)):
        for budget in (None, 0):
            plan = compile_dhm(topo, p, quant=quant, vmem_budget=budget)
            assert verify_plan(plan) == [], f"{name}/{quant}/{budget}"


def test_seeded_structure_defects_on_the_card(card):
    """On the card the kernel-path checks run: a stage that splits its
    fusion group (V002), a stage that falls back to cuDNN (V003) and a
    fake-quant stage that quantizes between launches (V007)."""
    plan = compile_dhm(TOPO, _params(TOPO, 0, card), quant=QuantSpec(weight_bits=6, act_bits=6))
    assert verify_plan(plan) == []
    st = plan.stages[0]
    tr = ProbeContext(plan).trace()
    assert [d[1:] for d in tr.phase_dispatches("features")] == [("stream_conv_pyramid", False)]
    assert [l[1] for l in tr.phase_launches("features")] == ["stream_conv_pyramid"]

    def ids(bad, rule):
        return sorted({f.rule for f in verify_plan(bad, ids=(rule,))})

    split = dataclasses.replace(plan, stages=(dataclasses.replace(
        st, fn=emit_conv_stage(st.specs, act_bits=6)),))
    assert ids(split, "V002") == ["V002"]

    def cudnn(params, x, _f=st.fn):
        F.conv2d(x.permute(0, 3, 1, 2), params[0]["w"].permute(3, 2, 0, 1))
        return _f(params, x)

    assert ids(dataclasses.replace(plan, stages=(dataclasses.replace(st, fn=cudnn),)),
               "V003") == ["V003"]

    def requant(params, x, _f=st.fn):
        return torch.round(_f(params, x) * 32) / 32

    assert ids(dataclasses.replace(plan, stages=(dataclasses.replace(st, fn=requant),)),
               "V007") == ["V007"]


def test_probe_counts_only_its_own_launches_on_the_card(card):
    """Another thread launches the single-layer kernel in a loop while the
    probe runs: the probe still reads its own launches only, and the
    shared counters show the other thread's."""
    plan = compile_dhm(TOPO, _params(TOPO, 0, card), vmem_budget=0)
    x = torch.from_numpy(_frames(MB, 5)).cuda()
    w, b = plan.conv_params[0]["w"], plan.conv_params[0]["b"]
    stop, busy = threading.Event(), []

    def hammer():
        with torch.cuda.device(card):
            while not stop.is_set():
                stream_conv_block(x, w, b, padding="SAME", act="relu", pool=2)
                busy.append(1)

    before = kconv.LAUNCHES["stream_conv_fused"]
    t = threading.Thread(target=hammer, daemon=True)
    t.start()
    try:
        while not busy:
            stop.wait(0.001)
        for _ in range(3):
            tr = ProbeContext(plan).trace()
            assert len(tr.phase_launches("features")) == len(plan.fusion_groups)
            assert verify_plan(plan, scopes=("structure",)) == []
    finally:
        stop.set()
        t.join(timeout=30.0)
    torch.cuda.synchronize()
    assert not t.is_alive()
    assert kconv.LAUNCHES["stream_conv_fused"] - before > len(plan.fusion_groups) * 3
