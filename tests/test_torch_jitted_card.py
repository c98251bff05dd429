"""The plan's jitted closure on the card: CUDA graphs of the hand-written
kernels (``core/dhm/engine.py``, ``JittedForward``).

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit (the kernels are built with nvcc at first
use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_jitted_card.py

This file imports no JAX: the machine with the card has none.

A replay runs the kernels the eager call runs, in the same order on the
same shapes, and no stream-conv or pow2 kernel sums with atomics, so
every replay is held to the eager ``forward`` bit for bit. Covered: every
plan kind (fp32 fused and per-layer, int8, the integer and the fp32 pow2
heads), the replay's launch accounting, four threads on one plan, a
capture while another engine serves, the donating closure reading its
buffer in place, the Engine's fused and per-layer rungs serving through
graphs, a capture failure demoting the rung, the verifier's V005 and
V006 on the card, and the collector guard of the capture sequence
(``repro_torch/cuda_graphs.py``) under a plan's and a decode step's
capture.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402
import gc  # noqa: E402
import threading  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.analysis.verify import ProbeContext, verify_plan  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core.dhm import DispatchError, Engine, FaultPlan, QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.engine import JittedForward, forward  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import quantize_stream, stream_quant_spec  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402
from repro_torch.tree_util import tree_leaves  # noqa: E402

pytestmark = pytest.mark.card

TOPO = ALL_TOPOLOGIES["cifar10"]
KINDS = {
    "fp32": (QuantSpec(), None),
    "fp32_per_layer": (QuantSpec(), 0),
    "int8": (QuantSpec(weight_bits=8, act_bits=8, int8_compute=True), None),
    "int_pow2_head": (QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True,
                                per_layer_bits=(8, 8, 8)), None),
    "fp32_pow2_head": (QuantSpec(pow2_weights=True), None),
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


def _plan(kind, device, seed=0):
    quant, budget = KINDS[kind]
    params = init_cnn(torch.Generator().manual_seed(seed), TOPO, device=device)
    return compile_dhm(TOPO, params, quant=quant, vmem_budget=budget, device=device)


def _frames(n, seed, device=None, grid=False):
    h, w = TOPO.input_shape
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, h, w, TOPO.input_channels)).astype(np.float32))
    if grid:
        x = quantize_stream(x, 8).to(torch.float32) * stream_quant_spec(8).scale
    return x if device is None else x.to(device)


def _eager(plan, x):
    with torch.no_grad():
        return forward(plan, x)


def _counts():
    return {**kconv.LAUNCHES, **kpow2.LAUNCHES}


def _delta(before):
    return {k: v - before[k] for k, v in _counts().items() if v != before[k]}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_replay_is_bit_equal_to_eager(card, kind):
    plan = _plan(kind, card)
    fwd = plan.jitted_forward()
    for b in (1, 8):
        for seed in (1, 2):  # the capture's call, then a replay alone
            x = _frames(b, seed, card, grid=kind != "fp32")
            kept = x.clone()
            got = plan(x)
            assert torch.equal(got, _eager(plan, x)), (kind, b, seed)
            assert torch.equal(x, kept)
    assert fwd._cache_size() == 2


def test_replay_counts_the_eager_calls_launches(card):
    plan = _plan("int_pow2_head", card)
    x = _frames(8, 1, card, grid=True)
    before = _counts()
    _eager(plan, x)
    torch.cuda.synchronize()
    eager = _delta(before)
    assert set(eager) >= {"stream_conv_pyramid_int8", "pow2_matmul_int"}
    fwd = plan.jitted_forward()
    before = _counts()
    fwd(x)  # warm-up (real launches) + capture (none) + replay
    assert _delta(before) == {k: 2 * v for k, v in eager.items()}
    before = _counts()
    with probe.recording() as log:
        fwd(x)
    assert _delta(before) == eager
    assert sorted(name for _, name, _ in log.launches) == sorted(
        name for name, n in eager.items() for _ in range(n))
    conv_smem = [smem for _, name, smem in log.launches if name.startswith("stream_conv")]
    assert conv_smem == list(plan.card_smem)


def test_four_threads_on_one_plan(card):
    plan = _plan("fp32", card)
    xs = [_frames(8, s, card) for s in range(16)]
    want = [_eager(plan, x) for x in xs]
    got = [None] * len(xs)
    errors = []

    def work(i):
        try:
            with torch.cuda.device(card):
                for j in range(i, len(xs), 4):
                    got[j] = plan(xs[j])
                torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert errors == []
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert plan.jitted_forward()._cache_size() == 1


def test_capture_while_a_second_engine_serves(card):
    serving = _plan("fp32", card)
    eng = Engine(serving, microbatch=16, auto_flush=True)
    frames = [_frames(n, 10 + n).numpy() for n in (3, 16, 7, 12, 1, 16, 9, 5)]
    stop, answers = threading.Event(), []

    def traffic():
        while not stop.is_set():
            reqs = [eng.submit(f) for f in frames]
            answers.extend((f, r.result(timeout=60.0)) for f, r in zip(frames, reqs))

    t = threading.Thread(target=traffic)
    t.start()
    try:
        other = _plan("int_pow2_head", card, seed=1)
        x = _frames(16, 3, card, grid=True)
        got = other(x)  # captured on this thread while the engine serves
        eng_b = Engine(other, microbatch=16)  # its rung's capture too
        out_b = eng_b.infer(x.cpu().numpy())
    finally:
        stop.set()
        t.join()
        eng.stop()
    assert torch.equal(got, _eager(other, x))
    assert torch.equal(out_b, _eager(other, x).cpu())
    assert answers and eng.rung == "fused" and eng.demotions == []
    for f, out in answers:
        pad = np.zeros((16,) + f.shape[1:], np.float32)
        pad[: f.shape[0]] = f
        want = _eager(serving, torch.from_numpy(pad).to(card))[: f.shape[0]].cpu()
        assert torch.equal(out, want)


def test_donating_closure_reads_its_buffer_in_place(card):
    plan = _plan("int8", card)
    rep = ProbeContext(plan).lower_donated()
    assert rep.declared and rep.input_copies == 0
    fwd = plan.jitted_forward(donate=True)
    x = _frames(8, 4, card, grid=True)
    with fwd.lock:
        buf = fwd.input_buffer(tuple(x.shape))
        ptr = buf.data_ptr()
        buf.copy_(x)
        got = fwd(buf)
    assert torch.equal(got, _eager(plan, x))
    assert fwd.input_buffer(tuple(x.shape)).data_ptr() == ptr


@pytest.mark.parametrize("donate", [True, False])
def test_engine_rungs_serve_through_graphs(card, donate):
    plan = _plan("int_pow2_head", card)
    faults = FaultPlan([DispatchError(at=2, times=3)])
    eng = Engine(plan, microbatch=16, donate=donate, fault_plan=faults, max_retries=2,
                 retry_backoff_s=0.0)
    assert eng.rung == "fused"
    fused = eng._fwd
    assert isinstance(fused, JittedForward) and fused._cache_size() == 1
    assert fused is plan.jitted_forward(donate=donate)
    plan0 = compile_dhm(TOPO, init_cnn(torch.Generator().manual_seed(0), TOPO, device=card),
                        quant=KINDS["int_pow2_head"][0], vmem_budget=0, device=card)
    outs = []
    for seed in range(4):
        x = _frames(16, 20 + seed, grid=True).numpy()
        outs.append((x, eng.infer(x), eng.rung))
    assert eng.rung == "per_layer" and [d["rung"] for d in eng.demotions] == ["fused"]
    assert isinstance(eng._fwd, JittedForward) and eng._fwd._cache_size() == 1
    assert eng._fwd.donate is donate
    for x, out, rung in outs:
        want = _eager(plan if rung == "fused" else plan0, torch.from_numpy(x).to(card)).cpu()
        assert torch.equal(out, want), rung


def test_a_failed_capture_fails_the_rungs_warmup(card):
    """A stage body that reads a value to the host runs eagerly but cannot
    be captured: the fused rung's warm-up fails with the capture's error
    recorded, and the per-layer rung (re-emitted from the specs) serves
    through its own graph."""
    plan = _plan("fp32", card)
    st = plan.stages[0]

    def reads_host(params, x, _f=st.fn):
        float(x.sum())
        return _f(params, x)

    bad = dataclasses.replace(plan, stages=(dataclasses.replace(st, fn=reads_host),))
    eng = Engine(bad, microbatch=8)
    assert eng.rung == "per_layer"
    assert [d["rung"] for d in eng.demotions] == ["fused"]
    assert "captur" in eng.demotions[0]["reason"].lower()
    x = _frames(8, 5)
    plan0 = compile_dhm(TOPO, init_cnn(torch.Generator().manual_seed(0), TOPO, device=card),
                        vmem_budget=0, device=card)
    assert torch.equal(eng.infer(x.numpy()), _eager(plan0, x.to(card)).cpu())
    found = verify_plan(bad, ids=("V005",))
    assert len(found) == 2 and all(f.rule == "V005" for f in found)
    assert any("CUDA graph" in f.message for f in found)


def test_verifier_V005_V006_on_the_card(card):
    plan = _plan("int_pow2_head", card)
    assert verify_plan(plan, ids=("V005", "V006")) == []
    ctx = ProbeContext(plan)
    assert ctx.capture_error() is None
    assert plan.jitted_forward()._cache_size() == 1  # the probe batch, captured

    class _DropsDonate:
        topo = plan.topo
        device = plan.device

        def jitted_forward(self, *, donate=False):
            return plan.jitted_forward(donate=False)

    found = verify_plan(_DropsDonate(), ids=("V006",))
    assert [f.rule for f in found] == ["V006"]
    rep = ProbeContext(_DropsDonate()).lower_donated()
    assert not rep.declared and rep.input_copies == 1


# ---------------------------------------------------------------------------
# The collector guard: a graph that becomes garbage during another capture.


def _old_graph_dropped_mid_capture(card):
    """A captured plan closure, and ``drop``: called at each call of the
    next closure's function, at its second call (the capture; the first
    is the warm-up) it moves the only reference to the old closure into a
    fresh reference cycle, so that the collection the capture's own
    allocations trigger under ``gc.set_threshold(1)`` would tear the old
    graph down on the capturing thread."""
    old = _plan("fp32", card, seed=3)
    parked = [JittedForward(lambda xb: forward(old, xb), card)]
    parked[0](_frames(8, 9, card))
    calls = [0]

    def drop():
        calls[0] += 1
        if calls[0] == 2 and parked:
            cycle = [parked.pop()]
            cycle.append(cycle)

    return drop


def _under_gc_threshold_1(fn):
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    try:
        return fn()
    finally:
        gc.set_threshold(*thresholds)


def test_a_collection_inside_a_plan_capture_voids_nothing(card):
    """Without the collector guard the capture fails (CUDA error 901:
    the capture was invalidated)."""
    plan = _plan("int_pow2_head", card, seed=1)
    drop = _old_graph_dropped_mid_capture(card)

    def fn(xb):
        drop()
        return forward(plan, xb)

    fwd = JittedForward(fn, card)
    x = _frames(8, 2, card, grid=True)
    got, again = _under_gc_threshold_1(lambda: (fwd(x), fwd(x)))
    want = _eager(plan, x)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert fwd._cache_size() == 1


def test_a_collection_inside_a_decode_capture_voids_nothing(card, monkeypatch):
    """The same for the LM decode step's graph (falcon-mamba through the
    scan kernel)."""
    cfg = get_arch("falcon-mamba-7b").scaled_down()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=card)
    toks = torch.randint(0, cfg.vocab_size, (2, 9),
                         generator=torch.Generator().manual_seed(1)).to(card)
    with torch.no_grad():
        _, cache = T.prefill(params, cfg, toks[:, :8], max_len=10)
        want, want_cache = T.decode_step(params, cfg, toks[:, 8:], cache, 8)
    drop = _old_graph_dropped_mid_capture(card)
    real = S._decode_into

    def step(*args):
        drop()
        return real(*args)

    monkeypatch.setattr(S, "_decode_into", step)
    decode = S.jit_decode_step(cfg)
    with torch.no_grad():
        (got, c1), (again, c2) = _under_gc_threshold_1(
            lambda: (decode(params, cache, toks[:, 8:], 8), decode(params, cache, toks[:, 8:], 8)))
    assert torch.equal(got, want) and torch.equal(again, want)
    for c in (c1, c2):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(c), tree_leaves(want_cache)))
    assert decode._cache_size() == 1
