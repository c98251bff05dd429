"""The spans of the port's CUDA graphs on the card (``kernels/probe.py``
``span``, ``cuda_graphs.graphs``).

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one. Run on a machine with
the card and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_spans_card.py

This file imports no JAX: the machine with the card has none.

For the int8 plan's graph and the QAT train step's graph: the capture
leaves one record whose phase table covers every device operation of the
graph, in the order of the spans (``dhm.quantize`` in the first
``dhm.stage``, the stages, ``dhm.head``; ``train.forward`` with the
``dhm.*`` spans inside, ``train.backward``, ``train.update``); one
profiled replay runs exactly the record's operations (those that share
the ``cudaGraphLaunch``'s correlation id), named as the record names
them, in its order; and the plan call's copy into the static input is
the device operation just before its replay, which is what the
benchmark's ``infer_stage_in_us`` reads. A capture that names no owner
(a decode key's, the mesh rung's) reads no operations and leaves an
empty phase table.
"""
import json

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch import cuda_graphs  # noqa: E402
from repro_torch.analysis.invariants import planned_backward_launches  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, LENET5, init_cnn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine  # noqa: E402
from repro_torch.paper.train_cnn import jit_train_step  # noqa: E402

pytestmark = pytest.mark.card

P = "repro_torch."
QUANT, STAGE, HEAD = P + "dhm.quantize", P + "dhm.stage", P + "dhm.head"
FWD, BWD, UPD = P + "train.forward", P + "train.backward", P + "train.update"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _profiled(call, tmp_path) -> list:
    """The chrome trace's complete events of one profiled ``call()``."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        call()
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"]
            if e.get("ph") == "X" and "dur" in e]


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def _key(name: str) -> str:
    return "Memcpy" if name.startswith("Memcpy") else "Memset" if name.startswith("Memset") \
        else name


def _check_replay(events, record) -> list:
    """The replay's device operations are the record's, in its order: all
    of the trace's device operations, by start, with the replay's first
    one's index."""
    by_corr: dict = {}
    for e in events:
        if e.get("cat") in DEVICE:
            by_corr.setdefault(_corr(e), []).append(e)
    launches = [e for e in events if "GraphLaunch" in e["name"] and _corr(e) in by_corr]
    assert len(launches) == 1, [(e["name"], e.get("cat")) for e in events
                                if "GraphLaunch" in e["name"]]
    ops = sorted(by_corr[_corr(launches[0])], key=lambda e: e["ts"])
    assert len(ops) == record.n_ops
    for e, op in zip(ops, record.ops):
        assert _key(e["name"]) == op or (op == "" and _key(e["name"]) == e["name"]), \
            (e["name"], op)
    device = sorted((e for e in events if e.get("cat") in DEVICE), key=lambda e: e["ts"])
    return device, device.index(ops[0])


def _runs(names) -> list:
    """``names`` with each run of one name kept once."""
    out = []
    for name in names:
        if not out or out[-1] != name:
            out.append(name)
    return out


def _innermost(record) -> list:
    return _runs(path.split("/")[-1] for path, _ in record.phases)


def test_the_int8_plans_graph_by_phase(card, tmp_path):
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device=card)
    plan = compile_dhm(topo, params, device=card,
                       quant=QuantSpec(weight_bits=6, act_bits=6, int8_compute=True))
    x = torch.randn(64, 32, 32, 3, device=card)
    plan(x)
    fwd = plan.jitted_forward()
    record = cuda_graphs.graphs()[-1]
    assert record.owner == "JittedForward" and (fwd.captures, fwd.replays) == (1, 1)
    assert record.n_ops == sum(n for _, n in record.phases) > 0
    assert _innermost(record) == [QUANT, STAGE, HEAD], record.phases
    assert record.phases[0][0] == f"{STAGE}/{QUANT}"
    assert sum(1 for op in record.ops if op == "") == 0, record.ops
    assert record.first_call_s >= record.capture_s > 0 and record.warmup_s > 0
    events = _profiled(lambda: plan(x), tmp_path)
    assert (fwd.staged, fwd.replays) == (2, 2)
    device, first = _check_replay(events, record)
    copy_in = device[first - 1]
    assert first > 0 and copy_in["cat"] == "gpu_memcpy", copy_in["name"]
    assert copy_in["ts"] + copy_in["dur"] <= device[first]["ts"]


def test_a_capture_that_names_no_owner_reads_no_operations(card):
    side = torch.cuda.Stream(card)
    x = torch.ones(8, device=card)
    cap = cuda_graphs.capture(lambda: x * 2, card, side)
    assert cap.record.owner == "" and cap.record.phases == () and cap.record.ops == ()
    assert cap.record.capture_s > 0
    cap.graph.replay()
    assert torch.equal(cap.out, x * 2)


def test_the_qat_train_steps_graph_by_phase(card, tmp_path):
    params = init_cnn(torch.Generator().manual_seed(0), LENET5, device=card)
    cfg = AdamWConfig(weight_decay=0.01)
    step_fn = jit_train_step(LENET5, cfg, linear_warmup_cosine(3e-3, 20, 100),
                             weight_bits=3, act_bits=3)
    state = adamw_init(params, cfg)
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.randn(32, 28, 28, 1, device=card, generator=g)
    y = torch.randint(0, 10, (32,), device=card, generator=g)
    params, state, _, _ = step_fn(params, state, x, y, 0)
    record = cuda_graphs.graphs()[-1]
    assert record.owner == "JittedTrainStep" and step_fn.captures == 1
    assert record.n_ops == sum(n for _, n in record.phases) > 0
    top = _runs(n for n in _innermost(record) if n in (FWD, BWD, UPD))
    assert top == [FWD, BWD, UPD], record.phases
    paths = [p for p, _ in record.phases]
    assert any(p.startswith(f"{FWD}/") and p.endswith(STAGE) for p in paths)
    assert any(p.startswith(f"{FWD}/") and p.endswith(HEAD) for p in paths)
    # The backward, launched on autograd's thread, lands in its own phase:
    # the stream-conv group's backward kernels, as many as planned, all there.
    plan = compile_dhm(LENET5, params, quant=QuantSpec(weight_bits=3, act_bits=3), device=card)
    in_bwd, elsewhere, at = [], [], 0
    for path, n in record.phases:
        (in_bwd if path == BWD else elsewhere).extend(record.ops[at:at + n])
        at += n
    scb = [op for op in in_bwd if "scb_" in op]
    assert len(scb) == planned_backward_launches(plan), record.phases
    assert not [op for op in elsewhere if "scb_" in op] and len(in_bwd) > len(scb)
    assert record.first_call_s >= record.capture_s > 0 and record.release_s > 0
    events = _profiled(lambda: step_fn(params, state, x, y, 1), tmp_path)
    assert step_fn.replays == 1
    _check_replay(events, record)
