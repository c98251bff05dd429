"""The readers of the port's graph phases (``bench/phases.py`` and the
metrics that use it) on hand-built chrome traces, and the accepted
metrics on a fixed trace, read as they read before the phases were."""
import json
import time
from types import SimpleNamespace

import pytest

from bench import harness, phases
from bench.cell import Readings
from bench.trace import read_chrome_trace

SPEC = harness.load_spec()
PEAKS = {"int8_ops_per_s": 1.979e15, "fp32_flops_per_s": 6.7e13, "hbm_bytes_per_s": 3.35e12}
QUANT, STAGE, HEAD = "repro_torch.dhm.quantize", "repro_torch.dhm.stage", "repro_torch.dhm.head"
FWD, BWD, UPD = "repro_torch.train.forward", "repro_torch.train.backward", "repro_torch.train.update"

DIV = "void at::native::vectorized_elementwise_kernel<4, at::native::DivFunctor<float> >(int)"
ROUND = "void at::native::vectorized_elementwise_kernel<4, at::native::round_kernel>(int)"
CONV = "sc_pyramid_i8_kernel(signed char const*, int)"
GEMM = "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x32x8_stage3_warpsize2x2x1_ffma"
TANH = "void at::native::vectorized_elementwise_kernel<4, at::native::tanh_kernel>(int)"

# The plan's graph: (name in the trace, its op in the record, its phase, us).
PLAN_OPS = [(DIV, DIV, QUANT, 50.0), (ROUND, ROUND, QUANT, 40.0), (CONV, CONV, STAGE, 500.0),
            ("Memset (Device)", "Memset", STAGE, 2.0), (GEMM, GEMM, HEAD, 20.0),
            (TANH, "", HEAD, 10.0)]
PLAN_PHASES = ((f"{STAGE}/{QUANT}", 2), (STAGE, 2), (HEAD, 2))


def _dev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _trace(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return read_chrome_trace(str(path))


def _record(owner, ops, table, first_call_s=0.25, id_=7):
    return SimpleNamespace(id=id_, owner=owner, key="()", ops=tuple(ops), phases=table,
                           n_ops=len(ops), first_call_s=first_call_s)


def _infer_events(lose=(1,)):
    """Three requests: the copy in (36 us), the graph, the clone, the copy
    to the host; request ``lose`` lost its Memset record."""
    events, t = [], 1000.0
    for req in range(3):
        events.append(_span("bench.enqueue", 10.0 + 700.0 * req, 60.0))
        events.append(_span("bench.to_host", 75.0 + 700.0 * req, 5.0))
        events.append(_dev("Memcpy DtoD (Device -> Device)", t, 36.0, "gpu_memcpy"))
        t += 37.0
        for name, _, _, us in PLAN_OPS:
            if req in lose and name.startswith("Memset"):
                continue
            events.append(_dev(name, t, us, "gpu_memset" if name.startswith("Memset")
                               else "kernel"))
            t += us + 1.0
        events.append(_dev("Memcpy DtoD (Device -> Device)", t, 3.0, "gpu_memcpy"))
        events.append(_dev("Memcpy DtoH (Device -> Pinned)", t + 4.0, 5.0, "gpu_memcpy"))
        t += 10.0
    events.append(_span("bench.wait", 2100.0, 1500.0))
    return events


def _infer_readings(tmp_path, events):
    cell = harness.make_cell(SPEC, "cifar10-q6.infer", seed=2**31 + 9, seconds=1.0,
                             trace=True, device="cpu", t_start=time.perf_counter())
    work = {"requests": 3, "frames_per_request": 4096, "window_s": 0.004}
    return Readings(cell=cell, trace=_trace(tmp_path, events),
                    host_s={"enqueue": [2e-4, 3e-4, 4e-4]}, work=work, peaks=dict(PEAKS))


def _read(metric, r):
    return harness.metric_reader(metric).read(r)


@pytest.fixture
def plan_record(monkeypatch):
    rec = _record(phases.PLAN, [op for _, op, _, _ in PLAN_OPS], PLAN_PHASES)
    monkeypatch.setattr(phases, "records", lambda: [rec])
    return rec


def test_replays_matched_and_the_lost_one_left_out_and_counted(tmp_path, plan_record):
    r = _infer_readings(tmp_path, _infer_events())
    w = phases.window(r, phases.PLAN)
    assert w.record is plan_record
    assert (w.matched, w.expected) == (2, 3)
    assert w.by_path() == pytest.approx({f"{STAGE}/{QUANT}": 180e-6, STAGE: 1004e-6,
                                         HEAD: 60e-6})
    assert w.replay_seconds() == pytest.approx(2 * 622e-6)


@pytest.mark.parametrize("metric, value", [
    ("infer_quantize_us", 90.0), ("infer_conv_us", 502.0), ("infer_head_us", 30.0),
    ("infer_stage_in_us", 36.0), ("graph_capture_ms", 250.0)])
def test_each_plan_metric(tmp_path, plan_record, metric, value):
    assert _read(metric, _infer_readings(tmp_path, _infer_events())) == pytest.approx(value)


def test_ops_outside_the_graph_are_charged_to_no_phase(tmp_path, plan_record):
    """The copies in and out and the copy to the host lie between replays:
    a phase holds only its replays' own operations, and a kernel the
    record names "" (any kernel) never takes a copy's place."""
    r = _infer_readings(tmp_path, _infer_events(lose=()))
    w = phases.window(r, phases.PLAN)
    assert w.matched == 3
    charged = {i + j for i in w.starts for j in range(plan_record.n_ops)}
    outside = [w.device[i][0] for i in range(len(w.device)) if i not in charged]
    assert len(outside) == 9 and all(n.startswith("Memcpy") for n in outside)
    assert phases.find([phases.COPY], ("",)) == []


def test_stage_in_counts_only_a_copy_before_a_replay(tmp_path, plan_record):
    """A replay with no copy in before it (a donated input) is left out of
    ``infer_stage_in_us``; with none, the metric is left out of the line."""
    events = _infer_events(lose=())
    copies_in = [e for e in events if e["name"].startswith("Memcpy DtoD") and e["dur"] == 36.0]
    copies_in[1].update(name=TANH, cat="kernel", dur=7.0)
    r = _infer_readings(tmp_path, events)
    assert phases.window(r, phases.PLAN).matched == 3
    assert _read("infer_stage_in_us", r) == pytest.approx(36.0)
    for e in copies_in:
        e.update(name=TANH, cat="kernel", dur=7.0)
    assert _read("infer_stage_in_us", _infer_readings(tmp_path, events)) is None


def test_the_record_with_most_replays_is_read(tmp_path, monkeypatch):
    small = _record(phases.PLAN, [DIV, ROUND, CONV], ((STAGE, 3),), id_=1)
    full = _record(phases.PLAN, [op for _, op, _, _ in PLAN_OPS], PLAN_PHASES, id_=2)
    monkeypatch.setattr(phases, "records", lambda: [full, small])
    w = phases.window(_infer_readings(tmp_path, _infer_events()), phases.PLAN)
    assert w.record is full and w.matched == 2


def test_no_registry_reads_nothing(tmp_path, monkeypatch):
    """A program without the capture registry: every new metric is left out
    of the line, and nothing raises."""
    monkeypatch.setattr(phases, "records", lambda: [])
    r = _infer_readings(tmp_path, _infer_events())
    for m in ("infer_quantize_us", "infer_conv_us", "infer_head_us", "infer_stage_in_us",
              "graph_capture_ms", "train_forward_ms", "train_backward_ms", "train_update_ms"):
        assert _read(m, r) is None


def test_the_ports_registry_is_read():
    from repro_torch import cuda_graphs

    assert phases.records() == cuda_graphs.graphs()


# The train graph: a schedule op outside every span, then the phases.
TRAIN_OPS = [("void lr_kernel(int)", "", 3.0),
             ("void bake_kernel(int)", FWD, 5.0),
             ("sc_pyramid_kernel(float const*, int)", f"{FWD}/{STAGE}", 160.0),
             ("void fake_quant_kernel(int)", f"{FWD}/{STAGE}", 20.0),
             (GEMM, f"{FWD}/{HEAD}", 15.0),
             ("void at::native::im2col_kernel<float>(int)", BWD, 5600.0),
             ("void at::native::col2im_kernel<float, float>(int)", BWD, 5600.0),
             ("Memset (Device)", BWD, 4.0),
             ("void multi_tensor_apply_kernel<Norm>(int)", UPD, 30.0),
             ("void multi_tensor_apply_kernel<AdamW>(int)", UPD, 70.0)]


def _train_table():
    table = []
    for _, path, _ in TRAIN_OPS:
        if table and table[-1][0] == path:
            table[-1] = (path, table[-1][1] + 1)
        else:
            table.append((path, 1))
    return tuple(table)


def test_each_train_metric(tmp_path, monkeypatch):
    ops = ["Memset" if n.startswith("Memset") else n for n, _, _ in TRAIN_OPS]
    monkeypatch.setattr(phases, "records",
                        lambda: [_record(phases.TRAIN, ops, _train_table(), first_call_s=0.8)])
    events, t = [], 100.0
    for step in range(2):
        events.append(_span("bench.step", 10.0 + 20000.0 * step, 900.0))
        events.append(_dev("void index_kernel(int)", t, 8.0))  # the batch's gather
        events.append(_dev("void multi_tensor_apply_kernel<Copy>(int)", t + 9.0, 12.0))
        t += 22.0
        for name, _, us in TRAIN_OPS:
            events.append(_dev(name, t, us, "gpu_memset" if name.startswith("Memset")
                               else "kernel"))
            t += us + 1.0
        events.append(_dev("void multi_tensor_apply_kernel<Copy>(int)", t, 12.0))
        t += 13.0
    cell = harness.make_cell(SPEC, "lenet5-q3.train", seed=2**31 + 9, seconds=1.0,
                             trace=True, device="cpu", t_start=time.perf_counter())
    r = Readings(cell=cell, trace=_trace(tmp_path, events), host_s={"step": [0.006]},
                 work={"steps": 2, "batch": 128, "window_s": 0.03}, peaks=dict(PEAKS))
    assert phases.window(r, phases.TRAIN).matched == 2
    assert _read("train_forward_ms", r) == pytest.approx(0.200)
    assert _read("train_backward_ms", r) == pytest.approx(11.204)
    assert _read("train_update_ms", r) == pytest.approx(0.100)
    assert _read("graph_capture_ms", r) == pytest.approx(800.0)
    assert _read("infer_quantize_us", r) is None


def test_accepted_metrics_read_as_before(tmp_path, monkeypatch):
    """Every accepted metric, the busy and idle reading and the breakdown
    on a fixed trace: the values they gave before the program had spans."""
    monkeypatch.setattr(phases, "records", lambda: [])
    r = _infer_readings(tmp_path, _infer_events())
    tr = r.trace
    assert len(tr.device) == 26 and [s[0] for s in tr.spans][:2] == ["bench.enqueue",
                                                                      "bench.to_host"]
    assert tr.window_s == pytest.approx(3590e-6)
    assert tr.busy_s == pytest.approx(1996e-6)
    assert tr.top_ops(3) == [[CONV.split("(")[0], pytest.approx(1500e-6)],
                             [DIV.split("(")[0], pytest.approx(150e-6)],
                             [ROUND.split("(")[0], pytest.approx(120e-6)]]
    assert tr.idle_gaps() == [["host: outside any span", pytest.approx(1002e-6)],
                              ["host: bench.wait", pytest.approx(592e-6)]]
    expected = {"infer_idle_share": 44.40111420612814, "infer_host_us": 300.0,
                "stream_conv_roofline": 10.173147650328449,
                "head_gemm_roofline": 40.45625313432826, "infer_mfu": 4.926767872855814}
    for metric, value in expected.items():
        assert _read(metric, r) == pytest.approx(value, rel=1e-9), metric
