"""The port's spans (``kernels/probe.py`` ``span``) and the capture
registry (``cuda_graphs.graphs``), on the CPU.

- With no profiler running and no capture open, a span is one shared
  no-op: it builds no ``record_function`` (patched here to raise) and
  records nothing, not even into an open dispatch log.
- Under ``torch.profiler``, the eager int8 plan's forward emits the
  ``dhm.stage`` spans, then ``dhm.head``; the quantization of a float
  frame to the kernel's codes (``ops._as_codes``, on the card's path:
  the plain path quantizes inside its reference) emits ``dhm.quantize``,
  and none for codes; the eager QAT ``train_step`` emits
  ``train.forward`` (the ``dhm.*`` spans inside it), ``train.backward``,
  ``train.update``, in that order and not overlapping.
- Inside a capture (its log open with a count of the graph's device
  operations) a span marks the log at entry and exit, and
  ``probe.phase_table`` cuts the count by the marks; operations added
  from another thread while the capturing thread waits inside a span
  (autograd's backward) fall to that span.
- ``JittedForward`` and ``JittedTrainStep`` keep the same counters; on the
  CPU nothing is captured, so they stay at 0.

The spans of captured graphs on the card, and a profiled replay's
operations against the phase table, are held in
``test_torch_spans_card.py``.
"""
import threading

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch import cuda_graphs  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.engine import JittedForward, forward  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.stream_conv.ops import _as_codes  # noqa: E402
from repro_torch.models.cnn import LENET5, init_cnn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.paper.train_cnn import jit_train_step, train_step  # noqa: E402

P = "repro_torch."
QUANT, STAGE, HEAD = P + "dhm.quantize", P + "dhm.stage", P + "dhm.head"
FWD, BWD, UPD = P + "train.forward", P + "train.backward", P + "train.update"


def _int8_plan():
    params = init_cnn(torch.Generator().manual_seed(0), LENET5, device="cpu")
    plan = compile_dhm(LENET5, params, device="cpu",
                       quant=QuantSpec(weight_bits=3, act_bits=3, int8_compute=True))
    return plan, torch.randn(2, 28, 28, 1, generator=torch.Generator().manual_seed(1))


def _step_args():
    params = init_cnn(torch.Generator().manual_seed(0), LENET5, device="cpu")
    cfg = AdamWConfig(weight_decay=0.01)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 28, 28, 1, generator=g)
    y = torch.randint(0, 10, (4,), generator=g)
    return params, adamw_init(params, cfg), x, y, cfg


def _spans(prof) -> list:
    """(name, start, end) of the profile's ``repro_torch.*`` spans, by start."""
    out = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
           if e.name.startswith(P)]
    return sorted(out, key=lambda t: (t[1], -t[2]))


def _within(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture
def no_record_function(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a span built a record_function with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)


def test_with_no_profiler_a_span_builds_nothing_and_records_nothing(no_record_function):
    plan, x = _int8_plan()
    assert probe.span(STAGE) is probe.span(HEAD)
    with probe.recording() as log, torch.no_grad():
        forward(plan, x)
        with probe.span(QUANT):
            pass
    assert log.marks == [] and log.spans == 0
    params, opt, x, y, cfg = _step_args()
    train_step(params, opt, x, y, 1e-3, topo=LENET5, cfg=cfg, weight_bits=3, act_bits=3)


def test_the_int8_plans_forward_names_its_phases_in_order():
    plan, x = _int8_plan()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.no_grad():
            forward(plan, x)
    spans = _spans(prof)
    names = [n for n, _, _ in spans]
    assert names == [STAGE] * plan.n_stages + [HEAD]
    stages = spans[:-1]
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:]))
    assert max(e for _, _, e in stages) <= spans[-1][1]


def test_quantizing_a_float_frame_to_codes_is_its_own_span():
    x = torch.randn(2, 28, 28, 1, generator=torch.Generator().manual_seed(1))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with probe.span(STAGE):
            codes = _as_codes(x, 3)
        _as_codes(codes, 3)  # codes already: no quantization, no span
    spans = _spans(prof)
    assert [n for n, _, _ in spans] == [STAGE, QUANT] and _within(spans[1], spans[0])
    assert codes.dtype == torch.int8


def test_the_qat_train_step_names_its_phases_in_order():
    params, opt, x, y, cfg = _step_args()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        train_step(params, opt, x, y, 1e-3, topo=LENET5, cfg=cfg, weight_bits=3, act_bits=3)
    spans = _spans(prof)
    top = [s for s in spans if s[0].startswith(P + "train.")]
    assert [n for n, _, _ in top] == [FWD, BWD, UPD]
    assert top[0][2] <= top[1][1] and top[1][2] <= top[2][1]
    inner = [s for s in spans if s[0].startswith(P + "dhm.")]
    assert {n for n, _, _ in inner} == {STAGE, HEAD}
    assert all(_within(s, top[0]) for s in inner)


class _FakeGraph:
    """A count of device operations that launches add to, from any thread."""

    def __init__(self):
        self.n = 0
        self.lock = threading.Lock()

    def launch(self, k=1):
        with self.lock:
            self.n += k

    def __call__(self):
        return self.n


def test_a_capture_marks_its_spans_and_the_table_cuts_by_them(no_record_function):
    g = _FakeGraph()
    with probe.recording() as log, probe.capturing(12345, log, g):
        g.launch(2)  # outside every span
        with probe.span(FWD):
            g.launch()
            with probe.span(STAGE):
                with probe.span(QUANT):
                    g.launch(3)
                g.launch(4)
            with probe.span(HEAD):
                pass  # no operation: left out of the table
        with probe.span(BWD):
            # autograd's device thread launches while this thread waits
            t = threading.Thread(target=lambda: (g.launch(5), probe.span(STAGE).__enter__()))
            t.start()
            t.join()
        with probe.span(UPD):
            g.launch(2)
        g.launch(1)
    assert log.nodes is None and log.spans == 0
    assert len(log.marks) == 12
    assert log.marks[0] == (FWD, 1, True, 2) and log.marks[-1] == (UPD, 1, False, 17)
    assert probe.phase_table(log.marks, g()) == (
        ("", 2), (FWD, 1), (f"{FWD}/{STAGE}/{QUANT}", 3), (f"{FWD}/{STAGE}", 4),
        (BWD, 5), (UPD, 2), ("", 1))
    # With no profiler and the capture closed, the span is the no-op again.
    assert probe.span(FWD) is probe.span(BWD)


def test_phase_table_merges_neighbours_of_one_path():
    marks = [(STAGE, 1, True, 0), (STAGE, 1, False, 3), (STAGE, 1, True, 3),
             (STAGE, 1, False, 5), (HEAD, 1, True, 5), (HEAD, 1, False, 6)]
    assert probe.phase_table(marks, 6) == ((STAGE, 5), (HEAD, 1))
    assert probe.phase_table([], 4) == (("", 4),)
    assert probe.phase_table([], 0) == ()


def test_the_graph_owners_keep_the_same_counters_and_nothing_is_captured_on_the_cpu():
    plan, x = _int8_plan()
    fwd = plan.jitted_forward()
    assert isinstance(fwd, JittedForward)
    before = len(cuda_graphs.graphs())
    plan(x)
    plan(x)
    assert (fwd.staged, fwd.captures, fwd.replays) == (0, 0, 0) and fwd._cache_size() == 1
    params, opt, xb, yb, cfg = _step_args()
    step = jit_train_step(LENET5, cfg, lambda s: 1e-3, weight_bits=3, act_bits=3)
    step(params, opt, xb, yb, 0)
    assert step.captures == step.replays == 0 and step.staged > 0
    assert len(cuda_graphs.graphs()) == before


def test_a_record_keeps_its_first_call():
    rec = cuda_graphs.GraphRecord(id=1, owner="JittedForward", key="((2, 28, 28, 1),)",
                                  phases=((STAGE, 2),), ops=("k", "Memcpy"), warmup_s=0.1,
                                  release_s=0.0, capture_s=0.2)
    assert rec.n_ops == 2 and rec.first_call_s == 0.0
    cuda_graphs.first_call_done(rec, 0.0)
    assert rec.first_call_s > 0
