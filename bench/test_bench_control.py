"""The comparison that decides ``correct`` fails what it must: the control
(the reference in the precision below the configuration's, in the
program's place) and a run of the harness with the timed path broken
underneath, for each fault a cell can have. At small sizes on the CPU; the
readings at the cells' sizes come from ``bench/control.py`` on the card."""
import time

import pytest

from bench import control, harness
from bench.correct import checks, load_limits

SPEC = harness.load_spec()
SMALL = {
    "infer": {"frames_per_request": 32, "pool_batches": 2, "warmup_seconds": 0.05},
    "train": {"batch": 16, "n_train_per_class": 8, "warmup_seconds": 0.05},
}


def _cell(name, seed=2**31 + 21, seconds=0.2):
    sizes = SMALL[name.split(".")[1]]
    return harness.make_cell(SPEC, name, seed=seed, seconds=seconds, trace=False, device="cpu",
                             t_start=time.perf_counter(), sizes=sizes)


CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(name):
    cell = _cell(name)
    values = control.readings(cell)["control"]
    limits = {k: v for k, v in load_limits(name).items() if k in values}
    found = checks(values, limits)
    assert found and not all(c.ok for c in found), found


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    line, _ = harness.run(SPEC, _cell(name))
    assert line["correct"], line["checks"]


def _altered_answer(monkeypatch):
    from repro_torch.core.dhm import engine

    forward = engine.forward

    def altered(plan, x):
        out = forward(plan, x).clone()
        out[0, 0] += 0.25
        return out

    monkeypatch.setattr(engine, "forward", altered)


def _half_the_frames(monkeypatch):
    from repro_torch.core.dhm import engine

    forward = engine.forward

    def half(plan, x):
        n = x.shape[0] // 2
        return forward(plan, x[:n]).repeat(2, 1)

    monkeypatch.setattr(engine, "forward", half)


def _state_unchanged(monkeypatch):
    from repro_torch.paper import train_cnn

    step = train_cnn.train_step

    def unchanged(params, opt_state, x, y, lr, **kw):
        _, _, loss, gnorm = step(params, opt_state, x, y, lr, **kw)
        return params, opt_state, loss, gnorm

    monkeypatch.setattr(train_cnn, "train_step", unchanged)


def _half_the_batch(monkeypatch):
    from repro_torch.paper import train_cnn

    step = train_cnn.train_step

    def half(params, opt_state, x, y, lr, **kw):
        n = x.shape[0] // 2
        return step(params, opt_state, x[:n], y[:n], lr, **kw)

    monkeypatch.setattr(train_cnn, "train_step", half)


FAULTS = {
    "infer": {"an answer altered": _altered_answer, "half the frames left out": _half_the_frames},
    "train": {"a step returns its state unchanged": _state_unchanged,
              "half the batch left out": _half_the_batch},
}


@pytest.mark.parametrize("name, fault", [(c, f) for c in CELLS for f in FAULTS[c.split(".")[1]]])
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[name.split(".")[1]][fault](monkeypatch)
    line, found = harness.run(SPEC, _cell(name))
    assert line["correct"] is False, line["checks"]
    assert any(not c.ok for c in found)
