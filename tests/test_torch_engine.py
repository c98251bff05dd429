"""The port's serving Engine on the CPU: mixed request sizes, deadlines,
admission policies, the gate, the ladder's demotion, stop()."""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import threading  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402

from repro_torch.core.dhm import (  # noqa: E402
    DeadlineExceeded,
    Engine,
    FlusherWedged,
    InvalidRequest,
    QuantSpec,
    Rejected,
    Shed,
    compile_dhm,
)
from repro_torch.models.cnn import LENET5, init_cnn  # noqa: E402

FP32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def plan():
    params = init_cnn(torch.Generator().manual_seed(0), LENET5, device="cpu")
    return compile_dhm(LENET5, params, quant=QuantSpec(weight_bits=6, act_bits=6),
                       device="cpu")


def _frames(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 28, 28, 1)).astype(np.float32)


def test_mixed_request_sizes_match_the_plan(plan):
    eng = Engine(plan, microbatch=4)
    xs = [_frames(n, i) for i, n in enumerate([1, 3, 4, 6, 2, 9])]
    reqs = [eng.submit(x) for x in xs]
    assert eng.flush() == sum(x.shape[0] for x in xs)
    assert eng.flush() == 0  # empty queue: a no-op
    for x, r in zip(xs, reqs):
        np.testing.assert_allclose(r.result().numpy(), plan(x).numpy(), **FP32)
    single = _frames(1, 99)[0]
    np.testing.assert_allclose(eng.infer(single).numpy(), plan(single[None]).numpy(), **FP32)
    st = eng.stats()
    assert st.n_ok == 7 and st.n_errors == 0 and st.n_frames == 26
    assert st.n_batches == 7 + 1 and eng.rung == "fused" and eng.demotions == []
    assert "rung fused" in st.summary()
    eng.reset_stats()
    assert eng.stats().n_requests == 0 and eng.stats().n_ok == 0


def test_deadlines_and_background_flusher(plan):
    with Engine(plan, microbatch=4, auto_flush=True, flush_interval_ms=2.0) as eng:
        reqs = [eng.submit(_frames(n, n), deadline_ms=5_000.0) for n in (1, 2, 5, 3)]
        for r in reqs:
            assert r.result(timeout=30.0).shape == (r.n_frames, 10)
        assert eng.stats().n_ok == 4
    late = Engine(plan, microbatch=4)
    req = late.submit(_frames(2, 1), deadline_ms=1.0)
    time.sleep(0.01)
    late.flush()
    with pytest.raises(DeadlineExceeded):
        req.result()
    assert late.stats().n_deadline_exceeded == 1


def test_admission_policies(plan):
    eng = Engine(plan, microbatch=4, max_queue=2, admission="reject")
    a, b, c = (eng.submit(_frames(1, i)) for i in range(3))
    with pytest.raises(Rejected):
        c.result()
    eng.flush()
    assert a.ok and b.ok and eng.stats().n_rejected == 1

    eng = Engine(plan, microbatch=4, max_queue=2, admission="shed_oldest")
    a, b, c = (eng.submit(_frames(1, i)) for i in range(3))
    eng.flush()
    with pytest.raises(Shed):
        a.result()
    assert b.ok and c.ok and eng.stats().n_shed == 1

    eng = Engine(plan, microbatch=4, max_queue=1, admission="block")
    a, b = eng.submit(_frames(1, 0)), eng.submit(_frames(1, 1))  # b drains a inline
    assert a.done and not b.done
    eng.flush()
    assert b.ok

    with pytest.raises(ValueError, match="admission policy"):
        Engine(plan, admission="drop")


def test_gate_rejects_bad_frames(plan):
    eng = Engine(plan, microbatch=4)
    bad = _frames(2, 0)
    bad[1, 3, 3, 0] = np.nan
    with pytest.raises(InvalidRequest):
        eng.submit(bad).result()
    with pytest.raises(InvalidRequest):
        eng.submit(np.ones((1, 28, 28, 1), np.int32)).result()
    with pytest.raises(ValueError, match="expected frames of shape"):
        eng.submit(np.ones((2, 28, 27, 1), np.float32))
    assert eng.stats().n_invalid == 2


def test_persistent_fused_failure_demotes_to_per_layer(plan):
    eng = Engine(plan, microbatch=4, max_retries=1, retry_backoff_s=1e-4)

    def broken(xb):
        raise RuntimeError("fused rung down")

    eng._fwd = broken
    x = _frames(3, 5)
    np.testing.assert_allclose(eng.infer(x).numpy(), plan(x).numpy(), **FP32)
    assert eng.rung == "per_layer"
    assert [d["rung"] for d in eng.demotions] == ["fused"]
    assert eng.stats().n_retries == 1


def test_stop_raises_when_the_flusher_is_wedged(plan):
    eng = Engine(plan, microbatch=4, dispatch_timeout_s=None, auto_flush=True,
                 flush_interval_ms=1.0)
    release = threading.Event()
    fwd = eng._fwd

    def stuck(xb):
        release.wait(10.0)
        return fwd(xb)

    eng._fwd = stuck
    first = eng.submit(_frames(1, 0))
    time.sleep(0.05)  # the flusher picks `first` up and blocks
    queued = eng.submit(_frames(1, 1))
    try:
        with pytest.raises(FlusherWedged):
            eng.stop(join_timeout_s=0.2)
        with pytest.raises(Shed):
            queued.result()
    finally:
        release.set()
    assert first.result(timeout=10.0).shape == (1, 10)
