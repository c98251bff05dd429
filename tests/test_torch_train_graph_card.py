"""The CNN training step as CUDA graphs on the card (``paper/train_cnn.py``
``jit_train_step``): one graph of the whole step (loss through the
compiled plan's kernels, its gradient, clipping, ``sched(step)`` and
AdamW) per (topology, quant mode, batch shape), with the QAT exponent
and the learning rate on the card.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card and the
CUDA toolkit (the kernels are built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_train_graph_card.py

This file imports no JAX: the machine with the card has none.

A replay runs the kernels the eager ``train_step`` runs with
``lr=sched(step)`` on the card, in the same order on the same shapes,
so every replay is held to the eager step bit for bit: the params, both
moments, the step count, the loss and the gradient norm. Covered: the
exponent formula against the CPU's near every power of two, the graph
against the eager step for lenet5 and cifar10 in fp32, 8/8 and 4/4-bit
QAT and pow2, one capture per key, memory over 100 replays, no
synchronisation in an eager step, a resilient run through the graph and
a collection inside the capture.
"""
import gc

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.quant import fixed_point as tfp  # noqa: E402
from repro_torch.data import make_image_dataset  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, linear_warmup_cosine  # noqa: E402
from repro_torch.paper.train_cnn import jit_train_step, train_step  # noqa: E402
from repro_torch.runtime import FaultInjector, ResilientTrainer  # noqa: E402
from repro_torch.tree_util import tree_flatten  # noqa: E402

pytestmark = pytest.mark.card

B, STEPS = 16, 5
CFG = AdamWConfig(weight_decay=0.01)
MODES = {"fp32": {}, "qat8": dict(weight_bits=8, act_bits=8),
         "qat4": dict(weight_bits=4, act_bits=4), "pow2": dict(pow2_weights=True)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _leaves(*trees):
    return [t for tree in trees for t in tree_flatten(tree)[0]]


def _setup(name, dev, batch=B, seed=0):
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(seed), topo, device=dev)
    ds = make_image_dataset(hw=topo.square_input_hw(), channels=topo.input_channels, seed=seed,
                            n_train_per_class=8)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(STEPS):
        idx = torch.from_numpy(rng.integers(0, ds.x_train.shape[0], batch))
        batches.append((ds.x_train[idx].to(dev), ds.y_train[idx].to(dev)))
    return topo, params, adamw_init(params, CFG), batches


def _eager(topo, params, opt, batches, sched, dev, **quant):
    out = []
    for s, (x, y) in enumerate(batches):
        step = torch.full((), s, dtype=torch.int32, device=dev)
        params, opt, loss, gnorm = train_step(params, opt, x, y, sched(step), topo=topo, cfg=CFG,
                                              **quant)
        out.append(_leaves(params, opt) + [loss, gnorm])
    return out


def test_exponent_formula_on_the_card_is_the_cpus(card):
    k = np.arange(-126, 128)
    bits = ((k + 127) << 23)[:, None] + np.arange(-1024, 1025)[None, :]
    v = torch.from_numpy(bits.reshape(-1).astype(np.int32).view(np.float32))
    want = tfp.ceil_log2_each(v)
    got = tfp.ceil_log2_each(v.to(card)).cpu()
    bad = torch.nonzero(got.view(torch.int32) != want.view(torch.int32)).flatten()
    assert bad.numel() == 0, [(float(v[i]), float(got[i]), float(want[i])) for i in bad[:5]]
    # The scale: torch.ldexp gives the exact power of two on the card too.
    e = torch.arange(-149, 128, dtype=torch.float32)
    assert torch.equal(torch.ldexp(torch.ones_like(e), e), torch.ldexp(torch.ones_like(e.to(card)),
                                                                       e.to(card)).cpu())


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", ["lenet5", "cifar10"])
def test_graph_is_the_eager_step_bit_for_bit(card, name, mode):
    topo, params, opt, batches = _setup(name, card)
    sched = linear_warmup_cosine(3e-3, 2, STEPS)
    want = _eager(topo, params, opt, batches, sched, card, **MODES[mode])
    step_fn = jit_train_step(topo, CFG, sched, **MODES[mode])
    kept = [t.clone() for t in _leaves(params, opt)]
    p, o = params, opt
    for s, (x, y) in enumerate(batches):
        given = _leaves(p, o)
        before = [t.clone() for t in given]
        p, o, loss, gnorm = step_fn(p, o, x, y, s)
        assert all(torch.equal(a, b) for a, b in zip(given, before)), s
        got = _leaves(p, o) + [loss, gnorm]
        assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want[s])), s
    assert all(torch.equal(a, b) for a, b in zip(_leaves(params, opt), kept))
    assert step_fn._cache_size() == 1


def test_one_capture_per_key_and_replays_count_the_forward_kernels(card):
    topo, params, opt, batches = _setup("lenet5", card)
    step_fn = jit_train_step(topo, CFG, linear_warmup_cosine(3e-3, 2, STEPS), pow2_weights=True)
    x, y = batches[0]
    step_fn(params, opt, x, y, 0)
    graph = next(iter(step_fn._graphs.values())).graph
    conv0, p20 = sum(kconv.LAUNCHES.values()), sum(kpow2.LAUNCHES.values())
    for s in range(1, 4):
        step_fn(params, opt, x, y, s)
    assert next(iter(step_fn._graphs.values())).graph is graph and step_fn._cache_size() == 1
    entry = next(iter(step_fn._graphs.values()))
    conv_a_replay = sum(1 for n, _ in entry.launches if n in kconv.LAUNCHES)
    p2_a_replay = sum(1 for n, _ in entry.launches if n in kpow2.LAUNCHES)
    assert conv_a_replay > 0 and p2_a_replay > 0
    assert sum(kconv.LAUNCHES.values()) - conv0 == 3 * conv_a_replay
    assert sum(kpow2.LAUNCHES.values()) - p20 == 3 * p2_a_replay
    step_fn(params, opt, x[:8], y[:8], 4)
    assert step_fn._cache_size() == 2


def test_memory_is_flat_over_100_replays(card):
    topo, params, opt, batches = _setup("lenet5", card)
    step_fn = jit_train_step(topo, CFG, linear_warmup_cosine(3e-3, 2, STEPS), weight_bits=8,
                             act_bits=8)
    x, y = batches[0]
    for s in range(2):
        step_fn(params, opt, x, y, s)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(card)
    for s in range(100):
        step_fn(params, opt, x, y, s)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(card) == before


@pytest.mark.parametrize("mode", sorted(MODES))
def test_an_eager_step_synchronises_nothing(card, mode):
    topo, params, opt, batches = _setup("lenet5", card)
    sched = linear_warmup_cosine(3e-3, 2, STEPS)
    step = torch.full((), 3, dtype=torch.int32, device=card)
    x, y = batches[0]
    train_step(params, opt, x, y, sched(step), topo=topo, cfg=CFG, **MODES[mode])  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = train_step(params, opt, x, y, sched(step), topo=topo, cfg=CFG, **MODES[mode])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out[2]))


def test_a_resilient_run_through_the_graph_replays_to_the_clean_run(card, tmp_path):
    """A failure before the first checkpoint (a cold restart from the
    state given, which the graph never wrote) and one after it."""
    topo, params, opt, _ = _setup("lenet5", card)
    ds = make_image_dataset(hw=28, channels=1, seed=0, n_train_per_class=4)
    xt, yt = ds.x_train.to(card), ds.y_train.to(card)
    sched = linear_warmup_cosine(3e-3, 20, 9)

    def batch_fn(step):
        idx = torch.from_numpy(np.random.default_rng(step).integers(0, 40, 8)).to(card)
        return xt[idx], yt[idx]

    finals = []
    for what, faults in (("clean", ()), ("faulty", (2, 7))):
        step_fn = jit_train_step(topo, CFG, sched, weight_bits=6, act_bits=6)

        def fn(state, batch, step, step_fn=step_fn):
            p, o, loss, _ = step_fn(*state, *batch, step)
            return (p, o), {"loss": float(loss)}

        tr = ResilientTrainer(fn, batch_fn, CheckpointManager(str(tmp_path / what)), ckpt_every=3,
                              fault_injector=FaultInjector(fail_at_steps=faults))
        finals.append((tr.run((params, opt), num_steps=9)[0], tr.restarts))
    (clean, _), (faulty, restarts) = finals
    assert restarts == 2 and int(faulty[1].step) == 9
    assert all(torch.equal(a, b) for a, b in zip(_leaves(faulty), _leaves(clean)))


def test_a_collection_inside_the_capture_voids_nothing(card):
    """An older step's graph, moved into a reference cycle at the
    capture's call of the schedule, is not torn down inside the capture
    (the capture sequence keeps the collector off)."""
    topo, params, opt, batches = _setup("lenet5", card)
    sched = linear_warmup_cosine(3e-3, 2, STEPS)
    x, y = batches[0]
    old = jit_train_step(topo, CFG, sched)
    old(params, opt, x, y, 0)
    parked, calls = [old], [0]

    def dropping(step):
        calls[0] += 1
        if calls[0] == 2 and parked:  # the capture's call (the first is the warm-up)
            cycle = [parked.pop()]
            cycle.append(cycle)
        return sched(step)

    del old
    step_fn = jit_train_step(topo, CFG, dropping, weight_bits=8, act_bits=8)
    thresholds = gc.get_threshold()
    gc.set_threshold(1)
    got, p, o = [], params, opt
    try:
        for s in range(2):  # the warm-up and capture, then a replay
            p, o, loss, gnorm = step_fn(p, o, x, y, s)
            got.append(_leaves(p, o) + [loss, gnorm])
    finally:
        gc.set_threshold(*thresholds)
    want = _eager(topo, params, opt, batches[:1] * 2, sched, card, weight_bits=8, act_bits=8)
    for g, w in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(g, w))
    assert step_fn._cache_size() == 1 and not parked
