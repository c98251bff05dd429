"""The LM train step as CUDA graphs on the card (``launch/steps.py``
``JittedTrainStep``, ``jit_train_step``): one graph of the whole step
(the forward through the scan kernel, ``torch.autograd.grad`` with
remat's recompute on autograd's device thread, clipping and AdamW) per
(batch, trees), the parameters and optimizer state donated.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card and the
CUDA toolkit (the scan kernel is built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_lm_train_graph_card.py

This file imports no JAX: the machine with the card has none.

A replay runs the kernels the eager ``make_train_step`` step runs, in the
same order on the same shapes, so every replay is held to the eager step
bit for bit: the params, the f32 master copy, both moments, the step
count and the metrics (by exact checksums of their bits: the eager run
first, then the graph's, so that one run is on the card at a time).
Covered: falcon-mamba-7b at full width, 2 layers, bf16 with the master
copy and full remat, B=2, S=256 (chip_smoke.py phase 5o (a) at 2
layers; 5o holds the two side by side, leaf for leaf); the scan counted at each replay as eager counts it, 2 a layer
with remat "full" (the forward, and the recompute on autograd's thread)
and 1 with "none"; an eager launch from another thread during a capture
kept out of the capture's log.
"""
import dataclasses
import gc
import threading

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

from repro_torch import cuda_graphs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import TokenStreamConfig, synthetic_token_batches  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.ssm_scan.scan import ssm_scan_cuda  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import params_shapes  # noqa: E402
from repro_torch.launch.steps import jit_train_step, make_train_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree_util import tree_leaves  # noqa: E402

pytestmark = pytest.mark.card

LAYERS, B, S, STEPS = 2, 2, 256, 3
BITS = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    # Earlier tests' graphs in reference cycles hold their private pools
    # until a collection: free them before a step this size.
    gc.collect()
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    gc.collect()
    torch.cuda.empty_cache()


def _meta(cfg):
    return params_shapes(cfg, make_mesh((1, 1), ("data", "model"), device="cpu"))[0]


def _batches(cfg, dev, b, s, n):
    it = synthetic_token_batches(TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=s,
                                                   batch_size=b), seed=0)
    return [{"tokens": torch.from_numpy(next(it)["tokens"]).to(dev)} for _ in range(n)]


def _init(cfg, opt_cfg, dev):
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    return params, adamw_init(params, opt_cfg)


def _digest(tree) -> torch.Tensor:
    """Per leaf, two exact int64 checksums of its bits: the sum of its
    elements' bit patterns and that sum weighted by position mod 65,521.
    Trees equal bit for bit have equal digests; a leaf whose bits differ
    anywhere changes them but for a chance cancellation."""
    out = []
    for t in tree_leaves(tree):
        bits = t.detach().reshape(-1).view(BITS[t.element_size()])
        total = weighted = torch.zeros((), dtype=torch.int64, device=t.device)
        for i in range(0, bits.numel(), 1 << 24):
            chunk = bits[i:i + (1 << 24)].long()
            pos = torch.arange(i, i + chunk.numel(), device=t.device) % 65521 + 1
            total, weighted = total + chunk.sum(), weighted + (chunk * pos).sum()
        out.append(torch.stack([total, weighted]))
    return torch.stack(out)


def _graph_against_eager(cfg, opt_cfg, batches, dev):
    """Eager ``make_train_step`` over ``batches`` from one seeded state,
    then ``jit_train_step`` (each call's trees handed back) from the same
    state: every step's params, optimizer state and metrics bit for bit
    (their digests equal; the two runs one after the other, so a card
    left fragmented by earlier tests holds one run at a time). Returns
    the jitted step, the scan launches each jitted call counted and the
    leaves of the state."""
    eager = make_train_step(cfg, opt_cfg=opt_cfg)
    p, o = _init(cfg, opt_cfg, dev)
    want = []
    for batch in batches:
        p, o, m = eager(p, o, batch)
        want.append(_digest((p, o, m)))
    del p, o, m
    gc.collect()
    torch.cuda.empty_cache()
    jitted, _ = jit_train_step(cfg, None, _meta(cfg), batches[0], opt_cfg=opt_cfg)
    p, o = _init(cfg, opt_cfg, dev)
    scans = []
    for s, batch in enumerate(batches):
        before = kscan.LAUNCHES["ssm_scan"]
        p, o, m = jitted(p, o, batch, s)
        scans.append(kscan.LAUNCHES["ssm_scan"] - before)
        got = _digest((p, o, m))
        assert got.shape == want[s].shape
        bad = torch.nonzero((got != want[s]).any(-1)).flatten().tolist()
        assert not bad, (s, bad[:8])
    torch.cuda.synchronize()
    return jitted, scans, len(tree_leaves((p, o)))


def test_falcon_mamba_graph_is_the_eager_step_bit_for_bit(card):
    cfg = dataclasses.replace(get_arch("falcon-mamba-7b"), n_layers=LAYERS)
    assert cfg.dtype == "bfloat16" and cfg.remat == "full"
    opt_cfg = AdamWConfig(keep_master_copy=True)
    jitted, scans, n_leaves = _graph_against_eager(cfg, opt_cfg, _batches(cfg, card, B, S, STEPS),
                                                   card)
    assert jitted._cache_size() == 1 and jitted.captures == 1 and jitted.replays == STEPS - 1
    # The first call's warm-up counts as an eager step, each replay as its
    # capture: 2 a layer.
    assert scans == [2 * LAYERS] * STEPS
    # Only the first call's trees were staged; the others were handed back.
    assert jitted.staged == n_leaves
    entry = next(iter(jitted._graphs.values()))
    assert entry.opt_state.master is not None


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_a_replay_counts_the_scan_as_eager_does(card, remat, per_layer):
    cfg = dataclasses.replace(get_arch("falcon-mamba-7b").scaled_down(), remat=remat)
    n_layers = cfg.n_layers
    opt_cfg = AdamWConfig()
    batches = _batches(cfg, card, 2, 64, 3)
    jitted, scans, _ = _graph_against_eager(cfg, opt_cfg, batches, card)
    assert scans == [per_layer * n_layers] * 3
    entry = next(iter(jitted._graphs.values()))
    assert [n for n, _ in entry.launches] == ["ssm_scan"] * (per_layer * n_layers)
    # A replay logs them on the calling thread's open log too.
    with probe.recording() as log:
        jitted(entry.params, entry.opt_state, batches[0], 3)
    assert [n for _, n, _ in log.launches] == ["ssm_scan"] * (per_layer * n_layers)


def test_another_threads_eager_launch_stays_out_of_a_capture(card):
    bz, s, d, n = 2, 16, 256, 16
    g = torch.Generator().manual_seed(0)

    def inputs():
        x = torch.randn(bz, s, d, generator=g).to(card)
        dt = torch.rand(bz, s, d, generator=g).to(card) * 0.1
        b_ = torch.randn(bz, s, n, generator=g).to(card)
        c_ = torch.randn(bz, s, n, generator=g).to(card)
        a = -torch.rand(d, n, generator=g).to(card)
        return x, dt, b_, c_, a, torch.randn(d, generator=g).to(card)

    mine, theirs = inputs(), inputs()
    # The other thread's stream comes from the high-priority pool, never
    # the capture's side stream.
    other = torch.cuda.Stream(card, priority=-1)
    ready, done = threading.Event(), threading.Event()
    errors = []

    def tenant():
        ready.wait(30)
        try:
            with torch.cuda.stream(other):
                ssm_scan_cuda(*theirs)
            other.synchronize()
        except Exception as e:  # noqa: BLE001 — reported by the test
            errors.append(e)
        done.set()

    def fn():
        y, _ = ssm_scan_cuda(*mine)
        if torch.cuda.is_current_stream_capturing():
            ready.set()
            assert done.wait(30)
        return y

    thread = threading.Thread(target=tenant)
    thread.start()
    before = kscan.LAUNCHES["ssm_scan"]
    cap = cuda_graphs.capture(fn, card, torch.cuda.Stream(card))
    thread.join()
    assert not errors, errors
    # The capture logged its own launch alone; the warm-up and the
    # tenant's launch are real and counted, the capture's taken back.
    assert cap.launches == (("ssm_scan", cap.launches[0][1]),)
    assert kscan.LAUNCHES["ssm_scan"] - before == 2
    cap.graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(cap.out, cap.warm)
