"""The stream-conv group's gradient on the card: the hand-written backward
kernels (``csrc/stream_conv_bwd.cu``, through ``ops._GroupGrad``) against
autograd of the group's composition in float64.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card and the
CUDA toolkit (the kernels are built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_stream_conv_bwd_card.py

This file imports no JAX: the machine with the card has none.

The reference is the composition of ``ref.py`` (conv, + bias, act,
``F.max_pool2d``, the fake-quant's straight-through mask) in float64 on
the CPU, at the plan's baked weights. fp32: each gradient within a
relative L2 error of ``F64_REL_L2`` (IEEE fp32 sums in another order).
Fake-quant: the frames, weights and biases lie on grids that make every
conv sum exact in float32, and the reference takes its tanh in float32
on the card, so both sides quantize the same values and mask the same
elements; the gradients are then held as tightly. Covered: every topology
in fp32 and 6-bit QAT, as fusion groups and as single layers, every leaf
(the frame, each layer's weights and biases); tied pool windows, relu at
an exact zero, elements the fake-quant clips, per-layer act bits, batches
of one to five frames; launches and dispatches; two calls bit for bit and
a graph replay bit for bit the eager call.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import numpy as np  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.analysis.invariants import planned_backward_launches  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.quant.fixed_point import fake_quant_dynamic, fake_quant_ste  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import ref as kref  # noqa: E402
from repro_torch.kernels.stream_conv import stream_conv_block, stream_conv_pyramid  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import normalize_pool, stream_quant_spec  # noqa: E402
from repro_torch.kernels.stream_conv.halo import PyramidLayer, as_pyramid_layers  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402
from repro_torch.tree_util import tree_flatten  # noqa: E402

pytestmark = pytest.mark.card

NAMES = sorted(ALL_TOPOLOGIES)
F64_REL_L2 = 1e-5
BITS = 6
BATCH = 8


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _on_grid(t: torch.Tensor, frac_bits: int, bound: float) -> torch.Tensor:
    return torch.clamp(torch.round(t * 2.0 ** frac_bits), -bound * 2.0 ** frac_bits,
                       bound * 2.0 ** frac_bits - 1) / 2.0 ** frac_bits


def _compose64(x, weights, biases, layers, bits, tanh_on):
    """``ref.py``'s per-layer composition in float64, its tanh taken in
    float32 on ``tanh_on`` where the layer quantizes (the kernels' own
    rounding of an exact sum), else in float64."""
    h = x
    for layer, w, b, nb in zip(layers, weights, biases, bits):
        y = kref._conv_nhwc(h, w, stride=layer.stride, padding=layer.padding,
                            dtype=torch.float64) + b
        if layer.act == "relu":
            y = torch.maximum(y, y.new_zeros(()))
        elif layer.act == "tanh":
            if nb is None:
                y = torch.tanh(y)
            else:  # the float32 tanh's value, its derivative 1 - t^2
                t32 = torch.tanh(y.detach().to(tanh_on, torch.float32)).to("cpu", torch.float64)
                y = _Tanh32.apply(y, t32)
        pw, ps = normalize_pool(layer.pool, layer.pool_stride)
        if pw:
            y = F.max_pool2d(y.permute(0, 3, 1, 2), pw, ps).permute(0, 2, 3, 1)
        if nb is not None:
            y = fake_quant_ste(y, stream_quant_spec(nb))
        h = y
    return h


class _Tanh32(torch.autograd.Function):
    """The value ``t32`` (tanh in float32), the derivative 1 - t32^2."""

    @staticmethod
    def forward(ctx, y, t32):
        ctx.save_for_backward(t32)
        return t32.clone()

    @staticmethod
    def backward(ctx, g):
        (t32,) = ctx.saved_tensors
        return g * (1 - t32 * t32), None


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _inputs(topo, quant: bool, batch=BATCH, seed=0):
    rng = np.random.default_rng(seed)
    h, w = topo.input_shape
    x = torch.from_numpy(rng.normal(size=(batch, h, w, topo.input_channels)).astype(np.float32))
    params = init_cnn(torch.Generator().manual_seed(seed), topo, device="cpu")
    for layer in params["conv"]:
        layer["b"] = torch.from_numpy(rng.normal(0, 0.05, size=layer["b"].shape).astype(np.float32))
    if quant:
        x = _on_grid(x, BITS - 2, 2.0)
        for layer in params["conv"]:
            layer["w"] = fake_quant_dynamic(layer["w"], BITS).detach()
            layer["b"] = _on_grid(layer["b"], 10, 1.0)
    return x, params


def _group_grads(topo, params, x, dev, quant, vmem_budget):
    """(features, gradients of sum(features * r) for the frame and every
    baked conv weight and bias) through the compiled plan on ``dev``."""
    leaves, treedef = tree_flatten(params)
    leaves = [t.to(dev).requires_grad_() for t in leaves]
    plan = compile_dhm(topo, treedef.unflatten(leaves), quant=QuantSpec(**quant), device=dev,
                       vmem_budget=vmem_budget)
    xd = x.to(dev).requires_grad_()
    feats = plan.features(xd)
    r = torch.from_numpy(np.random.default_rng(1).normal(size=feats.shape).astype(np.float32))
    ws = [p["w"] for p in plan.conv_params]
    bs = [p["b"] for p in plan.conv_params]
    grads = torch.autograd.grad((feats * r.to(dev)).sum(), [xd, *ws, *bs])
    return feats.detach(), grads, plan, r, [w.detach() for w in ws], [b.detach() for b in bs]


def _reference(topo, x, ws, bs, r, bits, dev):
    leaves = [t.detach().cpu().double().requires_grad_() for t in (x, *ws, *bs)]
    n = len(ws)
    layers = as_pyramid_layers(topo.conv_layers)
    y = _compose64(leaves[0], leaves[1:1 + n], leaves[1 + n:], layers, (bits,) * n, dev)
    grads = torch.autograd.grad((y * r.double()).sum(), leaves)
    return y.detach(), grads


@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("mode", ["fp32", "qat"])
@pytest.mark.parametrize("name", NAMES)
def test_every_leaf_gradient_equals_the_float64_composition(card, name, mode, vmem_budget):
    topo = ALL_TOPOLOGIES[name]
    quant = dict(act_bits=BITS) if mode == "qat" else {}
    x, params = _inputs(topo, mode == "qat")
    feats, got, plan, r, ws, bs = _group_grads(topo, params, x, card, quant, vmem_budget)
    want_feats, want = _reference(topo, x, ws, bs, r, quant.get("act_bits"), card)
    if mode == "qat":
        assert torch.equal(feats.cpu().double(), want_feats)
    errs = [_rel(a, b) for a, b in zip(got, want)]
    assert max(errs) <= F64_REL_L2, errs
    for a in got:
        assert bool(torch.isfinite(a).all())


def _one_layer(dev, *, x, w, b, layer, bits):
    xd, wd, bd = (t.to(dev).requires_grad_() for t in (x, w, b))
    out = stream_conv_block(xd, wd, bd, padding=layer.padding, stride=layer.stride,
                            act=layer.act, pool=layer.pool, pool_stride=layer.pool_stride,
                            act_bits=bits)
    r = torch.from_numpy(np.random.default_rng(2).normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad((out * r.to(dev)).sum(), [xd, wd, bd])
    leaves = [t.double().requires_grad_() for t in (x, w, b)]
    y = _compose64(leaves[0], [leaves[1]], [leaves[2]], (layer,), (bits,), dev)
    want = torch.autograd.grad((y * r.double()).sum(), leaves)
    return got, want


@pytest.mark.parametrize("pool,pool_stride", [(2, None), (3, 2), (0, None)])
def test_a_tied_window_sends_its_gradient_to_the_first_element(card, pool, pool_stride):
    """A zero frame: every conv output is its bias, every window tied; dx
    tells which element took the gradient."""
    layer = PyramidLayer(padding="SAME", stride=1, act="tanh", pool=pool, pool_stride=pool_stride)
    x = torch.zeros(2, 9, 9, 3)
    w = torch.from_numpy(np.random.default_rng(3).normal(size=(3, 3, 3, 8)).astype(np.float32))
    b = torch.linspace(-0.5, 0.5, 8)
    got, want = _one_layer(card, x=x, w=w, b=b, layer=layer, bits=None)
    for a, e in zip(got, want):
        assert _rel(a, e) <= F64_REL_L2


def test_relu_at_an_exact_zero_takes_half_the_gradient(card):
    layer = PyramidLayer(padding="VALID", stride=1, act="relu", pool=2)
    x = torch.zeros(3, 8, 8, 2)
    x[:, ::3] = 1.0
    w = torch.ones(3, 3, 2, 4) * torch.tensor([1.0, -1.0, 0.0, 0.5])
    b = torch.zeros(4)
    got, want = _one_layer(card, x=x, w=w, b=b, layer=layer, bits=None)
    for a, e in zip(got, want):
        assert _rel(a, e) <= F64_REL_L2
    assert float(got[2][2]) != 0.0  # channel 2 sums to 0 everywhere: half the gradient


def test_the_fake_quant_mask_drops_clipped_elements(card):
    layer = PyramidLayer(padding="SAME", stride=1, act="relu", pool=2)
    rng = np.random.default_rng(4)
    x = _on_grid(torch.from_numpy(rng.normal(size=(4, 10, 10, 3)).astype(np.float32)), 2, 2.0)
    w = _on_grid(torch.from_numpy(rng.normal(size=(3, 3, 3, 6)).astype(np.float32)), 3, 4.0)
    w[..., -1] = 0.0
    b = torch.tensor([0.0, 0.5, 1.0, 1.5, 2.0, 3.0])
    got, want = _one_layer(card, x=x, w=w, b=b, layer=layer, bits=3)
    for a, e in zip(got, want):
        assert _rel(a, e) <= F64_REL_L2
    assert float(got[2][-1]) == 0.0  # every output of the last channel clipped


@pytest.mark.parametrize("batch", [1, 3, 5])
def test_batches_that_leave_shares_ragged(card, batch):
    topo = ALL_TOPOLOGIES["cifar10"]
    x, params = _inputs(topo, False, batch=batch, seed=batch)
    feats, got, plan, r, ws, bs = _group_grads(topo, params, x, card, {}, None)
    _, want = _reference(topo, x, ws, bs, r, None, card)
    assert max(_rel(a, b) for a, b in zip(got, want)) <= F64_REL_L2


def test_per_layer_act_bits_and_strides(card):
    layers = (PyramidLayer("SAME", 2, "relu", 0), PyramidLayer("VALID", 1, "relu", 2),
              PyramidLayer("SAME", 1, "none", 3, 2))
    bits = (6, None, 4)
    rng = np.random.default_rng(5)
    x = _on_grid(torch.from_numpy(rng.normal(size=(4, 21, 19, 3)).astype(np.float32)), 4, 2.0)
    shapes = ((5, 5, 3, 8), (3, 3, 8, 12), (3, 3, 12, 16))
    ws = [_on_grid(torch.from_numpy(rng.normal(0, 0.3, size=s).astype(np.float32)), 6, 2.0)
          for s in shapes]
    bs = [_on_grid(torch.from_numpy(rng.normal(0, 0.1, size=s[3]).astype(np.float32)), 8, 1.0)
          for s in shapes]
    leaves = [t.to(card).requires_grad_() for t in (x, *ws, *bs)]
    out = stream_conv_pyramid(leaves[0], leaves[1:4], leaves[4:], layers=layers, act_bits=bits)
    r = torch.from_numpy(rng.normal(size=out.shape).astype(np.float32))
    got = torch.autograd.grad((out * r.to(card)).sum(), leaves)
    ref = [t.double().requires_grad_() for t in (x, *ws, *bs)]
    y = _compose64(ref[0], ref[1:4], ref[4:], layers, bits, card)
    assert torch.equal(out.detach().cpu().double(), y.detach())
    want = torch.autograd.grad((y * r.double()).sum(), ref)
    assert max(_rel(a, b) for a, b in zip(got, want)) <= F64_REL_L2


@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("name", NAMES)
def test_a_backward_launches_only_the_backward_kernels(card, name, vmem_budget):
    topo = ALL_TOPOLOGIES[name]
    x, params = _inputs(topo, False)
    _group_grads(topo, params, x, card, {}, vmem_budget)  # builds and warms up
    kconv.reset_launch_counts()
    with probe.recording() as log:
        _, _, plan, _, _, _ = _group_grads(topo, params, x, card, {}, vmem_budget)
    torch.cuda.synchronize()
    bwd = [d for d in log.dispatches if d[1] == "stream_conv_pyramid_bwd"]
    assert [d for d in log.dispatches if d[2]] == []
    assert len(bwd) == len(plan.fusion_groups)
    # The frame requires grad here: the first group's dx is planned too.
    want = planned_backward_launches(plan, frame_grad=True)
    assert sum(kconv.LAUNCHES[k] for k in kconv.BACKWARD_KERNELS) == want
    assert sum(1 for _, n, _ in log.launches if n in kconv.BACKWARD_KERNELS) == want


def test_two_calls_and_a_graph_replay_are_bit_for_bit(card):
    topo = ALL_TOPOLOGIES["cifar10"]
    x, params = _inputs(topo, True, batch=32)
    quant = dict(act_bits=BITS)
    first = _group_grads(topo, params, x, card, quant, None)[1]
    second = _group_grads(topo, params, x, card, quant, None)[1]
    assert all(torch.equal(a, b) for a, b in zip(first, second))

    layers = as_pyramid_layers(topo.conv_layers)
    xs = x.to(card)
    ws = [p["w"].to(card) for p in params["conv"]]
    bs = [p["b"].to(card) for p in params["conv"]]
    g = torch.randn(32, 4, 4, 64, generator=torch.Generator().manual_seed(6)).to(card)
    run = lambda: kconv.stream_conv_pyramid_bwd_cuda(  # noqa: E731
        xs, ws, bs, g, layers=layers, act_bits=(BITS,) * 3, need_dx=True)
    eager = run()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()  # warm-up on the side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = run()
    graph.replay()
    torch.cuda.synchronize()
    flat = lambda t: [t[0], *t[1], *t[2]]  # noqa: E731
    assert all(torch.equal(a, b) for a, b in zip(flat(static), flat(eager)))
