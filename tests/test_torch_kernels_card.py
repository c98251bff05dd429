"""The hand-written CUDA kernels on the card, held against their plain
PyTorch versions on the same CUDA tensors.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card and the
CUDA toolkit (the kernels are built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_kernels_card.py

This file imports no JAX: the machine with the card has none.

Tolerances: fp32 rtol=1e-4, atol=1e-5 (the reference's own; both sides
sum in IEEE fp32, TF32 off, in different orders). With ``act_bits`` the
outputs are equal except where a sum in another order crosses a rounding
boundary: those elements sit exactly one quant step apart, and at most
``MAX_STEP_SHARE`` of them may.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core.dhm import Engine, QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm.fusion import plan_fusion_groups  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import (  # noqa: E402
    stream_conv2d,
    stream_conv_block,
    stream_conv_block_ref,
    stream_conv_pyramid,
    stream_conv_pyramid_ref,
)
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, ConvLayerSpec, cnn_apply_reference, init_cnn  # noqa: E402

pytestmark = pytest.mark.card

NAMES = sorted(ALL_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
MAX_STEP_SHARE = 1e-3
BATCH = 16


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _assert_matches(out, ref, act_bits, what):
    torch.cuda.synchronize()
    assert out.shape == ref.shape, what
    if act_bits is None:
        torch.testing.assert_close(out, ref, **FP32, msg=what)
        return
    step = stream_quant_spec(act_bits).scale
    d = (out - ref).abs()
    off = d > 1e-6
    assert float(d.max()) <= step * (1 + 1e-5), what
    assert bool(torch.allclose(d[off], torch.full_like(d[off], step), rtol=1e-5)), what
    assert int(off.sum()) <= MAX_STEP_SHARE * d.numel(), (what, int(off.sum()))


def _frames(dev, seed, b, h, w, c):
    x = np.random.default_rng(seed).normal(size=(b, h, w, c)).astype(np.float32)
    return torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("act_bits", [None, 6])
def test_pyramid_matches_its_plain_version(card, name, act_bits):
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(1), topo, device=card)
    h, w = topo.input_shape
    x = _frames(card, 2, BATCH, h, w, topo.input_channels)
    (grp,) = plan_fusion_groups(topo, tuple(range(len(topo.conv_layers))))
    layers = [topo.conv_layers[i] for i in grp.layers]
    ws = [params["conv"][i]["w"] for i in grp.layers]
    bs = [params["conv"][i]["b"] for i in grp.layers]
    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers), act_bits=act_bits)
    for block_rows in (grp.block_rows, 1):
        before = kconv.LAUNCHES["stream_conv_pyramid"]
        out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=act_bits,
                                  block_rows=block_rows)
        assert kconv.LAUNCHES["stream_conv_pyramid"] == before + 1
        _assert_matches(out, ref, act_bits, f"{name} block_rows={block_rows}")


@pytest.mark.parametrize("name", ["cifar10", "cifar10_full", "cifar10_strided", "lenet5"])
@pytest.mark.parametrize("act_bits", [None, 6])
def test_single_layer_kernel_matches_its_plain_version(card, name, act_bits):
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(3), topo, device=card)
    h, w = topo.input_shape
    c = topo.input_channels
    for li, spec in enumerate(topo.conv_layers):
        x = _frames(card, 10 + li, BATCH, h, w, c)
        p = params["conv"][li]
        kw = dict(padding=spec.padding, stride=spec.stride, act=spec.act, pool=spec.pool,
                  pool_stride=spec.pool_stride, act_bits=act_bits)
        before = kconv.LAUNCHES["stream_conv_fused"]
        out = stream_conv_block(x, p["w"], p["b"], **kw)
        assert kconv.LAUNCHES["stream_conv_fused"] == before + 1
        _assert_matches(out, stream_conv_block_ref(x, p["w"], p["b"], **kw), act_bits,
                        f"{name} layer {li}")
        h, w = spec.out_hw(h, w)
        c = spec.n_out


@pytest.mark.parametrize("frame,stride,pool,pool_stride,block_r",
                         [((21, 27), 1, 2, None, 2), ((19, 23), 2, 0, None, 3),
                          ((25, 18), 1, 3, 2, 4), ((13, 16), 1, 2, 3, 1)])
def test_single_layer_kernel_over_odd_frames_and_blocks(card, frame, stride, pool,
                                                        pool_stride, block_r):
    rng = np.random.default_rng(4)
    h, w = frame
    x = torch.from_numpy(rng.normal(size=(3, h, w, 5)).astype(np.float32)).to(card)
    wt = torch.from_numpy(rng.normal(size=(3, 3, 5, 7)).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.normal(size=(7,)).astype(np.float32)).to(card)
    for padding in ("SAME", "VALID"):
        kw = dict(padding=padding, stride=stride, act="relu", pool=pool,
                  pool_stride=pool_stride)
        out = stream_conv_block(x, wt, b, block_r=block_r, **kw)
        _assert_matches(out, stream_conv_block_ref(x, wt, b, **kw), None,
                        f"{frame} {padding} block_r={block_r}")
        # The bare conv is the same kernel with no epilogue.
        out = stream_conv2d(x, wt, padding=padding, stride=stride, block_r=block_r)
        ref = stream_conv_block_ref(x, wt, torch.zeros_like(b), padding=padding,
                                    stride=stride, act="none", pool=0)
        _assert_matches(out, ref, None, f"stream_conv2d {frame} {padding}")


@pytest.mark.parametrize("vmem_budget", [None, 0])
def test_compiled_plan_and_engine_on_the_card(card, vmem_budget):
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(5), topo, device=card)
    plan = compile_dhm(topo, params, quant=QuantSpec(), vmem_budget=vmem_budget)
    x = _frames(card, 6, BATCH, 32, 32, 3)
    kconv.reset_launch_counts()
    logits = plan(x)
    kernel = "stream_conv_pyramid" if vmem_budget is None else "stream_conv_fused"
    assert kconv.LAUNCHES[kernel] == len(plan.fusion_groups)
    torch.testing.assert_close(logits, cnn_apply_reference(params, topo, x),
                               rtol=1e-4, atol=1e-4)
    with Engine(plan, microbatch=8) as eng:
        reqs = [eng.submit(x[i : i + n].cpu()) for i, n in ((0, 3), (3, 8), (11, 5))]
        outs = [r.result(timeout=60.0) for r in reqs]
    torch.testing.assert_close(torch.cat(outs), logits.cpu(), rtol=1e-4, atol=1e-4)
    assert eng.rung == "fused" and eng.demotions == [] and eng.stats().n_retries == 0


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    x = torch.zeros((2, 12, 12, 3), device=card)
    w = torch.zeros((3, 3, 3, 4), device=card)
    b = torch.zeros(4, device=card)
    with pytest.raises(ValueError, match="float32"):
        kconv.stream_conv_fused_cuda(x.double(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        kconv.stream_conv_fused_cuda(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="shape"):
        kconv.stream_conv_fused_cuda(x, w, b[:3])
    # A whole-frame block of three wide layers needs more than a Hopper
    # block's 232,448 B of shared memory: the wrapper raises, it never
    # falls back.
    spec = ConvLayerSpec(n_out=64, kernel=5, padding="SAME", act="relu")
    geom = group_geometry(96, 96, 3, as_pyramid_layers([spec] * 3), (5,) * 3, (64,) * 3)
    assert kconv.pyramid_smem_bytes(geom) > kconv.SMEM_LIMIT
    ws = [torch.zeros((5, 5, c, 64), device=card) for c in (3, 64, 64)]
    with pytest.raises(ValueError, match="shared memory"):
        kconv.stream_conv_pyramid_cuda(torch.zeros((1, 96, 96, 3), device=card), ws,
                                       [torch.zeros(64, device=card)] * 3, geom=geom,
                                       act_bits=(None,) * 3)
