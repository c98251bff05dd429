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
``MAX_STEP_SHARE`` of them may. The int8 kernels sum integers exactly, so
they are held equal on the relu topologies; where tanh follows, the
card's ``tanhf`` and the plain version's ``torch.tanh`` may still put an
element one quant step apart (counted, as above). ``pow2_matmul``'s
integer mode is held equal, its fp32 mode at rtol 1e-5 / atol 1e-6 on
activations on a 2^-4 grid (every partial sum exact in float32).
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.core.dhm import Engine, QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.quant.fixed_point import dynamic_spec, quantize_fixed  # noqa: E402
from repro_torch.core.dhm.fusion import plan_fusion_groups  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import (  # noqa: E402
    stream_conv2d,
    stream_conv_block,
    stream_conv_block_ref,
    stream_conv_pyramid,
    stream_conv_pyramid_ref,
)
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.pow2_matmul import (  # noqa: E402
    pow2_matmul,
    pow2_matmul_int_ref,
    pow2_matmul_ref,
    quantize_weights,
)
from repro_torch.kernels.stream_conv.epilogue import Int8Scales, stream_quant_spec  # noqa: E402
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


# ---------------------------------------------------------------------------
# int8 kernels and pow2_matmul.


def _bake_int8(w, bits):
    spec = dynamic_spec(w, bits)
    return quantize_fixed(w, spec).to(torch.int8).contiguous(), spec.scale


def _assert_int8_matches(out, ref, act_bits, act, what):
    if act == "relu":
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (what, float((out - ref).abs().max()))
    else:
        _assert_matches(out, ref, act_bits, what)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("act_bits", [8, 6])
def test_int8_pyramid_matches_its_plain_version(card, name, act_bits):
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(1), topo, device=card)
    h, w = topo.input_shape
    x = _frames(card, 2, BATCH, h, w, topo.input_channels)
    (grp,) = plan_fusion_groups(topo, tuple(range(len(topo.conv_layers))), elem_bytes=1)
    layers = [topo.conv_layers[i] for i in grp.layers]
    baked = [_bake_int8(params["conv"][i]["w"], act_bits) for i in grp.layers]
    ws = [c for c, _ in baked]
    bs = [params["conv"][i]["b"] for i in grp.layers]
    scales = tuple(Int8Scales(in_bits=act_bits, w_scale=s) for _, s in baked)
    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers),
                                  act_bits=act_bits, int8_scales=scales)
    for block_rows in (grp.block_rows, 1):
        before = dict(kconv.LAUNCHES)
        out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=act_bits,
                                  int8_scales=scales, block_rows=block_rows)
        assert kconv.LAUNCHES["stream_conv_pyramid_int8"] == before["stream_conv_pyramid_int8"] + 1
        assert kconv.LAUNCHES["stream_conv_pyramid"] == before["stream_conv_pyramid"]
        _assert_int8_matches(out, ref, act_bits, layers[0].act, f"{name} block_rows={block_rows}")


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("act_bits", [8, 6])
def test_int8_single_layer_kernel_matches_its_plain_version(card, name, act_bits):
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(3), topo, device=card)
    h, w = topo.input_shape
    c = topo.input_channels
    for li, spec in enumerate(topo.conv_layers):
        x = _frames(card, 10 + li, BATCH, h, w, c)
        wq, ws = _bake_int8(params["conv"][li]["w"], act_bits)
        b = params["conv"][li]["b"]
        kw = dict(padding=spec.padding, stride=spec.stride, act=spec.act, pool=spec.pool,
                  pool_stride=spec.pool_stride, act_bits=act_bits,
                  int8_scales=Int8Scales(in_bits=act_bits, w_scale=ws))
        before = kconv.LAUNCHES["stream_conv_fused_int8"]
        out = stream_conv_block(x, wq, b, **kw)
        assert kconv.LAUNCHES["stream_conv_fused_int8"] == before + 1
        _assert_int8_matches(out, stream_conv_block_ref(x, wq, b, **kw), act_bits, spec.act,
                             f"{name} layer {li}")
        h, w = spec.out_hw(h, w)
        c = spec.n_out


@pytest.mark.parametrize("m,k,n", [(256, 1024, 64), (256, 64, 10), (256, 800, 500),
                                   (256, 500, 10), (5, 33, 7)])
def test_pow2_matmul_matches_its_plain_version(card, m, k, n):
    rng = np.random.default_rng(m + k + n)
    w = torch.from_numpy((rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)).to(card)
    x = np.clip(np.round(rng.normal(size=(m, k)) * 16) / 16, -2.0, 1.9375)
    x = torch.from_numpy(x.astype(np.float32)).to(card)
    packed, scale = quantize_weights(w)
    before = dict(kpow2.LAUNCHES)
    out = pow2_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert kpow2.LAUNCHES["pow2_matmul"] == before["pow2_matmul"] + 1
    torch.testing.assert_close(out, pow2_matmul_ref(x, packed, scale), rtol=1e-5, atol=1e-6)
    for bits in (8, 6):
        spec = stream_quant_spec(bits)
        out = pow2_matmul(x, packed, scale, x_spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(out, pow2_matmul_int_ref(x, packed, scale, x_spec=spec)), bits
    assert kpow2.LAUNCHES["pow2_matmul_int"] == before["pow2_matmul_int"] + 2


def test_int8_launches_refuse_float_operands(card):
    x = torch.zeros((2, 12, 12, 4), device=card)
    w = torch.zeros((3, 3, 4, 4), device=card)
    b = torch.zeros(4, device=card)
    sc = Int8Scales(in_bits=8, w_scale=2.0 ** -7)
    with pytest.raises(ValueError, match="x must be int8"):
        kconv.stream_conv_fused_cuda(x, w.to(torch.int8), b, act_bits=8, int8_scales=sc)
    with pytest.raises(ValueError, match="w must be int8"):
        kconv.stream_conv_fused_cuda(x.to(torch.int8), w, b, act_bits=8, int8_scales=sc)
    with pytest.raises(ValueError, match="int8_scales requires act_bits"):
        kconv.stream_conv_fused_cuda(x.to(torch.int8), w.to(torch.int8), b, int8_scales=sc)
    spec = ConvLayerSpec(n_out=4, kernel=3, padding="SAME", act="relu")
    geom = group_geometry(12, 12, 4, as_pyramid_layers([spec] * 2), (3, 3), (4, 4))
    with pytest.raises(ValueError, match="x must be int8"):
        kconv.stream_conv_pyramid_cuda(x, [w.to(torch.int8)] * 2, [b] * 2, geom=geom,
                                       act_bits=(8, 8), int8_scales=(sc, sc))
    with pytest.raises(ValueError, match=r"weights\[0\] must be int8"):
        kconv.stream_conv_pyramid_cuda(x.to(torch.int8), [w] * 2, [b] * 2, geom=geom,
                                       act_bits=(8, 8), int8_scales=(sc, sc))
    # The wrappers above the kernels refuse float weights before any launch.
    with pytest.raises(ValueError, match="int8_scales requires int8 weight codes"):
        stream_conv_block(x, w, b, padding="SAME", act_bits=8, int8_scales=sc)
    packed, scale = quantize_weights(torch.ones((16, 4), device=card))
    with pytest.raises(ValueError, match="x must be int8"):
        kpow2.pow2_matmul_cuda(torch.zeros((3, 16), device=card), packed, scale, x_scale=0.25)
    with pytest.raises(ValueError, match="x must be float32"):
        kpow2.pow2_matmul_cuda(torch.zeros((3, 16), device=card, dtype=torch.int8), packed, scale)


def test_int8_and_pow2_plans_on_the_card(card):
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(5), topo, device=card)
    spec = stream_quant_spec(8)
    x = _frames(card, 6, BATCH, 32, 32, 3)
    x = torch.clamp(torch.round(x / spec.scale), spec.qmin, spec.qmax) * spec.scale
    fq = compile_dhm(topo, params, quant=QuantSpec(weight_bits=8, act_bits=8))
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    for budget, kernel in ((None, "stream_conv_pyramid_int8"), (0, "stream_conv_fused_int8")):
        i8 = compile_dhm(topo, params, quant=QuantSpec(weight_bits=8, act_bits=8,
                                                       int8_compute=True), vmem_budget=budget)
        assert torch.equal(i8(x), fq(x)), budget
        assert kconv.LAUNCHES[kernel] == len(i8.fusion_groups)
    q = QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8))
    plan = compile_dhm(topo, params, quant=q)
    logits = plan(x)
    assert kpow2.LAUNCHES["pow2_matmul_int"] == 2
    with Engine(plan, microbatch=8) as eng:
        reqs = [eng.submit(x[i : i + n].cpu()) for i, n in ((0, 3), (3, 8), (11, 5))]
        outs = [r.result(timeout=60.0) for r in reqs]
    assert torch.equal(torch.cat(outs), logits.cpu())
    assert eng.rung == "fused" and eng.demotions == [] and eng.stats().n_retries == 0
    p2 = compile_dhm(topo, params, quant=QuantSpec(pow2_weights=True))
    before = kpow2.LAUNCHES["pow2_matmul"]
    torch.testing.assert_close(
        p2(x), cnn_apply_reference(params, topo, x, pow2_weights=True), rtol=1e-4, atol=1e-4
    )
    assert kpow2.LAUNCHES["pow2_matmul"] == before + 2
