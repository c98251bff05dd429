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
activations on a 2^-4 grid (every partial sum exact in float32). The
selective scan and the seed conv at the fp32 tolerance (both compute in
f32); the scaled-down falcon-mamba on the card against the CPU: f32
logits at rtol/atol 1e-4, bf16 by a relative L2 error under 3e-2.
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
from repro_torch.kernels.backends import sm_count  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.pow2_matmul import (  # noqa: E402
    pow2_matmul,
    pow2_matmul_int_ref,
    pow2_matmul_ref,
    quantize_weights,
)
from repro_torch.kernels.stream_conv.epilogue import Int8Scales, stream_quant_spec  # noqa: E402
from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, ConvLayerSpec, cnn_apply_reference, init_cnn  # noqa: E402

pytestmark = pytest.mark.card

NAMES = sorted(ALL_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
MAX_STEP_SHARE = 1e-3
BATCH = 16

# (B, H, W, C, N, K) of the seed conv on the card: the kernel bench's
# shape at B=8 and B=256 (the 2 x 4 and the 4 x 8 register tiles), an odd
# frame, a 1x1 conv over 70 channels; a strip edge (h_out = 33, one more
# than 8 strips of 4 rows), h_out = 1 with N = 7, C = 1 with K = 7 (and
# N = 7), B=16, N split across two CTAs (64 column groups), C = 32, whose
# ring takes a padded column stride; and both tiles at C of 1, 4 and 5.
SEED_CARD_CASES = (
    (8, 36, 36, 3, 32, 5), (256, 36, 36, 3, 32, 5), (3, 13, 17, 5, 7, 3), (2, 9, 9, 70, 40, 1),
    (256, 37, 36, 3, 32, 5), (2, 5, 9, 3, 7, 5), (1, 12, 12, 1, 4, 7), (3, 14, 13, 1, 7, 7),
    (16, 36, 36, 3, 32, 5), (1, 8, 132, 3, 32, 5), (2, 10, 20, 32, 8, 3),
    (256, 36, 36, 1, 32, 5), (16, 36, 36, 4, 32, 5), (8, 36, 36, 5, 32, 5),
)
# (B, H, W, C, N, K) of the seed conv on frames whose ring of K + 1 whole
# rows exceeds a block: column strips.
SEED_STRIP_CASES = ((1, 4, 4000, 4, 4, 3), (2, 9, 3000, 16, 8, 5))
# (M, K, N) of pow2_matmul at the edges of its K split: K = 1, K = BK - 1,
# K = 8 BK + 3, and the K that pick each cluster size (1, 2, 4, 8), all at
# an odd N; then several tiles in both directions.
POW2_CARD_CASES = ((5, 1, 7), (5, 31, 7), (5, 259, 7), (5, 128, 7), (5, 1024, 7), (37, 259, 131))


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


# The fp32 kernels at the edges of their register tile (16 windows x 2
# groups of TN = 4 or 8 channels per warp, K in stages of 64): (batch, H,
# W, C, N, K, stride, pool, pool_stride, padding, act, block_r of the
# single-layer kernel, block_rows of the pyramid). N 10, 20 and 50 are
# no multiple of the tile (50 is no multiple of 4 either: 4-byte weight
# copies); C 1 and 3 give K = 25, 9, 75; the frames give window counts
# that are no multiple of 16; every case has more than one row block; the
# last one is wide enough for TN = 8 with N = 50 (a clamped channel group).
EDGE_CASES = [
    (1, 13, 17, 1, 10, 5, 1, 2, None, "SAME", "relu", 2, 1),
    (257, 21, 19, 3, 20, 3, 1, 3, 2, "SAME", "tanh", 4, 2),
    (2, 23, 25, 20, 50, 3, 2, 0, None, "VALID", "relu", 3, 3),
    (3, 18, 22, 32, 10, 5, 1, 2, None, "SAME", "none", 2, 2),
    (257, 28, 14, 3, 50, 5, 2, 2, None, "SAME", "relu", 1, 1),
    (2, 40, 44, 3, 50, 5, 1, 2, None, "SAME", "relu", 16, 10),
]


@pytest.mark.parametrize("case", EDGE_CASES, ids=lambda c: "b{}_{}x{}_c{}_n{}_k{}_s{}_p{}".format(*c))
@pytest.mark.parametrize("act_bits", [None, 6])
def test_fp32_kernels_at_the_tile_edges(card, case, act_bits):
    b_, h, w, c, n, k, stride, pool, pool_stride, padding, act, block_r, block_rows = case
    rng = np.random.default_rng(sum(case[:6]))

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(card)

    x = t(b_, h, w, c)
    wt, b = t(k, k, c, n, scale=(2.0 / (k * k * c)) ** 0.5), t(n, scale=0.1)
    kw = dict(padding=padding, stride=stride, act=act, pool=pool, pool_stride=pool_stride,
              act_bits=act_bits)
    before = dict(kconv.LAUNCHES)
    out = stream_conv_block(x, wt, b, block_r=block_r, **kw)
    assert kconv.LAUNCHES["stream_conv_fused"] == before["stream_conv_fused"] + 1
    _assert_matches(out, stream_conv_block_ref(x, wt, b, **kw), act_bits, f"single layer {case}")
    # The same layer, then a SAME 3x3 layer of 20 channels, as one pyramid.
    layers = [ConvLayerSpec(n_out=n, kernel=k, padding=padding, stride=stride, act=act,
                            pool=pool, pool_stride=pool_stride),
              ConvLayerSpec(n_out=20, kernel=3, padding="SAME", act="relu", pool=0)]
    ws, bs = [wt, t(3, 3, n, 20, scale=(2.0 / (9 * n)) ** 0.5)], [b, t(20, scale=0.1)]
    geom = group_geometry(h, w, c, as_pyramid_layers(layers), (k, 3), (n, 20),
                          block_rows=block_rows)
    assert geom.n_row_blocks > 1
    out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=act_bits, block_rows=block_rows)
    assert kconv.LAUNCHES["stream_conv_pyramid"] == before["stream_conv_pyramid"] + 1
    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers), act_bits=act_bits)
    _assert_matches(out, ref, act_bits, f"pyramid {case}")


@pytest.mark.parametrize("vmem_budget", [None, 0])
def test_compiled_plan_and_engine_on_the_card(card, vmem_budget):
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(5), topo, device=card)
    plan = compile_dhm(topo, params, quant=QuantSpec(), vmem_budget=vmem_budget)
    x = _frames(card, 6, BATCH, 32, 32, 3)
    kconv.reset_launch_counts()
    logits = plan(x)
    kernel = "stream_conv_pyramid" if vmem_budget is None else "stream_conv_fused"
    # plan(x) runs the plan's CUDA graph: a shape's first call runs the
    # plan once eagerly before the capture, then replays it, one launch a
    # group each time.
    assert kconv.LAUNCHES[kernel] == 2 * len(plan.fusion_groups)
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
    # The seed kernel: one channel group of 11 x 11 x 121 weights above a
    # Hopper block, which no column strip makes smaller.
    from repro_torch.kernels.stream_conv import legacy as klegacy

    for (b_, h_, w_, c_, n_, k_) in ((1, 11, 11, 121, 4, 11),):
        with pytest.raises(ValueError, match="shared memory"):
            klegacy.stream_conv2d_seed_cuda(torch.zeros((b_, h_, w_, c_), device=card),
                                            torch.zeros((k_ * k_, c_, n_), device=card), k=k_)


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


def _pow2_operands(dev, m, k, n, seed, on_grid=True):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)).to(dev)
    x = rng.normal(size=(m, k))
    if on_grid:
        x = np.clip(np.round(x * 16) / 16, -2.0, 1.9375)
    packed, scale = quantize_weights(w)
    return torch.from_numpy(x.astype(np.float32)).to(dev), packed, scale


@pytest.mark.parametrize("m,k,n", POW2_CARD_CASES)
def test_pow2_matmul_at_the_edges_of_its_k_split(card, m, k, n):
    """Every cluster size the plan picks, in both modes: fp32 on the 2^-4
    grid at the tolerance above, the integer mode bit for bit."""
    x, packed, scale = _pow2_operands(card, m, k, n, seed=m * k + n)
    split = kpow2.p2_plan(m, k, n, sm_count(card))["split"]
    torch.testing.assert_close(pow2_matmul(x, packed, scale), pow2_matmul_ref(x, packed, scale),
                               rtol=1e-5, atol=1e-6, msg=f"fp32 {(m, k, n)} split {split}")
    for bits in (8, 6):
        spec = stream_quant_spec(bits)
        out = pow2_matmul(x, packed, scale, x_spec=spec)
        torch.cuda.synchronize()
        assert torch.equal(out, pow2_matmul_int_ref(x, packed, scale, x_spec=spec)), (bits, split)


@pytest.mark.parametrize("m,k,n", [(256, 1024, 64), (5, 259, 7)])
def test_pow2_matmul_split_is_deterministic(card, m, k, n):
    """Off the grid the split's fp32 sum is an ordinary sum in a fixed
    order: two calls give the same bits. Against the plain version (cuBLAS,
    another order) it is held at the fp32 tolerance of sums in different
    orders; the 2^-4 grid's tighter one holds only where the sums are exact."""
    x, packed, scale = _pow2_operands(card, m, k, n, seed=3, on_grid=False)
    assert kpow2.p2_plan(m, k, n, sm_count(card))["split"] > 1
    first = pow2_matmul(x, packed, scale)
    second = pow2_matmul(x, packed, scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, pow2_matmul_ref(x, packed, scale), **FP32)


@pytest.mark.parametrize("x_off,code_off", [(1, 0), (2, 3), (3, 1), (0, 2)])
def test_pow2_matmul_reads_byte_views_at_any_offset(card, x_off, code_off):
    """The int8 codes and the packed weights as contiguous views 1-3 bytes
    into their storage: the kernel stages the aligned words around them and
    shifts, so both modes give what they give on aligned copies."""
    m, k, n = 37, 259, 131
    x, packed, scale = _pow2_operands(card, m, k, n, seed=x_off + 4 * code_off)
    spec = stream_quant_spec(8)
    qx = torch.clamp(torch.round(x / spec.scale), spec.qmin, spec.qmax).to(torch.int8)

    def shifted(t, off):
        buf = torch.zeros(t.numel() + off, device=card, dtype=t.dtype)
        view = buf[off:].view(t.shape)
        view.copy_(t)
        assert view.is_contiguous() and view.data_ptr() % 4 == off % 4
        return view

    codes = shifted(packed, code_off)
    out = kpow2.pow2_matmul_cuda(shifted(qx, x_off), codes, scale, x_scale=spec.scale)
    torch.cuda.synchronize()
    assert torch.equal(out, pow2_matmul_int_ref(qx, packed, scale, x_spec=spec))
    torch.testing.assert_close(kpow2.pow2_matmul_cuda(x, codes, scale),
                               pow2_matmul_ref(x, packed, scale), rtol=1e-5, atol=1e-6)


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
        # The first call of the plan's CUDA graph: the eager warm-up and the replay.
        assert kconv.LAUNCHES[kernel] == 2 * len(i8.fusion_groups)
    q = QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8))
    plan = compile_dhm(topo, params, quant=q)
    logits = plan(x)
    assert kpow2.LAUNCHES["pow2_matmul_int"] == 2 * 2  # warm-up and replay, 2 FC layers
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
    assert kpow2.LAUNCHES["pow2_matmul"] == before + 2 * 2  # warm-up and replay, 2 FC layers


# ---------------------------------------------------------------------------
# The selective scan, the seed conv and the Mamba LM.

# (Bz, S, D, N, x/B/C dtype, with h0): the falcon-mamba layer at prefill
# (bf16 and f32, zero and carried state), decode (S = 1, with and without
# state), one sequence (Bz 1), a D no CTA's channels divide (8200, 200),
# N of 3, 4, 32 and 64 (the kernel took at most 16 before), and S of 7
# (a step group cut short).
SSM_CASES = [
    (4, 512, 8192, 16, torch.bfloat16, False),
    (4, 512, 8192, 16, torch.float32, True),
    (4, 1, 8192, 16, torch.bfloat16, True),
    (4, 1, 8192, 16, torch.float32, False),
    (1, 512, 8192, 16, torch.bfloat16, True),
    (2, 7, 8200, 16, torch.bfloat16, True),
    (2, 37, 200, 16, torch.float32, True),
    (3, 20, 64, 3, torch.bfloat16, False),
    (2, 7, 512, 4, torch.float32, True),
    (2, 512, 520, 32, torch.bfloat16, False),
    (1, 7, 8200, 64, torch.float32, True),
    (2, 1, 1024, 64, torch.bfloat16, False),
]


def _ssm_inputs(dev, bz, s, d, n, dtype, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(a.astype(np.float32)).to(dev).to(dt)

    return (t(rng.normal(size=(bz, s, d)) * 0.5, dtype),
            t(np.logaddexp(0.0, rng.normal(size=(bz, s, d)))),
            t(rng.normal(size=(bz, s, n)), dtype), t(rng.normal(size=(bz, s, n)), dtype),
            t(-np.exp(rng.normal(size=(d, n)) * 0.3)), t(rng.normal(size=(d,))),
            t(rng.normal(size=(bz, d, n))))


@pytest.mark.parametrize("bz,s,d,n,dtype,with_h0", SSM_CASES)
def test_ssm_scan_matches_its_plain_version(card, bz, s, d, n, dtype, with_h0):
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref

    x, dt, b, c, a, d_skip, h0 = _ssm_inputs(card, bz, s, d, n, dtype)
    h0 = h0 if with_h0 else None
    before = kscan.LAUNCHES["ssm_scan"]
    y, h_last = ssm_scan(x, dt, b, c, a, d_skip, h0)
    assert kscan.LAUNCHES["ssm_scan"] == before + 1
    y_ref, h_ref = ssm_scan_ref(x, dt, b, c, a, d_skip, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **FP32)
    torch.testing.assert_close(h_last, h_ref, **FP32)


def test_ssm_scan_reads_strided_views_of_one_projection(card):
    """mamba_apply hands the kernel B and C as slices of x_proj's output."""
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.ssm_scan import ssm_scan_ref

    x, dt, b, c, a, d_skip, h0 = _ssm_inputs(card, 2, 33, 512, 16, torch.bfloat16, seed=1)
    proj = torch.cat([torch.zeros_like(b[..., :5]), b, c], dim=-1)
    b_v, c_v = proj[..., 5:21], proj[..., 21:]
    assert not b_v.is_contiguous()
    y, h_last = kscan.ssm_scan_cuda(x, dt, b_v, c_v, a, d_skip, h0)
    y_ref, h_ref = ssm_scan_ref(x, dt, b, c, a, d_skip, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **FP32)
    torch.testing.assert_close(h_last, h_ref, **FP32)
    with pytest.raises(ValueError, match="unit stride"):
        kscan.ssm_scan_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dt, b, c, a, d_skip)
    with pytest.raises(ValueError, match="dt must be float32"):
        kscan.ssm_scan_cuda(x, dt.to(torch.bfloat16), b, c, a, d_skip)
    with pytest.raises(ValueError, match="b must be bfloat16"):
        kscan.ssm_scan_cuda(x, dt, b.float(), c, a, d_skip)


@pytest.mark.parametrize("b,h,w,c,n,k", SEED_CARD_CASES)
def test_seed_conv_matches_its_plain_version(card, b, h, w, c, n, k):
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.kernels.stream_conv import stream_conv2d_ref, stream_conv2d_seed

    x = _frames(card, 7, b, h, w, c)
    wt = _frames(card, 8, k, k, c, n) * 0.2
    before = klegacy.LAUNCHES["stream_conv2d_seed"]
    out = stream_conv2d_seed(x, wt.reshape(k * k, c, n), k=k)
    assert klegacy.LAUNCHES["stream_conv2d_seed"] == before + 1
    _assert_matches(out, stream_conv2d_ref(x, wt), None, f"seed {(b, h, w, c, n, k)}")


# A shape at which scan.scan_plan picks each compiled (lanes, states a lane)
# tile on an H100 (132 SMs): (Bz, S, D, N, tile). N picks the states a lane;
# Bz * D the lanes at N 4 and 16 (fewer lanes where the grid fills the card).
SCAN_TILE_CASES = [
    (2, 5, 40, 1, (1, 1)), (2, 9, 100, 2, (2, 1)), (4, 3, 8192, 4, (2, 2)),
    (2, 7, 328, 4, (4, 1)), (2, 9, 328, 8, (4, 2)), (4, 9, 8192, 16, (2, 8)),
    (2, 9, 8192, 16, (4, 4)), (1, 9, 8192, 16, (8, 2)), (2, 45, 328, 16, (16, 1)),
    (2, 9, 328, 32, (4, 8)), (2, 9, 328, 64, (4, 16)), (2, 9, 328, 128, (4, 32)),
    (2, 9, 328, 256, (8, 32)), (1, 9, 200, 512, (16, 32)),
]


@pytest.mark.parametrize("bz,s,d,n,tile", SCAN_TILE_CASES)
def test_ssm_scan_at_every_tile_the_plan_picks(card, bz, s, d, n, tile):
    """Each compiled kernel, at a shape the plan gives it, at the fp32
    tolerance: the lanes' order of the y sum changes nothing it can see."""
    from repro_torch.kernels.backends import sm_count
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.ssm_scan import ssm_scan_ref

    p = kscan.scan_plan(bz, s, d, n, n_sms=sm_count(card))
    if sm_count(card) == 132:
        assert (p["lanes"], p["npl"]) == tile
    x, dt, b, c, a, d_skip, h0 = _ssm_inputs(card, bz, s, d, n, torch.bfloat16, seed=2)
    y, h_last = kscan.ssm_scan_cuda(x, dt, b, c, a, d_skip, h0)
    y_ref, h_ref = ssm_scan_ref(x, dt, b, c, a, d_skip, h0)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, **FP32)
    torch.testing.assert_close(h_last, h_ref, **FP32)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_ssm_scan_reads_states_at_any_offset(card, offset):
    """A and h0 as contiguous views ``offset`` floats into their storage
    (not 16-byte aligned): the kernel reads them a float at a time."""
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.kernels.ssm_scan import ssm_scan_ref

    x, dt, b, c, a, d_skip, h0 = _ssm_inputs(card, 2, 33, 512, 16, torch.bfloat16, seed=3)

    def shifted(t):
        v = torch.empty(t.numel() + offset, device=card)[offset:].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16
        return v

    for a_, h0_ in ((shifted(a), h0), (a, shifted(h0)), (shifted(a), shifted(h0))):
        y, h_last = kscan.ssm_scan_cuda(x, dt, b, c, a_, d_skip, h0_)
        y_ref, h_ref = ssm_scan_ref(x, dt, b, c, a, d_skip, h0)
        torch.cuda.synchronize()
        torch.testing.assert_close(y, y_ref, **FP32)
        torch.testing.assert_close(h_last, h_ref, **FP32)


@pytest.mark.parametrize("b,h,w,c,n,k", SEED_STRIP_CASES)
def test_seed_conv_over_column_strips(card, b, h, w, c, n, k):
    from repro_torch.kernels.backends import sm_count
    from repro_torch.kernels.stream_conv import legacy as klegacy
    from repro_torch.kernels.stream_conv import stream_conv2d_ref, stream_conv2d_seed

    x = _frames(card, 9, b, h, w, c)
    wt = _frames(card, 10, k, k, c, n) * 0.2
    t = klegacy.seed_tile(b, h, w, c, n, k, n_sms=sm_count(card), resident=klegacy._resident)
    assert len(t["strips"]) > 1
    before = klegacy.LAUNCHES["stream_conv2d_seed"]
    out = stream_conv2d_seed(x, wt.reshape(k * k, c, n), k=k)
    assert klegacy.LAUNCHES["stream_conv2d_seed"] == before + len(t["strips"])
    _assert_matches(out, stream_conv2d_ref(x, wt), None, f"seed strips {(b, h, w, c, n, k)}")


# (C, N, K, stride, pool, pool_stride) of one int8 layer at every path the
# int8 kernels compile: the ldmatrix path (C of 16, 32, 48, 64) and the
# word path (C of 1, 3, 4, 20); pool windows 2, 3, none, one position at
# stride 2, and 4 (the run-time window); stride 2; N of 20 and 50; K not a
# multiple of 32 (75, 500, 48, 36, 144).
INT8_PATH_CASES = (
    (32, 32, 5, 1, 2, None), (64, 64, 3, 1, 2, None), (32, 64, 3, 2, 0, None),
    (3, 32, 5, 2, 0, None), (1, 20, 5, 1, 2, None), (20, 50, 5, 1, 2, None),
    (32, 32, 5, 1, 3, 2), (3, 32, 5, 1, 3, 2), (16, 24, 3, 1, 4, 2), (4, 20, 3, 1, 4, None),
    (48, 24, 1, 1, 0, None), (16, 12, 3, 1, 1, 2),
)


@pytest.mark.parametrize("case", INT8_PATH_CASES,
                         ids=lambda c: "c{}_n{}_k{}_s{}_p{}_{}".format(*c))
def test_int8_kernels_at_every_compiled_path(card, case):
    """Both int8 kernels bit for bit against their plain versions: the
    layer alone through the single-layer kernel, then as the first of a
    two-layer pyramid at a row block below the frame (2 rows) and at the
    whole frame."""
    c, n, k, stride, pool, pool_stride = case
    x = _frames(card, 20, 3, 19, 22, c)
    wt, sc = _bake_int8(_frames(card, 21, k, k, c, n) * (2.0 / (k * k * c)) ** 0.5, 8)
    b = _frames(card, 22, 1, 1, 1, n).reshape(n) * 0.1
    kw = dict(padding="SAME", stride=stride, act="relu", pool=pool, pool_stride=pool_stride,
              act_bits=8, int8_scales=Int8Scales(in_bits=8, w_scale=sc))
    before = kconv.LAUNCHES["stream_conv_fused_int8"]
    out = stream_conv_block(x, wt, b, **kw)
    assert kconv.LAUNCHES["stream_conv_fused_int8"] == before + 1
    _assert_int8_matches(out, stream_conv_block_ref(x, wt, b, **kw), 8, "relu", f"single {case}")
    layers = [ConvLayerSpec(n_out=n, kernel=k, padding="SAME", stride=stride, act="relu",
                            pool=pool, pool_stride=pool_stride),
              ConvLayerSpec(n_out=8, kernel=3, padding="SAME", act="relu", pool=0)]
    w2, sc2 = _bake_int8(_frames(card, 23, 3, 3, n, 8) * (2.0 / (9 * n)) ** 0.5, 8)
    ws, bs = [wt, w2], [b, _frames(card, 24, 1, 1, 1, 8).reshape(8) * 0.1]
    scales = (Int8Scales(in_bits=8, w_scale=sc), Int8Scales(in_bits=8, w_scale=sc2))
    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers), act_bits=8,
                                  int8_scales=scales)
    for block_rows in (2, 0):
        before = kconv.LAUNCHES["stream_conv_pyramid_int8"]
        out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=8, int8_scales=scales,
                                  block_rows=block_rows)
        assert kconv.LAUNCHES["stream_conv_pyramid_int8"] == before + 1
        _assert_int8_matches(out, ref, 8, "relu", f"pyramid {case} block_rows {block_rows}")


def _byte_view(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``offset`` bytes into its
    storage (int8 tensors)."""
    buf = torch.zeros(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[offset:offset + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 4 == offset % 4
    return view


@pytest.mark.parametrize("x_off,w_off", [(1, 0), (2, 3), (3, 1), (0, 2)])
def test_int8_kernels_read_byte_views_at_any_offset(card, x_off, w_off):
    """Frame and weight codes as contiguous views 1-3 bytes into their
    storage: the kernels read them 32 bits at a time only where the
    pointer and the rows allow, byte by byte otherwise, and agree with the
    plain versions bit for bit (C = 32 and N = 32: rows whole words)."""
    from repro_torch.kernels.stream_conv.ops import _pad_same

    x = _frames(card, 25, 2, 12, 14, 32)
    sc_in = Int8Scales(in_bits=8, w_scale=1.0)
    codes = quantize_fixed(x, sc_in.in_spec).to(torch.int8)
    wt, sc = _bake_int8(_frames(card, 26, 3, 3, 32, 32) * 0.08, 8)
    w2, sc2 = _bake_int8(_frames(card, 27, 3, 3, 32, 16) * 0.08, 8)
    b, b2 = _frames(card, 28, 1, 1, 1, 32).reshape(32) * 0.1, torch.zeros(16, device=card)
    scales = (Int8Scales(in_bits=8, w_scale=sc), Int8Scales(in_bits=8, w_scale=sc2))
    kw = dict(act="relu", pool=2, act_bits=8, int8_scales=scales[0])
    padded = _pad_same(codes, 3).contiguous()
    out = kconv.stream_conv_fused_cuda(_byte_view(padded, x_off), _byte_view(wt, w_off), b, **kw)
    ref = stream_conv_block_ref(padded, wt, b, padding="VALID", **kw)
    _assert_int8_matches(out, ref, 8, "relu", f"single layer x+{x_off} w+{w_off}")
    layers = [ConvLayerSpec(n_out=32, kernel=3, padding="SAME", act="relu", pool=2),
              ConvLayerSpec(n_out=16, kernel=3, padding="SAME", act="relu", pool=0)]
    geom = group_geometry(12, 14, 32, as_pyramid_layers(layers), (3, 3), (32, 16))
    out = kconv.stream_conv_pyramid_cuda(
        _byte_view(codes, x_off), [_byte_view(wt, w_off), _byte_view(w2, (w_off + 1) % 4)],
        [b, b2], geom=geom, act_bits=(8, 8), int8_scales=scales)
    ref = stream_conv_pyramid_ref(codes, [wt, w2], [b, b2], layers=as_pyramid_layers(layers),
                                  act_bits=8, int8_scales=scales)
    _assert_int8_matches(out, ref, 8, "relu", f"pyramid x+{x_off} w+{w_off}")


# ---------------------------------------------------------------------------
# Plans the card refused before: five fused layers, any pool window, frames
# wider than one block, weight stages wider than one block.


@pytest.mark.parametrize("what,frame,n,block_w,int8", [
    ("column strips", (2, 8, 20004, 3), 8, 0, False), ("column strips", (2, 8, 20004, 3), 8, 0, True),
    ("block_w", (2, 20, 90, 5), 12, 24, False), ("block_w", (2, 20, 90, 5), 12, 24, True),
    ("channel slices", (2, 12, 12, 8), 1024, 0, False),
    ("channel slices", (2, 12, 12, 8), 2048, 0, True),
])
def test_single_layer_kernel_over_strips_and_slices(card, what, frame, n, block_w, int8):
    b_, h, w, c = frame
    x = _frames(card, 11, *frame)
    wt = _frames(card, 12, 3, 3, c, n) * (2.0 / (9 * c)) ** 0.5
    b = _frames(card, 13, 1, 1, 1, n).reshape(n) * 0.1
    kw = dict(padding="VALID", act="relu", pool=2)
    if int8:
        wt, sc = _bake_int8(wt, 8)
        kw.update(act_bits=8, int8_scales=Int8Scales(in_bits=8, w_scale=sc))
    g = kconv.fused_plan(h, w, c, k=3, stride=1, pool=2, pool_stride=None, block_r=8,
                         block_w=block_w, n_out=n, elem_bytes=1 if int8 else 4)
    launches = len(g["strips"]) * len(g["slices"])
    assert launches > 1
    name = "stream_conv_fused_int8" if int8 else "stream_conv_fused"
    before = kconv.LAUNCHES[name]
    out = stream_conv_block(x, wt, b, block_w=block_w, **kw)
    assert kconv.LAUNCHES[name] == before + launches
    ref = stream_conv_block_ref(x, wt, b, **kw)
    if int8:
        _assert_int8_matches(out, ref, 8, "relu", what)
    else:
        _assert_matches(out, ref, None, what)


@pytest.mark.parametrize("pool,pool_stride", [(1, 2), (4, None), (5, 3), (4, 2)])
@pytest.mark.parametrize("act_bits,int8", [(None, False), (6, False), (8, True)])
def test_every_pool_window_on_the_card(card, pool, pool_stride, act_bits, int8):
    """Windows 2 and 3 are compiled; every other one runs the run-time
    window path, in the single layer and in the pyramid."""
    x = _frames(card, 14, 3, 23, 26, 4)
    layers = [ConvLayerSpec(n_out=12, kernel=3, padding="SAME", act="relu", pool=pool,
                            pool_stride=pool_stride),
              ConvLayerSpec(n_out=8, kernel=3, padding="SAME", act="relu", pool=0)]
    ws = [_frames(card, 15, 3, 3, 4, 12) * 0.3, _frames(card, 16, 3, 3, 12, 8) * 0.2]
    bs = [_frames(card, 17, 1, 1, 1, 12).reshape(12) * 0.1,
          _frames(card, 18, 1, 1, 1, 8).reshape(8) * 0.1]
    scales = None
    if int8:
        baked = [_bake_int8(wt, 8) for wt in ws]
        ws = [wq for wq, _ in baked]
        scales = tuple(Int8Scales(in_bits=8, w_scale=sc) for _, sc in baked)
    spec = layers[0]
    kw = dict(padding=spec.padding, act=spec.act, pool=pool, pool_stride=pool_stride,
              act_bits=act_bits, int8_scales=None if scales is None else scales[0])
    out = stream_conv_block(x, ws[0], bs[0], **kw)
    ref = stream_conv_block_ref(x, ws[0], bs[0], **kw)
    check = (lambda o, r, w: _assert_int8_matches(o, r, act_bits, "relu", w)) if int8 else (
        lambda o, r, w: _assert_matches(o, r, act_bits, w))
    check(out, ref, f"single layer pool {pool}/{pool_stride}")
    out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=act_bits, int8_scales=scales,
                              block_rows=2)
    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers), act_bits=act_bits,
                                  int8_scales=scales)
    check(out, ref, f"pyramid pool {pool}/{pool_stride}")


def _smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["five", "pool4", "wide"])
@pytest.mark.parametrize("quant", ["fp32", "int8"])
def test_card_serves_the_plans_the_reference_serves(card, name, quant):
    """compile_dhm on the card against the same plan on the CPU (the plain
    versions, the reference's groups): features at the fp32 tolerance or,
    in int8, equal; logits at the plans' tolerance."""
    from repro_torch.core.dhm.compiler import card_fusion_groups

    topo = _smoke().regroup_topologies(tcnn)[name]
    params = init_cnn(torch.Generator().manual_seed(6), topo, device="cpu")
    q = QuantSpec(weight_bits=8, act_bits=8, int8_compute=True) if quant == "int8" else QuantSpec()
    cpu_plan = compile_dhm(topo, params, quant=q, device="cpu")
    plan = compile_dhm(topo, _to(params, card), quant=q)
    idxs = tuple(range(len(topo.conv_layers)))
    assert plan.fusion_groups == card_fusion_groups(
        topo, idxs, cpu_plan.fusion_groups, elem_bytes=1 if quant == "int8" else 4)
    assert all(len(g.layers) <= kconv.MAX_PYRAMID_LAYERS for g in plan.fusion_groups)
    h, w = topo.input_shape
    x = _frames(card, 19, 3, h, w, topo.input_channels)
    feats, want = plan.features(x), cpu_plan.features(x.cpu())
    if quant == "int8":
        # Equal, but where tanh follows (tanhf against torch.tanh).
        tanh = any(spec.act == "tanh" for spec in topo.conv_layers)
        _assert_int8_matches(feats.cpu(), want, 8, "tanh" if tanh else "relu", name)
    else:
        _assert_matches(feats.cpu(), want, None, name)
    torch.testing.assert_close(plan(x).cpu(), cpu_plan(x.cpu()), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_lm_on_the_card_matches_the_cpu(card, dtype):
    """A scaled-down falcon-mamba: prefill and decode through the kernel on
    the card against the plain versions on the CPU, same weights."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.ssm_scan import scan as kscan
    from repro_torch.models import transformer as T

    cfg = dataclasses.replace(get_arch("falcon-mamba-7b").scaled_down(n_layers=3, dtype=dtype),
                              d_model=256)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    on_card = _to(params, card)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 17)))
    kscan.reset_launch_counts()
    logits, cache = T.prefill(on_card, cfg, toks[:, :16].to(card), max_len=20)
    assert kscan.LAUNCHES["ssm_scan"] == cfg.n_layers
    step, _ = T.decode_step(on_card, cfg, toks[:, 16:].to(card), cache, 16)
    assert kscan.LAUNCHES["ssm_scan"] == 2 * cfg.n_layers
    ref, ref_cache = T.prefill(params, cfg, toks[:, :16], max_len=20)
    ref_step, _ = T.decode_step(params, cfg, toks[:, 16:], ref_cache, 16)
    for got, want in ((logits, ref), (step, ref_step)):
        got, want = got.cpu().float(), want.float()
        if dtype == "float32":
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        else:
            # cuBLAS and the CPU round bf16 at other places: about 1 %
            # apart, as the two packages are on the CPU (test_torch_lm.py).
            assert float((got - want).norm() / want.norm()) < 3e-2


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)
