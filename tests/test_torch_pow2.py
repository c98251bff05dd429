"""The port's pow2 codebook, nibble packing, ``pow2_matmul`` (its plain
versions, on CPU tensors) and the packed pow2 head, held against the
reference on the same numpy inputs.

Codes, scales and packed bytes must be byte-identical. The integer
rendering of ``pow2_matmul`` must be equal to ``pow2_matmul_int_ref``;
the fp32 rendering is held at rtol 1e-5 / atol 1e-6 on activations on a
2^-4 grid, where every partial sum of these shapes is exact in float32,
so the check sees the decode, the scale and the odd-N slicing rather
than the order of a float sum. Plan logits use the reference's fp32
tolerance (rtol 1e-4, atol 1e-5).
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import functools  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm.engine import forward as jax_forward  # noqa: E402
from repro.core.quant import packing as jpacking  # noqa: E402
from repro.core.quant import pow2 as jpow2  # noqa: E402
from repro.kernels.pow2_matmul import ops as jops  # noqa: E402
from repro.kernels.pow2_matmul.ref import pow2_matmul_int_ref as jax_int_ref  # noqa: E402
from repro.kernels.pow2_matmul.ref import pow2_matmul_ref as jax_ref  # noqa: E402
from repro.kernels.stream_conv.epilogue import stream_quant_spec as jax_stream_spec  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import cnn_apply_reference as jax_cnn_apply_reference  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.core.quant import packing as tpacking  # noqa: E402
from repro_torch.core.quant import pow2 as tpow2  # noqa: E402
from repro_torch.kernels.pow2_matmul import ops as tops  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as tkernel  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES as TORCH_TOPOLOGIES  # noqa: E402
from repro_torch.models.cnn import cnn_apply, cnn_apply_reference  # noqa: E402

NAMES = sorted(JAX_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
MATMUL_FP32 = dict(rtol=1e-5, atol=1e-6)
# (M, K, N) of the heads the main path runs (cifar10: 1024 -> 64 -> 10;
# lenet5: 800 -> 500 -> 10) and an odd width.
HEAD_SHAPES = [(256, 1024, 64), (256, 64, 10), (8, 800, 500), (8, 500, 10), (5, 33, 7)]


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    return jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), JAX_TOPOLOGIES[name]))


def _weight_tensors(name):
    params = _reference_params(name)
    return [np.asarray(p["w"]) for group in ("conv", "fc") for p in params[group]]


def _jax_round_log2(x):
    return np.asarray(jnp.round(jnp.log2(jnp.maximum(jnp.asarray(x, jnp.float32), 1e-30))))


@pytest.mark.parametrize("e", range(6))
def test_rounding_thresholds_are_the_references(e):
    """Threshold e is the smallest float32 that the reference's
    round(log2(mag)) sends to e + 1, found by walking ulps around the
    midpoint 2^(e + 0.5); the reference's rounding is monotone there."""
    base = np.float32(2.0 ** (e + 0.5)).view(np.int32)
    xs = (base + np.arange(-64, 65)).astype(np.int32).view(np.float32)
    r = _jax_round_log2(xs)
    assert np.all(np.diff(r) >= 0)
    first = xs[np.nonzero(r >= e + 1)[0][0]]
    assert tpow2._E_THRESHOLDS[e].item() == first
    assert tpow2._E_THRESHOLD_BITS[e] == int(first.view(np.uint32))


@pytest.mark.parametrize("e", range(-1, 6))
def test_codes_at_the_midpoints_and_three_ulps_beside(e):
    """The six rounding midpoints 2^(e + 0.5) and the zero threshold
    2^-0.5, three ulps either side, both signs: a column whose max is 64
    has scale 1, so these are the normalized magnitudes themselves."""
    base = np.float32(2.0 ** (e + 0.5)).view(np.int32)
    vals = (base + np.arange(-3, 4)).astype(np.int32).view(np.float32)
    col = np.concatenate([vals, -vals, [64.0]]).astype(np.float32).reshape(-1, 1)
    jc, js = jpow2.pow2_codes(jnp.asarray(col), channel_axis=1)
    tc, ts = tpow2.pow2_codes(torch.from_numpy(col), channel_axis=1)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("name", NAMES)
def test_codes_scales_and_packing_on_every_topology_tensor(name):
    for w in _weight_tensors(name):
        jc, js = jpow2.pow2_codes(jnp.asarray(w))
        tc, ts = tpow2.pow2_codes(torch.from_numpy(w.copy()))
        assert tc.dtype == torch.uint8
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(
            tpow2.project_pow2(torch.from_numpy(w.copy())).numpy(),
            np.asarray(jpow2.project_pow2(jnp.asarray(w))),
        )
        if w.ndim == 2:
            jp, jsc = jops.quantize_weights(jnp.asarray(w))
            tp, tsc = tops.quantize_weights(torch.from_numpy(w.copy()))
        else:
            jp, jsc = jpacking.pack_codes_u4(jc), js
            tp, tsc = tpacking.pack_codes_u4(tc), ts
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))


def test_all_zero_channel_and_decode():
    w = np.random.default_rng(0).normal(size=(6, 5)).astype(np.float32)
    w[:, 2] = 0.0
    jc, js = jpow2.pow2_codes(jnp.asarray(w))
    tc, ts = tpow2.pow2_codes(torch.from_numpy(w))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    codes = np.arange(16, dtype=np.uint8).reshape(4, 4)
    scale = np.float32([0.5, 1.0, 3.0, 0.1])
    np.testing.assert_array_equal(
        tpow2.decode_pow2(torch.from_numpy(codes), torch.from_numpy(scale)).numpy(),
        np.asarray(jpow2.decode_pow2(jnp.asarray(codes), jnp.asarray(scale))),
    )


@pytest.mark.parametrize("frac_bits", [-1, 0, 3, 6])
def test_classify_params_matches(frac_bits):
    q = np.random.default_rng(frac_bits + 5).integers(-80, 81, size=(7, 9)).astype(np.int32)
    want = jpow2.classify_params(jnp.asarray(q), frac_bits)
    got = tpow2.classify_params(torch.from_numpy(q), frac_bits)
    assert got == tpow2.ParamClassStats(**vars(want))
    assert got.multiplierless == pytest.approx(want.multiplierless)


@pytest.mark.parametrize("shape", [(4,), (3, 6), (2, 3, 8)])
def test_pack_and_unpack_match(shape):
    codes = np.random.default_rng(len(shape)).integers(0, 16, size=shape).astype(np.uint8)
    packed = tpacking.pack_codes_u4(torch.from_numpy(codes))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacking.pack_codes_u4(codes)))
    np.testing.assert_array_equal(tpacking.unpack_codes_u4(packed).numpy(), codes)
    with pytest.raises(ValueError, match="last axis must be even"):
        tpacking.pack_codes_u4(torch.zeros(shape[:-1] + (shape[-1] + 1,), dtype=torch.uint8))


def _head_case(m, k, n, seed=0):
    """Weights at the reference init's scale; activations on a 2^-4 grid
    inside [-2, 2) (on the 8-bit stream grid too)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(k, n)) * np.sqrt(2.0 / k)).astype(np.float32)
    x = np.clip(np.round(rng.normal(size=(m, k)) * 16) / 16, -2.0, 1.9375).astype(np.float32)
    jp, js = jops.quantize_weights(jnp.asarray(w))
    tp, ts = tops.quantize_weights(torch.from_numpy(w))
    return x, (jp, js), (tp, ts)


@pytest.mark.parametrize("m,k,n", HEAD_SHAPES)
def test_pow2_matmul_fp32_decode_matches_reference(m, k, n):
    x, (jp, js), (tp, ts) = _head_case(m, k, n)
    want = np.asarray(jax_ref(jnp.asarray(x), jp, js))
    before = dict(tkernel.LAUNCHES)
    got = tops.pow2_matmul(torch.from_numpy(x), tp, ts)
    assert tkernel.LAUNCHES == before  # a CPU tensor launches nothing
    assert got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), want, **MATMUL_FP32)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jops.pow2_matmul(jnp.asarray(x), jp, js, backend="pallas")),
        **MATMUL_FP32,
    )


@pytest.mark.parametrize("m,k,n", HEAD_SHAPES)
@pytest.mark.parametrize("bits", [8, 6])
def test_pow2_matmul_integer_rendering_is_exact(m, k, n, bits):
    x, (jp, js), (tp, ts) = _head_case(m, k, n, seed=1)
    want = np.asarray(jax_int_ref(jnp.asarray(x), jp, js, x_spec=jax_stream_spec(bits)))
    spec = stream_quant_spec(bits)
    got = tops.pow2_matmul(torch.from_numpy(x), tp, ts, x_spec=spec)
    np.testing.assert_array_equal(got.numpy(), want)
    # int8 codes in take the same path.
    codes = torch.clamp(torch.round(torch.from_numpy(x) / spec.scale), spec.qmin, spec.qmax)
    np.testing.assert_array_equal(
        tops.pow2_matmul(codes.to(torch.int8), tp, ts, x_spec=spec).numpy(), want
    )
    if bits == 8:
        # On the 8-bit grid the integer rendering equals the fp32 decode.
        np.testing.assert_array_equal(got.numpy(), tops.pow2_matmul(torch.from_numpy(x), tp, ts).numpy())


def test_pow2_matmul_refuses_what_the_reference_refuses():
    _, (jp, js), (tp, ts) = _head_case(4, 16, 6)
    x = torch.zeros((4, 16))
    with pytest.raises(ValueError, match="packed width 3 inconsistent with scale length 4"):
        tops.pow2_matmul(x, tp, ts[:4])
    with pytest.raises(ValueError, match="packed width 3 inconsistent with scale length 4"):
        jops.pow2_matmul(jnp.zeros((4, 16)), jp, js[:4])
    with pytest.raises(ValueError, match="int8 activation codes"):
        tops.pow2_matmul(x, tp, ts, x_spec=stream_quant_spec(12))
    with pytest.raises(ValueError, match=r"expected \(K, N\) weights"):
        tops.quantize_weights(torch.zeros(3))
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        tkernel.pow2_matmul_cuda(x, tp, ts)


def test_project_pow2_ste_gradient_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(5, 5, 3, 8)).astype(np.float32)
    g = rng.normal(size=w.shape).astype(np.float32)
    want = jax.grad(lambda t: jnp.sum(jpow2.project_pow2_ste(t) * g))(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    (tpow2.project_pow2_ste(tw) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tpow2.project_pow2_ste(torch.from_numpy(w)).numpy(),
        np.asarray(jpow2.project_pow2_ste(jnp.asarray(w))),
    )


@pytest.mark.parametrize("bits", [None, 8])
def test_pow2_linear_ste_gradients_match_jax(bits):
    x, _, _ = _head_case(6, 48, 9, seed=4)
    rng = np.random.default_rng(5)
    w = (rng.normal(size=(48, 9)) * 0.2).astype(np.float32)
    g = rng.normal(size=(6, 9)).astype(np.float32)
    jspec = None if bits is None else jax_stream_spec(bits)

    def loss(a, b):
        return jnp.sum(jcompiler._pow2_linear_ste(a, b, "ref", jspec) * g)

    want_y = np.asarray(jcompiler._pow2_linear_ste(jnp.asarray(x), jnp.asarray(w), "ref", jspec))
    want_gx, want_gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tspec = None if bits is None else stream_quant_spec(bits)
    y = tcompiler._pow2_linear_ste(tx, tw, tspec)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want_y, **MATMUL_FP32)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_gw), rtol=1e-5, atol=1e-5)


def _frames(name, b=2, seed=1):
    topo = JAX_TOPOLOGIES[name]
    h, w = topo.input_shape
    return np.random.default_rng(seed).normal(size=(b, h, w, topo.input_channels)).astype(np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_cnn_apply_with_pow2_weights_matches_reference(name):
    params, x = _reference_params(name), _frames(name)
    want = np.asarray(jax_cnn_apply_reference(
        jax.tree_util.tree_map(jnp.asarray, params), JAX_TOPOLOGIES[name], jnp.asarray(x),
        pow2_weights=True,
    ))
    tparams = params_from_numpy(params, "cpu")
    tt = TORCH_TOPOLOGIES[name]
    with torch.no_grad():
        ref = cnn_apply_reference(tparams, tt, torch.from_numpy(x), pow2_weights=True).numpy()
        got = cnn_apply(tparams, tt, torch.from_numpy(x), pow2_weights=True).numpy()
    np.testing.assert_allclose(ref, want, **FP32)
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_pow2_plan_logits_match_reference(name, backend):
    """QuantSpec(pow2_weights=True): projected conv weights through the
    fp32 kernels' plain versions, the packed head in fp32-decode mode."""
    params, x = _reference_params(name), _frames(name)
    q = dict(pow2_weights=True)
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES[name], params, quant=jcompiler.QuantSpec(**q),
                                  backend=backend)
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES[name], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**q), device="cpu")
    assert plan.quant.packed_fc_head
    for p in plan.fc_params:
        assert p["packed"].dtype == torch.uint8
        assert p["packed"].shape == (p["w"].shape[0], (p["w"].shape[1] + 1) // 2)
    with torch.no_grad():
        got = plan(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_forward(jplan, jnp.asarray(x))), **FP32)


def test_dense_head_when_weight_bits_is_stacked_on_pow2():
    """weight_bits on top of the pow2 projection leaves the codebook: the
    head is the dense projected + fake-quantized matmul, as in the
    reference."""
    name = "lenet5"
    params, x = _reference_params(name), _frames(name)
    q = dict(pow2_weights=True, weight_bits=6, act_bits=6)
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES[name], params, quant=jcompiler.QuantSpec(**q),
                                  backend="ref")
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES[name], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**q), device="cpu")
    assert not plan.quant.packed_fc_head
    assert all("packed" not in p for p in plan.fc_params)
    with torch.no_grad():
        got = plan(x).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_forward(jplan, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
