"""The port's fixed-point quantization and fused epilogue, held against the
reference package on the same numpy inputs (CPU)."""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import zlib  # noqa: E402
import functools  # noqa: E402

from repro.core.quant import fixed_point as jfp  # noqa: E402
from repro.kernels.stream_conv import epilogue as jep  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro_torch.core.quant import fixed_point as tfp  # noqa: E402
from repro_torch.kernels.stream_conv import epilogue as tep  # noqa: E402

SPECS = [(2, 0), (3, 1), (6, 4), (8, 5), (8, -2), (16, 12)]


def _fmt(spec):
    return spec.bits, spec.frac_bits


def _pair(x):
    return jnp.asarray(x), torch.from_numpy(np.array(x, copy=True))


@pytest.mark.parametrize("bits,frac", SPECS)
def test_fixed_point_forward_matches(bits, frac):
    rng = np.random.default_rng(bits * 100 + frac)
    x = (rng.normal(size=(257,)) * 4.0).astype(np.float32)
    # Half-way points exercise round-half-to-even on both sides.
    x[:8] = (np.arange(8) - 3.5) * 2.0 ** (-frac)
    jx, tx = _pair(x)
    js, ts = jfp.FixedPointSpec(bits, frac), tfp.FixedPointSpec(bits, frac)
    assert (js.scale, js.qmin, js.qmax, js.int_bits) == (
        ts.scale, ts.qmin, ts.qmax, ts.int_bits
    )
    np.testing.assert_array_equal(
        np.asarray(jfp.quantize_fixed(jx, js)), tfp.quantize_fixed(tx, ts).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jfp.fake_quant(jx, js)), tfp.fake_quant(tx, ts).numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(jfp.fake_quant_ste(jx, js)), tfp.fake_quant_ste(tx, ts).numpy()
    )


@pytest.mark.parametrize("bits,frac", SPECS)
def test_ste_gradient_matches(bits, frac):
    rng = np.random.default_rng(7 + bits)
    x = (rng.normal(size=(129,)) * 2.0 ** (bits - 1 - frac)).astype(np.float32)
    js, ts = jfp.FixedPointSpec(bits, frac), tfp.FixedPointSpec(bits, frac)
    g_jax = jax.grad(lambda v: jnp.sum(jfp.fake_quant_ste(v, js) * 3.0))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    (tfp.fake_quant_ste(tx, ts) * 3.0).sum().backward()
    np.testing.assert_array_equal(np.asarray(g_jax), tx.grad.numpy())


def test_fixed_point_spec_rejects_one_bit():
    with pytest.raises(ValueError, match="fixed-point needs >=2 bits"):
        tfp.FixedPointSpec(1, 0)


@functools.lru_cache(maxsize=None)
def _topology_tensors(name):
    """Every conv and FC tensor of a topology, at its shape and the
    reference init's scale (normal * sqrt(2 / fan_in), zero biases)."""
    topo = JAX_TOPOLOGIES[name]
    rng = np.random.default_rng(3)
    shapes, c = [], topo.input_channels
    for i, spec in enumerate(topo.conv_layers):
        shapes.append((f"conv{i}", (spec.kernel, spec.kernel, c, spec.n_out)))
        c = spec.n_out
    dims = (int(np.prod(topo.feature_shape())),) + tuple(topo.fc_dims) + (topo.n_classes,)
    for i, (d_in, d_out) in enumerate(zip(dims[:-1], dims[1:])):
        shapes.append((f"fc{i}", (d_in, d_out)))
    out = []
    for label, shape in shapes:
        fan_in = int(np.prod(shape[:-1]))
        w = (rng.normal(size=shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        out += [(f"{name}/{label}/w", w), (f"{name}/{label}/b", np.zeros(shape[-1], np.float32))]
    return out


@pytest.mark.parametrize("name", sorted(JAX_TOPOLOGIES))
def test_dynamic_spec_on_every_topology_tensor(name):
    """The baked Q-format of every conv and FC tensor of the five
    topologies (zero biases included) is the reference's."""
    for label, arr in _topology_tensors(name):
        jx, tx = _pair(arr)
        for bits in (3, 6, 8):
            assert _fmt(jfp.dynamic_spec(jx, bits)) == _fmt(tfp.dynamic_spec(tx, bits)), label
        np.testing.assert_array_equal(
            np.asarray(jfp.fake_quant_dynamic(jx, 6)),
            tfp.fake_quant_dynamic(tx, 6).numpy(),
            err_msg=label,
        )


@pytest.mark.parametrize("k", [-24, -15, -13, -5, -1, 0, 1, 3, 13, 15, 24])
def test_dynamic_spec_at_power_of_two_and_one_ulp_beside(k):
    """At and one float32 step beside 2^k, including exponents where the
    reference's float32 log2 lands one step off the integer."""
    p = np.float32(2.0 ** k)
    for top in (np.nextafter(p, np.float32(0)), p, np.nextafter(p, np.float32(np.inf))):
        arr = np.array([0.25 * top, -top, 0.5 * top], np.float32)
        jx, tx = _pair(arr)
        for bits in (4, 8):
            jspec = jfp.dynamic_spec(jx, bits)
            assert _fmt(jspec) == _fmt(tfp.dynamic_spec(tx, bits)), (k, top)
            # Against the reference's exact-scale rendering: its in-graph
            # jnp.exp2 scale is off the pow2 grid on XLA:CPU for exponents
            # outside about [-14, 12] (2^-15 -> 3.0517562e-05); the port's
            # scale is the exact power of two.
            np.testing.assert_array_equal(
                np.asarray(jfp.fake_quant(jx, jspec)),
                tfp.fake_quant_dynamic(tx, bits).numpy(),
            )


def test_for_tensor_matches():
    for label, arr in _topology_tensors("cifar10"):
        jx, tx = _pair(arr)
        assert _fmt(jfp.FixedPointSpec.for_tensor(jx, 6)) == _fmt(
            tfp.FixedPointSpec.for_tensor(tx, 6)
        ), label


# ---------------------------------------------------------------------------
# epilogue


@pytest.mark.parametrize("pool,pool_stride", [(0, None), (2, None), (3, 2), (2, 3), (3, 1)])
@pytest.mark.parametrize("act", ["none", "relu", "tanh"])
@pytest.mark.parametrize("act_bits", [None, 3, 6])
@pytest.mark.parametrize("pool_first", [False, True])
def test_apply_epilogue_matches(pool, pool_stride, act, act_bits, pool_first):
    rng = np.random.default_rng(zlib.crc32(repr((pool, pool_stride, act, act_bits)).encode()))
    y = rng.normal(size=(2, 9, 7, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    kw = dict(act=act, pool=pool, pool_stride=pool_stride, act_bits=act_bits,
              pool_first=pool_first)
    want = np.asarray(jep.apply_epilogue(jnp.asarray(y), jnp.asarray(b), **kw))
    got = tep.apply_epilogue(torch.from_numpy(y), torch.from_numpy(b), **kw).numpy()
    assert got.shape == want.shape
    # tanh may differ by float32 ulps between XLA and PyTorch; quantized
    # outputs may then sit one step apart where a value lies on a rounding
    # boundary — none do at these inputs.
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_epilogue_vocabulary_matches():
    for pool, ps in [(0, None), (2, None), (3, 2), (2, 5)]:
        assert tep.normalize_pool(pool, ps) == jep.normalize_pool(pool, ps)
    for d, wdw, s in [(32, 2, 2), (32, 3, 2), (15, 3, 2), (7, 2, 3)]:
        assert tep.pool_out_dim(d, wdw, s) == jep.pool_out_dim(d, wdw, s)
    for bits in (2, 6, 8):
        j, t = jep.stream_quant_spec(bits), tep.stream_quant_spec(bits)
        assert (j.bits, j.frac_bits) == (t.bits, t.frac_bits)
    js, ts = jep.Int8Scales(6, 2.0 ** -7), tep.Int8Scales(6, 2.0 ** -7)
    assert (js.in_scale, js.deq_scale) == (ts.in_scale, ts.deq_scale)


@pytest.mark.parametrize(
    "args",
    [
        dict(act="rleu", pool=0),
        dict(act="relu", pool=-1),
        dict(act="relu", pool=0, pool_stride=2),
        dict(act="relu", pool=2, pool_stride=0),
        dict(act="relu", pool=2.0),
        dict(act="relu", pool=2, act_bits=1),
    ],
)
def test_validate_epilogue_errors_match(args):
    with pytest.raises(ValueError) as want:
        jep.validate_epilogue(**args)
    with pytest.raises(ValueError) as got:
        tep.validate_epilogue(**args)
    assert str(got.value) == str(want.value)
