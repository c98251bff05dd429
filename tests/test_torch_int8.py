"""True int8 compute in the port (its plain versions, on CPU tensors),
held against the reference's int8 paths (``ref`` and ``pallas``, which on
the CPU is the XLA rendering) on the same numpy inputs.

The numeric contract: with weights baked to int8 codes on the dynamic
pow2 grid ``fake_quant_dynamic`` uses and an input on its stream grid,
the int8 rendering (int8 x int8 summed exactly into an int32 accumulator,
one exact pow2 dequantization, the fp32 epilogue) gives EXACTLY the
fake-quant values. Accumulators, single-layer and pyramid outputs, the
integer pow2 head and int8 plans on on-grid frames are therefore held
bit for bit. Off-grid frames are quantized on the way in, identically in
both packages; plan logits there use the tolerance of the fake-quant plan
test in ``test_torch_compiler.py`` (features equal except where tanh
implementations land on the two sides of a rounding boundary, exactly one
quant step apart, in at most one frame).
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
from repro.core.dhm import fusion as jfusion  # noqa: E402
from repro.core.dhm.engine import forward as jax_forward  # noqa: E402
from repro.core.quant import fixed_point as jfp  # noqa: E402
from repro.kernels.stream_conv import epilogue as jepi  # noqa: E402
from repro.kernels.stream_conv import ops as jops  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import CNNTopology as JTopology  # noqa: E402
from repro.models.cnn import ConvLayerSpec as JSpec  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import Engine  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.core.dhm import fusion as tfusion  # noqa: E402
from repro_torch.core.quant import fixed_point as tfp  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import epilogue as tepi  # noqa: E402
from repro_torch.kernels.stream_conv import ops as tops  # noqa: E402
from repro_torch.kernels.stream_conv import ref as tref  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES as TORCH_TOPOLOGIES  # noqa: E402
from repro_torch.models.cnn import CNNTopology as TTopology  # noqa: E402
from repro_torch.models.cnn import ConvLayerSpec as TSpec  # noqa: E402

BITS = 8
NAMES = sorted(JAX_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
MAX_OFF_FRAMES = 1


def _bake(w, bits=BITS):
    """(int8 codes, w_scale) on the fake-quant grid, by the reference."""
    spec = jfp.dynamic_spec(jnp.asarray(w), bits)
    return np.asarray(jfp.quantize_fixed(jnp.asarray(w), spec)).astype(np.int8), float(spec.scale)


def _grid(x, bits=BITS):
    """Snap numpy values onto the ``bits``-wide stream grid."""
    spec = tepi.stream_quant_spec(bits)
    q = np.clip(np.round(x / spec.scale), spec.qmin, spec.qmax)
    return (q * spec.scale).astype(np.float32)


def _case(seed, h, w, c, n, k=3):
    rng = np.random.default_rng(seed)
    wts = (rng.normal(size=(k, k, c, n)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    x = _grid(rng.normal(size=(2, h, w, c)))
    return x, wts, b


def _fq(a, bits=BITS):
    return np.array(jfp.fake_quant_dynamic(jnp.asarray(a), bits))


def test_bake_matches_fake_quant_grid_in_both_packages():
    w = np.random.default_rng(0).normal(size=(5, 5, 3, 8)).astype(np.float32)
    codes, scale = _bake(w)
    tspec = tfp.dynamic_spec(torch.from_numpy(w), BITS)
    assert tspec.scale == scale
    np.testing.assert_array_equal(
        tfp.quantize_fixed(torch.from_numpy(w), tspec).to(torch.int8).numpy(), codes
    )
    np.testing.assert_array_equal(codes.astype(np.float32) * scale, _fq(w))


GRID = [
    dict(padding="VALID", stride=1, act="relu", pool=2, pool_stride=None),
    dict(padding="VALID", stride=2, act="tanh", pool=0, pool_stride=None),
    dict(padding="SAME", stride=1, act="relu", pool=3, pool_stride=2),
    dict(padding="SAME", stride=2, act="none", pool=2, pool_stride=None),
]
GRID_IDS = [f"{c['padding']}-s{c['stride']}-{c['act']}-p{c['pool']}" for c in GRID]


@pytest.mark.parametrize("cfg", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("frame", [(14, 18), (17, 11)])
def test_int32_accumulator_is_exact(cfg, frame):
    """The plain version's integer sum equals the reference's int32
    accumulator (``preferred_element_type=int32``) bit for bit."""
    x, wts, _ = _case(3, *frame, 4, 6)
    codes, _ = _bake(wts)
    qx = np.asarray(jfp.quantize_fixed(jnp.asarray(x), jepi.stream_quant_spec(BITS))).astype(np.int8)
    want = np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(qx), jnp.asarray(codes), window_strides=(cfg["stride"],) * 2,
        padding=cfg["padding"], dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32,
    ))
    got = tref._conv_nhwc(torch.from_numpy(qx), torch.from_numpy(codes), stride=cfg["stride"],
                          padding=cfg["padding"], dtype=torch.float64)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("cfg", GRID, ids=GRID_IDS)
@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("bits", [8, 6])
def test_int8_block_matches_reference(cfg, backend, bits):
    x, wts, b = _case(3, 14, 18, 2, 5)
    x = _grid(x, bits)
    codes, w_scale = _bake(wts, bits)
    bq = _fq(b, bits)
    want = np.asarray(jops.stream_conv_block(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(bq), act_bits=bits,
        int8_scales=jepi.Int8Scales(in_bits=bits, w_scale=w_scale), backend=backend, **cfg,
    ))
    sc = tepi.Int8Scales(in_bits=bits, w_scale=w_scale)
    got = tops.stream_conv_block(torch.from_numpy(x), torch.from_numpy(codes),
                                 torch.from_numpy(bq), act_bits=bits, int8_scales=sc, **cfg)
    np.testing.assert_array_equal(got.numpy(), want)
    # ... and exactly the port's own fake-quant composition.
    fq = tref.stream_conv_block_ref(torch.from_numpy(x), torch.from_numpy(_fq(wts, bits)),
                                    torch.from_numpy(bq), act_bits=bits, **cfg)
    np.testing.assert_array_equal(got.numpy(), fq.numpy())


PYR_LAYERS = [
    dict(n_out=4, kernel=3, padding="SAME", pool=3, pool_stride=2, act="relu"),
    dict(n_out=5, kernel=3, padding="SAME", pool=2, act="tanh"),
]


@pytest.mark.parametrize("backend", ["ref", "pallas"])
@pytest.mark.parametrize("bits", [(8, 8), (8, 6)])
def test_int8_pyramid_matches_reference(backend, bits):
    """A 2-layer group on a rectangular SAME frame: the interior layer
    emits int8 codes, the last fp32 grid values — exactly the reference's
    int8 pyramid and the per-layer fake-quant composition."""
    rng = np.random.default_rng(5)
    w0 = (rng.normal(size=(3, 3, 2, 4)) * 0.5).astype(np.float32)
    w1 = (rng.normal(size=(3, 3, 4, 5)) * 0.5).astype(np.float32)
    b0 = np.full((4,), 0.0625, np.float32)
    b1 = np.full((5,), -0.125, np.float32)
    x = _grid(rng.normal(size=(2, 14, 18, 2)), bits[0])
    (c0, s0), (c1, s1) = _bake(w0, bits[0]), _bake(w1, bits[1])
    bq = [_fq(b0, bits[0]), _fq(b1, bits[1])]
    in_bits = (bits[0], bits[0])
    want = np.asarray(jops.stream_conv_pyramid(
        jnp.asarray(x), [jnp.asarray(c0), jnp.asarray(c1)], [jnp.asarray(v) for v in bq],
        layers=[JSpec(**d) for d in PYR_LAYERS], act_bits=bits,
        int8_scales=(jepi.Int8Scales(in_bits[0], s0), jepi.Int8Scales(in_bits[1], s1)),
        backend=backend,
    ))
    got = tops.stream_conv_pyramid(
        torch.from_numpy(x), [torch.from_numpy(c0), torch.from_numpy(c1)],
        [torch.from_numpy(v) for v in bq], layers=[TSpec(**d) for d in PYR_LAYERS],
        act_bits=bits,
        int8_scales=(tepi.Int8Scales(in_bits[0], s0), tepi.Int8Scales(in_bits[1], s1)),
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_validation_errors_match_reference():
    x, wts, b = _case(1, 8, 8, 2, 3)
    codes, w_scale = _bake(wts)
    jsc, tsc = jepi.Int8Scales(BITS, w_scale), tepi.Int8Scales(BITS, w_scale)
    cases = [
        (dict(w=wts, act_bits=BITS), "int8_scales requires int8 weight codes"),
        (dict(w=codes, act_bits=None), "int8_scales requires act_bits"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jops.stream_conv_block(jnp.asarray(x), jnp.asarray(kw["w"]), jnp.asarray(b),
                                   act_bits=kw["act_bits"], int8_scales=jsc, backend="ref")
        with pytest.raises(ValueError, match=msg):
            tops.stream_conv_block(torch.from_numpy(x), torch.from_numpy(kw["w"]),
                                   torch.from_numpy(b), act_bits=kw["act_bits"], int8_scales=tsc)
    layers = [dict(n_out=3, kernel=3, padding="SAME"), dict(n_out=3, kernel=3, padding="SAME")]
    c1, s1 = _bake(np.random.default_rng(2).normal(size=(3, 3, 3, 3)).astype(np.float32))
    msg = "in_bits=8 must equal the previous layer's act_bits=6"
    with pytest.raises(ValueError, match=msg):
        jops.stream_conv_pyramid(
            jnp.asarray(x), [jnp.asarray(codes), jnp.asarray(c1)], [jnp.asarray(b)] * 2,
            layers=[JSpec(**d) for d in layers], act_bits=(6, 8),
            int8_scales=(jepi.Int8Scales(6, w_scale), jepi.Int8Scales(8, s1)), backend="ref",
        )
    with pytest.raises(ValueError, match=msg):
        tops.stream_conv_pyramid(
            torch.from_numpy(x), [torch.from_numpy(codes), torch.from_numpy(c1)],
            [torch.from_numpy(b)] * 2, layers=[TSpec(**d) for d in layers], act_bits=(6, 8),
            int8_scales=(tepi.Int8Scales(6, w_scale), tepi.Int8Scales(8, s1)),
        )
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kconv.stream_conv_fused_cuda(torch.from_numpy(x).to(torch.int8), torch.from_numpy(codes),
                                     torch.from_numpy(b), act_bits=BITS, int8_scales=tsc)


@pytest.mark.parametrize("act_bits", [8, 5])
@pytest.mark.parametrize("pool_first", [False, True])
def test_codes_out_and_quantize_stream_match(act_bits, pool_first):
    rng = np.random.default_rng(act_bits)
    y = rng.normal(size=(2, 6, 7, 3)).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    kw = dict(act="tanh", pool=2, act_bits=act_bits, pool_first=pool_first, codes_out=True)
    want = np.asarray(jepi.apply_epilogue(jnp.asarray(y), jnp.asarray(b), **kw))
    got = tepi.apply_epilogue(torch.from_numpy(y), torch.from_numpy(b), **kw)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tepi.quantize_stream(torch.from_numpy(y), act_bits).numpy(),
        np.asarray(jepi.quantize_stream(jnp.asarray(y), act_bits)),
    )
    with pytest.raises(ValueError, match="codes_out requires act_bits"):
        tepi.apply_epilogue(torch.from_numpy(y), torch.from_numpy(b), act="none", pool=0,
                            codes_out=True)


# ---------------------------------------------------------------------------
# Compiled int8 plans.


@functools.lru_cache(maxsize=None)
def _setup(name):
    """The reference init's params (numpy) and frames from a seed."""
    topo = JAX_TOPOLOGIES[name]
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), topo))
    h, w = topo.input_shape
    x = np.random.default_rng(1).normal(size=(2, h, w, topo.input_channels))
    return params, x.astype(np.float32)


def _int8(bits=BITS, **kw):
    return dict(weight_bits=bits, act_bits=bits, int8_compute=True, **kw)


def _assert_plan_matches(got_feats, got_logits, want_feats, want_logits, bits):
    step = tepi.stream_quant_spec(bits).scale
    d = np.abs(got_feats - want_feats)
    off = d > 1e-6
    np.testing.assert_allclose(d[off], step, rtol=1e-5)
    off_frames = off.reshape(off.shape[0], -1).any(axis=1)
    assert off_frames.sum() <= MAX_OFF_FRAMES, int(off.sum())
    np.testing.assert_allclose(got_logits[~off_frames], want_logits[~off_frames], **FP32)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_int8_plan_logits_match_reference(name, backend):
    params, x = _setup(name)
    jt, tt = JAX_TOPOLOGIES[name], TORCH_TOPOLOGIES[name]
    tparams = params_from_numpy(params, "cpu")
    for n_stages in range(1, len(tt.conv_layers) + 1):
        for budget in (None, 0):
            jplan = jcompiler.compile_dhm(jt, params, quant=jcompiler.QuantSpec(**_int8()),
                                          n_stages=n_stages, backend=backend,
                                          vmem_budget=budget)
            plan = tcompiler.compile_dhm(tt, tparams, quant=tcompiler.QuantSpec(**_int8()),
                                         n_stages=n_stages, device="cpu", vmem_budget=budget)
            assert [(g.layers, g.block_rows, g.working_set) for g in plan.fusion_groups] == [
                (g.layers, g.block_rows, g.working_set) for g in jplan.fusion_groups
            ]
            with torch.no_grad():
                feats = plan.features(torch.from_numpy(x)).numpy()
                logits = plan(x).numpy()
            _assert_plan_matches(feats, logits, np.asarray(jplan.features(jnp.asarray(x))),
                                 np.asarray(jax_forward(jplan, jnp.asarray(x))), BITS)


def test_int8_plan_bakes_the_references_codes_and_scales():
    params, _ = _setup("cifar10")
    q = _int8()
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES["cifar10"], params,
                                  quant=jcompiler.QuantSpec(**q), backend="ref")
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES["cifar10"], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**q), device="cpu")
    assert tfusion.plan_elem_bytes(plan.quant) == 1
    assert [(s.in_bits, s.w_scale) for s in plan.int8_scales] == [
        (s.in_bits, s.w_scale) for s in jplan.int8_scales
    ]
    for got, want in zip(plan.conv_params, jplan.conv_params):
        assert got["w"].dtype == torch.int8
        np.testing.assert_array_equal(got["w"].numpy(), np.asarray(want["w"]))
        np.testing.assert_array_equal(got["b"].numpy(), np.asarray(want["b"]))
    plan.self_check()


def _on_grid_frames(name, seed, bits=BITS, b=2):
    topo = JAX_TOPOLOGIES[name]
    h, w = topo.input_shape
    return _grid(np.random.default_rng(seed).normal(size=(b, h, w, topo.input_channels)), bits)


@pytest.mark.parametrize("budget", [None, 0])
def test_int8_plan_equals_fake_quant_plan_on_grid(budget):
    """The reference's ``_topo_params`` topology (lenet5, init_cnn at
    PRNGKey(0)): the port's int8 plan equals its fake-quant plan bit for
    bit on an on-grid frame."""
    params, _ = _setup("lenet5")
    tparams = params_from_numpy(params, "cpu")
    tt = TORCH_TOPOLOGIES["lenet5"]
    x = _on_grid_frames("lenet5", 7)
    fq = tcompiler.compile_dhm(tt, tparams, quant=tcompiler.QuantSpec(weight_bits=BITS, act_bits=BITS),
                               device="cpu", vmem_budget=budget)
    i8 = tcompiler.compile_dhm(tt, tparams, quant=tcompiler.QuantSpec(**_int8()), device="cpu",
                               vmem_budget=budget)
    with torch.no_grad():
        np.testing.assert_array_equal(i8(x).numpy(), fq(x).numpy())


def test_mixed_per_layer_bits_plan_matches_reference():
    params, _ = _setup("cifar10")
    bits = (8, 6, 7)
    q = dict(int8_compute=True, per_layer_bits=bits)
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES["cifar10"], params,
                                  quant=jcompiler.QuantSpec(**q), backend="ref")
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES["cifar10"], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**q), device="cpu")
    assert plan.quant.mixed_bitwidth
    assert [s.in_bits for s in plan.int8_scales] == [8, 8, 6]  # the code chain
    x = _on_grid_frames("cifar10", 8)
    with torch.no_grad():
        got = plan(x).numpy()
        feats = plan.features(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(feats, np.asarray(jplan.features(jnp.asarray(x))))
    np.testing.assert_allclose(got, np.asarray(jax_forward(jplan, jnp.asarray(x))), **FP32)


def test_int8_validation_matches_reference():
    params, _ = _setup("lenet5")
    tparams = params_from_numpy(params, "cpu")
    with pytest.raises(ValueError, match="int8_compute requires"):
        tcompiler.QuantSpec(int8_compute=True)
    with pytest.raises(ValueError, match="<= 8"):
        tcompiler.QuantSpec(weight_bits=9, act_bits=9, int8_compute=True)
    with pytest.raises(ValueError, match="per_layer_bits"):
        tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], tparams,
                              quant=tcompiler.QuantSpec(per_layer_bits=(8,) * 17), device="cpu")


def test_int8_fusion_widens_at_the_probe_budget():
    """At the reference's probe budget the int8 plan fuses a longer group
    than the fp32 plan, with the same groups and working sets as the
    reference's plans."""
    widened = 0
    for name in NAMES:
        jt, tt = JAX_TOPOLOGIES[name], TORCH_TOPOLOGIES[name]
        idxs = tuple(range(len(tt.conv_layers)))
        probe = tfusion.widening_budget(tt, idxs)
        assert probe == jfusion.widening_budget(jt, idxs)
        if probe is None or probe["int8_max_group"] <= probe["fp32_max_group"]:
            continue
        params, _ = _setup(name)
        tparams = params_from_numpy(params, "cpu")
        plans = {}
        for key, q in (("fp", {}), ("i8", _int8())):
            plans[key] = tcompiler.compile_dhm(tt, tparams, quant=tcompiler.QuantSpec(**q),
                                               device="cpu", vmem_budget=probe["budget"])
            jplan = jcompiler.compile_dhm(jt, params, quant=jcompiler.QuantSpec(**q),
                                          backend="ref", vmem_budget=probe["budget"])
            assert [(g.layers, g.block_rows, g.working_set) for g in plans[key].fusion_groups] == [
                (g.layers, g.block_rows, g.working_set) for g in jplan.fusion_groups
            ]
        fp_max = max(len(g.layers) for g in plans["fp"].fusion_groups)
        i8_max = max(len(g.layers) for g in plans["i8"].fusion_groups)
        assert i8_max > fp_max, name
        for g in plans["i8"].fusion_groups:
            assert g.working_set == tfusion.group_working_set(
                tt, g.layers, block_rows=g.block_rows, elem_bytes=1
            )
        widened += 1
    assert widened


def _p2head():
    kw = dict(name="p2head", input_hw=(12, 12), input_channels=2, fc_dims=(16,), n_classes=5)
    layer = dict(n_out=4, kernel=3, padding="SAME", pool=2, act="tanh")
    return JTopology(conv_layers=(JSpec(**layer),), **kw), TTopology(conv_layers=(TSpec(**layer),), **kw)


def test_integer_pow2_head_equals_fp32_decode_head():
    """The reference's p2head topology: the packed head's integer
    rendering equals its fp32 decode on on-grid activations, and both
    equal the reference's plans."""
    jt, tt = _p2head()
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), jt))
    tparams = params_from_numpy(params, "cpu")
    x = _grid(np.random.default_rng(1).normal(size=(2, 12, 12, 2)))
    base = dict(act_bits=8, pow2_weights=True, per_layer_bits=(8,))
    out = {}
    for key, q in (("fp", base), ("i8", dict(base, int8_compute=True))):
        plan = tcompiler.compile_dhm(tt, tparams, quant=tcompiler.QuantSpec(**q), device="cpu")
        jplan = jcompiler.compile_dhm(jt, params, quant=jcompiler.QuantSpec(**q), backend="ref")
        with torch.no_grad():
            out[key] = plan(x).numpy()
        np.testing.assert_array_equal(out[key], np.asarray(jplan(jnp.asarray(x))))
    np.testing.assert_array_equal(out["i8"], out["fp"])


def test_stage_quant_kwargs_rebuild_matches():
    """The per-layer rung's rebuilds (emit_conv_stage from
    stage_quant_kwargs) reproduce the plan's int8 stage bodies exactly."""
    params, _ = _setup("lenet5")
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**_int8()), device="cpu")
    kw = plan.stage_quant_kwargs(0)
    assert kw["int8_scales"] == plan.int8_scales
    x = torch.from_numpy(_on_grid_frames("lenet5", 6))
    st = plan.stages[0]
    rebuilt = tcompiler.emit_conv_stage(st.specs, **kw)
    np.testing.assert_array_equal(rebuilt(plan.stage_params(0), x).numpy(),
                                  st.fn(plan.stage_params(0), x).numpy())


@pytest.mark.parametrize("name", ["lenet5", "cifar10"])
def test_engine_per_layer_rung_on_int8_plan_equals_fused_rung(name):
    params, x = _setup(name)
    q = dict(act_bits=8, pow2_weights=True, int8_compute=True,
             per_layer_bits=(8,) * len(TORCH_TOPOLOGIES[name].conv_layers))
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES[name], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**q), device="cpu")
    with torch.no_grad():
        want = plan(x).numpy()
    eng = Engine(plan, warmup=False, auto_flush=False)
    rungs = dict(eng._ladder)
    assert list(rungs) == ["fused", "per_layer"]
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(rungs["fused"]()(xt).numpy(), want)
    np.testing.assert_array_equal(rungs["per_layer"]()(xt).numpy(), want)
    np.testing.assert_array_equal(eng.infer(x).numpy(), want)
    assert eng.rung == "fused" and eng.demotions == []


@pytest.mark.parametrize("name", NAMES)
def test_int8_kernels_count_one_byte_per_slab_element(name):
    """The int8 pyramid's slabs at the int8 plan's block: a quarter of the
    fp32 bytes, the second buffer starting on a 16-byte boundary (cifar10:
    6,480 + 17,920 = 24,400 B); the single-layer slab likewise."""
    tt = TORCH_TOPOLOGIES[name]
    (grp,) = tfusion.plan_fusion_groups(tt, tuple(range(len(tt.conv_layers))), elem_bytes=1)
    geom = tfusion._group_geom(tt, grp.layers, grp.block_rows)
    buf0, buf1 = kconv.pyramid_buffers(geom, 1)
    assert buf0 % kconv.INT8_BUF_ALIGN == 0
    assert buf0 - kconv.INT8_BUF_ALIGN < kconv.pyramid_buffers(geom)[0] <= buf0
    assert kconv.pyramid_smem_bytes(geom, 1) == buf0 + buf1 <= kconv.SMEM_LIMIT
    if name in ("cifar10", "svhn"):
        assert kconv.pyramid_smem_bytes(geom, 1) == 24_400
    h, w = tt.input_shape
    spec = tt.conv_layers[0]
    kw = dict(k=spec.kernel, stride=spec.stride, pool=spec.pool, pool_stride=spec.pool_stride,
              block_r=8)
    g4 = kconv.fused_geometry(h + 4, w + 4, tt.input_channels, **kw)
    g1 = kconv.fused_geometry(h + 4, w + 4, tt.input_channels, elem_bytes=1, **kw)
    assert g1["smem"] * 4 == g4["smem"] and g1["r"] == g4["r"]
