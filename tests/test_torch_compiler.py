"""The port's compile_dhm plans on the CPU, held against the reference's
plans on the same params (carried across with ``params_from_numpy``) and
the same numpy frames: all five topologies, fp32 and 6-bit fake-quant,
n_stages 1..L, fused and ``vmem_budget=0``.

Tolerances: fp32 logits rtol=1e-4, atol=1e-5 (the reference's own). Under
fake-quant the conv features are equal except where an fp32 sum in
another order crosses a rounding boundary (those elements sit exactly one
quant step apart and are counted); a frame whose features are all equal
must then give logits equal at the fp32 tolerance, and at most
``MAX_OFF_FRAMES`` frames may carry an off-by-one-step feature.
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
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro.models.cnn import cnn_apply_reference as jax_cnn_apply_reference  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES as TORCH_TOPOLOGIES  # noqa: E402
from repro_torch.models.cnn import cnn_apply, cnn_apply_reference  # noqa: E402

NAMES = sorted(JAX_TOPOLOGIES)
FP32 = dict(rtol=1e-4, atol=1e-5)
BATCH = 3
MAX_OFF_FRAMES = 1


@functools.lru_cache(maxsize=None)
def _setup(name):
    """Params at the reference init's scale (normal * sqrt(2 / fan_in)),
    with small non-zero biases, and frames: numpy from a seed, fed to
    both packages."""
    topo = JAX_TOPOLOGIES[name]
    rng = np.random.default_rng(0)
    params, c = {"conv": [], "fc": []}, topo.input_channels
    for spec in topo.conv_layers:
        shape = (spec.kernel, spec.kernel, c, spec.n_out)
        params["conv"].append({
            "w": (rng.normal(size=shape) * np.sqrt(2.0 / np.prod(shape[:3]))).astype(np.float32),
            "b": (rng.normal(size=(spec.n_out,)) * 0.1).astype(np.float32),
        })
        c = spec.n_out
    dims = (int(np.prod(topo.feature_shape())),) + tuple(topo.fc_dims) + (topo.n_classes,)
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        params["fc"].append({
            "w": (rng.normal(size=(d_in, d_out)) * np.sqrt(2.0 / d_in)).astype(np.float32),
            "b": (rng.normal(size=(d_out,)) * 0.1).astype(np.float32),
        })
    h, w = topo.input_shape
    x = np.random.default_rng(1).normal(size=(BATCH, h, w, topo.input_channels))
    return params, x.astype(np.float32)


def test_params_from_numpy_carries_the_reference_init_across():
    """The reference's own init tree, as ``jax.device_get`` gives it,
    runs unchanged through the port: same layouts, same logits."""
    topo = JAX_TOPOLOGIES["lenet5"]
    params = jax.device_get(jax_init_cnn(jax.random.PRNGKey(0), topo))
    tparams = params_from_numpy(params, "cpu")
    for group in ("conv", "fc"):
        for got, want in zip(tparams[group], params[group]):
            for key in ("w", "b"):
                assert got[key].dtype == torch.float32
                np.testing.assert_array_equal(got[key].numpy(), want[key])
    _, x = _setup("lenet5")
    want = jax_forward(jcompiler.compile_dhm(topo, params, backend="ref"), jnp.asarray(x))
    got = tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], tparams, device="cpu")(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


def _quant(bits):
    return dict(weight_bits=bits, act_bits=bits) if bits else {}


@functools.lru_cache(maxsize=None)
def _reference(name, bits, backend="ref"):
    """(features, logits) of the reference plan, n_stages=1, eager."""
    params, x = _setup(name)
    plan = jcompiler.compile_dhm(
        JAX_TOPOLOGIES[name], params, quant=jcompiler.QuantSpec(**_quant(bits)),
        backend=backend,
    )
    feats = plan.features(jnp.asarray(x))
    return np.asarray(feats), np.asarray(jax_forward(plan, jnp.asarray(x)))


def _assert_plan_matches(got_feats, got_logits, want_feats, want_logits, bits):
    if bits is None:
        np.testing.assert_allclose(got_feats, want_feats, **FP32)
        np.testing.assert_allclose(got_logits, want_logits, **FP32)
        return
    step = stream_quant_spec(bits).scale
    d = np.abs(got_feats - want_feats)
    off = d > 1e-6
    np.testing.assert_allclose(d[off], step, rtol=1e-5)
    off_frames = off.reshape(off.shape[0], -1).any(axis=1)
    assert off_frames.sum() <= MAX_OFF_FRAMES, int(off.sum())
    np.testing.assert_allclose(got_logits[~off_frames], want_logits[~off_frames], **FP32)


def _groups(plan):
    return [(g.layers, g.block_rows, g.working_set) for g in plan.fusion_groups]


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("bits", [None, 6])
def test_compile_dhm_logits_match_reference(name, bits):
    params, x = _setup(name)
    want_feats, want_logits = _reference(name, bits)
    tparams = params_from_numpy(params, "cpu")
    jt, tt = JAX_TOPOLOGIES[name], TORCH_TOPOLOGIES[name]
    for n_stages in range(1, len(tt.conv_layers) + 1):
        for budget in (None, 0):
            plan = tcompiler.compile_dhm(
                tt, tparams, quant=tcompiler.QuantSpec(**_quant(bits)),
                n_stages=n_stages, device="cpu", vmem_budget=budget,
            )
            jplan = jcompiler.compile_dhm(
                jt, params, quant=jcompiler.QuantSpec(**_quant(bits)),
                n_stages=n_stages, backend="ref", vmem_budget=budget,
            )
            assert _groups(plan) == _groups(jplan)
            assert [st.conv_layers for st in plan.stages] == [
                st.conv_layers for st in jplan.stages
            ]
            assert [st.io.out_shape for st in plan.stages] == [
                st.io.out_shape for st in jplan.stages
            ]
            with torch.no_grad():
                feats = plan.features(torch.from_numpy(x)).numpy()
                logits = plan(x).numpy()
            _assert_plan_matches(feats, logits, want_feats, want_logits, bits)


@pytest.mark.parametrize("name", NAMES)
def test_compile_dhm_matches_reference_pallas_backend(name):
    """Against the reference's default backend (on the CPU: the XLA
    rendering of the fused pyramid kernel)."""
    params, x = _setup(name)
    _, want = _reference(name, None, backend="pallas")
    plan = tcompiler.compile_dhm(
        TORCH_TOPOLOGIES[name], params_from_numpy(params, "cpu"), device="cpu"
    )
    np.testing.assert_allclose(plan(x).numpy(), want, **FP32)


def test_per_layer_bits_plan_matches_reference():
    params, x = _setup("cifar10")
    q = dict(per_layer_bits=(6, 5, 4), act_bits=6, weight_bits=6)
    jplan = jcompiler.compile_dhm(JAX_TOPOLOGIES["cifar10"], params,
                                  quant=jcompiler.QuantSpec(**q), backend="ref")
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES["cifar10"], params_from_numpy(params, "cpu"),
                                 quant=tcompiler.QuantSpec(**q), device="cpu")
    want_feats = np.asarray(jplan.features(jnp.asarray(x)))
    want = np.asarray(jax_forward(jplan, jnp.asarray(x)))
    with torch.no_grad():
        feats = plan.features(torch.from_numpy(x)).numpy()
        logits = plan(x).numpy()
    _assert_plan_matches(feats, logits, want_feats, want, 4)


@pytest.mark.parametrize("name", ["lenet5", "cifar10_full"])
@pytest.mark.parametrize("bits", [None, 6])
def test_cnn_apply_and_reference_forward_match(name, bits):
    params, x = _setup(name)
    want = np.asarray(jax_cnn_apply_reference(
        jax.tree_util.tree_map(jnp.asarray, params), JAX_TOPOLOGIES[name], jnp.asarray(x),
        weight_bits=bits, act_bits=bits,
    ))
    tparams = params_from_numpy(params, "cpu")
    tt = TORCH_TOPOLOGIES[name]
    with torch.no_grad():
        ref = cnn_apply_reference(tparams, tt, torch.from_numpy(x),
                                  weight_bits=bits, act_bits=bits).numpy()
        got = cnn_apply(tparams, tt, torch.from_numpy(x), weight_bits=bits,
                        act_bits=bits).numpy()
    tol = FP32 if bits is None else dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref, want, **tol)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize(
    "quant,item",
    [(dict(int8_compute=True, weight_bits=8, act_bits=8), "int8"),
     (dict(pow2_weights=True), "pow2")],
)
def test_unported_quant_modes_raise(quant, item):
    params, _ = _setup("lenet5")
    with pytest.raises(NotImplementedError, match=item):
        tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], params_from_numpy(params, "cpu"),
                              quant=tcompiler.QuantSpec(**quant), device="cpu")


def test_validation_errors_match_reference():
    import dataclasses

    from repro.models.cnn import ConvLayerSpec as JSpec
    from repro_torch.models.cnn import ConvLayerSpec as TSpec

    for field, value in (("act", "rleu"), ("padding", "FULL"), ("stride", 0),
                         ("pool_stride", 0)):
        kw = {"n_out": 4, "kernel": 3, "padding": "SAME", field: value}
        jt = dataclasses.replace(JAX_TOPOLOGIES["cifar10"], conv_layers=(JSpec(**kw),))
        tt = dataclasses.replace(TORCH_TOPOLOGIES["cifar10"], conv_layers=(TSpec(**kw),))
        with pytest.raises(ValueError) as want:
            jcompiler.validate_topology(jt)
        with pytest.raises(ValueError) as got:
            tcompiler.validate_topology(tt)
        assert str(got.value) == str(want.value)


def test_check_plan_catches_non_finite_params_and_bad_heads():
    params, _ = _setup("lenet5")
    tparams = params_from_numpy(params, "cpu")
    plan = tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], tparams, device="cpu")
    plan.self_check()
    tparams["conv"][1]["w"][0, 0, 0, 0] = float("nan")
    bad = tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], tparams, device="cpu")
    with pytest.raises(tcompiler.PlanCheckError) as err:
        bad.self_check()
    assert err.value.invariants == ("V301",)
    narrow = params_from_numpy(params, "cpu")
    narrow["fc"][-1]["w"] = narrow["fc"][-1]["w"][:, :7].contiguous()
    narrow["fc"][-1]["b"] = narrow["fc"][-1]["b"][:7].contiguous()
    with pytest.raises(tcompiler.PlanCheckError) as err:
        tcompiler.compile_dhm(TORCH_TOPOLOGIES["lenet5"], narrow, device="cpu").self_check()
    assert err.value.invariants == ("V304",)
