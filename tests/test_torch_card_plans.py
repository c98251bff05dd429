"""Plans that the reference serves and the card must serve too, on the CPU:
the card's fusion groups (``conv.card_groups`` through
``compiler.card_fusion_groups``), the single-layer kernel's column strips
and channel slices, any pool window, and the selective scan at N above 16.

The card's groups are planned in plain Python, so they are checked here
against the limits the kernels have (``MAX_PYRAMID_LAYERS`` layers,
``SMEM_LIMIT`` bytes); a regrouped stage is run on CPU tensors (the
kernels' plain versions) against the reference's grouping; the CPU plans
are held against the reference's plans (``backend="ref"`` and
``"pallas"``, never the interpret oracle) on the same numpy inputs. The
kernels themselves run these plans in ``test_torch_kernels_card.py``.

Tolerances: fp32 rtol=1e-4, atol=1e-5 (the reference's own; the plain
pyramid and a chain of plain single layers sum in other orders), int8
equal (integer sums), the scan atol 1e-5 (the reference's own).
"""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.dhm import compiler as jcompiler  # noqa: E402
from repro.core.dhm.engine import forward as jax_forward  # noqa: E402
from repro.kernels.ssm_scan import ssm_scan_ref as j_ssm_scan_ref  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.core.dhm.fusion import _group_geom, plan_fusion_groups  # noqa: E402
from repro_torch.core.quant.fixed_point import dynamic_spec, quantize_fixed  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import halo as thalo  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import Int8Scales  # noqa: E402
from repro_torch.models import cnn as tcnn  # noqa: E402

FP32 = dict(rtol=1e-4, atol=1e-5)
SCAN_ATOL = 1e-5


def _smoke():
    """chip_smoke.py, whose regroup_topologies the card runs too."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _extra(cnn):
    """Topologies the card regroups, in the given package's classes: the
    smoke's five layers and a two-layer pair on a 32 x 1024 frame that the
    reference fuses and no pyramid block of the card holds in fp32."""
    spec = cnn.ConvLayerSpec(n_out=8, kernel=5, padding="SAME", pool=2, act="relu")
    return {**_smoke().regroup_topologies(cnn),
            "split": cnn.CNNTopology("split", (32, 1024), 3, (spec, spec), (), 10)}


TORCH = {**_extra(tcnn), **tcnn.ALL_TOPOLOGIES}
JAX = {**_extra(jcnn), **jcnn.ALL_TOPOLOGIES}
NEW = ("five", "pool4", "wide")


def _params(topo, seed=0):
    """Params at the reference init's scale with small biases, numpy."""
    rng = np.random.default_rng(seed)
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
    return params


def _frames(topo, b=2, seed=1):
    h, w = topo.input_shape
    return np.random.default_rng(seed).normal(size=(b, h, w, topo.input_channels)).astype(
        np.float32)


def _card(name, elem_bytes):
    topo = TORCH[name]
    idxs = tuple(range(len(topo.conv_layers)))
    ref = plan_fusion_groups(topo, idxs, elem_bytes=elem_bytes)
    return topo, ref, tcompiler.card_fusion_groups(topo, idxs, ref, elem_bytes=elem_bytes)


@pytest.mark.parametrize("elem_bytes", [4, 1])
@pytest.mark.parametrize("name", sorted(TORCH))
def test_card_groups_fit_the_pyramid_kernel(name, elem_bytes):
    """Every multi-layer card group has at most four layers and fits a
    Hopper block at its block_rows; the groups cover the layers in order;
    the paper's topologies keep the reference's groups."""
    topo, ref, card = _card(name, elem_bytes)
    assert [li for g in card for li in g.layers] == list(range(len(topo.conv_layers)))
    for g in card:
        if g.fused:
            assert len(g.layers) <= kconv.MAX_PYRAMID_LAYERS
            geom = _group_geom(topo, g.layers, g.block_rows)
            assert kconv.pyramid_smem_bytes(geom, elem_bytes) <= kconv.SMEM_LIMIT
            assert g.block_rows >= 1
        else:
            assert g.block_rows == 0
    if name in tcnn.ALL_TOPOLOGIES:
        assert card == ref


def test_five_layers_split_at_four_and_keep_the_reference_block():
    _, ref, card = _card("five", 4)
    assert [g.layers for g in ref] == [(0, 1, 2, 3, 4)]
    assert [g.layers for g in card] == [(0, 1, 2, 3), (4,)]
    assert card[0].block_rows == ref[0].block_rows


def test_a_group_above_shared_memory_is_split_after_smaller_blocks():
    """The int8 reference fuses the wide frame's two layers; no block of
    rows fits their one-byte slabs on the card, so each runs alone (the
    single-layer kernel cuts the frame into column strips)."""
    spec = tcnn.ConvLayerSpec(n_out=8, kernel=5, padding="SAME", pool=2, act="relu")
    topo = tcnn.CNNTopology("wide2", (64, 4100), 3, (spec, spec), (), 10)
    ref = plan_fusion_groups(topo, (0, 1), elem_bytes=1)
    assert [g.layers for g in ref] == [(0, 1)]
    card = tcompiler.card_fusion_groups(topo, (0, 1), ref, elem_bytes=1)
    assert [(g.layers, g.block_rows) for g in card] == [((0,), 0), ((1,), 0)]


@pytest.mark.parametrize("name", NEW)
def test_cpu_plans_keep_the_reference_groups(name):
    params = _params(JAX[name])
    plan = tcompiler.compile_dhm(TORCH[name], params_from_numpy(params, "cpu"), device="cpu")
    jplan = jcompiler.compile_dhm(JAX[name], params, backend="ref")
    assert [(g.layers, g.block_rows, g.working_set) for g in plan.fusion_groups] == [
        (g.layers, g.block_rows, g.working_set) for g in jplan.fusion_groups]


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_plan_logits_match_the_reference(name, backend):
    params, x = _params(JAX[name]), _frames(JAX[name])
    want = jax_forward(jcompiler.compile_dhm(JAX[name], params, backend=backend), jnp.asarray(x))
    plan = tcompiler.compile_dhm(TORCH[name], params_from_numpy(params, "cpu"), device="cpu")
    with torch.no_grad():
        got = plan(x).numpy()
    np.testing.assert_allclose(got, np.asarray(want), **FP32)


def _stage(topo, groups, **kw):
    return tcompiler.emit_conv_stage(
        topo.conv_layers, groups=tuple((g.layers, g.block_rows) for g in groups), **kw)


@pytest.mark.parametrize("name,mode", [("five", "fp32"), ("five", "act_bits"), ("five", "int8"),
                                       ("split", "fp32"), ("split", "act_bits")])
def test_a_regrouped_stage_computes_the_same_numbers(name, mode):
    """The card's groups against the reference's, both on CPU tensors:
    one FMA chain per output either way (equal at the fp32 tolerance),
    int8 bit for bit."""
    topo = TORCH[name]
    elem_bytes = 1 if mode == "int8" else 4
    _, ref, card = _card(name, elem_bytes)
    assert card != ref
    params = params_from_numpy(_params(JAX[name]), "cpu")["conv"]
    x = torch.from_numpy(_frames(topo, b=3))
    kw = {}
    if mode == "act_bits":
        kw = dict(act_bits=6)
    elif mode == "int8":
        scales, baked = [], []
        for p in params:
            spec = dynamic_spec(p["w"], 8)
            baked.append({"w": quantize_fixed(p["w"], spec).to(torch.int8),
                          "b": p["b"]})
            scales.append(Int8Scales(in_bits=8, w_scale=spec.scale))
        params, kw = baked, dict(act_bits=8, int8_scales=tuple(scales))
    with torch.no_grad():
        want = _stage(topo, ref, **kw)(params, x)
        got = _stage(topo, card, **kw)(params, x)
    if mode == "fp32":
        torch.testing.assert_close(got, want, **FP32)
    else:
        assert torch.equal(got, want)


def test_one_topology_is_laid_out_once():
    """compile_dhm caches the stage layout of a topology (the actor walk),
    as the reference does: a second compile of it walks nothing."""
    topo = TORCH["five"]
    params = params_from_numpy(_params(JAX["five"]), "cpu")
    tcompiler.compile_dhm(topo, params, device="cpu")
    before = tcompiler._cached_layout.cache_info()
    tcompiler.compile_dhm(topo, params, device="cpu")
    after = tcompiler._cached_layout.cache_info()
    assert (after.hits, after.misses) == (before.hits + 1, before.misses)


@pytest.mark.parametrize("h,w,k,stride,padding", [
    (32, 4100, 5, 1, "SAME"), (17, 9, 4, 2, "SAME"), (7, 7, 3, 3, "SAME"), (12, 30, 5, 1, "VALID")])
def test_the_planner_sizes_the_frame_the_launcher_pads(h, w, k, stride, padding):
    """The card's plan checks each single layer over ``halo.padded_frame``,
    the frame stream_conv_block hands its launcher."""
    from repro_torch.kernels.stream_conv import ops as tops

    x = torch.zeros(1, h, w, 2)
    padded = tops._pad_same(x, k, stride) if padding == "SAME" else x
    assert thalo.padded_frame(h, w, k, stride, padding) == tuple(padded.shape[1:3])


def test_a_layer_the_card_cannot_serve_is_refused_when_compiled():
    """An 11 x 11 tap table over 512 channels (61,952 words) exceeds a
    Hopper block on its own: no strip or slice helps, and the card's plan
    says so at compile time, not at its first call."""
    topo = tcnn.CNNTopology(
        "huge_taps", 16, 512, (tcnn.ConvLayerSpec(n_out=8, kernel=11, padding="SAME", pool=0,
                                                  act="relu"),), (), 10)
    ref = plan_fusion_groups(topo, (0,))
    with pytest.raises(ValueError, match="huge_taps conv layer 0 cannot run on the card"):
        tcompiler.card_fusion_groups(topo, (0,), ref)


@pytest.mark.parametrize("in_cols,k,stride,pool,ps,strip", [
    (4100, 5, 1, 2, 2, 64), (4100, 5, 1, 3, 2, 7), (1001, 3, 2, 0, 0, 33),
    (257, 7, 1, 4, 4, 5), (96, 3, 1, 1, 2, 10), (40, 5, 2, 2, 1, 3),
])
def test_column_strips_cover_what_each_output_column_reads(in_cols, k, stride, pool, ps, strip):
    strips = thalo.column_strips(in_cols, k, stride, pool, ps, strip)
    conv_cols = (in_cols - k) // stride + 1
    out_cols = (conv_cols - pool) // ps + 1 if pool else conv_cols
    assert [o for _, _, lo, hi in strips for o in range(lo, hi)] == list(range(out_cols))
    for in_lo, in_hi, lo, hi in strips:
        assert 0 <= in_lo < in_hi <= in_cols and hi - lo <= strip
        reads = {(o * (ps or 1) + i) * stride + kj
                 for o in range(lo, hi) for i in range(max(pool, 1)) for kj in range(k)}
        assert min(reads) == in_lo and max(reads) == in_hi - 1


@pytest.mark.parametrize("elem_bytes,wd", [(4, 4104), (1, 12004)])
def test_a_frame_too_wide_for_one_block_runs_in_column_strips(elem_bytes, wd):
    """Even the smallest row block over the whole padded frame (the wide
    topology's layer in fp32; a wider one for the one-byte int8 slab)
    exceeds a Hopper block, so the launcher's plan cuts it into strips,
    each within the block."""
    kw = dict(k=5, stride=1, pool=2, pool_stride=None, block_r=8, n_out=8,
              elem_bytes=elem_bytes)
    with pytest.raises(ValueError, match="shared memory"):
        kconv.fused_geometry(16, wd, 3, **kw)
    g = kconv.fused_plan(16, wd, 3, **kw)
    assert len(g["strips"]) > 1 and g["smem"] <= kconv.SMEM_LIMIT
    assert g["strips"] == thalo.column_strips(wd, 5, 1, 2, 2, g["strips"][0][3])
    w_keep = (wd - 4 - 2) // 2 + 1
    assert [o for _, _, lo, hi in g["strips"] for o in range(lo, hi)] == list(range(w_keep))
    # The caller's block_w is the reference's: conv columns per strip.
    g = kconv.fused_plan(16, wd, 3, block_w=100, **kw)
    assert all(hi - lo <= 50 for _, _, lo, hi in g["strips"])


def test_weight_stages_above_a_block_run_in_channel_slices():
    """1,024 output channels: two stages of 64 rows of them are 512 KB, so
    the fp32 launcher runs slices of the channels, one launch each."""
    g = kconv.fused_plan(12, 12, 8, k=3, stride=1, pool=0, pool_stride=None, block_r=8,
                         n_out=1024)
    assert len(g["slices"]) > 1 and g["smem"] <= kconv.SMEM_LIMIT
    assert [n for lo, hi in g["slices"] for n in range(lo, hi)] == list(range(1024))
    assert all(lo % 4 == 0 for lo, _ in g["slices"])


@pytest.mark.parametrize("pool", [1, 4, 5])
def test_every_pool_window_has_a_layout(pool):
    """Windows other than 2 and 3 take the run-time window path, compiled
    at TN = 4."""
    g = kconv.fused_geometry(40, 40, 8, k=3, stride=1, pool=pool, pool_stride=None, block_r=8,
                             n_out=16)
    assert g["smem"] <= kconv.SMEM_LIMIT
    if pool > 3:
        assert g["tn"] == 4 and kconv.tile_n(pool, 16, 64) == 4


@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("with_h0", [False, True])
def test_plain_scan_matches_the_reference_above_sixteen_states(n, with_h0):
    """The kernel took at most 16 states; the plain version, which the
    card's kernel is held against, agrees with the reference's at more."""
    rng = np.random.default_rng(n)
    bz, s, d = 2, 11, 24
    x = (rng.normal(size=(bz, s, d)) * 0.5).astype(np.float32)
    dt = np.logaddexp(0.0, rng.normal(size=(bz, s, d))).astype(np.float32)
    b, c = (rng.normal(size=(bz, s, n)).astype(np.float32) for _ in range(2))
    a = (-np.exp(rng.normal(size=(d, n)) * 0.3)).astype(np.float32)
    d_skip = rng.normal(size=(d,)).astype(np.float32)
    args = [torch.from_numpy(v) for v in (x, dt, b, c, a, d_skip)]
    y, h_last = ssm_scan(*args)
    assert h_last.shape == (bz, d, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_ssm_scan_ref(x, dt, b, c, a, d_skip)),
                               atol=SCAN_ATOL)
    if with_h0:
        # Two halves with the state carried equal one scan.
        y1, h1 = ssm_scan(*(t[:, :5] for t in args[:4]), *args[4:])
        y2, h2 = ssm_scan(*(t[:, 5:] for t in args[:4]), *args[4:], h1)
        torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=0, atol=1e-6)
        torch.testing.assert_close(h2, h_last, rtol=0, atol=1e-6)
