"""The stream-conv group's gradient, what of it runs on the CPU: the
backward wrapper's argument checks (the same on every device), the plan
of launches and tiles its kernels take for every layer of every
topology's fusion groups (``conv.bwd_plan``, with H100 values), and the
CPU path, which stays autograd of ``ref.py``'s composition. The kernels
themselves run in ``tests/test_torch_stream_conv_bwd_card.py``."""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.analysis.invariants import planned_backward_launches  # noqa: E402
from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import ops as kops  # noqa: E402
from repro_torch.kernels.stream_conv import ref as kref  # noqa: E402
from repro_torch.kernels.stream_conv import stream_conv_block, stream_conv_pyramid  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import Int8Scales  # noqa: E402
from repro_torch.kernels.stream_conv.halo import (  # noqa: E402
    PyramidLayer,
    as_pyramid_layers,
    group_geometry,
)
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

NAMES = sorted(ALL_TOPOLOGIES)
H100_SMS = 132


def _group_geometries(topo, vmem_budget):
    """(geometry, input needs a gradient) of each fusion group of the
    topology's plan (compiled on the CPU), in order."""
    plan = compile_dhm(topo, init_cnn(torch.Generator().manual_seed(0), topo, device="cpu"),
                       device="cpu", vmem_budget=vmem_budget)
    specs = topo.conv_layers
    (h, w), c = topo.input_shape, topo.input_channels
    out = []
    for i, g in enumerate(plan.fusion_groups):
        idx = list(g.layers)
        layers = as_pyramid_layers([specs[j] for j in idx])
        geom = group_geometry(h, w, c, layers, [specs[j].kernel for j in idx],
                              [specs[j].n_out for j in idx])
        out.append((geom, i > 0))
        h, w, c = geom.out_rows, geom.out_cols, specs[idx[-1]].n_out
    return plan, out


def _check_conv_launch(d, rows_total, kin, nout, k):
    assert d["smem"] <= kconv.SMEM_LIMIT
    assert d["threads"] % 32 == 0 and 32 <= d["threads"] <= 32 * kconv.BWD_MAX_WARPS
    assert d["kc"] in (kconv.K_STAGE, -(-(k * k * kin) // 4) * 4)
    assert d["wpt"] in (1, 2, 4) and d["tn"] in (4, 8)
    assert d["np"] % 4 == 0 and d["np"] >= -(-nout // d["tn"]) * d["tn"]
    assert d["cs"] % 2 == 1 and d["cs"] >= kin
    assert d["tap_off"] % 4 == 0 and d["wst_off"] % 4 == 0
    assert d["wst_off"] - d["tap_off"] >= k * k * kin
    assert (d["n_rb"] - 1) * d["rows"] < rows_total <= d["n_rb"] * d["rows"]


@pytest.mark.parametrize("batch", [1, 16, 128])
@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("name", NAMES)
def test_the_plan_fits_every_layer_of_every_group(name, vmem_budget, batch):
    _, groups = _group_geometries(ALL_TOPOLOGIES[name], vmem_budget)
    for geom, need_dx in groups:
        plan = kconv.bwd_plan(geom, batch, H100_SMS, need_dx)
        assert kconv.bwd_launches(len(plan), need_dx) == 3 * len(plan) + need_dx
        for i, (lp, g) in enumerate(zip(plan, geom.layers)):
            r = lp.recompute
            _check_conv_launch(r, g.out_rows, g.in_ch, g.n_out, g.k)
            m_rows = (r["rows"] - 1) * (g.ps or 1) + (g.pw or 1)
            assert r["y_off"] - r["wst_off"] >= r["kc"] * r["np"]
            assert r["ys"] % 2 == 1 and r["ys"] >= g.n_out
            assert r["smem"] == 4 * (r["y_off"] + m_rows * r["wc"] * r["ys"])
            assert (lp.dx is None) == (i == 0 and not need_dx)
            if lp.dx is not None:
                _check_conv_launch(lp.dx, g.in_rows, g.n_out, g.in_ch, g.k)
            d = lp.dw
            assert d["kk1"] == g.k * g.k * g.in_ch + 1
            assert d["kth"] * d["tk"] * d["ktiles"] >= d["kk1"] > d["kth"] * d["tk"] * (d["ktiles"] - 1)
            assert 1 <= d["tk"] <= 8 and d["tn"] in (4, 8)
            assert d["np"] == d["ng"] * d["tn"] >= g.n_out > (d["ng"] - 1) * d["tn"]
            assert d["ng"] * d["kth"] <= d["threads"] <= kconv.THREADS and d["threads"] % 32 == 0
            assert d["cs"] % 2 == 1 and d["cs"] >= g.in_ch + 1
            assert d["units"] == batch * d["n_rb"] and 1 <= d["parts"] <= d["units"]
            assert d["smem"] <= kconv.SMEM_LIMIT and d["dz_off"] % 4 == 0


def test_the_tiles_adapt_to_the_layer_shapes():
    """cifar10's first layer (3 channels, 75 K rows) takes a narrow dW tile
    in one K tile; its 800-row layers split K into tiles; the recompute's
    largest tile where the block has the positions, a narrow one where it
    has few."""
    assert kconv.bwd_dw_tile(76, 32) == dict(tn=4, ng=8, kth=32, tk=3, ktiles=1, threads=256)
    assert kconv.bwd_dw_tile(801, 32) == dict(tn=8, ng=4, kth=64, tk=7, ktiles=2, threads=256)
    assert kconv.bwd_dw_tile(801, 64) == dict(tn=8, ng=8, kth=32, tk=7, ktiles=4, threads=256)
    assert kconv.bwd_dw_tile(26, 20) == dict(tn=4, ng=5, kth=26, tk=1, ktiles=1, threads=160)
    tiles = kconv.bwd_conv_tiles(512, 32)
    assert (4, 8, 16, 1) in tiles  # 8 position blocks x 2 pairs, 16 warps, one round
    assert (1, 8, 16, 4) in tiles  # 32 position blocks x 2 pairs, 4 rounds
    assert (1, 4, 8, 1) in kconv.bwd_conv_tiles(16, 64)


def test_the_cost_model_prefers_whole_blocks_when_staging_dominates():
    """The weights of an 800-row layer stage once a block: the planner
    keeps cifar10's inner layers in a few large blocks, where one row a
    block would stage them 8 to 16 times as often."""
    topo = ALL_TOPOLOGIES["cifar10"]
    (_, [(geom, _)]) = _group_geometries(topo, None)
    plan = kconv.bwd_plan(geom, 128, H100_SMS, False)
    assert plan[1].recompute["n_rb"] <= 2 and plan[2].recompute["n_rb"] <= 2
    assert plan[1].dx["n_rb"] <= 2 and plan[2].dx["n_rb"] <= 2


@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("name", NAMES)
def test_planned_backward_launches_follow_the_groups(name, vmem_budget):
    plan, groups = _group_geometries(ALL_TOPOLOGIES[name], vmem_budget)
    # Launches of the plans the wrapper makes: a dx where one is planned.
    want = sum(sum(2 + (lp.dx is not None) for lp in kconv.bwd_plan(geom, 8, H100_SMS, need)) + 1
               for geom, need in groups)
    assert planned_backward_launches(plan) == want
    assert planned_backward_launches(plan, frame_grad=True) == want + 1


def test_a_pool_window_above_the_index_byte_raises():
    geom = group_geometry(40, 40, 1, (PyramidLayer("VALID", 1, "none", 16),), (1,), (2,))
    with pytest.raises(ValueError, match="pool window 16"):
        kconv.bwd_plan(geom, 1, H100_SMS, False)


def _operands(dtype=torch.float32):
    layers = (PyramidLayer("SAME", 1, "tanh", 2), PyramidLayer("VALID", 1, "relu", 0))
    geom = group_geometry(8, 8, 3, layers, (3, 3), (4, 5))
    x = torch.zeros(2, 8, 8, 3, dtype=dtype)
    ws = [torch.zeros(3, 3, 3, 4), torch.zeros(3, 3, 4, 5)]
    bs = [torch.zeros(4), torch.zeros(5)]
    g = torch.zeros(2, 2, 2, 5)
    return layers, geom, x, ws, bs, g


def test_the_wrapper_checks_dtype_shape_and_contiguity():
    layers, geom, x, ws, bs, g = _operands()
    kconv.check_bwd_operands(x, ws, bs, g, geom)  # passes
    with pytest.raises(ValueError, match="x must be float32"):
        kconv.check_bwd_operands(x.double(), ws, bs, g, geom)
    with pytest.raises(ValueError, match=r"g must have shape \(2, 2, 2, 5\)"):
        kconv.check_bwd_operands(x, ws, bs, g[:, :1].contiguous(), geom)
    with pytest.raises(ValueError, match=r"weights\[1\] must be contiguous"):
        kconv.check_bwd_operands(x, [ws[0], ws[1].transpose(0, 1)], bs, g, geom)
    with pytest.raises(ValueError, match=r"biases\[0\] must be float32"):
        kconv.check_bwd_operands(x, ws, [bs[0].half(), bs[1]], g, geom)


def test_the_wrapper_refuses_tensors_off_the_card():
    layers, _, x, ws, bs, g = _operands()
    with pytest.raises(ValueError, match="x must be a CUDA tensor"):
        kconv.stream_conv_pyramid_bwd_cuda(x, ws, bs, g, layers=layers, act_bits=(None, None),
                                           need_dx=False)
    with pytest.raises(ValueError, match="takes 1 to 4 layers"):
        kconv.stream_conv_pyramid_bwd_cuda(x, ws * 3, bs * 3, g, layers=layers * 3,
                                           act_bits=(None,) * 6, need_dx=False)


def test_an_int8_group_with_grad_raises_on_every_device():
    w = torch.ones(3, 3, 1, 2, dtype=torch.int8)
    x = torch.zeros(1, 6, 6, 1, requires_grad=True)
    b = torch.zeros(2)
    sc = Int8Scales(in_bits=4, w_scale=0.25)
    with pytest.raises(ValueError, match="forward-only"):
        stream_conv_block(x, w, b, act_bits=4, int8_scales=sc, pool=0)
    with pytest.raises(ValueError, match="forward-only"):
        stream_conv_pyramid(x, [w], [b], layers=[PyramidLayer()], act_bits=4, int8_scales=[sc])


@pytest.mark.parametrize("bits", [None, 4])
def test_a_cpu_tensor_takes_the_composition(monkeypatch, bits):
    """On the CPU the gradient is autograd of ``ref.py``'s composition, bit
    for bit, and never the card's wrapper; no backward dispatch is logged."""
    def refuse(*args, **kwargs):
        raise AssertionError("the card's backward wrapper was called on the CPU")

    monkeypatch.setattr(kops, "stream_conv_pyramid_bwd_cuda", refuse)
    rng = np.random.default_rng(0)
    layers = (PyramidLayer("SAME", 1, "tanh", 2), PyramidLayer("SAME", 2, "relu", 3, 2))
    x = torch.from_numpy(rng.normal(size=(2, 23, 21, 3)).astype(np.float32))
    ws = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((3, 3, 3, 4), (3, 3, 4, 6))]
    bs = [torch.zeros(4), torch.zeros(6)]
    got_leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    with probe.recording() as log:
        out = stream_conv_pyramid(got_leaves[0], got_leaves[1:3], got_leaves[3:], layers=layers,
                                  act_bits=bits)
        got = torch.autograd.grad(out.sum(), got_leaves)
    assert [d[1] for d in log.dispatches] == ["stream_conv_pyramid"]
    want_leaves = [t.clone().requires_grad_() for t in (x, *ws, *bs)]
    y = kref.stream_conv_pyramid_ref(want_leaves[0], want_leaves[1:3], want_leaves[3:],
                                     layers=layers, act_bits=bits)
    want = torch.autograd.grad(y.sum(), want_leaves)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_quantized_plans_plan_the_same_launches():
    """The backward's launches depend on the groups, not on the quant mode."""
    topo = ALL_TOPOLOGIES["cifar10"]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device="cpu")
    fp32 = compile_dhm(topo, params, device="cpu")
    qat = compile_dhm(topo, params, quant=QuantSpec(weight_bits=6, act_bits=6), device="cpu")
    assert planned_backward_launches(fp32) == planned_backward_launches(qat) == 9
