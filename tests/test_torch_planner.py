"""The port's copies of the pure-Python planners (halo geometry, fusion,
DPN graph, stage mapping), held field for field against the reference,
plus the kernels' shared-memory sizing computed from that geometry."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

from repro.core.dhm import fusion as jfusion  # noqa: E402
from repro.core.dhm import graph as jgraph  # noqa: E402
from repro.core.dhm import mapping as jmapping  # noqa: E402
from repro.kernels.stream_conv import halo as jhalo  # noqa: E402
from repro.models.cnn import ALL_TOPOLOGIES as JAX_TOPOLOGIES  # noqa: E402
from repro_torch.core.dhm import fusion as tfusion  # noqa: E402
from repro_torch.core.dhm import graph as tgraph  # noqa: E402
from repro_torch.core.dhm import mapping as tmapping  # noqa: E402
from repro_torch.kernels.stream_conv import conv as tconv  # noqa: E402
from repro_torch.kernels.stream_conv import halo as thalo  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES as TORCH_TOPOLOGIES  # noqa: E402

NAMES = sorted(JAX_TOPOLOGIES)


def _as_tuple(obj):
    """A frozen dataclass tree as plain tuples (the two packages define
    their own classes, so compare field values, not instances)."""
    if dataclasses.is_dataclass(obj):
        return tuple(
            (f.name, _as_tuple(getattr(obj, f.name))) for f in dataclasses.fields(obj)
        )
    if isinstance(obj, tuple):
        return tuple(_as_tuple(o) for o in obj)
    return obj


def test_topologies_match():
    assert sorted(TORCH_TOPOLOGIES) == NAMES
    for name in NAMES:
        assert _as_tuple(TORCH_TOPOLOGIES[name]) == _as_tuple(JAX_TOPOLOGIES[name])
        assert TORCH_TOPOLOGIES[name].feature_shape() == JAX_TOPOLOGIES[name].feature_shape()
        assert (
            TORCH_TOPOLOGIES[name].feature_extractor_ops()
            == JAX_TOPOLOGIES[name].feature_extractor_ops()
        )


def _group_args(topo, idxs, halo):
    h, w = topo.input_shape
    for spec in topo.conv_layers[: idxs[0]]:
        h, w = spec.out_hw(h, w)
    c = topo.input_channels if idxs[0] == 0 else topo.conv_layers[idxs[0] - 1].n_out
    specs = [topo.conv_layers[i] for i in idxs]
    return (h, w, c, halo.as_pyramid_layers(specs), tuple(s.kernel for s in specs),
            tuple(s.n_out for s in specs))


@pytest.mark.parametrize("name", NAMES)
def test_group_geometry_over_the_block_row_ladder(name):
    jt, tt = JAX_TOPOLOGIES[name], TORCH_TOPOLOGIES[name]
    n = len(jt.conv_layers)
    for i in range(n):
        for j in range(i + 1, n + 1):
            idxs = tuple(range(i, j))
            ladder = jfusion._block_row_candidates(jt, idxs)
            assert tfusion._block_row_candidates(tt, idxs) == ladder
            for r in ladder + [0]:
                want = jhalo.group_geometry(*_group_args(jt, idxs, jhalo), block_rows=r)
                got = thalo.group_geometry(*_group_args(tt, idxs, thalo), block_rows=r)
                assert _as_tuple(got) == _as_tuple(want), (idxs, r)
                for eb in (1, 4):
                    assert thalo.working_set_breakdown(got, elem_bytes=eb, acc_bytes=4) == (
                        jhalo.working_set_breakdown(want, elem_bytes=eb, acc_bytes=4)
                    )


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("budget", [None, 0, 232_448, 2_000_000])
def test_plan_fusion_groups_match(name, budget):
    jt, tt = JAX_TOPOLOGIES[name], TORCH_TOPOLOGIES[name]
    idxs = tuple(range(len(jt.conv_layers)))
    for lo in range(len(idxs)):
        run = idxs[lo:]
        want = jfusion.plan_fusion_groups(jt, run, vmem_budget=budget)
        got = tfusion.plan_fusion_groups(tt, run, vmem_budget=budget)
        assert _as_tuple(got) == _as_tuple(want), (run, budget)


def _actor(a):
    return (a.name, a.kind.value, a.multipliers, a.adders, a.line_buffer_bits,
            a.flops, a.param_bytes, a.stream_bytes, a.layer)


@pytest.mark.parametrize("name", NAMES)
def test_dpn_and_stage_partition_match(name):
    jt, tt = JAX_TOPOLOGIES[name], TORCH_TOPOLOGIES[name]
    for bits in (6, 32):
        jg, tg = jgraph.cnn_to_dpn(jt, bits=bits), tgraph.cnn_to_dpn(tt, bits=bits)
        assert [_actor(a) for a in tg.actors] == [_actor(a) for a in jg.actors]
        assert tg.edges == jg.edges
        assert tg.total_flops() == jg.total_flops()
    costs = [float(c) for c in range(1, len(jt.conv_layers) + 1)]
    for s in range(1, len(jt.conv_layers) + 1):
        assert _as_tuple(tmapping.partition_stages(costs, s)) == _as_tuple(
            jmapping.partition_stages(costs, s)
        )


def test_pyramid_shared_memory_of_the_reference_blocks():
    """The pyramid kernel's ping-pong slabs at each topology's planned
    whole-frame block, from group_geometry: all within the 232,448 B a
    Hopper block may use."""
    want = {
        # cifar10: max(L0 in 25,920, L2 in 18,432) + L1 padded in 71,680.
        "cifar10": 25_920 + 71_680,
        "svhn": 25_920 + 71_680,
        "cifar10_full": 25_488 + 65_664,
        # max(L0 in 18,900, L2 in 25,600) + L1 padded in 45,696.
        "cifar10_strided": 25_600 + 45_696,
    }
    for name in NAMES:
        tt = TORCH_TOPOLOGIES[name]
        (grp,) = tfusion.plan_fusion_groups(tt, tuple(range(len(tt.conv_layers))))
        geom = tfusion._group_geom(tt, grp.layers, grp.block_rows)
        smem = tconv.pyramid_smem_bytes(geom)
        assert smem <= tconv.SMEM_LIMIT, name
        if name in want:
            assert smem == want[name], name
    assert tconv.pyramid_smem_bytes(
        tfusion._group_geom(TORCH_TOPOLOGIES["lenet5"], (0, 1), 4)
    ) < 15_000


@pytest.mark.parametrize(
    "h,w,c,k,stride,pool,pool_stride,block_r",
    [
        (36, 36, 3, 5, 1, 2, None, 8),
        (20, 20, 32, 5, 1, 2, None, 8),
        (36, 36, 3, 5, 1, 3, 2, 8),
        (35, 35, 3, 5, 2, 0, None, 8),
        (17, 17, 32, 3, 2, 0, None, 1),
        (64, 100, 64, 5, 1, 2, None, 64),
    ],
)
def test_single_layer_blocking_follows_the_halo_rule(h, w, c, k, stride, pool, pool_stride, block_r):
    from repro.kernels.stream_conv.conv import _block_multiple as jax_block_multiple
    from repro_torch.kernels.stream_conv.epilogue import normalize_pool

    pw, ps = normalize_pool(pool, pool_stride)
    assert tconv._block_multiple(k, stride, pw, ps) == jax_block_multiple(k, stride, pw, ps)
    mult = tconv._block_multiple(k, stride, pw, ps)[0]
    g = tconv.fused_geometry(h, w, c, k=k, stride=stride, pool=pool,
                             pool_stride=pool_stride, block_r=block_r)
    assert g["r"] % mult == 0 and g["smem"] <= tconv.SMEM_LIMIT
    h_out = (h - k) // stride + 1
    assert g["n_rb"] * g["r_o"] >= g["h_keep"] > (g["n_rb"] - 1) * g["r_o"]
    assert g["h_keep"] == ((h_out - pw) // ps + 1 if pw else h_out)


def test_single_layer_block_above_shared_memory_raises():
    # Even the smallest legal block (4 conv rows + a 4-row halo) of a
    # 600-wide, 64-channel frame needs 1,228,800 B.
    with pytest.raises(ValueError, match="shared memory"):
        tconv.fused_geometry(600, 600, 64, k=5, stride=1, pool=2,
                             pool_stride=None, block_r=8)
