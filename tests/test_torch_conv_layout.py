"""The shared-memory layout of the fp32 conv kernels (the implicit-GEMM
redesign of ``csrc/stream_conv.cu``), computed on the host: every fusion
group the compiler plans still fits a Hopper block, the int8 kernels'
sizing is unchanged, and the rows each pyramid block computes are
exactly the rows the next layer reads. Runs on the CPU: the sizing is
plain Python, the kernels themselves are tested on the card
(``test_torch_kernels_card.py``)."""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm import fusion as tfusion  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.halo import same_pads  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

NAMES = sorted(ALL_TOPOLOGIES)


def _layer_inputs(topo):
    """(H, W, C) of each conv layer's input frame."""
    h, w = topo.input_shape
    c = topo.input_channels
    dims = []
    for spec in topo.conv_layers:
        dims.append((h, w, c))
        h, w = spec.out_hw(h, w)
        c = spec.n_out
    return dims


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("vmem_budget", [None, 0])
@pytest.mark.parametrize("act_bits", [None, 6])
def test_every_planned_group_fits_a_hopper_block(name, vmem_budget, act_bits):
    """Each group of a compiled plan, at the fp32 kernels' new layout, needs
    at most 232,448 B: the redesign makes no plan raise that ran before."""
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device="cpu")
    plan = compile_dhm(topo, params, quant=QuantSpec(act_bits=act_bits),
                       vmem_budget=vmem_budget, device="cpu")
    dims = _layer_inputs(topo)
    assert plan.fusion_groups
    for grp in plan.fusion_groups:
        if grp.fused:
            geom = tfusion._group_geom(topo, grp.layers, grp.block_rows)
            smem = kconv.pyramid_smem_bytes(geom)
        else:
            (li,) = grp.layers
            spec = topo.conv_layers[li]
            h, w, c = dims[li]
            if spec.padding == "SAME":
                h += sum(same_pads(h, spec.stride, spec.kernel))
                w += sum(same_pads(w, spec.stride, spec.kernel))
            smem = kconv.fused_geometry(
                h, w, c, k=spec.kernel, stride=spec.stride, pool=spec.pool,
                pool_stride=spec.pool_stride, block_r=8, n_out=spec.n_out,
            )["smem"]
        assert 0 < smem <= kconv.SMEM_LIMIT, (grp, smem)
    assert all(not g.fused for g in plan.fusion_groups) == (vmem_budget == 0)


@pytest.mark.parametrize("name,want", [("lenet5", 3_664), ("cifar10", 24_400), ("svhn", 24_400),
                                       ("cifar10_full", 22_800), ("cifar10_strided", 17_824)])
def test_int8_sizing_is_unchanged(name, want):
    """The int8 pyramid keeps its whole halo'd one-byte slabs."""
    topo = ALL_TOPOLOGIES[name]
    geom = tfusion._group_geom(topo, tuple(range(len(topo.conv_layers))), 0)
    assert kconv.pyramid_smem_bytes(geom, 1) == want


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("block_rows", [0, 1, 2])
def test_each_pyramid_block_computes_the_rows_the_next_layer_reads(name, block_rows):
    """pyramid_rows (the walk the kernel opens with): every layer computes
    exactly the rows of the next layer's frame that the next layer reads,
    reads only rows inside its in-slab, the blocks tile the output rows
    once, and the layout stores every block's rows."""
    topo = ALL_TOPOLOGIES[name]
    geom = tfusion._group_geom(topo, tuple(range(len(topo.conv_layers))), block_rows)
    layout = kconv.pyramid_layout(geom)
    n = len(geom.layers)
    covered = []
    for rb in range(geom.n_row_blocks):
        rows = kconv.pyramid_rows(geom, rb)
        for i, (g, (olo, ohi, ilo, ihi)) in enumerate(zip(geom.layers, rows)):
            assert olo < ohi, (rb, i)
            assert 0 <= ilo < ihi <= g.in_slab_rows, (rb, i)
            assert ihi - ilo <= layout.slab_rows[i]
            # The conv rows of output rows [olo, ohi) read exactly [ilo, ihi).
            pw, ps = g.pw or 1, g.ps or 1
            read = {(r * ps + p) * g.stride + kk for r in range(olo, ohi)
                    for p in range(pw) for kk in range(g.k)}
            assert read == set(range(ilo, ihi)), (rb, i)
            if i + 1 < n:
                nx = geom.layers[i + 1]
                start = nx.in_mult * rb + nx.in_off
                nlo, nhi = rows[i + 1][2:]
                want = [r for r in range(nlo, nhi) if 0 <= start + r < nx.in_rows]
                assert list(range(olo, ohi)) == want, (rb, i)
        olo, ohi = rows[-1][:2]
        covered += [rb * geom.block_rows + r for r in range(olo, ohi)]
    assert covered == list(range(geom.out_rows))


@pytest.mark.parametrize("layer", [0, 1, 2])
def test_a_warps_windows_fall_in_distinct_banks_on_cifar10(layer):
    """The 16 windows a warp gathers at one tap sit at distinct shared-memory
    banks in cifar10's whole-frame pyramid (the C + 1 column stride and the
    padded row stride); with a column stride of C = 32 and no row pad they
    would all share one bank."""
    topo = ALL_TOPOLOGIES["cifar10"]
    (grp,) = tfusion.plan_fusion_groups(topo, (0, 1, 2))
    geom = tfusion._group_geom(topo, grp.layers, grp.block_rows)
    layout = kconv.pyramid_layout(geom)
    g = geom.layers[layer]
    olo, ohi = kconv.pyramid_rows(geom, 0)[layer][:2]
    cols = g.in_cols + sum(g.pads[1])
    n_win = (ohi - olo) * g.out_cols

    def banks(cs, rs):
        step = g.ps * g.stride
        for w0 in range(0, n_win, 16):
            yield [((w // g.out_cols) * step * rs + (w % g.out_cols) * step * cs) % 32
                   for w in range(w0, min(w0 + 16, n_win))]

    assert layout.rs[layer] - cols * layout.cs[layer] in range(32)
    for group in banks(layout.cs[layer], layout.rs[layer]):
        assert len(set(group)) == len(group), group
    if g.in_ch == 32:
        assert any(len(set(group)) == 1 for group in banks(32, cols * 32))
