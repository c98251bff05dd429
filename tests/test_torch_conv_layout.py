"""The shared-memory layout of the conv kernels (the implicit GEMMs of
``csrc/stream_conv.cu``), computed on the host: every fusion group the
compiler plans still fits a Hopper block, the int8 kernels' layout
(``conv.int8_layout``) is pinned, and the rows each pyramid block
computes are exactly the rows the next layer reads. The int8 layout is
the kernel's own address arithmetic, so it is also checked here as the
kernel uses it: every ldmatrix row 16-byte aligned, the eight rows of a
phase on distinct banks where the design says so, the staged weights
covering K and N once, and the tiles, emulated in numpy, computing the
conv. Runs on the CPU: the sizing is plain Python, the kernels themselves
are tested on the card (``test_torch_kernels_card.py``)."""
import numpy as np
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


@pytest.mark.parametrize("name,want", [("lenet5", 35_312), ("cifar10", 84_096), ("svhn", 84_096),
                                       ("cifar10_full", 82_032), ("cifar10_strided", 63_792)])
def test_int8_sizing_is_unchanged(name, want):
    """The int8 pyramid's block as ``int8_layout`` pins it: the slabs of
    the rows the fp32 walk computes, the tap table and the largest
    layer's staged weights (cifar10: 7,344 + 19,200 B of slabs, 208 B of
    taps and 64 rows of 896 B of weights). Compile time and launch time
    read the same number."""
    topo = ALL_TOPOLOGIES[name]
    geom = tfusion._group_geom(topo, tuple(range(len(topo.conv_layers))), 0)
    lay = kconv.int8_pyramid_layout(geom)
    assert kconv.pyramid_smem_bytes(geom, 1) == lay.smem == want
    assert lay.buf0 + lay.buf1 == lay.tap_off
    assert lay.smem == lay.wst_off + max(li.w_bytes for li in lay.layers)
    if name in ("cifar10", "svhn"):
        assert (lay.buf0, lay.buf1, lay.wst_off - lay.tap_off) == (7_344, 19_200, 208)
        assert max(li.w_bytes for li in lay.layers) == 64 * 896


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


# ---------------------------------------------------------------------------
# The int8 kernels' layout, as the kernel addresses it.

# Single int8 layers (an Int8Slab each) at every path the kernel compiles:
# the ldmatrix path (C of 16, 32, 48 and 64) and the word path (C of 1, 3,
# 8 and 20); pool windows 1 (none, or a one-position window at stride 2),
# 2, 3 and 4 (the run-time window); stride 2; N of 20 and 50; K not a
# multiple of 32 (75, 500, 48 and 72).
SLAB_CASES = (
    # rows, cols, c, k, stride, pw, ps, n, n_wr, n_wc
    (12, 20, 32, 5, 1, 2, 2, 32, 4, 8),
    (12, 12, 32, 5, 1, 2, 2, 64, 4, 4),
    (9, 17, 32, 3, 2, 0, 0, 64, 4, 8),
    (10, 10, 64, 3, 1, 2, 2, 64, 4, 4),
    (10, 36, 3, 5, 1, 2, 2, 32, 3, 16),
    (11, 35, 3, 5, 2, 0, 0, 32, 4, 16),
    (12, 12, 20, 5, 1, 2, 2, 50, 4, 4),
    (12, 28, 1, 5, 1, 2, 2, 20, 4, 12),
    (11, 19, 32, 5, 1, 3, 2, 32, 3, 7),
    (9, 15, 16, 3, 1, 4, 2, 8, 2, 5),
    (9, 13, 8, 3, 1, 1, 2, 12, 4, 6),
    (5, 9, 48, 1, 1, 0, 0, 24, 5, 9),
)


def _int8_group_slabs(name):
    """(geometry, its int8 layout, each layer's Int8Slab) of a topology's
    whole-stack int8 group at the plan's block."""
    topo = ALL_TOPOLOGIES[name]
    (grp,) = tfusion.plan_fusion_groups(topo, tuple(range(len(topo.conv_layers))), elem_bytes=1)
    geom = tfusion._group_geom(topo, grp.layers, grp.block_rows)
    return geom, kconv.int8_pyramid_layout(geom), kconv.int8_pyramid_slabs(geom)


def _phases(lay, sl):
    """Per A tile of every m-task: the slab offsets of its 16 rows."""
    mt, per = kconv.int8_tiles(sl.pw)
    for mb in range(-(-(sl.n_wr * sl.n_wc) // per)):
        for t in range(mt):
            yield [kconv.int8_row_base(lay, sl, mb, t, r)[0] for r in range(16)]


@pytest.mark.parametrize("name", NAMES)
def test_every_int8_ldmatrix_row_is_16_byte_aligned(name):
    """ldmatrix reads 16-byte rows at 16-byte addresses: on the ldmatrix
    path every row base, tap, column and row stride and buffer offset is a
    multiple of 16 (on the word path of 4, its 32-bit loads)."""
    _, lay, slabs = _int8_group_slabs(name)
    assert lay.buf0 % 16 == lay.buf1 % 16 == lay.tap_off % 16 == lay.wst_off % 16 == 0
    for li, sl in zip(lay.layers, slabs):
        unit = 16 if li.ldm else 4
        assert li.ldm == (sl.c % 16 == 0)
        assert li.cs % unit == li.rs % unit == 0 and li.w_row % 128 == 0
        assert all(t % unit == 0 for t in kconv.int8_taps(li, sl.k, sl.stride))
        for rows in _phases(li, sl):
            assert all(b % unit == 0 for b in rows)


@pytest.mark.parametrize("name,layer", [("cifar10", 1), ("cifar10", 2), ("svhn", 1), ("svhn", 2),
                                        ("cifar10_strided", 1), ("cifar10_strided", 2)])
def test_int8_ldmatrix_phases_fall_in_distinct_banks(name, layer):
    """The eight rows of each ldmatrix phase (rows 0-7 and 8-15 of an A
    tile) sit in the eight distinct 16-byte bank groups: a column stride
    of 48 (80) bytes for C = 32 (64), the stride-2 slab's columns split
    by phase, the row pad, and at pool window 2 rows 4-7 and 12-15 at
    the other column of the window. With the column stride of C bytes,
    no phase split and no swizzle, some phase shares a bank group."""
    _, lay, slabs = _int8_group_slabs(name)
    li, sl = lay.layers[layer], slabs[layer]
    assert li.ldm

    def groups(lay_):
        for rows in _phases(lay_, sl):
            for half in (rows[:8], rows[8:]):
                yield {(b // 16) % 8 for b in set(half)}, len(set(half))

    assert all(len(g) == n for g, n in groups(li))

    def plain_groups():
        """The same phases over a slab of C-byte columns (48 at stride 2),
        its columns unsplit and no swizzle: stride 1 puts windows two
        columns apart, stride 2 every position on an even bank group."""
        cs = sl.c if sl.stride == 1 else li.cs
        rs = sl.cols * cs
        mt, per = kconv.int8_tiles(sl.pw)
        pw, ps = sl.pw or 1, sl.ps or 1
        for mb in range(-(-(sl.n_wr * sl.n_wc) // per)):
            for t in range(mt):
                rows = []
                for r in range(16):
                    o = mb * per + (t * 16 if pw == 1 else 0) + r
                    o = o if o < sl.n_wr * sl.n_wc else 0
                    (wr, wc), (i, j) = divmod(o, sl.n_wc), divmod(0 if pw == 1 else t, pw)
                    rows.append(((wr * ps + i) * rs + (wc * ps + j) * cs) * sl.stride)
                for half in (rows[:8], rows[8:]):
                    yield {(b // 16) % 8 for b in set(half)}, len(set(half))

    assert any(len(g) < n for g, n in plain_groups())


def _stage(lay, sl, w):
    """The staged weight bytes (kernel's sc_stage_w8) of HWIO codes w."""
    staged = np.zeros(lay.w_bytes, np.int64)
    owner = {}
    for kk in range(lay.kpad):
        for n in range(lay.n_pad):
            off = kconv.int8_w_offset(lay, kk, n)
            assert 0 <= off < lay.w_bytes and off not in owner
            owner[off] = (kk, n)
            tap, c = divmod(kk, lay.cpad)
            if kk < lay.kdim and c < sl.c and n < sl.n:
                staged[off] = w[tap // sl.k, tap % sl.k, c, n]
    return staged, owner


@pytest.mark.parametrize("case", SLAB_CASES, ids=lambda c: "c{2}_n{7}_k{3}_s{4}_p{5}".format(*c))
def test_int8_k_and_n_padding_cover_the_weights_exactly_once(case):
    """Every staged byte holds one (K, N) pair: K runs over k*k*cpad
    rounded up to 32, N over N rounded up to 8 n8 tiles a task; each HWIO
    weight lands in one byte, and the padding (channels past C, K past
    k*k*cpad, N past N) holds zeros."""
    sl = kconv.Int8Slab(*case)
    lay = kconv.int8_layer(sl)
    assert lay.kpad % kconv.MMA_K == 0 and lay.kpad - lay.kdim < kconv.MMA_K
    assert lay.n_pad % (8 * lay.nt) == 0 and lay.n_pad - sl.n < 8 * lay.nt
    assert lay.kdim == sl.k * sl.k * lay.cpad and lay.cpad - sl.c < (1 if lay.ldm else 4)
    w = np.random.default_rng(1).integers(1, 128, size=(sl.k, sl.k, sl.c, sl.n))
    staged, owner = _stage(lay, sl, w)
    assert len(owner) == lay.kpad * lay.n_pad
    assert all(off // lay.w_row == n for off, (_, n) in owner.items())
    assert np.count_nonzero(staged) == w.size and staged.sum() == w.sum()


@pytest.mark.parametrize("case", SLAB_CASES, ids=lambda c: "c{2}_n{7}_k{3}_s{4}_p{5}".format(*c))
def test_int8_tiles_compute_the_conv(case):
    """The kernel's address arithmetic, emulated: a random code slab
    written where the fill writes it, the tap table, the staged weights
    and every A tile's rows as the K loop reads them (16 or 4 bytes per
    granule) give, for every output and pool position a tile holds, the
    conv's exact int32 sums; padded channels read zero."""
    sl = kconv.Int8Slab(*case)
    lay = kconv.int8_layer(sl)
    rng = np.random.default_rng(2)
    x = rng.integers(-128, 128, size=(sl.rows, sl.cols, sl.c))
    w = rng.integers(-128, 128, size=(sl.k, sl.k, sl.c, sl.n))
    slab = np.zeros(lay.slab_bytes, np.int64)
    for r in range(sl.rows):
        for xx in range(sl.cols):
            for c in range(sl.c):
                slab[kconv.int8_slab_offset(lay, r, xx, c, sl.stride)] = x[r, xx, c]
    staged, _ = _stage(lay, sl, w)
    kk = np.arange(lay.kpad)
    taps = np.asarray(kconv.int8_taps(lay, sl.k, sl.stride))[kk // lay.grain] + kk % lay.grain
    b = staged[[[kconv.int8_w_offset(lay, k_, n) for n in range(lay.n_pad)] for k_ in kk]]
    mt, per = kconv.int8_tiles(sl.pw)
    pw, ps = sl.pw or 1, sl.ps or 1
    runtime = mt == 1 and pw > 1
    seen = set()
    for mb in range(-(-(sl.n_wr * sl.n_wc) // per)):
        for t in range(mt):
            for pos in (range(pw * pw) if runtime else (0,)):
                for r in range(16):
                    base, o = kconv.int8_row_base(lay, sl, mb, t, r, pos)
                    got = slab[base + taps] @ b
                    if o is None:
                        continue
                    p = pos if runtime else (t ^ (1 if lay.swz and r & 4 else 0)) if pw > 1 else 0
                    i, j = divmod(p, pw)
                    wr, wc = divmod(o, sl.n_wc)
                    cr, cc = (wr * ps + i) * sl.stride, (wc * ps + j) * sl.stride
                    want = np.einsum("abc,abcn->n", x[cr:cr + sl.k, cc:cc + sl.k], w)
                    np.testing.assert_array_equal(got[:sl.n], want)
                    assert not got[sl.n:].any()
                    seen.add((o, i, j))
    assert len(seen) == sl.n_wr * sl.n_wc * (1 if pw == 1 else pw * pw)


@pytest.mark.parametrize("case", [SLAB_CASES[0], SLAB_CASES[1], SLAB_CASES[6]],
                         ids=lambda c: "c{2}_n{7}".format(*c))
def test_int8_staged_weights_fall_in_distinct_banks(case):
    """The staged weights' chunk swizzle: ldmatrix reads one 16-byte K
    chunk of eight consecutive channels (n = 8a..8a+7), the staging's
    lanes write eight consecutive chunks of one channel; both land on the
    eight distinct 16-byte bank groups of a 128-byte row."""
    lay = kconv.int8_layer(kconv.Int8Slab(*case))
    assert lay.w_row % kconv.W_ROW_ALIGN == 0
    for chunk in range(lay.kpad // 16):
        for a in range(lay.n_pad // 8):
            assert len({(kconv.int8_w_offset(lay, 16 * chunk, 8 * a + r) // 16) % 8
                        for r in range(8)}) == 8
    for n in range(lay.n_pad):
        for c0 in range(0, lay.kpad // 16 - 7, 8):
            assert len({(kconv.int8_w_offset(lay, 16 * (c0 + c), n) // 16) % 8
                        for c in range(8)}) == 8
