"""The single-layer int8 kernel's wgmma path, on the host: which layers
take it (``conv.fused_path``), its blocking at VGG-16's widths
(``conv.wgmma_geometry``: one launch a layer within a Hopper block's
shared memory), the weights laid out as it streams them
(``conv.kmajor_weights``), its A rows on distinct banks, and its tiles,
emulated in numpy through the kernel's own address arithmetic
(``wgmma_row``, ``wgmma_tap``, ``wgmma_w_offset``), computing the conv.
The layers it leaves to the mma.sync path keep their geometry. Runs on
the CPU: the kernel itself is held to its plain version on the card
(``test_torch_fused_i8_card.py``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv.halo import padded_frame  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, VGG16, init_cnn  # noqa: E402


def _vgg16_inputs():
    """(H, W, C) entering each of VGG-16's conv layers at 224x224."""
    h, w = VGG16.input_shape
    c = VGG16.input_channels
    out = []
    for sp in VGG16.conv_layers:
        out.append((h, w, c))
        h, w = sp.out_hw(h, w)
        c = sp.n_out
    return out


@pytest.mark.parametrize("layer", range(2, 13))
def test_vgg16_singletons_take_the_wgmma_path_in_one_launch(layer):
    h, w, c = _vgg16_inputs()[layer]
    sp = VGG16.conv_layers[layer]
    g = kconv.fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=sp.pool, pool_stride=None,
                         block_r=8, n_out=sp.n_out, elem_bytes=1)
    assert g["path"] == "wgmma"
    assert len(g["strips"]) == len(g["slices"]) == 1 and g["slices"] == ((0, sp.n_out),)
    assert g["smem"] <= kconv.SMEM_LIMIT and g["threads"] == kconv.WG_THREADS
    assert kconv.WG_STAGES[0] <= g["stages"] <= kconv.WG_STAGES[1]
    assert g["wst_off"] == g["tap_off"] >= g["in_rows_blk"] * g["rs"]
    assert g["smem"] == g["wst_off"] + g["stages"] * (kconv.WG_STAGE + 16)
    assert g["wst_off"] % 128 == 0 and g["cs"] == c + 16 and g["rs"] % 16 == 0
    assert g["tn"] * kconv.WG_NT == g["np"] >= sp.n_out and g["kpad"] == 9 * c
    # Whole output rows a block, spread evenly, every row once.
    cap = kconv.WG_WINDOWS if sp.pool else kconv.WG_POSITIONS
    assert g["r_o"] * g["w_keep"] <= cap
    assert (g["n_rb"] - 1) * g["r_o"] < g["h_keep"] <= g["n_rb"] * g["r_o"]
    assert g["in_rows_blk"] == g["r"] + 2 and g["r"] == (2 if sp.pool else 1) * g["r_o"]


def test_vgg16_blocks_cover_most_of_their_tiles():
    """A block covers at least 196 conv positions at every layer (the
    mma.sync path's blocks covered 56 at layers 8-12), and the 512-channel
    layers stream 72 K steps of four N tiles per block."""
    for layer in range(2, 13):
        h, w, c = _vgg16_inputs()[layer]
        sp = VGG16.conv_layers[layer]
        g = kconv.fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=sp.pool, pool_stride=None,
                             block_r=8, n_out=sp.n_out, elem_bytes=1)
        assert g["r"] * g["w_keep"] * (2 if sp.pool else 1) >= 196, layer
        if c == 512:
            assert (g["kpad"] // kconv.WG_KS, g["tn"]) == (72, 4)


@pytest.mark.parametrize("h,w,c,pool,strips", [
    (224, 224, 512, 0, 2),  # VGG-16's 512-channel layer at 4x the area: 112-column strips
    (224, 224, 512, 2, 4),  # pooled: 32 windows a strip
    (224, 448, 256, 0, 4),
    (3, 300, 512, 0, 5),
    (1, 1000, 4096, 0, 125),  # 8 columns a strip
])
def test_wide_frames_stay_on_the_wgmma_path_in_column_strips(h, w, c, pool, strips):
    """Where one row's slab leaves no room for the ring, the strips
    narrow: the layer stays on the wgmma path, one slice, and every
    output column is computed by exactly one strip."""
    g = kconv.fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=pool, pool_stride=None,
                         block_r=8, n_out=128, elem_bytes=1)
    assert g["path"] == "wgmma" and g["slices"] == ((0, 128),)
    assert len(g["strips"]) == strips
    assert g["smem"] <= kconv.SMEM_LIMIT and g["stages"] >= kconv.WG_STAGES[0]
    assert [s[2] for s in g["strips"]] == [0] + [s[3] for s in g["strips"][:-1]]
    assert g["strips"][-1][3] == g["w_keep"] == (w // 2 if pool else w)
    assert max(s[1] - s[0] for s in g["strips"]) == g["q"]


@pytest.mark.parametrize("c,n,stride,pool,want", [
    (64, 128, 1, (0, 0), "wgmma"), (192, 192, 1, (2, 2), "wgmma"), (512, 64, 1, (0, 0), "wgmma"),
    (32, 64, 1, (0, 0), "mma_sync"), (96, 128, 1, (0, 0), "mma_sync"),
    (64, 32, 1, (0, 0), "mma_sync"), (64, 128, 2, (0, 0), "mma_sync"),
    (64, 128, 1, (3, 2), "mma_sync"), (64, 128, 1, (2, 1), "mma_sync"),
    (3, 64, 1, (2, 2), "mma_sync"), (1, 20, 1, (2, 2), "mma_sync"), (20, 50, 1, (2, 2), "mma_sync"),
])
def test_the_path_follows_the_shape(c, n, stride, pool, want):
    assert kconv.fused_path(c, n, stride=stride, pw=pool[0], ps=pool[1]) == want


# The parent's single-layer geometry of cifar10's and lenet5's layers,
# field for field (``fused_plan`` at 1 byte an element).
SMALL_C_PLANS = {
    ("cifar10", 0): dict(r=8, r_o=4, in_rows_blk=12, h_keep=16, w_keep=16, n_rb=4, smem=6672,
                         strips=((0, 36, 0, 16),), slices=((0, 32),), threads=256, cs=4, rs=204,
                         tn=2, np=32, q=36, cpad=4, kpad=128, wrow=128, swz=0, tap_off=2448,
                         wst_off=2576),
    ("cifar10", 1): dict(r=8, r_o=4, in_rows_blk=12, h_keep=8, w_keep=8, n_rb=2, smem=40400,
                         strips=((0, 20, 0, 8),), slices=((0, 32),), threads=256, cs=48, rs=960,
                         tn=1, np=32, q=20, cpad=32, kpad=800, wrow=896, swz=1, tap_off=11520,
                         wst_off=11728),
    ("cifar10", 2): dict(r=8, r_o=4, in_rows_blk=12, h_keep=4, w_keep=4, n_rb=1, smem=64464,
                         strips=((0, 12, 0, 4),), slices=((0, 64),), threads=256, cs=48, rs=576,
                         tn=1, np=64, q=12, cpad=32, kpad=800, wrow=896, swz=1, tap_off=6912,
                         wst_off=7120),
    ("lenet5", 0): dict(r=8, r_o=4, in_rows_blk=12, h_keep=12, w_keep=12, n_rb=3, smem=4592,
                        strips=((0, 28, 0, 12),), slices=((0, 20),), threads=256, cs=4, rs=116,
                        tn=1, np=24, q=28, cpad=4, kpad=128, wrow=128, swz=0, tap_off=1392,
                        wst_off=1520),
    ("lenet5", 1): dict(r=8, r_o=4, in_rows_blk=12, h_keep=4, w_keep=4, n_rb=1, smem=32064,
                        strips=((0, 12, 0, 4),), slices=((0, 50),), threads=224, cs=20, rs=240,
                        tn=1, np=56, q=12, cpad=20, kpad=512, wrow=512, swz=0, tap_off=2880,
                        wst_off=3392),
}


@pytest.mark.parametrize("name,layer", sorted(SMALL_C_PLANS))
def test_small_channel_layers_keep_the_mma_sync_path_as_they_were(name, layer):
    topo = ALL_TOPOLOGIES[name]
    h, w = topo.input_shape
    c = topo.input_channels
    for sp in topo.conv_layers[:layer]:
        h, w = sp.out_hw(h, w)
        c = sp.n_out
    sp = topo.conv_layers[layer]
    hp, wp = padded_frame(h, w, sp.kernel, sp.stride, sp.padding)
    g = kconv.fused_plan(hp, wp, c, k=sp.kernel, stride=sp.stride, pool=sp.pool,
                         pool_stride=sp.pool_stride, block_r=8, n_out=sp.n_out, elem_bytes=1)
    assert g == dict(path="mma_sync", **SMALL_C_PLANS[(name, layer)])


@pytest.mark.parametrize("name", ["cifar10", "lenet5"])
def test_the_paper_cells_launch_tables_are_unchanged(name):
    """Every card group of the paper's two benchmarked nets, fused or
    alone, keeps its kernel, one launch, and the mma.sync main loop."""
    topo = ALL_TOPOLOGIES[name]
    idxs = tuple(range(len(topo.conv_layers)))
    for budget in (None, 0):
        groups = tcompiler.plan_fusion_groups(
            topo, idxs, vmem_budget=tcompiler.DEFAULT_VMEM_BUDGET if budget is None else 0,
            elem_bytes=1)
        groups = tcompiler.card_fusion_groups(topo, idxs, groups, elem_bytes=1)
        for g in groups:
            e = tcompiler.card_launch(topo, g, elem_bytes=1)
            assert (e.path, e.launches) == ("mma_sync", 1)
            assert e.kernel == ("stream_conv_pyramid_int8" if len(g.layers) > 1
                                else "stream_conv_fused_int8")


@pytest.mark.parametrize("k,c,n", [(3, 64, 128), (3, 192, 192), (1, 128, 64), (3, 64, 520)])
def test_kmajor_weights_relayout_the_codes(k, c, n):
    """Element for element: weight (kk, channel) of the HWIO codes, K in
    (ki, kj, c) order, sits where ``wgmma_w_offset`` says, and the
    channels that pad N to whole N tiles are zero."""
    rng = np.random.default_rng(k * c + n)
    w = rng.integers(-128, 128, size=(k, k, c, n)).astype(np.int8)
    got = kconv.kmajor_weights(torch.from_numpy(w)).numpy()
    kdim, n_pad = k * k * c, -(-n // kconv.WG_NT) * kconv.WG_NT
    assert got.dtype == np.int8 and got.shape == (kdim * n_pad,)
    kk, nn = np.meshgrid(np.arange(kdim), np.arange(n_pad), indexing="ij")
    off = np.vectorize(lambda a, b: kconv.wgmma_w_offset(a, b, ksteps=kdim // kconv.WG_KS))(kk, nn)
    assert sorted(off.ravel().tolist()) == list(range(kdim * n_pad))
    want = np.zeros((kdim, n_pad), np.int8)
    want[:, :n] = w.reshape(kdim, n)
    assert np.array_equal(got[off], want)


def test_a_card_plan_keeps_the_kmajor_codes_beside_its_codes():
    """``"wk"`` for each singleton the launch table sends down the wgmma
    path (VGG-16's pattern at a quarter of its channels, 32 wide: layers
    of 64 and more channels that the plan leaves alone), none on the
    others, the fused layers of 64 channels among them."""
    topo = dataclasses.replace(
        VGG16, name="vgg16_small", input_hw=32, fc_dims=(64, 64), n_classes=10,
        conv_layers=tuple(dataclasses.replace(sp, n_out=sp.n_out // 4)
                          for sp in VGG16.conv_layers))
    params = init_cnn(torch.Generator().manual_seed(0), topo, device="cpu")
    codes = tuple({"w": torch.randint(-9, 9, p["w"].shape, dtype=torch.int8), "b": p["b"]}
                  for p in params["conv"])
    idxs = tuple(range(len(topo.conv_layers)))
    groups = tcompiler.plan_fusion_groups(topo, idxs, vmem_budget=tcompiler.DEFAULT_VMEM_BUDGET,
                                          elem_bytes=1)
    groups = tcompiler.card_fusion_groups(topo, idxs, groups, elem_bytes=1)
    launches = tuple(tcompiler.card_launch(topo, g, elem_bytes=1) for g in groups)
    got = tcompiler._kmajor_params(codes, launches)
    wgmma = {e.layers[0] for e in launches if e.path == "wgmma"}
    singles = {e.layers[0] for e in launches if len(e.layers) == 1}
    assert wgmma == {i for i in singles if codes[i]["w"].shape[2] % 64 == 0} == {12}
    assert [("wk" in p) for p in got] == [i in wgmma for i in idxs]
    # A 64-channel layer inside a pyramid group gets none.
    fused = [i for e in launches if len(e.layers) > 1 for i in e.layers]
    assert any(codes[i]["w"].shape[2] % 64 == 0 for i in fused)
    assert any("wk" in p for p in got) and not all("wk" in p for p in got)
    for p, q in zip(got, codes):
        assert p["w"] is q["w"] and p["b"] is q["b"]
        if "wk" in p:
            assert torch.equal(p["wk"], kconv.kmajor_weights(q["w"]))


@pytest.mark.parametrize("layer,want", [(3, 32), (6, 32), (9, 32), (12, 36)])
def test_pooled_vgg16_a_rows_fall_in_distinct_banks(layer, want):
    """With the 2x2 pool a phase's eight rows are windows two columns
    apart: the swizzle puts them on the eight bank groups, one wavefront
    a phase, 32 phases a K step; at layer 12 a phase's eight windows span
    two rows of 7, and four phases take two."""
    h, w, c = _vgg16_inputs()[layer]
    sp = VGG16.conv_layers[layer]
    g = kconv.fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=sp.pool, pool_stride=None,
                         block_r=8, n_out=sp.n_out, elem_bytes=1)
    waves = kconv.wgmma_wavefronts(pooled=True, n_wc=g["w_keep"], rs=g["rs"], cs=g["cs"],
                                   swz=g["swz"], n_valid=g["r_o"] * g["w_keep"])
    assert g["swz"] == 1 and waves == want


def _emulate(x, w, g, pooled):
    """The wgmma path's integer sums, as its blocks address them: per
    strip and row block the slab (code 0 below the frame), each A row read
    through ``wgmma_row`` and ``wgmma_tap``, the weights through
    ``wgmma_w_offset`` in ``kmajor_weights``; then each thread's rows
    gathered as its epilogue takes them. Returns {(out row, out col):
    (position sums (positions, N), their conv positions)}."""
    h, _, c = x.shape
    k, n = w.shape[0], w.shape[3]
    kdim, ksteps = g["kpad"], g["kpad"] // kconv.WG_KS
    wk = kconv.kmajor_weights(torch.from_numpy(w)).numpy().astype(np.int64)
    woff = np.array([[kconv.wgmma_w_offset(kk, nn, ksteps=ksteps) for nn in range(n)]
                     for kk in range(kdim)])
    wmat = wk[woff]
    taps = np.array([kconv.wgmma_tap(kk, c=c, k=k, rs=g["rs"], cs=g["cs"]) for kk in range(kdim)])
    out = {}
    for in_lo, in_hi, o_lo, o_hi in g["strips"]:
        n_wc = o_hi - o_lo
        for rb in range(g["n_rb"]):
            slab = np.zeros(g["in_rows_blk"] * g["rs"] + kconv.WG_KS, np.int64)
            for rr in range(g["in_rows_blk"]):
                row = rb * g["r"] + rr
                for xx in range(in_hi - in_lo):
                    at = rr * g["rs"] + xx * g["cs"]
                    slab[at:at + c] = x[row, in_lo + xx] if row < h else 0
            n_valid = min(g["r_o"], g["h_keep"] - rb * g["r_o"]) * n_wc
            rows = [kconv.wgmma_row(pooled=pooled, n_wc=n_wc, rs=g["rs"], cs=g["cs"],
                                    swz=g["swz"], n_valid=n_valid, wg=wg, wi=wi, t=t, rho=rho)
                    for wg in range(2) for wi in range(4) for gid in range(8)
                    for t in range(2) for rho in (gid, gid + 8)]
            bases = np.array([r[0] for r in rows])
            sums = slab[bases[:, None] + taps[None, :]] @ wmat
            for th in range(len(rows) // 4):  # a thread's rows: gid, gid + 8 of both tiles
                held = [(rows[i][1], rows[i][0], sums[i]) for i in range(4 * th, 4 * th + 4)]
                for grp in ([held] if pooled else [[e] for e in held]):
                    o = grp[0][0]
                    assert all(e[0] == o for e in grp)
                    if o is None:
                        continue
                    wr, wc = divmod(o, n_wc)
                    key = (rb * g["r_o"] + wr, o_lo + wc)
                    assert key not in out
                    pos = []
                    for _, base, _ in grp:  # the conv position the base names
                        pr, rest = divmod(base, g["rs"])
                        pos.append((rb * g["r"] + pr, in_lo + rest // g["cs"]))
                    out[key] = (np.stack([e[2] for e in grp]), pos)
    return out


@pytest.mark.parametrize("frame,n,pool", [
    ((22, 22, 64), 128, 0),  # 400 conv positions: two row blocks of 10 rows
    ((19, 21, 192), 192, 0),  # K 1,728, N tiles 128 + 64, rows 9 + 8
    ((20, 20, 64), 64, 2),  # 81 windows: two row blocks
    ((15, 21, 192), 192, 2),  # an odd width: the last conv column has no window
    ((4, 300, 64), 64, 0),  # 298 conv columns: two strips
])
def test_the_wgmma_tiles_compute_the_conv(frame, n, pool):
    rng = np.random.default_rng(sum(frame) + n)
    x = rng.integers(-128, 128, size=frame).astype(np.int8)
    w = rng.integers(-128, 128, size=(3, 3, frame[2], n)).astype(np.int8)
    g = kconv.fused_plan(*frame, k=3, stride=1, pool=pool, pool_stride=None, block_r=8,
                         n_out=n, elem_bytes=1)
    assert g["path"] == "wgmma"
    got = _emulate(x, w, g, pooled=bool(pool))
    conv = torch.nn.functional.conv2d(
        torch.from_numpy(x.astype(np.float64)).permute(2, 0, 1)[None],
        torch.from_numpy(w.astype(np.float64)).permute(3, 2, 0, 1))[0].permute(1, 2, 0).numpy()
    assert sorted(got) == [(r, cc) for r in range(g["h_keep"])
                           for cc in range(sum(s[3] - s[2] for s in g["strips"]))]
    for (r, cc), (sums, pos) in got.items():
        window = [(2 * r + i, 2 * cc + j) for i in (0, 1) for j in (0, 1)] if pool else [(r, cc)]
        assert sorted(pos) == window
        for s, (pr, pc) in zip(sums, pos):
            assert np.array_equal(s, conv[pr, pc]), (r, cc, pr, pc)


def test_a_plan_that_halves_its_slices_pins_no_callers_frame():
    """``fused_plan`` tries geometries that do not fit before one that
    does; the errors it keeps must not hold the callers' frames, whose
    tensors (a layer's input, codes and output on the card) would then
    live until the cyclic GC ran."""
    import gc
    import weakref

    def launch(x):
        return kconv.fused_plan(30, 30, 512, k=3, stride=1, pool=0, pool_stride=None,
                                block_r=8, n_out=512, elem_bytes=4)

    gc.collect()
    gc.disable()
    try:
        x = torch.zeros(4)
        alive = weakref.ref(x)
        g = launch(x)
        del x
        assert len(g["slices"]) > 1  # some geometries did not fit
        assert alive() is None
    finally:
        gc.enable()
