"""The host-side sizing of the seed conv, pow2_matmul and selective-scan
kernels, on the CPU: ``legacy.seed_tile`` (strips, register tile, ring,
column strips), ``pow2.p2_plan`` (the K split over a thread-block
cluster) and ``scan.scan_plan`` (lanes per channel, chunk, channels per
CTA), at every shape that ``chip_smoke.py`` and the card tests launch. The
kernels themselves are tested on the card (``test_torch_kernels_card.py``);
what is checked here is plain Python arithmetic, so it holds exactly."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.stream_conv import halo as khalo  # noqa: E402
from repro_torch.kernels.stream_conv import legacy as klegacy  # noqa: E402
from repro_torch.kernels.stream_conv.conv import SMEM_LIMIT  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# The card's facts that the wrappers read at run time, given here: an H100
# SXM's SMs, and CTAs an SM holds (the wrapper asks the occupancy API; the
# strips must cover every row whatever it answers).
H100_SMS = 132
RESIDENT = (1, 16, 32)


def _resident(per_sm):
    return lambda tw, tn, c, threads, smem: per_sm


def _tile(case, per_sm=16):
    return klegacy.seed_tile(*case, n_sms=H100_SMS, resident=_resident(per_sm))


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(path.stem, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_SMOKE = _module(ROOT / "chip_smoke.py")
_CARD = _module(ROOT / "tests" / "test_torch_kernels_card.py")
SEED_CASES = sorted(set(_SMOKE.SEED_SHAPES) | set(_CARD.SEED_CARD_CASES))
POW2_CASES = sorted(set(_SMOKE.POW2_SHAPES) | {(5, 33, 7)} | set(_CARD.POW2_CARD_CASES))


@pytest.mark.parametrize("per_sm", RESIDENT)
@pytest.mark.parametrize("b,h,w,c,n,k", SEED_CASES)
def test_seed_strips_cover_every_output_row_once(b, h, w, c, n, k, per_sm):
    t = _tile((b, h, w, c, n, k), per_sm)
    h_out = h - k + 1
    covered = [r for s in range(t["n_strips"]) for r in range(s * t["rows"],
                                                              min((s + 1) * t["rows"], h_out))]
    assert covered == list(range(h_out))
    assert (t["n_strips"] - 1) * t["rows"] < h_out  # no empty strip
    assert 1 <= t["rows"] <= klegacy.MAX_STRIP
    assert t["ctas"] == b * t["n_strips"] * t["n_split"]
    assert t["resident"] == per_sm


@pytest.mark.parametrize("b,h,w,c,n,k", SEED_CASES)
def test_seed_ring_and_weights_fit_a_hopper_block(b, h, w, c, n, k):
    t = _tile((b, h, w, c, n, k))
    assert t["ring_rows"] == k + 1
    # A ring row holds every column a thread reads (pad columns past W for
    # the masked ones), at the ring's column stride, in whole 16-byte words.
    assert t["rs"] % 4 == 0 and t["rs"] >= (t["cg"] * t["tw"] + k - 1) * t["cs"]
    assert t["cs"] >= c and t["rs"] >= w * t["cs"]
    assert t["smem"] == 4 * (k * k * c * t["np"] + (k + 1) * t["rs"])
    assert t["smem"] <= SMEM_LIMIT == 232_448
    # 16-byte row copies only where a ring row is the input row verbatim.
    assert not t["xvec"] or (t["cs"] == c and (w * c) % 4 == 0)


@pytest.mark.parametrize("b,h,w,c,n,k", SEED_CASES)
def test_seed_threads_cover_every_column_and_channel(b, h, w, c, n, k):
    t = _tile((b, h, w, c, n, k))
    assert (t["tw"], t["tn"]) in klegacy.SEED_TILES
    assert t["cg"] * t["tw"] >= w - k + 1 > (t["cg"] - 1) * t["tw"]
    assert t["np"] == t["ngc"] * t["tn"] and t["np"] % 4 == 0
    assert t["n_split"] * t["np"] >= n > (t["n_split"] - 1) * t["np"]
    assert t["threads"] % 32 == 0 and 32 <= t["threads"] <= klegacy.MAX_THREADS


def test_seed_card_cases_reach_every_register_tile_and_n_split():
    tiles = [_tile(case) for case in _CARD.SEED_CARD_CASES]
    assert {(t["tw"], t["tn"]) for t in tiles} == set(klegacy.SEED_TILES)
    # Each tile at C = 3 and at another C.
    assert {(t["tw"], t["tn"], case[3] == 3) for t, case in zip(tiles, _CARD.SEED_CARD_CASES)} \
        == {(tw, tn, c3) for tw, tn in klegacy.SEED_TILES for c3 in (False, True)}
    assert any(t["n_split"] > 1 for t in tiles)
    # A strip edge: strips of several rows, the last of them short.
    assert any(t["rows"] > 1 and t["n_strips"] * t["rows"] > case[1] - case[5] + 1
               for t, case in zip(tiles, _CARD.SEED_CARD_CASES))
    assert any(t["cs"] != case[3] for t, case in zip(tiles, _CARD.SEED_CARD_CASES))
    assert any(not t["xvec"] for t in tiles) and any(t["xvec"] for t in tiles)


def test_seed_tile_at_the_kernel_bench_shapes():
    """On 132 SMs, B=8 takes the 2 x 4 tile and one row per CTA (256 CTAs
    of 128 threads); B=256 the 4 x 8 tile and, at 16 one-warp CTAs an SM,
    strips of 4 rows: 2,048 CTAs, one wave."""
    small = _tile((8, 36, 36, 3, 32, 5))
    assert (small["tw"], small["tn"], small["rows"], small["ctas"]) == (2, 4, 1, 256)
    assert small["threads"] == 128
    big = _tile((256, 36, 36, 3, 32, 5), per_sm=16)
    assert (big["tw"], big["tn"], big["rows"], big["ctas"]) == (4, 8, 4, 2048)
    assert big["cs"] == 3 and big["smem"] == 12_192


@pytest.mark.parametrize("b,h,w,c,n,k", [(1, 11, 11, 121, 4, 11), (1, 12, 40, 700, 4, 9)])
def test_seed_tile_refuses_what_no_block_holds(b, h, w, c, n, k):
    """One channel group of weights alone above a block: no column strip
    helps."""
    with pytest.raises(ValueError, match="shared memory"):
        _tile((b, h, w, c, n, k))


@pytest.mark.parametrize("b,h,w,c,n,k", _CARD.SEED_STRIP_CASES)
def test_seed_tile_cuts_a_wide_ring_into_column_strips(b, h, w, c, n, k):
    """A ring of K + 1 rows of the whole frame above a block: the frame
    runs as column strips, each strip's ring (its columns and the K - 1 of
    halo) within the block, the strips covering every output column once."""
    t = _tile((b, h, w, c, n, k))
    strips = t["strips"]
    assert len(strips) > 1 and t["smem"] <= SMEM_LIMIT
    assert strips == khalo.column_strips(w, k, 1, 0, 0, strips[0][3])
    assert [o for _, _, lo, hi in strips for o in range(lo, hi)] == list(range(w - k + 1))
    for in_lo, in_hi, lo, hi in strips:
        assert in_hi - in_lo == hi - lo + k - 1
        assert t["cg"] * t["tw"] >= hi - lo and t["rs"] >= (in_hi - in_lo) * t["cs"]
    assert t["ctas"] == b * t["n_strips"] * t["n_split"] * len(strips)


@pytest.mark.parametrize("c,cg,tasks,threads", [(3, 8, 32, 32), (32, 18, 36, 64), (4, 32, 256, 256),
                                                (70, 9, 45, 64), (1, 64, 256, 256)])
def test_ring_column_stride_never_adds_wavefronts(c, cg, tasks, threads):
    """The chosen stride puts a warp's columns in no more wavefronts than C
    itself; odd C is conflict-free already and kept."""
    def worst(cs):
        out = 0
        for w0 in range(0, min(tasks, threads), 32):
            banks = [0] * 32
            for g in {i % cg for i in range(w0, min(w0 + 32, tasks))}:
                banks[g * cs % 32] += 1
            out = max(out, max(banks))
        return out

    cs = klegacy.ring_column_stride(c, cg, tasks, threads)
    assert c <= cs < c + 4 and worst(cs) <= worst(c)
    if c % 2:
        assert cs == c


@pytest.mark.parametrize("m,k,n", POW2_CASES)
def test_p2_plan_tiles_k_exactly_once(m, k, n):
    p = kpow2.p2_plan(m, k, n, H100_SMS)
    bk = p["bk"]
    assert p["split"] in (1, 2, 4, 8)
    assert p["slices"] == -(-k // bk)
    ranges = p["k_ranges"]
    assert len(ranges) == p["split"]
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi - lo >= 1 for lo, hi in ranges)  # every CTA gets at least one slice
    assert all(lo % bk == 0 for lo, _ in ranges)  # ranges start on slice boundaries
    if k <= bk:
        assert p["split"] == 1
    if p["split"] > 1:
        assert p["ctas"] <= kpow2.CTAS_PER_SM * H100_SMS and p["slices"] >= 2 * p["split"]
    assert p["ctas"] == p["tiles"] * p["split"]
    assert p["tiles"] == -(-m // p["bm"]) * -(-n // p["bn"])


def test_p2_plan_at_the_heads():
    """The cifar10 head's first FC splits K = 1024 over clusters of 8 (128
    CTAs of 4 slices); its second (K = 64) runs one CTA per tile; lenet5's
    first (128 tiles already) splits in two, its second (16 tiles) in 8."""
    assert kpow2.p2_plan(256, 1024, 64, H100_SMS)["split"] == 8
    assert kpow2.p2_plan(256, 1024, 64, H100_SMS)["ctas"] == 128
    assert kpow2.p2_plan(256, 64, 10, H100_SMS)["split"] == 1
    assert kpow2.p2_plan(256, 800, 500, H100_SMS)["split"] == 2
    assert kpow2.p2_plan(256, 500, 10, H100_SMS)["split"] == 8


def test_pow2_card_cases_reach_every_split():
    splits = {kpow2.p2_plan(*case, H100_SMS)["split"] for case in _CARD.POW2_CARD_CASES}
    assert splits == {1, 2, 4, 8}
    assert all(n % 2 for _, _, n in _CARD.POW2_CARD_CASES)


SSM_CASES = sorted({case[1:5] for case in _SMOKE.SSM_CASES}
                   | {case[:4] for case in _CARD.SSM_CASES}
                   | {(1, 512, 8192, 16), (4, 1, 8192, 16)})


def _scan(bz, s, d, n, **kw):
    return kscan.scan_plan(bz, s, d, n, n_sms=H100_SMS, **kw)


def test_scan_plan_fills_the_card_at_the_falcon_mamba_shapes():
    """Bz 4, D 8192, N 16: two lanes a channel give 2,048 warps, 15.5 an
    SM, at least FILL_WARPS_PER_SM (one thread a channel gave 8), in 512
    CTAs that all fit on the card at once (threads, CTAs and shared memory
    within an SM). One sequence (Bz 1) takes eight lanes for the same
    warps; decode (S = 1) the same lanes as prefill."""
    p = _scan(4, 512, 8192, 16)
    assert (p["lanes"], p["npl"], p["dc"], p["threads"]) == (2, 8, 64, 128)
    assert p["warps"] == 2048 >= kscan.FILL_WARPS_PER_SM * H100_SMS
    assert p["ctas"] == 512 and p["per_sm"] == -(-p["ctas"] // H100_SMS) == 4
    assert p["per_sm"] * p["threads"] <= kscan.SM_THREADS
    assert p["per_sm"] * (p["smem"] + kscan.CTA_RESERVED_SMEM) <= kscan.SM_SMEM
    assert p["chunk"] == 32
    one = _scan(1, 512, 8192, 16)
    assert (one["lanes"], one["warps"]) == (8, 2048)
    assert _scan(4, 1, 8192, 16)["lanes"] == 2
    # One lane a channel would leave the SMs short of warps.
    assert 4 * 8192 // 32 < kscan.FILL_WARPS_PER_SM * H100_SMS


@pytest.mark.parametrize("n", [4, 16, 32, 64, 512])
def test_scan_plan_splits_n_over_lanes_that_divide_it(n):
    p = _scan(4, 512, 8192, n)
    assert n % p["lanes"] == 0 and p["lanes"] * p["npl"] == n
    assert (p["lanes"], p["npl"]) in kscan.KERNEL_TILES and p["npl"] <= kscan.MAX_NPL
    assert p["threads"] % 32 == 0 and p["threads"] <= 256 and p["dc"] % 8 == 0
    assert p["chunk"] % p["lanes"] == 0 and p["smem"] <= kscan.BLOCK_SMEM
    assert p["bcp"] % 4 == 0 and p["bcp"] >= n


@pytest.mark.parametrize("bz,s,d,n", SSM_CASES + [(2, 5, 13, 7), (3, 2, 9, 3), (1, 4, 8, 1)])
def test_scan_plan_covers_every_channel_and_state(bz, s, d, n):
    """A ragged D: the last CTA's channels past D are masked, none is
    left out; N need not be a power of two (zero-padded lanes)."""
    p = _scan(bz, s, d, n, elem_bytes=2)
    assert p["ctas"] == bz * -(-d // p["dc"]) and (p["ctas"] // bz) * p["dc"] >= d
    assert p["lanes"] * p["npl"] >= n > p["lanes"] * p["npl"] // 2 or p["npl"] == 1
    assert p["lanes"] <= n
    assert p["chunk"] % p["lanes"] == 0 and p["chunk"] <= max(p["lanes"], kscan.MAX_CHUNK)
    assert p["smem"] == kscan.smem_bytes(p["chunk"], p["dc"], p["bcp"], 2, p["lanes"])
    assert p["smem"] <= kscan.BLOCK_SMEM


@pytest.mark.parametrize("bz,s,d,n,tile", _CARD.SCAN_TILE_CASES)
def test_scan_plan_picks_each_compiled_tile_at_the_card_tests_shapes(bz, s, d, n, tile):
    p = _scan(bz, s, d, n)
    assert (p["lanes"], p["npl"]) == tile
    assert p["threads"] == max(kscan.THREADS, 8 * p["lanes"])


def test_the_card_tests_run_every_compiled_scan_tile():
    assert {case[-1] for case in _CARD.SCAN_TILE_CASES} == kscan.KERNEL_TILES


def test_scan_plan_takes_a_compiled_tile_for_every_n():
    """Every N up to MAX_N, at a grid that fills the card and one that
    does not, has a compiled kernel: the plan never asks for a missing one."""
    for n in range(1, kscan.MAX_N + 1):
        for bz, d in ((4, 8192), (1, 64)):
            p = _scan(bz, 8, d, n)
            assert (p["lanes"], p["npl"]) in kscan.KERNEL_TILES
            assert p["lanes"] * p["npl"] >= n


def test_scan_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="at most 512 states"):
        _scan(1, 4, 8, 513)


# ---------------------------------------------------------------------------
# The int8 conv kernels' tiles and plans (conv.int8_layer, int8_layout).

from repro_torch.core.dhm import QuantSpec, compile_dhm  # noqa: E402
from repro_torch.core.dhm import compiler as tcompiler  # noqa: E402
from repro_torch.core.dhm import fusion as tfusion  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn  # noqa: E402

INT8_QUANT = QuantSpec(weight_bits=8, act_bits=8, int8_compute=True)


@pytest.mark.parametrize("name", sorted(ALL_TOPOLOGIES))
@pytest.mark.parametrize("vmem_budget", [None, 0])
def test_every_planned_int8_group_fits_and_keeps_the_reference_groups(name, vmem_budget):
    """The five topologies' int8 plans: the card's groups are the
    reference's, each multi-layer group's pyramid fits a Hopper block at
    the reference's block_rows, and each singleton's single-layer launch
    fits (sized as the launcher sizes it)."""
    topo = ALL_TOPOLOGIES[name]
    params = init_cnn(torch.Generator().manual_seed(0), topo, device="cpu")
    plan = compile_dhm(topo, params, quant=INT8_QUANT, vmem_budget=vmem_budget, device="cpu")
    idxs = tuple(range(len(topo.conv_layers)))
    card = tcompiler.card_fusion_groups(topo, idxs, plan.fusion_groups, elem_bytes=1)
    assert card == tuple(plan.fusion_groups)
    h, w = topo.input_shape
    dims = [(h, w, topo.input_channels)]
    for spec in topo.conv_layers:
        dims.append((*spec.out_hw(*dims[-1][:2]), spec.n_out))
    for g in card:
        if g.fused:
            geom = tfusion._group_geom(topo, g.layers, g.block_rows)
            assert kconv.pyramid_smem_bytes(geom, 1) <= kconv.SMEM_LIMIT
            continue
        (li,) = g.layers
        spec = topo.conv_layers[li]
        hp, wp = khalo.padded_frame(*dims[li][:2], spec.kernel, spec.stride, spec.padding)
        fp = kconv.fused_plan(hp, wp, dims[li][2], k=spec.kernel, stride=spec.stride,
                              pool=spec.pool, pool_stride=spec.pool_stride, block_r=8,
                              n_out=spec.n_out, elem_bytes=1)
        assert fp["smem"] <= kconv.SMEM_LIMIT
        assert len(fp["strips"]) == len(fp["slices"]) == 1


def test_int8_tiles_give_every_warp_of_cifar10_a_task():
    """cifar10's int8 pyramid at B=256 (one whole-frame block an image):
    4 n8 tiles a task at layer 0 (16 window sets), 2 at layer 1 (4 sets
    of 32 channels), 1 at layer 2 (one set of 64): at least 8 tasks a
    layer for the CTA's 8 warps; two CTAs fit an SM."""
    topo = ALL_TOPOLOGIES["cifar10"]
    geom = tfusion._group_geom(topo, (0, 1, 2), 0)
    lay = kconv.int8_pyramid_layout(geom)
    assert [li.nt for li in lay.layers] == [4, 2, 1]
    for i, (g, li) in enumerate(zip(geom.layers, lay.layers)):
        olo, ohi = kconv.pyramid_rows(geom, 0)[i][:2]
        m_tasks = -(-(ohi - olo) * g.out_cols // kconv.int8_tiles(g.pw)[1])
        assert m_tasks * -(-g.n_out // (8 * li.nt)) >= kconv.THREADS // 32
    assert 2 * (lay.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("pw", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [8, 20, 50, 64, 1024])
@pytest.mark.parametrize("outputs", [1, 16, 64, 256])
def test_int8_nt_is_an_instantiated_tile(pw, n, outputs):
    """The host picks only n8 tiles the source instantiates for the pool
    window (sc_gemm_i8_pick), and the staged rows cover every task's
    tiles."""
    nt = kconv.int8_nt(pw, n, outputs)
    assert nt in kconv.I8_TILES_N.get(pw or 1, (1,))
    sl = kconv.Int8Slab(rows=8, cols=8, c=16, k=3, stride=1, pw=pw, ps=pw or 1, n=n, n_wr=1,
                        n_wc=outputs)
    lay = kconv.int8_layer(sl)
    groups = -(-(-(-n // 8)) // lay.nt)
    assert groups * lay.nt * 8 <= lay.n_pad
