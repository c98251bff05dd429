"""The single-layer int8 kernel's wgmma path on the card, held bit for bit
to its plain version (``stream_conv_block_ref``, whose float64 sums of
integer products are exact) at every VGG-16 single-layer shape, at ragged
shapes on the path, and just outside its rule, where the mma.sync path
runs instead.

Every test needs an NVIDIA card: it asks for it inside the test (the
``card`` fixture) and skips there without one. Run on a machine with the
card and the CUDA toolkit (the kernels are built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_fused_i8_card.py

This file imports no JAX: the machine with the card has none.

The operands: stream codes over the whole 8-bit grid, weight codes in
[-8, 8] at a weight scale of 2^-10, so that the outputs spread over the
grid rather than clip, and a bias of about 0.05.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import (  # noqa: E402
    stream_conv_block,
    stream_conv_block_ref,
)
from repro_torch.kernels.stream_conv.epilogue import Int8Scales  # noqa: E402
from repro_torch.models.cnn import VGG16  # noqa: E402

B = 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    return torch.device("cuda")


def _vgg16_cases():
    """(H, W, C, N, pool) of VGG-16's layers 2-12 at 224x224."""
    h, w = VGG16.input_shape
    c = VGG16.input_channels
    out = []
    for i, sp in enumerate(VGG16.conv_layers):
        if i >= 2:
            out.append((h, w, c, sp.n_out, sp.pool))
        h, w = sp.out_hw(h, w)
        c = sp.n_out
    return out


def _operands(dev, seed, h, w, c, n):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randint(-128, 128, (B, h, w, c), generator=gen, device=dev) / 64.0
    wq = torch.randint(-8, 9, (3, 3, c, n), generator=gen, device=dev, dtype=torch.int8)
    b = 0.05 * torch.randn(n, generator=gen, device=dev)
    return x, wq, b


def _run(dev, seed, h, w, c, n, pool, *, path, kmajor=False):
    x, wq, b = _operands(dev, seed, h, w, c, n)
    kw = dict(padding="SAME", act="relu", pool=pool, act_bits=8,
              int8_scales=Int8Scales(in_bits=8, w_scale=2.0 ** -10))
    g = kconv.fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=pool, pool_stride=None, block_r=8,
                         n_out=n, elem_bytes=1)
    assert g["path"] == path
    before, paths = dict(kconv.LAUNCHES), dict(kconv.PATH_LAUNCHES)
    extra = dict(w_kmajor=kconv.kmajor_weights(wq)) if kmajor else {}
    out = stream_conv_block(x, wq, b, **kw, **extra)
    torch.cuda.synchronize()
    launches = len(g["strips"]) * len(g["slices"])
    assert kconv.LAUNCHES["stream_conv_fused_int8"] == before["stream_conv_fused_int8"] + launches
    assert kconv.PATH_LAUNCHES[path] == paths[path] + launches
    ref = stream_conv_block_ref(x, wq, b, **kw)
    assert out.shape == ref.shape
    assert torch.equal(out, ref), float((out - ref).abs().max())
    # The outputs spread over the grid, not clipped to its ends.
    assert int(torch.unique(ref).numel()) > 8
    return g


@pytest.mark.card
@pytest.mark.parametrize("case", _vgg16_cases(), ids=lambda c: "{0}x{1}x{2}_n{3}_p{4}".format(*c))
def test_wgmma_path_equals_the_plain_version_at_vgg16_shapes(card, case):
    g = _run(card, sum(case), *case, path="wgmma", kmajor=True)
    assert len(g["strips"]) == len(g["slices"]) == 1


@pytest.mark.card
@pytest.mark.parametrize("h,w,c,n,pool", [
    (19, 21, 192, 192, 0),  # N tiles 128 + 64, an odd width, rows 10 + 9
    (19, 21, 192, 192, 2),  # windows 10 a row, rows 5 + 4, the last conv row and column unpooled
    (4, 300, 64, 64, 0),  # two column strips
    (3, 300, 512, 128, 0),  # a row's slab too large for the ring: five strips of 64 columns
    (4, 260, 512, 128, 2),  # pooled: five strips of 32 windows
    (9, 7, 128, 200, 2),  # one block of 12 windows, N 200
])
def test_wgmma_path_at_ragged_shapes(card, h, w, c, n, pool):
    _run(card, h * w + n, h, w, c, n, pool, path="wgmma")


@pytest.mark.card
@pytest.mark.parametrize("h,w,c,n,pool", [(12, 12, 32, 64, 0), (12, 12, 64, 32, 2)])
def test_just_outside_the_rule_the_mma_sync_path_runs(card, h, w, c, n, pool):
    _run(card, h + c + n, h, w, c, n, pool, path="mma_sync")
