"""The port's streaming conv wrappers on CPU tensors (their plain PyTorch
versions), held against the reference's ``ref`` backend and its ``pallas``
backend (on the CPU: the XLA rendering of the kernel's algorithm) over a
stride x pool (overlapping included) x rectangular frame x padding grid,
in fp32 and with stream quantization.

Tolerances: fp32 rtol=1e-4, atol=1e-5 (the reference's own). With
``act_bits`` the outputs are equal except where an fp32 sum taken in
another order lands on the other side of a rounding boundary; those
elements sit exactly one quant step apart and are counted.
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.stream_conv import ops as jops  # noqa: E402
from repro.models.cnn import ConvLayerSpec as JSpec  # noqa: E402
from repro_torch.kernels.stream_conv import ops as tops  # noqa: E402
from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec  # noqa: E402
from repro_torch.models.cnn import ConvLayerSpec as TSpec  # noqa: E402

FP32 = dict(rtol=1e-4, atol=1e-5)
# At most this many of the elements may sit one quant step apart.
MAX_STEP_SHARE = 0.01


def assert_matches(got, want, act_bits, what=""):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    if act_bits is None:
        np.testing.assert_allclose(got, want, err_msg=what, **FP32)
        return 0
    step = stream_quant_spec(act_bits).scale
    d = np.abs(got - want)
    off = d > 1e-6
    np.testing.assert_allclose(d[off], step, rtol=1e-5, err_msg=what)
    assert off.sum() <= MAX_STEP_SHARE * d.size, (what, int(off.sum()))
    return int(off.sum())


def _inputs(seed, b, h, w, c, k, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(k, k, c, n)) * np.sqrt(2.0 / (k * k * c))).astype(np.float32)
    bias = (rng.normal(size=(n,)) * 0.1).astype(np.float32)
    return x, wt, bias


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("pool,pool_stride", [(0, None), (2, None), (3, 2), (2, 3)])
@pytest.mark.parametrize("act_bits", [None, 4])
def test_stream_conv_block_matches_reference(padding, stride, pool, pool_stride, act_bits):
    h, w, k = (13, 16, 3) if stride == 1 else (17, 14, 5)
    x, wt, bias = _inputs(stride * 10 + pool, 2, h, w, 3, k, 6)
    kw = dict(padding=padding, stride=stride, act="tanh" if stride == 1 else "relu",
              pool=pool, pool_stride=pool_stride, act_bits=act_bits)
    got = tops.stream_conv_block(torch.from_numpy(x), torch.from_numpy(wt),
                                 torch.from_numpy(bias), **kw).numpy()
    # The XLA rendering of the Pallas kernel runs the same epilogue code as
    # ``ref`` once the conv is summed: one quantized grid is enough there.
    for backend in ("ref", "pallas") if act_bits is None else ("ref",):
        want = jops.stream_conv_block(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                      backend=backend, **kw)
        assert_matches(got, want, act_bits, backend)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_stream_conv2d_matches_reference(padding):
    x, wt, _ = _inputs(5, 2, 10, 13, 4, 3, 5)
    got = tops.stream_conv2d(torch.from_numpy(x), torch.from_numpy(wt), padding=padding)
    want = jops.stream_conv2d(jnp.asarray(x), jnp.asarray(wt), padding=padding, backend="ref")
    assert_matches(got.numpy(), want, None)


PYRAMIDS = {
    "same_pool2": [dict(n_out=5, kernel=5, padding="SAME"),
                   dict(n_out=4, kernel=3, padding="SAME")],
    "valid_pool2": [dict(n_out=5, kernel=5, padding="VALID"),
                    dict(n_out=4, kernel=3, padding="VALID", act="relu")],
    "overlap_pool": [dict(n_out=4, kernel=5, padding="SAME", pool=3, pool_stride=2, act="relu"),
                     dict(n_out=6, kernel=3, padding="SAME", pool=3, pool_stride=2, act="relu")],
    "strided": [dict(n_out=4, kernel=5, padding="SAME", stride=2, pool=0, act="relu"),
                dict(n_out=5, kernel=3, padding="SAME", stride=2, pool=0, act="relu"),
                dict(n_out=3, kernel=3, padding="SAME", pool=2, act="relu")],
}


@pytest.mark.parametrize("stack", sorted(PYRAMIDS))
@pytest.mark.parametrize("frame", [(24, 24), (21, 27)])
@pytest.mark.parametrize("act_bits", [None, 6])
def test_stream_conv_pyramid_matches_reference(stack, frame, act_bits):
    specs = PYRAMIDS[stack]
    rng = np.random.default_rng(len(stack) + frame[0])
    h, w = frame
    x = rng.normal(size=(2, h, w, 3)).astype(np.float32)
    ws, bs, c = [], [], 3
    for s in specs:
        k, n = s["kernel"], s["n_out"]
        ws.append((rng.normal(size=(k, k, c, n)) * np.sqrt(2.0 / (k * k * c))).astype(np.float32))
        bs.append((rng.normal(size=(n,)) * 0.1).astype(np.float32))
        c = n
    got = tops.stream_conv_pyramid(
        torch.from_numpy(x), [torch.from_numpy(a) for a in ws],
        [torch.from_numpy(a) for a in bs], layers=[TSpec(**s) for s in specs],
        act_bits=act_bits,
    ).numpy()
    # The reference's XLA rendering streams one final row per block here,
    # so its composed-halo row blocking is exercised too.
    for backend, block_rows in (("ref", 0), ("pallas", 1)):
        want = jops.stream_conv_pyramid(
            jnp.asarray(x), [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in bs],
            layers=[JSpec(**s) for s in specs], act_bits=act_bits,
            block_rows=block_rows, backend=backend,
        )
        assert_matches(got, want, act_bits, f"{backend} block_rows={block_rows}")


@pytest.mark.parametrize("axis", [0, 1, 2, -1])
@pytest.mark.parametrize("mult", [1, 4, 5])
def test_padding_helpers_match_reference(axis, mult):
    from repro.kernels import padding as jpad
    from repro_torch.kernels import padding as tpad

    x = np.random.default_rng(axis + 7 * mult).normal(size=(3, 6, 7)).astype(np.float32)
    assert tpad.round_up(x.shape[axis], mult) == jpad.round_up(x.shape[axis], mult)
    got = tpad.pad_axis_to_multiple(torch.from_numpy(x), axis, mult).numpy()
    want = np.asarray(jpad.pad_axis_to_multiple(jnp.asarray(x), axis, mult))
    np.testing.assert_array_equal(got, want)
    target = x.shape[axis] + mult
    np.testing.assert_array_equal(tpad.pad_axis_to(torch.from_numpy(x), axis, target).numpy(),
                                  np.asarray(jpad.pad_axis_to(jnp.asarray(x), axis, target)))


def _raises_same(fn_jax, fn_torch):
    with pytest.raises(ValueError) as want:
        fn_jax()
    with pytest.raises(ValueError) as got:
        fn_torch()
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "case",
    ["non_square", "bad_padding", "bad_act", "bad_pool", "bias_shape", "pool_too_big",
     "stride_zero"],
)
def test_stream_conv_block_validation_errors_match(case):
    x, wt, bias = _inputs(1, 1, 8, 8, 3, 3, 4)
    kw = dict(padding="SAME", act="relu", pool=2)
    if case == "non_square":
        wt = wt[:, :2]
    elif case == "bad_padding":
        kw["padding"] = "FULL"
    elif case == "bad_act":
        kw["act"] = "rleu"
    elif case == "bad_pool":
        kw["pool_stride"] = 0
    elif case == "bias_shape":
        bias = bias[:3]
    elif case == "pool_too_big":
        kw.update(padding="VALID", pool=7)
    elif case == "stride_zero":
        kw.update(padding="VALID", stride=0)
    # The reference raises these argument checks only in its Pallas
    # wrapper, before the kernel body is traced; its interpret backend
    # reaches them without running the oracle.
    backend = "pallas_interpret"
    _raises_same(
        lambda: jops.stream_conv_block(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                       backend=backend, **kw),
        lambda: tops.stream_conv_block(torch.from_numpy(x), torch.from_numpy(wt),
                                       torch.from_numpy(bias), **kw),
    )


@pytest.mark.parametrize("case", ["count_mismatch", "non_square", "bits_length"])
def test_stream_conv_pyramid_validation_errors_match(case):
    x, wt, bias = _inputs(2, 1, 8, 8, 3, 3, 4)
    specs = [dict(n_out=4, kernel=3, padding="SAME")] * 2
    bs, bits = [bias, bias], None
    w2 = np.ones((3, 3, 4, 4), np.float32)
    ws = [wt, w2]
    if case == "count_mismatch":
        bs = [bias]
    elif case == "non_square":
        ws = [wt[:, :2], w2]
    elif case == "bits_length":
        bits = (4,)
    _raises_same(
        lambda: jops.stream_conv_pyramid(
            jnp.asarray(x), [jnp.asarray(a) for a in ws], [jnp.asarray(a) for a in bs],
            layers=[JSpec(**s) for s in specs], act_bits=bits, backend="ref"),
        lambda: tops.stream_conv_pyramid(
            torch.from_numpy(x), [torch.from_numpy(a) for a in ws],
            [torch.from_numpy(a) for a in bs], layers=[TSpec(**s) for s in specs],
            act_bits=bits),
    )
