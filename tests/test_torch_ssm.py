"""The port's selective scan, Mamba mixer and seed conv on CPU tensors
(their plain PyTorch versions), held against the reference on the same
numpy inputs.

The reference side runs ``ssm_scan_ref`` and the model's own recurrence
(``chunked_linear_recurrence`` plus the einsum), never the Pallas
interpret oracle. Tolerances: the scan and the seed conv at the
reference's own (atol 1e-5; the conv with rtol 1e-4); the mixer at
rtol 1e-4, atol 1e-5 in f32 (the port sums h . C inside the scan, the
reference in an einsum after it).
"""
import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssm_scan import ssm_scan_ref as j_ssm_scan_ref  # noqa: E402
from repro.kernels.stream_conv import stream_conv2d_ref as j_conv_ref  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_ref  # noqa: E402
from repro_torch.kernels.stream_conv import legacy as klegacy  # noqa: E402
from repro_torch.kernels.stream_conv import stream_conv2d_seed  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

SCAN_ATOL = 1e-5
MIXER = dict(rtol=1e-4, atol=1e-5)
CONV = dict(rtol=1e-4, atol=1e-5)

# TestSSMScan's shape sweep: (Bz, S, D, N, seed).
SWEEP = [(1, 2, 4, 1, 0), (2, 7, 8, 2, 1), (1, 20, 16, 4, 2),
         (2, 13, 4, 4, 3), (1, 5, 8, 1, 4), (2, 16, 16, 2, 5)]


def _mk(bz, s, d, n, seed=0):
    """TestSSMScan._mk's recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bz, s, d)) * 0.5
    dt = np.logaddexp(0.0, rng.normal(size=(bz, s, d)))  # softplus
    b = rng.normal(size=(bz, s, n))
    c = rng.normal(size=(bz, s, n))
    a = -np.exp(rng.normal(size=(d, n)) * 0.3)
    d_skip = np.ones((d,))
    h0 = rng.normal(size=(bz, d, n))
    return [v.astype(np.float32) for v in (x, dt, b, c, a, d_skip, h0)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _model_recurrence(x, dt, b, c, a, d_skip, h0):
    """The y and final state the reference's mamba_apply computes."""
    dta = jnp.exp(dt[..., None] * a[None, None])
    bx = (dt * x)[..., None] * b[:, :, None, :]
    h_all, h_last = jssm.chunked_linear_recurrence(dta, bx, jnp.asarray(h0), chunk=8)
    y = jnp.einsum("bsdn,bsn->bsd", h_all, c) + x * d_skip
    return np.asarray(y), np.asarray(h_last)


@pytest.mark.parametrize("bz,s,d,n,seed", SWEEP)
def test_scan_matches_reference_ref(bz, s, d, n, seed):
    x, dt, b, c, a, d_skip, _ = _mk(bz, s, d, n, seed)
    y, h_last = ssm_scan(*_t(x, dt, b, c, a, d_skip), block_d=4)
    assert y.shape == (bz, s, d) and y.dtype == torch.float32
    assert h_last.shape == (bz, d, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_ssm_scan_ref(x, dt, b, c, a, d_skip)),
                               atol=SCAN_ATOL)


@pytest.mark.parametrize("bz,s,d,n,seed", SWEEP)
def test_scan_state_and_initial_state_match_model_recurrence(bz, s, d, n, seed):
    x, dt, b, c, a, d_skip, h0 = _mk(bz, s, d, n, seed)
    for init in (np.zeros_like(h0), h0):
        y, h_last = ssm_scan(*_t(x, dt, b, c, a, d_skip, init))
        y_ref, h_ref = _model_recurrence(x, dt, b, c, a, d_skip, init)
        np.testing.assert_allclose(y.numpy(), y_ref, atol=SCAN_ATOL)
        np.testing.assert_allclose(h_last.numpy(), h_ref, atol=SCAN_ATOL)


def test_scan_split_in_two_equals_one_scan():
    """Prefill then decode: the final state of the first part is the
    initial state of the second, one step at a time."""
    x, dt, b, c, a, d_skip, h0 = _mk(2, 9, 8, 4, seed=7)
    tx = _t(x, dt, b, c)
    y_all, h_all = ssm_scan(*tx, *_t(a, d_skip, h0))
    y, h = ssm_scan(*(t[:, :6] for t in tx), *_t(a, d_skip, h0))
    ys = [y]
    for t in range(6, 9):
        y_t, h = ssm_scan(*(v[:, t : t + 1] for v in tx), *_t(a, d_skip), h)
        ys.append(y_t)
    torch.testing.assert_close(torch.cat(ys, dim=1), y_all, rtol=0, atol=1e-6)
    torch.testing.assert_close(h, h_all, rtol=0, atol=1e-6)


def test_scan_reads_bf16_inputs_in_float32():
    x, dt, b, c, a, d_skip, _ = _mk(2, 6, 8, 4, seed=8)
    xb, bb, cb = (torch.from_numpy(v).to(torch.bfloat16) for v in (x, b, c))
    y, _ = ssm_scan(xb, torch.from_numpy(dt), bb, cb, *_t(a, d_skip))
    want = j_ssm_scan_ref(jnp.asarray(xb.float().numpy()), dt, jnp.asarray(bb.float().numpy()),
                          jnp.asarray(cb.float().numpy()), a, d_skip)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), atol=SCAN_ATOL)


def test_scan_on_the_cpu_launches_nothing_and_the_kernel_wrapper_refuses_cpu_tensors():
    args = _t(*_mk(1, 3, 8, 2)[:6])
    before = dict(kscan.LAUNCHES)
    ssm_scan(*args)
    assert kscan.LAUNCHES == before
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        kscan.ssm_scan_cuda(*args)
    with pytest.raises(ValueError, match="unsupported device"):
        ssm_scan(*(t.to("meta") for t in args))
    assert kscan.LAUNCHES == before


@pytest.mark.parametrize("which,shape,match", [
    (1, (1, 3, 4), "dt"), (2, (1, 3, 3), "b"), (4, (8, 3), "a"), (6, (1, 8, 3), "h0"),
])
def test_scan_validates_shapes(which, shape, match):
    args = _t(*_mk(1, 3, 8, 2))
    args[which] = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        ssm_scan(*args)


def test_plain_version_is_the_dispatch_target_on_the_cpu():
    args = _t(*_mk(2, 5, 8, 2, seed=9))
    for got, want in zip(ssm_scan(*args), ssm_scan_ref(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# causal_conv1d and the Mamba mixer


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv1d_matches_reference(k, carried):
    rng = np.random.default_rng(k)
    x = rng.normal(size=(2, 7, 6)).astype(np.float32)
    w = rng.normal(size=(k, 6)).astype(np.float32)
    state = rng.normal(size=(2, k - 1, 6)).astype(np.float32) if carried else None
    y, new = tssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                                state=None if state is None else torch.from_numpy(state))
    y_ref, new_ref = jssm.causal_conv1d(x, w, state=state)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **MIXER)
    assert tuple(new.shape) == tuple(new_ref.shape)
    np.testing.assert_allclose(new.numpy(), np.asarray(new_ref), **MIXER)


SPEC = dict(d_model=32, d_inner=64, d_state=8, d_conv=4)


def _mixer_params(seed):
    jspec = jssm.MambaSpec(**SPEC)
    jp = jax.device_get(jssm.init_mamba(jax.random.PRNGKey(seed), jspec))
    # The reference starts the skip at ones and the biases at zeros: draw
    # them so the test sees them.
    rng = np.random.default_rng(seed)
    jp["d_skip"] = rng.normal(size=jp["d_skip"].shape).astype(np.float32)
    jp["conv_b"] = (rng.normal(size=jp["conv_b"].shape) * 0.1).astype(np.float32)
    jp["dt_proj"]["b"] = (rng.normal(size=jp["dt_proj"]["b"].shape) * 0.1).astype(np.float32)
    return jspec, jp, lm_params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 9])
def test_mamba_apply_matches_reference(carried, s):
    jspec, jp, tp = _mixer_params(seed=s)
    rng = np.random.default_rng(100 + s)
    x = rng.normal(size=(2, s, SPEC["d_model"])).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        ssm_state = rng.normal(size=(2, SPEC["d_inner"], SPEC["d_state"])).astype(np.float32)
        conv_state = rng.normal(size=(2, SPEC["d_conv"] - 1, SPEC["d_inner"])).astype(np.float32)
        kw_j = dict(ssm_state=ssm_state, conv_state=conv_state)
        kw_t = {k: torch.from_numpy(v) for k, v in kw_j.items()}
    outs = tssm.mamba_apply(tp, tssm.MambaSpec(**SPEC), torch.from_numpy(x), **kw_t)
    refs = jssm.mamba_apply(jp, jspec, jnp.asarray(x), **kw_j)
    for what, got, want in zip(("y", "ssm state", "conv state"), outs, refs):
        assert got.dtype == torch.float32, what
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **MIXER)


def test_init_mamba_has_the_reference_tree():
    jspec = jssm.MambaSpec(**SPEC)
    ref = jax.device_get(jssm.init_mamba(jax.random.PRNGKey(0), jspec, dtype=jnp.bfloat16))
    got = tssm.init_mamba(torch.Generator().manual_seed(0), tssm.MambaSpec(**SPEC),
                          dtype=torch.bfloat16, device="cpu")

    def flat(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from flat(v, prefix + k + ".")
            else:
                yield prefix + k, tuple(v.shape), str(v.dtype).replace("torch.", "")

    assert sorted(flat(got)) == sorted(flat(ref))
    # log(n) of the S4D-real init; XLA's and torch's log may differ by an ulp.
    np.testing.assert_allclose(got["a_log"].numpy(), ref["a_log"], rtol=1e-6, atol=0)
    assert tssm.MambaSpec(**SPEC).dtr == jspec.dtr == 2


# ---------------------------------------------------------------------------
# The seed conv (benchmark baseline)


@pytest.mark.parametrize("b,h,w,c,n,k,seed", [
    (2, 12, 12, 3, 6, 3, 4), (1, 7, 9, 2, 3, 3, 1), (2, 9, 9, 3, 5, 5, 2),
    (1, 6, 5, 4, 7, 1, 3), (3, 36, 36, 3, 32, 5, 5),
])
def test_seed_conv_matches_reference_ref(b, h, w, c, n, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    wt = (rng.normal(size=(k, k, c, n)) * 0.2).astype(np.float32)
    before = dict(klegacy.LAUNCHES)
    out = stream_conv2d_seed(torch.from_numpy(x), torch.from_numpy(wt.reshape(k * k, c, n)), k=k)
    assert klegacy.LAUNCHES == before
    assert tuple(out.shape) == (b, h - k + 1, w - k + 1, n)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_conv_ref(x, wt)), **CONV)


def test_seed_conv_raises_as_the_reference_does():
    x = torch.zeros((1, 8, 8, 3))
    with pytest.raises(ValueError, match="inconsistent"):
        stream_conv2d_seed(x, torch.zeros((8, 3, 4)), k=3)
    with pytest.raises(ValueError, match="inconsistent"):
        stream_conv2d_seed(x, torch.zeros((9, 2, 4)), k=3)
    with pytest.raises(ValueError, match="too small"):
        stream_conv2d_seed(torch.zeros((1, 2, 8, 3)), torch.zeros((9, 3, 4)), k=3)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        klegacy.stream_conv2d_seed_cuda(x, torch.zeros((9, 3, 4)), k=3)
