"""The selective scan's gradient on the CPU: the plain version, the
backward kernel's layout and arithmetic mirrored in Python, and the
registered op.

- ``ref.ssm_scan_bwd_ref`` against ``jax.vjp`` of the reference's
  ``repro.kernels.ssm_scan.ref.ssm_scan_ref`` on the same numpy inputs
  (no ``h0`` and no cotangent of h_last: the reference has neither).
  Tolerances: f32 rtol 1e-4, atol 1e-5 (the two sum the recurrence in
  other orders); bf16 x, B and C: their bf16 gradients within one bf16
  rounding of each other, rtol 2^-7 of the element plus 1e-3 of the
  leaf's largest magnitude (both round an f32 gradient that differs in
  its last bits).
- ``scan.scan_bwd_plan`` with the H100's values (132 SMs, 232,448 B a
  block) on falcon-mamba's full and ``scaled_down()`` layers, S 1-4096,
  Bz 1-8, N 17-64: every plan fits shared memory, covers D and S, and
  names a compiled kernel.
- The kernel's warp reduce-scatter of dB and dC (``ssmb_channel_sum``),
  step for step in Python, against plain sums, for every compiled tile.
- The kernel's two passes (checkpoints, the chunk's recompute, the
  reverse steps) written in PyTorch against the plain version, at chunks
  that do and do not divide S, with and without h0 and the cotangent of
  h_last: rtol 1e-4, atol 1e-5.
- ``repro_torch::ssm_scan_bwd`` as a registered op: ``opcheck``, one node
  of an op log charged 2 Bz S D N on ``meta``, the plain version on the
  CPU with no launch; the scan's autograd Function calling it once; on
  ``meta`` falcon-mamba's train step logging one a layer.
"""
import os

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")  # the reference on the CPU, as the suite runs it

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as kssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
H100_SMS = 132
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")


def _inputs(bz, s, d, n, seed=0):
    """Numpy inputs in the mixer's ranges: x, B, C unit-scale, dt a
    softplus, A = -exp(.) (f32), D_skip, h0, and the cotangents of y and
    h_last."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    x, b, c = f(bz, s, d) * 0.5, f(bz, s, n), f(bz, s, n)
    dt = np.logaddexp(0.0, f(bz, s, d) - 1.0).astype(np.float32)
    a = -np.exp(f(d, n) * 0.3).astype(np.float32)
    return dict(x=x, dt=dt, b=b, c=c, a=a, d_skip=f(d), h0=f(bz, d, n), g_y=f(bz, s, d),
                g_h=f(bz, d, n))


def _port(v, dtype=torch.float32, h0=False, g_h=False):
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    for k in ("x", "b", "c"):
        t[k] = t[k].to(dtype)
    return (t["x"], t["dt"], t["b"], t["c"], t["a"], t["d_skip"], t["h0"] if h0 else None,
            t["g_y"], t["g_h"] if g_h else None)


# ---------------------------------------------------------------------------
# the plain version against jax.vjp of the reference's scan


@pytest.mark.parametrize("s", [64, 300])
@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_gradient_matches_jax_vjp_of_the_reference(dtype, n, s):
    v = _inputs(2, s, 24, n, seed=n + s)
    args = _port(v, dtype)
    got = ssm_scan_bwd_ref(*args)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    primals = [jnp.asarray(v["x"]).astype(jdt), jnp.asarray(v["dt"]),
               jnp.asarray(v["b"]).astype(jdt), jnp.asarray(v["c"]).astype(jdt),
               jnp.asarray(v["a"]), jnp.asarray(v["d_skip"])]
    _, vjp = jax.vjp(j_ssm_scan_ref, *primals)
    want = vjp(jnp.asarray(v["g_y"]))
    assert got[6] is None
    for name, g, w, p in zip(NAMES, got, want, args):
        assert g.dtype == p.dtype and tuple(g.shape) == tuple(w.shape), name
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32))
        if dtype == torch.bfloat16 and name in ("dx", "dB", "dC"):
            np.testing.assert_allclose(g, w, rtol=2.0 ** -7, atol=1e-3 * np.abs(w).max(),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(g, w, err_msg=name, **F32)


def test_plain_gradient_skips_an_absent_cotangent():
    """Only g_h: no gradient reaches C and D_skip, which y alone reads
    (zeros); neither cotangent: all zeros."""
    v = _inputs(1, 9, 8, 4)
    x, dt, b, c, a, d_skip, h0, _, g_h = _port(v, h0=True, g_h=True)
    got = ssm_scan_bwd_ref(x, dt, b, c, a, d_skip, h0, None, g_h)
    assert torch.equal(got[3], torch.zeros_like(c)) and torch.equal(got[5], torch.zeros_like(d_skip))
    assert all(bool(g.abs().sum() > 0) for i, g in enumerate(got) if i not in (3, 5))
    none = ssm_scan_bwd_ref(x, dt, b, c, a, d_skip, h0, None, None)
    assert all(torch.equal(g, torch.zeros_like(p)) for g, p in zip(none, (x, dt, b, c, a,
                                                                             d_skip, h0)))


# ---------------------------------------------------------------------------
# the kernel's plan


def _check_plan(bz, s, d, n, elem):
    p = kscan.scan_bwd_plan(bz, s, d, n, n_sms=H100_SMS, elem_bytes=elem)
    assert p["smem"] == kscan.bwd_smem_bytes(p["chunk"], p["dc"], p["lanes"], p["npl"],
                                             p["bcp"], elem)
    assert p["smem"] <= kscan.BLOCK_SMEM
    assert 1 <= p["per_sm"] and p["per_sm"] * (p["smem"] + kscan.CTA_RESERVED_SMEM) <= kscan.SM_SMEM
    assert (p["lanes"], p["npl"]) in kscan.KERNEL_TILES and p["lanes"] * p["npl"] >= n
    assert p["dc"] * p["lanes"] == p["threads"] and p["threads"] % 32 == 0 and p["dc"] % 8 == 0
    assert p["nblk"] * p["dc"] >= d > (p["nblk"] - 1) * p["dc"]  # covers D
    assert p["n_ckpt"] * p["chunk"] >= s > (p["n_ckpt"] - 1) * p["chunk"]  # covers S
    assert p["bcp"] % 4 == 0 and p["bcp"] >= p["lanes"] * p["npl"]
    assert p["chunk"] >= min(kscan.BWD_MIN_CHUNK, s) or p["per_sm"] == 1
    assert p["parts"] == (bz * p["n_ckpt"] * d * p["lanes"] * p["npl"],
                          bz * p["nblk"] * s * 2 * n, bz * d * n, bz * d)
    return p


@pytest.mark.parametrize("layer", ["full", "scaled_down"])
def test_backward_plans_fit_and_cover_the_falcon_mamba_layers(layer):
    arch = get_arch("falcon-mamba-7b")
    cfg = arch if layer == "full" else arch.scaled_down()
    d, n = cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    for s in (1, 2, 3, 17, 64, 256, 300, 512, 1000, 2048, 4096):
        for bz in (1, 2, 3, 4, 8):
            for elem in (2, 4):
                _check_plan(bz, s, d, n, elem)
    # The training step's layer: two lanes, 16 steps a checkpoint, two
    # CTAs an SM; the workspace about a (Bz, S, D) f32 tensor and a half.
    p = kscan.scan_bwd_plan(4, 512, 8192, 16, n_sms=H100_SMS)
    assert (p["lanes"], p["npl"], p["dc"], p["chunk"], p["per_sm"]) == (2, 8, 64, 16, 2)
    assert 4 * p["workspace"] < 1.6 * 4 * 4 * 512 * 8192


@pytest.mark.parametrize("n", [17, 24, 31, 32, 33, 48, 64])
def test_backward_plans_fit_states_above_sixteen(n):
    for d in (200, 384, 8192, 8200):
        for s in (1, 5, 300, 4096):
            for bz in (1, 4, 8):
                _check_plan(bz, s, d, n, 2)


def test_backward_plan_refuses_more_states_than_the_kernel_keeps():
    with pytest.raises(ValueError, match="states a channel"):
        kscan.scan_bwd_plan(1, 8, 64, kscan.MAX_N + 1, n_sms=H100_SMS)


# ---------------------------------------------------------------------------
# the warp's channel sums of dB and dC


def _channel_sums(values, lanes: int, npl: int, bcp: int) -> list:
    """What one warp stores for one step (``ssmb_channel_sum`` in the
    source), step for step: ``values[lane]`` is lane's 2 * npl values
    (its dB terms, then its dC terms, of states lane % lanes * npl + i);
    returns the warp's row of 2 * bcp sums over its 32 / lanes channels
    (dB of state s at s, dC at bcp + s), None where no lane stores. Each
    round of lane bit m, 16 down to ``lanes``: while a lane holds more
    than one value it keeps the half its bit selects and adds its
    partner's copy of that half; then the single value is added across,
    and the lanes whose remaining bits are 0 store."""
    v = [list(map(float, x)) for x in values]
    base, writer = [0] * 32, [True] * 32
    m = 16
    while m >= lanes:
        cur = len(v[0])
        if cur > 1:
            h = cur // 2
            sent = [x[:h] if lane & m else x[h:] for lane, x in enumerate(v)]
            v = [(x[h:] if lane & m else x[:h]) for lane, x in enumerate(v)]
            v = [[a + b for a, b in zip(x, sent[lane ^ m])] for lane, x in enumerate(v)]
            base = [b + (h if lane & m else 0) for lane, b in enumerate(base)]
        else:
            v = [[x[0] + v[lane ^ m][0]] for lane, x in enumerate(v)]
            writer = [w and not lane & m for lane, w in enumerate(writer)]
        m //= 2
    row = [None] * (2 * bcp)
    for lane in range(32):
        if writer[lane]:
            j = lane % lanes
            for k, val in enumerate(v[lane]):
                i = base[lane] + k
                slot = j * npl + i if i < npl else bcp + j * npl + i - npl
                if row[slot] is not None:
                    raise AssertionError(f"slot {slot} stored twice")
                row[slot] = val
    return row


@pytest.mark.parametrize("lanes,npl", sorted(kscan.KERNEL_TILES))
def test_channel_sums_store_every_states_sum_once(lanes, npl):
    rng = np.random.default_rng(lanes * 64 + npl)
    values = rng.normal(size=(32, 2 * npl))
    bcp = -(-lanes * npl // 4) * 4
    row = _channel_sums(values.tolist(), lanes, npl, bcp)
    for j in range(lanes):
        chans = values[j::lanes]  # the lanes j of the warp's channels
        for i in range(npl):
            for slot, col in ((j * npl + i, i), (bcp + j * npl + i, npl + i)):
                assert row[slot] == pytest.approx(chans[:, col].sum(), rel=1e-12, abs=1e-12)
    stored = [k for k, v in enumerate(row) if v is not None]
    assert len(stored) == 2 * lanes * npl


# ---------------------------------------------------------------------------
# the kernel's two passes, in PyTorch


def _kernel_mirror(x, dt, b, c, a, d_skip, h0, g_y, g_h, chunk):
    """ssm_scan_bwd_kernel's arithmetic over whole (Bz, D, N) arrays:
    pass 1 writes the state before each chunk; pass 2 walks the chunks
    from the last, recomputes the chunk's states from its checkpoint and
    runs the reverse steps carrying mu = exp(dt_{t+1} A) lam_{t+1}; dA and
    dD summed over the batch rows at the end (the second kernel)."""
    x, b, c = x.float(), b.float(), c.float()
    bz, s, d = x.shape
    n = b.shape[-1]
    k_n = -(-s // chunk)
    h = torch.zeros(bz, d, n) if h0 is None else h0.clone()
    ckpt = []
    for k in range(k_n):
        ckpt.append(h)
        if k == k_n - 1:
            break
        for t in range(k * chunk, (k + 1) * chunk):
            h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None]
    gy = torch.zeros(bz, s, d) if g_y is None else g_y
    mu = torch.zeros(bz, d, n) if g_h is None else g_h.clone()
    ga, gd = torch.zeros(bz, d, n), torch.zeros(bz, d)
    dx, ddt = torch.empty(bz, s, d), torch.empty(bz, s, d)
    db, dc = torch.empty(bz, s, n), torch.empty(bz, s, n)
    for k in reversed(range(k_n)):
        t0 = k * chunk
        hs, h = [], ckpt[k]
        for t in range(t0, min(s, t0 + chunk)):
            h = torch.exp(dt[:, t, :, None] * a) * h + (dt[:, t] * x[:, t])[..., None] * b[:, t, None]
            hs.append(h)
        for u in reversed(range(len(hs))):
            t = t0 + u
            hp = hs[u - 1] if u else ckpt[k]
            lam = gy[:, t, :, None] * c[:, t, None] + mu
            da = torch.exp(dt[:, t, :, None] * a)
            w = lam * da * hp
            dx[:, t] = dt[:, t] * (lam * b[:, t, None]).sum(-1) + d_skip * gy[:, t]
            ddt[:, t] = (a * w + lam * (x[:, t, :, None] * b[:, t, None])).sum(-1)
            ga += dt[:, t, :, None] * w
            db[:, t] = (lam * (dt[:, t] * x[:, t])[..., None]).sum(1)
            dc[:, t] = (gy[:, t, :, None] * hs[u]).sum(1)
            mu = da * lam
        gd += (gy[:, t0:t0 + len(hs)] * x[:, t0:t0 + len(hs)]).sum(1)
    return dx, ddt, db, dc, ga.sum(0), gd.sum(0), None if h0 is None else mu


@pytest.mark.parametrize("chunk", [1, 4, 16, 64])
@pytest.mark.parametrize("h0,g_h", [(False, False), (True, True), (True, False)])
def test_kernel_passes_match_the_plain_gradient(chunk, h0, g_h):
    v = _inputs(2, 37, 12, 8, seed=chunk)
    args = _port(v, h0=h0, g_h=g_h)
    got = _kernel_mirror(*args, chunk=chunk)
    want = ssm_scan_bwd_ref(*args)
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w, msg=name, **F32)


# ---------------------------------------------------------------------------
# the registered op


def _op_args(h0, g_h, dtype=torch.float32):
    return _port(_inputs(2, 5, 6, 4, seed=3), dtype, h0=h0, g_h=g_h)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h0,g_h", [(False, False), (True, True)])
def test_backward_op_passes_opcheck(h0, g_h, dtype):
    torch.library.opcheck(kssm_ops.scan_bwd_op, _op_args(h0, g_h, dtype),
                          test_utils=("test_schema", "test_faketensor"))


def test_backward_op_is_one_node_charged_its_contraction(monkeypatch):
    """On ``meta`` one op of the log: 2 Bz S D N FLOPs (for
    ``FlopCounterMode`` too), its operands read and its results written
    once; on the CPU the plain version, looked up at the call, and no
    launch."""
    args = [None if t is None else t.to("meta") for t in _op_args(True, True)]
    grads, rec, counter = H.record(kssm_ops.scan_bwd_op, *args, device="meta")
    assert [i.op for i in rec.instrs] == ["repro_torch.ssm_scan_bwd.default"]
    assert [tuple(g.shape) for g in grads] == [(2, 5, 6), (2, 5, 6), (2, 5, 4), (2, 5, 4),
                                               (6, 4), (6,), (2, 6, 4)]
    assert H.analyze_hlo(rec.instrs).flops == counter == 2 * 2 * 5 * 6 * 4
    grads_io = 2 * 60 + 2 * 40 + 24 + 6 + 48  # x, dt, B, C, A, D_skip, h0 and theirs
    assert H.analyze_hlo(rec.instrs).hbm_bytes == 4 * (2 * grads_io + 60 + 48)  # and g_y, g_h
    calls = []

    def counted(*a):
        calls.append(1)
        return ssm_scan_bwd_ref(*a)

    monkeypatch.setattr(kssm_ops, "ssm_scan_bwd_ref", counted)
    before = dict(kscan.LAUNCHES)
    cpu = kssm_ops.scan_bwd_op(*_op_args(True, True))
    assert kscan.LAUNCHES == before and calls == [1]
    for got, want in zip(cpu, ssm_scan_bwd_ref(*_op_args(True, True))):
        assert torch.equal(got, want)
    _, _, no_h0 = kssm_ops.scan_bwd_op(*_op_args(False, False))[4:]
    assert tuple(no_h0.shape) == (0,)


@pytest.mark.parametrize("read_h_last", [False, True])
def test_the_scan_function_runs_the_backward_op_once(monkeypatch, read_h_last):
    calls = []
    op = kssm_ops.scan_bwd_op

    def counted(*a):
        calls.append([t is not None for t in a[6:]])
        return op(*a)

    monkeypatch.setattr(kssm_ops, "scan_bwd_op", counted)
    x, dt, b, c, a, d_skip, h0, g_y, g_h = _op_args(True, True)
    leaves = [t.clone().requires_grad_() for t in (x, dt, b, c, a, d_skip, h0)]
    y, h_last = ssm_scan(*leaves)
    loss = (y * g_y).sum() + ((h_last * g_h).sum() if read_h_last else 0.0)
    grads = torch.autograd.grad(loss, leaves)
    assert calls == [[True, True, read_h_last]]
    want = ssm_scan_bwd_ref(x, dt, b, c, a, d_skip, h0, g_y, g_h if read_h_last else None)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)


def test_the_backward_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        kscan.ssm_scan_bwd_cuda(*_op_args(True, True))


def test_falcon_mamba_train_step_logs_one_backward_op_a_layer():
    cfg = get_arch("falcon-mamba-7b").scaled_down()
    bz, s = 2, 64
    tr = D.trace_cell(cfg, ShapeConfig("t", s, bz, "train"), make_production_mesh(device="cpu"))
    bwd = [i for i in tr.instrs if i.packet == H.SCAN_BWD_OP]
    per = 2 * bz * s * cfg.ssm_expand * cfg.d_model * cfg.ssm_state
    assert len(bwd) == cfg.n_layers
    assert [H.instr_flops(i) for i in bwd] == [per] * cfg.n_layers
    assert tr.counter_flops == H.analyze_hlo(tr.instrs).flops
