"""The selective scan's backward kernel on the card
(``csrc/ssm_scan_bwd.cu`` through ``kernels/ssm_scan/scan.py``
``ssm_scan_bwd_cuda`` and the registered op ``repro_torch::ssm_scan_bwd``)
against its plain version, ``ref.ssm_scan_bwd_ref`` (autograd of the
reference's composition), on the same card tensors.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_scan_bwd_card.py

This file imports no JAX: the machine with the card has none.

Tolerance: each gradient leaf within a relative L2 error of 1e-4 (the
gate the forward kernel's gradient is held to in phase 5j: the kernel
sums the recurrence in another order than the composition's associative
scan; a bf16 leaf rounds an f32 gradient that differs in its last bits);
two calls bit for bit (no atomics: the sums run in a fixed order).
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import torch.nn.functional as F  # noqa: E402

from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as kssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_chunked_ref  # noqa: E402
from repro_torch.launch import hlo_analysis as H  # noqa: E402

pytestmark = pytest.mark.card

LEAF_REL_L2 = 1e-4
NAMES = ("dx", "ddt", "dB", "dC", "dA", "dD", "dh0")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _inputs(dev, bz, s, d, n, dtype, h0, g_h, seed=0, strided=False):
    """Inputs in the mixer's ranges; with ``strided`` B and C are slices of
    one (Bz, S, 2N + 3) projection, as ``mamba_apply`` passes them."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    x = (r(bz, s, d) * 0.5).to(dev, dtype)
    dt = F.softplus(r(bz, s, d) - 1.0).to(dev)
    if strided:
        proj = r(bz, s, 2 * n + 3).to(dev, dtype)
        b, c = proj[..., 3:3 + n], proj[..., 3 + n:]
    else:
        b, c = r(bz, s, n).to(dev, dtype), r(bz, s, n).to(dev, dtype)
    a = -torch.exp(r(d, n) * 0.3).to(dev)
    return (x, dt, b, c, a, r(d).to(dev), r(bz, d, n).to(dev) if h0 else None,
            r(bz, s, d).to(dev), r(bz, d, n).to(dev) if g_h else None)


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _hold(got, want):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, name
            continue
        assert g.dtype == w.dtype and g.shape == w.shape and g.is_contiguous(), name
        assert bool(torch.isfinite(g).all()), name
        assert _rel(g, w) <= LEAF_REL_L2, (name, _rel(g, w))


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("h0,g_h", [(False, False), (True, True), (True, False), (False, True)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_the_plain_gradient_at_ragged_d_and_s(card, dtype, h0, g_h, n):
    """D 200 and S 300: no CTA's channels and no checkpoint's steps divide
    them. One launch a call, logged with its shared memory; two calls
    bit for bit."""
    args = _inputs(card, 2, 300, 200, n, dtype, h0, g_h, seed=n)
    before = kscan.LAUNCHES["ssm_scan_bwd"]
    with probe.recording() as log:
        got = kscan.ssm_scan_bwd_cuda(*args)
    again = kscan.ssm_scan_bwd_cuda(*args)
    torch.cuda.synchronize()
    assert kscan.LAUNCHES["ssm_scan_bwd"] - before == 2
    plan = kscan.scan_bwd_plan(2, 300, 200, n, n_sms=kscan.sm_count(card),
                               elem_bytes=args[0].element_size())
    assert [(name, smem) for _, name, smem in log.launches] == [("ssm_scan_bwd", plan["smem"])]
    _hold(got, ssm_scan_bwd_ref(*args))
    for g, a in zip(got, again):
        assert (g is None and a is None) or torch.equal(g, a)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_the_plain_gradient_at_falcon_mambas_layer(card, dtype):
    """The training step's layer: Bz 4, S 512, D 8192, N 16, B and C
    strided slices of one projection, h_last unread."""
    args = _inputs(card, 4, 512, 8192, 16, dtype, False, False, seed=1, strided=True)
    got = kscan.ssm_scan_bwd_cuda(*args)
    again = kscan.ssm_scan_bwd_cuda(*args)
    want = ssm_scan_bwd_ref(*args)
    torch.cuda.synchronize()
    _hold(got, want)
    assert all(torch.equal(g, a) for g, a in zip(got[:6], again[:6]))


@pytest.mark.parametrize("n", [1, 8, 64, 512])
def test_kernel_takes_every_state_count_the_forward_takes(card, n):
    args = _inputs(card, 2, 45, 72, n, torch.float32, True, True, seed=n)
    _hold(kscan.ssm_scan_bwd_cuda(*args), ssm_scan_bwd_ref(*args))


def test_the_op_on_cuda_launches_the_kernel_and_never_the_plain_version(card, monkeypatch):
    calls = []

    def counted(*a):
        calls.append(1)
        return ssm_scan_bwd_ref(*a)

    monkeypatch.setattr(kssm_ops, "ssm_scan_bwd_ref", counted)
    args = _inputs(card, 2, 64, 256, 16, torch.bfloat16, False, False)
    before = kscan.LAUNCHES["ssm_scan_bwd"]
    grads, rec, counter = H.record(kssm_ops.scan_bwd_op, *args, device=card)
    torch.cuda.synchronize()
    assert kscan.LAUNCHES["ssm_scan_bwd"] == before + 1 and calls == []
    assert [i.op for i in rec.instrs] == ["repro_torch.ssm_scan_bwd.default"]
    assert counter == H.analyze_hlo(rec.instrs).flops == 2 * 2 * 64 * 256 * 16
    assert tuple(grads[6].shape) == (0,)
    _hold(grads[:6], ssm_scan_bwd_ref(*args)[:6])


@pytest.mark.parametrize("read_h_last", [False, True])
def test_the_scan_function_runs_the_kernel_once_against_native_autograd(card, read_h_last):
    """``ssm_scan`` with grad on card tensors: the forward kernel, then one
    backward launch; its gradients against native autograd of the
    composition within the leaf tolerance."""
    x, dt, b, c, a, d_skip, h0, w_y, w_h = _inputs(card, 2, 300, 384, 16, torch.bfloat16,
                                                   True, True, seed=5)
    out = []
    for fn in (ssm_scan, ssm_scan_chunked_ref):
        leaves = [t.clone().requires_grad_() for t in (x, dt, b, c, a, d_skip, h0)]
        before = dict(kscan.LAUNCHES)
        y, h_last = fn(*leaves)
        loss = (y * w_y).sum() + ((h_last * w_h).sum() if read_h_last else 0.0)
        out.append(torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        launched = {k: kscan.LAUNCHES[k] - v for k, v in before.items()}
        assert launched == ({"ssm_scan": 1, "ssm_scan_bwd": 1} if fn is ssm_scan
                            else {"ssm_scan": 0, "ssm_scan_bwd": 0})
    _hold(*out)
