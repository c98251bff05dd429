"""LM training on the card: the gradient through the selective-scan kernel
(``kernels/ssm_scan/ops.py``'s ``_ScanGrad``: the kernel's forward, the
backward kernel ``repro_torch::ssm_scan_bwd``) against autograd of the
plain composition on the card and against the CPU; the remat modes;
the chunked CE at a real vocabulary's width; µbatch accumulation.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_lm_train_card.py

This file imports no JAX: the machine with the card has none.

Tolerances: gradients through the kernel against the plain composition
(the card, TF32 off) and against the CPU: each leaf within a relative L2
error of 1e-4 (the kernel's forward and the composition sum the scan in
other orders); the gradient's plain version (``ssm_scan_bwd_ref``)
against native autograd of its composition on the same card tensors:
bit for bit (the same ops on the same inputs; the backward kernel is
held to it in ``tests/test_torch_scan_bwd_card.py``); remat modes: bit
for bit; the chunked CE against the full
``log_softmax``: rtol 1e-5, its gradients rtol 1e-4, atol 1e-7; µbatches
against one batch: losses rtol 1e-5, parameters atol 1e-5 (the
reference test's bounds).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ArchConfig  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as kssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_bwd_ref, ssm_scan_chunked_ref  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import ssm as mssm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.tree_util import tree_flatten, tree_leaves  # noqa: E402

pytestmark = pytest.mark.card

LEAF_REL_L2 = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _mamba_cfg(**kw):
    """falcon-mamba-7b cut to a width a test runs in seconds: d_inner 512,
    N 16 (the config's), 3 layers."""
    return get_arch("falcon-mamba-7b").scaled_down(n_layers=3, d_model=256, ssm_state=16,
                                                   vocab_size=1000, **kw)


def _tokens(cfg, b=2, s=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32))


def _loss_and_grads(params, cfg, tokens):
    leaves, treedef = tree_flatten(params)
    leaves = [t.detach().requires_grad_() for t in leaves]
    loss, _ = T.train_loss(treedef.unflatten(leaves), cfg, {"tokens": tokens}, vocab_chunk=384)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def _plain_scan(x, dt, b, c, a, d_skip, h0=None, **_):
    return ssm_scan_chunked_ref(x, dt, b, c, a, d_skip, h0)


def test_scan_gradient_through_the_kernel_matches_the_plain_composition(card, monkeypatch):
    """A falcon-mamba training loss: its gradients through the kernels (one
    forward and one backward launch a layer; the plain scan and its
    gradient never called) against autograd of the plain composition on
    the card and against the CPU; every leaf finite and nonzero."""
    cfg = _mamba_cfg()
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=card)
    toks = _tokens(cfg)
    plain = [0]
    dispatch_plain = kssm_ops.ssm_scan_ref

    def counted(*args):
        plain[0] += 1
        return dispatch_plain(*args)

    monkeypatch.setattr(kssm_ops, "ssm_scan_ref", counted)
    monkeypatch.setattr(kssm_ops, "ssm_scan_bwd_ref", counted)
    kscan.reset_launch_counts()
    loss, grads = _loss_and_grads(params, cfg, toks.to(card))
    torch.cuda.synchronize()
    assert kscan.LAUNCHES == {"ssm_scan": cfg.n_layers, "ssm_scan_bwd": cfg.n_layers}
    assert plain[0] == 0
    monkeypatch.setattr(mssm, "ssm_scan", _plain_scan)
    want_loss, want = _loss_and_grads(params, cfg, toks.to(card))
    cpu_loss, cpu_grads = _loss_and_grads(cpu, cfg, toks)
    assert kscan.LAUNCHES["ssm_scan"] == cfg.n_layers
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(cpu_loss), rtol=1e-5)
    for g, w, c in zip(grads, want, cpu_grads):
        assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
        assert _rel(g, w) <= LEAF_REL_L2 and _rel(g, c) <= LEAF_REL_L2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
def test_scan_function_on_the_card_equals_native_autograd(card, dtype, with_h0):
    """``ssm_scan`` on card tensors with grad on (the kernel's forward)
    against native autograd of its composition: the forwards within a
    relative L2 error of 1e-5 (states of unit-normal B and C grow large
    here, so a few elements sit past the kernel gate's atol); the
    gradient's plain version, ``ssm_scan_bwd_ref``, on the same card
    tensors: native autograd's gradients bit for bit, bf16 x, B and C
    getting bf16 ones (the backward kernel that ``ssm_scan`` runs is held
    to it in ``tests/test_torch_scan_bwd_card.py``)."""
    g = torch.Generator().manual_seed(3)
    bz, s, d, n = 2, 300, 384, 16
    x = torch.randn(bz, s, d, generator=g).to(card, dtype)
    dt = (torch.rand(bz, s, d, generator=g) * 0.5).to(card)
    b = torch.randn(bz, s, n, generator=g).to(card, dtype)
    c = torch.randn(bz, s, n, generator=g).to(card, dtype)
    a = -torch.rand(d, n, generator=g).to(card)
    d_skip = torch.randn(d, generator=g).to(card)
    h0 = torch.randn(bz, d, n, generator=g).to(card) if with_h0 else None
    w_y = torch.randn(bz, s, d, generator=g).to(card)
    inputs = [x, dt, b, c, a, d_skip, h0]
    out = []
    for fn in (ssm_scan, ssm_scan_chunked_ref):
        leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
        y, _ = fn(*leaves)
        out.append((y.detach(), torch.autograd.grad((y * w_y).sum(),
                                                    [t for t in leaves if t is not None])))
    assert _rel(out[0][0], out[1][0]) <= 1e-5
    plain = [g for g in ssm_scan_bwd_ref(*inputs, w_y, None) if g is not None]
    assert len(plain) == len(out[1][1])
    for got, want in zip(plain, out[1][1]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert plain[0].dtype == out[0][1][0].dtype == dtype


def test_remat_modes_are_bit_equal_on_the_card(card):
    """"none", "full" and "dots" on the card: the same loss and gradients
    bit for bit; the scan launches once a layer a step, twice under
    "full" and "dots" (the forward and its recompute), its backward once
    under every mode."""
    cfg = _mamba_cfg(remat="none")
    params = T.init_params(torch.Generator().manual_seed(1), cfg, device=card)
    toks = _tokens(cfg, seed=1).to(card)
    results = {}
    for remat, per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        kscan.reset_launch_counts()
        results[remat] = _loss_and_grads(params, dataclasses.replace(cfg, remat=remat), toks)
        torch.cuda.synchronize()
        assert kscan.LAUNCHES["ssm_scan"] == per_layer * cfg.n_layers, remat
        assert kscan.LAUNCHES["ssm_scan_bwd"] == cfg.n_layers, remat
    for remat in ("full", "dots"):
        assert torch.equal(results[remat][0], results["none"][0])
        assert all(torch.equal(a, b) for a, b in zip(results[remat][1], results["none"][1]))


@pytest.mark.parametrize("remat_chunks", [False, True])
def test_chunked_ce_at_qwens_vocab_is_the_full_log_softmax(card, remat_chunks):
    """151,936 columns (qwen2.5, qwen3-moe) in chunks of 8,192: the last
    chunk holds 4,480 columns and 3,712 of padding. The loss and its
    gradients against F.cross_entropy over the full f32 logits."""
    g = torch.Generator().manual_seed(4)
    v = 151_936
    h = torch.randn(2, 48, 64, generator=g).to(card).requires_grad_()
    w = (torch.randn(64, v, generator=g) * 0.3).to(card).requires_grad_()
    t = torch.randint(0, v, (2, 48), generator=g)
    t[0, :8] = torch.arange(v - 8, v)  # targets in the padded last chunk
    t = t.to(card)
    loss = T.chunked_softmax_ce(h, w, t, vocab_chunk=8192, remat_chunks=remat_chunks)
    got = torch.autograd.grad(loss, [h, w])
    full = torch.nn.functional.cross_entropy((h @ w).reshape(-1, v), t.long().reshape(-1))
    want = torch.autograd.grad(full, [h, w])
    np.testing.assert_allclose(float(loss.detach()), float(full.detach()), rtol=1e-5)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-7)


def test_microbatches_equal_one_batch_on_the_card(card):
    """The reference's test_mb_equals_single_batch on the card."""
    cfg = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab_size=128, dtype="float32", remat="none")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=card)
    toks = _tokens(cfg, b=8, s=16).to(card)
    out = {}
    for mb in (1, 4):
        opt = adamw_init(params, AdamWConfig())
        out[mb] = make_train_step(cfg, microbatches=mb)(params, opt, {"tokens": toks})
    np.testing.assert_allclose(float(out[4][2]["loss"]), float(out[1][2]["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(out[1][0]), tree_leaves(out[4][0])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
