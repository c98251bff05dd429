"""The pieces of LM training on the CPU (the loss and gradients of the
ten architectures are in ``test_torch_lm_train.py``):

- ``chunked_softmax_ce`` against the reference's (and its gradients, at
  rtol 1e-6 / per element rtol 1e-4, atol 1e-5) where the chunk divides
  the vocab, and against the full ``log_softmax`` CE where it does not:
  the reference is off there (``ROADMAP.md`` Queue 3), pinned here;
- ``cfg.remat`` "none", "full" and "dots": the same loss and gradients
  bit for bit for all ten architectures at ``scaled_down()`` (on the
  reference's numpy weights); "full" recomputes the scan;
- ``ssm_scan`` with grad on (its forward the dispatch, its backward the
  reference's composition recomputed) against native autograd of that
  composition, ``kernels/ssm_scan/ref.py``'s ``ssm_scan_chunked_ref``:
  bit for bit;
- ``opt_bf16_ssm`` within the reference test's 2 % of the f32 loss.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as kssm_ops  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan  # noqa: E402
from repro_torch.kernels.ssm_scan.ref import ssm_scan_chunked_ref  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from test_torch_lm_train import CHUNK, LEAF, _batch, _cfgs, _params, _port_loss_and_grads  # noqa: E402


# ---------------------------------------------------------------------------
# remat


def _remat_run(tcfg, np_params, batch):
    loss, _, grads = _port_loss_and_grads(tcfg, np_params, batch)
    return loss.detach(), grads


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_remat_modes_give_bit_equal_gradients(name, monkeypatch):
    """``remat`` "none", "full" and "dots": the same loss and gradients,
    bit for bit. "full" recomputes each unit's forward in the backward;
    "dots" saves the outputs of the matmuls without a batch dimension
    (counted here) and recomputes the rest."""
    jcfg, tcfg = _cfgs(name)
    jp, batch = _params(jcfg, seed=2), _batch(jcfg, seed=3)
    want_loss, want = _remat_run(tcfg, jp, batch)
    decisions = []
    save_dots = tT._save_dots

    def counted(ctx, op, *args, **kwargs):
        decisions.append(save_dots(ctx, op, *args, **kwargs))
        return decisions[-1]

    monkeypatch.setattr(tT, "_save_dots", counted)
    for remat in ("full", "dots"):
        loss, grads = _remat_run(dataclasses.replace(tcfg, remat=remat), jp, batch)
        assert torch.equal(loss, want_loss), remat
        assert all(torch.equal(g, w) for g, w in zip(grads, want)), remat
    from torch.utils.checkpoint import CheckpointPolicy

    assert CheckpointPolicy.MUST_SAVE in decisions
    assert CheckpointPolicy.PREFER_RECOMPUTE in decisions


def test_remat_runs_the_scan_twice_a_layer(monkeypatch):
    """falcon-mamba: each layer's scan runs once a training step without
    remat, twice under "full" and "dots" (the forward and its recompute:
    no matmul makes it); the backward itself runs the composition, not
    the dispatch; without grad, once."""
    jcfg, tcfg = _cfgs("falcon-mamba-7b", n_layers=3)
    jp, batch = _params(jcfg), _batch(jcfg)
    calls = [0]
    plain = kssm_ops.ssm_scan_ref

    def counted(*args):
        calls[0] += 1
        return plain(*args)

    monkeypatch.setattr(kssm_ops, "ssm_scan_ref", counted)
    for remat, per_layer in (("none", 1), ("full", 2), ("dots", 2)):
        calls[0] = 0
        _remat_run(dataclasses.replace(tcfg, remat=remat), jp, batch)
        assert calls[0] == per_layer * tcfg.n_layers, (remat, calls[0])
    calls[0] = 0
    with torch.no_grad():
        tT.train_loss(lm_params_from_numpy(jp, device="cpu"), tcfg,
                      {k: torch.from_numpy(v) for k, v in batch.items()}, vocab_chunk=CHUNK)
    assert calls[0] == tcfg.n_layers


# ---------------------------------------------------------------------------
# the scan's autograd Function


def _scan_inputs(dtype, seed=5, bz=2, s=37, d=12, n=4):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(bz, s, d)).astype(np.float32)).to(dtype)
    dt = torch.from_numpy((rng.random((bz, s, d)) * 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(bz, s, n)).astype(np.float32)).to(dtype)
    c = torch.from_numpy(rng.normal(size=(bz, s, n)).astype(np.float32)).to(dtype)
    a = torch.from_numpy(-rng.random((d, n)).astype(np.float32))
    d_skip = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32))
    h0 = torch.from_numpy(rng.normal(size=(bz, d, n)).astype(np.float32))
    w_y = torch.from_numpy(rng.normal(size=(bz, s, d)).astype(np.float32))
    w_h = torch.from_numpy(rng.normal(size=(bz, d, n)).astype(np.float32))
    return [x, dt, b, c, a, d_skip, h0], w_y, w_h


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("read_h_last", [False, True])
def test_scan_function_gradients_equal_native_autograd_bit_for_bit(dtype, with_h0, read_h_last):
    """``ssm_scan`` with grad on (the step loop forward, the composition's
    recomputed backward) against autograd of ``ssm_scan_chunked_ref``
    itself: the same gradients, bit for bit, for every input; bf16 x, B
    and C get bf16 gradients; an unread ``h_last`` contributes nothing."""
    inputs, w_y, w_h = _scan_inputs(dtype)
    if not with_h0:
        inputs[6] = None
    results = []
    for fn in (ssm_scan, ssm_scan_chunked_ref):
        leaves = [None if t is None else t.clone().requires_grad_() for t in inputs]
        y, h_last = fn(*leaves)
        loss = (y * w_y).sum() + ((h_last * w_h).sum() if read_h_last else 0.0)
        results.append(torch.autograd.grad(loss, [t for t in leaves if t is not None]))
    assert y.grad_fn is not None
    for got, want in zip(*results):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)
    assert [g.dtype for g in results[0][:4]] == [dtype, torch.float32, dtype, dtype]


def test_scan_without_grad_is_the_bare_dispatch():
    inputs, _, _ = _scan_inputs(torch.float32)
    leaves = [t.clone().requires_grad_() for t in inputs]
    with torch.no_grad():
        y, h_last = ssm_scan(*leaves)
    assert y.grad_fn is None and h_last.grad_fn is None
    y2, _ = ssm_scan(*inputs[:6])  # no input requires grad
    assert y2.grad_fn is None
    assert torch.equal(y, kssm_ops.ssm_scan_ref(*inputs)[0])


# ---------------------------------------------------------------------------
# chunked_softmax_ce


def _ce_inputs(v, seed=3):
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(2, 7, 16)).astype(np.float32)
    w = (rng.normal(size=(16, v)) * 0.5).astype(np.float32)
    t = rng.integers(0, v, (2, 7)).astype(np.int32)
    return h, w, t


def _port_ce(h, w, t, **kw):
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss = tT.chunked_softmax_ce(th, tw, torch.from_numpy(t), **kw)
    return float(loss.detach()), [g.numpy() for g in torch.autograd.grad(loss, [th, tw])]


def _ref_ce(h, w, t, **kw):
    loss, grads = jax.value_and_grad(
        lambda a, b: jT.chunked_softmax_ce(a, b, jnp.asarray(t), **kw), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(w))
    return float(loss), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_ce_matches_reference_where_the_chunk_divides_the_vocab(remat):
    h, w, t = _ce_inputs(256)
    loss, grads = _port_ce(h, w, t, vocab_chunk=CHUNK, remat_chunks=remat)
    want_loss, want = _ref_ce(h, w, t, vocab_chunk=CHUNK, remat_chunks=remat)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for g, w_ in zip(grads, want):
        np.testing.assert_allclose(g, w_, **LEAF)


@pytest.mark.parametrize("remat", [False, True])
def test_chunked_ce_with_a_padded_last_chunk_is_the_full_softmax_ce(remat):
    """V = 100 in chunks of 64: the last chunk's 28 padding columns are
    masked. The port equals the full-vocab CE (and the reference's one
    chunk of 100, gradients too). The reference's own chunks of 64 slice
    the last chunk with ``dynamic_slice``, which clamps it to columns
    36..99 under the labels 64..127, so its loss is off (pinned here; the
    port does not keep it)."""
    v = 100
    h, w, t = _ce_inputs(v)
    loss, grads = _port_ce(h, w, t, vocab_chunk=CHUNK, remat_chunks=remat)
    logits = torch.from_numpy(h) @ torch.from_numpy(w)
    full = float(torch.nn.functional.cross_entropy(logits.reshape(-1, v),
                                                   torch.from_numpy(t).long().reshape(-1)))
    np.testing.assert_allclose(loss, full, rtol=1e-6)
    want_loss, want = _ref_ce(h, w, t, vocab_chunk=v)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    for g, w_ in zip(grads, want):
        np.testing.assert_allclose(g, w_, **LEAF)
    clamped, _ = _ref_ce(h, w, t, vocab_chunk=CHUNK)
    assert abs(clamped - full) > 1e-2 * full


# ---------------------------------------------------------------------------
# opt_bf16_ssm


def test_opt_bf16_ssm_within_the_references_two_percent():
    """The reference's flag rounds its discretized SSM tensors to bf16; the
    port's fused scan never forms them and runs the f32 scan: its loss
    under the flag is its f32 loss, within 2 % of the reference's loss
    under the flag (the reference test's bound)."""
    jcfg, tcfg = _cfgs("falcon-mamba-7b", n_layers=2)
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(0), jcfg))
    batch = _batch(jcfg, s=32, seed=0)
    j_bf16 = dataclasses.replace(jcfg, opt_bf16_ssm=True)
    want, _ = jT.train_loss(jp, j_bf16, {"tokens": jnp.asarray(batch["tokens"])}, vocab_chunk=64)
    tp = lm_params_from_numpy(jp, device="cpu")
    tb = {"tokens": torch.from_numpy(batch["tokens"])}
    got, _ = tT.train_loss(tp, dataclasses.replace(tcfg, opt_bf16_ssm=True), tb, vocab_chunk=64)
    f32, _ = tT.train_loss(tp, tcfg, tb, vocab_chunk=64)
    assert torch.equal(got, f32)
    assert np.isfinite(float(got))
    assert abs(float(got) - float(want)) / float(want) < 0.02
