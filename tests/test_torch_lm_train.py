"""LM training in the port on the CPU, held against the reference: the
training loss and its gradients for all ten architectures at
``scaled_down()`` against ``jax.grad`` of the reference's ``train_loss``
on the same numpy parameters (``convert.lm_params_from_numpy``) and
batches, and the prefix slice and untied head of the loss. The other
pieces of LM training (``chunked_softmax_ce``, remat, the scan's autograd
Function, ``opt_bf16_ssm``) are in ``test_torch_lm_train_parts.py``.

MoE configs run drop-free (``capacity_factor=8.0``, as
``test_archs.py::_reduced``), where the reference is right.

Tolerances:
- the loss: rtol 1e-5 (a mean of f32 terms summed in another order);
- gradient leaves: per element rtol 1e-4, atol 1e-5 (the reference
  tests' fp32 tolerance), except falcon-mamba-7b and recurrentgemma-9b,
  where the recurrence is summed in another order (the port's forward
  scan is a step loop; XLA may contract the associative scan's
  multiply-adds): each leaf within a relative L2 error of 1e-4;
- the loss against the full forward's CE: rtol 1e-6.
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

from repro import configs as jconfigs  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.tree_util import tree_flatten  # noqa: E402

LOSS_RTOL = 1e-5
LEAF = dict(rtol=1e-4, atol=1e-5)
LEAF_REL_L2 = 1e-4
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-9b")
CHUNK = 64
_PERTURBED = ("scale", "b", "conv_b", "d_skip")


def _cfgs(name, **overrides):
    j = jconfigs.get_arch(name).scaled_down(**overrides)
    t = tconfigs.get_arch(name).scaled_down(**overrides)
    if j.n_experts:
        j = dataclasses.replace(j, capacity_factor=8.0)
        t = dataclasses.replace(t, capacity_factor=8.0)
    return j, t


def _perturb(tree, rng):
    """Draw the leaves the reference starts at constants (norm scales,
    biases, the skip) so that their gradients are not degenerate."""
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng) if isinstance(v, (dict, list)) or v is None
                    else (v + (rng.normal(size=v.shape) * 0.1).astype(v.dtype)
                          if k in _PERTURBED else v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


def _params(jcfg, seed=0):
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(seed), jcfg))
    return _perturb(jp, np.random.default_rng(seed))


def _batch(cfg, b=2, s=16, seed=1) -> dict:
    """Tokens (b, s + 1) and the VLM / enc-dec inputs (x 0.1, as
    test_archs.py draws them), numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["prefix_embeds"] = (rng.normal(size=(b, cfg.n_prefix_tokens, cfg.d_model))
                                  * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        batch["encoder_frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                                   * 0.1).astype(np.float32)
    return batch


def _port_loss_and_grads(tcfg, np_params, batch, vocab_chunk=CHUNK):
    leaves, treedef = tree_flatten(lm_params_from_numpy(np_params, device="cpu"))
    leaves = [t.requires_grad_() for t in leaves]
    loss, metrics = tT.train_loss(treedef.unflatten(leaves), tcfg,
                                  {k: torch.from_numpy(v) for k, v in batch.items()},
                                  vocab_chunk=vocab_chunk)
    return loss, metrics, torch.autograd.grad(loss, leaves)


def _rel_l2(got, want) -> float:
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# train_loss and its gradients, all ten architectures


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_train_loss_and_gradients_match_jax_grad(name):
    jcfg, tcfg = _cfgs(name)
    jp, batch = _params(jcfg), _batch(jcfg)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bt: jT.train_loss(p, jcfg, bt, vocab_chunk=CHUNK)[0]))
    want_loss, want = grad_fn(jax.tree_util.tree_map(jnp.asarray, jp),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = _port_loss_and_grads(tcfg, jp, batch)
    loss = loss.detach()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_RTOL)
    assert float(metrics["ce"].detach() + 0.01 * metrics["aux"].detach()) == pytest.approx(float(loss))
    want = [np.asarray(w) for w in jax.tree_util.tree_leaves(want)]
    assert len(grads) == len(want)
    for g, w in zip(grads, want):
        got = g.numpy()
        assert got.shape == w.shape and np.isfinite(got).all()
        if name in RECURRENT:
            assert _rel_l2(got, w) <= LEAF_REL_L2
        else:
            np.testing.assert_allclose(got, w, **LEAF)


def test_train_loss_slices_prefix_positions_and_uses_the_untied_head():
    """internvl2-2b: the loss reads the token positions only (the 8
    prefix positions sliced off) through ``lm_head``: equal to the full
    forward's CE over those rows."""
    jcfg, tcfg = _cfgs("internvl2-2b")
    assert not tcfg.tie_embeddings and tcfg.n_prefix_tokens
    batch = _batch(jcfg)
    tp = lm_params_from_numpy(_params(jcfg), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = tT.train_loss(tp, tcfg, tb, vocab_chunk=CHUNK)
    h, _, aux = tT.forward_hidden(tp, tcfg, tb["tokens"][:, :-1],
                                  prefix_embeds=tb["prefix_embeds"])
    logits = tT.unembed(tp, tcfg, h[:, tcfg.n_prefix_tokens:])
    ce = torch.nn.functional.cross_entropy(logits.reshape(-1, tcfg.vocab_size),
                                           tb["tokens"][:, 1:].long().reshape(-1))
    np.testing.assert_allclose(float(metrics["ce"]), float(ce), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(ce + 0.01 * aux), rtol=1e-6)
