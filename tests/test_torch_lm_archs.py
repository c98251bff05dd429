"""The nine attention, RG-LRU, MoE, encoder-decoder and VLM architectures
of the port at ``scaled_down()`` on the CPU, held against the reference
on the same numpy inputs and the same reference-initialised weights
(carried across bit for bit with ``convert.lm_params_from_numpy``).

Adapted from ``tests/test_archs.py`` (``test_forward_shapes``,
``test_decode_matches_forward``, ``test_scan_vs_unscanned_equivalence``)
and ``tests/test_optimizations.py`` (the attention flags, through the
forward). MoE configs run drop-free (``capacity_factor=8.0``, as
``test_archs.py::_reduced``) and prompts stay within the local window,
where the reference is right (the two cases where it is not are pinned
in ``test_torch_attention.py``).

Tolerances: f32 at rtol 1e-4, atol 1e-5 (sums taken in another order).
bf16 by the relative L2 error of the logits against the exact answer
(the reference's f32 forward on the same bf16 weights): the port's must
be within ``BF16_REL`` of it, or no further from it than
``BF16_OVER_REF`` times the reference's own bf16 logits are. Both
packages round bf16 activations at different places, so each lands
about 1 % from the exact answer, and for RG-LRU and MoE stacks the
reference's own bf16 logits sit 1.5-2.2 % from it (``python
tests/test_torch_lm_archs.py`` prints both distances over three seeds
for every architecture); on the two rows of a prefill or decode step
the port's distance over the reference's reached 1.62 in six seeds of
qwen3-moe, llama4 and recurrentgemma. The port's prefill and decode against its own
full forward at the reference test's tolerance (atol 2e-2, rtol 1e-2).
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
from repro.models import accounting as jacc  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import accounting as tacc  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=2e-2)
BF16_REL = 1e-2
BF16_OVER_REF = 2.0
ARCHS = [n for n in jbase.ARCH_IDS if n != "falcon-mamba-7b"]
# Leaves the reference starts at constants (norm scales, biases), drawn
# here so that the comparison sees them.
_PERTURBED = ("scale", "b", "conv_b", "d_skip")


def _cfgs(name, **overrides):
    j = jconfigs.get_arch(name).scaled_down(**overrides)
    t = tconfigs.get_arch(name).scaled_down(**overrides)
    if j.n_experts and "capacity_factor" not in overrides:
        # Drop-free routing, as test_archs.py::_reduced.
        j = dataclasses.replace(j, capacity_factor=8.0)
        t = dataclasses.replace(t, capacity_factor=8.0)
    return j, t


def _perturb(tree, rng):
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
    jp = _perturb(jp, np.random.default_rng(seed))
    return jp, lm_params_from_numpy(jp, device="cpu")


def _inputs(cfg, b, s, seed):
    """Tokens (b, s) and the VLM / enc-dec inputs, drawn with numpy: the
    prefix embeddings and encoder frames x 0.1, as test_archs.py draws
    them."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = (rng.normal(size=(b, cfg.n_prefix_tokens, cfg.d_model))
                               * 0.1).astype(np.float32)
    if cfg.family == "encdec":
        kw["encoder_frames"] = (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model))
                                * 0.1).astype(np.float32)
    return toks, kw


def _t(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _np(t):
    return t.float().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


def _f32(jcfg, jp):
    """The reference's config and weights in float32 (the bf16 values,
    exactly): the exact answer a bf16 run is held to."""
    return (dataclasses.replace(jcfg, dtype="float32"),
            jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp))


def _bf16_distances(got, ref_bf16, exact):
    """(the port's, the reference's) relative L2 distance from the exact
    logits."""
    exact = np.asarray(exact, np.float32)
    return _rel(got, exact), _rel(torch.from_numpy(np.asarray(ref_bf16, np.float32)), exact)


def _assert_bf16_close(got, ref_bf16, exact):
    port, ref = _bf16_distances(got, ref_bf16, exact)
    assert port < max(BF16_REL, BF16_OVER_REF * ref), (port, ref)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_reference_f32(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    b, s = 2, 16
    toks, kw = _inputs(jcfg, b, s, seed=1)
    h_ref, _, aux_ref = jT.forward_hidden(jp, jcfg, toks, **kw)
    h, _, aux = tT.forward_hidden(tp, tcfg, torch.from_numpy(toks).long(), **_t(kw))
    p = jcfg.n_prefix_tokens if jcfg.family == "vlm" else 0
    assert tuple(h.shape) == (b, s + p, jcfg.d_model)
    np.testing.assert_allclose(_np(h), np.asarray(h_ref), **F32)
    np.testing.assert_allclose(float(aux), float(aux_ref), **F32)
    logits = tT.unembed(tp, tcfg, h)
    assert tuple(logits.shape) == (b, s + p, jcfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    np.testing.assert_allclose(_np(logits), np.asarray(jT.unembed(jp, jcfg, h_ref)), **F32)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_reference_f32(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg)
    b, s = 2, 12
    toks, kw = _inputs(jcfg, b, s, seed=2)
    tt, tkw = torch.from_numpy(toks).long(), _t(kw)
    p = jcfg.n_prefix_tokens if jcfg.family == "vlm" else 0
    max_len = s + p + 4
    h, _, _ = tT.forward_hidden(tp, tcfg, tt, **tkw)
    full = tT.unembed(tp, tcfg, h)

    lp_ref, cache_ref = jT.prefill(jp, jcfg, toks[:, : s - 1], max_len=max_len, **kw)
    lp, cache = tT.prefill(tp, tcfg, tt[:, : s - 1], max_len=max_len, **tkw)
    np.testing.assert_allclose(_np(lp), np.asarray(lp_ref), **F32)
    np.testing.assert_allclose(_np(lp), _np(full[:, p + s - 2]), **F32)
    ld_ref, new_ref = jT.decode_step(jp, jcfg, toks[:, s - 1:], cache_ref, jnp.asarray(p + s - 1))
    ld, new = tT.decode_step(tp, tcfg, tt[:, s - 1:], cache, p + s - 1)
    np.testing.assert_allclose(_np(ld), np.asarray(ld_ref), **F32)
    np.testing.assert_allclose(_np(ld), _np(full[:, p + s - 1]), **F32)

    # The caches: the reference's tree, leaf for leaf.
    want = jax.tree_util.tree_leaves(new_ref)
    got = jax.tree_util.tree_leaves(new, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == w.dtype.name
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float32), **F32)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_in_bf16(name):
    """The reference test's bf16 case on the port (prefill and decode
    reproduce its own full forward at atol 2e-2, rtol 1e-2), and the
    port's bf16 forward, prefill and decode logits held to the exact
    answer as closely as the reference's bf16 logits are."""
    jcfg, tcfg = _cfgs(name, dtype="bfloat16")
    jp, tp = _params(jcfg, seed=3)
    j32, jp32 = _f32(jcfg, jp)
    b, s = 2, 12
    toks, kw = _inputs(jcfg, b, s, seed=4)
    tt, tkw = torch.from_numpy(toks).long(), _t(kw)
    p = jcfg.n_prefix_tokens if jcfg.family == "vlm" else 0
    max_len = s + p + 4
    h, _, _ = tT.forward_hidden(tp, tcfg, tt, **tkw)
    full = tT.unembed(tp, tcfg, h)
    assert full.dtype == torch.bfloat16
    h_ref, _, _ = jT.forward_hidden(jp, jcfg, toks, **kw)
    h_32, _, _ = jT.forward_hidden(jp32, j32, toks, **kw)
    _assert_bf16_close(full, jT.unembed(jp, jcfg, h_ref), jT.unembed(jp32, j32, h_32))

    lp, cache = tT.prefill(tp, tcfg, tt[:, : s - 1], max_len=max_len, **tkw)
    ld, _ = tT.decode_step(tp, tcfg, tt[:, s - 1:], cache, p + s - 1)
    np.testing.assert_allclose(_np(lp), _np(full[:, p + s - 2]), **BF16)
    np.testing.assert_allclose(_np(ld), _np(full[:, p + s - 1]), **BF16)
    for cfg_, p_ in ((jcfg, jp), (j32, jp32)):
        lp_r, c_r = jT.prefill(p_, cfg_, toks[:, : s - 1], max_len=max_len, **kw)
        ld_r, _ = jT.decode_step(p_, cfg_, toks[:, s - 1:], c_r, jnp.asarray(p + s - 1))
        if cfg_ is jcfg:
            lp_ref, ld_ref = lp_r, ld_r
    _assert_bf16_close(lp, lp_ref, lp_r)
    _assert_bf16_close(ld, ld_ref, ld_r)


@pytest.mark.parametrize("name", ARCHS)
def test_init_params_has_the_reference_tree(name):
    for scan_layers in (True, False):
        jcfg, tcfg = _cfgs(name, scan_layers=scan_layers, dtype="bfloat16")
        ref = jax.eval_shape(lambda k, c=jcfg: jT.init_params(k, c), jax.random.PRNGKey(0))
        got = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        want = jax.tree_util.tree_map(lambda a: (tuple(a.shape), str(a.dtype)), ref)
        have = jax.tree_util.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got,
            is_leaf=lambda t: isinstance(t, torch.Tensor))
        assert have == want


@pytest.mark.parametrize("name", ARCHS)
def test_scan_vs_unscanned_equivalence(name):
    """The stacked (scanned) layout and the same stack layer by layer give
    one forward, in both packages (test_archs.py's granite case, for each
    architecture)."""
    jcfg, tcfg = _cfgs(name)
    n = 2 * len(jcfg.block_pattern)
    jcfg, tcfg = (dataclasses.replace(c, n_layers=n) for c in (jcfg, tcfg))
    jp, tp = _params(jcfg, seed=5)
    toks, kw = _inputs(jcfg, 2, 8, seed=6)
    tt, tkw = torch.from_numpy(toks).long(), _t(kw)
    h_scan, _, _ = tT.forward_hidden(tp, tcfg, tt, **tkw)

    def unroll(params, index):
        units = params["stack"]["units"]
        pat = len(units)
        tail = [jax.tree_util.tree_map(lambda x, u=u: x[u], units[i], is_leaf=index)
                for u in range(n // pat) for i in range(pat)]
        out = dict(params)
        out["stack"] = {"units": None, "tail": tail}
        return out

    is_t = lambda x: isinstance(x, torch.Tensor)  # noqa: E731
    ucfg_t = dataclasses.replace(tcfg, scan_layers=False)
    ucfg_j = dataclasses.replace(jcfg, scan_layers=False)
    h_unroll, _, _ = tT.forward_hidden(unroll(tp, is_t), ucfg_t, tt, **tkw)
    np.testing.assert_allclose(_np(h_unroll), _np(h_scan), rtol=1e-6, atol=1e-6)
    h_ref, _, _ = jT.forward_hidden(unroll(jp, None), ucfg_j, toks, **kw)
    np.testing.assert_allclose(_np(h_unroll), np.asarray(h_ref), **F32)


def _ce(logits, toks):
    """Mean next-token cross-entropy of the logits (the reference test's
    loss, on the forward's logits)."""
    v = logits.shape[-1]
    return float(torch.nn.functional.cross_entropy(
        logits[:, :-1].float().reshape(-1, v), torch.from_numpy(toks[:, 1:]).long().reshape(-1)))


@pytest.mark.parametrize("name", ["qwen2.5-3b", "recurrentgemma-9b", "stablelm-12b"])
def test_opt_no_f32_cast_attn_matches_reference(name):
    """bf16 attention operands with f32 scores (test_optimizations.py's
    ``test_bf16_attn_close``, through the forward): the next-token loss
    within its rtol 5e-3 of the exact-f32 attention's, the port's
    logits held to the exact answer as the reference's are with the flag
    on, and prefill + decode with the flag against the full forward."""
    jcfg, tcfg = _cfgs(name, dtype="bfloat16")
    jp, tp = _params(jcfg, seed=7)
    j32, jp32 = _f32(jcfg, jp)
    toks, _ = _inputs(jcfg, 2, 16, seed=8)
    tt = torch.from_numpy(toks).long()
    h32, _, _ = jT.forward_hidden(jp32, j32, toks)
    exact = jT.unembed(jp32, j32, h32)
    logits = {}
    for flag in (False, True):
        jc, tc = (dataclasses.replace(c, opt_no_f32_cast_attn=flag) for c in (jcfg, tcfg))
        h, _, _ = tT.forward_hidden(tp, tc, tt)
        h_ref, _, _ = jT.forward_hidden(jp, jc, toks)
        logits[flag] = tT.unembed(tp, tc, h)
        _assert_bf16_close(logits[flag], jT.unembed(jp, jc, h_ref), exact)
    assert np.isclose(_ce(logits[True], toks), _ce(logits[False], toks), rtol=5e-3)
    tc = dataclasses.replace(tcfg, opt_no_f32_cast_attn=True)
    s = toks.shape[1]
    lp, cache = tT.prefill(tp, tc, tt[:, : s - 1], max_len=s + 2)
    ld, _ = tT.decode_step(tp, tc, tt[:, s - 1:], cache, s - 1)
    np.testing.assert_allclose(_np(lp), _np(logits[True][:, s - 2]), **BF16)
    np.testing.assert_allclose(_np(ld), _np(logits[True][:, s - 1]), **BF16)


@pytest.mark.parametrize("name", ["qwen2.5-3b", "granite-34b", "whisper-base"])
def test_opt_shard_attn_batch_is_a_no_op(name):
    """``pin_batch`` repeats K/V over the query groups and flattens the
    heads (test_optimizations.py's ``test_attnpin_noop_on_single_device``,
    through the forward): the same logits as without it, and the
    reference's with the flag on."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, seed=9)
    toks, kw = _inputs(jcfg, 2, 16, seed=10)
    tt, tkw = torch.from_numpy(toks).long(), _t(kw)
    h0, _, _ = tT.forward_hidden(tp, tcfg, tt, **tkw)
    jc, tc = (dataclasses.replace(c, opt_shard_attn_batch=True) for c in (jcfg, tcfg))
    h1, _, _ = tT.forward_hidden(tp, tc, tt, **tkw)
    np.testing.assert_allclose(_np(h1), _np(h0), rtol=1e-6, atol=1e-6)
    h_ref, _, _ = jT.forward_hidden(jp, jc, toks, **kw)
    np.testing.assert_allclose(_np(h1), np.asarray(h_ref), **F32)


def test_decode_leaves_the_cache_it_was_given():
    """Attention, RG-LRU and cross-attention caches stay as they were."""
    for name in ("recurrentgemma-9b", "whisper-base"):
        _, tcfg = _cfgs(name)
        tp = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        toks, kw = _inputs(tcfg, 2, 6, seed=11)
        tt, tkw = torch.from_numpy(toks).long(), _t(kw)
        _, cache = tT.prefill(tp, tcfg, tt[:, :5], max_len=8, **tkw)
        before = [t.clone() for t in tT._leaves(cache)]
        a, new = tT.decode_step(tp, tcfg, tt[:, 5:], cache, 5, encoder_out=torch.zeros(1))
        b, _ = tT.decode_step(tp, tcfg, tt[:, 5:], cache, 5)
        assert all(torch.equal(x, y) for x, y in zip(before, tT._leaves(cache)))
        assert torch.equal(a, b)
        assert not all(torch.equal(x, y) for x, y in zip(before, tT._leaves(new)))


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_accounting_matches_reference_at_full_size(name):
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert tacc.param_count(t) == jacc.param_count(j)
    assert tacc.active_param_count(t) == jacc.active_param_count(j)
    assert tacc.param_bytes(t) == jacc.param_bytes(j)
    for shape in ("prefill_32k", "decode_32k", "train_4k"):
        assert tacc.model_flops(t, tbase.SHAPES[shape]) == jacc.model_flops(
            j, jbase.SHAPES[shape])


if __name__ == "__main__":
    # The spread behind BF16_OVER_REF: each architecture's bf16 logits,
    # port and reference, against the exact answer, over three seeds.
    for name in ARCHS:
        for seed in range(3):
            jcfg, tcfg = _cfgs(name, dtype="bfloat16")
            jp, tp = _params(jcfg, seed=seed)
            j32, jp32 = _f32(jcfg, jp)
            toks, kw = _inputs(jcfg, 2, 12, seed=seed + 1)
            h, _, _ = tT.forward_hidden(tp, tcfg, torch.from_numpy(toks).long(), **_t(kw))
            h_ref, _, _ = jT.forward_hidden(jp, jcfg, toks, **kw)
            h_32, _, _ = jT.forward_hidden(jp32, j32, toks, **kw)
            port, ref = _bf16_distances(tT.unembed(tp, tcfg, h), jT.unembed(jp, jcfg, h_ref),
                                        jT.unembed(jp32, j32, h_32))
            print(f"{name:24s} seed {seed}: bf16 logits from the exact answer: "
                  f"port {port:.4f}, reference {ref:.4f}")
