"""The port's LM modules below the transformer — attention, the chunked
linear recurrence and RG-LRU, MoE routing, pow2 packing of LM weights —
on the CPU, held against the reference on the same numpy inputs; and the
two reference failures the port does not keep (a ring buffer after a
prompt longer than the window, an expert past its capacity).

Tolerances: f32 at rtol 1e-4, atol 1e-5 (sums taken in another order);
bf16 attention (``exact_f32=False``) by a relative L2 error under 1e-2;
packing bit for bit.
"""

import pytest

torch = pytest.importorskip("torch")

# One intra-op thread: the suite runs in parallel workers, and idle
# OpenMP threads would spin on cores that timing tests elsewhere use.
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jA  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import moe as jM  # noqa: E402
from repro.models import ssm as jS  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as tA  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import moe as tM  # noqa: E402
from repro_torch.models import ssm as tS  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
BF16_REL = 1e-2
SPECS = {"causal": dict(), "local": dict(window=3), "chunked": dict(chunk=4), "full": dict()}


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _np(t):
    return t.float().numpy()


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want))


def _specs(kind):
    return jA.AttnSpec(kind, **SPECS[kind]), tA.AttnSpec(kind, **SPECS[kind])


def _to_torch(*arrays, dtype="float32"):
    """numpy arrays -> (the reference's jnp arrays, the port's tensors),
    both in ``dtype`` and with the same bits."""
    js = [jnp.asarray(a, dtype) for a in arrays]
    ts = lm_params_from_numpy([np.asarray(j) for j in js], device="cpu")
    return js, ts


# ---------------------------------------------------------------------------
# Attention


@pytest.mark.parametrize("kind", list(SPECS))
def test_mask_matches_reference(kind):
    js, ts = _specs(kind)
    q, kv = np.arange(3, 11), np.arange(13)
    got = tA._mask(ts, torch.from_numpy(q), torch.from_numpy(kv))
    want = jA._mask(js, jnp.asarray(q), jnp.asarray(kv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# (Sq, Skv, q_block, kv_block, q_offset): whole blocks; Sq and Skv not
# multiples of small blocks; queries after a prefix of keys (q_offset).
BLOCK_CASES = ((8, 8, 4, 4, 0), (7, 7, 3, 2, 0), (5, 13, 2, 4, 8), (11, 11, 1024, 1024, 0))


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "sq%d-skv%d-qb%d-kb%d-off%d" % c)
@pytest.mark.parametrize("kind", list(SPECS))
@pytest.mark.parametrize("exact_f32", [True, False])
def test_blockwise_attention_matches_reference(kind, case, exact_f32):
    sq, skv, qb, kb, off = case
    rng = np.random.default_rng(sq * 100 + skv)
    b, hkv, g, dh = 2, 2, 3, 8
    dtype = "float32" if exact_f32 else "bfloat16"
    (jq, jk, jv), (tq, tk, tv) = _to_torch(
        _rand(rng, b, sq, hkv, g, dh), _rand(rng, b, skv, hkv, dh), _rand(rng, b, skv, hkv, dh),
        dtype=dtype)
    js, ts = _specs(kind)
    kw = dict(q_offset=off, q_block=qb, kv_block=kb, exact_f32=exact_f32)
    got = tA.blockwise_attention(tq, tk, tv, ts, **kw)
    want = jA.blockwise_attention(jq, jk, jv, js, **kw)
    assert tuple(got.shape) == want.shape and str(got.dtype).endswith(dtype)
    if exact_f32:
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    else:
        assert _rel(got, want) < BF16_REL


def test_blockwise_attention_rows_with_no_visible_key_in_a_block():
    """A local window leaves whole early kv blocks masked for late rows:
    the finite NEG_INF keeps them finite and the next block's rescale
    wipes them (with -inf they would be NaN)."""
    rng = np.random.default_rng(0)
    (jq, jk, jv), (tq, tk, tv) = _to_torch(_rand(rng, 1, 16, 1, 2, 4), _rand(rng, 1, 16, 1, 4),
                                          _rand(rng, 1, 16, 1, 4))
    js, ts = jA.AttnSpec("local", window=2), tA.AttnSpec("local", window=2)
    got = tA.blockwise_attention(tq, tk, tv, ts, q_block=4, kv_block=4)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(_np(got), np.asarray(jA.blockwise_attention(
        jq, jk, jv, js, q_block=4, kv_block=4)), **F32)


@pytest.mark.parametrize("g", [1, 4])
def test_pin_batch_matches_reference(g):
    rng = np.random.default_rng(g)
    (jq, jk, jv), (tq, tk, tv) = _to_torch(_rand(rng, 2, 6, 2, g, 8), _rand(rng, 2, 6, 2, 8),
                                          _rand(rng, 2, 6, 2, 8))
    js, ts = _specs("causal")
    got = tA.blockwise_attention(tq, tk, tv, ts, pin_batch=True, q_block=4, kv_block=2)
    want = jA.blockwise_attention(jq, jk, jv, js, pin_batch=True, q_block=4, kv_block=2)
    assert tuple(got.shape) == want.shape == (2, 6, 2 * g, 1, 8)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    plain = tA.blockwise_attention(tq, tk, tv, ts, q_block=4, kv_block=2)
    np.testing.assert_allclose(_np(got).reshape(plain.shape), _np(plain), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["causal", "local", "chunked"])
@pytest.mark.parametrize("exact_f32", [True, False])
def test_decode_attention_on_a_wrapped_ring_matches_reference(kind, exact_f32):
    """Position 13 against a 5-slot ring that has wrapped twice; and, with
    the ring filled as decode fills it, the last row of the blockwise
    attention over the whole sequence."""
    rng = np.random.default_rng(3)
    b, hkv, g, dh, s_cache, cur = 2, 1, 4, 8, 5, 13
    dtype = "float32" if exact_f32 else "bfloat16"
    (jq, jk, jv), (tq, tk, tv) = _to_torch(_rand(rng, b, cur + 1, hkv, g, dh),
                                          _rand(rng, b, cur + 1, hkv, dh),
                                          _rand(rng, b, cur + 1, hkv, dh), dtype=dtype)
    js, ts = jA.AttnSpec(kind, window=4, chunk=4), tA.AttnSpec(kind, window=4, chunk=4)
    ring_j = jA.init_kv_cache(b, s_cache, hkv, dh, jnp.dtype(dtype))
    ring_t = tA.init_kv_cache(b, s_cache, hkv, dh, getattr(torch, dtype), device="cpu")
    for pos in range(cur + 1):
        ring_j = jA.update_kv_cache(ring_j, jk[:, pos:pos + 1], jv[:, pos:pos + 1], pos)
        ring_t = tA.update_kv_cache(ring_t, tk[:, pos:pos + 1], tv[:, pos:pos + 1], pos)
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(ring_t[name]), np.asarray(ring_j[name], np.float32))
    q_last = tq[:, cur:]
    got = tA.decode_attention(q_last, ring_t["k"], ring_t["v"], cur, ts, exact_f32=exact_f32)
    want = jA.decode_attention(jq[:, cur:], ring_j["k"], ring_j["v"], jnp.asarray(cur), js,
                               exact_f32=exact_f32)
    assert tuple(got.shape) == want.shape == (b, 1, hkv, g, dh)
    if exact_f32:
        np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    else:
        assert _rel(got, want) < BF16_REL
    if kind != "causal":  # a causal layer sees more than 5 slots hold
        full = tA.blockwise_attention(tq, tk, tv, ts, exact_f32=exact_f32)[:, cur:]
        if exact_f32:
            np.testing.assert_allclose(_np(got), _np(full), **F32)
        else:
            assert _rel(got, _np(full)) < BF16_REL


def test_update_kv_cache_leaves_the_cache_it_was_given():
    cache = tA.init_kv_cache(1, 3, 1, 2, torch.float32, device="cpu")
    new = tA.update_kv_cache(cache, torch.ones(1, 1, 1, 2), 2 * torch.ones(1, 1, 1, 2), 7)
    assert float(cache["k"].abs().sum()) == 0.0
    assert new["k"][0, 1].tolist() == [[1.0, 1.0]] and new["v"][0, 1].tolist() == [[2.0, 2.0]]
    ref = jA.init_kv_cache(1, 3, 1, 2, jnp.float32)
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in ref.items()} == {
        k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in cache.items()}


# ---------------------------------------------------------------------------
# The chunked linear recurrence and RG-LRU


@pytest.mark.parametrize("s, chunk", [(7, 3), (16, 4), (13, 256), (1, 4), (300, 256)])
def test_chunked_linear_recurrence_matches_reference(s, chunk):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, (2, s, 5)).astype(np.float32)
    b, h0 = _rand(rng, 2, s, 5), _rand(rng, 2, 5)
    h_all, h_last = tS.chunked_linear_recurrence(torch.from_numpy(a), torch.from_numpy(b),
                                                 torch.from_numpy(h0), chunk=chunk)
    r_all, r_last = jS.chunked_linear_recurrence(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0),
                                                 chunk=chunk)
    np.testing.assert_allclose(h_all.numpy(), np.asarray(r_all), **F32)
    np.testing.assert_allclose(h_last.numpy(), np.asarray(r_last), **F32)
    # The plain recurrence, step by step.
    h, ref = h0.astype(np.float64), []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        ref.append(h)
    np.testing.assert_allclose(h_all.numpy(), np.stack(ref, 1), **F32)


def _rglru(seed, dtype="float32"):
    spec_j = jS.RGLRUSpec(d_model=16, lru_width=24, d_conv=4)
    spec_t = tS.RGLRUSpec(d_model=16, lru_width=24, d_conv=4)
    jp = jax.device_get(jS.init_rglru(jax.random.PRNGKey(seed), spec_j, dtype=jnp.dtype(dtype)))
    return spec_j, spec_t, jp, lm_params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_apply_matches_reference(with_state):
    spec_j, spec_t, jp, tp = _rglru(0)
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 11, 16)
    kw_j, kw_t = {}, {}
    if with_state:
        h, conv = _rand(rng, 2, 24), _rand(rng, 2, 3, 24)
        kw_j = dict(h_state=jnp.asarray(h), conv_state=jnp.asarray(conv))
        kw_t = dict(h_state=torch.from_numpy(h), conv_state=torch.from_numpy(conv))
    got = tS.rglru_apply(tp, spec_t, torch.from_numpy(x), chunk=4, **kw_t)
    want = jS.rglru_apply(jp, spec_j, jnp.asarray(x), chunk=4, **kw_j)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
    # A decode step from the carried states equals the next row of the
    # sequence run in one call.
    y_all, _, _ = tS.rglru_apply(tp, spec_t, torch.from_numpy(x), **kw_t)
    _, h10, c10 = tS.rglru_apply(tp, spec_t, torch.from_numpy(x[:, :10]), **kw_t)
    y_step, _, _ = tS.rglru_apply(tp, spec_t, torch.from_numpy(x[:, 10:]), h_state=h10,
                                  conv_state=c10)
    np.testing.assert_allclose(y_step.numpy(), y_all[:, 10:].numpy(), **F32)


def test_init_rglru_has_the_reference_tree_and_range():
    spec_j, spec_t, jp, _ = _rglru(0, dtype="bfloat16")
    got = tS.init_rglru(torch.Generator().manual_seed(0), spec_t, dtype=torch.bfloat16,
                        device="cpu")
    assert jax.tree_util.tree_map(lambda a: (a.shape, a.dtype.name), jp) == jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got,
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    # a^c = sigmoid-free decay at r = 1: exp(-c softplus(lam)) in [0.9, 0.999].
    decay = torch.exp(-spec_t.c * tS._softplus(got["lam"]))
    assert float(decay.min()) >= 0.9 - 1e-5 and float(decay.max()) <= 0.999 + 1e-5
    x = torch.linspace(-30, 30, 121)
    np.testing.assert_allclose(tS._softplus(x).numpy(), np.asarray(jax.nn.softplus(x.numpy())),
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# MoE


def _moe(seed, **spec_kw):
    kw = dict(d_model=16, n_experts=4, top_k=2, d_ff=24, capacity_factor=8.0)
    kw.update(spec_kw)
    spec_j, spec_t = jM.MoESpec(**kw), tM.MoESpec(**kw)
    jp = jax.device_get(jM.init_moe(jax.random.PRNGKey(seed), spec_j))
    return spec_j, spec_t, jp, lm_params_from_numpy(jp, device="cpu")


def test_route_group_matches_reference():
    spec_j, spec_t, jp, tp = _moe(0)
    x = _rand(np.random.default_rng(0), 9, 16)
    y, aux = tM._route_group(torch.from_numpy(x)[None], tp, spec_t)
    y_ref, aux_ref = jM._route_group(jnp.asarray(x), jp, spec_j)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(y_ref), **F32)
    np.testing.assert_allclose(float(aux[0]), float(aux_ref), **F32)


@pytest.mark.parametrize("shared, norm_topk, top_k", [(0, True, 2), (12, True, 1),
                                                      (0, False, 2), (12, False, 3)])
def test_moe_apply_matches_reference(shared, norm_topk, top_k):
    spec_j, spec_t, jp, tp = _moe(1, shared_d_ff=shared, norm_topk=norm_topk, top_k=top_k)
    x = _rand(np.random.default_rng(2), 3, 10, 16)
    y, aux = tM.moe_apply(tp, spec_t, torch.from_numpy(x))
    y_ref, aux_ref = jM.moe_apply(jp, spec_j, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **F32)
    np.testing.assert_allclose(float(aux), float(aux_ref), **F32)
    assert spec_t.capacity(10) == spec_j.capacity(10)


def test_top_k_breaks_ties_toward_the_lower_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1]])
    vals, idx = tM._top_k(probs, 2)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(want_i).tolist() == [[0, 1], [1, 2]]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


def test_init_moe_has_the_reference_tree():
    spec_j, spec_t, jp, _ = _moe(0, shared_d_ff=12)
    got = tM.init_moe(torch.Generator().manual_seed(0), spec_t, dtype=torch.bfloat16, device="cpu")
    want = jax.eval_shape(lambda k: jM.init_moe(k, spec_j, dtype=jnp.bfloat16),
                          jax.random.PRNGKey(0))
    have = jax.tree_util.tree_map(lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
                                  got, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), want) == have


# ---------------------------------------------------------------------------
# pow2 packing of LM weights


@pytest.mark.parametrize("shape, bias", [((16, 8), False), ((16, 7), True), ((3, 16, 8), False),
                                         ((2, 3, 16, 9), True)])
def test_pack_linear_pow2_bit_for_bit(shape, bias):
    rng = np.random.default_rng(len(shape) * 10 + shape[-1])
    p = {"w": _rand(rng, *shape, scale=0.3)}
    if bias:
        p["b"] = _rand(rng, shape[-1])
    want = jax.device_get(jL.pack_linear_pow2({k: jnp.asarray(v) for k, v in p.items()}))
    got = tL.pack_linear_pow2({k: torch.from_numpy(v) for k, v in p.items()})
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == {"codes": torch.uint8}.get(k, torch.float32)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    # linear on the packed weights (a per-layer slice of a stacked one).
    x = _rand(rng, 2, 5, shape[-2])
    one = {k: (v.reshape((-1,) + v.shape[-2:])[0] if k != "b" else v) for k, v in got.items()}
    one_ref = {k: (np.asarray(v).reshape((-1,) + v.shape[-2:])[0] if k != "b" else v)
               for k, v in want.items()}
    np.testing.assert_allclose(tL.linear(torch.from_numpy(x), one).numpy(),
                               np.asarray(jL.linear(jnp.asarray(x), one_ref)), **F32)


def test_pack_params_pow2_and_packed_lm_serving_match_reference():
    """A whole scaled-down LM tree packed in both packages, bit for bit,
    and prefill + decode on the packed weights against the reference."""
    jcfg = jconfigs.get_arch("qwen2.5-3b").scaled_down()
    tcfg = tconfigs.get_arch("qwen2.5-3b").scaled_down()
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(0), jcfg))
    packed_ref = jax.device_get(jL.pack_params_pow2(jp))
    packed = tL.pack_params_pow2(lm_params_from_numpy(jp, device="cpu"))
    want = jax.tree_util.tree_leaves_with_path(packed_ref)
    got = jax.tree_util.tree_leaves_with_path(packed, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert str(g.dtype).replace("torch.", "") == np.asarray(w).dtype.name, path
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=str(path))
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 9)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    lp, cache = tT.prefill(packed, tcfg, tt[:, :8], max_len=12)
    lp_ref, cache_ref = jT.prefill(packed_ref, jcfg, toks[:, :8], max_len=12)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_ref), **F32)
    ld, _ = tT.decode_step(packed, tcfg, tt[:, 8:], cache, 8)
    ld_ref, _ = jT.decode_step(packed_ref, jcfg, toks[:, 8:], cache_ref, jnp.asarray(8))
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **F32)


# ---------------------------------------------------------------------------
# Reference failures the port does not keep


def _ring_case(prompt):
    """recurrentgemma scaled_down with a 4-token window, B=2, the same
    reference-initialised weights in both packages: (port's decode logits,
    reference's, port's full forward's last row)."""
    jcfg = jconfigs.get_arch("recurrentgemma-9b").scaled_down(window=4)
    tcfg = tconfigs.get_arch("recurrentgemma-9b").scaled_down(window=4)
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(0), jcfg))
    tp = lm_params_from_numpy(jp, device="cpu")
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, prompt + 1)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    h, _, _ = tT.forward_hidden(tp, tcfg, tt)
    full_last = tT.unembed(tp, tcfg, h)[:, prompt]
    _, cache = tT.prefill(tp, tcfg, tt[:, :prompt], max_len=prompt + 4)
    ld, _ = tT.decode_step(tp, tcfg, tt[:, prompt:], cache, prompt)
    _, cache_ref = jT.prefill(jp, jcfg, toks[:, :prompt], max_len=prompt + 4)
    ld_ref, _ = jT.decode_step(jp, jcfg, toks[:, prompt:], cache_ref, jnp.asarray(prompt))
    return ld, np.asarray(ld_ref), full_last


@pytest.mark.parametrize("prompt", [3, 4, 8])
def test_ring_buffer_within_the_window_or_a_multiple_matches_reference(prompt):
    """Where the reference's prefill lays the ring out right (s <= S, or S
    divides s), the port's cache and decode are the reference's."""
    ld, ld_ref, full_last = _ring_case(prompt)
    np.testing.assert_allclose(ld.numpy(), ld_ref, **F32)
    np.testing.assert_allclose(ld.numpy(), full_last.numpy(), **F32)


@pytest.mark.parametrize("prompt", [7, 9])
def test_ring_buffer_after_a_prompt_longer_than_the_window(prompt):
    """Reference failure, not kept by the port: after a prompt longer than
    the window and not a multiple of it, the reference's prefill writes
    the KV tail at slots 0..S-1, where decode reads slot i as position
    cur - ((cur - i) mod S), so its decode is far off its full forward.
    The port writes position p at slot p mod S: its decode is its full
    forward's last row."""
    ld, ld_ref, full_last = _ring_case(prompt)
    np.testing.assert_allclose(ld.numpy(), full_last.numpy(), **F32)
    assert float(np.abs(ld_ref - full_last.numpy()).max()) > 0.5


def test_overflowing_expert_keeps_its_first_tokens():
    """Reference failure, not kept by the port: 8 tokens all routed to
    expert 0 of 2, capacity 2. GShard semantics give tokens 0 and 1 an
    output and drop the rest. The reference also scatters each dropped
    slot to slot 0 of its expert, and on XLA:CPU the last write wins, so
    token 0 loses its output there; the port scatters kept slots only."""
    spec_kw = dict(d_model=8, n_experts=2, top_k=1, d_ff=8, capacity_factor=0.5)
    spec_j, spec_t, jp, _ = _moe(0, **spec_kw)
    assert spec_t.capacity(8) == spec_j.capacity(8) == 2
    jp = dict(jp, router=np.array([[4.0, -4.0]] * 8, np.float32))  # x > 0 -> expert 0
    tp = lm_params_from_numpy(jp, device="cpu")
    x = np.abs(_rand(np.random.default_rng(0), 1, 8, 8)) + 0.1
    y, _ = tM.moe_apply(tp, spec_t, torch.from_numpy(x))
    y_ref, _ = jM.moe_apply(jp, spec_j, jnp.asarray(x))
    got = (y[0].abs().sum(-1) > 0).tolist()
    ref = (np.abs(np.asarray(y_ref)[0]).sum(-1) > 0).tolist()
    assert got == [True, True] + [False] * 6
    assert ref[0] is False and ref[1] is True
    # Token 1 (kept in both) gets the same output.
    np.testing.assert_allclose(y[0, 1].numpy(), np.asarray(y_ref)[0, 1], **F32)
    # Token 0's output is its expert's, gate 1 (top-1, renormalized).
    h = torch.from_numpy(x[0, :1])
    w = {k: tp[k][0] for k in ("w_gate", "w_up", "w_down")}
    one = (torch.nn.functional.silu(h @ w["w_gate"]) * (h @ w["w_up"])) @ w["w_down"]
    np.testing.assert_allclose(y[0, 0:1].numpy(), one.numpy(), **F32)


def test_moe_with_drops_keeps_each_experts_first_tokens():
    """At the configs' capacity factor 1.25 with uneven routing: every
    expert keeps at most C tokens, the first in token order, and a kept
    token's output is its experts' weighted sum."""
    spec_j, spec_t, jp, tp = _moe(3, capacity_factor=1.25, top_k=1)
    x = _rand(np.random.default_rng(4), 2, 16, 16)
    y, _ = tM.moe_apply(tp, spec_t, torch.from_numpy(x))
    c = spec_t.capacity(16)
    probs = torch.softmax(torch.from_numpy(x) @ tp["router"], -1)
    ids = probs.argmax(-1)
    for g in range(2):
        for e in range(spec_t.n_experts):
            toks = (ids[g] == e).nonzero().flatten().tolist()
            for rank, t in enumerate(toks):
                kept = bool(y[g, t].abs().sum() > 0)
                assert kept == (rank < c), (g, e, t, rank, c)


# ---------------------------------------------------------------------------
# Public names


@pytest.mark.parametrize("module", ["attention", "moe", "ssm", "layers", "transformer"])
def test_the_lm_modules_have_the_references_names(module):
    """Every function and class the reference module defines, but the mesh
    constraint the port has no ambient mesh for."""
    import importlib

    j = importlib.import_module(f"repro.models.{module}")
    t = importlib.import_module(f"repro_torch.models.{module}")
    left_out = {"_constrain"}
    names = {n for n, v in vars(j).items() if not n.startswith("__")
             and callable(v) and getattr(v, "__module__", None) == j.__name__}
    assert sorted(n for n in names - left_out if not hasattr(t, n)) == []
    if module == "attention":
        assert tA.NEG_INF == jA.NEG_INF == -1e30
