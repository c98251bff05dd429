"""The port's LM side (configs, layers, the Mamba stack, prefill and
decode, accounting, parameter carry-over) on the CPU, held against the
reference on the same numpy inputs and the same reference-initialised
weights.

Tolerances: f32 logits and hidden states at rtol 1e-4, atol 1e-4 (sums
of up to d_inner terms taken in another order); bf16 prefill and decode
against the port's own full forward at the reference test's tolerance
(``test_archs.py::test_decode_matches_forward``: atol 2e-2, rtol 1e-2),
and against the reference at ``BF16_REL``; layers at rtol 1e-5, atol
1e-6 (one short sum each).
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
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import accounting as tacc  # noqa: E402
from repro_torch.models import layers as tL  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=1e-2, atol=2e-2)
# bf16 across the two packages: they round intermediate activations at
# different places (XLA keeps fused chains in f32), which bf16's 8-bit
# mantissa (eps 2^-8) turns into about 1 % over three layers (``python
# tests/test_torch_lm.py`` prints the spread over ten seeds and both
# layouts); elementwise, a few logits sit past the reference test's atol.
# Held by the relative L2 error.
BF16_REL = 3e-2
LAYER = dict(rtol=1e-5, atol=1e-6)
ARCH = "falcon-mamba-7b"


def _cfgs(**overrides):
    j = jconfigs.get_arch(ARCH).scaled_down(n_layers=3, **overrides)
    t = tconfigs.get_arch(ARCH).scaled_down(n_layers=3, **overrides)
    return j, t


def _perturb(tree, rng):
    """Draw the leaves the reference starts at constants (norm scales,
    biases, the skip) so that the comparison sees them."""
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng) if isinstance(v, (dict, list)) or v is None
                    else (v + (rng.normal(size=v.shape) * 0.1).astype(v.dtype)
                          if k in ("scale", "b", "conv_b", "d_skip") else v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


def _params(jcfg, seed=0):
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(seed), jcfg))
    jp = _perturb(jp, np.random.default_rng(seed))
    return jp, lm_params_from_numpy(jp, device="cpu")


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# (c) the Mamba stack end to end


@pytest.mark.parametrize("scan_layers", [True, False])
def test_forward_prefill_and_decode_match_reference_f32(scan_layers):
    jcfg, tcfg = _cfgs(scan_layers=scan_layers)
    jp, tp = _params(jcfg)
    b, s = 2, 12
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    tt = torch.from_numpy(toks).long()

    h_ref, _, _ = jT.forward_hidden(jp, jcfg, toks)
    h, _, aux = tT.forward_hidden(tp, tcfg, tt)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_np(h), np.asarray(h_ref), **F32)
    full = tT.unembed(tp, tcfg, h)
    full_ref = jT.unembed(jp, jcfg, h_ref)
    np.testing.assert_allclose(_np(full), np.asarray(full_ref), **F32)

    lp_ref, cache_ref = jT.prefill(jp, jcfg, toks[:, : s - 1], max_len=s + 4)
    lp, cache = tT.prefill(tp, tcfg, tt[:, : s - 1], max_len=s + 4)
    np.testing.assert_allclose(_np(lp), np.asarray(lp_ref), **F32)
    np.testing.assert_allclose(_np(lp), _np(full[:, s - 2]), **F32)
    ld_ref, new_ref = jT.decode_step(jp, jcfg, toks[:, s - 1 :], cache_ref, jnp.asarray(s - 1))
    ld, new = tT.decode_step(tp, tcfg, tt[:, s - 1 :], cache, s - 1)
    np.testing.assert_allclose(_np(ld), np.asarray(ld_ref), **F32)
    np.testing.assert_allclose(_np(ld), _np(full[:, s - 1]), **F32)

    got = jax.tree_util.tree_leaves(jax.tree_util.tree_map(
        lambda t: t.numpy(), new, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    want = jax.tree_util.tree_leaves(new_ref)
    assert len(got) == len(want) == 2 * jcfg.n_layers // (jcfg.n_layers if scan_layers else 1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, np.asarray(w), **F32)


def test_decode_leaves_the_cache_it_was_given():
    _, tcfg = _cfgs()
    tp = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    toks = torch.randint(0, tcfg.vocab_size, (2, 6), generator=torch.Generator().manual_seed(1))
    _, cache = tT.prefill(tp, tcfg, toks[:, :5], max_len=8)
    before = [t.clone() for t in tT._leaves(cache)]
    a, _ = tT.decode_step(tp, tcfg, toks[:, 5:], cache, 5)
    b, _ = tT.decode_step(tp, tcfg, toks[:, 5:], cache, 5)
    assert all(torch.equal(x, y) for x, y in zip(before, tT._leaves(cache)))
    assert torch.equal(a, b)


def _bf16_run(scan_layers, seed):
    """The bf16 model on the same weights and tokens in both packages:
    the port's (prefill, decode, full) logits, its params, and the
    relative L2 errors of its prefill and decode logits against the
    reference's."""
    jcfg, tcfg = _cfgs(dtype="bfloat16", scan_layers=scan_layers)
    jp, tp = _params(jcfg, seed=seed)
    b, s = 2, 12
    toks = np.random.default_rng(seed + 1).integers(0, jcfg.vocab_size, (b, s)).astype(np.int32)
    tt = torch.from_numpy(toks).long()
    h, _, _ = tT.forward_hidden(tp, tcfg, tt)
    full = tT.unembed(tp, tcfg, h)
    lp, cache = tT.prefill(tp, tcfg, tt[:, : s - 1], max_len=s + 4)
    ld, _ = tT.decode_step(tp, tcfg, tt[:, s - 1 :], cache, s - 1)
    lp_ref, cache_ref = jT.prefill(jp, jcfg, toks[:, : s - 1], max_len=s + 4)
    ld_ref, _ = jT.decode_step(jp, jcfg, toks[:, s - 1 :], cache_ref, jnp.asarray(s - 1))
    rel = []
    for got, want in ((lp, lp_ref), (ld, ld_ref)):
        want = np.asarray(want, np.float32)
        rel.append(float(np.linalg.norm(_np(got) - want) / np.linalg.norm(want)))
    return (lp, ld, full), tp, rel


@pytest.mark.parametrize("scan_layers", [True, False])
def test_prefill_and_decode_in_bf16(scan_layers):
    """The reference test's bf16 case on the port (prefill and decode
    reproduce the full forward at its atol 2e-2, rtol 1e-2), and the
    port's bf16 logits against the reference's at BF16_REL."""
    (lp, ld, full), tp, rel = _bf16_run(scan_layers, seed=2)
    leaf = tp["stack"]["units"][0] if scan_layers else tp["stack"]["tail"][0]
    assert leaf["mamba"]["in_proj"]["w"].dtype == torch.bfloat16
    assert leaf["mamba"]["a_log"].dtype == torch.float32
    assert lp.dtype == ld.dtype == torch.bfloat16
    s = full.shape[1]
    np.testing.assert_allclose(_np(lp), _np(full[:, s - 2]), **BF16)
    np.testing.assert_allclose(_np(ld), _np(full[:, s - 1]), **BF16)
    assert max(rel) < BF16_REL, rel


def test_init_params_has_the_reference_tree():
    for scan_layers in (True, False):
        jcfg, tcfg = _cfgs(scan_layers=scan_layers, dtype="bfloat16")
        ref = jax.eval_shape(lambda k, c=jcfg: jT.init_params(k, c), jax.random.PRNGKey(0))
        got = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
        want = jax.tree_util.tree_map(lambda s: (tuple(s.shape), str(s.dtype)), ref)
        have = jax.tree_util.tree_map(
            lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")), got,
            is_leaf=lambda t: isinstance(t, torch.Tensor))
        assert have == want


def test_init_params_is_deterministic_in_the_generator():
    _, tcfg = _cfgs()
    a = tT.init_params(torch.Generator().manual_seed(5), tcfg, device="cpu")
    b = tT.init_params(torch.Generator().manual_seed(5), tcfg, device="cpu")
    c = tT.init_params(torch.Generator().manual_seed(6), tcfg, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(tT._leaves(a), tT._leaves(b)))
    assert not torch.equal(a["embed"], c["embed"])
    # Every unit of the stack draws its own weights.
    w = a["stack"]["units"][0]["mamba"]["in_proj"]["w"]
    assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# (d) configs


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_lm_config_equals_reference_field_for_field(name):
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert type(t).__module__ == "repro_torch.configs.base"
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.scaled_down()) == dataclasses.asdict(j.scaled_down())
    assert (t.hd, t.q_groups, t.is_subquadratic) == (j.hd, j.q_groups, j.is_subquadratic)
    for shape in jbase.SHAPES:
        assert t.supports_shape(tbase.SHAPES[shape]) == j.supports_shape(jbase.SHAPES[shape])


def test_config_registry_equals_reference():
    assert tbase.ARCH_IDS == jbase.ARCH_IDS
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("name", ["cifar10", "cifar10_full", "cifar10_strided", "lenet5", "svhn"])
def test_cnn_configs_point_at_the_ports_topologies(name):
    import importlib

    from repro_torch.models import cnn as tcnn

    t = importlib.import_module(f"repro_torch.configs.{name}")
    j = importlib.import_module(f"repro.configs.{name}")
    assert t.CONFIG is tcnn.ALL_TOPOLOGIES[name]
    port = dataclasses.asdict(t.CONFIG)
    # The port's head activation; the reference's head is always tanh.
    assert port.pop("fc_act") == "tanh"
    assert port == dataclasses.asdict(j.CONFIG)
    assert t.SELECTED_BITS == j.SELECTED_BITS


# ---------------------------------------------------------------------------
# (e) layers


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 3, 5, 16, scale=3.0), _rand(rng, 16, scale=0.2)
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx = lm_params_from_numpy({"x": np.asarray(jx), "w": np.asarray(jw)}, device="cpu")
    got = tL.rms_norm(tx["x"], tx["w"])
    want = jL.rms_norm(jx, jw)
    assert str(got.dtype).endswith(dtype)
    tol = LAYER if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32), **tol)
    # Not torch.nn.RMSNorm's weight scaling: zero weights leave the unit norm.
    out = tL.rms_norm(torch.from_numpy(x), torch.zeros(16))
    np.testing.assert_allclose(out.square().mean(-1).numpy(), 1.0, rtol=1e-4)


def test_layer_norm_and_apply_norm_match_reference():
    rng = np.random.default_rng(1)
    x = _rand(rng, 4, 16, scale=2.0)
    p = {"scale": _rand(rng, 16), "bias": _rand(rng, 16)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(tL.apply_norm(torch.from_numpy(x), tp, "layernorm").numpy(),
                               np.asarray(jL.apply_norm(x, p, "layernorm")), **LAYER)
    with pytest.raises(ValueError):
        tL.apply_norm(torch.from_numpy(x), tp, "batchnorm")
    for kind in ("rmsnorm", "layernorm"):
        got = tL.init_norm(16, kind, device="cpu")
        want = jL.init_norm(16, kind)
        assert {k: v.tolist() for k, v in got.items()} == {k: np.asarray(v).tolist()
                                                           for k, v in want.items()}


@pytest.mark.parametrize("mode", ["dense", "dense_bias", "pow2_qat", "packed", "packed_odd"])
def test_linear_matches_reference(mode):
    rng = np.random.default_rng(2)
    n = 7 if mode == "packed_odd" else 8
    x = _rand(rng, 3, 4, 16)
    p = {"w": _rand(rng, 16, n, scale=0.3)}
    if mode == "dense_bias":
        p["b"] = _rand(rng, n)
    quant = "pow2_qat" if mode == "pow2_qat" else None
    if mode.startswith("packed"):
        p = jax.device_get(jL.pack_linear_pow2(p))
        assert p["codes"].dtype == np.uint8
    tp = lm_params_from_numpy(p, device="cpu")
    got = tL.linear(torch.from_numpy(x), tp, quant=quant)
    want = jL.linear(jnp.asarray(x), p, quant=quant)
    assert tuple(got.shape) == (3, 4, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


def test_rope_matches_reference():
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 5, 3, 8)
    pos = np.arange(5)
    np.testing.assert_allclose(
        tL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=500.0).numpy(),
        np.asarray(jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=500.0)), **LAYER)


@pytest.mark.parametrize("act", ["silu", "gelu_glu", "gelu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 3, 8)
    ref_p = jax.device_get(jL.init_mlp(jax.random.PRNGKey(0), 8, 16, act=act, bias=True))
    tp = lm_params_from_numpy(ref_p, device="cpu")
    np.testing.assert_allclose(tL.mlp(torch.from_numpy(x), tp, act=act).numpy(),
                               np.asarray(jL.mlp(jnp.asarray(x), ref_p, act=act)), **LAYER)
    got = tL.init_mlp(torch.Generator().manual_seed(0), 8, 16, act=act, bias=True,
                      device="cpu")
    assert {k: {n: tuple(t.shape) for n, t in v.items()} for k, v in got.items()} == {
        k: {n: tuple(a.shape) for n, a in v.items()} for k, v in ref_p.items()}


def test_initializers_have_the_reference_scale():
    gen = torch.Generator().manual_seed(0)
    for fn, shape, std in ((tL.he_init, (400, 300), (2 / 400) ** 0.5),
                           (tL.xavier_init, (400, 300), (2 / 700) ** 0.5),
                           (tL.embed_init, (400, 300), 0.02)):
        w = fn(gen, shape, torch.float32, device="cpu")
        assert tuple(w.shape) == shape and abs(float(w.std()) / std - 1) < 0.02


# ---------------------------------------------------------------------------
# (f) parameter carry-over


def test_lm_params_from_numpy_is_bit_exact_and_keeps_dtypes():
    jcfg, _ = _cfgs(dtype="bfloat16")
    tree = jax.device_get(jT.init_params(jax.random.PRNGKey(7), jcfg))
    got = lm_params_from_numpy(tree, device="cpu")
    want = jax.tree_util.tree_leaves(tree)
    have = list(tT._leaves(got))
    assert len(have) == len(want)
    dtypes = set()
    for t, a in zip(have, want):
        a = np.asarray(a)
        dtypes.add(a.dtype.name)
        assert str(t.dtype).replace("torch.", "") == a.dtype.name
        bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[a.dtype.itemsize]
        np.testing.assert_array_equal(t.view(bits[0]).numpy(), a.view(bits[1]))
    assert dtypes == {"bfloat16", "float32"}
    unrolled = jax.device_get(jT.init_params(
        jax.random.PRNGKey(7), dataclasses.replace(jcfg, scan_layers=False)))
    got = lm_params_from_numpy(unrolled, device="cpu")
    assert got["stack"]["units"] is None and len(got["stack"]["tail"]) == 3


def _lm_builders(tcfg):
    """Every public builder of the LM side, as a function of ``device``."""
    from repro_torch.models import attention as tA
    from repro_torch.models import moe as tmoe

    gen = torch.Generator().manual_seed(0)
    spec = tT._mamba_spec(tcfg)
    return {
        "init_params": lambda **kw: tT.init_params(gen, tcfg, **kw),
        "lm_params_from_numpy": lambda **kw: lm_params_from_numpy(
            {"w": np.zeros((2, 2), np.float32)}, **kw),
        "init_stack": lambda **kw: tT.init_stack(gen, tcfg, 2, **kw),
        "init_stack_cache": lambda **kw: tT.init_stack_cache(tcfg, 2, 1, 4, **kw),
        "init_block": lambda **kw: tT.init_block(gen, tcfg, "mamba", **kw),
        "init_block_cache": lambda **kw: tT.init_block_cache(tcfg, "mamba", "causal", 1, 4,
                                                             **kw),
        "init_mamba": lambda **kw: tssm.init_mamba(gen, spec, **kw),
        "init_rglru": lambda **kw: tssm.init_rglru(gen, tssm.RGLRUSpec(4, 6), **kw),
        "init_moe": lambda **kw: tmoe.init_moe(gen, tmoe.MoESpec(4, 2, 1, 8, shared_d_ff=4),
                                               **kw),
        "init_kv_cache": lambda **kw: tA.init_kv_cache(1, 4, 1, 2, torch.float32, **kw),
        "init_linear": lambda **kw: tL.init_linear(gen, 4, 2, bias=True, **kw),
        "init_norm": lambda **kw: tL.init_norm(4, "layernorm", **kw),
        "init_mlp": lambda **kw: tL.init_mlp(gen, 4, 8, **kw),
        "he_init": lambda **kw: tL.he_init(gen, (4, 2), torch.float32, **kw),
        "xavier_init": lambda **kw: tL.xavier_init(gen, (4, 2), torch.float32, **kw),
        "embed_init": lambda **kw: tL.embed_init(gen, (4, 2), torch.float32, **kw),
        "rope_frequencies": lambda **kw: tL.rope_frequencies(8, **kw),
    }


def test_lm_entry_points_raise_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = _cfgs()
    for name, build in _lm_builders(tcfg).items():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
            pytest.fail(f"{name} built on the CPU without being asked")
        tree = build(device="cpu")
        leaves = [tree] if isinstance(tree, torch.Tensor) else list(tT._leaves(tree))
        assert leaves and all(t.device.type == "cpu" for t in leaves), name


# ---------------------------------------------------------------------------
# (g) opt_bf16_ssm


def test_opt_bf16_ssm_is_accepted_and_runs_the_f32_scan():
    """The reference's flag rounds its discretized SSM tensors to bf16,
    which the fused scan never forms: the port accepts it and runs the
    same f32 scan, so init, prefill and decode equal the flag's absence
    bit for bit (the loss against the reference's 2 % bound:
    ``test_torch_lm_train_parts.py``)."""
    _, tcfg = _cfgs()
    flagged = dataclasses.replace(tcfg, opt_bf16_ssm=True)
    p = tT.init_params(torch.Generator().manual_seed(0), tcfg, device="cpu")
    q = tT.init_params(torch.Generator().manual_seed(0), flagged, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tT._leaves(p), tT._leaves(q)))
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab_size, (2, 6)))
    want, cache = tT.prefill(p, tcfg, toks[:, :-1], max_len=8)
    got, cache_f = tT.prefill(p, flagged, toks[:, :-1], max_len=8)
    assert torch.equal(got, want)
    want, _ = tT.decode_step(p, tcfg, toks[:, -1:], cache, 5)
    got, _ = tT.decode_step(p, flagged, toks[:, -1:], cache_f, 5)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# accounting


def test_accounting_matches_reference():
    for cfg_name in ("full", "scaled"):
        j = jconfigs.get_arch(ARCH)
        t = tconfigs.get_arch(ARCH)
        if cfg_name == "scaled":
            j, t = j.scaled_down(n_layers=3), t.scaled_down(n_layers=3)
        assert tacc.param_count(t) == jacc.param_count(j)
        assert tacc.active_param_count(t) == jacc.active_param_count(j)
        assert tacc.param_bytes(t) == jacc.param_bytes(j)
        for shape in ("prefill_32k", "decode_32k", "train_4k"):
            assert tacc.model_flops(t, tbase.SHAPES[shape]) == jacc.model_flops(
                j, jbase.SHAPES[shape])
    assert tacc.param_count(tconfigs.get_arch(ARCH)) == 7_272_665_088


@pytest.mark.parametrize("name", jbase.ARCH_IDS)
def test_attention_flop_counts_match_reference(name):
    j, t = jconfigs.get_arch(name), tconfigs.get_arch(name)
    assert tacc._attention_flops(t, 4096, 8) == jacc._attention_flops(j, 4096, 8)
    assert tacc._decode_attention_flops(t, 4096, 8) == jacc._decode_attention_flops(j, 4096, 8)
    assert tacc._n_moe_layers(t) == jacc._n_moe_layers(j)


if __name__ == "__main__":
    # The spread behind BF16_REL: the port's bf16 prefill and decode
    # logits against the reference's, over ten seeds and both layouts.
    errs = [e for scan in (True, False) for seed in range(10)
            for e in _bf16_run(scan, seed)[2]]
    print(f"bf16 relative L2 error over {len(errs)} logit sets: "
          f"min {min(errs):.4g}, max {max(errs):.4g}, mean {np.mean(errs):.4g}")
