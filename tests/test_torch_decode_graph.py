"""The LM decode step with its position on the device, written into the
cache it runs on, and jitted (``launch/steps.py`` ``jit_decode_step``),
on the CPU, held against the reference's jitted decode
(``jax.jit(make_decode_step(cfg), donate_argnums=(1,))`` with a
``jnp.int32`` index) on the same numpy inputs and the same
reference-initialised weights (carried across bit for bit with
``convert.lm_params_from_numpy``).

All ten configurations run at ``scaled_down()`` in float32, prompts of 14
tokens (within the 16-token windows and chunks, where the reference lays
its ring out right) and 4 decode steps, so the windowed and chunked
layers' rings wrap or cross a chunk while decoding. MoE configs run
drop-free (``capacity_factor=8.0``), as ``test_torch_lm_archs.py``. The
reference's ring after a prompt longer than the window is a recorded
failure (``test_torch_attention.py``); there the steps are held against
the port's own full forward.

On the CPU the jitted step is the eager step on its static buffers, so
it and a device-tensor index are held bit for bit to the host-int
``decode_step``; against the reference, rtol 1e-4 and atol 1e-5 (sums
taken in another order). The CUDA graphs themselves are held in
``test_torch_decode_graph_card.py``.
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
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.quant import pow2 as tpow2  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.launch.steps import JittedDecode, jit_decode_step  # noqa: E402
from repro_torch.models import transformer as tT  # noqa: E402
from repro_torch.models.layers import pack_params_pow2  # noqa: E402
from repro_torch.tree_util import tree_leaves, tree_map  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
ARCHS = list(jbase.ARCH_IDS)
PROMPT, STEPS, BATCH = 14, 4, 2
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
    biases, the skip) so that the comparison sees them."""
    if isinstance(tree, dict):
        return {k: (_perturb(v, rng) if isinstance(v, (dict, list)) or v is None
                    else (v + (rng.normal(size=v.shape) * 0.1).astype(v.dtype)
                          if k in _PERTURBED else v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, rng) for v in tree]
    return tree


def _case(name, seed=0, prompt=PROMPT, **overrides):
    """(jcfg, tcfg, reference params, port params, tokens (B, prompt +
    STEPS) int32, the reference's and the port's prefill kwargs, the
    prefix length, the caches' max_len)."""
    jcfg, tcfg = _cfgs(name, **overrides)
    jp = jax.device_get(jT.init_params(jax.random.PRNGKey(seed), jcfg))
    jp = _perturb(jp, np.random.default_rng(seed))
    tp = lm_params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(seed + 1)
    toks = rng.integers(0, jcfg.vocab_size, (BATCH, prompt + STEPS)).astype(np.int32)
    kw = {}
    if jcfg.family == "vlm":
        kw["prefix_embeds"] = (rng.normal(size=(BATCH, jcfg.n_prefix_tokens, jcfg.d_model))
                               * 0.1).astype(np.float32)
    if jcfg.family == "encdec":
        kw["encoder_frames"] = (rng.normal(size=(BATCH, jcfg.encoder_seq, jcfg.d_model))
                                * 0.1).astype(np.float32)
    p = jcfg.n_prefix_tokens if jcfg.family == "vlm" else 0
    tkw = {k: torch.from_numpy(v) for k, v in kw.items()}
    return jcfg, tcfg, jp, tp, toks, kw, tkw, p, p + prompt + STEPS


def _port_prefill(tp, tcfg, toks, tkw, max_len, prompt=PROMPT):
    return tT.prefill(tp, tcfg, torch.from_numpy(toks[:, :prompt]).long(), max_len=max_len,
                      **tkw)


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _steps(step, tp, tcfg, cache, toks, start, index_of, prompt=PROMPT):
    """STEPS decode steps on the given tokens: (logits per step, the last
    cache). ``index_of(pos)`` is the index handed to the step."""
    out = []
    for i in range(STEPS):
        tok = torch.from_numpy(toks[:, prompt + i:prompt + i + 1]).long()
        logits, cache = step(tp, tcfg, tok, cache, index_of(start + i))
        out.append(logits)
    return out, cache


@pytest.mark.parametrize("name", ARCHS)
def test_device_index_is_the_host_int_path(name):
    """A 0-d tensor index (int64 and int32, the reference's dtype) gives
    the host-int path's logits and cache bit for bit, step after step."""
    _, tcfg, _, tp, toks, _, tkw, p, max_len = _case(name)
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    want, want_cache = _steps(tT.decode_step, tp, tcfg, cache, toks, p + PROMPT, int)
    for dtype in (torch.int64, torch.int32):
        got, got_cache = _steps(tT.decode_step, tp, tcfg, cache, toks, p + PROMPT,
                                lambda pos, dt=dtype: torch.tensor(pos, dtype=dt))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), dtype
        assert _equal_trees(got_cache, want_cache), dtype


@pytest.mark.parametrize("name", ARCHS)
def test_step_written_in_place_is_decode_steps(name):
    """The private step writes into the cache it is given (the same tree
    comes back) and that cache is ``decode_step``'s bit for bit;
    ``decode_step`` leaves its cache as it was."""
    _, tcfg, _, tp, toks, _, tkw, p, max_len = _case(name)
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    before = tree_map(torch.clone, cache)
    tok = torch.from_numpy(toks[:, PROMPT:PROMPT + 1]).long()
    want, want_cache = tT.decode_step(tp, tcfg, tok, cache, p + PROMPT)
    assert _equal_trees(cache, before)
    mine = tree_map(torch.clone, cache)
    got, got_cache = tT._decode_into(tp, tcfg, tok, mine, torch.tensor(p + PROMPT))
    assert got_cache is mine
    assert torch.equal(got, want) and _equal_trees(got_cache, want_cache)
    assert not _equal_trees(got_cache, before)


@pytest.mark.parametrize("name", ARCHS)
def test_jitted_decode_matches_the_references(name):
    """jit_decode_step, its position a device tensor advanced
    in place, against the reference's jitted decode with the cache donated
    and a jnp.int32 index: the logits of every step and the last cache,
    leaf for leaf; from the second call on the donated tree comes back."""
    jcfg, tcfg, jp, tp, toks, kw, tkw, p, max_len = _case(name)
    jstep = jax.jit(jsteps.make_decode_step(jcfg), donate_argnums=(1,))
    _, cache_ref = jT.prefill(jp, jcfg, toks[:, :PROMPT], max_len=max_len, **kw)
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    decode = jit_decode_step(tcfg)
    pos = torch.full((), p + PROMPT, dtype=torch.long)
    returned = []
    for i in range(STEPS):
        ld_ref, cache_ref = jstep(jp, cache_ref, toks[:, PROMPT + i:PROMPT + i + 1],
                                  jnp.asarray(p + PROMPT + i, jnp.int32))
        ld, cache = decode(tp, cache, torch.from_numpy(toks[:, PROMPT + i:PROMPT + i + 1]).long(),
                           pos)
        pos.add_(1)
        returned.append(cache)
        np.testing.assert_allclose(ld.numpy(), np.asarray(ld_ref), **F32)
    assert all(c is returned[0] for c in returned) and decode._cache_size() == 1
    want = jax.tree_util.tree_leaves(cache_ref)
    got = tree_leaves(cache)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and str(g.dtype).replace("torch.", "") == w.dtype.name
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32), **F32)


@pytest.mark.parametrize("prompt", [7, 9])
def test_ring_after_a_prompt_longer_than_the_window(prompt):
    """recurrentgemma with a 4-token window after a 7- or 9-token prompt
    (the reference's recorded failure): the jitted steps, the position on
    the device, are the port's full forward's rows, and the host-int
    path's bit for bit."""
    _, tcfg, _, tp, toks, _, tkw, _, max_len = _case("recurrentgemma-9b", prompt=prompt,
                                                      window=4)
    h, _, _ = tT.forward_hidden(tp, tcfg, torch.from_numpy(toks).long())
    full = tT.unembed(tp, tcfg, h)
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len, prompt=prompt)
    want, _ = _steps(tT.decode_step, tp, tcfg, cache, toks, prompt, int, prompt=prompt)
    decode = jit_decode_step(tcfg)

    def jitted(tp_, cfg_, tok, cache_, index):
        return decode(tp_, cache_, tok, index)

    got, _ = _steps(jitted, tp, tcfg, cache, toks, prompt, torch.tensor, prompt=prompt)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
        np.testing.assert_allclose(g.numpy(), full[:, prompt + i].numpy(), **F32)


@pytest.mark.parametrize("index_kind", ["int", "tensor"])
def test_jit_decode_step_surface_on_the_cpu(index_kind):
    """The CPU's jitted step, its position a host int or a 0-d tensor:
    decode_step's logits and cache bit for bit, the caller's cache left as
    it was, the static tree handed back and read in place, one key per
    (token shape, cache), new weights followed on the same key, ``clear``."""
    idx = int if index_kind == "int" else torch.tensor
    _, tcfg, _, tp, toks, _, tkw, p, max_len = _case("falcon-mamba-7b")
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    before = tree_map(torch.clone, cache)
    decode = jit_decode_step(tcfg)
    assert isinstance(decode, JittedDecode)
    assert decode is not jit_decode_step(tcfg)
    tok = torch.from_numpy(toks[:, PROMPT:PROMPT + 1]).long()
    want, want_cache = tT.decode_step(tp, tcfg, tok, cache, PROMPT)
    got, c1 = decode(tp, cache, tok, idx(PROMPT))
    assert torch.equal(got, want) and _equal_trees(c1, want_cache)
    assert _equal_trees(cache, before) and decode._cache_size() == 1

    tok2 = torch.from_numpy(toks[:, PROMPT + 1:PROMPT + 2]).long()
    want2, want_cache2 = tT.decode_step(tp, tcfg, tok2, want_cache, PROMPT + 1)
    got2, c2 = decode(tp, c1, tok2, idx(PROMPT + 1))
    assert torch.equal(got2, want2) and _equal_trees(c2, want_cache2)
    assert c2 is c1 and decode._cache_size() == 1

    # Another batch is another key; weights at new addresses stay on their
    # key, and the step follows them, there and back.
    _, cache1 = _port_prefill(tp, tcfg, toks[:1], tkw, max_len)
    decode(tp, cache1, tok[:1], idx(PROMPT))
    assert decode._cache_size() == 2
    tp2 = tree_map(lambda t: t * 1.5 if t.is_floating_point() else t.clone(), tp)
    want3, _ = tT.decode_step(tp2, tcfg, tok, before, PROMPT)
    got3, _ = decode(tp2, before, tok, idx(PROMPT))
    assert torch.equal(got3, want3) and not torch.equal(got3, want)
    got4, _ = decode(tp, before, tok, idx(PROMPT))
    assert torch.equal(got4, want) and decode._cache_size() == 2
    decode.clear()
    assert decode._cache_size() == 0


def test_pow2_packed_decode_and_the_magnitude_table():
    """A pow2-packed stack through the jitted step is decode_step's bit
    for bit; the decode table is copied to a device once."""
    _, tcfg, _, tp, toks, _, tkw, _, max_len = _case("qwen2.5-3b")
    tp = dict(tp, stack=pack_params_pow2(tp["stack"]))
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    want, _ = _steps(tT.decode_step, tp, tcfg, cache, toks, PROMPT, int)
    decode = jit_decode_step(tcfg)

    def jitted(tp_, cfg_, tok, cache_, index):
        return decode(tp_, cache_, tok, index)

    got, _ = _steps(jitted, tp, tcfg, cache, toks, PROMPT, int)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cpu = torch.device("cpu")
    assert tpow2._magnitudes(cpu) is tpow2._magnitudes(cpu)
    assert torch.equal(tpow2._magnitudes(cpu), tpow2._POW2_MAGNITUDES)


def test_scan_launches_are_registered_and_the_cpu_step_launches_nothing():
    """The scan's launch count is registered with the probe (a decode
    graph's capture takes its launches back and each replay adds them);
    on the CPU the step runs the plain scan and logs no launch."""
    assert probe._TABLES["ssm_scan"] is kscan.LAUNCHES
    _, tcfg, _, tp, toks, _, tkw, _, max_len = _case("falcon-mamba-7b")
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    before = dict(kscan.LAUNCHES)
    decode = jit_decode_step(tcfg)
    with probe.recording() as log:
        for i in range(2):
            tok = torch.from_numpy(toks[:, PROMPT + i:PROMPT + i + 1]).long()
            _, cache = decode(tp, cache, tok, PROMPT + i)
    assert log.launches == [] and dict(kscan.LAUNCHES) == before


def test_the_jitted_step_keeps_no_weights_alive():
    """Once the caller drops its weights and its jitted step, nothing keeps
    them: no reference cycle holds them until a collection (a server that
    swaps or frees a model gets its memory back at once)."""
    import gc
    import weakref

    _, tcfg, _, tp, toks, _, tkw, _, max_len = _case("recurrentgemma-9b")
    _, cache = _port_prefill(tp, tcfg, toks, tkw, max_len)
    embed = weakref.ref(tp["embed"])
    enabled = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        decode = jit_decode_step(tcfg)
        tok = torch.from_numpy(toks[:, PROMPT:PROMPT + 1]).long()
        _, cache = decode(tp, cache, tok, PROMPT)
        _, cache = decode(tp, cache, tok, PROMPT + 1)
        step = weakref.ref(decode)
        del decode, tp, cache
        assert embed() is None and step() is None
    finally:
        if enabled:
            gc.enable()
