"""The LM decode step as CUDA graphs on the card (``launch/steps.py``
``jit_decode_step``): one graph of the whole step per (batch, cache),
recaptured on new weights, the position on the device, the cache
written in place.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card and the
CUDA toolkit (the scan kernel is built with nvcc at first use):

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_decode_graph_card.py

This file imports no JAX: the machine with the card has none.

A replay runs the kernels the eager ``decode_step`` runs, in the same
order on the same shapes (the eager step's clone of the cache aside),
and no kernel of the step sums with atomics, so every replay is held to
the eager step bit for bit: its logits and every leaf of its cache.
Covered: falcon-mamba through the scan kernel, a recurrentgemma ring
wrapped after a prompt longer than its window, a MoE config, a
pow2-packed stack, the donated cache read and written in place, new
weights recaptured in place of the old graph, new weights at freed
addresses followed, the scan's launches counted at each replay, and a
capture that fails.
"""
import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import dataclasses  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels import probe  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.layers import pack_params_pow2  # noqa: E402
from repro_torch.tree_util import tree_leaves, tree_map  # noqa: E402

pytestmark = pytest.mark.card

B, PROMPT, STEPS = 2, 12, 6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _model(name, dev, seed=0, prompt=PROMPT, pow2=False, **overrides):
    """(cfg, params, tokens (B, prompt + STEPS), the prefill's cache)."""
    cfg = get_arch(name).scaled_down(**overrides)
    params = T.init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    if pow2:
        params = dict(params, stack=pack_params_pow2(params["stack"]))
    gen = torch.Generator().manual_seed(seed + 1)
    toks = torch.randint(0, cfg.vocab_size, (B, prompt + STEPS), generator=gen).to(dev)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = (torch.randn((B, cfg.n_prefix_tokens, cfg.d_model),
                                           generator=gen) * 0.1).to(dev)
    if cfg.family == "encdec":
        kw["encoder_frames"] = (torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                            generator=gen) * 0.1).to(dev)
    n_pre = cfg.n_prefix_tokens if cfg.family == "vlm" else 0
    with torch.no_grad():
        _, cache = T.prefill(params, cfg, toks[:, :prompt], max_len=n_pre + prompt + STEPS,
                             **kw)
    return cfg, params, toks, cache, n_pre + prompt


def _equal_trees(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _graph_against_eager(cfg, params, toks, cache, start, *, prompt=PROMPT, counts=None):
    """STEPS steps through one jitted step (the position a device tensor
    advanced in place) and through eager ``decode_step`` from the same
    cache on the same tokens; asserts the logits and caches bit for bit
    at every step. ``counts`` collects the scan launches of each jitted
    call. Returns the jitted step."""
    decode = S.jit_decode_step(cfg)
    pos = torch.full((), start, dtype=torch.long, device=toks.device)
    eager_cache, graph_cache = cache, cache
    with torch.no_grad():
        for i in range(STEPS):
            tok = toks[:, prompt + i:prompt + i + 1]
            want, eager_cache = T.decode_step(params, cfg, tok, eager_cache, start + i)
            before = kscan.LAUNCHES["ssm_scan"]
            got, graph_cache = decode(params, graph_cache, tok, pos)
            if counts is not None:
                counts.append(kscan.LAUNCHES["ssm_scan"] - before)
            pos.add_(1)
            assert torch.equal(got, want), i
            assert _equal_trees(graph_cache, eager_cache), i
    return decode


def test_falcon_mamba_replays_the_scan_kernel_bit_for_bit(card):
    cfg, params, toks, cache, start = _model("falcon-mamba-7b", card)
    counts = []
    decode = _graph_against_eager(cfg, params, toks, cache, start, counts=counts)
    assert decode._cache_size() == 1
    # Every call counts one launch a layer: the first its eager warm-up
    # (the capture's own are taken back), every later one its replay.
    assert counts == [cfg.n_layers] * STEPS


def test_scan_launches_are_logged_at_each_replay(card):
    cfg, params, toks, cache, start = _model("falcon-mamba-7b", card)
    decode = S.jit_decode_step(cfg)
    with torch.no_grad():
        _, cache = decode(params, cache, toks[:, PROMPT:PROMPT + 1], start)  # capture
        before = kscan.LAUNCHES["ssm_scan"]
        with probe.recording() as log:
            decode(params, cache, toks[:, PROMPT + 1:PROMPT + 2], start + 1)
    assert kscan.LAUNCHES["ssm_scan"] - before == cfg.n_layers
    assert [name for _, name, _ in log.launches] == ["ssm_scan"] * cfg.n_layers
    assert all(smem > 0 for _, _, smem in log.launches)


@pytest.mark.parametrize("prompt", [7, 9])
def test_recurrentgemma_ring_wrapped_after_a_long_prompt(card, prompt):
    """A 4-token window after a 7- or 9-token prompt: the ring has wrapped
    before the first step and wraps again while decoding; the replays
    read and write it at the device position's slot."""
    cfg, params, toks, cache, start = _model("recurrentgemma-9b", card, prompt=prompt, window=4)
    _graph_against_eager(cfg, params, toks, cache, start, prompt=prompt)


@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
def test_moe_replays_bit_for_bit(card, name):
    cfg, params, toks, cache, start = _model(name, card)
    _graph_against_eager(cfg, params, toks, cache, start)


def test_pow2_packed_stack_replays_bit_for_bit(card):
    cfg, params, toks, cache, start = _model("qwen2.5-3b", card, pow2=True)
    _graph_against_eager(cfg, params, toks, cache, start)


@pytest.mark.parametrize("name", ["whisper-base", "internvl2-2b"])
def test_encdec_and_vlm_replay_bit_for_bit(card, name):
    cfg, params, toks, cache, start = _model(name, card)
    _graph_against_eager(cfg, params, toks, cache, start)


def test_a_donated_call_copies_no_cache(card):
    """Handing back the tree the last call returned: the same tree and the
    same storage come back, and no copy writes into a cache leaf."""
    cfg, params, toks, cache, start = _model("recurrentgemma-9b", card)
    decode = S.jit_decode_step(cfg)
    kept = tree_map(torch.clone, cache)
    with torch.no_grad():
        _, c1 = decode(params, cache, toks[:, PROMPT:PROMPT + 1], start)
        assert _equal_trees(cache, kept)  # the caller's tree, copied in
        ptrs = [t.data_ptr() for t in tree_leaves(c1)]
        copies = []
        real_copy = torch.Tensor.copy_

        def spy(self, src, *a, **k):
            copies.append(self.data_ptr())
            return real_copy(self, src, *a, **k)

        torch.Tensor.copy_ = spy
        try:
            _, c2 = decode(params, c1, toks[:, PROMPT + 1:PROMPT + 2], start + 1)
        finally:
            torch.Tensor.copy_ = real_copy
    assert c2 is c1 and [t.data_ptr() for t in tree_leaves(c2)] == ptrs
    assert not set(copies) & set(ptrs)
    assert decode._cache_size() == 1


def test_new_weights_capture_anew_and_are_followed(card):
    """Weights swapped twice, and back: each swap recaptures the key's
    graph in place of the old one (one graph per (batch, cache), the old
    graph dropped) and the replays follow the weights of the call."""
    cfg, params, toks, cache, start = _model("qwen2.5-3b", card)
    decode = S.jit_decode_step(cfg)
    tok = toks[:, PROMPT:PROMPT + 1]
    graphs, held = [], []
    with torch.no_grad():
        first, _ = decode(params, cache, tok, start)
        graphs.append(next(iter(decode._graphs.values())).graph)
        for scale in (1.25, 0.75):
            # Each swap's weights are held to the end, so the next swap's lie
            # elsewhere: weights allocated where freed ones lay replay the
            # key's graph as it is, reading them there, with no recapture.
            swapped = tree_map(lambda t: t * scale if t.is_floating_point() else t.clone(),
                               params)
            held.append(swapped)
            want, _ = T.decode_step(swapped, cfg, tok, cache, start)
            got, _ = decode(swapped, cache, tok, start)
            again, _ = decode(swapped, cache, tok, start)
            assert decode._cache_size() == 1
            assert torch.equal(got, want) and torch.equal(again, want)
            assert not torch.equal(got, first)
            graphs.append(next(iter(decode._graphs.values())).graph)
        back, _ = decode(params, cache, tok, start)
    assert decode._cache_size() == 1 and torch.equal(back, first)
    assert len({id(g) for g in graphs}) == len(graphs)


def test_weights_allocated_where_freed_ones_lay_are_followed(card):
    """Each swap's weights are freed before the next swap's are made with
    the same shapes, so the allocator may hand out the freed addresses
    again: the key's storage then matches and the graph replays as it is,
    reading the new values there; where it does not, the key recaptures.
    Either way each answer is the eager step's on the weights of the call."""
    cfg, params, toks, cache, start = _model("qwen2.5-3b", card)
    decode = S.jit_decode_step(cfg)
    tok = toks[:, PROMPT:PROMPT + 1]
    with torch.no_grad():
        for scale in (1.25, 0.75, 1.5, 0.5):
            swapped = tree_map(lambda t: t * scale if t.is_floating_point() else t.clone(),
                               params)
            got, _ = decode(swapped, cache, tok, start)
            again, _ = decode(swapped, cache, tok, start)
            want, _ = T.decode_step(swapped, cfg, tok, cache, start)
            assert torch.equal(got, want) and torch.equal(again, want), scale
            del swapped
    assert decode._cache_size() == 1


def test_a_failed_capture_raises(card, monkeypatch):
    """A step that reads the host cannot be captured: the call raises
    CUDA's error, nothing is kept, and nothing falls back to eager."""
    cfg, params, toks, cache, start = _model("qwen2.5-3b", card)
    real = S._decode_into

    def reads_host(*args):
        logits, c = real(*args)
        float(logits.sum())
        return logits, c

    monkeypatch.setattr(S, "_decode_into", reads_host)
    decode = S.jit_decode_step(cfg)
    with torch.no_grad(), pytest.raises(RuntimeError, match="(?i)captur"):
        decode(params, cache, toks[:, PROMPT:PROMPT + 1], start)
    assert decode._cache_size() == 0
    monkeypatch.setattr(S, "_decode_into", real)
    torch.cuda.synchronize()
    with torch.no_grad():
        got, _ = decode(params, cache, toks[:, PROMPT:PROMPT + 1], start)
        want, _ = T.decode_step(params, cfg, toks[:, PROMPT:PROMPT + 1], cache, start)
    assert torch.equal(got, want)


def test_full_width_layer_shapes(card):
    """One falcon-mamba layer at its published width (d_model 4096, the
    scan at D 8192, N 16) in bf16 at B=4: the graph's step is eager's."""
    full = get_arch("falcon-mamba-7b")
    cfg = dataclasses.replace(full.scaled_down(n_layers=1), d_model=full.d_model,
                              ssm_state=full.ssm_state, vocab_size=1024, dtype="bfloat16")
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device=card)
    toks = torch.randint(0, cfg.vocab_size, (4, 16 + STEPS),
                         generator=torch.Generator().manual_seed(1)).to(card)
    with torch.no_grad():
        _, cache = T.prefill(params, cfg, toks[:, :16], max_len=16 + STEPS)
    _graph_against_eager(cfg, params, toks, cache, 16, prompt=16)
