"""The nine attention, RG-LRU, MoE, encoder-decoder and VLM architectures
on the card against the same port on the CPU (same weights, same
inputs), at ``scaled_down()``.

Every test needs an NVIDIA card: each one asks for it inside the test
(the ``card`` fixture) and skips there without one, so every pytest
worker collects the same tests. Run on a machine with the card:

    PYTHONPATH=src python -m pytest -q -m card tests/test_torch_lm_card.py

This file imports no JAX: the machine with the card has none.

Tolerances: f32 at rtol 1e-4, atol 1e-5 (cuBLAS and the CPU sum in other
orders, TF32 off). bf16 by the relative L2 error of the logits against
the exact answer (the port's own f32 forward on the CPU, on the same
bf16 weights): the card's must be within ``BF16_REL`` of it, or no
further from it than ``BF16_OVER_CPU`` times the CPU's bf16 logits are,
as ``tests/test_torch_lm_archs.py`` holds the port's bf16 against the
reference's (each lands 1-2 % from the exact answer).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

torch.set_num_threads(1)

import numpy as np  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.base import ARCH_IDS  # noqa: E402
from repro_torch.kernels.pow2_matmul import pow2 as kpow2  # noqa: E402
from repro_torch.kernels.ssm_scan import scan as kscan  # noqa: E402
from repro_torch.kernels.stream_conv import conv as kconv  # noqa: E402
from repro_torch.kernels.stream_conv import legacy as klegacy  # noqa: E402
from repro_torch.models import moe as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=2e-2)
BF16_REL = 1e-2
BF16_OVER_CPU = 2.0
ARCHS = [n for n in ARCH_IDS if n != "falcon-mamba-7b"]
KERNELS = (kconv, kpow2, kscan, klegacy)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and the CUDA toolkit")
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return None if tree is None else tree.to(dev)


def _inputs(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = torch.from_numpy(
            (rng.normal(size=(b, cfg.n_prefix_tokens, cfg.d_model)) * 0.1).astype(np.float32))
    if cfg.family == "encdec":
        kw["encoder_frames"] = torch.from_numpy(
            (rng.normal(size=(b, cfg.encoder_seq, cfg.d_model)) * 0.1).astype(np.float32))
    return toks, kw, (cfg.n_prefix_tokens if cfg.family == "vlm" else 0)


def _run(params, cfg, toks, kw, n_pre, dev):
    """(full-forward logits, prefill logits, decode logits) on ``dev``."""
    toks = toks.to(dev)
    kw = {k: v.to(dev) for k, v in kw.items()}
    p = _to(params, dev)
    s = toks.shape[1]
    h, _, _ = T.forward_hidden(p, cfg, toks, **kw)
    full = T.unembed(p, cfg, h)
    lp, cache = T.prefill(p, cfg, toks[:, : s - 1], max_len=n_pre + s + 2, **kw)
    ld, _ = T.decode_step(p, cfg, toks[:, s - 1:], cache, n_pre + s - 1)
    return [t.float().cpu() for t in (full, lp, ld)]


def _rel(got, want):
    return float((got - want).norm() / want.norm())


def _reduced(name, **kw):
    cfg = get_arch(name).scaled_down(**kw)
    if cfg.n_experts and "capacity_factor" not in kw:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)  # drop-free
    return cfg


@pytest.mark.card
@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_on_the_card_matches_the_cpu(card, name, dtype):
    """forward_hidden, prefill and decode_step on the card against the CPU,
    and no port kernel launched (these architectures run none)."""
    cfg = _reduced(name, dtype=dtype)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, kw, n_pre = _inputs(cfg, 2, 12, seed=1)
    for m in KERNELS:
        m.reset_launch_counts()
    got = _run(params, cfg, toks, kw, n_pre, card)
    assert all(v == 0 for m in KERNELS for v in m.LAUNCHES.values())
    want = _run(params, cfg, toks, kw, n_pre, torch.device("cpu"))
    if dtype == "float32":
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, **F32)
        return
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    exact = _run(_f32(params), cfg32, toks, kw, n_pre, torch.device("cpu"))
    for g, w, e in zip(got, want, exact):
        card_d, cpu_d = _rel(g, e), _rel(w, e)
        assert card_d < max(BF16_REL, BF16_OVER_CPU * cpu_d), (card_d, cpu_d)
    # The card's own prefill and decode against its full forward.
    s = toks.shape[1]
    torch.testing.assert_close(got[1], got[0][:, n_pre + s - 2], **BF16)
    torch.testing.assert_close(got[2], got[0][:, n_pre + s - 1], **BF16)


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f32(v) for v in tree]
    return None if tree is None else tree.float()


@pytest.mark.card
@pytest.mark.parametrize("prompt", [7, 9])
def test_wrapped_ring_buffer_on_the_card(card, prompt):
    """recurrentgemma with a 4-token window after a prompt longer than the
    window: decode on the card equals the card's full forward and the
    CPU's decode."""
    cfg = get_arch("recurrentgemma-9b").scaled_down(window=4)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, kw, n_pre = _inputs(cfg, 2, prompt + 1, seed=2)
    full, lp, ld = _run(params, cfg, toks, kw, n_pre, card)
    _, lp_cpu, ld_cpu = _run(params, cfg, toks, kw, n_pre, torch.device("cpu"))
    torch.testing.assert_close(ld, full[:, prompt], **F32)
    torch.testing.assert_close(lp, full[:, prompt - 1], **F32)
    torch.testing.assert_close(ld, ld_cpu, **F32)
    torch.testing.assert_close(lp, lp_cpu, **F32)


@pytest.mark.card
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "llama4-scout-17b-a16e"])
def test_moe_with_drops_on_the_card_matches_the_cpu(card, name):
    """The configs' own capacity factor 1.25, where experts drop tokens:
    the card's MoE layer, forward and serving path equal the CPU's."""
    cfg = get_arch(name).scaled_down()
    assert cfg.capacity_factor == 1.25
    spec = T._moe_spec(cfg)
    p = M.init_moe(torch.Generator().manual_seed(3), spec, device="cpu")
    x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(4))
    y_cpu, aux_cpu = M.moe_apply(p, spec, x)
    y, aux = M.moe_apply(_to(p, card), spec, x.to(card))
    torch.testing.assert_close(y.cpu(), y_cpu, **F32)
    torch.testing.assert_close(aux.cpu(), aux_cpu, **F32)
    # Some token lost a slot: the drop path ran.
    probs = torch.softmax(x @ p["router"], -1)
    ids = M._top_k(probs, spec.top_k)[1].reshape(2, -1)
    assert int((M._expert_positions(ids, spec.n_experts) >= spec.capacity(24)).sum()) > 0
    params = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    toks, kw, n_pre = _inputs(cfg, 2, 16, seed=5)
    for g, w in zip(_run(params, cfg, toks, kw, n_pre, card),
                    _run(params, cfg, toks, kw, n_pre, torch.device("cpu"))):
        torch.testing.assert_close(g, w, **F32)
