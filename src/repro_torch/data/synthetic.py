"""Deterministic synthetic datasets.

No MNIST, CIFAR or SVHN ships with the repo, so the paper's CNN
experiments train on a *structured* synthetic classification task: each
class is a smooth random template; samples are template x per-sample gain
+ noise. The task is (a) learnable by the paper's topologies and (b) hard
enough that accuracy degrades as bit-width shrinks, which is the property
Fig. 3 measures.

The image data is drawn on the host from a ``torch.Generator`` seeded by
``seed``, with the reference's recipe (``repro.data.synthetic``): the same
shapes, the same distributions, other numbers (the reference draws from
``jax.random``). To run both packages on the same frames, carry the
reference's arrays across (a ``SyntheticImageDataset`` of numpy arrays
works wherever one of tensors does).

For LM training, ``synthetic_token_batches`` yields an affine-recurrence
token stream with injected noise: next = (a * prev + b) mod V with
probability (1-eps), uniform otherwise. It is the reference's numpy
generator, batch for batch.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SyntheticImageDataset:
    x_train: torch.Tensor  # (N, H, W, C) float32 in [-2, 2]
    y_train: torch.Tensor  # (N,) int32
    x_test: torch.Tensor
    y_test: torch.Tensor
    n_classes: int


def _smooth_field(gen: torch.Generator, hw: int, channels: int, cutoff: int = 6):
    """Low-frequency random field: random spectrum, zeroed high frequencies."""
    spec = torch.randn((hw, hw, channels, 2), generator=gen)
    spec = torch.complex(spec[..., 0], spec[..., 1])
    fx = torch.fft.fftfreq(hw) * hw
    mask = (fx.abs()[:, None] <= cutoff) & (fx.abs()[None, :] <= cutoff)
    spec = spec * mask[..., None]
    field = torch.fft.ifft2(spec, dim=(0, 1)).real
    field = field / (field.abs().amax(dim=(0, 1), keepdim=True) + 1e-9)
    return field.to(torch.float32)


def make_image_dataset(
    *,
    hw: int,
    channels: int,
    n_classes: int = 10,
    n_train_per_class: int = 256,
    n_test_per_class: int = 64,
    noise: float = 1.3,
    seed: int = 0,
) -> SyntheticImageDataset:
    gen = torch.Generator().manual_seed(seed)
    templates = torch.stack(
        [_smooth_field(gen, hw, channels) for _ in range(n_classes)]
    )  # (n_classes, H, W, C)

    def _make_split(n_per_class):
        n = n_classes * n_per_class
        y = torch.arange(n_classes, dtype=torch.int32).repeat(n_per_class)
        eps = torch.randn((n, hw, hw, channels), generator=gen) * noise
        # Per-sample random gain in [0.7, 1.3] to prevent trivial matching.
        gain = 0.7 + 0.6 * torch.rand((n, 1, 1, 1), generator=gen)
        x = templates[y.long()] * gain + eps
        return torch.clamp(x, -2.0, 2.0).to(torch.float32), y

    x_train, y_train = _make_split(n_train_per_class)
    x_test, y_test = _make_split(n_test_per_class)
    return SyntheticImageDataset(x_train, y_train, x_test, y_test, n_classes)


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    noise_eps: float = 0.15
    mult: int = 31  # recurrence multiplier (coprime with typical vocabs)
    add: int = 7

    @property
    def loss_floor(self) -> float:
        """Conditional entropy of the stream in nats (optimal model loss)."""
        e, v = self.noise_eps, self.vocab_size
        p_correct = (1 - e) + e / v
        p_other = e / v
        return float(
            -(p_correct * np.log(p_correct) + (v - 1) * p_other * np.log(p_other))
        )


def synthetic_token_batches(
    cfg: TokenStreamConfig, *, seed: int = 0
) -> Iterator[dict]:
    """Infinite iterator of {'tokens': (B, T+1) int32} batches (host-side
    numpy, as a real host-input pipeline feeds the loader)."""
    rng = np.random.default_rng(seed)
    v = cfg.vocab_size
    while True:
        start = rng.integers(0, v, size=(cfg.batch_size, 1))
        toks = [start]
        for _ in range(cfg.seq_len):
            nxt = (toks[-1] * cfg.mult + cfg.add) % v
            flip = rng.random((cfg.batch_size, 1)) < cfg.noise_eps
            rand = rng.integers(0, v, size=(cfg.batch_size, 1))
            toks.append(np.where(flip, rand, nxt))
        yield {"tokens": np.concatenate(toks, axis=1).astype(np.int32)}
