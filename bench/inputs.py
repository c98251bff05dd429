"""What a run is given: weights and frames, made on the device from the seed.

The weights follow the port's ``init_cnn`` arithmetic (normal draws times
sqrt(2 / fan_in); HWIO conv kernels, (in, out) FC weights), drawn from a
``torch.Generator`` on the run's device in one call for all weights and
one for all biases. The frames follow the recipe of the port's
``data/synthetic.py`` ``make_image_dataset``: each class a smooth random
template (a random spectrum with its high frequencies zeroed), each frame
its class's template times a gain in [0.7, 1.3] plus normal noise,
clipped to [-2, 2], and then, as a decoded image is, held in
``pixel_bits`` bits: rounded to the grid of 4 / 2^pixel_bits. Frames with
these value ranges matter: the quantizers' scales and codes depend on
them.

One seed gives the same weights and frames on every run; the program and
the reference are both handed these tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from bench.count import cnn as count


def sub_seeds(seed: int, n: int = 8) -> list:
    """``n`` independent 63-bit seeds from any whole number."""
    state = np.random.SeedSequence(seed % 2**64).generate_state(n, dtype=np.uint64)
    return [int(s) >> 1 for s in state]


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=torch.device(device)).manual_seed(seed)


def make_params(topo: dict, init: dict, seed: int, device) -> dict:
    """``{"conv": [{"w", "b"}...], "fc": [{"w", "b"}...]}`` float32 tensors on
    ``device``: weights normal * sqrt(2 / fan_in), biases normal *
    ``init["bias_std"]``."""
    shapes, fans = [], []
    for c, n, k, *_ in count.conv_shapes(topo):
        shapes.append((k, k, c, n))
        fans.append(k * k * c)
    for i, o in count.fc_dims(topo):
        shapes.append((i, o))
        fans.append(i)
    gen = generator(seed, device)
    sizes = [math.prod(s) for s in shapes]
    flat_w = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    biases = [s[-1] for s in shapes]
    flat_b = torch.randn(sum(biases), generator=gen, device=device, dtype=torch.float32)
    flat_b *= float(init.get("bias_std", 0.0))
    ws = [w.reshape(s) * math.sqrt(2.0 / f)
          for w, s, f in zip(torch.split(flat_w, sizes), shapes, fans)]
    bs = [b.clone() for b in torch.split(flat_b, biases)]
    n_conv = len(topo["conv_layers"])
    return {
        "conv": [{"w": w, "b": b} for w, b in zip(ws[:n_conv], bs[:n_conv])],
        "fc": [{"w": w, "b": b} for w, b in zip(ws[n_conv:], bs[n_conv:])],
    }


def _templates(topo: dict, spec: dict, gen: torch.Generator, device) -> torch.Tensor:
    """(n_classes, H, W, C) smooth fields, each channel's max |value| 1."""
    h, w, c = count.input_hwc(topo)
    if h != w:
        raise ValueError(f"{topo['name']}: the frame recipe needs a square frame")
    n = spec["n_classes"]
    raw = torch.randn((n, h, w, c, 2), generator=gen, device=device)
    field = torch.complex(raw[..., 0], raw[..., 1])
    f = torch.fft.fftfreq(h, device=device) * h
    keep = (f.abs()[:, None] <= spec["cutoff"]) & (f.abs()[None, :] <= spec["cutoff"])
    field = torch.fft.ifft2(field * keep[None, :, :, None], dim=(1, 2)).real
    field = field / (field.abs().amax(dim=(1, 2), keepdim=True) + 1e-9)
    return field.to(torch.float32)


def make_frames(topo: dict, spec: dict, n: int, seed: int, device) -> tuple:
    """(frames (n, H, W, C) float32, labels (n,) int64) on ``device``; labels
    cycle through the classes."""
    gen = generator(seed, device)
    templates = _templates(topo, spec, gen, device)
    y = torch.arange(n, device=device) % spec["n_classes"]
    lo, hi = spec["gain"]
    h, w, c = count.input_hwc(topo)
    x = torch.randn((n, h, w, c), generator=gen, device=device)
    x *= spec["noise"]
    gain = lo + (hi - lo) * torch.rand((n, 1, 1, 1), generator=gen, device=device)
    x += templates[y] * gain
    x.clamp_(-spec["clip"], spec["clip"])
    levels = 2 ** spec["pixel_bits"]
    step = 2 * spec["clip"] / levels
    x = torch.clamp(torch.round(x / step), -levels // 2, levels // 2 - 1) * step
    return x, y
