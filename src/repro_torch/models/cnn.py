"""CNN substrate in PyTorch: the paper's three benchmark networks plus the
non-paper generalization topologies (the counterpart of
``repro.models.cnn``).

Topologies (paper Table 1):

  LeNet5   : 28x28x1  -> conv(20,5) mpool tanh -> conv(50,5) mpool tanh -> FC
  Cifar10  : 32x32x3  -> conv(32,5) mpool tanh -> conv(32,5) mpool tanh
                       -> conv(64,5) mpool tanh -> FC
  SVHN     : same topology as Cifar10 (different learned kernel values).

plus ``CIFAR10_FULL`` (Caffe's cifar10_full: overlapping 3x3/stride-2
max-pool) and ``CIFAR10_STRIDED`` (stride-2 downsampling convs), and
``VGG16`` (configuration D of Simonyan & Zisserman, arXiv:1409.1556,
Table 1: 13 3x3 SAME relu convs at 224x224x3, a relu classifier head),
which stays out of ``ALL_TOPOLOGIES`` so that the loops over every
topology do not run a 224x224 network.

``fc_act`` is the activation between the head's FC layers, in the conv
layers' vocabulary (``tanh`` by default, as the paper's networks have it).

Parameters are a plain dict ``{"conv": [{"w", "b"}...], "fc": [...]}``
with the reference's layouts: HWIO conv kernels, ``(in, out)`` FC weights;
activations are NHWC. ``cnn_apply`` lowers through ``compile_dhm`` and
runs the plan; ``cnn_apply_reference`` is the hand-composed forward pass
(separate conv / bias / pool / act / fake-quant ops) kept free of the
compiler and the kernels.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.quant.fixed_point import (
    FixedPointSpec,
    fake_quant_dynamic,
    fake_quant_ste,
)
from repro_torch.core.quant.pow2 import project_pow2_ste
from repro_torch.kernels.backends import resolve_device
from repro_torch.kernels.stream_conv.halo import same_pads
from repro_torch.tree_util import tree_map


@dataclasses.dataclass(frozen=True)
class ConvLayerSpec:
    """One conv+mpool+act stage (a row of paper Table 1, generalized).

    ``pool`` is the square max-pool window (0 = no pool) and
    ``pool_stride`` its sliding stride; ``pool_stride=None`` means
    window == stride. ``stride`` is the conv stride.
    """

    n_out: int  # N: output feature maps
    kernel: int  # K
    padding: str = "VALID"  # VALID (LeNet5) or SAME (Cifar10/SVHN)
    pool: int = 2  # mpool window (0 = no pool)
    act: str = "tanh"
    stride: int = 1  # conv stride
    pool_stride: int | None = None  # None -> == pool (window == stride)

    @property
    def pool_cfg(self) -> tuple:
        """Concrete ``(window, stride)`` pool pair; ``(0, 0)`` = no pool."""
        if not self.pool:
            return (0, 0)
        ps = self.pool if self.pool_stride is None else self.pool_stride
        return (self.pool, ps)

    def out_hw(self, h: int, w: int) -> tuple:
        """(H, W) after this layer's conv + pool, from an (H, W) input."""
        h_c, w_c = self.conv_hw(h, w)
        pw, ps = self.pool_cfg
        if pw:
            return (h_c - pw) // ps + 1, (w_c - pw) // ps + 1
        return h_c, w_c

    def conv_hw(self, h: int, w: int) -> tuple:
        """(H, W) after the conv alone (pre-pool)."""
        s = self.stride
        if self.padding == "SAME":
            return -(-h // s), -(-w // s)
        return (h - self.kernel) // s + 1, (w - self.kernel) // s + 1


@dataclasses.dataclass(frozen=True)
class CNNTopology:
    name: str
    input_hw: object  # int (square frame) or (H, W) tuple
    input_channels: int
    conv_layers: tuple
    fc_dims: tuple  # hidden FC dims of the classifier head
    n_classes: int
    fc_act: str = "tanh"  # activation between the head's FC layers

    def __post_init__(self):
        hw = self.input_hw
        ok = isinstance(hw, int) or (
            isinstance(hw, tuple) and len(hw) == 2
            and all(isinstance(d, int) for d in hw)
        )
        if not ok:
            raise ValueError(
                f"{self.name}: input_hw must be an int (square frame) or an "
                f"(H, W) tuple of ints, got {hw!r}"
            )

    @property
    def input_shape(self) -> tuple:
        """(H, W) of the input frame (int sugar means square)."""
        if isinstance(self.input_hw, int):
            return (self.input_hw, self.input_hw)
        return self.input_hw

    def square_input_hw(self) -> int:
        """The square frame side; raises on a rectangular frame, for the
        paths (the synthetic datasets) that need a square one."""
        h, w = self.input_shape
        if h != w:
            raise ValueError(
                f"{self.name}: this path requires a square input frame, "
                f"got {h}x{w}"
            )
        return h

    def conv_shapes(self):
        """Per-layer (C_in, N_out, K, H_out, W_out) after conv (pre-pool)."""
        h, w = self.input_shape
        c = self.input_channels
        out = []
        for spec in self.conv_layers:
            h_conv, w_conv = spec.conv_hw(h, w)
            out.append((c, spec.n_out, spec.kernel, h_conv, w_conv))
            h, w = spec.out_hw(h, w)
            c = spec.n_out
        return out

    def feature_shape(self) -> tuple:
        """(H, W, C) of the feature-extractor output (FC head input)."""
        h, w = self.input_shape
        c = self.input_channels
        for spec in self.conv_layers:
            h, w = spec.out_hw(h, w)
            c = spec.n_out
        return h, w, c

    def feature_extractor_macs(self) -> int:
        """MACs of the conv stack for one input frame."""
        return sum(c * n * k * k * h * w for (c, n, k, h, w) in self.conv_shapes())

    def feature_extractor_ops(self) -> int:
        """Ops (1 MAC = 2 ops) — the paper's 'Workload' column in Table 4."""
        return 2 * self.feature_extractor_macs()

    def n_multipliers(self) -> int:
        """Multipliers a full DHM instantiation needs: N*C*K*K per layer."""
        return sum(c * n * k * k for (c, n, k, _, _) in self.conv_shapes())


LENET5 = CNNTopology(
    name="lenet5",
    input_hw=28,
    input_channels=1,
    conv_layers=(
        ConvLayerSpec(n_out=20, kernel=5, padding="VALID"),
        ConvLayerSpec(n_out=50, kernel=5, padding="VALID"),
    ),
    fc_dims=(500,),
    n_classes=10,
)

CIFAR10 = CNNTopology(
    name="cifar10",
    input_hw=32,
    input_channels=3,
    conv_layers=(
        ConvLayerSpec(n_out=32, kernel=5, padding="SAME"),
        ConvLayerSpec(n_out=32, kernel=5, padding="SAME"),
        ConvLayerSpec(n_out=64, kernel=5, padding="SAME"),
    ),
    fc_dims=(64,),
    n_classes=10,
)

SVHN = dataclasses.replace(CIFAR10, name="svhn")

PAPER_TOPOLOGIES = {"lenet5": LENET5, "cifar10": CIFAR10, "svhn": SVHN}

CIFAR10_FULL = CNNTopology(
    name="cifar10_full",
    input_hw=32,
    input_channels=3,
    conv_layers=(
        ConvLayerSpec(n_out=32, kernel=5, padding="SAME", pool=3,
                      pool_stride=2, act="relu"),
        ConvLayerSpec(n_out=32, kernel=5, padding="SAME", pool=3,
                      pool_stride=2, act="relu"),
        ConvLayerSpec(n_out=64, kernel=5, padding="SAME", pool=3,
                      pool_stride=2, act="relu"),
    ),
    fc_dims=(64,),
    n_classes=10,
)

CIFAR10_STRIDED = CNNTopology(
    name="cifar10_strided",
    input_hw=32,
    input_channels=3,
    conv_layers=(
        ConvLayerSpec(n_out=32, kernel=5, padding="SAME", stride=2, pool=0,
                      act="relu"),
        ConvLayerSpec(n_out=64, kernel=3, padding="SAME", stride=2, pool=0,
                      act="relu"),
        ConvLayerSpec(n_out=64, kernel=3, padding="SAME", pool=2,
                      act="relu"),
    ),
    fc_dims=(64,),
    n_classes=10,
)

EXTRA_TOPOLOGIES = {
    "cifar10_full": CIFAR10_FULL,
    "cifar10_strided": CIFAR10_STRIDED,
}
ALL_TOPOLOGIES = {**PAPER_TOPOLOGIES, **EXTRA_TOPOLOGIES}


VGG16 = CNNTopology(
    name="vgg16",
    input_hw=224,
    input_channels=3,
    conv_layers=tuple(
        ConvLayerSpec(n_out=n, kernel=3, padding="SAME", pool=pool, act="relu")
        for n, pool in ((64, 0), (64, 2), (128, 0), (128, 2), (256, 0), (256, 0),
                        (256, 2), (512, 0), (512, 0), (512, 2), (512, 0), (512, 0),
                        (512, 2))
    ),
    fc_dims=(4096, 4096),
    n_classes=1000,
    fc_act="relu",
)


def init_cnn(generator: torch.Generator, topo: CNNTopology, *, device=None) -> dict:
    """Glorot-style init (normal * sqrt(2 / fan_in), zero biases) drawn
    from ``generator`` (a CPU ``torch.Generator``) and moved to ``device``
    (the card unless ``device="cpu"``). Layout: conv kernels HWIO
    (K, K, C, N); FC weights (in, out). The numbers differ from the
    reference's ``jax.random`` streams: to compare the two packages, build
    the params once and carry them across with ``convert.params_from_numpy``."""
    dev = resolve_device(device)

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (w * math.sqrt(2.0 / fan_in)).to(dev)

    params: dict = {"conv": [], "fc": []}
    c = topo.input_channels
    for spec in topo.conv_layers:
        w = normal((spec.kernel, spec.kernel, c, spec.n_out),
                   spec.kernel * spec.kernel * c)
        params["conv"].append(
            {"w": w, "b": torch.zeros(spec.n_out, device=dev)}
        )
        c = spec.n_out
    h, w_, c = topo.feature_shape()
    dims = (h * w_ * c,) + tuple(topo.fc_dims) + (topo.n_classes,)
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        params["fc"].append(
            {"w": normal((d_in, d_out), d_in),
             "b": torch.zeros(d_out, device=dev)}
        )
    return params


def quantize_cnn_params(params: dict, bits: int) -> dict:
    """Fake-quantize all parameters with per-tensor dynamic power-of-two
    scales (STE gradients)."""
    return {
        group: [
            {name: fake_quant_dynamic(t, bits) for name, t in p.items()}
            for p in layers
        ]
        for group, layers in params.items()
    }


def export_cnn_specs(params: dict, bits: int) -> dict:
    """Static per-tensor FixedPointSpec tree for a *trained* model (the
    offline Q-format the paper's synthesis flow consumes)."""
    return tree_map(lambda p: FixedPointSpec.for_tensor(p, bits), params)


def cnn_apply(
    params: dict,
    topo: CNNTopology,
    x: torch.Tensor,
    *,
    weight_bits: int | None = None,
    act_bits: int | None = None,
    pow2_weights: bool = False,
    vmem_budget: int | None = None,
) -> torch.Tensor:
    """Forward pass through the DHM compiler on the device of ``x``.
    x: (B, H, W, C) NHWC -> logits (B, n_classes). ``pow2_weights``
    projects every weight onto the {0, ±2^k} codebook (STE) and runs the FC
    head through the packed ``pow2_matmul`` kernel."""
    from repro_torch.core.dhm.compiler import QuantSpec, compile_dhm
    from repro_torch.core.dhm.engine import forward

    plan = compile_dhm(
        topo, params,
        quant=QuantSpec(
            weight_bits=weight_bits, act_bits=act_bits, pow2_weights=pow2_weights
        ),
        device=x.device, vmem_budget=vmem_budget,
    )
    return forward(plan, x)


def cnn_apply_reference(
    params: dict,
    topo: CNNTopology,
    x: torch.Tensor,
    *,
    weight_bits: int | None = None,
    act_bits: int | None = None,
    pow2_weights: bool = False,
) -> torch.Tensor:
    """The hand-composed forward pass (separate conv / bias / pool / act /
    fake-quant ops) — the oracle compiled plans are tested against."""
    if pow2_weights:
        params = {
            group: [
                {name: project_pow2_ste(t) if t.ndim > 1 else t for name, t in p.items()}
                for p in layers
            ]
            for group, layers in params.items()
        }
    if weight_bits is not None:
        params = quantize_cnn_params(params, weight_bits)

    def maybe_qact(h):
        if act_bits is None:
            return h
        return fake_quant_ste(h, FixedPointSpec(bits=act_bits, frac_bits=act_bits - 2))

    act = {"tanh": torch.tanh, "relu": F.relu, "none": lambda t: t}
    fc_act = act[topo.fc_act]
    h = x.to(torch.float32)
    for spec, p in zip(topo.conv_layers, params["conv"]):
        if spec.padding == "SAME":
            k, s = spec.kernel, spec.stride
            ph, pw_ = same_pads(h.shape[1], s, k), same_pads(h.shape[2], s, k)
            h = F.pad(h, (0, 0, pw_[0], pw_[1], ph[0], ph[1]))
        h = F.conv2d(
            h.permute(0, 3, 1, 2), p["w"].permute(3, 2, 0, 1),
            stride=spec.stride,
        )
        h = h + p["b"][:, None, None]
        pw, ps = spec.pool_cfg
        if pw:
            h = F.max_pool2d(h, kernel_size=pw, stride=ps)
        h = maybe_qact(act[spec.act](h)).permute(0, 2, 3, 1)
    h = h.reshape(h.shape[0], -1)
    for i, p in enumerate(params["fc"]):
        h = h @ p["w"] + p["b"]
        if i < len(params["fc"]) - 1:
            h = maybe_qact(fc_act(h))
    return h
