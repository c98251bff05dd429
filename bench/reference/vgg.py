"""The plain reference of a VGG configuration (``bench/configs/vgg16-q8.json``):
plain PyTorch only, with the integer conv stage of :mod:`bench.reference.cnn`.

It imports nothing of the program and takes nothing the program made.

- The conv stage is :func:`bench.reference.cnn.int8_features`: input codes
  times weight codes summed exactly in float64, each window's max, the
  exact power-of-two dequantization, the float32 bias, the layer's
  activation and the stream's re-quantization. It runs in blocks of at
  most ``BLOCK`` frames, which keeps a 224x224x64 float64 activation of a
  block near 400 MB. Its output is exact, so the program's features must
  equal it bit for bit.
- The head takes the configuration's ``fc_act`` between FC layers (relu
  for VGG-16). Each product sums stream values times fake-quantized
  weights in float64 and rounds the sum once to float32; the bias is then
  added in float32, the activation taken in float32 and the stream
  re-quantized, as the configuration states. Unlike
  :func:`bench.reference.cnn.int8_forward` it does not require that
  float32 could hold every partial sum of a 25,088-wide product exactly:
  the program's float32 sums, in cuBLAS's order, are held to these logits
  within a limit (``bench/loops/infer_requests_vgg.py``).
- :func:`float_logits`: the forward of the plans without integer
  compute, float32 (no ``bits``) or fake-quantized (weights and stream at
  ``bits``), each product summed in float64 and rounded once to float32.
- ``precision="bf16"``: the control. Each product's sum is rounded to
  bfloat16 before the bias, the step below the float32 sums that the
  configuration states (the 8-bit operands are exact in TF32 and in
  bfloat16 alike, so rounding the operands would change nothing).

Every product here is in float64, which TF32 never touches; the
functions turn TF32 off all the same while they run, and restore it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import cnn

BLOCK = 16  # frames of one block of the conv stage


class _NoTF32:
    """TF32 off for matmuls and convolutions inside the block, as it was
    after it."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "tanh":
        return torch.tanh(x)
    if name == "relu":
        return torch.maximum(x, x.new_zeros(()))
    return x


@torch.no_grad()
def features(cfg: dict, params: dict, x: torch.Tensor, *, block: int = BLOCK) -> torch.Tensor:
    """The conv stage on NHWC frames ``x``: the last layer's stream values,
    (B, H, W, C) float64, exact."""
    with _NoTF32():
        return torch.cat([cnn.int8_features(cfg, params, x[i:i + block])
                          for i in range(0, x.shape[0], block)])


@torch.no_grad()
def head(cfg: dict, params: dict, feats: torch.Tensor, *, precision: str = "fp32"):
    """Float32 logits (B, n_classes) of the FC head on ``feats``
    (:func:`features`'s output), ``cfg["topology"]["fc_act"]`` between
    its layers."""
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"unknown precision {precision!r}")
    q, n_fc = cfg["infer_quant"], len(params["fc"])
    wb, ab = q["weight_bits"], q["act_bits"]
    s = cnn.stream_scale(ab)
    fc_act = cfg["topology"].get("fc_act", "tanh")
    h = feats.reshape(feats.shape[0], -1).to(torch.float32)
    with _NoTF32():
        for i, p in enumerate(params["fc"]):
            w = cnn.fake_quant(p["w"].to(torch.float32), wb)
            b = cnn.fake_quant(p["b"].to(torch.float32), wb)
            pre = (h.to(torch.float64) @ w.to(torch.float64)).to(torch.float32)
            if precision == "bf16":
                pre = pre.to(torch.bfloat16).to(torch.float32)
            pre = pre + b
            if i == n_fc - 1:
                return pre
            h = cnn.codes(_act(fc_act, pre), s, ab) * s
    raise ValueError("a head needs at least one FC layer")


@torch.no_grad()
def float_logits(cfg: dict, params: dict, x: torch.Tensor, *, bits=None) -> torch.Tensor:
    """Float32 logits of NHWC frames ``x`` through the float layers: each
    conv and FC product summed in float64 and rounded once to float32,
    then the bias, the activation, the pool and, with ``bits``, the
    stream's re-quantization, in float32; with ``bits`` every weight and
    bias fake-quantized to its dynamic ``bits`` grid."""
    topo = cfg["topology"]

    def wq(t):
        return t if bits is None else cnn.fake_quant(t, bits)

    def sq(t):
        if bits is None:
            return t
        s = cnn.stream_scale(bits)
        return cnn.codes(t, s, bits) * s

    with _NoTF32():
        h = x.to(torch.float32).permute(0, 3, 1, 2)
        for layer, p in zip(topo["conv_layers"], params["conv"]):
            w = wq(p["w"].to(torch.float32)).permute(3, 2, 0, 1)
            y = F.conv2d(cnn._pad(h, layer).double(), w.double(),
                         stride=layer.get("stride", 1)).float()
            y = y + wq(p["b"].to(torch.float32))[:, None, None]
            h = sq(cnn._pool(_act(layer["act"], y), layer))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        for i, p in enumerate(params["fc"]):
            h = (h.double() @ wq(p["w"].to(torch.float32)).double()).float()
            h = h + wq(p["b"].to(torch.float32))
            if i < len(params["fc"]) - 1:
                h = sq(_act(topo.get("fc_act", "tanh"), h))
    return h
