"""The plain reference of the CNN configurations: plain PyTorch only.

It imports nothing of the program and takes nothing the program made: it
works out again, from the float weights and the frames that the benchmark
made, the quantized weights, their power-of-two scales, the integer codes
and the stream's codes.

Quantization, as the paper's fixed-point formats state it:

- A tensor quantized to ``bits`` with a dynamic scale takes the exponent
  m = ceil(log2(max(max |t|, 1e-12))) and the scale 2^(m - (bits - 1));
  its codes are clip(round(t / scale), -2^(bits-1), 2^(bits-1) - 1),
  rounding half to even.
- The feature stream of ``bits`` has the scale 2^-(bits - 2) and the same
  clip.

Inference (:func:`int8_forward`): the conv layers in integers (input codes
times weight codes, summed exactly, in float64 where every such sum is an
exact integer), each window's max of the sums, dequantized by one exact
power-of-two product and the float32 bias, tanh in float32, re-quantized
onto the stream; the FC head on the stream values and the fake-quantized
weights, whose products float32 sums exactly (:func:`_head`), the bias,
tanh and the stream's quantization in float32. Every step is exact or one
float32 rounding that the configuration states, so the program's logits
must equal these bit for bit (``bench/correct.py``).

Training (:func:`qat_steps`): the quantization-aware forward (fake-quant
weights and stream, straight-through gradients inside the clip range) in
float32 with each product's sums rounded once, then cross entropy,
autograd, clipping at global norm 1 and AdamW in float64.

``precision="tf32"``: the same computation with the operands of every
product rounded to TF32 (10 mantissa bits) and the rest in float32, the
step below the float32 with TF32 off that the configurations state: the
training cells' control (``bench/control.py``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

U32 = 2.0 ** -24  # float32's unit roundoff


def exponent(t: torch.Tensor) -> int:
    """ceil(log2(max(max |t|, 1e-12)))."""
    v = max(float(t.detach().abs().max()), 1e-12)
    return math.ceil(math.log2(v))


def dynamic_scale(t: torch.Tensor, bits: int) -> float:
    return 2.0 ** (exponent(t) - (bits - 1))


def stream_scale(bits: int) -> float:
    return 2.0 ** -(bits - 2)


def code_range(bits: int) -> tuple:
    return -(2 ** (bits - 1)), 2 ** (bits - 1) - 1


def codes(t: torch.Tensor, scale: float, bits: int) -> torch.Tensor:
    lo, hi = code_range(bits)
    return torch.clamp(torch.round(t / scale), lo, hi)


def fake_quant(t: torch.Tensor, bits: int) -> torch.Tensor:
    """``t`` on its dynamic ``bits`` grid (values, no gradient)."""
    scale = dynamic_scale(t, bits)
    return codes(t, scale, bits) * scale


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return r.view(torch.float32)


def _same_pads(d: int, stride: int, k: int) -> tuple:
    total = max((-(-d // stride) - 1) * stride + k - d, 0)
    return total // 2, total - total // 2


def _pad(x: torch.Tensor, layer: dict) -> torch.Tensor:
    """Pad an NCHW tensor as the layer's padding says."""
    if layer["padding"] == "VALID":
        return x
    s, k = layer.get("stride", 1), layer["kernel"]
    ph = _same_pads(x.shape[2], s, k)
    pw = _same_pads(x.shape[3], s, k)
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]))


def _pool(x: torch.Tensor, layer: dict) -> torch.Tensor:
    pw = layer.get("pool", 0)
    if not pw:
        return x
    ps = layer.get("pool_stride") or pw
    return F.max_pool2d(x, kernel_size=pw, stride=ps)


def _act(x: torch.Tensor, layer: dict) -> torch.Tensor:
    if layer["act"] == "tanh":
        return torch.tanh(x)
    if layer["act"] == "relu":
        return torch.maximum(x, x.new_zeros(()))
    return x


# ---------------------------------------------------------------------------
# Inference: integer conv layers, float head


def int8_features(cfg: dict, params: dict, x: torch.Tensor) -> torch.Tensor:
    """The conv layers of ``cfg["infer_quant"]`` on NHWC frames ``x``: the
    last layer's stream values, (B, H, W, C) float64."""
    topo, q = cfg["topology"], cfg["infer_quant"]
    wb, ab = q["weight_bits"], q["act_bits"]
    s = stream_scale(ab)  # every layer's input and output stream
    h = codes(x.to(torch.float32), s, ab).to(torch.float64).permute(0, 3, 1, 2)
    for layer, p in zip(topo["conv_layers"], params["conv"]):
        w = p["w"].to(torch.float32)
        w_scale = dynamic_scale(w, wb)
        w_codes = codes(w, w_scale, wb).to(torch.float64).permute(3, 2, 0, 1)
        b = fake_quant(p["b"].to(torch.float32), wb)
        acc = torch.round(F.conv2d(_pad(h, layer), w_codes, stride=layer.get("stride", 1)))
        # Every activation is monotone: the max of the exact sums, then the
        # epilogue, equals the epilogue, then the max.
        y = _pool(acc, layer).to(torch.float32) * (s * w_scale) + b[:, None, None]
        h = codes(_act(y, layer), s, ab).to(torch.float64)
    return (h * s).permute(0, 2, 3, 1)


def _head(cfg: dict, params: dict, feats: torch.Tensor, *, precision: str) -> torch.Tensor:
    """The FC head on flattened features: float32 logits. Each product sums
    stream values times fake-quantized weights, multiples of one power of
    two whose sums stay under 2^24 of it: float32 holds every partial sum
    exactly, in any order, so the sum is taken exactly (float64) and is the
    float32 one. The bias is then added in float32, tanh taken in float32
    and the stream re-quantized, as the configuration states. Under
    ``precision="tf32"`` the sums take TF32-rounded operands."""
    q, n_fc = cfg["infer_quant"], len(params["fc"])
    wb, ab = q["weight_bits"], q["act_bits"]
    s = stream_scale(ab)
    lo, hi = code_range(ab)
    h = feats.reshape(feats.shape[0], -1).to(torch.float32)
    for i, p in enumerate(params["fc"]):
        w32 = p["w"].to(torch.float32)
        w_scale = dynamic_scale(w32, wb)
        w = codes(w32, w_scale, wb) * w_scale
        b = fake_quant(p["b"].to(torch.float32), wb)
        if precision == "tf32":
            h, w = round_tf32(h), round_tf32(w)
        quantum = w_scale * s  # features and hidden units both lie on the stream grid
        exact = h.to(torch.float64) @ w.to(torch.float64)
        bound = (h.to(torch.float64).abs() @ w.to(torch.float64).abs()).max()
        if precision != "tf32" and float(bound) >= 2.0 ** 24 * quantum:
            raise ValueError("the head's float32 sums are not exact at this width")
        pre = exact.to(torch.float32) + b
        if i == n_fc - 1:
            return pre
        t = torch.tanh(pre)
        h = torch.clamp(torch.round(t / s), lo, hi) * s
    raise ValueError("a head needs at least one FC layer")


@torch.no_grad()
def int8_forward(cfg: dict, params: dict, x: torch.Tensor, *, precision: str = "fp32",
                 block: int = 4096) -> torch.Tensor:
    """Float32 logits (B, n_classes) of NHWC frames ``x``, in blocks of
    ``block`` frames."""
    return torch.cat([_head(cfg, params, int8_features(cfg, params, x[i:i + block]),
                            precision=precision)
                      for i in range(0, x.shape[0], block)])


# ---------------------------------------------------------------------------
# Training: quantization-aware steps


class _STE(torch.autograd.Function):
    """clip(round(x / scale)) * scale; the gradient passes where x lies in
    the clip range and is zero outside it."""

    @staticmethod
    def forward(ctx, x, scale: float, bits: int):
        lo, hi = code_range(bits)
        ctx.save_for_backward((x >= lo * scale) & (x <= hi * scale))
        return torch.clamp(torch.round(x / scale), lo, hi) * scale

    @staticmethod
    def backward(ctx, g):
        (inside,) = ctx.saved_tensors
        return torch.where(inside, g, torch.zeros_like(g)), None, None


class _RoundTF32(torch.autograd.Function):
    """A product's operand rounded to TF32; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradTF32(torch.autograd.Function):
    """A product's output, unchanged; the gradient that the backward's two
    products take as an operand is rounded to TF32."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def _product(op, a: torch.Tensor, b: torch.Tensor, precision: str, **kw) -> torch.Tensor:
    """A float32 product (a conv or a matmul). ``"fp32"``: the sums taken in
    float64 and rounded once to float32; most of them are exact, as in
    float32 (8-bit frames and stream values times fake-quantized weights).
    ``"tf32"``: every operand of the product and of its backward's two
    products rounded to TF32, the sums in float32."""
    if precision == "tf32":
        return _GradTF32.apply(op(_RoundTF32.apply(a), _RoundTF32.apply(b), **kw))
    return op(a.double(), b.double(), **kw).float()


def qat_logits(cfg: dict, params: dict, x: torch.Tensor, *, precision: str = "fp32"):
    """The quantization-aware forward of ``cfg["train_quant"]``: float32
    logits of NHWC frames ``x`` from float32 ``params`` (with gradients).
    The bias, tanh, the pools and the fake-quantizers run in float32, as
    the configuration states, so that a value lands on the same side of a
    quantizer's rounding boundary as the program's does."""
    topo, q = cfg["topology"], cfg["train_quant"]
    wb, ab = q.get("weight_bits"), q.get("act_bits")

    def wq(t):
        return t if wb is None else _STE.apply(t, dynamic_scale(t, wb), wb)

    def aq(t):
        return t if ab is None else _STE.apply(t, stream_scale(ab), ab)

    h = x.to(torch.float32).permute(0, 3, 1, 2)
    for layer, p in zip(topo["conv_layers"], params["conv"]):
        w = wq(p["w"]).permute(3, 2, 0, 1)
        h = _product(F.conv2d, _pad(h, layer), w, precision, stride=layer.get("stride", 1))
        h = aq(_pool(_act(h + wq(p["b"])[:, None, None], layer), layer))
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    for i, p in enumerate(params["fc"]):
        h = _product(torch.matmul, h, wq(p["w"]), precision) + wq(p["b"])
        if i < len(params["fc"]) - 1:
            h = aq(torch.tanh(h))
    return h


def leaves(tree: dict) -> list:
    """The leaves of a ``{"conv": [...], "fc": [...]}`` tree, in order."""
    return [p[k] for group in ("conv", "fc") for p in tree[group] for k in ("w", "b")]


def unflatten(tree: dict, flat: list) -> dict:
    it = iter(flat)
    return {g: [{k: next(it) for k in ("w", "b")} for _ in tree[g]] for g in ("conv", "fc")}


def learning_rate(mix: dict, step: int) -> float:
    """Linear warmup to ``peak_lr``, then cosine to a tenth of it."""
    peak, warm, total = mix["peak_lr"], mix["warmup_steps"], mix["total_steps"]
    if step < warm:
        return peak * step / max(1, warm)
    t = min(max((step - warm) / max(1, total - warm), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * t)))


def qat_steps(cfg: dict, mix: dict, params: dict, batches: list, *,
              precision: str = "fp32") -> dict:
    """Train from ``params`` (float tensors, left as they are) on
    ``batches``, a list of (frames, labels), one step each: the
    quantization-aware loss, its gradient, clipping at global norm 1 and
    AdamW (b1 0.9, b2 0.95, eps 1e-8, weight decay ``mix["weight_decay"]``)
    at :func:`learning_rate`. Returns each step's loss, the first step's
    clipped gradient and the parameters after the last step, as lists of
    leaves in :func:`leaves` order. The loss, the gradient's sums and AdamW
    run in float64 (``"tf32"``: float32)."""
    dt = torch.float32 if precision == "tf32" else torch.float64
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, mix["weight_decay"]
    ps = [t.detach().to(dt).clone() for t in leaves(params)]
    m = [torch.zeros_like(t) for t in ps]
    v = [torch.zeros_like(t) for t in ps]
    losses, first_grad = [], None
    for step, (x, y) in enumerate(batches):
        ws = [t.clone().requires_grad_() for t in ps]
        logits = qat_logits(cfg, unflatten(params, [w.float() for w in ws]), x,
                            precision=precision).to(dt)
        loss = -torch.gather(F.log_softmax(logits, dim=-1), 1, y.long()[:, None]).mean()
        grads = torch.autograd.grad(loss, ws)
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(1.0 / (norm + 1e-9), max=1.0)
        grads = [g * scale for g in grads]
        if first_grad is None:
            first_grad = [g.detach() for g in grads]
        lr = learning_rate(mix, step)
        t = step + 1
        c1, c2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for i, g in enumerate(grads):
            m[i] = b1 * m[i] + (1 - b1) * g
            v[i] = b2 * v[i] + (1 - b2) * g * g
            upd = (m[i] / c1) / (torch.sqrt(v[i] / c2) + eps)
            ps[i] = ps[i] - lr * (upd + wd * ps[i])
        losses.append(float(loss.detach()))
    return {"losses": losses, "first_grad": first_grad, "params": ps}
