"""Work counts of a CNN configuration, from its topology alone.

The benchmark's own copy of the arithmetic of the port's ``CNNTopology``
(``conv_shapes``, ``feature_extractor_macs``): a roofline or an ``mfu``
divides these counts by a peak, so they live with the benchmark, where a
change to the program cannot move them. A topology is the ``topology``
object of a file in ``bench/configs/``.

A MAC is one multiply-add, two operations. Bytes count each input element
read once and each output element written once.
"""
from __future__ import annotations

import dataclasses


def conv_hw(layer: dict, h: int, w: int) -> tuple:
    """(H, W) after the conv of ``layer`` alone, before its pool."""
    s, k = layer.get("stride", 1), layer["kernel"]
    if layer["padding"] == "SAME":
        return -(-h // s), -(-w // s)
    return (h - k) // s + 1, (w - k) // s + 1


def pool_cfg(layer: dict) -> tuple:
    """(window, stride) of the layer's max-pool; (0, 0) for none."""
    pw = layer.get("pool", 0)
    if not pw:
        return 0, 0
    ps = layer.get("pool_stride")
    return pw, (pw if ps is None else ps)


def out_hw(layer: dict, h: int, w: int) -> tuple:
    """(H, W) after the layer's conv and pool."""
    hc, wc = conv_hw(layer, h, w)
    pw, ps = pool_cfg(layer)
    if pw:
        return (hc - pw) // ps + 1, (wc - pw) // ps + 1
    return hc, wc


def input_hwc(topo: dict) -> tuple:
    hw = topo["input_hw"]
    h, w = (hw, hw) if isinstance(hw, int) else tuple(hw)
    return h, w, topo["input_channels"]


def conv_shapes(topo: dict) -> list:
    """Per conv layer: (C_in, N_out, K, H_conv, W_conv, H_out, W_out)."""
    h, w, c = input_hwc(topo)
    out = []
    for layer in topo["conv_layers"]:
        hc, wc = conv_hw(layer, h, w)
        ho, wo = out_hw(layer, h, w)
        out.append((c, layer["n_out"], layer["kernel"], hc, wc, ho, wo))
        h, w, c = ho, wo, layer["n_out"]
    return out


def feature_elems(topo: dict) -> int:
    """Elements of one frame's feature map, the head's input."""
    _, _, _, _, _, ho, wo = conv_shapes(topo)[-1]
    return ho * wo * topo["conv_layers"][-1]["n_out"]


def fc_dims(topo: dict) -> list:
    """(in, out) of each FC layer of the head."""
    dims = [feature_elems(topo), *topo["fc_dims"], topo["n_classes"]]
    return list(zip(dims[:-1], dims[1:]))


def conv_macs(topo: dict) -> int:
    """Conv MACs of one frame (every output position of every layer, before
    its pool)."""
    return sum(c * n * k * k * hc * wc for c, n, k, hc, wc, _, _ in conv_shapes(topo))


def head_macs(topo: dict) -> int:
    """FC MACs of one frame."""
    return sum(i * o for i, o in fc_dims(topo))


def frame_elems(topo: dict) -> int:
    h, w, c = input_hwc(topo)
    return h * w * c


@dataclasses.dataclass(frozen=True)
class InferWork:
    """The work of classifying ``frames`` frames through a plan whose conv
    layers run in integers (``int8``) or in float32."""

    conv_ops: float
    conv_bytes: float
    head_flops: float
    int8: bool

    def conv_seconds(self, peaks: dict) -> float:
        """The conv layers' least time: operations at the matching peak, or
        the bytes at the memory's, the larger."""
        rate = peaks["int8_ops_per_s"] if self.int8 else peaks["fp32_flops_per_s"]
        return max(self.conv_ops / rate, self.conv_bytes / peaks["hbm_bytes_per_s"])

    def head_seconds(self, peaks: dict) -> float:
        """The head's least time: its float32 FLOPs at the float32 peak."""
        return self.head_flops / peaks["fp32_flops_per_s"]

    def compute_seconds(self, peaks: dict) -> float:
        """The least compute time of the whole request, each part at its own
        peak."""
        rate = peaks["int8_ops_per_s"] if self.int8 else peaks["fp32_flops_per_s"]
        return self.conv_ops / rate + self.head_seconds(peaks)


def infer_work(topo: dict, frames: int, *, int8: bool) -> InferWork:
    """The conv group reads its input once (1-byte codes under int8, else
    float32) and writes the float32 features once."""
    in_bytes = 1 if int8 else 4
    return InferWork(
        conv_ops=2.0 * conv_macs(topo) * frames,
        conv_bytes=float(frames * (in_bytes * frame_elems(topo) + 4 * feature_elems(topo))),
        head_flops=2.0 * head_macs(topo) * frames,
        int8=int8,
    )


def train_flops(topo: dict, frames: int) -> float:
    """A training step's FLOPs: three times the forward's (the forward, and
    the backward's two products per layer)."""
    return 3.0 * 2.0 * (conv_macs(topo) + head_macs(topo)) * frames
