"""The stream-conv group's gradient on the card, timed: the backward
kernels (``conv.stream_conv_pyramid_bwd_cuda``) against the plain backward
(autograd of ``ref.py``'s composition on PyTorch's own CUDA convolution,
cuDNN off) and cuDNN's (the same composition, cuDNN deterministic), all
with TF32 off, at cifar10's and lenet5's fusion group (B = 128 by
default), each beside its bound (its FMAs at 67 TFLOP/s) and its largest
relative L2 error of a gradient against the float64 composition.

Run on the machine with the card (needs no JAX):

    python3 chip_bwd.py [--batch 128] [--iters 50]

Prints one JSON line a topology, then ``{"ok": true, ...}``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

FP32_PEAK = 67e12


def bwd_fmas(geom, need_dx: bool) -> int:
    """FMAs of the kernels' algorithm: each layer's forward recomputed and
    dW, and dx of every layer but the first (the first too with
    ``need_dx``); a forward or a dW is B x conv positions x k*k*c x n."""
    total = 0
    for i, g in enumerate(geom.layers):
        conv = g.conv_rows * g.conv_cols * g.k * g.k * g.in_ch * g.n_out
        total += 2 * conv + (conv if (i or need_dx) else 0)
    return total


def main() -> int:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import ref as kref
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry
    from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn

    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--topos", default="cifar10,lenet5")
    ap.add_argument("--bits", type=int, default=6)
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    ok = True
    for name in args.topos.split(","):
        topo = ALL_TOPOLOGIES[name]
        layers = as_pyramid_layers(topo.conv_layers)
        h, w = topo.input_shape
        geom = group_geometry(h, w, topo.input_channels, layers,
                              [s.kernel for s in topo.conv_layers], [s.n_out for s in topo.conv_layers])
        params = init_cnn(torch.Generator().manual_seed(0), topo, device=dev)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(args.batch, h, w, topo.input_channels, generator=gen).to(dev)
        ws = [p["w"] for p in params["conv"]]
        bs = [(0.05 * torch.randn(p["b"].shape, generator=gen)).to(dev) for p in params["conv"]]
        last = geom.layers[-1]
        g = torch.randn(args.batch, last.out_rows, last.out_cols, last.n_out, generator=gen).to(dev)
        bits = (args.bits,) * len(layers)

        def kernels():
            return kconv.stream_conv_pyramid_bwd_cuda(x, ws, bs, g, layers=layers, act_bits=bits,
                                                      need_dx=False)

        def plain(cudnn: bool):
            leaves = [t.detach().requires_grad_() for t in (*ws, *bs)]
            with torch.backends.cudnn.flags(enabled=cudnn, benchmark=False, deterministic=True,
                                            allow_tf32=False):
                y = kref.stream_conv_pyramid_ref(x, leaves[:len(ws)], leaves[len(ws):],
                                                 layers=layers, act_bits=bits)
                return torch.autograd.grad(y, leaves, g)

        def f64():
            leaves = [t.detach().cpu().double().requires_grad_() for t in (*ws, *bs)]
            hh = x.cpu().double()
            for lay, wt, bt, nb in zip(layers, leaves[:len(ws)], leaves[len(ws):], bits):
                y = kref._conv_nhwc(hh, wt, stride=lay.stride, padding=lay.padding,
                                    dtype=torch.float64) + bt
                y = torch.tanh(y) if lay.act == "tanh" else torch.maximum(y, y.new_zeros(()))
                pw = lay.pool
                if pw:
                    y = F.max_pool2d(y.permute(0, 3, 1, 2), pw, lay.pool_stride or pw).permute(0, 2, 3, 1)
                hh = y
            return torch.autograd.grad(hh, leaves, g.cpu().double())

        def timed(fn):
            fn()
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(args.iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            return start.elapsed_time(end) / args.iters

        got = kernels()
        again = kernels()
        bitwise = all(torch.equal(a, b) for a, b in zip((*got[1], *got[2]), (*again[1], *again[2])))
        pl = plain(False)
        # fp32 precision: the unquantized group (bits None) against float64.
        bits_q = bits
        bits = (None,) * len(layers)
        got32 = kernels()
        truth = f64()
        err = max(float((a.cpu().double() - b).norm() / b.norm())
                  for a, b in zip((*got32[1], *got32[2]), truth))
        plain_err = max(float((a.cpu().double() - b).norm() / b.norm())
                        for a, b in zip(plain(False), truth))
        bits = bits_q
        qat_vs_plain = max(float((a - b).norm() / b.norm()) for a, b in zip((*got[1], *got[2]), pl))
        ms = timed(kernels)
        plain_ms = timed(lambda: plain(False))
        cudnn_ms = timed(lambda: plain(True))
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                kernels()
            torch.cuda.synchronize()
        by_kernel = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", 0) or 0
            if us:
                by_kernel[evt.key[:60]] = round(us / 1e3 / 10, 5)
        bound = 2 * args.batch * bwd_fmas(geom, False) / FP32_PEAK * 1e3
        ok &= bitwise and err <= 1e-5
        print(json.dumps(dict(
            topo=name, batch=args.batch, card=smi, kernels_ms=round(ms, 5),
            device_ms=round(sum(by_kernel.values()), 5), bound_ms=round(bound, 5),
            plain_ms=round(plain_ms, 5), cudnn_ms=round(cudnn_ms, 5),
            f64_rel_l2=err, plain_f64_rel_l2=plain_err, qat_vs_plain_rel_l2=qat_vs_plain,
            bitwise_repeat=bitwise, launches=kconv.bwd_launches(len(layers), False),
            by_kernel=by_kernel)))
    print(json.dumps({"ok": bool(ok), "device": torch.cuda.get_device_name(0)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
