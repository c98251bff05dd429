"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

Phases (each asserts or exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a),
     one nvcc per source, all started together, and print what
     -Xptxas -v reports;
  3. hold each kernel against its plain PyTorch version at B=256, TF32
     off: the fp32 pyramid on the fusion group of each of the five
     topologies and the fp32 single-layer kernel on every layer of
     cifar10, cifar10_full and cifar10_strided, in fp32 and with
     act_bits=6; their int8 variants at act_bits=8 on the same groups and
     layers; pow2_matmul in both modes at the cifar10 and lenet5 head
     shapes;
  4. the fp32 path: compile cifar10 at full width from seeded params, run
     B=256 through the fused plan and the vmem_budget=0 plan, and compare
     both with the plain-version forward;
  5. serve 24 requests of 1-256 frames with deadlines through
     Engine(plan, microbatch=256) with the flush loop on, and hold every
     answer against plan(x) and the plain-version forward;
  4b. the int8 and pow2 path on an on-grid B=256 batch: plan (a)
     QuantSpec(weight_bits=8, act_bits=8, int8_compute=True), fused and
     vmem_budget=0, bit for bit against the 8-bit fake-quant plan; plan
     (b) QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True,
     per_layer_bits=(8, 8, 8)), bit for bit against its fake-quant twin
     (fp32 kernels, fp32-decode head); plan (c) QuantSpec(pow2_weights=
     True) against the plain-version forward;
  5b. serve the same burst through Engine(plan (b)) and hold every answer
     bit for bit against plan (b)(x);
  6. time each kernel, its plain version and the library call with CUDA
     events at main-path shapes, beside the card's bound; then the plans,
     and one serving micro-batch piece by piece;
  7. print the {"kernels": [...]} line, then the {"ok": true, ...} line.

The launch counts are zeroed just before phase 4 and read just after
phase 5 (the fp32 path), then zeroed just before phase 4b and read just
after phase 5b (the int8 and pow2 path): they show that each path went
through its kernels. Reference outputs that need kernel launches are
computed before a path's counts are zeroed.
Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor
# cores, dense int8 on the tensor cores, and HBM3 bandwidth. The bound of
# a kernel is the larger of its operations over the peak for their type
# and its bytes over the bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES_S = 3.35e12
SEED = 0
BATCH = 256
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5
# Logits of the compiled plans against the plain forward: the reference
# tests' own fp32 tolerance for logits (sums of 1024 features).
LOGITS_RTOL, LOGITS_ATOL = 1e-4, 1e-4
QUANT_BITS = 6
# Fake-quant outputs may sit one quant step apart where an fp32 sum in
# another order lands on the other side of a rounding boundary; more than
# this share of such elements would mean a real fault.
QUANT_MAX_STEP_SHARE = 1e-3
INT8_BITS = 8
# pow2_matmul's fp32 mode against its plain version; the activations sit
# on a 2^-4 grid, where every partial sum of these shapes is exact.
POW2_RTOL, POW2_ATOL = 1e-5, 1e-6
# (M, K, N) of the pow2 heads: cifar10's two FC layers, lenet5's two.
POW2_SHAPES = ((BATCH, 1024, 64), (BATCH, 64, 10), (BATCH, 800, 500), (BATCH, 500, 10))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(2)

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core.dhm import Engine, QuantSpec, compile_dhm
    from repro_torch.core.dhm.fusion import plan_fusion_groups
    from repro_torch.core.quant.fixed_point import dynamic_spec, quantize_fixed
    from repro_torch.core.quant.packing import unpack_codes_u4
    from repro_torch.core.quant.pow2 import decode_pow2
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.pow2_matmul import pow2 as kpow2
    from repro_torch.kernels.pow2_matmul import (
        pow2_matmul,
        pow2_matmul_int_ref,
        pow2_matmul_ref,
        quantize_weights,
    )
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import (
        stream_conv_block,
        stream_conv_block_ref,
        stream_conv_pyramid,
        stream_conv_pyramid_ref,
    )
    from repro_torch.kernels.stream_conv.epilogue import (
        Int8Scales,
        quantize_stream,
        stream_quant_spec,
    )
    from repro_torch.kernels.stream_conv.ops import _pad_same
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry
    from repro_torch.models.cnn import ALL_TOPOLOGIES, cnn_apply_reference, init_cnn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}, device 0: {kind}, "
          f"count {torch.cuda.device_count()}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    logs = _nvcc.build(["stream_conv", "pow2_matmul"])
    print(f"[2] nvcc build: {time.perf_counter() - t0:.1f} s"
          + ("" if logs else " (library already built in this checkout)"))
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"[2] {name}.cu: {line}")
    kconv._library()  # loads them and checks the descriptor layouts
    kpow2._library()

    gen = torch.Generator().manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32).to(dev)

    params = {name: init_cnn(gen, topo, device=dev) for name, topo in ALL_TOPOLOGIES.items()}

    def compare_quant(out, ref, bits, what):
        step = stream_quant_spec(bits).scale
        d = (out - ref).abs()
        off = int((d > 1e-6).sum())
        check(float(d.max()) <= step + 1e-6,
              f"{what}: max |delta| {float(d.max())} above one quant step {step}")
        share = off / d.numel()
        check(share <= QUANT_MAX_STEP_SHARE,
              f"{what}: {off} of {d.numel()} elements one step apart")
        return float(d.max()), off

    # -- 3. each kernel against its plain version ------------------------------
    errs = {"stream_conv_pyramid": 0.0, "stream_conv_fused": 0.0}
    for name, topo in ALL_TOPOLOGIES.items():
        h, w = topo.input_shape
        x = randn(BATCH, h, w, topo.input_channels)
        idxs = tuple(range(len(topo.conv_layers)))
        for grp in plan_fusion_groups(topo, idxs):
            layers = [topo.conv_layers[i] for i in grp.layers]
            ws = [params[name]["conv"][i]["w"] for i in grp.layers]
            bs = [params[name]["conv"][i]["b"] for i in grp.layers]
            check(grp.fused, f"{name}: expected one fused group, got {grp}")
            block_list = [grp.block_rows] + ([1] if name in ("cifar10", "lenet5") else [])
            for bits in (None, QUANT_BITS):
                for br in block_list:
                    out = stream_conv_pyramid(x, ws, bs, layers=layers,
                                              act_bits=bits, block_rows=br)
                    ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers),
                                                  act_bits=bits)
                    torch.cuda.synchronize()
                    check(out.shape == ref.shape, f"{name} pyramid shape {out.shape} vs {ref.shape}")
                    what = f"pyramid {name} layers {grp.layers} block_rows {br} act_bits {bits}"
                    if bits is None:
                        err = float((out - ref).abs().max())
                        check(torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL),
                              f"{what}: max |delta| {err}")
                        errs["stream_conv_pyramid"] = max(errs["stream_conv_pyramid"], err)
                        print(f"[3] {what}: shape {tuple(out.shape)} max |delta| {err:.3e}")
                    else:
                        err, off = compare_quant(out, ref, bits, what)
                        print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} "
                              "elements one step apart")
    for name in ("cifar10", "cifar10_full", "cifar10_strided"):
        topo = ALL_TOPOLOGIES[name]
        h, w = topo.input_shape
        c = topo.input_channels
        for li, spec in enumerate(topo.conv_layers):
            x = randn(BATCH, h, w, c)
            p = params[name]["conv"][li]
            kw = dict(padding=spec.padding, stride=spec.stride, act=spec.act,
                      pool=spec.pool, pool_stride=spec.pool_stride)
            for bits in (None, QUANT_BITS):
                out = stream_conv_block(x, p["w"], p["b"], act_bits=bits, **kw)
                ref = stream_conv_block_ref(x, p["w"], p["b"], act_bits=bits, **kw)
                torch.cuda.synchronize()
                check(out.shape == ref.shape, f"{name} layer {li}: {out.shape} vs {ref.shape}")
                what = f"single-layer {name} layer {li} act_bits {bits}"
                if bits is None:
                    err = float((out - ref).abs().max())
                    check(torch.allclose(out, ref, rtol=FP32_RTOL, atol=FP32_ATOL),
                          f"{what}: max |delta| {err}")
                    errs["stream_conv_fused"] = max(errs["stream_conv_fused"], err)
                    print(f"[3] {what}: shape {tuple(out.shape)} max |delta| {err:.3e}")
                else:
                    err, off = compare_quant(out, ref, bits, what)
                    print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} "
                          "elements one step apart")
            h, w = spec.out_hw(h, w)
            c = spec.n_out

    def bake_int8(w, bits):
        spec = dynamic_spec(w, bits)
        return quantize_fixed(w, spec).to(torch.int8).contiguous(), spec.scale

    def compare_int8(out, ref, act, what):
        """Equal on relu layers; where tanh follows, elements may sit one
        quant step apart (the card's tanhf against torch.tanh), counted."""
        if act == "relu":
            check(torch.equal(out, ref), f"{what}: max |delta| {float((out - ref).abs().max())}")
            return 0.0, 0
        return compare_quant(out, ref, INT8_BITS, what)

    errs.update(stream_conv_pyramid_int8=0.0, stream_conv_fused_int8=0.0,
                pow2_matmul=0.0, pow2_matmul_int=0.0)
    for name, topo in ALL_TOPOLOGIES.items():
        h, w = topo.input_shape
        x = randn(BATCH, h, w, topo.input_channels)
        (grp,) = plan_fusion_groups(topo, tuple(range(len(topo.conv_layers))), elem_bytes=1)
        layers = [topo.conv_layers[i] for i in grp.layers]
        baked = [bake_int8(params[name]["conv"][i]["w"], INT8_BITS) for i in grp.layers]
        ws = [c for c, _ in baked]
        bs = [params[name]["conv"][i]["b"] for i in grp.layers]
        scales = tuple(Int8Scales(in_bits=INT8_BITS, w_scale=sc) for _, sc in baked)
        out = stream_conv_pyramid(x, ws, bs, layers=layers, act_bits=INT8_BITS,
                                  int8_scales=scales, block_rows=grp.block_rows)
        ref = stream_conv_pyramid_ref(x, ws, bs, layers=as_pyramid_layers(layers),
                                      act_bits=INT8_BITS, int8_scales=scales)
        torch.cuda.synchronize()
        check(out.shape == ref.shape, f"{name} int8 pyramid shape {out.shape} vs {ref.shape}")
        what = f"int8 pyramid {name} layers {grp.layers} block_rows {grp.block_rows}"
        err, off = compare_int8(out, ref, layers[0].act, what)
        errs["stream_conv_pyramid_int8"] = max(errs["stream_conv_pyramid_int8"], err)
        print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} elements one step apart")
    for name in ("cifar10", "cifar10_full", "cifar10_strided"):
        topo = ALL_TOPOLOGIES[name]
        h, w = topo.input_shape
        c = topo.input_channels
        for li, spec in enumerate(topo.conv_layers):
            x = randn(BATCH, h, w, c)
            wq, wsc = bake_int8(params[name]["conv"][li]["w"], INT8_BITS)
            b = params[name]["conv"][li]["b"]
            kw = dict(padding=spec.padding, stride=spec.stride, act=spec.act, pool=spec.pool,
                      pool_stride=spec.pool_stride, act_bits=INT8_BITS,
                      int8_scales=Int8Scales(in_bits=INT8_BITS, w_scale=wsc))
            out = stream_conv_block(x, wq, b, **kw)
            ref = stream_conv_block_ref(x, wq, b, **kw)
            torch.cuda.synchronize()
            check(out.shape == ref.shape, f"{name} int8 layer {li}: {out.shape} vs {ref.shape}")
            what = f"int8 single-layer {name} layer {li}"
            err, off = compare_int8(out, ref, spec.act, what)
            errs["stream_conv_fused_int8"] = max(errs["stream_conv_fused_int8"], err)
            print(f"[3] {what}: max |delta| {err:.3e}, {off} of {out.numel()} elements one "
                  "step apart")
            h, w = spec.out_hw(h, w)
            c = spec.n_out
    pow2_cases = {}
    for m, k, n in POW2_SHAPES:
        wt = randn(k, n) * (2.0 / k) ** 0.5
        xg = torch.clamp(torch.round(randn(m, k) * 16) / 16, -2.0, 1.9375)
        packed, scale = quantize_weights(wt)
        pow2_cases[(m, k, n)] = (xg, packed, scale)
        out = pow2_matmul(xg, packed, scale)
        ref = pow2_matmul_ref(xg, packed, scale)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        check(torch.allclose(out, ref, rtol=POW2_RTOL, atol=POW2_ATOL),
              f"pow2_matmul fp32 {(m, k, n)}: max |delta| {err}")
        errs["pow2_matmul"] = max(errs["pow2_matmul"], err)
        xspec = stream_quant_spec(INT8_BITS)
        out = pow2_matmul(xg, packed, scale, x_spec=xspec)
        ref = pow2_matmul_int_ref(xg, packed, scale, x_spec=xspec)
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"pow2_matmul integer {(m, k, n)}: max |delta| "
              f"{float((out - ref).abs().max())}")
        print(f"[3] pow2_matmul {(m, k, n)}: fp32 decode max |delta| {err:.3e}, integer mode equal")

    # -- 4. + 5. the main path, with the launch counts ---------------------------
    topo = ALL_TOPOLOGIES["cifar10"]
    cparams = init_cnn(torch.Generator().manual_seed(SEED), topo, device=dev)
    h, w = topo.input_shape
    x = randn(BATCH, h, w, topo.input_channels)
    kconv.reset_launch_counts()
    plan = compile_dhm(topo, cparams, quant=QuantSpec())
    plan0 = compile_dhm(topo, cparams, quant=QuantSpec(), vmem_budget=0)
    check([g.layers for g in plan.fusion_groups] == [(0, 1, 2)],
          f"fused plan groups {plan.fusion_groups}")
    check(all(not g.fused for g in plan0.fusion_groups), "vmem_budget=0 plan fuses")
    logits = plan(x)
    logits0 = plan0(x)
    ref_logits = cnn_apply_reference(cparams, topo, x)
    torch.cuda.synchronize()
    for what, out in (("fused plan", logits), ("vmem_budget=0 plan", logits0)):
        check(out.shape == (BATCH, topo.n_classes) and bool(torch.isfinite(out).all()),
              f"{what}: logits {tuple(out.shape)} not finite/shaped")
        err = float((out - ref_logits).abs().max())
        check(torch.allclose(out, ref_logits, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"{what}: max |delta| {err} against the plain forward")
        print(f"[4] cifar10 {what}, B={BATCH}: logits max |delta| {err:.3e} against "
              "the plain-version forward")

    rng = np.random.default_rng(SEED)
    eng = Engine(plan, microbatch=BATCH, auto_flush=True, default_deadline_ms=10_000.0)
    eng.reset_stats()
    frames = [rng.normal(size=(int(rng.integers(1, BATCH + 1)), h, w, topo.input_channels))
              .astype(np.float32) for _ in range(24)]
    t0 = time.perf_counter()
    reqs = [eng.submit(f) for f in frames]
    results = [r.result(timeout=120.0) for r in reqs]
    wall = time.perf_counter() - t0
    eng.stop()
    main_launches = dict(kconv.LAUNCHES)
    st = eng.stats()
    for f, got in zip(frames, results):
        want = plan(f).cpu()
        plain = cnn_apply_reference(cparams, topo, torch.from_numpy(f).to(dev)).cpu()
        check(got.shape == want.shape, f"engine logits {tuple(got.shape)} vs {tuple(want.shape)}")
        check(torch.allclose(got, want, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"engine logits max |delta| {float((got - want).abs().max())} against plan(x)")
        check(torch.allclose(got, plain, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"engine logits max |delta| {float((got - plain).abs().max())} against the "
              "plain-version forward")
    check(eng.rung == "fused", f"engine rung {eng.rung!r}")
    check(eng.demotions == [], f"engine demotions {eng.demotions}")
    check(st.n_retries == 0, f"engine retries {st.n_retries}")
    check(st.n_ok == len(frames) and st.n_errors == 0, f"engine outcomes: {st.summary()}")
    check(main_launches["stream_conv_pyramid"] > 0, "main path never launched the pyramid")
    check(main_launches["stream_conv_fused"] > 0, "main path never launched the single-layer kernel")
    lat = st.rung_latency_ms["fused"]
    n_frames = sum(f.shape[0] for f in frames)
    print(f"[5] engine: {len(frames)} requests / {n_frames} frames on rung {eng.rung}, "
          f"p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms, "
          f"{st.frames_per_s:.0f} frames/s busy, {n_frames / wall:.0f} frames/s wall, "
          f"{st.n_batches} micro-batches, 0 retries, 0 demotions")
    print(f"[5] main-path launches: {main_launches}")

    # -- 4b. + 5b. the int8 and pow2 path, with its own launch counts ------------
    qspec8 = stream_quant_spec(INT8_BITS)
    xq = quantize_stream(x, INT8_BITS).to(torch.float32) * qspec8.scale  # on-grid batch
    quant_a = QuantSpec(weight_bits=8, act_bits=8, int8_compute=True)
    quant_b = QuantSpec(act_bits=8, pow2_weights=True, int8_compute=True, per_layer_bits=(8, 8, 8))
    quant_c = QuantSpec(pow2_weights=True)
    # Reference outputs first, outside the counted window: the fake-quant
    # twins of plans (a) and (b) run the fp32 kernels.
    want_a = compile_dhm(topo, cparams, quant=QuantSpec(weight_bits=8, act_bits=8))(xq)
    want_b = compile_dhm(topo, cparams, quant=QuantSpec(
        act_bits=8, pow2_weights=True, per_layer_bits=(8, 8, 8)))(xq)
    plain_a = cnn_apply_reference(cparams, topo, xq, weight_bits=8, act_bits=8)
    plain_c = cnn_apply_reference(cparams, topo, x, pow2_weights=True)
    q_frames = [(quantize_stream(torch.from_numpy(f), INT8_BITS).to(torch.float32)
                 * qspec8.scale).numpy() for f in frames]
    torch.cuda.synchronize()
    kconv.reset_launch_counts()
    kpow2.reset_launch_counts()
    plan_a = compile_dhm(topo, cparams, quant=quant_a)
    plan_a0 = compile_dhm(topo, cparams, quant=quant_a, vmem_budget=0)
    plan_b = compile_dhm(topo, cparams, quant=quant_b)
    plan_c = compile_dhm(topo, cparams, quant=quant_c)
    check([g.layers for g in plan_a.fusion_groups] == [(0, 1, 2)],
          f"int8 plan groups {plan_a.fusion_groups}")
    check(all(not g.fused for g in plan_a0.fusion_groups), "int8 vmem_budget=0 plan fuses")
    logits_a = plan_a(xq)
    logits_a0 = plan_a0(xq)
    logits_b = plan_b(xq)
    logits_c = plan_c(x)
    eng_b = Engine(plan_b, microbatch=BATCH, auto_flush=True, default_deadline_ms=10_000.0)
    eng_b.reset_stats()
    t0 = time.perf_counter()
    reqs = [eng_b.submit(f) for f in q_frames]
    results_b = [r.result(timeout=120.0) for r in reqs]
    wall_b = time.perf_counter() - t0
    eng_b.stop()
    torch.cuda.synchronize()
    int8_launches = {**kconv.LAUNCHES, **kpow2.LAUNCHES}
    for what, out, want in (("plan (a) fused", logits_a, want_a),
                            ("plan (a) vmem_budget=0", logits_a0, want_a),
                            ("plan (b)", logits_b, want_b)):
        check(out.shape == (BATCH, topo.n_classes) and bool(torch.isfinite(out).all()),
              f"{what}: logits {tuple(out.shape)} not finite/shaped")
        check(torch.equal(out, want), f"{what}: max |delta| {float((out - want).abs().max())} "
              "against its fake-quant twin")
        print(f"[4b] cifar10 {what}, B={BATCH}, on-grid batch: logits equal to the fake-quant "
              "twin bit for bit")
    for what, out, plain in (("plan (a) fused", logits_a, plain_a), ("plan (c)", logits_c, plain_c)):
        err = float((out - plain).abs().max())
        check(torch.allclose(out, plain, rtol=LOGITS_RTOL, atol=LOGITS_ATOL),
              f"{what}: max |delta| {err} against the plain forward")
        print(f"[4b] cifar10 {what}, B={BATCH}: logits max |delta| {err:.3e} against the "
              "plain-version forward")
    st_b = eng_b.stats()
    for f, got in zip(q_frames, results_b):
        want = plan_b(f).cpu()
        check(torch.equal(got, want), f"engine (b) logits max |delta| "
              f"{float((got - want).abs().max())} against plan(x)")
    check(eng_b.rung == "fused", f"engine (b) rung {eng_b.rung!r}")
    check(eng_b.demotions == [], f"engine (b) demotions {eng_b.demotions}")
    check(st_b.n_retries == 0, f"engine (b) retries {st_b.n_retries}")
    check(st_b.n_ok == len(frames) and st_b.n_errors == 0, f"engine (b) outcomes: {st_b.summary()}")
    for key in ("stream_conv_pyramid_int8", "stream_conv_fused_int8", "pow2_matmul",
                "pow2_matmul_int"):
        check(int8_launches[key] > 0, f"the int8 and pow2 path never launched {key}")
    lat = st_b.rung_latency_ms["fused"]
    print(f"[5b] engine on plan (b): {len(frames)} requests / {n_frames} frames on rung "
          f"{eng_b.rung}, p50 {lat['p50_ms']:.3f} ms p99 {lat['p99_ms']:.3f} ms, "
          f"{st_b.frames_per_s:.0f} frames/s busy, {n_frames / wall_b:.0f} frames/s wall, "
          f"{st_b.n_batches} micro-batches, 0 retries, 0 demotions, every answer equal to plan(x)")
    print(f"[5b] int8 and pow2 path launches: {int8_launches}")

    # -- 6. timing at main-path shapes -------------------------------------------
    def time_ms(fn, iters=50, warmup=5):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters

    def cost(layer_idxs, code_bytes=4):
        """(operations, bytes) of a run of cifar10 conv layers at B=BATCH: 2
        per conv MAC over the frame's real outputs; the input and weights
        read once at ``code_bytes`` per element (4 fp32, 1 int8 codes), the
        biases read once and the output written once in fp32."""
        hh, ww = topo.input_shape
        cc = topo.input_channels
        flops, nbytes = 0, 0
        for i, spec in enumerate(topo.conv_layers):
            hc, wc = spec.conv_hw(hh, ww)
            if i in layer_idxs:
                if i == layer_idxs[0]:
                    nbytes += BATCH * hh * ww * cc * code_bytes
                flops += 2 * BATCH * hc * wc * spec.kernel ** 2 * cc * spec.n_out
                nbytes += spec.kernel ** 2 * cc * spec.n_out * code_bytes + spec.n_out * 4
            hh, ww = spec.out_hw(hh, ww)
            cc = spec.n_out
            if i == layer_idxs[-1]:
                nbytes += BATCH * hh * ww * cc * 4
        return flops, nbytes

    def bound(flops, nbytes, peak=PEAK_FP32_FLOPS):
        t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")

    ws = [p["w"] for p in plan.conv_params]
    bs = [p["b"] for p in plan.conv_params]
    specs = topo.conv_layers
    check(all(s.padding == "SAME" and s.stride == 1 and s.kernel % 2 for s in specs),
          "the library chain takes SAME stride-1 odd-kernel layers")
    w_nchw = [wt.permute(3, 2, 0, 1).contiguous() for wt in ws]
    x_nchw = x.permute(0, 3, 1, 2).contiguous()

    acts = {"tanh": torch.tanh, "relu": F.relu, "none": lambda t: t}

    def library_chain(idxs, xin):
        """cuDNN conv -> max-pool -> act on NCHW: cifar10's layers are
        stride 1 with odd kernels, where SAME is a symmetric k // 2 pad."""
        for i in idxs:
            xin = F.conv2d(xin, w_nchw[i], bs[i], padding=specs[i].kernel // 2)
            pw, ps = specs[i].pool_cfg
            xin = acts[specs[i].act](F.max_pool2d(xin, pw, ps))
        return xin

    layers_in = [x]
    for spec, p in zip(specs, plan.conv_params):
        layers_in.append(stream_conv_block_ref(
            layers_in[-1], p["w"], p["b"], padding=spec.padding, act=spec.act, pool=spec.pool))
    layers_in_nchw = [t.permute(0, 3, 1, 2).contiguous() for t in layers_in]

    kernels = []
    pyr_layers = as_pyramid_layers(specs)
    block_rows = plan.fusion_groups[0].block_rows
    ms = time_ms(lambda: stream_conv_pyramid(x, ws, bs, layers=specs, block_rows=block_rows))
    plain = time_ms(lambda: stream_conv_pyramid_ref(x, ws, bs, layers=pyr_layers))
    lib = time_ms(lambda: library_chain((0, 1, 2), x_nchw))
    b_ms, b_by = bound(*cost((0, 1, 2)))
    print(f"[6] pyramid cifar10 B={BATCH}: {ms:.4f} ms, plain {plain:.4f} ms, "
          f"library {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernels.append(dict(
        name="stream_conv_pyramid", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:440",
        launches=main_launches["stream_conv_pyramid"], max_abs_err=errs["stream_conv_pyramid"],
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
    ))
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "flops": 0, "bytes": 0}
    for i, spec in enumerate(specs):
        xi, p = layers_in[i], plan.conv_params[i]
        kw = dict(padding=spec.padding, act=spec.act, pool=spec.pool)
        t_k = time_ms(lambda: stream_conv_block(xi, p["w"], p["b"], **kw))
        t_p = time_ms(lambda: stream_conv_block_ref(xi, p["w"], p["b"], **kw))
        t_l = time_ms(lambda: library_chain((i,), layers_in_nchw[i]))
        f_i, b_i = cost((i,))
        lb_ms, lb_by = bound(f_i, b_i)
        print(f"[6] single-layer cifar10 layer {i} B={BATCH}: {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library {t_l:.4f} ms, bound {lb_ms:.4f} ms ({lb_by})")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l), ("flops", f_i), ("bytes", b_i)):
            tot[key] += val
    b_ms, b_by = bound(tot["flops"], tot["bytes"])
    print(f"[6] single-layer cifar10 per-layer stack (3 launches): {tot['ms']:.4f} ms, "
          f"plain {tot['plain']:.4f} ms, library {tot['lib']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernels.append(dict(
        name="stream_conv_fused", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:168",
        launches=main_launches["stream_conv_fused"], max_abs_err=errs["stream_conv_fused"],
        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=b_ms, bound_by=b_by,
        library_ms=tot["lib"],
    ))

    # The int8 kernels, timed at their own wrappers on the codes the plan
    # hands them (frame quantized and, for the single layer, padded): the
    # host-side quantize is not the kernel's. The library yardstick is the
    # fp32 cuDNN chain on the same shapes: PyTorch has no int8 conv on CUDA.
    ws8 = [p["w"] for p in plan_a.conv_params]
    bs8 = [p["b"] for p in plan_a.conv_params]
    sc8 = plan_a.int8_scales
    bits8 = (INT8_BITS,) * len(specs)
    g8 = group_geometry(h, w, topo.input_channels, pyr_layers, tuple(s.kernel for s in specs),
                        tuple(s.n_out for s in specs),
                        block_rows=plan_a.fusion_groups[0].block_rows)
    x8 = quantize_stream(xq, INT8_BITS)
    ms = time_ms(lambda: kconv.stream_conv_pyramid_cuda(x8, ws8, bs8, geom=g8, act_bits=bits8,
                                                        int8_scales=sc8))
    plain = time_ms(lambda: stream_conv_pyramid_ref(xq, ws8, bs8, layers=pyr_layers,
                                                    act_bits=bits8, int8_scales=sc8))
    lib = time_ms(lambda: library_chain((0, 1, 2), x_nchw))
    b_ms, b_by = bound(*cost((0, 1, 2), code_bytes=1), peak=PEAK_INT8_OPS)
    print(f"[6] int8 pyramid cifar10 B={BATCH}: {ms:.4f} ms, plain {plain:.4f} ms, library "
          f"(fp32 cuDNN chain) {lib:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernels.append(dict(
        name="stream_conv_pyramid_int8", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:440",
        launches=int8_launches["stream_conv_pyramid_int8"],
        max_abs_err=errs["stream_conv_pyramid_int8"],
        ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
    ))
    layers_in8 = [xq]
    for spec, p, sc in zip(specs, plan_a.conv_params, sc8):
        layers_in8.append(stream_conv_block_ref(
            layers_in8[-1], p["w"], p["b"], padding=spec.padding, act=spec.act, pool=spec.pool,
            act_bits=INT8_BITS, int8_scales=sc))
    tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "flops": 0, "bytes": 0}
    for i, spec in enumerate(specs):
        xi, p, sc = layers_in8[i], plan_a.conv_params[i], sc8[i]
        codes_i = _pad_same(quantize_stream(xi, sc.in_bits), spec.kernel).contiguous()
        kw = dict(padding=spec.padding, act=spec.act, pool=spec.pool, act_bits=INT8_BITS,
                  int8_scales=sc)
        t_k = time_ms(lambda: kconv.stream_conv_fused_cuda(
            codes_i, p["w"], p["b"], act=spec.act, pool=spec.pool, act_bits=INT8_BITS,
            int8_scales=sc))
        t_p = time_ms(lambda: stream_conv_block_ref(xi, p["w"], p["b"], **kw))
        t_l = time_ms(lambda: library_chain((i,), layers_in_nchw[i]))
        f_i, b_i = cost((i,), code_bytes=1)
        lb_ms, lb_by = bound(f_i, b_i, peak=PEAK_INT8_OPS)
        print(f"[6] int8 single-layer cifar10 layer {i} B={BATCH}: {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, library (fp32 cuDNN) {t_l:.4f} ms, bound {lb_ms:.4f} ms ({lb_by})")
        for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l), ("flops", f_i), ("bytes", b_i)):
            tot[key] += val
    b_ms, b_by = bound(tot["flops"], tot["bytes"], peak=PEAK_INT8_OPS)
    print(f"[6] int8 single-layer cifar10 stack (3 launches): {tot['ms']:.4f} ms, plain "
          f"{tot['plain']:.4f} ms, library {tot['lib']:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
    kernels.append(dict(
        name="stream_conv_fused_int8", route="cuda", source="src/repro_torch/csrc/stream_conv.cu",
        replaces="src/repro/kernels/stream_conv/conv.py:168",
        launches=int8_launches["stream_conv_fused_int8"],
        max_abs_err=errs["stream_conv_fused_int8"],
        ms=tot["ms"], plain_ms=tot["plain"], bound_ms=b_ms, bound_by=b_by, library_ms=tot["lib"],
    ))

    # pow2_matmul at the cifar10 head's two shapes, summed (one head).
    for mode in ("pow2_matmul", "pow2_matmul_int"):
        tot = {"ms": 0.0, "plain": 0.0, "lib": 0.0, "bound": 0.0}
        bound_by = set()
        for shape in POW2_SHAPES[:2]:
            m, k, n = shape
            xg, packed, scale = pow2_cases[shape]
            w_dec = decode_pow2(unpack_codes_u4(packed), torch.ones((), device=dev))[:, :n].contiguous()
            if mode == "pow2_matmul":
                t_k = time_ms(lambda: kpow2.pow2_matmul_cuda(xg, packed, scale))
                t_p = time_ms(lambda: pow2_matmul_ref(xg, packed, scale))
                ops, peak, x_bytes = 2 * m * k * n, PEAK_FP32_FLOPS, 4 * m * k
            else:
                xc = quantize_fixed(xg, qspec8).to(torch.int8)
                t_k = time_ms(lambda: kpow2.pow2_matmul_cuda(xc, packed, scale,
                                                             x_scale=qspec8.scale))
                t_p = time_ms(lambda: pow2_matmul_int_ref(xg, packed, scale, x_spec=qspec8))
                ops, peak, x_bytes = 2 * m * k * n, PEAK_INT8_OPS, m * k
            t_l = time_ms(lambda: torch.matmul(xg, w_dec) * scale)
            nbytes = x_bytes + packed.numel() + 4 * n + 4 * m * n
            t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES_S
            bound_by.add("operations" if t_ops >= t_bytes else "bytes")
            print(f"[6] {mode} {shape}: {t_k:.4f} ms, plain {t_p:.4f} ms, library "
                  f"(torch.matmul on decoded weights) {t_l:.4f} ms, bound "
                  f"{max(t_ops, t_bytes) * 1e3:.6f} ms")
            for key, val in (("ms", t_k), ("plain", t_p), ("lib", t_l),
                             ("bound", max(t_ops, t_bytes) * 1e3)):
                tot[key] += val
        kernels.append(dict(
            name=mode, route="cuda", source="src/repro_torch/csrc/pow2_matmul.cu",
            replaces="src/repro/kernels/pow2_matmul/pow2.py:77",
            launches=int8_launches[mode], max_abs_err=errs[mode],
            ms=tot["ms"], plain_ms=tot["plain"], bound_ms=tot["bound"],
            bound_by="bytes" if "bytes" in bound_by else "operations", library_ms=tot["lib"],
        ))
    fwd_ms = time_ms(lambda: plan(x), iters=20)
    fwd0_ms = time_ms(lambda: plan0(x), iters=20)
    print(f"[6] cifar10 plan(x) B={BATCH}: fused {fwd_ms:.4f} ms, vmem_budget=0 {fwd0_ms:.4f} ms")
    plan_ms = {name_: time_ms(lambda: p_(xq), iters=20)
               for name_, p_ in (("(a) fused", plan_a), ("(a) vmem_budget=0", plan_a0),
                                 ("(b)", plan_b), ("(c)", plan_c))}
    print(f"[6] cifar10 plan(x) B={BATCH}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in plan_ms.items()))
    # One serving micro-batch, piece by piece: the host-to-card copy of a
    # packed batch, the conv features (one pyramid launch), the FC head,
    # and the logits' copy back; beside the Engine's host-clock time per
    # micro-batch (packing, watchdog thread, and all of the above).
    host_batch = np.zeros((BATCH, h, w, topo.input_channels), np.float32)
    feats = plan.features(x)
    out = plan.head_fn(feats)
    parts = {
        "h2d": time_ms(lambda: torch.from_numpy(host_batch).to(dev), iters=20),
        "features": time_ms(lambda: plan.features(x), iters=20),
        "head": time_ms(lambda: plan.head_fn(feats), iters=20),
        "d2h": time_ms(lambda: out.to("cpu"), iters=20),
    }
    per_batch_ms = st.busy_s / st.n_batches * 1e3
    print(f"[6] engine micro-batch of {BATCH}: {per_batch_ms:.4f} ms host clock; on the card "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())
          + f"; card share {sum(parts.values()) / per_batch_ms:.3f}")

    # -- 7. the record ------------------------------------------------------------
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SystemExit:
        raise
    except BaseException:  # noqa: BLE001 — any failed phase fails the run
        import traceback

        traceback.print_exc()
        sys.exit(1)
