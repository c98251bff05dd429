"""Drive the PyTorch/CUDA port's main path once on an NVIDIA card.

    python3 chip_smoke.py

Phases (each asserts or exits non-zero):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the CUDA kernels from src/repro_torch/csrc with nvcc (sm_90a)
     and print what -Xptxas -v reports;
  3. hold each kernel against its plain PyTorch version at B=256: the
     pyramid on the fusion group of each of the five topologies, the
     single-layer kernel on every layer of cifar10, cifar10_full and
     cifar10_strided, in fp32 and with act_bits=6, TF32 off;
  4. the main path: compile cifar10 at full width from seeded params, run
     B=256 through the fused plan and the vmem_budget=0 plan, and compare
     both with the plain-version forward;
  5. serve 24 requests of 1-256 frames with deadlines through
     Engine(plan, microbatch=256) with the flush loop on, and hold every
     answer against plan(x) and the plain-version forward;
  6. time each kernel, its plain version and the library chain with CUDA
     events at main-path shapes, beside the card's bound; then the fused
     and per-layer plans, and one serving micro-batch piece by piece;
  7. print the {"kernels": [...]} line, then the {"ok": true, ...} line.

The launch counts are zeroed just before phase 4 and read just after
phase 5: they show that the main path went through both kernels.
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
# cores and HBM3 bandwidth. The bound of a kernel is the larger of its
# FLOPs over the first and its bytes over the second.
PEAK_FP32_FLOPS = 67e12
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
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.stream_conv import conv as kconv
    from repro_torch.kernels.stream_conv import (
        stream_conv_block,
        stream_conv_block_ref,
        stream_conv_pyramid,
        stream_conv_pyramid_ref,
    )
    from repro_torch.kernels.stream_conv.epilogue import stream_quant_spec
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers
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
    logs = _nvcc.build(["stream_conv"])
    print(f"[2] nvcc build: {time.perf_counter() - t0:.1f} s"
          + ("" if logs else " (library already built in this checkout)"))
    for name, log in logs.items():
        for line in log.strip().splitlines():
            print(f"[2] {name}.cu: {line}")
    kconv._library()  # loads it and checks the descriptor layouts

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

    def cost(layer_idxs):
        """(FLOPs, bytes) of a run of cifar10 conv layers at B=BATCH: 2 per
        conv MAC over the frame's real outputs; the input, weights and
        biases read once and the output written once, in fp32."""
        hh, ww = topo.input_shape
        cc = topo.input_channels
        flops, nbytes = 0, 0
        for i, spec in enumerate(topo.conv_layers):
            hc, wc = spec.conv_hw(hh, ww)
            if i in layer_idxs:
                if i == layer_idxs[0]:
                    nbytes += BATCH * hh * ww * cc * 4
                flops += 2 * BATCH * hc * wc * spec.kernel ** 2 * cc * spec.n_out
                nbytes += (spec.kernel ** 2 * cc + 1) * spec.n_out * 4
            hh, ww = spec.out_hw(hh, ww)
            cc = spec.n_out
            if i == layer_idxs[-1]:
                nbytes += BATCH * hh * ww * cc * 4
        return flops, nbytes

    def bound(flops, nbytes):
        t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_S
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
    fwd_ms = time_ms(lambda: plan(x), iters=20)
    fwd0_ms = time_ms(lambda: plan0(x), iters=20)
    print(f"[6] cifar10 plan(x) B={BATCH}: fused {fwd_ms:.4f} ms, vmem_budget=0 {fwd0_ms:.4f} ms")
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
