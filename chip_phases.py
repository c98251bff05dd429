"""Phase times inside the int8 conv kernels' CTAs on an NVIDIA card.

    python3 chip_phases.py
    python3 chip_phases.py --vgg16-layer 8

Builds a copy of src/repro_torch/csrc/stream_conv.cu in which thread 0 of
every CTA of the two int8 kernels reads clock64() after each barrier (a
barrier is added after the slab fill), runs cifar10's int8 plan at B=256
(random weights from seed 0) through the int8 pyramid and through the
single-layer kernel layer by layer, and prints per kernel the CUDA-event
time of a call and the median and largest cycles per CTA of each phase:
the layer-0 slab fill, then per layer the staging (tap table, weights,
the next slab's padding) and the GEMM with its epilogue. Warp 0 of each
CTA also sums the cycles of its K loops (the MMAs with their operand
loads), so the GEMM phase splits into the MMAs and the rest (the
epilogue, and the wait for the other warps at the barrier). With
``--vgg16-layer i`` it runs VGG-16's conv layer i alone at B=256 on
random codes instead, through the single-layer kernel's path for it: on
the mma.sync path each launch is one channel slice and the marks are the
last slice's; on the wgmma path thread 0 of each CTA of the persistent
grid sums its cycles in the slab fills and in the K loops over its work
items, the rest being the epilogues. The copy's
library is built apart from the kernels' own; the kernels' numbers in
PERF.md come from chip_smoke.py, these only say where a CTA's time goes.
Imports nothing of JAX and nothing of the reference package.
"""
from __future__ import annotations

import ctypes
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BATCH = 256
PROBE = """__device__ long long sc_prof[1 << 20];
#define SCP(k) if (threadIdx.x == 0) sc_prof[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + (k)] = clock64();
extern "C" int sc_prof_read(long long* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, sc_prof, n * 8);
}
"""
# (anchor in the source, what replaces it): each anchor occurs once.
EDITS = (
    ("#include <cuda_runtime.h>\n", "#include <cuda_runtime.h>\n" + PROBE),
    ("  sc_pyramid_rows(P, rb, olo, ohi, ilo, ihi);\n\n  {  // Layer 0's rows [ilo, ihi) of codes",
     "  SCP(0);\n  sc_pyramid_rows(P, rb, olo, ohi, ilo, ihi);\n\n  {  // Layer 0's rows [ilo, ihi) of codes"),
    ("#pragma unroll 1\n  for (int li = 0; li < P.n_layers; ++li) {\n    const ScLayer& L = P.L[li];\n"
     "    const i8* in = (li & 1) ? buf1 : buf0;\n    sc_build_taps8",
     "  __syncthreads();\n  SCP(1);\n#pragma unroll 1\n  for (int li = 0; li < P.n_layers; ++li) {\n"
     "    const ScLayer& L = P.L[li];\n    const i8* in = (li & 1) ? buf1 : buf0;\n    sc_build_taps8"),
    ("    __syncthreads();\n    if (ohi[li] > olo[li]) sc_gemm_i8_dispatch<true>(J, L.pw, L.tn, L.cpad);\n"
     "    __syncthreads();",
     "    __syncthreads();\n    SCP(2 + 2 * li);\n    if (ohi[li] > olo[li]) sc_gemm_i8_dispatch<true>(J, L.pw, L.tn, L.cpad);\n"
     "    __syncthreads();\n    SCP(3 + 2 * li);"),
    ("  const int row0 = rb * F.r * F.stride;\n  const i8* xb",
     "  SCP(0);\n  const int row0 = rb * F.r * F.stride;\n  const i8* xb"),
    ("  sc_build_taps8(taps, F.k,", "  __syncthreads();\n  SCP(1);\n  sc_build_taps8(taps, F.k,"),
    ("  __syncthreads();\n  sc_gemm_i8_dispatch<false>(J, F.pw, F.tn, F.cpad);\n}",
     "  __syncthreads();\n  SCP(2);\n  sc_gemm_i8_dispatch<false>(J, F.pw, F.tn, F.cpad);\n"
     "  __syncthreads();\n  SCP(3);\n}"),
    ("  for (int task = warp; task < tasks; task += n_warps) {\n    const int mb = task / groups;\n"
     "    const int nt0 = (task - mb * groups) * NT;",
     "  long long scp_k = 0;\n  for (int task = warp; task < tasks; task += n_warps) {\n"
     "    const int mb = task / groups;\n    const int nt0 = (task - mb * groups) * NT;"),
    ("    sc_kloop_i8<MT, NT, LDM>(J, ab, ab8, nt0, acc);\n",
     "    const long long scp_t = clock64();\n    sc_kloop_i8<MT, NT, LDM>(J, ab, ab8, nt0, acc);\n"
     "    scp_k += clock64() - scp_t;\n"),
    ("  }\n}\n\n// Any other pool window, read at run time: the pw * pw positions of 16",
     "  }\n  if (threadIdx.x == 0) {\n    sc_prof[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + 12] = scp_k;\n"
     "    sc_prof[(blockIdx.y * gridDim.x + blockIdx.x) * 16 + 13] = clock64();\n  }\n}\n\n"
     "// Any other pool window, read at run time: the pw * pw positions of 16"),
    # The wgmma path: thread 0 sums its cycles in the slab fills (barrier
    # to barrier) and in the K loops (the stage waits and the wgmmas) over
    # the CTA's work items, and the CTA's whole time: slots 8, 9, 10.
    ("  int acc[2][64];\n",
     "  long long scp_f = 0, scp_m = 0, scp_c = 0;\n  const long long scp_0 = clock64();\n"
     "  int acc[2][64];\n"),
    ("    asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(SC_WG_CONSUMERS) : \"memory\");  "
     "// the last slab is read\n",
     "    asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(SC_WG_CONSUMERS) : \"memory\");\n"
     "    scp_c = clock64();\n"),
    ("    asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(SC_WG_CONSUMERS) : \"memory\");\n"
     "    const unsigned ab0",
     "    asm volatile(\"bar.sync 1, %0;\\n\" ::\"n\"(SC_WG_CONSUMERS) : \"memory\");\n"
     "    scp_f += clock64() - scp_c;\n    const unsigned ab0"),
    ("    for (int nt = 0; nt < F.tn; ++nt) {\n      unsigned a0[2][2][4], a1[2][2][4];\n",
     "    for (int nt = 0; nt < F.tn; ++nt) {\n      scp_c = clock64();\n"
     "      unsigned a0[2][2][4], a1[2][2][4];\n"),
    ("      // Epilogue: dequantize, bias, act per position",
     "      scp_m += clock64() - scp_c;\n      // Epilogue: dequantize, bias, act per position"),
    ("  }\n}\n\n// WG: the wgmma path",
     "  }\n  if (tid == 0) {\n    sc_prof[blockIdx.x * 16 + 8] = scp_f;\n"
     "    sc_prof[blockIdx.x * 16 + 9] = scp_m;\n"
     "    sc_prof[blockIdx.x * 16 + 10] = clock64() - scp_0;\n  }\n}\n\n// WG: the wgmma path"),
)


def vgg16(layer: int, phases, kconv, dev, lib) -> None:
    """VGG-16's conv layer ``layer`` alone at B=256: random stream codes
    of its SAME-padded input, random weight codes, relu and its pool."""
    import torch

    from repro_torch.kernels.stream_conv.epilogue import Int8Scales
    from repro_torch.models.cnn import VGG16

    h, w = VGG16.input_shape
    c = VGG16.input_channels
    for sp in VGG16.conv_layers[:layer]:
        h, w = sp.out_hw(h, w)
        c = sp.n_out
    spec = VGG16.conv_layers[layer]
    gen = torch.Generator(device=dev).manual_seed(layer)
    codes = torch.randint(-128, 128, (BATCH, h + 2, w + 2, c), generator=gen, device=dev,
                          dtype=torch.int8)
    wq = torch.randint(-64, 64, (3, 3, c, spec.n_out), generator=gen, device=dev,
                       dtype=torch.int8)
    b = 0.05 * torch.randn(spec.n_out, generator=gen, device=dev)
    sc = Int8Scales(in_bits=8, w_scale=2.0 ** -10)
    g = kconv.fused_plan(h + 2, w + 2, c, k=3, stride=1, pool=spec.pool, pool_stride=None,
                         block_r=8, n_out=spec.n_out, elem_bytes=1)
    what = (f"VGG-16 layer {layer} ({h}x{w}x{c} -> {spec.n_out}), {g['path']} path, "
            f"{len(g['slices'])} slices of {g['n_rb'] * BATCH} work items, {g['threads']} "
            f"threads, {g['smem']} B")
    wk = kconv.kmajor_weights(wq) if g["path"] == "wgmma" else None

    def fn():
        return kconv.stream_conv_fused_cuda(codes, wq, b, act="relu", pool=spec.pool, act_bits=8,
                                            int8_scales=sc, w_kmajor=wk)

    if g["path"] != "wgmma":
        phases(fn, g["n_rb"] * BATCH, 4, what + " [fill, stage, GEMM]")
        return
    import numpy as np

    grid = min(g["n_rb"] * BATCH, torch.cuda.get_device_properties(dev).multi_processor_count)
    fn()
    torch.cuda.synchronize()
    marks = np.zeros(grid * 16, np.int64)
    if lib.sc_prof_read(marks.ctypes.data, marks.size):
        raise RuntimeError("chip_phases: reading the clock marks failed")
    m = marks.reshape(grid, 16)[:, 8:11].astype(np.float64)
    fill, main, total = (np.median(m[:, i]) for i in range(3))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(20):
        fn()
    end.record()
    torch.cuda.synchronize()
    print(f"{what}: {start.elapsed_time(end) / 20:.4f} ms a call (CUDA events); {grid} CTAs, "
          f"cycles per CTA (thread 0, summed over its items), median: whole {total:.0f}, slab "
          f"fills {fill:.0f}, K loops {main:.0f}, epilogues and the rest "
          f"{total - fill - main:.0f}")
    # The plain version (float64 sums of the codes) on the same operands:
    # its time, and whether the kernel's output equals it.
    from repro_torch.kernels.stream_conv import stream_conv_block_ref

    x = codes.float() * sc.in_scale
    kw = dict(padding="VALID", act="relu", pool=spec.pool, act_bits=8, int8_scales=sc)
    ref = stream_conv_block_ref(x, wq, b, **kw)
    start.record()
    ref = stream_conv_block_ref(x, wq, b, **kw)
    end.record()
    torch.cuda.synchronize()
    print(f"  plain version {start.elapsed_time(end):.2f} ms a call (CUDA events); the kernel "
          f"equals it: {bool(torch.equal(fn(), ref))}")


def main() -> None:
    import torch

    vgg_layer = None
    if sys.argv[1:2] == ["--vgg16-layer"]:
        vgg_layer = int(sys.argv[2])

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    import numpy as np

    from repro_torch.core.dhm import QuantSpec, compile_dhm
    from repro_torch.core.quant.fixed_point import quantize_fixed
    from repro_torch.kernels import _nvcc
    from repro_torch.kernels.stream_conv import stream_conv_block_ref
    from repro_torch.kernels.stream_conv.halo import as_pyramid_layers, group_geometry
    from repro_torch.kernels.stream_conv.ops import _pad_same
    from repro_torch.models.cnn import ALL_TOPOLOGIES, init_cnn

    src = (_nvcc.CSRC_DIR / "stream_conv.cu").read_text()
    for anchor, new in EDITS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"chip_phases: anchor not found once in stream_conv.cu: {anchor!r}")
        src = src.replace(anchor, new)
    probe_dir = _nvcc.BUILD_DIR / "phases_csrc"
    probe_dir.mkdir(parents=True, exist_ok=True)
    (probe_dir / "stream_conv.cu").write_text(src)
    _nvcc.CSRC_DIR = probe_dir  # this process builds and loads the probed copy
    from repro_torch.kernels.stream_conv import conv as kconv

    lib = kconv._library()
    lib.sc_prof_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    out = os.popen("nvidia-smi --query-gpu=name,power.limit,clocks.sm --format=csv,noheader").read()
    print(out.strip())

    topo = ALL_TOPOLOGIES["cifar10"]
    dev = torch.device("cuda")
    params = init_cnn(torch.Generator().manual_seed(0), topo, device=dev)
    plan = compile_dhm(topo, params, quant=QuantSpec(weight_bits=8, act_bits=8, int8_compute=True))
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(BATCH, *topo.input_shape, topo.input_channels)).astype(np.float32)).to(dev)
    sc8 = plan.int8_scales
    ws = [p["w"] for p in plan.conv_params]
    bs = [p["b"] for p in plan.conv_params]
    specs = topo.conv_layers

    def phases(fn, n_blocks, n_marks, what):
        fn()
        torch.cuda.synchronize()
        marks = np.zeros(n_blocks * 16, np.int64)
        if lib.sc_prof_read(marks.ctypes.data, marks.size):
            raise RuntimeError("chip_phases: reading the clock marks failed")
        m = marks.reshape(n_blocks, 16).astype(np.float64)
        t = m[:, :n_marks]
        d = np.diff(t, axis=1)
        kloop, w0_end = m[:, 12], m[:, 13] - t[:, n_marks - 2]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(20):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(f"{what}: {start.elapsed_time(end) / 20:.4f} ms a call (CUDA events, the probes "
              f"included); cycles per CTA, median {np.median(t[:, -1] - t[:, 0]):.0f}; per phase "
              f"median {np.median(d, axis=0).round().astype(int).tolist()}, largest "
              f"{d.max(axis=0).round().astype(int).tolist()}; warp 0 of the last GEMM: K loops "
              f"median {np.median(kloop):.0f}, the rest {np.median(w0_end - kloop):.0f} cycles")

    if vgg_layer is not None:
        vgg16(vgg_layer, phases, kconv, dev, lib)
        return
    x8 = quantize_fixed(x, sc8[0].in_spec).to(torch.int8)
    geom = group_geometry(*topo.input_shape, topo.input_channels, as_pyramid_layers(specs),
                          tuple(s.kernel for s in specs), tuple(s.n_out for s in specs),
                          block_rows=plan.fusion_groups[0].block_rows)
    bits = (8,) * len(specs)
    phases(lambda: kconv.stream_conv_pyramid_cuda(x8, ws, bs, geom=geom, act_bits=bits,
                                                  int8_scales=sc8),
           geom.n_row_blocks * BATCH, 2 + 2 * len(specs),
           "int8 pyramid [fill, then stage and GEMM per layer]")
    xin = x
    for i, spec in enumerate(specs):
        codes = _pad_same(quantize_fixed(xin, sc8[i].in_spec).to(torch.int8), spec.kernel)
        codes = codes.contiguous()
        g = kconv.fused_geometry(*codes.shape[1:], k=spec.kernel, stride=1, pool=spec.pool,
                                 pool_stride=spec.pool_stride, block_r=8, n_out=spec.n_out,
                                 elem_bytes=1)
        phases(lambda: kconv.stream_conv_fused_cuda(codes, ws[i], bs[i], act=spec.act,
                                                    pool=spec.pool, act_bits=8,
                                                    int8_scales=sc8[i]),
               g["n_rb"] * BATCH, 4,
               f"int8 single layer {i}, {g['n_rb'] * BATCH} CTAs [fill, stage, GEMM]")
        xin = stream_conv_block_ref(xin, ws[i], bs[i], padding="SAME", act=spec.act,
                                    pool=spec.pool, act_bits=8, int8_scales=sc8[i])


if __name__ == "__main__":
    main()
