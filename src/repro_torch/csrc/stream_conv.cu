// Hand-written Hopper (sm_90a) kernels for the streaming conv actor chain.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/stream_conv/conv.py). Every entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// sc_pyramid_kernel
//   Replaces: src/repro/kernels/stream_conv/conv.py:stream_conv_pyramid_pallas
//             (body _pyramid_kernel, _assemble_taps).
//   Computes: a whole fusion group of conv -> bias -> max-pool -> act ->
//             stream-quant layers (pool_first order) for one block of the
//             group's final output rows.
//   Bound on this card: operations. cifar10 at B=256 is 6.29 GFLOP of fp32
//             FMA against 67 TFLOP/s (about 94 us) while its bytes (frame,
//             weights, features: about 4.5 MB) take about 1.4 us at
//             3.35 TB/s. What limits a direct conv on CUDA cores is the
//             shared-memory traffic and the latency per FMA: one thread per
//             output reads one slab word per FMA and waits on one weight
//             from L2 every pw*pw FMAs (about 7.7 TFLOP/s here).
//   Design:   one CTA per (row block, image), 256 threads, two CTAs per SM.
//             The CTA reads only its halo'd layer-0 rows from global memory
//             (zeros outside the frame and in the SAME pad columns), then
//             keeps every inter-layer slab in shared memory, ping-ponging
//             two buffers. A slab holds only the rows that the conv
//             positions the block really computes will read (the SAME
//             padding rows among them as zeros), so rows that only feed the
//             masked padding are neither computed nor stored. Each layer
//             is an implicit GEMM (sc_gemm below): M = the pooled windows'
//             conv positions, N = n_out, K = k*k*C in the weights' (ki, kj,
//             c) order. Two CTAs fit an SM (cifar10: 108,096 B of shared
//             memory each), so the 256 images of B=256 run in one wave.
//
// sc_fused_kernel
//   Replaces: src/repro/kernels/stream_conv/conv.py:stream_conv_fused_pallas
//             (body _kernel_body, _block_multiple).
//   Computes: one conv layer on a host-SAME-padded frame with the fused
//             bias -> act -> max-pool -> stream-quant epilogue (the paper's
//             conv -> act -> pool order).
//   Bound on this card: operations, as above (cifar10's three layers at
//             B=256: 6.29 GFLOP against 67 TFLOP/s).
//   Design:   one CTA per (row block, image). The CTA stages its input rows
//             (block rows plus the halo of _block_multiple: the conv window
//             overlap and the recomputed pool-overlap rows) in shared
//             memory, then runs the same implicit GEMM as one pyramid layer.
//             Its size is the host's (conv.py fused_tile): one warp per
//             warp task, up to eight, so a block of few windows takes the
//             larger tile (TN = 8) in a smaller CTA rather than TN = 4.
//             A launch covers one column strip and channel slice of the
//             layer (conv.py fused_plan): the host offsets the pointers and
//             passes the frame's and the output's strides, so a frame too
//             wide for one block, or weight stages too wide, run as several
//             launches into one output tensor.
//
// sc_gemm, the core of both fp32 kernels (IEEE fp32 FMA, no TF32):
//   - Weights: K-slices of SC_KC rows are copied into shared memory with
//     cp.async (16-byte copies where N % 4 == 0), double-buffered and read
//     by every warp of the CTA as float4 broadcasts.
//   - A operand: gathered straight from the slab through a per-layer table
//     of tap offsets (k -> ki * rs + kj * cs + c) plus each conv
//     position's base; patches are never materialised. Stride 2 only
//     changes the bases.
//   - Register tile: each thread holds whole pool windows (PW*PW conv
//     positions, four windows when there is no pool) times TN = 4 or 8
//     output channels, so the max-pool stays in registers. Per k it loads
//     one slab word per position and TN/4 float4 weights for TM*TN FMAs.
//     A warp covers 16 windows x 2 channel groups: the two halves share
//     each slab word (broadcast) and each half shares one weight float4.
//   - Bank conflicts: a slab column is cs = C words for odd C and C + 1
//     for even C, and a slab row rs = cols * cs words plus a pad that the
//     host picks (conv.py row_stride), so the 16 windows of a warp, whose
//     bases differ by multiples of the pool stride times cs and rs, fall
//     in distinct banks where the geometry allows (C = 32 with cs = C
//     would put all 16 in one bank).
//   - The K loop runs in (ki, kj, c) order with one accumulator per
//     output: one fp32 FMA chain, no split of K. Ragged M and N are
//     masked at the store (clamped reads), ragged K with zero weight rows.
//   - Epilogue in registers, in the reference orders: pyramid bias ->
//     max-pool -> act -> quant (the bias added once after the max, since
//     max(a + b, c + b) == max(a, c) + b), single layer bias -> act ->
//     pool -> quant; it writes straight into the next slab's padded layout
//     or to global memory.
//   - Pool windows 2 and 3 are compiled (and a window of one position is
//     the unpooled tile with the pool stride as pitch); every other window
//     runs sc_gemm_window, which reads it at run time and folds the
//     window's conv positions one K loop at a time into a running max.
//
// sc_pyramid_i8_kernel, sc_fused_i8_kernel
//   Replace:  the int8 paths of the same two Pallas kernels
//             (Int8Scales given: conv.py:102-108 and 122-123 for the single
//             layer, 385-429 for the pyramid with codes_out at 428).
//   Compute:  the same chains on int8 codes: int8 frame (quantized by the
//             wrapper, padding is code 0) and int8 weight codes, int32
//             accumulation, y = float(acc) * deq_scale (exact: a power of
//             two), then the fp32 epilogue. Interior pyramid layers write
//             int8 stream codes (rintf, clip) into the next slab; the last
//             layer, and the single-layer kernel, write fp32 grid values.
//   Bound on this card: operations. cifar10 at B=256 is 6.29 Gop of int8
//             products against the dense int8 tensor-core peak of 1,979
//             TOP/s (3.2 us), while its bytes (0.8 MB of int8 frame, 79 KB
//             of int8 weights, 1.0 MB of fp32 output) take 0.6 us at
//             3.35 TB/s. These kernels run on CUDA cores, whose int32 rate
//             is far below that peak.
//   Design:   one CTA per (row block, image) over 1-byte slabs of the whole
//             halo'd rows, one thread per pooled output. Where the channel
//             count is a multiple of four (every layer but a 3-channel
//             frame) the inner loop reads four channels of the slab as one
//             32-bit word and packs the four weight bytes of one output
//             channel, then issues one __dp4a per conv position of the pool
//             window; otherwise it multiplies byte by byte. Weights stay in
//             global memory and L2 (79,200 B of int8 for cifar10), read
//             coalesced across the warp's 32 output channels. Pool windows
//             other than 1, 2 and 3 are read at run time (PW = 0), their
//             positions summed one at a time.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#define SC_MAX_LAYERS 4
#define SC_THREADS 256
#define SC_KC 64  // weight rows (K) per shared-memory stage

struct ScLayer {
  const float* w;  // (K, K, C, N) HWIO, contiguous (int8 codes in the int8 kernel)
  const float* b;  // (N,)
  int k, stride, act, pw, ps;  // act: 0 none, 1 relu, 2 tanh; no pool: pw = ps = 1
  int qbits;                   // 0: no stream quantization
  float qscale, qmin, qmax;
  int in_rows, in_cols, in_ch, pad_l, pad_r;
  int out_cols, n_out;
  int in_mult, in_off, in_slab_rows, out_slab_rows;
  float deq;  // int8 kernels: int32 accumulator -> fp32 (a power of two)
  // fp32 kernels: slab column and row strides (words), output channels per
  // thread (4 or 8), staged weight row stride (N rounded up to tn), and
  // whether the weights may be copied 16 bytes at a time.
  int cs, rs, tn, np, wvec;
};

struct ScPyramid {
  const float* x;  // (B, H, W, C0), unpadded (int8 codes in the int8 kernel)
  float* out;      // (B, out_rows, out_cols, N_last)
  int batch, n_layers, n_rb, block_rows, out_rows;
  int buf0_elems;  // elements of the first ping-pong buffer
  // fp32 kernel: float offsets of the tap table and the two weight stages,
  // and the floats of one stage.
  int tap_off, wst_off, wst_elems;
  ScLayer L[SC_MAX_LAYERS];
};

struct ScFused {
  // One column strip and channel slice of a layer (the host offsets the
  // pointers to the strip's first input and output column and the slice's
  // first channel): the strip's w_in input columns of rows x_rs elements
  // apart, weights (K, K, C, n) of rows w_ld apart, n biases, and outputs
  // (h_keep, w_keep, n) at out[r * out_rs + c * out_cs + n].
  const float* x;  // (B, H, W, C), already SAME-padded (int8: codes)
  const float* w;  // (K, K, C, N) (int8: codes)
  const float* b;  // (N,)
  float* out;      // (B, h_keep, W_keep, N)
  long long x_img, out_img;  // elements per image of x and out
  int x_rs, out_rs, out_cs, w_ld;
  int batch, h, w_in, c, n, k, stride, act, pw, ps, qbits;
  float qscale, qmin, qmax;
  int h_keep, w_keep, r, r_o, in_rows_blk, n_rb;
  float deq;  // int8 kernel: int32 accumulator -> fp32 (a power of two)
  int cs, rs, tn, np, wvec, tap_off, wst_off, wst_elems;  // fp32 kernel, as above
  int threads;  // fp32 kernel: threads per CTA (a multiple of 32, at most 256)
};

__device__ __forceinline__ float sc_act(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) return tanhf(y);
  return y;
}

// clip(round_half_even(y / scale), qmin, qmax) * scale, as jnp.round.
__device__ __forceinline__ float sc_quant(float y, int qbits, float scale,
                                          float qmin, float qmax) {
  if (qbits == 0) return y;
  float q = rintf(y / scale);
  q = fminf(fmaxf(q, qmin), qmax);
  return q * scale;
}

// ---------------------------------------------------------------------------
// The implicit-GEMM core of the fp32 kernels.

__device__ __forceinline__ void sc_cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void sc_cp4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

template <int N>
__device__ __forceinline__ void sc_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One layer's implicit GEMM: conv positions of whole pool windows against
// the layer's weights, then the fused epilogue.
struct ScJob {
  const float* in;  // slab: row 0 is the first row window row 0 reads
  int rs, cs, s;    // slab row and column strides (floats), conv stride
  int ps;           // pool stride (1 without a pool)
  int n_wr, n_wc;   // pooled output rows and columns computed
  int n, kdim;      // N, K = k * k * C
  const int* taps;  // shared: slab offset of each k, round_up(K, 4) entries
  const float* w;   // global (K, N), rows w_ld floats apart
  const float* b;   // global (N,)
  int w_ld;
  int np, wvec;     // staged row stride; 16-byte copies allowed
  float* wst;       // shared: two stages of SC_KC x np floats
  int wst_elems;
  int act, qbits;
  float qscale, qmin, qmax;
  float* dst;  // output element (r, c, n) at dst[r*dst_rs + (c+dst_co)*dst_cs + n]
  int dst_rs, dst_cs, dst_co;
};

// Weight rows [k0, k0 + kc) into one stage (row stride np), rows
// [kc, kc4) zeroed; commits one cp.async group.
__device__ __forceinline__ void sc_stage_weights(const ScJob& J, float* st, int k0,
                                                 int kc, int kc4) {
  if (J.wvec) {
    const int n4 = J.n >> 2;
    for (int i = threadIdx.x; i < kc * n4; i += blockDim.x) {
      const int r = i / n4, q = i - r * n4;
      sc_cp16(st + r * J.np + 4 * q, J.w + (size_t)(k0 + r) * J.w_ld + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < kc * J.n; i += blockDim.x) {
      const int r = i / J.n, q = i - r * J.n;
      sc_cp4(st + r * J.np + q, J.w + (size_t)(k0 + r) * J.w_ld + q);
    }
  }
  for (int i = threadIdx.x; i < (kc4 - kc) * J.np; i += blockDim.x)
    st[kc * J.np + i] = 0.0f;
  asm volatile("cp.async.commit_group;\n" ::);
}

// The tap table of a slab with row stride rs and column stride cs.
__device__ __forceinline__ void sc_build_taps(int* taps, int k, int C, int rs, int cs) {
  const int kdim = k * k * C;
  const int k4 = (kdim + 3) & ~3;
  for (int i = threadIdx.x; i < k4; i += blockDim.x) {
    int off = 0;
    if (i < kdim) {
      const int ki = i / (k * C);
      const int rem = i - ki * k * C;
      const int kj = rem / C;
      off = ki * rs + kj * cs + (rem - kj * C);
    }
    taps[i] = off;
  }
}

// The K loop of one warp task: TM conv positions (slab bases pbase) x TN
// channels from n0, one fp32 FMA chain per output in (ki, kj, c) order,
// over weight stages double-buffered by cp.async. Every thread of the CTA
// calls it (it synchronises).
template <int TM, int TN>
__device__ __forceinline__ void sc_kloop(const ScJob& J, const int (&pbase)[TM], int n0,
                                         float (&acc)[TM][TN]) {
  const int nchunks = (J.kdim + SC_KC - 1) / SC_KC;
#pragma unroll
  for (int p = 0; p < TM; ++p)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[p][q] = 0.0f;

  {
    const int kc = min(SC_KC, J.kdim);
    sc_stage_weights(J, J.wst, 0, kc, (kc + 3) & ~3);
  }
  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) {
      const int k1 = (c + 1) * SC_KC;
      const int kc = min(SC_KC, J.kdim - k1);
      sc_stage_weights(J, J.wst + ((c + 1) & 1) * J.wst_elems, k1, kc, (kc + 3) & ~3);
      sc_cp_wait<1>();
    } else {
      sc_cp_wait<0>();
    }
    __syncthreads();
    const int k0 = c * SC_KC;
    const int kc4 = (min(SC_KC, J.kdim - k0) + 3) & ~3;
    const float* ws = J.wst + (c & 1) * J.wst_elems + n0;
    const int* tp = J.taps + k0;
#pragma unroll 2
    for (int kk = 0; kk < kc4; kk += 4) {
      const int4 o4 = *reinterpret_cast<const int4*>(tp + kk);
      const int offs[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float a[TM];
#pragma unroll
        for (int p = 0; p < TM; ++p) a[p] = J.in[pbase[p] + offs[u]];
        float bv[TN];
        const float4* wp = reinterpret_cast<const float4*>(ws + (kk + u) * J.np);
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = wp[q];
          bv[4 * q] = v.x;
          bv[4 * q + 1] = v.y;
          bv[4 * q + 2] = v.z;
          bv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int p = 0; p < TM; ++p)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[p][q] = fmaf(a[p], bv[q], acc[p][q]);
      }
    }
    __syncthreads();  // the stage is refilled two chunks on
  }
}

// PW: pool window (1 = none); WPT: windows per thread; TN: channels per
// thread. Every thread of the CTA calls it (it synchronises).
template <int PW, int WPT, int TN, bool POOL_FIRST>
__device__ __forceinline__ void sc_gemm(const ScJob& J) {
  constexpr int PP = PW * PW;
  constexpr int TM = WPT * PP;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_win = J.n_wr * J.n_wc;
  const int groups = (J.n + TN - 1) / TN;
  const int gpairs = (groups + 1) >> 1;
  const int tasks = ((n_win + 16 * WPT - 1) / (16 * WPT)) * gpairs;
  const int rounds = (tasks + n_warps - 1) / n_warps;
  const int win_step = J.ps * J.s;

  for (int rd = 0; rd < rounds; ++rd) {
    const int task = rd * n_warps + warp;
    const bool live = task < tasks;
    const int t = live ? task : 0;
    const int wb = t / gpairs;
    const int g = (t - wb * gpairs) * 2 + (lane >> 4);
    const int n0 = min(g, groups - 1) * TN;  // clamped: reads stay in the stage
    int win[WPT];
    int pbase[TM];
#pragma unroll
    for (int w = 0; w < WPT; ++w) {
      win[w] = wb * 16 * WPT + (lane & 15) + 16 * w;
      const int wv = win[w] < n_win ? win[w] : 0;
      const int wr = wv / J.n_wc;
      const int wc = wv - wr * J.n_wc;
      const int base = wr * win_step * J.rs + wc * win_step * J.cs;
#pragma unroll
      for (int i = 0; i < PW; ++i)
#pragma unroll
        for (int j = 0; j < PW; ++j)
          pbase[w * PP + i * PW + j] = base + i * J.s * J.rs + j * J.s * J.cs;
    }
    float acc[TM][TN];
    sc_kloop<TM, TN>(J, pbase, n0, acc);

    if (!live || g >= groups) continue;
#pragma unroll
    for (int w = 0; w < WPT; ++w) {
      if (win[w] >= n_win) continue;
      const int wr = win[w] / J.n_wc;
      const int wc = win[w] - wr * J.n_wc;
      float* d = J.dst + wr * J.dst_rs + (wc + J.dst_co) * J.dst_cs;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int n = n0 + q;
        if (n >= J.n) break;
        const float bv = __ldg(J.b + n);
        float y;
        if (POOL_FIRST) {
          float m = acc[w * PP][q];
#pragma unroll
          for (int p = 1; p < PP; ++p) m = fmaxf(m, acc[w * PP + p][q]);
          y = sc_act(m + bv, J.act);
        } else {
          y = sc_act(acc[w * PP][q] + bv, J.act);
#pragma unroll
          for (int p = 1; p < PP; ++p) y = fmaxf(y, sc_act(acc[w * PP + p][q] + bv, J.act));
        }
        d[n] = sc_quant(y, J.qbits, J.qscale, J.qmin, J.qmax);
      }
    }
  }
}

// Any other pool window, read at run time: one window per thread and
// TN = 4 channels, the PW x PW conv positions of the window one after the
// other, each a whole K loop, folded into a running max in the kernel's
// order (pool first: the max of the sums, then bias and act; else bias and
// act per position, then the max). Slower than a compiled window (the
// weights are staged once per position); it serves the windows the
// reference takes and no topology of the paper uses.
template <bool POOL_FIRST>
__device__ __forceinline__ void sc_gemm_window(const ScJob& J, int pw) {
  constexpr int TN = 4;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int n_win = J.n_wr * J.n_wc;
  const int groups = (J.n + TN - 1) / TN;
  const int gpairs = (groups + 1) >> 1;
  const int tasks = ((n_win + 15) / 16) * gpairs;
  const int rounds = (tasks + n_warps - 1) / n_warps;
  const int win_step = J.ps * J.s;

  for (int rd = 0; rd < rounds; ++rd) {
    const int task = rd * n_warps + warp;
    const bool live = task < tasks;
    const int t = live ? task : 0;
    const int wb = t / gpairs;
    const int g = (t - wb * gpairs) * 2 + (lane >> 4);
    const int n0 = min(g, groups - 1) * TN;
    const int win = wb * 16 + (lane & 15);
    const int wv = win < n_win ? win : 0;
    const int wr = wv / J.n_wc;
    const int wc = wv - wr * J.n_wc;
    const int base = wr * win_step * J.rs + wc * win_step * J.cs;
    float m[TN];
    for (int pos = 0; pos < pw * pw; ++pos) {
      const int pi = pos / pw;
      const int pbase[1] = {base + pi * J.s * J.rs + (pos - pi * pw) * J.s * J.cs};
      float acc[1][TN];
      sc_kloop<1, TN>(J, pbase, n0, acc);
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        float v = acc[0][q];
        if (!POOL_FIRST) v = sc_act(v + __ldg(J.b + min(n0 + q, J.n - 1)), J.act);
        m[q] = pos ? fmaxf(m[q], v) : v;
      }
    }
    if (!live || g >= groups || win >= n_win) continue;
    float* d = J.dst + wr * J.dst_rs + (wc + J.dst_co) * J.dst_cs;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int n = n0 + q;
      if (n >= J.n) break;
      const float y = POOL_FIRST ? sc_act(m[q] + __ldg(J.b + n), J.act) : m[q];
      d[n] = sc_quant(y, J.qbits, J.qscale, J.qmin, J.qmax);
    }
  }
}

// The instantiations the host may pick (conv.py tile_n, fused_tile): no
// pool (or a window of one position, the pool stride its pitch) takes four
// windows per thread, pool windows 2 and 3 one; pool window 3 only with
// TN = 4; every other window the run-time path above.
template <bool POOL_FIRST>
__device__ __forceinline__ void sc_gemm_dispatch(const ScJob& J, int pw, int tn) {
  if (pw == 2) {
    if (tn == 8) sc_gemm<2, 1, 8, POOL_FIRST>(J);
    else sc_gemm<2, 1, 4, POOL_FIRST>(J);
  } else if (pw == 3) {
    sc_gemm<3, 1, 4, POOL_FIRST>(J);
  } else if (pw == 1) {
    if (tn == 8) sc_gemm<1, 4, 8, POOL_FIRST>(J);
    else sc_gemm<1, 4, 4, POOL_FIRST>(J);
  } else {
    sc_gemm_window<POOL_FIRST>(J, pw);
  }
}

__device__ __forceinline__ ScJob sc_job(const ScLayer& L, const float* in, int rs,
                                        int n_wr, const int* taps, float* wst,
                                        int wst_elems) {
  ScJob J;
  J.in = in;
  J.rs = rs;
  J.cs = L.cs;
  J.s = L.stride;
  J.ps = L.ps;
  J.n_wr = n_wr;
  J.n_wc = L.out_cols;
  J.n = L.n_out;
  J.kdim = L.k * L.k * L.in_ch;
  J.taps = taps;
  J.w = L.w;
  J.b = L.b;
  J.w_ld = L.n_out;
  J.np = L.np;
  J.wvec = L.wvec;
  J.wst = wst;
  J.wst_elems = wst_elems;
  J.act = L.act;
  J.qbits = L.qbits;
  J.qscale = L.qscale;
  J.qmin = L.qmin;
  J.qmax = L.qmax;
  return J;
}

__global__ void __launch_bounds__(SC_THREADS, 2)
    sc_pyramid_kernel(const ScPyramid P) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + P.buf0_elems;
  int* const taps = reinterpret_cast<int*>(smem + P.tap_off);
  float* const wst = smem + P.wst_off;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;

  // Rows of each layer's output that this block computes, [olo, ohi) in
  // out-slab coordinates, and the input rows they read, [ilo, ihi) in
  // in-slab coordinates, last layer first: a layer computes the rows of
  // the next layer's frame that the next layer reads (conv.py
  // pyramid_rows is the same walk on the host).
  int olo[SC_MAX_LAYERS], ohi[SC_MAX_LAYERS], ilo[SC_MAX_LAYERS], ihi[SC_MAX_LAYERS];
#pragma unroll 1
  for (int li = P.n_layers - 1; li >= 0; --li) {
    {
      const ScLayer& L = P.L[li];
      int lo, hi;
      if (li + 1 < P.n_layers) {
        const int nx = li + 1;
        const ScLayer& Nx = P.L[nx];
        const int start = Nx.in_mult * rb + Nx.in_off;
        lo = max(max(0, -start), ilo[nx]);
        hi = min(min(L.out_slab_rows, Nx.in_rows - start), ihi[nx]);
      } else {
        lo = 0;
        hi = min(P.block_rows, P.out_rows - rb * P.block_rows);
      }
      olo[li] = lo;
      ohi[li] = hi;
      if (hi > lo) {
        ilo[li] = lo * L.ps * L.stride;
        ihi[li] = ((hi - 1) * L.ps + L.pw - 1) * L.stride + L.k;
      } else {
        ilo[li] = ihi[li] = 0;
      }
    }
  }

  {  // Layer 0's rows [ilo, ihi), column-padded, zero outside the frame.
    const ScLayer& L0 = P.L[0];
    const int cols = L0.in_cols + L0.pad_l + L0.pad_r;
    const int C = L0.in_ch;
    const int start = L0.in_mult * rb + L0.in_off + ilo[0];
    const int total = (ihi[0] - ilo[0]) * cols * C;
    const float* xb = P.x + (size_t)bi * L0.in_rows * L0.in_cols * C;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx % C;
      const int pc = (idx / C) % cols;
      const int rr = idx / (C * cols);
      const int gr = start + rr;
      const int gc = pc - L0.pad_l;
      float v = 0.0f;
      if (gr >= 0 && gr < L0.in_rows && gc >= 0 && gc < L0.in_cols)
        v = __ldg(xb + ((size_t)gr * L0.in_cols + gc) * C + c);
      buf0[rr * L0.rs + pc * L0.cs + c] = v;
    }
  }

  // Not unrolled: one inlined copy of each GEMM instantiation.
#pragma unroll 1
  for (int li = 0; li < P.n_layers; ++li) {
    {
      const ScLayer& L = P.L[li];
      const float* in = (li & 1) ? buf1 : buf0;
      sc_build_taps(taps, L.k, L.in_ch, L.rs, L.cs);
      ScJob J = sc_job(L, in, L.rs, ohi[li] - olo[li], taps, wst, P.wst_elems);
      if (li + 1 < P.n_layers) {
        const int nx = li + 1;
        const ScLayer& Nx = P.L[nx];
        const int cols_n = Nx.in_cols + Nx.pad_l + Nx.pad_r;
        float* dst = (li & 1) ? buf0 : buf1;
        J.dst_rs = Nx.rs;
        J.dst_cs = Nx.cs;
        J.dst_co = Nx.pad_l;
        J.dst = dst + (olo[li] - ilo[nx]) * J.dst_rs;
        // The next layer's SAME padding: its stored rows outside the
        // computed ones and its pad columns read as zero.
        const int N = L.n_out;
        const int total = (ihi[nx] - ilo[nx]) * cols_n * N;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
          const int n = idx % N;
          const int pc = (idx / N) % cols_n;
          const int rr = idx / (N * cols_n);
          const int r = ilo[nx] + rr;
          if (r < olo[li] || r >= ohi[li] || pc < Nx.pad_l || pc >= Nx.pad_l + Nx.in_cols)
            dst[rr * Nx.rs + pc * Nx.cs + n] = 0.0f;
        }
      } else {
        J.dst = P.out + ((size_t)bi * P.out_rows + (size_t)rb * P.block_rows) *
                            L.out_cols * L.n_out;
        J.dst_rs = L.out_cols * L.n_out;
        J.dst_cs = L.n_out;
        J.dst_co = 0;
      }
      if (ohi[li] > olo[li]) sc_gemm_dispatch<true>(J, L.pw, L.tn);
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(SC_THREADS, 2) sc_fused_kernel(const ScFused F) {
  extern __shared__ __align__(16) float smem[];
  float* const slab = smem;
  int* const taps = reinterpret_cast<int*>(smem + F.tap_off);
  float* const wst = smem + F.wst_off;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;
  const int row0 = rb * F.r * F.stride;
  const int strip = F.w_in * F.c;  // elements of one slab row
  const int total = F.in_rows_blk * strip;
  const float* xb = F.x + (size_t)bi * F.x_img + (size_t)row0 * F.x_rs;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int row = idx / strip;
    const int e = idx - row * strip;
    const int pix = e / F.c;
    // rows past the frame read 0
    slab[row * F.rs + pix * F.cs + (e - pix * F.c)] =
        row0 + row < F.h ? __ldg(xb + (size_t)row * F.x_rs + e) : 0.0f;
  }
  const int rs = F.rs;
  sc_build_taps(taps, F.k, F.c, rs, F.cs);
  const int po_lo = rb * F.r_o;
  const int po_hi = min(F.h_keep, po_lo + F.r_o);
  ScJob J;
  J.in = slab;
  J.rs = rs;
  J.cs = F.cs;
  J.s = F.stride;
  J.ps = F.ps;
  J.n_wr = po_hi - po_lo;
  J.n_wc = F.w_keep;
  J.n = F.n;
  J.kdim = F.k * F.k * F.c;
  J.taps = taps;
  J.w = F.w;
  J.b = F.b;
  J.w_ld = F.w_ld;
  J.np = F.np;
  J.wvec = F.wvec;
  J.wst = wst;
  J.wst_elems = F.wst_elems;
  J.act = F.act;
  J.qbits = F.qbits;
  J.qscale = F.qscale;
  J.qmin = F.qmin;
  J.qmax = F.qmax;
  J.dst = F.out + (size_t)bi * F.out_img + (size_t)po_lo * F.out_rs;
  J.dst_rs = F.out_rs;
  J.dst_cs = F.out_cs;
  J.dst_co = 0;
  sc_gemm_dispatch<false>(J, F.pw, F.tn);  // its first barrier covers the slab and taps
}

// ---------------------------------------------------------------------------
// int8 kernels.

typedef signed char i8;

// The stream quantization's code: clip(round_half_even(y / scale)).
__device__ __forceinline__ float sc_code(float y, float scale, float qmin,
                                         float qmax) {
  return fminf(fmaxf(rintf(y / scale), qmin), qmax);
}

// The int32 sums of the PW x PW conv positions of one pool window, for
// output channel n, over an int8 HWC slab.
template <int PW>
__device__ __forceinline__ void sc_window_i8(
    const i8* __restrict__ in, int cols, int C, const i8* __restrict__ w,
    int N, int n, int k, int s, int cr0, int cc0, int (&acc)[PW][PW]) {
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int j = 0; j < PW; ++j) acc[i][j] = 0;
  const int rs = cols * C;
  const bool words = (C & 3) == 0;  // four channels per aligned 32-bit word
  for (int ki = 0; ki < k; ++ki) {
    for (int kj = 0; kj < k; ++kj) {
      const i8* wp = w + (size_t)((ki * k + kj) * C) * N + n;
      const i8* ip = in + (cr0 * s + ki) * rs + (cc0 * s + kj) * C;
      if (words) {
        for (int c = 0; c < C; c += 4) {
          const int wv = (int)(unsigned char)__ldg(wp + (size_t)c * N) |
                         ((int)(unsigned char)__ldg(wp + (size_t)(c + 1) * N) << 8) |
                         ((int)(unsigned char)__ldg(wp + (size_t)(c + 2) * N) << 16) |
                         ((int)(unsigned char)__ldg(wp + (size_t)(c + 3) * N) << 24);
#pragma unroll
          for (int i = 0; i < PW; ++i)
#pragma unroll
            for (int j = 0; j < PW; ++j)
              acc[i][j] = __dp4a(
                  *reinterpret_cast<const int*>(ip + i * s * rs + j * s * C + c),
                  wv, acc[i][j]);
        }
      } else {
        for (int c = 0; c < C; ++c) {
          const int wv = (int)__ldg(wp + (size_t)c * N);
#pragma unroll
          for (int i = 0; i < PW; ++i)
#pragma unroll
            for (int j = 0; j < PW; ++j)
              acc[i][j] += (int)ip[i * s * rs + j * s * C + c] * wv;
        }
      }
    }
  }
}

// One pooled output of channel n before the stream quantization: the int32
// sums dequantized by deq (a power of two: exact), then POOL_FIRST
// bias -> pool -> act (pyramid) or bias -> act -> pool (single layer).
// Dequantization and bias are monotone, so the pool-first path takes the
// max of the integer sums. PW = 0 reads the window (pw) at run time and
// folds its conv positions one at a time into the same max; N is the
// weights' row stride.
template <int PW, bool POOL_FIRST>
__device__ __forceinline__ float sc_point_i8(
    const i8* __restrict__ in, int cols, int C, const i8* __restrict__ w,
    const float* __restrict__ bias, int N, int n, int k, int s, int cr0,
    int cc0, int act, float deq, int pw = PW) {
  if constexpr (PW == 0) {
    const float bv = __ldg(bias + n);
    float y = 0.0f;
    int m = 0;
    for (int i = 0; i < pw; ++i)
      for (int j = 0; j < pw; ++j) {
        int one[1][1];
        sc_window_i8<1>(in, cols, C, w, N, n, k, s, cr0 + i, cc0 + j, one);
        const int v = one[0][0];
        if (POOL_FIRST) {
          m = (i | j) ? max(m, v) : v;
        } else {
          const float f = sc_act(__fmul_rn(__int2float_rn(v), deq) + bv, act);
          y = (i | j) ? fmaxf(y, f) : f;
        }
      }
    return POOL_FIRST ? sc_act(__fmul_rn(__int2float_rn(m), deq) + bv, act) : y;
  }
  constexpr int P = PW > 0 ? PW : 1;
  int acc[P][P];
  sc_window_i8<P>(in, cols, C, w, N, n, k, s, cr0, cc0, acc);
  const float bv = __ldg(bias + n);
  if (POOL_FIRST) {
    int m = acc[0][0];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) m = max(m, acc[i][j]);
    return sc_act(__fmul_rn(__int2float_rn(m), deq) + bv, act);
  }
  float y = sc_act(__fmul_rn(__int2float_rn(acc[0][0]), deq) + bv, act);
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j)
      y = fmaxf(y, sc_act(__fmul_rn(__int2float_rn(acc[i][j]), deq) + bv, act));
  return y;
}

// Pooled rows [r_lo, r_hi) of one int8 pyramid layer into dst, as int8
// codes (interior layers: the next layer's slab) or fp32 grid values (the
// group's last layer).
template <int PW, bool CODES>
__device__ void sc_pyramid_layer_i8(const ScLayer& L, const i8* __restrict__ in,
                                    void* __restrict__ dst, int dst_rs,
                                    int dst_co, int r_lo, int r_hi) {
  const int cols = L.in_cols + L.pad_l + L.pad_r;
  const int N = L.n_out;
  const i8* w = reinterpret_cast<const i8*>(L.w);
  const int items = (r_hi - r_lo) * L.out_cols * N;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int n = idx % N;
    const int pos = idx / N;
    const int oc = pos % L.out_cols;
    const int r = r_lo + pos / L.out_cols;
    const float y = sc_point_i8<PW, true>(in, cols, L.in_ch, w, L.b, N, n, L.k,
                                          L.stride, r * L.ps, oc * L.ps, L.act,
                                          L.deq, L.pw);
    const float q = sc_code(y, L.qscale, L.qmin, L.qmax);
    const int o = r * dst_rs + (oc + dst_co) * N + n;
    if (CODES)
      static_cast<i8*>(dst)[o] = (i8)(int)q;
    else
      static_cast<float*>(dst)[o] = q * L.qscale;
  }
}

template <bool CODES>
__device__ __forceinline__ void sc_pyramid_layer_i8_pw(
    const ScLayer& L, const i8* in, void* dst, int dst_rs, int dst_co,
    int r_lo, int r_hi) {
  switch (L.pw) {
    case 1: sc_pyramid_layer_i8<1, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
    case 2: sc_pyramid_layer_i8<2, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
    case 3: sc_pyramid_layer_i8<3, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
    default: sc_pyramid_layer_i8<0, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
  }
}

__global__ void __launch_bounds__(SC_THREADS)
    sc_pyramid_i8_kernel(const ScPyramid P) {
  extern __shared__ __align__(16) i8 smem8[];
  i8* const buf0 = smem8;
  i8* const buf1 = smem8 + P.buf0_elems;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;

  {  // Layer 0's halo'd rows of codes, column-padded, code 0 outside the frame.
    const ScLayer& L0 = P.L[0];
    const int cols = L0.in_cols + L0.pad_l + L0.pad_r;
    const int C = L0.in_ch;
    const int start = L0.in_mult * rb + L0.in_off;
    const int total = L0.in_slab_rows * cols * C;
    const i8* xb = reinterpret_cast<const i8*>(P.x) +
                   (size_t)bi * L0.in_rows * L0.in_cols * C;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx % C;
      const int pc = (idx / C) % cols;
      const int gr = start + idx / (C * cols);
      const int gc = pc - L0.pad_l;
      i8 v = 0;
      if (gr >= 0 && gr < L0.in_rows && gc >= 0 && gc < L0.in_cols)
        v = __ldg(xb + ((size_t)gr * L0.in_cols + gc) * C + c);
      buf0[idx] = v;
    }
  }
  __syncthreads();

#pragma unroll
  for (int li = 0; li < SC_MAX_LAYERS; ++li) {
    if (li < P.n_layers) {
      const ScLayer& L = P.L[li];
      const i8* in = (li & 1) ? buf1 : buf0;
      if (li + 1 < P.n_layers) {
        const ScLayer& Nx = P.L[li + 1 < SC_MAX_LAYERS ? li + 1 : li];
        const int cols_n = Nx.in_cols + Nx.pad_l + Nx.pad_r;
        const int N = L.n_out;
        i8* dst = (li & 1) ? buf0 : buf1;
        const int start = Nx.in_mult * rb + Nx.in_off;
        const int r_lo = max(0, -start);
        const int r_hi = min(L.out_slab_rows, Nx.in_rows - start);
        // The next layer's SAME padding: rows outside its frame and its pad
        // columns hold code 0 (value 0).
        const int total = L.out_slab_rows * cols_n * N;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
          const int pc = (idx / N) % cols_n;
          const int r = idx / (N * cols_n);
          if (r < r_lo || r >= r_hi || pc < Nx.pad_l ||
              pc >= Nx.pad_l + Nx.in_cols)
            dst[idx] = 0;
        }
        if (r_hi > r_lo)
          sc_pyramid_layer_i8_pw<true>(L, in, dst, cols_n * N, Nx.pad_l, r_lo, r_hi);
      } else {
        float* dst = P.out + ((size_t)bi * P.out_rows + (size_t)rb * P.block_rows) *
                                 L.out_cols * L.n_out;
        const int r_hi = min(P.block_rows, P.out_rows - rb * P.block_rows);
        if (r_hi > 0)
          sc_pyramid_layer_i8_pw<false>(L, in, dst, L.out_cols * L.n_out, 0, 0, r_hi);
      }
      __syncthreads();
    }
  }
}

template <int PW>
__device__ void sc_fused_body_i8(const ScFused& F, const i8* __restrict__ in,
                                 int rb, int bi) {
  const int po_lo = rb * F.r_o;
  const int po_hi = min(F.h_keep, po_lo + F.r_o);
  const int items = (po_hi - po_lo) * F.w_keep * F.n;
  const i8* w = reinterpret_cast<const i8*>(F.w);
  float* out = F.out + (size_t)bi * F.out_img;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int n = idx % F.n;
    const int pos = idx / F.n;
    const int oc = pos % F.w_keep;
    const int po = po_lo + pos / F.w_keep;
    const float y = sc_point_i8<PW, false>(in, F.w_in, F.c, w, F.b, F.w_ld, n, F.k,
                                           F.stride, po * F.ps - rb * F.r,
                                           oc * F.ps, F.act, F.deq, F.pw);
    out[(size_t)po * F.out_rs + (size_t)oc * F.out_cs + n] =
        sc_code(y, F.qscale, F.qmin, F.qmax) * F.qscale;
  }
}

__global__ void __launch_bounds__(SC_THREADS) sc_fused_i8_kernel(const ScFused F) {
  extern __shared__ __align__(16) i8 slab8[];
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;
  const int row0 = rb * F.r * F.stride;
  const int strip = F.w_in * F.c;  // bytes of one slab row
  const int total = F.in_rows_blk * strip;
  const i8* xb = reinterpret_cast<const i8*>(F.x) + (size_t)bi * F.x_img +
                 (size_t)row0 * F.x_rs;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int row = idx / strip;
    // rows past the frame read 0
    slab8[idx] = row0 + row < F.h ? __ldg(xb + (size_t)row * F.x_rs + (idx - row * strip))
                                  : (i8)0;
  }
  __syncthreads();
  switch (F.pw) {
    case 1: sc_fused_body_i8<1>(F, slab8, rb, bi); break;
    case 2: sc_fused_body_i8<2>(F, slab8, rb, bi); break;
    case 3: sc_fused_body_i8<3>(F, slab8, rb, bi); break;
    default: sc_fused_body_i8<0>(F, slab8, rb, bi); break;
  }
}

static int sc_opt_in_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

extern "C" int sc_pyramid_desc_bytes() { return (int)sizeof(ScPyramid); }
extern "C" int sc_fused_desc_bytes() { return (int)sizeof(ScFused); }

// CTAs of the fp32 pyramid (which = 0) or single-layer kernel (1) that fit
// on one SM at `threads` per CTA and smem_bytes of dynamic shared memory;
// negative: a CUDA error.
extern "C" int sc_ctas_per_sm(int which, int smem_bytes, int threads) {
  const void* kernel =
      which == 0 ? (const void*)sc_pyramid_kernel : (const void*)sc_fused_kernel;
  int err = sc_opt_in_smem(kernel, smem_bytes);
  if (err) return -err;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads,
                                                           smem_bytes);
  return err ? -err : n;
}

extern "C" int sc_pyramid_launch(const ScPyramid* desc, int smem_bytes,
                                 void* stream) {
  int err = sc_opt_in_smem((const void*)sc_pyramid_kernel, smem_bytes);
  if (err) return err;
  dim3 grid(desc->n_rb, desc->batch);
  sc_pyramid_kernel<<<grid, SC_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      *desc);
  return (int)cudaGetLastError();
}

extern "C" int sc_fused_launch(const ScFused* desc, int smem_bytes,
                               void* stream) {
  int err = sc_opt_in_smem((const void*)sc_fused_kernel, smem_bytes);
  if (err) return err;
  dim3 grid(desc->n_rb, desc->batch);
  sc_fused_kernel<<<grid, desc->threads, smem_bytes, (cudaStream_t)stream>>>(
      *desc);
  return (int)cudaGetLastError();
}

extern "C" int sc_pyramid_i8_launch(const ScPyramid* desc, int smem_bytes,
                                    void* stream) {
  int err = sc_opt_in_smem((const void*)sc_pyramid_i8_kernel, smem_bytes);
  if (err) return err;
  dim3 grid(desc->n_rb, desc->batch);
  sc_pyramid_i8_kernel<<<grid, SC_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      *desc);
  return (int)cudaGetLastError();
}

extern "C" int sc_fused_i8_launch(const ScFused* desc, int smem_bytes,
                                  void* stream) {
  int err = sc_opt_in_smem((const void*)sc_fused_i8_kernel, smem_bytes);
  if (err) return err;
  dim3 grid(desc->n_rb, desc->batch);
  sc_fused_i8_kernel<<<grid, SC_THREADS, smem_bytes, (cudaStream_t)stream>>>(
      *desc);
  return (int)cudaGetLastError();
}
