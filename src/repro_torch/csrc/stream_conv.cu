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
//             weights, logits-side features: about 4.5 MB) take about
//             1.4 us at 3.35 TB/s. In practice the inner loop is bounded by
//             shared-memory load issue: one broadcast LDS per FMA.
//   Design:   one CTA per (row block, image). The CTA reads only its halo'd
//             layer-0 rows from global memory (zeros outside the frame and
//             in the SAME pad columns stand in for the host padding of the
//             reference), then keeps every inter-layer slab in shared
//             memory, ping-ponging two buffers. Each layer's epilogue writes
//             straight into the next layer's column-padded layout and zeroes
//             the rows outside the next layer's frame (SAME row padding by
//             masking, as the reference does), so rows that only feed the
//             masked padding are never computed. Weights stay in global
//             memory and L2 (cifar10 holds 316,800 B of fp32 conv weights,
//             too many to stage beside the slabs); a warp reads 32
//             consecutive output channels of one tap, so each weight load
//             is coalesced and each slab load is a broadcast. Each thread
//             computes one pooled output: the pool window's conv positions
//             share every weight load (pw*pw FMAs per load). Accumulation
//             is IEEE fp32 FMA on CUDA cores: no TF32.
//
// sc_fused_kernel
//   Replaces: src/repro/kernels/stream_conv/conv.py:stream_conv_fused_pallas
//             (body _kernel_body, _block_multiple).
//   Computes: one conv layer on a host-SAME-padded frame with the fused
//             bias -> act -> max-pool -> stream-quant epilogue (the paper's
//             conv -> act -> pool order).
//   Bound on this card: operations, as above (cifar10 layer 1 at B=256:
//             3.36 GFLOP against 67 TFLOP/s).
//   Design:   one CTA per (row block, image). The CTA stages its input rows
//             (block rows plus the halo of _block_multiple: the conv window
//             overlap and the recomputed pool-overlap rows) in shared
//             memory, then each thread computes one pooled output with the
//             same weight-sharing inner loop as the pyramid.
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
//   Design:   the fp32 kernels' structure with 1-byte slabs (a quarter of
//             the shared memory). Where the channel count is a multiple of
//             four (every layer but a 3-channel frame) the inner loop
//             reads four channels of the slab as one 32-bit word and packs
//             the four weight bytes of one output channel, then issues one
//             __dp4a per conv position of the pool window; otherwise it
//             multiplies byte by byte. Weights stay in global memory and
//             L2 (79,200 B of int8 for cifar10), read coalesced across the
//             warp's 32 output channels.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#define SC_MAX_LAYERS 4
#define SC_THREADS 256

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
};

struct ScPyramid {
  const float* x;  // (B, H, W, C0), unpadded (int8 codes in the int8 kernel)
  float* out;      // (B, out_rows, out_cols, N_last)
  int batch, n_layers, n_rb, block_rows, out_rows;
  int buf0_elems;  // elements of the first ping-pong buffer
  ScLayer L[SC_MAX_LAYERS];
};

struct ScFused {
  const float* x;  // (B, H, W, C), already SAME-padded (int8: codes)
  const float* w;  // (K, K, C, N) (int8: codes)
  const float* b;  // (N,)
  float* out;      // (B, h_keep, w_keep, N)
  int batch, h, w_in, c, n, k, stride, act, pw, ps, qbits;
  float qscale, qmin, qmax;
  int h_keep, w_keep, r, r_o, in_rows_blk, n_rb;
  float deq;  // int8 kernel: int32 accumulator -> fp32 (a power of two)
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

// The PW x PW conv outputs of one pool window, for output channel n:
// conv position (cr0 + i, cc0 + j) reads slab rows (cr0 + i) * s + ki and
// columns (cc0 + j) * s + kj of an HWC slab `cols` columns wide.
template <int PW>
__device__ __forceinline__ void sc_window(
    const float* __restrict__ in, int cols, int C,
    const float* __restrict__ w, int N, int n, int k, int s, int cr0,
    int cc0, float (&acc)[PW][PW]) {
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int j = 0; j < PW; ++j) acc[i][j] = 0.0f;
  const int rs = cols * C;
  for (int ki = 0; ki < k; ++ki) {
    for (int kj = 0; kj < k; ++kj) {
      const float* wp = w + (size_t)((ki * k + kj) * C) * N + n;
      const float* ip = in + (cr0 * s + ki) * rs + (cc0 * s + kj) * C;
      for (int c = 0; c < C; ++c) {
        const float wv = __ldg(wp + (size_t)c * N);
#pragma unroll
        for (int i = 0; i < PW; ++i)
#pragma unroll
          for (int j = 0; j < PW; ++j)
            acc[i][j] = fmaf(ip[i * s * rs + j * s * C + c], wv, acc[i][j]);
      }
    }
  }
}

// One pooled output of channel n through the fused epilogue.
// POOL_FIRST: bias -> pool -> act -> quant (pyramid); else bias -> act ->
// pool -> quant (single layer). max(a + b, c + b) == max(a, c) + b exactly,
// so the pool-first path adds the bias once after the max.
template <int PW, bool POOL_FIRST>
__device__ __forceinline__ float sc_point(
    const float* __restrict__ in, int cols, int C,
    const float* __restrict__ w, const float* __restrict__ bias, int N,
    int n, int k, int s, int cr0, int cc0, int act, int qbits, float qscale,
    float qmin, float qmax) {
  float acc[PW][PW];
  sc_window<PW>(in, cols, C, w, N, n, k, s, cr0, cc0, acc);
  const float bv = __ldg(bias + n);
  float y;
  if (POOL_FIRST) {
    float m = acc[0][0];
#pragma unroll
    for (int i = 0; i < PW; ++i)
#pragma unroll
      for (int j = 0; j < PW; ++j) m = fmaxf(m, acc[i][j]);
    y = sc_act(m + bv, act);
  } else {
    y = sc_act(acc[0][0] + bv, act);
#pragma unroll
    for (int i = 0; i < PW; ++i)
#pragma unroll
      for (int j = 0; j < PW; ++j) y = fmaxf(y, sc_act(acc[i][j] + bv, act));
  }
  return sc_quant(y, qbits, qscale, qmin, qmax);
}

// Pooled rows [r_lo, r_hi) of one pyramid layer's output slab into dst:
// element (r, c, n) lands at dst[r * dst_rs + (c + dst_co) * N + n].
template <int PW>
__device__ void sc_pyramid_layer(const ScLayer& L, const float* __restrict__ in,
                                 float* __restrict__ dst, int dst_rs,
                                 int dst_co, int r_lo, int r_hi) {
  const int cols = L.in_cols + L.pad_l + L.pad_r;
  const int N = L.n_out;
  const int items = (r_hi - r_lo) * L.out_cols * N;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int n = idx % N;
    const int pos = idx / N;
    const int oc = pos % L.out_cols;
    const int r = r_lo + pos / L.out_cols;
    dst[r * dst_rs + (oc + dst_co) * N + n] = sc_point<PW, true>(
        in, cols, L.in_ch, L.w, L.b, N, n, L.k, L.stride, r * L.ps,
        oc * L.ps, L.act, L.qbits, L.qscale, L.qmin, L.qmax);
  }
}

__global__ void __launch_bounds__(SC_THREADS)
    sc_pyramid_kernel(const ScPyramid P) {
  extern __shared__ float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + P.buf0_elems;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;

  {  // Layer 0's halo'd rows, column-padded, zero outside the frame.
    const ScLayer& L0 = P.L[0];
    const int cols = L0.in_cols + L0.pad_l + L0.pad_r;
    const int C = L0.in_ch;
    const int start = L0.in_mult * rb + L0.in_off;
    const int total = L0.in_slab_rows * cols * C;
    const float* xb = P.x + (size_t)bi * L0.in_rows * L0.in_cols * C;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int c = idx % C;
      const int pc = (idx / C) % cols;
      const int gr = start + idx / (C * cols);
      const int gc = pc - L0.pad_l;
      float v = 0.0f;
      if (gr >= 0 && gr < L0.in_rows && gc >= 0 && gc < L0.in_cols)
        v = __ldg(xb + ((size_t)gr * L0.in_cols + gc) * C + c);
      buf0[idx] = v;
    }
  }
  __syncthreads();

  // Unrolled over the layer slots so every P.L[li] is a constant offset
  // into the parameter bank.
#pragma unroll
  for (int li = 0; li < SC_MAX_LAYERS; ++li) {
    if (li < P.n_layers) {
      const ScLayer& L = P.L[li];
      const float* in = (li & 1) ? buf1 : buf0;
      float* dst;
      int dst_rs, dst_co, r_lo, r_hi;
      if (li + 1 < P.n_layers) {
        const ScLayer& Nx = P.L[li + 1 < SC_MAX_LAYERS ? li + 1 : li];
        const int cols_n = Nx.in_cols + Nx.pad_l + Nx.pad_r;
        const int N = L.n_out;
        dst = (li & 1) ? buf0 : buf1;
        dst_rs = cols_n * N;
        dst_co = Nx.pad_l;
        const int start = Nx.in_mult * rb + Nx.in_off;
        r_lo = max(0, -start);
        r_hi = min(L.out_slab_rows, Nx.in_rows - start);
        // The next layer's SAME padding: rows outside its frame and its
        // pad columns read as zero.
        const int total = L.out_slab_rows * cols_n * N;
        for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
          const int pc = (idx / N) % cols_n;
          const int r = idx / (N * cols_n);
          if (r < r_lo || r >= r_hi || pc < Nx.pad_l ||
              pc >= Nx.pad_l + Nx.in_cols)
            dst[idx] = 0.0f;
        }
      } else {
        dst = P.out + ((size_t)bi * P.out_rows + (size_t)rb * P.block_rows) *
                          L.out_cols * L.n_out;
        dst_rs = L.out_cols * L.n_out;
        dst_co = 0;
        r_lo = 0;
        r_hi = min(P.block_rows, P.out_rows - rb * P.block_rows);
      }
      if (r_hi > r_lo) {
        switch (L.pw) {
          case 2: sc_pyramid_layer<2>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
          case 3: sc_pyramid_layer<3>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
          default: sc_pyramid_layer<1>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
        }
      }
      __syncthreads();
    }
  }
}

template <int PW>
__device__ void sc_fused_body(const ScFused& F, const float* __restrict__ in,
                              int rb, int bi) {
  const int po_lo = rb * F.r_o;
  const int po_hi = min(F.h_keep, po_lo + F.r_o);
  const int items = (po_hi - po_lo) * F.w_keep * F.n;
  float* out = F.out + (size_t)bi * F.h_keep * F.w_keep * F.n;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int n = idx % F.n;
    const int pos = idx / F.n;
    const int oc = pos % F.w_keep;
    const int po = po_lo + pos / F.w_keep;
    out[((size_t)po * F.w_keep + oc) * F.n + n] = sc_point<PW, false>(
        in, F.w_in, F.c, F.w, F.b, F.n, n, F.k, F.stride,
        po * F.ps - rb * F.r, oc * F.ps, F.act, F.qbits, F.qscale, F.qmin,
        F.qmax);
  }
}

__global__ void __launch_bounds__(SC_THREADS) sc_fused_kernel(const ScFused F) {
  extern __shared__ float slab[];
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;
  const int row0 = rb * F.r * F.stride;
  const int total = F.in_rows_blk * F.w_in * F.c;
  const float* xb = F.x + ((size_t)bi * F.h + row0) * F.w_in * F.c;
  const int valid = (F.h - row0) * F.w_in * F.c;  // rows past the frame read 0
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
    slab[idx] = idx < valid ? __ldg(xb + idx) : 0.0f;
  __syncthreads();
  switch (F.pw) {
    case 2: sc_fused_body<2>(F, slab, rb, bi); break;
    case 3: sc_fused_body<3>(F, slab, rb, bi); break;
    default: sc_fused_body<1>(F, slab, rb, bi); break;
  }
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
// max of the integer sums.
template <int PW, bool POOL_FIRST>
__device__ __forceinline__ float sc_point_i8(
    const i8* __restrict__ in, int cols, int C, const i8* __restrict__ w,
    const float* __restrict__ bias, int N, int n, int k, int s, int cr0,
    int cc0, int act, float deq) {
  int acc[PW][PW];
  sc_window_i8<PW>(in, cols, C, w, N, n, k, s, cr0, cc0, acc);
  const float bv = __ldg(bias + n);
  if (POOL_FIRST) {
    int m = acc[0][0];
#pragma unroll
    for (int i = 0; i < PW; ++i)
#pragma unroll
      for (int j = 0; j < PW; ++j) m = max(m, acc[i][j]);
    return sc_act(__fmul_rn(__int2float_rn(m), deq) + bv, act);
  }
  float y = sc_act(__fmul_rn(__int2float_rn(acc[0][0]), deq) + bv, act);
#pragma unroll
  for (int i = 0; i < PW; ++i)
#pragma unroll
    for (int j = 0; j < PW; ++j)
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
                                          L.deq);
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
    case 2: sc_pyramid_layer_i8<2, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
    case 3: sc_pyramid_layer_i8<3, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
    default: sc_pyramid_layer_i8<1, CODES>(L, in, dst, dst_rs, dst_co, r_lo, r_hi); break;
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
  float* out = F.out + (size_t)bi * F.h_keep * F.w_keep * F.n;
  for (int idx = threadIdx.x; idx < items; idx += blockDim.x) {
    const int n = idx % F.n;
    const int pos = idx / F.n;
    const int oc = pos % F.w_keep;
    const int po = po_lo + pos / F.w_keep;
    const float y = sc_point_i8<PW, false>(in, F.w_in, F.c, w, F.b, F.n, n, F.k,
                                           F.stride, po * F.ps - rb * F.r,
                                           oc * F.ps, F.act, F.deq);
    out[((size_t)po * F.w_keep + oc) * F.n + n] =
        sc_code(y, F.qscale, F.qmin, F.qmax) * F.qscale;
  }
}

__global__ void __launch_bounds__(SC_THREADS) sc_fused_i8_kernel(const ScFused F) {
  extern __shared__ __align__(16) i8 slab8[];
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;
  const int row0 = rb * F.r * F.stride;
  const int total = F.in_rows_blk * F.w_in * F.c;
  const i8* xb = reinterpret_cast<const i8*>(F.x) +
                 ((size_t)bi * F.h + row0) * F.w_in * F.c;
  const int valid = (F.h - row0) * F.w_in * F.c;  // rows past the frame read 0
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x)
    slab8[idx] = idx < valid ? __ldg(xb + idx) : (i8)0;
  __syncthreads();
  switch (F.pw) {
    case 2: sc_fused_body_i8<2>(F, slab8, rb, bi); break;
    case 3: sc_fused_body_i8<3>(F, slab8, rb, bi); break;
    default: sc_fused_body_i8<1>(F, slab8, rb, bi); break;
  }
}

static int sc_opt_in_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

extern "C" int sc_pyramid_desc_bytes() { return (int)sizeof(ScPyramid); }
extern "C" int sc_fused_desc_bytes() { return (int)sizeof(ScFused); }

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
  sc_fused_kernel<<<grid, SC_THREADS, smem_bytes, (cudaStream_t)stream>>>(
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
