// Hand-written Hopper (sm_90a) kernel for the seed streaming conv.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/stream_conv/legacy.py). The entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// sc_seed_kernel<TW, TN, CC>
//   Replaces: src/repro/kernels/stream_conv/legacy.py:stream_conv2d_pallas_seed
//             (body _stream_conv_kernel_seed).
//   Computes: a VALID stride-1 conv, out[b, r, c, n] =
//             sum_{ki, kj} sum_ch x[b, r + ki, c + kj, ch] * w[ki*K + kj, ch, n]
//             with weights as K*K per-tap (C, N) matrices, in IEEE fp32 on
//             CUDA cores in the reference's order: per tap a dot over ch
//             (one fmaf chain from 0), then acc += dot, tap by tap.
//   Bound on this card: at the kernel bench's cifar10-conv1 shape (8 x 36
//             x 36 x 3, K 5, N 32) 39.3 MFLOP is 0.59 us at 67 TFLOP/s and
//             the 1.2 MB of input, weights and output 0.35 us at 3.35 TB/s;
//             at B = 256 1.26 GFLOP is 18.8 us, bound by the operations.
//   Design:   the TPU kernel's idea, a row stream through a line buffer, on
//             Hopper's blocks. A CTA walks a strip of output rows of one
//             image in order (the TPU grid's sequential row axis) and keeps
//             a ring of K + 1 input rows in shared memory, rotated by index:
//             K rows are the line buffer, the spare slot is being filled.
//             While it computes output row r from input rows r .. r+K-1, it
//             prefetches input row r + K into the spare slot with cp.async
//             (16-byte copies where the row is contiguous in both places),
//             so each input row is read once per strip, not K times. One
//             barrier per row: after it every thread is done with row r-1,
//             whose slot the next prefetch takes.
//             The CTA's weights (K*K*C rows of its channels, zero-padded to
//             whole groups of TN) are staged once, by cp.async, with rows of
//             `np` floats so a thread reads its TN channels as float4s. Where
//             all N channels do not fit, the host splits N across CTAs
//             (grid.y): each CTA still stages its slice once, where slices
//             of K would be staged again for every output row.
//             Register tile: each thread holds TW output columns x TN
//             channels. Its columns are g, g + CG, g + 2 CG, ... (CG column
//             groups), so the lanes of a warp read neighbouring columns of
//             the ring: per (tap, ch) TW ring words and TN/4 float4 weights
//             feed TW*TN FMAs. The host picks the tile (4 x 8, or 2 x 4
//             where 4 x 8 leaves the SMs short of warps), the threads, the
//             ring's column stride (C or a padded C that puts a warp's
//             columns on distinct banks) and the strip length (one wave of
//             the CTAs an SM holds, sc_seed_resident) from the work
//             (legacy.py seed_tile), so that the CTAs fill the card at
//             B = 8 and at B = 256 alike. C = 3, a first layer's RGB and
//             the seed's own shape, is also compiled as a constant (CC):
//             the channel loop unrolls and the offsets fold, which an H100
//             ran 1.3-1.5x faster than the runtime loop (PERF.md).
//             A frame whose ring does not fit beside one channel group of
//             weights runs as column strips, one launch each (legacy.py
//             seed_tile): a strip's ring holds its columns and the K - 1 of
//             halo to their right, and it writes its columns of the one
//             output tensor.
//             Ragged edges are masked: columns
//             past w_out read zeroed pad columns of the ring and are not
//             stored, channels past N multiply zeroed weights.
//             The seed is deliberately NOT routed through the row-blocked
//             implicit GEMM of the single-layer kernel (stream_conv.cu
//             sc_gemm): it is the streaming baseline that kernel is measured
//             against (speedup_vs_seed), and one kernel for both would make
//             that ratio 1 by construction.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#define SEED_MAX_THREADS 256

struct ScSeed {
  // One column strip of the frame (the host offsets x and out to the
  // strip's first input and output column): w_in input columns of rows
  // x_rs floats apart, w_out output columns of rows out_rs floats apart.
  const float* x;  // (B, H, W, C) contiguous
  const float* w;  // (K*K, C, N) contiguous
  float* out;      // (B, H-K+1, W-K+1, N) contiguous
  long long x_img, out_img;  // floats per image of x and out
  int x_rs, out_rs;
  int batch, h, w_in, c, n, k;
  int h_out, w_out;
  int rows;        // output rows per strip (grid.x strips)
  int n_split;     // CTAs across N (grid.y)
  int cg;          // column groups: thread column t of group g is g + t*cg
  int ngc;         // channel groups of TN per CTA
  int np;          // staged weight row stride: ngc * TN floats
  int cs, rs;      // ring column and row strides (floats)
  int xvec, wvec;  // 16-byte copies of input rows / weight rows
  int tw, tn;      // the register tile the host chose
};

// Through L1 (.ca): the CTAs on one SM stage the same weights.
__device__ __forceinline__ void seed_cp16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void seed_cp4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

// Input row `row` of this image into ring slot `slot` (no commit).
__device__ __forceinline__ void seed_stage_row(const ScSeed& p, const float* xb, float* ring,
                                               int row, int slot) {
  const int words = p.w_in * p.c;
  const float* src = xb + (size_t)row * p.x_rs;
  float* dst = ring + slot * p.rs;
  if (p.xvec) {
    for (int i = threadIdx.x; i < (words >> 2); i += blockDim.x)
      seed_cp16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const int col = i / p.c;
      seed_cp4(dst + col * p.cs + (i - col * p.c), src + i);
    }
  }
}

// CC: C fixed at compile time (3, a first conv layer's RGB, the seed's
// own shape), so the channel loop unrolls and a tap's loads issue
// together; 0 reads C from the descriptor.
template <int TW, int TN, int CC>
__global__ void __launch_bounds__(SEED_MAX_THREADS) sc_seed_kernel(const ScSeed p) {
  extern __shared__ __align__(16) float sm[];
  const int K = p.k, C = CC ? CC : p.c;
  const int kkc = K * K * C;
  float* wsm = sm;               // (K*K*C, np) weights of this CTA's channels
  float* ring = sm + kkc * p.np;  // (K + 1, rs) the line buffer and its spare slot
  const int r0 = blockIdx.x * p.rows;
  const int r1 = min(r0 + p.rows, p.h_out);
  const int n0 = blockIdx.y * p.np;
  const int bi = blockIdx.z;
  const float* xb = p.x + (size_t)bi * p.x_img;

  // Prologue: this CTA's weights, the ring's pad columns, input rows r0 ..
  // r0 + K - 1 into slots 0 .. K - 1; one cp.async group.
  const int nw = min(p.np, p.n - n0);  // real channels (a multiple of 4 with wvec)
  if (p.wvec) {
    const int q4 = nw >> 2;
    for (int i = threadIdx.x; i < kkc * q4; i += blockDim.x) {
      const int r = i / q4, q = i - r * q4;
      seed_cp16(wsm + r * p.np + 4 * q, p.w + (size_t)r * p.n + n0 + 4 * q);
    }
  } else {
    for (int i = threadIdx.x; i < kkc * nw; i += blockDim.x) {
      const int r = i / nw, j = i - r * nw;
      seed_cp4(wsm + r * p.np + j, p.w + (size_t)r * p.n + n0 + j);
    }
  }
  const int wpad = p.np - nw;
  for (int i = threadIdx.x; i < kkc * wpad; i += blockDim.x) {
    const int r = i / wpad;
    wsm[r * p.np + nw + (i - r * wpad)] = 0.0f;
  }
  const int row_end = p.w_in * p.cs;  // ring words past the last input column
  for (int i = threadIdx.x; i < (K + 1) * (p.rs - row_end); i += blockDim.x) {
    const int slot = i / (p.rs - row_end);
    ring[slot * p.rs + row_end + (i - slot * (p.rs - row_end))] = 0.0f;
  }
  for (int ki = 0; ki < K; ++ki) seed_stage_row(p, xb, ring, r0 + ki, ki);
  asm volatile("cp.async.commit_group;\n" ::);

  const int tasks = p.cg * p.ngc;
  const int colstep = p.cg * p.cs;
  for (int r = r0; r < r1; ++r) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // input row r + K - 1 landed; row r - 1 is done with
    const int s0 = (r - r0) % (K + 1);  // slot of input row r
    if (r + 1 < r1) {
      const int spare = s0 == 0 ? K : s0 - 1;  // held input row r - 1
      seed_stage_row(p, xb, ring, r + K, spare);
    }
    asm volatile("cp.async.commit_group;\n" ::);

    float* const orow = p.out + (size_t)bi * p.out_img + (size_t)r * p.out_rs;
    for (int task = threadIdx.x; task < tasks; task += blockDim.x) {
      const int g = task % p.cg, ng = task / p.cg;
      float acc[TW][TN];
#pragma unroll
      for (int t = 0; t < TW; ++t)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[t][j] = 0.0f;
      for (int ki = 0; ki < K; ++ki) {
        const int slot = s0 + ki <= K ? s0 + ki : s0 + ki - (K + 1);
        const float* xr = ring + slot * p.rs + g * p.cs;
        for (int kj = 0; kj < K; ++kj) {
          const float* xp = xr + kj * p.cs;
          const float* wp = wsm + (size_t)((ki * K + kj) * C) * p.np + ng * TN;
          float dot[TW][TN];
#pragma unroll
          for (int t = 0; t < TW; ++t)
#pragma unroll
            for (int j = 0; j < TN; ++j) dot[t][j] = 0.0f;
#pragma unroll  // whole where C is a compile-time constant, else not at all
          for (int ch = 0; ch < C; ++ch) {
            float xv[TW];
#pragma unroll
            for (int t = 0; t < TW; ++t) xv[t] = xp[t * colstep + ch];
            float wv[TN];
#pragma unroll
            for (int q = 0; q < TN / 4; ++q) {
              const float4 v = *reinterpret_cast<const float4*>(wp + ch * p.np + 4 * q);
              wv[4 * q] = v.x;
              wv[4 * q + 1] = v.y;
              wv[4 * q + 2] = v.z;
              wv[4 * q + 3] = v.w;
            }
#pragma unroll
            for (int t = 0; t < TW; ++t)
#pragma unroll
              for (int j = 0; j < TN; ++j) dot[t][j] = fmaf(xv[t], wv[j], dot[t][j]);
          }
#pragma unroll
          for (int t = 0; t < TW; ++t)
#pragma unroll
            for (int j = 0; j < TN; ++j) acc[t][j] += dot[t][j];
        }
      }
      const int nc = n0 + ng * TN;  // first channel of this thread
      const int nv = p.n - nc;      // channels of it inside N
#pragma unroll
      for (int t = 0; t < TW; ++t) {
        const int c = g + t * p.cg;
        if (c >= p.w_out || nv <= 0) continue;
        float* o = orow + (size_t)c * p.n + nc;
        if (nv >= TN && (p.n & 3) == 0) {
#pragma unroll
          for (int q = 0; q < TN / 4; ++q)
            *reinterpret_cast<float4*>(o + 4 * q) =
                make_float4(acc[t][4 * q], acc[t][4 * q + 1], acc[t][4 * q + 2], acc[t][4 * q + 3]);
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j)
            if (j < nv) o[j] = acc[t][j];
        }
      }
    }
  }
}

typedef void (*SeedKernel)(const ScSeed);

static SeedKernel seed_kernel_for(int tw, int tn, int c) {
  if (tw == 4 && tn == 8) return c == 3 ? sc_seed_kernel<4, 8, 3> : sc_seed_kernel<4, 8, 0>;
  if (tw == 2 && tn == 4) return c == 3 ? sc_seed_kernel<2, 4, 3> : sc_seed_kernel<2, 4, 0>;
  return nullptr;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory.
static int seed_opt_in_smem(SeedKernel kernel, int smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

extern "C" int sc_seed_desc_bytes() { return (int)sizeof(ScSeed); }

// CTAs of the (tw, tn) kernel for C channels that one SM of the current
// card holds at `threads` per CTA and `smem` bytes of dynamic shared
// memory; negative: a CUDA error.
extern "C" int sc_seed_resident(int tw, int tn, int c, int threads, int smem) {
  SeedKernel kernel = seed_kernel_for(tw, tn, c);
  if (kernel == nullptr) return -(int)cudaErrorInvalidValue;
  int err = seed_opt_in_smem(kernel, smem);
  if (err) return -err;
  int n = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err ? -err : n;
}

extern "C" int sc_seed_launch(const ScSeed* desc, int smem, int threads, void* stream) {
  SeedKernel kernel = seed_kernel_for(desc->tw, desc->tn, desc->c);
  if (kernel == nullptr || threads <= 0 || threads > SEED_MAX_THREADS || threads % 32)
    return (int)cudaErrorInvalidValue;
  int err = seed_opt_in_smem(kernel, smem);
  if (err) return err;
  dim3 grid((desc->h_out + desc->rows - 1) / desc->rows, desc->n_split, desc->batch);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(*desc);
  return (int)cudaGetLastError();
}
