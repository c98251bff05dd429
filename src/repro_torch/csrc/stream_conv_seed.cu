// Hand-written Hopper (sm_90a) kernel for the seed streaming conv.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/stream_conv/legacy.py). The entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// sc_seed_kernel
//   Replaces: src/repro/kernels/stream_conv/legacy.py:stream_conv2d_pallas_seed
//             (body _stream_conv_kernel_seed).
//   Computes: a VALID stride-1 conv, out[b, r, c, n] =
//             sum_{ki, kj} sum_ch x[b, r + ki, c + kj, ch] * w[ki*K + kj, ch, n]
//             with weights as K*K per-tap (C, N) matrices, summed tap by
//             tap in the reference's order, in IEEE fp32 on CUDA cores.
//   Bound on this card: at the kernel bench's cifar10-conv1 shape (8 x 36
//             x 36 x 3, K 5, N 32) 39.3 MFLOP is 0.59 us at 67 TFLOP/s and
//             the 1.2 MB of input, weights and output 0.35 us at
//             3.35 TB/s; at B = 256 about 19 us, bound by the operations.
//             Latency and one output row per CTA bound it in practice, as
//             on the TPU, where this design was superseded by the
//             row-blocked kernel (conv.py).
//   Design:   one CTA per (output row, image). The TPU kernel walks the
//             rows in order and rotates a (K-1)-row line buffer by hand;
//             on Hopper the CTAs run in parallel and in no order, so each
//             one stages its own K-row window (the K-1 rows of that line
//             buffer plus the new row) in shared memory. Each thread
//             computes output (c, n) pairs, n fastest: the window is read
//             as a broadcast and the weights and the output row coalesced
//             over n. The input is read K times over, from L2.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#define SEED_THREADS 256

struct ScSeed {
  const float* x;  // (B, H, W, C) contiguous
  const float* w;  // (K*K, C, N) contiguous
  float* out;      // (B, H-K+1, W-K+1, N) contiguous
  int batch, h, w_in, c, n, k;
  int h_out, w_out;
};

__global__ void sc_seed_kernel(const ScSeed p) {
  extern __shared__ float win[];  // (K, W, C)
  const int r = blockIdx.x;
  const int bi = blockIdx.y;
  const int row_elems = p.w_in * p.c;
  const float* __restrict__ src = p.x + ((long long)bi * p.h + r) * row_elems;
  for (int i = threadIdx.x; i < p.k * row_elems; i += blockDim.x) win[i] = __ldg(src + i);
  __syncthreads();

  const float* __restrict__ w = p.w;
  float* __restrict__ dst = p.out + ((long long)bi * p.h_out + r) * p.w_out * p.n;
  for (int o = threadIdx.x; o < p.w_out * p.n; o += blockDim.x) {
    const int col = o / p.n, n = o - col * p.n;
    float acc = 0.0f;
    for (int ki = 0; ki < p.k; ++ki) {
      for (int kj = 0; kj < p.k; ++kj) {
        const float* seg = win + (ki * p.w_in + col + kj) * p.c;
        const float* tap = w + (long long)(ki * p.k + kj) * p.c * p.n + n;
        float dot = 0.0f;
        for (int ch = 0; ch < p.c; ++ch) dot = fmaf(seg[ch], __ldg(tap + ch * p.n), dot);
        acc += dot;
      }
    }
    dst[o] = acc;
  }
}

extern "C" int sc_seed_desc_bytes() { return (int)sizeof(ScSeed); }

extern "C" int sc_seed_launch(const ScSeed* desc, int smem, void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        sc_seed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(desc->h_out, desc->batch);
  sc_seed_kernel<<<grid, SEED_THREADS, smem, (cudaStream_t)stream>>>(*desc);
  return (int)cudaGetLastError();
}
