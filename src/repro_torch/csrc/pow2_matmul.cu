// Hand-written Hopper (sm_90a) kernel for the packed pow2 matmul.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/pow2_matmul/pow2.py). The entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// p2_matmul_kernel<INT>
//   Replaces: src/repro/kernels/pow2_matmul/pow2.py:pow2_matmul_pallas
//             (body _pow2_matmul_kernel, _unpack_u4, _decode_codes_f32);
//             INT=true is the integer rendering that the reference computes
//             only on its CPU path (ref.py:pow2_matmul_int_ref).
//   Computes: out[m, n] = sum_k x[m, k] * decode(code[k, n]) * scale[n],
//             4-bit codes packed two per byte along N (even n in the low
//             nibble); bit 3 is the sign, bits 0-2 the magnitude m, and the
//             value is +-2^(m-1) (m = 0 is +0.0).
//             INT=false: x float32, each code decoded by exponent
//             construction ((126 + m) << 23 | s << 28, bitcast), fp32 FMA,
//             one multiply by scale[n] after the K reduction.
//             INT=true: x int8 activation codes, each code decoded to the
//             integer shift weight +-(1 << (m - 1)), int32 accumulation,
//             then float(acc) * (x_scale * scale[n]), as the reference's
//             integer rendering orders it.
//   Bound on this card: at the heads' shapes (cifar10: 256x1024 by 1024x64,
//             then 256x64 by 64x10) neither operations nor bytes: 33.6 MFLOP
//             is 0.5 us at 67 TFLOP/s and about 1.1 MB of x, codes and out
//             is 0.33 us at 3.35 TB/s. What bounds it is latency and the few
//             blocks the small N allows.
//   Design:   one 256-thread CTA per 16 x 64 output tile, looping over K in
//             slices of 32: the CTA stages its x slice (zero outside the
//             matrix) and decodes its 32 x 32 bytes of codes into a 32 x 64
//             weight tile in shared memory, then each thread accumulates
//             one row by four columns (16 apart, so a warp reads 16
//             consecutive weights). Weights are read from device memory at
//             half a byte each; the decode is integer arithmetic only.
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>

#define P2_BM 16
#define P2_BN 64
#define P2_BK 32
#define P2_THREADS 256

struct P2Matmul {
  const void* x;                 // (M, K) float32, or int8 codes when int_mode
  const unsigned char* packed;   // (K, NB) two codes per byte, NB = ceil(N/2)
  const float* scale;            // (N,)
  float* out;                    // (M, N)
  int m, k, n, nb;
  int int_mode;
  float x_scale;                 // the activation grid's scale (int_mode)
};

template <bool INT>
struct P2Acc;
template <>
struct P2Acc<false> {
  typedef float T;
  // +-2^(m-1) by exponent construction; m == 0 is +0.0.
  static __device__ __forceinline__ float decode(unsigned c) {
    const unsigned m = c & 7u;
    const unsigned s = c & 8u;
    return m ? __uint_as_float(((126u + m) << 23) | (s << 28)) : 0.0f;
  }
  static __device__ __forceinline__ float load_x(const void* x, size_t i) {
    return __ldg(static_cast<const float*>(x) + i);
  }
  static __device__ __forceinline__ float mad(float a, float b, float c) {
    return fmaf(a, b, c);
  }
};
template <>
struct P2Acc<true> {
  typedef int T;
  // The integer shift weight +-(1 << (m-1)); m == 0 is 0.
  static __device__ __forceinline__ int decode(unsigned c) {
    const unsigned m = c & 7u;
    const int v = m ? (1 << (m - 1)) : 0;
    return (c & 8u) ? -v : v;
  }
  static __device__ __forceinline__ int load_x(const void* x, size_t i) {
    return (int)__ldg(static_cast<const signed char*>(x) + i);
  }
  static __device__ __forceinline__ int mad(int a, int b, int c) {
    return a * b + c;
  }
};

template <bool INT>
__global__ void __launch_bounds__(P2_THREADS) p2_matmul_kernel(const P2Matmul P) {
  typedef P2Acc<INT> A;
  typedef typename A::T T;
  __shared__ T xs[P2_BM][P2_BK + 1];
  __shared__ T ws[P2_BK][P2_BN];
  const int m0 = blockIdx.y * P2_BM;
  const int n0 = blockIdx.x * P2_BN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  T acc[4] = {0, 0, 0, 0};
  for (int k0 = 0; k0 < P.k; k0 += P2_BK) {
    for (int i = threadIdx.x; i < P2_BM * P2_BK; i += P2_THREADS) {
      const int r = i / P2_BK, c = i % P2_BK;
      const int gm = m0 + r, gk = k0 + c;
      xs[r][c] = (gm < P.m && gk < P.k) ? A::load_x(P.x, (size_t)gm * P.k + gk) : (T)0;
    }
    for (int i = threadIdx.x; i < P2_BK * (P2_BN / 2); i += P2_THREADS) {
      const int r = i / (P2_BN / 2), bc = i % (P2_BN / 2);
      const int gk = k0 + r, gb = n0 / 2 + bc;
      const unsigned v =
          (gk < P.k && gb < P.nb) ? (unsigned)__ldg(P.packed + (size_t)gk * P.nb + gb) : 0u;
      ws[r][2 * bc] = A::decode(v & 15u);
      ws[r][2 * bc + 1] = A::decode(v >> 4);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < P2_BK; ++kk) {
      const T a = xs[ty][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = A::mad(a, ws[kk][tx + 16 * j], acc[j]);
    }
    __syncthreads();
  }
  const int gm = m0 + ty;
  if (gm >= P.m) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int gn = n0 + tx + 16 * j;
    if (gn >= P.n) continue;
    const float sc = __ldg(P.scale + gn);
    float y;
    if (INT)
      y = __fmul_rn(__int2float_rn((int)acc[j]), __fmul_rn(P.x_scale, sc));
    else
      y = __fmul_rn((float)acc[j], sc);
    P.out[(size_t)gm * P.n + gn] = y;
  }
}

extern "C" int p2_desc_bytes() { return (int)sizeof(P2Matmul); }

extern "C" int p2_matmul_launch(const P2Matmul* desc, void* stream) {
  dim3 grid((desc->n + P2_BN - 1) / P2_BN, (desc->m + P2_BM - 1) / P2_BM);
  if (desc->int_mode)
    p2_matmul_kernel<true><<<grid, P2_THREADS, 0, (cudaStream_t)stream>>>(*desc);
  else
    p2_matmul_kernel<false><<<grid, P2_THREADS, 0, (cudaStream_t)stream>>>(*desc);
  return (int)cudaGetLastError();
}
