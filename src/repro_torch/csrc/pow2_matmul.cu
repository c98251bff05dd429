// Hand-written Hopper (sm_90a) kernel for the packed pow2 matmul.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/pow2_matmul/pow2.py). The entry point
// launches on the caller's stream, allocates nothing, and returns the
// launch's error code so the wrapper can raise on a refused launch.
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
//             is 0.33 us at 3.35 TB/s, below what one launch costs. What
//             bounds it is latency: the few output tiles a small N allows
//             (16 at the cifar10 head's first shape) and the round trips to
//             memory of a long K walk.
//   Design:   one 16 x 64 output tile per cluster of S CTAs (S in {1, 2, 4,
//             8}, the portable cluster sizes), K split across the cluster:
//             the host (pow2.py p2_plan) picks S so the tiles times S make
//             one wave (two CTAs an SM) while each CTA keeps at least two
//             K-slices of 32. A CTA walks its K range in slices, four in
//             flight: the copies (cp.async; fp32 x 16 bytes at a time
//             where K % 4 == 0; the packed code bytes and int8 x, at any
//             byte offset, as the aligned words around them, zero-filled
//             past the matrix by cp.async's src-size) of the next three
//             slices run while a slice is decoded into a weight tile in
//             shared memory and multiplied. Each thread holds one
//             row by four neighbouring columns and reads its weights as one
//             float4 (int4) a k. The integer mode stages its weights K-major
//             in groups of four int8 and multiplies four K steps at once
//             with __dp4a. Then the cluster reduces, pushing to rank 0:
//               1. every CTA arrives on the cluster barrier as it starts and
//                  waits on it after its K range: by then every CTA of the
//                  cluster has started, so its shared memory may be written;
//               2. each peer stores its register tile into its own slot of
//                  rank 0's shared memory (map_shared_rank), arrives again
//                  (release) and leaves: no CTA ever reads a peer's memory,
//                  so no peer has to stay alive for another;
//               3. rank 0 waits (acquire) for every peer's arrival, adds the
//                  slots to its own tile in rank order, applies the scale
//                  and stores.
//             One launch, no atomics, no second pass: two calls give the
//             same bits. (Rank 0 pulling the peers' tiles instead needs a
//             second barrier to keep every peer alive until it has read
//             them, and ran slower on an H100.)
//   Parity:   the integer sums are exact, so any split equals
//             pow2_matmul_int_ref bit for bit. In fp32 the split changes the
//             order of the sum (rank by rank, each rank in K order). Where x
//             lies on a pow2 grid (the card tests' 2^-4 grid, and the 8-bit
//             grid of plan (b)'s fake-quant twin) every product x * 2^e is
//             exact and every partial sum is an integer count of grid units
//             below 2^24, so the sum is exact in any order; this is also why
//             plan (b) equals its twin bit for bit. Off the grid it is an
//             ordinary fp32 sum in a fixed order: deterministic, and within
//             the fp32 tolerance of sums in another order (rtol 1e-4, atol
//             1e-5) of the plain version; an element that nearly cancels
//             may sit outside the grid's rtol 1e-5, atol 1e-6, as cuBLAS's
//             own order does.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

#define P2_BM 16
#define P2_BN 64
#define P2_BK 32
#define P2_THREADS 256
#define P2_STAGES 4  // K-slices in flight: the copies of three run ahead
// Words of one staged byte row: 32 bytes from any byte offset span 9.
#define P2_ROW_WORDS 9
// fp32 x row stride: whole 16-byte words, and the two rows a warp reads
// four banks apart.
#define P2_XS (P2_BK + 4)

struct P2Matmul {
  const void* x;                 // (M, K) float32, or int8 codes when int_mode
  const unsigned char* packed;   // (K, NB) two codes per byte, NB = ceil(N/2)
  const float* scale;            // (N,)
  float* out;                    // (M, N)
  int m, k, n, nb;
  int int_mode;
  float x_scale;                 // the activation grid's scale (int_mode)
  int split;                     // S: CTAs of a cluster, K split across them
  int slices;                    // ceil(K / P2_BK)
  int xvec;                      // 16-byte copies of fp32 x (K % 4 == 0, aligned)
};

__device__ __forceinline__ void p2_cp4(void* dst, const void* src, unsigned src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void p2_cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void p2_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void p2_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes a byte matrix's first byte lies past the 4-byte word that holds it.
__device__ __forceinline__ unsigned p2_lead(const void* base) {
  return (unsigned)((size_t)base & 3u);
}

// Stage bytes [start, start + 32) of a byte matrix of `total` bytes (0: a
// row past the matrix, staged as zeros) as the aligned words that cover
// them; bytes past the end are zero-filled. The words are aligned in
// memory, so the first may begin up to three bytes before the matrix:
// those bytes lie in the same allocation (CUDA allocations start on 256
// bytes) and are never used. The staged row begins at byte
// (p2_lead(base) + start) & 3 of `dst`.
__device__ __forceinline__ void p2_stage_bytes(unsigned* dst, const unsigned char* base,
                                               long long start, long long total, int w) {
  const long long lead = p2_lead(base);
  const unsigned char* aligned = base - lead;
  const long long a = ((lead + start) & ~3LL) + 4LL * w;
  const long long left = total ? lead + total - a : 0;
  const unsigned nbytes = left <= 0 ? 0u : (left >= 4 ? 4u : (unsigned)left);
  p2_cp4(dst + w, aligned + (nbytes ? a : 0), nbytes);
}

// +-2^(m-1) by exponent construction; m == 0 is +0.0.
__device__ __forceinline__ float p2_decode_f32(unsigned c) {
  const unsigned m = c & 7u;
  const unsigned s = c & 8u;
  return m ? __uint_as_float(((126u + m) << 23) | (s << 28)) : 0.0f;
}

// The integer shift weight +-(1 << (m-1)); m == 0 is 0.
__device__ __forceinline__ int p2_decode_int(unsigned c) {
  const unsigned m = c & 7u;
  const int v = m ? (1 << (m - 1)) : 0;
  return (c & 8u) ? -v : v;
}

template <bool INT>
struct P2Smem;
template <>
struct P2Smem<false> {
  float xs[P2_STAGES][P2_BM][P2_XS];           // x slices
  unsigned cst[P2_STAGES][P2_BK][P2_ROW_WORDS];  // code bytes, as staged
  float ws[P2_BK][P2_BN];                      // decoded weights of one slice
};
template <>
struct P2Smem<true> {
  unsigned xraw[P2_STAGES][P2_BM][P2_ROW_WORDS];  // x code bytes, as staged
  unsigned cst[P2_STAGES][P2_BK][P2_ROW_WORDS];
  int xs4[P2_BM][P2_BK / 4];                   // x codes, four k per word
  int ws4[P2_BK / 4][P2_BN];                   // weights, four k per word
};

// Issue the copies of K-slice `kb` into stage `buf` (no commit).
template <bool INT>
__device__ __forceinline__ void p2_stage(P2Smem<INT>& S, const P2Matmul& P, int buf, int kb,
                                         int m0, int n0) {
  const int k0 = kb * P2_BK;
  const long long code_total = (long long)P.k * P.nb;
  for (int i = threadIdx.x; i < P2_BK * P2_ROW_WORDS; i += P2_THREADS) {
    const int r = i / P2_ROW_WORDS, w = i - r * P2_ROW_WORDS;
    const int gk = k0 + r;
    // Rows past K stage nothing (zero-filled); decode masks them anyway.
    const long long start = (long long)gk * P.nb + n0 / 2;
    p2_stage_bytes(S.cst[buf][r], P.packed, start, gk < P.k ? code_total : 0, w);
  }
  if constexpr (INT) {
    const unsigned char* x = static_cast<const unsigned char*>(P.x);
    const long long x_total = (long long)P.m * P.k;
    for (int i = threadIdx.x; i < P2_BM * P2_ROW_WORDS; i += P2_THREADS) {
      const int r = i / P2_ROW_WORDS, w = i - r * P2_ROW_WORDS;
      const int gm = m0 + r;
      const long long start = (long long)gm * P.k + k0;
      p2_stage_bytes(S.xraw[buf][r], x, start, gm < P.m ? x_total : 0, w);
    }
  } else {
    const float* x = static_cast<const float*>(P.x);
    if (P.xvec) {
      for (int i = threadIdx.x; i < P2_BM * (P2_BK / 4); i += P2_THREADS) {
        const int r = i / (P2_BK / 4), q = i - r * (P2_BK / 4);
        const int gm = m0 + r, gk = k0 + 4 * q;
        float* dst = &S.xs[buf][r][4 * q];
        if (gm < P.m && gk < P.k)  // K % 4 == 0: all four inside
          p2_cp16(dst, x + (size_t)gm * P.k + gk);
        else
          *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    } else {
      for (int i = threadIdx.x; i < P2_BM * P2_BK; i += P2_THREADS) {
        const int r = i / P2_BK, c = i - r * P2_BK;
        const int gm = m0 + r, gk = k0 + c;
        float* dst = &S.xs[buf][r][c];
        if (gm < P.m && gk < P.k)
          p2_cp4(dst, x + (size_t)gm * P.k + gk, 4u);
        else
          *dst = 0.0f;
      }
    }
  }
}

// The staged code row of K row gk: its first byte, and how many of its
// bytes (from the tile's first column pair) lie inside the matrix.
__device__ __forceinline__ const unsigned char* p2_code_row(const unsigned* row,
                                                            const P2Matmul& P, int gk, int n0,
                                                            int* valid) {
  // The row starts (gk * NB + n0 / 2) bytes in: only the low two bits of
  // its address matter.
  const unsigned shift =
      (p2_lead(P.packed) + (unsigned)gk * (unsigned)P.nb + (unsigned)(n0 / 2)) & 3u;
  *valid = gk < P.k ? P.nb - n0 / 2 : 0;
  return reinterpret_cast<const unsigned char*>(row) + shift;
}

// Decode K-slice kb (staged in stage buf) into the weight tile; in integer
// mode also realign the x codes into whole words of four k.
template <bool INT>
__device__ __forceinline__ void p2_decode(P2Smem<INT>& S, const P2Matmul& P, int buf, int kb,
                                          int m0, int n0) {
  const int k0 = kb * P2_BK;
  if constexpr (INT) {
    // (group of four k, pair of bytes = four columns): 128 tasks.
    for (int i = threadIdx.x; i < (P2_BK / 4) * (P2_BN / 4); i += P2_THREADS) {
      const int g = i / (P2_BN / 4), p = i - g * (P2_BN / 4);
      unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 4 * g + q;
        int valid;
        const unsigned char* row = p2_code_row(S.cst[buf][r], P, k0 + r, n0, &valid);
        const unsigned b0 = 2 * p < valid ? row[2 * p] : 0u;
        const unsigned b1 = 2 * p + 1 < valid ? row[2 * p + 1] : 0u;
        w[0] |= ((unsigned)p2_decode_int(b0 & 15u) & 0xffu) << (8 * q);
        w[1] |= ((unsigned)p2_decode_int(b0 >> 4) & 0xffu) << (8 * q);
        w[2] |= ((unsigned)p2_decode_int(b1 & 15u) & 0xffu) << (8 * q);
        w[3] |= ((unsigned)p2_decode_int(b1 >> 4) & 0xffu) << (8 * q);
      }
      *reinterpret_cast<int4*>(&S.ws4[g][4 * p]) =
          make_int4((int)w[0], (int)w[1], (int)w[2], (int)w[3]);
    }
    for (int i = threadIdx.x; i < P2_BM * (P2_BK / 4); i += P2_THREADS) {
      const int r = i / (P2_BK / 4), g = i - r * (P2_BK / 4);
      const int gm = m0 + r;
      const unsigned shift =
          8u * ((p2_lead(P.x) + (unsigned)gm * (unsigned)P.k + (unsigned)k0) & 3u);
      unsigned v = __funnelshift_r(S.xraw[buf][r][g], S.xraw[buf][r][g + 1], shift);
      const int valid = P.k - (k0 + 4 * g);  // k codes of this word inside the row
      if (gm >= P.m || valid <= 0)
        v = 0u;
      else if (valid < 4)
        v &= (1u << (8 * valid)) - 1u;
      S.xs4[r][g] = (int)v;
    }
  } else {
    // (K row, four bytes = eight columns): 256 tasks, one a thread.
    for (int i = threadIdx.x; i < P2_BK * (P2_BN / 8); i += P2_THREADS) {
      const int r = i / (P2_BN / 8), u = i - r * (P2_BN / 8);
      const int gk = k0 + r;
      const unsigned shift =
          (p2_lead(P.packed) + (unsigned)gk * (unsigned)P.nb + (unsigned)(n0 / 2)) & 3u;
      unsigned v = __funnelshift_r(S.cst[buf][r][u], S.cst[buf][r][u + 1], 8u * shift);
      const int valid = gk < P.k ? P.nb - n0 / 2 - 4 * u : 0;  // bytes inside the matrix
      if (valid <= 0)
        v = 0u;
      else if (valid < 4)
        v &= (1u << (8 * valid)) - 1u;
      float4* dst = reinterpret_cast<float4*>(&S.ws[r][8 * u]);
      dst[0] = make_float4(p2_decode_f32(v & 15u), p2_decode_f32((v >> 4) & 15u),
                           p2_decode_f32((v >> 8) & 15u), p2_decode_f32((v >> 12) & 15u));
      dst[1] = make_float4(p2_decode_f32((v >> 16) & 15u), p2_decode_f32((v >> 20) & 15u),
                           p2_decode_f32((v >> 24) & 15u), p2_decode_f32(v >> 28));
    }
  }
}

__device__ __forceinline__ void p2_cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void p2_cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void p2_cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <bool INT>
__global__ void __launch_bounds__(P2_THREADS) p2_matmul_kernel(const P2Matmul P) {
  typedef typename std::conditional<INT, int, float>::type T;
  typedef typename std::conditional<INT, int4, float4>::type T4;
  __shared__ __align__(16) P2Smem<INT> S;
  // Rank 0's receive slots, one (BM, BN) tile per peer (dynamic: split > 1).
  extern __shared__ __align__(16) unsigned char p2_recv[];
  const int rank = blockIdx.x;  // the cluster spans grid.x: rank = blockIdx.x
  // Phase 1 of the cluster barrier, waited on after the K loop: by then
  // every CTA of the cluster has started, so rank 0's slots may be written.
  if (P.split > 1) p2_cluster_arrive_relaxed();
  const int n0 = blockIdx.y * P2_BN;
  const int m0 = blockIdx.z * P2_BM;
  const int tx = threadIdx.x % 16;  // columns 4 tx .. 4 tx + 3 of the tile
  const int ty = threadIdx.x / 16;  // row ty of the tile
  const int kb0 = (int)((long long)rank * P.slices / P.split);
  const int nk = (int)((long long)(rank + 1) * P.slices / P.split) - kb0;

  T acc[4] = {0, 0, 0, 0};
  // Group g of cp.async holds slice kb0 + g (or nothing past the range).
#pragma unroll
  for (int s = 0; s < P2_STAGES - 1; ++s) {
    if (s < nk) p2_stage<INT>(S, P, s, kb0 + s, m0, n0);
    p2_commit();
  }
  for (int i = 0; i < nk; ++i) {
    const int buf = i % P2_STAGES;
    p2_wait<P2_STAGES - 2>();
    __syncthreads();  // slice i landed; every thread is done with slice i - 1
    if (i + P2_STAGES - 1 < nk)  // into the stage slice i - 1 held
      p2_stage<INT>(S, P, (i + P2_STAGES - 1) % P2_STAGES, kb0 + i + P2_STAGES - 1, m0, n0);
    p2_commit();
    p2_decode<INT>(S, P, buf, kb0 + i, m0, n0);
    __syncthreads();
    if constexpr (INT) {
#pragma unroll
      for (int g = 0; g < P2_BK / 4; ++g) {
        const int a = S.xs4[ty][g];
        const int4 w = *reinterpret_cast<const int4*>(&S.ws4[g][4 * tx]);
        acc[0] = __dp4a(a, w.x, acc[0]);
        acc[1] = __dp4a(a, w.y, acc[1]);
        acc[2] = __dp4a(a, w.z, acc[2]);
        acc[3] = __dp4a(a, w.w, acc[3]);
      }
    } else {
#pragma unroll 2
      for (int k4 = 0; k4 < P2_BK; k4 += 4) {  // four k of x in one load, k in order
        const float4 x4 = *reinterpret_cast<const float4*>(&S.xs[buf][ty][k4]);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 w = *reinterpret_cast<const float4*>(&S.ws[k4 + q][4 * tx]);
          acc[0] = fmaf(xv[q], w.x, acc[0]);
          acc[1] = fmaf(xv[q], w.y, acc[1]);
          acc[2] = fmaf(xv[q], w.z, acc[2]);
          acc[3] = fmaf(xv[q], w.w, acc[3]);
        }
      }
    }
  }

  if (P.split > 1) {
    T4* slots = reinterpret_cast<T4*>(p2_recv);  // (split - 1, BM, BN / 4)
    const int at = ty * (P2_BN / 4) + tx;
    p2_cluster_wait_acquire();
    if (rank != 0) {
      // Push this partial tile into slot rank - 1 of rank 0, then arrive
      // (release: the stores are visible to rank 0 after its wait) and
      // leave: no CTA reads a peer's memory, so a peer need not wait.
      T4* dst = cg::this_cluster().map_shared_rank(slots + (rank - 1) * (P2_BM * P2_BN / 4), 0);
      dst[at] = T4{acc[0], acc[1], acc[2], acc[3]};
      p2_cluster_arrive_release();
      return;
    }
    p2_cluster_arrive_release();
    p2_cluster_wait_acquire();  // every peer's tile is in the slots
    for (int q = 0; q < P.split - 1; ++q) {  // in rank order
      const T4 v = slots[q * (P2_BM * P2_BN / 4) + at];
      acc[0] += v.x;
      acc[1] += v.y;
      acc[2] += v.z;
      acc[3] += v.w;
    }
  }

  const int gm = m0 + ty;
  const int gn = n0 + 4 * tx;
  if (gm >= P.m || gn >= P.n) return;
  float y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float sc = gn + j < P.n ? __ldg(P.scale + gn + j) : 0.0f;
    if constexpr (INT)
      y[j] = __fmul_rn(__int2float_rn(acc[j]), __fmul_rn(P.x_scale, sc));
    else
      y[j] = __fmul_rn(acc[j], sc);
  }
  float* o = P.out + (size_t)gm * P.n + gn;
  if ((P.n & 3) == 0) {  // gn + 3 < N, and 16-byte aligned
    *reinterpret_cast<float4*>(o) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (gn + j < P.n) o[j] = y[j];
  }
}

extern "C" int p2_desc_bytes() { return (int)sizeof(P2Matmul); }

extern "C" int p2_matmul_launch(const P2Matmul* desc, void* stream) {
  const int s = desc->split;
  if (s != 1 && s != 2 && s != 4 && s != 8) return (int)cudaErrorInvalidValue;
  // Rank 0's receive slots: one 4-byte (BM, BN) tile per peer.
  const int recv = (s - 1) * P2_BM * P2_BN * 4;
  if (recv > 0) {
    cudaError_t e = desc->int_mode
                        ? cudaFuncSetAttribute(p2_matmul_kernel<true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, recv)
                        : cudaFuncSetAttribute(p2_matmul_kernel<false>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, recv);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(s, (desc->n + P2_BN - 1) / P2_BN, (desc->m + P2_BM - 1) / P2_BM);
  cfg.blockDim = dim3(P2_THREADS);
  cfg.dynamicSmemBytes = recv;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = s;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = desc->int_mode ? cudaLaunchKernelEx(&cfg, p2_matmul_kernel<true>, *desc)
                                 : cudaLaunchKernelEx(&cfg, p2_matmul_kernel<false>, *desc);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
