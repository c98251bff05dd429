// Hand-written Hopper (sm_90a) kernel for the Mamba-1 selective scan.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/ssm_scan/scan.py). The entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// ssm_scan_kernel<T, NMAX>
//   Replaces: src/repro/kernels/ssm_scan/scan.py:ssm_scan_pallas
//             (body _ssm_scan_kernel).
//   Computes: per batch row and channel d, with the state h (N values)
//             starting at h0 (or 0):
//               h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * x_t) * B_t
//               y_t = sum_j h_t[j] * C_t[j] + D_skip[d] * x_t
//             and writes the final state h_S as h_last. x, B and C are
//             read in the model's dtype T (bf16 or f32) and dt in f32, all
//             converted in registers; everything is computed in f32, with
//             expf (no fast-math). The initial and final states are what
//             the reference's mamba_apply carries between prefill and
//             decode; decode is the same kernel at S = 1.
//   Bound on this card: at the falcon-mamba layer (Bz 4, S 512, D 8192,
//             N 16) the Bz*S*D*N = 268 M expf over the SFU rate (16 per
//             clock per SM, 132 SMs) is about 0.065 ms; the bytes (x, dt,
//             y per element, B, C, A and both states) about 0.05 ms at
//             3.35 TB/s; the 6 FLOPs per state update about 0.02 ms at
//             67 TFLOP/s. So the exponentials bind it.
//   Design:   grid (ceil(D / block_d), Bz), block_d threads; each thread
//             owns one channel d and keeps its N states and A[d] in
//             registers for the whole sequence (the state never touches
//             device memory). The sequential grid axis of the TPU kernel
//             becomes the loop over t inside the thread. B_t and C_t are
//             shared by every channel of a batch row: a chunk of
//             SSM_CHUNK steps is staged in shared memory and read as a
//             broadcast. x_t and dt_t are read SSM_UNROLL steps ahead into
//             registers, so those loads are in flight together; every
//             warp reads and writes 32 consecutive channels (coalesced).
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define SSM_CHUNK 64
#define SSM_UNROLL 8
#define SSM_MAX_N 16

struct SsmScan {
  const void* x;       // (Bz, S, D) T, strides x_sb / x_ss, unit stride over D
  const float* dt;     // (Bz, S, D) f32, strides dt_sb / dt_ss
  const void* b;       // (Bz, S, N) T, strides b_sb / b_ss
  const void* c;       // (Bz, S, N) T, strides c_sb / c_ss
  const float* a;      // (D, N) f32 contiguous: A = -exp(a_log)
  const float* d_skip; // (D,) f32
  const float* h0;     // (Bz, D, N) f32 contiguous, or null for zeros
  float* y;            // (Bz, S, D) f32 contiguous
  float* h_last;       // (Bz, D, N) f32 contiguous
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int bz, s, d, n;
  int block_d;
  int bf16;            // T is bf16 (1) or f32 (0)
};

template <typename T>
__device__ __forceinline__ float ssm_load(const T* p, long long i);
template <>
__device__ __forceinline__ float ssm_load<float>(const float* p, long long i) {
  return __ldg(p + i);
}
template <>
__device__ __forceinline__ float ssm_load<__nv_bfloat16>(const __nv_bfloat16* p,
                                                          long long i) {
  return __bfloat162float(p[i]);
}

template <typename T, int NMAX>
__global__ void ssm_scan_kernel(const SsmScan p) {
  __shared__ float s_b[SSM_CHUNK][NMAX];
  __shared__ float s_c[SSM_CHUNK][NMAX];

  const int bi = blockIdx.y;
  const int d = blockIdx.x * p.block_d + threadIdx.x;
  const int n = p.n;
  const bool live = d < p.d;
  const T* __restrict__ x = static_cast<const T*>(p.x) + bi * p.x_sb;
  const float* __restrict__ dt = p.dt + bi * p.dt_sb;
  const T* __restrict__ bsrc = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* __restrict__ csrc = static_cast<const T*>(p.c) + bi * p.c_sb;
  float* __restrict__ y = p.y + (long long)bi * p.s * p.d;

  float h[NMAX], a[NMAX];
  const long long sidx = ((long long)bi * p.d + d) * n;
#pragma unroll
  for (int j = 0; j < NMAX; ++j) {
    const bool on = live && j < n;
    a[j] = on ? __ldg(p.a + (long long)d * n + j) : 0.0f;
    h[j] = (on && p.h0) ? __ldg(p.h0 + sidx + j) : 0.0f;
  }
  const float dsk = live ? __ldg(p.d_skip + d) : 0.0f;

  for (int t0 = 0; t0 < p.s; t0 += SSM_CHUNK) {
    const int steps = min(SSM_CHUNK, p.s - t0);
    __syncthreads();  // the previous chunk's B and C are consumed
    for (int i = threadIdx.x; i < steps * n; i += blockDim.x) {
      const int tt = i / n, j = i - tt * n;
      s_b[tt][j] = ssm_load<T>(bsrc, (long long)(t0 + tt) * p.b_ss + j);
      s_c[tt][j] = ssm_load<T>(csrc, (long long)(t0 + tt) * p.c_ss + j);
    }
    __syncthreads();
    if (!live) continue;
    for (int u0 = 0; u0 < steps; u0 += SSM_UNROLL) {
      float xr[SSM_UNROLL], dr[SSM_UNROLL];
#pragma unroll
      for (int u = 0; u < SSM_UNROLL; ++u) {
        const long long t = t0 + u0 + u;
        const bool in = u0 + u < steps;
        xr[u] = in ? ssm_load<T>(x, t * p.x_ss + d) : 0.0f;
        dr[u] = in ? __ldg(dt + t * p.dt_ss + d) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < SSM_UNROLL; ++u) {
        if (u0 + u >= steps) break;
        const int tt = u0 + u;
        const float dx = dr[u] * xr[u];
        float acc = 0.0f;
#pragma unroll
        for (int j = 0; j < NMAX; ++j) {
          if (j < n) {
            const float da = expf(dr[u] * a[j]);
            h[j] = da * h[j] + dx * s_b[tt][j];
            acc += h[j] * s_c[tt][j];
          }
        }
        y[(long long)(t0 + tt) * p.d + d] = acc + dsk * xr[u];
      }
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < NMAX; ++j)
      if (j < n) p.h_last[sidx + j] = h[j];
  }
}

template <typename T>
static void ssm_launch_t(const SsmScan& p, cudaStream_t stream) {
  dim3 grid((p.d + p.block_d - 1) / p.block_d, p.bz);
  if (p.n <= 4)
    ssm_scan_kernel<T, 4><<<grid, p.block_d, 0, stream>>>(p);
  else if (p.n <= 8)
    ssm_scan_kernel<T, 8><<<grid, p.block_d, 0, stream>>>(p);
  else
    ssm_scan_kernel<T, SSM_MAX_N><<<grid, p.block_d, 0, stream>>>(p);
}

extern "C" int ssm_desc_bytes() { return (int)sizeof(SsmScan); }

extern "C" int ssm_max_n() { return SSM_MAX_N; }

extern "C" int ssm_scan_launch(const SsmScan* desc, void* stream) {
  if (desc->bf16)
    ssm_launch_t<__nv_bfloat16>(*desc, (cudaStream_t)stream);
  else
    ssm_launch_t<float>(*desc, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
