// Hand-written Hopper (sm_90a) kernel for the gradient of the Mamba-1
// selective scan.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/ssm_scan/scan.py, ssm_scan_bwd_cuda).
// The entry point launches two kernels on the caller's stream, allocates
// nothing (the wrapper hands it the gradients and one workspace), and
// returns cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// ssm_scan_bwd_kernel<T, L, NPL> and ssm_scan_bwd_reduce<T>
//   Replaces: no Pallas kernel. The JAX package differentiates its chunked
//             composition with XLA's autodiff (src/repro/models/ssm.py,
//             mamba_apply), and the port's plain version is the same
//             product (ref.py ssm_scan_bwd_ref); this is that gradient as
//             a kernel, the backward of ssm_scan_kernel (ssm_scan.cu,
//             which replaces src/repro/kernels/ssm_scan/scan.py:
//             ssm_scan_pallas).
//   Computes: per batch row, channel d and state n, with
//             h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t from h0 (or 0) and
//             y_t = sum_n h_t C_t + D x_t, given the cotangents g_y of y
//             and g_h of h_S (either may be absent: zeros):
//               lam_t = g_y,t C_t + exp(dt_{t+1} A) lam_{t+1}, from g_h
//               dx_t  = dt_t sum_n lam_t B_t + D g_y,t
//               ddt_t = sum_n lam_t (A exp(dt_t A) h_{t-1} + x_t B_t)
//               dB_t  = sum_d lam_t dt_t x_t     dC_t = sum_d g_y,t h_t
//               dA    = sum_{b,t} lam_t dt_t exp(dt_t A) h_{t-1}
//               dD    = sum_{b,t} g_y,t x_t      dh0 = exp(dt_1 A) lam_1
//             in f32, with IEEE exp2f of dt * (A log2(e)) as the forward
//             kernel takes it and no fast-math; dx, dB and dC are written
//             in the model's dtype T (bf16 or f32), the rest in f32.
//   Bound on this card: at the falcon-mamba layer (Bz 4, S 512, D 8192,
//             N 16) the three exponentials per state and step (the
//             forward pass to the checkpoints, the chunk's recompute, the
//             reverse step) over the SFU rate (16 per clock per SM, 132
//             SMs) take about 0.19 ms, one alone 0.064 ms; the bytes (x,
//             dt, g_y, dx, ddt per element, B, C, dB, dC, A, dA) about
//             0.08 ms at 3.35 TB/s, the workspace's round trip about
//             0.1 ms more.
//   Design:   each channel's N states are split over L lanes as in the
//             forward (NPL = N / L states, their A values, adjoints and
//             dA sums in each lane's registers). A CTA of DC channels of
//             one batch row walks the sequence twice:
//             1. forward, chunk by chunk, writing the state at the start
//                of each chunk of TC steps to a checkpoint buffer (the
//                only state that leaves the SM: Bz x S/TC x D x N floats,
//                never the (Bz, S, D, N) states);
//             2. backward, chunk by chunk from the last: the chunk's
//                inputs are staged in shared memory, its TC states
//                recomputed from the checkpoint into shared memory (each
//                thread its own column, conflict-free), then the reverse
//                steps carry lam in registers. Per step a channel's lanes
//                sum dx and ddt by __shfl_xor_sync; dB and dC, sums over
//                channels, are reduce-scattered over the warp's channels
//                by shuffles (each round halves the values a lane holds),
//                stored per warp and step in shared memory, summed over
//                the CTA's warps in order and written as the CTA's
//                partial for its channel block.
//             dA and dD are summed over the row's steps in registers and
//             written per batch row. A second kernel sums the channel
//             blocks' partials of dB and dC and the batch rows' of dA and
//             dD, each in a fixed order: no atomics, so two calls give the
//             same bits (a CUDA graph of the train step replays them).
//             The host picks L (as the forward), TC and DC (scan.py
//             scan_bwd_plan). Ragged D and N are masked: the extra lanes
//             compute on zeros and store nothing.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSMB_MAX_THREADS 256
#define SSMB_MAX_NPL 32  // states a lane keeps in registers
#define SSMB_MAX_LANES 16
#define SSMB_REDUCE_THREADS 256

struct SsmScanBwd {
  const void* x;        // (Bz, S, D) T, strides x_sb / x_ss, unit stride over D
  const float* dt;      // (Bz, S, D) f32, strides dt_sb / dt_ss
  const void* b;        // (Bz, S, N) T, strides b_sb / b_ss
  const void* c;        // (Bz, S, N) T, strides c_sb / c_ss
  const float* a;       // (D, N) f32 contiguous
  const float* d_skip;  // (D,) f32
  const float* h0;      // (Bz, D, N) f32 contiguous, or null for zeros
  const float* g_y;     // (Bz, S, D) f32, strides gy_sb / gy_ss, or null for zeros
  const float* g_h;     // (Bz, D, N) f32 contiguous, or null for zeros
  void* grad_x;         // (Bz, S, D) T contiguous
  float* grad_dt;       // (Bz, S, D) f32 contiguous
  void* grad_b;         // (Bz, S, N) T contiguous
  void* grad_c;         // (Bz, S, N) T contiguous
  float* grad_a;        // (D, N) f32
  float* grad_d;        // (D,) f32
  float* grad_h0;       // (Bz, D, N) f32, or null
  float* ckpt;          // (Bz, ceil(S / chunk), D, L * NPL) f32, 16-byte aligned
  float* ws_bc;         // (Bz, D blocks, S, 2N) f32: each block's dB, dC
  float* ws_a;          // (Bz, D, N) f32: each row's dA
  float* ws_d;          // (Bz, D) f32: each row's dD
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, gy_sb, gy_ss;  // in elements
  int bz, s, d, n;
  int lanes;  // L: lanes per channel, a power of two, L * NPL >= N
  int chunk;  // TC: steps a checkpoint covers, staged at once
  int dc;     // channels per CTA (a multiple of 8): DC * L threads
  int bcp;    // floats per staged B / C row (L * NPL rounded up to 4)
  int bf16;   // T is bf16 (1) or f32 (0)
};

// Shared-memory bytes of one CTA; the host's bwd_smem_bytes computes the
// same. Per step: the recomputed states (DC * L * NPL), dt, g_y, dx, ddt
// (4 * DC f32), B and C rows (2 * BCP f32), each warp's dB / dC sums
// (2 * BCP a warp) and x in its own type.
__host__ __device__ inline int ssmb_smem_bytes(int chunk, int dc, int lanes, int npl, int bcp,
                                               int elem) {
  const int warps = dc * lanes / 32;
  return chunk * (4 * (dc * lanes * npl + 4 * dc + 2 * bcp + warps * 2 * bcp) + dc * elem);
}

__device__ __forceinline__ float ssmb_f(float v) { return v; }
__device__ __forceinline__ float ssmb_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// NPL consecutive floats of a staged row at p (16-byte aligned where NPL
// is a multiple of 4, 8-byte where it is 2).
template <int NPL>
__device__ __forceinline__ void ssmb_row(const float* p, float (&v)[NPL]) {
  if constexpr (NPL % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NPL / 4; ++q) {
      const float4 u = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else if constexpr (NPL == 2) {
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x;
    v[1] = u.y;
  } else {
    v[0] = p[0];
  }
}

// A lane's NPL states of a checkpoint, in or out (16 bytes at a time
// where NPL is a multiple of 4: the buffer and every lane's run of NPL
// floats start 16-byte aligned).
template <int NPL>
__device__ __forceinline__ void ssmb_put(float* p, const float (&v)[NPL]) {
  if constexpr (NPL % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NPL / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                    v[4 * q + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) p[i] = v[i];
  }
}

template <int NPL>
__device__ __forceinline__ void ssmb_get(const float* p, float (&v)[NPL]) {
  if constexpr (NPL % 4 == 0) {
#pragma unroll
    for (int q = 0; q < NPL / 4; ++q) {
      const float4 u = reinterpret_cast<const float4*>(p)[q];
      v[4 * q] = u.x;
      v[4 * q + 1] = u.y;
      v[4 * q + 2] = u.z;
      v[4 * q + 3] = u.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < NPL; ++i) v[i] = p[i];
  }
}

// Rounds of the channel sum: log2 of the channels a warp holds (32 / L).
template <int L>
struct SsmbRounds {
  static constexpr int value = L == 1 ? 5 : L == 2 ? 4 : L == 4 ? 3 : L == 8 ? 2 : 1;
};

// Sum v (a lane's NPL dB values, then its NPL dC values) over the warp's
// channels, lane bits L..16, and store the sums into this warp's row of
// 2 * bcp floats (dB at [0, bcp), dC at [bcp, 2 bcp), state j * NPL + i).
// Reduce-scatter: in the round of lane bit m a lane keeps the half of its
// values its bit selects and adds the partner's copy of that half, so
// each round halves what a lane holds; once one value is left, the rounds
// add it across (butterfly) and the lanes whose remaining bits are 0
// store. tests/test_torch_scan_bwd.py mirrors it step for step on the CPU.
template <int L, int NPL>
__device__ __forceinline__ void ssmb_channel_sum(float (&v)[2 * NPL], float* row, int j, int lane,
                                                 int bcp) {
  constexpr int V = 2 * NPL;
  constexpr int R = SsmbRounds<L>::value;
  int base = 0;
  bool writer = true;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int m = 16 >> r;
    const int cur = (V >> r) > 1 ? (V >> r) : 1;
    if (cur > 1) {
      const int h = cur >> 1;
      const bool upper = lane & m;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float keep = upper ? v[i + h] : v[i];
        const float send = upper ? v[i] : v[i + h];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
      }
      if (upper) base += h;
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], m);
      if (lane & m) writer = false;
    }
  }
  constexpr int LEFT = (V >> R) > 1 ? (V >> R) : 1;
  if (writer) {
#pragma unroll
    for (int k = 0; k < LEFT; ++k) {
      const int idx = base + k;
      row[idx < NPL ? j * NPL + idx : bcp + j * NPL + idx - NPL] = v[k];
    }
  }
}

template <typename T, int L, int NPL>
__global__ void __launch_bounds__(SSMB_MAX_THREADS) ssm_scan_bwd_kernel(const SsmScanBwd p) {
  extern __shared__ __align__(16) unsigned char ssmb_smem[];
  constexpr int NP = L * NPL;
  constexpr float LOG2E = 1.4426950408889634f;
  const int TC = p.chunk, DC = p.dc, BCP = p.bcp;
  const int NT = DC * L, W = NT / 32;
  // Layout (every piece a multiple of 16 B): h[TC][NPL][NT], dt[TC][DC],
  // g_y[TC][DC], b[TC][BCP], c[TC][BCP], red[W][TC][2 BCP], dx[TC][DC],
  // ddt[TC][DC] (f32), then x[TC][DC] (T).
  float* const sh = reinterpret_cast<float*>(ssmb_smem);
  float* const sdt = sh + TC * NPL * NT;
  float* const sgy = sdt + TC * DC;
  float* const sb = sgy + TC * DC;
  float* const sc = sb + TC * BCP;
  float* const sred = sc + TC * BCP;
  float* const sdx = sred + W * TC * 2 * BCP;
  float* const sddt = sdx + TC * DC;
  T* const sx = reinterpret_cast<T*>(sddt + TC * DC);

  const int bi = blockIdx.y, blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * DC;
  const int tid = threadIdx.x;
  const int cl = tid / L;          // this thread's channel in the CTA
  const int j = tid - cl * L;      // its lane in the channel's group
  const int lane = tid & 31, warp = tid >> 5;
  const int d = d0 + cl;
  const bool live = d < p.d;
  const int n = p.n;
  const int dvalid = min(DC, p.d - d0);
  const int K = (p.s + TC - 1) / TC;

  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + d0;
  const float* dtg = p.dt + bi * p.dt_sb + d0;
  const float* gyg = p.g_y ? p.g_y + bi * p.gy_sb + d0 : nullptr;
  const T* bg = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cg = static_cast<const T*>(p.c) + bi * p.c_sb;

  // Rows [0, rows) of the chunk at step t0 into shared memory: x and dt
  // (and, backward, g_y) per channel, zero past D; B (and C) as f32 rows,
  // zero past N.
  auto stage = [&](int t0, bool backward) {
    const int rows = min(TC, p.s - t0);
    for (int i = tid; i < rows * DC; i += NT) {
      const int r = i / DC, e = i - r * DC;
      const bool in = e < dvalid;
      const long long t = t0 + r;
      sx[r * DC + e] = in ? xg[t * p.x_ss + e] : T(0.0f);
      sdt[r * DC + e] = in ? dtg[t * p.dt_ss + e] : 0.0f;
      if (backward) sgy[r * DC + e] = in && gyg ? gyg[t * p.gy_ss + e] : 0.0f;
    }
    for (int i = tid; i < rows * BCP; i += NT) {
      const int r = i / BCP, e = i - r * BCP;
      const bool in = e < n;
      const long long t = t0 + r;
      sb[r * BCP + e] = in ? ssmb_f(bg[t * p.b_ss + e]) : 0.0f;
      if (backward) sc[r * BCP + e] = in ? ssmb_f(cg[t * p.c_ss + e]) : 0.0f;
    }
  };

  // This lane's A values (and A log2(e), as the forward scales them),
  // zero past N and D.
  float ar[NPL], a2[NPL], h[NPL];
  const long long sbase = ((long long)bi * p.d + d) * n + j * NPL;  // (Bz, D, N) states
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    const bool in = live && j * NPL + i < n;
    ar[i] = in ? __ldg(p.a + (long long)d * n + j * NPL + i) : 0.0f;
    a2[i] = ar[i] * LOG2E;
    h[i] = in && p.h0 ? __ldg(p.h0 + sbase + i) : 0.0f;
  }
  const float dsk = live ? __ldg(p.d_skip + d) : 0.0f;
  float* const ck = p.ckpt + ((long long)bi * K * p.d + d) * NP + j * NPL;
  const long long ck_step = (long long)p.d * NP;  // one chunk's checkpoint

  // 1. Forward to the checkpoints: the state before chunk k, k < K.
  for (int k = 0; k < K; ++k) {
    if (live) ssmb_put<NPL>(ck + k * ck_step, h);
    if (k == K - 1) break;
    __syncthreads();
    stage(k * TC, false);
    __syncthreads();
    for (int u = 0; u < TC; ++u) {  // chunks before the last are whole
      const float xv = ssmb_f(sx[u * DC + cl]);
      const float dtv = sdt[u * DC + cl];
      float bv[NPL];
      ssmb_row<NPL>(sb + u * BCP + j * NPL, bv);
      const float dx = dtv * xv;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const float da = exp2f(dtv * a2[i]);
        h[i] = da * h[i] + dx * bv[i];
      }
    }
  }

  // 2. Backward, chunk by chunk from the last. mu = exp(dt_{t+1} A)
  // lam_{t+1}, the adjoint carried into step t; it starts at g_h.
  float mu[NPL], ga[NPL];
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    mu[i] = live && p.g_h && j * NPL + i < n ? __ldg(p.g_h + sbase + i) : 0.0f;
    ga[i] = 0.0f;
  }
  float gd = 0.0f;
  for (int k = K - 1; k >= 0; --k) {
    const int t0 = k * TC;
    const int rows = min(TC, p.s - t0);
    __syncthreads();  // the last chunk's staging, sums and outputs are read
    stage(t0, true);
    __syncthreads();
    // The chunk's states from its checkpoint, each thread its own column.
    float hstart[NPL];
    if (live) {
      ssmb_get<NPL>(ck + k * ck_step, hstart);
    } else {
#pragma unroll
      for (int i = 0; i < NPL; ++i) hstart[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < NPL; ++i) h[i] = hstart[i];
    for (int u = 0; u < rows; ++u) {
      const float xv = ssmb_f(sx[u * DC + cl]);
      const float dtv = sdt[u * DC + cl];
      float bv[NPL];
      ssmb_row<NPL>(sb + u * BCP + j * NPL, bv);
      const float dx = dtv * xv;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const float da = exp2f(dtv * a2[i]);
        h[i] = da * h[i] + dx * bv[i];
        sh[(u * NPL + i) * NT + tid] = h[i];
      }
    }
    // The reverse steps.
    for (int u = rows - 1; u >= 0; --u) {
      const float xv = ssmb_f(sx[u * DC + cl]);
      const float dtv = sdt[u * DC + cl];
      const float gyv = sgy[u * DC + cl];
      float bv[NPL], cv[NPL], v[2 * NPL];
      ssmb_row<NPL>(sb + u * BCP + j * NPL, bv);
      ssmb_row<NPL>(sc + u * BCP + j * NPL, cv);
      const float dx = dtv * xv;
      float s_dx = 0.0f, s_ddt = 0.0f;
#pragma unroll
      for (int i = 0; i < NPL; ++i) {
        const float ht = sh[(u * NPL + i) * NT + tid];
        const float hp = u > 0 ? sh[((u - 1) * NPL + i) * NT + tid] : hstart[i];
        const float lam = gyv * cv[i] + mu[i];
        const float da = exp2f(dtv * a2[i]);
        const float w = lam * da * hp;
        s_dx += lam * bv[i];
        s_ddt += ar[i] * w + lam * xv * bv[i];
        ga[i] += dtv * w;
        v[i] = lam * dx;
        v[NPL + i] = gyv * ht;
        mu[i] = da * lam;
      }
      gd += gyv * xv;
#pragma unroll
      for (int m = 1; m < L; m <<= 1) {
        s_dx += __shfl_xor_sync(0xffffffffu, s_dx, m);
        s_ddt += __shfl_xor_sync(0xffffffffu, s_ddt, m);
      }
      if (j == 0) {
        sdx[u * DC + cl] = dtv * s_dx + dsk * gyv;
        sddt[u * DC + cl] = s_ddt;
      }
      ssmb_channel_sum<L, NPL>(v, sred + (warp * TC + u) * 2 * BCP, j, lane, BCP);
    }
    __syncthreads();
    // dx and ddt of the chunk, coalesced; this block's dB and dC, the
    // warps' sums added in order.
    for (int i = tid; i < rows * DC; i += NT) {
      const int r = i / DC, e = i - r * DC;
      if (e < dvalid) {
        const long long o = ((long long)bi * p.s + t0 + r) * p.d + d0 + e;
        static_cast<T*>(p.grad_x)[o] = T(sdx[r * DC + e]);
        p.grad_dt[o] = sddt[r * DC + e];
      }
    }
    const int n2 = 2 * n;
    for (int i = tid; i < rows * n2; i += NT) {
      const int r = i / n2, e = i - r * n2;
      const int slot = e < n ? e : BCP + e - n;
      float acc = 0.0f;
      for (int w = 0; w < W; ++w) acc += sred[(w * TC + r) * 2 * BCP + slot];
      p.ws_bc[(((long long)bi * nblk + blk) * p.s + t0 + r) * n2 + e] = acc;
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      if (j * NPL + i < n) {
        p.ws_a[sbase + i] = ga[i];
        if (p.grad_h0) p.grad_h0[sbase + i] = mu[i];
      }
    }
    if (j == 0) p.ws_d[(long long)bi * p.d + d] = gd;
  }
}

// dB and dC: each channel block's partial summed in block order; dA and
// dD: each batch row's summed in row order.
template <typename T>
__global__ void __launch_bounds__(SSMB_REDUCE_THREADS) ssm_scan_bwd_reduce(const SsmScanBwd p,
                                                                            int nblk) {
  const long long n2 = 2LL * p.n, per_b = (long long)p.s * n2;
  const long long nbc = (long long)p.bz * per_b, na = (long long)p.d * p.n;
  const long long total = nbc + na + p.d;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nbc) {
      const long long bi = i / per_b, rem = i - bi * per_b;
      const float* src = p.ws_bc + bi * nblk * per_b + rem;
      float acc = 0.0f;
      for (int k = 0; k < nblk; ++k) acc += src[k * per_b];
      const long long t = rem / n2;
      const int e = (int)(rem - t * n2);
      T* out = static_cast<T*>(e < p.n ? p.grad_b : p.grad_c);
      out[(bi * p.s + t) * p.n + (e < p.n ? e : e - p.n)] = T(acc);
    } else if (i < nbc + na) {
      const long long e = i - nbc;
      float acc = 0.0f;
      for (int b = 0; b < p.bz; ++b) acc += p.ws_a[b * na + e];
      p.grad_a[e] = acc;
    } else {
      const long long e = i - nbc - na;
      float acc = 0.0f;
      for (int b = 0; b < p.bz; ++b) acc += p.ws_d[b * (long long)p.d + e];
      p.grad_d[e] = acc;
    }
  }
}

typedef void (*SsmbKernel)(const SsmScanBwd);

// The (lanes, states a lane) kernels compiled: the forward's tiles
// (ssm_scan.cu SSM_TILES, scan.py KERNEL_TILES), since the backward takes
// the forward's lanes.
#define SSMB_TILES(T)                                                                 \
  X(T, 1, 1) X(T, 2, 1) X(T, 2, 2) X(T, 2, 8) X(T, 4, 1) X(T, 4, 2) X(T, 4, 4)        \
  X(T, 4, 8) X(T, 4, 16) X(T, 4, 32) X(T, 8, 2) X(T, 8, 32) X(T, 16, 1) X(T, 16, 32)

template <typename T>
static SsmbKernel ssmb_kernel_tile(int lanes, int npl) {
#define X(T_, L_, NPL_) \
  if (lanes == L_ && npl == NPL_) return ssm_scan_bwd_kernel<T_, L_, NPL_>;
  SSMB_TILES(T)
#undef X
  return nullptr;
}

extern "C" int ssm_bwd_desc_bytes() { return (int)sizeof(SsmScanBwd); }

extern "C" int ssm_bwd_max_npl() { return SSMB_MAX_NPL; }

extern "C" int ssm_bwd_smem_bytes(int chunk, int dc, int lanes, int npl, int bcp, int elem) {
  return ssmb_smem_bytes(chunk, dc, lanes, npl, bcp, elem);
}

extern "C" int ssm_scan_bwd_launch(const SsmScanBwd* desc, void* stream) {
  const SsmScanBwd& p = *desc;
  const int L = p.lanes;
  if (L < 1 || L > SSMB_MAX_LANES || (L & (L - 1)) || p.dc % 8 || p.chunk < 1 || p.s < 1 ||
      p.bz < 1 || p.d < 1 || p.n < 1 || p.bcp < L || p.bcp % 4)
    return (int)cudaErrorInvalidValue;
  const int npl = (p.n + L - 1) / L;
  int pw = 1;
  while (pw < npl) pw <<= 1;
  if (pw > SSMB_MAX_NPL || p.bcp < L * pw) return (int)cudaErrorInvalidValue;
  const int threads = p.dc * L;
  if (threads > SSMB_MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  SsmbKernel kernel = p.bf16 ? ssmb_kernel_tile<__nv_bfloat16>(L, pw) : ssmb_kernel_tile<float>(L, pw);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = ssmb_smem_bytes(p.chunk, p.dc, L, pw, p.bcp, p.bf16 ? 2 : 4);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  const int nblk = (p.d + p.dc - 1) / p.dc;
  kernel<<<dim3(nblk, p.bz), threads, smem, (cudaStream_t)stream>>>(p);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const long long total = (long long)p.bz * p.s * 2 * p.n + (long long)p.d * p.n + p.d;
  long long grid = (total + SSMB_REDUCE_THREADS - 1) / SSMB_REDUCE_THREADS;
  if (grid > 132 * 16) grid = 132 * 16;  // a grid-stride loop covers the rest
  if (p.bf16)
    ssm_scan_bwd_reduce<__nv_bfloat16>
        <<<(int)grid, SSMB_REDUCE_THREADS, 0, (cudaStream_t)stream>>>(p, nblk);
  else
    ssm_scan_bwd_reduce<float><<<(int)grid, SSMB_REDUCE_THREADS, 0, (cudaStream_t)stream>>>(p, nblk);
  err = (int)cudaGetLastError();
  return err;
}
