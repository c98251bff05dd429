// Hand-written Hopper (sm_90a) kernel for the Mamba-1 selective scan.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/ssm_scan/scan.py). The entry point
// launches on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so the wrapper can raise on a refused launch.
//
// ---------------------------------------------------------------------------
// ssm_scan_kernel<T, L, NPL>
//   Replaces: src/repro/kernels/ssm_scan/scan.py:ssm_scan_pallas
//             (body _ssm_scan_kernel).
//   Computes: per batch row and channel d, with the state h (N values)
//             starting at h0 (or 0):
//               h_t = exp(dt_t * A[d]) * h_{t-1} + (dt_t * x_t) * B_t
//               y_t = sum_j h_t[j] * C_t[j] + D_skip[d] * x_t
//             and writes the final state h_S as h_last. x, B and C are
//             read in the model's dtype T (bf16 or f32) and dt in f32;
//             everything is computed in f32, the update written as
//             h = da * h + dx * B, with IEEE exp2f of dt * (A * log2(e))
//             and no fast-math (1.41x faster than expf of dt * A on the
//             H100, PERF.md). The initial and
//             final states are what the reference's mamba_apply carries
//             between prefill and decode; decode is the same kernel at S = 1.
//   Bound on this card: at the falcon-mamba layer (Bz 4, S 512, D 8192,
//             N 16) the Bz*S*D*N = 268 M exponentials over the SFU rate
//             (16 per clock per SM, 132 SMs) take about 0.064 ms; the bytes
//             (x, dt, y per element, B, C, A and both states) about 0.05 ms
//             at 3.35 TB/s; the 6 FLOPs per state update about 0.025 ms at
//             67 TFLOP/s. So the exponentials bind it. What holds it is
//             issue: each state update is several FP32 instructions beside
//             its one MUFU.EX2 (PERF.md).
//   Design:   the TPU kernel kept a (block_d, N) state in VMEM and walked S
//             on its sequential grid axis. Here each channel's N states are
//             split over L lanes (a power of two; NPL = N / L states, and
//             the matching A values, in each lane's registers): lane j of a
//             channel's group owns states [j*NPL, (j+1)*NPL). Splitting the
//             states multiplies the warps in flight by L, so the latency of
//             the SFU and of shared memory has warps to hide behind (one
//             thread per channel left 8 warps an SM at the prefill shape);
//             but each lane repeats a step's loads, conversion and
//             shuffles, so the host takes the fewest lanes that still give
//             every SM about 12 warps: 2 at the prefill shape (2,048
//             warps), 8 for one sequence (PERF.md, the lanes timed on an
//             H100).
//             The lanes step L steps at a time: each lane sums its states'
//             h . C for each of the L steps, then the group reduce-scatters
//             the L partial sums (L - 1 __shfl_xor_sync adds for L steps;
//             lane j ends with step j's y and stores it), so no
//             shared-memory store sits between one step's loads and the
//             next. A chunk's tail is padded with zero steps (dt = 0 and
//             B = 0 leave the state as it is).
//             A CTA of DC channels (DC * L threads) of one batch row stages
//             T steps at a time in shared memory, double-buffered, with one
//             barrier a chunk: x and dt (T x DC) by cp.async, 16 bytes a
//             thread where the rows are 16-byte aligned (zero-filling past
//             D); B and C (T x N, padded to L * NPL with zeros) loaded into
//             registers before the chunk's arithmetic and stored as f32
//             after it, converted once for the CTA rather than by every
//             channel's lanes; y (T x DC) into the other y buffer, written
//             out 16 bytes a thread, coalesced, while the next chunk is
//             computed. Strided views with a unit last stride (mamba_apply's
//             slices of one projection) are read in place. h0, A and h_last
//             are read and written by the lanes of a group in order, so a
//             warp touches one contiguous run of states (coalesced at
//             S = 1, where the state I/O is the kernel's bytes), 16 bytes a
//             lane where A and h0 are 16-byte aligned.
//             The host picks L, T and DC (scan.py scan_plan) from the shape
//             and the card's SMs. Ragged D and N are masked: the extra
//             lanes compute on zeros and store nothing.
// ---------------------------------------------------------------------------

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSM_MAX_THREADS 256
#define SSM_MAX_NPL 32  // states a lane keeps in registers
#define SSM_MAX_LANES 16

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
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;  // in elements
  int bz, s, d, n;
  int lanes;  // L: lanes per channel, a power of two, L * NPL >= N
  int chunk;  // T: steps staged per chunk
  int dc;     // channels per CTA (a multiple of 8): DC * L threads
  int bcp;    // floats per staged B / C row (L * NPL rounded up to 4)
  int vec;    // 16-byte accesses: x (1), dt (2), B (4), C (8) staged; A and h0 (16) read
  int bf16;   // T is bf16 (1) or f32 (0)
};

// Floats per staged y row: DC plus a pad that puts the L steps the lanes
// of a channel store at once on distinct banks (a multiple of 4, so rows
// stay 16-byte aligned).
__host__ __device__ inline int ssm_y_pitch(int dc, int lanes) {
  return dc + (32 / lanes > 4 ? 32 / lanes : 4);
}

// Shared-memory bytes of one CTA; the host's scan_plan computes the same.
__host__ __device__ inline int ssm_smem_bytes(int chunk, int dc, int bcp, int elem, int lanes) {
  return 2 * chunk * (dc * elem + dc * 4 + 2 * bcp * 4 + ssm_y_pitch(dc, lanes) * 4);
}

__device__ __forceinline__ float ssm_f(float v) { return v; }
__device__ __forceinline__ float ssm_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes global -> shared, zero-filled past `bytes` (0..16).
__device__ __forceinline__ void ssm_cp16(void* dst, const void* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(bytes));
}

// Rows [0, rows) of `cols` elements of E bytes each, row r at src + r * ld
// (elements), into shared rows of `pitch` elements; elements past `valid`
// of a row read zero. By 16-byte cp.async where `vec` (the caller checked
// the alignment), else by plain loads and stores.
template <typename E>
__device__ __forceinline__ void ssm_stage(E* dst, int pitch, const E* src, long long ld,
                                          int rows, int cols, int valid, bool vec) {
  constexpr int PER = 16 / sizeof(E);
  if (vec) {
    const int groups = (cols + PER - 1) / PER;
    for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
      const int r = i / groups, g = i - r * groups;
      const int left = valid - g * PER;
      const int bytes = left <= 0 ? 0 : (left >= PER ? 16 : left * (int)sizeof(E));
      // A group wholly past `valid` copies nothing from a row start that
      // is in bounds.
      const E* from = src + r * ld + (bytes ? g * PER : 0);
      ssm_cp16(dst + r * pitch + g * PER, from, bytes);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cols; i += blockDim.x) {
      const int r = i / cols, j = i - r * cols;
      E v;
      if (j < valid)
        v = src[r * ld + j];
      else
        v = E(0.0f);
      dst[r * pitch + j] = v;
    }
  }
}

// Rows [0, rows) of n elements (T) at src + r * ld into shared f32 rows
// of `pitch` floats, converted once here rather than by every channel's
// lanes: 16 bytes a load where `vec` (the caller checked that every row
// starts 16-byte aligned and n * sizeof(T) is a multiple of 16), else one
// element a load. Plain loads: the data lands before the next chunk.
template <typename T>
__device__ __forceinline__ void ssm_stage_f32(float* dst, int pitch, const T* src, long long ld,
                                              int rows, int n, bool vec) {
  constexpr int PER = 16 / sizeof(T);
  if (vec) {
    const int groups = n / PER;
    for (int i = threadIdx.x; i < rows * groups; i += blockDim.x) {
      const int r = i / groups, g = i - r * groups;
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(src + r * ld) + g);
      float4* d = reinterpret_cast<float4*>(dst + r * pitch + g * PER);
      if constexpr (sizeof(T) == 2) {
        d[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                           __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        d[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                           __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      } else {
        d[0] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                           __uint_as_float(u.w));
      }
    }
  } else {
    for (int i = threadIdx.x; i < rows * n; i += blockDim.x) {
      const int r = i / n, e = i - r * n;
      dst[r * pitch + e] = ssm_f(src[r * ld + e]);
    }
  }
}

// The 16-byte groups of B and C of one chunk that a thread prefetches into
// registers, at most SSM_BC_REGS; chunks with more groups a thread stage
// them directly (ssm_stage_f32).
#define SSM_BC_REGS 2

template <typename T>
struct SsmBcPrefetch {
  uint4 v[SSM_BC_REGS];
};

// Load group k of this thread (k-th of threadIdx.x + k * blockDim.x over
// the B groups, then the C groups, of `rows` rows of n / PER groups).
template <typename T>
__device__ __forceinline__ void ssm_bc_load(SsmBcPrefetch<T>& r, const T* bsrc, long long bld,
                                            const T* csrc, long long cld, int rows, int n) {
  constexpr int PER = 16 / sizeof(T);
  const int groups = n / PER, total = rows * groups;
#pragma unroll
  for (int k = 0; k < SSM_BC_REGS; ++k) {
    int i = threadIdx.x + k * blockDim.x;
    if (i < 2 * total) {
      const bool isc = i >= total;
      i -= isc ? total : 0;
      const int row = i / groups, g = i - row * groups;
      r.v[k] = __ldg(reinterpret_cast<const uint4*>(isc ? csrc + row * cld : bsrc + row * bld) +
                     g);
    }
  }
}

template <typename T>
__device__ __forceinline__ void ssm_bc_store(const SsmBcPrefetch<T>& r, float* sbuf, float* cbuf,
                                             int pitch, int rows, int n) {
  constexpr int PER = 16 / sizeof(T);
  const int groups = n / PER, total = rows * groups;
#pragma unroll
  for (int k = 0; k < SSM_BC_REGS; ++k) {
    int i = threadIdx.x + k * blockDim.x;
    if (i < 2 * total) {
      const bool isc = i >= total;
      i -= isc ? total : 0;
      const int row = i / groups, g = i - row * groups;
      float4* d = reinterpret_cast<float4*>((isc ? cbuf : sbuf) + row * pitch + g * PER);
      const uint4 u = r.v[k];
      if constexpr (sizeof(T) == 2) {
        d[0] = make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                           __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        d[1] = make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                           __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      } else {
        d[0] = make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                           __uint_as_float(u.w));
      }
    }
  }
}

// NPL consecutive elements of a staged row at p into f32.
template <int NPL>
__device__ __forceinline__ void ssm_row(const float* p, float (&v)[NPL]) {
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

template <typename T, int L, int NPL>
__global__ void __launch_bounds__(SSM_MAX_THREADS) ssm_scan_kernel(const SsmScan p) {
  extern __shared__ __align__(16) unsigned char ssm_smem[];
  const int TC = p.chunk, DC = p.dc, BCP = p.bcp, YP = ssm_y_pitch(DC, L);
  // Layout: x[2][TC][DC] (T), dt[2][TC][DC] (f32), b[2][TC][BCP] (f32),
  // c[2][TC][BCP] (f32), y[2][TC][YP] (f32); every piece a multiple of 16 B.
  T* const sx = reinterpret_cast<T*>(ssm_smem);
  float* const sdt = reinterpret_cast<float*>(sx + 2 * TC * DC);
  float* const sb = sdt + 2 * TC * DC;
  float* const sc = sb + 2 * TC * BCP;
  float* const sy = sc + 2 * TC * BCP;

  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * DC;
  const int cl = threadIdx.x / L;       // this thread's channel in the CTA
  const int j = threadIdx.x - cl * L;   // its lane in the channel's group
  const int d = d0 + cl;
  const bool live = d < p.d;
  const int n = p.n;
  const int dvalid = min(DC, p.d - d0);

  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + d0;
  const float* dtg = p.dt + bi * p.dt_sb + d0;
  const T* bg = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cg = static_cast<const T*>(p.c) + bi * p.c_sb;

  // B and C rows past N are zero in both buffers for the whole run (the
  // copies below never write there).
  {  // sc follows sb: 4 * TC rows of BCP
    const int pad = BCP - n;
    for (int i = threadIdx.x; i < 4 * TC * pad; i += blockDim.x) {
      const int r = i / pad;
      sb[r * BCP + n + (i - r * pad)] = 0.0f;
    }
  }

  // B and C go by registers where both rows are 16-byte groups and a chunk
  // has at most SSM_BC_REGS of them a thread: loaded before a chunk is
  // computed, stored (as f32) after it, so their latency hides behind it.
  const bool bc_vec = (p.vec & 12) == 12;
  const bool bc_regs =
      bc_vec && 2 * TC * (n / (16 / (int)sizeof(T))) <= SSM_BC_REGS * (int)blockDim.x;
  SsmBcPrefetch<T> bcr;

  // Chunk t0 into buffer buf: x and dt by cp.async (one commit group); B
  // and C into registers (bc_regs, stored by the caller) or straight in.
  auto issue = [&](int t0, int buf, bool direct) {
    const int rows = min(TC, p.s - t0);
    // A last chunk's rows up to the next multiple of L are zero (no copy
    // writes there): dt = 0 and B = 0 leave the state as it is.
    const int pad = ((rows + L - 1) / L) * L - rows;
    for (int i = threadIdx.x; i < pad * (DC + DC + 2 * BCP); i += blockDim.x) {
      const int r = rows + i / (2 * DC + 2 * BCP), e = i % (2 * DC + 2 * BCP);
      if (e < DC)
        sx[(buf * TC + r) * DC + e] = T(0.0f);
      else if (e < 2 * DC)
        sdt[(buf * TC + r) * DC + e - DC] = 0.0f;
      else if (e < 2 * DC + BCP)
        sb[(buf * TC + r) * BCP + e - 2 * DC] = 0.0f;
      else
        sc[(buf * TC + r) * BCP + e - 2 * DC - BCP] = 0.0f;
    }
    ssm_stage<T>(sx + buf * TC * DC, DC, xg + t0 * p.x_ss, p.x_ss, rows, DC, dvalid,
                 p.vec & 1);
    ssm_stage<float>(sdt + buf * TC * DC, DC, dtg + t0 * p.dt_ss, p.dt_ss, rows, DC, dvalid,
                     p.vec & 2);
    asm volatile("cp.async.commit_group;\n" ::);
    if (bc_regs) {
      ssm_bc_load<T>(bcr, bg + t0 * p.b_ss, p.b_ss, cg + t0 * p.c_ss, p.c_ss, rows, n);
      if (direct) ssm_bc_store<T>(bcr, sb + buf * TC * BCP, sc + buf * TC * BCP, BCP, rows, n);
    } else {
      ssm_stage_f32<T>(sb + buf * TC * BCP, BCP, bg + t0 * p.b_ss, p.b_ss, rows, n, bc_vec);
      ssm_stage_f32<T>(sc + buf * TC * BCP, BCP, cg + t0 * p.c_ss, p.c_ss, rows, n, bc_vec);
    }
  };
  issue(0, 0, true);

  // y rows [0, steps) of the chunk at step t0 from staging buffer ybuf:
  // 16 bytes a thread where D allows it.
  auto write_y = [&](int t0, const float* ybuf) {
    const int steps = min(TC, p.s - t0);
    float* yg = p.y + ((long long)bi * p.s + t0) * p.d + d0;
    if ((p.d & 3) == 0) {
      const int q = DC >> 2;
      for (int i = threadIdx.x; i < steps * q; i += blockDim.x) {
        const int r = i / q, g = 4 * (i - r * q);
        if (g < dvalid)
          *reinterpret_cast<float4*>(yg + (long long)r * p.d + g) =
              *reinterpret_cast<const float4*>(ybuf + r * YP + g);
      }
    } else {
      for (int i = threadIdx.x; i < steps * DC; i += blockDim.x) {
        const int r = i / DC, g = i - r * DC;
        if (g < dvalid) yg[(long long)r * p.d + g] = ybuf[r * YP + g];
      }
    }
  };

  // This lane's states and A values, h0 or zero, in order across the group:
  // 16 bytes a load where the group's lanes hold exactly N states and A and
  // h0 start 16-byte aligned (h_last, allocated by the wrapper, does).
  float h[NPL], a[NPL];
  const long long sbase = ((long long)bi * p.d + d) * n + j * NPL;
  const float* arow = p.a + (long long)d * n + j * NPL;
  const bool vec4 = NPL % 4 == 0 && n == L * NPL && (p.vec & 16);
#pragma unroll
  for (int i = 0; i < NPL; ++i) {
    a[i] = 0.0f;
    h[i] = 0.0f;
  }
  if (live && vec4) {
#pragma unroll
    for (int q = 0; q < NPL / 4; ++q) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(arow) + q);
      a[4 * q] = u.x;
      a[4 * q + 1] = u.y;
      a[4 * q + 2] = u.z;
      a[4 * q + 3] = u.w;
      if (p.h0) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(p.h0 + sbase) + q);
        h[4 * q] = v.x;
        h[4 * q + 1] = v.y;
        h[4 * q + 2] = v.z;
        h[4 * q + 3] = v.w;
      }
    }
  } else if (live) {
#pragma unroll
    for (int i = 0; i < NPL; ++i) {
      if (j * NPL + i < n) {
        a[i] = __ldg(arow + i);
        if (p.h0) h[i] = __ldg(p.h0 + sbase + i);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NPL; ++i) a[i] *= 1.4426950408889634f;  // exp(v) = exp2(v * log2(e))
  const float dsk = live ? __ldg(p.d_skip + d) : 0.0f;
  const unsigned full = 0xffffffffu;

  // One barrier a chunk: after it chunk ci has landed and every thread is
  // done with chunk ci - 1, whose input buffer takes chunk ci + 1 and whose
  // y (the other y buffer) goes out while chunk ci is computed.
  const int nchunks = (p.s + TC - 1) / TC;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int buf = ci & 1;
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    const bool next = ci + 1 < nchunks;
    if (next) issue((ci + 1) * TC, buf ^ 1, false);
    if (ci > 0) write_y((ci - 1) * TC, sy + (buf ^ 1) * TC * YP);
    const int steps = min(TC, p.s - ci * TC);
    float* const ys = sy + buf * TC * YP;
    const T* cx = sx + buf * TC * DC + cl;
    const float* cdt = sdt + buf * TC * DC + cl;
    const float* cb = sb + buf * TC * BCP + j * NPL;
    const float* cc = sc + buf * TC * BCP + j * NPL;
    // L steps at a time (the chunk's rows past S are zero: no-op steps).
    // Each lane sums its states' h . C for each of the L steps, then the
    // group reduce-scatters the L partial sums: in round m the lanes
    // exchange half their sums with lane ^ m, so after L - 1 shuffles lane
    // j holds step j's y, and stores it. No shared-memory store inside the
    // group, so the next step's loads need not wait for one.
    for (int t0 = 0; t0 < steps; t0 += L) {
      float part[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int tt = t0 + u;
        const float xv = ssm_f(cx[tt * DC]);
        const float dtv = cdt[tt * DC];
        float bv[NPL], cv[NPL];
        ssm_row<NPL>(cb + tt * BCP, bv);
        ssm_row<NPL>(cc + tt * BCP, cv);
        const float dx = dtv * xv;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
          const float da = exp2f(dtv * a[i]);
          h[i] = da * h[i] + dx * bv[i];
          acc += h[i] * cv[i];
        }
        part[u] = acc;
      }
#pragma unroll
      for (int m = L >> 1; m > 0; m >>= 1) {
        const bool upper = j & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float keep = upper ? part[i + m] : part[i];
          const float send = upper ? part[i] : part[i + m];
          part[i] = keep + __shfl_xor_sync(full, send, m);
        }
      }
      const int tt = t0 + j;
      ys[tt * YP + cl] = part[0] + dsk * ssm_f(cx[tt * DC]);
    }
    if (next && bc_regs)
      ssm_bc_store<T>(bcr, sb + (buf ^ 1) * TC * BCP, sc + (buf ^ 1) * TC * BCP, BCP,
                      min(TC, p.s - (ci + 1) * TC), n);
  }
  __syncthreads();
  write_y((nchunks - 1) * TC, sy + ((nchunks - 1) & 1) * TC * YP);
  if (live && vec4) {
#pragma unroll
    for (int q = 0; q < NPL / 4; ++q)
      reinterpret_cast<float4*>(p.h_last + sbase)[q] =
          make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
  } else if (live) {
#pragma unroll
    for (int i = 0; i < NPL; ++i)
      if (j * NPL + i < n) p.h_last[sbase + i] = h[i];
  }
}

typedef void (*SsmKernel)(const SsmScan);

// The (lanes, states a lane) kernels compiled (scan.py KERNEL_TILES):
// what scan_plan picks for any N up to 512.
#define SSM_TILES(T)                                                                  \
  X(T, 1, 1) X(T, 2, 1) X(T, 2, 2) X(T, 2, 8) X(T, 4, 1) X(T, 4, 2) X(T, 4, 4)        \
  X(T, 4, 8) X(T, 4, 16) X(T, 4, 32) X(T, 8, 2) X(T, 8, 32) X(T, 16, 1) X(T, 16, 32)

template <typename T>
static SsmKernel ssm_kernel_tile(int lanes, int npl) {
#define X(T_, L_, NPL_) \
  if (lanes == L_ && npl == NPL_) return ssm_scan_kernel<T_, L_, NPL_>;
  SSM_TILES(T)
#undef X
  return nullptr;
}

static SsmKernel ssm_kernel_for(int bf16, int lanes, int npl) {
  return bf16 ? ssm_kernel_tile<__nv_bfloat16>(lanes, npl) : ssm_kernel_tile<float>(lanes, npl);
}

extern "C" int ssm_desc_bytes() { return (int)sizeof(SsmScan); }

extern "C" int ssm_max_npl() { return SSM_MAX_NPL; }

extern "C" int ssm_scan_launch(const SsmScan* desc, void* stream) {
  const SsmScan& p = *desc;
  const int L = p.lanes;
  if (L < 1 || L > SSM_MAX_LANES || (L & (L - 1)) || p.dc % 8 || p.chunk % L)
    return (int)cudaErrorInvalidValue;
  const int npl = (p.n + L - 1) / L;
  int pw = 1;
  while (pw < npl) pw <<= 1;
  const int threads = p.dc * L;
  if (threads > SSM_MAX_THREADS || threads % 32) return (int)cudaErrorInvalidValue;
  SsmKernel kernel = ssm_kernel_for(p.bf16, L, pw);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int smem = ssm_smem_bytes(p.chunk, p.dc, p.bcp, p.bf16 ? 2 : 4, L);
  if (smem > 48 * 1024) {
    const int err = (int)cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err) return err;
  }
  dim3 grid((p.d + p.dc - 1) / p.dc, p.bz);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
