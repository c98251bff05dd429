// Hand-written Hopper (sm_90a) kernels for the gradient of one fp32 /
// fake-quant stream-conv fusion group (or single layer).
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/stream_conv/conv.py
// stream_conv_pyramid_bwd_cuda). Every entry point launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError() so
// the wrapper can raise on a refused launch.
//
//   Replaces: no Pallas kernel. The JAX package differentiates its
//             stream-conv composition with XLA's autodiff
//             (src/repro/kernels/stream_conv/ref.py, through
//             repro/paper/train_cnn.py _loss_fn); the port's plain version
//             of the same thing is autograd of ref.py's composition
//             (kernels/stream_conv/ops.py _GroupGrad, on the CPU).
//   Computes: for a group of conv -> bias -> act -> max-pool -> stream
//             fake-quant layers, given the group input x, the weights and
//             biases and the gradient g of the group output: dW and db of
//             every layer, and dx where the group input needs one. The
//             semantics are the composition's autodiff: a pool window's
//             gradient goes to its first maximal element, relu is
//             max(y, 0) (half the gradient at y == 0), tanh's derivative
//             is 1 - t^2, and the fake-quant is a straight-through
//             estimator masked to lo <= v <= hi.
//   Bound on this card: operations. cifar10 at B = 128 is about 8.8 GFLOP
//             of fp32 FMA (the forward recomputed, dW of three layers, dX
//             of two) against 67 TFLOP/s, 0.13 ms, while its bytes
//             (frames, features, gates, partial sums) are a few tens of MB,
//             about 0.01 ms at 3.35 TB/s.
//   Design:   four kernels, each over the whole batch, none of them
//             materialising a patch matrix or a pre-pool gradient:
//   - scb_conv_kernel<FWD> recomputes one layer's forward from its input
//     (the group input, or the previous layer's recomputed output), one CTA
//     per (block of pooled rows, image). The conv is the forward kernels'
//     implicit GEMM (one fp32 FMA chain per output in (ki, kj, c) order,
//     the same zero-weight tail), so every sum, and with tanhf, rintf and
//     the clip every output, gate and mask, is the forward's own bit for
//     bit. The pre-pool sums (plus bias) stay in shared memory; a pool pass
//     then writes, at the pooled size, the output (the next layer's input),
//     the index of each window's first maximal element after the act, and
//     the gate: the act's derivative there times the fake-quant mask.
//   - scb_conv_kernel<DX> computes dx as the transposed conv in gather
//     form: each input pixel reads its K x K neighbours' conv-output
//     gradients times the flipped weights. The CTA stages those gradients
//     (dz) in shared memory, built as they load from g, the gate and the
//     winner index (a conv position's dz is the sum, over the windows that
//     chose it, of g times the gate), dilated by the conv stride and placed
//     with the forward's pad rule, so the GEMM is a stride-1 VALID conv.
//   - scb_dw_kernel computes partial sums of dW (and db, as one more K row
//     read from a channel of ones in the staged frame) over a fixed,
//     contiguous share of the (image, row block) units: K rows x N outputs
//     per thread tile, reduced over the conv positions in registers. No
//     float atomics.
//   - scb_reduce_kernel sums the partials of every layer in a fixed order
//     (eight running sums over the shares, then a fixed tree).
//   So eager calls and graph replays are bit for bit equal, call after
//   call. IEEE fp32 FMA on the CUDA cores throughout: no TF32 and no
//   --use_fast_math. Tiles come from the layer's shape on the host
//   (conv.py bwd_plan).
// ---------------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

#define SCB_MAX_LAYERS 4

enum { SCB_FWD = 0, SCB_DX = 1 };

// One layer's frame geometry and epilogue.
struct ScbLayer {
  int batch, hi, wi, c;   // unpadded input frame
  int pt, pl, k, s;       // SAME pads (top, left), kernel, conv stride
  int hc, wc;             // conv rows and columns the pool windows read
  int pw, ps;             // pool window and stride (1, 1 without a pool)
  int hq, wq, n;          // pooled output rows, columns, channels
  int act, qbits;         // act: 0 none, 1 relu, 2 tanh; qbits 0: no quant
  float qscale, qmin, qmax, qlo, qhi;  // grid step, code range, mask bounds
};

// scb_conv_kernel: FWD recomputes a layer (out, gate, idx); DX writes dx.
struct ScbConv {
  ScbLayer L;
  const float* x;        // FWD: (B, hi, wi, c)
  const float* w;        // (k, k, c, n) HWIO
  const float* b;        // (n,)
  const float* g;        // DX: (B, hq, wq, n), the layer output's gradient
  const float* gate;     // DX: (B, hq, wq, n)
  const uint8_t* idx;    // DX: (B, hq, wq, n)
  float* out;            // FWD: (B, hq, wq, n) or null; DX: dx (B, hi, wi, c)
  float* gate_out;       // FWD: (B, hq, wq, n)
  uint8_t* idx_out;      // FWD: (B, hq, wq, n)
  int rows, n_rb;        // FWD: pooled rows a block; DX: input rows a block
  int cs, rs;            // slab column and row strides (floats)
  int np;                // staged weight row stride (outputs rounded to tn)
  int ys;                // FWD: floats per conv position of the sums' tile
  int tap_off, wst_off, y_off;  // shared-memory float offsets
  int threads, wpt, tn;  // CTA size; positions and channels a thread
  int kc;                // weight rows a stage: 64, or all of them (staged once)
};

// scb_dw_kernel: partial sums of (dW; db) over a share of the units.
struct ScbGrad {
  ScbLayer L;
  const float* x;        // (B, hi, wi, c), the layer's input
  const float* g;        // (B, hq, wq, n)
  const float* gate;
  const uint8_t* idx;
  float* part;           // (parts, k*k*c + 1, n)
  int rows, n_rb;        // conv rows a unit, row blocks an image
  int units, parts;      // units = batch * n_rb, split into parts shares
  int cs, rs;            // x slab strides (cs > c: channel c holds ones)
  int np;                // floats per position of the dz slab (n rounded)
  int dz_off;            // shared-memory float offset of the dz slab
  int kth, ng;           // K threads, channel groups of tn
  int threads, tk, tn;   // CTA size; K rows and channels a thread
};

struct ScbReduce {
  const float* part[SCB_MAX_LAYERS];
  float* dw[SCB_MAX_LAYERS];
  float* db[SCB_MAX_LAYERS];
  int kk1[SCB_MAX_LAYERS], n[SCB_MAX_LAYERS], parts[SCB_MAX_LAYERS];
  int layers;
};

__device__ __forceinline__ float scb_act(float y, int act) {
  if (act == 1) return fmaxf(y, 0.0f);
  if (act == 2) return tanhf(y);
  return y;
}

// d act / dy at y (t = act(y)), as autograd of the composition: relu as
// max(y, 0) gives an exact zero half the gradient.
__device__ __forceinline__ float scb_dact(float y, float t, int act) {
  if (act == 1) return y > 0.0f ? 1.0f : (y == 0.0f ? 0.5f : 0.0f);
  if (act == 2) return 1.0f - t * t;
  return 1.0f;
}

// The forward kernels' sc_quant: clip(round_half_even(y / scale)) * scale.
__device__ __forceinline__ float scb_quant(const ScbLayer& L, float y) {
  if (L.qbits == 0) return y;
  float q = rintf(y / L.qscale);
  q = fminf(fmaxf(q, L.qmin), L.qmax);
  return q * L.qscale;
}

// dz at conv position (oy, ox), channel n: the sum over the pool windows
// that hold it, in window order, of g times the gate where the window's
// winner is this position.
__device__ __forceinline__ float scb_dz(const ScbLayer& L, const float* __restrict__ g,
                                        const float* __restrict__ gate,
                                        const uint8_t* __restrict__ idx, int b, int oy,
                                        int ox, int n) {
  if (oy < 0 || ox < 0 || oy >= L.hc || ox >= L.wc) return 0.0f;
  const int qy0 = oy < L.pw ? 0 : (oy - L.pw) / L.ps + 1;
  const int qy1 = min(L.hq - 1, oy / L.ps);
  const int qx0 = ox < L.pw ? 0 : (ox - L.pw) / L.ps + 1;
  const int qx1 = min(L.wq - 1, ox / L.ps);
  float acc = 0.0f;
  for (int qy = qy0; qy <= qy1; ++qy) {
    for (int qx = qx0; qx <= qx1; ++qx) {
      const size_t e = (((size_t)b * L.hq + qy) * L.wq + qx) * L.n + n;
      const int win = idx[e];  // the three loads issued together
      const float gv = __ldg(g + e), gt = __ldg(gate + e);
      if (win == (oy - qy * L.ps) * L.pw + (ox - qx * L.ps)) acc += gv * gt;
    }
  }
  return acc;
}

// ---------------------------------------------------------------------------
// scb_conv_kernel: one implicit GEMM over a slab in shared memory.
//   FWD: M = the block's conv positions, N = n, K = k*k*c in (ki, kj, c)
//        order, the slab the block's input rows (zeros in the pads).
//   DX:  M = the block's input pixels, N = c, K = k*k*n in (ki', kj', n)
//        order over the flipped kernel, the slab the dilated dz rows.
// A warp task is 16 x WPT positions x 2 channel groups of TN (the forward
// kernels' sc_gemm at pool window 1); the weights stage 64 rows at a time
// (SC_KC's stages, restaged every round of tasks), or all rows once where
// they fit (conv.py _bwd_conv_launch picks).

template <int MODE, int WPT, int TN>
__global__ void __launch_bounds__(512) scb_conv_kernel(const ScbConv P) {
  extern __shared__ __align__(16) float sm[];
  const ScbLayer& L = P.L;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int rb = blockIdx.x, b = blockIdx.y;
  const int k = L.k;

  int m_rows, m_cols, step, s_rows, s_cols, kin, nout, r0, c0, q0 = 0, q1 = 0;
  if (MODE == SCB_FWD) {
    q0 = rb * P.rows;
    q1 = min(L.hq, q0 + P.rows);
    m_rows = (q1 - q0 - 1) * L.ps + L.pw;
    m_cols = L.wc;
    step = L.s;
    s_rows = (m_rows - 1) * L.s + k;
    s_cols = (m_cols - 1) * L.s + k;
    kin = L.c;
    nout = L.n;
    r0 = q0 * L.ps * L.s - L.pt;  // unpadded input row of slab row 0
    c0 = -L.pl;
  } else {
    const int i0 = rb * P.rows;
    m_rows = min(L.hi, i0 + P.rows) - i0;
    m_cols = L.wi;
    step = 1;
    s_rows = m_rows + k - 1;
    s_cols = L.wi + k - 1;
    kin = L.n;
    nout = L.c;
    r0 = i0 + L.pt - (k - 1);  // padded-frame row of slab row 0
    c0 = L.pl - (k - 1);
  }
  const int kdim = k * k * kin;
  float* slab = sm;
  int* taps = reinterpret_cast<int*>(sm + P.tap_off);
  float* wst = sm + P.wst_off;

  // The slab: FWD the input rows (zeros outside the frame), DX dz dilated
  // by the stride (zeros between and outside).
  const int s_elems = s_rows * s_cols * kin;
  for (int i = tid; i < s_elems; i += nthr) {
    const int ch = i % kin;
    const int rest = i / kin;
    const int col = rest % s_cols;
    const int r = rest / s_cols;
    float v = 0.0f;
    if (MODE == SCB_FWD) {
      const int yy = r0 + r, xx = c0 + col;
      if (yy >= 0 && yy < L.hi && xx >= 0 && xx < L.wi)
        v = __ldg(P.x + (((size_t)b * L.hi + yy) * L.wi + xx) * L.c + ch);
    } else {
      const int py = r0 + r, px = c0 + col;
      if (py >= 0 && px >= 0 && py % L.s == 0 && px % L.s == 0)
        v = scb_dz(L, P.g, P.gate, P.idx, b, py / L.s, px / L.s, ch);
    }
    slab[r * P.rs + col * P.cs + ch] = v;
  }
  const int k4 = (kdim + 3) & ~3;
  for (int i = tid; i < k4; i += nthr) {
    int off = 0;
    if (i < kdim) {
      const int ki = i / (k * kin);
      const int rem = i - ki * k * kin;
      const int kj = rem / kin;
      off = ki * P.rs + kj * P.cs + (rem - kj * kin);
    }
    taps[i] = off;
  }

  const int lane = tid & 31, warp = tid >> 5, n_warps = nthr >> 5;
  const int M = m_rows * m_cols;
  const int groups = (nout + TN - 1) / TN;
  const int gpairs = (groups + 1) >> 1;
  const int tasks = ((M + 16 * WPT - 1) / (16 * WPT)) * gpairs;
  const int rounds = (tasks + n_warps - 1) / n_warps;
  const int nchunks = (kdim + P.kc - 1) / P.kc;
  float* ytile = sm + P.y_off;

  for (int rd = 0; rd < rounds; ++rd) {
    const int task = rd * n_warps + warp;
    const bool live = task < tasks;
    const int t = live ? task : 0;
    const int wb = t / gpairs;
    const int gi = (t - wb * gpairs) * 2 + (lane >> 4);
    const int n0 = min(gi, groups - 1) * TN;  // clamped: reads stay in the stage
    int pos[WPT], pbase[WPT];
#pragma unroll
    for (int w = 0; w < WPT; ++w) {
      pos[w] = wb * 16 * WPT + (lane & 15) + 16 * w;
      const int pv = pos[w] < M ? pos[w] : 0;
      const int r = pv / m_cols;
      pbase[w] = r * step * P.rs + (pv - r * m_cols) * step * P.cs;
    }
    float acc[WPT][TN];
#pragma unroll
    for (int w = 0; w < WPT; ++w)
#pragma unroll
      for (int q = 0; q < TN; ++q) acc[w][q] = 0.0f;

    for (int ch = 0; ch < nchunks; ++ch) {
      const int kb = ch * P.kc;
      const int kc = min(P.kc, kdim - kb);
      const int kc4 = (kc + 3) & ~3;
      // Weights held whole (one stage) are staged in the first round only.
      if (rd == 0 || nchunks > 1) {
      __syncthreads();  // the slab and taps are written; the stage is free
          for (int i = tid; i < kc4 * P.np; i += nthr) {
        // FWD reads rows of w, DX columns of w's (c, n) blocks: consecutive
        // threads take consecutive global words either way.
        int r, q;
        if (MODE == SCB_FWD) {
          r = i / P.np;
          q = i - r * P.np;
        } else {
          q = i / kc4;
          r = i - q * kc4;
        }
        float v = 0.0f;
        if (r < kc && q < nout) {
          const int kk = kb + r;
          if (MODE == SCB_FWD) {
            v = __ldg(P.w + (size_t)kk * L.n + q);
          } else {  // row (ki', kj', n), column c of the flipped kernel
            const int tap = kk / L.n, n = kk - tap * L.n;
            const int ki = tap / k, kj = tap - ki * k;
            v = __ldg(P.w + ((size_t)((k - 1 - ki) * k + (k - 1 - kj)) * L.c + q) * L.n + n);
          }
        }
        wst[r * P.np + q] = v;
      }
      __syncthreads();
      }
      const float* ws = wst + n0;
      const int* tp = taps + kb;
#pragma unroll 2
      for (int kk = 0; kk < kc4; kk += 4) {
        const int4 o4 = *reinterpret_cast<const int4*>(tp + kk);
        const int offs[4] = {o4.x, o4.y, o4.z, o4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float a[WPT];
#pragma unroll
          for (int w = 0; w < WPT; ++w) a[w] = slab[pbase[w] + offs[u]];
          float bv[TN];
          const float4* wp = reinterpret_cast<const float4*>(ws + (kk + u) * P.np);
#pragma unroll
          for (int q = 0; q < TN / 4; ++q) {
            const float4 v = wp[q];
            bv[4 * q] = v.x;
            bv[4 * q + 1] = v.y;
            bv[4 * q + 2] = v.z;
            bv[4 * q + 3] = v.w;
          }
#pragma unroll
          for (int w = 0; w < WPT; ++w)
#pragma unroll
            for (int q = 0; q < TN; ++q) acc[w][q] = fmaf(a[w], bv[q], acc[w][q]);
        }
      }
    }
    if (!live || gi >= groups) continue;
#pragma unroll
    for (int w = 0; w < WPT; ++w) {
      if (pos[w] >= M) continue;
#pragma unroll
      for (int q = 0; q < TN; ++q) {
        const int n = n0 + q;
        if (n >= nout) break;
        if (MODE == SCB_FWD) {
          ytile[pos[w] * P.ys + n] = acc[w][q] + __ldg(P.b + n);
        } else {
          const int r = pos[w] / m_cols;
          const int col = pos[w] - r * m_cols;
          P.out[(((size_t)b * L.hi + rb * P.rows + r) * L.wi + col) * L.c + n] = acc[w][q];
        }
      }
    }
  }
  if (MODE != SCB_FWD) return;

  // The pool pass: per pooled output, the first maximal element after the
  // act (the window in row-major order), its output, gate and index.
  __syncthreads();
  const int nq = (q1 - q0) * L.wq * L.n;
  for (int i = tid; i < nq; i += nthr) {
    const int n = i % L.n;
    const int rest = i / L.n;
    const int qc = rest % L.wq;
    const int qr = rest / L.wq;
    float best = 0.0f, by = 0.0f;
    int bi = 0;
    for (int pi = 0; pi < L.pw; ++pi) {
      for (int pj = 0; pj < L.pw; ++pj) {
        const float y = ytile[((qr * L.ps + pi) * m_cols + qc * L.ps + pj) * P.ys + n];
        const float t = scb_act(y, L.act);
        if ((pi | pj) == 0 || t > best) {
          best = t;
          by = y;
          bi = pi * L.pw + pj;
        }
      }
    }
    const size_t e = (((size_t)b * L.hq + q0 + qr) * L.wq + qc) * L.n + n;
    const bool inside = L.qbits == 0 || (best >= L.qlo && best <= L.qhi);
    if (P.out) P.out[e] = scb_quant(L, best);
    P.gate_out[e] = inside ? scb_dact(by, best, L.act) : 0.0f;
    P.idx_out[e] = (uint8_t)bi;
  }
}

// ---------------------------------------------------------------------------
// scb_dw_kernel: CTA (K tile, share). Thread (tk, tn) holds K rows
// kt*KTH*TK + tk + i*KTH (i < TK) and channels tn*TN + j; per conv position
// it reads TK slab words through its own taps (held in registers) and TN
// dz values, for TK x TN FMAs. Row k*k*c is db: its tap reads channel c of
// the position's first pixel, which the staging fills with ones.

template <int TK, int TN>
__global__ void __launch_bounds__(256) scb_dw_kernel(const ScbGrad P) {
  extern __shared__ __align__(16) float sm[];
  const ScbLayer& L = P.L;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int kt = blockIdx.x, part = blockIdx.y;
  const int k = L.k, c = L.c, s = L.s;
  const int kk1 = k * k * c + 1;
  const int tn = tid % P.ng, tk = tid / P.ng;
  const bool active = tk < P.kth;
  float* xs = sm;
  float* dzs = sm + P.dz_off;

  int tap[TK];
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int kk = kt * P.kth * TK + tk + i * P.kth;
    int off = 0;
    if (active && kk < kk1 - 1) {
      const int ki = kk / (k * c);
      const int rem = kk - ki * k * c;
      const int kj = rem / c;
      off = ki * P.rs + kj * P.cs + (rem - kj * c);
    } else if (active && kk == kk1 - 1) {
      off = c;
    }
    tap[i] = off;
  }
  float acc[TK][TN];
#pragma unroll
  for (int i = 0; i < TK; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  const int u0 = (int)(((long long)part * P.units) / P.parts);
  const int u1 = (int)(((long long)(part + 1) * P.units) / P.parts);
  const int scols = (L.wc - 1) * s + k;
  for (int u = u0; u < u1; ++u) {
    const int b = u / P.n_rb, rb = u - b * P.n_rb;
    const int o0 = rb * P.rows;
    const int nr = min(L.hc, o0 + P.rows) - o0;
    const int srows = (nr - 1) * s + k;
    __syncthreads();  // the previous unit's slabs are read
    const int xe = srows * scols * (c + 1);
      for (int i = tid; i < xe; i += nthr) {
      const int ch = i % (c + 1);
      const int rest = i / (c + 1);
      const int col = rest % scols;
      const int r = rest / scols;
      float v = 1.0f;
      if (ch < c) {
        const int yy = o0 * s + r - L.pt, xx = col - L.pl;
        v = (yy >= 0 && yy < L.hi && xx >= 0 && xx < L.wi)
                ? __ldg(P.x + (((size_t)b * L.hi + yy) * L.wi + xx) * c + ch)
                : 0.0f;
      }
      xs[r * P.rs + col * P.cs + ch] = v;
    }
    const int de = nr * L.wc * P.np;
      for (int i = tid; i < de; i += nthr) {
      const int n = i % P.np;
      const int pos = i / P.np;
      const int col = pos % L.wc;
      const int r = pos / L.wc;
      dzs[i] = n < L.n ? scb_dz(L, P.g, P.gate, P.idx, b, o0 + r, col, n) : 0.0f;
    }
    __syncthreads();
    for (int r = 0; r < nr; ++r) {
      for (int col = 0; col < L.wc; ++col) {
        const int pb = r * s * P.rs + col * s * P.cs;
        const float4* dp =
            reinterpret_cast<const float4*>(dzs + (r * L.wc + col) * P.np + tn * TN);
        float bv[TN];
#pragma unroll
        for (int q = 0; q < TN / 4; ++q) {
          const float4 v = dp[q];
          bv[4 * q] = v.x;
          bv[4 * q + 1] = v.y;
          bv[4 * q + 2] = v.z;
          bv[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int i = 0; i < TK; ++i) {
          const float a = xs[pb + tap[i]];
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < TK; ++i) {
    const int kk = kt * P.kth * TK + tk + i * P.kth;
    if (kk >= kk1) break;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = tn * TN + j;
      if (n < L.n) P.part[((size_t)part * kk1 + kk) * L.n + n] = acc[i][j];
    }
  }
}

// dW[kk][n] (kk < k*k*c) and db[n] (kk = k*k*c) of every layer: the sum
// of its partials, share 0 first.
__global__ void scb_reduce_kernel(const ScbReduce R) {
  const int l = blockIdx.y;
  const int total = R.kk1[l] * R.n[l];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  // Eight running sums, share q into sum q % 8 in share order, added in
  // a fixed tree: the loads of eight shares are in flight together.
  const float* p = R.part[l] + i;
  const int parts = R.parts[l];
  float a[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  int q = 0;
  for (; q + 8 <= parts; q += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) a[j] += __ldg(p + (size_t)(q + j) * total);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (q + j < parts) a[j] += __ldg(p + (size_t)(q + j) * total);
  const float acc = ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
  const int kk = i / R.n[l];
  if (kk < R.kk1[l] - 1) R.dw[l][i] = acc;
  else R.db[l][i - kk * R.n[l]] = acc;
}

// ---------------------------------------------------------------------------

static int scb_opt_in_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   smem_bytes);
}

template <int MODE>
static const void* scb_conv_pick(int wpt, int tn) {
  if (tn == 8) {
    if (wpt == 4) return (const void*)scb_conv_kernel<MODE, 4, 8>;
    if (wpt == 2) return (const void*)scb_conv_kernel<MODE, 2, 8>;
    if (wpt == 1) return (const void*)scb_conv_kernel<MODE, 1, 8>;
  } else if (tn == 4) {
    if (wpt == 4) return (const void*)scb_conv_kernel<MODE, 4, 4>;
    if (wpt == 2) return (const void*)scb_conv_kernel<MODE, 2, 4>;
    if (wpt == 1) return (const void*)scb_conv_kernel<MODE, 1, 4>;
  }
  return nullptr;
}

static const void* scb_dw_pick(int tk, int tn) {
#define SCB_DW(TK)                                                   \
  if (tk == TK) return tn == 8 ? (const void*)scb_dw_kernel<TK, 8> \
                               : (tn == 4 ? (const void*)scb_dw_kernel<TK, 4> : nullptr);
  SCB_DW(1) SCB_DW(2) SCB_DW(3) SCB_DW(4) SCB_DW(5) SCB_DW(6) SCB_DW(7) SCB_DW(8)
#undef SCB_DW
  return nullptr;
}

static int scb_launch(const void* kernel, dim3 grid, int threads, int smem_bytes,
                      void* arg, void* stream) {
  if (!kernel) return (int)cudaErrorInvalidValue;
  int err = scb_opt_in_smem(kernel, smem_bytes);
  if (err) return err;
  void* args[1] = {arg};
  err = (int)cudaLaunchKernel(kernel, grid, dim3(threads), args, (size_t)smem_bytes,
                              (cudaStream_t)stream);
  if (err) return err;
  return (int)cudaGetLastError();
}

extern "C" int scb_conv_desc_bytes() { return (int)sizeof(ScbConv); }
extern "C" int scb_grad_desc_bytes() { return (int)sizeof(ScbGrad); }
extern "C" int scb_reduce_desc_bytes() { return (int)sizeof(ScbReduce); }

// mode 0: recompute (FWD), 1: dx (DX).
extern "C" int scb_conv_launch(int mode, const ScbConv* desc, int smem_bytes, void* stream) {
  const void* kernel = mode == SCB_FWD ? scb_conv_pick<SCB_FWD>(desc->wpt, desc->tn)
                                       : scb_conv_pick<SCB_DX>(desc->wpt, desc->tn);
  ScbConv d = *desc;
  return scb_launch(kernel, dim3(desc->n_rb, desc->L.batch), desc->threads, smem_bytes, &d,
                    stream);
}

extern "C" int scb_dw_launch(const ScbGrad* desc, int ktiles, int smem_bytes, void* stream) {
  ScbGrad d = *desc;
  return scb_launch(scb_dw_pick(desc->tk, desc->tn), dim3(ktiles, desc->parts), desc->threads,
                    smem_bytes, &d, stream);
}

extern "C" int scb_reduce_launch(const ScbReduce* desc, int max_total, void* stream) {
  ScbReduce d = *desc;
  const int threads = 256;
  return scb_launch((const void*)scb_reduce_kernel,
                    dim3((max_total + threads - 1) / threads, desc->layers), threads, 0, &d,
                    stream);
}
