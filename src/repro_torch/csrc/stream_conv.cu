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
//             3.35 TB/s.
//   Design:   both kernels run one core, sc_gemm_i8, an implicit GEMM on
//             the s8 tensor cores (mma.sync m16n8k32, int32 accumulators),
//             the same CTA per (row block, image) and slab walk as the fp32
//             kernels (the pyramid computes only the rows the next layer
//             reads). What it does about the bound:
//   - A operand: the int8 slab in shared memory, never materialised as
//     patches. Where the channels are a multiple of 16, ldmatrix.x4 reads
//     each lane's row (its conv position's base plus the tap of a 16-byte
//     K run); otherwise (3 and 1 channel frames, lenet5's 20) C is padded
//     to 4 with zero-weight channels and each A register is one 32-bit word
//     through the tap table. K is k*k*cpad, rounded up to 32 with zero
//     weights.
//   - Bank conflicts: a slab column is C bytes rounded up to 16, or 16
//     more where that puts the eight rows of an ldmatrix phase on eight
//     bank groups (48 bytes for C = 32); the columns of a stride-2 slab
//     are stored in two phases (even, odd), so neighbouring conv
//     positions sit one column apart; the row pad is the host's choice
//     (conv.py int8_layer counts the wavefronts).
//   - M order: a warp task is 16 pool windows x PW*PW tiles, tile p
//     holding pool position p of the same 16 windows (at pool window 2
//     rows 4-7 and 12-15 take the window's other column, which keeps the
//     phases conflict-free), so a thread's accumulators hold every
//     position of its windows and the max-pool is an integer max over
//     registers; without a pool, 4 tiles of 16 consecutive positions.
//     Pool windows other than 1, 2 and 3 run one tile per position,
//     folded into a running max.
//   - B operand: each layer's weights staged whole in shared memory,
//     transposed at staging from HWIO to one row of K bytes per output
//     channel (a thread reads four K rows of 16 channels with 16-byte loads
//     and writes 16 words of four K, byte permutes in registers), N padded
//     to whole n8 tiles with zero rows, 16-byte chunks swizzled within each
//     128-byte group so that ldmatrix's rows and the staging's stores fall
//     on distinct banks. With no barrier in the K loop, the warps take
//     their tasks round-robin.
//   - Epilogue in registers, in the reference orders: pyramid int max ->
//     dequantize, bias -> act -> code; single layer dequantize, bias ->
//     act per position -> max -> quantize (the division by the stream's
//     power-of-two scale as an exact multiply, one output address per
//     window). The int32 sums do not depend on order, so the outputs are
//     bit for bit those of the plain versions.
//   - Frames and weights are read 32 bits at a time only where the pointer
//     and the row stride are 4-byte aligned, byte by byte otherwise.
//
// sc_fused_i8_kernel<true>, the wgmma path (sc_fused_i8_wgmma)
//   Replaces: for the layers conv.py fused_path sends to it (C a multiple
//             of 64, N >= 64, conv stride 1, no pool or 2x2/2), the
//             mma.sync path of the same kernel above, which the TPU's
//             single-layer kernel (conv.py:168 stream_conv_fused_pallas,
//             int8) was first ported to. That path stages a layer's weights
//             whole per CTA: at C = 512 a channel slice of 32 (147 KB), 16
//             launches a layer, each CTA of 56 conv positions re-reading the
//             slab the 15 other slices read, its staging 71 % of the CTA's
//             cycles at VGG-16's layer 8 (chip_phases.py), with no overlap
//             of loads and MMAs.
//   Bound on this card: operations at VGG-16's layers 3 and 5-12 (at B=256
//             layer 8 is 0.947 Top, 0.48 ms at 1,979 TOP/s, against 0.53 GB,
//             0.16 ms); bytes at layers 2 and 4, whose float32 outputs
//             (1.6 GB at layer 2) outweigh their products. Over layers 2-12,
//             6.87 Top, 3.82 ms at the larger of the two a layer.
//   Design:   one implicit GEMM, M = a block's conv positions (at most 256:
//             whole output rows, or a column strip of one where a row's
//             slab would leave no room for the ring; conv.py
//             wgmma_geometry), N = all of the layer's output channels,
//             K = 9 C in (ki, kj, c) order, on the s8 wgmma (m64n128k32,
//             int32 accumulators), A from registers and B from shared memory.
//   - Weights in K steps, never whole: the plan lays each layer's codes out
//     once (conv.py kmajor_weights) as the kernel streams them, N tile (128
//     channels) by N tile, K step (64 bytes, one tap's run of channels) by
//     K step, each an 8 KB stage in wgmma's K-major core matrices, so a
//     stage is one bulk copy (TMA without a tensor map) into a ring of 4-8
//     stages with full/empty mbarriers, which one thread of the producer
//     warpgroup keeps in flight, nothing transposed per block.
//   - The slab stays: a block loads its rows' slab once (cp.async, code 0
//     below the frame; columns C + 16 bytes apart, rows padded so that the
//     A loads' phases fall on distinct bank groups) and walks every N tile
//     from it, one launch a layer; a persistent grid (one CTA an SM, 228 KB
//     at most) walks (image, row block) items, so the producer fills the
//     ring for the next tile or item during an epilogue.
//   - Two consumer warpgroups, two m64 tiles each: the A fragments by
//     ldmatrix from the slab at the K step's tap offset (as the mma.sync
//     path's), loaded for the next step while this step's wgmmas run, one
//     wgmma group in flight. The producer warpgroup gives its registers to
//     the consumers (setmaxnreg 40 / 232) for the 128 accumulators a thread.
//   - M order: without a pool, position 128 wg + 64 t + 16 warp + row; with
//     the 2x2 pool, window 32 wg + 8 warp + row % 8 at pool position (tile,
//     row / 8), its column flipped for rows 4-7 where that spreads the
//     phases, so a thread's accumulators hold all four positions of its
//     window and the pool is a max over registers.
//   - Epilogue in registers in the single layer's order (dequantize, bias,
//     act per position, max, quantize), the four lanes of a quad storing 32
//     contiguous bytes of a position's channels. The int32 sums do not
//     depend on order: the outputs are bit for bit the plain version's.
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
  // whether the weights may be copied 16 bytes at a time. int8 kernels
  // (conv.py int8_layer): slab column and row strides in bytes, n8 tiles
  // per warp task (tn) and staged weight rows (np), and below the slab's
  // columns per stride phase, the channels gathered per column, K padded
  // to the MMA's 32, the staged weight row in bytes and the pool-position
  // swizzle.
  int cs, rs, tn, np, wvec;
  int q, cpad, kpad, wrow, swz;
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
  int cs, rs, tn, np, wvec, tap_off, wst_off, wst_elems;  // as ScLayer; offsets:
  // fp32 words, int8 bytes
  int threads;  // threads per CTA (a multiple of 32, at most 256)
  int q, cpad, kpad, wrow, swz;  // int8 kernel, as ScLayer
  // int8 kernel: 1 on the wgmma path, whose ring has `stages` stages at
  // byte wst_off, its N tiles in tn, and whose persistent grid is `grid`
  // CTAs.
  int wg, stages, grid;
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

// Rows of each layer's output that row block rb computes, [olo, ohi) in
// out-slab coordinates, and the input rows they read, [ilo, ihi) in
// in-slab coordinates, last layer first: a layer computes the rows of the
// next layer's frame that the next layer reads (conv.py pyramid_rows is
// the same walk on the host).
__device__ __forceinline__ void sc_pyramid_rows(const ScPyramid& P, int rb,
                                                int (&olo)[SC_MAX_LAYERS],
                                                int (&ohi)[SC_MAX_LAYERS],
                                                int (&ilo)[SC_MAX_LAYERS],
                                                int (&ihi)[SC_MAX_LAYERS]) {
#pragma unroll 1
  for (int li = P.n_layers - 1; li >= 0; --li) {
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

__global__ void __launch_bounds__(SC_THREADS, 2)
    sc_pyramid_kernel(const ScPyramid P) {
  extern __shared__ __align__(16) float smem[];
  float* const buf0 = smem;
  float* const buf1 = smem + P.buf0_elems;
  int* const taps = reinterpret_cast<int*>(smem + P.tap_off);
  float* const wst = smem + P.wst_off;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;

  int olo[SC_MAX_LAYERS], ohi[SC_MAX_LAYERS], ilo[SC_MAX_LAYERS], ihi[SC_MAX_LAYERS];
  sc_pyramid_rows(P, rb, olo, ohi, ilo, ihi);

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
// The s8 tensor-core implicit GEMM of the int8 kernels (sc_gemm_i8). Every
// layout decision below is mirrored on the host by conv.py (int8_layer,
// int8_taps, int8_row_base, int8_w_offset), which the CPU tests check.

typedef signed char i8;

__device__ __forceinline__ unsigned sc_smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void sc_ldm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void sc_ldm_x2(unsigned (&r)[2], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16 x 32, row-major) * b (32 x 8, column-major): int8 products
// summed exactly in int32.
__device__ __forceinline__ void sc_mma_s8(int (&d)[4], const unsigned (&a)[4],
                                          const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Slab column of input column x: a slab's columns are stored in s phases
// of q columns (x % s, then x / s), so the conv positions of one row, s
// input columns apart, sit one column apart in the slab.
__device__ __forceinline__ int sc_phase_col(int x, int s, int q) {
  return s == 1 ? x : (x % s) * q + x / s;
}

// The 16-byte chunk of staged weight row n that holds K chunk c: swizzled
// within each 128-byte group, so that ldmatrix's eight rows of one chunk
// (n = 8a..8a+7) and the staging's stores (eight chunks of one n) fall in
// distinct banks.
__device__ __forceinline__ int sc_wchunk(int c, int n) { return c ^ ((n ^ (n >> 4)) & 7); }

struct ScJob8 {
  const i8* in;      // slab: row 0 is the first row window row 0 reads
  int rs, cs, s;     // slab row and column strides (bytes), conv stride
  int ps;            // pool stride (1 without a pool)
  int n_wr, n_wc;    // outputs (pooled windows) computed: rows, columns
  int n, ksteps;     // N, K / 32
  int swz;           // pool window 2: rows 4-7 and 12-15 of a tile take position p ^ 1
  const int* taps;   // shared: slab offset of each 16-byte (ldmatrix) or 4-byte K granule
  const i8* w;       // shared: staged weights, one w_row-byte row per output channel
  int w_row;
  const float* b;    // global (N,)
  int act;
  float deq, qscale, qinv, qmin, qmax;  // qinv = 1 / qscale, exact (a power of two)
  // codes: int8 code (r, c, n) at dst[r*dst_rs + phase(c + dst_co)*dst_cs + n]
  // (the next slab); else fp32 value at dst[r*dst_rs + (c + dst_co)*dst_cs + n].
  void* dst;
  int codes, dst_rs, dst_cs, dst_co, dst_s, dst_q;
};

// rows x cols pixels of a C-channel code frame into a slab of cpad
// channels per column, 16 bytes per thread and step where C is a multiple
// of 16 and the frame's rows and pointer are 16-byte aligned, else one
// 32-bit word of four channels (read whole where the rows and pointer are
// 4-byte aligned, byte by byte otherwise): slab pixel (rr, x) is frame
// pixel (r0 + rr, x - x0) at src[row * src_rs + col * C], code 0 outside
// [0, src_rows) x [0, src_cols).
__device__ void sc_fill_slab8(i8* slab, int rs, int cs, int s, int q, int cpad, int rows,
                              int cols, const i8* __restrict__ src, long long src_rs, int C,
                              int r0, int src_rows, int x0, int src_cols) {
  const size_t at = reinterpret_cast<size_t>(src);
  const bool vec16 = (C & 15) == 0 && (src_rs & 15) == 0 && (at & 15) == 0;
  const bool vec = (C & 3) == 0 && (src_rs & 3) == 0 && (at & 3) == 0;
  const int unit = vec16 ? 16 : 4;
  const int cw = cpad / unit;
  const int total = rows * cols * cw;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int px = idx / cw;
    const int wi = idx - px * cw;
    const int rr = px / cols;
    const int x = px - rr * cols;
    const int gr = r0 + rr;
    const int gc = x - x0;
    const bool in = gr >= 0 && gr < src_rows && gc >= 0 && gc < src_cols;
    const i8* p = src + (size_t)gr * src_rs + (size_t)gc * C + unit * wi;
    i8* d = slab + rr * rs + sc_phase_col(x, s, q) * cs + unit * wi;
    if (vec16) {
      *reinterpret_cast<uint4*>(d) =
          in ? __ldg(reinterpret_cast<const uint4*>(p)) : make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    unsigned v = 0;
    if (in) {
      if (vec) {
        v = __ldg(reinterpret_cast<const unsigned*>(p));
      } else {
        for (int e = 0; e < 4; ++e)
          if (unit * wi + e < C) v |= (unsigned)(unsigned char)__ldg(p + e) << (8 * e);
      }
    }
    *reinterpret_cast<unsigned*>(d) = v;
  }
}

// The tap table of an int8 slab: the slab offset of each K granule of gran
// bytes (16 on the ldmatrix path, 4 on the word path), K in (ki, kj, c)
// order over cpad channels; granules past k*k*cpad read offset 0 (their
// weights are zero).
__device__ void sc_build_taps8(int* taps, int k, int cpad, int kpad, int gran, int rs,
                               int cs, int s, int q) {
  const int kdim = k * k * cpad;
  for (int i = threadIdx.x; i < kpad / gran; i += blockDim.x) {
    const int kk = i * gran;
    int off = 0;
    if (kk < kdim) {
      const int tap = kk / cpad;
      const int ki = tap / k;
      const int kj = tap - ki * k;
      off = ki * rs + sc_phase_col(kj, s, q) * cs + (kk - tap * cpad);
    }
    taps[i] = off;
  }
}

// Four K rows of codes, a 32-bit word of four output channels each (r[j]
// byte e is (k0 + j, nb + e)), transposed into four words of four K, one
// per channel (o[e] byte j is the same weight).
__device__ __forceinline__ void sc_transpose4(const unsigned (&r)[4], unsigned (&o)[4]) {
  const unsigned t0 = __byte_perm(r[0], r[1], 0x5140);
  const unsigned t1 = __byte_perm(r[2], r[3], 0x5140);
  const unsigned t2 = __byte_perm(r[0], r[1], 0x7362);
  const unsigned t3 = __byte_perm(r[2], r[3], 0x7362);
  o[0] = __byte_perm(t0, t1, 0x5410);
  o[1] = __byte_perm(t0, t1, 0x7632);
  o[2] = __byte_perm(t2, t3, 0x5410);
  o[3] = __byte_perm(t2, t3, 0x7632);
}

// Weight codes (K, K, C, N) HWIO, rows w_ld bytes apart, transposed into
// one staged row of w_row bytes per output channel n < n_pad, K in (ki, kj,
// c) order over cpad channels, zero past C, past k*k*cpad and past N. Where
// N, n_pad, the rows and the pointer allow, a thread reads four K rows of
// 16 channels (16-byte loads) and writes 16 words of four K, the lanes of
// a warp along K (eight chunks of one channel group: distinct banks);
// otherwise four rows of four channels, 32-bit loads where the rows and
// the pointer allow, byte by byte elsewhere.
__device__ void sc_stage_w8(i8* ws, const i8* __restrict__ w, int w_ld, int N, int n_pad,
                            int C, int k, int cpad, int kpad, int w_row) {
  const int kdim = k * k * cpad;
  const int nchunks = kpad >> 4;
  if ((N & 15) == 0 && (n_pad & 15) == 0 && (w_ld & 15) == 0 &&
      (reinterpret_cast<size_t>(w) & 15) == 0) {
    const int total = nchunks * (n_pad >> 4) * 4;
#pragma unroll 2
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
      const int kq = idx & 3;
      const int rest = idx >> 2;
      const int n16 = rest / nchunks;
      const int chunk = rest - n16 * nchunks;
      const int nb = n16 * 16;
      const int k0 = chunk * 16 + kq * 4;
      const int tap = k0 / cpad;
      const int c0 = k0 - tap * cpad;
      uint4 v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (k0 < kdim && c0 + j < C && nb < N)
          v[j] = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(tap * C + c0 + j) * w_ld + nb));
      }
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const unsigned r[4] = {(&v[0].x)[qq], (&v[1].x)[qq], (&v[2].x)[qq], (&v[3].x)[qq]};
        unsigned o[4];
        sc_transpose4(r, o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = nb + 4 * qq + e;
          *reinterpret_cast<unsigned*>(ws + n * w_row + sc_wchunk(chunk, n) * 16 + kq * 4) = o[e];
        }
      }
    }
    return;
  }
  const bool vec = (w_ld & 3) == 0 && (reinterpret_cast<size_t>(w) & 3) == 0;
  const int n4s = n_pad >> 2;
  const int total = (kpad >> 2) * n4s;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int kq = idx & 3;
    const int rest = idx >> 2;
    const int chunk = rest / n4s;
    const int nb = (rest - chunk * n4s) * 4;
    const int k0 = chunk * 16 + kq * 4;
    const int tap = k0 / cpad;
    const int c0 = k0 - tap * cpad;
    unsigned r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      unsigned v = 0;
      if (k0 < kdim && c0 + j < C) {
        const i8* src = w + (size_t)(tap * C + c0 + j) * w_ld + nb;
        if (vec && nb + 3 < N) {
          v = __ldg(reinterpret_cast<const unsigned*>(src));
        } else {
          for (int e = 0; e < 4; ++e)
            if (nb + e < N) v |= (unsigned)(unsigned char)__ldg(src + e) << (8 * e);
        }
      }
      r[j] = v;
    }
    unsigned o[4];
    sc_transpose4(r, o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = nb + e;
      *reinterpret_cast<unsigned*>(ws + n * w_row + sc_wchunk(chunk, n) * 16 + kq * 4) = o[e];
    }
  }
}

// Slab offset of output o's window (its first pool position); outputs
// past the last read output 0's window (conv.py int8_row_base).
__device__ __forceinline__ int sc_win_base8(const ScJob8& J, int o) {
  if (o >= J.n_wr * J.n_wc) o = 0;
  const int wr = o / J.n_wc;
  const int wc = o - wr * J.n_wc;
  return wr * J.ps * J.s * J.rs + wc * J.ps * J.cs;
}

// Slab offset of pool position p of a window of pw x pw.
__device__ __forceinline__ int sc_pos_off8(const ScJob8& J, int p, int pw) {
  const int i = p / pw;
  return i * J.s * J.rs + (p - i * pw) * J.cs;
}

// The K loop of one warp task: MT A tiles of 16 rows (ab: on the ldmatrix
// path the row this lane addresses; on the word path rows gid and gid + 8
// in ab and ab8) against NT n8 tiles from nt0, one m16n8k32 MMA per tile
// pair and 32 K. No barrier: the slab, taps and weights are all staged.
template <int MT, int NT, bool LDM>
__device__ __forceinline__ void sc_kloop_i8(const ScJob8& J, const int (&ab)[MT],
                                            const int (&ab8)[MT], int nt0,
                                            int (&acc)[MT][NT][4]) {
  constexpr int NB = NT > 1 ? NT / 2 : 1;
  const int lane = threadIdx.x & 31;
  const int tig = lane & 3;
  const int mi = lane >> 3;
  unsigned wrow[NB];
  int wsw[NB];
#pragma unroll
  for (int jp = 0; jp < NB; ++jp) {
    const int n = (nt0 + 2 * jp + (NT > 1 ? (mi >> 1) : 0)) * 8 + (lane & 7);
    wrow[jp] = sc_smem_addr(J.w + n * J.w_row);
    wsw[jp] = sc_wchunk(0, n);
  }
  const unsigned slab = sc_smem_addr(J.in);
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[t][j][e] = 0;

#pragma unroll 2
  for (int ks = 0; ks < J.ksteps; ++ks) {
    unsigned bf[NT][2];
    const int chunk = 2 * ks + (mi & 1);
#pragma unroll
    for (int jp = 0; jp < NB; ++jp) {
      const unsigned addr = wrow[jp] + 16 * (chunk ^ wsw[jp]);
      if constexpr (NT == 1) {
        sc_ldm_x2(bf[0], addr);
      } else {
        unsigned r[4];
        sc_ldm_x4(r, addr);
        bf[2 * jp][0] = r[0];
        bf[2 * jp][1] = r[1];
        bf[2 * jp + 1][0] = r[2];
        bf[2 * jp + 1][1] = r[3];
      }
    }
    if constexpr (LDM) {
      const int off = J.taps[2 * ks + (lane >> 4)];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        unsigned a[4];
        sc_ldm_x4(a, slab + ab[t] + off);
#pragma unroll
        for (int j = 0; j < NT; ++j) sc_mma_s8(acc[t][j], a, bf[j]);
      }
    } else {
      const int o0 = J.taps[8 * ks + tig];
      const int o1 = J.taps[8 * ks + 4 + tig];
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        const unsigned a[4] = {*reinterpret_cast<const unsigned*>(J.in + ab[t] + o0),
                               *reinterpret_cast<const unsigned*>(J.in + ab8[t] + o0),
                               *reinterpret_cast<const unsigned*>(J.in + ab[t] + o1),
                               *reinterpret_cast<const unsigned*>(J.in + ab8[t] + o1)};
#pragma unroll
        for (int j = 0; j < NT; ++j) sc_mma_s8(acc[t][j], a, bf[j]);
      }
    }
  }
}

__device__ __forceinline__ float sc_deq_act(const ScJob8& J, int v, float bv) {
  return sc_act(__fmul_rn(__int2float_rn(v), J.deq) + bv, J.act);
}

// Where output o (row-major over n_wr x n_wc) starts in the destination:
// its channel 0's element.
__device__ __forceinline__ long long sc_out_at8(const ScJob8& J, int o) {
  const int wr = o / J.n_wc;
  const int wc = o - wr * J.n_wc;
  return (long long)wr * J.dst_rs +
         (long long)(J.codes ? sc_phase_col(wc + J.dst_co, J.dst_s, J.dst_q) : wc + J.dst_co) *
             J.dst_cs;
}

// Channel n of the output at `at`: the stream code, into the next slab or
// as its fp32 grid value. y * qinv is y / qscale exactly (a power of two).
__device__ __forceinline__ void sc_put8(const ScJob8& J, long long at, int n, float y) {
  const float q = fminf(fmaxf(rintf(y * J.qinv), J.qmin), J.qmax);
  if (J.codes)
    static_cast<i8*>(J.dst)[at + n] = (i8)(int)q;
  else
    static_cast<float*>(J.dst)[at + n] = q * J.qscale;
}

// PW: compiled pool window (1: none, MT = 4 tiles of 16 outputs; 2, 3: PW*PW
// tiles of the same 16 windows, so a thread's accumulators hold every
// position of its windows and the pool is a max over registers). NT: n8
// tiles per warp task. Epilogue in the reference orders: pool first, the
// max of the int32 sums (exact), then dequantize, bias, act; else
// dequantize, bias and act per position, then the max. Every thread of the
// CTA calls it; warps take tasks round-robin, with no barrier.
template <int PW, int NT, bool LDM, bool POOL_FIRST>
__device__ void sc_gemm_i8(const ScJob8& J) {
  constexpr int MT = PW == 1 ? 4 : PW * PW;
  constexpr int PER = PW == 1 ? 64 : 16;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n_win = J.n_wr * J.n_wc;
  const int groups = ((J.n + 7) / 8 + NT - 1) / NT;
  const int tasks = ((n_win + PER - 1) / PER) * groups;
  const int ar = (lane & 7) + (lane & 8);  // the A row this lane addresses (ldmatrix)
  for (int task = warp; task < tasks; task += n_warps) {
    const int mb = task / groups;
    const int nt0 = (task - mb * groups) * NT;
    int ab[MT], ab8[MT];
    if (PW == 1) {
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        ab[t] = sc_win_base8(J, mb * 64 + t * 16 + (LDM ? ar : gid));
        ab8[t] = LDM ? 0 : sc_win_base8(J, mb * 64 + t * 16 + gid + 8);
      }
    } else {
      // Rows 4-7 and 12-15 (where swz) take position t ^ 1.
      const int r0 = LDM ? ar : gid;
      const int w0 = sc_win_base8(J, mb * 16 + r0);
      const int w8 = LDM ? 0 : sc_win_base8(J, mb * 16 + gid + 8);
      const int sw = (PW == 2 && J.swz && (r0 & 4)) ? 1 : 0;
#pragma unroll
      for (int t = 0; t < MT; ++t) {
        ab[t] = w0 + sc_pos_off8(J, t ^ sw, PW);
        ab8[t] = LDM ? 0 : w8 + sc_pos_off8(J, t ^ sw, PW);
      }
    }
    int acc[MT][NT][4];
    sc_kloop_i8<MT, NT, LDM>(J, ab, ab8, nt0, acc);
    float bv[NT][2];  // loaded before any store, which may alias
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = (nt0 + j) * 8 + 2 * tig + e;
        bv[j][e] = n < J.n ? __ldg(J.b + n) : 0.0f;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int t = 0; t < (PW == 1 ? MT : 1); ++t) {
        const int o = PW == 1 ? mb * 64 + t * 16 + gid + 8 * h : mb * 16 + gid + 8 * h;
        if (o >= n_win) continue;
        const long long at = sc_out_at8(J, o);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = (nt0 + j) * 8 + 2 * tig + e;
            if (n >= J.n) continue;
            const int i = 2 * h + e;
            float y;
            if (PW == 1) {
              y = sc_deq_act(J, acc[t][j][i], bv[j][e]);
            } else if (POOL_FIRST) {
              int m = acc[0][j][i];
#pragma unroll
              for (int u = 1; u < MT; ++u) m = max(m, acc[u][j][i]);
              y = sc_deq_act(J, m, bv[j][e]);
            } else {
              y = sc_deq_act(J, acc[0][j][i], bv[j][e]);
#pragma unroll
              for (int u = 1; u < MT; ++u) y = fmaxf(y, sc_deq_act(J, acc[u][j][i], bv[j][e]));
            }
            sc_put8(J, at, n, y);
          }
        }
      }
    }
  }
}

// Any other pool window, read at run time: the pw * pw positions of 16
// windows one after the other, each a K loop of one tile, folded into a
// running max in the kernel's order (the int32 sums pool first; else
// dequantize, bias and act per position). It serves the windows the
// reference takes and no topology of the paper uses.
template <bool LDM, bool POOL_FIRST>
__device__ void sc_gemm_i8_window(const ScJob8& J, int pw) {
  constexpr int NT = 1;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int n_win = J.n_wr * J.n_wc;
  const int groups = (J.n + 7) / 8;
  const int tasks = ((n_win + 15) / 16) * groups;
  const int ar = (lane & 7) + (lane & 8);
  for (int task = warp; task < tasks; task += n_warps) {
    const int mb = task / groups;
    const int nt0 = task - mb * groups;
    int m[4];
    float y[4];
    for (int pos = 0; pos < pw * pw; ++pos) {
      const int off = sc_pos_off8(J, pos, pw);
      const int ab[1] = {sc_win_base8(J, mb * 16 + (LDM ? ar : gid)) + off};
      const int ab8[1] = {LDM ? 0 : sc_win_base8(J, mb * 16 + gid + 8) + off};
      int acc[1][NT][4];
      sc_kloop_i8<1, NT, LDM>(J, ab, ab8, nt0, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = acc[0][0][i];
        if (POOL_FIRST) {
          m[i] = pos ? max(m[i], v) : v;
        } else {
          const int n = min(nt0 * 8 + 2 * tig + (i & 1), J.n - 1);
          const float f = sc_deq_act(J, v, __ldg(J.b + n));
          y[i] = pos ? fmaxf(y[i], f) : f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = nt0 * 8 + 2 * tig + (i & 1);
      const int o = mb * 16 + gid + 8 * (i >> 1);
      if (n >= J.n || o >= n_win) continue;
      sc_put8(J, sc_out_at8(J, o), n, POOL_FIRST ? sc_deq_act(J, m[i], __ldg(J.b + n)) : y[i]);
    }
  }
}

// The instantiations the host may pick (conv.py int8_layer): pool windows
// 1 and 2 with 4, 2 or 1 n8 tiles a task, 3 with 2 or 1, every other
// window the run-time path with 1; the ldmatrix path where the slab's
// channels are a multiple of 16, else the word path.
template <bool LDM, bool POOL_FIRST>
__device__ __forceinline__ void sc_gemm_i8_pick(const ScJob8& J, int pw, int nt) {
  if (pw == 2) {
    if (nt == 4) sc_gemm_i8<2, 4, LDM, POOL_FIRST>(J);
    else if (nt == 2) sc_gemm_i8<2, 2, LDM, POOL_FIRST>(J);
    else sc_gemm_i8<2, 1, LDM, POOL_FIRST>(J);
  } else if (pw == 3) {
    if (nt == 2) sc_gemm_i8<3, 2, LDM, POOL_FIRST>(J);
    else sc_gemm_i8<3, 1, LDM, POOL_FIRST>(J);
  } else if (pw == 1) {
    if (nt == 4) sc_gemm_i8<1, 4, LDM, POOL_FIRST>(J);
    else if (nt == 2) sc_gemm_i8<1, 2, LDM, POOL_FIRST>(J);
    else sc_gemm_i8<1, 1, LDM, POOL_FIRST>(J);
  } else {
    sc_gemm_i8_window<LDM, POOL_FIRST>(J, pw);
  }
}

template <bool POOL_FIRST>
__device__ __forceinline__ void sc_gemm_i8_dispatch(const ScJob8& J, int pw, int nt,
                                                    int cpad) {
  if ((cpad & 15) == 0) sc_gemm_i8_pick<true, POOL_FIRST>(J, pw, nt);
  else sc_gemm_i8_pick<false, POOL_FIRST>(J, pw, nt);
}

__device__ __forceinline__ ScJob8 sc_job8(const ScLayer& L, const i8* in, int n_wr,
                                          const int* taps, const i8* wst) {
  ScJob8 J;
  J.in = in;
  J.rs = L.rs;
  J.cs = L.cs;
  J.s = L.stride;
  J.ps = L.ps;
  J.n_wr = n_wr;
  J.n_wc = L.out_cols;
  J.n = L.n_out;
  J.ksteps = L.kpad / 32;
  J.swz = L.swz;
  J.taps = taps;
  J.w = wst;
  J.w_row = L.wrow;
  J.b = L.b;
  J.act = L.act;
  J.deq = L.deq;
  J.qscale = L.qscale;
  J.qinv = 1.0f / L.qscale;
  J.qmin = L.qmin;
  J.qmax = L.qmax;
  return J;
}

__global__ void __launch_bounds__(SC_THREADS, 2)
    sc_pyramid_i8_kernel(const ScPyramid P) {
  extern __shared__ __align__(16) i8 smem8[];
  i8* const buf0 = smem8;
  i8* const buf1 = smem8 + P.buf0_elems;
  int* const taps = reinterpret_cast<int*>(smem8 + P.tap_off);
  i8* const wst = smem8 + P.wst_off;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;
  int olo[SC_MAX_LAYERS], ohi[SC_MAX_LAYERS], ilo[SC_MAX_LAYERS], ihi[SC_MAX_LAYERS];
  sc_pyramid_rows(P, rb, olo, ohi, ilo, ihi);

  {  // Layer 0's rows [ilo, ihi) of codes, code 0 outside the frame.
    const ScLayer& L0 = P.L[0];
    const i8* xb = reinterpret_cast<const i8*>(P.x) +
                   (size_t)bi * L0.in_rows * L0.in_cols * L0.in_ch;
    sc_fill_slab8(buf0, L0.rs, L0.cs, L0.stride, L0.q, L0.cpad, ihi[0] - ilo[0],
                  L0.in_cols + L0.pad_l + L0.pad_r, xb, (long long)L0.in_cols * L0.in_ch,
                  L0.in_ch, L0.in_mult * rb + L0.in_off + ilo[0], L0.in_rows, L0.pad_l,
                  L0.in_cols);
  }

#pragma unroll 1
  for (int li = 0; li < P.n_layers; ++li) {
    const ScLayer& L = P.L[li];
    const i8* in = (li & 1) ? buf1 : buf0;
    sc_build_taps8(taps, L.k, L.cpad, L.kpad, (L.cpad & 15) ? 4 : 16, L.rs, L.cs, L.stride,
                   L.q);
    sc_stage_w8(wst, reinterpret_cast<const i8*>(L.w), L.n_out, L.n_out, L.np, L.in_ch, L.k,
                L.cpad, L.kpad, L.wrow);
    ScJob8 J = sc_job8(L, in, ohi[li] - olo[li], taps, wst);
    if (li + 1 < P.n_layers) {
      const int nx = li + 1;
      const ScLayer& Nx = P.L[nx];
      const int cols_n = Nx.in_cols + Nx.pad_l + Nx.pad_r;
      i8* dst = (li & 1) ? buf0 : buf1;
      J.codes = 1;
      J.dst = dst + (olo[li] - ilo[nx]) * Nx.rs;
      J.dst_rs = Nx.rs;
      J.dst_cs = Nx.cs;
      J.dst_co = Nx.pad_l;
      J.dst_s = Nx.stride;
      J.dst_q = Nx.q;
      // The next layer's SAME padding: its stored rows outside the computed
      // ones (whole rows) and the computed rows' pad columns hold code 0.
      const int lo = max(olo[li], ilo[nx]) - ilo[nx];  // computed rows [lo, hi) of the slab
      const int hi = max(lo, min(ohi[li], ihi[nx]) - ilo[nx]);
      const int below = ihi[nx] - ilo[nx] - hi;
      const int row_words = Nx.rs >> 2;
      for (int idx = threadIdx.x; idx < (lo + below) * row_words; idx += blockDim.x) {
        const int zr = idx / row_words;
        const int rr = zr < lo ? zr : hi + (zr - lo);
        reinterpret_cast<unsigned*>(dst + rr * Nx.rs)[idx - zr * row_words] = 0u;
      }
      const int cw = Nx.cpad >> 2;
      const int pads = (cols_n - Nx.in_cols) * cw;
      for (int idx = threadIdx.x; idx < (hi - lo) * pads; idx += blockDim.x) {
        const int rr = lo + idx / pads;
        const int e = idx % pads;
        const int px = e / cw;
        const int x = px < Nx.pad_l ? px : Nx.in_cols + px;
        *reinterpret_cast<unsigned*>(dst + rr * Nx.rs + sc_phase_col(x, Nx.stride, Nx.q) * Nx.cs +
                                     4 * (e - px * cw)) = 0u;
      }
    } else {
      J.codes = 0;
      J.dst = P.out + ((size_t)bi * P.out_rows + (size_t)rb * P.block_rows) * L.out_cols *
                          L.n_out;
      J.dst_rs = L.out_cols * L.n_out;
      J.dst_cs = L.n_out;
      J.dst_co = 0;
      J.dst_s = 1;
      J.dst_q = 0;
    }
    __syncthreads();
    if (ohi[li] > olo[li]) sc_gemm_i8_dispatch<true>(J, L.pw, L.tn, L.cpad);
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The wgmma path of sc_fused_i8_kernel (sc_fused_i8_wgmma below; conv.py
// fused_path picks it, wgmma_geometry sizes it, kmajor_weights lays out its
// weights). Every layout decision here is mirrored by conv.py (wgmma_row,
// wgmma_w_offset), which the CPU tests check.

#define SC_WG_KS 64                       // K bytes of one ring stage: one tap's channel run
#define SC_WG_NT 128                      // output channels of one N tile
#define SC_WG_STAGE (SC_WG_KS * SC_WG_NT)  // bytes of one ring stage
#define SC_WG_CONSUMERS 256               // two consumer warpgroups
#define SC_WG_THREADS (SC_WG_CONSUMERS + 128)  // and the producer warpgroup

__device__ __forceinline__ void sc_mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Spin until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void sc_mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void sc_mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// One bulk copy (TMA, no tensor map) of `bytes` contiguous bytes into shared
// memory, its completion counted on `bar`, which expects them.
__device__ __forceinline__ void sc_bulk_g2s(unsigned dst, const void* src, unsigned bytes,
                                            unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 16 bytes into shared memory without a register round trip; zeros where
// `bytes` is 0 (nothing is read then).
__device__ __forceinline__ void sc_cp16_zfill(unsigned dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

// The B operand's descriptor: a ring stage's 32-byte K step at `addr`,
// K-major without swizzle, in core matrices of 8 channels x 16 bytes (128
// contiguous bytes): the two 16-byte halves of the step LBO = 128 bytes
// apart, groups of 8 channels SBO = 512 bytes apart (conv.py
// wgmma_w_offset).
__device__ __forceinline__ unsigned long long sc_wg_desc(unsigned addr) {
  return (unsigned long long)((addr & 0x3FFFF) >> 4) | ((unsigned long long)(128 >> 4) << 16) |
         ((unsigned long long)(512 >> 4) << 32);
}

// d (this thread's share of a 64 x 128 int32 tile) = a (64 x 32 s8: this
// warp's 16 rows as mma.sync's A fragment) * b (32 x 128 s8 at desc),
// plus d where scale_d. Exact int32 sums.
__device__ __forceinline__ void sc_wgmma_s8(int (&d)[64], const unsigned (&a)[4],
                                            unsigned long long desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

__device__ __forceinline__ void sc_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void sc_wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void sc_wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from touching an accumulator while a wgmma that
// writes it may be in flight.
__device__ __forceinline__ void sc_wg_pin(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Slab offset of row rho of this warp's slice of m64 tile t (0 or 1) of
// consumer warpgroup wg, warp wi of it: without a pool, conv position m =
// 128 wg + 64 t + 16 wi + rho of the block, row-major over its rows; with
// the 2x2 pool, window v = 32 wg + 8 wi + rho % 8 at pool position (t, rho
// / 8), its column flipped for rows 4-7 and 12-15 where swz, so that a
// thread's accumulators (rows gid and gid + 8 of both tiles) hold all four
// positions of its window. Rows past the block's outputs read output 0's.
__device__ __forceinline__ int sc_wg_row(const ScFused& F, int n_valid, int wg, int wi, int t,
                                         int rho) {
  if (F.pw == 2) {
    int v = 32 * wg + 8 * wi + (rho & 7);
    if (v >= n_valid) v = 0;
    const int wr = v / F.w_keep;
    const int wc = v - wr * F.w_keep;
    const int pj = (rho >> 3) ^ ((F.swz && (rho & 4)) ? 1 : 0);
    return (2 * wr + t) * F.rs + (2 * wc + pj) * F.cs;
  }
  int m = 128 * wg + 64 * t + 16 * wi + rho;
  if (m >= n_valid) m = 0;
  const int pr = m / F.w_keep;
  return pr * F.rs + (m - pr * F.w_keep) * F.cs;
}

// The A fragments of K step ks (one tap's run of 64 channels): two 32-byte
// halves of this lane's row of each m64 tile, whose bases are ab0, ab1.
__device__ __forceinline__ void sc_wg_lda(unsigned (&a)[2][2][4], const ScFused& F, unsigned ab0,
                                          unsigned ab1, int ks) {
  const int k0 = ks * SC_WG_KS;
  const int tap = k0 / F.c;
  const int ki = tap / F.k;
  const int toff = ki * F.rs + (tap - ki * F.k) * F.cs + (k0 - tap * F.c);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sc_ldm_x4(a[0][h], ab0 + toff + 32 * h);
    sc_ldm_x4(a[1][h], ab1 + toff + 32 * h);
  }
}

// The ring's consumer side: the stage a warpgroup reads next, the parity
// of its fill, and the stage its last wgmmas still read (-1: none).
struct ScWgRing {
  unsigned ring, full, empty;
  int stages, stage, prev;
  unsigned phase;
};

// K step ks of both m64 tiles (scale_d 0 at the tile's first step): wait
// for the stage, four wgmmas, then wait for the previous step's, whose
// stage goes back to the producer. One group stays in flight.
__device__ __forceinline__ void sc_wg_step(int (&acc)[2][64], const unsigned (&a)[2][2][4],
                                           ScWgRing& R, int ks, int lane) {
  const unsigned st = R.ring + R.stage * SC_WG_STAGE;
  sc_mbar_wait(R.full + 8 * R.stage, R.phase);
  sc_wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned long long desc = sc_wg_desc(st + 256 * h);
    sc_wgmma_s8(acc[0], a[0][h], desc, ks | h);
    sc_wgmma_s8(acc[1], a[1][h], desc, ks | h);
  }
  sc_wgmma_commit();
  sc_wgmma_wait<1>();
  sc_wg_pin(acc[0]);
  sc_wg_pin(acc[1]);
  if (R.prev >= 0 && lane == 0) sc_mbar_arrive(R.empty + 8 * R.prev);
  R.prev = R.stage;
  if (++R.stage == R.stages) {
    R.stage = 0;
    R.phase ^= 1;
  }
}

// The stream code of y as its fp32 grid value (sc_put8's arithmetic).
__device__ __forceinline__ float sc_wg_code(const ScFused& F, float qinv, float y) {
  return fminf(fmaxf(rintf(y * qinv), F.qmin), F.qmax) * F.qscale;
}

// Channels n0 and n0 + 1 of the output at p: one 8-byte store where N is
// even (the four lanes of a quad fill 32 contiguous bytes).
__device__ __forceinline__ void sc_wg_put2(const ScFused& F, float qinv, float* p, int n0,
                                           float y0, float y1) {
  const float q0 = sc_wg_code(F, qinv, y0);
  const float q1 = sc_wg_code(F, qinv, y1);
  if ((F.n & 1) == 0) {
    *reinterpret_cast<float2*>(p + n0) = make_float2(q0, q1);
  } else {
    p[n0] = q0;
    if (n0 + 1 < F.n) p[n0 + 1] = q1;
  }
}

// One row block of one image a work item; a persistent grid walks them.
// Warpgroup 2, the producer, gives up registers and one thread of it
// streams each item's weights (kmajor_weights: N tile by N tile, K step
// by K step, one SC_WG_STAGE-byte stage each) through a ring of F.stages
// stages with bulk copies and mbarriers. Warpgroups 0 and 1, the
// consumers, take the registers, fill the item's slab once (cp.async,
// code 0 below the frame), then for each N tile run every K step: ldmatrix
// the next step's A rows from the slab (a K step is one tap's channel run,
// at the tap's offset) while this step's wgmmas run, two m64n128k32 a
// tile, one group in flight; then the epilogue of the tile in registers,
// in the single layer's order, while the producer fills the ring for the
// next.
__device__ __forceinline__ void sc_fused_i8_wgmma(const ScFused& F, i8* smem) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const unsigned slab = sc_smem_addr(smem);
  ScWgRing R;
  R.ring = slab + F.wst_off;
  R.full = R.ring + F.stages * SC_WG_STAGE;  // full[s] at 8 s, then empty[s]
  R.empty = R.full + 8 * F.stages;
  R.stages = F.stages;
  R.stage = 0;
  R.prev = -1;
  R.phase = 0;
  const int ksteps = F.kpad / SC_WG_KS;
  const int items = F.n_rb * F.batch;
  if (tid == 0) {
    for (int s = 0; s < F.stages; ++s) {
      sc_mbar_init(R.full + 8 * s, 1);
      sc_mbar_init(R.empty + 8 * s, SC_WG_CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp >= SC_WG_CONSUMERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == SC_WG_CONSUMERS) {
      const i8* w = reinterpret_cast<const i8*>(F.w);
      for (int item = blockIdx.x; item < items; item += gridDim.x)
        for (int i = 0; i < F.tn * ksteps; ++i) {
          sc_mbar_wait(R.empty + 8 * R.stage, R.phase ^ 1);
          sc_bulk_g2s(R.ring + R.stage * SC_WG_STAGE, w + (size_t)i * SC_WG_STAGE, SC_WG_STAGE,
                      R.full + 8 * R.stage);
          if (++R.stage == F.stages) {
            R.stage = 0;
            R.phase ^= 1;
          }
        }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2;
  const int wi = warp & 3;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int rho = lane & 15;
  const bool pooled = F.pw == 2;
  const float qinv = 1.0f / F.qscale;
  ScJob8 J;  // sc_deq_act's fields
  J.act = F.act;
  J.deq = F.deq;
  int acc[2][64];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[t][i] = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int bi = item / F.n_rb;
    const int rb = item - bi * F.n_rb;
    const int row0 = rb * F.r;
    const i8* xb = reinterpret_cast<const i8*>(F.x) + (size_t)bi * F.x_img + (size_t)row0 * F.x_rs;
    const int n_valid = min(F.r_o, F.h_keep - rb * F.r_o) * F.w_keep;
    float* const dst = F.out + (size_t)bi * F.out_img + (size_t)rb * F.r_o * F.out_rs;
    // This thread's outputs: rows gid and gid + 8 of both tiles, one window
    // with the pool; nullptr past the block's outputs.
    float* op[2][2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = pooled ? 32 * wg + 8 * wi + gid : 128 * wg + 64 * t + 16 * wi + gid + 8 * h;
        const int orow = o / F.w_keep;
        op[t][h] = o < n_valid ? dst + (size_t)orow * F.out_rs + (size_t)(o - orow * F.w_keep) * F.out_cs
                               : nullptr;
      }
    asm volatile("bar.sync 1, %0;\n" ::"n"(SC_WG_CONSUMERS) : "memory");  // the last slab is read
    {  // the slab: rows past the frame read code 0
      const int cw = F.c >> 4;
      const int px_row = F.w_in * cw;
      const int total = F.in_rows_blk * px_row;
      const int rows_in = F.h - row0;
      for (int idx = tid; idx < total; idx += SC_WG_CONSUMERS) {
        const int rr = idx / px_row;
        const int e = idx - rr * px_row;
        const int x = e / cw;
        const int ci = e - x * cw;
        const bool in = rr < rows_in;
        const void* src = xb + (size_t)rr * F.x_rs + (size_t)x * F.c + 16 * ci;
        sc_cp16_zfill(slab + rr * F.rs + x * F.cs + 16 * ci, in ? src : F.x, in ? 16 : 0);
      }
      asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(SC_WG_CONSUMERS) : "memory");
    const unsigned ab0 = slab + sc_wg_row(F, n_valid, wg, wi, 0, rho) + 16 * (lane >> 4);
    const unsigned ab1 = slab + sc_wg_row(F, n_valid, wg, wi, 1, rho) + 16 * (lane >> 4);
    for (int nt = 0; nt < F.tn; ++nt) {
      unsigned a0[2][2][4], a1[2][2][4];
      sc_wg_lda(a0, F, ab0, ab1, 0);
      int ks = 0;
#pragma unroll 1
      for (; ks + 1 < ksteps; ks += 2) {
        sc_wg_step(acc, a0, R, ks, lane);
        sc_wg_lda(a1, F, ab0, ab1, ks + 1);
        sc_wg_step(acc, a1, R, ks + 1, lane);
        if (ks + 2 < ksteps) sc_wg_lda(a0, F, ab0, ab1, ks + 2);
      }
      if (ks < ksteps) sc_wg_step(acc, a0, R, ks, lane);
      sc_wgmma_wait<0>();
      sc_wg_pin(acc[0]);
      sc_wg_pin(acc[1]);
      if (lane == 0) sc_mbar_arrive(R.empty + 8 * R.prev);
      R.prev = -1;
      // Epilogue: dequantize, bias, act per position, then the max over the
      // window, then the stream code as its fp32 grid value.
#pragma unroll
      for (int j = 0; j < SC_WG_NT / 8; ++j) {
        const int n0 = nt * SC_WG_NT + 8 * j + 2 * tig;
        if (n0 >= F.n) continue;
        const float b0 = __ldg(F.b + n0);
        const float b1 = n0 + 1 < F.n ? __ldg(F.b + n0 + 1) : 0.0f;
        if (pooled) {
          if (!op[0][0]) continue;
          float y[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float bv = e ? b1 : b0;
            y[e] = sc_deq_act(J, acc[0][4 * j + e], bv);
            y[e] = fmaxf(y[e], sc_deq_act(J, acc[0][4 * j + 2 + e], bv));
            y[e] = fmaxf(y[e], sc_deq_act(J, acc[1][4 * j + e], bv));
            y[e] = fmaxf(y[e], sc_deq_act(J, acc[1][4 * j + 2 + e], bv));
          }
          sc_wg_put2(F, qinv, op[0][0], n0, y[0], y[1]);
        } else {
#pragma unroll
          for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int h = 0; h < 2; ++h)
              if (op[t][h])
                sc_wg_put2(F, qinv, op[t][h], n0, sc_deq_act(J, acc[t][4 * j + 2 * h], b0),
                           sc_deq_act(J, acc[t][4 * j + 2 * h + 1], b1));
        }
      }
    }
  }
}

// WG: the wgmma path (sc_fused_i8_wgmma, a persistent grid of
// SC_WG_THREADS-thread CTAs); else the mma.sync path below, a CTA per
// (row block, image).
template <bool WG>
__global__ void __launch_bounds__(WG ? SC_WG_THREADS : SC_THREADS)
    sc_fused_i8_kernel(const ScFused F) {
  extern __shared__ __align__(16) i8 slab8[];
  if (WG) {
    sc_fused_i8_wgmma(F, slab8);
    return;
  }
  int* const taps = reinterpret_cast<int*>(slab8 + F.tap_off);
  i8* const wst = slab8 + F.wst_off;
  const int rb = blockIdx.x;
  const int bi = blockIdx.y;
  const int row0 = rb * F.r * F.stride;
  const i8* xb = reinterpret_cast<const i8*>(F.x) + (size_t)bi * F.x_img +
                 (size_t)row0 * F.x_rs;
  // rows past the frame read code 0
  sc_fill_slab8(slab8, F.rs, F.cs, F.stride, F.q, F.cpad, F.in_rows_blk, F.w_in, xb, F.x_rs,
                F.c, 0, F.h - row0, 0, F.w_in);
  sc_build_taps8(taps, F.k, F.cpad, F.kpad, (F.cpad & 15) ? 4 : 16, F.rs, F.cs, F.stride, F.q);
  sc_stage_w8(wst, reinterpret_cast<const i8*>(F.w), F.w_ld, F.n, F.np, F.c, F.k, F.cpad,
              F.kpad, F.wrow);
  const int po_lo = rb * F.r_o;
  const int po_hi = min(F.h_keep, po_lo + F.r_o);
  ScJob8 J;
  J.in = slab8;
  J.rs = F.rs;
  J.cs = F.cs;
  J.s = F.stride;
  J.ps = F.ps;
  J.n_wr = po_hi - po_lo;
  J.n_wc = F.w_keep;
  J.n = F.n;
  J.ksteps = F.kpad / 32;
  J.swz = F.swz;
  J.taps = taps;
  J.w = wst;
  J.w_row = F.wrow;
  J.b = F.b;
  J.act = F.act;
  J.deq = F.deq;
  J.qscale = F.qscale;
  J.qinv = 1.0f / F.qscale;
  J.qmin = F.qmin;
  J.qmax = F.qmax;
  J.dst = F.out + (size_t)bi * F.out_img + (size_t)po_lo * F.out_rs;
  J.codes = 0;
  J.dst_rs = F.out_rs;
  J.dst_cs = F.out_cs;
  J.dst_co = 0;
  J.dst_s = 1;
  J.dst_q = 0;
  __syncthreads();
  sc_gemm_i8_dispatch<false>(J, F.pw, F.tn, F.cpad);
}

static int sc_opt_in_smem(const void* kernel, int smem_bytes) {
  if (smem_bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
}

extern "C" int sc_pyramid_desc_bytes() { return (int)sizeof(ScPyramid); }
extern "C" int sc_fused_desc_bytes() { return (int)sizeof(ScFused); }

// CTAs of the fp32 pyramid (which = 0), fp32 single-layer (1), int8
// pyramid (2) or int8 single-layer kernel (3) that fit on one SM at
// `threads` per CTA and smem_bytes of dynamic shared memory; negative: a
// CUDA error.
extern "C" int sc_ctas_per_sm(int which, int smem_bytes, int threads) {
  const void* kernels[5] = {(const void*)sc_pyramid_kernel, (const void*)sc_fused_kernel,
                            (const void*)sc_pyramid_i8_kernel,
                            (const void*)sc_fused_i8_kernel<false>,
                            (const void*)sc_fused_i8_kernel<true>};
  if (which < 0 || which > 4) return -(int)cudaErrorInvalidValue;
  const void* kernel = kernels[which];
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
  if (desc->wg) {
    int err = sc_opt_in_smem((const void*)sc_fused_i8_kernel<true>, smem_bytes);
    if (err) return err;
    sc_fused_i8_kernel<true><<<desc->grid, SC_WG_THREADS, smem_bytes, (cudaStream_t)stream>>>(
        *desc);
    return (int)cudaGetLastError();
  }
  int err = sc_opt_in_smem((const void*)sc_fused_i8_kernel<false>, smem_bytes);
  if (err) return err;
  dim3 grid(desc->n_rb, desc->batch);
  sc_fused_i8_kernel<false><<<grid, desc->threads, smem_bytes, (cudaStream_t)stream>>>(
      *desc);
  return (int)cudaGetLastError();
}
