// GRU backpropagation through time for Hopper (sm_90a) with W streamed
// from global memory every step: one C call runs the whole reverse time
// loop of D directions at any H, for the sizes whose W does not fit the
// grid's shared memory (ds2_full: H=1760, D=2, W 18.6 MB a direction in
// bf16).
//
// Replaces the TPU kernel _gru_bwd_kernel_blocked (deepspeech_tpu/ops/
// rnn_pallas.py:312, K9, launched by _gru_bwd :898 on a (T, n_blocks)
// grid of [H, c] column blocks), which recomputes a step's gates block by
// block and accumulates the previous step's dgates @ W^T on the same block
// stream. The contract is ops/gru.py gru_bwd's docstring, as for
// csrc/gru_bwd.cu:
//   xp [T,B,3H] and w [D,H,3H] in one dtype, bf16|f32 (the dot dtype),
//   mask [T,B] f32, bias [D,3H] f32, ys [D,T,B,H] f32 (the forward's
//   outputs), dy [D,T,B,H] f32, reverse bit d set for a direction whose
//   forward ran t = T-1..0
//   -> dxp [D,T,B,3H] f32 = (da_r, da_z, da_n) and dgates [D,T,B,3H] f32
//      = (da_r, da_z, dg_n) at every row.
// Each direction runs against its own forward order from dh = 0; a step
// recomputes the gates from h_prev (the ys row of the forward's step
// before, 0 at its first step) rounded to the dot dtype, applies
// _gru_bwd_elt's math (rnn_pallas.py:189) with dh = carry + dy, and
// carries dh_prev = the elementwise terms + round(dgates) @ W^T in f32.
//
// What bounds it: two [T*B,H] x [H,3H]-sized products per direction, the
// gate recompute and round(dgates) @ W^T (1.01 TFLOP each at ds2_full's
// D=2, B=32, T'=850), and dxp and dgates written once (2.3 GB). The gate
// recompute reads h_prev from the forward's tape and so does not depend
// on the carried dh: it is one parallel GEMM. Only round(dgates) @ W^T
// lies on the serial chain: T steps of a [B,3H] x [3H,U] product per group
// of U units, so the time is T times one step's latency, far above both
// bounds. A step's cost is that of the busiest SM: it moves the part of
// W's [U,3H] rows that is not resident and the [B,3H] dgates row (0.68 MB
// at U=32, B=32, all streamed) from L2 through shared memory into 10.8
// MFLOP of mma.sync, then waits at one grid barrier.
//
// bf16 path (the main path) where H % 8 == 0 and w, ys and the scratch
// are 16-byte aligned: two launches from one C entry point, both from
// csrc/gru_bwd_mma.cuh (K5 and K7, csrc/gru_bwd.cu, run the same two with
// all of W held):
//  1. gru_bwd_stream_gates_kernel, the gate pre-pass: one tensor-core GEMM
//     pre[d, row] = round(h_prev(d, row)) @ W[d] + bias[d] for every row at
//     once (M = T*B, N = 3H, K = H), written into the dgates buffer itself.
//     N need not fill the last tile (3H = 5280 = 20 * 256 + 160 at
//     H=1760).
//  2. gru_bwd_stream_mma_kernel, the serial loop: a cooperative,
//     persistent grid over D x ceil(H/32) groups of MU=32 hidden units, one
//     group a block and one block an SM (110 groups at ds2_full), with one
//     grid barrier a step. A step forms dh[:, own] = elementwise part +
//     round(dg_{i-1}) @ W[own rows, :]^T on mma.sync, 3H deep, each of 8
//     warps taking every 8th 32-deep chunk (165 chunks at H=1760: 21 or 20
//     a warp), then the elementwise step. Each warp's first W_RES chunks of
//     W stay in shared memory for the whole call when a block has one
//     group (csrc/lstm_fwd_stream.cu's lever); the streamed ones pass
//     through the warp's ring beside the [B,3H] bf16 dgates row, and those
//     of the next step are issued before the grid barrier. W crosses L2
//     once a step, by rows, and only its part that is not resident; h_prev
//     leaves the loop. deepspeech_tpu_torch/k9_variants.py times the ring
//     depth and resident share beside the others tried.
//
// f32 path (not the main path; model.dtype=float32) and every other bf16
// call: gru_bwd_stream_kernel, two phases a step on the CUDA cores (no
// TF32). dh_prev[:, k] sums over all 3H gate columns, which no block owns
// alone. csrc/gru_bwd.cu has each column block write partial sums for
// every k and adds them up after the grid barrier: at H=1760, D=2, B=32
// that scratch is 99 MB a step, far over the 50 MB L2. This kernel splits
// each step into two phases instead, over D x ceil(H/U) groups of U=16
// hidden units:
//  1. Column phase. A group streams its [H, 3U] column slice of W
//     (gate columns j, H+j, 2H+j) to recompute its gates, takes the
//     elementwise step, writes dxp and dgates, keeps the elementwise part
//     of dh_prev for its units, and writes round(dgates) for its columns
//     into a [B, 3H] row in the dot dtype. A grid barrier follows.
//  2. Row phase. The same group streams W's rows k of its own units
//     ([U, 3H], contiguous) and the whole round(dgates) row of its
//     direction, and forms dh_prev[:, k] = elementwise part +
//     sum_c round(dgates)[:, c] W[k, c], summed in column order.
// A group owns the same units in both phases, so dh never leaves its
// owner and the row phase of step i runs straight into the column phase
// of step i+1: one grid barrier a step. The dgates row is double-buffered
// by step parity. W crosses L2 twice a step, once by columns and once by
// rows. Each phase stages its operands in KC-wide chunks through shared
// memory as f32, two buffers deep, with the next chunk's global loads
// issued into registers before the current chunk's products run (one
// __syncthreads() per chunk); f32 FMAs on the CUDA cores. The grid is
// cooperative and persistent: as many blocks as fit (at most one per
// group), block g taking groups g, g + grid, ... No atomics.
//
// The choice between the two is made before any launch, from the dtype,
// H and the pointers' alignment (gru_bwd_stream_launch); ops/gru.py's
// _bwd_mma repeats it.


#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_bwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per group
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 3 * U;         // gate columns of a group
constexpr int KC = 64;            // chunk width (W rows or gate columns)
constexpr int KS = KC + 4;        // chunk row stride (16-byte aligned rows)
// Column phase: a chunk of W is staged by the first W_THREADS threads,
// each owning one of the group's columns and every KR-th row of the
// chunk (one base pointer and one stride keep the registers few).
constexpr int KR = 4;
constexpr int W_THREADS = KR * GC;            // 192
constexpr int W_STAGE = KC / KR;              // W values per loader
constexpr int H_STAGE = ROWS * KC / THREADS;  // h_prev or dgates per thread
constexpr int R_STAGE = U * KC / THREADS;     // row phase: W per thread
constexpr int HR = THREADS / KC;              // rows per staging sweep
constexpr int BUF = (GC + ROWS) * KS;         // floats per buffer

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Loads of a value's bits, read-only (.nc) or through L2 only (.cg),
// widened to f32 by bits_f32 only where the value is used: a conversion
// right after the load would wait for it, and the prefetch would no
// longer overlap the products.
template <typename T> struct Bits { using type = float; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ float ldg_bits(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short ldg_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float ldcg_bits(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ unsigned short ldcg_bits(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float bits_f32(float x) { return x; }
__device__ __forceinline__ float bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A value rounded to the dot dtype, kept as f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

constexpr size_t SMEM_BYTES = sizeof(float) * 2 * BUF;

template <typename WT>
__global__ void __launch_bounds__(THREADS, 2)
gru_bwd_stream_kernel(const WT* __restrict__ xp,
                      const float* __restrict__ mask,
                      const WT* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ ys,
                      const float* __restrict__ dy, float* __restrict__ dxp,
                      float* __restrict__ dgates, float* scratch, int D,
                      int T, int B, int H, int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int nblk = (H + U - 1) / U;
  const int groups = D * nblk;
  const int h_pad = (H + KC - 1) / KC * KC;
  const int c_pad = (3 * H + KC - 1) / KC * KC;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;
  // Scratch: dh carried into a step and the elementwise part of dh_prev,
  // each [D][B][H] f32 and touched only by the thread that owns the unit
  // and row; then round(dgates) rows [2][D][B][3H] in the dot dtype.
  float* dh_buf = scratch;
  float* de_buf = dh_buf + size_t(D) * BH;
  WT* dgr = reinterpret_cast<WT*>(de_buf + size_t(D) * BH);
  cg::grid_group grid = cg::this_grid();

  for (int i = 0; i < T; ++i) {
    const bool last = i == T - 1;  // the forward's first step: h_prev = 0
    WT* dgr_i = dgr + size_t(i & 1) * D * B * H3;

    // 1. Column phase.
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int j = j0 + lu;
      const bool rev = (reverse_bits >> d) & 1;
      // Step i of this direction's BPTT is step T-1-i of its forward.
      const int row = rev ? i : T - 1 - i;
      const WT* w_d = w + size_t(d) * H * H3;
      const float* ys_d = ys + size_t(d) * T * BH;
      const float* hp =
          last ? nullptr : ys_d + size_t(rev ? row + 1 : row - 1) * BH;
      // This thread's W column when it stages W (gate wc / U, unit
      // j0 + wc % U, rows wk, wk + KR, ...) and its h_prev rows and column.
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_loader = threadIdx.x < W_THREADS;
      const bool w_live = j0 + wc % U < H;
      const WT* w_col = w_d + (wc / U) * H + j0 + wc % U;
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][3] = {};
        if (hp != nullptr) {
          typename Bits<WT>::type wpre[W_STAGE];
          float hpre[H_STAGE];
          auto fetch = [&](int k0) {
            if (w_loader) {
#pragma unroll
              for (int q = 0; q < W_STAGE; ++q) {
                const int k = k0 + wk + q * KR;
                wpre[q] = (w_live && k < H) ? ldg_bits(w_col + size_t(k) * H3)
                                            : 0;
              }
            }
#pragma unroll
            for (int q = 0; q < H_STAGE; ++q) {
              const int b = b0 + hr + q * HR, k = k0 + hk;
              hpre[q] = (b < B && k < H) ? __ldg(hp + size_t(b) * H + k)
                                         : 0.f;
            }
          };
          fetch(0);
          for (int k0 = 0, buf = 0; k0 < h_pad; k0 += KC, buf ^= 1) {
            float* w_s = smem + buf * BUF;  // [GC][KS], k contiguous
            float* h_s = w_s + GC * KS;     // [ROWS][KS]
            if (w_loader) {
#pragma unroll
              for (int q = 0; q < W_STAGE; ++q)
                w_s[wc * KS + wk + q * KR] = bits_f32(wpre[q]);
            }
#pragma unroll
            for (int q = 0; q < H_STAGE; ++q)
              h_s[(hr + q * HR) * KS + hk] = round_to<WT>(hpre[q]);
            __syncthreads();
            if (k0 + KC < h_pad) fetch(k0 + KC);
            const float* w_r = w_s + (0 * U + lu) * KS;
            const float* w_z = w_s + (1 * U + lu) * KS;
            const float* w_n = w_s + (2 * U + lu) * KS;
            const float* h_a = h_s + rg * KS;
            const float* h_b = h_s + (rg + RG) * KS;
#pragma unroll 4
            for (int kk = 0; kk < KC; kk += 4) {
              float vr[4], vz[4], vn[4], xa[4], xb[4];
              load4(w_r + kk, vr);
              load4(w_z + kk, vz);
              load4(w_n + kk, vn);
              load4(h_a + kk, xa);
              load4(h_b + kk, xb);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[0][0] = fmaf(xa[e], vr[e], acc[0][0]);
                acc[0][1] = fmaf(xa[e], vz[e], acc[0][1]);
                acc[0][2] = fmaf(xa[e], vn[e], acc[0][2]);
                acc[1][0] = fmaf(xb[e], vr[e], acc[1][0]);
                acc[1][1] = fmaf(xb[e], vz[e], acc[1][1]);
                acc[1][2] = fmaf(xb[e], vn[e], acc[1][2]);
              }
            }
          }
          // The next pass fills buffer 0 at once: when the last chunk
          // used it (an odd chunk count), its readers finish first.
          __syncthreads();
        }
        if (j >= H) continue;
        const float b_r = bias[d * H3 + j];
        const float b_z = bias[d * H3 + H + j];
        const float b_n = bias[d * H3 + 2 * H + j];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = b0 + rg + q * RG;
          if (b >= B) continue;
          const float h_prev = hp ? __ldg(hp + size_t(b) * H + j) : 0.f;
          const WT* x = xp + (size_t(row) * B + b) * H3;
          const float gn = acc[q][2] + b_n;
          const float rr = sigmoid(to_f32(x[j]) + (acc[q][0] + b_r));
          const float z = sigmoid(to_f32(x[H + j]) + (acc[q][1] + b_z));
          const float n = tanhf(to_f32(x[2 * H + j]) + rr * gn);
          const float m = mask[size_t(row) * B + b];
          const size_t o_h = size_t(d) * BH + size_t(b) * H + j;
          const float dh = (i > 0 ? dh_buf[o_h] : 0.f) +
                           dy[size_t(d) * T * BH + size_t(row) * BH +
                              size_t(b) * H + j];
          const float dh_mid = m * dh;
          const float dn = dh_mid * (1.f - z);
          const float dz = dh_mid * (h_prev - n);
          const float da_n = dn * (1.f - n * n);
          const float dr = da_n * gn;
          const float dg_n = da_n * rr;
          const float da_z = dz * z * (1.f - z);
          const float da_r = dr * rr * (1.f - rr);
          de_buf[o_h] = dh_mid * z + (1.f - m) * dh;
          const size_t o = (size_t(d) * T + row) * B * H3 + size_t(b) * H3;
          dxp[o + j] = da_r;
          dxp[o + H + j] = da_z;
          dxp[o + 2 * H + j] = da_n;
          dgates[o + j] = da_r;
          dgates[o + H + j] = da_z;
          dgates[o + 2 * H + j] = dg_n;
          WT* g = dgr_i + (size_t(d) * B + b) * H3;
          g[j] = from_f32<WT>(da_r);
          g[H + j] = from_f32<WT>(da_z);
          g[2 * H + j] = from_f32<WT>(dg_n);
        }
      }
    }
    if (last) break;  // no dh_prev past the recurrence's start
    grid.sync();

    // 2. Row phase: dh for the next step, owned units only.
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int k = j0 + lu;
      const WT* w_d = w + size_t(d) * H * H3;
      const WT* g_d = dgr_i + size_t(d) * B * H3;
      // Staging: rows sr, sr + HR, ... (units of W, batch rows of the
      // dgates row), column sc of the chunk.
      const int sr = threadIdx.x / KC, sc = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2] = {0.f, 0.f};
        typename Bits<WT>::type wpre[R_STAGE], gpre[H_STAGE];
        auto fetch = [&](int c0) {
          const int c = c0 + sc;
#pragma unroll
          for (int q = 0; q < R_STAGE; ++q) {
            const int u = j0 + sr + q * HR;
            wpre[q] = (u < H && c < 3 * H) ? ldg_bits(w_d + size_t(u) * H3 + c)
                                           : 0;
          }
#pragma unroll
          for (int q = 0; q < H_STAGE; ++q) {
            const int b = b0 + sr + q * HR;
            // Other blocks wrote this row before the barrier: read it
            // through L2 (.cg), never from a stale L1 line.
            gpre[q] = (b < B && c < 3 * H)
                          ? ldcg_bits(g_d + size_t(b) * H3 + c)
                          : 0;
          }
        };
        fetch(0);
        for (int c0 = 0, buf = 0; c0 < c_pad; c0 += KC, buf ^= 1) {
          float* w_s = smem + buf * BUF;  // [U][KS], c contiguous
          float* g_s = w_s + U * KS;      // [ROWS][KS]
#pragma unroll
          for (int q = 0; q < R_STAGE; ++q)
            w_s[(sr + q * HR) * KS + sc] = bits_f32(wpre[q]);
#pragma unroll
          for (int q = 0; q < H_STAGE; ++q)
            g_s[(sr + q * HR) * KS + sc] = bits_f32(gpre[q]);
          __syncthreads();
          if (c0 + KC < c_pad) fetch(c0 + KC);
          const float* w_k = w_s + lu * KS;
          const float* g_a = g_s + rg * KS;
          const float* g_b = g_s + (rg + RG) * KS;
#pragma unroll 4
          for (int cc = 0; cc < KC; cc += 4) {
            float wk[4], ga[4], gb[4];
            load4(w_k + cc, wk);
            load4(g_a + cc, ga);
            load4(g_b + cc, gb);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[0] = fmaf(ga[e], wk[e], acc[0]);
              acc[1] = fmaf(gb[e], wk[e], acc[1]);
            }
          }
        }
        __syncthreads();  // as in the column phase
        if (k >= H) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = b0 + rg + q * RG;
          if (b >= B) continue;
          const size_t o_h = size_t(d) * BH + size_t(b) * H + k;
          dh_buf[o_h] = de_buf[o_h] + acc[q];
        }
      }
    }
  }
}

// ---- bf16 path: the gate pre-pass and the serial loop of
// csrc/gru_bwd_mma.cuh, part of W resident ----

// Groups of MU units, the stages of a warp's ring, and the chunks of W a
// warp holds for the call when a block has one group. A warp's first
// W_RES chunks of W (10 of 20 or 21 at H=1760: 48% of the group's 338 KB
// slice, 160 KB beside the rings' 64 KB) are copied into shared memory
// once and stay there for the whole call; the rest streams every step.
// On an H100 SXM (k9_variants, three calls) the loop took 14.6-14.9 ms a
// call so, 16.2-16.5 with all of W streamed, and within the same 0.3 ms
// with 3 stages and 8 chunks or 4 and 6, whose order changed from call to
// call: W (37 MB across the card) fits the 50 MB L2 either way, so holding
// part of it saves its copies, not trips to device memory. These 10
// chunks hold all of W at H=800 (8.7 ms a call against 9.3 with 6) and
// more of it at B=1.
constexpr int MU = 32;
constexpr int MS = 2;
constexpr int W_RES = 10;

__global__ void __launch_bounds__(gru_bwd_mma::P_THREADS)
gru_bwd_stream_gates_kernel(const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias,
                            const float* __restrict__ ys,
                            float* __restrict__ pre, int T, int B, int H,
                            int reverse_bits) {
  gru_bwd_mma::gates(w, bias, ys, pre, T, B, H, reverse_bits);
}

__global__ void __launch_bounds__(gru_bwd_mma::M_THREADS, 1)
gru_bwd_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                          const float* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ ys,
                          const float* __restrict__ dy,
                          float* __restrict__ dxp, float* dgates,
                          float* scratch, int D, int T, int B, int H,
                          int reverse_bits) {
  gru_bwd_mma::loop<MU, MS, W_RES>(xp, mask, w, ys, dy, dxp, dgates,
                                   scratch, D, T, B, H, reverse_bits);
}

// The two-phase CUDA-core kernel: f32, or bf16 off the tensor-core path.
template <typename WT>
cudaError_t launch_two_phase(const void* xp, const float* mask,
                             const void* w, const float* bias,
                             const float* ys, const float* dy, float* dxp,
                             float* dgates, float* scratch, int D, int T,
                             int B, int H, int reverse_bits, int device,
                             cudaStream_t stream) {
  auto* kernel = gru_bwd_stream_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = gru_bwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                 THREADS, SMEM_BYTES, D * ((H + U - 1) / U),
                                 device, &blocks);
  if (err != cudaSuccess) return err;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &ys, &dy, &dxp, &dgates,
                  &scratch, &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tensor-core path: the gate pre-pass into dgates, then the serial
// loop over it.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* ys, const float* dy,
                       float* dxp, float* dgates, float* scratch, int D,
                       int T, int B, int H, int reverse_bits, int device,
                       cudaStream_t stream) {
  return gru_bwd_mma::launch(
      gru_bwd_stream_gates_kernel, gru_bwd_stream_mma_kernel, MU,
      gru_bwd_mma::Plan<MU, MS, W_RES>::smem(H), false, xp, mask, w, bias,
      ys, dy, dxp, dgates, scratch, D, T, B, H, reverse_bits, device,
      stream);
}

}  // namespace

extern "C" {

// Floats of scratch that gru_bwd_stream_launch needs, on either path:
// the two-phase kernel keeps dh and its elementwise part (2*D*B*H f32),
// then two round(dgates) rows (2*D*B*3H in the dot dtype; f32 room); the
// tensor-core loop keeps the elementwise part in the first D*B*H and its
// two bf16 rows right after it (4*D*B*H in all).
long long gru_bwd_stream_scratch_floats(int D, int B, int H) {
  return 8LL * D * B * H;
}

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise. A bf16 call runs
// the tensor-core path (two launches) where H % 8 == 0 and w, ys and
// scratch are 16-byte aligned, else the two-phase kernel, as f32 does.
// The calling thread's current device is the same after the call as
// before it.
int gru_bwd_stream_launch(int bf16, const void* xp, const float* mask,
                          const void* w, const float* bias, const float* ys,
                          const float* dy, float* dxp, float* dgates,
                          float* scratch, int D, int T, int B, int H,
                          int reverse_bits, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool mma = bf16 && H % 8 == 0 && gru_bwd_mma::aligned16(w) &&
                   gru_bwd_mma::aligned16(ys) &&
                   gru_bwd_mma::aligned16(scratch);
  if (mma)
    err = launch_mma(xp, mask, w, bias, ys, dy, dxp, dgates, scratch, D, T,
                     B, H, reverse_bits, device, st);
  else if (bf16)
    err = launch_two_phase<__nv_bfloat16>(xp, mask, w, bias, ys, dy, dxp,
                                          dgates, scratch, D, T, B, H,
                                          reverse_bits, device, st);
  else
    err = launch_two_phase<float>(xp, mask, w, bias, ys, dy, dxp, dgates,
                                  scratch, D, T, B, H, reverse_bits, device,
                                  st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_bwd_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
