// LSTM backpropagation through time for Hopper (sm_90a) with W streamed
// from global memory, for the sizes whose W does not fit the grid's shared
// memory (ds2_full: H=1760, D=2, W 24.8 MB a direction in bf16).
//
// Replaces the TPU kernel _lstm_bwd_kernel_blocked (deepspeech_tpu/ops/
// lstm_pallas.py:174, K15, launched by _lstm_bwd :464 on a (T, n_blocks)
// grid of [H, c] column blocks), which recomputes a step's gates block by
// block, accumulates the previous step's dgates @ W^T on the same block
// stream, and fires the elementwise BPTT on the last block. The contract
// is ops/lstm.py lstm_bwd's docstring, as for csrc/lstm_bwd.cu:
//   xp [T,B,4H] and w [D,H,4H] in one dtype, bf16|f32 (the dot dtype),
//   mask [T,B] f32, bias [D,4H] f32, h0 and c0 [D,B,H] f32 or NULL
//   (zeros), ys and cs [D,T,B,H] f32 (the forward's outputs and cell-state
//   tape), dy [D,T,B,H] f32, dcfin [D,B,H] f32 or NULL (zeros: the
//   gradient on the final cell state), reverse bit d set for a direction
//   whose forward ran t = T-1..0
//   -> dgates [D,T,B,4H] f32 = (da_i, da_f, da_g, da_o) at every row (the
//      TPU kernel's dxp and dgates, which hold the same values), and dh0
//      and dc0 [D,B,H] f32 where they are not NULL.
// Each direction runs against its own forward order from dh = 0 and
// dc = dcfin; a step recomputes the gates from h_prev (the ys row of the
// forward's step before, h0 at its first step) rounded to the dot dtype,
// with c_prev from the tape (c0 at the first step), applies
// _lstm_elementwise_bwd's math (lstm_pallas.py:54) with dh = carry + dy,
// and carries dc_prev and dh_prev = (1 - m) dh + round(dgates) @ W^T in
// f32; the first step's are dc0 and dh0.
//
// What bounds it: two [T*B,H] x [H,4H]-sized products per direction, the
// gate recompute and round(dgates) @ W^T (1.35 TFLOP each at ds2_full's
// D=2, B=32, T'=850), and dgates written once (1.53 GB). The gate
// recompute reads h_prev from the forward's tape and so does not depend
// on the carried dh: it is one parallel GEMM (1.4 ms at the bf16 peak),
// whose tiles re-read their operands from L2. Only round(dgates) @ W^T
// lies on the serial chain: T steps of a [B,4H] x [4H,U] product per group
// of U units. A step's cost is that of the busiest SM: it moves W's
// [U,4H] rows and the [B,4H] dgates row (0.9 MB at U=32, B=32) from L2
// through shared memory into 14.4 MFLOP of mma.sync, then waits at one
// grid barrier. Across the card that is 99 MB a step, W once, but the
// card's L2 in aggregate is not the limit: one direction, on half the
// SMs, is barely faster a step. deepspeech_tpu_torch/k15_ablation.py
// times the parts.
//
// bf16 path (the main path), two launches from one C entry point, both
// from csrc/lstm_bwd_mma.cuh (K13 runs the same two with W resident):
//  1. lstm_bwd_stream_gates_kernel, the gate pre-pass: one tensor-core GEMM
//     pre[d, row] = round(h_prev(d, row)) @ W[d] + bias[d] for every row at
//     once (M = T*B, N = 4H, K = H), written into the dgates buffer itself.
//  2. lstm_bwd_stream_mma_kernel<CARRY>, the serial loop with W streamed
//     (CARRY where the call has a carry, as in csrc/lstm_bwd.cu): a
//     cooperative, persistent grid over D x ceil(H/32) groups of MU=32
//     hidden units, one group a block and one block an SM (110 groups at
//     ds2_full), one grid barrier a step. A step forms
//     dh[:, own] = elementwise part + round(dg_{i-1}) @ W[own rows, :]^T
//     on mma.sync, 8 warps each taking every 8th 32-deep chunk of the
//     4H-deep product; a lane stages its 16-byte pieces of the dgates row
//     and of W's rows with cp.async into its warp's own MS=4-stage ring.
//     W crosses L2 once a step, by rows; h_prev leaves the loop.
//     U=32 rather than 16: 110 groups on 110 SMs read 0.9 MB each a step,
//     where 220 groups would put two on 88 SMs, 1.35 MB each; 24 or 40
//     units fill no more SMs evenly.
//
// f32 path (not the main path; model.dtype=float32) and a bf16 call whose H
// is not a multiple of 4 or whose pointers are not 16-byte aligned:
// lstm_bwd_stream_kernel, two phases a step on the CUDA cores (no TF32), as
// csrc/gru_bwd_stream.cu (K9) does with three gates. A column phase streams
// each group's [H, 4U] column slice of W to recompute its gates and takes
// the elementwise step; after a grid barrier, a row phase streams W's rows
// of its own units and the whole round(dgates) row to form dh_prev; each
// stages KC-wide chunks through shared memory as f32, two buffers deep,
// register prefetch of raw bits; groups of U=16 units, at most one block per
// group.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_bwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per group
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 4 * U;         // gate columns of a group
constexpr int KC = 64;            // chunk width (W rows or gate columns)
constexpr int KS = KC + 4;        // chunk row stride (16-byte aligned rows)
// Column phase: a chunk of W is staged by every thread, each owning one of
// the group's columns and every KR-th row of the chunk (one base pointer
// and one stride keep the registers few).
constexpr int KR = THREADS / GC;              // 4
constexpr int W_STAGE = KC / KR;              // W values per thread
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
lstm_bwd_stream_kernel(const WT* __restrict__ xp,
                       const float* __restrict__ mask,
                       const WT* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ h0,
                       const float* __restrict__ c0,
                       const float* __restrict__ ys,
                       const float* __restrict__ cs,
                       const float* __restrict__ dy,
                       const float* __restrict__ dcfin,
                       float* __restrict__ dgates, float* __restrict__ dh0,
                       float* __restrict__ dc0, float* scratch, int D,
                       int T, int B, int H, int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int nblk = (H + U - 1) / U;
  const int groups = D * nblk;
  const int h_pad = (H + KC - 1) / KC * KC;
  const int c_pad = (4 * H + KC - 1) / KC * KC;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const size_t H4 = 4 * size_t(H);
  const size_t BH = size_t(B) * H;
  // Scratch: dh and dc, each [D][B][H] f32 and touched only by the thread
  // that owns the unit and row; then round(dgates) rows [2][D][B][4H] in
  // the dot dtype.
  float* dh_buf = scratch;
  float* dc_buf = dh_buf + size_t(D) * BH;
  WT* dgr = reinterpret_cast<WT*>(dc_buf + size_t(D) * BH);
  cg::grid_group grid = cg::this_grid();

  for (int i = 0; i < T; ++i) {
    const bool last = i == T - 1;  // the forward's first step: h0, c0
    WT* dgr_i = dgr + size_t(i & 1) * D * B * H4;

    // 1. Column phase.
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int j = j0 + lu;
      const bool rev = (reverse_bits >> d) & 1;
      // Step i of this direction's BPTT is step T-1-i of its forward.
      const int row = rev ? i : T - 1 - i;
      const WT* w_d = w + size_t(d) * H * H4;
      const size_t prev =
          size_t(d) * T * BH + size_t(rev ? row + 1 : row - 1) * BH;
      const float* hp = !last ? ys + prev
                        : h0 != nullptr ? h0 + size_t(d) * BH
                                        : nullptr;
      const float* cp = !last ? cs + prev
                        : c0 != nullptr ? c0 + size_t(d) * BH
                                        : nullptr;
      // This thread's W column when it stages W (gate wc / U, unit
      // j0 + wc % U, rows wk, wk + KR, ...) and its h_prev rows and column.
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_live = j0 + wc % U < H;
      const WT* w_col = w_d + (wc / U) * H + j0 + wc % U;
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][4] = {};
        if (hp != nullptr) {
          typename Bits<WT>::type wpre[W_STAGE];
          float hpre[H_STAGE];
          auto fetch = [&](int k0) {
#pragma unroll
            for (int q = 0; q < W_STAGE; ++q) {
              const int k = k0 + wk + q * KR;
              wpre[q] = (w_live && k < H) ? ldg_bits(w_col + size_t(k) * H4)
                                          : 0;
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
            // Buffer `buf` was last read two chunks ago, before the
            // previous chunk's barrier: it is free to fill.
            float* w_s = smem + buf * BUF;  // [GC][KS], k contiguous
            float* h_s = w_s + GC * KS;     // [ROWS][KS]
#pragma unroll
            for (int q = 0; q < W_STAGE; ++q)
              w_s[wc * KS + wk + q * KR] = bits_f32(wpre[q]);
#pragma unroll
            for (int q = 0; q < H_STAGE; ++q)
              h_s[(hr + q * HR) * KS + hk] = round_to<WT>(hpre[q]);
            __syncthreads();
            if (k0 + KC < h_pad) fetch(k0 + KC);
            const float* w_i = w_s + (0 * U + lu) * KS;
            const float* w_f = w_s + (1 * U + lu) * KS;
            const float* w_g = w_s + (2 * U + lu) * KS;
            const float* w_o = w_s + (3 * U + lu) * KS;
            const float* h_a = h_s + rg * KS;
            const float* h_b = h_s + (rg + RG) * KS;
#pragma unroll 2
            for (int kk = 0; kk < KC; kk += 4) {
              float vi[4], vf[4], vg[4], vo[4], xa[4], xb[4];
              load4(w_i + kk, vi);
              load4(w_f + kk, vf);
              load4(w_g + kk, vg);
              load4(w_o + kk, vo);
              load4(h_a + kk, xa);
              load4(h_b + kk, xb);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc[0][0] = fmaf(xa[e], vi[e], acc[0][0]);
                acc[0][1] = fmaf(xa[e], vf[e], acc[0][1]);
                acc[0][2] = fmaf(xa[e], vg[e], acc[0][2]);
                acc[0][3] = fmaf(xa[e], vo[e], acc[0][3]);
                acc[1][0] = fmaf(xb[e], vi[e], acc[1][0]);
                acc[1][1] = fmaf(xb[e], vf[e], acc[1][1]);
                acc[1][2] = fmaf(xb[e], vg[e], acc[1][2]);
                acc[1][3] = fmaf(xb[e], vo[e], acc[1][3]);
              }
            }
          }
          // The next pass or group fills buffer 0 at once: when the last
          // chunk used it (an odd chunk count), its readers finish first.
          __syncthreads();
        }
        if (j >= H) continue;
        const float b_i = bias[d * H4 + j];
        const float b_f = bias[d * H4 + H + j];
        const float b_g = bias[d * H4 + 2 * H + j];
        const float b_o = bias[d * H4 + 3 * H + j];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = b0 + rg + q * RG;
          if (b >= B) continue;
          const size_t at = size_t(b) * H + j;
          const float c_prev = cp ? __ldg(cp + at) : 0.f;
          const WT* x = xp + (size_t(row) * B + b) * H4;
          const float ig = sigmoid(to_f32(x[j]) + (acc[q][0] + b_i));
          const float fg =
              sigmoid((to_f32(x[H + j]) + (acc[q][1] + b_f)) + 1.f);
          const float gg = tanhf(to_f32(x[2 * H + j]) + (acc[q][2] + b_g));
          const float og = sigmoid(to_f32(x[3 * H + j]) + (acc[q][3] + b_o));
          const float tc = tanhf(fg * c_prev + ig * gg);
          const float m = mask[size_t(row) * B + b];
          const size_t o_h = size_t(d) * BH + at;
          const float dh = (i > 0 ? dh_buf[o_h] : 0.f) +
                           dy[size_t(d) * T * BH + size_t(row) * BH + at];
          const float dc_in = i > 0             ? dc_buf[o_h]
                              : dcfin != nullptr ? dcfin[o_h]
                                                 : 0.f;
          const float dh_mid = m * dh;
          const float d_o = dh_mid * tc;
          const float dc_pre = m * dc_in + dh_mid * og * (1.f - tc * tc);
          const float da_i = dc_pre * gg * ig * (1.f - ig);
          const float da_f = dc_pre * c_prev * fg * (1.f - fg);
          const float da_g = dc_pre * ig * (1.f - gg * gg);
          const float da_o = d_o * og * (1.f - og);
          dh_buf[o_h] = (1.f - m) * dh;  // dh_prev's elementwise part
          // The first step's dc_prev is dc0.
          (last && dc0 != nullptr ? dc0 : dc_buf)[o_h] =
              dc_pre * fg + (1.f - m) * dc_in;
          float* o = dgates + ((size_t(d) * T + row) * B + b) * H4;
          o[j] = da_i;
          o[H + j] = da_f;
          o[2 * H + j] = da_g;
          o[3 * H + j] = da_o;
          WT* g = dgr_i + (size_t(d) * B + b) * H4;
          g[j] = from_f32<WT>(da_i);
          g[H + j] = from_f32<WT>(da_f);
          g[2 * H + j] = from_f32<WT>(da_g);
          g[3 * H + j] = from_f32<WT>(da_o);
        }
      }
    }
    // No dh_prev past the recurrence's start unless dh0 asks for it.
    if (last && dh0 == nullptr) break;
    grid.sync();

    // 2. Row phase: dh for the next step, owned units only.
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int k = j0 + lu;
      const WT* w_d = w + size_t(d) * H * H4;
      const WT* g_d = dgr_i + size_t(d) * B * H4;
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
            wpre[q] = (u < H && c < 4 * H) ? ldg_bits(w_d + size_t(u) * H4 + c)
                                           : 0;
          }
#pragma unroll
          for (int q = 0; q < H_STAGE; ++q) {
            const int b = b0 + sr + q * HR;
            // Other blocks wrote this row before the barrier: read it
            // through L2 (.cg), never from a stale L1 line.
            gpre[q] = (b < B && c < 4 * H)
                          ? ldcg_bits(g_d + size_t(b) * H4 + c)
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
          (last ? dh0 : dh_buf)[o_h] = dh_buf[o_h] + acc[q];
        }
      }
    }
  }
}

// ---- bf16 path: the gate pre-pass and the serial loop of
// csrc/lstm_bwd_mma.cuh, W streamed ----

// Groups of MU=32 units, MS=4 stages of the rings (see the top of this
// file for why 32).
constexpr int MU = 32;
constexpr int MS = 4;

__global__ void __launch_bounds__(lstm_bwd_mma::P_THREADS)
lstm_bwd_stream_gates_kernel(const __nv_bfloat16* __restrict__ w,
                             const float* __restrict__ bias,
                             const float* __restrict__ h0,
                             const float* __restrict__ ys,
                             float* __restrict__ pre, int T, int B, int H,
                             int reverse_bits) {
  lstm_bwd_mma::gates(w, bias, h0, ys, pre, T, B, H, reverse_bits);
}

// CARRY: the loop reads c0 and dcfin and writes dh0 and dc0; without it
// the loop from zeros.
template <bool CARRY>
__global__ void __launch_bounds__(lstm_bwd_mma::M_THREADS, 1)
lstm_bwd_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                           const float* __restrict__ mask,
                           const __nv_bfloat16* __restrict__ w,
                           const float* __restrict__ c0,
                           const float* __restrict__ cs,
                           const float* __restrict__ dy,
                           const float* __restrict__ dcfin, float* dgates,
                           float* __restrict__ dh0, float* __restrict__ dc0,
                           float* scratch, int D, int T, int B, int H,
                           int reverse_bits) {
  lstm_bwd_mma::loop<MU, MS, false, CARRY>(xp, mask, w, c0, cs, dy, dcfin,
                                           dgates, dh0, dc0, scratch, D, T,
                                           B, H, reverse_bits);
}

// The two-phase CUDA-core kernel: f32, or bf16 off the tensor-core path.
template <typename WT>
cudaError_t launch_two_phase(const void* xp, const float* mask,
                             const void* w, const float* bias,
                             const float* h0, const float* c0,
                             const float* ys, const float* cs,
                             const float* dy, const float* dcfin,
                             float* dgates, float* dh0, float* dc0,
                             float* scratch, int D, int T, int B, int H,
                             int reverse_bits, int device,
                             cudaStream_t stream) {
  auto* kernel = lstm_bwd_stream_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = lstm_bwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                  THREADS, SMEM_BYTES,
                                  D * ((H + U - 1) / U), device, &blocks);
  if (err != cudaSuccess) return err;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t,     &bias, &h0, &c0, &ys,
                  &cs,   &dy,   &dcfin,   &dgates, &dh0, &dc0, &scratch,
                  &D,    &T,    &B,       &H,    &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of scratch that lstm_bwd_stream_launch needs: dh and dc (2*D*B*H)
// and two round(dgates) rows (2*D*B*4H, held in the dot dtype; f32 room
// either way).
long long lstm_bwd_stream_scratch_floats(int D, int B, int H) {
  return 10LL * D * B * H;
}

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise. h0, c0 and dcfin
// (NULL: zeros) and dh0 and dc0 (NULL: not formed) are [D,B,H] f32; with
// all five NULL the call is the BPTT from zeros, bit for bit. A bf16 call
// runs the tensor-core path (two launches) where H % 4 == 0 and w, ys, h0
// and scratch are 16-byte aligned, else the two-phase kernel, as f32
// does. The calling thread's current device is the same after the call as
// before it.
int lstm_bwd_stream_launch(int bf16, const void* xp, const float* mask,
                           const void* w, const float* bias, const float* h0,
                           const float* c0, const float* ys, const float* cs,
                           const float* dy, const float* dcfin,
                           float* dgates, float* dh0, float* dc0,
                           float* scratch, int D, int T, int B, int H,
                           int reverse_bits, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool mma = bf16 && H % 4 == 0 && aligned16(w) && aligned16(ys) &&
                   aligned16(h0) && aligned16(scratch);
  if (mma)
    err = lstm_bwd_mma::launch(
        lstm_bwd_stream_gates_kernel,
        lstm_bwd_mma::carries(h0, c0, dcfin, dh0, dc0)
            ? lstm_bwd_stream_mma_kernel<true>
            : lstm_bwd_stream_mma_kernel<false>,
        MU, lstm_bwd_mma::Plan<MU, MS, false>::smem(H), false, xp, mask, w,
        bias, h0, c0, ys, cs, dy, dcfin, dgates, dh0, dc0, scratch, D, T, B,
        H, reverse_bits, device, st);
  else if (bf16)
    err = launch_two_phase<__nv_bfloat16>(xp, mask, w, bias, h0, c0, ys, cs,
                                          dy, dcfin, dgates, dh0, dc0,
                                          scratch, D, T, B, H, reverse_bits,
                                          device, st);
  else
    err = launch_two_phase<float>(xp, mask, w, bias, h0, c0, ys, cs, dy,
                                  dcfin, dgates, dh0, dc0, scratch, D, T, B,
                                  H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* lstm_bwd_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
