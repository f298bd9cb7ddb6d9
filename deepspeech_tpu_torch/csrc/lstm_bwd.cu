// LSTM backpropagation through time for Hopper (sm_90a) with W held in
// shared memory: one launch runs the whole reverse time loop of D
// directions.
//
// Replaces the TPU kernel _lstm_bwd_kernel (deepspeech_tpu/ops/
// lstm_pallas.py:147, K13, launched per direction by _lstm_bwd :416 in its
// resident branch). The contract is ops/lstm.py lstm_bwd's docstring:
//   xp [T,B,4H] and w [D,H,4H] in one dtype, bf16|f32 (the dot dtype),
//   mask [T,B] f32, bias [D,4H] f32, ys and cs [D,T,B,H] f32 (the forward's
//   outputs and cell-state tape), dy [D,T,B,H] f32, reverse bit d set for a
//   direction whose forward ran t = T-1..0
//   -> dgates [D,T,B,4H] f32 = (da_i, da_f, da_g, da_o) at every row, the
//      gradient of the gate pre-activations; it is both the TPU kernel's
//      dxp and its dgates, which hold the same values.
// Each direction runs against its own forward order from dh = dc = 0. A
// step recomputes the gates from h_prev (the ys row of the forward's step
// before, 0 at its first step) rounded to the dot dtype, with c_prev from
// the tape one step behind (0 at the first step), applies
// _lstm_elementwise_bwd's math (lstm_pallas.py:54) with dh = carry + dy,
// and carries dc_prev and dh_prev = (1 - m) dh + round(dgates) @ W^T, summed
// in f32.
//
// What bounds it: per step two [B,H] x [H,4H]-sized products (the gate
// recompute and dgates @ W^T), 2 * 2*T*D*B*H*4H FLOPs in all, and the
// inputs and outputs once (dgates dominates: D*T*B*4H*4 bytes). The gate
// recompute reads h_prev from the ys tape and so does not depend on the
// carried dh; only dgates @ W^T lies on the serial chain, but every step
// needs it, so the time is T times one step's latency, far above both
// bounds.
//
// bf16 path (the main path: ds2_small-lstm at D=2, ds2_streaming-lstm at
// D=1, both H=800) where H % 8 == 0 and w, ys and the scratch are 16-byte
// aligned: two launches from one C entry point, both from
// csrc/lstm_bwd_mma.cuh (K15 runs the same two with W streamed):
//  1. lstm_bwd_gates_kernel, the gate pre-pass: one tensor-core GEMM
//     pre[d, row] = round(h_prev(d, row)) @ W[d] + bias[d] for every row at
//     once (M = T*B, N = 4H, K = H: 139 GFLOP a direction at H=800, T'=850,
//     B=32), written into the dgates buffer itself. The recompute leaves
//     the serial chain.
//  2. lstm_bwd_mma_kernel<MU, MS>, the serial loop with W resident: a
//     cooperative grid of D x ceil(H/MU) groups of MU hidden units, one
//     group a block and one block an SM, one grid barrier a step. A group
//     copies its rows of W, [MU, 4H] bf16 (102 KB at MU=16, H=800), into
//     shared memory once a call; a step forms
//     dh[:, own] = (1 - m) dh + round(dg_{i-1}) @ W[own rows, :]^T
//     on mma.sync, 8 warps each taking every 8th 32-deep chunk of the
//     4H-deep product and adding their partial sums in warp order, while
//     a lane streams its 16-byte pieces of the [B, 4H] bf16 dgates row
//     (205 KB at B=32, H=800; double-buffered by step parity) through its
//     warp's MS-stage ring. Then the elementwise step, its activations
//     taken while the first copies are in flight, dc and dh's elementwise
//     part kept by their owning thread in a [D,B,H] f32 scratch each. A
//     step's cost is the busiest SM's: its copy of the dgates row from L2
//     and its warps' chains of mma.sync (3.3 MFLOP an SM a step at MU=16,
//     B=32, H=800), then the grid barrier. The launch takes MU=8 with 6
//     ring stages where D x ceil(H/8) groups fit one an SM (D=1 at H=800:
//     100 groups, 51 KB of W each), else MU=16 with 4 (D=2: 100 groups):
//     deepspeech_tpu_torch/k13_variants.py times the widths and the
//     depths beside the parent's kernel.
//
// f32 path (not the main path; model.dtype=float32) and every other bf16
// call: lstm_bwd_kernel, everything on the CUDA cores with f32 FMAs.
// The design is csrc/gru_bwd.cu's with four gates, and csrc/lstm_fwd.cu's
// tile: D x ceil(H/U) blocks, each owning U hidden units of one direction
// (gate columns j, H+j, 2H+j, 3H+j), holding their [H, 4U] column slice of
// W in shared memory as f32 for the whole sequence, with a grid-wide
// barrier per step (cooperative launch). A block owns all four gates of its
// units, so dc never leaves it: dc sits in shared memory, one value per
// batch row and unit, read and written by the thread that owns that row and
// unit. dh_prev sums over all 4H gate columns: a block forms the partial sum
// over its own 4U columns for every hidden unit k, round(dgates)[:, cols] @
// W[k, cols]^T, writes it to a scratch row of its own, and after the grid
// barrier each block adds the partial sums of its units from every block in
// block order. No atomics: every output is the same bits on every run. The
// scratch is double-buffered by step parity, so one grid barrier a step
// separates a step's writes from its reads and from the next step's writes.
//
// Fit of the f32 tile: gru_bwd.cu's tile with four gates (the [832, 64] f32
// slice, the h_prev chunk, the dgates tile, dh and dc for B=32) needs
// 235,520 bytes at H=800, over the 232,448 a block may have. The h_prev
// chunk is dead once the gate recompute ends and the dgates tile is born
// after it, and with 4U = KC columns both are [32, 68] floats: they share
// one buffer, which gives 226,816 bytes, one block an SM, 100 blocks at
// D=2. ops/gru.py resident_smem_bytes("lstm_bwd") repeats both layouts.
//
// The choice between the two is made before any launch, from the dtype,
// H and the pointers' alignment (lstm_bwd_launch); ops/lstm.py's _bwd_mma
// repeats it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_bwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per block
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 4 * U;         // gate columns a block owns
constexpr int KC = 64;            // h_prev columns staged per chunk
constexpr int STAGE = ROWS * KC / THREADS;  // staged values per thread
constexpr int TS = KC + 4;        // row stride of the shared tile
static_assert(GC == KC, "the dgates tile reuses the h_prev chunk's room");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A value rounded to the dot dtype, kept as f32.
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Shared memory, all f32: W's slice [GC][h_pad + 4] (k contiguous per
// column), one [ROWS][TS] tile (the h_prev chunk, then the dgates tile),
// and dh and dc for every batch row of the block's units.
size_t smem_bytes(int h_pad, int B) {
  return sizeof(float) * (size_t(GC) * (h_pad + 4) + size_t(ROWS) * TS +
                          2 * size_t(B) * U);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const WT* __restrict__ xp, const float* __restrict__ mask,
                const WT* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ ys, const float* __restrict__ cs,
                const float* __restrict__ dy, float* __restrict__ dgates,
                float* partial, int T, int B, int H, int h_pad,
                int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int ws = h_pad + 4;
  float* w_s = smem;                // [GC][ws]
  float* t_s = w_s + GC * ws;       // [ROWS][TS]: h_prev chunk, dgates tile
  float* dh_s = t_s + ROWS * TS;    // [B][U] dh carried into the step
  float* dc_s = dh_s + B * U;       // [B][U] dc carried into the step

  const int nblk = (H + U - 1) / U;
  const int n_dirs = gridDim.x / nblk;
  const int d = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int j0 = blk * U;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int j = j0 + lu;
  const bool rev = (reverse_bits >> d) & 1;
  const size_t H4 = 4 * size_t(H);
  const size_t BH = size_t(B) * H;

  // Column c = g*U + u of w_s holds W[d][:, g*H + j0 + u], k contiguous;
  // rows k >= H and units past H are zero.
  const WT* w_d = w + size_t(d) * H * H4;
  for (int i = threadIdx.x; i < h_pad * GC; i += THREADS) {
    const int k = i / GC, c = i % GC;
    const int g = c / U, u = c % U;
    w_s[c * ws + k] =
        (k < H && j0 + u < H) ? to_f32(w_d[k * H4 + g * H + j0 + u]) : 0.f;
  }
  for (int i = threadIdx.x; i < 2 * B * U; i += THREADS) dh_s[i] = 0.f;
  float b_i = 0.f, b_f = 0.f, b_g = 0.f, b_o = 0.f;
  if (j < H) {
    b_i = bias[d * H4 + j];
    b_f = bias[d * H4 + H + j];
    b_g = bias[d * H4 + 2 * H + j];
    b_o = bias[d * H4 + 3 * H + j];
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const float* ys_d = ys + size_t(d) * T * BH;
  const float* cs_d = cs + size_t(d) * T * BH;
  const float* dy_d = dy + size_t(d) * T * BH;
  float* dg_d = dgates + size_t(d) * T * B * H4;
  const size_t parity_stride = size_t(n_dirs) * nblk * BH;
  const float* w_i = w_s + (0 * U + lu) * ws;
  const float* w_f = w_s + (1 * U + lu) * ws;
  const float* w_g = w_s + (2 * U + lu) * ws;
  const float* w_o = w_s + (3 * U + lu) * ws;

  for (int i = 0; i < T; ++i) {
    // Step i of this direction's BPTT is step T-1-i of its forward scan.
    const int row = rev ? i : T - 1 - i;
    const bool last = i == T - 1;  // the forward's first step: h, c = 0
    const size_t prev = size_t(rev ? row + 1 : row - 1) * BH;
    const float* hp = last ? nullptr : ys_d + prev;
    const float* cp = last ? nullptr : cs_d + prev;
    // This block's partial sums for this step: [B][H].
    float* part = partial + (i & 1) * parity_stride +
                  (size_t(d) * nblk + blk) * BH;
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      float acc[2][4] = {};
      if (hp != nullptr) {
        // The gate recompute, staged as lstm_fwd.cu stages its product:
        // the next chunk's loads in flight while this one is multiplied.
        float pre[STAGE];
        auto fetch = [&](int k0) {
#pragma unroll
          for (int q = 0; q < STAGE; ++q) {
            const int e = threadIdx.x + q * THREADS;
            const int b = b0 + e / KC, k = k0 + e % KC;
            pre[q] = (b < B && k < H) ? __ldg(hp + size_t(b) * H + k) : 0.f;
          }
        };
        fetch(0);
        for (int k0 = 0; k0 < h_pad; k0 += KC) {
          __syncthreads();  // the last chunk's or tile's readers are done
#pragma unroll
          for (int q = 0; q < STAGE; ++q) {
            const int e = threadIdx.x + q * THREADS;
            t_s[(e / KC) * TS + e % KC] = round_to<WT>(pre[q]);
          }
          __syncthreads();
          if (k0 + KC < h_pad) fetch(k0 + KC);
          const float* h_a = t_s + rg * TS;
          const float* h_b = t_s + (rg + RG) * TS;
#pragma unroll 2
          for (int kk = 0; kk < KC; kk += 4) {
            float vi[4], vf[4], vg[4], vo[4], xa[4], xb[4];
            load4(w_i + k0 + kk, vi);
            load4(w_f + k0 + kk, vf);
            load4(w_g + k0 + kk, vg);
            load4(w_o + k0 + kk, vo);
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
        __syncthreads();  // the last chunk's readers are done: the tile
                          // below overwrites it
      }
      // The elementwise BPTT step for rows rg and rg + RG, unit j.
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = rg + q * RG;
        const int b = b0 + r;
        float g_i = 0.f, g_f = 0.f, g_g = 0.f, g_o = 0.f;
        if (b < B && j < H) {
          const float c_prev = cp ? __ldg(cp + size_t(b) * H + j) : 0.f;
          const WT* x = xp + (size_t(row) * B + b) * H4;
          const float ig = sigmoid(to_f32(x[j]) + (acc[q][0] + b_i));
          const float fg =
              sigmoid((to_f32(x[H + j]) + (acc[q][1] + b_f)) + 1.f);
          const float gg = tanhf(to_f32(x[2 * H + j]) + (acc[q][2] + b_g));
          const float og = sigmoid(to_f32(x[3 * H + j]) + (acc[q][3] + b_o));
          const float tc = tanhf(fg * c_prev + ig * gg);
          const float m = mask[size_t(row) * B + b];
          const float dh =
              dh_s[b * U + lu] + dy_d[size_t(row) * BH + size_t(b) * H + j];
          const float dc_in = dc_s[b * U + lu];
          const float dh_mid = m * dh;
          const float d_o = dh_mid * tc;
          const float dc_pre = m * dc_in + dh_mid * og * (1.f - tc * tc);
          const float da_i = dc_pre * gg * ig * (1.f - ig);
          const float da_f = dc_pre * c_prev * fg * (1.f - fg);
          const float da_g = dc_pre * ig * (1.f - gg * gg);
          const float da_o = d_o * og * (1.f - og);
          // dh_s now holds dh_prev's elementwise part; the partial sums
          // are added to it after the grid barrier.
          dh_s[b * U + lu] = (1.f - m) * dh;
          dc_s[b * U + lu] = dc_pre * fg + (1.f - m) * dc_in;
          float* o = dg_d + (size_t(row) * B + b) * H4;
          o[j] = da_i;
          o[H + j] = da_f;
          o[2 * H + j] = da_g;
          o[3 * H + j] = da_o;
          g_i = round_to<WT>(da_i);
          g_f = round_to<WT>(da_f);
          g_g = round_to<WT>(da_g);
          g_o = round_to<WT>(da_o);
        }
        t_s[r * TS + lu] = g_i;
        t_s[r * TS + U + lu] = g_f;
        t_s[r * TS + 2 * U + lu] = g_g;
        t_s[r * TS + 3 * U + lu] = g_o;
      }
      if (last) continue;  // no dh_prev past the recurrence's start
      __syncthreads();  // the dgates tile is complete
      // Partial sums of round(dgates) @ W^T over this block's columns,
      // for every hidden unit k: thread k holds W[k, cols] in registers.
      const int rows = min(ROWS, B - b0);
      for (int k = threadIdx.x; k < H; k += THREADS) {
        float wk[GC];
#pragma unroll
        for (int c = 0; c < GC; ++c) wk[c] = w_s[c * ws + k];
        for (int r = 0; r < rows; ++r) {
          const float* g = t_s + r * TS;
          float sum = 0.f;
#pragma unroll
          for (int c = 0; c < GC; c += 4) {
            float gv[4];
            load4(g + c, gv);
            sum = fmaf(gv[0], wk[c], sum);
            sum = fmaf(gv[1], wk[c + 1], sum);
            sum = fmaf(gv[2], wk[c + 2], sum);
            sum = fmaf(gv[3], wk[c + 3], sum);
          }
          part[size_t(b0 + r) * H + k] = sum;
        }
      }
      __syncthreads();  // the tile's readers are done before the next pass
    }
    if (last) break;
    grid.sync();
    // dh carried into the next step: the elementwise part plus the
    // partial sums of every block of this direction, in block order.
    // Other blocks wrote them before the barrier: read through L2 (.cg).
    const float* pd = partial + (i & 1) * parity_stride +
                      size_t(d) * nblk * BH;
    for (int e = threadIdx.x; e < B * U; e += THREADS) {
      const int b = e / U, u = e % U;
      if (j0 + u >= H) continue;
      const float* p = pd + size_t(b) * H + j0 + u;
      float dot = 0.f;
#pragma unroll 5
      for (int q = 0; q < nblk; ++q) dot += __ldcg(p + size_t(q) * BH);
      dh_s[e] += dot;
    }
    __syncthreads();
  }
}

template <typename WT>
cudaError_t launch(const void* xp, const float* mask, const void* w,
                   const float* bias, const float* ys, const float* cs,
                   const float* dy, float* dgates, float* partial, int D,
                   int T, int B, int H, int reverse_bits, int device,
                   cudaStream_t stream) {
  auto* kernel = lstm_bwd_kernel<WT>;
  const int h_pad = (H + KC - 1) / KC * KC;
  const size_t smem = smem_bytes(h_pad, B);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int groups = D * ((H + U - 1) / U);
  int blocks = 0;
  err = lstm_bwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                  THREADS, smem, groups, device, &blocks);
  if (err != cudaSuccess) return err;
  // grid.sync() needs every block resident at once.
  if (blocks < groups) return cudaErrorCooperativeLaunchTooLarge;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &ys, &cs, &dy, &dgates,
                  &partial, &T, &B, &H, const_cast<int*>(&h_pad),
                  &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: the gate pre-pass and the serial loop of
// csrc/lstm_bwd_mma.cuh, W resident ----

// The group widths and the stages of a warp's ring of dgates-row pieces:
// MU_NARROW units and MS_NARROW stages where D x ceil(H/MU_NARROW) groups
// fit one an SM, else MU_WIDE and MS_WIDE.
constexpr int MU_NARROW = 8;
constexpr int MS_NARROW = 6;
constexpr int MU_WIDE = 16;
constexpr int MS_WIDE = 4;

__global__ void __launch_bounds__(lstm_bwd_mma::P_THREADS)
lstm_bwd_gates_kernel(const __nv_bfloat16* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ ys, float* __restrict__ pre,
                      int T, int B, int H, int reverse_bits) {
  lstm_bwd_mma::gates(w, bias, ys, pre, T, B, H, reverse_bits);
}

template <int MU, int MS>
__global__ void __launch_bounds__(lstm_bwd_mma::M_THREADS, 1)
lstm_bwd_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                    const float* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ cs,
                    const float* __restrict__ dy, float* dgates,
                    float* scratch, int D, int T, int B, int H,
                    int reverse_bits) {
  lstm_bwd_mma::loop<MU, MS, true>(xp, mask, w, cs, dy, dgates, scratch, D,
                                   T, B, H, reverse_bits);
}

template <int MU, int MS>
size_t loop_smem(int H) {
  return lstm_bwd_mma::Plan<MU, MS, true>::smem(H);
}

// The two launches at the width the card's SM count gives.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* ys, const float* cs,
                       const float* dy, float* dgates, float* scratch, int D,
                       int T, int B, int H, int reverse_bits, int device,
                       cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool narrow = D * ((H + MU_NARROW - 1) / MU_NARROW) <= sms;
  return lstm_bwd_mma::launch(
      lstm_bwd_gates_kernel,
      narrow ? lstm_bwd_mma_kernel<MU_NARROW, MS_NARROW>
             : lstm_bwd_mma_kernel<MU_WIDE, MS_WIDE>,
      narrow ? MU_NARROW : MU_WIDE,
      narrow ? loop_smem<MU_NARROW, MS_NARROW>(H)
             : loop_smem<MU_WIDE, MS_WIDE>(H),
      true, xp, mask, w, bias, ys, cs, dy, dgates, scratch, D, T, B, H,
      reverse_bits, device, stream);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Floats of scratch that lstm_bwd_launch needs on the CUDA-core path: the
// partial sums [2][D][ceil(H/16)][B][H].
long long lstm_bwd_scratch_floats(int D, int B, int H) {
  return 2LL * D * ((H + U - 1) / U) * B * H;
}

// Floats of scratch that lstm_bwd_launch needs on the tensor-core path: dh
// and dc [D,B,H] f32 each, then two round(dgates) rows [2,D,B,4H] bf16.
long long lstm_bwd_mma_scratch_floats(int D, int B, int H) {
  return 6LL * D * B * H;
}

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise. A bf16 call runs
// the tensor-core path (two launches; lstm_bwd_mma_scratch_floats of
// scratch) where H % 8 == 0 and w, ys and scratch are 16-byte aligned,
// else the CUDA-core kernel, as f32 does (lstm_bwd_scratch_floats). The
// calling thread's current device is the same after the call as before it.
int lstm_bwd_launch(int bf16, const void* xp, const float* mask,
                    const void* w, const float* bias, const float* ys,
                    const float* cs, const float* dy, float* dgates,
                    float* scratch, int D, int T, int B, int H,
                    int reverse_bits, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool mma = bf16 && H % 8 == 0 && aligned16(w) && aligned16(ys) &&
                   aligned16(scratch);
  if (mma)
    err = launch_mma(xp, mask, w, bias, ys, cs, dy, dgates, scratch, D, T, B,
                     H, reverse_bits, device, st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, w, bias, ys, cs, dy, dgates,
                                scratch, D, T, B, H, reverse_bits, device, st);
  else
    err = launch<float>(xp, mask, w, bias, ys, cs, dy, dgates, scratch, D, T,
                        B, H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* lstm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
