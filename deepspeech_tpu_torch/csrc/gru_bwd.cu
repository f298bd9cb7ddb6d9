// GRU backpropagation through time for Hopper (sm_90a): one launch runs
// the whole reverse time loop of D directions.
//
// Replaces the TPU kernels _gru_bwd_kernel (deepspeech_tpu/ops/
// rnn_pallas.py:113, D=1, K7) and _bigru_bwd_kernel (rnn_pallas.py:211,
// both directions of a BiGRU, D=2, K5). The contract is ops/gru.py
// gru_bwd's docstring:
//   xp [T,B,3H] and w [D,H,3H] in one dtype, bf16|f32 (the dot dtype),
//   mask [T,B] f32, bias [D,3H] f32, h0 [D,B,H] f32 or NULL (zeros: the
//   state the forward started from), ys [D,T,B,H] f32 (the forward's
//   outputs), dy [D,T,B,H] f32, reverse bit d set for a direction whose
//   forward ran t = T-1..0
//   -> dxp [D,T,B,3H] f32 = (da_r, da_z, da_n) and dgates [D,T,B,3H] f32
//      = (da_r, da_z, dg_n) at every row, and, where dh0 [D,B,H] f32 is
//      not NULL, the gradient of h0 there.
// Each direction runs against its own forward order, starting from
// dh = 0. A step recomputes the gates from h_prev (the ys row the
// forward wrote one step earlier, h0 at the forward's first step)
// rounded to the dot dtype, applies _gru_bwd_elt's math
// (rnn_pallas.py:189) with dh = carry + dy, and carries dh_prev = the
// elementwise terms + round(dgates) @ W^T, summed in f32; the first
// step's dh_prev, formed the same way, is dh0. The gradient on the final
// state needs no argument: a GRU's carry out is ys at its scan's last row
// (a masked frame holds h), so it arrives in dy there.
//
// What bounds it: per step two [B,H] x [H,3H]-sized products (the gate
// recompute and dgates @ W^T), 2 * 2*T*D*B*H*3H FLOPs in all, and the
// inputs and outputs once (dxp and dgates dominate: 2*D*T*B*3H*4 bytes).
// The gate recompute reads h_prev from the ys tape and so does not depend
// on the carried dh; only dgates @ W^T lies on the serial chain, but every
// step needs it, so the time is T times one step's latency, far above
// both bounds.
//
// bf16 path (the main path: ds2_small at D=2, ds2_streaming at D=1, both
// H=800) where H % 8 == 0 and w, ys and the scratch are 16-byte aligned:
// two launches from one C entry point, both from csrc/gru_bwd_mma.cuh (K9
// runs the same two with W partly streamed):
//  1. gru_bwd_gates_kernel, the gate pre-pass: one tensor-core GEMM
//     pre[d, row] = round(h_prev(d, row)) @ W[d] + bias[d] for every row at
//     once (M = T*B, N = 3H, K = H: 104 GFLOP a direction at H=800,
//     T'=850, B=32), written into the dgates buffer itself. The recompute
//     leaves the serial chain.
//  2. gru_bwd_mma_kernel<MU, MS>, the serial loop with W resident: a
//     cooperative grid of D x ceil(H/MU) groups of MU hidden units, one
//     group a block and one block an SM, one grid barrier a step. A group
//     copies its rows of W, [MU, 3H] bf16 (77 KB at MU=16, H=800), into
//     shared memory once a call; a step forms
//     dh[:, own] = dh_mid z + (1 - m) dh + round(dg_{i-1}) @ W[own rows, :]^T
//     on mma.sync, 8 warps each taking every 8th 32-deep chunk of the
//     3H-deep product and adding their partial sums in warp order, while a
//     lane streams its 16-byte pieces of the [B, 3H] bf16 dgates row (154
//     KB at B=32, H=800; double-buffered by step parity) through its
//     warp's MS-stage ring. Then the elementwise step, its activations
//     taken while the first copies are in flight, dh's elementwise part
//     kept by its owning thread in a [D,B,H] f32 scratch. The launch takes
//     MU=8 with MS_NARROW ring stages where D x ceil(H/8) groups fit one an
//     SM (D=1 at H=800: 100 groups, 38 KB of W each), else MU=16 with
//     MS_WIDE (D=2: 100 groups): deepspeech_tpu_torch/k7_variants.py times
//     the widths and the depths beside the parent's kernel.
//
// f32 path (not the main path; model.dtype=float32) and every other bf16
// call: gru_bwd_kernel, everything on the CUDA cores with f32 FMAs. The
// design is gru_fwd.cu's: D x ceil(H/U) blocks, each owning U hidden
// units of one direction, holding their [H, 3U] column slice of W in
// shared memory for the whole sequence, with a grid-wide barrier per
// step (cooperative launch). The gate recompute reads h_prev from ys as
// the forward kernel reads it. For dh_prev a block has its own units'
// dgates [B, 3U] and its own columns of W, so it forms the partial sum
// over its 3U columns for every hidden unit k, dgates[:, cols] @
// W[k, cols]^T, and writes it to a scratch row of its own; after the grid
// barrier each block adds the partial sums of its units from every block
// in block order. No atomics: dh, and so every output, is the same bits
// on every run. The scratch is double-buffered by step parity, so one
// grid barrier per step separates a step's writes from its reads and
// from the next step's writes.
//
// The choice between the two is made before any launch, from the dtype,
// H and the pointers' alignment (gru_bwd_launch); ops/gru.py's _bwd_mma
// repeats it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_bwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per block
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int KC = 64;            // h_prev columns staged per chunk
constexpr int STAGE = ROWS * KC / THREADS;  // staged values per thread
constexpr int GC = 3 * U;         // gate columns a block owns
constexpr int HS = KC + 4;        // h_prev chunk row stride
constexpr int GS = GC + 4;        // dgates tile row stride

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

// W's slice and the staged h_prev as f32, as in gru_fwd.cu; the dgates
// tile, and the carried dh and its elementwise part for every batch row
// of the block's units.
size_t smem_bytes(int h_pad, int B) {
  return sizeof(float) * (size_t(GC) * (h_pad + 4) + size_t(ROWS) * HS +
                          size_t(ROWS) * GS + 2 * size_t(B) * U);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const WT* __restrict__ xp, const float* __restrict__ mask,
               const WT* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ h0, const float* __restrict__ ys,
               const float* __restrict__ dy, float* __restrict__ dxp,
               float* __restrict__ dgates, float* __restrict__ dh0,
               float* partial, int T, int B, int H, int h_pad,
               int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int ws = h_pad + 4;
  float* w_s = smem;                // [GC][ws]
  float* h_s = w_s + GC * ws;       // [ROWS][HS]
  float* g_s = h_s + ROWS * HS;     // [ROWS][GS]
  float* dh_s = g_s + ROWS * GS;    // [B][U] dh carried into the step
  float* de_s = dh_s + B * U;       // [B][U] its elementwise part

  const int nblk = (H + U - 1) / U;
  const int n_dirs = gridDim.x / nblk;
  const int d = blockIdx.x / nblk;
  const int blk = blockIdx.x % nblk;
  const int j0 = blk * U;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int j = j0 + lu;
  const bool rev = (reverse_bits >> d) & 1;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;

  // Column c = g*U + u of w_s holds W[d][:, g*H + j0 + u], k contiguous;
  // rows k >= H and units past H are zero.
  const WT* w_d = w + d * H * H3;
  for (int i = threadIdx.x; i < h_pad * GC; i += THREADS) {
    const int k = i / GC, c = i % GC;
    const int g = c / U, u = c % U;
    w_s[c * ws + k] =
        (k < H && j0 + u < H) ? to_f32(w_d[k * H3 + g * H + j0 + u]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * U; i += THREADS) dh_s[i] = 0.f;
  float b_r = 0.f, b_z = 0.f, b_n = 0.f;
  if (j < H) {
    b_r = bias[d * H3 + j];
    b_z = bias[d * H3 + H + j];
    b_n = bias[d * H3 + 2 * H + j];
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  const float* ys_d = ys + size_t(d) * T * BH;
  const float* dy_d = dy + size_t(d) * T * BH;
  float* dxp_d = dxp + size_t(d) * T * B * H3;
  float* dg_d = dgates + size_t(d) * T * B * H3;
  const size_t parity_stride = size_t(n_dirs) * nblk * BH;
  const float* w_r = w_s + (0 * U + lu) * ws;
  const float* w_z = w_s + (1 * U + lu) * ws;
  const float* w_n = w_s + (2 * U + lu) * ws;

  for (int i = 0; i < T; ++i) {
    // Step i of this direction's BPTT is step T-1-i of its forward scan.
    const int row = rev ? i : T - 1 - i;
    const bool last = i == T - 1;  // the forward's first step: h_prev = h0
    // No dh_prev past the recurrence's start unless dh0 asks for it.
    const bool stop = last && dh0 == nullptr;
    const float* hp = !last ? ys_d + size_t(rev ? row + 1 : row - 1) * BH
                      : h0 != nullptr ? h0 + size_t(d) * BH
                                      : nullptr;
    // This block's partial sums for this step: [B][H].
    float* part = partial + (i & 1) * parity_stride +
                  (size_t(d) * nblk + blk) * BH;
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      float acc[2][3] = {};
      if (hp != nullptr) {
        // The gate recompute, staged as gru_fwd.cu stages its product.
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
          __syncthreads();  // the previous chunk's readers are done
#pragma unroll
          for (int q = 0; q < STAGE; ++q) {
            const int e = threadIdx.x + q * THREADS;
            h_s[(e / KC) * HS + e % KC] = round_to<WT>(pre[q]);
          }
          __syncthreads();
          if (k0 + KC < h_pad) fetch(k0 + KC);
          const float* h_a = h_s + rg * HS;
          const float* h_b = h_s + (rg + RG) * HS;
#pragma unroll 4
          for (int kk = 0; kk < KC; kk += 4) {
            float vr[4], vz[4], vn[4], xa[4], xb[4];
            load4(w_r + k0 + kk, vr);
            load4(w_z + k0 + kk, vz);
            load4(w_n + k0 + kk, vn);
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
      }
      // The elementwise BPTT step for rows rg and rg + RG, unit j.
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = rg + q * RG;
        const int b = b0 + r;
        float g_r = 0.f, g_z = 0.f, g_n = 0.f;
        if (b < B && j < H) {
          const float h_prev = hp ? hp[size_t(b) * H + j] : 0.f;
          const WT* x = xp + (size_t(row) * B + b) * H3;
          const float gn = acc[q][2] + b_n;
          const float rr = sigmoid(to_f32(x[j]) + (acc[q][0] + b_r));
          const float z = sigmoid(to_f32(x[H + j]) + (acc[q][1] + b_z));
          const float n = tanhf(to_f32(x[2 * H + j]) + rr * gn);
          const float m = mask[size_t(row) * B + b];
          const float dh =
              dh_s[b * U + lu] + dy_d[size_t(row) * BH + size_t(b) * H + j];
          const float dh_mid = m * dh;
          const float dn = dh_mid * (1.f - z);
          const float dz = dh_mid * (h_prev - n);
          const float da_n = dn * (1.f - n * n);
          const float dr = da_n * gn;
          const float dg_n = da_n * rr;
          const float da_z = dz * z * (1.f - z);
          const float da_r = dr * rr * (1.f - rr);
          de_s[b * U + lu] = dh_mid * z + (1.f - m) * dh;
          const size_t o = (size_t(row) * B + b) * H3;
          dxp_d[o + j] = da_r;
          dxp_d[o + H + j] = da_z;
          dxp_d[o + 2 * H + j] = da_n;
          dg_d[o + j] = da_r;
          dg_d[o + H + j] = da_z;
          dg_d[o + 2 * H + j] = dg_n;
          g_r = round_to<WT>(da_r);
          g_z = round_to<WT>(da_z);
          g_n = round_to<WT>(dg_n);
        }
        g_s[r * GS + lu] = g_r;
        g_s[r * GS + U + lu] = g_z;
        g_s[r * GS + 2 * U + lu] = g_n;
      }
      if (stop) continue;
      __syncthreads();  // the dgates tile is complete
      // Partial sums of round(dgates) @ W^T over this block's columns,
      // for every hidden unit k: thread k holds W[k, cols] in registers.
      const int rows = min(ROWS, B - b0);
      for (int k = threadIdx.x; k < H; k += THREADS) {
        float wk[GC];
#pragma unroll
        for (int c = 0; c < GC; ++c) wk[c] = w_s[c * ws + k];
        for (int r = 0; r < rows; ++r) {
          const float* g = g_s + r * GS;
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
      __syncthreads();  // the tile's readers are done before the next
    }
    if (stop) break;
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
      if (last)
        dh0[size_t(d) * BH + size_t(b) * H + j0 + u] = de_s[e] + dot;
      else
        dh_s[e] = de_s[e] + dot;
    }
    __syncthreads();
  }
}

template <typename WT>
cudaError_t launch(const void* xp, const float* mask, const void* w,
                   const float* bias, const float* h0, const float* ys,
                   const float* dy, float* dxp, float* dgates, float* dh0,
                   float* partial, int D, int T, int B, int H,
                   int reverse_bits, int device, cudaStream_t stream) {
  auto* kernel = gru_bwd_kernel<WT>;
  const int h_pad = (H + KC - 1) / KC * KC;
  const size_t smem = smem_bytes(h_pad, B);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int groups = D * ((H + U - 1) / U);
  int blocks = 0;
  err = gru_bwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                 THREADS, smem, groups, device, &blocks);
  if (err != cudaSuccess) return err;
  // grid.sync() needs every block resident at once.
  if (blocks < groups) return cudaErrorCooperativeLaunchTooLarge;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &h0, &ys, &dy, &dxp, &dgates,
                  &dh0, &partial, &T, &B, &H, const_cast<int*>(&h_pad),
                  &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: the gate pre-pass and the serial loop of
// csrc/gru_bwd_mma.cuh, W resident ----

// The group widths and the stages of a warp's ring of dgates-row pieces:
// MU_NARROW units and MS_NARROW stages where D x ceil(H/MU_NARROW) groups
// fit one an SM, else MU_WIDE and MS_WIDE.
constexpr int MU_NARROW = 8;
constexpr int MS_NARROW = 6;
constexpr int MU_WIDE = 16;
constexpr int MS_WIDE = 4;

__global__ void __launch_bounds__(gru_bwd_mma::P_THREADS)
gru_bwd_gates_kernel(const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ bias,
                     const float* __restrict__ h0,
                     const float* __restrict__ ys, float* __restrict__ pre,
                     int T, int B, int H, int reverse_bits) {
  gru_bwd_mma::gates(w, bias, h0, ys, pre, T, B, H, reverse_bits);
}

template <int MU, int MS>
__global__ void __launch_bounds__(gru_bwd_mma::M_THREADS, 1)
gru_bwd_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                   const float* __restrict__ mask,
                   const __nv_bfloat16* __restrict__ w,
                   const float* __restrict__ h0,
                   const float* __restrict__ ys,
                   const float* __restrict__ dy, float* __restrict__ dxp,
                   float* dgates, float* __restrict__ dh0, float* scratch,
                   int D, int T, int B, int H, int reverse_bits) {
  gru_bwd_mma::loop<MU, MS, gru_bwd_mma::W_ALL>(xp, mask, w, h0, ys, dy, dxp,
                                                dgates, dh0, scratch, D, T, B,
                                                H, reverse_bits);
}

template <int MU, int MS>
size_t loop_smem(int H) {
  return gru_bwd_mma::Plan<MU, MS, gru_bwd_mma::W_ALL>::smem(H);
}

// The two launches at the width the card's SM count gives.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* h0, const float* ys,
                       const float* dy, float* dxp, float* dgates, float* dh0,
                       float* scratch, int D, int T, int B, int H,
                       int reverse_bits, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool narrow = D * ((H + MU_NARROW - 1) / MU_NARROW) <= sms;
  return gru_bwd_mma::launch(
      gru_bwd_gates_kernel,
      narrow ? gru_bwd_mma_kernel<MU_NARROW, MS_NARROW>
             : gru_bwd_mma_kernel<MU_WIDE, MS_WIDE>,
      narrow ? MU_NARROW : MU_WIDE,
      narrow ? loop_smem<MU_NARROW, MS_NARROW>(H)
             : loop_smem<MU_WIDE, MS_WIDE>(H),
      true, xp, mask, w, bias, h0, ys, dy, dxp, dgates, dh0, scratch, D, T, B,
      H, reverse_bits, device, stream);
}

}  // namespace

extern "C" {

// Floats of scratch that gru_bwd_launch needs on the CUDA-core path: the
// partial sums [2][D][ceil(H/16)][B][H].
long long gru_bwd_scratch_floats(int D, int B, int H) {
  return 2LL * D * ((H + U - 1) / U) * B * H;
}

// Floats of scratch that gru_bwd_launch needs on the tensor-core path:
// dh's elementwise part [D,B,H] f32, then two round(dgates) rows
// [2,D,B,3H] bf16.
long long gru_bwd_mma_scratch_floats(int D, int B, int H) {
  return 4LL * D * B * H;
}

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise. h0 (NULL: zeros)
// and dh0 (NULL: not formed) are [D,B,H] f32. A bf16 call runs the
// tensor-core path (two launches; gru_bwd_mma_scratch_floats of scratch)
// where H % 8 == 0 and w, ys, h0 and scratch are 16-byte aligned, else the
// CUDA-core kernel, as f32 does (gru_bwd_scratch_floats). The calling
// thread's current device is the same after the call as before it.
int gru_bwd_launch(int bf16, const void* xp, const float* mask,
                   const void* w, const float* bias, const float* h0,
                   const float* ys, const float* dy, float* dxp,
                   float* dgates, float* dh0, float* scratch, int D, int T,
                   int B, int H, int reverse_bits, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool mma = bf16 && H % 8 == 0 && gru_bwd_mma::aligned16(w) &&
                   gru_bwd_mma::aligned16(ys) &&
                   gru_bwd_mma::aligned16(h0) &&
                   gru_bwd_mma::aligned16(scratch);
  if (mma)
    err = launch_mma(xp, mask, w, bias, h0, ys, dy, dxp, dgates, dh0, scratch,
                     D, T, B, H, reverse_bits, device, st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, w, bias, h0, ys, dy, dxp, dgates,
                                dh0, scratch, D, T, B, H, reverse_bits, device,
                                st);
  else
    err = launch<float>(xp, mask, w, bias, h0, ys, dy, dxp, dgates, dh0,
                        scratch, D, T, B, H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
