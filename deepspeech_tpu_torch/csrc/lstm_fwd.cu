// LSTM forward recurrence for Hopper (sm_90a) with W held in shared memory:
// one C call runs the whole time loop of D directions.
//
// Replaces the TPU kernel _lstm_kernel (deepspeech_tpu/ops/lstm_pallas.py:89,
// K12, via _lstm_pallas_raw :223 / lstm_scan_pallas :281), one direction a
// launch there; here D=1 or D=2 in one C call. The contract is
// ops/lstm.py lstm_fwd's docstring:
//   xp [T,B,4H] and w [D,H,4H] in one dtype, bf16|f32 (the dot dtype; xp
//   includes the input bias), mask [T,B] f32, bias [D,4H] f32, reverse bit
//   d set for a direction that runs t = T-1..0
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h) and, when cs is not
//   NULL, the cell-state tape cs [D,T,B,H] f32 (masked rows hold c).
// Gates i, f, g, o: i = sigmoid(xp_i + (h W_i + b_i)),
// f = sigmoid(xp_f + (h W_f + b_f) + 1), g = tanh(...), o = sigmoid(...);
// c' = f c + i g, h' = o tanh(c'); h_prev is rounded to the dot dtype for
// the product, sums, c and h stay f32. Each direction starts from h0 and
// c0 [D,B,H] f32 (either NULL for zeros), and with hfin and cfin not NULL
// the last step writes the final h and c [D,B,H] there (the
// sequence-parallel relay's chunk, deepspeech_tpu_torch/parallel/seqpar.py,
// hands them to the next shard).
// The final state is written by the thread that owns each value at the
// last step, from the f32 values it holds; ys's last row holds the same h,
// but the cell state has no row without the tape.
//
// What bounds it: each step is a [B,H] x [H,4H] product that depends on the
// step before, so the T steps run in order and the time is T times the
// latency of one step, far above both the FLOP and the byte roofline of the
// whole call. The design keeps W out of device memory for the whole
// sequence: each group of hidden units of one direction holds its slice of
// W in shared memory from the first step to the last, one group a block,
// all blocks resident at once (cooperative launch), a grid-wide barrier
// between the steps. The whole cell update of a unit happens in its block,
// so only h crosses blocks; c is read and written by the one thread that
// owns its row and unit.
//
// bf16 path (the main path: ds2_small-lstm at D=2, ds2_streaming-lstm at
// D=1, both H=800) where H % 8 == 0 and the scratch is 16-byte aligned:
// two launches from one C call, both from csrc/lstm_fwd_mma.cuh (K14 runs
// the same two with W^T partly streamed):
//  1. lstm_fwd_transpose_kernel writes W^T [D,4H,H] bf16 into the scratch
//     once a call (5.12 MB a direction at H=800).
//  2. lstm_fwd_mma_kernel<MU, MS>, the serial loop with all of W^T
//     resident: a cooperative grid of D x ceil(H/MU) groups of MU hidden
//     units, one group a block and one block an SM. A group copies its
//     [4*MU, H] rows of W^T (102 KB at MU=16, H=800) into shared memory
//     once a call; a step forms its [B, 4*MU] gate sums
//     round(h_prev) @ W[:, own columns] on mma.sync, bf16 operands and
//     f32 sums, one warp taking all 4*MU columns and the 8 warps every
//     8th 32-deep chunk of the H-deep product (3-4 chunks at H=800),
//     their partial sums added in warp order, while each lane streams its
//     16-byte pieces of the [B, H] bf16 h row (51 KB at B=32; double-
//     buffered by step parity) through its warp's MS-stage ring. Then the
//     LSTM update and the mask, c from and back to the scratch, ys, the
//     tape and the next step's bf16 row. The launch takes MU=MU_NARROW
//     units with MS_NARROW stages where D x ceil(H/MU_NARROW) groups fit
//     one an SM (D=1 at H=800: 100 groups, 51 KB of W^T each), else
//     MU_WIDE with MS_WIDE (D=2: 100 groups): deepspeech_tpu_torch/
//     k12_variants.py times the widths and the depths beside the
//     parent's kernel.
//
// f32 path (not the main path; model.dtype=float32) and every other bf16
// call: lstm_fwd_kernel, everything on the CUDA cores with f32 FMAs, no
// scratch. The grid is D x ceil(H/U) blocks, each owning U hidden units of
// one direction (gate columns j, H+j, 2H+j, 3H+j): c sits in shared memory
// beside the block's [H, 4U] slice of W (f32, held from the first step to
// the last), one value per batch row and unit. Only h crosses blocks,
// through the ys row the grid wrote the step before (read through L2). A
// step stages h_prev in KC-column chunks rounded to the dot dtype (the
// next chunk's loads in flight while the current one is multiplied), forms
// [B, 4U] gates with f32 FMAs, applies the update and the mask, and writes
// its [B, U] slice of the ys row (and of the tape). At H=800 a block takes
// 220 KB of shared memory (one an SM; 100 blocks at D=2); ops/gru.py
// resident_smem_bytes("lstm_fwd") repeats the layout.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (lstm_fwd_launch); ops/lstm.py's _fwd_mma
// repeats it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_fwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per block
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 4 * U;         // gate columns of a block
constexpr int KC = 64;            // h_prev columns staged per chunk
constexpr int STAGE = ROWS * KC / THREADS;  // staged values per thread
constexpr int HS = KC + 4;        // h_prev chunk row stride

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// h_prev rounded to the dot dtype, kept as f32.
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
// column; a bf16 value widens exactly and a product of two bf16 values is
// exact in f32, so the sums equal a bf16 dot with f32 accumulation), the
// h_prev chunk [ROWS][HS], and the cell state [B][U].
size_t smem_bytes(int h_pad, int B) {
  return sizeof(float) *
         (size_t(GC) * (h_pad + 4) + size_t(ROWS) * HS + size_t(B) * U);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS, 2)
lstm_fwd_kernel(const WT* __restrict__ xp, const float* __restrict__ mask,
                const WT* __restrict__ w, const float* __restrict__ bias,
                float* ys, float* cs, int T, int B, int H, int h_pad,
                int reverse_bits, const float* __restrict__ h0,
                const float* __restrict__ c0, float* hfin, float* cfin) {
  extern __shared__ __align__(16) float smem[];
  const int ws = h_pad + 4;
  float* w_s = smem;
  float* h_s = w_s + GC * ws;
  float* c_s = h_s + ROWS * HS;

  const int nblk = (H + U - 1) / U;
  const int d = blockIdx.x / nblk;
  const int j0 = (blockIdx.x % nblk) * U;
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
  // The cell state starts from c0 (zeros without one).
  for (int i = threadIdx.x; i < B * U; i += THREADS) {
    const int b = i / U, u = i % U;
    c_s[i] = (c0 != nullptr && j0 + u < H)
                 ? c0[size_t(d) * B * H + size_t(b) * H + j0 + u]
                 : 0.f;
  }
  float b_i = 0.f, b_f = 0.f, b_g = 0.f, b_o = 0.f;
  if (j < H) {
    b_i = bias[d * H4 + j];
    b_f = bias[d * H4 + H + j];
    b_g = bias[d * H4 + 2 * H + j];
    b_o = bias[d * H4 + 3 * H + j];
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  float* ys_d = ys + size_t(d) * T * BH;
  float* cs_d = cs ? cs + size_t(d) * T * BH : nullptr;
  const float* w_i = w_s + (0 * U + lu) * ws;
  const float* w_f = w_s + (1 * U + lu) * ws;
  const float* w_g = w_s + (2 * U + lu) * ws;
  const float* w_o = w_s + (3 * U + lu) * ws;

  for (int s = 0; s < T; ++s) {
    const int row = rev ? T - 1 - s : s;
    // h_prev of this direction: the ys row of the previous step, h0, or 0.
    const float* hp = s > 0 ? ys_d + size_t(rev ? row + 1 : row - 1) * BH
                      : h0 != nullptr ? h0 + size_t(d) * BH
                                      : nullptr;
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      float acc[2][4] = {};
      if (hp != nullptr) {
        // Register prefetch of the next h_prev chunk: its L2 loads are in
        // flight while the current chunk's products run.
        float pre[STAGE];
        auto fetch = [&](int k0) {
#pragma unroll
          for (int q = 0; q < STAGE; ++q) {
            const int i = threadIdx.x + q * THREADS;
            const int b = b0 + i / KC, k = k0 + i % KC;
            // Other blocks wrote this row before the barrier: read it
            // through L2 (.cg), never from a stale L1 line.
            pre[q] = (b < B && k < H) ? __ldcg(hp + size_t(b) * H + k) : 0.f;
          }
        };
        fetch(0);
        for (int k0 = 0; k0 < h_pad; k0 += KC) {
          __syncthreads();  // the previous chunk's readers are done
#pragma unroll
          for (int q = 0; q < STAGE; ++q) {
            const int i = threadIdx.x + q * THREADS;
            h_s[(i / KC) * HS + i % KC] = round_to<WT>(pre[q]);
          }
          __syncthreads();
          if (k0 + KC < h_pad) fetch(k0 + KC);
          const float* h_a = h_s + rg * HS;
          const float* h_b = h_s + (rg + RG) * HS;
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
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + rg + r * RG;
        if (b >= B || j >= H) continue;
        const float h_prev = hp ? __ldcg(hp + size_t(b) * H + j) : 0.f;
        const float c_prev = c_s[b * U + lu];
        const WT* x = xp + (size_t(row) * B + b) * H4;
        const float ig = sigmoid(to_f32(x[j]) + (acc[r][0] + b_i));
        const float fg =
            sigmoid((to_f32(x[H + j]) + (acc[r][1] + b_f)) + 1.f);
        const float gg = tanhf(to_f32(x[2 * H + j]) + (acc[r][2] + b_g));
        const float og = sigmoid(to_f32(x[3 * H + j]) + (acc[r][3] + b_o));
        const float c_new = fg * c_prev + ig * gg;
        const float h_new = og * tanhf(c_new);
        const float m = mask[size_t(row) * B + b];
        const float h = m * h_new + (1.f - m) * h_prev;
        const float c = m * c_new + (1.f - m) * c_prev;
        c_s[b * U + lu] = c;
        ys_d[size_t(row) * BH + size_t(b) * H + j] = h;
        if (cs_d) cs_d[size_t(row) * BH + size_t(b) * H + j] = c;
        if (hfin != nullptr && s == T - 1) {
          hfin[size_t(d) * BH + size_t(b) * H + j] = h;
          cfin[size_t(d) * BH + size_t(b) * H + j] = c;
        }
      }
    }
    grid.sync();
  }
}

template <typename WT>
cudaError_t launch(const void* xp, const float* mask, const void* w,
                   const float* bias, const float* h0, const float* c0,
                   float* ys, float* cs, float* hfin, float* cfin, int D,
                   int T, int B, int H, int reverse_bits, int device,
                   cudaStream_t stream) {
  auto* kernel = lstm_fwd_kernel<WT>;
  const int h_pad = (H + KC - 1) / KC * KC;
  const size_t smem = smem_bytes(h_pad, B);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int groups = D * ((H + U - 1) / U);
  int blocks = 0;
  err = lstm_fwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                  THREADS, smem, groups, device, &blocks);
  if (err != cudaSuccess) return err;
  // grid.sync() needs every block resident at once.
  if (blocks < groups) return cudaErrorCooperativeLaunchTooLarge;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &ys, &cs,
                  &T, &B, &H, const_cast<int*>(&h_pad), &reverse_bits,
                  &h0, &c0, &hfin, &cfin};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: csrc/lstm_fwd_mma.cuh's transpose and serial loop, all
// of W^T resident ----

// The group widths and the stages of a warp's ring of h-row pieces:
// MU_NARROW units and MS_NARROW stages where D x ceil(H/MU_NARROW) groups
// fit one an SM, else MU_WIDE and MS_WIDE.
constexpr int MU_NARROW = 8;
constexpr int MS_NARROW = 4;
constexpr int MU_WIDE = 16;
constexpr int MS_WIDE = 4;

__global__ void __launch_bounds__(lstm_fwd_mma::TT * 8)
lstm_fwd_transpose_kernel(const unsigned short* __restrict__ w,
                          unsigned short* __restrict__ wt, int H,
                          const float* __restrict__ h0,
                          __nv_bfloat16* __restrict__ h_row, size_t n_h) {
  lstm_fwd_mma::transpose(w, wt, H, h0, h_row, n_h);
}

template <int MU, int MS>
__global__ void __launch_bounds__(lstm_fwd_mma::M_THREADS, 1)
lstm_fwd_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                    const float* __restrict__ mask,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, float* ys, float* cs,
                    float* scratch, int D, int T, int B, int H,
                    int reverse_bits, const float* __restrict__ h0,
                    const float* __restrict__ c0, float* hfin, float* cfin) {
  lstm_fwd_mma::loop<MU, MS, lstm_fwd_mma::W_ALL>(
      xp, mask, scale, bias, ys, cs, scratch, D, T, B, H, reverse_bits, h0,
      c0, hfin, cfin);
}

template <int MU, int MS>
size_t loop_smem(int H) {
  return lstm_fwd_mma::Plan<MU, MS, lstm_fwd_mma::W_ALL>::smem(H);
}

// The two launches at the width the card's SM count gives.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* h0, const float* c0,
                       float* ys, float* cs, float* hfin, float* cfin,
                       float* scratch, int D, int T, int B, int H,
                       int reverse_bits, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool narrow = D * ((H + MU_NARROW - 1) / MU_NARROW) <= sms;
  return lstm_fwd_mma::launch_carry(
      lstm_fwd_transpose_kernel,
      narrow ? lstm_fwd_mma_kernel<MU_NARROW, MS_NARROW>
             : lstm_fwd_mma_kernel<MU_WIDE, MS_WIDE>,
      narrow ? MU_NARROW : MU_WIDE,
      narrow ? loop_smem<MU_NARROW, MS_NARROW>(H)
             : loop_smem<MU_WIDE, MS_WIDE>(H),
      true, xp, mask, w, nullptr, bias, ys, cs, scratch, D, T, B, H,
      reverse_bits, device, stream, h0, c0, hfin, cfin);
}

}  // namespace

namespace {

int run(int bf16, const void* xp, const float* mask, const void* w,
        const float* bias, const float* h0, const float* c0, float* ys,
        float* cs, float* hfin, float* cfin, float* scratch, int D, int T,
        int B, int H, int reverse_bits, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16 && H % 8 == 0 && scratch != nullptr &&
      lstm_fwd_mma::aligned16(scratch))
    err = launch_mma(xp, mask, w, bias, h0, c0, ys, cs, hfin, cfin, scratch,
                     D, T, B, H, reverse_bits, device, st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, w, bias, h0, c0, ys, cs, hfin,
                                cfin, D, T, B, H, reverse_bits, device, st);
  else
    err = launch<float>(xp, mask, w, bias, h0, c0, ys, cs, hfin, cfin, D, T,
                        B, H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise; cs may be NULL (no
// tape). A bf16 call with H % 8 == 0 and a non-NULL, 16-byte aligned
// scratch runs the tensor-core path (two launches); its scratch holds
// 2*D*B*H + 2*D*H*H floats (c in f32, then the two rounded h rows and
// W^T, both bf16). Any other call runs the CUDA-core kernel, which reads
// no scratch (it may be NULL). The calling thread's current device is the
// same after the call as before it. Each direction starts from h0 and c0
// [D,B,H] f32 (either may be NULL: zeros), and when hfin and cfin are not
// NULL the last step writes the final h and c [D,B,H] f32 there.
int lstm_fwd_launch(int bf16, const void* xp, const float* mask,
                    const void* w, const float* bias, const float* h0,
                    const float* c0, float* ys, float* cs, float* hfin,
                    float* cfin, float* scratch, int D, int T, int B, int H,
                    int reverse_bits, int device, void* stream) {
  return run(bf16, xp, mask, w, bias, h0, c0, ys, cs, hfin, cfin, scratch, D,
             T, B, H, reverse_bits, device, stream);
}

const char* lstm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
