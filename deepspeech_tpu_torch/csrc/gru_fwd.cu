// GRU forward recurrence for Hopper (sm_90a): one C call runs the whole
// time loop of D directions.
//
// Replaces the TPU kernels _gru_kernel (deepspeech_tpu/ops/rnn_pallas.py:85,
// D=1, with an optional carried h0 and the final carry out) and
// _bigru_kernel (rnn_pallas.py:155, D=2, directions forward and reverse).
// The contract is ops/gru.py gru_fwd's docstring:
//   xp [T,B,3H] and w [D,H,3H] in one dtype, bf16|f32 (the dot dtype; xp
//   includes the input bias), mask [T,B] f32, bias [D,3H] f32, h0 [D,B,H] f32
//   or NULL, reverse bit d set for a direction that runs t = T-1..0
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h), hfin [D,B,H] f32.
// Gates r, z, n: n = tanh(xp_n + r * (h W_n + b_n)); h_prev is rounded to
// the dot dtype for the product, sums and the carry stay f32.
//
// What bounds it: each step is a [B,H] x [H,3H] product that depends on
// the step before, so the T steps run in order and the time is T times
// the latency of one step, far above both the FLOP and the byte roofline
// of the whole call. The design keeps W out of device memory for the
// whole sequence: each group of hidden units of one direction holds its
// slice of W in shared memory from the first step to the last, one group
// a block, all blocks resident at once (cooperative launch), a grid-wide
// barrier between the steps.
//
// bf16 path (the main path: ds2_small at D=2, ds2_streaming at D=1, both
// H=800) where H % 8 == 0 and the scratch is 16-byte aligned: two
// launches from one C call, both from csrc/gru_fwd_mma.cuh (K8 runs the
// same two with W^T partly streamed):
//  1. gru_fwd_transpose_kernel writes W^T [D,3H,H] bf16 into the scratch
//     once a call (3.84 MB a direction at H=800), and with h0 its bf16
//     rounding into the h row step 0 reads.
//  2. gru_fwd_mma_kernel<MU, MS>, the serial loop with all of W^T
//     resident: a cooperative grid of D x ceil(H/MU) groups of MU hidden
//     units, one group a block and one block an SM. A group copies its
//     [3*MU, H] rows of W^T (77 KB at MU=16, H=800) into shared memory
//     once a call; a step forms its [B, 3*MU] gate sums
//     round(h_prev) @ W[:, own columns] on mma.sync, bf16 operands and
//     f32 sums, one warp taking all 3*MU columns and the 8 warps every
//     8th 32-deep chunk of the H-deep product (3-4 chunks at H=800),
//     their partial sums added in warp order, while each lane streams its
//     16-byte pieces of the [B, H] bf16 h row (51 KB at B=32; double-
//     buffered by step parity) through its warp's MS-stage ring. Then the
//     GRU update and the mask from the f32 carry (h0 at step 0), ys, hfin
//     at the last step and the next step's bf16 row. The launch takes
//     MU=MU_NARROW units with MS_NARROW stages where D x ceil(H/MU_NARROW)
//     groups fit one an SM (D=1 at H=800: 100 groups, 38 KB of W^T each),
//     else MU_WIDE with MS_WIDE (D=2: 100 groups): deepspeech_tpu_torch/
//     k4_variants.py times the widths and the depths beside the parent's
//     kernel.
//
// f32 path (not the main path; model.dtype=float32) and every other bf16
// call: gru_fwd_kernel, everything on the CUDA cores with f32 FMAs. The
// grid is D x ceil(H/U) blocks, each owning U hidden units of one
// direction (gate columns j, H+j, 2H+j), and each block holds its [H, 3U]
// slice of W as f32 in shared memory. A step reads h_prev of its
// direction (from L2: the ys row the whole grid wrote the step before),
// stages it through shared memory in KC-column chunks rounded to the dot
// dtype (the next chunk's loads in flight while the current one is
// multiplied), forms [B, 3U] gates with f32 FMAs, applies the GRU update
// and the mask, and writes its [B, U] slice of the ys row.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (gru_fwd_launch); ops/gru.py's _fwd_mma
// repeats it.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_fwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per block
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int KC = 64;            // h_prev columns staged per chunk
constexpr int STAGE = ROWS * KC / THREADS;  // staged values per thread

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

// Shared memory holds W and h_prev as f32 whatever the dot dtype: a bf16
// value widens to f32 exactly, and a product of two bf16 values is exact
// in f32, so the sums equal a bf16 dot with f32 accumulation while the
// inner loop needs no unpacking. Rows are padded by 4 floats so that the
// 16-byte loads of neighbouring columns fall on different banks.
constexpr int HS = KC + 4;  // h_prev chunk row stride

size_t smem_bytes(int h_pad) {
  return sizeof(float) * (size_t(3 * U) * (h_pad + 4) + size_t(ROWS) * HS);
}

template <typename WT>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const WT* __restrict__ xp, const float* __restrict__ mask,
               const WT* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ h0, float* ys, float* hfin,
               int T, int B, int H, int h_pad, int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int ws = h_pad + 4;
  float* w_s = smem;
  float* h_s = w_s + 3 * U * ws;

  const int nblk = (H + U - 1) / U;
  const int d = blockIdx.x / nblk;
  const int j0 = (blockIdx.x % nblk) * U;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int j = j0 + lu;
  const bool rev = (reverse_bits >> d) & 1;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;

  // Column c = g*U + u of w_s holds W[d][:, g*H + j0 + u], k contiguous;
  // rows k >= H and units past H are zero.
  const WT* w_d = w + d * H * H3;
  for (int i = threadIdx.x; i < h_pad * 3 * U; i += THREADS) {
    const int k = i / (3 * U), c = i % (3 * U);
    const int g = c / U, u = c % U;
    w_s[c * ws + k] =
        (k < H && j0 + u < H) ? to_f32(w_d[k * H3 + g * H + j0 + u]) : 0.f;
  }
  float b_r = 0.f, b_z = 0.f, b_n = 0.f;
  if (j < H) {
    b_r = bias[d * H3 + j];
    b_z = bias[d * H3 + H + j];
    b_n = bias[d * H3 + 2 * H + j];
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  float* ys_d = ys + size_t(d) * T * BH;
  const float* w_r = w_s + (0 * U + lu) * ws;
  const float* w_z = w_s + (1 * U + lu) * ws;
  const float* w_n = w_s + (2 * U + lu) * ws;

  for (int s = 0; s < T; ++s) {
    const int row = rev ? T - 1 - s : s;
    // h_prev of this direction: the ys row of the previous step, h0, or 0.
    const float* hp = nullptr;
    if (s > 0) {
      hp = ys_d + size_t(rev ? row + 1 : row - 1) * BH;
    } else if (h0 != nullptr) {
      hp = h0 + d * BH;
    }
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      float acc[2][3] = {};
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
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + rg + i * RG;
        if (b >= B || j >= H) continue;
        const float h_prev = hp ? __ldcg(hp + size_t(b) * H + j) : 0.f;
        const WT* x = xp + (size_t(row) * B + b) * H3;
        const float r = sigmoid(to_f32(x[j]) + (acc[i][0] + b_r));
        const float z = sigmoid(to_f32(x[H + j]) + (acc[i][1] + b_z));
        const float n = tanhf(to_f32(x[2 * H + j]) + r * (acc[i][2] + b_n));
        const float h_new = (1.f - z) * n + z * h_prev;
        const float m = mask[size_t(row) * B + b];
        const float h = m * h_new + (1.f - m) * h_prev;
        ys_d[size_t(row) * BH + size_t(b) * H + j] = h;
        if (s == T - 1) hfin[d * BH + size_t(b) * H + j] = h;
      }
    }
    grid.sync();
  }
}

template <typename WT>
cudaError_t launch(const void* xp, const float* mask, const void* w,
                   const float* bias, const float* h0, float* ys, float* hfin,
                   int D, int T, int B, int H, int reverse_bits, int device,
                   cudaStream_t stream) {
  auto* kernel = gru_fwd_kernel<WT>;
  const int h_pad = (H + KC - 1) / KC * KC;
  const size_t smem = smem_bytes(h_pad);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  const int groups = D * ((H + U - 1) / U);
  int blocks = 0;
  err = gru_fwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                 THREADS, smem, groups, device, &blocks);
  if (err != cudaSuccess) return err;
  // grid.sync() needs every block resident at once.
  if (blocks < groups) return cudaErrorCooperativeLaunchTooLarge;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &h0, &ys, &hfin,
                  &T, &B, &H, const_cast<int*>(&h_pad), &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: csrc/gru_fwd_mma.cuh's transpose and serial loop, all
// of W^T resident ----

// The group widths and the stages of a warp's ring of h-row pieces:
// MU_NARROW units and MS_NARROW stages where D x ceil(H/MU_NARROW) groups
// fit one an SM, else MU_WIDE and MS_WIDE.
constexpr int MU_NARROW = 8;
constexpr int MS_NARROW = 4;
constexpr int MU_WIDE = 16;
constexpr int MS_WIDE = 4;

__global__ void __launch_bounds__(gru_fwd_mma::TT * 8)
gru_fwd_transpose_kernel(const unsigned short* __restrict__ w,
                         unsigned short* __restrict__ wt,
                         const float* __restrict__ h0,
                         __nv_bfloat16* __restrict__ h_row, size_t n_h,
                         int H) {
  gru_fwd_mma::transpose(w, wt, h0, h_row, n_h, H);
}

template <int MU, int MS>
__global__ void __launch_bounds__(gru_fwd_mma::M_THREADS, 1)
gru_fwd_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                   const float* __restrict__ mask,
                   const float* __restrict__ bias,
                   const float* __restrict__ h0, float* ys, float* hfin,
                   float* scratch, int D, int T, int B, int H,
                   int reverse_bits) {
  gru_fwd_mma::loop<MU, MS, gru_fwd_mma::W_ALL>(
      xp, mask, bias, h0, ys, hfin, scratch, D, T, B, H, reverse_bits);
}

template <int MU, int MS>
size_t loop_smem(int H) {
  return gru_fwd_mma::Plan<MU, MS, gru_fwd_mma::W_ALL>::smem(H);
}

// The two launches at the width the card's SM count gives.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* h0, float* ys,
                       float* hfin, float* scratch, int D, int T, int B,
                       int H, int reverse_bits, int device,
                       cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool narrow = D * ((H + MU_NARROW - 1) / MU_NARROW) <= sms;
  return gru_fwd_mma::launch(
      gru_fwd_transpose_kernel,
      narrow ? gru_fwd_mma_kernel<MU_NARROW, MS_NARROW>
             : gru_fwd_mma_kernel<MU_WIDE, MS_WIDE>,
      narrow ? MU_NARROW : MU_WIDE,
      narrow ? loop_smem<MU_NARROW, MS_NARROW>(H)
             : loop_smem<MU_WIDE, MS_WIDE>(H),
      true, xp, mask, w, bias, h0, ys, hfin, scratch, D, T, B, H,
      reverse_bits, device, stream);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise; h0 may be NULL
// (zeros). A bf16 call with H % 8 == 0 and a non-NULL, 16-byte aligned
// scratch runs the tensor-core path (two launches); its scratch holds
// D*B*H + 3*D*H*H/2 floats (the two rounded h rows and W^T, both bf16).
// Any other call runs the CUDA-core kernel, which reads no scratch (it
// may be NULL). The calling thread's current device is the same after
// the call as before it.
int gru_fwd_launch(int bf16, const void* xp, const float* mask,
                   const void* w, const float* bias, const float* h0,
                   float* ys, float* hfin, float* scratch, int D, int T,
                   int B, int H, int reverse_bits, int device,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16 && H % 8 == 0 && scratch != nullptr &&
      gru_fwd_mma::aligned16(scratch))
    err = launch_mma(xp, mask, w, bias, h0, ys, hfin, scratch, D, T, B, H,
                     reverse_bits, device, st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, w, bias, h0, ys, hfin, D, T, B, H,
                                reverse_bits, device, st);
  else
    err = launch<float>(xp, mask, w, bias, h0, ys, hfin, D, T, B, H,
                        reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
