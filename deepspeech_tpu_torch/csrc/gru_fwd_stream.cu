// GRU forward recurrence for Hopper (sm_90a) with W streamed from global
// memory every step: one C call runs the whole time loop of D directions
// at any H, for the sizes whose W does not fit the grid's shared memory
// (ds2_full: H=1760, D=2, W 18.6 MB a direction in bf16).
//
// Replaces the TPU kernel _gru_kernel_blocked (deepspeech_tpu/ops/
// rnn_pallas.py:260, K8, launched at :491 on a (T, n_blocks) grid), which
// streams [H, 512] column blocks of W through VMEM each step when W misses
// the TPU's residency budget. The contract is ops/gru.py gru_fwd's
// docstring, as for csrc/gru_fwd.cu:
//   xp [T,B,3H] and w [D,H,3H] in one dtype, bf16|f32 (the dot dtype; xp
//   includes the input bias), mask [T,B] f32, bias [D,3H] f32, h0 [D,B,H]
//   f32 or NULL, reverse bit d set for a direction that runs t = T-1..0,
//   a scratch whose size depends on the path (gru_fwd_stream_launch says
//   what it holds)
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h), hfin [D,B,H] f32.
// Gates r, z, n: n = tanh(xp_n + r * (h W_n + b_n)); h_prev is rounded to
// the dot dtype for the product, sums and the carry stay f32.
//
// What bounds it: T serial steps of one step's latency, far above the FLOP
// roofline (2*T*D*B*H*3H over the peak) and the byte roofline (the inputs
// and outputs once). Every step's input is the step before's h, so the
// whole product stays on the serial chain (the backward, csrc/
// gru_bwd_stream.cu, could hoist its gate recompute; this cannot). A
// step's cost is that of the busiest SM: it moves its group's slice of W
// and the h row from L2 through shared memory into the products, then
// waits at one grid barrier. csrc/gru_fwd.cu keeps each block's [H, 48]
// slice of W in shared memory instead; at H=1760 that slice is 345 KB,
// over the 227 KB a block may have.
//
// bf16 path (the main path; H % 8 == 0 and a 16-byte aligned scratch),
// two launches from one C call, both from csrc/gru_fwd_mma.cuh (K4/K6,
// csrc/gru_fwd.cu, run the same two with all of W^T resident):
//  1. gru_fwd_stream_transpose_kernel writes Wt [D,3H,H] bf16 = W^T into
//     the scratch, once a call (37.2 MB each way at ds2_full), and with
//     h0 round_bf16(h0) into the h row that step 0 reads.
//  2. gru_fwd_stream_mma_kernel, the header's serial loop (csrc/
//     lstm_fwd_stream.cu's, K14, with three gates) for D x ceil(H/32)
//     groups of MU=32 hidden units (96 rows of Wt), one group a block and
//     one block an SM (110 groups at ds2_full), one grid barrier a step:
//     mma.sync.m16n8k16 with bf16 operands and f32 sums, the 8 warps split
//     NW_N = 2 ways over the 96 columns (48 a warp, six n8 tiles; warp 0
//     holds r's 32 columns and z's first 16) and 4 ways over H (every 4th
//     32-deep chunk), 3-stage rings of the h row's and Wt's pieces, the
//     partial sums added in warp order, the f32 carry from h0, hfin at the
//     last step. Each warp's first W_RES chunks of Wt stay in shared
//     memory for the whole call (when a block has one group: not at
//     H=2176, whose 136 groups outnumber the SMs), and the first streamed
//     chunks of the next step are issued before the grid barrier, which
//     they do not wait for. Per SM and step at ds2_full: 10.8 MFLOP; the
//     71% of W's 338 KB slice that is not resident, and the h row's 113 KB
//     once for each of the NW_N column splits, from L2: 466 KB a step,
//     against 564 with all of W^T streamed (k8_variants, H100 SXM:
//     13.2-13.4 ms a call with every chunk streamed, 12.1 with 29%
//     resident; with 2 stages 15.0 and 12.2-12.7 at 44%). The loop takes
//     about 14 us a step, against 91 for the CUDA-core kernel below.
//
// f32 path (not the main path; model.dtype=float32, TF32 off) and a bf16
// call whose H is not a multiple of 8 or whose scratch is not 16-byte
// aligned: gru_fwd_stream_kernel on the CUDA cores, no scratch. The work
// of a step is D x ceil(H/U) column groups of U=16 units; a cooperative
// persistent grid of as many blocks as fit (at most one per group) walks
// the groups. For its group a block stages KC-row chunks of the group's
// [H, 3U] column slice of W, and the matching KC columns of h_prev
// (rounded to the dot dtype), into shared memory as f32, two buffers
// deep: the next chunk's global loads are issued into registers (raw
// bits, widened where they are stored) before the current chunk's
// products run. f32 FMAs; then the GRU update and the mask. A grid-wide
// barrier separates the steps; h_prev is read through L2 (.cg) from the
// ys row the grid wrote the step before (h0 at step 0). Here the whole of
// W crosses L2 into shared memory every step (74 MB in f32, which the 50
// MB L2 cannot hold, so f32 streams from HBM).
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (gru_fwd_stream_launch); ops/gru.py's
// _fwd_mma repeats it to size the scratch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_fwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per column group
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 3 * U;         // gate columns of a group
constexpr int KC = 64;            // W rows / h_prev columns per chunk
constexpr int KS = KC + 4;        // chunk row stride (16-byte aligned rows)
// A chunk of W is staged by the first W_THREADS threads, each owning one
// of the group's columns and every KR-th row of the chunk: one base
// pointer and one stride per thread keep the staging's registers few.
constexpr int KR = 4;
constexpr int W_THREADS = KR * GC;            // 192
constexpr int W_STAGE = KC / KR;              // W values per loader
constexpr int H_STAGE = ROWS * KC / THREADS;  // h_prev values per thread
constexpr int HR = THREADS / KC;              // h_prev rows per sweep
constexpr int BUF = (GC + ROWS) * KS;         // floats per buffer

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A read-only (.nc) load of a value's bits, widened to f32 by bits_f32
// only where the value is used: a conversion right after the load would
// wait for it, and the prefetch would no longer overlap the products.
template <typename T> struct Bits { using type = float; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ float ldg_bits(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short ldg_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float bits_f32(float x) { return x; }
__device__ __forceinline__ float bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
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

constexpr size_t SMEM_BYTES = sizeof(float) * 2 * BUF;

template <typename WT>
__global__ void __launch_bounds__(THREADS, 2)
gru_fwd_stream_kernel(const WT* __restrict__ xp,
                      const float* __restrict__ mask,
                      const WT* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ h0, float* ys, float* hfin,
                      int D, int T, int B, int H, int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int nblk = (H + U - 1) / U;
  const int groups = D * nblk;
  const int h_pad = (H + KC - 1) / KC * KC;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;
  cg::grid_group grid = cg::this_grid();

  for (int s = 0; s < T; ++s) {
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int j = j0 + lu;
      const bool rev = (reverse_bits >> d) & 1;
      const int row = rev ? T - 1 - s : s;
      const WT* w_d = w + size_t(d) * H * H3;
      float* ys_d = ys + size_t(d) * T * BH;
      // h_prev of this direction: the ys row of the previous step, h0, or 0.
      const float* hp = nullptr;
      if (s > 0) {
        hp = ys_d + size_t(rev ? row + 1 : row - 1) * BH;
      } else if (h0 != nullptr) {
        hp = h0 + size_t(d) * BH;
      }
      // This thread's W column when it stages W: gate wc / U, unit
      // j0 + wc % U (neighbouring threads read neighbouring units, U
      // values in a row of global memory), rows wk, wk + KR, ...
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_loader = threadIdx.x < W_THREADS;
      const bool w_live = j0 + wc % U < H;
      const WT* w_col = w_d + (wc / U) * H + j0 + wc % U;
      // h_prev: rows hr, hr + HR, ... of the pass, column hk of the chunk.
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][3] = {};
        if (hp != nullptr) {
          typename Bits<WT>::type wpre[W_STAGE];
          float hpre[H_STAGE];
          // Chunk k0 into registers, unconverted (see ldg_bits).
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
              // Other blocks wrote this row before the barrier: read it
              // through L2 (.cg), never from a stale L1 line.
              hpre[q] = (b < B && k < H) ? __ldcg(hp + size_t(b) * H + k)
                                         : 0.f;
            }
          };
          fetch(0);
          for (int k0 = 0, buf = 0; k0 < h_pad; k0 += KC, buf ^= 1) {
            // Buffer `buf` was last read two chunks ago, before the
            // previous chunk's barrier: it is free to fill.
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
          // The next pass or group fills buffer 0 at once: when the last
          // chunk used it (an odd chunk count), its readers finish first.
          __syncthreads();
        }
        if (j < H) {
          const float b_r = bias[d * H3 + j];
          const float b_z = bias[d * H3 + H + j];
          const float b_n = bias[d * H3 + 2 * H + j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int b = b0 + rg + i * RG;
            if (b >= B) continue;
            const float h_prev = hp ? __ldcg(hp + size_t(b) * H + j) : 0.f;
            const WT* x = xp + (size_t(row) * B + b) * H3;
            const float r = sigmoid(to_f32(x[j]) + (acc[i][0] + b_r));
            const float z = sigmoid(to_f32(x[H + j]) + (acc[i][1] + b_z));
            const float n =
                tanhf(to_f32(x[2 * H + j]) + r * (acc[i][2] + b_n));
            const float h_new = (1.f - z) * n + z * h_prev;
            const float m = mask[size_t(row) * B + b];
            const float h = m * h_new + (1.f - m) * h_prev;
            ys_d[size_t(row) * BH + size_t(b) * H + j] = h;
            if (s == T - 1) hfin[size_t(d) * BH + size_t(b) * H + j] = h;
          }
        }
      }
    }
    grid.sync();
  }
}

// ---- bf16 path: csrc/gru_fwd_mma.cuh's transpose and serial loop, part
// of W^T resident ----

// Groups of MU units, the stages of a warp's ring, the warps over the
// group's 96 gate columns (2: 48 columns a warp, six n8 tiles; the other
// 4 split the depth H), and the chunks of W^T a warp holds for the call.
// A warp's first W_RES chunks of Wt (4 of 13 or 14 at H=1760: 29% of the
// group's 338 KB slice, 96 KB beside the rings' 120 KB) are copied into
// shared memory once and stay there for the whole call, when a block has
// one group; the rest streams every step. deepspeech_tpu_torch/
// k8_variants.py times this choice beside the others that fit: on an
// H100 SXM (700 W, two calls) 12.07-12.14 ms a call, against 12.23-12.67
// with 2 stages and 6 chunks (44%), 13.2-13.4 with 3 stages and every
// chunk streamed, and 14.4-14.9 at best with 4 column splits (50%
// resident), whose warps read the h row 4 times a step.
constexpr int MU = 32;
constexpr int MS = 3;
constexpr int NW_N = 2;
constexpr int W_RES = 4;
using Plan = gru_fwd_mma::Plan<MU, MS, W_RES, NW_N>;
// With a count of held chunks a block's bytes do not depend on H.
static_assert(Plan::smem(0) <= 232448, "over the shared memory of a block");

__global__ void __launch_bounds__(gru_fwd_mma::TT * 8)
gru_fwd_stream_transpose_kernel(const unsigned short* __restrict__ w,
                                unsigned short* __restrict__ wt,
                                const float* __restrict__ h0,
                                __nv_bfloat16* __restrict__ h_row,
                                size_t n_h, int H) {
  gru_fwd_mma::transpose(w, wt, h0, h_row, n_h, H);
}

__global__ void __launch_bounds__(gru_fwd_mma::M_THREADS, 1)
gru_fwd_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                          const float* __restrict__ mask,
                          const float* __restrict__ bias,
                          const float* __restrict__ h0, float* ys,
                          float* hfin, float* scratch, int D, int T, int B,
                          int H, int reverse_bits) {
  gru_fwd_mma::loop<MU, MS, W_RES, NW_N>(xp, mask, bias, h0, ys, hfin,
                                         scratch, D, T, B, H, reverse_bits);
}

// The CUDA-core kernel: f32, or bf16 off the tensor-core path.
template <typename WT>
cudaError_t launch_cuda_core(const void* xp, const float* mask,
                             const void* w, const float* bias,
                             const float* h0, float* ys, float* hfin, int D,
                             int T, int B, int H, int reverse_bits,
                             int device, cudaStream_t stream) {
  auto* kernel = gru_fwd_stream_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = gru_fwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                 THREADS, SMEM_BYTES, D * ((H + U - 1) / U),
                                 device, &blocks);
  if (err != cudaSuccess) return err;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &h0, &ys, &hfin,
                  &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tensor-core path: W transposed (and h0 rounded) into the scratch,
// then the serial loop, as many blocks as fit (at most one a group).
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* h0, float* ys,
                       float* hfin, float* scratch, int D, int T, int B,
                       int H, int reverse_bits, int device,
                       cudaStream_t stream) {
  return gru_fwd_mma::launch(gru_fwd_stream_transpose_kernel,
                             gru_fwd_stream_mma_kernel, MU, Plan::smem(H),
                             false, xp, mask, w, bias, h0, ys, hfin, scratch,
                             D, T, B, H, reverse_bits, device, stream);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise; h0 may be NULL
// (zeros). A bf16 call with H % 8 == 0 and a non-NULL, 16-byte aligned
// scratch runs the tensor-core path (two launches); its scratch holds
// D*B*H + 3*D*H*H/2 floats (the two rounded h rows and Wt, both bf16).
// Any other call runs the CUDA-core kernel, which reads no scratch (it
// may be NULL). The calling thread's current device is the same after
// the call as before.
int gru_fwd_stream_launch(int bf16, const void* xp, const float* mask,
                          const void* w, const float* bias, const float* h0,
                          float* ys, float* hfin, float* scratch, int D,
                          int T, int B, int H, int reverse_bits, int device,
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
    err = launch_cuda_core<__nv_bfloat16>(xp, mask, w, bias, h0, ys, hfin, D,
                                          T, B, H, reverse_bits, device, st);
  else
    err = launch_cuda_core<float>(xp, mask, w, bias, h0, ys, hfin, D, T, B,
                                  H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_fwd_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
