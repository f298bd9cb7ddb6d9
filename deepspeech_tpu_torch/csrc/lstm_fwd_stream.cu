// LSTM forward recurrence for Hopper (sm_90a) with W streamed from global
// memory every step: one C call runs the whole time loop of D directions
// at any H, for the sizes whose W does not fit the grid's shared memory
// (ds2_full: H=1760, D=2, W 24.8 MB a direction in bf16).
//
// Replaces the TPU kernel _lstm_kernel_blocked (deepspeech_tpu/ops/
// lstm_pallas.py:116, K14), which streams [H, 512] column blocks of W
// through VMEM each step when W misses the TPU's residency budget, gathers
// the gate partials in scratch and fires the update on the last block. The
// contract is ops/lstm.py lstm_fwd's docstring, as for csrc/lstm_fwd.cu:
//   xp [T,B,4H] and w [D,H,4H] in one dtype, bf16|f32 (the dot dtype; xp
//   includes the input bias), mask [T,B] f32, bias [D,4H] f32, reverse bit
//   d set for a direction that runs t = T-1..0, an f32 scratch whose size
//   depends on the path (lstm_fwd_stream_launch says what it holds)
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h) and, when cs is not
//   NULL, the cell-state tape cs [D,T,B,H] f32 (masked rows hold c).
// Gates i, f, g, o with the +1 on f, as in csrc/lstm_fwd.cu; the product
// rounds h_prev to the dot dtype and sums in f32. Each direction starts
// from h0 and c0 [D,B,H] f32 (either NULL for zeros), writing the final h and c [D,B,H]
// into hfin and cfin at the last step when they are not NULL, as
// csrc/lstm_fwd.cu does.
//
// What bounds it: T serial steps of one step's latency, far above the FLOP
// roofline (2*T*D*B*H*4H over the peak) and the byte roofline (the inputs
// and outputs once). Every step's input is the step before's h, so the
// whole product stays on the serial chain (the backward, csrc/
// lstm_bwd_stream.cu, could hoist its gate recompute; this cannot). A
// step's cost is that of the busiest SM: it moves its group's slice of W
// and the h row from L2 through shared memory into the products, then
// waits at one grid barrier.
//
// bf16 path (the main path; H % 8 == 0 and a 16-byte aligned scratch),
// two launches from one C call, both from csrc/lstm_fwd_mma.cuh (K12,
// csrc/lstm_fwd.cu, runs the same two with all of W^T resident):
//  1. lstm_fwd_stream_transpose_kernel writes Wt [D,4H,H] bf16 = W^T into
//     the scratch, once a call (49.6 MB each way at ds2_full). The
//     product's depth k runs down W's columns, so a 16-byte piece of a W
//     row holds 8 consecutive n; a piece of a Wt row holds 8 consecutive
//     k, which is what the loop's fragments take as they lie.
//  2. lstm_fwd_stream_mma_kernel, the header's serial loop: a cooperative,
//     persistent grid over D x ceil(H/32) groups of U=32 hidden units (gate
//     columns j, H+j, 2H+j, 3H+j: 128 rows of Wt), one group a block and
//     one block an SM (110 groups at ds2_full), one grid barrier a step.
//     A group forms its [B, 128] gate pre-activations round(h_prev) @
//     W[:, own columns] with mma.sync.m16n8k16, bf16 operands and f32
//     sums. Its 8 warps split the product NW_N ways over the 128 columns
//     (2: two gates' 64 columns a warp) and NW_K ways over H (4: every
//     NW_K-th 32-deep chunk), for 32 batch rows (two m16 tiles) at a
//     time. Each lane stages 16-byte pieces of the h row and of Wt's rows
//     with cp.async into its warp's own MS-stage ring (2: one chunk
//     copied while the last one multiplies) and reads back only its own
//     pieces, so the product needs no barrier: a piece holds 8
//     consecutive k of one row, the same permutation of k for both
//     operands, so each is one A or B fragment register of two k16 steps
//     as it lies (csrc/lstm_bwd_stream.cu's loop, transposed). The warps'
//     partial sums meet in shared memory (over the drained rings) and are
//     added in warp order: no atomics, the same bits on every run. Then
//     the LSTM update, from xp, the mask, c_prev and h_prev loaded before
//     the product (which does not wait for them): c stays in a [D,B,H]
//     scratch that only its owning thread touches; the step writes ys,
//     the tape and round_bf16(h) into a [2,D,B,H] bf16 row, double-buffered
//     by step parity so that a fast group's write cannot meet a slow
//     group's read of the step before. That row is the next step's A
//     operand, read through L2 (.cg: other blocks wrote it before the
//     barrier). Step 0 has h_prev = 0 and no product (with an h0, the
//     product on round_bf16(h0), as csrc/lstm_fwd_mma.cuh says). Each
//     warp's first W_RES chunks of Wt stay in shared memory for the whole
//     call (when a block has one group), and the first streamed chunks of
//     the next step are issued before the grid barrier, which they do not
//     wait for. Per SM and step at ds2_full: 14.4 MFLOP; the 71% of W's 450 KB
//     slice that is not resident, and the h row's 113 KB once for each of
//     the NW_N column splits, from L2. The resident part saves more
//     than its share of the bytes (k14_variants on an H100 SXM: 24.1-24.4
//     ms a call with every chunk streamed, 16.6-16.8 with 29% resident),
//     likely because the streamed part of W across the card (35 MB) then
//     fits the 50 MB L2 beside the h rows, and all of it (49.6 MB) did
//     not.
//
// f32 path (not the main path; model.dtype=float32, TF32 off) and a bf16
// call whose H is not a multiple of 8 or whose scratch is not 16-byte
// aligned: lstm_fwd_stream_kernel, csrc/gru_fwd_stream.cu's (K8) design
// with four gates. The work of a step is D x ceil(H/U) column groups of
// U=16 units; a cooperative persistent grid of as many blocks as fit (at
// most one per group) walks the groups. For its group a block stages
// KC-row chunks of the group's [H, 4U] column slice of W, and the matching
// KC columns of h_prev (rounded to the dot dtype), into shared memory as
// f32, two buffers deep: the next chunk's global loads are issued into
// registers (raw bits, widened where they are stored) before the current
// chunk's products run. f32 FMAs on the CUDA cores; then the LSTM update
// and the mask. The cell state stays in the scratch's [D,B,H] f32 head,
// owned by one thread as above. A grid-wide barrier separates the steps;
// h_prev is read through L2 (.cg) from the ys row the grid wrote the step
// before.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (lstm_fwd_stream_launch); ops/lstm.py's
// _fwd_mma repeats it to size the scratch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_fwd_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per column group
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 4 * U;         // gate columns of a group
constexpr int KC = 64;            // W rows / h_prev columns per chunk
constexpr int KS = KC + 4;        // chunk row stride (16-byte aligned rows)
// A chunk of W is staged by every thread, each owning one of the group's
// columns and every KR-th row of the chunk: one base pointer and one
// stride per thread keep the staging's registers few.
constexpr int KR = THREADS / GC;              // 4
constexpr int W_STAGE = KC / KR;              // W values per thread
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
lstm_fwd_stream_kernel(const WT* __restrict__ xp,
                       const float* __restrict__ mask,
                       const WT* __restrict__ w,
                       const float* __restrict__ bias, float* ys, float* cs,
                       float* c_buf, int D, int T, int B, int H,
                       int reverse_bits, const float* __restrict__ h0,
                       const float* __restrict__ c0, float* hfin,
                       float* cfin) {
  extern __shared__ __align__(16) float smem[];
  const int nblk = (H + U - 1) / U;
  const int groups = D * nblk;
  const int h_pad = (H + KC - 1) / KC * KC;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const size_t H4 = 4 * size_t(H);
  const size_t BH = size_t(B) * H;
  cg::grid_group grid = cg::this_grid();

  for (int s = 0; s < T; ++s) {
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int j = j0 + lu;
      const bool rev = (reverse_bits >> d) & 1;
      const int row = rev ? T - 1 - s : s;
      const WT* w_d = w + size_t(d) * H * H4;
      float* ys_d = ys + size_t(d) * T * BH;
      float* c_d = c_buf + size_t(d) * BH;
      // h_prev of this direction: the ys row of the previous step, h0, or
      // 0.
      const float* hp = s > 0 ? ys_d + size_t(rev ? row + 1 : row - 1) * BH
                        : h0 != nullptr ? h0 + size_t(d) * BH
                                        : nullptr;
      // This thread's W column when it stages W: gate wc / U, unit
      // j0 + wc % U (neighbouring threads read neighbouring units, U
      // values in a row of global memory), rows wk, wk + KR, ...
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_live = j0 + wc % U < H;
      const WT* w_col = w_d + (wc / U) * H + j0 + wc % U;
      // h_prev: rows hr, hr + HR, ... of the pass, column hk of the chunk.
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][4] = {};
        if (hp != nullptr) {
          typename Bits<WT>::type wpre[W_STAGE];
          float hpre[H_STAGE];
          // Chunk k0 into registers, unconverted (see ldg_bits).
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
        if (j < H) {
          const float b_i = bias[d * H4 + j];
          const float b_f = bias[d * H4 + H + j];
          const float b_g = bias[d * H4 + 2 * H + j];
          const float b_o = bias[d * H4 + 3 * H + j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int b = b0 + rg + r * RG;
            if (b >= B) continue;
            const size_t at = size_t(b) * H + j;
            const float h_prev = hp ? __ldcg(hp + at) : 0.f;
            const float c_prev = s > 0             ? c_d[at]
                                 : c0 != nullptr ? c0[size_t(d) * BH + at]
                                                 : 0.f;
            const WT* x = xp + (size_t(row) * B + b) * H4;
            const float ig = sigmoid(to_f32(x[j]) + (acc[r][0] + b_i));
            const float fg =
                sigmoid((to_f32(x[H + j]) + (acc[r][1] + b_f)) + 1.f);
            const float gg =
                tanhf(to_f32(x[2 * H + j]) + (acc[r][2] + b_g));
            const float og =
                sigmoid(to_f32(x[3 * H + j]) + (acc[r][3] + b_o));
            const float c_new = fg * c_prev + ig * gg;
            const float h_new = og * tanhf(c_new);
            const float m = mask[size_t(row) * B + b];
            const float h = m * h_new + (1.f - m) * h_prev;
            const float c = m * c_new + (1.f - m) * c_prev;
            c_d[at] = c;
            ys_d[size_t(row) * BH + at] = h;
            if (cs) cs[(size_t(d) * T + row) * BH + at] = c;
            if (hfin != nullptr && s == T - 1) {
              hfin[size_t(d) * BH + at] = h;
              cfin[size_t(d) * BH + at] = c;
            }
          }
        }
      }
    }
    grid.sync();
  }
}

// ---- bf16 path: csrc/lstm_fwd_mma.cuh's transpose and serial loop, part
// of W^T resident ----

// Groups of MU units, the stages of a warp's ring, the warps over the
// group's 128 gate columns (2: two gates' 64 columns a warp, eight n8
// tiles; the other 4 split the depth H), and the chunks of W^T a warp
// holds for the call. A warp's first W_RES chunks of Wt (4 of 13 or 14
// at H=1760: 29% of the group's slice, 128 KB beside the rings' 96 KB)
// are copied into shared memory once and stay there for the whole call,
// when a block has one group; the rest streams every step.
// deepspeech_tpu_torch/k14_variants.py times this choice beside the
// others tried.
constexpr int MU = 32;
constexpr int MS = 2;
constexpr int NW_N = 2;
constexpr int W_RES = 4;
using Plan = lstm_fwd_mma::Plan<MU, MS, W_RES, NW_N>;
// With a count of held chunks a block's bytes do not depend on H.
static_assert(Plan::smem(0) <= 232448, "over the shared memory of a block");

__global__ void __launch_bounds__(lstm_fwd_mma::TT * 8)
lstm_fwd_stream_transpose_kernel(const unsigned short* __restrict__ w,
                                 unsigned short* __restrict__ wt, int H,
                                 const float* __restrict__ h0,
                                 __nv_bfloat16* __restrict__ h_row,
                                 size_t n_h) {
  lstm_fwd_mma::transpose(w, wt, H, h0, h_row, n_h);
}

__global__ void __launch_bounds__(lstm_fwd_mma::M_THREADS, 1)
lstm_fwd_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                           const float* __restrict__ mask,
                           const float* __restrict__ scale,
                           const float* __restrict__ bias, float* ys,
                           float* cs, float* scratch, int D, int T, int B,
                           int H, int reverse_bits,
                           const float* __restrict__ h0,
                           const float* __restrict__ c0, float* hfin,
                           float* cfin) {
  lstm_fwd_mma::loop<MU, MS, W_RES, NW_N>(xp, mask, scale, bias, ys, cs,
                                          scratch, D, T, B, H, reverse_bits,
                                          h0, c0, hfin, cfin);
}

// The CUDA-core kernel: f32, or bf16 off the tensor-core path.
template <typename WT>
cudaError_t launch_cuda_core(const void* xp, const float* mask,
                             const void* w, const float* bias,
                             const float* h0, const float* c0, float* ys,
                             float* cs, float* hfin, float* cfin,
                             float* c_buf, int D, int T, int B, int H,
                             int reverse_bits, int device,
                             cudaStream_t stream) {
  auto* kernel = lstm_fwd_stream_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = lstm_fwd_mma::coop_blocks(reinterpret_cast<const void*>(kernel),
                                  THREADS, SMEM_BYTES, D * ((H + U - 1) / U),
                                  device, &blocks);
  if (err != cudaSuccess) return err;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &ys, &cs, &c_buf,
                  &D, &T, &B, &H, &reverse_bits, &h0, &c0, &hfin, &cfin};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The tensor-core path: W transposed into the scratch, then the serial
// loop, as many blocks as fit (at most one a group).
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* h0, const float* c0,
                       float* ys, float* cs, float* hfin, float* cfin,
                       float* scratch, int D, int T, int B, int H,
                       int reverse_bits, int device, cudaStream_t stream) {
  return lstm_fwd_mma::launch_carry(
      lstm_fwd_stream_transpose_kernel, lstm_fwd_stream_mma_kernel, MU,
      Plan::smem(H), false, xp, mask, w, nullptr, bias, ys, cs, scratch, D,
      T, B, H, reverse_bits, device, stream, h0, c0, hfin, cfin);
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
  if (bf16 && H % 8 == 0 && lstm_fwd_mma::aligned16(scratch))
    err = launch_mma(xp, mask, w, bias, h0, c0, ys, cs, hfin, cfin, scratch,
                     D, T, B, H, reverse_bits, device, st);
  else if (bf16)
    err = launch_cuda_core<__nv_bfloat16>(xp, mask, w, bias, h0, c0, ys, cs,
                                          hfin, cfin, scratch, D, T, B, H,
                                          reverse_bits, device, st);
  else
    err = launch_cuda_core<float>(xp, mask, w, bias, h0, c0, ys, cs, hfin,
                                  cfin, scratch, D, T, B, H, reverse_bits,
                                  device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise; cs may be NULL (no
// tape). A bf16 call with H % 8 == 0 and a 16-byte aligned scratch runs
// the tensor-core path (two launches); its scratch holds D*B*H + D*B*H +
// 2*D*H*H floats (c, the two bf16 h rows, Wt in bf16). Any other call
// runs the CUDA-core kernel, whose scratch is c alone, D*B*H floats. The
// calling thread's current device is the same after the call as before.
// Each direction starts from h0 and c0 [D,B,H] f32 (either may be NULL:
// zeros), and when hfin and cfin are not NULL the last step writes the
// final h and c [D,B,H] f32 there.
int lstm_fwd_stream_launch(int bf16, const void* xp, const float* mask,
                           const void* w, const float* bias, const float* h0,
                           const float* c0, float* ys, float* cs,
                           float* hfin, float* cfin, float* scratch, int D,
                           int T, int B, int H, int reverse_bits, int device,
                           void* stream) {
  return run(bf16, xp, mask, w, bias, h0, c0, ys, cs, hfin, cfin, scratch, D,
             T, B, H, reverse_bits, device, stream);
}

const char* lstm_fwd_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
