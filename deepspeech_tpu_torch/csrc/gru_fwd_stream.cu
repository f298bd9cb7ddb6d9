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
// two launches from one C call:
//  1. gru_fwd_stream_transpose_kernel writes Wt [D,3H,H] bf16 = W^T into
//     the scratch, once a call (37.2 MB each way at ds2_full): a 16-byte
//     piece of a Wt row holds 8 consecutive k, which is what the loop's
//     fragments take as they lie. With h0 its threads also write
//     round_bf16(h0) into the h row that step 0 reads; the launch boundary
//     orders it before the loop, so no grid barrier is added.
//  2. gru_fwd_stream_mma_kernel, the serial loop: csrc/lstm_fwd_stream.cu's
//     (K14) with three gates. A cooperative, persistent grid over D x
//     ceil(H/32) groups of U=32 hidden units (gate columns j, H+j, 2H+j:
//     96 rows of Wt), one group a block and one block an SM (110 groups at
//     ds2_full), one grid barrier a step. A group forms its [B, 96] gate
//     sums round(h_prev) @ W[:, own columns] with mma.sync.m16n8k16, bf16
//     operands and f32 sums. Its 8 warps split the product NW_N ways over
//     the 96 columns (2: 48 columns a warp, six n8 tiles; warp 0 holds r's
//     32 columns and z's first 16) and NW_K ways over H (4: every NW_K-th
//     32-deep chunk), for 32 batch rows (two m16 tiles) at a time. Each
//     lane stages 16-byte pieces of the h row and of Wt's rows with
//     cp.async into its warp's own MS-stage ring (3: two chunks in flight
//     while one multiplies) and reads back only its own pieces, so the
//     product needs no barrier; a lane's 4 pieces of a row are k 8l..8l+7
//     of a chunk, so the 4 lanes of a row copy 64 contiguous bytes, whole
//     32-byte sectors. The warps' partial sums meet in shared memory
//     (over the drained rings) and are added in warp order: no atomics,
//     the same bits on every run. Then the GRU update
//     (b_n added to h W_n before r multiplies it) and the mask, from xp,
//     the mask and the f32 h_prev loaded before the product (which does not
//     wait for them): h_prev is h0 at step 0 and the ys row the owning
//     thread wrote the step before, never the rounded row. The step writes
//     ys, hfin at the last step, and round_bf16(h) into a [2,D,B,H] bf16
//     row, double-buffered by step parity so that a fast group's write
//     cannot meet a slow group's read of the step before. That row is the
//     next step's A operand, read through L2 (.cg: other blocks wrote it
//     before the barrier). Step 0 without h0 has h_prev = 0 and no
//     product. Each warp's first W_RES chunks of Wt stay in shared memory
//     for the whole call (when a block has one group: not at H=2176, whose
//     136 groups outnumber the SMs), and the first streamed chunks of the
//     next step are issued before the grid barrier, which they do not wait
//     for. Per SM and step at ds2_full: 10.8 MFLOP; the 71% of W's 338 KB
//     slice that is not resident, and the h row's 113 KB once for each of
//     the NW_N column splits, from L2: 466 KB a step, against 564 with
//     all of W^T streamed (k8_variants, H100 SXM: 13.2-13.4 ms a call
//     with every chunk streamed, 12.1 with 29% resident; with 2 stages
//     15.0 and 12.2-12.7 at 44%). The loop takes about 14 us a step,
//     against 91 for the CUDA-core kernel below.
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
// _fwd_stream_mma repeats it to size the scratch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// ---- bf16 path: W transposed once, then the serial loop on the tensor cores ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory through L2 only (.cg); with `ok`
// false, 16 zero bytes and nothing read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a @ b on one m16n8k16 tile: bf16 operands, f32 sums.
__device__ __forceinline__ void mma_bf16(float* c, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

constexpr int TT = 32;  // transpose tile

// wt[d][n][k] = w[d][k][n] for n < 3H, k < H (bf16 bits). With h0, the
// grid's threads also write h_row[i] = round_bf16(h0[i]) for the n_h
// values of h0, in a grid-stride loop.
// grid = (ceil(3H/TT), ceil(H/TT), D), block = (TT, 8).
__global__ void __launch_bounds__(TT * 8)
gru_fwd_stream_transpose_kernel(const unsigned short* __restrict__ w,
                                unsigned short* __restrict__ wt,
                                const float* __restrict__ h0,
                                __nv_bfloat16* __restrict__ h_row,
                                size_t n_h, int H) {
  __shared__ unsigned short tile[TT][TT + 1];
  if (h0 != nullptr) {
    const size_t per_block = TT * 8;
    const size_t block =
        (size_t(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    const size_t stride =
        size_t(gridDim.x) * gridDim.y * gridDim.z * per_block;
    for (size_t i = block * per_block + threadIdx.y * TT + threadIdx.x;
         i < n_h; i += stride)
      h_row[i] = __float2bfloat16_rn(h0[i]);
  }
  const size_t N = 3 * size_t(H);
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  const unsigned short* src = w + size_t(blockIdx.z) * H * N;
  unsigned short* dst = wt + size_t(blockIdx.z) * N * H;
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int k = k0 + r, n = n0 + threadIdx.x;
    if (k < H && n < N) tile[r][threadIdx.x] = src[size_t(k) * N + n];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int n = n0 + r, k = k0 + threadIdx.x;
    if (n < N && k < H) dst[size_t(n) * H + k] = tile[threadIdx.x][r];
  }
}

// Serial loop.
constexpr int MU = 32;                  // hidden units per group
constexpr int GCOL = 3 * MU;            // a group's gate columns: Wt rows
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int MROWS = 32;               // batch rows per pass: two m16 tiles
constexpr int QROWS = MROWS / M_WARPS;  // rows per thread, elementwise step
constexpr int MKC = 32;                 // depth of a chunk: two k16 steps
constexpr int MS = 3;                   // cp.async stages of a warp's ring
constexpr int NW_N = 2;                 // warps over the group's columns
constexpr int NW_K = M_WARPS / NW_N;    // warps over the depth H
constexpr int NCOL = GCOL / NW_N;       // a warp's columns
constexpr int NT = NCOL / 8;            // its n8 tiles
constexpr int PIECES = 4 + NT;          // a lane's 16-byte pieces a chunk:
                                        // 4 of the h row, NT of Wt
constexpr int RING = MS * PIECES * 32;  // uint4 of a warp's ring
// A warp's first W_RES chunks of Wt (4 of 13 or 14 at H=1760: 29% of the
// group's 338 KB slice, 96 KB beside the rings' 120 KB) are copied into
// shared memory once and stay there for the whole call, when a block has
// one group; the rest streams every step. deepspeech_tpu_torch/
// k8_variants.py times this choice beside the others that fit: on an
// H100 SXM (700 W, two calls) 12.07-12.14 ms a call, against 12.23-12.67
// with 2 stages and 6 chunks (44%), 13.2-13.4 with 3 stages and every
// chunk streamed, and 14.4-14.9 at best with 4 column splits (50%
// resident), whose warps read the h row 4 times a step.
constexpr int W_RES = 4;
constexpr int RES = W_RES * NT * 32;    // uint4 of a warp's resident chunks
constexpr int RED_S = GCOL + 8;         // partial-sum row stride, floats
// The warps' partial sums alias the rings, which are drained by then.
constexpr size_t MMA_SMEM = sizeof(uint4) * (RING + RES) * M_WARPS;
static_assert(NCOL % 8 == 0, "a warp's columns are whole n8 tiles");
static_assert(MMA_SMEM <= 232448, "over the shared memory of a block");
static_assert(sizeof(float) * NW_K * MROWS * RED_S <=
                  sizeof(uint4) * RING * M_WARPS,
              "partial sums must fit the rings");

// A lane of the warp that takes columns wn*NCOL.. and chunks kw,
// kw + NW_K, ... stages its NT 16-byte pieces of Wt's rows for its chunk
// `it` at `dst` (NT x 32 uint4): the row (gate c / MU, unit j0 + c % MU)
// of column c = wn*NCOL + 8*nt + lane/4, 8 consecutive k each. Units past
// H are zero-filled (a partial last group; whole n8 tiles, as H % 8 == 0).
__device__ __forceinline__ void stage_w(uint4* dst, int it, int kw, int wn,
                                        int lane, int j0, int H,
                                        const __nv_bfloat16* wt_d) {
  const int k = (kw + it * NW_K) * MKC + (lane % 4) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wn * NCOL + nt * 8 + lane / 4;
    const int u = j0 + c % MU;
    const bool ok = k < H && u < H;  // H % 8 == 0: 8 k or none
    cp_async16(dst + nt * 32 + lane,
               ok ? wt_d + (size_t(c / MU) * H + u) * H + k : wt_d, ok);
  }
}

// Needs H % 8 == 0 and a 16-byte aligned scratch: the rounded h rows
// [2][D][B][H] bf16 (parity 1 holding round(h0) when h0 is given), then
// Wt [D][3H][H] bf16, as gru_fwd_stream_transpose_kernel wrote them.
__global__ void __launch_bounds__(M_THREADS, 1)
gru_fwd_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                          const float* __restrict__ mask,
                          const float* __restrict__ bias,
                          const float* __restrict__ h0, float* ys,
                          float* hfin, float* scratch, int D, int T, int B,
                          int H, int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wn = warp % NW_N, kw = warp / NW_N;
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) + warp * RING;
  uint4* res_w =
      reinterpret_cast<uint4*>(smem_raw) + M_WARPS * RING + warp * RES;
  float* red = reinterpret_cast<float*>(smem_raw);
  const int nblk = (H + MU - 1) / MU;
  const int groups = D * nblk;
  const int n_chunks = (H + MKC - 1) / MKC;
  // This warp's chunks: kw, kw + NW_K, ...
  const int n_mine = (n_chunks - kw + NW_K - 1) / NW_K;
  const int res = gridDim.x >= groups ? (W_RES < n_mine ? W_RES : n_mine)
                                      : 0;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;
  __nv_bfloat16* hrow = reinterpret_cast<__nv_bfloat16*>(scratch);
  const __nv_bfloat16* wt = hrow + 2 * D * BH;
  cg::grid_group grid = cg::this_grid();

  if (res > 0) {
    const int j0 = (blockIdx.x % nblk) * MU;
    const __nv_bfloat16* wt_d = wt + size_t(blockIdx.x / nblk) * H3 * H;
    for (int it = 0; it < res; ++it)
      stage_w(res_w + it * NT * 32, it, kw, wn, lane, j0, H, wt_d);
    cp_async_commit();
    cp_async_wait<0>();  // a lane reads back only its own pieces
  }

  for (int s = 0; s < T; ++s) {
    // Step s reads the row of parity (s + 1) & 1: the one step s - 1
    // wrote or, at step 0, round(h0) as the transpose launch wrote it.
    __nv_bfloat16* h_out = hrow + size_t(s & 1) * D * BH;
    const __nv_bfloat16* h_in = hrow + size_t((s + 1) & 1) * D * BH;
    const bool product = s > 0 || h0 != nullptr;
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * MU;
      const int j = j0 + lane;  // the unit this thread updates
      const bool rev = (reverse_bits >> d) & 1;
      const int row = rev ? T - 1 - s : s;
      const int prev = rev ? row + 1 : row - 1;
      const __nv_bfloat16* wt_d = wt + size_t(d) * H3 * H;
      const __nv_bfloat16* h_d = h_in + size_t(d) * BH;
      float* ys_d = ys + size_t(d) * T * BH;
      for (int b0 = 0; b0 < B; b0 += MROWS) {
        // The update's inputs, rows b0 + warp + M_WARPS q: issued now,
        // used after the product, which they do not depend on.
        unsigned short x_v[QROWS][3];
        float m_v[QROWS], h_v[QROWS];
#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int b = b0 + warp + M_WARPS * q;
          if (b >= B || j >= H) continue;
          const size_t at = size_t(b) * H + j;
          const unsigned short* x = reinterpret_cast<const unsigned short*>(
              xp + (size_t(row) * B + b) * H3);
#pragma unroll
          for (int e = 0; e < 3; ++e) x_v[q][e] = __ldg(x + e * H + j);
          m_v[q] = __ldg(mask + size_t(row) * B + b);
          // The f32 carry: h0 at step 0, else the previous row's h, which
          // this thread wrote itself.
          h_v[q] = s > 0 ? __ldcg(ys_d + size_t(prev) * BH + at)
                         : h0 != nullptr ? __ldg(h0 + size_t(d) * BH + at)
                                         : 0.f;
        }

        // gates = round(h_prev) @ W[:, own columns], on the tensor cores.
        if (product) {
          float acc[2][NT][4] = {};
          const bool m1 = b0 + 16 < B;  // the second m16 tile holds a row
          // The first pass of a step after the first finds Wt's first
          // MS-1 chunks issued before the barrier (below).
          const bool w_issued = s > 0 && gi == blockIdx.x && b0 == 0;
          auto stage = [&](int it) {
            if (it < n_mine) {
              uint4* slot = ring + (it % MS) * PIECES * 32;
              const int k = (kw + it * NW_K) * MKC + tig * 8;
              const bool k_ok = k < H;  // H % 8 == 0: 8 k or none
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const int b = b0 + p * 8 + g;  // m tile p/2, rows +8*(p%2)
                const bool ok = k_ok && b < B;
                cp_async16(slot + p * 32 + lane,
                           ok ? h_d + size_t(b) * H + k : h_d, ok);
              }
              if (it >= res && !(w_issued && it < MS - 1))
                stage_w(slot + 4 * 32, it, kw, wn, lane, j0, H, wt_d);
            }
            cp_async_commit();
          };
#pragma unroll
          for (int it = 0; it < MS - 1; ++it) stage(it);
          for (int it = 0; it < n_mine; ++it) {
            cp_async_wait<MS - 2>();
            // Refills the slot this lane read in the last iteration.
            stage(it + MS - 1);
            const uint4* slot = ring + (it % MS) * PIECES * 32;
            const uint4* wp = it < res ? res_w + it * NT * 32 : slot + 4 * 32;
            uint4 a[4], bw[NT];
#pragma unroll
            for (int p = 0; p < 4; ++p) a[p] = slot[p * 32 + lane];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) bw[nt] = wp[nt * 32 + lane];
            // A lane's piece holds k = 8*tig .. 8*tig+7 of the chunk; the
            // fragment slots (2tig, 2tig+1 | 2tig+8, 2tig+9) of the first
            // k16 step take its words x | y, of the second z | w, in A
            // and in B alike.
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (mt == 1 && !m1) continue;
#pragma unroll
              for (int nt = 0; nt < NT; ++nt) {
                if (j0 + (wn * NCOL + nt * 8) % MU >= H) continue;
                mma_bf16(acc[mt][nt], a[2 * mt].x, a[2 * mt + 1].x,
                         a[2 * mt].y, a[2 * mt + 1].y, bw[nt].x, bw[nt].y);
                mma_bf16(acc[mt][nt], a[2 * mt].z, a[2 * mt + 1].z,
                         a[2 * mt].w, a[2 * mt + 1].w, bw[nt].z, bw[nt].w);
              }
            }
          }
          cp_async_wait<0>();
          __syncthreads();  // every ring is drained: red may overwrite them
          float* r = red + kw * MROWS * RED_S;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              float* o = r + (mt * 16 + g) * RED_S + wn * NCOL + nt * 8 +
                         tig * 2;
              *reinterpret_cast<float2*>(o) =
                  make_float2(acc[mt][nt][0], acc[mt][nt][1]);
              *reinterpret_cast<float2*>(o + 8 * RED_S) =
                  make_float2(acc[mt][nt][2], acc[mt][nt][3]);
            }
          __syncthreads();
        }

        if (j < H) {
          const float b_r = bias[d * H3 + j];
          const float b_z = bias[d * H3 + H + j];
          const float b_n = bias[d * H3 + 2 * H + j];
#pragma unroll
          for (int q = 0; q < QROWS; ++q) {
            const int bl = warp + M_WARPS * q, b = b0 + bl;
            if (b >= B) continue;
            float sum[3] = {0.f, 0.f, 0.f};
            if (product) {  // the warps' partial sums, in warp order
#pragma unroll
              for (int kk = 0; kk < NW_K; ++kk)
#pragma unroll
                for (int e = 0; e < 3; ++e)
                  sum[e] += red[(kk * MROWS + bl) * RED_S + e * MU + lane];
            }
            const float r = sigmoid(bits_f32(x_v[q][0]) + (sum[0] + b_r));
            const float z = sigmoid(bits_f32(x_v[q][1]) + (sum[1] + b_z));
            const float n =
                tanhf(bits_f32(x_v[q][2]) + r * (sum[2] + b_n));
            const float h_new = (1.f - z) * n + z * h_v[q];
            const float m = m_v[q];
            const float h = m * h_new + (1.f - m) * h_v[q];
            const size_t at = size_t(b) * H + j;
            ys_d[size_t(row) * BH + at] = h;
            if (s == T - 1) hfin[size_t(d) * BH + at] = h;
            h_out[size_t(d) * BH + at] = __float2bfloat16_rn(h);
          }
        }
        if (product) __syncthreads();  // red is read: the rings are free
      }
    }
    if (s == T - 1) break;
    // Wt does not wait for the barrier: issue the next step's first chunks
    // for this block's first group (committed with its first chunk of the
    // h row).
    {
      const int j0 = (blockIdx.x % nblk) * MU;
      const __nv_bfloat16* wt_d = wt + size_t(blockIdx.x / nblk) * H3 * H;
      for (int it = res; it < MS - 1 && it < n_mine; ++it)
        stage_w(ring + (it % MS) * PIECES * 32 + 4 * 32, it, kw, wn, lane,
                j0, H, wt_d);
    }
    grid.sync();
  }
}

// Blocks of a cooperative launch of `kernel`: all resident at once, as
// grid.sync() needs, and no more than `groups`.
cudaError_t coop_blocks(const void* kernel, int threads, size_t smem,
                        int groups, int device, int* blocks) {
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  *blocks = groups < per_sm * sms ? groups : per_sm * sms;
  return cudaSuccess;
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
  err = coop_blocks(reinterpret_cast<const void*>(kernel), THREADS,
                    SMEM_BYTES, D * ((H + U - 1) / U), device, &blocks);
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor-core path: W transposed (and h0 rounded) into the scratch,
// then the serial loop.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* h0, float* ys,
                       float* hfin, float* scratch, int D, int T, int B,
                       int H, int reverse_bits, int device,
                       cudaStream_t stream) {
  const size_t dbh = size_t(D) * B * H;
  __nv_bfloat16* hrow = reinterpret_cast<__nv_bfloat16*>(scratch);
  unsigned short* wt = reinterpret_cast<unsigned short*>(hrow + 2 * dbh);
  const dim3 t_grid((3 * H + TT - 1) / TT, (H + TT - 1) / TT, D);
  // round(h0) goes to the row of parity 1, the one step 0 reads.
  gru_fwd_stream_transpose_kernel<<<t_grid, dim3(TT, 8), 0, stream>>>(
      static_cast<const unsigned short*>(w), wt, h0, hrow + dbh, dbh, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* kernel = gru_fwd_stream_mma_kernel;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(MMA_SMEM));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = coop_blocks(reinterpret_cast<const void*>(kernel), M_THREADS,
                    MMA_SMEM, D * ((H + MU - 1) / MU), device, &blocks);
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  void* args[] = {&xp_t, &mask, &bias, &h0, &ys, &hfin, &scratch,
                  &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(M_THREADS), args,
                                    MMA_SMEM, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
  if (bf16 && H % 8 == 0 && scratch != nullptr && aligned16(scratch))
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
