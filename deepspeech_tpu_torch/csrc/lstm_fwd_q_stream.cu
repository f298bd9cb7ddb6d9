// LSTM forward recurrence for Hopper (sm_90a) with weight-only int8
// recurrent weights streamed from global memory every step: one C call runs
// the whole time loop of D directions at any H, for the sizes whose int8
// slices do not fit the grid's shared memory (ds2_full: H=1760, D=2, Q 12.4
// MB a direction).
//
// Replaces the TPU kernel _lstm_kernel_blocked_q (deepspeech_tpu/ops/
// lstm_pallas.py:315, K17, via lstm_scan_pallas_q :378), which streams s8
// [H, 512] column tiles of W_h through VMEM each step, dequantized next to
// their [1, C] scale columns, when the int8 matrix misses the TPU's
// residency budget (the flagship LSTM's H=1760 does). The contract is
// ops/lstm.py lstm_fwd_q's docstring, as for csrc/lstm_fwd_q.cu:
//   xp [T,B,4H] in the dot dtype, bf16|f32 (xp includes the input bias),
//   mask [T,B] f32, wq [D,H,4H] int8, scale [D,4H] f32 (per output
//   channel), bias [D,4H] f32, reverse bit d set for a direction that runs
//   t = T-1..0, an f32 scratch whose size depends on the path
//   (lstm_fwd_q_stream_launch says what it holds)
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h). No tape.
// Gates: (round(h_prev) @ Q) * scale + b, the sum in f32 and the scale on
// the finished column sum; then i, f, g, o as in csrc/lstm_fwd.cu.
//
// What bounds it: T serial steps of one step's latency, far above the FLOP
// roofline (2*T*D*B*H*4H over the peak) and the byte roofline (the inputs
// and outputs once), as for csrc/lstm_fwd_stream.cu (K14), whose function
// this is with s8 weights. A step's cost is that of the busiest SM: it
// moves its group's slice of Q and the h row from L2 through shared memory
// into the products, widens the slice to bf16, then waits at one grid
// barrier.
//
// bf16 path (the main path; H % 8 == 0 and a 16-byte aligned scratch),
// two launches from one C call, K14's tensor-core loop with s8 weights:
//  1. lstm_fwd_q_stream_transpose_kernel writes Qt [D,4H,Hp] = Q^T into
//     the scratch, once a call (12.4 MB a direction at ds2_full): each
//     byte biased to q + 128 (what the widening below takes), each row
//     padded to Hp = H rounded up to 64 and its k permuted within each
//     64-deep chunk (q_pos), so that a 16-byte piece holds the 16 k that a
//     lane's two 16-byte pieces of the h row hold, and the 4 lanes of an h
//     row copy 64 contiguous bytes: whole 32-byte sectors. (With 16
//     consecutive k a lane, each copy used half of every sector of the h
//     row, and the loop took 25 ms a call where it now takes 17:
//     k17_variants on an H100.)
//  2. lstm_fwd_q_stream_mma_kernel, the serial loop: a cooperative,
//     persistent grid over D x ceil(H/32) groups of U=32 hidden units (gate
//     columns j, H+j, 2H+j, 3H+j: 128 rows of Qt), one group a block and
//     one block an SM (110 groups at ds2_full), one grid barrier a step.
//     A group forms its [B, 128] gate sums round(h_prev) @ Q[:, own
//     columns] with mma.sync.m16n8k16, bf16 operands and f32 sums. Its 8
//     warps split the product NW_N ways over the 128 columns (2: 64
//     columns a warp) and NW_K ways over H (4: every NW_K-th 64-deep
//     chunk), for 32 batch rows (two m16 tiles) at a time. Each lane stages
//     with cp.async into its warp's own MS-stage ring (2) one 16-byte s8
//     piece of each of its NT Qt rows and the two 16-byte bf16 pieces of
//     each of its 4 h rows that hold the same 16 k, and reads back only its
//     own pieces, so the product needs no barrier.
//     The lane widens each s8 piece in registers to 8 words of bf16 pairs,
//     the B fragments of the chunk's four k16 steps (the same permutation
//     of k as its h pieces give the A fragments), once for both m16 tiles:
//     prmt puts each biased byte q + 128 into the low byte of an f32 with
//     exponent 2^23, one fsub of 2^23 + 128 gives q, and prmt keeps the two
//     upper halves: 10 instructions for 4 values, exact for every byte
//     (|q| <= 128 needs 8 bits of significand, bf16's count). It costs
//     about 13% of the loop (k17_variants' no_widening build).
//     The warps' partial sums meet in shared memory (over the drained
//     rings) and are added in warp order: no atomics, the same bits on
//     every run. acc * scale + b, then the LSTM update, from xp, the mask,
//     c_prev and h_prev loaded before the product (which does not wait
//     for them): c stays in a [D,B,H] f32 scratch that only its owning
//     thread touches; the step writes ys and round_bf16(h) into a
//     [2,D,B,H] bf16 row, double-buffered by step parity so that a fast
//     group's write cannot meet a slow group's read of the step before.
//     That row is the next step's A operand, read through L2 (.cg: other
//     blocks wrote it before the barrier). Step 0 has h_prev = 0 and no
//     product. Each warp's first W_RES chunks of Qt stay in shared memory
//     for the whole call (when a block has one group), as s8 (RES_BF16 0)
//     or already widened (1), and the first streamed chunks of the next
//     step are issued before the grid barrier, which they do not wait for.
//     Per SM and step at ds2_full: 14.4 MFLOP, Q's 225 KB slice (the 57%
//     not resident from L2) widened once, and the h row's 113 KB once for
//     each of the NW_N column splits. deepspeech_tpu_torch/k17_variants.py
//     times the constants beside the others tried; a ring of the h pieces
//     shared by the two column splits (half the h row's bytes, a named
//     barrier a chunk) measured no faster and was taken out.
//
// f32 path (not the main path; model.dtype=float32) and a bf16 call whose
// H is not a multiple of 8 or whose scratch is not 16-byte aligned:
// lstm_fwd_q_stream_kernel on the CUDA cores, csrc/gru_fwd_q_stream.cu's
// (K11) design with four gates. The work of a step is D x ceil(H/U) column
// groups of U=16 units; a cooperative persistent grid walks the groups.
// For its group a block stages KC-row chunks of the group's [H, 4U] column
// slice of Q (the raw s8 bytes prefetched into registers, widened to f32
// where they are stored) and the matching h_prev columns into shared
// memory as f32, two buffers deep, and runs f32 FMAs; the group's 64 scales
// multiply the finished sums. The cell state stays in the scratch's [D,B,H]
// f32 head, owned by one thread at every step. A grid-wide barrier
// separates the steps; h_prev is read through L2 (.cg) from the ys row the
// grid wrote the step before.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (lstm_fwd_q_stream_launch); ops/lstm.py's
// _fwd_q_stream_mma repeats it to size the scratch. ops/lstm.py launches
// this kernel where resident_fits("lstm_fwd_q") says the resident kernel
// csrc/lstm_fwd_q.cu cannot hold the int8 slices, or when the caller forces
// it (blocked=True).

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
constexpr int GC = 4 * U;         // gate columns of a group
constexpr int KC = 64;            // W rows / h_prev columns per chunk
constexpr int KS = KC + 4;        // chunk row stride (16-byte aligned rows)
// A chunk of W is staged by every thread, each owning one of the group's
// columns and every KR-th row of the chunk.
constexpr int KR = THREADS / GC;              // 4
constexpr int W_STAGE = KC / KR;              // W values per thread
constexpr int H_STAGE = ROWS * KC / THREADS;  // h_prev values per thread
constexpr int HR = THREADS / KC;              // h_prev rows per sweep
constexpr int BUF = (GC + ROWS) * KS;         // floats per buffer

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

constexpr size_t SMEM_BYTES = sizeof(float) * 2 * BUF;

template <typename XT>
__global__ void __launch_bounds__(THREADS, 2)
lstm_fwd_q_stream_kernel(const XT* __restrict__ xp,
                         const float* __restrict__ mask,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ scale,
                         const float* __restrict__ bias, float* ys,
                         float* c_buf, int D, int T, int B, int H,
                         int reverse_bits) {
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
      const int8_t* wq_d = wq + size_t(d) * H * H4;
      float* ys_d = ys + size_t(d) * T * BH;
      float* c_d = c_buf + size_t(d) * BH;
      // h_prev of this direction: the ys row of the previous step, or 0.
      const float* hp = s > 0 ? ys_d + size_t(rev ? row + 1 : row - 1) * BH
                              : nullptr;
      // This thread's W column when it stages W: gate wc / U, unit
      // j0 + wc % U (neighbouring threads read neighbouring units, U
      // bytes in a row of global memory), rows wk, wk + KR, ...
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_live = j0 + wc % U < H;
      const int8_t* w_col = wq_d + (wc / U) * H + j0 + wc % U;
      // h_prev: rows hr, hr + HR, ... of the pass, column hk of the chunk.
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][4] = {};
        if (hp != nullptr) {
          int8_t wpre[W_STAGE];
          float hpre[H_STAGE];
          // Chunk k0 into registers; W as raw bytes (widened at the store).
          auto fetch = [&](int k0) {
#pragma unroll
            for (int q = 0; q < W_STAGE; ++q) {
              const int k = k0 + wk + q * KR;
              wpre[q] = (w_live && k < H) ? __ldg(w_col + size_t(k) * H4)
                                          : int8_t(0);
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
              w_s[wc * KS + wk + q * KR] = static_cast<float>(wpre[q]);
#pragma unroll
            for (int q = 0; q < H_STAGE; ++q)
              h_s[(hr + q * HR) * KS + hk] = round_to<XT>(hpre[q]);
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
          float b_[4], s_[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            b_[g] = bias[d * H4 + g * H + j];
            s_[g] = scale[d * H4 + g * H + j];
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int b = b0 + rg + r * RG;
            if (b >= B) continue;
            const size_t at = size_t(b) * H + j;
            const float h_prev = hp ? __ldcg(hp + at) : 0.f;
            const float c_prev = s > 0 ? c_d[at] : 0.f;
            const XT* x = xp + (size_t(row) * B + b) * H4;
            const float ig =
                sigmoid(to_f32(x[j]) + (acc[r][0] * s_[0] + b_[0]));
            const float fg = sigmoid(
                (to_f32(x[H + j]) + (acc[r][1] * s_[1] + b_[1])) + 1.f);
            const float gg =
                tanhf(to_f32(x[2 * H + j]) + (acc[r][2] * s_[2] + b_[2]));
            const float og =
                sigmoid(to_f32(x[3 * H + j]) + (acc[r][3] * s_[3] + b_[3]));
            const float c_new = fg * c_prev + ig * gg;
            const float h_new = og * tanhf(c_new);
            const float m = mask[size_t(row) * B + b];
            c_d[at] = m * c_new + (1.f - m) * c_prev;
            ys_d[size_t(row) * BH + at] = m * h_new + (1.f - m) * h_prev;
          }
        }
      }
    }
    grid.sync();
  }
}

// ---- bf16 path: Q transposed once, then the serial loop on the tensor cores ----

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

// Four s8 values, stored biased (byte e of u is q_e + 128, unsigned, as
// the transpose writes Qt) -> bf16 pairs lo = (q0, q1), hi = (q2, q3), the
// first of each pair in the low half; exact for every byte.
__device__ __forceinline__ void widen4(uint32_t u, uint32_t& lo,
                                       uint32_t& hi) {
  constexpr uint32_t EXP = 0x4B000000u;  // 2^23 as f32: 2^23 + u exactly
  constexpr float BIAS = 8388736.f;      // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(u, EXP, 0x7540)) - BIAS;
  const float f1 = __uint_as_float(__byte_perm(u, EXP, 0x7541)) - BIAS;
  const float f2 = __uint_as_float(__byte_perm(u, EXP, 0x7542)) - BIAS;
  const float f3 = __uint_as_float(__byte_perm(u, EXP, 0x7543)) - BIAS;
  // An integer of at most 8 significant bits: its f32 low half is zero.
  lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

// A lane's s8 piece (16 k) -> the B fragments b[2j], b[2j+1] of k16 step
// j = 0..3: bytes 4j..4j+3.
__device__ __forceinline__ void widen16(const uint4& q, uint32_t* b) {
  widen4(q.x, b[0], b[1]);
  widen4(q.y, b[2], b[3]);
  widen4(q.z, b[4], b[5]);
  widen4(q.w, b[6], b[7]);
}

constexpr int TT = 32;  // transpose tile

constexpr int MKC = 64;  // depth of a chunk of the loop: four k16 steps

// Where the transpose puts depth k in a row of Qt: within each MKC-deep
// chunk, position 16*l + e holds k = 8*l + e for e < 8 and k = 32 + 8*l +
// e - 8 for e >= 8 (l = 0..3, a lane's tig). So the s8 piece at 16*l
// holds the 16 k of the two bf16 h pieces a lane stages at 8*l and 32 +
// 8*l, and the 4 lanes of a row copy 64 contiguous bytes of h in each of
// their two copies (full 32-byte sectors).
__host__ __device__ constexpr int q_pos(int k) {
  return k / MKC * MKC + 16 * (k % 32 / 8) + 8 * (k % MKC / 32) + k % 8;
}

// qt[d][n][q_pos(k)] = q[d][k][n] + 128 (as unsigned bytes: the loop's
// widening takes them so) for n < 4H, k < H, and 0 + 128 for H <= k < Hp,
// the row length: H rounded up to MKC.
// grid = (ceil(4H/TT), Hp/TT, D), block = (TT, 8).
__global__ void __launch_bounds__(TT * 8)
lstm_fwd_q_stream_transpose_kernel(const int8_t* __restrict__ q,
                                   int8_t* __restrict__ qt, int H,
                                   int Hp) {
  __shared__ int8_t tile[TT][TT + 1];
  const size_t N = 4 * size_t(H);
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  const int8_t* src = q + size_t(blockIdx.z) * H * N;
  int8_t* dst = qt + size_t(blockIdx.z) * N * Hp;
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int k = k0 + r, n = n0 + threadIdx.x;
    tile[r][threadIdx.x] =
        k < H && n < N ? src[size_t(k) * N + n] : int8_t(0);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int n = n0 + r, k = k0 + threadIdx.x;
    if (n < N)
      dst[size_t(n) * Hp + q_pos(k)] = int8_t(tile[threadIdx.x][r] ^ 0x80);
  }
}

// Serial loop.
constexpr int MU = 32;                  // hidden units per group
constexpr int GCOL = 4 * MU;            // a group's gate columns: Qt rows
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int MROWS = 32;               // batch rows per pass: two m16 tiles
constexpr int QROWS = MROWS / M_WARPS;  // rows per thread, elementwise step
constexpr int MS = 2;                   // cp.async stages of a warp's ring
constexpr int NW_N = 2;                 // warps over the group's columns
constexpr int NW_K = M_WARPS / NW_N;    // warps over the depth H
constexpr int NCOL = GCOL / NW_N;       // a warp's columns
constexpr int NT = NCOL / 8;            // its n8 tiles
constexpr int HP = 8;                   // a lane's 16-byte pieces of the h
                                        // row a chunk: 4 rows x 2 x 8 k
constexpr int PIECES = HP + NT;         // and NT of Qt, 16 k of a row each
constexpr int RING = MS * PIECES * 32;  // uint4 of a warp's ring
// A warp's first W_RES chunks of Qt (3 of 7 at H=1760: 43% of the group's
// slice, 96 KB beside the rings' 128 KB) are copied into shared memory
// once and stay there for the whole call, when a block has one group; the
// rest streams every step. RES_BF16 1 holds them widened to bf16 (twice
// the bytes, no widening in the step). deepspeech_tpu_torch/
// k17_variants.py times these choices beside the others tried.
constexpr int W_RES = 3;
constexpr int RES_BF16 = 0;
constexpr int RES_PIECE = RES_BF16 ? 2 : 1;  // uint4 of a resident piece
constexpr int RES = W_RES * NT * 32 * RES_PIECE;  // uint4 of a warp's
constexpr int RED_S = GCOL + 8;         // partial-sum row stride, floats
// The warps' partial sums alias the rings, which are drained by then.
constexpr size_t MMA_SMEM = sizeof(uint4) * (RING + RES) * M_WARPS;
static_assert(sizeof(float) * NW_K * MROWS * RED_S <=
                  sizeof(uint4) * RING * M_WARPS,
              "partial sums must fit the rings");
static_assert(MMA_SMEM <= 232448, "a block has 227 KB of shared memory");

// A lane of the warp that takes columns wn*NCOL.. and chunks kw,
// kw + NW_K, ... stages its NT 16-byte s8 pieces of Qt's rows for its
// chunk `it` at `dst` (NT x 32 uint4): the row (gate c / MU, unit
// j0 + c % MU) of column c = wn*NCOL + 8*nt + lane/4, positions 16*tig ..
// 16*tig+15 of the chunk (zero past H: the rows are padded to Hp). A unit
// past H gets zero bytes, which widen to -128; H % 8 == 0 puts it in an n8
// tile whose units all lie past H, and the loop skips that tile.
__device__ __forceinline__ void stage_q(uint4* dst, int it, int kw, int wn,
                                        int lane, int j0, int H, int Hp,
                                        const int8_t* qt_d) {
  const int k = (kw + it * NW_K) * MKC + (lane % 4) * 16;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wn * NCOL + nt * 8 + lane / 4;
    const int u = j0 + c % MU;
    const bool ok = u < H;
    cp_async16(dst + nt * 32 + lane,
               ok ? qt_d + (size_t(c / MU) * H + u) * Hp + k : qt_d, ok);
  }
}

// Needs H % 8 == 0 and a 16-byte aligned scratch: c [D,B,H] f32, then the
// rounded h rows [2][D][B][H] bf16, then Qt [D][4H][Hp] int8 as
// lstm_fwd_q_stream_transpose_kernel wrote it.
__global__ void __launch_bounds__(M_THREADS, 1)
lstm_fwd_q_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                             const float* __restrict__ mask,
                             const float* __restrict__ scale,
                             const float* __restrict__ bias, float* ys,
                             float* scratch, int D, int T, int B, int H,
                             int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wn = warp % NW_N, kw = warp / NW_N;
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) + warp * RING;
  uint4* res_q =
      reinterpret_cast<uint4*>(smem_raw) + M_WARPS * RING + warp * RES;
  float* red = reinterpret_cast<float*>(smem_raw);
  const int nblk = (H + MU - 1) / MU;
  const int groups = D * nblk;
  const int n_chunks = (H + MKC - 1) / MKC;
  const int Hp = n_chunks * MKC;  // a row of Qt
  // This warp's chunks: kw, kw + NW_K, ...
  const int n_mine = (n_chunks - kw + NW_K - 1) / NW_K;
  const int res = gridDim.x >= groups ? (W_RES < n_mine ? W_RES : n_mine)
                                      : 0;
  const size_t H4 = 4 * size_t(H);
  const size_t BH = size_t(B) * H;
  float* c_buf = scratch;
  __nv_bfloat16* hrow = reinterpret_cast<__nv_bfloat16*>(c_buf + D * BH);
  const int8_t* qt = reinterpret_cast<const int8_t*>(hrow + 2 * D * BH);
  cg::grid_group grid = cg::this_grid();

  if (res > 0) {
    const int j0 = (blockIdx.x % nblk) * MU;
    const int8_t* qt_d = qt + size_t(blockIdx.x / nblk) * H4 * Hp;
    for (int it = 0; it < res; ++it) {
      // As s8 straight into place, or through the (free) ring to be
      // widened there once.
      uint4* dst = RES_BF16 ? ring : res_q + it * NT * 32;
      stage_q(dst, it, kw, wn, lane, j0, H, Hp, qt_d);
      cp_async_commit();
      cp_async_wait<0>();  // a lane reads back only its own pieces
      if (RES_BF16) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t b[8];
          widen16(ring[nt * 32 + lane], b);
          uint4* o = res_q + (it * NT + nt) * 2 * 32;
          o[lane] = make_uint4(b[0], b[1], b[2], b[3]);
          o[32 + lane] = make_uint4(b[4], b[5], b[6], b[7]);
        }
      }
    }
  }

  for (int s = 0; s < T; ++s) {
    __nv_bfloat16* h_out = hrow + size_t(s & 1) * D * BH;
    const __nv_bfloat16* h_in = hrow + size_t((s + 1) & 1) * D * BH;
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * MU;
      const int j = j0 + lane;  // the unit this thread updates
      const bool rev = (reverse_bits >> d) & 1;
      const int row = rev ? T - 1 - s : s;
      const int prev = rev ? row + 1 : row - 1;
      const int8_t* qt_d = qt + size_t(d) * H4 * Hp;
      const __nv_bfloat16* h_d = h_in + size_t(d) * BH;
      float* ys_d = ys + size_t(d) * T * BH;
      float* c_d = c_buf + size_t(d) * BH;
      for (int b0 = 0; b0 < B; b0 += MROWS) {
        // The update's inputs, rows b0 + warp + M_WARPS q: issued now,
        // used after the product, which they do not depend on.
        unsigned short x_v[QROWS][4];
        float m_v[QROWS], c_v[QROWS], h_v[QROWS];
#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int b = b0 + warp + M_WARPS * q;
          if (b >= B || j >= H) continue;
          const size_t at = size_t(b) * H + j;
          const unsigned short* x = reinterpret_cast<const unsigned short*>(
              xp + (size_t(row) * B + b) * H4);
#pragma unroll
          for (int e = 0; e < 4; ++e) x_v[q][e] = __ldg(x + e * H + j);
          m_v[q] = __ldg(mask + size_t(row) * B + b);
          c_v[q] = s > 0 ? c_d[at] : 0.f;
          // This thread wrote the previous row's h itself.
          h_v[q] = s > 0 ? __ldcg(ys_d + size_t(prev) * BH + at) : 0.f;
        }

        // gates = round(h_prev) @ Q[:, own columns], on the tensor cores.
        if (s > 0) {
          float acc[2][NT][4] = {};
          const bool m1 = b0 + 16 < B;  // the second m16 tile holds a row
          // The first pass of a step finds Qt's first MS-1 chunks issued
          // before the barrier (below).
          const bool w_issued = gi == blockIdx.x && b0 == 0;
          auto stage = [&](int it) {
            if (it < n_mine) {
              uint4* slot = ring + (it % MS) * PIECES * 32;
              const int k = (kw + it * NW_K) * MKC + tig * 8;
#pragma unroll
              for (int i = 0; i < HP; ++i) {
                // Row p*8+g (m tile p/2, rows +8*(p%2)), k + 32*half.
                const int b = b0 + (i / 2) * 8 + g, kh = k + 32 * (i % 2);
                const bool ok = kh < H && b < B;  // H % 8 == 0: 8 k or none
                cp_async16(slot + i * 32 + lane,
                           ok ? h_d + size_t(b) * H + kh : h_d, ok);
              }
              if (it >= res && !(w_issued && it < MS - 1))
                stage_q(slot + HP * 32, it, kw, wn, lane, j0, H, Hp, qt_d);
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
            const bool held = it < res;
            const uint4* qp = held ? res_q + it * NT * 32 * RES_PIECE
                                   : slot + HP * 32;
            uint4 a[HP];
#pragma unroll
            for (int p = 0; p < HP; ++p) a[p] = slot[p * 32 + lane];
            // Of row p*8+g, the lane's piece 2p holds k = 8*tig .. 8*tig+7
            // of the chunk, 2p+1 holds 32 + 8*tig ..: the 16 k of its s8
            // piece of Qt, in the same order (q_pos). k16 step j takes
            // words 2j%4, 2j%4+1 of piece half j/2 into the fragment slots
            // (2tig, 2tig+1 | 2tig+8, 2tig+9), and the B fragments b[2j],
            // b[2j+1] hold the same k of Qt's row.
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (j0 + (wn * NCOL + nt * 8) % MU >= H) continue;
              uint32_t b[8];
              if (RES_BF16 && held) {
                const uint4 lo = qp[(2 * nt) * 32 + lane];
                const uint4 hi = qp[(2 * nt + 1) * 32 + lane];
                b[0] = lo.x; b[1] = lo.y; b[2] = lo.z; b[3] = lo.w;
                b[4] = hi.x; b[5] = hi.y; b[6] = hi.z; b[7] = hi.w;
              } else {
                widen16(qp[nt * 32 + lane], b);
              }
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                if (mt == 1 && !m1) continue;
                const uint4& r0 = a[4 * mt];       // row 16mt+g, half 0
                const uint4& r0h = a[4 * mt + 1];  // row 16mt+g, half 1
                const uint4& r1 = a[4 * mt + 2];   // row 16mt+8+g
                const uint4& r1h = a[4 * mt + 3];
                mma_bf16(acc[mt][nt], r0.x, r1.x, r0.y, r1.y, b[0], b[1]);
                mma_bf16(acc[mt][nt], r0.z, r1.z, r0.w, r1.w, b[2], b[3]);
                mma_bf16(acc[mt][nt], r0h.x, r1h.x, r0h.y, r1h.y, b[4],
                         b[5]);
                mma_bf16(acc[mt][nt], r0h.z, r1h.z, r0h.w, r1h.w, b[6],
                         b[7]);
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
          float b_[4], s_[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            b_[e] = bias[d * H4 + e * H + j];
            s_[e] = scale[d * H4 + e * H + j];
          }
#pragma unroll
          for (int q = 0; q < QROWS; ++q) {
            const int bl = warp + M_WARPS * q, b = b0 + bl;
            if (b >= B) continue;
            float sum[4] = {0.f, 0.f, 0.f, 0.f};
            if (s > 0) {  // the warps' partial sums, in warp order
#pragma unroll
              for (int kk = 0; kk < NW_K; ++kk)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  sum[e] += red[(kk * MROWS + bl) * RED_S + e * MU + lane];
            }
            const float ig = sigmoid(
                __bfloat162float(__ushort_as_bfloat16(x_v[q][0])) +
                (sum[0] * s_[0] + b_[0]));
            const float fg = sigmoid(
                (__bfloat162float(__ushort_as_bfloat16(x_v[q][1])) +
                 (sum[1] * s_[1] + b_[1])) + 1.f);
            const float gg =
                tanhf(__bfloat162float(__ushort_as_bfloat16(x_v[q][2])) +
                      (sum[2] * s_[2] + b_[2]));
            const float og = sigmoid(
                __bfloat162float(__ushort_as_bfloat16(x_v[q][3])) +
                (sum[3] * s_[3] + b_[3]));
            const float c_new = fg * c_v[q] + ig * gg;
            const float h_new = og * tanhf(c_new);
            const float m = m_v[q];
            const float h = m * h_new + (1.f - m) * h_v[q];
            const float c = m * c_new + (1.f - m) * c_v[q];
            const size_t at = size_t(b) * H + j;
            c_d[at] = c;
            ys_d[size_t(row) * BH + at] = h;
            h_out[size_t(d) * BH + at] = __float2bfloat16_rn(h);
          }
        }
        if (s > 0) __syncthreads();  // red is read: the rings are free
      }
    }
    if (s == T - 1) break;
    // Qt does not wait for the barrier: issue the next step's first chunks
    // for this block's first group (committed with its first chunk of the
    // h row).
    {
      const int j0 = (blockIdx.x % nblk) * MU;
      const int8_t* qt_d = qt + size_t(blockIdx.x / nblk) * H4 * Hp;
      for (int it = res; it < MS - 1 && it < n_mine; ++it)
        stage_q(ring + (it % MS) * PIECES * 32 + HP * 32, it, kw, wn, lane,
                j0, H, Hp, qt_d);
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
template <typename XT>
cudaError_t launch_cuda_core(const void* xp, const float* mask,
                             const int8_t* wq, const float* scale,
                             const float* bias, float* ys, float* c_buf,
                             int D, int T, int B, int H, int reverse_bits,
                             int device, cudaStream_t stream) {
  auto* kernel = lstm_fwd_q_stream_kernel<XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = coop_blocks(reinterpret_cast<const void*>(kernel), THREADS,
                    SMEM_BYTES, D * ((H + U - 1) / U), device, &blocks);
  if (err != cudaSuccess) return err;
  const XT* xp_t = static_cast<const XT*>(xp);
  void* args[] = {&xp_t, &mask, &wq, &scale, &bias, &ys, &c_buf,
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

// The tensor-core path: Q transposed into the scratch, then the serial
// loop.
cudaError_t launch_mma(const void* xp, const float* mask, const int8_t* wq,
                       const float* scale, const float* bias, float* ys,
                       float* scratch, int D, int T, int B, int H,
                       int reverse_bits, int device, cudaStream_t stream) {
  const size_t BH = size_t(B) * H;
  int8_t* qt = reinterpret_cast<int8_t*>(scratch + 2 * D * BH);
  const int Hp = (H + MKC - 1) / MKC * MKC;
  const dim3 t_grid((4 * H + TT - 1) / TT, Hp / TT, D);
  lstm_fwd_q_stream_transpose_kernel<<<t_grid, dim3(TT, 8), 0, stream>>>(
      wq, qt, H, Hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* kernel = lstm_fwd_q_stream_mma_kernel;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(MMA_SMEM));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = coop_blocks(reinterpret_cast<const void*>(kernel), M_THREADS,
                    MMA_SMEM, D * ((H + MU - 1) / MU), device, &blocks);
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  void* args[] = {&xp_t, &mask, &scale, &bias, &ys, &scratch,
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
// xp is bf16 when `bf16` is set, f32 otherwise; wq is int8. A bf16 call
// with H % 8 == 0 and a 16-byte aligned scratch runs the tensor-core path
// (two launches); its scratch holds D*B*H + D*B*H + D*H*Hp floats (c, the
// two bf16 h rows, Qt in int8 with rows of Hp = H rounded up to 64). Any other call runs the CUDA-core kernel,
// whose scratch is c alone, D*B*H floats. The calling thread's current
// device is the same after the call as before it.
int lstm_fwd_q_stream_launch(int bf16, const void* xp, const float* mask,
                             const int8_t* wq, const float* scale,
                             const float* bias, float* ys, float* scratch,
                             int D, int T, int B, int H, int reverse_bits,
                             int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16 && H % 8 == 0 && aligned16(scratch))
    err = launch_mma(xp, mask, wq, scale, bias, ys, scratch, D, T, B, H,
                     reverse_bits, device, st);
  else if (bf16)
    err = launch_cuda_core<__nv_bfloat16>(xp, mask, wq, scale, bias, ys,
                                          scratch, D, T, B, H, reverse_bits,
                                          device, st);
  else
    err = launch_cuda_core<float>(xp, mask, wq, scale, bias, ys, scratch, D,
                                  T, B, H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* lstm_fwd_q_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
