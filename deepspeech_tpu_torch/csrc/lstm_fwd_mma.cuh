// The tensor-core path of the LSTM forward, shared by csrc/lstm_fwd.cu
// (K12 at D=2 and D=1, all of W^T held in shared memory for the call),
// csrc/lstm_fwd_stream.cu (K14, part of W^T held and the rest streamed
// from L2 every step) and csrc/lstm_fwd_q.cu (K16, K12's loop on the int8
// Q widened to bf16, with SCALED set): the three differ in the width of a
// group, the split of its warps, where its rows of W^T live and whether
// the finished sums are scaled, which each source sets with the template
// arguments of loop() and passes to launch() below with its own two
// kernels.
//
// The contract is ops/lstm.py lstm_fwd's docstring: xp [T,B,4H] and
// w [D,H,4H] bf16 (xp includes the input bias), mask [T,B] f32, bias
// [D,4H] f32, reverse bit d set for a direction that runs t = T-1..0
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h) and, when cs is
//   not NULL, the cell-state tape cs [D,T,B,H] f32 (masked rows hold c).
// Gates i, f, g, o with the +1 on f; h_prev is rounded to bf16 for the
// product, sums, c and h stay f32. Each direction starts from h = c = 0,
// or, through launch_carry() (K12 and K14), from h0 and c0 [D,B,H] f32,
// either of them NULL for zeros; with hfin and cfin not NULL the last
// step also writes the final h and c [D,B,H] there. With SCALED (ops/lstm.py lstm_fwd_q's contract) W is the int8 Q [D,H,4H]
// and a gate's recurrent part is sum * scale + b, scale [D,4H] f32 on the
// finished column sum; every int8 value is exact in bf16 (8 significant
// bits), so the product is round(h) @ Q exactly as the plain version's.
//
// Two launches from one C call, chosen before either:
//  1. transpose() writes Wt [D,4H,H] bf16 = W^T into the scratch, once a
//     call (from int8 Q, each value widened to bf16 on the way): a 16-byte
//     piece of a Wt row holds 8 consecutive k, which is what the loop's
//     fragments take as they lie.
//  2. loop(), the serial loop: a cooperative, persistent grid over
//     D x ceil(H/MU) groups of MU hidden units (gate columns j, H+j,
//     2H+j, 3H+j: 4*MU rows of Wt), one grid barrier a step. A group
//     forms its [B, 4*MU] gate sums round(h_prev) @ W[:, own columns]
//     with mma.sync.m16n8k16, bf16 operands and f32 sums. Its 8 warps
//     split the product NW_N ways over the 4*MU columns (whole n8 tiles a
//     warp) and NW_K = 8/NW_N ways over H (every NW_K-th 32-deep chunk),
//     for 32 batch rows (two m16 tiles) at a time. Each lane stages
//     16-byte pieces of the h row (and of Wt's rows where they stream)
//     with cp.async into its warp's own MS-stage ring and reads back only
//     its own pieces, so the product needs no barrier; a lane's 4 pieces
//     of a row are k 8l..8l+7 of a chunk, so the 4 lanes of a row copy 64
//     contiguous bytes, whole 32-byte sectors. The warps' partial sums
//     meet in shared memory (over the drained rings) and are added in
//     warp order: no atomics, the same bits on every run. Then the LSTM
//     update and the mask, from xp, the mask, c_prev and the f32 h_prev
//     loaded before the product (which does not wait for them): c stays
//     in a [D,B,H] scratch that only its owning thread touches, and
//     h_prev is the ys row the owning thread wrote the step before, never
//     the rounded row; with SCALED each thread loads its unit's four
//     scales once a call. Thread t updates unit j0 + t % MU for rows t / MU +
//     q * (256 / MU). The step writes c, ys, the tape when cs is not NULL,
//     and round_bf16(h) into a [2,D,B,H] bf16 row, double-buffered by step
//     parity so that a fast group's write cannot meet a slow group's read
//     of the step before. That row is the next step's A operand, read
//     through L2 (.cg: other blocks wrote it before the barrier). Step 0
//     has h_prev = c_prev = 0 and no product; with an h0 it runs the
//     product on round_bf16(h0), which the transpose launch writes into
//     the row of parity 1 (the one step 0 reads), h_prev is the f32 h0
//     and c_prev the f32 c0 (or 0 without one).
//     With W_RES = W_ALL (K12) every chunk of the group's Wt rows is
//     copied into shared memory once a call and stays there, each group
//     has a block of its own, and the ring carries only the h row's
//     pieces. Else (K14) a warp's first W_RES chunks stay when a block has
//     one group, the rest stream through the same ring beside the row's,
//     and the next step's first streamed chunks are issued before the
//     grid barrier, which they do not wait for.
//
// Needs H % 8 == 0 and a 16-byte aligned scratch: c [D][B][H] f32, then
// the rounded h rows [2][D][B][H] bf16 (parity 1 holding round(h0) when
// h0 is given), then Wt [D][4H][H] bf16, 2*D*B*H + 2*D*H*H floats in all.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_fwd_mma {

namespace cg = cooperative_groups;

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

// A value's bf16 bits, widened to f32 only where it is used: a conversion
// right after the load would wait for it.
__device__ __forceinline__ float bf16_bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- 1. W^T, once a call ----

constexpr int TT = 32;  // transpose tile

// A value of W as bf16 bits: bf16 as it is; int8 widened, which is exact.
__device__ __forceinline__ unsigned short bf16_bits(unsigned short x) {
  return x;
}
__device__ __forceinline__ unsigned short bf16_bits(int8_t x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(float(x)));
}

// wt[d][n][k] = w[d][k][n] for n < 4H, k < H (bf16 bits; W bf16 bits or
// int8). grid = (ceil(4H/TT), ceil(H/TT), D), block = (TT, 8).
template <class Src>
__device__ __forceinline__ void transpose(const Src* __restrict__ w,
                                          unsigned short* __restrict__ wt,
                                          int H) {
  __shared__ unsigned short tile[TT][TT + 1];
  const size_t N = 4 * size_t(H);
  const int n0 = blockIdx.x * TT, k0 = blockIdx.y * TT;
  const Src* src = w + size_t(blockIdx.z) * H * N;
  unsigned short* dst = wt + size_t(blockIdx.z) * N * H;
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int k = k0 + r, n = n0 + threadIdx.x;
    if (k < H && n < N)
      tile[r][threadIdx.x] = bf16_bits(src[size_t(k) * N + n]);
  }
  __syncthreads();
  for (int r = threadIdx.y; r < TT; r += 8) {
    const int n = n0 + r, k = k0 + threadIdx.x;
    if (n < N && k < H) dst[size_t(n) * H + k] = tile[threadIdx.x][r];
  }
}

// transpose() with an h0: the grid's threads also write h_row[i] =
// round_bf16(h0[i]) for the n_h values of h0, in a grid-stride loop
// (csrc/gru_fwd_mma.cuh's transpose does the same for the GRU).
template <class Src>
__device__ __forceinline__ void transpose(const Src* __restrict__ w,
                                          unsigned short* __restrict__ wt,
                                          int H, const float* __restrict__ h0,
                                          __nv_bfloat16* __restrict__ h_row,
                                          size_t n_h) {
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
  transpose(w, wt, H);
}

// ---- 2. The serial loop ----

constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int MROWS = 32;   // batch rows per pass: two m16 tiles
constexpr int MKC = 32;     // depth of a chunk: two k16 steps
constexpr int ROWP = 4;     // a lane's 16-byte pieces of the h row a chunk
constexpr int W_ALL = -1;   // W_RES: every chunk held, none streamed

// The loop's layout for groups of MU units, MS-stage rings, W_RES of a
// warp's chunks of Wt held in shared memory for the call (W_ALL: all),
// and NW_N warps over the group's 4*MU columns: under 32 units one warp
// takes them all (four n8 tiles at MU=8, eight at 16) and the 8 warps
// split the depth; K14's 32 units take 2 column x 4 depth splits.
template <int MU, int MS, int W_RES, int NW_N = (MU < 32 ? 1 : 2)>
struct Plan {
  static_assert(MU % 8 == 0 && M_THREADS % MU == 0, "whole n8 tiles");
  static_assert(M_WARPS % NW_N == 0 && 4 * MU % (8 * NW_N) == 0,
                "a warp's columns are whole n8 tiles");
  static_assert(W_RES == W_ALL || W_RES >= 0, "a count of chunks or W_ALL");
  static constexpr bool ALL = W_RES == W_ALL;        // Wt never streams
  static constexpr int UNITS = MU;
  static constexpr int GCOL = 4 * MU;                // a group's Wt rows
  static constexpr int NW_K = M_WARPS / NW_N;        // warps over the depth
  static constexpr int NCOL = GCOL / NW_N;           // a warp's columns
  static constexpr int NT = NCOL / 8;                // its n8 tiles
  static constexpr int QROWS = MROWS * MU / M_THREADS;  // a thread's rows
  static constexpr int RSTEP = M_THREADS / MU;       // apart by RSTEP
  // uint4 of a ring slot: a lane's row pieces, and Wt's when it streams.
  static constexpr int SLOT = (ROWP + (ALL ? 0 : NT)) * 32;
  static constexpr int RING = MS * SLOT;             // uint4 of a warp's ring
  // The partial-sum row stride, 8 (mod 16) floats: the float2 stores of
  // a half-warp's 4 rows fall on 32 different banks.
  static constexpr int RED_S = GCOL + 8 + ((GCOL + 8) % 16 == 0 ? 8 : 0);
  static constexpr int RED = NW_K * MROWS * RED_S / 4;  // uint4
  // The warps' partial sums alias the rings, which are drained by then.
  static constexpr int RINGS = M_WARPS * RING > RED ? M_WARPS * RING : RED;
  // uint4 of a warp's held chunks when W_RES counts them.
  static constexpr int RES = ALL ? 0 : W_RES * NT * 32;
  // The 32-deep chunks of the depth H.
  __host__ __device__ static constexpr int chunks(int H) {
    return (H + MKC - 1) / MKC;
  }
  // Bytes of a block: the rings, then the held chunks of Wt, NT pieces a
  // lane each: with W_ALL every chunk of the group's rows, in chunk order
  // for each column split; else W_RES a warp.
  __host__ __device__ static constexpr size_t smem(int H) {
    return 16 * (size_t(RINGS) + (ALL ? size_t(NW_N) * chunks(H) * NT * 32
                                      : size_t(M_WARPS) * RES));
  }
};

// A lane of the warp that takes columns wn*NCOL.. and chunks kw,
// kw + NW_K, ... stages its NT 16-byte pieces of Wt's rows for its chunk
// `it` at `dst` (NT x 32 uint4): the row (gate c / MU, unit j0 + c % MU)
// of column c = wn*NCOL + 8*nt + lane/4, 8 consecutive k each. Units past
// H are zero-filled (a partial last group; whole n8 tiles, as H % 8 == 0).
template <class P>
__device__ __forceinline__ void stage_w(uint4* dst, int it, int kw, int wn,
                                        int lane, int j0, int H,
                                        const __nv_bfloat16* wt_d) {
  constexpr int MU = P::UNITS;
  const int k = (kw + it * P::NW_K) * MKC + (lane % 4) * 8;
#pragma unroll
  for (int nt = 0; nt < P::NT; ++nt) {
    const int c = wn * P::NCOL + nt * 8 + lane / 4;
    const int u = j0 + c % MU;
    const bool ok = k < H && u < H;  // H % 8 == 0: 8 k or none
    cp_async16(dst + nt * 32 + lane,
               ok ? wt_d + (size_t(c / MU) * H + u) * H + k : wt_d, ok);
  }
}

// The scratch as the top of this file lays it out, Wt as transpose()
// wrote it (and round(h0) with an h0). With SCALED the gates take scale
// [D,4H] on the finished sums (read only then). h0, c0, hfin and cfin as
// the top of this file says; K16 passes none of them.
template <int MU, int MS, int W_RES, int NW_N = (MU < 32 ? 1 : 2),
          bool SCALED = false>
__device__ __forceinline__ void loop(const __nv_bfloat16* __restrict__ xp,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     float* ys, float* cs, float* scratch,
                                     int D, int T, int B, int H,
                                     int reverse_bits,
                                     const float* __restrict__ h0 = nullptr,
                                     const float* __restrict__ c0 = nullptr,
                                     float* hfin = nullptr,
                                     float* cfin = nullptr) {
  using P = Plan<MU, MS, W_RES, NW_N>;
  // A block's one group (W_ALL) reads its scales before the first step.
  static_assert(!SCALED || P::ALL, "the scales of one group a block");
  constexpr int NT = P::NT, NCOL = P::NCOL, NW_K = P::NW_K;
  constexpr int QROWS = P::QROWS, RSTEP = P::RSTEP;
  constexpr int SLOT = P::SLOT, RED_S = P::RED_S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wn = warp % NW_N, kw = warp / NW_N;
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) + warp * P::RING;
  float* red = reinterpret_cast<float*>(smem_raw);
  const int nblk = (H + MU - 1) / MU;
  const int groups = D * nblk;
  const int n_chunks = P::chunks(H);
  // This warp's chunks: kw, kw + NW_K, ...
  const int n_mine = (n_chunks - kw + NW_K - 1) / NW_K;
  // The chunks it holds for the call: all (W_ALL, a block a group), or
  // its first W_RES when a block has one group.
  const int res = P::ALL ? n_mine
                  : gridDim.x >= groups ? (W_RES < n_mine ? W_RES : n_mine)
                                        : 0;
  // Where its held chunk `it` lies: `held + it * held_step`.
  uint4* held =
      reinterpret_cast<uint4*>(smem_raw) + P::RINGS +
      (P::ALL ? (wn * n_chunks + kw) * NT * 32 : warp * P::RES);
  constexpr int held_step = (P::ALL ? NW_K : 1) * NT * 32;
  // The elementwise step's unit and first row of this thread.
  const int lu = threadIdx.x % MU, r0 = threadIdx.x / MU;
  const size_t H4 = 4 * size_t(H);
  const size_t BH = size_t(B) * H;
  float* c_buf = scratch;
  __nv_bfloat16* hrow = reinterpret_cast<__nv_bfloat16*>(c_buf + D * BH);
  const __nv_bfloat16* wt = hrow + 2 * D * BH;
  cg::grid_group grid = cg::this_grid();

  // This thread's unit's four scales (i, f, g, o), for the call.
  float sc[4] = {1.f, 1.f, 1.f, 1.f};
  if constexpr (SCALED) {
    const int j = (blockIdx.x % nblk) * MU + lu;
    if (j < H)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sc[e] = scale[(blockIdx.x / nblk) * H4 + e * H + j];
  }

  if (res > 0) {
    const int j0 = (blockIdx.x % nblk) * MU;
    const __nv_bfloat16* wt_d = wt + size_t(blockIdx.x / nblk) * H4 * H;
    for (int it = 0; it < res; ++it)
      stage_w<P>(held + it * held_step, it, kw, wn, lane, j0, H, wt_d);
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
      const int j = j0 + lu;  // the unit this thread updates
      const bool rev = (reverse_bits >> d) & 1;
      const int row = rev ? T - 1 - s : s;
      const int prev = rev ? row + 1 : row - 1;
      const __nv_bfloat16* wt_d = wt + size_t(d) * H4 * H;
      const __nv_bfloat16* h_d = h_in + size_t(d) * BH;
      float* ys_d = ys + size_t(d) * T * BH;
      float* c_d = c_buf + size_t(d) * BH;
      for (int b0 = 0; b0 < B; b0 += MROWS) {
        // The update's inputs, rows b0 + r0 + RSTEP q: issued now, used
        // after the product, which they do not depend on.
        unsigned short x_v[QROWS][4];
        float m_v[QROWS], c_v[QROWS], h_v[QROWS];
#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int b = b0 + r0 + RSTEP * q;
          if (b >= B || j >= H) continue;
          const size_t at = size_t(b) * H + j;
          const unsigned short* x = reinterpret_cast<const unsigned short*>(
              xp + (size_t(row) * B + b) * H4);
#pragma unroll
          for (int e = 0; e < 4; ++e) x_v[q][e] = __ldg(x + e * H + j);
          m_v[q] = __ldg(mask + size_t(row) * B + b);
          // The carry: h0 and c0 at step 0, else what this thread wrote
          // itself the step before.
          c_v[q] = s > 0 ? c_d[at]
                         : c0 != nullptr ? __ldg(c0 + size_t(d) * BH + at)
                                         : 0.f;
          h_v[q] = s > 0 ? __ldcg(ys_d + size_t(prev) * BH + at)
                         : h0 != nullptr ? __ldg(h0 + size_t(d) * BH + at)
                                         : 0.f;
        }

        // gates = round(h_prev) @ W[:, own columns], on the tensor cores.
        if (product) {
          float acc[2][NT][4] = {};
          const bool m1 = b0 + 16 < B;  // the second m16 tile holds a row
          // The first pass of a step after the first finds Wt's first
          // streamed chunks issued before the barrier (below).
          const bool w_issued = s > 0 && gi == blockIdx.x && b0 == 0;
          auto stage = [&](int it) {
            if (it < n_mine) {
              uint4* slot = ring + (it % MS) * SLOT;
              const int k = (kw + it * NW_K) * MKC + tig * 8;
              const bool k_ok = k < H;  // H % 8 == 0: 8 k or none
#pragma unroll
              for (int p = 0; p < ROWP; ++p) {
                const int b = b0 + p * 8 + g;  // m tile p/2, rows +8*(p%2)
                const bool ok = k_ok && b < B;
                cp_async16(slot + p * 32 + lane,
                           ok ? h_d + size_t(b) * H + k : h_d, ok);
              }
              if constexpr (!P::ALL) {
                if (it >= res && !(w_issued && it < MS - 1))
                  stage_w<P>(slot + ROWP * 32, it, kw, wn, lane, j0, H, wt_d);
              }
            }
            cp_async_commit();
          };
#pragma unroll
          for (int it = 0; it < MS - 1; ++it) stage(it);
          for (int it = 0; it < n_mine; ++it) {
            cp_async_wait<MS - 2>();
            // Refills the slot this lane read in the last iteration.
            stage(it + MS - 1);
            const uint4* slot = ring + (it % MS) * SLOT;
            const uint4* wp = P::ALL || it < res ? held + it * held_step
                                                 : slot + ROWP * 32;
            uint4 a[ROWP], bw[NT];
#pragma unroll
            for (int p = 0; p < ROWP; ++p) a[p] = slot[p * 32 + lane];
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
          const float b_i = bias[d * H4 + j];
          const float b_f = bias[d * H4 + H + j];
          const float b_g = bias[d * H4 + 2 * H + j];
          const float b_o = bias[d * H4 + 3 * H + j];
#pragma unroll
          for (int q = 0; q < QROWS; ++q) {
            const int bl = r0 + RSTEP * q, b = b0 + bl;
            if (b >= B) continue;
            float sum[4] = {0.f, 0.f, 0.f, 0.f};
            if (product) {  // the warps' partial sums, in warp order
#pragma unroll
              for (int kk = 0; kk < NW_K; ++kk)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                  sum[e] += red[(kk * MROWS + bl) * RED_S + e * MU + lu];
            }
            if constexpr (SCALED) {  // the scale on the finished sums
#pragma unroll
              for (int e = 0; e < 4; ++e) sum[e] *= sc[e];
            }
            const float ig =
                sigmoid(bf16_bits_f32(x_v[q][0]) + (sum[0] + b_i));
            const float fg =
                sigmoid((bf16_bits_f32(x_v[q][1]) + (sum[1] + b_f)) + 1.f);
            const float gg = tanhf(bf16_bits_f32(x_v[q][2]) + (sum[2] + b_g));
            const float og =
                sigmoid(bf16_bits_f32(x_v[q][3]) + (sum[3] + b_o));
            const float c_new = fg * c_v[q] + ig * gg;
            const float h_new = og * tanhf(c_new);
            const float m = m_v[q];
            const float h = m * h_new + (1.f - m) * h_v[q];
            const float c = m * c_new + (1.f - m) * c_v[q];
            const size_t at = size_t(b) * H + j;
            c_d[at] = c;
            ys_d[size_t(row) * BH + at] = h;
            if (cs) cs[(size_t(d) * T + row) * BH + at] = c;
            h_out[size_t(d) * BH + at] = __float2bfloat16_rn(h);
            if (hfin != nullptr && s == T - 1) {
              hfin[size_t(d) * BH + at] = h;
              cfin[size_t(d) * BH + at] = c;
            }
          }
        }
        if (product) __syncthreads();  // red is read: the rings are free
      }
    }
    if (s == T - 1) break;
    if constexpr (!P::ALL) {
      // Wt does not wait for the barrier: issue the next step's first
      // streamed chunks for this block's first group (committed with its
      // first chunk of the h row).
      const int j0 = (blockIdx.x % nblk) * MU;
      const __nv_bfloat16* wt_d = wt + size_t(blockIdx.x / nblk) * H4 * H;
      for (int it = res; it < MS - 1 && it < n_mine; ++it)
        stage_w<P>(ring + (it % MS) * SLOT + ROWP * 32, it, kw, wn, lane, j0,
                   H, wt_d);
    }
    grid.sync();
  }
}

// ---- The launches ----

// The transpose takes W's bf16 bits or the int8 Q.
template <class Src>
using TransposeKernel = void (*)(const Src*, unsigned short*, int);
// xp, mask, scale (NULL without SCALED), bias, ys, cs, scratch, D, T, B,
// H, reverse_bits.
using LoopKernel = void (*)(const __nv_bfloat16*, const float*,
                            const float*, const float*, float*, float*,
                            float*, int, int, int, int, int);

// Blocks of a cooperative launch of `kernel`: all resident at once, as
// grid.sync() needs, and no more than `groups`.
inline cudaError_t coop_blocks(const void* kernel, int threads, size_t smem,
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

// The loop kernels of K12 and K14, which take a carry: LoopKernel's
// arguments, then h0, c0, hfin, cfin.
using LoopCarryKernel = void (*)(const __nv_bfloat16*, const float*,
                                 const float*, const float*, float*, float*,
                                 float*, int, int, int, int, int,
                                 const float*, const float*, float*, float*);
// The transpose that also rounds h0 into the h row: w, wt, H, h0, the
// row, its values.
using TransposeCarryKernel = void (*)(const unsigned short*, unsigned short*,
                                      int, const float*, __nv_bfloat16*,
                                      size_t);

// The loop's shared memory and cooperative grid, and where Wt and the
// rounded h rows lie in the scratch. With `one_each` (W_ALL) every group
// needs a block of its own, or nothing is launched: the residency rule
// (ops/gru.py resident_fits) admits only such sizes.
inline cudaError_t loop_grid(const void* loop_kernel, int MU, size_t smem,
                             bool one_each, int D, int H, int device,
                             int* blocks) {
  const int groups = D * ((H + MU - 1) / MU);
  cudaError_t err = cudaFuncSetAttribute(
      loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  err = coop_blocks(loop_kernel, M_THREADS, smem, groups, device, blocks);
  if (err != cudaSuccess) return err;
  if (one_each && *blocks < groups) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}
inline __nv_bfloat16* h_rows(float* scratch, int D, int B, int H) {
  return reinterpret_cast<__nv_bfloat16*>(scratch + size_t(D) * B * H);
}
inline unsigned short* wt_of(float* scratch, int D, int B, int H) {
  return reinterpret_cast<unsigned short*>(h_rows(scratch, D, B, H) +
                                           2 * size_t(D) * B * H);
}
inline dim3 transpose_grid(int D, int H) {
  return dim3((4 * H + TT - 1) / TT, (H + TT - 1) / TT, D);
}

// The two launches: W (bf16, or the int8 Q with `scale`) transposed into
// the scratch, then the serial loop over groups of MU units, `smem` bytes
// a block.
template <class Src>
inline cudaError_t launch(TransposeKernel<Src> transpose_kernel,
                          LoopKernel loop_kernel, int MU, size_t smem,
                          bool one_each, const void* xp, const float* mask,
                          const void* w, const float* scale,
                          const float* bias, float* ys, float* cs,
                          float* scratch, int D, int T, int B, int H,
                          int reverse_bits, int device,
                          cudaStream_t stream) {
  int blocks = 0;
  cudaError_t err = loop_grid(reinterpret_cast<const void*>(loop_kernel), MU,
                              smem, one_each, D, H, device, &blocks);
  if (err != cudaSuccess) return err;
  transpose_kernel<<<transpose_grid(D, H), dim3(TT, 8), 0, stream>>>(
      static_cast<const Src*>(w), wt_of(scratch, D, B, H), H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  void* args[] = {&xp_t, &mask, &scale, &bias, &ys, &cs, &scratch,
                  &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(loop_kernel),
                                    dim3(blocks), dim3(M_THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// launch() for bf16 W with a carry, launch()'s arguments then h0, c0,
// hfin and cfin (any of them NULL): the transpose also rounds h0 into the
// row of parity 1, the one step 0 reads, and the loop takes the four.
inline cudaError_t launch_carry(TransposeCarryKernel transpose_kernel,
                                LoopCarryKernel loop_kernel, int MU,
                                size_t smem, bool one_each, const void* xp,
                                const float* mask, const void* w,
                                const float* scale, const float* bias,
                                float* ys, float* cs, float* scratch, int D,
                                int T, int B, int H, int reverse_bits,
                                int device, cudaStream_t stream,
                                const float* h0, const float* c0,
                                float* hfin, float* cfin) {
  int blocks = 0;
  cudaError_t err = loop_grid(reinterpret_cast<const void*>(loop_kernel), MU,
                              smem, one_each, D, H, device, &blocks);
  if (err != cudaSuccess) return err;
  const size_t dbh = size_t(D) * B * H;
  transpose_kernel<<<transpose_grid(D, H), dim3(TT, 8), 0, stream>>>(
      static_cast<const unsigned short*>(w), wt_of(scratch, D, B, H), H, h0,
      h_rows(scratch, D, B, H) + dbh, dbh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  void* args[] = {&xp_t, &mask, &scale, &bias, &ys, &cs, &scratch,
                  &D, &T, &B, &H, &reverse_bits, &h0, &c0, &hfin, &cfin};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(loop_kernel),
                                    dim3(blocks), dim3(M_THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace lstm_fwd_mma
