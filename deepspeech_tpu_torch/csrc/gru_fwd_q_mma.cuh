// The tensor-core path of the int8 GRU forward, shared by csrc/gru_fwd_q.cu
// (K10) and csrc/gru_fwd_q_stream.cu (K11): the two compute the same
// function and differ only in how much of Q^T a block holds in shared
// memory, which each source sets with its own constants (NW_N, MS, Q_RES)
// and passes to launch() below with its two kernels.
//
// The contract is ops/gru.py gru_fwd_q's docstring: xp [T,B,3H] bf16 (xp
// includes the input bias), mask [T,B] f32, wq [D,H,3H] int8, scale [D,3H]
// f32 (per output channel), bias [D,3H] f32, h0 [D,B,H] f32 or NULL, reverse
// bit d set for a direction that runs t = T-1..0 -> ys [D,T,B,H] f32 (every
// row, masked rows hold h), hfin [D,B,H] f32. Gates: (round_bf16(h_prev) @
// Q) * scale + b, the sum in f32 and the scale on the finished column sum;
// b_n joins h Q_n before r multiplies it; then the GRU update and the mask.
//
// Two launches from one C call, chosen before either:
//  1. transpose(): Qt [D,3H,Hp] = Q^T into the scratch, once a call (9.5
//     MB a direction at ds2_full), csrc/lstm_fwd_q_stream.cu's (K17)
//     layout: each byte biased to q + 128 (what widen4 takes), each row
//     padded to Hp = H rounded up to 64 and its k permuted within each
//     64-deep chunk by q_pos, so that a lane's 16-byte s8 piece holds the
//     16 k of its two 16-byte bf16 pieces of the h row, and the 4 lanes of
//     an h row copy 64 contiguous bytes. With h0, the grid's threads also
//     write round_bf16(h0) into the h row that step 0 reads, as csrc/
//     gru_fwd_stream.cu's (K8) transpose does: the launch boundary orders
//     it before the loop, so no grid barrier is added.
//  2. loop(): K17's serial loop with K8's three gates. A cooperative,
//     persistent grid over D x ceil(H/32) groups of MU=32 hidden units
//     (gate columns j, H+j, 2H+j: 96 rows of Qt), one group a block and
//     one block an SM (110 groups at ds2_full), one grid barrier a step;
//     where groups outnumber the SMs (H=2176 at D=2) blocks walk two
//     groups and hold no Q^T. A group forms its [B, 96] gate sums with
//     mma.sync.m16n8k16, bf16 operands and f32 sums. Its 8 warps split
//     the product NW_N ways over the 96 columns (2: 48 columns, six n8
//     tiles a warp) and NW_K ways over H (4: every NW_K-th 64-deep chunk),
//     for 32 batch rows (two m16 tiles) at a time. A lane widens each s8
//     piece exactly to the bf16 B fragments of its chunk's four k16 steps
//     in registers (prmt into an f32 with exponent 2^23, one fsub, prmt:
//     K17's widen16), once for both m16 tiles.
//     The h row is what a step must move from L2: the NW_N warps of a
//     depth split share one MS-stage cp.async ring of its pieces (each
//     copies 1/NW_N of them; a named barrier of those warps a chunk makes
//     them visible and frees the slot read the chunk before), so a block
//     reads the h row from L2 once a step, and the ring takes MS x 16 KB.
//     The first `res` chunks of each warp's Qt slice are copied into
//     shared memory once and stay for the whole call; any further chunk
//     streams through the warp's own MS-stage ring of s8 pieces, which a
//     lane copies and reads back itself. The warps' partial sums meet in
//     shared memory (over the drained rings) and are added in warp order:
//     no atomics, the same bits on every run. Then acc * scale + b, the GRU
//     update and the mask, from xp, the mask and the f32 h_prev loaded
//     before the product (which does not wait for them): h_prev is h0 at
//     step 0 and the ys row the owning thread wrote the step before, never
//     the rounded row. The step writes ys, hfin at the last step, and
//     round_bf16(h) into a [2,D,B,H] bf16 row, double-buffered by step
//     parity so that a fast group's write cannot meet a slow group's read
//     of the step before. That row is the next step's A operand, read
//     through L2 (.cg: other blocks wrote it before the barrier). Step 0
//     without h0 has h_prev = 0 and no product.
//
// Shared memory of a block: the rings region (h rings, then Q rings when
// some chunk streams; the partial sums alias its start, so it is at least
// their 52 KB), then the resident chunks, 24 KB each across the 8 warps.
// At ds2_full (7 chunks a warp) all of a group's 172 KB of Qt fits beside
// the 52 KB region: a step then moves only the h row (113 KB a block) from
// L2. Per SM and step: 10.8 MFLOP and 42 widened pieces a lane. What a
// step costs is not bytes: on an H100 the loop takes 14.3 us a step at
// ds2_full with all of Q^T resident and 16.2 with all of it streamed, 12.5
// at B=1, and a third stage of the rings changes nothing. Each of a
// warp's 7 chunks adds about 1.45 us (5.5 a step with one chunk a warp);
// taking the mma.sync out saves 2.5 us a step, the widening 1.4, the grid
// barrier 1.3, the h copies 0.6 (k10_variants' ablations).
//
// Needs H % 8 == 0 (a 16-byte piece holds 8 bf16 of h or none) and a
// 16-byte aligned scratch: the rounded h rows [2][D][B][H] bf16 (parity 1
// holding round(h0) when h0 is given), then Qt [D][3H][Hp] as bytes.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gru_q_mma {

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

// A barrier of the `count` threads (whole warps) that name barrier `id`.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float bf16_bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
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

// qt[d][n][q_pos(k)] = q[d][k][n] + 128 (as unsigned bytes: widen4 takes
// them so) for n < 3H, k < H, and 0 + 128 for H <= k < Hp, the row length:
// H rounded up to MKC. With h0, the grid's threads also write h_row[i] =
// round_bf16(h0[i]) for the n_h values of h0, in a grid-stride loop.
// grid = (ceil(3H/TT), Hp/TT, D), block = (TT, 8).
__device__ __forceinline__ void transpose(const int8_t* __restrict__ q,
                                          int8_t* __restrict__ qt,
                                          const float* __restrict__ h0,
                                          __nv_bfloat16* __restrict__ h_row,
                                          size_t n_h, int H, int Hp) {
  __shared__ int8_t tile[TT][TT + 1];
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
constexpr int GCOL = 3 * MU;            // a group's gate columns: Qt rows
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int MROWS = 32;               // batch rows per pass: two m16 tiles
constexpr int QROWS = MROWS / M_WARPS;  // rows per thread, elementwise step
constexpr int HP = 8;                   // 16-byte pieces of the h row a
                                        // lane's fragments take a chunk:
                                        // 4 rows x 2 x 8 k
constexpr int RED_S = GCOL + 8;         // partial-sum row stride, floats

// The loop's shared-memory plan for NW_N column splits and MS stages, in
// uint4, the same on the host (launch) and in the kernel.
template <int NW_N, int MS> struct Plan {
  static_assert(NW_N == 1 || NW_N == 2 || NW_N == 4,
                "whole n8 tiles a warp and whole h pieces a lane");
  static_assert(MS >= 2, "a ring holds the chunk read and one in flight");
  static constexpr int NW_K = M_WARPS / NW_N;  // warps over the depth H
  static constexpr int NCOL = GCOL / NW_N;     // a warp's columns
  static constexpr int NT = NCOL / 8;          // its n8 tiles
  static constexpr int H_SHARE = HP / NW_N;    // h pieces a lane copies
  static constexpr int H_SLOT = HP * 32;       // a depth split's h chunk
  static constexpr int Q_SLOT = NT * 32;       // a warp's Qt chunk
  static constexpr int H_RING = NW_K * MS * H_SLOT;
  static constexpr int Q_RING = M_WARPS * MS * Q_SLOT;
  static constexpr int RED = (NW_K * MROWS * RED_S + 3) / 4;
  // The rings region: the h rings, then the Q rings when a chunk streams;
  // the partial sums alias it.
  __host__ __device__ static constexpr int rings(bool streams) {
    return H_RING + (streams ? Q_RING : 0) > RED
               ? H_RING + (streams ? Q_RING : 0)
               : RED;
  }
  // Chunks of a warp over the depth: the most any warp takes.
  __host__ __device__ static constexpr int most_chunks(int H) {
    return ((H + MKC - 1) / MKC + NW_K - 1) / NW_K;
  }
  __host__ __device__ static constexpr size_t smem(int res, int H) {
    return sizeof(uint4) *
           (size_t(rings(res < most_chunks(H))) + size_t(res) * M_WARPS *
                                                      Q_SLOT);
  }
};

// A lane of the warp that takes columns wn*NCOL.. and chunks kw,
// kw + NW_K, ... stages its NT 16-byte s8 pieces of Qt's rows for its
// chunk `it` at `dst` (NT x 32 uint4): the row (gate c / MU, unit
// j0 + c % MU) of column c = wn*NCOL + 8*nt + lane/4, positions 16*tig ..
// 16*tig+15 of the chunk (the rows are padded to Hp). A unit past H gets
// zero bytes; H % 8 == 0 puts it in an n8 tile whose units all lie past
// H, and the loop skips that tile.
template <int NW_N, int MS>
__device__ __forceinline__ void stage_q(uint4* dst, int it, int kw, int wn,
                                        int lane, int j0, int H, int Hp,
                                        const int8_t* qt_d) {
  using P = Plan<NW_N, MS>;
  const int k = (kw + it * P::NW_K) * MKC + (lane % 4) * 16;
#pragma unroll
  for (int nt = 0; nt < P::NT; ++nt) {
    const int c = wn * P::NCOL + nt * 8 + lane / 4;
    const int u = j0 + c % MU;
    const bool ok = u < H;
    cp_async16(dst + nt * 32 + lane,
               ok ? qt_d + (size_t(c / MU) * H + u) * Hp + k : qt_d, ok);
  }
}

// The serial loop; `res` chunks of each warp's Qt stay resident (0 where
// the grid has fewer blocks than groups), as launch() chose them.
template <int NW_N, int MS>
__device__ __forceinline__ void loop(const __nv_bfloat16* __restrict__ xp,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ bias,
                                     const float* __restrict__ h0, float* ys,
                                     float* hfin, float* scratch, int D,
                                     int T, int B, int H, int reverse_bits,
                                     int res) {
  using P = Plan<NW_N, MS>;
  constexpr int NW_K = P::NW_K, NCOL = P::NCOL, NT = P::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  const int wn = warp % NW_N, kw = warp / NW_N;
  uint4* base = reinterpret_cast<uint4*>(smem_raw);
  uint4* h_ring = base + kw * MS * P::H_SLOT;  // shared by the NW_N warps
  uint4* q_ring = base + P::H_RING + warp * MS * P::Q_SLOT;
  uint4* res_q = base + P::rings(res < P::most_chunks(H)) +
                 warp * res * P::Q_SLOT;
  float* red = reinterpret_cast<float*>(smem_raw);
  const int nblk = (H + MU - 1) / MU;
  const int groups = D * nblk;
  const int n_chunks = (H + MKC - 1) / MKC;
  const int Hp = n_chunks * MKC;  // a row of Qt
  // This warp's chunks: kw, kw + NW_K, ...
  const int n_mine = (n_chunks - kw + NW_K - 1) / NW_K;
  const int res_w = res < n_mine ? res : n_mine;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;
  __nv_bfloat16* hrow = reinterpret_cast<__nv_bfloat16*>(scratch);
  const int8_t* qt = reinterpret_cast<const int8_t*>(hrow + 2 * D * BH);
  cg::grid_group grid = cg::this_grid();

  if (res_w > 0) {
    const int j0 = (blockIdx.x % nblk) * MU;
    const int8_t* qt_d = qt + size_t(blockIdx.x / nblk) * H3 * Hp;
    for (int it = 0; it < res_w; ++it)
      stage_q<NW_N, MS>(res_q + it * P::Q_SLOT, it, kw, wn, lane, j0, H,
                        Hp, qt_d);
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
      const int8_t* qt_d = qt + size_t(d) * H3 * Hp;
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

        // gates = round(h_prev) @ Q[:, own columns], on the tensor cores.
        if (product) {
          float acc[2][NT][4] = {};
          const bool m1 = b0 + 16 < B;  // the second m16 tile holds a row
          // The first pass of a step after the first finds Qt's first
          // streamed chunks issued before the barrier (below).
          const bool q_issued = s > 0 && gi == blockIdx.x && b0 == 0;
          auto stage = [&](int it) {
            if (it < n_mine) {
              uint4* hs = h_ring + (it % MS) * P::H_SLOT;
              const int k = (kw + it * NW_K) * MKC + tig * 8;
#pragma unroll
              for (int i = 0; i < P::H_SHARE; ++i) {
                // Piece p: row (p/2)*8+g (m tile p/4), k + 32*(p%2).
                const int p = wn * P::H_SHARE + i;
                const int b = b0 + (p / 2) * 8 + g, kh = k + 32 * (p % 2);
                const bool ok = kh < H && b < B;  // H % 8 == 0: 8 k or none
                cp_async16(hs + p * 32 + lane,
                           ok ? h_d + size_t(b) * H + kh : h_d, ok);
              }
              if (it >= res_w && !(q_issued && it < MS - 1))
                stage_q<NW_N, MS>(q_ring + (it % MS) * P::Q_SLOT, it, kw,
                                  wn, lane, j0, H, Hp, qt_d);
            }
            cp_async_commit();
          };
#pragma unroll
          for (int it = 0; it < MS - 1; ++it) stage(it);
          for (int it = 0; it < n_mine; ++it) {
            cp_async_wait<MS - 2>();
            // The depth split's copies of chunk it have landed, and its
            // warps are done with chunk it - 1, whose slot is refilled.
            named_sync(1 + kw, 32 * NW_N);
            stage(it + MS - 1);
            const uint4* hs = h_ring + (it % MS) * P::H_SLOT;
            const uint4* qp = it < res_w ? res_q + it * P::Q_SLOT
                                         : q_ring + (it % MS) * P::Q_SLOT;
            uint4 a[HP];
#pragma unroll
            for (int p = 0; p < HP; ++p) a[p] = hs[p * 32 + lane];
            // Of row p*8+g, the lane's piece 2p holds k = 8*tig .. 8*tig+7
            // of the chunk, 2p+1 holds 32 + 8*tig ..: the 16 k of its s8
            // piece of Qt, in the same order (q_pos). k16 step j takes
            // words 2j%4, 2j%4+1 of piece half j/2 into the fragment slots
            // (2tig, 2tig+1 | 2tig+8, 2tig+9), and the B fragments b[2j],
            // b[2j+1] hold the same k of Qt's row.
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              if (j0 + (wn * NCOL + nt * 8) % MU >= H) continue;
              uint32_t bq[8];
              widen16(qp[nt * 32 + lane], bq);
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                if (mt == 1 && !m1) continue;
                const uint4& r0 = a[4 * mt];       // row 16mt+g, half 0
                const uint4& r0h = a[4 * mt + 1];  // row 16mt+g, half 1
                const uint4& r1 = a[4 * mt + 2];   // row 16mt+8+g
                const uint4& r1h = a[4 * mt + 3];
                mma_bf16(acc[mt][nt], r0.x, r1.x, r0.y, r1.y, bq[0], bq[1]);
                mma_bf16(acc[mt][nt], r0.z, r1.z, r0.w, r1.w, bq[2], bq[3]);
                mma_bf16(acc[mt][nt], r0h.x, r1h.x, r0h.y, r1h.y, bq[4],
                         bq[5]);
                mma_bf16(acc[mt][nt], r0h.z, r1h.z, r0h.w, r1h.w, bq[6],
                         bq[7]);
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
          float b_[3], s_[3];
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            b_[e] = bias[d * H3 + e * H + j];
            s_[e] = scale[d * H3 + e * H + j];
          }
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
            const float r =
                sigmoid(bf16_bits_f32(x_v[q][0]) + (sum[0] * s_[0] + b_[0]));
            const float z =
                sigmoid(bf16_bits_f32(x_v[q][1]) + (sum[1] * s_[1] + b_[1]));
            const float n = tanhf(bf16_bits_f32(x_v[q][2]) +
                                  r * (sum[2] * s_[2] + b_[2]));
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
    // Qt does not wait for the barrier: issue the next step's first
    // streamed chunks for this block's first group (committed with its
    // first chunk of the h row).
    {
      const int j0 = (blockIdx.x % nblk) * MU;
      const int8_t* qt_d = qt + size_t(blockIdx.x / nblk) * H3 * Hp;
      for (int it = res_w; it < MS - 1 && it < n_mine; ++it)
        stage_q<NW_N, MS>(q_ring + (it % MS) * P::Q_SLOT, it, kw, wn, lane,
                          j0, H, Hp, qt_d);
    }
    grid.sync();
  }
}

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

using TransposeKernel = void (*)(const int8_t*, int8_t*, const float*,
                                 __nv_bfloat16*, size_t, int, int);
using LoopKernel = void (*)(const __nv_bfloat16*, const float*, const float*,
                            const float*, const float*, float*, float*,
                            float*, int, int, int, int, int, int);

// The resident chunks a warp holds: as many as RES_MAX allows and fit a
// block's shared memory beside the rings, when every group has a block of
// its own; else none.
template <int NW_N, int MS, int RES_MAX>
cudaError_t plan_res(LoopKernel kernel, int D, int H, int device, int* res,
                     size_t* smem, int* blocks) {
  using P = Plan<NW_N, MS>;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  const int groups = D * ((H + MU - 1) / MU);
  int r = P::most_chunks(H) < RES_MAX ? P::most_chunks(H) : RES_MAX;
  while (r > 0 && P::smem(r, H) > size_t(optin)) --r;
  for (;;) {
    *smem = P::smem(r, H);
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(*smem));
    if (err != cudaSuccess) return err;
    err = coop_blocks(reinterpret_cast<const void*>(kernel), M_THREADS,
                      *smem, groups, device, blocks);
    if (err != cudaSuccess) return err;
    if (r == 0 || *blocks >= groups) break;
    r = 0;  // blocks walk groups: nothing resident
  }
  *res = r;
  return cudaSuccess;
}

// The two launches: Q transposed (and h0 rounded) into the scratch, then
// the serial loop with RES_MAX chunks of a warp's Qt resident at most.
template <int NW_N, int MS, int RES_MAX>
cudaError_t launch(TransposeKernel transpose_kernel, LoopKernel loop_kernel,
                   const void* xp, const float* mask, const int8_t* wq,
                   const float* scale, const float* bias, const float* h0,
                   float* ys, float* hfin, float* scratch, int D, int T,
                   int B, int H, int reverse_bits, int device,
                   cudaStream_t stream) {
  const size_t dbh = size_t(D) * B * H;
  __nv_bfloat16* hrow = reinterpret_cast<__nv_bfloat16*>(scratch);
  int8_t* qt = reinterpret_cast<int8_t*>(hrow + 2 * dbh);
  const int Hp = (H + MKC - 1) / MKC * MKC;
  const dim3 t_grid((3 * H + TT - 1) / TT, Hp / TT, D);
  // round(h0) goes to the row of parity 1, the one step 0 reads.
  transpose_kernel<<<t_grid, dim3(TT, 8), 0, stream>>>(wq, qt, h0,
                                                       hrow + dbh, dbh, H,
                                                       Hp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int res = 0, blocks = 0;
  size_t smem = 0;
  err = plan_res<NW_N, MS, RES_MAX>(loop_kernel, D, H, device, &res, &smem,
                                    &blocks);
  if (err != cudaSuccess) return err;
  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  void* args[] = {&xp_t, &mask, &scale, &bias, &h0, &ys, &hfin, &scratch,
                  &D, &T, &B, &H, &reverse_bits, &res};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(loop_kernel),
                                    dim3(blocks), dim3(M_THREADS), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace gru_q_mma
