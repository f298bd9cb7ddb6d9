// The tensor-core path of the GRU backward, shared by csrc/gru_bwd.cu
// (K5 at D=2 and K7 at D=1, W held in shared memory for the call) and
// csrc/gru_bwd_stream.cu (K9, part of W held and the rest streamed from L2
// every step): the two compute the same function and differ in the width
// of a group and in where its rows of W live, which each source sets with
// the template arguments of loop() and passes to launch() below with its
// own two kernels.
//
// The contract is ops/gru.py gru_bwd's docstring: xp [T,B,3H] and
// w [D,H,3H] bf16, mask [T,B] f32, bias [D,3H] f32, ys [D,T,B,H] f32 (the
// forward's outputs), dy [D,T,B,H] f32, reverse bit d set for a direction
// whose forward ran t = T-1..0
//   -> dxp [D,T,B,3H] f32 = (da_r, da_z, da_n) and dgates [D,T,B,3H] f32
//      = (da_r, da_z, dg_n) at every row.
// Each direction runs against its own forward order from dh = 0; a step
// recomputes the gates from round(h_prev) (the ys row of the forward's
// step before, 0 at its first step), applies _gru_bwd_elt's math
// (deepspeech_tpu/ops/rnn_pallas.py:189) with dh = carry + dy, and
// carries dh_prev = dh_mid z + (1 - m) dh + round(dgates) @ W^T in f32.
//
// Two launches from one C call, chosen before either:
//  1. gates(), a tiled GEMM on the tensor cores: pre[d, row] =
//     round(h_prev(d, row)) @ W[d] + bias[d] for every row at once (M = T*B,
//     N = 3H, K = H), written into the dgates buffer itself (no memory
//     added). The gate recompute reads h_prev from the forward's tape and
//     not from the carried dh, so it leaves the serial chain. 128 x 256
//     block tiles, 8 warps of 64 x 64, K in 32-deep stages, four deep:
//     h_prev's f32 tile and W's bf16 tile by 16-byte cp.async, each thread
//     then rounding the h_prev it copied into a bf16 tile; ldmatrix (.trans
//     for W, whose rows are N-major) and mma.sync.m16n8k16 bf16 with f32
//     sums; pre = sum + bias in f32. N need not fill the last tile.
//  2. loop(), the serial loop: a cooperative, persistent grid over
//     D x ceil(H/MU) groups of MU hidden units, one grid barrier a step. At
//     step i a group forms
//       dh[:, own] = elementwise part + round(dg_{i-1}) @ W[own rows, :]^T
//     on the tensor cores, 3H deep; then the elementwise step from pre (r,
//     z and n pre-activations with their bias, gn = pre_n), xp, the f32
//     h_prev (for dz = dh_mid (h_prev - n), not rounded), dy and the mask,
//     all loaded before the product, which does not wait for them (the
//     gate activations, which need no carry, are taken while the product's
//     first copies are in flight). It writes dxp = (da_r, da_z, da_n),
//     dgates = (da_r, da_z, dg_n) over pre, and round(da_r, da_z, dg_n)
//     into a [B,3H] bf16 row, double-buffered by step parity so that a
//     fast group's write cannot meet a slow group's read of the step
//     before. Each of 8 warps takes every 8th 32-deep chunk of the 3H-deep
//     product for 32 batch rows (two m16 tiles) and the MU units (MU/8 n8
//     tiles). A lane stages 16-byte pieces of the dgates row (read through
//     L2, .cg: other blocks wrote it before the barrier) with cp.async into
//     its warp's own MS-stage ring and reads back only its own pieces, so
//     the product needs no barrier: a piece holds 8 consecutive k of one
//     row, the same permutation of k for both operands, so each is one A or
//     B fragment register of two k16 steps as it lies. W's pieces of a
//     group's rows lie the same way. With W_RES = W_ALL (K5/K7) every chunk
//     of them is copied into shared memory once a call and stays there, and
//     each group has a block of its own. Else (K9) a warp's first W_RES
//     chunks stay when a block has one group, the rest stream through the
//     same ring beside the row's, and the next step's first streamed chunks
//     are issued before the grid barrier, which they do not wait for. The
//     warps' partial sums meet in shared memory (over the drained rings)
//     and are added in warp order: no atomics, the same bits on every run.
//     dh's elementwise part stays with its owning thread (a [D,B,H] f32
//     scratch only it touches).
//
// What a step costs: K5/K7 (H=800, B=32, groups of 16 at D=2, of 8 at
// D=1) take 6.7 us a step at D=2 and 5.4 at D=1 on an H100 80GB HBM3 at
// 700 W. Its parts are latencies: taking out the grid barrier saves 1.6
// / 1.4 us a step, the copies of the dgates row 1.2 / 1.1, the mma.sync
// 1.8 / 0.7, and cutting each warp's 9-10 chunks to one 2.9 / 2.2
// (deepspeech_tpu_torch/k7_variants.py's ablations).
//
// Needs H % 8 == 0 and 16-byte aligned w, ys and scratch (a copy is 4 f32
// of h_prev or 8 bf16 of a row). Scratch: dh's elementwise part [D,B,H]
// f32, then the round(dgates) rows [2][D][B][3H] bf16.

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gru_bwd_mma {

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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---- 1. The gate pre-pass ----

// A block computes PM x PN of pre, 8 warps of 64 x P_WN.
constexpr int P_THREADS = 256;
constexpr int PM = 128, PN = 256, PK = 32;
constexpr int P_WN = PN / 4;        // a warp's columns
constexpr int P_NT = P_WN / 8;      // its n8 tiles
constexpr int PS = 4;               // cp.async stages of both operands
constexpr int PAS = PK + 8;         // rounded h_prev tile row stride, bf16
constexpr int PBS = PN + 8;         // W tile row stride, bf16
constexpr int P_BR = PN / 8;        // 16-byte pieces in a W tile row
constexpr int P_BQ = PK * P_BR / P_THREADS;  // W pieces a thread stages
constexpr int P_F = PM * PK / 4;    // float4 per f32 h_prev stage
constexpr int P_A = PM * PAS;       // bf16 per rounded h_prev tile
constexpr int P_B = PK * PBS;       // bf16 per W stage
constexpr size_t PRE_SMEM = sizeof(float4) * PS * P_F +
                            sizeof(__nv_bfloat16) * (2 * P_A + PS * P_B);

// pre[d] [T*B, 3H] f32 = round(h_prev(d)) @ W[d] + bias[d], where row
// m = t*B + b of h_prev(d) is ys[d] row m - B (forward) or m + B
// (reverse), zero where that falls outside: the forward's first step.
// grid = (N tiles, M tiles (strided), D).
__device__ __forceinline__ void gates(const __nv_bfloat16* __restrict__ w,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ ys,
                                      float* __restrict__ pre, int T, int B,
                                      int H, int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [PS][4][P_THREADS] float4: a thread's 16 staged h_prev values, each
  // float4 of a warp contiguous; then the rounded tile, two buffers; then
  // W's stages.
  float4* f_s = reinterpret_cast<float4*>(smem_raw);
  __nv_bfloat16* a_s = reinterpret_cast<__nv_bfloat16*>(f_s + PS * P_F);
  __nv_bfloat16* b_s = a_s + 2 * P_A;
  const int d = blockIdx.z;
  const bool rev = (reverse_bits >> d) & 1;
  const int M = T * B, N = 3 * H;
  const int n0 = blockIdx.x * PN;
  const __nv_bfloat16* w_d = w + size_t(d) * H * N;
  const float* ys_d = ys + size_t(d) * M * H;
  float* pre_d = pre + size_t(d) * M * N;
  const float* bias_d = bias + size_t(d) * N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int k_tiles = (H + PK - 1) / PK;
  // Staging: h_prev rows ar + 32q, k ak..ak+3 (f32, rounded by this
  // thread into the bf16 tile; a warp's copy covers four whole rows); W
  // rows bk + (P_THREADS / P_BR) q, n bn..bn+7.
  const int ar = threadIdx.x / 8, ak = (threadIdx.x % 8) * 4;
  const int bk = threadIdx.x / P_BR, bn = (threadIdx.x % P_BR) * 8;

  for (int mt = blockIdx.y; mt * PM < M; mt += gridDim.y) {
    const int m0 = mt * PM;
    const float* a_row[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int m = m0 + ar + 32 * q;
      const int src = rev ? m + B : m - B;
      a_row[q] =
          (m < M && src >= 0 && src < M) ? ys_d + size_t(src) * H : nullptr;
    }
    auto fetch = [&](int kt) {
      float4* f = f_s + (kt % PS) * P_F + threadIdx.x;
      const int k = kt * PK + ak;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = a_row[q] != nullptr && k < H;  // 4 k or none
        cp_async16(f + q * P_THREADS, ok ? a_row[q] + k : ys_d, ok);
      }
      __nv_bfloat16* bd = b_s + (kt % PS) * P_B;
#pragma unroll
      for (int q = 0; q < P_BQ; ++q) {
        const int r = bk + (P_THREADS / P_BR) * q;
        const int k = kt * PK + r, n = n0 + bn;
        const bool ok = k < H && n < N;  // N % 8 == 0: 8 columns or none
        cp_async16(bd + r * PBS + bn, ok ? w_d + size_t(k) * N + n : w_d, ok);
      }
    };

    float acc[4][P_NT][4] = {};
#pragma unroll
    for (int s = 0; s < PS - 1; ++s) {
      if (s < k_tiles) fetch(s);
      cp_async_commit();
    }
    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<PS - 2>();
      {  // Round this thread's h_prev of tile kt into the bf16 tile.
        const float4* f = f_s + (kt % PS) * P_F + threadIdx.x;
        __nv_bfloat16* dst = a_s + (kt % 2) * P_A + ar * PAS + ak;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 x = f[q * P_THREADS];
          *reinterpret_cast<uint2*>(dst + 32 * q * PAS) =
              make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
        }
      }
      // Tile kt is in and rounded; every thread is done with tile kt-1,
      // whose stage the next fetch refills (the rounded buffer it wrote
      // was last read at tile kt-2).
      __syncthreads();
      if (kt + PS - 1 < k_tiles) fetch(kt + PS - 1);
      cp_async_commit();
      const __nv_bfloat16* as = a_s + (kt % 2) * P_A;
      const __nv_bfloat16* bs = b_s + (kt % PS) * P_B;
#pragma unroll
      for (int kk = 0; kk < PK; kk += 16) {
        uint32_t af[4][4], bf[P_NT][2];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
          ldsm_x4(af[mi], as + (wm * 64 + mi * 16 + lane % 16) * PAS + kk +
                              (lane / 16) * 8);
#pragma unroll
        for (int np = 0; np < P_NT / 2; ++np) {
          uint32_t r[4];
          ldsm_x4_trans(r, bs + (kk + lane % 8 + ((lane / 8) % 2) * 8) * PBS +
                               wn * P_WN + np * 16 + (lane / 16) * 8);
          bf[2 * np][0] = r[0];
          bf[2 * np][1] = r[1];
          bf[2 * np + 1][0] = r[2];
          bf[2 * np + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi)
#pragma unroll
          for (int ni = 0; ni < P_NT; ++ni)
            mma_bf16(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                     bf[ni][0], bf[ni][1]);
      }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < P_NT; ++ni) {
        const int r = m0 + wm * 64 + mi * 16 + lane / 4;
        const int c = n0 + wn * P_WN + ni * 8 + (lane % 4) * 2;
        if (c >= N) continue;
        const float b0 = bias_d[c], b1 = bias_d[c + 1];
        if (r < M)
          *reinterpret_cast<float2*>(pre_d + size_t(r) * N + c) =
              make_float2(acc[mi][ni][0] + b0, acc[mi][ni][1] + b1);
        if (r + 8 < M)
          *reinterpret_cast<float2*>(pre_d + size_t(r + 8) * N + c) =
              make_float2(acc[mi][ni][2] + b0, acc[mi][ni][3] + b1);
      }
    }
    __syncthreads();  // the next tile refills every stage
  }
}

// ---- 2. The serial loop ----

constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int MROWS = 32;              // batch rows per pass: two m16 tiles
constexpr int MKC = 32;                // depth of a chunk: two k16 steps
constexpr int ROWP = 4;                // a lane's 16-byte pieces of the
                                       // dgates row a chunk
constexpr int W_ALL = -1;              // W_RES: every chunk held, none
                                       // streamed

// The loop's layout for groups of MU units, MS-stage rings, and W_RES of
// a warp's chunks of W held in shared memory for the call (W_ALL: all).
template <int MU, int MS, int W_RES> struct Plan {
  static_assert(MU % 8 == 0 && M_THREADS % MU == 0, "whole n8 tiles");
  static_assert(W_RES == W_ALL || W_RES >= 0, "a count of chunks or W_ALL");
  static constexpr bool ALL = W_RES == W_ALL;        // W never streams
  static constexpr int NT = MU / 8;                  // n8 tiles: units
  static constexpr int QROWS = MROWS * MU / M_THREADS;  // a thread's rows
  static constexpr int RSTEP = M_THREADS / MU;       // apart by RSTEP
  // uint4 of a ring slot: a lane's row pieces, and W's when it streams.
  static constexpr int SLOT = (ROWP + (ALL ? 0 : NT)) * 32;
  static constexpr int RING = MS * SLOT;             // uint4 of a warp's ring
  static constexpr int RED_S = MU + 8;               // partial-sum row stride
  static constexpr int RED = M_WARPS * MROWS * RED_S / 4;  // uint4
  // The warps' partial sums alias the rings, which are drained by then.
  static constexpr int RINGS = M_WARPS * RING > RED ? M_WARPS * RING : RED;
  // A warp's chunks of the 3H-deep product, at most.
  __host__ __device__ static constexpr int chunks(int H) {
    return ((3 * H + MKC - 1) / MKC + M_WARPS - 1) / M_WARPS;
  }
  // The chunks of W a warp holds, at most.
  __host__ __device__ static constexpr int held(int H) {
    return ALL || W_RES > chunks(H) ? chunks(H) : W_RES;
  }
  // Bytes of a block: the rings, then every warp's held chunks of W, NT
  // pieces a lane each.
  __host__ __device__ static constexpr size_t smem(int H) {
    return 16 * (size_t(RINGS) + size_t(M_WARPS) * held(H) * NT * 32);
  }
};

// Lane `lane` of warp `warp` stages its NT 16-byte pieces of W's rows
// j0.. (units j0 + 8*nt + lane/4) for the warp's chunk `it` at `dst`
// (NT x 32 uint4): 8 consecutive k of one row each.
template <int NT>
__device__ __forceinline__ void stage_w(uint4* dst, int it, int warp,
                                        int lane, int j0, int H,
                                        const __nv_bfloat16* w_d) {
  const int N = 3 * H;
  const int k = (warp + it * M_WARPS) * MKC + (lane % 4) * 8;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int u = j0 + nt * 8 + lane / 4;
    const bool ok = k < N && u < H;  // N % 8 == 0: 8 k or none
    cp_async16(dst + nt * 32 + lane, ok ? w_d + size_t(u) * N + k : w_d, ok);
  }
}

// A step's gate activations, which need no carry: from xp's bf16 bits
// and the pre-pass's pre (bias included).
struct Act {
  float rr, z, n, gn;
};
__device__ __forceinline__ Act activate(const unsigned short* x,
                                        const float* pre) {
  Act a;
  a.gn = pre[2];
  a.rr = sigmoid(bf16_bits_f32(x[0]) + pre[0]);
  a.z = sigmoid(bf16_bits_f32(x[1]) + pre[1]);
  a.n = tanhf(bf16_bits_f32(x[2]) + a.rr * a.gn);
  return a;
}

// _gru_bwd_elt's step once the carry is known: dh = carry + dy, h_prev
// in f32 -> (da_r, da_z, da_n, dg_n) and dh_prev's elementwise part.
__device__ __forceinline__ void bptt(const Act& a, float h_prev, float m,
                                     float carry, float dy, float* da,
                                     float* de_out) {
  const float dh = carry + dy;
  const float dh_mid = m * dh;
  const float dn = dh_mid * (1.f - a.z);
  const float dz = dh_mid * (h_prev - a.n);
  const float da_n = dn * (1.f - a.n * a.n);
  const float dr = da_n * a.gn;
  da[3] = da_n * a.rr;                      // dg_n
  da[2] = da_n;
  da[1] = dz * a.z * (1.f - a.z);
  da[0] = dr * a.rr * (1.f - a.rr);
  *de_out = dh_mid * a.z + (1.f - m) * dh;
}

// dgates holds pre on entry.
template <int MU, int MS, int W_RES>
__device__ __forceinline__ void loop(const __nv_bfloat16* __restrict__ xp,
                                     const float* __restrict__ mask,
                                     const __nv_bfloat16* __restrict__ w,
                                     const float* __restrict__ ys,
                                     const float* __restrict__ dy,
                                     float* __restrict__ dxp, float* dgates,
                                     float* scratch, int D, int T, int B,
                                     int H, int reverse_bits) {
  using P = Plan<MU, MS, W_RES>;
  constexpr int NT = P::NT, QROWS = P::QROWS, RSTEP = P::RSTEP;
  constexpr int SLOT = P::SLOT, RED_S = P::RED_S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) + warp * P::RING;
  float* red = reinterpret_cast<float*>(smem_raw);
  const int nblk = (H + MU - 1) / MU;
  const int groups = D * nblk;
  const int N = 3 * H;  // gate columns: the product's depth
  const int n_chunks = (N + MKC - 1) / MKC;
  // This warp's chunks: warp, warp + M_WARPS, ...
  const int n_mine = (n_chunks - warp + M_WARPS - 1) / M_WARPS;
  // The chunks it holds for the call: all (W_ALL, a block a group), or
  // its first W_RES when a block has one group.
  const int res = P::ALL ? n_mine
                  : gridDim.x >= groups ? (W_RES < n_mine ? W_RES : n_mine)
                                        : 0;
  // The elementwise step's unit and first row of this thread.
  const int lu = threadIdx.x % MU, r0 = threadIdx.x / MU;
  const size_t BH = size_t(B) * H;
  float* de_buf = scratch;
  __nv_bfloat16* dgr =
      reinterpret_cast<__nv_bfloat16*>(scratch + size_t(D) * BH);
  cg::grid_group grid = cg::this_grid();
  uint4* res_w = reinterpret_cast<uint4*>(smem_raw) + P::RINGS +
                 warp * P::held(H) * NT * 32;
  if (res > 0) {
    const int j0 = (blockIdx.x % nblk) * MU;
    const __nv_bfloat16* w_d = w + size_t(blockIdx.x / nblk) * H * N;
    for (int it = 0; it < res; ++it)
      stage_w<NT>(res_w + it * NT * 32, it, warp, lane, j0, H, w_d);
    cp_async_commit();
    cp_async_wait<0>();  // a lane reads back only its own pieces
  }

  for (int i = 0; i < T; ++i) {
    const bool first = i == T - 1;  // the forward's first step: h_prev = 0
    __nv_bfloat16* dgr_i = dgr + size_t(i & 1) * D * B * N;
    const __nv_bfloat16* dgr_prev = dgr + size_t((i + 1) & 1) * D * B * N;
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * MU;
      const int j = j0 + lu;  // the unit this thread owns
      const bool rev = (reverse_bits >> d) & 1;
      // Step i of this direction's BPTT is step T-1-i of its forward.
      const int row = rev ? i : T - 1 - i;
      const size_t prev =
          size_t(d) * T * BH + size_t(rev ? row + 1 : row - 1) * BH;
      const __nv_bfloat16* w_d = w + size_t(d) * H * N;
      const __nv_bfloat16* g_d = dgr_prev + size_t(d) * B * N;
      for (int b0 = 0; b0 < B; b0 += MROWS) {
        // The elementwise step's inputs, rows b0 + r0 + RSTEP q: issued
        // now; the activations, which need no carry, are taken while the
        // product's first copies are in flight.
        float pre_v[QROWS][3], hp_v[QROWS], dy_v[QROWS], m_v[QROWS];
        float de_v[QROWS];
        unsigned short x_v[QROWS][3];
        Act act[QROWS];
#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int b = b0 + r0 + RSTEP * q;
          if (b >= B || j >= H) continue;
          const size_t at = size_t(b) * H + j;
          const float* o = dgates + ((size_t(d) * T + row) * B + b) * N;
          const unsigned short* x = reinterpret_cast<const unsigned short*>(
              xp + (size_t(row) * B + b) * N);
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            pre_v[q][e] = __ldcs(o + e * H + j);
            x_v[q][e] = __ldg(x + e * H + j);
          }
          hp_v[q] = first ? 0.f : __ldg(ys + prev + at);
          dy_v[q] = __ldg(dy + size_t(d) * T * BH + size_t(row) * BH + at);
          m_v[q] = __ldg(mask + size_t(row) * B + b);
          de_v[q] = i > 0 ? de_buf[size_t(d) * BH + at] : 0.f;
        }
        auto activations = [&]() {
#pragma unroll
          for (int q = 0; q < QROWS; ++q)
            if (b0 + r0 + RSTEP * q < B && j < H)
              act[q] = activate(x_v[q], pre_v[q]);
        };

        // dh += round(dg_{i-1}) @ W[own rows, :]^T, on the tensor cores.
        if (i > 0) {
          float acc[2][NT][4] = {};
          const bool m1 = b0 + 16 < B;  // the second m16 tile holds a row
          // The first pass of a step finds W's first streamed chunks
          // issued before the barrier (below).
          const bool w_issued = gi == blockIdx.x && b0 == 0;
          auto stage = [&](int it) {
            if (it < n_mine) {
              uint4* slot = ring + (it % MS) * SLOT;
              const int k = (warp + it * M_WARPS) * MKC + tig * 8;
              const bool k_ok = k < N;  // N % 8 == 0: 8 k or none
#pragma unroll
              for (int p = 0; p < ROWP; ++p) {
                const int b = b0 + p * 8 + g;  // m tile p/2, rows +8*(p%2)
                const bool ok = k_ok && b < B;
                cp_async16(slot + p * 32 + lane,
                           ok ? g_d + size_t(b) * N + k : g_d, ok);
              }
              if constexpr (!P::ALL) {
                if (it >= res && !(w_issued && it < MS - 1))
                  stage_w<NT>(slot + ROWP * 32, it, warp, lane, j0, H, w_d);
              }
            }
            cp_async_commit();
          };
#pragma unroll
          for (int s = 0; s < MS - 1; ++s) stage(s);
          activations();
          for (int it = 0; it < n_mine; ++it) {
            cp_async_wait<MS - 2>();
            // Refills the slot this lane read in the last iteration.
            stage(it + MS - 1);
            const uint4* slot = ring + (it % MS) * SLOT;
            const uint4* wp = P::ALL || it < res ? res_w + it * NT * 32
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
                if (j0 + nt * 8 >= H) continue;
                mma_bf16(acc[mt][nt], a[2 * mt].x, a[2 * mt + 1].x,
                         a[2 * mt].y, a[2 * mt + 1].y, bw[nt].x, bw[nt].y);
                mma_bf16(acc[mt][nt], a[2 * mt].z, a[2 * mt + 1].z,
                         a[2 * mt].w, a[2 * mt + 1].w, bw[nt].z, bw[nt].w);
              }
            }
          }
          cp_async_wait<0>();
          __syncthreads();  // every ring is drained: red may overwrite them
          float* r = red + warp * MROWS * RED_S;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              float* o = r + (mt * 16 + g) * RED_S + nt * 8 + tig * 2;
              *reinterpret_cast<float2*>(o) =
                  make_float2(acc[mt][nt][0], acc[mt][nt][1]);
              *reinterpret_cast<float2*>(o + 8 * RED_S) =
                  make_float2(acc[mt][nt][2], acc[mt][nt][3]);
            }
          __syncthreads();
        } else {
          activations();
        }

#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int bl = r0 + RSTEP * q, b = b0 + bl;
          if (b >= B || j >= H) continue;
          float carry = de_v[q];
          if (i > 0) {
            float s = 0.f;  // the warps' partial sums, in warp order
#pragma unroll
            for (int ww = 0; ww < M_WARPS; ++ww)
              s += red[(ww * MROWS + bl) * RED_S + lu];
            carry += s;
          }
          float da[4];
          bptt(act[q], hp_v[q], m_v[q], carry, dy_v[q], da,
               de_buf + size_t(d) * BH + size_t(b) * H + j);
          const size_t o = ((size_t(d) * T + row) * B + b) * N;
          dxp[o + j] = da[0];
          dxp[o + H + j] = da[1];
          dxp[o + 2 * H + j] = da[2];
          dgates[o + j] = da[0];
          dgates[o + H + j] = da[1];
          dgates[o + 2 * H + j] = da[3];
          __nv_bfloat16* gr = dgr_i + (size_t(d) * B + b) * N;
          gr[j] = __float2bfloat16_rn(da[0]);
          gr[H + j] = __float2bfloat16_rn(da[1]);
          gr[2 * H + j] = __float2bfloat16_rn(da[3]);
        }
        if (i > 0) __syncthreads();  // red is read: the rings are free
      }
    }
    if (first) break;  // no dh_prev past the recurrence's start
    if constexpr (!P::ALL) {
      // W does not wait for the barrier: issue the next step's first
      // streamed chunks for this block's first group (committed with its
      // first chunk of the dgates row).
      const int j0 = (blockIdx.x % nblk) * MU;
      const __nv_bfloat16* w_d = w + size_t(blockIdx.x / nblk) * H * N;
      for (int it = res; it < MS - 1 && it < n_mine; ++it)
        stage_w<NT>(ring + (it % MS) * SLOT + ROWP * 32, it, warp, lane, j0,
                    H, w_d);
    }
    grid.sync();
  }
}

// ---- The launches ----

using GatesKernel = void (*)(const __nv_bfloat16*, const float*,
                             const float*, float*, int, int, int, int);
using LoopKernel = void (*)(const __nv_bfloat16*, const float*,
                            const __nv_bfloat16*, const float*, const float*,
                            float*, float*, float*, int, int, int, int, int);

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

// The two launches: the gate pre-pass into dgates, then the serial loop
// over it, groups of MU units, `smem` bytes a block. With `one_each`
// (W_ALL) every group needs a block of its own, or nothing is launched:
// the residency rule (ops/gru.py resident_fits) admits only such sizes.
inline cudaError_t launch(GatesKernel gates_kernel, LoopKernel loop_kernel,
                          int MU, size_t smem, bool one_each, const void* xp,
                          const float* mask, const void* w,
                          const float* bias, const float* ys,
                          const float* dy, float* dxp, float* dgates,
                          float* scratch, int D, int T, int B, int H,
                          int reverse_bits, int device, cudaStream_t stream) {
  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  const __nv_bfloat16* w_t = static_cast<const __nv_bfloat16*>(w);
  const int groups = D * ((H + MU - 1) / MU);
  cudaError_t err = cudaFuncSetAttribute(
      loop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = coop_blocks(reinterpret_cast<const void*>(loop_kernel), M_THREADS,
                    smem, groups, device, &blocks);
  if (err != cudaSuccess) return err;
  if (one_each && blocks < groups) return cudaErrorCooperativeLaunchTooLarge;

  err = cudaFuncSetAttribute(
      gates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(PRE_SMEM));
  if (err != cudaSuccess) return err;
  const int m_tiles = (T * B + PM - 1) / PM;
  const dim3 pre_grid((3 * H + PN - 1) / PN,
                      m_tiles < 65535 ? m_tiles : 65535, D);
  gates_kernel<<<pre_grid, P_THREADS, PRE_SMEM, stream>>>(
      w_t, bias, ys, dgates, T, B, H, reverse_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  void* args[] = {&xp_t, &mask, &w_t, &ys, &dy, &dxp, &dgates,
                  &scratch, &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(loop_kernel),
                                    dim3(blocks), dim3(M_THREADS), args,
                                    smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace gru_bwd_mma
