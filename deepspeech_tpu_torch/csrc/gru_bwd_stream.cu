// GRU backpropagation through time for Hopper (sm_90a) with W streamed
// from global memory every step: one C call runs the whole reverse time
// loop of D directions at any H, for the sizes whose W does not fit the
// grid's shared memory (ds2_full: H=1760, D=2, W 18.6 MB a direction in
// bf16).
//
// Replaces the TPU kernel _gru_bwd_kernel_blocked (deepspeech_tpu/ops/
// rnn_pallas.py:312, K9, launched by _gru_bwd :898 on a (T, n_blocks)
// grid of [H, c] column blocks), which recomputes a step's gates block by
// block and accumulates the previous step's dgates @ W^T on the same block
// stream. The contract is ops/gru.py gru_bwd's docstring, as for
// csrc/gru_bwd.cu:
//   xp [T,B,3H] and w [D,H,3H] in one dtype, bf16|f32 (the dot dtype),
//   mask [T,B] f32, bias [D,3H] f32, ys [D,T,B,H] f32 (the forward's
//   outputs), dy [D,T,B,H] f32, reverse bit d set for a direction whose
//   forward ran t = T-1..0
//   -> dxp [D,T,B,3H] f32 = (da_r, da_z, da_n) and dgates [D,T,B,3H] f32
//      = (da_r, da_z, dg_n) at every row.
// Each direction runs against its own forward order from dh = 0; a step
// recomputes the gates from h_prev (the ys row of the forward's step
// before, 0 at its first step) rounded to the dot dtype, applies
// _gru_bwd_elt's math (rnn_pallas.py:189) with dh = carry + dy, and
// carries dh_prev = the elementwise terms + round(dgates) @ W^T in f32.
//
// What bounds it: two [T*B,H] x [H,3H]-sized products per direction, the
// gate recompute and round(dgates) @ W^T (1.01 TFLOP each at ds2_full's
// D=2, B=32, T'=850), and dxp and dgates written once (2.3 GB). The gate
// recompute reads h_prev from the forward's tape and so does not depend
// on the carried dh: it is one parallel GEMM. Only round(dgates) @ W^T
// lies on the serial chain: T steps of a [B,3H] x [3H,U] product per group
// of U units, so the time is T times one step's latency, far above both
// bounds. A step's cost is that of the busiest SM: it moves the part of
// W's [U,3H] rows that is not resident and the [B,3H] dgates row (0.68 MB
// at U=32, B=32, all streamed) from L2 through shared memory into 10.8
// MFLOP of mma.sync, then waits at one grid barrier.
//
// bf16 path (the main path) where H % 8 == 0 and w, ys and the scratch
// are 16-byte aligned, two launches from one C entry point:
//  1. gru_bwd_stream_gates_kernel, a tiled GEMM on the tensor cores:
//     pre[d, row] = round(h_prev(d, row)) @ W[d] + bias[d] for every row at
//     once (M = T*B, N = 3H, K = H), written into the dgates buffer itself
//     (no memory added): csrc/lstm_bwd_stream.cu's pre-pass with three
//     gates. 128 x 256 block tiles, 8 warps of 64 x 64, K in 32-deep
//     stages, four deep: h_prev's f32 tile and W's bf16 tile by 16-byte
//     cp.async, each thread then rounding the h_prev it copied into a bf16
//     tile; ldmatrix (.trans for W, whose rows are N-major) and
//     mma.sync.m16n8k16 bf16 with f32 sums; pre = sum + bias in f32. N need
//     not fill the last tile (3H = 5280 = 20 * 256 + 160 at H=1760).
//  2. gru_bwd_stream_mma_kernel, the serial loop: a cooperative,
//     persistent grid over D x ceil(H/32) groups of U=32 hidden units, one
//     group a block and one block an SM (110 groups at ds2_full), with one
//     grid barrier a step. At step i a group forms
//     dh[:, own] = elementwise part + round(dg_{i-1}) @ W[own rows, :]^T
//     on the tensor cores, 3H deep; then the elementwise step from pre (r,
//     z and n pre-activations with their bias, gn = pre_n), xp, the f32
//     h_prev (for dz = dh_mid (h_prev - n), not rounded), dy and the mask,
//     all loaded before the product, which they do not wait for. It writes
//     dxp = (da_r, da_z, da_n), dgates = (da_r, da_z, dg_n) over pre, and
//     round(da_r, da_z, dg_n) into a [B,3H] bf16 row, double-buffered by
//     step parity so that a fast group's write cannot meet a slow group's
//     read of the step before. Each of 8 warps takes every 8th 32-deep
//     chunk of the 3H-deep product (165 chunks at H=1760: 21 or 20 a warp)
//     for 32 batch rows (two m16 tiles) and the 32 units (four n8 tiles).
//     A lane stages 16-byte pieces of the dgates row (read through L2,
//     .cg: other blocks wrote it before the barrier) and of W's rows with
//     cp.async into its warp's own MS-stage ring and reads back only its
//     own pieces, so the product needs no barrier: a piece holds 8
//     consecutive k of one row, the same permutation of k for both
//     operands, so each is one A or B fragment register of two k16 steps
//     as it lies (csrc/lstm_bwd_stream.cu's loop). Each warp's first W_RES
//     chunks of W stay in shared memory for the whole call when a block
//     has one group (csrc/lstm_fwd_stream.cu's lever); the streamed ones
//     of the next step are issued before the grid barrier, which they do
//     not wait for. The warps' partial sums meet in shared memory (over
//     the drained rings) and are added in warp order: no atomics, the same
//     bits on every run. dh's elementwise part stays with its owning
//     thread (a [D,B,H] f32 scratch only it touches). W crosses L2 once a
//     step, by rows, and only its part that is not resident; h_prev
//     leaves the loop. deepspeech_tpu_torch/k9_variants.py times the ring
//     depth and resident share beside the others tried.
//
// f32 path (not the main path; model.dtype=float32) and every other bf16
// call: gru_bwd_stream_kernel, two phases a step on the CUDA cores (no
// TF32). dh_prev[:, k] sums over all 3H gate columns, which no block owns
// alone. csrc/gru_bwd.cu has each column block write partial sums for
// every k and adds them up after the grid barrier: at H=1760, D=2, B=32
// that scratch is 99 MB a step, far over the 50 MB L2. This kernel splits
// each step into two phases instead, over D x ceil(H/U) groups of U=16
// hidden units:
//  1. Column phase. A group streams its [H, 3U] column slice of W
//     (gate columns j, H+j, 2H+j) to recompute its gates, takes the
//     elementwise step, writes dxp and dgates, keeps the elementwise part
//     of dh_prev for its units, and writes round(dgates) for its columns
//     into a [B, 3H] row in the dot dtype. A grid barrier follows.
//  2. Row phase. The same group streams W's rows k of its own units
//     ([U, 3H], contiguous) and the whole round(dgates) row of its
//     direction, and forms dh_prev[:, k] = elementwise part +
//     sum_c round(dgates)[:, c] W[k, c], summed in column order.
// A group owns the same units in both phases, so dh never leaves its
// owner and the row phase of step i runs straight into the column phase
// of step i+1: one grid barrier a step. The dgates row is double-buffered
// by step parity. W crosses L2 twice a step, once by columns and once by
// rows. Each phase stages its operands in KC-wide chunks through shared
// memory as f32, two buffers deep, with the next chunk's global loads
// issued into registers before the current chunk's products run (one
// __syncthreads() per chunk); f32 FMAs on the CUDA cores. The grid is
// cooperative and persistent: as many blocks as fit (at most one per
// group), block g taking groups g, g + grid, ... No atomics.
//
// The choice between the two is made before any launch, from the dtype,
// H and the pointers' alignment (gru_bwd_stream_launch); ops/gru.py's
// _bwd_stream_mma repeats it.


#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per group
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 3 * U;         // gate columns of a group
constexpr int KC = 64;            // chunk width (W rows or gate columns)
constexpr int KS = KC + 4;        // chunk row stride (16-byte aligned rows)
// Column phase: a chunk of W is staged by the first W_THREADS threads,
// each owning one of the group's columns and every KR-th row of the
// chunk (one base pointer and one stride keep the registers few).
constexpr int KR = 4;
constexpr int W_THREADS = KR * GC;            // 192
constexpr int W_STAGE = KC / KR;              // W values per loader
constexpr int H_STAGE = ROWS * KC / THREADS;  // h_prev or dgates per thread
constexpr int R_STAGE = U * KC / THREADS;     // row phase: W per thread
constexpr int HR = THREADS / KC;              // rows per staging sweep
constexpr int BUF = (GC + ROWS) * KS;         // floats per buffer

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Loads of a value's bits, read-only (.nc) or through L2 only (.cg),
// widened to f32 by bits_f32 only where the value is used: a conversion
// right after the load would wait for it, and the prefetch would no
// longer overlap the products.
template <typename T> struct Bits { using type = float; };
template <> struct Bits<__nv_bfloat16> { using type = unsigned short; };
__device__ __forceinline__ float ldg_bits(const float* p) { return __ldg(p); }
__device__ __forceinline__ unsigned short ldg_bits(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float ldcg_bits(const float* p) {
  return __ldcg(p);
}
__device__ __forceinline__ unsigned short ldcg_bits(const __nv_bfloat16* p) {
  return __ldcg(reinterpret_cast<const unsigned short*>(p));
}
__device__ __forceinline__ float bits_f32(float x) { return x; }
__device__ __forceinline__ float bits_f32(unsigned short x) {
  return __bfloat162float(__ushort_as_bfloat16(x));
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A value rounded to the dot dtype, kept as f32.
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
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
gru_bwd_stream_kernel(const WT* __restrict__ xp,
                      const float* __restrict__ mask,
                      const WT* __restrict__ w,
                      const float* __restrict__ bias,
                      const float* __restrict__ ys,
                      const float* __restrict__ dy, float* __restrict__ dxp,
                      float* __restrict__ dgates, float* scratch, int D,
                      int T, int B, int H, int reverse_bits) {
  extern __shared__ __align__(16) float smem[];
  const int nblk = (H + U - 1) / U;
  const int groups = D * nblk;
  const int h_pad = (H + KC - 1) / KC * KC;
  const int c_pad = (3 * H + KC - 1) / KC * KC;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;
  // Scratch: dh carried into a step and the elementwise part of dh_prev,
  // each [D][B][H] f32 and touched only by the thread that owns the unit
  // and row; then round(dgates) rows [2][D][B][3H] in the dot dtype.
  float* dh_buf = scratch;
  float* de_buf = dh_buf + size_t(D) * BH;
  WT* dgr = reinterpret_cast<WT*>(de_buf + size_t(D) * BH);
  cg::grid_group grid = cg::this_grid();

  for (int i = 0; i < T; ++i) {
    const bool last = i == T - 1;  // the forward's first step: h_prev = 0
    WT* dgr_i = dgr + size_t(i & 1) * D * B * H3;

    // 1. Column phase.
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int j = j0 + lu;
      const bool rev = (reverse_bits >> d) & 1;
      // Step i of this direction's BPTT is step T-1-i of its forward.
      const int row = rev ? i : T - 1 - i;
      const WT* w_d = w + size_t(d) * H * H3;
      const float* ys_d = ys + size_t(d) * T * BH;
      const float* hp =
          last ? nullptr : ys_d + size_t(rev ? row + 1 : row - 1) * BH;
      // This thread's W column when it stages W (gate wc / U, unit
      // j0 + wc % U, rows wk, wk + KR, ...) and its h_prev rows and column.
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_loader = threadIdx.x < W_THREADS;
      const bool w_live = j0 + wc % U < H;
      const WT* w_col = w_d + (wc / U) * H + j0 + wc % U;
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][3] = {};
        if (hp != nullptr) {
          typename Bits<WT>::type wpre[W_STAGE];
          float hpre[H_STAGE];
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
              hpre[q] = (b < B && k < H) ? __ldg(hp + size_t(b) * H + k)
                                         : 0.f;
            }
          };
          fetch(0);
          for (int k0 = 0, buf = 0; k0 < h_pad; k0 += KC, buf ^= 1) {
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
          // The next pass fills buffer 0 at once: when the last chunk
          // used it (an odd chunk count), its readers finish first.
          __syncthreads();
        }
        if (j >= H) continue;
        const float b_r = bias[d * H3 + j];
        const float b_z = bias[d * H3 + H + j];
        const float b_n = bias[d * H3 + 2 * H + j];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = b0 + rg + q * RG;
          if (b >= B) continue;
          const float h_prev = hp ? __ldg(hp + size_t(b) * H + j) : 0.f;
          const WT* x = xp + (size_t(row) * B + b) * H3;
          const float gn = acc[q][2] + b_n;
          const float rr = sigmoid(to_f32(x[j]) + (acc[q][0] + b_r));
          const float z = sigmoid(to_f32(x[H + j]) + (acc[q][1] + b_z));
          const float n = tanhf(to_f32(x[2 * H + j]) + rr * gn);
          const float m = mask[size_t(row) * B + b];
          const size_t o_h = size_t(d) * BH + size_t(b) * H + j;
          const float dh = (i > 0 ? dh_buf[o_h] : 0.f) +
                           dy[size_t(d) * T * BH + size_t(row) * BH +
                              size_t(b) * H + j];
          const float dh_mid = m * dh;
          const float dn = dh_mid * (1.f - z);
          const float dz = dh_mid * (h_prev - n);
          const float da_n = dn * (1.f - n * n);
          const float dr = da_n * gn;
          const float dg_n = da_n * rr;
          const float da_z = dz * z * (1.f - z);
          const float da_r = dr * rr * (1.f - rr);
          de_buf[o_h] = dh_mid * z + (1.f - m) * dh;
          const size_t o = (size_t(d) * T + row) * B * H3 + size_t(b) * H3;
          dxp[o + j] = da_r;
          dxp[o + H + j] = da_z;
          dxp[o + 2 * H + j] = da_n;
          dgates[o + j] = da_r;
          dgates[o + H + j] = da_z;
          dgates[o + 2 * H + j] = dg_n;
          WT* g = dgr_i + (size_t(d) * B + b) * H3;
          g[j] = from_f32<WT>(da_r);
          g[H + j] = from_f32<WT>(da_z);
          g[2 * H + j] = from_f32<WT>(dg_n);
        }
      }
    }
    if (last) break;  // no dh_prev past the recurrence's start
    grid.sync();

    // 2. Row phase: dh for the next step, owned units only.
    for (int gi = blockIdx.x; gi < groups; gi += gridDim.x) {
      const int d = gi / nblk;
      const int j0 = (gi % nblk) * U;
      const int k = j0 + lu;
      const WT* w_d = w + size_t(d) * H * H3;
      const WT* g_d = dgr_i + size_t(d) * B * H3;
      // Staging: rows sr, sr + HR, ... (units of W, batch rows of the
      // dgates row), column sc of the chunk.
      const int sr = threadIdx.x / KC, sc = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2] = {0.f, 0.f};
        typename Bits<WT>::type wpre[R_STAGE], gpre[H_STAGE];
        auto fetch = [&](int c0) {
          const int c = c0 + sc;
#pragma unroll
          for (int q = 0; q < R_STAGE; ++q) {
            const int u = j0 + sr + q * HR;
            wpre[q] = (u < H && c < 3 * H) ? ldg_bits(w_d + size_t(u) * H3 + c)
                                           : 0;
          }
#pragma unroll
          for (int q = 0; q < H_STAGE; ++q) {
            const int b = b0 + sr + q * HR;
            // Other blocks wrote this row before the barrier: read it
            // through L2 (.cg), never from a stale L1 line.
            gpre[q] = (b < B && c < 3 * H)
                          ? ldcg_bits(g_d + size_t(b) * H3 + c)
                          : 0;
          }
        };
        fetch(0);
        for (int c0 = 0, buf = 0; c0 < c_pad; c0 += KC, buf ^= 1) {
          float* w_s = smem + buf * BUF;  // [U][KS], c contiguous
          float* g_s = w_s + U * KS;      // [ROWS][KS]
#pragma unroll
          for (int q = 0; q < R_STAGE; ++q)
            w_s[(sr + q * HR) * KS + sc] = bits_f32(wpre[q]);
#pragma unroll
          for (int q = 0; q < H_STAGE; ++q)
            g_s[(sr + q * HR) * KS + sc] = bits_f32(gpre[q]);
          __syncthreads();
          if (c0 + KC < c_pad) fetch(c0 + KC);
          const float* w_k = w_s + lu * KS;
          const float* g_a = g_s + rg * KS;
          const float* g_b = g_s + (rg + RG) * KS;
#pragma unroll 4
          for (int cc = 0; cc < KC; cc += 4) {
            float wk[4], ga[4], gb[4];
            load4(w_k + cc, wk);
            load4(g_a + cc, ga);
            load4(g_b + cc, gb);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              acc[0] = fmaf(ga[e], wk[e], acc[0]);
              acc[1] = fmaf(gb[e], wk[e], acc[1]);
            }
          }
        }
        __syncthreads();  // as in the column phase
        if (k >= H) continue;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int b = b0 + rg + q * RG;
          if (b >= B) continue;
          const size_t o_h = size_t(d) * BH + size_t(b) * H + k;
          dh_buf[o_h] = de_buf[o_h] + acc[q];
        }
      }
    }
  }
}

// ---- bf16 path: tensor-core gate pre-pass and serial loop ----

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

// Gate pre-pass tiles: a block computes PM x PN of pre, 8 warps of
// 64 x P_WN.
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
// grid = (N tiles, M tiles (strided), D). Needs H % 8 == 0 and w and ys
// 16-byte aligned: a copy is 4 f32 of h_prev or 8 bf16 of W.
__global__ void __launch_bounds__(P_THREADS)
gru_bwd_stream_gates_kernel(const __nv_bfloat16* __restrict__ w,
                            const float* __restrict__ bias,
                            const float* __restrict__ ys,
                            float* __restrict__ pre, int T, int B, int H,
                            int reverse_bits) {
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

// Serial loop.
constexpr int MU = 32;                 // hidden units per group
constexpr int M_WARPS = 8;
constexpr int M_THREADS = 32 * M_WARPS;
constexpr int MROWS = 32;              // batch rows per pass: two m16 tiles
constexpr int QROWS = MROWS / M_WARPS; // rows per thread, elementwise step
constexpr int MKC = 32;                // depth of a chunk: two k16 steps
constexpr int MS = 2;                  // cp.async stages of a warp's ring
constexpr int PIECES = 8;              // a lane's 16-byte pieces a chunk:
                                       // 4 of the dgates row, 4 of W
constexpr int RING = MS * PIECES * 32; // uint4 of a warp's ring
// A warp's first W_RES chunks of W (10 of 20 or 21 at H=1760: 48% of the
// group's 338 KB slice, 160 KB beside the rings' 64 KB) are copied into
// shared memory once and stay there for the whole call, when a block has
// one group; the rest streams every step. On an H100 SXM (k9_variants,
// three calls) the loop took 14.6-14.9 ms a call so, 16.2-16.5 with all of
// W streamed, and within the same 0.3 ms with 3 stages and 8 chunks or 4
// and 6, whose order changed from call to call: W (37 MB across the card)
// fits the 50 MB L2 either way, so holding part of it saves its copies,
// not trips to device memory. These 10 chunks hold all of W at H=800
// (8.7 ms a call against 9.3 with 6) and more of it at B=1.
constexpr int W_RES = 10;
constexpr int RES = W_RES * 4 * 32;    // uint4 of a warp's resident chunks
constexpr int RED_S = MU + 8;          // partial-sum row stride, floats
// The warps' partial sums alias the rings, which are drained by then.
constexpr size_t MMA_SMEM = sizeof(uint4) * (RING + RES) * M_WARPS;
static_assert(sizeof(float) * M_WARPS * MROWS * RED_S <=
                  sizeof(uint4) * RING * M_WARPS,
              "partial sums must fit the rings");

// Lane `lane` of warp `warp` stages its four 16-byte pieces of W's rows
// j0.. (units j0 + 8*nt + lane/4) for the warp's chunk `it` at `dst`
// (4 x 32 uint4): 8 consecutive k of one row each.
__device__ __forceinline__ void stage_w(uint4* dst, int it, int warp,
                                        int lane, int j0, int H,
                                        const __nv_bfloat16* w_d) {
  const int N = 3 * H;
  const int k = (warp + it * M_WARPS) * MKC + (lane % 4) * 8;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int u = j0 + nt * 8 + lane / 4;
    const bool ok = k < N && u < H;  // N % 8 == 0: 8 k or none
    cp_async16(dst + nt * 32 + lane, ok ? w_d + size_t(u) * N + k : w_d, ok);
  }
}

// Needs H % 8 == 0 and 16-byte aligned w and scratch (a piece is 8 bf16
// of one row). dgates holds pre on entry. Scratch: dh's elementwise part
// [D,B,H] f32, then (at float 2*D*B*H, where the two-phase kernel keeps
// its rows too) round(dgates) rows [2][D][B][3H] bf16.
__global__ void __launch_bounds__(M_THREADS, 1)
gru_bwd_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                          const float* __restrict__ mask,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ ys,
                          const float* __restrict__ dy,
                          float* __restrict__ dxp, float* dgates,
                          float* scratch, int D, int T, int B, int H,
                          int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, tig = lane % 4;  // mma fragment coordinates
  uint4* ring = reinterpret_cast<uint4*>(smem_raw) + warp * RING;
  uint4* res_w =
      reinterpret_cast<uint4*>(smem_raw) + M_WARPS * RING + warp * RES;
  float* red = reinterpret_cast<float*>(smem_raw);
  const int nblk = (H + MU - 1) / MU;
  const int groups = D * nblk;
  const int N = 3 * H;  // gate columns: the product's depth
  const int n_chunks = (N + MKC - 1) / MKC;
  // This warp's chunks: warp, warp + M_WARPS, ...
  const int n_mine = (n_chunks - warp + M_WARPS - 1) / M_WARPS;
  const int res = gridDim.x >= groups ? (W_RES < n_mine ? W_RES : n_mine)
                                      : 0;
  const size_t BH = size_t(B) * H;
  float* de_buf = scratch;
  __nv_bfloat16* dgr =
      reinterpret_cast<__nv_bfloat16*>(scratch + 2 * size_t(D) * BH);
  cg::grid_group grid = cg::this_grid();

  if (res > 0) {
    const int j0 = (blockIdx.x % nblk) * MU;
    const __nv_bfloat16* w_d = w + size_t(blockIdx.x / nblk) * H * N;
    for (int it = 0; it < res; ++it)
      stage_w(res_w + it * 4 * 32, it, warp, lane, j0, H, w_d);
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
      const int j = j0 + lane;  // the unit this thread owns
      const bool rev = (reverse_bits >> d) & 1;
      // Step i of this direction's BPTT is step T-1-i of its forward.
      const int row = rev ? i : T - 1 - i;
      const size_t prev =
          size_t(d) * T * BH + size_t(rev ? row + 1 : row - 1) * BH;
      const __nv_bfloat16* w_d = w + size_t(d) * H * N;
      const __nv_bfloat16* g_d = dgr_prev + size_t(d) * B * N;
      for (int b0 = 0; b0 < B; b0 += MROWS) {
        // The elementwise step's inputs, rows b0 + warp + M_WARPS q:
        // issued now, used after the product, which they do not depend on.
        float pre_v[QROWS][3], hp_v[QROWS], dy_v[QROWS], m_v[QROWS];
        float de_v[QROWS];
        unsigned short x_v[QROWS][3];
#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int b = b0 + warp + M_WARPS * q;
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

        // dh += round(dg_{i-1}) @ W[own rows, :]^T, on the tensor cores.
        if (i > 0) {
          float acc[2][4][4] = {};
          const bool m1 = b0 + 16 < B;  // the second m16 tile holds a row
          // The first pass of a step finds W's first streamed chunks
          // issued before the barrier (below).
          const bool w_issued = gi == blockIdx.x && b0 == 0;
          auto stage = [&](int it) {
            if (it < n_mine) {
              uint4* slot = ring + (it % MS) * PIECES * 32;
              const int k = (warp + it * M_WARPS) * MKC + tig * 8;
              const bool k_ok = k < N;  // N % 8 == 0: 8 k or none
#pragma unroll
              for (int p = 0; p < 4; ++p) {
                const int b = b0 + p * 8 + g;  // m tile p/2, rows +8*(p%2)
                const bool ok = k_ok && b < B;
                cp_async16(slot + p * 32 + lane,
                           ok ? g_d + size_t(b) * N + k : g_d, ok);
              }
              if (it >= res && !(w_issued && it < MS - 1))
                stage_w(slot + 4 * 32, it, warp, lane, j0, H, w_d);
            }
            cp_async_commit();
          };
#pragma unroll
          for (int s = 0; s < MS - 1; ++s) stage(s);
          for (int it = 0; it < n_mine; ++it) {
            cp_async_wait<MS - 2>();
            // Refills the slot this lane read in the last iteration.
            stage(it + MS - 1);
            const uint4* slot = ring + (it % MS) * PIECES * 32;
            const uint4* wp = it < res ? res_w + it * 4 * 32 : slot + 4 * 32;
            uint4 a[4], bw[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) a[p] = slot[p * 32 + lane];
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) bw[nt] = wp[nt * 32 + lane];
            // A lane's piece holds k = 8*tig .. 8*tig+7 of the chunk; the
            // fragment slots (2tig, 2tig+1 | 2tig+8, 2tig+9) of the first
            // k16 step take its words x | y, of the second z | w, in A
            // and in B alike.
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              if (mt == 1 && !m1) continue;
#pragma unroll
              for (int nt = 0; nt < 4; ++nt) {
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
            for (int nt = 0; nt < 4; ++nt) {
              float* o = r + (mt * 16 + g) * RED_S + nt * 8 + tig * 2;
              *reinterpret_cast<float2*>(o) =
                  make_float2(acc[mt][nt][0], acc[mt][nt][1]);
              *reinterpret_cast<float2*>(o + 8 * RED_S) =
                  make_float2(acc[mt][nt][2], acc[mt][nt][3]);
            }
          __syncthreads();
        }

#pragma unroll
        for (int q = 0; q < QROWS; ++q) {
          const int bl = warp + M_WARPS * q, b = b0 + bl;
          if (b >= B || j >= H) continue;
          float carry = de_v[q];
          if (i > 0) {
            float s = 0.f;  // the warps' partial sums, in warp order
#pragma unroll
            for (int ww = 0; ww < M_WARPS; ++ww)
              s += red[(ww * MROWS + bl) * RED_S + lane];
            carry += s;
          }
          const float gn = pre_v[q][2];
          const float rr = sigmoid(bits_f32(x_v[q][0]) + pre_v[q][0]);
          const float z = sigmoid(bits_f32(x_v[q][1]) + pre_v[q][1]);
          const float n = tanhf(bits_f32(x_v[q][2]) + rr * gn);
          const float m = m_v[q];
          const float dh = carry + dy_v[q];
          const float dh_mid = m * dh;
          const float dn = dh_mid * (1.f - z);
          const float dz = dh_mid * (hp_v[q] - n);
          const float da_n = dn * (1.f - n * n);
          const float dr = da_n * gn;
          const float dg_n = da_n * rr;
          const float da_z = dz * z * (1.f - z);
          const float da_r = dr * rr * (1.f - rr);
          de_buf[size_t(d) * BH + size_t(b) * H + j] =
              dh_mid * z + (1.f - m) * dh;
          const size_t o = ((size_t(d) * T + row) * B + b) * N;
          dxp[o + j] = da_r;
          dxp[o + H + j] = da_z;
          dxp[o + 2 * H + j] = da_n;
          dgates[o + j] = da_r;
          dgates[o + H + j] = da_z;
          dgates[o + 2 * H + j] = dg_n;
          __nv_bfloat16* gr = dgr_i + (size_t(d) * B + b) * N;
          gr[j] = __float2bfloat16_rn(da_r);
          gr[H + j] = __float2bfloat16_rn(da_z);
          gr[2 * H + j] = __float2bfloat16_rn(dg_n);
        }
        if (i > 0) __syncthreads();  // red is read: the rings are free
      }
    }
    if (first) break;  // no dh_prev past the recurrence's start
    // W does not wait for the barrier: issue the next step's first
    // streamed chunks for this block's first group (committed with its
    // first chunk of the dgates row).
    {
      const int j0 = (blockIdx.x % nblk) * MU;
      const __nv_bfloat16* w_d = w + size_t(blockIdx.x / nblk) * H * N;
      for (int it = res; it < MS - 1 && it < n_mine; ++it)
        stage_w(ring + (it % MS) * PIECES * 32 + 4 * 32, it, warp, lane, j0,
                H, w_d);
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

// The two-phase CUDA-core kernel: f32, or bf16 off the tensor-core path.
template <typename WT>
cudaError_t launch_two_phase(const void* xp, const float* mask,
                             const void* w, const float* bias,
                             const float* ys, const float* dy, float* dxp,
                             float* dgates, float* scratch, int D, int T,
                             int B, int H, int reverse_bits, int device,
                             cudaStream_t stream) {
  auto* kernel = gru_bwd_stream_kernel<WT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = coop_blocks(reinterpret_cast<const void*>(kernel), THREADS,
                    SMEM_BYTES, D * ((H + U - 1) / U), device, &blocks);
  if (err != cudaSuccess) return err;
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &ys, &dy, &dxp, &dgates,
                  &scratch, &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The tensor-core path: the gate pre-pass into dgates, then the serial
// loop over it.
cudaError_t launch_mma(const void* xp, const float* mask, const void* w,
                       const float* bias, const float* ys, const float* dy,
                       float* dxp, float* dgates, float* scratch, int D,
                       int T, int B, int H, int reverse_bits, int device,
                       cudaStream_t stream) {
  const __nv_bfloat16* xp_t = static_cast<const __nv_bfloat16*>(xp);
  const __nv_bfloat16* w_t = static_cast<const __nv_bfloat16*>(w);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_stream_gates_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(PRE_SMEM));
  if (err != cudaSuccess) return err;
  const int m_tiles = (T * B + PM - 1) / PM;
  const dim3 pre_grid((3 * H + PN - 1) / PN,
                      m_tiles < 65535 ? m_tiles : 65535, D);
  gru_bwd_stream_gates_kernel<<<pre_grid, P_THREADS, PRE_SMEM, stream>>>(
      w_t, bias, ys, dgates, T, B, H, reverse_bits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto* kernel = gru_bwd_stream_mma_kernel;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(MMA_SMEM));
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = coop_blocks(reinterpret_cast<const void*>(kernel), M_THREADS,
                    MMA_SMEM, D * ((H + MU - 1) / MU), device, &blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&xp_t, &mask, &w_t, &ys, &dy, &dxp, &dgates,
                  &scratch, &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(M_THREADS), args,
                                    MMA_SMEM, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch that gru_bwd_stream_launch needs, on either path:
// the two-phase kernel keeps dh and its elementwise part (2*D*B*H f32),
// then two round(dgates) rows (2*D*B*3H in the dot dtype; f32 room); the
// tensor-core loop keeps the elementwise part alone in the first D*B*H
// and its bf16 rows at the same place.
long long gru_bwd_stream_scratch_floats(int D, int B, int H) {
  return 8LL * D * B * H;
}

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp and w are bf16 when `bf16` is set, f32 otherwise. A bf16 call runs
// the tensor-core path (two launches) where H % 8 == 0 and w, ys and
// scratch are 16-byte aligned, else the two-phase kernel, as f32 does.
// The calling thread's current device is the same after the call as
// before it.
int gru_bwd_stream_launch(int bf16, const void* xp, const float* mask,
                          const void* w, const float* bias, const float* ys,
                          const float* dy, float* dxp, float* dgates,
                          float* scratch, int D, int T, int B, int H,
                          int reverse_bits, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool mma = bf16 && H % 8 == 0 && aligned16(w) && aligned16(ys) &&
                   aligned16(scratch);
  if (mma)
    err = launch_mma(xp, mask, w, bias, ys, dy, dxp, dgates, scratch, D, T,
                     B, H, reverse_bits, device, st);
  else if (bf16)
    err = launch_two_phase<__nv_bfloat16>(xp, mask, w, bias, ys, dy, dxp,
                                          dgates, scratch, D, T, B, H,
                                          reverse_bits, device, st);
  else
    err = launch_two_phase<float>(xp, mask, w, bias, ys, dy, dxp, dgates,
                                  scratch, D, T, B, H, reverse_bits, device,
                                  st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_bwd_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
