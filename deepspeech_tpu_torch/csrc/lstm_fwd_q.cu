// LSTM forward recurrence for Hopper (sm_90a) with weight-only int8
// recurrent weights held in shared memory: one C call runs the whole time
// loop of D directions.
//
// Replaces the TPU kernel _lstm_kernel_q (deepspeech_tpu/ops/lstm_pallas.py:
// 292, K16, via lstm_scan_pallas_q :345/:396), which keeps the int8 W_h
// resident in VMEM, one direction a launch; here D=1 or D=2 in one call.
// The contract is ops/lstm.py lstm_fwd_q's docstring:
//   xp [T,B,4H] in the dot dtype, bf16|f32 (xp includes the input bias),
//   mask [T,B] f32, wq [D,H,4H] int8, scale [D,4H] f32 (per output
//   channel), bias [D,4H] f32, reverse bit d set for a direction that runs
//   t = T-1..0
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h). No tape.
// Gates: (round(h_prev) @ Q) * scale + b, with h_prev rounded to the dot
// dtype, the sum in f32 and the scale applied to the finished column sum
// (lstm_pallas.py:305-307); then i, f, g, o as in csrc/lstm_fwd.cu (the +1
// on f). Each direction starts from h = c = 0.
//
// What bounds it: as for csrc/lstm_fwd.cu, T serial steps of one step's
// latency, far above the FLOP and the byte roofline of the call.
//
// bf16 path (the main path: ds2_small-lstm int8 at D=2, ds2_streaming-lstm
// int8 at D=1, both H=800) where xp is bf16, H % 8 == 0 and the scratch is
// 16-byte aligned: csrc/lstm_fwd.cu's (K12) two launches from
// csrc/lstm_fwd_mma.cuh, on Q instead of W:
//  1. lstm_fwd_q_transpose_kernel writes Wt [D,4H,H] = bf16(Q^T) into the
//     scratch once a call (10.24 MB at D=2, H=800). Every int8 value is
//     exact in bf16, so Wt holds Q itself and the tensor cores form
//     round(h_prev) @ Q exactly as a bf16 product of the two: no widening
//     in the step, where csrc/lstm_fwd_q_stream.cu (K17) widens its s8
//     pieces in registers every step.
//  2. lstm_fwd_q_mma_kernel<MU, MS>, K12's serial loop with all of W^T
//     resident and SCALED set: each thread loads its unit's four scales
//     once a call and the update forms xp + (sum * scale + b) per gate,
//     the scale on the finished column sum as the plain version has it.
//     The launch takes K12's widths: MU_NARROW units with MS_NARROW stages
//     where D x ceil(H/MU_NARROW) groups fit one an SM (D=1 at H=800: 100
//     groups, 114 KB a block), else MU_WIDE with MS_WIDE (D=2: 100 groups,
//     172 KB); deepspeech_tpu_torch/k16_variants.py times the widths and
//     the depths beside the parent's kernel.
// The bf16 rule is K12's (ops/gru.py resident_fits("lstm_fwd_q", ...)
// routes to lstm_fwd_mma_width and lstm_fwd_mma_smem_bytes): H up to 1056
// at D=2 and 1216 at D=1, whatever B; wider calls run K17.
//
// f32 path (not the main path) and every other bf16 call: lstm_fwd_q_kernel
// on the CUDA cores, no scratch. Its design is csrc/gru_fwd_q.cu's CUDA-core
// kernel with four gates and the cell state of csrc/lstm_fwd.cu's: a block
// owns U hidden units of one direction (gate
// columns j, H+j, 2H+j, 3H+j), keeps their [H, 4U] column slice of Q in
// shared memory as bytes for the whole sequence (a quarter of the f32
// slice) and their cell state [B][U] as f32 beside it. A step stages h_prev
// in KC-column chunks (rounded to the dot dtype, the next chunk's loads in
// flight while the current one is multiplied) and, beside each chunk,
// widens the matching KC rows of the int8 slice to f32 in a small shared
// buffer (exact: |q| <= 127); the inner loop is csrc/lstm_fwd.cu's f32 FMA
// loop. Then the scale, the bias, the LSTM update and the mask, and the
// block writes its [B, U] slice of the ys row. A grid-wide barrier
// (cooperative launch, every block resident) separates the steps. At
// H=800 a block takes 80 KB (two an SM could run; 100 blocks at D=2); at
// ds2_full's H=1760 it would take 140 KB, one an SM, and the 220 blocks do
// not fit 132 SMs, so ops/lstm.py launches csrc/lstm_fwd_q_stream.cu
// there. ops/gru.py resident_smem_bytes("lstm_fwd_q") repeats the layout.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch (lstm_fwd_q_launch); ops/lstm.py's _fwd_q_mma repeats
// it.

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
constexpr int KC = 64;            // h_prev columns / W rows per chunk
constexpr int STAGE = ROWS * KC / THREADS;    // staged h values per thread
constexpr int WIDEN = GC * KC / 4 / THREADS;  // 4-byte groups per thread
constexpr int HS = KC + 4;        // f32 row stride of the staged chunks
constexpr int QPAD = 16;          // bytes after each int8 column

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

// Four int8 values (little-endian in `v`) widened to f32 exactly: each
// byte, biased by 128, becomes the low byte of the float 2^23 + (q + 128),
// from which 2^23 + 128 is subtracted.
__device__ __forceinline__ float4 widen4(uint32_t v) {
  const uint32_t x = v ^ 0x80808080u;
  const float bias = 8388736.f;
  return make_float4(__uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650)) - bias,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7651)) - bias,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7652)) - bias,
                     __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7653)) - bias);
}

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// Shared memory: the int8 slice [GC][h_pad + QPAD] (k contiguous per
// column), then as f32 the widened W chunk [GC][HS], the h_prev chunk
// [ROWS][HS] and the cell state [B][U].
size_t smem_bytes(int h_pad, int B) {
  return size_t(GC) * (h_pad + QPAD) +
         sizeof(float) * (size_t(GC + ROWS) * HS + size_t(B) * U);
}

template <typename XT>
__global__ void __launch_bounds__(THREADS, 2)
lstm_fwd_q_kernel(const XT* __restrict__ xp, const float* __restrict__ mask,
                  const int8_t* __restrict__ wq,
                  const float* __restrict__ scale,
                  const float* __restrict__ bias, float* ys, int T, int B,
                  int H, int h_pad, int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qs = h_pad + QPAD;
  int8_t* q_s = reinterpret_cast<int8_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + size_t(GC) * qs);
  float* h_s = w_s + GC * HS;
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

  // Column c = g*U + u of q_s holds Q[d][:, g*H + j0 + u], k contiguous;
  // rows k >= H and units past H are zero.
  const int8_t* wq_d = wq + size_t(d) * H * H4;
  for (int i = threadIdx.x; i < h_pad * GC; i += THREADS) {
    const int k = i / GC, c = i % GC;
    const int g = c / U, u = c % U;
    q_s[c * qs + k] =
        (k < H && j0 + u < H) ? wq_d[k * H4 + g * H + j0 + u] : int8_t(0);
  }
  for (int i = threadIdx.x; i < B * U; i += THREADS) c_s[i] = 0.f;
  float b_[4] = {}, s_[4] = {};
  if (j < H) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      b_[g] = bias[d * H4 + g * H + j];
      s_[g] = scale[d * H4 + g * H + j];
    }
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  float* ys_d = ys + size_t(d) * T * BH;
  const float* w_i = w_s + (0 * U + lu) * HS;
  const float* w_f = w_s + (1 * U + lu) * HS;
  const float* w_g = w_s + (2 * U + lu) * HS;
  const float* w_o = w_s + (3 * U + lu) * HS;

  for (int s = 0; s < T; ++s) {
    const int row = rev ? T - 1 - s : s;
    // h_prev of this direction: the ys row of the previous step, or 0.
    const float* hp = s > 0 ? ys_d + size_t(rev ? row + 1 : row - 1) * BH
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
            h_s[(i / KC) * HS + i % KC] = round_to<XT>(pre[q]);
          }
          // Rows k0..k0+KC of the int8 slice, widened: group i is column
          // i / (KC/4), rows k0 + 4 * (i % (KC/4)) .. + 3.
#pragma unroll
          for (int q = 0; q < WIDEN; ++q) {
            const int i = threadIdx.x + q * THREADS;
            const int c = i / (KC / 4), k4 = 4 * (i % (KC / 4));
            const uint32_t v =
                *reinterpret_cast<const uint32_t*>(q_s + c * qs + k0 + k4);
            *reinterpret_cast<float4*>(w_s + c * HS + k4) = widen4(v);
          }
          __syncthreads();
          if (k0 + KC < h_pad) fetch(k0 + KC);
          const float* h_a = h_s + rg * HS;
          const float* h_b = h_s + (rg + RG) * HS;
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
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + rg + r * RG;
        if (b >= B || j >= H) continue;
        const float h_prev = hp ? __ldcg(hp + size_t(b) * H + j) : 0.f;
        const float c_prev = c_s[b * U + lu];
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
        c_s[b * U + lu] = m * c_new + (1.f - m) * c_prev;
        ys_d[size_t(row) * BH + size_t(b) * H + j] =
            m * h_new + (1.f - m) * h_prev;
      }
    }
    grid.sync();
  }
}

template <typename XT>
cudaError_t launch(const void* xp, const float* mask, const int8_t* wq,
                   const float* scale, const float* bias, float* ys, int D,
                   int T, int B, int H, int reverse_bits, int device,
                   cudaStream_t stream) {
  auto* kernel = lstm_fwd_q_kernel<XT>;
  const int h_pad = (H + KC - 1) / KC * KC;
  const size_t smem = smem_bytes(h_pad, B);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (err != cudaSuccess) return err;
  const int blocks = D * ((H + U - 1) / U);
  // grid.sync() needs every block resident at once.
  if (per_sm * sms < blocks) return cudaErrorCooperativeLaunchTooLarge;
  const XT* xp_t = static_cast<const XT*>(xp);
  void* args[] = {&xp_t, &mask, &wq, &scale, &bias, &ys,
                  &T, &B, &H, const_cast<int*>(&h_pad), &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: csrc/lstm_fwd_mma.cuh's widening transpose and serial
// loop, all of Q^T resident as bf16, the scale on the finished sums ----

// The group widths and the stages of a warp's ring of h-row pieces:
// MU_NARROW units and MS_NARROW stages where D x ceil(H/MU_NARROW) groups
// fit one an SM, else MU_WIDE and MS_WIDE (csrc/lstm_fwd.cu's).
constexpr int MU_NARROW = 8;
constexpr int MS_NARROW = 4;
constexpr int MU_WIDE = 16;
constexpr int MS_WIDE = 4;

__global__ void __launch_bounds__(lstm_fwd_mma::TT * 8)
lstm_fwd_q_transpose_kernel(const int8_t* __restrict__ q,
                            unsigned short* __restrict__ wt, int H) {
  lstm_fwd_mma::transpose(q, wt, H);
}

template <int MU, int MS>
__global__ void __launch_bounds__(lstm_fwd_mma::M_THREADS, 1)
lstm_fwd_q_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                      const float* __restrict__ mask,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, float* ys, float* cs,
                      float* scratch, int D, int T, int B, int H,
                      int reverse_bits) {
  constexpr int NW_N = MU < 32 ? 1 : 2;  // the header's column splits
  lstm_fwd_mma::loop<MU, MS, lstm_fwd_mma::W_ALL, NW_N, true>(
      xp, mask, scale, bias, ys, cs, scratch, D, T, B, H, reverse_bits);
}

template <int MU, int MS>
size_t loop_smem(int H) {
  return lstm_fwd_mma::Plan<MU, MS, lstm_fwd_mma::W_ALL>::smem(H);
}

// The two launches at the width the card's SM count gives; no tape.
cudaError_t launch_mma(const void* xp, const float* mask, const int8_t* wq,
                       const float* scale, const float* bias, float* ys,
                       float* scratch, int D, int T, int B, int H,
                       int reverse_bits, int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const bool narrow = D * ((H + MU_NARROW - 1) / MU_NARROW) <= sms;
  return lstm_fwd_mma::launch(
      lstm_fwd_q_transpose_kernel,
      narrow ? lstm_fwd_q_mma_kernel<MU_NARROW, MS_NARROW>
             : lstm_fwd_q_mma_kernel<MU_WIDE, MS_WIDE>,
      narrow ? MU_NARROW : MU_WIDE,
      narrow ? loop_smem<MU_NARROW, MS_NARROW>(H)
             : loop_smem<MU_WIDE, MS_WIDE>(H),
      true, xp, mask, wq, scale, bias, ys, nullptr, scratch, D, T, B, H,
      reverse_bits, device, stream);
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp is bf16 when `bf16` is set, f32 otherwise; wq is int8. A bf16 call
// with H % 8 == 0 and a non-NULL, 16-byte aligned scratch runs the
// tensor-core path (two launches); its scratch holds 2*D*B*H + 2*D*H*H
// floats (c in f32, then the two rounded h rows and bf16(Q^T), both bf16).
// Any other call runs the CUDA-core kernel, which reads no scratch (it may
// be NULL). The calling thread's current device is the same after the call
// as before it.
int lstm_fwd_q_launch(int bf16, const void* xp, const float* mask,
                      const int8_t* wq, const float* scale,
                      const float* bias, float* ys, float* scratch, int D,
                      int T, int B, int H, int reverse_bits, int device,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16 && H % 8 == 0 && scratch != nullptr &&
      lstm_fwd_mma::aligned16(scratch))
    err = launch_mma(xp, mask, wq, scale, bias, ys, scratch, D, T, B, H,
                     reverse_bits, device, st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, wq, scale, bias, ys, D, T, B, H,
                                reverse_bits, device, st);
  else
    err = launch<float>(xp, mask, wq, scale, bias, ys, D, T, B, H,
                        reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* lstm_fwd_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
