// GRU forward recurrence for Hopper (sm_90a) with weight-only int8
// recurrent weights held in shared memory: one C call runs the whole time
// loop of D directions.
//
// Replaces the TPU kernel _gru_kernel_q (deepspeech_tpu/ops/rnn_pallas.py:581,
// K10, via gru_scan_pallas_q), which keeps the int8 W_h resident in VMEM.
// The contract is ops/gru.py gru_fwd_q's docstring:
//   xp [T,B,3H] in the dot dtype, bf16|f32 (xp includes the input bias),
//   mask [T,B] f32, wq [D,H,3H] int8, scale [D,3H] f32 (per output
//   channel), bias [D,3H] f32, h0 [D,B,H] f32 or NULL, reverse bit d set for
//   a direction that runs t = T-1..0, a scratch whose size depends on the
//   path (gru_fwd_q_launch says what it holds)
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h), hfin [D,B,H] f32.
// Gates: (round(h_prev) @ Q) * scale + b, with h_prev rounded to the dot
// dtype, the sum in f32 and the scale applied to the finished column sum
// (rnn_pallas.py:601-603); then r, z, n as in csrc/gru_fwd.cu.
//
// What bounds it: as for csrc/gru_fwd.cu, each step's [B,H] x [H,3H]
// product needs the step before, so the time is T times one step's
// latency, far above the FLOP and the byte roofline of the call. What a
// step costs is the busiest SM's: with Q held in shared memory it reads
// only the h row from L2, multiplies, and waits at one grid barrier.
//
// bf16 path (the main path: an int8 engine's dots are bf16; H % 8 == 0 and
// a 16-byte aligned scratch), two launches from one C call: Q^T written
// once as biased s8 (gru_fwd_q_transpose_kernel), then the serial loop on
// mma.sync with the s8 pieces widened to bf16 in registers
// (gru_fwd_q_mma_kernel). Both are csrc/gru_fwd_q_mma.cuh's, which holds
// the design; csrc/gru_fwd_q_stream.cu (K11) runs the same loop with a
// fixed share of Q^T resident. Here a block keeps as many chunks of its
// group's Qt slice resident as fit beside the rings (at most Q_RES a
// warp), worked out at launch from H: at ds2_full's H=1760 all 7 of a
// warp's chunks, 172 KB a block, so a step moves only the h row from L2;
// at the residency rule's edges (D=2 H=1920, D=1 H=2112, 184-203 KB of
// slice) 6 a warp, the rest streamed every step.
// deepspeech_tpu_torch/k10_variants.py times the constants below beside
// the others that fit: on an H100 SXM (700 W, one call, ds2_full)
// 12.12-12.49 ms a call, against 12.11-12.32 with 3 stages (all 7 chunks
// still resident), 12.90 with 4 chunks, 13.97-13.98 with every chunk
// streamed, 13.24-13.71 with 4 column splits (all 14 of theirs resident)
// and 13.70-13.74 with one; the CUDA-core kernel below took 65.45-66.67.
//
// f32 path (not the main path; model.dtype=float32) and a bf16 call whose
// H is not a multiple of 8 or whose scratch is not 16-byte aligned:
// gru_fwd_q_kernel on the CUDA cores, no scratch. This is csrc/
// gru_fwd.cu's design with W held as int8: a block owns U hidden units of
// one direction (gate columns j, H+j, 2H+j) and keeps their [H, 3U] column
// slice of Q in shared memory as bytes for the whole sequence (at H=1760
// 87 KB a block, 106 KB with the staging buffers: two blocks per SM, 264
// slots on 132 SMs for the 220 blocks of D=2). A step stages h_prev in
// KC-column chunks (rounded to the dot dtype, the next chunk's loads in
// flight while the current one is multiplied) and, beside each chunk,
// widens the matching KC rows of the int8 slice to f32 in a small shared
// buffer (exact: |q| <= 127), so the inner loop is gru_fwd.cu's f32 FMA
// loop. Then the scale, the bias, the GRU update and the mask, and the
// block writes its [B, U] slice of the ys row. A grid-wide barrier
// (cooperative launch, every block resident) separates the steps.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (gru_fwd_q_launch); ops/gru.py's _fwd_q_mma
// repeats it to size the scratch. ops/gru.py launches this kernel where
// resident_fits("fwd_q") says the CUDA-core kernel's [H, 48] int8 slices
// fit the card (the rule that names the "resident-q" regime), and
// csrc/gru_fwd_q_stream.cu otherwise.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_fwd_q_mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 16;             // hidden units per block
constexpr int RG = 16;            // row groups: threads per hidden unit
constexpr int THREADS = U * RG;   // 256
constexpr int ROWS = 2 * RG;      // batch rows per pass: two per thread
constexpr int GC = 3 * U;         // gate columns of a block
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
// column), then the widened W chunk [GC][HS] and the h_prev chunk
// [ROWS][HS] as f32. ops/gru.py resident_smem_bytes("fwd_q") repeats this.
size_t smem_bytes(int h_pad) {
  return size_t(GC) * (h_pad + QPAD) + sizeof(float) * size_t(GC + ROWS) * HS;
}

template <typename XT>
__global__ void __launch_bounds__(THREADS, 2)
gru_fwd_q_kernel(const XT* __restrict__ xp, const float* __restrict__ mask,
                 const int8_t* __restrict__ wq,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ h0, float* ys, float* hfin,
                 int T, int B, int H, int h_pad, int reverse_bits) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int qs = h_pad + QPAD;
  int8_t* q_s = reinterpret_cast<int8_t*>(smem);
  float* w_s = reinterpret_cast<float*>(smem + size_t(GC) * qs);
  float* h_s = w_s + GC * HS;

  const int nblk = (H + U - 1) / U;
  const int d = blockIdx.x / nblk;
  const int j0 = (blockIdx.x % nblk) * U;
  const int lu = threadIdx.x % U;
  const int rg = threadIdx.x / U;
  const int j = j0 + lu;
  const bool rev = (reverse_bits >> d) & 1;
  const size_t H3 = 3 * size_t(H);
  const size_t BH = size_t(B) * H;

  // Column c = g*U + u of q_s holds Q[d][:, g*H + j0 + u], k contiguous;
  // rows k >= H and units past H are zero.
  const int8_t* wq_d = wq + d * H * H3;
  for (int i = threadIdx.x; i < h_pad * GC; i += THREADS) {
    const int k = i / GC, c = i % GC;
    const int g = c / U, u = c % U;
    q_s[c * qs + k] =
        (k < H && j0 + u < H) ? wq_d[k * H3 + g * H + j0 + u] : int8_t(0);
  }
  float b_r = 0.f, b_z = 0.f, b_n = 0.f, s_r = 0.f, s_z = 0.f, s_n = 0.f;
  if (j < H) {
    b_r = bias[d * H3 + j];
    b_z = bias[d * H3 + H + j];
    b_n = bias[d * H3 + 2 * H + j];
    s_r = scale[d * H3 + j];
    s_z = scale[d * H3 + H + j];
    s_n = scale[d * H3 + 2 * H + j];
  }
  __syncthreads();

  cg::grid_group grid = cg::this_grid();
  float* ys_d = ys + size_t(d) * T * BH;
  const float* w_r = w_s + (0 * U + lu) * HS;
  const float* w_z = w_s + (1 * U + lu) * HS;
  const float* w_n = w_s + (2 * U + lu) * HS;

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
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int b = b0 + rg + i * RG;
        if (b >= B || j >= H) continue;
        const float h_prev = hp ? __ldcg(hp + size_t(b) * H + j) : 0.f;
        const XT* x = xp + (size_t(row) * B + b) * H3;
        const float r = sigmoid(to_f32(x[j]) + (acc[i][0] * s_r + b_r));
        const float z = sigmoid(to_f32(x[H + j]) + (acc[i][1] * s_z + b_z));
        const float n =
            tanhf(to_f32(x[2 * H + j]) + r * (acc[i][2] * s_n + b_n));
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

template <typename XT>
cudaError_t launch(const void* xp, const float* mask, const int8_t* wq,
                   const float* scale, const float* bias, const float* h0,
                   float* ys, float* hfin, int D, int T, int B, int H,
                   int reverse_bits, int device, cudaStream_t stream) {
  auto* kernel = gru_fwd_q_kernel<XT>;
  const int h_pad = (H + KC - 1) / KC * KC;
  const size_t smem = smem_bytes(h_pad);
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
  void* args[] = {&xp_t, &mask, &wq, &scale, &bias, &h0, &ys, &hfin,
                  &T, &B, &H, const_cast<int*>(&h_pad), &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: Q transposed once, then the serial loop on the tensor cores ----

// The loop's constants: warps over the group's 96 columns (the rest over
// the depth), cp.async stages of the rings, and the most chunks of a warp's
// Qt slice held resident for the call (fewer where they do not fit).
constexpr int NW_N = 2;
constexpr int MS = 2;
constexpr int Q_RES = 16;

__global__ void __launch_bounds__(gru_q_mma::TT * 8)
gru_fwd_q_transpose_kernel(const int8_t* __restrict__ q,
                           int8_t* __restrict__ qt,
                           const float* __restrict__ h0,
                           __nv_bfloat16* __restrict__ h_row, size_t n_h,
                           int H, int Hp) {
  gru_q_mma::transpose(q, qt, h0, h_row, n_h, H, Hp);
}

__global__ void __launch_bounds__(gru_q_mma::M_THREADS, 1)
gru_fwd_q_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                     const float* __restrict__ mask,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias,
                     const float* __restrict__ h0, float* ys, float* hfin,
                     float* scratch, int D, int T, int B, int H,
                     int reverse_bits, int res) {
  gru_q_mma::loop<NW_N, MS>(xp, mask, scale, bias, h0, ys, hfin, scratch, D,
                            T, B, H, reverse_bits, res);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launches are asynchronous on `stream`.
// xp is bf16 when `bf16` is set, f32 otherwise; wq is int8; h0 may be NULL
// (zeros). A bf16 call with H % 8 == 0 and a non-NULL, 16-byte aligned
// scratch runs the tensor-core path (two launches); its scratch holds
// D*B*H + 3*D*H*Hp/4 floats (the two rounded h rows in bf16, then Qt in
// int8 with rows of Hp = H rounded up to 64). Any other call runs the
// CUDA-core kernel, which reads no scratch (it may be NULL). The calling
// thread's current device is the same after the call as before it.
int gru_fwd_q_launch(int bf16, const void* xp, const float* mask,
                     const int8_t* wq, const float* scale, const float* bias,
                     const float* h0, float* ys, float* hfin, float* scratch,
                     int D, int T, int B, int H, int reverse_bits,
                     int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16 && H % 8 == 0 && scratch != nullptr && aligned16(scratch))
    err = gru_q_mma::launch<NW_N, MS, Q_RES>(
        gru_fwd_q_transpose_kernel, gru_fwd_q_mma_kernel, xp, mask, wq,
        scale, bias, h0, ys, hfin, scratch, D, T, B, H, reverse_bits, device,
        st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, wq, scale, bias, h0, ys, hfin, D,
                                T, B, H, reverse_bits, device, st);
  else
    err = launch<float>(xp, mask, wq, scale, bias, h0, ys, hfin, D, T, B, H,
                        reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_fwd_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
