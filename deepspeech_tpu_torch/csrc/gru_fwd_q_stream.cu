// GRU forward recurrence for Hopper (sm_90a) with weight-only int8
// recurrent weights streamed from global memory every step: one C call runs
// the whole time loop of D directions at any H.
//
// Replaces the TPU kernel _gru_kernel_blocked_q (deepspeech_tpu/ops/
// rnn_pallas.py:282, K11), which streams s8 [H, 512] column tiles of W_h
// through VMEM each step, with their [1, C] scale columns beside them,
// when the int8 matrix misses the TPU's residency budget. The contract is
// ops/gru.py gru_fwd_q's docstring, as for csrc/gru_fwd_q.cu:
//   xp [T,B,3H] in the dot dtype, bf16|f32 (xp includes the input bias),
//   mask [T,B] f32, wq [D,H,3H] int8, scale [D,3H] f32 (per output
//   channel), bias [D,3H] f32, h0 [D,B,H] f32 or NULL, reverse bit d set for
//   a direction that runs t = T-1..0, a scratch whose size depends on the
//   path (gru_fwd_q_stream_launch says what it holds)
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h), hfin [D,B,H] f32.
// Gates: (round(h_prev) @ Q) * scale + b, the sum in f32 and the scale on
// the finished column sum; then r, z, n as in csrc/gru_fwd.cu. The TPU
// kernel takes no h0; this one does, as csrc/gru_fwd_stream.cu does.
//
// What bounds it: T serial steps of one step's latency, far above the FLOP
// roofline (2*T*D*B*H*3H over the peak) and the byte roofline (the inputs
// and outputs once), as for csrc/gru_fwd_stream.cu (K8), whose function
// this is with s8 weights. A step's cost is that of the busiest SM: it
// moves the h row and the streamed part of its group's slice of Q from L2
// through shared memory into the products, widens Q to bf16, then waits at
// one grid barrier.
//
// bf16 path (the main path of a streamed int8 layer; H % 8 == 0 and a
// 16-byte aligned scratch), two launches from one C call: Q^T written once
// as biased s8 (gru_fwd_q_stream_transpose_kernel), then the serial loop
// on mma.sync with the s8 pieces widened to bf16 in registers
// (gru_fwd_q_stream_mma_kernel). Both are csrc/gru_fwd_q_mma.cuh's, which
// holds the design; csrc/gru_fwd_q.cu (K10) runs the same loop with as
// much of Q^T resident as fits. Here a fixed share stays resident, the
// first Q_RES chunks of a warp's slice (6 of 7 at ds2_full's H=1760: 86%),
// and the rest streams through each warp's MS-stage ring every step, as
// csrc/lstm_fwd_q_stream.cu's (K17) loop streams it: the kernel of a layer
// whose int8 slices the residency rule refuses, or that the caller forces
// here (blocked=True). deepspeech_tpu_torch/k10_variants.py times the
// constants below beside the others that fit: on an H100 SXM (700 W, one
// call, ds2_full) 12.36-12.54 ms a call with 6 chunks resident, against
// 12.86-13.23 with 4, 13.38-13.41 with 2 and 13.94-14.00 with every chunk
// streamed; 3 stages and 4 chunks 12.94-12.95, 4 column splits 14.05 at
// best.
//
// f32 path (not the main path; model.dtype=float32) and a bf16 call whose
// H is not a multiple of 8 or whose scratch is not 16-byte aligned:
// gru_fwd_q_stream_kernel on the CUDA cores, no scratch. This is csrc/
// gru_fwd_stream.cu's CUDA-core kernel with 1-byte weight tiles. A
// cooperative persistent grid walks D x ceil(H/U) column groups each
// step; for its group a block stages KC-row chunks of the group's [H, 3U]
// column slice of Q and the matching h_prev columns into shared memory as
// f32, two buffers deep, the next chunk's global loads issued into
// registers before the current chunk's products run. The prefetch holds
// the raw s8 bytes and widens them where they are stored to shared memory
// (exact: |q| <= 127), so the thread does not wait on the loads before
// computing. The group's 48 scales multiply the finished sums. W crosses
// L2 once a step at one byte a value.
//
// The choice between the two is made before any launch, from the dtype,
// H and the scratch's alignment (gru_fwd_q_stream_launch); ops/gru.py's
// _fwd_q_mma repeats it to size the scratch. ops/gru.py launches this
// kernel where resident_fits("fwd_q") says the resident kernel csrc/
// gru_fwd_q.cu cannot hold the int8 slices, or when the caller forces it
// (blocked=True).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gru_fwd_q_mma.cuh"

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
// of the group's columns and every KR-th row of the chunk.
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
gru_fwd_q_stream_kernel(const XT* __restrict__ xp,
                        const float* __restrict__ mask,
                        const int8_t* __restrict__ wq,
                        const float* __restrict__ scale,
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
      const int8_t* wq_d = wq + size_t(d) * H * H3;
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
      // bytes in a row of global memory), rows wk, wk + KR, ...
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_loader = threadIdx.x < W_THREADS;
      const bool w_live = j0 + wc % U < H;
      const int8_t* w_col = wq_d + (wc / U) * H + j0 + wc % U;
      // h_prev: rows hr, hr + HR, ... of the pass, column hk of the chunk.
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][3] = {};
        if (hp != nullptr) {
          int8_t wpre[W_STAGE];
          float hpre[H_STAGE];
          // Chunk k0 into registers; W as raw bytes (widened at the store).
          auto fetch = [&](int k0) {
            if (w_loader) {
#pragma unroll
              for (int q = 0; q < W_STAGE; ++q) {
                const int k = k0 + wk + q * KR;
                wpre[q] = (w_live && k < H) ? __ldg(w_col + size_t(k) * H3)
                                            : int8_t(0);
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
                w_s[wc * KS + wk + q * KR] = static_cast<float>(wpre[q]);
            }
#pragma unroll
            for (int q = 0; q < H_STAGE; ++q)
              h_s[(hr + q * HR) * KS + hk] = round_to<XT>(hpre[q]);
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
          const float s_r = scale[d * H3 + j];
          const float s_z = scale[d * H3 + H + j];
          const float s_n = scale[d * H3 + 2 * H + j];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int b = b0 + rg + i * RG;
            if (b >= B) continue;
            const float h_prev = hp ? __ldcg(hp + size_t(b) * H + j) : 0.f;
            const XT* x = xp + (size_t(row) * B + b) * H3;
            const float r = sigmoid(to_f32(x[j]) + (acc[i][0] * s_r + b_r));
            const float z =
                sigmoid(to_f32(x[H + j]) + (acc[i][1] * s_z + b_z));
            const float n =
                tanhf(to_f32(x[2 * H + j]) + r * (acc[i][2] * s_n + b_n));
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

template <typename XT>
cudaError_t launch(const void* xp, const float* mask, const int8_t* wq,
                   const float* scale, const float* bias, const float* h0,
                   float* ys, float* hfin, int D, int T, int B, int H,
                   int reverse_bits, int device, cudaStream_t stream) {
  auto* kernel = gru_fwd_q_stream_kernel<XT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(SMEM_BYTES));
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorLaunchOutOfResources;
  // grid.sync() needs every block resident at once: no more blocks than
  // fit, and no more than there are groups.
  const int groups = D * ((H + U - 1) / U);
  const int blocks = groups < per_sm * sms ? groups : per_sm * sms;
  const XT* xp_t = static_cast<const XT*>(xp);
  void* args[] = {&xp_t, &mask, &wq, &scale, &bias, &h0, &ys, &hfin,
                  &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- bf16 path: Q transposed once, then the serial loop on the tensor cores ----

// The loop's constants: warps over the group's 96 columns (the rest over
// the depth), cp.async stages of the rings, and the chunks of a warp's Qt
// slice held resident for the call (when a block has one group).
constexpr int NW_N = 2;
constexpr int MS = 2;
constexpr int Q_RES = 6;

__global__ void __launch_bounds__(gru_q_mma::TT * 8)
gru_fwd_q_stream_transpose_kernel(const int8_t* __restrict__ q,
                                  int8_t* __restrict__ qt,
                                  const float* __restrict__ h0,
                                  __nv_bfloat16* __restrict__ h_row,
                                  size_t n_h, int H, int Hp) {
  gru_q_mma::transpose(q, qt, h0, h_row, n_h, H, Hp);
}

__global__ void __launch_bounds__(gru_q_mma::M_THREADS, 1)
gru_fwd_q_stream_mma_kernel(const __nv_bfloat16* __restrict__ xp,
                            const float* __restrict__ mask,
                            const float* __restrict__ scale,
                            const float* __restrict__ bias,
                            const float* __restrict__ h0, float* ys,
                            float* hfin, float* scratch, int D, int T, int B,
                            int H, int reverse_bits, int res) {
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
int gru_fwd_q_stream_launch(int bf16, const void* xp, const float* mask,
                            const int8_t* wq, const float* scale,
                            const float* bias, const float* h0, float* ys,
                            float* hfin, float* scratch, int D, int T, int B,
                            int H, int reverse_bits, int device,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (bf16 && H % 8 == 0 && scratch != nullptr && aligned16(scratch))
    err = gru_q_mma::launch<NW_N, MS, Q_RES>(
        gru_fwd_q_stream_transpose_kernel, gru_fwd_q_stream_mma_kernel, xp,
        mask, wq, scale, bias, h0, ys, hfin, scratch, D, T, B, H,
        reverse_bits, device, st);
  else if (bf16)
    err = launch<__nv_bfloat16>(xp, mask, wq, scale, bias, h0, ys, hfin, D,
                                T, B, H, reverse_bits, device, st);
  else
    err = launch<float>(xp, mask, wq, scale, bias, h0, ys, hfin, D, T, B, H,
                        reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* gru_fwd_q_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
