// LSTM forward recurrence for Hopper (sm_90a) with weight-only int8
// recurrent weights streamed from global memory every step: one launch
// runs the whole time loop of D directions at any H.
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
//   t = T-1..0, c_buf [D,B,H] f32 scratch
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h). No tape.
// Gates: (round(h_prev) @ Q) * scale + b, the sum in f32 and the scale on
// the finished column sum; then i, f, g, o as in csrc/lstm_fwd.cu.
//
// This is csrc/lstm_fwd_stream.cu (K14) with 1-byte weight tiles, as
// csrc/gru_fwd_q_stream.cu (K11) is csrc/gru_fwd_stream.cu with them; see
// their notes for the design. A cooperative persistent grid walks
// D x ceil(H/U) column groups each step; for its group a block stages
// KC-row chunks of the group's [H, 4U] column slice of Q and the matching
// h_prev columns into shared memory as f32, two buffers deep, the next
// chunk's global loads issued into registers before the current chunk's
// products run. The prefetch holds the raw s8 bytes and widens them where
// they are stored to shared memory (exact: |q| <= 127). The group's 64
// scales multiply the finished sums. The cell state stays in c_buf, owned
// by one thread at every step. W crosses L2 once a step at one byte a
// value: 12.4 MB a direction at ds2_full's H=1760, half of bf16's bytes.
// What bounds it is K14's: T steps of a serial latency, far above the FLOP
// and byte roofline of the call. CUDA cores, no tensor cores.
//
// ops/lstm.py launches it where resident_fits("lstm_fwd_q") says the
// resident kernel csrc/lstm_fwd_q.cu cannot hold the int8 slices, or when
// the caller forces it (blocked=True).

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

template <typename XT>
cudaError_t launch(const void* xp, const float* mask, const int8_t* wq,
                   const float* scale, const float* bias, float* ys,
                   float* c_buf, int D, int T, int B, int H,
                   int reverse_bits, int device, cudaStream_t stream) {
  auto* kernel = lstm_fwd_q_stream_kernel<XT>;
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
  void* args[] = {&xp_t, &mask, &wq, &scale, &bias, &ys, &c_buf,
                  &D, &T, &B, &H, &reverse_bits};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                    dim3(blocks), dim3(THREADS), args,
                                    SMEM_BYTES, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns 0 or a cudaError_t; the launch is asynchronous on `stream`.
// xp is bf16 when `bf16` is set, f32 otherwise; wq is int8; c_buf is
// [D,B,H] f32 scratch. The calling thread's current device is the same
// after the call as before it.
int lstm_fwd_q_stream_launch(int bf16, const void* xp, const float* mask,
                             const int8_t* wq, const float* scale,
                             const float* bias, float* ys, float* c_buf,
                             int D, int T, int B, int H, int reverse_bits,
                             int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = bf16 ? launch<__nv_bfloat16>(xp, mask, wq, scale, bias, ys, c_buf, D,
                                     T, B, H, reverse_bits, device, st)
             : launch<float>(xp, mask, wq, scale, bias, ys, c_buf, D, T, B,
                             H, reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* lstm_fwd_q_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
