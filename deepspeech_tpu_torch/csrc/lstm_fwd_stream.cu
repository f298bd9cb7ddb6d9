// LSTM forward recurrence for Hopper (sm_90a) with W streamed from global
// memory every step: one launch runs the whole time loop of D directions
// at any H, for the sizes whose W does not fit the grid's shared memory.
//
// Replaces the TPU kernel _lstm_kernel_blocked (deepspeech_tpu/ops/
// lstm_pallas.py:116, K14), which streams [H, 512] column blocks of W
// through VMEM each step when W misses the TPU's residency budget, gathers
// the gate partials in scratch and fires the update on the last block. The
// contract is ops/lstm.py lstm_fwd's docstring, as for csrc/lstm_fwd.cu:
//   xp [T,B,4H] and w [D,H,4H] in one dtype, bf16|f32 (the dot dtype; xp
//   includes the input bias), mask [T,B] f32, bias [D,4H] f32, reverse bit
//   d set for a direction that runs t = T-1..0, c_buf [D,B,H] f32 scratch
//   -> ys [D,T,B,H] f32 (every row, masked rows hold h) and, when cs is not
//   NULL, the cell-state tape cs [D,T,B,H] f32 (masked rows hold c).
// Gates i, f, g, o with the +1 on f, as in csrc/lstm_fwd.cu.
//
// Why a second kernel: csrc/lstm_fwd.cu keeps each block's [H, 64] slice of
// W in shared memory for the whole sequence. At ds2_full's H=1760 that
// slice is 460 KB, over the 227 KB a block may have, and W is 24.8 MB a
// direction in bf16 against about 30 MB of shared memory on the whole card.
//
// What bounds it: as for csrc/lstm_fwd.cu, T serial steps of one step's
// latency, far above the FLOP roofline (2*T*D*B*H*4H over the peak) and
// the byte roofline (the inputs and outputs once). Here a step also moves
// W: the whole of it crosses L2 once a step (50 MB at D=2 in bf16, about
// what the 50 MB L2 holds; 99 MB in f32, which streams from HBM).
//
// Design: csrc/gru_fwd_stream.cu's (K8) with four gates. The work of a step
// is D x ceil(H/U) column groups, each U hidden units of one direction
// (gate columns j, H+j, 2H+j, 3H+j). A cooperative persistent grid of as
// many blocks as fit on the card (at most one per group) walks the groups,
// block g taking g, g + grid, ... For its group a block stages KC-row
// chunks of the group's [H, 4U] column slice of W, and the matching KC
// columns of h_prev (rounded to the dot dtype), into shared memory as f32,
// two buffers deep: the next chunk's global loads are issued into
// registers (raw bits, widened where they are stored) before the current
// chunk's products run. f32 FMAs on the CUDA cores; then the LSTM update
// and the mask, and the block writes its [B, U] slice of the ys row (and
// of the tape). The cell state stays in c_buf, one value per direction,
// batch row and unit: the same thread of the same block owns it at every
// step (the group -> block and row -> thread maps do not change), so it
// never crosses threads and needs no barrier. A grid-wide barrier
// separates the steps; h_prev is read through L2 (.cg) from the ys row the
// grid wrote the step before. Simple first: no tensor cores, no TMA.

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
// columns and every KR-th row of the chunk: one base pointer and one
// stride per thread keep the staging's registers few.
constexpr int KR = THREADS / GC;              // 4
constexpr int W_STAGE = KC / KR;              // W values per thread
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
lstm_fwd_stream_kernel(const WT* __restrict__ xp,
                       const float* __restrict__ mask,
                       const WT* __restrict__ w,
                       const float* __restrict__ bias, float* ys, float* cs,
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
      const WT* w_d = w + size_t(d) * H * H4;
      float* ys_d = ys + size_t(d) * T * BH;
      float* c_d = c_buf + size_t(d) * BH;
      // h_prev of this direction: the ys row of the previous step, or 0.
      const float* hp = s > 0 ? ys_d + size_t(rev ? row + 1 : row - 1) * BH
                              : nullptr;
      // This thread's W column when it stages W: gate wc / U, unit
      // j0 + wc % U (neighbouring threads read neighbouring units, U
      // values in a row of global memory), rows wk, wk + KR, ...
      const int wc = threadIdx.x % GC, wk = threadIdx.x / GC;
      const bool w_live = j0 + wc % U < H;
      const WT* w_col = w_d + (wc / U) * H + j0 + wc % U;
      // h_prev: rows hr, hr + HR, ... of the pass, column hk of the chunk.
      const int hr = threadIdx.x / KC, hk = threadIdx.x % KC;
      for (int b0 = 0; b0 < B; b0 += ROWS) {
        float acc[2][4] = {};
        if (hp != nullptr) {
          typename Bits<WT>::type wpre[W_STAGE];
          float hpre[H_STAGE];
          // Chunk k0 into registers, unconverted (see ldg_bits).
          auto fetch = [&](int k0) {
#pragma unroll
            for (int q = 0; q < W_STAGE; ++q) {
              const int k = k0 + wk + q * KR;
              wpre[q] = (w_live && k < H) ? ldg_bits(w_col + size_t(k) * H4)
                                          : 0;
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
              w_s[wc * KS + wk + q * KR] = bits_f32(wpre[q]);
#pragma unroll
            for (int q = 0; q < H_STAGE; ++q)
              h_s[(hr + q * HR) * KS + hk] = round_to<WT>(hpre[q]);
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
          const float b_i = bias[d * H4 + j];
          const float b_f = bias[d * H4 + H + j];
          const float b_g = bias[d * H4 + 2 * H + j];
          const float b_o = bias[d * H4 + 3 * H + j];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int b = b0 + rg + r * RG;
            if (b >= B) continue;
            const size_t at = size_t(b) * H + j;
            const float h_prev = hp ? __ldcg(hp + at) : 0.f;
            const float c_prev = s > 0 ? c_d[at] : 0.f;
            const WT* x = xp + (size_t(row) * B + b) * H4;
            const float ig = sigmoid(to_f32(x[j]) + (acc[r][0] + b_i));
            const float fg =
                sigmoid((to_f32(x[H + j]) + (acc[r][1] + b_f)) + 1.f);
            const float gg =
                tanhf(to_f32(x[2 * H + j]) + (acc[r][2] + b_g));
            const float og =
                sigmoid(to_f32(x[3 * H + j]) + (acc[r][3] + b_o));
            const float c_new = fg * c_prev + ig * gg;
            const float h_new = og * tanhf(c_new);
            const float m = mask[size_t(row) * B + b];
            const float h = m * h_new + (1.f - m) * h_prev;
            const float c = m * c_new + (1.f - m) * c_prev;
            c_d[at] = c;
            ys_d[size_t(row) * BH + at] = h;
            if (cs) cs[(size_t(d) * T + row) * BH + at] = c;
          }
        }
      }
    }
    grid.sync();
  }
}

template <typename WT>
cudaError_t launch(const void* xp, const float* mask, const void* w,
                   const float* bias, float* ys, float* cs, float* c_buf,
                   int D, int T, int B, int H, int reverse_bits, int device,
                   cudaStream_t stream) {
  auto* kernel = lstm_fwd_stream_kernel<WT>;
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
  const WT* xp_t = static_cast<const WT*>(xp);
  const WT* w_t = static_cast<const WT*>(w);
  void* args[] = {&xp_t, &mask, &w_t, &bias, &ys, &cs, &c_buf,
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
// xp and w are bf16 when `bf16` is set, f32 otherwise; cs may be NULL (no
// tape); c_buf is [D,B,H] f32 scratch. The calling thread's current device
// is the same after the call as before it.
int lstm_fwd_stream_launch(int bf16, const void* xp, const float* mask,
                           const void* w, const float* bias, float* ys,
                           float* cs, float* c_buf, int D, int T, int B,
                           int H, int reverse_bits, int device,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = bf16 ? launch<__nv_bfloat16>(xp, mask, w, bias, ys, cs, c_buf, D, T,
                                     B, H, reverse_bits, device, st)
             : launch<float>(xp, mask, w, bias, ys, cs, c_buf, D, T, B, H,
                             reverse_bits, device, st);
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* lstm_fwd_stream_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
