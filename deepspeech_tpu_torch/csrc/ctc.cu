// CTC alpha and beta recursions for Hopper (sm_90a).
//
// ctc_alpha replaces the TPU kernels _fwd_kernel (deepspeech_tpu/ops/
// ctc_pallas.py:118, K1: alpha tape and log-likelihood) and
// _fwd_kernel_loss_only (ctc_pallas.py:124, K3: log-likelihood only),
// selected by whether a tape pointer is given. ctc_beta replaces
// _bwd_kernel (ctc_pallas.py:132, K2: beta and the occupancy gamma).
// The contract is ops/ctc.py ctc_alpha's and ctc_beta's docstrings:
//   lp [B,T,V] f32 log-probs, ext [B,S] int32 extended labels, skip [B,S]
//   bytes (1 = the s-2 -> s move is legal), lens [B] int32 frames,
//   s_last [B] int32 (= 2L; states past it are invalid)
//   -> ll [B] f32 and, with a tape, alpha [B,T,S] f32;
//   -> (with alpha and ll) gamma [B,T,S] f32.
// Moves are stay, step and skip. Frames at or past len hold alpha; beta
// restarts at the terminal states (2L and 2L-1) for t >= len-1, and a
// skip s -> s+2 is judged at its destination (skip[s+2]). The
// log-likelihood is read from the final alpha, which equals alpha at
// len-1 since later frames hold it. gamma = exp(min(alpha+beta-ll, 0)),
// zero at invalid states and frames past len.
//
// What bounds it: at B=32, T=850, S=513 the alpha kernel reads the
// log-probs (3.2 MB) and writes the 55.8 MB tape, about 0.018 ms at
// 3.35 TB/s, and the beta kernel reads both and writes gamma, about
// 0.035 ms; the loss-only alpha kernel moves almost nothing. But the T
// steps are serial, so the time is T times the latency of one step. The
// design: one block per utterance, one thread per band state s, the band
// double-buffered in shared memory so that one __syncthreads() separates
// the steps, and the next step's emission (and, in the beta kernel, the
// next tape value) loaded into a register a step ahead so that their
// latency is off the serial chain. The TPU kernel's 128-lane and
// 8-sublane padding does not carry over: nothing is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_S = 1024;

// log(e^a + e^b + e^c); NEG when every term is NEG, as the TPU kernel's
// guarded _logaddexp.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  if (m <= 0.5f * NEG) return NEG;
  return m + logf(expf(a - m) + expf(b - m) + expf(c - m));
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  if (m <= 0.5f * NEG) return NEG;
  return m + logf(expf(a - m) + expf(b - m));
}

__global__ void ctc_alpha_kernel(const float* __restrict__ lp,
                                 const int* __restrict__ ext,
                                 const unsigned char* __restrict__ skip,
                                 const int* __restrict__ lens,
                                 const int* __restrict__ s_last,
                                 float* __restrict__ tape,
                                 float* __restrict__ ll, int T, int V,
                                 int S) {
  extern __shared__ float band[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool in = s < S;
  const int sl = s_last[b];
  const int len = lens[b];
  const int e = in ? ext[size_t(b) * S + s] : 0;
  const bool sk = in && s >= 2 && skip[size_t(b) * S + s];
  const bool valid = in && s <= sl;
  const float* lpb = lp + size_t(b) * T * V + e;
  float* tb = tape ? tape + size_t(b) * T * S + s : nullptr;

  float a = NEG;
  if (valid && (s == 0 || (s == 1 && sl > 0))) a = lpb[0];
  float* prev = band;
  float* cur = band + S;
  if (in) {
    prev[s] = a;
    if (tb) tb[0] = a;
  }
  float lp_next = (valid && T > 1) ? lpb[V] : 0.f;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float lp_t = lp_next;
    if (valid && t + 1 < T) lp_next = lpb[size_t(t + 1) * V];
    if (in) {
      const float a0 = prev[s];
      float nw = NEG;
      if (valid) {
        const float a1 = s >= 1 ? prev[s - 1] : NEG;
        const float a2 = sk ? prev[s - 2] : NEG;
        nw = lp_t + lse3(a0, a1, a2);
      }
      const float v = t < len ? nw : a0;
      cur[s] = v;
      if (tb) tb[size_t(t) * S] = v;
    }
    __syncthreads();
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
  if (s == 0) {
    // s_last past the band is a caller's error: NaN, never a stray read.
    ll[b] = (sl < 0 || sl >= S) ? __int_as_float(0x7fc00000)
                                : lse2(prev[sl], sl > 0 ? prev[sl - 1] : NEG);
  }
}

// beta is never stored: the shared band holds c[s] = beta_t[s] + lp_t[s],
// the term every move out of t-1 adds, so a thread reads its three
// successors' c and needs one barrier per step.
__global__ void ctc_beta_kernel(const float* __restrict__ lp,
                                const int* __restrict__ ext,
                                const unsigned char* __restrict__ skip,
                                const int* __restrict__ lens,
                                const int* __restrict__ s_last,
                                const float* __restrict__ alpha,
                                const float* __restrict__ ll,
                                float* __restrict__ gamma, int T, int V,
                                int S) {
  extern __shared__ float band[];  // [2][S]
  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool in = s < S;
  const int sl = s_last[b];
  const int len = lens[b];
  const float llb = ll[b];
  const int e = in ? ext[size_t(b) * S + s] : 0;
  // The skip s -> s+2 is legal when skip[s+2]: judged at the destination.
  const bool sk2 = s + 2 < S && skip[size_t(b) * S + s + 2];
  const bool valid = in && s <= sl;
  const float term = (s == sl || (s == sl - 1 && sl > 0)) ? 0.f : NEG;
  const float* lpb = lp + size_t(b) * T * V + e;
  const float* ab = alpha + size_t(b) * T * S + s;
  float* gb = gamma + size_t(b) * T * S + s;

  float* next = band;  // c at t+1
  float* cur = band + S;
  float beta = term;
  float a_t = in ? ab[size_t(T - 1) * S] : 0.f;
  float lp_t = in ? lpb[size_t(T - 1) * V] : 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float a_here = a_t, lp_here = lp_t;
    if (t > 0 && in) {
      a_t = ab[size_t(t - 1) * S];
      lp_t = lpb[size_t(t - 1) * V];
    }
    if (in) {
      if (t < T - 1) {
        float rec = NEG;
        if (valid) {
          const float c1 = s + 1 < S ? next[s + 1] : NEG;
          const float c2 = sk2 ? next[s + 2] : NEG;
          rec = lse3(next[s], c1, c2);
        }
        beta = t >= len - 1 ? term : rec;
      }
      gb[size_t(t) * S] =
          (valid && t < len) ? expf(fminf(a_here + beta - llb, 0.f)) : 0.f;
      cur[s] = beta + lp_here;
    }
    __syncthreads();
    float* tmp = next;
    next = cur;
    cur = tmp;
  }
}

cudaError_t check_launch(int B, int T, int S, int* threads) {
  if (S < 1 || S > MAX_S || B < 1 || T < 1) return cudaErrorInvalidValue;
  *threads = (S + 31) / 32 * 32;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Both return 0 or a cudaError_t; the launch is asynchronous on `stream`.
// `tape` may be NULL (the loss-only recursion). The calling thread's
// current device is the same after the call as before it.
int ctc_alpha_launch(const float* lp, const int* ext,
                     const unsigned char* skip, const int* lens,
                     const int* s_last, float* tape, float* ll, int B, int T,
                     int V, int S, int device, void* stream) {
  int threads = 0, prev = 0;
  cudaError_t err = check_launch(B, T, S, &threads);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  ctc_alpha_kernel<<<B, threads, 2 * S * sizeof(float),
                     static_cast<cudaStream_t>(stream)>>>(
      lp, ext, skip, lens, s_last, tape, ll, T, V, S);
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

int ctc_beta_launch(const float* lp, const int* ext,
                    const unsigned char* skip, const int* lens,
                    const int* s_last, const float* alpha, const float* ll,
                    float* gamma, int B, int T, int V, int S, int device,
                    void* stream) {
  int threads = 0, prev = 0;
  cudaError_t err = check_launch(B, T, S, &threads);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  ctc_beta_kernel<<<B, threads, 2 * S * sizeof(float),
                    static_cast<cudaStream_t>(stream)>>>(
      lp, ext, skip, lens, s_last, alpha, ll, gamma, T, V, S);
  err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
}

const char* ctc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
