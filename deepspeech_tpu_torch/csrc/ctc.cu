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
// steps are serial: the time is T times one step, and a step is at
// least one dependent chain of shuffle, compare, accurate expf and
// accurate logf (about 200 cycles), since the arithmetic must stay the
// plain version's bit for bit (ll near -2e3 makes one ulp of drift 1e-4
// in gamma).
//
// The design. A cluster of C CTAs works on one utterance (one CTA when
// C = 1), W warps each; the band is cut into segments of `own` states,
// one a warp (a warp past them idles). A lane holds KS states in
// registers (one, as built: a warp issues in order, so a lane's second
// state would wait behind the first one's chain; other warps fill the
// issue slots instead), and takes its neighbours' from the lanes beside
// it with shuffles, issued as soon as a step has made them: no shared
// memory and no barrier inside a step. A warp also holds a ghost zone
// of G = 2h states on its upstream side (below it for alpha, above for
// beta) and computes them as their owner does, so its own states stay
// exact for h steps. Every h steps each segment sends its edge to its
// downstream neighbour's mailbox with st.async, which completes on the
// receiver's mbarrier (in another CTA through the cluster's distributed
// shared memory), and takes its ghost from its own; the receiver frees
// the slot with a remote arrive. Only neighbours wait on each other, so
// the segments drift apart by a transfer's latency instead of meeting
// at a barrier, and no fence waits on the loads in flight (a cluster
// barrier's release waits on them: ctc_variants' barrier_every_step).
// The arithmetic is the plain
// version's, in the same order: the bits depend on none of C, W, KS, h,
// PREFETCH or RING. What is left out is left out only where the bits
// provably stay the same:
// - blank states (even s) never take a skip, so their exp(NEG - m) term,
//   exactly +0, is not computed where a lane's states have a fixed
//   parity (consecutive states, KS even);
// - frames past len: the loops stop at len; the tape rows after it copy
//   the last alpha and gamma's are zero, written off the serial chain;
// - the band trim (TRIM, off as built: its branch cost more than the
//   work it skipped): alpha at s > min(2L, 2t+1) and beta below
//   2L-1-2(len-1-t) is NEG, so a warp wholly there computes nothing
//   (NEG predecessors give lse NEG, and lp + NEG rounds to NEG for any
//   log-prob above -3.8e22).
// Emissions (and, for beta, the tape) are fetched PREFETCH steps ahead
// into a register ring, and a step stores the row the step before it
// made, so neither a load nor a store waits on the chain. The TPU
// kernel's 128-lane and 8-sublane padding does not carry over: nothing
// is padded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_S = 1024;
// The plan's constants (ctc_variants.py reads and substitutes them).
constexpr int KS = 1;        // states a lane holds
constexpr int PREFETCH = 8;  // steps the loads run ahead
constexpr int GHOST_H = 6;   // steps between exchanges (ghost 2h states)
constexpr int MAX_C = 4;     // CTAs a cluster, at most
constexpr int MAX_W = 4;     // warps a CTA before the plan takes a larger C
constexpr int STRIDED = 0;   // 1: lane j holds states first + 32r + j
constexpr int TRIM = 0;      // 1: a warp wholly outside the band skips

constexpr int H_EFF = GHOST_H < 8 * KS ? GHOST_H : 8 * KS;
constexpr int CAP = 32 * KS - 2 * H_EFF;  // own states a warp holds at most
constexpr int W_MAX = (MAX_S + CAP - 1) / CAP < 32 ? (MAX_S + CAP - 1) / CAP
                                                   : 32;
constexpr int DEPTH = PREFETCH + 1;  // rows the load ring holds
// Consecutive states with KS even: a lane's state r has r's parity.
constexpr bool PARITY = !STRIDED && KS % 2 == 0;

struct Plan {
  int C;    // CTAs a cluster
  int W;    // warps a CTA
  int own;  // states a segment owns (the last one fewer): ceil(S / own)
            // segments, one a warp; a warp past them idles
  int h;    // steps between exchanges
};

// The launch's plan; ctc_variants.plan mirrors it. C grows from 1 until
// a CTA needs at most MAX_W warps, as long as B * C CTAs fit the SMs in
// one wave (past the SMs, when no C fits, the fewest CTAs that hold the
// band). W is the fewest warps whose C * W segments of an even `own`
// (at most CAP) cover the band; the band then takes ceil(S / own)
// segments, none empty, and a warp left over idles. A segment owns its
// downstream neighbour's ghost zone: h is at most own / 2.
bool make_plan(int B, int S, int sm_count, Plan* p) {
  bool found = false;
  for (int pass = 0; pass < 2 && !found; ++pass) {
    for (int C = 1; C <= MAX_C; C *= 2) {
      if (pass == 0 && C > 1 && B * C > sm_count) break;
      const int W = ((S + CAP - 1) / CAP + C - 1) / C;
      if (W > W_MAX) continue;
      int own = (S + C * W - 1) / (C * W);
      own += own & 1;
      const int h = (S + own - 1) / own > 1 && own / 2 < H_EFF ? own / 2
                                                                 : H_EFF;
      *p = {C, W, own, h};
      found = true;
      if (W <= MAX_W || pass == 1) break;
    }
  }
  return found;
}

// log(e^a + e^b + e^c); NEG when every term is NEG, as the TPU kernel's
// guarded _logaddexp. Computed whole and then selected, with no branch:
// a lane's KS states then run their chains side by side instead of one
// divergent region after another.
__device__ __forceinline__ float lse3(float a, float b, float c) {
  const float m = fmaxf(fmaxf(a, b), c);
  const float v = m + logf(expf(a - m) + expf(b - m) + expf(c - m));
  return m <= 0.5f * NEG ? NEG : v;
}

// lse3(a, b, NEG) without its third term: m > NEG/2 makes exp(NEG - m)
// exactly +0, and x + 0 is x for the sum x >= 0.
__device__ __forceinline__ float lse3_blank(float a, float b) {
  const float m = fmaxf(fmaxf(a, b), NEG);
  const float v = m + logf(expf(a - m) + expf(b - m));
  return m <= 0.5f * NEG ? NEG : v;
}

__device__ __forceinline__ float lse2(float a, float b) {
  const float m = fmaxf(a, b);
  const float v = m + logf(expf(a - m) + expf(b - m));
  return m <= 0.5f * NEG ? NEG : v;
}

constexpr unsigned FULL = 0xffffffffu;

// The band state of a lane's slot r.
__device__ __forceinline__ int state(int first, int lane, int r) {
  return STRIDED ? first + 32 * r + lane : first + KS * lane + r;
}

// x at s-1 and s-2 for each slot (NEG below the warp's span).
__device__ __forceinline__ void left(const float (&x)[KS], int lane,
                                     float (&l1)[KS], float (&l2)[KS]) {
  if (STRIDED) {
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      const float below = r > 0 ? x[r > 0 ? r - 1 : 0] : NEG;
      l1[r] = __shfl_sync(FULL, lane == 31 ? below : x[r], (lane + 31) & 31);
      l2[r] = __shfl_sync(FULL, lane >= 30 ? below : x[r], (lane + 30) & 31);
    }
    if (lane == 0) l1[0] = l2[0] = NEG;
    if (lane == 1) l2[0] = NEG;
    return;
  }
  float u1 = __shfl_up_sync(FULL, x[KS - 1], 1);
  float u2 = KS >= 2 ? __shfl_up_sync(FULL, x[KS >= 2 ? KS - 2 : 0], 1)
                     : __shfl_up_sync(FULL, x[0], 2);
  if (lane < 1) u1 = NEG;
  if (lane < (KS >= 2 ? 1 : 2)) u2 = NEG;
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    l1[r] = r >= 1 ? x[r >= 1 ? r - 1 : 0] : u1;
    l2[r] = r >= 2 ? x[r >= 2 ? r - 2 : 0] : (r == 1 ? u1 : u2);
  }
}

// x at s+1 and s+2 for each slot (NEG above the warp's span).
__device__ __forceinline__ void right(const float (&x)[KS], int lane,
                                      float (&r1)[KS], float (&r2)[KS]) {
  if (STRIDED) {
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      const float above = r + 1 < KS ? x[r + 1 < KS ? r + 1 : 0] : NEG;
      r1[r] = __shfl_sync(FULL, lane == 0 ? above : x[r], (lane + 1) & 31);
      r2[r] = __shfl_sync(FULL, lane <= 1 ? above : x[r], (lane + 2) & 31);
    }
    if (lane == 31) r1[KS - 1] = r2[KS - 1] = NEG;
    if (lane == 30) r2[KS - 1] = NEG;
    return;
  }
  float d1 = __shfl_down_sync(FULL, x[0], 1);
  float d2 = KS >= 2 ? __shfl_down_sync(FULL, x[KS >= 2 ? 1 : 0], 1)
                     : __shfl_down_sync(FULL, x[0], 2);
  if (lane == 31) d1 = NEG;
  if (lane >= (KS >= 2 ? 31 : 30)) d2 = NEG;
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    r1[r] = r + 1 < KS ? x[r + 1 < KS ? r + 1 : 0] : d1;
    r2[r] = r + 2 < KS ? x[r + 2 < KS ? r + 2 : 0] : (r + 2 == KS ? d1 : d2);
  }
}

// Point-to-point mailboxes between neighbouring segments. A segment's
// Mail, in its CTA's shared memory, holds RING slots of incoming edge
// values, a `full` mbarrier per slot (the receiver arrives with the
// bytes it expects; the sender's st.async completes them) and an
// `empty` mbarrier per slot of its outgoing mailbox (the receiver
// arrives, from its CTA, once it has read the slot). No barrier spans
// more than the two segments, so a segment waits only for its upstream
// neighbour, and no fence waits on the loads in flight.
constexpr int RING = 4;  // slots a mailbox holds
constexpr int G_MAX = 2 * GHOST_H;

struct Mail {
  uint64_t full[RING];
  uint64_t empty[RING];
  float box[RING][G_MAX];
};

__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared::cluster address of `local` (a shared::cta address) in CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Arrive on an mbarrier in another CTA (`bar` a shared::cluster address).
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Store v at `dst` (shared::cluster) and complete 4 bytes on `bar`, the
// mbarrier of the CTA that holds dst.
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// One utterance's segment: a warp's geometry and its two mailboxes.
struct Seg {
  int lane, lo, hi, G, first;
  int sends;      // the sender's states [send_base, send_base + G) go out
  int send_base;
  int receives;   // the ghost [ghost_base, ghost_base + G) comes in
  int ghost_base;
  uint32_t my_full, my_empty, dst_box, dst_full, src_empty;
  const float* my_box;

  // Exchange n: send this segment's edge into the downstream mailbox
  // (after the receiver has freed the slot's last use), then take the
  // ghost from its own mailbox and free the slot for the upstream one.
  __device__ void exchange(float (&x)[KS], int n, int S) const {
    const int j = n % RING, u = n / RING;
    if (sends) {
      if (u > 0) mbar_wait(my_empty + 8 * j, (u - 1) & 1);
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        const int q = state(first, lane, r) - send_base;
        if (q >= 0 && q < G)
          st_async(dst_box + 4 * (j * G_MAX + q), x[r], dst_full + 8 * j);
      }
    }
    if (receives) {
      if (lane == 0) mbar_expect(my_full + 8 * j, 4 * G);
      mbar_wait(my_full + 8 * j, u & 1);
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        const int s = state(first, lane, r);
        const int q = s - ghost_base;
        if (q >= 0 && q < G && s < S) x[r] = my_box[j * G_MAX + q];
      }
      __syncwarp();
      if (lane == 0) mbar_arrive_remote(src_empty + 8 * j);
    }
  }
};

// The segment of this warp: alpha's ghost lies below it and its edge
// goes up; beta's the other way. Initialises this warp's mailbox; the
// caller makes the cluster wait for every CTA's before any exchange.
__device__ Seg make_seg(const Plan& p, int S, bool alpha, Mail* mail) {
  Seg g;
  const int rank = blockIdx.x % p.C;
  const int warp = threadIdx.x >> 5;
  const int seg = rank * p.W + warp;
  const int nseg = (S + p.own - 1) / p.own;
  g.lane = threadIdx.x & 31;
  g.lo = seg * p.own;
  g.hi = min(g.lo + p.own, S);
  g.G = 2 * p.h;
  g.first = alpha ? (seg == 0 ? 0 : g.lo - g.G) : g.lo;
  const int to = alpha ? seg + 1 : seg - 1;
  const int from = alpha ? seg - 1 : seg + 1;
  g.sends = seg < nseg && to >= 0 && to < nseg;
  g.receives = seg < nseg && from >= 0 && from < nseg;
  g.send_base = alpha ? (seg + 1) * p.own - g.G : g.lo;
  g.ghost_base = alpha ? g.first : g.hi;
  Mail& m = mail[warp];
  g.my_full = cta_addr(&m.full[0]);
  g.my_empty = cta_addr(&m.empty[0]);
  g.my_box = &m.box[0][0];
  const int t = g.sends ? to : seg, f = g.receives ? from : seg;
  g.dst_box = cluster_addr(cta_addr(&mail[t % p.W].box[0][0]), t / p.W);
  g.dst_full = cluster_addr(cta_addr(&mail[t % p.W].full[0]), t / p.W);
  g.src_empty = cluster_addr(cta_addr(&mail[f % p.W].empty[0]), f / p.W);
  if (g.lane == 0) {
    for (int j = 0; j < RING; ++j) {
      mbar_init(g.my_full + 8 * j);
      mbar_init(g.my_empty + 8 * j);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  return g;
}

template <bool TAPE>
__global__ void __launch_bounds__(32 * W_MAX, 1)
    ctc_alpha_kernel(const float* __restrict__ lp, const int* __restrict__ ext,
                     const unsigned char* __restrict__ skip,
                     const int* __restrict__ lens,
                     const int* __restrict__ s_last, float* __restrict__ tape,
                     float* __restrict__ ll, int T, int V, int S, Plan p) {
  __shared__ Mail mail[W_MAX];
  const Seg g = make_seg(p, S, true, mail);
  cluster_sync();  // every mailbox initialised before any exchange
  const int b = blockIdx.x / p.C;
  const int sl = s_last[b];
  const int len = min(max(lens[b], 0), T);
  const int* eb = ext + size_t(b) * S;
  const unsigned char* kb = skip + size_t(b) * S;
  const float* lpb = lp + size_t(b) * T * V;
  float* tb = TAPE ? tape + size_t(b) * T * S : nullptr;

  int e[KS];
  bool sk[KS], live[KS], mine[KS];
  float a[KS];
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    const int s = state(g.first, g.lane, r);
    const bool in = s >= 0 && s < S;
    e[r] = in ? eb[s] : 0;
    sk[r] = in && s >= 2 && kb[s];
    live[r] = in && s <= sl;
    mine[r] = s >= g.lo && s < g.hi;
    a[r] = (live[r] && (s == 0 || (s == 1 && sl > 0))) ? lpb[e[r]] : NEG;
    if (TAPE && mine[r]) tb[s] = a[r];
  }
  // The ring holds PREFETCH + 1 rows: a step reloads the slot the step
  // before it read, so the load lands in a dead register. Loads are
  // unconditional (rows clamped to the last frame; slots off the band
  // read their unused value at ext 0), and a whole unrolled group runs,
  // its steps past len changing nothing: a predicated load or a branch
  // out of the group makes the compiler copy the loaded registers,
  // which waits on the load at once.
  float ring[DEPTH][KS];
#pragma unroll
  for (int i = 0; i < DEPTH; ++i)
#pragma unroll
    for (int r = 0; r < KS; ++r)
      ring[i][r] = i < PREFETCH ? lpb[min(1 + i, max(len - 1, 0)) * V + e[r]]
                                : 0.f;

  const bool exch = p.C * p.W > 1;
  int until = p.h, n = 0;
  // The neighbours' values are shuffled in as soon as a step has made
  // them (and again after an exchange), so that the next step's chain
  // does not start behind its loads' address arithmetic.
  float l1[KS], l2[KS];
  left(a, g.lane, l1, l2);
  int t0 = 1;
  for (; t0 < len; t0 += DEPTH) {
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int t = t0 + i;
      const bool on = t < len;
      const float(&lt)[KS] = ring[i];
      float(&next)[KS] = ring[(i + PREFETCH) % DEPTH];
      const int ahead = min(t + PREFETCH, len - 1) * V;
#pragma unroll
      for (int r = 0; r < KS; ++r) next[r] = lpb[ahead + e[r]];
      // Row t-1, the alpha this step reads, is stored while the step
      // runs: the store waits on nothing of the chain. A step past len
      // holds alpha, so its row is the held one.
      if (TAPE && t > 1 && t - 1 < T) {
        float* row = tb + (t - 1) * S;
#pragma unroll
        for (int r = 0; r < KS; ++r)
          if (mine[r]) row[state(g.first, g.lane, r)] = a[r];
      }
      // Band trim: a warp wholly above min(2L, 2t+1) holds NEG.
      if (!TRIM || g.first <= min(sl, 2 * t + 1)) {
#pragma unroll
        for (int r = 0; r < KS; ++r) {
          float nw;
          if (PARITY && r % 2 == 0)
            nw = lt[r] + lse3_blank(a[r], l1[r]);
          else
            nw = lt[r] + lse3(a[r], l1[r], sk[r] ? l2[r] : NEG);
          a[r] = on ? (live[r] ? nw : NEG) : a[r];
        }
        left(a, g.lane, l1, l2);
      }
      if (exch && --until == 0) {
        until = p.h;
        g.exchange(a, n++, S);
        left(a, g.lane, l1, l2);
      }
    }
  }
  // The ghost exact again, for s_last - 1 below a segment's edge.
  if (exch && until != p.h) g.exchange(a, n++, S);
  // No CTA leaves while a neighbour may still arrive on its mailbox.
  if (exch) cluster_sync();
  left(a, g.lane, l1, l2);
#pragma unroll
  for (int r = 0; r < KS; ++r)
    if (mine[r] && state(g.first, g.lane, r) == sl)
      ll[b] = lse2(a[r], sl > 0 ? l1[r] : NEG);
  // s_last past the band is a caller's error: NaN, never a stray read.
  if ((sl < 0 || sl >= S) && g.lo == 0 && g.lane == 0)
    ll[b] = __int_as_float(0x7fc00000);
  if (TAPE) {  // the rows the loop has not stored, from t0 - 1 on
    for (int t = max(t0 - 1, 1); t < T; ++t) {
      float* row = tb + t * S;
#pragma unroll
      for (int r = 0; r < KS; ++r)
        if (mine[r]) row[state(g.first, g.lane, r)] = a[r];
    }
  }
}

// beta is never stored: a lane holds c[s] = beta_t[s] + lp_t[s], the
// term every move out of t-1 adds.
__global__ void __launch_bounds__(32 * W_MAX, 1)
    ctc_beta_kernel(const float* __restrict__ lp, const int* __restrict__ ext,
                    const unsigned char* __restrict__ skip,
                    const int* __restrict__ lens,
                    const int* __restrict__ s_last,
                    const float* __restrict__ alpha,
                    const float* __restrict__ ll, float* __restrict__ gamma,
                    int T, int V, int S, Plan p) {
  __shared__ Mail mail[W_MAX];
  const Seg g = make_seg(p, S, false, mail);
  cluster_sync();  // every mailbox initialised before any exchange
  const int b = blockIdx.x / p.C;
  const int sl = s_last[b];
  const int len = min(max(lens[b], 0), T);
  const float llb = ll[b];
  const int* eb = ext + size_t(b) * S;
  const unsigned char* kb = skip + size_t(b) * S;
  const float* lpb = lp + size_t(b) * T * V;
  const float* ab = alpha + size_t(b) * T * S;
  float* gb = gamma + size_t(b) * T * S;

  int e[KS];
  bool sk2[KS], live[KS], mine[KS];
  float term[KS];
#pragma unroll
  for (int r = 0; r < KS; ++r) {
    const int s = state(g.first, g.lane, r);
    const bool in = s < S;
    e[r] = in ? eb[s] : 0;
    // The skip s -> s+2 is legal when skip[s+2]: judged at the destination.
    sk2[r] = s + 2 < S && kb[s + 2];
    live[r] = in && s <= sl;
    mine[r] = s >= g.lo && s < g.hi;
    term[r] = (s == sl || (s == sl - 1 && sl > 0)) ? 0.f : NEG;
  }
  // Frames at or past len: gamma is zero, off the serial chain.
  for (int t = len; t < T; ++t) {
    float* row = gb + t * S;
#pragma unroll
    for (int r = 0; r < KS; ++r)
      if (mine[r]) row[state(g.first, g.lane, r)] = 0.f;
  }
  if (len == 0) return;

  // t = len-1: beta restarts at the terminal states.
  float c[KS];
  {
    const int t = len - 1;
    float* row = gb + t * S;
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      const int s = state(g.first, g.lane, r);
      if (mine[r])
        row[s] = live[r] ? expf(fminf(ab[t * S + s] + term[r] - llb, 0.f))
                         : 0.f;
      c[r] = live[r] ? term[r] + lpb[t * V + e[r]] : NEG;
    }
  }
  // The rings of lp and of the tape, as the alpha kernel's: PREFETCH + 1
  // rows, unconditional loads (rows clamped to frame 0, slots past the
  // band at the last state), whole groups with their steps before
  // frame 0 changing nothing.
  int sc[KS];
#pragma unroll
  for (int r = 0; r < KS; ++r) sc[r] = min(state(g.first, g.lane, r), S - 1);
  float ring_lp[DEPTH][KS], ring_a[DEPTH][KS];
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) {
    const int t = max(len - 2 - i, 0);
#pragma unroll
    for (int r = 0; r < KS; ++r) {
      ring_lp[i][r] = i < PREFETCH ? lpb[t * V + e[r]] : 0.f;
      ring_a[i][r] = i < PREFETCH ? ab[t * S + sc[r]] : 0.f;
    }
  }

  const bool exch = p.C * p.W > 1;
  const int top = g.first + 32 * KS - 1;  // the span's highest state
  int until = p.h, n = 0;
  float r1[KS], r2[KS];  // c at s+1 and s+2, shuffled in as alpha's
  right(c, g.lane, r1, r2);
  // beta and the tape at the row the last step made: its gamma is
  // stored during the next step.
  float pbeta[KS], pat[KS];
#pragma unroll
  for (int r = 0; r < KS; ++r) pbeta[r] = pat[r] = 0.f;
  auto gamma_row = [&](int t, const float(&bt)[KS], const float(&at)[KS]) {
    float* row = gb + t * S;
#pragma unroll
    for (int r = 0; r < KS; ++r)
      if (mine[r])
        row[state(g.first, g.lane, r)] =
            live[r] ? expf(fminf(at[r] + bt[r] - llb, 0.f)) : 0.f;
  };
  for (int t0 = len - 2; t0 >= 0; t0 -= DEPTH) {
#pragma unroll
    for (int i = 0; i < DEPTH; ++i) {
      const int t = t0 - i;
      const bool on = t >= 0;
      const float(&lt)[KS] = ring_lp[i];
      const float(&at)[KS] = ring_a[i];
      const int j = (i + PREFETCH) % DEPTH;
      const int ahead = max(t - PREFETCH, 0);
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        ring_lp[j][r] = lpb[ahead * V + e[r]];
        ring_a[j][r] = ab[ahead * S + sc[r]];
      }
      float beta[KS];
      // Band trim: below 2L-1-2(len-1-t) beta is NEG.
      if (!TRIM || top >= sl - 1 - 2 * (len - 1 - t)) {
#pragma unroll
        for (int r = 0; r < KS; ++r) {
          float rec;
          if (PARITY && r % 2 == 0)
            rec = lse3_blank(c[r], r1[r]);
          else
            rec = lse3(c[r], r1[r], sk2[r] ? r2[r] : NEG);
          beta[r] = live[r] ? rec : NEG;
        }
      } else {
#pragma unroll
        for (int r = 0; r < KS; ++r) beta[r] = NEG;
      }
      // gamma's row t+1, from the step before, is stored while this
      // step's chain runs (row len-1 went out before the loop).
      if (t + 1 >= 0 && t + 1 <= len - 2) gamma_row(t + 1, pbeta, pat);
#pragma unroll
      for (int r = 0; r < KS; ++r) {
        pbeta[r] = on ? beta[r] : pbeta[r];
        pat[r] = on ? at[r] : pat[r];
        c[r] = on ? (live[r] ? beta[r] + lt[r] : NEG) : c[r];
      }
      right(c, g.lane, r1, r2);
      if (exch && --until == 0) {
        until = p.h;
        g.exchange(c, n++, S);
        right(c, g.lane, r1, r2);
      }
    }
  }
  if (len >= 2) gamma_row(0, pbeta, pat);
  // No CTA leaves while a neighbour may still arrive on its mailbox.
  if (exch) cluster_sync();
}

// Offsets inside a utterance are 32-bit: T * max(V, S) < 2^31.
cudaError_t plan_for(int B, int T, int V, int S, int device, Plan* p) {
  if (S < 1 || S > MAX_S || B < 1 || T < 1 || V < 1 ||
      int64_t(T) * (V > S ? V : S) >= (int64_t(1) << 31))
    return cudaErrorInvalidValue;
  int sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  return make_plan(B, S, sm, p) ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Plan& p, int B, int device,
                   void* stream, Args... args) {
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.C);
  cfg.blockDim = dim3(32 * p.W);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args..., p);
  if (err == cudaSuccess) err = cudaGetLastError();
  const cudaError_t restore = cudaSetDevice(prev);
  return err != cudaSuccess ? err : restore;
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
  Plan p;
  cudaError_t err = plan_for(B, T, V, S, device, &p);
  if (err != cudaSuccess) return err;
  if (tape)
    return launch(ctc_alpha_kernel<true>, p, B, device, stream, lp, ext, skip,
                  lens, s_last, tape, ll, T, V, S);
  return launch(ctc_alpha_kernel<false>, p, B, device, stream, lp, ext, skip,
                lens, s_last, tape, ll, T, V, S);
}

int ctc_beta_launch(const float* lp, const int* ext,
                    const unsigned char* skip, const int* lens,
                    const int* s_last, const float* alpha, const float* ll,
                    float* gamma, int B, int T, int V, int S, int device,
                    void* stream) {
  Plan p;
  cudaError_t err = plan_for(B, T, V, S, device, &p);
  if (err != cudaSuccess) return err;
  return launch(ctc_beta_kernel, p, B, device, stream, lp, ext, skip, lens,
                s_last, alpha, ll, gamma, T, V, S);
}

// The plan both launches take at (B, S) on `device`: out = {C, W, own,
// h, KS, PREFETCH, STRIDED}. Returns 0 or a cudaError_t.
int ctc_plan(int B, int S, int device, int* out) {
  Plan p;
  cudaError_t err = plan_for(B, 1, 1, S, device, &p);
  if (err != cudaSuccess) return err;
  const int v[7] = {p.C, p.W, p.own, p.h, KS, PREFETCH, STRIDED};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

const char* ctc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
