// Colinear chaining DP for Hopper: two variants, each with an exact
// window and a pruned instance.
//
// Replaces all six Pallas kernels of minimap2_rs_tpu/ops/chain_pallas.py.
// Their split into static-sublane, dynamic-sublane and lane layouts
// existed only for the TPU's VMEM and (8, 128) tiling; here one kernel
// template with a runtime window H serves every shape:
//
//   mm2t_chain_dp_aux (kAux = true) -> (f, cnt, sq, sr), for the lite path:
//     _static_aux_kernel     (A < 1024, full window)
//     _chain_aux_kernel      (A < 1024, truncated window)
//     _chain_aux_kernel_lane (A >= 1024)
//   mm2t_chain_dp     (kAux = false) -> (f, prev), for the general path:
//     _static_kernel         (A < 1024, full window)
//     _chain_kernel          (A < 1024, truncated window)
//     _chain_kernel_lane     (A >= 1024)
//
// Contract (chain_ops.chain_dp_batch / chain_dp_aux_batch in the JAX
// package): for anchor i of read b, the best f[j] + comput_sc(i, j) over
// admissible j in [max(0, i-H), i), ties to the largest j. If it does not
// beat span[i], f[i] = span[i] and i starts a chain: prev = -1, cnt = 1,
// sq/sr = own coordinates. Otherwise prev = the chosen j, and cnt, sq, sr
// follow it (cnt + 1, its chain start).
//
// Design: one warp per read. The DP is sequential in i, so the warp
// walks i in order; its 32 lanes stride over the j window, each keeping
// its best (score, j), and a shuffle reduction picks the max score and
// then the largest j. Lane 0 writes row i; __syncwarp() orders that
// write before row i+1 reads it. The window is read from global memory
// (it stays L1/L2-resident): a long read at A ~ 12k needs 8 arrays x 4 B
// x A, more than a block's 227 KB of shared memory. The (f, prev)
// variant has no dependent load after the reduction: prev is the index
// itself, where the aux variant reads cnt/sq/sr at the chosen j.
//
// What bounds it on this card: the latency of each sequential step (a
// window sweep, a 5-level shuffle reduction and, for aux, the dependent
// load of the chosen predecessor's statistics) and the global-memory
// window reads, not FLOPs. Parallelism is one warp per read (1024 warps
// at the short-read shape, one wave on 132 SMs; 128 warps at the
// longest general-path shape, A = 11,904 with a 5000-slot window).
//
// Exactness: the penalty is (int)(pen_gap*dd + pen_skip*dg
// + 0.5f*log2(dd+1)) in f32 with no FMA contraction (__fmul_rn /
// __fadd_rn, and -fmad=false), log2 read from a host-built table of the
// oracle's mg_log2 (oracle/lchain.py:51-80). Differences are taken in
// 64-bit integers. Rows after a read's last valid anchor (grp == -1
// padding, which the mapper places at the end with no admissible
// predecessor) take the base case directly, as the Pallas kernels'
// padding epilogue does (chain_pallas.py:274-285).
//
// The pruned instances (kPrune; mm2t_chain_dp_prune and
// mm2t_chain_dp_aux_prune) replicate the reference's order-dependent
// max_chain_skip early break (oracle/lchain.py:106-129), which the JAX
// package runs only in its lax.scan DP (ops/chain_ops.py:80-137 with
// max_chain_skip, under MM2T_SKIP_PRUNE). They have no Pallas
// counterpart. The walk is newest-first: a beat (sc > max_f, seeded with
// span[i]) decrements the skip counter, floored at 0; a non-beat j with
// t[j] == i increments it and the walk breaks past max_skip; every
// scanned in-band j with prev[j] >= 0 then sets t[prev[j]] = i. The
// lanes score the window 32 slots at a time, newest first, and stage the
// scores and prev values in shared memory; lane 0 walks the admissible
// ones serially (a ballot mask skips the rest) and the warp stops at the
// break. t is a per-read scratch of A ints, set to -1 once: it stores i,
// so it needs no reset between rows. The aux instance keeps prev in a
// per-read scratch as well, for the marks.
//
// ptxas -v for sm_90a (build log of an H100 run), as <kAux, kPrune>:
// <false, false> 44 registers, <true, false> 48, <false, true> 32 and
// <true, true> 40 (both with 1 KB of shared memory); all 0 bytes of
// stack and no spill stores or loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// comput_sc (lchain.rs:17-34) of anchor j as a predecessor of i, plus
// f[j]; false when j is not admissible
__device__ __forceinline__ bool score(
    int j, int gi, long long ri, long long qi, const int* g, const int* rp,
    const int* qp, const int* sp, const int* fo, const float* log2tab,
    int tab_len, int mdx, int mdy, int bw, float pen_gap, float pen_skip,
    int* out) {
  if (g[j] != gi) return false;
  const long long dq = qi - qp[j];
  const long long dr = ri - rp[j];
  const long long dd = dr > dq ? dr - dq : dq - dr;
  if (dq <= 0 || dq > mdx || dq > mdy || dr == 0 || dr > mdx || dd > bw)
    return false;
  const long long dg = dr < dq ? dr : dq;
  const int sj = sp[j];
  int sc = (int)(sj < dg ? sj : dg);
  if (dd != 0 || dg > sj) {
    const int t = (int)(dd < tab_len - 1 ? dd : tab_len - 1);
    const float lin = __fadd_rn(__fmul_rn(pen_gap, (float)dd),
                                __fmul_rn(pen_skip, (float)dg));
    sc -= __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, log2tab[t])));
  }
  *out = sc + fo[j];
  return true;
}

// kAux: (f, cnt, sq, sr). !kAux: (f, prev); o2 and o3 are unused.
// kPrune: the max_chain_skip walk; pv is prev (the aux instance's
// scratch, else o1) and tt the marks scratch, both (B, A).
template <bool kAux, bool kPrune>
__global__ void chain_dp_kernel(
    const int* __restrict__ grp, const int* __restrict__ rpos,
    const int* __restrict__ qpos, const int* __restrict__ span,
    int* f, int* o1, int* o2, int* o3, int* pv_scratch, int* t_scratch,
    const float* __restrict__ log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, int max_skip) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;  // whole warps exit together
  const size_t base = (size_t)b * A;
  const int* g = grp + base;
  const int* rp = rpos + base;
  const int* qp = qpos + base;
  const int* sp = span + base;
  int* fo = f + base;
  int* co = o1 + base;  // cnt (aux) or prev
  int* qo = kAux ? o2 + base : nullptr;
  int* ro = kAux ? o3 + base : nullptr;
  int* pv = kPrune ? (kAux ? pv_scratch + base : co) : nullptr;
  int* tt = kPrune ? t_scratch + base : nullptr;

  // rows >= n are trailing padding
  int last = -1;
  for (int j = lane; j < A; j += 32)
    if (g[j] != -1) last = j;
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, o));
  const int n = last + 1;

  for (int i = lane + n; i < A; i += 32) {
    fo[i] = sp[i];
    if (kAux) {
      co[i] = 1;
      qo[i] = qp[i];
      ro[i] = rp[i];
    } else {
      co[i] = -1;
    }
  }
  if (kPrune) {
    for (int i = lane; i < n; i += 32) tt[i] = -1;
    __syncwarp();
  }

  __shared__ int s_sc[kPrune ? kWarpsPerBlock : 1][32];
  __shared__ int s_pv[kPrune ? kWarpsPerBlock : 1][32];

  for (int i = 0; i < n; ++i) {
    const int gi = g[i];
    const long long ri = rp[i];
    const long long qi = qp[i];
    const int si = sp[i];
    int best = kNegInf;
    int jb = -1;
    if (!kPrune) {
      for (int j = max(0, i - H) + lane; j < i; j += 32) {
        int sc;
        if (!score(j, gi, ri, qi, g, rp, qp, sp, fo, log2tab, tab_len, mdx,
                   mdy, bw, pen_gap, pen_skip, &sc))
          continue;
        // j ascends per lane, so >= keeps this lane's largest tied j
        if (sc >= best) {
          best = sc;
          jb = j;
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        const int ob = __shfl_xor_sync(kFull, best, o);
        const int oj = __shfl_xor_sync(kFull, jb, o);
        if (ob > best || (ob == best && oj > jb)) {
          best = ob;
          jb = oj;
        }
      }
    } else {
      // newest-first walk in chunks of 32; lane 0 carries (best, jb,
      // n_skip) and the break
      const int lo = max(0, i - H);
      best = si;
      int n_skip = 0;
      bool brk = false;
      for (int top = i - 1; top >= lo && !brk; top -= 32) {
        const int j = top - lane;
        int sc = 0;
        const bool ok = j >= lo &&
            score(j, gi, ri, qi, g, rp, qp, sp, fo, log2tab, tab_len, mdx,
                  mdy, bw, pen_gap, pen_skip, &sc);
        const unsigned okm = __ballot_sync(kFull, ok);
        s_sc[warp][lane] = sc;
        s_pv[warp][lane] = ok ? pv[j] : -1;
        __syncwarp();
        if (lane == 0) {
          for (unsigned m = okm; m; m &= m - 1) {
            const int u = __ffs(m) - 1;  // lowest lane = newest j
            const int jj = top - u;
            const int s = s_sc[warp][u];
            if (s > best) {
              best = s;
              jb = jj;
              if (n_skip > 0) --n_skip;
            } else if (tt[jj] == i) {
              if (++n_skip > max_skip) {
                brk = true;
                break;
              }
            }
            const int p = s_pv[warp][u];
            if (p >= 0) tt[p] = i;
          }
        }
        brk = __shfl_sync(kFull, brk, 0);
        __syncwarp();  // the next chunk overwrites the staging
      }
    }
    if (lane == 0) {
      const bool win = jb >= 0 && best > si;
      fo[i] = win ? best : si;
      if (kAux) {
        if (win) {
          co[i] = co[jb] + 1;
          qo[i] = qo[jb];
          ro[i] = ro[jb];
        } else {
          co[i] = 1;
          qo[i] = (int)qi;
          ro[i] = (int)ri;
        }
      } else {
        co[i] = win ? jb : -1;
      }
      if (kPrune && kAux) pv[i] = win ? jb : -1;
    }
    __syncwarp();
  }
}

template <bool kAux, bool kPrune>
int launch(const void* grp, const void* rpos, const void* qpos,
           const void* span, void* f, void* o1, void* o2, void* o3,
           void* pv_scratch, void* t_scratch,
           const void* log2tab, int tab_len, int B, int A, int H, int mdx,
           int mdy, int bw, float pen_gap, float pen_skip, int max_skip,
           void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaSuccess;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_dp_kernel<kAux, kPrune><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)grp, (const int*)rpos, (const int*)qpos, (const int*)span,
      (int*)f, (int*)o1, (int*)o2, (int*)o3, (int*)pv_scratch,
      (int*)t_scratch, (const float*)log2tab, tab_len, B, A, H, mdx, mdy, bw,
      pen_gap, pen_skip, max_skip);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, allocates nothing and does not
// synchronise; each returns cudaGetLastError() after the launch (0 when
// the launch was accepted).
extern "C" int mm2t_chain_dp_aux(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch<true, false>(grp, rpos, qpos, span, f, cnt, sq, sr, nullptr,
                             nullptr, log2tab, tab_len, B, A, H, mdx, mdy, bw,
                             pen_gap, pen_skip, 0, stream);
}

extern "C" int mm2t_chain_dp(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* prev,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch<false, false>(grp, rpos, qpos, span, f, prev, nullptr,
                              nullptr, nullptr, nullptr, log2tab, tab_len, B,
                              A, H, mdx, mdy, bw, pen_gap, pen_skip, 0,
                              stream);
}

// The pruned instances. prev_scratch (aux only) and t_scratch are (B, A)
// int32 scratch the kernel fills.
extern "C" int mm2t_chain_dp_aux_prune(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr, void* prev_scratch,
    void* t_scratch, const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, int max_skip, void* stream) {
  return launch<true, true>(grp, rpos, qpos, span, f, cnt, sq, sr,
                            prev_scratch, t_scratch, log2tab, tab_len, B, A,
                            H, mdx, mdy, bw, pen_gap, pen_skip, max_skip,
                            stream);
}

extern "C" int mm2t_chain_dp_prune(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* prev, void* t_scratch, const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, int max_skip, void* stream) {
  return launch<false, true>(grp, rpos, qpos, span, f, prev, nullptr,
                             nullptr, nullptr, t_scratch, log2tab, tab_len, B,
                             A, H, mdx, mdy, bw, pen_gap, pen_skip, max_skip,
                             stream);
}
