// Colinear chaining DP for Hopper: two variants, each in three designs,
// and a pruned instance of each in two.
//
// Replaces all six Pallas kernels of minimap2_rs_tpu/ops/chain_pallas.py.
// Their split into static-sublane, dynamic-sublane and lane layouts
// existed only for the TPU's VMEM and (8, 128) tiling; here a runtime
// window H serves every shape, and the shape picks one of four designs
// (kernels/chain_dp.py decides, by A, H and the pruning, before the
// launch):
//
//   short-read kernel (chain_dp_short_kernel): A < 1024, exact window; a
//     warp per read with the whole read in shared memory;
//   lane kernel (chain_dp_lane_kernel): A >= 1024, exact window whose
//     ring fits a block; a block per read, the window in shared memory;
//   pruned kernel (chain_dp_prune_kernel): the pruned instances whose read
//     fits a block; a warp per read with the read in shared memory;
//   warp-per-read template (chain_dp_kernel): any shape whose blocks
//     would not fit shared memory, pruned or not.
//
//   kAux = true -> (f, cnt, sq, sr), for the lite path:
//     _static_aux_kernel     (A < 1024, full window):      mm2t_chain_dp_aux_short
//     _chain_aux_kernel      (A < 1024, truncated window): mm2t_chain_dp_aux_short
//     _chain_aux_kernel_lane (A >= 1024):                  mm2t_chain_dp_aux_lane
//   kAux = false -> (f, prev), for the general path:
//     _static_kernel         (A < 1024, full window):      mm2t_chain_dp_short
//     _chain_kernel          (A < 1024, truncated window): mm2t_chain_dp_short
//     _chain_kernel_lane     (A >= 1024):                  mm2t_chain_dp_lane
//   pruned (no Pallas counterpart): mm2t_chain_dp_aux_prune_smem and
//     mm2t_chain_dp_prune_smem.
//   The template's entries, mm2t_chain_dp_aux, mm2t_chain_dp and their
//   pruned instances mm2t_chain_dp_aux_prune and mm2t_chain_dp_prune, take
//   any shape; kernels/chain_dp.template_batch keeps them callable so a
//   run can time the previous design on the same inputs.
//
// Contract (chain_ops.chain_dp_batch / chain_dp_aux_batch in the JAX
// package): for anchor i of read b, the best f[j] + comput_sc(i, j) over
// admissible j in [max(0, i-H), i), ties to the largest j. If it does not
// beat span[i], f[i] = span[i] and i starts a chain: prev = -1, cnt = 1,
// sq/sr = own coordinates. Otherwise prev = the chosen j, and cnt, sq, sr
// follow it (cnt + 1, its chain start).
//
// Design of the warp-per-read template (chain_dp_kernel: shapes whose
// blocks would not fit): one warp per read. The DP is sequential in i, so
// the warp walks i in order; its 32 lanes stride over the j window, each
// keeping its best (score, j), and a shuffle reduction picks the max score
// and then the largest j. Lane 0 writes row i; __syncwarp() orders that
// write before row i+1 reads it. The window is read from global memory
// (it stays L1/L2-resident). The (f, prev) variant has no dependent load
// after the reduction: prev is the index itself, where the aux variant
// reads cnt/sq/sr at the chosen j. What bounds it: the latency of each
// sequential step (a window sweep of dependent global loads, a 5-level
// shuffle and, for aux, the dependent load of the chosen predecessor's
// statistics), not FLOPs. At the lane shapes it ran 128 warps, one per
// SM, at about 2% of the card's bound, and at the short-read shape about
// 1.4 us a row (PERF.md), hence the lane, short-read and pruned kernels
// below, whose headers give their designs.
//
// Exactness: the penalty is (int)(pen_gap*dd + pen_skip*dg
// + 0.5f*log2(dd+1)) in f32 with no FMA contraction (__fmul_rn /
// __fadd_rn, and -fmad=false), log2 read from a host-built table of the
// oracle's mg_log2 (oracle/lchain.py:51-80). Differences are taken in
// 64-bit integers by the template, the lane and the pruned kernel, in
// 32-bit ones by the short-read kernel (its header says why that is
// exact). Rows after a read's last valid anchor (grp == -1 padding, which
// the mapper places at the end with no admissible predecessor) take the
// base case directly, as the Pallas kernels' padding epilogue does
// (chain_pallas.py:274-285).
//
// The pruned instances (kPrune in the template, and the pruned kernel)
// replicate the reference's order-dependent max_chain_skip early break
// (oracle/lchain.py:106-129), which the JAX package runs only in its
// lax.scan DP (ops/chain_ops.py:80-137 with max_chain_skip, under
// MM2T_SKIP_PRUNE). They have no Pallas counterpart. The walk is
// newest-first: a beat (sc > max_f, seeded with span[i]) decrements the
// skip counter, floored at 0; a non-beat j with t[j] == i increments it
// and the walk breaks past max_skip; every scanned in-band j with
// prev[j] >= 0 then sets t[prev[j]] = i. In the template the lanes score
// the window 32 slots at a time, newest first, and stage the scores and
// prev values in shared memory; lane 0 walks the admissible ones serially
// (a ballot mask skips the rest) and the warp stops at the break. t is a
// per-read scratch of A ints, set to -1 once: it stores i, so it needs no
// reset between rows. The aux instance keeps prev in a per-read scratch
// as well, for the marks. The pruned kernel's header gives its design.
//
// ptxas -v for sm_90a (build log of an H100 run): the template as
// <kAux, kPrune> <false, false> 42 registers, <true, false> 48,
// <false, true> 32 and <true, true> 40 (both with 1 KB of shared
// memory); the lane kernel 44 and 48; the short-read kernel's eight
// <kAux, kSkip, kWide> instances 40 to 56; the pruned kernel 39 ((f, prev)) and 48 (aux);
// all 0 bytes of stack and no spill stores or loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// comput_sc (lchain.rs:17-34) of a predecessor at (rj, qj) with span sj,
// in anchor i's group, without f[j]; false when it is not admissible
__device__ __forceinline__ bool comput_sc(
    long long ri, long long qi, int rj, int qj, int sj, const float* log2tab,
    int tab_len, int mdx, int mdy, int bw, float pen_gap, float pen_skip,
    int* out) {
  const long long dq = qi - qj;
  const long long dr = ri - rj;
  const long long dd = dr > dq ? dr - dq : dq - dr;
  if (dq <= 0 || dq > mdx || dq > mdy || dr == 0 || dr > mdx || dd > bw)
    return false;
  const long long dg = dr < dq ? dr : dq;
  int sc = (int)(sj < dg ? sj : dg);
  if (dd != 0 || dg > sj) {
    const int t = (int)(dd < tab_len - 1 ? dd : tab_len - 1);
    const float lin = __fadd_rn(__fmul_rn(pen_gap, (float)dd),
                                __fmul_rn(pen_skip, (float)dg));
    sc -= __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, log2tab[t])));
  }
  *out = sc;
  return true;
}

// comput_sc of anchor j of a read's global columns as a predecessor of i
__device__ __forceinline__ bool score(
    int j, int gi, long long ri, long long qi, const int* g, const int* rp,
    const int* qp, const int* sp, const float* log2tab,
    int tab_len, int mdx, int mdy, int bw, float pen_gap, float pen_skip,
    int* out) {
  if (g[j] != gi) return false;
  return comput_sc(ri, qi, rp[j], qp[j], sp[j], log2tab, tab_len, mdx, mdy,
                   bw, pen_gap, pen_skip, out);
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
        if (!score(j, gi, ri, qi, g, rp, qp, sp, log2tab, tab_len, mdx, mdy,
                   bw, pen_gap, pen_skip, &sc))
          continue;
        sc += fo[j];
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
            score(j, gi, ri, qi, g, rp, qp, sp, log2tab, tab_len, mdx, mdy,
                  bw, pen_gap, pen_skip, &sc);
        if (ok) sc += fo[j];
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

// ---- the block-per-read lane kernel (exact window, A >= 1024) ----------
//
// One block of kLaneThreads threads per read. The DP reads only the
// window, so the window lives in dynamic shared memory as a ring of
// R = H + kLaneTile slots, one column per array: grp, rpos, qpos, span, f
// and, for aux, cnt, sq, sr. Row r sits in slot r mod R. Every kLaneTile
// rows the block stores the next tile's input columns (held in registers
// since the previous tile start, one row per thread, coalesced) into the
// ring and loads the tile after it; R = H + kLaneTile keeps rows
// [i - H, tile end) resident for every row i of the tile.
//
// Row i: each thread scores its share of [i - H, i) from shared memory
// with comput_sc() (a slot's words loaded together, before any test) and
// keeps its best (score, j), ties to the largest j; two hardware warp
// reductions (__reduce_max_sync: the max score, then the largest j that
// holds it) reduce each warp, warp leaders write the per-parity partial
// arrays, one __syncthreads(), and every warp reduces the kLaneWarps
// partials the same way, so all threads agree on (best, jb). Thread 0 writes row i to
// the ring and to global memory. The parity double buffer keeps the step
// to one barrier per row: a warp can write row i + 2's partials only
// after the barrier of row i + 1, which every thread reaches after
// reading row i's. Row i's f (and cnt/sq/sr) become visible in shared
// memory only after row i + 1's barrier, so row i + 1 takes slot j = i
// from the registers every thread holds (f_last, c_last, ...); older
// slots, and the winner's statistics at jb < i - 1, come from the ring.
//
// What bounds it: the sequential row walk leaves one block per read (128
// at the long-read shapes, about one per SM), and each row costs the
// scoring of ceil(H / kLaneThreads) slots a thread from shared memory,
// four warp reductions and one barrier, issued by every warp of the
// block. 512 threads beat 256 and 1024 at the long-read shapes
// (lane_block_ab.py times the three on one card; PERF.md has the table).
constexpr int kLaneThreads = 512;
constexpr int kLaneWarps = kLaneThreads / 32;
constexpr int kLaneTile = kLaneThreads;  // rows per tile load, one a thread

template <bool kAux>
__global__ void __launch_bounds__(kLaneThreads, 1) chain_dp_lane_kernel(
    const int* __restrict__ grp, const int* __restrict__ rpos,
    const int* __restrict__ qpos, const int* __restrict__ span,
    int* __restrict__ f, int* __restrict__ o1, int* __restrict__ o2,
    int* __restrict__ o3, const float* __restrict__ log2tab, int tab_len,
    int A, int H, int mdx, int mdy, int bw, float pen_gap, float pen_skip) {
  extern __shared__ int ring[];
  __shared__ int s_best[2][kLaneWarps];
  __shared__ int s_jb[2][kLaneWarps];
  __shared__ int s_last[kLaneWarps];
  const int R = H + kLaneTile;
  int* s_g = ring;
  int* s_r = ring + R;
  int* s_q = ring + 2 * R;
  int* s_s = ring + 3 * R;
  int* s_f = ring + 4 * R;
  int* s_c = kAux ? ring + 5 * R : nullptr;
  int* s_sq = kAux ? ring + 6 * R : nullptr;
  int* s_sr = kAux ? ring + 7 * R : nullptr;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)blockIdx.x * A;
  const int* g = grp + base;
  const int* rp = rpos + base;
  const int* qp = qpos + base;
  const int* sp = span + base;
  int* fo = f + base;
  int* co = o1 + base;  // cnt (aux) or prev
  int* qo = kAux ? o2 + base : nullptr;
  int* ro = kAux ? o3 + base : nullptr;

  // rows >= n are trailing padding
  int last = -1;
  for (int j = tid; j < A; j += kLaneThreads)
    if (g[j] != -1) last = j;
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(kFull, last, o));
  if (lane == 0) s_last[warp] = last;
  __syncthreads();
  last = s_last[0];
  for (int w = 1; w < kLaneWarps; ++w) last = max(last, s_last[w]);
  const int n = last + 1;

  for (int i = n + tid; i < A; i += kLaneThreads) {
    fo[i] = sp[i];
    if (kAux) {
      co[i] = 1;
      qo[i] = qp[i];
      ro[i] = rp[i];
    } else {
      co[i] = -1;
    }
  }

  // the first tile's columns, one row a thread
  int pg = 0, pr = 0, pq = 0, ps = 0;
  if (tid < n) {
    pg = g[tid];
    pr = rp[tid];
    pq = qp[tid];
    ps = sp[tid];
  }
  int f_last = 0, c_last = 0, q_last = 0, r_last = 0;
  int islot = 0;  // i mod R
  for (int i = 0; i < n; ++i) {
    if ((i & (kLaneTile - 1)) == 0) {
      // rows [i, i + kLaneTile) into the ring; their slots held rows
      // [i - H - kLaneTile, i - H), which no row from i on reads
      if (i + tid < n) {
        int slot = islot + tid;
        if (slot >= R) slot -= R;
        s_g[slot] = pg;
        s_r[slot] = pr;
        s_q[slot] = pq;
        s_s[slot] = ps;
      }
      const int nr = i + kLaneTile + tid;
      if (nr < n) {
        pg = g[nr];
        pr = rp[nr];
        pq = qp[nr];
        ps = sp[nr];
      }
      __syncthreads();
    }
    const int gi = s_g[islot];
    const long long ri = s_r[islot];
    const long long qi = s_q[islot];
    const int si = s_s[islot];
    int best = kNegInf;
    int jb = -1;
    const int j0 = max(0, i - H) + tid;
    if (j0 < i) {
      int slot = islot - (i - j0);  // i - j0 <= H < R: one wrap at most
      if (slot < 0) slot += R;
      for (int j = j0; j < i; j += kLaneThreads) {
        // the slot's words, loaded together before any test
        const int gj = s_g[slot], rj = s_r[slot], qj = s_q[slot];
        const int sj = s_s[slot];
        const int fj = j == i - 1 ? f_last : s_f[slot];
        int sc;
        if (gj == gi && comput_sc(ri, qi, rj, qj, sj, log2tab, tab_len, mdx,
                                  mdy, bw, pen_gap, pen_skip, &sc)) {
          sc += fj;
          // j ascends per thread, so >= keeps this thread's largest tied j
          if (sc >= best) {
            best = sc;
            jb = j;
          }
        }
        slot += kLaneThreads;
        if (slot >= R) slot -= R;
      }
    }
    // max score, then the largest j holding it: a warp's, then the block's
    const int wb = __reduce_max_sync(kFull, best);
    jb = __reduce_max_sync(kFull, best == wb ? jb : -1);
    best = wb;
    const int par = i & 1;
    if (lane == 0) {
      s_best[par][warp] = best;
      s_jb[par][warp] = jb;
    }
    __syncthreads();
    {
      const int pb = lane < kLaneWarps ? s_best[par][lane] : kNegInf;
      const int pj = lane < kLaneWarps ? s_jb[par][lane] : -1;
      best = __reduce_max_sync(kFull, pb);
      jb = __reduce_max_sync(kFull, pb == best ? pj : -1);
    }
    const bool win = jb >= 0 && best > si;
    const int fi = win ? best : si;
    if (kAux) {
      int ci = 1, qsi = (int)qi, rsi = (int)ri;
      if (win && jb == i - 1) {
        ci = c_last + 1;
        qsi = q_last;
        rsi = r_last;
      } else if (win) {
        int js = islot - (i - jb);
        if (js < 0) js += R;
        ci = s_c[js] + 1;
        qsi = s_sq[js];
        rsi = s_sr[js];
      }
      if (tid == 0) {
        s_f[islot] = fi;
        s_c[islot] = ci;
        s_sq[islot] = qsi;
        s_sr[islot] = rsi;
        fo[i] = fi;
        co[i] = ci;
        qo[i] = qsi;
        ro[i] = rsi;
      }
      c_last = ci;
      q_last = qsi;
      r_last = rsi;
    } else if (tid == 0) {
      s_f[islot] = fi;
      fo[i] = fi;
      co[i] = win ? jb : -1;
    }
    f_last = fi;
    if (++islot == R) islot = 0;
  }
}

// the lane kernel's dynamic shared memory: the ring's R = H + kLaneTile
// slots of 8 (aux) or 5 words
template <bool kAux>
size_t lane_ring_bytes(int H) {
  return (size_t)(H + kLaneTile) * (kAux ? 8 : 5) * sizeof(int);
}

template <bool kAux>
int launch_lane(const void* grp, const void* rpos, const void* qpos,
                const void* span, void* f, void* o1, void* o2, void* o3,
                const void* log2tab, int tab_len, int B, int A, int H, int mdx,
                int mdy, int bw, float pen_gap, float pen_skip, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaSuccess;
  const size_t smem = lane_ring_bytes<kAux>(H);
  // a ring over the block's limit is refused here and raised by the caller
  const cudaError_t e = cudaFuncSetAttribute(
      chain_dp_lane_kernel<kAux>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  chain_dp_lane_kernel<kAux><<<B, kLaneThreads, smem, (cudaStream_t)stream>>>(
      (const int*)grp, (const int*)rpos, (const int*)qpos, (const int*)span,
      (int*)f, (int*)o1, (int*)o2, (int*)o3, (const float*)log2tab, tab_len,
      A, H, mdx, mdy, bw, pen_gap, pen_skip);
  return (int)cudaGetLastError();
}

// ---- the short-read kernel (exact window, A < 1024) ---------------------
//
// A group of kShortThreads threads per read (one warp), kShortReads reads
// a block. The whole read lives in dynamic shared memory: its four input
// columns interleaved as one int4 a slot (one 128-bit load fetches a
// predecessor), loaded once and coalesced, and its outputs (f and cnt,
// sq, sr, or f and prev). The block also stages kShortTab entries of a
// table built from the log2 table (short_stage): at pen_skip == 0 (the
// default) the penalty depends on dd alone, and the table holds it whole;
// otherwise it holds 0.5f * log2(dd + 1). An admissible pair has
// dd <= bw, so below kShortTab (the default band, bw = 500) every lookup
// hits shared memory, and only the instance for a wider band reads the
// global table.
//
// The row walk is pipelined so that a row's critical path holds no pair
// scoring. A pair's score without f[j] does not depend on the DP, and
// f[j] of every slot but the newest is final one row early. So while
// row i's two warp reductions are in flight, each thread scores its slots
// j = lo + tid, lo + tid + 32, ... of row i + 1's window [lo, i]
// (ShortRow), in groups of kShortUnroll slots scored as independent
// chains, the row's last group cut to the strides that reach i:
// short_pair() tests admissibility (32-bit, no branch), a warp vote skips
// a group with no admissible slot in the warp, and short_score() adds the
// penalty (kNegInf where not admissible). Each thread adds f[j] to all
// but the newest slot (j < i) and keeps their best (bo, jo), ties to the
// largest j, and the newest slot's score sn. Row i + 1 itself then only adds f[i],
// taken from registers every thread holds (f_last), to sn, merges it, and
// runs two __reduce_max_sync: the max score, then the largest j holding
// it. Every thread computes the row's outputs and writes them to shared
// memory itself (the same values), so each later read of a row is of the
// thread's own write and needs no barrier; the newest slot's statistics
// come from registers (c_last, ...), an older winner's from shared
// memory. Nothing on a row's path touches global memory: the outputs are
// written, coalesced, after the walk.
//
// With kShortThreads = 64 (two warps a read; short_block_ab.py times both)
// each warp reduces its half, the warp leaders write parity-buffered
// partials, and a named barrier of the group's 64 threads (bar.sync
// 1 + group, 64) precedes the combine: one barrier a row, as in the lane
// kernel.
//
// Exactness of 32-bit scoring: valid anchors' positions lie in [0, 2^31)
// (the mapper passes x_lo and y_lo, chain_inputs in models/stages.py), so
// the wrapped differences dr, dq of two valid anchors are exact; the
// unsigned compares (dq - 1 <u min(mdx, mdy), dr - 1 <u mdx; the Pallas
// kernel's reduced form, chain_pallas.py:114-121) pass exactly the pairs
// with dq in [1, min(mdx, mdy)] and dr in [1, mdx], and only those use dd.
// With pen_skip == 0 (instance kSkip = false) the reference's penalty is
// trunc(fl(fl(pen_gap * dd) + fl(0.5 * log2(dd + 1)))), the staged value,
// and it is 0 where dd == 0, so it is subtracted unconditionally. A slot
// that is not admissible adds f[j] to kNegInf: it stays below every
// admissible score and below span[i] >= 0, so it never wins.
//
// What bounds it: the scoring. On the headline's inputs (B = 1024,
// A = 256) the walk without it takes about a fifth of the kernel's time
// (PERF.md); with about 8 warps an SM its dependent chains leave most
// issue slots empty. Four slots a group beat two, and one warp a read
// two (short_block_ab.py times both).
constexpr int kShortThreads = 32;  // threads per read
constexpr int kShortWarps = kShortThreads / 32;
constexpr int kShortReads = 4;     // reads per block
constexpr int kShortTab = 1024;    // penalty-table entries staged in shared memory
constexpr int kShortUnroll = 4;    // slots a thread scores as one group

// bar.sync on the named barrier of the block's read group g: its
// kShortThreads threads only (barrier 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int g) {
#ifdef MM2T_CUDA_EMUL
  mm2t_emul::bar_sync(1 + g, kShortThreads);
#else
  asm volatile("bar.sync %0, %1;" ::"r"(1 + g), "r"(kShortThreads) : "memory");
#endif
}

// The admissibility of predecessor slot s = (grp, rpos, qpos, span) for
// anchor (gi, ri, qi), with the pair's dd and dg: 32-bit, branch-free.
struct ShortPair {
  bool ok;
  int dd, dg;
};

__device__ __forceinline__ ShortPair short_pair(int gi, int ri, int qi, int4 s,
                                                unsigned mn_u, unsigned mdx_u,
                                                int bw) {
  const int dq = (int)((unsigned)qi - (unsigned)s.z);
  const int dr = (int)((unsigned)ri - (unsigned)s.y);
  const unsigned de = (unsigned)dr - (unsigned)dq;
  const int dd = (int)((int)de < 0 ? 0u - de : de);
  const bool ok = s.x == gi && (unsigned)dq - 1u < mn_u &&
                  (unsigned)dr - 1u < mdx_u && dd <= bw;
  return ShortPair{ok, dd, min(dr, dq)};
}

// comput_sc of an admissible pair without f[j]; kNegInf where not
// admissible. kSkip: pen_skip != 0; kWide: bw >= kShortTab. s_tab holds
// the first kShortTab entries of a staged table (short_stage): at
// pen_skip == 0 the penalty depends on dd alone, and the default band's
// instance reads it whole from s_tab; otherwise s_tab holds 0.5f * log2,
// and the wide band's instance reads the global table (cached, and
// branch-free).
template <bool kSkip, bool kWide>
__device__ __forceinline__ int short_score(
    ShortPair p, int span_j, const int* s_tab,
    const float* __restrict__ log2tab, float pen_gap, float pen_skip) {
  const int t = p.ok ? p.dd : 0;  // dd <= bw < the table's length
  int pen;
  if (!kSkip && !kWide) {
    pen = s_tab[t];
  } else {
    const float hl = kWide ? __fmul_rn(0.5f, __ldg(log2tab + t))
                           : __int_as_float(s_tab[t]);
    float lin = __fmul_rn(pen_gap, (float)p.dd);
    if (kSkip) lin = __fadd_rn(lin, __fmul_rn(pen_skip, (float)p.dg));
    pen = __float2int_rz(__fadd_rn(lin, hl));
  }
  int sc = min(span_j, p.dg);
  if (!kSkip || p.dd != 0 || p.dg > span_j) sc -= pen;
  return p.ok ? sc : kNegInf;
}

// The scoring of one row's window, for anchor nx: each thread's best
// (bo, jo) over its slots j < i with f[j] added, ties to the largest j,
// and the score sn of its slot j == i (kNegInf if it holds none).
template <bool kSkip, bool kWide>
struct ShortRow {
  int4 nx;
  int i, tid, bw;
  unsigned mn_u, mdx_u;
  float pen_gap, pen_skip;
  const int4* s_in;
  const int* s_f;
  const int* s_tab;
  const float* log2tab;
  int bo = kNegInf, jo = -1, sn = kNegInf;

  // kU slots from b0 + tid, kShortThreads apart, as independent chains
  template <int kU>
  __device__ __forceinline__ void group(int b0) {
    int4 s[kU];
    ShortPair p[kU];
    bool any = false;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = b0 + tid + u * kShortThreads;
      s[u] = s_in[min(j, i)];  // a slot of the read, for j past i
      p[u] = short_pair(nx.x, nx.y, nx.z, s[u], mn_u, mdx_u, bw);
      p[u].ok = p[u].ok && j <= i;
      any = any || p[u].ok;
    }
    // a group with no admissible slot in the warp skips the penalties
    if (!__any_sync(kFull, any)) return;
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int j = b0 + tid + u * kShortThreads;
      const int sc = short_score<kSkip, kWide>(p[u], s[u].w, s_tab, log2tab,
                                               pen_gap, pen_skip);
      // s_f[i] is not written yet: used only when j < i
      const int v = sc + s_f[min(j, i)];
      // j ascends per thread, so >= keeps its largest j among equal scores
      const bool take = j < i && v >= bo;
      bo = take ? v : bo;
      jo = take ? j : jo;
      sn = j == i ? sc : sn;
    }
  }

  // a group of the `left` (warp-uniform) strides of slots that reach i,
  // at most kU: the last group of a row scores no stride wholly past i
  template <int kU>
  __device__ __forceinline__ void group_upto(int b0, int left) {
    if constexpr (kU > 1) {
      if (left < kU) return group_upto<kU - 1>(b0, left);
    }
    group<kU>(b0);
  }

  __device__ __forceinline__ void score(int lo) {
    for (int b0 = lo; b0 <= i; b0 += kShortUnroll * kShortThreads)
      group_upto<kShortUnroll>(b0, (i - b0) / kShortThreads + 1);
  }
};

// entry t of the staged table: the whole penalty of dd = t at pen_skip == 0
// (the reference's fl(fl(pen_gap * dd) + fl(0.5 * log2(dd + 1))), then
// truncated), else the bits of 0.5f * log2(t + 1)
template <bool kSkip>
__device__ __forceinline__ int short_stage(int t, const float* __restrict__ log2tab,
                                           float pen_gap) {
  const float hl = __fmul_rn(0.5f, log2tab[t]);
  if (kSkip) return __float_as_int(hl);
  return __float2int_rz(__fadd_rn(__fmul_rn(pen_gap, (float)t), hl));
}

template <bool kAux, bool kSkip, bool kWide>
__global__ void __launch_bounds__(kShortReads * kShortThreads)
chain_dp_short_kernel(
    const int* __restrict__ grp, const int* __restrict__ rpos,
    const int* __restrict__ qpos, const int* __restrict__ span,
    int* __restrict__ f, int* __restrict__ o1, int* __restrict__ o2,
    int* __restrict__ o3, const float* __restrict__ log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw, float pen_gap,
    float pen_skip) {
  extern __shared__ int4 s_short[];
  // per parity, read group and warp: (best, jb); used at kShortWarps > 1
  __shared__ int s_part[2][kShortReads][kShortWarps][2];
  int* s_tab = reinterpret_cast<int*>(s_short);
  const int n_tab = min(tab_len, kShortTab);
  for (int t = threadIdx.x; t < n_tab; t += blockDim.x)
    s_tab[t] = short_stage<kSkip>(t, log2tab, pen_gap);
  __syncthreads();

  const int gid = threadIdx.x / kShortThreads;
  const int tid = threadIdx.x % kShortThreads;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x * kShortReads + gid;
  if (b >= B) return;  // whole groups exit together, after the block's barrier
  // layout: the table, then every group's slots, then every group's outputs
  int4* s_in = s_short + kShortTab / 4 + (size_t)gid * A;
  int* s_f = reinterpret_cast<int*>(s_short + kShortTab / 4 +
                                    (size_t)kShortReads * A) +
             (size_t)gid * (kAux ? 4 : 2) * A;
  int* s_c = s_f + A;  // cnt (aux) or prev
  int* s_sq = kAux ? s_f + 2 * A : nullptr;
  int* s_sr = kAux ? s_f + 3 * A : nullptr;

  const size_t base = (size_t)b * A;
  int last = -1;
  for (int j = tid; j < A; j += kShortThreads) {
    const int gj = grp[base + j];
    s_in[j] = make_int4(gj, rpos[base + j], qpos[base + j], span[base + j]);
    if (gj != -1) last = j;
  }
  last = __reduce_max_sync(kFull, last);
  if (kShortWarps > 1) {
    // parity 0 here; row i uses parity (i + 1) & 1
    if (lane == 0) s_part[0][gid][warp][0] = last;
    group_sync(gid);
    for (int w = 0; w < kShortWarps; ++w) last = max(last, s_part[0][gid][w][0]);
  } else {
    __syncwarp();  // the slots written above, visible to the warp
  }
  const int n = last + 1;  // rows >= n are trailing padding

  const unsigned mn_u = (unsigned)min(mdx, mdy);
  const unsigned mdx_u = (unsigned)mdx;
  int f_last = 0, c_last = 0, q_last = 0, r_last = 0;
  // row i's scoring, done during row i - 1: the best (bo, jo) of the slots
  // j < i - 1 with f[j] added, and the score sn of slot i - 1 (kNegInf if
  // this thread does not hold it); row 0 has no slot
  int bo = kNegInf, jo = -1, sn = kNegInf;
  int4 me = s_in[0];
  for (int i = 0; i < n; ++i) {
    const int4 nx = s_in[min(i + 1, A - 1)];  // row i + 1, for its scoring
    const bool tn = sn != kNegInf && sn + f_last >= bo;
    int best = tn ? sn + f_last : bo;
    int jb = tn ? i - 1 : jo;
    const int wb = __reduce_max_sync(kFull, best);
    jb = __reduce_max_sync(kFull, best == wb ? jb : -1);
    best = wb;

    // row i + 1's scoring, while the reductions are in flight
    ShortRow<kSkip, kWide> row{nx, i, tid, bw, mn_u, mdx_u, pen_gap, pen_skip,
                               s_in, s_f, s_tab, log2tab};
    if (i + 1 < n) row.score(max(0, i + 1 - H));
    bo = row.bo;
    jo = row.jo;
    sn = row.sn;

    if (kShortWarps > 1) {
      const int par = (i + 1) & 1;
      if (lane == 0) {
        s_part[par][gid][warp][0] = best;
        s_part[par][gid][warp][1] = jb;
      }
      group_sync(gid);
      for (int w = 0; w < kShortWarps; ++w) {
        const int pb = s_part[par][gid][w][0];
        const int pj = s_part[par][gid][w][1];
        if (pb > best || (pb == best && pj > jb)) {
          best = pb;
          jb = pj;
        }
      }
    }
    // best > span[i] >= 0 only for an admissible winner
    const bool win = best > me.w;
    const int fi = win ? best : me.w;
    s_f[i] = fi;
    if (kAux) {
      int ci = 1, qsi = me.z, rsi = me.y;
      if (win && jb == i - 1) {
        ci = c_last + 1;
        qsi = q_last;
        rsi = r_last;
      } else if (win) {
        ci = s_c[jb] + 1;
        qsi = s_sq[jb];
        rsi = s_sr[jb];
      }
      s_c[i] = ci;
      s_sq[i] = qsi;
      s_sr[i] = rsi;
      c_last = ci;
      q_last = qsi;
      r_last = rsi;
    } else {
      s_c[i] = win ? jb : -1;
    }
    f_last = fi;
    me = nx;
  }

  // every thread wrote every row, and slot j >= n itself: no barrier
  int* fo = f + base;
  int* co = o1 + base;
  int* qo = kAux ? o2 + base : nullptr;
  int* ro = kAux ? o3 + base : nullptr;
  for (int j = tid; j < A; j += kShortThreads) {
    if (j < n) {
      fo[j] = s_f[j];
      co[j] = s_c[j];
      if (kAux) {
        qo[j] = s_sq[j];
        ro[j] = s_sr[j];
      }
    } else {
      const int4 s = s_in[j];
      fo[j] = s.w;
      co[j] = kAux ? 1 : -1;
      if (kAux) {
        qo[j] = s.z;
        ro[j] = s.y;
      }
    }
  }
}

// the short-read kernel's dynamic shared memory: the staged table, and a
// slot (4 words) and the outputs (4 aux, 2 (f, prev)) a row for each of
// the block's reads
template <bool kAux>
size_t short_smem_bytes(int A) {
  return (size_t)kShortTab * sizeof(float) +
         (size_t)kShortReads * A * (kAux ? 8 : 6) * sizeof(int);
}

template <bool kAux, bool kSkip, bool kWide>
int launch_short_as(const void* grp, const void* rpos, const void* qpos,
                    const void* span, void* f, void* o1, void* o2, void* o3,
                    const void* log2tab, int tab_len, int B, int A, int H,
                    int mdx, int mdy, int bw, float pen_gap, float pen_skip,
                    void* stream) {
  const size_t smem = short_smem_bytes<kAux>(A);
  // a block over the limit is refused here and raised by the caller
  const cudaError_t e = cudaFuncSetAttribute(
      chain_dp_short_kernel<kAux, kSkip, kWide>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (B + kShortReads - 1) / kShortReads;
  const int threads = kShortReads * kShortThreads;
  chain_dp_short_kernel<kAux, kSkip, kWide>
      <<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)grp, (const int*)rpos, (const int*)qpos, (const int*)span,
      (int*)f, (int*)o1, (int*)o2, (int*)o3, (const float*)log2tab, tab_len,
      B, A, H, mdx, mdy, bw, pen_gap, pen_skip);
  return (int)cudaGetLastError();
}

// picks the instance: pen_skip == 0 drops its term, bw < kShortTab the
// global table
template <bool kAux>
int launch_short(const void* grp, const void* rpos, const void* qpos,
                 const void* span, void* f, void* o1, void* o2, void* o3,
                 const void* log2tab, int tab_len, int B, int A, int H,
                 int mdx, int mdy, int bw, float pen_gap, float pen_skip,
                 void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaSuccess;
  const bool skip = pen_skip != 0.0f;
  const bool wide = bw >= kShortTab;
  auto* fn = skip ? (wide ? launch_short_as<kAux, true, true>
                          : launch_short_as<kAux, true, false>)
                  : (wide ? launch_short_as<kAux, false, true>
                          : launch_short_as<kAux, false, false>);
  return fn(grp, rpos, qpos, span, f, o1, o2, o3, log2tab, tab_len, B, A, H,
            mdx, mdy, bw, pen_gap, pen_skip, stream);
}

// ---- the pruned kernel (max_chain_skip, the read in shared memory) -----
//
// One warp (one block) per read. The read's four input columns, one int4 a
// slot, its f, prev and marks t, and for aux its cnt, sq and sr live in
// dynamic shared memory; the outputs are written, coalesced, after the
// walk. t stores i, so it needs no reset between rows.
//
// Row i walks its window [max(0, i-H), i) newest-first in chunks of 32
// slots, lane u taking j = top - u, and replaces the template's serial
// walk by warp scans:
//   1. each lane scores its slot (comput_sc, + f[j]; ok when admissible);
//   2. every ok lane with prev[j] >= 0 sets t[prev[j]] = i, then
//      __syncwarp. As prev[j] < j a mark reaches only slots the walk
//      visits after j, and marks set from slots past the break land past
//      it too, where nothing reads them (_skip_prune_mask's argument);
//   3. an ok lane is marked when t[j] == i;
//   4. beat = ok && sc > the running max before the lane (a shuffle
//      max-scan, seeded with the carried best, span[i] at first);
//   5. the skip counter is the max-plus composition of n -> max(n + a, b)
//      across the lanes, newest first, seeded with the carried counter:
//      a = +1 on a marked non-beat, a = -1 with b = 0 on a beat (the
//      floored decrement), else the identity; a shuffle scan of (a, b);
//   6. the break is the first lane whose counter passes max_skip (a
//      ballot); the chunk's winner is the newest lane before it that
//      holds the chunk's max, if that beats the carried best;
//   7. (best, jb, counter) carry into the next chunk; the row stops at
//      the break or the window's end.
// Two exact shortcuts (skip a chunk with no ok lane; count a chunk that
// cannot beat by a popcount) cost two warp votes a chunk: 10-12% slower
// on the CLI's shape, 3-4% faster at skipprune (prune_ab.py, PERF.md),
// so the kernel does without them.
// Every lane computes the row's outputs and writes them to shared memory
// itself (the same values), so each later read of f, prev, cnt, sq or sr
// is of the lane's own write; only the marks cross lanes, behind the
// __syncwarp of step 2.
//
// Admissibility is comput_sc's, with 64-bit differences and dr != 0, as in
// the plain version: the kernel depends on no anchor order. What bounds
// it: the latency of each chunk's chain (a slot load, the scoring, two
// warp scans of five shuffle steps, two ballots and a reduction); a row
// of the reference's default max_chain_skip mostly breaks within one or
// two chunks.
template <bool kAux>
__global__ void __launch_bounds__(32) chain_dp_prune_kernel(
    const int* __restrict__ grp, const int* __restrict__ rpos,
    const int* __restrict__ qpos, const int* __restrict__ span,
    int* __restrict__ f, int* __restrict__ o1, int* __restrict__ o2,
    int* __restrict__ o3, const float* __restrict__ log2tab, int tab_len,
    int A, int H, int mdx, int mdy, int bw, float pen_gap, float pen_skip,
    int max_skip) {
  extern __shared__ int4 s_prune[];
  int4* s_in = s_prune;
  int* s_f = reinterpret_cast<int*>(s_prune + A);
  int* s_pv = s_f + A;
  int* s_t = s_pv + A;
  int* s_c = kAux ? s_t + A : nullptr;
  int* s_sq = kAux ? s_t + 2 * A : nullptr;
  int* s_sr = kAux ? s_t + 3 * A : nullptr;

  const int lane = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * A;
  int last = -1;
  for (int j = lane; j < A; j += 32) {
    const int gj = grp[base + j];
    s_in[j] = make_int4(gj, rpos[base + j], qpos[base + j], span[base + j]);
    s_t[j] = -1;
    if (gj != -1) last = j;
  }
  const int n = __reduce_max_sync(kFull, last) + 1;  // rows >= n: padding
  __syncwarp();

  for (int i = 0; i < n; ++i) {
    const int4 me = s_in[i];
    const int lo = max(0, i - H);
    int best = me.w;  // the running max, seeded with span[i]
    int jb = -1;
    int skip = 0;
    for (int top = i - 1; top >= lo; top -= 32) {
      const int j = top - lane;
      int sc = kNegInf;
      bool ok = false;
      if (j >= lo) {
        const int4 s = s_in[j];
        int v;
        ok = s.x == me.x &&
             comput_sc(me.y, me.z, s.y, s.z, s.w, log2tab, tab_len, mdx, mdy,
                       bw, pen_gap, pen_skip, &v);
        if (ok) {
          sc = v + s_f[j];
          const int p = s_pv[j];
          if (p >= 0) s_t[p] = i;
        }
      }
      __syncwarp();
      const bool counted = ok && s_t[j] == i;  // a marked slot, unless it beats
      // the running max before each lane: an inclusive max-scan, shifted
      int run = sc;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(kFull, run, o);
        if (lane >= o) run = max(run, u);
      }
      const int before = __shfl_up_sync(kFull, run, 1);
      const bool beat = ok && sc > (lane == 0 ? best : max(best, before));
      // the skip counter: (a, b) of n -> max(n + a, b), composed with the
      // older lanes' map applied first
      int a = beat ? -1 : (counted ? 1 : 0);
      int bb = beat ? 0 : kNegInf;
      for (int o = 1; o < 32; o <<= 1) {
        const int ua = __shfl_up_sync(kFull, a, o);
        const int ub = __shfl_up_sync(kFull, bb, o);
        if (lane >= o) {
          bb = max(ub + a, bb);
          a += ua;
        }
      }
      const int counter = max(skip + a, bb);
      const unsigned over = __ballot_sync(kFull, counter > max_skip);
      const int brk = over ? __ffs(over) - 1 : 32;  // a marked non-beat
      const int cand = ok && lane < brk ? sc : kNegInf;
      const int m = __reduce_max_sync(kFull, cand);
      if (m > best) {
        best = m;
        jb = top - (__ffs(__ballot_sync(kFull, cand == m)) - 1);
      }
      if (over) break;
      skip = __shfl_sync(kFull, counter, 31);
    }
    const bool win = jb >= 0 && best > me.w;
    s_f[i] = win ? best : me.w;
    s_pv[i] = win ? jb : -1;
    if (kAux) {
      s_c[i] = win ? s_c[jb] + 1 : 1;
      s_sq[i] = win ? s_sq[jb] : me.z;
      s_sr[i] = win ? s_sr[jb] : me.y;
    }
  }

  // every lane wrote every row: no barrier
  int* fo = f + base;
  int* co = o1 + base;
  for (int j = lane; j < A; j += 32) {
    const int4 s = s_in[j];
    const bool in = j < n;
    fo[j] = in ? s_f[j] : s.w;
    if (kAux) {
      co[j] = in ? s_c[j] : 1;
      o2[base + j] = in ? s_sq[j] : s.z;
      o3[base + j] = in ? s_sr[j] : s.y;
    } else {
      co[j] = in ? s_pv[j] : -1;
    }
  }
}

// the pruned kernel's dynamic shared memory: a slot (4 words), f, prev and
// t, and for aux cnt, sq and sr, a row of the read
template <bool kAux>
size_t prune_smem_bytes(int A) {
  return (size_t)A * (kAux ? 10 : 7) * sizeof(int);
}

template <bool kAux>
int launch_prune(const void* grp, const void* rpos, const void* qpos,
                 const void* span, void* f, void* o1, void* o2, void* o3,
                 const void* log2tab, int tab_len, int B, int A, int H,
                 int mdx, int mdy, int bw, float pen_gap, float pen_skip,
                 int max_skip, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaSuccess;
  const size_t smem = prune_smem_bytes<kAux>(A);
  // a read over the limit is refused here and raised by the caller
  const cudaError_t e = cudaFuncSetAttribute(
      chain_dp_prune_kernel<kAux>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  chain_dp_prune_kernel<kAux><<<B, 32, smem, (cudaStream_t)stream>>>(
      (const int*)grp, (const int*)rpos, (const int*)qpos, (const int*)span,
      (int*)f, (int*)o1, (int*)o2, (int*)o3, (const float*)log2tab, tab_len,
      A, H, mdx, mdy, bw, pen_gap, pen_skip, max_skip);
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

// The block-per-read lane kernel: the same contracts as mm2t_chain_dp_aux
// and mm2t_chain_dp, for the exact window; its ring of (H + 512) slots
// must fit a block's shared memory (kernels/chain_dp.py picks it).
extern "C" int mm2t_chain_dp_aux_lane(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch_lane<true>(grp, rpos, qpos, span, f, cnt, sq, sr, log2tab,
                           tab_len, B, A, H, mdx, mdy, bw, pen_gap, pen_skip,
                           stream);
}

extern "C" int mm2t_chain_dp_lane(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* prev,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch_lane<false>(grp, rpos, qpos, span, f, prev, nullptr, nullptr,
                            log2tab, tab_len, B, A, H, mdx, mdy, bw, pen_gap,
                            pen_skip, stream);
}

// The short-read kernel: the same contracts as mm2t_chain_dp_aux and
// mm2t_chain_dp, for the exact window; its block of kShortReads whole
// reads must fit a block's shared memory (kernels/chain_dp.py picks it).
extern "C" int mm2t_chain_dp_aux_short(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch_short<true>(grp, rpos, qpos, span, f, cnt, sq, sr, log2tab,
                            tab_len, B, A, H, mdx, mdy, bw, pen_gap, pen_skip,
                            stream);
}

extern "C" int mm2t_chain_dp_short(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* prev,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch_short<false>(grp, rpos, qpos, span, f, prev, nullptr,
                             nullptr, log2tab, tab_len, B, A, H, mdx, mdy, bw,
                             pen_gap, pen_skip, stream);
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

// The pruned kernel with the read in shared memory: the same contracts as
// mm2t_chain_dp_aux_prune and mm2t_chain_dp_prune, with no scratch; its
// block of one read must fit a block's shared memory (kernels/chain_dp.py
// picks it).
extern "C" int mm2t_chain_dp_aux_prune_smem(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr, const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, int max_skip, void* stream) {
  return launch_prune<true>(grp, rpos, qpos, span, f, cnt, sq, sr, log2tab,
                            tab_len, B, A, H, mdx, mdy, bw, pen_gap, pen_skip,
                            max_skip, stream);
}

extern "C" int mm2t_chain_dp_prune_smem(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* prev, const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, int max_skip, void* stream) {
  return launch_prune<false>(grp, rpos, qpos, span, f, prev, nullptr, nullptr,
                             log2tab, tab_len, B, A, H, mdx, mdy, bw, pen_gap,
                             pen_skip, max_skip, stream);
}
