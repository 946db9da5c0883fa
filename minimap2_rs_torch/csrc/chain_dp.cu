// Exact-window colinear chaining DP for Hopper, in two variants.
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
// ptxas -v for sm_90a (build log of an H100 run): chain_dp_kernel<false>
// uses 42 registers, chain_dp_kernel<true> 48; both 0 bytes of stack
// and no spill stores or loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kWarpsPerBlock = 4;

// kAux: (f, cnt, sq, sr). !kAux: (f, prev); o2 and o3 are unused.
template <bool kAux>
__global__ void chain_dp_kernel(
    const int* __restrict__ grp, const int* __restrict__ rpos,
    const int* __restrict__ qpos, const int* __restrict__ span,
    int* f, int* o1, int* o2, int* o3,
    const float* __restrict__ log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
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

  // rows >= n are trailing padding
  int last = -1;
  for (int j = lane; j < A; j += 32)
    if (g[j] != -1) last = j;
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
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

  for (int i = 0; i < n; ++i) {
    const int gi = g[i];
    const long long ri = rp[i];
    const long long qi = qp[i];
    const int si = sp[i];
    int best = kNegInf;
    int jb = -1;
    for (int j = max(0, i - H) + lane; j < i; j += 32) {
      if (g[j] != gi) continue;
      const long long dq = qi - qp[j];
      const long long dr = ri - rp[j];
      const long long dd = dr > dq ? dr - dq : dq - dr;
      if (dq <= 0 || dq > mdx || dq > mdy || dr == 0 || dr > mdx || dd > bw)
        continue;
      const long long dg = dr < dq ? dr : dq;
      const int sj = sp[j];
      int sc = (int)(sj < dg ? sj : dg);
      if (dd != 0 || dg > sj) {
        const int t = (int)(dd < tab_len - 1 ? dd : tab_len - 1);
        const float lin = __fadd_rn(__fmul_rn(pen_gap, (float)dd),
                                    __fmul_rn(pen_skip, (float)dg));
        sc -= __float2int_rz(__fadd_rn(lin, __fmul_rn(0.5f, log2tab[t])));
      }
      sc += fo[j];
      // j ascends per lane, so >= keeps this lane's largest tied j
      if (sc >= best) {
        best = sc;
        jb = j;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oj = __shfl_xor_sync(0xffffffffu, jb, o);
      if (ob > best || (ob == best && oj > jb)) {
        best = ob;
        jb = oj;
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
    }
    __syncwarp();
  }
}

template <bool kAux>
int launch(const void* grp, const void* rpos, const void* qpos,
           const void* span, void* f, void* o1, void* o2, void* o3,
           const void* log2tab, int tab_len, int B, int A, int H, int mdx,
           int mdy, int bw, float pen_gap, float pen_skip, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaSuccess;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_dp_kernel<kAux><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)grp, (const int*)rpos, (const int*)qpos, (const int*)span,
      (int*)f, (int*)o1, (int*)o2, (int*)o3,
      (const float*)log2tab, tab_len, B, A, H, mdx, mdy, bw,
      pen_gap, pen_skip);
  return (int)cudaGetLastError();
}

}  // namespace

// Both entry points launch on `stream`, allocate nothing and do not
// synchronise; each returns cudaGetLastError() after the launch (0 when
// the launch was accepted).
extern "C" int mm2t_chain_dp_aux(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch<true>(grp, rpos, qpos, span, f, cnt, sq, sr, log2tab,
                      tab_len, B, A, H, mdx, mdy, bw, pen_gap, pen_skip,
                      stream);
}

extern "C" int mm2t_chain_dp(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* prev,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  return launch<false>(grp, rpos, qpos, span, f, prev, nullptr, nullptr,
                       log2tab, tab_len, B, A, H, mdx, mdy, bw, pen_gap,
                       pen_skip, stream);
}
