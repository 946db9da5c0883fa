// Exact-window colinear chaining DP with per-chain statistics, for Hopper.
//
// Replaces the two Pallas kernels of the lite mapping path
// (minimap2_rs_tpu/ops/chain_pallas.py): _static_aux_kernel (A < 1024,
// full window) and _chain_aux_kernel_lane (A >= 1024, sliding window).
// Their split into sublane/lane layouts existed only for the TPU's VMEM
// and (8, 128) tiling; here ONE kernel with a runtime window H serves
// every shape.
//
// Contract (chain_dp_aux_batch, chain_ops.py:218-294): for anchor i of
// read b, the best f[j] + comput_sc(i, j) over admissible j in
// [max(0, i-H), i), ties to the largest j; if it does not beat span[i],
// f[i] = span[i], cnt = 1, sq/sr = own coordinates. Otherwise cnt, sq,
// sr follow the chosen predecessor (cnt + 1, its chain start).
//
// Design: one warp per read. The DP is sequential in i, so the warp
// walks i in order; its 32 lanes stride over the j window, each keeping
// its best (score, j), and a shuffle reduction picks the max score and
// then the largest j. Lane 0 writes row i; __syncwarp() orders that
// write before row i+1 reads it. The window is read from global memory
// (it stays L1/L2-resident): a long read at A ~ 12k needs 8 arrays x 4 B
// x A, more than a block's 227 KB of shared memory.
//
// What bounds it on this card: the latency of each sequential step (a
// window sweep, a 5-level shuffle reduction, a dependent load of the
// chosen predecessor's statistics) and the global-memory window reads,
// not FLOPs. Parallelism is one warp per read (1024 warps at the
// headline shape, one wave on 132 SMs).
//
// Exactness: the penalty is (int)(pen_gap*dd + pen_skip*dg
// + 0.5f*log2(dd+1)) in f32 with no FMA contraction (__fmul_rn /
// __fadd_rn), log2 read from a host-built table of the oracle's mg_log2
// (oracle/lchain.py:51-80). Differences are taken in 64-bit integers.
// Rows after a read's last valid anchor (grp == -1 padding, which the
// mapper places at the end with no admissible predecessor) take the
// base case directly, as the Pallas kernels' padding epilogue does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kWarpsPerBlock = 4;

__global__ void chain_dp_aux_kernel(
    const int* __restrict__ grp, const int* __restrict__ rpos,
    const int* __restrict__ qpos, const int* __restrict__ span,
    int* f, int* cnt, int* sq, int* sr,
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
  int* co = cnt + base;
  int* qo = sq + base;
  int* ro = sr + base;

  // rows >= n are trailing padding
  int last = -1;
  for (int j = lane; j < A; j += 32)
    if (g[j] != -1) last = j;
  for (int o = 16; o > 0; o >>= 1)
    last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
  const int n = last + 1;

  for (int i = lane + n; i < A; i += 32) {
    fo[i] = sp[i];
    co[i] = 1;
    qo[i] = qp[i];
    ro[i] = rp[i];
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
      if (jb >= 0 && best > si) {
        fo[i] = best;
        co[i] = co[jb] + 1;
        qo[i] = qo[jb];
        ro[i] = ro[jb];
      } else {
        fo[i] = si;
        co[i] = 1;
        qo[i] = (int)qi;
        ro[i] = (int)ri;
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Launches on `stream`, allocates nothing, does not synchronise; returns
// cudaGetLastError() after the launch (0 when the launch was accepted).
extern "C" int mm2t_chain_dp_aux(
    const void* grp, const void* rpos, const void* qpos, const void* span,
    void* f, void* cnt, void* sq, void* sr,
    const void* log2tab, int tab_len,
    int B, int A, int H, int mdx, int mdy, int bw,
    float pen_gap, float pen_skip, void* stream) {
  if (B <= 0 || A <= 0) return (int)cudaSuccess;
  const int threads = 32 * kWarpsPerBlock;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  chain_dp_aux_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)grp, (const int*)rpos, (const int*)qpos, (const int*)span,
      (int*)f, (int*)cnt, (int*)sq, (int*)sr,
      (const float*)log2tab, tab_len, B, A, H, mdx, mdy, bw,
      pen_gap, pen_skip);
  return (int)cudaGetLastError();
}
