// The mapper's query sketch at odd k for Hopper: one batch's H2D wire in,
// the compacted minimizers out (mm2t_sketch_minimizers).
//
// Replaces the XLA elementwise sketch of minimap2_rs_tpu/ops/sketch.py
// (sketch_positions, its odd-k window-minimum characterization) with the
// wire unpack before it (models/stages.py unpack_codes2 / unpack_codes4)
// and the compaction after it (compact_minimizers); none of them is a
// Pallas kernel. Carried over op by op into PyTorch they are about a
// hundred int64 passes over the padded (B, L) rows, each a full read and
// write of device memory.
//
// Contract (the plain version is that chain, run by kernels/sketch.py on
// CPU tensors): for each read b of length n = lengths[b] <= L,
//   cks[b] (M int64): key << 8 | k of the emitted minimizers in position
//     order, the first M kept, then KS_INVALID (2^63 - 1);
//   cps[b] (M int64): pos << 1 | strand beside them, then 0xFFFFFFFF;
//   n_mini[b] = min(emitted, M); mini_ovf[b] = emitted > M;
// bit for bit, including the run-end drops, the completion-step ties and
// the final flush (sketch.rs:29-100). The wire is one of
//   2-bit: (B, L/4) bytes of 4 codes, position p at bits 2(p & 3) of byte
//     p >> 2, with the batch's N bases in `nex`, the flat positions
//     b * L + p in increasing order (as the host encoder writes them),
//     padded with B * L;
//   4-bit: (B, L/2) bytes of 2 nt4 codes, a code >= 4 is no base;
//   nt4: (B, L) int32 codes, a code >= 4 is no base.
// Positions >= n are no base on every wire.
//
// Why the window alone decides. At odd k no k-mer is its own reverse
// complement, so the reference's l counter is the number of bases since
// the last N or the read's start, and a position's word is valid when
// l >= k. The emissions are then those of the window recurrence that
// csrc/window_scan.cu's tiled kernel computes position by position (its
// header gives the argument): step e needs the words of [e-w, e] and
// l at e, and emits only positions in [e-w, e]. So position j is emitted,
// or not, by the steps e in [j, j+w]; a word needs the k bases up to it;
// l needs the w+k positions before it.
//
// Design: one block per read walks the read's tiles of kSketchTile
// positions in order, carrying the count of minimizers its earlier tiles
// emitted, which is the output slot of the tile's first one. A tile
//   1. stages the 2-bit codes and the no-base flags of positions
//      [t0 - 2w - k, t0 + T + w) in shared memory, 32 a warp step by
//      ballots (each lane decodes its position from the wire), and sets
//      the flags of the read's Ns on the 2-bit wire (a binary search of
//      the read's part of `nex`);
//   2. computes the words of [t0 - w, t0 + T + w) in registers: l from
//      the flags (count leading zeros), the k-mer as one funnel-shifted
//      window of the 2-bit words (reverse complement by a complement,
//      forward by a bit reversal), hash64, key << 8 | k and pos << 1 |
//      strand, into shared memory;
//   3. runs the steps e in [t0, t0 + T + w) (window_scan_tile_kernel's
//      rules), setting a shared flag for each emitted position of the
//      tile;
//   4. compacts the tile's flags with a block-wide prefix sum and writes
//      the emitted words to their slots (those below M).
// The halos are computed again by each tile (2w + k words and w steps per
// T positions). After the last tile the block writes the padding,
// n_mini and mini_ovf. One block per read, rather than a count pass and a
// write pass over a 2-D grid: one launch, no scratch and no second
// reading of the wire, and the mapper's batches hold 128-1024 reads,
// enough blocks to fill the card; a read's tiles run one after another,
// so a batch takes about as long as its longest read's tiles.
//
// What bounds it on this card: not the bytes (the wire's 0.25 B a
// position in, 16 B a minimizer slot out, about 4 B a position at the
// mapper's M = 0.22 L) but the integer work of about 125 operations a
// position at w = 10 (sketch_ops_per_position in utils/measure.py), much
// of it 64-bit, and the latency of each tile's dependent phases between the
// block's barriers (six a tile), which the few blocks an SM holds hide
// only in part; PERF.md has the times beside the bound.
//
// ptxas -v for sm_90a (build log of an H100 run): 40 registers, 23,236
// bytes of static shared memory, 0 bytes of stack, no spill stores or
// loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kUMax = ~0ull;
constexpr unsigned int kInv = 0xFFFFFFFFu;
constexpr long long kKsInvalid = 0x7FFFFFFFFFFFFFFFll;
constexpr int kSketchThreads = 256;  // a block, one read
constexpr int kSketchTile = 1024;    // positions a tile
constexpr int kMaxW = 255;
constexpr int kMaxK = 27;
constexpr int kPer = kSketchTile / kSketchThreads;  // tile positions a thread compacts
constexpr int kWarps = kSketchThreads / 32;
// staged positions, [t0 - 2w - k, t0 + T + w) rounded up to 32
constexpr int kStageMax = (2 * kMaxW + kMaxK + kSketchTile + kMaxW + 31) / 32 * 32;
constexpr int kStageWords = kStageMax / 32;
// the words of [t0 - w, t0 + T + w)
constexpr int kWordMax = kSketchTile + 2 * kMaxW;
static_assert(kSketchTile % kSketchThreads == 0 && kSketchThreads % 32 == 0,
              "a tile splits evenly over whole warps");

enum Wire { kWire2 = 0, kWire4 = 1, kWireNt4 = 2 };

// bit i of x to bit 2i
__device__ __forceinline__ unsigned long long spread(unsigned int x) {
  unsigned long long v = x;
  v = (v | v << 16) & 0x0000FFFF0000FFFFull;
  v = (v | v << 8) & 0x00FF00FF00FF00FFull;
  v = (v | v << 4) & 0x0F0F0F0F0F0F0F0Full;
  v = (v | v << 2) & 0x3333333333333333ull;
  v = (v | v << 1) & 0x5555555555555555ull;
  return v;
}

// hash64 (sketch.rs:4-13) on the low 2k bits
__device__ __forceinline__ unsigned long long hash64(unsigned long long key,
                                                     unsigned long long mask) {
  key = (~key + (key << 21)) & mask;
  key = key ^ key >> 24;
  key = ((key + (key << 3)) + (key << 8)) & mask;
  key = key ^ key >> 14;
  key = ((key + (key << 2)) + (key << 4)) & mask;
  key = key ^ key >> 28;
  key = (key + (key << 31)) & mask;
  return key;
}

// the code of position p (0 <= p < L) of row b on the wire; >= 4: no base
__device__ __forceinline__ unsigned int wire_code(const void* rows, int wire,
                                                  int b, int L, int p) {
  if (wire == kWire2) {
    const unsigned char* r = (const unsigned char*)rows + (size_t)b * (L >> 2);
    return (r[p >> 2] >> (2 * (p & 3))) & 3u;
  }
  if (wire == kWire4) {
    const unsigned char* r = (const unsigned char*)rows + (size_t)b * (L >> 1);
    return (r[p >> 1] >> (4 * (p & 1))) & 15u;
  }
  return (unsigned int)((const int*)rows)[(size_t)b * L + p];
}

// the first index of a[lo, hi) (ascending) whose value is >= v
__device__ __forceinline__ int lower_bound(const int* a, int lo, int hi, long long v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// bases from the last no-base slot at or before s to s, at most cap; the
// staged slots hold at least cap positions before s
__device__ __forceinline__ int bases_since_n(const unsigned int* s_n, int s, int cap) {
  for (int q = s >> 5;; --q) {
    unsigned int m = s_n[q];
    if (q == s >> 5) m &= 0xFFFFFFFFu >> (31 - (s & 31));
    if (m) return min(s - (32 * q + 31 - __clz((int)m)), cap);
    if (q == 0 || s - 32 * q >= cap) return cap;
  }
}

__global__ void __launch_bounds__(kSketchThreads) sketch_minimizers_kernel(
    const void* __restrict__ rows, int wire, const int* __restrict__ lengths,
    const int* __restrict__ nex, int n_nex, long long* __restrict__ cks,
    long long* __restrict__ cps, int* __restrict__ n_mini,
    unsigned char* __restrict__ mini_ovf, int L, int w, int k, int M) {
  __shared__ unsigned long long s_code[kStageWords + 1];  // 2-bit codes, 32 a word
  __shared__ unsigned int s_n[kStageWords];               // no-base flags
  __shared__ unsigned long long s_o[kWordMax];            // key << 8 | k, or all ones
  __shared__ unsigned int s_y[kWordMax];                  // pos << 1 | strand
  __shared__ unsigned short s_l[kWordMax];                // l, at most w + k
  __shared__ unsigned char s_em[kSketchTile];             // emitted, by tile slot
  __shared__ int s_warp[kWarps];
  __shared__ int s_nex[2];

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = lengths[b];
  const long long bL = (long long)b * L;
  const int wk = w + k - 1;
  const int front = 2 * w + k;  // staged positions before the tile
  const int nw = (front + kSketchTile + w + 31) >> 5;
  const int nwords = kSketchTile + 2 * w;
  const unsigned long long kmask = (1ull << (2 * k)) - 1;
  if (tid == 0) {  // the read's Ns: nex[lo, hi)
    const int lo = wire == kWire2 ? lower_bound(nex, 0, n_nex, bL) : 0;
    s_nex[0] = lo;
    s_nex[1] = wire == kWire2 ? lower_bound(nex, lo, n_nex, bL + n) : 0;
  }

  int offset = 0;  // minimizers the read's earlier tiles emitted
  for (int t0 = 0; t0 < n; t0 += kSketchTile) {
    const int P0 = t0 - front;  // staged slot s holds position P0 + s
    // 1. the codes and no-base flags, a warp's 32 positions at a time
    for (int q = warp; q < nw; q += kWarps) {
      const int p = P0 + 32 * q + lane;
      const unsigned int c = p >= 0 && p < n ? wire_code(rows, wire, b, L, p) : 4u;
      const unsigned int lo = __ballot_sync(0xFFFFFFFFu, c & 1u);
      const unsigned int hi = __ballot_sync(0xFFFFFFFFu, (c >> 1) & 1u);
      const unsigned int nb = __ballot_sync(0xFFFFFFFFu, c >= 4u);
      if (lane == 0) {
        s_code[q] = spread(lo) | spread(hi) << 1;
        s_n[q] = nb;
      }
    }
    if (tid == 0) s_code[nw] = 0;  // a k-mer's second word past the last
    for (int i = tid; i < kSketchTile; i += kSketchThreads) s_em[i] = 0;
    __syncthreads();
    if (wire == kWire2 && s_nex[0] < s_nex[1]) {
      const int hi = s_nex[1];
      for (int j = lower_bound(nex, s_nex[0], hi, bL + P0) + tid; j < hi;
           j += kSketchThreads) {
        const long long v = nex[j] - bL - P0;
        if (v >= 32 * nw) break;
        atomicOr(&s_n[v >> 5], 1u << (v & 31));
      }
      __syncthreads();
    }

    // 2. the words of [t0 - w, t0 + T + w)
    for (int u = tid; u < nwords; u += kSketchThreads) {
      const int s = u + front - w;  // its staged slot
      const int l = bases_since_n(s_n, s, w + k);
      unsigned long long o = kUMax;
      unsigned int y = kInv;
      if (l >= k) {
        const int a = 2 * (s - k + 1);  // the bit of the k-mer's first base
        unsigned long long win = s_code[a >> 6] >> (a & 63);
        if (a & 63) win |= s_code[(a >> 6) + 1] << (64 - (a & 63));
        win &= kmask;  // the first base in the low bits
        const unsigned long long rev = win ^ kmask;
        unsigned long long fwd = __brevll(win);
        fwd = ((fwd >> 1) & 0x5555555555555555ull) | ((fwd & 0x5555555555555555ull) << 1);
        fwd >>= 64 - 2 * k;
        const bool strand = rev < fwd;
        o = hash64(strand ? rev : fwd, kmask) << 8 | (unsigned long long)k;
        y = (unsigned int)(t0 - w + u) << 1 | (unsigned int)strand;
      }
      s_o[u] = o;
      s_y[u] = y;
      s_l[u] = (unsigned short)l;
    }
    __syncthreads();

    // 3. the steps e in [t0, t0 + T + w); word u is position t0 - w + u,
    // tile slot u - w
    const int e_end = min(t0 + kSketchTile + w, n);
    for (int e = t0 + tid; e < e_end; e += kSketchThreads) {
      const int si = e - t0 + w;
      // C: the argmin over [e-w+1, e-1], the newest tie (none when w == 1)
      unsigned long long cv = kUMax;
      int cs = -1;
      for (int s = si - w + 1; s < si; ++s) {
        if (s_o[s] <= cv) {
          cv = s_o[s];
          cs = s;
        }
      }
      // M- over [e-w, e-1] (the minimum before the step), M+ over [e-w+1, e]
      const int mm = cs >= 0 && cv <= s_o[si - w] ? cs : si - w;
      const unsigned long long x = s_o[si];
      const int mp = cs >= 0 && cv < x ? cs : si;
      const unsigned long long mn = s_o[mm];
      const bool mn_valid = mn != kUMax;
      const int l = s_l[si];
      if (l == wk && mn_valid) {
        for (int s = si - w + 1; s < si; ++s)
          if (s_o[s] == mn && s_y[s] != s_y[mm] && s >= w && s - w < kSketchTile)
            s_em[s - w] = 1;
      }
      int one = -1;  // the old minimum, when this step emits it
      if (x <= mn) {
        if (l >= wk + 1 && mn_valid) one = mm;
      } else if (mm == si - w) {  // the minimum slid out of the window
        if (l >= wk && mn_valid) one = mm;
        if (l >= wk && s_o[mp] != kUMax) {
          for (int s = si - w + 1; s <= si; ++s)
            if (s_o[s] == s_o[mp] && s_y[s] != s_y[mp] && s >= w && s - w < kSketchTile)
              s_em[s - w] = 1;
        }
      }
      if (one >= w && one - w < kSketchTile) s_em[one - w] = 1;
      // the final flush at the read's end (sketch.rs:99)
      if (e == n - 1 && s_o[mp] != kUMax && mp >= w && mp - w < kSketchTile)
        s_em[mp - w] = 1;
    }
    __syncthreads();

    // 4. compaction: thread tid holds tile slots [kPer tid, kPer (tid + 1))
    const int base = tid * kPer;
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) cnt += s_em[base + j];
    int incl = cnt;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int v = s_warp[i];
      before += i < warp ? v : 0;
      total += v;
    }
    int slot = offset + before + incl - cnt;
    for (int j = 0; j < kPer; ++j) {
      if (!s_em[base + j]) continue;
      if (slot < M) {
        const size_t at = (size_t)b * M + slot;
        cks[at] = (long long)s_o[base + j + w];
        cps[at] = (long long)s_y[base + j + w];
      }
      ++slot;
    }
    offset += total;
    __syncthreads();
  }

  const int kept = min(offset, M);
  for (int j = kept + tid; j < M; j += kSketchThreads) {
    const size_t at = (size_t)b * M + j;
    cks[at] = kKsInvalid;
    cps[at] = (long long)kInv;
  }
  if (tid == 0) {
    n_mini[b] = kept;
    mini_ovf[b] = offset > M;
  }
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise; returns
// cudaGetLastError() after the launch (0 when it was accepted).
// wire: 0 the 2-bit rows with nex[n_nex], 1 the 4-bit rows, 2 int32 codes.
// Every slot of cks, cps, n_mini and mini_ovf is written.
extern "C" int mm2t_sketch_minimizers(
    const void* rows, int wire, const void* lengths, const void* nex, int n_nex,
    void* cks, void* cps, void* n_mini, void* mini_ovf, int B, int L, int w, int k,
    int M, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (w < 1 || w > kMaxW || k < 1 || k > kMaxK || (k & 1) == 0 || M < 0 || L < 0 ||
      wire < kWire2 || wire > kWireNt4 || n_nex < 0)
    return (int)cudaErrorInvalidValue;
  sketch_minimizers_kernel<<<B, kSketchThreads, 0, (cudaStream_t)stream>>>(
      rows, wire, (const int*)lengths, (const int*)nex, n_nex, (long long*)cks,
      (long long*)cps, (int*)n_mini, (unsigned char*)mini_ovf, L, w, k, M);
  return (int)cudaGetLastError();
}
