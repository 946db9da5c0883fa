// The reference's minimizer window scan (sketch.rs:80-99) for Hopper.
//
// Replaces the `lax.scan` of minimap2_rs_tpu/ops/sketch_scan.py
// (_window_scan, :109-241), the even-k sketch path. That scan is plain
// XLA on the TPU, not Pallas; as eager PyTorch it would take about 100
// small launches per position, so the port gives it this kernel.
//
// Contract (the plain version is ops/sketch_scan._window_scan_ref): for
// each read b, walk positions i < lengths[b] in order with the w-slot
// ring buffer of (key word, pos<<1|strand) and the tracked minimum:
//   * write position i into slot i mod w;
//   * when l == w+k-1 and the minimum is valid, emit every other slot
//     tied with it (sketch.rs:81-82);
//   * a word <= the minimum replaces it (emitting the old one when
//     l >= w+k); otherwise, when the minimum's slot was just overwritten,
//     emit it (l >= w+k-1), rescan the ring for the new minimum (ties to
//     the newest position) and emit the slots tied with that one;
//   * at the read's end the minimum is flushed if emit_final[b].
// Emissions set emitted[b][ps >> 1] = 1 directly (the wrapper zeroes it).
// Key words are compared as unsigned long long, so k = 28, where
// key << 8 | span reaches 2^64, is exact; an invalid position (ps ==
// 0xFFFFFFFF) enters the ring as all-ones, the JAX package's sentinel.
//
// Two designs, both kept callable (kernels/window_scan.py):
//
// Position-parallel (window_scan_tile_kernel, mm2t_window_scan_tile; the
// wrapper's kernel). The recurrence carries no state that a position
// cannot recompute. Let o[p] be position p's ordered word, all-ones for
// an invalid position and for p < 0 (a slot never written). After step
// i the tracked minimum is always the argmin of o over [i-w+1, i], ties
// to the newest position: a word <= the minimum is that argmin and the
// newest, and the rescan takes it by definition. So step i needs only
//   M- = argmin over [i-w, i-1] (the minimum before the step: its value
//        is the old minimum, and its slot is overwritten exactly when its
//        position is i-w, the slide),
//   M+ = argmin over [i-w+1, i] (the slide's new minimum),
// and x, y, l at i. Its emissions: at l == w+k-1 the positions of
// [i-w+1, i-1] equal to M- whose ps differs from M-'s; the old minimum on
// x <= M- at l >= w+k, or on a slide at l >= w+k-1; on a slide at
// l >= w+k-1 the positions of [i-w+1, i] equal to M+ whose ps differs;
// at i = n-1 the flush of M+. The byte stores commute, so the threads
// need no order.
//
// A 2-D grid of (tile of kScanTile positions, read); a block stages its
// tile's o and ps words, and a halo of w (rounded up to even) positions
// in front, in shared memory, with 16-byte loads of two positions where
// the row length is even and the columns aligned (else 8-byte ones),
// then each thread takes one
// position: the argmin over [i-w+1, i-1] in one pass (O(w) from shared
// memory; w < 256, the presets' w = 10), M- and M+ from it and the two
// ends, and the O(w) tie scans only at l == w+k-1 and at slides.
// Positions >= lengths[b] do nothing; a tile past the read's end exits.
// What bounds it: the bytes (20 a position in, one out) and, at
// w = 10, about 10 shared-memory compares a position; both far below the
// launch's fixed cost at the mapper's shapes (PERF.md has the times).
//
// Sequential (window_scan_kernel, mm2t_window_scan; the first design,
// kept so a run can time it beside the other): one thread per read walks
// the positions with the ring in a global scratch laid out [w][B]; bound
// by the latency of each step and by B threads of parallelism.
//
// ptxas -v for sm_90a (build log of an H100 run): the tiled kernel 32
// registers and 6,144 bytes of static shared memory, the sequential one
// 40 registers; both 0 bytes of stack and no spill stores or loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned long long kUMax = ~0ull;
constexpr unsigned int kInv = 0xFFFFFFFFu;
constexpr int kThreads = 32;

__global__ void window_scan_kernel(
    const long long* __restrict__ ks, const long long* __restrict__ ps,
    const int* __restrict__ l_eff, const int* __restrict__ lengths,
    const unsigned char* __restrict__ emit_final, unsigned char* emitted,
    unsigned long long* ring_x, unsigned int* ring_y,
    int B, int L, int w, int k) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const size_t base = (size_t)b * L;
  const long long* kr = ks + base;
  const long long* pr = ps + base;
  const int* lr = l_eff + base;
  unsigned char* er = emitted + base;
  unsigned long long* rx = ring_x + b;  // slot j at rx[j * B]
  unsigned int* ry = ring_y + b;
  for (int j = 0; j < w; ++j) {
    rx[(size_t)j * B] = kUMax;
    ry[(size_t)j * B] = kInv;
  }
  unsigned long long mn = kUMax;
  unsigned int mn_y = kInv;
  int min_pos = 0;
  const int wk = w + k - 1;
  const int n = lengths[b];
  int bp = 0;
  for (int i = 0; i < n; ++i) {
    const unsigned int y = (unsigned int)pr[i];
    const unsigned long long x = y != kInv ? (unsigned long long)kr[i] : kUMax;
    const int l = lr[i];
    rx[(size_t)bp * B] = x;
    ry[(size_t)bp * B] = y;
    const bool mn_valid = mn != kUMax;
    if (l == wk && mn_valid) {
      for (int j = 0; j < w; ++j) {
        if (j == bp) continue;
        const unsigned int yj = ry[(size_t)j * B];
        if (rx[(size_t)j * B] == mn && yj != mn_y) er[yj >> 1] = 1;
      }
    }
    if (x <= mn) {
      if (l >= wk + 1 && mn_valid) er[mn_y >> 1] = 1;
      mn = x;
      mn_y = y;
      min_pos = bp;
    } else if (bp == min_pos) {
      if (l >= wk && mn_valid) er[mn_y >> 1] = 1;
      // oldest slot first; <= lets the newest tie win
      int s = bp + 1 == w ? 0 : bp + 1;
      unsigned long long best = rx[(size_t)s * B];
      int bs = s;
      for (int a = 1; a < w; ++a) {
        s = s + 1 == w ? 0 : s + 1;
        const unsigned long long v = rx[(size_t)s * B];
        if (v <= best) {
          best = v;
          bs = s;
        }
      }
      const unsigned int by = ry[(size_t)bs * B];
      if (l >= wk && best != kUMax) {
        for (int j = 0; j < w; ++j) {
          const unsigned int yj = ry[(size_t)j * B];
          if (rx[(size_t)j * B] == best && yj != by) er[yj >> 1] = 1;
        }
      }
      mn = best;
      mn_y = by;
      min_pos = bs;
    }
    bp = bp + 1 == w ? 0 : bp + 1;
  }
  if (n > 0 && emit_final[b] && mn != kUMax) er[mn_y >> 1] = 1;
}

// ---- the position-parallel design ---------------------------------------
constexpr int kScanTile = 256;     // positions a block, one a thread
constexpr int kScanMaxHalo = 256;  // w < 256, rounded up to even

// staged words of position p of a row: (o, ps), all-ones for p < 0, p >= n
// and invalid positions
__device__ __forceinline__ void scan_word(long long k, long long p, bool in,
                                          unsigned long long* o,
                                          unsigned int* y) {
  const unsigned int yy = in ? (unsigned int)p : kInv;
  *y = yy;
  *o = yy != kInv ? (unsigned long long)k : kUMax;
}

// emit every position s in [s0, s1] of the staged tile whose word equals v
// and whose ps differs from vy
__device__ __forceinline__ void emit_ties(const unsigned long long* s_o,
                                          const unsigned int* s_y, int s0,
                                          int s1, unsigned long long v,
                                          unsigned int vy, unsigned char* er) {
  for (int s = s0; s <= s1; ++s)
    if (s_o[s] == v && s_y[s] != vy) er[s_y[s] >> 1] = 1;
}

__global__ void __launch_bounds__(kScanTile) window_scan_tile_kernel(
    const long long* __restrict__ ks, const long long* __restrict__ ps,
    const int* __restrict__ l_eff, const int* __restrict__ lengths,
    const unsigned char* __restrict__ emit_final, unsigned char* emitted,
    int L, int w, int k, bool vec) {
  __shared__ unsigned long long s_o[kScanTile + kScanMaxHalo];
  __shared__ unsigned int s_y[kScanTile + kScanMaxHalo];
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kScanTile;
  const int n = lengths[b];
  if (t0 >= n) return;  // the whole block: no position of the tile is read
  const int halo = (w + 1) & ~1;
  const int h0 = t0 - halo;  // staged slot s holds position h0 + s
  const int S = kScanTile + halo;
  const size_t base = (size_t)b * L;
  const long long* kr = ks + base;
  const long long* pr = ps + base;
  for (int s = 2 * threadIdx.x; s < S; s += 2 * kScanTile) {
    const int p = h0 + s;
    long long k0 = 0, k1 = 0, p0 = 0, p1 = 0;
    if (p >= 0 && p < n) {
      if (vec) {
        const longlong2 kk = *reinterpret_cast<const longlong2*>(kr + p);
        const longlong2 pp = *reinterpret_cast<const longlong2*>(pr + p);
        k0 = kk.x, k1 = kk.y, p0 = pp.x, p1 = pp.y;
      } else {
        k0 = kr[p], p0 = pr[p];
        if (p + 1 < n) k1 = kr[p + 1], p1 = pr[p + 1];
      }
    }
    scan_word(k0, p0, p >= 0 && p < n, &s_o[s], &s_y[s]);
    scan_word(k1, p1, p + 1 >= 0 && p + 1 < n, &s_o[s + 1], &s_y[s + 1]);
  }
  __syncthreads();

  const int i = t0 + threadIdx.x;
  if (i >= n) return;
  const int si = i - h0;  // >= halo >= w
  // C: the argmin over [i-w+1, i-1], the newest tie (none when w == 1)
  unsigned long long cv = kUMax;
  int cs = -1;
  for (int s = si - w + 1; s < si; ++s) {
    if (s_o[s] <= cv) {
      cv = s_o[s];
      cs = s;
    }
  }
  // M- over [i-w, i-1]: C unless the oldest is smaller (C is newer)
  const int mm = cs >= 0 && cv <= s_o[si - w] ? cs : si - w;
  // M+ over [i-w+1, i]: position i unless C is smaller (i is newest)
  const unsigned long long x = s_o[si];
  const int mp = cs >= 0 && cv < x ? cs : si;
  const unsigned long long mn = s_o[mm];
  const unsigned int mn_y = s_y[mm];
  const bool mn_valid = mn != kUMax;
  const int l = l_eff[base + i];
  const int wk = w + k - 1;
  unsigned char* er = emitted + base;
  if (l == wk && mn_valid) emit_ties(s_o, s_y, si - w + 1, si - 1, mn, mn_y, er);
  if (x <= mn) {
    if (l >= wk + 1 && mn_valid) er[mn_y >> 1] = 1;
  } else if (mm == si - w) {  // the minimum slid out of the window
    if (l >= wk && mn_valid) er[mn_y >> 1] = 1;
    if (l >= wk && s_o[mp] != kUMax)
      emit_ties(s_o, s_y, si - w + 1, si, s_o[mp], s_y[mp], er);
  }
  if (i == n - 1 && emit_final[b] && s_o[mp] != kUMax) er[s_y[mp] >> 1] = 1;
}

}  // namespace

// Both entries launch on `stream`, allocate nothing and do not
// synchronise; each returns cudaGetLastError() after the launch (0 when it
// was accepted).

// The sequential design. ring_x (w*B u64) and ring_y (w*B u32) are scratch
// the kernel fills.
extern "C" int mm2t_window_scan(
    const void* ks, const void* ps, const void* l_eff, const void* lengths,
    const void* emit_final, void* emitted, void* ring_x, void* ring_y,
    int B, int L, int w, int k, void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  const int blocks = (B + kThreads - 1) / kThreads;
  window_scan_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)ks, (const long long*)ps, (const int*)l_eff,
      (const int*)lengths, (const unsigned char*)emit_final,
      (unsigned char*)emitted, (unsigned long long*)ring_x,
      (unsigned int*)ring_y, B, L, w, k);
  return (int)cudaGetLastError();
}

// The position-parallel design: the same contract, no scratch. B is the
// grid's y: a launch with B > 65535 is refused.
extern "C" int mm2t_window_scan_tile(
    const void* ks, const void* ps, const void* l_eff, const void* lengths,
    const void* emit_final, void* emitted, int B, int L, int w, int k,
    void* stream) {
  if (B <= 0 || L <= 0) return (int)cudaSuccess;
  if (w < 1 || w > kScanMaxHalo - 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((L + kScanTile - 1) / kScanTile, B);
  // h0 is even, so with L even and ks, ps 16-byte aligned every pair of
  // positions the kernel stages is one 16-byte word
  const bool vec = (L & 1) == 0 && ((uintptr_t)ks | (uintptr_t)ps) % 16 == 0;
  window_scan_tile_kernel<<<grid, kScanTile, 0, (cudaStream_t)stream>>>(
      (const long long*)ks, (const long long*)ps, (const int*)l_eff,
      (const int*)lengths, (const unsigned char*)emit_final,
      (unsigned char*)emitted, L, w, k, vec);
  return (int)cudaGetLastError();
}
