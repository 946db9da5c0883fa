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
// Emissions set emitted[b][pos] = 1 directly (the wrapper zeroes it). Key
// words are compared as unsigned long long, so k = 28, where
// key << 8 | span reaches 2^64, is exact; an invalid position (ps ==
// 0xFFFFFFFF) enters the ring as all-ones, the JAX package's sentinel.
//
// Design: one thread per read; the recurrence is sequential in i. The
// ring is a global scratch laid out [w][B], so neighbouring threads,
// which step through the same slot index together (i mod w does not
// depend on the read), touch neighbouring words; every w < 256 that the
// reference accepts runs. What bounds it: the latency of each
// sequential step (a few dependent loads, and a w-slot rescan when the
// minimum slides out), not bandwidth. Parallelism is one thread per
// read, so blocks are one warp wide to spread a batch over the SMs.

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

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise;
// returns cudaGetLastError() after the launch (0 when it was accepted).
// ring_x (w*B u64) and ring_y (w*B u32) are scratch the kernel fills.
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
