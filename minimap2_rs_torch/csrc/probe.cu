// The prefix probe of the device index for Hopper (mm2t_probe_prefix):
// each query key's occurrence block, read from its own bucket's rows of
// the key table alone.
//
// Replaces the body of the prefix-probe branch of the index lookup
// (ops/index_ops.py prefix_probe, which stays as the plain version and the
// CPU path). That branch gathers the S = bucket_slots consecutive rows of
// kv from each key's bucket base, compares all S as int32 words and
// reduces them (argmax, any): at S 128, the layout of a human-sized index
// at k 19, a 2 KB window gathered and written a slot, read back by the
// compares, a (..., S) bool written and reduced twice. A key can only be
// in its own bucket, kv[prefix[p] : prefix[p + 1]], and a bucket's rows
// ascend (the index's keys are sorted), so this kernel reads those rows
// and stops at the hit.
//
// Contract (kernels/probe.py runs the plain version on CPU tensors): for
// each of the n slots of sks (int64 key_span words) and keep (bools),
//   q = keep ? (sks >> 8) & (2^56 - 1) : 0        (ops/seeds_ops.lookup_keys)
//   p = min(q >> shift, n_prefix - 2)
//   start, count = words 2 and 3 of the row of [prefix[p], prefix[p + 1])
//     whose words 0 and 1 are q's high and low 32 bits, as uint32 values;
//     0 and 0 when no row is.
// The plain branch compares the S rows from prefix[p]. A key's row lies in
// its own bucket, which holds at most S rows, and the sentinel rows past
// the keys match no 56-bit q, so both give the same (start, count) for
// every q: padding and filtered slots (q = 0) included. The kernel reads
// each bucket's own count from `prefix`, so one build serves every S.
//
// Design: one thread a query, a binary search of its bucket's rows for
// the first key not below q, which stops early at q.
//
// What bounds it on this card: the latency of random reads, not their
// bytes. A query reads its bucket's two prefix entries (one sector) and
// about log2 of its bucket's rows, 5-6 dependent sectors at 30-40 rows
// (chm13-hifi's buckets hold 8.4 keys on average, but minimizers and the
// index's keys crowd the same low buckets); the padding slots all search
// bucket 0, which stays in L2. A thread a query keeps 32 independent
// searches in flight a warp and issues no instruction for another lane's
// row.
//
// The design was chosen by an A/B on the inputs of one chm13-hifi pool
// call (T2T-CHM13's lengths at k 19: 562,532,551 keys, S 128, shift 12;
// 8 batch shapes, 10 batches; NVIDIA H100 80GB HBM3 at 700 W; CUDA events
// around 10 back-to-back launches, the better of two turns of a median of
// 5; every design equal to the plain branch on every shape) against a
// group of G lanes a query: each lane loads one whole 16-byte row, a warp
// ballot masked to the group finds the hit, and the group steps G rows at
// a time until the hit, the first key above q or the bucket's end. The
// group moves a row per lane and step, 128 bytes a step at G = 8, and
// repeats the key's set-up in every lane:
//   design             (896, 2816) ms   the call's 10 batches, ms
//   binary search      0.2572           1.456
//   G = 4              0.3728           2.111
//   G = 8              0.3557           2.045
//   G = 16             0.4258           2.502
//   G = 32             0.6251           3.800
// The plain branch took 11.1532 ms at (896, 2816); the bound there is
// 0.0163 ms (its 1.70 M query keys of 2,523,136 slots, one 32-byte sector
// each at 3.35 TB/s).
//
// ptxas -v for sm_90a (H100 run): 20 registers, 0 bytes of stack, no
// spill stores or loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kProbeThreads = 256;  // a block
constexpr unsigned long long kKeyMask = (1ull << 56) - 1;

__device__ __forceinline__ bool key_below(unsigned hi, unsigned lo, unsigned qhi,
                                          unsigned qlo) {
  return hi < qhi || (hi == qhi && lo < qlo);
}

__global__ void __launch_bounds__(kProbeThreads) probe_prefix_kernel(
    const long long* __restrict__ sks, const unsigned char* __restrict__ keep, long long n,
    const int* __restrict__ prefix, int n_prefix, const int4* __restrict__ kv, int shift,
    long long* __restrict__ start, long long* __restrict__ count) {
  const long long slot = (long long)blockIdx.x * kProbeThreads + threadIdx.x;
  if (slot >= n) return;
  unsigned long long q = 0;
  if (keep[slot]) q = ((unsigned long long)sks[slot] >> 8) & kKeyMask;
  const unsigned long long p = q >> shift;
  const int b = p > (unsigned long long)(n_prefix - 2) ? n_prefix - 2 : (int)p;
  const unsigned qhi = (unsigned)(q >> 32), qlo = (unsigned)q;
  unsigned s = 0, c = 0;  // the hit row's words 2 and 3 (0 without a hit)
  // the first row whose key is not below q, if it is q's
  int a = __ldg(prefix + b), e = __ldg(prefix + b + 1);
  while (a < e) {
    const int m = a + ((e - a) >> 1);
    const int4 row = __ldg(kv + m);
    if (key_below((unsigned)row.x, (unsigned)row.y, qhi, qlo)) {
      a = m + 1;
    } else {
      e = m;
      if ((unsigned)row.x == qhi && (unsigned)row.y == qlo) {
        s = (unsigned)row.z;
        c = (unsigned)row.w;
        break;
      }
    }
  }
  start[slot] = (long long)s;
  count[slot] = (long long)c;
}

}  // namespace

// Launches on `stream`, allocates nothing and does not synchronise; returns
// cudaGetLastError() after the launch (0 when it was accepted). sks (n
// int64), keep (n bytes), start and count (n int64 each); prefix (n_prefix
// int32, n_prefix >= 2); kv the (rows, 4) int32 key table, 16-byte
// aligned. Every slot of start and count is written.
extern "C" int mm2t_probe_prefix(const void* sks, const void* keep, long long n,
                                 const void* prefix, int n_prefix, const void* kv,
                                 int shift, void* start, void* count, void* stream) {
  if (n < 0 || n_prefix < 2 || shift < 0 || shift > 63 ||
      ((uintptr_t)kv & 15) != 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const long long blocks = (n + kProbeThreads - 1) / kProbeThreads;
  if (blocks > 0x7FFFFFFFll) return (int)cudaErrorInvalidValue;
  probe_prefix_kernel<<<(unsigned)blocks, kProbeThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)sks, (const unsigned char*)keep, n, (const int*)prefix, n_prefix,
      (const int4*)kv, shift, (long long*)start, (long long*)count);
  return (int)cudaGetLastError();
}
