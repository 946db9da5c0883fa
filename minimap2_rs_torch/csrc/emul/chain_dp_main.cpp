// Runs entry points of csrc/chain_dp.cu, built against cuda_emul.h, on the
// CPU:
//
//   chain_dp_emul IN OUT ENTRY...
//
// IN holds int32 [B, A, H, max_dist_x, max_dist_y, bw, tab_len, max_skip],
// float32 [pen_gap, pen_skip], the (B, A) int32 columns grp, rpos, qpos
// and span, then the float32 log2 table of tab_len entries. For each ENTRY
// (e.g. mm2t_chain_dp_aux_short or mm2t_chain_dp_aux_lane), in order, OUT
// gets its int32 return code and then its (B, A) int32 outputs: four for
// the aux entries (f, cnt, sq, sr), two for the others (f, prev). The pruned entries get max_skip, and
// the template's pruned entries their scratch as well.
#include <cstdio>
#include <cstring>
#include <vector>

using cp = const void*;
using vp = void*;
#define SCALARS int, int, int, int, int, int, float, float
using Exact2 = int (*)(cp, cp, cp, cp, vp, vp, cp, int, SCALARS, vp);
using Exact4 = int (*)(cp, cp, cp, cp, vp, vp, vp, vp, cp, int, SCALARS, vp);
using Prune2 = int (*)(cp, cp, cp, cp, vp, vp, cp, int, SCALARS, int, vp);
using Prune3 = int (*)(cp, cp, cp, cp, vp, vp, vp, cp, int, SCALARS, int, vp);
using Prune4 = int (*)(cp, cp, cp, cp, vp, vp, vp, vp, cp, int, SCALARS, int, vp);
using Prune6 = int (*)(cp, cp, cp, cp, vp, vp, vp, vp, vp, vp, cp, int, SCALARS,
                       int, vp);

extern "C" {
int mm2t_chain_dp_aux(cp, cp, cp, cp, vp, vp, vp, vp, cp, int, SCALARS, vp);
int mm2t_chain_dp_aux_short(cp, cp, cp, cp, vp, vp, vp, vp, cp, int, SCALARS, vp);
int mm2t_chain_dp(cp, cp, cp, cp, vp, vp, cp, int, SCALARS, vp);
int mm2t_chain_dp_short(cp, cp, cp, cp, vp, vp, cp, int, SCALARS, vp);
int mm2t_chain_dp_aux_lane(cp, cp, cp, cp, vp, vp, vp, vp, cp, int, SCALARS, vp);
int mm2t_chain_dp_lane(cp, cp, cp, cp, vp, vp, cp, int, SCALARS, vp);
int mm2t_chain_dp_aux_prune(cp, cp, cp, cp, vp, vp, vp, vp, vp, vp, cp, int, SCALARS,
                            int, vp);
int mm2t_chain_dp_prune(cp, cp, cp, cp, vp, vp, vp, cp, int, SCALARS, int, vp);
int mm2t_chain_dp_aux_prune_smem(cp, cp, cp, cp, vp, vp, vp, vp, cp, int, SCALARS,
                                 int, vp);
int mm2t_chain_dp_prune_smem(cp, cp, cp, cp, vp, vp, cp, int, SCALARS, int, vp);
}

namespace {

struct Named {
  const char* name;
  int n_out, n_scratch;  // (B, A) outputs, then scratch arrays
  bool prune;
  void* fn;
};
const Named kEntries[] = {
    {"mm2t_chain_dp_aux", 4, 0, false, (void*)mm2t_chain_dp_aux},
    {"mm2t_chain_dp_aux_short", 4, 0, false, (void*)mm2t_chain_dp_aux_short},
    {"mm2t_chain_dp", 2, 0, false, (void*)mm2t_chain_dp},
    {"mm2t_chain_dp_short", 2, 0, false, (void*)mm2t_chain_dp_short},
    {"mm2t_chain_dp_aux_lane", 4, 0, false, (void*)mm2t_chain_dp_aux_lane},
    {"mm2t_chain_dp_lane", 2, 0, false, (void*)mm2t_chain_dp_lane},
    {"mm2t_chain_dp_aux_prune", 4, 2, true, (void*)mm2t_chain_dp_aux_prune},
    {"mm2t_chain_dp_prune", 2, 1, true, (void*)mm2t_chain_dp_prune},
    {"mm2t_chain_dp_aux_prune_smem", 4, 0, true, (void*)mm2t_chain_dp_aux_prune_smem},
    {"mm2t_chain_dp_prune_smem", 2, 0, true, (void*)mm2t_chain_dp_prune_smem},
};

template <class T>
bool read_into(FILE* in, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), in) == v.size();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s IN OUT ENTRY...\n", argv[0]);
    return 2;
  }
  FILE* in = std::fopen(argv[1], "rb");
  if (!in) return 2;
  std::vector<int> hdr(8);
  std::vector<float> pens(2);
  if (!read_into(in, hdr) || !read_into(in, pens)) return 2;
  const int B = hdr[0], A = hdr[1], H = hdr[2], tab_len = hdr[6], skip = hdr[7];
  const size_t n = (size_t)B * A;
  std::vector<std::vector<int>> cols(4, std::vector<int>(n));
  std::vector<float> tab(tab_len);
  for (auto& c : cols)
    if (!read_into(in, c)) return 2;
  if (!read_into(in, tab)) return 2;
  std::fclose(in);

  FILE* out = std::fopen(argv[2], "wb");
  if (!out) return 2;
  for (int a = 3; a < argc; ++a) {
    const Named* e = nullptr;
    for (const Named& k : kEntries)
      if (std::strcmp(k.name, argv[a]) == 0) e = &k;
    if (!e) {
      std::fprintf(stderr, "unknown entry %s\n", argv[a]);
      return 2;
    }
    std::vector<std::vector<int>> o(e->n_out + e->n_scratch,
                                    std::vector<int>(n, 0x7eadbeef));
    const void *g = cols[0].data(), *r = cols[1].data(), *q = cols[2].data(),
               *s = cols[3].data();
    const float* t = tab.data();
    const float pg = pens[0], ps = pens[1];
    const int mdx = hdr[3], mdy = hdr[4], bw = hdr[5];
    int rc = -1;
    switch (10 * (e->n_out + e->n_scratch) + e->prune) {
      case 20:
        rc = ((Exact2)e->fn)(g, r, q, s, o[0].data(), o[1].data(), t, tab_len, B, A,
                             H, mdx, mdy, bw, pg, ps, nullptr);
        break;
      case 40:
        rc = ((Exact4)e->fn)(g, r, q, s, o[0].data(), o[1].data(), o[2].data(),
                             o[3].data(), t, tab_len, B, A, H, mdx, mdy, bw, pg, ps,
                             nullptr);
        break;
      case 21:
        rc = ((Prune2)e->fn)(g, r, q, s, o[0].data(), o[1].data(), t, tab_len, B, A,
                             H, mdx, mdy, bw, pg, ps, skip, nullptr);
        break;
      case 31:
        rc = ((Prune3)e->fn)(g, r, q, s, o[0].data(), o[1].data(), o[2].data(), t,
                             tab_len, B, A, H, mdx, mdy, bw, pg, ps, skip, nullptr);
        break;
      case 41:
        rc = ((Prune4)e->fn)(g, r, q, s, o[0].data(), o[1].data(), o[2].data(),
                             o[3].data(), t, tab_len, B, A, H, mdx, mdy, bw, pg, ps,
                             skip, nullptr);
        break;
      case 61:
        rc = ((Prune6)e->fn)(g, r, q, s, o[0].data(), o[1].data(), o[2].data(),
                             o[3].data(), o[4].data(), o[5].data(), t, tab_len, B, A,
                             H, mdx, mdy, bw, pg, ps, skip, nullptr);
        break;
    }
    std::fwrite(&rc, sizeof(int), 1, out);
    for (int k = 0; k < e->n_out; ++k) std::fwrite(o[k].data(), sizeof(int), n, out);
  }
  std::fclose(out);
  return 0;
}
