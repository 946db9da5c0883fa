// Runs the short-read and template entry points of csrc/chain_dp.cu,
// built against cuda_emul.h, on the CPU:
//
//   chain_dp_emul IN OUT ENTRY...
//
// IN holds int32 [B, A, H, max_dist_x, max_dist_y, bw, tab_len], float32
// [pen_gap, pen_skip], the (B, A) int32 columns grp, rpos, qpos and span,
// then the float32 log2 table of tab_len entries. For each ENTRY (e.g.
// mm2t_chain_dp_aux_short), in order, OUT
// gets its int32 return code and then its (B, A) int32 outputs: four for
// the aux entries (f, cnt, sq, sr), two for the others (f, prev).
#include <cstdio>
#include <cstring>
#include <vector>

using Entry = int (*)(const void*, const void*, const void*, const void*,
                      void*, void*, void*, void*, const void*, int, int, int,
                      int, int, int, int, float, float, void*);
using EntryPrev = int (*)(const void*, const void*, const void*, const void*,
                          void*, void*, const void*, int, int, int, int, int,
                          int, int, float, float, void*);

#define AUX_ENTRY(name)                                                      \
  extern "C" int name(const void*, const void*, const void*, const void*,    \
                      void*, void*, void*, void*, const void*, int, int, int, \
                      int, int, int, int, float, float, void*);
#define PREV_ENTRY(name)                                                    \
  extern "C" int name(const void*, const void*, const void*, const void*,   \
                      void*, void*, const void*, int, int, int, int, int, int, \
                      int, float, float, void*);
AUX_ENTRY(mm2t_chain_dp_aux)
AUX_ENTRY(mm2t_chain_dp_aux_short)
PREV_ENTRY(mm2t_chain_dp)
PREV_ENTRY(mm2t_chain_dp_short)

namespace {

struct Named {
  const char* name;
  Entry aux;
  EntryPrev prev;
};
const Named kEntries[] = {
    {"mm2t_chain_dp_aux", mm2t_chain_dp_aux, nullptr},
    {"mm2t_chain_dp_aux_short", mm2t_chain_dp_aux_short, nullptr},
    {"mm2t_chain_dp", nullptr, mm2t_chain_dp},
    {"mm2t_chain_dp_short", nullptr, mm2t_chain_dp_short},
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
  std::vector<int> hdr(7);
  std::vector<float> pens(2);
  if (!read_into(in, hdr) || !read_into(in, pens)) return 2;
  const int B = hdr[0], A = hdr[1], H = hdr[2], tab_len = hdr[6];
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
    std::vector<std::vector<int>> outs(e->aux ? 4 : 2, std::vector<int>(n, 0x7eadbeef));
    const int rc = e->aux
        ? e->aux(cols[0].data(), cols[1].data(), cols[2].data(), cols[3].data(),
                 outs[0].data(), outs[1].data(), outs[2].data(), outs[3].data(),
                 tab.data(), tab_len, B, A, H, hdr[3], hdr[4], hdr[5], pens[0],
                 pens[1], nullptr)
        : e->prev(cols[0].data(), cols[1].data(), cols[2].data(), cols[3].data(),
                  outs[0].data(), outs[1].data(), tab.data(), tab_len, B, A, H,
                  hdr[3], hdr[4], hdr[5], pens[0], pens[1], nullptr);
    std::fwrite(&rc, sizeof(int), 1, out);
    for (auto& o : outs) std::fwrite(o.data(), sizeof(int), n, out);
  }
  std::fclose(out);
  return 0;
}
