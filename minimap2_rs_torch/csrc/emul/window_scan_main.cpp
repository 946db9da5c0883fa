// Runs the entry points of csrc/window_scan.cu, built against cuda_emul.h,
// on the CPU:
//
//   window_scan_emul IN OUT ENTRY...
//
// IN holds int32 [B, L, w, k], the (B, L) int64 columns ks and ps, the
// (B, L) int32 l_eff, the (B,) int32 lengths and the (B,) uint8
// emit_final. For each ENTRY (mm2t_window_scan, mm2t_window_scan_tile), in
// order, OUT gets its int32 return code and then its (B, L) uint8 mask of
// emitted positions.
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {
int mm2t_window_scan(const void*, const void*, const void*, const void*,
                     const void*, void*, void*, void*, int, int, int, int,
                     void*);
int mm2t_window_scan_tile(const void*, const void*, const void*, const void*,
                          const void*, void*, int, int, int, int, void*);
}

namespace {

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
  std::vector<int> hdr(4);
  if (!read_into(in, hdr)) return 2;
  const int B = hdr[0], L = hdr[1], w = hdr[2], k = hdr[3];
  const size_t n = (size_t)B * L;
  std::vector<long long> ks(n), ps(n);
  std::vector<int> l_eff(n), lengths(B);
  std::vector<unsigned char> emit_final(B);
  if (!read_into(in, ks) || !read_into(in, ps) || !read_into(in, l_eff) ||
      !read_into(in, lengths) || !read_into(in, emit_final))
    return 2;
  std::fclose(in);

  FILE* out = std::fopen(argv[2], "wb");
  if (!out) return 2;
  for (int a = 3; a < argc; ++a) {
    std::vector<unsigned char> emitted(n, 0);
    int rc;
    if (std::strcmp(argv[a], "mm2t_window_scan") == 0) {
      std::vector<unsigned long long> ring_x((size_t)w * B);
      std::vector<unsigned int> ring_y((size_t)w * B);
      rc = mm2t_window_scan(ks.data(), ps.data(), l_eff.data(), lengths.data(),
                            emit_final.data(), emitted.data(), ring_x.data(),
                            ring_y.data(), B, L, w, k, nullptr);
    } else if (std::strcmp(argv[a], "mm2t_window_scan_tile") == 0) {
      rc = mm2t_window_scan_tile(ks.data(), ps.data(), l_eff.data(),
                                 lengths.data(), emit_final.data(),
                                 emitted.data(), B, L, w, k, nullptr);
    } else {
      std::fprintf(stderr, "unknown entry %s\n", argv[a]);
      return 2;
    }
    std::fwrite(&rc, sizeof(int), 1, out);
    std::fwrite(emitted.data(), 1, n, out);
  }
  std::fclose(out);
  return 0;
}
