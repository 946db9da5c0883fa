// Runs the entry point of csrc/sketch.cu, built against cuda_emul.h, on
// the CPU:
//
//   sketch_emul IN OUT WIRE...
//
// IN holds int32 [B, L, w, k, M, n_nex], the (B,) int32 lengths, the
// (n_nex,) int32 N list of the 2-bit wire, then the batch on each wire:
// (B, L/4) bytes of the 2-bit wire, (B, L/2) bytes of the 4-bit wire and
// (B, L) int32 nt4 codes. For each WIRE (0, 1, 2), in order, OUT gets the
// int32 return code of mm2t_sketch_minimizers and its outputs: (B, M)
// int64 cks, (B, M) int64 cps, (B,) int32 n_mini, (B,) uint8 mini_ovf.
// The outputs start filled with 0xA5 bytes, so a slot the kernel leaves
// unwritten shows.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" int mm2t_sketch_minimizers(const void*, int, const void*, const void*,
                                      int, void*, void*, void*, void*, int, int,
                                      int, int, int, void*);

namespace {

template <class T>
bool read_into(FILE* in, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), in) == v.size();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 4) {
    std::fprintf(stderr, "usage: %s IN OUT WIRE...\n", argv[0]);
    return 2;
  }
  FILE* in = std::fopen(argv[1], "rb");
  if (!in) return 2;
  std::vector<int> hdr(6);
  if (!read_into(in, hdr)) return 2;
  const int B = hdr[0], L = hdr[1], w = hdr[2], k = hdr[3], M = hdr[4],
            n_nex = hdr[5];
  const size_t n = (size_t)B * L;
  std::vector<int> lengths(B), nex(n_nex), nt4(n);
  std::vector<unsigned char> wire2(n / 4), wire4(n / 2);
  if (!read_into(in, lengths) || !read_into(in, nex) || !read_into(in, wire2) ||
      !read_into(in, wire4) || !read_into(in, nt4))
    return 2;
  std::fclose(in);
  const void* rows[3] = {wire2.data(), wire4.data(), nt4.data()};

  FILE* out = std::fopen(argv[2], "wb");
  if (!out) return 2;
  for (int a = 3; a < argc; ++a) {
    const int wire = std::atoi(argv[a]);
    if (wire < 0 || wire > 2) {
      std::fprintf(stderr, "unknown wire %s\n", argv[a]);
      return 2;
    }
    std::vector<long long> cks((size_t)B * M), cps((size_t)B * M);
    std::vector<int> n_mini(B);
    std::vector<unsigned char> ovf(B);
    std::memset(cks.data(), 0xA5, cks.size() * sizeof(long long));
    std::memset(cps.data(), 0xA5, cps.size() * sizeof(long long));
    std::memset(n_mini.data(), 0xA5, n_mini.size() * sizeof(int));
    std::memset(ovf.data(), 0xA5, ovf.size());
    const int rc = mm2t_sketch_minimizers(
        rows[wire], wire, lengths.data(), nex.data(), n_nex, cks.data(), cps.data(),
        n_mini.data(), ovf.data(), B, L, w, k, M, nullptr);
    std::fwrite(&rc, sizeof(int), 1, out);
    std::fwrite(cks.data(), sizeof(long long), cks.size(), out);
    std::fwrite(cps.data(), sizeof(long long), cps.size(), out);
    std::fwrite(n_mini.data(), sizeof(int), n_mini.size(), out);
    std::fwrite(ovf.data(), 1, ovf.size(), out);
  }
  std::fclose(out);
  return 0;
}
