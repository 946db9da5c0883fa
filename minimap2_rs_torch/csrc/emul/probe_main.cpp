// Runs the entry point of csrc/probe.cu, built against cuda_emul.h, on the
// CPU:
//
//   probe_emul IN OUT
//
// IN holds int64 [n, n_prefix, n_kv, shift], then the (n,) int64 sks, the
// (n,) uint8 keep, the (n_prefix,) int32 prefix table and the (n_kv, 4)
// int32 key table. OUT gets the int32 return code of mm2t_probe_prefix
// and its outputs: (n,) int64 start, (n,) int64 count. The outputs start
// filled with 0xA5 bytes, so a slot the kernel leaves unwritten shows.
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" int mm2t_probe_prefix(const void*, const void*, long long, const void*, int,
                                 const void*, int, void*, void*, void*);

namespace {

struct alignas(16) Row {  // a 16-byte row, aligned as on the card
  int w[4];
};

template <class T>
bool read_into(FILE* in, std::vector<T>& v) {
  return std::fread(v.data(), sizeof(T), v.size(), in) == v.size();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 3) {
    std::fprintf(stderr, "usage: %s IN OUT\n", argv[0]);
    return 2;
  }
  FILE* in = std::fopen(argv[1], "rb");
  if (!in) return 2;
  std::vector<long long> hdr(4);
  if (!read_into(in, hdr)) return 2;
  const long long n = hdr[0], n_prefix = hdr[1], n_kv = hdr[2], shift = hdr[3];
  std::vector<long long> sks(n);
  std::vector<unsigned char> keep(n);
  std::vector<int> prefix(n_prefix);
  std::vector<Row> kv(n_kv);
  if (!read_into(in, sks) || !read_into(in, keep) || !read_into(in, prefix) ||
      !read_into(in, kv))
    return 2;
  std::fclose(in);

  std::vector<long long> start(n), count(n);
  std::memset(start.data(), 0xA5, start.size() * sizeof(long long));
  std::memset(count.data(), 0xA5, count.size() * sizeof(long long));
  const int rc = mm2t_probe_prefix(sks.data(), keep.data(), n, prefix.data(), (int)n_prefix,
                                   kv.data(), (int)shift, start.data(), count.data(), nullptr);
  FILE* out = std::fopen(argv[2], "wb");
  if (!out) return 2;
  std::fwrite(&rc, sizeof(int), 1, out);
  std::fwrite(start.data(), sizeof(long long), start.size(), out);
  std::fwrite(count.data(), sizeof(long long), count.size(), out);
  std::fclose(out);
  return 0;
}
