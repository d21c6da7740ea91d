// Native L0 reader: streaming FASTQ/FASTA parser + 2-bit packer.
//
// The port's copy of the JAX package's native reader, loaded by
// hga_tpu_torch/io/native.py.  The pure-Python reader in
// hga_tpu_torch/io/fastq.py (with io/encode.pack_reads) defines the
// semantics; this library must produce bit-identical packed arrays:
//   * 2-bit codes A=0 C=1 G=2 T=3 (case-insensitive), 16 bases per uint32,
//     LSB-first within a word
//   * ambiguous bases encode as 0 with a 1-bit "bad" flag, 32 flags/uint32
//   * reads longer than pad_len are truncated; lengths report the
//     pre-truncation value clamped to pad_len
//
// Exposed as a C ABI for ctypes.  gzip input is handled with zlib (gzopen
// reads plain files transparently too).
//
// Build (io/native.py does it at first use, into hga_tpu_torch/_build/):
//   g++ -O3 -shared -fPIC fastq_pack.cpp -o libhga_native_<hash>.so -lz

#include <zlib.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Reader {
  gzFile f = nullptr;
  std::string buf;       // current line buffer
  bool eof = false;
  int format = 0;        // 0 unknown, 1 fasta, 2 fastq
  std::string pending_header;  // last header line seen (without > or @)

  bool getline(std::string* out) {
    out->clear();
    char chunk[4096];
    while (true) {
      if (gzgets(f, chunk, sizeof(chunk)) == nullptr) {
        eof = true;
        return !out->empty();
      }
      size_t n = std::strlen(chunk);
      bool nl = n > 0 && chunk[n - 1] == '\n';
      if (nl) chunk[--n] = '\0';
      if (n > 0 && chunk[n - 1] == '\r') chunk[--n] = '\0';
      out->append(chunk, n);
      if (nl) return true;
    }
  }
};

// base -> (code, bad) lookup
struct Lut {
  uint8_t code[256];
  uint8_t bad[256];
  Lut() {
    for (int i = 0; i < 256; i++) {
      code[i] = 0;
      bad[i] = 1;
    }
    const char* b = "ACGT";
    for (int i = 0; i < 4; i++) {
      code[(uint8_t)b[i]] = i;
      code[(uint8_t)(b[i] + 32)] = i;
      bad[(uint8_t)b[i]] = 0;
      bad[(uint8_t)(b[i] + 32)] = 0;
    }
  }
};
const Lut kLut;

void pack_seq(const std::string& seq, int pad_len, uint32_t* packed,
              uint32_t* bad, int32_t* length) {
  const int n_words = pad_len / 16;
  const int n_bad = (pad_len + 31) / 32;
  std::memset(packed, 0, n_words * sizeof(uint32_t));
  std::memset(bad, 0, n_bad * sizeof(uint32_t));
  int L = (int)seq.size();
  if (L > pad_len) L = pad_len;
  for (int i = 0; i < L; i++) {
    uint8_t c = (uint8_t)seq[i];
    packed[i >> 4] |= (uint32_t)kLut.code[c] << (2 * (i & 15));
    bad[i >> 5] |= (uint32_t)kLut.bad[c] << (i & 31);
  }
  *length = L;
}

}  // namespace

extern "C" {

void* hga_open(const char* path) {
  gzFile f = gzopen(path, "rb");
  if (!f) return nullptr;
  gzbuffer(f, 1 << 20);
  Reader* r = new Reader();
  r->f = f;
  return r;
}

void hga_close(void* h) {
  Reader* r = (Reader*)h;
  if (!r) return;
  gzclose(r->f);
  delete r;
}

// Read up to max_reads records.  Outputs (caller-allocated):
//   packed:  uint32[max_reads * pad_len/16]
//   bad:     uint32[max_reads * ceil(pad_len/32)]
//   lengths: int32[max_reads]
//   names:   char[max_reads * name_cap]  (NUL-terminated, truncated)
// Returns the number of records read, 0 at EOF, -1 on parse error.
long hga_read_batch(void* h, long max_reads, int pad_len, uint32_t* packed,
                    uint32_t* bad, int32_t* lengths, char* names,
                    int name_cap) {
  Reader* r = (Reader*)h;
  if (!r || pad_len % 16 != 0) return -1;
  const int n_words = pad_len / 16;
  const int n_bad = (pad_len + 31) / 32;
  long count = 0;
  std::string line, seq, qual;

  while (count < max_reads) {
    std::string header;
    if (!r->pending_header.empty() || r->format != 0) {
      if (r->pending_header.empty()) {
        if (!r->getline(&line)) break;
        if (line.empty()) continue;
        header = line;
      } else {
        header = r->pending_header;
        r->pending_header.clear();
      }
    } else {
      if (!r->getline(&line)) break;
      if (line.empty()) continue;
      header = line;
    }
    if (r->format == 0) {
      if (header[0] == '>') r->format = 1;
      else if (header[0] == '@') r->format = 2;
      else return -1;
    }
    if (r->format == 1) {
      // FASTA: header line then sequence lines until next '>'
      if (header[0] != '>') return -1;
      seq.clear();
      while (r->getline(&line)) {
        if (!line.empty() && line[0] == '>') {
          r->pending_header = line;
          break;
        }
        seq += line;
      }
      pack_seq(seq, pad_len, packed + count * n_words, bad + count * n_bad,
               lengths + count);
    } else {
      // FASTQ: 4-line records
      if (header[0] != '@') return -1;
      if (!r->getline(&seq)) return -1;
      if (!r->getline(&line)) return -1;  // '+'
      if (!r->getline(&qual)) return -1;
      pack_seq(seq, pad_len, packed + count * n_words, bad + count * n_bad,
               lengths + count);
    }
    // first whitespace-delimited token of the header, sans marker
    size_t start = 1;
    size_t end = header.find_first_of(" \t", start);
    if (end == std::string::npos) end = header.size();
    int n = (int)(end - start);
    if (n > name_cap - 1) n = name_cap - 1;
    std::memcpy(names + count * name_cap, header.data() + start, n);
    names[count * name_cap + n] = '\0';
    count++;
  }
  return count;
}

}  // extern "C"
