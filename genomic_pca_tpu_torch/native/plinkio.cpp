// Native host-side decoders for the genomic_pca_tpu_torch data path: a copy
// of the JAX package's native/plinkio.cpp with one addition, the PLINK text
// table parser at the end, built by this directory's Makefile into
// build/native/ (io/native.py).
//
// TPU-native equivalents of the reference's native ingest dependencies:
//  * bed-reader (PLINK .bed 2-bit decode, reference src/prepare.rs:622-629,
//    and its .bim / .fam parse)
//  * noodles-vcf GT tokenization (reference src/vcf.rs:103-279)
//
// Exposed as a C ABI for ctypes (no pybind11 in the build image).
// Compile: make -C genomic_pca_tpu_torch/native (OUT=<dir> to place the library)

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <zlib.h>

namespace {

// 256 x 4 genotype lookup tables (PLINK1 2-bit codes, low bits first).
// Codes: 00=hom A1, 01=missing, 10=het, 11=hom A2.
struct Luts {
  int8_t a1[256][4];  // count_A1: 00->2, 10->1, 11->0, 01->-127
  int8_t a2[256][4];  // count_A2: 00->0, 10->1, 11->2, 01->-127
  Luts() {
    const int8_t map_a1[4] = {2, -127, 1, 0};
    const int8_t map_a2[4] = {0, -127, 1, 2};
    for (int byte = 0; byte < 256; ++byte) {
      for (int pos = 0; pos < 4; ++pos) {
        int code = (byte >> (2 * pos)) & 0b11;
        a1[byte][pos] = map_a1[code];
        a2[byte][pos] = map_a2[code];
      }
    }
  }
};
const Luts kLuts;

void decode_rows(const uint8_t* packed, const int64_t* snp_offsets,
                 int64_t row_begin, int64_t row_end, int64_t bytes_per_snp,
                 int64_t n_samples, int count_a1, int8_t* out) {
  const auto& lut = count_a1 ? kLuts.a1 : kLuts.a2;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const uint8_t* src = packed + snp_offsets[r];
    int8_t* dst = out + r * n_samples;
    int64_t full = n_samples / 4;
    for (int64_t b = 0; b < full; ++b) {
      std::memcpy(dst + b * 4, lut[src[b]], 4);
    }
    int64_t rem = n_samples - full * 4;
    if (rem > 0) {
      const int8_t* last = lut[src[full]];
      for (int64_t k = 0; k < rem; ++k) dst[full * 4 + k] = last[k];
    }
    (void)bytes_per_snp;
  }
}

}  // namespace

extern "C" {

// ABI version of this library.  Bumped whenever any exported signature
// changes; the Python binding refuses to load a mismatched .so (a stale
// library would otherwise misinterpret arguments and crash the
// process).  History: 1 = initial; 2 = n_threads param added to
// plinkio_parse_vcf_lines; 3 = plinkio_packed_qc_counts added;
// 4 = plinkio_synth_pack added; 5 = plinkio_parse_table added.
int64_t plinkio_abi_version() { return 5; }

// Decode selected SNP rows of a SNP-major .bed byte block into int8
// dosages (missing = -127).  `snp_offsets[i]` is the byte offset of row
// i's packed data within `packed`.  Parallel over rows.
void plinkio_decode_bed(const uint8_t* packed, const int64_t* snp_offsets,
                        int64_t n_rows, int64_t bytes_per_snp,
                        int64_t n_samples, int count_a1, int n_threads,
                        int8_t* out) {
  if (n_threads <= 1 || n_rows < 256) {
    decode_rows(packed, snp_offsets, 0, n_rows, bytes_per_snp, n_samples,
                count_a1, out);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(n_rows, begin + chunk);
    if (begin >= end) break;
    workers.emplace_back(decode_rows, packed, snp_offsets, begin, end,
                         bytes_per_snp, n_samples, count_a1, out);
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// VCF record parsing.
//
// Parses a buffer of complete VCF data lines (no header lines) with the
// reference's exact drop semantics (src/vcf.rs:103-279): bi-allelic
// single-base REF/ALT SNPs only; GT must be a 3-byte diploid "a{/|}b"
// with alleles in {0,1}; any bad/missing sample GT drops the variant.
//
// Outputs, per input line i in [0, n_lines):
//   keep[i]      = 1 if the variant survives (dosages written), else 0
//   dosages      = row-major int8 (n_lines x n_samples); only kept rows valid
//   line_starts  = byte offset of each line (for the caller to extract
//                  CHROM/POS/REF/ALT of kept lines)
// Returns the number of lines found (<= max_lines).
namespace {

// Parse one data line into drow; returns 1 if the variant is kept.
// Fast path: when GT is the first FORMAT key and the sample region has
// the exact fixed 4-byte stride of pure 3-byte diploid GTs, samples
// decode with no per-byte scanning; any stride/separator surprise falls
// back to the general scanner (identical semantics), while a verified
// 3-byte GT with a non-{0,1} allele is a certain whole-variant drop.
int parse_vcf_one_line(const char* buf, int64_t line_start, int64_t line_end,
                       int64_t n_samples, int8_t* drow) {
  // Walk the first 9 tab-separated fields.
  const char* p = buf + line_start;
  const char* end = buf + line_end;
  const char* fields[9];
  int nf = 0;
  fields[nf++] = p;
  for (const char* q = p; q < end && nf < 9; ++q) {
    if (*q == '\t') fields[nf++] = q + 1;
  }
  if (nf < 9) return 0;
  // REF = field 3, ALT = field 4, FORMAT = field 8.
  const char* ref = fields[3];
  const char* alt = fields[4];
  auto field_len = [&](int idx) {
    const char* s = fields[idx];
    const char* e = (idx + 1 < nf) ? fields[idx + 1] - 1 : end;
    return static_cast<int64_t>(e - s);
  };
  if (field_len(3) != 1 || field_len(4) != 1) return 0;
  auto is_base = [](char c) {
    switch (c) {
      case 'A': case 'C': case 'G': case 'T':
      case 'a': case 'c': case 'g': case 't':
        return true;
      default:
        return false;
    }
  };
  if (!is_base(ref[0]) || !is_base(alt[0])) return 0;

  // FORMAT field: find GT position among ':'-separated keys.
  const char* fmt = fields[8];
  const char* fmt_end = fmt;
  while (fmt_end < end && *fmt_end != '\t') ++fmt_end;
  int gt_index = -1, fi = 0;
  for (const char* q = fmt; q < fmt_end;) {
    const char* key = q;
    while (q < fmt_end && *q != ':') ++q;
    if (q - key == 2 && key[0] == 'G' && key[1] == 'T') {
      gt_index = fi;
      break;
    }
    ++fi;
    if (q < fmt_end) ++q;
  }
  if (gt_index < 0) return 0;

  const char* s0 = (fmt_end < end) ? fmt_end + 1 : end;

  // ---- fixed-stride fast path --------------------------------------
  if (gt_index == 0 && end - s0 == 4 * n_samples - 1) {
    bool fallback = false;
    for (int64_t i = 0; i < n_samples; ++i) {
      const char* g = s0 + 4 * i;
      char sep = g[1];
      // Stride/separator mismatch: shapes the fast path cannot judge
      // (e.g. "0/1:30" sub-fields) -> general scanner decides.
      if (sep != '/' && sep != '|') { fallback = true; break; }
      if (i + 1 < n_samples && g[3] != '\t') { fallback = true; break; }
      unsigned a = static_cast<unsigned>(g[0]) - '0';
      unsigned b = static_cast<unsigned>(g[2]) - '0';
      // Verified 3-byte diploid GT with allele outside {0,1} (missing
      // '.' or multi-allelic): certain whole-variant drop.
      if (a > 1 || b > 1) return 0;
      drow[i] = static_cast<int8_t>(a + b);
    }
    if (!fallback) return 1;
  }

  // ---- general scanner ----------------------------------------------
  const char* s = s0;
  int64_t sample = 0;
  while (sample < n_samples) {
    const char* fstart = s;
    while (s < end && *s != '\t') ++s;
    const char* fend = s;
    // Locate the GT sub-field.
    const char* g = fstart;
    for (int skip = 0; skip < gt_index; ++skip) {
      while (g < fend && *g != ':') ++g;
      if (g < fend) ++g; else return 0;
    }
    const char* gend = g;
    while (gend < fend && *gend != ':') ++gend;
    if (gend - g != 3 || (g[1] != '/' && g[1] != '|')) return 0;
    int a = (g[0] == '0') ? 0 : (g[0] == '1') ? 1 : -1;
    int b = (g[2] == '0') ? 0 : (g[2] == '1') ? 1 : -1;
    if (a < 0 || b < 0) return 0;
    drow[sample++] = static_cast<int8_t>(a + b);
    if (s < end) ++s;  // skip tab
    else break;
  }
  if (sample != n_samples) return 0;
  if (s < end) return 0;  // more sample fields than expected -> drop
  return 1;
}

void parse_vcf_rows(const char* buf, const int64_t* starts,
                    const int64_t* ends, int64_t row_begin, int64_t row_end,
                    int64_t n_samples, int8_t* dosages, uint8_t* keep) {
  for (int64_t r = row_begin; r < row_end; ++r) {
    keep[r] = static_cast<uint8_t>(parse_vcf_one_line(
        buf, starts[r], ends[r], n_samples, dosages + r * n_samples));
  }
}

}  // namespace

int64_t plinkio_parse_vcf_lines(const char* buf, int64_t len,
                                int64_t n_samples, int64_t max_lines,
                                int n_threads, int8_t* dosages, uint8_t* keep,
                                int64_t* line_starts) {
  // Pass 1 (serial, memchr-speed): line boundaries.
  std::vector<int64_t> ends;
  ends.reserve(static_cast<size_t>(max_lines));
  int64_t n_lines = 0;
  int64_t pos = 0;
  while (pos < len && n_lines < max_lines) {
    int64_t line_start = pos;
    const char* nl = static_cast<const char*>(
        std::memchr(buf + pos, '\n', static_cast<size_t>(len - pos)));
    int64_t line_end = nl ? (nl - buf) : len;
    pos = line_end + 1;
    if (line_end > line_start && buf[line_end - 1] == '\r') --line_end;
    if (line_end == line_start) continue;  // blank
    line_starts[n_lines] = line_start;
    ends.push_back(line_end);
    ++n_lines;
  }

  // Pass 2: parse lines, parallel across rows.
  if (n_threads <= 1 || n_lines < 64) {
    parse_vcf_rows(buf, line_starts, ends.data(), 0, n_lines, n_samples,
                   dosages, keep);
    return n_lines;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_lines + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t row_end = std::min(n_lines, begin + chunk);
    if (begin >= row_end) break;
    workers.emplace_back(parse_vcf_rows, buf, line_starts, ends.data(),
                         begin, row_end, n_samples, dosages, keep);
  }
  for (auto& w : workers) w.join();
  return n_lines;
}

// ---------------------------------------------------------------------------
// BGZF block-parallel inflate.
//
// BGZF (the framing used by .vcf.gz/.bed.gz in the htslib ecosystem; the
// reference consumes it through noodles' BGZF layer) is a sequence of
// INDEPENDENT gzip members, each <= 64 KiB uncompressed, carrying the
// compressed block size in a "BC" extra subfield.  Independence makes
// decompression embarrassingly parallel -- unlike a plain gzip stream,
// which is inherently serial.  plinkio_bgzf_scan finds block boundaries;
// plinkio_bgzf_inflate raw-inflates all blocks across threads.

namespace {

// Parse one BGZF member header at buf[0..len).  On success returns the
// total compressed block size (BSIZE+1) and sets *data_off to the start
// of the deflate payload; returns 0 if the block is truncated, -1 if the
// bytes are not a BGZF member.
int64_t parse_bgzf_header(const uint8_t* buf, int64_t len, int64_t* data_off) {
  if (len < 18) return 0;
  if (buf[0] != 0x1f || buf[1] != 0x8b || buf[2] != 8 || !(buf[3] & 4))
    return -1;  // not gzip, or no FEXTRA -> cannot be BGZF
  int64_t xlen = buf[10] | (buf[11] << 8);
  if (12 + xlen > len) return 0;
  int64_t bsize = -1;
  for (int64_t p = 12; p + 4 <= 12 + xlen;) {
    uint8_t si1 = buf[p], si2 = buf[p + 1];
    int64_t slen = buf[p + 2] | (buf[p + 3] << 8);
    if (p + 4 + slen > 12 + xlen) return -1;
    if (si1 == 66 && si2 == 67 && slen == 2) {  // 'B','C'
      bsize = buf[p + 4] | (buf[p + 5] << 8);
      break;
    }
    p += 4 + slen;
  }
  if (bsize < 0) return -1;  // FEXTRA without BC subfield: not BGZF
  int64_t total = bsize + 1;
  if (total < 12 + xlen + 8) return -1;
  *data_off = 12 + xlen;
  return total;
}

std::atomic<int32_t> g_bgzf_error;

void inflate_blocks(const uint8_t* buf, const int64_t* offsets,
                    const int64_t* csizes, const int64_t* usizes,
                    const int64_t* out_offsets, int64_t begin, int64_t end,
                    uint8_t* out) {
  for (int64_t i = begin; i < end; ++i) {
    if (g_bgzf_error.load(std::memory_order_relaxed)) return;
    const uint8_t* block = buf + offsets[i];
    int64_t data_off = 0;
    int64_t total = parse_bgzf_header(block, csizes[i], &data_off);
    if (total != csizes[i]) {
      g_bgzf_error.store(1, std::memory_order_relaxed);
      return;
    }
    int64_t data_len = csizes[i] - data_off - 8;  // strip CRC32+ISIZE
    uint8_t* dst = out + out_offsets[i];
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) {  // raw deflate
      g_bgzf_error.store(2, std::memory_order_relaxed);
      return;
    }
    zs.next_in = const_cast<uint8_t*>(block + data_off);
    zs.avail_in = static_cast<uInt>(data_len);
    zs.next_out = dst;
    zs.avail_out = static_cast<uInt>(usizes[i]);
    int rc = inflate(&zs, Z_FINISH);
    bool ok = (rc == Z_STREAM_END) &&
              (static_cast<int64_t>(zs.total_out) == usizes[i]);
    inflateEnd(&zs);
    if (!ok) {
      g_bgzf_error.store(3, std::memory_order_relaxed);
      return;
    }
    // CRC check (matches the gzip module's strictness on the fallback path).
    const uint8_t* tail = block + csizes[i] - 8;
    uint32_t want = static_cast<uint32_t>(tail[0]) | (tail[1] << 8) |
                    (tail[2] << 16) | (static_cast<uint32_t>(tail[3]) << 24);
    uint32_t got = static_cast<uint32_t>(
        crc32(crc32(0L, Z_NULL, 0), dst, static_cast<uInt>(usizes[i])));
    if (want != got) {
      g_bgzf_error.store(4, std::memory_order_relaxed);
      return;
    }
  }
}

}  // namespace

// Scan complete BGZF blocks in buf.  Fills offsets/csizes (compressed)
// and usizes (ISIZE) per block.  Stops at the first block that extends
// past `len` (a partial tail the caller carries into its next window).
// Returns the number of complete blocks, or -1 if the buffer does not
// start with valid BGZF framing.
int64_t plinkio_bgzf_scan(const uint8_t* buf, int64_t len, int64_t max_blocks,
                          int64_t* offsets, int64_t* csizes, int64_t* usizes) {
  int64_t n = 0, pos = 0;
  while (pos < len && n < max_blocks) {
    int64_t data_off = 0;
    int64_t total = parse_bgzf_header(buf + pos, len - pos, &data_off);
    if (total < 0) return n == 0 ? -1 : n;  // mid-stream garbage: caller errors
    if (total == 0 || pos + total > len) break;  // partial tail
    offsets[n] = pos;
    csizes[n] = total;
    const uint8_t* tail = buf + pos + total - 4;
    usizes[n] = static_cast<int64_t>(tail[0]) | (tail[1] << 8) |
                (tail[2] << 16) | (static_cast<int64_t>(tail[3]) << 24);
    ++n;
    pos += total;
  }
  return n;
}

// Inflate n_blocks BGZF blocks (described by offsets/csizes/usizes from
// plinkio_bgzf_scan) into out at out_offsets, parallel across threads.
// Returns 0 on success, nonzero error code otherwise.
int32_t plinkio_bgzf_inflate(const uint8_t* buf, const int64_t* offsets,
                             const int64_t* csizes, const int64_t* usizes,
                             const int64_t* out_offsets, int64_t n_blocks,
                             int n_threads, uint8_t* out) {
  g_bgzf_error.store(0, std::memory_order_relaxed);
  if (n_threads <= 1 || n_blocks < 4) {
    inflate_blocks(buf, offsets, csizes, usizes, out_offsets, 0, n_blocks, out);
    return g_bgzf_error.load(std::memory_order_relaxed);
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_blocks + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(n_blocks, begin + chunk);
    if (begin >= end) break;
    workers.emplace_back(inflate_blocks, buf, offsets, csizes, usizes,
                         out_offsets, begin, end, out);
  }
  for (auto& w : workers) w.join();
  return g_bgzf_error.load(std::memory_order_relaxed);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Packed QC genotype counts.
//
// Host-side per-SNP genotype histograms straight off the PLINK 2-bit
// bytes (no decode, no device upload): the host analog of the device
// reduction in ops/qc.py:genotype_counts_packed, feeding the identical
// integer counts to the QC filter chain so decisions are bit-identical.
// SWAR popcounts over 64-bit words: per word, lo/hi code bit-planes
// classify all 32 fields at once.

namespace {

void qc_count_rows(const uint8_t* packed, const int64_t* snp_offsets,
                   int64_t row_begin, int64_t row_end, int64_t n_samples,
                   int32_t* out /* (n_rows, 4): n0, n1, n2, n_valid */) {
  const uint64_t kLoMask = 0x5555555555555555ull;
  const int64_t full_bytes = n_samples / 4;
  const int64_t rem_fields = n_samples - full_bytes * 4;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const uint8_t* src = packed + snp_offsets[r];
    int64_t c_dos0 = 0, c_dos1 = 0, c_miss = 0;  // codes 11, 10, 01
    int64_t b = 0;
    for (; b + 8 <= full_bytes; b += 8) {
      uint64_t x;
      std::memcpy(&x, src + b, 8);
      uint64_t lo = x & kLoMask;
      uint64_t hi = (x >> 1) & kLoMask;
      c_dos0 += __builtin_popcountll(lo & hi);
      c_dos1 += __builtin_popcountll(hi & ~lo);
      c_miss += __builtin_popcountll(lo & ~hi);
    }
    if (b < full_bytes) {
      // Zero-padded tail word: code 00 sets no bit in any of the three
      // counted planes, and n2 is derived by complement, so the pad
      // bytes are inert.
      uint64_t x = 0;
      std::memcpy(&x, src + b, full_bytes - b);
      uint64_t lo = x & kLoMask;
      uint64_t hi = (x >> 1) & kLoMask;
      c_dos0 += __builtin_popcountll(lo & hi);
      c_dos1 += __builtin_popcountll(hi & ~lo);
      c_miss += __builtin_popcountll(lo & ~hi);
    }
    for (int64_t p = 0; p < rem_fields; ++p) {
      int code = (src[full_bytes] >> (2 * p)) & 0b11;
      c_dos0 += (code == 3);
      c_dos1 += (code == 2);
      c_miss += (code == 1);
    }
    int32_t* dst = out + r * 4;
    dst[0] = static_cast<int32_t>(c_dos0);
    dst[1] = static_cast<int32_t>(c_dos1);
    dst[3] = static_cast<int32_t>(n_samples - c_miss);  // n_valid
    dst[2] = static_cast<int32_t>(dst[3] - c_dos0 - c_dos1);  // n2
  }
}

}  // namespace

extern "C" {

// Per-SNP genotype counts over SNP-major packed rows.  `snp_offsets[i]`
// is the byte offset of row i within `packed`; each row spans
// ceil(n_samples/4) bytes.  out is (n_rows, 4) int32: n0 (dosage 0 =
// code 11), n1 (code 10), n2 (code 00), n_valid.  Parallel over rows.
void plinkio_packed_qc_counts(const uint8_t* packed,
                              const int64_t* snp_offsets, int64_t n_rows,
                              int64_t n_samples, int n_threads,
                              int32_t* out) {
  if (n_threads <= 1 || n_rows < 1024) {
    qc_count_rows(packed, snp_offsets, 0, n_rows, n_samples, out);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(n_rows, begin + chunk);
    if (begin >= end) break;
    workers.emplace_back(qc_count_rows, packed, snp_offsets, begin, end,
                         n_samples, out);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Synthetic packed-genotype strip generator (benchmark fixtures).
//
// Biobank-scale synthetic BEDs (34 GB class) are memory-bandwidth-bound
// to generate; the numpy path (gather thresholds, draw bytes, compare,
// pack) makes five+ passes over strip-sized buffers.  This fuses the
// whole per-genotype pipeline — PRNG byte, two threshold lookups, PLINK
// code, 2-bit pack — into ONE pass writing packed bytes directly.
//
// Model (HWE per population): genotype byte r ~ U[0,256); dosage 2
// (code 00) if r < a[pop], het (code 10) if r < b[pop], else dosage 0
// (code 11), with r == 255 remapped to missing (code 01), where
// a = 256 p^2 and b = 256 p(2-p) clamped to 255.  Deterministic per
// (seed, absolute row): thread count cannot change the output.

namespace {

inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97F4A7C15ull);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

void synth_rows(const uint8_t* a_pop, const uint8_t* b_pop,
                const uint8_t* pop, int64_t row_begin, int64_t row_end,
                int64_t n_samples, int64_t n_pops, uint64_t seed,
                int64_t row0, uint8_t* out) {
  const int64_t bps = (n_samples + 3) / 4;
  for (int64_t r = row_begin; r < row_end; ++r) {
    const uint8_t* ar = a_pop + r * n_pops;
    const uint8_t* br = b_pop + r * n_pops;
    uint8_t* dst = out + r * bps;
    uint64_t state = seed ^ (0xD1B54A32D192ED03ull * (uint64_t)(row0 + r));
    uint64_t rbuf = 0;
    int have = 0;
    int64_t s = 0;
    for (; s + 4 <= n_samples; s += 4) {
      uint8_t byte = 0;
      for (int j = 0; j < 4; ++j) {
        if (have == 0) {
          rbuf = splitmix64(state);
          have = 8;
        }
        uint8_t rv = (uint8_t)(rbuf & 0xFF);
        rbuf >>= 8;
        --have;
        uint8_t p = pop[s + j];
        uint8_t code;
        if (rv < ar[p]) {
          code = 0;  // dosage 2
        } else if (rv < br[p]) {
          code = 2;  // het
        } else {
          code = (rv == 255) ? 1 : 3;  // missing : dosage 0
        }
        byte |= (uint8_t)(code << (2 * j));
      }
      dst[s >> 2] = byte;
    }
    if (s < n_samples) {  // partial last byte: zero-filled tail (PLINK)
      uint8_t byte = 0;
      for (int j = 0; s + j < n_samples; ++j) {
        if (have == 0) {
          rbuf = splitmix64(state);
          have = 8;
        }
        uint8_t rv = (uint8_t)(rbuf & 0xFF);
        rbuf >>= 8;
        --have;
        uint8_t p = pop[s + j];
        uint8_t code;
        if (rv < ar[p]) {
          code = 0;
        } else if (rv < br[p]) {
          code = 2;
        } else {
          code = (rv == 255) ? 1 : 3;
        }
        byte |= (uint8_t)(code << (2 * j));
      }
      dst[s >> 2] = byte;
    }
  }
}

}  // namespace

extern "C" {

// Generate `rows` packed PLINK rows into out (rows x ceil(n/4)).
// a_pop/b_pop: (rows, n_pops) uint8 thresholds; pop: (n_samples,) uint8
// population of each sample; row0: absolute index of the first row (for
// strip-invariant determinism).  Parallel over rows.
void plinkio_synth_pack(const uint8_t* a_pop, const uint8_t* b_pop,
                        const uint8_t* pop, int64_t rows, int64_t n_samples,
                        int64_t n_pops, uint64_t seed, int64_t row0,
                        int n_threads, uint8_t* out) {
  if (n_threads <= 1 || rows < 64) {
    synth_rows(a_pop, b_pop, pop, 0, rows, n_samples, n_pops, seed, row0,
               out);
    return;
  }
  std::vector<std::thread> workers;
  int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t begin = t * chunk;
    int64_t end = std::min(rows, begin + chunk);
    if (begin >= end) break;
    workers.emplace_back(synth_rows, a_pop, b_pop, pop, begin, end,
                         n_samples, n_pops, seed, row0, out);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// PLINK text tables (.bim, .fam).
//
// One pass over a whole table's bytes, split across threads at line
// boundaries, in place of a per-row Python loop.  Fields are separated by
// runs of spaces and tabs; a line ends at '\n' or "\r\n"; blank lines are
// skipped and fields past the first `n_cols` ignored.  Each of the first
// `n_cols` columns comes out as its kind says:
//   kTableSkip  - not kept;
//   kTableJoin  - its values joined by '\n' into one buffer;
//   kTableCodes - int32 codes of its distinct values by first appearance,
//                 with those values joined by '\n';
//   kTableInt   - int64, from an optional '-' and decimal digits.
// What the Python line loop would read otherwise, or reject, is handed
// back as a negative status, so that the loop keeps defining the values
// and the errors: a non-blank line with fewer than `n_cols` fields, an
// int field of any other form or outside int64, a byte outside ASCII, a
// control byte other than '\t', '\n' and '\r', and a '\r' that does not
// end a line (universal newlines would break the line there).

namespace {

enum : int32_t { kTableSkip = 0, kTableJoin = 1, kTableCodes = 2, kTableInt = 3 };
enum : int64_t {
  kTableShortRow = -1,
  kTableBadInt = -2,
  kTableNonAscii = -3,
  kTableControl = -4,
  kTableLoneCr = -5,
  kTableBadArgs = -6,
};
constexpr int kMaxTableCols = 16;
// Threads take at least this many bytes each (a .fam of a few thousand
// samples parses on one).
constexpr int64_t kTableMinChunk = 1 << 16;

enum : uint8_t { kByteField, kByteSep, kByteNl, kByteCr, kByteHigh, kByteControl };

struct ByteClasses {
  uint8_t of[256];
  ByteClasses() {
    for (int b = 0; b < 256; ++b) {
      if (b >= 0x80) of[b] = kByteHigh;
      else if (b == ' ' || b == '\t') of[b] = kByteSep;
      else if (b == '\n') of[b] = kByteNl;
      else if (b == '\r') of[b] = kByteCr;
      else if (b < 0x20 || b == 0x7f) of[b] = kByteControl;
      else of[b] = kByteField;
    }
  }
};
const ByteClasses kByteClasses;

// Codes of a column's distinct values in order of first appearance.
struct Factorizer {
  int32_t one_byte[256];  // single-byte values (A, C, G, T, 1-9, X, ...)
  std::unordered_map<std::string_view, int32_t> longer;
  std::string_view last;  // runs of one value (a chromosome) skip the map
  int32_t last_code = -1;
  std::vector<std::string_view> values;

  Factorizer() { std::fill(one_byte, one_byte + 256, -1); }

  int32_t code(std::string_view v) {
    if (v.size() == 1) {
      int32_t& c = one_byte[static_cast<uint8_t>(v[0])];
      if (c < 0) {
        c = static_cast<int32_t>(values.size());
        values.push_back(v);
      }
      return c;
    }
    if (last_code >= 0 && v == last) return last_code;
    auto it = longer.find(v);
    int32_t c;
    if (it == longer.end()) {
      c = static_cast<int32_t>(values.size());
      longer.emplace(v, c);
      values.push_back(v);
    } else {
      c = it->second;
    }
    last = v;
    last_code = c;
    return c;
  }
};

bool parse_int64(std::string_view s, int64_t* out) {
  size_t i = 0;
  bool neg = !s.empty() && s[0] == '-';
  if (neg) i = 1;
  if (i == s.size()) return false;
  const uint64_t limit = neg ? (uint64_t{1} << 63) : (uint64_t{1} << 63) - 1;
  uint64_t v = 0;
  for (; i < s.size(); ++i) {
    unsigned d = static_cast<unsigned>(static_cast<uint8_t>(s[i])) - '0';
    if (d > 9 || v > (limit - d) / 10) return false;
    v = v * 10 + d;
  }
  *out = static_cast<int64_t>(neg ? ~v + 1 : v);
  return true;
}

// One thread's share of the table: rows [begin, end) of the bytes.
struct TableChunk {
  int64_t begin = 0, end = 0, rows = 0, status = 0;
  std::vector<std::string> joined;             // kTableJoin, '\n' after each
  std::vector<std::vector<int32_t>> codes;     // kTableCodes, local codes
  std::vector<Factorizer> factors;             // kTableCodes, local values
  std::vector<std::vector<int64_t>> ints;      // kTableInt
};

void parse_table_chunk(const char* buf, int32_t n_cols, const int32_t* kinds,
                       TableChunk* ch) {
  ch->joined.resize(n_cols);
  ch->codes.resize(n_cols);
  ch->factors.resize(n_cols);
  ch->ints.resize(n_cols);
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf) + ch->begin;
  const uint8_t* e = reinterpret_cast<const uint8_t*>(buf) + ch->end;
  const uint8_t* cls = kByteClasses.of;
  std::string_view field[kMaxTableCols];
  while (p < e) {
    int nf = 0;
    for (;;) {  // one line
      while (p < e && cls[*p] == kByteSep) ++p;
      if (p == e) break;
      uint8_t c = cls[*p];
      if (c == kByteField) {
        const uint8_t* s = p;
        while (p < e && cls[*p] == kByteField) ++p;
        if (nf < n_cols)
          field[nf] = std::string_view(reinterpret_cast<const char*>(s), p - s);
        ++nf;
      } else if (c == kByteNl) {
        ++p;
        break;
      } else if (c == kByteCr && p + 1 < e && p[1] == '\n') {
        p += 2;
        break;
      } else {
        ch->status = c == kByteCr     ? kTableLoneCr
                     : c == kByteHigh ? kTableNonAscii
                                      : kTableControl;
        return;
      }
    }
    if (nf == 0) continue;  // blank line
    if (nf < n_cols) {
      ch->status = kTableShortRow;
      return;
    }
    for (int k = 0; k < n_cols; ++k) {
      switch (kinds[k]) {
        case kTableJoin:
          ch->joined[k].append(field[k]);
          ch->joined[k].push_back('\n');
          break;
        case kTableCodes:
          ch->codes[k].push_back(ch->factors[k].code(field[k]));
          break;
        case kTableInt: {
          int64_t v;
          if (!parse_int64(field[k], &v)) {
            ch->status = kTableBadInt;
            return;
          }
          ch->ints[k].push_back(v);
          break;
        }
        default:
          break;
      }
    }
    ++ch->rows;
  }
}

}  // namespace

extern "C" {

// Parse a whole PLINK text table (module comment above).  `kinds` holds
// n_cols column kinds; for column k, `outs[2k]` (and `outs[2k + 1]`)
// receive:
//   kTableJoin:  outs[2k] char[len + 1], the values joined by '\n';
//                sizes[2k] = its bytes, with no '\n' after the last;
//   kTableCodes: outs[2k] int32[max_rows] codes, outs[2k + 1] char[len + 1]
//                the distinct values joined by '\n'; sizes[2k] = their
//                bytes, sizes[2k + 1] = their count;
//   kTableInt:   outs[2k] int64[max_rows].
// Returns the number of rows, or a negative kTable* status (nothing the
// caller may use was written).
int64_t plinkio_parse_table(const char* buf, int64_t len, int32_t n_cols,
                            const int32_t* kinds, int64_t max_rows,
                            int n_threads, void* const* outs, int64_t* sizes) {
  if (n_cols < 1 || n_cols > kMaxTableCols) return kTableBadArgs;
  int64_t n_chunks = std::max<int64_t>(
      1, std::min<int64_t>(std::max(n_threads, 1), len / kTableMinChunk));
  // Chunk boundaries just after a '\n', so that no line is split.
  std::vector<TableChunk> chunks(n_chunks);
  int64_t at = 0;
  for (int64_t t = 0; t < n_chunks; ++t) {
    int64_t want = (t + 1 == n_chunks) ? len : len * (t + 1) / n_chunks;
    int64_t end = std::max(at, want);
    if (end < len && end > 0 && buf[end - 1] != '\n') {
      const char* nl = static_cast<const char*>(
          std::memchr(buf + end, '\n', static_cast<size_t>(len - end)));
      end = nl ? (nl - buf) + 1 : len;
    }
    chunks[t].begin = at;
    chunks[t].end = end;
    at = end;
  }
  if (n_chunks == 1) {
    parse_table_chunk(buf, n_cols, kinds, &chunks[0]);
  } else {
    std::vector<std::thread> workers;
    for (auto& ch : chunks)
      workers.emplace_back(parse_table_chunk, buf, n_cols, kinds, &ch);
    for (auto& w : workers) w.join();
  }
  int64_t rows = 0;
  for (const auto& ch : chunks) {
    if (ch.status != 0) return ch.status;
    rows += ch.rows;
  }
  if (rows > max_rows) return kTableBadArgs;

  for (int k = 0; k < n_cols; ++k) {
    sizes[2 * k] = sizes[2 * k + 1] = 0;
    if (kinds[k] == kTableJoin) {
      char* dst = static_cast<char*>(outs[2 * k]);
      int64_t n = 0;
      for (const auto& ch : chunks) {
        std::memcpy(dst + n, ch.joined[k].data(), ch.joined[k].size());
        n += static_cast<int64_t>(ch.joined[k].size());
      }
      sizes[2 * k] = n > 0 ? n - 1 : 0;
    } else if (kinds[k] == kTableCodes) {
      // The chunks' values in chunk order, each in its local first-
      // appearance order, meet the global codes in global first-appearance
      // order.
      int32_t* codes = static_cast<int32_t*>(outs[2 * k]);
      char* uniq = static_cast<char*>(outs[2 * k + 1]);
      Factorizer global;
      int64_t row = 0;
      for (const auto& ch : chunks) {
        const auto& local = ch.factors[k].values;
        std::vector<int32_t> to_global(local.size());
        for (size_t i = 0; i < local.size(); ++i) to_global[i] = global.code(local[i]);
        for (int32_t c : ch.codes[k]) codes[row++] = to_global[c];
      }
      int64_t n = 0;
      for (const auto& v : global.values) {
        std::memcpy(uniq + n, v.data(), v.size());
        n += static_cast<int64_t>(v.size());
        uniq[n++] = '\n';
      }
      sizes[2 * k] = n > 0 ? n - 1 : 0;
      sizes[2 * k + 1] = static_cast<int64_t>(global.values.size());
    } else if (kinds[k] == kTableInt) {
      int64_t* dst = static_cast<int64_t*>(outs[2 * k]);
      int64_t row = 0;
      for (const auto& ch : chunks) {
        std::memcpy(dst + row, ch.ints[k].data(), ch.ints[k].size() * sizeof(int64_t));
        row += static_cast<int64_t>(ch.ints[k].size());
      }
    }
  }
  return rows;
}

}  // extern "C"
