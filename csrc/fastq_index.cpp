// Host-side native FASTQ sharder for shortseq_tpu.
//
// Native replacement for the reference's C getline reader
// (reference fast_read.pyx:3-40): instead of building one Python object per
// line, this library indexes a FASTQ buffer at memory bandwidth (memchr
// newline scan, multi-threaded) and gathers the sequence lines (the 2nd of
// every 4-line record, trailing newline stripped - same selection as the
// reference's `count % 2 == 0 and count % 4 != 0`) into a PAD_BYTE(0x01)-
// padded [N, width] uint8 matrix ready for the device pack kernel.
//
// Byte-range sharding for multi-host runs: ssq_fastq_sync finds the first
// record boundary at or after an arbitrary file offset using the
// '@'-line-then-'+'-line-two-later heuristic, so each host can parse an
// independent slice of one large file.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Count '\n' bytes in [buf, buf+n).  Multi-threaded memchr scan.
int64_t ssq_count_lines(const char* buf, int64_t n) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = n > (1 << 22) ? (hw ? (int)hw : 4) : 1;
  std::vector<int64_t> partial(nthreads, 0);
  std::vector<std::thread> threads;
  int64_t chunk = (n + nthreads - 1) / nthreads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([=, &partial] {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      int64_t c = 0;
      const char* p = buf + lo;
      const char* end = buf + hi;
      while ((p = (const char*)memchr(p, '\n', end - p))) {
        ++c;
        ++p;
      }
      partial[t] = c;
    });
  }
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (int64_t c : partial) total += c;
  return total;
}

// Index the sequence lines of a FASTQ buffer.
// starts[i]/lengths[i] receive the byte offset and length (newline excluded)
// of the i-th record's sequence line.  Returns the number of records, or
// -(needed) if cap is too small.  A missing final newline is tolerated.
int64_t ssq_fastq_sync(const char* buf, int64_t n, int64_t offset);

// Index the byte range [lo, hi): record sequence-line (start, length) pairs
// into `starts`/`lengths` from slot `base` on, bounded by `cap` slots
// total.  `lo` must be a record boundary (line parity restarts at 0).
// Returns the number of sequence lines found (even past cap).
static int64_t index_range(const char* buf, int64_t lo, int64_t hi,
                           int64_t* starts, int32_t* lengths, int64_t base,
                           int64_t cap) {
  int64_t line = 0;
  int64_t count = 0;
  const char* p = buf + lo;
  const char* end = buf + hi;
  while (p < end) {
    const char* nl = (const char*)memchr(p, '\n', end - p);
    const char* line_end = nl ? nl : end;
    if ((line & 3) == 1) {  // 2nd line of each 4-line record
      if (base + count < cap) {
        starts[base + count] = p - buf;
        // Clamp: a >2 GiB "line" (corrupt/binary input) would wrap the
        // int32 negative and drive ssq_gather_padded's memcpy with a huge
        // size_t.  INT32_MAX keeps it positive; downstream length guards
        // (> MAX_VAR_NT) then reject it cleanly.
        int64_t ll = line_end - p;
        lengths[base + count] =
            ll > 0x7FFFFFFF ? 0x7FFFFFFF : (int32_t)ll;
      }
      ++count;
    }
    if (!nl) break;
    p = nl + 1;
    ++line;
  }
  return count;
}

int64_t ssq_fastq_index(const char* buf, int64_t n, int64_t* starts,
                        int32_t* lengths, int64_t cap) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = n > (8 << 20) ? (hw ? (int)hw : 4) : 1;
  if (nthreads == 1) {
    int64_t count = index_range(buf, 0, n, starts, lengths, 0, cap);
    return count <= cap ? count : -count;
  }
  // Parallel: split at record boundaries (the byte-range sharding
  // heuristic, ssq_fastq_sync), index each span into scratch, then
  // compact.  Boundary 0 stays 0 so malformed leading bytes index exactly
  // as the sequential scan would.  On well-formed FASTQ the result is
  // byte-identical to the sequential scan; on malformed input (stray
  // blank lines, 3-line records) each span restarts line parity at its
  // sync boundary, which matches the byte-range *sharding* semantics
  // rather than a whole-file parity scan - the same contract multi-host
  // shards already have.
  std::vector<int64_t> bounds(nthreads + 1);
  bounds[0] = 0;
  for (int t = 1; t < nthreads; ++t)
    bounds[t] = ssq_fastq_sync(buf, n, t * n / nthreads);
  bounds[nthreads] = n;
  struct Span {
    std::vector<int64_t> starts;
    std::vector<int32_t> lengths;
  };
  std::vector<Span> spans(nthreads);
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([=, &spans, &bounds] {
      int64_t lo = bounds[t], hi = bounds[t + 1];
      if (lo >= hi) return;
      Span& s = spans[t];
      int64_t est = (hi - lo) / 32 + 4;  // lines avg well above 8 bytes
      s.starts.resize(est);
      s.lengths.resize(est);
      int64_t c = index_range(buf, lo, hi, s.starts.data(),
                              s.lengths.data(), 0, est);
      if (c > est) {  // rare: re-run with exact capacity
        s.starts.resize(c);
        s.lengths.resize(c);
        index_range(buf, lo, hi, s.starts.data(), s.lengths.data(), 0, c);
      }
      s.starts.resize(c);
      s.lengths.resize(c);
    });
  for (auto& th : threads) th.join();
  int64_t total = 0;
  for (auto& s : spans) total += (int64_t)s.starts.size();
  if (total > cap) return -total;
  int64_t off = 0;
  for (auto& s : spans) {
    memcpy(starts + off, s.starts.data(), s.starts.size() * 8);
    memcpy(lengths + off, s.lengths.data(), s.lengths.size() * 4);
    off += (int64_t)s.starts.size();
  }
  return total;
}

// Gather indexed sequence lines into a PAD_BYTE-padded row-major
// [n_reads, width] matrix.  The pad byte 0x01 both passes the reference
// bloom (a false-pass alias, util.pxd:88-127) and encodes to code 0, so
// the device fused pack+validate can skip per-byte length masking
// (ops/bitpack.py pad_valid=True; constants.PAD_BYTE documents the
// contract).  Rows longer than width are truncated (callers size width
// from the max length that ssq_fastq_index reported).  Multi-threaded
// over rows.
void ssq_gather_padded(const char* buf, const int64_t* starts,
                       const int32_t* lengths, int64_t n_reads, int64_t width,
                       uint8_t* out) {
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = n_reads > 4096 ? (hw ? (int)hw : 4) : 1;
  int64_t chunk = (n_reads + nthreads - 1) / nthreads;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([=] {
      int64_t lo = t * chunk, hi = std::min(n_reads, lo + chunk);
      for (int64_t i = lo; i < hi; ++i) {
        uint8_t* row = out + i * width;
        int64_t len = lengths[i] < width ? lengths[i] : width;
        memcpy(row, buf + starts[i], (size_t)len);
        memset(row + len, 0x01, (size_t)(width - len));
      }
    });
  }
  for (auto& th : threads) th.join();
}

// Max of lengths[0..n) - lets the host size the padded matrix in one call.
int32_t ssq_max_length(const int32_t* lengths, int64_t n) {
  int32_t m = 0;
  for (int64_t i = 0; i < n; ++i)
    if (lengths[i] > m) m = lengths[i];
  return m;
}

// Find the first FASTQ record boundary at or after `offset`.
// A record boundary is a line start whose line begins with '@' and where the
// line two lines later begins with '+' (the separator line).  Returns the
// boundary offset, or n if none.  Used for multi-host byte-range sharding:
// host h parses [sync(h * n / H), sync((h + 1) * n / H)).
int64_t ssq_fastq_sync(const char* buf, int64_t n, int64_t offset) {
  if (offset <= 0) return 0;
  if (offset >= n) return n;  // past-the-end offsets would wrap the memchr
                              // count below to a huge size_t (OOB read)
  // Step to the next line start.
  const char* p = (const char*)memchr(buf + offset - 1, '\n', n - offset + 1);
  while (p) {
    const char* ls = p + 1;          // candidate line start
    if (ls >= buf + n) return n;
    if (*ls == '@') {
      // Look two lines ahead for the '+' separator.
      const char* nl1 = (const char*)memchr(ls, '\n', buf + n - ls);
      if (!nl1) return n;
      const char* nl2 = (const char*)memchr(nl1 + 1, '\n', buf + n - nl1 - 1);
      if (!nl2) return n;
      if (nl2 + 1 < buf + n && nl2[1] == '+') return ls - buf;
    }
    p = (const char*)memchr(ls, '\n', buf + n - ls);
  }
  return n;
}

// Pack ASCII bases straight to 2-bit words on the host (CPU fallback /
// oracle cross-check; the device path is ops/bitpack.py).  Packs row i of a
// [n_reads, width] matrix into words[i * width/16 ...], LSB-first,
// reproducing the reference layout (util.pyx:100-140).  width % 16 == 0.
// Returns 0, or 1 + index of the first row containing an invalid byte.
int64_t ssq_pack_rows(const uint8_t* mat, const int32_t* lengths,
                      int64_t n_reads, int64_t width, uint32_t* words) {
  const uint64_t kBloom = 0xFFFFFFFFFFEFFF75ull;  // reference util.pyx:75
  std::atomic<int64_t> bad{0};
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = n_reads > 4096 ? (hw ? (int)hw : 4) : 1;
  int64_t chunk = (n_reads + nthreads - 1) / nthreads;
  int64_t wpr = width / 16;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([=, &bad] {
      int64_t lo = t * chunk, hi = std::min(n_reads, lo + chunk);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* row = mat + i * width;
        uint32_t* w = words + i * wpr;
        int32_t len = lengths[i];
        for (int64_t j = 0; j < wpr; ++j) w[j] = 0;
        for (int32_t j = 0; j < len; ++j) {
          uint8_t c = row[j];
          if (kBloom & (1ull << (c & 63))) {
            int64_t want = 0;
            bad.compare_exchange_strong(want, i + 1);
            return;
          }
          w[j >> 4] |= ((uint32_t)((c >> 1) & 3)) << (2 * (j & 15));
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return bad.load();
}

// 4 ASCII bytes (u32, LSB = first byte) -> their 4 2-bit codes in the low
// byte.  code = (c >> 1) & 3 per byte; shifts {0,6,12,18} funnel code k
// from bit 8k to bit 2k, and no wrong (k, shift) pair lands below bit 8
// (the same SWAR identity as ops/bitpack._codes_byte).
static inline uint32_t pack4_codes(uint32_t v) {
  uint32_t c = (v >> 1) & 0x03030303u;
  return (c | (c >> 6) | (c >> 12) | (c >> 18)) & 0xFFu;
}

// 8 ASCII bytes (u64, LSB = first byte) -> their 8 2-bit codes in the low
// 16 bits.  Two independent 4-byte funnels: an 8-wide OR-doubling funnel
// would alias (code 3 >> 12 lands in code 6's slot), so it is not used.
static inline uint32_t pack8_codes(uint64_t v) {
  return pack4_codes((uint32_t)v) | (pack4_codes((uint32_t)(v >> 32)) << 8);
}

// Per-byte bloom test on 8 bytes at once: byte passes iff (c & 63) is one
// of {1, 3, 7, 20} (the reference bloom's exact pass set, util.pxd:88-127 -
// bits 6/7 never index the 64-bit bloom constant).  Returns nonzero iff any
// of the low `nbytes` bytes fails.
static inline uint64_t bad8_mask(uint64_t v, int nbytes) {
  const uint64_t kOnes = 0x0101010101010101ull;
  const uint64_t kHigh = 0x8080808080808080ull;
  uint64_t m = v & 0x3F3F3F3F3F3F3F3Full;
  uint64_t ok = 0;
  for (uint64_t t : {0x01ull, 0x03ull, 0x07ull, 0x14ull}) {
    uint64_t d = m ^ (t * kOnes);
    // Byte == t iff d's byte is 0.  d <= 0x7F per byte, so d + 0x7F*ones
    // never carries between bytes (max per-byte sum 0xFE) and bit 7 of the
    // sum is set iff the byte was nonzero - an exact, borrow-free zero
    // detect.  (The classic (d-ones)&~d&high trick is NOT used: its borrow
    // chain falsely flags a byte whose d==1 right after a d==0 byte, which
    // would silently accept e.g. '@' after 'A'.)
    ok |= ~(d + 0x7F7F7F7F7F7F7F7Full) & kHigh;
  }
  (void)kOnes;
  uint64_t inrange = nbytes >= 8 ? kHigh : (kHigh >> (8 * (8 - nbytes)));
  return ~ok & inrange;
}

// Gather indexed sequence lines and 2-bit pack them in one pass: row i
// (buf + starts[i], lengths[i] bytes, truncated to `width`) packs into
// words[i * width/16 ...], LSB-first per the reference layout
// (util.pyx:100-140), zero-padded past the row's length.  width % 16 == 0.
// Validation is the reference's exact bloom semantics.  Multi-threaded over
// rows.  Returns 0, or 1 + index of a row containing an invalid byte.
int64_t ssq_gather_pack(const char* buf, const int64_t* starts,
                        const int32_t* lengths, int64_t n_reads,
                        int64_t width, uint32_t* words) {
  std::atomic<int64_t> bad{0};
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = n_reads > 4096 ? (hw ? (int)hw : 4) : 1;
  int64_t chunk = (n_reads + nthreads - 1) / nthreads;
  int64_t wpr = width / 16;
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; ++t) {
    threads.emplace_back([=, &bad] {
      int64_t lo = t * chunk, hi = std::min(n_reads, lo + chunk);
      for (int64_t i = lo; i < hi; ++i) {
        const uint8_t* row = (const uint8_t*)(buf + starts[i]);
        uint32_t* w = words + i * wpr;
        int64_t len = lengths[i] < width ? lengths[i] : width;
        uint64_t any_bad = 0;
        int64_t j = 0;
        for (; j + 16 <= len; j += 16) {
          uint64_t a, b;
          memcpy(&a, row + j, 8);
          memcpy(&b, row + j + 8, 8);
          any_bad |= bad8_mask(a, 8) | bad8_mask(b, 8);
          w[j >> 4] = pack8_codes(a) | (pack8_codes(b) << 16);
        }
        if (j < len) {
          uint8_t tail[16] = {0};
          memcpy(tail, row + j, (size_t)(len - j));
          uint64_t a, b;
          memcpy(&a, tail, 8);
          memcpy(&b, tail + 8, 8);
          int rem = (int)(len - j);
          any_bad |= bad8_mask(a, rem < 8 ? rem : 8);
          if (rem > 8) any_bad |= bad8_mask(b, rem - 8);
          uint32_t word = pack8_codes(a) | (pack8_codes(b) << 16);
          // Zero-pad bytes encode to code 0 = the zeroed tail already.
          w[j >> 4] = word;
          j += 16;
        }
        for (int64_t k = j >> 4; k < wpr; ++k) w[k] = 0;
        if (any_bad) {
          int64_t want = 0;
          bad.compare_exchange_strong(want, i + 1);
          return;
        }
      }
    });
  }
  for (auto& th : threads) th.join();
  return bad.load();
}

// ---------------------------------------------------------------------------
// Host count engine: exact dedup of packed rows with a partitioned
// open-addressing hash table.  The single-host analogue of the device
// sort-unique-count (count/device.py) for runs where host<->device
// transfer dominates; same table contents, different engine.  The role of
// the reference's known-hash dict counting (counter.pyx:41-54), but
// batched and multi-threaded instead of object-at-a-time.

// splitmix64 finalizer - deterministic, well-mixed 64-bit hash.
static inline uint64_t mix64(uint64_t x) {
  x += 0x9E3779B97F4A7C15ull;
  x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
  x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
  return x ^ (x >> 31);
}

static inline uint64_t hash_row(const uint32_t* row, int64_t wpr,
                                int32_t len) {
  uint64_t h = mix64((uint64_t)(uint32_t)len);
  for (int64_t i = 0; i < wpr; ++i) h = mix64(h ^ row[i]);
  return h;
}

// Count exact-duplicate rows: words [n, wpr] uint32 + lengths [n] ->
// unique table (out_words [*, wpr], out_lengths, out_counts int64), first
// occurrence order within each hash partition.  Caller allocates outputs
// with capacity n rows.  Returns the number of unique rows.  When
// out_inverse is non-null it receives, per input row, the index of that
// row's unique entry in the output table (the np.unique(return_inverse)
// contract, at hash speed - the vectorized-grouping hook for UMI read
// dedup).
//
// Partitioned by high hash bits so each thread owns a disjoint slice of
// key space: no locks, deterministic counts.
// `weights` (nullable): per-row occurrence weights instead of 1 - the
// WEIGHTED count that merges already-deduped (rows, counts) tables
// exactly (streaming ingest: per-slice tables concatenated and
// re-counted with their counts as weights; api/counter.py).
static int64_t host_count_impl(const uint32_t* words, const int32_t* lengths,
                               int64_t n, int64_t wpr, uint32_t* out_words,
                               int32_t* out_lengths, int64_t* out_counts,
                               int64_t* out_inverse,
                               const int64_t* weights = nullptr) {
  if (n == 0) return 0;
  unsigned hw = std::thread::hardware_concurrency();
  int nthreads = 1;
  if (n > 16384) {
    nthreads = hw ? (int)hw : 4;
    if (nthreads > 16) nthreads = 16;
    while (nthreads & (nthreads - 1)) --nthreads;  // power of two partitions
  }

  std::vector<uint64_t> hashes((size_t)n);
  {
    std::vector<std::thread> threads;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t)
      threads.emplace_back([=, &hashes] {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        for (int64_t i = lo; i < hi; ++i)
          hashes[i] = hash_row(words + i * wpr, wpr, lengths[i]);
      });
    for (auto& th : threads) th.join();
  }

  // Per-partition tables: presized for the all-unique worst case
  // (load factor < 1/2 with no growth rehash) but capped so dup-heavy
  // giant inputs don't commit gigabytes of idle slots; past the cap the
  // insert loop grows on demand.
  struct Part {
    std::vector<int64_t> slot;    // row index of the unique occupant, or -1
    std::vector<int64_t> count;   // parallel to slot
    std::vector<int64_t> ord;     // parallel to slot: local unique id
    std::vector<int64_t> uniq;    // occupied slot ids, insertion order
  };
  std::vector<Part> parts(nthreads);
  std::vector<std::thread> threads;
  int shift = 64;
  for (int p = nthreads; p > 1; p >>= 1) --shift;  // top log2(P) bits
  for (int t = 0; t < nthreads; ++t)
    threads.emplace_back([=, &parts, &hashes] {
      Part& P = parts[t];
      size_t cap = 64;
      // 2x the per-partition mean keeps load factor < 1/2 with no growth
      // rehash for all-unique inputs (a rehash rebuilds every live
      // entry; the larger zero fill costs ~10 ms per 8M slots).  Capped
      // at 8M slots (192 MB of table per partition) so a dup-heavy 100M-
      // row call doesn't commit gigabytes of idle slots; beyond the cap
      // the grow path takes over.
      int64_t expect = 2 * (n / nthreads) + 64;
      if (expect > (int64_t)1 << 23) expect = (int64_t)1 << 23;
      while ((int64_t)cap < expect) cap <<= 1;
      P.slot.assign(cap, -1);
      P.count.assign(cap, 0);
      P.ord.assign(cap, 0);
      uint64_t mask = cap - 1;
      // Software-prefetch upcoming probe slots: the first probe of each
      // insert is a random cacheline in a table far larger than L2, so
      // the loop is latency-bound without it.  Stale prefetches after a
      // grow (mask changed) are merely useless, never wrong.
      const int64_t kPf = 16;
      int64_t pf = 0;
      for (int64_t i = 0; i < n; ++i) {
        for (; pf < n && pf < i + kPf; ++pf) {
          uint64_t hp = hashes[pf];
          if (nthreads == 1 || (int)(hp >> shift) == t)
            __builtin_prefetch(&P.slot[hp & mask], 0, 1);
        }
        uint64_t h = hashes[i];
        if (nthreads > 1 && (int)(h >> shift) != t) continue;
        size_t s = (size_t)(h & mask);
        for (;;) {
          int64_t occ = P.slot[s];
          if (occ < 0) {
            if (P.uniq.size() * 2 >= cap) {  // grow: keep load factor < 1/2
              size_t ncap = cap * 2;
              std::vector<int64_t> nslot(ncap, -1), ncount(ncap, 0);
              std::vector<int64_t> nord(ncap, 0);
              uint64_t nmask = ncap - 1;
              std::vector<int64_t> nuniq;
              nuniq.reserve(P.uniq.size() + 1);
              for (int64_t old_s : P.uniq) {
                int64_t row = P.slot[old_s];
                size_t q = (size_t)(hashes[row] & nmask);
                while (nslot[q] >= 0) q = (q + 1) & nmask;
                nslot[q] = row;
                ncount[q] = P.count[old_s];
                nord[q] = P.ord[old_s];
                nuniq.push_back((int64_t)q);
              }
              P.slot.swap(nslot);
              P.count.swap(ncount);
              P.ord.swap(nord);
              P.uniq.swap(nuniq);
              cap = ncap;
              mask = nmask;
              s = (size_t)(h & mask);
              continue;
            }
            P.slot[s] = i;
            P.count[s] = weights ? weights[i] : 1;
            P.ord[s] = (int64_t)P.uniq.size();
            P.uniq.push_back((int64_t)s);
            if (out_inverse) out_inverse[i] = P.ord[s];
            break;
          }
          if (hashes[occ] == h && lengths[occ] == lengths[i] &&
              memcmp(words + occ * wpr, words + i * wpr,
                     (size_t)wpr * 4) == 0) {
            P.count[s] += weights ? weights[i] : 1;
            if (out_inverse) out_inverse[i] = P.ord[s];
            break;
          }
          s = (s + 1) & mask;
        }
      }
    });
  for (auto& th : threads) th.join();

  // Emit: prefix-sum partition sizes, then parallel writes.
  std::vector<int64_t> offs(nthreads + 1, 0);
  for (int t = 0; t < nthreads; ++t)
    offs[t + 1] = offs[t] + (int64_t)parts[t].uniq.size();
  std::vector<std::thread> writers;
  for (int t = 0; t < nthreads; ++t)
    writers.emplace_back([=, &parts] {
      Part& P = parts[t];
      int64_t o = offs[t];
      for (int64_t s : P.uniq) {
        int64_t row = P.slot[s];
        memcpy(out_words + o * wpr, words + row * wpr, (size_t)wpr * 4);
        out_lengths[o] = lengths[row];
        out_counts[o] = P.count[s];
        ++o;
      }
    });
  for (auto& th : writers) th.join();

  if (out_inverse) {
    // Local unique ids -> global output indices (partition base offsets).
    std::vector<std::thread> fixers;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; ++t)
      fixers.emplace_back([=, &hashes, &offs] {
        int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
        for (int64_t i = lo; i < hi; ++i) {
          int p = nthreads > 1 ? (int)(hashes[i] >> shift) : 0;
          out_inverse[i] += offs[p];
        }
      });
    for (auto& th : fixers) th.join();
  }
  return offs[nthreads];
}

int64_t ssq_host_count(const uint32_t* words, const int32_t* lengths,
                       int64_t n, int64_t wpr, uint32_t* out_words,
                       int32_t* out_lengths, int64_t* out_counts) {
  return host_count_impl(words, lengths, n, wpr, out_words, out_lengths,
                         out_counts, nullptr);
}

int64_t ssq_host_count_inv(const uint32_t* words, const int32_t* lengths,
                           int64_t n, int64_t wpr, uint32_t* out_words,
                           int32_t* out_lengths, int64_t* out_counts,
                           int64_t* out_inverse) {
  return host_count_impl(words, lengths, n, wpr, out_words, out_lengths,
                         out_counts, out_inverse);
}

int64_t ssq_host_count_w(const uint32_t* words, const int32_t* lengths,
                         const int64_t* weights, int64_t n, int64_t wpr,
                         uint32_t* out_words, int32_t* out_lengths,
                         int64_t* out_counts) {
  return host_count_impl(words, lengths, n, wpr, out_words, out_lengths,
                         out_counts, nullptr, weights);
}

// Greedy count-ordered UMI collapse (umi/dedup._greedy_absorb, the
// umi_tools adjacency/directional semantics): visit nodes in `order`
// (descending count, ties by index); an unassigned node roots a cluster
// and absorbs unassigned neighbours - direct only for adjacency
// (directional == 0), or transitively through edges satisfying
// count(u) >= 2 * count(v) - 1 for directional.  Inherently sequential
// (a later root may not steal an earlier root's nodes), so the win over
// the Python walk is pure interpreter overhead: ~1 us/edge -> ~10 ns.
// Graph is CSR: indptr [u+1], indices [indptr[u]].
void ssq_greedy_absorb(const int64_t* indptr, const int64_t* indices,
                       const int64_t* counts, const int64_t* order,
                       int64_t u, int32_t directional, int64_t* labels) {
  for (int64_t i = 0; i < u; ++i) labels[i] = -1;
  std::vector<int64_t> stack;
  for (int64_t oi = 0; oi < u; ++oi) {
    const int64_t root = order[oi];
    if (labels[root] >= 0) continue;
    labels[root] = root;
    if (!directional) {
      for (int64_t p = indptr[root]; p < indptr[root + 1]; ++p) {
        const int64_t nbr = indices[p];
        if (labels[nbr] < 0) labels[nbr] = root;
      }
      continue;
    }
    stack.clear();
    stack.push_back(root);
    while (!stack.empty()) {
      const int64_t node = stack.back();
      stack.pop_back();
      const int64_t cn = counts[node];
      for (int64_t p = indptr[node]; p < indptr[node + 1]; ++p) {
        const int64_t nbr = indices[p];
        if (labels[nbr] >= 0) continue;
        if (cn < 2 * counts[nbr] - 1) continue;
        labels[nbr] = root;
        stack.push_back(nbr);
      }
    }
  }
}

}  // extern "C"
