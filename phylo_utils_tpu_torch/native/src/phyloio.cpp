// Native host-side data path: alignment column (site-pattern) compression
// (the PyTorch port's copy of phylo_utils_tpu/native/src/phyloio.cpp).
//
// The compute path runs on the card (phylo_utils_tpu_torch/csrc); this C++
// module is the host's data-loader stage: it turns a character matrix into
// unique site patterns + weights before the upload to the device.
// Hash-based single pass, O(sites x taxa), vs numpy's sort-based unique
// (O(sites x taxa log sites)); patterns come out in order of first
// occurrence.
//
// Exposed via ctypes; see phylo_utils_tpu_torch/native/__init__.py, which
// builds it with g++ at first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>

extern "C" {

// Collapse identical alignment columns.
//   seqs            (n_seqs x n_sites) uint8, row-major
//   site_to_pattern (n_sites)  out: pattern id per site
//   pattern_sites   (n_sites)  out: first-occurrence site per pattern
//                              (entries [0, n_patterns) valid)
//   counts          (n_sites)  out: pattern multiplicities (same validity)
// Returns n_patterns, or -1 on allocation failure.
int64_t pu_compress_columns(const uint8_t* seqs, int64_t n_seqs,
                            int64_t n_sites, int32_t* site_to_pattern,
                            int32_t* pattern_sites, int64_t* counts) {
  if (n_seqs <= 0 || n_sites <= 0) return 0;
  try {
    // Transpose to site-major so each column is a contiguous hash key.
    std::vector<uint8_t> cols(static_cast<size_t>(n_seqs) * n_sites);
    constexpr int64_t kBlock = 64;  // cache-blocked transpose
    for (int64_t i0 = 0; i0 < n_seqs; i0 += kBlock) {
      const int64_t i1 = std::min(i0 + kBlock, n_seqs);
      for (int64_t s0 = 0; s0 < n_sites; s0 += kBlock) {
        const int64_t s1 = std::min(s0 + kBlock, n_sites);
        for (int64_t i = i0; i < i1; ++i)
          for (int64_t s = s0; s < s1; ++s)
            cols[static_cast<size_t>(s) * n_seqs + i] =
                seqs[static_cast<size_t>(i) * n_sites + s];
      }
    }

    std::unordered_map<std::string_view, int32_t> ids;
    ids.reserve(static_cast<size_t>(n_sites) * 2);
    int32_t n_patterns = 0;
    for (int64_t s = 0; s < n_sites; ++s) {
      std::string_view key(
          reinterpret_cast<const char*>(cols.data() +
                                        static_cast<size_t>(s) * n_seqs),
          static_cast<size_t>(n_seqs));
      auto [it, inserted] = ids.emplace(key, n_patterns);
      if (inserted) {
        pattern_sites[n_patterns] = static_cast<int32_t>(s);
        counts[n_patterns] = 0;
        ++n_patterns;
      }
      site_to_pattern[s] = it->second;
      ++counts[it->second];
    }
    return n_patterns;
  } catch (...) {
    return -1;
  }
}

// Map characters to state-row indices through a 256-entry LUT (e.g. an
// uppercase fold or char->row-id table) in one pass; out may alias in.
void pu_map_bytes(const uint8_t* in, int64_t n, const uint8_t* lut256,
                  uint8_t* out) {
  for (int64_t i = 0; i < n; ++i) out[i] = lut256[in[i]];
}

static inline bool is_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\r' || c == '\n' || c == '\v' ||
         c == '\f';
}

// Pass 1 over a raw FASTA buffer: count records, validate equal sequence
// lengths. Returns n_seqs (>=0), -2 on ragged lengths, -3 on no records.
int64_t pu_fasta_scan(const uint8_t* buf, int64_t n, int64_t* seq_len_out) {
  int64_t n_seqs = 0, cur_len = 0, seq_len = -1;
  bool in_header = false, have_record = false;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = buf[i];
    if (in_header) {
      if (c == '\n') in_header = false;
      continue;
    }
    if (c == '>') {
      if (have_record) {
        if (seq_len < 0) seq_len = cur_len;
        else if (cur_len != seq_len) return -2;
      }
      have_record = true;
      ++n_seqs;
      cur_len = 0;
      in_header = true;
    } else if (!is_space(c)) {
      ++cur_len;
    }
  }
  if (!have_record) return -3;
  if (seq_len < 0) seq_len = cur_len;
  else if (cur_len != seq_len) return -2;
  *seq_len_out = seq_len;
  return n_seqs;
}

// Pass 2: write the (n_seqs x seq_len) uppercased character matrix and the
// [start, end) byte ranges of each record's name line (after '>').
// Returns 0 on success.
int64_t pu_fasta_parse(const uint8_t* buf, int64_t n, int64_t n_seqs,
                       int64_t seq_len, const uint8_t* upper_lut,
                       uint8_t* matrix, int64_t* name_ranges /* 2*n_seqs */) {
  int64_t seq = -1, pos = 0;
  bool in_header = false;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t c = buf[i];
    if (in_header) {
      if (c == '\n' || i == n - 1) {
        name_ranges[2 * seq + 1] = (c == '\n') ? i : i + 1;
        in_header = false;
      }
      continue;
    }
    if (c == '>') {
      ++seq;
      if (seq >= n_seqs) return -1;
      name_ranges[2 * seq] = i + 1;
      name_ranges[2 * seq + 1] = i + 1;
      pos = 0;
      in_header = true;
    } else if (!is_space(c)) {
      if (seq < 0 || pos >= seq_len) return -1;
      matrix[seq * seq_len + pos] = upper_lut[c];
      ++pos;
    }
  }
  return 0;
}

}  // extern "C"
