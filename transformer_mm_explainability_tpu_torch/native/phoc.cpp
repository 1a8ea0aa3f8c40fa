// PHOC (Pyramidal Histogram Of Characters) text descriptor, C++.
//
// The port's copy of ``transformer_mm_explainability_tpu/native/phoc.cpp``,
// unchanged.
//
// Native equivalent of the reference's single C extension
// (VisualBERT/mmf/utils/phoc/src/cphoc.c — the repo's only native op),
// re-implemented as a plain C ABI for ctypes with a batch API.
//
// Layout (604 dims): unigram pyramid levels 2..5 over the 36-symbol
// alphabet [a-z0-9] (region-major inside each level: (2+3+4+5)*36 = 504)
// followed by a level-2 pyramid over the 50 most frequent English
// bigrams (2*50 = 100). A symbol/bigram fires in a region when at least
// half of its normalised span overlaps the region.

#include <cstring>
#include <string>

namespace {

constexpr int kPhocDim = 604;
constexpr int kNumUnigrams = 36;
constexpr int kNumBigrams = 50;
constexpr const char* kBigrams[kNumBigrams] = {
    "th", "he", "in", "er", "an", "re", "es", "on", "st", "nt",
    "en", "at", "ed", "nd", "to", "or", "ea", "ti", "ar", "te",
    "ng", "al", "it", "as", "is", "ha", "et", "se", "ou", "of",
    "le", "sa", "ve", "ro", "ra", "ri", "hi", "ne", "me", "de",
    "co", "ta", "ec", "si", "ll", "so", "na", "li", "la", "el"};

inline int unigram_index(char c) {
  if (c >= 'a' && c <= 'z') return c - 'a';
  if (c >= '0' && c <= '9') return 26 + (c - '0');
  return -1;
}

inline int bigram_index(const char* s) {
  for (int k = 0; k < kNumBigrams; ++k) {
    if (s[0] == kBigrams[k][0] && s[1] == kBigrams[k][1]) return k;
  }
  return -1;
}

// fraction of the span [s0, s1) overlapping region r of `level` equal
// splits of [0, 1); fires when >= 0.5
inline bool occupies(float s0, float s1, int region, int level) {
  const float r0 = static_cast<float>(region) / level;
  const float r1 = static_cast<float>(region + 1) / level;
  const float lo = s0 > r0 ? s0 : r0;
  const float hi = s1 < r1 ? s1 : r1;
  return (hi - lo) / (s1 - s0) >= 0.5f;
}

}  // namespace

extern "C" {

// Returns 0 on success, -1 on unknown character. `out` must hold 604
// floats; it is zero-initialised here.
int phoc_build(const char* word, float* out) {
  std::memset(out, 0, kPhocDim * sizeof(float));
  const int n = static_cast<int>(std::strlen(word));
  if (n == 0) return 0;

  for (int i = 0; i < n; ++i) {
    const int ci = unigram_index(word[i]);
    if (ci < 0) return -1;
    const float c0 = static_cast<float>(i) / n;
    const float c1 = static_cast<float>(i + 1) / n;
    int level_base = 0;  // cumulative regions of previous levels
    for (int level = 2; level <= 5; ++level) {
      for (int region = 0; region < level; ++region) {
        if (occupies(c0, c1, region, level)) {
          out[(level_base + region) * kNumUnigrams + ci] = 1.0f;
        }
      }
      level_base += level;
    }
  }

  const int bigram_offset = (2 + 3 + 4 + 5) * kNumUnigrams;
  for (int i = 0; i + 1 < n; ++i) {
    const int bi = bigram_index(word + i);
    if (bi < 0) continue;
    const float b0 = static_cast<float>(i) / n;
    const float b1 = static_cast<float>(i + 2) / n;
    for (int region = 0; region < 2; ++region) {
      if (occupies(b0, b1, region, 2)) {
        out[bigram_offset + region * kNumBigrams + bi] = 1.0f;
      }
    }
  }
  return 0;
}

// Batch API: `words` is a NUL-separated blob of `count` words; output
// is [count, 604]. Returns the index of the first failing word or -1.
int phoc_build_batch(const char* words, int count, float* out) {
  const char* p = words;
  for (int i = 0; i < count; ++i) {
    if (phoc_build(p, out + i * kPhocDim) != 0) return i;
    p += std::strlen(p) + 1;
  }
  return -1;
}

int phoc_dim() { return kPhocDim; }

}  // extern "C"
