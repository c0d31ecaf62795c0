// Native corpus analyzer (the port's copy of intool_rag_tpu/native/analyzer.cc):
// UTF-8 tokenization (latin words + CJK bigrams, stopword filter, the rules
// of index/analyzer.py::tokenize_py) and corpus-level term counting.
// Where the two differ, this one is what both packages serve: every
// non-ASCII code point outside the punctuation blocks below is a word
// character here, so a symbol such as the euro sign stays inside its word
// ("5€"), where Python's \w splits it off.
//
// This is the host-side ingest hot loop (BM25 vocabulary + per-doc term
// counts) and the query-time term analysis. Exposed over a C ABI consumed
// via ctypes (native/__init__.py), which builds it with g++ on first use.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <string_view>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---- unicode helpers ----

// decode one UTF-8 codepoint; advances i
inline uint32_t decode_utf8(const unsigned char* s, size_t n, size_t& i) {
  uint32_t c = s[i];
  if (c < 0x80) { i += 1; return c; }
  if ((c >> 5) == 0x6 && i + 1 < n) {
    uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
    i += 2; return cp;
  }
  if ((c >> 4) == 0xE && i + 2 < n) {
    uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
    i += 3; return cp;
  }
  if ((c >> 3) == 0x1E && i + 3 < n) {
    uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                  ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
    i += 4; return cp;
  }
  i += 1;  // invalid byte: skip
  return 0xFFFD;
}

inline void encode_utf8(uint32_t cp, std::string& out) {
  if (cp < 0x80) out.push_back(static_cast<char>(cp));
  else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

inline bool is_cjk(uint32_t cp) {
  return (cp >= 0x3040 && cp <= 0x30FF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0xAC00 && cp <= 0xD7AF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x20000 && cp <= 0x2A6DF);
}

inline bool is_digit_cp(uint32_t cp) { return cp >= '0' && cp <= '9'; }

inline bool is_word_cp(uint32_t cp) {
  if (cp == '_') return true;
  if (cp < 0x80)
    return (cp >= 'a' && cp <= 'z') || (cp >= 'A' && cp <= 'Z') || is_digit_cp(cp);
  // treat all non-ASCII letters/ideographs as word chars (Python \w
  // matches unicode letters; digits-only checked separately)
  // exclude common punctuation blocks
  if (cp >= 0x2000 && cp <= 0x206F) return false;  // general punctuation
  if (cp >= 0x3000 && cp <= 0x303F) return false;  // CJK punctuation
  if (cp >= 0xFF00 && cp <= 0xFF0F) return false;
  if (cp >= 0xFF1A && cp <= 0xFF20) return false;
  if (cp >= 0xFF3B && cp <= 0xFF40) return false;
  if (cp >= 0xFF5B && cp <= 0xFF65) return false;
  return true;
}

inline uint32_t to_lower_cp(uint32_t cp) {
  if (cp >= 'A' && cp <= 'Z') return cp + 32;
  // Latin-1 supplement
  if (cp >= 0xC0 && cp <= 0xDE && cp != 0xD7) return cp + 32;
  return cp;
}

// NFKC-lite: fullwidth ASCII -> ASCII (the dominant NFKC case for search)
inline uint32_t nfkc_lite(uint32_t cp) {
  if (cp >= 0xFF01 && cp <= 0xFF5E) return cp - 0xFEE0;
  if (cp == 0x3000) return ' ';
  return cp;
}

const std::unordered_set<std::string_view> kStopwords = {
    "a", "an", "and", "are", "as", "at", "be", "but", "by", "for", "from",
    "has", "have", "if", "in", "into", "is", "it", "its", "of", "on", "or",
    "that", "the", "their", "then", "there", "these", "this", "to", "was",
    "were", "will", "with"};

struct Run {
  std::vector<uint32_t> cps;
  bool cjk = false;
  bool all_digit = true;
};

template <typename Emit>
void tokenize_text(const unsigned char* data, size_t len, Emit&& emit) {
  size_t i = 0;
  Run run;
  std::string buf;

  auto flush = [&]() {
    if (run.cps.empty()) return;
    if (run.cjk) {
      if (run.cps.size() == 1) {
        buf.clear();
        encode_utf8(run.cps[0], buf);
        emit(std::string_view(buf));
      } else {
        for (size_t j = 0; j + 1 < run.cps.size(); ++j) {
          buf.clear();
          encode_utf8(run.cps[j], buf);
          encode_utf8(run.cps[j + 1], buf);
          emit(std::string_view(buf));
        }
      }
    } else {
      buf.clear();
      for (uint32_t cp : run.cps) encode_utf8(cp, buf);
      if (run.cps.size() > 1) {
        if (kStopwords.find(std::string_view(buf)) == kStopwords.end())
          emit(std::string_view(buf));
      } else if (run.all_digit) {
        emit(std::string_view(buf));
      }
    }
    run.cps.clear();
    run.all_digit = true;
  };

  while (i < len) {
    uint32_t cp = decode_utf8(data, len, i);
    cp = nfkc_lite(cp);
    cp = to_lower_cp(cp);
    if (!is_word_cp(cp)) {
      flush();
      continue;
    }
    bool cjk = is_cjk(cp);
    if (!run.cps.empty() && cjk != run.cjk) flush();
    run.cjk = cjk;
    if (!is_digit_cp(cp)) run.all_digit = false;
    run.cps.push_back(cp);
  }
  flush();
}

// ---- corpus build result (owned by C++, freed via free_corpus) ----

struct CorpusResult {
  std::string vocab_blob;            // concatenated term strings
  std::vector<int64_t> vocab_offsets;  // [V+1]
  std::vector<int32_t> df;             // [V]
  std::vector<int64_t> doc_indptr;     // [n_docs+1] into pairs
  std::vector<int32_t> pair_terms;     // [nnz]
  std::vector<int32_t> pair_counts;    // [nnz]
  std::vector<int32_t> doc_len;        // [n_docs] total tokens
  std::vector<int32_t> first_seen;     // [V] rank of each (sorted) term in first-seen order
};

}  // namespace

extern "C" {

// Analyze a corpus: docs = concatenated UTF-8; offsets[n_docs+1] byte
// offsets. Returns an opaque handle; read sizes via corpus_sizes, copy
// arrays via corpus_copy_*, free via free_corpus.
void* build_corpus(const char* docs, const int64_t* offsets, int64_t n_docs) {
  auto* res = new CorpusResult();
  // term -> id, insertion keyed by first-seen; sorted remap at the end
  std::unordered_map<std::string, int32_t> vocab;
  vocab.reserve(1 << 16);
  std::vector<std::string> terms;

  std::unordered_map<int32_t, int32_t> doc_counts;
  res->doc_indptr.push_back(0);
  for (int64_t d = 0; d < n_docs; ++d) {
    const auto* start = reinterpret_cast<const unsigned char*>(docs) + offsets[d];
    size_t len = static_cast<size_t>(offsets[d + 1] - offsets[d]);
    doc_counts.clear();
    int32_t total = 0;
    tokenize_text(start, len, [&](std::string_view tok) {
      total++;
      auto it = vocab.find(std::string(tok));
      int32_t id;
      if (it == vocab.end()) {
        id = static_cast<int32_t>(terms.size());
        terms.emplace_back(tok);
        vocab.emplace(terms.back(), id);
      } else {
        id = it->second;
      }
      doc_counts[id]++;
    });
    res->doc_len.push_back(total);
    for (auto& [tid, tf] : doc_counts) {
      res->pair_terms.push_back(tid);
      res->pair_counts.push_back(tf);
    }
    res->doc_indptr.push_back(static_cast<int64_t>(res->pair_terms.size()));
  }

  // sort vocabulary lexicographically (matches Python's sorted(df)) and
  // remap ids
  std::vector<int32_t> order(terms.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = static_cast<int32_t>(i);
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return terms[a] < terms[b];
  });
  res->first_seen = order;
  std::vector<int32_t> remap(terms.size());
  for (size_t rank = 0; rank < order.size(); ++rank)
    remap[order[rank]] = static_cast<int32_t>(rank);

  res->vocab_offsets.push_back(0);
  for (int32_t old_id : order) {
    res->vocab_blob += terms[old_id];
    res->vocab_offsets.push_back(static_cast<int64_t>(res->vocab_blob.size()));
  }
  res->df.assign(terms.size(), 0);
  for (auto& t : res->pair_terms) {
    t = remap[t];
  }
  for (size_t d = 0; d + 1 < res->doc_indptr.size(); ++d) {
    for (int64_t j = res->doc_indptr[d]; j < res->doc_indptr[d + 1]; ++j)
      res->df[res->pair_terms[j]]++;
  }
  return res;
}

void corpus_sizes(void* handle, int64_t* out) {
  auto* r = static_cast<CorpusResult*>(handle);
  out[0] = static_cast<int64_t>(r->df.size());           // V
  out[1] = static_cast<int64_t>(r->pair_terms.size());   // nnz
  out[2] = static_cast<int64_t>(r->vocab_blob.size());   // blob bytes
  out[3] = static_cast<int64_t>(r->doc_len.size());      // n_docs
}

void corpus_copy(void* handle, char* blob, int64_t* vocab_offsets, int32_t* df,
                 int64_t* doc_indptr, int32_t* pair_terms, int32_t* pair_counts,
                 int32_t* doc_len) {
  auto* r = static_cast<CorpusResult*>(handle);
  std::memcpy(blob, r->vocab_blob.data(), r->vocab_blob.size());
  std::memcpy(vocab_offsets, r->vocab_offsets.data(),
              r->vocab_offsets.size() * sizeof(int64_t));
  std::memcpy(df, r->df.data(), r->df.size() * sizeof(int32_t));
  std::memcpy(doc_indptr, r->doc_indptr.data(),
              r->doc_indptr.size() * sizeof(int64_t));
  std::memcpy(pair_terms, r->pair_terms.data(),
              r->pair_terms.size() * sizeof(int32_t));
  std::memcpy(pair_counts, r->pair_counts.data(),
              r->pair_counts.size() * sizeof(int32_t));
  std::memcpy(doc_len, r->doc_len.data(), r->doc_len.size() * sizeof(int32_t));
}

// The first-seen rank of each term of the sorted vocabulary: the order in
// which a tokenizing pass over the corpus meets them.
void corpus_first_seen(void* handle, int32_t* out) {
  auto* r = static_cast<CorpusResult*>(handle);
  std::memcpy(out, r->first_seen.data(), r->first_seen.size() * sizeof(int32_t));
}

void free_corpus(void* handle) { delete static_cast<CorpusResult*>(handle); }

// Tokenize one text: writes tokens as len-prefixed UTF-8 into out (cap
// bytes); returns token count (tokens beyond cap are dropped).
int64_t tokenize_one(const char* text, int64_t len, char* out, int64_t cap,
                     int64_t* n_written_bytes) {
  int64_t count = 0;
  int64_t pos = 0;
  tokenize_text(reinterpret_cast<const unsigned char*>(text),
                static_cast<size_t>(len), [&](std::string_view tok) {
    int64_t need = static_cast<int64_t>(tok.size()) + 2;
    if (pos + need > cap) return;
    out[pos] = static_cast<char>(tok.size() & 0xFF);
    out[pos + 1] = static_cast<char>((tok.size() >> 8) & 0xFF);
    std::memcpy(out + pos + 2, tok.data(), tok.size());
    pos += need;
    count++;
  });
  *n_written_bytes = pos;
  return count;
}

}  // extern "C"
