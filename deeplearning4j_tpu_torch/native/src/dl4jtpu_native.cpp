// Native host-side runtime for deeplearning4j_tpu_torch (the port's copy
// of deeplearning4j_tpu/native/src/dl4jtpu_native.cpp).
//
// The reference's hot host paths are native (libnd4j C++ buffers, DataVec
// ETL — SURVEY §2.9); here the device math is PyTorch's and the port's
// CUDA kernels' job, so the native seam is the input pipeline: CSV ->
// dense matrix parsing and corpus word counting (Word2Vec vocab
// construction, reference
// `wordstore/VocabConstructor.java` whose inner loop is the tokenize+count
// pass over the corpus).
//
// Plain C ABI, loaded with ctypes.
// Build: native/loader.py (g++ -O3 -std=c++17 -shared -fPIC), into _build/.

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct CsvResult {
  std::vector<double> data;
  int64_t rows = 0;
  int64_t cols = 0;
  bool ok = false;  // false => non-numeric or ragged; caller falls back
};

// Read a whole file into memory. Returns false on IO error.
bool read_file(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (n < 0) { std::fclose(f); return false; }
  out->resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(&(*out)[0], 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------- CSV parse
// Parses an all-numeric rectangular CSV into a dense row-major double
// matrix in one pass (strtod over a single in-memory buffer — no per-line
// allocation). If any token fails to parse or rows are ragged, ok=0 and the
// Python caller uses its general (string-aware) fallback.

void* dl4j_csv_parse(const char* path, int skip_lines, char delim) {
  auto* res = new CsvResult();
  std::string buf;
  if (!read_file(path, &buf)) return res;  // ok=false
  const char* p = buf.data();
  const char* end = p + buf.size();
  // skip header lines
  for (int s = 0; s < skip_lines && p < end; ++s) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  int64_t cols = -1;
  std::vector<double> row;
  while (p < end) {
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;
    // skip truly empty lines only (the Python path does the same);
    // whitespace-only lines are NOT numeric CSV -> bail to the fallback so
    // both paths agree on them
    bool empty = (p == line_end);
    bool ws_only = !empty;
    for (const char* q = p; q < line_end; ++q)
      if (!std::isspace(static_cast<unsigned char>(*q))) { ws_only = false; break; }
    if (ws_only) { delete res; return new CsvResult(); }
    if (!empty) {
      row.clear();
      const char* q = p;
      while (q <= line_end) {
        const char* tok_end = q;
        while (tok_end < line_end && *tok_end != delim) ++tok_end;
        // strtod accepts hex floats ("0x1F") that Python's float() rejects:
        // any x/X in the token means this is not plain-decimal CSV -> bail
        for (const char* r = q; r < tok_end; ++r)
          if (*r == 'x' || *r == 'X') { delete res; return new CsvResult(); }
        char* conv_end = nullptr;
        // strtod stops at delim/newline; ensure token non-empty
        double v = std::strtod(q, &conv_end);
        if (conv_end == q || conv_end > tok_end) { delete res; return new CsvResult(); }
        // only whitespace may remain between number and delimiter
        for (const char* r = conv_end; r < tok_end; ++r)
          if (!std::isspace(static_cast<unsigned char>(*r))) { delete res; return new CsvResult(); }
        row.push_back(v);
        if (tok_end >= line_end) break;
        q = tok_end + 1;
      }
      if (cols < 0) cols = static_cast<int64_t>(row.size());
      if (static_cast<int64_t>(row.size()) != cols) { delete res; res = new CsvResult(); return res; }
      res->data.insert(res->data.end(), row.begin(), row.end());
      ++res->rows;
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  res->cols = cols < 0 ? 0 : cols;
  res->ok = true;
  return res;
}

int dl4j_csv_ok(void* h) { return static_cast<CsvResult*>(h)->ok ? 1 : 0; }
int64_t dl4j_csv_rows(void* h) { return static_cast<CsvResult*>(h)->rows; }
int64_t dl4j_csv_cols(void* h) { return static_cast<CsvResult*>(h)->cols; }
const double* dl4j_csv_data(void* h) {
  return static_cast<CsvResult*>(h)->data.data();
}
void dl4j_csv_free(void* h) { delete static_cast<CsvResult*>(h); }

// ------------------------------------------------------------ word counting
// Whitespace-tokenizing word counter over text files — the inner loop of
// vocab construction. Counts are serialized as "word\tcount\n" lines into a
// malloc'd buffer the Python side parses (strings can't cross a plain C ABI
// any cheaper without a real binding layer).

struct WordCounter {
  std::unordered_map<std::string, int64_t> counts;
  int64_t total = 0;
};

void* dl4j_wc_create() { return new WordCounter(); }

int dl4j_wc_add_file(void* h, const char* path, int lowercase) {
  auto* wc = static_cast<WordCounter*>(h);
  std::string buf;
  if (!read_file(path, &buf)) return 0;
  const char* p = buf.data();
  const char* end = p + buf.size();
  std::string word;
  while (p <= end) {
    char c = (p < end) ? *p : ' ';
    if (std::isspace(static_cast<unsigned char>(c))) {
      if (!word.empty()) {
        ++wc->counts[word];
        ++wc->total;
        word.clear();
      }
    } else {
      word.push_back(lowercase ? static_cast<char>(
          std::tolower(static_cast<unsigned char>(c))) : c);
    }
    ++p;
  }
  return 1;
}

int64_t dl4j_wc_total(void* h) { return static_cast<WordCounter*>(h)->total; }
int64_t dl4j_wc_unique(void* h) {
  return static_cast<int64_t>(static_cast<WordCounter*>(h)->counts.size());
}

// Serialize counts; caller frees with dl4j_buf_free. Returns byte length.
int64_t dl4j_wc_serialize(void* h, char** out) {
  auto* wc = static_cast<WordCounter*>(h);
  std::string s;
  s.reserve(wc->counts.size() * 16);
  char num[32];
  for (const auto& kv : wc->counts) {
    s.append(kv.first);
    std::snprintf(num, sizeof num, "\t%lld\n",
                  static_cast<long long>(kv.second));
    s.append(num);
  }
  *out = static_cast<char*>(std::malloc(s.size()));
  if (*out == nullptr) return -1;
  std::memcpy(*out, s.data(), s.size());
  return static_cast<int64_t>(s.size());
}

void dl4j_buf_free(char* p) { std::free(p); }
void dl4j_wc_free(void* h) { delete static_cast<WordCounter*>(h); }

}  // extern "C"
