// Native CSV codec for cylon_tpu_torch (the port's copy of the JAX
// package's codec, the same code).
//
// Reference analog: the reference reads CSV through Arrow's native C++
// csv::TableReader over a memory-mapped file (io/arrow_io.cpp:33-61) and
// writes via a row-wise ostream printer (table.cpp:244-253,854-900). This is
// the same role, built standalone: mmap + multithreaded tokenize + typed
// parse + dictionary-encoded strings, exposed over a plain C ABI loaded with
// ctypes (no pybind11 in the image).
//
// Output column model matches cylon_tpu_torch.Column.encode_host:
//   INT64 / FLOAT64 / BOOL buffers + uint8 validity, and STRING columns as
//   int32 codes against a *sorted* dictionary (code order == value order).
//
// Build: g++ -std=c++20 -O3 -fPIC -shared -pthread csv.cpp runtime.cpp -o libcylon_native.so
// (done by cylon_tpu_torch.native.get_lib, into build/cylon_tpu_torch/)

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cmath>
#if !(defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L)
#include <locale.h>  // newlocale/strtod_l for the pre-C++17-to_chars fallback
#endif
#include <memory>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

enum ColType : int32_t { CT_INT64 = 0, CT_FLOAT64 = 1, CT_BOOL = 2, CT_STRING = 3 };

struct Cell {
  uint64_t off;
  uint32_t len;
  uint32_t quoted;  // field contained quotes -> needs unescape
};

struct Column {
  int32_t type = CT_INT64;
  std::vector<int64_t> i64;
  std::vector<double> f64;
  std::vector<uint8_t> b8;
  std::vector<int32_t> codes;
  std::vector<uint8_t> valid;  // 1 = non-null
  bool any_null = false;
  std::vector<std::string> dict;           // sorted
  std::vector<const char*> dict_cstr;      // stable c_str pointers
};

struct Table {
  std::vector<std::string> names;
  std::vector<const char*> name_cstr;
  std::vector<Column> cols;
  int64_t nrows = 0;
  std::string error;
};

struct Mapped {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;
  bool is_mmap = false;
  std::string fallback;

  ~Mapped() {
    if (is_mmap && data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) close(fd);
  }
};

bool map_file(const char* path, Mapped* m, std::string* err) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) {
    *err = std::string("cannot open ") + path + ": " + strerror(errno);
    return false;
  }
  struct stat st;
  if (fstat(m->fd, &st) != 0) {
    *err = std::string("fstat failed: ") + strerror(errno);
    return false;
  }
  m->size = static_cast<size_t>(st.st_size);
  if (m->size == 0) {
    m->data = "";
    return true;
  }
  void* p = mmap(nullptr, m->size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p != MAP_FAILED) {
    m->data = static_cast<const char*>(p);
    m->is_mmap = true;
    madvise(p, m->size, MADV_SEQUENTIAL);
    return true;
  }
  // fallback: read into memory
  m->fallback.resize(m->size);
  ssize_t got = 0;
  size_t total = 0;
  while (total < m->size &&
         (got = pread(m->fd, m->fallback.data() + total, m->size - total, total)) > 0)
    total += static_cast<size_t>(got);
  if (total != m->size) {
    *err = "short read";
    return false;
  }
  m->data = m->fallback.data();
  return true;
}

inline bool is_null_token(std::string_view s) {
  if (s.empty()) return true;
  switch (s.size()) {
    case 2:
      return s == "NA" || s == "na";
    case 3:
      return s == "nan" || s == "NaN" || s == "NAN" || s == "N/A";
    case 4:
      return s == "null" || s == "NULL" || s == "None";
  }
  return false;
}

inline bool parse_i64(std::string_view s, int64_t* out) {
  const char* b = s.data();
  const char* e = s.data() + s.size();
  auto r = std::from_chars(b, e, *out, 10);
  return r.ec == std::errc() && r.ptr == e;
}

inline bool parse_f64(std::string_view s, double* out) {
  const char* b = s.data();
  const char* e = s.data() + s.size();
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
  auto r = std::from_chars(b, e, *out);
  return r.ec == std::errc() && r.ptr == e;
#else
  // libstdc++ < 11 has integer-only from_chars: strtod_l over a bounded
  // copy (cells are short; the buffer is mmap'd, NOT NUL-terminated).
  // The explicit C locale keeps '.' as the decimal point even when an
  // embedding host (the C-ABI path) has called setlocale(LC_NUMERIC,...).
  static locale_t c_loc = newlocale(LC_ALL_MASK, "C", (locale_t)0);
  char buf[64];
  std::string big;  // cells >= 64 chars (rare) take the heap copy
  size_t n = s.size();
  if (n == 0) return false;
  const char* p;
  if (n < sizeof(buf)) {
    memcpy(buf, b, n);
    buf[n] = '\0';
    p = buf;
  } else {
    big.assign(b, n);
    p = big.c_str();
  }
  char* endp = nullptr;
  errno = 0;
  *out = strtod_l(p, &endp, c_loc);
  if (endp != p + n) return false;
  // ERANGE underflow (subnormal -> rounded value) is data, not failure;
  // ERANGE overflow (+-HUGE_VAL) matches from_chars' rejection
  if (errno == ERANGE && (*out == HUGE_VAL || *out == -HUGE_VAL)) return false;
  return true;
#endif
}

inline bool parse_bool(std::string_view s, uint8_t* out) {
  if (s == "true" || s == "True" || s == "TRUE") { *out = 1; return true; }
  if (s == "false" || s == "False" || s == "FALSE") { *out = 0; return true; }
  return false;
}

// Count lines in [begin, end) — upper bound on rows (blank lines included).
int64_t count_lines(const char* base, size_t begin, size_t end) {
  int64_t n = 0;
  size_t i = begin;
  while (i < end) {
    const void* nl = memchr(base + i, '\n', end - i);
    if (!nl) { ++n; break; }
    ++n;
    i = static_cast<const char*>(nl) - base + 1;
  }
  return n;
}

// Tokenize [begin, end) into cells; rows must start at begin. Handles quoted
// fields ("", embedded delimiters/newlines) and \r\n. Appends ncols cells per
// row (missing trailing fields become nulls); returns row count.
//
// Hot path: lines are located with memchr('\n') and fields with
// memchr(delim) — both SIMD under glibc — instead of per-char scanning.
int64_t tokenize(const char* base, size_t begin, size_t end, char delim,
                 size_t ncols, std::vector<Cell>* cells) {
  size_t i = begin;
  int64_t rows = 0;
  while (i < end) {
    // find end of line (quote-free fast path; quoted rows re-scan below)
    const void* nlp = memchr(base + i, '\n', end - i);
    size_t line_end = nlp ? static_cast<const char*>(nlp) - base : end;
    size_t next = line_end < end ? line_end + 1 : end;
    if (line_end > i && base[line_end - 1] == '\r') --line_end;
    if (line_end == i) { i = next; continue; }  // blank line

    bool line_quoted = memchr(base + i, '"', line_end - i) != nullptr;
    if (!line_quoted) {
      size_t col = 0;
      size_t p = i;
      while (true) {
        const void* dp = memchr(base + p, delim, line_end - p);
        size_t fend = dp ? static_cast<const char*>(dp) - base : line_end;
        cells->push_back({p, static_cast<uint32_t>(fend - p), 0});
        ++col;
        if (!dp) break;
        p = fend + 1;
        if (p > line_end) break;
      }
      for (; col < ncols; ++col) cells->push_back({0, 0, 0});
      ++rows;
      i = next;
      continue;
    }

    // quoted row: per-char state machine (may span multiple lines)
    size_t col = 0;
    while (true) {
      size_t fstart = i;
      uint32_t quoted = 0;
      if (i < end && base[i] == '"') {
        quoted = 1;
        ++i;
        fstart = i;
        while (i < end) {
          if (base[i] == '"') {
            if (i + 1 < end && base[i + 1] == '"') { i += 2; continue; }
            break;
          }
          ++i;
        }
        size_t flen = i - fstart;
        if (i < end) ++i;  // closing quote
        cells->push_back({fstart, static_cast<uint32_t>(flen), quoted});
      } else {
        while (i < end && base[i] != delim && base[i] != '\n' && base[i] != '\r') ++i;
        cells->push_back({fstart, static_cast<uint32_t>(i - fstart), 0});
      }
      ++col;
      if (i < end && base[i] == delim) { ++i; continue; }
      break;
    }
    if (i < end && base[i] == '\r') ++i;
    if (i < end && base[i] == '\n') ++i;
    for (; col < ncols; ++col) cells->push_back({0, 0, 0});
    ++rows;
  }
  return rows;
}

std::string unescape(const char* base, const Cell& c) {
  std::string out;
  out.reserve(c.len);
  const char* p = base + c.off;
  for (uint32_t i = 0; i < c.len; ++i) {
    out.push_back(p[i]);
    if (p[i] == '"' && i + 1 < c.len && p[i + 1] == '"') ++i;
  }
  return out;
}

inline std::string_view cell_view(const char* base, const Cell& c) {
  return std::string_view(base + c.off, c.len);
}

struct SvHash {
  using is_transparent = void;
  size_t operator()(std::string_view s) const { return std::hash<std::string_view>{}(s); }
  size_t operator()(const std::string& s) const { return std::hash<std::string_view>{}(s); }
};
struct SvEq {
  using is_transparent = void;
  bool operator()(std::string_view a, std::string_view b) const { return a == b; }
};

// Infer a column's type from a sample of non-null cells (monotone lattice
// INT64 -> FLOAT64 -> STRING; BOOL if the first non-null is a bool literal).
// The typed parse pass below demotes + retries if the sample missed a
// conflicting cell (rare; costs one extra pass).
int32_t infer_type(const char* base, const std::vector<Cell>& cells, size_t ncols,
                   size_t col_idx, int64_t nrows, int64_t sample) {
  int32_t type = CT_INT64;
  bool saw_value = false;
  int64_t seen = 0;
  for (int64_t r = 0; r < nrows && seen < sample; ++r) {
    const Cell& c = cells[r * ncols + col_idx];
    std::string_view sv = cell_view(base, c);
    if (!c.quoted && is_null_token(sv)) continue;
    if (c.quoted) return CT_STRING;
    ++seen;
    int64_t iv; double dv; uint8_t bv;
    if (!saw_value) {
      saw_value = true;
      if (parse_bool(sv, &bv)) { type = CT_BOOL; continue; }
    }
    if (type == CT_BOOL) {
      if (parse_bool(sv, &bv)) continue;
      return CT_STRING;  // mixed bool/other -> string
    }
    if (type == CT_INT64 && !parse_i64(sv, &iv)) type = CT_FLOAT64;
    if (type == CT_FLOAT64 && !parse_f64(sv, &dv)) return CT_STRING;
  }
  return type;
}

// Typed parse of rows [r0, r1); returns false on the first cell that does not
// parse as `type` (caller demotes and retries the whole column).
bool parse_numeric_range(const char* base, const std::vector<Cell>& cells,
                         size_t ncols, size_t col_idx, int64_t r0, int64_t r1,
                         int32_t type, Column* out, std::atomic<bool>* any_null) {
  bool nulls = false;
  switch (type) {
    case CT_INT64:
      for (int64_t r = r0; r < r1; ++r) {
        std::string_view sv = cell_view(base, cells[r * ncols + col_idx]);
        if (is_null_token(sv)) { out->valid[r] = 0; nulls = true; out->i64[r] = 0; }
        else if (!parse_i64(sv, &out->i64[r])) return false;
      }
      break;
    case CT_FLOAT64:
      for (int64_t r = r0; r < r1; ++r) {
        std::string_view sv = cell_view(base, cells[r * ncols + col_idx]);
        if (is_null_token(sv)) { out->valid[r] = 0; nulls = true; out->f64[r] = 0.0; }
        else if (!parse_f64(sv, &out->f64[r])) return false;
      }
      break;
    case CT_BOOL:
      for (int64_t r = r0; r < r1; ++r) {
        std::string_view sv = cell_view(base, cells[r * ncols + col_idx]);
        if (is_null_token(sv)) { out->valid[r] = 0; nulls = true; out->b8[r] = 0; }
        else if (!parse_bool(sv, &out->b8[r])) return false;
      }
      break;
  }
  if (nulls) any_null->store(true, std::memory_order_relaxed);
  return true;
}

// Parse all cells of one column (strided walk over the row-major cell grid).
void parse_column(const char* base, const std::vector<Cell>& cells, size_t ncols,
                  size_t col_idx, int64_t nrows, Column* out) {
  int32_t type = infer_type(base, cells, ncols, col_idx, nrows, 1000);

  // numeric path with demote-and-retry on inference misses
  while (type != CT_STRING) {
    out->valid.assign(nrows, 1);
    if (type == CT_INT64) out->i64.resize(nrows);
    else if (type == CT_FLOAT64) out->f64.resize(nrows);
    else out->b8.resize(nrows);
    std::atomic<bool> any_null{false};
    if (parse_numeric_range(base, cells, ncols, col_idx, 0, nrows, type, out,
                            &any_null)) {
      out->type = type;
      out->any_null = any_null.load();
      if (!out->any_null) out->valid.clear();
      return;
    }
    // demote
    out->i64.clear(); out->f64.clear(); out->b8.clear();
    type = type == CT_BOOL ? CT_STRING : (type == CT_INT64 ? CT_FLOAT64 : CT_STRING);
  }

  out->type = type;
  out->valid.assign(nrows, 1);
  {
    {
      // dictionary-encode; then sort dict + remap so code order == value order
      std::unordered_map<std::string, int32_t, SvHash, SvEq> lut;
      out->codes.resize(nrows);
      std::vector<std::string> order;  // insertion order
      for (int64_t r = 0; r < nrows; ++r) {
        const Cell& c = cells[r * ncols + col_idx];
        std::string_view sv = cell_view(base, c);
        if (!c.quoted && is_null_token(sv)) {
          out->valid[r] = 0; out->any_null = true; out->codes[r] = 0;
          continue;
        }
        std::string owned;
        std::string_view key = sv;
        if (c.quoted && sv.find('"') != std::string_view::npos) {
          owned = unescape(base, c);
          key = owned;
        }
#if defined(__cpp_lib_generic_unordered_lookup)
        auto it = lut.find(key);
#else
        // libstdc++ < 11: no heterogeneous unordered lookup — pay one
        // std::string materialization per cell on this toolchain only
        auto it = lut.find(std::string(key));
#endif
        if (it == lut.end()) {
          int32_t id = static_cast<int32_t>(order.size());
          order.emplace_back(key);
          lut.emplace(order.back(), id);
          out->codes[r] = id;
        } else {
          out->codes[r] = it->second;
        }
      }
      // sorted dictionary + remap
      std::vector<int32_t> perm(order.size());
      for (size_t i = 0; i < perm.size(); ++i) perm[i] = static_cast<int32_t>(i);
      std::sort(perm.begin(), perm.end(),
                [&](int32_t a, int32_t b) { return order[a] < order[b]; });
      std::vector<int32_t> remap(order.size());
      out->dict.resize(order.size());
      for (size_t new_id = 0; new_id < perm.size(); ++new_id) {
        remap[perm[new_id]] = static_cast<int32_t>(new_id);
        out->dict[new_id] = std::move(order[perm[new_id]]);
      }
      for (int64_t r = 0; r < nrows; ++r)
        if (out->valid[r]) out->codes[r] = remap[out->codes[r]];
      out->dict_cstr.resize(out->dict.size());
      for (size_t i = 0; i < out->dict.size(); ++i) out->dict_cstr[i] = out->dict[i].c_str();
    }
  }
  if (!out->any_null) out->valid.clear();
}

}  // namespace

extern "C" {

// Returns a Table* (cast to void*); on failure returns a Table* whose error
// string is non-empty (query with ct_csv_error).
void* ct_csv_read(const char* path, char delim, int32_t skip_rows,
                  int32_t has_header, int32_t num_threads) {
  auto* t = new Table();
  Mapped m;
  std::string err;
  if (!map_file(path, &m, &err)) {
    t->error = err;
    return t;
  }
  const char* base = m.data;
  size_t size = m.size;
  size_t pos = 0;

  auto next_line = [&](size_t from) -> size_t {
    const void* nl = memchr(base + from, '\n', size - from);
    return nl ? static_cast<const char*>(nl) - base + 1 : size;
  };

  for (int32_t i = 0; i < skip_rows && pos < size; ++i) pos = next_line(pos);

  // header / column count
  size_t hdr_end = pos < size ? next_line(pos) : pos;
  {
    std::vector<Cell> hdr_cells;
    size_t line_end = hdr_end;
    while (line_end > pos && (base[line_end - 1] == '\n' || base[line_end - 1] == '\r'))
      --line_end;
    tokenize(base, pos, line_end, delim, 0, &hdr_cells);
    size_t ncols = hdr_cells.size();
    if (ncols == 0) {
      t->nrows = 0;
      return t;
    }
    t->names.reserve(ncols);
    for (size_t i = 0; i < ncols; ++i) {
      if (has_header) {
        const Cell& c = hdr_cells[i];
        std::string name = c.quoted ? unescape(base, c)
                                    : std::string(cell_view(base, c));
        t->names.push_back(std::move(name));
      } else {
        t->names.push_back(std::to_string(i));
      }
    }
  }
  if (has_header) pos = hdr_end;

  size_t ncols = t->names.size();
  size_t body = pos;

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = num_threads > 0 ? static_cast<size_t>(num_threads)
                                    : (hw ? hw : 4);
  // quoted fields may contain newlines: chunk-splitting on raw '\n' would be
  // wrong, so any '"' in the body forces single-threaded tokenize (the
  // numeric fast path — benchmarks, goldens — stays parallel)
  bool has_quote = memchr(base + body, '"', size - body) != nullptr;
  size_t data_len = size - body;
  if (has_quote || data_len < (1u << 20)) nthreads = 1;
  nthreads = std::min<size_t>(nthreads, 64);

  // chunk boundaries aligned to line starts
  std::vector<size_t> bounds(nthreads + 1);
  bounds[0] = body;
  for (size_t i = 1; i < nthreads; ++i) {
    size_t target = body + data_len * i / nthreads;
    if (target >= size) target = size;
    else target = next_line(target);
    bounds[i] = std::max(target, bounds[i - 1]);
  }
  bounds[nthreads] = size;

  std::vector<std::vector<Cell>> chunk_cells(nthreads);
  std::vector<int64_t> chunk_rows(nthreads, 0);
  {
    std::vector<std::thread> ths;
    for (size_t i = 0; i < nthreads; ++i) {
      ths.emplace_back([&, i] {
        int64_t lines = count_lines(base, bounds[i], bounds[i + 1]);
        chunk_cells[i].reserve(static_cast<size_t>(lines) * ncols);
        chunk_rows[i] =
            tokenize(base, bounds[i], bounds[i + 1], delim, ncols, &chunk_cells[i]);
      });
    }
    for (auto& th : ths) th.join();
  }

  int64_t nrows = 0;
  for (auto r : chunk_rows) nrows += r;
  std::vector<Cell> cells;
  cells.reserve(static_cast<size_t>(nrows) * ncols);
  for (auto& cc : chunk_cells) {
    cells.insert(cells.end(), cc.begin(), cc.end());
    cc.clear();
    cc.shrink_to_fit();
  }
  if (cells.size() != static_cast<size_t>(nrows) * ncols) {
    t->error = "ragged rows: cell count " + std::to_string(cells.size()) +
               " != rows*cols " + std::to_string(nrows * ncols);
    return t;
  }
  t->nrows = nrows;
  t->cols.resize(ncols);

  // parse columns in parallel: numeric columns additionally split into
  // row-range tasks so a 2-3 column numeric file still uses every core
  {
    size_t pw = std::max<size_t>(hw ? std::min<size_t>(hw, 64) : 4, 1);
    std::vector<int32_t> types(ncols);
    for (size_t c = 0; c < ncols; ++c)
      types[c] = infer_type(base, cells, ncols, c, nrows, 1000);

    struct Task { size_t col; int64_t r0, r1; };  // r0<0: whole-column (string)
    std::vector<Task> tasks;
    std::vector<std::unique_ptr<std::atomic<bool>>> fail(ncols), any_null(ncols);
    const int64_t grain = std::max<int64_t>(nrows / static_cast<int64_t>(pw * 2) + 1, 1 << 18);
    for (size_t c = 0; c < ncols; ++c) {
      fail[c] = std::make_unique<std::atomic<bool>>(false);
      any_null[c] = std::make_unique<std::atomic<bool>>(false);
      if (types[c] == CT_STRING) {
        tasks.push_back({c, -1, -1});
        continue;
      }
      Column* out = &t->cols[c];
      out->valid.assign(nrows, 1);
      if (types[c] == CT_INT64) out->i64.resize(nrows);
      else if (types[c] == CT_FLOAT64) out->f64.resize(nrows);
      else out->b8.resize(nrows);
      for (int64_t r0 = 0; r0 < nrows; r0 += grain)
        tasks.push_back({c, r0, std::min(r0 + grain, nrows)});
      if (nrows == 0) tasks.push_back({c, 0, 0});
    }

    std::atomic<size_t> next{0};
    std::vector<std::thread> ths;
    for (size_t i = 0; i < std::min(pw, tasks.size()); ++i) {
      ths.emplace_back([&] {
        for (size_t ti; (ti = next.fetch_add(1)) < tasks.size();) {
          const Task& tk = tasks[ti];
          if (tk.r0 < 0) {
            parse_column(base, cells, ncols, tk.col, nrows, &t->cols[tk.col]);
          } else if (!fail[tk.col]->load(std::memory_order_relaxed)) {
            if (!parse_numeric_range(base, cells, ncols, tk.col, tk.r0, tk.r1,
                                     types[tk.col], &t->cols[tk.col],
                                     any_null[tk.col].get()))
              fail[tk.col]->store(true);
          }
        }
      });
    }
    for (auto& th : ths) th.join();

    for (size_t c = 0; c < ncols; ++c) {
      if (types[c] == CT_STRING) continue;
      Column* out = &t->cols[c];
      if (fail[c]->load()) {
        // inference sample missed a conflicting cell: full re-parse with
        // parse_column's demote-and-retry loop
        *out = Column();
        parse_column(base, cells, ncols, c, nrows, out);
        continue;
      }
      out->type = types[c];
      out->any_null = any_null[c]->load();
      if (!out->any_null) out->valid.clear();
    }
  }

  t->name_cstr.resize(ncols);
  for (size_t i = 0; i < ncols; ++i) t->name_cstr[i] = t->names[i].c_str();
  return t;
}

const char* ct_csv_error(void* h) {
  auto* t = static_cast<Table*>(h);
  return t->error.empty() ? nullptr : t->error.c_str();
}
int64_t ct_csv_nrows(void* h) { return static_cast<Table*>(h)->nrows; }
int32_t ct_csv_ncols(void* h) {
  return static_cast<int32_t>(static_cast<Table*>(h)->cols.size());
}
const char* ct_csv_colname(void* h, int32_t i) {
  return static_cast<Table*>(h)->name_cstr[i];
}
int32_t ct_csv_coltype(void* h, int32_t i) {
  return static_cast<Table*>(h)->cols[i].type;
}
const int64_t* ct_csv_data_i64(void* h, int32_t i) {
  return static_cast<Table*>(h)->cols[i].i64.data();
}
const double* ct_csv_data_f64(void* h, int32_t i) {
  return static_cast<Table*>(h)->cols[i].f64.data();
}
const uint8_t* ct_csv_data_bool(void* h, int32_t i) {
  return static_cast<Table*>(h)->cols[i].b8.data();
}
const int32_t* ct_csv_data_codes(void* h, int32_t i) {
  return static_cast<Table*>(h)->cols[i].codes.data();
}
// NULL when the column has no nulls
const uint8_t* ct_csv_valid(void* h, int32_t i) {
  auto& c = static_cast<Table*>(h)->cols[i];
  return c.any_null ? c.valid.data() : nullptr;
}
int32_t ct_csv_dict_size(void* h, int32_t i) {
  return static_cast<int32_t>(static_cast<Table*>(h)->cols[i].dict.size());
}
const char* const* ct_csv_dict(void* h, int32_t i) {
  return static_cast<Table*>(h)->cols[i].dict_cstr.data();
}
void ct_csv_free(void* h) { delete static_cast<Table*>(h); }

// ---------------------------------------------------------------------------
// Writer: row-wise printer like the reference's PrintToOStream
// (table.cpp:854-900), but buffered + typed formatters.
// Columns arrive as parallel arrays; type tags as in ColType. Strings arrive
// as codes + dictionary. Returns 0 on success.
int32_t ct_csv_write(const char* path, char delim, int64_t nrows, int32_t ncols,
                     const char* const* names, const int32_t* types,
                     const void* const* data, const uint8_t* const* valids,
                     const char* const* const* dicts) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  std::string buf;
  buf.reserve(1 << 20);
  auto flush_if = [&](size_t cap) {
    if (buf.size() >= cap) {
      fwrite(buf.data(), 1, buf.size(), f);
      buf.clear();
    }
  };
  auto put_str = [&](const char* s) {
    bool need_quote = false;
    for (const char* p = s; *p; ++p)
      if (*p == delim || *p == '"' || *p == '\n' || *p == '\r') { need_quote = true; break; }
    if (!need_quote) { buf += s; return; }
    buf += '"';
    for (const char* p = s; *p; ++p) {
      if (*p == '"') buf += '"';
      buf += *p;
    }
    buf += '"';
  };
  for (int32_t c = 0; c < ncols; ++c) {
    if (c) buf += delim;
    put_str(names[c]);
  }
  buf += '\n';
  char tmp[64];
  for (int64_t r = 0; r < nrows; ++r) {
    for (int32_t c = 0; c < ncols; ++c) {
      if (c) buf += delim;
      if (valids[c] && !valids[c][r]) continue;  // null -> empty field
      switch (types[c]) {
        case CT_INT64: {
          auto v = static_cast<const int64_t*>(data[c])[r];
          auto res = std::to_chars(tmp, tmp + sizeof(tmp), v);
          buf.append(tmp, res.ptr - tmp);
          break;
        }
        case CT_FLOAT64: {
          auto v = static_cast<const double*>(data[c])[r];
          // shortest round-trip form, matching what pandas/python repr emit
#if defined(__cpp_lib_to_chars) && __cpp_lib_to_chars >= 201611L
          auto res = std::to_chars(tmp, tmp + sizeof(tmp), v);
          buf.append(tmp, res.ptr - tmp);
#else
          // libstdc++ < 11: %.17g round-trips every double (not always
          // shortest — cosmetic only, the reader parses both forms)
          int m = snprintf(tmp, sizeof(tmp), "%.17g", v);
          buf.append(tmp, m);
#endif
          break;
        }
        case CT_BOOL:
          buf += static_cast<const uint8_t*>(data[c])[r] ? "true" : "false";
          break;
        case CT_STRING: {
          auto code = static_cast<const int32_t*>(data[c])[r];
          put_str(dicts[c][code]);
          break;
        }
      }
    }
    buf += '\n';
    flush_if(1 << 20);
  }
  fwrite(buf.data(), 1, buf.size(), f);
  int rc = fclose(f);
  return rc == 0 ? 0 : -2;
}

}  // extern "C"
