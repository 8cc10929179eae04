// C ABI for the cylon_tpu_torch port: the foreign-language binding surface
// (the port's copy of the JAX package's C ABI, every ct_api_* symbol with
// the same signature).
//
// Reference analog: the Java binding chain — Table.java -> JNI ->
// cylon::Table (java/src/main/java/org/cylondata/cylon/Table.java:63-238,
// java/src/main/native/src/Table.cpp). There the JVM calls INTO the C++
// core; here any FFI-capable language (JVM/Go/C/Rust) calls into this C ABI,
// which drives the framework through an embedded CPython interpreter — the
// compute itself stays on the card (PyTorch and the port's CUDA kernels)
// either way, so the binding layer is a thin handle registry, exactly like
// the reference's JNI table-id map.
//
// Build: g++ -shared -fPIC capi.cpp $(python3-config --includes --ldflags)
// (done by cylon_tpu_torch.native.build_capi()). In-process use from Python
// is also supported (the GIL is re-acquired via PyGILState).
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>

namespace {
std::mutex g_mu;
std::map<int64_t, PyObject*> g_tables;  // handle -> cylon_tpu_torch.Table
int64_t g_next = 1;
PyObject* g_module = nullptr;  // cylon_tpu_torch
PyObject* g_ctx = nullptr;     // CylonContext
std::string g_err;
bool g_we_initialized = false;

struct Gil {
  PyGILState_STATE st;
  Gil() : st(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(st); }
};

void set_err_from_python() {
  PyObject *type, *value, *tb;
  PyErr_Fetch(&type, &value, &tb);
  g_err = "unknown python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* u = PyUnicode_AsUTF8(s);  // may fail -> nullptr
      if (u) g_err = u;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

int64_t store(PyObject* table) {
  std::lock_guard<std::mutex> g(g_mu);
  int64_t h = g_next++;
  g_tables[h] = table;
  return h;
}

// Returns a NEW reference (incref'd under the lock): a concurrent
// ct_api_release on the same handle can Py_DECREF the registry's reference
// the moment g_mu is dropped, so handing out the borrowed pointer would be a
// use-after-free. Callers own the returned reference.
PyObject* fetch(int64_t h) {
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_tables.find(h);
  if (it == g_tables.end()) return nullptr;
  Py_INCREF(it->second);
  return it->second;
}

// RAII owner for fetch() results.
struct Ref {
  PyObject* p;
  explicit Ref(PyObject* o) : p(o) {}
  ~Ref() { Py_XDECREF(p); }
  explicit operator bool() const { return p != nullptr; }
};

// The context's config: GPUConfig() on cuda:0, or
// GPUConfig(device=CYLON_TPU_TORCH_PLATFORM) where that knob is set
// (utils/envgate.py; "cpu" asks for the CPU). NEW reference or nullptr.
PyObject* make_config(PyObject* mod) {
  PyObject* gate = PyImport_ImportModule("cylon_tpu_torch.utils.envgate");
  PyObject* knob = gate ? PyObject_GetAttrString(gate, "PLATFORM") : nullptr;
  PyObject* plat = knob ? PyObject_CallMethod(knob, "get", nullptr) : nullptr;
  PyObject* cls = plat ? PyObject_GetAttrString(mod, "GPUConfig") : nullptr;
  PyObject* cfg = nullptr;
  if (cls) {
    cfg = PyUnicode_GetLength(plat) > 0
              ? PyObject_CallFunction(cls, "O", plat)  // GPUConfig(device)
              : PyObject_CallNoArgs(cls);
  }
  Py_XDECREF(cls);
  Py_XDECREF(plat);
  Py_XDECREF(knob);
  Py_XDECREF(gate);
  return cfg;
}
}  // namespace

extern "C" {

const char* ct_api_last_error() { return g_err.c_str(); }

// Initialize the embedded interpreter (no-op when hosted inside Python) and
// create the framework context, CylonContext.init_distributed(make_config()).
// Returns 0 on success.
int ct_api_init() {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    g_we_initialized = true;
  }
  Gil gil;
  if (g_module) return 0;
  PyObject* mod = PyImport_ImportModule("cylon_tpu_torch");
  if (!mod) {
    set_err_from_python();
    return 1;
  }
  PyObject* cfg = make_config(mod);
  PyObject* cls = cfg ? PyObject_GetAttrString(mod, "CylonContext") : nullptr;
  PyObject* ctx =
      cls ? PyObject_CallMethod(cls, "init_distributed", "O", cfg) : nullptr;
  Py_XDECREF(cls);
  Py_XDECREF(cfg);
  if (!ctx) {
    set_err_from_python();
    Py_DECREF(mod);
    return 1;
  }
  g_module = mod;
  g_ctx = ctx;
  return 0;
}

// Table fromCSV (reference Table.java fromCSV :63). Returns handle or 0.
int64_t ct_api_read_csv(const char* path) {
  Gil gil;
  if (!g_module) {
    g_err = "ct_api_init not called";
    return 0;
  }
  PyObject* t =
      PyObject_CallMethod(g_module, "read_csv", "Os", g_ctx, path);
  if (!t) {
    set_err_from_python();
    return 0;
  }
  return store(t);
}

// Build a table directly from raw C buffers — the reference's
// arrow_builder raw-buffer ingest used by JNI (arrow/arrow_builder.cpp:
// cylon::cyarrow::Build from addresses+sizes). Column types: 0 = int64,
// 1 = float64, 2 = bool (uint8). Strings go through the CSV path instead
// (variable-length raw buffers are not part of this ABI).
// Buffers are COPIED (numpy frombuffer is zero-copy, but the table encode
// stages to device anyway), so callers may free them on return.
int64_t ct_api_table_from_columns(int32_t ncols, const char** names,
                                  const int32_t* types, const void** data,
                                  int64_t nrows) {
  Gil gil;
  g_err.clear();
  if (!g_module) {
    g_err = "ct_api_init not called";
    return 0;
  }
  PyObject* np = PyImport_ImportModule("numpy");
  if (!np) {
    set_err_from_python();
    return 0;
  }
  PyObject* dict = PyDict_New();
  bool ok = dict != nullptr;
  for (int32_t c = 0; ok && c < ncols; ++c) {
    const char* dt;
    Py_ssize_t itemsize;
    switch (types[c]) {
      case 0: dt = "int64"; itemsize = 8; break;
      case 1: dt = "float64"; itemsize = 8; break;
      case 2: dt = "bool"; itemsize = 1; break;
      default:
        g_err = "unknown column type tag (use 0=int64,1=float64,2=bool)";
        ok = false;
        continue;
    }
    PyObject* mv = PyMemoryView_FromMemory(
        const_cast<char*>(static_cast<const char*>(data[c])),
        nrows * itemsize, PyBUF_READ);
    PyObject* arr =
        mv ? PyObject_CallMethod(np, "frombuffer", "Os", mv, dt) : nullptr;
    // copy so the caller's buffer lifetime ends at return
    PyObject* copy = arr ? PyObject_CallMethod(arr, "copy", nullptr) : nullptr;
    if (!copy || PyDict_SetItemString(dict, names[c], copy) != 0) ok = false;
    Py_XDECREF(copy);
    Py_XDECREF(arr);
    Py_XDECREF(mv);
  }
  PyObject* table = nullptr;
  if (ok) {
    PyObject* cls = PyObject_GetAttrString(g_module, "Table");
    table = cls ? PyObject_CallMethod(cls, "from_pydict", "OO", g_ctx, dict)
                : nullptr;
    Py_XDECREF(cls);
  }
  if (!table && ok) set_err_from_python();
  // never leave a pending exception across PyGILState_Release — a later
  // C-API call would then execute with an exception already set
  if (PyErr_Occurred()) set_err_from_python();
  Py_XDECREF(dict);
  Py_DECREF(np);
  return table ? store(table) : 0;
}

// join (reference Table.java join/distributedJoin :126-171)
int64_t ct_api_join(int64_t left, int64_t right, const char* on,
                    const char* how, int distributed) {
  Gil gil;
  Ref l(fetch(left));
  Ref r(fetch(right));
  if (!l || !r) {
    g_err = "invalid table handle";
    return 0;
  }
  PyObject* out = PyObject_CallMethod(
      l.p, distributed ? "distributed_join" : "join", "Oss", r.p, on, how);
  if (!out) {
    set_err_from_python();
    return 0;
  }
  return store(out);
}

// sort (reference Table.java sort :190)
int64_t ct_api_sort(int64_t h, const char* column, int distributed) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 0;
  }
  PyObject* out = PyObject_CallMethod(
      t.p, distributed ? "distributed_sort" : "sort", "s", column);
  if (!out) {
    set_err_from_python();
    return 0;
  }
  return store(out);
}

namespace {
// comma-separated names -> Python list[str]; nullptr on error.
PyObject* csv_to_pylist(const char* columns_csv) {
  PyObject* list = PyList_New(0);
  if (!list) return nullptr;
  std::string s(columns_csv);
  size_t pos = 0;
  while (pos != std::string::npos) {
    size_t c = s.find(',', pos);
    std::string name =
        c == std::string::npos ? s.substr(pos) : s.substr(pos, c - pos);
    PyObject* u = PyUnicode_FromString(name.c_str());
    if (!u || PyList_Append(list, u) != 0) {
      Py_XDECREF(u);
      Py_DECREF(list);
      return nullptr;
    }
    Py_DECREF(u);  // PyList_Append took its own reference
    pos = c == std::string::npos ? c : c + 1;
  }
  return list;
}

// Decoded host view of a table: list of (name, values ndarray) pairs in
// column order, plus the live row count. Returns false + python error on
// failure. Used by the callback-driven ops (select/filter/mapColumn), which
// are host-side by definition — the predicate is foreign code.
bool host_columns(PyObject* table, PyObject** out_names, PyObject** out_dict,
                  int64_t* out_rows) {
  PyObject* names = PyObject_GetAttrString(table, "column_names");
  PyObject* dict = names ? PyObject_CallMethod(table, "to_pydict", nullptr)
                         : nullptr;
  PyObject* rows = dict ? PyObject_GetAttrString(table, "row_count") : nullptr;
  if (!rows) {
    Py_XDECREF(names);
    Py_XDECREF(dict);
    return false;
  }
  *out_rows = PyLong_AsLongLong(rows);
  Py_DECREF(rows);
  *out_names = names;
  *out_dict = dict;
  return true;
}

// str() of dict[name][i] appended to out with CSV quoting (RFC 4180: a
// value containing comma/quote/newline is wrapped in quotes with embedded
// quotes doubled — otherwise a string like "a,b" would shift the row's
// fields under the foreign predicate). ``quote`` false appends raw (for the
// single-value callbacks, whose input is one value, not a line).
bool append_value_str(PyObject* dict, PyObject* name, int64_t i,
                      std::string* out, bool quote = false) {
  PyObject* arr = PyDict_GetItem(dict, name);  // borrowed
  if (!arr) return false;
  PyObject* idx = PyLong_FromLongLong(i);
  PyObject* v = idx ? PyObject_GetItem(arr, idx) : nullptr;
  Py_XDECREF(idx);
  PyObject* s = v ? PyObject_Str(v) : nullptr;
  Py_XDECREF(v);
  if (!s) return false;
  const char* u = PyUnicode_AsUTF8(s);
  if (u) {
    if (quote && strpbrk(u, ",\"\n\r")) {
      out->push_back('"');
      for (const char* p = u; *p; ++p) {
        if (*p == '"') out->push_back('"');
        out->push_back(*p);
      }
      out->push_back('"');
    } else {
      out->append(u);
    }
  }
  Py_DECREF(s);
  return u != nullptr;
}

// bool-list -> table.filter(np.asarray(mask)) -> new handle (0 on error).
int64_t filter_by_masklist(PyObject* table, PyObject* mask_list) {
  PyObject* np = PyImport_ImportModule("numpy");
  PyObject* mask =
      np ? PyObject_CallMethod(np, "asarray", "Os", mask_list, "bool")
         : nullptr;
  PyObject* out =
      mask ? PyObject_CallMethod(table, "filter", "O", mask) : nullptr;
  Py_XDECREF(mask);
  Py_XDECREF(np);
  if (!out) {
    set_err_from_python();
    return 0;
  }
  return store(out);
}
}  // namespace

// select/project by column names, comma separated (Table.java select :217)
int64_t ct_api_project(int64_t h, const char* columns_csv) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 0;
  }
  PyObject* list = csv_to_pylist(columns_csv);
  if (!list) {
    set_err_from_python();
    return 0;
  }
  PyObject* out = PyObject_CallMethod(t.p, "project", "O", list);
  Py_DECREF(list);
  if (!out) {
    set_err_from_python();
    return 0;
  }
  return store(out);
}

// Row-UDF select (reference Table.java select(Selector) :226-238 — the JNI
// path calls back into the JVM per row, java/src/main/native/src/Table.cpp
// Java_org_cylondata_cylon_Table_select). Here the foreign predicate is a C
// function pointer receiving (row index, the row rendered as a CSV line,
// user data); nonzero keeps the row. Host-side by definition.
typedef int32_t (*ct_row_pred)(int64_t row, const char* row_csv, void* user);

int64_t ct_api_select(int64_t h, ct_row_pred pred, void* user) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 0;
  }
  PyObject *names, *dict;
  int64_t rows;
  if (!host_columns(t.p, &names, &dict, &rows)) {
    set_err_from_python();
    return 0;
  }
  Py_ssize_t ncols = PyList_Size(names);
  PyObject* mask = PyList_New(0);
  bool ok = mask != nullptr;
  for (int64_t i = 0; ok && i < rows; ++i) {
    std::string line;
    for (Py_ssize_t c = 0; ok && c < ncols; ++c) {
      if (c) line.push_back(',');
      ok = append_value_str(dict, PyList_GetItem(names, c), i, &line,
                            /*quote=*/true);
    }
    if (ok) {
      int32_t keep = pred(i, line.c_str(), user);
      PyObject* b = PyBool_FromLong(keep != 0);
      ok = b && PyList_Append(mask, b) == 0;
      Py_XDECREF(b);
    }
  }
  int64_t out = 0;
  if (ok) {
    out = filter_by_masklist(t.p, mask);
  } else if (PyErr_Occurred()) {
    set_err_from_python();
  }
  Py_XDECREF(mask);
  Py_DECREF(names);
  Py_DECREF(dict);
  return out;
}

// Single-column value filter (reference Table.java filter(col, Filter) :214
// — which the reference never implemented: it throws unSupportedException.
// Implemented here for real). The value arrives as its string rendering.
typedef int32_t (*ct_val_pred)(const char* value, void* user);

int64_t ct_api_filter_column(int64_t h, int32_t col, ct_val_pred pred,
                             void* user) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 0;
  }
  PyObject *names, *dict;
  int64_t rows;
  if (!host_columns(t.p, &names, &dict, &rows)) {
    set_err_from_python();
    return 0;
  }
  int64_t out = 0;
  if (col < 0 || col >= PyList_Size(names)) {
    g_err = "column index out of range";
  } else {
    PyObject* name = PyList_GetItem(names, col);
    PyObject* mask = PyList_New(0);
    bool ok = mask != nullptr;
    for (int64_t i = 0; ok && i < rows; ++i) {
      std::string v;
      ok = append_value_str(dict, name, i, &v);
      if (ok) {
        PyObject* b = PyBool_FromLong(pred(v.c_str(), user) != 0);
        ok = b && PyList_Append(mask, b) == 0;
        Py_XDECREF(b);
      }
    }
    if (ok) {
      out = filter_by_masklist(t.p, mask);
    } else if (PyErr_Occurred()) {
      set_err_from_python();
    }
    Py_XDECREF(mask);
  }
  Py_DECREF(names);
  Py_DECREF(dict);
  return out;
}

// Per-element column map (reference Table.java mapColumn :156 — also
// unSupportedException there; real here). The mapper writes its result
// string into out (cap bytes incl. NUL) and returns the length, or -1 to
// abort. Result is a NEW 1-column table (the Column analog) whose dtype is
// re-inferred from the mapped strings.
typedef int32_t (*ct_val_map)(const char* value, char* out, int32_t cap,
                              void* user);

int64_t ct_api_map_column(int64_t h, int32_t col, ct_val_map fn, void* user) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 0;
  }
  PyObject *names, *dict;
  int64_t rows;
  if (!host_columns(t.p, &names, &dict, &rows)) {
    set_err_from_python();
    return 0;
  }
  int64_t out_h = 0;
  if (col < 0 || col >= PyList_Size(names)) {
    g_err = "column index out of range";
  } else {
    PyObject* name = PyList_GetItem(names, col);
    PyObject* vals = PyList_New(0);
    bool ok = vals != nullptr;
    char buf[4096];
    for (int64_t i = 0; ok && i < rows; ++i) {
      std::string v;
      ok = append_value_str(dict, name, i, &v);
      if (!ok) break;
      int32_t len = fn(v.c_str(), buf, sizeof(buf), user);
      if (len < 0 || len >= (int32_t)sizeof(buf)) {
        // a mapper with snprintf semantics returns the would-have-written
        // length on truncation; trusting it would read past the buffer
        g_err = len < 0 ? "mapper aborted" : "mapper result too long";
        ok = false;
        break;
      }
      PyObject* u = PyUnicode_FromStringAndSize(buf, len);
      ok = u && PyList_Append(vals, u) == 0;
      Py_XDECREF(u);
    }
    if (ok) {
      // object ndarray -> from_pydict re-infers the dtype (ints stay ints)
      PyObject* np = PyImport_ImportModule("numpy");
      PyObject* arr =
          np ? PyObject_CallMethod(np, "array", "Os", vals, "object")
             : nullptr;
      PyObject* d = arr ? PyDict_New() : nullptr;
      PyObject* table = nullptr;
      if (d && PyDict_SetItem(d, name, arr) == 0) {
        PyObject* cls = PyObject_GetAttrString(g_module, "Table");
        table = cls
                    ? PyObject_CallMethod(cls, "from_pydict", "OO", g_ctx, d)
                    : nullptr;
        Py_XDECREF(cls);
      }
      if (!table) set_err_from_python();
      else out_h = store(table);
      Py_XDECREF(d);
      Py_XDECREF(arr);
      Py_XDECREF(np);
    } else if (PyErr_Occurred()) {
      set_err_from_python();
    }
    Py_XDECREF(vals);
  }
  Py_DECREF(names);
  Py_DECREF(dict);
  return out_h;
}

// Hash partition into k tables (reference Table.java hashPartition :166 —
// unSupportedException there; the C++ core's HashPartition, table.cpp:384-405,
// is the real analog). Fills out_handles[0..k-1]; returns 0 on success.
int ct_api_hash_partition(int64_t h, const char* cols_csv, int32_t k,
                          int64_t* out_handles) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 1;
  }
  PyObject* list = csv_to_pylist(cols_csv);
  PyObject* parts =
      list ? PyObject_CallMethod(t.p, "hash_partition", "Oi", list, k)
           : nullptr;
  Py_XDECREF(list);
  if (!parts) {
    set_err_from_python();
    return 1;
  }
  int rc = 0;
  for (int32_t p = 0; p < k; ++p) out_handles[p] = 0;
  for (int32_t p = 0; p < k; ++p) {
    PyObject* key = PyLong_FromLong(p);
    PyObject* tab = key ? PyObject_GetItem(parts, key) : nullptr;  // new ref
    Py_XDECREF(key);
    if (!tab) {
      set_err_from_python();
      rc = 1;
      break;
    }
    out_handles[p] = store(tab);
  }
  if (rc != 0) {
    // mid-loop failure: release the already-stored handles so nothing
    // leaks and the caller sees all-zero out_handles on error
    for (int32_t p = 0; p < k; ++p) {
      if (out_handles[p]) {
        std::lock_guard<std::mutex> g(g_mu);
        auto it = g_tables.find(out_handles[p]);
        if (it != g_tables.end()) {
          Py_DECREF(it->second);
          g_tables.erase(it);
        }
        out_handles[p] = 0;
      }
    }
  }
  Py_DECREF(parts);
  return rc;
}

// Merge tables (reference Table.java merge :187 -> JNI merge). Concat of n
// same-schema tables.
int64_t ct_api_merge(const int64_t* handles, int32_t n) {
  Gil gil;
  if (!g_module) {
    g_err = "ct_api_init not called";
    return 0;
  }
  PyObject* list = PyList_New(0);
  bool ok = list != nullptr;
  for (int32_t i = 0; ok && i < n; ++i) {
    Ref t(fetch(handles[i]));
    if (!t) {
      g_err = "invalid table handle";
      ok = false;
      break;
    }
    ok = PyList_Append(list, t.p) == 0;  // Append takes its own reference
  }
  PyObject* out =
      ok ? PyObject_CallMethod(g_module, "concat", "O", list) : nullptr;
  Py_XDECREF(list);
  if (!out) {
    if (PyErr_Occurred()) set_err_from_python();
    return 0;
  }
  return store(out);
}

// Print the table head to stdout (reference Table.java print -> JNI print).
int ct_api_print(int64_t h) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 1;
  }
  PyObject* s = PyObject_Str(t.p);
  if (!s) {
    set_err_from_python();
    return 1;
  }
  // sys.stdout.write, not PySys_WriteStdout: the latter truncates at ~1000
  // bytes, which a few wide columns exceed
  PyObject* out = PyImport_ImportModule("sys");
  PyObject* stdout_ = out ? PyObject_GetAttrString(out, "stdout") : nullptr;
  PyObject* r =
      stdout_ ? PyObject_CallMethod(stdout_, "write", "O", s) : nullptr;
  PyObject* r2 = r ? PyObject_CallMethod(stdout_, "write", "s", "\n") : nullptr;
  bool ok = r2 != nullptr;
  if (!ok) set_err_from_python();
  Py_XDECREF(r2);
  Py_XDECREF(r);
  Py_XDECREF(stdout_);
  Py_XDECREF(out);
  Py_DECREF(s);
  return ok ? 0 : 1;
}

int64_t ct_api_row_count(int64_t h) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return -1;
  }
  PyObject* n = PyObject_GetAttrString(t.p, "row_count");
  if (!n) {
    set_err_from_python();
    return -1;
  }
  int64_t v = PyLong_AsLongLong(n);
  Py_DECREF(n);
  return v;
}

int32_t ct_api_column_count(int64_t h) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) return -1;
  PyObject* n = PyObject_GetAttrString(t.p, "column_count");
  if (!n) {
    set_err_from_python();
    return -1;
  }
  int32_t v = (int32_t)PyLong_AsLong(n);
  Py_DECREF(n);
  return v;
}

int ct_api_write_csv(int64_t h, const char* path) {
  Gil gil;
  Ref t(fetch(h));
  if (!t) {
    g_err = "invalid table handle";
    return 1;
  }
  PyObject* out = PyObject_CallMethod(g_module, "write_csv", "Os", t.p, path);
  if (!out) {
    set_err_from_python();
    return 1;
  }
  Py_DECREF(out);
  return 0;
}

void ct_api_release(int64_t h) {
  Gil gil;
  std::lock_guard<std::mutex> g(g_mu);
  auto it = g_tables.find(h);
  if (it != g_tables.end()) {
    Py_DECREF(it->second);
    g_tables.erase(it);
  }
}

void ct_api_shutdown() {
  // Py_Finalize requires the caller to HOLD the GIL, so the acquire/release
  // is managed by hand here instead of the Gil RAII guard.
  PyGILState_STATE st = PyGILState_Ensure();
  {
    std::lock_guard<std::mutex> g(g_mu);
    for (auto& kv : g_tables) Py_DECREF(kv.second);
    g_tables.clear();
    Py_XDECREF(g_ctx);
    Py_XDECREF(g_module);
    g_ctx = nullptr;
    g_module = nullptr;
  }
  if (g_we_initialized) {
    g_we_initialized = false;
    Py_Finalize();  // consumes the interpreter; no matching Release
  } else {
    PyGILState_Release(st);
  }
}

}  // extern "C"
