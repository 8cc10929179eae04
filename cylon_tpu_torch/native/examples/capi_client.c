/* Standalone C consumer of the cylon_tpu_torch C ABI (the port's copy of
 * the JAX package's client).
 *
 * The foreign-language client the reference ships as Table.java
 * (java/src/main/java/org/cylondata/cylon/Table.java:63-238 over JNI): a
 * program in another language driving the framework end-to-end — read two
 * CSVs, join, sort, project, count, write — with the compute running on
 * the card (or on the CPU under CYLON_TPU_TORCH_PLATFORM=cpu) behind the
 * C ABI (capi.cpp). dlopen keeps this binary free of any
 * link-time Python dependency; the capi .so pulls libpython in itself.
 *
 * Usage: capi_client <capi.so> <left.csv> <right.csv> <out.csv>
 * Exit 0 on success; prints "rows=<n> cols=<n>" for the joined table.
 */
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>

typedef const char* (*fn_err)(void);
typedef int (*fn_init)(void);
typedef int64_t (*fn_read)(const char*);
typedef int64_t (*fn_join)(int64_t, int64_t, const char*, const char*, int);
typedef int64_t (*fn_sort)(int64_t, const char*, int);
typedef int64_t (*fn_project)(int64_t, const char*);
typedef int64_t (*fn_rows)(int64_t);
typedef int32_t (*fn_cols)(int64_t);
typedef int (*fn_write)(int64_t, const char*);
typedef void (*fn_release)(int64_t);
typedef void (*fn_shutdown)(void);

#define LOAD(var, type, name)                                   \
  type var = (type)dlsym(lib, name);                            \
  if (!var) {                                                   \
    fprintf(stderr, "missing symbol %s: %s\n", name, dlerror()); \
    return 2;                                                   \
  }

int main(int argc, char** argv) {
  if (argc != 5) {
    fprintf(stderr, "usage: %s <capi.so> <left.csv> <right.csv> <out.csv>\n",
            argv[0]);
    return 2;
  }
  /* RTLD_GLOBAL: the embedded interpreter's extension modules (numpy, torch)
   * must resolve libpython symbols through this handle. */
  void* lib = dlopen(argv[1], RTLD_NOW | RTLD_GLOBAL);
  if (!lib) {
    fprintf(stderr, "dlopen failed: %s\n", dlerror());
    return 2;
  }
  LOAD(api_err, fn_err, "ct_api_last_error");
  LOAD(api_init, fn_init, "ct_api_init");
  LOAD(api_read, fn_read, "ct_api_read_csv");
  LOAD(api_join, fn_join, "ct_api_join");
  LOAD(api_sort, fn_sort, "ct_api_sort");
  LOAD(api_project, fn_project, "ct_api_project");
  LOAD(api_rows, fn_rows, "ct_api_row_count");
  LOAD(api_cols, fn_cols, "ct_api_column_count");
  LOAD(api_write, fn_write, "ct_api_write_csv");
  LOAD(api_release, fn_release, "ct_api_release");
  LOAD(api_shutdown, fn_shutdown, "ct_api_shutdown");

#define CHECK(cond, what)                                  \
  if (!(cond)) {                                           \
    fprintf(stderr, "%s failed: %s\n", what, api_err()); \
    return 1;                                              \
  }

  CHECK(api_init() == 0, "ct_api_init");
  int64_t hl = api_read(argv[2]);
  CHECK(hl, "ct_api_read_csv(left)");
  int64_t hr = api_read(argv[3]);
  CHECK(hr, "ct_api_read_csv(right)");
  int64_t hj = api_join(hl, hr, "k", "inner", 1); /* distributed join */
  CHECK(hj, "ct_api_join");
  /* the join keeps both key columns, suffixed k_x / k_y */
  int64_t hs = api_sort(hj, "k_x", 1); /* distributed sort */
  CHECK(hs, "ct_api_sort");
  int64_t hp = api_project(hs, "k_x,x,y");
  CHECK(hp, "ct_api_project");
  int64_t rows = api_rows(hp);
  CHECK(rows >= 0, "ct_api_row_count");
  int32_t cols = api_cols(hp);
  CHECK(cols >= 0, "ct_api_column_count");
  CHECK(api_write(hp, argv[4]) == 0, "ct_api_write_csv");
  printf("rows=%lld cols=%d\n", (long long)rows, cols);
  api_release(hp);
  api_release(hs);
  api_release(hj);
  api_release(hr);
  api_release(hl);
  api_shutdown();
  return 0;
}
