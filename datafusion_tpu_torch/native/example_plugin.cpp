// Verbatim copy of datafusion_tpu/native/example_plugin.cpp; host-only, kept in step with the original.
// Example datafusion_tpu plugin: a table provider and a scalar function
// exported over the stable C ABI in plugin.h (reference analog:
// datafusion-ffi's example providers, ffi/src/lib.rs:28-55).
//
// Exports:
//   table  "plugin_numbers"   (id int64, val float64, name utf8; 100 rows)
//   scalar "plugin_hypot"(a, b) -> float64
//
// The record batch is hand-assembled through the Arrow C Data Interface:
// refcounted holder owns every buffer; each exported struct's release
// callback drops one reference so the host may release/move structs in any
// order.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 example_plugin.cpp -o plugin.so
#include "plugin.h"

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Holder {
  int refs = 0;
  std::vector<int64_t> ids;
  std::vector<double> vals;
  std::vector<int32_t> offsets;
  std::string chars;
  std::vector<ArrowSchema*> schemas;      // heap children to free
  std::vector<ArrowArray*> arrays;
  std::vector<const void**> buffer_lists;
  std::vector<ArrowSchema**> schema_child_lists;
  std::vector<ArrowArray**> array_child_lists;
};

void drop_ref(Holder* h) {
  if (--h->refs == 0) {
    for (auto* s : h->schemas) delete s;
    for (auto* a : h->arrays) delete a;
    for (auto* b : h->buffer_lists) delete[] b;
    for (auto* c : h->schema_child_lists) delete[] c;
    for (auto* c : h->array_child_lists) delete[] c;
    delete h;
  }
}

void release_schema(ArrowSchema* s) {
  if (s->release == nullptr) return;
  s->release = nullptr;
  drop_ref(static_cast<Holder*>(s->private_data));
}

void release_array(ArrowArray* a) {
  if (a->release == nullptr) return;
  a->release = nullptr;
  drop_ref(static_cast<Holder*>(a->private_data));
}

ArrowSchema* make_schema(Holder* h, const char* fmt, const char* name) {
  auto* s = new ArrowSchema();
  std::memset(s, 0, sizeof(*s));
  s->format = fmt;
  s->name = name;
  s->release = release_schema;
  s->private_data = h;
  h->refs++;
  h->schemas.push_back(s);
  return s;
}

ArrowArray* make_array(Holder* h, int64_t length, int64_t n_buffers,
                       const void* b1, const void* b2) {
  auto* a = new ArrowArray();
  std::memset(a, 0, sizeof(*a));
  a->length = length;
  a->null_count = 0;
  a->n_buffers = n_buffers;
  auto** bufs = new const void*[3]();
  bufs[0] = nullptr;  // no validity bitmap: null_count 0
  bufs[1] = b1;
  bufs[2] = b2;
  a->buffers = bufs;
  a->release = release_array;
  a->private_data = h;
  h->refs++;
  h->arrays.push_back(a);
  h->buffer_lists.push_back(bufs);
  return a;
}

int scan_numbers(void* /*user*/, ArrowSchema* schema, ArrowArray* array) {
  const int64_t n = 100;
  auto* h = new Holder();
  h->ids.reserve(n);
  h->vals.reserve(n);
  h->offsets.reserve(n + 1);
  h->offsets.push_back(0);
  for (int64_t i = 0; i < n; ++i) {
    h->ids.push_back(i);
    h->vals.push_back(0.5 * static_cast<double>(i));
    h->chars += "row" + std::to_string(i);
    h->offsets.push_back(static_cast<int32_t>(h->chars.size()));
  }

  // schema: struct<id: int64, val: float64, name: utf8>
  std::memset(schema, 0, sizeof(*schema));
  schema->format = "+s";
  schema->name = "";
  schema->n_children = 3;
  auto** sc = new ArrowSchema*[3];
  sc[0] = make_schema(h, "l", "id");
  sc[1] = make_schema(h, "g", "val");
  sc[2] = make_schema(h, "u", "name");
  schema->children = sc;
  schema->release = release_schema;
  schema->private_data = h;
  h->refs++;
  h->schema_child_lists.push_back(sc);

  // array: struct of three columns
  std::memset(array, 0, sizeof(*array));
  array->length = n;
  array->null_count = 0;
  array->n_buffers = 1;
  auto** topbufs = new const void*[1]();
  array->buffers = topbufs;
  h->buffer_lists.push_back(topbufs);
  array->n_children = 3;
  auto** ac = new ArrowArray*[3];
  ac[0] = make_array(h, n, 2, h->ids.data(), nullptr);
  ac[1] = make_array(h, n, 2, h->vals.data(), nullptr);
  ac[2] = make_array(h, n, 3, h->offsets.data(), h->chars.data());
  array->children = ac;
  array->release = release_array;
  array->private_data = h;
  h->refs++;
  h->array_child_lists.push_back(ac);
  return 0;
}

void hypot_f64(void* /*user*/, const double** ins, int32_t nargs, double* out,
               int64_t n) {
  if (nargs != 2) return;
  for (int64_t i = 0; i < n; ++i) out[i] = std::hypot(ins[0][i], ins[1][i]);
}

}  // namespace

extern "C" int dft_plugin_init(DftRegistry* reg) {
  if (reg->abi_version != DFT_PLUGIN_ABI_VERSION) return 1;
  int rc = reg->register_table(reg->host, "plugin_numbers", nullptr,
                               scan_numbers);
  if (rc != 0) return rc;
  return reg->register_scalar_f64(reg->host, "plugin_hypot", 2, nullptr,
                                  hypot_f64);
}
