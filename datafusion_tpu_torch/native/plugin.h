// Verbatim copy of datafusion_tpu/native/plugin.h; host-only, kept in step with the original.
/* datafusion_tpu dynamic-library plugin ABI.
 *
 * Capability analog of the reference's `datafusion-ffi` crate
 * (ffi/src/lib.rs:28-55): a stable C ABI over the Arrow C Data Interface
 * that lets a shared library written in any native language provide tables
 * and scalar functions to the engine. The host (Python, via ctypes) loads
 * the library, calls dft_plugin_init with a registry of callbacks, and the
 * plugin registers its objects.
 *
 * Table data crosses the boundary as one Arrow record batch per scan call
 * through the standard ArrowSchema/ArrowArray C structs (the same interface
 * the reference FFI uses); ownership transfers to the host, which invokes
 * the embedded release callbacks.
 */
#ifndef DATAFUSION_TPU_PLUGIN_H
#define DATAFUSION_TPU_PLUGIN_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define DFT_PLUGIN_ABI_VERSION 1

/* Arrow C Data Interface (stable, from the Arrow specification). */
#ifndef ARROW_C_DATA_INTERFACE
#define ARROW_C_DATA_INTERFACE

struct ArrowSchema {
  const char* format;
  const char* name;
  const char* metadata;
  int64_t flags;
  int64_t n_children;
  struct ArrowSchema** children;
  struct ArrowSchema* dictionary;
  void (*release)(struct ArrowSchema*);
  void* private_data;
};

struct ArrowArray {
  int64_t length;
  int64_t null_count;
  int64_t offset;
  int64_t n_buffers;
  int64_t n_children;
  const void** buffers;
  struct ArrowArray** children;
  struct ArrowArray* dictionary;
  void (*release)(struct ArrowArray*);
  void* private_data;
};

#endif /* ARROW_C_DATA_INTERFACE */

/* Fill `schema`/`array` with one record batch (a struct array whose children
 * are the columns). Return 0 on success, nonzero on error. The host calls
 * the structs' release callbacks when done. */
typedef int (*DftScanFn)(void* user, struct ArrowSchema* schema,
                         struct ArrowArray* array);

/* Vectorized scalar function over float64: out[i] = f(in0[i], in1[i], ...).
 * `ins` is an array of `nargs` input pointers, each `n` elements. */
typedef void (*DftScalarF64Fn)(void* user, const double** ins, int32_t nargs,
                               double* out, int64_t n);

typedef struct DftRegistry {
  uint32_t abi_version; /* DFT_PLUGIN_ABI_VERSION */
  void* host;           /* opaque host handle, pass to the callbacks below */

  /* Register a named table provider. Returns 0 on success. */
  int (*register_table)(void* host, const char* name, void* user,
                        DftScanFn scan);

  /* Register a named scalar f64 function with a fixed argument count. */
  int (*register_scalar_f64)(void* host, const char* name, int32_t nargs,
                             void* user, DftScalarF64Fn fn);
} DftRegistry;

/* The one symbol a plugin must export. Return 0 on success. */
typedef int (*DftPluginInitFn)(DftRegistry* registry);

#ifdef __cplusplus
} /* extern "C" */
#endif

#endif /* DATAFUSION_TPU_PLUGIN_H */
