// Verbatim copy of datafusion_tpu/native/dictenc.cpp; host-only, kept in step with the original.
// Native host-side kernels for the TPU query engine.
//
// Role analog: the reference engine's hot host-side paths are native Rust
// (ArrowBytesMap interning, physical-expr-common/src/binary_map.rs:210; the
// parquet/CSV decoders).  Here the ingest bottleneck is dictionary-encoding
// string columns (sorted dictionary, order-preserving codes, data/column.py);
// numpy's np.unique on millions of strings is the slow path this replaces.
//
// Interface (ctypes, Arrow-style buffers):
//   dict_encode(values_buf, offsets[int64][n+1], n,
//               out_codes[int32][n], out_order_needed)
// Two-phase: build (hash-intern + sort unique) then remap to sorted codes.
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 dictenc.cpp -o libdictenc.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string_view>
#include <unordered_map>
#include <vector>
#include <thread>

extern "C" {

// Returns number of distinct values; fills codes with *sorted* dictionary
// codes. Caller then calls dict_extract to copy out the sorted unique
// strings' (offset,length) pairs against the ORIGINAL values buffer.
struct DictResult {
  std::vector<std::pair<const char*, int64_t>> sorted_values;  // ptr,len
};

static thread_local DictResult* g_last = nullptr;

int64_t dict_encode(const char* values, const int64_t* offsets, int64_t n,
                    int32_t* out_codes) {
  std::unordered_map<std::string_view, int32_t> intern;
  intern.reserve(static_cast<size_t>(n < 1024 ? 1024 : n / 4));
  std::vector<int32_t> first_codes(static_cast<size_t>(n));
  std::vector<std::string_view> uniques;
  uniques.reserve(1024);

  for (int64_t i = 0; i < n; i++) {
    std::string_view sv(values + offsets[i],
                        static_cast<size_t>(offsets[i + 1] - offsets[i]));
    auto it = intern.find(sv);
    int32_t code;
    if (it == intern.end()) {
      code = static_cast<int32_t>(uniques.size());
      intern.emplace(sv, code);
      uniques.push_back(sv);
    } else {
      code = it->second;
    }
    first_codes[static_cast<size_t>(i)] = code;
  }

  // sort the dictionary and build old->sorted remap
  const int64_t k = static_cast<int64_t>(uniques.size());
  std::vector<int32_t> order(static_cast<size_t>(k));
  for (int64_t i = 0; i < k; i++) order[static_cast<size_t>(i)] = (int32_t)i;
  std::sort(order.begin(), order.end(), [&](int32_t a, int32_t b) {
    return uniques[static_cast<size_t>(a)] < uniques[static_cast<size_t>(b)];
  });
  std::vector<int32_t> remap(static_cast<size_t>(k));
  for (int64_t i = 0; i < k; i++)
    remap[static_cast<size_t>(order[static_cast<size_t>(i)])] = (int32_t)i;

  for (int64_t i = 0; i < n; i++)
    out_codes[i] = remap[static_cast<size_t>(first_codes[static_cast<size_t>(i)])];

  delete g_last;
  g_last = new DictResult();
  g_last->sorted_values.reserve(static_cast<size_t>(k));
  for (int64_t i = 0; i < k; i++) {
    auto sv = uniques[static_cast<size_t>(order[static_cast<size_t>(i)])];
    g_last->sorted_values.emplace_back(sv.data(), (int64_t)sv.size());
  }
  return k;
}

// After dict_encode: copy sorted unique strings into a packed buffer.
// out_offsets has k+1 entries; out_buf must hold the total byte length,
// obtainable via dict_total_bytes().
int64_t dict_total_bytes() {
  if (!g_last) return 0;
  int64_t total = 0;
  for (auto& p : g_last->sorted_values) total += p.second;
  return total;
}

void dict_extract(char* out_buf, int64_t* out_offsets) {
  if (!g_last) return;
  int64_t pos = 0;
  int64_t i = 0;
  for (auto& p : g_last->sorted_values) {
    out_offsets[i++] = pos;
    std::memcpy(out_buf + pos, p.first, static_cast<size_t>(p.second));
    pos += p.second;
  }
  out_offsets[i] = pos;
  delete g_last;
  g_last = nullptr;
}

// Vectorized LIKE/contains over a dictionary: evaluate pattern containment
// for each distinct value (used to build the device lookup table).
void str_contains(const char* values, const int64_t* offsets, int64_t n,
                  const char* needle, int64_t needle_len, uint8_t* out) {
  std::string_view nd(needle, static_cast<size_t>(needle_len));
  for (int64_t i = 0; i < n; i++) {
    std::string_view sv(values + offsets[i],
                        static_cast<size_t>(offsets[i + 1] - offsets[i]));
    out[i] = sv.find(nd) != std::string_view::npos ? 1 : 0;
  }
}

}  // extern "C"
