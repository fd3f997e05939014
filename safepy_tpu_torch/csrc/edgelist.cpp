// Fast tab-delimited edge-list parser for SAFE network files.
//
// Host-side native component of the data loader: parses the reference's 3-column
// (key1 \t key2 \t weight) and 5-column (label1 \t key1 \t label2 \t key2 \t
// weight) formats (see safepy/safe_io.py:30-121 for the format spec) straight
// into index arrays, interning node keys with a single hash map pass — an order
// of magnitude faster than the pandas round trip on multi-million-edge files.
//
// C ABI exposed for ctypes (no pybind11 in this image):
//   el_parse(buf, len, ncols) -> handle        parse from an in-memory buffer
//   el_num_edges / el_num_nodes(handle)
//   el_copy_edges(handle, int32* out)          (E, 2) node indices
//   el_copy_weights(handle, double* out)       (E,)
//   el_keys_size / el_copy_keys(handle, char* out)   '\n'-joined unique keys
//   el_labels_size / el_copy_labels(handle, char* out) '\n'-joined labels
//   el_free(handle)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 edgelist.cpp -o libedgelist.so
// (done at first use by safepy_tpu_torch/io/edgelist.py into build/, keyed by
// a hash of this source). A copy of safepy_tpu/native/edgelist.cpp.

#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

struct ParseResult {
  std::vector<int32_t> edges;     // 2*E interleaved (u, v)
  std::vector<double> weights;    // E
  std::vector<std::string> keys;  // unique node keys, index order
  std::vector<std::string> labels;  // node labels (== keys for 3-col input)
  std::string error;
};

// split one line into up to `want` tab-separated fields; returns count
inline int split_tabs(std::string_view line, std::string_view* out, int want) {
  int n = 0;
  size_t start = 0;
  while (n < want) {
    size_t tab = line.find('\t', start);
    if (tab == std::string_view::npos) {
      out[n++] = line.substr(start);
      break;
    }
    out[n++] = line.substr(start, tab - start);
    start = tab + 1;
  }
  return n;
}

ParseResult* parse(const char* buf, size_t len, int ncols) {
  auto* res = new ParseResult();
  std::unordered_map<std::string_view, int32_t> index;  // label -> node id
  index.reserve(1 << 16);
  // string_views point into `buf`; the caller keeps it alive through parse.
  std::vector<std::string_view> label_views;
  std::vector<std::string_view> key_views;

  const char* p = buf;
  const char* end = buf + len;
  std::string_view fields[5];

  // Node identity is the LABEL column, matching the reference loader's node
  // table keyed on node_label1 (safe_io.py:91-101).
  auto intern = [&](std::string_view label, std::string_view key) -> int32_t {
    auto it = index.find(label);
    if (it != index.end()) return it->second;
    int32_t id = static_cast<int32_t>(label_views.size());
    index.emplace(label, id);
    label_views.push_back(label);
    key_views.push_back(key);
    return id;
  };

  // Per-line field views, collected in one scan.
  std::vector<std::string_view> L1, K1, L2, K2;
  bool first = true;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    size_t line_len = nl ? static_cast<size_t>(nl - p) : static_cast<size_t>(end - p);
    std::string_view line(p, line_len);
    p = nl ? nl + 1 : end;
    if (!line.empty() && line.back() == '\r') line.remove_suffix(1);
    if (line.empty()) continue;

    int got = split_tabs(line, fields, 5);
    if (first) {
      first = false;
      if (got != ncols) {
        res->error = "expected " + std::to_string(ncols) + " columns, got " +
                     std::to_string(got);
        return res;
      }
    }
    if (got < ncols - 1) {
      // A line missing more than the weight field cannot be interpreted
      // consistently with the pandas engine — fail loudly instead of diverging.
      res->error = "ragged line with " + std::to_string(got) + " fields";
      return res;
    }

    std::string_view k1, k2, l1, l2, w;
    if (ncols == 3) {
      l1 = k1 = fields[0];
      l2 = k2 = fields[1];
      w = fields[2];
    } else {
      l1 = fields[0]; k1 = fields[1];
      l2 = fields[2]; k2 = fields[3];
      w = fields[4];
    }
    L1.push_back(l1); K1.push_back(k1);
    L2.push_back(l2); K2.push_back(k2);
    if (got < ncols || w.empty()) {
      // missing weight field: NaN, matching pandas' trailing-column fill
      res->weights.push_back(std::numeric_limits<double>::quiet_NaN());
    } else {
      char tmp[64];
      size_t wl = w.size() < 63 ? w.size() : 63;
      memcpy(tmp, w.data(), wl);
      tmp[wl] = 0;
      res->weights.push_back(strtod(tmp, nullptr));
    }
  }

  // Node ordering parity with the reference: pandas concatenates the full
  // column-1 node table before the column-2 table and drops duplicates keeping
  // first occurrence (safe_io.py:91-96) — so intern every endpoint-1 label
  // first, then the endpoint-2-only labels.
  for (size_t i = 0; i < L1.size(); ++i) intern(L1[i], K1[i]);
  for (size_t i = 0; i < L2.size(); ++i) intern(L2[i], K2[i]);

  res->edges.reserve(2 * L1.size());
  for (size_t i = 0; i < L1.size(); ++i) {
    res->edges.push_back(index[L1[i]]);
    res->edges.push_back(index[L2[i]]);
  }

  res->keys.reserve(key_views.size());
  res->labels.reserve(label_views.size());
  for (size_t i = 0; i < key_views.size(); ++i) {
    res->labels.emplace_back(label_views[i]);
    res->keys.emplace_back(key_views[i]);
  }
  return res;
}

std::string joined(const std::vector<std::string>& v) {
  std::string out;
  size_t total = 0;
  for (auto& s : v) total += s.size() + 1;
  out.reserve(total);
  for (auto& s : v) {
    out += s;
    out += '\n';
  }
  return out;
}

}  // namespace

extern "C" {

void* el_parse(const char* buf, int64_t len, int ncols) {
  return parse(buf, static_cast<size_t>(len), ncols);
}

const char* el_error(void* h) {
  auto* r = static_cast<ParseResult*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}

int64_t el_num_edges(void* h) {
  return static_cast<ParseResult*>(h)->weights.size();
}

int64_t el_num_nodes(void* h) {
  return static_cast<ParseResult*>(h)->keys.size();
}

void el_copy_edges(void* h, int32_t* out) {
  auto& e = static_cast<ParseResult*>(h)->edges;
  memcpy(out, e.data(), e.size() * sizeof(int32_t));
}

void el_copy_weights(void* h, double* out) {
  auto& w = static_cast<ParseResult*>(h)->weights;
  memcpy(out, w.data(), w.size() * sizeof(double));
}

int64_t el_keys_size(void* h) {
  auto* r = static_cast<ParseResult*>(h);
  int64_t total = 0;
  for (auto& s : r->keys) total += s.size() + 1;
  return total;
}

void el_copy_keys(void* h, char* out) {
  auto s = joined(static_cast<ParseResult*>(h)->keys);
  memcpy(out, s.data(), s.size());
}

int64_t el_labels_size(void* h) {
  auto* r = static_cast<ParseResult*>(h);
  int64_t total = 0;
  for (auto& s : r->labels) total += s.size() + 1;
  return total;
}

void el_copy_labels(void* h, char* out) {
  auto s = joined(static_cast<ParseResult*>(h)->labels);
  memcpy(out, s.data(), s.size());
}

void el_free(void* h) { delete static_cast<ParseResult*>(h); }

}  // extern "C"
