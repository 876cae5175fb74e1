// Native graph-preprocessing kernels.
//
// Builds Walker/Vose alias tables for the padded-CSR graph container
// (see pmgt_tpu_torch/graph/container.py, whose Python loop is the plain
// version this is tested against). The Python loop is O(E) but
// interpreter-bound; this one handles production-scale graphs
// (hundreds of millions of edges) at memory bandwidth.
//
// Exposed as a plain C ABI consumed via ctypes — no pybind11 dependency.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// weights:  [n, d] row-major edge weights (-inf on padding)
// degrees:  [n] true neighbor counts
// out_prob: [n, d] acceptance probabilities (pre-filled with 1.0)
// out_idx:  [n, d] alias slot indices (pre-filled with 0)
void build_alias_tables(const float* weights, const int32_t* degrees,
                        int64_t n, int64_t d, float* out_prob,
                        int32_t* out_idx) {
  std::vector<double> scaled;
  std::vector<int32_t> small_stack, large_stack;
  scaled.reserve(d);
  small_stack.reserve(d);
  large_stack.reserve(d);

  for (int64_t row = 0; row < n; ++row) {
    const int32_t deg = degrees[row];
    float* prob = out_prob + row * d;
    int32_t* idx = out_idx + row * d;
    for (int64_t j = 0; j < d; ++j) {
      prob[j] = 1.0f;
      idx[j] = 0;
    }
    if (deg <= 1) continue;

    const float* w = weights + row * d;
    // softmax over the true neighbors (matches the reference's per-node
    // softmax sampling distribution).
    double wmax = w[0];
    for (int32_t j = 1; j < deg; ++j)
      if (w[j] > wmax) wmax = w[j];
    double sum = 0.0;
    scaled.assign(deg, 0.0);
    for (int32_t j = 0; j < deg; ++j) {
      scaled[j] = std::exp(static_cast<double>(w[j]) - wmax);
      sum += scaled[j];
    }
    for (int32_t j = 0; j < deg; ++j) scaled[j] = scaled[j] / sum * deg;

    small_stack.clear();
    large_stack.clear();
    for (int32_t j = 0; j < deg; ++j)
      (scaled[j] < 1.0 ? small_stack : large_stack).push_back(j);

    while (!small_stack.empty() && !large_stack.empty()) {
      const int32_t s = small_stack.back();
      small_stack.pop_back();
      const int32_t l = large_stack.back();
      large_stack.pop_back();
      prob[s] = static_cast<float>(scaled[s]);
      idx[s] = l;
      scaled[l] -= (1.0 - scaled[s]);
      (scaled[l] < 1.0 ? small_stack : large_stack).push_back(l);
    }
    // numerical leftovers keep probability 1 (self-alias)
    for (int32_t j : large_stack) prob[j] = 1.0f;
    for (int32_t j : small_stack) prob[j] = 1.0f;
  }
}

}  // extern "C"
