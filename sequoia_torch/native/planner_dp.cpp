// Native planner DP (the port's copy of sequoia_tpu/native/planner_dp.cpp):
// the hot offline loop of the hardware-aware tree planner (same recurrence
// as the reference `tree_search.py:21-50`, which triple-loops in pure
// Python and takes minutes at offloading-regime budgets like B=768).
// O(B^2 * D * W) with a fused inner split-scan.
//
// Semantics are kept bit-identical to the numpy reference path in
// `planner/dp.py::fill_table` (same -inf/NaN infeasibility handling, same
// first-maximum tie-breaking) so the two backends are interchangeable and
// cross-checked by tests/test_torch_planner.py.
//
// Exposed via ctypes (no pybind11 needed): plain C ABI, caller
// allocates the output arrays as contiguous float64/int32 numpy buffers.

#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {
constexpr double NEG = -std::numeric_limits<double>::infinity();
}

extern "C" {

// T:    [(B+1) * (D+1) * (W+1)] float64, filled with the DP values.
// Y:    [(B+1) * (D+1) * (W+1)] int32, split backpointer: the subtree with
//       the first b-1 children keeps y nodes; child b gets m-y nodes at
//       depth l-1 with Targ[m-y][l-1] children. Valid only where T > -inf.
// Returns 0 on success.
int sequoia_fill_table(const double* p, int32_t max_branch, int32_t max_budget,
                       int32_t max_depth, double* T, int32_t* Y) {
    const int64_t B = max_budget, D = max_depth, W = max_branch;
    const int64_t strideM = (D + 1) * (W + 1);
    const int64_t strideL = W + 1;
    auto at = [&](int64_t m, int64_t l, int64_t b) -> int64_t {
        return m * strideM + l * strideL + b;
    };

    for (int64_t i = 0; i < (B + 1) * strideM; ++i) {
        T[i] = NEG;
        Y[i] = -1;
    }
    // Base case: a single node (the root) is always worth 1 accepted token.
    for (int64_t l = 1; l <= D; ++l) T[at(1, l, 0)] = 1.0;

    // Tmax[m][l] = max_b T[m][l][b], Targ the first argmax — maintained
    // incrementally exactly like the numpy path.
    std::vector<double> Tmax((B + 1) * (D + 1), NEG);
    std::vector<int32_t> Targ((B + 1) * (D + 1), 0);
    for (int64_t l = 1; l <= D; ++l) {
        Tmax[1 * (D + 1) + l] = 1.0;
        Targ[1 * (D + 1) + l] = 0;
    }

    for (int64_t m = 2; m <= B; ++m) {
        for (int64_t l = 2; l <= D; ++l) {
            // b = 1: root plus one rank-1 child subtree of m-1 nodes.
            {
                double v = 1.0 + p[1] * Tmax[(m - 1) * (D + 1) + (l - 1)];
                if (std::isnan(v)) v = NEG;
                T[at(m, l, 1)] = v;
                if (v > 0) Y[at(m, l, 1)] = 1;
            }
            for (int64_t b = 2; b <= W; ++b) {
                // Split scan over y in [1, m): keep the FIRST maximum
                // (numpy argmax tie-breaking).
                double best = NEG;
                int64_t best_y = 1;
                const double pb = p[b];
                for (int64_t y = 1; y < m; ++y) {
                    double v = T[at(y, l, b - 1)] +
                               pb * Tmax[(m - y) * (D + 1) + (l - 1)];
                    if (std::isnan(v)) v = NEG;
                    if (v > best) {
                        best = v;
                        best_y = y;
                    }
                }
                T[at(m, l, b)] = best;
                if (best >= 0) Y[at(m, l, b)] = static_cast<int32_t>(best_y);
            }
            double mx = NEG;
            int32_t arg = 0;
            for (int64_t b = 0; b <= W; ++b) {
                double v = T[at(m, l, b)];
                if (v > mx) {
                    mx = v;
                    arg = static_cast<int32_t>(b);
                }
            }
            Tmax[m * (D + 1) + l] = mx;
            Targ[m * (D + 1) + l] = arg;
        }
    }
    return 0;
}

}  // extern "C"
