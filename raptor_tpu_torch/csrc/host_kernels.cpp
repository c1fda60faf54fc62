// Native host-side setup kernels (C ABI, loaded via ctypes).
//
// The two inherently-sequential host algorithms of the setup phase —
// serial Ruge-Stüben first-pass splitting (priority queue over dynamic
// weights; raptor_tpu/setup/splitting.py::rs_splitting_host) and greedy
// graph coloring (raptor_tpu/solve/smoothers.py::greedy_coloring_host) —
// are 50-200x faster here than in interpreted Python.  Everything on the
// device path stays JAX/Pallas; this is the host runtime surface
// (SURVEY.md §0: the reference capability's native surface).
//
// Build: g++ -O2 -shared -fPIC -o libhostkernels.so host_kernels.cpp
// (done on demand by raptor_tpu/utils/native.py, with a Python fallback).

#include <cstddef>
#include <cstdint>
#include <queue>
#include <vector>

using std::size_t;

extern "C" {

// Classical Ruge-Stüben first-pass C/F splitting.
// S is the strength graph in CSR (indptr/indices), St its transpose.
// cf out: 1 = C, 2 = F. Matches the Python/oracle implementation exactly
// (same tie-breaking: max lambda, lowest index first via heap order).
void rs_splitting(
    const int64_t* s_indptr, const int32_t* s_indices,
    const int64_t* st_indptr, const int32_t* st_indices,
    int64_t n, int32_t* cf)
{
    const int32_t UNDECIDED = 0, C_PT = 1, F_PT = 2;
    std::vector<double> lam(n);
    for (int64_t i = 0; i < n; ++i) {
        lam[i] = double(st_indptr[i + 1] - st_indptr[i]);
        cf[i] = UNDECIDED;
        if (lam[i] == 0.0 && s_indptr[i + 1] == s_indptr[i]) cf[i] = F_PT;
    }
    // max-heap of (lambda, -index) == python heapq of (-lambda, index)
    using Item = std::pair<double, int64_t>;  // (lambda, -i)
    std::priority_queue<Item> heap;
    for (int64_t i = 0; i < n; ++i)
        if (cf[i] == UNDECIDED) heap.push({lam[i], -i});
    while (!heap.empty()) {
        auto [w, ni] = heap.top();
        heap.pop();
        int64_t i = -ni;
        if (cf[i] != UNDECIDED || w != lam[i]) continue;  // stale entry
        cf[i] = C_PT;
        for (int64_t p = st_indptr[i]; p < st_indptr[i + 1]; ++p) {
            int64_t j = st_indices[p];
            if (cf[j] != UNDECIDED) continue;
            cf[j] = F_PT;
            for (int64_t q = s_indptr[j]; q < s_indptr[j + 1]; ++q) {
                int64_t k = s_indices[q];
                if (cf[k] == UNDECIDED) {
                    lam[k] += 1.0;
                    heap.push({lam[k], -k});
                }
            }
        }
    }
    for (int64_t i = 0; i < n; ++i)
        if (cf[i] == UNDECIDED) cf[i] = F_PT;
}

// Synchronous-round PMIS C/F splitting over a fixed strong-edge list.
// Mirrors raptor_tpu/setup/host_setup.py::np_pmis_splitting exactly
// (integer weights are distinct, so every comparison is tie-free and the
// result is bit-identical): per round, an undecided node whose weight
// exceeds every undecided neighbor's (either edge direction) becomes C;
// undecided neighbors of any C become F.  cf arrives pre-initialized
// (0 = undecided, 2 = F for isolated rows) and is updated in place.
// O(rounds * m) with no allocation per round — the numpy mirror pays
// ~0.5 s/level in reduceat segment maxima at n=110k; this runs in ms.
void pmis_splitting(
    const int64_t* esrc, const int64_t* edst, int64_t m,
    const int64_t* w, int64_t n, int32_t* cf)
{
    const int32_t UNDECIDED = 0, C_PT = 1, F_PT = 2;
    std::vector<int64_t> nmax(n);
    // working copy of the edge list, compacted each round: once BOTH
    // endpoints are decided an edge can never influence another round
    // (the numpy mirror rescans all edges every round — same result,
    // geometric-decay work here instead of rounds * m)
    std::vector<int64_t> es(esrc, esrc + m), ed(edst, edst + m);
    int64_t live = m;
    for (;;) {
        int64_t undecided = 0;
        for (int64_t i = 0; i < n; ++i) {
            nmax[i] = -1;
            if (cf[i] == UNDECIDED) ++undecided;
        }
        if (undecided == 0) break;
        for (int64_t e = 0; e < live; ++e) {
            const int64_t s = es[e], d = ed[e];
            if (cf[d] == UNDECIDED && w[d] > nmax[s]) nmax[s] = w[d];
            if (cf[s] == UNDECIDED && w[s] > nmax[d]) nmax[d] = w[s];
        }
        // simultaneous C decisions: each test reads only pre-round state
        for (int64_t i = 0; i < n; ++i)
            if (cf[i] == UNDECIDED && w[i] > nmax[i]) cf[i] = C_PT;
        int64_t keep = 0;
        for (int64_t e = 0; e < live; ++e) {
            const int64_t s = es[e], d = ed[e];
            if (cf[d] == C_PT && cf[s] == UNDECIDED) cf[s] = F_PT;
            if (cf[s] == C_PT && cf[d] == UNDECIDED) cf[d] = F_PT;
            // keep only edges whose BOTH endpoints are still undecided:
            // a decided endpoint's weight is never read again (nmax reads
            // UNDECIDED weights only), a C endpoint F-propagated along
            // this edge already above, and an F endpoint can never become
            // C — so the edge is dead either way.  F assignments above
            // used the POST-C state, matching the numpy round exactly.
            if (cf[s] == UNDECIDED && cf[d] == UNDECIDED) {
                es[keep] = s; ed[keep] = d; ++keep;
            }
        }
        live = keep;
    }
}

// Greedy graph coloring in natural order (exact red-black on bipartite
// stencil graphs). Returns the number of colors.
int32_t greedy_coloring(
    const int64_t* indptr, const int32_t* indices,
    int64_t n, int32_t* color)
{
    std::vector<uint8_t> used;
    int32_t ncolors = 0;
    for (int64_t i = 0; i < n; ++i) color[i] = -1;
    for (int64_t i = 0; i < n; ++i) {
        used.assign(size_t(ncolors) + 1, 0);
        for (int64_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int64_t j = indices[p];
            if (j < i && color[j] >= 0 && color[j] <= ncolors)
                used[color[j]] = 1;
        }
        int32_t c = 0;
        while (c < (int32_t)used.size() && used[c]) ++c;
        color[i] = c;
        if (c + 1 > ncolors) ncolors = c + 1;
    }
    return ncolors;
}

}  // extern "C"
