// BoW inverted file of the port's KeyFrameDatabase (models/keyframe_database.py),
// on the host: word id -> keyframe ids (reference include/KeyFrameDatabase.h:88)
// and the query prefilters of DetectLoopCandidates / DetectRelocalization-
// Candidates (src/KeyFrameDatabase.cc:79-160, 206-268): shared-word counts,
// more than 0.8 x the most shared words, then an L1 score of at least
// `min_score`.
//
// The results are those of the database's dict path, to the bit and in order:
//   - posting lists keep insertion order, and erasing a keyframe removes its
//     first entry in the list of each of its words (`list.remove`);
//   - candidates come out in first-shared-word order (the query's words in
//     the order given, each posting list in order), and the group stage's
//     stable sort lets that order decide ties;
//   - the L1 score is ops/bow.l1_score: the minima of the common words in
//     ascending word order, summed in float32 in numpy's pairwise order
//     (`pairwise_sum` below), widened to double; the 0.8 x test and the
//     `min_score` test compare in double, as Python does.
// No hash container is iterated: keyframe ids are dense and index vectors.
//
// Thread safety: a reader-writer lock per index (queries shared, add / erase
// exclusive), since ctypes calls run with the interpreter lock released.

#include <algorithm>
#include <cstdint>
#include <map>
#include <mutex>
#include <numeric>
#include <shared_mutex>
#include <vector>

namespace {

struct BowVector {
    std::vector<int32_t> words;  // as given (erase walks them in this order)
    std::vector<int32_t> sorted_words;  // ascending, first occurrence of each word
    std::vector<float> sorted_vals;
};

struct InvertedIndex {
    std::shared_mutex mu;
    std::vector<std::vector<int64_t>> postings;  // by word id
    std::map<int64_t, BowVector> vectors;        // looked up, never iterated into a result
    int64_t kf_slots = 0;                        // 1 + the largest keyframe id added
};

InvertedIndex* X(void* h) { return static_cast<InvertedIndex*>(h); }

BowVector make_vector(const int32_t* words, const float* vals, int64_t n) {
    BowVector v;
    v.words.assign(words, words + n);
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) { return words[a] < words[b]; });
    for (int64_t i : order) {
        if (!v.sorted_words.empty() && v.sorted_words.back() == words[i]) continue;
        v.sorted_words.push_back(words[i]);
        v.sorted_vals.push_back(vals[i]);
    }
    return v;
}

// numpy's float32 add.reduce of a contiguous array (pairwise summation,
// numpy/_core/src/umath/loops_utils.h.src): a plain loop under 8 elements,
// 8 accumulators up to 128, else a split at n / 2 rounded down to a
// multiple of 8.
float pairwise_sum(const float* a, size_t n) {
    if (n < 8) {
        float res = 0.f;
        for (size_t i = 0; i < n; ++i) res += a[i];
        return res;
    }
    if (n <= 128) {
        float r[8];
        for (int j = 0; j < 8; ++j) r[j] = a[j];
        size_t i = 8;
        for (; i < n - (n % 8); i += 8)
            for (int j = 0; j < 8; ++j) r[j] += a[i + j];
        float res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
        for (; i < n; ++i) res += a[i];
        return res;
    }
    size_t n2 = n / 2;
    n2 -= n2 % 8;
    return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

// ops/bow.l1_score: sum of min(v1, v2) over the common words, 0 without any.
double l1_score(const BowVector& a, const BowVector& b) {
    std::vector<float> mins;
    size_t i = 0, j = 0;
    while (i < a.sorted_words.size() && j < b.sorted_words.size()) {
        if (a.sorted_words[i] < b.sorted_words[j]) {
            ++i;
        } else if (b.sorted_words[j] < a.sorted_words[i]) {
            ++j;
        } else {
            mins.push_back(std::min(a.sorted_vals[i], b.sorted_vals[j]));
            ++i;
            ++j;
        }
    }
    return mins.empty() ? 0.0 : (double)pairwise_sum(mins.data(), mins.size());
}

}  // namespace

extern "C" {

void* ii_new() { return new InvertedIndex(); }

int ii_free(void* h) {
    delete X(h);
    return 0;
}

int ii_clear(void* h) {
    std::unique_lock lock(X(h)->mu);
    X(h)->postings.clear();
    X(h)->vectors.clear();
    X(h)->kf_slots = 0;
    return 0;
}

int64_t ii_size(void* h) {
    std::shared_lock lock(X(h)->mu);
    return (int64_t)X(h)->vectors.size();
}

// Registers (or re-registers) keyframe `kf`'s vector; every word's posting
// list gains `kf` once per occurrence. -1 for a negative id.
int ii_add(void* h, int64_t kf, const int32_t* words, const float* vals, int64_t n) {
    if (kf < 0) return -1;
    for (int64_t i = 0; i < n; ++i)
        if (words[i] < 0) return -1;
    auto* x = X(h);
    std::unique_lock lock(x->mu);
    x->vectors[kf] = make_vector(words, vals, n);
    for (int64_t i = 0; i < n; ++i) {
        if ((size_t)words[i] >= x->postings.size()) x->postings.resize(words[i] + 1);
        x->postings[words[i]].push_back(kf);
    }
    x->kf_slots = std::max(x->kf_slots, kf + 1);
    return 0;
}

int ii_erase(void* h, int64_t kf) {
    auto* x = X(h);
    std::unique_lock lock(x->mu);
    auto it = x->vectors.find(kf);
    if (it == x->vectors.end()) return 0;
    for (int32_t w : it->second.words) {
        auto& lst = x->postings[w];
        auto pos = std::find(lst.begin(), lst.end(), kf);
        if (pos != lst.end()) lst.erase(pos);
    }
    x->vectors.erase(it);
    return 0;
}

// Registered keyframe ids, ascending; returns their count.
int64_t ii_keyframes(void* h, int64_t* out, int64_t cap) {
    auto* x = X(h);
    std::shared_lock lock(x->mu);
    const int64_t m = (int64_t)x->vectors.size();
    if (m > cap) return m;
    int64_t i = 0;
    for (const auto& kv : x->vectors) out[i++] = kv.first;
    return m;
}

// L1 score of two registered keyframes (0 if either is missing) into *out.
int ii_score(void* h, int64_t kf1, int64_t kf2, double* out) {
    auto* x = X(h);
    std::shared_lock lock(x->mu);
    auto a = x->vectors.find(kf1), b = x->vectors.find(kf2);
    *out = a == x->vectors.end() || b == x->vectors.end() ? 0.0 : l1_score(a->second, b->second);
    return 0;
}

// L1 score of an unregistered vector against keyframe `kf` into *out.
int ii_score_vec(void* h, const int32_t* words, const float* vals, int64_t n, int64_t kf, double* out) {
    auto* x = X(h);
    std::shared_lock lock(x->mu);
    auto b = x->vectors.find(kf);
    *out = b == x->vectors.end() ? 0.0 : l1_score(make_vector(words, vals, n), b->second);
    return 0;
}

// Keyframes sharing more than 0.8 x the most shared words with the query,
// those in exclude[0..n_excl) left out, whose L1 score is >= min_score:
// (kf, score) rows in first-shared-word order; returns the row count.
int64_t ii_query(void* h, const int32_t* words, const float* vals, int64_t n, const int64_t* exclude,
                 int64_t n_excl, double min_score, int64_t* out_kf, double* out_score, int64_t cap) {
    auto* x = X(h);
    std::shared_lock lock(x->mu);
    std::vector<char> excluded(x->kf_slots, 0);
    for (int64_t i = 0; i < n_excl; ++i)
        if (exclude[i] >= 0 && exclude[i] < x->kf_slots) excluded[exclude[i]] = 1;
    std::vector<int64_t> count(x->kf_slots, 0), order;
    for (int64_t i = 0; i < n; ++i) {
        if (words[i] < 0 || (size_t)words[i] >= x->postings.size()) continue;
        for (int64_t kf : x->postings[words[i]]) {
            if (excluded[kf]) continue;
            if (count[kf]++ == 0) order.push_back(kf);
        }
    }
    if (order.empty()) return 0;
    int64_t max_common = 0;
    for (int64_t kf : order) max_common = std::max(max_common, count[kf]);
    const double min_common = 0.8 * (double)max_common;
    const BowVector q = make_vector(words, vals, n);
    std::vector<int64_t> kfs;
    std::vector<double> scores;
    for (int64_t kf : order) {
        if ((double)count[kf] <= min_common) continue;
        auto it = x->vectors.find(kf);
        if (it == x->vectors.end()) continue;
        const double s = l1_score(q, it->second);
        if (s >= min_score) {
            kfs.push_back(kf);
            scores.push_back(s);
        }
    }
    const int64_t m = (int64_t)kfs.size();
    if (m > cap) return m;
    std::copy(kfs.begin(), kfs.end(), out_kf);
    std::copy(scores.begin(), scores.end(), out_score);
    return m;
}

}  // extern "C"
