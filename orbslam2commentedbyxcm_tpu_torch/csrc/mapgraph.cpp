// Observation and covisibility index of the port's Map (models/map.py), on
// the host: the C++ mirror of `Map.obs` (point -> {keyframe: feature}) that
// the frame's hot queries read (reference MapPoint::mObservations,
// include/MapPoint.h:183; KeyFrame::UpdateConnections, src/KeyFrame.cc:324).
//
// Every output is in the order the dict path gives, so a Map on either index
// makes the same decisions:
//   - a point's observers are kept in insertion order; re-observing a
//     keyframe updates its feature in place, erasing one keeps the order of
//     the rest, and a later re-add appends (what `dict` does);
//   - covisibility counts over the caller's `map_pt` array and each point's
//     observers in order, and emits keyframes in first-seen order, so the
//     caller's `max()` breaks ties as the Python loop does;
//   - `points_seen_by` returns ascending ids; the observer export returns
//     rows in the order of the given points, then of each point's observers.
// No hash container is iterated: point and keyframe ids are dense, small and
// non-negative, and index vectors directly.
//
// Thread safety: tracking, the mapping worker and the loop worker call in
// with the interpreter lock released (ctypes drops it), so each graph holds
// a reader-writer lock: shared for queries, exclusive for mutations.
//
// Variable-length results go to caller buffers of `cap` rows; a call returns
// the row count, and writes nothing when that is more than `cap` (the caller
// grows its buffers and calls again). mg_add rejects a negative id with -1.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <shared_mutex>
#include <vector>

namespace {

struct Observer {
    int64_t kf;
    int64_t feat;
};

struct MapGraph {
    std::shared_mutex mu;
    std::vector<std::vector<Observer>> observers;  // by point id, insertion order
    std::vector<std::vector<int64_t>> kf_points;   // by keyframe id, ascending point ids

    std::vector<int64_t>& points_of(int64_t kf) {
        if ((size_t)kf >= kf_points.size()) kf_points.resize(kf + 1);
        return kf_points[kf];
    }
    const std::vector<Observer>* find(int64_t pid) const {
        return pid >= 0 && (size_t)pid < observers.size() ? &observers[pid] : nullptr;
    }
    void unlink(int64_t kf, int64_t pid) {
        if ((size_t)kf >= kf_points.size()) return;
        auto& pts = kf_points[kf];
        auto it = std::lower_bound(pts.begin(), pts.end(), pid);
        if (it != pts.end() && *it == pid) pts.erase(it);
    }
};

MapGraph* G(void* h) { return static_cast<MapGraph*>(h); }

}  // namespace

extern "C" {

void* mg_new() { return new MapGraph(); }

int mg_free(void* h) {
    delete G(h);
    return 0;
}

int mg_clear(void* h) {
    std::unique_lock lock(G(h)->mu);
    G(h)->observers.clear();
    G(h)->kf_points.clear();
    return 0;
}

// obs[pid][kf] = feat
int mg_add(void* h, int64_t pid, int64_t kf, int64_t feat) {
    if (pid < 0 || kf < 0) return -1;
    auto* g = G(h);
    std::unique_lock lock(g->mu);
    if ((size_t)pid >= g->observers.size()) g->observers.resize(pid + 1);
    auto& obs = g->observers[pid];
    for (auto& o : obs) {
        if (o.kf == kf) {
            o.feat = feat;
            return 0;
        }
    }
    obs.push_back({kf, feat});
    auto& pts = g->points_of(kf);
    auto it = std::lower_bound(pts.begin(), pts.end(), pid);
    if (it == pts.end() || *it != pid) pts.insert(it, pid);
    return 0;
}

// obs[pid].pop(kf): the feature it had, or -1.
int64_t mg_erase(void* h, int64_t pid, int64_t kf) {
    auto* g = G(h);
    std::unique_lock lock(g->mu);
    if (pid < 0 || (size_t)pid >= g->observers.size()) return -1;
    auto& obs = g->observers[pid];
    for (size_t i = 0; i < obs.size(); ++i) {
        if (obs[i].kf == kf) {
            const int64_t feat = obs[i].feat;
            obs.erase(obs.begin() + i);
            g->unlink(kf, pid);
            return feat;
        }
    }
    return -1;
}

// obs.pop(pid)
int mg_erase_point(void* h, int64_t pid) {
    auto* g = G(h);
    std::unique_lock lock(g->mu);
    if (pid < 0 || (size_t)pid >= g->observers.size()) return 0;
    for (const auto& o : g->observers[pid]) g->unlink(o.kf, pid);
    std::vector<Observer>().swap(g->observers[pid]);
    return 0;
}

// Shared points of keyframe `kf` with every other keyframe: for each id in
// map_pt[0..n) that is >= 0 (repeats count again, as in the caller's loop),
// each observer of that point other than `kf` gains one. Keyframes come out
// in first-seen order.
int64_t mg_covisibility(void* h, int64_t kf, const int64_t* map_pt, int64_t n, int64_t* out_kf,
                        int64_t* out_w, int64_t cap) {
    auto* g = G(h);
    std::shared_lock lock(g->mu);
    std::vector<int64_t> weight(g->kf_points.size(), 0);
    std::vector<int64_t> order;
    for (int64_t i = 0; i < n; ++i) {
        const auto* obs = g->find(map_pt[i]);
        if (!obs) continue;
        for (const auto& o : *obs) {
            if (o.kf == kf) continue;
            if (weight[o.kf]++ == 0) order.push_back(o.kf);
        }
    }
    const int64_t m = (int64_t)order.size();
    if (m > cap) return m;
    for (int64_t j = 0; j < m; ++j) {
        out_kf[j] = order[j];
        out_w[j] = weight[order[j]];
    }
    return m;
}

// Ascending ids of the points observed by any of kfs[0..n).
int64_t mg_points_seen_by(void* h, const int64_t* kfs, int64_t n, int64_t* out, int64_t cap) {
    auto* g = G(h);
    std::shared_lock lock(g->mu);
    std::vector<int64_t> acc;
    for (int64_t i = 0; i < n; ++i) {
        if (kfs[i] < 0 || (size_t)kfs[i] >= g->kf_points.size()) continue;
        const auto& pts = g->kf_points[kfs[i]];
        acc.insert(acc.end(), pts.begin(), pts.end());
    }
    std::sort(acc.begin(), acc.end());
    acc.erase(std::unique(acc.begin(), acc.end()), acc.end());
    const int64_t m = (int64_t)acc.size();
    if (m > cap) return m;
    std::copy(acc.begin(), acc.end(), out);
    return m;
}

// The observations of pids[0..n) as rows (index into pids, kf, feat): pids'
// order, then each point's observer order.
int64_t mg_export_observers(void* h, const int64_t* pids, int64_t n, int64_t* out_idx, int64_t* out_kf,
                            int64_t* out_feat, int64_t cap) {
    auto* g = G(h);
    std::shared_lock lock(g->mu);
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        const auto* obs = g->find(pids[i]);
        if (obs) total += (int64_t)obs->size();
    }
    if (total > cap) return total;
    int64_t r = 0;
    for (int64_t i = 0; i < n; ++i) {
        const auto* obs = g->find(pids[i]);
        if (!obs) continue;
        for (const auto& o : *obs) {
            out_idx[r] = i;
            out_kf[r] = o.kf;
            out_feat[r] = o.feat;
            ++r;
        }
    }
    return total;
}

}  // extern "C"
