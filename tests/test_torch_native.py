"""The port's host C++ runtime (native/, csrc/{mapgraph,invindex,vocloader}.cpp)
against its Python twins and the JAX package's dict paths, on the CPU.

- The Map index: seeded random sequences of keyframe creation, observation
  adds and erasures, point replacement, point erasure, keyframe erasure and
  covisibility updates drive a Map on each index; covisibility (weights and
  order), parents, children, `_observer_csr` rows (order included) and
  `points_seen_by` are identical. The same sequences through the JAX Map on
  its dict path (`_native = None`) give the same counts and the same sets.
- The inverted file: scores bit-equal to `ops/bow.l1_score` over 500 random
  vector pairs of 1-2000 words (numpy's pairwise float32 summation,
  reproduced in C++), and query candidates equal to the Python twin's, in
  order.
- The DBoW2 parser: bit-equal to `_parse_dbow2_text_py` on files whose
  weights have 9-17 significant digits, exponents, signs and underscores,
  with CRLF and CR line ends, short (skipped) and long lines; the same
  ValueError for a file that is not a vocabulary.
- Two threads, one mutating and one querying each native object, end in the
  state of the serial replay.
- RGB-D SLAM through `System(device="cpu")` on each index: the same
  trajectory and keyframes to the bit.

Chosen differences from the JAX package's native index (its outputs follow
its hash containers): covisibility is counted in first-seen order over the
keyframe's `map_pt`, so ties between equal weights break as the dict path
breaks them, and `points_seen_by` returns sorted ids. The parser raises
ValueError for a descriptor byte outside 0-255, where the Python twin raises
numpy's OverflowError."""

import threading
import types

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.models.map import Map as JMap
from orbslam2commentedbyxcm_tpu_torch import native
from orbslam2commentedbyxcm_tpu_torch.models import system as tsystem
from orbslam2commentedbyxcm_tpu_torch.models.keyframe_database import KeyFrameDatabase, _PyInvertedFile
from orbslam2commentedbyxcm_tpu_torch.models.map import Map as TMap
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.ops import bow
from orbslam2commentedbyxcm_tpu_torch.utils import vocab_tools
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

torch.set_num_threads(1)

N_KF, CAP = 9, 120


def _frame(rng, k):
    t_cw = np.eye(4, dtype=np.float32)
    t_cw[:3, 3] = [-0.3 * k, 0.02 * k, 0.05 * (k % 2)]
    return types.SimpleNamespace(
        id=k, timestamp=float(k), camera=None, n_levels=8, scale_factor=1.2,
        uv=rng.uniform(0, 320, (CAP, 2)).astype(np.float32),
        uv_und=rng.uniform(0, 320, (CAP, 2)).astype(np.float32),
        angle=rng.uniform(-3, 3, CAP).astype(np.float32),
        level=rng.integers(0, 8, CAP).astype(np.int32),
        desc=rng.integers(0, 2**32, (CAP, 8), dtype=np.uint32),
        valid=np.ones(CAP, bool),
        u_right=np.full(CAP, -1.0, np.float32), depth=np.full(CAP, -1.0, np.float32),
        t_cw=t_cw, map_pt=np.full(CAP, -1, np.int64),
    )


def _snapshot(m, rng):
    """What the index serves: covisibility and the tree per keyframe, the
    observer rows of every point and points_seen_by of keyframe sets."""
    kfs = {k: (list(kf.covis.items()), kf.parent, sorted(kf.children), kf.bad) for k, kf in m.keyframes.items()}
    rows = m._observer_csr(np.arange(m.n_points, dtype=np.int64))
    ids = sorted(m.keyframes)
    seen = [m.points_seen_by([k]) for k in ids]
    for _ in range(4):
        seen.append(m.points_seen_by(rng.choice(ids, int(rng.integers(1, len(ids) + 1)), replace=False).tolist()))
    counts = [m.n_observations(p) for p in range(m.n_points)]
    return {"kfs": kfs, "rows": [np.asarray(r) for r in rows], "seen": seen, "counts": counts}


def _drive(m, seed, n_ops=700):
    """A random operation stream; every choice reads only state both indexes
    share, so equal Maps stay in step. Returns snapshots along the way."""
    rng = np.random.default_rng(seed)
    snaps = []
    m.origin_kf_id = 0

    def live_kfs():
        return [k for k, kf in sorted(m.keyframes.items()) if not kf.bad]

    def valid_pids():
        return [p for p in range(m.n_points) if m.pt_valid[p] and m.obs.get(p)]

    def free_slot(k):
        free = np.nonzero(m.keyframes[k].map_pt < 0)[0]
        return int(rng.choice(free)) if len(free) else None

    for k in range(3):
        m.add_keyframe(_frame(rng, k))
    for step in range(n_ops):
        op = rng.choice(["point", "point", "observe", "observe", "erase_obs", "replace", "erase_point",
                         "connect", "connect", "keyframe", "erase_kf"],
                        p=[.2, .2, .15, .1, .1, .07, .04, .08, .04, .015, .005])
        kfs, pids = live_kfs(), valid_pids()
        if op == "point" and len(kfs) >= 2:
            chosen = rng.choice(kfs, int(rng.integers(2, min(5, len(kfs)) + 1)), replace=False).tolist()
            slots = [free_slot(k) for k in chosen]
            if None not in slots:
                pid = m.add_point(rng.normal(0, 3, 3).astype(np.float32) + [0, 0, 8],
                                  m.keyframes[chosen[0]].desc[slots[0]], chosen[0])
                for k, f in zip(chosen, slots):
                    m.add_observation(pid, k, f)
        elif op == "observe" and pids:
            pid = int(rng.choice(pids))
            cand = [k for k in kfs if k not in m.obs[pid]]
            if cand:
                k = int(rng.choice(cand))
                f = free_slot(k)
                if f is not None:
                    m.add_observation(pid, k, f)
        elif op == "erase_obs" and pids:
            pid = int(rng.choice(pids))
            m.erase_observation(pid, int(rng.choice(list(m.obs[pid]))))
        elif op == "replace" and len(pids) >= 2:
            a, b = rng.choice(pids, 2, replace=False)
            m.replace_point(int(a), int(b))
        elif op == "erase_point" and pids:
            m.erase_point(int(rng.choice(pids)))
        elif op == "connect" and kfs:
            m.update_connections(m.keyframes[int(rng.choice(kfs))], min_weight=int(rng.integers(1, 6)))
        elif op == "keyframe" and m.next_kf_id < N_KF:
            kf = m.add_keyframe(_frame(rng, m.next_kf_id))
            m.update_connections(kf, min_weight=3)
        elif op == "erase_kf" and len(kfs) > 3:
            m.erase_keyframe(int(rng.choice(kfs[1:])))
        if step % 175 == 174:
            for k in live_kfs():
                m.update_connections(m.keyframes[k], min_weight=3)
            snaps.append(_snapshot(m, rng))
    return snaps


SEEDS = [0, 1, 2, 3]


@pytest.mark.parametrize("seed", SEEDS)
def test_native_map_equals_python_map(seed):
    got = _drive(TMap(device="cpu", point_capacity=64, index="native"), seed)
    ref = _drive(TMap(device="cpu", point_capacity=64, index="python"), seed)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        assert g["kfs"] == r["kfs"]  # covis weights and order, parent, children, bad
        assert g["counts"] == r["counts"]
        for a, b in zip(g["rows"], r["rows"]):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)
        assert len(g["seen"]) == len(r["seen"])
        for a, b in zip(g["seen"], r["seen"]):
            np.testing.assert_array_equal(a, b)
    last = got[-1]
    assert len(last["rows"][0]) > 200 and sum(len(v[0]) > 0 for v in last["kfs"].values()) >= 3


@pytest.mark.parametrize("seed", SEEDS)
def test_native_map_matches_jax_dict_path(seed):
    jm = JMap(point_capacity=64)
    jm._native = None
    ref = _drive(jm, seed)
    got = _drive(TMap(device="cpu", point_capacity=64, index="native"), seed)
    for g, r in zip(got, ref):
        assert {k: (dict(c), p, ch, b) for k, (c, p, ch, b) in g["kfs"].items()} == \
               {k: (dict(c), p, ch, b) for k, (c, p, ch, b) in r["kfs"].items()}
        assert g["counts"] == r["counts"]
        assert sorted(zip(*(a.tolist() for a in g["rows"]))) == sorted(zip(*(a.tolist() for a in r["rows"])))
        for a, b in zip(g["seen"], r["seen"]):
            assert len(a) == len(b) and set(a.tolist()) == set(b.tolist())


def _random_vector(rng, n, pool=None):
    ids = (rng.choice(pool, n, replace=False) if pool is not None
           else rng.choice(1_000_000, n, replace=False))
    ids = np.sort(ids).astype(np.int32)
    vals = (rng.random(n) * rng.choice([1e-3, 1.0, 30.0], n)).astype(np.float32)
    return ids, (vals / vals.sum()).astype(np.float32)


def test_inverted_index_scores_bit_equal_to_l1_score():
    rng = np.random.default_rng(7)
    idx = native.InvertedIndex()
    for i in range(500):
        n = int(rng.integers(1, 2001))
        a = _random_vector(rng, n)
        # the second vector shares most of the first's words, so the common
        # set runs over the whole 1-2000 range
        share = a[0][rng.random(n) < rng.uniform(0.5, 1.0)]
        extra = rng.choice(1_000_000, int(rng.integers(0, 50)), replace=False).astype(np.int32)
        ids_b = np.unique(np.concatenate([share, extra])).astype(np.int32)
        vals_b = rng.random(len(ids_b)).astype(np.float32)
        b = ids_b, (vals_b / vals_b.sum()).astype(np.float32)
        idx.add(2 * i, *a)
        idx.add(2 * i + 1, *b)
        want = bow.l1_score(*a, *b)
        assert idx.score(2 * i, 2 * i + 1) == want, (i, n)
        assert idx.score_vec(*a, 2 * i + 1) == want
    assert idx.score(0, 10**6) == 0.0 and len(idx) == 1000


def _stub_world(ids, covis):
    kfs = {i: types.SimpleNamespace(bad=False, best_covisible=lambda n, c=covis.get(i, []): c[:n]) for i in ids}
    return types.SimpleNamespace(keyframes=kfs)


def test_inverted_index_candidates_equal_python():
    rng = np.random.default_rng(11)
    pool = np.arange(5000)
    vecs = {k: _random_vector(rng, int(rng.integers(20, 400)), pool) for k in range(60)}
    nat, py = native.InvertedIndex(), _PyInvertedFile()
    for k, v in vecs.items():
        nat.add(k, *v)
        py.add(k, *v)
    for k in (3, 17, 40):
        nat.erase(k)
        py.erase(k)
    nat.add(17, *vecs[17])  # re-registered: appended to its words' lists
    py.add(17, *vecs[17])
    assert len(nat) == len(py) == 58 and nat.kf_ids() == py.kf_ids()
    n_cands = 0
    for q in range(40):
        ids, vals = _random_vector(rng, int(rng.integers(50, 500)), pool)
        exclude = set(rng.choice(60, 5, replace=False).tolist())
        for min_score in (-np.inf, 0.0, 0.05):
            got, ref = nat.query(ids, vals, exclude, min_score), py.query(ids, vals, exclude, min_score)
            assert got == ref
            n_cands += len(got[0])
    assert n_cands > 100
    covis = {k: [j for j in (k - 1, k + 1, k + 7) if j in vecs] for k in vecs}
    world = _stub_world([k for k in vecs if k not in (3, 40)], covis)
    dbs = {}
    for index in ("native", "python"):
        db = KeyFrameDatabase(None, index=index)
        for k, v in vecs.items():
            db.add(k, *v)
        db.erase(3)
        db.erase(40)
        dbs[index] = db
    for q in range(0, 60, 3):
        for index in ("native", "python"):
            assert dbs[index].index == index
        ids, vals = vecs[q]
        loops = [db.detect_loop_candidates(q, ids, vals, 0.01, {q + 1}, world) for db in dbs.values()]
        relocs = [db.detect_relocalization_candidates(ids, vals, world) for db in dbs.values()]
        assert loops[0] == loops[1] and relocs[0] == relocs[1]
        assert dbs["native"].score_vec((ids, vals), q + 2) == dbs["python"].score_vec((ids, vals), q + 2)


def _write_vocabulary(path, rng, k=4, depth=3, digits=(9, 17), newline="\n", junk=False):
    """A k-ary tree in BFS order; weights printed with 9-17 significant
    digits in assorted float() spellings."""
    lines = [f"{k} {depth} 0 0"]
    starts = [0, 1]
    for lv in range(1, depth + 1):
        starts.append(starts[-1] + k**lv)
    for nid in range(1, starts[-1]):
        lvl = next(lv for lv in range(1, depth + 1) if starts[lv] <= nid < starts[lv + 1])
        parent = 0 if lvl == 1 else starts[lvl - 1] + (nid - starts[lvl]) // k
        w = float(rng.uniform(0, 1) * 10.0 ** rng.integers(-12, 3)) if lvl == depth else 0.0
        d = int(rng.integers(digits[0], digits[1] + 1))
        spell = nid % 6
        if spell == 0:
            ws = f"{w:.{d - 1}e}"
        elif spell == 1:
            ws = f"{w:.{d - 1}E}".replace("E-0", "E-")
        elif spell == 2:
            ws = repr(w)
        elif spell == 3:
            ws = "+" + f"{w:.{d}g}"
        elif spell == 4:
            mant, exp = f"{w:.{d - 1}e}".split("e")
            ws = f"{mant}e{exp[0]}00{exp[1:]}"  # zero-padded exponent
        else:
            s = f"{w:.{d}f}"
            ws = s[:2] + "_" + s[2:] if len(s) > 3 and s[1].isdigit() and s[2].isdigit() else s
        desc = " ".join(str(int(x)) for x in rng.integers(0, 256, 32))
        lines.append(f"{parent}\t{int(lvl == depth)} {desc} {ws}")
        if junk and nid % 7 == 0:
            lines.append("1 2 3 short line skipped")
            lines.append(f"{parent} 0 {desc} 0.5 trailing tokens ignored")
    path.write_bytes((newline.join(lines) + newline).encode())


def _assert_parse_equal(path):
    got = native.parse_dbow2_text(str(path))
    ref = vocab_tools._parse_dbow2_text_py(str(path))
    assert got[:2] == ref[:2]
    for a, b in zip(got[2:], ref[2:]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    return got


@pytest.mark.parametrize("newline,junk", [("\n", False), ("\r\n", True), ("\r", True)])
def test_parse_dbow2_text_bit_equal(tmp_path, newline, junk):
    rng = np.random.default_rng(len(newline) + junk)
    path = tmp_path / "voc.txt"
    _write_vocabulary(path, rng, newline=newline, junk=junk)
    got = _assert_parse_equal(path)
    assert len(got[2]) == 84 + (84 // 7 if junk else 0) and (got[5] > 0).sum() >= 60
    # the import through either parser builds the same tree
    a = vocab_tools.import_dbow2_text(str(path))
    b = vocab_tools.import_dbow2_text(str(path), parser="python")
    for name in ("node_desc", "node_children", "node_parent", "node_level", "word_id", "word_weight", "word_node"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


def test_parse_dbow2_text_rounding_cases(tmp_path):
    """Weights whose double rounding to float32 differs from a direct
    decimal -> float32 parse (what strtof would give), and float() spellings."""
    rng = np.random.default_rng(5)
    f32 = rng.random(400).astype(np.float32).astype(np.float64)
    nxt = np.nextafter(f32.astype(np.float32), np.float32(2)).astype(np.float64)
    mids = (f32 + nxt) / 2  # exactly between two float32 values in double
    weights = [f"{m:.17g}" for m in mids] + [f"{m:.17g}1" for m in mids]
    weights += ["1e-45", "1.4e-45", "3.4028235e38", "1e39", "-0", ".5", "5.", "1_0.2_5", "1e1_0", "inf",
                "-Infinity", "nan", "+1E+2", "0000.1"]
    desc = " ".join(["7"] * 32)
    text = "10 6 0 0\n" + "".join(f"0 1 {desc} {w}\n" for w in weights)
    path = tmp_path / "round.txt"
    path.write_text(text)
    got = _assert_parse_equal(path)
    assert len(got[5]) == len(weights)


@pytest.mark.parametrize("text", [
    "this is not a vocabulary\n1 2 3\n",
    "",
    "10\n",
    "10 6 0 0\n0 1 " + " ".join(["1"] * 32) + " abc\n",
    "10 6 0 0\n0 1 " + " ".join(["1"] * 32) + " 0x1p3\n",
    "10 6 0 0\n0.5 1 " + " ".join(["1"] * 32) + " 0.1\n",
    "10 6 0 0\n0 1 " + " ".join(["1"] * 31) + " 1_ 0.1\n",
    "10 6 0 0\n0 1 " + " ".join(["1"] * 32) + " 1._5\n",
    "10 6 0 0\n",
    "0 6 0 0\n0 1 " + " ".join(["1"] * 32) + " 0.1\n",
])
@pytest.mark.parametrize("parser", ["native", "python"])
def test_import_rejects_malformed(tmp_path, text, parser):
    path = tmp_path / "bad.txt"
    path.write_text(text)
    with pytest.raises(ValueError, match="not a DBoW2 text vocabulary"):
        vocab_tools.import_dbow2_text(str(path), parser=parser)


def test_parse_rejects_out_of_range_byte(tmp_path):
    path = tmp_path / "bad.txt"
    path.write_text("10 6 0 0\n0 1 " + " ".join(["256"] * 32) + " 0.1\n")
    with pytest.raises(ValueError, match="not a DBoW2 text vocabulary"):
        native.parse_dbow2_text(str(path))


def _graph_ops(seed, n=6000):
    rng = np.random.default_rng(seed)
    ops, obs = [], {}
    for _ in range(n):
        r = rng.random()
        if r < 0.6 or not obs:
            pid, kf = int(rng.integers(0, 800)), int(rng.integers(0, 40))
            ops.append(("add", pid, kf, int(rng.integers(0, 1000))))
            obs.setdefault(pid, set()).add(kf)
        elif r < 0.9:
            pid = int(rng.choice(sorted(obs)))
            kf = int(rng.choice(sorted(obs[pid]))) if obs[pid] else 0
            ops.append(("erase", pid, kf))
            obs[pid].discard(kf)
        else:
            pid = int(rng.choice(sorted(obs)))
            ops.append(("erase_point", pid))
            obs.pop(pid)
    return ops


def _apply(g, op):
    if op[0] == "add":
        g.add(*op[1:])
    elif op[0] == "erase":
        g.erase(*op[1:])
    else:
        g.erase_point(op[1])


def _graph_state(g):
    rows = g.export_observers(np.arange(800))
    return [r.tolist() for r in rows], [g.points_seen_by([k]).tolist() for k in range(40)]


def test_two_threads_map_graph():
    ops = _graph_ops(3)
    g, done, errors = native.MapGraph(), threading.Event(), []

    def reader():
        rng = np.random.default_rng(0)
        try:
            while not done.is_set():
                seen = g.points_seen_by(rng.integers(0, 40, 5).tolist())
                assert np.all(np.diff(seen) > 0)
                idx, kfs, _ = g.export_observers(np.arange(800))
                assert np.all(np.diff(idx) >= 0) and len(idx) == len(kfs)
                other, w = g.covisibility(int(rng.integers(0, 40)), rng.integers(-1, 800, 300))
                assert len(set(other.tolist())) == len(other) and np.all(w > 0)
        except Exception as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    t = threading.Thread(target=reader)
    t.start()
    for op in ops:
        _apply(g, op)
    done.set()
    t.join()
    assert not errors, errors
    serial = native.MapGraph()
    for op in ops:
        _apply(serial, op)
    assert _graph_state(g) == _graph_state(serial)


def test_two_threads_inverted_index():
    rng = np.random.default_rng(4)
    pool = np.arange(3000)
    vecs = [_random_vector(rng, int(rng.integers(10, 300)), pool) for _ in range(300)]
    ops = [("add", i, vecs[i]) if i < 150 or rng.random() < 0.6 else ("erase", int(rng.integers(0, i)), None)
           for i in range(300)]
    idx, done, errors = native.InvertedIndex(), threading.Event(), []

    def reader():
        try:
            q = 0
            while not done.is_set():
                kfs, scores = idx.query(*vecs[q % 300], set(), -np.inf)
                assert len(set(kfs)) == len(kfs) and all(0.0 <= s <= 1.0 + 1e-6 for s in scores)
                q += 1
        except Exception as exc:  # noqa: BLE001 - re-raised on the main thread
            errors.append(exc)

    def apply(x, op):
        if op[0] == "add":
            x.add(op[1], *op[2])
        else:
            x.erase(op[1])

    t = threading.Thread(target=reader)
    t.start()
    for op in ops:
        apply(idx, op)
    done.set()
    t.join()
    assert not errors, errors
    serial = native.InvertedIndex()
    for op in ops:
        apply(serial, op)
    assert idx.kf_ids() == serial.kf_ids()
    for q in range(0, 300, 7):
        assert idx.query(*vecs[q], {1, 2}, 0.0) == serial.query(*vecs[q], {1, 2}, 0.0)


def test_copying_a_native_object_raises():
    import copy

    for obj in (native.MapGraph(), native.InvertedIndex()):
        with pytest.raises(TypeError):
            copy.deepcopy(obj)


N_SYSTEM = 20


def _slam_run(index):
    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35, tex_size=256)
    s = tsystem.System(cam, tsystem.Sensor.RGBD, config=TrackingConfig(n_features=300, max_frames_between_kf=2),
                       device="cpu", index=index)
    poses = [s.track_rgbd(seq.render(i), seq.depth_map(i), i / 30.0) for i in range(N_SYSTEM)]
    s.shutdown()
    return s, poses


@pytest.fixture(scope="module")
def slam_runs():
    return _slam_run("native"), _slam_run("python")


def test_system_native_equals_python(slam_runs):
    (sn, pn), (sp, pp) = slam_runs
    assert sn.map.index == "native" and sp.map.index == "python"
    assert sn.keyframe_db.index == "native" and sp.keyframe_db.index == "python"
    assert all(p is not None for p in pn)
    for a, b in zip(pn, pp):
        np.testing.assert_array_equal(a, b)
    for (ta, a), (tb, b) in zip(sn.frame_trajectory(), sp.frame_trajectory()):
        assert ta == tb
        np.testing.assert_array_equal(a, b)
    assert sorted(sn.map.keyframes) == sorted(sp.map.keyframes)
    assert len(sn.map.good_keyframes()) >= 6
    for k, kf in sn.map.keyframes.items():
        other = sp.map.keyframes[k]
        assert list(kf.covis.items()) == list(other.covis.items())
        assert (kf.parent, kf.children, kf.bad) == (other.parent, other.children, other.bad)
        np.testing.assert_array_equal(kf.map_pt, other.map_pt)
        np.testing.assert_array_equal(kf.t_cw, other.t_cw)
    assert sn.map.obs == sp.map.obs
    np.testing.assert_array_equal(sn.map.pt_xyz, sp.map.pt_xyz)
    # the lazy vocabulary was trained and the keyframes registered on both
    assert sn.vocabulary is not None and sn.keyframe_db.kf_ids() == sp.keyframe_db.kf_ids()
    assert len(sn.keyframe_db) >= 5
    every = sorted(sn.map.keyframes)
    np.testing.assert_array_equal(sn.map.points_seen_by(every), sp.map.points_seen_by(every))
