"""The port's selection twin (ops/orb.select_level, select_plain over the
pyramid) against the JAX ORBExtractor._extract_level's selection (XLA path),
both fed the very same level maps; and the select kernel's two rankings
(csrc/select.cu: a bitonic sort of (key, index) pairs padded with +inf keys,
and, for a level too large for one block's sort, ranking by count in tiles)
walked on the CPU against the stable sort.

Every step of the selection is exact (max, min, compares, one float32
subtraction per key, a total order), so every slot must be bit-equal, valid
or not: px, py (through uv), response and valid.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import orb as jorb
from orbslam2commentedbyxcm_tpu.ops import pallas_frontend as jpf
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu.utils.synth import default_camera as j_default_camera
from orbslam2commentedbyxcm_tpu_torch import kernels
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
from orbslam2commentedbyxcm_tpu_torch.ops import select_kernel as sk
from orbslam2commentedbyxcm_tpu_torch.ops.orb import MARGIN, select_level, select_plain
from orbslam2commentedbyxcm_tpu_torch.utils import convert

torch.set_num_threads(1)


def _jax_selection(je, maps, lvl, monkeypatch):
    """JAX `_extract_level` on these (blurred, nms_hi, nms_lo) level maps:
    its Pallas branch reads the maps from `fused_frontend`, patched here to
    hand them over -> (uv, response, valid) as numpy."""
    monkeypatch.setattr(jpf, "fused_frontend", lambda img, th_hi, th_lo: tuple(jnp.asarray(m) for m in maps))
    monkeypatch.setattr(je, "use_pallas", True)
    h, w = maps[0].shape
    uv, resp, _, _, _, valid = je._extract_level(jnp.zeros((h, w), jnp.float32), lvl, h, w)
    return np.asarray(uv), np.asarray(resp), np.asarray(valid)


def _port_selection(pe, maps, lvl):
    px, py, resp, valid = select_level(torch.from_numpy(maps[1]), torch.from_numpy(maps[2]), pe.budgets[lvl],
                                       pe.cell_size, pe.per_cell_k)
    scale = torch.tensor(pe.scales[lvl], dtype=torch.float32)
    uv = torch.stack([px.float(), py.float()], dim=-1) * scale
    return uv.numpy(), resp.numpy(), valid.numpy()


def _frontend_maps(img, th_hi=20.0, th_lo=7.0):
    return tuple(m.numpy() for m in fk.fused_frontend_plain(torch.from_numpy(img.astype(np.float32)), th_hi, th_lo))


def _image(kind, w, h, rng):
    if kind == "uint8":
        return rng.integers(0, 256, (h, w)).astype(np.float32)
    if kind == "tile":  # a 32x32 texture repeated: every cell scores the same
        tile = rng.integers(0, 256, (32, 32))
        return np.tile(tile, (h // 32 + 1, w // 32 + 1))[:h, :w].astype(np.float32)
    return JBoxSequence(camera=j_default_camera(w, h), seed=5, n_frames=100, turns=0.35).render(2)


def _tie_maps(rng, h, w):
    """Sparse small integer scores: equal values within and across cells."""
    hi = (rng.integers(1, 4, (h, w)) * (rng.random((h, w)) < 0.02)).astype(np.float32) * 30.0
    lo = (rng.integers(1, 3, (h, w)) * (rng.random((h, w)) < 0.2)).astype(np.float32) * 8.0
    return np.zeros((h, w), np.float32), hi, lo


CASES = {
    # name: (image w, h, n_features, level, how the maps are made)
    "random_level": (160, 120, 200, 0, "uint8"),
    "box_level_2": (160, 120, 200, 2, "frame"),
    "tie_heavy_tile": (160, 120, 200, 0, "tile"),
    "tie_heavy_maps": (160, 120, 200, 1, "ties"),
    "all_zero": (160, 120, 200, 0, "zero"),
    "n_take_below_budget_64x48": (64, 48, 200, 0, "uint8"),
    "doubled_init_budget": (320, 240, 2000, 0, "frame"),
    "odd_width_1241x376": (1241, 376, 2000, 0, "frame"),
    "odd_width_1241x376_level_3": (1241, 376, 2000, 3, "frame"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_selection_twin_matches_jax(case, rng, monkeypatch):
    w, h, nf, lvl, kind = CASES[case]
    je = jorb.ORBExtractor(n_features=nf, use_pallas=False)
    pe = convert.extractor_from_jax(je)
    hl, wl = max(16, round(h / je.scales[lvl])), max(16, round(w / je.scales[lvl]))
    if kind == "zero":
        maps = tuple(np.zeros((hl, wl), np.float32) for _ in range(3))
    elif kind == "ties":
        maps = _tie_maps(rng, hl, wl)
    else:
        img = _image(kind, wl, hl, rng)
        maps = _frontend_maps(img)
    uv_j, resp_j, valid_j = _jax_selection(je, maps, lvl, monkeypatch)
    uv_p, resp_p, valid_p = _port_selection(pe, maps, lvl)
    np.testing.assert_array_equal(valid_p, valid_j)
    np.testing.assert_array_equal(uv_p, uv_j)
    np.testing.assert_array_equal(resp_p, resp_j)
    n_keys = -(-hl // 32) * -(-wl // 32) * 4
    if case.startswith("n_take") or case == "doubled_init_budget":
        assert n_keys < je.budgets[lvl]  # padding slots past n_take
    if kind == "zero":
        assert not valid_p.any()
    else:
        assert valid_p.sum() > 0
    if kind in ("tile", "ties"):
        assert len(resp_p[valid_p]) - len(np.unique(resp_p[valid_p])) > 10  # the ranking really had ties


def test_select_plain_fills_each_levels_slots(rng):
    """select_plain over a LevelTable writes level l's select_level outputs
    to its slot range and skips levels with no budget."""
    shapes = ((120, 160), (100, 133), (83, 111))
    table = fk.level_table(shapes)
    maps = torch.zeros((3, table.total))
    for lvl, (h, w) in enumerate(shapes):
        for m in (1, 2):
            fk.level_views(maps[m], table)[lvl].copy_(torch.from_numpy(_tie_maps(rng, h, w)[m]))
    budgets = [40, 0, 25]
    pxy, resp, valid = select_plain(maps, table, budgets, 32, 4)
    assert pxy.dtype == torch.int32 and pxy.shape == (2, 65)
    at = 0
    for lvl, budget in enumerate(budgets):
        if budget:
            px, py, r, v = select_level(fk.level_views(maps[1], table)[lvl], fk.level_views(maps[2], table)[lvl],
                                        budget, 32, 4)
            assert torch.equal(pxy[0, at : at + budget], px.int()) and torch.equal(pxy[1, at : at + budget], py.int())
            assert torch.equal(resp[at : at + budget], r) and torch.equal(valid[at : at + budget], v)
        at += budget
    # the wrapper takes the twin for a CPU tensor and counts no launch
    before = sk.select_keypoints.launches
    got = sk.select_keypoints(maps, table, budgets, 32, 4)
    assert sk.select_keypoints.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, (pxy, resp, valid)))


def test_select_plan_layout_and_limits():
    """The kernel's table: keys and slots of each level in turn, a level
    without a budget holds no keys; cells and k the kernel does not take
    raise, and a level of any size is taken (a large one is ranked by
    count)."""
    plan = sk.select_plan(((480, 640), (400, 533), (16, 16)), (0, 307200, 520416), (300, 200, 0), 32, 4)
    assert plan.levels[0] == (0, 480, 640, 15, 20, 0, 0, 300)
    assert plan.levels[1] == (307200, 400, 533, 13, 17, 1200, 300, 200)
    assert plan.levels[2][5:] == (2084, 500, 0)
    assert plan.n_keys == 1200 + 13 * 17 * 4 and plan.capacity == 500
    assert MARGIN == 16
    with pytest.raises(ValueError):
        sk.select_plan(((480, 640),), (0,), (100,), 33, 4)
    with pytest.raises(ValueError):
        sk.select_plan(((480, 640),), (0,), (100,), 32, 33)
    big = sk.select_plan(((4096, 4096),), (0,), (100,), 32, 4)
    assert big.n_keys == 128 * 128 * 4 and big.capacity == 100


def _bitonic(keys: np.ndarray) -> np.ndarray:
    """csrc/select.cu's ranking network: (key, index) pairs padded with +inf
    keys to a power of two, compare-exchanged stage by stage -> the indices
    in sorted order (padding last)."""
    n = len(keys)
    p = 1
    while p < n:
        p <<= 1
    sk_ = np.concatenate([keys, np.full(p - n, np.inf, np.float32)])
    si = np.arange(p)
    t = np.arange(p // 2)
    size = 2
    while size <= p:
        stride = size >> 1
        while stride > 0:
            a = 2 * t - (t & (stride - 1))
            b = a + stride
            ka, kb, ia, ib = sk_[a], sk_[b], si[a], si[b]
            after = (ka > kb) | ((ka == kb) & (ia > ib))
            swap = after == ((a & size) == 0)
            sk_[a[swap]], sk_[b[swap]] = kb[swap], ka[swap]
            si[a[swap]], si[b[swap]] = ib[swap], ia[swap]
            stride >>= 1
        size <<= 1
    return si


@pytest.mark.parametrize("n", [1, 7, 16, 300, 1200, 8160])
def test_bitonic_network_is_the_stable_order(n, rng):
    """Keys of the kernel's form (rank * 1e6 - score, +inf for empty slots)
    with many ties: the network's order is torch's stable sort's."""
    rank = (np.arange(n) % 4).astype(np.float32)
    score = rng.integers(1, 6, n).astype(np.float32) * 7.0
    keys = np.where(rng.random(n) < 0.3, np.float32(np.inf), rank * np.float32(1e6) - score).astype(np.float32)
    want = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    np.testing.assert_array_equal(_bitonic(keys)[:n], want)


def _rank_by_count(keys: np.ndarray, budget: int, nt: int) -> tuple[np.ndarray, np.ndarray]:
    """csrc/select.cu's ranking of a level too large for one block's sort,
    with tiles of `nt` keys: per tile, each key counts the (key, index)
    pairs before it, chunk by chunk, until every key of the tile has
    `budget` before it; a key with fewer takes the slot of its count. Slots
    past the keys take key 0, invalid -> (key per slot, valid per slot);
    -1 marks a slot no key took."""
    n = len(keys)
    sel, ok = np.full(budget, -1), np.zeros(budget, bool)
    for i0 in range(0, n, nt):
        i = np.arange(i0, i0 + nt)
        ki = np.where(i < n, keys[np.minimum(i, n - 1)], np.float32(np.inf))
        before = np.zeros(nt, int)
        for j0 in range(0, n, nt):
            j = np.arange(j0, min(j0 + nt, n))
            kj = keys[j]
            before += ((kj[None] < ki[:, None]) | ((kj[None] == ki[:, None]) & (j[None] < i[:, None]))).sum(1)
            if np.all((i >= n) | (before >= budget)):
                break
        take = (i < n) & (before < budget)
        assert not (sel[before[take]] >= 0).any(), "two keys took one slot"
        sel[before[take]], ok[before[take]] = i[take], np.isfinite(ki[take])
    sel[n:], ok[n:] = 0, False
    return sel, ok


@pytest.mark.parametrize("n,budget", [(3000, 200), (3000, 2999), (700, 900), (4099, 4099)])
def test_rank_by_count_is_the_stable_order(n, budget, rng):
    """Keys of the kernel's form with many ties, +inf keys and budgets
    below, at and past the key count: the slots are the stable sort's first
    `budget` indices, every slot taken once, and slots past the keys are
    key 0 and invalid (the sorted levels' padding)."""
    rank = (np.arange(n) % 4).astype(np.float32)
    score = rng.integers(1, 6, n).astype(np.float32) * 7.0
    keys = np.where(rng.random(n) < 0.3, np.float32(np.inf), rank * np.float32(1e6) - score).astype(np.float32)
    order = torch.sort(torch.from_numpy(keys), stable=True).indices.numpy()
    n_take = min(budget, n)
    sel, ok = _rank_by_count(keys, budget, 64)
    np.testing.assert_array_equal(sel[:n_take], order[:n_take])
    np.testing.assert_array_equal(ok[:n_take], np.isfinite(keys[order[:n_take]]))
    assert (sel[n_take:] == 0).all() and not ok[n_take:].any()


def test_limits_mirror_the_kernel_source():
    """`select_kernel`'s limits (what the wrapper checks before a launch)
    are csrc/select.cu's, and no build flag can change them there or in
    csrc/describe.cu."""
    src = (kernels.CSRC / "select.cu").read_text()
    assert int(re.search(r"constexpr int MAX_CELL = (\d+);", src).group(1)) == sk.MAX_CELL
    assert int(re.search(r"constexpr int MAX_K = (\d+);", src).group(1)) == sk.MAX_K
    for name in ("select.cu", "describe.cu"):
        assert not re.search(r"^#(ifndef|define) ", (kernels.CSRC / name).read_text(), re.M), name
