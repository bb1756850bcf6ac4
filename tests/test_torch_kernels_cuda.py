"""The CUDA kernels vs their plain torch twins, on the card.

Needs an NVIDIA GPU and nvcc; every test skips without a GPU. The module
imports torch and the port only (no JAX), so it also runs where JAX is not
installed, without the repository's conftest:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.ops import describe_kernel as dk
from orbslam2commentedbyxcm_tpu_torch.ops import frontend_kernel as fk
from orbslam2commentedbyxcm_tpu_torch.ops import optim
from orbslam2commentedbyxcm_tpu_torch.ops import poseopt_kernel
from orbslam2commentedbyxcm_tpu_torch.ops import pyramid_kernel as pk
from orbslam2commentedbyxcm_tpu_torch.ops import select_kernel as sk
from orbslam2commentedbyxcm_tpu_torch.utils.geometry import se3_exp

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

CAM = (500.0, 500.0, 320.0, 240.0, 40.0)  # fx, fy, cx, cy, bf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(480, 640), (134, 179), (53, 77), (7, 7)])
@pytest.mark.parametrize("kind", ["uint8", "float"])
def test_frontend_kernel_bit_equal_to_twin(cuda_device, shape, kind):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape) if kind == "uint8" else rng.uniform(0, 255, shape)
    img = torch.from_numpy(img.astype(np.float32)).to(cuda_device)
    before = fk.fused_frontend.launches
    got = fk.fused_frontend(img, 20.0, 7.0)
    ref = fk.fused_frontend_plain(img, 20.0, 7.0)
    torch.cuda.synchronize()
    assert fk.fused_frontend.launches == before + 1
    for name, a, b in zip(("blurred", "nms_hi", "nms_lo"), got, ref):
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} pixels differ"


@pytest.mark.parametrize("size", [(640, 480), (752, 480), (1241, 376)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["uint8", "float", "scene"])
def test_pyramid_kernel_bit_equal_to_twin(cuda_device, size, kind):
    """All 8 levels of the extractor's pyramid in one launch against the
    twin level by level: bit-equal. Sizes: TUM, EuRoC and KITTI frames
    (1241 makes odd and ragged level widths); "scene" is a rendered frame
    decoded from a PNG, as the dataset readers hand it over."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

    w, h = size
    rng = np.random.default_rng(1)
    if kind == "scene":
        from orbslam2commentedbyxcm_tpu_torch.utils import png
        from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

        frame = BoxSequence(camera=default_camera(w, h), seed=12, trajectory="line").render(3)
        img = png.decode(png.encode(frame.astype(np.uint8)))
    else:
        img = rng.integers(0, 256, (h, w)) if kind == "uint8" else rng.uniform(0, 255, (h, w))
    buf, table = ORBExtractor(n_features=1000)._pyramid(torch.from_numpy(img.astype(np.float32)).to(cuda_device))
    before = fk.fused_frontend_pyramid.launches
    out = fk.fused_frontend_pyramid(buf, table, 20.0, 7.0)
    torch.cuda.synchronize()
    assert fk.fused_frontend_pyramid.launches == before + 1
    maps = [fk.level_views(o, table) for o in out]
    for lvl, level in enumerate(fk.level_views(buf, table)):
        for name, got, ref in zip(("blurred", "nms_hi", "nms_lo"), (m[lvl] for m in maps),
                                  fk.fused_frontend_plain(level, 20.0, 7.0)):
            assert torch.equal(got, ref), f"level {lvl} {name}: {int((got != ref).sum())} pixels differ"


def _pyramid_image(size, kind):
    """A TUM / EuRoC / KITTI / 1920x1080 frame: rendered ("scene") or random uint8 values."""
    w, h = size
    if kind == "scene":
        from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

        img = BoxSequence(camera=default_camera(w, h), seed=12, trajectory="line").render(3)
    else:
        img = np.random.default_rng(2).integers(0, 256, (h, w))
    return torch.from_numpy(img.astype(np.float32))


def _assert_twin_levels(buf, img, table, target):
    """Every level of `buf` bit-equal to the twin's on the card and on the CPU."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import _pyramid_plain

    for ref in (_pyramid_plain(img.to(buf.device), table, target), _pyramid_plain(img, table, target)):
        for lvl, (a, b) in enumerate(zip(fk.level_views(buf, table), fk.level_views(ref, table))):
            assert torch.equal(a.cpu(), b.cpu()), f"level {lvl}: {int((a.cpu() != b.cpu()).sum())} pixels differ"


@pytest.mark.parametrize("size", [(640, 480), (752, 480), (1241, 376)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", ["uint8", "scene"])
@pytest.mark.parametrize("gain", [False, True], ids=["no_gain", "gain"])
def test_pyramid_resize_kernel_bit_equal_to_twin(cuda_device, size, kind, gain):
    """The exposure gain and all 8 levels in one launch, gain on or off,
    against the twin, on the card and on the CPU: every level bit-equal.
    Sizes: TUM, EuRoC and KITTI frames."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

    img = _pyramid_image(size, kind)
    ext = ORBExtractor(n_features=1000, normalize_exposure=gain)
    before = pk.pyramid_resize.launches
    buf, table = ext._pyramid(img.to(cuda_device))
    torch.cuda.synchronize()
    assert pk.pyramid_resize.launches == before + 1
    _assert_twin_levels(buf, img, table, ext.exposure_target_mad if gain else None)


@pytest.mark.parametrize("kind", ["uint8", "scene"])
def test_pyramid_resize_kernel_multi_chunk_gain(cuda_device, kind):
    """1920x1080 with the gain: 2025 partials, more than one chunk of 1024,
    so the partials' sum takes its two-stage path; one launch, bit-equal."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

    img = _pyramid_image((1920, 1080), kind)
    assert -(-img.numel() // pk.CHUNK) > pk.CHUNK
    ext = ORBExtractor(n_features=1000, normalize_exposure=True)
    before = pk.pyramid_resize.launches
    buf, table = ext._pyramid(img.to(cuda_device))
    torch.cuda.synchronize()
    assert pk.pyramid_resize.launches == before + 1
    _assert_twin_levels(buf, img, table, ext.exposure_target_mad)


@pytest.mark.parametrize("gain", [False, True], ids=["no_gain", "gain"])
def test_pyramid_resize_repeats_itself(cuda_device, gain):
    """20 calls back to back on one image give identical bits: no value
    depends on which block got past a grid barrier first."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

    img = _pyramid_image((640, 480), "scene").to(cuda_device)
    ext = ORBExtractor(n_features=1000, normalize_exposure=gain)
    first, table = ext._pyramid(img)
    runs = [ext._pyramid(img)[0] for _ in range(20)]
    torch.cuda.synchronize()
    for i, buf in enumerate(runs):
        for lvl, (a, b) in enumerate(zip(fk.level_views(buf, table), fk.level_views(first, table))):
            assert torch.equal(a, b), f"call {i + 1} level {lvl}: {int((a != b).sum())} pixels differ"


def test_pyramid_resize_on_a_side_stream(cuda_device):
    """A call on a non-default stream launches there and gives the twin's
    bits (the image is written on that stream just before)."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

    img = _pyramid_image((752, 480), "scene")
    ext = ORBExtractor(n_features=1000, normalize_exposure=True)
    side = torch.cuda.Stream(cuda_device)
    with torch.cuda.stream(side):
        dev_img = img.to(cuda_device, non_blocking=True) * 1.0
        buf, table = ext._pyramid(dev_img)
    side.synchronize()
    _assert_twin_levels(buf, img, table, ext.exposure_target_mad)


def test_pyramid_resize_rejects_bad_inputs(cuda_device):
    table = fk.level_table(((64, 64), (53, 53)))
    img = torch.zeros((64, 64), device=cuda_device)
    for bad in (img.double(), img.t(), img[:, :32]):
        with pytest.raises(ValueError):
            pk.pyramid_resize(bad, table)


def _extraction_maps(device, size, kind, n_features):
    """An extractor (gain on) and K1's maps of one image on `device`."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

    w, h = size
    rng = np.random.default_rng(0)
    if kind == "uint8":
        img = rng.integers(0, 256, (h, w))
    elif kind == "tile":  # every cell the same texture: ties within and across cells
        img = np.tile(rng.integers(0, 256, (32, 32)), (h // 32 + 1, w // 32 + 1))[:h, :w]
    elif kind == "flat":  # no corner anywhere: every slot invalid
        img = np.full((h, w), 7.0)
    else:
        img = _pyramid_image(size, "scene").numpy()
    ext = ORBExtractor(n_features=n_features, normalize_exposure=True)
    buf, table = ext._pyramid(torch.from_numpy(img.astype(np.float32)).to(device))
    return ext, table, fk.fused_frontend_pyramid(buf, table, ext.ini_th, ext.min_th)


def _assert_select_describe_twins(ext, table, maps):
    """One select and one describe launch against their twins on the card
    and on the CPU: every slot bit-equal, valid or not."""
    from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import describe_plain
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import select_plain

    args = (ext.budgets, ext.cell_size, ext.per_cell_k)
    before = (sk.select_keypoints.launches, dk.describe_keypoints.launches)
    sel = sk.select_keypoints(maps, table, *args)
    tables = ext._descriptor_tables(maps.device)
    desc = dk.describe_keypoints(maps[0], table, sel[0], ext.budgets, ext.scales, tables)
    torch.cuda.synchronize()
    assert (sk.select_keypoints.launches, dk.describe_keypoints.launches) == (before[0] + 1, before[1] + 1)
    for where, m, t in (("card", maps, tables), ("CPU", maps.cpu(), ext._descriptor_tables("cpu"))):
        ref = select_plain(m, table, *args)
        for name, a, b in zip(("pxy", "response", "valid"), sel, ref):
            assert torch.equal(a.cpu(), b.cpu()), f"select {name} vs the twin on the {where}"
        ref = describe_plain(m[0], table, sel[0].to(m.device), ext.budgets, ext.scales, t)
        for name, a, b in zip(("uv", "angle", "level", "desc"), desc, ref):
            assert torch.equal(a.cpu(), b.cpu()), f"describe {name} vs the twin on the {where}"
    return sel, desc


@pytest.mark.parametrize("size", [(640, 480), (752, 480), (1241, 376), (1920, 1080)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("n_features", [1000, 1200, 2000, 4000])
def test_select_and_describe_kernels_bit_equal_to_twins(cuda_device, size, n_features):
    """Every slot of both kernels bit-equal to the twins at the TUM, EuRoC,
    KITTI and 1080p sizes, at the feature counts of TUM1, EuRoC, KITTI (and
    the mono initializer's doubled 1000) and KITTI's doubled initializer."""
    ext, table, maps = _extraction_maps(cuda_device, size, "scene", n_features)
    sel, _ = _assert_select_describe_twins(ext, table, maps)
    assert int(sel[2].sum()) > 0.5 * min(n_features, 1000)


@pytest.mark.parametrize("kind", ["scene", "tile"])
@pytest.mark.parametrize("n_features", [1000, 4000])
def test_select_and_describe_kernels_at_3840x2160(cuda_device, kind, n_features):
    """A 4K frame: levels 0 and 1 hold more keys than one block sorts
    (16384, csrc/select.cu MAX_SORT), so the kernel ranks them by count
    across the grid; every slot bit-equal all the same, ties included."""
    ext, table, maps = _extraction_maps(cuda_device, (3840, 2160), kind, n_features)
    plan = sk.select_plan(table.shapes, table.offsets, tuple(ext.budgets), 32, 4)
    assert [row[3] * row[4] * 4 > 16384 for row in plan.levels[:3]] == [True, True, False]
    sel, _ = _assert_select_describe_twins(ext, table, maps)
    assert int(sel[2].sum()) > 0.5 * min(n_features, 1000)


@pytest.mark.parametrize("kind", ["uint8", "tile", "flat"])
def test_select_and_describe_kernels_on_hard_maps(cuda_device, kind):
    """Noise, a tiled texture (ties everywhere) and a flat image (every slot
    invalid) at 640x480, and a 64x48 image with fewer keys than slots."""
    for size in ((640, 480), (64, 48)):
        ext, table, maps = _extraction_maps(cuda_device, size, kind, 1000)
        sel, _ = _assert_select_describe_twins(ext, table, maps)
        if size == (640, 480):
            assert (int(sel[2].sum()) == 0) == (kind == "flat")
        else:
            assert sk.select_plan(table.shapes, table.offsets, tuple(ext.budgets), 32, 4).n_keys < sum(ext.budgets)


def test_select_and_describe_kernels_repeat_themselves(cuda_device):
    """20 calls back to back give identical bits (no value depends on which
    block passed the grid barrier first)."""
    ext, table, maps = _extraction_maps(cuda_device, (640, 480), "scene", 1000)
    tables = ext._descriptor_tables(cuda_device)
    first = sk.select_keypoints(maps, table, ext.budgets, 32, 4)
    first_d = dk.describe_keypoints(maps[0], table, first[0], ext.budgets, ext.scales, tables)
    for i in range(20):
        sel = sk.select_keypoints(maps, table, ext.budgets, 32, 4)
        d = dk.describe_keypoints(maps[0], table, sel[0], ext.budgets, ext.scales, tables)
        assert all(torch.equal(a, b) for a, b in zip(sel + d, first + first_d)), f"call {i + 1}"


def test_select_and_describe_kernels_on_a_side_stream(cuda_device):
    """Both launch on the current stream: the maps are rewritten on a side
    stream just before, and the result is the twins'."""
    ext, table, maps = _extraction_maps(cuda_device, (752, 480), "scene", 1200)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        maps2 = maps * 1.0
        _assert_select_describe_twins(ext, table, maps2)
    side.synchronize()


def test_select_and_describe_reject_bad_inputs(cuda_device):
    ext, table, maps = _extraction_maps(cuda_device, (64, 48), "scene", 200)
    for bad in (maps.double(), maps[:, : table.total - 1], maps.t().contiguous().t()):
        with pytest.raises(ValueError):
            sk.select_keypoints(bad, table, ext.budgets, 32, 4)
    with pytest.raises(ValueError):
        sk.select_keypoints(maps, table, ext.budgets, 64, 4)
    pxy = sk.select_keypoints(maps, table, ext.budgets, 32, 4)[0]
    tables = ext._descriptor_tables(cuda_device)
    for bad in (pxy.long(), pxy[:, 1:], pxy.cpu()):
        with pytest.raises(ValueError):
            dk.describe_keypoints(maps[0], table, bad, ext.budgets, ext.scales, tables)


def test_frontend_kernel_rejects_bad_inputs(cuda_device):
    img = torch.zeros((64, 64), device=cuda_device)
    for bad in (img.double(), img.t()[:, :32], img[None]):
        with pytest.raises(ValueError):
            fk.fused_frontend(bad, 20.0, 7.0)


def _pose_problem(rng, n, stereo_frac):
    """Noisy mono/stereo observations of points seen from a known pose, 10%
    gross outliers, 5% masked edges, started from a perturbed pose."""
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    t_true = se3_exp(torch.tensor([0.1, -0.05, 0.08, 0.02, -0.03, 0.01])).numpy()
    pc = pts @ t_true[:3, :3].T + t_true[:3, 3]
    fx, fy, cx, cy, bf = CAM
    u, v = fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy
    stereo = rng.random(n) < stereo_frac
    obs = np.stack([u + rng.normal(0, 0.5, n), v + rng.normal(0, 0.5, n),
                    np.where(stereo, u - bf / pc[:, 2] + rng.normal(0, 0.5, n), -1.0)], -1).astype(np.float32)
    out = rng.choice(n, n // 10, replace=False)
    obs[out, :2] += rng.normal(0, 40, (len(out), 2))
    mask = np.ones(n, bool)
    mask[rng.choice(n, n // 20, replace=False)] = False
    t0 = se3_exp(torch.tensor([0.12, -0.02, 0.05, 0.01, -0.01, 0.03])).numpy()
    return (t0, pts, obs, mask, np.ones(n, np.float32)), t_true


@pytest.mark.parametrize("n,stereo_frac", [
    (1, 0.5), (32, 0.5), (128, 0.5), (129, 0.5), (300, 0.5),
    (1000, 0.0), (1000, 0.5), (1000, 1.0), (1200, 0.0), (1200, 0.5), (1200, 1.0),
    (2000, 0.0), (2000, 0.5), (2000, 1.0),
    (56000, 0.5), (56001, 0.5), (70000, 0.5),
])
def test_pose_kernel_matches_twin(cuda_device, n, stereo_frac):
    """Bars of tests/test_pallas_poseopt.py. Up to 128 edges one block of
    128 threads solves the problem (1, 32, 128), above a cluster of 8 (129
    and up). A block stages up to 7000 edges of its share in shared memory
    (past the 48 KB default through the opt-in limit: 2000 edges, 56000);
    beyond that it streams them from global memory (56001, 70000). Below
    300 edges the noisy observations do not pin the pose to the truth, so
    only the bars against the twin apply there. 1000, 1200 and 2000 are the
    extractor capacities of the TUM1, EuRoC and KITTI settings, each with
    mono, mixed and stereo edges. The kernel's own count of
    its work is checked against its limits."""
    args, t_true = _pose_problem(np.random.default_rng(0), n, stereo_frac)
    targs = [torch.from_numpy(a).to(cuda_device) for a in args]
    before = poseopt_kernel.pose_optimization_fused.launches
    res_k = optim.PoseOptResult(*poseopt_kernel.pose_optimization_fused(*targs, *CAM))
    res_p = optim.pose_optimization_plain(*targs, *CAM)
    assert poseopt_kernel.pose_optimization_fused.launches == before + 1
    n_inl, evals, edge_evals = poseopt_kernel.pose_optimization_fused.last_counts.tolist()
    assert n_inl == int(res_k.n_inliers)
    assert 4 <= evals <= 4 * 11 and 0 < edge_evals <= evals * int(args[3].sum())
    tk, tp = res_k.t_cw.cpu().numpy(), res_p.t_cw.cpu().numpy()
    if n >= 300:
        assert np.abs(tk - t_true).max() < 5e-3
    assert np.abs(tk - tp).max() < 2e-3
    assert int((res_k.inliers != res_p.inliers).sum()) <= max(3, n // 100)
    assert abs(int(res_k.n_inliers) - int(res_p.n_inliers)) <= 3
    assert int(res_k.n_inliers) == int(res_k.inliers.sum())


def test_pose_kernel_with_every_edge_masked(cuda_device):
    """No active edge: H = 0, dx = 0, the pose comes back unchanged."""
    args, _ = _pose_problem(np.random.default_rng(0), 1000, 0.5)
    args = (args[0], args[1], args[2], np.zeros(1000, bool), args[4])
    targs = [torch.from_numpy(a).to(cuda_device) for a in args]
    res_k = optim.pose_optimization(*targs, *CAM)
    res_p = optim.pose_optimization_plain(*targs, *CAM)
    assert torch.equal(res_k.t_cw.cpu(), targs[0].cpu()) and torch.equal(res_p.t_cw.cpu(), targs[0].cpu())
    assert int(res_k.n_inliers) == 0 and not bool(res_k.inliers.any()) and float(res_k.chi2) == 0.0
    assert poseopt_kernel.pose_optimization_fused.last_counts.tolist() == [0, 8, 0]  # per round: 1 + 1 (dx = 0 stops)


def test_argmin_is_first_occurrence_on_card(cuda_device):
    """project_and_match relies on jnp.argmin's first-minimum rule."""
    d = torch.full((4096, 1000), 7.0, device=cuda_device)
    d[100:, ::3] = 3.0
    d[5:, 1::3] = 2.0
    idx = torch.argmin(d, dim=0).cpu().numpy()
    assert (idx[::3] == 100).all() and (idx[1::3] == 5).all() and (idx[2::3] == 0).all()


def _features_by_key(f):
    """{(level, u, v): row} over the valid slots of a FrameFeatures."""
    uv, level = f.uv.cpu().numpy(), f.level.cpu().numpy()
    rows = np.flatnonzero(f.valid.cpu().numpy())
    return {(int(level[r]), float(uv[r, 0]), float(uv[r, 1])): r for r in rows}


def _compare_features(a, b):
    """Keypoints in one set only; on the shared ones, the largest angle gap
    and the number of bits by which each descriptor pair differs."""
    ka, kb = _features_by_key(a), _features_by_key(b)
    both = sorted(set(ka) & set(kb))
    ra = torch.tensor([ka[k] for k in both])
    rb = torch.tensor([kb[k] for k in both])
    ang_err = float((a.angle.cpu()[ra] - b.angle.cpu()[rb]).abs().max())
    x = (a.desc.cpu()[ra] ^ b.desc.cpu()[rb]).view(torch.uint8)
    bits = torch.stack([(x >> s) & 1 for s in range(8)]).sum((0, 2))
    only = sorted(set(ka) ^ set(kb))
    return only, len(kb), ang_err, bits


def test_extractor_on_card_matches_cpu(cuda_device):
    """The whole ORBExtractor (exposure gain, pyramid, K1, per-cell
    selection, orientation, descriptors) at 640x480, 1000 features, on the
    card against the same extractor on the CPU, each extracting on its own,
    over three BoxSequence frames.

    Every stage is one fixed order of float32 operations on both devices
    (the four kernels and their twins), so every field of every slot is
    bit-equal: uv, response, angle, level, desc and valid. Four launches per
    extraction: pyramid, K1, select and describe."""
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence, default_camera

    seq = BoxSequence(camera=default_camera(640, 480), seed=5, n_frames=100, turns=0.35)
    ext = ORBExtractor(n_features=1000, normalize_exposure=True)
    counters = (pk.pyramid_resize, fk.fused_frontend_pyramid, sk.select_keypoints, dk.describe_keypoints)
    for i in (0, 20, 40):
        img = seq.render(i)
        before = [c.launches for c in counters]
        card = ext(torch.from_numpy(img).to(cuda_device))
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
        cpu = ext(torch.from_numpy(img))
        for f in card._fields:
            assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), (i, f)
        only, n, ang_err, bits = _compare_features(card, cpu)
        print(f"frame {i}: {n} keypoints, every field bit-equal")
        assert not only and n > 500 and ang_err == 0.0 and int(bits.max()) == 0


@pytest.mark.parametrize("features", ["handed", "own"])
def test_system_on_card_matches_cpu_twins(cuda_device, features):
    """Five RGB-D frames of the System on the card (all three kernels)
    against the same frames through the System on the CPU (the twins):
    poses within 2e-3. "handed": the CPU run is given the card's features;
    "own": the CPU run extracts its own, which are the card's keypoints bit
    for bit (test_extractor_on_card_matches_cpu), so the poses hold the same
    bar."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.ops.orb import FrameFeatures
    from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(5)]
    cfg = TrackingConfig(n_features=600)
    card = System(cam, Sensor.RGBD, config=cfg, enable_loop_closing=False, device=cuda_device)
    cpu = System(cam, Sensor.RGBD, config=cfg, enable_loop_closing=False, device="cpu")
    if features == "handed":
        extracted = []
        card_extract = card.extractor
        card.extractor = lambda img: extracted.append(card_extract(img)) or extracted[-1]
        cpu.extractor = lambda img: FrameFeatures(*(t.cpu() for t in extracted.pop(0)))
    k1, k2 = fk.fused_frontend_pyramid.launches, poseopt_kernel.pose_optimization_fused.launches
    k0, s0, d0 = pk.pyramid_resize.launches, sk.select_keypoints.launches, dk.describe_keypoints.launches
    for i, (img, depth) in enumerate(frames):
        a = card.track_rgbd(img, depth, i / 30.0)
        b = cpu.track_rgbd(img, depth, i / 30.0)
        assert a is not None and b is not None
        assert np.abs(a - b).max() < 2e-3, (i, np.abs(a - b).max())
        np.testing.assert_array_equal(card.tracking.last_frame.depth, cpu.tracking.last_frame.depth)
    assert fk.fused_frontend_pyramid.launches - k1 == len(frames)  # one launch per extraction
    assert pk.pyramid_resize.launches - k0 == len(frames)  # one launch per extraction, the gain included
    assert sk.select_keypoints.launches - s0 == len(frames) and dk.describe_keypoints.launches - d0 == len(frames)
    assert poseopt_kernel.pose_optimization_fused.launches - k2 >= 2 * (len(frames) - 1)
    assert card.map.n_valid_points() == cpu.map.n_valid_points()


def test_segment_sum_repeats_on_card(cuda_device):
    """BA's and the pose graph's block sums on the card: the same inputs give
    the same bits on every call (index_add_ there adds with atomics in no
    fixed order), within float32 rounding of a float64 sum."""
    rng = np.random.default_rng(3)
    values = torch.from_numpy(rng.normal(size=(60000, 7, 7)).astype(np.float32)).to(cuda_device)
    index = torch.from_numpy(rng.integers(0, 64, 60000)).to(cuda_device)
    first = optim.segment_sum(values, index, 64)
    for _ in range(3):
        assert torch.equal(optim.segment_sum(values, index, 64), first)
    ref = torch.zeros(64, 7, 7, dtype=torch.float64).index_add_(0, index.cpu(), values.cpu().double())
    np.testing.assert_allclose(first.cpu().numpy(), ref.numpy(), atol=2e-3)


def test_async_system_on_card(cuda_device):
    """The async pipeline on the card: the mapping and loop workers launch
    onto the default stream beside tracking; every frame is tracked, the
    kernels run once per extraction, shutdown() joins both workers, and the
    map holds as many keyframes as the synchronous run's (within 1)."""
    from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
    from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
    from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence
    from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

    cam = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
    seq = BoxSequence(camera=cam, seed=5, n_frames=100, turns=0.35)
    frames = [(seq.render(i), seq.depth_map(i)) for i in range(30)]
    cfg = TrackingConfig(n_features=600, max_frames_between_kf=6)
    kfs = []
    for async_mapping in (False, True):
        s = System(cam, Sensor.RGBD, config=cfg, async_mapping=async_mapping, tracer=Tracer(), device=cuda_device)
        k1 = fk.fused_frontend_pyramid.launches
        assert all(s.track_rgbd(img, depth, i / 30.0) is not None for i, (img, depth) in enumerate(frames))
        assert fk.fused_frontend_pyramid.launches - k1 == len(frames)
        s.shutdown()
        kfs.append(len(s.map.good_keyframes()))
    assert s.vocabulary is not None and not s.local_mapping._thread.is_alive()
    assert not s._loop_worker._thread.is_alive()
    assert abs(kfs[0] - kfs[1]) <= 1 and kfs[1] >= 4
    assert s.tracer.stats()["spans"]["local_ba"]["n"] >= 3


def test_run_dataset_on_card(cuda_device, tmp_path):
    """cli.run_dataset on the card over a small TUM fixture on disk: every
    frame through K1, the pose solves through K2, the trajectory written."""
    from orbslam2commentedbyxcm_tpu_torch.cli import run_dataset
    from orbslam2commentedbyxcm_tpu_torch.utils import dataset_writers
    from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
    from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

    cam = Camera(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=80.0, fps=30.0)
    settings = dataset_writers.write_tum_rgbd(str(tmp_path), BoxSequence(camera=cam, n_frames=90, seed=11,
                                                                         turns=0.35), 12)
    k1, k2 = fk.fused_frontend_pyramid.launches, poseopt_kernel.pose_optimization_fused.launches
    assert run_dataset.main(["tum", str(tmp_path), settings, "--no-loop-closing",
                             "--out-prefix", str(tmp_path) + "/"]) == 0
    assert fk.fused_frontend_pyramid.launches - k1 == 12
    assert poseopt_kernel.pose_optimization_fused.launches - k2 >= 2 * 11
    traj = np.loadtxt(str(tmp_path / "CameraTrajectory.txt"))
    assert traj.shape == (12, 8) and np.isfinite(traj).all()


def _ba_problem(seed=0, n_poses=8, n_pts=400, stereo=True):
    """tests/test_optim.make_ba_problem's scene with the port's se3_exp:
    poses along a line, every point seen by every pose (stereo edges), poses
    and points perturbed, the first pose fixed, 5% of the edges masked."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts), rng.uniform(5, 12, n_pts)], -1)
    pts = pts.astype(np.float32)
    poses = se3_exp(torch.tensor([[0.25 * k, 0.02 * k, 0.01 * k, 0.0, 0.03 * k, 0.0] for k in range(n_poses)])).numpy()
    fx, fy, cx, cy, bf = CAM
    op, opt_, ouv = [], [], []
    for k in range(n_poses):
        pc = pts @ poses[k, :3, :3].T + poses[k, :3, 3]
        u, v = fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy
        ur = u - bf / pc[:, 2] if stereo else np.full_like(u, -1.0)
        ouv.append(np.stack([u, v, ur], -1) + rng.normal(0, 0.5, (n_pts, 3)) * [1, 1, stereo])
        op.append(np.full(n_pts, k))
        opt_.append(np.arange(n_pts))
    poses_0 = poses.copy()
    poses_0[1:] = se3_exp(torch.from_numpy(rng.normal(0, 0.02, (n_poses - 1, 6)).astype(np.float32))).numpy() \
        @ poses[1:]
    fixed = np.zeros(n_poses, bool)
    fixed[0] = True
    mask = rng.random(n_poses * n_pts) >= 0.05
    return {"poses": poses_0, "pose_fixed": fixed, "points": pts + rng.normal(0, 0.05, pts.shape).astype(np.float32),
            "point_valid": np.ones(n_pts, bool), "op": np.concatenate(op), "opt": np.concatenate(opt_),
            "ouv": np.concatenate(ouv).astype(np.float32), "omask": mask,
            "osig": np.ones(n_poses * n_pts, np.float32), "pids": np.arange(n_pts)}


def _graph_problem(k=40, e=160, seed=0):
    """tests/test_dist_posegraph.py's construction with the port's sim3_exp."""
    from orbslam2commentedbyxcm_tpu_torch.utils.geometry import sim3_exp

    rng = np.random.default_rng(seed)
    poses = np.tile(np.eye(4, dtype=np.float32), (k, 1, 1))
    poses[:, 0, 3] = 0.3 * np.arange(k)
    poses[:, 1, 3] = 0.1 * np.sin(np.arange(k))
    ei = np.concatenate([np.arange(k - 1), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.concatenate([np.arange(1, k), rng.integers(0, k, e - k + 1)]).astype(np.int32)
    ej = np.where(ei == ej, (ej + 1) % k, ej)
    meas = np.einsum("eij,ejk->eik", poses[ej], np.linalg.inv(poses[ei])).astype(np.float32)
    fixed = np.zeros(k, bool)
    fixed[0] = True
    tang = np.zeros((k, 7), np.float32)
    tang[1:] = rng.normal(0, 0.03, (k - 1, 7))
    p0 = np.einsum("kij,kjl->kil", sim3_exp(torch.from_numpy(tang)).numpy(), poses).astype(np.float32)
    return p0, fixed, ei, ej, meas, np.ones(e, bool)


def _dist_solves(device, problem, graph, n_shards):
    from orbslam2commentedbyxcm_tpu_torch.parallel import system_bridge
    from orbslam2commentedbyxcm_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(n_shards, device=device)
    ba = system_bridge.solve_ba_problem_dist(problem, SimpleNamespace(**dict(zip(("fx", "fy", "cx", "cy", "bf"), CAM))),
                                             mesh)
    g = system_bridge.solve_pose_graph_dist(*graph, mesh)
    return ba.poses, ba.points, ba.cost, g.poses.cpu().numpy()


def test_dist_solvers_on_card_repeat_and_match_cpu(cuda_device):
    """The 4-shard Schur-CG global BA and the edge-sharded pose graph on the
    card: bit-equal to themselves on a repeat (every block sum in a fixed
    order), and within float32 regrouping of the same solves on the CPU
    (poses 1e-4, points 2e-3, cost 1e-5 relative; graph 1e-4)."""
    problem, graph = _ba_problem(), _graph_problem()
    first = _dist_solves(cuda_device, problem, graph, 4)
    again = _dist_solves(cuda_device, problem, graph, 4)
    for a, b in zip(first, again):
        assert np.array_equal(a, b)
    cpu = _dist_solves("cpu", problem, graph, 4)
    np.testing.assert_allclose(first[0], cpu[0], atol=1e-4)
    np.testing.assert_allclose(first[1], cpu[1], atol=2e-3)
    assert abs(first[2] - cpu[2]) <= 1e-5 * cpu[2]
    np.testing.assert_allclose(first[3], cpu[3], atol=1e-4)


@pytest.mark.parametrize("algorithm", ["gn", "dogleg"])
def test_gn_dogleg_on_card(cuda_device, algorithm):
    """Gauss-Newton and dogleg run the plain solve on the card (K2 is not
    launched): within 2e-3 of the kernel's LM pose and of the CPU's solve."""
    args, t_true = _pose_problem(np.random.default_rng(0), 1000, 0.5)
    targs = [torch.from_numpy(a).to(cuda_device) for a in args]
    lm = optim.pose_optimization(*targs, *CAM).t_cw.cpu().numpy()
    before = poseopt_kernel.pose_optimization_fused.launches
    res = optim.pose_optimization(*targs, *CAM, algorithm=algorithm)
    assert poseopt_kernel.pose_optimization_fused.launches == before
    cpu = optim.pose_optimization(*[torch.from_numpy(a) for a in args], *CAM, algorithm=algorithm)
    t = res.t_cw.cpu().numpy()
    assert np.abs(t - t_true).max() < 5e-3
    assert np.abs(t - lm).max() < 2e-3 and np.abs(t - cpu.t_cw.numpy()).max() < 2e-3
    assert abs(int(res.n_inliers) - int(cpu.n_inliers)) <= 3
