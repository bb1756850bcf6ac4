"""State carried between the packages: extractor constants, descriptor words,
feature and map-pack conversion, and the OpenCV-free BoxSequence renderer."""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.ops import orb as jorb
from orbslam2commentedbyxcm_tpu.utils import synth as jsynth
from orbslam2commentedbyxcm_tpu_torch.ops.orb import FrameFeatures
from orbslam2commentedbyxcm_tpu_torch.utils import convert
from orbslam2commentedbyxcm_tpu_torch.utils import synth as tsynth

torch.set_num_threads(1)


@pytest.mark.parametrize("kw", [{}, dict(n_features=300, n_levels=6, scale_factor=1.3)])
def test_extractor_constants_equal(kw):
    je = jorb.ORBExtractor(use_pallas=False, **kw)
    pe = convert.extractor_from_jax(je)  # asserts pattern, masks, taps, budgets, scales
    np.testing.assert_array_equal(pe._pattern, jorb.make_brief_pattern(seed=1234))
    assert pe.capacity == je.capacity


def test_extractor_constant_mismatch_is_caught():
    je = jorb.ORBExtractor(use_pallas=False)
    je._pattern = je._pattern.copy()
    je._pattern[0, 0, 0] += 1
    with pytest.raises(AssertionError):
        convert.extractor_from_jax(je)


def test_descriptor_words_round_trip(rng):
    d = rng.integers(0, 2**32, (64, 8), dtype=np.uint32)
    d[0] = [0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 1, 0x80000000, 0xDEADBEEF]
    t = convert.desc_to_torch(d)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(convert.desc_to_numpy(t), d)


def test_pack_bits_builds_uint32_words(rng):
    from orbslam2commentedbyxcm_tpu_torch.ops.descriptors import pack_bits

    bits = rng.random((32, 256)) < 0.5
    bits[0] = True  # every word 0xFFFFFFFF: bit 31 set
    words = convert.desc_to_numpy(pack_bits(torch.from_numpy(bits)))
    ref = np.packbits(bits.reshape(32, 8, 32)[..., ::-1], axis=-1).view(">u4")[..., 0]
    np.testing.assert_array_equal(words, ref)


def test_features_and_pack_round_trip(rng):
    n, cap = 50, 64
    feats = FrameFeatures(
        uv=rng.uniform(0, 100, (n, 2)).astype(np.float32), response=rng.uniform(0, 50, n).astype(np.float32),
        angle=rng.uniform(-3, 3, n).astype(np.float32), level=rng.integers(0, 8, n).astype(np.int32),
        desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32), valid=rng.random(n) < 0.8,
    )
    back = convert.features_to_numpy(convert.features_from_numpy(feats))
    for k in FrameFeatures._fields:
        np.testing.assert_array_equal(back[k], getattr(feats, k))
    pack = (rng.normal(size=(cap, 3)).astype(np.float32), rng.integers(0, 2**32, (cap, 8), dtype=np.uint32),
            rng.normal(size=(cap, 3)).astype(np.float32), rng.uniform(0, 1, cap).astype(np.float32),
            rng.uniform(1, 9, cap).astype(np.float32), rng.random(cap) < 0.5)
    got = convert.map_pack_from_numpy(pack)
    assert got[1].dtype == torch.int32 and got[5].dtype == torch.bool
    np.testing.assert_array_equal(convert.desc_to_numpy(got[1]), pack[1])
    for a, b in zip(got[:1] + got[2:], pack[:1] + pack[2:]):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("frame", [0, 11])
def test_box_sequence_matches_cv2_render(frame):
    """Same scene and poses; the numpy warp stands in for cv2.warpPerspective
    (not installed on the GPU machine): mean |d| < 1 gray level."""
    cam_j, cam_t = jsynth.default_camera(160, 120), tsynth.default_camera(160, 120)
    seq_j = jsynth.BoxSequence(camera=cam_j, seed=5, n_frames=100, turns=0.35)
    seq_t = tsynth.BoxSequence(camera=cam_t, seed=5, n_frames=100, turns=0.35)
    np.testing.assert_array_equal(seq_t.pose(frame), seq_j.pose(frame))
    for (_, _, _, tex_j), (_, _, _, tex_t) in zip(seq_j.walls, seq_t.walls):
        np.testing.assert_array_equal(tex_t, tex_j)
    diff = np.abs(seq_t.render(frame) - seq_j.render(frame))
    print(f"frame {frame}: mean |d| {diff.mean():.4f}, max {diff.max():.3f}")
    assert diff.mean() < 1.0
    np.testing.assert_array_equal(seq_t.depth_map(frame), seq_j.depth_map(frame))


def test_render_right_matches_jax():
    """The right stereo view: the same camera displaced by the baseline."""
    cam_j, cam_t = jsynth.default_camera(160, 120), tsynth.default_camera(160, 120)
    seq_j = jsynth.BoxSequence(camera=cam_j, seed=5, n_frames=100, turns=0.35)
    seq_t = tsynth.BoxSequence(camera=cam_t, seed=5, n_frames=100, turns=0.35)
    diff = np.abs(seq_t.render_right(7) - seq_j.render_right(7))
    assert diff.mean() < 1.0
    assert np.abs(seq_t.render_right(7) - seq_t.render(7)).mean() > 5.0  # a different view


def _jax_map(rng):
    """A small JAX Map with points, observations, covisibility, a spanning
    tree, a replaced point and an erased keyframe."""
    import types

    from orbslam2commentedbyxcm_tpu.models.map import Map as JMap
    from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera

    m = JMap(point_capacity=64)
    cam = JCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)
    n = 80
    for k in range(4):
        t_cw = np.eye(4, dtype=np.float32)
        t_cw[0, 3] = -0.2 * k
        m.add_keyframe(types.SimpleNamespace(
            id=10 + k, timestamp=0.1 * k, camera=cam, n_levels=8, scale_factor=1.2,
            uv=rng.uniform(0, 300, (n, 2)).astype(np.float32), uv_und=rng.uniform(0, 300, (n, 2)).astype(np.float32),
            angle=rng.uniform(-3, 3, n).astype(np.float32), level=rng.integers(0, 8, n).astype(np.int32),
            desc=rng.integers(0, 2**32, (n, 8), dtype=np.uint32), valid=np.ones(n, bool),
            u_right=rng.uniform(0, 300, n).astype(np.float32), depth=rng.uniform(1, 9, n).astype(np.float32),
            t_cw=t_cw, map_pt=np.full(n, -1, np.int64)))
    for i in range(70):
        pid = m.add_point(rng.normal(0, 2, 3) + [0, 0, 6], m.keyframes[0].desc[i], 0)
        for k in range(4 if i < 40 else 2):
            m.add_observation(pid, k, i)
    for k in range(4):
        m.update_connections(m.keyframes[k])
    m.update_points_batch(m.all_point_ids())
    m.replace_point(3, 4)
    m.erase_keyframe(2)
    return m


def test_map_from_jax_round_trip(rng):
    jm = _jax_map(rng)
    tm = convert.map_from_jax(jm, device="cpu")
    for name in ("pt_xyz", "pt_desc", "pt_normal", "pt_dmin", "pt_dmax", "pt_valid", "pt_ref_kf",
                 "pt_first_kf", "pt_visible", "pt_found", "pt_replaced_by"):
        np.testing.assert_array_equal(getattr(tm, name), getattr(jm, name), err_msg=name)
    for name in ("n_points", "pt_version", "next_kf_id", "origin_kf_id"):
        assert getattr(tm, name) == getattr(jm, name)
    assert tm.obs == jm.obs and sorted(tm.keyframes) == sorted(jm.keyframes)
    for k, jkf in jm.keyframes.items():
        tkf = tm.keyframes[k]
        for name in ("uv", "uv_und", "angle", "level", "desc", "valid", "u_right", "depth", "t_cw", "map_pt"):
            np.testing.assert_array_equal(getattr(tkf, name), getattr(jkf, name), err_msg=name)
        for name in ("kf_id", "frame_id", "timestamp", "parent", "children", "covis", "bad"):
            assert getattr(tkf, name) == getattr(jkf, name), name
        np.testing.assert_array_equal(tkf.inv_sigma2(), jkf.inv_sigma2())
        assert tkf.camera.bf == jkf.camera.bf
    assert tm.keyframes[2].bad and tm.keyframes[2].t_child_parent is not None
    np.testing.assert_array_equal(tm.keyframes[2].t_child_parent, jm.keyframes[2].t_child_parent)
    assert set(tm.points_seen_by([0, 1])) == set(jm.points_seen_by([0, 1]).tolist())
    # a copy: the two maps go on independently, and the port's Map copies too
    back = convert.map_from_jax(tm)
    tm.erase_point(5)
    tm.keyframes[0].t_cw[0, 3] = 9.0
    assert jm.pt_valid[5] and back.pt_valid[5] and jm.keyframes[0].t_cw[0, 3] == 0.0
    assert back.obs == jm.obs and back.keyframes[3].covis == jm.keyframes[3].covis
