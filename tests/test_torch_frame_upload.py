"""The System's frame upload (`System._image`) on the CPU.

A uint8 or uint16 image crosses to the System's device as it is and turns
grey there: the float32 channel sum over a device tensor holding the
channel count. Each case holds the result bit for bit against numpy's
float64 mean cast to float32, the grey the upload made on the host before.
A float image or another integer image keeps its own mean, numpy's on the
host or torch's for a tensor. The card's twin of the integer cases is in
test_torch_kernels_cuda.
"""

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu_torch.models.system import Sensor, System
from orbslam2commentedbyxcm_tpu_torch.models.tracking import TrackingConfig
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence
from orbslam2commentedbyxcm_tpu_torch.utils.tracing import Tracer

torch.set_num_threads(1)

CAM = Camera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240, bf=20.0)


def _system(tracer=None):
    return System(CAM, Sensor.RGBD, config=TrackingConfig(n_features=600), enable_loop_closing=False,
                  tracer=tracer, device="cpu")


def every_uint8_sum():
    """(1, 766, 3) uint8: pixel s has the channel sum s, for s = 0..765."""
    s = np.arange(766)
    return np.stack([np.minimum(s, 255), np.clip(s - 255, 0, 255), np.clip(s - 510, 0, 255)], -1)[None].astype(np.uint8)


def _random(dtype, shape, seed=7):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(info.min, info.max, shape, endpoint=True).astype(dtype)


INTEGER_IMAGES = {
    "every_uint8_sum": every_uint8_sum,
    "rgb_uint8_480x640": lambda: _random(np.uint8, (480, 640, 3)),
    "rgb_uint16": lambda: _random(np.uint16, (60, 80, 3)),
    "rgba_uint8": lambda: _random(np.uint8, (60, 80, 4)),
    "grey_uint8": lambda: _random(np.uint8, (60, 80)),
    "grey_uint16": lambda: _random(np.uint16, (60, 80)),
    "rgb_uint8_strided": lambda: _random(np.uint8, (60, 80, 3))[:, ::-1, ::-1],
}


def _numpy_grey(img):
    img = np.asarray(img)
    return (img.mean(axis=-1) if img.ndim == 3 else img).astype(np.float32)


def _assert_same_bits(out, ref):
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref.view(np.uint32))


def test_every_uint8_sum_is_covered():
    img = every_uint8_sum()
    np.testing.assert_array_equal(img.astype(np.int64).sum(-1)[0], np.arange(766))


@pytest.mark.parametrize("kind", list(INTEGER_IMAGES))
@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
def test_integer_image_is_numpy_mean_bit_for_bit(kind, as_tensor):
    img = INTEGER_IMAGES[kind]()
    ref = _numpy_grey(img)
    tracer = Tracer()
    s = _system(tracer)
    out = s._image(torch.from_numpy(img.copy()) if as_tensor else img)
    _assert_same_bits(out, ref)
    assert tracer.stats()["counters"] == {"grey_on_device": 1.0}


def test_channel_count_is_made_once_per_system():
    s = _system()
    a = s._image(_random(np.uint8, (8, 8, 3)))
    s._image(_random(np.uint8, (8, 8, 3), seed=8))
    s._image(_random(np.uint8, (8, 8, 4)))
    assert a.device == s.device
    assert sorted(s._channel_counts) == [3, 4]
    assert s._channel_counts[3].dtype == torch.float32 and float(s._channel_counts[3]) == 3.0


@pytest.mark.parametrize("kind", ["rgb_float32", "rgb_float64", "grey_float32", "rgb_int16", "rgb_int32"])
def test_other_numpy_images_keep_the_host_mean(kind):
    rng = np.random.default_rng(3)
    img = {
        "rgb_float32": lambda: rng.uniform(0, 255, (60, 80, 3)).astype(np.float32),
        "rgb_float64": lambda: rng.uniform(0, 255, (60, 80, 3)),
        "grey_float32": lambda: rng.uniform(0, 255, (60, 80)).astype(np.float32),
        "rgb_int16": lambda: _random(np.int16, (60, 80, 3)),
        "rgb_int32": lambda: rng.integers(0, 2**30, (60, 80, 3)).astype(np.int32),
    }[kind]()
    tracer = Tracer()
    _assert_same_bits(_system(tracer)._image(img), _numpy_grey(img))
    assert tracer.stats()["counters"] == {"grey_on_host": 1.0}


@pytest.mark.parametrize("ndim", [3, 2])
def test_float_tensor_keeps_the_torch_mean(ndim):
    img = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, (60, 80, 3)[:ndim]).astype(np.float32))
    tracer = Tracer()
    out = _system(tracer)._image(img)
    _assert_same_bits(out, (img.mean(dim=-1) if ndim == 3 else img).numpy())
    assert tracer.stats()["counters"] == {"grey_on_host": 1.0}


def test_rgbd_frame_from_uint8_matches_its_float_grey():
    """One track_rgbd frame given a colour uint8 frame extracts what one
    given numpy's float32 grey of it extracts, every field of every slot."""
    seq = BoxSequence(camera=CAM, seed=5, n_frames=100, turns=0.35)
    grey = seq.render(0)
    noise = np.random.default_rng(9).integers(-20, 21, grey.shape + (3,))
    rgb = np.clip(np.round(grey)[..., None] + noise, 0, 255).astype(np.uint8)
    feats = []
    for img, path in ((rgb, "grey_on_device"), (_numpy_grey(rgb), "grey_on_host")):
        tracer = Tracer()
        s = _system(tracer)
        assert s.track_rgbd(img, seq.depth_map(0), 0.0) is not None
        assert tracer.stats()["counters"][path] == 1.0
        feats.append(s.tracking.last_frame.feats)
    for f in feats[0]._fields:
        assert torch.equal(getattr(feats[0], f), getattr(feats[1], f)), f
    assert int(feats[0].valid.sum()) > 300
