"""The port's dataset readers and writers (utils/datasets,
utils/dataset_writers) against the JAX package's: on files the JAX writer
wrote, the readers yield bit-equal arrays, ground truth and timestamps; the
port's writer writes files that decode to the JAX writer's images; the
Prefetcher keeps order and length and passes errors on."""

import os

import numpy as np
import pytest
import torch

from orbslam2commentedbyxcm_tpu.utils import dataset_writers as jwriters
from orbslam2commentedbyxcm_tpu.utils import datasets as jdatasets
from orbslam2commentedbyxcm_tpu.utils.camera import Camera as JCamera
from orbslam2commentedbyxcm_tpu.utils.config import load_settings as jload_settings
from orbslam2commentedbyxcm_tpu.utils.rectify import StereoRectifier as JRectifier
from orbslam2commentedbyxcm_tpu.utils.synth import BoxSequence as JBoxSequence
from orbslam2commentedbyxcm_tpu_torch.utils import dataset_writers, datasets, png
from orbslam2commentedbyxcm_tpu_torch.utils.camera import Camera
from orbslam2commentedbyxcm_tpu_torch.utils.config import load_settings
from orbslam2commentedbyxcm_tpu_torch.utils.rectify import StereoRectifier
from orbslam2commentedbyxcm_tpu_torch.utils.synth import BoxSequence

torch.set_num_threads(1)

N = 4
CAM = dict(fx=260.0, fy=260.0, cx=160.0, cy=120.0, width=320, height=240, bf=80.0, fps=30.0)


def _jseq(seed, **kw):
    return JBoxSequence(camera=JCamera(**CAM), n_frames=12, seed=seed, tex_size=256, **kw)


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """The three formats as the JAX writer writes them."""
    root = tmp_path_factory.mktemp("jax_written")
    out = {}
    for fmt, seed in (("tum", 11), ("kitti", 12), ("euroc", 13)):
        d = str(root / fmt)
        if fmt == "tum":
            out[fmt] = (d, jwriters.write_tum_rgbd(d, _jseq(seed, turns=0.35), N))
        elif fmt == "kitti":
            out[fmt] = (d, jwriters.write_kitti(d, _jseq(seed, trajectory="line"), N))
        else:
            out[fmt] = (d, jwriters.write_euroc(d, _jseq(seed, turns=0.3), N, distorted=True))
    return out


def _assert_items_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or isinstance(x, float):
            assert x == y
        else:
            assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


def _assert_gt_equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_tum_reader_bit_equal_to_jax(jax_written):
    root, settings = jax_written["tum"]
    factor = load_settings(settings)[2]["depth_map_factor"]
    ours = datasets.TumRgbdDataset(root, depth_factor=factor)
    theirs = jdatasets.TumRgbdDataset(root, depth_factor=factor)
    assert len(ours) == len(theirs) == N
    assert ours.frames == [datasets.FrameRecord(**vars(f)) for f in theirs.frames]
    for i in range(N):
        _assert_items_equal(ours[i], theirs[i])
    ts, img, depth = ours[1]
    assert ts == pytest.approx(1 / 30.0, abs=1e-6) and img.shape == (240, 320)
    assert (depth > 0).all() and depth.max() < 13.0  # metres, no missing depth inside the box
    _assert_gt_equal(ours.groundtruth(), theirs.groundtruth())


def test_tum_association_rules(tmp_path):
    """Nearest depth timestamp within max_dt; unmatched rgb frames drop."""
    (tmp_path / "rgb.txt").write_text("# c\n1.00 rgb/a.png\n1.10 rgb/b.png\n2.00 rgb/c.png\n")
    (tmp_path / "depth.txt").write_text("1.01 depth/a.png\n1.095 depth/b.png\n1.5 depth/x.png\n")
    for max_dt in (0.02, 0.5):
        ours = datasets.TumRgbdDataset(str(tmp_path), max_dt=max_dt)
        theirs = jdatasets.TumRgbdDataset(str(tmp_path), max_dt=max_dt)
        assert [(f.timestamp, f.depth_path) for f in ours.frames] == \
               [(f.timestamp, f.depth_path) for f in theirs.frames]
    assert [os.path.basename(f.depth_path) for f in datasets.TumRgbdDataset(str(tmp_path)).frames] == \
           ["a.png", "b.png"]
    assert datasets.TumRgbdDataset(str(tmp_path)).groundtruth() is None


def test_kitti_reader_bit_equal_to_jax(jax_written):
    root, _ = jax_written["kitti"]
    ours, theirs = datasets.KittiOdometryDataset(root), jdatasets.KittiOdometryDataset(root)
    assert len(ours) == len(theirs) == N and ours.times == theirs.times
    for i in range(N):
        _assert_items_equal(ours[i], theirs[i])
    assert ours[0][2] is not None
    _assert_gt_equal(ours.groundtruth(), theirs.groundtruth())


def test_euroc_reader_bit_equal_to_jax(jax_written):
    """Raw and rectified frames, the nanosecond timestamps and the ground
    truth; the raw frames are genuinely unrectified (tests/test_datasets_e2e.py's
    fixture check: the rectified ones recover the ideal view)."""
    root, settings = jax_written["euroc"]
    rect = StereoRectifier.from_settings(load_settings(settings)[2])
    jrect = JRectifier.from_settings(jload_settings(settings)[2])
    for r, jr in ((None, None), (rect, jrect)):
        ours, theirs = datasets.EurocDataset(root, rectifier=r), jdatasets.EurocDataset(root, rectifier=jr)
        assert len(ours) == len(theirs) == N
        assert [f.timestamp for f in ours.frames] == [f.timestamp for f in theirs.frames]
        for i in range(N):
            _assert_items_equal(ours[i], theirs[i])
        _assert_gt_equal(ours.groundtruth(), theirs.groundtruth())
    assert datasets.EurocDataset(root).frames[1].timestamp == pytest.approx(1 / 20.0)
    ideal = _jseq(13, turns=0.3).render(2)
    sl = (slice(60, 180), slice(80, 240))
    raw_err = np.abs(datasets.EurocDataset(root)[2][1][sl] - ideal[sl]).mean()
    rect_err = np.abs(datasets.EurocDataset(root, rectifier=rect)[2][1][sl] - ideal[sl]).mean()
    assert raw_err > 4.0 * max(rect_err, 1e-6) and rect_err < 6.0, (raw_err, rect_err)


def _decoded_tree(root):
    """{relative path: decoded samples} of every PNG, plus the text files."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            path = os.path.join(dirpath, f)
            rel = os.path.relpath(path, root)
            out[rel] = png.read_png(path) if f.endswith(".png") else open(path).read()
    return out


@pytest.mark.parametrize("fmt", ["tum", "kitti", "euroc", "euroc_rectified"])
def test_writer_matches_jax_writer(tmp_path, fmt):
    """Both writers render the same sequence (the JAX one): the files decode
    to the same images and the text files (lists, ground truth, settings)
    are equal."""
    jseq, tseq = (_jseq(13, turns=0.3) for _ in range(2))
    args = {"tum": (jwriters.write_tum_rgbd, dataset_writers.write_tum_rgbd, {}),
            "kitti": (jwriters.write_kitti, dataset_writers.write_kitti, {}),
            "euroc": (jwriters.write_euroc, dataset_writers.write_euroc, {"distorted": True}),
            "euroc_rectified": (jwriters.write_euroc, dataset_writers.write_euroc, {"distorted": False})}[fmt]
    jw, tw, kw = args
    jw(str(tmp_path / "jax"), jseq, 3, **kw)
    tw(str(tmp_path / "port"), tseq, 3, **kw)
    a, b = _decoded_tree(str(tmp_path / "jax")), _decoded_tree(str(tmp_path / "port"))
    assert a.keys() == b.keys() and any(k.endswith(".png") for k in a)
    for key in a:
        if isinstance(a[key], str):
            assert a[key] == b[key], key
        else:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_port_writer_over_port_sequence_reads_back(tmp_path):
    """The port's writer over the port's renderer: every format reads back
    through the port's readers with its settings, rectification included."""
    seq = BoxSequence(camera=Camera(**CAM), n_frames=12, seed=13, turns=0.3, tex_size=256)
    s = dataset_writers.write_euroc(str(tmp_path / "e"), seq, 2, distorted=True)
    cam, cfg, raw = load_settings(s)
    assert cam.width == 320 and cfg.n_features == 800 and "LEFT.K" in raw
    rect = StereoRectifier.from_settings(raw)
    ts, left, right = datasets.EurocDataset(str(tmp_path / "e"), rectifier=rect)[1]
    assert left.shape == right.shape == (240, 320) and left.dtype == np.float32
    s = dataset_writers.write_tum_rgbd(str(tmp_path / "t"), seq, 2)
    ts, img, depth = datasets.TumRgbdDataset(str(tmp_path / "t"))[1]
    d16 = (seq.depth_map(1) * 5000.0).astype(np.uint16)  # the writer truncates to depth units
    np.testing.assert_array_equal(depth, d16.astype(np.float32) / 5000.0)
    np.testing.assert_array_equal(img, seq.render(1).astype(np.uint8).astype(np.float32))


def test_prefetcher_yields_in_order_and_len():
    class Fake:
        def __len__(self):
            return 25

        def __getitem__(self, i):
            return (float(i), np.full((4, 4), i, np.float32), None)

    got = [ts for ts, img, aux in datasets.Prefetcher(Fake(), depth=3)]
    assert got == [float(i) for i in range(25)]
    p = datasets.Prefetcher(Fake(), depth=2, start=5, stop=11)
    assert len(p) == 6
    assert [ts for ts, *_ in p] == [5.0, 6.0, 7.0, 8.0, 9.0, 10.0]
    early = datasets.Prefetcher(Fake(), depth=1)
    next(iter(early))
    early.close()
    assert not early._thread.is_alive()


def test_prefetcher_propagates_errors():
    class Boom:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            if i == 2:
                raise FileNotFoundError("missing.png")
            return (float(i), None, None)

    it = iter(datasets.Prefetcher(Boom(), depth=2))
    assert next(it)[0] == 0.0
    assert next(it)[0] == 1.0
    with pytest.raises(FileNotFoundError, match="missing.png"):
        next(it)
