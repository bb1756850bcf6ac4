"""Faults planted in the port underneath a run: the readings that set the
limits of checks.py (control.py, on the card) and the CPU tests that see a
broken timed path come out not correct.

    with faults.planted("local_ba_identity"):
        run.run_cell(...)

  pose_unchanged     the tracking pose solve returns the pose it was given
  half_slots         the second half of each extraction's keypoint slots
                     left out
  desc_bit           one bit of one descriptor flipped where it is produced
  local_ba_identity  local BA returns the poses and points it was given
  loop_off           place recognition never finds a loop candidate
  half_kf_obs        every keyframe's observations of odd keypoint slots
                     dropped (half of them)
"""

from __future__ import annotations

import contextlib

_MISSING = object()


def _pose_unchanged(patch):
    import torch

    from orbslam2commentedbyxcm_tpu_torch.models import tracking
    from orbslam2commentedbyxcm_tpu_torch.ops.optim import PoseOptResult

    def solve(t_cw, pts_w, obs, mask, inv_sigma2, *cam, **kw):
        return PoseOptResult(t_cw, mask, mask.sum(dtype=torch.int32), torch.zeros((), device=t_cw.device))
    patch(tracking, "pose_optimization", solve)


def _extract_altered(alter):
    def plant(patch):
        from orbslam2commentedbyxcm_tpu_torch.ops.orb import ORBExtractor

        inner = ORBExtractor._extract

        def extract(self, img):
            return alter(inner(self, img))
        patch(ORBExtractor, "_extract", extract)
    return plant


def _half_slots(f):
    valid = f.valid.clone()
    valid[len(valid) // 2:] = False
    return f._replace(valid=valid)


def _desc_bit(f):
    desc = f.desc.clone()
    desc[7, 3] ^= 1 << 5
    return f._replace(desc=desc)


def _local_ba_identity(patch):
    import torch

    from orbslam2commentedbyxcm_tpu_torch.models import local_mapping
    from orbslam2commentedbyxcm_tpu_torch.ops.optim import BAResult

    def solve(problem, cam, device, *a, **kw):
        return BAResult(torch.from_numpy(problem["poses"]).to(device), torch.from_numpy(problem["points"]).to(device),
                        torch.from_numpy(problem["omask"]).to(device), torch.zeros((), device=device))
    patch(local_mapping, "solve_ba_problem", solve)


def _loop_off(patch):
    from orbslam2commentedbyxcm_tpu_torch.models.loop_closing import LoopClosing

    patch(LoopClosing, "detect_candidates", lambda self, kf: [])


def _half_kf_obs(patch):
    from orbslam2commentedbyxcm_tpu_torch.models.map import Map

    inner = Map.add_observation

    def add_observation(self, pid, kf_id, feat_idx):
        if int(feat_idx) % 2 == 0:
            inner(self, pid, kf_id, feat_idx)
    patch(Map, "add_observation", add_observation)


FAULTS = {
    "pose_unchanged": _pose_unchanged,
    "half_slots": _extract_altered(_half_slots),
    "desc_bit": _extract_altered(_desc_bit),
    "local_ba_identity": _local_ba_identity,
    "loop_off": _loop_off,
    "half_kf_obs": _half_kf_obs,
}


@contextlib.contextmanager
def planted(name: str | None):
    """The fault `name` (None or "none": nothing) planted for the block."""
    undo = []

    def patch(obj, attr, value):
        undo.append((obj, attr, vars(obj).get(attr, _MISSING)))
        setattr(obj, attr, value)

    if name not in (None, "none"):
        FAULTS[name](patch)
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            if old is _MISSING:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
