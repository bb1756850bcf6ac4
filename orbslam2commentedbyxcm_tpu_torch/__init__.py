"""orbslam2commentedbyxcm_tpu_torch — the SLAM engine ported to PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

It grows beside the JAX package `orbslam2commentedbyxcm_tpu`, which stays the
reference, and keeps its layout:
  ops/       ORB frontend, Hamming matching, stereo matching, motion-only
             pose optimization, Schur bundle adjustment, triangulation, and
             the wrappers of the CUDA kernels (csrc/, built by kernels.py)
  models/    System (synchronous stereo / RGB-D SLAM), Tracking,
             LocalMapping, Map, Frame / KeyFrame
  utils/     geometry, camera, synthetic sequences, trajectory evaluation,
             JAX <-> torch conversion
  entry.py   the flagship per-frame step

The port imports torch and numpy, never JAX. Every function runs on the
device of its input tensors: CUDA tensors go through the kernels, CPU tensors
through their plain torch twins.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy: importing the package loads nothing heavy.
    if name == "flagship":
        from orbslam2commentedbyxcm_tpu_torch.entry import flagship

        return flagship
    raise AttributeError(name)
