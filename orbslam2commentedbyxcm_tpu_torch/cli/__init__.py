"""Command-line entry points of the port: `python -m
orbslam2commentedbyxcm_tpu_torch.cli.run_dataset | run_synthetic | run_video`,
the counterparts of the JAX package's examples/ scripts. Each runs on the
card unless given `--device cpu`."""
