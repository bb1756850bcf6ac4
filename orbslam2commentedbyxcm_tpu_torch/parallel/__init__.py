"""Sharded global solvers: landmark-sharded bundle adjustment, the
edge-sharded essential graph, their bridge to the live System, and the
process groups they reduce over (torch.distributed)."""
