"""The sharding layer: SPMD over torch.distributed process groups
(counterpart of mfa_tpu/shard/)."""
