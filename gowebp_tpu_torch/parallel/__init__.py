"""Multi-device codec steps on torch.distributed: meshes (``mesh``),
process-group set-up (``distributed``) and the sharded steps with their
halo exchanges (``shard``)."""
