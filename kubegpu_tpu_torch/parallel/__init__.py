"""Tensor parallelism over torch.distributed: the mesh, the Megatron
sharding rules, the collectives, the rank launcher and the replay of a
batcher's calls from rank 0 to the other ranks."""
