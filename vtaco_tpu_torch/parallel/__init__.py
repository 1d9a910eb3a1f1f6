"""Parallelism on torch.distributed (port of vtaco_tpu/parallel/): the
(data, model) mesh and the rows each rank takes (mesh.py), the group's
initialization and the input shard of a host (multihost.py), and tensor
parallelism over the model axis (tp.py)."""
