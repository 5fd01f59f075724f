"""Data-parallel training and ray-sharded rendering over ``torch.distributed``
(``mesh``: meshes, shards, collectives; ``render``: the ray-sharded render;
``launch``: spawning the ranks of one machine)."""
