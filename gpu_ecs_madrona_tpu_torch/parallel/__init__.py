"""Training on the simulator's device (counterpart of
``gpu_ecs_madrona_tpu/parallel``): the PPO learner (``learner.py``) and the
worlds sharded over ranks with ``torch.distributed`` (``mesh.py``), over
which the learner's update equals one process's on all the worlds."""

from gpu_ecs_madrona_tpu_torch.parallel.mesh import (  # noqa: F401
    WORLD_AXIS,
    WorldMesh,
    initialize_distributed,
    make_world_mesh,
    shard_state,
    world_sharding,
)
