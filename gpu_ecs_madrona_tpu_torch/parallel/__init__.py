"""Training on the simulator's device (counterpart of
``gpu_ecs_madrona_tpu/parallel``): the PPO learner (``learner.py``).  The
JAX package's ``mesh.py`` (worlds sharded over several devices) has no
counterpart yet: the port's learner runs on one device."""
