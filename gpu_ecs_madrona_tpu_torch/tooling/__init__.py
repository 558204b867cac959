"""Tooling of the port (counterpart of ``gpu_ecs_madrona_tpu/tooling``):
per-node profiling and step timelines (``profiler.py``) and the
exec-config autotuner with its artifact (``autotuner.py``).  Both run at
set-up or offline, not inside a step."""
