"""The port stands alone: importing it loads neither JAX nor the JAX
package, no source of it (or chip_smoke.py) imports them, and its entry
points refuse to run on a missing card instead of falling back to the CPU.
"""

import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gpu_ecs_madrona_tpu_torch")


def test_import_loads_no_jax():
    script = textwrap.dedent("""
        import sys
        import gpu_ecs_madrona_tpu_torch
        import gpu_ecs_madrona_tpu_torch.models.collisions
        import gpu_ecs_madrona_tpu_torch.models.simple_jobs
        import gpu_ecs_madrona_tpu_torch.models.fantasy_vs
        import gpu_ecs_madrona_tpu_torch.models.rigid_bench
        import gpu_ecs_madrona_tpu_torch.models.simple_taskgraph
        import gpu_ecs_madrona_tpu_torch.render.interop
        import gpu_ecs_madrona_tpu_torch.render.renderer
        import gpu_ecs_madrona_tpu_torch.ops.render_kernel
        import gpu_ecs_madrona_tpu_torch.physics
        import gpu_ecs_madrona_tpu_torch.physics.assets
        import gpu_ecs_madrona_tpu_torch.ops.substep_kernel
        import gpu_ecs_madrona_tpu_torch.core.base
        import gpu_ecs_madrona_tpu_torch.interop
        import gpu_ecs_madrona_tpu_torch.core.world
        import gpu_ecs_madrona_tpu_torch.bindings
        import gpu_ecs_madrona_tpu_torch.parallel.learner
        import gpu_ecs_madrona_tpu_torch.parallel.mesh
        import gpu_ecs_madrona_tpu_torch.tooling.profiler
        import gpu_ecs_madrona_tpu_torch.tooling.autotuner
        import gpu_ecs_madrona_tpu_torch.utils.tracing
        bad = [m for m in sys.modules
               if m == "jax" or m.startswith("jax.")
               or m == "gpu_ecs_madrona_tpu" or m.startswith("gpu_ecs_madrona_tpu.")]
        print("BAD", bad)
        assert not bad, bad
    """)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", script], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "BAD []" in out.stdout


@pytest.mark.parametrize("module", ["ops.substep_kernel", "physics", "physics.solver",
                                    "ops.render_kernel", "models.simple_taskgraph",
                                    "core.world", "bindings", "parallel.learner",
                                    "parallel.mesh", "tooling.profiler", "tooling.autotuner",
                                    "utils.tracing"])
def test_each_module_imports_first(module):
    """Any module of the port imports in a fresh process on its own (the
    physics package and the substep kernels' module import each other)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", f"import gpu_ecs_madrona_tpu_torch.{module}"],
                         env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


IMPORT_RE = re.compile(
    r"^\s*(import\s+(jax|gpu_ecs_madrona_tpu)(\.|\s|$|,)"
    r"|from\s+(jax|gpu_ecs_madrona_tpu)(\.|\s))", re.M)


def _sources():
    for root, _, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as f:
        text = f.read()
    assert not IMPORT_RE.search(text), path


def test_import_pattern_catches_jax_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from gpu_ecs_madrona_tpu.core import state",
                 "import gpu_ecs_madrona_tpu"):
        assert IMPORT_RE.search(line), line
    for line in ("import gpu_ecs_madrona_tpu_torch",
                 "from gpu_ecs_madrona_tpu_torch.core import state"):
        assert not IMPORT_RE.search(line), line


def test_make_executor_needs_a_card_or_cpu():
    cfg = col.CollisionsConfig(num_worlds=2, num_objects=4, max_pairs=16)
    if torch.cuda.is_available():
        assert col.make_executor(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            col.make_executor(cfg)
    assert col.make_executor(cfg, device="cpu").device.type == "cpu"


def test_fused_default_follows_device():
    """fused=None: off on the CPU (the row node and Gram solver run)."""
    sim = col.make_executor(col.CollisionsConfig(num_worlds=1, num_objects=4,
                                                 max_pairs=16), device="cpu")
    assert sim.graph.node_names == ["aabb_preprocess", "broadphase", "narrowphase",
                                    "clear_CollisionCandidate", "solver",
                                    "clear_Contact"]
    with pytest.raises(ValueError, match="single-tile"):
        col.make_executor(col.CollisionsConfig(num_worlds=1, num_objects=800,
                                               max_pairs=16, fused=True), device="cpu")


def test_rigid_bench_needs_a_card_or_cpu():
    cfg = rb.RigidBenchConfig(num_worlds=1, num_bodies=4, contact_mode="pallas")
    if torch.cuda.is_available():
        assert rb.make_executor(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            rb.make_executor(cfg)
    assert rb.make_executor(cfg, device="cpu").device.type == "cpu"


def test_learner_needs_a_card_or_cpu():
    """The learner's entry point, like the executors', runs on the card
    unless asked for the CPU."""
    from gpu_ecs_madrona_tpu_torch.parallel.learner import PPOConfig, PPOLearner
    cfg = PPOConfig(obs_dim=4, act_dim=2, hidden=8)
    fns = (None,) * 4
    if torch.cuda.is_available():
        assert PPOLearner(cfg, *fns).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PPOLearner(cfg, *fns)
    learner = PPOLearner(cfg, *fns, device="cpu")
    assert learner.generator.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in learner.policy.parameters())
