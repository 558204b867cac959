"""Does the settled pile of imported prisms fall asleep?  The port against
the JAX package (CPU).

The scene is tests/test_torch_hull_scenes.py's HULL_SETTLED (the settled
pile's options: grid spawn, the broadphase in the kernel, contact refresh,
persistent manifolds, sleep at threshold 0.02 over 10 quiet steps) with the
imported hexagonal prism for every dynamic body, at 2 worlds x 64 prisms.
The port's fused kernel (its plain version on the CPU) runs against JAX's
fused kernel as JAX's own tests run it on the CPU (interpreted), at
``substep_wt=1``, where sleep and persistence meet (the JAX kernel's result
depends on its world blocks, ROADMAP "Reference behaviours"), from one
JAX-initialised state; each step compares the SleepState flags and quiet
counters and each world's largest dynamic |v|^2 and |w|^2.

  - short (Tier-1): 25 steps, the flags and counters equal, positions and
    the largest |v|^2, |w|^2 within test_torch_hull_pile.py's multi-step
    gates (rtol 1e-4, atol 8e-2);
  - long (slow): the card's 660 steps (main_rigid_hulls_settled: 400 to
    settle, 5 windows of 50, 10 more): neither package's worlds fall
    asleep.  From the settle on every world of both keeps a body above the
    threshold, the quiet counters never reach sleep_frames, and in both
    some of the prisms above it rest on a cap: a hexagonal cap touches the
    plane at six corners of which the contact keeps the deepest four, so
    the prism rocks (a reference behaviour, ROADMAP, not a fault of the
    general-hull path).  The two runs part slowly (chaotic contacts: ~1e-5
    of position after 20 steps, ~0.1 after 100), so the long test holds
    each package to the outcome, not to the other's trajectory.

One JAX executor serves the file (one compile, module fixture).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import assets as jassets
from gpu_ecs_madrona_tpu.utils import importer as jimporter

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.physics import assets
from gpu_ecs_madrona_tpu_torch.utils import importer

import test_torch_hull_scenes as hs

W, NB = 2, 64
CFG = dict(hs.HULL_SETTLED, num_worlds=W, num_bodies=NB)
BODY = "RigidBenchBody"
SHORT, LONG = 25, 660
THRESHOLD = rb.RigidBenchConfig(**CFG).sleep_threshold
FRAMES = rb.RigidBenchConfig(**CFG).sleep_frames


def to_np(jstate):
    return jax.tree_util.tree_map(np.asarray, jstate)


@pytest.fixture(scope="module")
def jax_sim():
    """JAX's settled prism pile at substep_wt = 1 and its initial state."""
    world = hs.hull_world(jrb, hs.hull_object_manager(jassets, jimporter)).with_config(
        jrb.RigidBenchConfig(**CFG, substep_wt=1))
    sim = JTaskGraphExecutor(world, JExecutorConfig(num_worlds=W, max_entities_per_world=NB + 8,
                                                    seed=0, donate=False))
    return sim, to_np(sim.state)


def port_sim(state):
    world = hs.hull_world(rb, hs.hull_object_manager(assets, importer)).with_config(
        rb.RigidBenchConfig(**CFG))
    sim = TaskGraphExecutor(world, ExecutorConfig(num_worlds=W, max_entities_per_world=NB + 8,
                                                  seed=0, device="cpu"))
    sim.state = state_from_numpy(state, "cpu")
    return sim


def motion(s):
    """A state's sleep flags and quiet counters, each world's largest
    dynamic |v|^2 and |w|^2 (row 0 is the plane), the prisms' positions,
    and which prisms rest on a cap (their axis within 0.01 of vertical)."""
    c = s["arch"][BODY]["comps"]
    v2 = (c["Velocity"]["linear"][:, 1:] ** 2).sum(-1)
    w2 = (c["Velocity"]["angular"][:, 1:] ** 2).sum(-1)
    q = c["Rotation"]["value"][:, 1:]
    up = np.abs(1.0 - 2.0 * (q[..., 1] ** 2 + q[..., 2] ** 2))
    return {"asleep": s["singleton"]["SleepState"]["asleep"],
            "quiet": s["singleton"]["SleepState"]["quiet_steps"],
            "v2": v2, "w2": w2, "pos": c["Position"]["value"][:, 1:], "on_cap": up > 0.99}


def run_both(jax_sim, steps):
    """Both packages from JAX's initial state for ``steps`` steps: each
    step's motion, (JAX's, the port's)."""
    jsim, init = jax_sim
    jsim.state = jax.tree_util.tree_map(jnp.asarray, init)
    psim = port_sim(init)
    out = []
    for _ in range(steps):
        jsim.step()
        psim.step()
        out.append((motion(to_np(jsim.state)), motion(state_to_numpy(psim.state))))
    return out


def test_settled_prism_pile_sleep_matches_jax_short(jax_sim):
    for step, (a, b) in enumerate(run_both(jax_sim, SHORT)):
        for k in ("asleep", "quiet"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{k} step {step}")
        np.testing.assert_allclose(b["pos"], a["pos"], rtol=1e-4, atol=8e-2,
                                   err_msg=f"positions step {step}")
        for k in ("v2", "w2"):
            np.testing.assert_allclose(b[k].max(1), a[k].max(1), rtol=1e-4, atol=8e-2,
                                       err_msg=f"largest {k} step {step}")
    # the pile has not settled yet: every world moving, none quiet for long
    assert (b["quiet"] < FRAMES).all() and not b["asleep"].any()


@pytest.mark.slow
def test_settled_prism_pile_never_sleeps_in_660_steps_like_jax(jax_sim):
    thr2 = THRESHOLD ** 2
    steps = run_both(jax_sim, LONG)
    for step, pair in enumerate(steps):
        for name, m in zip(("jax", "port"), pair):
            assert not m["asleep"].any(), (name, step)
            assert (m["quiet"] < FRAMES).all(), (name, step)
            if step >= rb.SETTLE_STEPS:
                moving = (m["v2"] + m["w2"] > thr2).any(1)
                assert moving.all(), (name, step)
    for name, m in zip(("jax", "port"), steps[-1]):
        above = m["v2"] + m["w2"] > thr2
        # some prisms at rest on a cap keep rocking
        assert (above & m["on_cap"]).any(1).all(), name
