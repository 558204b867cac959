"""The dense contact mode's step against the JAX package's (CPU), on the
scenes of tests/test_physics.py that run it (``make_world``'s
``contact_mode="auto"`` at 16 body rows takes the dense mode in both
packages).

Every scene runs in two worlds of one executor a package (test_torch_
physics_world ``make_world``, no joint archetype, a body list a world):
the port's initial state is carried into the JAX executor of the same
layout, and both run the most steps of any scene.  Gates, each scene on
its own worlds and steps:
the scene's own gates of tests/test_physics.py on the port (free fall,
a box and a sphere settling on the plane, a static body that never
moves, a bouncing ball's rebound), and the port's positions against
JAX's: within 1e-4 after the first steps, and at the end of the scene
within that scene's own tolerance.  A dense step is bit-identical from
one world block size to another, and from run to run.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
from gpu_ecs_madrona_tpu_torch.physics import components as comp

from test_torch_physics_world import OBJ_BOX, OBJ_PLANE, OBJ_SPHERE, make_world

STATIC, DYNAMIC = comp.RESPONSE_STATIC, comp.RESPONSE_DYNAMIC
PLANE = (OBJ_PLANE, (0, 0, 0.0), STATIC)
# name: (bodies, steps, the end tolerance against JAX)
SCENES = {
    "free_fall": ([(OBJ_BOX, (0, 0, 50.0), DYNAMIC)], 30, 1e-3),
    "box_settles": ([PLANE, (OBJ_BOX, (0, 0, 1.5), DYNAMIC)], 120, 0.15),
    "sphere_settles": ([PLANE, (OBJ_SPHERE, (0.0, 0.0, 2.0), DYNAMIC)], 150, 0.15),
    "static_body": ([PLANE, (OBJ_BOX, (0, 0, 0.5), DYNAMIC)], 60, 0.15),
    "bounce": ([PLANE, (OBJ_SPHERE, (0.0, 0.0, 3.0), DYNAMIC)], 90, 0.05),
}
EARLY = 5


def graft(template, port_state):
    """The port's state (numpy) in the JAX executor's tree, its rng kept."""
    def put(t, p):
        if isinstance(t, dict):
            return {k: put(t[k], p[k]) for k in t}
        assert t.shape == p.shape and t.dtype == p.dtype
        return jnp.asarray(p)
    return {k: (v if k == "rng" else put(v, port_state[k])) for k, v in template.items()}


@contextlib.contextmanager
def one_thread():
    """PyTorch's CPU ops on one thread for the block: a dense step's small
    ops split across threads cost ~20x when other processes hold the cores
    (as the test run's parallel workers do), and a step's results do not
    depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def run_scenes(scenes, num_worlds=2):
    """The scenes ``{name: (bodies, steps, ...)}``, each in num_worlds
    worlds of one executor a package (one JAX compile; a dense step
    repeats bit for bit whatever the worlds beside it): both engines the
    most steps of any scene from the port's initial state.  Returns {name:
    (port positions [steps, W, bodies, 3], JAX's)}, each cut to its own
    steps, worlds and bodies."""
    per_world = [sc[0] for sc in scenes.values() for _ in range(num_worlds)]
    psim = make_world("port", "auto", per_world=per_world)
    jsim = make_world("jax", "auto", per_world=per_world)
    jsim.state = graft(jax.tree_util.tree_map(np.asarray, jsim.state),
                       state_to_numpy(psim.state))
    got, want = [], []
    with one_thread():
        for _ in range(max(sc[1] for sc in scenes.values())):
            psim.step()
            jsim.step()
            got.append(psim.get_exported(0)[0].numpy())
            want.append(np.asarray(jsim.get_exported(0)[0]))
    got, want = np.stack(got), np.stack(want)
    out = {}
    for k, (name, (bodies, steps, *_)) in enumerate(scenes.items()):
        cut = (slice(0, steps), slice(k * num_worlds, (k + 1) * num_worlds),
               slice(0, len(bodies)))
        out[name] = (got[cut], want[cut])
    return out


@pytest.fixture(scope="module")
def scene_runs():
    """Every scene of SCENES run once, two worlds each (run_scenes)."""
    return run_scenes(SCENES)


def test_auto_takes_the_dense_mode():
    sim = make_world("port", "auto", bodies=SCENES["box_settles"][0])
    names = sim.graph.node_names
    assert [n for n in names if n.startswith("physics_")] == [
        f"physics_substep_{i}" for i in range(4)]
    node = next(nd for nd in sim.graph.nodes if nd.name == "physics_substep_0")
    assert node.run.world_block == 2          # every world in one block


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_jax(scene_runs, name):
    got, want = scene_runs[name]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[:EARLY], want[:EARLY], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[-1], want[-1], atol=SCENES[name][2], rtol=1e-4)
    z = got[-1][..., 2]
    if name == "free_fall":        # z = 50 - g t^2 / 2 after 0.5 s
        assert (48.0 < z[:, 0]).all() and (z[:, 0] < 49.0).all(), z
    elif name in ("box_settles", "sphere_settles"):
        assert (np.abs(z[:, 1] - 1.0) < 0.15).all(), z
    elif name == "static_body":
        np.testing.assert_allclose(got[-1][:, 0], 0.0, atol=1e-6)
    else:                          # e = 0.3: the apex ~ e^2 h0 above rest
        traj = got[:, 0, 1, 2]
        low = int(np.argmax(traj < 1.05))
        assert traj[low] < 1.05, traj
        rebound = traj[low:].max() - 1.0
        assert 0.4 * 0.18 < rebound < 2.5 * 0.18, rebound


def random_pile():
    """The plane and 15 boxes and spheres above it, interpenetrating."""
    bodies = [PLANE] + [
        (OBJ_BOX if i % 2 else OBJ_SPHERE, tuple(float(x) for x in xyz), DYNAMIC)
        for i, xyz in enumerate(np.random.default_rng(5).uniform(
            (-2.0, -2.0, 0.8), (2.0, 2.0, 4.0), (15, 3)))]
    return bodies


def test_world_blocks_give_the_same_step(monkeypatch):
    """The dense node's world blocks: 3 worlds in blocks of 1, 2 and 3
    step to the same bits (a pile with contacts everywhere)."""
    outs = {}
    for per_block in (1, 2, 3):
        monkeypatch.setattr(phys, "DENSE_BLOCK_PAIRS", per_block * 16 * 16)
        sim = make_world("port", "auto", bodies=random_pile(), num_worlds=3)
        node = next(nd for nd in sim.graph.nodes if nd.name == "physics_substep_0")
        assert node.run.world_block == per_block
        sim.run(3)
        outs[per_block] = state_to_numpy(sim.state)["arch"]["PhysBody"]["comps"]
    for per_block in (1, 2):
        for comp_name, fields in outs[3].items():
            other = outs[per_block][comp_name]
            if isinstance(fields, dict):
                for f in fields:
                    np.testing.assert_array_equal(other[f], fields[f], err_msg=comp_name)
            else:
                np.testing.assert_array_equal(other, fields, err_msg=comp_name)


def test_dense_step_repeats_bit_for_bit():
    """tests/test_physics.py test_determinism on the port: two runs from
    one state agree bit for bit."""
    runs = []
    with one_thread():
        for _ in range(2):
            sim = make_world("port", "auto", bodies=random_pile()[:4])
            sim.run(20)
            runs.append(sim.get_exported(0)[0])
    assert torch.equal(runs[0], runs[1])
