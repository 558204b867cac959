"""Contacts of the port against the JAX package (CPU).

  - pair_contacts on the cases of tests/test_clip.py (plus box-plane,
    sphere-box, sphere-sphere and sphere-plane pairs) and the random poses
    of tests/test_obb_sat.py, with the analytic all-box path and the
    general-hull path: ok and num_points exact, normals, points and depths
    atol 1e-5;
  - the contact and collision-event tables that contact_mode="pairs" emits
    on its last substep: masks, handles and point counts exact; points,
    depths, normals and lambdas atol 1e-4 on live rows.  The mid-pile
    state is stepped by the port from a JAX-initialised state, so only one
    JAX step runs (eagerly, for its observer to see values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ecs_madrona_tpu import ExecutorConfig as JExecutorConfig
from gpu_ecs_madrona_tpu import TaskGraphExecutor as JTaskGraphExecutor
from gpu_ecs_madrona_tpu.models import rigid_bench as jrb
from gpu_ecs_madrona_tpu.physics import pairs as jpk

from gpu_ecs_madrona_tpu_torch.core.executor import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.physics import assets
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk

PILE = dict(num_worlds=4, num_bodies=20, spawn_xy=3.0, spawn_h=4.0, seed=0)


# ---------------------------------------------------------------------------
# pair_contacts
# ---------------------------------------------------------------------------

IDENT = (1.0, 0.0, 0.0, 0.0)


def _box_om(halves, all_box):
    loader = assets.PhysicsLoader(max_verts=8, max_faces=6, max_edges=3, max_face_verts=4,
                                  max_full_edges=12)
    loader.load_objects([assets.make_box(h, inv_mass=1.0) for h in halves]
                        + [assets.make_sphere(0.45), assets.make_plane()])
    om = loader.get_object_manager()
    if not all_box:
        om = dict(om)
        om["hull_is_box"] = np.zeros_like(om["hull_is_box"])
    return om


def contacts_both(om, pos, rot, obj):
    """pair_contacts of pairs (A = first half of the bodies axis, B =
    second half) through the JAX module and the port's; numpy dicts."""
    K = obj.shape[1] // 2
    jt, pt = jpk.ObjTables(om), pk.ObjTables(om)

    def fields(mod, tables, conv, sl):
        return mod.body_fields(tuple(conv(pos[:, sl, c]) for c in range(3)),
                               tuple(conv(rot[:, sl, c]) for c in range(4)),
                               conv(obj[:, sl]), tables)

    jconv, pconv = jnp.asarray, torch.from_numpy
    ja = fields(jpk, jt, jconv, slice(0, K))
    jb = fields(jpk, jt, jconv, slice(K, 2 * K))
    jout = jax.jit(lambda: jpk.pair_contacts(ja, jb, jnp.ones(obj[:, :K].shape, bool)))()
    pa = fields(pk, pt, pconv, slice(0, K))
    pb = fields(pk, pt, pconv, slice(K, 2 * K))
    pout = pk.pair_contacts(pa, pb, torch.ones(obj[:, :K].shape, dtype=torch.bool))

    def flat(out, conv):
        return {"ok": conv(out["ok"]), "num_points": conv(out["num_points"]),
                "normal": np.stack([conv(c) for c in out["normal"]], -1),
                "points": np.stack([conv(c) for c in out["points"]], -1),
                "depth": conv(out["depth"])}
    return flat(jout, np.asarray), flat(pout, lambda t: t.numpy())


def clip_cases():
    """The test_clip.py configurations as one batch of pairs (W=1)."""
    c, s = np.cos(np.pi / 8), np.sin(np.pi / 8)
    cases = [((0, 0, 0), (0, 0, 0.9), IDENT, IDENT, 0, 0),          # aligned
             ((0, 0, 0), (0, 0, 0.9), IDENT, (c, 0, 0, s), 0, 0),   # rotated 45
             ((0, 0, 0), (0, 0, 0.9), IDENT, IDENT, 1, 2),          # small under large
             ((0, 0, 0), (0.5, 0, 0.9), IDENT, IDENT, 0, 0),        # partial overlap
             ((0, 0, 0.3), (0, 0, 0), IDENT, IDENT, 0, 4),          # box on plane
             ((0.3, 0.1, 0.2), (0, 0, 0), IDENT, (c, s, 0, 0), 3, 0),  # sphere-box
             ((0, 0, 0.3), (0.2, 0, 0.9), IDENT, IDENT, 3, 3),      # sphere-sphere
             ((0.1, 0, 0.2), (0, 0, 0), IDENT, IDENT, 3, 4)]        # sphere-plane
    pa, pb, ra, rbt, oa, ob = zip(*cases)
    pos = np.array([list(pa) + list(pb)], np.float32)
    rot = np.array([list(ra) + list(rbt)], np.float32)
    obj = np.array([list(oa) + list(ob)], np.int32)
    return pos, rot, obj


def random_cases(seed=3, W=4, K=64, objects=5):
    """test_obb_sat.py's random poses (a mix of separated and overlapping
    pairs), over every object kind of the tables."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.2, 1.2, (W, 2 * K, 3)).astype(np.float32)
    ax = rng.standard_normal((W, 2 * K, 3)).astype(np.float32)
    ax /= np.linalg.norm(ax, axis=-1, keepdims=True)
    ang = rng.uniform(0, np.pi, (W, 2 * K, 1)).astype(np.float32)
    rot = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * ax], axis=-1)
    obj = rng.integers(0, objects, (W, 2 * K)).astype(np.int32)
    return pos, rot, obj


@pytest.mark.parametrize("all_box", [True, False], ids=["all_box", "general"])
@pytest.mark.parametrize("cases", ["clip", "random"])
def test_pair_contacts_matches_jax(all_box, cases):
    om = _box_om([(0.5, 0.5, 0.5), (0.2, 0.2, 0.5), (1.0, 1.0, 0.5)] if cases == "clip"
                 else [(0.5, 0.4, 0.3), (0.6, 0.6, 0.6)], all_box)
    pos, rot, obj = clip_cases() if cases == "clip" else random_cases(
        objects=om["prim_type"].shape[0])
    a, b = contacts_both(om, pos, rot, obj)
    np.testing.assert_array_equal(a["ok"], b["ok"])
    np.testing.assert_array_equal(a["num_points"], b["num_points"])
    for k in ("normal", "points", "depth"):
        np.testing.assert_allclose(b[k], a[k], atol=1e-5, rtol=0, err_msg=k)
    assert a["ok"].sum() >= (6 if cases == "clip" else 40)


def _observed(world, archs, node_id_cls, sink):
    """world with a node after its (only) substep that records the contact
    and event tables (the first clear waits for it)."""
    def observe(ctx):
        out = {}
        for arch, comp in archs:
            out[arch.name] = {"mask": np.asarray(ctx.row_mask(arch)),
                              **{f: np.asarray(v) for f, v in ctx.column(arch, comp).items()}}
        sink.append(out)

    class Observed(world):
        @classmethod
        def setup_tasks(cls, builder):
            super().setup_tasks(builder)
            names = [nd.name for nd in builder._nodes]
            obs = builder.add_node(observe, deps=[node_id_cls(names.index("physics_substep_0"))],
                                   name="observe")
            clear = builder._nodes[names.index("clear_CandidateTemporary")]
            clear.deps = clear.deps + (obs.idx,)

    return Observed


def test_contact_temporaries_match_jax():
    """pairs mode's last substep emits the contact and collision-event
    tables (built lazily in the port): masks, handles and point counts
    exact, points, depths, normals and lambdas atol 1e-4 on live rows.
    One substep (the JAX side runs eagerly so the observer sees values)."""
    from gpu_ecs_madrona_tpu.core.taskgraph import NodeID as JNodeID
    from gpu_ecs_madrona_tpu.physics import CollisionEventTemporary as JEv
    from gpu_ecs_madrona_tpu.physics import ContactTemporary as JCt
    from gpu_ecs_madrona_tpu.physics.components import CollisionEvent as JCE
    from gpu_ecs_madrona_tpu.physics.components import ContactConstraint as JCC
    from gpu_ecs_madrona_tpu_torch.core.taskgraph import NodeID
    from gpu_ecs_madrona_tpu_torch.physics import CollisionEventTemporary, ContactTemporary
    from gpu_ecs_madrona_tpu_torch.physics.components import CollisionEvent, ContactConstraint
    jseen, pseen = [], []
    jw = _observed(jrb.RigidBenchWorld.with_config(jrb.RigidBenchConfig(
        contact_mode="pairs", max_candidates=128, num_substeps=1, **PILE)),
        [(JCt, JCC), (JEv, JCE)],
        JNodeID, jseen)
    pw = _observed(rb.RigidBenchWorld.with_config(rb.RigidBenchConfig(
        contact_mode="pairs", max_candidates=128, num_substeps=1, **PILE)),
        [(ContactTemporary, ContactConstraint), (CollisionEventTemporary, CollisionEvent)],
        NodeID, pseen)
    jsim = JTaskGraphExecutor(jw, JExecutorConfig(num_worlds=4, max_entities_per_world=28,
                                                  seed=0, donate=False))
    jstate0 = jax.tree_util.tree_map(np.asarray, jsim.state)
    # the pile: three port steps (4 substeps each) from the JAX initial state
    mover = rb.make_executor(rb.RigidBenchConfig(contact_mode="pairs", max_candidates=128,
                                                 **PILE), device="cpu")
    mover.state = state_from_numpy(jstate0, "cpu")
    mover.run(3)
    pile_state = state_to_numpy(mover.state)
    pile_state["rng"] = jstate0["rng"]          # JAX keeps its own key layout
    psim = TaskGraphExecutor(pw, ExecutorConfig(num_worlds=4, max_entities_per_world=28,
                                                seed=0, device="cpu"))
    psim.state = state_from_numpy(pile_state, "cpu")
    psim.step()
    with jax.disable_jit():
        jsim.graph.step(jax.tree_util.tree_map(jnp.asarray, pile_state))
    (a,), (b,) = jseen, pseen
    live = a["ContactTemporary"]["mask"]
    assert live.sum() > 0
    for arch in a:
        for key, want in a[arch].items():
            got = b[arch][key]
            if want.dtype.kind in "iub":
                np.testing.assert_array_equal(got, want, err_msg=f"{arch}.{key}")
            else:
                np.testing.assert_allclose(got[live], want[live], atol=1e-4, rtol=0,
                                           err_msg=f"{arch}.{key}")
    assert (psim.mgr.num_rows(psim.state, ContactTemporary) == 0).all()
