"""The port's exec-config autotuner (tooling/autotuner.py): the cases of
tests/test_autotuner.py on the port, and its consumers.

- ``lookup``: the nearest workload in log space; the trust gates (another
  backend's entry, a failed validation or no flag: ignored); ``save``
  replacing an entry of the same kind and key.  Entries carry the port's
  backend, "cpu" here ("cuda" on the card).
- The consumers take a validated entry of their device's backend first:
  physics "auto" (a tuned "pairs" over the fixed rule's "dense"; a tuned
  ``substep_wt`` other than 1 refused by the existing error),
  ``CollisionsConfig(fused=None)`` and ``RigidBenchConfig.candidates()``.
- The repository's gem_tune.json (four entries, all "tpu") gives None for
  every kind, and with it, or with no artifact, every "auto", fused=None
  and candidates() of the configurations the other tests build resolves
  by the fixed rule.
- The end-to-end sweep (one process a candidate) is ``slow``, as the JAX
  package's is.
"""

import json
import os

import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu_torch import ExecutorConfig, TaskGraphExecutor
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.physics import (BODY_COMPONENTS, FUSED_NODE,
                                               RigidBodyPhysicsSystem, assets)
from gpu_ecs_madrona_tpu_torch.physics.components import RESPONSE_DYNAMIC, ResponseType
from gpu_ecs_madrona_tpu_torch.tooling import autotuner

REPO_TUNE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "gem_tune.json")
KINDS = ["collisions", "physics_substep", "physics_capacity"]


def test_lookup_nearest_workload(tmp_path):
    path = tmp_path / "tune.json"
    autotuner.save([
        {"kind": "collisions", "key": {"num_worlds": 8192, "num_objects": 100},
         "config": {"fused": True}, "backend": "cpu", "validated": True},
        {"kind": "collisions", "key": {"num_worlds": 64, "num_objects": 100},
         "config": {"fused": False}, "backend": "cpu", "validated": True},
        {"kind": "physics_substep", "key": {"num_worlds": 1024, "bodies": 64},
         "config": {"contact_mode": "pairs"}, "backend": "cpu", "validated": True},
    ], str(path))
    assert autotuner.lookup("collisions", path=str(path),
                            num_worlds=4096, num_objects=100) == {"fused": True}
    assert autotuner.lookup("collisions", path=str(path),
                            num_worlds=128, num_objects=100) == {"fused": False}
    assert autotuner.lookup("physics_substep", path=str(path),
                            num_worlds=900, bodies=50) == {"contact_mode": "pairs"}
    assert autotuner.lookup("nope", path=str(path), num_worlds=1) is None


def test_lookup_trust_gates(tmp_path):
    path = str(tmp_path / "tune.json")
    autotuner.save([
        {"kind": "collisions", "key": {"num_worlds": 8192},
         "config": {"fused": False}, "backend": "tpu", "validated": True},
        {"kind": "collisions", "key": {"num_worlds": 4096},
         "config": {"fused": False}, "backend": "cuda", "validated": True},
        {"kind": "collisions", "key": {"num_worlds": 64},
         "config": {"fused": False}, "backend": "cpu", "validated": False},
        {"kind": "collisions", "key": {"num_worlds": 32},
         "config": {"fused": False}, "backend": "cpu"},  # no flag
    ], path)
    assert autotuner.backend() == ("cuda" if torch.cuda.is_available() else "cpu")
    assert autotuner.lookup("collisions", path=path, backend_name="cpu",
                            num_worlds=8192) is None
    # the card's entry, for a consumer on the card only
    assert autotuner.lookup("collisions", path=path, backend_name="cuda",
                            num_worlds=8192) == {"fused": False}


def test_save_replaces_same_key(tmp_path):
    path = str(tmp_path / "tune.json")
    autotuner.save([{"kind": "collisions", "key": {"num_worlds": 8},
                     "config": {"fused": False}, "backend": "cpu",
                     "validated": True}], path)
    autotuner.save([{"kind": "collisions", "key": {"num_worlds": 8},
                     "config": {"fused": True}, "backend": "cpu",
                     "validated": True}], path)
    with open(path) as f:
        entries = json.load(f)["entries"]
    assert len(entries) == 1 and entries[0]["config"] == {"fused": True}


@pytest.mark.parametrize("backend_name", ["cpu", "cuda"])
@pytest.mark.parametrize("kind", KINDS)
def test_repo_artifact_gives_none(kind, backend_name):
    with open(REPO_TUNE) as f:
        entries = json.load(f)["entries"]
    assert {e["backend"] for e in entries} == {"tpu"} and len(entries) == 4
    for worlds, bodies in ((8192, 64), (8192, 128), (4, 6)):
        assert autotuner.lookup(kind, path=REPO_TUNE, backend_name=backend_name,
                                num_worlds=worlds, num_objects=bodies, bodies=bodies) is None


def physics_world(cap, mgr):
    """tests/test_autotuner.py's two-sphere world at body capacity ``cap``
    (no joint rows: "pallas" is the fused kernel's node)."""
    Body = Archetype(f"TuneBody{cap}", BODY_COMPONENTS)

    class W:
        @staticmethod
        def register_types(r):
            RigidBodyPhysicsSystem.register_types(r, max_candidates=16, max_contacts=16,
                                                  max_joints=0)
            r.register_archetype(Body, capacity=cap)
            r.export_column(Body, base.Position, 0)

        @staticmethod
        def init(ctx, init_data=None):
            n = ctx.num_worlds
            ctx.data = {"_": torch.zeros((n, 1))}
            RigidBodyPhysicsSystem.init(ctx, delta_t=1 / 60, num_substeps=2)
            ctx.make_entities(Body, counts=2, max_new=2, values={
                base.Position: torch.tensor([[0.0, 0, 1.0], [0.5, 0, 2.0]]).expand(n, 2, 3),
                base.Rotation: torch.tensor([1.0, 0, 0, 0]).expand(n, 2, 4),
                base.Scale: torch.ones((n, 2, 3)),
                base.ObjectID: torch.zeros((n, 2), dtype=torch.int32),
                ResponseType: torch.full((n, 2), RESPONSE_DYNAMIC, dtype=torch.int32),
            })

        @staticmethod
        def setup_tasks(builder):
            bp = RigidBodyPhysicsSystem.setup_broadphase_tasks(builder, [], Body, mgr)
            RigidBodyPhysicsSystem.setup_substep_tasks(builder, [bp], 2, Body, mgr,
                                                       contact_mode="auto")

    return TaskGraphExecutor(W, ExecutorConfig(num_worlds=2, max_entities_per_world=16,
                                               seed=0, device="cpu"))


def contact_mode_of(sim):
    names = sim.graph.node_names
    if FUSED_NODE in names:
        return "pallas"
    run = sim.graph.nodes[names.index("physics_substep_0")].run
    return "dense" if hasattr(run, "world_block") else "pairs"


@pytest.fixture(scope="module")
def sphere_manager():
    loader = assets.PhysicsLoader()
    loader.load_objects([assets.make_sphere(1.0)])
    return loader.get_object_manager()


def test_physics_auto_consumes_artifact(tmp_path, monkeypatch, sphere_manager):
    """contact_mode="auto" takes the tuned "pairs" over the <= 48-row rule's
    "dense"; another backend's entry is not taken."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)
    entry = {"kind": "physics_substep", "key": {"num_worlds": 2, "bodies": 8},
             "config": {"contact_mode": "pairs"}, "validated": True}
    autotuner.save([dict(entry, backend="cuda")], path)
    assert contact_mode_of(physics_world(8, sphere_manager)) == "dense"
    autotuner.save([dict(entry, backend="cpu")], path)
    sim = physics_world(8, sphere_manager)
    assert contact_mode_of(sim) == "pairs"
    sim.run(1)
    assert bool(sim.get_exported(0)[0].isfinite().all())


@pytest.mark.parametrize("wt", [None, 1, 2])
def test_physics_auto_takes_no_world_block(tmp_path, monkeypatch, sphere_manager, wt):
    """A tuned ``substep_wt`` absent or 1 is ignored; any other is refused
    (the port runs one CTA a world)."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)
    config = {"contact_mode": "pallas"} if wt is None else {"contact_mode": "pallas",
                                                           "substep_wt": wt}
    autotuner.save([{"kind": "physics_substep", "key": {"num_worlds": 2, "bodies": 8},
                     "config": config, "backend": "cpu", "validated": True}], path)
    if wt == 2:
        with pytest.raises(ValueError, match="substep_wt"):
            physics_world(8, sphere_manager)
    else:
        assert contact_mode_of(physics_world(8, sphere_manager)) == "pallas"


def test_collisions_and_capacity_consume_artifact(tmp_path, monkeypatch):
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)
    autotuner.save([{"kind": "collisions", "key": {"num_worlds": 4, "num_objects": 6},
                     "config": {"fused": True}, "backend": "cpu", "validated": True},
                    {"kind": "physics_capacity", "key": {"num_worlds": 4, "bodies": 20},
                     "config": {"max_candidates": 48, "for_bodies": 20}, "backend": "cpu",
                     "validated": True}], path)
    calls = []
    tick = col.fused_collisions_step
    monkeypatch.setattr(col, "fused_collisions_step",
                        lambda *a, **k: calls.append(1) or tick(*a, **k))
    col.make_executor(col.CollisionsConfig(num_worlds=4, num_objects=6), device="cpu").step()
    assert calls == [1]          # the tuned fused=True on the CPU, whose rule says off
    col.make_executor(col.CollisionsConfig(num_worlds=8, num_objects=6,
                                           fused=False), device="cpu").step()
    assert calls == [1]
    assert rb.RigidBenchConfig(num_worlds=4, num_bodies=20).candidates() == 48
    # a capacity applies at its exact body count only
    assert rb.RigidBenchConfig(num_worlds=4, num_bodies=21).candidates() == 84
    assert rb.RigidBenchConfig(num_worlds=4, num_bodies=20, max_candidates=30).candidates() == 30


@pytest.mark.parametrize("config, pushes", [({"fused": False, "use_kernel": True}, 2),
                                             ({"fused": False}, 0)])
def test_default_collisions_config_applies_the_whole_entry(tmp_path, monkeypatch, config,
                                                           pushes):
    """The default CollisionsConfig(fused=None, use_kernel=False) takes an
    unfused entry as it was measured: the tuner's (use_kernel true, its
    unfused candidate) runs the collision_pushes kernel's route; an entry
    without use_kernel keeps the config's Gram form."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)
    autotuner.save([{"kind": "collisions", "key": {"num_worlds": 4, "num_objects": 6},
                     "config": config, "backend": "cpu", "validated": True}], path)
    calls = []
    pushes_fn = col.collision_pushes
    monkeypatch.setattr(col, "collision_pushes",
                        lambda *a, **k: calls.append(1) or pushes_fn(*a, **k))
    monkeypatch.setattr(col, "fused_collisions_step",
                        lambda *a, **k: pytest.fail("the fused tick ran"))
    cfg = col.CollisionsConfig(num_worlds=4, num_objects=6)
    assert cfg.fused is None and not cfg.use_kernel
    col.make_executor(cfg, device="cpu").run(2)
    assert len(calls) == pushes


def test_tuned_collisions_entry_records_the_measured_route(monkeypatch):
    """tune_collisions' entry holds use_kernel beside fused: its unfused
    candidate ran the collision_pushes kernel."""
    speeds = {"fused=False": 10.0, "fused=True": 5.0, "fused=None": 9.0}

    def measure(build, ticks, timeout, artifact=None):
        return speeds[next(k for k in speeds if k in build)]

    monkeypatch.setattr(autotuner, "_measure_subprocess", measure)
    entry = autotuner.tune_collisions(num_worlds=4, num_objects=6, ticks=1, device="cpu")
    assert entry["config"] == {"fused": False, "use_kernel": True} and entry["validated"]


def test_rigid_bench_capacity_is_looked_up_for_the_executors_device(tmp_path, monkeypatch):
    """make_executor resolves the candidate capacity for its own device's
    backend: on a machine with a card (backend "cuda"), an executor on the
    CPU does not take a capacity tuned on the card."""
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)
    autotuner.save([{"kind": "physics_capacity", "key": {"num_worlds": 2, "bodies": 8},
                     "config": {"max_candidates": 24, "for_bodies": 8}, "backend": "cuda",
                     "validated": True}], path)
    monkeypatch.setattr(autotuner, "backend", lambda: "cuda")
    cfg = rb.RigidBenchConfig(num_worlds=2, num_bodies=8, contact_mode="pallas")
    assert cfg.candidates() == 24 and cfg.candidates("cpu") == 32
    sim = rb.make_executor(cfg, device="cpu")
    assert sim.world_cls.config.max_candidates == 32


# the configurations the other tests build with "auto", fused=None or no
# max_candidates, and how the fixed rule resolves them on the CPU
COLLISIONS = [(1, 4), (2, 8), (4, 24), (8, 10), (4, 6), (1, 100)]
RIGID = [(2, 8, "dense"), (1, 32, "dense"), (2, 47, "dense"), (2, 48, "pallas"),
         (1, 60, "pallas"), (2, 64, "pallas"), (2, 200, "pallas"), (2, 255, "pallas")]
UNFUSED = ["aabb_preprocess", "broadphase", "narrowphase", "clear_CollisionCandidate",
           "solver", "clear_Contact"]


@pytest.mark.parametrize("artifact", ["absent", "repo"])
def test_without_a_cpu_entry_everything_resolves_by_the_fixed_rule(tmp_path, monkeypatch,
                                                                   artifact):
    monkeypatch.setenv(autotuner.CONFIG_ENV, str(tmp_path / "absent.json")
                       if artifact == "absent" else REPO_TUNE)
    for worlds, objects in COLLISIONS:
        sim = col.make_executor(col.CollisionsConfig(num_worlds=worlds, num_objects=objects,
                                                     max_pairs=16), device="cpu")
        assert sim.graph.node_names == UNFUSED
    for worlds, bodies, mode in RIGID:
        cfg = rb.RigidBenchConfig(num_worlds=worlds, num_bodies=bodies, contact_mode="auto")
        assert cfg.candidates() == 4 * bodies
        assert contact_mode_of(rb.make_executor(cfg, device="cpu")) == mode, bodies


@pytest.mark.slow
def test_sweep_emits_consumable_artifact(tmp_path, monkeypatch):
    """End to end on the CPU: tune_collisions measures both settings in
    fresh processes and saves a "cpu" entry, which
    CollisionsConfig(fused=None) consumes through GEM_TPU_EXEC_CONFIG_FILE:
    with fused False the tick kernel is never called, with True it is."""
    path = str(tmp_path / "tune.json")
    entry = autotuner.tune_collisions(num_worlds=4, num_objects=6, ticks=2, device="cpu")
    assert entry["kind"] == "collisions" and entry["backend"] == "cpu"
    assert "fused" in entry["config"] and len(entry["metric_steps_per_s"]) >= 1
    assert entry["heuristic_steps_per_s"] > 0 and not entry["failed"]
    autotuner.save([entry], path)
    monkeypatch.setenv(autotuner.CONFIG_ENV, path)

    class _Marker(Exception):
        pass

    def boom(*a, **k):
        raise _Marker()

    monkeypatch.setattr(col, "fused_collisions_step", boom)
    for fused in (False, True):
        autotuner.save([{"kind": "collisions", "key": {"num_worlds": 4, "num_objects": 6},
                         "config": {"fused": fused}, "backend": "cpu", "validated": True}],
                       path)
        sim = col.make_executor(col.CollisionsConfig(num_worlds=4, num_objects=6, seed=0),
                                device="cpu")
        if fused:
            with pytest.raises(_Marker):
                sim.run(1)
        else:
            sim.run(2)
            assert np.isfinite(sim.get_exported(0)[0].numpy()).all()
