"""The port's profiler (tooling/profiler.py) against the JAX package's:
tests/test_tooling.py's profiling cases and tests/test_node_timeline.py's.

- ``profile_nodes`` and ``sweep`` on the port (the CPU: host clock);
- ``node_timeline`` and ``_scope_node`` of both packages on JAX's synthetic
  trace events, equal dict for dict;
- a trace written by the port's ``trace_step`` read by JAX's
  ``node_timeline`` and ``aggregate_trace``, equal to the port's reading;
  its node segments inside their step spans;
- the same SVG text from both ``render_timeline_svg`` on one timeline;
- ``profile_nodes`` and ``trace_step`` leave an executor whose step writes
  a singleton in place (the settled pile's ManifoldPersist) bit for bit
  as it was.
"""

import numpy as np
import pytest

from gpu_ecs_madrona_tpu.tooling import profiler as jprofiler
from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import rigid_bench as rb
from gpu_ecs_madrona_tpu_torch.tooling import profiler

from test_node_timeline import synthetic_events


def make_sim(**kw):
    d = dict(num_worlds=2, num_objects=8, max_pairs=64, seed=6)
    d.update(kw)
    return col.make_executor(col.CollisionsConfig(**d), device="cpu")


def test_profile_nodes():
    sim = make_sim()
    rows = profiler.profile_nodes(sim, iters=2)
    names = [r["node"] for r in rows]
    assert names == sim.graph.node_names + ["__full_step__"]
    assert "broadphase" in names
    assert all(r["mean_ms"] >= 0 and r["clock"] == "host" for r in rows)


def test_sweep_harness(tmp_path):
    rows = profiler.sweep(lambda a, b: a * 10 + b, {"a": [1, 2], "b": [3, 4]},
                          out_json=str(tmp_path / "sweep.json"))
    assert rows[0] == {"a": 2, "b": 4, "metric": 24}
    assert rows == jprofiler.sweep(lambda a, b: a * 10 + b, {"a": [1, 2], "b": [3, 4]})
    assert (tmp_path / "sweep.json").exists()


def test_node_timeline_matches_jax_on_synthetic_events():
    tl = profiler.node_timeline("unused", events=synthetic_events())
    assert tl == jprofiler.node_timeline("unused", events=synthetic_events())
    by_node = {r["node"]: r for r in tl["nodes"]}
    assert by_node["node_a"]["total_us"] == 300.0
    assert [s["node"] for s in tl["steps"][0]["segments"]] == ["node_a", "node_b", "copy.9"]


@pytest.mark.parametrize("tf_op", ["jit(step)/bp_find_overlaps/top_k:",
                                   "jit(step)/physics_substeps_fused/jit(_run_fused)/pallas_call:",
                                   "", "pjit(f)/jit(g)/", "plain_name", "jit(step)/broadphase:"])
def test_scope_node_matches_jax(tf_op):
    assert profiler._scope_node(tf_op) == jprofiler._scope_node(tf_op)


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    sim = make_sim()
    d = str(tmp_path_factory.mktemp("trace"))
    assert profiler.trace_step(sim, d, steps=3) == d
    return sim, d


def test_port_trace_reads_the_same_in_jax(traced):
    sim, d = traced
    tl = profiler.node_timeline(d)
    assert tl == jprofiler.node_timeline(d)
    assert profiler.aggregate_trace(d) == jprofiler.aggregate_trace(d)
    assert len(tl["steps"]) == 3
    assert {r["node"] for r in tl["nodes"]} <= set(sim.graph.node_names)
    assert "broadphase" in {r["node"] for r in tl["nodes"]}
    for step in tl["steps"]:
        for seg in step["segments"]:
            assert 0 <= seg["start_us"] and seg["start_us"] + seg["dur_us"] <= step["dur_us"]
    step_total = sum(s["dur_us"] for s in tl["steps"])
    assert sum(r["total_us"] for r in tl["nodes"]) <= step_total + 0.1 * len(tl["nodes"])


def test_timeline_svg_matches_jax(traced, tmp_path):
    _, d = traced
    tl = profiler.node_timeline(d)
    mine = open(profiler.render_timeline_svg(tl, str(tmp_path / "port.svg"))).read()
    theirs = open(jprofiler.render_timeline_svg(tl, str(tmp_path / "jax.svg"))).read()
    assert mine == theirs and "<svg" in mine and "broadphase" in mine
    with pytest.raises(ValueError, match="empty timeline"):
        profiler.render_timeline_svg({"steps": [], "nodes": []}, str(tmp_path / "e.svg"))


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def test_profiling_leaves_an_in_place_state_bit_for_bit(tmp_path):
    """The settled pile's step writes ManifoldPersist in place (checked);
    profiling and tracing its executor leave every leaf as it was."""
    sim = rb.make_executor(rb.RigidBenchConfig(num_worlds=2, num_bodies=8, **rb.SETTLED_PILE),
                           device="cpu")
    assert "ManifoldPersist" in sim.registry.in_place_singletons
    before = dict(leaves(state_to_numpy(sim.state)))
    profiler.profile_nodes(sim, iters=2)
    profiler.trace_step(sim, str(tmp_path), steps=2)
    after = dict(leaves(state_to_numpy(sim.state)))
    assert before.keys() == after.keys()
    for path, leaf in before.items():
        np.testing.assert_array_equal(after[path], leaf, err_msg=str(path))
    # a step on the executor's own state (no copy) does write it in place
    sim.graph.step(sim.state)
    cache = state_to_numpy(sim.state)["singleton"]["ManifoldPersist"]
    assert any(not np.array_equal(cache[k], before[("singleton", "ManifoldPersist", k)])
               for k in cache)


def test_profiling_and_stepping_leave_user_data_as_it_was(tmp_path):
    """collisions' fused path stashes its push in ``ctx.data``: neither the
    profiler nor a step changes the state they were given."""
    sim = make_sim(fused=True)
    sim.run(2)
    state = sim.state
    before = dict(leaves(state_to_numpy(state)))
    profiler.profile_nodes(sim, iters=2)
    profiler.trace_step(sim, str(tmp_path), steps=2)
    sim.step()
    assert sim.state is not state
    after = dict(leaves(state_to_numpy(state)))
    for path, leaf in before.items():
        np.testing.assert_array_equal(after[path], leaf, err_msg=str(path))
