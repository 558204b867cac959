"""The port's worlds across ranks (parallel/mesh.py) against the JAX
package's mesh (gpu_ecs_madrona_tpu/parallel/mesh.py).

``world_sharding`` is a rank's contiguous block of the worlds axis (an
uneven split raises, as JAX's NamedSharding refuses one); ``shard_state``
takes every leaf's block, the generator streams and unbuilt lazy rows
included.  A rank's shard of a collisions state equals, leaf for leaf and
exactly, the matching device's shard of JAX's ``shard_state`` on a
2-device CPU mesh (``rng`` through ``interop.rng_from_jax_keys``).  Worlds
stepped in two halves equal the same worlds stepped together, bit for bit
(fantasy_vs draws from each world's generator stream every step).  No
process group here: the meshes are built by hand, one per rank.
"""

import jax
import numpy as np
import pytest
import torch

from gpu_ecs_madrona_tpu.models import collisions as jcol
from gpu_ecs_madrona_tpu.parallel import make_world_mesh as jmake_world_mesh
from gpu_ecs_madrona_tpu.parallel import shard_state as jshard_state
from gpu_ecs_madrona_tpu_torch.core.state import LazyRows
from gpu_ecs_madrona_tpu_torch.interop import rng_from_jax_keys, state_from_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col
from gpu_ecs_madrona_tpu_torch.models import fantasy_vs as fvs
from gpu_ecs_madrona_tpu_torch.parallel import (
    WORLD_AXIS, WorldMesh, initialize_distributed, make_world_mesh, shard_state,
    world_sharding)

CPU = torch.device("cpu")


def rank_mesh(rank, size):
    return WorldMesh(rank, size, CPU)


def leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_world_sharding_splits_in_rank_order(size):
    blocks = [world_sharding(rank_mesh(r, size), 16) for r in range(size)]
    assert [b.start for b in blocks] == [16 // size * r for r in range(size)]
    assert [b.stop - b.start for b in blocks] == [16 // size] * size
    assert blocks[-1].stop == 16


@pytest.mark.parametrize("worlds,size", [(6, 4), (7, 2), (1, 2)])
def test_world_sharding_refuses_an_uneven_split(worlds, size):
    with pytest.raises(ValueError, match="do not split evenly"):
        world_sharding(rank_mesh(0, size), worlds)


def test_shard_state_slices_every_leaf_rng_included():
    sim = col.make_executor(col.CollisionsConfig(num_worlds=8, num_objects=6, max_pairs=32,
                                                 seed=2), device="cpu")
    sim.step()
    full = dict(leaves(sim.state))
    shards = [dict(leaves(shard_state(sim.state, rank_mesh(r, 4)))) for r in range(4)]
    assert ("rng",) in full
    for path, leaf in full.items():
        for r, shard in enumerate(shards):
            assert shard[path].dtype == leaf.dtype, path
            assert torch.equal(shard[path], leaf[2 * r:2 * r + 2]), path
            assert shard[path].data_ptr() != leaf.data_ptr()    # a copy
        assert torch.equal(torch.cat([s[path] for s in shards]), leaf), path
    # the streams differ by world: rank 1's are not rank 0's
    assert not torch.equal(shards[1][("rng",)], shards[0][("rng",)])


def test_shard_state_keeps_unbuilt_rows_lazy():
    built = []
    rows = {"mask": torch.arange(8)[:, None] > 3, "entity": torch.arange(16).reshape(8, 2),
            "comps": {}}

    def build():
        built.append(1)
        return rows

    state = {"tick": torch.zeros(8, dtype=torch.int32), "arch": {"T": LazyRows(build)}}
    shard = shard_state(state, rank_mesh(1, 2))
    assert isinstance(shard["arch"]["T"], LazyRows) and not shard["arch"]["T"].built
    assert not built
    assert torch.equal(shard["arch"]["T"]["entity"], rows["entity"][4:])
    assert built == [1]


def test_shard_state_refuses_a_leaf_without_the_worlds_axis():
    state = {"tick": torch.zeros(8, dtype=torch.int32), "user": {"table": torch.zeros(3)}}
    with pytest.raises(ValueError, match="no leading axis of 8 worlds"):
        shard_state(state, rank_mesh(0, 2))


def test_rank_shard_matches_jax_shard_state():
    """Rank r's shard of a collisions state equals device r's shard of JAX's
    shard_state on a 2-device CPU mesh, leaf for leaf."""
    jsim = jcol.make_executor(jcol.CollisionsConfig(num_worlds=8, num_objects=10,
                                                    max_pairs=128, seed=5), donate=False)
    jsim.step()
    devices = jax.devices()[:2]
    jstate = jshard_state(jsim.state, jmake_world_mesh(devices))
    port = state_from_numpy(jax.tree_util.tree_map(np.asarray, jsim.state), "cpu")
    jleaves = dict(leaves(jstate))
    for r, dev in enumerate(devices):
        mine = dict(leaves(shard_state(port, rank_mesh(r, 2))))
        assert set(mine) == set(jleaves)
        for path, jleaf in jleaves.items():
            (shard,) = [s for s in jleaf.addressable_shards if s.device == dev]
            want = np.asarray(shard.data)
            if path == ("rng",):
                assert torch.equal(mine[path], rng_from_jax_keys(want, "cpu"))
            else:
                np.testing.assert_array_equal(mine[path].numpy(), want, err_msg=str(path))


def test_halves_step_as_the_whole():
    """fantasy_vs (random draws from each world's stream every step): the
    two halves of 8 worlds, each stepped by a 4-world executor from its
    shard, equal the 8 worlds stepped together, bit for bit; a 4-world
    executor's own initial state would repeat rank 0's streams."""
    cfg = dict(num_dragons=3, num_knights=6, seed=4, cleanup=True)
    whole = fvs.make_executor(fvs.FantasyVsConfig(num_worlds=8, **cfg), device="cpu")
    start = whole.state
    whole.run(4)
    for r in range(2):
        half = fvs.make_executor(fvs.FantasyVsConfig(num_worlds=4, **cfg), device="cpu")
        if r == 1:
            assert torch.equal(half.state["rng"], start["rng"][:4])
            assert not torch.equal(half.state["rng"], start["rng"][4:])
        half.state = shard_state(start, rank_mesh(r, 2))
        half.run(4)
        for path, leaf in leaves(shard_state(whole.state, rank_mesh(r, 2))):
            assert torch.equal(dict(leaves(half.state))[path], leaf), path


def test_mesh_without_a_process_group():
    initialize_distributed()                      # no address: nothing happens
    assert not torch.distributed.is_initialized()
    mesh = make_world_mesh("cpu")
    assert (mesh.rank, mesh.world_size, mesh.device, mesh.group) == (0, 1, CPU, None)
    assert WORLD_AXIS == "worlds"
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and torch.equal(t, torch.arange(3.0))
    assert torch.equal(mesh.broadcast(t), torch.arange(3.0))
    with pytest.raises(RuntimeError, match="without a process group"):
        rank_mesh(0, 2).all_reduce(t)
