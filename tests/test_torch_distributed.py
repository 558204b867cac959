"""Two processes across ranks on the CPU (torch.distributed, gloo): the
port's counterpart of tests/test_distributed.py.

The JAX executor's collisions state (CollisionsConfig(num_worlds=8,
num_objects=10, max_pairs=128, seed=5)) goes to a checkpoint; each of two
worker processes (tests/test_torch_rank_cases.py ``collisions_worker``,
``initialize_distributed`` on a free local port, ``make_world_mesh``,
``shard_state``) steps its 4 worlds 3 times.  Each rank's state equals the
matching rows of one process stepping all 8 worlds, bit for bit, leaf for
leaf (positions, masks, handles, generator streams); the
cross-rank checksum (an all_reduce of the ranks' |pos| sums) is the same
on both ranks and within 1e-4 relative of tests/test_distributed.py's
checksum (JAX, the same three steps, jnp.sum of |pos|).  The workers get
120 s; on a timeout or a failure every worker is killed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpu_ecs_madrona_tpu.models import collisions as jcol
from gpu_ecs_madrona_tpu_torch.interop import state_to_numpy
from gpu_ecs_madrona_tpu_torch.models import collisions as col

import test_torch_rank_cases as rc

W, STEPS = 8, 3


def test_two_process_distributed_step(tmp_path):
    jsim = jcol.make_executor(jcol.CollisionsConfig(num_worlds=W, num_objects=10,
                                                    max_pairs=128, seed=5), donate=False)
    ckpt = str(tmp_path / "start.npz")
    jsim.save_checkpoint(ckpt)
    step = jax.jit(jsim.graph.step)
    jstate = jsim.state
    for _ in range(STEPS):
        jstate = step(jstate)
    jpos = jstate["arch"][jcol.CubeObject.name]["comps"][jcol.Translation.name]["value"]
    jax_checksum = float(jnp.sum(jnp.abs(jpos)))

    one = col.make_executor(rc.collisions_config("distributed", W), device="cpu")
    one.restore_checkpoint(ckpt)
    one.run(STEPS)
    want = rc.collisions_positions(one)
    full = state_to_numpy(one.state)

    out = str(tmp_path / "ranks")
    rc.run_ranks(tmp_path, "collisions_worker", 2, ckpt, out, STEPS, W, "None")
    sums = []
    for r in range(2):
        with np.load(f"{out}.{r}.npz") as z:
            res = dict(z)
        assert tuple(res["worlds"]) == (4 * r, 4 * r + 4)
        pos = res["state/arch/CubeObject/comps/Translation/value"]
        np.testing.assert_array_equal(pos, want[4 * r:4 * r + 4].numpy())
        assert rc.rank_state_rows(res, full) == []    # every leaf, rng included
        sums.append(float(res["checksum"][0]))
        assert int(res["launches"]) == 0          # the CPU runs the plain versions
    assert sums[0] == sums[1] > 0
    assert sums[0] == pytest.approx(jax_checksum, rel=1e-4)
    assert sums[0] == pytest.approx(float(want.abs().sum()), rel=1e-6)
