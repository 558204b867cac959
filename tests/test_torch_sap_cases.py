"""The sap broadphase's cases for the CPU tests, the card tests and
chip_smoke.py (numpy and the port only: no JAX, no test of its own).

  - ``set_grid``: a rigid_bench state's bodies moved onto an unrotated grid
    of boxes at rest (4 columns): every box has the same x extent, so the
    globals' top-k ties, and each column the same lower x, so the sweep's
    sort ties;
  - ``aabb_state``: an executor's state (or a numpy state of its layout)
    with its step's AABB columns (its ``bp_update_aabbs`` node run on its
    own device), as numpy;
  - ``sap_outputs``: the executor's ``bp_find_overlaps`` node run on its
    device from a numpy state: the candidate temporaries and
    CandidateRowsTemporary's overflow counter, as numpy;
  - ``differing``: how many integer entries of two such outputs differ;
  - ``leaves``: a nested dict's leaves in key order.
"""

import numpy as np

from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.interop import state_from_numpy, state_to_numpy

BODY = "RigidBenchBody"
ROWS = "CandidateRowsTemporary"
CANDIDATES = "CandidateTemporary"
BOX = 0


def set_grid(state):
    """``state`` (numpy, changed in place and returned) with its body rows
    past row 0 on an unrotated grid of boxes at rest."""
    comps = state["arch"][BODY]["comps"]
    cap = comps["ObjectID"]["value"].shape[1]
    idx = np.arange(1, cap)
    grid = np.stack([(idx % 4) * 1.5, (idx // 4) * 0.9, np.full(idx.shape, 0.6)], -1)
    comps["Position"]["value"][:, 1:] = grid.astype(np.float32)
    comps["Rotation"]["value"][:, 1:] = np.array([1.0, 0.0, 0.0, 0.0], np.float32)
    comps["ObjectID"]["value"][:, 1:] = BOX
    for f in comps["Velocity"]:
        comps["Velocity"][f][:] = 0.0
    return state


def _node(sim, name):
    return next(nd for nd in sim.graph.nodes if nd.name == name).run


def aabb_state(sim, state=None):
    ctx = Context(sim.mgr, sim.state if state is None
                  else state_from_numpy(state, sim.mgr.device))
    _node(sim, "bp_update_aabbs")(ctx)
    return state_to_numpy(ctx.state)


def sap_outputs(sim, state):
    ctx = Context(sim.mgr, state_from_numpy(state, sim.mgr.device))
    _node(sim, "bp_find_overlaps")(ctx)
    out = state_to_numpy(ctx.state)
    return {"rows": out["arch"][ROWS], "candidates": out["arch"][CANDIDATES],
            "overflow": out["overflow"][ROWS]}


def leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k])
    else:
        yield tree


def differing(a, b):
    """Integer entries that differ between two sap_outputs (0: equal)."""
    return int(sum(np.count_nonzero(x != y) for x, y in zip(leaves(a), leaves(b))))
