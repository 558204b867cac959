"""Kernel 5's node launch on the CPU: its plain version against the route
the kernel-mode substep node ran before the launch took it all in.

The node of a world with joints (``physics_substep_<i>``) now makes one
kernel-5 launch a substep (``SubstepKernel.step``: the integrate, steps 2-9,
the joint solve and the writeback); on the CPU it runs the launch's plain
version, ``substep_node_plain``.  These tests hold that plain version, bit
for bit, to the route composed as the node composed it before: the object
table's constants gathered at the body's object (raw, the integrate's),
``solver.integrate``, ``SubstepKernel``'s steps 2-9 on the constants zeroed
off the dynamic rows, the joints' rows by ``StateManager.lookup``,
``solver.solve_joints``, and the writeback with the three stashes — on
simple_taskgraph's state (64 dead joint rows, dead body rows), on a world
with live Fixed and Hinge joints and static bodies, and on simple_taskgraph's
state with random live joints (several on one body and side, a null handle,
a handle into another archetype).  The JAX comparisons of the node are
tests/test_torch_simple_taskgraph.py, test_torch_joint_world.py and
test_torch_substep_joints.py.
"""

import pytest
import torch

from gpu_ecs_madrona_tpu_torch import physics as phys
from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.models import simple_taskgraph as stg
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as sk
from gpu_ecs_madrona_tpu_torch.physics import solver

from test_torch_joint_scenes import joint_world, random_joints

RS = phys.RigidBodyPhysicsSystem


def route_before(sim, arch, objmgr, kern, kw):
    """The kernel-mode node's route before its one launch, on the node's
    inputs ``kw`` (RigidBodyPhysicsSystem.next_step_kernel_inputs(...,
    node=True))."""
    tab = phys._tables_on(objmgr, "cpu")
    o = kw["obj"].long()
    inv_mass, inv_inertia = tab["inv_mass"][o], tab["inv_inertia"][o]
    dyn = (kw["resp"] == phys.RESPONSE_DYNAMIC) & kw["mask"]
    new_pos, new_rot, v, w, prev_pos, prev_rot = solver.integrate(
        kw["pos"], kw["rot"], kw["v"], kw["w"], inv_mass, inv_inertia, kw["ext_f"], kw["ext_t"],
        dyn, kw["h"], kw["gravity"])
    im, ii = torch.where(dyn, inv_mass, 0.0), torch.where(dyn[..., None], inv_inertia, 0.0)
    p2, r2, v3, w3 = kern(pos=new_pos, rot=new_rot, v=v, w=w, prev_pos=prev_pos,
                          prev_rot=prev_rot, im=im, ii=ii, mu_s=tab["mu_s"][o],
                          mu_d=tab["mu_d"][o], obj=kw["obj"], dyn=dyn, rows_i=kw["rows_i"],
                          rows_j=kw["rows_j"], kvalid=kw["kvalid"], h=kw["h"],
                          restitution_threshold=kw["restitution_threshold"])
    rows = []
    for side in ("e1", "e2"):
        la, lr, lv = sim.mgr.lookup(sim.state, kw["joints"][side])
        rows.append(torch.where(lv & (la == sim.mgr.arch_index[arch.name]), lr, -1))
    p2, r2 = solver.solve_joints(p2, r2, im, ii, kw["joints"], rows[0], rows[1], kw["jmask"],
                                 relaxation=kern.relaxation)
    keep = dyn[..., None]
    vals = (torch.where(keep, p2, kw["pos"]), torch.where(keep, r2, kw["rot"]),
            torch.where(keep, v3, kw["v"]), torch.where(keep, w3, kw["w"]),
            prev_pos, prev_rot, new_pos, new_rot, v, w)
    return dict(zip(sk.NODE_KEYS, vals)), rows


def stg_case():
    sim = stg.make_executor(stg.SimpleTaskgraphConfig(num_worlds=2, num_objects=48, seed=3),
                            device="cpu")
    sim.run(2)
    return sim, stg.Sphere, stg.OBJMGR


@pytest.mark.parametrize("case", ["simple_taskgraph", "joint_world", "random_joints"])
def test_node_plain_equals_the_route_before(case):
    if case == "joint_world":
        sim = joint_world("pallas")
        sim.run(5)
        arch, objmgr = sim.world_cls.Body, None
    else:
        sim, arch, objmgr = stg_case()
    kern = RS.substep_kernel(sim)
    if objmgr is None:
        objmgr = kern.tables.om
    kw = RS.next_step_kernel_inputs(sim, arch, objmgr, node=True)
    if case == "random_joints":
        kw = random_joints(sim, kw, num_spheres=48)
    want, rows = route_before(sim, arch, objmgr, kern, kw)
    got = kern.step_plain(**kw)
    live = kw["jmask"] & (rows[0] >= 0) & (rows[1] >= 0)
    mask = kw["mask"]
    dyn = (kw["resp"] == phys.RESPONSE_DYNAMIC) & mask
    if case == "simple_taskgraph":
        assert not bool(live.any()) and bool((~mask).any())
    else:
        assert bool(live.any()) and bool((~dyn & mask).any() or (~mask).any())
    for k in sk.NODE_KEYS:
        assert got[k].shape == want[k].shape and torch.isfinite(got[k]).all(), k
        assert torch.equal(got[k], want[k]), k
    # the joints moved their bodies, the others kept their pose
    if case != "simple_taskgraph":
        free = kern.step_plain(**dict(kw, jmask=torch.zeros_like(kw["jmask"])))
        assert float((free["pos"] - got["pos"]).abs().max()) > 1e-4
    assert torch.equal(got["pos"][~dyn], kw["pos"][~dyn])
    assert torch.equal(got["v"][~dyn], kw["v"][~dyn])


def test_node_runs_the_launch_once_a_substep():
    """Each substep node is one SubstepKernel.step call: on the CPU its
    plain version (no launch counted), its columns the node's outputs."""
    sim, arch, objmgr = stg_case()
    kern = RS.substep_kernel(sim)
    kw = RS.next_step_kernel_inputs(sim, arch, objmgr, node=True)
    want = kern.step_plain(**kw)
    calls = []
    step = kern.step
    kern.step = lambda **k: calls.append(1) or step(**k)
    try:
        sk.SubstepKernel.launches = 0
        from gpu_ecs_madrona_tpu_torch.core.context import Context
        ctx = Context(sim.mgr, sim.state)
        for node in sim.graph.nodes:
            node.run(ctx)
            if node.name == "physics_substep_0":
                break
    finally:
        kern.step = step
    assert calls == [1] and sk.SubstepKernel.launches == 0
    assert torch.equal(ctx.column(arch, base.Position), want["pos"])
    assert torch.equal(ctx.column(arch, phys.PreSolveVelocity)["omega"], want["ps_w"])
