"""Physics component set (PyTorch) — mirrors reference
include/madrona/physics.hpp.

Counterpart of ``gpu_ecs_madrona_tpu/physics/components.py``: the same
names, fields, shapes and dtypes, so a JAX state converts 1:1
(``interop.state_from_numpy``).  Quaternions (w,x,y,z), vectors xyz.  The
solver's per-body stashes (SubstepPrevState / PreSolvePositional /
PreSolveVelocity, physics.hpp:396-413) are ordinary components.
"""

import torch

from gpu_ecs_madrona_tpu_torch.core.component import component, singleton_component

f32, i32 = torch.float32, torch.int32

# Dynamics state (physics.hpp:168-173 Velocity)
Velocity = component("Velocity", linear=((3,), f32), angular=((3,), f32))

# Response type enum (physics.hpp:161-166): 0=Dynamic, 1=Kinematic, 2=Static
ResponseType = component("ResponseType", ((), i32))
RESPONSE_DYNAMIC = 0
RESPONSE_KINEMATIC = 1
RESPONSE_STATIC = 2

# External force/torque accumulators (physics.hpp:150-159)
ExternalForce = component("ExternalForce", ((3,), f32))
ExternalTorque = component("ExternalTorque", ((3,), f32))

# Broadphase leaf bookkeeping (physics.hpp:297-299 LeafID): the "leaf" is
# the body's row; the column holds the velocity-expanded AABB.
CollisionAABB = component("CollisionAABB", lo=((3,), f32), hi=((3,), f32))
LeafID = component("LeafID", ((), i32))

# Solver stashes (physics.hpp:396-413)
SubstepPrevState = component("SubstepPrevState", prev_pos=((3,), f32),
                             prev_rot=((4,), f32))
PreSolvePositional = component("PreSolvePositional", x=((3,), f32), q=((4,), f32))
PreSolveVelocity = component("PreSolveVelocity", v=((3,), f32), omega=((3,), f32))

# Collision events (physics.hpp:175-183)
CollisionEvent = component("CollisionEvent", a=((), i32), b=((), i32))

# Candidate/contact temporaries (physics.hpp:184-198).  CandidateCollision
# holds entity handles; CandidatePairRows the body ROW indices the substep
# gathers through.
CandidateCollision = component("CandidateCollision", a=((), i32), b=((), i32))
CandidatePairRows = component("CandidatePairRows", i=((), i32), j=((), i32))
ContactConstraint = component(
    "ContactConstraint",
    ref=((), i32),            # entity handle of reference body
    alt=((), i32),            # entity handle of other body
    points=((4, 4), f32),     # xyz + penetration depth per point
    num_points=((), i32),
    normal=((3,), f32),
    lambda_n=((4,), f32),
)

# Joints (physics.hpp:200-243), union payload flattened; joint_type
# 0=Fixed, 1=Hinge; solved by solver.solve_joints.
JointConstraint = component(
    "JointConstraint",
    e1=((), i32),
    e2=((), i32),
    joint_type=((), i32),
    attach_rot1=((4,), f32),
    attach_rot2=((4,), f32),
    separation=((), f32),
    a1_local=((3,), f32),
    a2_local=((3,), f32),
    b1_local=((3,), f32),
    b2_local=((3,), f32),
    r1=((3,), f32),
    r2=((3,), f32),
)
JOINT_FIXED = 0
JOINT_HINGE = 1

# Per-world solver/config singleton (physics.cpp:1012-1036 init).
PhysicsState = singleton_component(
    "PhysicsState",
    delta_t=((), f32),
    h=((), f32),                       # substep dt = delta_t / num_substeps
    gravity=((3,), f32),
    restitution_threshold=((), f32),   # 2*|g|*h (physics.cpp:31)
)

# World-level sleeping state (beyond the reference).  Registered
# unconditionally, as in the JAX package, so the state schema does not
# depend on the option; the fused substep node reads and updates it when
# sleep_threshold > 0 (setup_substep_tasks).
SleepState = singleton_component(
    "SleepState",
    quiet_steps=((), i32),
    asleep=((), i32),
)
