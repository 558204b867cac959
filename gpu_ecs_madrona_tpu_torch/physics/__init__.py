"""RigidBodyPhysicsSystem — public physics API (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/physics/__init__.py`` (reference
include/madrona/physics.hpp:419-447):
  registerTypes        -> register_types(registry, ...)
  init                 -> init(ctx, delta_t, num_substeps, gravity)
  registerEntity       -> register_entity (rows as LeafIDs)
  setupBroadphaseTasks -> setup_broadphase_tasks(builder, deps, ...)
  setupSubstepTasks    -> setup_substep_tasks(builder, deps, num_substeps, ...)
  setupCleanupTasks    -> setup_cleanup_tasks(builder, deps)

Pipeline per step: broadphase (velocity-expanded AABBs + the dense AABB
overlap grid, compacted to candidate rows) -> the substeps (integrate ->
narrowphase -> positional solve -> velocity recovery -> velocity solve)
-> cleanup of the temporaries.

What is ported: broadphase ``mode="dense"`` (exact ``dense_degree=0`` and
rank-compacted ``dense_degree>0``); ``contact_mode="pairs"`` (one node per
substep, the pair math of physics/pairs.py, contact and event temporaries
emitted lazily on the last substep) and ``contact_mode="pallas"``, which
keeps the JAX spelling and here means the fused substep kernel
(ops/substep_kernel.py: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors), one node and one launch per step.
``contact_mode="auto"`` picks "pallas" above 48 body rows on any device.
Everything else raises NotImplementedError naming its ROADMAP item: the
dense contact mode (and "auto" at 48 rows or fewer), the sap and fused
broadphases, contact_refresh, sleep, persistent manifolds, joints and
raycasts.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import batched_gather
from gpu_ecs_madrona_tpu_torch.core.taskgraph import NodeID, TaskGraphBuilder
from gpu_ecs_madrona_tpu_torch.ops.substep_kernel import FusedSubstepKernel
from gpu_ecs_madrona_tpu_torch.physics import assets  # noqa: F401  (public submodule)
from gpu_ecs_madrona_tpu_torch.physics import pairs as pk
from gpu_ecs_madrona_tpu_torch.physics import solver as solver_mod
from gpu_ecs_madrona_tpu_torch.physics.components import (
    CandidateCollision,
    CandidatePairRows,
    CollisionAABB,
    CollisionEvent,
    ContactConstraint,
    ExternalForce,
    ExternalTorque,
    JointConstraint,
    LeafID,
    PhysicsState,
    PreSolvePositional,
    PreSolveVelocity,
    ResponseType,
    RESPONSE_DYNAMIC,
    SleepState,
    SubstepPrevState,
    Velocity,
)
from gpu_ecs_madrona_tpu_torch.utils import debug
from gpu_ecs_madrona_tpu_torch.utils import math as m
from gpu_ecs_madrona_tpu_torch.utils.compaction import first_partners, rank_slots

# Components a body archetype must include (physics.cpp:1055-1081).
BODY_COMPONENTS = [
    base.Position,
    base.Rotation,
    base.Scale,
    base.ObjectID,
    Velocity,
    ResponseType,
    ExternalForce,
    ExternalTorque,
    CollisionAABB,
    LeafID,
    SubstepPrevState,
    PreSolvePositional,
    PreSolveVelocity,
]

CandidateTemporary = Archetype("CandidateTemporary", [CandidateCollision])
CandidateRowsTemporary = Archetype("CandidateRowsTemporary", [CandidatePairRows])
ContactTemporary = Archetype("ContactTemporary", [ContactConstraint])
CollisionEventTemporary = Archetype("CollisionEventTemporary", [CollisionEvent])
JointArchetype = Archetype("JointArchetype", [JointConstraint])

# Dense narrowphase below this many body rows in contact_mode="auto" (the
# JAX package's threshold; that mode waits).
AUTO_DENSE_MAX_ROWS = 48
# broadphase_mode="auto": dense up to this capacity, sap beyond (JAX's
# measured crossover; sap waits).
AUTO_DENSE_BP_MAX_ROWS = 192
# The task-graph node of contact_mode="pallas" (one kernel launch a step).
FUSED_NODE = "physics_substeps_fused"


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to gpu_ecs_madrona_tpu_torch yet (ROADMAP: {item})")


def _tables_on(object_manager, device) -> Dict[str, torch.Tensor]:
    """The object manager's per-object arrays the nodes index, on device."""
    out = {}
    for k in ("inv_mass", "inv_inertia", "mu_s", "mu_d", "local_aabb_lo", "local_aabb_hi"):
        out[k] = torch.as_tensor(object_manager[k], dtype=torch.float32, device=device)
    rest = object_manager.get("restitution")
    out["restitution"] = (torch.zeros_like(out["mu_d"]) if rest is None else
                          torch.as_tensor(rest, dtype=torch.float32, device=device))
    return out


def _stable_topk_rows(flag, k):
    """Indices of the first k entries of flag [W, M] in descending order,
    lower index first among equals (lax.top_k's order on 0/1 values)."""
    return torch.sort(flag.to(torch.int8), dim=1, descending=True, stable=True).indices[:, :k]


class RigidBodyPhysicsSystem:
    @staticmethod
    def register_types(registry: ECSRegistry, max_candidates: int = 1024,
                       max_contacts: int = 1024, max_joints: int = 64):
        """reference RigidBodyPhysicsSystem::registerTypes
        (physics.cpp:1055-1081).  The joint archetype is registered as in
        the JAX package (so states convert 1:1); solving joints waits, and
        setup_substep_tasks raises when it has capacity."""
        base.register_types(registry)
        for comp in BODY_COMPONENTS:
            registry.register_component(comp)
        registry.register_singleton(PhysicsState)
        registry.register_singleton(SleepState)
        registry.register_archetype(CandidateTemporary, capacity=max_candidates,
                                    temporary=True)
        registry.register_archetype(CandidateRowsTemporary, capacity=max_candidates,
                                    temporary=True)
        registry.register_archetype(ContactTemporary, capacity=max_contacts, temporary=True)
        registry.register_archetype(CollisionEventTemporary, capacity=max_contacts,
                                    temporary=True)
        if max_joints > 0:
            registry.register_archetype(JointArchetype, capacity=max_joints)

    @staticmethod
    def init(ctx: Context, delta_t: float, num_substeps: int, gravity=(0.0, 0.0, -9.8)):
        """reference RigidBodyPhysicsSystem::init (physics.cpp:1012-1036):
        the per-world solver singleton; restitution threshold 2*|g|*h
        (physics.cpp:31)."""
        W, dev = ctx.num_worlds, ctx.device
        h = delta_t / num_substeps
        gmag = math.sqrt(sum(float(x) ** 2 for x in gravity))
        f32 = torch.float32
        ctx.set_singleton(PhysicsState, {
            "delta_t": torch.full((W,), delta_t, dtype=f32, device=dev),
            "h": torch.full((W,), h, dtype=f32, device=dev),
            "gravity": torch.tensor(gravity, dtype=f32, device=dev).expand(W, 3),
            "restitution_threshold": torch.full((W,), 2.0 * gmag * h, dtype=f32, device=dev),
        })
        ctx.set_singleton(SleepState, {
            "quiet_steps": torch.zeros((W,), dtype=torch.int32, device=dev),
            "asleep": torch.zeros((W,), dtype=torch.int32, device=dev),
        })

    @staticmethod
    def register_persistent_manifolds(registry: ECSRegistry, body_archetype: Archetype,
                                      max_candidates: int):
        _not_ported("persistent manifolds", "the fused kernel's options")

    @staticmethod
    def reset(ctx: Context):
        """reference RigidBodyPhysicsSystem::reset (physics.hpp:428): clear
        the per-step physics temporaries."""
        for arch in (CandidateTemporary, CandidateRowsTemporary, ContactTemporary,
                     CollisionEventTemporary):
            ctx.clear_archetype(arch)

    @staticmethod
    def register_entity(ctx: Context, ents, valid=None):
        """reference registerEntity (physics.hpp:429-431): the dense
        broadphase has no leaf reservation; returns the handles' rows as
        LeafIDs (-1 for dead handles)."""
        _, rows, live = ctx.mgr.lookup(ctx.state, ents)
        if valid is not None:
            live = live & valid
        return torch.where(live, rows, -1)

    @staticmethod
    def _body_data(ctx: Context, arch: Archetype, objtab):
        pos = ctx.column(arch, base.Position)
        rot = ctx.column(arch, base.Rotation)
        obj = ctx.column(arch, base.ObjectID)
        mask = ctx.row_mask(arch)
        o = obj.long()
        return (pos, rot, obj, mask, objtab["inv_mass"][o], objtab["inv_inertia"][o],
                objtab["mu_s"][o], objtab["mu_d"][o])

    @staticmethod
    def fused_kernel_inputs(ctx: Context, arch: Archetype, object_manager):
        """The fused substep kernel's keyword inputs (FusedSubstepKernel's
        call) from the current state: body columns, the per-object
        constants (inverse mass and inertia zeroed on non-dynamic rows),
        the solver singleton and this step's candidate rows (emitted by the
        broadphase earlier in the step).  ``object_manager``: the object
        manager dict, or its tensors from a previous call."""
        objtab = object_manager if isinstance(object_manager.get("inv_mass"), torch.Tensor) \
            else _tables_on(object_manager, ctx.device)
        pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d = \
            RigidBodyPhysicsSystem._body_data(ctx, arch, objtab)
        dyn = (ctx.column(arch, ResponseType) == RESPONSE_DYNAMIC) & mask
        phys = ctx.singleton(PhysicsState)
        vel = ctx.column(arch, Velocity)
        rows = ctx.column(CandidateRowsTemporary, CandidatePairRows)
        return dict(
            pos=pos, rot=rot, v=vel["linear"], w=vel["angular"],
            im=torch.where(dyn, inv_mass, 0.0), ii=torch.where(dyn[..., None], inv_inertia, 0.0),
            mu_s=mu_s, mu_d=mu_d, obj=obj, ext_f=ctx.column(arch, ExternalForce),
            ext_t=ctx.column(arch, ExternalTorque), dyn=dyn, h=phys["h"],
            gravity=phys["gravity"], restitution_threshold=phys["restitution_threshold"],
            rows_i=rows["i"], rows_j=rows["j"], kvalid=ctx.row_mask(CandidateRowsTemporary))

    @staticmethod
    def next_step_kernel_inputs(sim, arch: Archetype, object_manager):
        """fused_kernel_inputs for the next step of executor ``sim``: the
        step's nodes before the fused kernel's node (the broadphase, which
        emits the candidate rows) run on a Context over a copy of
        ``sim.state``, which stays as it was."""
        ctx = Context(sim.mgr, sim.state)
        for node in sim.graph.nodes:
            if node.name == FUSED_NODE:
                return RigidBodyPhysicsSystem.fused_kernel_inputs(ctx, arch, object_manager)
            node.run(ctx)
        raise ValueError(f"the executor's graph has no {FUSED_NODE!r} node "
                         "(contact_mode='pallas')")

    # ------------------------------------------------------------------

    @staticmethod
    def setup_broadphase_tasks(builder: TaskGraphBuilder, deps: Sequence[NodeID],
                               body_archetype: Archetype, object_manager: Dict[str, Any],
                               velocity_expansion: float = 1.0, mode: str = "auto",
                               sap_window: int = 0, sap_globals: int = 4,
                               sap_degree: int = 16, dense_degree: int = 0) -> NodeID:
        """reference setupBroadphaseTasks (broadphase.cpp:934-956):
        velocity-expanded world AABBs, then candidate pairs from the dense
        [W, n, n] overlap grid (the i < j pairs of live rows), emitted as
        CandidateTemporary (entity handles, built lazily) and
        CandidateRowsTemporary (body rows, read by the substeps).

        dense_degree = 0: every pair, in pair-index order (the JAX
        package's top_k order, by a stable sort).  dense_degree = D > 0:
        the rank compaction — each higher row keeps its first D lower
        partners, slot = base[owner] + rank; pairs over the cap are
        counted in CandidateRowsTemporary's overflow counter.
        mode "auto" is dense up to 192 body rows; "sap" and "fused" wait."""
        arch = body_archetype
        cap_n = builder.mgr.registry.archetypes[arch.name].capacity
        if mode == "auto":
            mode = "dense" if cap_n <= AUTO_DENSE_BP_MAX_ROWS else "sap"
        if mode not in ("dense", "sap", "fused"):
            raise ValueError(f"unknown broadphase mode {mode!r}")
        if mode == "sap":
            _not_ported("broadphase_mode='sap' (and 'auto' above 192 rows)",
                        "the fused kernel's options: the SAP broadphase")
        if mode == "fused":
            _not_ported("broadphase_mode='fused'",
                        "the fused kernel's options: in-kernel broadphase (kernel 8)")
        dev = builder.mgr.device
        objtab = _tables_on(object_manager, dev)
        W = builder.mgr.num_worlds
        n = cap_n
        triu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=dev), diagonal=1)
        k_cap = builder.mgr.registry.archetypes[CandidateTemporary.name].capacity
        k_eff = min(k_cap, n * n)
        leaf = torch.arange(n, dtype=torch.int32, device=dev).expand(W, n)

        def update_aabbs(ctx: Context):
            pos = ctx.column(arch, base.Position)
            rot = ctx.column(arch, base.Rotation)
            scale = ctx.column(arch, base.Scale)
            obj = ctx.column(arch, base.ObjectID).long()
            vel = ctx.column(arch, Velocity)
            phys = ctx.singleton(PhysicsState)
            lo_l = objtab["local_aabb_lo"][obj]
            hi_l = objtab["local_aabb_hi"][obj]
            # exact rotated AABB: center +- |R| half
            c_l = (lo_l + hi_l) * 0.5 * scale
            half = (hi_l - lo_l) * 0.5 * scale
            R = m.quat_to_mat(rot)                               # [W, n, 3, 3]
            aR = torch.abs(R)
            cw = pos + (R[..., 0] * c_l[..., 0:1] + R[..., 1] * c_l[..., 1:2]
                        + R[..., 2] * c_l[..., 2:3])
            ext = (aR[..., 0] * half[..., 0:1] + aR[..., 1] * half[..., 1:2]
                   + aR[..., 2] * half[..., 2:3])
            # velocity expansion (reference expandLeaf, physics.cpp:1023-1027)
            vexp = vel["linear"] * phys["delta_t"][:, None, None] * velocity_expansion
            lo = cw - ext + torch.clamp(vexp, max=0.0)
            hi = cw + ext + torch.clamp(vexp, min=0.0)
            ctx.set_column(arch, CollisionAABB, {"lo": lo, "hi": hi})
            ctx.set_column(arch, LeafID, leaf)

        n_aabb = builder.add_node(update_aabbs, deps, name="bp_update_aabbs")

        def emit_candidates(ctx: Context, counts, rows_i, rows_j):
            ents = ctx.entity_column(arch)
            ctx.emit_temporaries(
                CandidateTemporary, counts=counts, width=rows_i.shape[1],
                values=lambda: {CandidateCollision: {"a": batched_gather(ents, rows_i),
                                                     "b": batched_gather(ents, rows_j)}})
            ctx.emit_temporaries(CandidateRowsTemporary, counts=counts,
                                 values={CandidatePairRows: {"i": rows_i, "j": rows_j}})

        def find_overlaps(ctx: Context):
            # reference findOverlappingEntry (broadphase.cpp:897-932)
            aabb = ctx.column(arch, CollisionAABB)
            mask = ctx.row_mask(arch)
            lo, hi = aabb["lo"], aabb["hi"]
            ok = m.aabb_overlaps(lo[:, :, None, :], hi[:, :, None, :],
                                 lo[:, None, :, :], hi[:, None, :, :])
            ok = ok & mask[:, :, None] & mask[:, None, :] & triu
            counts = ok.sum(dim=(1, 2), dtype=torch.int32)
            if not dense_degree:
                pair_idx = _stable_topk_rows(ok.reshape(W, n * n), k_eff).to(torch.int32)
                emit_candidates(ctx, counts, pair_idx // n, pair_idx % n)
                return
            D = min(dense_degree, n)
            # owner = the higher row j, its partners the lower rows i < j
            partners, deg = first_partners(ok.transpose(1, 2), D)
            ab, _, excess = rank_slots(partners, deg, D, k_eff)
            debug.check(excess == 0, f"dense rank-compaction degree cap {D} exceeded: "
                        "dropped pairs={} per world", excess)
            ctx.add_overflow(CandidateRowsTemporary, excess)
            emit_candidates(ctx, counts - excess, ab[..., 1].contiguous(),
                            ab[..., 0].contiguous())

        return builder.add_node(find_overlaps, [n_aabb], name="bp_find_overlaps")

    @staticmethod
    def setup_substep_tasks(builder: TaskGraphBuilder, deps: Sequence[NodeID],
                            num_substeps: int, body_archetype: Archetype,
                            object_manager: Dict[str, Any], relaxation: float = 1.0,
                            contact_mode: str = "auto", substep_wt=None,
                            speculative_margin: float = 0.0, contact_refresh: bool = False,
                            sleep_threshold: float = 0.0, sleep_frames: int = 10,
                            manifold_persist: bool = False,
                            persist_margin: float = 0.05) -> NodeID:
        """reference setupSubstepTasks (physics.cpp:1149-1199).

        contact_mode:
          "pairs":  one node per substep over the compacted candidates
                    (CandidateRowsTemporary): integrate, pair gathers,
                    pair_contacts, positional pass, ordered segment sums,
                    velocity recovery, velocity pass.  The last substep
                    emits the contact and collision-event temporaries
                    (lazily: built only if read before the cleanup).
          "pallas": the fused substep kernel, one node (and one launch on
                    the card) per step; no contact temporaries.
          "auto":   "pallas" above 48 body rows, on any device; at 48 or
                    fewer (the dense mode) it raises.
        speculative_margin > 0: speculative-contact CCD (near-miss
        contacts clamp approach speed to depth/h in the velocity pass).
        contact_refresh, sleep_threshold > 0, manifold_persist, joints and
        contact_mode="dense" raise NotImplementedError (ROADMAP);
        substep_wt (the TPU kernel's world block) must stay None."""
        arch = body_archetype
        cap_n = builder.mgr.registry.archetypes[arch.name].capacity
        if contact_mode == "auto":
            contact_mode = "pallas" if cap_n > AUTO_DENSE_MAX_ROWS else "dense"
        if contact_mode not in ("dense", "pairs", "pallas"):
            raise ValueError(f"unknown contact_mode {contact_mode!r}")
        if contact_mode == "dense":
            _not_ported("contact_mode='dense' (and 'auto' at 48 rows or fewer)",
                        "the dense contact mode")
        if contact_refresh:
            _not_ported("contact_refresh", "the fused kernel's options")
        if sleep_threshold > 0.0:
            _not_ported("sleep_threshold > 0", "the fused kernel's options")
        if manifold_persist:
            _not_ported("manifold_persist", "the fused kernel's options")
        jinfo = builder.mgr.registry.archetypes.get(JointArchetype.name)
        if jinfo is not None and jinfo.capacity > 0:
            _not_ported("joints (a JointArchetype with capacity; register_types "
                        "max_joints=0 for worlds without joints)",
                        "joints and SubstepKernel (kernel 5)")
        if substep_wt is not None:
            raise ValueError("substep_wt is the TPU kernel's world-block size; "
                             "it has no meaning here")
        dev = builder.mgr.device
        objtab = _tables_on(object_manager, dev)
        W = builder.mgr.num_worlds

        def body_inputs(ctx: Context):
            pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d = \
                RigidBodyPhysicsSystem._body_data(ctx, arch, objtab)
            resp = ctx.column(arch, ResponseType)
            dyn = (resp == RESPONSE_DYNAMIC) & mask
            return pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d, dyn

        if contact_mode == "pallas":
            fused_kernel = FusedSubstepKernel(object_manager, num_substeps=num_substeps,
                                              relaxation=relaxation,
                                              speculative=speculative_margin)

            def substeps_fused(ctx: Context):
                kw = RigidBodyPhysicsSystem.fused_kernel_inputs(ctx, arch, objtab)
                out = fused_kernel(**kw)
                dyn, vel = kw["dyn"], ctx.column(arch, Velocity)
                ctx.set_column(arch, base.Position, out["pos"])
                ctx.set_column(arch, base.Rotation, out["rot"])
                keep = dyn[..., None]
                ctx.set_column(arch, Velocity, {
                    "linear": torch.where(keep, out["v"], vel["linear"]),
                    "angular": torch.where(keep, out["w"], vel["angular"])})
                ctx.set_column(arch, SubstepPrevState,
                               {"prev_pos": out["prev_pos"], "prev_rot": out["prev_rot"]})
                ctx.set_column(arch, PreSolvePositional, {"x": out["ps_pos"], "q": out["ps_rot"]})
                ctx.set_column(arch, PreSolveVelocity, {"v": out["ps_v"], "omega": out["ps_w"]})

            return builder.add_node(substeps_fused, list(deps), name=FUSED_NODE)

        tables = pk.ObjTables(object_manager)

        def make_substep(idx):
            def substep(ctx: Context):
                phys = ctx.singleton(PhysicsState)
                h = phys["h"]
                pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d, dyn = body_inputs(ctx)
                vel = ctx.column(arch, Velocity)
                new_pos, new_rot, v, w, prev_pos, prev_rot = solver_mod.integrate(
                    pos, rot, vel["linear"], vel["angular"], inv_mass, inv_inertia,
                    ctx.column(arch, ExternalForce), ctx.column(arch, ExternalTorque),
                    dyn, h, phys["gravity"])
                # pre-solve stash (reference PreSolvePositional/Velocity)
                ctx.set_column(arch, SubstepPrevState, {"prev_pos": prev_pos, "prev_rot": prev_rot})
                ctx.set_column(arch, PreSolvePositional, {"x": new_pos, "q": new_rot})
                ctx.set_column(arch, PreSolveVelocity, {"v": v, "omega": w})
                aabb = ctx.column(arch, CollisionAABB)

                rowsc = ctx.column(CandidateRowsTemporary, CandidatePairRows)
                kmask = ctx.row_mask(CandidateRowsTemporary)
                n = mask.shape[1]
                ri = rowsc["i"].long().clamp(0, n - 1)
                rj = rowsc["j"].long().clamp(0, n - 1)
                base_w = torch.arange(W, device=dev)[:, None] * n
                flat_i, flat_j = (ri + base_w).reshape(-1), (rj + base_w).reshape(-1)
                im_eff = torch.where(dyn, inv_mass, 0.0)
                ii_eff = torch.where(dyn[..., None], inv_inertia, 0.0)

                def gat(x, idx):
                    """[W, n, c] body channels at pair rows -> c-tuple of [W, K],
                    zero on dead slots (the JAX one-hot gather)."""
                    g = batched_gather(x, idx)
                    return tuple(torch.where(kmask, g[..., c], 0.0) for c in range(g.shape[-1]))

                def unpack(idx):
                    r = gat(new_rot, idx)
                    return {
                        "pos": gat(new_pos, idx),
                        "rot": (torch.where(kmask, r[0], 1.0),) + r[1:],
                        "prev_pos": gat(prev_pos, idx), "v": gat(v, idx), "w": gat(w, idx),
                        "im": gat(im_eff[..., None], idx)[0], "ii": gat(ii_eff, idx),
                        "mu_s": gat(mu_s[..., None], idx)[0],
                        "mu_d": gat(mu_d[..., None], idx)[0],
                        "obj": torch.where(kmask, batched_gather(obj, idx), 0),
                        "lo": gat(aabb["lo"], idx), "hi": gat(aabb["hi"], idx),
                    }

                SA, SB = unpack(ri), unpack(rj)
                pair_ok = kmask & pk.aabb_overlap(SA["lo"], SA["hi"], SB["lo"], SB["hi"])
                FA = pk.body_fields(SA["pos"], SA["rot"], SA["obj"], tables)
                FB = pk.body_fields(SB["pos"], SB["rot"], SB["obj"], tables)
                contacts = pk.pair_contacts(FA, FB, pair_ok, speculative=speculative_margin)

                def side1(S):
                    return {"pos": S["pos"], "rot": S["rot"], "im": S["im"], "ii": S["ii"],
                            "mu": S["mu_s"], "prev_pos": S["prev_pos"]}

                packA, packB, lam = pk.positional_pass(side1(SA), side1(SB), contacts,
                                                       relaxation=relaxation)
                acc = torch.stack(pk.segment_sum(packA, packB, flat_i, flat_j, kmask, W, n), -1)
                p2 = new_pos + acc[..., 0:3]
                r2 = solver_mod._apply_rot_delta(new_rot, acc[..., 3:6])
                v2, w2 = solver_mod.set_velocities(p2, r2, prev_pos, prev_rot, h, acc[..., 6:9])

                def side2(idx, S):
                    r = gat(r2, idx)
                    return {"pos": gat(p2, idx), "rot": (torch.where(kmask, r[0], 1.0),) + r[1:],
                            "im": S["im"], "ii": S["ii"], "mu": S["mu_d"],
                            "v": gat(v2, idx), "w": gat(w2, idx),
                            # restitution inputs: post-integrate velocities (the
                            # reference's PreSolveVelocity) and the material
                            "pv": S["v"], "pw": S["w"],
                            "rest": objtab["restitution"][S["obj"].long()]}

                vpA, vpB = pk.velocity_pass(side2(ri, SA), side2(rj, SB), contacts, lam,
                                            h[:, None], phys["restitution_threshold"][:, None],
                                            speculative=speculative_margin)
                accv = torch.stack(pk.segment_sum(vpA, vpB, flat_i, flat_j, kmask, W, n), -1)
                keep = dyn[..., None]
                ctx.set_column(arch, base.Position, torch.where(keep, p2, pos))
                ctx.set_column(arch, base.Rotation, torch.where(keep, r2, rot))
                ctx.set_column(arch, Velocity, {
                    "linear": torch.where(keep, v2 + accv[..., 0:3], vel["linear"]),
                    "angular": torch.where(keep, w2 + accv[..., 3:6], vel["angular"])})

                if idx == num_substeps - 1:
                    emit_contacts(ctx, contacts, lam, kmask, rowsc, n)

            substep.__name__ = f"physics_substep_{idx}"
            return substep

        def emit_contacts(ctx: Context, contacts, lam, kmask, rowsc, n):
            """Contact and collision-event temporaries of the last substep,
            in candidate order, deepest-4 points each (values built lazily;
            the counts now, for the overflow counters)."""
            okk = contacts["ok"] & kmask
            counts = okk.sum(dim=1, dtype=torch.int32)
            K = okk.shape[1]
            k_eff = min(builder.mgr.registry.archetypes[ContactTemporary.name].capacity, K)
            ents = ctx.entity_column(arch)

            def selected():
                a_ent = batched_gather(ents, torch.where(kmask, rowsc["i"], 0))
                b_ent = batched_gather(ents, torch.where(kmask, rowsc["j"], 0))
                cur = contacts["depth"]                               # [W, P, K]
                rows_p = torch.arange(cur.shape[1], device=cur.device)[None, :, None]
                sel_p, sel_d, sel_l = [], [], []
                for _ in range(4):
                    dmax, di = pk.extreme(cur, "max")
                    sel_d.append(dmax)
                    sel_p.append(torch.stack(pk.pick_rows(di, contacts["points"]), -1))
                    sel_l.append(pk.pick_rows(di, lam))
                    cur = torch.where(rows_p == di[:, None, :], -1e9, cur)
                pidx = _stable_topk_rows(okk, k_eff)

                def g(x):
                    return batched_gather(x, pidx)

                pts = torch.cat([g(torch.stack(sel_p, 2)), g(torch.stack(sel_d, 2))[..., None]],
                                -1)
                return g(a_ent), g(b_ent), {
                    "ref": g(a_ent), "alt": g(b_ent), "points": pts,
                    "num_points": g(torch.clamp(contacts["num_points"], max=4)),
                    "normal": g(torch.stack(contacts["normal"], -1)),
                    "lambda_n": g(torch.stack(sel_l, 2))}

            memo = {}

            def cached():
                if "v" not in memo:
                    memo["v"] = selected()
                return memo["v"]

            ctx.emit_temporaries(CollisionEventTemporary, counts=counts, width=k_eff,
                                 values=lambda: {CollisionEvent: {"a": cached()[0],
                                                                  "b": cached()[1]}})
            ctx.emit_temporaries(ContactTemporary, counts=counts, width=k_eff,
                                 values=lambda: {ContactConstraint: cached()[2]})

        last = list(deps)
        for i in range(num_substeps):
            last = [builder.add_node(make_substep(i), last)]
        return last[0]

    @staticmethod
    def setup_cleanup_tasks(builder: TaskGraphBuilder, deps: Sequence[NodeID]) -> NodeID:
        """reference setupCleanupTasks: clear the per-step temporaries."""
        n1 = builder.clear_tmp_node(CandidateTemporary, deps)
        n1b = builder.clear_tmp_node(CandidateRowsTemporary, [n1])
        n2 = builder.clear_tmp_node(ContactTemporary, [n1b])
        return builder.clear_tmp_node(CollisionEventTemporary, [n2])


def make_fixed_joint(*args, **kwargs):
    _not_ported("joints", "joints and SubstepKernel (kernel 5)")


def make_hinge_joint(*args, **kwargs):
    _not_ported("joints", "joints and SubstepKernel (kernel 5)")


def raycast(*args, **kwargs):
    _not_ported("raycast", "the renderer (kernel 10): raycasts share its ray math")
