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

The broadphase modes: ``"dense"`` (exact ``dense_degree=0`` and
rank-compacted ``dense_degree>0``), ``"sap"`` (sweep and prune along x,
with the widest bodies tested densely) and ``"fused"`` (the broadphase
inside the fused substep kernel, degree cap ``dense_degree or 12``; the
substep node writes the AABB and LeafID columns and emits the candidate
temporaries from the kernel's outputs); ``"auto"`` is dense up to 192
body rows and sap above.  The contact modes: ``"dense"`` (one node per
substep over the whole [W, n, n] grid of body pairs,
physics/narrowphase.py and the dense solves of physics/solver.py);
``"pairs"`` (one node per substep over the compacted candidates, the
pair math of physics/pairs.py); and ``"pallas"``, which keeps the JAX
spelling and means the substep kernels of ops/substep_kernel.py (the CUDA
kernels for CUDA tensors, their plain versions for CPU tensors): without
joints the fused substep kernel, one node and one launch per step, with
its options contact_refresh, world sleep (``sleep_threshold``) and
persistent manifolds (``manifold_persist``, with
``register_persistent_manifolds``); with a joint archetype of any
capacity the single-substep kernel, one node and one launch per substep,
whose launch also integrates, solves the joints after the velocity pass
(as the JAX package does) and writes the columns back.  The dense and
pairs modes emit the contact and event temporaries lazily on the last
substep.  Joints (``make_fixed_joint``, ``make_hinge_joint``,
``solver.solve_joints``) run in every mode.  ``contact_mode="auto"`` is
"dense" at 48 body rows or fewer and "pallas" above, on any device.  The
options raise the JAX package's ValueErrors where they do not compose.
``raycast`` runs the renderer's ray functions (render/renderer.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch

from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype, singleton_component
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.state import batched_gather, entity_rows
from gpu_ecs_madrona_tpu_torch.core.taskgraph import NodeID, TaskGraphBuilder
# the module, not its names: it imports this package's submodules, so either
# may be imported first
from gpu_ecs_madrona_tpu_torch.ops import substep_kernel as subk
from gpu_ecs_madrona_tpu_torch.physics import assets  # noqa: F401  (public submodule)
from gpu_ecs_madrona_tpu_torch.physics import narrowphase as npk
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
from gpu_ecs_madrona_tpu_torch.tooling import autotuner
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

# contact_mode="auto": the dense contact mode at this many body rows or
# fewer (the JAX package's threshold)
AUTO_DENSE_MAX_ROWS = 48
# broadphase_mode="auto": dense up to this capacity, sap beyond (the JAX
# package's crossover)
AUTO_DENSE_BP_MAX_ROWS = 192
# The dense contact mode's substep node runs its worlds in equal blocks of
# at most this many grid pairs (W x n x n), which bounds its intermediates:
# ~3.5 KB a grid pair at the step's peak, ~15 GB a block (every block size
# gives the same result)
DENSE_BLOCK_PAIRS = 1 << 22
# The task-graph node of contact_mode="pallas" without joints (one kernel
# launch a step).
FUSED_NODE = "physics_substeps_fused"


def _tables_on(object_manager, device) -> Dict[str, torch.Tensor]:
    """The object manager's per-object arrays the nodes index, on device."""
    out = {}
    for k in ("inv_mass", "inv_inertia", "mu_s", "mu_d", "local_aabb_lo", "local_aabb_hi"):
        out[k] = torch.as_tensor(object_manager[k], dtype=torch.float32, device=device)
    rest = object_manager.get("restitution")
    out["restitution"] = (torch.zeros_like(out["mu_d"]) if rest is None else
                          torch.as_tensor(rest, dtype=torch.float32, device=device))
    return out


def _emit_candidates(ctx: Context, arch: Archetype, counts, rows_i, rows_j):
    """The broadphase's observable output: CandidateTemporary (entity
    handles) and CandidateRowsTemporary (body rows) with ``counts`` per
    world (a count over the capacity goes to the overflow counter), both
    built lazily: only if something reads them before their clear node
    (the substep nodes read the rows)."""
    ents = ctx.entity_column(arch)
    ctx.emit_temporaries(
        CandidateTemporary, counts=counts, width=rows_i.shape[1],
        values=lambda: {CandidateCollision: {"a": batched_gather(ents, rows_i),
                                             "b": batched_gather(ents, rows_j)}})
    ctx.emit_temporaries(CandidateRowsTemporary, counts=counts, width=rows_i.shape[1],
                         values=lambda: {CandidatePairRows: {"i": rows_i, "j": rows_j}})


def _stable_topk_rows(flag, k):
    """Indices of the first k entries of flag [W, M] in descending order,
    lower index first among equals (lax.top_k's order on 0/1 values)."""
    return torch.sort(flag.to(torch.int8), dim=1, descending=True, stable=True).indices[:, :k]


def _sap_node(arch: Archetype, W: int, n: int, k_cap: int, dev, sap_window: int,
              sap_globals: int, sap_degree: int):
    """The sap broadphase's node (the JAX package's find_overlaps_sap,
    physics/__init__.py:419-545) for W worlds of n body rows and a
    candidate capacity k_cap; see setup_broadphase_tasks."""
    S = min(sap_window or 64, n - 1)
    G = min(sap_globals, n)
    Dc = min(sap_degree or S, S)
    k_sap = min(k_cap, n * S + G * n)
    k_take = min(k_sap, n * Dc + G * n)
    BIGI = 2 ** 30
    rows_n = torch.arange(n, dtype=torch.int32, device=dev)
    kk = torch.arange(S, dtype=torch.int32, device=dev)
    # a row's hits before window entry k (the product with it counts
    # them exactly: 0/1 terms, sums below 2^24)
    before = (kk[:, None] < kk[None, :]).to(torch.float32)
    i_iota = rows_n[None, :, None]
    gidx_iota = torch.arange(G * n, dtype=torch.int32, device=dev)[None]
    # the first sorted row past each row's window
    past = torch.clamp(rows_n + S + 1, max=n - 1).long()
    in_range = rows_n + S + 1 <= n - 1

    def find_overlaps_sap(ctx: Context):
        # sweep and prune (the JAX package's find_overlaps_sap): one
        # sort along x, each body against its next S in sorted order;
        # the G widest live bodies (ground planes, large statics, whose
        # x interval would saturate any window) leave the sweep and are
        # tested against all n bodies
        aabb = ctx.column(arch, CollisionAABB)
        mask = ctx.row_mask(arch)
        lo, hi = aabb["lo"], aabb["hi"]
        # the globals: the top-G x extents of the live bodies, the lower
        # row first among equal extents (lax.top_k's order)
        extent = torch.where(mask, hi[..., 0] - lo[..., 0], -math.inf)
        grow = torch.sort(extent, dim=1, descending=True, stable=True).indices[:, :G]
        grow = grow.to(torch.int32)
        is_global = (rows_n[None, None, :] == grow[:, :, None]).any(dim=1)   # [W, n]
        mask_eff = mask & ~is_global

        # the windowed sweep over the other bodies (dead and global
        # rows sort last, in row order: the sort is stable)
        key = torch.where(mask_eff, lo[..., 0], math.inf)
        order = torch.sort(key, dim=1, stable=True).indices.to(torch.int32)
        lo_s, hi_s = batched_gather(lo, order), batched_gather(hi, order)
        mask_s = batched_gather(mask_eff, order)

        # each sorted row i against sorted rows j = i + 1..i + S: windows
        # of the sorted columns (views, no copy), past the last row
        # padded dead
        def window(x, pad):
            return torch.nn.functional.pad(x, (0, S), value=pad).unfold(1, S, 1)[:, 1:]

        ok = mask_s[:, :, None] & window(mask_s, False)
        for c in range(3):
            ok = ok & (lo_s[:, :, c, None] <= window(hi_s[..., c], 0.0)) \
                & (window(lo_s[..., c], 0.0) <= hi_s[:, :, c, None])

        # the globals against every body; a global pair counted once
        # (at the higher row), never a body with itself
        glo, ghi = batched_gather(lo, grow), batched_gather(hi, grow)
        gmask = batched_gather(mask, grow)
        ok_g = m.aabb_overlaps(glo[:, :, None], ghi[:, :, None], lo[:, None], hi[:, None])
        ok_g = ok_g & gmask[:, :, None] & mask[:, None, :]
        ok_g = ok_g & (~is_global[:, None, :] | (rows_n[None, None, :] > grow[:, :, None]))

        # one compaction over both regions, in two stages: each sweep
        # row's first Dc hits in window order kept in Dc slots (the
        # drops counted), then the flat indices sorted (the JAX
        # package's order: ascending flat index, the global rows after
        # the sweep)
        rank = (ok.to(torch.float32).reshape(W * n, S) @ before).reshape(W, n, S)
        keep = ok & (rank < Dc)
        deg = ok.sum(dim=2, dtype=torch.int32)
        dropped = (ok & ~keep).sum(dim=(1, 2), dtype=torch.int32)
        if debug.DEBUG:
            debug.check(dropped == 0, f"sap per-row degree cap {Dc} exceeded: dropped "
                        "pairs={} per world", dropped)
        ctx.add_overflow(CandidateRowsTemporary, dropped)
        # each kept hit to its row's slot of its rank (the others to one
        # spare slot, all BIGI); every slot written once otherwise
        slot = torch.where(keep, i_iota * Dc + rank.to(torch.int32), n * Dc).reshape(W, -1)
        flat1 = torch.full((W, n * Dc + 1), BIGI, dtype=torch.int32, device=dev).scatter_(
            1, slot.long(), torch.where(keep, i_iota * S + kk, BIGI).reshape(W, -1))
        flat1 = flat1[:, :n * Dc]
        flat_g = torch.where(ok_g.reshape(W, G * n), n * S + gidx_iota, BIGI)
        pair_idx = torch.sort(torch.cat([flat1, flat_g], 1), dim=1).values[:, :k_take]
        pair_idx = torch.where(pair_idx < BIGI, pair_idx, 0)
        if k_take < k_sap:         # the stage-1 caps leave fewer than K
            pair_idx = torch.nn.functional.pad(pair_idx, (0, k_sap - k_take))
        counts = (deg.sum(dim=1, dtype=torch.int32) - dropped
                  + ok_g.sum(dim=(1, 2), dtype=torch.int32))
        in_sweep = pair_idx < n * S
        # the sweep region: sorted i = idx // S, j = i + idx % S + 1
        si = torch.where(in_sweep, pair_idx, 0) // S
        sj = torch.clamp(si + pair_idx % S + 1, max=n - 1)
        # the global region: g = idx' // n (its row), b = idx' % n
        gidx = torch.where(in_sweep, 0, pair_idx - n * S)
        ri = torch.where(in_sweep, batched_gather(order, si), batched_gather(grow, gidx // n))
        rj = torch.where(in_sweep, batched_gather(order, sj), gidx % n)
        # (low row, high row): the dense mode's pair order within a pair
        _emit_candidates(ctx, arch, counts, torch.minimum(ri, rj), torch.maximum(ri, rj))

        # the window's saturation: where the first body past a row's
        # window still starts before that row's x interval ends, pairs
        # beyond the window may be missed; counted as overflow
        sat = mask_s & mask_s[:, past] & in_range[None] & (lo_s[..., 0][:, past]
                                                            <= hi_s[..., 0])
        sat_counts = sat.sum(dim=1, dtype=torch.int32)
        if debug.DEBUG:
            debug.check(sat_counts == 0, f"sap broadphase window saturated (window {S}): "
                        "possibly-missed pairs={} per world — raise sap_window",
                        sat_counts)
        ctx.add_overflow(CandidateRowsTemporary, sat_counts)

    return find_overlaps_sap


class RigidBodyPhysicsSystem:
    @staticmethod
    def register_types(registry: ECSRegistry, max_candidates: int = 1024,
                       max_contacts: int = 1024, max_joints: int = 64):
        """reference RigidBodyPhysicsSystem::registerTypes
        (physics.cpp:1055-1081).  max_joints > 0 registers the joint
        archetype, as in the JAX package (so states convert 1:1); the
        substeps then solve its joints."""
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
            "gravity": torch.tensor(gravity, dtype=f32, device=dev).expand(W, 3).contiguous(),
            "restitution_threshold": torch.full((W,), 2.0 * gmag * h, dtype=f32, device=dev),
        })
        ctx.set_singleton(SleepState, {
            "quiet_steps": torch.zeros((W,), dtype=torch.int32, device=dev),
            "asleep": torch.zeros((W,), dtype=torch.int32, device=dev),
        })

    @staticmethod
    def register_persistent_manifolds(registry: ECSRegistry, body_archetype: Archetype,
                                      max_candidates: int):
        """Register the cross-step manifold cache singleton ``ManifoldPersist``
        (setup_substep_tasks' manifold_persist), after the body archetype:
        mc [MC_CHANNELS, K] (the cached rows and body-frame manifold, K =
        the fused kernel's slots for max_candidates), apos [n, 3] and arot
        [n, 4] (the poses the cache was built at), valid (int32).  The JAX
        package's keys and shapes, so its states convert 1:1.  A step
        writes its tensors in place (the worlds whose cache it rebuilt), so
        it is registered ``in_place``: the executor copies it when it takes
        a state in and in save_state."""
        n_cap = registry.archetypes[body_archetype.name].capacity
        comp = singleton_component(
            "ManifoldPersist",
            mc=((subk.MC_CHANNELS, subk.bp_slots(max_candidates)), torch.float32),
            apos=((n_cap, 3), torch.float32), arot=((n_cap, 4), torch.float32),
            valid=((), torch.int32))
        registry.register_singleton(comp, in_place=True)
        return comp

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
    def fused_kernel_inputs(ctx: Context, arch: Archetype, object_manager, rows: bool = True,
                            gather: bool = True):
        """The fused substep kernel's keyword inputs (FusedSubstepKernel's
        call) from the current state: body columns, with ``gather`` the
        per-object constants (inverse mass and inertia zeroed on
        non-dynamic rows; without it the kernel reads them from its object
        table), the solver singleton and, with ``rows``, this step's
        candidate rows (emitted by the broadphase earlier in the step).
        ``object_manager``: the object manager dict, or its tensors from a
        previous call (or None without ``gather``)."""
        dyn = (ctx.column(arch, ResponseType) == RESPONSE_DYNAMIC) & ctx.row_mask(arch)
        phys = ctx.singleton(PhysicsState)
        vel = ctx.column(arch, Velocity)
        kw = dict(
            pos=ctx.column(arch, base.Position), rot=ctx.column(arch, base.Rotation),
            v=vel["linear"], w=vel["angular"], obj=ctx.column(arch, base.ObjectID),
            ext_f=ctx.column(arch, ExternalForce), ext_t=ctx.column(arch, ExternalTorque),
            dyn=dyn, h=phys["h"], gravity=phys["gravity"],
            restitution_threshold=phys["restitution_threshold"])
        if gather:
            objtab = object_manager if isinstance(object_manager.get("inv_mass"), torch.Tensor) \
                else _tables_on(object_manager, ctx.device)
            _, _, _, _, inv_mass, inv_inertia, mu_s, mu_d = \
                RigidBodyPhysicsSystem._body_data(ctx, arch, objtab)
            kw.update(im=torch.where(dyn, inv_mass, 0.0),
                      ii=torch.where(dyn[..., None], inv_inertia, 0.0), mu_s=mu_s, mu_d=mu_d)
        if rows:
            cand = ctx.column(CandidateRowsTemporary, CandidatePairRows)
            kw.update(rows_i=cand["i"], rows_j=cand["j"],
                      kvalid=ctx.row_mask(CandidateRowsTemporary))
        return kw

    @staticmethod
    def substep_kernel_inputs(fused_kw):
        """The single-substep kernel's keyword inputs (SubstepKernel's call)
        for the first substep of a step, from that step's
        fused_kernel_inputs: the integrate its caller runs, the substep
        start, and the unchanged constants and candidate rows."""
        kw = fused_kw
        pos, rot, v, w, prev_pos, prev_rot = solver_mod.integrate(
            kw["pos"], kw["rot"], kw["v"], kw["w"], kw["im"], kw["ii"], kw["ext_f"],
            kw["ext_t"], kw["dyn"], kw["h"], kw["gravity"])
        out = dict(pos=pos, rot=rot, v=v, w=w, prev_pos=prev_pos, prev_rot=prev_rot)
        for k in ("im", "ii", "mu_s", "mu_d", "obj", "dyn", "rows_i", "rows_j", "kvalid", "h",
                  "restitution_threshold"):
            out[k] = kw[k]
        return {k: x.contiguous() for k, x in out.items()}

    @staticmethod
    def next_step_kernel_inputs(sim, arch: Archetype, object_manager, flags: bool = False,
                                node: bool = False):
        """The fused kernel's inputs for the next step of executor ``sim``:
        the step's nodes before its first substep node run on a Context
        over a copy of ``sim.state``, which stays as it was; then the fused
        node's own inputs (its options' too: the broadphase's, the sleep
        flags, the persistent cache and its stable flags, computed by
        world_flags; the per-object constants gathered), or for the
        per-substep nodes fused_kernel_inputs.  With ``flags``, the fused
        node's world_flags arguments instead; with ``node``, the kernel-mode
        substep node's own inputs (SubstepKernel.step's keywords)."""
        ctx = Context(sim.mgr, sim.state)
        for nd in sim.graph.nodes:
            if nd.name == FUSED_NODE:
                return nd.run.flag_inputs(ctx) if flags else nd.run.kernel_inputs(ctx)
            if nd.name == "physics_substep_0" and not flags:
                if node:
                    return nd.run.node_inputs(ctx)
                return RigidBodyPhysicsSystem.fused_kernel_inputs(ctx, arch, object_manager)
            nd.run(ctx)
        raise ValueError(f"the executor's graph has no {FUSED_NODE!r} or "
                         "'physics_substep_0' node")

    @staticmethod
    def substep_kernel(sim) -> subk.SubstepKernel:
        """The SubstepKernel of executor ``sim``'s kernel-mode substep nodes
        (a world with joints)."""
        for node in sim.graph.nodes:
            if node.name == "physics_substep_0" and hasattr(node.run, "kernel"):
                return node.run.kernel
        raise ValueError("the executor's graph has no kernel-mode 'physics_substep_0' node")

    @staticmethod
    def fused_kernel(sim) -> subk.FusedSubstepKernel:
        """The FusedSubstepKernel of executor ``sim``'s fused substep node
        (its options as the graph was built)."""
        for node in sim.graph.nodes:
            if node.name == FUSED_NODE:
                return node.run.kernel
        raise ValueError(f"the executor's graph has no {FUSED_NODE!r} node")

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
        mode "fused": the same rank compaction with D = dense_degree or 12,
        inside the fused substep kernel (at most 128 body rows;
        contact_mode "pallas" without joints): this registers a marker
        node, and the substep node writes the CollisionAABB and LeafID
        columns and the candidate temporaries.
        mode "sap": sweep and prune (``_sap_node``): the
        sap_globals widest live bodies along x are tested against every
        body; the others, sorted by their AABB's lower x, each against the
        next S = min(sap_window or 64, n - 1) in that order, each sorted
        row keeping at most sap_degree partners.  The rows dropped by that
        cap, and the window's saturation (a body past the window whose x
        interval may still overlap), go to CandidateRowsTemporary's
        overflow counter.
        mode "auto" is dense up to 192 body rows, sap above."""
        arch = body_archetype
        cap_n = builder.mgr.registry.archetypes[arch.name].capacity
        if mode == "auto":
            mode = "dense" if cap_n <= AUTO_DENSE_BP_MAX_ROWS else "sap"
        if mode not in ("dense", "sap", "fused"):
            raise ValueError(f"unknown broadphase mode {mode!r}")
        if mode == "fused":
            if cap_n > subk.MAX_BP_ROWS:
                raise ValueError(f"fused broadphase requires body capacity <= "
                                 f"{subk.MAX_BP_ROWS} (got {cap_n})")
            builder.fused_broadphase = {"degree": dense_degree or 12,
                                        "vexp": float(velocity_expansion)}

            def bp_fused_marker(ctx: Context):
                pass

            return builder.add_node(bp_fused_marker, deps, name="bp_fused_marker")
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
                _emit_candidates(ctx, arch, counts, pair_idx // n, pair_idx % n)
                return
            D = min(dense_degree, n)
            # owner = the higher row j, its partners the lower rows i < j
            partners, deg = first_partners(ok.transpose(1, 2), D)
            ab, _, excess = rank_slots(partners, deg, D, k_eff)
            debug.check(excess == 0, f"dense rank-compaction degree cap {D} exceeded: "
                        "dropped pairs={} per world", excess)
            ctx.add_overflow(CandidateRowsTemporary, excess)
            _emit_candidates(ctx, arch, counts - excess, ab[..., 1].contiguous(),
                             ab[..., 0].contiguous())

        node = (_sap_node(arch, W, n, k_cap, dev, sap_window, sap_globals, sap_degree)
                if mode == "sap" else find_overlaps)
        return builder.add_node(node, [n_aabb], name="bp_find_overlaps")

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
                    the card) per step; with a joint archetype, the
                    single-substep kernel, one node and one launch per
                    substep: the integrate, the solve and the joint solve
                    (after the substep's velocity pass, where "pairs"
                    solves them between the positional and velocity
                    phases, as in the JAX package); no contact
                    temporaries.
          "dense":  one node per substep over the whole [W, n, n] grid of
                    body pairs (physics/narrowphase.py), gated by the
                    AABB grid; solver.solve_positions, the joints,
                    set_velocities, solver.solve_velocities.  The last
                    substep emits the contact and collision-event
                    temporaries (all n x n pairs in grid order, lazily).
                    The worlds run in blocks of at most
                    DENSE_BLOCK_PAIRS grid pairs (the node's
                    ``world_block``).
          "auto":   the exec-config artifact's mode for this workload
                    (tooling/autotuner.py, GEM_TPU_EXEC_CONFIG_FILE; only
                    entries measured on this device's backend), else
                    "dense" at 48 body rows or fewer, "pallas" above, on
                    any device (the JAX package's thresholds).
        speculative_margin > 0: speculative-contact CCD (near-miss
        contacts clamp approach speed to depth/h in the velocity pass).

        The fused kernel's options (contact_mode "pallas" without joints;
        "pairs" ignores contact_refresh and manifold_persist, as the JAX
        package does):
          contact_refresh: SAT and clip on the first substep only, the
                    manifold moved with the bodies on the others.
          sleep_threshold > 0: a world whose dynamic bodies stay below it
                    (|v|^2 + |w|^2 < thr^2) with no external force or
                    torque for sleep_frames steps is asleep (SleepState)
                    and frozen bit for bit until woken.
          manifold_persist (with broadphase "fused", contact_refresh and
                    register_persistent_manifolds): a world whose bodies'
                    surfaces moved less than persist_margin / 2 since its
                    cache was built, and cannot within this step, keeps
                    its candidates and manifolds (ManifoldPersist) and
                    skips the broadphase and SAT; the others rebuild with
                    AABBs inflated by persist_margin / 2.
        The JAX package's ValueErrors where the options do not compose.
        substep_wt (the TPU kernel's world block) must stay None."""
        arch = body_archetype
        cap_n = builder.mgr.registry.archetypes[arch.name].capacity
        if contact_mode == "auto":
            # the exec-config artifact first (tooling/autotuner.py, keyed by
            # this device's backend), then the fixed rule
            tuned = autotuner.lookup("physics_substep", backend_name=builder.mgr.device.type,
                                     num_worlds=builder.mgr.num_worlds, bodies=cap_n)
            if tuned and tuned.get("contact_mode") in ("dense", "pairs", "pallas"):
                contact_mode = tuned["contact_mode"]
                if substep_wt is None and tuned.get("substep_wt", 1) != 1:
                    substep_wt = tuned["substep_wt"]     # refused below
            else:
                contact_mode = "pallas" if cap_n > AUTO_DENSE_MAX_ROWS else "dense"
        if contact_mode not in ("dense", "pairs", "pallas"):
            raise ValueError(f"unknown contact_mode {contact_mode!r}")
        jinfo = builder.mgr.registry.archetypes.get(JointArchetype.name)
        has_joints = jinfo is not None and jinfo.capacity > 0
        if substep_wt is not None:
            raise ValueError("substep_wt is the TPU kernel's world-block size; "
                             "it has no meaning here")
        fused_bp = getattr(builder, "fused_broadphase", None)
        fused = contact_mode == "pallas" and not has_joints
        if contact_mode == "pallas" and has_joints and contact_refresh:
            raise ValueError(
                "contact_refresh requires the fused substep kernel; worlds with joints run "
                "the per-substep kernel (joints interleave between the positional and "
                "velocity phases) — drop contact_refresh or joints")
        if fused and manifold_persist:
            if fused_bp is None or not contact_refresh:
                raise ValueError(
                    "manifold_persist requires broadphase mode 'fused' and "
                    "contact_refresh=True (the cache lives in the fused kernel and extends "
                    "the refresh across steps)")
            if "ManifoldPersist" not in builder.mgr.registry.singletons:
                raise ValueError("manifold_persist: call register_persistent_manifolds "
                                 "from the world's register_types")
        if sleep_threshold > 0.0 and not fused:
            raise ValueError("sleep_threshold requires the fused substep kernel "
                             "(contact_mode='pallas', no joints)")
        if fused_bp is not None:
            if not fused:
                raise ValueError(
                    "broadphase mode 'fused' requires contact_mode='pallas' without joints "
                    f"(the broadphase lives inside the fused kernel; got {contact_mode!r}, "
                    f"joints={has_joints})")
            if sleep_threshold > 0.0 and not manifold_persist:
                raise ValueError(
                    "broadphase mode 'fused' composes with sleep_threshold only through "
                    "manifold_persist (the sleep passthrough echoes the persistent "
                    "cache's AABB/pair surface)")
        dev = builder.mgr.device
        objtab = _tables_on(object_manager, dev)
        W = builder.mgr.num_worlds

        def body_inputs(ctx: Context):
            pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d = \
                RigidBodyPhysicsSystem._body_data(ctx, arch, objtab)
            resp = ctx.column(arch, ResponseType)
            dyn = (resp == RESPONSE_DYNAMIC) & mask
            return pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d, dyn

        def solve_joints_at(ctx: Context, p2, r2, dyn, inv_mass, inv_inertia):
            """The joint solve (reference solvePositions' joint query,
            physics.cpp:538-650) at pose (p2, r2); identity without joints."""
            if not has_joints:
                return p2, r2
            jfields = ctx.column(JointArchetype, JointConstraint)
            arch_idx = ctx.mgr.arch_index[arch.name]
            return solver_mod.solve_joints(
                p2, r2, torch.where(dyn, inv_mass, 0.0),
                torch.where(dyn[..., None], inv_inertia, 0.0), jfields,
                entity_rows(ctx.state["eid"], jfields["e1"], arch_idx),
                entity_rows(ctx.state["eid"], jfields["e2"], arch_idx),
                ctx.row_mask(JointArchetype), relaxation=relaxation)

        def integrate_and_stash(ctx: Context, body):
            """The substep's integrate, and the pre-solve stashes (reference
            PreSolvePositional/Velocity)."""
            pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d, dyn = body
            phys = ctx.singleton(PhysicsState)
            vel = ctx.column(arch, Velocity)
            new_pos, new_rot, v, w, prev_pos, prev_rot = solver_mod.integrate(
                pos, rot, vel["linear"], vel["angular"], inv_mass, inv_inertia,
                ctx.column(arch, ExternalForce), ctx.column(arch, ExternalTorque),
                dyn, phys["h"], phys["gravity"])
            ctx.set_column(arch, SubstepPrevState, {"prev_pos": prev_pos, "prev_rot": prev_rot})
            ctx.set_column(arch, PreSolvePositional, {"x": new_pos, "q": new_rot})
            ctx.set_column(arch, PreSolveVelocity, {"v": v, "omega": w})
            return new_pos, new_rot, v, w, prev_pos, prev_rot

        def writeback(ctx: Context, body, p2, r2, v3, w3):
            """Dynamic rows take the solve; the others keep pose and velocity."""
            pos, rot, dyn = body[0], body[1], body[8]
            vel = ctx.column(arch, Velocity)
            keep = dyn[..., None]
            ctx.set_column(arch, base.Position, torch.where(keep, p2, pos))
            ctx.set_column(arch, base.Rotation, torch.where(keep, r2, rot))
            ctx.set_column(arch, Velocity, {
                "linear": torch.where(keep, v3, vel["linear"]),
                "angular": torch.where(keep, w3, vel["angular"])})

        if contact_mode == "pallas" and has_joints:
            substep_kernel = subk.SubstepKernel(object_manager, relaxation=relaxation,
                                                speculative=speculative_margin)
            arch_idx = builder.mgr.arch_index[arch.name]

            def node_inputs(ctx: Context):
                """The node's launch inputs (SubstepKernel.step's keywords):
                the state's columns as they are, no device op."""
                phys = ctx.singleton(PhysicsState)
                vel = ctx.column(arch, Velocity)
                rowsc = ctx.column(CandidateRowsTemporary, CandidatePairRows)
                return dict(
                    pos=ctx.column(arch, base.Position), rot=ctx.column(arch, base.Rotation),
                    v=vel["linear"], w=vel["angular"], obj=ctx.column(arch, base.ObjectID),
                    resp=ctx.column(arch, ResponseType), mask=ctx.row_mask(arch),
                    ext_f=ctx.column(arch, ExternalForce), ext_t=ctx.column(arch, ExternalTorque),
                    h=phys["h"], gravity=phys["gravity"],
                    restitution_threshold=phys["restitution_threshold"], rows_i=rowsc["i"],
                    rows_j=rowsc["j"], kvalid=ctx.row_mask(CandidateRowsTemporary),
                    joints=ctx.column(JointArchetype, JointConstraint),
                    jmask=ctx.row_mask(JointArchetype), eid=ctx.state["eid"],
                    arch_index=arch_idx)

            def make_kernel_substep(idx):
                def substep(ctx: Context):
                    # the integrate, the solve, the joints and the writeback
                    # in one launch of kernel 5 (its plain version on the CPU)
                    out = substep_kernel.step(**node_inputs(ctx))
                    ctx.set_column(arch, SubstepPrevState,
                                   {"prev_pos": out["prev_pos"], "prev_rot": out["prev_rot"]})
                    ctx.set_column(arch, PreSolvePositional,
                                   {"x": out["ps_pos"], "q": out["ps_rot"]})
                    ctx.set_column(arch, PreSolveVelocity, {"v": out["ps_v"], "omega": out["ps_w"]})
                    ctx.set_column(arch, base.Position, out["pos"])
                    ctx.set_column(arch, base.Rotation, out["rot"])
                    ctx.set_column(arch, Velocity, {"linear": out["v"], "angular": out["w"]})

                substep.__name__ = f"physics_substep_{idx}"
                substep.node_inputs = node_inputs
                substep.kernel = substep_kernel
                return substep

            last = list(deps)
            for i in range(num_substeps):
                last = [builder.add_node(make_kernel_substep(i), last)]
            return last[0]

        if contact_mode == "pallas":
            cand_cap = builder.mgr.registry.archetypes[CandidateRowsTemporary.name].capacity
            fused_kernel = subk.FusedSubstepKernel(
                object_manager, num_substeps=num_substeps, relaxation=relaxation,
                speculative=speculative_margin, contact_refresh=contact_refresh,
                bp_degree=fused_bp["degree"] if fused_bp else 0,
                bp_capacity=cand_cap if fused_bp else 0,
                persist_margin=persist_margin if manifold_persist else 0.0)
            mpcomp = (builder.mgr.registry.singletons["ManifoldPersist"] if manifold_persist
                      else None)
            leaf = torch.arange(cap_n, dtype=torch.int32, device=dev).expand(W, cap_n)

            def flag_inputs(ctx: Context, dyn=None):
                """world_flags' arguments from the step's state (the sleep
                classifier's and the stability predicate's); ``dyn``, the
                dynamic rows, if the caller has them."""
                vel = ctx.column(arch, Velocity)
                phys = ctx.singleton(PhysicsState)
                if dyn is None:
                    dyn = (ctx.column(arch, ResponseType) == RESPONSE_DYNAMIC) & ctx.row_mask(arch)
                fkw = dict(pos=ctx.column(arch, base.Position),
                           rot=ctx.column(arch, base.Rotation), v=vel["linear"],
                           w=vel["angular"], ext_f=ctx.column(arch, ExternalForce),
                           ext_t=ctx.column(arch, ExternalTorque), dyn=dyn,
                           obj=ctx.column(arch, base.ObjectID),
                           scale=ctx.column(arch, base.Scale), delta_t=phys["delta_t"],
                           tables=fused_kernel.tables)
                if sleep_threshold > 0.0:
                    fkw.update(quiet_steps=ctx.singleton(SleepState)["quiet_steps"],
                               sleep_threshold=sleep_threshold, sleep_frames=sleep_frames)
                if manifold_persist:
                    mp = ctx.singleton(mpcomp)
                    fkw.update(apos=mp["apos"].contiguous(), arot=mp["arot"].contiguous(),
                               valid=mp["valid"].contiguous(), persist_margin=persist_margin)
                return fkw

            def kernel_inputs(ctx: Context, gather: bool = True):
                """The kernel's inputs from the step's state, its options'
                too (the world flags by world_flags, one launch on the
                card); updates SleepState under sleep.  Without ``gather``
                the kernel reads the per-object constants from its table."""
                kw = RigidBodyPhysicsSystem.fused_kernel_inputs(
                    ctx, arch, objtab, rows=fused_bp is None, gather=gather)
                phys = ctx.singleton(PhysicsState)
                if fused_bp is not None:
                    kw.update(scale=ctx.column(arch, base.Scale), live=ctx.row_mask(arch),
                              dtv=phys["delta_t"] * fused_bp["vexp"])
                if sleep_threshold > 0.0 or manifold_persist:
                    flags = subk.world_flags(**flag_inputs(ctx, kw["dyn"]))
                    if sleep_threshold > 0.0:
                        ctx.set_singleton(SleepState, {"quiet_steps": flags["quiet_steps"],
                                                       "asleep": flags["asleep"]})
                        kw["active"] = flags["active"]
                    if manifold_persist:
                        aabb = ctx.column(arch, CollisionAABB)
                        kw.update(mcache=ctx.singleton(mpcomp)["mc"].contiguous(),
                                  aabb_lo=aabb["lo"], aabb_hi=aabb["hi"],
                                  stable=flags["stable"])
                return kw

            def substeps_fused(ctx: Context):
                kw = kernel_inputs(ctx, gather=False)
                if manifold_persist:
                    # the cache and the anchors are updated in place by the
                    # launch, where a world rebuilt its cache (unstable and
                    # awake): the cache and its rows, the step's starting
                    # pose, and valid unless the rebuild dropped pairs
                    mp = ctx.singleton(mpcomp)
                    anchors = (mp["apos"].contiguous(), mp["arot"].contiguous(),
                               mp["valid"].contiguous())
                    out = fused_kernel(**kw, mcache_out=kw["mcache"], anchors=anchors,
                                       keep_velocity=True)
                    ctx.set_singleton(mpcomp, {"mc": kw["mcache"], "apos": anchors[0],
                                               "arot": anchors[1], "valid": anchors[2]})
                else:
                    out = fused_kernel(**kw, keep_velocity=True)
                if fused_bp is not None:
                    # the broadphase's observable surface, from the kernel's outputs
                    ctx.set_column(arch, CollisionAABB, {"lo": out["aabb_lo"],
                                                         "hi": out["aabb_hi"]})
                    ctx.set_column(arch, LeafID, leaf)
                    if debug.DEBUG:
                        debug.check(out["bp_dropped"] == 0,
                                    f"fused broadphase degree cap {fused_bp['degree']} "
                                    "exceeded: dropped pairs={} per world — raise dense_degree",
                                    out["bp_dropped"])
                    ctx.add_overflow(CandidateRowsTemporary, out["bp_dropped"])
                    # the kernel's slots are whole 128-slot tiles: the capacity's
                    # first ones go out (a count above it is overflow)
                    _emit_candidates(ctx, arch, out["bp_count"],
                                     out["rows_i"][:, :cand_cap].contiguous(),
                                     out["rows_j"][:, :cand_cap].contiguous())
                # non-dynamic rows keep their velocities (keep_velocity)
                ctx.set_column(arch, base.Position, out["pos"])
                ctx.set_column(arch, base.Rotation, out["rot"])
                ctx.set_column(arch, Velocity, {"linear": out["v"], "angular": out["w"]})
                ctx.set_column(arch, SubstepPrevState,
                               {"prev_pos": out["prev_pos"], "prev_rot": out["prev_rot"]})
                ctx.set_column(arch, PreSolvePositional, {"x": out["ps_pos"], "q": out["ps_rot"]})
                ctx.set_column(arch, PreSolveVelocity, {"v": out["ps_v"], "omega": out["ps_w"]})

            substeps_fused.kernel_inputs = kernel_inputs
            substeps_fused.flag_inputs = flag_inputs
            substeps_fused.kernel = fused_kernel
            return builder.add_node(substeps_fused, list(deps), name=FUSED_NODE)

        if contact_mode == "dense":
            # the JAX package's dense branch: narrowphase at the integrated
            # poses over the [W, n, n] grid, gated by the AABB grid; the
            # positional solve; the joints; velocity recovery; the velocity
            # solve.  Worlds run in blocks of ``world_block`` (every world's
            # arithmetic is its own, so any block size gives the same result)
            np_tables = npk.tables_of(object_manager)
            n = cap_n
            block = -(-W // -(-W * n * n // DENSE_BLOCK_PAIRS))
            k_eff = min(builder.mgr.registry.archetypes[ContactTemporary.name].capacity, n * n)

            def cat(xs):
                return xs[0] if len(xs) == 1 else torch.cat(xs)

            def make_dense_substep(idx):
                def substep(ctx: Context):
                    phys = ctx.singleton(PhysicsState)
                    h, rthr = phys["h"], phys["restitution_threshold"]
                    body = body_inputs(ctx)
                    pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d, dyn = body
                    new_pos, new_rot, v, w, prev_pos, prev_rot = integrate_and_stash(ctx, body)
                    aabb = ctx.column(arch, CollisionAABB)
                    rest = objtab["restitution"][obj.long()]
                    blocks = [slice(w0, w0 + block) for w0 in range(0, W, block)]
                    solved = []
                    for sl in blocks:
                        lo, hi = aabb["lo"][sl], aabb["hi"][sl]
                        cand = m.aabb_overlaps(lo[:, :, None], hi[:, :, None],
                                               lo[:, None], hi[:, None])
                        contacts = npk.narrowphase_dense(new_pos[sl], new_rot[sl], obj[sl],
                                                         mask[sl], np_tables,
                                                         speculative=speculative_margin)
                        contacts["ok"] = contacts["ok"] & cand
                        solved.append((contacts,) + solver_mod.solve_positions(
                            new_pos[sl], new_rot[sl], contacts, inv_mass[sl], inv_inertia[sl],
                            mu_s[sl], prev_pos[sl], prev_rot[sl], dyn[sl], relaxation=relaxation))
                    p2, r2 = solve_joints_at(ctx, cat([b[1] for b in solved]),
                                             cat([b[2] for b in solved]), dyn, inv_mass,
                                             inv_inertia)
                    v2, w2 = solver_mod.set_velocities(p2, r2, prev_pos, prev_rot, h,
                                                       cat([b[4] for b in solved]))
                    vel = [solver_mod.solve_velocities(
                        p2[sl], r2[sl], v2[sl], w2[sl], contacts, lam, inv_mass[sl],
                        inv_inertia[sl], mu_d[sl], v[sl], w[sl], dyn[sl], h[sl], rthr[sl],
                        rest_coef=rest[sl], speculative=speculative_margin)
                        for sl, (contacts, _, _, lam, _) in zip(blocks, solved)]
                    writeback(ctx, body, p2, r2, cat([x[0] for x in vel]),
                              cat([x[1] for x in vel]))
                    if idx == num_substeps - 1:
                        emit_dense_contacts(ctx, [(b[0], b[3]) for b in solved])

                substep.__name__ = f"physics_substep_{idx}"
                substep.world_block = block
                return substep

            def emit_dense_contacts(ctx: Context, solved):
                """The last substep's contact and collision-event
                temporaries: the grid's pairs flattened (i * n + j), the
                contacts first in that order (lax.top_k's order on the ok
                flags), values built lazily; the counts now, for the
                overflow counters."""
                okk = cat([c["ok"].reshape(-1, n * n) for c, _ in solved])
                counts = okk.sum(dim=1, dtype=torch.int32)
                ents = ctx.entity_column(arch)
                memo = {}

                def selected():
                    if "v" not in memo:
                        pidx = _stable_topk_rows(okk, k_eff)

                        def g(key, width=()):
                            x = cat([c[key].reshape((-1, n * n) + width) for c, _ in solved])
                            return batched_gather(x, pidx)

                        a_ent = batched_gather(ents, pidx // n)
                        b_ent = batched_gather(ents, pidx % n)
                        lam = cat([lm.reshape(-1, n * n, 4) for _, lm in solved])
                        memo["v"] = (a_ent, b_ent, {
                            "ref": a_ent, "alt": b_ent,
                            "points": torch.cat([g("points", (4, 3)),
                                                 g("depth", (4,))[..., None]], -1),
                            "num_points": g("num_points"), "normal": g("normal", (3,)),
                            "lambda_n": batched_gather(lam, pidx)})
                    return memo["v"]

                ctx.emit_temporaries(CollisionEventTemporary, counts=counts, width=k_eff,
                                     values=lambda: {CollisionEvent: {"a": selected()[0],
                                                                      "b": selected()[1]}})
                ctx.emit_temporaries(ContactTemporary, counts=counts, width=k_eff,
                                     values=lambda: {ContactConstraint: selected()[2]})

            last = list(deps)
            for i in range(num_substeps):
                last = [builder.add_node(make_dense_substep(i), last)]
            return last[0]

        tables = pk.ObjTables(object_manager)

        def make_substep(idx):
            def substep(ctx: Context):
                phys = ctx.singleton(PhysicsState)
                h = phys["h"]
                body = body_inputs(ctx)
                pos, rot, obj, mask, inv_mass, inv_inertia, mu_s, mu_d, dyn = body
                new_pos, new_rot, v, w, prev_pos, prev_rot = integrate_and_stash(ctx, body)
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
                p2, r2 = solve_joints_at(ctx, p2, r2, dyn, inv_mass, inv_inertia)
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
                writeback(ctx, body, p2, r2, v2 + accv[..., 0:3], w2 + accv[..., 3:6])

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


def make_fixed_joint(ctx: Context, e1, e2, attach_rot1, attach_rot2, r1, r2, separation,
                     counts=1, max_new=1):
    """Create Fixed joints (reference JointConstraint::setupFixed,
    physics.hpp:228-233).  e1/e2: entity handles [W, K]."""
    W, K = e1.shape
    zeros3 = torch.zeros((W, K, 3), device=ctx.device)
    return ctx.make_entities(JointArchetype, counts=counts, max_new=max_new, values={
        JointConstraint: {
            "e1": e1, "e2": e2,
            "joint_type": torch.zeros((W, K), dtype=torch.int32, device=ctx.device),
            "attach_rot1": attach_rot1, "attach_rot2": attach_rot2, "separation": separation,
            "a1_local": zeros3, "a2_local": zeros3, "b1_local": zeros3, "b2_local": zeros3,
            "r1": r1, "r2": r2}})


def make_hinge_joint(ctx: Context, e1, e2, a1_local, a2_local, b1_local, b2_local, r1, r2,
                     counts=1, max_new=1):
    """Create Hinge joints (reference JointConstraint::setupHinge,
    physics.hpp:235-243)."""
    W, K = e1.shape
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=ctx.device).expand(W, K, 4)
    return ctx.make_entities(JointArchetype, counts=counts, max_new=max_new, values={
        JointConstraint: {
            "e1": e1, "e2": e2,
            "joint_type": torch.ones((W, K), dtype=torch.int32, device=ctx.device),
            "attach_rot1": ident, "attach_rot2": ident,
            "separation": torch.zeros((W, K), device=ctx.device),
            "a1_local": a1_local, "a2_local": a2_local, "b1_local": b1_local,
            "b2_local": b2_local, "r1": r1, "r2": r2}})


def raycast(pos, rot, scale, obj_id, row_mask, object_manager, origins, directions,
            t_max=1e9):
    """Batched ray cast against all bodies (reference broadphase::BVH::
    traceRay, physics.hpp:316-320): the renderer's analytic sphere, exact
    convex-hull and plane intersections over the dense body list, no tree.

    pos/rot/scale/obj_id/row_mask: body columns [W, n, ...];
    origins/directions: [W, R, 3].  Returns (hit_row [W, R] int32, -1 at a
    miss; hit_t [W, R] float32, inf at a miss); the first row in order
    wins a tie of t."""
    from gpu_ecs_madrona_tpu_torch.physics.assets import PRIM_HULL, PRIM_SPHERE
    from gpu_ecs_madrona_tpu_torch.render.renderer import BatchRenderer

    dev = pos.device
    om = {k: torch.as_tensor(object_manager[k], device=dev)
          for k in ("prim_type", "sphere_radius", "face_normals", "face_d", "num_faces")}
    obj = obj_id.long()
    ptype = om["prim_type"][obj]                                    # [W, n]
    radius = om["sphere_radius"][obj] * scale[..., 0]
    ro, rd = origins[:, :, None, :], directions[:, :, None, :]      # [W, R, 1, 3]
    c, q = pos[:, None], rot[:, None]                               # [W, 1, n, *]
    ts = BatchRenderer._ray_sphere_t(ro, rd, c, radius[:, None])
    face_d = om["face_d"][obj]                                      # [W, n, F]
    fmask = torch.arange(face_d.shape[-1], device=dev) < om["num_faces"][obj][..., None]
    tb = BatchRenderer._ray_convex_t(ro, rd, c, q, scale[:, None],
                                     om["face_normals"][obj][:, None], face_d[:, None],
                                     fmask[:, None])
    tp = BatchRenderer._ray_plane_t(ro, rd, c, q)
    pt = ptype[:, None]
    t = torch.where(pt == PRIM_SPHERE, ts, torch.where(pt == PRIM_HULL, tb, tp))
    t = torch.where(row_mask[:, None] & (t <= t_max), t, 1e9)
    best, row = t.min(dim=-1)
    miss = best >= 1e9 * 0.5
    return (torch.where(miss, -1, row.to(torch.int32)),
            torch.where(miss, math.inf, best))
