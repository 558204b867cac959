"""RenderingSystem — instance and camera data for batch rendering (PyTorch).

Counterpart of ``gpu_ecs_madrona_tpu/render/interop.py`` (reference
src/mw/render/interop.cpp + include/madrona/mw_render.hpp): the packed
per-world buffers in ``ctx.data["render"]`` are updated by an ordinary
taskgraph node and read by the batch renderer (render/renderer.py).  An
instance's slot is its row index (dense masked layout).  The keys, shapes
and dtypes are the JAX package's, so a JAX state converts 1:1.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from gpu_ecs_madrona_tpu_torch.core import base
from gpu_ecs_madrona_tpu_torch.core.component import Archetype, component
from gpu_ecs_madrona_tpu_torch.core.context import Context
from gpu_ecs_madrona_tpu_torch.core.registry import ECSRegistry
from gpu_ecs_madrona_tpu_torch.core.taskgraph import NodeID, TaskGraphBuilder

f32, i32 = torch.float32, torch.int32

# ActiveView (mw_render.hpp:16-24): per-agent camera parameters.
ActiveView = component(
    "ActiveView",
    view_idx=((), i32),
    tan_fov=((), f32),
    eye_offset=((3,), f32),
)

# Packed outputs (reference InstanceData / ViewData buffers)
RenderInstances = component(
    "RenderInstances",
    txfm_pos=((3,), f32),
    txfm_rot=((4,), f32),
    txfm_scale=((3,), f32),
    obj_id=((), i32),
)
RenderViews = component(
    "RenderViews",
    eye=((3,), f32),
    rot=((4,), f32),
    tan_fov=((), f32),
)


def _identity_rot(shape, device):
    rot = torch.zeros(shape + (4,), dtype=f32, device=device)
    rot[..., 0] = 1.0
    return rot


class RenderingSystem:
    """reference render::RenderingSystem (mw_render.hpp:27-40)."""

    @staticmethod
    def register_types(registry: ECSRegistry):
        registry.register_component(ActiveView)

    @staticmethod
    def init(ctx: Context, renderable_archetypes: Sequence[Archetype] = (),
             view_archetype: Optional[Archetype] = None, max_views: int = 1):
        """reference RenderingSystem::init (interop.cpp:183-211): the packed
        render buffers, created up front so the state keeps its keys."""
        W, dev = ctx.num_worlds, ctx.device
        render = {}
        for arch in renderable_archetypes:
            cap = ctx.mgr.registry.archetypes[arch.name].capacity
            render[arch.name] = {
                "pos": torch.zeros((W, cap, 3), dtype=f32, device=dev),
                "rot": _identity_rot((W, cap), dev),
                "scale": torch.ones((W, cap, 3), dtype=f32, device=dev),
                "obj_id": torch.zeros((W, cap), dtype=i32, device=dev),
                "mask": torch.zeros((W, cap), dtype=torch.bool, device=dev),
            }
        if view_archetype is not None:
            cap = ctx.mgr.registry.archetypes[view_archetype.name].capacity
            render["__views__"] = {
                "eye": torch.zeros((W, cap, 3), dtype=f32, device=dev),
                "rot": _identity_rot((W, cap), dev),
                "tan_fov": torch.ones((W, cap), dtype=f32, device=dev),
                "mask": torch.zeros((W, cap), dtype=torch.bool, device=dev),
            }
        user = dict(ctx.data)
        user["render"] = render
        ctx.data = user

    @staticmethod
    def setup_view(ctx: Context, fov_degrees: float, view_idx=0, eye_offset=(0.0, 0.0, 0.0)):
        """reference RenderingSystem::setupView (mw_render.hpp:35-37): an
        ActiveView value dict for make_entities."""
        W, dev = ctx.num_worlds, ctx.device
        tan_fov = math.tan(math.radians(fov_degrees) / 2.0)
        return {
            "view_idx": torch.full((W, 1), int(view_idx), dtype=i32, device=dev),
            "tan_fov": torch.full((W, 1), tan_fov, dtype=f32, device=dev),
            "eye_offset": torch.as_tensor(eye_offset, dtype=f32, device=dev).expand(W, 1, 3),
        }

    @staticmethod
    def setup_tasks(builder: TaskGraphBuilder, deps: Sequence[NodeID],
                    renderable_archetypes: Sequence[Archetype],
                    view_archetype: Optional[Archetype] = None) -> NodeID:
        """Pack instance transforms and views into ``ctx.data["render"]``
        (reference setupTasks, interop.cpp:114-139), one entry per
        renderable archetype, and "__views__"."""

        def pack(ctx: Context):
            render = {}
            for arch in renderable_archetypes:
                pos = ctx.column(arch, base.Position)
                scale = (ctx.column(arch, base.Scale) if arch.has(base.Scale)
                         else torch.ones_like(pos))
                render[arch.name] = {
                    "pos": pos, "rot": ctx.column(arch, base.Rotation), "scale": scale,
                    "obj_id": ctx.column(arch, base.ObjectID), "mask": ctx.row_mask(arch),
                }
            if view_archetype is not None:
                vpos = ctx.column(view_archetype, base.Position)
                av = ctx.column(view_archetype, ActiveView)
                vmask = ctx.row_mask(view_archetype)
                # route each live view row into its view_idx slot (reference
                # updateViewData writes viewData[view_idx], interop.cpp:62-93)
                # as a masked sum over rows: no matmul, so no TF32 rounding
                # can reach camera eyes or rotations
                cap = vpos.shape[1]
                slots = torch.arange(cap, dtype=i32, device=vpos.device)
                sel = (av["view_idx"][:, :, None] == slots) & vmask[:, :, None]   # [W, r, s]

                def packv(x):
                    xs = x[:, :, None] if x.dim() == 2 else x[:, :, None, :]
                    s = sel if x.dim() == 2 else sel[..., None]
                    return torch.where(s, xs, 0.0).sum(dim=1)

                render["__views__"] = {
                    "eye": packv(vpos + av["eye_offset"]),
                    "rot": packv(ctx.column(view_archetype, base.Rotation)),
                    "tan_fov": packv(av["tan_fov"]),
                    "mask": sel.any(dim=1),
                }
            user = dict(ctx.data)
            user["render"] = render
            ctx.data = user

        return builder.add_node(pack, deps, name="render_pack")

    @staticmethod
    def reset(ctx: Context):
        """reference RenderingSystem::reset (interop.cpp)."""
