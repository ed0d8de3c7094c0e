"""Pipeline parallelism — the GPipe microbatch schedule over the ``pipe``
group (port of ``parallel/pipeline.py``).

Every stage runs the same program; a rank's stage is its coordinate on
``pipe``, activations advance one stage a tick by point-to-point sends
(``parallel/comm.py::ppermute``, whose backward sends the gradients the
other way), and autograd differentiates straight through the schedule.

Semantics: ``pipeline_apply(stage_fn, stacked_params, x)`` computes

    stage_{P-1}( ... stage_1(stage_0(x)) ... )

for P pipeline stages whose activations share one shape.  The batch is
split into M microbatches and the schedule takes the reference's
``M + P - 1`` ticks: stage 0 takes microbatch t at tick t, the last stage
banks microbatch ``t - (P - 1)``, and the banked outputs travel from the
last stage to stage 0 and are broadcast to every stage, so what follows
is computed alike everywhere.  Stage parameters are stacked on a leading
axis split over ``pipe``: a rank holds its own stage's (P-way parameter
sharding).  The backward is the schedule in reverse (``_Pipeline``); the
broadcast's keeps one copy of the gradient (stage 0's): the stages'
copies are the same value, counted once.
"""

from __future__ import annotations

from typing import Callable

import torch

from analytics_zoo_torch.parallel import comm
from analytics_zoo_torch.parallel import mesh as mesh_lib
from analytics_zoo_torch.pipeline.api.keras.topology import tree_map


def stack_stage_params(per_stage_params):
    """[stage0_tree, stage1_tree, ...] with identical structure → one tree
    with a leading stage axis (split it over ``pipe``)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *per_stage_params)


def stage_param_sharding(mesh, stacked_params):
    """The spec placing the leading stage axis on ``pipe``, for every
    leaf."""
    del mesh
    return tree_map(lambda _: mesh_lib.Shard(mesh_lib.PIPE_AXIS, 0),
                    stacked_params)


class _Pipeline(torch.autograd.Function):
    """The schedule on this stage, with its backward written out: autograd
    runs only the graph nodes a rank's loss reaches, and those differ
    between stages, while every exchange must run on every stage in the
    same order.  The backward runs the ticks in reverse, one exchange a
    tick: each stage sends back the gradient of the activation it
    received, and recomputes its stage's product to take the vjp (GPipe's
    recompute)."""

    @staticmethod
    def forward(ctx, x, stage_fn, group, m, params_def, *leaves):
        from analytics_zoo_torch.pipeline.api.keras.topology import (
            tree_replace)
        p, stage = comm.group_size(group), comm.group_rank(group)
        params = tree_replace(params_def, list(leaves))
        mb = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        state = torch.zeros_like(mb[0])       # activation entering stage
        outputs = torch.zeros_like(mb)        # banked on the last stage
        inputs = []
        for t in range(m + p - 1):
            if stage == 0:
                # stage 0 ingests microbatch t (when one remains)
                state = mb[t if t < m else 0]
            inputs.append(state)
            y = stage_fn(params, state)
            if stage == p - 1 and t >= p - 1:
                outputs[t - (p - 1)] = y
            # advance the baton: stage i's output is stage i+1's input
            state = comm._ppermute(y, group, 1)
        # the last stage's outputs to stage 0, then to every stage (the
        # reference's P - 1 rotations, stage 0 keeping its own)
        outputs = comm._ppermute(outputs, group, 1)
        for _ in range(p - 1):
            rolled = comm._ppermute(outputs, group, 1)
            outputs = outputs if stage == 0 else rolled
        ctx.stage_fn, ctx.group, ctx.m = stage_fn, group, m
        ctx.params_def, ctx.inputs = params_def, inputs
        ctx.mb_shape = tuple(mb.shape)
        ctx.save_for_backward(*leaves)
        return outputs.reshape((m * mb.shape[1],) + tuple(mb.shape[2:]))

    @staticmethod
    def backward(ctx, g):
        from analytics_zoo_torch.pipeline.api.keras.topology import (
            tree_replace)
        group, m = ctx.group, ctx.m
        p, stage = comm.group_size(group), comm.group_rank(group)
        leaves = ctx.saved_tensors
        g = g.reshape(ctx.mb_shape)
        # the broadcast counts stage 0's copy once; the last stage's
        # outputs took it from stage 0
        g_outputs = comm._ppermute(g if stage == 0 else torch.zeros_like(g),
                                   group, -1)
        g_leaves = [torch.zeros_like(a) for a in leaves]
        g_x = torch.zeros(ctx.mb_shape, dtype=g.dtype, device=g.device)
        g_received = torch.zeros_like(g[0])
        for t in reversed(range(m + p - 1)):
            # the gradient of y_t: what the next stage's input took
            g_y = comm._ppermute(g_received, group, -1)
            if stage == p - 1 and t >= p - 1:
                g_y = g_y + g_outputs[t - (p - 1)]
            with torch.enable_grad():
                live = [a.detach().requires_grad_() for a in leaves]
                h = ctx.inputs[t].detach().requires_grad_()
                y = ctx.stage_fn(tree_replace(ctx.params_def, live), h)
                grads = torch.autograd.grad(y, [h] + live, g_y,
                                            allow_unused=True)
            for i, gl in enumerate(grads[1:]):
                if gl is not None:
                    g_leaves[i] = g_leaves[i] + gl
            if stage == 0:
                if t < m:
                    g_x[t] += grads[0]
                g_received = torch.zeros_like(g_received)
            else:
                g_received = grads[0]
        g_x = g_x.reshape((m * ctx.mb_shape[1],) + ctx.mb_shape[2:])
        return (g_x, None, None, None, None, *g_leaves)


def _spmd_pipeline(stage_fn: Callable, params, x, group,
                   num_microbatches: int):
    """This stage's share of the schedule: ``params`` are its stage's
    params, ``x`` the whole batch (the same on every stage)."""
    from analytics_zoo_torch.pipeline.api.keras.topology import tree_leaves
    return _Pipeline.apply(x, stage_fn, group, num_microbatches, params,
                           *tree_leaves(params))


def _record_schedule_metrics(p: int, m: int, x) -> None:
    """Schedule accounting per ``pipeline_apply``: the GPipe fill/drain
    bubble is ``(P-1)/(M+P-1)`` of each stage's ticks, and every tick
    sends one microbatch of activations.  Never raises."""
    try:
        from analytics_zoo_torch.observability import get_registry
        from analytics_zoo_torch.observability.collectives import (
            estimate_pipeline_ppermute_bytes, record_step_collectives)
        reg = get_registry()
        ticks = m + p - 1
        reg.gauge(
            "pipeline_num_stages",
            "pipeline stages (pipe mesh axis) of the last apply").set(p)
        reg.gauge(
            "pipeline_num_microbatches",
            "microbatches per pipeline_apply").set(m)
        reg.gauge(
            "pipeline_bubble_fraction",
            "GPipe fill/drain bubble: (P-1)/(M+P-1) of each stage's "
            "ticks are idle — raise num_microbatches to amortize"
        ).set((p - 1) / ticks)
        mb_bytes = (x.numel() // m) * x.element_size()
        record_step_collectives(
            {"ppermute": estimate_pipeline_ppermute_bytes(mb_bytes, p, m)})
    except Exception:   # noqa: BLE001 — accounting never fails a step
        pass


def pipeline_apply(stage_fn: Callable, stacked_params, x, mesh=None,
                   num_microbatches: int = 1):
    """Forward through the pipeline; differentiable end to end.

    ``stage_fn(params, h) -> h`` is ONE stage's computation (all stages
    share code; weights differ).  ``stacked_params`` carries the leading
    stage axis, whole (every stage's) or this rank's piece (size 1).
    ``x``: (B, ...) with B divisible by ``num_microbatches``, the same on
    every stage.  Returns the last stage's outputs on every stage."""
    mesh = mesh if mesh is not None else mesh_lib.current_mesh()
    p = mesh.size(mesh_lib.PIPE_AXIS)
    if p == 1:
        return stage_fn(tree_map(lambda a: a[0], stacked_params), x)
    group = mesh.group(mesh_lib.PIPE_AXIS)
    stage = comm.group_rank(group)
    params = tree_map(lambda a: a[stage] if a.shape[0] == p else a[0],
                      stacked_params)
    _record_schedule_metrics(p, num_microbatches, x)
    return _spmd_pipeline(stage_fn, params, comm.copy_to_group(x, group),
                          group, num_microbatches)
