"""Data-parallel training over a mesh (the port of
``davo_tpu/parallel/data_parallel.py``).

The JAX step draws its batch inside a GSPMD-sharded step from one key, so
the global batch does not depend on the mesh, and XLA all-reduces the
gradients and the BatchNorm statistics.  Here every rank draws the whole
global batch and the drop-path keep-masks from the same generator (scenes
are tiny), keeps its rows, and issues the collectives itself:

* the BatchNorm statistics of the MLP head: each rank's sums of ``x`` and
  ``x^2`` all-reduced (differentiably: the backward all-reduces their
  gradients), so they are the global batch's;
* the gradients: the flattened list all-reduced once a step and divided
  by the world size, so clipping and the AdamW update run identically on
  every rank.  The port's step differentiates with ``torch.autograd.grad``,
  which DDP's ``.backward()`` hooks never see, so DDP is not used;
* the metrics: plain means all-reduced as means; the token usage before
  its entropy.

The N-rank step equals the single-device
:func:`davo_tpu_torch.train.make_train_step` on the same generator, up to
the order of the sums.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist

from davo_tpu_torch.models.calibration_network import _FlaxBatchNorm

from .mesh import DATA_AXIS, axis

__all__ = ["make_dp_train_step"]


class _AllReduceSum(torch.autograd.Function):
    """``sum over the group's ranks`` whose backward sums the gradients over
    the ranks too (each rank's loss reaches every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def make_dp_train_step(state, config, mesh, axis_name: str = DATA_AXIS):
    """``train_step(generator) -> metrics``: one data-parallel step of
    ``config.batch_size`` scenes over ``mesh``'s ``axis_name``, updating
    ``state`` (a :class:`davo_tpu_torch.train.TrainState`, replicated: the
    same weights on every rank) in place.

    Every rank calls it with a generator in the same state.
    ``config.batch_size`` must divide evenly over the axis.
    """
    from davo_tpu_torch.train.calibration import _loss_and_metrics

    network = state.network
    group, size, coordinate = axis(mesh, axis_name)
    if config.batch_size % size != 0:
        raise ValueError(f"batch_size={config.batch_size} must divide evenly over mesh axis {axis_name!r} ({size})")
    local = config.batch_size // size
    rows = slice(coordinate * local, (coordinate + 1) * local)
    device = next(network.parameters()).device
    batch_fn = config.make_batch_fn(device)
    params = list(network.parameters())
    norms = [m for m in network.modules() if isinstance(m, _FlaxBatchNorm)]
    solver = network.solver
    iterations, _ = solver.resolve(True)
    # the training solve draws a keep-mask an iteration from the generator
    # (single-guess heads with drop-path only), after the batch
    draws_keep_masks = network.guess_tokens == 1 and solver.drop_path_p > 0.0

    def reduce_statistics(sums, count):
        return _AllReduceSum.apply(sums, group), count * size

    def reduce_mean(x):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y / size

    def train_step(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = batch_fn(generator, config.batch_size)
        keep_masks = None
        if draws_keep_masks:
            keep_masks = torch.stack([
                torch.rand(config.batch_size, generator=generator, device=device) > solver.drop_path_p
                for _ in range(iterations)
            ])[:, rows]
        shard = type(batch)(*(x[rows] for x in batch))
        for norm in norms:
            norm.reduce_statistics = reduce_statistics
        try:
            loss, metrics = _loss_and_metrics(
                network, shard, config.structure_weight, training=True, generator=generator,
                keep_masks=keep_masks, reduce_mean=reduce_mean,
            )
            gradients = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            for norm in norms:
                norm.reduce_statistics = None
        # a parameter the loss does not reach has gradient 0, as under jax.grad
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for p, g in zip(params, gradients)])
        dist.all_reduce(flat, group=group)
        flat = flat / size
        state.apply_gradients([g.view_as(p) for g, p in zip(flat.split([p.numel() for p in params]), params)])
        names = [k for k in metrics if k != "token_usage_entropy"]
        means = reduce_mean(torch.stack([metrics[k].detach() for k in names]))
        out = dict(zip(names, means))
        if "token_usage_entropy" in metrics:
            out["token_usage_entropy"] = metrics["token_usage_entropy"].detach()
        return out

    return train_step
