"""Calibration network, eval mode: learned initial guess + in-forward BFGS
(the port of ``davo_tpu/models/calibration_network.py``).

A guess head (the flattened MLP or the per-observation transformer) maps
the ``M x N`` observed pixels to an initial calibration parameter vector;
a batched BFGS solve over the projective-angle objective refines it inside
the forward pass.  With ``num_restarts > 1`` the solve starts from the
guess and ``num_restarts - 1`` Gaussian perturbations of it ("noise"
proposals) and keeps, per scene, the estimate of lowest reprojection
error ("error" selection).  Every solve runs on the fused objective:
kernel K2 for the value+gradient, kernel K1 for the Hessian update.

The layers follow flax's conventions, so converted JAX weights give the
same function: LayerNorm epsilon 1e-6, tanh-approximated GELU, BatchNorm
epsilon 1e-5 with running statistics, attention scores scaled by
``1/sqrt(head_dim)`` with no mask (visibility multiplies the tokens).
The head's attention is plain ``torch.matmul`` and softmax.

The training forward (and its unrolled differentiable solve) belongs to
the later slice that ports ``train/calibration.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from davo_tpu_torch.camera import calibration_error, num_calibration_parameters
from davo_tpu_torch.ops.calibration_obj import make_fused_calibration_objective
from davo_tpu_torch.solve import BFGSConfig, bfgs_solve
from davo_tpu_torch.utils.device import resolve_device
from davo_tpu_torch.utils.precision import full_f32_matmuls

__all__ = ["CalibrationNetwork", "CalibrationMLPHead", "CalibrationTransformerHead"]

_LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm
_BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu


class CalibrationMLPHead(nn.Module):
    """Linear/GELU/BatchNorm x2 + linear head."""

    def __init__(self, num_inputs: int, num_outputs: int, hidden_size: int):
        super().__init__()
        self.dense_1 = nn.Linear(num_inputs, hidden_size)
        self.norm_1 = nn.BatchNorm1d(hidden_size, eps=_BATCH_NORM_EPS)
        self.dense_2 = nn.Linear(hidden_size, hidden_size)
        self.norm_2 = nn.BatchNorm1d(hidden_size, eps=_BATCH_NORM_EPS)
        self.head = nn.Linear(hidden_size, num_outputs)

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        x = self.norm_1(_gelu(self.dense_1(inputs)))
        x = self.norm_2(_gelu(self.dense_2(x)))
        return self.head(x)


class _SelfAttention(nn.Module):
    """Multi-head self-attention with flax ``SelfAttention``'s parameters:
    per-head query/key/value projections and an output projection."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} is not divisible by {num_heads} heads")
        self.num_heads = num_heads
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.num_heads

        def heads(proj):
            return proj(x).view(b, t, h, d // h).transpose(1, 2)  # (B, h, T, hd)

        q = heads(self.query) / math.sqrt(d // h)
        weights = torch.softmax(torch.matmul(q, heads(self.key).transpose(-1, -2)), dim=-1)
        out = torch.matmul(weights, heads(self.value))  # (B, h, T, hd)
        return self.out(out.transpose(1, 2).reshape(b, t, d))


class _EncoderBlock(nn.Module):
    """Pre-LN transformer block."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.ln_a = nn.LayerNorm(embed_dim, eps=_LAYER_NORM_EPS)
        self.attn = _SelfAttention(embed_dim, num_heads)
        self.ln_m = nn.LayerNorm(embed_dim, eps=_LAYER_NORM_EPS)
        self.mlp_in = nn.Linear(embed_dim, 4 * embed_dim)
        self.mlp_out = nn.Linear(4 * embed_dim, embed_dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        tokens = tokens + self.attn(self.ln_a(tokens))
        return tokens + self.mlp_out(_gelu(self.mlp_in(self.ln_m(tokens))))


class CalibrationTransformerHead(nn.Module):
    """Attention guess head: one token per (view, point) observation with
    learned view and point embeddings and a visibility gate, pre-LN
    encoder blocks, and a readout token regressing the parameter vector."""

    def __init__(
        self,
        num_outputs: int,
        num_views: int,
        num_points: int,
        embed_dim: int = 128,
        num_layers: int = 3,
        num_heads: int = 4,
    ):
        super().__init__()
        self.pixel_embed = nn.Linear(2, embed_dim)
        self.view_embedding = nn.Parameter(0.02 * torch.randn(num_views, 1, embed_dim))
        self.point_embedding = nn.Parameter(0.02 * torch.randn(1, num_points, embed_dim))
        self.readout_token = nn.Parameter(0.02 * torch.randn(1, embed_dim))
        self.layers = nn.ModuleList(
            _EncoderBlock(embed_dim, num_heads) for _ in range(num_layers)
        )
        self.ln_out = nn.LayerNorm(embed_dim, eps=_LAYER_NORM_EPS)
        self.head = nn.Linear(embed_dim, num_outputs)

    def forward(self, projected_points: torch.Tensor, visibility_mask: torch.Tensor) -> torch.Tensor:
        """:return: ``(B, P)``."""
        b = projected_points.shape[0]
        tokens = self.pixel_embed(projected_points)  # (B, M, N, d)
        vis = visibility_mask.to(tokens.dtype)[..., None]
        tokens = (tokens + self.view_embedding + self.point_embedding) * vis
        tokens = tokens.reshape(b, -1, tokens.shape[-1])
        readout = self.readout_token.expand(b, -1, -1)
        tokens = torch.cat([readout, tokens], dim=1)
        for layer in self.layers:
            tokens = layer(tokens)
        return self.head(self.ln_out(tokens[:, 0]))


class CalibrationNetwork(nn.Module):
    """Guess head + eval-mode BFGS refinement.

    :param num_views: M views per problem.
    :param num_points: N tracked points per problem.
    :param hidden_size: head width; ``<= 0`` means ``4 * 2MN`` for the MLP
        head and 128 for the transformer head.
    :param solver: configuration of the in-forward solve.
    :param num_restarts: solve from this many starts per scene (the guess
        and Gaussian perturbations of it) and keep the lowest-error estimate.
    :param restart_noise: std of the restart perturbations.
    :param head: "mlp" or "transformer".
    :param device: where the module lives — the card unless the caller
        asks for another.
    """

    def __init__(
        self,
        num_views: int,
        num_points: int,
        hidden_size: int = -1,
        solver: BFGSConfig = BFGSConfig(error_threshold=1e-7),
        num_restarts: int = 1,
        restart_noise: float = 0.1,
        head: str = "mlp",
        transformer_layers: int = 3,
        transformer_heads: int = 4,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            full_f32_matmuls()
        self.num_views = num_views
        self.num_points = num_points
        self.solver = solver
        self.num_restarts = num_restarts
        self.restart_noise = restart_noise
        self.num_parameters = num_calibration_parameters(num_views, num_points)
        num_inputs = num_views * num_points * 2
        if head == "transformer":
            self.initial_estimator = CalibrationTransformerHead(
                num_outputs=self.num_parameters,
                num_views=num_views,
                num_points=num_points,
                embed_dim=hidden_size if hidden_size > 0 else 128,
                num_layers=transformer_layers,
                num_heads=transformer_heads,
            )
        elif head == "mlp":
            self.initial_estimator = CalibrationMLPHead(
                num_inputs,
                self.num_parameters,
                hidden_size if hidden_size > 0 else 4 * num_inputs,
            )
        else:
            raise ValueError(f"Unknown head: {head!r}")
        self.head = head
        self.to(device=device, dtype=dtype)
        self.eval()

    @torch.no_grad()
    def guess(self, true_projected_points: torch.Tensor, visibility_mask: torch.Tensor) -> torch.Tensor:
        """The head's initial estimate ``(B, P)``."""
        if self.head == "mlp":
            return self.initial_estimator(true_projected_points.reshape(true_projected_points.shape[0], -1))
        return self.initial_estimator(true_projected_points, visibility_mask)

    @torch.no_grad()
    def forward(
        self,
        true_projected_points: torch.Tensor,
        visibility_mask: torch.Tensor,
        *,
        generator: Optional[torch.Generator] = None,
        restart_draws: Optional[torch.Tensor] = None,
        return_error: bool = False,
    ):
        """
        :param true_projected_points: ``(B, M, N, 2)`` observed pixels.
        :param visibility_mask: ``(B, M, N)`` visibility flags.
        :param generator: draws the restart noise (a generator seeded 0 on
            the module's device when omitted).
        :param restart_draws: ``(B, num_restarts - 1, P)`` standard-normal
            draws to use instead of the generator's.
        :return: ``(B, P)`` calibration parameters (and the final error per
            scene if ``return_error``).
        """
        if self.training:
            raise NotImplementedError(
                "the training forward (unrolled differentiable solve) is ported "
                "with train/calibration.py in a later slice of the port"
            )
        batch = true_projected_points.shape[0]
        p = self.num_parameters
        initial_guess = self.guess(true_projected_points, visibility_mask)
        visibility = visibility_mask.to(initial_guess.dtype)
        restarts = max(self.num_restarts, 1)

        if restarts > 1:
            if restart_draws is None:
                if generator is None:
                    generator = torch.Generator(initial_guess.device).manual_seed(0)
                restart_draws = torch.randn(
                    (batch, restarts - 1, p),
                    generator=generator,
                    device=initial_guess.device,
                    dtype=initial_guess.dtype,
                )
            starts = torch.cat(
                [
                    initial_guess[:, None, :],
                    initial_guess[:, None, :] + self.restart_noise * restart_draws,
                ],
                dim=1,
            ).reshape(batch * restarts, p)
            # the fused closures capture per-element observations, so the
            # observations are tiled over the restarts
            error_fn, value_and_grad_fn = make_fused_calibration_objective(
                true_projected_points.repeat_interleave(restarts, dim=0),
                visibility.repeat_interleave(restarts, dim=0),
            )
            solved = bfgs_solve(
                error_fn, starts, self.solver, value_and_grad_fn=value_and_grad_fn
            ).reshape(batch, restarts, p)
            scores = calibration_error(solved, true_projected_points[:, None], visibility[:, None])
            best = torch.argmin(scores, dim=-1)
            result = solved[torch.arange(batch, device=solved.device), best]
        else:
            error_fn, value_and_grad_fn = make_fused_calibration_objective(
                true_projected_points, visibility
            )
            result = bfgs_solve(
                error_fn, initial_guess, self.solver, value_and_grad_fn=value_and_grad_fn
            )
        if return_error:
            return result, calibration_error(result, true_projected_points, visibility)
        return result
