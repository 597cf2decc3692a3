"""Calibration network: learned initial guess + in-forward BFGS (the port
of ``davo_tpu/models/calibration_network.py``).

A guess head (the flattened MLP or the per-observation transformer) maps
the ``M x N`` observed pixels to an initial calibration parameter vector;
a batched BFGS solve over the projective-angle objective refines it inside
the forward pass.

Eval: with ``num_restarts > 1`` the solve starts from the guess and
``num_restarts - 1`` proposals ("noise": Gaussian perturbations of the
guess; "permutation": the head applied to point-permuted scenes, the
world points scattered back; "input_noise": the head applied to
observation-jittered scenes; "tokens": the transformer head's E readout
tokens) and keeps, per scene, the estimate of lowest reprojection error
("error" selection) or of lowest basin score ("basin": the error plus
plausibility penalties).  Every eval solve runs on the fused objective:
kernel K2 for the value+gradient, and, under BFGS, kernel K1 for the
Hessian update (the solver is BFGS or, for an ``LBFGSConfig``, L-BFGS,
whose two-loop recursion has no dense Hessian and no kernel).

Training (``training=True``): one start, the unrolled differentiable
solve on the plain objective (autograd of ``calibration_error``; neither
kernel, as in the JAX package, whose fused objective and Hessian kernel
are eval-only); a multi-token head returns its raw ``(B, E, P)`` tokens
unsolved.  The MLP head's BatchNorm then normalises with the batch
statistics and updates its running statistics as flax does (momentum
0.99 on the biased batch variance).

The layers follow flax's conventions, so converted JAX weights give the
same function: LayerNorm epsilon 1e-6, tanh-approximated GELU, BatchNorm
epsilon 1e-5 with running statistics, attention scores scaled by
``1/sqrt(head_dim)`` with no mask (visibility multiplies the tokens).
The head's attention is plain ``torch.matmul`` and softmax.  Fresh
weights follow flax's initialisers (:func:`flax_style_init_`).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from davo_tpu_torch.camera import (
    BasinScoreConfig,
    basin_score,
    calibration_error,
    num_calibration_parameters,
)
from davo_tpu_torch.ops.calibration_obj import make_fused_calibration_objective
from davo_tpu_torch.solve import BFGSConfig, LBFGSConfig, bfgs_solve, lbfgs_solve
from davo_tpu_torch.utils.device import resolve_device
from davo_tpu_torch.utils.precision import full_f32_matmuls

__all__ = [
    "CalibrationNetwork",
    "CalibrationMLPHead",
    "CalibrationTransformerHead",
    "flax_style_init_",
    "permutation_restart_guesses",
]

_LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm
_BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm
_BATCH_NORM_MOMENTUM = 0.99  # flax nn.BatchNorm: running = m * running + (1 - m) * batch
_EMBEDDING_STD = 0.02  # flax normal(0.02) for the view, point and readout embeddings
# flax lecun_normal: a normal truncated at +-2 std, rescaled to unit variance
_TRUNCATED_NORMAL_STD = 0.87962566103423978
_PROPOSALS = ("noise", "permutation", "input_noise", "tokens")
_SELECTIONS = ("error", "basin")


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # flax nn.gelu


class _FlaxBatchNorm(nn.BatchNorm1d):
    """``BatchNorm1d`` with flax's training semantics: normalise with the
    batch mean and biased variance ``E[x^2] - E[x]^2`` (floored at 0) and
    move the running statistics by ``m * running + (1 - m) * batch`` with
    m = 0.99 on that same biased variance (torch's own update uses the
    unbiased one and the opposite momentum).  ``affine=False`` is flax's
    BatchNorm without scale and bias.

    ``reduce_statistics``, when set (the data-parallel step sets it for its
    forward), takes this rank's ``(2, F)`` sums of ``x`` and ``x^2`` and
    their count and returns the global batch's, differentiably, so the
    statistics are the global batch's as under GSPMD."""

    reduce_statistics: Optional[Callable] = None

    def __init__(self, num_features: int, affine: bool = True):
        super().__init__(num_features, eps=_BATCH_NORM_EPS, affine=affine)

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        """Normalise the last axis of ``x`` (the statistics reduce over
        every other axis, as flax's do)."""
        if not training:
            mean, var = self.running_mean, self.running_var
        else:
            dims = tuple(range(x.ndim - 1))
            if self.reduce_statistics is None:
                mean = torch.mean(x, dim=dims)
                mean_sq = torch.mean(torch.square(x), dim=dims)
            else:
                sums, count = self.reduce_statistics(
                    torch.stack([torch.sum(x, dim=dims), torch.sum(torch.square(x), dim=dims)]),
                    x.numel() // x.shape[-1],
                )
                mean, mean_sq = sums[0] / count, sums[1] / count
            var = torch.clamp(mean_sq - torch.square(mean), min=0.0)
            with torch.no_grad():
                m = _BATCH_NORM_MOMENTUM
                self.running_mean.mul_(m).add_((1.0 - m) * mean.detach())
                self.running_var.mul_(m).add_((1.0 - m) * var.detach())
        if self.weight is None:  # flax use_scale=False, use_bias=False
            return (x - mean) * torch.rsqrt(var + self.eps)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


class CalibrationMLPHead(nn.Module):
    """Linear/GELU/BatchNorm x2 + linear head."""

    def __init__(self, num_inputs: int, num_outputs: int, hidden_size: int):
        super().__init__()
        self.dense_1 = nn.Linear(num_inputs, hidden_size)
        self.norm_1 = _FlaxBatchNorm(hidden_size)
        self.dense_2 = nn.Linear(hidden_size, hidden_size)
        self.norm_2 = _FlaxBatchNorm(hidden_size)
        self.head = nn.Linear(hidden_size, num_outputs)

    def forward(self, inputs: torch.Tensor, training: bool = False) -> torch.Tensor:
        x = self.norm_1(_gelu(self.dense_1(inputs)), training)
        x = self.norm_2(_gelu(self.dense_2(x)), training)
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
    encoder blocks, and ``num_tokens`` readout tokens, each regressing a
    parameter vector (E parallel guesses when ``num_tokens > 1``)."""

    def __init__(
        self,
        num_outputs: int,
        num_views: int,
        num_points: int,
        embed_dim: int = 128,
        num_layers: int = 3,
        num_heads: int = 4,
        num_tokens: int = 1,
    ):
        super().__init__()
        self.num_tokens = num_tokens
        self.pixel_embed = nn.Linear(2, embed_dim)
        self.view_embedding = nn.Parameter(torch.empty(num_views, 1, embed_dim))
        self.point_embedding = nn.Parameter(torch.empty(1, num_points, embed_dim))
        self.readout_token = nn.Parameter(torch.empty(num_tokens, embed_dim))
        self.layers = nn.ModuleList(
            _EncoderBlock(embed_dim, num_heads) for _ in range(num_layers)
        )
        self.ln_out = nn.LayerNorm(embed_dim, eps=_LAYER_NORM_EPS)
        self.head = nn.Linear(embed_dim, num_outputs)

    def forward(self, projected_points: torch.Tensor, visibility_mask: torch.Tensor) -> torch.Tensor:
        """:return: ``(B, P)``, or ``(B, E, P)`` when ``num_tokens > 1``."""
        b = projected_points.shape[0]
        tokens = self.pixel_embed(projected_points)  # (B, M, N, d)
        vis = visibility_mask.to(tokens.dtype)[..., None]
        tokens = (tokens + self.view_embedding + self.point_embedding) * vis
        tokens = tokens.reshape(b, -1, tokens.shape[-1])
        readout = self.readout_token.expand(b, -1, -1)
        tokens = torch.cat([readout, tokens], dim=1)
        for layer in self.layers:
            tokens = layer(tokens)
        out = self.head(self.ln_out(tokens[:, : self.num_tokens]))  # (B, E, P)
        return out[:, 0] if self.num_tokens == 1 else out


@torch.no_grad()
def flax_style_init_(module: nn.Module, generator: Optional[torch.Generator] = None) -> nn.Module:
    """Initialise ``module`` in place as flax initialises the JAX networks:
    ``lecun_normal`` kernels (a normal truncated at two standard
    deviations, variance 1 / fan_in) and zero biases on every dense
    projection and convolution (fan_in = in_features for a dense layer,
    and the attention's per-head projections have fan_in = d, as their
    flattened ``Linear`` weights do; kh * kw * cin for a convolution),
    normal(0.02) embeddings and readout tokens, unit scales and zero
    offsets on the norms, BatchNorm running statistics 0 and 1; a module
    listing ``flax_normal_parameters`` (``(name, std)`` pairs) has those
    parameters drawn from ``normal(std)``.
    ``generator`` (a CPU generator) draws on the CPU; the values are then
    copied to the module's device."""
    for sub in module.modules():
        if isinstance(sub, (nn.Linear, nn.Conv2d)):
            std = math.sqrt(1.0 / sub.weight[0].numel()) / _TRUNCATED_NORMAL_STD
            draw = torch.empty(sub.weight.shape, dtype=torch.float64)
            nn.init.trunc_normal_(draw, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
            sub.weight.copy_(draw)
            if sub.bias is not None:
                sub.bias.zero_()
        elif isinstance(sub, (nn.LayerNorm, nn.BatchNorm1d, nn.BatchNorm2d)):
            if sub.weight is not None:
                sub.weight.fill_(1.0)
                sub.bias.zero_()
            if not isinstance(sub, nn.LayerNorm):
                sub.reset_running_stats()
        elif isinstance(sub, CalibrationTransformerHead):
            for embedding in (sub.view_embedding, sub.point_embedding, sub.readout_token):
                draw = torch.randn(embedding.shape, generator=generator, dtype=torch.float64)
                embedding.copy_(_EMBEDDING_STD * draw)
        # a module's own normal-initialised parameters: (name, std) pairs
        for name, std in getattr(sub, "flax_normal_parameters", ()):
            parameter = getattr(sub, name)
            parameter.copy_(std * torch.randn(parameter.shape, generator=generator, dtype=torch.float64))
    return module


def permutation_restart_guesses(
    apply_head: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    raw_guess: torch.Tensor,
    permutations: torch.Tensor,
) -> torch.Tensor:
    """Multi-start guesses from point-permuted applications of the head.

    The heads are point-order-sensitive, so a permuted copy of the scene
    gives another, still scene-informed estimate.  Its world-point slices
    come back in permuted order and are scattered back through the
    inverse permutation; intrinsics and poses pass through.

    :param apply_head: ``(pixels (B, M, N, 2), visibility (B, M, N)) -> (B, P)``.
    :param raw_guess: ``(B, P)``, the head on the unpermuted scene (start 0).
    :param permutations: ``(E - 1, N)`` point permutations, one a restart.
    :return: ``(B, E, P)`` starts.
    """
    num_points = permutations.shape[-1]
    points_end = 3 + 3 * num_points
    guesses = [raw_guess]
    for perm in permutations:
        guess = apply_head(pixels[:, :, perm], visibility[:, :, perm])
        # entry j of the permuted prediction is original point perm[j]
        inverse = torch.argsort(perm)
        points = guess[:, 3:points_end].reshape(-1, num_points, 3)[:, inverse]
        guesses.append(torch.cat([guess[:, :3], points.reshape(-1, 3 * num_points), guess[:, points_end:]], dim=-1))
    return torch.stack(guesses, dim=1)


class CalibrationNetwork(nn.Module):
    """Guess head + in-forward BFGS refinement.

    :param num_views: M views per problem.
    :param num_points: N tracked points per problem.
    :param hidden_size: head width; ``<= 0`` means ``4 * 2MN`` for the MLP
        head and 128 for the transformer head.
    :param solver: configuration of the in-forward solve: a
        :class:`BFGSConfig` (BFGS) or an :class:`LBFGSConfig` (L-BFGS),
        on every route (training, one start, restarts).
    :param num_restarts: eval solves from this many starts per scene and
        keeps the best estimate (training always solves one start).
    :param restart_noise: std of the "noise" perturbations (and of the
        "tokens" restarts beyond the token count).
    :param restart_proposals: "noise", "permutation", "input_noise" or
        "tokens" (the module docstring says what each proposes).
    :param input_noise: std of the observation jitter of "input_noise".
    :param guess_tokens: readout tokens of the transformer head; with more
        than one, training returns the raw ``(B, E, P)`` tokens unsolved.
    :param selection: "error" (reprojection error) or "basin"
        (:func:`davo_tpu_torch.camera.basin_score`).
    :param basin: weights of the basin score; ``anchor_weight > 0`` pulls
        towards the guess head's focal.
    :param head: "mlp" or "transformer".
    :param device: where the module lives — the card unless the caller
        asks for another.
    :param generator: a CPU generator for the flax-style initial weights
        (the global generator when omitted).
    """

    def __init__(
        self,
        num_views: int,
        num_points: int,
        hidden_size: int = -1,
        solver: Union[BFGSConfig, LBFGSConfig] = BFGSConfig(error_threshold=1e-7, training_error_threshold=1e-3),
        num_restarts: int = 1,
        restart_noise: float = 0.1,
        restart_proposals: str = "noise",
        input_noise: float = 0.02,
        guess_tokens: int = 1,
        selection: str = "error",
        basin: BasinScoreConfig = BasinScoreConfig(),
        head: str = "mlp",
        transformer_layers: int = 3,
        transformer_heads: int = 4,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            full_f32_matmuls()
        if guess_tokens > 1 and head != "transformer":
            raise ValueError(f"guess_tokens > 1 requires the transformer head (got head={head!r})")
        if restart_proposals not in _PROPOSALS:
            raise ValueError(f"Unknown restart_proposals: {restart_proposals!r}")
        if selection not in _SELECTIONS:
            raise ValueError(f"Unknown selection: {selection!r}")
        self.num_views = num_views
        self.num_points = num_points
        self.solver = solver
        self.num_restarts = num_restarts
        self.restart_noise = restart_noise
        self.restart_proposals = restart_proposals
        self.input_noise = input_noise
        self.guess_tokens = guess_tokens
        self.selection = selection
        self.basin = basin
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
                num_tokens=guess_tokens,
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
        flax_style_init_(self, generator)
        self.to(device=device, dtype=dtype)
        self.eval()

    def _solve(self, *args, **kwargs):
        """The configured solver: L-BFGS for an :class:`LBFGSConfig`, BFGS
        otherwise."""
        return (lbfgs_solve if isinstance(self.solver, LBFGSConfig) else bfgs_solve)(*args, **kwargs)

    def _apply_head(self, pixels: torch.Tensor, visibility: torch.Tensor, training: bool) -> torch.Tensor:
        if self.head == "mlp":
            return self.initial_estimator(pixels.reshape(pixels.shape[0], -1), training)
        return self.initial_estimator(pixels, visibility)

    @torch.no_grad()
    def guess(self, true_projected_points: torch.Tensor, visibility_mask: torch.Tensor) -> torch.Tensor:
        """The head's initial estimate ``(B, P)`` (``(B, E, P)`` with several
        guess tokens), with the running statistics."""
        return self._apply_head(true_projected_points, visibility_mask, False)

    def forward(
        self,
        true_projected_points: torch.Tensor,
        visibility_mask: torch.Tensor,
        *,
        training: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        restart_draws: Optional[torch.Tensor] = None,
        restart_permutations: Optional[torch.Tensor] = None,
        input_draws: Optional[torch.Tensor] = None,
        keep_masks: Optional[torch.Tensor] = None,
        return_error: bool = False,
    ):
        """
        :param true_projected_points: ``(B, M, N, 2)`` observed pixels.
        :param visibility_mask: ``(B, M, N)`` visibility flags.
        :param training: the training forward (defaults to ``self.training``).
        :param generator: draws the eval restarts' noise, permutations and
            input jitter (a generator seeded 0 on the module's device when
            omitted), or the training solve's drop-path keep-masks.
        :param restart_draws: standard-normal draws to use instead of the
            generator's: ``(B, num_restarts - 1, P)`` for "noise",
            ``(B, num_restarts - E, P)`` for the "tokens" restarts beyond
            the E tokens.
        :param restart_permutations: ``(num_restarts - 1, N)`` point
            permutations for "permutation".
        :param input_draws: ``(num_restarts - 1, B, M, N, 2)`` standard-normal
            observation jitter for "input_noise".
        :param keep_masks: ``(iterations, B)`` drop-path keep-masks of the
            training solve.
        :return: ``(B, P)`` calibration parameters (and the final error per
            scene if ``return_error``); in training with several guess
            tokens, the ``(B, E, P)`` tokens (and their ``(B, E)`` errors).
        """
        if self.training if training is None else training:
            with torch.enable_grad():
                return self._forward_training(
                    true_projected_points, visibility_mask, generator, keep_masks, return_error
                )
        with torch.no_grad():
            result = self._solve_eval(
                true_projected_points, visibility_mask, generator, restart_draws, restart_permutations, input_draws
            )
            if return_error:
                visibility = visibility_mask.to(result.dtype)
                return result, calibration_error(result, true_projected_points, visibility)
            return result

    def _forward_training(self, pixels, visibility_mask, generator, keep_masks, return_error):
        """One start, the unrolled differentiable solve on the plain
        objective; multi-token heads return their tokens unsolved."""
        initial_guess = self._apply_head(pixels, visibility_mask, True)
        visibility = visibility_mask.to(initial_guess.dtype)
        if self.guess_tokens > 1:
            # winner-take-all training consumes every token's guess
            if return_error:
                return initial_guess, calibration_error(initial_guess, pixels[:, None], visibility[:, None])
            return initial_guess

        def error_function(parameters):
            return calibration_error(parameters, pixels, visibility)

        result = self._solve(
            error_function, initial_guess, self.solver, training=True, generator=generator, keep_masks=keep_masks
        )
        if return_error:
            return result, error_function(result)
        return result

    def _solve_eval(self, pixels, visibility_mask, generator, restart_draws, restart_permutations, input_draws):
        raw = self._apply_head(pixels, visibility_mask, False)
        initial_guess = raw[:, 0] if self.guess_tokens > 1 else raw
        batch, p = initial_guess.shape
        device, dtype = initial_guess.device, initial_guess.dtype
        visibility = visibility_mask.to(dtype)
        restarts = max(self.num_restarts, 1)
        if restarts == 1:
            error_fn, value_and_grad_fn = make_fused_calibration_objective(pixels, visibility)
            return self._solve(error_fn, initial_guess, self.solver, value_and_grad_fn=value_and_grad_fn)

        if generator is None:
            generator = torch.Generator(device).manual_seed(0)

        def normal(shape):
            return torch.randn(shape, generator=generator, device=device, dtype=dtype)

        proposals = self.restart_proposals
        if proposals == "tokens":
            if self.guess_tokens == 1:
                raise ValueError("restart_proposals='tokens' requires guess_tokens > 1")
            e = min(restarts, self.guess_tokens)
            starts = raw[:, :e]
            if restarts > e:
                # the restarts beyond the tokens: noise around token 0
                draws = restart_draws if restart_draws is not None else normal((batch, restarts - e, p))
                starts = torch.cat([starts, initial_guess[:, None] + self.restart_noise * draws], dim=1)
        elif proposals == "permutation":
            if self.guess_tokens > 1:
                raise ValueError(
                    "restart_proposals='permutation' is incompatible with guess_tokens > 1 (use 'tokens')"
                )
            if restart_permutations is None:
                restart_permutations = torch.stack(
                    [torch.randperm(self.num_points, generator=generator, device=device) for _ in range(restarts - 1)]
                )
            starts = permutation_restart_guesses(
                lambda pts, vis: self._apply_head(pts, vis, False),
                pixels,
                visibility_mask,
                initial_guess,
                restart_permutations.to(device),
            )
        elif proposals == "input_noise":
            guesses = [initial_guess]
            for e in range(1, restarts):
                draws = input_draws[e - 1] if input_draws is not None else normal(pixels.shape)
                guess = self._apply_head(pixels + self.input_noise * draws, visibility_mask, False)
                guesses.append(guess[:, 0] if self.guess_tokens > 1 else guess)
            starts = torch.stack(guesses, dim=1)
        else:  # noise
            draws = restart_draws if restart_draws is not None else normal((batch, restarts - 1, p))
            starts = torch.cat([initial_guess[:, None], initial_guess[:, None] + self.restart_noise * draws], dim=1)

        # the fused closures capture per-element observations, so the
        # observations are tiled over the restarts
        error_fn, value_and_grad_fn = make_fused_calibration_objective(
            pixels.repeat_interleave(restarts, dim=0), visibility.repeat_interleave(restarts, dim=0)
        )
        solved = self._solve(
            error_fn, starts.reshape(batch * restarts, p), self.solver, value_and_grad_fn=value_and_grad_fn
        ).reshape(batch, restarts, p)
        if self.selection == "basin":
            anchor = None
            if self.basin.anchor_weight > 0.0:
                # log of the guess head's effective focal, elu(f) + 1
                anchor = torch.log(torch.clamp(F.elu(initial_guess[:, 0]) + 1.0, min=1e-6))[:, None]
            scores = basin_score(solved, pixels[:, None], visibility[:, None], self.basin, anchor_log_focal=anchor)
        else:
            scores = calibration_error(solved, pixels[:, None], visibility[:, None])
        best = torch.argmin(scores, dim=-1)
        return solved[torch.arange(batch, device=device), best]
