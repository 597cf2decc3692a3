"""Experiment presets (the port of ``davo_tpu/train/presets.py``): the two
calibration-network presets and the three gen-1 optimisation presets
(``PinholeMLPGuess``, with the analytic-gradient BFGS unrolled in
training, or alone).
"""

from __future__ import annotations

from davo_tpu_torch.solve import BFGSConfig

from .calibration import CalibrationExperiment
from .optimisation import OptimisationExperiment

__all__ = ["PRESETS", "get_preset"]


def _calibration_from_oracle_matches() -> CalibrationExperiment:
    """The gen-2 scripted main: 4 views x 8 points, hidden 8 M N, batch 64,
    128 train batches, 50 epochs, the MLP head trained through a
    10-iteration unrolled solve with drop-path 0.1
    (``camera_calibration_from_oracle_matches.py:34-75`` in the reference)."""
    return CalibrationExperiment()


def _calibration_transformer_curriculum() -> CalibrationExperiment:
    """The JAX package's best recipe: the transformer guess head trained
    purely supervised (no unrolled solve in training), 300 epochs at a
    peak learning rate of 3e-4, and the full BFGS refinement at eval
    (strong Wolfe, 100 iterations, 50 probes, error threshold 1e-7)."""
    return CalibrationExperiment(
        epochs=300,
        head="transformer",
        learning_rate=3e-4,
        solver=BFGSConfig(
            error_threshold=1e-7,
            training_error_threshold=1e-3,
            iterations=100,
            training_iterations=0,
            line_search_iterations=50,
            drop_path_p=0.0,
        ),
    )


def _bfgs_solver_full_gradient() -> OptimisationExperiment:
    """Training through 10 unrolled BFGS iterations (differentiated through
    the analytic gradient too), 40 probes, the interpolating zoom
    (``configurations/bfgs_solver_full_gradient_config.yaml``)."""
    return OptimisationExperiment(
        solver=BFGSConfig(
            error_threshold=1e-6,
            iterations=10,
            drop_path_p=0.0,
            line_search_iterations=40,
            max_step_size=1e5,
            zoom_method="interpolate",
        ),
    )


def _bfgs_solver_only_error_gradient() -> OptimisationExperiment:
    """5 unrolled iterations, 12 probes, steps up to 32
    (``configurations/bfgs_solver_only_error_gradient_config.yaml``)."""
    return OptimisationExperiment(
        solver=BFGSConfig(
            error_threshold=1e-6,
            iterations=5,
            drop_path_p=0.0,
            line_search_iterations=12,
            max_step_size=32.0,
        ),
    )


def _mlp_guess() -> OptimisationExperiment:
    """The guess alone: 200 epochs, hidden 2,048, batch 256
    (``configurations/mlp_guess_config.yaml``)."""
    return OptimisationExperiment(hidden_size=2048, batch_size=256, epochs=200, solver_enabled=False)


PRESETS = {
    "calibration_from_oracle_matches": _calibration_from_oracle_matches,
    "calibration_transformer_curriculum": _calibration_transformer_curriculum,
    "bfgs_solver_full_gradient": _bfgs_solver_full_gradient,
    "bfgs_solver_only_error_gradient": _bfgs_solver_only_error_gradient,
    "mlp_guess": _mlp_guess,
}


def get_preset(name: str):
    if name not in PRESETS:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
