"""Experiment presets (the port of ``davo_tpu/train/presets.py``), as far
as the port runs them: the two calibration-network presets.  The three
optimisation presets train the gen-1 stack (``PinholeMLPGuess`` and the
protocol solver, ``ROADMAP.md`` Queue 1 item 6); :func:`get_preset`
raises for them and says so.
"""

from __future__ import annotations

from davo_tpu_torch.solve import BFGSConfig

from .calibration import CalibrationExperiment

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


PRESETS = {
    "calibration_from_oracle_matches": _calibration_from_oracle_matches,
    "calibration_transformer_curriculum": _calibration_transformer_curriculum,
}
_GEN1_PRESETS = ("bfgs_solver_full_gradient", "bfgs_solver_only_error_gradient", "mlp_guess")


def get_preset(name: str) -> CalibrationExperiment:
    if name in _GEN1_PRESETS:
        raise NotImplementedError(
            f"preset {name!r} trains the gen-1 stack (PinholeMLPGuess), which is not ported yet "
            "(ROADMAP.md Queue 1 item 6)"
        )
    if name not in PRESETS:
        raise KeyError(f"Unknown preset {name!r}; available: {sorted(PRESETS)}")
    return PRESETS[name]()
