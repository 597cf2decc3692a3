from .calibration_network import (
    CalibrationMLPHead,
    CalibrationNetwork,
    CalibrationTransformerHead,
)
from .convert import flax_to_state_dict, load_calibration_network, load_numpy_checkpoint

__all__ = [
    "CalibrationMLPHead",
    "CalibrationNetwork",
    "CalibrationTransformerHead",
    "flax_to_state_dict",
    "load_calibration_network",
    "load_numpy_checkpoint",
]
