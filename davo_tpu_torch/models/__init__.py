from .calibration_network import (
    CalibrationMLPHead,
    CalibrationNetwork,
    CalibrationTransformerHead,
)
from .convert import (
    FRONTEND_V4,
    flax_to_state_dict,
    frontend_state_dict,
    load_calibration_network,
    load_frontend,
    load_frontend_npz,
    load_numpy_checkpoint,
)
from .detector import FeatureDetectionModule, refine_points_centroid
from .matcher import FeatureMatchModule, NFoldMatcherModule
from .vo_frontend import FrontendOutput, VOFrontend, select_matches

__all__ = [
    "CalibrationMLPHead",
    "CalibrationNetwork",
    "CalibrationTransformerHead",
    "FRONTEND_V4",
    "flax_to_state_dict",
    "frontend_state_dict",
    "load_calibration_network",
    "load_frontend",
    "load_frontend_npz",
    "load_numpy_checkpoint",
    "FeatureDetectionModule",
    "refine_points_centroid",
    "FeatureMatchModule",
    "NFoldMatcherModule",
    "FrontendOutput",
    "VOFrontend",
    "select_matches",
]
