"""The gen-1 object protocol: optimisable-function objects (the port of
``davo_tpu/camera/model_protocol.py``).

An objective owns its parameters and observations and exposes
``get_error`` / ``get_gradient`` / ``add`` / ``masked_update`` /
``as_parameters_vector`` (the reference's
``solvers/i_optimisable_function.py``).  :class:`PinholeCameraModelL1` is
an immutable wrapper over the functional core
(:mod:`davo_tpu_torch.camera.pinhole_ba`): each method returns a new
object.
"""

from __future__ import annotations

import abc
import dataclasses

import torch

from davo_tpu_torch.utils.masked import masked_update as _masked_where

from .pinhole_ba import (
    PinholeBAConfig,
    PinholeBAData,
    PinholeBAParams,
    ba_add_vector,
    ba_error,
    ba_error_and_gradient,
    ba_params_to_vector,
    num_ba_parameters,
)

__all__ = ["IOptimisableFunction", "PinholeCameraModelL1"]


class IOptimisableFunction(abc.ABC):
    """The optimisable-function contract; tensors carry the batch
    dimensions ``(B, E, ...)``."""

    @property
    @abc.abstractmethod
    def batch_size(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_estimates(self) -> int: ...

    @property
    @abc.abstractmethod
    def num_parameters(self) -> int: ...

    @abc.abstractmethod
    def get_error(self) -> torch.Tensor:
        """Total error per estimate, ``(B, E)``."""

    @abc.abstractmethod
    def get_gradient(self) -> torch.Tensor:
        """Gradient per estimate, ``(B, E, P)``."""

    @abc.abstractmethod
    def as_parameters_vector(self) -> torch.Tensor:
        """Flat parameters, ``(B, E, P)``."""

    @abc.abstractmethod
    def add(self, delta: torch.Tensor) -> "IOptimisableFunction":
        """A new instance at ``parameters + delta``."""

    @abc.abstractmethod
    def masked_update(self, other: "IOptimisableFunction", mask: torch.Tensor) -> "IOptimisableFunction":
        """``other`` where ``mask`` (shape ``(B, E)``) holds, else self."""


@dataclasses.dataclass(frozen=True)
class PinholeCameraModelL1(IOptimisableFunction):
    """The gen-1 objective as an immutable object: parameters,
    observations and config; the error and gradient are the analytic
    functional core's."""

    params: PinholeBAParams
    data: PinholeBAData
    config: PinholeBAConfig = PinholeBAConfig()

    @property
    def batch_size(self) -> int:
        return self.params.focal_length.shape[0]

    @property
    def num_estimates(self) -> int:
        return self.params.focal_length.shape[1]

    @property
    def num_parameters(self) -> int:
        return num_ba_parameters(self.params.num_views, self.params.num_points)

    def get_error(self) -> torch.Tensor:
        return ba_error(self.params, self.data, self.config)

    def get_gradient(self) -> torch.Tensor:
        return ba_error_and_gradient(self.params, self.data, self.config)[1]

    def get_error_and_gradient(self):
        return ba_error_and_gradient(self.params, self.data, self.config)

    def as_parameters_vector(self) -> torch.Tensor:
        return ba_params_to_vector(self.params)

    def add(self, delta: torch.Tensor) -> "PinholeCameraModelL1":
        return PinholeCameraModelL1(ba_add_vector(self.params, delta, self.config), self.data, self.config)

    def masked_update(self, other: "PinholeCameraModelL1", mask: torch.Tensor) -> "PinholeCameraModelL1":
        merged = PinholeBAParams(*(_masked_where(cur, new, mask) for cur, new in zip(self.params, other.params)))
        return PinholeCameraModelL1(merged, self.data, self.config)
