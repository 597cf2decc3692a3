"""Rotation matrices from two (un-normalised) basis vectors (the port of
``davo_tpu/geometry/orientation.py``).

Gram-Schmidt: column 1 is ``a`` normalised, column 2 is ``b`` with its
component along ``a`` removed, then normalised, column 3 their cross
product.  The Jacobian comes from ``torch.func.jacfwd`` over the pure
construction, as the JAX module takes ``jax.jacfwd``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from davo_tpu_torch.utils.guards import safe_reciprocal

__all__ = ["two_vector_rotation_matrix", "two_vector_rotation_jacobian"]


def two_vector_rotation_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Orthonormalise ``(a, b)`` into a rotation matrix.

    :param a: ``(..., 3)`` first (forward) basis vector; becomes column 1.
    :param b: ``(..., 3)`` second (down) basis vector; its component
        orthogonal to ``a`` becomes column 2.
    :return: ``(..., 3, 3)`` rotation matrices with columns
        ``[a_hat, b'_hat, a_hat x b'_hat]``.
    """
    a_sq_len = torch.sum(torch.square(a), dim=-1, keepdim=True)
    col_1 = a * safe_reciprocal(torch.sqrt(a_sq_len))
    a_dot_b = torch.sum(a * b, dim=-1, keepdim=True)
    b_prime = b - a * (a_dot_b * safe_reciprocal(a_sq_len))
    b_prime_len = torch.sqrt(torch.sum(torch.square(b_prime), dim=-1, keepdim=True))
    col_2 = b_prime * safe_reciprocal(b_prime_len)
    col_3 = torch.linalg.cross(col_1, col_2, dim=-1)
    return torch.stack([col_1, col_2, col_3], dim=-1)


def two_vector_rotation_jacobian(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Jacobians of every rotation-matrix entry with respect to both input
    vectors.

    :return: ``(dR_da, dR_db)``, each ``(..., 3, 3, 3)`` with
        ``dR_da[..., i, j, k] = d R[i, j] / d a[k]``.
    """
    batch = a.shape[:-1]
    jac = torch.func.vmap(torch.func.jacfwd(two_vector_rotation_matrix, argnums=(0, 1)))
    d_a, d_b = jac(a.reshape(-1, 3), b.reshape(-1, 3))
    return d_a.reshape(*batch, 3, 3, 3), d_b.reshape(*batch, 3, 3, 3)
