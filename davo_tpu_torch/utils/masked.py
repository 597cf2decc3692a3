"""Mask-algebra helpers for lockstep batched optimisation.

The port of ``davo_tpu/utils/masked.py``: every batch element runs
full-width and ``torch.where`` merges select what each element keeps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["broadcast_mask", "masked_update", "masked_update_tree", "masked_merge_tensors"]


def broadcast_mask(mask: torch.Tensor, target_ndim: int) -> torch.Tensor:
    """Append singleton dims to ``mask`` until it has ``target_ndim`` dims."""
    while mask.ndim < target_ndim:
        mask = mask[..., None]
    return mask


def masked_update(current: torch.Tensor, new: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``new`` where ``mask`` else ``current``; mask broadcasts over trailing dims."""
    return torch.where(broadcast_mask(mask, current.ndim), new, current)


def masked_update_tree(current: dict, new: dict, mask: torch.Tensor) -> dict:
    """Apply :func:`masked_update` to every entry of matching dicts."""
    return {k: masked_update(current[k], new[k], mask) for k in current}


def masked_merge_tensors(
    values_1: Optional[torch.Tensor],
    mask_1: Optional[torch.Tensor],
    values_2: Optional[torch.Tensor],
    mask_2: Optional[torch.Tensor],
    update_mask: torch.Tensor,
) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """Merge two optional cached tensors with optional validity masks.

    Selects ``values_2`` where ``update_mask`` holds and ``values_1``
    elsewhere; returns the merged values and a validity mask (``None`` if
    every merged entry is valid).
    """
    if values_1 is None and values_2 is None:
        return None, None
    if values_1 is not None and values_2 is not None:
        merged = masked_update(values_1, values_2, update_mask)
        if mask_1 is None and mask_2 is None:
            return merged, None
        if mask_1 is not None and mask_2 is not None:
            return merged, torch.where(update_mask, mask_2, mask_1)
        if mask_1 is not None:
            return merged, mask_1 | update_mask
        return merged, mask_2 | ~update_mask
    if values_1 is not None:
        if mask_1 is not None:
            return values_1, mask_1 & ~update_mask
        return values_1, ~update_mask
    if mask_2 is not None:
        return values_2, mask_2 & update_mask
    return values_2, update_mask
