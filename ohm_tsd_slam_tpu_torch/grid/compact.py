"""Fixed-capacity mask compaction (port of ohm_tsd_slam_tpu/grid/compact.py).

The JAX module compacts with a per-128-lane butterfly and a one-hot pick
because XLA's scatter and gather are serial on a TPU.  Here compaction is
an inclusive cumsum of the mask plus one gather: output slot j reads the
lane where the running count first reaches j + 1 (`torch.searchsorted` on
the cumsum).  Nothing is read back to the host (no `torch.nonzero`, no
boolean indexing), capacities are fixed, and a value channel passes
through a gather untouched, NaN and Inf included: the JAX module's one-hot
pick and one-hot pack multiply 0 by the other lanes' values, so a NaN or
Inf channel poisons unrelated slots there (ROADMAP.md queue 3).

Results are ordered by flat index, as torch.nonzero would give them.
"""

from __future__ import annotations

from typing import Tuple

import torch

CHUNK = 128


def compact_mask(mask: torch.Tensor, size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """First-`size` indices of True entries of a flat boolean mask.

    Returns (idx [K] int64 flat indices, ascending; 0 in invalid slots),
    (valid [K] bool)."""
    mask = mask.reshape(-1)
    n = mask.shape[0]
    incl = torch.cumsum(mask, 0, dtype=torch.int64)
    j = torch.arange(size, dtype=torch.int64, device=mask.device)
    valid = j < incl[-1]
    src = torch.searchsorted(incl, j + 1).clamp_(max=n - 1)
    return torch.where(valid, src, 0), valid


def pack_channels_rows(mask: torch.Tensor, channels, size: int):
    """Order-preserving channel pack, the output layout of
    ohm_tsd_slam_tpu/ops/pack_rows_pallas.py::pack_channels_rows_pallas.

    Args:
      mask: flat bool or float (set where > 0), length % 128 == 0.
      channels: tuple of flat float tensors like mask.
      size: output capacity (multiple of 128).
    Returns:
      (packed [n_chan + 1, size + 128] in the channels' dtype (float32
      for the Pallas kernel's layout): the channels of the set lanes in
      flat order, then a 1.0/0.0 validity row, zeros after the last set
      lane; count int32 = total set lanes, possibly > size + 128,
      whose entries beyond the capacity are dropped).
    """
    n = mask.shape[0]
    assert n % CHUNK == 0, n
    assert size % CHUNK == 0, size
    m = mask.reshape(-1) > 0
    idx, valid = compact_mask(m, size + CHUNK)
    rows = [torch.where(valid, c.reshape(-1)[idx], 0) for c in channels]
    rows.append(valid.to(rows[0].dtype))
    return torch.stack(rows), m.sum(dtype=torch.int32)
