"""The least time one H100 could take for a kernel's work: the larger of
the bytes it must move over the HBM rate and its operations over the
float32 rate (NVIDIA's data sheet for the SXM part at its full 700 W).

Bytes count each input the work needs once and each output once; the
operations per element are counted from the kernels' sources, roughly.
These are the push and kernel A rows of the port's
tools/torch_kernel_times.py (its `bound`), whose bounds follow from the
grid's shape alone.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOP_PER_S) * 1e3


def push_ms(cells_per_side: int, beams: int, tile_dim: int = 32) -> float:
    """csrc/push.cu, out of place: tsd and weight of the whole grid read
    and written (an inactive tile is copied through), the ranges and their
    mask, the two tile arrays in and out; ~60 operations a cell of an
    active tile (atan2, bin, running average), ~150 a tile for the cull
    and 4 a beam for its spans.  Counted with every tile active, the push
    is still bound by its bytes."""
    cells = cells_per_side ** 2
    tiles = cells // tile_dim ** 2
    return bound_ms(cells * 16 + beams * 5 + tiles * 10,
                    tiles * tile_dim ** 2 * 60 + tiles * 150 + beams * 4)


def segment_layers_ms(cells_per_side: int) -> float:
    """csrc/segment_layers.cu (kernel A): the field read, the 4-layer
    mask and the row counts (4 layers, a row of 128 lanes) written; ~40
    operations a cell."""
    cells = cells_per_side ** 2
    rows = 4 * cells // 128
    return bound_ms(cells * 4 + 4 * cells * 4 + rows * 4, cells * 40)
