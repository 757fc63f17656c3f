"""Grid checkpoint and resume (port of ohm_tsd_slam_tpu/grid/checkpoint.py).

Equivalent of TsdGrid::storeGrid (src/obvision/reconstruct/grid/
TsdGrid.cpp:548-607) and the deserializing constructor
(TsdGrid.cpp:25-110): offline save and restore of the whole TSD field with
per-tile tags UNINITIALIZED(0) / EMPTY(1) / CONTENT(2) (TsdGrid.h:33-35).

Two codecs:
  * npz: the grid's four arrays and its static fields as compressed numpy
    arrays, the same file the JAX package writes and reads, so a grid
    passes between the packages through it in either direction;
  * text: the reference's plain-text format (one value per line: cellSize,
    layoutPartition, layoutGrid, maxTruncation, then per tile its tag and
    the interleaved tsd/weight cells), written byte for byte as the JAX
    package writes it, so checkpoints interoperate with grids stored by the
    C++ implementation.
"""

from __future__ import annotations

import io
import math
from typing import Union

import numpy as np
import torch

from ohm_tsd_slam_tpu_torch.grid.state import TsdGrid
from ohm_tsd_slam_tpu_torch.utils.device import default_device

UNINITIALIZED = 0
EMPTY = 1
CONTENT = 2


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _grid(tsd, weight, tile_init, tile_initw, dtype, device, **static):
    return TsdGrid(
        tsd=torch.as_tensor(tsd, dtype=dtype).to(device),
        weight=torch.as_tensor(weight, dtype=dtype).to(device),
        tile_init=torch.as_tensor(tile_init, dtype=torch.bool).to(device),
        tile_initw=torch.as_tensor(tile_initw, dtype=dtype).to(device),
        **static)


# ---------------------------------------------------------------------------
# npz codec
# ---------------------------------------------------------------------------

def save_npz(grid: TsdGrid, path: str) -> None:
    """Write the grid as a compressed npz checkpoint."""
    np.savez_compressed(
        path,
        tsd=_host(grid.tsd),
        weight=_host(grid.weight),
        tile_init=_host(grid.tile_init),
        tile_initw=_host(grid.tile_initw),
        meta=np.array([grid.cell_size, grid.max_truncation,
                       grid.max_weight, float(grid.tile_dim)]),
    )


def load_npz(path: str, dtype=torch.float32, device=None) -> TsdGrid:
    """The grid of a save_npz checkpoint (of either package), on
    `device`: None is the card (utils/device.py::default_device)."""
    device = default_device(device, "load_npz")
    with np.load(path) as z:
        cell_size, max_trunc, max_weight, tile_dim = z["meta"]
        return _grid(z["tsd"], z["weight"], z["tile_init"], z["tile_initw"],
                     dtype, device, cell_size=float(cell_size),
                     max_truncation=float(max_trunc),
                     max_weight=float(max_weight), tile_dim=int(tile_dim))


# ---------------------------------------------------------------------------
# reference text codec
# ---------------------------------------------------------------------------

def save_text(grid: TsdGrid, path: str) -> None:
    """TsdGrid::storeGrid (TsdGrid.cpp:548-607): one value per line:
    cellSize, layoutPartition (log2 tile dim), layoutGrid (log2 cells per
    side), maxTruncation; then per tile (row-major, y outer): the tag,
    followed by initWeight (EMPTY) or the interleaved tsd/weight cell
    values (CONTENT, row-major within the tile)."""
    tsd = _host(grid.tsd)
    weight = _host(grid.weight)
    init = _host(grid.tile_init)
    initw = _host(grid.tile_initw)
    p = grid.tile_dim
    out = io.StringIO()
    out.write(f"{grid.cell_size}\n{int(math.log2(p))}\n"
              f"{int(math.log2(grid.cells_x))}\n{grid.max_truncation}\n")
    for ty in range(grid.tiles_y):
        for tx in range(grid.tiles_x):
            if init[ty, tx]:
                out.write(f"{CONTENT}\n")
                block = np.stack(
                    [tsd[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p],
                     weight[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p]],
                    axis=-1).reshape(-1)
                out.write("\n".join(repr(float(v)) for v in block))
                out.write("\n")
            elif initw[ty, tx] > 0.0:
                out.write(f"{EMPTY}\n{float(initw[ty, tx])!r}\n")
            else:
                out.write(f"{UNINITIALIZED}\n")
    with open(path, "w") as f:
        f.write(out.getvalue())


def load_text(source: Union[str, io.TextIOBase], dtype=torch.float32,
              from_string: bool = False, max_weight: float = 32.0,
              device=None) -> TsdGrid:
    """The TsdGrid(data, FILE_SOURCE|STRING_SOURCE) constructor
    (TsdGrid.cpp:25-110), on `device`: None is the card
    (utils/device.py::default_device).  `from_string` mirrors
    STRING_SOURCE."""
    device = default_device(device, "load_text")
    if isinstance(source, str) and not from_string:
        with open(source) as f:
            tokens = f.read().split()
    elif isinstance(source, str):
        tokens = source.split()
    else:
        tokens = source.read().split()
    it = iter(tokens)

    cell_size = float(next(it))
    layout_partition = int(next(it))
    layout_grid = int(next(it))
    if not (0 <= layout_partition <= 15 and 0 <= layout_grid <= 15):
        raise ValueError("Partition or grid layout invalid")  # TsdGrid.cpp:56-62
    max_trunc = float(next(it))

    p = 2 ** layout_partition
    h = w = 2 ** layout_grid
    tiles = h // p
    tsd = np.full((h, w), np.nan, np.float64)
    weight = np.zeros((h, w), np.float64)
    tile_init = np.zeros((tiles, tiles), bool)
    tile_initw = np.zeros((tiles, tiles), np.float64)

    for ty in range(tiles):
        for tx in range(tiles):
            tag = int(next(it))
            if tag == UNINITIALIZED:
                continue
            if tag == EMPTY:
                # clamped at TSDGRIDMAXWEIGHT on load (TsdGrid.cpp:84-85)
                tile_initw[ty, tx] = min(float(next(it)), max_weight)
            elif tag == CONTENT:
                tile_init[ty, tx] = True
                vals = np.fromiter(
                    (float(next(it)) for _ in range(2 * p * p)),
                    np.float64, 2 * p * p).reshape(p, p, 2)
                tsd[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p] = vals[..., 0]
                weight[ty * p:(ty + 1) * p, tx * p:(tx + 1) * p] = vals[..., 1]
            else:
                raise ValueError(f"Unknown partition identifier {tag}")

    return _grid(tsd, weight, tile_init, tile_initw, dtype, device,
                 cell_size=cell_size, max_truncation=max_trunc,
                 max_weight=max_weight, tile_dim=p)
