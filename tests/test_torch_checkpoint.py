"""The port's grid checkpoints (ohm_tsd_slam_tpu_torch/grid/checkpoint.py)
against the JAX package's (ohm_tsd_slam_tpu/grid/checkpoint.py), on the
CPU.

A grid pushed by the port from a seeded scan goes through both packages'
codecs: npz files written by one package load in the other with every
array equal (float32 and float64), so a JAX grid becomes a port grid
through the file; the reference-format text file the port writes is
byte-equal to the JAX package's; the compiled reference's own store of the
golden room (golden/data/room_store.txt) loads in the port to the arrays
the JAX package loads, every value equal.  The round trips and the
reader's error cases of tests/test_aux.py run on the port."""

import io
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.grid import checkpoint as jck
from ohm_tsd_slam_tpu_torch.config import GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid import checkpoint as tck
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create
from ohm_tsd_slam_tpu_torch.sensor import polar2d
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

from golden_io import ROOM_STORE

limit_cpu_threads()

FIELDS = ("tsd", "weight", "tile_init", "tile_initw")
STATIC = ("cell_size", "max_truncation", "max_weight", "tile_dim")
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float64": (torch.float64, jnp.float64)}


def _grid(dtype):
    """tests/test_aux.py's pushed grid (map_size 7, 0.08 m, 16-cell
    tiles), pushed by the port: one scan of the 10 m room, then an
    all-masked scan from outside the walls so some tiles are EMPTY."""
    geom = polar2d.SensorPolar2D(size=361, angular_res=math.radians(0.75),
                                 phi_min=math.radians(-135.0),
                                 max_range=15.0)
    g = create(GridConfig(map_size=7, cellsize=0.08, tile_dim=16),
               dtype=dtype, device="cpu")
    pose = se2.make(5.0, 5.0, 0.2, dtype=dtype)
    r = simulate_scan(pose.double().numpy(), geom.size, geom.angular_res,
                      geom.phi_min, geom.max_range,
                      segments=rect_walls(1.0, 1.0, 9.0, 9.0))
    data, mask = polar2d.standard_mask(geom, torch.as_tensor(r, dtype=dtype))
    return push(g, geom, pose, data, mask)


def _assert_same(got, want):
    """Every array and static field equal (NaN where the other has NaN)."""
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    for f in STATIC:
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_npz_both_ways(tmp_path, dtype):
    tdt, jdt = DTYPES[dtype]
    g = _grid(tdt)
    assert bool(g.tile_init.any()) and bool((g.tile_initw > 0).any())
    path = str(tmp_path / "port.npz")
    tck.save_npz(g, path)
    jg = jck.load_npz(path, dtype=jdt)          # port -> JAX
    _assert_same(jg, g)
    assert jg.tsd.dtype == jdt
    jpath = str(tmp_path / "jax.npz")
    jck.save_npz(jg, jpath)
    back = tck.load_npz(jpath, dtype=tdt, device="cpu")   # JAX -> port
    _assert_same(back, g)
    assert back.tsd.dtype == tdt and back.tile_init.dtype == torch.bool
    # the two packages write the same arrays under the same names
    with np.load(path) as a, np.load(jpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_text_is_byte_equal_to_jax(tmp_path, dtype):
    tdt, jdt = DTYPES[dtype]
    g = _grid(tdt)
    path, jpath = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    tck.save_text(g, path)
    jck.save_text(jck.load_npz(_npz(tmp_path, g), dtype=jdt), jpath)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        got, want = a.read(), b.read()
    assert got == want
    tags = got.split(b"\n")[4:]
    assert tags.count(b"2") > 0 and tags.count(b"1") > 0   # CONTENT, EMPTY


def _npz(tmp_path, g):
    path = str(tmp_path / "g.npz")
    tck.save_npz(g, path)
    return path


def test_text_round_trip_and_header(tmp_path):
    """tests/test_aux.py's text checks on the port: the round trip within
    the text's precision, the header lines."""
    g = _grid(torch.float32)
    path = str(tmp_path / "grid.txt")
    tck.save_text(g, path)
    g2 = tck.load_text(path, device="cpu")
    np.testing.assert_allclose(g.tsd.numpy(), g2.tsd.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(g.weight.numpy(), g2.weight.numpy(),
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(g.tile_init, g2.tile_init)
    assert g2.cell_size == g.cell_size and g2.tile_dim == 16
    head = open(path).read().split("\n")[:4]
    assert float(head[0]) == pytest.approx(0.08)
    assert head[1:3] == ["4", "7"]
    # STRING_SOURCE and a file object read the same grid
    text = open(path).read()
    for src in (tck.load_text(text, from_string=True, device="cpu"),
                tck.load_text(io.StringIO(text), device="cpu")):
        _assert_same(src, g2)


def test_text_rejects_a_bad_layout():
    with pytest.raises(ValueError, match="layout"):
        tck.load_text("0.05\n16\n7\n0.1\n", from_string=True,
                      device="cpu")
    with pytest.raises(ValueError, match="identifier"):
        tck.load_text("0.05\n0\n1\n0.1\n7\n", from_string=True,
                      device="cpu")


@pytest.mark.skipif(not os.path.exists(ROOM_STORE),
                    reason="golden data not generated (make -C golden)")
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_store_loads_as_jax_loads_it(dtype):
    tdt, jdt = DTYPES[dtype]
    got = tck.load_text(ROOM_STORE, dtype=tdt, device="cpu")
    want = jck.load_text(ROOM_STORE, dtype=jdt)
    _assert_same(got, want)
    assert int(got.tile_init.sum()) > 0
    assert got.tsd.dtype == tdt


def test_load_on_a_device_and_save_from_it(tmp_path):
    """load_npz puts the grid where it is asked to; save_npz reads a grid
    back from wherever it lies (the CPU here)."""
    g = _grid(torch.float64)
    path = _npz(tmp_path, g)
    g2 = tck.load_npz(path, dtype=torch.float64, device="cpu")
    assert g2.tsd.device.type == "cpu"
    _assert_same(g2, g)


@pytest.mark.parametrize("codec", ["npz", "text"])
def test_load_defaults_to_the_card(tmp_path, codec):
    """Without a device load_npz and load_text go to the card, and say so
    where there is none rather than falling back to the CPU; with "cpu"
    named they build the grid there."""
    g = _grid(torch.float64)
    if codec == "npz":
        path, load = _npz(tmp_path, g), tck.load_npz
    else:
        path, load = str(tmp_path / "g.txt"), tck.load_text
        tck.save_text(g, path)
    if torch.cuda.is_available():
        assert load(path).tsd.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            load(path)
    assert load(path, device="cpu").tsd.device.type == "cpu"
