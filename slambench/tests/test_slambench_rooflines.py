"""The push and kernel A bounds at the cells' 1024² grid are the port's
PERF.md kernel table's (tools/torch_kernel_times.py::bound)."""

from __future__ import annotations

from slambench import rooflines


def test_bounds_at_1024():
    assert round(rooflines.push_ms(1024, 1081), 6) == 0.005013
    assert round(rooflines.segment_layers_ms(1024), 6) == 0.006299


def test_the_push_is_bound_by_its_bytes_with_every_tile_active():
    cells = 1024 * 1024
    by_bytes = rooflines.bound_ms(cells * 16 + 1081 * 5 + 1024 * 10, 0)
    assert rooflines.push_ms(1024, 1081) == by_bytes
