"""The port's fixed-capacity compaction (ohm_tsd_slam_tpu_torch/grid/
compact.py) against the JAX package's: compact_mask and the channels of
pack_channels_rows against its compact_mask_values (gather path),
pack_channels_rows against the Pallas pack kernel and against the Pallas
compaction kernel (compact_channels_pallas, whose counterpart on the card
is csrc/compact_channels.cu with pack_channels_rows as its twin), both in
interpret mode.  Inputs are numpy from a seed; results must be bit-equal.

Channels carry NaN and Inf (ROADMAP.md queue 3): the port passes them
through untouched, where the JAX package's one-hot pick and one-hot pack
multiply 0 by them and poison other slots.  So NaN and Inf at SET lanes
are held against the JAX gather path, which moves values without
arithmetic; at unset lanes the pack kernel masks them and is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.grid import compact as jcompact
from ohm_tsd_slam_tpu.ops.compact_pallas import (
    R_BLK,
    compact_channels_pallas,
)
from ohm_tsd_slam_tpu.ops.pack_rows_pallas import pack_channels_rows_pallas
from ohm_tsd_slam_tpu_torch.grid import compact
from ohm_tsd_slam_tpu_torch.ops.compact_channels_cuda import compact_channels

CHUNK = 128


def _channels(rng, n, mask, special):
    """Four float32 channels; `special` puts NaN/Inf at set ('set') or
    unset ('unset') lanes, or nowhere (None)."""
    chans = [rng.normal(size=n).astype(np.float32) for _ in range(4)]
    if special is not None:
        lanes = np.flatnonzero(mask if special == "set" else ~mask)
        pick = rng.choice(lanes, size=min(len(lanes), 12), replace=False)
        for c, v in zip(chans, (np.nan, np.inf, -np.inf, np.nan)):
            c[pick] = v
    return chans


@pytest.mark.parametrize("seed,density,size", [
    (0, 0.01, 512), (1, 0.2, 256), (2, 0.5, 4096), (3, 0.0, 128),
    (4, 1.0, 1024)])
def test_compact_and_pack_match_jax_values(seed, density, size):
    """The slots of compact_mask and the first `size` channel slots of
    pack_channels_rows equal JAX compact_mask_values', NaN and Inf at set
    lanes included."""
    rng = np.random.default_rng(seed)
    n = 64 * CHUNK
    mask = rng.random(n) < density
    chans = _channels(rng, n, mask, "set" if density > 0 else None)
    jidx, jvals, jvalid = jcompact.compact_mask_values(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in chans), size)
    idx, valid = compact.compact_mask(torch.from_numpy(mask), size)
    packed, _ = compact.pack_channels_rows(
        torch.from_numpy(mask), tuple(torch.from_numpy(c) for c in chans),
        size)
    v = valid.numpy()
    np.testing.assert_array_equal(v, np.asarray(jvalid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert not idx.numpy()[~v].any()
    for got, want in zip(packed[:4, :size].numpy(), jvals):
        # the JAX gather path leaves its pick in invalid slots; the port
        # zeroes them
        np.testing.assert_array_equal(got[v], np.asarray(want)[v])
        assert not got[~v].any()
    if density > 0:
        assert np.isnan(packed[0].numpy()).any()  # NaN carried, not spread
        assert np.isnan(packed[0].numpy()).sum() <= 12


def test_compact_mask_matches_jax_and_keeps_first_k():
    rng = np.random.default_rng(5)
    n = 32 * CHUNK
    mask = rng.random(n) < 0.3
    for size in (64, 1024, n):
        jidx, jvalid = jcompact.compact_mask(jnp.asarray(mask), size)
        idx, valid = compact.compact_mask(torch.from_numpy(mask), size)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
        want = np.flatnonzero(mask)[:size]
        np.testing.assert_array_equal(idx.numpy()[:len(want)], want)


@pytest.mark.parametrize("density,size,special", [
    (0.02, 1024, None), (0.3, 512, None), (0.0, 256, None),
    (0.05, 2048, "unset"), (0.3, 1024, "unset")])
def test_pack_channels_rows_matches_pallas_kernel(density, size, special):
    """Bit-equal to pack_channels_rows_pallas (interpret mode), overflow
    included: count is the total of set lanes, the pack keeps the first
    size + 128."""
    rng = np.random.default_rng(int(density * 100) + size)
    n = 128 * CHUNK
    mask = rng.random(n) < density
    chans = _channels(rng, n, mask, special)
    want, jcnt = pack_channels_rows_pallas(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in chans), size,
        interpret=True)
    got, cnt = compact.pack_channels_rows(
        torch.from_numpy(mask), tuple(torch.from_numpy(c) for c in chans),
        size)
    assert int(cnt) == int(jcnt) == int(mask.sum())
    assert got.dtype == torch.float32 and got.shape == (5, size + CHUNK)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pack_channels_rows_carries_nan_and_inf():
    """NaN/Inf at set lanes land in their own slots only."""
    rng = np.random.default_rng(7)
    n = 128 * CHUNK
    mask = rng.random(n) < 0.05
    size = 1024
    chans = _channels(rng, n, mask, "set")
    got, cnt = compact.pack_channels_rows(
        torch.from_numpy(mask), tuple(torch.from_numpy(c) for c in chans),
        size)
    _, jvals, jvalid = jcompact.compact_mask_values(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in chans),
        size + CHUNK)
    v = np.asarray(jvalid)
    for row, want in zip(got.numpy()[:4], jvals):
        np.testing.assert_array_equal(row[v], np.asarray(want)[v])
        assert not row[~v].any()
    np.testing.assert_array_equal(got.numpy()[4], v.astype(np.float32))
    assert int(cnt) == int(mask.sum())
    # the JAX package's one-hot pack spreads the NaN to other slots
    jpack, _ = jcompact.pack_channels_rows(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in chans), size)
    assert (np.isnan(np.asarray(jpack[0]))
            > np.isnan(got.numpy()[0])).any()


@pytest.mark.parametrize("density,size,special", [
    (0.002, 512, None), (0.0, 256, None), (0.01, 256, None),
    (0.004, 1024, "unset")])
def test_pack_channels_rows_matches_compact_pallas_kernel(density, size,
                                                          special):
    """Kernel E's twin against the TPU kernel it stands for
    (compact_channels_pallas, interpret mode) at the smallest n its assert
    allows: the count of set lanes, and the first `size` columns bit for
    bit, overflow included (the third case)."""
    rng = np.random.default_rng(int(density * 1000) + size)
    n = R_BLK * CHUNK
    mask = rng.random(n) < density
    chans = _channels(rng, n, mask, special)
    want, jcnt = compact_channels_pallas(
        jnp.asarray(mask), tuple(jnp.asarray(c) for c in chans), size,
        interpret=True)
    got, cnt = compact.pack_channels_rows(
        torch.from_numpy(mask), tuple(torch.from_numpy(c) for c in chans),
        size)
    assert int(cnt) == int(jcnt) == int(mask.sum())
    assert got.shape == np.asarray(want).shape == (5, size + CHUNK)
    np.testing.assert_array_equal(
        got.numpy()[:, :size].view(np.int32),
        np.asarray(want)[:, :size].view(np.int32))
    if density == 0.01:
        assert int(cnt) > size + CHUNK


@pytest.mark.parametrize("as_float", [False, True])
def test_compact_channels_wrapper_runs_the_twin_on_cpu(as_float):
    """On CPU tensors the wrapper of kernel E is its twin, for a bool and
    for a float 0/1 mask, any n % 128 == 0, NaN and Inf carried in their
    own slots; no launch is counted."""
    rng = np.random.default_rng(9)
    n = 16384                             # a 64^2 grid's layer stack
    mask = rng.random(n) < 0.05
    chans = tuple(torch.from_numpy(c)
                  for c in _channels(rng, n, mask, "set"))
    m = torch.from_numpy(mask)
    before = compact_channels.launches
    got, cnt = compact_channels(m.float() if as_float else m, chans, 512)
    want, wcnt = compact.pack_channels_rows(m, chans, 512)
    assert compact_channels.launches == before
    assert int(cnt) == int(wcnt) == int(mask.sum()) > 512 + CHUNK
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    lanes = np.flatnonzero(mask)[:512 + CHUNK]
    np.testing.assert_array_equal(
        got[0].numpy().view(np.int32),
        chans[0].numpy()[lanes].view(np.int32))
    assert torch.isnan(got[0]).any()
