"""ICP's pair assignment on the CPU: registration/nn.py::assign_pairs_fused
runs its plain twin assign_pairs_plain there (the kernel of
csrc/assign_pairs.cu runs only on the card: tests/test_torch_assign_cuda.py
holds it against the twin there).  Torch and numpy only.

Asserted: the CPU dispatch returns the twin's outputs in every bit and
launches nothing; the twin's edge cases that the kernel reproduces (the
first of equal minima, a NaN row's index M - 1, a row of +inf's index 0,
the reciprocal rule's least scene index); the wrapper's argument checks;
and the kernel's column key ((bits of a distance) << 32 | scene index)
ordering as (distance, scene index) do.
"""

import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu_torch.ops.assign_pairs_cuda import (
    assign_pairs,
    check_inputs,
)
from ohm_tsd_slam_tpu_torch.registration import nn
from ohm_tsd_slam_tpu_torch.utils.testing import limit_cpu_threads

limit_cpu_threads()


def _same(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.numpy().tobytes() == b.numpy().tobytes())


def _inputs(dtype, S=300, M=250, K=2, seed=3):
    rng = np.random.default_rng(seed)
    model = rng.uniform(-5.0, 5.0, (M, 2))
    n = min(S, M) * 3 // 4
    scene = np.concatenate([model[:n] + rng.normal(0, 0.05, (n, 2)),
                            rng.uniform(-5.0, 5.0, (S - n, 2))])
    payload = np.concatenate([model, rng.normal(size=(M, K - 2))], 1)
    t = [torch.from_numpy(a).to(dtype) for a in (model, scene, payload)]
    return (t[0], torch.from_numpy(rng.random(M) < 0.9), t[1],
            torch.from_numpy(rng.random(S) < 0.9), t[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("K", [2, 4])
@pytest.mark.parametrize("reciprocal", [True, False])
@pytest.mark.parametrize("gate", ["none", "number", "tensor"])
def test_fused_on_the_cpu_is_the_twin(dtype, K, reciprocal, gate):
    args = _inputs(dtype, K=K)
    thresh2 = {"none": None, "number": 0.02,
               "tensor": torch.tensor(0.02, dtype=dtype)}[gate]
    n0 = assign_pairs.launches
    got = nn.assign_pairs_fused(*args, thresh2=thresh2,
                                use_reciprocal=reciprocal)
    want = nn.assign_pairs_plain(*args, thresh2=thresh2,
                                 use_reciprocal=reciprocal)
    assert assign_pairs.launches == n0          # nothing launched
    for x, y in zip(got, want):
        assert _same(x, y)
    assert got[0].dtype == torch.int32 and got[2].dtype == torch.bool
    assert got[3].shape == (300, K) and int(got[2].sum()) > 50


def test_twin_edge_cases_the_kernel_reproduces():
    inf, nan = float("inf"), float("nan")
    model = torch.tensor([[1.0, 1.0], [2.0, 0.0], [1.0, 1.0], [-2.0, 1.0]])
    scene = torch.tensor([[1.25, 1.0], [0.75, 1.0], [nan, 0.0],
                          [-2.0, 1.5], [-2.0, 0.5], [1.0, 1.0]])
    smask = torch.ones(6, dtype=torch.bool)
    mmask = torch.ones(4, dtype=torch.bool)
    idx, d2, pm, paired = nn.assign_pairs_plain(model, mmask, scene, smask,
                                                model, thresh2=1.0)
    # equal minima: the first index; a NaN row: index M - 1, dist2 NaN
    assert idx.tolist() == [0, 0, 3, 3, 3, 0]
    assert torch.isnan(d2[2]) and not pm[2]
    # the reciprocal rule: column 0 to scene 5 (distance 0), column 3 to
    # scene 3 (the lesser scene index of two equal distances)
    assert pm.tolist() == [False, False, False, True, False, True]
    assert not paired[~pm].any() and torch.equal(paired[5], model[0])
    # every model point masked: rows of +inf, index 0, no pair
    idx, d2, pm, _ = nn.assign_pairs_plain(
        model, torch.zeros(4, dtype=torch.bool), scene, smask, model)
    assert idx.tolist() == [0] * 6 and not pm.any()
    assert torch.isinf(d2[[0, 1, 3, 4, 5]]).all()
    assert d2[2] == inf             # the masked columns hide the NaN


def test_check_inputs():
    model, mmask, scene, smask, payload = _inputs(torch.float32, K=4)
    out = check_inputs(model, mmask, scene, smask, payload, 0.3)
    assert out[-1].shape == () and out[-1].dtype == torch.float32
    assert float(out[-1]) == float(torch.tensor(0.3, dtype=torch.float32))
    assert check_inputs(model, mmask, scene, smask, payload)[-1] is None
    gate = check_inputs(model, mmask, scene, smask, payload,
                        torch.tensor([0.5], dtype=torch.float64))[-1]
    assert gate.shape == () and gate.dtype == torch.float32
    # a strided view is made contiguous
    wide = torch.cat([scene, scene], 1)[:, 1:3]
    assert not wide.is_contiguous()
    assert check_inputs(model, mmask, wide, smask, payload)[2].is_contiguous()
    bad = [
        (model.double(), mmask, scene, smask, payload, None),
        (model, mmask, scene.half(), smask, payload.half(), None),
        (model, mmask.float(), scene, smask, payload, None),
        (model, mmask, scene, smask[:-1], payload, None),
        (model[:, :1], mmask, scene, smask, payload, None),
        (model, mmask, scene, smask, payload[:-1], None),
        (model, mmask, scene, smask, payload[:, 0], None),
        (model, mmask, scene[:0], smask[:0], payload, None),
        (model, mmask, scene, smask, payload, torch.ones(2)),
        (model, mmask, scene, smask, payload, "0.3"),
    ]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            check_inputs(*args)


def test_column_key_orders_as_distance_then_scene_index():
    # the float32 kernel's reciprocal rule takes one 64-bit atomicMin of
    # (float bits of best) << 32 | s: for finite best >= 0 the least key
    # is the least best and, among equal bests, the least s
    rng = np.random.default_rng(5)
    best = np.concatenate([rng.choice(np.float32([0.0, 1e-30, 0.25, 3.0]),
                                      200),
                           rng.uniform(0, 4, 200).astype(np.float32),
                           np.float32([np.finfo(np.float32).max, 1e-45])])
    s = rng.permutation(len(best)).astype(np.uint64)
    key = (best.view(np.uint32).astype(np.uint64) << np.uint64(32)) | s
    by_key = np.argsort(key, kind="stable")
    by_pair = np.lexsort((s, best))
    assert (by_key == by_pair).all()
