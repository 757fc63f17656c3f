"""The port's RANSAC matchers (ohm_tsd_slam_tpu_torch/registration/
ransac.py) against the JAX package's, in float64 on the CPU.

The two packages cannot draw the same numbers (threefry against torch's
generators), so every comparison hands both the same draws through
`RansacInject`: the subsample, control set and trials that the JAX
package's own `subsample_mask` and `random_valid_subset` made from one key.
Clouds are simulated scans of the analytic room with 3 mm of numpy noise
from a seed; the TSD matcher reads a grid that the port pushed and both
packages load.  The port's own draws are tested for what they must have:
determinism under a seed, valid indices without repeats, the subsample
rule.

Tolerances: PCA normals, orientations and the candidate transforms within
1e-12 (the same closed forms; the libraries may round sin, cos, atan2 and
a sum's order differently in the last bits), every mask, index and count
equal, raw candidate scores and the winning transform within 1e-9, the
bound tests/test_reference_parity_ransac.py holds the JAX matchers to."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ohm_tsd_slam_tpu.config import BeamModelConfig as JBeamModelConfig
from ohm_tsd_slam_tpu.grid.state import TsdGrid as JTsdGrid
from ohm_tsd_slam_tpu.registration import ransac as jr
from ohm_tsd_slam_tpu_torch.config import BeamModelConfig, GridConfig
from ohm_tsd_slam_tpu_torch.core import se2
from ohm_tsd_slam_tpu_torch.grid.push import push
from ohm_tsd_slam_tpu_torch.grid.state import create, to_arrays
from ohm_tsd_slam_tpu_torch.registration import ransac as tr
from ohm_tsd_slam_tpu_torch.sensor import polar2d as tpolar
from ohm_tsd_slam_tpu_torch.utils.testing import (
    limit_cpu_threads,
    rect_walls,
    simulate_scan,
)

limit_cpu_threads()

F64 = torch.float64
TOL = 1e-12          # closed forms, float64 on both sides
SCORE_TOL = 1e-9     # candidate scores and the winning transform

GEOM = dict(size=361, angular_res=math.radians(0.75),
            phi_min=math.radians(-135.0), max_range=9.0,
            min_range=0.01, low_reflectivity_range=1.0)
PARAMS = dict(trials=20, size_control_set=40, resolution=GEOM["angular_res"])
POSE_M = (5.12, 5.12, 0.2)
POSE_S = (5.2, 5.05, 0.26)
FIELDS = ("tsd", "weight", "tile_init", "tile_initw")


def _t(a):
    return torch.from_numpy(np.array(a))


def _ranges(xyt, rng=None):
    pose = se2.make(*xyt, dtype=F64).numpy()
    r = simulate_scan(pose, GEOM["size"], GEOM["angular_res"],
                      GEOM["phi_min"], GEOM["max_range"],
                      segments=rect_walls(1.5, 1.5, 8.5, 8.5),
                      circles=[((7.0, 7.2), 0.5), ((3.0, 7.5), 0.35)])
    if rng is not None:
        r = r + rng.normal(0.0, 0.003, r.shape)
    return r


def _cloud(ranges):
    geom = tpolar.SensorPolar2D(**GEOM)
    data, mask = tpolar.standard_mask(geom, _t(ranges))
    pts, pmask = tpolar.data_to_cartesian(geom, data, mask)
    return pts.numpy(), pmask.numpy()


@pytest.fixture(scope="module")
def case():
    """Model and scene clouds, the grid of the model scan in both
    packages, and the draws of the JAX package for key 7."""
    rng = np.random.default_rng(0)
    M, maskM = _cloud(_ranges(POSE_M, rng))
    S, maskS = _cloud(_ranges(POSE_S, rng))
    # a gap of invalid beams in each cloud
    maskM[40:52] = False
    maskS[200:209] = False

    geom = tpolar.SensorPolar2D(**GEOM)
    g = create(GridConfig(map_size=7, cellsize=0.08), dtype=F64,
               device="cpu")
    pose_m = se2.make(*POSE_M, dtype=F64)
    data, mask = tpolar.standard_mask(geom, _t(_ranges(POSE_M)))
    g = push(g, geom, pose_m, data, mask)
    d = to_arrays(g)
    jg = JTsdGrid(**{f: jnp.asarray(d[f]) for f in FIELDS},
                  cell_size=d["cell_size"],
                  max_truncation=d["max_truncation"],
                  max_weight=d["max_weight"], tile_dim=d["tile_dim"])

    jp = jr.RansacParams(**PARAMS)
    r = jp.pca_search_range // 2
    k_sub, k_trial, k_ctrl = jax.random.split(jax.random.PRNGKey(7), 3)
    sub = jr.subsample_mask(k_sub, jnp.asarray(maskS))
    _, msp = jr.pca_normals(jnp.asarray(S), jnp.asarray(maskS), r)
    c_idx, c_valid = jr.random_valid_subset(k_ctrl, msp & sub,
                                            jp.size_control_set)
    _, mmp = jr.pca_normals(jnp.asarray(M), jnp.asarray(maskM), r)
    t_idx, t_valid = jr.random_valid_subset(k_trial, mmp, jp.trials)
    assert int(sub.sum()) < int(maskS.sum())       # the subsample bit
    assert bool(c_valid.all()) and bool(t_valid.all())
    jinject = jr.RansacInject(sub, c_idx, c_valid, t_idx, t_valid)
    tinject = tr.RansacInject(*(_t(x) for x in jinject))
    return dict(M=M, maskM=maskM, S=S, maskS=maskS, grid=g, jgrid=jg,
                pose_m=pose_m, jinject=jinject, tinject=tinject, jp=jp,
                tp=tr.RansacParams(**PARAMS))


def _jclouds(c):
    return tuple(jnp.asarray(c[k]) for k in ("M", "maskM", "S", "maskS"))


def _tclouds(c):
    return tuple(_t(c[k]) for k in ("M", "maskM", "S", "maskS"))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ------------------------------------------------------------- base machinery

def _wall_cloud(kind):
    """Noise-free points of one straight wall, exactly collinear up to
    the rounding of r·cos φ: the degenerate PCA window (minor extent 0)
    that the noisy golden data never reaches."""
    phi = math.radians(-60.0) + math.radians(0.75) * np.arange(161)
    if kind == "wall_x":        # the wall x = 3: the scatter matrix's axis
        r = 3.0 / np.cos(phi)   # angle sits on atan2's branch cut
        return np.stack([r * np.cos(phi), r * np.sin(phi)], -1)
    n = np.array([math.cos(0.4), math.sin(0.4)])      # oblique wall
    r = 3.0 / (np.cos(phi) * n[0] + np.sin(phi) * n[1])
    return np.stack([r * np.cos(phi), r * np.sin(phi)], -1)


@pytest.mark.parametrize("kind", ["room_noisy", "wall_x", "wall_oblique",
                                  "sparse"])
def test_pca_normals_match_jax(case, kind):
    if kind == "room_noisy":
        pts, mask = case["M"], case["maskM"]
    elif kind == "sparse":
        pts = case["S"]
        mask = case["maskS"] & (np.random.default_rng(3).random(
            len(pts)) < 0.5)
    else:
        pts = _wall_cloud(kind)
        mask = np.ones(len(pts), bool)
    for r in (5, 10):
        jn, jm = jr.pca_normals(jnp.asarray(pts), jnp.asarray(mask), r)
        n, m = tr.pca_normals(_t(pts), _t(mask), r)
        _equal(m, jm)
        sel = np.asarray(jm)
        assert sel.sum() > 10
        _close(n.numpy()[sel], np.asarray(jn)[sel], TOL)
        _close(tr.calc_phi(n, m), jr.calc_phi(jn, jm), TOL)
        _close(tr.calc_phi(n, None).numpy()[sel],
               np.asarray(jr.calc_phi(jn, None))[sel], TOL)
    if kind.startswith("wall"):
        # every interior window is collinear and kept, the normal faces
        # the sensor
        assert m[10:-10].all()
        assert ((_t(pts) * n).sum(1)[m] < 0).all()


def test_prepare_matches_jax(case):
    """Every field of _Prep, with the JAX package's draws in both."""
    jprep = jr._prepare(jax.random.PRNGKey(0), *_jclouds(case), case["jp"],
                        case["jinject"])
    prep = tr._prepare(None, *_tclouds(case), case["tp"], case["tinject"])
    assert prep._fields == jprep._fields
    for name in ("cand_valid", "ctrl_mask", "mask_m", "ok", "t_idx"):
        _equal(getattr(prep, name), getattr(jprep, name))
    for name in ("phi_cand", "t_cand", "ctrl", "ctrl_phi", "phi_m",
                 "theta_min", "theta_max"):
        _close(getattr(prep, name), getattr(jprep, name), TOL)
    K = case["tp"].trials * 2 * case["tp"].span
    assert prep.phi_cand.shape == (K,) and prep.t_cand.shape == (K, 2)
    assert 50 < int(prep.cand_valid.sum()) < K
    assert bool(prep.ok)


def test_prepare_empty_model_gives_jax_frustum(case):
    """No valid model point: argmax of the all-false mask is 0 and `last`
    is n - 1 in both packages, and nothing is ok."""
    _, _, S, maskS = _tclouds(case)
    M = _t(case["M"])
    none = torch.zeros(len(M), dtype=torch.bool)
    prep = tr._prepare(None, M, none, S, maskS, case["tp"], case["tinject"])
    jprep = jr._prepare(jax.random.PRNGKey(0), jnp.asarray(case["M"]),
                        jnp.asarray(none.numpy()), jnp.asarray(case["S"]),
                        jnp.asarray(case["maskS"]), case["jp"],
                        case["jinject"])
    assert not bool(prep.ok) and not bool(jprep.ok)
    _close(prep.theta_min, jprep.theta_min, TOL)
    _close(prep.theta_max, jprep.theta_max, TOL)
    assert not prep.cand_valid.any()


# ------------------------------------------------------------------- matchers

def test_match_tsd_matches_jax(case):
    jfn = jax.jit(lambda g, p, M, mm, S, ms, inj: jr.match_tsd(
        jax.random.PRNGKey(0), g, p, M, mm, S, ms, case["jp"], inject=inj,
        return_scores=True))
    jT, jaux = jfn(case["jgrid"], jnp.asarray(case["pose_m"].numpy()),
                   *_jclouds(case), case["jinject"])
    T, aux = tr.match_tsd(None, case["grid"], case["pose_m"],
                          *_tclouds(case), case["tp"],
                          inject=case["tinject"], return_scores=True)
    _close(aux["logp_raw"], jaux["logp_raw"], SCORE_TOL)
    _close(aux["logp"], jaux["logp"], SCORE_TOL)
    _close(T, jT, SCORE_TOL)
    # the seed is a real transform, near the true scene -> model motion
    assert abs(float(T[0, 2])) + abs(float(T[1, 2])) > 1e-3
    assert math.hypot(float(T[0, 2]) - 0.064, float(T[1, 2]) + 0.085) < 0.15
    # the scores span hits and interpolation misses
    assert float(aux["logp_raw"].min()) < float(aux["logp_raw"].max()) - 1.0


def test_match_normal_matches_jax(case):
    jfn = jax.jit(lambda M, mm, S, ms, inj: jr.match_normal(
        jax.random.PRNGKey(0), M, mm, S, ms, case["jp"], inject=inj,
        return_scores=True))
    jT, jaux = jfn(*_jclouds(case), case["jinject"])
    T, aux = tr.match_normal(None, *_tclouds(case), case["tp"],
                             inject=case["tinject"], return_scores=True)
    for name in ("cnt", "max_cnt", "cnt_thresh"):
        _equal(aux[name], jaux[name])
    _close(aux["err_sum"], jaux["err_sum"], SCORE_TOL)
    _close(aux["ratio"], jaux["ratio"], SCORE_TOL)
    _close(T, jT, SCORE_TOL)
    assert int((aux["ratio"] > 0).sum()) > 5         # candidates qualified
    assert not torch.equal(T, torch.eye(3, dtype=F64))


def _pshort_knife_edge(prep, model):
    """Candidates with a control point whose range equals its nearest
    model point's to rounding.  A candidate maps one scene point exactly
    onto a model point, so where that scene point is in the control set
    the beam model's `s < m` switch of the short-reading term sits on a
    knife edge, and its side is the libraries' last bit (the JAX package
    itself takes different sides with and without jit)."""
    m_angle = torch.where(prep.mask_m, torch.atan2(model[:, 1], model[:, 0]),
                          1e9)
    m_dist = torch.sqrt((model * model).sum(1))
    st = tr._transform_ctrl(prep, prep.phi_cand, prep.t_cand)
    angle = torch.atan2(st[..., 1], st[..., 0])
    nn = (angle[..., None] - m_angle).abs().argmin(-1)
    gap = (torch.sqrt((st * st).sum(-1)) - m_dist[nn]).abs()
    return ((gap < 1e-9) & prep.ctrl_mask[None, :]).any(1).numpy()


@pytest.mark.parametrize("zshort", [0.0, 0.25])
def test_match_pdf_matches_jax(case, zshort):
    """With zshort = 0 the beam model is continuous where a control point
    lands on a model point, and every candidate's score and the winner
    agree.  With the short-reading term on, the candidates on its knife
    edge are left out of the comparison of scores (a few percent); the
    winner is none of them and agrees."""
    kw = dict(max_range=9.0, sig_hit=0.1, zshort=zshort)
    jfn = jax.jit(lambda M, mm, S, ms, inj: jr.match_pdf(
        jax.random.PRNGKey(0), M, mm, S, ms, case["jp"],
        JBeamModelConfig(**kw), inject=inj, return_scores=True))
    jT, jaux = jfn(*_jclouds(case), case["jinject"])
    T, aux = tr.match_pdf(None, *_tclouds(case), case["tp"],
                          BeamModelConfig(**kw), inject=case["tinject"],
                          return_scores=True)
    _equal(aux["fov_cnt"], jaux["fov_cnt"])
    _close(aux["c_gate"], jaux["c_gate"], TOL)
    keep = np.ones(len(aux["logp"]), bool)
    if zshort:
        keep = ~_pshort_knife_edge(aux["prep"], _t(case["M"]))
        assert 0.8 < keep.mean() < 1.0
    _close(aux["logp_raw"].numpy()[keep],
           np.asarray(jaux["logp_raw"])[keep], SCORE_TOL)
    _close(aux["logp"].numpy()[keep], np.asarray(jaux["logp"])[keep],
           SCORE_TOL)
    assert int((aux["logp"] > -1e8).sum()) > 5
    assert not torch.equal(T, torch.eye(3, dtype=F64))
    # neither package's winner sits on the knife edge, so the winners are
    # compared at both settings
    assert keep[int(aux["logp"].argmax())]
    assert keep[int(np.asarray(jaux["logp"]).argmax())]
    _close(T, jT, SCORE_TOL)


def test_beam_model_log_prob_matches_jax():
    rng = np.random.default_rng(5)
    m = rng.uniform(0.0, 12.0, 4000)
    s = rng.uniform(0.0, 12.0, 4000)
    m[:50] = 0.0
    s[50:100] = 9.0                      # at max_range exactly
    for kw in (dict(max_range=9.0), dict(max_range=9.0, zphi=0.1),
               dict(max_range=9.0, zrand=0.0, zmax=0.0, zshort=0.0,
                    sig_hit=0.01)):     # p underflows to 0: the -1e9 term
        got = tr.beam_model_log_prob(_t(m), _t(s), BeamModelConfig(**kw))
        want = jr.beam_model_log_prob(jnp.asarray(m), jnp.asarray(s),
                                      JBeamModelConfig(**kw))
        # where exp() lands in the subnormals, p > 0 depends on whether
        # the library flushes them: leave that band out
        arg = -0.5 * (m - s) ** 2 / kw.get("sig_hit", 0.2) ** 2
        keep = (arg > -700.0) | (arg < -750.0)
        _close(got.numpy()[keep], np.asarray(want)[keep], SCORE_TOL)
    assert float(got.min()) < -1e8


@pytest.mark.parametrize("name", ["normal", "pdf"])
def test_scores_do_not_depend_on_the_chunk(case, name):
    def run(chunk):
        p = dataclasses.replace(case["tp"], chunk=chunk)
        if name == "normal":
            return tr.match_normal(None, *_tclouds(case), p,
                                   inject=case["tinject"],
                                   return_scores=True)
        return tr.match_pdf(None, *_tclouds(case), p,
                            BeamModelConfig(max_range=9.0),
                            inject=case["tinject"], return_scores=True)

    T_a, a = run(96)                     # a short last chunk
    T_b, b = run(1 << 20)                # one pass
    for key in ("ratio", "err_sum") if name == "normal" else ("logp_raw",):
        _close(a[key], b[key], TOL)
    for key in ("cnt", "max_cnt") if name == "normal" else ("fov_cnt",):
        assert torch.equal(a[key], b[key])
    assert torch.equal(T_a, T_b)


# --------------------------------------------------------------------- winner

def _jbest(keys, phis, ts, ok=True):
    return np.asarray(jr._lex_best(tuple(jnp.asarray(k) for k in keys),
                                   jnp.asarray(phis), jnp.asarray(ts),
                                   jnp.asarray(ok)))


def _tbest(keys, phis, ts, ok=True):
    return tr._lex_best(tuple(_t(k) for k in keys), _t(phis), _t(ts),
                        torch.tensor(ok)).numpy()


def test_lex_best_ties_nan_and_fallback():
    """The lowest index wins among equal keys, later keys break ties of
    earlier ones, a NaN key loses to every number, and nothing qualified
    (or not ok) gives the identity: as the JAX package's lexsort."""
    n = 12
    phis = np.linspace(-0.3, 0.3, n)
    ts = np.stack([np.arange(n) * 0.01, -np.arange(n) * 0.02], -1)

    def T_of(i):
        return se2.make(ts[i, 0], ts[i, 1], phis[i], dtype=F64).numpy()

    a = np.full(n, -1e9)
    a[[3, 7, 9]] = 5.0                              # a three-way tie
    cases = [((a,), 3)]
    b = np.zeros(n)
    b[[7, 9]] = 2.0                                 # second key: 7 and 9
    c = np.zeros(n)
    c[9] = 1.0                                      # third key: 9
    cases += [((a, b), 7), ((a, b, c), 9)]
    d = a.copy()
    d[1] = np.nan                                   # NaN before the winner
    cases += [((d,), 3)]
    e = np.full(n, np.nan)
    e[5] = -3.0                                     # the only number
    cases += [((e,), 5)]
    for keys, want in cases:
        got = _tbest(keys, phis, ts)
        _close(got, _jbest(keys, phis, ts), TOL)
        _close(got, T_of(want), TOL)
    eye = np.eye(3)
    for keys, ok in (((np.full(n, -1e9),), True), ((a,), False),
                     ((np.full(n, np.nan),), True)):
        _equal(_tbest(keys, phis, ts, ok), eye)
        _equal(_jbest(keys, phis, ts, ok), eye)


# -------------------------------------------------------- the port's own draws

def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_subsample_mask_rule_and_determinism():
    mask = torch.ones(2000, dtype=torch.bool)
    mask[::7] = False
    out = tr.subsample_mask(_gen(1), mask)
    assert torch.equal(out, tr.subsample_mask(_gen(1), mask))
    assert not torch.equal(out, tr.subsample_mask(_gen(2), mask))
    assert not (out & ~mask).any()                  # only valid points kept
    n_valid = int(mask.sum())
    kept = int(out.sum())                           # ~Binomial(n, 180/n)
    assert 130 < kept < 230, (kept, n_valid)
    # 180 / 181 > 0.99: nothing is dropped
    few = torch.zeros(2000, dtype=torch.bool)
    few[:181] = True
    assert torch.equal(tr.subsample_mask(_gen(1), few), few)
    # 180 / 182 < 0.99: the draw applies
    few[181] = True
    assert int(tr.subsample_mask(_gen(1), few).sum()) <= 182


def test_random_valid_subset_properties():
    mask = torch.zeros(300, dtype=torch.bool)
    mask[40:120:2] = True                           # 40 valid indices
    idx, valid = tr.random_valid_subset(_gen(3), mask, 25)
    assert idx.dtype == torch.int64 and idx.shape == valid.shape == (25,)
    assert valid.all() and mask[idx].all()
    assert len(set(idx.tolist())) == 25             # no repeats
    idx2, _ = tr.random_valid_subset(_gen(3), mask, 25)
    assert torch.equal(idx, idx2)                   # a function of the seed
    idx3, _ = tr.random_valid_subset(_gen(4), mask, 25)
    assert not torch.equal(idx, idx3)
    # more asked than available: the valid ones first, flags false after
    idx, valid = tr.random_valid_subset(_gen(3), mask, 60)
    assert valid[:40].all() and not valid[40:].any()
    assert sorted(idx[:40].tolist()) == list(range(40, 120, 2))
    assert len(set(idx.tolist())) == 60
    # over many seeds every valid index comes first about equally often
    first = [int(tr.random_valid_subset(_gen(s), mask, 1)[0]) for s in
             range(400)]
    assert len(set(first)) > 30 and set(first) <= set(range(40, 120, 2))


def test_matchers_draw_from_the_generator(case):
    """Without injection the matcher is a function of its generator's
    seed, consumes it (a second call on the same generator draws anew),
    and still finds the motion."""
    args = (case["grid"], case["pose_m"], *_tclouds(case), case["tp"])
    T_a, a = tr.match_tsd(_gen(11), *args, return_scores=True)
    T_b, b = tr.match_tsd(_gen(11), *args, return_scores=True)
    assert torch.equal(T_a, T_b)
    assert torch.equal(a["prep"].t_idx, b["prep"].t_idx)
    g = _gen(11)
    tr.match_tsd(g, *args)
    _, c = tr.match_tsd(g, *args, return_scores=True)
    assert not torch.equal(a["prep"].t_idx, c["prep"].t_idx)
    _, d = tr.match_tsd(_gen(12), *args, return_scores=True)
    assert not torch.equal(a["prep"].t_idx, d["prep"].t_idx)
    assert math.hypot(float(T_a[0, 2]) - 0.064,
                      float(T_a[1, 2]) + 0.085) < 0.15


def test_matchers_without_a_generator_raise(case):
    """No generator and draws left to make: an error, not a fixed seed
    that would hand every scan the same draws.  A full injection needs
    none."""
    clouds = _tclouds(case)
    with pytest.raises(ValueError, match="torch.Generator"):
        tr.match_tsd(None, case["grid"], case["pose_m"], *clouds, case["tp"])
    with pytest.raises(ValueError, match="torch.Generator"):
        tr.match_normal(None, *clouds, case["tp"])
    part = case["tinject"]._replace(trial_idx=None, trial_valid=None)
    with pytest.raises(ValueError, match="torch.Generator"):
        tr._prepare(None, *clouds, case["tp"], part)
    tr._prepare(None, *clouds, case["tp"], case["tinject"])
    tr._prepare(_gen(1), *clouds, case["tp"], part)


def test_params_from_config_mirror_jax():
    from ohm_tsd_slam_tpu.config import RansacConfig as JRansacConfig
    from ohm_tsd_slam_tpu_torch.config import RansacConfig

    kw = dict(trials=77, eps_thresh=0.2, size_control_set=90,
              phi_max_deg=25.0)
    p = tr.RansacParams.from_config(RansacConfig(**kw), math.radians(0.5))
    jp = jr.RansacParams.from_config(JRansacConfig(**kw), math.radians(0.5))
    want = dataclasses.asdict(jp)
    got = dataclasses.asdict(p)
    want.pop("chunk")                    # the port's is sized for eager torch
    got.pop("chunk")
    assert got == want
    assert p.span == jp.span and p.scale_distance == jp.scale_distance
    assert p.zrand_tsd == 0.25           # the config's zrand is not wired in
