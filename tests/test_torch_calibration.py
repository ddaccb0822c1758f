"""The paper's analysis in the port, against the reference, on the CPU.

The reference computes its variance math, the covariance calibration and
the whitening init in plain ``jnp``, outside any Pallas kernel; the port
computes them in plain torch. Held here, at the tolerances stated:

  * every function of ``core/variance.py`` on the same numpy inputs, at
    d = 4, 8 and 16, and the reference's own statistical tests
    (tests/test_variance.py, tests/test_core_prf.py) run on the port's
    functions, with torch generators;
  * ``core/calibration.py`` and ``feature_maps.whitening_init``: entry by
    entry where ``eigh``'s choice of eigenvectors does not enter (the
    shrinkage covariance, the anisotropy score, Sigma*), row by row up
    to sign where the eigenvalues are well apart, and through
    Sigma = M^T M and M Lambda M^T = I where they are not;
  * ``lm.collect_qk`` tap by tap and ``lm.whitening_calibrate`` layer by
    layer and group by group, f32 and bf16 (where the reference raises);
  * a calibrated model downstream: the loss and every gradient, one
    prefill chunk and one decode step;
  * the feature draws' statistics: orthogonal blocks, chi(d) row norms,
    standard normal entries;
  * ``examples/torch_finetune_kernel_swap.py`` at a few steps.

Reduced configs, f32 unless a case says bf16.
"""
import dataclasses
import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

from repro import configs as jcfgs
from repro.core import calibration as jcal
from repro.core import feature_maps as jfm
from repro.core import variance as jvr
from repro.data import SyntheticLM
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.core import calibration as tcal
from repro_torch.core import feature_maps as tfm
from repro_torch.core import variance as tvr
from repro_torch.models import lm as tlm
from repro_torch.tree import flatten

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# f32 in another order of operations (einsum, inv, slogdet, eigh, exp):
# relative to the largest entry of the compared quantity
RTOL = 1e-4
# Sigma = M^T M from an eigh of a shrunk f32 covariance: relative to the
# largest |Sigma| (the inverse amplifies a covariance's rounding by its
# condition number, at most ~20 d with 5% shrinkage)
SIGMA_TOL = 1e-4
# M Lambda M^T against I, Lambda in f64 from the same samples
WHITE_TOL = 1e-3
# the LM's taps through 3 layers, as tests/test_torch_model.py's ATOL
TAP_TOL = 1e-4
# the loss, as tests/test_torch_training.py
OUT_TOL = dict(atol=1e-5, rtol=1e-4)
# every gradient leaf of a calibrated model: tests/test_torch_training.py's
# GRAD_TOL (atol 2e-6, rtol 2e-4) plus 1e-5 of the leaf's largest |grad|.
# A whitened M widens the features' logit range; both packages then sit
# up to 1.2e-5 of max |grad| from a float64 evaluation of the same loss
# (the embedding's gradient, max 2.1), so f32 rounding alone passes
# 2e-6 there.
GRAD_TOL = dict(atol=2e-6, rtol=2e-4)
GRAD_LEAF_REL = 1e-5


def _close(got, exp, tol=RTOL, msg=""):
    """|got - exp| <= tol * max|exp|, elementwise."""
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    assert got.shape == exp.shape, (got.shape, exp.shape)
    scale = max(float(np.abs(exp).max()), 1e-30)
    gap = float(np.abs(got - exp).max()) / scale
    assert gap <= tol, f"{msg}: relative gap {gap:.3e} > {tol:.1e}"


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _spd(rng, d, lmax=0.45):
    """tests/test_variance.py::_random_spd in numpy: eigenvalues uniform
    in [0.02, lmax) in a random orthonormal basis. Returns (lam, evals,
    evecs) in f32."""
    evals = rng.uniform(0.02, lmax, d)
    q, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (((q * evals) @ q.T).astype(np.float32),
            evals.astype(np.float32), q.astype(np.float32))


def _sigma(m):
    m = np.asarray(m, np.float64)
    return np.einsum("...rd,...re->...de", m, m)


# ---------------------------------------------------------------------------
# variance: every function against the reference
# ---------------------------------------------------------------------------

def _variance_inputs(d, seed=0, n=32):
    rng = np.random.default_rng(seed + d)
    lam, _, _ = _spd(rng, d)
    star = np.asarray(jvr.optimal_sigma_star(jnp.asarray(lam)))
    a = 0.15 * rng.standard_normal((d, d))
    return dict(
        lam=lam, star=star.astype(np.float32),
        sigma=(a.T @ a + 0.5 * np.eye(d)).astype(np.float32),
        q=(0.3 * rng.standard_normal((n, d))).astype(np.float32),
        k=(0.3 * rng.standard_normal((n, d))).astype(np.float32),
        omega=(0.5 * rng.standard_normal((n, d))).astype(np.float32),
        omegas=rng.standard_normal((512, d)).astype(np.float32),
        weights=rng.uniform(0.5, 1.5, 512).astype(np.float32))


VARIANCE_CASES = {
    "optimal_sigma_star": lambda vr, x: vr.optimal_sigma_star(x["lam"]),
    "b_gaussian": lambda vr, x: vr.b_gaussian(x["omega"], x["lam"]),
    "kappa_softmax": lambda vr, x: vr.kappa_softmax(x["q"], x["k"]),
    "estimator_variance_iso":
        lambda vr, x: vr.estimator_variance_iso(x["q"], x["k"]),
    "estimator_variance_is":
        lambda vr, x: vr.estimator_variance_is(x["q"], x["k"], x["star"]),
    "estimator_variance_dark":
        lambda vr, x: vr.estimator_variance_dark(x["q"], x["k"], x["sigma"]),
    "importance_weight":
        lambda vr, x: vr.importance_weight(x["omegas"], x["sigma"]),
    "mc_kernel_estimate":
        lambda vr, x: vr.mc_kernel_estimate(x["q"], x["k"], x["omegas"]),
    "mc_kernel_estimate_weighted":
        lambda vr, x: vr.mc_kernel_estimate(x["q"], x["k"], x["omegas"],
                                            x["weights"]),
    "mc_dark_estimate":
        lambda vr, x: vr.mc_dark_estimate(x["q"], x["k"], x["omegas"],
                                          x["sigma"]),
    "empirical_qk_covariance":
        lambda vr, x: vr.empirical_qk_covariance(x["q"], x["k"]),
}


@pytest.mark.parametrize("d", [4, 8, 16])
@pytest.mark.parametrize("name", sorted(VARIANCE_CASES))
def test_variance_function_matches_reference(name, d):
    """Each function of core/variance.py on the same f32 inputs (Lambda
    with lambda_max < 0.45; q, k at 0.3 N(0, I); Sigma = A^T A + I/2),
    within RTOL of the reference's largest output."""
    x = _variance_inputs(d)
    exp = VARIANCE_CASES[name](jvr, {k: jnp.asarray(v) for k, v in x.items()})
    got = VARIANCE_CASES[name](tvr, {k: _t(v) for k, v in x.items()})
    assert got.dtype == torch.float32
    _close(got.numpy(), exp, msg=name)


@pytest.mark.parametrize("proposal", ["iso", "star"])
@pytest.mark.parametrize("d", [4, 8, 16])
def test_expected_variance_matches_reference_over_the_port_pairs(d,
                                                                 proposal):
    """The port's ``expected_variance`` against the mean of the
    reference's closed-form variances over the very pairs the port drew,
    rebuilt from the same seeded generator (q's normals, then k's, on the
    CPU in f32, through Lambda's Cholesky factor)."""
    x = _variance_inputs(d, seed=1)
    lam = _t(x["lam"])
    sigma = None if proposal == "iso" else _t(x["star"])
    got = tvr.expected_variance(torch.Generator().manual_seed(7), lam, sigma,
                                n_pairs=1024)
    gen = torch.Generator().manual_seed(7)
    chol = torch.linalg.cholesky(lam)
    q, k = (torch.randn((1024, d), generator=gen) @ chol.T for _ in range(2))
    q, k = jnp.asarray(q.numpy()), jnp.asarray(k.numpy())
    per_pair = (jvr.estimator_variance_iso(q, k) if sigma is None else
                jvr.estimator_variance_is(q, k, jnp.asarray(x["star"])))
    _close(float(got), float(jnp.mean(per_pair)), msg=proposal)
    # the seed fixes the pairs: another seed gives another mean
    other = tvr.expected_variance(torch.Generator().manual_seed(8), lam,
                                  sigma, n_pairs=1024)
    assert float(other) != float(got)


# ---------------------------------------------------------------------------
# variance: the reference's statistical tests, on the port's functions
# ---------------------------------------------------------------------------

def _normal(gen, *shape):
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def _spd_t(gen, d, lmax=0.45):
    """tests/test_variance.py::_random_spd drawn from a torch generator."""
    evals = 0.02 + (lmax - 0.02) * torch.rand(d, generator=gen)
    q, _ = torch.linalg.qr(_normal(gen, d, d))
    return (q * evals) @ q.T, evals, q


def test_variance_iso_closed_form_vs_mc():
    gen = torch.Generator().manual_seed(0)
    d = 6
    q, k = 0.3 * _normal(gen, d), 0.3 * _normal(gen, d)
    om = _normal(gen, 500_000, d)
    z = torch.exp(om @ (q + k) - 0.5 * (q @ q + k @ k))
    closed = float(tvr.estimator_variance_iso(q, k))
    assert abs(closed - float(torch.var(z))) / closed < 0.1


def test_variance_is_closed_form_vs_mc():
    gen = torch.Generator().manual_seed(1)
    d = 5
    q, k = 0.3 * _normal(gen, d), 0.3 * _normal(gen, d)
    sigma, _, _ = _spd_t(gen, d)
    sigma = sigma + 0.7 * torch.eye(d)       # ensure A = I - S^-1/2 > 0
    om = _normal(gen, 500_000, d) @ torch.linalg.cholesky(sigma).T
    # Z = (p_I / psi)(om) * prf terms; p_I/psi = 1 / w_sigma
    z = (torch.exp(om @ (q + k) - 0.5 * (q @ q + k @ k))
         / tvr.importance_weight(om, sigma))
    closed = float(tvr.estimator_variance_is(q, k, sigma))
    assert abs(closed - float(torch.var(z))) / max(closed, 1e-9) < 0.15


def test_theorem32_sigma_star_formula():
    """Sigma* = (I+2L)(I-2L)^{-1}: shares eigenbasis, matches eigenvalues."""
    lam, evals, evecs = _spd_t(torch.Generator().manual_seed(2), 6)
    expect = (evecs * ((1 + 2 * evals) / (1 - 2 * evals))) @ evecs.T
    np.testing.assert_allclose(tvr.optimal_sigma_star(lam).numpy(),
                               expect.numpy(), rtol=1e-4, atol=1e-5)


def test_theorem32_iso_iff_iso():
    d = 5
    star_iso = tvr.optimal_sigma_star(0.2 * torch.eye(d))
    np.testing.assert_allclose(star_iso.numpy(),
                               (star_iso[0, 0] * torch.eye(d)).numpy(),
                               atol=1e-5)
    lam, _, _ = _spd_t(torch.Generator().manual_seed(3), d)
    star = tvr.optimal_sigma_star(lam)
    off = (star - torch.diag(torch.diag(star))).numpy()
    assert (np.abs(off).max() > 1e-3
            or float(torch.std(torch.diag(star))) > 1e-3)


def test_theorem32_optimality():
    """E[Var] under Sigma* < under I, and < under random proposals
    (Lemma 3.1 says Sigma* is the global optimum among proposals)."""
    d = 6
    lam, _, _ = _spd_t(torch.Generator().manual_seed(4), d, lmax=0.4)
    star = tvr.optimal_sigma_star(lam)

    def ev(sigma):
        return float(tvr.expected_variance(torch.Generator().manual_seed(5),
                                           lam, sigma))
    v_star = ev(star)
    assert v_star < ev(None)
    for i in range(3):
        pert, _, _ = _spd_t(torch.Generator().manual_seed(10 + i), d)
        assert v_star <= ev(star + 0.5 * pert + 0.6 * torch.eye(d)) * 1.001


def test_b_gaussian_closed_form_vs_mc():
    gen = torch.Generator().manual_seed(6)
    d = 4
    lam, _, _ = _spd_t(gen, d)
    om = 0.5 * _normal(gen, d)
    x = _normal(gen, 400_000, d) @ torch.linalg.cholesky(lam).T
    mc = float(torch.mean(torch.exp(2 * x @ om - torch.sum(x * x, -1))))
    closed = float(tvr.b_gaussian(om, lam))
    assert abs(closed - mc) / closed < 0.05


@settings(deadline=None, max_examples=15)
@given(st.integers(0, 10_000))
def test_variance_nonnegative_and_star_bounded(seed):
    gen = torch.Generator().manual_seed(seed)
    d = 4
    lam, _, _ = _spd_t(gen, d)
    star = tvr.optimal_sigma_star(lam)
    q, k = 0.3 * _normal(gen, d), 0.3 * _normal(gen, d)
    assert float(tvr.estimator_variance_iso(q, k)) >= -1e-6
    assert float(tvr.estimator_variance_is(q, k, star)) >= -1e-6


def test_lemma21_unbiased_mc():
    """Lemma 2.1: E[phi(q).phi(k)] = exp(q.k), checked by MC."""
    gen = torch.Generator().manual_seed(0)
    d, m = 8, 200_000
    q, k = 0.4 * _normal(gen, d), 0.4 * _normal(gen, d)
    est = float(tvr.mc_kernel_estimate(q, k, _normal(gen, m, d)))
    true = float(torch.exp(q @ k))
    assert abs(est - true) / true < 0.02


def test_eq3_dark_unbiased_mc():
    """Eq. 3: DARKFormer PRF is unbiased for exp(q^T Sigma k), averaged
    over independent projection draws (heavy-tailed at one draw)."""
    gen = torch.Generator().manual_seed(1)
    d, r, m = 8, 8, 200_000
    q, k = 0.4 * _normal(gen, d), 0.4 * _normal(gen, d)
    m_mat = 0.5 * _normal(gen, r, d)
    sigma = m_mat.T @ m_mat
    true = float(torch.exp(q @ sigma @ k))
    ests = [float(tvr.mc_dark_estimate(q, k, _normal(gen, m, r) @ m_mat,
                                       sigma)) for _ in range(4)]
    assert abs(sum(ests) / len(ests) - true) / true < 0.02


def test_prop41_importance_equivalence():
    """Prop 4.1: unweighted sampling from N(0,S) == weighted from N(0,I)
    (Sigma's spectrum kept in (0.5, ~1.2), where the weighted estimator's
    variance is finite)."""
    gen = torch.Generator().manual_seed(2)
    d, m = 6, 400_000
    q, k = 0.3 * _normal(gen, d), 0.3 * _normal(gen, d)
    a = 0.15 * _normal(gen, d, d)
    sigma = a.T @ a + 0.5 * torch.eye(d)
    om_sigma = _normal(gen, m, d) @ torch.linalg.cholesky(sigma).T
    est_unweighted = float(tvr.mc_dark_estimate(q, k, om_sigma, sigma))
    om_iso = _normal(gen, m, d)
    zq = torch.exp(om_iso @ q - 0.5 * q @ sigma @ q)
    zk = torch.exp(om_iso @ k - 0.5 * k @ sigma @ k)
    est_weighted = float(torch.mean(tvr.importance_weight(om_iso, sigma)
                                    * zq * zk))
    true = float(torch.exp(q @ sigma @ k))
    assert abs(est_unweighted - true) / true < 0.05
    assert abs(est_weighted - true) / true < 0.05


def test_whitening_init_whitens():
    """Prop C.1: M = Lam^{-1/2} makes Cov(Mx) = I."""
    d = 8
    a = _normal(torch.Generator().manual_seed(3), d, d)
    lam = a @ a.T / d + 0.1 * torch.eye(d)
    m = tfm.whitening_init(lam)
    np.testing.assert_allclose((m @ lam @ m.T).numpy(), np.eye(d), atol=1e-3)


def test_anisotropy_score_regimes():
    gen = torch.Generator().manual_seed(7)
    iso = _normal(gen, 4000, 16)
    aniso = iso * torch.linspace(0.05, 3.0, 16)[None, :]
    assert float(tcal.anisotropy_score(iso)) < 0.1
    assert float(tcal.anisotropy_score(aniso)) > 0.25


# ---------------------------------------------------------------------------
# calibration against the reference
# ---------------------------------------------------------------------------

def _aniso_samples(rng, n, d, ratio=None):
    """(n, d) f32 samples with a covariance of distinct scales in a random
    basis: geometric with ``ratio`` between neighbours' variances, else
    random in [0.05, 3] (some close together)."""
    if ratio is None:
        scales = np.sqrt(rng.uniform(0.05, 3.0, d))
    else:
        scales = np.sqrt(0.05 * ratio ** np.arange(d))
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return ((rng.standard_normal((n, d)) * scales) @ basis.T
            + 0.1 * rng.standard_normal(d)).astype(np.float32)


@pytest.mark.parametrize("shrink", [0.0, 0.05, 0.3])
@pytest.mark.parametrize("d", [4, 16, 64])
def test_shrinkage_covariance_matches_reference(d, shrink):
    """Entry by entry (no eigh enters), within RTOL of its largest."""
    x = _aniso_samples(np.random.default_rng(d), 3000, d).reshape(30, 100, d)
    _close(tcal.shrinkage_covariance(_t(x), shrink).numpy(),
           jcal.shrinkage_covariance(jnp.asarray(x), shrink))


def _align_signs(got, exp):
    """``got``'s rows with each row's sign flipped to agree with ``exp``'s
    (eigh fixes an eigenvector up to its sign)."""
    s = np.sign(np.sum(got * exp, axis=-1, keepdims=True))
    return got * s


@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("d", [4, 8, 16])
def test_whitening_init_rows_match_reference_up_to_sign(d, r):
    """On a Lambda whose eigenvalues are spaced by ratios of 1.6, each
    row equals the reference's up to its sign, within 1e-3 of max |M|
    (eigenvectors of f32 eigh at gaps of 1.6x over a spread of up to
    1.6^15)."""
    rng = np.random.default_rng(d)
    basis, _ = np.linalg.qr(rng.standard_normal((d, d)))
    lam = ((basis * (0.05 * 1.6 ** np.arange(d))) @ basis.T
           ).astype(np.float32)
    exp = np.asarray(jfm.whitening_init(jnp.asarray(lam), r))
    got = tfm.whitening_init(_t(lam), r).numpy()
    assert got.shape == exp.shape == (r or d, d)
    _close(_align_signs(got, exp), exp, tol=1e-3)


@pytest.mark.parametrize("r", [None, 3])
@pytest.mark.parametrize("d", [4, 8, 16])
def test_whiten_m_from_qk_rows_match_reference_up_to_sign(d, r):
    """The same from q/k samples whose variances are spaced by ratios of
    1.6, without shrinkage (which would bunch the smallest eigenvalues
    at 5% of the mean), so the sample covariance's eigenvalues stay at
    least 1.5x apart."""
    rng = np.random.default_rng(10 + d)
    x = _aniso_samples(rng, 6000, d, ratio=1.6)
    q, k = x[:4000].reshape(2, 2, 1000, d), x[4000:].reshape(2, 1, 1000, d)
    ev = np.linalg.eigvalsh(np.asarray(
        jcal.shrinkage_covariance(jnp.asarray(x), 0.0), np.float64))
    assert (ev[1:] / ev[:-1]).min() >= 1.5
    exp = np.asarray(jcal.whiten_m_from_qk(jnp.asarray(q), jnp.asarray(k),
                                           r, shrink=0.0))
    got = tcal.whiten_m_from_qk(_t(q), _t(k), r, shrink=0.0).numpy()
    assert got.shape == exp.shape == (r or d, d)
    _close(_align_signs(got, exp), exp, tol=1e-3)


@pytest.mark.parametrize("r", [None, 6])
@pytest.mark.parametrize("d", [8, 16, 64])
def test_whitening_sigma_and_identity_match_reference(d, r):
    """On anisotropic random samples (eigenvalues free to lie close, so
    rows may rotate within near-equal ones): Sigma = M^T M within
    SIGMA_TOL of the reference's, M Lambda M^T = I_r within WHITE_TOL
    (Lambda in f64 from the same samples), for ``whiten_m_from_qk`` and
    for ``whitening_init`` on the reference's Lambda. At r < d the rows
    span the top-r eigenvectors: Sigma restricted to them, the same."""
    rng = np.random.default_rng(20 + d)
    x = _aniso_samples(rng, 4000, d)
    q, k = x[:3000].reshape(3, 1000, d), x[3000:].reshape(1, 1000, d)
    lam = np.asarray(jcal.shrinkage_covariance(jnp.asarray(x)))
    xc = x.astype(np.float64) - x.astype(np.float64).mean(0)
    cov = xc.T @ xc / len(xc)
    lam64 = 0.95 * cov + 0.05 * np.trace(cov) / d * np.eye(d)
    for what, got, exp in (
            ("whiten_m_from_qk",
             tcal.whiten_m_from_qk(_t(q), _t(k), r).numpy(),
             jcal.whiten_m_from_qk(jnp.asarray(q), jnp.asarray(k), r)),
            ("whitening_init", tfm.whitening_init(_t(lam), r).numpy(),
             jfm.whitening_init(jnp.asarray(lam), r))):
        _close(_sigma(got), _sigma(exp), tol=SIGMA_TOL, msg=what)
        np.testing.assert_allclose(got @ lam64 @ got.T, np.eye(r or d),
                                   atol=WHITE_TOL, rtol=0, err_msg=what)


def test_anisotropy_score_matches_reference():
    """Isotropic, graded and nearly rank-one samples: the score (in
    [0, 1)) within 1e-5 of the reference's, f32 rounding of an entropy
    over 16 eigenvalues; bf16 samples, where the reference's eigvalsh
    raises, are scored in f32 (the same score as their f32 values)."""
    rng = np.random.default_rng(0)
    base = rng.standard_normal((4000, 16)).astype(np.float32)
    for scales in (np.ones(16), np.linspace(0.05, 3.0, 16),
                   np.r_[10.0, np.full(15, 0.01)]):
        x = (base * scales).astype(np.float32)
        assert abs(float(tcal.anisotropy_score(_t(x)))
                   - float(jcal.anisotropy_score(jnp.asarray(x)))) < 1e-5
    xb = torch.tensor(base).to(torch.bfloat16)
    with pytest.raises(NotImplementedError):
        jcal.anisotropy_score(jnp.asarray(base, jnp.bfloat16))
    assert float(tcal.anisotropy_score(xb)) == float(
        tcal.anisotropy_score(xb.float()))


def test_calibrate_feature_params_on_its_documented_layout():
    """``calibrate_feature_params`` on the layout its docstring names: a
    tree reached by "a/b" paths and q, k (..., G, L, d). Each group's
    Sigma against the reference's; a layer without ``m_mat`` (performer)
    and the other leaves are left as they were; the input is unchanged."""
    rng = np.random.default_rng(5)
    g, r, d, m = 2, 8, 8, 16
    tree = {
        "enc": {"l0": {"feat": {"w": rng.standard_normal((g, m, r)),
                                "m_mat": np.broadcast_to(np.eye(r, d),
                                                         (g, r, d)).copy()}},
                "l1": {"feat": {"w": rng.standard_normal((g, m, r))}}},
        "head": rng.standard_normal((4, 4))}
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    x = _aniso_samples(rng, 2 * g * 600 + 2 * g * 300, d)
    q = x[:2 * g * 600].reshape(2, g, 600, d)
    k = x[2 * g * 600:].reshape(2, g, 300, d)
    taps = {"enc/l0/feat": (q, k), "enc/l1/feat": (q, k)}
    exp = jcal.calibrate_feature_params(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {n: tuple(map(jnp.asarray, v)) for n, v in taps.items()},
        jfm.FeatureConfig())
    ttree = bridge.tree_from_jax(tree, device="cpu")
    before = {p: t.clone() for p, t in flatten(ttree)}
    got = tcal.calibrate_feature_params(
        ttree, {n: tuple(map(_t, v)) for n, v in taps.items()},
        tfm.FeatureConfig())
    for p, t in flatten(ttree):
        assert torch.equal(t, before[p]), p
    gm = got["enc"]["l0"]["feat"]["m_mat"]
    assert gm.dtype == torch.float32 and gm.shape == (g, r, d)
    _close(_sigma(gm.numpy()),
           _sigma(np.asarray(exp["enc"]["l0"]["feat"]["m_mat"])),
           tol=SIGMA_TOL)
    assert "m_mat" not in got["enc"]["l1"]["feat"]
    for p in ("['enc']['l0']['feat']['w']", "['enc']['l1']['feat']['w']",
              "['head']"):
        assert dict(flatten(got))[p] is dict(flatten(ttree))[p]


# ---------------------------------------------------------------------------
# collect_qk and whitening_calibrate
# ---------------------------------------------------------------------------

def _setup(arch, kind="darkformer", dtype="float32", seed=0):
    jcfg = jcfgs.get_config(arch, reduced=True)
    tcfg = tcfgs.get_config(arch, reduced=True)
    m = jcfg.attn.num_features
    jcfg = dataclasses.replace(jcfgs.darkify(jcfg, kind, m), dtype=dtype)
    tcfg = dataclasses.replace(tcfgs.darkify(tcfg, kind, m), dtype=dtype)
    jparams = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _batch(vocab, b=2, l=24, step=0):
    data = SyntheticLM(vocab, l, b, seed=1).batch(step)
    return ({k: jnp.asarray(v) for k, v in data.items()},
            {k: torch.tensor(v).long() for k, v in data.items()})


def _reference_tap_draws(cfg, l):
    """The reference's ``collect_qk`` draws for the random kind: layer li
    keyed on PRNGKey(li) (repro/models/lm.py: collect_qk)."""
    return torch.tensor(np.stack([
        np.asarray(jax.random.normal(jax.random.PRNGKey(li), (l, l),
                                     jnp.float32))
        for li in range(cfg.n_layers)]))


@pytest.mark.parametrize("kind", ["darkformer", "exact", "performer",
                                  "random"])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_collect_qk_matches_reference(arch, kind):
    """Keys, shapes ((B, G, Hg, L, dh) and (B, G, 1, L, dh)) and every
    post-RoPE tap within TAP_TOL; the random kind fed the reference's
    per-layer draws."""
    jcfg, tcfg, jparams, tparams = _setup(arch, kind)
    jb, tb = _batch(jcfg.vocab)
    exp = jlm.collect_qk(jparams, jcfg, jb)
    draws = (_reference_tap_draws(tcfg, 24) if kind == "random" else None)
    got = tlm.collect_qk(tparams, tcfg, tb, draws=draws)
    assert list(got) == sorted(exp) == [f"unit{i}/b0"
                                        for i in range(tcfg.n_layers)]
    g, hg = tcfg.n_kv, tcfg.n_heads // tcfg.n_kv
    for name, (q, k) in got.items():
        assert q.shape == (2, g, hg, 24, tcfg.head_dim)
        assert k.shape == (2, g, 1, 24, tcfg.head_dim)
        assert not q.requires_grad
        for t, e, what in ((q, exp[name][0], "q"), (k, exp[name][1], "k")):
            np.testing.assert_allclose(t.numpy(), np.asarray(e),
                                       atol=TAP_TOL, rtol=0,
                                       err_msg=f"{name} {what}")


def _lam64(q, k, scale, shrink=0.05):
    """The shrunk covariance of a (layer, group)'s scaled taps in f64."""
    d = q.shape[-1]
    x = np.concatenate([np.asarray(q, np.float64).reshape(-1, d),
                        np.asarray(k, np.float64).reshape(-1, d)]) * scale
    x = x - x.mean(0)
    cov = x.T @ x / len(x)
    return (1 - shrink) * cov + shrink * np.trace(cov) / d * np.eye(d)


@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_whitening_calibrate_matches_reference(arch):
    """Reduced f32 configs: each (layer, group)'s Sigma = M^T M within
    SIGMA_TOL of the reference's and M Lambda M^T = I within WHITE_TOL
    (Lambda in f64 from the reference's taps); ``m_mat`` keeps its
    shape and f32; every other leaf is the input's own tensor, and the
    input tree is unchanged."""
    jcfg, tcfg, jparams, tparams = _setup(arch)
    jb, tb = _batch(jcfg.vocab)
    before = {p: t.clone() for p, t in flatten(tparams)}
    exp = np.asarray(jlm.whitening_calibrate(jparams, jcfg, jb)
                     ["units"]["b0"]["attn"]["feat"]["m_mat"])
    new = tlm.whitening_calibrate(tparams, tcfg, tb)
    got = new["units"]["b0"]["attn"]["feat"]["m_mat"]
    assert got.shape == exp.shape and got.dtype == torch.float32
    got = got.numpy()
    taps = jlm.collect_qk(jparams, jcfg, jb)
    for li in range(tcfg.n_layers):
        q, k = taps[f"unit{li}/b0"]
        for gi in range(tcfg.n_kv):
            _close(_sigma(got[li, gi]), _sigma(exp[li, gi]), tol=SIGMA_TOL,
                   msg=f"layer {li} group {gi}")
            lam = _lam64(q[:, gi], k[:, gi], tcfg.head_dim ** -0.25)
            np.testing.assert_allclose(
                got[li, gi] @ lam @ got[li, gi].T, np.eye(tcfg.head_dim),
                atol=WHITE_TOL, rtol=0, err_msg=f"layer {li} group {gi}")
    for p, t in flatten(tparams):
        assert torch.equal(t, before[p]), p
    old, fresh = dict(flatten(tparams)), dict(flatten(new))
    assert old.keys() == fresh.keys()
    for p, t in fresh.items():
        assert (t is not old[p]) == p.endswith("['m_mat']"), p


@pytest.mark.parametrize("kind", ["exact", "performer", "lfk", "random"])
def test_whitening_calibrate_leaves_other_kinds(kind):
    """Any kind but darkformer: the params come back as they went in."""
    _, tcfg, _, tparams = _setup("smollm-135m", kind)
    _, tb = _batch(tcfg.vocab)
    assert tlm.whitening_calibrate(tparams, tcfg, tb) is tparams


@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_whitening_calibrate_computes_in_f32_on_bf16(arch):
    """bf16 params: the reference raises in its eigh (NotImplementedError,
    'Unsupported dtype bfloat16'); the port calibrates in f32. Its Sigma
    is held against the reference's ``whiten_m_from_qk`` on the port's
    own taps cast to f32 and scaled, and its taps within 2^-5 of the
    largest |tap| of the reference's bf16 taps (bf16 roundings that part
    in the layers before: 0 at layer 0, up to 1.1% at layer 2)."""
    jcfg, tcfg, jparams, tparams = _setup(arch, dtype="bfloat16")
    jb, tb = _batch(jcfg.vocab)
    with pytest.raises(NotImplementedError):
        jlm.whitening_calibrate(jparams, jcfg, jb)
    got = tlm.whitening_calibrate(tparams, tcfg, tb)
    m = got["units"]["b0"]["attn"]["feat"]["m_mat"]
    assert m.dtype == torch.float32 and bool(torch.isfinite(m).all())
    taps = tlm.collect_qk(tparams, tcfg, tb)
    jtaps = jlm.collect_qk(jparams, jcfg, jb)
    scale = tcfg.head_dim ** -0.25
    for li in range(tcfg.n_layers):
        q, k = taps[f"unit{li}/b0"]
        assert q.dtype == torch.bfloat16
        for t, e in zip((q, k), jtaps[f"unit{li}/b0"]):
            _close(t.float().numpy(), np.asarray(e, np.float32),
                   tol=2.0 ** -5, msg=f"layer {li} taps")
        for gi in range(tcfg.n_kv):
            exp = jcal.whiten_m_from_qk(
                jnp.asarray(q[:, gi].float().numpy()) * scale,
                jnp.asarray(k[:, gi].float().numpy()) * scale,
                tcfg.head_dim)
            _close(_sigma(m[li, gi].numpy()), _sigma(exp), tol=SIGMA_TOL,
                   msg=f"layer {li} group {gi}")


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_calibrated_model_loss_and_every_gradient_match(arch, use_kernel):
    """The reference's calibrated params in both packages (through the
    bridge): the loss and every gradient leaf against ``jax.grad``, at
    OUT_TOL and GRAD_TOL plus GRAD_LEAF_REL of the leaf's largest
    gradient."""
    jcfg, tcfg, jparams, _ = _setup(arch)
    jcfg = dataclasses.replace(jcfg, use_kernel=use_kernel)
    tcfg = dataclasses.replace(tcfg, use_kernel=use_kernel)
    jb, tb = _batch(jcfg.vocab)
    jcal_params = jlm.whitening_calibrate(jparams, jcfg,
                                          _batch(jcfg.vocab, step=1)[0])
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jcal_params), tcfg, device="cpu")
    (jloss, jm), jgrads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(
        jcal_params, jcfg, jb)
    leaves = dict(flatten(tparams))
    for t in leaves.values():
        t.requires_grad_(True)
    tloss, tm = tlm.loss_fn(tparams, tcfg, tb)
    tgrads = torch.autograd.grad(tloss, list(leaves.values()),
                                 allow_unused=True)
    for name in ("loss", "ce", "z_loss", "accuracy"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   err_msg=name, **OUT_TOL)
    exp = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
           jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert exp.keys() == leaves.keys()
    for (path, t), g in zip(leaves.items(), tgrads):
        g = torch.zeros_like(t) if g is None else g
        atol = GRAD_TOL["atol"] + GRAD_LEAF_REL * np.abs(exp[path]).max()
        np.testing.assert_allclose(g.numpy(), exp[path], err_msg=path,
                                   atol=atol, rtol=GRAD_TOL["rtol"])


@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_calibrated_model_serves_like_reference(arch):
    """The reference's calibrated params: one ragged prefill chunk and one
    decode step through the fused path's plain version in both packages,
    logits and every serve-state leaf within tests/test_torch_model.py's
    atol."""
    jcfg, tcfg, jparams, _ = _setup(arch)
    jcfg = dataclasses.replace(jcfg, use_kernel=True)
    tcfg = dataclasses.replace(tcfg, use_kernel=True)
    jparams = jlm.whitening_calibrate(jparams, jcfg, _batch(jcfg.vocab)[0])
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    b = 3
    jstate = jlm.init_serve_state(jcfg, b=b, max_len=64, per_slot=True,
                                  stacked=True)
    tstate = tlm.init_serve_state(tcfg, b=b, max_len=64, per_slot=True,
                                  device="cpu")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (b, 9)).astype(np.int32)
    vl = np.asarray([9, 4, 6], np.int32)
    jlog, jstate = jlm.prefill_chunk(jparams, jcfg,
                                     {"tokens": jnp.asarray(toks)}, jstate,
                                     valid_len=jnp.asarray(vl))
    tlog, tstate = tlm.prefill_chunk(tparams, tcfg,
                                     {"tokens": torch.tensor(toks).long()},
                                     tstate, valid_len=torch.tensor(vl))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TAP_TOL,
                               rtol=0, err_msg="prefill logits")
    tok = rng.integers(0, jcfg.vocab, (b,)).astype(np.int32)
    jlog, jstate = jlm.decode_step(jparams, jcfg, jnp.asarray(tok), jstate)
    tlog, tstate = tlm.decode_step(tparams, tcfg, torch.tensor(tok).long(),
                                   tstate)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=TAP_TOL,
                               rtol=0, err_msg="decode logits")
    for name in ("s", "z", "c"):
        np.testing.assert_allclose(
            getattr(tstate["layers"], name).numpy(),
            np.asarray(getattr(jstate["layers"], name)), atol=TAP_TOL,
            rtol=0, err_msg=name)
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


# ---------------------------------------------------------------------------
# the feature draws' statistics (held statistically, not bitwise)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,r", [(16, 16), (48, 16), (40, 8)])
def test_orthogonal_projection_blocks_orthogonal(m, r):
    """Rows within each (r, r) block are orthogonal: the block's Gram
    matrix is diagonal to 1e-5 of its largest entry (f32 QR)."""
    w = tfm.orthogonal_projection(torch.Generator().manual_seed(m), m, r)
    assert w.shape == (m, r)
    for start in range(0, m, r):
        blk = w[start:start + r].double()
        gram = (blk @ blk.T).numpy()
        off = gram - np.diag(np.diag(gram))
        assert np.abs(off).max() < 1e-5 * np.abs(gram).max(), start


def test_orthogonal_projection_marginal_norms():
    """Row norms follow chi(d): mean within 0.5 of sqrt(d) at 512 x 64."""
    w = tfm.orthogonal_projection(torch.Generator().manual_seed(1), 512, 64)
    norms = torch.linalg.norm(w, dim=1).numpy()
    assert abs(norms.mean() - math.sqrt(64)) < 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_projection_is_standard_normal(seed):
    """Entries of a 512 x 64 draw: mean 0 and variance 1, each within
    four standard errors (1/sqrt(n) and sqrt(2/n))."""
    w = tfm.gaussian_projection(torch.Generator().manual_seed(seed), 512,
                                64).double()
    n = w.numel()
    assert abs(float(w.mean())) < 4 / math.sqrt(n)
    assert abs(float(w.var()) - 1.0) < 4 * math.sqrt(2 / n)


# ---------------------------------------------------------------------------
# the example
# ---------------------------------------------------------------------------

def test_finetune_kernel_swap_example_runs_on_cpu():
    """examples/torch_finetune_kernel_swap.py at 3 pretrain and 2
    finetune steps on the CPU: finite losses; the calibrated m_mat
    differs from the identity and whitens the calibration batch
    (M Lambda M^T = I within WHITE_TOL, Lambda in f64 from the taps of
    the transplanted model that the calibration read)."""
    spec = importlib.util.spec_from_file_location(
        "torch_finetune_kernel_swap",
        ROOT / "examples" / "torch_finetune_kernel_swap.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    out = ex.main(["--device", "cpu", "--pretrain-steps", "3",
                   "--finetune-steps", "2"])
    losses = out["pretrain_losses"] + out["finetune_losses"]
    assert len(losses) == 5 and all(math.isfinite(x) for x in losses)
    cfg, m = out["config"], out["calibrated_m"]
    eye = torch.eye(cfg.head_dim).expand_as(m)
    assert float((m - eye).abs().max()) > 0.1
    # the taps the calibration read: the transplanted model's, M = I
    taps = tlm.collect_qk(out["transplanted_params"], cfg,
                          out["calib_batch"])
    for li in range(cfg.n_layers):
        q, k = taps[f"unit{li}/b0"]
        for gi in range(cfg.n_kv):
            lam = _lam64(q[:, gi], k[:, gi], cfg.head_dim ** -0.25)
            mg = m[li, gi].double().numpy()
            np.testing.assert_allclose(mg @ lam @ mg.T, np.eye(cfg.head_dim),
                                       atol=WHITE_TOL, rtol=0)
