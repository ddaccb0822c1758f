"""Closed-form Monte-Carlo-variance math for PRF estimators (the
counterpart of ``repro.core.variance``).

The paper's theory layer, so it can be checked numerically:

  * ``optimal_sigma_star``      — Theorem 3.2: Sigma* = (I+2L)(I-2L)^{-1}
  * ``b_gaussian``              — B_x(w) for x ~ N(0, L) in closed form
                                  (Appendix A: prod_i c_i exp(beta_i w'_i^2))
  * ``estimator_variance_iso``  — Var_w[kappa_hat] for w ~ N(0, I) (exact)
  * ``estimator_variance_is``   — Var for the importance-sampled estimator
                                  with Gaussian proposal N(0, S) (Lemma 3.1's
                                  objective, exact Gaussian integrals)
  * ``estimator_variance_dark`` — Var of DARKFormer's *unweighted* estimator
                                  of its data-aligned kernel exp(q^T S k)
  * ``expected_variance``       — E_{q,k~D}[Var] by closed-form inner
                                  expectation + MC over (q, k)

All terms are per-sample variances; the m-sample estimator divides by m.
Every function computes in its inputs' dtype on their device.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def optimal_sigma_star(lam: torch.Tensor) -> torch.Tensor:
    """Theorem 3.2: Sigma* = (I + 2*Lam)(I - 2*Lam)^{-1}.

    Valid when lambda_max(Lam) < 1/2 (integrability of psi*). Computed in
    the eigenbasis for symmetry/stability.
    """
    evals, evecs = torch.linalg.eigh(lam)
    star = (1.0 + 2.0 * evals) / (1.0 - 2.0 * evals)
    return (evecs * star[None, :]) @ evecs.T


def _quad(x: torch.Tensor, a: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x^T A y over the last axis of x and y."""
    return torch.einsum("...d,de,...e->...", x, a, y)


def b_gaussian(omega: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """B_x(omega) = E_{x~N(0,Lam)}[exp(2 w.x - ||x||^2)], exact.

    = |I + 2 Lam|^{-1/2} * exp( 2 w^T Lam (I + 2 Lam)^{-1} w ).
    omega: (..., d).
    """
    d = lam.shape[-1]
    a = torch.eye(d, dtype=lam.dtype, device=lam.device) + 2.0 * lam
    _, logdet = torch.linalg.slogdet(a)
    inner = _quad(omega, lam @ torch.linalg.inv(a), omega)
    return torch.exp(2.0 * inner - 0.5 * logdet)


def kappa_softmax(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.sum(q * k, dim=-1))


def estimator_variance_iso(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact per-sample Var_w[Z], w ~ N(0, I), Z the PRF summand (Lemma 2.1).

    E[Z^2] = exp(2||q+k||^2 - ||q||^2 - ||k||^2);  Var = E[Z^2] - exp(2 q.k).
    """
    s = q + k
    ez2 = torch.exp(2.0 * torch.sum(s * s, dim=-1)
                    - torch.sum(q * q, dim=-1) - torch.sum(k * k, dim=-1))
    return ez2 - kappa_softmax(q, k) ** 2


def estimator_variance_is(q: torch.Tensor, k: torch.Tensor,
                          sigma_psi: torch.Tensor) -> torch.Tensor:
    """Exact per-sample Var of the IS estimator (Eq. 2) with psi = N(0, S).

    Z = (p_I/psi)(w) exp(w.s - a),  a = (||q||^2+||k||^2)/2,  w ~ psi.
    E[Z^2] = 2^{-d/2} |S|^{1/2} |A|^{-1/2} exp(s^T A^{-1} s - 2a),
    with A = I - S^{-1}/2, requires A > 0 (finite variance).
    """
    d = sigma_psi.shape[-1]
    eye = torch.eye(d, dtype=sigma_psi.dtype, device=sigma_psi.device)
    a_mat = eye - 0.5 * torch.linalg.inv(sigma_psi)
    s = q + k
    _, logdet_s = torch.linalg.slogdet(sigma_psi)
    _, logdet_a = torch.linalg.slogdet(a_mat)
    quad = _quad(s, torch.linalg.inv(a_mat), s)
    two_a = torch.sum(q * q, dim=-1) + torch.sum(k * k, dim=-1)
    log_ez2 = (-0.5 * d * math.log(2.0) + 0.5 * logdet_s - 0.5 * logdet_a
               + quad - two_a)
    return torch.exp(log_ez2) - kappa_softmax(q, k) ** 2


def estimator_variance_dark(q: torch.Tensor, k: torch.Tensor,
                            sigma: torch.Tensor) -> torch.Tensor:
    """Var of DARKFormer's unweighted estimator of exp(q^T Sigma k) (Eq. 3).

    Z = exp(w.s - (q^T S q + k^T S k)/2), w ~ N(0, S).
    E[Z^2] = exp(2 s^T S s - q^T S q - k^T S k).
    """
    s = q + k
    ez2 = torch.exp(2.0 * _quad(s, sigma, s) - _quad(q, sigma, q)
                    - _quad(k, sigma, k))
    return ez2 - torch.exp(_quad(q, sigma, k)) ** 2


def expected_variance(gen: torch.Generator, lam: torch.Tensor,
                      sigma_psi: Optional[torch.Tensor],
                      n_pairs: int = 4096) -> torch.Tensor:
    """E_{q,k~N(0,Lam)}[Var_w[kappa_hat]] — closed-form inner, MC outer.

    sigma_psi None -> isotropic baseline; else the IS proposal N(0, S).
    The (n_pairs, d) normals of q, then of k, are drawn from ``gen`` on
    the CPU in f32 and then moved to ``lam``'s device and dtype, so a
    seed gives the same pairs on every device.
    """
    d = lam.shape[-1]
    chol = torch.linalg.cholesky(lam)
    zq, zk = (torch.randn((n_pairs, d), generator=gen, dtype=torch.float32)
              .to(lam.device, lam.dtype) for _ in range(2))
    q, k = zq @ chol.T, zk @ chol.T
    if sigma_psi is None:
        v = estimator_variance_iso(q, k)
    else:
        v = estimator_variance_is(q, k, sigma_psi)
    return torch.mean(v)


def importance_weight(omega: torch.Tensor,
                      sigma: torch.Tensor) -> torch.Tensor:
    """w_Sigma(omega) = p_Sigma(omega) / p_I(omega)  (Proposition 4.1)."""
    _, logdet = torch.linalg.slogdet(sigma)
    quad_s = _quad(omega, torch.linalg.inv(sigma), omega)
    quad_i = torch.sum(omega * omega, dim=-1)
    return torch.exp(-0.5 * logdet - 0.5 * quad_s + 0.5 * quad_i)


def mc_kernel_estimate(q: torch.Tensor, k: torch.Tensor,
                       omegas: torch.Tensor,
                       weights: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """m-sample PRF estimate of exp(q.k) (optionally importance-weighted).

    q, k: (..., d); omegas: (m, d); weights: (m,) or None.
    """
    zq = torch.exp(torch.einsum("md,...d->...m", omegas, q)
                   - 0.5 * torch.sum(q * q, dim=-1, keepdim=True))
    zk = torch.exp(torch.einsum("md,...d->...m", omegas, k)
                   - 0.5 * torch.sum(k * k, dim=-1, keepdim=True))
    z = zq * zk
    if weights is not None:
        z = z * weights
    return torch.mean(z, dim=-1)


def mc_dark_estimate(q: torch.Tensor, k: torch.Tensor, omegas: torch.Tensor,
                     sigma: torch.Tensor) -> torch.Tensor:
    """m-sample unweighted DARKFormer estimate of exp(q^T Sigma k).

    omegas must be drawn from N(0, Sigma).
    """
    zq = torch.exp(torch.einsum("md,...d->...m", omegas, q)
                   - 0.5 * _quad(q, sigma, q)[..., None])
    zk = torch.exp(torch.einsum("md,...d->...m", omegas, k)
                   - 0.5 * _quad(k, sigma, k)[..., None])
    return torch.mean(zq * zk, dim=-1)


def empirical_qk_covariance(q: torch.Tensor,
                            k: torch.Tensor) -> torch.Tensor:
    """Pooled covariance of flattened q/k vectors — calibration input.

    q, k: (..., d). Used to whiten (M = Lam^{-1/2}) or to form Sigma*.
    """
    x = torch.cat([q.reshape(-1, q.shape[-1]), k.reshape(-1, k.shape[-1])],
                  dim=0)
    x = x - torch.mean(x, dim=0, keepdim=True)
    return (x.T @ x) / x.shape[0]
