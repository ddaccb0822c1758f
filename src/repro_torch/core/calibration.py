"""Calibration: estimate q/k covariance and initialize DARKFormer's M (the
counterpart of ``repro.core.calibration``).

The paper's finetuning recipe: pretrained weights fix the q/k
distribution; a small calibration pass estimates per-layer (per KV group)
covariance Lambda and initializes M = Lambda^{-1/2} (whitening, App. C)
or leaves M = I (pure learned). ``repro_torch.models.lm.
whitening_calibrate`` runs one batch through the model's q/k projections
and returns an updated param tree.

Inputs below f32 (bf16, f16) are computed in f32, where the reference's
``eigh`` raises on them. A covariance's product accumulates in f64 and
is rounded to f32 (the reference accumulates in f32), so the process's
TF32 setting never reaches it; the shrinkage and ``eigh`` run in f32.
"""
from __future__ import annotations

import torch

from repro_torch.core import feature_maps as fm
from repro_torch.tree import tree_map


def _at_least_f32(x: torch.Tensor) -> torch.Tensor:
    return x.float() if x.dtype in (torch.bfloat16, torch.float16) else x


def shrinkage_covariance(x: torch.Tensor, shrink: float = 0.05
                         ) -> torch.Tensor:
    """Ledoit-Wolf-style diagonal shrinkage; keeps Lambda well-conditioned
    when the calibration sample is small."""
    d = x.shape[-1]
    x = _at_least_f32(x).reshape(-1, d)
    x = x - torch.mean(x, dim=0, keepdim=True)
    # the product accumulates in f64 and rounds to x's type: no TF32
    # setting reaches it, on any device
    xd = x.double()
    cov = ((xd.T @ xd) / x.shape[0]).to(x.dtype)
    mu = torch.trace(cov) / d
    return ((1.0 - shrink) * cov
            + shrink * mu * torch.eye(d, dtype=cov.dtype, device=cov.device))


def whiten_m_from_qk(q: torch.Tensor, k: torch.Tensor, r=None,
                     shrink: float = 0.05) -> torch.Tensor:
    """M = Lambda^{-1/2} (top-r rows) from sampled q/k activations."""
    d = q.shape[-1]
    lam = shrinkage_covariance(
        torch.cat([q.reshape(-1, d), k.reshape(-1, d)], dim=0),
        shrink=shrink)
    return fm.whitening_init(lam, r)


def calibrate_feature_params(params: dict, qk_samples: dict,
                             cfg: fm.FeatureConfig) -> dict:
    """Replace each layer's identity-initialized m_mat by the whitening M.

    qk_samples: {layer_name: (q, k)} with q,k of shape (..., G, L, d) — one
    entry per attention layer; ``layer_name`` is a "/"-separated path of
    dict keys to the layer's feature params {"w", "m_mat" (G, r, d)}.
    Returns a new params tree (functional update; ``params`` untouched).
    """
    new = tree_map(lambda t: t, params)
    for name, (q, k) in qk_samples.items():
        layer = new
        path = name.split("/")
        for p in path[:-1]:
            layer = layer[p]
        fp = layer[path[-1]]
        if "m_mat" not in fp:
            continue
        g, r = fp["m_mat"].shape[0], fp["m_mat"].shape[1]
        mats = [whiten_m_from_qk(q[..., gi, :, :], k[..., gi, :, :], r)
                for gi in range(g)]
        fp["m_mat"] = torch.stack(mats).to(fp["m_mat"].dtype)
    return new


def anisotropy_score(x: torch.Tensor) -> torch.Tensor:
    """Effective-rank-based anisotropy diagnostic: 1 - erank/d in [0, 1).

    0 for isotropic inputs; -> 1 as variance concentrates in one direction.
    Used by benchmarks to show the regimes where DARKFormer wins.
    """
    lam = shrinkage_covariance(x, shrink=0.0)
    evals = torch.clamp(torch.linalg.eigvalsh(lam), min=1e-12)
    p = evals / torch.sum(evals)
    erank = torch.exp(-torch.sum(p * torch.log(p)))
    return 1.0 - erank / x.shape[-1]
