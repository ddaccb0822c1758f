"""Positive random feature (PRF) maps: config, projection draws, and the
decode-time projection precompose.

The counterpart of ``repro.core.feature_maps`` for what the serving path
needs. The isotropic Performer kinds draw W; the DARKFormer kind adds
the re-embedding M (Sigma = M^T M), so that phi_Sigma(x) = phi_iso(Mx).

Shapes (single head): W : (m, r); M : (r, d).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# kinds with a decode-time PRF (S, z, c) state, and hence a fused path
PRF_KINDS = ("performer", "darkformer", "lfk")


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    """Configuration of the random-feature attention kernel."""
    kind: str = "darkformer"         # exact|performer|darkformer|lfk|...
    num_features: int = 256          # m
    feature_rank: int = 0            # r for DARKFormer; 0 -> r = d_head
    orthogonal: bool = True          # blockwise-orthogonal W
    stabilize: bool = True           # subtract running max before exp
    eps: float = 1e-8                # denominator floor
    redraw: bool = False             # redraw W each step (training)

    def rank(self, d_head: int) -> int:
        return self.feature_rank if self.feature_rank > 0 else d_head


def gaussian_projection(gen: torch.Generator, m: int, r: int,
                        dtype=torch.float32) -> torch.Tensor:
    """Plain iid N(0,1) projection rows, shape (m, r)."""
    return torch.randn((m, r), generator=gen, dtype=torch.float32).to(dtype)


def orthogonal_projection(gen: torch.Generator, m: int, r: int,
                          dtype=torch.float32) -> torch.Tensor:
    """Blockwise-orthogonal Gaussian rows (Performer's ORF variance trick).

    Draws ceil(m/r) independent (r, r) Gaussian blocks, QR-orthogonalizes
    each, rescales rows to chi(r)-distributed norms so marginals match
    N(0, I_r), and stacks the first m rows.
    """
    nblocks = -(-m // r)
    blocks = []
    for _ in range(nblocks):
        g = torch.randn((r, r), generator=gen, dtype=torch.float32)
        q, _ = torch.linalg.qr(g)
        blocks.append(q)
    w = torch.cat(blocks, dim=0)[:m]
    norms = torch.linalg.norm(
        torch.randn((m, r), generator=gen, dtype=torch.float32), dim=-1,
        keepdim=True)
    return (w * norms).to(dtype)


def draw_projection(gen: torch.Generator, cfg: FeatureConfig, d_head: int,
                    dtype=torch.float32) -> torch.Tensor:
    r = cfg.rank(d_head)
    if cfg.orthogonal:
        return orthogonal_projection(gen, cfg.num_features, r, dtype)
    return gaussian_projection(gen, cfg.num_features, r, dtype)


def init_feature_params(gen: torch.Generator, cfg: FeatureConfig,
                        d_head: int, n_groups: int = 1,
                        dtype=torch.float32) -> dict:
    """Per-layer feature params: ``w`` (n_groups, m, r) and, for
    darkformer, ``m_mat`` (n_groups, r, d) identity-initialized."""
    r = cfg.rank(d_head)
    w = torch.stack([draw_projection(gen, cfg, d_head, dtype)
                     for _ in range(n_groups)])
    params = {"w": w}
    if cfg.kind == "darkformer":
        eye = torch.eye(r, d_head, dtype=dtype)
        params["m_mat"] = eye.expand(n_groups, r, d_head).clone()
    return params


def precompose_projection(fparams: dict, kind: str) -> dict:
    """Fold W and M into one decode-time projection A = (W M)^T.

    ``fparams``: {"w": (..., m, r)[, "m_mat": (..., r, d)]} with any
    leading (layer-stack, group) axes. Returns {"a": (..., d, m),
    "m_mat": (..., r, d) | None} in f32, both contiguous (the kernels
    take them as flat arrays).
    """
    if kind not in PRF_KINDS:
        raise ValueError(f"no decode projection for kind {kind!r}")
    w = fparams["w"].float()
    if kind == "darkformer":
        m_mat = fparams["m_mat"].float().contiguous()
        a = torch.einsum("...mr,...rd->...dm", w, m_mat).contiguous()
        return {"a": a, "m_mat": m_mat}
    return {"a": w.transpose(-1, -2).contiguous(), "m_mat": None}


def inv_sqrt(m: int) -> float:
    """m ** -0.5, the feature normalization 1/sqrt(m)."""
    return 1.0 / math.sqrt(m)


def raw_features(x: torch.Tensor, a: torch.Tensor,
                 m_mat: Optional[torch.Tensor], eq: str) -> torch.Tensor:
    """Raw PRF logits through the precomposed projection:
    x A − ‖M x‖²/2 (‖x‖²/2 when ``m_mat`` is None), in f32.

    ``eq`` names x's axes with ``g`` the KV-group axis and ``d`` the
    feature axis, e.g. "bghd"; a: (G, d, m); m_mat: (G, r, d).
    """
    x = x.float()
    logits = torch.einsum(f"{eq},gdm->{eq.replace('d', 'm')}", x, a.float())
    xt = x if m_mat is None else torch.einsum(
        f"{eq},grd->{eq.replace('d', 'r')}", x, m_mat.float())
    return logits - 0.5 * torch.sum(xt * xt, dim=-1, keepdim=True)
