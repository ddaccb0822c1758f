"""Positive random feature (PRF) maps: config, projection draws, the
whitening init of M, the feature maps and the decode-time projection
precompose, and the trigonometric features (benchmarks only).

The counterpart of ``repro.core.feature_maps``. The isotropic Performer kinds
draw W; the DARKFormer kind adds the re-embedding M (Sigma = M^T M), so
that phi_Sigma(x) = phi_iso(Mx). Every map subtracts a stabilizer c, a
max taken without gradient, which cancels in the attention's
normalization.

Shapes (single head): x : (..., L, d); W : (m, r); M : (r, d).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

FEATURE_KINDS = ("exact", "performer", "darkformer", "lfk", "trig",
                 "random", "constant")

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
    return torch.randn((m, r), generator=gen, dtype=torch.float32,
                       device=gen.device).to(dtype)


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
        g = torch.randn((r, r), generator=gen, dtype=torch.float32,
                        device=gen.device)
        q, _ = torch.linalg.qr(g)
        blocks.append(q)
    w = torch.cat(blocks, dim=0)[:m]
    norms = torch.linalg.norm(
        torch.randn((m, r), generator=gen, dtype=torch.float32,
                    device=gen.device), dim=-1, keepdim=True)
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
        eye = torch.eye(r, d_head, dtype=dtype, device=w.device)
        params["m_mat"] = eye.expand(n_groups, r, d_head).clone()
    return params


def whitening_init(lam: torch.Tensor, r: Optional[int] = None
                   ) -> torch.Tensor:
    """M = Lambda^{-1/2} from a calibration covariance (App. C / Prop C.1).

    lam: (..., d, d) SPD covariance of q/k from a calibration batch, any
    leading axes batched into one ``eigh``. Returns (..., r, d) with the
    top-r whitening directions (full rank if r is None): rows sorted by
    descending variance, eigenvalues floored at 1e-8. Each row's sign is
    what ``eigh`` returns.
    """
    evals, evecs = torch.linalg.eigh(lam)
    evals = torch.clamp(evals, min=1e-8)
    # eigh returns ascending order; take the largest-variance directions.
    inv_sqrt = evecs * torch.rsqrt(evals)[..., None, :]
    m_full = inv_sqrt.transpose(-1, -2).flip(-2)
    if r is not None:
        m_full = m_full[..., :r, :]
    return m_full


def _stabilizer(logits: torch.Tensor, stabilize: bool) -> torch.Tensor:
    """Max over (L, m) per leading batch dims, without gradient."""
    if not stabilize:
        return torch.zeros(logits.shape[:-2] + (1, 1), dtype=logits.dtype,
                           device=logits.device)
    return logits.detach().amax(dim=(-2, -1), keepdim=True)


def prf_features(x: torch.Tensor, w: torch.Tensor, *, stabilize: bool = True,
                 shared_stabilizer: Optional[torch.Tensor] = None):
    """Isotropic positive random features (Performer):
    phi(x)_j = exp(w_j . x - ||x||^2/2 - c) / sqrt(m). Returns (phi, c);
    ``shared_stabilizer`` gives q and k one c."""
    raw = (torch.einsum("...ld,md->...lm", x, w)
           - 0.5 * torch.sum(x * x, dim=-1, keepdim=True))
    c = (shared_stabilizer if shared_stabilizer is not None
         else _stabilizer(raw, stabilize))
    return torch.exp(raw - c) * inv_sqrt(w.shape[0]), c


def dark_features(x: torch.Tensor, w: torch.Tensor, m_mat: torch.Tensor, *,
                  stabilize: bool = True,
                  shared_stabilizer: Optional[torch.Tensor] = None):
    """DARKFormer data-aware PRFs: phi_Sigma(x) = phi_iso(M x).
    x: (..., L, d), m_mat: (r, d), w: (m, r). Returns (phi, c)."""
    x_tilde = torch.einsum("...ld,rd->...lr", x, m_mat)
    return prf_features(x_tilde, w, stabilize=stabilize,
                        shared_stabilizer=shared_stabilizer)


def trig_features(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Trigonometric random features for the softmax kernel (§2):
    h(x) [cos(x Wᵀ), sin(x Wᵀ)] / sqrt(m) with h(x) = exp(‖x‖²/2).
    Unbiased but possibly negative, so attention over them is unstable;
    no attention path takes them (``qk_features`` refuses "trig").
    x: (..., L, d), w: (m, d) -> (..., L, 2m). For benchmarks only."""
    proj = torch.einsum("...ld,md->...lm", x, w)
    h = torch.exp(0.5 * torch.sum(x * x, dim=-1, keepdim=True))
    feats = torch.cat([torch.cos(proj), torch.sin(proj)], dim=-1)
    return h * feats / math.sqrt(w.shape[0])


def qk_features(q: torch.Tensor, k: torch.Tensor, w: torch.Tensor,
                kind: str, m_mat: Optional[torch.Tensor] = None, *,
                stabilize: bool = True):
    """Map (q, k) jointly with one shared stabilizer, the max of both
    logit sets. q, k: (..., L, d) with the 1/sqrt(d) softmax scaling
    already absorbed. Returns (q', k')."""
    if kind == "darkformer":
        if m_mat is None:
            raise ValueError("darkformer needs the M matrix")
        q = torch.einsum("...ld,rd->...lr", q, m_mat)
        k = torch.einsum("...ld,rd->...lr", k, m_mat)
    elif kind not in ("performer", "lfk"):
        raise ValueError(f"qk_features: unsupported kind {kind!r}")
    qraw = (torch.einsum("...ld,md->...lm", q, w)
            - 0.5 * torch.sum(q * q, dim=-1, keepdim=True))
    kraw = (torch.einsum("...ld,md->...lm", k, w)
            - 0.5 * torch.sum(k * k, dim=-1, keepdim=True))
    c = torch.maximum(_stabilizer(qraw, stabilize),
                      _stabilizer(kraw, stabilize))
    isq = inv_sqrt(w.shape[0])
    return torch.exp(qraw - c) * isq, torch.exp(kraw - c) * isq


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
