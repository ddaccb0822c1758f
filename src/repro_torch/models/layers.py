"""Model substrate: init, norms, RoPE and the dense MLPs.

The counterpart of ``repro.models.layers`` (MoE is not ported yet,
ROADMAP A12). Params are plain dicts of tensors with the reference's key
names, so a reference param tree maps leaf for leaf (``bridge``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def trunc_normal(gen: torch.Generator, shape, scale: float,
                 dtype=torch.float32) -> torch.Tensor:
    """N(0, scale / fan_in) truncated at two standard deviations."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = (scale / fan_in) ** 0.5
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, a=-2.0, b=2.0, generator=gen)
    return (std * t).to(dtype)


def rmsnorm_init(d: int, dtype=torch.float32) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype)}    # gemma-style 1+scale


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(dt)


def layernorm(params: dict, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(dt)


def apply_norm(kind: str, params: dict, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


def norm_init(kind: str, d: int, dtype=torch.float32) -> dict:
    if kind == "rmsnorm":
        return rmsnorm_init(d, dtype)
    return {"scale": torch.ones((d,), dtype=dtype),
            "bias": torch.zeros((d,), dtype=dtype)}


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., L, d_head); positions: (L,) or broadcastable int."""
    d = x.shape[-1]
    freqs = theta ** (-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d)
    ang = positions[..., :, None].float() * freqs       # (..., L, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype=torch.float32) -> dict:
    # draw order follows the reference's key split: gate, up, out
    gate = trunc_normal(gen, (d_model, d_ff), 1.0, dtype)
    up = trunc_normal(gen, (d_model, d_ff), 1.0, dtype)
    p = {"w_out": trunc_normal(gen, (d_ff, d_model), 1.0, dtype),
         "w_up": up}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = gate
    return p


def mlp_apply(params: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif kind == "geglu":
        # jax.nn.gelu defaults to the tanh approximation
        h = (F.gelu(x @ params["w_gate"], approximate="tanh")
             * (x @ params["w_up"]))
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_out"]
