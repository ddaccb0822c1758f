"""RG-LRU, the recurrent mixer of Griffin / RecurrentGemma
(arXiv:2402.19427), for the ``rec`` slots of a block pattern.

The counterpart of the RG-LRU half of ``repro.models.recurrent``:

    x, g = W_x u, W_g u                  (both d_rnn)
    x <- causal depthwise conv1d(x, k=4)
    r_t = sigmoid(W_a x_t);  i_t = sigmoid(W_i x_t)
    log a_t = -c * softplus(lam) * r_t          (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * x_t)
    out = W_o (h * gelu(g))

The reference has no Pallas kernel here (its block is plain ``jnp``), so
neither has the port. The gates come from f32 products, h is f32, and
the recurrence runs as a log-step (Hillis-Steele) scan over the
reference's combine, so an L-token chunk costs ceil(log2 L) steps of
elementwise launches rather than L. Position t's value depends only on
positions <= t, in an order fixed by t: padding a row, or cutting a
prompt into other chunks at the same boundaries, leaves its valid
outputs bitwise as they were.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ll

RGLRU_C = 8.0
CONV_K = 4


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, d_rnn) f32
    conv: torch.Tensor       # (B, CONV_K - 1, d_rnn): the pre-conv inputs


def rglru_init(gen: torch.Generator, d_model: int, d_rnn: int,
               dtype=torch.float32) -> dict:
    """Draws in the order of the reference's keys: wx, wg, conv_w, wa,
    wi, lam. The reference draws ``wo`` from ``wg``'s key, so ``wo`` is
    drawn here from the generator state saved before ``wg``: with
    d_rnn == d_model the two are equal bitwise, as in the reference."""
    wx = ll.trunc_normal(gen, (d_model, d_rnn), 1.0, dtype)
    at_wg = gen.get_state()
    wg = ll.trunc_normal(gen, (d_model, d_rnn), 1.0, dtype)
    conv_w = ll.trunc_normal(gen, (CONV_K, d_rnn), float(CONV_K), dtype)
    wa = ll.trunc_normal(gen, (d_rnn, d_rnn), 1.0, dtype)
    wi = ll.trunc_normal(gen, (d_rnn, d_rnn), 1.0, dtype)
    # lam so that a^(c softplus) lies in (0.9, 0.999) (Griffin A.2)
    u = torch.empty((d_rnn,), dtype=torch.float32, device=gen.device)
    u.uniform_(0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / RGLRU_C))
    again = torch.Generator(device=gen.device)
    again.set_state(at_wg)
    return {"wx": wx, "wg": wg, "conv_w": conv_w, "wa": wa, "wi": wi,
            "lam": lam,
            "wo": ll.trunc_normal(again, (d_rnn, d_model), 1.0, dtype)}


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 prefix: Optional[torch.Tensor] = None):
    """Depthwise causal conv. x: (B, L, d); w: (K, d); prefix: (B, K-1,
    d), the inputs before x (zeros when None). Returns (out in x.dtype,
    the padded inputs (B, K-1+L, d))."""
    b, l, d = x.shape
    if prefix is None:
        prefix = torch.zeros((b, CONV_K - 1, d), dtype=x.dtype,
                             device=x.device)
    xp = torch.cat([prefix.to(x.dtype), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(CONV_K):
        out = out + xp[:, i:i + l].float() * w[i].float()
    return out.to(x.dtype), xp


def _rglru_scan(x: torch.Tensor, a: torch.Tensor, i_gate: torch.Tensor,
                h0: torch.Tensor):
    """h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t) from h0, in f32.
    x, a, i_gate: (B, L, d); h0: (B, d). Returns (h (B, L, d), h_L).

    A Hillis-Steele scan over the pairs (a_t, b_t) with the reference's
    combine (a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2); h0 enters as the
    reference's prepended (1, h0), already combined into position 0."""
    a = a.float()
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * (
        i_gate.float() * x.float())
    b = torch.cat([h0.float()[:, None] * a[:, :1] + b[:, :1], b[:, 1:]],
                  dim=1)
    step = 1
    while step < a.shape[1]:
        a, b = (torch.cat([a[:, :step], a[:, :-step] * a[:, step:]], dim=1),
                torch.cat([b[:, :step], b[:, :-step] * a[:, step:]
                           + b[:, step:]], dim=1))
        step *= 2
    return b, b[:, -1]


def rglru_ref(x: torch.Tensor, a: torch.Tensor, gate: torch.Tensor,
              h0: torch.Tensor):
    """The sequential recurrence oracle (reference ``ref.rglru_ref``):
    x, a, gate (N, L, d) with a in (0, 1); h0 (N, d). Returns (h (N, L,
    d), h_L), f32."""
    a = a.float()
    inp = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * (
        gate.float() * x.float())
    h, hs = h0.float(), []
    for t in range(a.shape[1]):
        h = a[:, t] * h + inp[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def rglru_apply(params: dict, u: torch.Tensor,
                state: Optional[RGLRUState] = None,
                valid_len: Optional[torch.Tensor] = None):
    """u: (B, L, d_model) -> (out (B, L, d_model) in u.dtype, the new
    ``RGLRUState``: h f32, conv the last K-1 pre-conv inputs in u.dtype).

    ``valid_len`` ((B,) int32) marks ragged rows of a padded chunk: past
    a row's valid end the gate is a = 1 (so sqrt(1 - a^2) = 0 and h
    carries through), h is read at the row's last valid step and the
    conv tail gathered at its valid end, so the carry is the one an
    unpadded run over ``valid_len[b]`` tokens gives. Nothing here waits
    for the device."""
    x = u @ params["wx"]
    g = u @ params["wg"]
    prefix = None if state is None else state.conv
    x_conv, xp = _causal_conv(x, params["conv_w"], prefix)
    xf = x_conv.float()
    r = torch.sigmoid(xf @ params["wa"].float())
    i_gate = torch.sigmoid(xf @ params["wi"].float())
    a = torch.exp(-RGLRU_C * F.softplus(params["lam"].float()) * r)
    b, l = u.shape[0], u.shape[1]
    if valid_len is not None:
        vmask = (torch.arange(l, device=u.device)[None]
                 < valid_len[:, None])[..., None]
        a = torch.where(vmask, a, 1.0)
    h0 = (torch.zeros((b, x.shape[-1]), dtype=torch.float32,
                      device=u.device) if state is None else state.h)
    hs, h_last = _rglru_scan(x_conv, a, i_gate, h0)
    if valid_len is None:
        tail = xp[:, -(CONV_K - 1):]
    else:
        vl = valid_len.long()
        at = (vl[:, None] + torch.arange(CONV_K - 1, device=u.device))
        tail = xp.gather(1, at[..., None].expand(-1, -1, xp.shape[-1]))
        last = (vl - 1).clamp(min=0)[:, None, None]
        h_last = hs.gather(1, last.expand(-1, 1, hs.shape[-1]))[:, 0]
    out = (hs * F.gelu(g.float(), approximate="tanh")).to(u.dtype)
    return out @ params["wo"], RGLRUState(h=h_last, conv=tail)


def rglru_decode(params: dict, u: torch.Tensor, state: RGLRUState):
    """One-token step. u: (B, 1, d_model)."""
    return rglru_apply(params, u, state)


def init_rglru_state(b: int, d_rnn: int, device="cuda") -> RGLRUState:
    """A zero state: h (b, d_rnn) and the conv tail (b, K-1, d_rnn), both
    f32 (the tail holds the model's-type inputs, cast on write)."""
    return RGLRUState(
        h=torch.zeros((b, d_rnn), dtype=torch.float32, device=device),
        conv=torch.zeros((b, CONV_K - 1, d_rnn), dtype=torch.float32,
                         device=device))
