"""Recurrent mixers: the RG-LRU of Griffin / RecurrentGemma
(arXiv:2402.19427), for the ``rec`` slots of a block pattern, and the
RWKV-6 "Finch" time and channel mixes (arXiv:2404.05892), for the
``rwkv`` slots.

The counterpart of ``repro.models.recurrent``. The RG-LRU:

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

RWKV-6: token-shift lerps, a data-dependent decay
w_t = exp(-exp(lam_w + tanh(x_t A) B)) and a per-head state S (dh x dh):

    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)

then a LayerNorm over the whole d_model, a silu(g) gate and W_o. The
reference's block runs its own sequential ``jnp`` scan, not its Pallas
``wkv6`` kernel (that one starts from a zero state, returns no final
state and shares one bonus u across heads, where the block's is per
head), so the port's block runs the same token loop in f32 in plain
PyTorch: an L-token chunk costs L steps of a few launches each. The
channel mix, sigmoid(W_r x_r) * W_v relu(W_k x_k)^2, carries its own
token shift.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as ll
from repro_torch.models.remat import dot

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
    x = dot(u, params["wx"])
    g = dot(u, params["wg"])
    prefix = None if state is None else state.conv
    x_conv, xp = _causal_conv(x, params["conv_w"], prefix)
    xf = x_conv.float()
    r = torch.sigmoid(dot(xf, params["wa"].float()))
    i_gate = torch.sigmoid(dot(xf, params["wi"].float()))
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
    return dot(out, params["wo"]), RGLRUState(h=h_last, conv=tail)


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


# ---------------------------------------------------------------------------
# RWKV-6 (the time mix; the channel mix is the block's feed-forward)
# ---------------------------------------------------------------------------

class RWKVState(NamedTuple):
    """The time mix's carry."""
    s: torch.Tensor          # (B, H, dh, dh) f32 wkv state
    shift: torch.Tensor      # (B, d_model) f32: the last token's input


class RWKVBlockState(NamedTuple):
    """An ``rwkv`` block's serve state: the time mix's carry and the
    channel mix's token shift. The reference's is the nested tuple
    ``(RWKVState(s, shift), cshift)``; these are its leaves, in its
    flattening order."""
    s: torch.Tensor          # (B, H, dh, dh) f32
    shift: torch.Tensor      # (B, d_model) f32, the time mix's
    cshift: torch.Tensor     # (B, d_model) f32, the channel mix's


def rwkv6_init(gen: torch.Generator, d_model: int, n_heads: int,
               decay_rank: int = 64, dtype=torch.float32) -> dict:
    """Draws in the order of the reference's keys: wr, wk, wv, wg,
    decay_a, decay_b (both f32), wo; mu, lam_w, the per-head bonus u and
    ln_x (f32, over the whole d_model) are constants."""
    dh = d_model // n_heads
    dev = gen.device
    wr, wk, wv, wg = (ll.trunc_normal(gen, (d_model, d_model), 1.0, dtype)
                      for _ in range(4))
    decay_a = ll.trunc_normal(gen, (d_model, decay_rank), 1.0)
    decay_b = ll.trunc_normal(gen, (decay_rank, d_model), 1.0)
    return {
        "mu": torch.full((5, d_model), 0.5, device=dev),  # r, k, v, w, g
        "wr": wr, "wk": wk, "wv": wv, "wg": wg,
        "decay_a": decay_a, "decay_b": decay_b,
        "lam_w": torch.zeros((d_model,), device=dev),
        "u": torch.zeros((n_heads, dh), device=dev),
        "ln_x": {"scale": torch.ones((d_model,), device=dev),
                 "bias": torch.zeros((d_model,), device=dev)},
        "wo": ll.trunc_normal(gen, (d_model, d_model), 1.0, dtype)}


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x_{t-1} with x_{-1} = last. x: (B, L, d); last: (B, d)."""
    return torch.cat([last[:, None], x[:, :-1]], dim=1)


def _last_valid(x: torch.Tensor, valid_len: Optional[torch.Tensor]):
    """x (B, L, d) at each row's last valid token (L - 1 when
    ``valid_len`` is None; token 0 for an empty row), gathered on the
    device."""
    if valid_len is None:
        return x[:, -1]
    last = (valid_len.long() - 1).clamp(min=0)[:, None, None]
    return x.gather(1, last.expand(-1, 1, x.shape[-1]))[:, 0]


def _wkv_scan(r, k, v, w, u, s0):
    """The reference's token loop, in f32. r, k, v, w: (B, H, L, dh); u:
    (H, dh); s0: (B, H, dh, dh). Returns (o (B, H, L, dh), S_L)."""
    r, k, v, w = (t.float() for t in (r, k, v, w))
    s = s0.float()
    bonus = u.float()[None, :, :, None]
    outs = []
    for t in range(r.shape[2]):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, :, t],
                                 s + bonus * kv))
        s = w[:, :, t, :, None] * s + kv
    return torch.stack(outs, dim=2), s


def rwkv6_apply(params: dict, x: torch.Tensor, n_heads: int,
                state: Optional[RWKVState] = None,
                valid_len: Optional[torch.Tensor] = None):
    """x: (B, L, d_model) -> (out (B, L, d_model) in x.dtype, the new
    ``RWKVState``: S and the shift in f32).

    The mixes run in x's type (``mu`` cast to it, as the reference
    does), the decay's low-rank product in f32. ``valid_len`` ((B,)
    int32) marks ragged rows of a padded chunk: past a row's valid end
    w = 1 and k = 0, so S carries through, and the shift is gathered at
    the row's last valid token. Nothing here waits for the device."""
    b, l, d = x.shape
    dh = d // n_heads
    last = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if state is None else state.shift.to(x.dtype))
    xprev = _token_shift(x, last)
    mu = params["mu"]
    xr, xk, xv, xw, xg = (x + (xprev - x) * mu[i].to(x.dtype)
                          for i in range(5))
    r = dot(xr, params["wr"]).reshape(b, l, n_heads, dh)
    k = dot(xk, params["wk"]).reshape(b, l, n_heads, dh)
    v = dot(xv, params["wv"]).reshape(b, l, n_heads, dh)
    g = dot(xg, params["wg"])
    dd = dot(torch.tanh(dot(xw.float(), params["decay_a"])),
             params["decay_b"])
    w = torch.exp(-torch.exp(params["lam_w"] + dd)).reshape(b, l, n_heads,
                                                            dh)
    if valid_len is not None:
        vmask = (torch.arange(l, device=x.device)[None]
                 < valid_len[:, None])[:, :, None, None]
        w = torch.where(vmask, w, 1.0)
        k = torch.where(vmask, k, 0.0)
    s0 = (torch.zeros((b, n_heads, dh, dh), dtype=torch.float32,
                      device=x.device) if state is None else state.s)
    o, s_last = _wkv_scan(*(t.transpose(1, 2) for t in (r, k, v, w)),
                          params["u"], s0)
    o = ll.layernorm(params["ln_x"], o.transpose(1, 2).reshape(b, l, d))
    o = o * F.silu(g.float()).to(o.dtype)
    out = dot(o.to(x.dtype), params["wo"])
    return out, RWKVState(s=s_last,
                          shift=_last_valid(x, valid_len).float())


def init_rwkv_state(b: int, d_model: int, n_heads: int,
                    device="cuda") -> RWKVState:
    """A zero time-mix carry: S (b, H, dh, dh) and the shift (b, d_model),
    both f32."""
    dh = d_model // n_heads
    return RWKVState(
        s=torch.zeros((b, n_heads, dh, dh), dtype=torch.float32,
                      device=device),
        shift=torch.zeros((b, d_model), dtype=torch.float32, device=device))


def rwkv6_channel_mix_init(gen: torch.Generator, d_model: int, d_ff: int,
                           dtype=torch.float32) -> dict:
    """Draws in the order of the reference's keys: wk, wv, wr."""
    wk = ll.trunc_normal(gen, (d_model, d_ff), 1.0, dtype)
    wv = ll.trunc_normal(gen, (d_ff, d_model), 1.0, dtype)
    return {"mu": torch.full((2, d_model), 0.5, device=gen.device),
            "wk": wk, "wv": wv,
            "wr": ll.trunc_normal(gen, (d_model, d_model), 1.0, dtype)}


def rwkv6_channel_mix(params: dict, x: torch.Tensor,
                      last: Optional[torch.Tensor] = None,
                      valid_len: Optional[torch.Tensor] = None):
    """out = sigmoid(W_r x_r) * (W_v relu(W_k x_k)^2), x: (B, L, d_model).
    Returns (out in x.dtype, the carried shift (B, d_model) f32, gathered
    at each row's last valid token under ``valid_len``)."""
    b, _, d = x.shape
    last = (torch.zeros((b, d), dtype=x.dtype, device=x.device)
            if last is None else last.to(x.dtype))
    xprev = _token_shift(x, last)
    mu = params["mu"]
    xk = x + (xprev - x) * mu[0].to(x.dtype)
    xr = x + (xprev - x) * mu[1].to(x.dtype)
    k = torch.square(F.relu(dot(xk, params["wk"])))
    out = (torch.sigmoid(dot(xr, params["wr"]).float()).to(x.dtype)
           * dot(k, params["wv"]))
    return out, _last_valid(x, valid_len).float()
