"""The port's two-stage serving kernels and B7 against the reference's.

On the CPU the wrappers ``linear_attention_decode_step`` (B3),
``linear_attention_prefill_chunk`` (B4) and ``wkv6`` (B7) run their plain
PyTorch versions; these are held against the reference's Pallas kernels
in interpret mode (``prf_decode_step_fwd``,
``linear_attention_causal_carry_fwd``, ``wkv6_fwd``) and against the
``ref.*`` oracles, on the same numpy inputs, at the reference's own
tolerances (atol 2e-5 for B3 and B4, 3e-5 for B7; gradients 2e-4, as
tests/test_kernels.py). Then the whole-prompt branch of
``rf_attention_prefill`` and ``lm.prefill`` against the reference's
(atol 1e-4, f32 across 3 layers), and the two-stage dispatch of the LM
steps. tests/test_torch_model.py holds ``fused=False`` LM steps against
the reference's; tests/test_torch_cuda.py holds the CUDA kernels against
these plain versions on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.core import attention as jatt
from repro.core import feature_maps as jfm
from repro.kernels import ops, ref
from repro.kernels.linear_attn_scan import linear_attention_causal_carry_fwd
from repro.kernels.prf_decode_step import prf_decode_step_fwd
from repro.kernels.wkv6_scan import wkv6_fwd
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch import kernels as tkops
from repro_torch.core import attention as tatt
from repro_torch.core import feature_maps as tfm
from repro_torch.kernels import linear_attn_scan as kl
from repro_torch.kernels import prf_decode_step as kds
from repro_torch.kernels import wkv6_scan as kw
from repro_torch.models import lm as tlm

torch.set_num_threads(1)
KERNEL_ATOL = 2e-5
WKV_ATOL = 3e-5
GRAD_ATOL = 2e-4
MODEL_ATOL = 1e-4
F = np.float32


def _close(got, exp, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, F), np.asarray(exp, F),
                               atol=atol, rtol=0, err_msg=msg)


# ---------------------------------------------------------------------------
# B3 prf_decode_step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("v_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,g,h,hk,m,dv", [
    (2, 3, 3, 1, 16, 8),      # GQA: kf, v, rho per KV group
    (3, 1, 4, 4, 16, 8),      # per head
    (2, 2, 2, 1, 32, 40),     # dv over several of the kernel's tiles
    (2, 3, 3, 1, 256, 64),    # smollm-135m's heads, 2 slots
    (2, 1, 8, 1, 256, 256),   # darkformer-2b's heads, 2 slots
])
def test_decode_step_plain_matches_reference(b, g, h, hk, m, dv, v_dtype):
    """bf16 v goes to the reference's kernel as bf16, which casts it
    itself, and to the oracle as the same values in f32."""
    rng = np.random.default_rng(b * 100 + m + dv)
    qf = rng.uniform(size=(b, g, h, m)).astype(F)
    kf = rng.uniform(size=(b, g, hk, m)).astype(F)
    v_t = torch.tensor(rng.standard_normal((b, g, hk, dv)).astype(F)).to(
        getattr(torch, v_dtype))
    v = v_t.float().numpy()                # bf16 values exactly, in f32
    s = rng.standard_normal((b, g, h, m, dv)).astype(F)
    z = (rng.uniform(size=(b, g, h, m)) * 4.0).astype(F)
    rho = rng.uniform(0.2, 1.0, size=(b, g, hk)).astype(F)
    n = b * g * h
    flat = [np.broadcast_to(a, (b, g, h) + a.shape[3:])
            .reshape(n, *a.shape[3:]) for a in (qf, kf, v, s, z)]
    rho_n = np.broadcast_to(rho, (b, g, h)).reshape(n, 1)
    jflat = list(map(jnp.asarray, flat))
    jflat_v = list(jflat)
    jflat_v[2] = jflat[2].astype(getattr(jnp, v_dtype))
    exp_k = prf_decode_step_fwd(*jflat_v, jnp.asarray(rho_n), eps=1e-6,
                                block_b=4, interpret=True)
    exp_r = ref.prf_decode_step_ref(*jflat, jnp.asarray(rho_n), eps=1e-6)
    args = [torch.tensor(qf), torch.tensor(kf), v_t, torch.tensor(s),
            torch.tensor(z), torch.tensor(rho)]
    ptrs = [args[3].data_ptr(), args[4].data_ptr()]
    n0 = kds.launches
    out, s_new, z_new = kds.linear_attention_decode_step(*args, eps=1e-6)
    assert kds.launches == n0
    assert [s_new.data_ptr(), z_new.data_ptr()] == ptrs   # in place
    for exp in (exp_k, exp_r):
        _close(out.reshape(n, dv), exp[0], KERNEL_ATOL, "out")
        _close(s_new.reshape(n, m, dv), exp[1], KERNEL_ATOL, "s")
        _close(z_new.reshape(n, m), exp[2], KERNEL_ATOL, "z")


# ---------------------------------------------------------------------------
# B4 linear_attention_causal_carry
# ---------------------------------------------------------------------------

def _carry_inputs(b, h, hk, l, m, dv, seed, feat_scale=1.0):
    rng = np.random.default_rng(seed)
    return ((feat_scale * rng.uniform(size=(b, h, l, m))).astype(F),
            (feat_scale * rng.uniform(size=(b, hk, l, m))).astype(F),
            rng.standard_normal((b, hk, l, dv)).astype(F),
            rng.standard_normal((b, h, m, dv)).astype(F),
            (rng.uniform(size=(b, h, m)) * 4.0).astype(F))


def _flat_carry(x, b, h):
    """The inputs as the reference's (N, ...) rows, kf and v broadcast."""
    return [jnp.asarray(np.broadcast_to(a, (b, h) + a.shape[2:])
                        .reshape(b * h, *a.shape[2:])) for a in x]


@pytest.mark.parametrize("b,h,hk,l,chunk,rho", [
    (2, 3, 1, 20, 16, False),   # GQA, L past one reference chunk (padded)
    (1, 2, 2, 7, 16, False),    # per head, one partial chunk
    (2, 3, 1, 1, 16, False),    # one token
    (1, 2, 1, 40, 16, False),   # three reference chunks
    # rho < 1 per query row: the reference's kernel from (rho S0, rho z0);
    # features at PRF scale (1/sqrt(m)): unscaled, z reaches ~150 by L =
    # 300, where f32's spacing is within 2x of the atol
    (2, 3, 1, 1, 16, True),
    (2, 3, 1, 37, 16, True),
    (1, 2, 2, 37, 16, True),
    (2, 3, 1, 300, 64, True),
    (1, 2, 2, 300, 64, True),
])
def test_carry_plain_matches_reference(b, h, hk, l, chunk, rho):
    m, dv = 16, 8
    x = _carry_inputs(b, h, hk, l, m, dv, seed=l + h,
                      feat_scale=m ** -0.5 if rho else 1.0)
    r = (np.exp(-np.random.default_rng(l).exponential(size=(b, h)))
         .astype(F) if rho else None)
    scaled = list(x) if r is None else [
        *x[:3], x[3] * r[..., None, None], x[4] * r[..., None]]
    fx = _flat_carry(scaled, b, h)
    exp_k = linear_attention_causal_carry_fwd(*fx, chunk=chunk, eps=1e-6,
                                              interpret=True)
    exp_r = ref.linear_attention_carry_ref(*fx, eps=1e-6)
    args = [torch.tensor(a) for a in x]
    ptrs = [args[3].data_ptr(), args[4].data_ptr()]
    n0 = kl.carry_launches
    kw = {} if r is None else {"rho": torch.tensor(r)}
    out, s, z = kl.linear_attention_prefill_chunk(*args, eps=1e-6, **kw)
    assert kl.carry_launches == n0
    assert [s.data_ptr(), z.data_ptr()] == ptrs            # in place
    for exp in (exp_k, exp_r):
        _close(out.reshape(b * h, l, dv), exp[0], KERNEL_ATOL, "out")
        _close(s.reshape(b * h, m, dv), exp[1], KERNEL_ATOL, "s")
        _close(z.reshape(b * h, m), exp[2], KERNEL_ATOL, "z")


def test_carry_plain_chained_chunks_match_single_pass():
    """Uneven resumed chunks reproduce one pass from the same state (the
    property chunked prefill rests on), as the reference's
    test_carry_kernel_chained_chunks_match_single_pass."""
    b, h, hk, l, m, dv = 2, 3, 1, 40, 16, 8
    qf, kf, v, s0, z0 = (torch.tensor(a) for a in
                         _carry_inputs(b, h, hk, l, m, dv, seed=5))
    s, z = s0.clone(), z0.clone()
    outs = [kl.linear_attention_prefill_chunk(
        qf[..., lo:hi, :].contiguous(), kf[..., lo:hi, :].contiguous(),
        v[..., lo:hi, :].contiguous(), s, z, eps=1e-6)[0]
        for lo, hi in ((0, 16), (16, 27), (27, 40))]
    full, sf, zf = ref.linear_attention_carry_ref(
        *_flat_carry([a.numpy() for a in (qf, kf, v, s0, z0)], b, h))
    _close(torch.cat(outs, -2).reshape(b * h, l, dv), full, KERNEL_ATOL)
    _close(s.reshape(b * h, m, dv), sf, KERNEL_ATOL)
    _close(z.reshape(b * h, m), zf, KERNEL_ATOL)


# ---------------------------------------------------------------------------
# B7 wkv6
# ---------------------------------------------------------------------------

def _wkv_inputs(n, l, dh, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((n, l, dh)).astype(F) for _ in range(3))
    w = (1 / (1 + np.exp(-(rng.standard_normal((n, l, dh)) + 2.0)))
         ).astype(F)
    u = (0.3 * rng.standard_normal(dh)).astype(F)
    return r, k, v, w, u


@pytest.mark.parametrize("n,l,dh,chunk", [
    (2, 16, 4, 8),
    (3, 50, 8, 16),          # the reference pads the last chunk
    (1, 1, 16, 8),
])
def test_wkv6_plain_matches_reference(n, l, dh, chunk):
    x = _wkv_inputs(n, l, dh, seed=l + dh)
    exp_k = wkv6_fwd(*map(jnp.asarray, x), chunk=chunk, interpret=True)
    exp_r, _ = ref.wkv6_ref(*map(jnp.asarray, x),
                            jnp.zeros((n, dh, dh), jnp.float32))
    n0 = kw.launches
    got = kw.wkv6(*(torch.tensor(a) for a in x))
    assert kw.launches == n0
    assert got.dtype == torch.float32 and got.shape == (n, l, dh)
    _close(got, exp_k, WKV_ATOL)
    _close(got, exp_r, WKV_ATOL)


def test_wkv6_gradients_match_reference():
    """Every input's gradient against ``jax.grad`` of ``ops.wkv6`` (whose
    backward is the oracle's VJP), with leading (batch, head) axes."""
    r, k, v, w, u = _wkv_inputs(6, 24, 4, seed=9)
    lead = lambda a: a.reshape(2, 3, 24, 4)  # noqa: E731
    r, k, v, w = map(lead, (r, k, v, w))
    cot = np.random.default_rng(1).standard_normal(r.shape).astype(F)

    def jf(*a):
        return jnp.sum(ops.wkv6(*a, chunk=8) * cot)
    exp = jax.grad(jf, argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)
    ins = [torch.tensor(a, requires_grad=True) for a in (r, k, v, w, u)]
    out = kw.wkv6(*ins)
    _close(out.detach(), ops.wkv6(r, k, v, w, u, chunk=8), WKV_ATOL)
    grads = torch.autograd.grad(out, ins, torch.tensor(cot))
    for gt, e, name in zip(grads, exp, "rkvwu"):
        assert gt.shape == e.shape, name
        _close(gt, e, GRAD_ATOL, name)


@pytest.mark.parametrize("bad", ["decode_rho_shape", "decode_kf_heads",
                                 "decode_v_float64", "decode_v_float16",
                                 "decode_qf_bf16", "carry_s0_dtype",
                                 "carry_z0_shape", "carry_rho_shape",
                                 "carry_rho_dtype", "wkv_dtype_mix",
                                 "wkv_u_shape"])
def test_two_stage_wrappers_reject_bad_arguments(bad):
    qf, kf, v, s, z = (torch.tensor(a)
                       for a in _carry_inputs(2, 3, 1, 5, 16, 8, seed=0))
    r, k, vv, w, u = (torch.tensor(a) for a in _wkv_inputs(2, 5, 8, 0))
    with pytest.raises((ValueError, TypeError)):
        if bad == "decode_rho_shape":
            kds.linear_attention_decode_step(
                qf[..., 0, :].contiguous(), kf[..., 0, :].contiguous(),
                v[..., 0, :].contiguous(), s, z, torch.ones(2, 3))
        elif bad == "decode_kf_heads":
            kds.linear_attention_decode_step(
                qf[..., 0, :].contiguous(), torch.ones(2, 2, 16),
                torch.ones(2, 2, 8), s, z, torch.ones(2, 2))
        elif bad in ("decode_v_float64", "decode_v_float16"):
            # v may be f32 or bf16 (the model's type), nothing else
            kds.linear_attention_decode_step(
                qf[..., 0, :].contiguous(), kf[..., 0, :].contiguous(),
                v[..., 0, :].to(torch.float64 if bad.endswith("64")
                                else torch.float16).contiguous(),
                s, z, torch.ones(2, 1))
        elif bad == "decode_qf_bf16":       # the features stay f32
            kds.linear_attention_decode_step(
                qf[..., 0, :].bfloat16().contiguous(),
                kf[..., 0, :].contiguous(), v[..., 0, :].contiguous(), s, z,
                torch.ones(2, 1))
        elif bad == "carry_s0_dtype":
            kl.linear_attention_prefill_chunk(qf, kf, v, s.double(), z)
        elif bad == "carry_z0_shape":
            kl.linear_attention_prefill_chunk(qf, kf, v, s, z[:, :1])
        elif bad == "carry_rho_shape":      # one per KV group, not per row
            kl.linear_attention_prefill_chunk(qf, kf, v, s, z,
                                              rho=torch.ones(2, 1))
        elif bad == "carry_rho_dtype":
            kl.linear_attention_prefill_chunk(
                qf, kf, v, s, z, rho=torch.ones(2, 3, dtype=torch.float64))
        elif bad == "wkv_dtype_mix":
            kw.wkv6(r, k.double(), vv, w, u)
        else:
            kw.wkv6(r, k, vv, w, u[:4])


# ---------------------------------------------------------------------------
# whole-prompt prefill: rf_attention_prefill(state=None) and lm.prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("hg,stabilize", [(3, True), (1, False)])
def test_whole_prompt_prefill_matches_reference(hg, stabilize, use_kernel):
    """The ``state=None`` branch: output and the new state (S, z, c)."""
    b, g, l, d, m = 2, 2, 11, 8, 16
    rng = np.random.default_rng(hg)
    q = rng.standard_normal((b, g, hg, l, d)).astype(F)
    k = rng.standard_normal((b, g, 1, l, d)).astype(F)
    v = rng.standard_normal((b, g, 1, l, d)).astype(F)
    fp = {"w": rng.standard_normal((g, m, d)).astype(F),
          "m_mat": (np.eye(d) + 0.2 * rng.standard_normal((g, d, d))
                    ).astype(F)}
    kw_ = dict(kind="darkformer", num_features=m, stabilize=stabilize)
    jo, js = jatt.rf_attention_prefill(
        q, k, v, {n: jnp.asarray(a) for n, a in fp.items()},
        jfm.FeatureConfig(**kw_), use_kernel=use_kernel)
    to, ts = tatt.rf_attention_prefill(
        torch.tensor(q), torch.tensor(k), torch.tensor(v),
        {n: torch.tensor(a) for n, a in fp.items()},
        tfm.FeatureConfig(**kw_), use_kernel=use_kernel)
    _close(to, jo, MODEL_ATOL, "out")
    for name in ("s", "z", "c"):
        assert getattr(ts, name).shape == getattr(js, name).shape, name
        _close(getattr(ts, name), getattr(js, name), MODEL_ATOL, name)


def _setup(arch, use_kernel):
    jcfg = dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                               use_kernel=use_kernel)
    tcfg = tcfgs.get_config(arch, reduced=True, use_kernel=use_kernel)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_lm_prefill_matches_reference(arch, use_kernel):
    """``lm.prefill``: last logits (B, 1, V) and every layer's state. The
    reference's fresh state is in the unit layout (leaves (n_units, ...),
    one unit a layer here), the port's layer-stacked."""
    jcfg, tcfg, jparams, tparams = _setup(arch, use_kernel)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 9))
    jlog, jst = jlm.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                            max_len=32)
    tlog, tst = tlm.prefill(tparams, tcfg,
                            {"tokens": torch.tensor(toks).long()}, max_len=32)
    assert tlog.shape == jlog.shape == (2, 1, jcfg.vocab)
    _close(tlog, jlog, MODEL_ATOL, "logits")
    jl = jst["units"]["b0"]
    for name in ("s", "z", "c"):
        _close(getattr(tst["layers"], name), getattr(jl, name), MODEL_ATOL,
               name)
    assert int(tst["pos"]) == int(jst["pos"]) == 9


def test_two_stage_steps_dispatch_to_their_kernels(monkeypatch):
    """With ``use_kernel`` and ``fused=False`` every layer calls the
    two-stage wrappers (B4 per prefill chunk, B3 per decode step) and
    never the fused ones; with ``fused=True`` the reverse."""
    cfg = tcfgs.get_config("darkformer-2b", reduced=True, use_kernel=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    calls = {}
    for name in ("linear_attention_prefill_chunk",
                 "linear_attention_decode_step", "fused_prf_prefill",
                 "fused_prf_decode"):
        def counted(*a, _fn=getattr(tkops, name), _n=name, **kw):
            calls[_n] = calls.get(_n, 0) + 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tkops, name, counted)
    toks = torch.tensor(np.random.default_rng(0).integers(0, cfg.vocab,
                                                          (2, 6)))
    for fused in (False, True):
        calls.clear()
        st = tlm.init_serve_state(cfg, b=2, max_len=32, per_slot=True,
                                  device="cpu")
        tlm.prefill_chunk(params, cfg, {"tokens": toks}, st,
                          valid_len=torch.tensor([6, 3], dtype=torch.int32),
                          fused=fused)
        tlm.decode_step(params, cfg, toks[:, 0], st, fused=fused)
        two = {"linear_attention_prefill_chunk": cfg.n_layers,
               "linear_attention_decode_step": cfg.n_layers}
        one = {"fused_prf_prefill": cfg.n_layers,
               "fused_prf_decode": cfg.n_layers}
        assert calls == (one if fused else two), fused


def test_wkv6_one_token_gradients():
    """At L = 1 no output reads w: its gradient is zero, as ``jax.grad``
    of ``ops.wkv6`` gives, and the others match."""
    x = _wkv_inputs(2, 1, 8, seed=4)
    exp = jax.grad(lambda *a: jnp.sum(ops.wkv6(*a, chunk=8)),
                   argnums=(0, 1, 2, 3, 4))(*x)
    ins = [torch.tensor(a, requires_grad=True) for a in x]
    grads = torch.autograd.grad(kw.wkv6(*ins).sum(), ins)
    assert not grads[3].any()
    for gt, e, name in zip(grads, exp, "rkvwu"):
        _close(gt, e, GRAD_ATOL, name)
