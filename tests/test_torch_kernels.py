"""The port's fused PRF kernels against the reference's.

On the CPU the wrappers ``repro_torch.kernels.fused_prf_decode`` /
``fused_prf_prefill`` run their plain PyTorch versions; these are held
against the reference ``ops.fused_prf_decode`` / ``ops.fused_prf_prefill``
(Pallas in interpret mode), on the same numpy inputs, at the reference's
own tolerance for the same math in another reduction order (atol 2e-5,
rtol 2e-4, as tests/test_fused_prefill.py). tests/test_torch_cuda.py
holds the CUDA kernels against these plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels import prf_fused_decode as kd
from repro_torch.kernels import prf_fused_prefill as kp

torch.set_num_threads(1)
ATOL, RTOL = 2e-5, 2e-4


def _inputs(b, g, hg, d, r, m, dv, l, dark, seed):
    """Numpy inputs of one call; l=None gives the decode layout."""
    rng = np.random.default_rng(seed)
    f = np.float32
    lq = () if l is None else (l,)
    x = {"q": rng.standard_normal((b, g, hg, *lq, d)).astype(f),
         "k": rng.standard_normal((b, g, *lq, d)).astype(f),
         "v": rng.standard_normal((b, g, *lq, dv)).astype(f)}
    w = rng.standard_normal((g, m, r if dark else d)).astype(f)
    if dark:
        x["m_mat"] = (0.4 * rng.standard_normal((g, r, d))).astype(f)
        x["a"] = np.einsum("gmr,grd->gdm", w, x["m_mat"]).astype(f)
    else:
        x["m_mat"] = None
        x["a"] = np.ascontiguousarray(np.swapaxes(w, -1, -2))
    x["s"] = rng.standard_normal((b, g, hg, m, dv)).astype(f)
    x["z"] = (rng.uniform(size=(b, g, hg, m)) + 0.5).astype(f)
    x["c"] = (rng.standard_normal((b, g)) + 1.0).astype(f)
    return x


ORDER = ("q", "k", "v", "a", "m_mat", "s", "z", "c")


def _torch(x, device="cpu"):
    return [None if x[n] is None
            else torch.tensor(np.ascontiguousarray(x[n]), device=device)
            for n in ORDER]


def _jax(x):
    return [None if x[n] is None else jnp.asarray(x[n]) for n in ORDER]


def _assert_close(got, exp, valid_len=None, l=None, msg=""):
    for o, e, name in zip(got, exp, ("out", "s", "z", "c")):
        o = np.asarray(o, np.float32)
        e = np.asarray(e, np.float32)
        if name == "out" and valid_len is not None:
            # outputs at masked positions are garbage by contract
            mask = (np.arange(l)[None] < np.asarray(valid_len)[:, None]
                    )[:, None, None, :, None]
            o = np.where(mask, o, 0.0)
            e = np.where(mask, e, 0.0)
        np.testing.assert_allclose(o, e, atol=ATOL, rtol=RTOL,
                                   err_msg=f"{name} {msg}")


DECODE_CASES = [  # b, g, hg, d, r, m, dv, dark, stabilize
    (3, 2, 2, 8, 4, 16, 8, True, True),       # GQA, darkformer
    (2, 1, 4, 8, 8, 16, 8, False, True),      # MQA, isotropic
    (4, 3, 1, 8, 4, 16, 8, True, False),      # no stabilizer
    (2, 2, 3, 16, 16, 32, 16, False, False),  # isotropic, no stabilizer
]

PREFILL_CASES = [  # b, g, hg, d, r, m, dv, l, dark, stab, chunk, valid_len
    (3, 2, 2, 8, 4, 16, 8, 12, True, True, 16, None),       # GQA
    (4, 1, 3, 8, 8, 16, 8, 7, False, True, 4, None),        # MQA iso, L>T
    (2, 2, 2, 8, 4, 16, 8, 9, True, False, 4, None),        # no stabilizer
    (4, 2, 2, 8, 4, 16, 8, 10, True, True, 4, (0, 3, 10, 7)),   # ragged
    (3, 1, 4, 8, 4, 16, 8, 11, False, False, 16, (11, 5, 0)),  # iso ragged
]


@pytest.mark.parametrize("b,g,hg,d,r,m,dv,dark,stab", DECODE_CASES)
def test_plain_decode_matches_reference(b, g, hg, d, r, m, dv, dark, stab):
    x = _inputs(b, g, hg, d, r, m, dv, None, dark, seed=b * 11 + m)
    exp = ops.fused_prf_decode(*_jax(x), stabilize=stab, eps=1e-6)
    args = _torch(x)
    ptrs = [t.data_ptr() for t in args[5:]]
    n0 = kd.launches
    got = kd.fused_prf_decode(*args, stabilize=stab, eps=1e-6)
    _assert_close(got, exp, msg=(b, g, hg, dark, stab))
    # state advanced in place; no kernel launched for CPU tensors
    assert [t.data_ptr() for t in got[1:]] == ptrs
    assert kd.launches == n0


@pytest.mark.parametrize("b,g,hg,d,r,m,dv,l,dark,stab,chunk,valid_len",
                         PREFILL_CASES)
def test_plain_prefill_matches_reference(b, g, hg, d, r, m, dv, l, dark,
                                         stab, chunk, valid_len):
    x = _inputs(b, g, hg, d, r, m, dv, l, dark, seed=b * 7 + l)
    vl = None if valid_len is None else np.asarray(valid_len, np.int32)
    exp = ops.fused_prf_prefill(
        *_jax(x), None if vl is None else jnp.asarray(vl),
        stabilize=stab, eps=1e-6, chunk=chunk)
    args = _torch(x)
    ptrs = [t.data_ptr() for t in args[5:]]
    n0 = kp.launches
    got = kp.fused_prf_prefill(
        *args, None if vl is None else torch.tensor(vl),
        stabilize=stab, eps=1e-6, chunk=chunk)
    _assert_close(got, exp, valid_len, l, msg=(b, g, hg, l, chunk))
    assert [t.data_ptr() for t in got[1:]] == ptrs
    assert kp.launches == n0


def test_valid_len_zero_row_advances_by_nothing():
    """A valid_len = 0 row keeps S, z, c bitwise (rho = 1, every kf 0)."""
    x = _inputs(2, 2, 2, 8, 4, 16, 8, 6, True, 0)
    args = _torch(x)
    before = [t.clone() for t in args[5:]]
    kp.fused_prf_prefill(*args, torch.tensor([0, 6], dtype=torch.int32))
    for old, new in zip(before, args[5:]):
        assert torch.equal(old[0], new[0])
        assert not torch.equal(old[1], new[1])


@pytest.mark.parametrize("kernel,bad", [
    ("decode", "noncontiguous"), ("decode", "dtype"), ("decode", "shape"),
    ("prefill", "noncontiguous"), ("prefill", "dtype"), ("prefill", "shape"),
    ("prefill", "valid_len_dtype")])
def test_wrappers_reject_bad_arguments(kernel, bad):
    l = None if kernel == "decode" else 4
    args = _torch(_inputs(2, 1, 2, 8, 4, 16, 8, l, True, 1))
    vl = torch.tensor([4, 2], dtype=torch.int32)
    if bad == "noncontiguous":          # same shape, every other element
        args[0] = torch.cat([args[0], args[0]], dim=-1)[..., ::2]
    elif bad == "dtype":
        args[5] = args[5].double()
    elif bad == "shape":
        args[6] = args[6][:, :, :1]
    else:
        vl = vl.long()
    with pytest.raises((ValueError, TypeError)):
        if kernel == "decode":
            kd.fused_prf_decode(*args)
        else:
            kp.fused_prf_prefill(*args, vl)


# ---------------------------------------------------------------------------
# B5 linear_attention_causal and B6 prf_featmap: the autograd wrappers
# ---------------------------------------------------------------------------

from repro.kernels import ref  # noqa: E402
from repro_torch.kernels import linear_attn_scan as kl  # noqa: E402
from repro_torch.kernels import prf_featmap as kf  # noqa: E402


def _lin_inputs(b, hq, hk, l, m, dv, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (np.exp(0.5 * rng.standard_normal((b, hq, l, m))).astype(f),
            np.exp(0.5 * rng.standard_normal((b, hk, l, m))).astype(f),
            rng.standard_normal((b, hk, l, dv)).astype(f))


@pytest.mark.parametrize("hk,l", [(1, 1), (1, 20), (3, 7), (3, 40)])
def test_linear_attention_matches_reference(hk, l):
    """Forward against ``ref.linear_attention_causal_ref`` and
    ``ops.linear_attention_causal`` (Pallas, interpret mode, chunk 16),
    and gradients against ``jax.grad`` of the latter, with kf and v
    shared by the 3 query heads (hk = 1) or per head."""
    qf, kf_, v = _lin_inputs(2, 3, hk, l, 16, 8, seed=l + hk)
    cot = np.random.default_rng(0).standard_normal((2, 3, l, 8)).astype(
        np.float32)
    bq = lambda a: np.broadcast_to(a, qf.shape[:2] + a.shape[2:])  # noqa
    exp_ref = ref.linear_attention_causal_ref(
        qf.reshape(-1, l, 16), bq(kf_).reshape(-1, l, 16),
        bq(v).reshape(-1, l, 8), eps=1e-6).reshape(2, 3, l, 8)

    def jf(q, k, vv):
        k, vv = (jnp.broadcast_to(a, q.shape[:2] + a.shape[2:])
                 for a in (k, vv))
        return jnp.sum(ops.linear_attention_causal(q, k, vv, chunk=16,
                                                   eps=1e-6) * cot)
    exp_grads = jax.grad(jf, argnums=(0, 1, 2))(qf, kf_, v)
    ins = [torch.tensor(a, requires_grad=True) for a in (qf, kf_, v)]
    n0 = kl.launches
    out = kl.linear_attention_causal(*ins, eps=1e-6)
    assert kl.launches == n0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp_ref),
                               atol=ATOL, rtol=RTOL)
    grads = torch.autograd.grad(out, ins, torch.tensor(cot))
    for g, e, name in zip(grads, exp_grads, ("qf", "kf", "v")):
        assert g.shape == ins[("qf", "kf", "v").index(name)].shape
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("dark", [True, False])
def test_prf_featmap_matches_reference(dark):
    """Forward against ``ref.prf_featmap_ref`` and ``ops.prf_featmap``
    (Pallas, interpret mode), gradients (x, M, W, c) against ``jax.grad``
    of the latter, over 37 rows (not a multiple of its row block)."""
    rng = np.random.default_rng(int(dark))
    f = np.float32
    d, r, m = 8, 6, 16
    x = (0.6 * rng.standard_normal((37, d))).astype(f)
    mm = (np.eye(r, d) + 0.2 * rng.standard_normal((r, d))).astype(f) \
        if dark else None
    w = rng.standard_normal((m, r if dark else d)).astype(f)
    c = f(0.7)
    cot = rng.standard_normal((37, m)).astype(f)
    exp = ops.prf_featmap(x, mm, w, c, block_n=16)
    np.testing.assert_allclose(np.asarray(exp),
                               np.asarray(ref.prf_featmap_ref(x, mm, w, c)),
                               atol=ATOL, rtol=RTOL)
    if dark:
        jg = jax.grad(lambda *a: jnp.sum(ops.prf_featmap(
            a[0], a[1], a[2], a[3], block_n=16) * cot),
            argnums=(0, 1, 2, 3))(x, mm, w, c)
    else:
        jg = jax.grad(lambda *a: jnp.sum(ops.prf_featmap(
            a[0], None, a[1], a[2], block_n=16) * cot),
            argnums=(0, 1, 2))(x, w, c)
    ins = [torch.tensor(a, requires_grad=True)
           for a in ((x, mm, w, c) if dark else (x, w, c))]
    n0 = kf.launches
    out = (kf.prf_featmap(*ins) if dark
           else kf.prf_featmap(ins[0], None, *ins[1:]))
    assert kf.launches == n0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp),
                               atol=ATOL, rtol=RTOL)
    for g, e in zip(torch.autograd.grad(out, ins, torch.tensor(cot)), jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(e), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("bad", ["qf_dtype", "kf_heads", "noncontiguous",
                                 "featmap_rank", "featmap_c"])
def test_training_kernel_wrappers_reject_bad_arguments(bad):
    qf, kf_, v = (torch.tensor(a) for a in _lin_inputs(2, 3, 1, 5, 16, 8, 0))
    x, w = torch.randn(4, 8), torch.randn(16, 8)
    with pytest.raises((ValueError, TypeError)):
        if bad == "qf_dtype":
            kl.linear_attention_causal(qf.double(), kf_, v)
        elif bad == "kf_heads":
            kl.linear_attention_causal(qf, torch.cat([kf_, kf_], 1),
                                       torch.cat([v, v], 1))
        elif bad == "noncontiguous":
            kl.linear_attention_causal(qf.transpose(-1, -2).contiguous()
                                       .transpose(-1, -2), kf_, v)
        elif bad == "featmap_rank":
            kf.prf_featmap(x, None, torch.randn(16, 6))
        else:
            kf.prf_featmap(x, None, w, torch.zeros(2))
