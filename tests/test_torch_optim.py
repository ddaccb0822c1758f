"""The port's optimizer, schedules and data streams against the
reference's.

AdamW (plain and factored second moment) and the schedules get the same
numpy trees and steps in both packages, and agree to f32 rounding; the
host-side data streams are bitwise the same.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import C4Mock as JC4Mock
from repro.data import SyntheticLM as JSyntheticLM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jinit
from repro.optim import adamw_update as jupdate
from repro.optim import schedules as jsched
from repro_torch import bridge
from repro_torch.data import C4Mock, SyntheticLM
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import schedules as tsched
from repro_torch.tree import flatten

torch.set_num_threads(1)
# f32 arithmetic in another order (sqrt, divisions, the global norm's sum)
TOL = dict(atol=1e-7, rtol=1e-5)


def _tree(rng, bf16):
    f = np.float32
    t = {"a": {"w": rng.standard_normal((3, 5, 4)).astype(f),
               "b": rng.standard_normal((7,)).astype(f)},
         "c": rng.standard_normal((6, 1)).astype(f),
         "s": np.asarray(rng.standard_normal(), f)}
    if bf16:
        t["h"] = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    return t


def _np(tree):
    return {jax.tree_util.keystr(p): np.asarray(v, np.float32) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _tnp(tree):
    return {p: v.float().numpy() for p, v in flatten(tree)}


@pytest.mark.parametrize("factored", [False, True])
def test_adamw_matches_reference(factored):
    """Four updates with clipping active, weight decay, a bf16 leaf and
    (factored) row/column second moments."""
    rng = np.random.default_rng(int(factored))
    params = _tree(rng, bf16=True)
    kw = dict(lr=1e-2, grad_clip=0.5, factored_second_moment=factored)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = bridge.tree_from_jax(params, device="cpu")
    jo, to = jinit(jp, jcfg), adamw_init(tp, tcfg)
    assert _tnp(to).keys() == _np(jo).keys()
    for i in range(4):
        grads = _tree(rng, bf16=True)
        lr = 1e-2 * (i + 1) / 4
        jp, jo, jm = jupdate(jp, jax.tree_util.tree_map(jnp.asarray, grads),
                             jo, jcfg, jnp.float32(lr))
        tp, to, tm = adamw_update(tp, bridge.tree_from_jax(grads, "cpu"),
                                  to, tcfg, torch.tensor(lr))
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), **TOL)
    for got, exp in ((_tnp(tp), _np(jp)), (_tnp(to), _np(jo))):
        assert got.keys() == exp.keys()
        for k in exp:
            # the bf16 leaf rounds once per update: allow one bf16 ulp
            tol = dict(atol=1e-2, rtol=1e-2) if "['h']" in k and \
                "mu" not in k and "nu" not in k else TOL
            np.testing.assert_allclose(got[k], exp[k], err_msg=k, **tol)
    assert tp["h"].dtype == torch.bfloat16
    assert all(v.dtype == torch.float32 for k, v in flatten(to["mu"]))


def test_schedules_match_reference():
    pairs = [(jsched.constant(3e-4), tsched.constant(3e-4)),
             (jsched.linear_warmup(1e-3, 5), tsched.linear_warmup(1e-3, 5)),
             (jsched.cosine_warmup(1e-3, 4, 20),
              tsched.cosine_warmup(1e-3, 4, 20)),
             (jsched.cosine_warmup(3e-4, 0, 7, 0.0),
              tsched.cosine_warmup(3e-4, 0, 7, 0.0))]
    for jf, tf in pairs:
        for step in range(25):
            np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                       rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize("task", ["bigram", "induction"])
def test_synthetic_lm_batches_are_bitwise_the_reference(task):
    for seed, step in ((0, 0), (3, 17)):
        kw = dict(vocab=97, seq_len=40, batch_size=3, seed=seed, task=task,
                  alphabet=8)
        exp = JSyntheticLM(**kw).batch(step)
        got = SyntheticLM(**kw).batch(step)
        assert exp.keys() == got.keys()
        for k in exp:
            assert got[k].dtype == exp[k].dtype
            assert np.array_equal(got[k], exp[k]), k


def test_c4mock_batches_are_bitwise_the_reference():
    for seed, step in ((0, 0), (2, 9)):
        exp = JC4Mock(300, 64, 4, seed=seed).batch(step)
        got = C4Mock(300, 64, 4, seed=seed).batch(step)
        for k in exp:
            assert got[k].dtype == exp[k].dtype
            assert np.array_equal(got[k], exp[k]), k
