"""The port's LM serving steps against the reference's.

For the reduced smollm-135m and darkformer-2b (f32), the same params
(the reference's, brought across by ``repro_torch.bridge``) and the same
token chunks go through ``lm.prefill_chunk`` / ``lm.decode_step`` of both
packages, over a sequence of resumed ragged chunks and decode steps, with
and without ``use_kernel``, and under ``use_kernel`` with ``fused=False``
(the two-stage path). Logits and every serve-state leaf agree within
atol 1e-4 (f32 in other reduction orders across 3 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.models import lm as tlm
from repro_torch.serving import slots as tslots

torch.set_num_threads(1)
ATOL = 1e-4
# (L, valid_len) of each resumed chunk; no row is empty, as in serving
CHUNKS = [(6, (6, 2, 3)), (5, None), (7, (3, 7, 1))]


def _setup(arch, use_kernel):
    jcfg = dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                               use_kernel=use_kernel)
    tcfg = tcfgs.get_config(arch, reduced=True, use_kernel=use_kernel)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _assert_states_close(jstate, tstate, msg):
    jl, tl = jstate["layers"], tstate["layers"]
    for name in ("s", "z", "c"):
        np.testing.assert_allclose(
            getattr(tl, name).numpy(), np.asarray(getattr(jl, name)),
            atol=ATOL, rtol=0, err_msg=f"{name} {msg}")
    np.testing.assert_array_equal(tstate["pos"].numpy(),
                                  np.asarray(jstate["pos"]))


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_prefill_and_decode_match_reference(arch, use_kernel):
    _check_prefill_and_decode(arch, use_kernel, fused=True)


@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_two_stage_prefill_and_decode_match_reference(arch):
    """``fused=False`` under ``use_kernel``: the two-stage path (plain
    feature map, then the B4/B3 wrappers) in both packages."""
    _check_prefill_and_decode(arch, True, fused=False)


def _check_prefill_and_decode(arch, use_kernel, fused):
    jcfg, tcfg, jparams, tparams = _setup(arch, use_kernel)
    b = 3
    jstate = jlm.init_serve_state(jcfg, b=b, max_len=64, per_slot=True,
                                  stacked=True)
    tstate = tlm.init_serve_state(tcfg, b=b, max_len=64, per_slot=True,
                                  device="cpu")
    rng = np.random.default_rng(3)
    for step, (l, vl) in enumerate(CHUNKS):
        toks = rng.integers(0, jcfg.vocab, (b, l)).astype(np.int32)
        vl_np = None if vl is None else np.asarray(vl, np.int32)
        jlog, jstate = jlm.prefill_chunk(
            jparams, jcfg, {"tokens": jnp.asarray(toks)}, jstate,
            valid_len=None if vl is None else jnp.asarray(vl_np),
            fused=fused)
        tlog, tstate = tlm.prefill_chunk(
            tparams, tcfg, {"tokens": torch.tensor(toks).long()}, tstate,
            valid_len=None if vl is None else torch.tensor(vl_np),
            fused=fused)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"prefill logits, chunk {step}")
        _assert_states_close(jstate, tstate, f"after chunk {step}")
    for step in range(2):
        tok = rng.integers(0, jcfg.vocab, (b,)).astype(np.int32)
        jlog, jstate = jlm.decode_step(jparams, jcfg, jnp.asarray(tok),
                                       jstate, fused=fused)
        tlog, tstate = tlm.decode_step(tparams, tcfg,
                                       torch.tensor(tok).long(), tstate,
                                       fused=fused)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=ATOL, rtol=0,
                                   err_msg=f"decode logits, step {step}")
        _assert_states_close(jstate, tstate, f"after decode {step}")


@pytest.mark.parametrize("use_kernel", [False, True])
def test_inactive_slot_state_is_bitwise_frozen(use_kernel):
    """A decode over a pool with a free slot leaves that slot's (S, z, c)
    in every layer, and its pos, bitwise unchanged."""
    tcfg = tcfgs.get_config("smollm-135m", reduced=True,
                            use_kernel=use_kernel)
    params = tlm.init_params(tcfg, seed=1, device="cpu")
    pool = tlm.init_serve_state(tcfg, b=3, max_len=64, per_slot=True,
                                device="cpu")
    toks = torch.randint(0, tcfg.vocab, (3, 5),
                         generator=torch.Generator().manual_seed(0))
    tlm.prefill_chunk(params, tcfg, {"tokens": toks}, pool)
    before = tslots.read_slots(pool, torch.tensor([0, 1, 2]))
    logits = tslots.freeze_inactive(
        pool, torch.tensor([0, 2]), lambda st: tlm.decode_step(
            params, tcfg, torch.tensor([7, 9]), st))
    assert logits.shape == (2, tcfg.vocab)
    for name in ("s", "z", "c"):
        old = getattr(before["layers"], name)
        new = getattr(pool["layers"], name)
        assert torch.equal(old[:, 1], new[:, 1]), name
        if name != "c":        # the running max moves only on a new max
            assert not torch.equal(old[:, 0], new[:, 0]), name
            assert not torch.equal(old[:, 2], new[:, 2]), name
    assert pool["pos"].tolist() == [6, 5, 6]
