"""Mixture of experts in the port against the reference's, on the CPU:
``moe_apply`` alone and the MoE configs granite-moe-3b-a800m and
qwen3-moe-235b-a22b, reduced.

The reference's MoE (``repro.models.layers.moe_apply``) is plain ``jnp``
outside any Pallas kernel; the port's is plain torch. Held here, the
layer-level checks within ``F32_TOL`` (f32 in another summation order)
and ``GRAD_TOL``, the LM-level ones through
``tests/_torch_arch_parity.py`` at its stated tolerances:

  * ``moe_apply`` over several (E, k, capacity_factor) settings with
    dropped pairs: the routing (expert ids in top-k order, capacity
    positions, kept pairs) equal, output, aux loss and gradients close,
    and dropped pairs landing on slots that kept tokens hold (the
    scatter adds, as the reference's ``.at[].add``);
  * each config's fields and init tree; its loss (the aux loss summed
    over layers) and every gradient against ``jax.grad``; ragged packed
    prefill chunks and decode steps; greedy engine streams; all at the
    reference's own capacity_factor, with drops asserted;
  * the expert leaves and the untied head through checkpoints both ways,
    AdamW's factored second moment on the 4-D expert leaves over two
    train steps, ``qkv_only_freeze`` leaf by leaf, and both CLIs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_arch_parity as par
from repro.data import SyntheticLM
from repro.launch import steps as jsteps
from repro.models import layers as jll
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim.schedules import constant as jconstant
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as tll
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.serving import Request, ServingEngine
from repro_torch.tree import flatten

torch.set_num_threads(1)
MOE = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b"]
F32_TOL = dict(atol=1e-6, rtol=1e-5)
GRAD_TOL = par.GRAD_TOL


@pytest.fixture
def drops(monkeypatch):
    """The number of dropped (token, k) pairs of every ``moe_apply`` call
    the test makes, in call order."""
    seen = []
    route = tll.moe_route

    def counted(x, router, cfg):
        out = route(x, router, cfg)
        seen.append(int((~out[4]).sum()))
        return out
    monkeypatch.setattr(tll, "moe_route", counted)
    return seen


def _reference_routing(x, router, cfg):
    """The reference's routing, line for line from its ``moe_apply``:
    (idx, pos, in_cap)."""
    b, l, _ = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = max(1, int(cfg.capacity_factor * k * l / e))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ router, axis=-1)
    _, idx = jax.lax.top_k(probs, k)
    sel = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    pos_e = jnp.cumsum(sel.reshape(b, l * k, e), axis=1) - 1
    pos = jnp.take_along_axis(
        pos_e.reshape(b, l, k, e), idx[..., None], axis=-1)[..., 0]
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap)


# (E, k, capacity_factor, L): the reduced configs' experts, granite-moe's
# and qwen3-moe's full-width E and k, and tight capacities
MOE_CASES = [(8, 2, 1.25, 16), (8, 2, 0.5, 16), (40, 8, 1.25, 32),
             (128, 8, 1.25, 20), (4, 1, 1.0, 12), (16, 4, 0.25, 9)]


@pytest.mark.parametrize("e,k,cf,l", MOE_CASES)
def test_moe_apply_matches_reference(e, k, cf, l):
    """Routing equal, output and aux within F32_TOL, the gradients of x,
    the router and every expert leaf within GRAD_TOL; some pairs drop,
    and some dropped pair lands on a slot a kept token holds."""
    jcfg = jll.MoEConfig(num_experts=e, top_k=k, d_ff=24,
                         capacity_factor=cf)
    tcfg = tll.MoEConfig(num_experts=e, top_k=k, d_ff=24,
                         capacity_factor=cf)
    jp = jll.moe_init(jax.random.PRNGKey(e + k), 32, jcfg)
    rng = np.random.default_rng(l)
    x = rng.standard_normal((3, l, 32)).astype(np.float32)
    w = rng.standard_normal((3, l, 32)).astype(np.float32)

    def jloss(p, x):
        out, aux = jll.moe_apply(p, x, jcfg)
        return jnp.sum(out * w) + aux, (out, aux)
    (_, (jout, jaux)), (jg, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))

    tp = {n: torch.tensor(np.asarray(v), requires_grad=True)
          for n, v in jp.items()}
    tx = torch.tensor(x, requires_grad=True)
    tout, taux = tll.moe_apply(tp, tx, tcfg)
    grads = torch.autograd.grad((tout * torch.tensor(w)).sum() + taux,
                                [tx, *tp.values()])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **F32_TOL)
    np.testing.assert_allclose(float(taux.detach()), float(jaux),
                               **F32_TOL)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **GRAD_TOL)
    for (name, _), g in zip(tp.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]),
                                   err_msg=name, **GRAD_TOL)

    _, gates, idx, pos, in_cap, cap = tll.moe_route(
        torch.tensor(x), tp["router"].detach(), tcfg)
    jidx, jpos, jin = _reference_routing(jnp.asarray(x), jp["router"], jcfg)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_array_equal(pos.numpy(), jpos)
    np.testing.assert_array_equal(in_cap.numpy(), jin)
    assert bool((gates.sum(-1) - 1).abs().max() < 1e-6)
    assert int((~in_cap).sum()) > 0
    kept = {(b, i) for b in range(3) for i, p, c in zip(
        jidx[b].ravel(), jpos[b].ravel(), jin[b].ravel())
        if c and p == cap - 1}
    landed = [(b, i) for b in range(3) for i, c in zip(
        jidx[b].ravel(), jin[b].ravel()) if not c]
    assert any(pair in kept for pair in landed)


@pytest.mark.parametrize("arch", MOE)
def test_config_fields_match_reference(arch):
    par.assert_config_fields_match(arch)
    cfg = tcfgs.get_config(arch)
    assert cfg.moe.top_k == 8 and cfg.moe.capacity_factor == 1.25


@pytest.mark.parametrize("arch", MOE)
def test_port_init_matches_reference_tree(arch):
    par.assert_init_tree_matches(arch)


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_every_gradient_match_jax_grad(arch, drops):
    """At the reference's capacity_factor: tokens drop in the forward,
    the aux loss (summed over both layers) and every gradient agree."""
    tm = par.check_loss_and_grads(arch)
    assert len(drops) == 2 and all(n > 0 for n in drops), drops
    assert float(tm["aux"]) > 0


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch, drops):
    """The fused path (the card's): ragged packed chunks, whose padded
    positions take capacity in both packages, and decode steps."""
    par.check_prefill_and_decode(arch, use_kernel=True)
    assert sum(drops) > 0


@pytest.mark.parametrize("arch,overlap", [(MOE[0], False), (MOE[1], True)])
def test_greedy_streams_match_reference_engine(arch, overlap):
    par.check_engine_streams(arch, overlap)


def test_overlap_matches_sequential_at_one_row():
    """With one staged row per prefill call both schedulers grant the same
    chunks, so MoE's capacities (which depend on the chunk's length)
    agree and the greedy streams are equal token for token."""
    cfg = tcfgs.get_config(MOE[0], reduced=True, use_kernel=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, int(n)).tolist()
               for n in rng.integers(6, 30, 6)]
    gens = rng.integers(3, 9, 6).tolist()
    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=3, max_len=48,
                            chunk_tokens=16, prefill_rows=1, overlap=overlap,
                            device="cpu")
        uids = [eng.submit(Request(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, gens)]
        got = {r.uid: r.tokens for r in eng.run()}
        streams.append([got[u] for u in uids])
    assert streams[0] == streams[1]
    assert [len(t) for t in streams[0]] == gens


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_expert_checkpoints_cross_between_packages(tmp_path, dtype):
    keys = par.check_checkpoints_cross(MOE[1], tmp_path, dtype)
    for leaf in ("router", "w_gate", "w_up", "w_out"):
        assert f"['params']['units']['b0']['ffn']['{leaf}']" in keys
        assert f"['opt']['mu']['units']['b0']['ffn']['{leaf}']" in keys
    assert "['params']['lm_head']" in keys


def test_factored_adamw_steps_match_reference():
    """From one shared state (the reference's after one of its own steps)
    two more train steps in each package with AdamW's factored second
    moment: the expert leaves are 4-D, (layers, E, d, f), and keep row
    factors of shape (layers, E, d) and column factors (layers, E, f).
    Losses, every param and every moment agree."""
    jcfg, tcfg, jparams, _ = par.setup(MOE[0])
    kw = dict(lr=3e-3, factored_second_moment=True)
    jopt_cfg = JAdamWConfig(**kw)
    jstep = jax.jit(jsteps.make_train_step(jcfg, jopt_cfg, jconstant(3e-3)))
    jopt = jadamw_init(jparams, jopt_cfg)
    data = SyntheticLM(jcfg.vocab, 16, 4, seed=2)
    jparams, jopt, _ = jstep(jparams, jopt, dict(data.batch(0)),
                             jnp.int32(0))
    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa
    tparams = bridge.params_from_jax(to_np(jparams), tcfg, device="cpu")
    topt = bridge.tree_from_jax(to_np(jopt), device="cpu")
    nu = topt["nu"]["units"]["b0"]["ffn"]["w_gate"]
    assert tuple(nu["row"].shape) == (2, 8, 64)
    assert tuple(nu["col"].shape) == (2, 8, 32)
    assert tuple(adamw_init(tparams, AdamWConfig(**kw))["nu"]["units"]["b0"]
                 ["ffn"]["w_out"]["col"].shape) == (2, 8, 64)
    tstep = tsteps.make_train_step(tcfg, AdamWConfig(**kw), constant(3e-3))
    for s in (1, 2):
        b = data.batch(s)
        jparams, jopt, jm = jstep(jparams, jopt, dict(b), jnp.int32(s))
        tparams, topt, tm = tstep(tparams, topt, par.tokens(b), s)
        for name in ("loss", "aux", "grad_norm"):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       err_msg=f"{name} step {s}",
                                       **par.OUT_TOL)
    got = dict(flatten({"params": tparams, "opt": topt}))
    exp = par.flat_np({"params": jparams, "opt": jopt})
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        np.testing.assert_allclose(got[path].numpy(), e, err_msg=path,
                                   atol=1e-5, rtol=1e-4)


def test_qkv_only_freeze_matches_reference():
    """On granite-moe-3b-a800m: the router and the experts are frozen."""
    frozen = par.check_qkv_only_freeze(MOE[0])
    for leaf in ("router", "w_gate", "w_up", "w_out"):
        assert f"['units']['b0']['ffn']['{leaf}']" in frozen


@pytest.mark.parametrize("arch", MOE)
def test_clis_run_each_arch_in_process(arch, capsys):
    out = par.run_clis(arch, capsys)
    assert out["metrics"][-1]["aux"] > 0
    cfg = tcfgs.get_config(arch, reduced=True)
    assert tuple(out["params"]["units"]["b0"]["ffn"]["w_gate"].shape) == (
        cfg.n_layers, cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff)


def test_serving_drops_the_aux_loss(monkeypatch):
    """``prefill_chunk`` and ``decode_step`` run the MoE feed-forward and
    return logits only, as the reference's; ``forward_train`` returns
    the sum of the layers' aux losses."""
    cfg = tcfgs.get_config(MOE[1], reduced=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    st = tlm.init_serve_state(cfg, b=2, max_len=32, per_slot=True,
                              device="cpu")
    logits, _ = tlm.prefill_chunk(params, cfg, {"tokens": toks}, st)
    assert logits.shape == (2, cfg.vocab)
    auxes = []
    apply = tll.moe_apply

    def kept(p, x, c):
        out, aux = apply(p, x, c)
        auxes.append(float(aux))
        return out, aux
    monkeypatch.setattr(tll, "moe_apply", kept)
    _, aux = tlm.forward_train(params, cfg, {"tokens": toks})
    assert len(auxes) == cfg.n_layers
    np.testing.assert_allclose(float(aux), sum(auxes), rtol=1e-6)
