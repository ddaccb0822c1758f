"""Remat in the port's training forward (``lm.REMAT_POLICIES``, each
unit of layers under ``torch.utils.checkpoint``) against the reference's
``jax.checkpoint`` on the CPU.

For five reduced archs (recurrentgemma-2b with its ``rem`` block, MoE,
the audio encoder): under "full" and "dots" the loss and every gradient
equal the "none" ones bitwise, and each lies within OUT_TOL/GRAD_TOL of
the reference's ``jax.grad`` at the same remat; the bytes kept for the
backward (``saved_tensors_hooks``, plus the products "dots" keeps for
the recompute) fall from "none" to "dots" to "full", and the recompute
under "dots" multiplies none of the kept products again. The
linear-attention kernel's plain path runs its forward again in the
recompute. The configs carry the reference's ``remat`` and
``sharding_overrides``.
"""
import dataclasses

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro import configs as jcfgs
from repro_torch import configs as tcfgs
from repro_torch.kernels import linear_attn_scan
from repro_torch.models import lm as tlm
from repro_torch.models import remat as remat_lib
from repro_torch.tree import flatten

import _torch_arch_parity as par

torch.set_num_threads(1)
ARCHS = ["smollm-135m", "darkformer-2b", "recurrentgemma-2b",
         "granite-moe-3b-a800m", "hubert-xlarge"]
POLICIES = ("none", "full", "dots")


def _loss_and_grads(arch, remat, use_kernel=False):
    grads: dict = {}
    m = par.check_loss_and_grads(arch, use_kernel=use_kernel,
                                 grads_out=grads, remat=remat)
    return m, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_bitwise_and_against_reference(arch):
    """Each policy within tolerance of the reference at that policy, and
    "full" and "dots" bitwise the "none" loss and gradients."""
    base_m, base_g = _loss_and_grads(arch, "none")
    for remat in ("full", "dots"):
        m, g = _loss_and_grads(arch, remat)
        for k in ("loss", "ce", "z_loss", "aux", "accuracy"):
            assert par.bits(m[k].numpy()) == par.bits(base_m[k].numpy()), \
                (remat, k)
        assert g.keys() == base_g.keys()
        for path, t in g.items():
            assert torch.equal(t, base_g[path]), (remat, path)


def test_remat_with_the_kernel_path_bitwise():
    """``use_kernel`` (on the CPU the kernel wrapper's plain version):
    the linear-attention forward runs once a layer a step under "none"
    and twice under "full" and "dots" (the unit's recompute), with the
    gradients bitwise equal."""
    calls = []
    orig = linear_attn_scan.linear_attention_causal_plain

    def counting(*a, **k):
        if not torch.is_grad_enabled():     # the Function's forward
            calls.append(1)
        return orig(*a, **k)
    cfg0 = tcfgs.get_config("smollm-135m", reduced=True, use_kernel=True)
    params = tlm.init_params(cfg0, seed=0, device="cpu")
    batch = par.tokens(par.make_batch(cfg0))
    out = {}
    linear_attn_scan.linear_attention_causal_plain = counting
    try:
        for remat in POLICIES:
            calls.clear()
            cfg = dataclasses.replace(cfg0, remat=remat)
            leaves = [t.detach().requires_grad_() for _, t in
                      flatten(params)]
            tree = _rebuild(params, leaves)
            loss, _ = tlm.loss_fn(tree, cfg, batch)
            g = torch.autograd.grad(loss, leaves, allow_unused=True)
            out[remat] = (loss.detach(), g, len(calls))
    finally:
        linear_attn_scan.linear_attention_causal_plain = orig
    assert out["none"][2] == cfg0.n_layers
    for remat in ("full", "dots"):
        assert out[remat][2] == 2 * cfg0.n_layers, remat
        assert torch.equal(out[remat][0], out["none"][0])
        for a, b in zip(out[remat][1], out["none"][1]):
            assert (a is None and b is None) or torch.equal(a, b)


def _rebuild(params, leaves):
    by_path = dict(zip((p for p, _ in flatten(params)), leaves))
    from repro_torch.tree import map_with_path
    return map_with_path(lambda p, _: by_path[p], params)


def _saved_bytes(cfg, params, batch, monkeypatch):
    """Bytes the forward keeps for the backward: what reaches the
    outermost saved-tensor hooks (all of it under "none"; each unit's
    input under "full" and "dots"; the layers outside the units), plus
    the products "dots" keeps for the recompute."""
    kept = [0]
    keep = remat_lib._Kept.keep

    def counting_keep(self, out):
        kept[0] += out.numel() * out.element_size()
        keep(self, out)
    monkeypatch.setattr(remat_lib._Kept, "keep", counting_keep)

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t
    leaves = [t.detach().requires_grad_() for _, t in flatten(params)]
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        tlm.loss_fn(_rebuild(params, leaves), cfg, batch)
    return kept[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_saved_activation_bytes_fall(arch, monkeypatch):
    cfg0 = tcfgs.get_config(arch, reduced=True)
    params = tlm.init_params(cfg0, seed=0, device="cpu")
    batch = par.tokens(par.make_batch(cfg0, seq=32, b=2))
    kept = {r: _saved_bytes(dataclasses.replace(cfg0, remat=r), params,
                            batch, monkeypatch) for r in POLICIES}
    assert kept["none"] > kept["dots"] > kept["full"] > 0, kept


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-2b"])
def test_dots_recompute_skips_the_kept_products(arch):
    """The aten.mm/addmm calls of one loss and gradient: "full" runs
    every unit's products again in the recompute, "dots" hands back the
    kept ones and so runs exactly as many as "none"."""
    cfg0 = tcfgs.get_config(arch, reduced=True)
    params = tlm.init_params(cfg0, seed=0, device="cpu")
    batch = par.tokens(par.make_batch(cfg0))
    n = {}
    for remat in POLICIES:
        leaves = [t.detach().requires_grad_() for _, t in flatten(params)]
        mode = _CountMM()
        with mode:
            loss, _ = tlm.loss_fn(_rebuild(params, leaves),
                                  dataclasses.replace(cfg0, remat=remat),
                                  batch)
            torch.autograd.grad(loss, leaves, allow_unused=True)
        n[remat] = mode.n
    assert n["dots"] == n["none"] < n["full"], n


class _Products(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.bmm = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.bmm.default:
            self.bmm.append((tuple(args[0].shape), tuple(args[1].shape)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCHS)
def test_no_unbatched_einsum_reaches_bmm(arch):
    """"dots" saves aten.mm/addmm and recomputes aten.bmm. Every aten.bmm
    of the training forward is batched in the model's own terms: a batch
    of 1 only where the config has one KV group (the feature map's
    einsums over G = n_kv = 1, batched in JAX's sense too)."""
    cfg = tcfgs.get_config(arch, reduced=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    batch = par.tokens(par.make_batch(cfg))
    mode = _Products()
    with mode:
        tlm.loss_fn(params, cfg, batch)
    ones = [s for s in mode.bmm if s[0][0] == 1]
    assert not ones or cfg.n_kv == 1, ones
    for a, b in ones:
        assert a[2] == b[1] and a[2] == cfg.head_dim, (a, b)


def test_unknown_remat_raises_and_no_grad_runs_plain():
    cfg = tcfgs.get_config("smollm-135m", reduced=True, remat="some")
    params = tlm.init_params(cfg, seed=0, device="cpu")
    batch = par.tokens(par.make_batch(cfg))
    with pytest.raises(ValueError, match="unknown remat"):
        tlm.loss_fn(params, cfg, batch)
    with torch.no_grad():
        a, _ = tlm.loss_fn(params, dataclasses.replace(cfg, remat="full"),
                           batch)
        b, _ = tlm.loss_fn(params, dataclasses.replace(cfg, remat="none"),
                           batch)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_configs_carry_reference_remat_and_overrides(arch):
    for reduced in (False, True):
        j = jcfgs.get_config(arch, reduced=reduced)
        t = tcfgs.get_config(arch, reduced=reduced)
        assert t.remat == j.remat == ("none" if reduced else "dots")
        assert t.sharding_overrides == j.sharding_overrides
    assert tlm.REMAT_POLICIES.keys() == {"none", "full", "dots"}
