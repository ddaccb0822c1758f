"""The dense attention configs of the port against the reference's:
granite-8b, qwen3-32b and yi-34b, reduced, on the CPU.

These configs bring what no other port test covers: ``qk_norm``
(qwen3-32b), an untied ``lm_head`` (all three), RoPE theta 1e6 and 5e6,
and 7 query heads per KV group (yi-34b's reduced MQA). Held here,
through ``tests/_torch_arch_parity.py`` at its stated tolerances:

  * every ``config()`` and ``reduced()`` field equal to the reference's,
    the port's own init drawing the reference's tree, layer by layer in
    the draw order the stacked init had;
  * the loss and every gradient against ``jax.grad``;
  * ragged packed ``prefill_chunk`` calls and decode steps (logits and
    every serve-state leaf), fused for each arch, two-stage once;
  * greedy engine streams token for token, one scheduler an arch;
  * checkpoints crossing both ways bitwise, ``qkv_only_freeze`` leaf by
    leaf, and both CLIs on each arch with ``--device cpu``.
"""
import dataclasses

import pytest
import torch

import _torch_arch_parity as par
from repro_torch import configs as tcfgs
from repro_torch.models import layers as tll
from repro_torch.models import lm as tlm
from repro_torch.tree import flatten, tree_map

torch.set_num_threads(1)
DENSE = ["granite-8b", "qwen3-32b", "yi-34b"]


def test_archs_lists_the_ported_configs_in_the_reference_order():
    from repro import configs as jcfgs
    assert tcfgs.ARCHS == jcfgs.ARCHS
    assert not hasattr(tcfgs, "NOT_PORTED")
    with pytest.raises(ValueError, match="unknown arch"):
        tcfgs.get_config("gpt-5")
    # A12c is done: rwkv6-7b loads, reduced and at full size
    assert tcfgs.get_config("rwkv6-7b").block_pattern == ("rwkv",)
    assert tcfgs.get_config("rwkv6-7b", reduced=True).n_layers == 2
    # A12e is done: internvl2-76b and hubert-xlarge load, reduced and at
    # full size, with their modalities
    assert tcfgs.get_config("internvl2-76b").modality == "vlm"
    assert tcfgs.get_config("internvl2-76b", reduced=True).num_patches == 8
    hubert = tcfgs.get_config("hubert-xlarge")
    assert hubert.modality == "audio" and not hubert.causal
    assert tcfgs.get_config("hubert-xlarge", reduced=True).n_layers == 2


@pytest.mark.parametrize("arch", DENSE)
def test_config_fields_match_reference(arch):
    par.assert_config_fields_match(arch)
    cfg = tcfgs.get_config(arch)
    assert cfg.head_dim == 128 and cfg.attn.num_features == 256
    assert not cfg.tie_embeddings and cfg.moe is None


@pytest.mark.parametrize("arch", DENSE)
def test_port_init_matches_reference_tree(arch):
    par.assert_init_tree_matches(arch)


@pytest.mark.parametrize("arch", ["qwen3-32b", "smollm-135m"])
def test_init_params_keeps_the_draw_order(arch):
    """``init_params`` writes each layer into stacked tensors as it is
    drawn; the values are the ones the draws in the order embed, layer
    0..L-1 (attention, then feed-forward), lm_head give when stacked at
    the end, so every seed gives the params it gave before."""
    cfg = tcfgs.get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(7)
    embed = tll.trunc_normal(gen, (cfg.vocab, cfg.d_model), 1.0)
    blocks = [tlm._block_init(gen, cfg) for _ in range(cfg.n_layers)]
    layers = tree_map(lambda *ts: torch.stack(ts), blocks[0], *blocks[1:])
    exp = {"embed": embed, "final_norm": tll.norm_init(
        cfg.norm_kind, cfg.d_model), "units": {"b0": layers}}
    if not cfg.tie_embeddings:
        exp["lm_head"] = tll.trunc_normal(gen, (cfg.d_model, cfg.vocab), 1.0)
    got = dict(flatten(tlm.init_params(cfg, seed=7, device="cpu")))
    assert got.keys() == dict(flatten(exp)).keys()
    for path, t in flatten(exp):
        assert torch.equal(got[path], t), path


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_every_gradient_match_jax_grad(arch):
    tm = par.check_loss_and_grads(arch)
    assert float(tm["aux"]) == 0.0


# the fused path (the card's) for each arch, the two-stage path once
@pytest.mark.parametrize("arch,use_kernel,fused", [
    *((a, True, True) for a in DENSE), ("yi-34b", True, False)])
def test_prefill_and_decode_match_reference(arch, use_kernel, fused):
    par.check_prefill_and_decode(arch, use_kernel, fused)


# one scheduler an arch: both are held against each other inside the
# port by tests/test_torch_overlap.py
@pytest.mark.parametrize("arch,overlap", [
    ("granite-8b", False), ("qwen3-32b", True), ("yi-34b", True)])
def test_greedy_streams_match_reference_engine(arch, overlap):
    par.check_engine_streams(arch, overlap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_untied_head_checkpoints_cross_between_packages(tmp_path, dtype):
    keys = par.check_checkpoints_cross("qwen3-32b", tmp_path, dtype)
    assert "['params']['lm_head']" in keys
    assert "['opt']['nu']['lm_head']" in keys
    assert "['params']['units']['b0']['attn']['q_norm']['scale']" in keys


def test_qkv_only_freeze_matches_reference():
    """On qwen3-32b, whose frozen leaves include the untied head and the
    q/k norms."""
    frozen = par.check_qkv_only_freeze("qwen3-32b")
    assert "['lm_head']" in frozen
    assert "['units']['b0']['attn']['k_norm']['scale']" in frozen


@pytest.mark.parametrize("arch", DENSE)
def test_clis_run_each_arch_in_process(arch, capsys):
    out = par.run_clis(arch, capsys)
    assert "lm_head" in out["params"]


def test_bridge_refuses_the_unit_rem_layout():
    """Every block kind of the reference is served since A12c, so the
    bridge refuses only a kind the reference does not know either: an
    ("attn", "rwkv") pattern of 3 layers (a unit, then an attention block
    in ``rem``) crosses it leaf for leaf, the rwkv block's
    ``tmix``/``cmix`` among them, and the port's own init draws the same
    tree."""
    jcfg, tcfg, jparams, _ = par.setup("granite-8b")
    kw = dict(block_pattern=("attn", "rwkv"), n_layers=3)
    jcfg, tcfg = (dataclasses.replace(c, **kw) for c in (jcfg, tcfg))
    jparams = par.jlm.init_params(par.jax.random.PRNGKey(1), jcfg)
    tree = par.jax.tree_util.tree_map(par.np.asarray, jparams)
    got = par.bridge.params_from_jax(tree, tcfg, device="cpu")
    exp = par.flat_np(jparams)
    flat = dict(flatten(got))
    assert flat.keys() == exp.keys()
    assert "['units']['b1']['tmix']['decay_a']" in flat
    assert "['rem'][0]['attn']['wq']" in flat
    for k, t in flat.items():
        assert par.bits(t.numpy()) == par.bits(exp[k]), k
    own = {k: (tuple(t.shape), t.dtype) for k, t in flatten(
        tlm.init_params(tcfg, device="cpu"))}
    assert own == {k: (tuple(t.shape), t.dtype) for k, t in flat.items()}
    unknown = dataclasses.replace(tcfg, block_pattern=("attn", "mamba"))
    with pytest.raises(ValueError, match="unknown block kind"):
        par.bridge.params_from_jax(tree, unknown, device="cpu")
