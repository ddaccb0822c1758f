"""The port's sharding rules (``repro_torch.parallel.sharding``) against
the reference's, with no process group.

Both run on meshes of axis names and sizes alone: the reference's on
``jax.sharding.AbstractMesh``, the port's on ``launch.mesh
.AbstractMesh``. The trees are the full-size archs' params and AdamW
states (the factored second moment too) as the reference's
``eval_shape`` gives them, rebuilt in the port as ``device="meta"``
tensors under the same key paths. ``param_specs`` (presets 2d and fsdp,
``shard_features``, each config's overrides, EP and its TP fallback)
and ``opt_state_specs`` must equal the reference's leaf for leaf on
(16, 16), (2, 16, 16), (4, 2), (2, 4) and (1, 1); ``batch_specs``,
``serve_state_specs`` and ``_divisible`` likewise. Then the specs'
DTensor placements.
"""
import ast
import itertools
import re

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JMesh
from jax.sharding import PartitionSpec as JP

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.parallel import sharding as jsh
from repro_torch import configs as tcfgs
from repro_torch.launch.mesh import AbstractMesh
from repro_torch.models import lm as tlm
from repro_torch.parallel import sharding as tsh
from repro_torch.tree import flatten

import _torch_arch_parity as par

torch.set_num_threads(1)
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")),
          ((1, 1), ("data", "model"))]
MESH_IDS = ["16x16", "2x16x16", "4x2", "2x4", "1x1"]


def _keys(path: str) -> list:
    return [ast.literal_eval(k) for k in re.findall(r"\[([^\]]*)\]", path)]


def _meta_tree(jtree):
    """The reference's tree as nested dicts and lists of meta tensors
    under the same key paths."""
    root: dict = {}
    for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        keys = _keys(jax.tree_util.keystr(p))
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = torch.empty(leaf.shape, device="meta")
    return _lists(root)


def _lists(node):
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            return [_lists(node[i]) for i in range(len(node))]
        return {k: _lists(v) for k, v in node.items()}
    return node


def _flat_ref(specs) -> dict:
    return {jax.tree_util.keystr(p): tuple(s) for p, s in
            jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, JP))[0]}


def _flat_port(specs) -> dict:
    return {p: tuple(s) for p, s in tsh._leaves_with_path(specs)}


_SHAPES: dict = {}


def _shapes(arch):
    """(reference params, reference factored AdamW state), eval_shape'd
    once an arch."""
    if arch not in _SHAPES:
        cfg = jcfgs.get_config(arch)
        ps = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
        op = jax.eval_shape(lambda: jadamw_init(
            ps, JAdamWConfig(factored_second_moment=True)))
        _SHAPES[arch] = (ps, op)
    return _SHAPES[arch]


@pytest.mark.parametrize("arch", tcfgs.ARCHS)
def test_param_and_opt_specs_match_reference(arch):
    """Every (mesh, preset, shard_features) at the config's overrides and
    MoE flag: the same spec at every param and optimizer-state leaf."""
    cfg = tcfgs.get_config(arch)
    jps, jop = _shapes(arch)
    tps, top = _meta_tree(jps), _meta_tree(jop)
    assert [p for p, _ in flatten(tps)] == \
        [jax.tree_util.keystr(p) for p, _ in
         jax.tree_util.tree_flatten_with_path(jps)[0]]
    moe = cfg.moe is not None
    for (shape, axes), preset, feat in itertools.product(
            MESHES, ("2d", "fsdp"), (False, True)):
        jm, tm = JMesh(shape, axes), AbstractMesh(shape, axes)
        kw = dict(moe=moe, preset=preset, shard_features=feat,
                  overrides=cfg.sharding_overrides)
        jspec = jsh.param_specs(jps, jm, **kw)
        tspec = tsh.param_specs(tps, tm, **kw)
        exp, got = _flat_ref(jspec), _flat_port(tspec)
        assert got == exp, (shape, preset, feat)
        assert _flat_port(tsh.opt_state_specs(top, tspec, tm)) == \
            _flat_ref(jsh.opt_state_specs(jop, jspec, jm)), (shape, preset)


def test_moe_expert_parallel_and_tp_fallback():
    """qwen3-moe's 128 experts divide a 16-way model axis (EP: experts
    over model); granite-moe's 40 do not (each expert's hidden dim over
    model), and without its overrides the fallback shows."""
    mesh = AbstractMesh((16, 16), ("data", "model"))
    qw = tsh.param_specs(_meta_tree(_shapes("qwen3-moe-235b-a22b")[0]),
                         mesh, moe=True)
    assert qw["units"]["b0"]["ffn"]["w_gate"] == \
        tsh.P(None, "model", None, "data")
    gr_p = _meta_tree(_shapes("granite-moe-3b-a800m")[0])
    gr = tsh.param_specs(gr_p, mesh, moe=True)
    assert gr["units"]["b0"]["ffn"]["w_gate"] == \
        tsh.P(None, None, None, "model")
    assert gr["units"]["b0"]["ffn"]["w_out"] == \
        tsh.P(None, None, "model", None)
    over = tsh.param_specs(gr_p, mesh, moe=True, overrides=tcfgs.get_config(
        "granite-moe-3b-a800m").sharding_overrides)
    assert over["units"]["b0"]["ffn"]["w_gate"] == \
        tsh.P(None, None, "data", "model")
    assert over["units"]["b0"]["attn"]["wq"] == tsh.P(None, "data", "model")


@pytest.mark.parametrize("arch", ["smollm-135m", "hubert-xlarge",
                                  "internvl2-76b"])
def test_batch_specs_match_reference(arch):
    cfg = jcfgs.get_config(arch, reduced=True)
    for b in (32, 6, 3):
        batch = dict(par.make_batch(cfg, seq=8, b=b))
        for (shape, axes), preset in itertools.product(MESHES,
                                                       ("2d", "fsdp")):
            exp = _flat_ref(jsh.batch_specs(batch, JMesh(shape, axes),
                                            preset))
            got = _flat_port(tsh.batch_specs(
                par.tokens(batch), AbstractMesh(shape, axes), preset))
            assert got == exp, (b, shape, preset)


@pytest.mark.parametrize("arch,kind", [
    ("smollm-135m", None), ("smollm-135m", "exact"),
    ("recurrentgemma-2b", None), ("recurrentgemma-2b", "exact"),
    ("rwkv6-7b", None), ("granite-moe-3b-a800m", None)])
def test_serve_state_specs_match_reference(arch, kind):
    """The engine's slot pools (per-slot, stacked where the layers stack)
    at full size: the port's meta-tensor state against the reference's
    eval_shape'd one, leaf by leaf (an rwkv block's state mapped by
    ``ref_state_path``)."""
    jcfg, tcfg = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if kind:
        jcfg, tcfg = jcfgs.darkify(jcfg, kind), tcfgs.darkify(tcfg, kind)
    stacked = tlm.can_stack_layers(tcfg)
    for b in (16, 6):
        jst = jax.eval_shape(lambda: jlm.init_serve_state(
            jcfg, b, 64, per_slot=True, stacked=stacked))
        tst = tlm.init_serve_state(tcfg, b, 64, per_slot=True,
                                   device="meta")
        for shape, axes in MESHES:
            exp = {par.ref_state_path(p): s for p, s in _flat_ref(
                jsh.serve_state_specs(jst, JMesh(shape, axes))).items()}
            got = _flat_port(tsh.serve_state_specs(
                tst, AbstractMesh(shape, axes)))
            assert got == exp, (b, shape)


def test_divisible_matches_reference():
    rng = np.random.default_rng(0)
    axes_opts = [None, "data", "model", ("model", "data"), ("data",),
                 ("pod", "data")]
    for (shape, axes) in MESHES:
        jm, tm = JMesh(shape, axes), AbstractMesh(shape, axes)
        names = set(axes)
        for _ in range(200):
            rank = int(rng.integers(1, 4))
            dims = tuple(int(d) for d in rng.choice(
                [1, 2, 3, 4, 8, 12, 16, 40, 48, 256], rank))
            opts = [a for a in axes_opts if a is None or set(
                a if isinstance(a, tuple) else (a,)) <= names]
            spec = tuple(opts[int(rng.integers(len(opts)))]
                         for _ in range(int(rng.integers(0, rank + 1))))
            assert tuple(tsh._divisible(dims, tsh.P(*spec), tm)) == \
                tuple(jsh._divisible(dims, JP(*spec), jm)), (dims, spec)
    assert tsh.dp_axes(AbstractMesh((2, 16, 16), ("pod", "data",
                                                  "model"))) == \
        jsh.dp_axes(JMesh((2, 16, 16), ("pod", "data", "model")))


class _FakeMesh:
    mesh_dim_names = ("data", "model")
    shape = (2, 2)


def test_placements_of_specs():
    """Mesh dim a gets Shard(i) where tensor dim i names a, else
    Replicate; a dim over ("model", "data") is Shard on both."""
    from torch.distributed.tensor import Replicate, Shard
    cases = {tsh.P("model", None): (Replicate(), Shard(0)),
             tsh.P(None, ("model", "data")): (Shard(1), Shard(1)),
             tsh.P(("data",), None): (Shard(0), Replicate()),
             tsh.P("model", "data"): (Shard(1), Shard(0)),
             tsh.P(): (Replicate(), Replicate())}
    for spec, exp in cases.items():
        assert tsh.NamedSharding(_FakeMesh(), spec).placements == exp, spec
