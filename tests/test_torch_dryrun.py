"""The port's dry-run report (``repro_torch.launch.dryrun``) against the
reference's sharding rules, with no device and nothing allocated.

For every assigned arch at full size: the port's parameter tree, walked
on the ``meta`` device, equals the reference's ``jax.eval_shape(
lm.init_params)`` leaf for leaf (path, shape, type). For every (arch x
shape x mesh) cell, pod (16, 16) and multi-pod (2, 16, 16): the skip and
its reason equal the reference's ``cell_supported``, and each rank's
bytes of params, AdamW state (train), batch and serve state (decode)
equal those of the reference's ``param_specs``/``opt_state_specs``/
``batch_specs``/``serve_state_specs`` on ``jax.sharding.AbstractMesh``,
each leaf's shard from ``NamedSharding(...).shard_shape``. The CLI
writes a report a cell and refuses ``--probe``.
"""
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.parallel import (batch_specs, opt_state_specs, param_specs,
                            serve_state_specs)
from repro_torch import configs as tcfgs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import AbstractMesh as TAbstractMesh
from repro_torch.tree import flatten

torch.set_num_threads(1)
KERNEL = "darkformer"           # the CLI's default kernel
CELLS = [(a, s, m) for a in tcfgs.ASSIGNED for s in tcfgs.SHAPES
         for m in dryrun.MESHES]
_REF: dict = {}
_PORT: dict = {}


def _jcfg(arch):
    import dataclasses
    cfg = jcfgs.get_config(arch)
    cfg = jcfgs.darkify(cfg, KERNEL, cfg.attn.num_features)
    return dataclasses.replace(cfg, remat="dots")


def _ref_params(arch):
    if arch not in _REF:
        _REF[arch] = jax.eval_shape(
            functools.partial(jlm.init_params, cfg=_jcfg(arch)),
            jax.random.PRNGKey(0))
    return _REF[arch]


def _port_params(arch):
    if arch not in _PORT:
        _PORT[arch] = dryrun.param_shapes(dryrun.cell_config(arch, KERNEL))
    return _PORT[arch]


def _ref_bytes(tree, specs, mesh) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(x.shape))
               * np.dtype(x.dtype).itemsize
               for x, s in zip(leaves, spec_leaves))


def _ref_cell(arch, shape, mesh_name):
    """The reference's cell: {"skipped": reason} or its per-rank bytes
    and parameter count, from its own spec functions."""
    cfg = _jcfg(arch)
    ok, why = jcfgs.cell_supported(cfg, shape)
    if not ok:
        return {"skipped": why}
    mesh = AbstractMesh(*dryrun.MESHES[mesh_name])
    sh = jcfgs.SHAPES[shape]
    pshape = _ref_params(arch)
    n = sum(int(x.size) for x in jax.tree_util.tree_leaves(pshape))
    pspecs = param_specs(pshape, mesh, moe=cfg.moe is not None,
                         overrides=cfg.sharding_overrides)
    batch = jcfgs.input_specs(cfg, shape)
    out = {"params": _ref_bytes(pshape, pspecs, mesh),
           "batch": _ref_bytes(batch, batch_specs(batch, mesh), mesh)}
    if sh["kind"] == "train":
        oshape = jax.eval_shape(functools.partial(
            jadamw_init, cfg=JAdamWConfig(factored_second_moment=n > 1e11)),
            pshape)
        out["opt_state"] = _ref_bytes(
            oshape, opt_state_specs(oshape, pspecs, mesh), mesh)
    if sh["kind"] == "decode":
        sshape = jax.eval_shape(functools.partial(
            jlm.init_serve_state, cfg, sh["global_batch"], sh["seq_len"]))
        out["serve_state"] = _ref_bytes(
            sshape, serve_state_specs(sshape, mesh), mesh)
    out["total"] = sum(out.values())
    return {"param_count": n, "bytes_per_rank": out}


@pytest.mark.parametrize("arch", tcfgs.ASSIGNED)
def test_param_shapes_match_reference(arch):
    """Every leaf of the port's meta-walked tree: path, shape and type
    as the reference's ``eval_shape``; nothing allocated."""
    ref = {jax.tree_util.keystr(p): x for p, x in
           jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]}
    got = dict(flatten(_port_params(arch)))
    assert list(got) == list(ref)
    for path, t in got.items():
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(ref[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == \
            np.dtype(ref[path].dtype).name, path


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS,
                         ids=[f"{a}-{s}-{m}" for a, s, m in CELLS])
def test_cell_bytes_match_reference(arch, shape, mesh_name):
    """A cell's skip (and its reason), parameter count and per-rank
    bytes, each kind of state apart, equal the reference's."""
    mesh = TAbstractMesh(*dryrun.MESHES[mesh_name])
    got = dryrun.build_cell(arch, shape, mesh, KERNEL,
                            params=_port_params(arch))
    ref = _ref_cell(arch, shape, mesh_name)
    ok, why = tcfgs.cell_supported(dryrun.cell_config(arch, KERNEL), shape)
    assert (ok, why) == (("skipped" not in ref), ref.get("skipped", ""))
    if "skipped" in ref:
        assert got == ref
        return
    assert got["param_count"] == ref["param_count"]
    assert got["bytes_per_rank"] == ref["bytes_per_rank"]


def test_cli_writes_every_cell_and_refuses_probe(tmp_path, capsys):
    """``--all --mesh both`` for two archs (one skipping its decode
    cells): a JSON a cell with the fields XLA's analyses gave listed as
    absent and none of them present; ``--probe`` exits with its
    reason."""
    out = tmp_path / "dr"
    for arch in ("smollm-135m", "hubert-xlarge"):
        assert dryrun.main(["--arch", arch, "--mesh", "both",
                            "--outdir", str(out)]) == 0
    files = sorted(p.name for p in out.iterdir())
    assert len(files) == 2 * len(tcfgs.SHAPES) * 2
    recs = [json.loads((out / f).read_text()) for f in files]
    assert sum(r["status"] == "skipped" for r in recs) == 4
    for r in recs:
        if r["status"] == "ok":
            assert not set(r["absent"]) & set(r), r
            assert r["bytes_per_rank"]["total"] > 0
    said = capsys.readouterr().out
    assert "dryrun summary: ok=8 skipped=0 errors=0" in said
    assert "dryrun summary: ok=4 skipped=4 errors=0" in said
    with pytest.raises(SystemExit, match="--probe is refused"):
        dryrun.main(["--probe", "--outdir", str(out)])


def test_cut_depth_sets_every_config_within():
    """``configs.cut_depth``: every config made within has the cut depth
    (the launchers' too), an explicit ``n_layers`` still wins, and the
    configs are whole again after."""
    from repro_torch.launch import train
    full = tcfgs.get_config("smollm-135m", reduced=True).n_layers
    with tcfgs.cut_depth(1):
        assert tcfgs.get_config("smollm-135m", reduced=True).n_layers == 1
        assert tcfgs.get_config("rwkv6-7b").n_layers == 1
        assert tcfgs.get_config("rwkv6-7b", n_layers=3).n_layers == 3
        out = train.main(["--arch", "smollm-135m", "--reduced", "--device",
                          "cpu", "--steps", "1", "--batch", "1", "--seq",
                          "8", "--log-every", "1"])
        assert out["config"].n_layers == 1
    assert tcfgs.get_config("smollm-135m", reduced=True).n_layers == full
