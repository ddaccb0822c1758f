"""The param bridge between the packages, and the port's independence.

Every leaf of the reference's reduced param trees comes across to the
port and back bitwise; the port's own init draws a tree of the same
structure, shapes and dtypes; and no file of the port imports JAX or the
reference package.
"""
import dataclasses
import pathlib
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.models import lm as tlm

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _jax_tree(arch, dtype):
    cfg = dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                              dtype=dtype)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_params_round_trip_bitwise(arch, dtype):
    tree = _jax_tree(arch, dtype)
    cfg = tcfgs.get_config(arch, reduced=True, dtype=dtype)
    back = bridge.params_to_numpy(
        bridge.params_from_jax(tree, cfg, device="cpu"))
    got, exp = dict(_leaves(back)), dict(_leaves(tree))
    assert got.keys() == exp.keys()
    assert any("feat/w" in k for k in exp) and any("m_mat" in k for k in exp)
    for k, e in exp.items():
        assert got[k].dtype == e.dtype, k
        assert got[k].shape == e.shape, k
        assert got[k].tobytes() == e.tobytes(), k


@pytest.mark.parametrize("arch", ["smollm-135m", "darkformer-2b"])
def test_port_init_matches_reference_tree(arch):
    tree = _jax_tree(arch, "float32")
    cfg = tcfgs.get_config(arch, reduced=True)
    params = tlm.init_params(cfg, seed=0, device="cpu")
    got = {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
           for k, v in _leaves(params)}
    exp = {k: (v.shape, str(v.dtype)) for k, v in _leaves(tree)}
    assert got == exp
    # units map to layers 0..L-1 with the feature draws along
    layers = tlm.stack_layer_params(
        bridge.params_from_jax(tree, cfg, device="cpu"), cfg)
    w = tree["units"]["b0"]["attn"]["feat"]["w"]
    for u in range(cfg.n_layers):
        assert np.array_equal(layers["attn"]["feat"]["w"][u].numpy(), w[u])


def test_port_imports_neither_jax_nor_reference():
    """No file of the port, nor chip_smoke.py or the port's scripts and
    examples, imports JAX, the reference package or msgpack; ml_dtypes
    only inside ``bridge._to_numpy``, which the tests alone call (the
    card's machine has neither package)."""
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += sorted((ROOT / "scripts").glob("torch_*.py"))
    files += sorted((ROOT / "examples").glob("torch_*.py"))
    names = {f.relative_to(ROOT).as_posix() for f in files}
    for mod in ("core/attention", "core/feature_maps",
                "core/linear_attention", "kernels/linear_attn_scan",
                "kernels/prf_featmap", "kernels/prf_decode_step",
                "kernels/wkv6_scan", "kernels/check", "models/lm",
                "models/recurrent", "optim/adamw",
                "optim/schedules", "data/synthetic", "data/c4_mock",
                "checkpoint/store", "checkpoint/msgpack_subset",
                "launch/steps", "launch/train", "launch/mesh",
                "runtime/fault_tolerance", "parallel/sharding",
                "parallel/compression", "parallel/tensor_parallel",
                "tree"):
        assert f"src/repro_torch/{mod}.py" in names, mod
    assert "scripts/torch_decode_rows.py" in names
    assert {"examples/torch_quickstart.py",
            "examples/torch_long_context_serving.py"} <= names
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\.|"
                     r"from\s+repro\.|import\s+repro\s*$|from\s+repro\s+|"
                     r"import\s+msgpack\b|from\s+msgpack\b)",
                     re.MULTILINE)
    for f in files:
        hits = bad.findall(f.read_text())
        assert not hits, (f, hits)
        if f.name != "bridge.py":
            assert "ml_dtypes" not in f.read_text(), f
