"""The reference's last public functions in the port, and its two
examples, on the CPU:

  * ``core.feature_maps.trig_features`` and ``FEATURE_KINDS`` against
    the reference's;
  * the names ``repro_torch.core`` and ``repro_torch.models`` export:
    every public name of ``repro.core`` and ``repro.models`` whose
    module has a counterpart in the port;
  * ``launch.steps.make_prefill_step``/``make_decode_step``: greedy
    streams of the reduced smollm-135m from the reference's params,
    against the reference's jitted steps;
  * ``serving.slots.write_slot``/``read_slot``: a seeded B = 1 serve
    state written into a pool and read back, leaf by leaf
    against the reference's, in the stacked and the unit/rem layouts,
    PRF and exact;
  * ``examples/torch_quickstart.py`` and
    ``examples/torch_long_context_serving.py`` at a few steps and short
    contexts.
"""
import importlib.util
import math
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core
import repro.models
import repro_torch.core
import repro_torch.models
from repro import configs as jcfgs
from repro.core import feature_maps as jfm
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.serving import slots as jslots
from repro_torch import configs as tcfgs
from repro_torch.core import feature_maps as tfm
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.serving import slots as tslots

import _torch_arch_parity as par

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
# f32 cos/sin of a d = 8 projection times exp(|x|^2 / 2), the sums in
# another order: relative to the largest |feature| (an entry near a zero
# of cos or sin keeps no relative precision); 3.9e-7 read at the seed
TRIG_RTOL = 1e-6
PROMPT, GEN = 12, 8


def test_trig_features_match_reference():
    """(2, 16, 8) inputs, m = 16: (2, 16, 32) features equal to the
    reference's within ``TRIG_RTOL`` of the largest."""
    rng = np.random.default_rng(0)
    # scaled by d^-1/4 as attention scales q and k before its features
    x = (rng.standard_normal((2, 16, 8)) * 8 ** -0.25).astype(np.float32)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    exp = np.asarray(jfm.trig_features(jnp.asarray(x), jnp.asarray(w)))
    got = tfm.trig_features(torch.from_numpy(x), torch.from_numpy(w))
    assert got.shape == exp.shape == (2, 16, 32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=0,
                               atol=TRIG_RTOL * np.abs(exp).max())


def test_feature_kinds_and_trig_refused():
    """``FEATURE_KINDS`` is the reference's tuple; attention refuses
    "trig" as the reference's ``qk_features`` does."""
    assert tfm.FEATURE_KINDS == jfm.FEATURE_KINDS
    q = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError):
        tfm.qk_features(q, q, torch.zeros(16, 8), "trig")


def _public(ref: types.ModuleType) -> dict:
    """{name: has a counterpart in the port} over the public names of a
    reference package: a submodule whose port module exists, or an
    object one of whose defining submodules' port modules has it."""
    subs = [m for name, m in sorted(sys.modules.items())
            if name.startswith(ref.__name__ + ".")]

    def port(name):
        name = "repro_torch" + name.removeprefix("repro")
        return (importlib.import_module(name)
                if importlib.util.find_spec(name) else None)
    out = {}
    for n, obj in vars(ref).items():
        if n.startswith("_"):
            continue
        if isinstance(obj, types.ModuleType):
            out[n] = port(obj.__name__) is not None
        else:
            out[n] = any(hasattr(port(m.__name__), n) for m in subs
                         if hasattr(m, n) and port(m.__name__))
    return out


@pytest.mark.parametrize("ref,mod", [(repro.core, repro_torch.core),
                                     (repro.models, repro_torch.models)],
                         ids=["core", "models"])
def test_package_exports_cover_reference(ref, mod):
    """Every public name of the reference package with a counterpart is
    exported under the same spelling, and every one has one."""
    names = _public(ref)
    assert names and all(names.values()), names
    missing = [n for n in names if not hasattr(mod, n)]
    assert not missing, missing
    assert set(mod.__all__) >= {n for n, o in vars(ref).items()
                                if not n.startswith("_")
                                and not isinstance(o, types.ModuleType)}


def test_prefill_and_decode_steps_match_reference():
    """Two prompts of ``PROMPT`` tokens through ``make_prefill_step``,
    then ``GEN`` greedy ``make_decode_step`` tokens: the same tokens as
    the reference's jitted steps, logits within ``par.ATOL``."""
    jcfg, tcfg, jparams, tparams = par.setup("smollm-135m")
    prompt = np.random.default_rng(3).integers(
        0, jcfg.vocab, (2, PROMPT)).astype(np.int32)
    jpre = jax.jit(jsteps.make_prefill_step(jcfg, max_len=32))
    jdec = jax.jit(jsteps.make_decode_step(jcfg))
    tpre = tsteps.make_prefill_step(tcfg, max_len=32)
    tdec = tsteps.make_decode_step(tcfg)
    jlog, jst = jpre(jparams, {"tokens": jnp.asarray(prompt)})
    with torch.no_grad():
        tlog, tst = tpre(tparams, {"tokens": torch.from_numpy(prompt)
                                   .long()})
        assert tlog.shape == jlog.shape == (2, 1, jcfg.vocab)
        jtok, ttok = jnp.argmax(jlog[:, -1], -1), torch.argmax(tlog[:, -1],
                                                               -1)
        for i in range(GEN):
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       atol=par.ATOL, rtol=0,
                                       err_msg=f"logits {i}")
            np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
            jlog, jst = jdec(jparams, jtok, jst)
            tlog, tst = tdec(tparams, ttok, tst)
            jtok, ttok = jnp.argmax(jlog, -1), torch.argmax(tlog, -1)
    np.testing.assert_array_equal(tst["pos"].numpy(), np.asarray(jst["pos"]))


def _fill(skeleton, flat: dict):
    """A port serve state in ``skeleton``'s structure (the unit/rem
    layout, as the reference's) with each leaf set from ``flat``, the
    reference's {keystr path: numpy}."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, f"{path}[{k!r}]") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{path}[{i}]") for i, v in enumerate(node)]
        if isinstance(node, tuple):
            return type(node)(*(walk(v, f"{path}.{n}") for n, v in
                                node._asdict().items()))
        return torch.from_numpy(np.array(flat[path])).to(node.dtype)
    return walk(skeleton, "")


def _assert_bitwise(tstate, jstate, what):
    got, exp = par.port_state_np(tstate), par.flat_np(jstate)
    assert got.keys() == exp.keys(), what
    for path, e in exp.items():
        assert got[path].shape == e.shape, (what, path)
        assert par.bits(got[path]) == par.bits(e), (what, path)


@pytest.mark.parametrize("arch,kind", [("smollm-135m", None),
                                       ("smollm-135m", "exact"),
                                       ("recurrentgemma-2b", None)],
                         ids=["prf", "exact", "unit-rem"])
def test_write_and_read_slot_match_reference(arch, kind):
    """A B = 1 serve state of the reference's layout, seeded values
    (``pos`` and the exact kind's ``length`` one dim short of the
    pool's), written into slot 1 of a
    3-slot pool by ``write_slot`` in both packages: the pools equal leaf
    by leaf, bitwise; ``read_slot`` of slots 1 and 2 as the reference's;
    a read slot written back into slot 0 round-trips."""
    jcfg, tcfg = (jcfgs.get_config(arch, reduced=True),
                  tcfgs.get_config(arch, reduced=True))
    if kind:
        jcfg, tcfg = jcfgs.darkify(jcfg, kind), tcfgs.darkify(tcfg, kind)
    rng = np.random.default_rng(4)
    jone = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating)
        else jnp.asarray(rng.integers(1, 16, x.shape), x.dtype),
        jlm.init_serve_state(jcfg, b=1, max_len=16))
    tone = _fill(tlm.init_serve_state(tcfg, b=1, max_len=16,
                                      stacked=False, device="cpu"),
                 par.flat_np(jone))
    _assert_bitwise(tone, jone, "the B = 1 state")
    jpool = jlm.init_serve_state(jcfg, b=3, max_len=16, per_slot=True)
    tpool = tlm.init_serve_state(tcfg, b=3, max_len=16, per_slot=True,
                                 stacked=False, device="cpu")
    jpool = jslots.write_slot(jpool, jone, jnp.int32(1))
    assert tslots.write_slot(tpool, tone, 1) is tpool
    _assert_bitwise(tpool, jpool, "the pool after write_slot")
    for idx in (1, 2):
        _assert_bitwise(tslots.read_slot(tpool, torch.tensor(idx)),
                        jslots.read_slot(jpool, jnp.int32(idx)),
                        f"read_slot({idx})")
    tslots.write_slot(tpool, tslots.read_slot(tpool, 1), 0)
    jpool = jslots.write_slot(jpool, jslots.read_slot(jpool, jnp.int32(1)),
                              jnp.int32(0))
    _assert_bitwise(tpool, jpool, "the pool after a round trip")
    _assert_bitwise(tslots.read_slot(tpool, 0), jslots.read_slot(
        jpool, jnp.int32(1)), "slot 0 against slot 1")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    return ex


def test_quickstart_example_runs_on_cpu():
    """``examples/torch_quickstart.py --device cpu --steps 3``: finite
    losses, 13 generated tokens a prompt, no kernel launched (the
    kernels' plain versions run on CPU tensors)."""
    out = _example("torch_quickstart").main(["--device", "cpu", "--steps",
                                             "3"])
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["generated"].shape == (2, 13)
    assert out["config"].use_kernel
    assert out["launches"] and not any(out["launches"].values())


def test_long_context_example_runs_on_cpu():
    """``examples/torch_long_context_serving.py --device cpu --contexts
    1024 2048 3072``: the PRF state's bytes equal at every context and
    to the reference's; the exact KV cache's equal to the reference's
    and linear in the context; no kernel launched."""
    ctxs = (1024, 2048, 3072)
    out = _example("torch_long_context_serving").main(
        ["--device", "cpu", "--contexts", *map(str, ctxs)])
    jcfg = jcfgs.get_config("smollm-135m", reduced=True)

    def ref_bytes(cfg, ctx):
        return sum(x.size * x.dtype.itemsize for x in jax.tree_util.
                   tree_leaves(jlm.init_serve_state(cfg, b=1, max_len=ctx)))
    rows = out["rows"]
    assert [r["context"] for r in rows] == list(ctxs)
    assert {r["prf_state_bytes"] for r in rows} == {ref_bytes(jcfg, 1024)}
    kv = [r["kv_cache_bytes"] for r in rows]
    assert kv == [ref_bytes(jcfgs.darkify(jcfg, "exact"), c) for c in ctxs]
    assert kv[2] - kv[1] == kv[1] - kv[0] > 0
    assert all(math.isfinite(r["prf_us_per_token"]) for r in rows)
    assert not any(out["launches"].values())
