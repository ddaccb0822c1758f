"""Tensor parallelism over ``model`` on gloo ranks (CPU): the sharded
train step and the mesh engine computing each rank's share, held against
the reference's unsharded functions (its multi-device tests need devices
this machine lacks).

Meshes (1, 2) at world 2 and (2, 2) at world 4 (``_torch_dist.
run_ranks``, workers in ``_torch_tp_ranks``), f32, from the reference's
drawn params (``bridge``):

  * the TP train step (remat "dots", B5's plain version) for reduced
    granite-8b (4 heads over 2 KV groups, untied head) and qwen3-moe-
    235b-a22b (experts over ``model``, qk-norm) against the reference's
    ``loss_fn`` gradients and one step of its ``make_train_step`` (its
    body: that gradient, then its AdamW update), and against the port's
    unsharded step; the same for the MoE fallback that splits each
    expert's hidden dim, with 3 experts and granite-moe-3b-a800m (its
    overrides). The ZeRO-3 tests hold
    smollm-135m, whose 3 KV groups keep attention whole at M = 2,
    against the reference on the same meshes. The loss within
    ``LOSS_TOL``, every gradient shard within ``REL_TOL`` of the leaf's
    largest magnitude, each rank's shard cut from the whole leaf in
    JAX's order (model-major); the updated params as
    :func:`_assert_step` says; B5 saw G/M groups, and nothing was
    gathered over ``model``;
  * with the ``model`` sum of qk-norm's gradient dropped, q_norm's
    gradient leaves the reference's (the planted fault);
  * the mesh engine (darkformer and exact for granite-8b, darkformer for
    qwen3-moe and smollm-135m): greedy streams equal to the port's engine
    without a mesh, its params and projections through a prefill chunk
    and three decode steps against the reference's ``prefill_chunk`` and
    ``decode_step`` logits within ``LOGIT_TOL``, B1 and B2 on G/M groups,
    resident bytes equal to ``dryrun.rank_bytes``;
  * ``serve --mesh-model 2`` (reduced granite-8b), drawing its params
    and loading a checkpoint: its engine built from placed params, each
    rank's ``dryrun.rank_bytes``, no whole copy of a split leaf alive,
    streams equal to the CLI's without a mesh;
  * the placement of a dim split over ("model", "data") on (1, 2),
    (2, 2) and (2, 4) (world 8): after the gather over ``data`` each
    rank holds the contiguous block m of M, for ``wk``/``wv`` its whole
    KV groups.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import MoEConfig as JMoEConfig
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim.schedules import constant as jconstant
from repro_torch import bridge
from repro_torch import configs
from repro_torch.checkpoint import save_checkpoint
from repro_torch.launch import serve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import to_device
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.schedules import constant
from repro_torch.tree import flatten

import _torch_arch_parity as par
import _torch_dist as td
import _torch_tp_ranks as tr

torch.set_num_threads(1)
SHAPES = [(1, 2), (2, 2)]
SHAPE_IDS = ["1x2", "2x2"]
LOSS_TOL = 1e-6          # relative, the reference's loss
REL_TOL = 1e-5           # of each leaf's largest |value|
LOGIT_TOL = 1e-5
TIMEOUT = 400
_RANKS: dict = {}
_REF: dict = {}
_CLI: dict = {}


def _jcfg(name):
    arch, _ = tr.TRAIN_RUNS[name]
    return dataclasses.replace(jcfgs.get_config(arch, reduced=True),
                               **tr.overrides(name, JMoEConfig))


def _ref_train(name):
    """The reference's params (numpy), the whole batch, its metrics and
    gradients on it, and its params after one train step."""
    if name not in _REF:
        jcfg = _jcfg(name)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        whole = td.step_batch(tr.train_cfg(name))
        jb = {k: jnp.asarray(v) for k, v in whole.items()}
        # the body of the reference's make_train_step at step 0: its
        # loss gradient (jitted), then its AdamW update
        rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
        (_, jm), jg = jax.jit(jax.value_and_grad(
            jlm.loss_fn, has_aux=True), static_argnums=1)(jp, jcfg, jb, rng)
        opt = JAdamWConfig(lr=tr.LR)
        jp1, _, om = jadamw_update(jp, jg, jadamw_init(jp, opt), opt,
                                   jconstant(tr.LR)(0))
        jm1 = {**jm, **om}
        _REF[name] = {
            "params_np": jax.tree_util.tree_map(np.asarray, jp),
            "whole": whole, "metrics": {k: float(v) for k, v in jm.items()},
            "grads": par.flat_np(jg), "params1": par.flat_np(jp1),
            "step_metrics": {k: float(v) for k, v in jm1.items()}}
    return _REF[name]


def _ref_engine(arch, kind):
    """The reference's params (numpy), the tokens, and its logits of one
    prefill chunk and ``DECODES`` decode steps."""
    key = ("engine", arch, kind)
    if key not in _REF:
        jcfg = jcfgs.get_config(arch, reduced=True)
        jcfg = jcfgs.darkify(jcfg, kind, jcfg.attn.num_features)
        jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        toks = np.random.default_rng(5).integers(
            0, jcfg.vocab, (tr.ROWS, tr.PROMPT + tr.DECODES)).astype(np.int32)
        st = jlm.init_serve_state(jcfg, b=tr.ROWS, max_len=64, per_slot=True,
                                  stacked=True)
        lg, st = jlm.prefill_chunk(jp, jcfg,
                                   {"tokens": jnp.asarray(toks[:, :tr.PROMPT])},
                                   st)
        logits = [np.asarray(lg)]
        for i in range(tr.DECODES):
            lg, st = jlm.decode_step(jp, jcfg,
                                     jnp.asarray(toks[:, tr.PROMPT + i]), st)
            logits.append(np.asarray(lg))
        _REF[key] = {"params_np": jax.tree_util.tree_map(np.asarray, jp),
                     "toks": toks, "logits": logits}
    return _REF[key]


def _ranks(shape, tmp_path):
    if shape not in _RANKS:
        train_np = {n: _ref_train(n)["params_np"] for n in tr.TRAIN_RUNS}
        whole = {n: _ref_train(n)["whole"] for n in tr.TRAIN_RUNS}
        engine_np = {(a, k): (_ref_engine(a, k)["params_np"],
                              _ref_engine(a, k)["toks"])
                     for a, k in tr.ENGINE_RUNS}
        _RANKS[shape] = td.run_ranks(tr.w_tp, math.prod(shape), tmp_path,
                                     shape, train_np, engine_np, whole,
                                     timeout=TIMEOUT)
    return _RANKS[shape]


def _shard_of(full, dims, coord, sizes):
    """The piece of ``full`` a rank at ``coord`` holds when tensor dim i
    is split over ``dims[i]`` (its axes, major first, as JAX splits)."""
    for i, axes in enumerate(dims):
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        size = full.shape[i] // n
        full = full.take(np.arange(idx * size, (idx + 1) * size), axis=i)
    return full


def _assert_shards(got: dict, exp: dict, res, shape, what):
    sizes = dict(zip(("data", "model"), shape))
    assert got.keys() == exp.keys()
    for path, e in exp.items():
        want = _shard_of(e, res["dims"][path], res["coord"], sizes)
        g = got[path].detach().numpy()
        assert g.shape == want.shape, (what, path)
        gap = float(np.abs(g - want).max()) if g.size else 0.0
        assert gap <= REL_TOL * max(float(np.abs(e).max()), 1e-30), (
            what, path, gap, float(np.abs(e).max()))


TRAIN_IDS = list(tr.TRAIN_RUNS)


@pytest.mark.parametrize("name", TRAIN_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tp_grads_match_reference(shape, name, tmp_path):
    ref = _ref_train(name)
    for res in (r[name] for r in _ranks(shape, tmp_path)):
        for k in ("loss", "ce", "z_loss", "aux"):
            assert abs(res["metrics"][k] - ref["metrics"][k]) <= \
                LOSS_TOL * max(abs(ref["metrics"][k]), 1.0), k
        assert res["metrics"]["accuracy"] == pytest.approx(
            ref["metrics"]["accuracy"], abs=1e-6)
        _assert_shards(res["grads"], ref["grads"], res, shape, "grads")


def _plain_step(name):
    """The port's unsharded step from the reference's params: the params
    after it, by path."""
    key = ("plain-step", name)
    if key not in _REF:
        ref = _ref_train(name)
        cfg = tr.train_cfg(name)
        p = bridge.params_from_jax(ref["params_np"], cfg, device="cpu")
        opt = AdamWConfig(lr=tr.LR)
        p1, _, _ = tsteps.make_train_step(cfg, opt, constant(tr.LR))(
            p, adamw_init(p, opt), to_device(ref["whole"], "cpu"), 0)
        _REF[key] = {k: t.numpy() for k, t in flatten(p1)}
    return _REF[key]


# AdamW's first step moves an element by lr * g / (|g| + eps): where |g|
# is near the gradients' rounding, a gradient gap that the gradient check
# allows (REL_TOL of the leaf's largest |g|) swings the step by up to lr.
# Elements whose reference gradient is at least STEP_FLOOR of the leaf's
# largest are held within REL_TOL of the leaf's largest |value|, the
# others within the step's own bound, lr (1 + weight_decay |p|).
STEP_FLOOR = 1e-3


def _assert_step(res, exp, grads, shape, what):
    sizes = dict(zip(("data", "model"), shape))
    assert res["params"].keys() == exp.keys()
    for path, e in exp.items():
        cut = [_shard_of(x, res["dims"][path], res["coord"], sizes)
               for x in (e, grads[path])]
        gap = np.abs(res["params"][path].numpy() - cut[0])
        steady = np.abs(cut[1]) >= STEP_FLOOR * np.abs(grads[path]).max()
        assert (gap[steady] <= REL_TOL * np.abs(e).max()).all(), (
            what, path, float(gap[steady].max()), float(np.abs(e).max()))
        assert (gap <= tr.LR * (1 + 0.01 * np.abs(e).max())).all(), (
            what, path, float(gap.max()))


@pytest.mark.parametrize("name", TRAIN_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tp_step_matches_reference(shape, name, tmp_path):
    """One train step: every param shard against the reference's step and
    the port's unsharded one (:func:`_assert_step`), the loss and the
    global gradient norm within ``REL_TOL`` of the reference's."""
    ref = _ref_train(name)
    for res in (r[name] for r in _ranks(shape, tmp_path)):
        _assert_step(res, _plain_step(name), ref["grads"], shape,
                     "vs the unsharded step")
        _assert_step(res, ref["params1"], ref["grads"], shape,
                     "vs the reference")
        for k in ("loss", "grad_norm"):
            assert abs(res["step_metrics"][k] - ref["step_metrics"][k]) <= \
                REL_TOL * abs(ref["step_metrics"][k]), k


@pytest.mark.parametrize("name", TRAIN_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_tp_step_computes_shares(shape, name, tmp_path):
    """B5 ran on G/M KV groups, and the step gathered nothing over
    ``model``."""
    cfg = tr.train_cfg(name)
    m = shape[1]
    tp = cfg.n_kv % m == 0
    for res in (r[name] for r in _ranks(shape, tmp_path)):
        assert res["b5_groups"] == [cfg.n_kv // m if tp else cfg.n_kv]
        if tp:
            assert res["gauge"]["over_model"] == 0, res["gauge"]
        else:
            assert res["gauge"]["over_model"] > 0, res["gauge"]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_dropped_model_sum_of_q_norm_fails(shape, tmp_path):
    """qk-norm's scales are used by each rank on its own heads: without
    the sum over ``model`` their gradient is one rank's part, and leaves
    the reference's; with it, it matches (the test above)."""
    ref = _ref_train("qwen3-moe")
    for res in (r["qwen3-moe"] for r in _ranks(shape, tmp_path)):
        faulty = res["q_norm_fault"]
        assert faulty
        with pytest.raises(AssertionError):
            _assert_shards(faulty, {k: ref["grads"][k] for k in faulty},
                           res, shape, "q_norm fault")


ENGINE_IDS = [f"{a}-{k}" for a, k in tr.ENGINE_RUNS]


def _plain_streams(arch, kind):
    key = ("plain", arch, kind)
    if key not in _REF:
        cfg = tr.engine_cfg(arch, kind)
        params = bridge.params_from_jax(_ref_engine(arch, kind)["params_np"],
                                        cfg, device="cpu")
        _REF[key] = td.serve_streams(params, cfg)
    return _REF[key]


@pytest.mark.parametrize("run", tr.ENGINE_RUNS, ids=ENGINE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_engine_matches_plain_and_reference(shape, run, tmp_path):
    arch, kind = run
    ref = _ref_engine(arch, kind)
    want = _plain_streams(arch, kind)
    for res in (r[run] for r in _ranks(shape, tmp_path)):
        assert res["streams"] == want
        for i, (got, exp) in enumerate(zip(res["logits"], ref["logits"])):
            np.testing.assert_allclose(got.numpy(), exp, atol=LOGIT_TOL,
                                       rtol=0, err_msg=f"step {i}")


@pytest.mark.parametrize("run", tr.ENGINE_RUNS, ids=ENGINE_IDS)
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_engine_computes_shares(shape, run, tmp_path):
    """B1 and B2 (darkformer) launch on G/M groups, nothing split over
    ``model`` is gathered over it (smollm-135m's 3 groups excepted), and
    the params and the slot pool each rank holds are the bytes
    ``dryrun.rank_bytes`` gives them."""
    arch, kind = run
    cfg = tr.engine_cfg(arch, kind)
    m = shape[1]
    tp = cfg.n_kv % m == 0
    g = cfg.n_kv // m if tp else cfg.n_kv
    for res in (r[run] for r in _ranks(shape, tmp_path)):
        if kind == "darkformer":
            assert res["b1_groups"] == [g] and res["b2_groups"] == [g]
            assert res["paths"] == ("fused_plain", "fused_plain")
        else:
            assert res["b1_groups"] == res["b2_groups"] == []
        assert (res["gauge"]["over_model"] == 0) == tp, res["gauge"]
        assert res["held"] == res["rank_bytes"]


CLI_ARGV = ["--arch", "granite-8b", "--reduced", "--device", "cpu",
            "--requests", "4", "--slots", "2", "--prompt-len", "4-12",
            "--gen", "3-6", "--chunk-tokens", "8", "--max-len", "64"]


def _cli_runs(tmp_path):
    """The serve CLI drawing its params and loading a checkpoint, on two
    gloo ranks under ``--mesh-model 2`` (``_torch_tp_ranks.
    _watched_serve``) and in this process without a mesh."""
    if "ranks" not in _CLI:
        ck = tmp_path / "ck"
        cfg = configs.get_config("granite-8b", reduced=True)
        save_checkpoint(str(ck), 3, {"params": tlm.init_params(
            cfg, seed=7, device="cpu")})
        runs = {"draw": CLI_ARGV, "load": CLI_ARGV + ["--load", str(ck)]}
        _CLI["ranks"] = td.run_ranks(
            tr.w_serve_cli_placed, 2, tmp_path,
            {k: v + ["--mesh-model", "2"] for k, v in runs.items()})
        _CLI["plain"] = {k: serve.main(v) for k, v in runs.items()}
    return _CLI


@pytest.mark.parametrize("run", ["draw", "load"])
def test_serve_cli_mesh_model_serves_from_placed_params(run, tmp_path,
                                                        capsys):
    """``serve --mesh-model 2`` builds its engine from placed params, the
    bytes ``dryrun.rank_bytes`` gives a rank, with no whole copy of a
    split leaf alive beside them: drawn on the host and dropped once
    placed, or (``--load``) restored onto the placements with nothing
    drawn. Its streams are the CLI's without a mesh."""
    res = _cli_runs(tmp_path)
    st = res["plain"][run]
    want = [r.tokens for r in sorted(st["results"], key=lambda r: r.uid)]
    for got in (r[run] for r in res["ranks"]):
        assert got["tokens"] == want
        assert got["paths"] == (st["prefill_path"], st["decode_path"])
        assert got["placed"] and got["held"] == got["rank_bytes"], got
        assert got["alive_split"] == 0, got
        assert (got["drawn_split"] > 0) == (run == "draw"), got


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)],
                         ids=["1x2", "2x2", "2x4"])
def test_model_major_placement(shape, tmp_path):
    """Every rule that splits a dim over ("model", "data"): rank (d, m)'s
    block after the gather over ``data`` is the contiguous block m of M,
    DTensor's ``full_tensor`` and the port's gather both give the leaf
    back, and the dims read model-major; reduced granite-8b with one KV
    group a model rank: ``wk``/``wv``'s block is that whole group."""
    rules = tr.tuple_rules()
    assert len(rules) >= 10
    ranks = ([r["placement"] for r in _ranks(shape, tmp_path)]
             if shape in SHAPES else
             td.run_ranks(tr.w_placement, math.prod(shape), tmp_path, shape))
    for res in ranks:
        for pat, _ in rules:
            got = res[pat]
            assert got["dims"] == ("model", "data"), pat
            assert got["block"] and got["full_tensor"] and \
                got["gathered"], (pat, got, res["coord"])
        for leaf in ("wk", "wv"):
            assert res[leaf]["dims"] == ("model", "data")
            assert res[leaf]["groups"], (leaf, res["coord"])


def test_no_mesh_no_model_axis():
    """Outside ``over_model`` (and on a one-rank ``model`` axis) there is
    no model axis: every block computes whole, as without a mesh."""
    from repro_torch.parallel import tensor_parallel as tpl
    assert tpl.model_axis() is None
    cfg = tr.train_cfg("granite-8b")
    assert tlm.attn_split(cfg) is None and tlm.vocab_split(cfg) is None

    class OneRank:
        mesh_dim_names = ("data", "model")

        def size(self, k):
            return (2, 1)[k]
    with tpl.over_model(OneRank()) as ax:
        assert ax is None and tpl.model_axis() is None
