"""The serving half of distribution on gloo ranks (CPU): the engine's
pools placed on a mesh, prefix snapshots promoted onto it, ``serve
--mesh-data``, and MoE's ``dispatch_spec``, each against the port's own
unsharded path (the reference's multi-device serving tests need
devices this machine lacks).

Meshes (2, 1) at world 2 and (2, 2) at world 4
(``_torch_dist.run_ranks``): reduced smollm-135m, darkformer and exact,
through both schedulers, and reduced granite-moe-3b-a800m with its
``dispatch_spec`` on the mesh's axes; every rank's greedy streams
bitwise those of the engine without a mesh (granite-moe's without the
spec), and after the run every leaf of both pools a DTensor with the
placements and local shape ``serve_state_specs`` gives it. The snapshot
round trip (the reference's ``test_mesh_sharded_snapshot_roundtrip``):
a primed cache-on engine whose entries are demoted to the host tier
before the sharers run, at least 5 forks, streams equal to an
unsharded cache-less engine's, the promoted snapshots on the pools'
placements (paged KV's page pools replicated). Timed arrivals on a
clock that each rank runs faster than the first rank's: streams bitwise
those of the engine without a mesh on the first rank's clock.
``serve --mesh-data 2`` on two ranks against the CLI without a mesh, in
a burst and at ``--rate``. ``_pin`` on DTensor buffers, and
``moe_apply`` with the spec set bitwise without it.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.launch import serve
from repro_torch.models import layers as tll
from repro_torch.models import lm as tlm

import _torch_dist as td

torch.set_num_threads(1)
SHAPES = [(2, 1), (2, 2)]
SHAPE_IDS = ["2x1", "2x2"]
_RUNS: dict = {}
_PLAIN: dict = {}


def _mesh_runs(shape, tmp_path):
    if shape not in _RUNS:
        _RUNS[shape] = td.run_ranks(td.w_serve_mesh, shape[0] * shape[1],
                                    tmp_path, shape)
    return _RUNS[shape]


def _model(arch, kind):
    cfg = td.serve_cfg(arch, kind)
    return cfg, tlm.init_params(cfg, seed=0, device="cpu")


def _plain(arch, kind, overlap):
    """The engine without a mesh (MoE without ``dispatch_spec``)."""
    if (arch, kind, overlap) not in _PLAIN:
        cfg, params = _model(arch, kind)
        _PLAIN[(arch, kind, overlap)] = td.serve_streams(params, cfg,
                                                         overlap=overlap)
    return _PLAIN[(arch, kind, overlap)]


def _run_id(run):
    arch, kind, overlap = run
    return f"{arch}-{kind or 'own'}-{'ovl' if overlap else 'seq'}"


@pytest.mark.parametrize("run", td.SERVE_RUNS,
                         ids=[_run_id(r) for r in td.SERVE_RUNS])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_engine_on_mesh_matches_unsharded(shape, run, tmp_path):
    want = _plain(*run)
    for rank, res in enumerate(_mesh_runs(shape, tmp_path)):
        got = res[run]
        assert got["streams"] == want, rank
        bad = [p for p, ok, local in got["placements"]
               if not (ok and local)]
        assert got["placements"] and not bad, (rank, bad)


@pytest.mark.parametrize("kind", ["darkformer", "exact"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_snapshot_roundtrip(shape, kind, tmp_path):
    cfg, params = _model("smollm-135m", kind)
    prefix = np.random.default_rng(42).integers(0, cfg.vocab, 16).tolist()
    cold = td.serve_streams(params, cfg, slots=4,
                            reqs=td.serve_requests(cfg.vocab, 6, 7, prefix))
    for rank, res in enumerate(_mesh_runs(shape, tmp_path)):
        got = res[("snapshot", kind)]
        assert got["stats"]["forked_requests"] >= 5, rank
        assert got["stats"]["prefix_promotions"] >= 1, rank
        assert got["streams"] == cold, rank
        assert got["promoted"] and all(
            ok and local for rep in got["promoted"] for _, ok, local in rep)
        assert got["pages_replicated"]


@pytest.mark.parametrize("overlap", [False, True], ids=["seq", "ovl"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_mesh_admits_by_one_clock(shape, overlap, tmp_path):
    """Requests arrive 0.3 s apart, and rank r runs the engine's clock
    1 + 0.5 r times as fast as rank 0 (``_torch_dist.reading_clock``):
    had each rank admitted by its own clock, the gathered pools would
    join two schedules. Every rank's streams are bitwise those of the engine
    without a mesh on rank 0's clock, in the same number of steps."""
    from repro_torch.serving import ServingEngine

    cfg, params = _model("smollm-135m", "darkformer")
    eng = td.reading_clock(ServingEngine(
        params, cfg, max_slots=3, max_len=64, chunk_tokens=8, seed=0,
        overlap=overlap, device="cpu"))
    want = td.serve_streams(params, cfg, engine=eng, reqs=td.serve_requests(
        cfg.vocab, gap=td.ARRIVAL_GAP))
    assert want == _plain("smollm-135m", "darkformer", overlap)
    for rank, res in enumerate(_mesh_runs(shape, tmp_path)):
        got = res[("timed", overlap)]
        assert got["streams"] == want, rank
        assert got["steps"] == eng.stats["decode_steps"], rank


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_moe_pin_places_dtensor_buffers(shape, tmp_path):
    """The (B, E, C, d) buffers get batch on 'data' and experts on
    'model'; the gather's expert dim is left replicated; values kept."""
    from torch.distributed.tensor import Replicate, Shard
    want = [[str(Shard(0)), str(Shard(1))], [str(Shard(0)), str(Replicate())]]
    for res in _mesh_runs(shape, tmp_path):
        pin = res["pin"]
        assert pin["placements"] == want
        assert pin["equal"] and pin["plain_is_identity"]


def test_moe_dispatch_spec_is_bitwise_plain():
    """``moe_apply`` with ``dispatch_spec`` set: output, aux loss and
    every gradient bitwise those without it, on plain tensors."""
    cfg, params = _model("granite-moe-3b-a800m", None)
    moe = cfg.moe
    pinned = dataclasses.replace(moe, dispatch_spec=(("data",), "model"))
    p = params["units"]["b0"]["ffn"]
    p = {k: v[0].detach() for k, v in p.items()}
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 16, cfg.d_model)).astype(np.float32))
    outs = []
    for c in (moe, pinned):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xi = x.clone().requires_grad_(True)
        out, aux = tll.moe_apply(leaves, xi, c)
        g = torch.autograd.grad((out.square().sum() + aux),
                                [xi, *leaves.values()])
        outs.append((out, aux, *g))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _serve_cli_mesh_data_2(tmp_path, extra=()):
    argv = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--requests", "4", "--slots", "2", "--prompt-len", "4-12",
            "--gen", "3-6", "--chunk-tokens", "8", "--max-len", "64",
            *extra]
    ranks = td.run_ranks(td.w_serve_cli, 2, tmp_path,
                         argv + ["--mesh-data", "2"])
    st = serve.main(argv)
    want = [r.tokens for r in sorted(st["results"], key=lambda r: r.uid)]
    for res in ranks:
        assert res["tokens"] == want
        assert res["paths"] == (st["prefill_path"], st["decode_path"])


def test_serve_cli_mesh_data_2(tmp_path, capsys):
    _serve_cli_mesh_data_2(tmp_path)


def test_serve_cli_mesh_data_2_at_rate(tmp_path, capsys):
    """Timed arrivals: both ranks admit by rank 0's clock, so neither
    splits the schedule (greedy streams do not depend on it)."""
    _serve_cli_mesh_data_2(tmp_path, ["--rate", "40"])
