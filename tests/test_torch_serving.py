"""The port's serving engine and launcher on the CPU.

Greedy streams equal the reference ``ServingEngine(overlap=False,
mesh=None)`` under the same requests, params, ``chunk_tokens`` and
admission schedule (greedy tokens are compared only within one chunk
schedule: across schedules the stabilizer trajectories differ in f32
rounding). Inside the port: ``submit`` validation, ``cancel``, and
sampled streams that do not depend on the batch around a request.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfgs
from repro.models import lm as jlm
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JEngine
from repro_torch import bridge
from repro_torch import configs as tcfgs
from repro_torch.launch import serve
from repro_torch.models import lm as tlm
from repro_torch.serving import Request, ServingEngine

torch.set_num_threads(1)
LENGTHS, GENS = (5, 13, 9, 7), (6, 3, 8, 4)


def _prompts(vocab, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, l).tolist() for l in LENGTHS]


@pytest.mark.parametrize("use_kernel", [False, True])
def test_greedy_streams_match_reference_engine(use_kernel):
    jcfg = dataclasses.replace(jcfgs.get_config("smollm-135m", reduced=True),
                               use_kernel=use_kernel)
    tcfg = tcfgs.get_config("smollm-135m", reduced=True,
                            use_kernel=use_kernel)
    jparams = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = bridge.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), tcfg, device="cpu")
    prompts = _prompts(jcfg.vocab)
    streams = []
    for eng, req in (
            (JEngine(jparams, jcfg, max_slots=2, max_len=48, chunk_tokens=8,
                     overlap=False), JRequest),
            (ServingEngine(tparams, tcfg, max_slots=2, max_len=48,
                           chunk_tokens=8, device="cpu"), Request)):
        uids = [eng.submit(req(prompt=p, max_new_tokens=n))
                for p, n in zip(prompts, GENS)]
        got = {r.uid: r.tokens for r in eng.run()}
        streams.append([got[u] for u in uids])
        st = eng.stats
        assert st["admitted"] == st["finished"] == len(prompts)
    assert streams[0] == streams[1]
    assert st["decode_path"] == ("fused_plain" if use_kernel else "torch")


@pytest.fixture(scope="module")
def small_engine_parts():
    cfg = tcfgs.get_config("smollm-135m", reduced=True, use_kernel=True)
    return cfg, tlm.init_params(cfg, seed=0, device="cpu")


def _engine(parts, **kw):
    cfg, params = parts
    kw = {"max_slots": 3, "max_len": 48, "device": "cpu", **kw}
    return ServingEngine(params, cfg, **kw)


@pytest.mark.parametrize("bad", [
    dict(prompt=[]), dict(prompt=list(range(48))), dict(prompt=[256]),
    dict(prompt=[-1]), dict(max_new_tokens=0), dict(temperature=-0.5),
    dict(top_k=-1), dict(top_p=0.0)])
def test_submit_rejects_bad_requests(small_engine_parts, bad):
    eng = _engine(small_engine_parts)
    with pytest.raises(ValueError):
        eng.submit(Request(**{"prompt": [1, 2, 3], **bad}))
    assert not eng.has_work


def test_cancel_queued_prefilling_and_decoding(small_engine_parts):
    eng = _engine(small_engine_parts, max_slots=2, chunk_tokens=4)
    a = eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=20))
    b = eng.submit(Request(prompt=list(range(1, 30)), max_new_tokens=5))
    c = eng.submit(Request(prompt=[4, 5], max_new_tokens=5))
    eng.step()
    eng.step()
    assert eng.num_active == 1 and eng.num_prefilling == 1
    queued = eng.cancel(c)
    assert queued.cancelled and queued.tokens == []
    mid_prefill = eng.cancel(b)
    assert mid_prefill.cancelled and mid_prefill.tokens == []
    decoding = eng.cancel(a)
    assert decoding.cancelled and len(decoding.tokens) == 2
    assert eng.cancel(12345) is None
    assert not eng.has_work and eng.num_active == 0


def test_sampled_stream_does_not_depend_on_the_batch(small_engine_parts):
    """A sampled request decodes the same tokens alone and inside a busy
    batch: its draws depend only on (seed, uid, token index)."""
    prompt = list(range(3, 14))
    kw = dict(max_new_tokens=12, temperature=0.9, top_k=40, top_p=0.95)
    alone = _engine(small_engine_parts, seed=5)
    uid = alone.submit(Request(prompt=prompt, uid=777, **kw))
    ref = {r.uid: r.tokens for r in alone.run()}[uid]

    busy = _engine(small_engine_parts, seed=5, chunk_tokens=8)
    rng = np.random.default_rng(0)
    for i in range(4):
        busy.submit(Request(prompt=rng.integers(0, 256, 6 + 3 * i).tolist(),
                            max_new_tokens=4 + i, temperature=0.7,
                            arrival_time=0.0))
    busy.submit(Request(prompt=prompt, uid=777, **kw))
    got = {r.uid: r.tokens for r in busy.run()}[777]
    assert got == ref
    assert len(set(ref)) > 1          # really sampled, not a greedy loop


@pytest.mark.parametrize("use_kernel", ["--use-kernel", "--no-use-kernel"])
def test_launcher_runs_in_process(use_kernel, capsys):
    st = serve.main(["--arch", "smollm-135m", "--reduced", "--device",
                     "cpu", use_kernel, "--requests", "3", "--slots", "2",
                     "--max-len", "48", "--prompt-len", "4-12",
                     "--gen", "3-5", "--chunk-tokens", "8"])
    assert st["finished"] == 3 and len(st["results"]) == 3
    assert st["prefill_path"] == ("fused_plain" if use_kernel ==
                                  "--use-kernel" else "torch")
    assert "throughput:" in capsys.readouterr().out
