"""The port's training launcher, in process, and its checkpoints against
the reference's.

``repro_torch.launch.train.main`` runs the reduced smollm-135m on the CPU
(no subprocess): its loss falls, a qkv-only finetune from its own
checkpoint trains only q/k/v and M, and checkpoints cross between the
packages in both directions, bitwise, through the same msgpack layout.
"""
import dataclasses
import os

import jax
import msgpack
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro import configs as jcfgs
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro_torch import bridge
from repro_torch import checkpoint as tckpt
from repro_torch import configs as tcfgs
from repro_torch.checkpoint import msgpack_subset
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.tree import flatten

torch.set_num_threads(1)
COMMON = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
          "--batch", "4", "--seq", "64", "--lr", "3e-3", "--warmup", "2"]


def test_train_launcher_loss_falls(tmp_path):
    mfile = tmp_path / "metrics.json"
    out = train.main(COMMON + ["--steps", "20", "--log-every", "5",
                               "--metrics-out", str(mfile)])
    metrics = out["metrics"]
    assert [m["step"] for m in metrics] == [0, 5, 10, 15, 19]
    assert all(np.isfinite(m["loss"]) for m in metrics)
    assert metrics[-1]["loss"] < metrics[0]["loss"] - 0.1, metrics
    assert mfile.exists()


def test_finetune_qkv_only_keeps_frozen_leaves(tmp_path):
    ck = tmp_path / "pretrain"
    train.main(COMMON + ["--steps", "6", "--ckpt-dir", str(ck),
                         "--ckpt-every", "4", "--log-every", "5"])
    assert tckpt.all_steps(str(ck)) == [3, 5]
    cfg = tcfgs.get_config("smollm-135m", reduced=True)
    pre, step = tckpt.restore_checkpoint(
        str(ck), {"params": tlm.init_params(cfg, seed=1, device="cpu")})
    assert step == 5
    out = train.main(COMMON + ["--steps", "3", "--finetune-from", str(ck),
                               "--qkv-only", "--log-every", "1"])
    # a frozen leaf's gradient is zeroed, so (f32 here) only the decoupled
    # weight decay moves it: by a factor 1 - lr·wd a step
    decay = float(np.prod([1 - m["lr"] * AdamWConfig().weight_decay
                           for m in out["metrics"]]))
    assert decay < 1
    for (path, a), (_, b) in zip(flatten(pre["params"]),
                                 flatten(out["params"])):
        if tsteps.qkv_only_freeze(path):
            np.testing.assert_allclose(b.numpy(), a.numpy() * decay,
                                       err_msg=path, atol=0, rtol=1e-6)
        else:
            assert not torch.allclose(b, a * decay, atol=0, rtol=1e-6), path


def _port_state(dtype):
    cfg = tcfgs.get_config("smollm-135m", reduced=True, dtype=dtype)
    params = tlm.init_params(cfg, seed=3, device="cpu")
    return {"params": params, "opt": adamw_init(params, AdamWConfig())}


def _jax_state(dtype, seed):
    cfg = dataclasses.replace(jcfgs.get_config("smollm-135m", reduced=True),
                              dtype=dtype)
    params = jlm.init_params(jax.random.PRNGKey(seed), cfg)
    return {"params": params, "opt": jadamw_init(params, JAdamWConfig())}


def _bits(a) -> bytes:
    a = np.asarray(a)
    return a.view(np.uint8).tobytes() if a.ndim else a.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_packages(tmp_path, dtype):
    """Port -> reference and reference -> port, every leaf bitwise,
    including bf16 params and the int32 step count."""
    port = _port_state(dtype)
    port["opt"]["count"] += 7
    tckpt.save_checkpoint(str(tmp_path / "port"), 7, port)
    got, step = jckpt.restore_checkpoint(str(tmp_path / "port"),
                                         _jax_state(dtype, 0))
    assert step == 7
    exp = {p: bridge.params_to_numpy({"x": t})["x"] for p, t in
           flatten(port)}
    flat = {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_flatten_with_path(got)[0]}
    assert flat.keys() == exp.keys()
    for k, e in exp.items():
        assert np.asarray(flat[k]).dtype == e.dtype, k
        assert _bits(flat[k]) == _bits(e), k

    ref = _jax_state(dtype, 5)
    jckpt.save_checkpoint(str(tmp_path / "ref"), 2, ref)
    got, step = tckpt.restore_checkpoint(str(tmp_path / "ref"),
                                         _port_state(dtype))
    assert step == 2
    for (k, t), (jp, e) in zip(flatten(got),
                               jax.tree_util.tree_flatten_with_path(ref)[0]):
        assert k == jax.tree_util.keystr(jp)
        assert _bits(bridge.params_to_numpy({"x": t})["x"]) == _bits(e), k


def test_checkpoint_bytes_are_msgpacks(tmp_path):
    """The port's encoder writes the bytes ``msgpack.packb(...,
    use_bin_type=True)`` writes, for a checkpoint and for every length
    class of the subset; its decoder reads them back."""
    tckpt.save_checkpoint(str(tmp_path), 0, _port_state("bfloat16"))
    raw = (tmp_path / "step_0" / "state.msgpack").read_bytes()
    payload = msgpack.unpackb(raw, raw=False)
    assert msgpack.packb(payload, use_bin_type=True) == raw
    assert msgpack_subset.unpackb(raw) == payload
    sizes = [0, 15, 16, 31, 32, 255, 256, 65535, 65536]
    obj = {"s" * n: [b"b" * n, n, -n - 1, list(range(n % 20))]
           for n in sizes}
    obj["ints"] = [-(2 ** 63), -(2 ** 31) - 1, -129, -33, 127, 128, 2 ** 40]
    assert msgpack_subset.packb(obj) == msgpack.packb(obj,
                                                      use_bin_type=True)
    assert msgpack_subset.unpackb(msgpack_subset.packb(obj)) == obj
    assert os.listdir(tmp_path) == ["step_0"]
