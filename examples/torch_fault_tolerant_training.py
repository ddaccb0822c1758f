"""Fault-tolerant training in the PyTorch port, the counterpart of
examples/fault_tolerant_training.py: checkpoint/restart with an injected
failure, straggler monitoring and an elastic-shrink plan. The model, the
steps and the failure are the JAX example's; the run with the failure
ends on the state of an uninterrupted one, which the example checks.

Runs on the GPU through the hand-written kernels by default; ``--device
cpu`` runs the plain path on the CPU:

    PYTHONPATH=src python examples/torch_fault_tolerant_training.py
    PYTHONPATH=src python examples/torch_fault_tolerant_training.py \
        --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.feature_maps import FeatureConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.lm import ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402
from repro_torch.runtime import (StragglerMonitor,  # noqa: E402
                                 TrainSupervisor, elastic_shrink_plan)
from repro_torch.tree import flatten  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--fail-at", type=int, default=25)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    cfg = ModelConfig(name="ft-demo", n_layers=2, d_model=48, n_heads=4,
                      n_kv=2, d_ff=96, vocab=128, remat="none",
                      attn=FeatureConfig(kind="darkformer", num_features=16),
                      use_kernel=True)
    opt_cfg = AdamWConfig(lr=1e-3)
    params = lm.init_params(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab, 32, 4)
    step = make_train_step(cfg, opt_cfg, constant(1e-3))

    def step_fn(state, i):
        batch = {k: torch.from_numpy(v).to(dev).long()
                 for k, v in data.batch(i).items()}
        p, o, m = step(state["params"], state["opt"], batch, i)
        if i % 10 == 0:
            print(f"  step {i:3d} loss {float(m['loss']):.4f}")
        return {"params": p, "opt": o}

    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    runs = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        sup = TrainSupervisor(str(Path(ckpt_dir) / "faulty"), ckpt_every=10,
                              monitor=StragglerMonitor(threshold=3.0))
        print(f"training {args.steps} steps with a simulated node failure "
              f"at step {args.fail_at}:")
        runs["faulty"] = sup.run(state, step_fn, args.steps,
                                 fail_at=args.fail_at)
        print("recovered and completed; stragglers flagged:",
              sup.monitor.straggler_steps)
        print("the same steps uninterrupted:")
        runs["clean"] = TrainSupervisor(str(Path(ckpt_dir) / "clean"),
                                        ckpt_every=10).run(
            state, step_fn, args.steps)
    equal = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten(runs["faulty"]), flatten(runs["clean"])))
    print("final state equal to the uninterrupted run's:", equal)
    if not equal:
        raise SystemExit("the recovered run differs from the clean one")
    plan = elastic_shrink_plan((16, 16), ("data", "model"), 3)
    print("elastic plan after losing 3 hosts from a (16,16) mesh:", plan)
    return {"final": runs["faulty"], "stragglers":
            sup.monitor.straggler_steps, "plan": plan}


if __name__ == "__main__":
    main()
