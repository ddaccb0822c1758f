"""Quickstart in the PyTorch port, the counterpart of
examples/quickstart.py: build a DARKFormer model, train it, serve from
it. The model, the steps, the data and the prompt are the JAX example's;
the attention runs through the hand-written kernels (``use_kernel``).

Runs on the GPU by default; ``--device cpu`` runs the kernels' plain
versions on the CPU:

    PYTHONPATH=src python examples/torch_quickstart.py
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu \
        --steps 3

Prints the launches of each of the seven kernels the run made.
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import FeatureConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.launch.train import to_device  # noqa: E402
from repro_torch.models import ModelConfig, init_params  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.schedules import cosine_warmup  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    kernels.reset_launch_counts()

    # 1. A small model with the paper's data-aware PRF attention.
    cfg = ModelConfig(
        name="quickstart", n_layers=4, d_model=64, n_heads=4, n_kv=2,
        d_ff=128, vocab=256, remat="none",
        attn=FeatureConfig(kind="darkformer", num_features=32),
        use_kernel=True)
    params = init_params(cfg, seed=0, device=dev)
    n = sum(x.numel() for _, x in flatten(params))
    print(f"model: {n/1e6:.2f}M params, attention kernel = {cfg.attn.kind}")

    # 2. Train for a few steps on the deterministic synthetic corpus.
    opt_cfg = AdamWConfig(lr=3e-3)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(cfg, opt_cfg, cosine_warmup(3e-3, 10, 60))
    data = SyntheticLM(cfg.vocab, seq_len=64, batch_size=8)
    losses = []
    for i in range(args.steps):
        params, opt, metrics = step(params, opt,
                                    to_device(data.batch(i), dev), i)
        losses.append(float(metrics["loss"]))
        if i % 20 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"acc {float(metrics['accuracy']):.3f}")

    # 3. Serve: prefill a prompt, then O(1)-state greedy decode.
    prompt = to_device(data.batch(999), dev)["tokens"][:2, :16]
    prefill = make_prefill_step(cfg, max_len=64)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        logits, state = prefill(params, {"tokens": prompt})
        tok = torch.argmax(logits[:, -1], -1)
        out = [tok]
        for _ in range(12):
            logits, state = decode(params, tok, state)
            tok = torch.argmax(logits, -1)
            out.append(tok)
    generated = torch.stack(out, 1).cpu()
    print("generated:", generated[0].tolist())
    launches = kernels.launch_counts()
    print("kernel launches:", launches)
    return {"config": cfg, "losses": losses, "generated": generated,
            "launches": launches}


if __name__ == "__main__":
    main()
