"""The paper's main scenario in the PyTorch port (Fig. 2 bottom / Fig. 4),
the counterpart of examples/finetune_kernel_swap.py: take a pretrained
exact-attention model, swap in the DARKFormer kernel (pure config
change), whitening-calibrate the covariance from one batch (App. C), and
finetune q/k/v + M only (limited-attention finetuning). The model, the
steps, the learning rates and the batches are the JAX example's.

Runs on the GPU through the hand-written kernels by default; ``--device
cpu`` runs the plain path on the CPU:

    PYTHONPATH=src python examples/torch_finetune_kernel_swap.py
    PYTHONPATH=src python examples/torch_finetune_kernel_swap.py \
        --device cpu --pretrain-steps 3 --finetune-steps 2
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.feature_maps import FeatureConfig  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch.steps import (make_train_step,  # noqa: E402
                                      qkv_only_freeze, transplant)
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.lm import ModelConfig  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.schedules import constant  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pretrain-steps", type=int, default=80)
    ap.add_argument("--finetune-steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    base = ModelConfig(name="ft", n_layers=4, d_model=64, n_heads=4, n_kv=1,
                       d_ff=128, vocab=256,
                       attn=FeatureConfig(kind="exact"))
    data = SyntheticLM(base.vocab, 64, 8)

    def batch(step):
        return {k: torch.from_numpy(v).to(dev).long()
                for k, v in data.batch(step).items()}

    # --- pretrain with exact softmax attention ---
    params = lm.init_params(base, seed=0, device=dev)
    opt_cfg = AdamWConfig(lr=3e-3)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(base, opt_cfg, constant(3e-3))
    pre = []
    for i in range(args.pretrain_steps):
        params, opt, m = step(params, opt, batch(i), i)
        pre.append(float(m["loss"]))
    print(f"pretrained (exact): loss {pre[-1]:.4f}")

    # --- swap kernel: exact -> darkformer (adds feat params; rest
    # transplants), on the kernel path on the card
    cfg_d = dataclasses.replace(
        base, attn=FeatureConfig(kind="darkformer", num_features=16),
        use_kernel=dev.type == "cuda")
    p_dark = transplant(params, lm.init_params(cfg_d, seed=1, device=dev))

    # --- whitening calibration: M = Lambda^{-1/2} from one batch (App. C)
    calib = batch(10_000)
    p_cal = lm.whitening_calibrate(p_dark, cfg_d, calib)
    m_mat = p_cal["units"]["b0"]["attn"]["feat"]["m_mat"]
    print("covariance calibrated from one batch")

    # --- limited finetuning: only q/k/v and the PRF covariance M train
    opt = adamw_init(p_cal, opt_cfg)
    step_ft = make_train_step(cfg_d, opt_cfg, constant(1e-3),
                              freeze=qkv_only_freeze)
    ft, p_ft = [], p_cal
    for i in range(args.finetune_steps):
        p_ft, opt, m = step_ft(p_ft, opt, batch(1000 + i), i)
        ft.append(float(m["loss"]))
    print(f"finetuned (darkformer, q/k/v+M only): loss {ft[-1]:.4f}")
    return {"config": cfg_d, "pretrain_losses": pre, "finetune_losses": ft,
            "transplanted_params": p_dark, "calibrated_params": p_cal,
            "calibrated_m": m_mat, "calib_batch": calib,
            "finetuned_params": p_ft}


if __name__ == "__main__":
    main()
