"""chip_smoke.py's phase 12 (f) alone, on the card: build the kernels,
then ``runtime_tp`` on a one-rank NCCL group (tensor parallelism over
``model`` with its branches on one rank), held against the plain step's
losses that phase 12 (e) would give it (run here). Prints the card, the phase's
JSON line and its launches; exits non-zero when a check fails.

  python3 scripts/torch_tp_probe.py
"""
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main():
    import subprocess
    import torch
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import COUNTERS, _build
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import local_batch

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print("build_s", _build.build(), flush=True)
    dev = torch.device("cuda")
    store = ROOT / "build" / "torch_tp_probe_store"
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type="cuda")
        cfg = configs.get_config("smollm-135m", use_kernel=True)
        params = lm.init_params(cfg, seed=0, device=dev)
        opt_cfg = AdamWConfig(lr=3e-4)
        data = SyntheticLM(cfg.vocab, cs.L_TRAIN, cs.B, seed=0)
        plain = steps.make_train_step(cfg, opt_cfg, constant(3e-4))
        p, o, losses = params, adamw_init(params, opt_cfg), []
        for i in range(cs.TP_STEPS):
            p, o, m = plain(p, o, to_device(local_batch(data.batch(i), mesh),
                                            dev), i)
            losses.append(float(m["loss"]))
        del p, o
        fields, check, launches, checks = cs.runtime_tp(
            torch, dev, dict(COUNTERS), mesh, cfg, params, opt_cfg, data,
            losses)
        cs.emit({"phase": "runtime_tp", **fields})
        print("launches", launches, "check launches", checks, flush=True)
        check()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    print("total_s", time.perf_counter() - t0, flush=True)


if __name__ == "__main__":
    main()
