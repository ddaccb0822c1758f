#!/usr/bin/env python3
"""The port's two serving schedulers on the same traffic, in turns.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_serve_overlap.py          # smollm-135m, 4 turns

Serves ``chip_smoke.py`` phase 3's traffic (smollm-135m at full width,
random weights from seed 0, kernels on; 16 requests of 64-512 prompt
and 32-64 new tokens, all at 0; 8 slots, max_len 1024, chunk_tokens
256) through the sequential (``seq``) and the overlapped (``ovl``)
``ServingEngine`` in turns: seq, ovl, ovl, seq, ... (``--turns``), each
run on a fresh engine after one warm-up engine per scheduler. Every run
prints one JSON line: wall, throughput, TTFT p50, TPOT p50 and p99,
decode stall and dispatch depth, steps. Then one run of each scheduler
under ``torch.profiler`` (CUDA activity only, so the host's dispatch is
not slowed by CPU-side recording; its times are not the ones above):
the device's busy ms (the union of kernel intervals) over the run's
wall, its idle share, and kernel launches per decode step. Prints the
card's name and power limit first. ``--reduced --device cpu``
rehearses the control flow on the CPU, where no device time exists.
Imports neither JAX nor the reference.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "scripts"))

from torch_train_profile import busy_us  # noqa: E402


def run(torch, params, cfg, dev, overlap: bool, profiled: bool = False):
    from repro_torch.serving import ServingEngine, synthetic_requests

    eng = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                        chunk_tokens=256, seed=0, overlap=overlap,
                        device=dev)
    reqs = synthetic_requests(16, cfg.vocab, seed=0,
                              prompt_range=(64, 512), gen_range=(32, 64))
    for r in reqs:
        eng.submit(r)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    events = []
    prof = None
    if profiled and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    sync()
    t0 = time.perf_counter()
    results = eng.run()
    sync()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    st = eng.stats
    if sorted(len(r.tokens) for r in results) != sorted(
            r.max_new_tokens for r in reqs):
        raise SystemExit("torch_serve_overlap: a request fell short")
    tpots = [t for r in results for t in r.tpots]
    out = {"scheduler": "ovl" if overlap else "seq", "wall_s": wall,
           "throughput_tok_s": st["emitted_tokens"] / wall,
           "ttft_p50_ms": float(np.percentile([r.ttft for r in results],
                                              50)) * 1e3,
           "tpot_p50_ms": float(np.percentile(tpots, 50)) * 1e3,
           "tpot_p99_ms": float(np.percentile(tpots, 99)) * 1e3,
           "prefill_calls": st["prefill_calls"],
           "decode_steps": st["decode_steps"],
           **{k: st[k] for k in ("decode_stall_ms_p50",
                                 "decode_stall_ms_p99",
                                 "decode_stall_ms_max",
                                 "dispatch_depth_mean",
                                 "dispatch_depth_max")}}
    if profiled:
        busy = busy_us([(e.time_range.start, e.time_range.end)
                        for e in events]) / 1e3
        out = {"scheduler": out["scheduler"], "profiled": True,
               "wall_s": wall, "device_busy_ms": busy if events else None,
               "device_idle_share": (1 - busy / (wall * 1e3)
                                     if events else None),
               "kernel_launches": len(events),
               "launches_per_decode_step": (len(events) / st["decode_steps"]
                                            if events else None)}
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=2,
                    help="rounds of (seq, ovl, ovl, seq)")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_serve_overlap: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)

    from repro_torch import configs
    from repro_torch.models import lm
    cfg = configs.get_config("smollm-135m", reduced=args.reduced,
                             use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    for overlap in (False, True):              # warm-up, one each
        run(torch, params, cfg, dev, overlap)
    for _ in range(args.turns):
        for overlap in (False, True, True, False):
            print(json.dumps(run(torch, params, cfg, dev, overlap)),
                  flush=True)
    for overlap in (False, True):
        print(json.dumps(run(torch, params, cfg, dev, overlap,
                             profiled=True)), flush=True)
    print(json.dumps({"device": (torch.cuda.get_device_name(0)
                                 if dev.type == "cuda" else "cpu")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
