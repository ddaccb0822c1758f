#!/usr/bin/env python3
"""Where a train step of the PyTorch/CUDA port spends its device time.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_train_profile.py        # smollm-135m, 8 x 512
    python3 scripts/torch_train_profile.py --arch rwkv6-7b --layers 8

Runs the port's train launcher (``repro_torch.launch.train.main``):
smollm-135m at full width, random weights from seed 0, kernel on,
SyntheticLM batches of 8 x 512, lr 3e-4. ``torch.profiler`` skips the
first WARM steps, warms up over one and records the next ACTIVE. Prints
the card's name and power limit and one JSON line: the host-clock ms of
the recorded steps, the device's busy ms (the union of the kernels'
device intervals), its idle share, the device time by class of kernel
(the B5 kernel, matrix products, elementwise, reductions, the rest) and
the top kernels by device time, and the device time of the RWKV-6
token loop (``models.recurrent._wkv_scan``: its forward ops, those of
its remat recompute, and the backward of both) and its share of the
busy time. ``--layers N`` cuts the config's depth to N layers (the
launcher has no depth flag: the script hands it the cut config).
Further arguments go to the launcher after these defaults (``--reduced
--device cpu`` rehearses the control flow on the CPU, where no device
time is recorded). Imports neither JAX nor the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WARM, ACTIVE, TOP = 3, 2, 25
SCAN = "recurrent._wkv_scan"           # the token loop's profiler range
# substrings of kernel names, first match wins
CLASSES = (("linear_attn_causal (B5)", ("las::",)),
           ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
           ("reduction", ("reduce", "softmax", "norm")),
           ("elementwise", ("elementwise", "vectorized", "unrolled",
                            "copy", "fill", "cat", "index")))


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k.lower() in low for k in keys):
            return cls
    return "other"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def scan_device_us(events) -> float:
    """Device time of the kernels launched inside a ``SCAN`` range, or by
    the backward of an autograd op recorded inside one (a backward node
    carries its forward op's sequence number and thread), the engine's
    accumulation of that node's gradients into their buffers included
    (it runs in the node's ``autograd::engine::evaluate_function`` range,
    outside the node's own)."""
    def ancestors(e):
        while e is not None:
            yield e
            e = e.cpu_parent

    fwd = set()
    inside = set()
    for e in events:
        if any(a.name == SCAN for a in ancestors(e)):
            inside.add(id(e))
            if e.sequence_nr >= 0:
                fwd.add((e.sequence_nr, e.thread))
    # the scan's backward nodes, and the engine ranges around them
    roots = set()
    for e in events:
        if e.scope == 1 and (e.sequence_nr, e.fwd_thread) in fwd:
            roots.add(id(e))
            p = e.cpu_parent
            if p is not None and p.name.startswith(
                    "autograd::engine::evaluate_function"):
                roots.add(id(p))
    total = 0.0
    for e in events:
        if id(e) in inside or any(id(a) in roots for a in ancestors(e)):
            total += sum(k.duration for k in e.kernels)
    return total


@contextlib.contextmanager
def scan_range():
    """Wrap ``models.recurrent._wkv_scan`` (looked up at each call) in a
    profiler range named ``SCAN``."""
    import torch
    from repro_torch.models import recurrent

    plain = recurrent._wkv_scan

    @functools.wraps(plain)
    def ranged(*args):
        with torch.profiler.record_function(SCAN):
            return plain(*args)
    recurrent._wkv_scan = ranged
    try:
        yield
    finally:
        recurrent._wkv_scan = plain


def main(argv=None) -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import configs
    from repro_torch.launch import train

    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--layers", type=int, default=0)
    own, _ = ap.parse_known_args(argv)
    cuda = own.device != "cpu"
    if own.layers:
        i = argv.index("--layers")
        del argv[i:i + 2]
    if cuda:
        if not torch.cuda.is_available():
            print("torch_train_profile: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)

    total = WARM + 1 + ACTIVE
    launcher = ["--arch", "smollm-135m", "--batch", "8", "--seq", "512",
                "--lr", "3e-4", "--warmup", "2", "--seed", "0",
                "--log-every", "1", "--steps", str(total)] + argv
    done, events = {}, []

    def on_step(step):
        done[step] = time.perf_counter()   # each logged step synchronises
        prof.step()

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts,
                 schedule=schedule(skip_first=WARM, wait=0, warmup=1,
                                   active=ACTIVE, repeat=1),
                 on_trace_ready=lambda p: events.extend(p.events())) as prof, \
            (configs.cut_depth(own.layers) if own.layers
             else contextlib.nullcontext()), scan_range():
        out = train.main(launcher, on_step=on_step)
    wall_ms = (done[total - 1] - done[WARM]) * 1e3
    # device-side events, less the profiler's own step annotations
    # (ProfilerStep#n spans a whole step on the device timeline too)
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("ProfilerStep")]
    busy = busy_us([(e.time_range.start, e.time_range.end)
                    for e in kernels]) / 1e3
    by_name: dict[str, list] = {}
    for e in kernels:
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += e.time_range.elapsed_us() / 1e3
        rec[1] += 1
    by_class: dict[str, float] = {}
    for name, (ms, _) in by_name.items():
        by_class[classify(name)] = by_class.get(classify(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    scan_ms = scan_device_us(events) / 1e3
    print(json.dumps({
        "config": out["config"].name, "n_layers": out["config"].n_layers,
        "remat": out["config"].remat, "launcher_args": launcher,
        "profiled_steps": ACTIVE,
        "losses": [m["loss"] for m in out["metrics"]][-ACTIVE:],
        "wall_ms_per_step": wall_ms / ACTIVE,
        "device_busy_ms_per_step": busy / ACTIVE,
        "device_idle_share": (1 - busy / wall_ms) if kernels else None,
        "kernel_launches_per_step": len(kernels) / ACTIVE,
        "device_ms_per_step_by_class": {
            k: v / ACTIVE for k, v in sorted(by_class.items(),
                                             key=lambda kv: -kv[1])},
        "wkv_scan_device_ms_per_step": scan_ms / ACTIVE,
        "wkv_scan_share_of_busy": (scan_ms / busy) if busy else None,
        "top_kernels": [{"name": n[:120], "class": classify(n),
                         "ms_per_step": ms / ACTIVE,
                         "launches_per_step": cnt / ACTIVE}
                        for n, (ms, cnt) in top],
        "device": (torch.cuda.get_device_name(0) if cuda else "cpu")}),
        flush=True)
    return 0 if (kernels or not cuda) else 2


if __name__ == "__main__":
    sys.exit(main())
