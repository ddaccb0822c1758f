#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as a JSON line:
  1. card and build: the card's name and power limit (nvidia-smi), then
     the kernels built from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. kernels vs plain: each CUDA kernel held against its plain PyTorch
     version on the card, at the smollm-135m and darkformer-2b head
     geometries and at the main path's shapes, then timed (CUDA events)
     at the smollm-135m serving shape beside its plain version and its
     bound;
  3. main path: smollm-135m at full width (random weights from a seed)
     served by the port's ``ServingEngine`` through the kernels, with the
     kernels' launch counts checked against the engine's calls;
  4. cross-device: one prefill chunk and two decode steps on the card
     (kernels) and on the CPU (plain path) with the same params, logits
     and every layer's state compared; a planted fault must fail the
     same comparison.
Then the kernels line and, last, the ``{"ok": true, ...}`` line. Exits
non-zero, without that line, when there is no CUDA device or any phase
fails. Imports neither JAX nor the reference package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
# phase 4, card (kernels) vs CPU (plain path), both bf16 after 30 layers:
# the largest |logit| gap over max |logit|, and over each layer's S and z
# (stabilizer factored out) the largest gap over max |S|, max |z|
CROSS_DEVICE_TOL = 0.05
STATE_TOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(byte_count, flops):
    t_bytes = byte_count / HBM_BYTES_PER_S
    t_ops = flops / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def feature_flops(rows_q, rows_k, d, r, m, dark):
    """x A plus the norm ‖Mx‖² for every featurized row."""
    per_row = 2 * d * m + (2 * r * d if dark else 0) + 2 * r
    return (rows_q + rows_k) * per_row


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_kernels(torch, dev, kd, kp):
    """Phase 2: every kernel vs its plain version; returns the worst
    error per kernel."""
    from repro_torch.kernels import check as kc

    err = {"prf_fused_decode": 0.0, "prf_fused_prefill": 0.0}
    geos = {"smollm-135m": (8, 3, 3, 64, 256, 64),
            "darkformer-2b": (4, 1, 8, 256, 256, 256)}
    cases = []
    for gname, (b, g, hg, d, m, dv) in geos.items():
        for dark, stab in ((True, True), (True, False), (False, True)):
            name = f"decode {gname} dark={dark} stabilize={stab} f32"
            args = kc.make_inputs(dev, b, g, hg, d, m, dv, None, dark,
                                  seed=len(cases))
            e = kc.check_case(name, kd, kd.fused_prf_decode,
                              kd.prf_fused_decode_plain, args,
                              stabilize=stab)
            err["prf_fused_decode"] = max(err["prf_fused_decode"], e)
            cases.append({"case": name, "max_abs_err": e})
        vls = [512, 0, 300, 257, 256, 1, 511, 100][:b]
        for dark, stab, l, vl in ((True, True, 512, vls),
                                  (True, False, 512, vls),
                                  (False, True, 64, None)):
            name = (f"prefill {gname} L={l} dark={dark} stabilize={stab} "
                    f"valid_len={vl} f32")
            args = kc.make_inputs(dev, b, g, hg, d, m, dv, l, dark,
                                  seed=len(cases))
            vlt = (None if vl is None else
                   torch.tensor(vl, dtype=torch.int32, device=dev))
            e = kc.check_case(name, kp, kp.fused_prf_prefill,
                              kp.prf_fused_prefill_plain, args, vlt,
                              stabilize=stab)
            err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
            cases.append({"case": name, "max_abs_err": e})
    # the main path's shapes and input type: smollm-135m, 8 slots, bf16
    args = kc.make_inputs(dev, 8, 3, 3, 64, 256, 64, None, True, seed=100,
                          dtype=torch.bfloat16)
    e = kc.check_case("decode main-path bf16", kd, kd.fused_prf_decode,
                      kd.prf_fused_decode_plain, args, eps=1e-8)
    err["prf_fused_decode"] = max(err["prf_fused_decode"], e)
    cases.append({"case": "decode main-path bf16", "max_abs_err": e})
    for l, vl in ((32, [32] * 8), (256, [256, 200, 17, 1, 0, 0, 0, 0])):
        name = f"prefill main-path bf16 L={l} valid_len={vl}"
        args = kc.make_inputs(dev, 8, 3, 3, 64, 256, 64, l, True,
                              seed=101 + l, dtype=torch.bfloat16)
        vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
        e = kc.check_case(name, kp, kp.fused_prf_prefill,
                          kp.prf_fused_prefill_plain, args, vlt, eps=1e-8)
        err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
        cases.append({"case": name, "max_abs_err": e})
    emit({"phase": "kernels_vs_plain", "tolerance_f32": kc.F32_TOL,
          "tolerance_bf16_out": kc.BF16_OUT_TOL, "cases": cases})
    return err


def phase_timing(torch, dev, kd, kp):
    """Phase 2b: kernel and plain times at the smollm-135m serving shape
    (8 slots; prefill 8 rows of 32 tokens, the packer's grant at 8 staged
    admissions and chunk_tokens=256), with the bound of each."""
    from repro_torch.kernels import check as kc

    b, g, hg, d, m, dv = 8, 3, 3, 64, 256, 64
    out = {}
    args = kc.make_inputs(dev, b, g, hg, d, m, dv, None, True, seed=7,
                          dtype=torch.bfloat16)
    q, k, v, a, mm, s, z, c = args
    byts = nbytes(q, k, v, a, mm) + 2 * nbytes(s, z, c) + \
        b * g * hg * dv * 4
    flops = (feature_flops(b * g * hg, b * g, d, d, m, True)
             + b * g * hg * (4 * m * dv + 4 * m))
    bms, by = bound(byts, flops)
    out["prf_fused_decode"] = {
        "shape": f"B={b} G={g} Hg={hg} d={d} m={m} dv={dv} bf16",
        "ms": time_ms(torch, lambda: kd.fused_prf_decode(*args, eps=1e-8),
                      200),
        "plain_ms": time_ms(torch, lambda: kd.prf_fused_decode_plain(
            *args, eps=1e-8), 50),
        "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}
    l = 32
    args = kc.make_inputs(dev, b, g, hg, d, m, dv, l, True, seed=8,
                          dtype=torch.bfloat16)
    q, k, v, a, mm, s, z, c = args
    vl = torch.full((b,), l, dtype=torch.int32, device=dev)
    n_valid = int(vl.sum())
    byts = (nbytes(q, k, v, a, mm, vl) + 2 * nbytes(s, z, c)
            + nbytes(v) * hg)
    flops = (feature_flops(n_valid * g * hg, n_valid * g, d, d, m, True)
             + n_valid * g * hg * (4 * m * dv + 4 * m))
    bms, by = bound(byts, flops)
    out["prf_fused_prefill"] = {
        "shape": f"B={b} L={l} G={g} Hg={hg} d={d} m={m} dv={dv} bf16",
        "ms": time_ms(torch, lambda: kp.fused_prf_prefill(
            *args, vl, eps=1e-8), 50),
        "plain_ms": time_ms(torch, lambda: kp.prf_fused_prefill_plain(
            *args, vl, eps=1e-8), 20),
        "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}
    emit({"phase": "kernel_timing", **out})
    return out


def phase_main_path(torch, dev, kd, kp):
    """Phase 3: smollm-135m at full width served through the kernels."""
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import ServingEngine, synthetic_requests

    cfg = configs.get_config("smollm-135m", use_kernel=True)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    init_s = time.perf_counter() - t0

    def engine():
        return ServingEngine(params, cfg, max_slots=8, max_len=1024,
                             chunk_tokens=256, seed=0, device=dev)
    warm = engine()                        # cuBLAS, allocator, libraries
    for r in synthetic_requests(2, cfg.vocab, seed=1, prompt_range=(8, 40),
                                gen_range=(2, 4)):
        warm.submit(r)
    warm.run()
    del warm

    eng = engine()
    reqs = synthetic_requests(16, cfg.vocab, seed=0,
                              prompt_range=(64, 512), gen_range=(32, 64))
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    kd.launches = 0
    kp.launches = 0
    t0 = time.perf_counter()
    results = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"prf_fused_decode": kd.launches,
                "prf_fused_prefill": kp.launches}
    st = eng.stats
    want = {r.uid: r.max_new_tokens for r in reqs}
    got = {r.uid: len(r.tokens) for r in results}
    if got != want:
        fail(f"main path: tokens per request {got}, expected {want}")
    if st["prefill_path"] != "fused_kernel" or \
            st["decode_path"] != "fused_kernel":
        fail(f"main path ran {st['prefill_path']}/{st['decode_path']}")
    if launches["prf_fused_prefill"] != st["prefill_calls"] * cfg.n_layers:
        fail(f"prefill launches {launches['prf_fused_prefill']} != "
             f"{st['prefill_calls']} calls x {cfg.n_layers} layers")
    if launches["prf_fused_decode"] != st["decode_steps"] * cfg.n_layers:
        fail(f"decode launches {launches['prf_fused_decode']} != "
             f"{st['decode_steps']} steps x {cfg.n_layers} layers")
    tpots = [t for r in results for t in r.tpots]
    ttfts = [r.ttft for r in results]
    emit({"phase": "main_path", "config": cfg.name,
          "n_layers": cfg.n_layers, "d_model": cfg.d_model,
          "n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "d_head": cfg.head_dim,
          "num_features": cfg.attn.num_features, "vocab": cfg.vocab,
          "dtype": cfg.dtype, "slots": 8, "max_len": 1024,
          "chunk_tokens": 256, "requests": len(reqs),
          "param_init_s": init_s, "wall_s": wall,
          "emitted_tokens": st["emitted_tokens"],
          "throughput_tok_s": st["emitted_tokens"] / wall,
          "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
          "tpot_p50_ms": float(np.percentile(tpots, 50)) * 1e3,
          "tpot_p99_ms": float(np.percentile(tpots, 99)) * 1e3,
          "prefill_calls": st["prefill_calls"],
          "decode_steps": st["decode_steps"], "launches": launches,
          "launches_per_prefill_call":
              launches["prf_fused_prefill"] / st["prefill_calls"],
          "launches_per_decode_step":
              launches["prf_fused_decode"] / st["decode_steps"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    return cfg, params, launches


def drive(torch, lm, cfg, params, dev, toks, vl, feed=None, proj=None):
    """One ragged prefill chunk and two decode steps from a fresh state.
    Each decode step is fed ``feed[i]``, or the argmax of the logits
    before it. Returns (logits of each step on the CPU, tokens fed, the
    final state on the CPU)."""
    st = lm.init_serve_state(cfg, b=toks.shape[0], max_len=128,
                             per_slot=True, device=dev)
    logits, st = lm.prefill_chunk(
        params, cfg, {"tokens": torch.tensor(toks, device=dev)}, st,
        valid_len=torch.tensor(vl, device=dev), proj=proj)
    out, fed = [logits.float().cpu()], []
    for i in range(2):
        fed.append(out[-1].argmax(-1) if feed is None else feed[i])
        logits, st = lm.decode_step(params, cfg, fed[-1].to(dev), st,
                                    proj=proj)
        out.append(logits.float().cpu())
    return out, fed, st["layers"]._replace(
        **{k: t.cpu() for k, t in st["layers"]._asdict().items()})


def gaps(torch, got, ref):
    """How far run ``got`` is from run ``ref``: the largest |logit| gap
    over max |logit| per step, and over layers the largest gap of S and z
    over max |S|, max |z| of that layer. S and z are compared as S e^c,
    z e^c, since the stabilizer c cancels in the outputs and two devices
    may round it differently."""
    (lg, _, sg), (lr, _, sr) = got, ref
    for t in (*lg, *lr, sg.s, sg.z, sr.s, sr.z):
        if not bool(torch.isfinite(t).all()):
            fail("cross-device: non-finite logits or state")
    logit = [float((g - r).abs().max() / r.abs().max())
             for g, r in zip(lg, lr)]
    rescale = torch.exp(sg.c - sr.c)                 # (L, B, G, 1, 1, 1)
    state = 0.0
    for g, r in ((sg.s * rescale, sr.s), (sg.z * rescale[..., 0], sr.z)):
        per_layer = ((g - r).abs().flatten(1).amax(1)
                     / r.abs().flatten(1).amax(1))
        state = max(state, float(per_layer.max()))
    return logit, state


def phase_cross_device(torch, dev, cfg, params):
    """Phase 4: the card's kernel path vs the CPU's plain path, same
    params, same tokens: one ragged prefill chunk, two decode steps; the
    logits of every step and every layer's final state are compared.
    A planted fault (each layer run with the next layer's projection)
    must fail the same check."""
    from repro_torch.models import lm

    cpu_cfg = dataclasses.replace(cfg, use_kernel=False)
    cpu_params = lm.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 64))
    vl = np.array([64, 40], np.int32)
    card = drive(torch, lm, cfg, params, dev, toks, vl)
    cpu = drive(torch, lm, cpu_cfg, cpu_params, "cpu", toks, vl,
                feed=card[1])
    shifted = lm.tree_map(lambda t: torch.roll(t, 1, dims=0),
                          lm.build_decode_proj(params, cfg))
    planted = drive(torch, lm, cfg, params, dev, toks, vl, feed=card[1],
                    proj=shifted)
    logit_err, state_err = gaps(torch, card, cpu)
    fault_logit, fault_state = gaps(torch, planted, cpu)
    agree = [float((g.argmax(-1) == c.argmax(-1)).float().mean())
             for g, c in zip(card[0], cpu[0])]
    emit({"phase": "cross_device", "rel_max_err": logit_err,
          "state_rel_err": state_err, "tolerance": CROSS_DEVICE_TOL,
          "state_tolerance": STATE_TOL, "argmax_agreement": agree,
          "planted_fault": {"what": "each layer run with the next layer's "
                                    "projection A, M",
                            "rel_max_err": fault_logit,
                            "state_rel_err": fault_state}})
    if max(logit_err) > CROSS_DEVICE_TOL:
        fail(f"cross-device logits differ by {max(logit_err):.3e} of "
             "max |logit|")
    if state_err > STATE_TOL:
        fail(f"cross-device state differs by {state_err:.3e} of its max")
    if max(fault_logit) <= CROSS_DEVICE_TOL and fault_state <= STATE_TOL:
        fail("cross-device check passes a planted fault")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import prf_fused_decode as kd
    from repro_torch.kernels import prf_fused_prefill as kp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    build_s = _build.build()
    emit({"phase": "build", "seconds": build_s,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "ptxas": {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                        if "registers" in ln or "spill" in ln][:12]
                    for n in _build.SOURCES}})

    errs = phase_kernels(torch, dev, kd, kp)
    timing = phase_timing(torch, dev, kd, kp)
    cfg, params, launches = phase_main_path(torch, dev, kd, kp)
    phase_cross_device(torch, dev, cfg, params)

    replaces = {
        "prf_fused_decode": "src/repro/kernels/prf_fused_decode.py:131",
        "prf_fused_prefill": "src/repro/kernels/prf_fused_prefill.py:167"}
    emit({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{n}.cu",
         "replaces": replaces[n], "launches": launches[n],
         "max_abs_err": errs[n], "ms": timing[n]["ms"],
         "plain_ms": timing[n]["plain_ms"],
         "bound_ms": timing[n]["bound_ms"],
         "bound_by": timing[n]["bound_by"], "library_ms": None}
        for n in ("prf_fused_decode", "prf_fused_prefill")],
        "card": card, "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
