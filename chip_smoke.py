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
     same comparison;
  5. training: smollm-135m at full width trained for 8 steps by the
     port's train launcher through the causal linear-attention kernel
     (loss finite and falling, 30 launches a step), checkpointed, then
     finetuned qkv-only for 3 steps from that checkpoint (frozen bf16
     leaves bitwise, the frozen f32 feat.w moved by weight decay alone,
     wq/wk/wv/m_mat moved);
  6. cross-device training: one loss and all its gradients at full
     width and 4 layers on the card (kernel) and on the CPU (plain
     path), same params and batch; a planted fault (each layer's kernel
     call fed the next layer's key features) must fail the same check.
Phase 2 holds the training kernels too (linear_attention_causal and
prf_featmap, forward and gradients) and times them at the smollm-135m
training shapes. Then the kernels line and, last, the ``{"ok": true,
...}`` line. Exits
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
# phase 6, card (kernel) vs CPU (plain path), bf16 params, 4 layers:
# |loss gap| / |loss|, and over the param leaves the largest gradient gap
# over that leaf's max |gradient|. Sound readings on an H100: 4.4e-6 and
# 0.027 (wo); the planted fault: 7.0e-5 and 1.52. Limits at 2.3x, 2.6x.
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 0.07
B, L_TRAIN = 8, 512             # phase 5 batch: 8 sequences of 512 tokens


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


def lin_attn_flops(rows, kv_rows, l, m, dv, chunk=256):
    """Operations causal linear attention needs from a zero state: the
    fewer of its two exact forms on these shapes. Token-serial: per
    token, the state update S += k vᵀ, z += k once per KV row (shared by
    its group's query rows), and per query row q·S, q·z and the
    division. Chunked (the kernel's form): per query row and chunk of t
    tokens the causal half of the scores and of P·V (t(t+1)/2 entries at
    2m and 2dv operations, plus their row sums) and Q·S_in, Q·z_in for
    every chunk after the first; per KV row Kᵀ V and Σ K for every chunk
    a later chunk reads; the division."""
    serial = l * (kv_rows * m * (2 * dv + 1)
                  + rows * (2 * m * (dv + 1) + dv + 1))
    chunked = rows * l * (dv + 1)
    for c0 in range(0, l, chunk):
        t = min(chunk, l - c0)
        chunked += rows * t * (t + 1) // 2 * (2 * m + 2 * dv + 1)
        if c0:
            chunked += rows * 2 * t * m * (dv + 1)
        if c0 + chunk < l:
            chunked += kv_rows * t * m * (2 * dv + 1)
    return min(serial, chunked)


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


def phase_train_kernels(torch, dev, kl, kf):
    """Phase 2c: the training kernels, forward and gradients, against
    autograd of their plain versions; returns the worst forward error
    per kernel."""
    from repro_torch.kernels import check as kc

    err = {"linear_attention_causal": 0.0, "prf_featmap": 0.0}
    cases = []
    for b, g, hg, l, m, dv, dt in (
            (8, 3, 3, 512, 256, 64, torch.bfloat16),   # the main path's
            (8, 3, 3, 512, 256, 64, torch.float32),
            (2, 3, 3, 777, 256, 64, torch.float32),
            (4, 3, 3, 256, 256, 64, torch.bfloat16),
            (4, 3, 3, 100, 256, 64, torch.float32),
            (8, 3, 3, 1, 256, 64, torch.bfloat16),
            (2, 1, 8, 300, 256, 256, torch.float32)):  # darkformer-2b
        name = (f"linear_attention_causal N={b * g * hg} L={l} m={m} "
                f"dv={dv} v={str(dt).split('.')[-1]}")
        args = kc.make_lin_attn_inputs(dev, b, g, hg, l, m, dv,
                                       seed=len(cases), dtype=dt)
        fwd, grad = kc.check_autograd(
            name, kl, lambda q, k, v: kl.linear_attention_causal(
                q, k, v, eps=1e-8),
            lambda q, k, v: kl.linear_attention_causal_plain(q, k, v, 1e-8),
            args, seed=len(cases))
        err["linear_attention_causal"] = max(
            err["linear_attention_causal"], fwd)
        cases.append({"case": name, "max_abs_err": fwd,
                      "grad_max_abs_err": grad})
    for n, d, r, m, dark, dt in (
            (B * 9 * L_TRAIN, 64, 64, 256, True, torch.float32),
            (4099, 64, 64, 256, True, torch.float32),
            (1000, 64, 32, 256, True, torch.bfloat16),
            (777, 64, 64, 256, False, torch.float32)):
        name = (f"prf_featmap N={n} d={d} r={r} m={m} dark={dark} "
                f"x={str(dt).split('.')[-1]}")
        args = kc.make_featmap_inputs(dev, n, d, r, m, dark,
                                      seed=len(cases), dtype=dt)
        fwd, grad = kc.check_autograd(name, kf, kf.prf_featmap,
                                      kf.prf_featmap_plain, args,
                                      seed=len(cases))
        err["prf_featmap"] = max(err["prf_featmap"], fwd)
        cases.append({"case": name, "max_abs_err": fwd,
                      "grad_max_abs_err": grad})
    emit({"phase": "train_kernels_vs_plain", "tolerance_f32": kc.F32_TOL,
          "tolerance_bf16_out": kc.BF16_OUT_TOL, "cases": cases})
    return err


def phase_train_timing(torch, dev, kl, kf):
    """Phase 2d: the training kernels timed (forward, CUDA events) at the
    smollm-135m training shapes beside their plain versions and bounds.
    linear_attention_causal: 8 x 512 tokens, 9 heads over 3 KV groups,
    m = 256, dv = 64, bf16 v (operations: :func:`lin_attn_flops`).
    prf_featmap: the 8·9·512 query rows of that batch, d = r = 64."""
    from repro_torch.kernels import check as kc

    out = {}
    b, g, hg, l, m, dv = B, 3, 3, L_TRAIN, 256, 64
    args = kc.make_lin_attn_inputs(dev, b, g, hg, l, m, dv, seed=11,
                                   dtype=torch.bfloat16)
    rows, kv_rows = b * g * hg, b * g
    flops = lin_attn_flops(rows, kv_rows, l, m, dv)
    byts = nbytes(*args) + rows * l * dv * 2
    bms, by = bound(byts, flops)
    with torch.no_grad():
        out["linear_attention_causal"] = {
            "shape": f"B={b} G={g} Hg={hg} L={l} m={m} dv={dv} v=bf16",
            "ms": time_ms(torch, lambda: kl.linear_attention_causal(
                *args, eps=1e-8), 20),
            "plain_ms": time_ms(
                torch, lambda: kl.linear_attention_causal_plain(*args, 1e-8),
                10),
            "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}
    n, d, r = b * 9 * l, 64, 64
    args = kc.make_featmap_inputs(dev, n, d, r, m, True, seed=12)
    flops = n * (2 * d * r + 2 * r * m + 2 * r)
    byts = nbytes(*args) + n * m * 4
    bms, by = bound(byts, flops)
    with torch.no_grad():
        out["prf_featmap"] = {
            "shape": f"N={n} d={d} r={r} m={m} dark x=f32",
            "ms": time_ms(torch, lambda: kf.prf_featmap(*args), 50),
            "plain_ms": time_ms(torch, lambda: kf.prf_featmap_plain(*args),
                                20),
            "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}
    emit({"phase": "train_kernel_timing", **out})
    return out


def phase_train(torch, dev, mods):
    """Phase 5: smollm-135m at full width trained by the port's launcher
    (kernel on), checkpointed, then finetuned qkv-only from that
    checkpoint in a fresh state. Returns the kernels' launch counts over
    the 8 training steps."""
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.tree import flatten

    steps_n = 8
    ck = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    common = ["--arch", "smollm-135m", "--batch", str(B), "--seq",
              str(L_TRAIN), "--lr", "3e-4", "--warmup", "2", "--log-every",
              "1", "--device", str(dev)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in mods.values():
        mod.launches = 0
    t0 = time.perf_counter()
    out = train.main(common + ["--steps", str(steps_n), "--seed", "0",
                               "--ckpt-dir", str(ck), "--ckpt-every",
                               str(steps_n)])
    wall = time.perf_counter() - t0
    launches = {n: mod.launches for n, mod in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["config"]
    m = out["metrics"]
    losses = [x["loss"] for x in m]
    ms = [x["ms"] for x in m]
    p50 = float(np.percentile(ms, 50))
    emit({"phase": "train", "config": cfg.name, "n_layers": cfg.n_layers,
          "d_model": cfg.d_model, "n_heads": cfg.n_heads, "n_kv": cfg.n_kv,
          "d_head": cfg.head_dim, "num_features": cfg.attn.num_features,
          "vocab": cfg.vocab, "dtype": cfg.dtype, "batch": B,
          "seq": L_TRAIN, "steps": steps_n, "use_kernel": cfg.use_kernel,
          "loss": losses, "grad_norm": [x["grad_norm"] for x in m],
          "step_ms": ms, "step_ms_p50": p50,
          "tokens_per_s": B * L_TRAIN / (p50 / 1e3), "wall_s": wall,
          "launches": launches, "peak_mem_gb": peak})
    if len(losses) != steps_n or not all(np.isfinite(losses)):
        fail(f"train: losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"train: loss did not fall ({losses[0]} -> {losses[-1]})")
    want = {n: 0 for n in mods}
    want["linear_attention_causal"] = cfg.n_layers * steps_n
    if launches != want:
        fail(f"train: launches {launches}, expected {want}")
    del out

    # qkv-only finetune from the checkpoint, into params drawn from
    # another seed (so the restore must overwrite every leaf)
    pre, step = ckpt.restore_checkpoint(
        str(ck), {"params": lm.init_params(cfg, seed=1, device=dev)})
    mods["linear_attention_causal"].launches = 0
    ft = train.main(common + ["--steps", "3", "--seed", "1",
                              "--finetune-from", str(ck), "--qkv-only"])
    # a frozen leaf's gradient is zeroed (the reference's freeze), so only
    # the decoupled weight decay moves it, by 1 - lr·wd a step: below
    # rounding for the bf16 leaves (held bitwise), visible in the f32
    # feature draw feat.w (held to the decayed value)
    decay = float(np.prod([1 - x["lr"] * AdamWConfig().weight_decay
                           for x in ft["metrics"]]))
    frozen_moved, trained_still = [], []
    for (path, a), (_, b) in zip(flatten(pre["params"]),
                                 flatten(ft["params"])):
        if a.dtype == torch.float32:
            same = torch.allclose(b, a * decay, atol=0, rtol=1e-6)
        else:
            same = torch.equal(a, b)
        if steps.qkv_only_freeze(path) and not same:
            frozen_moved.append(path)
        if not steps.qkv_only_freeze(path) and same:
            trained_still.append(path)
    emit({"phase": "finetune_qkv_only", "from_step": step,
          "frozen_f32_decay": decay,
          "loss": [x["loss"] for x in ft["metrics"]],
          "step_ms": [x["ms"] for x in ft["metrics"]],
          "frozen_leaves_moved": frozen_moved,
          "trained_leaves_unchanged": trained_still,
          "launches": mods["linear_attention_causal"].launches})
    shutil.rmtree(ck, ignore_errors=True)
    if frozen_moved or trained_still:
        fail(f"finetune: frozen leaves moved {frozen_moved}, trained "
             f"leaves unchanged {trained_still}")
    if not all(np.isfinite(x["loss"]) for x in ft["metrics"]):
        fail("finetune: non-finite loss")
    if mods["linear_attention_causal"].launches != 3 * cfg.n_layers:
        fail("finetune: linear_attention_causal launches "
             f"{mods['linear_attention_causal'].launches}")
    return launches


def train_gaps(torch, got, ref):
    """(|loss gap| / |loss|, the largest per-leaf gradient gap over that
    leaf's max |gradient| and the leaf it occurs in)."""
    (lg, gg), (lr_, gr) = got, ref
    for t in (lg, lr_, *gg.values(), *gr.values()):
        if not bool(torch.isfinite(t).all()):
            fail("cross-device training: non-finite loss or gradient")
    loss = float((lg - lr_).abs() / lr_.abs())
    worst, where = 0.0, None
    for k, r in gr.items():
        gap = float((gg[k].float() - r.float()).abs().max()
                    / r.float().abs().max().clamp(min=1e-30))
        if gap > worst:
            worst, where = gap, k
    return loss, worst, where


def phase_train_cross_device(torch, dev, kl):
    """Phase 6: one loss and all its gradients, smollm-135m at full width
    and 4 layers, bf16, batch 2 x 256: the card through the kernel vs the
    CPU through the plain path, same params and batch. A planted fault
    (layer i's kernel call fed layer i+1's key features) must fail."""
    import repro_torch.kernels as kops
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm
    from repro_torch.tree import flatten

    cfg = configs.get_config("smollm-135m", n_layers=4, use_kernel=True)
    params = lm.init_params(cfg, seed=0, device=dev)
    data = SyntheticLM(cfg.vocab, 256, 2, seed=0).batch(0)

    def loss_and_grads(cfg, params, device):
        leaves = dict(flatten(params))
        for t in leaves.values():
            t.requires_grad_(True)
        batch = {k: torch.from_numpy(v).to(device).long()
                 for k, v in data.items()}
        loss, _ = lm.loss_fn(params, cfg, batch)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        out = {k: (torch.zeros_like(t) if g is None else g).detach().cpu()
               for (k, t), g in zip(leaves.items(), grads)}
        for t in leaves.values():
            t.requires_grad_(False)
        return loss.detach().cpu(), out

    kl.launches = 0
    card = loss_and_grads(cfg, params, dev)
    card_launches = kl.launches
    cpu = loss_and_grads(dataclasses.replace(cfg, use_kernel=False),
                         lm.tree_map(lambda t: t.cpu(), params), "cpu")
    sound = kops.linear_attention_causal
    kfs = []

    def record(qf, kf, v, **kw):
        kfs.append(kf.detach())
        return sound(qf, kf, v, **kw)

    def planted(qf, kf, v, **kw):
        i = len(fed)
        fed.append(i)
        return sound(qf, kfs[(i + 1) % len(kfs)], v, **kw)
    fed = []
    try:
        kops.linear_attention_causal = record
        with torch.no_grad():
            lm.loss_fn(params, cfg, {k: torch.from_numpy(v).to(dev).long()
                                     for k, v in data.items()})
        kops.linear_attention_causal = planted
        fault = loss_and_grads(cfg, params, dev)
    finally:
        kops.linear_attention_causal = sound
    loss_gap, grad_gap, where = train_gaps(torch, card, cpu)
    f_loss, f_grad, f_where = train_gaps(torch, fault, cpu)
    emit({"phase": "train_cross_device", "config": cfg.name,
          "n_layers": cfg.n_layers, "batch": 2, "seq": 256,
          "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
          "loss_rel_err": loss_gap, "grad_rel_err": grad_gap,
          "grad_worst_leaf": where, "loss_tolerance": TRAIN_LOSS_TOL,
          "grad_tolerance": TRAIN_GRAD_TOL, "launches": card_launches,
          "planted_fault": {"what": "layer i's kernel call fed layer i+1's "
                                    "key features",
                            "loss_rel_err": f_loss, "grad_rel_err": f_grad,
                            "grad_worst_leaf": f_where}})
    if card_launches != cfg.n_layers:
        fail(f"cross-device training: {card_launches} kernel launches for "
             f"{cfg.n_layers} layers")
    if loss_gap > TRAIN_LOSS_TOL or grad_gap > TRAIN_GRAD_TOL:
        fail(f"cross-device training: loss gap {loss_gap:.3e}, gradient "
             f"gap {grad_gap:.3e} ({where})")
    if f_loss <= TRAIN_LOSS_TOL and f_grad <= TRAIN_GRAD_TOL:
        fail("cross-device training check passes a planted fault")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import linear_attn_scan as kl
    from repro_torch.kernels import prf_featmap as kf
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
    errs.update(phase_train_kernels(torch, dev, kl, kf))
    timing = phase_timing(torch, dev, kd, kp)
    timing.update(phase_train_timing(torch, dev, kl, kf))
    cfg, params, launches = phase_main_path(torch, dev, kd, kp)
    phase_cross_device(torch, dev, cfg, params)
    del params
    mods = {"prf_fused_decode": kd, "prf_fused_prefill": kp,
            "linear_attention_causal": kl, "prf_featmap": kf}
    train_launches = phase_train(torch, dev, mods)
    # the serving kernels' launches come from phase 3, the training
    # kernels' from phase 5 (prf_featmap lies on no path: 0)
    launches.update({n: train_launches[n]
                     for n in ("linear_attention_causal", "prf_featmap")})
    phase_train_cross_device(torch, dev, kl)

    replaces = {
        "prf_fused_decode": "src/repro/kernels/prf_fused_decode.py:131",
        "prf_fused_prefill": "src/repro/kernels/prf_fused_prefill.py:167",
        "linear_attention_causal": "src/repro/kernels/linear_attn_scan.py:73",
        "prf_featmap": "src/repro/kernels/prf_featmap.py:51"}
    sources = {"linear_attention_causal": "linear_attn_scan"}
    emit({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{sources.get(n, n)}.cu",
         "replaces": replaces[n], "launches": launches[n],
         "max_abs_err": errs[n], "ms": timing[n]["ms"],
         "plain_ms": timing[n]["plain_ms"],
         "bound_ms": timing[n]["bound_ms"],
         "bound_by": timing[n]["bound_by"], "library_ms": None}
        for n in mods],
        "card": card, "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
