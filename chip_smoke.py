#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root:  python3 chip_smoke.py

Phases, each printed as a JSON line:
  1. card and build: the card's name and power limit (nvidia-smi), then
     the seven kernels built from ``src/repro_torch/kernels/csrc`` with
     nvcc (one process per source, in parallel);
  2. kernels vs plain: each CUDA kernel held against its plain PyTorch
     version on the card, at the smollm-135m and darkformer-2b head
     geometries and at the main paths' shapes (prf_fused_decode and
     prf_fused_prefill also at phase 7's five head layouts and phase
     8's, bf16, 8 slots and the packer's four ragged grants; the training kernels and
     wkv6 with gradients), then timed (CUDA events, and device time
     from the profiler) at the main paths' shapes beside its plain
     version and its bound: the fused serving kernels at the smollm-135m
     serving shape (prf_fused_decode also at 1, 2 and 5 active slots,
     and timed at 8 slots with the L2 cold, over 30 pools as a decode
     step meets them, and warm; prf_fused_prefill held against its plain
     version and timed at each of the packer's four grants, 8 x 32 to
     1 x 256, and held at L = 300, a partial second T-chunk), the
     training kernels at its training shapes (prf_featmap also held at
     d_head 128 and darkformer-2b's 256, dark and isotropic, and timed
     at darkformer-2b's), the
     two-stage kernels (prf_decode_step at 1, 2, 4 and 8 slots of
     smollm-135m and 1 and 8 of darkformer-2b, f32 and bf16 v, kf and v
     per query head too, and timed at 8 slots cold and warm; the
     carried scan with and without a rho < 1, at the packer's four grants
     and darkformer-2b's heads, also chained over three uneven chunks, and
     timed at those shapes) and wkv6 at the rwkv6-7b geometry (held
     at widths 4 to 128, with the model's decays, exact zeros among
     them, and timed at 512 x 512 and 64 x 4096 tokens);
  3. main path: smollm-135m at full width (random weights from a seed)
     served by the port's ``ServingEngine`` through the fused kernels,
     with every kernel's launch count checked against the engine's
     calls and the histogram of prf_fused_prefill's call shapes;
     3b. two-stage serving: the same traffic with the LM's serve entry
     points pinned to ``fused=False`` (B4 per prefill call, B3 per decode
     step, no fused launch); throughput, TTFT and TPOT beside phase 3's,
     the share of greedy tokens equal to phase 3's streams and the
     histogram of B4's call shapes;
     3c. overlapped serving: phase 3's traffic through the overlapped
     scheduler (``overlap=True``, the serve CLI's default) under
     ``torch.cuda.set_sync_debug_mode("error")``, so any synchronising
     call in a step but retire's event wait fails it; full token
     counts, fused_kernel paths, B1/B2 launches equal to decode steps
     and prefill calls x 30, dispatch depth >= 1; throughput, TTFT,
     TPOT, decode stall and dispatch depth beside phase 3's, and the
     share of greedy tokens equal to phase 3's streams. Then 8 requests
     through a sequential and an overlapped engine with one staged row
     per prefill call (so the chunk boundaries agree): their greedy
     streams must be equal token for token;
     3d. exact serving: smollm-135m at full width with exact softmax
     attention (``kind="exact"``, a per-slot f32 KV cache of 1024
     positions a layer; random weights from seed 0) served with phase
     3's traffic through the overlapped scheduler under
     ``set_sync_debug_mode("error")``: full token counts, paths
     ``exact``, none of the seven kernels launched in the phase;
     throughput, TTFT and TPOT beside phase 3c's; then phase 3c's 8
     requests through both schedulers at ``prefill_rows=1``, whose
     greedy streams must be equal;
     3e. prefix-cache serving: a burst of system-prompt traffic
     (``shared_prefix_requests``: 16 requests arriving at once, 80%
     opening with one of two shared 256-token prefixes, suffixes of
     16-128 tokens, 16-32 new ones; the reference's
     benchmarks/serve_latency.py part 6 spaces its requests instead,
     Poisson at 16/s over one prefix, so TTFT here is mostly the wait
     for one of the 8 slots, not the fork) through engines with
     ``PrefixCacheConfig()`` defaults (block 16, page 16, 64 / 256 MiB),
     primed with each shared prefix. (a) phase 3's smollm-135m through
     the overlapped scheduler under ``set_sync_debug_mode("error")``:
     full token counts, forks and prefix hits, at least one snapshot
     demoted to pinned host memory and one promoted back, B1/B2 launches
     equal to decode steps and prefill calls x 30, the prefilled tokens
     plus the forked ones equal to the prompts' (every forked remainder
     ran through B2 from its seeded state); the same traffic through a
     cache-less engine for TTFT and throughput beside. (b) the traffic
     through cache-on and cache-less engines at ``prefill_rows=1``:
     every greedy stream equal, token for token. (c) the same with phase
     3d's exact model on paged KV: paths ``exact_paged``, no kernel
     launched, streams equal to the contiguous exact engine's;
  4. cross-device: one prefill chunk and two decode steps on the card
     (kernels) and on the CPU (plain path) with the same params, logits
     and every layer's state compared; a planted fault must fail the
     same comparison;
     4b. two-stage cross-check: the same chunk and steps through the
     card's two stages, held against the card's fused kernels and the
     CPU's plain path; a planted fault (each layer with the next layer's
     feature params) must fail;
     4c. exact cross-device: phase 4's chunk and decode steps through
     phase 3d's exact model on the card and on the CPU from the same
     params: logits within phase 4's limit, each layer's kv_k and kv_v
     within its state limit of their max, the cache lengths equal; a
     planted fault (each layer run with the next layer's wk) must fail;
  5. training: smollm-135m at full width trained for 8 steps by the
     port's train launcher through the causal linear-attention kernel
     under the config's remat "dots" (loss finite and falling, 60
     launches a step: :func:`b5_per_step`, each layer's forward and its
     recompute in the backward), checkpointed, then
     finetuned qkv-only for 3 steps from that checkpoint (frozen bf16
     leaves bitwise, the frozen f32 feat.w moved by weight decay alone,
     wq/wk/wv/m_mat moved);
     5b. serve --load: 4 requests at full width served by the serve CLI
     from phase 5's checkpoint (token counts, fused_kernel paths, B1/B2
     launches), with the streams of an engine built on the params
     restored from it;
     5c. the paper's scenario: smollm-135m with exact attention trained
     for 4 steps by the train launcher (``--kernel exact``; no kernel
     launched), checkpointed, its params transplanted into a darkformer
     (m 256, fresh w and m_mat; ``launch.steps.transplant``); the exact
     model's layer-0 q anisotropy (``lm.collect_qk``); the whitening
     calibration (``lm.whitening_calibrate`` on one 8 x 512 batch: B5
     once a layer and no other launch, its seconds, max |M Lambda M^T -
     I| with Lambda in f64 from its taps); card vs CPU calibration at 4
     layers (Sigma = M^T M and the taps), with a planted fault; the
     eval loss of the exact, the transplanted and the calibrated models;
     the calibrated params finetuned qkv-only for 3 steps through B5 (3
     x 60 launches under remat, m_mat moved), then 4 requests served from the
     finetuned params through B1/B2;
  6. cross-device training: one loss and all its gradients at full
     width and 4 layers on the card (kernel, 8 launches under remat) and
     on the CPU (plain path), same params and batch; a planted fault
     (each layer's kernel
     call fed the next layer's key features) must fail the same check;
  7. the homogeneous attention configs at full width, random weights
     from seed 0 drawn on the card, one model at a time: (a) granite-8b
     at its 36 layers (d_head 128, 32 H / 8 KV, untied head) and (b)
     granite-moe-3b-a800m at its 32 (40 experts, top-8), each serving 8
     requests (prompts of 64-256 tokens, 16-32 new ones) through the
     overlapped scheduler under
     ``set_sync_debug_mode("error")``: full token counts, fused_kernel
     paths, B1/B2 launches equal to decode steps and prefill calls x
     layers; TTFT, TPOT, throughput, the params' init seconds and peak
     device memory; for (b) then phase 3c's 8 requests through both
     schedulers at ``prefill_rows=1``, whose greedy streams must be
     equal; (c) qwen3-32b at 4 of its 64 layers, yi-34b at 4 of 60 and
     qwen3-moe-235b-a22b at 2 of 94, full width, 4 requests each, with
     the same checks; (d) for each of the five, phase 4's card-against-CPU
     check on its served params' first 2 layers, with its planted fault;
     for the MoE configs the CPU's run takes the card's experts (bf16
     router inputs that differ in their last bits move near-tied experts
     and, through the capacity positions, the drops after them), the
     card's capacity positions and kept flags must equal the CPU's
     cumulative sum over them, and every token the CPU's own top-k
     routes elsewhere must lie within the router's card-CPU perturbation
     at the swapped experts (``RouteTap``);
  8. recurrentgemma-2b at its full 26 layers and width (8 units of
     ("rec", "rec", "local"), then 2 remainder RG-LRU layers; 10 query
     heads on one KV head at d_head 256, m 256), random weights from
     seed 0 drawn on the card, in the unit/rem layout: (a) 8 requests
     (prompts of 64-256 tokens, 16-32 new ones) through the overlapped
     scheduler under ``set_sync_debug_mode("error")``: full token
     counts, fused_kernel paths, B1 = decode steps x 8 and B2 = prefill
     calls x 8 (only the local layers launch); TTFT, TPOT, throughput,
     init seconds and peak device memory; (b) 8 requests through both
     schedulers at ``prefill_rows=1``: equal greedy streams; (c) phase
     3e's traffic through cache-on and cache-less engines at
     ``prefill_rows=1``: forks of the RG-LRU's (h, conv) and the local
     layers' (S, z, c), prefilled plus forked tokens equal to the
     prompts', equal greedy streams; (d) phase 4's card-against-CPU
     check at 5 layers (one unit and both remainder layers): logits,
     the local layer's S and z, each RG-LRU layer's h and conv within
     ``REC_STATE_TOL``, with a planted fault (each RG-LRU layer fed the
     next one's gate weight). Phase 2 holds B1/B2 at its head layout;
  9. recurrentgemma-2b trained, checkpointed and calibrated over unit/rem:
     (a) the train launcher at full width and ``REC_TRAIN_LAYERS`` of
     its 26 layers (4 units and both remainder layers; params from
     seed 0 drawn on the host, as the launcher draws them), kernel on,
     ``REC_TRAIN_STEPS`` steps of ``REC_TRAIN_BATCH`` x 512 tokens (the
     launcher's default batch, which fits the card under remat "dots"
     at all 26: scripts/torch_train_memory.py): losses finite, B5 =
     steps x 8 (the 4 local layers, each recomputed under remat) and no
     other launch, a {"params", "opt"} checkpoint
     with its ``rem`` list written; step times, the checkpoint's bytes,
     peak device memory; (b) phase 5b's ``serve --load`` of that
     checkpoint (4 requests through B1/B2, streams equal to an engine
     on the params the run returned); (c) phase 6's card-against-CPU
     loss and every gradient at 5 layers (one unit and the two
     remainder layers; B5 twice, its local layer inside the unit), bf16,
     2 x 256, with a planted fault (each
     RG-LRU layer fed the next one's gate weight); (d)
     ``lm.whitening_calibrate`` on the card at those 5 layers: B5 once,
     the whitening gap within phase 5c's limit, card-against-CPU Sigma
     = M^T M within phase 5c's 0.02, with a planted fault (the taps
     scaled by the d^-1/4 temperature twice);
  10. rwkv6-7b at its full 32 layers and width (64 heads of 64, d_ff
     14 336, untied head; 7.5 B params drawn on the card from seed 0),
     layer-stacked, no attention layer: its RWKV-6 blocks run the
     reference's sequential scan in plain PyTorch, so no kernel of the
     port runs. (a) phase 7's traffic through the overlapped scheduler
     under ``set_sync_debug_mode("error")``: full token counts, paths
     ``none``, none of the seven kernels launched; TTFT, TPOT,
     throughput, init seconds and peak device memory; at its first 8
     layers, (b) 8 requests through both schedulers at
     ``prefill_rows=1``: equal greedy streams; (c) phase 3e's traffic
     through cache-on and cache-less engines at ``prefill_rows=1``:
     forks of the (S, shift, cshift) state, prefilled plus forked
     tokens equal to the prompts', equal greedy streams; (d) phase
     4's card-against-CPU check at 2 layers: logits within phase 4's
     limit, each layer's S, shift and cshift within ``REC_STATE_TOL``,
     with a planted fault (each layer's time mix fed the next layer's
     key weight);
  10b. rwkv6-7b trained at full width with its depth cut to
     ``RWKV_TRAIN_LAYERS`` of 32 (params drawn on the card from seed 0):
     (a) ``RWKV_TRAIN_STEPS`` steps of ``launch.steps.make_train_step``
     (the launcher's AdamW with an unfactored second moment and cosine
     schedule) on SyntheticLM batches of ``RWKV_TRAIN_BATCH`` x 512
     under the config's remat "dots": losses finite, none of the seven
     kernels launched (the block runs the reference's token loop, not
     B7), step ms p50 and max, peak device memory; (b) its first 2
     layers card vs CPU, 2 x 256: every bf16 gradient within phase 6's
     limit, the f32 loss within phase 6's limit and the bf16 loss gap
     reported beside it (phase 11 (b)'s rule), a planted fault (each
     layer fed the next layer's ``decay_a``) failing both;
  11. the non-text modalities: (a) hubert-xlarge (the audio encoder:
     48 layers, d_model 1280, 16 heads of 80, noncausal) at full size
     trained by the train launcher on masked audio frames
     (SyntheticAudio, ``HUBERT_TRAIN_BATCH`` x 512, params drawn on the
     host): losses finite, none of the seven kernels launched (the
     reference's noncausal PRF attention is the plain two-matmul form);
     step times, tokens/s, peak device memory, init seconds; (b) its
     first 2 layers card vs CPU, 2 x 256, in bf16 and in f32: every
     gradient within phase 6's limit in both (the embed, with no path to
     the loss, zero), the f32 loss within phase 6's limit and the bf16
     loss gap reported beside each side's distance to the f32 loss, a
     planted fault (the mask ignored on the card); then the whitening
     calibration on the same batch within phase 5c's limits, with its
     planted fault. internvl2-76b at full width with
     the depth cut (152 GB of bf16 at its 80 layers), params drawn on
     the card: (c) 4 layers, 4 rows of 256 patches and 64 or 256 prompt
     tokens through one ``lm.prefill`` each (B2 over two T-chunks), then
     32 greedy ``lm.decode_step`` calls (B1) under
     ``set_sync_debug_mode("error")``: B2 = prefill calls x layers, B1 =
     decode steps x layers, ``pos`` 256 + prompt (+ steps); prefill ms
     and TPOT; (e) its first 2 layers card vs CPU, one row of 256
     patches and 32 tokens, prefill then 8 decode steps, with a planted
     fault (the patches dropped on the card); (d) 1 layer trained
     through ``launch.steps.make_train_step`` with AdamW's factored
     second moment (4 rows of 256 patches and 256 tokens, 3 steps): B5 =
     steps x 2 (the layer and its recompute) and no other launch, losses
     finite, step ms, peak memory;
  12. training at scale, smollm-135m at full width, 8 x 512, remat
     "dots": (a) the train launcher under the supervisor
     (``--ckpt-dir``, ``--ckpt-every 4``) for 12 steps, clean, again
     without the supervisor (two clean runs: the determinism gauge),
     with ``--simulate-failure-at 6`` (restored from step 3's
     checkpoint, steps 4 and 5 rerun: 14 steps), then ``--steps 16`` on
     the clean directory (resumes at step 12, 4 steps): final params and
     AdamW state and every logged metric after the restart equal to the
     clean run's (bitwise where the two clean runs are), the checkpoints
     kept, B5 = 60 x steps run; (b) one batch under remat none, full and
     dots (and none again): loss and every gradient equal, the peak
     memory falling from none to dots to full, ms and B5 of each; (c) a
     single-rank NCCL group and ``make_local_mesh(1, 1)``: two sharded
     steps (DTensor params and state) equal to two plain ones,
     ``compressed_psum_mean`` none, bf16 and int8 equal to their
     arithmetic, ``restore_to_shardings`` of (a)'s step-11 checkpoint
     equal to the clean run's state; (d) the serving half on its own
     single-rank NCCL group: 8 requests (smollm-135m, B1/B2) through an
     overlapped engine given ``make_local_mesh(1, 1)`` and through one
     without it, greedy streams bitwise equal, B1 and B2 launches
     equal, every pool leaf a DTensor with ``serve_state_specs``'
     placements; phase 3e's traffic at ``prefill_rows=1`` through a
     cache-on engine on the mesh whose snapshots are demoted to the
     host before it, forks served by the mesh-aware promotion, streams
     equal to a cache-less engine's; each part with its seconds; (e) on
     (c)'s group, the ZeRO-3 step (params, gradients and AdamW state as
     shards, each leaf gathered where the model uses it) against the
     plain step, 4 steps each: the first two equal to (c)'s plain ones
     (bitwise where (c)'s two plain runs are), ms a step, peak memory,
     gathers a step (2 x 30 layers x 7 sharded leaves + the tied
     embedding twice) and B5 = 60 a step on both (on a one-rank
     ``model`` axis this is also the TP train step, which computes
     whole there); (f) on (c)'s group, tensor parallelism over
     ``model`` with its branches forced onto the one rank (the test
     seam ``tensor_parallel._MIN_RANKS`` = 1): smollm-135m's TP train
     step, 4 steps, its step-0 loss bitwise (e)'s plain one and step
     0's gradients within a stated limit, an f32 witness of the same
     comparison held tighter, two controls that must fail the limits,
     nothing gathered over ``model``. A one-rank axis cannot show a
     missing ``model`` sum or a wrong group slice: tensor parallelism's
     correctness rests on the gloo tests (tests/test_torch_tp.py);
     granite-8b at full depth and width through a mesh
     engine with the branches on, greedy streams bitwise an engine's
     without a mesh, B1 and B2 launches equal, its resident bytes; B1,
     B2 and B5 against their plain versions at the per-rank head
     layouts tensor parallelism gives the configs a card cannot hold
     (one KV group a rank);
  13. the reference's two examples in the port on the card:
     ``examples/torch_quickstart.py`` (60 steps, then prefill and 12
     greedy decode steps; the loss at step 59 below step 0's) and
     ``examples/torch_long_context_serving.py`` (contexts 1 024, 8 192,
     65 536: the PRF state's bytes equal, the KV cache's linear), each
     kernel's launches and the seconds of each.
Then the kernels line (all seven kernels: launches on their path, max
error, time and device time, prf_fused_decode's and prf_decode_step's
cold beside their warm ones, plain time,
bound: bytes at 3.35 TB/s or operations at 67 TFLOP/s of f32, for
linear_attention_causal, linear_attention_carry and prf_featmap, which
run on the tensor cores, at 495 TFLOP/s of TF32; B1's and B2's launches
in phase 3e's, each phase 7 model's and phase 8's serving run beside,
and every kernel's in phase 9's training and serving, in phase 10, in
phase 10b, in phase 11 by arch, in phase 12, ``launches_runtime``, in
phase 12 (f)'s checks at the per-rank geometries,
``launches_tp_geometry``, and in phase 13, ``launches_examples``)
and, last, the
``{"ok": true, ...}`` line. Exits non-zero, without that line, when there is no CUDA device
or any phase fails. Imports neither JAX nor the reference package.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS = 67e12               # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12             # H100 SXM TF32 on the tensor cores, dense
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
# phase 5c, the whitening calibration: max |M Lambda M^T - I| over every
# (layer, group), Lambda recomputed in f64 from the taps the pass read;
# and, card vs CPU at 4 layers, bf16, the largest gap in Sigma = M^T M
# over max |Sigma| of a (layer, group). Sound readings on an H100: 4.8e-6
# and 1.4e-3 (bf16 against f32 taps on the CPU: up to 2.8e-3); the
# planted fault (each layer calibrated from the next layer's taps): 0.17
# at its least
WHITEN_TOL = 1e-3
CAL_SIGMA_TOL = 0.02
B, L_TRAIN = 8, 512             # phase 5 batch: 8 sequences of 512 tokens
# the engine's readback counters, reported by the serving phases
PIPELINE_STATS = ("decode_stall_ms_p50", "decode_stall_ms_p99",
                  "decode_stall_ms_max", "dispatch_depth_mean",
                  "dispatch_depth_max")


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


def kernel_times(torch, fn, iters):
    """A kernel's time per call with CUDA events (:func:`time_ms`: the
    host's launch path included, as the main path pays it) and its
    device time per call: the union of the device intervals (kernels and
    copies) of ``iters`` profiled calls, over ``iters`` (None if the
    profiler saw none). Where device_ms is well below ms, the host's
    launch path, not the kernel, sets the pace."""
    from torch.profiler import ProfilerActivity, profile

    ms = time_ms(torch, fn, iters)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    busy, end = 0.0, None
    for t0, t1 in sorted((e.time_range.start, e.time_range.end)
                         for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA):
        if end is None or t0 >= end:
            busy, end = busy + t1 - t0, t1
        elif t1 > end:
            busy, end = busy + t1 - end, t1
    return {"ms": ms, "device_ms": busy / 1e3 / iters if end else None}


def device_ms_by_kernel(torch, fn, iters):
    """Device ms per call of each kernel (and copy or memset) that ``fn``
    launches: the profiler's device intervals of ``iters`` calls, after
    one unprofiled call, summed by the kernel's unqualified name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ms = collections.defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name.split("(")[0].split("<")[0].split("::")[-1]
            ms[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {n: t / iters for n, t in sorted(ms.items())}


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def lin_attn_flops(rows, kv_rows, l, m, dv, chunk=64):
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


def bound(byte_count, flops, peak=F32_FLOPS):
    t_bytes = byte_count / HBM_BYTES_PER_S
    t_ops = flops / peak
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
    """Phase 2: the fused serving kernels vs their plain versions;
    returns the worst error per kernel."""
    from repro_torch.kernels import check as kc

    state = (5, 6, 7)                  # s, z, c of make_inputs' list
    err = {"prf_fused_decode": 0.0, "prf_fused_prefill": 0.0}
    geos = {"smollm-135m": (8, 3, 3, 64, 256, 64),
            "darkformer-2b": (4, 1, 8, 256, 256, 256)}
    cases = []
    for gname, (b, g, hg, d, m, dv) in geos.items():
        for (dark, stab), dt in itertools.product(
                ((True, True), (True, False), (False, True)),
                (torch.float32, torch.bfloat16)):
            name = (f"decode {gname} dark={dark} stabilize={stab} "
                    f"{str(dt).split('.')[-1]}")
            args = kc.make_inputs(dev, b, g, hg, d, m, dv, None, dark,
                                  seed=len(cases), dtype=dt)
            e = kc.check_case(name, lambda: kd.launches,
                              kd.fused_prf_decode, kd.prf_fused_decode_plain,
                              args, state, stabilize=stab)
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
            e = kc.check_case(name, lambda: kp.launches,
                              kp.fused_prf_prefill,
                              kp.prf_fused_prefill_plain, args, state, vlt,
                              stabilize=stab)
            err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
            cases.append({"case": name, "max_abs_err": e})
    # the main path's shapes and input type: smollm-135m, bf16, at 8 slots
    # and at the active-slot counts the engine decodes when slots are idle
    for b in (8, 1, 2, 5):
        name = f"decode main-path bf16 B={b}"
        args = kc.make_inputs(dev, b, 3, 3, 64, 256, 64, None, True,
                              seed=100 + b, dtype=torch.bfloat16)
        e = kc.check_case(name, lambda: kd.launches, kd.fused_prf_decode,
                          kd.prf_fused_decode_plain, args, state, eps=1e-8)
        err["prf_fused_decode"] = max(err["prf_fused_decode"], e)
        cases.append({"case": name, "max_abs_err": e})
    # the packer's grants (8 x 32, 4 x 64, 2 x 128, 1 x 256), ragged rows,
    # and L = 300: a second, partial T-chunk
    for b, l, vl in ((8, 32, [32] * 8),
                     (8, 256, [256, 200, 17, 1, 0, 0, 0, 0]),
                     (4, 64, [64, 1, 0, 40]), (2, 128, [128, 1]),
                     (1, 256, [256]), (4, 300, [300, 0, 257, 1])):
        name = f"prefill main-path bf16 B={b} L={l} valid_len={vl}"
        args = kc.make_inputs(dev, b, 3, 3, 64, 256, 64, l, True,
                              seed=101 + l, dtype=torch.bfloat16)
        vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
        e = kc.check_case(name, lambda: kp.launches, kp.fused_prf_prefill,
                          kp.prf_fused_prefill_plain, args, state, vlt,
                          eps=1e-8)
        err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
        cases.append({"case": name, "max_abs_err": e})
    # phase 7's, 8's and 11's head layouts (G, Hg, d_head, m), read from
    # their configs, at their input type: B1 at 8 slots, B2 at each of
    # the packer's grants (hubert-xlarge's d_head 80 on no path: its
    # encoder runs no kernel)
    from repro_torch import configs
    for arch in [a for a, _, _ in HOMOGENEOUS] + [RECURRENT, VLM, HUBERT]:
        c = configs.get_config(arch)
        g, hg, d, m = (c.n_kv, c.n_heads // c.n_kv, c.head_dim,
                       c.attn.num_features)
        geo = f"{arch} G={g} Hg={hg} d={d} m={m}"
        args = kc.make_inputs(dev, 8, g, hg, d, m, d, None, True,
                              seed=200 + len(cases), dtype=torch.bfloat16)
        e = kc.check_case(f"decode {geo} bf16 B=8", lambda: kd.launches,
                          kd.fused_prf_decode, kd.prf_fused_decode_plain,
                          args, state, eps=1e-8)
        err["prf_fused_decode"] = max(err["prf_fused_decode"], e)
        cases.append({"case": f"decode {geo} bf16 B=8", "max_abs_err": e})
        for b, l, vl in kc.PACKER_GRANTS:
            name = f"prefill {geo} bf16 B={b} L={l} valid_len={list(vl)}"
            args = kc.make_inputs(dev, b, g, hg, d, m, d, l, True,
                                  seed=200 + len(cases),
                                  dtype=torch.bfloat16)
            vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
            e = kc.check_case(name, lambda: kp.launches,
                              kp.fused_prf_prefill,
                              kp.prf_fused_prefill_plain, args, state, vlt,
                              eps=1e-8)
            err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
            cases.append({"case": name, "max_abs_err": e})
    # phase 11 (c)'s calls: internvl2-76b's whole VLM prompts in one B2
    # call, 256 patches and each prompt: two 256-token T-chunks
    c = configs.get_config(VLM)
    for l in (c.num_patches + n for n in VLM_PROMPTS):
        name = f"prefill {VLM} bf16 B={VLM_ROWS} L={l}"
        args = kc.make_inputs(dev, VLM_ROWS, c.n_kv, c.n_heads // c.n_kv,
                              c.head_dim, c.attn.num_features, c.head_dim,
                              l, True, seed=300 + l, dtype=torch.bfloat16)
        e = kc.check_case(name, lambda: kp.launches, kp.fused_prf_prefill,
                          kp.prf_fused_prefill_plain, args, state, eps=1e-8)
        err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
        cases.append({"case": name, "max_abs_err": e})
    emit({"phase": "kernels_vs_plain", "tolerance_f32": kc.F32_TOL,
          "tolerance_bf16_out": kc.BF16_OUT_TOL, "cases": cases})
    return err


def phase_timing(torch, dev, kd, kp):
    """Phase 2b: kernel and plain times at the smollm-135m serving shape
    (B1 at 8 slots, cold and warm L2: :func:`decode_row_timing`; B2 at
    each of the packer's grants for chunk_tokens=256: 8 rows of 32
    tokens, 4 x 64, 2 x 128 and 1 x 256), with the bound of each."""
    out = {"prf_fused_decode": decode_row_timing(torch, dev, kd, 8)}
    out.update(prefill_grant_timing(torch, dev, kp))
    emit({"phase": "kernel_timing", **out})
    return out


# S that B1's cold timing rotates over at least: twice the H100's 50 MB L2
COLD_S_BYTES = 100e6
DECODE_POOLS = 30               # smollm-135m's layers: a decode step's pools


def cold_pools(args, s):
    """``args`` and independent copies of it: 30, one for each of a
    decode step's layers, or as many as hold COLD_S_BYTES of ``s``."""
    from repro_torch.kernels import check as kc

    n = max(DECODE_POOLS, math.ceil(COLD_S_BYTES / nbytes(s)))
    return [args] + [kc.clone(args) for _ in range(n - 1)]


def cold_warm_times(torch, call, pools):
    """:func:`kernel_times` of ``call(args)``, 200 calls each way: cold
    (``ms``, ``device_ms``), one call per pool in turn, so each call
    finds its S in device memory, as a decode step over 30 layers'
    8-slot pools (141 MB) does; warm (``ms_warm``, ``device_ms_warm``),
    on the first pool, whose S stays in the 50 MB L2."""
    turn = itertools.cycle(pools)
    cold = kernel_times(torch, lambda: call(next(turn)), 200)
    warm = kernel_times(torch, lambda: call(pools[0]), 200)
    return {**cold, "ms_warm": warm["ms"], "device_ms_warm": warm["device_ms"],
            "cold_pools": len(pools)}


def decode_pools(torch, dev, b):
    """:func:`cold_pools` of one B1 call's inputs at ``b`` active slots of
    smollm-135m (bf16 q/k/v, f32 state)."""
    from repro_torch.kernels import check as kc

    args = kc.make_inputs(dev, b, 3, 3, 64, 256, 64, None, True, seed=7,
                          dtype=torch.bfloat16)
    return cold_pools(args, args[5])


def decode_row_timing(torch, dev, kd, b):
    """B1 timed at ``b`` active slots of smollm-135m (bf16 q/k/v, f32
    state), cold and warm (:func:`cold_warm_times` over
    :func:`decode_pools`), beside its plain version (warm) and its bound:
    bytes of the inputs, S, z and c in and out, and the output;
    operations of the features and the state update."""
    g, hg, d, m, dv = 3, 3, 64, 256, 64
    pools = decode_pools(torch, dev, b)
    args = pools[0]
    q, k, v, a, mm, s, z, c = args
    byts = nbytes(q, k, v, a, mm) + 2 * nbytes(s, z, c) + \
        b * g * hg * dv * 4
    flops = (feature_flops(b * g * hg, b * g, d, d, m, True)
             + b * g * hg * (4 * m * dv + 4 * m))
    bms, by = bound(byts, flops)
    return {
        "shape": f"B={b} G={g} Hg={hg} d={d} m={m} dv={dv} bf16",
        **cold_warm_times(
            torch, lambda a: kd.fused_prf_decode(*a, eps=1e-8), pools),
        "plain_ms": time_ms(torch, lambda: kd.prf_fused_decode_plain(
            *args, eps=1e-8), 50),
        "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}


def decode_step_pools(torch, dev, b, g=3, hg=3, dv=64):
    """:func:`cold_pools` of one B3 call's inputs (qf, kf, v, s, z, ρ) at
    ``b`` active slots (smollm-135m's heads unless ``g``, ``hg``, ``dv``
    say otherwise; m 256, bf16 v as the serving path passes it, the rest
    f32)."""
    from repro_torch.kernels import check as kc

    args = kc.make_decode_step_inputs(dev, b, g, hg, 256, dv, seed=13)
    args[2] = args[2].to(torch.bfloat16)
    return cold_pools(args, args[3])


def decode_step_timing(torch, dev, kds, b, g=3, hg=3, dv=64, call=None):
    """B3 timed at ``b`` active slots, cold and warm
    (:func:`cold_warm_times` over :func:`decode_step_pools`), beside its
    plain version (warm) and its bound: bytes of qf, kf, v and ρ, S and z
    in and out, and the output; operations of the state update and the
    readout. ``call(args)`` makes one call (the wrapper by default)."""
    call = call or (lambda a: kds.linear_attention_decode_step(*a, eps=1e-8))
    pools = decode_step_pools(torch, dev, b, g, hg, dv)
    args = pools[0]
    qf, kf_, v, s, z, rho = args
    m, rows = qf.shape[-1], qf.numel() // qf.shape[-1]
    byts = nbytes(qf, kf_, v, rho) + 2 * nbytes(s, z) + rows * dv * 4
    flops = rows * (4 * m * dv + 4 * m + dv)
    bms, by = bound(byts, flops)
    return {
        "shape": f"B={b} G={g} Hg={hg} m={m} dv={dv} v=bf16",
        **cold_warm_times(torch, call, pools),
        "plain_ms": time_ms(torch, lambda: kds.prf_decode_step_plain(
            *args, eps=1e-8), 50),
        "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}


# the packer's grants at chunk_tokens=256 (rows x tokens; B2's calls in
# phase 3): "prf_fused_prefill" is the 8 x 32 one
GRANTS = ((8, 32), (4, 64), (2, 128), (1, 256))


def prefill_grant_timing(torch, dev, kp):
    """B2 timed (CUDA events and device time) at each of the packer's
    grant shapes for smollm-135m (bf16 q/k/v, all rows full), beside its
    plain version and its bound: operations of the features and of the
    token-serial scan, bytes of the inputs, S, z and c in and out, and
    the output. Keys: "prf_fused_prefill" for 8 x 32, then
    "prf_fused_prefill_<B>x<L>"."""
    from repro_torch.kernels import check as kc

    g, hg, d, m, dv = 3, 3, 64, 256, 64
    out = {}
    for b, l in GRANTS:
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
        key = ("prf_fused_prefill" if (b, l) == GRANTS[0]
               else f"prf_fused_prefill_{b}x{l}")
        out[key] = {
            "shape": f"B={b} L={l} G={g} Hg={hg} d={d} m={m} dv={dv} bf16",
            **kernel_times(torch, lambda: kp.fused_prf_prefill(
                *args, vl, eps=1e-8), 50),
            "plain_ms": time_ms(torch, lambda: kp.prf_fused_prefill_plain(
                *args, vl, eps=1e-8), 20),
            "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}
    return out


def serve(torch, dev, cfg, params, counters, shapes=None,
          shaped="fused_prf_prefill", overlap=False, requests=16,
          prompt_range=(64, 512), gen_range=(32, 64)):
    """The 16 requests of the serving phases (prompts of 64-512 tokens,
    32-64 new ones, 8 slots, chunk_tokens 256; phase 7 asks for other
    counts and lengths) through the port's ``ServingEngine``, after a
    short warm-up engine (cuBLAS, allocator, libraries). Every count of
    ``counters`` is set to 0 just before the run and read just after;
    ``shapes``, a Counter, gets one count per call of the prefill kernel
    ``shaped`` (B2's wrapper, or B4's) in the run under its
    "<rows>x<tokens>". ``overlap`` selects the overlapped
    scheduler and runs it under ``set_sync_debug_mode("error")``: a
    synchronising call anywhere in its steps raises (retire's wait is an
    event's, which the mode does not count). Returns (the phase's JSON
    fields, the launches, each request's tokens in submission order,
    engine stats)."""
    import contextlib
    from unittest import mock
    from repro_torch import kernels as kops
    from repro_torch.serving import ServingEngine, synthetic_requests

    def engine():
        return ServingEngine(params, cfg, max_slots=8, max_len=1024,
                             chunk_tokens=256, seed=0, overlap=overlap,
                             device=dev)
    warm = engine()
    for r in synthetic_requests(2, cfg.vocab, seed=1, prompt_range=(8, 40),
                                gen_range=(2, 4)):
        warm.submit(r)
    warm.run()
    del warm

    eng = engine()
    reqs = synthetic_requests(requests, cfg.vocab, seed=0,
                              prompt_range=prompt_range,
                              gen_range=gen_range)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    record = contextlib.nullcontext()
    if shapes is not None:
        prefill = getattr(kops, shaped)

        def counted(q, *args, **kw):
            shapes[f"{q.shape[0]}x{q.shape[3]}"] += 1
            return prefill(q, *args, **kw)
        record = mock.patch.object(kops, shaped, counted)
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    with record:
        t0 = time.perf_counter()
        if overlap:
            torch.cuda.set_sync_debug_mode("error")
        try:
            results = eng.run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    st = eng.stats
    by_uid = {r.uid: r for r in results}
    got = {r.uid: len(by_uid[r.uid].tokens) if r.uid in by_uid else 0
           for r in reqs}
    want = {r.uid: r.max_new_tokens for r in reqs}
    if got != want:
        fail(f"serving: tokens per request {got}, expected {want}")
    tpots = [t for r in results for t in r.tpots]
    ttfts = [r.ttft for r in results]
    fields = {
        "config": cfg.name, "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "n_heads": cfg.n_heads, "n_kv": cfg.n_kv, "d_head": cfg.head_dim,
        "num_features": cfg.attn.num_features, "vocab": cfg.vocab,
        "dtype": cfg.dtype, "slots": 8, "max_len": 1024, "chunk_tokens": 256,
        "requests": len(reqs), "wall_s": wall,
        "emitted_tokens": st["emitted_tokens"],
        "throughput_tok_s": st["emitted_tokens"] / wall,
        "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
        "tpot_p50_ms": float(np.percentile(tpots, 50)) * 1e3,
        "tpot_p99_ms": float(np.percentile(tpots, 99)) * 1e3,
        "prefill_calls": st["prefill_calls"],
        "decode_steps": st["decode_steps"], "launches": launches,
        "prefill_path": st["prefill_path"], "decode_path": st["decode_path"],
        "overlap": st["overlap"],
        **{k: st[k] for k in PIPELINE_STATS if k in st},
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    return fields, launches, [by_uid[r.uid].tokens for r in reqs], st


def attn_layers(cfg) -> int:
    """The layers with attention: every layer but the RG-LRU's."""
    return sum(kind != "rec" for kind in cfg.layer_kinds())


def b5_per_step(cfg) -> int:
    """B5's launches in one training forward and backward of ``cfg``
    (``lm.forward_train``): once a causal PRF attention layer, and once
    more in the backward's recompute of each such layer that lies in a
    unit of ``len(block_pattern)`` layers under remat "full" or "dots"
    (the remainder layers run unwrapped). The no-gradient passes
    (calibration, eval) launch once a layer."""
    k = len(cfg.block_pattern)
    return sum((2 if cfg.remat != "none" and li < cfg.n_units * k else 1)
               for li, kind in enumerate(cfg.layer_kinds())
               if kind != "rec")


def fused_launches(counters, st, cfg) -> dict:
    """The launches a run through the fused serving kernels must count:
    B2 once an attention layer a prefill call, B1 once an attention
    layer a decode step, no other kernel."""
    want = {n: 0 for n in counters}
    want["prf_fused_prefill"] = st["prefill_calls"] * attn_layers(cfg)
    want["prf_fused_decode"] = st["decode_steps"] * attn_layers(cfg)
    return want


def phase_main_path(torch, dev, counters):
    """Phase 3: smollm-135m at full width served through the fused
    kernels. Returns (cfg, params, launches, the token streams, the
    phase's JSON fields)."""
    from repro_torch import configs
    from repro_torch.models import lm

    cfg = configs.get_config("smollm-135m", use_kernel=True)
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev)
    init_s = time.perf_counter() - t0
    shapes = collections.Counter()
    fields, launches, streams, st = serve(torch, dev, cfg, params, counters,
                                          shapes)
    emit({"phase": "main_path", **fields, "param_init_s": init_s,
          "launches_per_prefill_call":
              launches["prf_fused_prefill"] / st["prefill_calls"],
          "launches_per_decode_step":
              launches["prf_fused_decode"] / st["decode_steps"],
          "prefill_call_shapes": dict(sorted(shapes.items()))})
    if st["prefill_path"] != "fused_kernel" or \
            st["decode_path"] != "fused_kernel":
        fail(f"main path ran {st['prefill_path']}/{st['decode_path']}")
    want = fused_launches(counters, st, cfg)
    if launches != want:
        fail(f"main path: launches {launches}, expected {want} (prefill "
             f"calls and decode steps x {cfg.n_layers} layers)")
    if sum(shapes.values()) != want["prf_fused_prefill"]:
        fail(f"main path: B2 call shapes {dict(shapes)} do not add up to "
             f"its {want['prf_fused_prefill']} launches")
    return cfg, params, launches, streams, fields


def phase_two_stage_serve(torch, dev, cfg, params, counters, main):
    """Phase 3b: phase 3's traffic again with the LM's serve entry points
    pinned to ``fused=False`` (the reference's ``two_stage_kernel`` rung,
    benchmarks/serve_faults.py): every layer runs the plain feature map,
    then B4 per prefill call and B3 per decode step. The engine still
    labels its paths ``fused_kernel``, as the reference's does under that
    pin, so the launch counts are the evidence. Returns the launches."""
    import functools
    from unittest import mock
    from repro_torch.models import lm

    shapes = collections.Counter()
    with mock.patch.multiple(
            lm, prefill_chunk=functools.partial(lm.prefill_chunk,
                                                fused=False),
            decode_step=functools.partial(lm.decode_step, fused=False)):
        fields, launches, two, st = serve(
            torch, dev, cfg, params, counters, shapes,
            shaped="linear_attention_prefill_chunk")
    streams, main_fields = main
    same = [a == b for s1, s2 in zip(streams, two) for a, b in zip(s1, s2)]
    emit({"phase": "two_stage_serve", **fields,
          "main_path": {k: main_fields[k] for k in (
              "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms",
              "tpot_p99_ms")},
          "greedy_tokens_equal_to_main_path": sum(same) / len(same),
          "prefill_call_shapes": dict(sorted(shapes.items()))})
    want = {n: 0 for n in counters}
    want["linear_attention_carry"] = st["prefill_calls"] * cfg.n_layers
    want["prf_decode_step"] = st["decode_steps"] * cfg.n_layers
    if launches != want:
        fail(f"two-stage serve: launches {launches}, expected {want} "
             f"(prefill calls and decode steps x {cfg.n_layers} layers)")
    if sum(shapes.values()) != want["linear_attention_carry"]:
        fail(f"two-stage serve: B4 call shapes {dict(shapes)} do not add "
             f"up to its {want['linear_attention_carry']} launches")
    return launches


def phase_overlap_serve(torch, dev, cfg, params, counters, main):
    """Phase 3c: phase 3's traffic through the overlapped scheduler, no
    synchronising call in its steps but retire's event wait; then the
    sequential and overlapped engines on 8 requests with one staged row
    per prefill call, whose greedy streams must be equal. Returns the
    launches."""
    fields, launches, ovl, st = serve(torch, dev, cfg, params, counters,
                                      overlap=True)
    streams, main_fields = main
    same = [a == b for s1, s2 in zip(streams, ovl) for a, b in zip(s1, s2)]
    want = fused_launches(counters, st, cfg)
    equal, eq_fields = overlap_equality(torch, dev, cfg, params)
    emit({"phase": "overlap_serve", **fields,
          "pack_fence_waits": st["pack_fence_waits"],
          "main_path": {k: main_fields[k] for k in (
              "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms",
              "tpot_p99_ms", *PIPELINE_STATS) if k in main_fields},
          "greedy_tokens_equal_to_main_path": sum(same) / len(same),
          "rows_1_equality": eq_fields})
    if st["prefill_path"] != "fused_kernel" or \
            st["decode_path"] != "fused_kernel":
        fail(f"overlapped serve ran {st['prefill_path']}/"
             f"{st['decode_path']}")
    if launches != want:
        fail(f"overlapped serve: launches {launches}, expected {want} "
             f"(prefill calls and decode steps x {cfg.n_layers} layers)")
    if not st["dispatch_depth_max"] >= 1:
        fail(f"overlapped serve: dispatch depth max "
             f"{st['dispatch_depth_max']}, expected >= 1")
    if not equal:
        fail(f"overlapped serve: greedy streams differ from the sequential "
             f"engine's with one staged row per prefill call "
             f"({eq_fields})")
    return launches, fields


def overlap_equality(torch, dev, cfg, params):
    """8 requests (prompts of 64-256 tokens, 16-32 new, all at 0) through
    a sequential and an overlapped engine with ``prefill_rows=1`` and
    chunk_tokens 256: every grant is min(remaining, 256) in both, so the
    chunk boundaries agree and, rows being elementwise over the batch,
    the greedy streams must be equal. Returns (equal, JSON fields)."""
    from repro_torch.serving import ServingEngine, synthetic_requests

    streams = []
    for overlap in (False, True):
        eng = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                            chunk_tokens=256, prefill_rows=1, seed=0,
                            overlap=overlap, device=dev)
        reqs = synthetic_requests(8, cfg.vocab, seed=3,
                                  prompt_range=(64, 256),
                                  gen_range=(16, 32))
        for r in reqs:
            eng.submit(r)
        by_uid = {r.uid: r.tokens for r in eng.run()}
        streams.append([by_uid[r.uid] for r in reqs])
    same = [a == b for s1, s2 in zip(*streams) for a, b in zip(s1, s2)]
    first = next((j for j, (a, b) in enumerate(zip(*streams)) if a != b),
                 None)
    return streams[0] == streams[1], {
        "requests": 8, "tokens": len(same),
        "tokens_equal": sum(same) / len(same),
        "first_differing_request": first}


def phase_exact_serve(torch, dev, counters, ovl_fields):
    """Phase 3d: phase 3's traffic through an exact smollm-135m at full
    width, served by the overlapped scheduler under sync-debug mode; then
    the ``prefill_rows=1`` equality of phase 3c. None of the seven
    kernels may launch in the phase. Returns (cfg, params)."""
    from repro_torch import configs
    from repro_torch.models import lm

    t0 = time.perf_counter()
    cfg = configs.darkify(configs.get_config("smollm-135m", use_kernel=True),
                          "exact")
    params = lm.init_params(cfg, seed=0, device=dev)
    fields, launches, _, st = serve(torch, dev, cfg, params, counters,
                                    overlap=True)
    # the equality runs count too: nothing in the phase may launch
    equal, eq_fields = overlap_equality(torch, dev, cfg, params)
    phase_launches = {n: getattr(mod, attr)
                      for n, (mod, attr) in counters.items()}
    emit({"phase": "exact_serve", **fields,
          "overlap_serve": {k: ovl_fields[k] for k in (
              "throughput_tok_s", "ttft_p50_ms", "tpot_p50_ms",
              "tpot_p99_ms", *PIPELINE_STATS) if k in ovl_fields},
          "launches_with_equality_runs": phase_launches,
          "rows_1_equality": eq_fields,
          "seconds": time.perf_counter() - t0})
    if st["prefill_path"] != "exact" or st["decode_path"] != "exact":
        fail(f"exact serve ran {st['prefill_path']}/{st['decode_path']}")
    if any(launches.values()) or any(phase_launches.values()):
        fail(f"exact serve launched kernels: {phase_launches}")
    if not equal:
        fail(f"exact serve: greedy streams differ between the schedulers "
             f"with one staged row per prefill call ({eq_fields})")
    return cfg, params


# phase 3e's traffic: a burst (no arrival rate) of system-prompt
# requests over two shared prefixes, suffixes of 16-128 tokens
PREFIX_TRAFFIC = dict(seed=0, prefix_len=256, n_prefixes=2, reuse=0.8,
                      suffix_range=(16, 128), gen_range=(16, 32))
# the engine's prefix-cache counters, read as increments over a run
PREFIX_STATS = ("prefill_calls", "decode_steps", "prefill_tokens",
                "emitted_tokens", "forked_requests", "forked_tokens",
                "prefix_hits", "prefix_misses", "prefix_captures",
                "prefix_demotions", "prefix_promotions", "prefix_evictions")


def prefix_serve(torch, dev, cfg, params, counters, cache, rows=None):
    """Phase 3e's 16 requests through an overlapped engine (8 slots,
    max_len 1024, chunk_tokens 256, ``prefill_rows`` ``rows``, the prefix
    cache ``cache`` or none) under ``set_sync_debug_mode("error")``,
    after a primer of each shared prefix plus three tokens (the
    cache-less engine serves it too, as its warm-up). Every count of
    ``counters`` is set to 0 just before the run and read just after.
    Returns (JSON fields, launches, streams in submission order, the
    stats at the end, their increments over the run)."""
    from repro_torch.serving import (Request, ServingEngine,
                                     shared_prefix_requests)

    eng = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                        chunk_tokens=256, prefill_rows=rows, seed=0,
                        overlap=True, prefix_cache=cache, device=dev)
    reqs = shared_prefix_requests(16, cfg.vocab, **PREFIX_TRAFFIC)
    n_lead = collections.Counter(tuple(r.prompt[:256]) for r in reqs)
    for lead, n in n_lead.items():
        if n > 1:
            eng.submit(Request(prompt=list(lead) + [1, 2, 3],
                               max_new_tokens=2))
    eng.run()
    before = dict(eng.stats)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        results = eng.run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    st = eng.stats
    delta = {k: st[k] - before.get(k, 0) for k in PREFIX_STATS if k in st}
    by_uid = {r.uid: r for r in results}
    got = {r.uid: len(by_uid[r.uid].tokens) if r.uid in by_uid else 0
           for r in reqs}
    want = {r.uid: r.max_new_tokens for r in reqs}
    if got != want:
        fail(f"prefix-cache serving: tokens per request {got}, expected "
             f"{want}")
    ttfts = [by_uid[r.uid].ttft for r in reqs]
    tpots = [t for r in reqs for t in by_uid[r.uid].tpots]
    fields = {
        "prefix_cache": cache is not None, "prefill_rows": rows,
        "wall_s": wall, "throughput_tok_s": delta["emitted_tokens"] / wall,
        "ttft_p50_ms": float(np.percentile(ttfts, 50)) * 1e3,
        "tpot_p50_ms": float(np.percentile(tpots, 50)) * 1e3,
        "prompt_tokens": sum(len(r.prompt) for r in reqs),
        **delta, "launches": launches,
        "prefill_path": st["prefill_path"], "decode_path": st["decode_path"],
        **{k: st[k] for k in ("prefix_device_bytes", "prefix_host_bytes",
                              "prefix_entries", "kv_pages_total",
                              "kv_pages_free") if k in st}}
    return fields, launches, [by_uid[r.uid].tokens for r in reqs], st, delta


def phase_prefix_cache(torch, dev, counters, cfg, params, cfg_e, params_e):
    """Phase 3e: phase 3's model, then phase 3d's exact one, serving the
    system-prompt traffic with and without the prefix cache (module
    docstring). Returns B1's and B2's launches in (a)."""
    from repro_torch.serving import PrefixCacheConfig

    t0 = time.perf_counter()
    for kind, c, p in (("darkformer", cfg, params),
                       ("exact", cfg_e, params_e)):
        path = "exact_paged" if kind == "exact" else "fused_kernel"
        runs = {(cache, rows): prefix_serve(
                    torch, dev, c, p, counters,
                    PrefixCacheConfig() if cache else None, rows)
                for cache in (True, False) for rows in (None, 1)}
        on, launches, _, st, d = runs[True, None]
        s_on, s_off = runs[True, 1][2], runs[False, 1][2]
        same = [a == b for x, y in zip(s_on, s_off) for a, b in zip(x, y)]
        first = next((j for j, (x, y) in enumerate(zip(s_on, s_off))
                      if x != y), None)
        emit({"phase": "prefix_cache_serve", "kind": kind,
              "config": c.name, "slots": 8, "max_len": 1024,
              "chunk_tokens": 256, "traffic": PREFIX_TRAFFIC,
              "requests": 16, "prefill_tokens_saved": d["forked_tokens"],
              "cache_on": on, "cache_off": runs[False, None][0],
              "rows_1": {"cache_on": runs[True, 1][0],
                         "cache_off": runs[False, 1][0],
                         "tokens": len(same),
                         "tokens_equal": sum(same) / len(same),
                         "first_differing_request": first},
              "seconds": time.perf_counter() - t0})
        if st["prefill_path"] != path or st["decode_path"] != path:
            fail(f"prefix-cache serve ({kind}) ran {st['prefill_path']}/"
                 f"{st['decode_path']}, expected {path}")
        if d["forked_requests"] < 1 or d["prefix_hits"] < 1 \
                or runs[True, 1][4]["forked_requests"] < 1:
            fail(f"prefix-cache serve ({kind}): no fork")
        if d["prefill_tokens"] + d["forked_tokens"] != on["prompt_tokens"]:
            fail(f"prefix-cache serve ({kind}): {d['prefill_tokens']} "
                 f"prefilled + {d['forked_tokens']} forked tokens, "
                 f"expected the prompts' {on['prompt_tokens']}")
        if kind == "darkformer" and (d["prefix_demotions"] < 1
                                     or d["prefix_promotions"] < 1):
            fail(f"prefix-cache serve: demotions {d['prefix_demotions']}, "
                 f"promotions {d['prefix_promotions']}, expected >= 1 each")
        for key, (_, got, _, _, dd) in runs.items():
            want = {n: 0 for n in counters}
            if kind == "darkformer":
                want = fused_launches(counters, dd, c)
            if got != want:
                fail(f"prefix-cache serve ({kind}, cache and rows {key}): "
                     f"launches {got}, expected {want}")
        if kind == "darkformer":
            b12 = launches
        if s_on != s_off:
            fail(f"prefix-cache serve ({kind}): greedy streams with the "
                 f"cache differ from the cache-less engine's at "
                 f"prefill_rows=1 ({sum(same)} of {len(same)} tokens "
                 f"equal, first request {first})")
    return b12


def drive(torch, lm, cfg, params, dev, toks, vl, feed=None, proj=None,
          fused=True):
    """One ragged prefill chunk and two decode steps from a fresh state,
    through the fused kernels or (``fused=False``) the two stages. Each
    decode step is fed ``feed[i]``, or the argmax of the logits before
    it. Returns (logits of each step on the CPU, tokens fed, the final
    state on the CPU, in either layout)."""
    from repro_torch.serving import slots as slot_ops
    st = lm.init_serve_state(cfg, b=toks.shape[0], max_len=128,
                             per_slot=True, device=dev)
    logits, st = lm.prefill_chunk(
        params, cfg, {"tokens": torch.tensor(toks, device=dev)}, st,
        valid_len=torch.tensor(vl, device=dev), proj=proj, fused=fused)
    out, fed = [logits.float().cpu()], []
    for i in range(2):
        fed.append(out[-1].argmax(-1) if feed is None else feed[i])
        logits, st = lm.decode_step(params, cfg, fed[-1].to(dev), st,
                                    proj=proj, fused=fused)
        out.append(logits.float().cpu())
    return out, fed, slot_ops.tree_slot_map(lambda t, axis: t.cpu(), st)


def gaps(torch, got, ref):
    """How far run ``got`` is from run ``ref``: the largest |logit| gap
    over max |logit| per step, and over layers the largest gap of S and z
    over max |S|, max |z| of that layer. S and z are compared as S e^c,
    z e^c, since the stabilizer c cancels in the outputs and two devices
    may round it differently."""
    (lg, _, sg), (lr, _, sr) = got, ref
    sg, sr = sg["layers"], sr["layers"]
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


def cross_device(torch, dev, cfg, params, what="cross-device", tap=None):
    """Phase 4's recipe: the card's kernel path vs the CPU's plain path,
    same params, same tokens: one ragged prefill chunk, two decode steps;
    the logits of every step and every layer's final state are compared.
    A planted fault (each layer run with the next layer's projection)
    must fail the same check; ``what`` names the check in a failure.
    ``tap`` (a :class:`RouteTap`) wraps the card's and the CPU's runs.
    Returns (the JSON fields, a function that runs the checks, tokens,
    valid lengths, the card's run, the CPU's run)."""
    from repro_torch.models import lm

    cpu_cfg = dataclasses.replace(cfg, use_kernel=False)
    cpu_params = lm.tree_map(lambda t: t.cpu(), params)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 64))
    vl = np.array([64, 40], np.int32)
    with tap.card(vl) if tap else contextlib.nullcontext():
        card = drive(torch, lm, cfg, params, dev, toks, vl)
    with tap.cpu() if tap else contextlib.nullcontext():
        cpu = drive(torch, lm, cpu_cfg, cpu_params, "cpu", toks, vl,
                    feed=card[1])
    free = None
    if tap:         # the CPU's own routing, for the record
        free = gaps(torch, card, drive(torch, lm, cpu_cfg, cpu_params,
                                       "cpu", toks, vl, feed=card[1]))
    del cpu_params
    shifted = lm.tree_map(lambda t: torch.roll(t, 1, dims=0),
                          lm.build_decode_proj(params, cfg))
    planted = drive(torch, lm, cfg, params, dev, toks, vl, feed=card[1],
                    proj=shifted)
    logit_err, state_err = gaps(torch, card, cpu)
    fault_logit, fault_state = gaps(torch, planted, cpu)
    agree = [float((g.argmax(-1) == c.argmax(-1)).float().mean())
             for g, c in zip(card[0], cpu[0])]
    fields = {"rel_max_err": logit_err,
              "state_rel_err": state_err, "tolerance": CROSS_DEVICE_TOL,
              "state_tolerance": STATE_TOL, "argmax_agreement": agree,
              "planted_fault": {"what": "each layer run with the next "
                                        "layer's projection A, M",
                                "rel_max_err": fault_logit,
                                "state_rel_err": fault_state}}
    if tap:
        fields["routing"] = {**tap.fields(), "cpu_own_routing": {
            "rel_max_err": free[0], "state_rel_err": free[1]}}

    def check():
        if max(logit_err) > CROSS_DEVICE_TOL:
            fail(f"{what} logits differ by {max(logit_err):.3e} of "
                 "max |logit|")
        if state_err > STATE_TOL:
            fail(f"{what} state differs by {state_err:.3e} of its max")
        if max(fault_logit) <= CROSS_DEVICE_TOL and \
                fault_state <= STATE_TOL:
            fail(f"{what} check passes a planted fault")
        if tap and fields["routing"]["moved_beyond_perturbation"]:
            fail(f"{what}: the CPU routes tokens elsewhere than the card "
                 f"beyond the router's perturbation ({fields['routing']})")
    return fields, check, toks, vl, card, cpu


class RouteTap:
    """MoE routing across phase 7 (d)'s card and CPU runs. Router logits
    computed from bf16 activations that differ in their last bits (the
    kernels' sums against the plain path's) move a token's k-th and
    (k+1)-th experts past each other wherever their probabilities lie
    closer than that perturbation, and a moved pair shifts the capacity
    positions, so the drops, of the pairs after it: a discontinuity, not
    a fault. So ``card(valid_len)`` records the routing of every
    ``moe_route`` call of the card's run, and ``cpu()`` gives each call
    of the CPU's run the card's experts, with the capacity positions and
    kept flags computed on the CPU from them (which must equal the
    card's: its cumulative sum is checked at full width) and the gates
    from the CPU's own probabilities at those experts. Where the CPU's
    own top-k set differs it records the token's k-th minus (k+1)-th
    probability on the CPU (its margin) and the largest card-CPU gap of
    the probabilities at the experts in one set but not the other. An
    expert i the CPU keeps and j the card keeps instead bound the margin
    by p_i - p_j on the CPU, which the card reverses, so by twice that
    gap: ``fields()`` summarises them over the valid tokens, and a token
    whose margin exceeds twice its gap has moved beyond the
    perturbation, and fails the phase."""

    def __init__(self, torch):
        self.torch = torch
        self.routes, self.valid, self.rows, self.pairs = [], None, [], 0

    @contextlib.contextmanager
    def card(self, valid_len):
        from unittest import mock
        from repro_torch.models import layers as ll
        route = ll.moe_route
        self.valid = valid_len

        def tap(x, router, cfg):
            out = route(x, router, cfg)
            self.routes.append(out)
            return out
        with mock.patch.object(ll, "moe_route", tap):
            yield

    @contextlib.contextmanager
    def cpu(self):
        from unittest import mock
        from repro_torch.models import layers as ll
        torch = self.torch
        route = ll.moe_route
        calls = iter(self.routes)

        def forced(x, router, cfg):
            probs, _, idx, _, _, cap = route(x, router, cfg)
            c_probs, _, c_idx, c_pos, c_in, c_cap = next(calls)
            c_probs, c_idx = c_probs.cpu(), c_idx.cpu()
            if c_cap != cap:
                fail(f"MoE routing: capacity {c_cap} on the card, {cap} on "
                     "the CPU")
            pos, in_cap = ll.moe_positions(c_idx, cfg.num_experts, cap)
            if not (torch.equal(pos, c_pos.cpu())
                    and torch.equal(in_cap, c_in.cpu())):
                fail("MoE routing: the card's capacity positions or kept "
                     "flags differ from the CPU's cumulative sum over the "
                     "card's experts")
            l = x.shape[1]
            valid = (torch.arange(l)[None] < torch.tensor(self.valid)[:, None]
                     if l > 1 else torch.ones(x.shape[:2], dtype=torch.bool))
            chosen = torch.zeros_like(probs, dtype=torch.bool)
            swapped = (chosen.scatter(-1, idx, True)
                       ^ chosen.scatter(-1, c_idx, True))
            moved = swapped.any(-1) & valid
            top = probs.topk(cfg.top_k + 1, dim=-1).values
            self.pairs += pos.numel()
            self.rows.append({
                "tokens": int(valid.sum()), "moved": int(moved.sum()),
                "margin": (top[..., -2] - top[..., -1])[moved],
                "gap": ((c_probs - probs).abs() * swapped).amax(-1)[moved]})
            gates = probs.gather(-1, c_idx)
            gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
            return probs, gates, c_idx, pos, in_cap, cap
        with mock.patch.object(ll, "moe_route", forced):
            yield

    def fields(self) -> dict:
        margins = [float(m) for r in self.rows for m in r["margin"]]
        gaps_ = [float(g) for r in self.rows for g in r["gap"]]
        return {"calls": len(self.rows),
                "tokens_routed": sum(r["tokens"] for r in self.rows),
                "tokens_moved": sum(r["moved"] for r in self.rows),
                "positions_checked": self.pairs,
                "largest_margin_moved": max(margins, default=0.0),
                "largest_prob_gap_moved": max(gaps_, default=0.0),
                "moved_beyond_perturbation": sum(
                    m > 2 * g for m, g in zip(margins, gaps_))}


def phase_cross_device(torch, dev, cfg, params):
    """Phase 4: :func:`cross_device` at phase 3's model. Returns (tokens,
    valid lengths, the card's run, the CPU's run) for phase 4b."""
    fields, check, toks, vl, card, cpu = cross_device(torch, dev, cfg,
                                                      params)
    emit({"phase": "cross_device", **fields})
    check()
    return toks, vl, card, cpu


def phase_two_stage_cross(torch, dev, cfg, params, toks, vl, card, cpu):
    """Phase 4b: phase 4's chunk and decode steps through the card's two
    stages (B4, B3), held by phase 4's gauges and limits against the
    card's fused kernels and against the CPU's plain path. A planted
    fault (each layer run with the next layer's feature params w and
    m_mat) must fail the same check."""
    from repro_torch.models import lm

    two = drive(torch, lm, cfg, params, dev, toks, vl, feed=card[1],
                fused=False)
    layers = params["units"]["b0"]
    shifted = {**params, "units": {"b0": {**layers, "attn": {
        **layers["attn"], "feat": lm.tree_map(
            lambda t: torch.roll(t, -1, dims=0), layers["attn"]["feat"])}}}}
    planted = drive(torch, lm, cfg, shifted, dev, toks, vl, feed=card[1],
                    fused=False)
    vs_fused = gaps(torch, two, card)
    vs_cpu = gaps(torch, two, cpu)
    fault = gaps(torch, planted, cpu)
    emit({"phase": "two_stage_cross", "tolerance": CROSS_DEVICE_TOL,
          "state_tolerance": STATE_TOL,
          "vs_card_fused": {"rel_max_err": vs_fused[0],
                            "state_rel_err": vs_fused[1]},
          "vs_cpu_plain": {"rel_max_err": vs_cpu[0],
                           "state_rel_err": vs_cpu[1]},
          "planted_fault": {"what": "each layer run with the next layer's "
                                    "feature params w, m_mat",
                            "rel_max_err": fault[0],
                            "state_rel_err": fault[1]}})
    for what, (logit_err, state_err) in (("card fused", vs_fused),
                                         ("CPU plain", vs_cpu)):
        if max(logit_err) > CROSS_DEVICE_TOL or state_err > STATE_TOL:
            fail(f"two-stage vs {what}: logits {max(logit_err):.3e}, state "
                 f"{state_err:.3e} of their max")
    if max(fault[0]) <= CROSS_DEVICE_TOL and fault[1] <= STATE_TOL:
        fail("two-stage cross-check passes a planted fault")


def exact_gaps(torch, got, ref):
    """How far exact run ``got`` is from run ``ref``: the largest |logit|
    gap over max |logit| per step, the largest gap of each layer's kv_k
    and kv_v over that layer's max, and whether the cache lengths are
    equal."""
    (lg, _, sg), (lr, _, sr) = got, ref
    sg, sr = sg["layers"], sr["layers"]
    for t in (*lg, *lr, sg.kv_k, sg.kv_v, sr.kv_k, sr.kv_v):
        if not bool(torch.isfinite(t).all()):
            fail("exact cross-device: non-finite logits or cache")
    logit = [float((g - r).abs().max() / r.abs().max())
             for g, r in zip(lg, lr)]
    state = 0.0
    for g, r in ((sg.kv_k, sr.kv_k), (sg.kv_v, sr.kv_v)):
        per_layer = ((g - r).abs().flatten(1).amax(1)
                     / r.abs().flatten(1).amax(1))
        state = max(state, float(per_layer.max()))
    return logit, state, bool(torch.equal(sg.length, sr.length))


def phase_exact_cross(torch, dev, cfg, params):
    """Phase 4c: phase 4's ragged chunk and two decode steps through the
    exact model on the card and on the CPU, same params and tokens, held
    by phase 4's limits on the logits and on each layer's cache; the
    lengths must be equal. A planted fault (each layer run with the next
    layer's key projection wk) must fail the same check."""
    from repro_torch.models import lm

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 64))
    vl = np.array([64, 40], np.int32)
    card = drive(torch, lm, cfg, params, dev, toks, vl)
    cpu = drive(torch, lm, cfg, lm.tree_map(lambda t: t.cpu(), params),
                "cpu", toks, vl, feed=card[1])
    layers = params["units"]["b0"]
    shifted = {**params, "units": {"b0": {**layers, "attn": {
        **layers["attn"],
        "wk": torch.roll(layers["attn"]["wk"], -1, dims=0)}}}}
    planted = drive(torch, lm, cfg, shifted, dev, toks, vl, feed=card[1])
    logit_err, state_err, lengths_equal = exact_gaps(torch, card, cpu)
    fault_logit, fault_state, _ = exact_gaps(torch, planted, cpu)
    emit({"phase": "exact_cross_device", "rel_max_err": logit_err,
          "cache_rel_err": state_err, "lengths_equal": lengths_equal,
          "lengths": card[2]["layers"].length[0].tolist(),
          "tolerance": CROSS_DEVICE_TOL, "state_tolerance": STATE_TOL,
          "planted_fault": {"what": "each layer run with the next layer's "
                                    "key projection wk",
                            "rel_max_err": fault_logit,
                            "cache_rel_err": fault_state},
          "seconds": time.perf_counter() - t0})
    if max(logit_err) > CROSS_DEVICE_TOL:
        fail(f"exact cross-device logits differ by {max(logit_err):.3e} "
             "of max |logit|")
    if state_err > STATE_TOL:
        fail(f"exact cross-device cache differs by {state_err:.3e} of its "
             "max")
    if not lengths_equal:
        fail("exact cross-device: cache lengths differ")
    if max(fault_logit) <= CROSS_DEVICE_TOL and fault_state <= STATE_TOL:
        fail("exact cross-device check passes a planted fault")


def phase_train_kernels(torch, dev, kl, kf):
    """Phase 2c: the training kernels, forward and gradients, against
    autograd of their plain versions; returns the worst forward error
    per kernel."""
    from repro_torch.kernels import check as kc

    err = {"linear_attention_causal": 0.0, "prf_featmap": 0.0}
    cases = []
    for b, g, hg, hk, l, m, dv, dt in (
            (8, 3, 3, 1, 512, 256, 64, torch.bfloat16),   # the main path's
            (8, 3, 3, 1, 512, 256, 64, torch.float32),
            (2, 3, 3, 1, 777, 256, 64, torch.float32),
            (4, 3, 3, 1, 256, 256, 64, torch.bfloat16),
            (4, 3, 3, 1, 100, 256, 64, torch.float32),
            (8, 3, 3, 1, 1, 256, 64, torch.bfloat16),
            (4, 3, 3, 1, 64, 256, 64, torch.float32),     # one tile
            (4, 3, 3, 1, 65, 256, 64, torch.bfloat16),    # a key past it
            (2, 3, 3, 1, 2048, 256, 64, torch.bfloat16),  # 31 prefixes
            (2, 3, 3, 3, 300, 256, 64, torch.float32),    # Hk = H
            (2, 1, 8, 1, 300, 256, 256, torch.float32)):  # darkformer-2b
        name = (f"linear_attention_causal N={b * g * hg} Hk={hk} L={l} "
                f"m={m} dv={dv} v={str(dt).split('.')[-1]}")
        args = kc.make_lin_attn_inputs(dev, b, g, hg, l, m, dv,
                                       seed=len(cases), dtype=dt, hk=hk)
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
            (777, 64, 64, 256, False, torch.float32),
            (5, 16, 16, 32, True, torch.float32),
            # d_head 128 and darkformer-2b's 256
            (4099, 128, 128, 256, True, torch.bfloat16),
            (4099, 256, 256, 256, True, torch.float32),
            (777, 256, 256, 256, False, torch.float32),
            (B * 8 * L_TRAIN, 256, 256, 256, True, torch.bfloat16),
            # the other kernels of the dispatch: streamed at d > r (r = 64,
            # 128), resident at r = 64 where W's split does not fit
            (777, 128, 64, 256, True, torch.float32),
            (777, 256, 128, 256, True, torch.bfloat16),
            (777, 64, 64, 512, True, torch.float32)):
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


def lin_attn_timing(torch, dev, kl, b, g, hg, l, m, dv, dtype, iters=20):
    """B5's forward at one shape (qf (B, G, Hg, L, m), kf and v per KV
    group): CUDA events and device time (:func:`kernel_times`) beside its
    plain version and two bounds, each max(bytes / 3.35 TB/s, operations
    / peak): ``bound_ms`` at the 495 TFLOP/s of TF32 on the tensor cores,
    where the kernel computes, ``bound_f32_simt_ms`` at the 67 TFLOP/s of
    f32 outside them (operations: :func:`lin_attn_flops`; bytes: qf, kf,
    v read once, out written once)."""
    from repro_torch.kernels import check as kc

    args = kc.make_lin_attn_inputs(dev, b, g, hg, l, m, dv, seed=11,
                                   dtype=dtype)
    rows, kv_rows = b * g * hg, b * g
    flops = lin_attn_flops(rows, kv_rows, l, m, dv)
    byts = nbytes(*args) + rows * l * dv * args[2].element_size()
    bms, by = bound(byts, flops, TF32_FLOPS)
    with torch.no_grad():
        return {
            "shape": (f"B={b} G={g} Hg={hg} L={l} m={m} dv={dv} "
                      f"v={str(dtype).split('.')[-1]}"),
            **kernel_times(torch, lambda: kl.linear_attention_causal(
                *args, eps=1e-8), iters),
            "plain_ms": time_ms(
                torch, lambda: kl.linear_attention_causal_plain(*args, 1e-8),
                max(iters // 2, 3)),
            "bound_ms": bms, "bound_by": by,
            "bound_f32_simt_ms": bound(byts, flops)[0], "bytes": byts,
            "flops": flops}


def featmap_timing(torch, dev, kf, n, d, r, m, dark, dtype, iters=50):
    """B6's forward on n rows (x (n, d) in ``dtype``, M (r, d) when
    ``dark``, else r = d; W (m, r)): CUDA events and device time
    (:func:`kernel_times`) beside its plain version and two bounds, each
    max(bytes / 3.35 TB/s, operations / peak): ``bound_ms`` at the 495
    TFLOP/s of TF32 on the tensor cores, where the kernel computes,
    ``bound_f32_simt_ms`` at the 67 TFLOP/s of f32 outside them (bytes:
    x, M, W and c read once, phi written once; operations: x Mᵀ when
    dark, x̃ Wᵀ and the squared norm)."""
    from repro_torch.kernels import check as kc

    args = kc.make_featmap_inputs(dev, n, d, r, m, dark, seed=12,
                                  dtype=dtype)
    r = r if dark else d
    flops = n * ((2 * d * r if dark else 0) + 2 * r * m + 2 * r)
    byts = nbytes(*args) + n * m * 4
    bms, by = bound(byts, flops, TF32_FLOPS)
    with torch.no_grad():
        return {
            "shape": (f"N={n} d={d} r={r} m={m} "
                      f"{'dark' if dark else 'isotropic'} "
                      f"x={str(dtype).split('.')[-1]}"),
            **kernel_times(torch, lambda: kf.prf_featmap(*args), iters),
            "plain_ms": time_ms(torch, lambda: kf.prf_featmap_plain(*args),
                                max(iters // 2, 3)),
            "bound_ms": bms, "bound_by": by,
            "bound_f32_simt_ms": bound(byts, flops)[0], "bytes": byts,
            "flops": flops}


def phase_train_timing(torch, dev, kl, kf):
    """Phase 2d: the training kernels timed (forward, CUDA events) at the
    smollm-135m training shapes beside their plain versions and bounds.
    linear_attention_causal: 8 x 512 tokens, 9 heads over 3 KV groups,
    m = 256, dv = 64, bf16 v (:func:`lin_attn_timing`). prf_featmap
    (:func:`featmap_timing`): the 8·9·512 query rows of that batch, d = r
    = 64, f32 x; and darkformer-2b's 8·8·512 rows at d = r = m = 256."""
    out = {"linear_attention_causal": lin_attn_timing(
        torch, dev, kl, B, 3, 3, L_TRAIN, 256, 64, torch.bfloat16)}
    out["prf_featmap"] = featmap_timing(torch, dev, kf, B * 9 * L_TRAIN, 64,
                                        64, 256, True, torch.float32)
    out["prf_featmap_darkformer"] = featmap_timing(
        torch, dev, kf, B * 8 * L_TRAIN, 256, 256, 256, True, torch.float32,
        20)
    emit({"phase": "train_kernel_timing", **out})
    return out


def phase_two_stage_kernels(torch, dev, kds, kl, kw):
    """Phase 2e: the two-stage serving kernels (B3, B4) and B7 against
    their plain versions; returns the worst forward error per kernel."""
    from repro_torch.kernels import check as kc

    err = {"prf_decode_step": 0.0, "linear_attention_carry": 0.0,
           "wkv6": 0.0}
    cases = []

    def record(kernel, name, e, **extra):
        err[kernel] = max(err[kernel], e)
        cases.append({"case": name, "max_abs_err": e, **extra})
    def step_case(gname, b, g, hg, hk, dv, dt):
        name = (f"prf_decode_step {gname} slots={b} Hk={hk} "
                f"v={str(dt).split('.')[-1]} rho<1")
        args = kc.make_decode_step_inputs(dev, b, g, hg, 256, dv,
                                          seed=len(cases), hk=hk, dtype=dt)
        record("prf_decode_step", name, kc.check_case(
            name, lambda: kds.launches, kds.linear_attention_decode_step,
            kds.prf_decode_step_plain, args, (3, 4), eps=1e-8))
    for gname, g, hg, dv, slots in (("smollm-135m", 3, 3, 64, (8, 4, 2, 1)),
                                    ("darkformer-2b", 1, 8, 256, (8, 1))):
        for b in slots:
            for dt in (torch.float32, torch.bfloat16):
                step_case(gname, b, g, hg, 1, dv, dt)
        step_case(gname, 2, g, hg, hg, dv, torch.bfloat16)  # Hk = H
    carry = (lambda: kl.carry_launches, kl.linear_attention_prefill_chunk,
             kl.linear_attention_carry_plain)

    def carry_case(b, g, hg, hk, l, dv, dt, rho):
        name = (f"linear_attention_carry B={b} G={g} Hg={hg} L={l} Hk={hk} "
                f"dv={dv} v={str(dt).split('.')[-1]} s0,z0 nonzero"
                f"{' rho<1' if rho else ''}")
        args = kc.make_carry_inputs(dev, b, g, hg, hk, l, 256, dv,
                                    seed=len(cases), dtype=dt)
        kw = {"rho": kc.make_carry_rho(dev, b, g, hg, seed=len(cases))
              } if rho else {}
        record("linear_attention_carry", name, kc.check_case(
            name, *carry, args, (3, 4), eps=1e-8, **kw))
    for l in (1, 37, 256, 300, 512):
        for hk in (1, 3):
            for dt in (torch.bfloat16, torch.float32):
                carry_case(2, 3, 3, hk, l, 64, dt, rho=False)
    for l in (37, 300):
        for hk in (1, 3):
            carry_case(2, 3, 3, hk, l, 64, torch.float32, rho=True)
    for dt in (torch.bfloat16, torch.float32):
        for b, l in GRANTS:                       # smollm-135m's heads
            carry_case(b, 3, 3, 1, l, 64, dt, rho=True)
        for b, l in ((8, 32), (1, 256)):          # darkformer-2b's
            carry_case(b, 1, 8, 1, l, 256, dt, rho=True)
    for b, l in ((3, 64), (5, 32)):               # the packer's most
        carry_case(b, 3, 3, 1, l, 64, torch.bfloat16, rho=True)  # frequent
    record("linear_attention_carry", "linear_attention_carry chunks "
           "256+37+307 vs one pass of 600",
           kc.check_carry_chained(dev, seed=99))
    for n, l, dh, dt, decays in WKV6_CASES:
        name = f"wkv6 N={n} L={l} dh={dh} {dt} {decays} decays"
        args = kc.make_wkv6_inputs(dev, n, l, dh, seed=len(cases),
                                   dtype=getattr(torch, dt), decays=decays)
        record("wkv6", name, kc.check_forward(
            name, lambda: kw.launches, kw.wkv6, kw.wkv6_plain, args))
    for n, l, dt in ((4, 1, torch.float32), (4, 50, torch.float32),
                     (4, 33, torch.bfloat16)):
        name = f"wkv6 gradients N={n} L={l} dh=64 {str(dt).split('.')[-1]}"
        args = kc.make_wkv6_inputs(dev, n, l, 64, seed=len(cases), dtype=dt)
        fwd, grad = kc.check_autograd(name, kw, kw.wkv6, kw.wkv6_plain,
                                      args, seed=len(cases))
        record("wkv6", name, fwd, grad_max_abs_err=grad)
    emit({"phase": "two_stage_kernels_vs_plain", "tolerance_f32": kc.F32_TOL,
          "tolerance_bf16_out": kc.BF16_OUT_TOL, "cases": cases})
    return err


# B7's forward cases in phase 2e, as (rows, L, dh, type, decays): the
# rwkv6-7b geometry (dh 64) at a batch of 8 prompts (512 rows x 512) and
# one long prompt (64 rows x 4096), f32 and bf16, with sigmoid decays and
# with the model's (exact zeros, a padded tail of w = 1, k = 0); short
# and one-token rows; narrow and uneven widths (4, 16, 100) and the
# widest the kernel takes, 128, also at more rows than the card has SMs
WKV6_CASES = (
    (512, 512, 64, "float32", "sigmoid"),
    (64, 50, 64, "bfloat16", "sigmoid"),
    (8, 1, 64, "float32", "sigmoid"),
    (64, 4096, 64, "float32", "sigmoid"),
    (512, 512, 64, "float32", "model"),
    (64, 4096, 64, "bfloat16", "model"),
    (8, 300, 4, "float32", "model"),
    (8, 300, 16, "float32", "sigmoid"),
    (16, 300, 100, "float32", "model"),
    (16, 300, 128, "float32", "sigmoid"),
    (16, 300, 128, "bfloat16", "model"),
    (512, 64, 128, "float32", "sigmoid"),
    (256, 64, 100, "bfloat16", "model"),
)


def carry_flops(rows, kv_rows, l, m, dv, chunk=256):
    """Operations the carried scan needs, the fewer of its two exact
    forms, as :func:`lin_attn_flops` with a nonzero carried state per
    query row. Token-serial: per token the increments of S and z once per
    KV row, and per query row q·S0, q·z0 and q·ΔS, q·Δz, their sums and
    the division; then S0 + ΔS and z0 + Δz once. Chunked: per query row
    and chunk the causal half of the scores and of P·V and Q·S_in, Q·z_in
    (every chunk, S0 being nonzero), and S_in formed per chunk; per KV
    row Kᵀ V and Σ K for every chunk (the final state needs the last)."""
    final = rows * m * (dv + 1)
    serial = l * (kv_rows * m * (2 * dv + 1)
                  + rows * (4 * m * (dv + 1) + 2 * (dv + 1))) + final
    chunked = rows * l * (dv + 1)
    for c0 in range(0, l, chunk):
        t = min(chunk, l - c0)
        chunked += rows * t * (t + 1) // 2 * (2 * m + 2 * dv + 1)
        chunked += rows * 2 * t * m * (dv + 1) + final
        chunked += kv_rows * t * m * (2 * dv + 1)
    return min(serial, chunked)


def carry_times(torch, args, call, plain, rho=None, by_kernel=False):
    """B4's numbers for ``call``, one launch on ``args`` (qf, kf, v, s0,
    z0, as ``check.make_carry_inputs`` makes them, the state advanced in
    place): CUDA events and device time beside ``plain`` (its plain
    version) and two bounds, each max(bytes / 3.35 TB/s, operations /
    peak): ``bound_ms`` at the 495 TFLOP/s of TF32 on the tensor cores,
    where the kernel computes, ``bound_f32_simt_ms`` at the 67 TFLOP/s of
    f32 outside them (operations: :func:`carry_flops`; bytes: qf, kf, v,
    S0 and z0 in and out, out). ``rho`` (None or the ρ given) names the
    shape; ``by_kernel`` adds the device time of each launch
    (:func:`device_ms_by_kernel`)."""
    qf, kf_, v, s0, z0 = args
    b, g, hg, l, m = qf.shape
    dv = v.shape[-1]
    rows, kv_rows = b * g * hg, b * g
    flops = carry_flops(rows, kv_rows, l, m, dv)
    byts = nbytes(qf, kf_, v) + 2 * nbytes(s0, z0) + rows * l * dv * 2
    bms, by = bound(byts, flops, TF32_FLOPS)
    out = {
        "shape": (f"B={b} L={l} G={g} Hg={hg} m={m} dv={dv} v=bf16"
                  f"{'' if rho is None else ' rho<1'}"),
        **kernel_times(torch, call, 100),
        "plain_ms": time_ms(torch, plain, 30),
        "bound_ms": bms, "bound_by": by,
        "bound_f32_simt_ms": bound(byts, flops)[0], "bytes": byts,
        "flops": flops}
    if by_kernel:
        out["device_ms_by_kernel"] = device_ms_by_kernel(torch, call, 10)
    return out


def carry_timing(torch, dev, kl, b, l, g=3, hg=3, dv=64, rho=True,
                 by_kernel=False):
    """B4 at ``b`` rows x ``l`` tokens (smollm-135m's heads unless ``g``,
    ``hg``, ``dv`` say otherwise; bf16 v, the pool's state scaled by a
    ρ < 1 per query row when ``rho`` and advanced in place), as
    :func:`carry_times` reports it."""
    from repro_torch.kernels import check as kc

    args = kc.make_carry_inputs(dev, b, g, hg, 1, l, 256, dv, seed=14,
                                dtype=torch.bfloat16)
    r = kc.make_carry_rho(dev, b, g, hg, seed=14) if rho else None
    return carry_times(
        torch, args,
        lambda: kl.linear_attention_prefill_chunk(*args, rho=r, eps=1e-8),
        lambda: kl.linear_attention_carry_plain(*args, 1e-8, rho=r),
        r, by_kernel)


# B4's timed shapes (phase 2f, scripts/torch_lin_attn_shapes.py): the four
# grants at smollm-135m's heads, then darkformer-2b's (G 1, Hg 8, dv 256)
# at 8 x 32 and 1 x 256, as (key, b, l, g, hg, dv); "linear_attention_carry"
# is the 8 x 32 one
CARRY_SHAPES = (
    ("linear_attention_carry", 8, 32, 3, 3, 64),
    *((f"linear_attention_carry_{b}x{l}", b, l, 3, 3, 64)
      for b, l in GRANTS[1:]),
    ("linear_attention_carry_darkformer_8x32", 8, 32, 1, 8, 256),
    ("linear_attention_carry_darkformer_1x256", 1, 256, 1, 8, 256))


def phase_two_stage_timing(torch, dev, kds, kl, kw):
    """Phase 2f: B3, B4 and B7 timed (CUDA events) beside their plain
    versions and bounds. B3 at 8 slots of smollm-135m, cold and warm
    (:func:`decode_step_timing`); B4 at the packer's four grants at
    smollm-135m's heads and at darkformer-2b's at 8 x 32 and 1 x 256
    (:data:`CARRY_SHAPES`), bf16 v, the pool's state
    scaled by ρ and advanced in place; B7 at the rwkv6-7b geometry, dh
    64, f32, at 512 rows (64 heads x batch 8) x 512 tokens and at one
    long prompt, 64 rows x 4096 tokens (:func:`wkv6_timing`)."""
    out = {"prf_decode_step": decode_step_timing(torch, dev, kds, 8)}
    for key, b, l, g, hg, dv in CARRY_SHAPES:
        out[key] = carry_timing(torch, dev, kl, b, l, g, hg, dv)
    out["wkv6"] = wkv6_timing(torch, dev, kw, 512, 512, 64)
    out["wkv6_64x4096"] = wkv6_timing(torch, dev, kw, 64, 4096, 64)
    emit({"phase": "two_stage_kernel_timing", **out})
    return out


def wkv6_timing(torch, dev, kw, n, l, dh, dtype=None, iters=20):
    """B7 at ``n`` rows x ``l`` tokens of width ``dh`` (f32 unless
    ``dtype``; sigmoid decays): CUDA events and device time beside its
    plain version and its bound, max(bytes / 3.35 TB/s, operations / 67
    TFLOP/s of f32); bytes: r, k, v, w read once and o written once;
    operations: about 5 dh² a token and row (the state's decay, k vᵀ and
    its sum, r's product with it, and the bonus)."""
    from repro_torch.kernels import check as kc

    dtype = dtype or torch.float32
    args = kc.make_wkv6_inputs(dev, n, l, dh, seed=15, dtype=dtype)
    flops = n * l * (5 * dh * dh + 5 * dh)
    byts = nbytes(*args) + n * l * dh * args[2].element_size()
    bms, by = bound(byts, flops)
    with torch.no_grad():
        return {
            "shape": f"N={n} L={l} dh={dh} {str(dtype).split('.')[-1]}",
            **kernel_times(torch, lambda: kw.wkv6(*args), iters),
            "plain_ms": time_ms(torch, lambda: kw.wkv6_plain(*args), 3),
            "bound_ms": bms, "bound_by": by, "bytes": byts, "flops": flops}


def phase_train(torch, dev, counters):
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
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    out = train.main(common + ["--steps", str(steps_n), "--seed", "0",
                               "--ckpt-dir", str(ck), "--ckpt-every",
                               str(steps_n)])
    wall = time.perf_counter() - t0
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
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
    want = {n: 0 for n in counters}
    want["linear_attention_causal"] = b5_per_step(cfg) * steps_n
    if launches != want:
        fail(f"train: launches {launches}, expected {want}")
    del out

    # qkv-only finetune from the checkpoint, into params drawn from
    # another seed (so the restore must overwrite every leaf)
    pre, step = ckpt.restore_checkpoint(
        str(ck), {"params": lm.init_params(cfg, seed=1, device=dev)})
    kl = counters["linear_attention_causal"][0]
    kl.launches = 0
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
          "launches": kl.launches})
    if frozen_moved or trained_still:
        fail(f"finetune: frozen leaves moved {frozen_moved}, trained "
             f"leaves unchanged {trained_still}")
    if not all(np.isfinite(x["loss"]) for x in ft["metrics"]):
        fail("finetune: non-finite loss")
    if kl.launches != 3 * b5_per_step(cfg):
        fail(f"finetune: linear_attention_causal launches {kl.launches}")
    phase_serve_load(torch, dev, counters, ck, pre["params"], cfg)
    shutil.rmtree(ck, ignore_errors=True)
    return launches


def phase_serve_load(torch, dev, counters, ck, restored, cfg,
                     phase="serve_load"):
    """Phase 5b (and 9 (b)): the serve CLI serves 4 requests at full
    width from a trainer's checkpoint (``--load``, overlapped scheduler,
    the arch ``cfg.name``): full token counts, fused_kernel paths, B1/B2
    launches per decode step and prefill call (x the attention layers),
    and the streams of an engine built on ``restored``, the params
    restored from that checkpoint. Returns the launches."""
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving import ServingEngine, synthetic_requests

    args = ["--arch", cfg.name, "--device", str(dev), "--requests",
            "4", "--slots", "4", "--max-len", "512", "--prompt-len",
            "64-256", "--gen", "16-32", "--chunk-tokens", "256"]
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    t0 = time.perf_counter()
    st = serve_cli.main(args + ["--load", str(ck)])
    wall = time.perf_counter() - t0
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    got = [r.tokens for r in sorted(st["results"], key=lambda r: r.uid)]
    reqs = synthetic_requests(4, cfg.vocab, prompt_range=(64, 256),
                              gen_range=(16, 32))
    eng = ServingEngine(restored, dataclasses.replace(cfg, use_kernel=True),
                        max_slots=4, max_len=512, chunk_tokens=256,
                        overlap=True, device=dev)
    uids = [eng.submit(r) for r in reqs]
    by_uid = {r.uid: r.tokens for r in eng.run()}
    want = fused_launches(counters, st, cfg)
    emit({"phase": phase, "arch": cfg.name,
          "from": str(ck.relative_to(ROOT)),
          "wall_s": wall, "tokens": [len(t) for t in got],
          "max_new_tokens": [r.max_new_tokens for r in reqs],
          "prefill_path": st["prefill_path"],
          "decode_path": st["decode_path"], "overlap": st["overlap"],
          "launches": launches,
          "streams_equal_to_restored_params": got == [by_uid[u]
                                                      for u in uids]})
    if [len(t) for t in got] != [r.max_new_tokens for r in reqs]:
        fail(f"serve --load: tokens per request {[len(t) for t in got]}")
    if st["prefill_path"] != "fused_kernel" or \
            st["decode_path"] != "fused_kernel" or not st["overlap"]:
        fail(f"serve --load ran {st['prefill_path']}/{st['decode_path']}, "
             f"overlap {st['overlap']}")
    if launches != want:
        fail(f"serve --load: launches {launches}, expected {want}")
    if got != [by_uid[u] for u in uids]:
        fail("serve --load: streams differ from an engine on the params "
             "restored from the checkpoint")
    return launches


def sigma(torch, m_mat):
    """Sigma = M^T M of every (layer, group) in f64: what two devices that
    calibrate the same model agree on (eigh fixes M's rows only up to
    sign and rotation within near-equal eigenvalues)."""
    m = m_mat.double()
    return torch.einsum("lgrd,lgre->lgde", m, m)


def shrunk_cov64(torch, q, k, scale, shrink=0.05):
    """A (layer, group)'s shrunk covariance in f64 from its taps."""
    d = q.shape[-1]
    x = torch.cat([(q.double() * scale).reshape(-1, d),
                   (k.double() * scale).reshape(-1, d)])
    x = x - x.mean(0)
    cov = x.T @ x / x.shape[0]
    eye = torch.eye(d, dtype=torch.float64, device=x.device)
    return (1 - shrink) * cov + shrink * torch.trace(cov) / d * eye


def attn_m(cfg, params):
    """{tap name: (G, r, d) M} of every attention layer, in layer order
    (``lm.collect_qk``'s names), in either layout."""
    plen = len(cfg.block_pattern)
    out = {}
    for li, kind in enumerate(cfg.layer_kinds()):
        if kind in ("attn", "local"):
            u, i = divmod(li, plen)
            blk = (params["units"][f"b{i}"] if u < cfg.n_units else
                   params["rem"][li - cfg.n_units * plen])
            m = blk["attn"]["feat"]["m_mat"]
            out[f"unit{u}/b{i}"] = m[u] if u < cfg.n_units else m
    return out


def whitening_gaps(torch, ms, taps, cfg):
    """max |M Lambda M^T - I| of each attention layer over its groups
    (``ms``: {tap name: (G, r, d) M}), Lambda in f64 from the taps the
    calibration read."""
    scale = cfg.head_dim ** -0.25
    out = []
    for name, m_l in ms.items():
        q, k = taps[name]
        gap = 0.0
        for gi in range(cfg.n_kv):
            m = m_l[gi].double().to(q.device)
            w = m @ shrunk_cov64(torch, q[:, gi], k[:, gi], scale) @ m.T
            eye = torch.eye(w.shape[0], dtype=torch.float64,
                            device=w.device)
            gap = max(gap, float((w - eye).abs().max()))
        out.append(gap)
    return out


def calibrate_cross_device(torch, dev, cfg_d):
    """Phase 5c (4): ``whitening_calibrate`` of smollm-135m at full width
    and 4 layers (bf16, darkformer m 256, params from seed 0), batch
    2 x 256, on the card and on the CPU from the same params: each
    (layer, group)'s Sigma gap over its max |Sigma|, each layer's taps'
    gap over their max |tap|; then the card's run again with a planted
    fault (each layer calibrated from the next layer's taps)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm

    cfg = dataclasses.replace(cfg_d, n_layers=4)
    params = lm.init_params(cfg, seed=0, device=dev)
    cpu_params = lm.tree_map(lambda t: t.cpu(), params)
    cfg_cpu = dataclasses.replace(cfg, use_kernel=False)
    data = SyntheticLM(cfg.vocab, 256, 2, seed=0).batch(0)
    batch = {k: torch.from_numpy(v).long() for k, v in data.items()}
    card_batch = {k: t.to(dev) for k, t in batch.items()}

    def m_of(p):
        return p["units"]["b0"]["attn"]["feat"]["m_mat"]
    m_card = m_of(lm.whitening_calibrate(params, cfg, card_batch)).cpu()
    m_cpu = m_of(lm.whitening_calibrate(cpu_params, cfg_cpu, batch))
    card, cpu = sigma(torch, m_card), sigma(torch, m_cpu)
    # M itself: rows whose sign eigh chose otherwise, and the largest row
    # gap once signs agree, over max |M| (reported, not checked)
    sign = torch.sign((m_card.double() * m_cpu.double()).sum(-1,
                                                             keepdim=True))
    m_flipped = int((sign < 0).sum())
    m_gap = float((m_card.double() * sign - m_cpu.double()).abs().max()
                  / m_cpu.double().abs().max())
    taps_card = lm.collect_qk(params, cfg, card_batch)
    taps_cpu = lm.collect_qk(cpu_params, cfg_cpu, batch)
    tap_gap = [max(float((a.cpu().float() - b.float()).abs().max()
                         / b.float().abs().max())
                   for a, b in zip(taps_card[n], taps_cpu[n]))
               for n in taps_cpu]
    del taps_card, taps_cpu
    sound = lm.collect_qk

    def planted(*a, **kw):
        t = sound(*a, **kw)
        return {f"unit{i}/b0": t[f"unit{(i + 1) % len(t)}/b0"]
                for i in range(len(t))}
    try:
        lm.collect_qk = planted
        fault = sigma(torch, m_of(lm.whitening_calibrate(
            params, cfg, card_batch))).cpu()
    finally:
        lm.collect_qk = sound

    def gaps(got):
        return [[float((got[li, gi] - cpu[li, gi]).abs().max()
                       / cpu[li, gi].abs().max())
                 for gi in range(cfg.n_kv)] for li in range(cfg.n_layers)]
    return {"n_layers": cfg.n_layers, "batch": 2, "seq": 256,
            "sigma_rel_err": gaps(card), "tap_rel_err": tap_gap,
            "m_rows_sign_flipped": [m_flipped, sign.numel()],
            "m_row_rel_err_signs_aligned": m_gap,
            "sigma_tolerance": CAL_SIGMA_TOL,
            "tap_tolerance": CROSS_DEVICE_TOL,
            "planted_fault": {"what": "each layer calibrated from the next "
                                      "layer's taps",
                              "sigma_rel_err": gaps(fault)}}


def phase_exact_finetune(torch, dev, counters):
    """Phase 5c: the paper's scenario at full width. Exact smollm-135m
    trained by the launcher for 4 steps (SyntheticLM seed 0, 8 x 512,
    AdamW lr 3e-4; no kernel may launch) and checkpointed; the restored
    params transplanted into a darkformer (m 256); the exact model's
    layer-0 q anisotropy; ``lm.whitening_calibrate`` on batch 10 000
    (B5 once a layer, no other launch), its whitening gap, and card vs
    CPU calibration at 4 layers with a planted fault; the eval loss of
    the exact, the transplanted (M = I) and the calibrated models; the
    calibrated params finetuned qkv-only for 3 steps through B5 (3 x 30
    launches, no other; m_mat moved); then 4 requests served from the
    finetuned params through B1/B2."""
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.core import calibration as cal
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps, train
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.serving import ServingEngine, synthetic_requests

    t0 = time.perf_counter()
    ck = ROOT / "build" / "chip_smoke_exact_ckpt"
    shutil.rmtree(ck, ignore_errors=True)

    def launches():
        return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}

    def zero():
        for mod, attr in counters.values():
            setattr(mod, attr, 0)

    zero()
    out = train.main(["--arch", "smollm-135m", "--kernel", "exact",
                      "--batch", str(B), "--seq", str(L_TRAIN), "--lr",
                      "3e-4", "--warmup", "2", "--log-every", "1",
                      "--device", str(dev), "--steps", "4", "--seed", "0",
                      "--ckpt-dir", str(ck), "--ckpt-every", "4"])
    exact_launches = launches()
    cfg_e = out["config"]
    exact_losses = [x["loss"] for x in out["metrics"]]
    exact_ms = [x["ms"] for x in out["metrics"]]
    del out
    restored, step = ckpt.restore_checkpoint(
        str(ck), {"params": lm.init_params(cfg_e, seed=1, device=dev)})
    cfg_d = dataclasses.replace(configs.darkify(cfg_e, "darkformer", 256),
                                use_kernel=True)
    exact_params = restored["params"]
    dark = steps.transplant(exact_params,
                            lm.init_params(cfg_d, seed=2, device=dev))
    del restored
    data = SyntheticLM(cfg_d.vocab, L_TRAIN, B, seed=0)

    def batch_at(i):
        return {k: torch.from_numpy(v).to(dev).long()
                for k, v in data.batch(i).items()}
    calib = batch_at(10_000)
    t_cal = time.perf_counter()
    q0 = lm.collect_qk(exact_params, cfg_e, calib)["unit0/b0"][0]
    aniso = float(cal.anisotropy_score(q0.reshape(-1, q0.shape[-1])))
    del q0
    # the calibration pass, counted; the taps it reads are kept for the
    # whitening check
    seen = {}
    sound = lm.collect_qk

    def keep(*a, **kw):
        seen.update(sound(*a, **kw))
        return seen
    zero()
    torch.cuda.synchronize()
    t0_cal = time.perf_counter()
    try:
        lm.collect_qk = keep
        params = lm.whitening_calibrate(dark, cfg_d, calib)
    finally:
        lm.collect_qk = sound
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0_cal
    calib_launches = launches()
    m_cal = params["units"]["b0"]["attn"]["feat"]["m_mat"].clone()
    white = whitening_gaps(torch, attn_m(cfg_d, params), seen, cfg_d)
    seen.clear()
    cross = calibrate_cross_device(torch, dev, cfg_d)
    held_out = batch_at(20_000)
    eval_loss = {
        "exact": float(steps.make_eval_step(cfg_e)(exact_params,
                                                   held_out)["loss"]),
        "darkformer_identity_m": float(steps.make_eval_step(cfg_d)(
            dark, held_out)["loss"]),
        "darkformer_calibrated": float(steps.make_eval_step(cfg_d)(
            params, held_out)["loss"])}
    del dark, exact_params, held_out, calib
    cal_s = time.perf_counter() - t_cal

    opt_cfg = AdamWConfig(lr=3e-4)
    opt = adamw_init(params, opt_cfg)
    step_fn = steps.make_train_step(cfg_d, opt_cfg, constant(3e-4),
                                    steps.qkv_only_freeze)
    zero()
    ft_losses = []
    for i in range(3):
        params, opt, m = step_fn(params, opt, batch_at(4 + i), i)
        ft_losses.append(float(m["loss"]))
    ft_launches = launches()
    m_moved = float((params["units"]["b0"]["attn"]["feat"]["m_mat"]
                     - m_cal).abs().max())
    del opt, m_cal

    reqs = synthetic_requests(4, cfg_d.vocab, seed=5, prompt_range=(64, 256),
                              gen_range=(16, 32))
    eng = ServingEngine(params, cfg_d, max_slots=4, max_len=512,
                        chunk_tokens=256, overlap=True, device=dev)
    for r in reqs:
        eng.submit(r)
    zero()
    by_uid = {r.uid: r.tokens for r in eng.run()}
    serve_launches = launches()
    st = eng.stats
    tokens = [len(by_uid.get(r.uid, [])) for r in reqs]
    emit({"phase": "exact_to_darkformer", "config": cfg_e.name,
          "exact_steps": len(exact_losses), "exact_loss": exact_losses,
          "exact_step_ms": exact_ms, "exact_launches": exact_launches,
          "from_step": step, "num_features": cfg_d.attn.num_features,
          "anisotropy_layer0_q": aniso,
          "calibration": {"batch": [B, L_TRAIN], "seconds": calib_s,
                          "launches": calib_launches,
                          "whitening_gap_by_layer": white,
                          "whitening_gap": max(white),
                          "whitening_tolerance": WHITEN_TOL,
                          "cross_device": cross,
                          "phase_seconds": cal_s},
          "eval_loss": eval_loss,
          "finetune_loss": ft_losses, "finetune_launches": ft_launches,
          "m_mat_moved": m_moved,
          "served_tokens": tokens,
          "max_new_tokens": [r.max_new_tokens for r in reqs],
          "prefill_path": st["prefill_path"],
          "decode_path": st["decode_path"], "serve_launches": serve_launches,
          "seconds": time.perf_counter() - t0})
    shutil.rmtree(ck, ignore_errors=True)
    if not all(np.isfinite(exact_losses + ft_losses)):
        fail(f"exact -> darkformer: losses {exact_losses} {ft_losses}")
    if any(exact_launches.values()):
        fail(f"exact training launched kernels: {exact_launches}")
    want = {n: 0 for n in counters}
    want["linear_attention_causal"] = cfg_d.n_layers
    if calib_launches != want:
        fail(f"calibration: launches {calib_launches}, expected {want}")
    if not (math.isfinite(aniso) and 0.0 <= aniso < 1.0):
        fail(f"calibration: anisotropy score {aniso}")
    if not max(white) <= WHITEN_TOL:
        fail(f"calibration: whitening gap {max(white):.3e} > {WHITEN_TOL}")
    worst = max(max(r) for r in cross["sigma_rel_err"])
    fault = min(min(r) for r in cross["planted_fault"]["sigma_rel_err"])
    if not worst <= CAL_SIGMA_TOL:
        fail(f"calibration card vs CPU: Sigma gap {worst:.3e}")
    if not max(cross["tap_rel_err"]) <= CROSS_DEVICE_TOL:
        fail(f"calibration card vs CPU: taps {cross['tap_rel_err']}")
    if not fault > CAL_SIGMA_TOL:
        fail(f"calibration card vs CPU passes a planted fault ({fault:.3e})")
    if not all(map(math.isfinite, eval_loss.values())):
        fail(f"exact -> darkformer: eval losses {eval_loss}")
    if not m_moved > 0.0:
        fail("exact -> darkformer finetune left m_mat at its calibration")
    want["linear_attention_causal"] = 3 * b5_per_step(cfg_d)
    if ft_launches != want:
        fail(f"exact -> darkformer finetune: launches {ft_launches}, "
             f"expected {want}")
    if tokens != [r.max_new_tokens for r in reqs]:
        fail(f"exact -> darkformer serve: tokens per request {tokens}")
    if st["prefill_path"] != "fused_kernel" or \
            st["decode_path"] != "fused_kernel":
        fail(f"exact -> darkformer serve ran {st['prefill_path']}/"
             f"{st['decode_path']}")
    if serve_launches != fused_launches(counters, st, cfg_d):
        fail(f"exact -> darkformer serve: launches {serve_launches}")


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


def cpu_reference(cfg):
    """``cfg`` for the CPU's side of a card-against-CPU gradient check:
    the plain path, every activation kept (remat gives the CPU bitwise
    the same loss and gradients, tests/test_torch_remat.py, and its
    recompute would only cost the CPU time)."""
    return dataclasses.replace(cfg, use_kernel=False, remat="none")


def loss_and_grads(torch, cfg, params, data, device):
    """The loss and every gradient leaf (``None`` as zeros) of
    ``lm.loss_fn`` on ``data`` (a numpy batch: {"tokens", "labels"}, with
    the modality's frames and mask or patches) moved to ``device``
    (``launch.train.to_device``), all on the CPU, detached; ``params``
    are left as they were."""
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.tree import flatten

    leaves = dict(flatten(params))
    for t in leaves.values():
        t.requires_grad_(True)
    batch = to_device(data, device)
    loss, _ = lm.loss_fn(params, cfg, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    out = {k: (torch.zeros_like(t) if g is None else g).detach().cpu()
           for (k, t), g in zip(leaves.items(), grads)}
    for t in leaves.values():
        t.requires_grad_(False)
    return loss.detach().cpu(), out


def phase_train_cross_device(torch, dev, kl, seed: int = 0):
    """Phase 6: one loss and all its gradients, smollm-135m at full width
    and 4 layers, bf16, batch 2 x 256: the card through the kernel vs the
    CPU through the plain path, same params and batch (both from
    ``seed``). A planted fault (layer i's kernel call fed layer i+1's key
    features) must fail."""
    import repro_torch.kernels as kops
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm

    cfg = configs.get_config("smollm-135m", n_layers=4, use_kernel=True)
    params = lm.init_params(cfg, seed=seed, device=dev)
    data = SyntheticLM(cfg.vocab, 256, 2, seed=seed).batch(0)

    kl.launches = 0
    card = loss_and_grads(torch, cfg, params, data, dev)
    card_launches = kl.launches
    cpu = loss_and_grads(torch, cpu_reference(cfg),
                         lm.tree_map(lambda t: t.cpu(), params), data, "cpu")
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
        fault = loss_and_grads(torch, cfg, params, data, dev)
    finally:
        kops.linear_attention_causal = sound
    loss_gap, grad_gap, where = train_gaps(torch, card, cpu)
    f_loss, f_grad, f_where = train_gaps(torch, fault, cpu)
    emit({"phase": "train_cross_device", "config": cfg.name,
          "n_layers": cfg.n_layers, "batch": 2, "seq": 256, "seed": seed,
          "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
          "loss_rel_err": loss_gap, "grad_rel_err": grad_gap,
          "grad_worst_leaf": where, "loss_tolerance": TRAIN_LOSS_TOL,
          "grad_tolerance": TRAIN_GRAD_TOL, "launches": card_launches,
          "planted_fault": {"what": "layer i's kernel call fed layer i+1's "
                                    "key features",
                            "loss_rel_err": f_loss, "grad_rel_err": f_grad,
                            "grad_worst_leaf": f_where}})
    if card_launches != b5_per_step(cfg):
        fail(f"cross-device training: {card_launches} kernel launches for "
             f"{cfg.n_layers} layers under remat {cfg.remat!r}, expected "
             f"{b5_per_step(cfg)}")
    if loss_gap > TRAIN_LOSS_TOL or grad_gap > TRAIN_GRAD_TOL:
        fail(f"cross-device training: loss gap {loss_gap:.3e}, gradient "
             f"gap {grad_gap:.3e} ({where})")
    if f_loss <= TRAIN_LOSS_TOL and f_grad <= TRAIN_GRAD_TOL:
        fail("cross-device training check passes a planted fault")


# phase 7: the homogeneous attention configs at full width: (arch, the
# depth served, None for the config's own, the requests sent). The
# dense qwen3-32b and yi-34b (65 and 69 GB of bf16 params) leave no room
# for a pool on the 80 GB card, and qwen3-moe-235b-a22b (2.5 B params a
# layer) does not fit at all, so their depth is cut, never their width
HOMOGENEOUS = (("granite-8b", None, 8), ("granite-moe-3b-a800m", None, 8),
               ("qwen3-32b", 4, 4), ("yi-34b", 4, 4),
               ("qwen3-moe-235b-a22b", 2, 4))
# (d): the first layers of the served params, held card against CPU
CROSS_LAYERS = 2


def phase_homogeneous(torch, dev, counters):
    """Phase 7: the five homogeneous attention configs at full width,
    random weights from seed 0 drawn on the card (the host draws about
    1e8 a second: minutes at these sizes), one model at a time (its
    params freed before the next). Each is served through the overlapped
    scheduler under ``set_sync_debug_mode("error")`` (8 slots, max_len 1024,
    chunk_tokens 256; prompts of 64-256 tokens, 16-32 new ones): full
    token counts, fused_kernel paths, B1 = decode steps x layers and B2 =
    prefill calls x layers and no other launch. The MoE config served at
    full depth then sends 8 requests through both schedulers at
    ``prefill_rows=1``, whose greedy streams must be equal. Last,
    phase 4's card-against-CPU check on the served params' first
    ``CROSS_LAYERS`` layers, with its planted fault, the MoE configs'
    CPU run on the card's routing (:class:`RouteTap`). Returns {arch:
    B1's and B2's launches in its serving run}."""
    import gc
    from repro_torch import configs
    from repro_torch.models import lm

    out = {}
    for arch, depth, n_req in HOMOGENEOUS:
        t0 = time.perf_counter()
        cfg = configs.get_config(arch, use_kernel=True)
        full_depth = cfg.n_layers
        if depth:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        param_gb = torch.cuda.memory_allocated() / 1e9
        fields, launches, _, st = serve(
            torch, dev, cfg, params, counters, overlap=True,
            requests=n_req, prompt_range=(64, 256), gen_range=(16, 32))
        equal, eq_fields = True, None
        if cfg.moe and depth is None:
            equal, eq_fields = overlap_equality(torch, dev, cfg, params)
        sub_cfg = dataclasses.replace(cfg, n_layers=CROSS_LAYERS)
        sub = {**params, "units": {"b0": lm.tree_map(
            lambda t: t[:CROSS_LAYERS], params["units"]["b0"])}}
        t_cross = time.perf_counter()
        cross, check, *_ = cross_device(
            torch, dev, sub_cfg, sub, f"{arch} cross-device",
            tap=RouteTap(torch) if cfg.moe else None)
        emit({"phase": "homogeneous", "arch": arch, **fields,
              "full_depth": full_depth, "depth_cut": depth is not None,
              "qk_norm": cfg.qk_norm, "rope_theta": cfg.rope_theta,
              "tie_embeddings": cfg.tie_embeddings,
              "moe": None if cfg.moe is None else dataclasses.asdict(
                  cfg.moe),
              "param_init_s": init_s, "param_gb": param_gb,
              "rows_1_equality": eq_fields,
              "cross_device": {"n_layers": CROSS_LAYERS, **cross,
                               "seconds": time.perf_counter() - t_cross},
              "seconds": time.perf_counter() - t0})
        if st["prefill_path"] != "fused_kernel" or \
                st["decode_path"] != "fused_kernel":
            fail(f"{arch}: served {st['prefill_path']}/"
                 f"{st['decode_path']}")
        want = fused_launches(counters, st, cfg)
        if launches != want:
            fail(f"{arch}: launches {launches}, expected {want} (prefill "
                 f"calls and decode steps x {cfg.n_layers} layers)")
        if not equal:
            fail(f"{arch}: greedy streams differ between the schedulers "
                 f"with one staged row per prefill call ({eq_fields})")
        check()
        out[arch] = {n: launches[n] for n in ("prf_fused_decode",
                                              "prf_fused_prefill")}
        del params, sub
        gc.collect()
        torch.cuda.empty_cache()
    return out


# phase 8: recurrentgemma-2b at its full 26 layers (8 units of ("rec",
# "rec", "local") and 2 remainder rec layers; 2.9 B params, about 5.8 GB
# of bf16, so nothing is cut); (d) holds its first 5 layers (one unit and
# the two remainder layers) card against CPU
RECURRENT = "recurrentgemma-2b"
RECURRENT_CROSS_LAYERS = 5
# (d): each RG-LRU layer's h and conv tail, card (kernels, cuBLAS) against
# CPU (plain path), bf16, 5 layers: the largest gap over that layer's max
# |h|, max |conv|. Sound readings on an H100: h 8.2e-3, conv 1.83e-2 (the
# conv tail holds bf16 products u @ wx of inputs that already differ);
# the planted fault: h 0.39 and conv 0.48 at their least (the first
# layer's conv, upstream of any gate, excepted). Limit at 2.7x
REC_STATE_TOL = 0.05


def _layer_states(st) -> list:
    """A unit/rem state's blocks in layer order (unit by unit, the
    pattern's keys in order, then the remainder)."""
    units = st["units"]
    n = next(iter(units.values()))[0].shape[0]
    return ([type(units[k])(*(t[u] for t in units[k]))
             for u in range(n) for k in sorted(units)] + list(st["rem"]))


def recurrent_gaps(torch, got, ref):
    """How far unit/rem run ``got`` is from run ``ref``: the largest
    |logit| gap over max |logit| per step; over the attention layers the
    largest gap of S and z (stabilizer factored out, as :func:`gaps`)
    over their max; and each RG-LRU layer's largest h and conv gap over
    that layer's max |h|, max |conv|."""
    (lg, _, sg), (lr, _, sr) = got, ref
    logit = [float((g - r).abs().max() / r.abs().max())
             for g, r in zip(lg, lr)]
    attn, rec_h, rec_conv = 0.0, [], []
    for g, r in zip(_layer_states(sg), _layer_states(sr)):
        for t in (*g, *r):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                fail("recurrent cross-device: non-finite state")
        if hasattr(g, "h"):
            rec_h.append(float((g.h - r.h).abs().max() / r.h.abs().max()))
            rec_conv.append(float((g.conv - r.conv).abs().max()
                                  / r.conv.abs().max()))
            continue
        rescale = torch.exp(g.c - r.c)
        for a, b in ((g.s * rescale, r.s), (g.z * rescale[..., 0], r.z)):
            attn = max(attn, float((a - b).abs().max() / b.abs().max()))
    return {"rel_max_err": logit, "state_rel_err": attn,
            "rec_h_rel_err": rec_h, "rec_conv_rel_err": rec_conv}


def rec_gate_fault(torch, params):
    """``params`` with each RG-LRU layer's gate weight ``wa`` taken from
    the next RG-LRU layer (cyclic), every other leaf shared."""
    units = params["units"]
    keys = [k for k in sorted(units) if "rec" in units[k]]
    n = units[keys[0]]["rec"]["wa"].shape[0]
    was = ([units[k]["rec"]["wa"][u] for u in range(n) for k in keys]
           + [b["rec"]["wa"] for b in params["rem"]])
    was = was[1:] + was[:1]
    new_units = dict(units)
    for j, k in enumerate(keys):
        new_units[k] = {**units[k], "rec": {**units[k]["rec"], "wa": torch.stack(
            [was[u * len(keys) + j] for u in range(n)])}}
    rem = [{**b, "rec": {**b["rec"], "wa": was[n * len(keys) + i]}}
           for i, b in enumerate(params["rem"])]
    return {**params, "units": new_units, "rem": rem}


def recurrent_cross_device(torch, dev, cfg, params):
    """Phase 4's recipe on the unit/rem layout: one ragged prefill chunk
    (2 rows of 64 and 40 tokens) and two decode steps, the card's kernel
    path against the CPU's plain path on the same params; logits within
    ``CROSS_DEVICE_TOL``, the local layers' S and z within ``STATE_TOL``,
    each RG-LRU layer's h and conv within ``REC_STATE_TOL``. A planted
    fault (each RG-LRU layer fed the next one's gate weight) must fail
    the same check. Returns (the JSON fields, a function that runs the
    checks)."""
    from repro_torch.models import lm

    cpu_cfg = dataclasses.replace(cfg, use_kernel=False)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 64))
    vl = np.array([64, 40], np.int32)
    card = drive(torch, lm, cfg, params, dev, toks, vl)
    cpu_params = lm.tree_map(lambda t: t.cpu(), params)
    cpu = drive(torch, lm, cpu_cfg, cpu_params, "cpu", toks, vl,
                feed=card[1])
    del cpu_params
    planted = drive(torch, lm, cfg, rec_gate_fault(torch, params), dev,
                    toks, vl, feed=card[1])
    got, fault = recurrent_gaps(torch, card, cpu), recurrent_gaps(
        torch, planted, cpu)
    fields = {**got, "tolerance": CROSS_DEVICE_TOL,
              "state_tolerance": STATE_TOL,
              "rec_state_tolerance": REC_STATE_TOL,
              "argmax_agreement": [
                  float((g.argmax(-1) == c.argmax(-1)).float().mean())
                  for g, c in zip(card[0], cpu[0])],
              "planted_fault": {"what": "each RG-LRU layer fed the next "
                                        "RG-LRU layer's gate weight wa",
                                **fault}}

    def within(r):
        return (max(r["rel_max_err"]) <= CROSS_DEVICE_TOL
                and r["state_rel_err"] <= STATE_TOL
                and max(r["rec_h_rel_err"] + r["rec_conv_rel_err"])
                <= REC_STATE_TOL)

    def check():
        if not within(got):
            fail(f"{RECURRENT} cross-device: card and CPU differ beyond "
                 f"their limits ({got})")
        if within(fault):
            fail(f"{RECURRENT} cross-device check passes a planted fault")
    return fields, check


def phase_recurrent(torch, dev, counters):
    """Phase 8: recurrentgemma-2b at full size (26 layers, 10 query heads
    on one KV head at d_head 256, m 256), random weights from seed 0
    drawn on the card, in the unit/rem layout. (a) 8 requests (prompts
    of 64-256 tokens, 16-32 new ones) through the overlapped scheduler
    under ``set_sync_debug_mode("error")``: full token counts,
    fused_kernel paths, B1 = decode steps x 8 and B2 = prefill calls x 8
    (only the local layers launch), no other kernel; TTFT, TPOT,
    throughput, init seconds and peak device memory. (b) 8 requests
    through both schedulers at ``prefill_rows=1``: equal greedy streams.
    (c) phase 3e's system-prompt traffic through cache-on and cache-less
    engines at ``prefill_rows=1``: forks of the RG-LRU's h and conv and
    the local layers' (S, z, c), streams equal, launches as in (a).
    (d) :func:`recurrent_cross_device` at the first 5 layers. Returns
    B1's and B2's launches in (a)."""
    import gc
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCacheConfig

    t0 = time.perf_counter()
    cfg = configs.get_config(RECURRENT, use_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = torch.cuda.memory_allocated() / 1e9
    fields, launches, _, st = serve(
        torch, dev, cfg, params, counters, overlap=True, requests=8,
        prompt_range=(64, 256), gen_range=(16, 32))
    t_eq = time.perf_counter()
    equal, eq_fields = overlap_equality(torch, dev, cfg, params)
    eq_fields["seconds"] = time.perf_counter() - t_eq
    t_pc = time.perf_counter()
    on, on_launches, s_on, _, d_on = prefix_serve(
        torch, dev, cfg, params, counters, PrefixCacheConfig(), 1)
    off, off_launches, s_off, _, d_off = prefix_serve(
        torch, dev, cfg, params, counters, None, 1)
    same = [a == b for x, y in zip(s_on, s_off) for a, b in zip(x, y)]
    prefix = {"cache_on": on, "cache_off": off, "tokens": len(same),
              "tokens_equal": sum(same) / len(same),
              "seconds": time.perf_counter() - t_pc}
    sub_cfg = dataclasses.replace(cfg, n_layers=RECURRENT_CROSS_LAYERS)
    sub = {**params, "units": lm.tree_map(
        lambda t: t[:sub_cfg.n_units], params["units"])}
    t_cross = time.perf_counter()
    cross, check = recurrent_cross_device(torch, dev, sub_cfg, sub)
    emit({"phase": "recurrent", "arch": RECURRENT, **fields,
          "layer_kinds": collections.Counter(cfg.layer_kinds()),
          "n_units": cfg.n_units, "n_rem": cfg.n_rem,
          "attn_layers": attn_layers(cfg), "window": cfg.window,
          "param_init_s": init_s, "param_gb": param_gb,
          "rows_1_equality": eq_fields, "prefix_cache_rows_1": prefix,
          "cross_device": {"n_layers": RECURRENT_CROSS_LAYERS, **cross,
                           "seconds": time.perf_counter() - t_cross},
          "seconds": time.perf_counter() - t0})
    for name, s_ in (("serving", st), ("prefix cache on", on),
                     ("prefix cache off", off)):
        if s_["prefill_path"] != "fused_kernel" or \
                s_["decode_path"] != "fused_kernel":
            fail(f"{RECURRENT} {name}: served {s_['prefill_path']}/"
                 f"{s_['decode_path']}")
    for name, got, stats in (("serving", launches, st),
                             ("prefix cache on", on_launches, d_on),
                             ("prefix cache off", off_launches, d_off)):
        want = fused_launches(counters, stats, cfg)
        if got != want:
            fail(f"{RECURRENT} {name}: launches {got}, expected {want} "
                 f"(prefill calls and decode steps x {attn_layers(cfg)} "
                 "local layers)")
    if not equal:
        fail(f"{RECURRENT}: greedy streams differ between the schedulers "
             f"with one staged row per prefill call ({eq_fields})")
    if d_on["forked_requests"] < 1 or d_on["prefix_hits"] < 1:
        fail(f"{RECURRENT}: no prefix-cache fork ({d_on})")
    if d_on["prefill_tokens"] + d_on["forked_tokens"] != on["prompt_tokens"]:
        fail(f"{RECURRENT}: {d_on['prefill_tokens']} prefilled + "
             f"{d_on['forked_tokens']} forked tokens, expected the "
             f"prompts' {on['prompt_tokens']}")
    if s_on != s_off:
        fail(f"{RECURRENT}: forked greedy streams differ from cold-start "
             f"ones ({sum(same)} of {len(same)} tokens equal)")
    check()
    out = {n: launches[n] for n in ("prf_fused_decode", "prf_fused_prefill")}
    del params, sub
    gc.collect()
    torch.cuda.empty_cache()
    return out


# phase 9: recurrentgemma-2b trained at full width by the train launcher
# (kernel on: B5 in the local layers, each again in its unit's
# recompute), 512-token rows at the launcher's default batch of 8, under
# the config's remat "dots". At its full 26 layers
# scripts/torch_train_memory.py on an H100 80GB HBM3, 700 W reads 74.30
# GB at 8 and 6 x 512, the functional AdamW update's peak (params,
# gradients, their clipped copy, old and new f32 moments: 74.31 GB at 5
# x 512 without remat), above the backward's; without remat 8 x 512 ran
# out and 5 was the largest batch. The phase runs 14 of the 26 layers (4
# units and both remainder layers, so the rem list stays): at 26 its 29
# GB checkpoint's save and restore took about 90 s, and the whole run
# 947 s with phase 10b, above its 900 s budget
REC_TRAIN_LAYERS = 14
REC_TRAIN_BATCH = 8


REC_TRAIN_STEPS = 4
# (c), (d): one unit and the two remainder layers, full width, bf16
REC_GRAD_LAYERS = 5


def rec_train_cross_device(torch, dev, kl, cfg, params):
    """Phase 9 (c): phase 6's check on recurrentgemma-2b's first 5 layers
    (``params``, full width, bf16), batch 2 x 256: one loss and every
    gradient, the card through B5 (the local layer) against the CPU's
    plain path; a planted fault (each RG-LRU layer fed the next one's
    gate weight, :func:`rec_gate_fault`) must fail the same check.
    Returns (the JSON fields, a function that runs the checks)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm

    data = SyntheticLM(cfg.vocab, 256, 2, seed=0).batch(0)
    kl.launches = 0
    card = loss_and_grads(torch, cfg, params, data, dev)
    card_launches = kl.launches
    cpu = loss_and_grads(torch, cpu_reference(cfg),
                         lm.tree_map(lambda t: t.cpu(), params), data, "cpu")
    fault = loss_and_grads(torch, cfg, rec_gate_fault(torch, params), data,
                           dev)
    loss_gap, grad_gap, where = train_gaps(torch, card, cpu)
    f_loss, f_grad, f_where = train_gaps(torch, fault, cpu)
    fields = {"n_layers": cfg.n_layers, "batch": 2, "seq": 256,
              "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
              "loss_rel_err": loss_gap, "grad_rel_err": grad_gap,
              "grad_worst_leaf": where, "loss_tolerance": TRAIN_LOSS_TOL,
              "grad_tolerance": TRAIN_GRAD_TOL, "launches": card_launches,
              "planted_fault": {"what": "each RG-LRU layer fed the next "
                                        "RG-LRU layer's gate weight wa",
                                "loss_rel_err": f_loss,
                                "grad_rel_err": f_grad,
                                "grad_worst_leaf": f_where}}

    def check():
        if card_launches != b5_per_step(cfg):
            fail(f"{RECURRENT} cross-device training: {card_launches} B5 "
                 f"launches for {attn_layers(cfg)} local layers, expected "
                 f"{b5_per_step(cfg)}")
        if loss_gap > TRAIN_LOSS_TOL or grad_gap > TRAIN_GRAD_TOL:
            fail(f"{RECURRENT} cross-device training: loss gap "
                 f"{loss_gap:.3e}, gradient gap {grad_gap:.3e} ({where})")
        if f_loss <= TRAIN_LOSS_TOL and f_grad <= TRAIN_GRAD_TOL:
            fail(f"{RECURRENT} cross-device training check passes a "
                 "planted fault")
    return fields, check


def calibrate_cross_device_at(torch, dev, kl, cfg, params, data, name,
                              want_launches):
    """Phase 9 (d) and 11 (b): ``lm.whitening_calibrate`` of ``params``
    (a few layers at full width, bf16, darkformer m 256) on ``data`` (a
    numpy 2 x 256 batch), on the card and on the CPU from the same
    params: B5 ``want_launches`` times (once a causal attention layer's
    tap; none for an encoder) and no other launch; the whitening gap max
    |M Lambda M^T - I| (Lambda in f64 from the card's taps) within
    ``WHITEN_TOL``; each (attention layer, group)'s Sigma = M^T M gap
    over its max |Sigma| within ``CAL_SIGMA_TOL``. A planted fault (the
    taps scaled by the d^-1/4 temperature a second time) must fail the
    Sigma check; ``name`` names the model in a failure. Returns (the
    JSON fields, a function that runs the checks)."""
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm

    batch = to_device(data, "cpu")
    card_batch = {k: t.to(dev) for k, t in batch.items()}
    cpu_cfg = dataclasses.replace(cfg, use_kernel=False)
    sound, seen = lm.collect_qk, {}

    def keep(*a, **kw):
        seen.update(sound(*a, **kw))
        return seen

    def twice(*a, **kw):
        t = cfg.head_dim ** -0.25
        return {n: (q * t, k * t) for n, (q, k) in sound(*a, **kw).items()}

    def calibrated(tap, p, c, b):
        try:
            lm.collect_qk = tap
            return attn_m(c, lm.whitening_calibrate(p, c, b))
        finally:
            lm.collect_qk = sound
    kl.launches = 0
    t0 = time.perf_counter()
    m_card = calibrated(keep, params, cfg, card_batch)
    cal_s = time.perf_counter() - t0
    launches = kl.launches
    white = whitening_gaps(torch, m_card, seen, cfg)
    seen.clear()
    m_cpu = calibrated(sound, lm.tree_map(lambda t: t.cpu(), params),
                       cpu_cfg, batch)
    m_card, m_fault = (lm.tree_map(lambda m: m.cpu(), x) for x in (
        m_card, calibrated(twice, params, cfg, card_batch)))

    def sigma_gaps(got):
        out = []
        for name, m in got.items():
            card_s, cpu_s = (sigma(torch, x[None])[0]
                             for x in (m, m_cpu[name]))
            out.append([float((card_s[gi] - cpu_s[gi]).abs().max()
                              / cpu_s[gi].abs().max())
                        for gi in range(cfg.n_kv)])
        return out
    got, fault = sigma_gaps(m_card), sigma_gaps(m_fault)
    fields = {"n_layers": cfg.n_layers, "batch": 2, "seq": 256,
              "attention_layers": list(m_card), "seconds": cal_s,
              "launches": launches, "whitening_gap": max(white),
              "whitening_tolerance": WHITEN_TOL, "sigma_rel_err": got,
              "sigma_tolerance": CAL_SIGMA_TOL,
              "planted_fault": {"what": "the taps scaled by the d^-1/4 "
                                        "temperature a second time",
                                "sigma_rel_err": fault}}

    def check():
        if launches != want_launches:
            fail(f"{name} calibration: {launches} B5 launches, expected "
                 f"{want_launches}")
        if not max(white) <= WHITEN_TOL:
            fail(f"{name} calibration: whitening gap {max(white):.3e}")
        if not max(max(r) for r in got) <= CAL_SIGMA_TOL:
            fail(f"{name} calibration card vs CPU: Sigma gap {got}")
        if not min(min(r) for r in fault) > CAL_SIGMA_TOL:
            fail(f"{name} calibration card vs CPU passes a planted "
                 f"fault ({fault})")
    return fields, check


def phase_recurrent_train(torch, dev, counters):
    """Phase 9: recurrentgemma-2b trained at full width and
    ``REC_TRAIN_LAYERS`` layers (``configs.cut_depth``) by the port's
    launcher (kernel on; params drawn on the host from seed 0, as the
    launcher draws them) for ``REC_TRAIN_STEPS`` steps of
    ``REC_TRAIN_BATCH`` x 512 tokens, checkpointed ({"params", "opt"},
    the ``rem`` list among them). (a) Losses finite, B5 = steps x 2 x
    the local layers and no other launch, the checkpoint written, step
    times, its seconds and bytes, peak device memory. (b) Phase 5b's
    ``serve --load`` of that checkpoint through B1/B2 (4 requests), its
    streams those of an engine on the params the run returned.
    (c) :func:`rec_train_cross_device` and (d)
    :func:`calibrate_cross_device_at` at 5 layers, full width, params
    from seed 0 drawn on the card. Returns the kernels' launches in (a)
    and (b)."""
    import gc
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import lm

    t0 = time.perf_counter()
    ck = ROOT / "build" / "chip_smoke_rec_ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    steps_n = REC_TRAIN_STEPS
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_train = time.perf_counter()
    with configs.cut_depth(REC_TRAIN_LAYERS):
        out = train.main(["--arch", RECURRENT, "--batch",
                          str(REC_TRAIN_BATCH), "--seq", str(L_TRAIN),
                          "--lr", "3e-4", "--warmup", "2", "--log-every",
                          "1", "--device", str(dev), "--steps",
                          str(steps_n), "--seed", "0", "--ckpt-dir",
                          str(ck), "--ckpt-every", str(steps_n)])
    reserved = torch.cuda.max_memory_reserved() / 1e9
    wall = time.perf_counter() - t_train
    launches = {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["config"]
    m = out["metrics"]
    losses = [x["loss"] for x in m]
    ms = [x["ms"] for x in m]
    saved = ckpt.all_steps(str(ck))
    ck_bytes = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
    # the params the run returned, which it saved: (b)'s engine serves
    # them beside the CLI's restore
    trained = out["params"]
    del out, m
    gc.collect()
    torch.cuda.empty_cache()
    train_fields = {
        "n_layers": cfg.n_layers, "full_depth": 26, "depth_cut": True,
        "d_model": cfg.d_model,
        "layer_kinds": collections.Counter(cfg.layer_kinds()),
        "n_rem": cfg.n_rem, "batch": REC_TRAIN_BATCH, "seq": L_TRAIN,
        "steps": steps_n, "loss": losses, "step_ms": ms,
        "step_ms_p50_after_first": float(np.percentile(ms[1:], 50)),
        "tokens_per_s": REC_TRAIN_BATCH * L_TRAIN
        / (float(np.percentile(ms[1:], 50)) / 1e3),
        "wall_s": wall, "launches": launches, "peak_mem_gb": peak,
        "peak_reserved_gb": reserved,
        "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF"),
        "checkpoint_steps": saved, "checkpoint_bytes": ck_bytes}
    want = {n: 0 for n in counters}
    want["linear_attention_causal"] = steps_n * b5_per_step(cfg)
    if cfg.n_layers != REC_TRAIN_LAYERS:
        fail(f"{RECURRENT} train: {cfg.n_layers} layers, expected "
             f"{REC_TRAIN_LAYERS}")
    if len(losses) != steps_n or not all(np.isfinite(losses)):
        fail(f"{RECURRENT} train: losses {losses}")
    if launches != want:
        fail(f"{RECURRENT} train: launches {launches}, expected {want}")
    if saved != [steps_n - 1]:
        fail(f"{RECURRENT} train: checkpoints {saved}")

    t_load = time.perf_counter()
    with configs.cut_depth(REC_TRAIN_LAYERS):
        serve_launches = phase_serve_load(torch, dev, counters, ck,
                                          trained, cfg,
                                          phase="recurrent_serve_load")
    del trained
    shutil.rmtree(ck, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    load_s = time.perf_counter() - t_load

    sub_cfg = dataclasses.replace(cfg, n_layers=REC_GRAD_LAYERS)
    sub = lm.init_params(sub_cfg, seed=0, device=dev, draw_on=dev)
    t_cross = time.perf_counter()
    kl = counters["linear_attention_causal"][0]
    grads, check_grads = rec_train_cross_device(torch, dev, kl, sub_cfg,
                                                sub)
    grads["seconds"] = time.perf_counter() - t_cross
    t_cal = time.perf_counter()
    cal, check_cal = calibrate_cross_device_at(
        torch, dev, kl, sub_cfg, sub,
        SyntheticLM(sub_cfg.vocab, 256, 2, seed=0).batch(0), RECURRENT,
        attn_layers(sub_cfg))
    cal["phase_seconds"] = time.perf_counter() - t_cal
    del sub
    emit({"phase": "recurrent_train", "arch": RECURRENT,
          "train": train_fields, "serve_load_seconds": load_s,
          "cross_device_training": grads, "calibration": cal,
          "seconds": time.perf_counter() - t0})
    check_grads()
    check_cal()
    gc.collect()
    torch.cuda.empty_cache()
    return {n: launches[n] + serve_launches[n] for n in counters}


# phase 10: rwkv6-7b at its full 32 layers and width (7.5 B params, 15 GB
# of bf16, drawn on the card), layer-stacked, no attention layer: the
# engine's path is "none" and no kernel of the port runs (its block runs
# the reference's sequential scan in plain PyTorch, not B7). (b) and (c)
# run its first 8 layers: the schedulers' equality and the forks hold at
# any depth, and its token loop made them 100 of the phase's 119 s at 32
# on an H100 80GB HBM3 at 700 W. (d) holds its first 2 layers card
# against CPU
RWKV = "rwkv6-7b"
RWKV_ROWS_LAYERS = 8
RWKV_CROSS_LAYERS = 2


def rwkv_gaps(torch, got, ref):
    """How far run ``got`` is from run ``ref`` (:func:`drive` on a
    stacked rwkv state): the largest |logit| gap over max |logit| per
    step, and each layer's largest gap of S, the time mix's shift and the
    channel mix's over that layer's max of each."""
    (lg, _, sg), (lr, _, sr) = got, ref
    sg, sr = sg["layers"], sr["layers"]
    for t in (*lg, *lr, *sg, *sr):
        if not bool(torch.isfinite(t).all()):
            fail("rwkv cross-device: non-finite logits or state")
    logit = [float((g - r).abs().max() / r.abs().max())
             for g, r in zip(lg, lr)]
    state = {name: [float((a[li] - b[li]).abs().max() / b[li].abs().max())
                    for li in range(a.shape[0])]
             for name, a, b in zip(sg._fields, sg, sr)}
    return {"rel_max_err": logit, "state_rel_err": state}


def rwkv_cross_device(torch, dev, cfg, params):
    """Phase 4's recipe on the rwkv stack: one ragged prefill chunk (2
    rows of 64 and 40 tokens) and two decode steps, card against CPU on
    the same params; logits within ``CROSS_DEVICE_TOL``, each layer's S,
    shift and cshift within ``REC_STATE_TOL`` (phase 8's limits). A
    planted fault (each layer's time mix fed the next layer's key weight
    wk) must fail the same check. Returns (the JSON fields, a function
    that runs the checks)."""
    from repro_torch.models import lm

    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 64))
    vl = np.array([64, 40], np.int32)
    card = drive(torch, lm, cfg, params, dev, toks, vl)
    cpu = drive(torch, lm, dataclasses.replace(cfg, use_kernel=False),
                lm.tree_map(lambda t: t.cpu(), params), "cpu", toks, vl,
                feed=card[1])
    layers = params["units"]["b0"]
    shifted = {**params, "units": {"b0": {**layers, "tmix": {
        **layers["tmix"], "wk": torch.roll(layers["tmix"]["wk"], 1, 0)}}}}
    planted = drive(torch, lm, cfg, shifted, dev, toks, vl, feed=card[1])
    got, fault = rwkv_gaps(torch, card, cpu), rwkv_gaps(torch, planted, cpu)
    fields = {**got, "tolerance": CROSS_DEVICE_TOL,
              "state_tolerance": REC_STATE_TOL,
              "argmax_agreement": [
                  float((g.argmax(-1) == c.argmax(-1)).float().mean())
                  for g, c in zip(card[0], cpu[0])],
              "planted_fault": {"what": "each layer's time mix fed the "
                                        "next layer's key weight wk",
                                **fault}}

    def within(r):
        return (max(r["rel_max_err"]) <= CROSS_DEVICE_TOL and
                max(max(v) for v in r["state_rel_err"].values())
                <= REC_STATE_TOL)

    def check():
        if not within(got):
            fail(f"{RWKV} cross-device: card and CPU differ beyond their "
                 f"limits ({got})")
        if within(fault):
            fail(f"{RWKV} cross-device check passes a planted fault")
    return fields, check


def phase_rwkv(torch, dev, counters):
    """Phase 10: rwkv6-7b at full size (32 layers, d_model 4096, 64 heads
    of 64), random weights from seed 0 drawn on the card, layer-stacked.
    (a) Phase 7's traffic (8 requests, prompts of 64-256 tokens, 16-32
    new ones) through the overlapped scheduler under
    ``set_sync_debug_mode("error")``: full token counts, paths ``none``;
    TTFT, TPOT, throughput, init seconds and peak device memory. At the
    first ``RWKV_ROWS_LAYERS`` layers: (b) 8 requests through both
    schedulers at ``prefill_rows=1``: equal greedy streams; (c) phase
    3e's system-prompt traffic through cache-on and cache-less engines
    at ``prefill_rows=1``: forks of the (S, shift, cshift) state,
    prefilled plus forked tokens equal to the prompts', equal greedy
    streams. None of the seven kernels launches anywhere in the phase.
    (d) :func:`rwkv_cross_device` at the first 2 layers."""
    import gc
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCacheConfig

    t0 = time.perf_counter()
    cfg = configs.get_config(RWKV, use_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    param_gb = torch.cuda.memory_allocated() / 1e9
    fields, launches, _, st = serve(
        torch, dev, cfg, params, counters, overlap=True, requests=8,
        prompt_range=(64, 256), gen_range=(16, 32))
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    rows_cfg = dataclasses.replace(cfg, n_layers=RWKV_ROWS_LAYERS)
    rows = {**params, "units": lm.tree_map(
        lambda t: t[:RWKV_ROWS_LAYERS], params["units"])}
    t_eq = time.perf_counter()
    equal, eq_fields = overlap_equality(torch, dev, rows_cfg, rows)
    eq_fields.update(n_layers=RWKV_ROWS_LAYERS,
                     seconds=time.perf_counter() - t_eq)
    eq_launches = {n: getattr(mod, attr)
                   for n, (mod, attr) in counters.items()}
    t_pc = time.perf_counter()
    on, on_launches, s_on, _, d_on = prefix_serve(
        torch, dev, rows_cfg, rows, counters, PrefixCacheConfig(), 1)
    off, off_launches, s_off, _, d_off = prefix_serve(
        torch, dev, rows_cfg, rows, counters, None, 1)
    same = [a == b for x, y in zip(s_on, s_off) for a, b in zip(x, y)]
    prefix = {"n_layers": RWKV_ROWS_LAYERS, "cache_on": on,
              "cache_off": off, "tokens": len(same),
              "tokens_equal": sum(same) / len(same),
              "seconds": time.perf_counter() - t_pc}
    sub_cfg = dataclasses.replace(cfg, n_layers=RWKV_CROSS_LAYERS)
    sub = {**params, "units": lm.tree_map(
        lambda t: t[:RWKV_CROSS_LAYERS], params["units"])}
    t_cross = time.perf_counter()
    cross, check = rwkv_cross_device(torch, dev, sub_cfg, sub)
    emit({"phase": "rwkv", "arch": RWKV, **fields,
          "param_init_s": init_s, "param_gb": param_gb,
          "rows_1_equality": eq_fields, "rows_1_launches": eq_launches,
          "prefix_cache_rows_1": prefix,
          "cross_device": {"n_layers": RWKV_CROSS_LAYERS, **cross,
                           "seconds": time.perf_counter() - t_cross},
          "seconds": time.perf_counter() - t0})
    for name, s_ in (("serving", st), ("prefix cache on", on),
                     ("prefix cache off", off)):
        if s_["prefill_path"] != "none" or s_["decode_path"] != "none":
            fail(f"{RWKV} {name}: served {s_['prefill_path']}/"
                 f"{s_['decode_path']}, expected none")
    for name, got in (("serving", launches), ("rows_1 equality",
                                              eq_launches),
                      ("prefix cache on", on_launches),
                      ("prefix cache off", off_launches)):
        if any(got.values()):
            fail(f"{RWKV} {name}: kernels launched ({got})")
    if not equal:
        fail(f"{RWKV}: greedy streams differ between the schedulers with "
             f"one staged row per prefill call ({eq_fields})")
    if d_on["forked_requests"] < 1 or d_on["prefix_hits"] < 1:
        fail(f"{RWKV}: no prefix-cache fork ({d_on})")
    if d_on["prefill_tokens"] + d_on["forked_tokens"] != on["prompt_tokens"]:
        fail(f"{RWKV}: {d_on['prefill_tokens']} prefilled + "
             f"{d_on['forked_tokens']} forked tokens, expected the "
             f"prompts' {on['prompt_tokens']}")
    if s_on != s_off:
        fail(f"{RWKV}: forked greedy streams differ from cold-start ones "
             f"({sum(same)} of {len(same)} tokens equal)")
    check()
    del params, sub, rows
    gc.collect()
    torch.cuda.empty_cache()
    return {n: launches[n] + eq_launches[n] + on_launches[n]
            + off_launches[n] for n in counters}


# phase 10b: rwkv6-7b trained at full width (d_model 4096, 64 heads of
# 64, d_ff 14 336, vocab 65 536) with its depth cut, params drawn on the
# card, under the config's remat "dots" and the launcher's AdamW with an
# unfactored second moment. 7.53 B params at 32 layers (218.6 M a layer,
# 0.537 B in the embed and head); the functional update holds params,
# gradients, their clipped copy and old and new f32 moments, about 22
# bytes a param, and the recomputed layer's token loop keeps about three
# (8, 64, 64, 64) f32 tensors a token (13 GB at 8 x 512), so 8 layers
# (2.29 B params) fit and 12 would need about 70-74 GB
# (scripts/torch_train_memory.py --arch rwkv6-7b --layers 8 12)
RWKV_TRAIN_LAYERS = 8
RWKV_TRAIN_BATCH = 8
RWKV_TRAIN_STEPS = 4
RWKV_GRAD_LAYERS = 2


def rwkv_decay_fault(torch, params):
    """``params`` with each rwkv layer's ``decay_a`` taken from the next
    layer (the last from the first)."""
    units = params["units"]["b0"]
    return {**params, "units": {"b0": {**units, "tmix": {
        **units["tmix"],
        "decay_a": torch.roll(units["tmix"]["decay_a"], -1, 0)}}}}


def loss_only(torch, cfg, params, data, device):
    """``lm.loss_fn`` on ``data`` moved to ``device``, without gradients,
    as a CPU scalar."""
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm

    with torch.no_grad():
        loss, _ = lm.loss_fn(params, cfg, to_device(data, device))
    return loss.cpu()


def rwkv_train_cross_device(torch, dev, counters, cfg, params):
    """Phase 10b (b): phase 6's check on rwkv6-7b's first
    ``RWKV_GRAD_LAYERS`` layers (``params``, full width), one 2 x 256
    SyntheticLM batch from seed 0, phase 11 (b)'s rule: one loss and
    every gradient on the card against the CPU in bf16, every gradient
    within ``TRAIN_GRAD_TOL`` of its leaf's max; the loss again with the
    same params in f32 (no gradient: card and CPU forward), within
    ``TRAIN_LOSS_TOL``. The bf16 loss gap is reported beside each bf16
    side's distance to the CPU's f32 loss, not held to that limit: bf16
    rounding alone sets it (3.1e-5 on an H100 80GB HBM3 at 700 W, where
    the f32 gap read 8.3e-8). A planted fault (:func:`rwkv_decay_fault` on
    the card) must fail both. No kernel launches. Returns (the JSON
    fields, the checks)."""
    from repro_torch.data import SyntheticLM
    from repro_torch.models import lm

    data = SyntheticLM(cfg.vocab, 256, 2, seed=0).batch(0)
    zero_counts(counters)
    t0 = time.perf_counter()
    card = loss_and_grads(torch, cfg, params, data, dev)
    cpu = loss_and_grads(torch, cpu_reference(cfg),
                         lm.tree_map(lambda t: t.cpu(), params), data, "cpu")
    fault = loss_and_grads(torch, cfg, rwkv_decay_fault(torch, params),
                           data, dev)
    loss_gap, grad_gap, where = train_gaps(torch, card, cpu)
    f_loss, f_grad, f_where = train_gaps(torch, fault, cpu)
    bf16 = {"loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
            "loss_rel_err": loss_gap, "grad_rel_err": grad_gap,
            "grad_worst_leaf": where,
            "planted_fault": {"loss_rel_err": f_loss,
                              "grad_rel_err": f_grad,
                              "grad_worst_leaf": f_where}}
    del card, cpu, fault
    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = lm.tree_map(lambda t: t.float(), params)
    l_card = loss_only(torch, c32, p32, data, dev)
    l_cpu = loss_only(torch, cpu_reference(c32),
                      lm.tree_map(lambda t: t.cpu(), p32), data, "cpu")
    l_fault = loss_only(torch, c32, rwkv_decay_fault(torch, p32), data, dev)
    del p32
    launches = launch_counts(counters)

    def rel(a):
        return float((a - l_cpu).abs() / l_cpu.abs())
    f32 = {"loss_card": float(l_card), "loss_cpu": float(l_cpu),
           "loss_rel_err": rel(l_card),
           "planted_fault": {"loss_rel_err": rel(l_fault)}}
    bf16["loss_card_vs_cpu_f32"] = rel(torch.tensor(bf16["loss_card"]))
    bf16["loss_cpu_vs_cpu_f32"] = rel(torch.tensor(bf16["loss_cpu"]))
    fields = {"n_layers": cfg.n_layers, "batch": 2, "seq": 256,
              "bfloat16": bf16, "float32": f32,
              "loss_tolerance": TRAIN_LOSS_TOL,
              "loss_tolerance_applies_to": "float32",
              "grad_tolerance": TRAIN_GRAD_TOL,
              "grad_tolerance_applies_to": "bfloat16",
              "planted_fault": "each rwkv layer fed the next layer's "
                               "decay_a",
              "launches": launches, "seconds": time.perf_counter() - t0}

    def check():
        if any(launches.values()):
            fail(f"{RWKV} cross-device training: kernels launched "
                 f"({launches})")
        if grad_gap > TRAIN_GRAD_TOL:
            fail(f"{RWKV} cross-device training bfloat16: gradient gap "
                 f"{grad_gap:.3e} ({where})")
        if f_grad <= TRAIN_GRAD_TOL:
            fail(f"{RWKV} cross-device training bfloat16 check passes a "
                 "planted fault")
        if f32["loss_rel_err"] > TRAIN_LOSS_TOL:
            fail(f"{RWKV} cross-device training float32: loss gap "
                 f"{f32['loss_rel_err']:.3e}")
        if f32["planted_fault"]["loss_rel_err"] <= TRAIN_LOSS_TOL:
            fail(f"{RWKV} cross-device training float32 check passes a "
                 "planted fault")
    return fields, check


def phase_rwkv_train(torch, dev, counters):
    """Phase 10b: rwkv6-7b at full width and ``RWKV_TRAIN_LAYERS``
    layers (``configs.get_config(..., n_layers=)``: the launcher has no
    depth flag, as the reference's has none), params from seed 0 drawn
    on the card. (a) ``RWKV_TRAIN_STEPS`` steps of
    ``launch.steps.make_train_step`` (the launcher's step, its
    ``AdamWConfig(lr=3e-4)`` and cosine schedule) on SyntheticLM batches
    of ``RWKV_TRAIN_BATCH`` x 512 under remat "dots": losses finite, no
    kernel launched, step ms (synchronised), peak device memory. (b)
    :func:`rwkv_train_cross_device` on the first ``RWKV_GRAD_LAYERS``
    layers of the same draw. Returns each kernel's launches (all 0)."""
    import gc
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import cosine_warmup
    from repro_torch.tree import flatten

    t0 = time.perf_counter()
    cfg = configs.get_config(RWKV, n_layers=RWKV_TRAIN_LAYERS,
                             use_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
    opt_cfg = AdamWConfig(lr=3e-4)
    opt = adamw_init(params, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    step = steps.make_train_step(cfg, opt_cfg,
                                 cosine_warmup(3e-4, 2, RWKV_TRAIN_STEPS))
    data = SyntheticLM(cfg.vocab, L_TRAIN, RWKV_TRAIN_BATCH, seed=0)
    zero_counts(counters)
    losses, ms = [], []
    for s_ in range(RWKV_TRAIN_STEPS):
        batch = to_device(data.batch(s_), dev)
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch, s_)
        losses.append(float(m["loss"]))                 # synchronises
        ms.append((time.perf_counter() - t1) * 1e3)
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    reserved = torch.cuda.max_memory_reserved() / 1e9
    del opt
    gc.collect()
    torch.cuda.empty_cache()
    train_fields = {
        "n_layers": cfg.n_layers, "full_depth": 32, "depth_cut": True,
        "d_model": cfg.d_model, "n_heads": cfg.n_heads, "d_ff": cfg.d_ff,
        "vocab": cfg.vocab, "remat": cfg.remat,
        "params": sum(t.numel() for _, t in flatten(params)),
        "factored_second_moment": False, "batch": RWKV_TRAIN_BATCH,
        "seq": L_TRAIN, "steps": RWKV_TRAIN_STEPS, "loss": losses,
        "step_ms": ms, "step_ms_p50": float(np.percentile(ms, 50)),
        "step_ms_max": max(ms),
        "tokens_per_s": RWKV_TRAIN_BATCH * L_TRAIN
        / (float(np.percentile(ms[1:], 50)) / 1e3),
        "init_s": init_s, "params_and_opt_gb": state_gb,
        "peak_mem_gb": peak, "peak_reserved_gb": reserved,
        "launches": launches}
    # the trained draw's first layers for (b): a fresh draw would cost a
    # second init; (b) holds the card against the CPU on the same params
    sub_cfg = dataclasses.replace(cfg, n_layers=RWKV_GRAD_LAYERS)
    sub = {**params, "units": lm.tree_map(
        lambda t: t[:RWKV_GRAD_LAYERS].clone(), params["units"])}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cross, check = rwkv_train_cross_device(torch, dev, counters, sub_cfg,
                                           sub)
    del sub
    emit({"phase": "rwkv_train", "arch": RWKV, "train": train_fields,
          "cross_device_training": cross,
          "seconds": time.perf_counter() - t0})
    if len(losses) != RWKV_TRAIN_STEPS or not all(np.isfinite(losses)):
        fail(f"{RWKV} train: losses {losses}")
    if any(launches.values()):
        fail(f"{RWKV} train: kernels launched ({launches})")
    check()
    gc.collect()
    torch.cuda.empty_cache()
    return {n: launches[n] + cross["launches"][n] for n in counters}


# phase 11: the non-text modalities. hubert-xlarge at its full 48 layers
# (0.97 B params, 1.9 GB of bf16: nothing cut) trained by the launcher on
# masked audio frames; internvl2-76b at full width with its depth cut
# (0.86 B params a layer and 2.1 B in its embed and head: 152 GB of bf16
# at 80 layers, on an 80 GB card): VLM_SERVE_LAYERS layers served,
# VLM_CROSS_LAYERS held card against CPU, VLM_TRAIN_LAYERS trained: the
# largest depth whose train step fits (scripts/torch_train_memory.py), and
# only with AdamW's factored second moment. Unfactored, the functional
# update holds old and new f32 moments of the 2.1 B embed and head params
# beside f32 temporaries of a 1.05 B-param leaf and runs out at 1 layer
# and any batch; factored (the reference's option, which its dry-run
# takes above 1e11 params), 1 layer peaks at 62 GB and 2 run out
HUBERT = "hubert-xlarge"
# 512-frame rows a step: the memory probe reads 45 GB at 8, 62 at 12 and
# 78.9 of the card's 79.2 at 16, which leaves the launcher no room
HUBERT_TRAIN_BATCH = 12
HUBERT_TRAIN_STEPS = 4
HUBERT_CROSS_LAYERS = 2
VLM = "internvl2-76b"
VLM_SERVE_LAYERS = 4
VLM_ROWS = 4
VLM_PROMPTS = (64, 256)         # text tokens after the 256 patches
VLM_DECODE_STEPS = 32
VLM_TRAIN_LAYERS = 1
VLM_TRAIN_BATCH = 4
VLM_TRAIN_SEQ = 256             # text tokens after the 256 patches
VLM_TRAIN_STEPS = 3
VLM_CROSS_LAYERS = 2
VLM_CROSS_TEXT = 32
VLM_CROSS_STEPS = 8


def launch_counts(counters) -> dict:
    return {n: getattr(mod, attr) for n, (mod, attr) in counters.items()}


def zero_counts(counters) -> None:
    for mod, attr in counters.values():
        setattr(mod, attr, 0)


def hubert_train(torch, dev, counters):
    """Phase 11 (a): hubert-xlarge at full size trained by the launcher
    (params from seed 0 drawn on the host, as the launcher draws them)
    for ``HUBERT_TRAIN_STEPS`` steps of ``HUBERT_TRAIN_BATCH`` x 512
    masked audio frames (SyntheticAudio seed 0). Its attention is
    noncausal, the reference's two-matmul form, so no kernel launches.
    Returns (the JSON fields, a function that runs the checks, the
    launches)."""
    from repro_torch.launch import train

    zero_counts(counters)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = []
    t0 = time.perf_counter()
    out = train.main(
        ["--arch", HUBERT, "--batch", str(HUBERT_TRAIN_BATCH), "--seq",
         str(L_TRAIN), "--lr", "3e-4", "--warmup", "2", "--log-every", "1",
         "--device", str(dev), "--steps", str(HUBERT_TRAIN_STEPS),
         "--seed", "0"],
        on_step=lambda s: first.append(time.perf_counter()) if s == 0
        else None)
    wall = time.perf_counter() - t0
    launches = launch_counts(counters)
    cfg, m = out["config"], out["metrics"]
    del out
    losses, ms = [x["loss"] for x in m], [x["ms"] for x in m]
    p50 = float(np.percentile(ms[1:], 50))
    fields = {
        "n_layers": cfg.n_layers, "d_model": cfg.d_model,
        "heads": [cfg.n_heads, cfg.n_kv, cfg.head_dim],
        "causal": cfg.causal, "batch": HUBERT_TRAIN_BATCH, "seq": L_TRAIN,
        "steps": HUBERT_TRAIN_STEPS, "loss": losses, "step_ms": ms,
        "step_ms_p50_after_first": p50,
        "tokens_per_s": HUBERT_TRAIN_BATCH * L_TRAIN / (p50 / 1e3),
        "init_s": first[0] - t0 - ms[0] / 1e3, "wall_s": wall,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches": launches}

    def check():
        if len(losses) != HUBERT_TRAIN_STEPS or not all(np.isfinite(losses)):
            fail(f"{HUBERT} train: losses {losses}")
        if any(launches.values()):
            fail(f"{HUBERT} train: kernels launched ({launches}); its "
                 "noncausal attention has no kernel")
    return fields, check, launches


def hubert_cross_device(torch, dev, counters, seed: int = 0):
    """Phase 11 (b): hubert-xlarge's first ``HUBERT_CROSS_LAYERS`` layers
    at full width, params drawn on the card and one 2 x 256
    SyntheticAudio batch, both from ``seed``: one loss and every
    gradient on the card against the CPU, in bf16 and again with the
    same params in f32. Every gradient within ``TRAIN_GRAD_TOL`` of its
    leaf's max in both, the f32 loss within ``TRAIN_LOSS_TOL``; the bf16
    loss gap is reported beside each bf16 side's distance to the CPU's
    f32 loss, not held to that limit: its bf16 logits round 504-way over
    the masked frames alone (141 of 512 at seed 0), and card and CPU sit
    1.5e-5 to 8.4e-5 apart over seeds 0-3 (scripts/torch_train_gap_seeds.py
    --arch hubert-xlarge), where phase 6's smollm-135m reads 3.4e-6 to
    5.5e-6. A planted fault (the mask ignored on the card: no
    ``mask_embed`` at the masked frames, the loss over every frame) must
    fail both. Then :func:`calibrate_cross_device_at` on the same batch
    in bf16 (no B5 launch: the taps run the noncausal forward). No kernel
    launches anywhere. Returns (the JSON fields, the checks)."""
    from repro_torch import configs
    from repro_torch.data import SyntheticAudio
    from repro_torch.models import lm

    cfg = configs.get_config(HUBERT, n_layers=HUBERT_CROSS_LAYERS,
                             use_kernel=True)
    params = lm.init_params(cfg, seed=seed, device=dev, draw_on=dev)
    data = SyntheticAudio(cfg.d_model, 256, 2, vocab=cfg.vocab,
                          seed=seed).batch(0)
    no_mask = {k: v for k, v in data.items() if k != "mask"}
    zero_counts(counters)
    t0 = time.perf_counter()
    runs = {}
    for dtype in ("bfloat16", "float32"):
        # bf16: the params as drawn (the feature params stay f32); f32:
        # every leaf upcast
        c = dataclasses.replace(cfg, dtype=dtype)
        p = (params if dtype == cfg.dtype
             else lm.tree_map(lambda t: t.float(), params))
        runs[dtype] = (
            loss_and_grads(torch, c, p, data, dev),
            loss_and_grads(torch, cpu_reference(c),
                           lm.tree_map(lambda t: t.cpu(), p), data, "cpu"),
            loss_and_grads(torch, c, p, no_mask, dev))
    launches = launch_counts(counters)
    gaps_ = {}
    for dtype, (card, cpu, fault) in runs.items():
        loss_gap, grad_gap, where = train_gaps(torch, card, cpu)
        f_loss, f_grad, f_where = train_gaps(torch, fault, cpu)
        gaps_[dtype] = {
            "loss_card": float(card[0]), "loss_cpu": float(cpu[0]),
            "loss_rel_err": loss_gap, "grad_rel_err": grad_gap,
            "grad_worst_leaf": where,
            "embed_grad_max": float(card[1]["['embed']"].abs().max()),
            "planted_fault": {"loss_rel_err": f_loss,
                              "grad_rel_err": f_grad,
                              "grad_worst_leaf": f_where}}
    f32_loss = runs["float32"][1][0]
    for side, i in (("card", 0), ("cpu", 1)):
        gaps_["bfloat16"][f"loss_{side}_vs_cpu_f32"] = float(
            (runs["bfloat16"][i][0] - f32_loss).abs() / f32_loss.abs())
    grads = {"n_layers": cfg.n_layers, "batch": 2, "seq": 256,
             "seed": seed, "masked_frames": int(data["mask"].sum()),
             **gaps_, "loss_tolerance": TRAIN_LOSS_TOL,
             "loss_tolerance_applies_to": "float32",
             "grad_tolerance": TRAIN_GRAD_TOL,
             "planted_fault": "the mask ignored on the card",
             "seconds": time.perf_counter() - t0}
    del runs
    t1 = time.perf_counter()
    kl = counters["linear_attention_causal"][0]
    cal, check_cal = calibrate_cross_device_at(torch, dev, kl, cfg, params,
                                               data, HUBERT, 0)
    cal["phase_seconds"] = time.perf_counter() - t1
    launches_cal = launch_counts(counters)
    del params

    def check():
        if any(launches.values()) or any(launches_cal.values()):
            fail(f"{HUBERT} cross-device: kernels launched ({launches}, "
                 f"{launches_cal})")
        for dtype, g in gaps_.items():
            if g["embed_grad_max"] != 0.0:
                fail(f"{HUBERT} cross-device {dtype}: embed, which has no "
                     f"path to the loss, got a gradient "
                     f"({g['embed_grad_max']})")
            if g["grad_rel_err"] > TRAIN_GRAD_TOL:
                fail(f"{HUBERT} cross-device {dtype}: gradient gap "
                     f"{g['grad_rel_err']:.3e} ({g['grad_worst_leaf']})")
            f = g["planted_fault"]
            if f["loss_rel_err"] <= TRAIN_LOSS_TOL and \
                    f["grad_rel_err"] <= TRAIN_GRAD_TOL:
                fail(f"{HUBERT} cross-device {dtype} check passes a "
                     "planted fault")
        if gaps_["float32"]["loss_rel_err"] > TRAIN_LOSS_TOL:
            fail(f"{HUBERT} cross-device float32: loss gap "
                 f"{gaps_['float32']['loss_rel_err']:.3e}")
        check_cal()
    return {"cross_device_training": grads, "calibration": cal}, check


def vlm_serve(torch, dev, counters, cfg, params):
    """Phase 11 (c): ``VLM_ROWS`` rows of 256 patches (SyntheticVLM seed 0)
    and a prompt of each length in ``VLM_PROMPTS`` through one
    ``lm.prefill`` (B2, the whole row in one call: L = 320 and 512, two
    T-chunks), then ``VLM_DECODE_STEPS`` greedy ``lm.decode_step`` calls
    (B1) against the engine's precomposed projection, under
    ``set_sync_debug_mode("error")``: B2 = prefill calls x layers, B1 =
    decode steps x layers and no other launch; ``pos`` num_patches +
    prompt after the prefill and + decode steps after them; every logit
    finite. Prefill ms and TPOT from CUDA events. Returns (the JSON
    fields, the checks, the launches)."""
    from repro_torch.data import SyntheticVLM
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm

    runs, bad = [], []
    total = dict.fromkeys(counters, 0)
    proj = lm.build_decode_proj(params, cfg)
    for n_text in VLM_PROMPTS:
        data = SyntheticVLM(cfg.d_model, cfg.num_patches, n_text, VLM_ROWS,
                            cfg.vocab, seed=0).batch(0)
        batch = to_device({k: data[k] for k in ("tokens", "patch_embeds")},
                          dev)
        max_len = cfg.num_patches + n_text + VLM_DECODE_STEPS
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(VLM_DECODE_STEPS + 2)]
        finite = []
        torch.cuda.synchronize()
        zero_counts(counters)
        torch.cuda.set_sync_debug_mode("error")
        try:
            ev[0].record()
            logits, st = lm.prefill(params, cfg, batch, max_len)
            ev[1].record()
            pos_prefill = st["pos"].clone()
            finite.append(torch.isfinite(logits).all())
            tok = logits[:, 0].argmax(-1)
            for i in range(VLM_DECODE_STEPS):
                logits, st = lm.decode_step(params, cfg, tok, st, proj=proj)
                ev[i + 2].record()
                finite.append(torch.isfinite(logits).all())
                tok = logits.argmax(-1)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = launch_counts(counters)
        for n in total:
            total[n] += launches[n]
        tpot = [ev[i].elapsed_time(ev[i + 1])
                for i in range(1, VLM_DECODE_STEPS + 1)]
        want = {**dict.fromkeys(counters, 0),
                "prf_fused_prefill": cfg.n_layers,
                "prf_fused_decode": VLM_DECODE_STEPS * cfg.n_layers}
        pos = [int(pos_prefill), int(st["pos"])]
        run = {"rows": VLM_ROWS, "patches": cfg.num_patches,
               "prompt": n_text, "prefill_len": cfg.num_patches + n_text,
               "prefill_ms": ev[0].elapsed_time(ev[1]),
               "tpot_p50_ms": float(np.percentile(tpot, 50)),
               "tpot_p99_ms": float(np.percentile(tpot, 99)),
               "decode_steps": VLM_DECODE_STEPS, "pos": pos,
               "launches": launches}
        runs.append(run)
        if launches != want:
            bad.append(f"launches {launches}, expected {want}")
        if pos != [cfg.num_patches + n_text,
                   cfg.num_patches + n_text + VLM_DECODE_STEPS]:
            bad.append(f"pos {pos} at prompt {n_text}")
        if not all(bool(f) for f in finite):
            bad.append(f"non-finite logits at prompt {n_text}")
        del st, logits

    def check():
        if bad:
            fail(f"{VLM} serving: {'; '.join(bad)}")
    return runs, check, total


def vlm_prefill_timing(torch, dev, kp, cfg):
    """B2 alone at phase 11 (c)'s calls (``VLM_ROWS`` rows, internvl2-76b's
    heads, bf16, all rows full) over 256 tokens (one T-chunk) and 256
    patches + each of ``VLM_PROMPTS`` (two), with its bound (as
    :func:`prefill_grant_timing`): whether a call's time grows with its
    T-chunks. These timing calls are not counted on the path."""
    from repro_torch.kernels import check as kc

    g, hg, d, m = (cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.head_dim,
                   cfg.attn.num_features)
    out = []
    for l in (256, *(cfg.num_patches + n for n in VLM_PROMPTS)):
        args = kc.make_inputs(dev, VLM_ROWS, g, hg, d, m, d, l, True,
                              seed=9, dtype=torch.bfloat16)
        q, k, v, a, mm, s, z, c = args
        rows = VLM_ROWS * l
        byts = (nbytes(q, k, v, a, mm) + 2 * nbytes(s, z, c)
                + nbytes(v) * hg)
        flops = (feature_flops(rows * g * hg, rows * g, d, d, m, True)
                 + rows * g * hg * (4 * m * d + 4 * m))
        bms, by = bound(byts, flops)
        out.append({"shape": f"B={VLM_ROWS} L={l} G={g} Hg={hg} d={d} "
                             f"m={m} dv={d} bf16",
                    "t_chunks": -(-l // 256),
                    **kernel_times(torch, lambda: kp.fused_prf_prefill(
                        *args, eps=1e-8), 20),
                    "bound_ms": bms, "bound_by": by})
    return out


def vlm_drive(torch, lm, cfg, params, dev, data, feed=None):
    """``lm.prefill`` of ``data`` (numpy tokens and patches, or tokens
    alone for a text ``cfg``), then ``VLM_CROSS_STEPS`` decode steps, each
    fed ``feed[i]`` or the argmax before it. Returns (each step's logits
    on the CPU, the tokens fed, the final state on the CPU)."""
    from repro_torch.launch.train import to_device
    from repro_torch.serving import slots as slot_ops

    keys = ("tokens", "patch_embeds") if cfg.modality == "vlm" else (
        "tokens",)
    logits, st = lm.prefill(params, cfg, to_device(
        {k: data[k] for k in keys}, dev), max_len=512)
    out, fed = [logits[:, 0].float().cpu()], []
    for i in range(VLM_CROSS_STEPS):
        fed.append(out[-1].argmax(-1) if feed is None else feed[i])
        logits, st = lm.decode_step(params, cfg, fed[-1].to(dev), st)
        out.append(logits.float().cpu())
    return out, fed, slot_ops.tree_slot_map(lambda t, axis: t.cpu(), st)


def vlm_cross_device(torch, dev, cfg, params):
    """Phase 11 (e): phase 4's check on internvl2-76b's served params'
    first ``VLM_CROSS_LAYERS`` layers (full width, bf16): one row of 256
    patches and ``VLM_CROSS_TEXT`` tokens through ``lm.prefill``, then
    ``VLM_CROSS_STEPS`` decode steps, the card through B2/B1 against the
    CPU's plain path fed the card's tokens: every step's logits within
    ``CROSS_DEVICE_TOL`` of max |logit|, each layer's S and z within
    ``STATE_TOL``, ``pos`` equal. A planted fault (the patches dropped on
    the card: the prompt's tokens alone) must fail. Returns (the JSON
    fields, the checks)."""
    from repro_torch.data import SyntheticVLM
    from repro_torch.models import lm

    data = SyntheticVLM(cfg.d_model, cfg.num_patches, VLM_CROSS_TEXT, 1,
                        cfg.vocab, seed=1).batch(0)
    t0 = time.perf_counter()
    card = vlm_drive(torch, lm, cfg, params, dev, data)
    t_cpu = time.perf_counter()
    cpu = vlm_drive(torch, lm, dataclasses.replace(cfg, use_kernel=False),
                    lm.tree_map(lambda t: t.cpu(), params), "cpu", data,
                    feed=card[1])
    cpu_s = time.perf_counter() - t_cpu
    planted = vlm_drive(torch, lm, dataclasses.replace(cfg, modality="text"),
                        params, dev, data, feed=card[1])
    logit_err, state_err = gaps(torch, card, cpu)
    fault_logit, fault_state = gaps(torch, planted, cpu)
    pos = [int(card[2]["pos"]), int(cpu[2]["pos"])]
    fields = {"n_layers": cfg.n_layers, "patches": cfg.num_patches,
              "prompt": VLM_CROSS_TEXT, "decode_steps": VLM_CROSS_STEPS,
              "rel_max_err": logit_err, "state_rel_err": state_err,
              "tolerance": CROSS_DEVICE_TOL, "state_tolerance": STATE_TOL,
              "argmax_agreement": [
                  float((g.argmax(-1) == c.argmax(-1)).float().mean())
                  for g, c in zip(card[0], cpu[0])],
              "pos": pos, "cpu_seconds": cpu_s,
              "planted_fault": {"what": "the patches dropped on the card",
                                "rel_max_err": fault_logit,
                                "state_rel_err": fault_state},
              "seconds": time.perf_counter() - t0}

    def check():
        want = cfg.num_patches + VLM_CROSS_TEXT + VLM_CROSS_STEPS
        if pos != [want, want]:
            fail(f"{VLM} cross-device: pos {pos}, expected {want}")
        if max(logit_err) > CROSS_DEVICE_TOL:
            fail(f"{VLM} cross-device logits differ by {max(logit_err):.3e} "
                 "of max |logit|")
        if state_err > STATE_TOL:
            fail(f"{VLM} cross-device state differs by {state_err:.3e} of "
                 "its max")
        if max(fault_logit) <= CROSS_DEVICE_TOL and \
                fault_state <= STATE_TOL:
            fail(f"{VLM} cross-device check passes a planted fault")
    return fields, check


def vlm_train(torch, dev, counters):
    """Phase 11 (d): internvl2-76b at full width and ``VLM_TRAIN_LAYERS``
    layers (params from seed 0 drawn on the card), ``VLM_TRAIN_STEPS``
    steps of ``launch.steps.make_train_step`` (the launcher's AdamW and
    cosine schedule; the launcher has no depth flag) on SyntheticVLM
    batches of ``VLM_TRAIN_BATCH`` rows of 256 patches and
    ``VLM_TRAIN_SEQ`` tokens: losses finite, B5 = steps x layers and no
    other launch; step ms (synchronised) and peak device memory. Returns
    (the JSON fields, the checks, the launches)."""
    import gc
    from repro_torch import configs
    from repro_torch.data import SyntheticVLM
    from repro_torch.launch import steps
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import cosine_warmup

    cfg = configs.get_config(VLM, n_layers=VLM_TRAIN_LAYERS, use_kernel=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
    opt_cfg = AdamWConfig(lr=3e-4, factored_second_moment=True)
    opt = adamw_init(params, opt_cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = steps.make_train_step(cfg, opt_cfg,
                                 cosine_warmup(3e-4, 2, VLM_TRAIN_STEPS))
    data = SyntheticVLM(cfg.d_model, cfg.num_patches, VLM_TRAIN_SEQ,
                        VLM_TRAIN_BATCH, cfg.vocab, seed=0)
    zero_counts(counters)
    losses, ms = [], []
    for s in range(VLM_TRAIN_STEPS):
        batch = to_device(data.batch(s), dev)
        t1 = time.perf_counter()
        params, opt, m = step(params, opt, batch, s)
        losses.append(float(m["loss"]))                 # synchronises
        ms.append((time.perf_counter() - t1) * 1e3)
    launches = launch_counts(counters)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()
    want = {**dict.fromkeys(counters, 0),
            "linear_attention_causal": VLM_TRAIN_STEPS * b5_per_step(cfg)}
    fields = {"n_layers": cfg.n_layers, "batch": VLM_TRAIN_BATCH,
              "patches": cfg.num_patches, "text": VLM_TRAIN_SEQ,
              "steps": VLM_TRAIN_STEPS, "factored_second_moment": True,
              "loss": losses, "step_ms": ms,
              "tokens_per_s": VLM_TRAIN_BATCH * (cfg.num_patches
                                                 + VLM_TRAIN_SEQ)
              / (float(np.percentile(ms[1:], 50)) / 1e3),
              "init_s": init_s, "peak_mem_gb": peak, "launches": launches}

    def check():
        if len(losses) != VLM_TRAIN_STEPS or not all(np.isfinite(losses)):
            fail(f"{VLM} train: losses {losses}")
        if launches != want:
            fail(f"{VLM} train: launches {launches}, expected {want}")
    return fields, check, launches


def phase_modalities(torch, dev, counters):
    """Phase 11: the non-text modalities. hubert-xlarge: (a)
    :func:`hubert_train` at full size, (b) :func:`hubert_cross_device` at
    2 layers; internvl2-76b at full width with its depth cut: (c)
    :func:`vlm_serve` at ``VLM_SERVE_LAYERS`` layers drawn on the card,
    (e) :func:`vlm_cross_device` on their first ``VLM_CROSS_LAYERS``,
    (d) :func:`vlm_train` at ``VLM_TRAIN_LAYERS``. One line an arch.
    Returns {arch: each kernel's launches in its runs}."""
    import gc
    from repro_torch import configs
    from repro_torch.models import lm

    t0 = time.perf_counter()
    train_fields, check_train, h_launches = hubert_train(torch, dev,
                                                         counters)
    gc.collect()
    torch.cuda.empty_cache()
    cross, check_cross = hubert_cross_device(torch, dev, counters)
    emit({"phase": "modalities", "arch": HUBERT, "train": train_fields,
          **cross, "seconds": time.perf_counter() - t0})
    check_train()
    check_cross()
    gc.collect()
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    cfg = configs.get_config(VLM, use_kernel=True)
    full_depth = cfg.n_layers
    cfg = dataclasses.replace(cfg, n_layers=VLM_SERVE_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t1
    param_gb = torch.cuda.memory_allocated() / 1e9
    b2_timing = vlm_prefill_timing(
        torch, dev, counters["prf_fused_prefill"][0], cfg)
    runs, check_serve, v_launches = vlm_serve(torch, dev, counters, cfg,
                                              params)
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    sub_cfg = dataclasses.replace(cfg, n_layers=VLM_CROSS_LAYERS)
    sub = {**params, "units": {"b0": lm.tree_map(
        lambda t: t[:VLM_CROSS_LAYERS], params["units"]["b0"])}}
    vcross, check_vcross = vlm_cross_device(torch, dev, sub_cfg, sub)
    del params, sub
    gc.collect()
    torch.cuda.empty_cache()
    vtrain, check_vtrain, t_launches = vlm_train(torch, dev, counters)
    emit({"phase": "modalities", "arch": VLM, "full_depth": full_depth,
          "depth_cut": True, "serve": {
              "n_layers": cfg.n_layers, "param_init_s": init_s,
              "param_gb": param_gb, "peak_mem_gb": serve_peak,
              "runs": runs, "b2_alone": b2_timing},
          "cross_device": vcross, "train": vtrain,
          "seconds": time.perf_counter() - t1})
    check_serve()
    check_vcross()
    check_vtrain()
    return {HUBERT: h_launches,
            VLM: {n: v_launches[n] + t_launches[n] for n in counters}}


# phase 12: training at scale, smollm-135m at full width (8 x 512, the
# config's remat "dots"): (a) the supervisor, 12 steps checkpointed every
# 4, clean and with a failure injected before step 6 (restored from step
# 3's checkpoint: steps 4 and 5 run again, 14 steps in all); (b) one
# step's loss and gradients under each remat policy; (c) the mesh path on
# a single-rank NCCL group; (e) the ZeRO-3 step on that group, timed
RT_STEPS, RT_CKPT_EVERY, RT_FAIL_AT, RT_RESUME_STEPS = 12, 4, 6, 16
# (e): steps of the ZeRO-3 step and of the plain one, timed
ZERO_STEPS = 4


def tree_gap(torch, a, b) -> float:
    """max |a - b| over two trees' leaves, in f32; 0.0 when equal."""
    from repro_torch.tree import flatten
    fa, fb = flatten(a), flatten(b)
    if [p for p, _ in fa] != [p for p, _ in fb]:
        fail("trees of different structure compared")
    return max((float((x.float() - y.float()).abs().max())
                for (_, x), (_, y) in zip(fa, fb) if x.numel()),
               default=0.0)


def trees_equal(torch, a, b) -> bool:
    from repro_torch.tree import flatten
    return all(torch.equal(x, y) for (_, x), (_, y) in
               zip(flatten(a), flatten(b)))


def held(torch, got, ref, gauge) -> bool:
    """``got`` equals ``ref`` as far as the card repeats itself: bitwise
    where two clean runs were (``gauge`` 0.0), else within their gap."""
    return (trees_equal(torch, got, ref) if gauge == 0.0
            else tree_gap(torch, got, ref) <= gauge)


def runtime_supervisor(torch, dev, counters):
    """Phase 12 (a): ``train.main`` at smollm-135m's full width, 8 x 512,
    ``RT_STEPS`` steps: clean under the supervisor (``--ckpt-dir``,
    ``--ckpt-every 4``); again without it (the determinism gauge: two
    clean runs); with ``--simulate-failure-at 6`` (14 steps run); then
    ``--steps 16`` on the clean directory, which resumes at step 12.
    Returns (the JSON fields, the checks, the B5 launches, the clean
    directory, the clean run's final {"params", "opt"})."""
    import shutil
    from repro_torch import checkpoint as ckpt
    from repro_torch.launch import train

    base = ["--arch", "smollm-135m", "--batch", str(B), "--seq",
            str(L_TRAIN), "--lr", "3e-4", "--warmup", "2", "--log-every",
            "1", "--device", str(dev), "--seed", "0"]
    dirs = {k: ROOT / "build" / f"chip_smoke_rt_{k}"
            for k in ("clean", "faulty")}
    for d in dirs.values():
        shutil.rmtree(d, ignore_errors=True)

    def run(argv):
        seen: list = []
        zero_counts(counters)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train.main(base + argv, on_step=seen.append)
        torch.cuda.synchronize()
        out.update(seen=seen, launches=launch_counts(counters),
                   seconds=time.perf_counter() - t0)
        return out
    ck = ["--ckpt-every", str(RT_CKPT_EVERY)]
    clean = run(["--steps", str(RT_STEPS), "--ckpt-dir",
                 str(dirs["clean"])] + ck)
    again = run(["--steps", str(RT_STEPS)])
    faulty = run(["--steps", str(RT_STEPS), "--ckpt-dir",
                  str(dirs["faulty"]), "--simulate-failure-at",
                  str(RT_FAIL_AT)] + ck)
    saved = {k: ckpt.all_steps(str(d)) for k, d in dirs.items()}
    resumed = run(["--steps", str(RT_RESUME_STEPS), "--ckpt-dir",
                   str(dirs["clean"])] + ck)
    shutil.rmtree(dirs["faulty"], ignore_errors=True)
    cfg = clean["config"]
    per_step = b5_per_step(cfg)

    def state(o):
        return {"params": o["params"], "opt": o["opt"]}
    gauge = tree_gap(torch, state(clean), state(again))
    gap = tree_gap(torch, state(clean), state(faulty))
    ok = held(torch, state(faulty), state(clean), gauge)
    by_step = {m["step"]: m for m in clean["metrics"]}
    again_gap = max(abs(m[k] - by_step[m["step"]][k])
                    for m in again["metrics"] for k in m if k != "ms")
    metric_gap = max(abs(m[k] - by_step[m["step"]][k])
                     for m in faulty["metrics"] for k in m if k != "ms")
    after = faulty["metrics"][RT_FAIL_AT:]
    rerun = list(range(RT_FAIL_AT)) + list(range(
        (RT_FAIL_AT // RT_CKPT_EVERY) * RT_CKPT_EVERY, RT_STEPS))
    want_launches = {k: n * per_step for k, n in (
        ("clean", RT_STEPS), ("again", RT_STEPS),
        ("faulty", len(rerun)), ("resumed", RT_RESUME_STEPS - RT_STEPS))}
    runs = {"clean": clean, "again": again, "faulty": faulty,
            "resumed": resumed}
    fields = {
        "config": cfg.name, "remat": cfg.remat, "batch": B, "seq": L_TRAIN,
        "steps": RT_STEPS, "ckpt_every": RT_CKPT_EVERY,
        "fail_at": RT_FAIL_AT,
        "steps_run": {k: o["seen"] for k, o in runs.items()},
        "seconds": {k: o["seconds"] for k, o in runs.items()},
        "step_ms": {k: [m["ms"] for m in o["metrics"]]
                    for k, o in runs.items()},
        "loss": {k: [m["loss"] for m in o["metrics"]]
                 for k, o in runs.items()},
        "checkpoints": saved,
        "checkpoints_after_resume": ckpt.all_steps(str(dirs["clean"])),
        "launches": {k: o["launches"] for k, o in runs.items()},
        "b5_per_step": per_step, "b5_expected": want_launches,
        "clean_vs_clean_state_gap": gauge,
        "clean_vs_clean_metric_gap": again_gap,
        "faulty_vs_clean_state_gap": gap,
        "faulty_vs_clean_metric_gap": metric_gap,
        "faulty_equal": ok, "stragglers": {
            k: o["stragglers"] for k, o in runs.items()}}
    keep = state(clean)
    del again, faulty, resumed, runs

    def check():
        if fields["steps_run"]["faulty"] != rerun:
            fail(f"supervisor: steps run {fields['steps_run']['faulty']}, "
                 f"expected {rerun}")
        if fields["steps_run"]["clean"] != list(range(RT_STEPS)) or \
                fields["steps_run"]["resumed"] != list(
                    range(RT_STEPS, RT_RESUME_STEPS)):
            fail(f"supervisor: steps run {fields['steps_run']}")
        if not ok:
            fail(f"supervisor: the faulty run's state is {gap:.3e} from the "
                 f"clean run's (two clean runs: {gauge:.3e})")
        if [m["step"] for m in after] != rerun[RT_FAIL_AT:] or \
                metric_gap > again_gap:
            fail(f"supervisor: metrics after the restart {metric_gap:.3e} "
                 f"from the clean run's (two clean runs: {again_gap:.3e})")
        if saved != {"clean": [3, 7, 11], "faulty": [3, 7, 11]} or \
                fields["checkpoints_after_resume"] != [7, 11, 15]:
            fail(f"supervisor: checkpoints {saved}, after the resume "
                 f"{fields['checkpoints_after_resume']}")
        for k, o in fields["launches"].items():
            want = {**dict.fromkeys(counters, 0),
                    "linear_attention_causal": want_launches[k]}
            if o != want:
                fail(f"supervisor ({k}): launches {o}, expected {want}")
        if not all(np.isfinite(x) for v in fields["loss"].values()
                   for x in v):
            fail(f"supervisor: losses {fields['loss']}")
    b5 = sum(o["linear_attention_causal"] for o in fields["launches"]
             .values())
    return fields, check, b5, dirs["clean"], keep


def runtime_remat(torch, dev, counters):
    """Phase 12 (b): smollm-135m at full width, one batch of 8 x 512 and
    the same params (seed 0): under each remat policy, two calls of the
    loss and gradients (``steps.make_grad_fn``) and three train steps
    (``steps.make_train_step``), each phase's peak device memory (reset
    before it), ms (synchronised) and B5's launches; "none" again last,
    the determinism gauge. Loss and every gradient must equal the
    "none" ones (bitwise if the two "none" runs are). Returns (fields,
    checks, B5 launches)."""
    import gc
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant

    cfg0 = configs.get_config("smollm-135m", use_kernel=True)
    params = lm.init_params(cfg0, seed=0, device=dev)
    opt_cfg = AdamWConfig(lr=3e-4)
    opt = adamw_init(params, opt_cfg)
    batch = to_device(SyntheticLM(cfg0.vocab, L_TRAIN, B, seed=0).batch(0),
                      dev)
    res, kept = {}, {}
    b5 = 0
    for name in ("none", "full", "dots", "none_again"):
        cfg = dataclasses.replace(cfg0, remat=name.split("_")[0])
        grad_fn = steps.make_grad_fn(cfg)
        step = steps.make_train_step(cfg, opt_cfg, constant(3e-4))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counts(counters)
        g_ms = []
        for _ in range(2):
            t0 = time.perf_counter()
            grads, m = grad_fn(params, batch, 0)
            torch.cuda.synchronize()
            g_ms.append((time.perf_counter() - t0) * 1e3)
        g_peak = torch.cuda.max_memory_allocated()
        g_launches = launch_counts(counters)
        kept[name] = {"loss": m["loss"], "grads": grads}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s_ms = []
        for i in range(3):
            t0 = time.perf_counter()
            _, _, sm = step(params, opt, batch, i)
            float(sm["loss"])                               # synchronises
            s_ms.append((time.perf_counter() - t0) * 1e3)
        launches = launch_counts(counters)
        b5 += launches["linear_attention_causal"]
        res[name] = {
            "remat": cfg.remat, "loss": float(m["loss"]),
            "grad_ms": g_ms, "grad_peak_gb": g_peak / 1e9,
            "grad_peak_above_state_gb": (g_peak - base) / 1e9,
            "step_ms": s_ms,
            "step_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "grad_launches": g_launches["linear_attention_causal"],
            "launches": launches}
        del grads
    gauge = tree_gap(torch, kept["none"], kept["none_again"])
    gaps = {n: tree_gap(torch, kept[n], kept["none"])
            for n in ("full", "dots", "none_again")}
    equal = {n: held(torch, kept[n], kept["none"], gauge)
             for n in ("full", "dots")}
    per_step = {n: b5_per_step(dataclasses.replace(cfg0, remat=r["remat"]))
                for n, r in res.items()}
    del kept, params, opt, batch
    fields = {"config": cfg0.name, "batch": B, "seq": L_TRAIN,
              "policies": res, "none_vs_none_gap": gauge,
              "gap_to_none": gaps, "equal_to_none": equal,
              "b5_per_step": per_step}

    def check():
        for n in ("full", "dots"):
            if not equal[n]:
                fail(f"remat {n}: loss and gradients {gaps[n]:.3e} from "
                     f"'none' (two 'none' runs: {gauge:.3e})")
        for n, r in res.items():
            want = {**dict.fromkeys(counters, 0),
                    "linear_attention_causal": 5 * per_step[n]}
            if r["launches"] != want or r["grad_launches"] != \
                    2 * per_step[n]:
                fail(f"remat {n}: launches {r['launches']}, expected "
                     f"{want}")
        if not res["none"]["grad_peak_gb"] > res["dots"]["grad_peak_gb"] \
                > res["full"]["grad_peak_gb"]:
            fail("remat: peak memory does not fall from none to dots to "
                 f"full: {[res[n]['grad_peak_gb'] for n in res]}")
    return fields, check, b5


def runtime_mesh(torch, dev, counters, ck_dir, clean_state):
    """Phase 12 (c): a single-rank NCCL group on a ``FileStore`` under
    build/, ``make_local_mesh(1, 1, device_type="cuda")``: two sharded
    steps of smollm-135m at full width (``steps.make_sharded_train_step``,
    DTensor params and optimizer state) against two plain steps, run
    twice (the determinism gauge); ``compressed_psum_mean`` none, bf16 and
    int8 against their arithmetic on one rank; ``restore_to_shardings`` of
    (a)'s step-11 checkpoint against the clean run's final state. The
    group is destroyed after. Returns (fields, checks, B5 launches)."""
    import torch.distributed as dist
    from repro_torch import checkpoint as ckpt
    from repro_torch import configs
    from repro_torch.data import SyntheticLM
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import (compressed_psum_mean, local_batch,
                                      make_shardings, opt_state_specs,
                                      param_specs, place_tree)
    from repro_torch.tree import flatten

    store = ROOT / "build" / "chip_smoke_nccl_store"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type=dev.type)
        init_s = time.perf_counter() - t0
        cfg = configs.get_config("smollm-135m", use_kernel=True)
        params = lm.init_params(cfg, seed=0, device=dev)
        opt_cfg = AdamWConfig(lr=3e-4)
        opt = adamw_init(params, opt_cfg)
        data = SyntheticLM(cfg.vocab, L_TRAIN, B, seed=0)
        plain = steps.make_train_step(cfg, opt_cfg, constant(3e-4))

        def two(step_fn, p, o, shard):
            ms, ms_out = [], []
            for i in range(2):
                b = data.batch(i)
                if shard:
                    b = local_batch(b, mesh)
                b = to_device(b, dev)
                t1 = time.perf_counter()
                p, o, m = step_fn(p, o, b, i)
                ms_out.append({k: float(v) for k, v in m.items()})
                ms.append((time.perf_counter() - t1) * 1e3)
            return p, o, ms_out, ms
        zero_counts(counters)
        ref = two(plain, params, opt, False)
        ref2 = two(plain, params, opt, False)
        pspecs = param_specs(params, mesh, overrides=cfg.sharding_overrides)
        psh = make_shardings(pspecs, mesh)
        osh = make_shardings(opt_state_specs(opt, pspecs, mesh), mesh)
        sp, so = place_tree(params, psh), place_tree(opt, osh)
        sharded = two(steps.make_sharded_train_step(cfg, opt_cfg,
                                                    constant(3e-4), mesh),
                      sp, so, True)
        launches = launch_counts(counters)
        del sp, so
        placements_kept = all(
            hasattr(t, "placements") for _, t in flatten(
                {"p": sharded[0], "o": sharded[1]}))
        full = {"params": lm.tree_map(lambda t: t.full_tensor(),
                                      sharded[0]),
                "opt": lm.tree_map(lambda t: t.full_tensor(), sharded[1])}
        plain_state = {"params": ref[0], "opt": ref[1]}
        gauge = tree_gap(torch, plain_state, {"params": ref2[0],
                                              "opt": ref2[1]})
        gap = tree_gap(torch, full, plain_state)
        step_equal = held(torch, full, plain_state, gauge) and \
            sharded[2] == ref[2]
        del full, plain_state, ref2
        zero = runtime_zero(torch, dev, counters, mesh, cfg, params, opt,
                            opt_cfg, data, ref, gauge, plain)
        tp = runtime_tp(torch, dev, counters, mesh, cfg, params, opt_cfg,
                        data, zero[0]["losses"]["plain"])

        gen = torch.Generator(device=dev).manual_seed(3)
        g = {"a": torch.randn(4096, generator=gen, device=dev),
             "b": {"c": torch.randn(96, 576, generator=gen, device=dev,
                                    dtype=torch.bfloat16)}}
        eb = lm.tree_map(lambda t: 0.01 * torch.randn(
            t.shape, generator=gen, device=dev), g)
        comp = {}
        out, _ = compressed_psum_mean(g, ("data",), "none", mesh=mesh)
        comp["none"] = trees_equal(torch, out, g)
        out, _ = compressed_psum_mean(g, ("data",), "bf16", mesh=mesh)
        comp["bf16"] = trees_equal(torch, out, lm.tree_map(
            lambda t: t.to(torch.bfloat16).float().to(t.dtype), g))
        out, new_eb = compressed_psum_mean(g, ("data",), "int8", eb,
                                           mesh=mesh)

        def quant(t, e):
            gf = t.float() + e
            scale = gf.abs().max() / 127.0 + 1e-12
            deq = torch.clamp(torch.round(gf / scale), -127, 127) * scale
            return deq, gf - deq
        pairs = lm.tree_map(quant, g, eb)
        comp["int8"] = trees_equal(torch, out, lm.tree_map(
            lambda t, pr: pr[0].to(t.dtype), g, pairs)) and trees_equal(
            torch, new_eb, lm.tree_map(lambda t, pr: pr[1], g, pairs))

        restored, step = ckpt.restore_to_shardings(
            str(ck_dir), clean_state, {
                "params": make_shardings(param_specs(
                    clean_state["params"], mesh), mesh),
                "opt": make_shardings(opt_state_specs(
                    clean_state["opt"], param_specs(clean_state["params"],
                                                    mesh), mesh), mesh)},
            step=RT_STEPS - 1)
        restored_equal = trees_equal(torch, lm.tree_map(
            lambda t: t.full_tensor(), restored), clean_state)
        del restored
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    per_step = b5_per_step(cfg)
    fields = {"backend": backend, "world": 1, "mesh": [1, 1],
              "group_init_s": init_s, "plain_step_ms": ref[3],
              "sharded_step_ms": sharded[3],
              "plain_vs_plain_gap": gauge, "sharded_vs_plain_gap": gap,
              "sharded_equal": step_equal,
              "placements_kept": placements_kept,
              "compression_equal": comp, "restored_step": step,
              "restore_to_shardings_equal": restored_equal,
              "launches": launches, "b5_expected": 6 * per_step,
              "seconds": time.perf_counter() - t0}

    def check():
        if not step_equal or not placements_kept:
            fail(f"mesh: two sharded steps {gap:.3e} from the plain ones "
                 f"(two plain runs: {gauge:.3e}), placements kept "
                 f"{placements_kept}")
        if not all(comp.values()):
            fail(f"mesh: compressed_psum_mean {comp}")
        if step != RT_STEPS - 1 or not restored_equal:
            fail(f"mesh: restore_to_shardings of step {step} "
                 f"equal={restored_equal}")
        want = {**dict.fromkeys(counters, 0),
                "linear_attention_causal": 6 * per_step}
        if launches != want:
            fail(f"mesh: launches {launches}, expected {want}")
    return fields, check, launches["linear_attention_causal"], zero, tp


def runtime_zero(torch, dev, counters, mesh, cfg, params, opt, opt_cfg,
                 data, ref, gauge, plain):
    """Phase 12 (e), on (c)'s single-rank group: the ZeRO-3 step
    (``steps.make_sharded_train_step``: each leaf's shard gathered where
    the model uses it, its gradient reduce-scattered back) against the
    plain step, ``ZERO_STEPS`` steps each from seed 0's params, each
    side's peak device memory (reset before it) and ms a step
    (synchronised). The sharded side's first two steps must be (c)'s
    plain ones (``ref``: params, mu, nu and every metric), bitwise where
    (c)'s two plain runs are (``gauge`` 0.0, :func:`held`); each
    step gathers ``2 x layers x sharded leaves a layer`` (a unit's
    forward and its recompute under "dots") plus the tied embedding
    twice (input and head), and launches B5 ``b5_per_step`` (60) times,
    as the plain step does. Returns (fields, checks, B5 launches)."""
    import gc
    from repro_torch.launch import steps
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import (local_batch, make_shardings,
                                      opt_state_specs, param_specs,
                                      place_tree, sharding)
    from repro_torch.tree import flatten

    t0 = time.perf_counter()
    pspecs = param_specs(params, mesh, overrides=cfg.sharding_overrides)
    split_leaves = [p for p, sp in flatten(pspecs)
                    if p.startswith("['units']")
                    and any(a is not None for a in sp)]
    # a unit's leaves in its forward, again in its recompute under
    # "full" and "dots"; the tied embedding at the input and the head
    want_gathers = ((1 if cfg.remat == "none" else 2) * cfg.n_units
                    * len(split_leaves) + 2)
    batches = [to_device(local_batch(data.batch(i), mesh), dev)
               for i in range(ZERO_STEPS)]

    def run(step_fn, p, o):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(counters)
        ms, out, kept, gathers, gathered_peak = [], [], None, [], []
        for i, b in enumerate(batches):
            sharding.GAUGE.reset()
            t1 = time.perf_counter()
            p, o, m = step_fn(p, o, b, i)
            out.append({k: float(v) for k, v in m.items()})  # synchronises
            ms.append((time.perf_counter() - t1) * 1e3)
            gathers.append(sharding.GAUGE.gathers)
            gathered_peak.append(sharding.GAUGE.peak)
            if i == 1:
                kept = (p, o)
        return {"ms": ms, "metrics": out, "kept": kept,
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "launches": launch_counts(counters), "gathers": gathers,
                "gathered_peak_bytes": gathered_peak}
    res = {"plain": run(plain, params, opt)}
    res["plain"].pop("kept")
    sp = place_tree(params, make_shardings(pspecs, mesh))
    so = place_tree(opt, make_shardings(opt_state_specs(opt, pspecs, mesh),
                                        mesh))
    res["sharded"] = run(steps.make_sharded_train_step(
        cfg, opt_cfg, constant(3e-4), mesh), sp, so)
    del sp, so
    kp, ko = res["sharded"].pop("kept")
    full = {"params": lm.tree_map(lambda t: t.full_tensor(), kp),
            "opt": lm.tree_map(lambda t: t.full_tensor(), ko)}
    plain_state = {"params": ref[0], "opt": ref[1]}
    gap = tree_gap(torch, full, plain_state)
    equal = (held(torch, full, plain_state, gauge)
             and res["sharded"]["metrics"][:2] == ref[2])
    del full, kp, ko, plain_state
    per_step = b5_per_step(cfg)
    fields = {
        "steps": ZERO_STEPS, "equal_to_plain_steps": equal,
        "gap_to_plain_steps": gap, "plain_vs_plain_gap": gauge,
        "step_ms_p50": {k: float(np.median(r["ms"])) for k, r in res.items()},
        "step_ms": {k: r["ms"] for k, r in res.items()},
        "peak_gb": {k: r["peak_gb"] for k, r in res.items()},
        "gathers_per_step": res["sharded"]["gathers"],
        "gathers_expected": want_gathers,
        "sharded_leaves_per_layer": len(split_leaves),
        "gathered_peak_bytes": res["sharded"]["gathered_peak_bytes"],
        "launches": {k: r["launches"] for k, r in res.items()},
        "b5_expected": ZERO_STEPS * per_step,
        "losses": {k: [m["loss"] for m in r["metrics"]]
                   for k, r in res.items()},
        "seconds": time.perf_counter() - t0}

    def check():
        if not equal:
            fail(f"zero: two sharded steps {gap:.3e} from the plain ones "
                 f"(two plain runs: {gauge:.3e})")
        want = {**dict.fromkeys(counters, 0),
                "linear_attention_causal": ZERO_STEPS * per_step}
        for k, r in res.items():
            if r["launches"] != want:
                fail(f"zero: {k} launches {r['launches']}, expected {want}")
        if set(res["sharded"]["gathers"]) != {want_gathers}:
            fail(f"zero: gathers {res['sharded']['gathers']}, expected "
                 f"{want_gathers} a step")
        if res["plain"]["gathers"] != [0] * ZERO_STEPS:
            fail("zero: the plain step gathered")
    return fields, check, res["sharded"]["launches"][
        "linear_attention_causal"] + res["plain"]["launches"][
        "linear_attention_causal"]


# phase 12 (f): tensor parallelism over ``model`` on (c)'s one-rank
# group. A card's mesh has one ``model`` rank, where the layers compute
# whole: the port's TP train step there is the ZeRO-3 step that (e)
# holds bitwise to the plain one. With ``tensor_parallel._MIN_RANKS``
# lowered to 1 (its test seam) every tensor-parallel branch runs on the
# card, each rank's share the whole: blocks gathered over ``data``, the
# collectives over a one-rank NCCL group, the KV groups cut for the
# kernels, the vocab-parallel cross-entropy. On one rank the all-reduces
# are identities and a share is the whole leaf, so a missing ``model``
# sum or a wrong group slice cannot show here: the correctness of tensor
# parallelism rests on the gloo tests (tests/test_torch_tp.py). This
# phase shows that the branches run on CUDA and NCCL, through the
# kernels, with the plain path's arithmetic up to rounding.
# The branches' forward is the plain one's arithmetic (the step-0 loss
# bitwise, in bf16 and f32); the backward sums the logsumexp's terms in
# another order. In bf16 (the card's path) step 0's gradients are held
# within TP_GRAD_TOL of each leaf's largest |g|. That the gap is
# rounding is witnessed in f32 (params and activations), where the same
# comparison is held within TP_GRAD_TOL_F32 and the four steps' losses
# within TP_LOSS_TOL_F32 of the plain step's. Each limit is checked to
# lie below a control that must fail it: step 0's bf16 gradients with
# every label rolled one position (the wrong target) for the gradient
# limits, the f32 steps with their updates lost (lr 0) for the loss
# limit. The bf16 losses after step 0 are reported, not held: AdamW
# divides each gradient element by its own magnitude, so where a
# gradient sits at bf16 rounding the two runs move an element up to
# about lr apart a step, and a lost update moves the loss little more
# than that at this lr.
TP_STEPS = 4
TP_GRAD_TOL = 0.05
TP_GRAD_TOL_F32 = 1e-4
TP_LOSS_TOL_F32 = 1e-5
# the per-rank geometries tensor parallelism gives the configs that a
# card cannot hold whole: (arch, model ranks), one KV group a rank
TP_GEOMETRIES = (("granite-8b", 8), ("qwen3-32b", 8), ("yi-34b", 8),
                 ("internvl2-76b", 8), ("qwen3-moe-235b-a22b", 4))
TP_SERVE = "granite-8b"


def tree_rel_gap(torch, a, b) -> tuple:
    """(max over leaves of max |a - b| / max |b|, that leaf's path)."""
    from repro_torch.tree import flatten
    worst = (0.0, None)
    for (p, x), (_, y) in zip(flatten(a), flatten(b)):
        if x.numel():
            gap = float((x.float() - y.float()).abs().max()
                        / y.float().abs().max().clamp(min=1e-30))
            worst = max(worst, (gap, p), key=lambda w: w[0])
    return worst


@contextlib.contextmanager
def tp_on_one_rank():
    """Within, a one-rank ``model`` axis computes on shards (the test
    seam ``tensor_parallel._MIN_RANKS`` lowered to 1)."""
    from repro_torch.parallel import tensor_parallel as tpl
    prev, tpl._MIN_RANKS = tpl._MIN_RANKS, 1
    try:
        yield
    finally:
        tpl._MIN_RANKS = prev


def tp_geometry_kernels(torch, dev, kd, kp, kl):
    """(f) (c): B1, B2 and B5 against their plain versions at the
    per-rank head layouts of :data:`TP_GEOMETRIES` (G = n_kv / M = 1),
    full width, bf16: B1 at 8 slots, B2 at the packer's 8 x 32 and
    1 x 256 grants, B5 forward and gradients at 8 x 512. Returns (cases,
    the worst error per kernel, each kernel's launches in the checks)."""
    from repro_torch import configs
    from repro_torch.kernels import check as kc

    state = (5, 6, 7)
    err = dict.fromkeys(("prf_fused_decode", "prf_fused_prefill",
                         "linear_attention_causal"), 0.0)
    before = {"prf_fused_decode": kd.launches,
              "prf_fused_prefill": kp.launches,
              "linear_attention_causal": kl.launches}
    cases, seen = [], set()
    for arch, m_ranks in TP_GEOMETRIES:
        c = configs.get_config(arch)
        g, hg, d, m = (c.n_kv // m_ranks, c.n_heads // c.n_kv, c.head_dim,
                       c.attn.num_features)
        if (g, hg, d, m) in seen:
            continue
        seen.add((g, hg, d, m))
        geo = f"{arch} M={m_ranks} G={g} Hg={hg} d={d} m={m}"
        args = kc.make_inputs(dev, 8, g, hg, d, m, d, None, True,
                              seed=400 + len(cases), dtype=torch.bfloat16)
        e = kc.check_case(f"decode {geo} bf16 B=8", lambda: kd.launches,
                          kd.fused_prf_decode, kd.prf_fused_decode_plain,
                          args, state, eps=1e-8)
        err["prf_fused_decode"] = max(err["prf_fused_decode"], e)
        cases.append({"case": f"decode {geo} bf16 B=8", "max_abs_err": e})
        for b, l, vl in (kc.PACKER_GRANTS[0], kc.PACKER_GRANTS[-1]):
            name = f"prefill {geo} bf16 B={b} L={l}"
            args = kc.make_inputs(dev, b, g, hg, d, m, d, l, True,
                                  seed=400 + len(cases),
                                  dtype=torch.bfloat16)
            vlt = torch.tensor(vl, dtype=torch.int32, device=dev)
            e = kc.check_case(name, lambda: kp.launches,
                              kp.fused_prf_prefill,
                              kp.prf_fused_prefill_plain, args, state, vlt,
                              eps=1e-8)
            err["prf_fused_prefill"] = max(err["prf_fused_prefill"], e)
            cases.append({"case": name, "max_abs_err": e})
        name = f"linear_attention_causal {geo} B=8 L=512 bf16"
        args = kc.make_lin_attn_inputs(dev, 8, g, hg, 512, m, d,
                                       seed=400 + len(cases),
                                       dtype=torch.bfloat16)
        fwd, grad = kc.check_autograd(
            name, kl, lambda q, k, v: kl.linear_attention_causal(
                q, k, v, eps=1e-8),
            lambda q, k, v: kl.linear_attention_causal_plain(q, k, v, 1e-8),
            args, seed=len(cases))
        err["linear_attention_causal"] = max(err["linear_attention_causal"],
                                             fwd)
        cases.append({"case": name, "max_abs_err": fwd,
                      "grad_max_abs_err": grad})
    launches = {"prf_fused_decode": kd.launches, "prf_fused_prefill":
                kp.launches, "linear_attention_causal": kl.launches}
    return cases, err, {n: launches[n] - before[n] for n in launches}


def runtime_tp(torch, dev, counters, mesh, cfg, params, opt_cfg, data,
               plain_losses):
    """Phase 12 (f), on (c)'s single-rank group with the tensor-parallel
    branches on (:func:`tp_on_one_rank`; module comment above
    :data:`TP_STEPS`). (a) smollm-135m at 8 x 512 from seed 0's params:
    the TP train step ``TP_STEPS`` steps in bf16, its step-0 loss
    bitwise (e)'s plain one (``plain_losses``), the later gaps reported;
    step 0's gradients against the plain step's within
    :data:`TP_GRAD_TOL`; the f32 witness, plain and TP ``TP_STEPS``
    steps each from the same params in f32, step 0's gradients within
    :data:`TP_GRAD_TOL_F32` and every loss within
    :data:`TP_LOSS_TOL_F32`; the controls, which must fail the limits
    (rolled labels; the f32 TP steps at lr 0); nothing gathered over
    ``model``, B5 ``b5_per_step`` times a step and a gradient call. (b)
    granite-8b at full depth and width, drawn on the card, through an
    overlapped engine on the mesh with the branches on and through one
    without a mesh (8 requests, prompts of 64-256 tokens, 16-32 new):
    greedy streams bitwise, B1 and B2 launches equal, nothing gathered
    over ``model``; the resident bytes of its params and pools on the
    rank. (c) :func:`tp_geometry_kernels`. Returns (fields, checks, the
    paths' launches, the checks' launches)."""
    import gc
    from repro_torch import configs
    from repro_torch import kernels as kmod
    from repro_torch.launch import steps
    from repro_torch.launch.train import to_device
    from repro_torch.models import lm
    from repro_torch.optim import adamw_init
    from repro_torch.optim.schedules import constant
    from repro_torch.parallel import (local_batch, make_shardings,
                                      opt_state_specs, param_specs,
                                      place_tree, sharding)
    from repro_torch.serving import synthetic_requests

    t0 = time.perf_counter()
    batches = [to_device(local_batch(data.batch(i), mesh), dev)
               for i in range(TP_STEPS)]
    rolled = {**batches[0], "labels": torch.roll(batches[0]["labels"], 1,
                                                 dims=1)}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = lm.tree_map(lambda t: t.float(), params)
    b5 = {}

    def run(name, c, p, lr, placed):
        """``TP_STEPS`` steps of ``c`` from ``p`` at ``lr``, the TP step
        with the branches on (``placed``) or the plain one: losses."""
        o = adamw_init(p, opt_cfg)
        if placed:
            pspecs = param_specs(p, mesh, overrides=c.sharding_overrides)
            p = place_tree(p, make_shardings(pspecs, mesh))
            o = place_tree(o, make_shardings(opt_state_specs(o, pspecs, mesh),
                                             mesh))
        step_fn = (steps.make_sharded_train_step(c, opt_cfg, constant(lr),
                                                 mesh) if placed else
                   steps.make_train_step(c, opt_cfg, constant(lr)))
        zero_counts(counters)
        losses = []
        with (tp_on_one_rank() if placed else contextlib.nullcontext()):
            for i, b in enumerate(batches):
                p, o, m = step_fn(p, o, b, i)
                losses.append(float(m["loss"]))
        b5[name] = launch_counts(counters)["linear_attention_causal"]
        return losses

    def grads(name, c, p, batch, placed):
        """Step 0's gradients of ``c`` at ``p`` on ``batch``, plain or
        through the TP branches (the local shards, here the whole)."""
        zero_counts(counters)
        if placed:
            with tp_on_one_rank():
                g, _ = steps.make_sharded_grad_fn(c, mesh)(place_tree(
                    p, make_shardings(param_specs(
                        p, mesh, overrides=c.sharding_overrides), mesh)),
                    batch, 0)
        else:
            g, _ = steps.make_grad_fn(c)(p, batch, 0)
        b5[name] = launch_counts(counters)["linear_attention_causal"]
        return g

    t1 = time.perf_counter()
    sharding.GAUGE.reset()
    tp_losses = run("tp", cfg, params, 3e-4, True)
    over_model = sharding.GAUGE.over_model
    g_plain = grads("grad_plain", cfg, params, batches[0], False)
    g_tp = grads("grad_tp", cfg, params, batches[0], True)
    grad_gap, grad_leaf = tree_rel_gap(torch, g_tp, g_plain)
    del g_tp
    g_rolled = grads("grad_rolled_labels", cfg, params, rolled, True)
    rolled_gap, rolled_leaf = tree_rel_gap(torch, g_rolled, g_plain)
    del g_rolled, g_plain
    bf16_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    g_plain = grads("grad_plain_f32", cfg32, params32, batches[0], False)
    g_tp = grads("grad_tp_f32", cfg32, params32, batches[0], True)
    grad_gap32, grad_leaf32 = tree_rel_gap(torch, g_tp, g_plain)
    del g_tp, g_plain
    plain32 = run("plain_f32", cfg32, params32, 3e-4, False)
    tp32 = run("tp_f32", cfg32, params32, 3e-4, True)
    lost32 = run("tp_f32_lr0", cfg32, params32, 0.0, True)
    f32_s = time.perf_counter() - t1
    del params32
    gc.collect()
    torch.cuda.empty_cache()

    def rel_gaps(a, b):
        return [abs(x - y) / abs(y) for x, y in zip(a, b)]
    loss_gaps = rel_gaps(tp_losses, plain_losses)
    loss_gaps32 = rel_gaps(tp32, plain32)
    lost_gaps32 = rel_gaps(lost32, plain32)
    per_step = b5_per_step(cfg)
    b5_want = {k: (TP_STEPS if k in ("tp", "plain_f32", "tp_f32",
                                      "tp_f32_lr0") else 1) * per_step
               for k in b5}
    train = {"steps": TP_STEPS,
             "losses": {"plain_bf16_from_e": plain_losses,
                        "tp_bf16": tp_losses, "plain_f32": plain32,
                        "tp_f32": tp32, "tp_f32_lr0_control": lost32},
             "bf16_step0_loss_bitwise": tp_losses[0] == plain_losses[0],
             "bf16_loss_rel_gaps": loss_gaps,
             "bf16_grad_rel_gap": grad_gap, "bf16_grad_gap_leaf": grad_leaf,
             "f32_step0_loss_bitwise": tp32[0] == plain32[0],
             "f32_loss_rel_gaps": loss_gaps32,
             "f32_grad_rel_gap": grad_gap32, "f32_grad_gap_leaf": grad_leaf32,
             "control_rolled_labels_grad_rel_gap": rolled_gap,
             "control_rolled_labels_grad_gap_leaf": rolled_leaf,
             "control_lr0_f32_loss_rel_gaps": lost_gaps32,
             "limits": {"grad_bf16": TP_GRAD_TOL, "grad_f32": TP_GRAD_TOL_F32,
                        "loss_f32": TP_LOSS_TOL_F32},
             "over_model": over_model,
             "b5_launches": b5, "b5_expected": b5_want,
             "seconds": {"bf16": bf16_s, "f32": f32_s}}
    gc.collect()

    t1 = time.perf_counter()
    scfg = configs.get_config(TP_SERVE, use_kernel=True)
    sparams = lm.init_params(scfg, seed=0, device=dev, draw_on=dev)

    def reqs():
        return synthetic_requests(8, scfg.vocab, seed=3,
                                  prompt_range=(64, 256),
                                  gen_range=(16, 32))
    base, l_base, _ = mesh_serve(torch, dev, counters, sparams, scfg,
                                 reqs())
    sharding.GAUGE.reset()
    with tp_on_one_rank():
        got, l_tp, eng = mesh_serve(torch, dev, counters, sparams, scfg,
                                    reqs(), mesh=mesh)
    serve_gauge = {"gathers": sharding.GAUGE.gathers,
                   "over_model": sharding.GAUGE.over_model}
    leaf_bytes = [t.to_local().numel() * t.element_size()
                  for _, t in sharding._leaves_with_path(eng.params)]
    pool_bytes = sum(t.to_local().numel() * t.element_size()
                     for _, t in sharding._leaves_with_path(eng.pool))
    paths = (eng.stats["prefill_path"], eng.stats["decode_path"])
    del eng, sparams
    gc.collect()
    torch.cuda.empty_cache()
    serve_fields = {
        "config": scfg.name, "n_layers": scfg.n_layers, "requests": 8,
        "paths": list(paths), "streams_bitwise": got == base,
        "launches_plain": l_base, "launches_tp_branches": l_tp,
        "gauge": serve_gauge, "resident_param_bytes": sum(leaf_bytes),
        "resident_pool_bytes": pool_bytes,
        "seconds": time.perf_counter() - t1}

    kd, kp, kl = (kmod.COUNTERS[n][0] for n in
                  ("prf_fused_decode", "prf_fused_prefill",
                   "linear_attention_causal"))
    cases, errs, check_launches = tp_geometry_kernels(torch, dev, kd, kp, kl)
    fields = {"train": train, "serve": serve_fields,
              "geometry_cases": cases, "geometry_max_abs_err": errs,
              "geometry_launches": check_launches,
              "seconds": time.perf_counter() - t0}

    def check():
        if not (train["bf16_step0_loss_bitwise"]
                and train["f32_step0_loss_bitwise"]):
            fail(f"tp: the TP branches' step-0 loss is not bitwise the "
                 f"plain one's (bf16 {tp_losses[0]} vs {plain_losses[0]}, "
                 f"f32 {tp32[0]} vs {plain32[0]})")
        if grad_gap > TP_GRAD_TOL or grad_gap32 > TP_GRAD_TOL_F32:
            fail(f"tp: step 0's gradients {grad_gap:.3e} at {grad_leaf} "
                 f"(bf16, limit {TP_GRAD_TOL}) and {grad_gap32:.3e} at "
                 f"{grad_leaf32} (f32, limit {TP_GRAD_TOL_F32}) from the "
                 f"plain step's")
        if max(loss_gaps32) > TP_LOSS_TOL_F32:
            fail(f"tp: f32 losses {loss_gaps32} from the plain step's "
                 f"(limit {TP_LOSS_TOL_F32})")
        if rolled_gap <= TP_GRAD_TOL or max(lost_gaps32) <= TP_LOSS_TOL_F32:
            fail(f"tp: a control passes its limit: rolled labels' gradients "
                 f"{rolled_gap:.3e} (limit {TP_GRAD_TOL}), lr 0's f32 losses "
                 f"{lost_gaps32} (limit {TP_LOSS_TOL_F32})")
        if b5 != b5_want:
            fail(f"tp: B5 launches {b5}, expected {b5_want}")
        if over_model:
            fail(f"tp: the TP branches gathered over model ({over_model})")
        if paths != ("fused_kernel", "fused_kernel"):
            fail(f"tp serve: paths {paths}")
        if got != base:
            fail("tp serve: the mesh engine's greedy streams differ from "
                 "the engine's without a mesh")
        if l_tp != l_base or not (l_tp["prf_fused_decode"]
                                  and l_tp["prf_fused_prefill"]):
            fail(f"tp serve: launches {l_tp} on the mesh, {l_base} without")
        if serve_gauge["over_model"]:
            fail(f"tp serve: gathered over model ({serve_gauge})")
    launches = {n: l_tp[n] + l_base[n] for n in counters}
    launches["linear_attention_causal"] += sum(b5.values())
    return fields, check, launches, check_launches


def mesh_serve(torch, dev, counters, params, cfg, reqs, mesh=None,
               **kw):
    """``reqs`` through an overlapped engine (8 slots, max_len 1024,
    chunk_tokens 256; ``kw`` more of its arguments) on ``mesh`` or
    without one, counted from 0: (streams in submission order, the
    launches, the engine)."""
    from repro_torch.serving import ServingEngine

    eng = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                        chunk_tokens=256, seed=0, overlap=True, mesh=mesh,
                        device=dev, **kw)
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    zero_counts(counters)
    by_uid = {r.uid: r.tokens for r in eng.run()}
    torch.cuda.synchronize()
    return [by_uid[r.uid] for r in reqs], launch_counts(counters), eng


def placements_as_specs(eng, mesh) -> list:
    """The pool and staging leaves that are not DTensors with the
    placements ``serve_state_specs`` gives them (empty: all are)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.parallel import (make_shardings, serve_state_specs,
                                      sharding)

    bad = []
    for name in ("pool", "staging"):
        tree = getattr(eng, name)
        want = dict(sharding._leaves_with_path(make_shardings(
            serve_state_specs(tree, mesh), mesh)))
        for path, t in sharding._leaves_with_path(tree):
            if not (isinstance(t, DTensor)
                    and tuple(t.placements) == want[path].placements):
                bad.append(name + path)
    return bad


def runtime_serve_mesh(torch, dev, counters):
    """Phase 12 (d): the serving half of distribution on phase 12 (c)'s
    single-rank NCCL group (a ``FileStore`` under build/) and
    ``make_local_mesh(1, 1)``: smollm-135m at full width through B1/B2.
    8 requests (prompts of 64-256 tokens, 16-32 new) through an
    overlapped engine given the mesh and through one without it: greedy
    streams bitwise equal, B1 and B2 launches equal, every pool leaf a
    DTensor with ``serve_state_specs``' placements. Then phase 3e's
    system-prompt traffic at ``prefill_rows=1``: a cache-on engine on
    the mesh, primed with each shared prefix, every snapshot demoted to
    the host tier before the traffic (so its forks are served by the
    mesh-aware promotion), against a cache-less engine without the
    mesh: forks and promotions happen, streams equal. The group is
    destroyed after. Returns (fields, checks, launches)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import lm
    from repro_torch.serving import (PrefixCacheConfig, Request,
                                     shared_prefix_requests,
                                     synthetic_requests)
    from repro_torch.serving import prefix_cache as pcache

    store = ROOT / "build" / "chip_smoke_nccl_serve_store"
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", store=dist.FileStore(str(store), 1),
                            rank=0, world_size=1)
    try:
        mesh = make_local_mesh(1, 1, device_type=dev.type)
        cfg = configs.get_config("smollm-135m", use_kernel=True)
        params = lm.init_params(cfg, seed=0, device=dev, draw_on=dev)

        def reqs():
            return synthetic_requests(8, cfg.vocab, seed=3,
                                      prompt_range=(64, 256),
                                      gen_range=(16, 32))
        mesh_serve(torch, dev, counters, params, cfg, reqs()[:2])  # warm
        plain, l_plain, _ = mesh_serve(torch, dev, counters, params, cfg,
                                       reqs())
        t1 = time.perf_counter()
        sharded, l_mesh, eng = mesh_serve(torch, dev, counters, params,
                                          cfg, reqs(), mesh=mesh)
        mesh_s = time.perf_counter() - t1
        bad = placements_as_specs(eng, mesh)
        paths = (eng.stats["prefill_path"], eng.stats["decode_path"])
        del eng

        traffic = shared_prefix_requests(16, cfg.vocab, **PREFIX_TRAFFIC)
        leads = [lead for lead, n in collections.Counter(
            tuple(r.prompt[:256]) for r in traffic).items() if n > 1]

        def copy(rs):
            return [Request(prompt=list(r.prompt),
                            max_new_tokens=r.max_new_tokens) for r in rs]
        cold, _, _ = mesh_serve(torch, dev, counters, params, cfg,
                                copy(traffic), prefill_rows=1)
        on, l_on, eng = mesh_serve(
            torch, dev, counters, params, cfg,
            [Request(prompt=list(ld) + [1, 2, 3], max_new_tokens=2)
             for ld in leads], mesh=mesh, prefill_rows=1,
            prefix_cache=PrefixCacheConfig())
        for ent in eng.prefix_cache._entries.values():
            if not ent.on_host:
                ent.state = pcache.snapshot_to_host(ent.state)
                ent.on_host = True
        before = dict(eng.stats)
        reqs_on = copy(traffic)
        for r in reqs_on:
            eng.submit(r)
        zero_counts(counters)
        by_uid = {r.uid: r.tokens for r in eng.run()}
        l_on = launch_counts(counters)
        forked = [by_uid[r.uid] for r in reqs_on]
        st = eng.stats
        delta = {k: st[k] - before.get(k, 0) for k in PREFIX_STATS}
        bad_fork = placements_as_specs(eng, mesh)
        del eng, params
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
    same = [a == b for x, y in zip(forked, cold) for a, b in zip(x, y)]
    fields = {"backend": "nccl", "world": 1, "mesh": [1, 1],
              "config": cfg.name, "requests": 8, "paths": list(paths),
              "streams_equal": sharded == plain,
              "launches_plain": l_plain, "launches_mesh": l_mesh,
              "mesh_run_s": mesh_s, "pool_leaves_off_spec": bad,
              "prefix": {"requests": len(traffic), "prefill_rows": 1,
                         **delta, "launches": l_on,
                         "tokens": len(same),
                         "tokens_equal": sum(same) / max(len(same), 1),
                         "pool_leaves_off_spec": bad_fork},
              "seconds": time.perf_counter() - t0}
    launches = {n: l_mesh[n] + l_on[n] for n in counters}

    def check():
        if paths != ("fused_kernel", "fused_kernel"):
            fail(f"serve mesh: paths {paths}")
        if sharded != plain:
            fail("serve mesh: the mesh engine's greedy streams differ "
                 "from the engine's without a mesh")
        if l_mesh != l_plain or not (l_mesh["prf_fused_decode"]
                                     and l_mesh["prf_fused_prefill"]):
            fail(f"serve mesh: launches {l_mesh} on the mesh, {l_plain} "
                 "without")
        if bad or bad_fork:
            fail(f"serve mesh: pool leaves off their specs "
                 f"({bad + bad_fork})")
        if delta["forked_requests"] < 1 or delta["prefix_promotions"] < 1:
            fail(f"serve mesh: no fork from a promoted snapshot ({delta})")
        if forked != cold:
            fail(f"serve mesh: forked streams differ from cold ones "
                 f"({sum(same)} of {len(same)} tokens equal)")
    return fields, check, launches


def phase_runtime(torch, dev, counters):
    """Phase 12: training at scale: (a) :func:`runtime_supervisor`, (b)
    :func:`runtime_remat`, (c) :func:`runtime_mesh` with (e)
    :func:`runtime_zero` and (f) :func:`runtime_tp` on its group, and
    the serving half of distribution, (d) :func:`runtime_serve_mesh`,
    one JSON line each with its seconds. Returns (each kernel's
    launches on the phase's paths: B5's in (a)-(c), (e) and (f), B1's
    and B2's in (d) and (f), the others' 0; (f)'s checks' launches)."""
    import gc
    import shutil

    t0 = time.perf_counter()
    sup, check_sup, b5_a, ck_dir, clean = runtime_supervisor(torch, dev,
                                                             counters)
    emit({"phase": "runtime_supervisor", **sup,
          "phase_seconds": time.perf_counter() - t0})
    check_sup()
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    rem, check_rem, b5_b = runtime_remat(torch, dev, counters)
    emit({"phase": "runtime_remat", **rem,
          "seconds": time.perf_counter() - t1})
    check_rem()
    gc.collect()
    torch.cuda.empty_cache()
    mesh, check_mesh, b5_c, (zero, check_zero, b5_e), \
        (tp, check_tp, tp_launches, tp_checks) = runtime_mesh(
            torch, dev, counters, ck_dir, clean)
    emit({"phase": "runtime_mesh", **mesh})
    check_mesh()
    emit({"phase": "runtime_zero", **zero})
    check_zero()
    emit({"phase": "runtime_tp", **tp})
    check_tp()
    shutil.rmtree(ck_dir, ignore_errors=True)
    del clean
    gc.collect()
    torch.cuda.empty_cache()
    serve_mesh, check_serve_mesh, serve_launches = runtime_serve_mesh(
        torch, dev, counters)
    emit({"phase": "runtime_serve_mesh", **serve_mesh})
    check_serve_mesh()
    gc.collect()
    torch.cuda.empty_cache()
    out = {n: serve_launches[n] + tp_launches[n] for n in counters}
    out["linear_attention_causal"] += b5_a + b5_b + b5_c + b5_e
    return out, tp_checks


def run_example(name: str, argv: list) -> tuple:
    """``examples/<name>.py``'s ``main(argv)`` in this process: (its
    result, seconds)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    out = mod.main(argv)
    return out, time.perf_counter() - t0


def phase_examples(torch, dev):
    """Phase 13: the reference's two examples in the port on the card,
    with no arguments but the device: ``examples/torch_quickstart.py``
    (60 steps of a 4-layer darkformer through B5, then a prefill through
    B2 and 12 greedy decode steps through B1), its loss at step 59 below
    step 0's; ``examples/torch_long_context_serving.py`` (reduced
    smollm-135m, decode at contexts 1 024, 8 192 and 65 536), the PRF
    state's bytes equal at every context and the exact KV cache's linear
    in the context. Each example counts its own launches. Returns each
    kernel's launches in both."""
    qs, qs_s = run_example("torch_quickstart", ["--device", str(dev)])
    lc, lc_s = run_example("torch_long_context_serving",
                           ["--device", str(dev)])
    rows = lc["rows"]
    ctx = [r["context"] for r in rows]
    kv = [r["kv_cache_bytes"] for r in rows]
    prf = {r["prf_state_bytes"] for r in rows}
    linear = (len(rows) == 3 and kv[0] < kv[1] < kv[2] and
              (kv[2] - kv[1]) * (ctx[1] - ctx[0])
              == (kv[1] - kv[0]) * (ctx[2] - ctx[1]))
    losses = qs["losses"]
    emit({"phase": "examples",
          "quickstart": {"seconds": qs_s, "loss_0": losses[0],
                         "loss_59": losses[-1], "steps": len(losses),
                         "generated": qs["generated"][0].tolist(),
                         "launches": qs["launches"]},
          "long_context": {"seconds": lc_s, "rows": rows,
                           "prf_state_equal": len(prf) == 1,
                           "kv_linear": linear,
                           "launches": lc["launches"]}})
    if not (len(losses) == 60 and losses[-1] < losses[0]
            and all(math.isfinite(x) for x in losses)):
        fail(f"quickstart: losses {losses[0]} -> {losses[-1]}")
    if len(prf) != 1 or not linear or ctx != [1024, 8192, 65536]:
        fail(f"long context: PRF bytes {prf}, KV bytes {kv} at {ctx}")
    return {n: qs["launches"][n] + lc["launches"][n] for n in qs["launches"]}


# every kernel of the port (its module and launch counter:
# ``repro_torch.kernels.COUNTERS``): (its CUDA source, the Pallas TPU
# kernel it replaces)
KERNELS = {
    "prf_fused_decode": ("prf_fused_decode",
                         "src/repro/kernels/prf_fused_decode.py:131"),
    "prf_fused_prefill": ("prf_fused_prefill",
                          "src/repro/kernels/prf_fused_prefill.py:167"),
    "prf_decode_step": ("prf_decode_step",
                        "src/repro/kernels/prf_decode_step.py:56"),
    "linear_attention_carry": ("linear_attn_scan",
                               "src/repro/kernels/linear_attn_scan.py:158"),
    "linear_attention_causal": ("linear_attn_scan",
                                "src/repro/kernels/linear_attn_scan.py:73"),
    "prf_featmap": ("prf_featmap", "src/repro/kernels/prf_featmap.py:51"),
    "wkv6": ("wkv6_scan", "src/repro/kernels/wkv6_scan.py:60"),
}


def main() -> int:
    # before torch loads: the caching allocator's expandable segments.
    # Phase 9's launcher run (8 x 512) fits the card alone at a 74.30 GB
    # peak, but after phases 2-8 the default allocator held 8.2-9.4 GiB
    # in split cached blocks and step 1's update ran out (an H100 80GB
    # HBM3 at 700 W); expandable segments leave no such blocks. The
    # launcher run alone at that batch wants the same setting (README).
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import COUNTERS, _build

    counters = dict(COUNTERS)
    if counters.keys() != KERNELS.keys():
        fail(f"kernels {sorted(counters)} against {sorted(KERNELS)}")
    mod = {n: m for n, (m, _) in counters.items()}
    kd, kp, kds = (mod[n] for n in ("prf_fused_decode", "prf_fused_prefill",
                                    "prf_decode_step"))
    kl, kf, kw = (mod[n] for n in ("linear_attention_causal", "prf_featmap",
                                   "wkv6"))

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
    errs.update(phase_two_stage_kernels(torch, dev, kds, kl, kw))
    timing = phase_timing(torch, dev, kd, kp)
    timing.update(phase_train_timing(torch, dev, kl, kf))
    timing.update(phase_two_stage_timing(torch, dev, kds, kl, kw))
    # each path's launches come from its own run: the fused serving
    # kernels' from phase 3c, the two-stage ones' from phase 3b, the
    # training kernels' from phase 5 (prf_featmap and wkv6 lie on no
    # path: 0)
    cfg, params, launches, *main = phase_main_path(torch, dev, counters)
    toks, vl, card_run, cpu_run = phase_cross_device(torch, dev, cfg, params)
    two = phase_two_stage_serve(torch, dev, cfg, params, counters, main)
    launches.update({n: two[n] for n in ("prf_decode_step",
                                         "linear_attention_carry")})
    # the serve CLI's default scheduler: B1's and B2's launches on the
    # line come from its run
    ovl, ovl_fields = phase_overlap_serve(torch, dev, cfg, params,
                                          counters, main)
    launches.update({n: ovl[n] for n in ("prf_fused_decode",
                                         "prf_fused_prefill")})
    phase_two_stage_cross(torch, dev, cfg, params, toks, vl, card_run,
                          cpu_run)
    del card_run, cpu_run
    # the exact kind: no kernel on its path
    cfg_e, params_e = phase_exact_serve(torch, dev, counters, ovl_fields)
    # the prefix cache: B1 and B2 on forked rows, exact on paged KV
    prefix_launches = phase_prefix_cache(torch, dev, counters, cfg, params,
                                         cfg_e, params_e)
    del params
    phase_exact_cross(torch, dev, cfg_e, params_e)
    del params_e
    train_launches = phase_train(torch, dev, counters)
    launches.update({n: train_launches[n]
                     for n in ("linear_attention_causal", "prf_featmap",
                               "wkv6")})
    phase_exact_finetune(torch, dev, counters)
    phase_train_cross_device(torch, dev, kl)
    homogeneous = phase_homogeneous(torch, dev, counters)
    recurrent = phase_recurrent(torch, dev, counters)
    recurrent_train = phase_recurrent_train(torch, dev, counters)
    rwkv = phase_rwkv(torch, dev, counters)
    rwkv_train = phase_rwkv_train(torch, dev, counters)
    modalities = phase_modalities(torch, dev, counters)
    runtime, tp_geometry = phase_runtime(torch, dev, counters)
    examples = phase_examples(torch, dev)

    emit({"kernels": [
        {"name": n, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}.cu",
         "replaces": replaces, "launches": launches[n],
         "max_abs_err": errs[n], "ms": timing[n]["ms"],
         "device_ms": timing[n]["device_ms"],
         **{k: timing[n][k] for k in ("ms_warm", "device_ms_warm")
            if k in timing[n]},
         "plain_ms": timing[n]["plain_ms"],
         "launches_prefix_cache": prefix_launches[n],
         "launches_homogeneous": {a: h.get(n, 0)
                                  for a, h in homogeneous.items()},
         "launches_recurrent": recurrent.get(n, 0),
         "launches_recurrent_train": recurrent_train[n],
         "launches_rwkv": rwkv[n],
         "launches_rwkv_train": rwkv_train[n],
         "launches_modalities": {a: m[n] for a, m in modalities.items()},
         "launches_runtime": runtime[n],
         "launches_tp_geometry": tp_geometry.get(n, 0),
         "launches_examples": examples[n],
         "bound_ms": timing[n]["bound_ms"],
         "bound_by": timing[n]["bound_by"], "library_ms": None}
        for n, (src, replaces) in KERNELS.items()],
        "card": card, "total_s": time.perf_counter() - t_start})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
