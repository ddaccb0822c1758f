"""Serving launcher: a thin CLI over the port's continuous-batching engine.

Runs on the GPU through the hand-written kernels by default
(``--use-kernel``, ``--device cuda``); ``--no-use-kernel`` selects the
plain PyTorch path and ``--device cpu`` runs on the CPU. The overlapped
scheduler is the default (``--overlap``; ``--no-overlap`` selects the
sequential one). ``--load DIR`` serves the params of the newest
checkpoint a trainer wrote there (``{"params", "opt"}``). ``--kernel
exact`` serves softmax attention over a per-slot KV cache; it has no
kernel, so ``--use-kernel`` selects nothing there and the engine's
paths, printed in the header, read ``exact``.

Examples:
  # 8 requests over 4 slots on the GPU, greedy
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --requests 8 --slots 4 --prompt-len 16-64 --gen 32

  # the reduced config on the CPU, chunked prefill, sequential scheduler
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --reduced --device cpu --chunk-tokens 16 --no-overlap

  # exact softmax attention, the paper's baseline
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --kernel exact --max-len 1024

  # serve what the port's trainer saved
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --load /tmp/ck
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from repro_torch import checkpoint as ckpt_lib
from repro_torch import configs as cfgs
from repro_torch.models import lm
from repro_torch.serving import ServingEngine, synthetic_requests

SERVABLE = ("exact", "performer", "darkformer", "lfk")


def _parse_range(spec: str) -> tuple[int, int]:
    """'64' -> (64, 64); '16-64' -> (16, 64)."""
    if "-" in spec:
        lo, hi = spec.split("-", 1)
        return int(lo), int(hi)
    return int(spec), int(spec)


def main(argv=None) -> dict:
    """Serve synthetic traffic and print the report. Returns the engine's
    stats plus the results under "results"."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m",
                    choices=list(cfgs.ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--kernel", default=None,
                    help=f"{'|'.join(SERVABLE)} (default: config)")
    ap.add_argument("--slots", type=int, default=4,
                    help="decode slots (max concurrent sequences)")
    ap.add_argument("--max-len", type=int, default=256,
                    help="per-slot context budget (prompt + generated)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", default="16-64",
                    help="prompt length or lo-hi range")
    ap.add_argument("--gen", default="32", help="new tokens or lo-hi range")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate (req/s); 0 = all at t=0")
    ap.add_argument("--realtime", action="store_true",
                    help="sleep through arrival gaps instead of skipping")
    ap.add_argument("--chunk-tokens", type=int, default=None,
                    help="chunked prefill: at most N prompt tokens per "
                         "engine step (default: whole prompts)")
    ap.add_argument("--prefill-rows", type=int, default=None,
                    help="cap on staged admissions sharing one batched "
                         "prefill call (default: all staged)")
    ap.add_argument("--no-bucket-prefill", action="store_true",
                    help="disable pow-2 bucketing of packed chunk lengths")
    ap.add_argument("--overlap", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="pipelined step loop: decode dispatched before "
                         "prefill, the next chunk packed while the device "
                         "works, tokens read back one step late without a "
                         "blocking copy (--no-overlap = the sequential "
                         "scheduler)")
    ap.add_argument("--use-kernel", default=True,
                    action=argparse.BooleanOptionalAction,
                    help="run prefill/decode through the fused CUDA "
                         "kernels (on a CPU device their plain versions); "
                         "--no-use-kernel selects the plain PyTorch path; "
                         "no effect with --kernel exact, which has no "
                         "kernel")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k sampling (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus sampling (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load", default=None,
                    help="checkpoint dir written by the trainer: serve "
                         "its newest params")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfgs.get_config(args.arch, reduced=args.reduced)
    if args.kernel:
        if args.kernel not in SERVABLE:
            raise SystemExit(f"unservable --kernel {args.kernel!r} "
                             f"(choose from {', '.join(SERVABLE)})")
        cfg = cfgs.darkify(cfg, args.kernel, cfg.attn.num_features)
    cfg = dataclasses.replace(cfg, use_kernel=args.use_kernel)

    params = lm.init_params(cfg, seed=args.seed, device=args.device)
    if args.load:
        # trainer checkpoints hold {"params", "opt"}: restore the params
        wrapped, step = ckpt_lib.restore_checkpoint(args.load,
                                                    {"params": params})
        params = wrapped["params"]
        print(f"loaded params from {args.load} @ step {step}")
    engine = ServingEngine(params, cfg, max_slots=args.slots,
                           max_len=args.max_len,
                           chunk_tokens=args.chunk_tokens, seed=args.seed,
                           prefill_rows=args.prefill_rows,
                           bucket_prefill=not args.no_bucket_prefill,
                           overlap=args.overlap, device=args.device)
    reqs = synthetic_requests(
        args.requests, cfg.vocab, seed=args.seed, rate=args.rate,
        prompt_range=_parse_range(args.prompt_len),
        gen_range=_parse_range(args.gen), temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p)
    try:
        for r in reqs:
            engine.submit(r)
    except ValueError as e:                    # e.g. prompt >= max_len
        raise SystemExit(f"bad request: {e}")

    print(f"serving {args.requests} requests over {args.slots} slots "
          f"(kernel={cfg.attn.kind}, path={engine.stats['decode_path']}, "
          f"max_len={args.max_len}, "
          f"rate={args.rate or 'batch'}, device={args.device})")
    results = engine.run(realtime=args.realtime)

    for res in sorted(results, key=lambda r: r.uid):
        span = res.finish_time - res.arrival_time
        print(f"  req {res.uid}: prompt={len(res.prompt)} "
              f"gen={len(res.tokens)} ttft={res.ttft * 1e3:.0f}ms "
              f"span={span:.2f}s tokens[:8]={res.tokens[:8]}")
    st = engine.stats
    print(f"attention paths: prefill={st['prefill_path']} "
          f"decode={st['decode_path']} "
          f"scheduler={'overlap' if st['overlap'] else 'sequential'}")
    if "decode_stall_ms_p50" in st:
        print(f"decode stall (host blocked on token readiness): "
              f"p50={st['decode_stall_ms_p50']:.2f}ms "
              f"p99={st['decode_stall_ms_p99']:.2f}ms "
              f"max={st['decode_stall_ms_max']:.2f}ms; "
              f"dispatch depth mean={st['dispatch_depth_mean']:.1f} "
              f"max={st['dispatch_depth_max']}")
    tpots = np.array([t for r in results for t in r.tpots])
    span = max(r.finish_time for r in results) - min(
        r.arrival_time for r in results)
    print(f"throughput: {st['emitted_tokens'] / max(span, 1e-9):.1f} tok/s "
          f"({st['emitted_tokens']} tokens in {span:.2f}s)")
    if tpots.size:
        print(f"per-token latency: p50={np.percentile(tpots, 50) * 1e3:.1f}ms "
              f"p99={np.percentile(tpots, 99) * 1e3:.1f}ms")
    if "ttft_p50" in st:
        print(f"ttft: p50={st['ttft_p50'] * 1e3:.0f}ms "
              f"p99={st['ttft_p99'] * 1e3:.0f}ms")
    print(f"slot occupancy: {st['mean_occupancy'] * 100:.0f}% over "
          f"{st['decode_steps']} decode steps")
    print(f"prefill: {st['prefill_tokens']} tokens in "
          f"{st['prefill_chunks']} chunks over {st['prefill_calls']} "
          f"batched calls ({st['prefill_rows_per_call']:.1f} rows/call, "
          f"batch occupancy {st['prefill_batch_occupancy'] * 100:.0f}%, "
          f"max {st['max_prefill_tokens_per_step']} tokens per step)")
    return {**st, "results": results}


if __name__ == "__main__":
    main()
