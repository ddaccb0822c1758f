"""Serving launcher: a thin CLI over the port's continuous-batching engine.

Runs on the GPU through the hand-written kernels by default
(``--use-kernel``, ``--device cuda``); ``--no-use-kernel`` selects the
plain PyTorch path and ``--device cpu`` runs on the CPU. The overlapped
scheduler is the default (``--overlap``; ``--no-overlap`` selects the
sequential one). ``--load DIR`` serves the params of the newest
checkpoint a trainer wrote there (``{"params", "opt"}``). ``--kernel
exact`` serves softmax attention over a per-slot KV cache; it has no
kernel, so ``--use-kernel`` selects nothing there and the engine's
paths, printed in the header, read ``exact``. ``--prefix-cache`` captures
prefix snapshots at block boundaries and admits later requests that
share a cached prefix by forking its state (for exact attention over
paged KV, path ``exact_paged``); ``--shared-prefix N`` serves traffic
whose prompts open with a shared N-token prefix, ``--prompt-len`` then
giving the suffix's range. ``--mesh-data`` x ``--mesh-model`` above
1 x 1 places the engine's slot and staging pools on a mesh over the
process group ``torchrun`` describes (NCCL for ``--device cuda``, gloo
for ``cpu``; the train launcher's ``make_mesh``): every rank serves the
same requests, the params placed by the reference's "2d" rules (drawn
on the host, or restored from ``--load`` straight onto their
placements, so no device holds the whole tree) and the pools by its
serve-state rules (``ServingEngine(mesh=)``): each rank
holds and computes its share over ``model`` (attention's KV groups,
the MLP's hidden columns, MoE's experts, the vocab slice). At 1 x 1 no
group is made.

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

  # system-prompt traffic through the prefix cache
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --requests 16 --slots 8 --max-len 1024 --chunk-tokens 256 \
      --prefix-cache --shared-prefix 256 --prompt-len 16-128 --gen 16-32

  # serve what the port's trainer saved
  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \
      --load /tmp/ck

  # the pools on a (2, 1) mesh of two gloo ranks on the CPU
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch smollm-135m --reduced --device cpu --mesh-data 2

  # tensor parallel over two gloo ranks: each computes one of 2 KV groups
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
      --arch granite-8b --reduced --device cpu --mesh-model 2
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch.distributed as dist

from repro_torch import checkpoint as ckpt_lib
from repro_torch import configs as cfgs
from repro_torch.models import lm
from repro_torch.serving import (PrefixCacheConfig, ServingEngine,
                                 shared_prefix_requests, synthetic_requests)

SERVABLE = ("exact", "performer", "darkformer", "lfk")


def _parse_range(spec: str) -> tuple[int, int]:
    """'64' -> (64, 64); '16-64' -> (16, 64)."""
    if "-" in spec:
        lo, hi = spec.split("-", 1)
        return int(lo), int(hi)
    return int(spec), int(spec)


def _quiet(*args, **kw) -> None:
    """A rank other than 0 prints nothing."""


def _placed_params(cfg, args, mesh, say) -> dict:
    """This rank's shards of the params on ``mesh``, placed by the
    reference's "2d" rules (``parallel.param_specs``), with no whole copy
    on any device: drawn on the host and placed leaf by leaf, each rank
    moving only its shard, or with ``--load`` restored from the
    checkpoint straight onto their placements (no draw at all)."""
    from repro_torch.launch.dryrun import param_shapes
    from repro_torch.parallel import sharding

    shapes = param_shapes(cfg)
    shardings = sharding.make_shardings(sharding.param_specs(
        shapes, mesh, moe=cfg.moe is not None,
        overrides=cfg.sharding_overrides), mesh)
    if not args.load:
        return sharding.place_tree(
            lm.init_params(cfg, seed=args.seed, device="cpu"), shardings)
    # trainer checkpoints hold {"params", "opt"}: restore the params
    wrapped, step = ckpt_lib.restore_to_shardings(
        args.load, {"params": shapes}, {"params": shardings})
    say(f"loaded params from {args.load} @ step {step}")
    return wrapped["params"]


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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="capture prefix snapshots at block boundaries "
                         "and admit later requests sharing a cached "
                         "prefix by forking its state (O(1) for the PRF "
                         "kinds; exact switches to paged KV with "
                         "copy-on-write page sharing)")
    ap.add_argument("--prefix-block", type=int, default=16,
                    help="prefix-cache capture/match granularity in "
                         "tokens (must divide --chunk-tokens)")
    ap.add_argument("--prefix-device-mb", type=int, default=64,
                    help="device-tier snapshot budget (MiB) before LRU "
                         "demotion to host")
    ap.add_argument("--prefix-host-mb", type=int, default=256,
                    help="host-tier snapshot budget (MiB) before LRU "
                         "eviction")
    ap.add_argument("--page-size", type=int, default=16,
                    help="exact paged-KV page size in tokens "
                         "(prefix-cache engines only)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="generate prefix-heavy traffic: N-token shared "
                         "prompt prefix on ~80%% of requests, "
                         "--prompt-len then the suffix's range (0 = "
                         "fully random prompts)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k sampling (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="per-request nucleus sampling (1.0 = off)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--load", default=None,
                    help="checkpoint dir written by the trainer: serve "
                         "its newest params")
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = cfgs.get_config(args.arch, reduced=args.reduced)
    if args.kernel:
        if args.kernel not in SERVABLE:
            raise SystemExit(f"unservable --kernel {args.kernel!r} "
                             f"(choose from {', '.join(SERVABLE)})")
        cfg = cfgs.darkify(cfg, args.kernel, cfg.attn.num_features)
    cfg = dataclasses.replace(cfg, use_kernel=args.use_kernel)
    if cfg.modality != "text":
        raise SystemExit("serving engine drives text decode only")
    # a non-trivial mesh places the params and the pools; 1 x 1 keeps the
    # engine as it is
    mesh = None
    if args.mesh_data * args.mesh_model > 1:
        from repro_torch.launch.train import make_mesh
        mesh = make_mesh(args.mesh_data, args.mesh_model, args.device)
    say = print if mesh is None or dist.get_rank() == 0 else _quiet

    if mesh is not None:
        params = _placed_params(cfg, args, mesh, say)
    else:
        # with --load every leaf is overwritten: draw the template on the
        # device (seconds at full width, where the host takes minutes)
        params = lm.init_params(cfg, seed=args.seed, device=args.device,
                                draw_on=args.device if args.load else "cpu")
        if args.load:
            # trainer checkpoints hold {"params", "opt"}: restore the params
            wrapped, step = ckpt_lib.restore_checkpoint(args.load,
                                                        {"params": params})
            params = wrapped["params"]
            say(f"loaded params from {args.load} @ step {step}")
    pc = None
    if args.prefix_cache:
        pc = PrefixCacheConfig(block_tokens=args.prefix_block,
                               device_bytes=args.prefix_device_mb << 20,
                               host_bytes=args.prefix_host_mb << 20,
                               page_size=args.page_size)
    engine = ServingEngine(params, cfg, max_slots=args.slots,
                           max_len=args.max_len,
                           chunk_tokens=args.chunk_tokens, seed=args.seed,
                           prefill_rows=args.prefill_rows,
                           bucket_prefill=not args.no_bucket_prefill,
                           overlap=args.overlap, prefix_cache=pc,
                           mesh=mesh, device=args.device)
    if args.shared_prefix > 0:
        reqs = shared_prefix_requests(
            args.requests, cfg.vocab, seed=args.seed, rate=args.rate,
            prefix_len=args.shared_prefix,
            suffix_range=_parse_range(args.prompt_len),
            gen_range=_parse_range(args.gen),
            temperature=args.temperature)
    else:
        reqs = synthetic_requests(
            args.requests, cfg.vocab, seed=args.seed, rate=args.rate,
            prompt_range=_parse_range(args.prompt_len),
            gen_range=_parse_range(args.gen),
            temperature=args.temperature, top_k=args.top_k,
            top_p=args.top_p)
    try:
        for r in reqs:
            engine.submit(r)
    except ValueError as e:                    # e.g. prompt >= max_len
        raise SystemExit(f"bad request: {e}")

    say(f"serving {args.requests} requests over {args.slots} slots "
          f"(kernel={cfg.attn.kind}, path={engine.stats['decode_path']}, "
          f"max_len={args.max_len}, "
          f"rate={args.rate or 'batch'}, device={args.device})")
    results = engine.run(realtime=args.realtime)

    for res in sorted(results, key=lambda r: r.uid):
        span = res.finish_time - res.arrival_time
        say(f"  req {res.uid}: prompt={len(res.prompt)} "
              f"gen={len(res.tokens)} ttft={res.ttft * 1e3:.0f}ms "
              f"span={span:.2f}s tokens[:8]={res.tokens[:8]}")
    st = engine.stats
    say(f"attention paths: prefill={st['prefill_path']} "
          f"decode={st['decode_path']} "
          f"scheduler={'overlap' if st['overlap'] else 'sequential'}")
    if "decode_stall_ms_p50" in st:
        say(f"decode stall (host blocked on token readiness): "
              f"p50={st['decode_stall_ms_p50']:.2f}ms "
              f"p99={st['decode_stall_ms_p99']:.2f}ms "
              f"max={st['decode_stall_ms_max']:.2f}ms; "
              f"dispatch depth mean={st['dispatch_depth_mean']:.1f} "
              f"max={st['dispatch_depth_max']}")
    tpots = np.array([t for r in results for t in r.tpots])
    span = max(r.finish_time for r in results) - min(
        r.arrival_time for r in results)
    say(f"throughput: {st['emitted_tokens'] / max(span, 1e-9):.1f} tok/s "
          f"({st['emitted_tokens']} tokens in {span:.2f}s)")
    if tpots.size:
        say(f"per-token latency: p50={np.percentile(tpots, 50) * 1e3:.1f}ms "
              f"p99={np.percentile(tpots, 99) * 1e3:.1f}ms")
    if "ttft_p50" in st:
        say(f"ttft: p50={st['ttft_p50'] * 1e3:.0f}ms "
              f"p99={st['ttft_p99'] * 1e3:.0f}ms")
    say(f"slot occupancy: {st['mean_occupancy'] * 100:.0f}% over "
          f"{st['decode_steps']} decode steps")
    if "prefix_hits" in st:
        say(f"prefix cache: {st['prefix_hits']} hits, "
              f"{st['prefix_misses']} misses, "
              f"{st['forked_requests']} forked requests "
              f"({st['forked_tokens']} prompt tokens not prefilled), "
              f"{st['prefix_captures']} captures, "
              f"{st['prefix_demotions']} demotions, "
              f"{st['prefix_promotions']} promotions, "
              f"{st['prefix_evictions']} evictions; device "
              f"{st['prefix_device_bytes'] / 2**20:.1f} MiB, host "
              f"{st['prefix_host_bytes'] / 2**20:.1f} MiB")
    say(f"prefill: {st['prefill_tokens']} tokens in "
          f"{st['prefill_chunks']} chunks over {st['prefill_calls']} "
          f"batched calls ({st['prefill_rows_per_call']:.1f} rows/call, "
          f"batch occupancy {st['prefill_batch_occupancy'] * 100:.0f}%, "
          f"max {st['max_prefill_tokens_per_step']} tokens per step)")
    return {**st, "results": results}


if __name__ == "__main__":
    main()
