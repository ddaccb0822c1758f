#!/usr/bin/env python3
"""Forked against cold-start streams through the prefix cache, with the
logits at the first token where they part.

Run from the repository root on a machine with a CUDA device:

    python3 scripts/torch_prefix_parity.py              # exact and dark

Serves ``chip_smoke.py`` phase 3e's system-prompt traffic (smollm-135m
at full width, random weights from seed 0; 16 requests, 14 of them on
two shared 256-token prefixes; 8 slots, max_len 1024, chunk_tokens 256,
one staged row per prefill call, the overlapped scheduler) through
three engines per kind, each primed with the shared prefixes:

  * ``cold``: no prefix cache (for exact the contiguous KV cache);
  * ``fork``: ``PrefixCacheConfig()`` defaults, so the sharers fork;
  * ``no_reuse``: the cache with both tier budgets 0, so every entry is
    evicted when it is captured and nothing forks (for exact: paged KV
    on the cold schedule).

Every sampled row's logits are recorded with its request and token
index. Against ``cold``, each run prints one JSON line: the share of
equal tokens; the logits rows bitwise equal up to the first token where
a stream parts, and their largest gap; and for each parting request the
token index, the largest logit gap there, each run's top-2 margin and
the active rows of each run's decode at that token; and the first 40
logits rows that differ before a parting, with the rows beside them in
each run's call. Then a batch probe
per kind: one decode step over 8 prefilled rows (gathered, as the
engine does with a slot free) against the 8 advanced where they lie
(as it does with every slot busy), each row decoded alone and 4 rows
together, from copies of the same state: the rows bitwise equal and the
largest logit gap. Prints the card's name and
power limit first. ``--reduced --device cpu`` rehearses the control flow
on the CPU. Imports neither JAX nor the reference.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# phase 3e's traffic (chip_smoke.PREFIX_TRAFFIC)
TRAFFIC = dict(seed=0, prefix_len=256, n_prefixes=2, reuse=0.8,
               suffix_range=(16, 128), gen_range=(16, 32))


def serve(torch, dev, cfg, params, cache):
    """Prime, then serve the traffic; returns (streams in submission
    order, {(request, token index): (logits row, rows in the call)})."""
    from repro_torch.serving import (Request, ServingEngine,
                                     shared_prefix_requests)
    eng = ServingEngine(params, cfg, max_slots=8, max_len=1024,
                        chunk_tokens=256, prefill_rows=1, seed=0,
                        overlap=True, prefix_cache=cache, device=dev)
    reqs = shared_prefix_requests(16, cfg.vocab, **TRAFFIC)
    lead = collections.Counter(tuple(r.prompt[:256]) for r in reqs)
    for p, n in lead.items():
        if n > 1:
            eng.submit(Request(prompt=list(p) + [1, 2, 3],
                               max_new_tokens=2))
    eng.run()
    index = {r.uid: j for j, r in enumerate(reqs)}
    seen = {}
    sample = eng._sample

    def recorded(logits, rows, counts):
        host = logits.float().cpu()
        for r, (i, n) in enumerate(zip(rows, counts)):
            j = index.get(int(eng._uids[i]))
            if j is not None:
                seen[j, n] = (host[r], len(rows))
        return sample(logits, rows, counts)
    eng._sample = recorded
    for r in reqs:
        eng.submit(r)
    by_uid = {r.uid: r.tokens for r in eng.run()}
    return [by_uid[r.uid] for r in reqs], seen


def margin(row) -> float:
    top = row.topk(2).values
    return float(top[0] - top[1])


def compare(torch, cold, other) -> dict:
    (s0, l0), (s1, l1) = cold, other
    same = [a == b for x, y in zip(s0, s1) for a, b in zip(x, y)]
    parts = []
    firsts = {}
    for j, (x, y) in enumerate(zip(s0, s1)):
        k = next((k for k, (a, b) in enumerate(zip(x, y)) if a != b), None)
        if k is not None:
            firsts[j] = k
            a, na = l0[j, k]
            b, nb = l1[j, k]
            parts.append({"request": j, "token": k,
                          "max_logit_gap": float((a - b).abs().max()),
                          "top2_margin_cold": margin(a),
                          "top2_margin_other": margin(b),
                          "max_abs_logit": float(a.abs().max()),
                          "rows_cold": na, "rows_other": nb})
    before = [key for key in l0
              if key in l1 and key[1] < firsts.get(key[0], 1 << 30)]
    gaps = [float((l0[key][0] - l1[key][0]).abs().max()) for key in before]
    differ = [[*key, gap, l0[key][1], l1[key][1]]
              for key, gap in zip(before, gaps) if gap]
    return {"tokens": len(same), "tokens_equal": sum(same) / len(same),
            "rows_before_parting": len(before),
            "rows_bitwise_equal": sum(g == 0.0 for g in gaps),
            "max_logit_gap_before_parting": max(gaps) if gaps else 0.0,
            "parting": parts,
            # [request, token index, largest gap, rows in each run's call]
            "differing_rows": sorted(differ)[:40]}


def batch_probe(torch, dev, cfg, params) -> dict:
    """One decode step over 8 prefilled rows against each row alone and
    rows 0-3 together, from copies of one state."""
    from repro_torch.models import lm
    from repro_torch.serving import slots as slot_ops
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab, (8, 64), generator=gen).to(dev)
    st = lm.init_serve_state(cfg, b=8, max_len=1024, per_slot=True,
                             device=dev)
    lm.prefill_chunk(params, cfg, {"tokens": toks}, st)
    nxt = torch.randint(0, cfg.vocab, (8,), generator=gen).to(dev)

    def step(rows):
        idx = torch.tensor(rows, device=dev)
        sub = slot_ops.read_slots(st, idx)
        logits, _ = lm.decode_step(params, cfg, nxt[idx], sub)
        return logits.float().cpu()
    full = step(list(range(8)))
    # the engine's path when every slot decodes: the pool advanced where
    # it lies, no gather (slots.freeze_inactive with idx None)
    pool = slot_ops.read_slots(st, torch.arange(8, device=dev))
    inplace = slot_ops.freeze_inactive(
        pool, None, lambda s: lm.decode_step(params, cfg, nxt, s)
    ).float().cpu()
    gaps = [float((inplace[i] - full[i]).abs().max()) for i in range(8)]
    out = {"in_place": {"rows": 8,
                        "rows_bitwise_equal": sum(x == 0.0 for x in gaps),
                        "max_logit_gap": max(gaps)}}
    for name, groups in (("alone", [[i] for i in range(8)]),
                         ("four", [[0, 1, 2, 3]])):
        gaps = []
        for g in groups:
            part = step(g)
            gaps += [float((part[r] - full[i]).abs().max())
                     for r, i in enumerate(g)]
        out[name] = {"rows": len(gaps),
                     "rows_bitwise_equal": sum(x == 0.0 for x in gaps),
                     "max_logit_gap": max(gaps)}
    out["max_abs_logit"] = float(full.abs().max())
    return out


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=("exact", "darkformer", "both"),
                    default="both")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_prefix_parity: no CUDA device", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)

    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.serving import PrefixCacheConfig

    kinds = ("exact", "darkformer") if args.kind == "both" else (args.kind,)
    for kind in kinds:
        cfg = configs.get_config("smollm-135m", reduced=args.reduced,
                                 use_kernel=True)
        if kind == "exact":
            cfg = configs.darkify(cfg, "exact")
        params = lm.init_params(cfg, seed=0, device=dev)
        cold = serve(torch, dev, cfg, params, None)
        for name, cache in (
                ("fork", PrefixCacheConfig()),
                ("no_reuse", PrefixCacheConfig(device_bytes=0,
                                               host_bytes=0))):
            got = compare(torch, cold, serve(torch, dev, cfg, params, cache))
            print(json.dumps({"kind": kind, "run": name, "against": "cold",
                              **got}), flush=True)
        print(json.dumps({"kind": kind, "batch_probe":
                          batch_probe(torch, dev, cfg, params)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
