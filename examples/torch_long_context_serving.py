"""O(1)-state long-context serving in the PyTorch port, the counterpart
of examples/long_context_serving.py: the PRF decode state is (m x d_v) a
head whatever the context's length, so 1k, 8k and 64k contexts cost the
same (the paper's headline efficiency property), while an exact KV cache
grows linearly. The config, the contexts and the decode steps are the
JAX example's; the attention runs through the hand-written kernels
(``use_kernel``).

Runs on the GPU by default; ``--device cpu`` runs the kernels' plain
versions on the CPU:

    PYTHONPATH=src python examples/torch_long_context_serving.py
    PYTHONPATH=src python examples/torch_long_context_serving.py \
        --device cpu --contexts 1024

Prints the launches of each of the seven kernels the run made.
"""
import argparse
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs as cfgs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def state_bytes(state) -> int:
    """Bytes of every tensor in a serve state (dicts, lists and the
    blocks' named tuples)."""
    if isinstance(state, dict):
        return sum(state_bytes(v) for v in state.values())
    if isinstance(state, (tuple, list)):
        return sum(state_bytes(v) for v in state)
    return state.numel() * state.element_size() \
        if isinstance(state, torch.Tensor) else 0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--contexts", type=int, nargs="+",
                    default=[1024, 8192, 65536])
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    kernels.reset_launch_counts()

    cfg = cfgs.get_config("smollm-135m", reduced=True,
                          use_kernel=True)                  # darkformer
    cfg_exact = cfgs.darkify(cfg, "exact")
    params = lm.init_params(cfg, seed=0, device=dev)
    tok = torch.zeros((1,), dtype=torch.int64, device=dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rows = []
    print(f"{'context':>10s} {'PRF state':>12s} {'KV cache':>12s} "
          f"{'PRF us/tok':>11s}")
    with torch.no_grad():
        for ctx in args.contexts:
            st = lm.init_serve_state(cfg, b=1, max_len=ctx, device=dev)
            st_e = lm.init_serve_state(cfg_exact, b=1, max_len=ctx,
                                       device=dev)
            prf, kv = state_bytes(st), state_bytes(st_e)
            _, st2 = lm.decode_step(params, cfg, tok, st)    # warm-up
            sync()
            t0 = time.perf_counter()
            for _ in range(10):
                _, st2 = lm.decode_step(params, cfg, tok, st2)
            sync()
            us = (time.perf_counter() - t0) / 10 * 1e6
            rows.append({"context": ctx, "prf_state_bytes": prf,
                         "kv_cache_bytes": kv, "prf_us_per_token": us})
            print(f"{ctx:10d} {prf/1e3:10.1f}KB {kv/1e3:10.1f}KB "
                  f"{us:11.0f}")
            del st, st_e, st2
    print("PRF state & decode cost are context-independent; the KV cache "
          "grows linearly.")
    launches = kernels.launch_counts()
    print("kernel launches:", launches)
    return {"rows": rows, "launches": launches}


if __name__ == "__main__":
    main()
