"""Serving CLI: a thin wrapper over ``repro_torch.serving.ServeEngine``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --smoke --sparse --device cpu

Port of ``repro/launch/serve.py``.  The engine does the work: bucketed
admission, continuous batching, per-window timing (each prefill and each
decode step waits for its work before its clock stops) and MoE
dropped-token stats.  ``--sparse`` routes MoE dispatch and combine and
prefill attention scoring through the ``DistBSR``/``matmul`` engine (B1
and B2 on the card).  It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np


def serve(cfg, *, requests: int, prompt_len: int, gen_len: int,
          max_len: int = None, seed: int = 0, sparse: bool = False,
          max_batch: int = None, device=None):
    """Serve ``requests`` synthetic prompts; returns generations + metrics.

    Runs on the card unless ``device`` says otherwise (a machine without
    one raises)."""
    from repro_torch.serving import ServeEngine

    max_len = max_len or (prompt_len + gen_len + 8)
    rng = np.random.default_rng(seed)
    engine = ServeEngine(cfg, seed=seed, max_len=max_len, sparse=sparse,
                         max_batch=max_batch or min(requests, 4),
                         device=device)
    for _ in range(requests):
        engine.submit(rng.integers(0, cfg.vocab_size, (prompt_len,)),
                      max_new_tokens=gen_len)
    results = engine.run()
    stats = engine.summary()
    gen = np.stack([results[rid] for rid in sorted(results)])
    return {
        "generated": gen,
        "prefill_s": stats["prefill_s"],
        "decode_s": stats["decode_s"],
        "decode_tok_per_s": stats["decode_tok_per_s"] or 0.0,
        "metrics": stats,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--gen-len", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sparse", action="store_true",
                   help="route MoE dispatch / attention scoring through "
                        "the DistBSR plan engine")
    p.add_argument("--device", default=None,
                   help="torch device to serve on (default: the CUDA card; "
                        "'cpu' runs the plain versions of the kernels)")
    p.add_argument("--trace", metavar="PATH", default=None,
                   help="record an execution trace of the serve run and "
                        "write Chrome-trace JSON to PATH (open in "
                        "ui.perfetto.dev)")
    args = p.parse_args(argv)

    from repro_torch import obs
    from repro_torch.configs import get_config
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.is_encoder:
        raise SystemExit(f"{args.arch} is encoder-only; no serve path")
    if cfg.frontend:
        raise SystemExit(f"{args.arch} takes {cfg.frontend} inputs beside "
                         "its tokens; the engine serves token prompts")
    if args.trace:
        obs.enable(clear=True)
    out = serve(cfg, requests=args.requests, prompt_len=args.prompt_len,
                gen_len=args.gen_len, seed=args.seed, sparse=args.sparse,
                device=args.device)
    if args.trace:
        obs.disable()
        trace = obs.export_trace(args.trace)
        print(f"[serve] wrote {len(trace['traceEvents'])} trace events "
              f"to {args.trace}")
        drift = obs.drift_report()
        for key, d in sorted(drift.items()):
            print(f"[serve] drift {key}: ratio {d['ratio']:.2f} "
                  f"over {d['n']} multiplies")
    m = out["metrics"]
    print(f"[serve] prefill {out['prefill_s']:.2f}s, "
          f"decode {out['decode_s']:.2f}s "
          f"({out['decode_tok_per_s']:.1f} tok/s)")
    print(f"[serve] ttft p50/p99 {m['ttft_p50_s']:.3f}/{m['ttft_p99_s']:.3f}s"
          f", tpot p50/p99 {m['tpot_p50_s']:.3f}/{m['tpot_p99_s']:.3f}s")
    print(f"[serve] plan lookups {m['plan_lookups']} "
          f"(hit rate {m['plan_cache_hit_rate']}), "
          f"dropped mean/max {m['dropped_mean']:.4f}/{m['dropped_max']:.4f}")
    print(f"[serve] sample generation: {out['generated'][0][:16].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
