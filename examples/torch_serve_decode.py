"""Serve a small model through the PyTorch port's ServeEngine: continuous
batching + greedy decode, verified against the unbatched reference path.

Run:  PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
      [--arch llama3-8b] [--sparse]

The port of ``examples/serve_decode.py``.  Exercises the request-level
serving path (bucketed admission, per-request positions, cache rows
spliced at step boundaries) on the smoke config of ``--arch`` and checks
each decoded continuation against an unbatched greedy decode of the same
prompt (``lm.prefill`` and ``lm.make_decode_step``).  With ``--sparse`` the
MoE dispatch and combine and the prefill scores go through the plan API
(the hand-written B1 and B2 kernels on the card).  Every token must equal
the reference's, as in the JAX example.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm, transformer as tf  # noqa: E402
from repro_torch.runtime.device import strict_fp32  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

def reference(model, cfg, toks, steps: int, max_len: int, dev):
    """Unbatched greedy decode of one prompt: its tokens."""
    batch = {"tokens": torch.as_tensor(toks[None], dtype=torch.int32,
                                       device=dev)}
    logits, caches, pos = lm.prefill(model, batch, cfg, max_len,
                                     cache_dtype=torch.float32)
    step = lm.make_decode_step(cfg)
    out = []
    for _ in range(steps):
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        out.append(int(tok))
        logits, caches = step(model, tok, caches, pos)
        pos = pos + 1
    return np.asarray(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="recurrentgemma-2b")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=24)
    p.add_argument("--gen-len", type=int, default=12)
    p.add_argument("--sparse", action="store_true",
                   help="MoE dispatch / attention scoring via plan_matmul")
    p.add_argument("--device", default="cuda",
                   help="cuda (the card, the default) or cpu")
    args = p.parse_args(argv)
    dev = torch.device(args.device)
    strict_fp32()

    cfg = get_config(args.arch, smoke=True)
    max_len = args.prompt_len + args.gen_len + 8
    model = tf.init_params(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (args.prompt_len,))
               for _ in range(args.requests)]

    engine = ServeEngine(cfg, params=model, max_batch=2, max_len=max_len,
                         sparse=args.sparse, device=dev)
    for toks in prompts:
        engine.submit(toks, max_new_tokens=args.gen_len)
    results = engine.run()
    m = engine.summary()
    print(f"[serve] {args.arch}: prefill {m['prefill_s']:.2f}s, "
          f"decode {m['decode_s']:.2f}s "
          f"({(m['decode_tok_per_s'] or 0):.1f} tok/s on {dev})")
    print(f"[serve] ttft p50 {m['ttft_p50_s']:.3f}s, "
          f"tpot p50 {m['tpot_p50_s']:.3f}s")
    print(f"[serve] generations:\n"
          f"{np.stack([results[r] for r in sorted(results)])}")

    # continuous-batched decode against the unbatched reference
    for rid, toks in enumerate(prompts):
        want = reference(model, cfg, toks, args.gen_len, max_len, dev)
        diff = np.flatnonzero(results[rid] != want)
        if diff.size:
            print(f"[serve] request {rid} diverges from the reference at "
                  f"token {int(diff[0])}: FAILED")
            return 1
    print(f"[serve] engine decode == unbatched greedy reference on {dev}: "
          f"{len(prompts)} requests exact: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
