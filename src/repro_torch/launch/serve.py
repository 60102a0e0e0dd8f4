"""Serve a transformer LM: wave-batched greedy decode with KV caches and
recurrent states (the JAX package's ``repro.launch.serve``).

    python -m repro_torch.launch.serve --arch qwen2_5_3b --requests 8
    python -m repro_torch.launch.serve --arch qwen2_5_3b --smoke \\
        --device cpu --requests 3
    python -m repro_torch.launch.serve --arch zamba2_1_2b --smoke \\
        --requests 6 --slots 3 --prompt-len 6 --max-new 12 --device cpu

``--arch`` is one of ``configs.ARCH_IDS`` but the enc-dec whisper-small,
whose encoder input a request does not carry (the engine refuses it);
``--smoke`` cuts it to toy dimensions (``configs.reduce_experiment``, as
``launch.train --smoke``).  Parameters come from seed 0 and the prompts,
``--prompt-len`` tokens each, from ``numpy.random.RandomState(0)``;
``--slots`` requests a wave, ``--max-new`` tokens each, KV caches of
``prompt-len + max-new + 8`` positions.  Runs on the card unless
``--device cpu`` is given.  Prints ``served N requests, T tokens in Xs (R
tok/s)`` and the first three requests' first tokens.  The JAX package's
``examples/serve_batched.py`` is this engine with other defaults: ``--smoke
--requests 6 --slots 3 --prompt-len 6 --max-new 12``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs import ARCH_IDS, get_experiment, reduce_experiment
from repro_torch.core.device import resolve_device
from repro_torch.models.transformer import TransformerLM
from repro_torch.serving.engine import Request, ServeEngine


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--smoke", action="store_true",
                    help="reduce the model to toy dimensions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    exp = get_experiment(args.arch)
    if args.smoke:
        exp = reduce_experiment(exp)
    m = exp.model
    model = TransformerLM(m, exp.e2, seed=0, device=dev)
    try:
        engine = ServeEngine(exp, model, batch_slots=args.slots,
                             max_len=args.prompt_len + args.max_new + 8,
                             device=dev)
    except ValueError as e:                     # the enc-dec: no frontend
        ap.error(str(e))
    rng = np.random.RandomState(0)
    for i in range(args.requests):
        engine.submit(Request(rid=i,
                              prompt=rng.randint(0, m.vocab_size,
                                                 size=args.prompt_len),
                              max_new=args.max_new))
    t0 = time.perf_counter()
    done = engine.run()
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / dt:.1f} tok/s)")
    for r in done[:3]:
        print(f"  rid={r.rid} out[:8]={r.out[:8]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
