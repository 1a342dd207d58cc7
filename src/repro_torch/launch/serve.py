"""Serving launcher: the COAX-routed wave-batched server on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-3-4b \
        --requests 64 [--reduced-layers 4] [--device cuda]

Initialises the model from ``--seed`` (float32 masters cast once to the
activation dtype), spins up the Server with a CoaxRouter on the same
device and drains a synthetic request stream, reporting wave composition
and token throughput.  ``--reduced-layers 0`` serves the full config.
``--ckpt-dir`` (restoring trained weights) needs the training slice's
checkpointer and optimizer state; until then it is refused.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from ..configs import get_config, list_configs
from ..models import build_model
from ..models.common import cast_params, make_generator
from ..runtime.serve_loop import ServeConfig, Server
from .train import reduced


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), default="h2o-danube-3-4b")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=512)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--reduced-layers", type=int, default=4)
    ap.add_argument("--reduced-width", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.ckpt_dir:
        ap.error("--ckpt-dir needs runtime/checkpoint.py and the optimizer "
                 "state, which the port does not have yet (ROADMAP queue 1, "
                 "item 3(a))")

    cfg = get_config(args.arch)
    if args.reduced_layers:
        cfg = reduced(cfg, args.reduced_layers, args.reduced_width)
    model = build_model(cfg, device=args.device)
    cast_params(model.init(make_generator(args.seed, args.device)))

    srv = Server(model, ServeConfig(
        batch_size=args.batch_size, max_new_tokens=args.max_new,
        cache_len=args.cache_len, eos_token=0), device=args.device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        plen = int(rng.choice([16, 32, 64, 128]))
        srv.submit(rng.integers(1, cfg.padded_vocab - 1, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(4, args.max_new)),
                   priority=float(rng.random()))
    print(f"[serve] {args.requests} requests queued; "
          f"router: {srv.router.stats()}")
    t0 = time.time()
    results = srv.run_until_drained(max_waves=200)
    dt = time.time() - t0
    toks = sum(r.tokens.size for r in results)
    print(f"[serve] {len(results)} responses, {srv.waves} waves, "
          f"{toks} tokens in {dt:.1f}s ({toks/max(dt,1e-9):.0f} tok/s)")


if __name__ == "__main__":
    main()
