"""Training launcher: the fault-tolerant train loop on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
        --steps 200 --batch 8 --seq 256 [--curate] [--device cuda]

The port of ``repro.launch.train``, with its flags and defaults and a
``--device`` (default ``cuda``; ``cpu`` runs on the host).  ``--curate``
selects the training documents through the COAX index on the device
backend (one ``fused_scan`` wave on the card).  Checkpoints land in
``--ckpt-dir`` in the reference's format, and a rerun resumes from the
newest.  ``--reduced-layers`` shrinks the config (``reduced``, shared
with the serving launcher); without it the config runs at full size.
The default arch is mamba2-130m (the ssm family); ``--arch`` takes any
config ``build_model`` builds (dense GQA or MLA, ssm, hybrid).  A mesh
(``--mesh-data`` or ``--mesh-model`` > 1) waits for the port of
``distributed/*`` (ROADMAP queue 1, item 3(c)) and is refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

import torch.distributed as dist

from ..configs import get_config, list_configs
from ..data.curation import CuratedSelector, MetaQuery
from ..data.pipeline import ShardedLoader, make_corpus
from ..models import build_model
from ..optim import AdamWConfig
from ..runtime.train_loop import TrainLoopConfig, train

__all__ = ["reduced", "main"]


def reduced(cfg, layers, d_model):
    return dataclasses.replace(
        cfg, n_layers=layers, d_model=d_model,
        d_ff=max(d_model * 3, 128),
        n_heads=min(cfg.n_heads, 8) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=(d_model // 8) if cfg.head_dim else None,
        vocab_size=min(cfg.vocab_size, 8192),
        enc_layers=min(cfg.enc_layers, layers) if cfg.enc_layers else 0,
        n_patches=min(cfg.n_patches, 16) if cfg.n_patches else 0)


def _process():
    """(index, count) of this process among the job's (1 process unless
    torch.distributed is initialised)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def main(argv=None):
    """Run the launcher; returns ``train``'s output."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), default="mamba2-130m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--reduced-layers", type=int, default=None,
                    help="shrink the config for small runs (None = full)")
    ap.add_argument("--reduced-width", type=int, default=256)
    ap.add_argument("--curate", action="store_true",
                    help="select training docs through the COAX index")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh_data * args.mesh_model > 1:
        ap.error("a (data, model) mesh needs the port of distributed/* "
                 "(ROADMAP queue 1, item 3(c)); run with --mesh-data 1 "
                 "--mesh-model 1")

    cfg = get_config(args.arch)
    if args.reduced_layers:
        cfg = reduced(cfg, args.reduced_layers, args.reduced_width)
    model = build_model(cfg, device=args.device)
    print(f"[launch] {cfg.name}: {model.param_count()/1e6:.1f}M params")

    corpus = make_corpus(50_000, vocab_size=min(cfg.padded_vocab, 32_000))
    doc_ids = None
    if args.curate:
        sel = CuratedSelector(corpus, device=args.device)
        doc_ids = sel.select(MetaQuery(token_len=(args.seq // 2, 32768),
                                       quality=(0.5, 1.1)))
        print(f"[launch] COAX curation: {doc_ids.size:,} docs")
    rank, world = _process()
    loader = ShardedLoader(corpus, batch_size=args.batch, seq_len=args.seq,
                           doc_ids=doc_ids, process_index=rank,
                           process_count=world)
    loop_cfg = TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                               ckpt_every=args.ckpt_every, log_every=10)
    try:
        out = train(model, iter(loader), AdamWConfig(lr=args.lr), loop_cfg)
    finally:
        loader.close()
    print(f"[launch] finished step {out['final_step']}, "
          f"loss {out['history'][-1]['loss']:.4f}, restarts {out['restarts']}")
    return out


if __name__ == "__main__":
    main()
