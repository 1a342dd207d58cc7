"""End-to-end training driver on the PyTorch port: COAX-curated data ->
sharded loader -> fault-tolerant train loop with checkpointing.

    PYTHONPATH=src python examples/train_lm_torch.py                  # quick preset
    PYTHONPATH=src python examples/train_lm_torch.py --preset 130m --steps 300
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu     # on the host

The twin of ``examples/train_lm.py`` on ``repro_torch``.  The quick preset
(default) trains a ~10M-param danube-style model for 200 steps;
``--preset 130m`` selects the full mamba2-130m assigned config (a
~100M-class model) — same code path, more compute.  Curation selects
through the COAX index on ``--device`` (default ``cuda``; asked for
``cuda`` without a card it raises before any work), and the model trains
there.  On a real cluster the identical script runs under
``repro_torch.launch.mesh.make_production_mesh`` with the dry run's
shardings (``repro_torch.launch.train --mesh-data --mesh-model`` drives
the train loop on a mesh).
"""
import argparse
import dataclasses
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config
from repro_torch.data.curation import CuratedSelector, MetaQuery
from repro_torch.data.pipeline import ShardedLoader, make_corpus
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.train_loop import TrainLoopConfig, train
from repro_torch.storage.snapshot import require_device

CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def make_model(preset: str, device: str = "cuda"):
    if preset == "130m":
        return build_model(get_config("mamba2-130m"), device=device)
    cfg = dataclasses.replace(
        get_config("h2o-danube-3-4b"),
        n_layers=4, d_model=256, d_ff=768, vocab_size=8192,
        n_heads=8, n_kv_heads=4, head_dim=32, window=256)
    return build_model(cfg, device=device)


def main(device: str = "cuda", *, preset: str = "quick", steps: int = 200,
         batch: int = 4, seq: int = 256, ckpt_dir: str = CKPT_DIR,
         docs: int = 30_000) -> dict:
    """Curate, load, train; returns ``train``'s output."""
    require_device("device", device)
    model = make_model(preset, device)
    vocab = model.cfg.padded_vocab
    print(f"model: {model.cfg.name} ({model.param_count()/1e6:.1f}M params)")

    # COAX-curated corpus: select mid-length, high-quality documents through
    # the paper's index (the data-plane integration, DESIGN.md §2).
    corpus = make_corpus(docs, vocab_size=min(vocab, 32_000), seed=0)
    sel = CuratedSelector(corpus, device=device)
    selected = sel.select(MetaQuery(token_len=(256, 8192), quality=(0.5, 1.1)))
    print(f"curation: {selected.size:,}/{corpus.meta.shape[0]:,} docs selected "
          f"via COAX ({sel.build_time*1e3:.0f} ms build)")

    loader = ShardedLoader(corpus, batch_size=batch, seq_len=seq,
                           doc_ids=selected, seed=1)
    try:
        out = train(
            model, iter(loader), AdamWConfig(lr=1e-3),
            TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir,
                            ckpt_every=50, log_every=10, warmup=20))
    finally:
        loader.close()
    print(f"done: {out['final_step']} steps, final loss "
          f"{out['history'][-1]['loss']:.4f}, restarts={out['restarts']}, "
          f"stragglers={len(out['stragglers'])}")
    out["selected"] = selected
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--preset", choices=["quick", "130m"], default="quick")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=CKPT_DIR)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.device, preset=args.preset, steps=args.steps, batch=args.batch,
         seq=args.seq, ckpt_dir=args.ckpt_dir)
