"""Batched serving loop: COAX-routed admission -> prefill -> decode waves.

The port of ``repro.runtime.serve_loop``.  The router admits a
length-homogeneous batch (a range query on prompt_len: COAX's job), the
wave prefills once and decodes greedily until every sequence finishes or
hits its budget, then the next wave is admitted.  Slots of a wave share
the step counter.

``Server`` runs on ``device`` (default ``"cuda"``; no card raises at
construction), the model's device, and builds its default router there
on the device backend, so each admission against a built index is a
``fused_scan`` wave on the same card.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import List, Optional

import numpy as np
import torch

from ..models.model import Model, _resolve_device
from .router import CoaxRouter, Request

__all__ = ["ServeConfig", "Server", "ServeResult"]


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8
    max_prompt_len: int = 512
    max_new_tokens: int = 64
    cache_len: int = 1024
    eos_token: int = 1


@dataclasses.dataclass
class ServeResult:
    rid: int
    tokens: np.ndarray
    prompt_len: int
    wave: int
    latency_s: float


class Server:
    def __init__(self, model: Model, cfg: ServeConfig,
                 router: Optional[CoaxRouter] = None, *, device="cuda"):
        self.device = _resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"the model lives on {model.device}, the "
                             f"server was asked for {self.device}")
        self.model = model
        self.cfg = cfg
        self.router = router or CoaxRouter(device=str(self.device))
        self._prefill = functools.partial(model.prefill,
                                          cache_len=cfg.cache_len)
        self._decode = model.decode_step
        self.waves = 0

    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None,
               priority: float = 0.0) -> int:
        return self.router.submit(prompt, max_new_tokens or self.cfg.max_new_tokens,
                                  priority)

    # ------------------------------------------------------------------ #
    def _pad_prompts(self, reqs: List[Request]) -> np.ndarray:
        """Left-pad with token 0 to a common length, so position S-1 is the
        last prompt token of every row.  No attention mask, as in the
        reference: the pads are attended to (wave batches are
        length-homogeneous by routing, so there are few)."""
        s = max(r.prompt_len for r in reqs)
        out = np.zeros((len(reqs), s), np.int32)
        for i, r in enumerate(reqs):
            out[i, s - r.prompt_len:] = r.prompt
        return out

    @staticmethod
    def _greedy(logits: torch.Tensor) -> torch.Tensor:
        return logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]

    def run_wave(self) -> List[ServeResult]:
        cfg = self.cfg
        # admission: length-homogeneous band around the oldest pending request
        reqs = self.router.admit(
            cfg.batch_size, prompt_len_range=(0, cfg.max_prompt_len))
        if not reqs:
            return []
        t0 = time.time()
        prompts = self._pad_prompts(reqs)
        b, s = prompts.shape

        logits, cache = self._prefill(
            {"tokens": torch.from_numpy(prompts).to(self.device)})
        max_new = max(r.max_new_tokens for r in reqs)
        budget = np.array([r.max_new_tokens for r in reqs])
        out_tokens = np.zeros((b, max_new), np.int32)
        done = np.zeros(b, bool)

        tok = self._greedy(logits)
        for t in range(max_new):
            tok_np = tok[:, 0].cpu().numpy()
            out_tokens[:, t] = np.where(done, cfg.eos_token, tok_np)
            done |= tok_np == cfg.eos_token
            done |= t + 1 >= budget
            if done.all():
                break
            logits, cache = self._decode(cache, tok, s + t)
            tok = self._greedy(logits)

        dt = time.time() - t0
        self.waves += 1
        results = []
        for i, r in enumerate(reqs):
            n = min(r.max_new_tokens, max_new)
            results.append(ServeResult(
                rid=r.rid, tokens=out_tokens[i, :n], prompt_len=r.prompt_len,
                wave=self.waves, latency_s=dt))
        return results

    def run_until_drained(self, max_waves: int = 100) -> List[ServeResult]:
        out: List[ServeResult] = []
        for _ in range(max_waves):
            res = self.run_wave()
            if not res and len(self.router) == 0:
                break
            out.extend(res)
        return out
