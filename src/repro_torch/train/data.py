"""Deterministic synthetic data pipeline with async host prefetch.

The port of ``repro.train.data``, pure numpy: batches equal the
reference's bit for bit (the train step moves them to its device).

Stateless-by-step generation: batch ``i`` is a pure function of
``(seed, i)`` (Philox counter RNG), so checkpoint/restart resumes the
stream losslessly with no dataloader state to save — a key piece of the
fault-tolerance story.  A background thread keeps a small prefetch queue
ahead of the training loop (the static-SPMD analogue of the paper's
communication/computation overlap, applied to the host->device edge).

Token stream: Zipf-distributed ids with a deterministic shift structure
so the LM has learnable signal (next-token = f(current), loss should
drop), which the e2e example asserts.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from repro_torch.models.config import ModelConfig

__all__ = ["SyntheticData", "Prefetcher", "mrope_positions"]


class SyntheticData:
    def __init__(
        self,
        cfg: ModelConfig,
        batch: int,
        seq: int,
        seed: int = 0,
    ):
        self.cfg = cfg
        self.batch = batch
        self.seq = seq
        self.seed = seed

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=[self.seed, step]))

    def batch_at(self, step: int) -> dict:
        rng = self._rng(step)
        cfg = self.cfg
        v = cfg.vocab_size
        if cfg.family == "audio":
            # frame embeddings + per-frame class labels, correlated so the
            # classifier head has signal
            labels = rng.integers(0, v, size=(self.batch, self.seq)).astype(np.int32)
            base = rng.normal(size=(v, cfg.d_model)).astype(np.float32)
            embeds = base[labels] + 0.1 * rng.normal(
                size=(self.batch, self.seq, cfg.d_model)
            ).astype(np.float32)
            return {"embeds": embeds, "labels": labels}
        # zipf-ish marginals + learnable next = (3*cur + 7) % V structure
        z = rng.zipf(1.5, size=(self.batch, self.seq))
        tokens = np.minimum(z, v - 1).astype(np.int32)
        half = self.seq // 2
        for t in range(half, self.seq):  # second half is deterministic
            tokens[:, t] = (3 * tokens[:, t - 1] + 7) % v
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = -1  # masked
        if cfg.family == "vlm":
            s_vis = self.seq // 4
            s_text = self.seq - s_vis
            embeds = rng.normal(size=(self.batch, s_vis, cfg.d_model)).astype(
                np.float32
            )
            pos = mrope_positions(self.batch, s_vis, s_text)
            return {
                "tokens": tokens[:, :s_text],
                "embeds": embeds,
                "positions": pos,
                "labels": labels[:, :s_text],
            }
        return {"tokens": tokens, "labels": labels}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def mrope_positions(batch: int, s_vis: int, s_text: int) -> np.ndarray:
    """(B, S, 3) t/h/w positions: vision patches on a ~square grid, text
    sequential after the vision span (Qwen2-VL scheme, simplified)."""
    side = max(int(np.sqrt(s_vis)), 1)
    t = np.zeros(s_vis, np.int32)
    h = (np.arange(s_vis) // side).astype(np.int32)
    w = (np.arange(s_vis) % side).astype(np.int32)
    vis = np.stack([t, h, w], -1)  # (s_vis, 3)
    start = int(vis.max()) + 1
    txt = (start + np.arange(s_text)).astype(np.int32)[:, None].repeat(3, 1)
    pos = np.concatenate([vis, txt], 0)  # (S, 3)
    return np.broadcast_to(pos[None], (batch, s_vis + s_text, 3)).copy()


class Prefetcher:
    """Background-thread prefetch of ``SyntheticData`` batches."""

    def __init__(self, data: SyntheticData, start_step: int = 0, depth: int = 2):
        self.data = data
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.data.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self) -> tuple[int, dict]:
        return self.q.get()

    def stop(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
