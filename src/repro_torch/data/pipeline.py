"""Token data pipeline: deterministic, shardable, resumable (port of
``repro/data/pipeline.py``).

Sources:
  * SyntheticLM — seeded Zipf-ish token stream (offline default).
  * FileTokens  — memory-mapped flat token file (one uint32 array).

The pipeline is *stateless by step index*: ``batch_at(step)`` is a pure
function of (seed, step), so restart-from-checkpoint reproduces the exact
stream with no iterator state to persist: the property the trainer's
restart relies on.  It draws with numpy exactly as the reference does,
so both packages give the same batches bit for bit.  Batches stay numpy
arrays here; the train step puts them on the model's device.
:meth:`Pipeline.host_batch_at` slices the global batch by the rank of
``torch.distributed`` when a process group is initialized, and is one
process otherwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from repro_torch.parallel.context import process_grid


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    batch: int
    seq_len: int
    seed: int = 0
    source: str = "synthetic"          # "synthetic" | "file"
    path: Optional[str] = None
    frontend: Optional[str] = None     # audio/vision stubs
    frontend_len: int = 0
    frontend_dim: int = 0
    d_model: int = 0


class SyntheticLM:
    """Zipf-distributed tokens with short-range structure (next-token is
    partially predictable, so training loss decreases measurably)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.p = p / p.sum()

    def tokens_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        toks = rng.choice(cfg.vocab, size=(cfg.batch, cfg.seq_len + 1),
                          p=self.p).astype(np.int32)
        # inject copy structure: token t+1 repeats token t with prob 0.3
        rep = rng.random((cfg.batch, cfg.seq_len)) < 0.3
        toks[:, 1:][rep] = toks[:, :-1][rep]
        return toks


class FileTokens:
    """Flat binary token file; batches are strided windows by step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.arr = np.memmap(Path(cfg.path), dtype=np.uint32, mode="r")

    def tokens_at(self, step: int) -> np.ndarray:
        cfg = self.cfg
        n = cfg.batch * (cfg.seq_len + 1)
        total = len(self.arr) - n - 1
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, total, size=cfg.batch)
        rows = [self.arr[s: s + cfg.seq_len + 1] for s in starts]
        return np.stack(rows).astype(np.int32)


class Pipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.source = FileTokens(cfg) if cfg.source == "file" \
            else SyntheticLM(cfg)

    def batch_at(self, step: int) -> dict:
        """Global batch for ``step`` (pure function of step)."""
        cfg = self.cfg
        toks = self.source.tokens_at(step)
        inputs, targets = toks[:, :-1], toks[:, 1:]
        if cfg.frontend == "audio":
            rng = np.random.default_rng((cfg.seed, step, 1))
            emb = rng.standard_normal(
                (cfg.batch, cfg.seq_len, cfg.d_model)).astype(np.float32)
            return {"frame_embeddings": emb, "targets": targets}
        if cfg.frontend == "vision":
            rng = np.random.default_rng((cfg.seed, step, 1))
            emb = rng.standard_normal(
                (cfg.batch, cfg.frontend_len, cfg.frontend_dim)
            ).astype(np.float32)
            st = cfg.seq_len - cfg.frontend_len
            return {"patch_embeddings": emb, "inputs": inputs[:, :st],
                    "targets": targets[:, :st]}
        return {"inputs": inputs, "targets": targets}

    def host_batch_at(self, step: int) -> dict:
        """This process's slice of the global batch (multi-process
        layout: rank r of n takes rows [r * B / n, (r + 1) * B / n))."""
        pid, n_proc = process_grid()
        full = self.batch_at(step)
        per = self.cfg.batch // n_proc
        return {k: v[pid * per: (pid + 1) * per] for k, v in full.items()}

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


def for_model(model_cfg, batch: int, seq_len: int, seed: int = 0,
              **kw) -> Pipeline:
    return Pipeline(DataConfig(
        vocab=model_cfg.vocab, batch=batch, seq_len=seq_len, seed=seed,
        frontend=model_cfg.frontend, frontend_len=model_cfg.frontend_len,
        frontend_dim=model_cfg.frontend_dim, d_model=model_cfg.d_model,
        **kw))
