"""Deterministic synthetic LM data (port of ``repro.data.synthetic``).

A numpy copy of the reference's generator: token streams keyed by (seed,
step, host), a fixed random Markov chain over the vocab (so loss falls)
or uniform tokens.  Only the last step differs —
``torch.from_numpy(...).to(device)`` instead of ``jnp.asarray`` — so both
packages see the same batches.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mode: str = "markov"      # markov | uniform
    branching: int = 4         # successors per token in markov mode
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    def __init__(self, cfg: DataConfig, device="cpu"):
        self.cfg = cfg
        self.device = torch.device(device)
        if cfg.global_batch % cfg.n_hosts != 0:
            raise ValueError("global_batch must divide evenly across hosts")
        self.per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.RandomState(cfg.seed)
        # fixed transition table: token t -> one of `branching` successors
        self.table = rng.randint(0, cfg.vocab,
                                 size=(cfg.vocab, cfg.branching)).astype(np.int32)

    def tokens_at(self, step: int) -> np.ndarray:
        """(per_host, seq_len) int32 tokens of a global step — a pure
        function of (seed, step, host)."""
        cfg = self.cfg
        rng = np.random.RandomState(
            (cfg.seed * 1_000_003 + step * 1_009 + cfg.host_id) % (2**31 - 1))
        if cfg.mode == "uniform":
            return rng.randint(0, cfg.vocab, size=(self.per_host, cfg.seq_len)
                               ).astype(np.int32)
        toks = np.empty((self.per_host, cfg.seq_len), np.int32)
        toks[:, 0] = rng.randint(0, cfg.vocab, size=self.per_host)
        choices = rng.randint(0, cfg.branching,
                              size=(self.per_host, cfg.seq_len - 1))
        for t in range(1, cfg.seq_len):
            toks[:, t] = self.table[toks[:, t - 1], choices[:, t - 1]]
        return toks

    def batch_at(self, step: int) -> dict:
        toks = torch.from_numpy(self.tokens_at(step).astype(np.int64))
        toks = toks.to(self.device)
        return {"tokens": toks, "labels": toks}


class PrefetchIterator:
    """One-batch lookahead, so the host makes the next batch while the
    device computes."""

    def __init__(self, source: SyntheticLM, start_step: int = 0):
        self.source = source
        self.step = start_step
        self._next = source.batch_at(start_step)

    def __next__(self) -> dict:
        out = self._next
        self.step += 1
        self._next = self.source.batch_at(self.step)
        return out


class _StubFrontend:
    """A stub modality frontend over a token source (the reference's
    launcher wraps its stream the same way): each batch gains ``key``, a
    standard-normal tensor of ``shape``.  The reference draws
    ``jax.random.normal(PRNGKey(step + 1))``; the port cannot draw
    ``jax.random``, so it draws from a ``torch.Generator`` seeded by
    (seed, step) on the source's device: the same law, other numbers."""

    def __init__(self, source: SyntheticLM, key: str, shape: tuple):
        self.source = source
        self.device = source.device
        self.key = key
        self.shape = shape

    def batch_at(self, step: int) -> dict:
        out = self.source.batch_at(step)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.source.cfg.seed * 1_000_003 + step) % (2**63 - 1))
        out[self.key] = torch.randn(self.shape, generator=gen,
                                    device=self.device)
        return out


class VisionStubLM(_StubFrontend):
    """The vlm family's stub frontend: ``vision_embeds`` (B,
    vision_tokens, d_model)."""

    def __init__(self, source: SyntheticLM, vision_tokens: int,
                 d_model: int):
        super().__init__(source, "vision_embeds",
                         (source.per_host, vision_tokens, d_model))


class SourceStubLM(_StubFrontend):
    """The encdec family's stub frontend: ``src_embeds`` (B, seq_len,
    d_model), frame embeddings as long as the token rows, as the
    reference's launcher draws them."""

    def __init__(self, source: SyntheticLM, d_model: int):
        super().__init__(source, "src_embeds",
                         (source.per_host, source.cfg.seq_len, d_model))
