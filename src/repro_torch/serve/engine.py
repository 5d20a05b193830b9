"""Serving engines: prefill + batched decode over KV (and SSM) caches.

Port of ``repro.serve.engine``:

- :class:`ServeEngine` — fixed decode batch over a contiguous cache, for
  the dense, vlm, hybrid, moe and encdec families, and over the xlstm
  family's constant-size state; the simple baseline and the
  token-for-token oracle of the continuous engine.
- :class:`ContinuousServeEngine` — dense family only: slot-level
  continuous batching over the paged cache (``serve.kv_cache``) driven
  by ``serve.scheduler``: per-slot admission with full-budget
  reservation, per-request max_new/EOS stop, and mid-decode refill.

Both run on ``device="cuda"`` unless told otherwise, and raise if no card
is present; ``device="cpu"`` serves through the kernels' plain versions.
Params are cast once to the compute dtype and moved to the device at
construction, but for the norms' ``scale`` and ``bias`` and the
family's ``FP32_LEAVES``, which stay fp32 as the reference reads them.
Deliberate differences from JAX: a request that could never be admitted
(its budget is wider than a slot's table or the whole pool) raises
``ValueError`` instead of looping forever; the continuous engine refuses
the vlm family at construction, where the reference's admits it and then
fails in its first prefill (its ``_start`` passes no ``vision_embeds``).

Both take ``mesh=``, a ``torch.distributed`` ``DeviceMesh`` whose device
type is the engine's (one process a device, ``launch.mesh``), and both
``from_train_state`` take a state that a mesh built, DTensor leaves and
all.  Under a mesh the params are placed by ``dist.shardings``'
``param_shardings``, as the trainer places them, and gathered to full
tensors once a ``generate`` or ``run`` call (no copy where a leaf
replicates, as every leaf does at a model size of 1): the model runs on
plain tensors, through the kernels, as without a mesh.
:class:`ServeEngine` splits the batch's rows over the data axes by the
batch rule (every data rank runs every row where the batch does not
divide, and for the moe family, whose experts' capacity couples a
batch's rows), builds its rows' cache whole and gathers the sampled tokens
over the data axes once at the end, so every rank returns every prompt's
tokens; the model axis repeats its rows' compute.  The reference splits
the cache's sequence or state dim over ``model`` and leaves the compute
to GSPMD (ROADMAP, deliberate differences).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import (flatten_with_paths,
                                       unflatten_from_paths)
from repro_torch.configs.base import ArchConfig
from repro_torch.dist import shardings as S
from repro_torch.models import get_family
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.scheduler import Scheduler, ServeRequest

PyTree = Any

_PAD_FAMILIES = ("dense", "vlm")   # families whose prefill masks left pad
# families whose prefill couples a batch's rows: the moe layer's expert
# capacity is shared by all the batch's tokens, so a rank's rows alone
# would drop other routes; under a mesh their rows are not split
_ROW_COUPLED = ("moe",)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last dim; ties go to the first index, as
    ``jnp.argmax`` does."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _extract_params(state_or_params):
    """Accept a TrainState-like object (``.params``), a ``{"params": ...}``
    dict, or bare params."""
    params = getattr(state_or_params, "params", state_or_params)
    if isinstance(params, dict) and "params" in params \
            and isinstance(params["params"], dict):
        params = params["params"]
    return params


# The norms' leaves: the reference's engines keep params as passed, and
# its rmsnorm and layernorm multiply fp32 activations by an fp32 ``scale``
# and add an fp32 ``bias`` (no other leaf of any family has these names).
NORM_LEAVES = ("scale", "bias")


def _place(params: PyTree, device: torch.device, dtype,
           keep_fp32: tuple = (), mesh=None) -> PyTree:
    """Params on ``device``, floating leaves cast to ``dtype`` — once, here
    — except the norms' ``NORM_LEAVES`` and the leaves named in
    ``keep_fp32`` (the family's ``FP32_LEAVES``: per-head scalars the
    reference reads in fp32), which stay fp32.  A DTensor leaf (a state
    that a mesh built) is gathered to its full tensor first: a collective,
    which every rank of its mesh runs.  Under ``mesh`` the result is
    placed by ``param_shardings``, each rank keeping its shard.  Leaves
    already in place are shared with the caller, not copied."""
    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(
            f"mesh of {mesh.device_type!r} devices for an engine on "
            f"{device.type!r}; init_distributed(device=...) and the "
            "engine's device must agree")
    keep_fp32 = NORM_LEAVES + tuple(keep_fp32)

    def leaf(path, t):
        if not t.is_floating_point():
            return t.to(device)
        keep = path.split("/")[-1] in keep_fp32
        return t.to(device=device, dtype=torch.float32 if keep else dtype)
    placed = unflatten_from_paths({
        path: leaf(path, t) for path, t in
        flatten_with_paths(S.gather(params)).items()})
    if mesh is None:
        return placed
    return S.shard(placed, S.param_shardings(placed, mesh), mesh)


class ServeEngine:
    def __init__(self, cfg: ArchConfig, params: PyTree, max_len: int = 512,
                 batch: int = 4, compute_dtype=torch.float32,
                 sample_fn: Callable = greedy_sample, device="cuda",
                 mesh=None):
        self.cfg = cfg
        self.model = get_family(cfg)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = _place(params, self.device, compute_dtype,
                             getattr(self.model, "FP32_LEAVES", ()), mesh)
        self.max_len = max_len
        self.batch = batch
        self.compute_dtype = compute_dtype
        self.sample_fn = sample_fn

    @classmethod
    def from_train_state(cls, cfg: ArchConfig, state, *, mesh=None, **kw):
        """One-call train→serve handoff: pull params out of a TrainState
        (anything with ``.params``), a ``{"params": ...}`` dict or bare
        params, and stand up an engine.  ``mesh=None`` serves full tensors
        on the engine's device (a state that a mesh built is gathered); a
        mesh places them by the serving rules (at most a reshard)."""
        return cls(cfg, _extract_params(state), mesh=mesh, **kw)

    def generate(self, prompts, max_new_tokens: int = 16,
                 src_embeds: Optional[torch.Tensor] = None
                 ) -> list[list[int]]:
        """Batched greedy generation.  Prompts (1-D int sequences) are
        left-padded to equal length; the pad families (dense, vlm) mask the
        pad keys out of attention, the others run the pad tokens unmasked,
        as the reference does.  The vlm family gets zero ``vision_embeds``
        in front of the prompts, as in the reference; the cache's
        ``max_len`` counts those positions.  The encdec family needs
        ``src_embeds`` (batch, S_enc, d_model), the source its decoder
        attends to, and raises ``ValueError`` without them.  The xlstm
        family's state has a constant size, so ``max_len`` does not bound
        its generation, as in the reference.  Sampled
        tokens stay on the device and reach the host in one copy at the
        end.  Under a mesh every rank of it calls this with the same
        arguments: each runs its data rows and all get every prompt's
        tokens."""
        if len(prompts) > self.batch:
            raise ValueError(f"{len(prompts)} prompts for batch {self.batch}")
        encdec = self.cfg.family == "encdec"
        if encdec and (src_embeds is None or
                       src_embeds.shape[0] != self.batch):
            raise ValueError(f"encdec serving needs src_embeds with "
                             f"{self.batch} rows (one a batch slot)")
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        plen = max(len(p) for p in prompts)
        vt = self.cfg.vision_tokens
        xlstm = self.cfg.family == "xlstm"   # its state has no length
        if not xlstm and vt + plen + max_new_tokens - 1 > self.max_len:
            raise ValueError(f"{vt} vision tokens + prompt {plen} + "
                             f"{max_new_tokens} new tokens exceed max_len "
                             f"{self.max_len}")
        pads = [plen - len(p) for p in prompts] + \
            [plen] * (self.batch - len(prompts))
        padded = np.zeros((self.batch, plen), np.int64)
        for i, p in enumerate(prompts):
            padded[i, plen - len(p):] = p
        dev = self.device
        batch_in = {"tokens": torch.from_numpy(padded).to(dev)}
        if self.cfg.family in _PAD_FAMILIES:
            batch_in["pad"] = torch.tensor(pads, dtype=torch.int32,
                                           device=dev)
        if self.cfg.family == "vlm":
            batch_in["vision_embeds"] = torch.zeros(
                (self.batch, vt, self.cfg.d_model), dtype=torch.float32,
                device=dev)
        cdt = torch.float32 if self.compute_dtype == torch.float32 \
            else torch.bfloat16
        kw = {}
        if encdec:
            batch_in["src_embeds"] = torch.as_tensor(src_embeds).to(dev)
            kw["enc_len"] = src_embeds.shape[1]
        if self.mesh is not None and self.cfg.family not in _ROW_COUPLED:
            batch_in = S.data_shard(batch_in, self.mesh)
        rows = batch_in["tokens"].shape[0]
        if xlstm:
            cache = self.model.init_cache(self.cfg, rows, device=dev)
        else:
            cache = self.model.init_cache(self.cfg, rows, self.max_len,
                                          dtype=cdt, device=dev, **kw)
        params = S.gather(self.params)     # once a call, freed at its end
        logits, cache = self.model.prefill(self.cfg, params, batch_in,
                                           cache, self.compute_dtype)
        tok = self.sample_fn(logits[:, -1])
        toks = [tok]
        for _ in range(max_new_tokens - 1):
            cur = tok.reshape(rows, 1).long()
            logits, cache = self.model.decode_step(
                self.cfg, params, cache, cur, self.compute_dtype)
            tok = self.sample_fn(logits[:, -1])
            toks.append(tok)
        toks = torch.stack(toks, dim=1)                    # (rows, max_new)
        if rows < self.batch:
            toks = S.data_gather(toks, self.mesh)
        all_toks = toks.cpu().numpy()                      # (B, max_new)
        return [list(map(int, all_toks[i])) for i in range(len(prompts))]


class ContinuousServeEngine:
    """Continuous batching over the paged KV cache (dense family).

    ``slots`` is the decode batch width; ``n_blocks``/``block_size`` size
    the shared page pool; ``max_blocks_per_slot`` caps one request's share
    (its table width).  Prompts are left-padded up to a power-of-2 multiple
    of ``prefill_bucket``; correctness relies on the pad mask the prefill
    threads through attention, not on the pad content.

    Under ``mesh=`` the params are placed as :class:`ServeEngine` places
    them and gathered once a :meth:`run` call; every rank runs every slot
    over its own page pool, as the reference runs this engine without
    shardings.  The scheduler decides on the sampled tokens alone, which
    are equal on every rank (the same params, requests and kernels), so
    the ranks stay in step without a collective.
    """

    def __init__(self, cfg: ArchConfig, params: PyTree, *, slots: int = 4,
                 block_size: int = 16, n_blocks: Optional[int] = None,
                 max_blocks_per_slot: Optional[int] = None,
                 prefill_bucket: int = 32, compute_dtype=torch.float32,
                 sample_fn: Callable = greedy_sample, device="cuda",
                 mesh=None):
        if cfg.family != "dense":
            raise ValueError(
                "continuous batching serves the dense family, not "
                f"{cfg.family!r}" + (
                    " (the reference's continuous engine builds no "
                    "vision_embeds, so it cannot serve vlm either)"
                    if cfg.family == "vlm" else ""))
        self.cfg = cfg
        self.model = get_family(cfg)
        self.device = resolve_device(device)
        self.mesh = mesh
        self.params = _place(params, self.device, compute_dtype, mesh=mesh)
        self.slots = slots
        self.block_size = block_size
        self.prefill_bucket = prefill_bucket
        if max_blocks_per_slot is None:
            max_blocks_per_slot = -(-(prefill_bucket + 64) // block_size)
        if n_blocks is None:
            n_blocks = 1 + slots * max_blocks_per_slot
        cdt = torch.float32 if compute_dtype == torch.float32 \
            else torch.bfloat16
        self.cache = PagedKVCache(cfg, n_blocks=n_blocks,
                                  block_size=block_size, slots=slots,
                                  max_blocks_per_slot=max_blocks_per_slot,
                                  dtype=cdt, device=self.device)
        self.compute_dtype = compute_dtype
        self.sample_fn = sample_fn
        self.scheduler = Scheduler(slots)
        self._cur = np.zeros((slots, 1), np.int64)   # last sampled token/slot
        self.steps = 0                                # decode steps run
        self.prefill_seconds: list[float] = []        # host clock, per prefill
        self.decode_seconds: list[float] = []         # host clock, per step

    @classmethod
    def from_train_state(cls, cfg: ArchConfig, state, *, mesh=None, **kw):
        """Same handoff contract as :meth:`ServeEngine.from_train_state`."""
        return cls(cfg, _extract_params(state), mesh=mesh, **kw)

    # -- internals -----------------------------------------------------------
    def _bucket(self, plen: int) -> int:
        b = self.prefill_bucket
        while b < plen:
            b *= 2
        return b

    def _budget(self, req: ServeRequest) -> int:
        return self._bucket(len(req.prompt)) + req.max_new_tokens

    def _admit(self, slot: int, req: ServeRequest) -> bool:
        return self.cache.admit(slot, self._budget(req))

    def _start(self, slot: int, req: ServeRequest, params: PyTree) -> None:
        """Prefill one admitted request and park it in ``slot``."""
        t0 = time.perf_counter()
        plen = len(req.prompt)
        bucket = self._bucket(plen)
        pad = bucket - plen
        dev = self.device
        toks = torch.tensor([[0] * pad + list(req.prompt)], dtype=torch.long,
                            device=dev)
        cache = self.model.init_cache(self.cfg, 1, bucket,
                                      dtype=self.cache.k_pool.dtype,
                                      device=dev)
        batch_in = {"tokens": toks,
                    "pad": torch.tensor([pad], dtype=torch.int32, device=dev)}
        logits, cache = self.model.prefill(self.cfg, params, batch_in,
                                           cache, self.compute_dtype)
        tok = self.sample_fn(logits[:, -1])
        # (L, 1, bucket, KV, hd) -> the slot's pages
        self.cache.write_prefill(slot, cache["k"][:, 0], cache["v"][:, 0],
                                 pad=pad)
        first = int(tok[0])                      # waits for the prefill
        self.prefill_seconds.append(time.perf_counter() - t0)
        self._cur[slot, 0] = first
        if req.record(first):
            self.scheduler.active[slot] = None
            self.scheduler.stats.n_finished += 1
            self.cache.release(slot)

    def _fill(self, params: PyTree) -> None:
        while True:
            placed = self.scheduler.fill(self._admit)
            if not placed:
                break
            for slot, req in placed:
                self._start(slot, req, params)
            # _start may free slots again (1-token requests) — loop until
            # no placement happens, then decode.

    def run(self, requests: list[ServeRequest]) -> list[ServeRequest]:
        """Drive every request to completion; returns them in submit order
        with ``out_tokens`` filled.  One host transfer per decode step (the
        sampled tokens: the scheduler needs them for EOS/refill decisions);
        the page pools stay on the device and are written in place.

        Raises ``ValueError`` up front if a request's budget (prompt bucket
        + max_new_tokens) can never fit the cache."""
        for r in requests:
            budget = self._budget(r)
            if not self.cache.can_ever_admit(budget):
                raise ValueError(
                    f"request with a {len(r.prompt)}-token prompt (bucket "
                    f"{self._bucket(len(r.prompt))}) and max_new_tokens "
                    f"{r.max_new_tokens} needs "
                    f"{self.cache.pages_needed(budget)} pages; a slot holds "
                    f"{self.cache.max_blocks_per_slot} and the pool "
                    f"{self.cache.allocator.n_usable}")
        for r in requests:
            self.scheduler.submit(r)
        params = S.gather(self.params)     # once a call, freed at its end
        self._fill(params)
        dev = self.device
        while self.scheduler.has_work:
            t0 = time.perf_counter()
            lengths = self.cache.lengths
            logits, _, _ = self.model.paged_decode_step(
                self.cfg, params, self.cache.k_pool, self.cache.v_pool,
                self.cache.block_tables, torch.from_numpy(lengths).to(dev),
                torch.from_numpy(self.cache.pads).to(dev),
                torch.from_numpy(self._cur).to(dev), self.compute_dtype)
            toks_host = self.sample_fn(logits[:, -1]).cpu().numpy()  # sync
            self.steps += 1
            self.decode_seconds.append(time.perf_counter() - t0)
            active_slots = [i for i, r in enumerate(self.scheduler.active)
                            if r is not None]
            finished = self.scheduler.step_tokens(toks_host)
            for slot in active_slots:
                self._cur[slot, 0] = toks_host[slot]
                self.cache.set_length(slot, int(lengths[slot]) + 1)
            for slot in finished:
                self.cache.release(slot)
            self._fill(params)
        return requests
