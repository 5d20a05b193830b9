"""Double-buffered optimizer-bundle pipeline for the grouped strategies,
and the chunk stream of ``fpft_streamed`` (port of
``repro.core.pipeline``).

HiFT keeps inactive optimizer bundles in host memory (the paper's
MoveOptimizerState2CPU / MoveOptimizerState2GPU).  The serial step puts
that traffic on the compute stream: the bundle's upload before the step,
its offload after.  HiFT's sweep order makes the next group knowable a
step ahead, and LiSA's sample is a pure function of ``(seed, step)``, so
both can move optimizer bytes beside the compute:

  - :meth:`BundlePipeline.prefetch` starts the upload of group g+1's
    bundle right after group g's step is enqueued, so it runs while g
    computes;
  - :meth:`BundlePipeline.fetch` hands that device copy to g+1's step
    (a fresh upload on a cache miss: a restored checkpoint, a forked
    state, a LiSA group sampled twice in a row);
  - :meth:`BundlePipeline.offload` enqueues g's device-to-host copy and
    defers waiting for it, so the drain runs beside step g+1.

**On the card** each pipeline owns two side CUDA streams
(:class:`SideStreams`): ``up`` carries host-to-device copies, ``down``
device-to-host ones, so both copy engines run beside the compute stream.
A prefetch issues its copy on ``up`` and records an event that
:meth:`~BundlePipeline.fetch` makes the compute stream wait on.  An
offload records an event on the compute stream after the step and issues
the copy into pinned memory on ``down``; the event recorded there is the
"drain".  The caching allocator is told who reads what: a device copy
made on ``up`` and used by the step is ``record_stream``'d on the compute
stream, and a step's output read by the deferred copy on ``down``.  The
same pinned buffers carry a group's bundle from visit to visit, so the
copies of one key are ordered: an upload waits for the key's last drain,
a drain for the key's last upload.

**On the CPU** every transfer is the identity, as in the reference; the
bookkeeping and :class:`PipelineStats` still run, so the CPU tests check
them.

A bounded budget keeps at most ``depth`` bundles on the device (the active
step's plus prefetched and draining ones): to admit another, the host
blocks on the oldest drain (``event.synchronize()``, the reference's
``block_until_ready``), then evicts stale prefetches.  The memory model
prices this as mode ``hift_pipelined`` (``core.memory_model``).

Every value still crosses host and device unchanged, so a pipelined run is
bit-identical to the serial schedule: the pipeline moves when the
transfers happen, never what they carry.

:class:`ChunkLayout` and :class:`ChunkStream` apply the same window to
fixed-byte chunks of param-congruent trees, for ``fpft_streamed``.  On
the card a chunk of one piece is a view of its leaf, and the updated
chunk is copied back into the same host view, so a step copies no whole
tree.

The placement primitives :func:`host_put` and :func:`device_put` live
here; ``core.strategy`` re-exports them.  Under a ``mesh=`` a bundle's
leaves are DTensors: both move each leaf's local shard and re-wrap it
under the same placements, on the host mesh (``dist.shardings.
host_mesh``) in pinned memory and back on the device mesh, so the
pipeline's copies, events and pinned-buffer reuse act on the shards.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Mapping, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.pytree import (flatten_with_paths, tree_map,
                                       unflatten_from_paths)

PyTree = Any


# --------------------------------------------------------------- placement

def host_put(tree: PyTree, into: Optional[PyTree] = None) -> PyTree:
    """Move a bundle to host memory (the paper's MoveOptimizerState2CPU).

    Each CUDA leaf is copied into a pinned CPU tensor with
    ``non_blocking=True`` on the current stream — into ``into``'s pinned
    leaf at the same path when it has the same shape and dtype (a revisited
    group's host buffers are reused), else into a new one.  Any host read
    of the result must synchronise first.  CPU leaves (the step count, and
    everything when training on the CPU) pass through."""
    old = flatten_with_paths(into) if into is not None else {}
    out = {}
    for path, t in flatten_with_paths(tree).items():
        if isinstance(t, DTensor):
            out[path] = _host_shard(t, old.get(path))
            continue
        if t.device.type != "cuda":
            out[path] = t
            continue
        dst = old.get(path)
        if (dst is None or dst.device.type != "cpu" or not dst.is_pinned()
                or dst.shape != t.shape or dst.dtype != t.dtype):
            dst = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        dst.copy_(t, non_blocking=True)
        out[path] = dst
    return unflatten_from_paths(out)


def _host_shard(t: DTensor, into) -> DTensor:
    """A DTensor's shard in pinned host memory (into ``into``'s shard when
    it fits), on the host mesh with the same placements."""
    from repro_torch.dist import shardings as S
    loc = t.to_local()
    if loc.device.type != "cuda":
        return t
    prev = into.to_local() if isinstance(into, DTensor) else None
    host = host_put({"x": loc}, into=None if prev is None else {"x": prev})
    return S.wrap(host["x"], S.host_mesh(t.device_mesh),
                  tuple(t.placements), t.shape)


def device_put(tree: PyTree, device: torch.device) -> PyTree:
    """Floating leaves to ``device`` (asynchronous from pinned memory, on
    the current stream); integer leaves — optimizer step counts — stay on
    the host.  A host DTensor's shard goes to its device mesh."""
    if device.type == "cpu":
        return tree
    from repro_torch.dist import shardings as S
    return tree_map(lambda t: S.on_device(t) if isinstance(t, DTensor)
                    else t.to(device, non_blocking=True)
                    if t.is_floating_point() else t, tree)


def pinned_trees(trees: list) -> list:
    """Empty host trees shaped and typed like ``trees`` (leaves on any
    device, ``meta`` included), every leaf a view of ONE pinned buffer.
    PyTorch's caching host allocator rounds each pinned block up to a
    power of two; a leaf at a time that would cost up to twice a moment
    tree's bytes (llama2-7b's stacked (32, 4096, 4096) fp32 leaves: 4 GiB
    blocks for 2 GiB), one buffer pays the rounding once, on the total."""
    flats = [flatten_with_paths(t) for t in trees]
    spans, total = [], 0
    for flat in flats:
        span = {}
        for path, t in flat.items():
            nbytes = t.numel() * t.element_size()
            span[path] = (total, nbytes)
            total += -(-nbytes // 64) * 64          # 64-byte aligned leaves
        spans.append(span)
    buf = torch.empty(max(total, 1), dtype=torch.uint8, pin_memory=True)
    return [unflatten_from_paths({
        p: buf[o:o + n].view(t.dtype).view(t.shape)
        for p, t in flat.items() for o, n in (span[p],)})
        for flat, span in zip(flats, spans)]


def _cuda_tensors(obj) -> list:
    """The CUDA tensors in a nest of dicts, tuples and lists."""
    if isinstance(obj, DTensor):
        obj = obj.to_local()
    if isinstance(obj, torch.Tensor):
        return [obj] if obj.device.type == "cuda" else []
    if isinstance(obj, Mapping):
        obj = list(obj.values())
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _cuda_tensors(x)]
    return []


class SideStreams:
    """The side CUDA streams of a pipeline: ``up`` for host-to-device
    copies, ``down`` for device-to-host ones (the two copy engines)."""

    def __init__(self, device: torch.device):
        self.up = torch.cuda.Stream(device)
        self.down = torch.cuda.Stream(device)


# ---------------------------------------------------------------- pipeline

@dataclasses.dataclass
class PipelineStats:
    """Counters (reset with the pipeline, never checkpointed).

    ``max_resident`` counts device-resident bundles at their peak — the
    active step's bundle plus everything prefetched or draining — and is
    what the budget bounds (<= depth)."""
    prefetch_hits: int = 0
    prefetch_misses: int = 0
    prefetches: int = 0
    offloads: int = 0
    budget_waits: int = 0
    max_resident: int = 0


class BundlePipeline:
    """Double-buffered host<->device scheduler for per-group optimizer
    bundles.  One instance per grouped strategy; it holds only redundant
    device copies of host-resident state (a transfer cache), so losing it
    (a fresh process, a restore) costs a prefetch miss, never correctness.

    Cache coherence: a prefetched entry is keyed by group and by the
    identity of the host tree it was uploaded from; :meth:`fetch` serves it
    only when that tree is the bundle the caller holds.

    ``device``: where the steps run; on the CPU transfers are the
    identity.  ``streams``: the :class:`SideStreams` to issue on (default:
    the pipeline's own, made at its first transfer).  ``upload(src) ->
    device copy`` and ``download(device copy, into) -> host copy`` replace
    :func:`device_put` and :func:`host_put` (:class:`ChunkStream` moves
    chunks); both run inside the side stream's context."""

    def __init__(self, depth: int = 2, *, device="cuda",
                 streams: Optional[SideStreams] = None,
                 upload: Optional[Callable] = None,
                 download: Optional[Callable] = None):
        if depth < 2:
            raise ValueError(f"pipeline depth must be >= 2, got {depth}; "
                             "use the serial path for depth 1")
        self.depth = depth
        self.device = torch.device(device)
        self._streams = streams
        self._upload = upload or (lambda src: device_put(src, self.device))
        self._download = download or host_put
        # group key -> (source host tree, device copy, its upload event)
        self._prefetched: dict[str, tuple] = {}
        # drain events of deferred offloads, oldest first (None on the
        # CPU); an entry leaves when the host blocks on it
        self._draining: deque = deque()
        # the last upload and drain event of each key (the card)
        self._uploaded: dict[str, Any] = {}
        self._drained: dict[str, Any] = {}
        self.stats = PipelineStats()

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def streams(self) -> SideStreams:
        if self._streams is None:
            self._streams = SideStreams(self.device)
        return self._streams

    # ------------------------------------------------------------- budget

    def device_resident(self, active: int = 1) -> int:
        """Device-resident bundle count: the active step's (``active``) plus
        prefetched copies plus offloads still draining."""
        return active + len(self._prefetched) + len(self._draining)

    def holds(self, key: str, source: PyTree = None) -> bool:
        """True when a prefetched copy for ``key`` is in flight (uploaded
        from ``source``, when given — the identity rule of :meth:`fetch`)."""
        entry = self._prefetched.get(key)
        if entry is None:
            return False
        return source is None or entry[0] is source

    def _note_resident(self) -> None:
        self.stats.max_resident = max(self.stats.max_resident,
                                      self.device_resident())

    def _block_oldest(self) -> None:
        self.stats.budget_waits += 1
        event = self._draining.popleft()
        if event is not None:
            event.synchronize()

    def _make_room(self, active: int) -> None:
        """Make room for one incoming device bundle: block on the oldest
        drain(s) — enqueued a step ago, so usually done — then, if still
        over budget (stale entries of forked or restored states), evict
        prefetched copies oldest first, which only costs a re-upload."""
        def over():
            return (active + len(self._prefetched) + len(self._draining)
                    + 1 > self.depth)
        while over() and self._draining:
            self._block_oldest()
        while over() and self._prefetched:
            self._prefetched.pop(next(iter(self._prefetched)))

    # ---------------------------------------------------------- transfers

    def _start_upload(self, key: str, source: PyTree) -> tuple:
        """(device copy, event) of ``source``, issued on ``up`` after the
        key's last drain (the same pinned buffers); (source, None) on the
        CPU."""
        if not self.on_card:
            return source, None
        up = self.streams.up
        drained = self._drained.get(key)
        if drained is not None:
            up.wait_event(drained)
        with torch.cuda.stream(up):
            dev = self._upload(source)
            event = torch.cuda.Event()
            event.record(up)
        self._uploaded[key] = event
        return dev, event

    def _use(self, dev: PyTree, event) -> PyTree:
        """Hand an upload to the compute stream: wait for it, and keep the
        allocator from reusing its memory before the step has read it."""
        if event is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(event)
            for t in _cuda_tensors(dev):
                t.record_stream(compute)
        return dev

    # ------------------------------------------------------------ actions

    def fetch(self, key: str, bundle: PyTree) -> PyTree:
        """Device copy of ``bundle`` for the active step: the prefetched
        copy when its source matches, else an upload now.  The entry is
        popped, so the pipeline holds no reference to it afterwards."""
        entry = self._prefetched.pop(key, None)
        if entry is not None and entry[0] is bundle:
            self.stats.prefetch_hits += 1
            return self._use(entry[1], entry[2])
        self.stats.prefetch_misses += 1
        self._make_room(active=0)   # the upload becomes the active bundle
        self._note_resident()
        return self._use(*self._start_upload(key, bundle))

    def prefetch(self, key: str, bundle: PyTree) -> None:
        """Start the upload of the next group's bundle.  Call right after
        enqueuing the current step so the copy overlaps its compute.
        Respects the budget first (:meth:`_make_room`); replacing an entry
        for ``key`` drops the old copy."""
        self._prefetched.pop(key, None)
        self._make_room(active=1)
        self._prefetched[key] = (bundle, *self._start_upload(key, bundle))
        self.stats.prefetches += 1
        self._note_resident()

    def offload(self, key: str, new_bundle: PyTree,
                into: Optional[PyTree] = None) -> PyTree:
        """Deferred host offload of a step's output bundle: the copy is
        enqueued now (it runs once the step is done, beside the next step)
        and nothing waits for it here.  Older drains are first blocked down
        to ``depth - 2`` so the next step's bundle still fits the budget.
        ``into``: the host tree whose pinned buffers take the copy (the
        group's previous bundle).  Returns the host tree to store in
        ``TrainState.opt_state``; host reads of it synchronise first."""
        while len(self._draining) > max(self.depth - 2, 0):
            self._block_oldest()
        if self.on_card:
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            down = self.streams.down
            down.wait_event(done)
            uploaded = self._uploaded.get(key)
            if uploaded is not None:
                down.wait_event(uploaded)
            for t in _cuda_tensors(new_bundle):
                t.record_stream(down)
            with torch.cuda.stream(down):
                host = self._download(new_bundle, into)
                drained = torch.cuda.Event()
                drained.record(down)
            self._drained[key] = drained
        else:
            host, drained = new_bundle, None
        self._draining.append(drained)
        self.stats.offloads += 1
        # the draining copy is the step's own bundle, so at this instant
        # nothing else counts as active
        self.stats.max_resident = max(self.stats.max_resident,
                                      self.device_resident(active=0))
        return host

    def order_after_drains(self) -> None:
        """Make later uploads wait for every drain enqueued so far (a new
        pipeline sharing ``streams`` with an earlier one)."""
        if self.on_card:
            self.streams.up.wait_stream(self.streams.down)

    def flush(self) -> None:
        """Block until every deferred offload has drained and drop all
        prefetched copies.  State values are unaffected."""
        while self._draining:
            event = self._draining.popleft()
            if event is not None:
                event.synchronize()
        self._prefetched.clear()


# ----------------------------------------------------- chunk-granular layer
#
# ChunkFT-style generalisation: partition any params-congruent tree into
# fixed-byte chunks and stream them through the same bounded window, so
# full-parameter AdamW keeps its moments in host memory and still updates
# every parameter each step (strategy ``fpft_streamed``).

def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype (``torch.bfloat16`` -> "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _bucket_layout(spec: tuple) -> tuple:
    """Group leaves by (param dtype, grad dtype) names so each bucket packs
    into one flat stream (``repro.kernels.ops._bucket_layout``): ``spec``
    is ``(size, p_dtype, g_dtype)`` per leaf in flatten order; buckets come
    in sorted key order, leaves in flatten order within one."""
    buckets: dict = {}
    for i, (_, pdt, gdt) in enumerate(spec):
        buckets.setdefault((pdt, gdt), []).append(i)
    return tuple((key, tuple(idxs)) for key, idxs in sorted(buckets.items()))


def _sorted_leaves(tree: PyTree, prefix: str = "") -> list:
    """``[(path, leaf)]`` in the reference's flatten order: dict keys
    sorted at every level (jax's order), not insertion order."""
    if not isinstance(tree, Mapping):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree, key=str):
        out += _sorted_leaves(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


@dataclasses.dataclass(frozen=True)
class ChunkLayout:
    """A fixed-byte chunking of a tree, by element ranges.

    Built once per tree structure (:meth:`build`): the flattened elements
    of every dtype bucket are cut into chunks of at most ``chunk_bytes``
    bytes.  Chunks never span buckets, so an extracted chunk is one 1-D
    tensor of one dtype.  The pieces ``(leaf_index, start, n)`` index the
    leaves in the reference's order (``paths``), so chunk i covers the same
    elements as the reference's chunk i, and one layout built from the
    params applies to every congruent tree (grads, moments of another
    dtype): a per-chunk elementwise update is the resident update."""

    paths: tuple             # leaf paths, the reference's flatten order
    shapes: tuple            # per-leaf shapes, same order
    tree_paths: tuple        # leaf paths in the tree's own order
    chunk_bytes: int
    # per chunk: tuple of (leaf_index, start_element, n_elements) pieces
    chunks: tuple

    @classmethod
    def build(cls, tree: PyTree, chunk_bytes: int) -> "ChunkLayout":
        """Partition ``tree`` into chunks of at most ``chunk_bytes`` bytes
        (in the tree's own dtypes; at least one element per chunk).
        Raises ``ValueError`` for a non-positive chunk size."""
        if chunk_bytes <= 0:
            raise ValueError(
                f"chunk_bytes must be > 0, got {chunk_bytes}; a zero-byte "
                "chunk can hold no element")
        flat = _sorted_leaves(tree)
        spec = tuple((int(l.numel()), _dtype_name(l.dtype),
                      _dtype_name(l.dtype)) for _, l in flat)
        chunks = []
        for _, idxs in _bucket_layout(spec):
            itemsize = flat[idxs[0]][1].element_size()
            per_chunk = max(chunk_bytes // itemsize, 1)
            pieces, room = [], per_chunk
            for i in idxs:
                start, left = 0, spec[i][0]
                while left:
                    take = min(left, room)
                    pieces.append((i, start, take))
                    start, left, room = start + take, left - take, room - take
                    if room == 0:
                        chunks.append(tuple(pieces))
                        pieces, room = [], per_chunk
            if pieces:
                chunks.append(tuple(pieces))
        return cls(paths=tuple(p for p, _ in flat),
                   shapes=tuple(tuple(l.shape) for _, l in flat),
                   tree_paths=tuple(flatten_with_paths(tree)),
                   chunk_bytes=int(chunk_bytes), chunks=tuple(chunks))

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    def flat(self, tree: PyTree) -> list:
        """``tree``'s leaves as 1-D views, in layout order — a form every
        method below also takes, so a loop over chunks flattens once."""
        leaves = flatten_with_paths(tree)
        return [leaves[p].reshape(-1) for p in self.paths]

    def pieces(self, tree: PyTree, i: int) -> tuple:
        """The 1-D views of ``tree``'s leaves (a tree or its :meth:`flat`
        list) that chunk ``i`` covers."""
        flat = tree if isinstance(tree, list) else self.flat(tree)
        return tuple(flat[li][s:s + n] for li, s, n in self.chunks[i])

    def extract(self, tree: PyTree, i: int) -> torch.Tensor:
        """Chunk ``i`` of any layout-congruent tree (or its :meth:`flat`
        list) as one 1-D tensor, a view of the leaf when the chunk has one
        piece."""
        parts = self.pieces(tree, i)
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def write(self, tree: PyTree, i: int, chunk: torch.Tensor) -> None:
        """Copy ``chunk`` into ``tree``'s elements of chunk ``i`` (a tree
        or its :meth:`flat` list), in place, on the current stream."""
        off = 0
        with torch.no_grad():
            for view in self.pieces(tree, i):
                view.copy_(chunk[off:off + view.numel()])
                off += view.numel()

    def combine(self, chunks: list) -> PyTree:
        """A new tree from all ``num_chunks`` chunk tensors — bit-equal to
        the tree the chunks were extracted from."""
        if len(chunks) != self.num_chunks:
            raise ValueError(f"combine needs all {self.num_chunks} chunks, "
                             f"got {len(chunks)}")
        segs: dict[int, list] = {}
        for chunk, pieces in zip(chunks, self.chunks):
            off = 0
            for li, start, n in pieces:
                segs.setdefault(li, []).append((start, chunk[off:off + n]))
                off += n
        leaves = {}
        for li, (path, shape) in enumerate(zip(self.paths, self.shapes)):
            parts = [a for _, a in sorted(segs[li], key=lambda t: t[0])]
            flat = parts[0] if len(parts) == 1 else torch.cat(parts)
            leaves[path] = flat.reshape(shape)
        return unflatten_from_paths({p: leaves[p] for p in self.tree_paths})


def _upload_chunk(src: tuple, device: torch.device) -> tuple:
    """Device copies of one chunk of each streamed tree: a one-piece chunk
    straight from its host view, a packed one piece by piece into one
    buffer."""
    out = []
    for views in src:
        if len(views) == 1:
            out.append(views[0].to(device, non_blocking=True))
            continue
        buf = torch.empty(sum(v.numel() for v in views),
                          dtype=views[0].dtype, device=device)
        off = 0
        for v in views:
            buf[off:off + v.numel()].copy_(v, non_blocking=True)
            off += v.numel()
        out.append(buf)
    return tuple(out)


def _download_chunk(new: tuple, into: tuple) -> tuple:
    """Copy each updated device chunk back into the host views it came
    from (in place: the streamed trees are never copied whole)."""
    for chunk, views in zip(new, into):
        off = 0
        for v in views:
            v.copy_(chunk[off:off + v.numel()], non_blocking=True)
            off += v.numel()
    return into


class ChunkStream:
    """Stream the chunks of one or more congruent host-resident trees
    through a bounded device window.

    Wraps a :class:`BundlePipeline` (depth < 2 raises the same
    ``ValueError``; the budget and coherence rules are shared) keyed by
    chunk index, with a lookahead window: after serving chunk i, chunks
    i+1 .. i+depth-1 start uploading, so at most ``depth`` chunks are on
    the device while the consumer walks the stream front to back.

    One sweep per training step::

        stream = ChunkStream(layout, depth=4, device=dev)
        stream.begin(m_tree, v_tree)
        for i in range(layout.num_chunks):
            m_c, v_c = stream.fetch(i)
            ...update...
            stream.offload(i, (new_m_c, new_v_c))
        new_m, new_v = stream.end()

    On the CPU (the reference's semantics) ``begin`` extracts every chunk
    once and ``end`` reassembles new trees.  On the card ``begin`` takes
    views of the host leaves, each drain copies the updated chunk back
    into its views, and ``end`` returns the trees given to ``begin``, by
    then updated in place (their drains may still be in flight: host
    reads synchronise first).  ``streams``: side streams shared across
    steps; ``begin`` orders this sweep's uploads after earlier drains."""

    def __init__(self, layout: ChunkLayout, depth: int = 2, *,
                 device="cuda", streams: Optional[SideStreams] = None):
        self.layout = layout
        dev = torch.device(device)
        card = dev.type == "cuda"
        self.pipeline = BundlePipeline(
            depth, device=dev, streams=streams,
            upload=(lambda src: _upload_chunk(src, dev)) if card else None,
            download=_download_chunk if card else None)
        self._trees: Optional[tuple] = None
        self._source: Optional[list] = None
        self._done: Optional[list] = None

    @property
    def depth(self) -> int:
        return self.pipeline.depth

    @property
    def stats(self) -> PipelineStats:
        return self.pipeline.stats

    def begin(self, *trees: PyTree) -> "ChunkStream":
        """Take the host-side chunks of ``trees`` (all layout-congruent)
        and prime the lookahead window."""
        n = self.layout.num_chunks
        flats = [self.layout.flat(t) for t in trees]
        if self.pipeline.on_card:
            self.pipeline.order_after_drains()
            self._source = [tuple(self.layout.pieces(f, i) for f in flats)
                            for i in range(n)]
        else:
            self._source = [tuple(self.layout.extract(f, i) for f in flats)
                            for i in range(n)]
        self._trees = trees
        self._done = [None] * n
        self._lookahead(0)
        return self

    def _lookahead(self, next_i: int) -> None:
        # fill the window up to depth-1 chunks ahead of the active one
        hi = min(next_i + self.depth - 1, self.layout.num_chunks)
        for j in range(next_i, hi):
            if not self.pipeline.holds(str(j)):
                self.pipeline.prefetch(str(j), self._source[j])

    def fetch(self, i: int) -> tuple:
        """Device copies of chunk ``i`` of every tree given to ``begin``,
        then top up the lookahead window."""
        if self._source is None:
            raise RuntimeError("ChunkStream.fetch before begin()")
        got = self.pipeline.fetch(str(i), self._source[i])
        self._lookahead(i + 1)
        return got

    def offload(self, i: int, new_chunks: tuple) -> None:
        """Enqueue chunk ``i``'s updated tensors back to the host (a
        deferred drain, as :meth:`BundlePipeline.offload`)."""
        self._done[i] = self.pipeline.offload(str(i), tuple(new_chunks),
                                              into=self._source[i])

    def end(self) -> list:
        """The host trees after the sweep — one per tree given to
        ``begin``, in the same order."""
        missing = [i for i, c in enumerate(self._done) if c is None]
        if missing:
            raise RuntimeError(f"ChunkStream.end with chunks {missing[:4]}... "
                               "never offloaded")
        if self.pipeline.on_card:
            out = list(self._trees)
        else:
            out = [self.layout.combine([c[t] for c in self._done])
                   for t in range(len(self._trees))]
        self._trees = self._source = self._done = None
        return out
