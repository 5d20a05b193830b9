"""Checkpointing: atomic, async, keep-last-k (port of
``repro.train.checkpoint``, in the same on-disk layout).

Layout:  <dir>/step_<n>/state.msgpack.zst  + MANIFEST.json (written LAST:
a checkpoint without a manifest is incomplete and ignored on restore, so a
write is atomic under kill -9 at any point).  The payload is the
reference's path-keyed msgpack map ``{"paths": [...], "leaves": [{"dtype",
"shape", "data"}, ...]}`` (dtype a numpy name, bfloat16 as its uint16
bits), so a checkpoint crosses between the two packages in both
directions.

The port needs neither ``msgpack`` nor ``zstandard``: it packs and
unpacks the payload with a small encoder of its own (map, array, str, bin
and unsigned int, the subset the payload uses) and frames it as a
standard-library zlib stream behind the reference's ``b"ZLIB"`` prefix,
in stored blocks (:func:`_write_blob` says why).  Both directions stream:
a save holds the host snapshot and one chunk, a restore the leaves and
one chunk.  It reads a zstd-compressed checkpoint (the reference's
default) only where ``zstandard`` is installed.

HiFT-specific: the visit order and per-group optimizer bundles are part of
the state, so a restart resumes the paper's Algorithm 1 exactly where it
stopped.
"""
from __future__ import annotations

import io
import json
import shutil
import struct
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor

from repro_torch.common.pytree import flatten_with_paths, unflatten_from_paths

PyTree = Any

_MANIFEST = "MANIFEST.json"
_PAYLOAD = "state.msgpack.zst"


# ------------------------------------------------------------ msgpack subset

def _pack(obj, out: list) -> None:
    """Append the msgpack encoding of ``obj`` to ``out`` as buffers, in the
    forms ``msgpack.packb(use_bin_type=True)`` picks, so the bytes equal
    the reference's.  ``obj``: a dict, list, str, non-negative int, or
    bytes or a uint8 numpy array as bin; an array's data is appended as a
    view, not copied."""
    if isinstance(obj, dict):
        out.append(_header(len(obj), 0x80, 0xde, 0xdf, fix=16))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_header(len(obj), 0x90, 0xdc, 0xdd, fix=16))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        n = len(raw)
        out.append(bytes((0xa0 | n,)) if n < 32 else
                   bytes((0xd9, n)) if n < 1 << 8 else
                   _header(n, None, 0xda, 0xdb, fix=0))
        out.append(raw)
    elif isinstance(obj, (bytes, bytearray, np.ndarray)):
        n = obj.nbytes if isinstance(obj, np.ndarray) else len(obj)
        out.append(bytes((0xc4, n)) if n < 1 << 8 else
                   _header(n, None, 0xc5, 0xc6, fix=0))
        out.append(memoryview(obj))
    elif isinstance(obj, int) and not isinstance(obj, bool) and obj >= 0:
        out.append(bytes((obj,)) if obj < 0x80 else
                   bytes((0xcc, obj)) if obj < 1 << 8 else
                   b"\xcd" + struct.pack(">H", obj) if obj < 1 << 16 else
                   b"\xce" + struct.pack(">I", obj) if obj < 1 << 32 else
                   b"\xcf" + struct.pack(">Q", obj))
    else:
        raise TypeError(f"checkpoint payload: cannot pack {type(obj)}")


def _header(n: int, fixbase, tag16: int, tag32: int, fix: int) -> bytes:
    if n < fix:
        return bytes((fixbase | n,))
    if n < 1 << 16:
        return bytes((tag16,)) + struct.pack(">H", n)
    return bytes((tag32,)) + struct.pack(">I", n)


def packb(obj) -> bytes:
    out: list = []
    _pack(obj, out)
    return b"".join(out)


def unpackb(raw: bytes):
    """Inverse of :func:`packb` for the same subset."""
    src = io.BytesIO(raw)

    def read(n):
        data = src.read(n)
        if len(data) != n:
            raise ValueError("checkpoint payload ends early")
        return data

    obj = _unpack(read)
    if src.read(1):
        raise ValueError("checkpoint payload: trailing bytes")
    return obj


_UINT = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q"}
_LEN = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
        0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
        0xdc: (">H", "array"), 0xdd: (">I", "array"),
        0xde: (">H", "map"), 0xdf: (">I", "map")}


def _unpack(read):
    """One msgpack object from ``read(n)`` (exactly n bytes, in order); a
    bin comes back as what ``read`` returns."""
    tag = read(1)[0]
    if tag < 0x80:
        return tag
    if tag in _UINT:
        fmt = _UINT[tag]
        return struct.unpack(fmt, read(struct.calcsize(fmt)))[0]
    if 0xa0 <= tag <= 0xbf:
        n, kind = tag & 0x1f, "str"
    elif 0x90 <= tag <= 0x9f:
        n, kind = tag & 0x0f, "array"
    elif 0x80 <= tag <= 0x8f:
        n, kind = tag & 0x0f, "map"
    elif tag in _LEN:
        fmt, kind = _LEN[tag]
        n = struct.unpack(fmt, read(struct.calcsize(fmt)))[0]
    else:
        raise ValueError(f"checkpoint payload: unsupported msgpack tag "
                         f"0x{tag:02x}")
    if kind == "str":
        return str(read(n), "utf-8")
    if kind == "bin":
        return read(n)
    if kind == "array":
        return [_unpack(read) for _ in range(n)]
    return {_unpack(read): _unpack(read) for _ in range(n)}


# ------------------------------------------------------------ the blob

_LEVEL = 0                    # zlib level: stored blocks (see _write_blob)
_CHUNK = 64 << 20             # bytes handed to zlib, or read, at a time


def _write_blob(path: Path, pieces: list) -> None:
    """``b"ZLIB"`` + one zlib stream of the concatenated ``pieces``, as the
    reference's zlib fallback frames it, written as it is made: memory
    stays one chunk over the leaves.  Level 0 (stored blocks): fp32
    weights deflate to ~93 % at the reference's level 3, at 15-20 MB/s a
    core, so a 2 GB roberta-large state took 17 s to save and 19 s to
    restore on the card's host (PERF.md); stored, zlib only frames and
    checksums them.  Any zlib reader takes either."""
    comp = zlib.compressobj(_LEVEL)
    with open(path, "wb") as f:
        f.write(b"ZLIB")
        for piece in pieces:
            view = memoryview(piece)          # 1-d bytes
            for i in range(0, len(view), _CHUNK):
                f.write(comp.compress(view[i:i + _CHUNK]))
        f.write(comp.flush())


class _Inflater:
    """The payload bytes of a blob, read in order: ``read(n)`` returns a
    fresh ``bytearray`` (writable, so a leaf's tensor is built on it
    without a copy)."""

    def __init__(self, f):
        head = f.read(4)
        if head == b"ZLIB":
            self.src, d = f, zlib.decompressobj()
            self.inflate = lambda data: d.decompress(data) if data else \
                d.flush()
        else:
            try:
                import zstandard
            except ImportError:
                raise RuntimeError(
                    "checkpoint is zstd-compressed (written where zstandard "
                    "is installed) but zstandard is not installed here") \
                    from None
            f.seek(0)
            self.src = zstandard.ZstdDecompressor().stream_reader(f)
            self.inflate = lambda data: data
        self.buf, self.pos = memoryview(b""), 0

    def read(self, n: int) -> bytearray:
        out = bytearray(n)
        view, got = memoryview(out), 0
        while got < n:
            if self.pos == len(self.buf):
                data = self.src.read(_CHUNK)
                self.buf, self.pos = memoryview(self.inflate(data)), 0
                if not data and not len(self.buf):
                    raise ValueError("checkpoint payload ends early")
            take = min(n - got, len(self.buf) - self.pos)
            view[got:got + take] = self.buf[self.pos:self.pos + take]
            got += take
            self.pos += take
        return out


# ------------------------------------------------------------ leaves

def _leaf_to_host(x) -> np.ndarray:
    """A private host copy of one leaf: a torch tensor on any device
    (bfloat16 as its uint16 bits), a numpy array or a scalar.  A copy, so
    a writer thread never reads memory the next training step writes."""
    if isinstance(x, torch.Tensor):
        t = x.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.to("cpu", copy=True).contiguous().numpy()
    return np.array(x, copy=True)


def _dtype_name(x, a: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(a.dtype)


def _leaf_from_bytes(dtype: str, shape, data: bytearray) -> torch.Tensor:
    """A CPU tensor on one payload leaf's bytes; bfloat16 through its
    uint16 bits (the view ``bridge`` uses)."""
    if dtype == "bfloat16":
        a = np.frombuffer(data, np.int16).reshape(shape)
        return torch.from_numpy(a).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(data, np.dtype(dtype))
                            .reshape(shape))


def _snapshot(tree: PyTree) -> dict:
    """{path: (dtype name, host copy)} of every leaf."""
    out = {}
    for path, x in flatten_with_paths(tree).items():
        a = _leaf_to_host(x)
        out[path] = (_dtype_name(x, a), a)
    return out


def _encode(snap: dict) -> list:
    """The payload's msgpack encoding, as buffers over the snapshot."""
    pieces: list = []
    _pack({"paths": list(snap.keys()),
           "leaves": [{"dtype": dt, "shape": list(a.shape),
                       "data": np.ascontiguousarray(a).reshape(-1)
                       .view(np.uint8)}
                      for dt, a in snap.values()]}, pieces)
    return pieces


def _read_tree(path: Path) -> PyTree:
    with open(path, "rb") as f:
        payload = _unpack(_Inflater(f).read)
    flat = {p: _leaf_from_bytes(l["dtype"], l["shape"], l["data"])
            for p, l in zip(payload["paths"], payload["leaves"])}
    return unflatten_from_paths(flat)


# ------------------------------------------------------------ save / restore

def save(ckpt_dir, step: int, state: PyTree, keep: int = 3,
         async_write: bool = False) -> Optional[threading.Thread]:
    """Write the checkpoint of ``step``.  Every leaf is first copied to the
    host (after the card is synchronised), so with ``async_write=True`` the
    returned writer thread (join it before exit) encodes and writes a
    snapshot that later in-place steps cannot touch.

    A state trained under ``mesh=`` holds DTensor leaves: each is gathered
    whole (``full_tensor()``, the counterpart of the reference's
    ``_fetch``) on the calling thread, before any writer starts.  That is a
    collective, so every process of the job calls :func:`save`; process 0
    alone writes the files, and the synchronous path ends in a barrier so
    no process can restore a half-written step (the async path skips it,
    as the reference's does)."""
    import torch.distributed as dist

    from repro_torch.dist.elastic import gather_to_host

    ckpt_dir = Path(ckpt_dir)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    flat = flatten_with_paths(state)
    save.gathered_leaves = sum(isinstance(x, DTensor)
                               for x in flat.values())
    if save.gathered_leaves:
        state = gather_to_host(state)
    snap = _snapshot(state)
    multi = dist.is_initialized() and dist.get_world_size() > 1
    if multi and dist.get_rank() != 0:
        if not async_write:
            dist.barrier()
        return None

    def _write():
        tmp = ckpt_dir / f".tmp_step_{step}_{time.time_ns()}"
        tmp.mkdir(parents=True, exist_ok=True)
        _write_blob(tmp / _PAYLOAD, _encode(snap))
        (tmp / _MANIFEST).write_text(json.dumps({
            "step": step, "time": time.time(), "n_leaves": len(snap)}))
        final = ckpt_dir / f"step_{step}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        _gc(ckpt_dir, keep)

    if async_write:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return t
    _write()
    if multi:
        dist.barrier()
    return None


save.gathered_leaves = 0   # DTensor leaves the last save gathered


def _gc(ckpt_dir: Path, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)


def all_steps(ckpt_dir) -> list[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / _MANIFEST).exists():
            try:
                out.append(int(d.name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir, step: int, like: PyTree = None) -> PyTree:
    """The path-keyed state tree of ``step`` (no template needed), every
    leaf a CPU tensor.  ``Runner.load_state_dict`` places each where its
    strategy keeps it."""
    return _read_tree(Path(ckpt_dir) / f"step_{step}" / _PAYLOAD)


def save_state(ckpt_dir, step: int, state, keep: int = 3,
               async_write: bool = False):
    """TrainState-aware save: the one checkpointable object serializes
    through its plain-dict view (HiFT's visit order included)."""
    return save(ckpt_dir, step, state.to_tree(), keep=keep,
                async_write=async_write)


def restore_state(ckpt_dir, step: int, *, mesh=None, strategy=None):
    """Inverse of :func:`save_state`: a ``TrainState`` of CPU tensors (the
    step an int, ``extra["order"]`` an int64 numpy array, ``extra["rng"]``
    a uint32 one).  ``strategy=`` (an instance built for the target mesh)
    or ``mesh=`` take the elastic resize (``dist.elastic.resize_state``):
    the state lands on the new layout, whatever mesh it was saved from."""
    from repro_torch.core.strategy import TrainState
    tree = restore(ckpt_dir, step)
    extra = dict(tree.get("extra") or {})
    if "order" in extra:
        extra["order"] = np.asarray(extra["order"], np.int64)
    if "rng" in extra:
        extra["rng"] = np.asarray(extra["rng"], np.uint32)
    tree["extra"] = extra
    state = TrainState.from_tree(tree)
    if mesh is not None or strategy is not None:
        from repro_torch.dist.elastic import resize_state
        state = resize_state(state, strategy=strategy, mesh=mesh)
    return state


def restore_latest(ckpt_dir, like: PyTree = None):
    step = latest_step(ckpt_dir)
    if step is None:
        return None, like
    return step, restore(ckpt_dir, step)
