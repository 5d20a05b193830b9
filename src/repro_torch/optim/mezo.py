"""MeZO (Malladi et al., 2023), the paper's gradient-free baseline (port
of ``repro.optim.mezo``).

SPSA estimator: sample z ~ N(0, I) (regenerated from a seed, never
stored), evaluate the loss at theta + eps*z and theta - eps*z (two forward
passes, no backward), and step theta -= lr * (L+ - L-)/(2 eps) * z.
Memory: no gradients, no optimizer moments, only the params themselves.

Differences from the reference, all deliberate:

- the noise: torch cannot reproduce ``jax.random``'s stream.  The key
  keeps the reference's bits (``prng_key(seed)`` is
  ``jax.random.PRNGKey(seed)``), and the z of each slice is drawn from a
  ``torch.Generator`` seeded by a hash of (key words, leaf path, slice
  index), so z depends on the key and nothing else;
- fp32 leaves are perturbed in place, as MeZO's own algorithm runs: p +=
  eps z, L+, p -= 2 eps z, L-, p += eps z, p -= lr ghat z.  The reference
  builds each perturbed tree from the original p, so the params the
  update starts from differ from it by the rounding of the three in-place
  adds (a few ulps).  A leaf of any other dtype would random-walk under
  those adds (a bf16 ulp is far above lr ghat z), so its original is kept
  (a copy on its own device, one layer slice at a time) and every
  perturbed value and the update are computed from it, as the reference
  computes them: ``orig + sign eps z`` in the leaf's dtype and
  ``(orig.float() - lr ghat z)`` rounded once;
- a leaf of a stacked segment is perturbed one layer slice at a time, so
  the temporary z is one slice, never a whole stacked leaf.

``noise=`` replaces the generator: ``noise(path, index) -> z`` for the
leaf at ``path`` (its layer ``index`` of a stacked leaf, None for a whole
leaf).  It exists to hold the port to the reference (the tests hand it
``jax.random``'s z as numpy) and the card to the CPU; the default path
never takes it.
"""
from __future__ import annotations

import hashlib
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from repro_torch.common.pytree import flatten_with_paths

PyTree = Any
Noise = Callable[[str, Optional[int]], Any]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s two uint32 words, made without JAX:
    the seed's high and low 32 bits."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    np.uint32)


def noise_seed(key: Iterable[int], path: str, index: Optional[int]) -> int:
    """The ``torch.Generator`` seed of one slice's z: a hash of the key's
    words, the leaf path and the layer index (None for a whole leaf)."""
    words = tuple(int(k) for k in key)
    digest = hashlib.blake2b(repr((words, path, index)).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


def _slices(params: PyTree, stacked: Iterable[str]):
    """``(path, index, view)`` over every leaf: the leaves under a
    top-level key in ``stacked`` one layer slice at a time, the others
    whole (index None)."""
    stacked = set(stacked)
    for path, t in flatten_with_paths(params).items():
        if path.split("/")[0] in stacked and t.dim() >= 1:
            for i in range(t.shape[0]):
                yield path, i, t[i]
        else:
            yield path, None, t


def _z(key, path: str, index: Optional[int], like: torch.Tensor,
       noise: Optional[Noise]) -> torch.Tensor:
    """A fresh float32 z shaped like ``like``, on its device."""
    if noise is not None:
        z = noise(path, index)
        if not isinstance(z, torch.Tensor):
            z = torch.from_numpy(np.array(z, np.float32))
        return z.to(device=like.device, dtype=torch.float32, copy=True)
    gen = torch.Generator(device=like.device)
    gen.manual_seed(noise_seed(key, path, index))
    return torch.randn(like.shape, generator=gen, dtype=torch.float32,
                       device=like.device)


@torch.no_grad()
def mezo_step(loss_fn: Callable[[PyTree, Any], torch.Tensor], params: PyTree,
              batch: Any, key, lr, eps: float = 1e-3, *,
              stacked: Iterable[str] = (),
              noise: Optional[Noise] = None) -> tuple[PyTree, torch.Tensor]:
    """One MeZO step on ``params``, IN PLACE.  ``loss_fn(params, batch) ->
    0-d tensor``; ``key``: the step's key words (the strategy passes its
    rng words and the step); ``stacked``: top-level keys whose leaves are
    layer stacks, perturbed a slice at a time.  Returns ``(params, 0.5 *
    (L+ + L-))``, both on the params' device (nothing is read back to the
    host).  The same key regenerates z for +eps, -2 eps and the restore
    and update, so z is never stored."""
    stacked = tuple(stacked)
    # originals of the non-fp32 slices (the fp32 ones are restored by
    # subtraction), keyed by slice; filled by the first perturbation
    orig: dict = {}

    def perturb(sign: float, fp32_scale: float) -> None:
        for path, i, p in _slices(params, stacked):
            z = _z(key, path, i, p, noise).to(p.dtype)
            if p.dtype == torch.float32:
                p.add_(z, alpha=fp32_scale)
                continue
            o = orig.setdefault((path, i), p.clone())
            # the reference's ``p + sign * eps * z.astype(p.dtype)``: the
            # Python scalar takes the leaf's dtype, the scaled z rounds to
            # it, then the sum once
            torch.add(o, z.mul_(torch.tensor(sign * eps, dtype=p.dtype)),
                      out=p)

    perturb(1.0, eps)
    lplus = loss_fn(params, batch)
    perturb(-1.0, -2.0 * eps)
    lminus = loss_fn(params, batch)
    ghat = (lplus - lminus) / (2.0 * eps)
    coef = lr * ghat.float()
    for path, i, p in _slices(params, stacked):
        z = _z(key, path, i, p, noise)
        if p.dtype == torch.float32:
            p.add_(z, alpha=eps)                        # restore
            p.sub_(z.mul_(coef))
        else:
            o = orig.pop((path, i))
            p.copy_((o.float() - z.mul_(coef)).to(p.dtype))
    return params, 0.5 * (lplus + lminus)
