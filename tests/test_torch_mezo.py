"""The port's MeZO (``repro_torch.optim.mezo``, strategy ``mezo``) on the
CPU, held against the JAX package (the counterpart of the reference's
``tests/test_mezo.py``).

Torch cannot draw ``jax.random``'s stream, so the port's own z differs
from the reference's by design.  The ``noise=`` seam hands the port the
reference's z (``jax.random.split`` of the step's key, then ``normal``
per leaf, as ``repro.optim.mezo`` draws it) as numpy, which makes the two
packages' steps comparable.  The port perturbs in place (p += eps z,
p -= 2 eps z, p += eps z) where the reference perturbs copies of the
original p, so its L- and the params the update starts from carry the
rounding of those adds: losses within 1e-5 over three steps at lr 1e-3
(MeZO's own learning rates are 1e-3 and below: the SPSA estimate
(L+ - L-) / 2 eps multiplies a loss's rounding by 1 / 2 eps = 500), params
within atol 1e-5.

A bf16 leaf is perturbed from its kept original, as the reference builds
each perturbed tree: at lr 0 three steps leave every param bit-equal, and
at lr 1e-3 the port follows the reference's written bf16 arithmetic (the
JAX run under ``jax.disable_jit``: under jit XLA keeps ``p + eps z`` in
fp32 where the reference's code rounds it to bf16, which a bf16 tensor
cannot hold): the first loss within 1e-5, later ones within 2e-4, and the
params after the first step within one bf16 ulp (atol 1e-5 near zero): a
loss's rounding, times 500 in the estimate, sends an element at a
rounding boundary to the next bf16 value, and later steps compound it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.mezo import mezo_step as jax_mezo_step  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.core import LRSchedule, make_runner  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim.mezo import mezo_step, noise_seed, prng_key  # noqa: E402
from test_torch_pipeline import one_thread  # noqa: E402,F401
from test_torch_training import (_batches, _cfgs, _jbatch,  # noqa: E402
                                 _jtree, _np_params)

LR = 1e-3
UNTIED, TIED = "llama2-7b", "roberta-base"


def jax_noise(tree, key):
    """The reference's z of ``key`` for every leaf of ``tree``, as the
    port's seam wants it: ``(path, index) -> z`` (index: a layer of a
    stacked leaf, None for the whole leaf)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    keys = jax.random.split(key, len(flat))
    z = {"/".join(k.key for k in path):
         np.asarray(jax.random.normal(kk, np.shape(leaf), jnp.float32))
         for (path, leaf), kk in zip(flat, keys)}
    return lambda path, index: z[path] if index is None else z[path][index]


def jax_step_noise(tree):
    """The strategy's seam: the reference's ``fold_in(rng, step)`` key."""
    return lambda rng, step: jax_noise(tree, jax.random.fold_in(
        jnp.asarray(rng, jnp.uint32), step))


def _np(tree):
    return {p: (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
            for p, x in flatten_with_paths(tree).items()}


def _assert_close(got, want, **tol):
    assert got.keys() == want.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], err_msg=path, **tol)


@pytest.mark.parametrize("seed", [0, 3, 2**31 - 1])
def test_prng_key_is_the_reference_key(seed):
    np.testing.assert_array_equal(prng_key(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))
    assert prng_key(seed).dtype == np.uint32


def test_mezo_step_matches_the_reference():
    """``optim.mezo.mezo_step`` against ``repro.optim.mezo.mezo_step`` on
    the reference's z, at the tied config (the embedding perturbed once
    reaches the head too): the loss and the updated params."""
    name = TIED
    jcfg, cfg = _cfgs(name)
    npp = _np_params(name)
    batch = _batches(cfg, 1)[0]
    key = jax.random.PRNGKey(5)
    want_p, want_l = jax.jit(lambda p, b: jax_mezo_step(
        lambda q, c: JT.loss_fn(jcfg, q, c, compute_dtype=jnp.float32),
        p, b, key, jnp.float32(LR)))(_jtree(npp), _jbatch(batch))
    params = bridge.to_torch(npp)
    got_p, got_l = mezo_step(
        lambda p, b: TT.loss_fn(cfg, p, b, compute_dtype=torch.float32),
        params, batch, (0, 5), LR, stacked=("layers",),
        noise=jax_noise(npp, key))
    assert got_p is params                       # in place
    np.testing.assert_allclose(float(got_l), float(want_l), atol=1e-5)
    _assert_close(_np(got_p), _np(jax.tree.map(np.asarray, want_p)),
                  atol=1e-5)


@pytest.mark.parametrize("name", [UNTIED, TIED])
def test_mezo_strategy_matches_the_reference(name):
    """Three steps of the ``mezo`` strategy (seed 3) against the JAX
    runner's, the port drawing the reference's z through the seam: the key
    in ``extra["rng"]`` is the reference's, the losses and params agree,
    and no optimizer state or gradient exists."""
    jcfg, cfg = _cfgs(name)
    npp = _np_params(name)
    jr = jax_make_runner(jcfg, "mezo", params=_jtree(npp), seed=3,
                         schedule=JLRSchedule(base_lr=LR))
    tr = make_runner(cfg, "mezo", params=bridge.to_torch(npp), seed=3,
                     schedule=LRSchedule(base_lr=LR), device="cpu",
                     noise=jax_step_noise(npp))
    np.testing.assert_array_equal(tr.state.extra["rng"],
                                  np.asarray(jr.state.extra["rng"]))
    for b in _batches(cfg, 3):
        np.testing.assert_allclose(float(tr.train_step(b)),
                                   float(jr.train_step(_jbatch(b))),
                                   atol=1e-5)
    _assert_close(_np(tr.params), _np(jax.tree.map(np.asarray, jr.params)),
                  atol=1e-5)
    assert tr.opt_state == {}
    assert tr.strategy.peak_grad_params(tr.params) == 0


def test_mezo_is_deterministic_in_rng_and_step():
    """The default z is a function of (key, step): two runners of one key
    step alike, another key steps otherwise, and one state re-stepped
    repeats its step."""
    _, cfg = _cfgs(UNTIED)
    batches = _batches(cfg, 2)

    def run(rng):
        r = make_runner(cfg, "mezo", params=bridge.to_torch(
            _np_params(UNTIED)), rng=rng, device="cpu",
            schedule=LRSchedule(base_lr=LR))
        return [float(r.train_step(b)) for b in batches], r

    a, ra = run(prng_key(1))
    b, rb = run(np.array([0, 1], np.uint32))
    c, _ = run(prng_key(2))
    assert a == b and a[1] != c[1]
    _, m1 = ra.strategy.step(ra.state, batches[0])
    _, m2 = ra.strategy.step(ra.state, batches[0])
    assert float(m1["loss"]) == float(m2["loss"])
    for p, t in flatten_with_paths(ra.params).items():
        assert torch.equal(t, flatten_with_paths(rb.params)[p]), p


def test_noise_is_drawn_one_layer_slice_at_a_time():
    """A stacked leaf's z is asked for one layer at a time (the temporary
    is one slice), every slice has its own seed, and the step's key and
    the step select them."""
    _, cfg = _cfgs(UNTIED)
    params = bridge.to_torch(_np_params(UNTIED))
    asked = []

    def noise(path, index):
        asked.append((path, index))
        t = flatten_with_paths(params)[path]
        return torch.zeros(t.shape[1:] if index is not None else t.shape)

    mezo_step(lambda p, b: TT.loss_fn(cfg, p, b, compute_dtype=torch.float32),
              params, _batches(cfg, 1)[0], (0, 0, 0), LR,
              stacked=("layers",), noise=noise)
    flat = flatten_with_paths(params)
    per_pass = [(p, i) for p, t in flat.items()
                for i in (range(t.shape[0]) if p.startswith("layers/")
                          else [None])]
    assert asked == per_pass * 3            # +eps, -2 eps, restore+update
    seeds = {noise_seed((0, 1, 7), p, i) for p, i in per_pass}
    assert len(seeds) == len(per_pass)
    assert noise_seed((0, 1, 7), *per_pass[0]) != \
        noise_seed((0, 1, 8), *per_pass[0])


def _bf16_runners(lr):
    jcfg, cfg = _cfgs(UNTIED)
    npp = _np_params(UNTIED)
    tp = {p: t.to(torch.bfloat16) for p, t in
          flatten_with_paths(bridge.to_torch(npp)).items()}
    from repro_torch.common.pytree import unflatten_from_paths
    tr = make_runner(cfg, "mezo", params=unflatten_from_paths(tp), seed=3,
                     schedule=LRSchedule(base_lr=lr), device="cpu",
                     noise=jax_step_noise(npp))
    jr = jax_make_runner(jcfg, "mezo", seed=3,
                         params=jax.tree.map(
                             lambda x: jnp.asarray(x, jnp.bfloat16), npp),
                         schedule=JLRSchedule(base_lr=lr))
    return cfg, tp, tr, jr


def test_bf16_mezo_at_lr_zero_leaves_params_bit_equal():
    cfg, before, tr, _ = _bf16_runners(0.0)
    for b in _batches(cfg, 3):
        tr.train_step(b)
    for path, t in flatten_with_paths(tr.params).items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, before[path]), \
            path


def test_bf16_mezo_matches_the_references_arithmetic():
    cfg, _, tr, jr = _bf16_runners(LR)
    with jax.disable_jit():
        for i, b in enumerate(_batches(cfg, 3)):
            np.testing.assert_allclose(float(tr.train_step(b)),
                                       float(jr.train_step(_jbatch(b))),
                                       atol=1e-5 if i == 0 else 2e-4)
            if i:
                continue
            want = {p: np.asarray(x.astype(jnp.float32))
                    for p, x in flatten_with_paths(jr.params).items()}
            for path, t in flatten_with_paths(tr.params).items():
                assert t.dtype == torch.bfloat16, path
                np.testing.assert_allclose(t.float().numpy(), want[path],
                                           atol=1e-5, rtol=2.0 ** -8,
                                           err_msg=path)
