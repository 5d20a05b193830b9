"""The port's training slice, held against the JAX package on the CPU.

Same JAX-initialised params (norm scales and biases perturbed so those
paths count), bridged to torch; same numpy-made batches (the port's
``SyntheticLM`` is the reference's generator).  ``ce_chunk=16`` at
sequence 32, so the chunked cross-entropy runs two checkpointed blocks;
llama2-smoke keeps ``remat="layer"``.

- ``loss_fn``: loss and every gradient at fp32 for llama2-smoke
  (rmsnorm/swiglu) and roberta-base-smoke (layernorm/gelu/tied head), cut
  in {None, 0, 1, n_layers}; below the cut the port's gradients are absent
  (the reference's are zeros).  Tolerance rtol 1e-5 / atol 1e-6: the same
  fp32 arithmetic, summed in other orders by XLA and by PyTorch's CPU
  kernels (and XLA fuses multiply-adds under jit).
- the training attention (several blocks), and the options the port
  refuses;
- the ``to_tree``/``from_tree`` round trip, the CLI, train-then-serve, and
  the analytic memory figures ``chip_smoke.py`` prints.

The runner itself is held against the reference's in
``test_torch_runner.py``, which shares this file's helpers.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import HiFTConfig as JHiFTConfig  # noqa: E402
from repro.core import LRSchedule as JLRSchedule  # noqa: E402
from repro.core import make_runner as jax_make_runner  # noqa: E402
from repro.core.memory_model import analyze  # noqa: E402
from repro.models import get_family as jax_get_family  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim.mixed_precision import get_policy as jax_policy  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths, tree_map  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import (HiFTConfig, LRSchedule, TrainState,  # noqa: E402
                              make_runner)
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.base import LayerStack  # noqa: E402
from repro_torch.optim.mixed_precision import get_policy  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-6)
LR = 1e-3
SEQ, BATCH = 32, 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """These tiny models run fastest on one intra-op thread; the tier-1 run
    puts several workers on the machine's cores, where torch's default of
    one thread a core makes them contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name):
    """(JAX config, port config) of an arch's smoke twin, ce_chunk 16."""
    return (dataclasses.replace(jax_get_config(name, smoke=True), ce_chunk=16),
            dataclasses.replace(get_config(name, smoke=True), ce_chunk=16))


@functools.lru_cache(maxsize=None)
def _np_params(name):
    jcfg, _ = _cfgs(name)
    params = jax.tree.map(np.asarray, jax_get_family(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(7)
    flat = flatten_with_paths(params)
    for path, a in flat.items():
        if path.endswith("scale"):
            flat[path] = (1 + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        elif path.split("/")[-1] in ("bias", "b_up", "b_down"):
            flat[path] = (0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
    from repro_torch.common.pytree import unflatten_from_paths
    return unflatten_from_paths(flat)


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _batches(cfg, n):
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                  global_batch=BATCH, seed=0))
    return [data.batch_at(s) for s in range(n)]


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _assert_tree_close(got, want, **tol):
    want = flatten_with_paths(want)
    got = flatten_with_paths(got)
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(want[path], np.float32),
                                   err_msg=path, **tol)


def _runner(opt="adamw", strategy="hift", m=1, order="bottom2up", seed=0,
            policy="fp32", fused=None):
    """The port's runner on the CPU from the bridged llama2-smoke params."""
    _, cfg = _cfgs("llama2-7b")
    kw = {}
    if strategy == "hift":
        kw["hift"] = HiFTConfig(m=m, strategy=order, seed=seed)
    return make_runner(cfg, strategy,
                       params=bridge.to_torch(_np_params("llama2-7b")),
                       optimizer=opt, schedule=LRSchedule(base_lr=LR),
                       policy=get_policy(policy), fused_update=fused,
                       device="cpu", **kw)


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("cut", [None, 0, 1, "n"])
@pytest.mark.parametrize("name", ["llama2-7b", "roberta-base"])
def test_loss_and_grads_match_jax(name, cut):
    jcfg, cfg = _cfgs(name)
    cut = cfg.n_layers if cut == "n" else cut
    npp = _np_params(name)
    batch = _batches(cfg, 1)[0]
    jloss, jgrads = jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, _jbatch(batch), cut=cut,
                             compute_dtype=jnp.float32))(_jtree(npp))
    # one leaf per layer, so a layer below the cut shows as absent
    tp = bridge.to_torch(npp)
    req = lambda t: t.clone().requires_grad_(True)
    layers = [tree_map(lambda x: req(x[i:i + 1]), tp["layers"])
              for i in range(cfg.n_layers)]
    params = {"embed": tree_map(req, tp["embed"]),
              "layers": LayerStack(layers), "head": tree_map(req, tp["head"])}
    loss = TT.loss_fn(cfg, params, batch, cut=cut,
                      compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    named = {f"embed/{k}": v for k, v in flatten_with_paths(
        params["embed"]).items()}
    named.update({f"head/{k}": v for k, v in flatten_with_paths(
        params["head"]).items()})
    for i, lyr in enumerate(layers):
        named.update({(i, k): v for k, v in flatten_with_paths(lyr).items()})
    grads = dict(zip(named, torch.autograd.grad(
        loss, list(named.values()), allow_unused=True)))
    jflat = flatten_with_paths(jgrads)
    below = lambda i: cut is not None and i < cut
    for key, g in grads.items():
        if isinstance(key, tuple):
            i, path = key
            want = np.asarray(jflat[f"layers/{path}"][i:i + 1])
            frozen = below(i)
        else:
            want = np.asarray(jflat[key])
            frozen = (key.startswith("embed") and cut is not None
                      and not cfg.tie_embeddings)
        if frozen:
            assert g is None, key
            assert not want.any(), key
        else:
            np.testing.assert_allclose(g.numpy(), want, err_msg=str(key),
                                       **TOL)


def test_training_attention_matches_jax():
    """Several query and kv blocks (the block-skipping schedule), the
    balanced schedule (4 blocks), the full attention, and the option the
    port refuses."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(JL.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16, 16))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TL.chunked_causal_attention(tq, tk, tv, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        TL.full_causal_attention(tq, tk, tv).numpy(),
        np.asarray(JL.full_causal_attention(*map(jnp.asarray, (q, k, v)))),
        **TOL)
    np.testing.assert_allclose(
        TL.chunked_causal_attention(tq, tk, tv, 16, 16, balanced=True)
        .numpy(), np.asarray(JL.chunked_causal_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 16, 16,
            balanced=True)), **TOL)
    _, cfg = _cfgs("llama2-7b")
    cfg = dataclasses.replace(cfg, attention_impl="pallas")
    params = bridge.to_torch(_np_params("llama2-7b"))
    with pytest.raises(NotImplementedError, match="no backward"):
        TT.loss_fn(cfg, params, _batches(cfg, 1)[0],
                   compute_dtype=torch.float32)


def test_to_tree_from_tree_round_trip():
    """A state copied out through ``to_tree`` and numpy, and read back
    with ``from_tree``, continues in lockstep with the original."""
    runner = _runner()
    _, cfg = _cfgs("llama2-7b")
    batches = _batches(cfg, 6)
    for b in batches[:3]:
        runner.train_step(b)
    tree = runner.state.to_tree()
    assert isinstance(tree["step"], np.int64) and int(tree["step"]) == 3
    copy = {"params": bridge.to_torch(bridge.to_numpy(tree["params"])),
            "opt_state": bridge.to_torch(bridge.to_numpy(tree["opt_state"])),
            "step": tree["step"],
            "extra": {"order": np.array(tree["extra"]["order"])}}
    other = _runner()
    other.load_state_dict(copy)
    for b in batches[3:]:
        assert float(runner.train_step(b)) == float(other.train_step(b))
    assert TrainState.from_tree(tree).step == 3


def test_unported_options_raise():
    from repro_torch.core import CrossPodConfig
    _, cfg = _cfgs("llama2-7b")
    params = bridge.to_torch(_np_params("llama2-7b"))
    # mesh= and cross_pod= are ported (tests/test_torch_distributed.py,
    # tests/test_torch_crosspod.py); the pipeline and the stream are
    # ported; a stream window still applies to fpft_streamed only
    with pytest.raises(ValueError, match="does not apply to 'hift'"):
        make_runner(cfg, "hift", params=params, device="cpu",
                    stream_window=1 << 20)
    # every strategy of the reference is ported: a name outside the
    # registry raises, and the new strategies reject what is not ported
    with pytest.raises(ValueError, match="unknown or not yet ported"):
        make_runner(cfg, "no-such-strategy", params=params, device="cpu")
    for name in ("mezo", "lomo", "adalomo"):
        with pytest.raises(ValueError, match="does not support cross_pod"):
            make_runner(cfg, name, params=params, device="cpu",
                        cross_pod=CrossPodConfig(pods=2))
    with pytest.raises(ValueError, match="no fused update kernel"):
        make_runner(cfg, "hift", params=params, optimizer="sgd",
                    fused_update=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_runner(cfg, "hift", params=params)


# ------------------------------------------------------------ satellites

def test_launcher_trains_on_cpu(capsys):
    out = train_cli.main(["--arch", "llama2-7b", "--smoke", "--steps", "4",
                          "--device", "cpu"])
    text = capsys.readouterr().out
    assert "hift k=4" in text and "step     0 loss" in text
    assert "done: final loss" in text
    assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "llama2-7b", "--smoke", "--steps", "1"])


def test_train_then_serve():
    """Greedy tokens after 2 HiFT steps, served through
    ``from_train_state``, equal those of serving the same params."""
    runner = _runner()
    _, cfg = _cfgs("llama2-7b")
    for b in _batches(cfg, 2):
        runner.train_step(b)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (9, 6)]
    a = ServeEngine.from_train_state(cfg, runner.state, max_len=32, batch=2,
                                     device="cpu").generate(prompts, 5)
    b = ServeEngine(cfg, runner.state.params, max_len=32, batch=2,
                    device="cpu").generate(prompts, 5)
    assert a == b and all(len(t) == 5 for t in a)


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    return chip_smoke


def _reference_analyze(arch, n_layers=None, **kw):
    """``repro.core.memory_model.analyze`` of the reference's config (m=1)."""
    cfg = jax_get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    fam = jax_get_family(cfg)
    shapes = jax.eval_shape(functools.partial(fam.init, cfg),
                            jax.random.PRNGKey(0))
    return analyze(shapes, fam.unit_spec(cfg), m=1, **kw)


# (arch, n_layers, mode, precision, optimizer) that chip_smoke.py's
# unquantized training phases price
CHIP_SMOKE_POINTS = (
    [("llama2-7b", None, "hift", "fp32", "adamw"),
     ("llama2-7b", None, "hift", "mixed_hi", "adamw"),
     ("llama2-7b", 4, "hift", "fp32", "adamw"),
     ("llama2-7b", 4, "fpft", "fp32", "adamw"),
     ("gpt-neo-2.7b", None, "fpft", "fp32", "adamw")]
    + [(a, None, "hift", "fp32", "adamw")
       for a in ("roberta-large", "gpt2-large", "gpt-neo-2.7b")]
    + [("gpt2-large", None, "hift", "fp32", o)
       for o in ("sgdm", "sgd", "adagrad", "adafactor")])


def test_chip_smoke_analytic_figures_are_the_memory_models():
    """``chip_smoke.py`` prints the port's analytic P+G+S
    (``repro_torch.core.memory_model``) beside the measured peaks; at every
    point its training phases price, the figures equal the reference's
    ``repro.core.memory_model.analyze``."""
    chip_smoke = _chip_smoke()
    assert not [k for k in vars(chip_smoke) if k.startswith("ANALYTIC")]
    for arch, layers, mode, precision, opt in CHIP_SMOKE_POINTS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        got = chip_smoke.analytic(cfg, mode, precision, optimizer=opt)
        want = _reference_analyze(arch, layers, mode=mode,
                                  precision=precision, optimizer=opt)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), \
            (arch, layers, mode, precision, opt)
    # the figures PERF.md quotes
    llama = get_config("llama2-7b")
    assert chip_smoke.analytic(llama).pgs_gb == 27.364364624023438
    assert chip_smoke.analytic(
        llama, precision="mixed_hi").pgs_gb == 15.567024230957031
