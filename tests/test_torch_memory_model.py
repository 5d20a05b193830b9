"""The port's Appendix-B memory model (``repro_torch.core.memory_model``)
held against the reference's (``repro.core.memory_model``) on the CPU.

- ``analyze`` on the port's meta-device shapes equals ``analyze`` on the
  reference's ``jax.eval_shape`` shapes, report for report, over the five
  paper configs, zamba2-2.7b, the six archs of the moe, vlm and
  remaining dense configs and seamless-m4t-large-v2 (encdec) x the five optimizers x {fp32, mixed,
  mixed_hi} x {hift, fpft, hift_pipelined, fpft_streamed, mezo, lomo,
  adalomo} x {no codec, int8, nf4}; a combination the reference rejects raises the same
  ``ValueError`` in the port.  Integer arithmetic on the same shapes, so
  equal to the last bit.  deepseek-moe-16b's, internvl2-26b's and
  seamless-m4t-large-v2's headline figures are pinned.
- ``paper_equation_check`` and the cases of ``tests/test_memory_model.py``
  on the port's shapes.
"""
import dataclasses
import functools

import jax
import pytest

torch = pytest.importorskip("torch")

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import memory_model as JM  # noqa: E402
from repro.models import get_family as jax_get_family  # noqa: E402
from repro_torch.common.pytree import flatten_with_paths  # noqa: E402
from repro_torch.configs.registry import PAPER_IDS, get_config  # noqa: E402
from repro_torch.core import memory_model as TM  # noqa: E402
from repro_torch.models import get_family  # noqa: E402

OPTIMIZERS = ["adamw", "sgdm", "sgd", "adagrad", "adafactor"]
PRECISIONS = ["fp32", "mixed", "mixed_hi"]
MODES = ["hift", "fpft", "hift_pipelined", "fpft_streamed", "mezo", "lomo",
         "adalomo"]
CODECS = [None, "int8", "nf4"]


@functools.lru_cache(maxsize=None)
def _jax_shapes(arch):
    cfg = jax_get_config(arch)
    fam = jax_get_family(cfg)
    return fam.unit_spec(cfg), jax.eval_shape(functools.partial(
        fam.init, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _shapes(arch):
    cfg = get_config(arch)
    return get_family(cfg).unit_spec(cfg), TM.param_shapes(cfg)


HYBRID = "zamba2_2_7b"
# the moe, vlm and remaining dense configs, and the encdec one
MORE = ["deepseek_7b", "internlm2_1_8b", "smollm_360m", "internvl2_26b",
        "deepseek_moe_16b", "arctic_480b", "seamless_m4t_large_v2",
        "xlstm_1_3b"]


@pytest.mark.parametrize("arch", PAPER_IDS + [HYBRID] + MORE)
def test_param_shapes_are_the_references_without_storage(arch):
    units, shapes = _shapes(arch)
    junits, jshapes = _jax_shapes(arch)
    flat, jflat = flatten_with_paths(shapes), flatten_with_paths(jshapes)
    assert flat.keys() == jflat.keys()
    for path, leaf in flat.items():
        assert leaf.device.type == "meta", path
        assert tuple(leaf.shape) == tuple(jflat[path].shape), path
        assert str(leaf.dtype).split(".")[-1] == str(jflat[path].dtype)
    assert [u.label() for u in units] == [u.label() for u in junits]


@pytest.mark.parametrize("arch", PAPER_IDS + [HYBRID] + MORE)
def test_analyze_matches_the_reference(arch):
    units, shapes = _shapes(arch)
    junits, jshapes = _jax_shapes(arch)
    compared = rejected = 0
    for opt in OPTIMIZERS:
        for precision in PRECISIONS:
            for mode in MODES:
                for codec in CODECS:
                    kw = dict(optimizer=opt, precision=precision, mode=mode,
                              m=1, frozen_quant=codec)
                    try:
                        want = JM.analyze(jshapes, junits, **kw)
                    except ValueError as e:
                        with pytest.raises(ValueError) as got:
                            TM.analyze(shapes, units, **kw)
                        assert str(got.value) == str(e), kw
                        rejected += 1
                        continue
                    got = TM.analyze(shapes, units, **kw)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), kw
                    compared += 1
    # mixed + a codec is the one combination the reference rejects
    assert (compared, rejected) == (5 * 3 * 7 * 3 - 5 * 7 * 2, 5 * 7 * 2)


def test_zamba2_prices_as_the_reference():
    """The hybrid family on its meta-device ``init``: 2,422,670,240
    params; fp32 AdamW P+G+S 10.20 GiB under HiFT m=1 (the largest group,
    the shared block's 104.86 M params) against 36.10 GiB under FPFT, a
    71.8 % saving; the fused strategies' grain is one super-block
    (``liveness_m = attn_every``), priced as the reference prices it."""
    units, shapes = _shapes(HYBRID)
    junits, jshapes = _jax_shapes(HYBRID)
    kw = dict(optimizer="adamw", precision="fp32")
    h = TM.analyze(shapes, units, mode="hift", **kw)
    f = TM.analyze(shapes, units, mode="fpft", **kw)
    assert h.n_params == 2_422_670_240
    assert round(h.pgs_gb, 2) == 10.20 and round(f.pgs_gb, 2) == 36.10
    assert round(h.peak_trainable / 1e6, 2) == 104.86
    assert round(100 * (1 - h.pgs_gb / f.pgs_gb), 1) == 71.8
    m = get_config("zamba2-2.7b").attn_every
    for mode in ("lomo", "adalomo", "hift", "hift_pipelined"):
        want = JM.analyze(jshapes, junits, mode=mode, m=m, **kw)
        assert dataclasses.asdict(TM.analyze(shapes, units, mode=mode, m=m,
                                             **kw)) == \
            dataclasses.asdict(want), mode


@pytest.mark.parametrize("arch,pgs", [
    ("deepseek_moe_16b", {("hift", None): 69.45, ("fpft", None): 251.53,
                          ("hift", "nf4"): 14.50}),
    ("internvl2_26b", {("hift", None): 80.36, ("fpft", None): 295.98,
                       ("hift", "nf4"): 15.71}),
    ("deepseek_7b", {("hift", None): 30.43}),
    ("internlm2_1_8b", {("hift", None): 9.16}),
    ("smollm_360m", {("hift", None): 2.05}),
    ("seamless_m4t_large_v2", {("hift", None): 9.03, ("fpft", None): 24.35,
                               ("hift", "nf4"): 3.72}),
    ("xlstm_1_3b", {("hift", None): 14.30, ("fpft", None): 52.60,
                    ("hift", "nf4"): 2.81})])
def test_new_archs_price_as_the_reference(arch, pgs):
    """AdamW, m=1, fp32 P+G+S in GiB (NF4 residency with bf16 moments
    where the codec is named): deepseek-moe-16b's HiFT fits one 80 GB card
    where FPFT needs more than three (a 72.4 % saving); internvl2-26b's
    fp32 HiFT does not fit, its NF4 HiFT does; xlstm-1.3b's HiFT saves
    72.8 % of FPFT's P+G+S."""
    units, shapes = _shapes(arch)
    for (mode, codec), want in pgs.items():
        kw = dict(optimizer="adamw", precision="fp32", mode=mode, m=1,
                  frozen_quant=codec,
                  moment_dtype="bf16" if codec else "fp32")
        got = TM.analyze(shapes, units, **kw)
        assert round(got.pgs_gb, 2) == want, (mode, codec)
    saving = {"deepseek_moe_16b": 72.4, "seamless_m4t_large_v2": 62.9,
              "xlstm_1_3b": 72.8}
    if arch in saving:
        h, f = (TM.analyze(shapes, units, mode=m) for m in ("hift", "fpft"))
        assert round(100 * (1 - h.pgs_gb / f.pgs_gb), 1) == saving[arch]
    if arch == "seamless_m4t_large_v2":
        # the largest group is the embed (the token table and src_proj),
        # 1 M above the untied head
        assert h.n_params == 1_633_847_296
        assert h.peak_trainable == 256_256 * 1024 + 1024 * 1024
        for mode, want in (("lomo", 7.07), ("adalomo", 7.08),
                           ("mezo", 6.09)):
            got = TM.analyze(shapes, units, mode=mode,
                             optimizer="adafactor" if mode == "adalomo"
                             else "adamw")
            assert round(got.pgs_gb, 2) == want, mode
    if arch == "xlstm_1_3b":
        # 42 mLSTM and 6 sLSTM layers; the largest group is the head (its
        # weight and final norm), the embedding 2,048 params below it
        assert h.n_params == 3_529_631_912
        assert h.peak_trainable == 2048 * 50304 + 2048 == 103_024_640
        for mode, want in (("lomo", 13.53), ("adalomo", 13.54),
                           ("mezo", 13.15)):
            got = TM.analyze(shapes, units, mode=mode,
                             optimizer="adafactor" if mode == "adalomo"
                             else "adamw")
            assert round(got.pgs_gb, 2) == want, mode


@pytest.mark.parametrize("kw", [
    dict(m=2), dict(m=4, mode="hift_pipelined", stream_depth=3),
    dict(mode="fpft_streamed", stream_chunk_bytes=1 << 24),
    dict(moment_dtype="bf16", frozen_quant="nf4", precision="mixed_hi"),
    dict(ef_pods=4), dict(ef_pods=2, mode="fpft"),
    dict(ef_pods=2, mode="mezo"), dict(moment_dtype="bf16", optimizer="sgd"),
    dict(frozen_quant="fp8"), dict(stream_depth=0)],
    ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_analyze_options_match_the_reference(kw):
    units, shapes = _shapes("llama2_7b")
    junits, jshapes = _jax_shapes("llama2_7b")
    try:
        want = JM.analyze(jshapes, junits, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match="^" + str(e)[:20]):
            TM.analyze(shapes, units, **kw)
        return
    assert dataclasses.asdict(TM.analyze(shapes, units, **kw)) == \
        dataclasses.asdict(want)


# ------------------------------------------------------------ the cases of
# tests/test_memory_model.py, on the port's shapes

def test_appendix_b_equations():
    fpft, hift, saved = TM.paper_equation_check(zeta1_gb=26.08, k=34)
    assert abs(fpft - 4 * 26.08) < 1e-6
    assert abs(hift - 37 / 34 * 26.08) < 1e-6
    assert abs(saved - (fpft - hift)) < 1e-6
    assert (fpft, hift, saved) == JM.paper_equation_check(26.08, 34)


def test_llama7b_table12_columns():
    units, shapes = _shapes("llama2_7b")
    f = TM.analyze(shapes, units, optimizer="adamw", precision="fp32",
                   mode="fpft")
    h = TM.analyze(shapes, units, optimizer="adamw", precision="fp32",
                   mode="hift")
    assert abs(f.para_mb - 25705) / 25705 < 0.02
    assert abs(f.state_mb - 51410) / 51410 < 0.02
    assert abs(h.grad_mb - 772) / 772 < 0.12
    assert abs(h.state_mb - 1544) / 1544 < 0.12
    mh = TM.analyze(shapes, units, optimizer="adamw", precision="mixed_hi",
                    mode="hift")
    assert abs(mh.pgs_gb - 15.57) / 15.57 < 0.12   # paper Mixed^Hi #PGS


def test_sgd_has_zero_state():
    units, shapes = _shapes("roberta_base")
    r = TM.analyze(shapes, units, optimizer="sgd", precision="fp32",
                   mode="hift")
    assert r.state_mb == 0.0


def test_adafactor_state_sublinear():
    units, shapes = _shapes("llama2_7b")
    r = TM.analyze(shapes, units, optimizer="adafactor", precision="fp32",
                   mode="fpft")
    assert r.state_mb < 20  # paper: 10.82 MB
    h = TM.analyze(shapes, units, optimizer="adafactor", precision="fp32",
                   mode="hift")
    assert h.state_mb < 1   # paper: 0.33 MB


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_memory_decreases_with_k(m):
    units, shapes = _shapes("roberta_large")
    r1 = TM.analyze(shapes, units, optimizer="adamw", mode="hift", m=m)
    r2 = TM.analyze(shapes, units, optimizer="adamw", mode="hift", m=m * 2)
    assert r2.pgs_gb >= r1.pgs_gb  # bigger groups -> more resident


@pytest.mark.parametrize("opt", ["adamw", "sgdm", "adagrad", "adafactor"])
def test_hift_pipelined_holds_exactly_two_bundles(opt):
    units, shapes = _shapes("roberta_base")
    h = TM.analyze(shapes, units, optimizer=opt, precision="fp32",
                   mode="hift")
    p = TM.analyze(shapes, units, optimizer=opt, precision="fp32",
                   mode="hift_pipelined")
    assert p.state_mb == 2 * h.state_mb
    assert p.grad_mb == h.grad_mb          # still one backward, one group
    assert p.para_mb == h.para_mb
    assert p.peak_trainable == h.peak_trainable


def test_hift_pipelined_mixed_hi_doubles_masters():
    units, shapes = _shapes("roberta_base")
    h = TM.analyze(shapes, units, precision="mixed_hi", mode="hift")
    p = TM.analyze(shapes, units, precision="mixed_hi", mode="hift_pipelined")
    assert p.para_mb > h.para_mb
    assert p.para_mb - h.para_mb == pytest.approx(
        4 * h.peak_trainable / 2**20)


def test_hift_pipelined_still_beats_fpft():
    units, shapes = _shapes("llama2_7b")
    f = TM.analyze(shapes, units, optimizer="adamw", precision="fp32",
                   mode="fpft")
    p = TM.analyze(shapes, units, optimizer="adamw", precision="fp32",
                   mode="hift_pipelined")
    assert p.pgs_gb < 0.5 * f.pgs_gb


def test_adafactor_state_against_the_bundles_bytes():
    """The model's Adafactor #Sta of a group against the fp32 bytes of
    the moments the optimizer keeps for it.  They differ where the
    reference's model and its optimizer path differ: the model prices a
    stacked per-layer vector ``(L, d)`` as a full ``v`` (L d floats), the
    optimizer (``stacked=False`` on the group's slice) factors it across
    its layers into ``vr (L,)`` and ``vc (d,)``."""
    from repro_torch.core.grouping import make_groups, split_params
    from repro_torch.optim import make_optimizer
    cfg = get_config("gpt2-large", smoke=True)
    units, shapes = get_family(cfg).unit_spec(cfg), TM.param_shapes(cfg)
    acc = TM._Accountant(shapes, units)
    opt = make_optimizer("adafactor")
    for g in make_groups(units, 2):
        active = split_params(shapes, g)[0]
        state = opt.init(active)
        nbytes = sum(t.numel() * t.element_size() for t in
                     flatten_with_paths(state["moments"]).values())
        stacked_vectors = [t.shape for t in flatten_with_paths(
            active.get("layers", {})).values() if t.ndim == 2]
        extra = sum(4 * (n + d - n * d) for n, d in stacked_vectors)
        assert nbytes == acc.group_adafactor_bytes(g) + extra, g.label()
        assert bool(extra) == ("layers" in active)
