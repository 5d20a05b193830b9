"""Mamba2 (SSD) block (port of ``repro.models.mamba2``).

Recurrence per head (state N = ``ssm_state``, head dim P):
    h_t = a_t * h_{t-1} + dt_t * B_t (outer) x_t        a_t = exp(dt_t * A)
    y_t = C_t . h_t + D * x_t
Two scans run it chunkwise.  Training (``mamba2_forward``) runs
``gated_chunked_scan``, the reference's chunked scan in plain torch ops
that autograd differentiates, on every device: the reference trains
through its jnp scan, and no kernel (the Pallas one nor the port's) has a
backward.  The prompt pass (``mamba2_prefill``) runs ``kernels.ssm_scan``,
on the card the hand-written kernel ``kernels/csrc/ssm_scan.cu``; decode
runs the single-step recurrence in plain torch.  Params keep the
reference's keys and ``x @ W`` layout; ``A_log`` and ``dt_bias`` stay fp32
(the SSM reads them in fp32), every other leaf may be in the compute
dtype.  In the training forward any leaf may be a layer of a codec record
(quantized residency, ``dist.quant.layer_of``): the projections multiply
through the dequant-matmul kernel, ``conv_w`` is decoded at use, and the
``(L, d)`` stacks come decoded.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ref
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models import layers as L

# per-head scalars the SSM reads in fp32 whatever the compute dtype
FP32_LEAVES = ("A_log", "dt_bias")


def d_inner(cfg: ArchConfig) -> int:
    return cfg.expand * cfg.d_model


def mamba2_init(gen: torch.Generator, cfg: ArchConfig, *, lead=(),
                device=None, dtype=torch.float32):
    """The reference's init: dense in/out projections, conv weights
    N(0, 0.1), ``A_log = log(linspace(1, 16, H))``, ``D = 1``,
    ``dt_bias = 0`` (``A_log``/``dt_bias`` in fp32 whatever ``dtype``)."""
    di = d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    conv_ch = di + 2 * n                 # x, B, C go through the conv
    kw = dict(device=device, dtype=dtype)
    f32 = dict(device=device, dtype=torch.float32)
    a_log = torch.log(torch.linspace(1.0, 16.0, h, **f32))
    return {
        "in_proj": L.dense_init(gen, cfg.d_model, 2 * di + 2 * n + h,
                                lead=lead, **kw),
        "conv_w": torch.randn((*lead, cfg.conv_width, conv_ch), generator=gen,
                              **kw).mul_(0.1),
        "conv_b": torch.zeros((*lead, conv_ch), **kw),
        "A_log": a_log.expand(*lead, h).contiguous(),
        "D": torch.ones((*lead, h), **kw),
        "dt_bias": torch.zeros((*lead, h), **f32),
        "norm": L.rmsnorm_init(di, lead=lead, **kw),
        "out_proj": L.dense_init(gen, di, cfg.d_model, lead=lead, **kw),
    }


def _depthwise_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                    state=None):
    """Causal depthwise conv1d.  x: (B, S, C); w: (W, C).

    A sum of W shifted products plus the bias, in the reference's order
    (not ``F.conv1d``, whose fp32 path cuDNN may run in TF32).  With
    ``state`` (B, W-1, C) (decode) it is the left context; returns
    ``(y, new_state)``, the last W-1 rows of the padded input."""
    W = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
        xp = torch.cat([pad, x], dim=1)
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = sum(xp[:, i:i + s] * w[i].to(x.dtype) for i in range(W))
    y = y + b.to(x.dtype)
    new_state = xp[:, -(W - 1):] if W > 1 else None
    return y, new_state


def gated_chunked_scan(x_scaled, a_log, B, C, chunk: int = 128, h0=None):
    """The reference's ``gated_chunked_scan`` (the shared core of Mamba2
    SSD), the training scan: ``kernels.ref.gated_chunked_scan_ref``, the
    reference's algorithm line for line in plain torch ops, so autograd
    differentiates it on every device.  x_scaled (Bt,S,H,P); a_log
    (Bt,S,H); B/C (Bt,S,N).  Returns (y, final state fp32)."""
    y, h = ref.gated_chunked_scan_ref(x_scaled, a_log, B, C, chunk=chunk,
                                      h0=h0)
    return y, h.float()


def ssd_chunked(x, dt, A_log, B, C, D, chunk: int = 128, h0=None,
                scan=gated_chunked_scan):
    """Mamba2 SSD scan.  x (Bt,S,H,P); dt (Bt,S,H) softplus'd; B/C
    (Bt,S,N).  The ``dt`` scaling and the ``D`` skip stay outside the
    scan, as in the reference.  ``scan``: the training scan (default) or
    ``kernels.ssm_scan`` (the prompt pass).  Returns (y, final state
    fp32)."""
    A = -torch.exp(A_log.float())                     # (H,) negative rates
    a_log = dt.float() * A                            # (Bt,S,H)
    x_scaled = x * dt[..., None].to(x.dtype)
    y, hfinal = scan(x_scaled, a_log, B, C, chunk=chunk, h0=h0)
    return y + x * D.to(x.dtype)[None, None, :, None], hfinal


def _split_proj(cfg: ArchConfig, zxbcdt: torch.Tensor):
    di, n = d_inner(cfg), cfg.ssm_state
    return torch.split(zxbcdt, [di, di, n, n, cfg.ssm_heads], dim=-1)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_prefill(p, x: torch.Tensor, cfg: ArchConfig, chunk: int = 128):
    """The prompt pass of one Mamba2 block (the body of the reference's
    ``zamba2.prefill`` per layer).  x: (B, S, D), already normed.

    Returns ``(y (B,S,D), ssm_state (B,H,P,N) fp32, conv_state
    (B,W-1,d_inner+2N))``: the scan's final state and the last W-1 rows of
    the conv's input, which decode continues from."""
    b, s, _ = x.shape
    W = cfg.conv_width
    if s < W - 1:
        raise ValueError(f"the hybrid prefill needs at least conv_width - 1 "
                         f"= {W - 1} prompt tokens, got {s}")
    di = d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    z, xin, Bm, Cm, dt = _split_proj(cfg, x @ p["in_proj"].to(x.dtype))
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, _ = _depthwise_conv(conv_in, p["conv_w"], p["conv_b"])
    conv_out = F.silu(conv_out)
    xin2, Bm2, Cm2 = torch.split(conv_out, [di, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])
    y, state = ssd_chunked(xin2.reshape(b, s, h, di // h), dt, p["A_log"],
                           Bm2.contiguous(), Cm2.contiguous(), p["D"],
                           chunk=chunk, scan=ssm_scan)
    y = y.reshape(b, s, di)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    return y @ p["out_proj"].to(x.dtype), state.float(), conv_in[:, -(W - 1):]


def mamba2_forward(p, x: torch.Tensor, cfg: ArchConfig, chunk: int = 128):
    """Full-sequence training forward of one Mamba2 block.  x: (B, S, D),
    already normed -> (B, S, D).

    The reference's ops in its order; the SSD call runs under
    ``torch.utils.checkpoint`` (non re-entrant), as the reference wraps it
    in ``jax.checkpoint``: its O(Lc^2) decay and score blocks are
    recomputed in the backward instead of saved."""
    b, s, _ = x.shape
    di = d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    z, xin, Bm, Cm, dt = _split_proj(cfg, L.linear(x, p["in_proj"]))
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, _ = _depthwise_conv(conv_in, L.decoded(p["conv_w"]), p["conv_b"])
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"].float())
    A_log, D = p["A_log"], p["D"]

    def ssd(xh, dtt, bm, cm):
        return ssd_chunked(xh, dtt, A_log, bm, cm, D, chunk=chunk)[0]

    args = (xin.reshape(b, s, h, di // h), dt, Bm, Cm)
    if torch.is_grad_enabled():
        y = checkpoint(ssd, *args, use_reentrant=False,
                       preserve_rng_state=False)
    else:
        y = ssd(*args)
    y = L.rmsnorm(p["norm"], y.reshape(b, s, di) * F.silu(z))
    return L.linear(y, p["out_proj"])


def mamba2_decode(p, x: torch.Tensor, cfg: ArchConfig, ssm_state, conv_state):
    """Single-token recurrent step.  x: (B, 1, D).

    ssm_state: (B, H, P, N) fp32; conv_state: (B, W-1, conv_ch).
    Returns (y (B,1,D), new_ssm_state, new_conv_state)."""
    b = x.shape[0]
    di = d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    P = di // h
    z, xin, Bm, Cm, dt = _split_proj(cfg, x @ p["in_proj"].to(x.dtype))
    conv_in = torch.cat([xin, Bm, Cm], dim=-1)
    conv_out, new_conv = _depthwise_conv(conv_in, p["conv_w"], p["conv_b"],
                                         state=conv_state)
    conv_out = F.silu(conv_out)
    xin, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)

    dt = _softplus(dt.float() + p["dt_bias"])                   # (B, 1, H)
    A = -torch.exp(p["A_log"].float())
    a = torch.exp(dt[:, 0] * A)                                  # (B, H)
    xh = xin.reshape(b, h, P)
    dB = dt[:, 0, :, None] * Bm[:, 0][:, None, :]                # (B, H, N)
    new_state = (ssm_state * a[..., None, None]
                 + xh[..., :, None].float() * dB[..., None, :])
    y = torch.einsum("bhpn,bn->bhp", new_state.to(x.dtype), Cm[:, 0])
    y = y + xh * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(b, 1, di)
    y = L.rmsnorm(p["norm"], y * F.silu(z))
    return y @ p["out_proj"].to(x.dtype), new_state, new_conv


def init_states(cfg: ArchConfig, batch: int, dtype=torch.float32,
                device="cpu"):
    """Zero (ssm (B,H,P,N) fp32, conv (B,W-1,d_inner+2N)) states."""
    di = d_inner(cfg)
    h, n = cfg.ssm_heads, cfg.ssm_state
    return (torch.zeros((batch, h, di // h, n), dtype=torch.float32,
                        device=device),
            torch.zeros((batch, cfg.conv_width - 1, di + 2 * n), dtype=dtype,
                        device=device))
