#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py            # from the repository root; needs a card

Phases, one JSON line each:

0. the card (``nvidia-smi`` name and power limit, torch and CUDA versions);
1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one nvcc
   per source, all at once), with ptxas's registers and spills per kernel
   and the tensor-core instructions (HMMA, HGMMA) in the SASS of the two
   prefill kernels, the bf16 dequant kernel and the two SSM scans, beside
   each instantiation's registers and spill bytes;
2. each attention kernel against its plain PyTorch version at the serving
   shapes (llama2-7b width in bf16 and fp32, batched and ragged; qwen2-0.5b's
   GQA widths; one long chat session, 1 x 4096 keys; windows that are
   empty; pad rows finite), with its time, the plain version's, the
   library call's where one PyTorch call computes the same function, and
   the bound of the work.  The prefill has two instantiations, both on the
   tensor cores: bf16 through ``wgmma`` (``flash_attention``), fp32 as
   three-pass TF32 (``flash_attention_fp32``, bound by TF32's rate x 3);
   the decodes split each row's window over blocks;
3. serving, card against CPU at fp32: a 2-layer model at llama2-7b width,
   both engines, the same greedy tokens on both devices (the fp32
   prefill's launches counted over the card's run);
4. serving at full size: llama2-7b (32 layers, bf16, random weights from a
   seed) served by ``ContinuousServeEngine`` and then ``ServeEngine``, with
   the attention kernels' launches counted over that run, then a profile
   of a prefill (batch 4, the attention's share) and of a decode step;
   then the same at fp32, the launcher's default dtype (``full_size_fp32``:
   16 of the 32 layers, 14 GB of weights, 16 new tokens a request);
5. each fused update kernel (AdamW, SGD-momentum, AdaGrad) against its
   plain version at one llama2-7b layer group, the embedding group, a
   Mixed^Hi case (f32 master, bf16 grads) and bf16 moments, with times,
   library yardstick and byte bound;
6. training, card against CPU at fp32: 3 HiFT steps with AdamW (embed,
   layer 0, head) of a 1-layer model at llama2-7b width;
7. training at full size: llama2-7b (32 layers, fp32, remat per layer),
   HiFT m=1 at batch 4 x 512 — AdamW bottom2up (embed, layer 0) and
   top2down (head), then SGD-momentum and AdaGrad — with host time, peak memory and the update
   kernel's device time per step, the update kernels' launches counted
   over that run, and a profile of a layer-group step; then two full-size
   steps under Mixed^Hi (bf16 params, fp32 master of the active group);
8. FPFT against HiFT at 4 layers of llama2-7b width (fp32, AdamW, fused).
   Peak memory of 7 and 8 stands beside the analytic P+G+S of the port's
   Appendix-B model (``core.memory_model``), as in every training phase;
   then the paper's experiment matrix, each phase counting the fused
   updates' launches over its run:
   a. card against CPU at 1 layer of gpt-neo-2.7b's width, then
      roberta-large, gpt2-large and gpt-neo-2.7b at full size (fp32, HiFT
      m=1, AdamW, batch 4 x 512): the embed step, the head and the top
      layer of each, with host time, peak memory and update time per step;
   b. the five optimizers (AdamW, SGD-momentum, SGD, AdaGrad, Adafactor)
      on gpt2-large at full size, two steps each, peak beside the model's
      P+G+S and #Sta;
   c. FPFT against HiFT on gpt-neo-2.7b at full depth (one step each):
      both peaks, both analytic figures and the saving;
   d. ``get_config(optimized=True)`` (the balanced causal schedule)
      against the default on gpt2-large at 1 x 2048, the embed step of
      each in turns ABBA: losses equal, both step times;
   e. checkpoint and resume of roberta-large at full size through the
      training loop's async save: the resumed run equal to a straight one,
      with the checkpoint's bytes and save and restore seconds;
   f. the bundle pipeline on side streams (``train_pipelined``): 2
      layers of llama2-7b at full width, fp32, AdamW (fused), 4 x 512 —
      serial ``hift`` against ``hift_pipelined`` at depths 2 and 3, and
      ``lisa`` against pipelined ``lisa``, bit-equal at every step of two
      sweeps and one; each mode's second-sweep step times, peak beside the
      analytic figure at its depth, and for serial and depth 2 a profile
      of the copies' device time and its overlap with kernels;
   g. ``fpft_streamed`` (``train_streamed``): gpt-neo-2.7b at full depth,
      one ``fpft`` and one ``fpft_streamed`` step (64 MiB chunks, depth
      3), bit-equal, peaks, pinned bytes, chunks, the update's share;
      then two streamed steps of llama2-7b at 8 of its 32 layers;
   h. ``lomo``, ``adalomo`` and ``mezo``, card against CPU
      (``train_fused_card_vs_cpu``): 1 layer at llama2-7b's width (untied
      head) and at gpt-neo-2.7b's (tied), fp32, 2 steps each of ``lomo``
      (clip 1.0), ``adalomo`` (clip 0; 1.0 at the tied width) and
      ``mezo`` (the same z on both devices), losses and grad norms within
      1e-4, params within a tolerance per strategy; then ``lomo`` with
      ``stream=`` bit-equal to unstreamed on the card;
   i. the same strategies at full width (``train_fused_full``): llama2-7b
      at 16 of its 32 layers, fp32, 4 x 512, ``lomo`` (2 steps, clip 1.0:
      a forward and two reverse sweeps), ``adalomo`` (2) and ``mezo`` (3),
      then gpt-neo-2.7b ``lomo`` (2): step time, loss, grad norm, peak
      allocated and reserved memory beside the analytic P+G+S (a peak more than 6 GiB
      over it fails the run: no whole gradient tree may exist), and a
      profiled ``lomo`` step (GEMM and update shares);
9. the dequant-matmul kernel against its plain version at llama2-7b's
   shapes (M = 4 x 512; the three projection shapes of a stacked layer,
   scale tile rows 8; the head, tile rows 1; one ragged case), then at
   zamba2's Mamba2 projections (in_proj (2560, 10448), whose last column
   tile is partial, and out_proj (5120, 2560)) and xlstm's (the mLSTM's
   gates (4096, 4), the sLSTM's w_zifo (2048, 8192)), int8 and NF4, fp32 x
   (CUDA cores, ``dequant_matmul``) and bf16 x (tensor cores,
   ``dequant_matmul_bf16``): decode bit-exact (x = the identity) and the
   product within tolerance, with its time, the plain version's, the
   time of ``torch.matmul`` on the pre-decoded weight, and the bound;
10. codes on the card equal codes on the CPU: a llama2-7b layer group and
   the head, both formats (the CPU's encode in the ``CpuHalves`` thread);
11. quantized training, card against CPU: 3 HiFT steps of a 1-layer model
   at llama2-7b width with ``QuantConfig("nf4", "bf16")``;
12. quantized training at full width: llama2-7b at 16 of its 32 layers,
   HiFT m=1, AdamW, batch 4 x 512 — NF4 with bf16 moments (embed, layers
   0 and 1 bottom2up, then the head and the top layer top2down), int8
   with bf16 moments and Mixed^Hi with NF4 (2 steps each) — with host
   time, peak memory beside the analytic
   P+G+S and the dequant kernel's device time and launches per step (the
   Mixed^Hi steps' on the tensor cores), the kernels' launches counted
   over that run, and profiles of a deep NF4 step and a deep Mixed^Hi +
   NF4 step;
   then hybrid training (zamba2; its Mamba2 blocks train through the
   plain chunked scan, as the reference trains through its jnp scan):
   a. card against CPU (``train_hybrid_card_vs_cpu``, run between 8f and
      8g, where its CPU half is done): 12 layers (2
      super-blocks) at zamba2-2.7b's width, slow-decay SSM scalars, fp32,
      2 x 64: 4 HiFT steps (m = 4, top2down: the shared block's group,
      whose cut rounds down to super-block 1, then layers of both
      super-blocks, then the embedding's group) and one step each of
      ``lomo`` (unclipped), ``adalomo`` and ``mezo``, losses within 1e-4;
      the scan kernel never launched by training, and its refusal of an
      input that requires grad under grad mode;
   b. zamba2-2.7b at its published config (``train_hybrid_full``), fp32,
      4 x 512: HiFT m=1 (embed, layer 0, head, shared, layer 53), then
      one step each of FPFT, ``lomo``, ``adalomo`` and ``mezo``, with step
      time and peak allocated
      and reserved memory beside the analytic P+G+S (the fused and MeZO
      peaks failing the run more than 6 GiB over it), the FPFT-vs-HiFT
      saving beside the analytic one, then NF4 HiFT with the dequant
      kernel's ms and launches a step;
13. the SSM scan kernel against its plain version at zamba2-2.7b's widths
   (H 80, P = N = 64): batch 4 x 512 in fp32 and bf16, one 2048-token
   prompt in fp32 and bf16, a ragged S = 300, the published init's fast
   decay and a small case; y and the final state within ``TOL``, with
   time, plain time and bound (fp32, ``ssm_scan``: three-pass TF32 on the
   tensor cores, bound by TF32's rate x 3, the CUDA cores' bound beside
   it; bf16, ``ssm_scan_bf16``);
14. the attention kernels at zamba2's shared block (H = KV = 32, head dim
   80): the prefill and both decodes in bf16 and fp32;
15. hybrid serving, card against CPU at fp32: 12 layers (2 super-blocks) of
   zamba2-2.7b at full width with slow-decay SSM scalars, 4 prompts of
   mixed length, 8 new tokens: the same greedy tokens on both devices
   (the card's run launches the fp32 scan 12 times);
16. hybrid serving at full size: zamba2-2.7b (54 layers, random weights
   from a seed) through ``ServeEngine``, batch 4, prompts of 128-512
   tokens, in bf16 with 32 new tokens and then in fp32 (the launcher's
   default; 24 of the 54 layers) with 8, each after one warm-up run:
   tokens/s, peak memory, the kernels' launches over that run (a scan a
   layer a prefill, of the dtype's instantiation), then prefill and decode-step times (the step
   in rounds, as ``generate`` runs it) and a profile of each (the scan's
   and the attention's share of the prefill);
17. the moe and vlm families and the last dense configs
   (``phase_moe_vlm``; ``--only moe_vlm`` builds and runs only this):
   a. the prefill and the decode with internvl2-26b's 256-token vision
      prefix in front of ragged left pads (48 heads over 8, hd 128) and
      the decode at smollm-360m's 15 heads over 5, bf16 and fp32, each
      against its plain version;
   b. ``train_moe_card_vs_cpu``: 2 layers of deepseek-moe-16b at full
      width, fp32, 2 x 64, 4 HiFT steps and one step each of ``lomo``,
      ``adalomo`` and ``mezo``, then one HiFT step of arctic-480b's SMOKE
      twin, losses within 1e-4, the routes that flip counted;
   c. ``train_moe_full``: deepseek-moe-16b at its published config, 4 x
      512, fp32 HiFT m=1 (embed, layer 0, head, layer 27) beside the
      analytic P+G+S and FPFT's, ``lomo`` and ``mezo`` (6 GiB gate), NF4
      HiFT from a tree encoded leaf by leaf;
   d. ``train_dense_vlm_full``: deepseek-7b (embed, head), internlm2-1.8b
      and smollm-360m fp32 HiFT, internvl2-26b NF4 HiFT at 16 of its 48
      layers with 256 vision tokens (its fp32 tree does not fit);
   e. ``serve_moe_vlm_full``: deepseek-moe-16b, internvl2-26b and
      smollm-360m (also continuous) in bf16, 4 ragged prompts, 16 new
      tokens: prefill ms, decode-step ms, tokens/s, launches;
   f. ``serve_moe_vlm_card_vs_cpu``: 2 layers of deepseek-moe-16b and of
      internvl2-26b width at fp32, the same greedy tokens on both
      devices, or a route flip behind a difference;
18. the encdec family (``phase_encdec``; ``--only encdec`` builds and runs
   only this):
   a. the prefill at seamless-m4t-large-v2's widths (16 heads over 16, hd
      64) non-causal, 4 x 512 (the encoder), and over another key length,
      4 x 64 over 512 keys and 4 x 37 over 300 (the cross attention; the
      last q and key tiles partial), and the decode over 512 memory keys,
      bf16 and fp32, each against its plain version;
   b. ``train_encdec_card_vs_cpu``: 2 encoder and 2 decoder layers at
      full width, fp32, 2 x 64 frames and 2 x 32 tokens, 4 HiFT steps
      (embed, enc 0, enc 1, dec 0) and one step each of ``lomo``,
      ``adalomo`` and ``mezo``, losses within 1e-4;
   c. ``train_encdec_full``: seamless-m4t-large-v2 at its published
      config, 4 x 512 frames and 4 x 128 tokens, fp32 HiFT m=1 (embed,
      enc 0, dec 0, dec 23, head, head again), FPFT and the saving beside
      the analytic one, ``lomo``/``adalomo``/``mezo`` (6 GiB gate), NF4
      HiFT with the dequant kernel's ms and launches;
   d. ``serve_encdec_full``: ``ServeEngine`` at full depth, batch 4, 512
      source frames, in bf16 (32 new tokens) and fp32 (8): prefill and
      decode-step ms, tokens/s, 72 prefill launches a generation and 48
      decode launches a step; then served card against CPU at 2 + 2
      layers, fp32, the same greedy tokens.
19. the xlstm family (``phase_xlstm``, run after phase 16 and before the
   card-against-CPU training phases; ``--only xlstm`` builds and runs
   only this):
   a. the wide scan kernel ((P, N) = (1025, 1024), ``ssm_scan_wide`` and
      ``ssm_scan_wide_bf16``: a scores kernel, fp64 on the CUDA cores,
      then a walk of 32-row state slices in shared memory fed by a
      producer warp's cp.async through a ring of stages, C h^T and
      the state update as TF32 ``mma.sync`` products, three passes fp32,
      two bf16, fp64 sums, the normalizer row in a block of its own)
      against its plain version (the fp64 chunked scan) at 16 x 512 (4
      prompts x 4 heads), 4 x 2048 (one long prompt) and 16 x 301 (a
      ragged last chunk), fp32 and bf16, at the mLSTM's own decays and at
      ``ssm_inputs``' fast decays, with ms, the scores kernel's and the
      walk's ms apart, the plain version's ms and the bound;
   b. ``serve_xlstm_full``: xlstm-1.3b at its published config (48
      layers), ``ServeEngine`` at batch 4, ragged prompts of up to 512
      tokens, bf16 (32 new tokens) and fp32 (8, 24 of the 48 layers):
      prefill and decode-step ms, tokens/s, a wide-scan launch a mLSTM
      layer a prefill (42 at full depth) and none in decode,
      peak memory beside the weights and the 2.82 GB decode state, the
      scan's and the sLSTM loop's shares of a prefill and a decode step;
   c. ``serve_xlstm_card_vs_cpu``, last: one super-block (8 layers) at
      full width, fp32: the same greedy tokens, prefill logits within
      ``XLSTM_LOGIT_TOL``.
20. xlstm training (``phase_train_xlstm``, run after ``train_streamed``
   and before ``train_fused_full``; ``--only xlstm`` runs it too, its CPU
   side in the same process and every run at all 48 layers);
   the mLSTM trains through the plain chunked scan and the sLSTM through
   its Python time loop under autograd, as the reference trains, so no
   scan kernel is launched (the run fails if one is):
   a. ``train_xlstm_full``: xlstm-1.3b at its published width and 16 of
      its 48 layers (two super-blocks), fp32, AdamW, 4 x 512: HiFT m=1
      (fused, in place) over embed (a backward through every layer),
      mLSTM 0, sLSTM 0, mLSTM 13, sLSTM 1, the head and the head again,
      with host ms, peak allocated and reserved
      beside the analytic P+G+S and the update kernel's ms; the embed step
      again, broken down (``xlstm_train_breakdown``: the sLSTM loop's and
      the chunked scan's shares of the host time in the forward, the
      recompute and the backward, the GEMMs' share of the busy time, the
      device's idle share); one FPFT step and the saving; ``lomo`` (clip
      1.0), ``adalomo`` and ``mezo`` one step each (6 GiB gate over the
      analytic P+G+S); NF4 HiFT from a tree encoded leaf by leaf (embed,
      mLSTM 0), the dequant kernel's ms and launches;
   b. ``train_xlstm_card_vs_cpu``: one super-block (8 layers) at full
      width, fp32, 1 x 128: HiFT m=1 over embed, mLSTM 0, sLSTM 0 and the
      head, then one ``lomo`` step, losses and grad norms within 1e-4.
21. distributed training at a world of one (``phase_train_dist``, run
   last, after the moe/encdec child has exited: its pinned bundles beside
   the child's memory overran the host; ``--only dist`` builds and runs
   only it, its CPU side in line): the cross-pod reduce
   (``CrossPodConfig(pods=2)``, the int8 error-feedback codec) card against
   CPU at 2 layers of gpt2-large; ``init_distributed`` through NCCL with a
   ``FileStore`` and a 1x1 ``DeviceMesh``; gpt2-large at full size, fp32,
   AdamW, 4 x 512, HiFT m = 10 (4 groups): a sweep of plain HiFT, HiFT on
   the mesh (losses within 1e-6 relative) and cross-pod HiFT, a step of
   each in turn, then 2 revisits (host ms per
   group kind, the codec's share, peaks beside the memory model's with
   ``ef_pods=2``, a profiled step); FPFT plain and cross-pod peaks; a
   checkpoint under the mesh restored onto a fresh mesh-built runner with
   ``restore_state(strategy=)``, 2 steps bit-equal; ``moe_ffn_spmd`` at
   tp = 1 equal to ``moe_ffn`` bit for bit at deepseek-moe-16b's width
   (at tp = 1 both run the same whole-range dispatch: the check holds the
   context's path, not the model-axis split, which only the gloo tests
   reach); then the options the mesh refused before: NF4 fp32 HiFT
   (kernel 7) and int8 Mixed^Hi HiFT with bf16 moments (kernel 7b) at
   gpt2-large's full width, each plain and on the mesh, a sweep in turns,
   losses and resident codes bit-equal and the mesh's launches of rows 7
   and 7b equal to plain's; ``fpft_streamed`` at full width, 2 steps,
   params and pinned host moments bit-equal; ``lomo`` and ``adalomo``
   with ``stream=`` at 2 layers, bit-equal.  Its fused AdamW launches
   join row 4's count, its dequant launches rows 7's and 7b's.
22. ``mesh=`` serving at a world of one (``phase_serve_mesh``, run right
   after phase 4's bf16 run, on its tree; ``--only serve_mesh`` builds
   and runs only it, with a tree of its own): ``init_distributed``
   through NCCL with a ``FileStore`` and a 1x1 ``DeviceMesh``; llama2-7b
   bf16 at full size, both engines on phase 4's prompts with 16 new
   tokens, without and then with the mesh: tokens bit-equal, each
   engine's median decode-step host ms, the gathered tree's extra bytes
   (0 at 1x1); rows 0-1 and 2-3 as two batch-2 engines against one
   batch-4 engine, printed only; zamba2-2.7b (6 layers), xlstm-1.3b (8),
   seamless-m4t-large-v2 (1 + 1), deepseek-moe-16b and internvl2-26b (2)
   in bf16, without and with the mesh, bit-equal; then the serve
   launcher at llama2-7b's full size in fp32, without and with ``--mesh
   1x1``, the same tokens.  Kernels 1, 2, 3, 8b and 8wb (and 1f, 2f on
   the launcher) are counted over the mesh's runs.

The CPU halves of the in-process card-against-CPU phases (6, 8a, the
fused training, 10's codes, the quantized and hybrid training, then 20b's
training, 21's cross-pod training and 19c's serving) run one after
another in a thread of their own from before the build (``CpuHalves``),
beside the card's kernel and serving phases; each draws its params on the
CPU, and its phase takes them for the card's half and compares, where
the thread has had the time to finish it (the ``cpu_half`` line gives the
job's start, its seconds and the take's wait; each line's ``at_s`` the
seconds since the start).  The CPU
sides of 17b and 18b run in one child process (``CpuSide``) from 20 on,
when the host's cores are otherwise idle.  The card waits on neither: the
script's time is the card's phases' and their host work's (the host's
least available memory over each phase is in the ``seconds`` line).

Then the ``nvidia-smi`` line, the kernels line and, last, the result line.
Any failure raises: the script exits non-zero and prints no result.  It
imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import functools
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM, dense; "tf32" is the tensor cores' rate that the fp32 prefill's
# three TF32 passes run at
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
HBM_BYTES_PER_S = 3.35e12
TOL = {"bfloat16": 2e-2, "float32": 2e-5}             # atol = rtol
L2_BYTES = 50 * 2**20
KERNEL_ROWS = {   # instantiations by name: the bf16 ones run on tensor cores
    "flash_attention": "src/repro/kernels/flash_attention.py:63",
    "flash_attention_fp32": "src/repro/kernels/flash_attention.py:63",
    "flash_decode": "src/repro/kernels/flash_attention.py:141",
    "paged_flash_decode": "src/repro/kernels/flash_attention.py:230",
    "fused_adamw": "src/repro/kernels/fused_adamw.py:41",
    "fused_sgdm": "src/repro/kernels/fused_sgdm.py:29",
    "fused_adagrad": "src/repro/kernels/fused_adagrad.py:30",
    "dequant_matmul": "src/repro/kernels/fused_dequant_matmul.py:64",
    "dequant_matmul_bf16": "src/repro/kernels/fused_dequant_matmul.py:64",
    "ssm_scan": "src/repro/kernels/ssm_scan.py:57",
    "ssm_scan_bf16": "src/repro/kernels/ssm_scan.py:57",
    "ssm_scan_wide": "src/repro/kernels/ssm_scan.py:57",
    "ssm_scan_wide_bf16": "src/repro/kernels/ssm_scan.py:57",
}
SOURCES = {
    **dict.fromkeys(("flash_attention", "flash_attention_fp32",
                     "flash_decode", "paged_flash_decode"),
                    "src/repro_torch/kernels/csrc/flash_attention.cu"),
    **dict.fromkeys(("fused_adamw", "fused_sgdm", "fused_adagrad"),
                    "src/repro_torch/kernels/csrc/fused_update.cu"),
    **dict.fromkeys(("dequant_matmul", "dequant_matmul_bf16"),
                    "src/repro_torch/kernels/csrc/dequant_matmul.cu"),
    **dict.fromkeys(("ssm_scan", "ssm_scan_bf16"),
                    "src/repro_torch/kernels/csrc/ssm_scan.cu"),
    **dict.fromkeys(("ssm_scan_wide", "ssm_scan_wide_bf16"),
                    "src/repro_torch/kernels/csrc/ssm_scan_wide.cu"),
}


def analytic(cfg, mode: str = "hift", precision: str = "fp32",
             optimizer: str = "adamw", frozen=None, moments: str = "fp32",
             stream_depth: int = 2, stream_chunk_bytes: int = 1 << 20,
             m: int = 1, ef_pods: int = 0):
    """The port's Appendix-B model of ``cfg`` (``core.memory_model.analyze``
    on its meta-device shapes, m=1 unless given): a ``MemoryReport`` whose
    ``pgs_gb`` is the analytic P+G+S in GiB, a model, not a measurement.
    ``stream_depth``: the bundles of ``hift_pipelined`` or the chunks of
    ``fpft_streamed`` on the device; ``stream_chunk_bytes``: the latter's
    chunk size; ``ef_pods``: the cross-pod reduce's residuals."""
    from repro_torch.core.memory_model import analyze, param_shapes
    from repro_torch.models import get_family
    return analyze(param_shapes(cfg), get_family(cfg).unit_spec(cfg),
                   optimizer=optimizer, precision=precision, mode=mode, m=m,
                   frozen_quant=frozen, moment_dtype=moments,
                   stream_depth=stream_depth,
                   stream_chunk_bytes=stream_chunk_bytes, ef_pods=ef_pods)


# The dequant-matmul kernel against its plain version (decode, then one
# cuBLAS product): fp32 sums of up to 11008 products taken in another
# order (atol = rtol 1e-4; a sum's rounding walk is ~1e-5 of outputs of
# order 1); bf16 outputs may round to neighbouring values (2e-2, the
# attention kernels' bf16 tolerance).  The decode itself is exact.
DEQUANT_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# The update kernels round every operation exactly as their plain
# versions' eager ops do (explicitly rounded intrinsics, no contraction),
# so they must agree bit for bit: 0 ulps of each output's dtype.
UPDATE_ULP_TOL = 0


_START = time.perf_counter()


def emit(phase: str, **kw) -> None:
    """One JSON line: the phase, its figures and ``at_s``, the seconds
    since the script was imported."""
    print(json.dumps({"phase": phase, **kw,
                      "at_s": time.perf_counter() - _START}), flush=True)


# ------------------------------------------------------------ measurement

def time_ms(torch, fn, arg_sets, reps: int = 10, launches: int = 30):
    """Device time of one call: median over ``reps`` of the mean time of
    ~``launches`` calls, by CUDA events.  The calls cycle over
    ``arg_sets``, whose inputs together exceed the L2 cache, so each call
    reads its inputs from HBM as a layer of the model does.  A sleep kernel
    holds the stream while the host enqueues the calls, so they run back to
    back and the host's launch overhead stays out of the number."""
    rounds = max(1, launches // len(arg_sets))

    def run():
        for _ in range(rounds):
            for args in arg_sets:
                fn(*args)

    run()                                               # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_s * 2e9))        # >= 2x the enqueue
        e0.record()
        run()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / (rounds * len(arg_sets)))
    return statistics.median(times)


def bound(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def copies(nbytes: int) -> int:
    return max(2, min(16, math.ceil(2 * L2_BYTES / max(nbytes, 1))))


# ------------------------------------------------------------ phase 2

def kernel_cases(torch):
    """(kernel, case name, dtype, shapes) at the slice's shapes."""
    llama = dict(h=32, kvh=32, hd=128)
    qwen = dict(h=14, kvh=2, hd=64)
    starts4 = [0, 37, 100, 5]
    lengths4 = [544, 520, 300, 33]
    empty4 = [0, 37, 300, 5]                    # row 2's window is empty
    return [
        ("flash_attention", "llama2-7b continuous prefill", "bfloat16",
         dict(b=1, s=512, starts=[37], **llama)),
        ("flash_attention", "llama2-7b batched prefill (ragged)", "bfloat16",
         dict(b=4, s=301, starts=[0, 50, 120, 300], **llama)),
        ("flash_attention", "qwen2-0.5b GQA prefill", "bfloat16",
         dict(b=1, s=512, starts=[37], **qwen)),
        ("flash_attention", "llama2-7b prefill fp32", "float32",
         dict(b=1, s=256, starts=[11], **llama)),
        ("flash_decode", "llama2-7b decode", "bfloat16",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **llama)),
        ("flash_decode", "qwen2-0.5b GQA decode", "bfloat16",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **qwen)),
        ("flash_decode", "llama2-7b decode fp32", "float32",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **llama)),
        ("paged_flash_decode", "llama2-7b paged decode", "bfloat16",
         dict(b=4, bs=16, max_blocks=34, starts=starts4, lengths=lengths4,
              **llama)),
        ("paged_flash_decode", "qwen2-0.5b GQA paged decode", "bfloat16",
         dict(b=4, bs=16, max_blocks=34, starts=starts4, lengths=lengths4,
              **qwen)),
        ("paged_flash_decode", "llama2-7b paged decode fp32", "float32",
         dict(b=4, bs=16, max_blocks=34, starts=starts4, lengths=lengths4,
              **llama)),
        ("flash_attention", "llama2-7b batched prefill fp32 (ragged)",
         "float32", dict(b=4, s=301, starts=[0, 50, 120, 300], **llama)),
        ("flash_decode", "llama2-7b long decode (1 x 4096)", "bfloat16",
         dict(b=1, s=4096, starts=[0], lengths=[4096], **llama)),
        ("flash_decode", "llama2-7b long decode fp32 (1 x 4096)", "float32",
         dict(b=1, s=4096, starts=[0], lengths=[4096], **llama)),
        ("paged_flash_decode", "llama2-7b long paged decode (1 x 4096)",
         "bfloat16", dict(b=1, bs=16, max_blocks=256, starts=[0],
                          lengths=[4096], **llama)),
        ("flash_decode", "qwen2-0.5b GQA decode fp32", "float32",
         dict(b=4, s=544, starts=starts4, lengths=lengths4, **qwen)),
        ("paged_flash_decode", "qwen2-0.5b GQA paged decode fp32",
         "float32", dict(b=4, bs=16, max_blocks=34, starts=starts4,
                         lengths=lengths4, **qwen)),
        ("flash_decode", "GQA hd 128, 8 heads a kv head (two head groups)",
         "bfloat16", dict(b=4, s=544, starts=starts4, lengths=lengths4,
                          h=32, kvh=4, hd=128)),
        ("flash_decode", "llama2-7b decode, an empty window", "bfloat16",
         dict(b=4, s=544, starts=empty4, lengths=lengths4, **llama)),
        ("paged_flash_decode", "llama2-7b paged decode fp32, an empty window",
         "float32", dict(b=4, bs=16, max_blocks=34, starts=empty4,
                         lengths=lengths4, **llama)),
    ]


def make_inputs(torch, kernel, dt, sh, gen):
    """One set of inputs (a tuple of the kernel's arguments; with a vision
    ``prefix`` in ``sh``, the prefill's ``causal`` and ``prefix`` and the
    decode's ``prefix`` follow the tensors)."""
    dev = "cuda"
    b, h, kvh, hd = sh["b"], sh["h"], sh["kvh"], sh["hd"]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def idx(vals):
        return torch.tensor(vals, dtype=torch.int32, device=dev)

    extra = (sh["prefix"],) if "prefix" in sh else ()
    if kernel == "flash_attention" and not sh.get("causal", True):
        sk = sh["sk"]            # no pad: the encoder's or cross attention
        return (rnd(b, sh["s"], h, hd), rnd(b, sk, kvh, hd),
                rnd(b, sk, kvh, hd), None, False)
    if kernel == "flash_attention":
        s = sh["s"]
        return (rnd(b, s, h, hd), rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
                idx(sh["starts"])) + ((True,) + extra if extra else ())
    q = rnd(b, h, hd)
    if kernel == "flash_decode":
        s = sh["s"]
        return (q, rnd(b, s, kvh, hd), rnd(b, s, kvh, hd),
                idx(sh["lengths"]), idx(sh["starts"])) + extra
    n_blocks = 1 + b * sh["max_blocks"]
    perm = torch.randperm(n_blocks - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, sh["max_blocks"]).to(torch.int32)
    return (q, rnd(n_blocks, sh["bs"], kvh, hd),
            rnd(n_blocks, sh["bs"], kvh, hd), tables, idx(sh["lengths"]),
            idx(sh["starts"]))


def work(kernel, dtype, sh):
    """(FLOPs, bytes) this call's data needs: 4*hd operations per visible
    (query, key) pair (QK^T and PV), each needed input row read once, each
    output written once."""
    e = 2 if dtype == "bfloat16" else 4
    h, kvh, hd = sh["h"], sh["kvh"], sh["hd"]
    pre = sh.get("prefix", 0)     # valid keys [0, pre) and [pre + start, ..)
    if kernel == "flash_attention" and not sh.get("causal", True):
        b, s, sk = sh["b"], sh["s"], sh["sk"]    # every query sees every key
        nbytes = b * (2 * s * h + 2 * sk * kvh) * hd * e   # q, out, k, v
        return 4 * hd * h * b * s * sk, nbytes
    if kernel == "flash_attention":
        s = sh["s"]
        valid = [s - pre - st for st in sh["starts"]]
        # a valid query sees the valid keys at or before it
        pairs = sum(pre * (pre + 1) // 2 + n * pre + n * (n + 1) // 2
                    for n in valid)
        nbytes = sum(pre + n for n in valid) * (h + 2 * kvh) * hd * e
        nbytes += sh["b"] * s * h * hd * e + 4 * sh["b"]    # out, starts
        return 4 * hd * h * pairs, nbytes
    window = [min(pre, ln) + max(0, ln - pre - st)
              for st, ln in zip(sh["starts"], sh["lengths"])]
    nbytes = 2 * sh["b"] * h * hd * e + 8 * sh["b"]         # q, out, idx
    nbytes += sum(window) * 2 * kvh * hd * e                # k, v rows
    if kernel == "paged_flash_decode":
        bs = sh["bs"]
        pages = sum((ln - 1) // bs - st // bs + 1
                    for st, ln in zip(sh["starts"], sh["lengths"]) if ln > st)
        nbytes += 4 * pages                                 # table entries
    return 4 * hd * h * sum(window), nbytes


def library_call(torch, kernel, args, h, kvh):
    """One PyTorch call computing the same function (the yardstick), or
    None.  Masks and views are built here, outside the timed call."""
    import torch.nn.functional as F
    if kernel == "paged_flash_decode":
        return None
    gqa = {}
    if h != kvh:
        major, minor = (int(x) for x in torch.__version__.split(".")[:2])
        if (major, minor) < (2, 5):
            return None
        gqa = {"enable_gqa": True}
    pre = args[-1] if isinstance(args[-1], int) and \
        not isinstance(args[-1], bool) else 0
    if kernel == "flash_attention" and args[3] is None:     # non-causal
        qt, kt, vt = (a.transpose(1, 2) for a in args[:3])
        return lambda: F.scaled_dot_product_attention(qt, kt, vt, **gqa)
    if kernel == "flash_attention":
        q, k, v, starts = args[:4]
        s = q.shape[1]
        pos = torch.arange(s, device=q.device)
        key_ok = (pos[None, :] >= starts.long()[:, None] + pre) | \
            (pos[None, :] < pre)
        mask = (pos[None, :, None] >= pos[None, None, :]) & \
            key_ok[:, None, :]
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        mask = mask[:, None]
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      attn_mask=mask, **gqa)
    q, k, v, lengths, starts = args[:5]
    pos = torch.arange(k.shape[1], device=q.device)
    mask = ((pos[None, :] >= starts.long()[:, None] + pre) |
            (pos[None, :] < pre)) & (pos[None, :] < lengths.long()[:, None])
    qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    mask = mask[:, None, None]
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask, **gqa)


def instance(kernel: str, dtype: str) -> str:
    """The kernels line's name of a kernel's instantiation: the prefill
    attention in fp32 runs as three-pass TF32 (``flash_attention_fp32``),
    in bf16 through ``wgmma`` (``flash_attention``); the dequant matmul
    with bf16 x runs on the tensor cores (``dequant_matmul_bf16``), with
    fp32 x on the CUDA cores (``dequant_matmul``); the SSM scan in bf16 is
    ``ssm_scan_bf16``, in fp32 (three-pass TF32) ``ssm_scan``; the wide
    scan (P, N) = (1025, 1024), three-pass TF32 in fp32 and two-pass in
    bf16, ``ssm_scan_wide`` and ``ssm_scan_wide_bf16``."""
    if kernel == "flash_attention" and dtype == "float32":
        return "flash_attention_fp32"
    if kernel in ("dequant_matmul", "ssm_scan", "ssm_scan_wide") and \
            dtype == "bfloat16":
        return kernel + "_bf16"
    return kernel


def phase_kernels(torch, cases=None):
    """Each attention kernel against its plain version over ``cases``
    (default: ``kernel_cases``); returns the first case's row of each
    instantiation (``instance``)."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ref
    wrappers = {"flash_attention": K.flash_attention,
                "flash_decode": K.flash_decode,
                "paged_flash_decode": K.paged_flash_decode}
    plains = {"flash_attention": ref.flash_attention_ref,
              "flash_decode": ref.flash_decode_ref,
              "paged_flash_decode": ref.paged_flash_decode_ref}
    gen = torch.Generator(device="cuda").manual_seed(1234)
    results = {}
    for kernel, case, dtype, sh in cases or kernel_cases(torch):
        dt = getattr(torch, dtype)
        args = make_inputs(torch, kernel, dt, sh, gen)
        split0 = getattr(wrappers[kernel], "launches_split", 0)
        got = wrappers[kernel](*args)
        split = getattr(wrappers[kernel], "launches_split", 0) > split0
        want = plains[kernel](*args)
        torch.cuda.synchronize()
        extra = {}
        pre = sh.get("prefix", 0)
        if kernel == "flash_attention" and args[3] is None:
            pass                              # no pad: every row is valid
        elif kernel == "flash_attention":     # pad rows: finite, else free
            pos = torch.arange(sh["s"], device="cuda")[None, :]
            keep = (pos >= args[3].long()[:, None] + pre) | (pos < pre)
            pad_finite = bool(torch.isfinite(got[~keep].float()).all())
            if not pad_finite:
                raise RuntimeError(f"{kernel} ({case}): non-finite pad row")
            got, want = got[keep], want[keep]
            extra["pad_rows_finite"] = pad_finite
        else:                                 # empty windows come out as 0
            keep = torch.tensor([ln > st or pre > 0 for st, ln in
                                 zip(sh["starts"], sh["lengths"])],
                                device="cuda")
            if not bool((got[~keep] == 0).all()):
                raise RuntimeError(f"{kernel} ({case}): an empty window's "
                                   "row is not 0")
            got, want = got[keep], want[keep]
            extra.update(split=split, empty_windows=int((~keep).sum()))
        got, want = got.float(), want.float()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{kernel} ({case}): non-finite output")
        err = (got - want).abs()
        tol = TOL[dtype]
        max_err = float(err.max())
        if bool((err > tol + tol * want.abs()).any()):
            raise RuntimeError(f"{kernel} ({case}): max |err| {max_err} "
                               f"over tolerance {tol}")
        nbytes = sum(a.numel() * a.element_size() for a in args
                     if isinstance(a, torch.Tensor))
        sets = [args] + [make_inputs(torch, kernel, dt, sh, gen)
                         for _ in range(copies(nbytes) - 1)]
        ms = time_ms(torch, wrappers[kernel], sets)
        # the plain version's several launches a call: fewer rounds
        plain_ms = time_ms(torch, plains[kernel], sets, reps=3, launches=10)
        lib = [library_call(torch, kernel, a, sh["h"], sh["kvh"])
               for a in sets]
        library_ms = None if lib[0] is None else time_ms(
            torch, lambda f: f(), [(f,) for f in lib])
        flops, wbytes = work(kernel, dtype, sh)
        bound_ms, bound_by = bound(flops, wbytes, dtype)
        if instance(kernel, dtype) == "flash_attention_fp32":
            # three TF32 passes; the CUDA cores' fp32 bound beside it
            extra["bound_cuda_cores_ms"] = bound_ms
            bound_ms, bound_by = bound(3 * flops, wbytes, "tf32")
            extra["products"] = "3xTF32 mma.sync"
        row = dict(kernel=instance(kernel, dtype), case=case, dtype=dtype,
                   shapes=sh, max_abs_err=max_err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=wbytes, share_of_bound=bound_ms / ms, **extra)
        emit("kernel", **row)
        results.setdefault(row["kernel"], row)   # the first case is the main one
        del sets, lib, args
        torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phases 3, 4

def serve_both(torch, cfg, params, prompts, max_new, dtype, device,
               slots, prefill_bucket, max_blocks=None, mesh=None,
               step_ms=None):
    """Greedy tokens from both engines (on ``mesh`` when given), with
    host-clock timings; ``step_ms``, a list, takes each of
    ``ServeEngine``'s decode steps' host ms, each step synchronised
    (``StepTimer``)."""
    from repro_torch.serve.engine import ContinuousServeEngine, ServeEngine
    from repro_torch.serve.scheduler import ServeRequest
    ceng = ContinuousServeEngine(cfg, params, slots=slots, block_size=16,
                                 prefill_bucket=prefill_bucket,
                                 max_blocks_per_slot=max_blocks,
                                 compute_dtype=dtype, device=device,
                                 mesh=mesh)
    reqs = [ServeRequest(prompt=list(map(int, p)), max_new_tokens=max_new)
            for p in prompts]
    t0 = time.perf_counter()
    ceng.run(reqs)
    if device == "cuda":
        torch.cuda.synchronize()
    t_cont = time.perf_counter() - t0
    cont = [r.out_tokens for r in reqs]
    batch = min(slots, len(prompts))
    max_len = max(len(p) for p in prompts) + max_new
    eng = ServeEngine(cfg, params, max_len=max_len, batch=batch,
                      compute_dtype=dtype, device=device, mesh=mesh)
    if step_ms is not None:
        eng.model = StepTimer(torch, eng.model, step_ms)
    t0 = time.perf_counter()
    fixed = []
    for i in range(0, len(prompts), batch):
        fixed += eng.generate(prompts[i:i + batch], max_new_tokens=max_new)
    t_fixed = time.perf_counter() - t0
    return ceng, cont, fixed, t_cont, t_fixed


class StepTimer:
    """A family module whose ``decode_step`` ends in a synchronise and
    appends its host ms to ``ms`` (``ServeEngine`` synchronises only at
    the end of a call)."""

    def __init__(self, torch, model, ms: list):
        self.torch, self.model, self.ms = torch, model, ms

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *a, **kw):
        t0 = time.perf_counter()
        out = self.model.decode_step(*a, **kw)
        self.torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        return out


def phase_card_vs_cpu(torch):
    """Same fp32 weights on CPU (plain versions) and card (kernels): the
    fp32 prefill (three-pass TF32) and both decodes must give the CPU's
    greedy tokens; the fp32 prefill's launches over the card's serving run
    must be non-zero."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2)
    params = host_params(torch, cfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, n) for n in (64, 37, 20)]
    out = {}
    for dev in ("cpu", "cuda"):
        K.reset_launches()                 # count the card's run only
        _, cont, fixed, _, _ = serve_both(torch, cfg, params, prompts, 8,
                                          torch.float32, dev, slots=2,
                                          prefill_bucket=64)
        out[dev] = (cont, fixed)
    fp32_launches = (K.flash_attention.launches
                     - K.flash_attention.launches_tc)
    # logits of one prefill and one decode step on both devices
    toks = torch.from_numpy(np.stack([np.pad(p, (64 - len(p), 0))
                                      for p in prompts])).long()
    pad = torch.tensor([64 - len(p) for p in prompts], dtype=torch.int32)
    gaps = []
    logits = {}
    for dev in ("cpu", "cuda"):
        p_dev = tree_map(lambda t: t.to(dev), params)
        cache = T.init_cache(cfg, 3, 72, dtype=torch.float32, device=dev)
        lg, cache = T.prefill(cfg, p_dev, {"tokens": toks.to(dev),
                                           "pad": pad.to(dev)}, cache,
                              torch.float32)
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        lg2, _ = T.decode_step(cfg, p_dev, cache, nxt, torch.float32)
        logits[dev] = (lg.cpu(), lg2.cpu())
    for a, b in zip(logits["cpu"], logits["cuda"]):
        gaps.append(float((a - b).abs().max()))
    same = out["cpu"] == out["cuda"]
    emit("card_vs_cpu", n_layers=cfg.n_layers, d_model=cfg.d_model,
         prompts=[len(p) for p in prompts], new_tokens=8,
         tokens_equal=same, max_logit_gap=max(gaps),
         cpu_continuous=out["cpu"][0], cuda_continuous=out["cuda"][0],
         flash_attention_fp32_launches=fp32_launches)
    if not same:
        raise RuntimeError(f"card and CPU greedy tokens differ: {out}")
    if out["cuda"][0] != out["cuda"][1]:
        raise RuntimeError("continuous and fixed-batch tokens differ at fp32")
    if fp32_launches == 0:
        raise RuntimeError("the fp32 serving run never launched the fp32 "
                           "prefill kernel")


def attention_launches(K, dtype: str) -> dict:
    """The attention kernels' counts by instantiation (``instance``)."""
    tc = K.flash_attention.launches_tc
    return {instance("flash_attention", dtype):
            tc if dtype == "bfloat16" else K.flash_attention.launches - tc,
            "flash_decode": K.flash_decode.launches,
            "paged_flash_decode": K.paged_flash_decode.launches}


def full_prompts(cfg) -> list:
    """``phase_full``'s 8 prompts of 32-512 tokens, from seed 0."""
    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(32, 513, 8)]
    return [rng.integers(0, cfg.vocab, n) for n in plens]


def phase_full(torch, dtype: str = "bfloat16", max_new: int = 32,
               n_layers=None, keep=None):
    """llama2-7b at full width, both engines, in ``dtype``: bf16
    (``full_size``, full depth), or fp32 (``full_size_fp32``), the
    launcher's default, whose prefill runs ``flash_attention_fp32``, at
    ``n_layers`` (None: full depth).  Returns the attention kernels'
    launches over the run by instantiation (``instance``); ``keep``, a
    dict, takes the config, the tree and the prompts for a later phase
    (``phase_serve_mesh``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models import transformer as T
    cfg = get_config("llama2-7b")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dt = getattr(torch, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=dt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = full_prompts(cfg)
    plens = [len(p) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                   # count the main path's run only
    ceng, cont, fixed, t_cont, t_fixed = serve_both(
        torch, cfg, params, prompts, max_new, dt, "cuda", slots=4,
        prefill_bucket=32, max_blocks=-(-(512 + max_new) // 16))
    prefill = instance("flash_attention", dtype)
    launches = attention_launches(K, dtype)
    split = {fn.__name__: fn.launches_split for fn in K.KERNELS[1:]}
    if launches[prefill] != K.flash_attention.launches:
        raise RuntimeError(f"{dtype} serving ran the other prefill kernel "
                           f"{K.flash_attention.launches - launches[prefill]}"
                           " times")
    peak = torch.cuda.max_memory_allocated()
    for toks in cont + fixed:
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_padded
                                           for t in toks):
            raise RuntimeError(f"bad generation {toks}")
    n_tok = len(prompts) * max_new
    agree = sum(a == b for a, b in zip(cont, fixed))
    prefix = [next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                   len(a)) for a, b in zip(cont, fixed)]
    emit("full_size" if dtype == "bfloat16" else "full_size_fp32",
         arch=cfg.name, n_layers=cfg.n_layers, dtype=dtype,
         depth="full" if n_layers is None else n_layers,
         init_s=init_s, prompt_lens=plens, new_tokens=max_new,
         continuous=dict(slots=4, block_size=16, wall_s=t_cont,
                         tokens_per_s=n_tok / t_cont, steps=ceng.steps,
                         prefill_ms=[1e3 * s for s in ceng.prefill_seconds],
                         decode_step_ms_median=1e3 * statistics.median(
                             ceng.decode_seconds),
                         refills=ceng.scheduler.stats.n_refills),
         fixed_batch=dict(batch=4, wall_s=t_fixed,
                          tokens_per_s=n_tok / t_fixed),
         peak_memory_bytes=peak, peak_memory_gib=peak / 2**30,
         launches=launches, decode_launches_split=split,
         engines_agree=f"{agree}/{len(prompts)} requests",
         agreeing_prefix_tokens=prefix)
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: "
                           f"{missing}")
    phase_profile(torch, cfg, params, prompts[:4], dt)
    if keep is not None:
        keep.update(cfg=cfg, params=params, prompts=prompts)
    del ceng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def profile_summary(prof, host_ms: float, calls: int = 1, top: int = 8,
                    **named):
    """The device side of a ``torch.profiler`` run, per call: busy ms (the
    sum of kernel times), idle share against ``host_ms`` (the host clock
    per call), the top kernels, and for each ``key=substring`` in ``named``
    the ms of the kernels whose name holds the substring.  Read from the
    profiler's raw device events, summed by name here: ``key_averages``
    builds a Python event a kernel first, a minute for the ~300,000 of an
    xlstm training step."""
    from torch.autograd import DeviceType
    by_name = {}                        # name -> [device ns, calls]
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0, 0])
            acc[0] += e.duration_ns()
            acc[1] += 1
    busy_ms = sum(ns for ns, _ in by_name.values()) / 1e6 / calls
    out = dict(host_ms=host_ms, device_busy_ms=busy_ms,
               device_idle_share=1 - busy_ms / host_ms)
    for key, sub in named.items():
        out[key] = sum(ns for name, (ns, _) in by_name.items()
                       if sub in name) / 1e6 / calls
    ranked = sorted(by_name.items(), key=lambda t: -t[1][0])[:top]
    out["top_kernels"] = [dict(name=name[:80], ms=ns / 1e6 / calls,
                               calls=n / calls) for name, (ns, n) in ranked]
    return out


def phase_profile(torch, cfg, params, prompts, dt, steps: int = 8):
    """Where a prefill's and a decode step's time go: ``torch.profiler``
    over one prefill of llama2-7b (batch 4, in ``dt``, after a warm-up
    prefill), with the prefill attention's share, then over ``steps``
    contiguous decode steps, with the decode attention's.  Reports the
    device's busy time (sum of kernel times) per call, the host clock per
    call under the profiler, and the kernels that take the most device
    time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer as T
    plen = max(len(p) for p in prompts)
    toks = torch.tensor(np.stack([np.pad(p, (plen - len(p), 0))
                                  for p in prompts]), device="cuda")
    pad = torch.tensor([plen - len(p) for p in prompts], dtype=torch.int32,
                       device="cuda")
    def prefill():
        cache = T.init_cache(cfg, len(prompts), plen + 2 * steps,
                             dtype=dt, device="cuda")
        return T.prefill(cfg, params, {"tokens": toks, "pad": pad}, cache,
                         dt)

    prefill()                                           # warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    dtype = str(dt).replace("torch.", "")
    emit("prefill_profile", arch=cfg.name, dtype=dtype, batch=len(prompts),
         prompt=plen,
         **profile_summary(prof, host_ms, attention_ms="flash_attention"))
    tok = logits[:, -1].argmax(-1, keepdim=True)
    for _ in range(2):                                  # warm up
        logits, cache = T.decode_step(cfg, params, cache, tok, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = T.decode_step(cfg, params, cache, tok, dt)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    emit("decode_profile", dtype=dtype, steps=steps, batch=len(prompts),
         **profile_summary(prof, 1e3 * host_s / steps, steps,
                           attention_ms="flash_decode"))


# ------------------------------------------------------------ phase 5

UPDATE_HYPER = {   # c1, c2 of AdamW's third step
    "fused_adamw": dict(lr=1e-4, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.01, c1=1.0 - 0.9 ** 3,
                        c2=1.0 - 0.999 ** 3),
    "fused_sgdm": dict(lr=1e-4, momentum=0.9, weight_decay=0.01),
    "fused_adagrad": dict(lr=1e-4, eps=1e-10, weight_decay=0.01),
}
N_MOMENTS = {"fused_adamw": 2, "fused_sgdm": 1, "fused_adagrad": 1}
# fp32 operations per element, for the (never binding) operations bound
UPDATE_FLOPS = {"fused_adamw": 16, "fused_sgdm": 6, "fused_adagrad": 8}


def group_shapes(cfg, group: str):
    """Leaf shapes of one HiFT group of a dense config (m=1)."""
    d, f = cfg.d_model, cfg.d_ff
    q, kv = cfg.n_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    if group == "layer":
        return [(1, d), (1, d, q), (1, d, kv), (1, d, kv), (1, q, d),
                (1, d), (1, d, f), (1, d, f), (1, f, d)]
    return [(cfg.vocab_padded, d)]


def update_cases(torch):
    f32, bf16 = torch.float32, torch.bfloat16
    return [("layer", "llama2-7b layer group fp32", (f32, f32, f32)),
            ("embed", "llama2-7b embed group fp32", (f32, f32, f32)),
            ("layer", "llama2-7b layer group mixed_hi (f32 master, bf16 "
             "grads)", (f32, bf16, f32)),
            ("layer", "llama2-7b layer group bf16 moments", (f32, f32, bf16))]


def update_inputs(torch, kernel, shapes, dts, gen):
    """(params, grads, moments...) lists on the card; second moments and
    AdaGrad's accumulator are non-negative."""
    def rnd(s, dt, scale=1.0, pos=False):
        x = torch.randn(s, generator=gen, device="cuda") * scale
        return (x.abs() if pos else x).to(dt)
    pdt, gdt, mdt = dts
    p = [rnd(s, pdt) for s in shapes]
    g = [rnd(s, gdt, 1e-2) for s in shapes]
    if kernel == "fused_adamw":
        ms = [[rnd(s, mdt, 1e-2) for s in shapes],
              [rnd(s, mdt, 1e-4, pos=True) for s in shapes]]
    else:
        ms = [[rnd(s, mdt, 1e-2, pos=kernel == "fused_adagrad")
               for s in shapes]]
    return (p, g, *ms)


def ulp_distance(torch, a, b) -> int:
    """Largest distance in units in the last place between two tensors of
    one dtype (their bit patterns as integers; the values here share a
    sign or are exactly equal)."""
    view = torch.int32 if a.dtype == torch.float32 else torch.int16
    return int((a.view(view).long() - b.view(view).long()).abs().max())


def library_update(torch, kernel, args, hyper, dts):
    """One PyTorch call computing the same update at weight_decay=0 (the
    yardstick), and None or the reason there is none."""
    f32 = torch.float32
    if dts != (f32, f32, f32):
        return None, "no single PyTorch call takes mixed-dtype leaves"
    p, g, *ms = args
    steps = [torch.full((), 3.0, device="cuda") for _ in p]
    if kernel == "fused_adamw":
        fn = getattr(torch, "_fused_adamw_", None)
        call = lambda: fn(p, g, ms[0], ms[1], [], steps, lr=hyper["lr"],
                          beta1=hyper["b1"], beta2=hyper["b2"],
                          weight_decay=0.0, eps=hyper["eps"], amsgrad=False,
                          maximize=False)
    elif kernel == "fused_sgdm":
        fn = getattr(torch, "_fused_sgd_", None)
        call = lambda: fn(p, g, ms[0], weight_decay=0.0,
                          momentum=hyper["momentum"], lr=hyper["lr"],
                          dampening=0.0, nesterov=False, maximize=False,
                          is_first_step=False)
    else:
        fn = getattr(torch, "_fused_adagrad_", None)
        call = lambda: fn(p, g, ms[0], steps, lr=hyper["lr"], lr_decay=0.0,
                          weight_decay=0.0, eps=hyper["eps"], maximize=False)
    if fn is None:
        return None, f"torch {torch.__version__} has no such call"
    try:
        call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:   # yardstick only
        return None, f"{fn.__name__} refuses CUDA tensors: {str(e)[:120]}"
    return call, None


def phase_update_kernels(torch):
    """Each fused update kernel against its plain version on the card,
    timed with its inputs rotated beyond L2, beside its byte bound and the
    library yardstick."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import fused_update as FU
    from repro_torch.kernels import ref
    wrappers = {"fused_adamw": FU.fused_adamw_update,
                "fused_sgdm": FU.fused_sgdm_update,
                "fused_adagrad": FU.fused_adagrad_update}
    plains = {"fused_adamw": ref.fused_adamw_ref,
              "fused_sgdm": ref.fused_sgdm_ref,
              "fused_adagrad": ref.fused_adagrad_ref}
    cfg = get_config("llama2-7b")
    gen = torch.Generator(device="cuda").manual_seed(4321)
    results = {}
    for kernel in wrappers:
        hyper = UPDATE_HYPER[kernel]
        wrap = functools.partial(wrappers[kernel], **hyper)

        def plain(*args, kernel=kernel, hyper=hyper):
            return [plains[kernel](*leaf, **hyper) for leaf in zip(*args)]

        for group, case, dts in update_cases(torch):
            shapes = group_shapes(cfg, group)
            args = update_inputs(torch, kernel, shapes, dts, gen)
            want = plain(*args)
            mine = [[t.clone() for t in stream] for stream in args]
            got = wrap(*mine)
            torch.cuda.synchronize()
            max_err, max_ulps = 0.0, 0
            for j, stream in enumerate(got):
                for i, t in enumerate(stream):
                    w = want[i][j]
                    if not torch.isfinite(t.float()).all():
                        raise RuntimeError(f"{kernel} ({case}): non-finite")
                    max_err = max(max_err, float((t.float() - w.float())
                                                 .abs().max()))
                    max_ulps = max(max_ulps, ulp_distance(torch, t, w))
            if max_ulps > UPDATE_ULP_TOL:
                raise RuntimeError(f"{kernel} ({case}): {max_ulps} ulps from "
                                   f"its plain version (bound "
                                   f"{UPDATE_ULP_TOL})")
            del want, mine, got
            n = sum(math.prod(s) for s in shapes)
            size = {torch.float32: 4, torch.bfloat16: 2}
            per = (2 * size[dts[0]] + size[dts[1]]
                   + 2 * N_MOMENTS[kernel] * size[dts[2]])
            nbytes = n * per
            sets = [args] + [update_inputs(torch, kernel, shapes, dts, gen)
                             for _ in range(copies(nbytes) - 1)]
            ms = time_ms(torch, wrap, sets, reps=5, launches=10)
            plain_ms = time_ms(torch, plain, sets, reps=3, launches=4)
            lib = [library_update(torch, kernel, a, hyper, dts) for a in sets]
            library_ms = None if lib[0][0] is None else time_ms(
                torch, lambda f: f(), [(f,) for f, _ in lib], reps=5,
                launches=10)
            bound_ms, bound_by = bound(UPDATE_FLOPS[kernel] * n, nbytes,
                                       "float32")
            row = dict(kernel=kernel, case=case,
                       dtypes=[str(d).split(".")[-1] for d in dts],
                       leaves=len(shapes), elements=n, max_abs_err=max_err,
                       max_ulps=max_ulps, ulp_tol=UPDATE_ULP_TOL, ms=ms,
                       plain_ms=plain_ms, library_ms=library_ms,
                       library_note=lib[0][1], bound_ms=bound_ms,
                       bound_by=bound_by, bytes=nbytes,
                       share_of_bound=bound_ms / ms)
            emit("kernel", **row)
            results.setdefault(kernel, row)   # the first case is the main one
            del sets, lib, args
            gc.collect()
            torch.cuda.empty_cache()
    return results


# ------------------------------------------------------------ phases 6-8

def train_batches(cfg, seq, batch, n, device):
    from repro_torch.data.synthetic import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                  global_batch=batch, seed=0), device=device)
    return [data.batch_at(s) for s in range(n)]


class UpdateTimer:
    """While in use: CUDA events around each launch of a kernel module's
    ``_launch`` (by default the fused update kernels', ``fused_update``;
    ``kernels.dequant_matmul`` for the dequant kernel), and the module's
    launch counts from 0."""

    def __init__(self, torch, module=None):
        if module is None:
            from repro_torch.kernels import fused_update as module
        self.torch, self.fu, self.events = torch, module, []

    def __enter__(self):
        launch, cuda = self.fu._launch, self.torch.cuda
        self._launch = launch

        def timed_launch(*args):
            e0 = cuda.Event(enable_timing=True)
            e1 = cuda.Event(enable_timing=True)
            e0.record()
            n = launch(*args)
            e1.record()
            self.events.append((e0, e1))
            return n

        self.fu._launch = timed_launch
        self.fu.reset_launches()
        return self

    def __exit__(self, *exc):
        self.fu._launch = self._launch

    def take(self) -> tuple[float, int]:
        """(device ms, launches) of the kernels since the last take."""
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        n = len(self.events)
        self.events.clear()
        return ms, n

    def launches(self) -> dict:
        return {fn.__name__.replace("_update", ""): fn.launches
                for fn in self.fu.KERNELS}


def measured_step(torch, runner, batch, timer: UpdateTimer) -> dict:
    """One training step: host clock to a synchronise, peak memory (reset
    before the step) and the fused updates' device time and launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer.take()
    t0 = time.perf_counter()
    loss = float(runner.train_step(batch))
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    update_ms, launches = timer.take()
    label = runner.last_metrics.get("group", "all")     # FPFT: every param
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss at {label}: {loss}")
    peak = torch.cuda.max_memory_allocated()
    kind = "all" if label == "all" else _group_kind(label)
    return dict(group=label, kind=kind, loss=loss,
                host_ms=host_ms, peak_memory_bytes=peak,
                peak_memory_gib=peak / 2**30, update_kernel_ms=update_ms,
                update_launches=launches)


def fresh_params(torch, cfg, seed: int = 0, dtype=None):
    """The port's random init of ``cfg`` on the card from ``seed``, after
    freeing what earlier phases left."""
    from repro_torch.models import transformer as T
    gc.collect()
    torch.cuda.empty_cache()
    return T.init(cfg, torch.Generator(device="cuda").manual_seed(seed),
                  device="cuda", dtype=dtype or torch.float32)


def host_params(torch, cfg, on_card: bool = True, seed: int = 0):
    """The family's random fp32 init of ``cfg`` from ``seed`` for a phase
    that runs it on the CPU and on the card: drawn on the card and copied
    to the host (a CPU draw of a 2-layer model at full width takes from
    seconds to half a minute), or drawn on the CPU where ``on_card`` is
    False (a phase rehearsed on the CPU alone)."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.models import get_family
    dev = "cuda" if on_card else "cpu"
    params = get_family(cfg).init(
        cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
        dtype=torch.float32)
    if not on_card:
        return params
    out = tree_map(lambda t: t.cpu(), params)
    del params
    torch.cuda.empty_cache()
    return out


# Layers of the dense and quantized card-against-CPU training: their CPU
# halves, with the fused, hybrid and moe ones, set much of the whole
# script's time, and one layer is a group of its own between embed and
# head
CARD_VS_CPU_LAYERS = 1


def train_card_vs_cpu_side(torch, cfg, params, dev: str) -> dict:
    """One device's side of ``phase_train_card_vs_cpu``: a HiFT step with
    AdamW (m = 1) for each group (embed, each layer, head) from
    ``params``; the losses, the final params (on the CPU), the seconds and
    the groups."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.core import LRSchedule, make_runner
    from repro_torch.kernels import fused_update as FU
    steps = cfg.n_layers + 2
    batches = train_batches(cfg, 64, 1, steps, "cpu")
    runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                         schedule=LRSchedule(base_lr=1e-4), device=dev)
    before = FU.fused_adamw_update.launches
    t0 = time.perf_counter()
    losses = [float(runner.train_step(b)) for b in batches]
    secs = time.perf_counter() - t0
    if dev == "cuda" and FU.fused_adamw_update.launches - before != steps:
        raise RuntimeError("the card's HiFT steps did not run the fused "
                           "AdamW kernel once each")
    return dict(losses=losses, seconds=secs,
                groups=[g.label() for g in runner.groups],
                final={k: t.detach().cpu() for k, t in
                       flatten_with_paths(runner.params).items()})


def train_card_vs_cpu_cpu(torch, arch: str):
    """The CPU half of ``phase_train_card_vs_cpu`` (``CpuHalves`` runs it
    beside the card's phases): ``CARD_VS_CPU_LAYERS`` of ``arch``'s width,
    the fp32 params of seed 0 drawn on the CPU, and the CPU's side."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=CARD_VS_CPU_LAYERS)
    params = host_params(torch, cfg, on_card=False)
    return params, train_card_vs_cpu_side(torch, cfg, params, "cpu")


def phase_train_card_vs_cpu(torch, arch: str = "llama2-7b", cpu=None):
    """3 HiFT steps with AdamW (embed, layer 0, head) of a 1-layer model
    (``CARD_VS_CPU_LAYERS``) at ``arch``'s width, fp32, batch 1 x 64, from
    the same params on the CPU (plain versions) and the card (fused
    kernel); ``cpu`` is the CPU half (``train_card_vs_cpu_cpu``), run here
    when None.  Losses within rtol 1e-4: the same fp32 arithmetic summed
    in other orders by cuBLAS and the CPU's BLAS, where AdamW's first step
    moves every element by about lr times the sign of its gradient, so
    near-zero gradients may flip."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config(arch), n_layers=CARD_VS_CPU_LAYERS)
    params, host = cpu or train_card_vs_cpu_cpu(torch, arch)
    sides = {"cpu": host,
             "cuda": train_card_vs_cpu_side(torch, cfg, params, "cuda")}
    for dev, side in sides.items():
        emit("train_card_vs_cpu_run", arch=cfg.name, device=dev,
             seconds=side["seconds"])
    out = {dev: side["losses"] for dev, side in sides.items()}
    final = {dev: side["final"] for dev, side in sides.items()}
    gap = max(float((final["cpu"][k] - final["cuda"][k]).abs().max())
              for k in final["cpu"])
    rel = max(abs(a - b) / abs(a) for a, b in zip(out["cpu"], out["cuda"]))
    emit("train_card_vs_cpu", arch=cfg.name, n_layers=cfg.n_layers,
         d_model=cfg.d_model,
         batch=1, seq=64, groups=sides["cuda"]["groups"],
         cpu_losses=out["cpu"], cuda_losses=out["cuda"],
         max_rel_loss_gap=rel, rtol=1e-4, max_param_gap=gap)
    if not all(math.isfinite(x) for x in out["cuda"]) or rel > 1e-4:
        raise RuntimeError(f"card and CPU training losses differ: {out}")
    del final, params, sides
    gc.collect()


def _group_kind(label: str) -> str:
    return "embed" if "embed" in label else (
        "head" if "head" in label else "layer")


def phase_train_full(torch):
    """llama2-7b at full depth and width, fp32, HiFT m=1, batch 4 x 512:
    AdamW 2 steps bottom2up (embed, layer 0) and 1 top2down (head) from
    fresh runners, then SGD-momentum and AdaGrad 1 step each top2down
    (9 steps in all took 16.5 s of the whole script's 760.0 on an H100).
    The runners train the same resident params in place.  Per step: host
    clock (to a synchronise), peak memory (reset per step) and the update
    kernel's device time (CUDA events around its launches).
    The update kernels' launches are counted over this run; then one more
    AdamW layer-group step runs under ``torch.profiler``."""
    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    from repro_torch.models import transformer as T
    cfg = get_config("llama2-7b")
    t0 = time.perf_counter()
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plan = [("adamw", "bottom2up", 2), ("adamw", "top2down", 1),
            ("sgdm", "top2down", 1), ("adagrad", "top2down", 1)]
    batches = train_batches(cfg, 512, 4, sum(n for *_, n in plan) + 1,
                            "cuda")
    steps = []
    with UpdateTimer(torch) as timer:   # counts the main path's run only
        for opt, order, n in plan:
            runner = make_runner(cfg, "hift", params=params, optimizer=opt,
                                 hift=HiFTConfig(m=1, strategy=order),
                                 schedule=LRSchedule(base_lr=1e-5),
                                 device="cuda")
            for _ in range(n):
                steps.append(dict(optimizer=opt, order=order, **measured_step(
                    torch, runner, batches[len(steps)], timer)))
                emit("train_step", arch=cfg.name, **steps[-1])
            del runner
        launches = timer.launches()
    emit("train_full_size", arch=cfg.name, n_layers=cfg.n_layers,
         dtype="float32", batch=4, seq=512, remat=cfg.remat, init_s=init_s,
         launches=launches, params_bytes=tree_bytes(params))
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise RuntimeError(f"update kernels never launched on the training "
                           f"path: {missing}")
    phase_train_profile(torch, cfg, params, batches[-1])
    full = steps[:2]
    emit("train_full_size_vs_model", policy="fp32",
         peak_memory_gib=max(s["peak_memory_bytes"] for s in full) / 2**30,
         analytic_pgs_gib=analytic(cfg).pgs_gb)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_mixed_hi(torch):
    """The paper's adapted mixed precision at full size: llama2-7b with
    bf16 resident params and an fp32 master for the active group only
    (``mixed_hi``), HiFT m=1 with AdamW, batch 4 x 512 — the embed and
    layer-0 steps (the two deepest backwards), with host time and peak
    memory per step beside the analytic model's figure.  The update
    kernel runs f32 masters against bf16 grads here."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LRSchedule, make_runner
    from repro_torch.models import transformer as T
    from repro_torch.optim.mixed_precision import get_policy
    cfg = get_config("llama2-7b")
    gc.collect()
    torch.cuda.empty_cache()
    params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=torch.bfloat16)
    runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                         policy=get_policy("mixed_hi"),
                         schedule=LRSchedule(base_lr=1e-5), device="cuda")
    rows = []
    for batch in train_batches(cfg, 512, 4, 2, "cuda"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(runner.train_step(batch))
        torch.cuda.synchronize()
        rows.append(dict(group=runner.last_metrics["group"], loss=loss,
                         host_ms=1e3 * (time.perf_counter() - t0),
                         peak_memory_bytes=torch.cuda.max_memory_allocated()))
        if not math.isfinite(loss):
            raise RuntimeError(f"mixed_hi: non-finite loss {rows[-1]}")
    emit("train_mixed_hi", arch=cfg.name, policy="mixed_hi", batch=4,
         seq=512, steps=rows,
         peak_memory_gib=max(r["peak_memory_bytes"] for r in rows) / 2**30,
         analytic_pgs_gib=analytic(cfg, precision="mixed_hi").pgs_gb)
    del runner, params
    gc.collect()
    torch.cuda.empty_cache()


def hift_layer_step_flops(cfg, batch: int, seq: int, layer: int) -> int:
    """Operations one HiFT step needs whose active group is stacked layer
    ``layer`` (m=1), counted from shapes: every layer's forward, the
    recomputed forward (remat) and the input-gradient backward of the
    layers from ``layer`` up, the active layer's weight gradients, and the
    head's logits forward, recompute (chunked CE) and input gradient.
    Attention counts the full 512-key block it computes (QK^T and PV;
    twice that backward)."""
    d, f, h, hd = cfg.d_model, cfg.d_ff, cfg.n_heads, cfg.head_dim
    tokens = batch * seq
    weights = 2 * d * h * hd + 2 * d * cfg.kv_heads * hd + 3 * d * f
    lin = 2 * tokens * weights
    attn = 4 * tokens * seq * h * hd
    above = cfg.n_layers - layer
    head = 2 * tokens * d * cfg.vocab_padded
    return (cfg.n_layers * (lin + attn) + above * (lin + attn)
            + above * (lin + 2 * attn) + lin + 3 * head)


def phase_train_profile(torch, cfg, params, batch):
    """Where a full-size HiFT layer-group step's time goes: layer 1's step
    (AdamW, backward through 31 layers) under ``torch.profiler``, after
    the embed and layer 0 steps of a fresh runner."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                         hift=HiFTConfig(m=1), schedule=LRSchedule(1e-5),
                         device="cuda")
    for _ in range(2):
        runner.train_step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(runner.train_step(batch))
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    b, s = batch["tokens"].shape
    flops = hift_layer_step_flops(cfg, b, s, layer=1)
    emit("train_profile", group=runner.last_metrics["group"],
         flops=flops, bound_ms=1e3 * flops / PEAK_FLOPS["float32"],
         **profile_summary(prof, 1e3 * host_s, top=10))


def phase_train_4_layers(torch):
    """FPFT against HiFT at 4 layers of llama2-7b width, fp32, AdamW with
    the fused kernel, batch 4 x 512: peak memory over 2 FPFT steps and a
    full HiFT sweep (6 groups), beside the reference's analytic P+G+S for
    the same config (a model: it counts params, grads and optimizer state,
    not activations)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LRSchedule, make_runner
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=4)
    batches = train_batches(cfg, 512, 4, 6, "cuda")
    for mode, n in (("fpft", 2), ("hift", 6)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                        device="cuda", dtype=torch.float32)
        runner = make_runner(cfg, mode, params=params, optimizer="adamw",
                             fused_update=True,
                             schedule=LRSchedule(base_lr=1e-5), device="cuda")
        t0 = time.perf_counter()
        losses = [float(runner.train_step(b)) for b in batches[:n]]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        emit("train_4_layers", mode=mode, steps=n, losses=losses,
             host_s=time.perf_counter() - t0, peak_memory_bytes=peak,
             peak_memory_gib=peak / 2**30,
             analytic_pgs_gib=analytic(cfg, mode).pgs_gb)
        if not all(math.isfinite(x) for x in losses):
            raise RuntimeError(f"{mode}: non-finite loss {losses}")
        del runner, params
    gc.collect()
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phases 8a-8e

PAPER_NEW = ("roberta-large", "gpt2-large", "gpt-neo-2.7b")
OPTIMIZERS = ("adamw", "sgdm", "sgd", "adagrad", "adafactor")
# The balanced schedule runs the default's per-block loop in the port, so
# its losses are expected bit-equal; held to 1e-6 relative (8 fp32 ulps).
BALANCED_RTOL = 1e-6
# A resumed run repeats the straight run's arithmetic on the same state, so
# its params are expected bit-equal.  Should a kernel of the step not be
# run-to-run deterministic, AdamW at lr 1e-5 moves an element by at most
# ~lr a step whatever its gradient: the bound is 2 lr for each of the 3
# steps after the restore.
CKPT_BOUND = 3 * 2 * 1e-5


def _hift_runner(cfg, params, optimizer="adamw", order="bottom2up"):
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    return make_runner(cfg, "hift", params=params, optimizer=optimizer,
                       hift=HiFTConfig(m=1, strategy=order),
                       schedule=LRSchedule(base_lr=1e-5), device="cuda")


def _model_row(report) -> dict:
    return dict(analytic_pgs_gib=report.pgs_gb,
                analytic_para_mb=report.para_mb,
                analytic_grad_mb=report.grad_mb,
                analytic_state_mb=report.state_mb)


def phase_train_paper_configs(torch, cpu=None):
    """The paper's other models at published widths and full depth:
    roberta-large, gpt2-large and gpt-neo-2.7b, fp32, HiFT m=1, AdamW
    (fused), batch 4 x 512, random params from seed 0.  Each takes the
    embed step (a backward through every layer and the tied head) from a
    bottom2up runner, then the head and the top layer from a top2down one.
    Per step: host clock, peak memory beside the port's analytic P+G+S,
    the fused update's device time and launches (counted over this run).
    First, card against CPU: 3 steps of 1 layer at gpt-neo-2.7b's width
    (``phase_train_card_vs_cpu``; ``cpu`` its CPU half)."""
    from repro_torch.common.pytree import tree_bytes, tree_size
    from repro_torch.configs.registry import get_config
    phase_train_card_vs_cpu(torch, "gpt-neo-2.7b", cpu)
    with UpdateTimer(torch) as timer:
        for arch in PAPER_NEW:
            cfg = get_config(arch)
            params = fresh_params(torch, cfg)
            batches = train_batches(cfg, 512, 4, 3, "cuda")
            model = analytic(cfg)
            steps = []
            for order, n in (("bottom2up", 1), ("top2down", 2)):
                runner = _hift_runner(cfg, params, order=order)
                for _ in range(n):
                    steps.append(dict(order=order, **measured_step(
                        torch, runner, batches[len(steps)], timer)))
                    emit("train_paper_step", arch=cfg.name,
                         analytic_pgs_gib=model.pgs_gb, **steps[-1])
                k = runner.k
                del runner
            emit("train_paper_config", arch=cfg.name, n_layers=cfg.n_layers,
                 d_model=cfg.d_model, head_dim=cfg.head_dim, groups=k,
                 params=tree_size(params), params_bytes=tree_bytes(params),
                 dtype="float32", batch=4, seq=512, optimizer="adamw",
                 peak_memory_gib=max(x["peak_memory_gib"] for x in steps),
                 **_model_row(model))
            del params
        launches = timer.launches()
    if launches["fused_adamw"] == 0:
        raise RuntimeError(f"the paper configs' steps ran no fused AdamW: "
                           f"{launches}")
    return launches


def phase_train_optimizer_matrix(torch):
    """The paper's five optimizers (its claim that HiFT's saving holds for
    each) on gpt2-large at full size, fp32, HiFT m=1, batch 4 x 512: two
    steps each (embed, layer 0) from a fresh runner over the same resident
    params (trained in place), AdamW, SGD-momentum and AdaGrad through
    their fused kernels, SGD and Adafactor in plain torch (no kernel in the
    reference either).  Per step: host clock, peak memory beside the
    analytic P+G+S, the model's #Sta and the bytes of the group's bundle
    as it lies in pinned host memory."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs.registry import get_config
    cfg = get_config("gpt2-large")
    params = fresh_params(torch, cfg)
    batches = train_batches(cfg, 512, 4, 2, "cuda")
    rows = []
    with UpdateTimer(torch) as timer:
        for opt in OPTIMIZERS:
            model = analytic(cfg, optimizer=opt)
            runner = _hift_runner(cfg, params, optimizer=opt)
            steps = []
            for batch in batches:
                gi = runner.group_for_step().index
                steps.append(measured_step(torch, runner, batch, timer))
                bundle = flatten_with_paths(runner.opt_state[str(gi)]["opt"])
                steps[-1]["bundle_state_bytes"] = sum(
                    t.numel() * t.element_size() for t in bundle.values()
                    if t.is_floating_point())
                emit("train_optimizer_step", arch=cfg.name, optimizer=opt,
                     **steps[-1])
            rows.append(dict(
                optimizer=opt, host_ms=[x["host_ms"] for x in steps],
                peak_memory_gib=max(x["peak_memory_gib"] for x in steps),
                update_kernel_ms=[x["update_kernel_ms"] for x in steps],
                bundle_state_mb=max(x["bundle_state_bytes"]
                                    for x in steps) / 2**20,
                **_model_row(model)))
            del runner
        launches = timer.launches()
    emit("train_optimizer_matrix", arch=cfg.name, dtype="float32", batch=4,
         seq=512, rows=rows, launches=launches)
    if 0 in launches.values():
        raise RuntimeError(f"a fused update never launched: {launches}")
    del params
    return launches


def phase_train_fpft_vs_hift_full(torch):
    """The paper's headline comparison on a whole paper model: gpt-neo-2.7b
    at full depth, fp32, AdamW (fused), batch 4 x 512 — one FPFT step,
    then one HiFT m=1 embed step (the deepest backward) from fresh params.
    Peak memory above what was allocated before the params, beside the
    analytic P+G+S of each, and the saving both ways."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LRSchedule, make_runner
    cfg = get_config("gpt-neo-2.7b")
    batch = train_batches(cfg, 512, 4, 1, "cuda")[0]
    out = {}
    with UpdateTimer(torch) as timer:
        for mode in ("fpft", "hift"):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            params = fresh_params(torch, cfg)
            runner = make_runner(cfg, mode, params=params, optimizer="adamw",
                                 fused_update=True,
                                 schedule=LRSchedule(base_lr=1e-5),
                                 device="cuda")
            del params
            row = measured_step(torch, runner, batch, timer)
            row["peak_memory_gib"] = (row["peak_memory_bytes"] - base) / 2**30
            out[mode] = dict(row, **_model_row(analytic(cfg, mode)))
            emit("train_fpft_vs_hift_step", arch=cfg.name, mode=mode,
                 **out[mode])
            del runner
        launches = timer.launches()
    f, h = out["fpft"], out["hift"]
    emit("train_fpft_vs_hift_full", arch=cfg.name, n_layers=cfg.n_layers,
         dtype="float32", batch=4, seq=512,
         fpft_peak_gib=f["peak_memory_gib"],
         hift_peak_gib=h["peak_memory_gib"],
         fpft_analytic_gib=f["analytic_pgs_gib"],
         hift_analytic_gib=h["analytic_pgs_gib"],
         saving_pct=100 * (1 - h["peak_memory_gib"] / f["peak_memory_gib"]),
         analytic_saving_pct=100 * (1 - h["analytic_pgs_gib"]
                                    / f["analytic_pgs_gib"]),
         fpft_ms=f["host_ms"], hift_ms=h["host_ms"], launches=launches)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_balanced(torch):
    """``get_config(optimized=True)`` (the balanced causal schedule)
    against the default on gpt2-large at full size, fp32, HiFT m=1 AdamW,
    one 2048-token sequence (4 q blocks of 512): in turns default,
    balanced, balanced, default, one step each (embed: a backward through
    every layer; two steps each took 18.9 s of the whole script's 760.0 on
    an H100) from the same params; every turn's loss within
    ``BALANCED_RTOL`` of the first's, and each turn's step time.  No
    speed-up is expected: the port runs one loop for both schedules."""
    from repro_torch.configs.registry import get_config
    cfgs = {"default": get_config("gpt2-large"),
            "balanced": get_config("gpt2-large", optimized=True)}
    if not cfgs["balanced"].attention_balanced:
        raise RuntimeError("optimized=True did not select the balanced "
                           "schedule")
    batches = train_batches(cfgs["default"], 2048, 1, 1, "cuda")
    turns = []
    with UpdateTimer(torch) as timer:
        for name in ("default", "balanced", "balanced", "default"):
            cfg = cfgs[name]
            runner = _hift_runner(cfg, fresh_params(torch, cfg))
            steps = [measured_step(torch, runner, b, timer) for b in batches]
            turns.append(dict(schedule=name,
                              losses=[x["loss"] for x in steps],
                              host_ms=[x["host_ms"] for x in steps],
                              peak_memory_gib=max(x["peak_memory_gib"]
                                                  for x in steps)))
            del runner
        launches = timer.launches()
    first = turns[0]["losses"]
    gap = max(abs(a - b) / abs(a) for t in turns
              for a, b in zip(first, t["losses"]))
    emit("train_balanced", arch="gpt2-large", batch=1, seq=2048, blocks=4,
         turns=turns, max_rel_loss_gap=gap, rtol=BALANCED_RTOL,
         launches=launches)
    if gap > BALANCED_RTOL:
        raise RuntimeError(f"balanced and default losses differ: {turns}")
    return launches


def _states_equal(torch, a: dict, b: dict) -> list:
    """Paths at which two flat states differ in dtype, shape or any bit
    (tensors on the same device, numpy leaves)."""
    out = []
    for path in a.keys() | b.keys():
        x, y = a.get(path), b.get(path)
        if isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor):
            same = x.dtype == y.dtype and torch.equal(x, y)
        else:
            same = x is not None and y is not None and np.array_equal(
                np.asarray(x), np.asarray(y))
        if not same:
            out.append(path)
    return sorted(out)


def phase_train_checkpoint(torch):
    """Checkpoint and resume at full size: roberta-large, fp32, HiFT m=1
    AdamW (fused), batch 4 x 512.  6 steps straight through; then 3 steps
    through ``train.loop.train`` with an async checkpoint at step 3 (into
    a ``tempfile`` directory, removed afterwards), restored into a runner
    built from another seed, and 3 more steps.  The restored state must
    equal the saved one bit for bit (params on the card, bundles in pinned
    memory, counts, order, step) and the next group the straight run's;
    the final params are expected bit-equal to the straight run's and
    held to ``CKPT_BOUND``.  Prints the checkpoint's bytes, the save
    seconds (the host snapshot, and until the writer thread is joined) and
    the restore seconds (decode, then placement)."""
    import shutil
    import tempfile
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.loop import LoopConfig, train
    cfg = get_config("roberta-large")
    batches = train_batches(cfg, 512, 4, 6, "cuda")
    with UpdateTimer(torch) as timer:
        straight = _hift_runner(cfg, fresh_params(torch, cfg))
        for b in batches:
            straight.train_step(b)
        want_group = straight.group_for_step(3).label()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        save, calls = ckpt.save, []

        def timed_save(*args, **kw):
            t0 = time.perf_counter()
            writer = save(*args, **kw)
            calls.append((t0, time.perf_counter(), writer is not None))
            return writer

        try:
            first = _hift_runner(cfg, fresh_params(torch, cfg))
            ckpt.save = timed_save
            try:
                train(first, iter(batches[:3]), LoopConfig(
                    total_steps=3, ckpt_every=3, ckpt_dir=tmp, log_every=0,
                    async_ckpt=True))
            finally:
                ckpt.save = save
            joined = time.perf_counter()
            (t_call, t_snap, is_async), = calls
            blob = Path(tmp) / "step_3" / "state.msgpack.zst"
            nbytes = blob.stat().st_size
            resumed = _hift_runner(cfg, fresh_params(torch, cfg, seed=1))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = ckpt.restore(tmp, 3)
            decoded = time.perf_counter()
            resumed.load_state_dict(tree)
            torch.cuda.synchronize()
            placed = time.perf_counter()
            del tree
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        restored = _states_equal(torch, flatten_with_paths(first.state_dict()),
                                 flatten_with_paths(resumed.state_dict()))
        n_leaves = len(flatten_with_paths(first.state_dict()))
        del first
        got_group = resumed.group_for_step().label()
        for b in batches[3:]:
            resumed.train_step(b)
        torch.cuda.synchronize()
        launches = timer.launches()
    a = flatten_with_paths(straight.params)
    b = flatten_with_paths(resumed.params)
    unequal = [p for p in a if not torch.equal(a[p], b[p])]
    gap = max(float((a[p] - b[p]).abs().max()) for p in a)
    emit("train_checkpoint", arch=cfg.name, dtype="float32", batch=4,
         seq=512, steps=6, saved_at=3, async_write=is_async,
         checkpoint_bytes=nbytes, state_leaves=n_leaves,
         save_snapshot_s=t_snap - t_call, save_s=joined - t_call,
         restore_decode_s=decoded - t0, restore_s=placed - t0,
         restored_leaves_unequal=restored, next_group=got_group,
         want_group=want_group, unequal_param_leaves=len(unequal),
         max_param_gap=gap, bound=CKPT_BOUND, launches=launches)
    if restored or got_group != want_group or not is_async:
        raise RuntimeError(f"the checkpoint did not restore the state: "
                           f"leaves {restored[:5]}, next group {got_group} "
                           f"(want {want_group})")
    if gap > CKPT_BOUND:
        raise RuntimeError(f"the resumed run left the straight one by {gap}")
    del straight, resumed
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ phases 8f-8g

# fpft_streamed's window on the card: 64 MiB chunks, 3 on the device (the
# reference's default 1 MiB would be ~10,000 chunks a gpt-neo-2.7b step,
# each ~10 eager launches)
STREAM_WINDOW, STREAM_DEPTH = 64 << 20, 3
STREAM_LLAMA_LAYERS = 8


def _host_trees_unequal(torch, a, b) -> list:
    """Paths at which two trees (host or device leaves) differ in dtype,
    shape or any bit, each pair of leaves compared on the card."""
    from repro_torch.common.pytree import flatten_with_paths
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    bad = []
    for path in sorted(fa.keys() | fb.keys()):
        x, y = fa.get(path), fb.get(path)
        if (x is None or y is None or x.dtype != y.dtype
                or x.shape != y.shape
                or not torch.equal(x.to("cuda"), y.to("cuda"))):
            bad.append(path)
    return bad


def _pipeline_runner(torch, cfg, strategy, **kw):
    from repro_torch.core import LRSchedule, make_runner
    return make_runner(cfg, strategy, params=fresh_params(torch, cfg),
                       optimizer="adamw", fused_update=True,
                       schedule=LRSchedule(base_lr=1e-5), device="cuda",
                       **kw)


def _lockstep(torch, cfg, batches, modes: dict) -> dict:
    """One runner per mode (``make_runner`` keywords; the first is the
    serial reference), each from the same seeded params, stepped in turn
    through ``batches``.  After every step: the loss, every param (on the
    card) and the stepped group's bundle (host, compared on the card) equal
    the reference's to the bit; after the last, every leaf of the state.
    A step changes no other leaf, so every leaf is held at every step.
    Returns each pipelined mode's counters."""
    from repro_torch.common.pytree import flatten_with_paths
    runners = {name: _pipeline_runner(torch, cfg, **kw)
               for name, kw in modes.items()}
    (ref_name, ref), *others = runners.items()
    for s, batch in enumerate(batches):
        gi = str(ref.group_for_step().index)
        losses = {name: float(r.train_step(batch))
                  for name, r in runners.items()}
        torch.cuda.synchronize()
        for name, r in others:
            bad = [p for p, x in flatten_with_paths(ref.params).items()
                   if not torch.equal(x, flatten_with_paths(r.params)[p])]
            bad += _host_trees_unequal(torch, ref.opt_state[gi],
                                       r.opt_state[gi])
            if losses[name] != losses[ref_name] or bad:
                raise RuntimeError(f"{name} left {ref_name} at step {s}: "
                                   f"losses {losses}, leaves {bad[:5]}")
    stats = {}
    for name, r in others:
        bad = _host_trees_unequal(torch, ref.state_dict()["opt_state"],
                                  r.state_dict()["opt_state"])
        if bad or r.state.step != ref.state.step:
            raise RuntimeError(f"{name}: final state differs at {bad[:5]}")
        stats[name] = dict(r.strategy.pipeline_stats.__dict__,
                           depth=r.strategy._pipeline.depth)
    del runners, ref, others
    return stats


def transfer_profile(torch, runner, batches) -> dict:
    """``torch.profiler`` over ``len(batches)`` steps (each ending in the
    loss read, a synchronise at the end): per step, the device time of the
    host-to-device and device-to-host copies (the trace's ``gpu_memcpy``
    events), the part of it during which some kernel ran (overlap with the
    union of ``kernel`` events), the kernels' busy time and the host
    clock."""
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches:
            float(runner.train_step(b))
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "kernel")
    union = []
    for a, b in spans:
        if union and a <= union[-1][1]:
            union[-1][1] = max(union[-1][1], b)
        else:
            union.append([a, b])
    n = len(batches)
    out = dict(steps=n, host_ms=host_ms / n,
               kernel_busy_ms=sum(b - a for a, b in union) / 1e3 / n)
    for kind in ("HtoD", "DtoH"):
        copies = [e for e in events if e.get("cat") == "gpu_memcpy"
                  and kind in e.get("name", "")]
        dur = sum(e["dur"] for e in copies)
        over = sum(max(0.0, min(e["ts"] + e["dur"], b) - max(e["ts"], a))
                   for e in copies for a, b in union
                   if a < e["ts"] + e["dur"] and b > e["ts"])
        out[kind] = dict(copies=len(copies) / n,
                         bytes=sum(e.get("args", {}).get("bytes", 0)
                                   for e in copies) / n,
                         ms=dur / 1e3 / n, overlapped_ms=over / 1e3 / n,
                         exposed_ms=(dur - over) / 1e3 / n)
    return out


def _sweep_timing(torch, cfg, batches, strategy, timer, profile=False,
                  **kw) -> dict:
    """A fresh runner: sweep 1 (k steps), then sweep 2 timed — each step's
    host clock to its loss read, as the training loop reads it, and the
    sweep's to one synchronise after its last step — with the peak
    memory over it above what was allocated (and what the caching
    allocator held) before the params, then one
    more step; then, with ``profile``, two more steps under the profiler
    (``transfer_profile``)."""
    from repro_torch.common.pytree import flatten_with_paths
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    base_reserved = torch.cuda.memory_reserved()
    runner = _pipeline_runner(torch, cfg, strategy, **kw)
    k = runner.k
    for b in batches[:k]:
        float(runner.train_step(b))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    timer.take()
    step_ms = []
    t0 = time.perf_counter()
    for b in batches[k:2 * k]:
        t1 = time.perf_counter()
        float(runner.train_step(b))
        step_ms.append(1e3 * (time.perf_counter() - t1))
    torch.cuda.synchronize()
    sweep_ms = 1e3 * (time.perf_counter() - t0)
    update_ms, launches = timer.take()
    peak = torch.cuda.max_memory_allocated() - base
    reserved = torch.cuda.max_memory_reserved() - base_reserved
    float(runner.train_step(batches[2 * k]))
    bundle = flatten_with_paths(runner.opt_state["1"])   # layer 0's
    row = dict(strategy=strategy, k=k, second_sweep_step_ms=step_ms,
               second_sweep_ms=sweep_ms, step_ms_mean=sweep_ms / k,
               update_kernel_ms=update_ms, update_launches=launches,
               peak_memory_bytes=peak, peak_memory_gib=peak / 2**30,
               peak_reserved_gib=reserved / 2**30,
               layer_bundle_bytes=sum(t.numel() * t.element_size()
                                      for t in bundle.values()
                                      if t.is_floating_point()),
               pipeline_depth=kw.get("pipeline_depth"))
    if "lisa" in kw:
        row["switch_every"] = kw["lisa"].switch_every
    stats = runner.strategy.pipeline_stats
    if stats is not None:
        row["pipeline_stats"] = dict(stats.__dict__)
        if stats.max_resident > runner.strategy._pipeline.depth:
            raise RuntimeError(f"{strategy}: {stats.max_resident} bundles "
                               "resident over the budget")
    if profile:
        row["profile"] = transfer_profile(torch, runner,
                                          batches[2 * k + 1:2 * k + 3])
    del runner
    return row


def phase_train_pipelined(torch):
    """The bundle pipeline on the card: llama2-7b at full width and 2
    layers (k = 4; at 4 layers the phase took 44.7 s on an H100), fp32,
    HiFT m=1 with AdamW (fused), batch 4 x 512.

    Lockstep (``_lockstep``), two sweeps and one step: serial ``hift``
    against ``hift_pipelined`` at depth 2 and ``hift`` at depth 3; then
    ``lisa`` serial against ``lisa`` pipelined (depth 2), re-sampled every
    step — states bit-equal to the serial run's at every step, no prefetch
    miss for HiFT, at most ``depth`` bundles resident.

    Timing (``_sweep_timing``), each mode from fresh params: the second
    sweep's per-step host ms, the peak beside
    ``analytic(cfg, "hift_pipelined")`` at its depth (``hift`` beside
    ``hift``), the bundle bytes, and for serial and depth 2 a profile of
    two steps after the sweeps: the copies' device time and how much of it
    ran beside kernels.  The fused updates' launches are counted over the
    phase."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LiSAConfig
    cfg = dataclasses.replace(get_config("llama2-7b"), n_layers=2)
    k = cfg.n_layers + 2
    batches = train_batches(cfg, 512, 4, 2 * k + 3, "cuda")
    lisa = LiSAConfig(m=1, switch_every=1, seed=0)
    with UpdateTimer(torch) as timer:
        t0 = time.perf_counter()
        stats = _lockstep(torch, cfg, batches[:2 * k + 1], {
            "hift": dict(strategy="hift"),
            "hift_pipelined": dict(strategy="hift_pipelined"),
            "hift_depth3": dict(strategy="hift", pipeline_depth=3)})
        stats.update(_lockstep(torch, cfg, batches[:2 * k + 1], {
            "lisa": dict(strategy="lisa", lisa=lisa),
            "lisa_pipelined": dict(strategy="lisa", lisa=lisa,
                                   pipeline_depth=2)}))
        lockstep_s = time.perf_counter() - t0
        for name, st in stats.items():
            if st["max_resident"] > st["depth"] or (
                    name.startswith("hift") and st["prefetch_misses"]):
                raise RuntimeError(f"{name}: pipeline counters {st}")
        rows = []
        for strategy, kw, prof in (
                ("hift", {}, True),
                ("hift_pipelined", {}, True),
                ("hift", dict(pipeline_depth=3), False),
                ("lisa", dict(lisa=lisa), False),
                ("lisa", dict(lisa=lisa, pipeline_depth=2), False)):
            row = _sweep_timing(torch, cfg, batches, strategy, timer,
                                profile=prof, **kw)
            depth = kw.get("pipeline_depth",
                           2 if strategy == "hift_pipelined" else 1)
            model = analytic(cfg, "hift" if depth == 1 else "hift_pipelined",
                             stream_depth=max(depth, 2))
            row.update(_model_row(model), depth=depth)
            emit("train_pipelined_timing", arch=cfg.name,
                 n_layers=cfg.n_layers, **row)
            rows.append(row)
        launches = timer.launches()
    serial, piped = rows[0], rows[1]
    emit("train_pipelined", arch=cfg.name, n_layers=cfg.n_layers,
         dtype="float32", batch=4, seq=512, optimizer="adamw", k=k,
         lockstep_steps=2 * k + 1, bit_equal=True, lockstep_s=lockstep_s,
         pipeline_stats=stats,
         serial_step_ms=serial["step_ms_mean"],
         pipelined_step_ms=piped["step_ms_mean"],
         serial_copies=serial["profile"], pipelined_copies=piped["profile"],
         layer_bundle_bytes=serial["layer_bundle_bytes"], launches=launches)
    if launches["fused_adamw"] == 0:
        raise RuntimeError("the pipelined steps ran no fused AdamW")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def _timed_update(torch, strategy, attr: str, times: list) -> None:
    """Wrap ``strategy``'s update call ``attr`` (``_streamed_update``, or
    the optimizer's ``update``) in two synchronises and a host clock,
    appending its ms to ``times``."""
    if attr == "update":
        opt = strategy.optimizer
        inner = opt.update
    else:
        inner = getattr(strategy, attr)

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        return out

    if attr == "update":
        strategy.optimizer = opt._replace(update=timed)
    else:
        setattr(strategy, attr, timed)


def _streamed_row(torch, runner) -> dict:
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.core.pipeline import ChunkLayout
    s = runner.strategy
    streamed, _ = s._split_state(runner.opt_state, runner.params)
    pinned = [t for tree in streamed.values()
              for t in flatten_with_paths(tree).values()]
    if not all(t.is_pinned() for t in pinned):
        raise RuntimeError("fpft_streamed moments are not in pinned memory")
    return dict(stream_window=s.stream.chunk_bytes, depth=s.stream.depth,
                chunks=ChunkLayout.build(runner.params,
                                         s.stream.chunk_bytes).num_chunks,
                pinned_host_bytes=sum(t.numel() * t.element_size()
                                      for t in pinned),
                stream_stats=dict(s.stream_stats.__dict__))


def phase_train_streamed(torch):
    """``fpft_streamed`` on the card.  gpt-neo-2.7b at full depth, fp32,
    AdamW, batch 4 x 512: one ``fpft`` step (the fused kernel: the plain
    update on whole leaves needs ~25 GiB of temporaries and does not fit
    beside P+G+S) and one ``fpft_streamed`` step (64 MiB chunks, depth 3;
    the plain elementwise update, as the reference's) from the same
    params.  The kernel rounds as the plain version does (0 ulps, the
    update-kernel phase), so loss, every param and every moment are
    expected bit-equal and held so — with each peak above
    what was allocated before its params, beside the analytic figures, the
    pinned host bytes, the chunks, the stream's counters and the update's
    share of the step (the update between two synchronises).  Then
    llama2-7b at 8 of its 32 layers (``STREAM_LLAMA_LAYERS``; at full
    depth, where resident FPFT needs 100.4 GiB, the phase took 46.3 s of
    the whole script's 933.1, and 36.7 s at 16 layers, on an H100): two
    ``fpft_streamed`` steps, the moments in one pinned buffer."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LRSchedule, make_runner

    def runner_of(cfg, strategy, **kw):
        return make_runner(cfg, strategy, params=fresh_params(torch, cfg),
                           optimizer="adamw",
                           fused_update=strategy == "fpft",
                           schedule=LRSchedule(base_lr=1e-5), device="cuda",
                           **kw)

    window = dict(stream_window=STREAM_WINDOW, pipeline_depth=STREAM_DEPTH)
    cfg = get_config("gpt-neo-2.7b")
    batch = train_batches(cfg, 512, 4, 1, "cuda")[0]
    out = {}
    with UpdateTimer(torch) as timer:
        for mode in ("fpft", "fpft_streamed"):
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            runner = runner_of(cfg, mode,
                               **(window if mode == "fpft_streamed" else {}))
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            upd = []
            _timed_update(torch, runner.strategy, "update" if mode == "fpft"
                          else "_streamed_update", upd)
            row = measured_step(torch, runner, batch, timer)
            row.update(peak_memory_gib=(row["peak_memory_bytes"] - base)
                       / 2**30, init_s=init_s, update_ms=upd[0],
                       update_share=upd[0] / row["host_ms"],
                       **_model_row(analytic(
                           cfg, mode, stream_depth=STREAM_DEPTH,
                           stream_chunk_bytes=STREAM_WINDOW)))
            if mode == "fpft_streamed":
                row.update(_streamed_row(torch, runner))
            emit("train_streamed_step", arch=cfg.name, mode=mode, **row)
            out[mode] = (row, runner)
            del runner
        (f, fr), (s, sr) = out["fpft"], out["fpft_streamed"]
        bad = [p for p, x in flatten_with_paths(fr.params).items()
               if not torch.equal(x, flatten_with_paths(sr.params)[p])]
        bad += _host_trees_unequal(torch, fr.opt_state, sr.opt_state)
        if f["loss"] != s["loss"] or bad:
            raise RuntimeError(f"fpft_streamed left fpft: losses "
                               f"{f['loss']} {s['loss']}, leaves {bad[:5]}")
        emit("train_streamed", arch=cfg.name, n_layers=cfg.n_layers,
             dtype="float32", batch=4, seq=512, optimizer="adamw",
             bit_equal=True, fpft_peak_gib=f["peak_memory_gib"],
             streamed_peak_gib=s["peak_memory_gib"],
             fpft_analytic_gib=f["analytic_pgs_gib"],
             streamed_analytic_gib=s["analytic_pgs_gib"],
             fpft_ms=f["host_ms"], streamed_ms=s["host_ms"],
             fpft_update_ms=f["update_ms"], streamed_update_ms=s["update_ms"],
             pinned_host_bytes=s["pinned_host_bytes"], chunks=s["chunks"],
             stream_stats=s["stream_stats"])
        del out, fr, sr
        gc.collect()
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()      # the cached pinned blocks go back
        cfg = dataclasses.replace(get_config("llama2-7b"),
                                  n_layers=STREAM_LLAMA_LAYERS)
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        runner = runner_of(cfg, "fpft_streamed", **window)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        upd, steps = [], []
        _timed_update(torch, runner.strategy, "_streamed_update", upd)
        for b in train_batches(cfg, 512, 4, 2, "cuda"):
            steps.append(measured_step(torch, runner, b, timer))
            steps[-1].update(update_ms=upd[-1],
                             peak_memory_gib=(steps[-1]["peak_memory_bytes"]
                                              - base) / 2**30)
        emit("train_streamed_llama", arch=cfg.name, n_layers=cfg.n_layers,
             dtype="float32", batch=4, seq=512, init_s=init_s, steps=steps,
             fpft_analytic_gib=analytic(cfg, "fpft").pgs_gb,
             **_model_row(analytic(cfg, "fpft_streamed",
                                   stream_depth=STREAM_DEPTH,
                                   stream_chunk_bytes=STREAM_WINDOW)),
             **_streamed_row(torch, runner))
        del runner
        launches = timer.launches()
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()
    return launches


# ---------------------------------------------- fused backward and MeZO

FUSED_LR = 1e-4            # card against CPU
FUSED_STEPS = 2            # 2 steps carry each strategy's state over
FUSED_SEQ = 32             # batch 2 x FUSED_SEQ
# one layer (two until PR 22: the phase's CPU side took 135.7 of the
# whole script's 933.1 s); the full-size phase runs every layer
FUSED_LAYERS = 1
FUSED_RTOL = 1e-4          # card against CPU: losses and grad norms
# Params' largest gap, card against CPU, after FUSED_STEPS steps at
# FUSED_LR.  LOMO moves an element by lr * g, so the gradients' rounding
# (fp32 sums in other orders) leaves far less than 1e-5.  AdaLomo's
# update is about lr * sign(g) while its moments are young: a near-zero
# gradient whose sign rounds the other way moves an element by up to
# 2 lr a step.  MeZO moves every element by lr * ghat * z, and ghat =
# (L+ - L-) / 2 eps carries the losses' gap over 2 eps: at FUSED_RTOL of
# a loss near 11, up to ~1 of ghat, so up to lr * max|z| (< 6) a step.
FUSED_PARAM_TOL = {"lomo": 1e-5, "adalomo": 2 * FUSED_LR * FUSED_STEPS,
                   "mezo": 6 * FUSED_LR * FUSED_STEPS}
# What a full-size fused step may hold above the analytic P+G+S (params,
# one layer's gradients, AdaLomo's factored moments): the saved layer
# inputs (llama2-7b at 4 x 512: 32 x 32 MiB), one layer's recomputed
# graph, the head's CE blocks and gradients, the embedding's gradient and
# the updates' temporaries.  A whole gradient tree is 25.1 GiB.
FUSED_ALLOWANCE_GIB = 6.0


FUSED_ARCHS = ("llama2-7b", "gpt-neo-2.7b")    # untied and tied heads


def fused_train_side(torch, cfg, params, dev, strategy, batches, **kw):
    """One device's run of ``phase_train_fused_card_vs_cpu``: (losses, grad
    norms, final params on the CPU, seconds)."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.core import LRSchedule, make_runner
    runner = make_runner(cfg, strategy, params=params, device=dev,
                         schedule=LRSchedule(base_lr=FUSED_LR), **kw)
    t0 = time.perf_counter()
    losses, norms = [], []
    for b in batches:
        losses.append(float(runner.train_step(b)))
        g = runner.last_metrics.get("grad_norm")
        norms.append(None if g is None else float(g))
    secs = time.perf_counter() - t0
    if dev == "cuda":
        torch.cuda.synchronize()
    final = {k: t.detach().cpu() for k, t in
             flatten_with_paths(runner.params).items()}
    return losses, norms, final, secs


def fused_train_cpu(torch) -> list:
    """The CPU half of ``phase_train_fused_card_vs_cpu`` (``CpuHalves``
    runs it beside the card's phases): per arch of ``FUSED_ARCHS`` the
    config, the fp32 params of seed 0 drawn on the CPU, the batches, the
    runs (label, strategy, runner kwargs; MeZO's z from ``cpu_noise``, kept
    for the card's run) and the CPU's side of each run."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.core import AdaLomoConfig, LOMOConfig
    out = []
    for arch in FUSED_ARCHS:
        cfg = dataclasses.replace(get_config(arch), n_layers=FUSED_LAYERS)
        params = host_params(torch, cfg, on_card=False)
        shapes = {p: tuple(t.shape)
                  for p, t in flatten_with_paths(params).items()}
        batches = train_batches(cfg, FUSED_SEQ, 2, FUSED_STEPS, "cpu")
        runs = [("lomo", "lomo", dict(lomo=LOMOConfig(grad_clip=1.0,
                                                      weight_decay=0.01))),
                ("adalomo", "adalomo", {}),
                ("adalomo_clip", "adalomo",
                 dict(adalomo=AdaLomoConfig(grad_clip=1.0))),
                ("mezo", "mezo", dict(noise=cpu_noise(torch, shapes)))]
        if not cfg.tie_embeddings:
            # the CPU's side of a run at llama2-7b's width costs tens of
            # seconds; the clipped sweep's intricate case is the tied
            # head's (its embedding gradient live beside one layer's), and
            # lomo covers the untied head's two sweeps
            runs = [r for r in runs if r[0] != "adalomo_clip"]
        host = {label: fused_train_side(torch, cfg, params, "cpu", strategy,
                                        batches, **kw)
                for label, strategy, kw in runs}
        out.append((cfg, params, batches, runs, host))
    return out


def phase_train_fused_card_vs_cpu(torch, cpu=None):
    """``lomo`` (clip 1.0, weight decay 0.01), ``adalomo`` (defaults, then
    clip 1.0) and ``mezo`` (the same z on both devices, ``cpu_noise``),
    ``FUSED_STEPS`` steps each, from the same params on the CPU and the
    card: one layer (``FUSED_LAYERS``) at llama2-7b's width (untied head)
    and at gpt-neo-2.7b's (tied), fp32, batch 2 x 32 (the CPU's side sets
    the phase's time; at 2 x 128 its steps take minutes), the clipped
    ``adalomo`` at the tied width only; ``cpu`` is the CPU half
    (``fused_train_cpu``), run here when None.  Losses and grad norms
    within ``FUSED_RTOL``, params within ``FUSED_PARAM_TOL``.  Then
    ``lomo`` with ``stream=`` on the card (params offloaded to pinned host
    memory between steps) against the unstreamed card run: losses and
    params bit-equal."""
    from repro_torch.core import StreamConfig

    def rel_gap(a, b):
        return max(abs(x - y) / abs(x) for x, y in zip(a, b))

    for cfg, params, batches, runs, host in cpu or fused_train_cpu(torch):
        for label, strategy, kw in runs:
            cl, cn, cp, cs = host.pop(label)
            gl, gn, gp, gs = fused_train_side(torch, cfg, params, "cuda",
                                              strategy, batches, **kw)
            rel = rel_gap(cl, gl)
            nrel = rel_gap(cn, gn) if cn[0] is not None else 0.0
            gap = max(float((cp[k] - gp[k]).abs().max()) for k in cp)
            emit("train_fused_card_vs_cpu", arch=cfg.name, run=label,
                 n_layers=cfg.n_layers, d_model=cfg.d_model,
                 tied=cfg.tie_embeddings, batch=2, seq=FUSED_SEQ,
                 lr=FUSED_LR,
                 cpu_losses=cl, cuda_losses=gl, cpu_grad_norms=cn,
                 cuda_grad_norms=gn, max_rel_loss_gap=rel,
                 max_rel_grad_norm_gap=nrel, rtol=FUSED_RTOL,
                 max_param_gap=gap, param_tol=FUSED_PARAM_TOL[strategy],
                 cpu_seconds=cs, cuda_seconds=gs,
                 cpu_threads=torch.get_num_threads())
            if (not all(math.isfinite(x) for x in gl) or rel > FUSED_RTOL
                    or nrel > FUSED_RTOL
                    or gap > FUSED_PARAM_TOL[strategy]):
                raise RuntimeError(f"{cfg.name} {label}: card and CPU "
                                   f"differ: losses {cl} {gl}, norms {cn} "
                                   f"{gn}, param gap {gap}")
            if label == "lomo" and not cfg.tie_embeddings:
                sl, _, sp, _ = fused_train_side(
                    torch, cfg, params, "cuda", strategy, batches,
                    stream=StreamConfig(depth=2), **kw)
                bad = [k for k in gp if not torch.equal(gp[k], sp[k])]
                emit("train_fused_streamed", arch=cfg.name, run=label,
                     losses=sl, bit_equal=not bad and sl == gl)
                if bad or sl != gl:
                    raise RuntimeError(f"lomo with stream= left lomo: "
                                       f"{sl} {gl}, leaves {bad[:5]}")
            del cp, gp
        del params
        gc.collect()


class FusedUpdateTimer:
    """While in use: CUDA events around each in-place update of the fused
    backward and AdaLomo (``core.strategy._sgd_tree``, ``_ada_tree``)."""

    def __init__(self, torch):
        from repro_torch.core import strategy
        self.torch, self.mod, self.events = torch, strategy, []

    def __enter__(self):
        self._saved = {n: getattr(self.mod, n)
                       for n in ("_sgd_tree", "_ada_tree")}
        cuda = self.torch.cuda
        for name, fn in self._saved.items():
            def timed(*args, _fn=fn, **kw):
                e0 = cuda.Event(enable_timing=True)
                e1 = cuda.Event(enable_timing=True)
                e0.record()
                _fn(*args, **kw)
                e1.record()
                self.events.append((e0, e1))
            setattr(self.mod, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.mod, name, fn)

    def ms(self) -> float:
        return sum(a.elapsed_time(b) for a, b in self.events)


def fused_step(torch, runner, batch, base: int = 0, timer=None) -> dict:
    """One step: host clock to a synchronise, the group, loss and grad
    norm, and the peak allocated and reserved memory (reset before the
    step), ``base`` (bytes allocated before the params) taken off the
    former; with ``timer`` (an ``UpdateTimer``) the fused updates' device
    ms and launches too."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    if timer is not None:
        timer.take()
    t0 = time.perf_counter()
    loss = runner.train_step(batch)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    loss = float(loss)
    if not math.isfinite(loss):
        raise RuntimeError(f"{runner.strategy.name}: non-finite loss {loss}")
    gnorm = runner.last_metrics.get("grad_norm")
    out = dict(group=runner.last_metrics.get("group", "all"), loss=loss,
               grad_norm=None if gnorm is None else float(gnorm),
               host_ms=host_ms,
               peak_allocated_gib=(torch.cuda.max_memory_allocated() - base)
               / 2**30,
               peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30)
    if timer is not None:
        out["update_kernel_ms"], out["update_launches"] = timer.take()
    return out


def fused_profile(torch, runner, batch) -> dict:
    """One step under ``torch.profiler`` with its updates timed by
    events: device busy ms, idle share, the GEMMs' and the updates'
    shares of the busy time."""
    from torch.profiler import ProfilerActivity, profile
    with FusedUpdateTimer(torch) as timer, profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(runner.train_step(batch))
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    out = profile_summary(prof, host_ms, top=10, gemm_ms="gemm")
    busy = out["device_busy_ms"]
    out.update(update_ms=timer.ms(), update_calls=len(timer.events),
               gemm_share=out["gemm_ms"] / busy,
               update_share=timer.ms() / busy)
    return out


# Depth of the llama2-7b runs of ``train_fused_full`` and
# ``train_quant_full`` (32 until PR 23: the whole script took 1077.8 s of
# its 1200 s limit with the encdec phase; the phases took 49.4 and 45.2 s).
LLAMA_CUT_LAYERS = 16


def phase_train_fused_full(torch):
    """The fused-backward and zeroth-order strategies at full width, fp32,
    batch 4 x 512, random weights from seed 0 trained in place: llama2-7b
    (``LLAMA_CUT_LAYERS`` of its 32 layers, untied head) under ``lomo``
    (clip 1.0: a forward and two
    reverse sweeps) for 2 steps, ``adalomo`` (defaults) for 2 and ``mezo``
    for 3, then gpt-neo-2.7b at full depth (tied head) under ``lomo`` for
    2.  Per step: host ms, loss, grad norm, peak allocated (above what was
    allocated before the params) and reserved memory beside the analytic
    P+G+S of the strategy's mode; then one more ``lomo`` step of
    llama2-7b under the profiler.  Raises when a loss is not finite or a
    peak exceeds the analytic figure by more than ``FUSED_ALLOWANCE_GIB``
    (which proves no whole gradient tree was built)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LOMOConfig, LRSchedule, make_runner
    summary = {}
    for arch, plan in (("llama2-7b", (("lomo", 2), ("adalomo", 2),
                                      ("mezo", 3))),
                       ("gpt-neo-2.7b", (("lomo", 2),))):
        cfg = get_config(arch)
        if arch == "llama2-7b":
            cfg = dataclasses.replace(cfg, n_layers=LLAMA_CUT_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        params = fresh_params(torch, cfg)
        batches = train_batches(cfg, 512, 4, 3, "cuda")
        for strategy, n in plan:
            kw = ({"lomo": LOMOConfig(grad_clip=1.0)}
                  if strategy == "lomo" else {})
            runner = make_runner(cfg, strategy, params=params,
                                 schedule=LRSchedule(base_lr=1e-5),
                                 device="cuda", **kw)
            model = analytic(cfg, strategy)
            steps = []
            for i in range(n):
                steps.append(fused_step(torch, runner, batches[i], base))
                emit("train_fused_step", arch=cfg.name, strategy=strategy,
                     step=i, analytic_pgs_gib=model.pgs_gb, **steps[-1])
            peak = max(s["peak_allocated_gib"] for s in steps)
            summary[f"{cfg.name}/{strategy}"] = dict(
                peak_allocated_gib=peak, analytic_pgs_gib=model.pgs_gb,
                over_analytic_gib=peak - model.pgs_gb,
                host_ms=[s["host_ms"] for s in steps])
            if peak - model.pgs_gb > FUSED_ALLOWANCE_GIB:
                raise RuntimeError(
                    f"{cfg.name} {strategy}: peak {peak:.2f} GiB exceeds the "
                    f"analytic {model.pgs_gb:.2f} GiB by more than "
                    f"{FUSED_ALLOWANCE_GIB} GiB")
            if strategy == "lomo" and arch == "llama2-7b":
                emit("train_fused_profile", arch=cfg.name, strategy=strategy,
                     **fused_profile(torch, runner, batches[2]))
            del runner
        del params, batches
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              n_layers=LLAMA_CUT_LAYERS)
    emit("train_fused_memory", arch=cfg.name, dtype="float32", batch=4,
         seq=512, allowance_gib=FUSED_ALLOWANCE_GIB, runs=summary,
         hift_analytic_gib=analytic(cfg, "hift").pgs_gb,
         fpft_analytic_gib=analytic(cfg, "fpft").pgs_gb)
    gc.collect()
    torch.cuda.empty_cache()


# ----------------------------------------------------- hybrid training

HYBRID_LR = 1e-4           # card against CPU
HYBRID_SEQ = 64            # batch 2 x HYBRID_SEQ
HYBRID_RTOL = 1e-4         # card against CPU: losses and grad norms


def hybrid_train_side(torch, cfg, params, runs, dev: str) -> dict:
    """One device's side of ``phase_train_hybrid_card_vs_cpu``: per run its
    (losses, grad norms, final params on the CPU, seconds, groups).  On
    the card the training forward must launch no scan kernel and the HiFT
    steps the fused AdamW once each."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.core import LRSchedule, make_runner
    from repro_torch.kernels import fused_update as FU
    from repro_torch.kernels import ssm_scan as S
    batches = train_batches(cfg, HYBRID_SEQ, 2, 4, "cpu")
    out = {}
    for strategy, kw, n, _ in runs:
        runner = make_runner(cfg, strategy, params=params, device=dev,
                             schedule=LRSchedule(base_lr=HYBRID_LR), **kw)
        if dev == "cuda":
            S.reset_launches()
        fu = FU.fused_adamw_update.launches
        t0 = time.perf_counter()
        losses, norms, groups = [], [], []
        for b in batches[:n]:
            losses.append(float(runner.train_step(b)))
            g = runner.last_metrics.get("grad_norm")
            norms.append(None if g is None else float(g))
            groups.append(runner.last_metrics.get("group"))
        secs = time.perf_counter() - t0
        if dev == "cuda":
            torch.cuda.synchronize()
            if S.ssm_scan.launches:
                raise RuntimeError("hybrid training launched the SSM "
                                   "scan kernel, which has no backward")
            if strategy == "hift" and \
                    FU.fused_adamw_update.launches - fu != n:
                raise RuntimeError("the card's hybrid HiFT steps did "
                                   "not run the fused AdamW once each")
        final = {k: t.detach().cpu() for k, t in
                 flatten_with_paths(runner.params).items()}
        out[strategy] = (losses, norms, final, secs, groups)
        del runner
    return out


def hybrid_train_cpu(torch, cfg=None):
    """The CPU half of ``phase_train_hybrid_card_vs_cpu`` (``CpuHalves``
    runs it beside the card's phases): the config (12 layers of
    zamba2-2.7b unless given), the fp32 params of seed 0 drawn on the CPU
    with slow-decay SSM scalars, the runs (strategy, runner kwargs, steps,
    param tolerance; MeZO's z from ``cpu_noise``, kept for the other
    side) and the CPU's side."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HiFTConfig, LOMOConfig
    cfg = cfg or dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12)
    params = host_params(torch, cfg, on_card=False)
    slow_decay(torch, params)
    shapes = {p: tuple(t.shape) for p, t in flatten_with_paths(params).items()}
    runs = (("hift", dict(hift=HiFTConfig(m=4, strategy="top2down"),
                          optimizer="adamw"), 4, 2 * HYBRID_LR + 1e-6),
            ("lomo", dict(lomo=LOMOConfig(grad_clip=0.0)), 1,
             FUSED_PARAM_TOL["lomo"]),
            ("adalomo", {}, 1, 2 * HYBRID_LR),
            ("mezo", dict(noise=cpu_noise(torch, shapes)), 1,
             6 * HYBRID_LR))
    return cfg, params, runs, hybrid_train_side(torch, cfg, params, runs,
                                                "cpu")


def phase_train_hybrid_card_vs_cpu(torch, cfg=None, devices=("cpu", "cuda"),
                                   cpu=None):
    """Hybrid training, card against CPU, from the same fp32 params: 12
    layers (2 super-blocks) of zamba2-2.7b at full width with slow-decay
    SSM scalars, batch 2 x 64.  ``hift`` (m = 4, top2down, AdamW: layer
    11 + shared + head, whose cut rounds down to super-block 1; layers
    7-10; layers 3-6, backward through both super-blocks; embed + layers
    0-2), then one step each of ``lomo`` (unclipped, one reverse sweep:
    the clipped two run at full size in ``train_hybrid_full`` and against
    the CPU in ``train_fused_card_vs_cpu``), ``adalomo`` and ``mezo``
    (the same z on both devices).  Losses and grad norms within
    ``HYBRID_RTOL``, params within ``FUSED_PARAM_TOL`` (HiFT's AdamW: its
    first update is about lr sign(g), so a near-zero gradient that rounds
    to the other sign on one device moves its element 2 lr apart, plus
    the subtraction's rounding, 1e-6).  The card's training
    forward runs the plain chunked scan, never the scan kernel (its
    launches stay 0), and the kernel refuses inputs that require grad
    under grad mode.  ``cpu`` is the CPU half (``hybrid_train_cpu``), run
    here when None; ``cfg``/``devices`` let the phase run small on the CPU
    alone (its second side on ``devices[1]``)."""
    from repro_torch.kernels import ssm_scan as S
    cfg, params, runs, first = cpu or hybrid_train_cpu(torch, cfg)
    second = hybrid_train_side(torch, cfg, params, runs, devices[1])
    for strategy, _, _, param_tol in runs:
        (cl, cn, cp, cs, groups), (gl, gn, gp, gs, _) = (first.pop(strategy),
                                                          second.pop(strategy))
        rel = max(abs(x - y) / abs(x) for x, y in zip(cl, gl))
        nrel = (max(abs(x - y) / abs(x) for x, y in zip(cn, gn))
                if cn[0] is not None else 0.0)
        gap = max(float((cp[k] - gp[k]).abs().max()) for k in cp)
        emit("train_hybrid_card_vs_cpu", arch=cfg.name, run=strategy,
             n_layers=cfg.n_layers, d_model=cfg.d_model, batch=2,
             seq=HYBRID_SEQ, lr=HYBRID_LR, groups=groups, cpu_losses=cl,
             cuda_losses=gl, cpu_grad_norms=cn, cuda_grad_norms=gn,
             max_rel_loss_gap=rel, max_rel_grad_norm_gap=nrel,
             rtol=HYBRID_RTOL, max_param_gap=gap, param_tol=param_tol,
             cpu_seconds=cs, cuda_seconds=gs,
             cpu_threads=torch.get_num_threads())
        if (not all(math.isfinite(x) for x in gl) or rel > HYBRID_RTOL
                or nrel > HYBRID_RTOL or gap > param_tol):
            raise RuntimeError(f"{cfg.name} {strategy}: card and CPU differ: "
                               f"losses {cl} {gl}, norms {cn} {gn}, param "
                               f"gap {gap}")
        del cp, gp
    if "cuda" in devices:
        x = torch.zeros((1, 64, 2, 64), device="cuda", requires_grad=True)
        a = torch.zeros((1, 64, 2), device="cuda")
        bc = torch.zeros((1, 64, 64), device="cuda")
        try:
            S.ssm_scan(x, a, bc, bc)
        except RuntimeError as e:
            refused = "no backward" in str(e)
        else:
            refused = False
        with torch.no_grad():
            S.ssm_scan(x, a, bc, bc)        # the same call without a graph
        torch.cuda.synchronize()
        emit("train_hybrid_scan_guard", refuses_grad=refused)
        if not refused:
            raise RuntimeError("ssm_scan accepted an input that requires "
                               "grad under grad mode on the card")
    del params
    gc.collect()


def phase_train_hybrid_full(torch):
    """zamba2-2.7b at its published config (54 layers, d_model 2560, 80 SSM
    heads of 64, state 64, the shared block every 6 layers), random fp32
    weights from seed 0 trained in place, batch 4 x 512:

    - HiFT m=1, AdamW (fused): embed and layer 0 (bottom2up), then head,
      shared and layer 53 (top2down): step ms, peak allocated and
      reserved beside the analytic P+G+S; layer 1's step (a backward
      through every super-block) under ``torch.profiler``: busy ms, idle
      share, the GEMMs' share, the top kernels;
    - FPFT, AdamW (fused, in place): one step, the same; the FPFT-vs-HiFT
      saving in peak memory beside the analytic one;
    - ``lomo`` (clip 1.0), ``adalomo`` and ``mezo``, one step each (two
      each took 16.6 s of the whole script's 760.0 on an H100): a peak
      more than ``FUSED_ALLOWANCE_GIB`` over the analytic P+G+S (the fused
      grain one super-block) fails the run;
    - NF4 HiFT (bf16 moments; embed, layer 0) from fresh params encoded
      and then freed: the dequant kernel's device ms and launches a step.

    Returns the kernels' launches over the HiFT and NF4 runs (counted from
    0 at their start)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (HiFTConfig, LOMOConfig, LRSchedule,
                                  QuantConfig, make_runner)
    from repro_torch.core.memory_model import analyze, param_shapes
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.models import zamba2 as Z
    cfg = get_config("zamba2-2.7b")
    units = Z.unit_spec(cfg)
    shapes = param_shapes(cfg)

    def model(mode, m=1, **kw):
        return analyze(shapes, units, optimizer="adamw", precision="fp32",
                       mode=mode, m=m, **kw).pgs_gb

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return Z.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda", dtype=torch.float32)

    batches = train_batches(cfg, 512, 4, 4, "cuda")
    sched = LRSchedule(base_lr=1e-5)
    params = fresh()
    rows, runs = [], {}
    with UpdateTimer(torch) as timer:   # counts the main path's run only
        for order, n in (("bottom2up", 2), ("top2down", 3)):
            runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                                 hift=HiFTConfig(m=1, strategy=order),
                                 schedule=sched, device="cuda")
            for _ in range(n):
                rows.append(fused_step(torch, runner, batches[len(rows) % 4],
                                       timer=timer))
                emit("train_hybrid_step", arch=cfg.name, strategy="hift",
                     order=order, analytic_pgs_gib=model("hift"),
                     **rows[-1])
            if order == "bottom2up":
                # layer 1: a backward through every super-block
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    float(runner.train_step(batches[2]))
                    torch.cuda.synchronize()
                    host_ms = 1e3 * (time.perf_counter() - t0)
                out = profile_summary(prof, host_ms, top=10, gemm_ms="gemm")
                emit("train_hybrid_profile", arch=cfg.name,
                     group=runner.last_metrics["group"],
                     gemm_share=out["gemm_ms"] / out["device_busy_ms"], **out)
            del runner
        # FPFT updates in place through the fused kernel: the plain
        # update's temporaries of the 5.4 GiB stacked in_proj leaf would
        # not fit beside the full tree, its gradients and moments
        runner = make_runner(cfg, "fpft", params=params, optimizer="adamw",
                             fused_update=True, schedule=sched,
                             device="cuda")
        runs["fpft"] = [fused_step(torch, runner, batches[0], timer=timer)]
        emit("train_hybrid_step", arch=cfg.name, strategy="fpft",
             analytic_pgs_gib=model("fpft"), **runs["fpft"][-1])
        del runner
        launches = timer.launches()
    gc.collect()
    torch.cuda.empty_cache()            # each run's reserved bytes its own
    runs["hift"] = rows
    for strategy, kw in (("lomo", {"lomo": LOMOConfig(grad_clip=1.0)}),
                         ("adalomo", {}), ("mezo", {})):
        runner = make_runner(cfg, strategy, params=params, schedule=sched,
                             device="cuda", **kw)
        m = runner.strategy.memory_m
        pgs = model(runner.strategy.memory_mode, m)
        runs[strategy] = [fused_step(torch, runner, batches[0])]
        emit("train_hybrid_step", arch=cfg.name, strategy=strategy, m=m,
             analytic_pgs_gib=pgs, **runs[strategy][-1])
        peak = max(r["peak_allocated_gib"] for r in runs[strategy])
        if peak - pgs > FUSED_ALLOWANCE_GIB:
            raise RuntimeError(f"{cfg.name} {strategy}: peak {peak:.2f} GiB "
                               f"exceeds the analytic {pgs:.2f} GiB by more "
                               f"than {FUSED_ALLOWANCE_GIB} GiB")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    del params
    hift_peak = max(r["peak_allocated_gib"] for r in runs["hift"])
    fpft_peak = max(r["peak_allocated_gib"] for r in runs["fpft"])
    hift_pgs, fpft_pgs = model("hift"), model("fpft")
    emit("train_hybrid_memory", arch=cfg.name, dtype="float32", batch=4,
         seq=512, n_params=analyze(shapes, units).n_params,
         hift_peak_gib=hift_peak, fpft_peak_gib=fpft_peak,
         hift_analytic_gib=hift_pgs, fpft_analytic_gib=fpft_pgs,
         saving=1 - hift_peak / fpft_peak,
         analytic_saving=1 - hift_pgs / fpft_pgs,
         runs={k: dict(peak_allocated_gib=max(r["peak_allocated_gib"]
                                              for r in v),
                       host_ms=[r["host_ms"] for r in v])
               for k, v in runs.items()})

    params = fresh()
    runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                         hift=HiFTConfig(m=1), quant=QuantConfig("nf4",
                                                                 "bf16"),
                         schedule=sched, device="cuda")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    # count the main path's run only
    with UpdateTimer(torch) as timer, UpdateTimer(torch, DM) as dq:
        for i in range(2):
            row = fused_step(torch, runner, batches[i], timer=timer)
            row["dequant_kernel_ms"], row["dequant_launches"] = dq.take()
            emit("train_hybrid_quant_step", arch=cfg.name, fmt="nf4",
                 moments="bf16", analytic_pgs_gib=model(
                     "hift", frozen_quant="nf4", moment_dtype="bf16"),
                 **row)
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
    tc = DM.dequant_matmul.launches_tc
    launches["dequant_matmul"] = DM.dequant_matmul.launches - tc
    launches["dequant_matmul_bf16"] = tc
    if not launches["dequant_matmul"]:
        raise RuntimeError("NF4 hybrid HiFT never launched the dequant "
                           "kernel")
    del runner
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_hybrid_launches", launches=launches)
    return launches


# ------------------------------------------------------------ phases 9-12

def dequant_cases(cfg):
    """(case, fmt, dtype, K, N, stacked) at llama2-7b's shapes; the first
    is the main path's (NF4, fp32, a stacked layer's square projection)."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_padded
    shapes = [("layer wq/wk/wv/wo", d, d, True),
              ("layer w_gate/w_up", d, f, True),
              ("layer w_down", f, d, True),
              ("head", d, v, False),
              ("ragged (K 1000, N 200)", 1000, 200, True)]
    return [(f"{name} {fmt} {dtype}", fmt, dtype, k, n, stacked)
            for fmt in ("nf4", "int8") for dtype in ("float32", "bfloat16")
            for name, k, n, stacked in shapes]


def mamba_dequant_cases(cfg):
    """(case, fmt, dtype, K, N, stacked) at a zamba2 Mamba2 layer's
    projections: ``in_proj`` (d_model, 2 d_inner + 2 N + H) = (2560,
    10448), 81.6 lane tiles of 128, its last column tile partial; and
    ``out_proj`` (d_inner, d_model) = (5120, 2560)."""
    di = cfg.expand * cfg.d_model
    n_in = 2 * di + 2 * cfg.ssm_state + cfg.ssm_heads
    shapes = [("mamba in_proj", cfg.d_model, n_in),
              ("mamba out_proj", di, cfg.d_model)]
    return [(f"{name} {fmt} {dtype}", fmt, dtype, k, n, True)
            for fmt in ("nf4", "int8") for dtype in ("float32", "bfloat16")
            for name, k, n in shapes]


def xlstm_dequant_cases(cfg):
    """(case, fmt, dtype, K, N, stacked) at the xlstm layers' projections
    that no other family has: the mLSTM's gates ``w_i``/``w_f`` (d_inner,
    heads) = (4096, 4), one partial column tile four columns wide, and
    the sLSTM's ``w_zifo`` (d_model, 4 d_model) = (2048, 8192)."""
    di = cfg.expand * cfg.d_model
    shapes = [("mlstm w_i/w_f", di, cfg.n_heads),
              ("slstm w_zifo", cfg.d_model, 4 * cfg.d_model)]
    return [(f"{name} {fmt} {dtype}", fmt, dtype, k, n, True)
            for fmt in ("nf4", "int8") for dtype in ("float32", "bfloat16")
            for name, k, n in shapes]


def dequant_inputs(torch, fmt, dt, m, k, n, stacked, gen):
    """(x, view): random x and a codec view of random weights encoded on
    the card; a stacked leaf gives layer 1 of a 2-layer stack (scale tile
    rows 8), a 2-d leaf its whole view (tile rows 1)."""
    from repro_torch.dist import quant as Q
    shape = (2, k, n) if stacked else (k, n)
    w = (torch.randn(shape, generator=gen, device="cuda") / k ** 0.5).to(dt)
    rec = Q.quantize_leaf(w, fmt)
    del w
    view = Q.layer_of(rec, 1) if stacked else Q.view_of(rec)
    x = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    return x, view


def phase_dequant_kernel(torch):
    """The dequant-matmul kernel against its plain version on the card at
    M = 2048 (batch 4 x 512): decode bit-exact through one-hot rows of x,
    the product within ``DEQUANT_TOL``; times beside the bound and the
    product of ``torch.matmul`` on the pre-decoded weight (no single
    PyTorch call decodes and multiplies, so ``library_ms`` is null).  bf16
    x runs on the tensor cores (``dequant_matmul_bf16``, bound at the bf16
    tensor-core rate), fp32 x on the CUDA cores (``dequant_matmul``).
    After llama2-7b's shapes, zamba2's Mamba2 projections
    (``mamba_dequant_cases``: N = 10448 ends in a partial column tile) and
    xlstm's (``xlstm_dequant_cases``: N = 4, one partial tile)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.kernels import ref
    cfg = get_config("llama2-7b")
    gen = torch.Generator(device="cuda").manual_seed(99)
    m = 4 * 512
    results = {}
    for case, fmt, dtype, k, n, stacked in (
            dequant_cases(cfg)
            + mamba_dequant_cases(get_config("zamba2-2.7b"))
            + xlstm_dequant_cases(get_config("xlstm-1.3b"))):
        dt = getattr(torch, dtype)
        x, view = dequant_inputs(torch, fmt, dt, m, k, n, stacked, gen)
        eye = torch.eye(k, dtype=dt, device="cuda")
        decoded = DM.dequant_matmul(eye, view)
        exact = torch.equal(decoded, view.decode().to(dt))
        del eye, decoded
        if not exact:
            raise RuntimeError(f"dequant_matmul ({case}): decode differs "
                               "from dist.quant's")
        got = DM.dequant_matmul(x, view).float()
        want = ref.dequant_matmul_ref(x, view).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"dequant_matmul ({case}): non-finite output")
        err = (got - want).abs()
        tol = DEQUANT_TOL[dtype]
        max_err = float(err.max())
        if bool((err > tol + tol * want.abs()).any()):
            raise RuntimeError(f"dequant_matmul ({case}): max |err| "
                               f"{max_err} over tolerance {tol}")
        del got, want, err
        e = 2 if dtype == "bfloat16" else 4
        nbytes = (x.numel() * e + view.q.numel() * view.q.element_size()
                  + 4 * view.s.numel() + m * n * e)
        sets = [(x, view)] + [dequant_inputs(torch, fmt, dt, m, k, n,
                                             stacked, gen)
                              for _ in range(copies(nbytes) - 1)]
        ms = time_ms(torch, DM.dequant_matmul, sets, reps=5, launches=10)
        plain_ms = time_ms(torch, ref.dequant_matmul_ref, sets, reps=3,
                           launches=4)
        dense = [(a, v.decode().to(dt)) for a, v in sets]
        decoded_ms = time_ms(torch, torch.matmul, dense, reps=5, launches=10)
        del dense
        flops = 2 * m * k * n
        bound_ms, bound_by = bound(flops, nbytes, dtype)
        row = dict(kernel=instance("dequant_matmul", dtype), case=case,
                   fmt=fmt, dtype=dtype,
                   shapes=dict(m=m, k=k, n=n, tile_rows=view.tile_rows),
                   decode_bit_exact=exact, max_abs_err=max_err, tol=tol,
                   ms=ms, plain_ms=plain_ms, library_ms=None,
                   decoded_matmul_ms=decoded_ms, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=nbytes,
                   share_of_bound=bound_ms / ms)
        emit("kernel", **row)
        results.setdefault(row["kernel"], row)   # the main path's cases
        del sets, x, view
        gc.collect()
        torch.cuda.empty_cache()
    return results


def quant_codes_cpu(torch) -> list:
    """The CPU half of ``phase_quant_codes`` (``CpuHalves`` runs it beside
    the card's phases: the CPU's encode took 43.2 s of the whole script's
    760.0 on the main thread): one llama2-7b layer group (9 leaves,
    stacked (1, K, N) and (1, d)) in fp32 and bf16, and the head (D, V)
    in fp32, drawn on the CPU from seed 5 for each format; per format and
    leaf (format, the leaf, its CPU record)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import quant as Q
    cfg = get_config("llama2-7b")
    gen = torch.Generator().manual_seed(5)
    leaves = [(s, torch.float32) for s in group_shapes(cfg, "layer")]
    leaves += [(s, torch.bfloat16) for s in group_shapes(cfg, "layer")]
    leaves += [((cfg.d_model, cfg.vocab_padded), torch.float32)]
    out = []
    for fmt in Q.QUANT_FORMATS:
        for shape, dt in leaves:
            w = (torch.randn(shape, generator=gen) / shape[-2] ** 0.5).to(dt)
            out.append((fmt, w, Q.quantize_leaf(w, fmt)))
    return out


def phase_quant_codes(torch, cpu=None):
    """The codec on the card and on the CPU from the same weights
    (``quant_codes_cpu``'s leaves, in both formats; ``cpu`` is that CPU
    half, run here when None): codes and scales must be equal."""
    from repro_torch.dist import quant as Q
    t0 = time.perf_counter()
    n_el = 0
    cpu = cpu or quant_codes_cpu(torch)
    for fmt, w, want in cpu:
        card = Q.quantize_leaf(w.to("cuda"), fmt)
        for key in ("q", "s"):
            if not torch.equal(want[key], card[key].cpu()):
                raise RuntimeError(f"{fmt} {key} of a {tuple(w.shape)} "
                                   f"{w.dtype} leaf: card differs from CPU")
        if card["t"].dtype != w.dtype or tuple(card["t"].shape) != tuple(
                want["t"].shape):
            raise RuntimeError("templates differ")
        n_el += w.numel()
        del card
    emit("codes_card_vs_cpu", formats=list(Q.QUANT_FORMATS),
         leaves=len(cpu) // len(Q.QUANT_FORMATS), elements=n_el, equal=True,
         seconds=time.perf_counter() - t0)
    cpu.clear()


def quant_train_side(torch, cfg, params, dev: str) -> dict:
    """One device's side of ``phase_train_quant_card_vs_cpu``: the
    runner's resident codes (on the CPU), a quantized HiFT step's loss for
    each group (embed, each layer, head), seconds and dequant launches."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.core import LRSchedule, QuantConfig, make_runner
    from repro_torch.kernels import dequant_matmul as DM
    batches = train_batches(cfg, 64, 1, cfg.n_layers + 2, "cpu")
    runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                         schedule=LRSchedule(base_lr=1e-4),
                         quant=QuantConfig("nf4", "bf16"), device=dev)
    codes = {k: t.cpu() for k, t in flatten_with_paths(runner.params).items()}
    before = DM.dequant_matmul.launches
    t0 = time.perf_counter()
    losses = [float(runner.train_step(b)) for b in batches]
    secs = time.perf_counter() - t0
    if dev == "cuda" and DM.dequant_matmul.launches == before:
        raise RuntimeError("the card's quantized HiFT steps did not run the "
                           "dequant-matmul kernel")
    return dict(codes=codes, losses=losses, seconds=secs,
                launches=DM.dequant_matmul.launches - before)


def quant_train_cpu(torch):
    """The CPU half of ``phase_train_quant_card_vs_cpu`` (``CpuHalves``
    runs it beside the card's phases): the fp32 params of seed 0 drawn on
    the CPU and the CPU's side."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              n_layers=CARD_VS_CPU_LAYERS)
    params = host_params(torch, cfg, on_card=False)
    return params, quant_train_side(torch, cfg, params, "cpu")


def phase_train_quant_card_vs_cpu(torch, cpu=None):
    """3 HiFT steps with AdamW and ``QuantConfig("nf4", "bf16")`` (embed,
    layer 0, head) of a 1-layer model (``CARD_VS_CPU_LAYERS``) at llama2-7b
    width, fp32, batch 1 x 64, from the same params on the CPU (plain
    versions) and the card (kernels); ``cpu`` is the CPU half
    (``quant_train_cpu``), run here when None.  The resident codes of both
    runners are equal; losses within rtol 1e-4, for the reason of
    ``phase_train_card_vs_cpu``."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              n_layers=CARD_VS_CPU_LAYERS)
    params, host = cpu or quant_train_cpu(torch)
    sides = {"cpu": host,
             "cuda": quant_train_side(torch, cfg, params, "cuda")}
    for dev, side in sides.items():
        emit("train_quant_card_vs_cpu_run", device=dev,
             seconds=side["seconds"], dequant_launches=side["launches"])
    codes = {dev: side["codes"] for dev, side in sides.items()}
    out = {dev: side["losses"] for dev, side in sides.items()}
    same = all(torch.equal(codes["cpu"][k], codes["cuda"][k])
               for k in codes["cpu"])
    rel = max(abs(a - b) / abs(a) for a, b in zip(out["cpu"], out["cuda"]))
    emit("train_quant_card_vs_cpu", n_layers=cfg.n_layers,
         d_model=cfg.d_model, quant="nf4/bf16", batch=1, seq=64,
         resident_codes_equal=same, cpu_losses=out["cpu"],
         cuda_losses=out["cuda"], max_rel_loss_gap=rel, rtol=1e-4)
    if not same:
        raise RuntimeError("card and CPU resident codes differ")
    if not all(math.isfinite(x) for x in out["cuda"]) or rel > 1e-4:
        raise RuntimeError(f"card and CPU quantized losses differ: {out}")
    del params, codes, sides
    gc.collect()


def phase_train_quant_full(torch):
    """llama2-7b at full width and ``LLAMA_CUT_LAYERS`` of its 32 layers,
    HiFT m=1, AdamW, batch 4 x 512,
    quantized residency: NF4 + bf16 moments at fp32 (embed, layers 0 and 1
    bottom2up; head and the top layer top2down), int8 + bf16 moments at fp32
    and NF4 + bf16 moments under Mixed^Hi (embed and layer 0 each).  Each
    runner encodes fresh random params from seed 0, which are then freed,
    so a step's peak holds the encoded tree.  Per step: host clock, peak
    memory (reset per step) and the dequant kernel's device time (CUDA
    events around its launches) and launches, those on the tensor cores
    (bf16 x: the Mixed^Hi steps) apart; the kernels' launches are counted
    over the run, which includes a profiled deep step of the first NF4
    runner (layer 2) and of the Mixed^Hi runner (layer 1), each run under
    ``torch.profiler``."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (HiFTConfig, LRSchedule, QuantConfig,
                                  make_runner)
    from repro_torch.dist.quant import quant_bytes
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.kernels import fused_update as FU
    from repro_torch.models import transformer as T
    from repro_torch.optim.mixed_precision import get_policy
    cfg = dataclasses.replace(get_config("llama2-7b"),
                              n_layers=LLAMA_CUT_LAYERS)
    batches = train_batches(cfg, 512, 4, 4, "cuda")
    plan = [("nf4", "fp32", "bottom2up", 3), ("nf4", "fp32", "top2down", 2),
            ("int8", "fp32", "bottom2up", 2),
            ("nf4", "mixed_hi", "bottom2up", 2)]
    steps, peaks = [], {}
    FU.reset_launches()                 # count the main path's run only
    with UpdateTimer(torch, DM) as dq:
        for fmt, policy, order, n in plan:
            gc.collect()
            torch.cuda.empty_cache()
            dt = torch.bfloat16 if policy == "mixed_hi" else torch.float32
            params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                            device="cuda", dtype=dt)
            t0 = time.perf_counter()
            runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                                 hift=HiFTConfig(m=1, strategy=order),
                                 policy=get_policy(policy),
                                 quant=QuantConfig(fmt, "bf16"),
                                 schedule=LRSchedule(base_lr=1e-5),
                                 device="cuda")
            torch.cuda.synchronize()
            encode_s = time.perf_counter() - t0
            del params
            gc.collect()
            torch.cuda.empty_cache()
            resident = quant_bytes(runner.params)
            model_gib = analytic(cfg, "hift", policy, frozen=fmt,
                                 moments="bf16").pgs_gb
            for i in range(n):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dq.take()
                tc0 = DM.dequant_matmul.launches_tc
                t0 = time.perf_counter()
                loss = float(runner.train_step(batches[i]))
                torch.cuda.synchronize()
                host_ms = 1e3 * (time.perf_counter() - t0)
                label = runner.last_metrics["group"]
                peak = torch.cuda.max_memory_allocated()
                key = (cfg.n_layers, "hift", policy, fmt, "bf16")
                dequant_ms, dequant_n = dq.take()
                steps.append(dict(
                    quant=f"{fmt}/bf16", policy=policy, order=order,
                    group=label, kind=_group_kind(label), loss=loss,
                    host_ms=host_ms, peak_memory_bytes=peak,
                    peak_memory_gib=peak / 2**30,
                    analytic_pgs_gib=model_gib,
                    resident_bytes=resident, encode_s=encode_s,
                    dequant_kernel_ms=dequant_ms,
                    dequant_launches=dequant_n,
                    dequant_launches_tc=DM.dequant_matmul.launches_tc - tc0))
                emit("train_quant_step", arch=cfg.name, **steps[-1])
                peaks[key] = max(peaks.get(key, 0), peak)
                if not math.isfinite(loss):
                    raise RuntimeError(f"non-finite loss at {label}")
            if order == "bottom2up" and fmt == "nf4":   # a deep step
                phase_train_quant_profile(torch, cfg, runner, batches[n],
                                          f"{fmt}/bf16", policy)
            del runner
        tc = DM.dequant_matmul.launches_tc
        launches = {"dequant_matmul": DM.dequant_matmul.launches - tc,
                    "dequant_matmul_bf16": tc,
                    **{fn.__name__.replace("_update", ""): fn.launches
                       for fn in FU.KERNELS}}
    emit("train_quant_full_size", arch=cfg.name, n_layers=cfg.n_layers,
         batch=4, seq=512, remat=cfg.remat, launches=launches,
         peaks_vs_model=[dict(policy=k[2], quant=f"{k[3]}/{k[4]}",
                              peak_memory_gib=v / 2**30,
                              analytic_pgs_gib=analytic(
                                  cfg, "hift", k[2], frozen=k[3],
                                  moments=k[4]).pgs_gb)
                         for k, v in peaks.items()])
    if 0 in (launches["dequant_matmul"], launches["dequant_matmul_bf16"],
             launches["fused_adamw"]):
        raise RuntimeError(f"kernels never launched on the quantized "
                           f"training path: {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_train_quant_profile(torch, cfg, runner, batch, quant, policy):
    """Where a deep quantized step's time goes: a runner's next step (the
    NF4 fp32 runner's layer 2, the Mixed^Hi runner's layer 1: a backward
    through all but two or one of the layers) under ``torch.profiler``,
    with the dequant kernel's share of the device's busy time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        float(runner.train_step(batch))
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    prof_row = profile_summary(prof, 1e3 * host_s, top=10,
                               dequant_kernel_ms="dequant_matmul")
    emit("train_quant_profile", group=runner.last_metrics["group"],
         quant=quant, policy=policy, dequant_share_of_busy=prof_row[
             "dequant_kernel_ms"] / prof_row["device_busy_ms"], **prof_row)


# ------------------------------------------------------------ phases 13-16

# Decays per step: "slow" keeps the state alive across chunks (a_log in
# [-0.05, 0]), "published" is the reference init's spread
# (dt = softplus(N(0, 1)), A = -linspace(1, 16, H)).
SSM_CASES = [   # (case, dtype, B, S, H, decay); P = N = 64
    ("zamba2 prefill 4 x 512 fp32", "float32", 4, 512, 80, "slow"),
    ("zamba2 prefill 4 x 512 bf16", "bfloat16", 4, 512, 80, "slow"),
    ("one prompt 1 x 2048 fp32", "float32", 1, 2048, 80, "slow"),
    ("one prompt 1 x 2048 bf16", "bfloat16", 1, 2048, 80, "slow"),
    ("ragged 4 x 300 fp32", "float32", 4, 300, 80, "slow"),
    ("published decay 4 x 512 fp32", "float32", 4, 512, 80, "published"),
    ("small 1 x 37, 4 heads fp32", "float32", 1, 37, 4, "slow"),
]


def ssm_inputs(torch, dt, b, s, h, decay, gen, p=64, n=64):
    """(x, a_log, b, c) on the card: x ~ N(0, 1), b and c ~ N(0, 1/4) in
    ``dt``, a_log fp32 at the case's decay ("mlstm": the mLSTM's forget
    gate at its bias, log_sigmoid(N(0, 1) + 3))."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dt)
    if decay == "slow":
        a_log = -0.05 * torch.rand((b, s, h), generator=gen, device="cuda")
    elif decay == "mlstm":
        a_log = torch.nn.functional.logsigmoid(
            torch.randn((b, s, h), generator=gen, device="cuda") + 3.0)
    else:
        raw = torch.randn((b, s, h), generator=gen, device="cuda")
        rates = torch.linspace(1.0, 16.0, h, device="cuda")
        a_log = -torch.nn.functional.softplus(raw) * rates
    return (rnd(b, s, h, p), a_log, rnd(b, s, n, scale=0.5),
            rnd(b, s, n, scale=0.5))


def ssm_plain(x, a_log, b, c):
    """The kernel's plain version: the reference's chunked scan
    (``ref.gated_chunked_scan_ref``) in fp64 on the same inputs, y rounded
    to x's dtype once and the state to fp32.  In fp32 the reference's
    prefix sums of the decay lose ~1e-4 of y at the published init's fast
    heads (|cum| near 1700 in a chunk of 128), over ``TOL``; the kernel
    sums them in fp64.  (In bf16 the reference also rounds every product
    to bf16.)  The gap of the reference's own arithmetic to this plain
    version is reported beside each row."""
    from repro_torch.kernels import ref
    y, h = ref.gated_chunked_scan_ref(x.double(), a_log.double(), b.double(),
                                      c.double())
    return y.to(x.dtype), h.float()


def ssm_chunked_flops(s, p, n, lc):
    """FLOPs of the chunked scan per (batch row, head), in chunks of ``lc``
    rows (the last one as long as the data): per chunk of L rows the masked
    halves of C B^T and of its product with x, (N + P) L (L + 1), then C h^T
    and the state's new term, 4 L N P, and the decay of the entering state
    and its sum with the new term, 2 N P."""
    rows = [min(lc, s - t) for t in range(0, s, lc)]
    return sum((n + p) * r * (r + 1) + 4 * r * n * p + 2 * n * p
               for r in rows)


def ssm_work(dtype, b, s, h, p=64, n=64):
    """(FLOPs, bytes) that one scan needs, whatever a kernel's chunking:
    the fewer of the sequential recurrence's 5 N P a row (decay, outer
    product and sum into h; h . c) and the chunked form at its cheapest
    chunk length (8 rows at P = N = 64); x, a_log, b, c read once, y and
    h_final written once."""
    e = 2 if dtype == "bfloat16" else 4
    per_head = min([5 * s * n * p] + [ssm_chunked_flops(s, p, n, lc)
                                      for lc in range(1, s + 1)])
    nbytes = (2 * b * s * h * p * e + 4 * b * s * h + 2 * b * s * n * e
              + 4 * b * h * p * n)
    return b * h * per_head, nbytes


def phase_ssm_kernel(torch):
    """The SSM scan kernel against its plain version on the card, timed
    with its inputs rotated beyond L2, beside its bound; returns the first
    case's row of each instantiation (``ssm_scan`` fp32, ``ssm_scan_bf16``).
    The fp32 bound takes three TF32 products a product at TF32's rate (the
    kernel's route), with the CUDA cores' fp32 bound beside it.  No single
    PyTorch call computes a gated linear scan, so ``library_ms`` is null;
    the plain version (the chunked scan in eager ops) is no yardstick of
    speed either."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as S
    gen = torch.Generator(device="cuda").manual_seed(2024)
    results = {}
    for case, dtype, b, s, h, decay in SSM_CASES:
        dt = getattr(torch, dtype)
        args = ssm_inputs(torch, dt, b, s, h, decay, gen)
        got_y, got_h = S.ssm_scan(*args)
        want_y, want_h = ssm_plain(*args)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        errs = {}
        for what, got, want in (("y", got_y, want_y), ("h_final", got_h,
                                                        want_h)):
            got, want = got.float(), want.float()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"ssm_scan ({case}): non-finite {what}")
            err = (got - want).abs()
            errs[what] = float(err.max())
            if bool((err > tol + tol * want.abs()).any()):
                raise RuntimeError(f"ssm_scan ({case}): {what} max |err| "
                                   f"{errs[what]} over tolerance {tol}")
        # the reference's own arithmetic in the case's dtype (fp32 decay
        # prefix sums; in bf16 every product rounded) against the fp64
        # plain version: reported, not held to TOL
        flow_y, _ = ref.gated_chunked_scan_ref(*args)
        row_extra = dict(
            reference_flow_gap=float((flow_y.float()
                                      - want_y.float()).abs().max()),
            y_scale=float(want_y.float().abs().max()))
        del flow_y
        del got_y, got_h, want_y, want_h
        nbytes = sum(a.numel() * a.element_size() for a in args)
        sets = [args] + [ssm_inputs(torch, dt, b, s, h, decay, gen)
                         for _ in range(copies(nbytes) - 1)]
        ms = time_ms(torch, S.ssm_scan, sets)
        plain_ms = time_ms(torch, ssm_plain, sets, reps=3, launches=4)
        flops, wbytes = ssm_work(dtype, b, s, h)
        bound_ms, bound_by = bound(flops, wbytes, dtype)
        if dtype == "float32":
            # three TF32 passes; the CUDA cores' fp32 bound beside it
            row_extra["bound_cuda_cores_ms"] = bound_ms
            bound_ms, bound_by = bound(3 * flops, wbytes, "tf32")
            row_extra["products"] = "3xTF32 mma.sync"
        else:
            row_extra["products"] = "bf16 mma.sync, fp32 operands as pairs"
        row = dict(kernel=instance("ssm_scan", dtype), case=case, dtype=dtype,
                   shapes=dict(b=b, s=s, h=h, p=64, n=64), decay=decay,
                   max_abs_err=max(errs.values()), max_abs_err_y=errs["y"],
                   max_abs_err_h=errs["h_final"], tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms,
                   bound_by=bound_by, flops=flops, bytes=wbytes,
                   kernel_flops=b * h * ssm_chunked_flops(s, 64, 64, 64),
                   share_of_bound=bound_ms / ms, **row_extra)
        emit("kernel", **row)
        # each instantiation's first case is its main one
        results.setdefault(row["kernel"], row)
        del sets, args
        gc.collect()
        torch.cuda.empty_cache()
    return results


def hybrid_attention_cases():
    """Attention at zamba2's shared block: H = KV = 32, head dim 80; the
    hybrid prefill masks no pad (starts 0)."""
    zamba = dict(h=32, kvh=32, hd=80)
    lengths4 = [544, 520, 300, 33]
    return [
        ("flash_attention", "zamba2 shared-block prefill hd80", "bfloat16",
         dict(b=4, s=512, starts=[0] * 4, **zamba)),
        ("flash_attention", "zamba2 shared-block prefill hd80 fp32",
         "float32", dict(b=2, s=256, starts=[0] * 2, **zamba)),
        ("flash_decode", "zamba2 shared-block decode hd80", "bfloat16",
         dict(b=4, s=544, starts=[0] * 4, lengths=lengths4, **zamba)),
        ("flash_decode", "zamba2 shared-block decode hd80 fp32", "float32",
         dict(b=4, s=544, starts=[0] * 4, lengths=lengths4, **zamba)),
        ("paged_flash_decode", "paged decode hd80 (zamba2's widths)",
         "bfloat16", dict(b=4, bs=16, max_blocks=34, starts=[0] * 4,
                          lengths=lengths4, **zamba)),
        ("paged_flash_decode", "paged decode hd80 fp32 (zamba2's widths)",
         "float32", dict(b=4, bs=16, max_blocks=34, starts=[0] * 4,
                         lengths=lengths4, **zamba)),
    ]


def slow_decay(torch, params, seed: int = 7):
    """SSM scalars at a slow decay (A_log = log(U(0.02, 0.05)), dt_bias =
    -4: a step decays the state by ~1e-3), so the state entering each chunk
    and each decode step is large and a wrong carry shows."""
    m = params["layers"]["mamba"]
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(m["A_log"].shape, generator=g) * 0.03 + 0.02
    m["A_log"] = torch.log(u).to(m["A_log"].device)
    m["dt_bias"] = torch.full_like(m["dt_bias"], -4.0)


def phase_hybrid_card_vs_cpu(torch):
    """The same fp32 weights served on the CPU (plain versions) and the
    card (kernels): 12 layers (2 super-blocks) of zamba2-2.7b at full
    width, slow-decay SSM scalars, 4 prompts of mixed length (left pad
    unmasked, as in the reference), 8 new tokens; then the logits of one
    prefill and one decode step on both devices."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssm_scan as S
    from repro_torch.models import zamba2 as Z
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config("zamba2-2.7b"), n_layers=12)
    params = host_params(torch, cfg)
    slow_decay(torch, params)
    rng = np.random.default_rng(5)
    plens = [64, 37, 20, 50]
    prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
    out, secs = {}, {}
    for dev in ("cpu", "cuda"):
        eng = ServeEngine(cfg, params, max_len=72, batch=4,
                          compute_dtype=torch.float32, device=dev)
        S.reset_launches()                  # count the card's run only
        t0 = time.perf_counter()
        out[dev] = eng.generate(prompts, max_new_tokens=8)
        secs[dev] = time.perf_counter() - t0
        del eng
    fp32_launches = S.ssm_scan.launches - S.ssm_scan.launches_bf16
    toks = torch.from_numpy(np.stack([np.pad(p, (64 - len(p), 0))
                                      for p in prompts])).long()
    logits = {}
    for dev in ("cpu", "cuda"):
        p_dev = tree_map(lambda t: t.to(dev), params)
        cache = Z.init_cache(cfg, 4, 72, dtype=torch.float32, device=dev)
        lg, cache = Z.prefill(cfg, p_dev, {"tokens": toks.to(dev)}, cache,
                              torch.float32)
        nxt = lg[:, -1].argmax(-1, keepdim=True)
        lg2, cache = Z.decode_step(cfg, p_dev, cache, nxt, torch.float32)
        logits[dev] = (lg.cpu(), lg2.cpu(), cache["ssm"].cpu())
        del p_dev, cache
    gaps = [float((a - b).abs().max())
            for a, b in zip(logits["cpu"], logits["cuda"])]
    same = out["cpu"] == out["cuda"]
    emit("hybrid_card_vs_cpu", n_layers=cfg.n_layers, d_model=cfg.d_model,
         prompts=plens, new_tokens=8, tokens_equal=same,
         max_logit_gap_prefill=gaps[0], max_logit_gap_decode=gaps[1],
         max_ssm_state_gap=gaps[2],
         ssm_state_scale=float(logits["cpu"][2].abs().max()),
         seconds=secs, cpu_tokens=out["cpu"], cuda_tokens=out["cuda"],
         ssm_scan_launches=fp32_launches)
    if not same:
        raise RuntimeError(f"card and CPU hybrid greedy tokens differ: {out}")
    if fp32_launches != cfg.n_layers:           # one prefill of 12 layers
        raise RuntimeError(f"the fp32 hybrid serving run launched the scan "
                           f"{fp32_launches} times, expected {cfg.n_layers}")
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()


def phase_hybrid_full(torch, dtype: str = "bfloat16", max_new: int = 32,
                      n_layers=None):
    """zamba2-2.7b at full width in ``dtype`` (at ``n_layers``, a multiple
    of ``attn_every``; None: full depth), random weights
    from seed 0, through ``ServeEngine``: batch 4, prompts of 128-512
    tokens, ``max_new`` new tokens, max_len 544.  After one warm-up run of
    the same requests, the kernels' launches are counted over a second
    run, which is timed, and returned by instantiation (``instance``);
    then prefill and decode-step times and profiles
    (``phase_hybrid_timing``)."""
    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ssm_scan as S
    from repro_torch.models import zamba2 as Z
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("zamba2-2.7b")
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dt = getattr(torch, dtype)
    bf16 = dtype == "bfloat16"
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = Z.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=dt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    plens = [int(n) for n in rng.integers(128, 513, 4)]
    prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
    max_len = 544
    eng = ServeEngine(cfg, params, max_len=max_len, batch=4,
                      compute_dtype=dt, device="cuda")
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=max_new)       # warm up
    torch.cuda.synchronize()
    cold_wall = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                   # count the main path's run only
    S.reset_launches()
    t0 = time.perf_counter()
    outs = eng.generate(prompts, max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scan, prefill = instance("ssm_scan", dtype), instance("flash_attention",
                                                          dtype)
    tc, bf = K.flash_attention.launches_tc, S.ssm_scan.launches_bf16
    launches = {scan: bf if bf16 else S.ssm_scan.launches - bf,
                prefill: tc if bf16 else K.flash_attention.launches - tc,
                "flash_decode": K.flash_decode.launches}
    if launches[scan] != S.ssm_scan.launches:
        raise RuntimeError(f"{dtype} hybrid serving ran the other scan")
    if launches[prefill] != K.flash_attention.launches:
        raise RuntimeError(f"{dtype} hybrid serving ran the other prefill "
                           "kernel")
    peak = torch.cuda.max_memory_allocated()
    for toks in outs:
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_padded
                                           for t in toks):
            raise RuntimeError(f"bad generation {toks}")
    n_sb = cfg.n_layers // cfg.attn_every
    expect = {scan: cfg.n_layers, prefill: n_sb,
              "flash_decode": n_sb * (max_new - 1)}
    emit("hybrid_full_size" if bf16 else "hybrid_full_size_fp32",
         arch=cfg.name, n_layers=cfg.n_layers, dtype=dtype, init_s=init_s,
         params_bytes=tree_bytes(params),
         prompt_lens=plens, new_tokens=max_new, max_len=max_len,
         cold_wall_s=cold_wall, wall_s=wall,
         tokens_per_s=len(prompts) * max_new / wall,
         peak_memory_bytes=peak, peak_memory_gib=peak / 2**30,
         launches=launches, expected_launches=expect)
    if launches != expect:
        raise RuntimeError(f"hybrid serving launched {launches}, expected "
                           f"{expect}")
    phase_hybrid_timing(torch, cfg, eng.params, prompts, dt)
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_hybrid_timing(torch, cfg, params, prompts, dt, rounds: int = 5,
                        steps: int = 8):
    """Prefill and decode-step times on the host clock, then
    ``torch.profiler`` over one prefill and over 8 decode steps.  The
    prefill is the median of 3 after a warm-up, each ended by a
    synchronise.  The decode step is timed as ``generate`` runs it, with no
    synchronise between steps: after 4 warm-up steps, ``rounds`` rounds of
    ``steps`` steps, each round ended by one synchronise; the host's CPU
    time over each round (``process_time``) beside its wall time shows
    whether the process waited for a core."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import zamba2 as Z
    plen = max(len(p) for p in prompts)
    toks = torch.tensor(np.stack([np.pad(p, (plen - len(p), 0))
                                  for p in prompts]), device="cuda")
    max_len = plen + 4 + (rounds + 1) * steps

    def prefill():
        cache = Z.init_cache(cfg, len(prompts), max_len, dtype=dt,
                             device="cuda")
        return Z.prefill(cfg, params, {"tokens": toks}, cache, dt)

    def decode(n, cache, tok):
        for _ in range(n):
            logits, cache = Z.decode_step(cfg, params, cache, tok, dt)
            tok = logits[:, -1].argmax(-1, keepdim=True)
        return cache, tok

    prefill_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill()
        torch.cuda.synchronize()
        prefill_ms.append(1e3 * (time.perf_counter() - t0))
    tok = logits[:, -1].argmax(-1, keepdim=True)
    cache, tok = decode(4, cache, tok)                  # warm up
    step_ms, cpu_share = [], []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        cache, tok = decode(steps, cache, tok)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms.append(1e3 * wall / steps)
        cpu_share.append((time.process_time() - c0) / wall)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    prefill_prof = profile_summary(prof, host_ms, ssm_scan_ms="ssm_scan",
                                   attention_ms="flash_attention")
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        cache, tok = decode(steps, cache, tok)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0) / steps
    decode_prof = profile_summary(prof, host_ms, steps,
                                  attention_ms="flash_decode")
    emit("hybrid_timing", arch=cfg.name, dtype=str(dt).split(".")[-1],
         batch=len(prompts), prompt=plen,
         prefill_ms=prefill_ms[1:], prefill_ms_median=statistics.median(
             prefill_ms[1:]), decode_step_ms_rounds=step_ms,
         decode_step_ms_median=statistics.median(step_ms),
         decode_step_ms_min=min(step_ms), decode_step_ms_max=max(step_ms),
         host_cpu_share_rounds=cpu_share,
         cpu_cores=len(os.sched_getaffinity(0)),
         prefill_profile=prefill_prof, decode_profile=decode_prof)


# ------------------------------------------------------------ moe, vlm and
# the last dense configs

def vlm_attention_cases():
    """The prefill and the contiguous decode with internvl2-26b's 256
    vision tokens in front of ragged left pads (48 heads over 8, head dim
    128), bf16 and fp32, and the decode at smollm-360m's GQA of 3 (15
    heads over 5, head dim 64), bf16 and fp32."""
    vl = dict(h=48, kvh=8, hd=128, prefix=256)
    smol = dict(h=15, kvh=5, hd=64)
    starts4 = [0, 37, 100, 5]
    return [
        ("flash_attention", "internvl2-26b prefill, 256 vision tokens + "
         "ragged pad", "bfloat16",
         dict(b=4, s=768, starts=[0, 50, 120, 400], **vl)),
        ("flash_attention", "internvl2-26b prefill fp32, 256 vision tokens "
         "+ ragged pad", "float32",
         dict(b=2, s=512, starts=[0, 75], **vl)),
        ("flash_decode", "internvl2-26b decode, 256 vision tokens + ragged "
         "pad", "bfloat16",
         dict(b=4, s=800, starts=starts4, lengths=[800, 776, 556, 289],
              **vl)),
        ("flash_decode", "internvl2-26b decode fp32, 256 vision tokens + "
         "ragged pad", "float32",
         dict(b=4, s=800, starts=starts4, lengths=[800, 776, 556, 289],
              **vl)),
        ("flash_decode", "smollm-360m GQA-3 decode", "bfloat16",
         dict(b=4, s=544, starts=starts4, lengths=[544, 520, 300, 33],
              **smol)),
        ("flash_decode", "smollm-360m GQA-3 decode fp32", "float32",
         dict(b=4, s=544, starts=starts4, lengths=[544, 520, 300, 33],
              **smol)),
    ]


MOE_LR = 1e-4              # card against CPU
MOE_SEQ = 64               # batch 2 x MOE_SEQ
MOE_RTOL = 1e-4            # card against CPU: losses and grad norms
# The card-against-CPU moe runs compare params on a sample: every
# MOE_SAMPLE-th element of each leaf (the CPU side may run in another
# process, and the whole trees are 6.4 GB a run).
MOE_SAMPLE = 97


def route_flips(a: list, b: list) -> int:
    """(token, slot) routes that differ between two recordings of the
    same runs (``models.moe.recording_routes``, as numpy arrays)."""
    if len(a) != len(b):
        return sum(int(x.size) for x in a)
    return sum(int((x != y).sum()) for x, y in zip(a, b))


def _sample(t):
    return t.detach().reshape(-1)[::MOE_SAMPLE].float().cpu().numpy()


def cpu_normal(torch, shape, seed: int, chunk: int = 1 << 22):
    """Standard normal fp32 of ``shape`` from ``seed``, drawn on the CPU in
    pieces of ``chunk`` elements, each from a generator of its own seeded
    by (``seed``, piece), on 8 threads: the same values in any process,
    several times faster than one generator's serial draw of a slice of
    hundreds of millions of elements."""
    from concurrent.futures import ThreadPoolExecutor
    out = torch.empty(math.prod(shape))

    def fill(i: int) -> None:
        gen = torch.Generator().manual_seed(
            (seed * 1_000_003 + i) & (2**63 - 1))
        out[i * chunk:(i + 1) * chunk].normal_(generator=gen)

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(fill, range(-(-out.numel() // chunk))))
    return out.view(shape)


def cpu_noise(torch, shapes: dict):
    """MeZO's seam for the card-against-CPU runs: each slice's z drawn on
    the CPU (``cpu_normal``) from the port's own seed of (key, step, path,
    index) and kept, so two processes draw the same z and the card's run
    copies it over."""
    from repro_torch.optim.mezo import noise_seed
    kept = {}

    def at(rng, step):
        key = (*(int(w) for w in rng), step)

        def z(path, index):
            if (key, path, index) not in kept:
                shape = shapes[path][1:] if index is not None \
                    else shapes[path]
                kept[key, path, index] = cpu_normal(
                    torch, shape, noise_seed(key, path, index))
            return kept[key, path, index]
        return z
    return at


def moe_train_runs(torch, cfgs=None):
    """The runs of the moe card-against-CPU phase: (cfg, label, strategy,
    runner kwargs, steps, param tolerance).  2 layers of deepseek-moe-16b
    at full width: ``hift`` (m = 1, AdamW: embed, layer 0, layer 1,
    head), ``lomo`` (clip 1.0), ``adalomo``, ``mezo`` (``cpu_noise``);
    one HiFT step of arctic-480b's SMOKE twin."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HiFTConfig, LOMOConfig
    from repro_torch.models import moe as M
    cfg, arctic = cfgs or (
        dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2),
        get_config("arctic-480b", smoke=True))
    shapes = {p: tuple(t.shape) for p, t in
              _flat(M.init(cfg, torch.Generator(), device="meta")).items()}
    hift = dict(hift=HiFTConfig(m=1), optimizer="adamw")
    hift_tol = 2 * MOE_LR + 1e-6       # AdamW's sign-like first update
    return [(cfg, "hift", "hift", hift, 4, hift_tol),
            (cfg, "lomo", "lomo", dict(lomo=LOMOConfig(grad_clip=1.0)), 1,
             FUSED_PARAM_TOL["lomo"]),
            (cfg, "adalomo", "adalomo", {}, 1, 2 * MOE_LR),
            (cfg, "mezo", "mezo", dict(noise=cpu_noise(torch, shapes)), 1,
             6 * MOE_LR),
            (arctic, "arctic_hift", "hift", hift, 1, hift_tol)]


def _flat(tree):
    from repro_torch.common.pytree import flatten_with_paths
    return flatten_with_paths(tree)


def moe_train_side(torch, runs, dev: str) -> dict:
    """One device's side of the moe card-against-CPU runs, from the params
    of seed 0 drawn on the CPU: per run the losses, grad norms, groups,
    routes, seconds and a sample of the final params; for ``adalomo`` also
    (on the card) where the starting gradient exceeds 1e-4 on that
    sample."""
    from repro_torch.core import LRSchedule, make_runner
    from repro_torch.models import moe as M
    out, params = {}, {}
    for cfg, label, strategy, kw, n, _ in runs:
        if cfg.name not in params:
            params = {cfg.name: M.init(cfg, torch.Generator().manual_seed(0),
                                       device="cpu", dtype=torch.float32)}
        p0 = params[cfg.name]
        batches = train_batches(cfg, MOE_SEQ, 2, n, "cpu")
        runner = make_runner(cfg, strategy, params=p0, device=dev,
                             schedule=LRSchedule(base_lr=MOE_LR), **kw)
        t0 = time.perf_counter()
        losses, norms, groups = [], [], []
        with M.recording_routes() as routes:
            for b in batches:
                losses.append(float(runner.train_step(b)))
                g = runner.last_metrics.get("grad_norm")
                norms.append(None if g is None else float(g))
                groups.append(runner.last_metrics.get("group"))
        secs = time.perf_counter() - t0
        row = dict(losses=losses, norms=norms, groups=groups, seconds=secs,
                   routes=[r.cpu().numpy() for r in routes],
                   params={k: _sample(t) for k, t in
                           _flat(runner.params).items()})
        del runner, routes
        if strategy == "adalomo" and dev != "cpu":
            row["mask"] = _grad_above(torch, cfg, p0, batches[0], dev)
        out[label] = row
    return out


def _grad_above(torch, cfg, params, batch, dev, floor: float = 1e-4):
    """Where FPFT's starting gradient (on ``dev``) exceeds ``floor``, on
    the params' sample."""
    from repro_torch.common.pytree import unflatten_from_paths
    from repro_torch.models import get_family
    flat = {k: t.detach().to(dev).requires_grad_(True)
            for k, t in _flat(params).items()}
    loss = get_family(cfg).loss_fn(cfg, unflatten_from_paths(flat),
                     {k: v.to(dev) for k, v in batch.items()},
                     compute_dtype=torch.float32)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return {k: np.abs(_sample(g)) > floor for k, g in zip(flat, grads)}


def train_gaps(x: dict, y: dict):
    """Two devices' sides of one card-against-CPU run: the largest
    relative loss and grad-norm gaps, the params' sample gap (where the
    starting gradient exceeds 1e-4 when a side carries that ``mask``), the
    same unmasked, and the leaf with the largest gap."""
    rel = max(abs(p - q) / abs(p) for p, q in zip(x["losses"], y["losses"]))
    nrel = (max(abs(p - q) / abs(p) for p, q in zip(x["norms"], y["norms"]))
            if x["norms"][0] is not None else 0.0)
    diff = {k: np.abs(x["params"][k] - y["params"][k]) for k in x["params"]}
    gap_all = max(float(d.max()) for d in diff.values())
    worst = max(diff, key=lambda k: float(diff[k].max()))
    mask = y.get("mask") or x.get("mask")
    gap = gap_all if mask is None else max(
        float(d[mask[k]].max()) if mask[k].any() else 0.0
        for k, d in diff.items())
    return rel, nrel, gap, gap_all, worst


def compare_moe_train(torch, runs, sides: dict, devices) -> None:
    """Emits a ``train_moe_card_vs_cpu`` line a run; raises where the
    devices differ: losses and grad norms beyond ``MOE_RTOL`` relative,
    the params' sample beyond the run's tolerance (``adalomo``'s where the
    starting gradient exceeds 1e-4, the reference's own bar for its moe
    pieces: the factored update divides a near-zero gradient by its row's
    and column's near-zero moments, so rounding moves such an element by
    several lr, 6.5e-4 at lr 1e-4 seen unmasked)."""
    a, b = (sides[d] for d in devices)
    for cfg, label, strategy, _, n, param_tol in runs:
        x, y = a[label], b[label]
        rel, nrel, gap, gap_all, worst = train_gaps(x, y)
        flips = route_flips(x["routes"], y["routes"])
        emit("train_moe_card_vs_cpu", arch=cfg.name, run=label,
             n_layers=cfg.n_layers, d_model=cfg.d_model,
             n_experts=cfg.n_experts, top_k=cfg.top_k, batch=2, seq=MOE_SEQ,
             lr=MOE_LR, groups=x["groups"], cpu_losses=x["losses"],
             cuda_losses=y["losses"], cpu_grad_norms=x["norms"],
             cuda_grad_norms=y["norms"], max_rel_loss_gap=rel,
             max_rel_grad_norm_gap=nrel, rtol=MOE_RTOL, max_param_gap=gap,
             max_param_gap_unmasked=gap_all, worst_leaf=worst,
             param_sample=f"every {MOE_SAMPLE}th element",
             param_tol=param_tol, route_flips=flips,
             routes=sum(int(r.size) for r in x["routes"]),
             cpu_seconds=x["seconds"], cuda_seconds=y["seconds"])
        if (not all(math.isfinite(v) for v in y["losses"])
                or rel > MOE_RTOL or nrel > MOE_RTOL or gap > param_tol):
            raise RuntimeError(f"{cfg.name} {label}: card and CPU differ: "
                               f"losses {x['losses']} {y['losses']}, norms "
                               f"{x['norms']} {y['norms']}, param gap {gap} "
                               f"({worst}), route flips {flips}")


def phase_train_moe_card_vs_cpu(torch, cfgs=None, devices=("cpu", "cuda")):
    """moe training, card against CPU, from the same fp32 params
    (``moe_train_runs``): 2 layers of deepseek-moe-16b at full width (64
    experts top-6, 2 shared, d 2048, expert ff 1408, vocab 102400), batch
    2 x 64, then arctic-480b's SMOKE twin (the parallel dense residual
    FFN); ``compare_moe_train``'s gates, the routes that flip counted.
    ``phase_moe_vlm`` runs the CPU's side in a child process beside the
    card's phases; here each device's side runs in turn, and ``cfgs`` /
    ``devices`` let the phase run small on the CPU alone."""
    runs = moe_train_runs(torch, cfgs)
    sides = {dev: moe_train_side(torch, runs, dev) for dev in set(devices)}
    compare_moe_train(torch, runs, sides, devices)
    gc.collect()


def encoded_init(torch, cfg, fmt: str, seed: int = 0):
    """A random ``cfg`` tree codec-encoded on the card one leaf at a time,
    so the whole fp32 tree never exists (internvl2-26b's is 104 GB): each
    leaf drawn as the family's ``init`` draws it (normal / sqrt(fan_in),
    the embedding x 0.02, unit norm scales, zero biases), encoded, its
    fp32 copy freed.  Other numbers than ``init`` from the same seed."""
    from repro_torch.common.pytree import (flatten_with_paths,
                                           unflatten_from_paths)
    from repro_torch.core.memory_model import param_shapes
    from repro_torch.dist.quant import quantizable, quantize_leaf
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    flat = {}
    for path, meta in flatten_with_paths(param_shapes(cfg)).items():
        leaf = path.split("/")[-1]
        if leaf == "scale":
            t = torch.ones(meta.shape, device="cuda")
        elif leaf.startswith("b"):
            t = torch.zeros(meta.shape, device="cuda")
        else:
            t = torch.randn(meta.shape, generator=gen, device="cuda")
            t.mul_(0.02 if leaf == "tok" else 1 / math.sqrt(meta.shape[-2]))
        flat[path] = quantize_leaf(t, fmt) if quantizable(t) else t
        del t
    torch.cuda.synchronize()
    return unflatten_from_paths(flat)


def pinned_bundle_bytes(torch, runner) -> int:
    """Bytes of the optimizer bundles held in pinned host memory."""
    from repro_torch.common.pytree import flatten_with_paths
    return sum(t.numel() * t.element_size() for t in
               flatten_with_paths(runner.opt_state).values()
               if isinstance(t, torch.Tensor) and t.is_pinned())


def _hift_steps(torch, cfg, params, batches, steps, timer, tag):
    """fp32 HiFT m=1 (AdamW, fused) steps: ``steps`` is ((order, n), ..);
    one line a step with its analytic P+G+S and the pinned bundle
    bytes."""
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    rows = []
    pgs = analytic(cfg).pgs_gb
    for order, n in steps:
        runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                             hift=HiFTConfig(m=1, strategy=order),
                             schedule=LRSchedule(base_lr=1e-5),
                             device="cuda")
        for _ in range(n):
            row = fused_step(torch, runner, batches[len(rows) % len(batches)],
                             timer=timer)
            row["pinned_bundle_bytes"] = pinned_bundle_bytes(torch, runner)
            rows.append(row)
            emit(tag, arch=cfg.name, strategy="hift", order=order,
                 analytic_pgs_gib=pgs,
                 over_analytic_gib=row["peak_allocated_gib"] - pgs, **row)
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_train_moe_full(torch):
    """deepseek-moe-16b at its published config (28 layers, 64 routed
    experts top-6 + 2 shared, 16.9 B params), random weights from seed 0,
    batch 4 x 512:

    - fp32 HiFT m=1, AdamW (fused, trained in place): the embed step (a
      backward through all 28 layers) and layer 0 (bottom2up), then the
      head and layer 27 (top2down): host ms, peak allocated and reserved
      beside the analytic P+G+S, the update kernel's device ms, the
      pinned host bytes of the visited bundles; the analytic FPFT figure
      and saving beside the measured HiFT peak (FPFT cannot run on one
      card);
    - ``lomo`` (clip 1.0) and ``mezo``, one step each: a peak more than
      ``FUSED_ALLOWANCE_GIB`` over the analytic P+G+S fails the run;
    - NF4 HiFT (bf16 moments) from a tree encoded leaf by leaf: the embed
      step and layer 0, with the dequant kernel's device ms and launches.

    Returns the kernels' launches over the HiFT runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LOMOConfig, LRSchedule, QuantConfig, \
        make_runner
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.models import moe as M
    cfg = get_config("deepseek-moe-16b")
    batches = train_batches(cfg, 512, 4, 2, "cuda")
    gc.collect()
    torch.cuda.empty_cache()
    params = M.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=torch.float32)
    with UpdateTimer(torch) as timer:   # counts the main path's run only
        rows = _hift_steps(torch, cfg, params, batches,
                           (("bottom2up", 2), ("top2down", 2)), timer,
                           "train_moe_step")
        launches = timer.launches()
    report = analytic(cfg)
    hift_pgs, fpft = report.pgs_gb, analytic(cfg, "fpft").pgs_gb
    peak = max(r["peak_allocated_gib"] for r in rows)
    emit("train_moe_memory", arch=cfg.name, dtype="float32", batch=4,
         seq=512, n_params=report.n_params, hift_peak_gib=peak,
         hift_analytic_gib=hift_pgs, fpft_analytic_gib=fpft,
         analytic_saving=1 - hift_pgs / fpft,
         saving_vs_analytic_fpft=1 - peak / fpft,
         card_gib=torch.cuda.get_device_properties(0).total_memory / 2**30,
         host_ms=[r["host_ms"] for r in rows])
    sched = LRSchedule(base_lr=1e-5)
    for strategy, kw in (("lomo", {"lomo": LOMOConfig(grad_clip=1.0)}),
                         ("mezo", {})):
        runner = make_runner(cfg, strategy, params=params, schedule=sched,
                             device="cuda", **kw)
        st = runner.strategy
        pgs = analytic(cfg, st.memory_mode, m=st.memory_m).pgs_gb
        row = fused_step(torch, runner, batches[0])
        emit("train_moe_step", arch=cfg.name, strategy=strategy,
             m=st.memory_m, analytic_pgs_gib=pgs,
             over_analytic_gib=row["peak_allocated_gib"] - pgs, **row)
        if row["peak_allocated_gib"] - pgs > FUSED_ALLOWANCE_GIB:
            raise RuntimeError(f"{cfg.name} {strategy}: peak "
                               f"{row['peak_allocated_gib']:.2f} GiB exceeds "
                               f"the analytic {pgs:.2f} GiB by more than "
                               f"{FUSED_ALLOWANCE_GIB} GiB")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    del params
    quant = QuantConfig("nf4", "bf16")
    params = encoded_init(torch, cfg, "nf4")
    with UpdateTimer(torch) as timer, UpdateTimer(torch, DM) as dq:
        _nf4_steps(torch, cfg, params, batches, timer, dq, quant,
                   "train_moe_quant_step")
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
    del params
    launches["dequant_matmul"] = DM.dequant_matmul.launches - \
        DM.dequant_matmul.launches_tc
    if not launches["dequant_matmul"]:
        raise RuntimeError("NF4 moe HiFT never launched the dequant kernel")
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_moe_launches", launches=launches)
    return launches


def _nf4_steps(torch, cfg, params, batches, timer, dq, quant, tag) -> None:
    """NF4 HiFT m=1 (bf16 moments, AdamW fused): the embed step and layer
    0, one line each with the dequant kernel's device ms and launches."""
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                         hift=HiFTConfig(m=1), quant=quant,
                         schedule=LRSchedule(base_lr=1e-5), device="cuda")
    pgs = analytic(cfg, frozen=quant.frozen, moments=quant.moments).pgs_gb
    for i in range(2):
        dq.take()
        row = fused_step(torch, runner, batches[i % len(batches)],
                         timer=timer)
        row["dequant_kernel_ms"], row["dequant_launches"] = dq.take()
        row["pinned_bundle_bytes"] = pinned_bundle_bytes(torch, runner)
        emit(tag, arch=cfg.name, n_layers=cfg.n_layers, fmt=quant.frozen,
             moments=quant.moments, analytic_pgs_gib=pgs,
             over_analytic_gib=row["peak_allocated_gib"] - pgs, **row)
    del runner
    gc.collect()
    torch.cuda.empty_cache()


def vlm_batches(cfg, seq, batch, n, device):
    """Token batches with the stub frontend's ``vision_embeds``
    (``data.synthetic.VisionStubLM``)."""
    from repro_torch.data.synthetic import (DataConfig, SyntheticLM,
                                            VisionStubLM)
    data = VisionStubLM(SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=0),
        device=device), cfg.vision_tokens, cfg.d_model)
    return [data.batch_at(s) for s in range(n)]


# Layers of internvl2-26b's NF4 training on the card (at all 48 its two
# steps took 19.9 s of the whole script's 760.0 on an H100)
VLM_TRAIN_LAYERS = 16


def phase_train_dense_vlm_full(torch):
    """The last dense configs and the vlm backbone at full size, batch
    4 x 512, HiFT m=1, AdamW (fused), random weights from seed 0:
    deepseek-7b fp32 (the embed step, a backward through all 30 layers,
    then the head with its 102,400-row CE blocks), internlm2-1.8b and
    smollm-360m fp32 (embed and layer 0), and internvl2-26b at its width
    and ``VLM_TRAIN_LAYERS`` of its 48 layers under NF4 residency with
    bf16 moments (its fp32 tree does not fit): the embed step and layer 0
    with 256 vision tokens in front of 512 text tokens, the dequant
    kernel's ms and launches.  Each step's peak beside the analytic P+G+S.
    Returns the kernels' launches over the run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import QuantConfig
    from repro_torch.kernels import dequant_matmul as DM
    launches = {"fused_adamw": 0}
    with UpdateTimer(torch) as timer:
        for arch, steps in (("deepseek-7b", (("bottom2up", 1),
                                             ("top2down", 1))),
                            ("internlm2-1.8b", (("bottom2up", 2),)),
                            ("smollm-360m", (("bottom2up", 2),))):
            cfg = get_config(arch)
            params = fresh_params(torch, cfg)
            _hift_steps(torch, cfg, params, train_batches(cfg, 512, 4, 2,
                                                          "cuda"),
                        steps, timer, "train_dense_step")
            del params
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
    cfg = dataclasses.replace(get_config("internvl2-26b"),
                              n_layers=VLM_TRAIN_LAYERS)
    quant = QuantConfig("nf4", "bf16")
    params = encoded_init(torch, cfg, "nf4")
    batches = vlm_batches(cfg, 512, 4, 2, "cuda")
    with UpdateTimer(torch) as timer, UpdateTimer(torch, DM) as dq:
        _nf4_steps(torch, cfg, params, batches, timer, dq, quant,
                   "train_vlm_quant_step")
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
    del params
    launches["dequant_matmul"] = DM.dequant_matmul.launches - \
        DM.dequant_matmul.launches_tc
    if not launches["dequant_matmul"]:
        raise RuntimeError("NF4 vlm HiFT never launched the dequant kernel")
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_dense_vlm_launches", launches=launches)
    return launches


def phase_serve_moe_vlm_full(torch, max_new: int = 16):
    """``ServeEngine`` in bf16, 4 ragged prompts of 128-512 tokens, 16 new
    tokens each, at full size, random weights from seed 0:
    deepseek-moe-16b (33.8 GB of weights; capacity dispatch in the
    prefill, the dropless expert gather in decode), internvl2-26b (39.7
    GB; 256 zero vision embeddings in front of the left pad) and
    smollm-360m (also through ``ContinuousServeEngine``).  Host-clock
    prefill ms (a 1-token generation), decode-step ms ((16-token run -
    prefill) / 15) and tokens/s, one warm-up call first, and the attention
    kernels' launches over the timed runs.  Returns those launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models import get_family
    from repro_torch.serve.engine import ServeEngine
    rng = np.random.default_rng(12)
    total = {}
    for arch in ("deepseek-moe-16b", "internvl2-26b", "smollm-360m"):
        cfg = get_config(arch)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        params = get_family(cfg).init(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda", dtype=torch.bfloat16)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        plens = [int(n) for n in rng.integers(128, 513, 4)]
        prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
        eng = ServeEngine(cfg, params, batch=4,
                          max_len=cfg.vision_tokens + max(plens) + max_new,
                          compute_dtype=torch.bfloat16, device="cuda")
        eng.generate(prompts, max_new_tokens=2)          # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()                 # count the timed runs only
        t0 = time.perf_counter()
        eng.generate(prompts, max_new_tokens=1)
        prefill_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = eng.generate(prompts, max_new_tokens=max_new)
        run_s = time.perf_counter() - t0
        launches = {"flash_attention": K.flash_attention.launches_tc,
                    "flash_decode": K.flash_decode.launches}
        cont = None
        if cfg.family == "dense":
            ceng, cout, fixed, t_cont, _ = serve_both(
                torch, cfg, params, prompts, max_new, torch.bfloat16, "cuda",
                slots=4, prefill_bucket=128,
                max_blocks=-(-(512 + max_new) // 16))
            launches["paged_flash_decode"] = K.paged_flash_decode.launches
            cont = dict(wall_s=t_cont,
                        tokens_per_s=len(prompts) * max_new / t_cont,
                        decode_step_ms_median=1e3 * statistics.median(
                            ceng.decode_seconds),
                        engines_agree=sum(a == b for a, b in
                                          zip(cout, fixed)))
            del ceng
        if K.flash_attention.launches != K.flash_attention.launches_tc:
            raise RuntimeError(f"{arch}: bf16 serving ran the fp32 prefill")
        for toks in out:
            if len(toks) != max_new or not all(0 <= t < cfg.vocab_padded
                                               for t in toks):
                raise RuntimeError(f"{arch}: bad generation {toks}")
        missing = [k for k, n in launches.items() if n == 0]
        if missing:
            raise RuntimeError(f"{arch}: kernels never launched: {missing}")
        leaves = list(_flat(params).values())
        emit("serve_moe_vlm_full", arch=arch, family=cfg.family,
             dtype="bfloat16", init_s=init_s, prompt_lens=plens,
             vision_tokens=cfg.vision_tokens, new_tokens=max_new,
             prefill_ms=1e3 * prefill_s,
             decode_step_ms=1e3 * (run_s - prefill_s) / (max_new - 1),
             tokens_per_s=len(prompts) * max_new / run_s,
             weights_gb=sum(t.numel() * t.element_size() for t in
                            leaves) / 1e9,
             n_params=sum(t.numel() for t in leaves),
             peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
             launches=launches, continuous=cont)
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        del eng, params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return total


def moe_vlm_serve_sides(torch, devices, smoke: bool = False) -> dict:
    """Each device's side of the moe/vlm card-against-CPU serving, {dev:
    {arch: ..}}: per arch (2 layers at deepseek-moe-16b's and
    internvl2-26b's width, fp32, the params of seed 0 drawn on the CPU
    once for both) the greedy tokens of 4 prompts of mixed length (8 new
    tokens), the routes and the seconds."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import moe as M
    from repro_torch.serve.engine import ServeEngine
    rng = np.random.default_rng(6)
    out = {dev: {} for dev in devices}
    for arch in ("deepseek-moe-16b", "internvl2-26b"):
        cfg = dataclasses.replace(get_config(arch, smoke=smoke), n_layers=2)
        params = host_params(torch, cfg, "cuda" in devices)
        plens = [64, 37, 20, 50]
        prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
        for dev in out:
            eng = ServeEngine(cfg, params, batch=4,
                              max_len=cfg.vision_tokens + 72,
                              compute_dtype=torch.float32, device=dev)
            t0 = time.perf_counter()
            with M.recording_routes() as rec:
                toks = eng.generate(prompts, max_new_tokens=8)
            out[dev][arch] = dict(name=cfg.name, n_layers=cfg.n_layers,
                                  d_model=cfg.d_model, prompts=plens,
                                  tokens=toks,
                                  routes=[r.cpu().numpy() for r in rec],
                                  seconds=time.perf_counter() - t0)
            del eng, rec
        del params
        gc.collect()
    return out


def phase_serve_moe_vlm_card_vs_cpu(torch, smoke=False,
                                    devices=("cpu", "cuda")):
    """The same fp32 weights served on the CPU (plain versions) and the
    card (kernels), ``ServeEngine`` (``moe_vlm_serve_sides``): 2 layers at
    deepseek-moe-16b's width (left pad unmasked, as the reference serves
    moe; the routes of both runs recorded) and at internvl2-26b's (256
    zero vision embeddings, then the left pad, masked).  The greedy tokens
    must be equal, or the report must show a route that flipped between
    the devices.  ``smoke`` / ``devices`` let the phase run small on the
    CPU alone."""
    sides = moe_vlm_serve_sides(torch, dict.fromkeys(devices), smoke)
    a, b = (sides[d] for d in devices)
    for arch, x in a.items():
        y = b[arch]
        flips = route_flips(x["routes"], y["routes"])
        same = x["tokens"] == y["tokens"]
        emit("serve_moe_vlm_card_vs_cpu", arch=x["name"],
             n_layers=x["n_layers"], d_model=x["d_model"],
             prompts=x["prompts"], new_tokens=8, tokens_equal=same,
             route_flips=flips,
             routes=sum(int(r.size) for r in x["routes"]),
             seconds={"cpu": x["seconds"], "cuda": y["seconds"]},
             cpu_tokens=x["tokens"], cuda_tokens=y["tokens"])
        if not same and not flips:
            raise RuntimeError(f"{arch}: card and CPU greedy tokens differ "
                               f"with no route flip: {x['tokens']} "
                               f"{y['tokens']}")


# ------------------------------------------------------------ encdec

ENCDEC_LR = 1e-4           # card against CPU
ENCDEC_FRAMES = 64         # batch 2 x 64 source frames
ENCDEC_SEQ = 32            # and 2 x 32 target tokens
ENCDEC_RTOL = 1e-4         # card against CPU: losses and grad norms


def encdec_attention_cases():
    """seamless-m4t-large-v2's attention (16 heads over 16, head dim 64)
    in bf16 and fp32: the encoder's non-causal prefill (4 x 512, Sk = S),
    the prompt's cross attention (4 x 64 queries over 512 memory keys), a
    ragged cross case (4 x 37 over 300: the last q tile and the last key
    tile both partial) and the decode step's cross attention (4 queries
    over 512 memory keys)."""
    sm = dict(h=16, kvh=16, hd=64)
    cases = []
    for dt, tag in (("bfloat16", ""), ("float32", " fp32")):
        cases += [
            ("flash_attention", f"seamless encoder prefill{tag} (non-causal, "
             "4 x 512)", dt, dict(b=4, s=512, sk=512, causal=False, **sm)),
            ("flash_attention", f"seamless cross attention{tag} (4 x 64 over "
             "512 keys)", dt, dict(b=4, s=64, sk=512, causal=False, **sm)),
            ("flash_attention", f"seamless cross attention{tag}, ragged (4 x "
             "37 over 300 keys)", dt, dict(b=4, s=37, sk=300, causal=False,
                                          **sm)),
            ("flash_decode", f"seamless cross decode{tag} (4 over 512 memory "
             "keys)", dt, dict(b=4, s=512, starts=[0] * 4, lengths=[512] * 4,
                               **sm)),
        ]
    return cases


def encdec_batches(torch, cfg, frames, seq, batch, n, device):
    """Token batches (``train_batches``) with ``src_embeds`` (batch,
    frames, d_model), standard normal from a generator on ``device``
    seeded by the step."""
    out = train_batches(cfg, seq, batch, n, device)
    for s, b in enumerate(out):
        gen = torch.Generator(device=device).manual_seed(1000 + s)
        b["src_embeds"] = torch.randn((batch, frames, cfg.d_model),
                                      generator=gen, device=device)
    return out


def encdec_train_runs(torch, cfg=None):
    """The runs of the encdec card-against-CPU phase: (cfg, label,
    strategy, runner kwargs, steps, param tolerance) at 2 encoder and 2
    decoder layers of seamless-m4t-large-v2's width: ``hift`` (m = 1,
    AdamW, bottom2up: embed, enc 0, enc 1, dec 0), ``lomo`` (clip 1.0),
    ``adalomo``, ``mezo`` (``cpu_noise``: the same z on both devices)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HiFTConfig, LOMOConfig
    from repro_torch.models import encdec as E
    cfg = cfg or dataclasses.replace(get_config("seamless-m4t-large-v2"),
                                     n_layers=4, enc_layers=2, dec_layers=2)
    shapes = {p: tuple(t.shape) for p, t in
              _flat(E.init(cfg, torch.Generator(), device="meta")).items()}
    return [(cfg, "hift", "hift", dict(hift=HiFTConfig(m=1),
                                       optimizer="adamw"), 4,
             2 * ENCDEC_LR + 1e-6),
            (cfg, "lomo", "lomo", dict(lomo=LOMOConfig(grad_clip=1.0)), 1,
             FUSED_PARAM_TOL["lomo"]),
            (cfg, "adalomo", "adalomo", {}, 1, 2 * ENCDEC_LR),
            (cfg, "mezo", "mezo", dict(noise=cpu_noise(torch, shapes)), 1,
             6 * ENCDEC_LR)]


def encdec_train_side(torch, runs, dev: str) -> dict:
    """One device's side of the encdec card-against-CPU runs, from the
    params of seed 0 drawn on the CPU and the same batches: per run the
    losses, grad norms, groups, seconds and a sample of the final params;
    for ``adalomo`` on the card also where the starting gradient exceeds
    1e-4 on that sample."""
    from repro_torch.core import LRSchedule, make_runner
    from repro_torch.models import encdec as E
    out = {}
    cfg = runs[0][0]
    p0 = E.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                dtype=torch.float32)
    for _, label, strategy, kw, n, _ in runs:
        batches = encdec_batches(torch, cfg, ENCDEC_FRAMES, ENCDEC_SEQ, 2, n,
                                 "cpu")
        runner = make_runner(cfg, strategy, params=p0, device=dev,
                             schedule=LRSchedule(base_lr=ENCDEC_LR), **kw)
        t0 = time.perf_counter()
        losses, norms, groups = [], [], []
        for b in batches:
            losses.append(float(runner.train_step(b)))
            g = runner.last_metrics.get("grad_norm")
            norms.append(None if g is None else float(g))
            groups.append(runner.last_metrics.get("group"))
        row = dict(losses=losses, norms=norms, groups=groups,
                   seconds=time.perf_counter() - t0,
                   params={k: _sample(t) for k, t in
                           _flat(runner.params).items()})
        del runner
        if strategy == "adalomo" and dev != "cpu":
            row["mask"] = _grad_above(torch, cfg, p0, batches[0], dev)
        out[label] = row
    return out


def compare_encdec_train(torch, runs, sides: dict, devices) -> None:
    """Emits a ``train_encdec_card_vs_cpu`` line a run; raises where the
    devices differ: losses and grad norms beyond ``ENCDEC_RTOL`` relative,
    the params' sample beyond the run's tolerance (``adalomo``'s where the
    starting gradient exceeds 1e-4, as ``compare_moe_train``)."""
    a, b = (sides[d] for d in devices)
    for cfg, label, strategy, _, n, param_tol in runs:
        x, y = a[label], b[label]
        rel, nrel, gap, gap_all, worst = train_gaps(x, y)
        emit("train_encdec_card_vs_cpu", arch=cfg.name, run=label,
             enc_layers=cfg.enc_layers, dec_layers=cfg.dec_layers,
             d_model=cfg.d_model, batch=2, frames=ENCDEC_FRAMES,
             seq=ENCDEC_SEQ, lr=ENCDEC_LR, groups=x["groups"],
             cpu_losses=x["losses"], cuda_losses=y["losses"],
             cpu_grad_norms=x["norms"], cuda_grad_norms=y["norms"],
             max_rel_loss_gap=rel, max_rel_grad_norm_gap=nrel,
             rtol=ENCDEC_RTOL, max_param_gap=gap,
             max_param_gap_unmasked=gap_all, worst_leaf=worst,
             param_sample=f"every {MOE_SAMPLE}th element",
             param_tol=param_tol, cpu_seconds=x["seconds"],
             cuda_seconds=y["seconds"])
        if (not all(math.isfinite(v) for v in y["losses"])
                or rel > ENCDEC_RTOL or nrel > ENCDEC_RTOL
                or gap > param_tol):
            raise RuntimeError(f"{cfg.name} {label}: card and CPU differ: "
                               f"losses {x['losses']} {y['losses']}, norms "
                               f"{x['norms']} {y['norms']}, param gap {gap} "
                               f"({worst})")


def phase_train_encdec_card_vs_cpu(torch, cfg=None, devices=("cpu", "cuda")):
    """encdec training, card against CPU, from the same fp32 params and
    batches (``encdec_train_runs``), ``compare_encdec_train``'s gates.
    ``phase_encdec`` runs the CPU's side in a child process beside the
    card's phases; here each device's side runs in turn, and ``cfg`` /
    ``devices`` let the phase run small on the CPU alone."""
    runs = encdec_train_runs(torch, cfg)
    sides = {dev: encdec_train_side(torch, runs, dev) for dev in set(devices)}
    compare_encdec_train(torch, runs, sides, devices)
    gc.collect()


def _visit_first(runner, labels) -> None:
    """Puts the HiFT groups named ``labels`` first in the runner's visit
    order (the order is state; a label may come again, a revisit), the
    others after them in their order."""
    first = [next(g.index for g in runner.groups if g.label().endswith(
        f"({lab})")) for lab in labels]
    rest = [gi for gi in runner.strategy.order if gi not in first]
    runner.state.extra["order"] = np.asarray(first + rest, np.int64)


def phase_train_encdec_full(torch):
    """seamless-m4t-large-v2 at its published config (24 + 24 layers,
    1.63 B params), random weights from seed 0, batch 4 x 512 source frames
    and 4 x 128 target tokens (the reference's encdec training shape):

    - fp32 HiFT m=1, AdamW (fused, trained in place): the embed step (a
      backward through both stacks), enc 0, dec 0, dec 23 and the head,
      then the head again (a revisit: its 2.1 GB bundle comes back from
      pinned host memory): host ms, peak allocated and reserved beside
      the analytic P+G+S, the update kernel's device ms;
    - one FPFT step (AdamW, fused) at full depth from fresh params: its
      peak beside the analytic, and the saving measured and analytic;
    - ``lomo`` (clip 1.0), ``adalomo`` and ``mezo``, one step each: a peak
      more than ``FUSED_ALLOWANCE_GIB`` over the analytic P+G+S fails the
      run;
    - NF4 HiFT (bf16 moments) from a tree encoded leaf by leaf: the embed
      step and enc 0, with the dequant kernel's device ms and launches.

    Returns the kernels' launches over the HiFT runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (HiFTConfig, LOMOConfig, LRSchedule,
                                  QuantConfig, make_runner)
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.models import encdec as E
    cfg = get_config("seamless-m4t-large-v2")
    batches = encdec_batches(torch, cfg, 512, 128, 4, 2, "cuda")
    sched = LRSchedule(base_lr=1e-5)

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return E.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda", dtype=torch.float32)

    base = torch.cuda.memory_allocated()
    params = fresh()
    hift_pgs = analytic(cfg).pgs_gb
    rows = []
    with UpdateTimer(torch) as timer:   # counts the main path's run only
        runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                             hift=HiFTConfig(m=1), schedule=sched,
                             device="cuda")
        _visit_first(runner, ("embed", "enc[0:1]", "dec[0:1]", "dec[23:24]",
                              "head", "head"))
        for i in range(6):
            row = fused_step(torch, runner, batches[i % 2], base, timer=timer)
            row["visit"] = sum(r["group"] == row["group"] for r in rows) + 1
            rows.append(row)
            emit("train_encdec_step", arch=cfg.name, strategy="hift",
                 analytic_pgs_gib=hift_pgs,
                 over_analytic_gib=row["peak_allocated_gib"] - hift_pgs,
                 **row)
        launches = timer.launches()
        del runner
    del params
    with UpdateTimer(torch) as timer:
        params = fresh()
        runner = make_runner(cfg, "fpft", params=params, optimizer="adamw",
                             fused_update=True, schedule=sched,
                             device="cuda")
        del params
        fpft = fused_step(torch, runner, batches[0], base, timer=timer)
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
        del runner
    fpft_pgs = analytic(cfg, "fpft").pgs_gb
    emit("train_encdec_step", arch=cfg.name, strategy="fpft",
         analytic_pgs_gib=fpft_pgs,
         over_analytic_gib=fpft["peak_allocated_gib"] - fpft_pgs, **fpft)
    hift_peak = max(r["peak_allocated_gib"] for r in rows)
    emit("train_encdec_memory", arch=cfg.name, dtype="float32", batch=4,
         frames=512, seq=128, n_params=analytic(cfg).n_params,
         hift_peak_gib=hift_peak, fpft_peak_gib=fpft["peak_allocated_gib"],
         hift_analytic_gib=hift_pgs, fpft_analytic_gib=fpft_pgs,
         saving=1 - hift_peak / fpft["peak_allocated_gib"],
         analytic_saving=1 - hift_pgs / fpft_pgs,
         host_ms=[[r["group"], r["host_ms"]] for r in rows],
         fpft_host_ms=fpft["host_ms"])
    params = fresh()
    for strategy, kw in (("lomo", {"lomo": LOMOConfig(grad_clip=1.0)}),
                         ("adalomo", {}), ("mezo", {})):
        runner = make_runner(cfg, strategy, params=params, schedule=sched,
                             device="cuda", **kw)
        st = runner.strategy
        pgs = analytic(cfg, st.memory_mode, m=st.memory_m).pgs_gb
        row = fused_step(torch, runner, batches[0], base)
        emit("train_encdec_step", arch=cfg.name, strategy=strategy,
             m=st.memory_m, analytic_pgs_gib=pgs,
             over_analytic_gib=row["peak_allocated_gib"] - pgs, **row)
        if row["peak_allocated_gib"] - pgs > FUSED_ALLOWANCE_GIB:
            raise RuntimeError(f"{cfg.name} {strategy}: peak "
                               f"{row['peak_allocated_gib']:.2f} GiB exceeds "
                               f"the analytic {pgs:.2f} GiB by more than "
                               f"{FUSED_ALLOWANCE_GIB} GiB")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    del params
    quant = QuantConfig("nf4", "bf16")
    params = encoded_init(torch, cfg, "nf4")
    with UpdateTimer(torch) as timer, UpdateTimer(torch, DM) as dq:
        _nf4_steps(torch, cfg, params, batches, timer, dq, quant,
                   "train_encdec_quant_step")
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
    del params
    launches["dequant_matmul"] = DM.dequant_matmul.launches - \
        DM.dequant_matmul.launches_tc
    if not launches["dequant_matmul"] or not launches["fused_adamw"]:
        raise RuntimeError(f"encdec training never launched a kernel: "
                           f"{launches}")
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_encdec_launches", launches=launches)
    return launches


def phase_serve_encdec_full(torch, dtype: str = "bfloat16",
                            max_new: int = 32):
    """``ServeEngine`` over seamless-m4t-large-v2 at full depth, random
    weights from seed 0, batch 4, 512 source frames (standard normal,
    seeded 99, as the launcher's), 4 prompts of 8-64 tokens, ``max_new``
    new tokens, one warm-up call first: host-clock prefill ms (a 1-token
    generation), decode-step ms ((the run - prefill) / (max_new - 1)) and
    tokens/s, and the attention kernels' launches over the timed runs,
    which must be 72 prefill launches a generation (24 encoder, 24 causal,
    24 cross) and 48 decode launches a step (24 self, 24 cross).  Returns
    those launches by instantiation."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models import encdec as E
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("seamless-m4t-large-v2")
    dt = getattr(torch, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = E.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=dt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(13)
    plens = [int(n) for n in rng.integers(8, 65, 4)]
    prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
    src = torch.randn((4, 512, cfg.d_model),
                      generator=torch.Generator(device="cuda").manual_seed(99),
                      device="cuda")
    eng = ServeEngine(cfg, params, batch=4, max_len=max(plens) + max_new,
                      compute_dtype=dt, device="cuda")
    eng.generate(prompts, max_new_tokens=2, src_embeds=src)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()                 # count the timed runs only
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1, src_embeds=src)
    prefill_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=max_new, src_embeds=src)
    run_s = time.perf_counter() - t0
    prefill = instance("flash_attention", dtype)
    launches = {prefill: K.flash_attention.launches_tc
                if dtype == "bfloat16" else
                K.flash_attention.launches - K.flash_attention.launches_tc,
                "flash_decode": K.flash_decode.launches}
    want = {prefill: 2 * 3 * 24, "flash_decode": (max_new - 1) * 2 * 24}
    if launches != want or K.flash_attention.launches != launches[prefill]:
        raise RuntimeError(f"seamless {dtype} serving launched {launches} "
                           f"({K.flash_attention.launches} prefills), not "
                           f"{want}")
    for toks in out:
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_padded
                                           for t in toks):
            raise RuntimeError(f"seamless: bad generation {toks}")
    leaves = list(_flat(params).values())
    emit("serve_encdec_full", arch=cfg.name, dtype=dtype, init_s=init_s,
         prompt_lens=plens, src_frames=512, new_tokens=max_new,
         prefill_ms=1e3 * prefill_s,
         decode_step_ms=1e3 * (run_s - prefill_s) / (max_new - 1),
         tokens_per_s=len(prompts) * max_new / run_s,
         weights_gb=sum(t.numel() * t.element_size() for t in leaves) / 1e9,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
         launches=launches,
         decode_launches_split=K.flash_decode.launches_split)
    del eng, params, leaves, src
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def encdec_serve_sides(torch, devices, cfg=None) -> dict:
    """Each device's side of the encdec card-against-CPU serving: 2
    encoder and 2 decoder layers at seamless-m4t-large-v2's width (or
    ``cfg``), fp32, the params of seed 0 drawn on the CPU once for both,
    4 prompts of mixed length in one padded batch (the left pad attends,
    as in the reference) over 128 source frames, 8 new tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or dataclasses.replace(get_config("seamless-m4t-large-v2"),
                                     n_layers=4, enc_layers=2, dec_layers=2)
    params = host_params(torch, cfg, "cuda" in devices)
    rng = np.random.default_rng(7)
    plens = [64, 37, 20, 50]
    prompts = [rng.integers(0, cfg.vocab, n) for n in plens]
    src = torch.randn((4, 128, cfg.d_model),
                      generator=torch.Generator().manual_seed(99))
    out = {}
    for dev in devices:
        eng = ServeEngine(cfg, params, batch=4, max_len=72,
                          compute_dtype=torch.float32, device=dev)
        t0 = time.perf_counter()
        out[dev] = dict(name=cfg.name, prompts=plens,
                        tokens=eng.generate(prompts, max_new_tokens=8,
                                            src_embeds=src),
                        seconds=time.perf_counter() - t0)
        del eng
    return out


def phase_serve_encdec_card_vs_cpu(torch, cfg=None, devices=("cpu", "cuda")):
    """The same fp32 weights served on the CPU (plain versions) and the
    card (kernels), ``encdec_serve_sides``: the greedy tokens must be
    equal.  ``cfg`` / ``devices`` let the phase run small on the CPU."""
    sides = encdec_serve_sides(torch, devices, cfg)
    x, y = (sides[d] for d in devices)
    same = x["tokens"] == y["tokens"]
    emit("serve_encdec_card_vs_cpu", arch=x["name"], prompts=x["prompts"],
         src_frames=128, new_tokens=8, tokens_equal=same,
         seconds={d: s["seconds"] for d, s in sides.items()},
         cpu_tokens=x["tokens"], cuda_tokens=y["tokens"])
    if not same:
        raise RuntimeError(f"seamless: card and CPU greedy tokens differ: "
                           f"{x['tokens']} {y['tokens']}")


def phase_encdec(torch, cpu: CpuSide | None = None) -> dict:
    """The encdec family (seamless-m4t-large-v2): the attention kernels at
    its widths (non-causal, cross, the cross decode), the card's side of
    the training card against CPU, the full-size training and serving, and
    serving card against CPU.  The CPU side of the training runs in a
    child process (``cpu``, a ``CpuSide`` started earlier, or one started
    here) beside the rest; its comparison comes last.  Each part's seconds
    in a line; returns the kernels' launches over the main-path runs."""
    launches, secs = {}, {}
    own = cpu is None
    cpu = cpu or CpuSide(("encdec",))
    try:
        t0 = time.perf_counter()
        phase_kernels(torch, encdec_attention_cases())
        secs["kernels_encdec"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = encdec_train_runs(torch)
        card = encdec_train_side(torch, runs, "cuda")
        runs = [r[:3] + (None,) + r[4:] for r in runs]
        gc.collect()
        torch.cuda.empty_cache()
        secs["train_encdec_card_side"] = time.perf_counter() - t0
        for name, fn in (("train_encdec_full", phase_train_encdec_full),
                         ("serve_encdec_full", phase_serve_encdec_full),
                         ("serve_encdec_full_fp32",
                          lambda t: phase_serve_encdec_full(t, "float32", 8))):
            t0 = time.perf_counter()
            for kernel, n in fn(torch).items():
                launches[kernel] = launches.get(kernel, 0) + n
            secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_serve_encdec_card_vs_cpu(torch)
        torch.cuda.empty_cache()
        secs["serve_encdec_card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sides = cpu.result("encdec")
        secs["cpu_side_wait"] = time.perf_counter() - t0
        secs["cpu_side"] = sides["seconds"]
        compare_encdec_train(torch, runs, {"cpu": sides["train"],
                                           "cuda": card}, ("cpu", "cuda"))
    finally:
        if own:
            cpu.close()
    emit("encdec_seconds", seconds=secs,
         total=sum(v for k, v in secs.items() if k != "cpu_side"))
    return launches


# ------------------------------------------------------------ xlstm

# The wide scan (P, N) = (1025, 1024): xlstm-1.3b's mLSTM, heads folded
# into the batch (H = 1).  (case, dtype, batch rows x heads, S, decay):
# "mlstm" is the mLSTM's own forget gate at its bias, log_sigmoid(N(0, 1)
# + 3) (~0.95 a step); "published" is ``ssm_inputs``' fast decay, at one
# head softplus(N(0, 1)) (~0.5 a step).
WIDE_SSM_CASES = [
    (f"xlstm {shape} {dtype} {decay}", dtype, b, s, decay)
    for shape, b, s in (("prefill 16 x 512", 16, 512),
                        ("one long prompt 4 x 2048", 4, 2048),
                        ("ragged 16 x 301", 16, 301))
    for dtype in ("float32", "bfloat16")
    for decay in ("mlstm", "published")]
XLSTM_LOGIT_TOL = 1e-3     # card against CPU, fp32 prefill logits (atol = rtol)
XLSTM_CPU_PROMPTS = [64, 37, 20, 50]
XLSTM_CPU_NEW = 8


WIDE_KERNELS = {"scores_ms": "ssm_wide_scores", "walk_ms": "ssm_wide_walk"}


def wide_split_ms(torch, fn, arg_sets) -> dict:
    """Device ms a launch of each of the wide scan's two kernels, the
    scores kernel and the walk, apart: ``torch.profiler``'s kernel times
    over two passes of ``arg_sets`` after a warm-up pass, each kernel's
    total over the launches the profiler caught (it may miss some; again,
    up to three times, where it caught none of one)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        for args in arg_sets:
            fn(*args)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for args in 2 * arg_sets:
                fn(*args)
            torch.cuda.synchronize()
        out = {}
        for key, sub in WIDE_KERNELS.items():
            evs = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and sub in e.key]
            n = sum(e.count for e in evs)
            out[key] = (sum(e.self_device_time_total for e in evs) / 1e3 / n
                        if n else 0.0)
        if all(out.values()):
            break
    return out


def phase_wide_ssm_kernel(torch):
    """The wide scan kernel against its plain version (``ssm_plain``, the
    fp64 chunked scan) over ``WIDE_SSM_CASES``, timed with its inputs
    rotated beyond L2, beside its bound: fp32 at three TF32 products a
    product (the kernel's route; the CUDA cores' bound beside it), bf16 at
    bf16's rate; the scores kernel's and the walk's device ms apart
    (``wide_split_ms``) beside the total.  No single PyTorch call computes
    the scan (``library_ms`` null).  Returns the first case's row of each
    instantiation."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssm_scan as S
    p, n = S.WIDE
    gen = torch.Generator(device="cuda").manual_seed(2025)
    results = {}
    for case, dtype, b, s, decay in WIDE_SSM_CASES:
        dt = getattr(torch, dtype)
        args = ssm_inputs(torch, dt, b, s, 1, decay, gen, p=p, n=n)
        got_y, got_h = S.ssm_scan(*args)
        want_y, want_h = ssm_plain(*args)
        torch.cuda.synchronize()
        tol = TOL[dtype]
        errs = {}
        for what, got, want in (("y", got_y, want_y),
                                ("h_final", got_h, want_h)):
            got, want = got.float(), want.float()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"ssm_scan_wide ({case}): non-finite "
                                   f"{what}")
            err = (got - want).abs()
            errs[what] = float(err.max())
            # the largest share of its tolerance an entry takes
            errs[what + "_of_tol"] = float((err / (tol + tol * want.abs()))
                                           .max())
            if errs[what + "_of_tol"] > 1:
                raise RuntimeError(f"ssm_scan_wide ({case}): {what} max "
                                   f"|err| {errs[what]} over tolerance {tol}")
        # the normalizer channel (column 1024) on its own: decode divides
        # by it
        norm_err = float((got_y[..., -1].float()
                          - want_y[..., -1].float()).abs().max())
        flow_y, _ = ref.gated_chunked_scan_ref(*args)
        row_extra = dict(
            reference_flow_gap=float((flow_y.float()
                                      - want_y.float()).abs().max()),
            y_scale=float(want_y.float().abs().max()),
            max_abs_err_normalizer=norm_err)
        del flow_y, got_y, got_h, want_y, want_h
        nbytes = sum(a.numel() * a.element_size() for a in args)
        sets = [args] + [ssm_inputs(torch, dt, b, s, 1, decay, gen, p=p, n=n)
                         for _ in range(copies(nbytes) - 1)]
        ms = time_ms(torch, S.ssm_scan, sets, reps=5, launches=10)
        row_extra.update(wide_split_ms(torch, S.ssm_scan, sets))
        plain_ms = time_ms(torch, ssm_plain, sets, reps=3, launches=2)
        flops, wbytes = ssm_work(dtype, b, s, 1, p=p, n=n)
        bound_ms, bound_by = bound(flops, wbytes, dtype)
        if dtype == "float32":
            row_extra["bound_cuda_cores_ms"] = bound_ms
            bound_ms, bound_by = bound(3 * flops, wbytes, "tf32")
        row = dict(kernel=instance("ssm_scan_wide", dtype), case=case,
                   dtype=dtype, shapes=dict(b=b, s=s, h=1, p=p, n=n),
                   decay=decay,
                   max_abs_err=max(errs["y"], errs["h_final"]),
                   max_abs_err_y=errs["y"], max_abs_err_h=errs["h_final"],
                   y_share_of_tol=errs["y_of_tol"],
                   h_share_of_tol=errs["h_final_of_tol"],
                   tol=tol, ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=wbytes, share_of_bound=bound_ms / ms,
                   products=("3xTF32" if dtype == "float32" else "2xTF32")
                   + " mma.sync (C h^T and the state update), fp64 sums "
                   "(C B^T, G x, decays, C h^T's 32-column partials), fp32 "
                   "k-step sums in the update, the normalizer row fp64",
                   **row_extra)
        emit("kernel", **row)
        results.setdefault(row["kernel"], row)
        del sets, args
        gc.collect()
        torch.cuda.empty_cache()
    return results


def _timed(torch, fn, acc: dict, key: str):
    """``fn`` that adds its synchronised wall seconds to ``acc[key]``."""
    def wrapped(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        acc[key] = acc.get(key, 0.0) + time.perf_counter() - t0
        return out
    return wrapped


def xlstm_breakdown(torch, cfg, params, toks, dt) -> dict:
    """Where one prefill's and one decode step's time go: the host clock of
    each with the wide scan's and the sLSTM loop's calls synchronised and
    timed on their own (their shares of the total), then
    ``torch.profiler`` (device activity) over one prefill and one decode
    step (device busy and idle share, the wide scan's device ms, the top
    kernels)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import xlstm as X
    # the device's activity only: a prefill launches ~60,000 kernels, and
    # the host's op events besides would take a minute to tally
    acts = [ProfilerActivity.CUDA]
    out = {}

    def prefill():
        cache = X.init_cache(cfg, toks.shape[0], device="cuda")
        return X.prefill(cfg, params, {"tokens": toks}, cache, dt)

    logits, cache = prefill()                          # warm up
    tok = logits[:, -1].argmax(-1, keepdim=True)
    X.decode_step(cfg, params, cache, tok, dt)
    for name, run in (("prefill", prefill),
                      ("decode", lambda: X.decode_step(cfg, params, cache,
                                                       tok, dt))):
        parts = {}
        scan, loop = X.ssm_scan, X._slstm_scan
        X.ssm_scan = _timed(torch, scan, parts, "wide_scan_s")
        X._slstm_scan = _timed(torch, loop, parts, "slstm_loop_s")
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
        finally:
            X.ssm_scan, X._slstm_scan = scan, loop
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            host_ms = 1e3 * (time.perf_counter() - t0)
        out[name] = dict(
            timed_ms=1e3 * total,
            **{k[:-2] + "_share": v / total for k, v in parts.items()},
            profile=profile_summary(prof, host_ms, wide_scan_ms="ssm_wide"))
    return out


def phase_serve_xlstm_full(torch, dtype: str = "bfloat16", max_new: int = 32,
                           n_layers=None):
    """``ServeEngine`` over xlstm-1.3b at its published config (48 layers,
    or ``n_layers`` of them; random weights from seed 0), batch 4, ragged
    prompts of 512, 384, 200 and 77 tokens (left pad unmasked, as in the
    reference), ``max_new`` new tokens, one warm-up call first: host-clock
    prefill ms (a 1-token generation), decode-step ms ((the run - prefill)
    / (max_new - 1)), tokens/s, and the wide scan's launches over the timed
    runs: one a mLSTM layer a prefill (42 at full depth) and none in
    decode.  Peak memory beside
    the weights and the decode state; then ``xlstm_breakdown``.  Returns
    the launches by instantiation."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ssm_scan as S
    from repro_torch.models import xlstm as X
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("xlstm-1.3b")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    dt = getattr(torch, dtype)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = X.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                    device="cuda", dtype=dt)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    plens = [512, 384, 200, 77]
    rng = np.random.default_rng(17)
    prompts = [rng.integers(1, cfg.vocab, n) for n in plens]
    eng = ServeEngine(cfg, params, batch=4, compute_dtype=dt, device="cuda")
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=2)              # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    S.reset_launches()                 # count the timed runs only
    t0 = time.perf_counter()
    eng.generate(prompts, max_new_tokens=1)
    prefill_s = time.perf_counter() - t0
    after_prefill = S.ssm_scan.launches_wide
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new_tokens=max_new)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    n_m = cfg.n_layers // cfg.slstm_every * (cfg.slstm_every - 1)
    name = instance("ssm_scan_wide", dtype)
    bf = S.ssm_scan.launches_wide_bf16
    launches = {name: bf if dtype == "bfloat16"
                else S.ssm_scan.launches_wide - bf}
    per_run = [after_prefill, S.ssm_scan.launches_wide - after_prefill]
    if per_run != [n_m, n_m] or launches[name] != 2 * n_m or \
            S.ssm_scan.launches != 0:
        raise RuntimeError(f"xlstm {dtype} serving launched the wide scan "
                           f"{per_run} times a generation ({launches}, "
                           f"{S.ssm_scan.launches} narrow), not {n_m} a "
                           "prefill and none in decode")
    for toks in out:
        if len(toks) != max_new or not all(0 <= t < cfg.vocab_padded
                                           for t in toks):
            raise RuntimeError(f"xlstm: bad generation {toks}")
    cache = X.init_cache(cfg, 4, device="meta")
    state_bytes = sum(t.numel() * 4 for t in _flat(cache).values()
                      if isinstance(t, torch.Tensor))
    weights = sum(t.numel() * t.element_size()
                  for t in _flat(eng.params).values())
    plen = max(plens)
    toks = torch.tensor(np.stack([np.pad(p, (plen - len(p), 0))
                                  for p in prompts]), device="cuda")
    t0 = time.perf_counter()
    breakdown = xlstm_breakdown(torch, cfg, eng.params, toks, dt)
    breakdown_s = time.perf_counter() - t0
    emit("serve_xlstm_full", arch=cfg.name, n_layers=cfg.n_layers,
         dtype=dtype, init_s=init_s, warm_up_s=warm_s,
         breakdown_s=breakdown_s, prompt_lens=plens, new_tokens=max_new,
         prefill_ms=1e3 * prefill_s,
         decode_step_ms=1e3 * (run_s - prefill_s) / (max_new - 1),
         tokens_per_s=len(prompts) * max_new / run_s,
         launches=launches, launches_per_generation=per_run,
         weights_gb=weights / 1e9, state_gb=state_bytes / 1e9,
         peak_memory_gb=peak / 1e9,
         peak_over_weights_and_state_gb=(peak - weights - state_bytes) / 1e9,
         breakdown=breakdown)
    del eng, params, toks
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def xlstm_serve_side(torch, dev: str, cfg=None) -> dict:
    """One device's side of the xlstm card-against-CPU serving: one
    super-block (8 layers) of xlstm-1.3b at full width (or ``cfg``), fp32,
    the params of seed 0 drawn on the CPU, 4 prompts of mixed length
    (``XLSTM_CPU_PROMPTS``, left pad unmasked), ``XLSTM_CPU_NEW`` new
    tokens through ``ServeEngine``, then one prefill's logits."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import xlstm as X
    from repro_torch.serve.engine import ServeEngine
    cfg = cfg or dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    secs = {}
    t0 = time.perf_counter()
    params = X.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    secs["init"] = time.perf_counter() - t0
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab, n) for n in XLSTM_CPU_PROMPTS]
    eng = ServeEngine(cfg, params, batch=4, compute_dtype=torch.float32,
                      device=dev)
    t0 = time.perf_counter()
    tokens = eng.generate(prompts, max_new_tokens=XLSTM_CPU_NEW)
    secs["generate"] = time.perf_counter() - t0
    plen = max(XLSTM_CPU_PROMPTS)
    toks = torch.from_numpy(np.stack([np.pad(p, (plen - len(p), 0))
                                      for p in prompts])).to(dev)
    t0 = time.perf_counter()
    logits, cache = X.prefill(cfg, eng.params, {"tokens": toks},
                              X.init_cache(cfg, 4, device=dev),
                              torch.float32)
    state = cache["mlstm_C"][-1, :, :, -1].cpu().numpy()
    secs["prefill"] = time.perf_counter() - t0
    return dict(name=cfg.name, tokens=tokens, seconds=secs,
                logits=logits.cpu().numpy(), state=state)


def phase_serve_xlstm_card_vs_cpu(torch, cpu: dict, cfg=None):
    """The card's side of ``xlstm_serve_side`` against the CPU's (``cpu``,
    the last of the ``CpuHalves``): the greedy tokens must be equal
    and the prefill logits within ``XLSTM_LOGIT_TOL`` (atol = rtol: fp32
    sums of up to 4096 products in other orders through 8 layers, and the
    card's scan in fp32 where the CPU's plain version follows the
    reference's chunked form); the last mLSTM layer's normalizer row of
    the prefill state beside it."""
    card = xlstm_serve_side(torch, "cuda", cfg)
    gap = np.abs(card["logits"] - cpu["logits"])
    over = gap > XLSTM_LOGIT_TOL * (1 + np.abs(cpu["logits"]))
    same = card["tokens"] == cpu["tokens"]
    emit("serve_xlstm_card_vs_cpu", arch=card["name"],
         prompts=XLSTM_CPU_PROMPTS, new_tokens=XLSTM_CPU_NEW,
         tokens_equal=same, max_logit_gap_prefill=float(gap.max()),
         logit_scale=float(np.abs(cpu["logits"]).max()),
         logit_tol=XLSTM_LOGIT_TOL,
         max_normalizer_state_gap=float(np.abs(card["state"]
                                               - cpu["state"]).max()),
         seconds={"cpu": cpu["seconds"], "cuda": card["seconds"]},
         cpu_tokens=cpu["tokens"], cuda_tokens=card["tokens"])
    if not same:
        raise RuntimeError(f"xlstm: card and CPU greedy tokens differ: "
                           f"{cpu['tokens']} {card['tokens']}")
    if over.any():
        raise RuntimeError(f"xlstm: card and CPU prefill logits differ by "
                           f"{float(gap.max())}, over {XLSTM_LOGIT_TOL}")


def phase_xlstm(torch) -> tuple[dict, dict]:
    """The xlstm family (xlstm-1.3b) served on the card: the wide scan
    kernel against its plain version, then the published config served in
    bf16 (32 new tokens) and fp32 (8, at 24 of its 48 layers).  Each
    part's seconds in a line; returns (the kernel rows, the wide scan's
    launches over the main-path runs).  The card-against-CPU serving
    (``phase_serve_xlstm_card_vs_cpu``) runs apart, once its CPU side is
    done."""
    launches, secs = {}, {}
    t0 = time.perf_counter()
    rows = phase_wide_ssm_kernel(torch)
    secs["wide_ssm_kernel"] = time.perf_counter() - t0
    # fp32 at 24 of the 48 layers, as the other families' fp32 serving
    # (full depth took 23.4-37 s of the whole script on an H100)
    for name, fn in (("serve_xlstm_full", phase_serve_xlstm_full),
                     ("serve_xlstm_full_fp32",
                      lambda t: phase_serve_xlstm_full(t, "float32", 8,
                                                       n_layers=24))):
        t0 = time.perf_counter()
        for kernel, n in fn(torch).items():
            launches[kernel] = launches.get(kernel, 0) + n
        secs[name] = time.perf_counter() - t0
    emit("xlstm_seconds", seconds=secs, total=sum(secs.values()))
    return rows, launches


# ------------------------------------------------------------ xlstm training

XLSTM_TRAIN_LR = 1e-4      # card against CPU
XLSTM_TRAIN_SEQ = 128      # batch 1 x XLSTM_TRAIN_SEQ
XLSTM_TRAIN_RTOL = 1e-4    # card against CPU: losses and grad norms
# The HiFT groups of the card-against-CPU runs, in their visit order: the
# embedding's (a backward through every layer), the first mLSTM and the
# first sLSTM (each a backward through the super-block), the head.
XLSTM_TRAIN_GROUPS = ("embed", "mlstm[0:1]", "slstm[0:1]", "head")


def xlstm_train_side(torch, cfg, params, dev: str) -> dict:
    """One device's side of the xlstm card-against-CPU training, from
    ``params`` (fp32, on the CPU) and the same batches of 1 x
    ``XLSTM_TRAIN_SEQ`` tokens: HiFT m=1 (AdamW) over
    ``XLSTM_TRAIN_GROUPS``, then one ``lomo`` step (clip 1.0); per run
    the losses, grad norms, groups, seconds and a sample of the final
    params.  On the card the HiFT steps must run the fused AdamW once each
    and training must launch no scan kernel (neither has a backward)."""
    from repro_torch.core import (HiFTConfig, LOMOConfig, LRSchedule,
                                  make_runner)
    from repro_torch.kernels import fused_update as FU
    from repro_torch.kernels import ssm_scan as S
    n_hift = len(XLSTM_TRAIN_GROUPS)
    batches = train_batches(cfg, XLSTM_TRAIN_SEQ, 1, n_hift, "cpu")
    out = {}
    for strategy, kw, n in (("hift", dict(hift=HiFTConfig(m=1),
                                          optimizer="adamw"), n_hift),
                            ("lomo", dict(lomo=LOMOConfig(grad_clip=1.0)), 1)):
        runner = make_runner(cfg, strategy, params=params, device=dev,
                             schedule=LRSchedule(base_lr=XLSTM_TRAIN_LR),
                             **kw)
        if strategy == "hift":
            _visit_first(runner, XLSTM_TRAIN_GROUPS)
        if dev == "cuda":
            S.reset_launches()
        fu = FU.fused_adamw_update.launches
        t0 = time.perf_counter()
        losses, norms, groups = [], [], []
        for b in batches[:n]:
            losses.append(float(runner.train_step(b)))
            g = runner.last_metrics.get("grad_norm")
            norms.append(None if g is None else float(g))
            groups.append(runner.last_metrics.get("group"))
        secs = time.perf_counter() - t0
        if dev == "cuda":
            if S.ssm_scan.launches or S.ssm_scan.launches_wide:
                raise RuntimeError("xlstm training launched a scan kernel, "
                                   "which has no backward")
            if strategy == "hift" and \
                    FU.fused_adamw_update.launches - fu != n:
                raise RuntimeError("the card's xlstm HiFT steps did not run "
                                   "the fused AdamW once each")
        out[strategy] = dict(losses=losses, norms=norms, groups=groups,
                             seconds=secs,
                             params={k: _sample(t) for k, t in
                                     _flat(runner.params).items()})
        del runner
    return out


def xlstm_train_cpu(torch, cfg=None):
    """The CPU half of ``phase_train_xlstm_card_vs_cpu`` (``CpuHalves``
    runs it beside the card's phases): the config (one super-block, 8
    layers, of xlstm-1.3b unless given), the fp32 params of seed 0 drawn
    on the CPU, and the CPU's side."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import xlstm as X
    cfg = cfg or dataclasses.replace(get_config("xlstm-1.3b"), n_layers=8)
    params = X.init(cfg, torch.Generator().manual_seed(0), device="cpu",
                    dtype=torch.float32)
    return cfg, params, xlstm_train_side(torch, cfg, params, "cpu")


def phase_train_xlstm_card_vs_cpu(torch, cfg=None, devices=("cpu", "cuda"),
                                  cpu=None):
    """xlstm training, card against CPU, from the same fp32 params: one
    super-block (7 mLSTM and 1 sLSTM layers) of xlstm-1.3b at full width,
    batch 1 x ``XLSTM_TRAIN_SEQ``: HiFT m=1 through the embed, mLSTM 0,
    sLSTM 0 and the head, then one ``lomo`` step (clip 1.0).  Losses and
    grad norms within ``XLSTM_TRAIN_RTOL``, the params' sample within
    2 lr + 1e-6 (HiFT's AdamW: its first update is about lr sign(g), so a
    near-zero gradient that rounds to the other sign on one device moves
    its element 2 lr apart) and ``FUSED_PARAM_TOL["lomo"]``.  ``cpu`` is
    the CPU half (``xlstm_train_cpu``), run here when None;
    ``cfg``/``devices`` let the phase run small on the CPU alone (its
    second side on ``devices[1]``)."""
    cfg, params, first = cpu or xlstm_train_cpu(torch, cfg)
    second = xlstm_train_side(torch, cfg, params, devices[1])
    tols = {"hift": 2 * XLSTM_TRAIN_LR + 1e-6,
            "lomo": FUSED_PARAM_TOL["lomo"]}
    for run, param_tol in tols.items():
        x, y = first[run], second[run]
        rel, nrel, gap, _, worst = train_gaps(x, y)
        emit("train_xlstm_card_vs_cpu", arch=cfg.name, run=run,
             n_layers=cfg.n_layers, d_model=cfg.d_model, batch=1,
             seq=XLSTM_TRAIN_SEQ, lr=XLSTM_TRAIN_LR, groups=x["groups"],
             cpu_losses=x["losses"], cuda_losses=y["losses"],
             cpu_grad_norms=x["norms"], cuda_grad_norms=y["norms"],
             max_rel_loss_gap=rel, max_rel_grad_norm_gap=nrel,
             rtol=XLSTM_TRAIN_RTOL, max_param_gap=gap, worst_leaf=worst,
             param_sample=f"every {MOE_SAMPLE}th element",
             param_tol=param_tol, cpu_seconds=x["seconds"],
             cuda_seconds=y["seconds"])
        if (not all(math.isfinite(v) for v in y["losses"])
                or rel > XLSTM_TRAIN_RTOL or nrel > XLSTM_TRAIN_RTOL
                or gap > param_tol):
            raise RuntimeError(f"{cfg.name} {run}: card and CPU differ: "
                               f"losses {x['losses']} {y['losses']}, norms "
                               f"{x['norms']} {y['norms']}, param gap {gap} "
                               f"({worst})")
    del params
    gc.collect()


def xlstm_train_breakdown(torch, runner, batch) -> dict:
    """Where one xlstm training step's time goes (run it on the embed
    group: a forward, a recompute and a backward through every layer),
    in one step under ``torch.profiler`` (device activity only: the step
    launches some 300,000 kernels) with synchronised timers: the sLSTM
    loop's calls (``xlstm._slstm_scan``) and the mLSTM's chunked scan's
    (``mamba2.gated_chunked_scan``) in the forward and in the recomputes,
    and the backward of each (from the gradient reaching the call's output
    to the gradient leaving its input, tensor hooks, less the recomputes
    in between), each a share of the step's host time; from the profile
    the busy ms, the device's idle share, the GEMMs' share of the busy
    time and the top kernels.  The timers' ~200 synchronisations wait
    for work already queued, so they add little idle time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import mamba2 as M
    from repro_torch.models import xlstm as X
    cuda = torch.cuda
    task = getattr(torch._C, "_current_graph_task_id", lambda: -1)
    calls, spans = [], []          # (part, kind, t0, t1); [part, t0, t1]

    def stamp(span, i):
        def hook(grad):
            cuda.synchronize()
            span[i] = time.perf_counter()
        return hook

    def timed(fn, part, arg):
        def wrapped(*args, **kw):
            cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            cuda.synchronize()
            kind = "forward" if task() == -1 else "recompute"
            calls.append((part, kind, t0, time.perf_counter()))
            y, x = out[0], args[arg]
            if kind == "forward" and y.requires_grad and x.requires_grad:
                span = [part, None, None]
                y.register_hook(stamp(span, 1))
                x.register_hook(stamp(span, 2))
                spans.append(span)
            return out
        return wrapped

    loop, scan = X._slstm_scan, M.gated_chunked_scan
    X._slstm_scan = timed(loop, "slstm_loop", 1)
    M.gated_chunked_scan = timed(scan, "chunked_scan", 0)
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(runner.train_step(batch))
            cuda.synchronize()
            total = time.perf_counter() - t0
    finally:
        X._slstm_scan, M.gated_chunked_scan = loop, scan
    shares = {}
    for part in ("slstm_loop", "chunked_scan"):
        for kind in ("forward", "recompute"):
            shares[f"{part}_{kind}"] = sum(
                t1 - t0 for p, k, t0, t1 in calls
                if p == part and k == kind) / total
        back = 0.0
        for p, s0, s1 in spans:
            if p == part and s0 is not None and s1 is not None:
                back += (s1 - s0) - sum(t1 - t0 for q, k, t0, t1 in calls
                                        if q == part and k == "recompute"
                                        and s0 <= t0 <= s1)
        shares[f"{part}_backward"] = back / total
        shares[part] = sum(v for k, v in shares.items()
                           if k.startswith(part + "_"))
    prof_out = profile_summary(prof, 1e3 * total, top=10, gemm_ms="gemm")
    return dict(group=runner.last_metrics["group"], loss=loss,
                host_ms=1e3 * total,
                calls={part: sum(p == part for p, *_ in calls)
                       for part in ("slstm_loop", "chunked_scan")},
                backward_spans=len(spans), shares=shares,
                gemm_share=prof_out["gemm_ms"] / prof_out["device_busy_ms"],
                profile=prof_out)


def phase_train_xlstm_full(torch, n_layers=None):
    """xlstm-1.3b at its published width (48 layers: 42 mLSTM, 6 sLSTM;
    3,529,631,912 params) and ``n_layers`` of its layers (None: all 48; a
    multiple of the 8-layer super-block), random fp32 weights from seed 0,
    batch 4 x 512:

    - HiFT m=1, AdamW (fused, trained in place): the embed step (a
      backward through every layer), mLSTM 0, sLSTM 0, the last mLSTM,
      the last sLSTM, the head, then the head again (a revisit: its 0.8 GB
      bundle back from pinned host memory): host ms, peak allocated and
      reserved beside the analytic P+G+S, the update kernel's device ms;
      then the embed group again for ``xlstm_train_breakdown``;
    - one FPFT step (AdamW, fused) from fresh params: its peak beside the
      analytic, and the saving measured and analytic;
    - ``lomo`` (clip 1.0), ``adalomo`` and ``mezo``, one step each: a
      peak more than ``FUSED_ALLOWANCE_GIB`` over the analytic P+G+S
      fails the run;
    - NF4 HiFT (bf16 moments) from a tree encoded leaf by leaf: the embed
      step and mLSTM 0, with the dequant kernel's device ms and launches.

    Training launches no scan kernel: the mLSTM trains through the plain
    chunked scan.  Returns the kernels' launches over the HiFT, FPFT and
    NF4 runs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (HiFTConfig, LOMOConfig, LRSchedule,
                                  QuantConfig, make_runner)
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.kernels import ssm_scan as S
    from repro_torch.models import xlstm as X
    cfg = get_config("xlstm-1.3b")
    cfg = dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers)
    n_s = cfg.n_layers // cfg.slstm_every
    n_m = cfg.n_layers - n_s
    batches = train_batches(cfg, 512, 4, 2, "cuda")
    sched = LRSchedule(base_lr=1e-5)
    secs = {}
    S.reset_launches()

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        return X.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      device="cuda", dtype=torch.float32)

    t0 = time.perf_counter()
    base = torch.cuda.memory_allocated()
    params = fresh()
    hift_pgs = analytic(cfg).pgs_gb
    rows = []
    visits = ("embed", "mlstm[0:1]", "slstm[0:1]", f"mlstm[{n_m - 1}:{n_m}]",
              f"slstm[{n_s - 1}:{n_s}]", "head", "head")
    with UpdateTimer(torch) as timer:   # counts the main path's run only
        runner = make_runner(cfg, "hift", params=params, optimizer="adamw",
                             hift=HiFTConfig(m=1), schedule=sched,
                             device="cuda")
        _visit_first(runner, visits + ("embed",))
        for i in range(len(visits)):
            row = fused_step(torch, runner, batches[i % 2], base, timer=timer)
            row["visit"] = sum(r["group"] == row["group"] for r in rows) + 1
            rows.append(row)
            emit("train_xlstm_step", arch=cfg.name, strategy="hift",
                 analytic_pgs_gib=hift_pgs,
                 over_analytic_gib=row["peak_allocated_gib"] - hift_pgs,
                 **row)
        secs["hift"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        emit("train_xlstm_breakdown", arch=cfg.name, batch=4, seq=512,
             **xlstm_train_breakdown(torch, runner, batches[0]))
        secs["breakdown"] = time.perf_counter() - t0
        launches = timer.launches()
        del runner
    del params
    t0 = time.perf_counter()
    with UpdateTimer(torch) as timer:
        params = fresh()
        runner = make_runner(cfg, "fpft", params=params, optimizer="adamw",
                             fused_update=True, schedule=sched,
                             device="cuda")
        del params
        fpft = fused_step(torch, runner, batches[0], base, timer=timer)
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
        del runner
    fpft_pgs = analytic(cfg, "fpft").pgs_gb
    emit("train_xlstm_step", arch=cfg.name, strategy="fpft",
         analytic_pgs_gib=fpft_pgs,
         over_analytic_gib=fpft["peak_allocated_gib"] - fpft_pgs, **fpft)
    hift_peak = max(r["peak_allocated_gib"] for r in rows)
    emit("train_xlstm_memory", arch=cfg.name, dtype="float32", batch=4,
         seq=512, n_params=analytic(cfg).n_params,
         hift_peak_gib=hift_peak, fpft_peak_gib=fpft["peak_allocated_gib"],
         hift_analytic_gib=hift_pgs, fpft_analytic_gib=fpft_pgs,
         saving=1 - hift_peak / fpft["peak_allocated_gib"],
         analytic_saving=1 - hift_pgs / fpft_pgs,
         host_ms=[[r["group"], r["host_ms"]] for r in rows],
         fpft_host_ms=fpft["host_ms"])
    secs["fpft"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = fresh()
    for strategy, kw in (("lomo", {"lomo": LOMOConfig(grad_clip=1.0)}),
                         ("adalomo", {}), ("mezo", {})):
        runner = make_runner(cfg, strategy, params=params, schedule=sched,
                             device="cuda", **kw)
        st = runner.strategy
        pgs = analytic(cfg, st.memory_mode, m=st.memory_m).pgs_gb
        row = fused_step(torch, runner, batches[0], base)
        emit("train_xlstm_step", arch=cfg.name, n_layers=cfg.n_layers,
             strategy=strategy, m=st.memory_m, analytic_pgs_gib=pgs,
             analytic_m1_pgs_gib=analytic(cfg, st.memory_mode).pgs_gb,
             over_analytic_gib=row["peak_allocated_gib"] - pgs, **row)
        if row["peak_allocated_gib"] - pgs > FUSED_ALLOWANCE_GIB:
            raise RuntimeError(f"{cfg.name} {strategy}: peak "
                               f"{row['peak_allocated_gib']:.2f} GiB exceeds "
                               f"the analytic {pgs:.2f} GiB by more than "
                               f"{FUSED_ALLOWANCE_GIB} GiB")
        del runner
        gc.collect()
        torch.cuda.empty_cache()
    del params
    secs["fused"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quant = QuantConfig("nf4", "bf16")
    params = encoded_init(torch, cfg, "nf4")
    DM.reset_launches()
    with UpdateTimer(torch) as timer, UpdateTimer(torch, DM) as dq:
        _nf4_steps(torch, cfg, params, batches, timer, dq, quant,
                   "train_xlstm_quant_step")
        launches["fused_adamw"] += timer.launches()["fused_adamw"]
    del params
    secs["nf4"] = time.perf_counter() - t0
    launches["dequant_matmul"] = DM.dequant_matmul.launches - \
        DM.dequant_matmul.launches_tc
    if not launches["dequant_matmul"] or not launches["fused_adamw"]:
        raise RuntimeError(f"xlstm training never launched a kernel: "
                           f"{launches}")
    if S.ssm_scan.launches or S.ssm_scan.launches_wide:
        raise RuntimeError("xlstm training launched a scan kernel, which "
                           "has no backward")
    gc.collect()
    torch.cuda.empty_cache()
    emit("train_xlstm_launches", launches=launches, seconds=secs,
         n_layers=cfg.n_layers)
    return launches


def phase_train_xlstm(torch, cpu=None, n_layers=None) -> dict:
    """The xlstm family trained on the card: ``phase_train_xlstm_full``
    (at ``n_layers``), then the card against the CPU (``cpu``: the CPU
    half, a ``CpuHalves`` job's result, or run here when None).  Each part's
    seconds in a line; returns the kernels' launches over the main-path
    runs."""
    secs = {}
    t0 = time.perf_counter()
    launches = phase_train_xlstm_full(torch, n_layers)
    secs["train_xlstm_full"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_train_xlstm_card_vs_cpu(torch, cpu=cpu)
    torch.cuda.empty_cache()
    secs["train_xlstm_card_vs_cpu"] = time.perf_counter() - t0
    emit("train_xlstm_seconds", seconds=secs, total=sum(secs.values()))
    return launches


# ------------------------------------------------------------ distributed

# Layers and batch of the cross-pod card-against-CPU training: 2 layers of
# gpt2-large's width, 4 x 64 (two pods of 2 rows)
DIST_CARD_VS_CPU = dict(n_layers=2, batch=4, seq=64)
# units a HiFT group of ``phase_train_dist``'s sweeps (4 groups of
# gpt2-large's 38 units, the first with the embedding, the last with the
# head: a host-bound step costs about the same at any m, and at m = 6 the
# sweeps took 24.9 s of the whole script's 760.0 on an H100)
DIST_M = 10
# steps after the first sweep: revisits of the first groups (the embed
# group's and a layer group's), whose bundles' pinned host buffers exist
# (a first visit pins new ones)
DIST_REVISITS = 2


def dist_train_side(torch, cfg, params, dev: str) -> dict:
    """One device's side of the cross-pod card-against-CPU training: HiFT
    m=1 with AdamW over embed, layer 0 and layer 1, then FPFT with AdamW,
    3 steps each, both under ``CrossPodConfig(pods=2, compress=True)``,
    from ``params`` (CPU tensors, copied per runner); the losses."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.core import CrossPodConfig, LRSchedule, make_runner
    batches = train_batches(cfg, DIST_CARD_VS_CPU["seq"],
                            DIST_CARD_VS_CPU["batch"], 3, "cpu")
    out = {}
    for strategy in ("hift", "fpft"):
        runner = make_runner(cfg, strategy,
                             params=tree_map(lambda t: t.to(dev), params),
                             optimizer="adamw",
                             schedule=LRSchedule(base_lr=1e-4),
                             cross_pod=CrossPodConfig(pods=2, compress=True),
                             device=dev)
        out[strategy] = [float(runner.train_step(b)) for b in batches]
        del runner
    return out


def dist_train_cpu(torch):
    """The CPU half of the cross-pod card-against-CPU training
    (``CpuHalves``): the params of seed 0 drawn on the CPU and the CPU's
    losses."""
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("gpt2-large"),
                              n_layers=DIST_CARD_VS_CPU["n_layers"])
    params = host_params(torch, cfg, on_card=False)
    return params, dist_train_side(torch, cfg, params, "cpu")


class CompressTimer:
    """While in use: CUDA events around each call of the cross-pod
    reduce's codec (``core.strategy.compress_decompress``, a leaf a
    call)."""

    def __init__(self, torch):
        self.torch, self.events = torch, []

    def __enter__(self):
        from repro_torch.core import strategy as st
        fn, cuda = st.compress_decompress, self.torch.cuda
        self._fn = fn

        def timed(*args):
            e0 = cuda.Event(enable_timing=True)
            e1 = cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            self.events.append((e0, e1))
            return out

        st.compress_decompress = timed
        return self

    def __exit__(self, *exc):
        from repro_torch.core import strategy as st
        st.compress_decompress = self._fn

    def take(self) -> float:
        self.torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.events)
        self.events.clear()
        return ms


def _sweep(torch, runner, batches, timer) -> list:
    """``measured_step`` on each batch in turn."""
    return [measured_step(torch, runner, b, timer) for b in batches]


def _by_kind(rows, key="host_ms", revisit=False) -> dict:
    """Median of ``key`` per group kind over the first visits (or over the
    revisits)."""
    kinds = {}
    for r in rows:
        if r.get("revisit", False) == revisit:
            kinds.setdefault(r["kind"], []).append(r[key])
    return {k: statistics.median(v) for k, v in kinds.items()}


def _ef_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for b in state.opt_state.values()
               for t in _leaves(b.get("ef", {})))


def _leaves(tree):
    from repro_torch.common.pytree import flatten_with_paths
    return list(flatten_with_paths(tree).values())


def _copy(torch, params):
    from repro_torch.common.pytree import tree_map
    return tree_map(lambda t: t.clone(), params)


def phase_train_dist(torch, cpu=None) -> dict:
    """Distributed training on one card.

    a. cross-pod card against CPU, first (it warms the card for the
       sweeps): 2 layers of gpt2-large, 4 x 64, HiFT and FPFT 3 steps
       each, losses within rtol 1e-4 (``cpu`` is the CPU half,
       ``dist_train_cpu``, run here when None);
    b. ``init_distributed`` through NCCL with a ``FileStore`` in a
       temporary directory, ``mesh_from_spec("1x1")``; then gpt2-large (36
       layers, fp32, AdamW, 4 x 512, m = ``DIST_M``), three sweeps (4
       steps each, a step of each in turn, then ``DIST_REVISITS``
       revisits) on the same
       batches from the same params, peaks net of the other two runners'
       params: plain HiFT, HiFT on the mesh
       (losses within rtol 1e-6 of the plain sweep's; the ratio of median
       host ms) and HiFT under ``CrossPodConfig(pods=2, compress=True)``
       (host ms per group kind beside plain's, peaks beside the memory
       model's with ``ef_pods=2``, the residual bytes in the bundles, the
       codec's share of each step by CUDA events around it, a profiled
       revisit); FPFT cross-pod's peak (its residuals on the card)
       beside its analytic figure;
    c. a checkpoint under the mesh of 2 layers of gpt2-large restored with
       ``restore_state(strategy=)`` onto a fresh mesh-built runner, 2
       steps bit-equal to the uninterrupted run; deepseek-moe-16b at 2
       layers under the context: ``moe_ffn_spmd`` at tp = 1 equal to
       ``moe_ffn`` bit for bit, and 2 HiFT steps on the mesh equal to 2
       without;
    d. quantized HiFT at full width on the mesh against plain
       (``phase_dist_quant``: NF4 through kernel 7, Mixed^Hi + int8
       through kernel 7b), then ``fpft_streamed`` at full width and
       ``lomo``/``adalomo`` with ``stream=`` at 2 layers
       (``phase_dist_stream``), each bit-equal to no mesh.

    Returns the fused updates' launches over the sweeps (b) and the
    launches of rows 7, 7b and 4 in part d."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.common.pytree import tree_bytes
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (CrossPodConfig, HiFTConfig, LRSchedule,
                                  make_runner)
    from repro_torch.dist import ctx as dctx
    from repro_torch.launch.mesh import init_distributed, mesh_from_spec
    from repro_torch.train import checkpoint as ckpt
    cfg = get_config("gpt2-large")
    params = fresh_params(torch, cfg)
    # a sweep of first visits, then DIST_REVISITS steps that revisit the
    # first groups (their bundles' pinned buffers reused)
    k = -(-(cfg.n_layers + 2) // DIST_M)
    batches = train_batches(cfg, 512, 4, k + DIST_REVISITS, "cuda")
    cp = CrossPodConfig(pods=2, compress=True)
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now


    def runner(p, **kw):
        return make_runner(cfg, "hift", params=p, optimizer="adamw",
                           hift=HiFTConfig(m=DIST_M),
                           schedule=LRSchedule(base_lr=1e-5),
                           device="cuda", **kw)

    phase_dist_card_vs_cpu(torch, cpu)
    part("card_vs_cpu")
    # b. the sweeps, a step of each in turn on the same batch, so the three
    # runners meet the same allocator state (a group's first visit pins
    # new host buffers for its bundle); the last trains ``params`` in
    # place, so the others start from copies made first
    launches = {}
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_")
    init_distributed(f"file://{tmp.name}/store", 1, 0, device="cuda")
    try:
        mesh = mesh_from_spec("1x1")
        kws = {"plain": {}, "mesh": dict(mesh=mesh),
               "crosspod": dict(cross_pod=cp)}
        runners = {name: runner(params if name == "crosspod" else
                                _copy(torch, params), **kw)
                   for name, kw in kws.items()}
        others = (len(runners) - 1) * tree_bytes(params)
        sweeps = {name: dict(rows=[]) for name in runners}
        with UpdateTimer(torch) as timer, CompressTimer(torch) as comp:
            for i, b in enumerate(batches):
                for name, r in runners.items():
                    row = measured_step(torch, r, b, timer)
                    row["revisit"] = i >= k
                    # the step's own peak: the other runners' params aside
                    row["peak_memory_bytes"] -= others
                    row["peak_memory_gib"] = row["peak_memory_bytes"] / 2**30
                    row["compress_ms"] = comp.take()
                    sweeps[name]["rows"].append(row)
            launches = timer.launches()
        for name, sw in sweeps.items():
            sw["fused_adamw"] = sum(x["update_launches"] for x in sw["rows"])
        sweeps["crosspod"]["ef_bytes"] = _ef_bytes(runners["crosspod"].state)
        prof = phase_dist_profile(torch, runners["crosspod"], batches[0])
        del runners
        gc.collect()
        torch.cuda.empty_cache()
        # the three runners' pinned bundles (~25 GB) go back to the host:
        # the moe/encdec phases' CPU child needs that memory later
        torch._C._host_emptyCache()
        part("sweeps")
        plain, cross = sweeps["plain"]["rows"], sweeps["crosspod"]["rows"]
        model = analytic(cfg, ef_pods=2, m=DIST_M).pgs_gb
        emit("train_dist_crosspod", arch=cfg.name, n_layers=cfg.n_layers,
             m=DIST_M, batch=4, seq=512, pods=2, compress=True,
             step_ms_by_kind=_by_kind(cross),
             plain_step_ms_by_kind=_by_kind(plain),
             revisit_step_ms_by_kind=_by_kind(cross, revisit=True),
             plain_revisit_step_ms_by_kind=_by_kind(plain, revisit=True),
             compress_ms_by_kind=_by_kind(cross, "compress_ms"),
             compress_share_by_kind={
                 k: v / _by_kind(cross)[k]
                 for k, v in _by_kind(cross, "compress_ms").items()},
             peak_memory_gib=max(r["peak_memory_gib"] for r in cross),
             plain_peak_memory_gib=max(r["peak_memory_gib"] for r in plain),
             analytic_pgs_gib=model,
             analytic_plain_pgs_gib=analytic(cfg, m=DIST_M).pgs_gb,
             ef_residual_bytes_in_bundles=sweeps["crosspod"]["ef_bytes"],
             fused_adamw_launches=sweeps["crosspod"]["fused_adamw"],
             profile=prof,
             losses=[r["loss"] for r in cross],
             plain_losses=[r["loss"] for r in plain])
        if sweeps["crosspod"]["fused_adamw"] != len(batches):
            raise RuntimeError("cross-pod HiFT did not run the fused AdamW "
                               "once a step")
        def ratio(rows, revisit):
            return (statistics.median(r["host_ms"] for r in rows
                                      if r["revisit"] == revisit)
                    / statistics.median(r["host_ms"] for r in plain
                                        if r["revisit"] == revisit))

        gap = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
                  zip(sweeps["mesh"]["rows"], plain))
        emit("train_dist_mesh", arch=cfg.name, mesh={"data": 1, "model": 1},
             backend=dist.get_backend(),
             step_ms_by_kind=_by_kind(sweeps["mesh"]["rows"]),
             plain_step_ms_by_kind=_by_kind(plain),
             revisit_step_ms_by_kind=_by_kind(sweeps["mesh"]["rows"],
                                              revisit=True),
             plain_revisit_step_ms_by_kind=_by_kind(plain, revisit=True),
             median_step_ratio=ratio(sweeps["mesh"]["rows"], False),
             median_revisit_step_ratio=ratio(sweeps["mesh"]["rows"], True),
             crosspod_median_step_ratio=ratio(cross, False),
             crosspod_median_revisit_step_ratio=ratio(cross, True),
             max_rel_loss_gap=gap, rtol=1e-6,
             fused_adamw_launches=sweeps["mesh"]["fused_adamw"],
             peak_memory_gib=max(r["peak_memory_gib"] for r in
                                 sweeps["mesh"]["rows"]))
        if gap > 1e-6:
            raise RuntimeError(f"the 1x1 mesh's losses differ from the "
                               f"plain sweep's by {gap:.3g} (relative)")
        if sweeps["mesh"]["fused_adamw"] != len(batches):
            raise RuntimeError("the mesh's HiFT did not run the fused AdamW "
                               "once a step")
        del params, sweeps
        gc.collect()
        torch.cuda.empty_cache()
        phase_dist_fpft_peak(torch, cfg, cp)
        part("fpft_crosspod")
        phase_dist_checkpoint(torch, mesh, tmp.name)
        part("checkpoint")
        phase_dist_moe(torch, mesh, dctx)
        part("moe")
        # d. the last options the mesh refused: quantized residency
        # (kernels 7/7b on a sharded step), the streamed strategies
        for name, n in phase_dist_quant(torch, mesh).items():
            launches[name] = launches.get(name, 0) + n
        part("quant")
        phase_dist_stream(torch, mesh)
        part("stream")
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
        torch._C._host_emptyCache()
    emit("train_dist_seconds", **parts)
    return launches


def phase_dist_profile(torch, runner, batch) -> dict:
    """``torch.profiler`` over one cross-pod step (the runner's next
    group, a revisit of a layer), with the device's busy ms and idle
    share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        runner.train_step(batch)
        torch.cuda.synchronize()
        host_ms = 1e3 * (time.perf_counter() - t0)
    return dict(group=runner.last_metrics["group"],
                **profile_summary(prof, host_ms, top=6,
                                  gemm_ms="gemm", adamw_ms="fused_adamw"))


def phase_dist_fpft_peak(torch, cfg, cp) -> None:
    """FPFT with AdamW at full size, one step plain and one under the
    cross-pod reduce (its residuals, 2 x the params in fp32, on the card),
    each from fresh params: the peaks beside the memory model's ``fpft``
    figures without and with ``ef_pods=2``."""
    from repro_torch.core import LRSchedule, make_runner
    batch = train_batches(cfg, 512, 4, 1, "cuda")
    rows, ef = {}, 0
    for name, kw in (("plain", {}), ("crosspod", dict(cross_pod=cp))):
        r = make_runner(cfg, "fpft", params=fresh_params(torch, cfg),
                        optimizer="adamw", schedule=LRSchedule(base_lr=1e-5),
                        device="cuda", **kw)
        with UpdateTimer(torch) as timer:
            rows[name] = _sweep(torch, r, batch, timer)[0]
        if name == "crosspod":
            ef = sum(t.numel() * t.element_size()
                     for t in _leaves(r.state.extra["ef_residual"]))
        del r
        gc.collect()
        torch.cuda.empty_cache()
    emit("train_dist_fpft_crosspod", arch=cfg.name, batch=4, seq=512,
         pods=2, host_ms=rows["crosspod"]["host_ms"],
         plain_host_ms=rows["plain"]["host_ms"],
         peak_memory_gib=rows["crosspod"]["peak_memory_gib"],
         plain_peak_memory_gib=rows["plain"]["peak_memory_gib"],
         analytic_pgs_gib=analytic(cfg, mode="fpft", ef_pods=2).pgs_gb,
         analytic_plain_pgs_gib=analytic(cfg, mode="fpft").pgs_gb,
         ef_residual_bytes=ef, loss=rows["crosspod"]["loss"],
         plain_loss=rows["plain"]["loss"])


def phase_dist_card_vs_cpu(torch, cpu=None) -> None:
    from repro_torch.configs.registry import get_config
    cfg = dataclasses.replace(get_config("gpt2-large"),
                              n_layers=DIST_CARD_VS_CPU["n_layers"])
    params, host = cpu or dist_train_cpu(torch)
    card = dist_train_side(torch, cfg, params, "cuda")
    rel = max(abs(a - b) / abs(a) for s in ("hift", "fpft")
              for a, b in zip(host[s], card[s]))
    emit("train_dist_card_vs_cpu", arch=cfg.name, n_layers=cfg.n_layers,
         **{k: v for k, v in DIST_CARD_VS_CPU.items() if k != "n_layers"},
         pods=2, cpu_losses=host, cuda_losses=card, max_rel_loss_gap=rel,
         rtol=1e-4)
    if rel > 1e-4 or not all(math.isfinite(x) for s in card.values()
                             for x in s):
        raise RuntimeError(f"cross-pod card and CPU losses differ: "
                           f"{host} {card}")


def phase_dist_checkpoint(torch, mesh, tmp: str) -> None:
    """2 layers of gpt2-large, HiFT with AdamW on the 1x1 mesh: a sweep,
    a checkpoint under the mesh, ``restore_state(strategy=)`` onto a fresh
    mesh-built runner, 2 steps there and on the uninterrupted runner,
    bit-equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    from repro_torch.train import checkpoint as ckpt
    cfg = dataclasses.replace(get_config("gpt2-large"), n_layers=2)
    batches = train_batches(cfg, 512, 4, cfg.n_layers + 4, "cuda")

    def runner():
        return make_runner(cfg, "hift", params=fresh_params(torch, cfg),
                           optimizer="adamw", hift=HiFTConfig(m=1),
                           schedule=LRSchedule(base_lr=1e-5), device="cuda",
                           mesh=mesh)

    r = runner()
    for b in batches[:cfg.n_layers + 2]:
        r.train_step(b)
    d = Path(tmp) / "ckpt"
    t0 = time.perf_counter()
    ckpt.save_state(d, r.step_count, r.state)
    save_s = time.perf_counter() - t0
    gathered = ckpt.save.gathered_leaves
    fresh = runner()
    t0 = time.perf_counter()
    fresh.state = ckpt.restore_state(d, r.step_count,
                                     strategy=fresh.strategy)
    restore_s = time.perf_counter() - t0
    tail = batches[cfg.n_layers + 2:]
    want = [float(r.train_step(b)) for b in tail]
    got = [float(fresh.train_step(b)) for b in tail]
    emit("train_dist_checkpoint", arch=cfg.name, n_layers=cfg.n_layers,
         mesh={"data": 1, "model": 1}, step=int(r.step_count) - 2,
         save_s=save_s, restore_s=restore_s, dtensor_leaves=gathered,
         resumed_losses=got, uninterrupted_losses=want,
         bit_equal=got == want)
    if got != want:
        raise RuntimeError(f"the restored mesh runner left lockstep: {got} "
                           f"!= {want}")
    del r, fresh
    gc.collect()
    torch.cuda.empty_cache()


def phase_dist_moe(torch, mesh, dctx) -> None:
    """deepseek-moe-16b at 2 layers: layer 0's moe FFN on a 4 x 512 batch
    of activations under the context (``moe_ffn_spmd`` at tp = 1) against
    ``moe_ffn``, bit for bit; then a HiFT step of layer 0 (AdamW) with and
    without the mesh from the same params, losses bit-equal."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.registry import get_config
    from repro_torch.core import HiFTConfig, LRSchedule, make_runner
    from repro_torch.models import get_family
    from repro_torch.models import moe as M
    cfg = dataclasses.replace(get_config("deepseek-moe-16b"), n_layers=2)
    gc.collect()
    torch.cuda.empty_cache()
    params = get_family(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    p0 = tree_map(lambda t: t[0], params["layers"]["moe"])
    x = torch.randn(4, 512, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1))
    with torch.no_grad():
        want = M.moe_ffn(p0, x, cfg)
        with dctx.activation_sharding(mesh, ("data",)):
            got = M.moe_ffn_auto(p0, x, cfg)
    batches = train_batches(cfg, 512, 4, 2, "cuda")
    losses = {}
    for name, kw in (("mesh", dict(mesh=mesh)), ("plain", {})):
        r = make_runner(cfg, "hift",
                        params=params if name == "plain" else
                        _copy(torch, params), optimizer="adamw",
                        hift=HiFTConfig(m=1, strategy="top2down"),
                        schedule=LRSchedule(base_lr=1e-5), device="cuda",
                        **kw)
        losses[name] = [float(r.train_step(b)) for b in batches]
        del r
    emit("train_dist_moe", arch=cfg.name, n_layers=2, tokens=4 * 512,
         spmd_equals_moe_ffn=bool(torch.equal(got, want)),
         max_abs_err=float((got - want).abs().max()),
         mesh_losses=losses["mesh"], plain_losses=losses["plain"])
    if not torch.equal(got, want) or losses["mesh"] != losses["plain"]:
        raise RuntimeError("moe_ffn_spmd at tp = 1 is not moe_ffn bit for "
                           f"bit: {losses}")
    del params, x, got, want
    gc.collect()
    torch.cuda.empty_cache()


def phase_dist_quant(torch, mesh) -> dict:
    """Part (d)(i) of ``phase_train_dist``: gpt2-large at full width (36
    layers, 4 x 512, HiFT m = ``DIST_M``, AdamW) with quantized residency,
    fp32 + ``QuantConfig(frozen="nf4")`` (every frozen projection through
    kernel 7, fp32 x) and then Mixed^Hi + ``QuantConfig(frozen="int8",
    moments="bf16")`` (kernel 7b, bf16 x), each plain and on the 1x1 mesh
    from the same params, a step of each in turn for one sweep.  The
    losses and the resident codes and scales after the sweep must be
    bit-equal, and the mesh's launches of rows 7 and 7b equal plain's and
    above 0.  Returns the part's launches of rows 7, 7b and 4."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.configs.registry import get_config
    from repro_torch.core import (HiFTConfig, LRSchedule, QuantConfig,
                                  make_runner)
    from repro_torch.dist import shardings as S
    from repro_torch.kernels import dequant_matmul as DM
    from repro_torch.optim.mixed_precision import get_policy
    cfg = get_config("gpt2-large")
    k = -(-(cfg.n_layers + 2) // DIST_M)
    batches = train_batches(cfg, 512, 4, k, "cuda")
    plan = (("fp32", QuantConfig(frozen="nf4")),
            ("mixed_hi", QuantConfig(frozen="int8", moments="bf16")))
    rows = {"plain": [], "mesh": []}
    counts = {name: {"dequant_matmul": 0, "dequant_matmul_bf16": 0,
                     "fused_adamw": 0} for name in rows}
    codes_equal = True
    with UpdateTimer(torch, DM) as dq, UpdateTimer(torch) as timer:
        for policy, quant in plan:
            params = fresh_params(torch, cfg)
            # each runner from its own tensors: the leaves no codec
            # encodes (1-d, the final norm's) stay the caller's, and the
            # first update of their group writes them in place on the card
            runners = {name: make_runner(
                cfg, "hift", params=params if name == "mesh" else
                _copy(torch, params), optimizer="adamw",
                hift=HiFTConfig(m=DIST_M), policy=get_policy(policy),
                quant=quant, schedule=LRSchedule(base_lr=1e-5),
                device="cuda", **kw)
                for name, kw in (("plain", {}), ("mesh", dict(mesh=mesh)))}
            del params
            gc.collect()
            torch.cuda.empty_cache()
            for b in batches:
                for name, r in runners.items():
                    tc0 = DM.dequant_matmul.launches_tc
                    dq.take()
                    row = measured_step(torch, r, b, timer)
                    _, n = dq.take()
                    tc = DM.dequant_matmul.launches_tc - tc0
                    row.update(policy=policy, quant=quant.frozen,
                               dequant_launches=n - tc,
                               dequant_launches_tc=tc)
                    rows[name].append(row)
                    counts[name]["dequant_matmul"] += n - tc
                    counts[name]["dequant_matmul_bf16"] += tc
                    counts[name]["fused_adamw"] += row["update_launches"]
            plain = flatten_with_paths(runners["plain"].params)
            meshed = flatten_with_paths(S.local(runners["mesh"].params))
            same = plain.keys() == meshed.keys() and all(
                torch.equal(t, meshed[p]) for p, t in plain.items())
            emit("train_dist_quant_codes", arch=cfg.name, policy=policy,
                 quant=quant.frozen, leaves=len(plain), bit_equal=same)
            codes_equal = codes_equal and same
            del runners, plain, meshed
            gc.collect()
            torch.cuda.empty_cache()
            torch._C._host_emptyCache()
    ratio = statistics.median(
        m["host_ms"] / p["host_ms"] for m, p in zip(rows["mesh"],
                                                    rows["plain"]))
    losses = {name: [r["loss"] for r in rs] for name, rs in rows.items()}
    emit("train_dist_quant", arch=cfg.name, n_layers=cfg.n_layers,
         m=DIST_M, batch=4, seq=512, mesh={"data": 1, "model": 1},
         plan=[f"{pol}/{q.frozen}/{q.moments or 'fp32'}" for pol, q in plan],
         mesh_losses=losses["mesh"], plain_losses=losses["plain"],
         step_ms=[r["host_ms"] for r in rows["mesh"]],
         plain_step_ms=[r["host_ms"] for r in rows["plain"]],
         median_step_ratio=ratio, codes_bit_equal=codes_equal,
         launches=counts)
    if losses["mesh"] != losses["plain"] or not codes_equal:
        raise RuntimeError(f"quantized HiFT on the 1x1 mesh left the plain "
                           f"run: {losses}, codes equal {codes_equal}")
    for kernel in ("dequant_matmul", "dequant_matmul_bf16"):
        if counts["mesh"][kernel] != counts["plain"][kernel] or \
                not counts["mesh"][kernel]:
            raise RuntimeError(f"{kernel}: {counts['mesh'][kernel]} "
                               f"launches on the mesh, "
                               f"{counts['plain'][kernel]} plain")
    return {kernel: counts["plain"][kernel] + counts["mesh"][kernel]
            for kernel in counts["mesh"]}


def phase_dist_stream(torch, mesh) -> None:
    """Part (d)(ii) of ``phase_train_dist``: gpt2-large ``fpft_streamed``
    (fp32, AdamW, 64 MiB chunks, depth 3, 2 steps) plain and on the 1x1
    mesh from the same params, the params and the pinned host moments
    bit-equal; then ``lomo`` and ``adalomo`` with ``stream=`` at 2 layers
    of its width, plain and on the mesh, 2 steps, bit-equal."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import LRSchedule, StreamConfig, make_runner
    from repro_torch.dist import shardings as S
    cfg = get_config("gpt2-large")
    batches = train_batches(cfg, 512, 4, 2, "cuda")
    params = fresh_params(torch, cfg)
    kw = dict(optimizer="adamw", schedule=LRSchedule(base_lr=1e-5),
              device="cuda", stream_window=STREAM_WINDOW,
              pipeline_depth=STREAM_DEPTH)
    runners = {"mesh": make_runner(cfg, "fpft_streamed",
                                   params=_copy(torch, params), mesh=mesh,
                                   **kw),
               "plain": make_runner(cfg, "fpft_streamed", params=params,
                                    **kw)}
    del params
    out = {name: [] for name in runners}
    for b in batches:
        for name, r in runners.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(r.train_step(b))
            torch.cuda.synchronize()
            out[name].append(dict(loss=loss, host_ms=1e3 * (
                time.perf_counter() - t0)))
    plain, meshed = runners["plain"], runners["mesh"]
    bad = (_host_trees_unequal(torch, plain.params, S.local(meshed.params))
           + _host_trees_unequal(torch, plain.opt_state,
                                 S.local(meshed.opt_state)))
    stats = dataclasses.asdict(meshed.strategy.stream_stats)
    pinned = all(t.is_pinned() for t in _leaves(S.local(meshed.opt_state))
                 if t.is_floating_point())
    emit("train_dist_stream", arch=cfg.name, n_layers=cfg.n_layers,
         mesh={"data": 1, "model": 1}, stream_window=STREAM_WINDOW,
         depth=STREAM_DEPTH,
         mesh_losses=[x["loss"] for x in out["mesh"]],
         plain_losses=[x["loss"] for x in out["plain"]],
         step_ms=[x["host_ms"] for x in out["mesh"]],
         plain_step_ms=[x["host_ms"] for x in out["plain"]],
         unequal_leaves=bad, moments_pinned=pinned, stream_stats=stats,
         plain_stream_stats=dataclasses.asdict(plain.strategy.stream_stats))
    if bad or not pinned or [x["loss"] for x in out["mesh"]] != \
            [x["loss"] for x in out["plain"]]:
        raise RuntimeError(f"fpft_streamed on the 1x1 mesh left the plain "
                           f"run: {out}, unequal {bad[:4]}, pinned {pinned}")
    del runners, plain, meshed
    gc.collect()
    torch.cuda.empty_cache()
    torch._C._host_emptyCache()
    cut = dataclasses.replace(cfg, n_layers=2)
    batches = train_batches(cut, 512, 4, 2, "cuda")
    for strategy in ("lomo", "adalomo"):
        params = fresh_params(torch, cut)
        got = {}
        for name, extra in (("mesh", dict(mesh=mesh)), ("plain", {})):
            r = make_runner(cut, strategy, params=params if name == "plain"
                            else _copy(torch, params),
                            schedule=LRSchedule(base_lr=1e-5),
                            stream=StreamConfig(), device="cuda", **extra)
            losses = [float(r.train_step(b)) for b in batches]
            torch.cuda.synchronize()
            got[name] = (losses, S.gather(r.params), r.opt_state)
        bad = _host_trees_unequal(torch, got["plain"][1], got["mesh"][1])
        if strategy == "adalomo":
            bad += _host_trees_unequal(torch,
                                       got["plain"][2]["moments"],
                                       S.gather(got["mesh"][2]["moments"]))
        emit("train_dist_stream_fused", arch=cut.name, n_layers=2,
             strategy=strategy, mesh_losses=got["mesh"][0],
             plain_losses=got["plain"][0], unequal_leaves=bad)
        if bad or got["mesh"][0] != got["plain"][0]:
            raise RuntimeError(f"{strategy} stream= on the 1x1 mesh left the "
                               f"plain run: {got['mesh'][0]} "
                               f"{got['plain'][0]}, unequal {bad[:4]}")
        del got, params
        gc.collect()
        torch.cuda.empty_cache()


# ------------------------------------------------------- mesh= serving

SERVE_MESH_NEW = 16          # llama2-7b's new tokens a request
SERVE_MESH_FAMILY_NEW = 8    # the other families'
# each other family at 2 layers, or at the fewest its structure allows:
# zamba2's shared block comes every 6 layers, xlstm's sLSTM every 8;
# seamless as 1 encoder + 1 decoder layer
SERVE_MESH_FAMILIES = (("zamba2-2.7b", 6), ("xlstm-1.3b", 8),
                       ("seamless-m4t-large-v2", 2),
                       ("deepseek-moe-16b", 2), ("internvl2-26b", 2))
# the kernels each family's serving must launch (bf16)
SERVE_MESH_KERNELS = {"zamba2-2.7b": ("ssm_scan_bf16", "flash_attention",
                                      "flash_decode"),
                      "xlstm-1.3b": ("ssm_scan_wide_bf16",)}


def gathered_extra_bytes(params) -> int:
    """The bytes a gather of a placed tree allocates: leaves whose full
    tensor is not the rank's own shard."""
    from repro_torch.common.pytree import flatten_with_paths
    from repro_torch.dist import shardings as S
    full = flatten_with_paths(S.gather(params))
    mine = flatten_with_paths(S.local(params))
    return sum(t.numel() * t.element_size() for p, t in full.items()
               if t.data_ptr() != mine[p].data_ptr())


def first_divergence(a: list, b: list) -> list:
    """Each row's first index where two generations differ (its length
    where none does)."""
    return [next((i for i, (x, y) in enumerate(zip(r, q)) if x != y),
                 len(r)) for r, q in zip(a, b)]


def greedy_rows(torch, cfg, params, tokens, pad, max_len: int, new: int,
                dt) -> tuple:
    """``ServeEngine.generate``'s loop (dense family) on rows already
    padded: their greedy tokens and the prefill's logits."""
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import greedy_sample
    cache = T.init_cache(cfg, tokens.shape[0], max_len, dtype=dt,
                         device="cuda")
    first, cache = T.prefill(cfg, params, {"tokens": tokens, "pad": pad},
                             cache, dt)
    toks = [greedy_sample(first[:, -1])]
    for _ in range(new - 1):
        logits, cache = T.decode_step(cfg, params, cache,
                                      toks[-1].reshape(-1, 1).long(), dt)
        toks.append(greedy_sample(logits[:, -1]))
    return torch.stack(toks, dim=1).tolist(), first


def serve_mesh_full(torch, mesh, full=None) -> dict:
    """(a) llama2-7b bf16 at full size, both engines without and with
    ``mesh`` in turns (plain, mesh, mesh, plain) on ``phase_full``'s
    prompts (its tree, popped from ``full``, or a fresh one),
    ``SERVE_MESH_NEW`` new tokens: bit-equal tokens, the decode steps'
    median host ms of each, the gathered tree's extra bytes; the
    attention kernels' launches over the mesh's runs.
    Then (d), printed only: rows 0-1 and 2-3 as two batch-2 engines
    against one batch-4 engine, and the same rows split with the four's
    padding, as two data ranks would run them (tokens, the first
    divergence, the prefill logits' largest difference)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import ServeEngine
    dt, new = torch.bfloat16, SERVE_MESH_NEW
    if full:
        cfg, params, prompts = full.pop("cfg"), full.pop("params"), \
            full.pop("prompts")
    else:
        cfg = get_config("llama2-7b")
        params = T.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda", dtype=dt)
        prompts = full_prompts(cfg)
    # turns plain, mesh, mesh, plain: the host-bound steps drift with the
    # CPU halves' thread beside them
    turns = {"plain": [], "mesh": []}
    for i, (name, m) in enumerate((("plain", None), ("mesh", mesh),
                                   ("mesh", mesh), ("plain", None))):
        step_ms = []
        if i == 1:
            K.reset_launches()           # count the mesh's runs only
        ceng, cont, fixed, t_cont, t_fixed = serve_both(
            torch, cfg, params, prompts, new, dt, "cuda", slots=4,
            prefill_bucket=32, max_blocks=-(-(512 + new) // 16), mesh=m,
            step_ms=step_ms)
        turns[name].append(dict(
            tokens=(cont, fixed), wall_s=(t_cont, t_fixed),
            step_ms=([1e3 * x for x in ceng.decode_seconds], step_ms)))
        if i == 2:
            launches = attention_launches(K, "bfloat16")
            fp32_prefill = K.flash_attention.launches - \
                launches["flash_attention"]
            extra = gathered_extra_bytes(ceng.params)
        del ceng

    def median(name, e):
        return statistics.median(x for t in turns[name]
                                 for x in t["step_ms"][e])

    want = turns["plain"][0]["tokens"]
    equal = {e: all(t["tokens"][i] == want[i] for ts in turns.values()
                    for t in ts)
             for i, e in enumerate(("continuous", "fixed"))}
    emit("serve_mesh_full", arch=cfg.name, n_layers=cfg.n_layers,
         dtype="bfloat16", mesh={"data": 1, "model": 1},
         prompt_lens=[len(p) for p in prompts], new_tokens=new,
         turns="plain mesh mesh plain", tokens_equal=equal,
         gathered_extra_bytes=extra, launches=launches,
         **{f"{e}_{k}": v for i, e in enumerate(("continuous", "fixed"))
            for k, v in (
                ("step_ms_median_plain", median("plain", i)),
                ("step_ms_median_mesh", median("mesh", i)),
                ("step_ratio", median("mesh", i) / median("plain", i)),
                ("turn_step_ms_medians", {
                    name: [statistics.median(t["step_ms"][i]) for t in ts]
                    for name, ts in turns.items()}),
                ("turn_wall_s", {name: [t["wall_s"][i] for t in ts]
                                 for name, ts in turns.items()}))})
    if not all(equal.values()):
        raise RuntimeError(f"the 1x1 mesh's tokens differ from the plain "
                           f"engines': {equal}")
    if extra != 0:
        raise RuntimeError(f"the 1x1 mesh's gather copied {extra} bytes")
    missing = [k for k, n in launches.items() if n == 0]
    if missing or fp32_prefill:
        raise RuntimeError(f"the mesh's serving missed kernels {missing} "
                           f"or ran the fp32 prefill {fp32_prefill} times: "
                           f"{launches}")
    # (d) rows split as two data ranks would hold them, printed only
    four = prompts[:4]
    plen = max(len(p) for p in four)
    eng4 = ServeEngine(cfg, params, max_len=plen + new, batch=4,
                       compute_dtype=dt, device="cuda")
    eng2 = ServeEngine(cfg, params, max_len=plen + new, batch=2,
                       compute_dtype=dt, device="cuda")
    whole = eng4.generate(four, new)
    halves = eng2.generate(four[:2], new) + eng2.generate(four[2:], new)
    toks = torch.tensor(np.stack([np.pad(p, (plen - len(p), 0))
                                  for p in four]), device="cuda")
    pad = torch.tensor([plen - len(p) for p in four], dtype=torch.int32,
                       device="cuda")
    rows = {n: greedy_rows(torch, cfg, eng4.params, toks[lo:hi],
                           pad[lo:hi], plen + new, new, dt)
            for n, (lo, hi) in (("all", (0, 4)), ("0:2", (0, 2)),
                                ("2:4", (2, 4)))}
    split = rows["0:2"][0] + rows["2:4"][0]
    gap = float((torch.cat([rows["0:2"][1], rows["2:4"][1]])
                 - rows["all"][1]).abs().max())
    emit("serve_mesh_rows", arch=cfg.name, dtype="bfloat16",
         prompt_lens=[len(p) for p in four], new_tokens=new,
         engines_equal=whole == halves,
         engines_first_divergence=first_divergence(whole, halves),
         split_equal=split == rows["all"][0],
         split_first_divergence=first_divergence(rows["all"][0], split),
         split_prefill_logits_max_abs_diff=gap,
         note="engines: two batch-2 engines, each pair padded to its own "
              "longest prompt; split: the rows with the four's padding, "
              "as a data split keeps it, through generate's loop")
    del eng4, eng2, params, rows
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def serve_mesh_family(torch, mesh, arch: str, n_layers: int) -> dict:
    """(b) ``arch`` at full width and ``n_layers``, bf16, random weights
    from seed 0, ``ServeEngine`` at batch 4 (ragged prompts of 16-128
    tokens, ``SERVE_MESH_FAMILY_NEW`` new tokens) without and then with
    ``mesh``: bit-equal tokens; the kernels' launches over the mesh's
    run."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as K
    from repro_torch.kernels import ssm_scan as SK
    from repro_torch.models import get_family
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    if cfg.family == "encdec":
        cfg = dataclasses.replace(cfg, enc_layers=1, dec_layers=1)
    dt, new = torch.bfloat16, SERVE_MESH_FAMILY_NEW
    gc.collect()
    torch.cuda.empty_cache()
    params = get_family(cfg).init(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        dtype=dt)
    rng = np.random.default_rng(29)
    plens = [int(n) for n in rng.integers(16, 129, 4)]
    prompts = [rng.integers(1, cfg.vocab, n) for n in plens]
    kw = {}
    if cfg.family == "encdec":
        kw["src_embeds"] = torch.randn(
            (4, 128, cfg.d_model), device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(99))
    out = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        eng = ServeEngine(cfg, params, batch=4, compute_dtype=dt,
                          max_len=cfg.vision_tokens + max(plens) + new,
                          device="cuda", mesh=m)
        if m is not None:
            K.reset_launches()           # count the mesh's run only
            SK.reset_launches()
        t0 = time.perf_counter()
        out[name] = eng.generate(prompts, max_new_tokens=new, **kw)
        torch.cuda.synchronize()
        out[f"{name}_wall_s"] = time.perf_counter() - t0
        del eng
    launches = {**attention_launches(K, "bfloat16"),
                "ssm_scan_bf16": SK.ssm_scan.launches_bf16,
                "ssm_scan_wide_bf16": SK.ssm_scan.launches_wide_bf16}
    launches = {k: n for k, n in launches.items() if n}
    want = SERVE_MESH_KERNELS.get(arch, ("flash_attention", "flash_decode"))
    emit("serve_mesh_family", arch=arch, n_layers=n_layers, dtype="bfloat16",
         mesh={"data": 1, "model": 1}, prompt_lens=plens, new_tokens=new,
         tokens_equal=out["mesh"] == out["plain"], launches=launches,
         wall_s={k: out[f"{k}_wall_s"] for k in ("plain", "mesh")})
    if out["mesh"] != out["plain"]:
        raise RuntimeError(f"{arch}: the 1x1 mesh's tokens differ: {out}")
    if any(launches.get(k, 0) == 0 for k in want) or \
            K.flash_attention.launches != K.flash_attention.launches_tc or \
            SK.ssm_scan.launches != SK.ssm_scan.launches_bf16 or \
            SK.ssm_scan.launches_wide != SK.ssm_scan.launches_wide_bf16:
        raise RuntimeError(f"{arch}: the mesh's serving launched {launches}, "
                           f"wanted {want} in bf16")
    del params
    return launches


def serve_mesh_launcher(torch) -> dict:
    """(c) ``launch/serve.py --arch llama2-7b --no-smoke --requests 4
    --max-new 8`` (fp32: the prefill runs ``flash_attention_fp32``)
    without and then with ``--mesh 1x1``, its own world of one: the same
    tokens; the attention kernels' launches over the mesh's run."""
    from repro_torch.kernels import flash_attention as K
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", "llama2-7b", "--no-smoke", "--requests", "4",
            "--max-new", "8"]
    outs, wall = {}, {}
    for name, extra in (("plain", []), ("mesh", ["--mesh", "1x1"])):
        gc.collect()
        torch.cuda.empty_cache()
        if extra:
            K.reset_launches()           # count the mesh's run only
        t0 = time.perf_counter()
        outs[name] = launch_serve.main(argv + extra)
        wall[name] = time.perf_counter() - t0
    launches = {k: n for k, n in attention_launches(K, "float32").items()
                if n}
    emit("serve_mesh_launcher", argv=argv, mesh="1x1", dtype="float32",
         tokens_equal=outs["mesh"] == outs["plain"], launches=launches,
         wall_s=wall)
    if outs["mesh"] != outs["plain"]:
        raise RuntimeError(f"the launcher's --mesh 1x1 tokens differ: {outs}")
    if set(launches) != {"flash_attention_fp32", "flash_decode"}:
        raise RuntimeError(f"the launcher under --mesh launched {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_serve_mesh(torch, full=None) -> dict:
    """``mesh=`` serving at a world of one: ``init_distributed`` through
    NCCL with a ``FileStore`` in a temporary directory and a 1x1
    ``DeviceMesh``; (a) and (d) ``serve_mesh_full`` on ``full``'s tree,
    (b) ``serve_mesh_family`` for each of ``SERVE_MESH_FAMILIES``; then,
    the group left, (c) ``serve_mesh_launcher``, which joins a world of
    its own.  Returns the kernels' launches over the mesh's runs by
    instantiation."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, mesh_from_spec
    parts, t_part = {}, [time.perf_counter()]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - t_part[0]
        t_part[0] = now

    def add(counts):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_serve_mesh_")
    init_distributed(f"file://{tmp.name}/store", 1, 0, device="cuda")
    try:
        mesh = mesh_from_spec("1x1")
        launches = serve_mesh_full(torch, mesh, full)
        part("full")
        for arch, n in SERVE_MESH_FAMILIES:
            add(serve_mesh_family(torch, mesh, arch, n))
            part(arch)
    finally:
        dist.destroy_process_group()
        tmp.cleanup()
    add(serve_mesh_launcher(torch))
    part("launcher")
    emit("serve_mesh_seconds", **parts)
    return launches


def cpu_side(path: str, families: str) -> int:
    """The CPU sides of the moe and encdec card-against-CPU training, of
    each of ``families`` (comma-separated) in turn, pickled to ``path`` as
    {family: {"train": the side, "seconds": its seconds}}: ``CpuSide`` runs
    this in a child process on 6 of the host's threads beside the card's
    phases."""
    import pickle

    import torch
    torch.set_num_threads(6)
    out = {}
    for family in families.split(","):
        t0 = time.perf_counter()
        if family == "moe":
            side = moe_train_side(torch, moe_train_runs(torch), "cpu")
        else:
            side = encdec_train_side(torch, encdec_train_runs(torch), "cpu")
        out[family] = {"train": side, "seconds": time.perf_counter() - t0}
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return 0


class CpuHalves:
    """The CPU halves of the in-process card-against-CPU training phases
    (``train_card_vs_cpu_cpu``, ``fused_train_cpu``, ``quant_train_cpu``,
    ``hybrid_train_cpu``), one after another in a thread of their own,
    started on construction, beside the card's phases: their torch ops
    release the interpreter's lock, and they touch no CUDA (each draws its
    params on the CPU, so no device peak of another phase moves).
    ``take(name)`` waits for that job and returns its result, or raises
    what it raised."""

    def __init__(self, jobs):
        import threading
        self._done = {name: threading.Event() for name, _ in jobs}
        self._out = {}

        def run():
            for name, fn in jobs:
                t0 = time.perf_counter()
                try:
                    ok, value = True, fn()
                except BaseException as e:      # handed to take()
                    ok, value = False, e
                self._out[name] = (ok, value, t0, time.perf_counter())
                self._done[name].set()

        threading.Thread(target=run, daemon=True).start()

    def take(self, name: str):
        """Also emits the job's seconds, when it started (seconds since
        the import) and how long the take waited for it."""
        t0 = time.perf_counter()
        self._done[name].wait()
        ok, value, start, end = self._out.pop(name)
        emit("cpu_half", job=name, seconds=end - start,
             started_at_s=start - _START, wait_s=time.perf_counter() - t0)
        if not ok:
            raise value
        return value


class HostMemory:
    """The host's available memory (``MemAvailable`` of /proc/meminfo),
    read every half second by a thread of its own: ``take()`` returns the
    least reading in GiB since the last take."""

    def __init__(self):
        import threading
        self._low = math.inf
        threading.Thread(target=self._run, daemon=True).start()

    @staticmethod
    def available_gib() -> float:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) / 2**20
        return math.nan

    def _run(self) -> None:
        while True:
            self._low = min(self._low, self.available_gib())
            time.sleep(0.5)

    def take(self) -> float:
        low = min(self._low, self.available_gib())
        self._low = math.inf
        return low


class CpuSide:
    """``cpu_side`` of ``families`` in a child process, started on
    construction: joined and read with ``result`` (which raises if the
    child failed; a second call returns the same sides), killed by
    ``close`` if still running."""

    def __init__(self, families=("moe",)):
        import tempfile
        self.dir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
        self.path = os.path.join(self.dir.name, "cpu_side.pkl")
        self.err = open(os.path.join(self.dir.name, "stderr"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--cpu-side",
             self.path, "--cpu-side-families", ",".join(families)],
            stdout=subprocess.DEVNULL, stderr=self.err)
        self._out = None

    def result(self, family: str) -> dict:
        import pickle
        if self._out is None:
            rc = self.proc.wait(timeout=900)
            if rc != 0:
                self.err.seek(0)
                raise RuntimeError(f"the CPU sides' process failed ({rc}): "
                                   f"{self.err.read()[-2000:]}")
            with open(self.path, "rb") as f:
                self._out = pickle.load(f)
        return self._out[family]

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.err.close()
        self.dir.cleanup()


# ------------------------------------------------------------ main

TC_KERNELS = ("flash_attention_tc_kernel", "flash_attention_3xtf32_kernel",
              "dequant_matmul_wgmma_kernel", "ssm_scan_tc_kernel",
              "ssm_wide_walk_kernel")


def ptxas_usage(log: str) -> dict:
    """Registers and spill bytes per kernel from ``nvcc -Xptxas -v``'s
    report, by mangled name."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out[fn] = {}
        elif fn and "spill stores" in line:
            words = line.replace(",", "").split()
            out[fn].update(spill_stores=int(words[words.index("spill") - 2]),
                           spill_loads=int(words[-4]))
        elif fn and "registers" in line and "Used" in line:
            words = line.split()
            out[fn]["registers"] = int(words[words.index("Used") + 1])
    return out


def sass_mma(libs, usage: dict) -> dict:
    """Tensor-core instructions in the built kernels' SASS (``cuobjdump
    -sass`` beside nvcc): for each kernel of ``TC_KERNELS``, its
    instantiations, the number of HMMA (``mma.sync``) and HGMMA
    (``wgmma``) instructions in each, and ptxas's registers and spill
    bytes from ``usage`` (``ptxas_usage`` of the build's logs)."""
    from repro_torch.kernels import build
    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    out = {}
    for lib in libs.values():
        sass = subprocess.run([str(tool), "-sass", str(lib)],
                              capture_output=True, text=True, check=True,
                              timeout=120).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                name = line.split("Function :")[1].strip()
                fn = next((k for k in TC_KERNELS if k in name), None)
                if fn:
                    key = f"{fn}#{sum(k.startswith(fn) for k in out)}"
                    out[key] = dict(symbol=name[:120], hmma=0, hgmma=0,
                                    **usage.get(name, {}))
            elif fn and "HGMMA" in line:
                out[key]["hgmma"] += 1
            elif fn and "HMMA" in line:
                out[key]["hmma"] += 1
    return out


def phase_moe_vlm(torch, cpu: CpuSide | None = None) -> dict:
    """The moe and vlm families and the last dense configs: the attention
    kernels with a vision prefix and at smollm-360m's GQA, the card's
    side of the moe training card against CPU, deepseek-moe-16b trained
    and the dense and vlm configs trained at full size, the three served
    at full size, and moe and vlm served card against CPU.  The CPU side
    of the moe training runs in a child process (``cpu``, a ``CpuSide``
    started earlier, or one started here) beside the rest; its comparison
    comes last.  Each part's seconds in a line; returns the kernels'
    launches over the main-path runs."""
    launches, secs = {}, {}
    own = cpu is None
    cpu = cpu or CpuSide(("moe",))
    try:
        t0 = time.perf_counter()
        phase_kernels(torch, vlm_attention_cases())
        secs["kernels_vlm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        runs = moe_train_runs(torch)
        card = moe_train_side(torch, runs, "cuda")
        # the comparison keeps no runner kwargs (MeZO's kept z)
        runs = [r[:3] + (None,) + r[4:] for r in runs]
        gc.collect()
        torch.cuda.empty_cache()
        secs["train_moe_card_side"] = time.perf_counter() - t0
        for fn in (phase_train_moe_full, phase_train_dense_vlm_full,
                   phase_serve_moe_vlm_full):
            t0 = time.perf_counter()
            for kernel, n in fn(torch).items():
                launches[kernel] = launches.get(kernel, 0) + n
            secs[fn.__name__[len("phase_"):]] = time.perf_counter() - t0
        t0 = time.perf_counter()
        phase_serve_moe_vlm_card_vs_cpu(torch)
        torch.cuda.empty_cache()
        secs["serve_moe_vlm_card_vs_cpu"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sides = cpu.result("moe")
        secs["cpu_side_wait"] = time.perf_counter() - t0
        secs["cpu_side"] = sides["seconds"]
        compare_moe_train(torch, runs, {"cpu": sides["train"],
                                        "cuda": card}, ("cpu", "cuda"))
    finally:
        if own:
            cpu.close()
    emit("moe_vlm_seconds", seconds=secs,
         total=sum(v for k, v in secs.items() if k != "cpu_side"))
    return launches


def main(argv=None) -> int:
    import argparse

    import torch
    ap = argparse.ArgumentParser(description="Drive the port on one card.")
    ap.add_argument("--only", choices=["moe_vlm", "encdec", "xlstm",
                                       "dist", "serve_mesh"],
                    help="build, then run only the moe/vlm, the encdec, "
                    "the xlstm, the distributed-training or the mesh "
                    "serving phase (no result line)")
    ap.add_argument("--cpu-side", metavar="PATH", help=argparse.SUPPRESS)
    ap.add_argument("--cpu-side-families", default="moe",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.cpu_side:                  # phase_moe_vlm's, encdec's, xlstm's child
        return cpu_side(args.cpu_side, args.cpu_side_families)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    start = time.perf_counter()
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())

    # the CPU halves of the card-against-CPU phases, from before the build
    # (they need no kernel) to beside the full-size training phases; each
    # is taken where its phase runs
    cpu = None if args.only else CpuHalves([
        ("train_card_vs_cpu", lambda: train_card_vs_cpu_cpu(torch,
                                                            "llama2-7b")),
        ("train_card_vs_cpu_neo",
         lambda: train_card_vs_cpu_cpu(torch, "gpt-neo-2.7b")),
        ("train_fused_card_vs_cpu", lambda: fused_train_cpu(torch)),
        ("quant_codes", lambda: quant_codes_cpu(torch)),
        ("train_quant_card_vs_cpu", lambda: quant_train_cpu(torch)),
        ("train_hybrid_card_vs_cpu", lambda: hybrid_train_cpu(torch)),
        ("train_xlstm_card_vs_cpu", lambda: xlstm_train_cpu(torch)),
        ("train_dist_card_vs_cpu", lambda: dist_train_cpu(torch)),
        ("serve_xlstm_card_vs_cpu", lambda: xlstm_serve_side(torch, "cpu"))])
    t0 = time.perf_counter()
    libs = build.build_all()
    usage = {}
    for log in build.last_build.get("logs", {}).values():
        usage.update(ptxas_usage(log))
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[str(p.relative_to(ROOT)) for p in libs.values()],
         ptxas=usage)
    mma = sass_mma(libs, usage)
    emit("sass", tensor_core_kernels=mma)
    for name in TC_KERNELS:
        inst = [v for k, v in mma.items() if k.startswith(name)]
        if not inst or any(v["hmma"] + v["hgmma"] == 0 for v in inst):
            raise RuntimeError(f"{name}: no tensor-core instruction in its "
                               f"SASS: {inst}")
    if args.only == "xlstm":
        phase_xlstm(torch)
        phase_train_xlstm(torch)            # every run at 48 layers
        phase_serve_xlstm_card_vs_cpu(torch, xlstm_serve_side(torch, "cpu"))
    elif args.only in ("dist", "serve_mesh"):
        t0 = time.perf_counter()
        phase = {"dist": phase_train_dist,
                 "serve_mesh": phase_serve_mesh}[args.only]
        phase(torch)
        emit("seconds", laps={phase.__name__[len("phase_"):]:
                              time.perf_counter() - t0})
    elif args.only:
        {"moe_vlm": phase_moe_vlm, "encdec": phase_encdec}[args.only](torch)
    if args.only:
        emit("done", seconds=time.perf_counter() - start)
        return 0

    laps, t_lap, low = {}, [time.perf_counter()], {}
    host = HostMemory()

    def lap(name: str) -> None:
        """Seconds since the previous lap, under ``name``, and the host's
        least available memory over them."""
        now = time.perf_counter()
        laps[name] = laps.get(name, 0.0) + now - t_lap[0]
        low[name] = min(low.get(name, math.inf), host.take())
        t_lap[0] = now

    # first the phases that hold little host memory, beside the CPU halves
    # (the kernels against their plain versions, serving): the halves' ~25
    # GB would not fit beside the training phases' pinned bundles (the
    # last half, xlstm serving's, holds a few GB)
    rows = phase_kernels(torch)
    lap("kernels")
    rows.update(phase_update_kernels(torch))
    lap("update_kernels")
    rows.update(phase_dequant_kernel(torch))
    lap("dequant_kernel")
    rows.update(phase_ssm_kernel(torch))
    lap("ssm_kernel")
    phase_kernels(torch, hybrid_attention_cases())
    lap("kernels_hybrid")
    phase_card_vs_cpu(torch)
    lap("card_vs_cpu")
    tree = {}
    launches = phase_full(torch, keep=tree)
    lap("full_size")
    # mesh= serving at a world of one, on full_size's tree: both engines,
    # every other family at 2 layers (or a super-block), the launcher
    for name, n in phase_serve_mesh(torch, tree).items():
        launches[name] = launches.get(name, 0) + n
    lap("serve_mesh")
    # the launcher's default path: fp32 serving at full width, half depth
    # (the whole script's time: full depth took 15.4 s of 933.1 in PR 22)
    for name, n in phase_full(torch, "float32", max_new=16,
                              n_layers=16).items():
        launches[name] = launches.get(name, 0) + n
    lap("full_size_fp32")
    phase_hybrid_card_vs_cpu(torch)
    lap("hybrid_card_vs_cpu")
    # the scan's main paths: zamba2-2.7b served at full size in bf16 and
    # in fp32, the launcher's default; they run the attention kernels too
    # (fp32 at 24 of the 54 layers: the whole script's time, PR 22)
    for dtype, max_new, depth in (("bfloat16", 32, None),
                                  ("float32", 8, 24)):
        for name, n in phase_hybrid_full(torch, dtype, max_new,
                                         depth).items():
            launches[name] = launches.get(name, 0) + n
    lap("hybrid_full")
    # the xlstm family served on the card: the wide-state scan kernel; its
    # card-against-CPU comparison comes last
    wide_rows, wide_launches = phase_xlstm(torch)
    rows.update(wide_rows)
    for name, n in wide_launches.items():     # serve_mesh's are counted
        launches[name] = launches.get(name, 0) + n
    lap("xlstm")
    # the card-against-CPU phases take their CPU halves, each where the
    # halves' thread has had the time to draw it (they run one after
    # another, ~380 s in all on an H100's host): dense HiFT, the
    # fused-backward and zeroth-order strategies (no hand-written kernel
    # lies on their path: the reference's updates there are plain), the
    # codec and quantized HiFT; hybrid training's after the pipelined
    # phase, and before the streamed one's pinned moments
    phase_train_card_vs_cpu(torch, cpu=cpu.take("train_card_vs_cpu"))
    lap("train_card_vs_cpu")
    phase_train_fused_card_vs_cpu(torch, cpu.take("train_fused_card_vs_cpu"))
    lap("train_fused_card_vs_cpu")
    phase_quant_codes(torch, cpu.take("quant_codes"))
    lap("quant_codes")
    phase_train_quant_card_vs_cpu(torch, cpu.take("train_quant_card_vs_cpu"))
    lap("train_quant_card_vs_cpu")
    sides = None
    try:
        launches.update(phase_train_full(torch))
        lap("train_full")
        phase_train_mixed_hi(torch)
        lap("train_mixed_hi")
        phase_train_4_layers(torch)
        lap("train_4_layers")
        # the paper's experiment matrix: its other models, optimizers, the
        # balanced schedule, FPFT against HiFT at full depth,
        # checkpoint/resume; each runs the fused updates
        # then the pipelined and streamed strategies (side streams; the
        # pipelined HiFT and LiSA steps run the fused AdamW)
        for name, n in phase_train_paper_configs(
                torch, cpu.take("train_card_vs_cpu_neo")).items():
            launches[name] += n
        lap("train_paper_configs")
        for phase in (phase_train_optimizer_matrix,
                      phase_train_fpft_vs_hift_full, phase_train_balanced,
                      phase_train_checkpoint, phase_train_pipelined):
            for name, n in phase(torch).items():
                launches[name] += n
            lap(phase.__name__[len("phase_"):])
        phase_train_hybrid_card_vs_cpu(
            torch, cpu=cpu.take("train_hybrid_card_vs_cpu"))
        lap("train_hybrid_card_vs_cpu")
        for name, n in phase_train_streamed(torch).items():
            launches[name] += n
        lap("train_streamed")
        # the moe and encdec training's CPU sides, in a child process beside
        # the last full-size training phases, whose host cores are otherwise
        # idle; not before: beside train_streamed's pinned moments the
        # child's ~30 GB left the host 8 GiB.  From here, not after
        # train_xlstm: on a slower H100 host the child's moe side (143.9
        # s) kept moe_vlm waiting 32.6 s for it
        sides = CpuSide(("moe", "encdec"))
        # xlstm training: the fused AdamW and, under NF4 residency, the
        # dequant kernel; the mLSTM trains through the plain chunked scan,
        # as the reference trains through its jnp scan.  Its card-against-
        # CPU part takes its CPU half (8 layers' 3 GB of params held since)
        # and frees it: at the script's end the child's ~30 GB beside it
        # left the host 7.9 GiB in moe_vlm.  Every run at 16 of the 48
        # layers, to keep the script near half its limit (at 48 the HiFT
        # and FPFT runs took 73.6 s of the whole script's 760.0 on an H100;
        # ``--only xlstm``: at 48).
        for name, n in phase_train_xlstm(
                torch, cpu.take("train_xlstm_card_vs_cpu"),
                n_layers=16).items():
            launches[name] = launches.get(name, 0) + n
        lap("train_xlstm")
        phase_train_fused_full(torch)
        lap("train_fused_full")
        quant = phase_train_quant_full(torch)
        for name in ("dequant_matmul", "dequant_matmul_bf16"):
            launches[name] = launches.get(name, 0) + quant[name]
        lap("train_quant_full")
        # hybrid training (zamba2): the fused AdamW and, under NF4
        # residency, the dequant kernel; the training scan is plain torch,
        # as the reference's is plain jnp
        for name, n in phase_train_hybrid_full(torch).items():
            launches[name] = launches.get(name, 0) + n
        lap("train_hybrid_full")
        # the moe and vlm families and the last dense configs: the prefill
        # and the decode with a vision prefix, the fused AdamW, the dequant
        # kernel
        for name, n in phase_moe_vlm(torch, sides).items():
            launches[name] = launches.get(name, 0) + n
        lap("moe_vlm")
        # the encdec family: the prefill non-causal and over the memory's
        # keys, the decode over the memory, the fused AdamW, the dequant
        # kernel
        for name, n in phase_encdec(torch, sides).items():
            launches[name] = launches.get(name, 0) + n
        lap("encdec")
    finally:
        if sides is not None:
            sides.close()
    phase_serve_xlstm_card_vs_cpu(torch,
                                  cpu.take("serve_xlstm_card_vs_cpu"))
    lap("serve_xlstm_card_vs_cpu")
    # distributed training at a world of one, last: its three runners pin
    # ~25 GB of bundles, which beside the moe/encdec child's ~30 GB left
    # the host's 96 GiB short in moe_vlm; the cross-pod
    # reduce at full width, the 1x1 NCCL mesh, its checkpoint and moe's
    # expert-parallel path, the fused AdamW (row 4) on each
    for name, n in phase_train_dist(
            torch, cpu.take("train_dist_card_vs_cpu")).items():
        launches[name] = launches.get(name, 0) + n
    lap("train_dist")
    emit("seconds", laps=laps, host_min_available_gib=low)
    emit("done", seconds=time.perf_counter() - start)

    kernels = []
    for name, row in rows.items():
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name],
            replaces=KERNEL_ROWS[name], launches=launches[name],
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            case=row["case"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
