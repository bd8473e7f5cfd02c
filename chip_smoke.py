#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases (any failure raises; the script then exits non-zero):
  1. device  — the card's name and power limit; build every CUDA source
               under ``src/repro_torch/kernels/csrc`` with nvcc, one
               compiler per source, all started together.
  2. engine  — the main path: ``repro_torch.launch.serve.serve`` on
               llama-7b-paper at full width (32 layers, bf16 weights from
               a seed, fp32 cache), padded and bucketed banks, decode
               blocks 1 and 4, 8 requests over 5 adapters with nonzero
               weights, prompts of 64, 128 and 1000 tokens (a group of 2
               at 1000: not a multiple of 128, 8 kv blocks); every request
               gets its 16 tokens, the mode's SGMV kernel launches 4 x 32
               times per prefill group and per decode step, the flash
               kernel B5 32 times per prefill group, all four runs emit the
               same tokens. The arguments of each kernel's and each
               dispatcher's largest (prefill) and smallest (decode) call
               are copied as the path runs. Then phase 6's trace is
               served at tp = 1, the reference of phase 6 (padded and
               bucketed emit the same tokens and first-prefill logits, bit
               for bit), and the bf16 noise floor of that prefill is
               measured: its logits against the einsum LoRA form, and
               against the same prefill in fp32 on the same weights
               upcast.
  3. kernels — B1 ``sgmv_fused_blocks``, B2 ``sgmv_multibank_blocks``, B3a
               ``sgmv_shrink``, B3b ``sgmv_expand`` (on B1's copied
               arguments) and B5 ``flash_mha`` against their plain-torch
               versions on those copies, in bf16 and cast to fp32; times
               from CUDA events with L2 flushed between launches (the
               card held busy while the host enqueues each call), the
               bound from the bytes and operations the call needs (B5
               in fp32: its products as 3xTF32 at the dense TF32 rate,
               the CUDA cores' fp32 bound printed beside it), and for
               B5 the time of ``scaled_dot_product_attention``; each line
               names the shrink split C of B1, B2, B3a and B4a, the
               expand's tile of B1, B2, B3b and B4b (``mma`` on bf16
               tensor cores, ``fma`` in fp32; B3b's and B4b's grid) and
               B5's tile. ``yardstick`` lines time B2's, B3a's and B3b's
               bf16 calls as ``torch.bmm`` over the blocks that hold
               tokens, their adapters' ``A[aid]``/``B[aid]`` gathered (B2:
               a pair per rank bucket). Then, for B1 in bf16 on
               its decode and prefill calls: its time at C = 4, 8 and 16
               beside the cluster occupancy the card reports, and a
               yardstick, ``A[aid]``-gathered ``torch.bmm`` then
               ``torch.bmm``. B1, B2, B3a and the decode lines print each
               block's live-row count as the path passed it; B2 runs at
               the block_t the path chose (``tune.block_plan``: 64 on the
               2 x 1000 group). ``plan:`` lines: B2 on that group laid out
               at block_t 16, 32 and 64 (plain-version check, ms, resident
               clusters, the outputs equal bit for bit).
  4. unfused — the path through B3a/B3b: ``sgmv`` and
               ``sgmv_rank_bucketed`` on the engine's own copied dispatcher
               calls, and ``apply_bank_sgmv(fused=False)`` on the engine's
               own banks (4 targets, layer 0, 8 and 512 tokens), each bit
               for bit equal to its fused counterpart (B2 at the plan's
               block_t == the host loop at 16 == B1 on the zero-padded
               bank, bf16 and fp32, on the bucketed calls); ``bgmv``
               against its plain version and bit for bit against
               ``sgmv_fused``.
  5. parity  — fp32, full width, 2 layers: kernel and einsum engines,
               padded and bucketed, emit the same tokens; prefill logits
               agree within 1e-3, and the LoRA delta moves them by more.
  6. tp      — the tensor-parallel engine (``ServingEngine(mesh=...)``),
               tp = 2 as two ranks on the one card over gloo (spawned;
               each reports its launch counts and outputs through a
               file): llama-7b-paper at full width and depth, bf16, 8
               requests over the 5 adapters, prompts of 64 and 128, 16
               new tokens, decode_block 4, both bank modes. B4a/B4b
               (bucketed) and B3a/B3b (padded) launch 4 x 32 times a
               model pass on each rank, B5 32 times a prefill group on 16
               local heads; both ranks emit the same tokens and logits;
               padded and bucketed emit the same tokens and first-prefill
               logits, bit for bit; those logits agree with phase 2's tp
               = 1 engine on the same trace, and with its fp32 reference,
               within 5e-2 of their largest magnitude (token agreement
               printed, not asserted: a bf16 tie may flip); the
               all-reduce timed. Then phase 5's fp32 2-layer trace at tp
               = 2, both modes: its tokens equal tp = 1's and its prefill
               logits agree with tp = 1's within 1e-3.
  7. split   — every kernel of the tp = 2 path against its plain version
               on copies of rank 0's own calls, bf16 and fp32, timed as
               phase 3: B4a ``sgmv_multibank_shrink`` (into memory that
               held NaN) and B4b ``sgmv_multibank_expand`` (bucketed) and
               B3a/B3b (padded) at d_local = d_out_local = 2048, decode
               and prefill, and B5 on both prefill groups' 16 local
               heads, with the yardsticks of B4a, B4b (per rank bucket),
               B3a and B3b on their calls; and B4a
               then B4b (block_t 16) equal to B2 (the plan's block_t)
               bit for bit on phase 2's recorded bucketed calls (tp = 1
               shapes).
  8. cluster — runs right after phase 2's main path, on its bf16
               params: ``LoRAServeCluster`` over 2 engines that share
               them (``launch.serve.make_cluster``), the launcher's 8
               adapters (ranks 8..128, phase 2's weight seed), 16
               requests of drifting popularity over 3 s, prompts 64 and
               128, 16 new tokens, max batch 8, decode_block 4,
               rebalances every 1 s. (a) On a virtual clock
               (``launch.serve.drive``, a poll every 0.25 s), padded then
               bucketed: at least one rebalance that changed the
               placement, equal routing, placements and tokens in both
               modes, each bank's max rank that of its hosted subset,
               B1/B2 launched 4 x 32 times and B5 32 times per model pass
               and prefill group over all engines, peak memory under
               twice the weights' bytes; (b) remote reads (>= 1, tokens
               of (a)); (c) a wall-clock ``run``: TTFT, TBT per server,
               decode tokens/s, bank rebuilds and their ms, peak memory,
               beside nvidia-smi's line; (d) phase 5's fp32 2-layer model,
               server 0 killed at 1.0 s: one failure, one recovery,
               every request complete with the fault-free run's tokens.
               The kernels line keeps phase 2's launch counts.
  9. gateway — right after phase 8, on the same bf16 params: (a) the
               streaming HTTP gateway (``repro_torch.server.ServeGateway``
               on 127.0.0.1, its loop in a thread) over 2 servers
               (bucketed, decode_block 4, max batch 8, the launcher's 8
               adapters) with a wall-clock ``Tracer`` and a
               ``FlightRecorder``: ``GET /healthz``, a 9th adapter (rank
               64) registered with ``POST /v1/adapters``, 8 concurrent SSE
               completions over the 9 adapters (prompts of 64 and 128,
               16 tokens each), one adapter deleted while its stream is
               in flight, ``GET /metrics``, then ``begin_shutdown`` (what
               SIGTERM does): every stream gets its 16 tokens in index
               order, ``/metrics`` carries the TTFT histogram, each
               request's span tree has the ``REQUEST_PHASES`` children
               and they sum to within 1% of its root, the Perfetto file
               parses, B2 launched 4 x 32 times a model pass and B5 32
               times a prefill group over both engines; TTFT, TBT, tok/s,
               spans, the cost-model drift (the paper's A100 model
               against the measured spans) and peak memory beside
               nvidia-smi's line. (b) Phase 5's fp32 2-layer model: 4
               requests sent one after another over the gateway (one
               adapter registered over HTTP) give the tokens of the same
               requests through the facade's ``run``, bit for bit. (c)
               ``python -m repro_torch.launch.server --backend engine
               --config full --port 0`` streams one request and exits 0
               on SIGTERM, printing ``gateway drained OK``; so does
               ``python -m repro_torch.launch.serve --serve 127.0.0.1:0
               --config full --trace-out F``, which writes the span trace
               and prints the ``costmodel[phase]`` lines.
 10. moe     — after every earlier phase has freed its weights, the MoE
               family and the dense configs at full width. (a)
               deepseek-v2-lite-16b, 27 layers (MLA attention, 64 experts
               top-6 plus 2 shared), bf16 weights from a seed (the router
               fp32), fp32 MLA cache: phase 2's trace (8 requests over the
               5 adapters, prompts 4 x 64, 2 x 128 and 2 x 1000, 16 new
               tokens, max batch 8), padded and bucketed, decode blocks 1
               and 4: every run emits the same tokens, B1/B2 launch 3 x
               27 times a model pass (MLA calls q, k and o) and B5 never;
               the first prefill group's bf16 logits equal bit for bit
               across the banks and lie within 5e-2 of the largest logit
               of an fp32 einsum run on the same weights (upcast in
               place). (b) Every B1 and B2 call the runs recorded at each
               width (d 2048; d_out 3072, 576, 2048; a decode step and
               the 2 x 1000 group) and B3a/B3b on B1's, against their
               plain versions (bf16 and fp32), timed and bounded as in
               phase 3, each with its gathered-bmm yardstick; on the
               dispatcher calls B3a then B3b == B1, and B2 at the plan ==
               the host loop == B1 on the zero-padded bank, bit for bit.
               (c) llama4-scout-17b-a16e at full width and 8 of its 48
               layers (GQA 40/8, 16 experts top-1 plus 1 shared), 4
               requests, padded and bucketed: the same checks, B1/B2 at d
               5120, d_out 5120 and 1024. (d) ``python -m
               repro_torch.launch.serve --arch deepseek-v2-lite-16b
               --config full --servers 2 --bank-mode bucketed
               --decode-block 4`` exits 0 with ``cluster drained OK``. (e)
               stablelm-1.6b at full width and depth, 4 requests, padded
               and bucketed; its MHA prefill runs B5 at head dim 64,
               held against ``flash_mha_plain`` and timed beside
               ``scaled_dot_product_attention`` on the 1000-token group.
               Each run logs TTFT, TBT, tok/s and peak memory; the
               kernels line adds its launches. The cluster launchers here
               and in phases 11, 12 and 14 serve ``LAUNCHER_TRACE``: 4
               requests over 1 s, 4 new tokens each.
 11. recurrent — after phase 10, the recurrent families at full width,
               bf16 weights from a seed, fp32 caches, on phase 2's trace,
               padded and bucketed, decode blocks 1 and 4: (a) zamba2-7b
               at 24 of its 81 Mamba2 blocks (``RECURRENT_LAYERS``; d
               3584, one shared MHA block 32 x 112 applied 4 times, whose
               one-layer bank serves every application): the same tokens
               in every run, B1/B2 4 x 4 times a model pass and B5 4
               times a prefill group; (b) rwkv6-7b at 8 of its 32 layers
               (d 4096): the same, B1/B2 4 x 8 times a model pass, B5
               never. For each, the first prefill
               group's bf16 logits equal bit for bit across the banks and
               are held within 5e-2 of the largest logit of an fp32 einsum
               run on the same weights (upcast in place) in which every
               layer takes the bf16 run's input (``LayerReplay``), each
               layer's output held too; the free fp32 run's distance and
               the fp32 logits' move under a one-rounding perturbation of
               the input (``Perturbed``) are printed. (c) Every B1 and B2
               call the runs recorded (d 3584 and 4096; a decode step and
               the 2 x 1000 group) and B3a/B3b on B1's, against plain,
               timed and bounded with their yardsticks, and the bit
               identities of phase 10 (b); B5 at head dim 112 on zamba2's
               2 x 1000 group against ``flash_mha_plain``, timed beside
               ``scaled_dot_product_attention``. (d) ``LoRAServeCluster``
               over 2 zamba2 engines at 12 layers with a
               ``UnifiedPagePool`` each (phase 8's virtual-clock drive,
               bucketed): tokens equal the
               drive without pools, every pool's invariant holds after the
               drain, pages by kind printed; then ``python -m
               repro_torch.launch.serve --arch rwkv6-7b --config full
               --servers 2 --bank-mode bucketed --decode-block 4`` (all 32
               layers) exits 0 with ``cluster drained OK``. (e)
               stablelm-1.6b at full
               width: one adapter merged into the bf16 weights
               (``merge_adapter``), the first group's logits within 5e-2 of
               the SGMV path's on a bank of that adapter alone. Each run
               logs TTFT, TBT, tok/s and peak memory; the kernels line
               adds its launches.
 12. encdec  — after phase 11, the encoder-decoder and VLM families at
               full width, bf16 weights from a seed, fp32 caches, on phase
               2's trace, padded and bucketed, decode blocks 1 and 4. (a)
               seamless-m4t-large-v2 at full depth (24 encoder and 24
               decoder layers, d 1024, MHA 16 x 64), fed the engine's zero
               frontend (1024 frames) as the reference's engine feeds it:
               the same tokens in every run, B1/B2 4 x 24 times a prefill
               group and never in decode (the adapters reach the decoder's
               self-attention in prefill only, ROADMAP C3), B5 72 times a
               prefill group (24 causal decoder, 24 non-causal encoder and
               24 non-causal cross-attention calls); the first group's
               bf16 logits padded == bucketed bit for bit and within 5e-2
               of the largest logit of an fp32 einsum run on the same
               weights (upcast in place). (b) A nonzero N(0, 0.02^2)
               frontend at model level (fp32, as the engine's: the encoder,
               its memory and the cross K/V run in fp32 over the bf16
               weights) on the 2 x 1000 group, prefill and 3 decode steps:
               within 5e-2 of the fp32 run's logits, and their distance
               from the zero frontend's printed. (c) B1 and B2 at d = d_out
               = 1024 (shrink split C = 8) on the smallest and the largest
               prefill group, B3a/B3b on B1's calls, against plain, timed,
               with yardsticks and phase 10's bit identities; B5 on (b)'s
               non-causal encoder (2, 16, 1024, 64) and cross (Sq 1000, Sk
               1024) calls and (a)'s causal decoder call, timed beside
               ``scaled_dot_product_attention`` of the same ``is_causal``.
               (d) ``python -m repro_torch.launch.serve --arch
               seamless-m4t-large-v2 --config full --servers 2 --bank-mode
               bucketed --decode-block 4`` exits 0 with ``cluster drained
               OK``. (e) llama-3.2-vision-90b at full width (d 8192, GQA
               64/8) and 10 of its 100 layers (two periods of 4
               self-attention layers and a gated cross-attention block over
               1601 patches), its gates set nonzero in place (0 at init,
               where the cross blocks are the identity): the same tokens in
               every run, no kernel launched, the first group's logits
               padded == bucketed bit for bit and within 5e-2 of an fp32
               run upcast in place; a nonzero frontend moves the logits
               (printed). Each run logs TTFT, TBT, tok/s and peak memory;
               the kernels line adds its launches.
 13. tpfam   — after phase 12, every family at tp = 2: two ranks on the
               one card over gloo, as phase 6 (spawned once; each rank
               draws its slice of the weights block by block,
               ``init_params(tp=...)``), every family at full width and
               ``TP_FAMILIES``'s depth: deepseek-v2-lite-16b at 6 layers
               (the expert-parallel MoE at prefill, its all-to-all and
               all-gather; MLA split by head; the drop-free MoE at
               decode), llama4-scout-17b-a16e at 8, zamba2-7b at 12 (two
               shared-block applications), rwkv6-7b at 8,
               seamless-m4t-large-v2 at 6 encoder and 6 decoder layers
               and llama-3.2-vision-90b at 10 (its gates set nonzero), bf16 weights from a seed, fp32 caches,
               phase 6's trace (8 requests over its 5 adapters, prompts 64
               and 128, 16 new tokens, decode_block 4, max batch 8) in
               both bank modes. Each family: B3a/B3b (padded) or B4a/B4b
               (bucketed) launch once per LoRA call and B5 as at tp = 1
               (zamba2's 16 local heads x 112; seamless's 8 x 64, fp32 on
               the encoder and cross calls), counted from 0 around each
               run; both ranks emit the same tokens and logits; padded ==
               bucketed tokens and first-prefill logits bit for bit; the
               fp32 2-layer model (the VLM: one period of 5) at tp = 2
               emits the tokens of tp = 1 and its first-prefill logits
               lie within 1e-3 of tp = 1's, with a nonzero frontend too
               for seamless and the VLM; the MoE family's tp = 1
               reference runs ``moe_ffn_ep_ref(n=2)`` at prefill
               (``EPReference``). The bf16 tp = 2 logits' distance from tp
               = 1 (zero and nonzero frontends) is printed, not asserted:
               a random router flips near-ties between bf16 runs and the
               recurrent stacks amplify one rounding (PERF.md, ROADMAP
               C13). B3a/B3b/B4a/B4b at each tp = 2 width and B5 on rank
               0's copied calls against their plain versions, bf16 and
               fp32, timed, bounded, with the SGMV yardsticks; the
               collectives' ms per call (all-reduce, and the MoE's
               all-to-all and all-gather) and rank 0's TTFT, TBT and peak
               memory logged; each rank's peaks with the vocab-parallel
               embed and ``lm_head``.
 14. dp      — after phase 13, data parallelism: llama-7b-paper at full
               width and 8 of its 32 layers (``DP_LAYERS``; bf16 weights
               from phase 2's seed, each rank drawing its slice), phase 2's trace (8 requests,
               prompts 4 x 64, 2 x 128 and 2 x 1000, 16 new tokens, max
               batch 8) padded and bucketed, decode blocks 1 and 4, as
               gloo ranks on the one card: (a) (dp, tp) = (2, 1), two
               ranks with the whole model each; (b) (2, 2), four ranks
               with the vocab-parallel head. Each world is spawned,
               checked and gone before the next. Every rank's cache holds
               4 of the 8 slot rows; B1/B2 (a) or B3a/B3b and B4a/B4b (b)
               launch once per LoRA call and B5 once a layer per prefill
               group, counted from 0 around each run; every rank emits the
               same tokens and first-prefill logits; padded == bucketed
               tokens and logits bit for bit; phase 5's fp32 2-layer
               trace at (dp, tp) emits phase 5's tokens, its prefill
               logits within 1e-3 (the distance printed); the bf16 tokens
               against dp = 1's on the same 8-layer model printed, not
               asserted;
               each rank's peak memory and rank 0's TTFT and TBT logged
               beside nvidia-smi's line. (c) ``python -m
               repro_torch.launch.serve --config full --servers 2 --mesh
               1,2 --backend gloo`` exits 0 with every request finished,
               the report on ``mesh=(1, 2)`` and ``cluster drained OK``.
               The kernels line adds (a)'s and (b)'s launches.
 15. train   — after phase 14, training (``repro_torch.training``;
               autograd over the plain path, ``models.model.forward``: no
               kernel has a backward, and every kernel wrapper refuses an
               input that requires grad). (a) ``repro_torch.launch.train``
               through its ``main`` in this process: internlm2-1.8b at
               full width and depth (24 layers, d 2048, GQA 16/8, V
               92 544), fp32, 10 full-parameter AdamW steps of 8 x 128 on
               the synthetic pipeline: every loss finite, every grad_norm
               > 0, each printed lr equal to ``lr_schedule``'s at the
               printed precision; step ms, tok/s and peak memory. (b) One
               fp32 step of the same model at 2 layers, from the same
               weights and a 4 x 128 batch, on the card and on the CPU
               path the tests hold against JAX: loss, grad_norm, every
               updated leaf and both moments within 1e-4 of each leaf's
               largest value; every wq, wk and wv has a nonzero gradient
               on the card. (c) llama-7b-paper at full width and depth:
               a bf16 base, frozen (a per-leaf digest equal after), and
               an fp32 rank-16 adapter on q/k/v/o, 10
               ``make_lora_train_step`` steps of 8 x 128 (step 1 gives
               every B a gradient and every A none); the tuned adapter
               saved (``save_checkpoint``), reloaded and served beside
               phase 2's seeded adapters on phase 2's trace plus two
               64-token requests of its own, padded and bucketed, decode
               blocks 1 and 4 (B1/B2 and B5 counted as phase 2 counts
               them; the same tokens in every run; the first group's
               logits padded == bucketed bit for bit); its rows'
               first-prefill logits within 5e-2 of the largest logit of
               the einsum ``forward`` with the same adapter; B1 and B2 on
               the engine's decode calls, with the trained B in the bank,
               against their plain versions, and their gathered-``bmm``
               yardsticks. The kernels line adds (c)'s launches.
 16. tools   — after phase 15, the tools (``repro_torch.analysis``,
               ``launch/dryrun.py``, ``launch/mesh.py:roofline``, the
               examples), their CPU parts in subprocesses beside the
               card's: (a) ``python -m repro_torch.analysis`` (lint, smem
               on the card's own limits and each compiled kernel
               instantiation's registers, static and dynamic shared
               memory and spills, protocol) exits 0; its ``smem[...]``
               lines are printed. (b) ``python -m
               repro_torch.launch.dryrun --mesh single`` over every arch
               and shape (two processes): every case ok or refused (C5);
               ``launch/report.py``'s two tables, llama-7b-paper's rows
               printed. (c) llama-7b-paper's decode case at full width
               (bf16, the dry-run's 8 rank-64 adapters, a cache of 8 x
               1024) built on the card by the dry-run's own ``build_case``: the
               allocator holds its argument bytes to within 512 B a
               tensor (the requested bytes exactly); one decode step
               timed over CUDA events beside the dry-run's t_memory and
               t_compute. (d) ``repro_torch.examples.quickstart`` and
               ``serve_cluster`` on the card exit 0; their tokens and
               summaries printed. The bounds of every ``kernel`` line
               take the card's published peaks from ``launch/mesh.py:
               roofline``.
Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. TF32 is off for matmuls and cuDNN, so
the plain versions' fp32 products run in full fp32; B5's fp32 kernel
runs its own as 3xTF32 (``csrc/flash.cu``), held against them at 1e-4.
"""
import asyncio
import dataclasses
import functools
import gc
import http.client
import json
import math
import os
import random
import re
import select
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
SPIN_CYCLES = 5_000_000               # ~2.5 ms of the card's clock
BLOCK_T = 16
SGMV_SRC = "src/repro_torch/kernels/csrc/sgmv.cu"
FLASH_SRC = "src/repro_torch/kernels/csrc/flash.cu"
# kernel id -> (wrapper, source, the TPU kernel's pallas_call)
KERNELS = {
    "B1": ("sgmv_fused_blocks", SGMV_SRC, "src/repro/kernels/sgmv.py:167"),
    "B2": ("sgmv_multibank_blocks", SGMV_SRC,
           "src/repro/kernels/sgmv.py:319"),
    "B3a": ("sgmv_shrink", SGMV_SRC, "src/repro/kernels/sgmv.py:72"),
    "B3b": ("sgmv_expand", SGMV_SRC, "src/repro/kernels/sgmv.py:102"),
    "B4a": ("sgmv_multibank_shrink", SGMV_SRC,
            "src/repro/kernels/sgmv.py:414"),
    "B4b": ("sgmv_multibank_expand", SGMV_SRC,
            "src/repro/kernels/sgmv.py:487"),
    "B5": ("flash_mha", FLASH_SRC, "src/repro/kernels/flash.py:103"),
}
TP = 2


def log(*a):
    print(*a, flush=True)


def gpu_line() -> str:
    from repro_torch.launch.mesh import power_limit_line
    return power_limit_line()


def _wrappers():
    """Kernel id -> the wrapper function, which carries ``launches``."""
    from repro_torch.kernels import flash, sgmv
    return {kid: getattr(flash if kid == "B5" else sgmv, name)
            for kid, (name, _, _) in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 2 helper: copies of the main path's own calls
# ---------------------------------------------------------------------------


def _copy(a):
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (tuple, list)):
        return type(a)(_copy(v) for v in a)
    if isinstance(a, dict):
        return {k: _copy(v) for k, v in a.items()}
    return a


def _move(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, (tuple, list)):
        return type(a)(_move(v, device) for v in a)
    if isinstance(a, dict):
        return {k: _move(v, device) for k, v in a.items()}
    return a


def _cast(a, dtype):
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if a.is_floating_point() else a
    if isinstance(a, (tuple, list)):
        return type(a)(_cast(v, dtype) for v in a)
    return a


def _call_widths(name, args):
    """(d, d_out) of an SGMV call's input and output rows (the bank's B
    gives d_out: ``args[2]`` of B1 and ``sgmv_fused``, the first bucket's
    of B2 and ``sgmv_bucketed_fused``); (hd,) of a B5 call."""
    x = args[0]
    if name == "flash_mha":
        return (x.shape[-1],)
    B = args[1][0][1] if isinstance(args[1], (list, tuple)) else args[2]
    return (x.shape[1], B.shape[-1])


class MainPathCalls:
    """Stands in, while it is entered, for the names under which the port
    calls the kernel wrappers B1/B2 and ``scatter_rows`` (``kernels/
    ops.py``), the dispatchers ``sgmv_fused`` / ``sgmv_bucketed_fused``
    (``lora/batched.py``) and B5 (``models/attention.py``); with ``tp``,
    for ``scatter_rows``, B3a/B3b and B4a/B4b (``lora/batched.py``) and
    B5, every kernel of the tensor-parallel path. It
    forwards every call unchanged (the wrappers count their own launches)
    and keeps a copy of the arguments of each one's smallest call (by
    rows: a decode step) and largest (a prefill group), with the ``dest``
    that laid out the last SGMV call's tokens. A dispatcher's ``layout``
    (the engine's plan built it once for the batch) is not kept: a replay
    builds it again from the call's own indices, the same tensors."""

    def __init__(self, tp=False, widths=False):
        from repro_torch.kernels import ops
        from repro_torch.lora import batched
        from repro_torch.models import attention
        self.ops = ops
        # tp: the names the tensor-parallel path calls its kernels by
        self.sites = [(batched, "sgmv_shrink"), (batched, "sgmv_expand"),
                      (batched, "sgmv_multibank_shrink"),
                      (batched, "sgmv_multibank_expand"),
                      (attention, "flash_mha")] if tp else [
                      (ops, "sgmv_fused_blocks"),
                      (ops, "sgmv_multibank_blocks"),
                      (batched, "sgmv_fused"),
                      (batched, "sgmv_bucketed_fused"),
                      (attention, "flash_mha")]
        self.orig = {}
        # (name, layout) -> (args, kwargs, dest); with ``widths`` (True:
        # ``_call_widths``, or a function of (name, args)), keyed (name,
        # layout) + its widths: a smallest and a largest call
        # at each width
        self.widths = widths
        self.calls = {}
        self._rows = {}
        self._dest = None

    def __enter__(self):
        scatter = self.ops.scatter_rows
        self.orig[(self.ops, "scatter_rows")] = scatter

        def scatter_rows(x, dest, T_pad):
            self._dest = dest
            return scatter(x, dest, T_pad)
        self.ops.scatter_rows = scatter_rows
        for mod, name in self.sites:
            self.orig[(mod, name)] = getattr(mod, name)
            setattr(mod, name, self._recorder(name, getattr(mod, name)))
        return self

    def __exit__(self, *exc):
        for (mod, name), f in self.orig.items():
            setattr(mod, name, f)

    def _recorder(self, name, fn):
        def call(*args, **kw):
            x = args[0]
            rows = x.shape[0] * x.shape[2] if name == "flash_mha" \
                else x.shape[0]
            widths = _call_widths if self.widths is True else self.widths
            extra = widths(name, args) if widths else ()
            for layout, keep in (("decode", lambda a, b: a < b),
                                 ("prefill", lambda a, b: a > b)):
                key = (name, layout) + extra
                kept = self._rows.get(key)
                if kept is None or keep(rows, kept):
                    self._rows[key] = rows
                    dest = None if self._dest is None else self._dest.clone()
                    self.calls[key] = (_copy(args), {
                        k: _copy(v) for k, v in kw.items()
                        if k != "layout"}, dest)
            return fn(*args, **kw)
        return call


# ---------------------------------------------------------------------------
# phase 3: the kernels against their plain versions, at the main path's
# own calls
# ---------------------------------------------------------------------------


def _block_t(kw):
    return kw.get("block_t") or BLOCK_T


def _sgmv_work(kid, args, kw, dest, item):
    """(bytes, FLOPs) an SGMV call needs: the live rows of its input read
    and of its output written, each used adapter's weights once at the
    rank the call gives it, the block indices (and live counts), and 2 *
    r FLOPs per live token for each column its weights span (B1/B2: d +
    d_out, B3a/B4a: d, B3b/B4b: d_out)."""
    x_pad = args[0]
    T = dest.shape[0]
    live = (dest.long() // _block_t(kw)).tolist()
    if kid in ("B4a", "B4b"):
        W, bkt, row = args[1:]
        ax = 2 if kid == "B4a" else 1
        rank = [w.shape[ax] for w in W]
        bkt, row = bkt.tolist(), row.tolist()
        used = {(bkt[i], row[i]): rank[bkt[i]] for i in set(live)}
        tok_r = [rank[bkt[i]] for i in live]
        # B4a reads x's d_local columns, writes h's max_r (zeros
        # included: they enter the all-reduce); B4b reads each token's
        # r_b columns of h and writes d_out_local
        if kid == "B4a":
            w_cols = x_pad.shape[1]
            rows = T * (x_pad.shape[1] + max(rank))
        else:
            w_cols = W[0].shape[-1]
            rows = sum(tok_r) + T * w_cols
        n_idx = 3 if kid == "B4a" else 2        # B4a: + the live counts
        byts = (rows + sum(used.values()) * w_cols) * item \
            + 4 * n_idx * len(bkt)
        return byts, sum(2 * r * w_cols for r in tok_r)
    if kid == "B2":
        banks, bkt, row = args[1:]
        rank = [A.shape[-1] for A, _ in banks]
        bkt, row = bkt.tolist(), row.tolist()
        used = {(bkt[i], row[i]): rank[bkt[i]] for i in set(live)}
        tok_r = [rank[bkt[i]] for i in live]
        x_cols, y_cols = x_pad.shape[1], banks[0][1].shape[-1]
        idx_bytes = 12 * len(bkt)                # bucket, row, live
    else:
        W, ba = args[1], args[-1].tolist()
        r = W.shape[1] if kid == "B3b" else W.shape[-1]
        used = {ba[i]: r for i in set(live)}
        tok_r = [r] * T
        x_cols = x_pad.shape[1]
        y_cols = {"B1": args[2].shape[-1], "B3a": r,
                  "B3b": W.shape[-1]}[kid]
        idx_bytes = (4 if kid == "B3b" else 8) * len(ba)   # + live counts
    w_cols = {"B3a": x_cols, "B3b": y_cols}.get(kid, x_cols + y_cols)
    byts = (T * (x_cols + y_cols) + sum(used.values()) * w_cols) * item \
        + idx_bytes
    flops = sum(2 * r * w_cols for r in tok_r)
    return byts, flops


def _flash_work(q, k, item, causal=True):
    """(bytes, FLOPs) of MHA: q, k, v read once and o written once; 4 * hd
    FLOPs (q.k and p.v) for each query-key pair the mask keeps in each
    (batch row, head): all Sq x Sk of them non-causal, the min(i + 1, Sk)
    keys of query i under B5's top-left causal mask (S (S + 1) / 2 at Sq
    = Sk = S)."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    pairs = sum(min(i + 1, Sk) for i in range(Sq)) if causal else Sq * Sk
    return 2 * B * H * (Sq + Sk) * hd * item, 4 * hd * B * H * pairs


def _time_ms(call, flush, reps=20):
    """Median ms of one call over CUDA events, L2 flushed before each.
    The card spins (``torch.cuda._sleep``, ~2.5 ms) between the flush and
    the start event, so the host has enqueued the call before the card
    reaches the event: the events time the card's work, not the host's
    launch overhead (which a flush alone did not hide for a short
    kernel on a slow host)."""
    for _ in range(3):
        call()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        s, e = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        s.record()
        call()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def _kernel_cases(calls):
    """(kernel id, layout, args, kwargs, dest) for every kernel: B1, B2
    and B5 on their own copied calls, B3a and B3b on B1's (the unfused
    pair's two halves of the same work)."""
    from repro_torch.kernels import sgmv
    cases = []
    for kid in ("B1", "B2"):
        for layout in ("decode", "prefill"):
            # as the path called it: block_t (B2: the plan's) and the
            # blocks' live-row counts
            args, kw, dest = calls[(KERNELS[kid][0], layout)]
            cases.append((kid, layout, args, kw, dest))
    for layout in ("decode", "prefill"):
        (x_pad, A, B, ba), kw, dest = calls[("sgmv_fused_blocks", layout)]
        h = sgmv.sgmv_shrink_blocks_ref(x_pad, A, ba, **kw)
        cases.append(("B3a", layout, (x_pad, A, ba), kw, dest))
        cases.append(("B3b", layout, (h, B, ba), {"block_t": BLOCK_T}, dest))
    args, kw, _ = calls[("flash_mha", "prefill")]
    assert args[0].shape[0] == 2 and args[0].shape[2] == 1000, \
        args[0].shape                       # the 1000-token group
    cases.append(("B5", "prefill", args, kw, None))
    return cases


def _plains():
    from repro_torch.kernels import flash, sgmv
    return {"B1": sgmv.sgmv_fused_blocks_ref,
            "B2": sgmv.sgmv_multibank_blocks_ref,
            "B3a": sgmv.sgmv_shrink_blocks_ref,
            "B3b": sgmv.sgmv_expand_blocks_ref,
            "B4a": sgmv.sgmv_multibank_shrink_blocks_ref,
            "B4b": sgmv.sgmv_multibank_expand_blocks_ref,
            "B5": flash.flash_mha_plain}


def _plan(kid, args, dtype, bt=BLOCK_T):
    """What shapes the kernel's work: the shrink split C of B1, B2, B3a
    and B4a (``sgmv.shrink_split``); the expand's output tile of B1, B2,
    B3b and B4b, on the tensor cores (``mma``, bf16) or CUDA cores
    (``fma``, fp32), with B3b's and B4b's grid (token blocks, column
    tiles); B5's (q, kv) tile."""
    from repro_torch.kernels import flash, sgmv
    if kid == "B5":
        return "tile={}x{}".format(*flash.kernel_tile(dtype,
                                                      args[0].shape[-1]))
    plan = []
    if kid not in ("B3b", "B4b"):
        plan.append(f"split={sgmv.shrink_split(args[0].shape[1], dtype)}")
    if kid not in ("B3a", "B4a"):
        op = "mma" if dtype == torch.bfloat16 else "fma"
        tiled = kid in ("B3b", "B4b")
        wide = bt > sgmv.TILE_T                  # B2's 64-row geometry
        cols = sgmv.EXPAND_COLS if tiled else (
            sgmv.WIDE_EXPAND_COLS if wide else sgmv.FUSED_EXPAND_COLS)
        plan.append(f"expand={op}{64 if wide else BLOCK_T}x{cols}")
        if tiled:
            W = args[1][0] if kid == "B4b" else args[1]
            plan.append(f"grid=({args[0].shape[0] // bt},"
                        f"{-(-W.shape[-1] // cols)})")
    return " ".join(plan)


@functools.lru_cache(maxsize=None)
def _roofline(dev):
    """The card's published peaks (``launch/mesh.py:roofline``): the
    bounds' HBM rate and peak FLOP/s by type."""
    from repro_torch.launch.mesh import roofline
    return roofline(dev)


def _check_and_time(kid, layout, args0, kw, dest, flush, results):
    """One kernel wrapper and its plain version on one call's arguments,
    bf16 (as the path ran it) and cast to fp32: compared (every row of
    every whole SGMV block; every output of B5), timed, bounded. B4a
    writes into memory that held NaN just before, so its zero columns
    are checked as written."""
    fn, plain = _wrappers()[kid], _plains()[kid]
    dev = args0[0].device
    for dtype in (torch.bfloat16, torch.float32):
        args = _cast(args0, dtype)
        if kid == "B4a":
            poison = torch.full((args[0].shape[0], max(
                a.shape[-1] for a in args[1])), float("nan"), dtype=dtype,
                device=dev)
            ptr = poison.data_ptr()
            del poison
        y = fn(*args, **kw)
        if kid == "B4a":
            assert y.data_ptr() == ptr, "B4a's output did not reuse the NaN"
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        item = args[0].element_size()
        if kid == "B5":
            yk, yr = y.float(), ref.float()
            causal = kw.get("causal", True)
            byts, flops = _flash_work(args[0], args[1], item, causal)
            shape = f"q={tuple(args[0].shape)}"
            if not causal or args[1].shape[2] != args[0].shape[2]:
                shape += f" k={tuple(args[1].shape)} causal={causal}"
            q, k, v = args
            library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal), flush)
        else:
            bt = _block_t(kw)
            n = args[0].shape[0] // bt * bt
            yk, yr = y[:n].float(), ref[:n].float()
            byts, flops = _sgmv_work(kid, args, kw, dest, item)
            shape = (f"in={tuple(args[0].shape)} block_t={bt} blocks="
                     f"{n // bt} live_rows={dest.shape[0]}")
            if kw.get("block_live") is not None and layout.endswith(
                    "decode"):
                shape += f" block_live={kw['block_live'].tolist()}"
            library_ms = None
        assert torch.isfinite(yk).all(), f"{kid}: non-finite output"
        err = (yk - yr).abs().max().item()
        tol = TOL[dtype]
        assert torch.allclose(yk, yr, atol=tol, rtol=tol), \
            f"{kid} {layout} {dtype}: max abs err {err} > tol {tol}"
        ms = _time_ms(lambda: fn(*args, **kw), flush)
        plain_ms = _time_ms(lambda: plain(*args, **kw), flush)
        roof = _roofline(dev)
        t_bytes = byts / roof.hbm_bytes_per_s * 1e3
        t_ops = flops / roof.flops(dtype) * 1e3
        cores = ""
        if kid == "B5" and dtype == torch.float32:
            # 3xTF32: three dense TF32 FLOPs a FLOP, the least time at
            # fp32 accuracy here; the CUDA cores' bound printed beside it
            cores = f" cuda_core_bound_ms={max(t_bytes, t_ops):.5f}"
            t_ops = 3 * flops / roof.tf32_flops * 1e3
        bound_ms, bound_by = max((t_bytes, "bytes"), (t_ops, "operations"))
        lib = "" if library_ms is None else f" library_ms={library_ms:.4f}"
        plan = _plan(kid, args, dtype, _block_t(kw))
        log(f"kernel {kid} {KERNELS[kid][0]} layout={layout} "
            f"dtype={str(dtype)[6:]} {shape} {plan} "
            f"max_abs_err={err:.3e} "
            f"tol={tol} ms={ms:.4f} plain_ms={plain_ms:.4f}{lib} "
            f"bound_ms={bound_ms:.5f} ({bound_by}: {byts} B, "
            f"{flops} FLOP){cores}")
        results[(kid, layout, dtype)] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms)


def _b1_splits_and_yardstick(calls, flush):
    """B1 in bf16 on its copied decode and prefill calls: its time with
    the shrink split C at 4, 8 and 16 (``shrink_split`` stood in for; the
    occupancy is ``cudaOccupancyMaxActiveClusters`` of B1's kernel), and
    the yardstick the split is weighed against: ``A[aid]`` and ``B[aid]``
    gathered, ``torch.bmm`` then ``torch.bmm`` (h in bf16)."""
    import ctypes
    from repro_torch.kernels import build, sgmv
    lib = build.load_library()
    chosen = sgmv.shrink_split
    for layout in ("decode", "prefill"):
        (x_pad, A, B, ba), kw, _ = calls[("sgmv_fused_blocks", layout)]
        d = x_pad.shape[1]
        for split in (4, 8, 16):
            n = ctypes.c_int(-1)
            err = lib.sgmv_cluster_occupancy(0, 1, split, BLOCK_T,
                                             ctypes.byref(n))
            assert err == 0 and n.value > 0, (split, err, n.value)
            sgmv.shrink_split = lambda d, dtype, split=split: split
            try:
                ms = _time_ms(lambda: sgmv.sgmv_fused_blocks(x_pad, A, B, ba,
                                                             **kw), flush)
            finally:
                sgmv.shrink_split = chosen
            log(f"split: B1 layout={layout} in={tuple(x_pad.shape)} C="
                f"{split}{' (chosen)' if split == chosen(d, A.dtype) else ''}"
                f" ms={ms:.4f} occupancy={n.value} clusters")
        nb = x_pad.shape[0] // BLOCK_T
        xb = x_pad[:nb * BLOCK_T].view(nb, BLOCK_T, d)
        idx = ba[:nb].long()
        ms = _time_ms(lambda: torch.bmm(torch.bmm(xb, A[idx]), B[idx]),
                      flush)
        log(f"yardstick: B1 layout={layout} in={tuple(x_pad.shape)} "
            f"gathered torch.bmm then torch.bmm bf16 ms={ms:.4f} (two "
            "library calls and two gathers, not one call)")


def _yardstick(kid, layout, args, kw, dest, flush):
    """The yardstick of B1, B2, B3a, B3b, B4a or B4b on one of its bf16
    calls, timed only (the port never calls it): the blocks that hold
    tokens, their adapters' weights gathered (``A[aid]``, ``B[aid]``), then
    ``torch.bmm`` of the token blocks: B1 ``(x @ A) @ B``, B3a ``x @ A``,
    B3b ``h @ B``; per
    rank bucket (blocks sorted on the host first), B4a ``x @ A_b``, B4b
    ``h[:, :r_b] @ B_b``, B2 ``(x @ A_b) @ B_b``."""
    bt = _block_t(kw)
    x = args[0]
    nb = x.shape[0] // bt
    xb = x[:nb * bt].view(nb, bt, x.shape[1])
    used = sorted(set((dest.long() // bt).tolist()))
    if kid in ("B1", "B3a", "B3b"):
        W, ba = args[1], args[-1]
        blk = torch.tensor(used, device=x.device)
        idx = ba[blk].long()
        if kid == "B1":
            B = args[2]
            call = lambda: torch.bmm(torch.bmm(xb[blk], W[idx]),  # noqa
                                     B[idx])
            what = "two gathers and two library calls"
        else:
            call = lambda: torch.bmm(xb[blk], W[idx])        # noqa: E731
            what = "a gather and a library call"
    else:
        bkt, row = args[2].tolist(), args[3]
        groups = []
        for b in sorted({bkt[i] for i in used}):
            blk = torch.tensor([i for i in used if bkt[i] == b],
                               device=x.device)
            groups.append((b, blk, row[blk].long()))
        if kid == "B2":
            def call():
                return [torch.bmm(torch.bmm(xb[blk], args[1][b][0][idx]),
                                  args[1][b][1][idx])
                        for b, blk, idx in groups]
        else:
            W = args[1]

            def call():                 # B4b reads h's first r_b columns
                return [torch.bmm(xb[blk] if kid == "B4a" else
                                  xb[blk][..., :W[b].shape[1]], W[b][idx])
                        for b, blk, idx in groups]
        what = (f"{len(groups)} bucket(s): "
                f"{(2 if kid == 'B2' else 1) * len(groups)} library calls "
                "and their gathers")
    ms = _time_ms(call, flush)
    log(f"yardstick: {kid} layout={layout} in={tuple(x.shape)} "
        f"block_t={bt} blocks={len(used)} gathered torch.bmm bf16 "
        f"ms={ms:.4f} ({what}, not one call)")


def _b2_block_sizes(calls, flush):
    """B2 in bf16 on phase 2's recorded prefill dispatcher call (the 2 x
    1000-token group) laid out at block_t 16, 32 and 64 (the plan's pick
    marked; the engine's own call ran at it): against its plain version,
    timed, with the clusters the card holds at once
    (``cudaOccupancyMaxActiveClusters`` of B2's kernel at that block_t).
    The tokens' outputs are equal bit for bit at every block_t."""
    import ctypes
    from repro_torch.kernels import build, ops, sgmv, tune
    lib = build.load_library()
    (x, banks, tok, bucket, local), _, _ = calls[("sgmv_bucketed_fused",
                                                  "prefill")]
    d, d_out = x.shape[1], banks[0][1].shape[-1]
    picked = tune.block_plan(x.shape[0], d, d_out,
                             tuple(A.shape[-1] for A, _ in banks),
                             tuple(A.shape[0] for A, _ in banks))
    ran = calls[("sgmv_multibank_blocks", "prefill")][1]["block_t"]
    assert picked == ran == 64, (picked, ran)
    split = sgmv.shrink_split(d, x.dtype)
    outs = {}
    for bt in (16, 32, 64):
        dest, bb, br, x_pad = ops.bucketed_layout(x, tok, bucket, local,
                                                  len(banks), bt)
        kw = {"block_t": bt,
              "block_live": ops.live_rows(dest, x_pad.shape[0], bt)}
        y = sgmv.sgmv_multibank_blocks(x_pad, banks, bb, br, **kw)
        ref = sgmv.sgmv_multibank_blocks_ref(x_pad, banks, bb, br, **kw)
        torch.cuda.synchronize()
        n = x_pad.shape[0] // bt * bt
        err = (y[:n].float() - ref[:n].float()).abs().max().item()
        tol = TOL[torch.bfloat16]
        assert torch.allclose(y[:n].float(), ref[:n].float(), atol=tol,
                              rtol=tol), (bt, err)
        outs[bt] = y[dest.long()]
        ms = _time_ms(lambda: sgmv.sgmv_multibank_blocks(x_pad, banks, bb,
                                                         br, **kw), flush)
        plain_ms = _time_ms(lambda: sgmv.sgmv_multibank_blocks_ref(
            x_pad, banks, bb, br, **kw), flush)
        occ = ctypes.c_int(-1)
        assert lib.sgmv_cluster_occupancy(1, 1, split, bt,
                                          ctypes.byref(occ)) == 0
        assert occ.value > 0, (bt, occ.value)
        log(f"plan: B2 layout=prefill block_t={bt}"
            f"{' (the plan)' if bt == picked else ''} in="
            f"{tuple(x_pad.shape)} blocks={n // bt} dtype=bfloat16 "
            f"max_abs_err={err:.3e} tol={tol} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} occupancy={occ.value} clusters of "
            f"{split}")
    assert all(torch.equal(outs[16], o) for o in outs.values())
    log("plan: B2's outputs at block_t 16, 32 and 64 equal bit for bit")


def phase_kernels(dev, calls):
    """Each kernel wrapper and its plain version on the arguments of the
    main path's own calls (bf16, as the engine ran them, and the same
    tensors cast to fp32); B2 at block_t 16, 32 and 64 on the prefill
    group; B1's split sweep and yardstick, the gathered-bmm yardsticks of
    B2, B3a and B3b."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    results = {}
    for kid, layout, args0, kw, dest in _kernel_cases(calls):
        _check_and_time(kid, layout, args0, kw, dest, flush, results)
        if kid in ("B2", "B3a", "B3b"):
            _yardstick(kid, layout, args0, kw, dest, flush)
    _b2_block_sizes(calls, flush)
    _b1_splits_and_yardstick(calls, flush)
    del flush
    return results


# ---------------------------------------------------------------------------
# phases 2, 4 and 5: the engine and the unfused path
# ---------------------------------------------------------------------------


def _path_launches(cfg, mode, passes, groups):
    """What an engine's runs launch: the mode's SGMV kernel once per LoRA
    call of a model pass (MLA calls q, k and o: its v adapter is never
    applied; the hybrid's calls come at each application of its shared
    attention block, RWKV-6's at each layer), B5 once per attention layer
    or application per prefill group of an MHA model without a window;
    nothing else. The VLM launches nothing (no adapter reaches it, and
    its attention is GQA); the audio family's adapters reach its
    decoder's self-attention in prefill only (ROADMAP C3), and B5 runs
    its decoder's causal self-attention, its encoder and its
    cross-attention, once a layer each per prefill group."""
    from repro_torch.models.model import n_attn_applications
    calls = 3 if cfg.mla is not None else len(cfg.lora.targets)
    n_attn = n_attn_applications(cfg)
    lora_layers = n_attn if cfg.family == "hybrid" else cfg.n_layers
    want = {kid: 0 for kid in KERNELS}
    if cfg.family == "vlm":
        return want
    if cfg.family == "audio":
        want[{"padded": "B1", "bucketed": "B2"}[mode]] = \
            calls * cfg.n_layers * groups
        want["B5"] = (2 * cfg.n_layers + cfg.encoder.n_layers) * groups
        return want
    want[{"padded": "B1", "bucketed": "B2"}[mode]] = \
        calls * lora_layers * passes
    if n_attn and cfg.mla is None and cfg.n_heads == cfg.n_kv_heads \
            and not cfg.sliding_window:
        want["B5"] = n_attn * groups
    return want


def _serve_trace(cfg, n, dev):
    """Phase 2's trace at ``n`` requests: adapters of ranks 8..128 in
    turn, prompts 64, 128, 64, 1000 in turn, 16 new tokens each; bf16
    adapter weights at each target's widths (phase 2's seed)."""
    from repro_torch.launch.serve import adapter_weights, build_trace
    trace = build_trace(cfg, n, (64, 128, 64, 1000), 16, seed=0)
    ranks = {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace}
    return trace, ranks, adapter_weights(cfg, ranks, dtype=torch.bfloat16,
                                         device=dev, seed=3)


def phase_engine(dev):
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = get_config("llama-7b-paper")
    t0 = time.monotonic()
    params = M.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    log(f"engine: llama-7b-paper {cfg.n_layers} layers d={cfg.d_model} "
        f"bf16 params={n_par} ({n_par * 2 / 1e9:.2f} GB) init "
        f"{time.monotonic() - t0:.1f}s")
    # prompts 64, 128, 64, 1000 in turn: groups of 4 x 64, 2 x 128 and
    # 2 x 1000 tokens, the last over adapters of ranks 64 and 32
    trace, _, weights = _serve_trace(cfg, 8, dev)
    wrappers = _wrappers()
    sgmv_kid = {"padded": "B1", "bucketed": "B2"}
    outputs, banks = {}, {}
    # the main path: counts at 0 just before, read just after; the
    # recorder copies the arguments of a few calls for phases 3 and 4
    for k in wrappers.values():
        k.launches = 0
    with MainPathCalls() as rec:
        for mode in ("padded", "bucketed"):
            for db in (1, 4):
                before = {kid: k.launches for kid, k in wrappers.items()}
                torch.cuda.reset_peak_memory_stats(dev)
                eng, reqs, s = serve(
                    cfg, params, trace, weights=weights, bank_mode=mode,
                    lora_kernel="sgmv", decode_block=db, max_batch=8,
                    device=dev)
                torch.cuda.synchronize()
                grew = {kid: k.launches - before[kid]
                        for kid, k in wrappers.items()}
                want = _path_launches(
                    cfg, mode, eng.prefill_dispatches + eng.decode_iterations,
                    eng.prefill_dispatches)
                assert all(len(r.output) == 16 for r in reqs), \
                    [len(r.output) for r in reqs]
                assert all(0 <= t < cfg.vocab_size for r in reqs
                           for t in r.output)
                assert grew == want, (grew, want)
                assert eng.prefill_dispatches == 3, eng.prefill_dispatches
                outputs[(mode, db)] = [r.output for r in reqs]
                banks[mode] = eng.lora_bank
                log(f"engine mode={mode} decode_block={db} finished="
                    f"{s['finished']}/8 prefill_groups="
                    f"{eng.prefill_dispatches} decode_steps="
                    f"{eng.decode_iterations} launches "
                    f"{sgmv_kid[mode]}={grew[sgmv_kid[mode]]} "
                    f"B5={grew['B5']}"
                    f" p50_ttft_ms={s['p50_ttft'] * 1e3:.2f}"
                    f" p95_ttft_ms={s['p95_ttft'] * 1e3:.2f}"
                    f" mean_tbt_ms={s['mean_tbt'] * 1e3:.3f}"
                    f" decode_tok_s={s['decode_tok_s']:.1f}"
                    f" wall_s={s['wall_s']:.3f} max_mem_gb="
                    f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
                del eng
    launches = {kid: k.launches for kid, k in wrappers.items()}
    first = outputs[("padded", 1)]
    for key, out in outputs.items():
        assert out == first, f"tokens of {key} differ from padded/1"
    log(f"engine: all 4 runs emit the same tokens; first request "
        f"{first[0]}")
    tp_ref = {}                  # phase 6's reference: tokens, logits
    for mode in ("padded", "bucketed"):
        eng, reqs, _ = _serve_tp_trace(cfg, params, dev, mode)
        tp_ref[mode] = ([r.output for r in reqs], _first_logits(cfg, eng))
        if mode == "padded":
            einsum = _first_logits(cfg, eng, kernel="einsum")
        del eng
    assert tp_ref["padded"][0] == tp_ref["bucketed"][0]
    assert torch.equal(tp_ref["padded"][1], tp_ref["bucketed"][1])
    return cfg, launches, rec.calls, banks, tp_ref, params, einsum


def _noise_floor(cfg, params, dev, tp_ref, einsum):
    """The end of phase 2: the bf16 noise floor of phase 6's first prefill
    at tp = 1, against the einsum LoRA form and against fp32 on the same
    weights (``params`` is upcast in place, then freed)."""
    ref = tp_ref["padded"][1]
    tp_ref["fp32"] = _fp32_first_logits(cfg, params, dev)  # params -> fp32
    scale = ref.abs().max().item()
    for what, other in (("the einsum LoRA form", einsum),
                        ("fp32 on the same weights", tp_ref["fp32"])):
        err = (ref - other).abs().max().item()
        log(f"engine: bf16 noise floor, tp = 1 first prefill logits vs "
            f"{what}: max abs diff {err:.4e} of max |logit| {scale:.4f} "
            f"({err / scale:.3%})")
    log("engine: phase 6's trace served at tp = 1 (its reference); padded "
        "and bucketed tokens and logits equal bit for bit")


def _tp_trace(cfg):
    """Phase 6's trace: 8 requests over the 5 adapters, prompts of 64 and
    128 tokens (two prefill groups of 4), 16 new tokens each."""
    from repro_torch.launch.serve import build_trace
    return build_trace(cfg, 8, (64, 128), 16, seed=0)


def _tp_ranks(cfg):
    """Phase 6's trace's adapters and their ranks."""
    return {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in _tp_trace(cfg)}


def _tp_weights(cfg, dev):
    """Phase 6's trace's adapter ranks and bf16 weights (phase 2's seed)."""
    from repro_torch.launch.serve import adapter_weights
    ranks = _tp_ranks(cfg)
    return ranks, adapter_weights(cfg, ranks, dtype=torch.bfloat16,
                                  device=dev, seed=3)


def _serve_tp_trace(cfg, params, dev, mode, mesh=None):
    """Phase 6's trace on one engine (a rank's, with ``mesh``), bf16,
    sgmv, decode_block 4, phase 2's adapter weights. Returns (engine,
    requests, summary)."""
    from repro_torch.launch.serve import serve
    return serve(cfg, params, _tp_trace(cfg), weights=_tp_weights(cfg, dev)[1],
                 bank_mode=mode, lora_kernel="sgmv", decode_block=4,
                 max_batch=8, mesh=mesh, device=dev)


def _group(eng, trace, S):
    """The trace's prompts of ``S`` tokens: (tokens, the bank's lora_idx)
    on the engine's device."""
    group = [(aid, p) for aid, p, _ in trace if len(p) == S]
    toks = torch.tensor([p for _, p in group], device=eng.device)
    gi = torch.tensor([eng.lora_bank.index(a) for a, _ in group],
                      dtype=torch.int32, device=eng.device)
    return toks, eng.lora_bank.lora_idx(gi)


def _group_logits(cfg, eng, trace, S, kernel="sgmv", mesh=None):
    """The trace's prompts of ``S`` tokens as one prefill group through
    ``eng``'s model and bank again (with the engine's zero frontend where
    the family takes one): fp32 logits on the host."""
    from repro_torch.models import model as M
    toks, idx = _group(eng, trace, S)
    lg, _ = M.prefill(cfg, eng.params, toks,
                      frontend=eng.zero_frontend(len(toks)), bank=eng.bank,
                      lora_idx=idx, lora_kernel=kernel, tp=mesh)
    assert torch.isfinite(lg).all()
    return lg.float().cpu()


def _first_logits(cfg, eng, kernel="sgmv", mesh=None):
    """The first prefill group of phase 6's trace (4 x 64 tokens): (4, V)
    logits."""
    return _group_logits(cfg, eng, _tp_trace(cfg), 64, kernel, mesh)


def _fp32_engine(cfg, params, ranks, weights, max_len):
    """An fp32 engine on the bf16 weights upcast (``params`` converted in
    place) and the adapter weights upcast, einsum LoRA on a padded bank."""
    from repro_torch.serving import ServingEngine
    params.float()
    eng = ServingEngine(cfg, params, ranks, max_batch=8, max_len=max_len,
                        bank_mode="padded", lora_kernel="einsum",
                        device=params.embed.device)
    for aid, w in weights.items():
        eng.install_adapter(aid, ranks[aid], {
            t: {k: v.float() for k, v in ab.items()} for t, ab in w.items()})
    return eng


def _fp32_first_logits(cfg, params, dev):
    """``_first_logits`` in fp32 on the bf16 weights upcast: ``params``
    (converted in place) and phase 2's adapter weights, einsum LoRA on a
    padded bank. How far a bf16 pass lies from it is the bf16 noise floor
    that phase 6's tp = 2 logits are held to."""
    ranks, weights = _tp_weights(cfg, dev)
    eng = _fp32_engine(cfg, params, ranks, weights, 72)
    return _first_logits(cfg, eng, kernel="einsum")


def _plain_bgmv(x, A, B, tok):
    """bgmv's plain version: the block_t = 1 layout through the plain
    shrink and expand."""
    from repro_torch.kernels import ops, sgmv
    Na = A.shape[0]
    dest, ba = ops.prepare_segments(tok, Na, 1)
    x_pad = ops.scatter_rows(x, dest, ops.padded_len(x.shape[0], Na, 1))
    h = sgmv.sgmv_shrink_blocks_ref(x_pad, A, ba, block_t=1)
    return sgmv.sgmv_expand_blocks_ref(h, B, ba, block_t=1)[dest.long()]


def _zero_padded(banks, bucket, local):
    """Batch row a's adapter (bucket[a], row local[a]) of a rank-bucketed
    bank set as row a of one bank zero-padded to the largest rank."""
    max_r = max(A.shape[-1] for A, _ in banks)
    A0, B0 = banks[0]
    Na = bucket.shape[0]
    Ap = A0.new_zeros((Na, A0.shape[1], max_r))
    Bp = B0.new_zeros((Na, max_r, B0.shape[-1]))
    for a, (b, row) in enumerate(zip(bucket.tolist(), local.tolist())):
        A, B = banks[b]
        Ap[a, :, :A.shape[-1]] = A[row]
        Bp[a, :B.shape[1]] = B[row]
    return Ap, Bp


def _bucketed_identities(layout, args, kw):
    """On one recorded bucketed dispatcher call, in bf16 and cast to fp32:
    B2 at the plan's block_t (the call as the engine made it) == the host
    loop ``sgmv_rank_bucketed`` (B3a/B3b) at 16 == B1 (``sgmv_fused``) on
    the zero-padded bank, bit for bit."""
    from repro_torch.kernels import ops, tune
    for dtype in (torch.bfloat16, torch.float32):
        x, bk, tok, bucket, local = _cast(args, dtype)
        y_plan = ops.sgmv_bucketed_fused(x, bk, tok, bucket, local, **kw)
        fixed = {**kw, "block_t": BLOCK_T}
        y_host = ops.sgmv_rank_bucketed(x, bk, tok, bucket,
                                        adapter_local=local, **fixed)
        Ap, Bp = _zero_padded(bk, bucket, local)
        y_pad = ops.sgmv_fused(x, Ap, Bp, tok, **fixed)
        assert torch.isfinite(y_plan.float()).all()
        assert torch.equal(y_plan, y_host), (layout, dtype, "host loop")
        assert torch.equal(y_plan, y_pad), (layout, dtype, "padded B1")
    bt = tune.block_plan(x.shape[0], x.shape[1], bk[0][1].shape[-1],
                         tuple(A.shape[-1] for A, _ in bk),
                         tuple(A.shape[0] for A, _ in bk))
    log(f"unfused: the engine's bucketed {layout} call x="
        f"{tuple(x.shape)}: B2 at the plan's block_t={bt} == host loop "
        f"(B3a/B3b) at 16 == B1 on the zero-padded bank, bit for bit, "
        "bf16 and fp32")


def phase_unfused(dev, cfg, calls, banks):
    """The path through B3a/B3b, driven with their counts at 0 just before
    and read just after: the unfused dispatchers on the engine's own
    copied dispatcher calls and on its own banks, each bit for bit equal
    to the fused path."""
    from repro_torch.kernels import ops
    from repro_torch.lora.batched import apply_bank_sgmv
    wrappers = _wrappers()
    b3 = {kid: wrappers[kid] for kid in ("B3a", "B3b")}
    for k in b3.values():
        k.launches = 0
    checked = 0
    for (name, layout), (args, kw, _) in sorted(calls.items()):
        if name == "sgmv_fused":
            y_f = ops.sgmv_fused(*args, **kw)
            y_u = ops.sgmv(*args, **kw)
        elif name == "sgmv_bucketed_fused":
            _bucketed_identities(layout, args, kw)
            checked += 4
            continue
        else:
            continue
        assert torch.equal(y_f, y_u), f"{name} {layout}: unfused differs"
        log(f"unfused: the engine's {name} {layout} call x="
            f"{tuple(args[0].shape)}: unfused == fused bit for bit")
        checked += 1
    g = torch.Generator(device=dev).manual_seed(7)
    for mode, bank in sorted(banks.items()):
        for T in (8, 512):
            x = torch.randn((T, cfg.d_model), generator=g, device=dev
                            ).to(torch.bfloat16)
            tok = torch.randint(0, bank.n_adapters, (T,), generator=g,
                                device=dev, dtype=torch.int32)
            for name in cfg.lora.targets:
                y_f = apply_bank_sgmv(x, bank, name, 0, tok, fused=True)
                y_u = apply_bank_sgmv(x, bank, name, 0, tok, fused=False)
                assert torch.isfinite(y_f.float()).all()
                assert torch.equal(y_f, y_u), (mode, T, name)
                checked += 1
            log(f"unfused: apply_bank_sgmv {mode} bank T={T} targets "
                f"{list(cfg.lora.targets)}: fused=False == fused=True bit "
                "for bit")
    t = banks["padded"].data["q"]
    A, B = t["A"][0], t["B"][0]
    x = torch.randn((8, cfg.d_model), generator=g, device=dev
                    ).to(torch.bfloat16)
    tok = torch.randint(0, A.shape[0], (8,), generator=g, device=dev,
                        dtype=torch.int32)
    y = ops.bgmv(x, A, B, tok)
    ref = _plain_bgmv(x, A, B, tok)
    tol = TOL[torch.bfloat16]
    err = (y.float() - ref.float()).abs().max().item()
    assert torch.allclose(y.float(), ref.float(), atol=tol, rtol=tol), err
    assert torch.equal(y, ops.sgmv_fused(x, A, B, tok))
    log(f"unfused: bgmv (block_t 1) vs plain max abs err {err:.3e} tol "
        f"{tol}; == sgmv_fused (block_t 16) bit for bit")
    launches = {kid: k.launches for kid, k in b3.items()}
    assert all(n > 0 for n in launches.values()), launches
    log(f"unfused: {checked} bitwise pairs; launches {launches}")
    return launches


def _parity_setup(dev):
    """Phase 5's fp32 model (full width, 2 layers), trace and adapter
    weights, all from seeds."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import adapter_weights, build_trace
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("llama-7b-paper"), n_layers=2)
    params = M.init_params(cfg, 1, dtype=torch.float32, device=dev)
    trace = build_trace(cfg, 5, (24, 40), 8, seed=1)
    ranks = {aid: int(aid.rsplit("-r", 1)[1]) for aid, _, _ in trace}
    weights = adapter_weights(cfg, ranks, dtype=torch.float32, device=dev,
                              seed=4)
    return cfg, params, trace, weights


def phase_parity(dev):
    """Returns the tokens all four engines emitted and the padded/einsum
    engine's prefill logits of the trace's 24-token prompts."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg, params, trace, weights = _parity_setup(dev)
    outs, logits = {}, {}
    for mode in ("padded", "bucketed"):
        for kernel in ("sgmv", "einsum"):
            eng, reqs, _ = serve(cfg, params, trace, weights=weights,
                                 bank_mode=mode, lora_kernel=kernel,
                                 max_batch=8, device=dev)
            outs[(mode, kernel)] = [r.output for r in reqs]
            logits[(mode, kernel)] = _group_logits(cfg, eng, trace, 24,
                                                   kernel)
    ref = logits[("padded", "einsum")]
    for key, lg in logits.items():
        err = (lg - ref).abs().max().item()
        log(f"parity fp32 2 layers {key}: prefill logits max abs diff vs "
            f"padded/einsum {err:.3e}; tokens equal: "
            f"{outs[key] == outs[('padded', 'einsum')]}")
        assert err <= 1e-3, (key, err)
        assert outs[key] == outs[("padded", "einsum")], key
    toks = torch.tensor([p for _, p, _ in trace if len(p) == 24],
                        device=dev)
    delta = (ref - M.prefill(cfg, params, toks)[0].cpu()).abs().max().item()
    log(f"parity: the LoRA delta moves the logits by {delta:.3e}")
    assert delta > 1e-3
    del params
    torch.cuda.empty_cache()
    return outs[("padded", "einsum")], ref


# ---------------------------------------------------------------------------
# phases 6 and 7: the tensor-parallel engine and the split kernels B4a/B4b
# ---------------------------------------------------------------------------


def _time_collective(fn, reps=20):
    """Median host ms of one collective ``fn()``, the card synchronised
    before and after; every rank calls it."""
    times = []
    for i in range(reps + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        if i >= 3:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _time_all_reduce(x):
    """``_time_collective`` of an all-reduce of ``x`` over the default
    group."""
    import torch.distributed as dist
    return _time_collective(lambda: dist.all_reduce(x))


def _tp_rank(rank, tp, out_dir):
    """One rank of phase 6, spawned with a default gloo group. Writes
    ``rank{rank}.pt``; rank 0 also ``calls.pt``, copies of its calls of
    every kernel of the path."""
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_engine_mesh(1, tp, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = get_config("llama-7b-paper")
    params = M.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    wrappers = _wrappers()
    all_reduce, reduces = dist.all_reduce, [0]

    def counted(*a, **kw):
        reduces[0] += 1
        return all_reduce(*a, **kw)

    out = {"bf16": {}, "fp32": {}, "fp32_logits": {}}
    dist.all_reduce = counted
    try:
        with MainPathCalls(tp=True) as rec:
            for mode in ("padded", "bucketed"):
                # the main path: counts at 0 just before each engine run,
                # read just after
                for k in wrappers.values():
                    k.launches = 0
                n0 = reduces[0]
                eng, reqs, summ = _serve_tp_trace(cfg, params, dev, mode,
                                                  mesh)
                torch.cuda.synchronize()
                out["bf16"][mode] = dict(
                    tokens=[r.output for r in reqs], summary=summ,
                    grew={kid: k.launches for kid, k in wrappers.items()},
                    passes=eng.prefill_dispatches + eng.decode_iterations,
                    prefills=eng.prefill_dispatches,
                    reduces=reduces[0] - n0)
                # off the counted run; one engine (6.5 GB of weights) at
                # a time
                out["bf16"][mode]["logits"] = _first_logits(cfg, eng,
                                                            mesh=mesh)
                del eng
    finally:
        dist.all_reduce = all_reduce
    out["launches"] = {kid: sum(out["bf16"][m]["grew"][kid]
                                for m in out["bf16"]) for kid in wrappers}
    out["flash_heads"] = rec.calls[("flash_mha", "prefill")][0][0].shape[1]
    if rank == 0:
        torch.save({key: _move(call, "cpu") for key, call in
                    rec.calls.items()}, Path(out_dir) / "calls.pt")
    h = rec.calls[("sgmv_multibank_expand", "decode")][0][0]
    out["all_reduce_ms"] = {
        f"h {tuple(h.shape)} bf16 (bucketed decode)":
            _time_all_reduce(torch.ones_like(h)),
        "hidden (8, 1, 4096) bf16 (decode)": _time_all_reduce(
            torch.ones((8, 1, 4096), dtype=torch.bfloat16, device=dev)),
        "hidden (4, 128, 4096) bf16 (prefill)": _time_all_reduce(
            torch.ones((4, 128, 4096), dtype=torch.bfloat16, device=dev))}
    del params, rec
    torch.cuda.empty_cache()
    cfg2, params2, trace2, weights2 = _parity_setup(dev)
    for mode in ("padded", "bucketed"):
        eng, reqs, _ = serve(cfg2, params2, trace2, weights=weights2,
                             bank_mode=mode, lora_kernel="sgmv", max_batch=8,
                             mesh=mesh, device=dev)
        out["fp32"][mode] = [r.output for r in reqs]
        out["fp32_logits"][mode] = _group_logits(cfg2, eng, trace2, 24,
                                                 mesh=mesh)
        del eng
    torch.save(out, Path(out_dir) / f"rank{rank}.pt")


def phase_tp(cfg, tp_ref, fp32_ref):
    """Phase 6 over TP ranks on this card; ``fp32_ref`` is phase 5's
    (tokens, prefill logits). Returns (rank 0's launch counts, rank 0's
    copied kernel calls)."""
    from repro_torch.launch.mesh import spawn
    per_pass = len(cfg.lora.targets) * cfg.n_layers
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_tp_rank, TP, backend="gloo", init_file=Path(tmp) / "init",
              args=(TP, tmp))
        outs = [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(TP)]
        calls = torch.load(Path(tmp) / "calls.pt", weights_only=False)
    for r, o in enumerate(outs):
        assert o["flash_heads"] == cfg.n_heads // TP, o["flash_heads"]
        for mode in ("padded", "bucketed"):
            b = o["bf16"][mode]
            split = ("B3a", "B3b") if mode == "padded" else ("B4a", "B4b")
            want = {kid: 0 for kid in KERNELS}
            want.update({kid: per_pass * b["passes"] for kid in split})
            want["B5"] = cfg.n_layers * b["prefills"]
            assert b["grew"] == want, (r, mode, b["grew"], want)
            assert all(len(t) == 16 for t in b["tokens"])
            assert torch.isfinite(b["logits"]).all()
            if r == 0:
                s = b["summary"]
                log(f"tp: rank 0 mode={mode} finished={s['finished']}/8 "
                    f"passes={b['passes']} all_reduces={b['reduces']} "
                    f"launches {split[0]}={b['grew'][split[0]]} "
                    f"{split[1]}={b['grew'][split[1]]} B5={b['grew']['B5']}"
                    f" ({o['flash_heads']} local heads)"
                    f" p50_ttft_ms={s['p50_ttft'] * 1e3:.2f}"
                    f" mean_tbt_ms={s['mean_tbt'] * 1e3:.3f}"
                    f" decode_tok_s={s['decode_tok_s']:.1f}"
                    f" wall_s={s['wall_s']:.3f}")
                continue
            a = outs[0]["bf16"][mode]
            assert b["tokens"] == a["tokens"], f"ranks disagree ({mode})"
            assert torch.equal(b["logits"], a["logits"]), mode
            assert torch.equal(o["fp32_logits"][mode],
                               outs[0]["fp32_logits"][mode]), mode
        assert o["fp32"] == outs[0]["fp32"], "ranks disagree (fp32)"
    log(f"tp: {TP} ranks emit the same tokens and logits")
    # at tp = 1 B1 and B2 agree bit for bit; at tp = 2 so do B3a->B3b and
    # B4a->B4b, through the same all-reduce of the same h columns
    pad, bkt = outs[0]["bf16"]["padded"], outs[0]["bf16"]["bucketed"]
    assert pad["tokens"] == bkt["tokens"], "tp = 2 modes' tokens differ"
    assert torch.equal(pad["logits"], bkt["logits"]), \
        "tp = 2 modes' logits differ"
    log("tp: padded (B3a/B3b) and bucketed (B4a/B4b) emit the same tokens "
        "and first-prefill logits, bit for bit")
    fp32_tokens, fp32_logits = fp32_ref
    for mode in ("padded", "bucketed"):
        got = outs[0]["bf16"][mode]
        ref_tokens, ref_logits = tp_ref[mode]
        err = (got["logits"] - ref_logits).abs().max().item()
        scale = ref_logits.abs().max().item()
        err32 = (got["logits"] - tp_ref["fp32"]).abs().max().item()
        same = sum(a == b for a, b in zip(got["tokens"], ref_tokens))
        agree = sum(x == y for a, b in zip(got["tokens"], ref_tokens)
                    for x, y in zip(a, b))
        elementwise = torch.allclose(got["logits"], ref_logits, atol=5e-2,
                                     rtol=5e-2)
        log(f"tp: bf16 {mode} first prefill logits vs tp = 1: max abs diff "
            f"{err:.4e} of max |logit| {scale:.4f} ({err / scale:.3%}; "
            f"elementwise allclose 5e-2: {elementwise}); first-token "
            f"argmax agree "
            f"{(got['logits'].argmax(-1) == ref_logits.argmax(-1)).tolist()};"
            f" {same}/8 requests and {agree}/128 tokens as tp = 1; vs "
            f"fp32 on the same weights: max abs diff {err32:.4e} "
            f"({err32 / scale:.3%})")
        assert err <= 5e-2 * scale, (mode, err, scale)
        assert err32 <= 5e-2 * scale, (mode, err32, scale)
        assert outs[0]["fp32"][mode] == fp32_tokens, mode
        err = (outs[0]["fp32_logits"][mode] - fp32_logits).abs().max().item()
        log(f"tp: fp32 2 layers {mode}: prefill logits max abs diff vs tp = "
            f"1 {err:.3e} (tol 1e-3)")
        assert err <= 1e-3, (mode, err)
    log("tp: fp32 2 layers, both modes: tp = 2 tokens == tp = 1 tokens")
    for name, ms in outs[0]["all_reduce_ms"].items():
        log(f"tp: all_reduce {name}: {ms:.4f} ms (gloo, {TP} ranks on one "
            "card, host clock)")
    return outs[0]["launches"], calls


def phase_split(dev, cfg, tp_calls, b2_calls):
    """Phase 7: every kernel of the tp = 2 path against its plain version
    on rank 0's calls, timed; B4a then B4b == B2 on phase 2's B2 calls.
    B4a/B4b, which run on this path only, keep the ``decode`` and
    ``prefill`` layout names; B3a, B3b and B5, whose tp = 1 calls phase 3
    checked, are filed under ``tp2-...``."""
    from repro_torch.kernels import ops, sgmv
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    results = {}
    d_local = cfg.d_model // TP
    for kid in ("B4a", "B4b", "B3a", "B3b", "B5"):
        name = KERNELS[kid][0]
        for layout in ("decode", "prefill"):
            args, kw, dest = _move(tp_calls[(name, layout)], dev)
            if kid == "B5":
                q = args[0]
                assert q.shape[1] == cfg.n_heads // TP, q.shape
                label = f"tp{TP}-prefill-S{q.shape[2]}"
            else:
                W = args[1][0] if kid in ("B4a", "B4b") else args[1]
                assert (W.shape[1] if kid in ("B4a", "B3a")
                        else W.shape[-1]) == d_local, W.shape
                label = layout if kid in ("B4a", "B4b") else \
                    f"tp{TP}-{layout}"
            _check_and_time(kid, label, args, kw, dest, flush, results)
            if kid != "B5":
                _yardstick(kid, label, args, kw, dest, flush)
    del flush
    for layout in ("decode", "prefill"):
        args, kw, _ = b2_calls[layout]
        for dtype in (torch.bfloat16, torch.float32):
            x, bk, tok, bucket, local = _cast(args, dtype)
            # B2 as the engine called it (the plan's block_t), B4a then
            # B4b at 16 as the tensor-parallel path lays tokens out
            y_b2 = ops.sgmv_bucketed_fused(x, bk, tok, bucket, local, **kw)
            dest, bkt, row, x_pad = ops.bucketed_layout(
                x, tok, bucket, local, len(bk), BLOCK_T)
            h = sgmv.sgmv_multibank_shrink(
                x_pad, [A for A, _ in bk], bkt, row,
                block_live=ops.live_rows(dest, x_pad.shape[0], BLOCK_T))
            y = sgmv.sgmv_multibank_expand(h, [B for _, B in bk], bkt, row)
            y = y[dest.long()] * kw["scaling"]
            assert torch.equal(y, y_b2), (layout, dtype)
        log(f"split: B4a then B4b (block_t 16) == B2 (block_t "
            f"{b2_calls[layout][2]}) bit for bit on phase 2's {layout} "
            f"bucketed call x={tuple(args[0].shape)}, bf16 and fp32")
    return results


# ---------------------------------------------------------------------------
# phase 8: the cluster facade
# ---------------------------------------------------------------------------
CLUSTER = dict(n_requests=16, prompt_lens=(64, 128), max_new=16,
               duration=3.0, dt=0.25, rebalance_period=1.0, max_batch=8,
               decode_block=4)


def _cluster_run(cfg, params, weights, mode, *, kill=None, wall=False,
                 **kw):
    """Phase 8's setup with a ``mode`` bank, driven on the virtual clock
    (or replayed on the wall clock with ``wall``): 2 servers over
    ``params``, the launcher's 8 adapters, 16 requests of drifting
    popularity over 3 s, prompts of 64 and 128 tokens, 16 new tokens each.
    ``kill`` = (time, server) adds ``FaultPlan.kill_one``. Every kernel
    count is 0 just before the drive. Returns (cluster, report, trace,
    launch counts)."""
    from repro_torch.faults import FaultPlan
    from repro_torch.launch.serve import (build_cluster_trace,
                                          cluster_adapters, drive,
                                          make_cluster)
    c = CLUSTER
    adapters = cluster_adapters(8)
    cluster = make_cluster(
        cfg, params, adapters, weights, 2,
        max_len=max(c["prompt_lens"]) + c["max_new"] + 8,
        max_batch=c["max_batch"], bank_mode=mode,
        decode_block=c["decode_block"],
        rebalance_period=c["rebalance_period"],
        fault_plan=None if kill is None else FaultPlan.kill_one(*kill),
        device=params.embed.device, **kw)
    trace = build_cluster_trace(adapters, cfg, c["n_requests"],
                                c["prompt_lens"], c["max_new"],
                                c["duration"], seed=0)
    wrappers = _wrappers()
    for k in wrappers.values():
        k.launches = 0
    report = cluster.run(trace) if wall else drive(cluster, trace, c["dt"])
    torch.cuda.synchronize()
    launches = {kid: k.launches for kid, k in wrappers.items()}
    assert report.completed() == len(trace), report.completed()
    assert all(len(r.output) == c["max_new"] for r in trace), \
        [len(r.output) for r in trace]
    assert all(0 <= t < cfg.vocab_size for r in trace for t in r.output)
    return cluster, report, trace, launches


def _cluster_launches(cfg, engines, mode, launches):
    """The mode's SGMV kernel launched 4 x 32 times a model pass and B5
    32 times a prefill group, over ``engines`` together; nothing else.
    Returns (model passes, prefill groups)."""
    passes = sum(e.prefill_dispatches + e.decode_iterations for e in engines)
    groups = sum(e.prefill_dispatches for e in engines)
    want = _path_launches(cfg, mode, passes, groups)
    assert launches == want, (launches, want)
    return passes, groups


def _engines(cluster):
    return [e for e in cluster.backend.engines if e is not None]


def _tokens(trace):
    return {r.req_id: list(r.output) for r in trace}


def _free():
    """Free a dropped cluster's engines now: each engine's clock is a
    method of its backend, a reference cycle that only the collector
    breaks, and their banks and caches hold gigabytes of the card."""
    gc.collect()
    torch.cuda.empty_cache()


def phase_cluster(dev, cfg, params, smi):
    """Phase 8 on phase 2's bf16 ``params`` (and phase 5's fp32 2-layer
    model for the kill)."""
    from repro_torch.launch.serve import (adapter_weights, cluster_adapters,
                                          cluster_summary, warm_up)
    ranks = {a.adapter_id: a.rank for a in cluster_adapters(8)}
    weights = adapter_weights(cfg, ranks, dtype=torch.bfloat16, device=dev,
                              seed=3)
    par_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    warm_up(cfg, params, weights, bank_mode="bucketed", decode_block=4,
            device=dev)
    _free()
    # (a) the virtual-clock drive in both bank modes
    runs = {}
    for mode in ("padded", "bucketed"):
        torch.cuda.reset_peak_memory_stats(dev)
        cluster, rep, trace, launches = _cluster_run(cfg, params, weights,
                                                     mode)
        peak = torch.cuda.max_memory_allocated(dev)
        passes, groups = _cluster_launches(cfg, _engines(cluster), mode,
                                           launches)
        assert rep.rebalances >= 1 and rep.placement_changed(), \
            (rep.rebalances, rep.placements)
        be = cluster.backend
        for sid, mem in enumerate(rep.memory_profile):
            hosted = be.hosted_adapters(sid)
            assert mem["max_rank"] == max(hosted.values()), (sid, mem, hosted)
        # one copy of the base weights: the engines share ``params``
        assert all(e.params is params for e in be.engines if e is not None)
        assert peak < 2 * par_bytes, (peak, par_bytes)
        runs[mode] = (cluster.routed, rep.placements, _tokens(trace))
        log(f"cluster (a) mode={mode} virtual clock dt={CLUSTER['dt']}s: "
            f"finished={rep.completed()}/{len(trace)} rebalances="
            f"{rep.rebalances} placements={len(rep.placements)} "
            f"per_server={rep.per_server_counts} max_rank="
            f"{[m['max_rank'] for m in rep.memory_profile]} hosted="
            f"{[sorted(be.hosted_adapters(s)) for s in range(2)]} "
            f"model_passes={passes} prefill_groups={groups} launches="
            f"{ {k: v for k, v in launches.items() if v} } bank_builds="
            f"{be.bank_builds} bank_rebuilds={be.bank_rebuilds} bank_ms="
            f"{[round(x, 1) for x in be.bank_ms]} peak_gb={peak / 1e9:.2f} "
            f"(params {par_bytes / 1e9:.2f})")
        del cluster, be
        _free()
    assert runs["padded"][0] == runs["bucketed"][0], "routing differs"
    assert runs["padded"][1] == runs["bucketed"][1], "placements differ"
    assert runs["padded"][2] == runs["bucketed"][2], "tokens differ"
    log("cluster (a): padded and bucketed route, place and emit the same "
        "tokens bit for bit")
    # (b) remote reads
    cluster, rep, trace, launches = _cluster_run(
        cfg, params, weights, "bucketed", access_mode="remote-read")
    _cluster_launches(cfg, _engines(cluster), "bucketed", launches)
    assert rep.remote_reads >= 1, rep.remote_reads
    assert _tokens(trace) == runs["bucketed"][2], "remote-read tokens differ"
    log(f"cluster (b) access_mode=remote-read: remote_reads="
        f"{rep.remote_reads} rebalances={rep.rebalances} launches="
        f"{ {k: v for k, v in launches.items() if v} }; tokens equal (a)'s")
    del cluster
    _free()
    # (c) the wall clock
    torch.cuda.reset_peak_memory_stats(dev)
    cluster, rep, trace, launches = _cluster_run(cfg, params, weights,
                                                 "bucketed", wall=True)
    peak = torch.cuda.max_memory_allocated(dev)
    _cluster_launches(cfg, _engines(cluster), "bucketed", launches)
    extra = cluster_summary(cluster, rep, trace)
    s = rep.summary
    per_tbt = {k: round(v * 1e3, 3)
               for k, v in extra["server_mean_tbt"].items()}
    log(f"cluster (c) wall clock, bucketed, 2 servers stepping in turn on "
        f"one card | {smi}: p50_ttft_ms={s['p50_ttft'] * 1e3:.2f} "
        f"p95_ttft_ms={s['p95_ttft'] * 1e3:.2f} "
        f"mean_tbt_ms={s['mean_tbt'] * 1e3:.3f} server_mean_tbt_ms="
        f"{per_tbt} decode_tok_s={extra['decode_tok_s']:.1f} "
        f"per_server={rep.per_server_counts} bank_max_rank="
        f"{[m['max_rank'] for m in rep.memory_profile]} rebalances="
        f"{rep.rebalances} bank_builds={extra['bank_builds']} "
        f"bank_rebuilds={extra['bank_rebuilds']} bank_ms="
        f"{[round(x, 1) for x in extra['bank_ms']]} launches="
        f"{ {k: v for k, v in launches.items() if v} } "
        f"peak_gb={peak / 1e9:.2f}")
    del cluster
    _free()
    # (d) kill a server: phase 5's fp32 2-layer model
    cfg2, params2, _, _ = _parity_setup(dev)
    weights2 = adapter_weights(cfg2, ranks, dtype=torch.float32, device=dev,
                               seed=4)
    _, _, ref, _ = _cluster_run(cfg2, params2, weights2, "bucketed")
    _, rep, trace, _ = _cluster_run(cfg2, params2, weights2, "bucketed",
                                    kill=(1.0, 0))
    assert rep.server_failures == 1 and rep.recoveries == 1, \
        (rep.server_failures, rep.recoveries)
    assert rep.redispatched >= 1, rep.redispatched
    assert _tokens(trace) == _tokens(ref), "tokens differ after the kill"
    log(f"cluster (d) fp32 2 layers, server 0 killed at 1.0 s: failures="
        f"{rep.server_failures} recoveries={rep.recoveries} redispatched="
        f"{rep.redispatched} finished={rep.completed()}/{len(trace)}; "
        f"tokens equal the fault-free run's")
    del params2
    _free()


# ---------------------------------------------------------------------------
# phase 9: the streaming HTTP gateway
# ---------------------------------------------------------------------------
GATEWAY = dict(prompt_lens=(64, 128), max_new=16, max_batch=8,
               decode_block=4, mode="bucketed")


class _Gateway:
    """``ServeGateway`` over ``cluster`` on 127.0.0.1 (an ephemeral port),
    its event loop in a thread; ``stop()`` does what SIGTERM does
    (``begin_shutdown``: finish in flight, then tear down) and returns the
    final report. A pump that died is raised again by ``stop()``."""

    def __init__(self, cluster):
        from repro_torch.server import ServeGateway
        self.gw = ServeGateway(cluster, "127.0.0.1", 0)
        self.ready = threading.Event()
        self.loop = None
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        assert self.ready.wait(120), "the gateway did not start"
        self.port = self.gw.port

    def _run(self):
        self.loop = asyncio.new_event_loop()

        async def main():
            await self.gw.start()
            self.ready.set()
            await self.gw.serve_until_stopped()

        try:
            self.loop.run_until_complete(main())
        finally:
            self.loop.close()

    def stop(self):
        self.loop.call_soon_threadsafe(self.gw.begin_shutdown)
        self.thread.join(600)
        assert not self.thread.is_alive(), "the gateway did not drain"
        self.gw._pump_task.result()
        return self.gw.final_report


def _http(port, method, path, body=None):
    """One request; (status, the JSON body or the text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    raw = resp.read()
    conn.close()
    json_body = "json" in (resp.getheader("Content-Type") or "")
    return resp.status, json.loads(raw) if json_body else raw.decode()


def _stream(port, payload, first=None):
    """``POST /v1/completions``, streamed: (status, the SSE frames up to
    ``[DONE]``, host seconds at the first token and at the last frame).
    ``first`` (an event) is set at the first token."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/completions", json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    frames, t_first, t_last = [], None, None
    while resp.status == 200:
        raw = resp.fp.readline()
        line = raw.decode().strip()
        if not raw or line == "data: [DONE]":
            break
        if line.startswith("data: "):
            frames.append(json.loads(line[6:]))
            t_last = time.monotonic()
            if frames[-1]["tokens"] and t_first is None:
                t_first = t_last
                if first is not None:
                    first.set()
    conn.close()
    return resp.status, frames, t_first, t_last


def _streamed_tokens(frames, n):
    """The tokens of a stream whose frames come in index order without
    gaps, ``n`` of them, ending with a stop."""
    toks = []
    for f in frames:
        assert f["index"] == len(toks), (f["index"], len(toks))
        toks += f["tokens"]
    assert len(toks) == n and frames[-1]["finish_reason"] == "stop", \
        (len(toks), frames[-1])
    return toks


def _readline(proc, timeout):
    ready, _, _ = select.select([proc.stdout], [], [], timeout)
    assert ready, f"no output from the launcher in {timeout} s"
    return proc.stdout.readline().strip()


def _gateway_full_width(dev, cfg, params, smi):
    """Phase 9 (a): 2 servers, bf16, 32 layers, over the gateway."""
    from repro_torch.launch.serve import (adapter_weights, cluster_adapters,
                                          make_cluster, print_cost_drift)
    from repro_torch.obs import (REQUEST_PHASES, FlightRecorder, Tracer,
                                 WallClock, write_perfetto)
    g = GATEWAY
    adapters = cluster_adapters(8)
    weights = adapter_weights(cfg, {a.adapter_id: a.rank for a in adapters},
                              dtype=torch.bfloat16, device=dev, seed=3)
    ids = ["hot-r64"] + [a.adapter_id for a in adapters]
    busy = ids[4]
    rng = random.Random(9)
    prompts = [[rng.randrange(1, cfg.vocab_size)
                for _ in range(g["prompt_lens"][i % 2])] for i in range(8)]
    with tempfile.TemporaryDirectory() as tmp:
        tracer = Tracer(clock=WallClock())
        recorder = FlightRecorder(out_dir=tmp)
        torch.cuda.reset_peak_memory_stats(dev)
        cluster = make_cluster(
            cfg, params, adapters, weights, 2,
            max_len=max(g["prompt_lens"]) + g["max_new"] + 8,
            max_batch=g["max_batch"], bank_mode=g["mode"],
            decode_block=g["decode_block"], rebalance_period=1e9,
            tracer=tracer, flight_recorder=recorder, device=dev)
        wrappers = _wrappers()
        for k in wrappers.values():
            k.launches = 0
        gw = _Gateway(cluster)
        status, health = _http(gw.port, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok", (status, health)
        status, created = _http(gw.port, "POST", "/v1/adapters",
                                {"adapter_id": "hot-r64", "rank": 64})
        assert status == 201, (status, created)
        results, firsts = [None] * 8, [threading.Event() for _ in range(8)]

        def client(i):
            results[i] = _stream(gw.port, {
                "adapter_id": ids[i], "prompt": prompts[i],
                "max_tokens": g["max_new"]}, firsts[i])

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        assert firsts[4].wait(600), f"{busy}'s stream never started"
        status, body = _http(gw.port, "DELETE", f"/v1/adapters/{busy}")
        assert status == 202 and body["draining"], (status, body)
        in_flight = results[4] is None
        for t in threads:
            t.join(600)
            assert not t.is_alive(), "a stream did not end"
        status, metrics = _http(gw.port, "GET", "/metrics")
        assert status == 200 and "repro_ttft_seconds_bucket" in metrics
        engines = _engines(cluster)
        report = gw.stop()
        torch.cuda.synchronize()
        launches = {kid: k.launches for kid, k in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        passes, groups = _cluster_launches(cfg, engines, g["mode"], launches)
        for status, frames, _, _ in results:
            assert status == 200, status
            _streamed_tokens(frames, g["max_new"])
        assert report.completed() == 8 and report.timed_out == 0, \
            (report.completed(), report.timed_out)
        assert report.registered == 1 and report.unregistered == 1
        trees = 0
        for rid, spans in tracer.by_request().items():
            root = [s for s in spans if s.name == "request"]
            if not root:
                continue
            trees += 1
            kids = {s.name: s for s in spans
                    if s.parent_id == root[0].span_id}
            assert set(kids) == set(REQUEST_PHASES), (rid, sorted(kids))
            total = sum(kids[p].duration for p in REQUEST_PHASES)
            assert abs(total - root[0].duration) <= 0.01 * \
                root[0].duration, (rid, total, root[0].duration)
        assert trees == 8, trees
        path = Path(tmp) / "gateway.perfetto.json"
        n = write_perfetto(tracer, str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        assert n == tracer.n_spans and len(events) > n
        t_first = min(r[2] for r in results)
        t_last = max(r[3] for r in results)
        tok_s = 8 * (g["max_new"] - 1) / (t_last - t_first)
        s = report.summary
        log(f"gateway (a) llama-7b-paper {cfg.n_layers} layers bf16, 2 "
            f"servers, {g['mode']}, decode_block {g['decode_block']}, 8 SSE "
            f"streams over 9 adapters (hot-r64 registered over HTTP, {busy} "
            f"deleted with its stream in flight: {in_flight}) | {smi}: "
            f"p50_ttft_ms={report.p50_ttft() * 1e3:.2f} "
            f"p95_ttft_ms={report.p95_ttft() * 1e3:.2f} "
            f"mean_tbt_ms={s['mean_tbt'] * 1e3:.3f} "
            f"decode_tok_s={tok_s:.1f} (client clock) spans={tracer.n_spans} "
            f"request_trees={trees} model_passes={passes} "
            f"prefill_groups={groups} launches="
            f"{ {k: v for k, v in launches.items() if v} } "
            f"per_server={report.per_server_counts} "
            f"peak_gb={peak / 1e9:.2f} perfetto_events={len(events)}")
        print_cost_drift(report)
        sys.stdout.flush()
        del cluster, engines, gw
    _free()
    return launches


def _gateway_fp32_parity(dev):
    """Phase 9 (b): phase 5's fp32 2-layer model; requests one after
    another over the gateway (one adapter registered over HTTP) against
    the same requests through the facade's ``run``, each alone in its
    batch."""
    from repro_torch.core import AdapterInfo, ServeRequest
    from repro_torch.launch.serve import (adapter_weights, cluster_adapters,
                                          make_cluster)
    g = GATEWAY
    cfg, params, _, _ = _parity_setup(dev)
    adapters = cluster_adapters(8)
    ranks = {a.adapter_id: a.rank for a in adapters}
    weights = adapter_weights(cfg, ranks, dtype=torch.float32, device=dev,
                              seed=4)
    hot = AdapterInfo("hot-r64", 64, nbytes=64 * 2_000_000)
    picks = [("hot-r64", 64), ("ad0-r8", 8), ("ad3-r64", 64),
             ("ad4-r128", 128)]
    rng = random.Random(10)
    prompts = [[rng.randrange(1, cfg.vocab_size)
                for _ in range(g["prompt_lens"][i % 2])] for i in range(4)]

    def cluster_of(ads):
        return make_cluster(
            cfg, params, ads, weights, 2,
            max_len=max(g["prompt_lens"]) + g["max_new"] + 8,
            max_batch=g["max_batch"], bank_mode=g["mode"],
            decode_block=g["decode_block"], rebalance_period=1e9,
            device=dev)

    trace = [ServeRequest(req_id=i, adapter_id=aid, rank=r,
                          prompt_len=len(p), output_len=g["max_new"],
                          prompt=list(p), arrival=0.5 * i)
             for i, ((aid, r), p) in enumerate(zip(picks, prompts))]
    rep = cluster_of(adapters + [hot]).run(trace)
    assert rep.completed() == len(trace), rep.completed()
    for a, b in zip(trace, trace[1:]):
        assert a.finish <= b.arrival, "a request was not alone in its batch"
    want = [list(r.output) for r in trace]
    _free()
    gw = _Gateway(cluster_of(adapters))
    status, _ = _http(gw.port, "POST", "/v1/adapters",
                      {"adapter_id": "hot-r64", "rank": 64})
    assert status == 201, status
    got = []
    for (aid, _), p in zip(picks, prompts):
        status, frames, _, _ = _stream(gw.port, {
            "adapter_id": aid, "prompt": p, "max_tokens": g["max_new"]})
        assert status == 200, status
        got.append(_streamed_tokens(frames, g["max_new"]))
    report = gw.stop()
    assert report.completed() == len(picks) and report.registered == 1
    assert got == want, (got, want)
    log(f"gateway (b) fp32 {cfg.n_layers} layers, 4 requests one after "
        f"another over the gateway (hot-r64 registered over HTTP): SSE "
        f"tokens equal the facade's run bit for bit; first {got[0]}")
    del params, gw
    _free()


def _gateway_launcher(args):
    """Phase 9 (c): ``python -m <args>`` (a gateway launcher; the card by
    default) streams one request and drains on SIGTERM with exit code 0
    and ``gateway drained OK`` last. Returns its output."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", *args], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = _readline(proc, 300)
        assert line.startswith("listening on "), line
        up = time.monotonic() - t0
        status, frames, _, _ = _stream(int(line.rsplit(":", 1)[1]), {
            "adapter_id": "ad0-r8", "prompt_len": 8, "max_tokens": 4})
        assert status == 200, status
        toks = _streamed_tokens(frames, 4)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (proc.returncode, out)
    lines = out.strip().splitlines()
    assert lines[-1] == "gateway drained OK", out
    log(f"gateway (c) python -m {' '.join(args)}: listening after "
        f"{up:.1f}s, streamed {toks}, exit 0 on SIGTERM; it printed: "
        f"{' | '.join(lines)}")
    return out


def phase_gateway(dev, cfg, params, smi):
    """Phase 9 on phase 2's bf16 ``params``: (a) full width, (b) fp32
    parity with the facade, (c) the launchers: ``launch.server``, and
    ``launch.serve --serve`` writing its span trace. Returns (a)'s
    launches."""
    launches = _gateway_full_width(dev, cfg, params, smi)
    _gateway_fp32_parity(dev)
    _gateway_launcher(["repro_torch.launch.server", "--backend", "engine",
                       "--config", "full", "--port", "0"])
    with tempfile.TemporaryDirectory() as tmp:
        trace = Path(tmp) / "spans.jsonl"
        out = _gateway_launcher([
            "repro_torch.launch.serve", "--serve", "127.0.0.1:0",
            "--config", "full", "--trace-out", str(trace)])
        names = {json.loads(x)["name"]
                 for x in trace.read_text().splitlines()}
        assert {"request", "gateway.receive", "prefill", "decode"} <= names
        assert "costmodel[decode]" in out, out
    return launches


# ---------------------------------------------------------------------------
# phase 10: the MoE family
# ---------------------------------------------------------------------------
DEEPSEEK = "deepseek-v2-lite-16b"
LLAMA4 = "llama4-scout-17b-a16e"
LLAMA4_LAYERS = 8                     # 48 layers need 215 GB in bf16
# the cluster launchers' trace (phases 10, 11, 12, 14): 4 requests arriving
# over 1 s, 4 new tokens each (the launcher's defaults: 8, 6 s, 16)
LAUNCHER_TRACE = ["--requests", "4", "--duration", "1", "--max-new", "4"]
STABLELM = "stablelm-1.6b"


def _moe_engine_runs(dev, cfg, params, trace, weights, runs, smi, rec,
                     tag="moe"):
    """Serve ``trace`` once per (bank mode, decode_block) in ``runs``,
    every count at 0 just before each run and read just after; every run
    emits the same tokens and launches what ``_path_launches`` says.
    ``tag`` begins each log line. Returns (the summed launches, each
    mode's last engine)."""
    from repro_torch.launch.serve import serve
    wrappers = _wrappers()
    total = {kid: 0 for kid in KERNELS}
    outputs, engines = {}, {}
    for mode, db in runs:
        for k in wrappers.values():
            k.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        with rec:
            eng, reqs, s = serve(cfg, params, trace, weights=weights,
                                 bank_mode=mode, lora_kernel="sgmv",
                                 decode_block=db, max_batch=8, device=dev)
            torch.cuda.synchronize()
        grew = {kid: k.launches for kid, k in wrappers.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        want = _path_launches(cfg, mode, eng.prefill_dispatches
                              + eng.decode_iterations, eng.prefill_dispatches)
        assert all(len(r.output) == 16 for r in reqs), \
            [len(r.output) for r in reqs]
        assert all(0 <= t < cfg.vocab_size for r in reqs for t in r.output)
        assert grew == want, (cfg.name, mode, db, grew, want)
        for kid, n in grew.items():
            total[kid] += n
        outputs[(mode, db)] = [r.output for r in reqs]
        engines[mode] = eng
        log(f"{tag} engine {cfg.name} layers={cfg.n_layers} mode={mode} "
            f"decode_block={db} | {smi}: finished={s['finished']}/"
            f"{len(trace)} prefill_groups={eng.prefill_dispatches} "
            f"decode_steps={eng.decode_iterations} decode_dispatches="
            f"{eng.decode_dispatches} launches "
            f"{ {k: v for k, v in grew.items() if v} }"
            f" p50_ttft_ms={s['p50_ttft'] * 1e3:.2f}"
            f" p95_ttft_ms={s['p95_ttft'] * 1e3:.2f}"
            f" mean_tbt_ms={s['mean_tbt'] * 1e3:.3f}"
            f" decode_tok_s={s['decode_tok_s']:.1f}"
            f" wall_s={s['wall_s']:.3f} peak_gb={peak / 1e9:.2f}")
    first = next(iter(outputs.values()))
    for key, out in outputs.items():
        assert out == first, f"{cfg.name}: tokens of {key} differ"
    log(f"{tag} engine {cfg.name}: {len(outputs)} runs ({sorted(outputs)}) "
        f"emit the same tokens; padded == bucketed bit for bit; first "
        f"request {first[0]}")
    return total, engines


def _init_model(cfg, dev, tag="moe"):
    from repro_torch.models import model as M
    t0 = time.monotonic()
    params = M.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    n_par = sum(p.numel() for p in params.parameters())
    par_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"{tag} init {cfg.name}: {cfg.n_layers} layers d={cfg.d_model} "
        f"params={n_par} ({par_bytes / 1e9:.2f} GB, bf16, a router fp32) "
        f"in {time.monotonic() - t0:.1f}s")
    return params


def _lora_widths(cfg):
    """(d, d_out) of every LoRA call of a model pass: each target's own
    widths (MLA calls q, k and o)."""
    from repro_torch.lora.adapter import _target_in_dim, _target_out_dim
    return sorted({(_target_in_dim(cfg, t), _target_out_dim(cfg, t))
                   for t in cfg.lora.targets
                   if cfg.mla is None or t != "v"})


class Routing:
    """Stands in for ``models.ffn.moe_topk`` while entered. Recording, it
    keeps every call's expert ids (N, K) in call order; replaying ``ids``
    (an earlier recording of the same model on the same tokens), each
    call takes the recorded experts in place of its own top k and weighs
    them by its own probabilities, renormalised: a run in another type
    then routes every token as the recorded run did, and the two differ
    by their arithmetic alone."""

    def __init__(self, ids=None):
        from repro_torch.models import ffn
        self.ffn, self.replay, self.ids = ffn, ids, []

    def __enter__(self):
        self.orig = self.ffn.moe_topk

        def topk(cfg, router, xf):
            probs, topw, topi = self.orig(cfg, router, xf)
            if self.replay is not None:
                topi = self.replay[len(self.ids)]
                topw = probs.gather(-1, topi)
                topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
            self.ids.append(topi)
            return probs, topw, topi
        self.ffn.moe_topk = topk
        return self

    def __exit__(self, *exc):
        self.ffn.moe_topk = self.orig


def _routing_flips(a, b):
    """Tokens whose expert set differs between two recordings, over all
    layers, and the decisions (token x layer) in all."""
    flips = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
                for x, y in zip(a, b))
    return flips, sum(x.shape[0] for x in a)


def _moe_kernel_checks(dev, model, calls, results):
    """Phase 10 (b)/(c): every B1 and B2 call the path recorded, at each
    width and layout, against its plain version (bf16 and fp32), timed,
    bounded, with its gathered-bmm yardstick; B3a/B3b on B1's calls, the
    same; on the dispatcher calls, the unfused pair == B1 and B2 at the
    plan == the host loop == B1 on the zero-padded bank, bit for bit."""
    from repro_torch.kernels import ops, sgmv
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for key in sorted(k for k in calls if k[0] in ("sgmv_fused_blocks",
                                                   "sgmv_multibank_blocks")):
        name, layout, d, d_out = key
        args, kw, dest = calls[key]
        kid = "B1" if name == "sgmv_fused_blocks" else "B2"
        label = f"{model}-{layout}-d{d}-o{d_out}"
        _check_and_time(kid, label, args, kw, dest, flush, results)
        _yardstick(kid, label, args, kw, dest, flush)
        if kid == "B1":
            x_pad, A, B, ba = args
            h = sgmv.sgmv_shrink_blocks_ref(x_pad, A, ba, **kw)
            for sub, sargs, skw in (
                    ("B3a", (x_pad, A, ba), kw),
                    ("B3b", (h, B, ba), {"block_t": _block_t(kw)})):
                _check_and_time(sub, label, sargs, skw, dest, flush, results)
                _yardstick(sub, label, sargs, skw, dest, flush)
    del flush
    for key in sorted(k for k in calls if k[0] in ("sgmv_fused",
                                                   "sgmv_bucketed_fused")):
        name, layout, d, d_out = key
        args, kw, _ = calls[key]
        label = f"{model}-{layout}-d{d}-o{d_out}"
        if name == "sgmv_bucketed_fused":
            _bucketed_identities(label, args, kw)
            continue
        for dtype in (torch.bfloat16, torch.float32):
            cargs = _cast(args, dtype)
            assert torch.equal(ops.sgmv_fused(*cargs, **kw),
                               ops.sgmv(*cargs, **kw)), (label, dtype)
        log(f"unfused: {label} sgmv_fused call x={tuple(args[0].shape)}: "
            "B3a then B3b == B1 bit for bit, bf16 and fp32")


def _widths_seen(calls, name):
    return sorted({k[2:] for k in calls if k[0] == name})


def _moe_deepseek(dev, smi, results):
    """Phase 10 (a) and (b): deepseek-v2-lite-16b at full width and depth."""
    from repro_torch.configs import get_config
    cfg = get_config(DEEPSEEK)
    params = _init_model(cfg, dev)
    trace, ranks, weights = _serve_trace(cfg, 8, dev)
    rec = MainPathCalls(widths=True)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [(m, db) for m in ("padded", "bucketed") for db in (1, 4)], smi, rec)
    # d 2048; d_out 3072 (q), 576 (k: kv_lora_rank + rope), 2048 (o)
    seen = _widths_seen(rec.calls, "sgmv_fused_blocks")
    assert seen == _lora_widths(cfg), seen
    assert seen == _widths_seen(rec.calls, "sgmv_multibank_blocks")
    # the first prefill group's bf16 logits: both banks bit for bit, and
    # against fp32 on the same weights. A router whose k-th and (k+1)-th
    # experts lie within bf16's rounding of each other picks differently
    # in the two types, and one token's changed expert moves the rest;
    # so the fp32 run that is held within phase 6's 5e-2 of the largest
    # logit takes the bf16 run's experts (``Routing``), and the free fp32
    # run's distance is printed beside the count of changed choices.
    with Routing() as bf16_routes:
        lg = _group_logits(cfg, engines["padded"], trace, 64)
    assert torch.equal(lg, _group_logits(cfg, engines["bucketed"], trace,
                                         64))
    del engines
    _free()
    eng = _fp32_engine(cfg, params, ranks, weights, 72)
    with Routing() as fp32_routes:
        free = _group_logits(cfg, eng, trace, 64, kernel="einsum")
    with Routing(bf16_routes.ids):
        ref = _group_logits(cfg, eng, trace, 64, kernel="einsum")
    del eng, params
    _free()
    flips, decisions = _routing_flips(bf16_routes.ids, fp32_routes.ids)
    scale = ref.abs().max().item()
    err = (lg - ref).abs().max().item()
    err_free = (lg - free).abs().max().item()
    log(f"moe logits {cfg.name} first prefill group (4 x 64): padded == "
        f"bucketed bit for bit; bf16 vs fp32 on the same weights and the "
        f"same experts: max abs diff {err:.4e} of max |logit| {scale:.4f} "
        f"({err / scale:.3%}; tol 5e-2 of it), argmax agree "
        f"{(lg.argmax(-1) == ref.argmax(-1)).tolist()}; fp32 "
        f"routing on its own: {flips} of {decisions} token-layer expert "
        f"choices differ from bf16's, max abs diff {err_free:.4e} "
        f"({err_free / scale:.3%}), argmax agree "
        f"{(lg.argmax(-1) == free.argmax(-1)).tolist()}")
    assert torch.isfinite(ref).all() and torch.isfinite(free).all()
    assert err <= 5e-2 * scale, (err, scale)
    _moe_kernel_checks(dev, "deepseek", rec.calls, results)
    return launches


def _moe_llama4(dev, smi, results):
    """Phase 10 (c): llama4-scout at full width and 8 layers, 4 requests,
    padded and bucketed; B1/B2 (and B3a/B3b) at d 5120, d_out 5120 and
    1024."""
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(LLAMA4), n_layers=LLAMA4_LAYERS)
    params = _init_model(cfg, dev)
    trace, _, weights = _serve_trace(cfg, 4, dev)
    rec = MainPathCalls(widths=True)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [("padded", 4), ("bucketed", 4)], smi, rec)
    del engines, params
    _free()
    # d 5120; d_out 5120 (q, o), 1024 (k, v: 8 kv heads of 128)
    seen = _widths_seen(rec.calls, "sgmv_fused_blocks")
    assert seen == _lora_widths(cfg), seen
    assert seen == _widths_seen(rec.calls, "sgmv_multibank_blocks")
    _moe_kernel_checks(dev, "llama4", rec.calls, results)
    return launches


def _moe_launcher(arch=DEEPSEEK, tag="moe"):
    """Phase 10 (d), 11 (d), 12 (d): the serve launcher at ``arch``'s full
    width and depth with 2 servers, as a subprocess, on a short trace
    (``LAUNCHER_TRACE``): exit 0, ``cluster drained OK``."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    args = ["repro_torch.launch.serve", "--arch", arch, "--config",
            "full", "--servers", "2", "--bank-mode", "bucketed",
            "--decode-block", "4", *LAUNCHER_TRACE]
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, (proc.returncode, proc.stdout,
                                  proc.stderr[-4000:])
    assert lines and lines[-1] == "cluster drained OK", proc.stdout
    log(f"{tag} launcher python -m {' '.join(args)}: exit 0 in "
        f"{time.monotonic() - t0:.1f}s; it printed: {' | '.join(lines)}")


def _stablelm(dev, smi, results):
    """Phase 10 (e): stablelm-1.6b at full width and depth, 4 requests,
    padded and bucketed: its MHA prefill runs B5 at head dim 64, held
    against ``flash_mha_plain`` and timed beside
    ``scaled_dot_product_attention`` on the 1000-token group's call."""
    from repro_torch.configs import get_config
    cfg = get_config(STABLELM)
    hd = cfg.resolved_head_dim
    params = _init_model(cfg, dev)
    trace, _, weights = _serve_trace(cfg, 4, dev)
    rec = MainPathCalls(widths=True)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [("padded", 4), ("bucketed", 4)], smi, rec)
    del engines, params
    _free()
    args, kw, _ = rec.calls[("flash_mha", "prefill", hd)]
    assert tuple(args[0].shape) == (1, cfg.n_heads, 1000, hd), \
        args[0].shape
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    _check_and_time("B5", f"stablelm-prefill-hd{hd}", args, kw, None,
                    flush, results)
    del flush
    return launches


def phase_moe(dev, smi):
    """Phase 10. Returns (the launches of its main-path runs, the
    kernels' results at the new widths)."""
    results, launches = {}, {kid: 0 for kid in KERNELS}
    for part in (_moe_deepseek, _moe_llama4):
        t0 = time.monotonic()
        for kid, n in part(dev, smi, results).items():
            launches[kid] += n
        _free()
        log(f"phase moe {part.__name__}: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    _moe_launcher()
    log(f"phase moe launcher: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    for kid, n in _stablelm(dev, smi, results).items():
        launches[kid] += n
    _free()
    log(f"phase moe stablelm: {time.monotonic() - t0:.1f}s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 11: the recurrent families, the page pool and merge_adapter
# ---------------------------------------------------------------------------
ZAMBA2 = "zamba2-7b"
RWKV6 = "rwkv6-7b"
# phase 11's depths, full width: zamba2 4 of its 14 shared-block
# applications (6 Mamba2 layers each) and 2 for the pooled servers, rwkv6
# 8 of 32 layers (a full-depth run is the launcher's, phase 11 (d))
RECURRENT_LAYERS = {ZAMBA2: 24, RWKV6: 8}
POOL_LAYERS = 12


class LayerReplay:
    """Stands in for the layer functions of ``models.model`` while entered
    (``_dense_block_full``, ``_mamba_layer``, ``_rwkv_block``: each takes
    the hidden state as its third argument and returns the new one
    first). Recording, it keeps every call's input and output in call
    order; replaying ``rec`` (an earlier recording of the same model on
    the same tokens), each call takes the recorded input, cast to its own
    type, in place of its own: a run in another type then computes every
    layer on the recorded run's inputs, and the two runs differ by each
    layer's own arithmetic, not by what the stack made of the earlier
    layers' rounding."""

    NAMES = ("_dense_block_full", "_mamba_layer", "_rwkv_block")

    def __init__(self, rec=None):
        from repro_torch.models import model
        self.model, self.rec, self.inputs, self.outputs = model, rec, [], []

    def __enter__(self):
        self.orig = {n: getattr(self.model, n) for n in self.NAMES}
        for name, fn in self.orig.items():
            setattr(self.model, name, self._wrap(fn))
        return self

    def _wrap(self, fn):
        def call(cfg, bp, x, *args, **kw):
            if self.rec is not None:
                x = self.rec.inputs[len(self.inputs)].to(x.dtype)
            self.inputs.append(x.detach().clone())
            out = fn(cfg, bp, x, *args, **kw)
            self.outputs.append(out[0].detach().clone())
            return out
        return call

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.model, name, fn)


class Perturbed:
    """Stands in for ``models.model._embed`` while entered: the embedded
    input times (1 + ``eps`` * N(0, 1)), the noise from a fixed seed."""

    def __init__(self, eps):
        from repro_torch.models import model
        self.model, self.eps = model, eps

    def __enter__(self):
        self.orig = self.model._embed

        def embed(cfg, params, tokens, tp=None):
            x = self.orig(cfg, params, tokens, tp)
            g = torch.Generator(device=x.device).manual_seed(1)
            return x * (1 + self.eps * torch.randn(
                x.shape, generator=g, device=x.device, dtype=x.dtype))
        self.model._embed = embed
        return self

    def __exit__(self, *exc):
        self.model._embed = self.orig


def _layer_errors(a, b):
    """max |a_i - b_i| / max |b_i| over the recorded layers' outputs."""
    return [((x.float() - y.float()).abs().max() / y.float().abs().max()
             ).item() for x, y in zip(a.outputs, b.outputs)]


def _recurrent(dev, smi, results, arch):
    """Phase 11 (a) zamba2-7b or (b) rwkv6-7b at full width and depth on
    phase 2's trace, padded and bucketed, decode blocks 1 and 4: the same
    tokens and the path's launches in every run, the first prefill group's
    bf16 logits padded == bucketed bit for bit and within 5e-2 of the
    largest logit of an fp32 einsum run on the same weights. (c) Every B1
    and B2 call the runs recorded, against plain, timed, with B3a/B3b on
    B1's and the bit identities (``_moe_kernel_checks``); at zamba2, B5 at
    head dim 112 on the 2 x 1000 group's call. Returns the launches."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import n_attn_applications
    cfg = dataclasses.replace(get_config(arch),
                              n_layers=RECURRENT_LAYERS[arch])
    params = _init_model(cfg, dev, tag="recurrent")
    trace, ranks, weights = _serve_trace(cfg, 8, dev)
    rec = MainPathCalls(widths=True)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [(m, db) for m in ("padded", "bucketed") for db in (1, 4)], smi, rec,
        tag="recurrent")
    # zamba2: d = d_out = 3584 on the shared block; rwkv6: 4096
    seen = _widths_seen(rec.calls, "sgmv_fused_blocks")
    assert seen == _lora_widths(cfg), seen
    assert seen == _widths_seen(rec.calls, "sgmv_multibank_blocks")
    # the first prefill group's bf16 logits: both banks bit for bit, and
    # against fp32 on the same weights. These stacks amplify a rounding
    # (at random init an input moved by one bf16 ulp moves rwkv6's logits
    # ~2%, ROADMAP C13), and the reference rounds its activations to bf16
    # at every op; so the fp32 run held within phase 6's 5e-2 computes
    # every layer on the bf16 run's own input (``LayerReplay``), each
    # layer's output and the logits are held, and the free fp32 run's
    # distance is printed beside them.
    with LayerReplay() as bf16_layers:
        lg = _group_logits(cfg, engines["padded"], trace, 64)
    assert torch.equal(lg, _group_logits(cfg, engines["bucketed"], trace,
                                         64))
    del engines
    _free()
    eng = _fp32_engine(cfg, params, ranks, weights, 72)
    free = _group_logits(cfg, eng, trace, 64, kernel="einsum")
    with LayerReplay(bf16_layers) as fp32_layers:
        ref = _group_logits(cfg, eng, trace, 64, kernel="einsum")
    with Perturbed(2.0 ** -9):
        moved = _group_logits(cfg, eng, trace, 64, kernel="einsum")
    del eng, params
    _free()
    layer_err = _layer_errors(bf16_layers, fp32_layers)
    del bf16_layers, fp32_layers
    scale = ref.abs().max().item()
    err = (lg - ref).abs().max().item()
    err_free = (lg - free).abs().max().item()
    worst = max(range(len(layer_err)), key=layer_err.__getitem__)
    err_moved = (moved - free).abs().max().item()
    log(f"recurrent sensitivity {cfg.name}: the fp32 run with its embedded "
        f"input moved by 2^-9 relative (one bf16 rounding) moves its logits "
        f"by {err_moved:.4e} ({err_moved / scale:.3%} of max |logit|)")
    log(f"recurrent logits {cfg.name} first prefill group (4 x 64): padded "
        f"== bucketed bit for bit; bf16 vs fp32 on the same weights, every "
        f"layer on the bf16 run's input: max abs diff {err:.4e} of max "
        f"|logit| {scale:.4f} ({err / scale:.3%}; tol 5e-2 of it), argmax "
        f"agree {(lg.argmax(-1) == ref.argmax(-1)).tolist()}; {len(layer_err)} "
        f"layer outputs, worst {layer_err[worst]:.3%} of its max (layer call "
        f"{worst}), median {statistics.median(layer_err):.3%}; fp32 running "
        f"free: max abs diff {err_free:.4e} ({err_free / scale:.3%}), argmax "
        f"agree {(lg.argmax(-1) == free.argmax(-1)).tolist()}")
    assert torch.isfinite(ref).all() and torch.isfinite(free).all()
    assert max(layer_err) <= 5e-2, layer_err
    assert err <= 5e-2 * scale, (err, scale)
    model = arch.split("-")[0]
    _moe_kernel_checks(dev, model, rec.calls, results)
    if n_attn_applications(cfg):
        hd = cfg.resolved_head_dim
        args, kw, _ = rec.calls[("flash_mha", "prefill", hd)]
        assert tuple(args[0].shape) == (2, cfg.n_heads, 1000, hd), \
            args[0].shape
        flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
        _check_and_time("B5", f"{model}-prefill-hd{hd}", args, kw, None,
                        flush, results)
        del flush
    return launches


def _recurrent_pool(dev, smi):
    """Phase 11 (d): ``LoRAServeCluster`` over an ``EngineBackend`` of 2
    zamba2-7b engines with a ``UnifiedPagePool`` each (phase 8's
    virtual-clock drive, bucketed): the tokens equal the same drive without
    pools, every pool's invariant holds after the drain, its pages by kind
    printed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import adapter_weights, cluster_adapters
    from repro_torch.serving import UnifiedPagePool
    cfg = dataclasses.replace(get_config(ZAMBA2), n_layers=POOL_LAYERS)
    params = _init_model(cfg, dev, tag="pool")
    ranks = {a.adapter_id: a.rank for a in cluster_adapters(8)}
    weights = adapter_weights(cfg, ranks, dtype=torch.bfloat16, device=dev,
                              seed=3)
    tokens = {}
    for pooled in (False, True):
        factory = (lambda: UnifiedPagePool(n_pages=4096)) if pooled else None
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.monotonic()
        cluster, rep, trace, launches = _cluster_run(
            cfg, params, weights, "bucketed", page_pool_factory=factory)
        engines = _engines(cluster)
        passes, groups = _cluster_launches(cfg, engines, "bucketed",
                                           launches)
        tokens[pooled] = _tokens(trace)
        pools = [e.page_pool for e in engines]
        if pooled:
            assert len({id(p) for p in pools}) == len(engines) == 2
            for sid, pool in enumerate(pools):
                assert pool.check_invariant(), sid
                kinds = pool.pages_by_kind()
                assert kinds["kv"] == 0 and kinds["adapter"] > 0, kinds
                log(f"pool server {sid}: pages_by_kind={kinds} used="
                    f"{pool.used_pages}/{pool.n_pages} page_bytes="
                    f"{pool.page_bytes} page_tokens={pool.page_tokens} "
                    f"adapter_page_ins={pool.adapter_page_ins} "
                    f"evictions={pool.adapter_evictions} invariant OK")
        else:
            assert pools == [None, None]
        s = rep.summary
        log(f"pool cluster {cfg.name} pooled={pooled} | {smi}: finished="
            f"{rep.completed()}/{len(trace)} rebalances={rep.rebalances} "
            f"model_passes={passes} prefill_groups={groups} launches "
            f"{ {k: v for k, v in launches.items() if v} } p50_ttft_ms="
            f"{s['p50_ttft'] * 1e3:.2f} p95_ttft_ms="
            f"{s['p95_ttft'] * 1e3:.2f} mean_tbt_ms="
            f"{s['mean_tbt'] * 1e3:.3f} wall_s={time.monotonic() - t0:.3f} "
            f"peak_gb={torch.cuda.max_memory_allocated(dev) / 1e9:.2f}")
        del cluster, engines, pools
        _free()
    assert tokens[True] == tokens[False]
    log("pool: the pooled drive's tokens equal the drive without pools")
    del params
    _free()


def _recurrent_launcher(dev, smi):
    """Phase 11 (d): ``launch.serve --arch rwkv6-7b --config full
    --servers 2`` as a subprocess."""
    _moe_launcher(RWKV6, tag="recurrent")


def _merged(dev, smi):
    """Phase 11 (e): stablelm-1.6b at full width, one adapter of phase 2's
    trace merged into the bf16 weights (``lora.adapter.merge_adapter``);
    the first group's logits against the SGMV path (B1) on a bank that
    holds that adapter alone, within 5e-2 of the largest logit."""
    from repro_torch.configs import get_config
    from repro_torch.lora import build_bank, merge_adapter
    from repro_torch.models import model as M
    cfg = get_config(STABLELM)
    params = _init_model(cfg, dev, tag="merge")
    trace, ranks, weights = _serve_trace(cfg, 4, dev)
    group = [(aid, p) for aid, p, _ in trace if len(p) == 64]
    aid = group[0][0]
    toks = torch.tensor([p for _, p in group], device=dev)
    bank = build_bank(cfg, {aid: ranks[aid]}, 0, dtype=torch.bfloat16,
                      device=dev)
    bank.set_adapter(aid, weights[aid])
    rows = torch.zeros(len(group), dtype=torch.int32, device=dev)
    lora, _ = M.prefill(cfg, params, toks, bank=bank.data,
                        lora_idx=bank.lora_idx(rows), lora_kernel="sgmv")
    base, _ = M.prefill(cfg, params, toks)
    t0 = time.monotonic()
    merged = merge_adapter(params, weights[aid], cfg)
    torch.cuda.synchronize()
    merge_s = time.monotonic() - t0
    lm, _ = M.prefill(cfg, merged, toks)
    shared = sum(a is b for a, b in zip(merged.parameters(),
                                        params.parameters()))
    del merged, params, bank
    _free()
    lora, lm, base = lora.float().cpu(), lm.float().cpu(), base.float().cpu()
    assert torch.isfinite(lm).all()
    scale = lora.abs().max().item()
    err = (lm - lora).abs().max().item()
    moved = (base - lora).abs().max().item()
    log(f"merge {cfg.name} adapter {aid} (rank {ranks[aid]}) merged in "
        f"{merge_s:.3f}s, {shared} parameters shared with the input | "
        f"{smi}: first group ({len(group)} x 64) logits vs the SGMV path on "
        f"a bank of that adapter alone: max abs diff {err:.4e} of max "
        f"|logit| {scale:.4f} ({err / scale:.3%}; tol 5e-2 of it); the "
        f"adapter moves them by {moved:.4e}; argmax agree "
        f"{(lm.argmax(-1) == lora.argmax(-1)).tolist()}")
    assert err <= 5e-2 * scale, (err, scale)
    assert moved > err, (moved, err)


def phase_recurrent(dev, smi):
    """Phase 11. Returns (the launches of its main-path runs, the kernels'
    results at the new widths)."""
    results, launches = {}, {kid: 0 for kid in KERNELS}
    for arch in (ZAMBA2, RWKV6):
        t0 = time.monotonic()
        for kid, n in _recurrent(dev, smi, results, arch).items():
            launches[kid] += n
        _free()
        log(f"phase recurrent {arch}: {time.monotonic() - t0:.1f}s")
    for part in (_recurrent_pool, _recurrent_launcher, _merged):
        t0 = time.monotonic()
        part(dev, smi)
        _free()
        log(f"phase recurrent {part.__name__}: "
            f"{time.monotonic() - t0:.1f}s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 12: the encoder-decoder and VLM families
# ---------------------------------------------------------------------------
SEAMLESS = "seamless-m4t-large-v2"
VISION = "llama-3.2-vision-90b"
VISION_LAYERS = 10                    # two periods; 100 layers need 175 GB
DECODE_STEPS = 3                      # (b)'s decode steps after its prefill


class FlashCalls:
    """While entered (after ``inner``, a ``MainPathCalls``, when given),
    keeps a copy of the arguments of the first B5 call of each (causal,
    batch, Sq, Sk) that ``models.attention`` makes: the audio family's
    decoder (causal), encoder and cross-attention calls apart."""

    def __init__(self, inner=None):
        from repro_torch.models import attention
        self.attention, self.inner, self.calls = attention, inner, {}

    def __enter__(self):
        if self.inner is not None:
            self.inner.__enter__()
        self.orig = self.attention.flash_mha

        def call(q, k, v, **kw):
            key = (kw.get("causal", True), q.shape[0], q.shape[2], k.shape[2])
            if key not in self.calls:
                self.calls[key] = (_copy((q, k, v)), dict(kw))
            return self.orig(q, k, v, **kw)
        self.attention.flash_mha = call
        return self

    def __exit__(self, *exc):
        self.attention.flash_mha = self.orig
        if self.inner is not None:
            self.inner.__exit__(*exc)


def _frontend_run(cfg, eng, trace, S, frontend, kernel="sgmv", tokens=None):
    """The model-level run of phase 12 (b): the trace's group of ``S``-token
    prompts prefilled through ``eng``'s model and bank with ``frontend``,
    then DECODE_STEPS decode steps, each on ``tokens[i]`` (the run's own
    argmax when None; the adapters take no part in decode, ROADMAP C3).
    Returns (fp32 logits on the host of the prefill and of each step, the
    tokens decoded)."""
    from repro_torch.models import model as M
    toks, idx = _group(eng, trace, S)
    lg, cache = M.prefill(cfg, eng.params, toks, frontend=frontend,
                          bank=eng.bank, lora_idx=idx, lora_kernel=kernel,
                          cache_len=S + DECODE_STEPS,
                          cache_dtype=torch.float32)
    out, fed = [lg], []
    for i in range(DECODE_STEPS):
        nxt = lg.argmax(-1).to(torch.int32) if tokens is None else tokens[i]
        fed.append(nxt)
        lg, cache = M.decode_step(cfg, eng.params, cache, nxt, bank=eng.bank,
                                  lora_idx=idx, lora_kernel=kernel)
        out.append(lg)
    assert all(torch.isfinite(o).all() for o in out)
    return [o.float().cpu() for o in out], fed


def _held(tag, what, got, ref):
    """bf16 logits (a list of (rows, V)) against their fp32 reference,
    within 5e-2 of the reference's largest logit; logged."""
    scale = max(r.abs().max().item() for r in ref)
    err = max((g - r).abs().max().item() for g, r in zip(got, ref))
    agree = [(g.argmax(-1) == r.argmax(-1)).tolist() for g, r in zip(got,
                                                                    ref)]
    log(f"{tag} logits {what}: bf16 vs fp32 on the same weights: max abs "
        f"diff {err:.4e} of max |logit| {scale:.4f} ({err / scale:.3%}; "
        f"tol 5e-2 of it), argmax agree {agree}")
    assert all(torch.isfinite(r).all() for r in ref)
    assert err <= 5e-2 * scale, (what, err, scale)


def _moved(tag, what, a, b):
    """How far a nonzero frontend moves the logits from the zero one's."""
    moved = max((x - y).abs().max().item() for x, y in zip(a, b))
    scale = max(y.abs().max().item() for y in b)
    log(f"{tag} frontend {what}: a nonzero frontend moves the logits by "
        f"max abs {moved:.4e} ({moved / scale:.3%} of max |logit| "
        f"{scale:.4f}) from the zero frontend's")
    assert moved > 0, what


def _audio(dev, smi, results):
    """Phase 12 (a)-(c): seamless-m4t-large-v2 at full width and depth.
    Returns the launches of (a)'s runs."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import sgmv
    cfg = get_config(SEAMLESS)
    params = _init_model(cfg, dev, tag="audio")
    trace, ranks, weights = _serve_trace(cfg, 8, dev)
    # (a) the engine: zero frontends, as the reference's engine feeds
    main = MainPathCalls(widths=True)
    flash = FlashCalls(main)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [(m, db) for m in ("padded", "bucketed") for db in (1, 4)], smi,
        flash, tag="audio")
    # d = d_out = 1024 at every target, the shrink split C = 8
    d = cfg.d_model
    assert _widths_seen(main.calls, "sgmv_fused_blocks") == \
        _lora_widths(cfg) == [(d, d)]
    assert _widths_seen(main.calls, "sgmv_multibank_blocks") == [(d, d)]
    log(f"audio B1/B2 width d={d}: shrink split C="
        f"{sgmv.shrink_split(d, torch.bfloat16)}")
    lg = _group_logits(cfg, engines["padded"], trace, 64)
    assert torch.equal(lg, _group_logits(cfg, engines["bucketed"], trace,
                                         64))
    # (b) a nonzero frontend at model level: N(0, 0.02^2) frames, fp32 as
    # the engine's, on the 2 x 1000 group; B5's calls recorded
    eng = engines["padded"]
    del engines
    g = torch.Generator(device=dev).manual_seed(7)
    fe = torch.randn((2, cfg.encoder.n_frames, cfg.d_model), generator=g,
                     device=dev) * 0.02
    with FlashCalls() as b5:
        nz, fed = _frontend_run(cfg, eng, trace, 1000, fe)
    zero, _ = _frontend_run(cfg, eng, trace, 1000, eng.zero_frontend(2),
                            tokens=fed)
    _moved("audio", f"{cfg.name} 2 x 1000 group, prefill and "
           f"{DECODE_STEPS} decode steps", nz, zero)
    del eng
    _free()
    # the fp32 reference on the same weights, upcast in place
    fp32 = _fp32_engine(cfg, params, ranks, weights, 72)
    ref = _group_logits(cfg, fp32, trace, 64, kernel="einsum")
    _held("audio", f"{cfg.name} first prefill group (4 x 64), zero "
          "frontend, padded == bucketed bit for bit", [lg], [ref])
    ref_nz, _ = _frontend_run(cfg, fp32, trace, 1000, fe, kernel="einsum",
                              tokens=fed)
    _held("audio", f"{cfg.name} 2 x 1000 group, nonzero frontend, prefill "
          f"and {DECODE_STEPS} decode steps", nz, ref_nz)
    del fp32, params
    _free()
    # (c) the kernels at the new shapes: B1/B2 (and B3a/B3b on B1's) on
    # the smallest and the largest prefill group (no decode call: the
    # adapters stay out of decode); B5 on (b)'s encoder and cross calls
    # and on (a)'s causal decoder call
    calls = {(k[0], {"decode": "minprefill", "prefill": "maxprefill"}[k[1]],
              *k[2:]): v for k, v in main.calls.items()
             if k[0] != "flash_mha"}
    _moe_kernel_checks(dev, "seamless", calls, results)
    M = cfg.encoder.n_frames
    picked = {"encoder": b5.calls[(False, 2, M, M)],
              "cross": b5.calls[(False, 2, 1000, M)],
              "decoder": flash.calls[(True, 2, 1000, 1000)]}
    assert picked["encoder"][0][0].dtype == torch.float32     # promoted
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for what, (args, kw) in picked.items():
        _check_and_time("B5", f"seamless-{what}-hd64", args, kw, None,
                        flush, results)
    del flush, picked, b5, flash, main, calls
    return launches


def _vision(dev, smi, results):
    """Phase 12 (e): llama-3.2-vision-90b at full width and two periods
    (10 of its 100 layers), the gates set nonzero in place after init (0
    at init, where every cross block is the identity). Returns the
    launches of its runs (none)."""
    import dataclasses as dc
    from repro_torch.configs import get_config
    cfg = dc.replace(get_config(VISION), n_layers=VISION_LAYERS)
    params = _init_model(cfg, dev, tag="vlm")
    with torch.no_grad():
        for i, cb in enumerate(params.cross_blocks):
            cb.gate_attn.fill_(0.5 + 0.25 * i)
            cb.gate_ffn.fill_(-0.4 - 0.25 * i)
    log(f"vlm gates set in place: gate_attn "
        f"{[cb.gate_attn.item() for cb in params.cross_blocks]} gate_ffn "
        f"{[cb.gate_ffn.item() for cb in params.cross_blocks]} (0 at init)")
    trace, ranks, weights = _serve_trace(cfg, 8, dev)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [(m, db) for m in ("padded", "bucketed") for db in (1, 4)], smi,
        MainPathCalls(), tag="vlm")
    assert not any(launches.values()), launches
    lg = _group_logits(cfg, engines["padded"], trace, 64)
    assert torch.equal(lg, _group_logits(cfg, engines["bucketed"], trace,
                                         64))
    eng = engines["padded"]
    del engines
    g = torch.Generator(device=dev).manual_seed(7)
    fe = torch.randn((4, cfg.n_frontend_tokens, cfg.d_model), generator=g,
                     device=dev) * 0.02
    nz, fed = _frontend_run(cfg, eng, trace, 64, fe)
    zero, _ = _frontend_run(cfg, eng, trace, 64, eng.zero_frontend(4),
                            tokens=fed)
    _moved("vlm", f"{cfg.name} first prefill group (4 x 64, "
           f"{cfg.n_frontend_tokens} patches), prefill and {DECODE_STEPS} "
           "decode steps", nz, zero)
    del eng
    _free()
    torch.cuda.reset_peak_memory_stats(dev)
    fp32 = _fp32_engine(cfg, params, ranks, weights, 72)
    ref = _group_logits(cfg, fp32, trace, 64, kernel="einsum")
    log(f"vlm fp32 reference: peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB")
    _held("vlm", f"{cfg.name} first prefill group (4 x 64), zero frontend, "
          "padded == bucketed bit for bit", [lg], [ref])
    del fp32, params
    _free()
    return launches


def phase_encdec_vlm(dev, smi):
    """Phase 12. Returns (the launches of its main-path runs, the kernels'
    results at the new shapes)."""
    results, launches = {}, {kid: 0 for kid in KERNELS}
    t0 = time.monotonic()
    for kid, n in _audio(dev, smi, results).items():
        launches[kid] += n
    _free()
    log(f"phase encdec audio: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    _moe_launcher(SEAMLESS, tag="audio")
    log(f"phase encdec launcher: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    for kid, n in _vision(dev, smi, results).items():
        launches[kid] += n
    _free()
    log(f"phase encdec vlm: {time.monotonic() - t0:.1f}s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 13: every family at tp = 2
# ---------------------------------------------------------------------------
ZAMBA, RWKV = "zamba2-7b", "rwkv6-7b"
# arch -> the layers phase 13 serves at full width (seamless: its encoder's
# too); phases 10-12 serve every family at full depth (llama4 and the VLM
# cut as there), the launchers of 10 (d), 11 (d), 12 (d) at tp = 1
TP_FAMILIES = {DEEPSEEK: 6, LLAMA4: LLAMA4_LAYERS, ZAMBA: 12, RWKV: 8,
               SEAMLESS: 6, VISION: VISION_LAYERS}
_SPLIT = {"padded": ("B3a", "B3b"), "bucketed": ("B4a", "B4b")}


def _family_cfg(arch, fp32=False):
    """Phase 13's config of ``arch``: full width, at ``TP_FAMILIES``'s
    depth; with ``fp32``, the parity's 2 layers (the VLM one period of 5,
    which holds its cross block); seamless's encoder as deep as its
    decoder."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n = TP_FAMILIES[arch] if not fp32 else (
        cfg.cross_attn_every if cfg.family == "vlm" else 2)
    cfg = dataclasses.replace(cfg, n_layers=n)
    if cfg.encoder is not None:
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
            cfg.encoder, n_layers=n))
    return cfg


def _family_params(cfg, dev, dtype, seed, tp=None):
    """Weights from ``seed`` (a rank's slice, drawn block by block, with
    ``tp``); the VLM's gates set nonzero in place, as in phase 12."""
    from repro_torch.models import model as M
    params = M.init_params(cfg, seed, dtype=dtype, device=dev, tp=tp)
    if cfg.family == "vlm":
        with torch.no_grad():
            for i, cb in enumerate(params.cross_blocks):
                cb.gate_attn.fill_(0.5 + 0.25 * i)
                cb.gate_ffn.fill_(-0.4 - 0.25 * i)
    return params


def _family_frontend(cfg, eng):
    """A nonzero N(0, 0.02^2) fp32 frontend for the first prefill group
    of phase 6's trace (4 rows), from a seed; None for a family that
    takes none."""
    from repro_torch.models import model as M
    if not M.n_cross_applications(cfg):
        return None
    g = torch.Generator(device=eng.device).manual_seed(7)
    return torch.randn((4, eng.enc_len, cfg.d_model), generator=g,
                       device=eng.device) * 0.02


def _fe_logits(cfg, eng, mesh=None):
    """The first prefill group's logits with the nonzero frontend (model
    level: the engines feed zeros), fp32 on the host."""
    from repro_torch.models import model as M
    toks, idx = _group(eng, _tp_trace(cfg), 64)
    lg, _ = M.prefill(cfg, eng.params, toks,
                      frontend=_family_frontend(cfg, eng), bank=eng.bank,
                      lora_idx=idx, lora_kernel="sgmv", tp=mesh)
    assert torch.isfinite(lg).all()
    return lg.float().cpu()


class EPReference:
    """While entered, the model's MoE layers run ``moe_ffn_ep_ref(n=TP)``
    at a prefill whose length TP divides (what TP expert-parallel ranks
    compute, on one process) and the drop-free path elsewhere: the tp =
    1 reference of the tp = 2 MoE path."""

    def __enter__(self):
        from repro_torch.models import ffn
        from repro_torch.models import model as M
        self.M, self.orig = M, M.moe_ffn

        def moe_ffn(cfg, p, x, **kw):
            if x.shape[1] > 1 and x.shape[1] % TP == 0:
                return ffn.moe_ffn_ep_ref(cfg, p, x, TP)
            return self.orig(cfg, p, x)
        M.moe_ffn = moe_ffn
        return self

    def __exit__(self, *exc):
        self.M.moe_ffn = self.orig


def _tp_call_widths(name, args):
    """The widths a tp call runs at: (d_local, r) of B3a, (d_local,) of
    B4a, the output's d_out_local of B3b and B4b, (hd,) of B5."""
    x = args[0]
    return {"sgmv_shrink": lambda: (x.shape[1], args[1].shape[-1]),
            "sgmv_multibank_shrink": lambda: (x.shape[1],),
            "sgmv_expand": lambda: (args[1].shape[-1],),
            "sgmv_multibank_expand": lambda: (args[1][0].shape[-1],),
            "flash_mha": lambda: (x.shape[-1],)}[name]()


def _tp_path_launches(cfg, mode, passes, groups):
    """``_path_launches`` on the tensor-parallel path: each of the
    mode's two split kernels once per LoRA call, where tp = 1 runs B1 or
    B2; B5 as at tp = 1 (a family's local heads are MHA where its heads
    are)."""
    want = _path_launches(cfg, mode, passes, groups)
    n = want.pop("B1") + want.pop("B2")
    want.update({"B1": 0, "B2": 0}, **{kid: n for kid in _SPLIT[mode]})
    return want


def _collective_times(cfg, dev):
    """ms per call of the collectives phase 13's path makes, at its
    shapes: the hidden state's all-reduce at decode and prefill, the
    rank-r intermediate's; for the MoE family the expert-parallel
    path's all-to-all of its (E, C, d) buffer (phase 6's 4 x 128 group)
    and all-gather of the (4, 64, d) chunk."""
    import torch.distributed as dist
    from repro_torch.models import ffn
    d, bf = cfg.d_model, torch.bfloat16
    out = {}
    for what, shape in (("all_reduce hidden decode", (8, 1, d)),
                        ("all_reduce hidden prefill", (4, 128, d)),
                        ("all_reduce lora h decode", (128, 128))):
        out[f"{what} {shape}"] = _time_all_reduce(
            torch.ones(shape, dtype=bf, device=dev))
    if cfg.moe is not None:
        e = cfg.moe
        C = ffn.ep_capacity(4 * 128 // TP, e.top_k, e.n_experts)
        x = torch.ones((e.n_experts, C, d), dtype=bf, device=dev)
        y = torch.empty_like(x)
        out[f"all_to_all EP buffer {tuple(x.shape)}"] = _time_collective(
            lambda: dist.all_to_all_single(y, x))
        x = torch.ones((4, 128 // TP, d), dtype=bf, device=dev)
        parts = [torch.empty_like(x) for _ in range(TP)]
        out[f"all_gather EP chunk {tuple(x.shape)}"] = _time_collective(
            lambda: dist.all_gather(parts, x))
    return out


def _family_rank(rank, tp, out_dir):
    """One rank of phase 13, spawned with a default gloo group: every
    family of ``TP_FAMILIES`` at full width in bf16 (phase 6's trace,
    both bank modes), then at the fp32 parity's 2 layers. Writes
    ``family-rank{rank}.pt``; rank 0 also ``family-calls-{arch}.pt``,
    copies of its calls of every kernel of the path."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.serve import adapter_weights, serve
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_engine_mesh(1, tp, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    wrappers = _wrappers()
    names = ("all_reduce", "all_gather", "all_to_all_single")
    orig = {n: getattr(dist, n) for n in names}
    counts = {n: 0 for n in names}

    def counted(n):
        def call(*a, **kw):
            counts[n] += 1
            return orig[n](*a, **kw)
        return call
    out = {}
    for arch in TP_FAMILIES:
        cfg = _family_cfg(arch)
        t0 = time.monotonic()
        params = _family_params(cfg, dev, torch.bfloat16, 0, tp=mesh)
        torch.cuda.synchronize()
        o = out[arch] = {"bf16": {}, "fp32": {}, "fp32_logits": {},
                         "init_s": time.monotonic() - t0}
        rec = MainPathCalls(tp=True, widths=_tp_call_widths)
        flash = FlashCalls(rec)
        for mode in ("padded", "bucketed"):
            # the main path: counts at 0 just before each engine run, read
            # just after
            for k in wrappers.values():
                k.launches = 0
            n0 = dict(counts)
            torch.cuda.reset_peak_memory_stats(dev)
            for n in names:
                setattr(dist, n, counted(n))
            try:
                with flash:
                    eng, reqs, summ = _serve_tp_trace(cfg, params, dev, mode,
                                                      mesh)
                    torch.cuda.synchronize()
            finally:
                for n in names:
                    setattr(dist, n, orig[n])
            b = o["bf16"][mode] = dict(
                tokens=[r.output for r in reqs], summary=summ,
                grew={kid: k.launches for kid, k in wrappers.items()},
                passes=eng.prefill_dispatches + eng.decode_iterations,
                prefills=eng.prefill_dispatches,
                collectives={n: counts[n] - n0[n] for n in names},
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
            # off the counted run
            b["logits"] = _first_logits(cfg, eng, mesh=mesh)
            if _takes_frontend(cfg):
                b["logits_fe"] = _fe_logits(cfg, eng, mesh)
            del eng
            _free()
        if rank == 0:
            torch.save({"calls": {k: _move(v, "cpu")
                                  for k, v in rec.calls.items()},
                        "flash": {k: _move(v, "cpu")
                                  for k, v in flash.calls.items()}},
                       Path(out_dir) / f"family-calls-{arch}.pt")
        o["collective_ms"] = _collective_times(cfg, dev)
        del params, rec, flash
        _free()
        cfg2 = _family_cfg(arch, fp32=True)
        params2 = _family_params(cfg2, dev, torch.float32, 1, tp=mesh)
        ranks = _tp_ranks(cfg2)
        weights2 = adapter_weights(cfg2, ranks, dtype=torch.float32,
                                   device=dev, seed=4)
        for mode in ("padded", "bucketed"):
            eng, reqs, _ = serve(cfg2, params2, _tp_trace(cfg2),
                                 weights=weights2, bank_mode=mode,
                                 lora_kernel="sgmv", decode_block=4,
                                 max_batch=8, mesh=mesh, device=dev)
            o["fp32"][mode] = [r.output for r in reqs]
            o["fp32_logits"][mode] = _first_logits(cfg2, eng, mesh=mesh)
            if _takes_frontend(cfg2):
                o["fp32_logits"][mode + "_fe"] = _fe_logits(cfg2, eng, mesh)
            del eng
        del params2, weights2
        _free()
    torch.save(out, Path(out_dir) / f"family-rank{rank}.pt")


def _takes_frontend(cfg):
    """Whether the family takes a frontend (the VLM and audio ones)."""
    from repro_torch.models import model as M
    return bool(M.n_cross_applications(cfg))


def _family_refs(dev):
    """The tp = 1 references of phase 13, one model on the card at a
    time: the bf16 first-prefill logits at full width (zero and nonzero
    frontends), the fp32 2-layer trace's tokens and first-prefill logits
    (the MoE family under ``EPReference``)."""
    from contextlib import nullcontext
    from repro_torch.launch.serve import adapter_weights, serve
    from repro_torch.serving import ServingEngine
    refs = {}
    for arch in TP_FAMILIES:
        cfg = _family_cfg(arch)
        ep = EPReference() if cfg.moe is not None else nullcontext()
        params = _family_params(cfg, dev, torch.bfloat16, 0)
        ranks, weights = _tp_weights(cfg, dev)
        eng = ServingEngine(cfg, params, ranks, max_batch=8, max_len=160,
                            bank_mode="padded", lora_kernel="sgmv",
                            device=dev)
        for aid, w in weights.items():
            eng.install_adapter(aid, ranks[aid], w)
        r = refs[arch] = {}
        log(f"tpfam ref {arch}: tp = 1, {cfg.n_layers} layers, bf16")
        with ep:
            r["bf16"] = _first_logits(cfg, eng)
            if _takes_frontend(cfg):
                r["bf16_fe"] = _fe_logits(cfg, eng)
        del eng, params, weights
        _free()
        cfg2 = _family_cfg(arch, fp32=True)
        params2 = _family_params(cfg2, dev, torch.float32, 1)
        ranks = _tp_ranks(cfg2)
        weights2 = adapter_weights(cfg2, ranks, dtype=torch.float32,
                                   device=dev, seed=4)
        with ep:
            eng, reqs, _ = serve(cfg2, params2, _tp_trace(cfg2),
                                 weights=weights2, bank_mode="padded",
                                 lora_kernel="sgmv", decode_block=4,
                                 max_batch=8, device=dev)
            r["fp32"] = [q.output for q in reqs]
            r["fp32_logits"] = _first_logits(cfg2, eng)
            if _takes_frontend(cfg2):
                r["fp32_fe"] = _fe_logits(cfg2, eng)
        del eng, params2, weights2
        _free()
    return refs


def _dist(a, b):
    err = (a - b).abs().max().item()
    return err, b.abs().max().item()


def _family_checks(arch, outs, ref, smi):
    """Phase 13's assertions on one family: launches, both ranks' tokens
    and logits equal, padded == bucketed bit for bit, the fp32 2-layer
    tokens of tp = 1 and its logits within 1e-3; the bf16 distance from
    tp = 1 printed. Returns rank 0's launches of the main path."""
    cfg = _family_cfg(arch)
    tag = f"tpfam {arch}"
    launches = {kid: 0 for kid in KERNELS}
    for r, o in enumerate(outs):
        fam = o[arch]
        for mode in ("padded", "bucketed"):
            b = fam["bf16"][mode]
            want = _tp_path_launches(cfg, mode, b["passes"], b["prefills"])
            assert b["grew"] == want, (arch, r, mode, b["grew"], want)
            assert all(len(t) == 16 for t in b["tokens"]), arch
            assert all(0 <= t < cfg.vocab_size for q in b["tokens"]
                       for t in q)
            assert torch.isfinite(b["logits"]).all()
            if r == 0:
                for kid, n in b["grew"].items():
                    launches[kid] += n
                s = b["summary"]
                log(f"{tag} rank 0 layers={cfg.n_layers} mode={mode} | "
                    f"{smi}: finished={s['finished']}/8 passes="
                    f"{b['passes']} collectives {b['collectives']} "
                    f"launches { {k: v for k, v in b['grew'].items() if v} }"
                    f" p50_ttft_ms={s['p50_ttft'] * 1e3:.2f}"
                    f" p95_ttft_ms={s['p95_ttft'] * 1e3:.2f}"
                    f" mean_tbt_ms={s['mean_tbt'] * 1e3:.3f}"
                    f" decode_tok_s={s['decode_tok_s']:.1f}"
                    f" wall_s={s['wall_s']:.3f} peak_gb={b['peak_gb']:.2f}"
                    f" (init {fam['init_s']:.1f}s)")
                continue
            a = outs[0][arch]["bf16"][mode]
            assert b["tokens"] == a["tokens"], (arch, mode, "ranks' tokens")
            assert torch.equal(b["logits"], a["logits"]), (arch, mode)
            for key in ("logits_fe",):
                if key in a:
                    assert torch.equal(b[key], a[key]), (arch, mode, key)
        assert fam["fp32"] == outs[0][arch]["fp32"], (arch, "fp32 ranks")
    peaks = "; ".join(
        f"rank {r} " + ", ".join(f"{m} {o[arch]['bf16'][m]['peak_gb']:.2f}"
                                 for m in ("padded", "bucketed"))
        for r, o in enumerate(outs))
    log(f"{tag} peak GB a rank, vocab-parallel embed and lm_head: {peaks} "
        f"| {smi}")
    o = outs[0][arch]
    pad, bkt = o["bf16"]["padded"], o["bf16"]["bucketed"]
    assert pad["tokens"] == bkt["tokens"], (arch, "modes' tokens differ")
    assert torch.equal(pad["logits"], bkt["logits"]), (arch, "modes' logits")
    if "logits_fe" in pad:
        assert torch.equal(pad["logits_fe"], bkt["logits_fe"])
    log(f"{tag}: both ranks emit the same tokens and logits; padded "
        f"(B3a/B3b) == bucketed (B4a/B4b) tokens and first-prefill "
        f"logits bit for bit")
    for what, got, want in (("zero frontend", pad["logits"], ref["bf16"]),
                            ("nonzero frontend", pad.get("logits_fe"),
                             ref.get("bf16_fe"))):
        if got is None:
            continue
        err, scale = _dist(got, want)
        agree = (got.argmax(-1) == want.argmax(-1)).tolist()
        log(f"{tag} bf16 first prefill logits ({what}) tp = 2 vs tp = 1"
            f"{' (EPReference)' if cfg.moe else ''}: max abs diff "
            f"{err:.4e} of max |logit| {scale:.4f} ({err / scale:.3%}; "
            f"printed, not asserted); argmax agree {agree}")
    for mode in ("padded", "bucketed"):
        assert o["fp32"][mode] == ref["fp32"], (arch, mode, "fp32 tokens")
        err, _ = _dist(o["fp32_logits"][mode], ref["fp32_logits"])
        line = f"prefill logits max abs diff vs tp = 1 {err:.3e}"
        assert err <= 1e-3, (arch, mode, err)
        if mode + "_fe" in o["fp32_logits"]:
            e2, _ = _dist(o["fp32_logits"][mode + "_fe"], ref["fp32_fe"])
            assert e2 <= 1e-3, (arch, mode, "nonzero frontend", e2)
            line += f"; with a nonzero frontend {e2:.3e}"
        log(f"{tag} fp32 {_family_cfg(arch, True).n_layers} layers {mode}: "
            f"tokens == tp = 1's; {line} (tol 1e-3)")
    for what, ms in o["collective_ms"].items():
        log(f"{tag} {what}: {ms:.4f} ms (gloo, {TP} ranks on one card, "
            "host clock)")
    return launches


def _family_kernels(arch, calls, flash, results):
    """B3a/B3b/B4a/B4b on rank 0's copied calls at each of the family's
    tp = 2 widths (a decode step's and the largest prefill group's; the
    audio family's adapters run at prefill only: its smallest and
    largest group), and B5 on its MHA calls, against their plain
    versions in bf16 and fp32, timed and bounded, with the SGMV
    kernels' yardsticks."""
    cfg = _family_cfg(arch)
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    short = arch.split("-")[0]
    kid_of = {KERNELS[k][0]: k for k in ("B3a", "B3b", "B4a", "B4b")}
    for key in sorted(k for k in calls if k[0] in kid_of):
        name, layout, *widths = key
        kid = kid_of[name]
        args, kw, dest = _move(calls[key], dev)
        if cfg.family == "audio":
            layout = {"decode": "minprefill", "prefill": "maxprefill"}[layout]
        label = f"tp{TP}-{short}-{layout}-w{'x'.join(map(str, widths))}"
        _check_and_time(kid, label, args, kw, dest, flush, results)
        _yardstick(kid, label, args, kw, dest, flush)
    picks = {}
    if cfg.family == "hybrid":
        picks["causal"] = flash[(True, 4, 128, 128)]
    elif cfg.family == "audio":
        M = cfg.encoder.n_frames
        picks = {"encoder": flash[(False, 4, M, M)],
                 "cross": flash[(False, 4, 128, M)],
                 "decoder": flash[(True, 4, 128, 128)]}
    for what, (args, kw) in picks.items():
        args = _move(args, dev)
        assert args[0].shape[1] == cfg.n_heads // TP, args[0].shape
        _check_and_time("B5", f"tp{TP}-{short}-{what}-hd{args[0].shape[-1]}",
                        args, kw, None, flush, results)
    del flush


def phase_tp_families(dev, smi):
    """Phase 13. Returns (rank 0's launches of the main path, the
    kernels' results at the tp = 2 widths)."""
    from repro_torch.launch.mesh import spawn
    t0 = time.monotonic()
    refs = _family_refs(dev)
    log(f"phase tpfam refs (tp = 1): {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        spawn(_family_rank, TP, backend="gloo", init_file=Path(tmp) / "init",
              args=(TP, tmp))
        outs = [torch.load(Path(tmp) / f"family-rank{r}.pt",
                           weights_only=False) for r in range(TP)]
        calls = {arch: torch.load(Path(tmp) / f"family-calls-{arch}.pt",
                                  weights_only=False)
                 for arch in TP_FAMILIES}
    log(f"phase tpfam ranks: {time.monotonic() - t0:.1f}s")
    launches, results = {kid: 0 for kid in KERNELS}, {}
    for arch in TP_FAMILIES:
        for kid, n in _family_checks(arch, outs, refs[arch], smi).items():
            launches[kid] += n
    t0 = time.monotonic()
    for arch in TP_FAMILIES:
        _family_kernels(arch, calls[arch]["calls"], calls[arch]["flash"],
                        results)
    log(f"phase tpfam kernels: {time.monotonic() - t0:.1f}s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 14: data parallelism and the cluster on a mesh
# ---------------------------------------------------------------------------
DP = 2
DP_LAYERS = 8                         # phase 14's depth, full width
def _dp_cfg():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama-7b-paper"),
                               n_layers=DP_LAYERS)


def _dp1_tokens(dev):
    """Phase 2's trace at dp = 1 on phase 14's model (padded, decode block
    1): the bf16 tokens the replicas' tokens are printed against."""
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    cfg = _dp_cfg()
    params = M.init_params(cfg, 0, dtype=torch.bfloat16, device=dev)
    trace, _, weights = _serve_trace(cfg, 8, dev)
    _, reqs, _ = serve(cfg, params, trace, weights=weights,
                       bank_mode="padded", lora_kernel="sgmv", max_batch=8,
                       device=dev)
    return [r.output for r in reqs]


def _dp_rank(rank, dp, tp, out_dir):
    """One rank of phase 14 at (dp, tp), spawned with a default gloo group:
    phase 2's trace on llama-7b-paper at full width and ``DP_LAYERS``
    layers (bf16 weights from phase 2's seed, the rank's slice drawn
    block by block),
    padded and bucketed, decode blocks 1 and 4, then phase 5's fp32
    2-layer trace. Writes ``dp-rank{rank}.pt``; rank 0 also
    ``dp-calls.pt``, copies of its bf16 calls of every kernel of the
    path."""
    from contextlib import nullcontext
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_engine_mesh
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_engine_mesh(dp, tp, device="cuda")
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = _dp_cfg()
    t0 = time.monotonic()
    params = M.init_params(cfg, 0, dtype=torch.bfloat16, device=dev,
                           tp=mesh)
    torch.cuda.synchronize()
    trace, _, weights = _serve_trace(cfg, 8, dev)
    wrappers = _wrappers()
    out = {"bf16": {}, "fp32": {}, "fp32_logits": {},
           "coords": (mesh.dp.rank, mesh.rank),
           "init_s": time.monotonic() - t0}
    rec = MainPathCalls(tp=tp > 1, widths=_tp_call_widths if tp > 1
                        else True) if rank == 0 else None
    for mode in ("padded", "bucketed"):
        for db in (1, 4):
            # the main path: counts at 0 just before each engine run, read
            # just after
            for k in wrappers.values():
                k.launches = 0
            torch.cuda.reset_peak_memory_stats(dev)
            with rec or nullcontext():
                eng, reqs, s = serve(cfg, params, trace, weights=weights,
                                     bank_mode=mode, lora_kernel="sgmv",
                                     decode_block=db, max_batch=8,
                                     mesh=mesh, device=dev)
                torch.cuda.synchronize()
            b = out["bf16"][(mode, db)] = dict(
                tokens=[r.output for r in reqs], summary=s,
                grew={kid: k.launches for kid, k in wrappers.items()},
                passes=eng.prefill_dispatches + eng.decode_iterations,
                prefills=eng.prefill_dispatches,
                rows=eng.cache["pos"].shape[0],
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
            if db == 1:                  # off the counted run
                b["logits"] = _group_logits(cfg, eng, trace, 64,
                                            mesh=eng.tp)
            del eng
            _free()
    if rec is not None:
        torch.save({k: _move(v, "cpu") for k, v in rec.calls.items()},
                   Path(out_dir) / "dp-calls.pt")
    del params, rec
    _free()
    cfg2, params2, trace2, weights2 = _parity_setup(dev)
    for mode in ("padded", "bucketed"):
        eng, reqs, _ = serve(cfg2, params2, trace2, weights=weights2,
                             bank_mode=mode, lora_kernel="sgmv", max_batch=8,
                             mesh=mesh, device=dev)
        out["fp32"][mode] = [r.output for r in reqs]
        out["fp32_logits"][mode] = _group_logits(cfg2, eng, trace2, 24,
                                                 mesh=eng.tp)
        del eng
    del params2
    _free()
    torch.save(out, Path(out_dir) / f"dp-rank{rank}.pt")


def _dp_checks(cfg, dp, tp, outs, fp32_ref, dp1_tokens, smi):
    """Phase 14 (a)/(b)'s assertions on every rank's outputs; returns rank
    0's launches of the main path."""
    tag = f"dp ({dp}, {tp})"
    launches = {kid: 0 for kid in KERNELS}
    runs = list(outs[0]["bf16"])
    for r, o in enumerate(outs):
        assert o["coords"] == (r // tp, r % tp), (r, o["coords"])
        for key in runs:
            b, a = o["bf16"][key], outs[0]["bf16"][key]
            mode = key[0]
            want = (_path_launches if tp == 1 else _tp_path_launches)(
                cfg, mode, b["passes"], b["prefills"])
            assert b["grew"] == want, (tag, r, key, b["grew"], want)
            assert b["rows"] == 8 // dp, b["rows"]   # the slot batch split
            assert all(len(t) == 16 for t in b["tokens"]), (tag, r, key)
            assert all(0 <= t < cfg.vocab_size for q in b["tokens"]
                       for t in q)
            assert b["tokens"] == a["tokens"], (tag, key, "ranks' tokens")
            if "logits" in b:
                assert torch.isfinite(b["logits"]).all()
                assert torch.equal(b["logits"], a["logits"]), (tag, key)
            if r == 0:
                for kid, n in b["grew"].items():
                    launches[kid] += n
        assert o["fp32"] == outs[0]["fp32"], (tag, "ranks' fp32 tokens")
        s = ", ".join(f"{m}/{d} {o['bf16'][(m, d)]['peak_gb']:.2f}"
                      for m, d in runs)
        log(f"{tag} rank {r} (dp rank {r // tp}, tp rank {r % tp}) peak GB "
            f"{s} | {smi}")
    o = outs[0]["bf16"]
    first = o[runs[0]]["tokens"]
    for key in runs:
        assert o[key]["tokens"] == first, (tag, key, "differs from", runs[0])
        s, b = o[key]["summary"], o[key]
        log(f"{tag} rank 0 {key[0]} decode_block={key[1]} | {smi}: "
            f"finished={s['finished']}/8 passes={b['passes']} launches "
            f"{ {k: v for k, v in b['grew'].items() if v} } "
            f"p50_ttft_ms={s['p50_ttft'] * 1e3:.2f} "
            f"p95_ttft_ms={s['p95_ttft'] * 1e3:.2f} "
            f"mean_tbt_ms={s['mean_tbt'] * 1e3:.3f} "
            f"decode_tok_s={s['decode_tok_s']:.1f} wall_s={s['wall_s']:.3f}"
            f" peak_gb={b['peak_gb']:.2f}")
    assert torch.equal(o[("padded", 1)]["logits"],
                       o[("bucketed", 1)]["logits"]), (tag, "modes' logits")
    log(f"{tag}: every rank emits the same tokens and first-prefill "
        f"logits; padded == bucketed tokens (decode blocks 1 and 4) and "
        f"logits bit for bit")
    same = sum(a == b for a, b in zip(first, dp1_tokens))
    agree = sum(x == y for a, b in zip(first, dp1_tokens)
                for x, y in zip(a, b))
    log(f"{tag} bf16 vs dp = 1's tokens on the same model (printed, not "
        f"asserted): {same}/8 requests and {agree}/128 tokens equal")
    fp32_tokens, fp32_logits = fp32_ref
    for mode in ("padded", "bucketed"):
        assert outs[0]["fp32"][mode] == fp32_tokens, (tag, mode)
        err = (outs[0]["fp32_logits"][mode] - fp32_logits).abs().max().item()
        log(f"{tag} fp32 2 layers {mode}: tokens == dp = 1's; prefill "
            f"logits max abs diff vs dp = 1 {err:.3e} (tol 1e-3)")
        assert err <= 1e-3, (tag, mode, err)
    return launches


def _dp_kernels(dp, tp, calls, results):
    """The SGMV kernels of (dp, tp)'s path on rank 0's copied decode calls,
    a replica's 8 / dp slot rows (B1/B2 at tp = 1, B3a/B3b/B4a/B4b on
    the local widths at tp = 2), against their plain versions in bf16
    and fp32, timed and bounded, with their yardsticks. Its prefill
    groups are phase 2's and 6's: every replica prefills the whole
    group."""
    dev = torch.device("cuda", 0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    for kid in ("B1", "B2") if tp == 1 else ("B3a", "B3b", "B4a", "B4b"):
        keys = [k for k in calls
                if k[:2] == (KERNELS[kid][0], "decode")]
        assert keys, (kid, sorted(calls))
        for key in keys:
            args, kw, dest = _move(calls[key], dev)
            assert dest.shape[0] == 8 // dp, (kid, dest.shape)
            label = f"dp{dp}x{tp}-decode-w{'x'.join(map(str, key[2:]))}"
            _check_and_time(kid, label, args, kw, dest, flush, results)
            _yardstick(kid, label, args, kw, dest, flush)
    del flush


def _dp_launcher(smi):
    """Phase 14 (c): ``launch/serve.py --config full --servers 2 --mesh
    1,2`` as a subprocess, two gloo ranks on the card: exit 0, every
    request finished, the report on the mesh."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    args = ["repro_torch.launch.serve", "--config", "full", "--servers",
            "2", "--mesh", "1,2", "--backend", "gloo", "--bank-mode",
            "bucketed", "--decode-block", "4", *LAUNCHER_TRACE]
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    lines = proc.stdout.strip().splitlines()
    assert proc.returncode == 0, (proc.returncode, proc.stdout,
                                  proc.stderr[-4000:])
    assert lines and lines[-1] == "cluster drained OK", proc.stdout
    assert "mesh=(1, 2)" in proc.stdout and "finished=4/4" in proc.stdout, \
        proc.stdout
    assert proc.stdout.count("finished=") == 1, proc.stdout
    log(f"dp launcher python -m {' '.join(args)} | {smi}: exit 0 in "
        f"{time.monotonic() - t0:.1f}s; it printed: {' | '.join(lines)}")


def phase_dp(dev, smi, fp32_ref):
    """Phase 14: (a) dp = 2, tp = 1 and (b) dp = 2, tp = 2 as gloo ranks on
    the card, each world spawned, checked and gone before the next, its
    kernels checked on rank 0's decode calls; (c) the cluster launcher on
    a (1, 2) mesh. Returns (rank 0's launches of (a) and (b)'s main path,
    the kernels' results at a replica's rows)."""
    from repro_torch.launch.mesh import spawn
    cfg = _dp_cfg()
    dp1_tokens = _dp1_tokens(dev)
    _free()
    launches, results = {kid: 0 for kid in KERNELS}, {}
    for dp, tp in ((DP, 1), (DP, 2)):
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            spawn(_dp_rank, dp * tp, backend="gloo",
                  init_file=Path(tmp) / "init", args=(dp, tp, tmp))
            outs = [torch.load(Path(tmp) / f"dp-rank{r}.pt",
                               weights_only=False) for r in range(dp * tp)]
            calls = torch.load(Path(tmp) / "dp-calls.pt", weights_only=False)
        for kid, n in _dp_checks(cfg, dp, tp, outs, fp32_ref, dp1_tokens,
                                 smi).items():
            launches[kid] += n
        t1 = time.monotonic()
        _dp_kernels(dp, tp, calls, results)
        del calls
        log(f"phase dp ({dp}, {tp}): {time.monotonic() - t0:.1f}s "
            f"(rank 0 init {outs[0]['init_s']:.1f}s; kernels "
            f"{time.monotonic() - t1:.1f}s)")
    t0 = time.monotonic()
    _dp_launcher(smi)
    log(f"phase dp launcher: {time.monotonic() - t0:.1f}s")
    return launches, results


# ---------------------------------------------------------------------------
# phase 15: training
# ---------------------------------------------------------------------------
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--steps", "10", "--batch", "8",
              "--seq", "128", "--log-every", "1"]
CPU_BATCH = 4                         # (b)'s rows: the CPU's share of time
LORA_RANK = 16
LORA_STEPS = 10
TUNED = f"tuned-r{LORA_RANK}"


def _step_times(log_):
    """Median seconds a step over steps 2.. of a training log (step 1
    holds the first calls' set-up)."""
    s = [m["seconds"] for m in log_]
    return statistics.median(b - a for a, b in zip(s, s[1:]))


def _train_full(dev, smi):
    """(a) ``python -m repro_torch.launch.train`` at internlm2-1.8b full
    width and depth, fp32, through its ``main`` in this process."""
    import contextlib
    import io
    from repro_torch.launch import train
    from repro_torch.training import lr_schedule
    torch.cuda.reset_peak_memory_stats(dev)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hist = train.main(TRAIN_ARGV)
    peak = torch.cuda.max_memory_allocated(dev)
    out = buf.getvalue().splitlines()
    for line in out:
        log(f"train (a) | {line}")
    steps = [ln for ln in out if ln.startswith("step")]
    assert len(hist) == len(steps) == 10, (len(hist), len(steps))
    args = train.parse_args(TRAIN_ARGV)
    opt = train.opt_config(args)
    for m, line in zip(hist, steps):
        assert math.isfinite(m["loss"]) and m["grad_norm"] > 0, m
        lr = float(lr_schedule(opt, torch.tensor(m["step"])))
        assert f"lr={lr:.2e} " in line, (line, lr)
    step_s = _step_times(hist)
    b, sq = args.batch, args.seq
    log(f"train (a) {out[0]} fp32, {len(hist)} steps of {b} x {sq} | {smi}: "
        f"loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, every loss "
        f"finite, grad_norm > 0, printed lr == lr_schedule; step_ms="
        f"{step_s * 1e3:.1f} (median of steps 2-10) tok_s="
        f"{b * sq / step_s:.0f} peak_gb={peak / 1e9:.2f}")


def _max_rel(a, b):
    """max |a - b| over max |b| (b the reference)."""
    return ((a.float() - b.float()).abs().max()
            / b.float().abs().max().clamp_min(1e-30)).item()


def _train_card_vs_cpu(dev, smi):
    """(b) one fp32 step of internlm2-1.8b at full width and 2 layers from
    the same weights and batch on the card and on the CPU path the tests
    hold against JAX. AdamW's eps is 1e-3 here: its first step is g / (|g|
    + eps), a sign where |g| >> eps, and a gradient entry within the two
    devices' rounding of 0 would flip its step by 2 lr; with eps 1e-3 the
    step is a smooth function of the gradient, so the updated leaves
    compare what the gradients are."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      make_train_step)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=2)
    t0 = time.monotonic()
    cpu = M.init_params(cfg, 0, device="cpu")
    card = copy.deepcopy(cpu).to(dev)
    toks, labels = next(SyntheticLM(DataConfig(
        cfg.vocab_size, 128, CPU_BATCH)).batches())
    opt_cfg = AdamWConfig(lr=1e-3, eps=1e-3, warmup_steps=0,
                          weight_decay=0.01)
    step = make_train_step(cfg, opt_cfg)
    res = {}
    for name, params in (("card", card), ("cpu", cpu)):
        d = params.embed.device
        batch = {"tokens": torch.from_numpy(toks).to(d),
                 "labels": torch.from_numpy(labels).to(d)}
        t1 = time.monotonic()
        params, opt, m = step(params, adamw_init(params), batch)
        res[name] = (params, opt, {k: float(v) for k, v in m.items()},
                     time.monotonic() - t1)
    (pc, oc, mc, tc), (pp, op, mp, tpu) = res["card"], res["cpu"]
    for k in ("loss", "grad_norm", "lr"):
        assert abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]), (k, mc[k], mp[k])
    worst = {}
    for what, a, b in (("param", dict(pc.named_parameters()),
                        dict(pp.named_parameters())),
                       ("mu", oc["mu"], op["mu"]), ("nu", oc["nu"], op["nu"])):
        errs = {k: _max_rel(a[k].cpu(), b[k]) for k in b}
        k = max(errs, key=errs.get)
        worst[what] = (k, errs[k])
        assert errs[k] <= 1e-4, (what, k, errs[k])
    # the guard's proof on the card: attention passes its gradient back
    for i in range(cfg.n_layers):
        for w in ("wq", "wk", "wv"):
            g = oc["mu"][f"blocks.{i}.attn.{w}"]
            assert g.abs().max() > 0, f"blocks.{i}.attn.{w}: no gradient"
    log(f"train (b) {cfg.name} full width, 2 layers, fp32, one step of "
        f"{CPU_BATCH} x 128 | {smi}: loss card {mc['loss']:.6f} cpu "
        f"{mp['loss']:.6f}, grad_norm card {mc['grad_norm']:.6f} cpu "
        f"{mp['grad_norm']:.6f}; worst leaf (|card - cpu| / max |cpu|): "
        + ", ".join(f"{w} {k} {e:.3e}" for w, (k, e) in worst.items())
        + f" (tol 1e-4); every wq, wk, wv has a nonzero gradient on the "
        f"card; step card {tc * 1e3:.1f} ms, cpu {tpu:.1f} s; phase "
        f"{time.monotonic() - t0:.1f}s")


def _digest(params):
    """A per-leaf digest of a module's bits: the sum of its 16- or 32-bit
    words and their sum weighted by position mod 1021."""
    out = {}
    for k, p in params.named_parameters():
        w = p.detach().reshape(-1).view(
            torch.int16 if p.element_size() == 2 else torch.int32).long()
        pos = torch.arange(w.numel(), device=w.device) % 1021 + 1
        out[k] = (int(w.sum()), int((w * pos).sum()))
    return out


def _train_lora_serve(dev, smi, results):
    """(c) llama-7b-paper at full width and depth: a bf16 base (frozen)
    and an fp32 adapter of rank 16 on q/k/v/o, ``make_lora_train_step``
    for 10 steps of 8 x 128; the tuned adapter saved, reloaded and served
    beside phase 2's seeded adapters on phase 2's trace and two requests
    of its own, padded and bucketed, decode blocks 1 and 4, through B1,
    B2 and B5. Returns the serve runs' launches."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.lora.adapter import init_adapter
    from repro_torch.models import model as M
    from repro_torch.training import (AdamWConfig, adamw_init,
                                      load_checkpoint, make_lora_train_step,
                                      save_checkpoint)
    cfg = get_config("llama-7b-paper")
    params = _init_model(cfg, dev, tag="train (c)")
    digest = _digest(params)
    adapter = init_adapter(cfg, LORA_RANK,
                           torch.Generator(device=dev).manual_seed(7))
    opt = adamw_init(adapter)
    step = make_lora_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2,
                                                 total_steps=LORA_STEPS))
    it = SyntheticLM(DataConfig(cfg.vocab_size, 128, 8, seed=99)).batches()
    torch.cuda.reset_peak_memory_stats(dev)
    losses, times = [], [time.monotonic()]
    for i in range(LORA_STEPS):
        toks, labels = next(it)
        adapter, opt, m = step(adapter, opt, params, {
            "tokens": torch.from_numpy(toks).to(dev),
            "labels": torch.from_numpy(labels).to(dev)})
        losses.append(float(m["loss"]))
        times.append(time.monotonic())
        if i == 0:
            for t in cfg.lora.targets:
                assert opt["mu"][t]["B"].abs().max() > 0, \
                    f"{t}: B got no gradient"
                assert not opt["mu"][t]["A"].any(), \
                    f"{t}: A got a gradient while B was 0"
    peak = torch.cuda.max_memory_allocated(dev)
    assert all(math.isfinite(x) for x in losses), losses
    assert _digest(params) == digest, "the frozen base changed"
    for t in cfg.lora.targets:
        assert adapter[t]["B"].abs().max() > 0, f"{t}: B still 0"
    step_s = statistics.median(b - a for a, b in zip(times[1:], times[2:]))
    log(f"train (c) {cfg.name} bf16 base (frozen, digest unchanged), fp32 "
        f"adapter rank {LORA_RANK} on {'/'.join(cfg.lora.targets)}, "
        f"{LORA_STEPS} LoRA steps of 8 x 128 | {smi}: step 1 gave every B "
        f"a gradient and every A none; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; step_ms={step_s * 1e3:.1f} (median of steps "
        f"2-{LORA_STEPS}) tok_s={8 * 128 / step_s:.0f} peak_gb="
        f"{peak / 1e9:.2f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "adapter.msgpack")
        save_checkpoint(path, adapter)
        tuned = load_checkpoint(path, adapter)
    for t in adapter:
        for k in ("A", "B"):
            assert torch.equal(tuned[t][k], adapter[t][k])
            assert not tuned[t][k].requires_grad
    # phase 2's trace and two 64-token requests of the tuned adapter
    trace, ranks, weights = _serve_trace(cfg, 8, dev)
    rng = random.Random(15)
    trace = trace + [(TUNED, [rng.randrange(1, cfg.vocab_size)
                              for _ in range(64)], 16) for _ in range(2)]
    weights[TUNED] = tuned
    rec = MainPathCalls(widths=True)
    launches, engines = _moe_engine_runs(
        dev, cfg, params, trace, weights,
        [(m, db) for m in ("padded", "bucketed") for db in (1, 4)], smi, rec,
        tag="train (c)")
    lg = _group_logits(cfg, engines["padded"], trace, 64)
    assert torch.equal(lg, _group_logits(cfg, engines["bucketed"], trace,
                                         64))
    del engines
    _free()
    rows = [i for i, (aid, p, _) in enumerate(
        [x for x in trace if len(x[1]) == 64]) if aid == TUNED]
    toks = torch.tensor([p for aid, p, _ in trace if aid == TUNED],
                        device=dev)
    bank = {t: {k: v[:, None] for k, v in d.items()}
            for t, d in tuned.items()}
    with torch.no_grad():
        h, _ = M.forward(cfg, params, toks, bank=bank,
                         lora_idx=torch.zeros(len(toks), dtype=torch.int32,
                                              device=dev))
        ref = (h[:, -1].float() @ M.lm_head(cfg, params).float()).cpu()
    got = lg[rows]
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    log(f"train (c) the tuned adapter served: its tokens equal in all 4 "
        f"runs, first group's logits padded == bucketed bit for bit; its "
        f"rows' first-prefill logits vs the einsum forward with the same "
        f"adapter: max abs diff {err:.4e} of max |logit| {scale:.4f} "
        f"({err / scale:.3%}; tol 5e-2 of it), argmax agree "
        f"{(got.argmax(-1) == ref.argmax(-1)).tolist()}")
    assert err <= 5e-2 * scale, (err, scale)
    del params, adapter, tuned, opt
    _free()
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    d = cfg.d_model
    for kid, name in (("B1", "sgmv_fused_blocks"),
                      ("B2", "sgmv_multibank_blocks")):
        args, kw, dest = rec.calls[(name, "decode", d, d)]
        _check_and_time(kid, "trained-decode", args, kw, dest, flush,
                        results)
        _yardstick(kid, "trained-decode", args, kw, dest, flush)
    del flush
    return launches


def phase_train(dev, smi):
    """Phase 15. Returns (the launches of (c)'s serve runs, the kernels'
    results on the trained bank)."""
    results = {}
    for part in (_train_full, _train_card_vs_cpu):
        t0 = time.monotonic()
        part(dev, smi)
        _free()
        log(f"phase train {part.__name__}: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    launches = _train_lora_serve(dev, smi, results)
    _free()
    log(f"phase train _train_lora_serve: {time.monotonic() - t0:.1f}s")
    return launches, results


TOOLS_ARCH = "llama-7b-paper"
TOOLS_SHAPE = ("card", 1024, 8, "decode")      # (c)'s cache: 8 x 1024
TOOLS_TIMEOUT = 900                          # seconds, each subprocess
# each example and the lines its stdout must hold: quickstart's five
# requests each with its tokens and all five finished; serve_cluster's
# mini cluster with its ten requests finished and the pool's invariant
EXAMPLES = {
    "quickstart": [r"^request \d+ \([^)]*\): tokens \[\d+(, \d+)*\]$"] * 5 +
                  [r"^metrics: \{'finished': 5,"],
    "serve_cluster": [r"^finished=10/10 .* invariant=OK$"],
}
DRYRUN_PROCS = 2                             # dry-run processes, (b)


def _tools_env():
    root = Path(__file__).resolve().parent
    return root, dict(os.environ, PYTHONPATH=str(root / "src"))


def _tools_measured_case(dev, smi):
    """(c) llama-7b-paper at full width, bf16, the dry-run's 8 rank-64
    adapters and a decode cache of 8 x 1024, built on the card by the
    dry-run's own ``launch/specs.py:build_case``: the bytes
    the allocator holds for it against the dry-run's argument bytes, and
    one decode step timed over CUDA events beside the dry-run's roofline
    terms for the same case."""
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch import dryrun, mesh, specs
    cfg = get_config(TOOLS_ARCH)
    shape = InputShape(*TOOLS_SHAPE)
    roof = mesh.roofline(dev)
    meta = specs.build_case(cfg, shape, (1, 1), device="meta")
    with torch.no_grad():
        counter, _ = dryrun.flop_count(meta.fn, *meta.args)
    t_compute = counter.total / roof.flops(torch.bfloat16)
    t_memory = counter.hbm_bytes / roof.hbm_bytes_per_s
    want = sum(meta.arg_bytes.values())
    _free()
    torch.cuda.synchronize(dev)
    stats0 = torch.cuda.memory_stats(dev)
    case = specs.build_case(cfg, shape, (1, 1), device=dev)
    torch.cuda.synchronize(dev)
    stats1 = torch.cuda.memory_stats(dev)
    assert case.arg_bytes == meta.arg_bytes, (case.arg_bytes,
                                              meta.arg_bytes)
    n = len(case.tensors())
    held = stats1["allocated_bytes.all.current"] - \
        stats0["allocated_bytes.all.current"]
    asked = stats1.get("requested_bytes.all.current", 0) - \
        stats0.get("requested_bytes.all.current", 0)
    log(f"tools (c) {cfg.name} bf16, {specs.DRYRUN_N_ADAPTERS} adapters "
        f"of rank {specs.DRYRUN_MAX_RANK}, cache {shape.global_batch} x "
        f"{shape.seq_len} | {smi}: argument bytes {want} "
        f"({case.arg_bytes}); the allocator holds {held} B in {n} "
        f"tensors (requested {asked} B); {held - want} B over, the "
        f"rounding allows < {512 * n}")
    assert want <= held < want + 512 * n, (want, held, n)
    if "requested_bytes.all.current" in stats1:
        assert asked == want, (asked, want)
    with torch.no_grad():
        logits, _ = case.fn(*case.args)
        torch.cuda.synchronize(dev)
        assert logits.shape == (shape.global_batch, cfg.vocab_size)
        assert torch.isfinite(logits).all()
        times = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            case.fn(*case.args)
            b.record()
            torch.cuda.synchronize(dev)
            times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    log(f"tools (c) one decode step (the dry-run's callable: einsum LoRA, "
        f"plain decode attention) {ms:.3f} ms median of 10 over CUDA "
        f"events; the dry-run's t_memory {t_memory * 1e3:.4f} ms "
        f"({counter.hbm_bytes} B of eager traffic), t_compute "
        f"{t_compute * 1e3:.4f} ms ({counter.total:.4e} FLOP) at "
        f"{roof.name}'s data sheet | {smi}")
    _tools_profile(case)
    del case, logits
    _free()


def _tools_profile(case, top=8):
    """(c)'s decode step once under ``torch.profiler``: the device time of
    its kernels by the aten op that launched them, the largest ``top``
    printed, beside the step's time on the host's clock."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.no_grad(), torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        case.fn(*case.args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = prof.key_averages()
    ops = sorted((e for e in evs if e.device_type ==
                  torch.autograd.DeviceType.CPU and
                  e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)
    kernels = sum(e.count for e in evs
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    busy = sum(e.self_device_time_total for e in ops) / 1e3
    log(f"tools (c) profile of one step: {wall:.3f} ms on the host's "
        f"clock under the profiler, {busy:.3f} ms of kernels ({kernels} "
        f"launches; idle share {1 - busy / wall:.3f})")
    for e in ops[:top]:
        log(f"tools (c)   {e.key}: {e.self_device_time_total / 1e3:.3f} ms "
            f"of kernels in {e.count} calls")


def phase_tools(dev, smi):
    """Phase 16: the tools. (c) measures a dry-run case on the card first,
    alone; then (a) ``python -m repro_torch.analysis`` (lint, smem on the
    card's own attributes, protocol) and (b) ``python -m
    repro_torch.launch.dryrun --mesh single`` over every arch (dealt to
    ``DRYRUN_PROCS`` processes) run as subprocesses while (d) runs both
    examples on the card and checks what they print."""
    root, env = _tools_env()
    out_dir = Path(tempfile.mkdtemp(prefix="dryrun-"))
    t0 = time.monotonic()
    _tools_measured_case(dev, smi)
    log(f"phase tools (c): {time.monotonic() - t0:.1f}s")
    procs = {}
    try:
        procs["a"] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.analysis"], cwd=root,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        from repro_torch.configs import ARCH_IDS
        for i in range(DRYRUN_PROCS):       # the archs dealt out in turn
            procs[f"b{i}"] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", ",".join(ARCH_IDS[i::DRYRUN_PROCS]), "--shape",
                 "all", "--mesh", "single", "--out", str(out_dir),
                 "--case-timeout", "300"], cwd=root, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, wanted in EXAMPLES.items():
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", f"repro_torch.examples.{name}"],
                cwd=root, env=env, capture_output=True, text=True,
                timeout=TOOLS_TIMEOUT)
            lines = proc.stdout.splitlines()
            for line in lines:
                log(f"tools (d) {name}: {line}")
            assert proc.returncode == 0, (name, proc.stderr[-3000:])
            for pattern in set(wanted):
                n = sum(bool(re.search(pattern, x)) for x in lines)
                assert n == wanted.count(pattern), (name, pattern, n)
            log(f"tools (d) {name} exited 0 on the card in "
                f"{time.monotonic() - t0:.1f}s, its {len(wanted)} checked "
                f"lines as expected")
        t0 = time.monotonic()
        out, err = procs["a"].communicate(timeout=TOOLS_TIMEOUT)
        for line in (err + out).splitlines():
            log(f"tools (a) {line}")
        assert procs["a"].returncode == 0, procs["a"].returncode
        assert "smem[" in err and "protocol[" in err
        log(f"tools (a) python -m repro_torch.analysis exited 0 "
            f"(lint, smem on the card's attributes, protocol); waited "
            f"{time.monotonic() - t0:.1f}s more")
        t0 = time.monotonic()
        for i in range(DRYRUN_PROCS):
            proc = procs[f"b{i}"]
            out, _ = proc.communicate(timeout=TOOLS_TIMEOUT)
            for line in out.splitlines():
                log(f"tools (b) {line}")
            assert proc.returncode == 0, proc.returncode
        _tools_report(out_dir)
        log(f"tools (b) waited {time.monotonic() - t0:.1f}s more")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _tools_report(out_dir):
    """(b): every case ok or refused (C5); ``report.py``'s two tables,
    llama-7b-paper's rows printed."""
    from repro_torch.configs import ARCH_IDS, INPUT_SHAPES
    from repro_torch.launch import report
    ok = sorted(out_dir.glob("*.json"))
    refused = sorted((out_dir / "refused").glob("*.json"))
    assert len(ok) + len(refused) == len(ARCH_IDS) * len(INPUT_SHAPES), \
        (len(ok), len(refused))
    for p in refused:
        assert json.loads(p.read_text())["status"] == "refused (C5)", p
    arts = report.load(str(out_dir))
    for table in (report.roofline_table(arts, mesh="16x16"),
                  report.dryrun_table(arts)):
        lines = table.splitlines()
        for line in lines[:2] + [x for x in lines if TOOLS_ARCH in x]:
            log(f"tools (b) {line}")
    log(f"tools (b) {len(ok)} cases ok, {len(refused)} refused (C5): "
        f"{[p.stem for p in refused]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = gpu_line()
    log(f"device: {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | TF32 off (matmul and cuDNN)")
    t0 = time.monotonic()
    build.build(verbose=True)            # the ptxas report, when it builds
    build.load_library()
    log(f"build: {build.library_path().name} from "
        f"{sorted(p.name for p in build.CSRC.glob('*.cu'))} in "
        f"{time.monotonic() - t0:.1f}s")

    t0 = time.monotonic()
    cfg, launches, calls, banks, tp_ref, params, einsum = phase_engine(dev)
    log(f"phase engine: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    phase_cluster(dev, cfg, params, smi)
    log(f"phase cluster: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    gw_launches = phase_gateway(dev, cfg, params, smi)
    log(f"phase gateway: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in gw_launches.items() if v} }")
    _noise_floor(cfg, params, dev, tp_ref, einsum)
    del params
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    kres = phase_kernels(dev, calls)
    log(f"phase kernels: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    launches.update(phase_unfused(dev, cfg, calls, banks))
    log(f"phase unfused: {time.monotonic() - t0:.1f}s")
    # the bucketed dispatcher's calls, with the block_t B2 ran them at
    b2_calls = {layout: calls[("sgmv_bucketed_fused", layout)][:2] + (
        calls[("sgmv_multibank_blocks", layout)][1]["block_t"],)
        for layout in ("decode", "prefill")}
    del calls, banks
    torch.cuda.empty_cache()
    t0 = time.monotonic()
    fp32_ref = phase_parity(dev)
    log(f"phase parity: {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    tp_launches, tp_calls = phase_tp(cfg, tp_ref, fp32_ref)
    # B4a/B4b run on the tensor-parallel path only; the other kernels
    # keep the counts of their own paths (phases 2 and 4)
    launches.update({kid: tp_launches[kid] for kid in ("B4a", "B4b")})
    log(f"phase tp: {time.monotonic() - t0:.1f}s; rank 0's launches "
        f"{tp_launches}")
    t0 = time.monotonic()
    kres.update(phase_split(dev, cfg, tp_calls, b2_calls))
    log(f"phase split: {time.monotonic() - t0:.1f}s")
    del tp_calls, b2_calls
    _free()
    t0 = time.monotonic()
    moe_launches, moe_res = phase_moe(dev, smi)
    kres.update(moe_res)
    for kid, n in moe_launches.items():
        launches[kid] += n
    log(f"phase moe: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in moe_launches.items() if v} }")
    t0 = time.monotonic()
    rec_launches, rec_res = phase_recurrent(dev, smi)
    kres.update(rec_res)
    for kid, n in rec_launches.items():
        launches[kid] += n
    log(f"phase recurrent: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in rec_launches.items() if v} }")
    t0 = time.monotonic()
    xf_launches, xf_res = phase_encdec_vlm(dev, smi)
    kres.update(xf_res)
    for kid, n in xf_launches.items():
        launches[kid] += n
    log(f"phase encdec: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in xf_launches.items() if v} }")
    _free()
    t0 = time.monotonic()
    fam_launches, fam_res = phase_tp_families(dev, smi)
    kres.update(fam_res)
    for kid, n in fam_launches.items():
        launches[kid] += n
    log(f"phase tpfam: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in fam_launches.items() if v} }")
    _free()
    t0 = time.monotonic()
    dp_launches, dp_res = phase_dp(dev, smi, fp32_ref)
    kres.update(dp_res)
    for kid, n in dp_launches.items():
        launches[kid] += n
    log(f"phase dp: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in dp_launches.items() if v} }")
    _free()
    t0 = time.monotonic()
    train_launches, train_res = phase_train(dev, smi)
    kres.update(train_res)
    for kid, n in train_launches.items():
        launches[kid] += n
    log(f"phase train: {time.monotonic() - t0:.1f}s; launches "
        f"{ {k: v for k, v in train_launches.items() if v} }")
    _free()
    t0 = time.monotonic()
    phase_tools(dev, smi)
    log(f"phase tools: {time.monotonic() - t0:.1f}s")

    rows = []
    for kid, (kname, src, replaces) in KERNELS.items():
        # as the path ran it: a decode step's call for the SGMV kernels,
        # the 1000-token prefill group's for B5
        layout = "prefill" if kid == "B5" else "decode"
        r = kres[(kid, layout, torch.bfloat16)]
        assert launches[kid] > 0, f"{kid} {kname} never launched on its path"
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": launches[kid],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
