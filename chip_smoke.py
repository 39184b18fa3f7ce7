#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --index-widths   # device, build, index_widths only
    python3 chip_smoke.py --sharded-sweep  # device, build, the sweep's split
    python3 chip_smoke.py --train-probe    # device, build, train_probe
    python3 chip_smoke.py --sharded-train  # device, build, train_entry,
                                           # sharded_train, sharded_rwkv,
                                           # split_decode
    python3 chip_smoke.py --dryrun-only    # device, build, dryrun_arch
    python3 chip_smoke.py --examples-only  # device, build, examples

Phases, each printing one JSON line:

  device       the card's name and power limit (nvidia-smi), torch's name
  build        nvcc-builds the two domain-map kernels, tri_attn and wkv
               from their csrc/ directories, one nvcc each, all in parallel
  kernels      every domain: the map kernel against its plain torch version
               at λ in [0, 2^22), near 2^31 and near 5e8, at an odd start
               with n not a multiple of 4 (unaligned rows, a ragged run),
               and for the peel domains with a 32-bit path (m >= 4) on both
               sides of their 32-bit bound and across it, and through the
               64-bit path forced at small λ; the membership
               kernel on a box of about 2^22 cells (also through the forced
               64-bit path) and on a box with odd extents whose padded total
               wraps — exact equality
  paper_scale  the paper's N = 5e8 (benchmarks/block_dense.py) through the
               mapped launcher for all 12 domains, checked against the
               plain version in chunks of 2^26 λ; BB membership for tri2d,
               pyramid3d (3.0e9 cells) and four full fractal levels,
               checked against the plain version and by member count; the
               kernels' median times (CUDA events) beside their bounds
  evaluate     a heterogeneous EvaluationService batch on the card, held
               against the port's own CPU path and its binary frame
  derive       the derive path: run_grid over the paper's measured grid
               (6 domains x 11 models x 3 stages, MockLLMBackend, 10^6
               ground-truth points, one in 100 checked) into a fresh
               TieredStore under build/, its wall time split by the
               obs.trace spans; the deployable cells exactly the 34 the
               paper's tables mark compiled and 100% ordered, none of
               menger3d, each perfect cell's complexity class the one its
               logic implies; a second pass over the same store (198 hits,
               no generate call, no validation); each of the 34 artifacts
               launched through the map kernel at N = 5e8, bit-identical
               to its domain's ground-truth launch and equal to its own
               scalar map on 10^4 λ, the median of 10 single calls per
               domain beside its byte bound, block counts and the paper's
               A100 model beside the card's mapped and BB times; key
               queries through an EvaluationService resolving over the
               store, byte-equal to domain queries, and the three refusals
               (not deployable, unknown, malformed) before any launch; the
               dry-run entry point (repro_torch.launch.dryrun --domain-map
               tri2d exits 0, menger3d exits 1)
  serve        evaluation serving: the asyncio and the threaded frontend in
               process, each a MappingService (mock backend behind the
               batching queue) over a fresh TieredStore under build/; per
               frontend the evaluate batch as a binary frame through
               RemoteMappingService, cold, warm and off the wire LRU,
               bit-identical to the in-process batch with equal metadata;
               POST /v1/derive of the paper's 34 deployable cells, then key
               queries at 2^21 points equal to the domain queries, and the
               three refusals (400, 404, 400) with no launch; a binary sweep
               stream over the 12 domains x [2^20, 2^21]; four concurrent
               clients; the sweep's λ-range split (two shards on one card,
               one per card on several), each shard a map-kernel launch;
               then python -m repro_torch.launch.serve --serve-maps (async)
               and --no-async as subprocesses: URL from the first line,
               /healthz, the 12 x 2^21 map batch, SIGINT, exit 0
  examples     the five scripts of examples_torch/ on the card, each main()
               in process with the reference's default arguments (its
               printed lines into build/examples/, its wall s on a line of
               its own): quickstart (a perfect tri2d map; tri_attn on the
               simt route in fp32 within ATTN_TOL of causal_attention_ref;
               grid steps 16 -> 10), fractal_compute (the map and BB
               membership kernels on the six fractals at N = 16384: every
               row bijective, the BB count the mapped count), derive_and_deploy
               in process (client 2 derives nothing) and with --url against
               python -m repro_torch.launch.serve --serve-maps (client 2 all
               server-side hits; SIGINT, exit 0), serve_lm (yi-6b smoke,
               tokens generated) and train_lm (the small preset: final loss
               finite and below the first logged); their map, membership
               and simt launches into the kernels line; then python
               examples_torch/quickstart.py as a subprocess: exit 0, its
               last line the in-process run's
  attention    the tri_attn kernel on both routes and in both grid modes
               against its plain versions (tests/test_kernels_tri_attn.py's
               sweep, GQA): the simt route (fp32; other bf16 shapes; strips
               of G key blocks) mapped bit-identical to BB, also in fp32
               at the LM shape at block 128 and at (1, 32, 4 kv, 2048, 128)
               at block 64 with G > 1 (every row within 3e-5 of
               causal_attention_ref and of attention_pairs_plain at the
               card's G), in bf16 at the LM shape at block 64 (G 16; late
               rows against causal_attention_ref, every row against
               attention_pairs_plain, as sm90's), and its B·H split
               bit-identical to one launch; the
               sm90 route (bf16, block 128, head_dim 64/128) at the LM shape
               and a GQA D 64 case against causal_attention_ref (late rows
               too) and attention_stream_plain, at several cells per CTA,
               each mode bitwise equal over two runs, mapped within bf16
               tolerance of BB; the device-side staircase map λ -> (i, g)
               exact against int64 torch for every λ < T(65535) at G = 1,
               every λ < C(65535, G) at G = 8 and 16, and in windows
               across 2^31 and at 2^33 for G = 1, 2, 3, 8, 16; a gradient
               check; at the LM
               path's shape each route's median time beside the bound, the
               plain version's and scaled_dot_product_attention's (the
               yardstick only): sm90 in bf16, simt in bf16 at block 64 and
               in fp32 at block 128 (device ms, calls back to back; its bound
               three TF32 products a flop pair, fp32 SDPA beside it), each
               simt case also at G = 1, 4, 8, 16, 32 (held to ATTN_TOL);
               both routes' registers and spills
  lm_forward   yi-6b at full width (bf16, random weights from a seeded
               torch.Generator), tokens (1, 4096): forward and lm_loss with
               attn_impl pallas_mapped, pallas_bb and xla, and a forward at
               attn_block 64 (the simt route, one strip launch a layer);
               every kernel forward's logits held against xla, mapped
               against BB; 32 sm90 launches per block-128 kernel forward
  xla_mapped   the same weights and tokens under attn_impl="xla_mapped"
               (the mapped block-pair attention in plain torch): forward
               and lm_loss against xla and pallas_mapped with lm_forward's
               logit, CE and top-1 gates, wall s and peak of each; one
               layer's gradients of x and wq, wk, wv, wo in fp32 against
               xla's (XLA_MAPPED_GRAD_RTOL)
  trace_split  launch.hlo_analysis.analyze on a torch.profiler trace of a
               kernel forward (1, 4096; 32 ta_sm90_kernel events) and of
               one decode step at batch 4 after a 512-token prefill: the
               device's busy share, time by category (own kernels, library
               products, other kernels, NCCL, copies), launches per kernel
               name, the three longest idle gaps with their host ops
  lm_generate  engine.generate at full width, batch 4, prompt 512, 32 greedy
               tokens; prefill and decode_step held against forward; then
               the LM demo entry point (repro_torch.launch.serve --arch yi-6b)
  vlm_forward  llama-3.2-vision-11b at full width (bf16, random weights
               from a seeded torch.Generator, every xattn_gate set to 0.5),
               tokens (1, 4096), stub vision states (1, 4100, 4096): forward
               and lm_loss under pallas_mapped, pallas_bb and xla, 32 sm90
               launches per kernel forward (none from the 8 cross layers),
               kernel logits held against xla and mapped against BB; one
               cross layer on its own inputs against the same layer in fp32
  vlm_generate engine.generate at batch 4, prompt 512, 32 greedy tokens,
               vision states (4, 4100, 4096); prefill and the first decode
               step held against forward; then the LM demo (--arch
               llama-3.2-vision-11b)
  whisper_forward whisper-medium at full width (bf16), stub frames
               (8, 1500, 1024), decoder tokens (8, 384): forward and lm_loss
               in the three modes, 24 sm90 launches per kernel forward,
               gates as vlm's; at 448 tokens no launch and the xla path;
               tri_attn at the decoder's shape (B·H 128, S 384, D 64)
               timed beside its bound and SDPA's time
  whisper_generate batch 4, prompt 64, 32 greedy tokens: the cross k/v that
               prefill caches equal a fresh projection of the encoder
               states; prefill and the first decode step against forward;
               then the LM demo (--arch whisper-medium)
  engine_serve EngineBackend on the card (the yi-6b smoke config, as the
               reference's): generate_batch against singles, decode steps
               and measured seconds; then python -m repro_torch.launch.serve
               --serve-maps --backend engine (asyncio: continuous batching)
               and --no-async as subprocesses: the paper's 6 domains
               derived by 4 concurrent clients, every record deployable,
               key queries at 2^21 points bit-identical to the domain
               queries, continuous-batching occupancy above 1 under asyncio,
               SIGINT, exit 0
  wkv          the wkv kernels (three a call: chunk states, state scan,
               chunk outputs) against their plain composition and the
               recurrence oracle (tests/test_kernels_wkv.py's cases in
               fp32, bf16 and bf16 in / fp32 out, the LM shapes
               (40, 4096, 64) and (160, 512, 64) in fp32 and bf16 in / fp32
               out), each of the three kernels against its own plain phase
               at the LM shape, two calls chained through the state equal
               to one, strong decays finite, the (B, S, H, D) strided path
               bit-identical to the contiguous call and o's two layouts to
               each other, a gradient check, the kernels' registers and
               spills, and at the LM shape the median time beside the bound
               and the plain version's, fp32 in / out and the main path's
               bf16 in / fp32 out
  rwkv_forward rwkv6-3b at full width (bf16, random weights from a seeded
               torch.Generator), tokens (1, 4096): forward and lm_loss, 32
               wkv launches per forward, three kernels issued by each (as
               the C entry reports them); every layer's kernel call held
               against the plain version on its own inputs; logits held
               against the same forward with the plain wkv on the card,
               beside a 1e-6 noise forward, and a faulty wkv (the state
               lost at S/2) that must fail that gate
  rwkv_generate engine.generate at full width, batch 4, prompt 512, 32
               greedy tokens: 32 wkv launches in prefill, none in decode;
               prefill bit-identical to forward, the first decode step
               against a forward over prompt + token, every layer's prefill
               time mix against the scan oracle on its own inputs; then the
               LM demo (--arch rwkv6-3b --prompt-len 64)
  moe_forward  moonshot-v1-16b-a3b at full width (bf16, random weights from
               a seeded torch.Generator), tokens (1, 4096): forward and
               lm_loss under pallas_mapped, pallas_bb and xla, 48 sm90
               launches per kernel forward, CE against xla; the logits and
               top-1 printed beside the routing flips and capacity drops of
               each forward, not gated (a flip reroutes a token); every
               layer on its own input: the attention core under both kernel
               modes against xla (per-row gate), the MoE branch against the
               layer with fp32 experts (equal routing), with controls; the
               expert products read the weights in place and moe_apply
               never syncs; tri_attn at (B·H 16, S 4096, D 128) timed
  moe_generate engine.generate at batch 4, prompt 512, 32 greedy tokens,
               drops per pass; a second prefill and decode step give
               generate's tokens; whole-model prefill / decode against
               forward printed, not gated; every layer of prefill and of
               the first decode step against the cache-less layer on the
               same inputs (decode at a capacity that drops nothing), a
               one-short RoPE control; then the LM demo (--arch
               moonshot-v1-16b-a3b)
  hybrid_forward zamba2-1.2b at full width (bf16), tokens (1, 4096): the
               lm_forward gates, 6 sm90 launches per kernel forward (one per
               firing of the shared block); two Mamba2 layers' SSD, chunked
               against the scan on their own inputs, with a restart
               control; tri_attn at (B·H 32, S 4096, D 64) timed
  hybrid_generate batch 4, prompt 512 (the chunked SSD), 32 greedy tokens
               (the scan): prefill and the first decode step against
               forward, one k/v cache per firing; then the LM demo (--arch
               zamba2-1.2b --prompt-len 64)
  mla_forward  deepseek-v2-236b at full width cut to 6 of its 60 layers
               (bf16, random weights from a seeded torch.Generator), tokens
               (1, 4096): forward and lm_loss (no tri_attn launch: MLA runs
               _sdpa), CE finite, the logits and each layer's capacity drops
               printed; every layer on its own input: the MLA branch
               against the layer in fp32 (a control with wuk and wuv
               swapped), the MoE branch against fp32 experts (equal
               routing, controls)
  mla_generate engine.generate at batch 4, prompt 512 (the up-projected
               path), 32 greedy tokens (the absorbed path); the MLA cache's
               bytes per token and the decode's weight-read bound; every
               layer's decode step on one cache against mla_absorb="never"
               and against a cache-less pass over prompt + token, a
               one-short RoPE control
  train        llama3.2-3b at full width and depth (bf16, pallas_mapped,
               remat "full"), batch 2 of 4096 in 2 microbatches, 4 steps of
               SyntheticLM: 112 sm90 launches a step (forward and
               recompute), step time, tokens/s, the optimizer's device time
               beside its byte bound, the step's product bound; the first
               step against the same step under xla from the same weights
               and batch; tri_attn's dq, dk, dv bitwise equal to the plain
               route's at (1, 24, 8, 4096, 128); tri_attn timed at the
               training shape; at 4 layers on one set of weights, remat
               "full" against "none", then microbatches 2 against 1 per
               tensor and both against an fp32 witness (a plain-lookup
               control); save, restore and a ResilientLoop with an
               InjectedFailure at 1 layer, bitwise equal to an
               uninterrupted run
  train_entry  python -m repro_torch.launch.train --arch llama3.2-3b
               --steps 3 --batch 2 --seq 4096 --microbatches 2 as a
               subprocess: exit 0, its parameter count and final metrics
  sharded_train  a 1-rank NCCL group (TCPStore on 127.0.0.1) and
               make_local_mesh() (1, 1): the train phase's first step on
               the single-device step, then from the same weights and batch
               on the sharded step with the weights and moments laid out
               as DTensors: loss, grad norm and every parameter bitwise
               (or within 1e-6 relative), 112 sm90 launches counted by the
               wrappers and in the profiler's trace, a second step's time
               and the peak memory; compressed_psum_mean on the embedding
               gradient against the formula in torch, timed; then
               python -m torch.distributed.run --standalone
               --nproc-per-node 1 -m repro_torch.launch.train with
               train_entry's arguments: exit 0, the same parameter count,
               final metrics within 1e-5 relative of train_entry's.  One
               card, so every collective is a 1-rank one; multi-rank
               numerics are held on the CPU (tests/test_torch_distributed.py)
  sharded_rwkv rwkv6-3b at full width (bf16, remat "full"), batch 1 of
               4096 in one microbatch, at SHARDED_RWKV_LAYERS layers: one
               single-device step, then from the same weights and batch
               the sharded step on the same 1-rank NCCL mesh: loss, grad
               norm and every parameter bitwise (or within 1e-6 relative);
               the wkv calls (one a layer in the forward, one in its remat
               recompute) counted by the wrapper; a second step's time and
               the peak memory; a third step under the profiler, each of
               the wkv call's three kernels counted in its trace.  The
               split of rwkv6's layers over model is held on the CPU
               (tests/test_torch_distributed_ssm.py)
  split_decode decode over a cache split along kv_seq, one attention layer
               at full width (SPLIT_DECODE_CASES): yi-6b's GQA with a bf16
               and an int8 cache and deepseek-v2's absorbed MLA, 8 rows
               against 32768 positions in 16 blocks, and zamba2-1.2b's
               shared block, 1 row against 524288 in 256; the cache filled
               from a seeded generator up to a position inside a middle
               block; each block attended as one rank attends it and the
               partial softmaxes combined by models/attention.py's
               combine_partials, against the whole-cache layer within 1e-2
               of max |out|; the new row in exactly that block, bitwise the
               whole cache's; a control (that block normalised alone) that
               must fail; the whole-cache call's, one block's call's and
               the combine's ms, not gated.  The split across ranks is held
               on the CPU (tests/test_torch_distributed_decode.py)
  dryrun_arch  python -m repro_torch.launch.dryrun --arch yi-6b --shape
               train_4k --multi-pod both, --arch deepseek-v2-236b --shape
               decode_32k, --arch rwkv6-3b --shape train_4k, --arch
               zamba2-1.2b --shape train_4k, --arch moonshot-v1-16b-a3b
               --shape decode_32k and --arch zamba2-1.2b --shape long_500k
               (all but the first --multi-pod off) as subprocesses, side by
               side, into build/dryrun (fake tensors on a fake 256/512-rank
               group; the full run starts them before train, so they
               overlap the card's phases): exit 0, each record's analytic
               equal to cell_analytics, FLOPs per device > 0,
               launch.roofline's load_rows and render_markdown over them,
               each cell's seconds; yi-6b's, rwkv6-3b's and zamba2-1.2b's
               train_4k on 16x16 against their caps (FLOPs over
               analytic_flops / 256, peak GB), moonshot's and deepseek's
               decode_32k and zamba2-1.2b's long_500k against their peak
               caps (10, 10 and 2 GB); --all only if those cells say it
               takes under 60 s

then a ``{"kernels": [...]}`` line and, last, ``{"ok": true, ...}``.

  index_widths (only with --index-widths) every paper_scale launch that
               the host sends through a 32-bit path, its median time beside
               the same launch forced through the 64-bit path, the two
               outputs bit-identical
  train_probe  (only with --train-probe) the train phase's 4 steps from
               the same weights at full depth in bf16 at lr 3e-4, 3e-5 and
               3e-6, and at 4 layers at 3e-4 in bf16 and in fp32 (xla):
               loss and grad norm a step, printed, not gated

Any failed check
raises and the script exits non-zero; without a CUDA device it exits 2 and
prints no result.  Nothing here imports JAX or ``repro``.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM device-memory rate and dense bf16 tensor-core rate (NVIDIA data
#: sheet, held in the port's ``core/energy.py``): a kernel's bound is the
#: larger of its bytes (each input read once, each output written once) at
#: the one and its operations at the other; the fp32 rate outside the tensor
#: cores is for the wkv kernel's fp32 work on the LM path, the TF32 rate for
#: tri_attn's fp32 products (three TF32 products each)
from repro_torch.core.energy import (  # noqa: E402
    H100_BF16_FLOPS as BF16_FLOP_PER_S, H100_FP32_FLOPS as FP32_FLOP_PER_S,
    H100_HBM_BW as HBM_BYTES_PER_S, H100_TF32_FLOPS as TF32_FLOP_PER_S,
)
N_PAPER = 500_000_000          # benchmarks/block_dense.py:23
CHUNK = 1 << 26                # λ per plain-version chunk (int64 temps fit)
REPS = 10                      # timed runs per kernel (median reported)
#: the largest full fractal level whose box is <= 2^31 cells
FRACTAL_LEVELS = {"gasket2d": 15, "carpet2d": 9, "sierpinski3d": 10,
                  "menger3d": 6}
#: the BB boxes of paper_scale: the two dense domains at N = 5e8 and the
#: four fractals at FRACTAL_LEVELS
BB_DOMAINS = ("tri2d", "pyramid3d", *FRACTAL_LEVELS)
#: about 2^22 cells per box, by dimension
SMALL_BOX = {2: (2048, 2048), 3: (161, 161, 161), 4: (45,) * 4, 5: (21,) * 5}
#: boxes with odd extents (rows end inside a run); launched with 1029 cells
#: of padding past the box, which wrap around it
ODD_BOX = {2: (1001, 777), 3: (37, 41, 43), 4: (9, 11, 13, 7),
           5: (5, 7, 9, 11, 3)}
ODD_PAD = 1029
#: map launches at an odd start with n not a multiple of 4
ODD_START, ODD_N = 12_345, (1 << 20) + 3
#: tests/test_kernels_tri_attn.py's cases as (B, H, Hk, S, D, block), plus
#: GQA ones and the examples' shapes (examples_torch/train_lm.py's smoke
#: llama at head_dim 8, quickstart.py's); tolerances are that test's (3e-5
#: fp32, 3e-2 bf16)
ATTN_CASES = [(1, 1, 1, 128, 64, 32), (1, 2, 2, 256, 64, 64),
              (2, 1, 1, 128, 128, 32), (1, 1, 1, 256, 32, 128),
              (2, 2, 2, 64, 16, 16), (1, 4, 2, 128, 32, 32),
              (2, 8, 2, 512, 128, 128), (8, 6, 2, 128, 8, 128),
              (1, 4, 4, 512, 64, 128)]
#: bf16 on the sm90 route: P is rounded to bf16 before P·V (the tensor
#: cores' input), and the pieces of a row split across CTAs merge in another
#: order than one CTA's running sum, so the route agrees with the fp32
#: oracle, with its plain version and mapped with BB to this tolerance, not
#: bit for bit
ATTN_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: the LM path's attention: yi-6b's heads at S = 4096, block 128
ATTN_MAIN = (1, 32, 4, 4096, 128, 128)
#: bf16 at that shape, rows S/2 and on: max |kernel - ref| over the row's
#: max |ref|.  Both compute in fp32 and round o to bf16, so they differ by
#: at most one bf16 ulp, 2^-7 of the row's max (7.8e-3) at worst
LATE_ROW_RTOL = 1e-2
#: a bf16 route against its plain version at the same cells, every row:
#: max |Δ| over the row's max |o|.  sm90 and attention_stream_plain both
#: round P to bf16, simt and attention_pairs_plain keep it in fp32; each
#: pair rounds o to bf16 from fp32 sums taken in other orders, so an
#: element differs by about one bf16 ulp, 2^-7 of the row's max at worst;
#: the gate allows two.  A piece or strip dropped, merged twice or
#: rescaled wrongly moves a row by about its share of the keys (1/8 of a
#: row of 8 pieces at ATTN_U_CASE), several times this
PLAIN_ROW_RTOL = 2 * 2.0 ** -7
#: the sm90 route at head_dim 64 with GQA (8 q heads per kv head)
ATTN_GQA64 = (2, 16, 2, 2048, 64, 128)
#: the sm90 route held against attention_stream_plain at the same cells per
#: CTA: U = 1 (every row of nb > 2 split across three or more CTAs), 3 (nb
#: 8: rows of up to 8 steps across up to 4 CTAs), and 2·T(nb) + 1 (a CTA
#: takes more than one (b, h))
ATTN_U_CASE = (1, 4, 2, 1024, 128, 128)
ATTN_U_VALUES = (1, 3, 73)
#: the simt route at yi-6b's heads, S 2048, block 64: in bf16 the B·H
#: split check (the LM shape at block 128 takes the sm90 route), in fp32
#: a case where default_strip gives G > 1 at four warps a cell
ATTN_SPLIT_BF16 = (1, 32, 4, 2048, 128, 64)
LM_SIMT_BLOCK = 64
#: strip lengths G at which the simt route's two ATTN_MAIN cases (bf16
#: block 64, fp32 block 128) are held and timed beside the chooser's G
SIMT_STRIP_SWEEP = (1, 4, 8, 16, 32)
NB_MAP = 65535                 # the λ map is held exact for λ < T(NB_MAP)
#: the staircase map's strip lengths held on the card past 2^31 cells
MAP_STRIPS = (1, 2, 3, 8, 16)
LM_ARCH = "yi-6b"
LM_SEQ = 4096
LM_LAUNCHES = 32               # one tri_attn launch per layer per forward
#: kernel vs plain (xla) forward, bf16 at full width.  Both compute the
#: attention in fp32 and round o to bf16 once, but in other orders, so o
#: differs by about one bf16 ulp here and there, and 32 layers carry that to
#: the logits: max |Δ logit| was 1.5e-2 of max |logit| on an H100.  The gate
#: is twice that.  A control run proves the gate can fail: the kernel
#: forward with one fault of the kind a combine could make (rows S/2 and on
#: lose their j = 0 partial) must land above it.
FWD_LOGIT_RTOL = 3e-2
#: CE and top-1 against xla are the scoring entry point's (lm_loss) own
#: outputs, so they stay gates, though random weights and labels keep CE near
#: ln(vocab) whatever attention returns: the mean over 4096 positions agrees
#: to 1e-2 relative, and top-1 flips only where the two best logits are
#: within the bf16 noise of each other, so 95% of positions agree.
CE_RTOL = 1e-2
TOP1_MIN = 0.95
#: prefill / decode_step against forward ("xla"), bf16 at full width: the
#: same math over other product shapes (a cache of 544 rows against 512,
#: batch rows 4 against 2052) rounds to bf16 at other places; 32 layers
#: carry that to the logits.  Bound: max |Δ logit| <= 5e-2 · max |logit|.
LOGIT_RTOL = 5e-2
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 512, 32
#: xla_mapped against xla, one yi-6b layer in fp32 (TF32 off): the same
#: softmax summed over the block pairs in another order, so the gradients
#: of x and of the attention's weights agree to fp32 rounding; the gate is
#: max |Δ| over the gradient's max
XLA_MAPPED_GRAD_RTOL = 1e-4
#: tests/test_kernels_wkv.py's cases as (B·H, S, D, chunk), then the LM
#: path's shapes: rwkv6-3b's 40 heads at S = 4096 (forward) and at batch 4,
#: S = 512 (generate's prefill).  fp32 o and state are held to that test's
#: 1e-4, also from bf16 r, k, v (the widening is exact).  bf16 o: kernel and
#: plain version compute in fp32 and round o to bf16 once, so they differ by
#: at most one bf16 ulp of the element, at most 2^-7 of the row's max |o|
#: (against the fp32 oracle, half that), plus the fp32 1e-4
WKV_CASES = [(2, 128, 16, 32), (1, 256, 32, 64), (4, 64, 64, 16)]
WKV_MAIN = (40, 4096, 64, 64)
WKV_GEN = (GEN_BATCH * 40, GEN_PROMPT, 64, 64)
WKV_TOL = 1e-4
WKV_BF16_ROW_RTOL = 2.0 ** -7
#: uniform decays w = exp(-exp(dec)) = 0.26, 0.19, 0.066: the reference's
#: chunked form is 0.065 off or non-finite there; the kernel must hold 1e-4
WKV_STRONG = (0.3, 0.5, 1.0)
RWKV_ARCH = "rwkv6-3b"
RWKV_PARAMS = 3_073_313_280
RWKV_SEQ = 4096
RWKV_LAYERS = 32
#: the three kernels of a wkv call, as the profiler's trace names them
WKV_KERNEL_NAMES = ("wkv_states_kernel", "wkv_scan_kernel",
                    "wkv_outputs_kernel")
#: one wkv call per layer per chunked pass (``launch_wkv``; each issues
#: three kernels: chunk states, state scan, chunk outputs)
RWKV_LAUNCHES = 32
#: every layer's wkv call on the main path, held against the plain version
#: on the same inputs (the model's own r, k, v, w and state): max |Δ| over
#: the call's max |o| (and |state|), fp32 orders only
RWKV_LAYER_RTOL = 1e-5
#: kernel vs plain wkv, logits at full width, bf16: max |Δ logit| over max
#: |logit|.  Both compute the WKV in fp32 in other orders (o differs by
#: about 1e-6 relative, see RWKV_LAYER_RTOL), and this random 32-layer model
#: amplifies any such difference to every position: the run's "noise"
#: forward (the kernel's o scaled by 1 + 1e-6·N(0, 1)) moves the median
#: position by 5.4e-2 of max |logit| and the worst by 0.91 on an H100.  So
#: this gate is a regression guard for this kernel's arithmetic (the run is
#: deterministic), set at about twice the measured 6.9e-2, not a rounding
#: tolerance; the per-layer check above is the tight one.  A control proves
#: it can fail: the kernel forward with the state lost at S/2 (1.46).
RWKV_LOGIT_RTOL = 0.15
#: each layer's time mix in prefill (the kernel), held against the scan
#: oracle on the same inputs: the wkv state to RWKV_LAYER_RTOL (fp32 orders),
#: the bf16 output to 2^-6 of its max |out|: both paths round o to bf16
#: after the group norm, and a one-ulp (2^-8) flip of a few elements, summed
#: through wo, stays inside that
RWKV_MIX_RTOL = 2.0 ** -6
#: the first decode step (the scan, from prefill's state) against a forward
#: over prompt + token (the scan all the way): other evaluation orders, the
#: the derive phase validates each candidate against the reference's own
#: 10^6 ground-truth points (core/pipeline.py's derive_mapping default),
#: checking one point in DERIVE_SAMPLE_EVERY
DERIVE_N_VALIDATE = 1_000_000
DERIVE_SAMPLE_EVERY = 100
#: λ spread over [0, N_PAPER), the last included, at which each deployed
#: artifact's own scalar map is held against the kernel's coordinates
DERIVE_LAMBDAS = 10_000
#: the complexity class each replayed logic implies: the registry's class
#: of the variant map of that name (core/maps/variants.py); the bitwise
#: digit maps loop once per base-B digit; binsearch_linear's doubling
#: search is followed by a linear layer scan, which dominates
IMPLIED_CLASS = {"analytical": "O(1)", "sqrt_loop": "O(1)",
                 "approx_if": "O(1)", "cbrt_loop": "O(1)",
                 "binsearch": "O(log N)", "bitwise": "O(log N)",
                 "linear": "O(N^1/3)", "binsearch_linear": "O(N^1/3)"}
#: same amplification as RWKV_LOGIT_RTOL; measured 0.128 of max |logit| on
#: an H100, gate about twice that
RWKV_DECODE_RTOL = 0.3
#: a λ offset past 2^31 (the evaluate batch's and the key queries' far query)
FAR = (1 << 31) + 12345
#: the serve phase: concurrent clients, sweep sizes, seconds to wait for the
#: entry point to boot and to stop
SERVE_CLIENTS = 4
SERVE_SWEEP = (1 << 20, 1 << 21)
SERVE_BOOT_S = 120
#: the examples phase: examples_torch/, the quickstart's grid steps at S 512,
#: block 128 (bounding box, mapped) and the paper domains x STAGES cells
#: that derive_and_deploy's client 2 must find in the server's store
EXAMPLES = ROOT / "examples_torch"
QUICKSTART_GRID_STEPS = (16, 10)
DERIVE_DEPLOY_CELLS = 18
#: the vlm path: llama-3.2-vision-11b at full width (8 groups of 4 self
#: layers and one gated cross layer), tokens (1, 4096), stub vision states
#: (1, 4100, 4096) × 0.1
VLM_ARCH = "llama-3.2-vision-11b"
VLM_PARAMS = 9_775_157_256
VLM_SEQ = 4096
VLM_LAUNCHES = 32              # one per self layer; none from a cross layer
#: every xattn_gate after init: the reference initialises them to 0, which
#: would leave the cross layers adding nothing any check could see
VLM_GATE = 0.5
#: one cross layer, bf16 on the card, against the same layer in fp32 on
#: the same inputs: its attention branch (tanh(gate) · attention) and its
#: output, max |Δ| over the max |fp32 value|.  The bf16 path rounds the
#: normed input, q, k, v, the attention output and each product's output
#: to bf16 (2^-9 of an element each), which sums to well under 1e-2 of the
#: max; the gate is 3e-2.  A control proves it can fail: the fp32 branch
#: over half the vision states.
CROSS_RTOL = 3e-2
#: the audio path: whisper-medium at full width (24 encoder + 24 decoder
#: layers, 16 heads of 64), stub frames (8, 1500, 1024) × 0.1, decoder
#: tokens (8, 384): 384 is a multiple of the 128 block inside whisper's
#: 448-token text context; at 448 the decoder takes the plain SDPA
WHISPER_ARCH = "whisper-medium"
WHISPER_PARAMS = 817_053_696
WHISPER_BATCH, WHISPER_SEQ, WHISPER_SEQ_PLAIN = 8, 384, 448
WHISPER_LAUNCHES = 24          # one per decoder self layer
WHISPER_GEN_PROMPT = 64
#: engine_serve: the paper's 6 domains derived at one model and stage
ENGINE_MODEL, ENGINE_STAGE = "OSS:120b", 20
#: the moe path: moonshot-v1-16b-a3b at full width (48 layers, d_model
#: 2048, MHA 16/16 of 128, 64 experts top-6 of width 1408 and 2 shared;
#: 57.8 GB in bf16), tokens (1, 4096)
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_PARAMS = 28_888_467_456
MOE_SEQ = 4096
MOE_LAUNCHES = 48              # one per layer
#: one layer's branch in bf16 against another evaluation of the same math
#: on the same input, max |Δ| over the other's max |value|: the MoE branch
#: against the same layer with its expert and shared weights upcast to fp32
#: (the router reads the same fp32 numbers, so routing must be equal), and
#: prefill's and the first decode step's attention branch and layer output
#: against the cache-less layer's.  The bf16 paths round each product's
#: output, the SwiGLU's product, the weighted outputs and their sum to bf16
#: (2^-9 of an element each), well under 1e-2 of the max; the gate is 3e-2,
#: as CROSS_RTOL.  Controls must miss it: the fp32 MoE without the
#: renormalisation of its top-k weights, and without its shared experts; a
#: decode step whose RoPE position is one short.
MOE_LAYER_RTOL = 3e-2
#: a decode step (4 tokens, capacity 8) is held against a cache-less layer
#: over 4 x 513 tokens at this capacity factor: capacity_for gives every
#: expert a slot for every token, so nothing drops and each token's output
#: is its own; the normal factor's drops there are printed beside it
MOE_NO_DROP_CF = 11.0
#: the hybrid path: zamba2-1.2b at full width (38 Mamba2 layers, d_inner
#: 4096, 64 heads of 64, state 64; one shared attention + MLP block, MHA
#: 32/32 of 64, d_ff 8192), tokens (1, 4096)
HYBRID_ARCH = "zamba2-1.2b"
HYBRID_PARAMS = 1_170_473_856
HYBRID_SEQ = 4096
HYBRID_LAUNCHES = 6            # the shared block fires after layers 5, ..., 35
#: top-1 kernel vs xla is printed, not gated, for zamba2: at random weights
#: its logits are flat (xla's top-2 margin is small against max |logit|),
#: so the bf16 noise of six attention firings reorders the best two at
#: about 7% of positions (0.932 on an H100) while the logits stay within
#: FWD_LOGIT_RTOL; each firing's attention is held on its own input instead
#: one Mamba2 layer's SSD on its own inputs at full width, the chunked form
#: against the scan, fp32 inside both: max |Δ| over max |value| of y and of
#: the final state.  The reference's test holds the two to 1e-5 absolute at
#: small widths (tests/test_models.py); fp32 sums taken in other orders stay
#: near 1e-6 of the max; the gate is 1e-4.  A control must miss it: the
#: chunked form restarted from a zero state at S/2.
MAMBA_CORE_RTOL = 1e-4
#: the Mamba2 layers held so: the first, and the first after a firing
MAMBA_HELD_LAYERS = (0, 6)
#: the MLA path: deepseek-v2-236b at full width (d_model 5120, 128 heads,
#: q_lora 1536, kv_lora 512, q·k over 128 + 64, v 128; 160 experts top-6 of
#: width 1536 and 2 shared), cut to MLA_LAYERS of its 60 layers: the whole
#: model is 239,375,569,920 parameters (478.8 GB in bf16), the cut
#: 24,881,280,000 (49.8 GB); tokens (1, 4096)
MLA_ARCH = "deepseek-v2-236b"
MLA_FULL_PARAMS = 239_375_569_920
MLA_LAYERS = 6
MLA_PARAMS = 24_881_280_000
MLA_SEQ = 4096
#: one MLA layer's attention branch in bf16 against another evaluation on
#: the same input, max |Δ| over the other's max |value|: against the same
#: layer with its weights upcast to fp32; the absorbed decode step against
#: mla_absorb="never" on the same cache, and against a cache-less pass over
#: prompt + token.  bf16 rounds each of the six products' outputs (2^-9 of
#: an element), well under 1e-2 of the max; the gate is 3e-2, as
#: MOE_LAYER_RTOL.  Controls must miss it: the fp32 layer with its k and v
#: up-projections swapped (wuk for wuv: the same shapes), a decode step
#: whose RoPE position is one short.
MLA_LAYER_RTOL = 3e-2
#: the training path: llama3.2-3b at full width and depth (28 layers,
#: d_model 3072, GQA 24/8 of 128, d_ff 8192, tied vocab 128,256), bf16,
#: attn_impl pallas_mapped, remat "full"; batch 2 of 4096 tokens in 2
#: microbatches, 4 steps of SyntheticLM
TRAIN_ARCH = "llama3.2-3b"
TRAIN_PARAMS = 3_212_749_824
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICROBATCHES, TRAIN_STEPS = 2, 4096, 2, 4
#: sm90 launches a step: one per layer per microbatch in the forward and
#: one more in its remat recompute (the backward is the plain vjp)
TRAIN_LAUNCHES_PER_STEP = 28 * 2 * 2
#: the same step under xla from the same parameters and batch: loss within
#: CE_RTOL, grad norm within TRAIN_GNORM_RTOL relative.  The two differ by
#: the kernel's bf16 P (its logits sit at ~2e-2 of max against xla's, PERF.md
#: §6); a gradient norm sums 3.2 G squares, so that noise averages down.
TRAIN_GNORM_RTOL = 3e-2
#: microbatches 2 against 1 on one batch: loss within 1e-4 relative (the
#: mean over the same tokens, each row's forward the same math), grad norm
#: within 1e-2 relative, and each gradient tensor within 1e-2 of its max
#: |value| (bf16 rounds each half's gradient, 2^-9 of an element, against
#: one rounding of the whole, and a product at another batch size may sum
#: in another order: a few bf16 ulps of the largest element)
MB_LOSS_RTOL, MB_GNORM_RTOL, MB_GRAD_RTOL = 1e-4, 1e-2, 1e-2
#: both of those gradients against an fp32 witness (the same weights
#: upcast, attn_impl xla, the whole batch): each tensor within 3e-2 of the
#: witness's max |value| (bf16 activations through 4 layers and the loss,
#: about 2^-8 an element, summed over 8192 tokens in fp32).  Control: the
#: plain lookup's embedding gradient (bf16 accumulation over a token's
#: repeats, about a tenth of the max at SyntheticLM's zipf) must miss it.
WITNESS_GRAD_RTOL = 3e-2
#: remat "full" against "none": the recompute runs the same kernels on the
#: same inputs; loss within 1e-6 relative, gradients within 1e-3 of each
#: tensor's max |value| (equality is printed)
REMAT_LOSS_RTOL, REMAT_GRAD_RTOL = 1e-6, 1e-3
#: depths of the training gates, both at full width: microbatches and
#: remat at 4 layers on one set of weights; the checkpoint and the restart
#: loop, which hold bitwise equality, at 1
TRAIN_GATE_LAYERS, CKPT_LAYERS = 4, 1
#: the sharded step against the single-device step from the same weights
#: and batch: loss, grad norm and each parameter within this relative
#: difference (one rank: they are equal bit for bit); the entry point under
#: torch.distributed.run against train_entry's final metrics
SHARDED_RTOL, SHARDED_ENTRY_RTOL = 1e-6, 1e-5
#: the sharded step's peak device memory over the single-device step's:
#: it holds one layer's weights gathered, never the whole model
SHARDED_PEAK_SLACK_GB = 0.5
#: sharded_rwkv: rwkv6-3b's step at batch 1 of RWKV_SEQ tokens in one
#: microbatch, at this depth (of RWKV_LAYERS)
SHARDED_RWKV_LAYERS, SHARDED_RWKV_BATCH = 6, 1
#: split_decode: (name, arch, config overrides, rows, cache length,
#: blocks): yi-6b's GQA with a bf16 and an int8 cache and deepseek-v2's
#: absorbed MLA at decode_32k's rows a rank (128 over 16 data ranks) in 16
#: blocks, zamba2-1.2b's shared block at long_500k's one row in 256
SPLIT_DECODE_CASES = (
    ("gqa", "yi-6b", {}, 8, 32_768, 16),
    ("gqa_int8", "yi-6b", {"kv_cache_quant": True}, 8, 32_768, 16),
    ("mla_absorbed", "deepseek-v2-236b", {"mla_absorb": "auto"}, 8, 32_768,
     16),
    ("zamba2_shared", "zamba2-1.2b", {}, 1, 524_288, 256),
)
#: the blocked layer's output against the whole-cache layer's, of max |out|
SPLIT_DECODE_RTOL, SPLIT_DECODE_SEED = 1e-2, 0
#: dryrun_arch's commands: (arch, shape, --multi-pod)
DRYRUN_COMMANDS = (("yi-6b", "train_4k", "both"),
                   ("deepseek-v2-236b", "decode_32k", "off"),
                   ("rwkv6-3b", "train_4k", "off"),
                   ("zamba2-1.2b", "train_4k", "off"),
                   ("moonshot-v1-16b-a3b", "decode_32k", "off"),
                   ("zamba2-1.2b", "long_500k", "off"))
#: the dry run's yi-6b x train_4k on the fake 16x16 group: each rank's
#: FLOPs over analytic_flops / 256, and its peak of live bytes
DRYRUN_YI_FLOPS_RATIO_MAX, DRYRUN_YI_PEAK_GB_MAX = 2.5, 80.0
#: rwkv6-3b's and zamba2-1.2b's train_4k on 16x16 with their layers split
#: over model: FLOPs over analytic_flops / 256 at most these, peaks below
#: those of their layers computed whole along model (120.3, 32.4 GB)
DRYRUN_SSM_CELLS = {"rwkv6-3b": (4.0, 120.3), "zamba2-1.2b": (3.0, 32.4)}
#: decode cells on 16x16 with the cache split along kv_seq: peak GB caps
#: (whole caches: 111.7, 27.1 and 28.2 GB a rank)
DRYRUN_DECODE_PEAK_GB = {"moonshot-v1-16b-a3b__decode_32k__sp": 10.0,
                         "deepseek-v2-236b__decode_32k__sp": 10.0,
                         "zamba2-1.2b__long_500k__sp": 2.0}
#: --train-probe: the main path's 4 steps at these learning rates (full
#: depth, bf16), and at TRAIN_GATE_LAYERS layers in bf16 and in fp32 at the
#: main path's 3e-4
PROBE_LRS = (3e-4, 3e-5, 3e-6)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _rel(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    want = want.float()
    return float((got.float() - want).abs().max()) / float(want.abs().max())


def _final_metrics(lines: list) -> dict:
    """launch.train's ``final metrics: {...}`` line as a dict of floats."""
    import ast

    line = [ln for ln in lines if ln.startswith("final metrics:")][-1]
    return ast.literal_eval(line.split(":", 1)[1].strip())


@contextlib.contextmanager
def _captured(owner, name: str, keep):
    """Within the block every call of ``owner.name`` also appends
    ``keep(args, kwargs, result)`` to the yielded list."""
    real = getattr(owner, name)
    seen: list = []

    def wrapper(*args, **kw):
        out = real(*args, **kw)
        seen.append(keep(args, kw, out))
        return out

    setattr(owner, name, wrapper)
    try:
        yield seen
    finally:
        setattr(owner, name, real)


def _routing_diff(a: list, b: list):
    """Per token (flattened over the batch), whether two passes' routing of
    one MoE call differs: the top-k experts in rank order, or which of them
    kept a slot."""
    k = a["top_e"].shape[-1]
    return ((a["top_e"].reshape(-1, k) != b["top_e"].reshape(-1, k)).any(-1)
            | (a["keep"].reshape(-1, k) != b["keep"].reshape(-1, k)).any(-1))


def _flips(a: list, b: list) -> int:
    """(layer, token) routing decisions that differ between two passes."""
    check(len(a) == len(b), f"{len(a)} against {len(b)} MoE calls")
    return int(sum(int(_routing_diff(x, y).sum()) for x, y in zip(a, b)))


def _drops(rec: list) -> int:
    """Assignments dropped (no slot left in their expert) over the calls."""
    return int(sum(int((~r["keep"]).sum()) for r in rec))


def _late_rows_drop_first_partial(attend, q, k, v, block, grid_mode,
                                  interpret=False):
    """``attend``'s output with every row from S/2 on missing its j = 0
    partial, as a combine that starts one partial late would."""
    o = attend(q, k, v, block, block, grid_mode, interpret)
    half = q.shape[2] // 2
    tail = attend(q[:, :, block:], k[:, :, block:], v[:, :, block:], block,
                  block, grid_mode, interpret)
    o[:, :, half:] = tail[:, :, half - block:]
    return o


class Smoke:
    def __init__(self):
        import torch

        from repro_torch.core.domains import DOMAINS
        from repro_torch.kernels import build
        from repro_torch.kernels.domain_map import kernel, ops
        from repro_torch.kernels.tri_attn import kernel as attn_kernel
        from repro_torch.kernels.wkv import kernel as wkv_kernel

        self.torch, self.K, self.ops, self.DOMAINS = torch, kernel, ops, DOMAINS
        self.build_mod, self.AK, self.WK = build, attn_kernel, wkv_kernel
        self.max_err = {"map_kernel": 0, "membership_kernel": 0}
        self.launches = {}
        self.totals = {k: {"ms": 0.0, "plain_ms": 0.0, "bytes": 0, "n": 0}
                       for k in self.max_err}
        self.attn_row = {}
        self.sm90_paths = {}           # sm90 launches per main path
        # launches per main path of the map, membership and simt rows
        self.paths = {"map_kernel": {}, "membership_kernel": {},
                      "tri_attn_simt": {}}
        self.wkv_paths = {}            # wkv calls per main path
        self.attn_simt_row = {}
        self.wkv_row = {}
        self.paper_ms = {}

    # -- helpers -------------------------------------------------------------
    def sync(self):
        self.torch.cuda.synchronize()

    def time_ms(self, fn, reps: int = REPS) -> float:
        """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
        after one warm-up run."""
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def host_us(self, fn, n: int = 50) -> float:
        """Host time of one ``fn()`` call in µs: ``n`` calls issued while
        the card is held busy, so no call waits for it."""
        torch = self.torch
        fn()
        self.sync()
        torch.cuda._sleep(50_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        self.sync()
        return (t1 - t0) / n * 1e6

    def device_ms(self, fn, n: int = 20) -> float:
        """Device time of one ``fn()`` call in ms: ``n`` calls issued while
        the card is held busy, then timed back to back (CUDA events), so no
        call waits for the host."""
        torch = self.torch
        fn()
        self.sync()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / n

    def compare(self, kernel_name: str, got, want, what: str) -> None:
        torch = self.torch
        check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} "
              f"!= {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max_err[kernel_name] = max(self.max_err[kernel_name], err)
        check(err == 0, f"{what}: kernel differs from its plain version "
              f"(max abs err {err})")

    def counts(self) -> dict:
        return {"map_kernel": self.K.MAP_LAUNCHES,
                "membership_kernel": self.K.MEMBERSHIP_LAUNCHES,
                "tri_attn": self.AK.ATTN_LAUNCHES,
                "tri_attn_sm90": self.AK.ATTN_SM90_LAUNCHES,
                "wkv": self.WK.WKV_LAUNCHES}

    def reset_counts(self) -> None:
        """Every kernel's launch count to 0, just before a main path."""
        self.K.reset_launch_counts()
        self.AK.reset_launch_counts()
        self.WK.reset_launch_counts()

    # -- phase 1 -------------------------------------------------------------
    def device(self) -> str:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        self.card = smi.stdout.strip().splitlines()[0]
        print(self.card, flush=True)
        name = self.torch.cuda.get_device_name(0)
        emit({"phase": "device", "nvidia_smi": self.card,
              "torch_device": name,
              "count": self.torch.cuda.device_count(),
              "torch": self.torch.__version__,
              "cuda": self.torch.version.cuda})
        return name

    # -- phase 2 -------------------------------------------------------------
    def build(self) -> None:
        t0 = time.perf_counter()
        paths = self.build_mod.build()          # every registered library
        dt = time.perf_counter() - t0
        ptxas = {}
        for name, log in self.build_mod.BUILD_LOG.items():
            regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
            spills = [int(m) for m in
                      re.findall(r"(\d+) bytes spill stores", log)]
            ptxas[name] = {"kernels": len(regs),
                           "max_registers": max(regs, default=0),
                           "kernels_spilling": sum(1 for x in spills if x),
                           "max_spill_store_bytes": max(spills, default=0)}
        # the domain-map kernels, one by one: (registers, spill store bytes)
        per_kernel = {}
        for name in self.K.LIBRARIES:
            per_kernel[name] = {}
            for blk in self.build_mod.BUILD_LOG.get(name, "").split(
                    "Compiling entry function '")[1:]:
                regs = re.search(r"Used (\d+) registers", blk)
                spill = re.search(r"(\d+) bytes spill stores", blk)
                per_kernel[name][blk.split("'")[0]] = [
                    int(regs[1]) if regs else None,
                    int(spill[1]) if spill else 0]
        emit({"phase": "build", "seconds": dt,
              "libraries": {k: str(p.relative_to(ROOT))
                            for k, p in paths.items()},
              "ptxas": ptxas, "ptxas_domain_map": per_kernel})

    # -- phase 3 -------------------------------------------------------------
    def _map_case(self, name, start, n, index_bits=None) -> None:
        K, ops = self.K, self.ops
        _, _, ndigits = ops.map_plan(name, n, 1, start)
        got = K._launch_map(name, n, ndigits, start, index_bits=index_bits)
        want = K.map_plain(name, n, ndigits, start, device="cuda")
        self.compare("map_kernel", got, want,
                     f"{name} map at start={start}, n={n}, "
                     f"bits={index_bits or 'auto'}")

    def _membership_case(self, name, ext, total, index_bits=None) -> None:
        K, ops = self.K, self.ops
        _, _, ndigits = ops.membership_plan(name, ext, 1)
        got = K._launch_membership(name, ext, total, ndigits,
                                   index_bits=index_bits)
        want = K.membership_plain(name, ext, ndigits, total, device="cuda")
        self.compare("membership_kernel", got, want,
                     f"{name} membership on {ext}, total={total}, "
                     f"bits={index_bits or 'auto'}")

    def kernels(self) -> None:
        K, ops = self.K, self.ops
        from repro_torch.kernels.domain_map import geometry as geo

        n = 1 << 22
        starts = (0, (1 << 31) - 1000, N_PAPER - (1 << 20))
        self.reset_counts()
        cases = 0
        bits_seen = {"map": set(), "membership": set()}
        for name, d in self.DOMAINS.items():
            g = geo.GEOMETRY[name]
            for start in starts:
                _, padded, ndigits = ops.map_plan(name, n, 1024, start)
                got = K.launch_map(name, padded, ndigits, start)
                want = K.map_plain(name, padded, ndigits, start,
                                   device="cuda")
                self.compare("map_kernel", got, want,
                             f"{name} map at start={start}")
                bits_seen["map"].add(geo.map_index_bits(g, start, padded))
            # an odd start, n % 4 == 3; a peel's 32-bit bound: the last
            # launch below it, one across it, the first above it, and the
            # 64-bit path where the 32-bit one is proven (the digit maps
            # and the peels of m = 2, 3 are 64-bit throughout)
            more = [(ODD_START, ODD_N, None)]
            if g.family == geo.PEEL and g.m in geo.PEEL32_M:
                bound = geo.PEEL_LAM32[g.m]
                more += [(bound - n, n, None), (bound - n // 2 - 1, n + 3, None),
                         (bound, n, None), (ODD_START, ODD_N, 64)]
            for start, m, bits in more:
                self._map_case(name, start, m, index_bits=bits)
                bits_seen["map"].add(bits or geo.map_index_bits(g, start, m))
            cases += len(starts) + len(more)
            for ext, total, bits in (
                    (SMALL_BOX[d.dim], None, None),
                    (SMALL_BOX[d.dim], None, 64),
                    (ODD_BOX[d.dim], math.prod(ODD_BOX[d.dim]) + ODD_PAD,
                     None)):
                if total is None:
                    _, total, _ = ops.membership_plan(name, ext, 1024)
                self._membership_case(name, ext, total, bits)
                bits_seen["membership"].add(
                    bits or geo.membership_index_bits(total))
                cases += 1
        self.sync()
        check(bits_seen["map"] == bits_seen["membership"] == {32, 64},
              f"index widths driven: {bits_seen}")
        emit({"phase": "kernels", "domains": len(self.DOMAINS),
              "map_starts": list(starts), "map_n": n, "cases": cases,
              "odd_start": ODD_START, "odd_n": ODD_N, "odd_boxes": ODD_BOX,
              "index_bits": {k: sorted(v) for k, v in bits_seen.items()},
              "launches": self.counts(), "max_abs_err": self.max_err,
              "equal": True})

    # -- phase 4 -------------------------------------------------------------
    def _check_map_chunks(self, name, out, n, ndigits) -> float:
        """Exact chunked check of a mapped output; returns the plain
        version's device time for the whole range (ms, one run)."""
        torch, K = self.torch, self.K
        plain_ms = 0.0
        for lo in range(0, n, CHUNK):
            c = min(CHUNK, n - lo)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = K.map_plain(name, c, ndigits, lo, device="cuda")
            b.record()
            b.synchronize()
            plain_ms += a.elapsed_time(b)
            self.compare("map_kernel", out[:, lo:lo + c], want,
                         f"{name} paper-scale map chunk at {lo}")
            del want
        return plain_ms

    def _check_mask_chunks(self, name, mask, extent, ndigits) -> float:
        torch, K = self.torch, self.K
        total = mask.shape[1]
        plain_ms = 0.0
        for lo in range(0, total, CHUNK):
            c = min(CHUNK, total - lo)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            want = K.membership_plain(name, extent, ndigits, c, lo,
                                      device="cuda")
            b.record()
            b.synchronize()
            plain_ms += a.elapsed_time(b)
            self.compare("membership_kernel", mask[:, lo:lo + c], want,
                         f"{name} paper-scale mask chunk at {lo}")
            del want
        return plain_ms

    def _members_of_mapped(self, name, coords, extent, mask) -> None:
        """Every mapped point lies in the box and is a member there."""
        torch = self.torch
        strides = [1] * len(extent)
        for k in range(len(extent) - 2, -1, -1):
            strides[k] = strides[k + 1] * extent[k + 1]
        n = coords.shape[1]
        for lo in range(0, n, CHUNK):
            c = coords[:, lo:lo + CHUNK].to(torch.int64)
            for k, e in enumerate(extent):
                check(bool(((c[k] >= 0) & (c[k] < e)).all()),
                      f"{name}: mapped axis {k} leaves the box")
            idx = sum(c[k] * s for k, s in enumerate(strides))
            check(bool((mask[0, idx] == 1).all()),
                  f"{name}: a mapped point fails the BB membership test")

    def _paper_box(self, name):
        """(extent, level, mapped points) of a domain's paper-scale BB box:
        the box of N = 5e8 for tri2d and pyramid3d, a full fractal level."""
        d = self.DOMAINS[name]
        if name in FRACTAL_LEVELS:
            level = FRACTAL_LEVELS[name]
            return (d.scale ** level,) * d.dim, level, d.size(level)
        extent = d.bounding_box_extent(N_PAPER)
        return extent, extent[0], N_PAPER

    def paper_scale(self) -> None:
        torch, ops = self.torch, self.ops
        from repro_torch.core.compile_cache import CompileCache

        from repro_torch.kernels.domain_map import geometry as geo

        cache = CompileCache(max_entries=64)
        rows = {}
        self.reset_counts()
        # the main-path calls: one mapped launch per domain at N = 5e8
        for name, d in self.DOMAINS.items():
            _, padded, ndigits = ops.map_plan(name, N_PAPER, 1024)
            call = ops.mapped_executable(name, padded, 1024, ndigits, False,
                                         compile_cache=cache)
            out = call()
            self.sync()
            plain_ms = self._check_map_chunks(name, out, N_PAPER, ndigits)
            del out
            rows[name] = {"n": N_PAPER, "padded": padded, "ndigits": ndigits,
                          "index_bits": geo.map_index_bits(
                              geo.GEOMETRY[name], 0, padded),
                          "bytes": d.dim * padded * 4, "call": call,
                          "plain_ms": plain_ms}
        # the map rows of the kernels line: these launches, one per domain
        self._add_path("map_kernel", "paper_scale", self.K.MAP_LAUNCHES)
        check(self.K.MAP_LAUNCHES == len(rows),
              f"{self.K.MAP_LAUNCHES} map launches for {len(rows)} domains")
        # BB membership: dense boxes at N = 5e8, full fractal levels
        bb = {}
        for name in BB_DOMAINS:
            d = self.DOMAINS[name]
            extent, level, n_map = self._paper_box(name)
            total = math.prod(extent)
            _, padded, ndigits = ops.membership_plan(name, extent, 1024)
            call = ops.membership_executable(name, extent, padded, 1024,
                                             ndigits, False,
                                             compile_cache=cache)
            mask = call()
            self.sync()
            members = int(mask[0, :total].sum(dtype=torch.int64))
            check(members == d.size(level),
                  f"{name}: {members} members in box {extent}, "
                  f"size({level}) = {d.size(level)}")
            plain_ms = self._check_mask_chunks(name, mask, extent, ndigits)
            # the mapped launch over the same points
            _, mpad, mdig = ops.map_plan(name, n_map, 1024)
            mcall = ops.mapped_executable(name, mpad, 1024, mdig, False,
                                          compile_cache=cache)
            coords = mcall()[:, :n_map]
            self._members_of_mapped(name, coords, extent, mask)
            del mask, coords
            bb[name] = {"extent": list(extent), "cells": total,
                        "padded": padded, "ndigits": ndigits,
                        "members": members,
                        "index_bits": geo.membership_index_bits(padded),
                        "level": level, "bytes": padded * 4, "call": call,
                        "plain_ms": plain_ms, "mapped_n": n_map,
                        "mapped_call": mcall, "mapped_bytes": d.dim * mpad * 4}
        self.sync()
        main = self.counts()
        self._add_path("membership_kernel", "paper_scale",
                       main["membership_kernel"])
        check(main["membership_kernel"] == len(bb),
              f"{main['membership_kernel']} membership launches for "
              f"{len(bb)} boxes")
        # timing (not part of the main-path launch count)
        for name, r in rows.items():
            r["ms"] = self.time_ms(r.pop("call"))
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
            r["over_bound"] = r["ms"] / r["bound_ms"]
            self.paper_ms[name] = {"mapped_ms": r["ms"]}
            emit({"phase": "paper_scale", "kernel": "map_kernel",
                  "domain": name, "card": self.card, **r})
            t = self.totals["map_kernel"]
            t["ms"] += r["ms"]
            t["plain_ms"] += r["plain_ms"]
            t["bytes"] += r["bytes"]
            t["n"] += 1
        for name, r in bb.items():
            r["ms"] = self.time_ms(r.pop("call"))
            r["bound_ms"] = r["bytes"] / HBM_BYTES_PER_S * 1e3
            r["over_bound"] = r["ms"] / r["bound_ms"]
            r["mapped_ms"] = self.time_ms(r.pop("mapped_call"))
            r["mapped_bound_ms"] = r["mapped_bytes"] / HBM_BYTES_PER_S * 1e3
            r["bb_over_mapped"] = r["ms"] / r["mapped_ms"]
            self.paper_ms[name].update(
                bb_ms=r["ms"], bb_extent=r["extent"],
                bb_box_mapped_ms=r["mapped_ms"], bb_box_points=r["mapped_n"])
            emit({"phase": "paper_scale", "kernel": "membership_kernel",
                  "domain": name, "card": self.card, **r})
            t = self.totals["membership_kernel"]
            t["ms"] += r["ms"]
            t["plain_ms"] += r["plain_ms"]
            t["bytes"] += r["bytes"]
            t["n"] += 1
        emit({"phase": "paper_scale", "card": self.card,
              "main_path_launches": main,
              "map_ms_12_domains": self.totals["map_kernel"]["ms"],
              "bb_ms_6_boxes": self.totals["membership_kernel"]["ms"]})

    # -- opt-in ----------------------------------------------------------------
    def index_widths(self) -> None:
        """The paper-scale launches that take a 32-bit path: each one's
        median time beside the same launch forced through the 64-bit path,
        and the two outputs bit-identical."""
        torch, K, ops = self.torch, self.K, self.ops
        from repro_torch.kernels.domain_map import geometry as geo

        pairs = []
        for name in self.DOMAINS:
            _, padded, ndigits = ops.map_plan(name, N_PAPER, 1024)
            if geo.map_index_bits(geo.GEOMETRY[name], 0, padded) == 32:
                pairs.append(("map_kernel", name, padded, functools.partial(
                    K._launch_map, name, padded, ndigits, 0)))
        for name in BB_DOMAINS:
            extent = self._paper_box(name)[0]
            _, padded, ndigits = ops.membership_plan(name, extent, 1024)
            if geo.membership_index_bits(padded) == 32:
                pairs.append(("membership_kernel", name, padded,
                              functools.partial(K._launch_membership, name,
                                                extent, padded, ndigits)))
        for kernel, name, padded, launch in pairs:
            check(torch.equal(launch(), launch(index_bits=64)),
                  f"{name}: {kernel}'s 32-bit and 64-bit outputs differ")
            self.sync()
            ms32 = self.time_ms(launch)
            ms64 = self.time_ms(lambda: launch(index_bits=64))
            emit({"phase": "index_widths", "kernel": kernel, "domain": name,
                  "card": self.card, "padded": padded, "ms_32bit": ms32,
                  "ms_64bit": ms64})

    # -- phase 5 -------------------------------------------------------------
    def _eval_queries(self, max_points: int) -> list[dict]:
        """The evaluate batch: every domain at ``max_points``, two tri2d
        prefixes, tri2d past 2^31 and three membership boxes (26.2 M
        points at 2^21)."""
        queries = [{"domain": name, "n_points": max_points}
                   for name in self.DOMAINS]
        return queries + [
            {"domain": "tri2d", "n_points": 1000},
            {"domain": "tri2d", "n_points": 5000},
            {"domain": "tri2d", "n_points": 1 << 20, "start": FAR},
            {"domain": "tri2d", "tier": "membership", "extent": [1448, 1448]},
            {"domain": "gasket2d", "tier": "membership",
             "extent": [1448, 1448]},
            {"domain": "menger3d", "tier": "membership",
             "extent": [128, 128, 128]},
        ]

    def evaluate(self) -> None:
        import numpy as np

        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.core.maps import np_map
        from repro_torch.serving import wire
        from repro_torch.serving.evaluate import (
            MAX_POINTS, EvaluationService, encoded_batch_response,
        )

        queries = self._eval_queries(MAX_POINTS)
        ev = EvaluationService(compile_cache=CompileCache(max_entries=64))
        self.reset_counts()
        t0 = time.perf_counter()
        cold, meta = ev.evaluate_batch(queries)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm, meta2 = ev.evaluate_batch(queries)
        warm_s = time.perf_counter() - t0
        frame = encoded_batch_response(ev, None, queries, single=False,
                                       binary=True)
        self.sync()
        launches = self.counts()
        for k in ("map_kernel", "membership_kernel"):
            check(launches[k] > 0, f"evaluate never launched {k}")

        check(meta == meta2, "repeat batch changed its grouping")
        check(all(r["executable"] == "hit" for r in warm),
              "repeat batch was not all executable hits")
        check(cold[12]["group"] == cold[13]["group"] == cold[0]["group"],
              "tri2d prefix queries did not share a group")
        cpu = EvaluationService(compile_cache=CompileCache(max_entries=64))
        ref, ref_meta = cpu.evaluate_batch(
            [{**q, "interpret": True} for q in queries])
        check(ref_meta == meta, "CPU path grouped the batch differently")
        decoded = wire.decode_frame(frame)["results"]
        for q, a, b, r, f in zip(queries, cold, warm, ref, decoded):
            field = "mask" if q.get("tier") == "membership" else "coords"
            for other, what in ((b, "warm"), (r, "interpret=True"),
                                (f, "binary frame")):
                check(other[field].dtype == a[field].dtype
                      and np.array_equal(other[field], a[field]),
                      f"{q}: {what} {field} differ from the card's")
            skip = ("interpret", "executable", field)
            check({k: v for k, v in a.items() if k not in skip}
                  == {k: v for k, v in r.items() if k not in skip},
                  f"{q}: result metadata differ from the CPU path")
        exact = np_map("tri2d", np.arange(FAR, FAR + (1 << 20),
                                          dtype=np.int64))
        check(np.array_equal(cold[14]["coords"].astype(np.int64), exact),
              "tri2d past 2^31 differs from the exact numpy tier")
        emit({"phase": "evaluate", "card": self.card,
              "queries": meta["queries"], "groups": meta["groups"],
              "points": sum(q.get("n_points", 0) for q in queries),
              "cold_batch_s": cold_s, "warm_batch_s": warm_s,
              "frame_bytes": len(frame), "launches": launches,
              "stats": ev.stats_dict()})

    # -- phase: derive --------------------------------------------------------
    def _derive_grid(self, run_grid, backend, store, buf, trace_id):
        """One run_grid pass over the paper's measured grid under an active
        trace; (results, wall s, {span name: [count, ms]})."""
        from repro_torch.obs import trace as obs_trace

        token = obs_trace.activate(buf, trace_id)
        try:
            t0 = time.perf_counter()
            grid = run_grid(backend_factory=backend,
                            n_validate=DERIVE_N_VALIDATE,
                            sample_every=DERIVE_SAMPLE_EVERY, cache=store)
            wall = time.perf_counter() - t0
        finally:
            obs_trace.deactivate(token)
        entry = buf.get(trace_id) or {"spans": [], "dropped_spans": 0}
        check(entry["dropped_spans"] == 0, "the trace dropped spans")
        spans = {}
        for sp in entry["spans"]:
            c = spans.setdefault(sp["name"], [0, 0.0])
            c[0] += 1
            c[1] += sp["duration_ms"]
        return grid, wall, spans

    def derive(self) -> None:
        """The derive path: the paper's grid through run_grid into a fresh
        store, a second pass served from it, each deployable artifact
        launched through the map kernel at N = 5e8, key queries and the
        dry-run entry point."""
        import os
        import shutil

        import numpy as np

        from repro_torch.core import paper_tables as pt
        from repro_torch.core.backends import MockLLMBackend, mock_behavior
        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.core.pipeline import result_from_record, run_grid
        from repro_torch.core.store import build_store
        from repro_torch.launch import analytic
        from repro_torch.obs.trace import TraceBuffer
        from repro_torch.serving.evaluate import MAX_POINTS, EvaluationService

        torch, K, ops = self.torch, self.K, self.ops
        t_phase = time.perf_counter()
        work = ROOT / "build" / "derive"
        shutil.rmtree(work, ignore_errors=True)
        store = build_store(work / "store")
        generated = [0]

        class Counted:
            """MockLLMBackend counting its generate calls."""

            def __init__(self, model):
                self._mock = MockLLMBackend(model)
                self.name = model
                self.cache_fingerprint = self._mock.cache_fingerprint

            def generate(self, prompt, *, meta):
                generated[0] += 1
                return self._mock.generate(prompt, meta=meta)

        # -- the grid, twice over one store
        buf = TraceBuffer(max_traces=4, max_spans=10_000)
        grid, wall1, spans1 = self._derive_grid(run_grid, Counted, store,
                                                buf, "1" * 32)
        gen1, generated[0] = generated[0], 0
        grid2, wall2, spans2 = self._derive_grid(run_grid, Counted, store,
                                                 buf, "2" * 32)
        cells = len(pt.ACCURACY) * len(pt.MODELS) * len(pt.STAGES)
        check(len(grid) == cells == 198, f"{len(grid)} cells, want 198")
        check(gen1 == cells, f"first pass: {gen1} generate calls")
        check(sum(r.cache_hit for r in grid2.values()) == cells
              and generated[0] == 0 and "validation" not in spans2
              and "inference" not in spans2,
              f"second pass: {sum(r.cache_hit for r in grid2.values())} "
              f"hits, {generated[0]} generate calls, spans {spans2}")
        want = {(d, m, s) for d in pt.ACCURACY for m in pt.MODELS
                for s, (ordered, _, compiled)
                in zip(pt.STAGES, pt.ACCURACY[d][m])
                if compiled and ordered >= 100.0}
        arts = {k: r.artifact for k, r in grid.items()
                if r.artifact is not None and r.artifact.deployable}
        check(set(arts) == want and len(want) == 34,
              f"deployable cells {sorted(set(arts) ^ want)} differ from the "
              f"paper's 34")
        check(not any(k[0] == "menger3d" for k in arts),
              "a menger3d cell is deployable")
        for k, r in grid.items():
            if r.perfect:
                logic = mock_behavior(*k)[0]
                check(r.complexity_class == IMPLIED_CLASS[logic],
                      f"{k}: class {r.complexity_class}, {logic} implies "
                      f"{IMPLIED_CLASS[logic]}")
        for k, r in grid2.items():
            check(r.cache_key == grid[k].cache_key
                  and r.report == grid[k].report, f"{k}: second pass differs")
        by_domain = {}
        for k in sorted(arts):
            by_domain.setdefault(k[0], []).append(k)
        span_s = {name: ms / 1e3 for name, (_, ms) in spans1.items()}
        store_s = sum(v for n, v in span_s.items() if n.startswith("store_"))
        emit({"phase": "derive", "part": "grid", "card": self.card,
              "cells": cells, "deployable": len(arts),
              "deployable_by_domain": {d: len(v)
                                       for d, v in by_domain.items()},
              "n_validate": DERIVE_N_VALIDATE,
              "sample_every": DERIVE_SAMPLE_EVERY,
              "first_pass_s": wall1, "generate_calls": gen1,
              "spans": {n: {"count": c, "s": ms / 1e3}
                        for n, (c, ms) in spans1.items()},
              "inference_s": span_s.get("inference", 0.0),
              "validation_s": span_s.get("validation", 0.0),
              "validation_share": span_s.get("validation", 0.0) / wall1,
              "store_load_s": store_s,
              "other_s": wall1 - span_s.get("inference", 0.0)
              - span_s.get("validation", 0.0) - store_s,
              "second_pass_s": wall2,
              "second_pass_hits": sum(r.cache_hit for r in grid2.values()),
              "second_pass_generate_calls": generated[0],
              "second_pass_spans": {n: c for n, (c, _) in spans2.items()},
              "store": store.stats()})

        # -- deployment: each artifact through the map kernel at N = 5e8
        cache = CompileCache(max_entries=64)
        lams = np.unique(np.linspace(0, N_PAPER - 1, DERIVE_LAMBDAS)
                         .astype(np.int64))
        lam_dev = torch.as_tensor(lams, device="cuda")
        launches = 0
        for name, keys in by_domain.items():
            d = self.DOMAINS[name]
            _, padded, ndigits = ops.map_plan(name, N_PAPER, 1024)
            gt = ops.mapped_executable(name, padded, 1024, ndigits, False,
                                       compile_cache=cache)()
            first = None
            for k in keys:
                art = arts[k]
                _, apad, adig = ops.map_plan(art, N_PAPER, 1024)
                call = ops.mapped_executable(art, apad, 1024, adig, False,
                                             compile_cache=cache)
                n0 = K.MAP_LAUNCHES
                out = call()
                launches += K.MAP_LAUNCHES - n0
                check(K.MAP_LAUNCHES - n0 == 1,
                      f"{k}: {K.MAP_LAUNCHES - n0} map launches")
                check((apad, adig) == (padded, ndigits)
                      and torch.equal(out, gt),
                      f"{k}: the artifact's launch differs from {name}'s "
                      f"ground truth")
                got = out[:, lam_dev].cpu().numpy().T
                scalar = art.scalar_fn()
                bad = [int(lam) for lam, row in zip(lams, got)
                       if tuple(int(v) for v in row[:d.dim])
                       != tuple(scalar(int(lam)))]
                check(not bad, f"{k}: kernel differs from the artifact's "
                      f"scalar map at λ {bad[:5]}")
                del out
                first = first or call
                emit({"phase": "derive", "part": "artifact",
                      "cell": list(k), "key": art.cache_key,
                      "logic": art.logic,
                      "complexity_class": art.complexity_class,
                      "lambdas_checked": len(lams),
                      "block_counts": ops.block_counts(art, N_PAPER, 256),
                      "a100_model": analytic.artifact_deployment_analytics(
                          art, N_PAPER),
                      "card": self.card,
                      "card_mapped_ms": self.paper_ms[name]["mapped_ms"],
                      "card_bb": {key: self.paper_ms[name][key]
                                  for key in ("bb_ms", "bb_extent",
                                              "bb_box_mapped_ms",
                                              "bb_box_points")}})
            del gt
            self.sync()
            ms = self.time_ms(first)
            bound = d.dim * padded * 4 / HBM_BYTES_PER_S * 1e3
            emit({"phase": "derive", "part": "deploy", "domain": name,
                  "card": self.card, "artifacts": len(keys),
                  "n": N_PAPER, "padded": padded, "ms": ms,
                  "bound_ms": bound, "over_bound": ms / bound,
                  "ground_truth_ms": self.paper_ms[name]["mapped_ms"]})
        check(launches == len(arts),
              f"{launches} map launches for {len(arts)} artifacts")

        # -- evaluation by content address
        def resolver(key):
            rec = store.load(key)
            if rec is None:
                return None
            return result_from_record(rec, self.DOMAINS[rec["domain"]],
                                      key).artifact

        keys = sorted(arts)
        tri = next(k for k in keys if k[0] == "tri2d")
        by_key = [{"key": arts[k].cache_key, "n_points": MAX_POINTS}
                  for k in keys]
        by_key.append({"key": arts[tri].cache_key, "n_points": 1 << 20,
                       "start": FAR})
        domain_of = {arts[k].cache_key: k[0] for k in keys}
        by_dom = [{"domain": domain_of[q["key"]],
                   **{f: v for f, v in q.items() if f != "key"}}
                  for q in by_key]
        ev = EvaluationService(artifact_resolver=resolver,
                               compile_cache=CompileCache(max_entries=128))
        n0 = K.MAP_LAUNCHES
        t0 = time.perf_counter()
        res_key, meta_key = ev.evaluate_batch(by_key)
        key_s = time.perf_counter() - t0
        key_launches = K.MAP_LAUNCHES - n0
        res_dom, _ = ev.evaluate_batch(by_dom)
        for q, a, b in zip(by_key, res_key, res_dom):
            check(a["coords"].dtype == b["coords"].dtype
                  and a["coords"].tobytes() == b["coords"].tobytes(),
                  f"{q}: key and domain query differ")
        check(ev.batch_cache_key(by_key)[1]
              == tuple(sorted({arts[k].cache_key for k in keys})),
              "batch_cache_key does not list the artifact keys")
        menger = next(r.cache_key for k, r in grid.items()
                      if k[0] == "menger3d" and r.artifact is not None)
        refusals = {}
        for what, q, exc in (
                ("not deployable", {"key": menger, "n_points": 10},
                 ValueError),
                ("unknown", {"key": "0" * 64, "n_points": 10}, KeyError),
                ("malformed", {"key": "not-hex", "n_points": 10},
                 ValueError)):
            n0 = K.MAP_LAUNCHES
            try:
                ev.evaluate_batch([by_key[0], q])
            except exc as e:
                refusals[what] = f"{type(e).__name__}: {e}"
            else:
                raise AssertionError(f"a {what} key was not refused")
            check(K.MAP_LAUNCHES == n0, f"a {what} key launched a kernel")
        emit({"phase": "derive", "part": "evaluate_by_key",
              "card": self.card, "queries": len(by_key),
              "groups": meta_key["groups"], "launches": key_launches,
              "batch_s": key_s, "refusals": refusals})

        # -- the dry-run entry point, as a user runs it
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "REPRO_ARTIFACT_CACHE": str(work / "dryrun_store")}
        out_dir = work / "dryrun"
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun",
             "--domain-map", name, "--out", str(out_dir)],
            env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
            for name in ("tri2d", "menger3d")}
        done = {}
        for name, proc in procs.items():
            try:
                stdout, stderr = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            done[name] = (proc.returncode, stdout.strip(),
                          stderr.strip().splitlines()[-1:])
        rec_path = out_dir / "domain_map__tri2d__OSS:120b.json"
        check(done["tri2d"][0] == 0 and rec_path.exists()
              and json.loads(rec_path.read_text())["status"] == "ok",
              f"dryrun --domain-map tri2d: {done['tri2d']}")
        check(done["menger3d"][0] == 1
              and "not deployable" in " ".join(done["menger3d"][2]),
              f"dryrun --domain-map menger3d: {done['menger3d']}")
        emit({"phase": "derive", "part": "dryrun", "card": self.card,
              "tri2d": {"rc": done["tri2d"][0], "stdout": done["tri2d"][1],
                        "record": json.loads(rec_path.read_text())},
              "menger3d": {"rc": done["menger3d"][0],
                           "stderr": done["menger3d"][2]},
              "phase_s": time.perf_counter() - t_phase})

    # -- phase: serve ---------------------------------------------------------
    def _same_results(self, got: list, want: list, what: str,
                      meta: bool = True) -> None:
        """Socket answers against in-process ones: arrays bit-identical
        with equal dtypes, metadata (``meta``) equal but for
        ``executable``."""
        import numpy as np

        check(len(got) == len(want), f"{what}: {len(got)} results, want "
              f"{len(want)}")
        skip = ("coords", "mask", "executable")
        for i, (g, w) in enumerate(zip(got, want)):
            for field in ("coords", "mask"):
                if field in w:
                    check(field in g and g[field].dtype == w[field].dtype
                          and np.array_equal(g[field], w[field]),
                          f"{what}: result {i} {field} differs from the "
                          f"in-process one")
            check(not meta or {k: v for k, v in g.items() if k not in skip}
                  == {k: v for k, v in w.items() if k not in skip},
                  f"{what}: result {i} metadata differ from the in-process "
                  f"one")

    def _serve_frontend(self, cls, name, queries, want, sweep_want,
                        cells, menger_cell) -> dict:
        """One frontend in process: the evaluate batch cold, warm and off
        the wire LRU; derives then key queries and three refusals; a binary
        sweep; concurrent clients."""
        import threading

        from repro_torch.core import compile_cache
        from repro_torch.core.backends import MockLLMBackend
        from repro_torch.core.store import build_store
        from repro_torch.serving import (
            MappingService, RemoteMappingService, RemoteServiceError,
            batching_factory,
        )
        from repro_torch.serving.evaluate import MAX_POINTS

        K = self.K
        compile_cache.configure_default(max_entries=128)   # a cold launcher
        service = MappingService(
            store=build_store(ROOT / "build" / "serve" / name / "store"),
            backend_factory=batching_factory(MockLLMBackend),
            n_validate=DERIVE_N_VALIDATE, sample_every=DERIVE_SAMPLE_EVERY)
        out = {"frontend": name}
        with cls(service) as server:
            client = RemoteMappingService(server.url, timeout=300)
            # -- the evaluate batch: cold, warm (computed), off the wire LRU
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                got = client.evaluate_batch(queries)
                times.append(time.perf_counter() - t0)
                self._same_results(got, want, f"{name} evaluate batch")
            check([r["executable"] for r in got] == ["hit"] * len(got),
                  f"{name}: the repeats rode launcher misses")
            wire_stats = client.metrics()["evaluate_wire"]
            check(wire_stats["hits"] >= 1, f"{name}: the third batch was "
                  f"not served from the wire LRU: {wire_stats}")
            out.update(cold_s=times[0], warm_s=times[1], wire_lru_s=times[2],
                       evaluate_wire=wire_stats)

            # -- derive the deployable cells, then evaluate them by key
            t0 = time.perf_counter()
            derived = {c: client.derive(*c) for c in cells}
            menger = client.derive(*menger_cell)
            out["derive_s"] = time.perf_counter() - t0
            check(all(r.artifact is not None and r.artifact.deployable
                      for r in derived.values()),
                  f"{name}: a paper-deployable cell derived undeployable")
            check(menger.artifact is not None
                  and not menger.artifact.deployable,
                  f"{name}: {menger_cell} derived deployable")
            by_domain = {q["domain"]: w for q, w in zip(queries, want)
                         if q.get("tier", "map") == "map"
                         and q["n_points"] == MAX_POINTS}
            far_want = next(w for q, w in zip(queries, want)
                            if q.get("start") == FAR)
            n0 = K.MAP_LAUNCHES
            t0 = time.perf_counter()
            key_points = 0
            for dom in sorted({c[0] for c in cells}):
                batch = [{"key": derived[c].cache_key, "n_points": MAX_POINTS}
                         for c in cells if c[0] == dom]
                if dom == "tri2d":
                    batch.append({"key": batch[0]["key"], "n_points": 1 << 20,
                                  "start": FAR})
                res = client.evaluate_batch(batch)
                for q, r in zip(batch, res):
                    w = far_want if q.get("start") == FAR else by_domain[dom]
                    check(r["coords"].dtype == w["coords"].dtype
                          and r["coords"].tobytes() == w["coords"].tobytes(),
                          f"{name}: key query {q['key'][:12]} differs from "
                          f"the {dom} domain query")
                    key_points += q["n_points"]
            out.update(key_queries_s=time.perf_counter() - t0,
                       key_queries=len(cells) + 1, key_points=key_points,
                       key_launches=K.MAP_LAUNCHES - n0)
            refusals = {}
            for what, key, status in (
                    ("not deployable", menger.cache_key, 400),
                    ("unknown", "0" * 64, 404), ("malformed", "not-hex", 400)):
                n0 = K.MAP_LAUNCHES, K.MEMBERSHIP_LAUNCHES
                try:
                    client.evaluate_batch([
                        {"key": derived[cells[0]].cache_key, "n_points": 10},
                        {"key": key, "n_points": 10}])
                except RemoteServiceError as e:
                    check(e.status == status, f"{name}: a {what} key "
                          f"answered {e.status}, want {status}")
                    refusals[what] = f"{e.status}: {e}"
                else:
                    raise AssertionError(f"{name}: a {what} key was not "
                                         f"refused")
                check((K.MAP_LAUNCHES, K.MEMBERSHIP_LAUNCHES) == n0,
                      f"{name}: a {what} key launched a kernel")
            out["refusals"] = refusals

            # -- a binary sweep stream, every cell as in process
            t0 = time.perf_counter()
            swept = list(client.evaluate_sweep(list(self.DOMAINS),
                                               list(SERVE_SWEEP)))
            out["sweep_s"] = time.perf_counter() - t0
            out["sweep_cells"] = len(swept)
            # several cards split each cell (``executable: sharded``)
            self._same_results(swept, sweep_want, f"{name} sweep",
                               meta=self.torch.cuda.device_count() == 1)
            client.close()

            # -- concurrent clients, the wire LRU emptied so each computes
            server.eval_wire.clear()
            answers, errors = [None] * SERVE_CLIENTS, []
            n0 = K.MAP_LAUNCHES, K.MEMBERSHIP_LAUNCHES

            def one(i):
                try:
                    c = RemoteMappingService(server.url, timeout=300)
                    answers[i] = c.evaluate_batch(queries)
                    c.close()
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errors.append(repr(e))

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            out["concurrent_s"] = time.perf_counter() - t0
            check(not errors, f"{name}: concurrent clients failed: {errors}")
            for i, a in enumerate(answers):
                self._same_results(a, want, f"{name} concurrent client {i}")
            out["concurrent_launches"] = {
                "map_kernel": K.MAP_LAUNCHES - n0[0],
                "membership_kernel": K.MEMBERSHIP_LAUNCHES - n0[1]}
            check(out["concurrent_launches"]["map_kernel"] > 0,
                  f"{name}: the concurrent clients launched nothing")
            out["metrics_evaluate"] = client.metrics()["evaluate"]
        return out

    @contextlib.contextmanager
    def _serve_maps_process(self, extra: list, work: Path,
                            backend: str = "mock"):
        """``python -m repro_torch.launch.serve --serve-maps --port 0`` as a
        user runs it, over a fresh store under ``work``: yields its URL
        (from the first line) and a dict of its command, first line and
        boot seconds; on leaving the block, SIGINT and exit 0, put into the
        dict as ``rc``."""
        import os
        import signal

        work.mkdir(parents=True, exist_ok=True)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "REPRO_ARTIFACT_CACHE": str(work / "store")}
        argv = [sys.executable, "-m", "repro_torch.launch.serve",
                "--serve-maps", *(["--backend", backend]
                                  if backend != "mock" else []),
                "--port", "0", *extra]
        command = "python -m repro_torch.launch.serve " + " ".join(argv[3:])
        with open(work / "stderr.txt", "w") as err:
            proc = subprocess.Popen(argv, env=env, cwd=ROOT,
                                    stdout=subprocess.PIPE, stderr=err,
                                    text=True)
        try:
            t0 = time.perf_counter()
            first = proc.stdout.readline()
            info = {"command": command, "first_line": first.strip(),
                    "boot_s": time.perf_counter() - t0}
            check(first.startswith("mapping service on http://")
                  and f"backend={backend}" in first,
                  f"{command} printed {first!r} (stderr in "
                  f"{work / 'stderr.txt'})")
            yield first.split()[3], info
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=SERVE_BOOT_S)
            info["rc"] = proc.returncode
            check(proc.returncode == 0,
                  f"{command} exited {proc.returncode} on SIGINT")
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()

    def _serve_entry_point(self, extra: list, want: list) -> dict:
        """The ``--serve-maps`` entry point: /healthz, the 12 × 2^21 map
        queries as one binary batch, then SIGINT and exit 0."""
        import urllib.request

        from repro_torch.serving import RemoteMappingService

        work = ROOT / "build" / "serve" / (
            "entry_threaded" if "--no-async" in extra else "entry_async")
        with self._serve_maps_process(extra, work) as (url, info):
            with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
                health = json.loads(r.read())
            check(health.get("status") == "ok", f"/healthz said {health}")
            client = RemoteMappingService(url, timeout=300)
            queries = [{"domain": name, "n_points": q["n_points"]}
                       for name, q in zip(self.DOMAINS, want)]
            t0 = time.perf_counter()
            got = client.evaluate_batch(queries)
            eval_s = time.perf_counter() - t0
            self._same_results(got, want, info["command"])
            client.close()
        return {**info, "mode": health.get("mode"), "evaluate_s": eval_s}

    def sharded_sweep(self) -> dict:
        """The sweep's λ-range split over every card (two shards on the one
        card where there is one): each shard one map-kernel launch at its
        λ offset, every cell held against one unsplit launch."""
        import numpy as np

        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.serving.evaluate import MAX_POINTS, EvaluationService

        torch, K = self.torch, self.K
        n = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n)] if n > 1 \
            else ["cuda:0", "cuda:0"]
        sizes = (MAX_POINTS, MAX_POINTS // 2 + 3)   # even and uneven splits
        ev = EvaluationService(compile_cache=CompileCache(max_entries=64))
        whole, _ = ev.evaluate_batch([{"domain": name, "n_points": MAX_POINTS}
                                      for name in self.DOMAINS])
        self.sync()
        n0 = K.MAP_LAUNCHES
        t0 = time.perf_counter()
        cells = list(ev.sweep(list(self.DOMAINS), sizes, devices=devices))
        sweep_s = time.perf_counter() - t0
        launches = K.MAP_LAUNCHES - n0
        check(launches == len(cells) * len(devices),
              f"{launches} map launches for {len(cells)} cells over "
              f"{len(devices)} shards")
        check(ev.stats.sharded_dispatches == len(cells),
              f"sharded_dispatches {ev.stats.sharded_dispatches}")
        want = {r["domain"]: r["coords"] for r in whole}
        for c in cells:
            n_points = c["n_points"]
            check(c["executable"] == "sharded"
                  and c["devices"] == len(devices)
                  and c["padded"] == -(-n_points // len(devices))
                  * len(devices),
                  f"{c['domain']} at {n_points}: not a sharded cell")
            check(c["coords"].dtype == want[c["domain"]].dtype
                  and np.array_equal(c["coords"],
                                     want[c["domain"]][:n_points]),
                  f"{c['domain']} at {n_points}: the split differs from one "
                  f"launch")
        return {"devices": devices, "cells": len(cells), "sizes": sizes,
                "launches": launches, "sweep_s": sweep_s,
                "sharded_dispatches": ev.stats.sharded_dispatches}

    def serve(self) -> None:
        """Evaluation serving: both frontends in process over a fresh
        store each, then the ``--serve-maps`` entry point in both modes."""
        import shutil

        from repro_torch.core import paper_tables as pt
        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.serving import (
            AsyncMappingHTTPServer, MappingHTTPServer, wire,
        )
        from repro_torch.serving.evaluate import MAX_POINTS, EvaluationService

        t_phase = time.perf_counter()
        shutil.rmtree(ROOT / "build" / "serve", ignore_errors=True)
        queries = self._eval_queries(MAX_POINTS)
        cells = [(d, m, s) for d in sorted(pt.ACCURACY) for m in pt.MODELS
                 for s, (ordered, _, compiled)
                 in zip(pt.STAGES, pt.ACCURACY[d][m])
                 if compiled and ordered >= 100.0]
        check(len(cells) == 34, f"{len(cells)} deployable paper cells")
        menger_cell = ("menger3d", pt.MODELS[0], pt.STAGES[-1])

        # the in-process yardstick (its launches are not the socket path's)
        ev = EvaluationService(compile_cache=CompileCache(max_entries=64))
        t0 = time.perf_counter()
        want, _ = ev.evaluate_batch(queries)
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm, meta = ev.evaluate_batch(queries)
        warm_s = time.perf_counter() - t0
        self._same_results(warm, want, "in-process warm batch")
        # the server's share of a socket answer past the evaluation: the
        # frame's encoding; and the client's decoding (zero-copy views)
        t0 = time.perf_counter()
        frame = wire.encode_frame({"results": warm, "batch": meta})
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = wire.decode_frame(frame)["results"]
        decode_s = time.perf_counter() - t0
        self._same_results(decoded, want, "in-process frame")
        frame_bytes = len(frame)
        del frame, decoded
        sweep_want = list(ev.sweep(list(self.DOMAINS), list(SERVE_SWEEP)))
        maps_want, _ = ev.evaluate_batch(queries[:len(self.DOMAINS)])
        self.sync()

        self.reset_counts()
        frontends = [self._serve_frontend(cls, name, queries, want,
                                          sweep_want, cells, menger_cell)
                     for cls, name in ((AsyncMappingHTTPServer, "async"),
                                       (MappingHTTPServer, "threaded"))]
        sharded = self.sharded_sweep()
        self.sync()
        counts = self.counts()
        for k in ("map_kernel", "membership_kernel"):
            check(counts[k] > 0, f"the serve phase never launched {k}")
            self._add_path(k, "serve", counts[k])
        check(all(n == 0 for k, n in counts.items()
                  if k not in ("map_kernel", "membership_kernel")),
              f"other kernels launched in the serve phase: {counts}")
        entry = [self._serve_entry_point(extra, maps_want)
                 for extra in ([], ["--no-async"])]
        check([e["mode"] for e in entry] == ["async", "threaded"],
              f"the entry point booted {[e['mode'] for e in entry]}")
        emit({"phase": "serve", "card": self.card,
              "queries": len(queries),
              "points": sum(q.get("n_points", 0) for q in queries),
              "in_process": {"cold_s": cold_s, "warm_s": warm_s,
                             "encode_frame_s": encode_s,
                             "decode_frame_s": decode_s,
                             "frame_bytes": frame_bytes},
              "frontends": frontends, "sharded_sweep": sharded,
              "entry_point": entry,
              "main_path_launches": counts,
              "phase_s": time.perf_counter() - t_phase})

    # -- the examples ---------------------------------------------------------
    def _run_example(self, name: str, argv: list, label: str) -> tuple:
        """``examples_torch/<name>.py``'s ``main(argv)`` in process, its
        printed lines into build/examples/<label>.txt: its result and a row
        of its wall s and kernel launches, printed on a line of its own."""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            f"examples_torch_{name}", EXAMPLES / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self.sync()
        n0 = self.counts()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = mod.main(argv)
        self.sync()
        wall_s = time.perf_counter() - t0
        (ROOT / "build" / "examples" / f"{label}.txt").write_text(
            buf.getvalue())
        n1 = self.counts()
        row = {"example": label, "argv": argv, "wall_s": wall_s,
               "launches": {k: n1[k] - n0[k] for k in n1 if n1[k] != n0[k]}}
        emit(row)
        return out, row

    def _quickstart_subprocess(self, work: Path, want: dict) -> dict:
        """``python examples_torch/quickstart.py`` as a user types it: exit
        0, its kernel error within the simt tolerance, and its last line,
        the deployment line, the in-process run's."""
        import os

        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "REPRO_ARTIFACT_CACHE": str(work / "store_subprocess")}
        command = ["python", "examples_torch/quickstart.py"]
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, *command[1:]], cwd=ROOT,
                             env=env, capture_output=True, text=True,
                             timeout=600)
        wall_s = time.perf_counter() - t0
        (work / "quickstart_subprocess.txt").write_text(out.stdout
                                                        + out.stderr)
        check(out.returncode == 0, f"{' '.join(command)} exited "
              f"{out.returncode} (output in {work}/quickstart_subprocess.txt)")
        lines = out.stdout.strip().splitlines()
        err = float([ln for ln in lines if ln.startswith("kernel err vs")][-1]
                    .rsplit(":", 1)[1])
        check(err < ATTN_TOL["float32"], f"{' '.join(command)}: kernel err "
              f"{err} >= {ATTN_TOL['float32']}")
        m = re.search(r"([0-9.]+)x faster, ([0-9.]+)x less energy, amortized"
                      r" after ([0-9.]+) runs", lines[-1])
        check(m is not None and lines[-1] == want["lines"][-1],
              f"{' '.join(command)}: last line {lines[-1]!r}, in process "
              f"{want['lines'][-1]!r}")
        emit({"example": "quickstart (subprocess)", "wall_s": wall_s})
        return {"command": " ".join(command), "rc": out.returncode,
                "wall_s": wall_s, "kernel_err": err,
                "a100_model": dict(zip(
                    ("speedup", "energy_reduction", "runs_to_break_even"),
                    map(float, m.groups())))}

    def examples(self) -> None:
        """The five examples of examples_torch/ on the card as a user calls
        them, their kernels counted as a main path of their own."""
        import os
        import shutil

        import numpy as np

        t_phase = time.perf_counter()
        work = ROOT / "build" / "examples"
        shutil.rmtree(work, ignore_errors=True)
        work.mkdir(parents=True)
        old_cache = os.environ.get("REPRO_ARTIFACT_CACHE")
        os.environ["REPRO_ARTIFACT_CACHE"] = str(work / "store")
        rows = []
        try:
            self.reset_counts()
            qs, row = self._run_example("quickstart", [], "quickstart")
            rows.append(row)
            check(qs["perfect"], "quickstart: the tri2d map is not perfect")
            check(qs["route"] == "simt", f"quickstart took {qs['route']}")
            check(qs["err"] < ATTN_TOL["float32"], f"quickstart: kernel err "
                  f"{qs['err']} >= {ATTN_TOL['float32']}")
            check((qs["bb_steps"], qs["mapped_steps"])
                  == QUICKSTART_GRID_STEPS, "quickstart: grid steps "
                  f"{qs['bb_steps']} -> {qs['mapped_steps']}")
            fc, row = self._run_example("fractal_compute", [],
                                        "fractal_compute")
            rows.append(row)
            for name, r in fc["rows"].items():
                coords = r["coords"]
                check(len(np.unique(coords, axis=0)) == len(coords)
                      and bool(self.DOMAINS[name].contains(coords).all()),
                      f"fractal_compute: {name}'s mapped points are not "
                      f"bijective")
                check(int(r["mask"].sum()) == r["mapped_count"],
                      f"fractal_compute: {name}'s BB count "
                      f"{int(r['mask'].sum())} is not the mapped count "
                      f"{r['mapped_count']}")
            dd, row = self._run_example("derive_and_deploy", [],
                                        "derive_and_deploy")
            rows.append(row)
            check(dd["client2"]["derivations"] == 0,
                  f"derive_and_deploy: client 2 derived "
                  f"{dd['client2']['derivations']} cells")
            with self._serve_maps_process([], work / "server") as (url, srv):
                du, row = self._run_example(
                    "derive_and_deploy", ["--url", url],
                    "derive_and_deploy_url")
            rows.append(row)
            check(du["second_all_hits"] and du["client2_server_hits"]
                  == DERIVE_DEPLOY_CELLS,
                  f"derive_and_deploy --url: client 2 got "
                  f"{du['client2_server_hits']} server-side hits")
            # the server validates more points (--n-validate), so only the
            # rows of undeployable cells may read other percentages
            check(all(x == y for x, y in zip(dd["table"], du["table"])
                      if not (x.endswith("--") or y.endswith("--"))),
                  "derive_and_deploy: the deployable rows differ between "
                  "in process and --url")
            sl, row = self._run_example("serve_lm", [], "serve_lm")
            rows.append(row)
            check(sl["steps"] > 0 and sl["seqs"] == 4,
                  f"serve_lm generated {sl['steps']} steps x {sl['seqs']}")
            tl, row = self._run_example(
                "train_lm", ["--ckpt-dir", str(work / "train_ckpt")],
                "train_lm")
            rows.append(row)
            first = tl["logged_losses"][0] if tl["logged_losses"] else None
            check(math.isfinite(tl["final"]["loss"]) and first is not None
                  and tl["final"]["loss"] < first,
                  f"train_lm: final loss {tl['final']['loss']}, first "
                  f"logged {first}")
            self.sync()
            counts = self.counts()
        finally:
            if old_cache is None:
                os.environ.pop("REPRO_ARTIFACT_CACHE", None)
            else:
                os.environ["REPRO_ARTIFACT_CACHE"] = old_cache
        simt = counts["tri_attn"] - counts["tri_attn_sm90"]
        for k, n in (("map_kernel", counts["map_kernel"]),
                     ("membership_kernel", counts["membership_kernel"]),
                     ("tri_attn_simt", simt)):
            check(n > 0, f"the examples never launched {k}")
            self._add_path(k, "examples", n)
        if counts["tri_attn_sm90"]:
            self._add_sm90("examples", counts)
        sub = self._quickstart_subprocess(work, qs)
        shutil.rmtree(work / "train_ckpt", ignore_errors=True)
        emit({"phase": "examples", "card": self.card,
              "examples": rows, "quickstart_subprocess": sub,
              "quickstart": {"route": qs["route"], "kernel_err": qs["err"],
                             "grid_steps_bb_mapped": [qs["bb_steps"],
                                                      qs["mapped_steps"]],
                             "a100_model_amortization": {
                                 "speedup": qs["amortization"].speedup,
                                 "energy_reduction":
                                     qs["amortization"].energy_reduction,
                                 "runs_to_break_even":
                                     qs["amortization"].runs_to_break_even}},
              "fractal_compute": {
                  name: {k: r[k] for k in ("bb_cells", "bb_count",
                                           "mapped_count", "via",
                                           "waste_fraction")}
                  for name, r in fc["rows"].items()},
              "derive_and_deploy": {
                  "in_process": {"client1": dd["client1"],
                                 "client2": dd["client2"]},
                  "url": {"server": srv,
                          "client1_server_hits": du["client1_server_hits"],
                          "client2_server_hits": du["client2_server_hits"]},
                  "tables_equal": du["table"] == dd["table"]},
              "serve_lm": {"argv": sl["argv"], "steps": sl["steps"],
                           "lines": sl["lines"]},
              "train_lm": {"argv": tl["argv"],
                           "logged_losses": tl["logged_losses"],
                           "final": tl["final"]},
              "main_path_launches": counts,
              "phase_s": time.perf_counter() - t_phase})

    # -- phase 6 -------------------------------------------------------------
    def _attn_inputs(self, b, h, hk, s, d, dtype, gen):
        torch = self.torch
        q = torch.randn((b, h, s, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        k = torch.randn((b, hk, s, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        v = torch.randn((b, hk, s, d), generator=gen, device="cuda",
                        dtype=torch.float32).to(dtype)
        return q, k, v

    @staticmethod
    def _attn_bound_ms(b, h, hk, s, d, itemsize) -> tuple[float, dict]:
        """The least time for causal attention: its products (4·D flop for
        each of the S(S+1)/2 (query, key) pairs per (b, h)) against q, k, v
        read once and o written once at the memory rate.  bf16 products run
        at the bf16 rate; fp32 (itemsize 4) ones as three TF32 products
        (3xTF32, the least that keeps fp32 accuracy on the tensor cores) at
        the TF32 rate, with ``fp32_cores_ms`` the same flop at the CUDA
        cores' fp32 rate beside it."""
        flop = b * h * 4 * d * (s * (s + 1) // 2)
        nbytes = (2 * b * h + 2 * b * hk) * s * d * itemsize
        extra = {}
        if itemsize == 4:
            t_ops = 3 * flop / TF32_FLOP_PER_S * 1e3
            extra["fp32_cores_ms"] = flop / FP32_FLOP_PER_S * 1e3
        else:
            t_ops = flop / BF16_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), {
            "flop": flop, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes, **extra,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def _attn_fp32_held(self, q, k, v, blk, what, causal_attention,
                        causal_attention_ref):
        """The simt route in fp32 on one input: mapped ≡ BB bit for bit, and
        every element within 3e-5 of causal_attention_ref and of
        attention_pairs_plain at the card's G.  Returns the errors (also
        over rows S/2 and on) and the oracle's output."""
        torch, AK = self.torch, self.AK
        h, s, d = q.shape[1], q.shape[2], q.shape[3]
        check(AK.attention_route(q.dtype, blk, d) == "simt",
              f"{what}: not a simt shape")
        got = {mode: causal_attention(q, k, v, blk, blk, mode)
               for mode in ("mapped", "bounding_box")}
        self.sync()
        check(torch.equal(got["mapped"], got["bounding_box"]),
              f"{what}: mapped and BB outputs differ")
        g = h // k.shape[1]
        ref = causal_attention_ref(q, k.repeat_interleave(g, 1),
                                   v.repeat_interleave(g, 1))
        errs = {}
        for name, fn in (
                ("causal_attention_ref", lambda: ref),
                ("attention_pairs_plain",
                 lambda: AK.attention_plain(q, k, v, blk, "mapped"))):
            diff = (got["mapped"] - fn()).abs()
            errs[name] = float(diff.max())
            errs[name + "_rows_ge_half"] = float(diff[:, :, s // 2:].max())
            check(errs[name] < ATTN_TOL["float32"],
                  f"{what}: kernel vs {name} max abs err {errs[name]} >= "
                  f"{ATTN_TOL['float32']}")
            del diff
        return errs, ref

    def _attn_strip_sweep(self, q, k, v, blk, want, what) -> dict:
        """The simt route's mapped call at each strip length G of
        SIMT_STRIP_SWEEP up to nb (the route's private launcher): held
        within ATTN_TOL of ``want`` and timed in device ms, beside
        default_strip's G."""
        AK = self.AK
        tol = ATTN_TOL[str(q.dtype).removeprefix("torch.")]
        out = {}
        for g in SIMT_STRIP_SWEEP:
            if g > q.shape[2] // blk:
                continue
            fn = (lambda g=g: AK._launch_simt(q, k, v, blk, "mapped", g))
            err = float((fn().float() - want).abs().max())
            check(err < tol, f"{what} at G {g}: vs causal_attention_ref "
                  f"{err} >= {tol}")
            out[g] = self.device_ms(fn, n=5)
        return out

    def _attn_fp32_strips(self, gen, causal_attention,
                          causal_attention_ref) -> dict:
        """fp32 at block 64 (four warps a cell, K and V split into the
        shared hi/lo buffers) at ATTN_SPLIT_BF16's shape, where the chooser
        gives G > 1: strips of several tiles refill the cp.async ring and
        the combine merges several strips a row, held by
        ``_attn_fp32_held``; its device ms."""
        torch, AK = self.torch, self.AK
        b, h, hk, s, d, blk = ATTN_SPLIT_BF16
        q, k, v = self._attn_inputs(b, h, hk, s, d, torch.float32, gen)
        strip = AK.default_strip(b * h, s // blk, AK.sm_count(q.device))
        check(strip > 1, f"fp32 {ATTN_SPLIT_BF16}: G {strip}, want > 1")
        errs, _ = self._attn_fp32_held(q, k, v, blk,
                                       f"fp32 {ATTN_SPLIT_BF16}",
                                       causal_attention, causal_attention_ref)
        return {"shape": [b, h, hk, s, d, blk], "dtype": "float32",
                "strip": strip, **errs,
                "device_ms": self.device_ms(lambda: causal_attention(
                    q, k, v, blk, blk, "mapped"), n=10)}

    def _attn_main_fp32(self, gen, causal_attention, causal_attention_ref):
        """The LM path's shape in fp32 at block 128 (the simt route, 3xTF32
        products), held by ``_attn_fp32_held``: the four-strip combines of
        the deep rows as tightly as the sweep's short ones.  Then its device
        ms in both modes (calls back to back) and by strip length, beside
        its bound (three TF32 products), fp32 SDPA's device ms and the
        plain versions' single-call ms."""
        torch, AK = self.torch, self.AK
        b, h, hk, s, d, blk = ATTN_MAIN
        q, k, v = self._attn_inputs(b, h, hk, s, d, torch.float32, gen)
        errs, ref = self._attn_fp32_held(q, k, v, blk, "main shape fp32",
                                         causal_attention,
                                         causal_attention_ref)
        sweep = self._attn_strip_sweep(q, k, v, blk, ref, "main shape fp32")
        del ref
        kr, vr = (x.repeat_interleave(h // hk, 1) for x in (k, v))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bound_ms, bound = self._attn_bound_ms(b, h, hk, s, d, 4)
        nb = s // blk
        strip = AK.default_strip(b * h, nb, AK.sm_count(q.device))
        row = {
            "shape": {"B": b, "H": h, "Hk": hk, "S": s, "D": d, "block": blk,
                      "dtype": "float32"},
            "strip": strip,
            "cells": {"mapped": b * h * AK.strip_cells(nb, strip),
                      "bounding_box": b * h * nb * -(-nb // strip)},
            "device_ms": {mode: self.device_ms(
                lambda m=mode: causal_attention(q, k, v, blk, blk, m), n=10)
                for mode in ("mapped", "bounding_box")},
            "library_device_ms": self.device_ms(
                lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), n=5),
            "plain_ms": self.time_ms(lambda: causal_attention_ref(q, kr, vr),
                                     reps=3),
            "strip_plain_ms": self.time_ms(
                lambda: AK.attention_plain(q, k, v, blk, "mapped"), reps=3),
            # one mapped call's strip and combine kernels in the trace
            "own_kernels_ms": self._traced(lambda: causal_attention(
                q, k, v, blk, blk, "mapped"))["own_kernels_ms"],
            "strip_sweep_ms": sweep, "bound_ms": bound_ms, **bound, **errs}
        row["ms"] = row["device_ms"]["mapped"]
        row["x_bound"] = row["ms"] / bound_ms
        row["x_library"] = row["ms"] / row["library_device_ms"]
        return row

    def _attn_split(self, gen, causal_attention) -> list:
        """simt route: B·H split into several pair launches under a lowered
        ``WORKSPACE_CAP_BYTES`` (the last group short): bit-identical to one
        launch, and ceil(B·H / group) launches per call."""
        torch, AK = self.torch, self.AK
        rows = []
        for (b, h, hk, s, d, blk), dname, group in (
                (ATTN_CASES[-1], "float32", 3),
                (ATTN_SPLIT_BF16, "bfloat16", 5)):
            dtype = getattr(torch, dname)
            check(AK.attention_route(dtype, blk, d) == "simt",
                  f"{(b, h, s, d, blk)} {dname} is not a simt shape")
            q, k, v = self._attn_inputs(b, h, hk, s, d, dtype, gen)
            strip = AK.default_strip(b * h, s // blk, AK.sm_count(q.device))
            check(AK.bh_group(b * h, s, d, blk, strip) == b * h,
                  f"{(b, h, s, d, blk)} splits under the default cap")
            whole = causal_attention(q, k, v, blk, blk, "mapped")
            cap = AK.WORKSPACE_CAP_BYTES
            AK.WORKSPACE_CAP_BYTES = group * (
                AK.strip_cells(s // blk, strip) * blk * (d + 2) * 4)
            try:
                check(AK.bh_group(b * h, s, d, blk, strip) == group,
                      "the lowered cap gives another group")
                for mode in ("mapped", "bounding_box"):
                    n0 = AK.ATTN_LAUNCHES
                    out = causal_attention(q, k, v, blk, blk, mode)
                    n = AK.ATTN_LAUNCHES - n0
                    self.sync()
                    want_n = -(-(b * h) // group)
                    check(n == want_n, f"split {mode}: {n} launches, want "
                          f"{want_n}")
                    check(torch.equal(out, whole),
                          f"split {mode} {(b, h, s, d, blk)} {dname}: output"
                          f" differs from one launch")
            finally:
                AK.WORKSPACE_CAP_BYTES = cap
            rows.append({"shape": [b, h, hk, s, d, blk], "dtype": dname,
                         "strip": strip, "group": group, "launches": want_n,
                         "equal_to_one_launch": True})
        return rows

    @staticmethod
    def _row_gates(o, want, plain, what: str,
                   plain_name: str = "attention_stream_plain") -> dict:
        """A bf16 output o (fp32 view) against the oracle ``want`` and
        against its route's plain version ``plain`` at the same cells (per
        CTA on sm90, per strip on simt): all elements to 3e-2 of both; rows
        S/2 and on to LATE_ROW_RTOL of the row's max |o| against the oracle;
        every row to PLAIN_ROW_RTOL of its max |o| against the plain
        version."""
        tol = ATTN_TOL["bfloat16"]
        half = o.shape[2] // 2
        err = float((o - want).abs().max())
        late = float(((o[:, :, half:] - want[:, :, half:]).abs().amax(-1)
                      / want[:, :, half:].abs().amax(-1)).max())
        err_plain = float((o - plain).abs().max())
        rows_plain = float(((o - plain).abs().amax(-1)
                            / plain.abs().amax(-1)).max())
        check(err < tol, f"{what}: kernel vs causal_attention_ref max abs "
              f"err {err} >= {tol}")
        check(late < LATE_ROW_RTOL,
              f"{what}: rows >= {half}, kernel vs causal_attention_ref "
              f"{late} of the row's max |o| (gate {LATE_ROW_RTOL})")
        check(err_plain < tol, f"{what}: kernel vs {plain_name} max abs "
              f"err {err_plain} >= {tol}")
        check(rows_plain <= PLAIN_ROW_RTOL,
              f"{what}: kernel vs {plain_name} {rows_plain} of a row's max "
              f"|o| (gate {PLAIN_ROW_RTOL})")
        return {"vs_causal_attention_ref": err, "late_rows_rel": late,
                f"vs_{plain_name}": err_plain,
                f"rows_rel_vs_{plain_name}": rows_plain}

    def _attn_sm90_held(self, q, k, v, blk, what, causal_attention,
                        causal_attention_ref) -> dict:
        """The sm90 route on one input in both modes: each mode bitwise
        equal over two runs; ``_row_gates`` against causal_attention_ref
        and attention_stream_plain at the card's cells per CTA; mapped
        within 3e-2 of BB.  Returns the errors."""
        torch, AK = self.torch, self.AK
        b, h, s, d = q.shape
        tol = ATTN_TOL["bfloat16"]
        check(AK.attention_route(q.dtype, blk, d) == "sm90",
              f"{what}: not an sm90 shape")
        g = h // k.shape[1]
        want = causal_attention_ref(q, k.repeat_interleave(g, 1),
                                    v.repeat_interleave(g, 1)).float()
        errs, outs = {}, {}
        for mode in ("mapped", "bounding_box"):
            n0 = AK.ATTN_SM90_LAUNCHES
            out = causal_attention(q, k, v, blk, blk, mode)
            again = causal_attention(q, k, v, blk, blk, mode)
            self.sync()
            check(AK.ATTN_SM90_LAUNCHES - n0 == 2,
                  f"{what} {mode}: did not take the sm90 route")
            check(torch.equal(out, again),
                  f"{what} {mode}: two runs differ (not deterministic)")
            del again
            plain = AK.attention_plain(q, k, v, blk, mode).float()
            errs[mode] = self._row_gates(out.float(), want, plain,
                                         f"{what} {mode}")
            del plain
            outs[mode] = out
        mb = float((outs["mapped"].float() - outs["bounding_box"].float())
                   .abs().max())
        check(mb < tol, f"{what}: mapped vs BB max abs err {mb} >= {tol}")
        errs["mapped_vs_bb"] = mb
        errs["mapped_equals_bb_bitwise"] = bool(
            torch.equal(outs["mapped"], outs["bounding_box"]))
        return errs

    def _attn_sm90_u(self, gen, causal_attention_ref) -> list:
        """The sm90 kernel at explicit cells per CTA (U), through the
        route's private launcher (``launch_attention`` takes the card's U),
        held by ``_row_gates`` against attention_stream_plain at the same U
        and against the oracle: rows split across three or more CTAs,
        U = 1, a CTA over more than one (b, h)."""
        torch, AK = self.torch, self.AK
        b, h, hk, s, d, blk = ATTN_U_CASE
        q, k, v = self._attn_inputs(b, h, hk, s, d, torch.bfloat16, gen)
        want = causal_attention_ref(q, k.repeat_interleave(h // hk, 1),
                                    v.repeat_interleave(h // hk, 1)).float()
        nb = s // blk
        rows = []
        for u in ATTN_U_VALUES:
            for mode in ("mapped", "bounding_box"):
                out = AK._launch_sm90(q, k, v, mode, u).float()
                self.sync()
                plain = AK.attention_stream_plain(q, k, v, blk, u,
                                                  mode).float()
                gates = self._row_gates(out, want, plain,
                                        f"sm90 U={u} {mode}")
                pieces = AK.stream_pieces(b * h, nb, u, mode)
                rows.append({"U": u, "mode": mode,
                             "ctas": AK.stream_ctas(b * h, nb, u, mode),
                             "split_rows": len(pieces),
                             "max_ctas_per_row": max(
                                 (len(p[2]) for p in pieces), default=1),
                             **gates})
        check(max(r["max_ctas_per_row"] for r in rows) >= 3,
              "no U split a row across three CTAs")
        check(max(r["U"] for r in rows) > AK.tri_grid_size(nb),
              "no U took more than one (b, h)")
        return rows

    def _attn_ptxas(self, route: str) -> dict | None:
        """Registers and spill bytes of the route's kernels, from nvcc's
        ``-Xptxas -v`` output (None where this process did not build):
        sm90, every kernel; simt, the kernel count, the most registers,
        every kernel that spills and the instantiations timed at ATTN_MAIN
        (bf16 block 64, fp32 block 128, head_dim 128)."""
        log = self.build_mod.BUILD_LOG.get("tri_attn")
        if not log:
            return None
        out = {}
        for part in log.split("Compiling entry function")[1:]:
            name = part.split("'")[1] if "'" in part else part.split()[0]
            if ("sm90" in name) != (route == "sm90") or (
                    route == "simt" and "ta_strip" not in name):
                continue
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            out[name] = {"registers": int(regs.group(1)) if regs else None,
                         "spill_store_bytes": int(spill.group(1))
                         if spill else None}
        if route == "sm90":
            return out
        timed = ("I13__nv_bfloat16Li64ELi128E", "IfLi128ELi128E")
        return {"kernels": len(out),
                "max_registers": max((r["registers"] or 0
                                      for r in out.values()), default=None),
                "spilling": {n: r["spill_store_bytes"] for n, r in out.items()
                             if r["spill_store_bytes"]},
                "timed": {n: r for n, r in out.items()
                          if any(t in n for t in timed)}}

    def attention(self) -> None:
        torch, AK = self.torch, self.AK
        from repro_torch.kernels.tri_attn.ops import causal_attention
        from repro_torch.kernels.tri_attn.ref import causal_attention_ref

        gen = torch.Generator(device="cuda").manual_seed(2)
        worst, routes = {}, {}
        for dname, dtype in (("float32", torch.float32),
                             ("bfloat16", torch.bfloat16)):
            for b, h, hk, s, d, blk in ATTN_CASES:
                q, k, v = self._attn_inputs(b, h, hk, s, d, dtype, gen)
                g = h // hk
                route = AK.attention_route(dtype, blk, d)
                routes[route] = routes.get(route, 0) + 1
                want = causal_attention_ref(q, k.repeat_interleave(g, 1),
                                            v.repeat_interleave(g, 1))
                outs = {mode: causal_attention(q, k, v, blk, blk, mode)
                        for mode in ("mapped", "bounding_box")}
                self.sync()
                if route == "simt":
                    check(torch.equal(outs["mapped"], outs["bounding_box"]),
                          f"{dname} {(b, h, hk, s, d, blk)}: mapped and BB "
                          f"outputs differ")
                for mode, out in outs.items():
                    what = ("attention_pairs_plain" if route == "simt"
                            else "attention_stream_plain")
                    plain = AK.attention_plain(q, k, v, blk, mode)
                    for other, name in ((want, "causal_attention_ref"),
                                        (plain, what)):
                        err = float((out.float() - other.float())
                                    .abs().max())
                        worst[dname] = max(worst.get(dname, 0.0), err)
                        check(err < ATTN_TOL[dname],
                              f"{dname} {(b, h, hk, s, d, blk)} {route} "
                              f"{mode}: kernel vs {name} max abs err {err} "
                              f">= {ATTN_TOL[dname]}")
                if route == "sm90":
                    err = float((outs["mapped"].float()
                                 - outs["bounding_box"].float()).abs().max())
                    check(err < ATTN_TOL[dname],
                          f"{dname} {(b, h, hk, s, d, blk)}: mapped vs BB "
                          f"{err}")
        check(set(routes) == {"simt", "sm90"},
              f"the sweep took routes {routes}")
        # the device-side staircase map λ -> (i, g), exact against int64
        # torch: at G = 1 (the triangular map) for every λ < T(NB_MAP), at
        # G = 8 and 16 for every λ < C(NB_MAP, G), and at each of
        # MAP_STRIPS in windows across 2^31 and at 2^33 cells
        ranges = [(1, 0, AK.tri_grid_size(NB_MAP)),
                  (8, 0, AK.strip_cells(NB_MAP, 8)),
                  (16, 0, AK.strip_cells(NB_MAP, 16))]
        for strip in MAP_STRIPS:
            ranges += [(strip, (1 << 31) - (1 << 22), 1 << 23),
                       (strip, 1 << 33, 1 << 22)]
        step = 1 << 27
        for strip, lo0, count in ranges:
            for lo in range(lo0, lo0 + count, step):
                n = min(step, lo0 + count - lo)
                i, g = AK.lam_to_ig_device(lo, n, strip)
                ei, eg = AK.lam_to_ig(torch.arange(lo, lo + n, device="cuda"),
                                      strip)
                check(torch.equal(i.to(torch.int64), ei)
                      and torch.equal(g.to(torch.int64), eg),
                      f"device staircase map (G {strip}) differs from int64 "
                      f"torch in [{lo}, {lo + n})")
                del i, g, ei, eg
        total = AK.tri_grid_size(NB_MAP)
        # gradients through the autograd.Function (backward: the oracle)
        q, k, v = self._attn_inputs(1, 4, 2, 128, 32, torch.float32, gen)
        w = torch.randn(q.shape, generator=gen, device="cuda")
        qs = [t.clone().requires_grad_() for t in (q, k, v)]
        (causal_attention(*qs, 32, 32, "mapped") * w).sum().backward()
        rs = [t.clone().requires_grad_() for t in (q, k, v)]
        (causal_attention_ref(rs[0], rs[1].repeat_interleave(2, 1),
                              rs[2].repeat_interleave(2, 1)) * w).sum() \
            .backward()
        grad_err = max(float((a.grad - r.grad).abs().max())
                       for a, r in zip(qs, rs))
        check(grad_err < 1e-5, f"tri_attn gradients differ by {grad_err}")
        u_rows = self._attn_sm90_u(gen, causal_attention_ref)
        gqa64 = self._attn_inputs(*ATTN_GQA64[:5], torch.bfloat16, gen)
        gqa64_errs = self._attn_sm90_held(*gqa64, ATTN_GQA64[5],
                                          f"GQA D 64 {ATTN_GQA64}",
                                          causal_attention,
                                          causal_attention_ref)
        del gqa64

        # the LM path's shape: the sm90 route held, then both routes timed
        b, h, hk, s, d, blk = ATTN_MAIN
        q, k, v = self._attn_inputs(b, h, hk, s, d, torch.bfloat16, gen)
        main_errs = self._attn_sm90_held(q, k, v, blk, f"main {ATTN_MAIN}",
                                         causal_attention,
                                         causal_attention_ref)
        ms = {mode: self.time_ms(
            lambda m=mode: causal_attention(q, k, v, blk, blk, m))
            for mode in ("mapped", "bounding_box")}
        # the simt route on the same inputs at the block-64 forward's block
        simt_out = {mode: causal_attention(q, k, v, LM_SIMT_BLOCK,
                                           LM_SIMT_BLOCK, mode)
                    for mode in ("mapped", "bounding_box")}
        self.sync()
        check(torch.equal(simt_out["mapped"], simt_out["bounding_box"]),
              "simt block 64 at the main shape: mapped and BB differ")
        kr, vr = (x.repeat_interleave(h // hk, 1) for x in (k, v))
        want = causal_attention_ref(q, kr, vr).float()
        simt_errs = self._row_gates(
            simt_out["mapped"].float(), want,
            AK.attention_plain(q, k, v, LM_SIMT_BLOCK, "mapped").float(),
            "simt block 64 at the main shape", "attention_pairs_plain")
        simt_err = simt_errs["vs_causal_attention_ref"]
        del simt_out
        simt_sweep = self._attn_strip_sweep(q, k, v, LM_SIMT_BLOCK, want,
                                            "simt block 64 at the main shape")
        del want
        simt_ms = {mode: self.time_ms(
            lambda m=mode: causal_attention(q, k, v, LM_SIMT_BLOCK,
                                            LM_SIMT_BLOCK, m), reps=3)
            for mode in ("mapped", "bounding_box")}
        simt_device_ms = {mode: self.device_ms(
            lambda m=mode: causal_attention(q, k, v, LM_SIMT_BLOCK,
                                            LM_SIMT_BLOCK, m), n=10)
            for mode in ("mapped", "bounding_box")}
        simt_kernels_ms = self._traced(lambda: causal_attention(
            q, k, v, LM_SIMT_BLOCK, LM_SIMT_BLOCK, "mapped"))[
                "own_kernels_ms"]
        check(set(simt_kernels_ms) == {"ta_strip_mapped_kernel",
                                       "ta_strip_combine_kernel"},
              f"the trace split names the simt call's kernels "
              f"{sorted(simt_kernels_ms)}")
        fp32_row = self._attn_main_fp32(gen, causal_attention,
                                        causal_attention_ref)
        fp32_strips = self._attn_fp32_strips(gen, causal_attention,
                                             causal_attention_ref)
        split = self._attn_split(gen, causal_attention)
        plain_ms = self.time_ms(lambda: causal_attention_ref(q, kr, vr),
                                reps=3)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        library_ms = self.time_ms(
            lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
        # the host's share of a single call, which the medians above include
        host_us = {"sm90_mapped": self.host_us(
            lambda: causal_attention(q, k, v, blk, blk, "mapped")),
            "simt_mapped_block64": self.host_us(
                lambda: causal_attention(q, k, v, LM_SIMT_BLOCK,
                                         LM_SIMT_BLOCK, "mapped")),
            "library": self.host_us(
                lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))}
        bound_ms, bound = self._attn_bound_ms(b, h, hk, s, d, 2)
        nb = s // blk
        u = AK.default_steps_per_cta(b * h, nb, AK.sm_count(q.device))
        ctas = {mode: AK.stream_ctas(b * h, nb, u, mode)
                for mode in ("mapped", "bounding_box")}
        ptxas = self._attn_ptxas("sm90")
        for mode in ("mapped", "bounding_box"):
            emit({"phase": "attention", "card": self.card, "route": "sm90",
                  "mode": mode,
                  "shape": {"B": b, "H": h, "Hk": hk, "S": s, "D": d,
                            "block": blk, "dtype": "bfloat16"},
                  "ms": ms[mode], "ctas": ctas[mode], "steps_per_cta": u,
                  "bound_ms": bound_ms, **bound, "plain_ms": plain_ms,
                  "library_ms": library_ms, "x_bound": ms[mode] / bound_ms,
                  "x_library": ms[mode] / library_ms})
        nb64 = s // LM_SIMT_BLOCK
        strip64 = AK.default_strip(b * h, nb64, AK.sm_count(q.device))
        simt_ptxas = self._attn_ptxas("simt")
        emit({"phase": "attention", "card": self.card, "route": "simt",
              "shape": {"B": b, "H": h, "Hk": hk, "S": s, "D": d,
                        "block": LM_SIMT_BLOCK, "dtype": "bfloat16"},
              "ms": simt_ms["mapped"], "bb_ms": simt_ms["bounding_box"],
              "device_ms": simt_device_ms, "strip": strip64,
              "strip_sweep_ms": simt_sweep,
              "own_kernels_ms": simt_kernels_ms,
              "cells": {"mapped": b * h * AK.strip_cells(nb64, strip64),
                        "bounding_box": b * h * nb64 * -(-nb64 // strip64)},
              "pair_launches_per_call": -(-(b * h) // AK.bh_group(
                  b * h, s, d, LM_SIMT_BLOCK, strip64)),
              "bound_ms": bound_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, "max_abs_err": simt_err,
              "x_bound": simt_device_ms["mapped"] / bound_ms,
              "x_library": simt_device_ms["mapped"] / library_ms})
        emit({"phase": "attention", "card": self.card, "route": "simt",
              **fp32_row})
        self.attn_row = {"ms": ms["mapped"], "bb_ms": ms["bounding_box"],
                         "plain_ms": plain_ms, "library_ms": library_ms,
                         "bound_ms": bound_ms,
                         "bound_by": bound["bound_by"],
                         "max_abs_err":
                             main_errs["mapped"]["vs_causal_attention_ref"]}
        self.attn_simt_row = {
            "ms": simt_ms["mapped"], "bb_ms": simt_ms["bounding_box"],
            "device_ms": simt_device_ms["mapped"],
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound["bound_by"],
            "max_abs_err": simt_err,
            "fp32_block128": {
                k: fp32_row[k] for k in (
                    "device_ms", "library_device_ms", "plain_ms",
                    "bound_ms", "bound_by", "fp32_cores_ms",
                    "causal_attention_ref")}}
        emit({"phase": "attention", "card": self.card,
              "cases": len(ATTN_CASES) * 2, "routes": routes,
              "max_abs_err": worst, "main_bf16_sm90": main_errs,
              "late_row_rtol": LATE_ROW_RTOL,
              "plain_row_rtol": PLAIN_ROW_RTOL,
              "gqa_d64_sm90": gqa64_errs,
              "main_bf16_block64_simt": simt_errs,
              "fp32_strips_simt": fp32_strips,
              "sm90_steps_per_cta": u_rows,
              "main_fp32_simt": {k: fp32_row[k] for k in fp32_row
                                 if k.startswith(("causal_attention_ref",
                                                  "attention_pairs_plain"))},
              "bh_split_simt": split, "simt_mapped_equals_bb": True,
              "sm90_deterministic": True, "lam_map_exact_below": total,
              "staircase_map_exact": [list(r) for r in ranges],
              "grad_max_abs_err": grad_err, "sm90_ptxas": ptxas,
              "simt_ptxas": simt_ptxas,
              "bb_over_mapped": ms["bounding_box"] / ms["mapped"],
              "mapped_over_library": ms["mapped"] / library_ms,
              "host_us_per_call": host_us,
              "simt_bb_over_mapped": simt_ms["bounding_box"]
              / simt_ms["mapped"]})

    # -- phase 7 -------------------------------------------------------------
    def lm_forward(self) -> None:
        import numpy as np

        torch, AK = self.torch, self.AK
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params
        from repro_torch.train.train_step import lm_loss

        torch.cuda.empty_cache()
        cfg = get_config(LM_ARCH)
        t0 = time.perf_counter()
        self.lm_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        self.sync()
        init_s = time.perf_counter() - t0
        params = self.lm_params
        n_params = count_params(params)
        check(abs(n_params - 6.06e9) < 0.01e9, f"{n_params} parameters")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (1, LM_SEQ), dtype=np.int64)).cuda()
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        T.forward(params, cfg, tokens[:, :256])      # warm-up (cuBLAS etc.)
        self.sync()

        self.reset_counts()
        rows, logits = {}, {}
        nb64 = LM_SEQ // LM_SIMT_BLOCK
        simt_per_call = -(-cfg.n_heads // AK.bh_group(
            cfg.n_heads, LM_SEQ, cfg.head_dim, LM_SIMT_BLOCK,
            AK.default_strip(cfg.n_heads, nb64, AK.sm_count("cuda"))))
        check(simt_per_call == 1, f"the block-{LM_SIMT_BLOCK} forward makes "
              f"{simt_per_call} simt strip launches a layer, want 1")
        for impl in ("pallas_mapped", "pallas_bb", "xla"):
            c = cfg.replace(attn_impl=impl)
            n0 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
            t0 = time.perf_counter()
            out = T.forward(params, c, tokens)
            self.sync()
            fwd_s = time.perf_counter() - t0
            n1 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
            t0 = time.perf_counter()
            loss, metrics = lm_loss(params, c, batch)
            ce = float(metrics["ce"])
            loss_s = time.perf_counter() - t0
            n2 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
            want = 0 if impl == "xla" else LM_LAUNCHES
            for what, x in (("tri_attn", 0), ("sm90", 1)):
                check(n1[x] - n0[x] == want and n2[x] - n1[x] == want,
                      f"{impl}: {n1[x] - n0[x]} and {n2[x] - n1[x]} {what} "
                      f"launches per forward, want {want}")
            check(out.shape == (1, LM_SEQ, cfg.padded_vocab)
                  and out.dtype == torch.float32, f"{impl}: logits shape")
            check(bool(torch.isfinite(out).all()) and math.isfinite(ce),
                  f"{impl}: logits or loss not finite")
            logits[impl] = out
            rows[impl] = {"forward_s": fwd_s, "lm_loss_s": loss_s,
                          "loss": float(loss), "ce": ce,
                          "launches_forward": n1[0] - n0[0],
                          "sm90_launches_forward": n1[1] - n0[1],
                          "launches_lm_loss": n2[0] - n1[0]}
        # the simt route on the main path: the same forward at block 64
        impl = f"pallas_mapped_block{LM_SIMT_BLOCK}"
        n0 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
        t0 = time.perf_counter()
        out = T.forward(params, cfg.replace(attn_impl="pallas_mapped",
                                            attn_block=LM_SIMT_BLOCK), tokens)
        self.sync()
        fwd_s = time.perf_counter() - t0
        n1 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
        want = LM_LAUNCHES * simt_per_call
        check(n1[0] - n0[0] == want and n1[1] == n0[1],
              f"{impl}: {n1[0] - n0[0]} launches ({n1[1] - n0[1]} sm90) per "
              f"forward, want {want} simt")
        check(bool(torch.isfinite(out).all()), f"{impl}: logits not finite")
        logits[impl] = out
        rows[impl] = {"forward_s": fwd_s, "launches_forward": n1[0] - n0[0],
                      "sm90_launches_forward": 0,
                      "pair_launches_per_call": simt_per_call}
        counts = self.counts()
        self._add_sm90("lm_forward", counts)
        self._add_path("tri_attn_simt", "lm_forward",
                       counts["tri_attn"] - counts["tri_attn_sm90"])
        x = logits["xla"]
        scale = float(x.abs().max())
        # every kernel forward against xla, and mapped against BB: the sm90
        # route splits rows at other places in the two modes, so they agree
        # to rounding (carried through 32 layers), no longer bit for bit
        rel = {name: float((logits[name] - x).abs().max()) / scale
               for name in ("pallas_mapped", "pallas_bb", impl)}
        mapped_vs_bb = float((logits["pallas_mapped"] - logits["pallas_bb"])
                             .abs().max()) / scale
        for name, r in rel.items():
            check(r <= FWD_LOGIT_RTOL,
                  f"logits {name} vs xla: {r} of max |logit|")
        check(mapped_vs_bb <= FWD_LOGIT_RTOL,
              f"logits mapped vs BB: {mapped_vs_bb} of max |logit|")
        for name in ("pallas_bb", impl):
            del logits[name]
        k = logits["pallas_mapped"]
        ce_rel = abs(rows["pallas_mapped"]["ce"] - rows["xla"]["ce"]) \
            / abs(rows["xla"]["ce"])
        top1 = float((k.argmax(-1) == x.argmax(-1)).float().mean())
        max_diff = float((k - x).abs().max())
        del logits, k
        fwd_rel = max_diff / scale
        # the control: the same forward with a deep-row combine fault
        control_rel, control_ce_rel = self._faulty_forward_rel(
            params, cfg, tokens, x)
        del x
        check(control_rel > FWD_LOGIT_RTOL,
              f"the control fault moved the logits by only {control_rel}: "
              f"the {FWD_LOGIT_RTOL} gate cannot see it")
        check(ce_rel <= CE_RTOL, f"CE kernel vs xla: relative {ce_rel}")
        check(top1 >= TOP1_MIN, f"top-1 agreement kernel vs xla {top1}")
        emit({"phase": "lm_forward", "card": self.card, "arch": LM_ARCH,
              "params": n_params, "dtype": cfg.dtype, "tokens": [1, LM_SEQ],
              "init_s": init_s, "impls": rows,
              "logit_rel_vs_xla_by_impl": rel,
              "logit_rel_mapped_vs_bb": mapped_vs_bb,
              "ce_rel_vs_xla": ce_rel,
              "ce_rtol": CE_RTOL, "top1_vs_xla": top1, "top1_min": TOP1_MIN,
              "max_abs_logit_diff_vs_xla": max_diff,
              "max_abs_logit_xla": scale, "logit_rel_vs_xla": fwd_rel,
              "logit_rtol": FWD_LOGIT_RTOL,
              "control_fault_logit_rel_vs_xla": control_rel,
              "control_fault_ce_rel_vs_xla": control_ce_rel,
              "main_path_launches": counts,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    def _faulty_forward_rel(self, params, cfg, tokens,
                            xla_logits) -> tuple[float, float]:
        """max |Δ logit| / max |logit| against ``xla_logits`` of a kernel
        forward whose attention drops the j = 0 partial of every row from
        S/2 on, as a combine that starts one partial late would: one of 17
        to 32 partials.  Also the relative change of the next-token CE."""
        F = self.torch.nn.functional
        from repro_torch.kernels.tri_attn import ops
        from repro_torch.models import transformer as T

        real = ops.causal_attention

        def faulty(q, k, v, block_q=128, block_k=128, grid_mode="mapped",
                   interpret=False):
            o = real(q, k, v, block_q, block_k, grid_mode, interpret)
            half = q.shape[2] // 2
            tail = real(q[:, :, block_q:], k[:, :, block_q:],
                        v[:, :, block_q:], block_q, block_k, grid_mode,
                        interpret)
            o[:, :, half:] = tail[:, :, half - block_q:]
            return o

        ops.causal_attention = faulty
        try:
            out = T.forward(params, cfg.replace(attn_impl="pallas_mapped"),
                            tokens)
        finally:
            ops.causal_attention = real
        rel = float((out - xla_logits).abs().max()) \
            / float(xla_logits.abs().max())
        labels = tokens[0, 1:]
        ce = [float(F.cross_entropy(x[0, :-1, :cfg.vocab_size], labels))
              for x in (out, xla_logits)]
        del out
        return rel, abs(ce[0] - ce[1]) / ce[1]

    # -- launch and analysis tooling (queue 1 item 10) -----------------------
    def _lm_model(self):
        """yi-6b at full width: lm_forward's weights, or the same made anew
        (the short runs)."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T

        if getattr(self, "lm_params", None) is None:
            self.lm_params = T.init_params(
                get_config(LM_ARCH),
                torch.Generator(device="cuda").manual_seed(0), "cuda")
        return self.lm_params

    def _lm_tokens(self, cfg, shape, seed):
        import numpy as np

        return self.torch.from_numpy(np.random.default_rng(seed).integers(
            0, cfg.vocab_size, shape, dtype=np.int64)).cuda()

    def _layer_grads(self, layer, cfg, x, g) -> list:
        """fp32 gradients of <layer(x), g> with respect to x and the
        attention's weights."""
        from repro_torch.models import transformer as T

        x = x.detach().requires_grad_(True)
        ws = [layer.attn.wq, layer.attn.wk, layer.attn.wv, layer.attn.wo]
        out, _ = T._layer_apply(layer, cfg, x)
        return list(self.torch.autograd.grad((out * g).sum(), [x, *ws]))

    def xla_mapped(self) -> None:
        """attn_impl="xla_mapped" (the mapped block-pair batch in plain
        torch) at yi-6b's full width, bf16, tokens (1, 4096): forward and
        lm_loss against xla with lm_forward's gates and against the kernel
        (pallas_mapped); wall seconds of each; one layer's gradients in
        fp32 against xla; the peak memory of the xla_mapped forward."""
        import copy

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.distribution.sharding import set_param
        from repro_torch.models import transformer as T
        from repro_torch.train.train_step import lm_loss

        params = self._lm_model()
        cfg = get_config(LM_ARCH)
        tokens = self._lm_tokens(cfg, (1, LM_SEQ), 1)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        T.forward(params, cfg.replace(attn_impl="xla_mapped"),
                  tokens[:, :512])                   # warm-up
        self.sync()
        rows, logits = {}, {}
        for impl in ("xla_mapped", "xla", "pallas_mapped"):
            c = cfg.replace(attn_impl=impl)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = T.forward(params, c, tokens)
            self.sync()
            fwd_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() / 1e9
            t0 = time.perf_counter()
            loss, metrics = lm_loss(params, c, batch)
            ce = float(metrics["ce"])
            loss_s = time.perf_counter() - t0
            check(out.shape == (1, LM_SEQ, cfg.padded_vocab)
                  and bool(torch.isfinite(out).all()) and math.isfinite(ce),
                  f"{impl}: logits or CE not finite")
            logits[impl] = out
            rows[impl] = {"forward_s": fwd_s, "lm_loss_s": loss_s,
                          "ce": ce, "forward_peak_gb": peak}
        x = logits["xla"]
        scale = float(x.abs().max())
        rel = {w: float((logits["xla_mapped"] - logits[w]).abs().max())
               / scale for w in ("xla", "pallas_mapped")}
        for w, r in rel.items():
            check(r <= FWD_LOGIT_RTOL,
                  f"xla_mapped logits vs {w}: {r} of max |logit|")
        ce_rel = abs(rows["xla_mapped"]["ce"] - rows["xla"]["ce"]) \
            / abs(rows["xla"]["ce"])
        check(ce_rel <= CE_RTOL, f"xla_mapped CE vs xla: relative {ce_rel}")
        top1 = float((logits["xla_mapped"].argmax(-1) == x.argmax(-1))
                     .float().mean())
        check(top1 >= TOP1_MIN, f"xla_mapped top-1 vs xla {top1}")
        del logits, x, out
        torch.cuda.empty_cache()

        # one layer in fp32: gradients of x and the attention's weights
        layer = copy.deepcopy(params.layers[0])
        for n, w in list(layer.named_parameters()):
            set_param(layer, n, w.detach().to(torch.float32))
            layer.get_parameter(n).requires_grad_(True)
        c32 = cfg.replace(dtype="float32")
        xin = params.embed[tokens].to(torch.float32)
        gen = torch.Generator(device="cuda").manual_seed(3)
        g = torch.randn(xin.shape, device="cuda", generator=gen)
        want = self._layer_grads(layer, c32.replace(attn_impl="xla"), xin, g)
        t0 = time.perf_counter()
        got = self._layer_grads(layer, c32.replace(attn_impl="xla_mapped"),
                                xin, g)
        self.sync()
        grad_s = time.perf_counter() - t0
        names = ("x", "wq", "wk", "wv", "wo")
        grad_rel = {n: float((a - b).abs().max()) / float(b.abs().max())
                    for n, a, b in zip(names, got, want)}
        for n, r in grad_rel.items():
            check(r <= XLA_MAPPED_GRAD_RTOL,
                  f"xla_mapped layer gradient of {n} vs xla: {r} of max")
        del layer, got, want, xin, g
        torch.cuda.empty_cache()
        emit({"phase": "xla_mapped", "card": self.card, "arch": LM_ARCH,
              "dtype": cfg.dtype, "tokens": [1, LM_SEQ], "impls": rows,
              "logit_rel_vs": rel, "logit_rtol": FWD_LOGIT_RTOL,
              "ce_rel_vs_xla": ce_rel, "top1_vs_xla": top1,
              "layer_grad_rel_fp32": grad_rel,
              "grad_rtol": XLA_MAPPED_GRAD_RTOL,
              "layer_grad_s": grad_s,
              "block_pairs": "T(16) = 136 padded to 144, chunk 256"})

    def _traced(self, fn) -> dict:
        """``hlo_analysis.analyze`` of one ``fn()`` under torch.profiler
        (CPU and CUDA activity, FLOPs recorded), after one warm-up call."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch import hlo_analysis

        fn()
        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     with_flops=True) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall = (time.perf_counter() - t0) * 1e3
        a = hlo_analysis.analyze(prof)
        top = sorted(a["launches"].items(), key=lambda kv: -kv[1])[:12]
        return {"wall_ms": wall, "window_ms": a["window_us"] / 1e3,
                "device_busy_ms": a["device_busy_us"] / 1e3,
                "busy_share": a["busy_share"], "idle_share": a["idle_share"],
                "ms_by_category": {k: v / 1e3 for k, v in
                                   a["time_by_category_us"].items()},
                "own_kernels_ms": {k: v / 1e3 for k, v in
                                   a["own_kernels_us"].items()},
                "launches_top": top,
                "kernel_launches": sum(a["launches"].values()),
                "ta_sm90_kernel": a["launches"].get("ta_sm90_kernel", 0),
                "idle_gaps": [{"dur_ms": x["dur_us"] / 1e3,
                               "start_ms": x["start_us"] / 1e3,
                               "host_op": x["host_op"]}
                              for x in a["idle_gaps"]],
                "gemm_flops": sum(v for k, v in a["flops_by_op"].items()
                                  if k in ("aten::mm", "aten::bmm",
                                           "aten::addmm"))}

    def trace_split(self) -> None:
        """hlo_analysis.analyze on a profiled yi-6b kernel forward (1, 4096)
        and on one engine decode step (batch 4 after a 512-token prefill):
        the device's busy share, time by category, launches per kernel name
        (32 ta_sm90_kernel in the forward) and the longest idle gaps with
        the host op running in each."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import greedy

        params = self._lm_model()
        cfg = get_config(LM_ARCH).replace(attn_impl="pallas_mapped")
        tokens = self._lm_tokens(cfg, (1, LM_SEQ), 1)
        fwd = self._traced(lambda: T.forward(params, cfg, tokens))
        check(fwd["ta_sm90_kernel"] == LM_LAUNCHES,
              f"{fwd['ta_sm90_kernel']} ta_sm90_kernel events in the "
              f"forward's trace, want {LM_LAUNCHES}")
        check(0 < fwd["busy_share"] <= 1, "forward: no device time traced")
        dcfg = get_config(LM_ARCH).replace(max_seq=GEN_PROMPT + GEN_NEW)
        prompts = self._lm_tokens(dcfg, (GEN_BATCH, GEN_PROMPT), 2)
        logits, cache = T.prefill(params, dcfg, prompts)
        tok = greedy(logits[:, -1:, :dcfg.vocab_size])
        state = {"tok": tok, "cache": cache}

        def step():
            lg, state["cache"] = T.decode_step(params, dcfg, state["tok"],
                                               state["cache"])
            state["tok"] = greedy(lg[:, :, :dcfg.vocab_size])

        dec = self._traced(step)
        check(0 < dec["busy_share"] <= 1, "decode: no device time traced")
        check(dec["ta_sm90_kernel"] == 0, "decode launched tri_attn")
        del state, cache, logits
        torch.cuda.empty_cache()
        emit({"phase": "trace_split", "card": self.card, "arch": LM_ARCH,
              "forward": {"tokens": [1, LM_SEQ], **fwd},
              "decode_step": {"batch": GEN_BATCH, "prompt": GEN_PROMPT,
                              **dec},
              "note": "device time from the profiler's CUDA events; HBM "
                      "bytes are not in a trace"})

    def start_dryruns(self) -> None:
        """dryrun_arch's commands (DRYRUN_COMMANDS) started side by side as
        subprocesses into build/dryrun: each is one single-threaded process
        on the host's cores and touches no card, so the full run starts
        them before the train phase and its card phases overlap them."""
        import os
        import shutil

        out = ROOT / "build" / "dryrun"
        shutil.rmtree(out, ignore_errors=True)
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        self.dry_t0, self.dry_procs = time.perf_counter(), []
        for arch, shape, mp in DRYRUN_COMMANDS:
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", arch, "--shape", shape, "--multi-pod", mp,
                    "--out", str(out)]
            self.dry_procs.append((argv, subprocess.Popen(
                argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))

    def dryrun_arch(self) -> None:
        """The --arch dry run as subprocesses into build/dryrun
        (start_dryruns, unless started before): DRYRUN_COMMANDS, yi-6b x
        train_4k on both meshes, the rest on 16x16 (exit 0; each record's
        analytic equal to cell_analytics, FLOPs per device > 0;
        roofline.load_rows and render_markdown accept them; yi-6b's,
        rwkv6-3b's and zamba2-1.2b's train_4k against their caps, the
        decode cells' peaks against DRYRUN_DECODE_PEAK_GB); then --all
        --multi-pod off if the cells measured say it would take under
        60 s."""
        import os

        from repro_torch.configs import SHAPES, get_config
        from repro_torch.launch import analytic, roofline
        from repro_torch.launch.dryrun import apply_profile

        out = ROOT / "build" / "dryrun"
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        if not getattr(self, "dry_procs", None):
            self.start_dryruns()
        t0, procs = self.dry_t0, self.dry_procs
        waited = time.perf_counter()
        runs = []
        try:
            for argv, proc in procs:
                stdout, stderr = proc.communicate(timeout=900)
                check(proc.returncode == 0,
                      f"{' '.join(argv[3:])} exited {proc.returncode}: "
                      f"{stderr[-2000:]}")
                runs.append({"command": "python -m repro_torch.launch.dryrun "
                             + " ".join(argv[3:-2]),
                             "stdout": [ln for ln in stdout.splitlines()
                                        if ln.startswith("[dryrun]")]})
        finally:
            for _, proc in procs:
                proc.kill()
                proc.wait()
            self.dry_procs = []
        waited = time.perf_counter() - waited
        wall = time.perf_counter() - t0
        cells = []
        for path in sorted(out.glob("*.json")):
            rec = json.loads(path.read_text())
            check(rec["status"] == "ok", f"{path.name}: {rec['status']}")
            shape = SHAPES[rec["shape"]]
            cfg = get_config(rec["arch"]).replace(max_seq=shape.seq_len,
                                                  attn_impl="xla")
            cfg, _, _ = apply_profile(cfg, shape, "baseline")
            check(rec["analytic"] == analytic.cell_analytics(cfg, shape),
                  f"{path.name}: analytic differs from cell_analytics")
            st = rec["step"]
            check(st["flops_per_device"] > 0, f"{path.name}: no FLOPs")
            share = rec["analytic"]["analytic_flops"] / math.prod(
                rec["mesh"].values())
            cells.append({
                "cell": path.stem, "lower_s": rec["lower_s"],
                "run_s": rec["run_s"],
                "flops_per_device": st["flops_per_device"],
                "analytic_flops_per_chip": share,
                "flops_over_share": st["flops_per_device"] / share,
                "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
                "collectives": {k: v for k, v in st["collectives"].items()
                                if isinstance(v, dict) and v["count"]},
                "comm_debug_counts": st["comm_debug_counts"],
                "memory_gb": {k: v / 1e9 for k, v in rec["memory"].items()},
                "peak_holders": st["peak_holders"]})
        check(len(cells) == len(DRYRUN_COMMANDS) + 1,
              f"{len(cells)} records, want {len(DRYRUN_COMMANDS) + 1}")
        by_cell = {c["cell"]: {"flops_over_share": c["flops_over_share"],
                               "peak_gb": c["peak_gb"]} for c in cells}
        yi_split = by_cell["yi-6b__train_4k__sp"]
        check(yi_split["flops_over_share"] <= DRYRUN_YI_FLOPS_RATIO_MAX
              and yi_split["peak_gb"] < DRYRUN_YI_PEAK_GB_MAX,
              f"yi-6b x train_4k on 16x16: {yi_split}")
        ssm = {}
        for arch, (ratio_max, peak_max) in DRYRUN_SSM_CELLS.items():
            ssm[arch] = by_cell[f"{arch}__train_4k__sp"]
            check(ssm[arch]["flops_over_share"] <= ratio_max
                  and ssm[arch]["peak_gb"] < peak_max,
                  f"{arch} x train_4k on 16x16: {ssm[arch]}, caps "
                  f"{ratio_max} and {peak_max} GB")
        decode = {}
        for cell, peak_max in DRYRUN_DECODE_PEAK_GB.items():
            decode[cell] = by_cell[cell]
            check(decode[cell]["peak_gb"] < peak_max,
                  f"{cell} on 16x16: {decode[cell]}, cap {peak_max} GB")
        md = roofline.render_markdown(roofline.load_rows(str(out)))
        mp_rows = roofline.load_rows(str(out), multi_pod=True)
        check(len(mp_rows) == 1
              and md.count("\n") == len(DRYRUN_COMMANDS) + 1,
              "roofline rows of the dry-run records")
        # --all: 32 cells one after another (8 of them skipped at once)
        estimate = sum(c["lower_s"] + c["run_s"] for c in cells) \
            / len(cells) * 24
        all_run = None
        if estimate < 60:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
                 "--multi-pod", "off", "--out", str(out / "all")],
                env=env, cwd=ROOT, capture_output=True, text=True,
                timeout=600)
            check(proc.returncode == 0, f"--all exited {proc.returncode}")
            all_run = time.perf_counter() - t0
        emit({"phase": "dryrun_arch", "card": self.card, "runs": runs,
              "wall_s": wall, "waited_s": waited,
              "yi_6b_train_4k_16x16": yi_split,
              "ssm_train_4k_16x16": ssm, "split_decode_16x16": decode,
              "cells": cells, "roofline_markdown": md,
              "all_estimate_s": estimate, "all_s": all_run,
              "note": "fake tensors on a fake 256/512-rank group: FLOPs, "
                      "collectives and bytes are counts, not device times"})

    # -- phase 8 -------------------------------------------------------------
    def lm_generate(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config

        params = self.lm_params
        cfg = get_config(LM_ARCH).replace(max_seq=GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int64)).cuda()
        got = self._generate_held(params, cfg, prompts, None, LM_ARCH)
        got.pop("cache")
        emit({"phase": "lm_generate", "card": self.card, "arch": LM_ARCH,
              **got,
              "note": "prefill and decode run the plain SDPA, as in the "
                      "reference: no tri_attn launch is expected"})
        del self.lm_params, params
        self._free()
        emit({"phase": "lm_demo", **self._demo(
            ["--arch", LM_ARCH, "--batch", "4", "--prompt-len", "32",
             "--max-new", "32"])})

    # -- phase 9 -------------------------------------------------------------
    def _wkv_inputs(self, bh, s, d, dtype, gen, dec=None):
        """tests/test_kernels_wkv.py's distributions, on the card: r, k, v ~
        N(0, 0.25), w = exp(-exp(N(0, 0.09) - 5)) or a uniform
        exp(-exp(dec)), u ~ N(0, 0.25), a zero state."""
        torch = self.torch

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        r, k, v = (randn(bh, s, d).mul_(0.5).to(dtype) for _ in range(3))
        if dec is None:
            w = torch.exp(-torch.exp(randn(bh, s, d) * 0.3 - 5.0))
        else:
            w = torch.full((bh, s, d), math.exp(-math.exp(dec)),
                           device="cuda")
        u = randn(bh, d) * 0.5
        s0 = torch.zeros((bh, d, d), device="cuda")
        return r, k, v, w, u, s0

    @staticmethod
    def _wkv_bound_ms(bh, s, d, chunk, in_itemsize,
                      out_itemsize) -> tuple[float, dict]:
        """The least time for the chunked WKV: r, k, v (``in_itemsize``) and
        w (fp32) read once, o (``out_itemsize``) written once, the states
        read and written once and u read once, at the memory rate; against
        the products the function needs per (bh, chunk) -- the
        strictly-lower pairs' scores and their P v, 2·D·C(C-1), the bonus
        diagonal, 5·C·D, r̃ S_in and the state update, 4·C·D² -- at the
        fp32 rate (the kernels' arithmetic is fp32)."""
        flop = bh * (s // chunk) * (2 * d * chunk * (chunk - 1)
                                    + 5 * chunk * d + 4 * chunk * d * d)
        nbytes = bh * s * d * (3 * in_itemsize + 4 + out_itemsize) \
            + 2 * bh * d * d * 4 + bh * d * 4
        t_ops = flop / FP32_FLOP_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return max(t_ops, t_bytes), {
            "flop": flop, "bytes": nbytes, "ops_ms": t_ops,
            "bytes_ms": t_bytes,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}

    def _wkv_case(self, x, chunk, what, worst, out_dtype=None) -> None:
        """The kernels against ``wkv_chunked_plain`` and ``wkv_ref``."""
        torch, WK = self.torch, self.WK
        from repro_torch.kernels.wkv.ops import wkv_chunked
        from repro_torch.kernels.wkv.ref import wkv_ref

        o, st = wkv_chunked(*x, chunk=chunk, out_dtype=out_dtype)
        self.sync()
        fp32 = o.dtype == torch.float32
        for (wo, ws), name, rtol in (
                (WK.wkv_chunked_plain(*x, chunk=chunk, out_dtype=out_dtype),
                 "wkv_chunked_plain", WKV_BF16_ROW_RTOL),
                (wkv_ref(*(t.float() for t in x)), "wkv_ref",
                 WKV_BF16_ROW_RTOL / 2)):
            check(bool(torch.isfinite(o).all() and torch.isfinite(st).all()),
                  f"{what}: non-finite output")
            s_err = float((st - ws).abs().max())
            diff = (o.float() - wo.float()).abs()
            if fp32:
                err = float(diff.max())
                if name == "wkv_chunked_plain":
                    worst["vs_plain"] = max(worst["vs_plain"], err, s_err)
                worst["o_fp32"] = max(worst["o_fp32"], err)
                check(err < WKV_TOL, f"{what}: o vs {name} max abs err {err}")
            else:
                excess = float((diff.amax(-1) - rtol * wo.float().abs()
                                .amax(-1)).max())
                worst["bf16_row_excess"] = max(worst["bf16_row_excess"],
                                               excess)
                check(excess < WKV_TOL, f"{what}: bf16 o vs {name} exceeds "
                      f"{rtol} of the row's max |o| by {excess}")
            worst["state"] = max(worst["state"], s_err)
            check(s_err < WKV_TOL, f"{what}: state vs {name} {s_err}")
            del wo, ws, diff

    def _wkv_phases(self, x, chunk) -> dict:
        """Each of the three kernels against its own plain phase, on the
        kernels' own inputs to it: the chunk states (ΔS, A), the scan (S_in
        of every chunk and the final state, from the kernel's ΔS and A; one
        rounding a step on both sides, so within two fp32 ulps of max |S|)
        and the chunk outputs (o, from the kernel's S_in)."""
        torch, WK = self.torch, self.WK
        r, k, v, w, u, s0 = x
        heads = [t.transpose(0, 1)[None] for t in (r, k, v, w)]
        out = torch.float32

        def run(phases):
            return WK._launch(*heads, u, s0[None], chunk, True, out, phases)

        _, _, ds, a_end = run(1)
        ds, a_end = ds.clone(), a_end.clone()
        _, s_fin, s_in, _ = run(2)
        s_in, s_fin = s_in.clone(), s_fin[0].clone()
        o, _, _, _ = run(3)
        self.sync()
        p_ds, p_a = WK.wkv_chunk_states_plain(k, v, w, chunk)
        p_in, p_fin = WK.wkv_state_scan_plain(ds, a_end, s0)
        p_o = WK.wkv_chunk_outputs_plain(r, k, v, w, u, s_in, chunk, out)
        errs = {"states_dS": float((ds - p_ds).abs().max()),
                "states_A": float((a_end - p_a).abs().max()),
                "scan_S_in": float((s_in - p_in).abs().max()),
                "scan_final": float((s_fin - p_fin).abs().max()),
                "outputs_o": float((o[0].transpose(0, 1) - p_o).abs().max())}
        scale = max(float(p_in.abs().max()), float(p_fin.abs().max()))
        errs["scan_rtol"] = 2.0 ** -22
        errs["scan_bitwise"] = bool(torch.equal(s_in, p_in)
                                    and torch.equal(s_fin, p_fin))
        for key in ("states_dS", "states_A", "outputs_o"):
            check(errs[key] < WKV_TOL, f"wkv kernel vs its plain phase: "
                  f"{key} {errs[key]}")
        check(max(errs["scan_S_in"], errs["scan_final"])
              <= errs["scan_rtol"] * scale,
              f"wkv scan vs its plain phase: {errs}")
        return errs

    def _wkv_ptxas(self) -> dict | None:
        """Registers and spill store bytes of the three wkv kernels, from
        nvcc's ``-Xptxas -v`` output: the main path's instantiation (bf16
        in, fp32 out, chunk 64, D 64) and the worst over all of each
        kernel's (None where this process did not build)."""
        log = self.build_mod.BUILD_LOG.get("wkv")
        if not log:
            return None
        main = {"wkv_states_kernel": "I13__nv_bfloat16Li64ELi64E",
                "wkv_scan_kernel": "ILi64E",
                "wkv_outputs_kernel": "I13__nv_bfloat16fLi64ELi64E"}
        out = {k: {"instances": 0, "max_registers": 0,
                   "max_spill_store_bytes": 0} for k in main}
        for part in log.split("Compiling entry function")[1:]:
            name = part.split("'")[1] if "'" in part else part.split()[0]
            regs = re.search(r"Used (\d+) registers", part)
            spill = re.search(r"(\d+) bytes spill stores", part)
            regs = int(regs.group(1)) if regs else 0
            spill = int(spill.group(1)) if spill else 0
            for kname, tag in main.items():
                if kname in name:
                    row = out[kname]
                    row["instances"] += 1
                    row["max_registers"] = max(row["max_registers"], regs)
                    row["max_spill_store_bytes"] = max(
                        row["max_spill_store_bytes"], spill)
                    if f"{kname}{tag}" in name:
                        row["main"] = {"registers": regs,
                                       "spill_store_bytes": spill}
        return out

    def wkv(self) -> None:
        torch, WK = self.torch, self.WK
        from repro_torch.kernels.wkv.ops import wkv_chunked
        from repro_torch.kernels.wkv.ref import wkv_ref

        self._free()
        gen = torch.Generator(device="cuda").manual_seed(3)
        worst = {"vs_plain": 0.0, "o_fp32": 0.0, "state": 0.0,
                 "bf16_row_excess": -1.0}
        f32, bf16 = torch.float32, torch.bfloat16
        cases = [(c, dt, out) for c in WKV_CASES
                 for dt, out in ((f32, None), (bf16, None), (bf16, f32))]
        cases += [(WKV_MAIN, f32, None), (WKV_GEN, f32, None),
                  (WKV_MAIN, bf16, f32), (WKV_GEN, bf16, f32)]
        for (bh, s, d, chunk), dtype, out in cases:
            x = self._wkv_inputs(bh, s, d, dtype, gen)
            self._wkv_case(x, chunk, f"{(bh, s, d, chunk)} {dtype} -> "
                           f"{out or dtype}", worst, out)
        # each kernel against its own plain phase, at the main path's shape
        bh, s, d, chunk = WKV_MAIN
        phases = self._wkv_phases(self._wkv_inputs(bh, s, d, bf16, gen),
                                  chunk)
        # strong decays: the reference's chunked form overflows there
        strong = {}
        for dec in WKV_STRONG:
            for bh, s, d in ((2, 128, 16), (40, 512, 64)):
                x = self._wkv_inputs(bh, s, d, torch.float32, gen, dec)
                o, st = wkv_chunked(*x, chunk=64)
                o_r, s_r = wkv_ref(*x)
                err = max(float((o - o_r).abs().max()),
                          float((st - s_r).abs().max()))
                strong[f"dec={dec} {(bh, s, d)}"] = err
                check(bool(torch.isfinite(o).all()) and err < WKV_TOL,
                      f"strong decay {dec} {(bh, s, d)}: {err}")
        # two calls chained through the state = one call, bit for bit
        r, k, v, w, u, s0 = self._wkv_inputs(40, 1024, 64, torch.float32, gen)
        o_full, s_full = wkv_chunked(r, k, v, w, u, s0)
        oa, sa = wkv_chunked(r[:, :512], k[:, :512], v[:, :512], w[:, :512],
                             u, s0)
        ob, sb = wkv_chunked(r[:, 512:], k[:, 512:], v[:, 512:], w[:, 512:],
                             u, sa)
        check(torch.equal(torch.cat([oa, ob], 1), o_full)
              and torch.equal(sb, s_full),
              "two calls chained through the state differ from one call")
        # the model's (B, S, H, D) layout read through its strides
        # bit-identical to the contiguous (BH, S, D) call, and o written in
        # either layout bit-identical (the launch's one free choice)
        b, h, s, d = GEN_BATCH, 40, GEN_PROMPT, 64

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")

        r4, k4, v4 = (randn(b, s, h * d).view(b, s, h, d) * 0.5
                      for _ in range(3))
        w4 = torch.exp(-torch.exp(randn(b, s, h * d) * 0.3 - 5.0)) \
            .view(b, s, h, d)
        u4, st4 = randn(h, d) * 0.5, randn(b, h, d, d) * 0.1
        o4, s4 = wkv_chunked(r4, k4, v4, w4, u4, st4)
        rows = [t.contiguous() for t in
                WK.heads_to_rows(r4, k4, v4, w4, u4, st4)]
        o3, s3 = WK.rows_to_heads(*wkv_chunked(*rows), b, h)
        check(torch.equal(o4, o3) and torch.equal(s4, s3),
              "the strided (B, S, H, D) path differs from the contiguous one")
        o_hm, s_hm = WK.launch_wkv(r4, k4, v4, w4, u4, st4, 64,
                                   heads_major=True)
        check(o_hm.stride() != o4.stride() and torch.equal(o_hm, o4)
              and torch.equal(s_hm, s4),
              "o written heads-major differs from o written (B, S, H, D)")
        del r4, k4, v4, w4, o4, o3, rows, o_hm
        # gradients through the autograd.Function (backward: the plain form)
        x = self._wkv_inputs(4, 256, 32, torch.float32, gen)
        g_o = torch.randn((4, 256, 32), generator=gen, device="cuda")
        grads = []
        for fn in (lambda *a: wkv_chunked(*a, chunk=32),
                   lambda *a: WK.wkv_chunked_plain(*a, chunk=32)):
            xs = [t.clone().requires_grad_() for t in x]
            o, st = fn(*xs)
            ((o * g_o).sum() + st.sum()).backward()
            grads.append([t.grad for t in xs])
        grad_err = max(float((a - c).abs().max()) / float(c.abs().max())
                       for a, c in zip(*grads))
        check(grad_err < 1e-5, f"wkv gradients differ by {grad_err}")

        # the LM path's shape: times beside the bound, fp32 in / out (the
        # parent kernel's yardstick) and bf16 in / fp32 out (the main path)
        bh, s, d, chunk = WKV_MAIN
        timed = {}
        for name, dtype in (("float32", f32), ("bfloat16->float32", bf16)):
            x = self._wkv_inputs(bh, s, d, dtype, gen)
            ms = self.time_ms(lambda: wkv_chunked(*x, chunk=chunk,
                                                  out_dtype=f32))
            plain_ms = self.time_ms(lambda: WK.wkv_chunked_plain(
                *x, chunk=chunk, out_dtype=f32), reps=3)
            bound_ms, bound = self._wkv_bound_ms(
                bh, s, d, chunk, x[0].element_size(), 4)
            timed[name] = {"ms": ms, "bound_ms": bound_ms, **bound,
                           "x_bound": ms / bound_ms, "plain_ms": plain_ms}
            del x
        main = timed["bfloat16->float32"]
        # the main path's call split by kernel: device time with the first
        # 1, 2, 3 kernels issued, back to back; and the host's share
        x = self._wkv_inputs(bh, s, d, bf16, gen)
        heads = [t.transpose(0, 1)[None] for t in x[:4]]
        upto = [self.device_ms(lambda p=p: WK._launch(
            *heads, x[4], x[5][None], chunk, True, f32, p))
            for p in (1, 2, 3)]
        breakdown = {"states_ms": upto[0], "scan_ms": upto[1] - upto[0],
                     "outputs_ms": upto[2] - upto[1],
                     "call_device_ms": upto[2],
                     "call_host_us": self.host_us(lambda: wkv_chunked(
                         *x, chunk=chunk, out_dtype=f32))}
        del x, heads
        self.wkv_row = {"max_abs_err": worst["vs_plain"], "ms": main["ms"],
                        "plain_ms": main["plain_ms"],
                        "bound_ms": main["bound_ms"],
                        "bound_by": main["bound_by"], "library_ms": None,
                        "dtype": "bfloat16 in, float32 out"}
        emit({"phase": "wkv", "card": self.card,
              "shape": {"BH": bh, "S": s, "D": d, "chunk": chunk},
              "timed": timed,
              "main_breakdown": breakdown, "library_ms": None,
              "cases": len(cases), "max_err": worst, "tol": WKV_TOL,
              "bf16_row_rtol": WKV_BF16_ROW_RTOL, "phases_vs_plain": phases,
              "strong_decay_err": strong, "chained_equals_one_call": True,
              "strided_equals_contiguous": True,
              "heads_major_equals_rows": True, "grad_rel_err": grad_err,
              "ptxas": self._wkv_ptxas()})

    # -- phase 10 ------------------------------------------------------------
    def _rwkv_forward_with(self, params, cfg, tokens, kind: str,
                           layer_errs: list | None = None,
                           dtypes: set | None = None):
        """Logits of ``forward`` with ``wkv_chunked`` replaced: by its plain
        version on the card (``"plain"``); by the kernel held against the
        plain version on each call's inputs, the kernel's result going on
        (``"compare"``, each call's relative errors appended to
        ``layer_errs``, its (r, kernel o, plain o) dtypes added to
        ``dtypes``); by the kernel with o scaled by 1 + 1e-6·N(0, 1)
        (``"noise"``); or by the kernel with the state lost at S/2
        (``"faulty"``: the second half starts from zero, a fault of the kind
        a chunk loop that restarts could make)."""
        torch, WK = self.torch, self.WK
        from repro_torch.kernels.wkv import ops
        from repro_torch.models import transformer as T

        real = ops.wkv_chunked
        gen = torch.Generator(device="cuda").manual_seed(4)

        def plain(r, k, v, w, u, state, chunk=64, interpret=False,
                  out_dtype=None):
            b, _, h, _ = r.shape
            o, st = WK.wkv_chunked_plain(
                *WK.heads_to_rows(r, k, v, w, u, state), chunk, out_dtype)
            return WK.rows_to_heads(o, st, b, h)

        def compare(r, k, v, w, u, state, chunk=64, interpret=False,
                    out_dtype=None):
            o, st = real(r, k, v, w, u, state, chunk, interpret, out_dtype)
            po, pst = plain(r, k, v, w, u, state, chunk, out_dtype=out_dtype)
            dtypes.add((r.dtype, o.dtype, po.dtype))
            layer_errs.append(
                (float((o - po).abs().max()) / float(po.abs().max()),
                 float((st - pst).abs().max()) / float(pst.abs().max())))
            return o, st

        def noise(r, k, v, w, u, state, chunk=64, interpret=False,
                  out_dtype=None):
            o, st = real(r, k, v, w, u, state, chunk, interpret, out_dtype)
            eps = torch.randn(o.shape, generator=gen, device=o.device)
            return o * (1 + 1e-6 * eps), st

        def faulty(r, k, v, w, u, state, chunk=64, interpret=False,
                   out_dtype=None):
            half = r.shape[1] // 2
            o1, _ = real(r[:, :half], k[:, :half], v[:, :half], w[:, :half],
                         u, state, chunk, interpret, out_dtype)
            o2, s2 = real(r[:, half:], k[:, half:], v[:, half:], w[:, half:],
                          u, torch.zeros_like(state), chunk, interpret,
                          out_dtype)
            return torch.cat([o1, o2], dim=1), s2

        ops.wkv_chunked = {"plain": plain, "compare": compare,
                           "noise": noise, "faulty": faulty}[kind]
        try:
            return T.forward(params, cfg, tokens)
        finally:
            ops.wkv_chunked = real

    def _profile(self, got, want) -> dict:
        """Per position (and batch row): max |Δ logit| over the run's max
        |logit| of ``want``; its max and quantiles over the positions."""
        torch = self.torch
        d = (got - want).abs().amax(-1).flatten() / float(want.abs().max())
        q = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99],
                                           device=d.device))
        return {"max": float(d.max()), "p50": float(q[0]),
                "p90": float(q[1]), "p99": float(q[2])}

    def rwkv_forward(self) -> None:
        import numpy as np

        torch, WK = self.torch, self.WK
        F = torch.nn.functional
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params
        from repro_torch.train.train_step import lm_loss

        self._free()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(RWKV_ARCH)
        t0 = time.perf_counter()
        self.rwkv_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        self.sync()
        init_s = time.perf_counter() - t0
        params = self.rwkv_params
        n_params = count_params(params)
        check(n_params == RWKV_PARAMS, f"{n_params} parameters, want "
              f"{RWKV_PARAMS}")
        tokens = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (1, RWKV_SEQ), dtype=np.int64)).cuda()
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        T.forward(params, cfg, tokens[:, :256])      # warm-up (cuBLAS etc.)
        self.sync()

        self.reset_counts()
        t0 = time.perf_counter()
        logits = T.forward(params, cfg, tokens)
        self.sync()
        fwd_s = time.perf_counter() - t0
        n1 = WK.WKV_LAUNCHES
        t0 = time.perf_counter()
        loss, metrics = lm_loss(params, cfg, batch)
        ce = float(metrics["ce"])
        loss_s = time.perf_counter() - t0
        counts = self.counts()
        self.launches["wkv"] = counts["wkv"]
        self.wkv_paths["rwkv_forward"] = counts["wkv"]
        self.wkv_row["kernels_issued"] = WK.WKV_KERNELS
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(n1 == RWKV_LAUNCHES and counts["wkv"] - n1 == RWKV_LAUNCHES,
              f"{n1} and {counts['wkv'] - n1} wkv launches per forward, want "
              f"{RWKV_LAUNCHES}")
        check(WK.WKV_KERNELS == 3 * counts["wkv"],
              f"{WK.WKV_KERNELS} wkv kernels issued by {counts['wkv']} "
              f"calls, want three a call")
        check(all(n == 0 for k, n in counts.items() if k != "wkv"),
              f"other kernels launched in the rwkv forward: {counts}")
        check(logits.shape == (1, RWKV_SEQ, cfg.padded_vocab)
              and logits.dtype == torch.float32, "logits shape")
        check(bool(torch.isfinite(logits).all()) and math.isfinite(ce),
              "logits or loss not finite")

        layer_errs, dtypes = [], set()
        again = self._rwkv_forward_with(params, cfg, tokens, "compare",
                                        layer_errs, dtypes)
        deterministic = torch.equal(again, logits)
        del again
        plain = self._rwkv_forward_with(params, cfg, tokens, "plain")
        scale = float(plain.abs().max())
        max_diff = float((logits - plain).abs().max())
        rel = max_diff / scale
        top1 = float((logits.argmax(-1) == plain.argmax(-1)).float().mean())
        labels = tokens[0, 1:]
        ces = {}
        for name, x in (("kernel", logits), ("plain", plain)):
            ces[name] = float(F.cross_entropy(x[0, :-1, :cfg.vocab_size],
                                              labels))
        profiles = {"kernel_vs_plain": self._profile(logits, plain)}
        noisy = self._rwkv_forward_with(params, cfg, tokens, "noise")
        profiles["noise_1e-6_vs_kernel"] = self._profile(noisy, logits)
        noise_rel = profiles["noise_1e-6_vs_kernel"]["max"]
        del logits, noisy
        faulty = self._rwkv_forward_with(params, cfg, tokens, "faulty")
        profiles["control_vs_plain"] = self._profile(faulty, plain)
        control_rel = float((faulty - plain).abs().max()) / scale
        ces["control"] = float(F.cross_entropy(
            faulty[0, :-1, :cfg.vocab_size], labels))
        del faulty, plain
        layer_o = max(e[0] for e in layer_errs)
        layer_state = max(e[1] for e in layer_errs)
        emit({"phase": "rwkv_forward", "card": self.card, "arch": RWKV_ARCH,
              "params": n_params, "dtype": cfg.dtype, "tokens": [1, RWKV_SEQ],
              "init_s": init_s, "forward_s": fwd_s, "lm_loss_s": loss_s,
              "loss": float(loss), "ce": ce, "ce_next_token": ces,
              "layer_calls": len(layer_errs), "layer_o_rel_vs_plain": layer_o,
              "layer_state_rel_vs_plain": layer_state,
              "layer_rtol": RWKV_LAYER_RTOL,
              "wkv_dtypes_r_o_plain": sorted(str(d) for d in dtypes),
              "second_forward_equal": deterministic,
              "max_abs_logit_diff_vs_plain": max_diff,
              "max_abs_logit_plain": scale, "logit_rel_vs_plain": rel,
              "logit_rtol": RWKV_LOGIT_RTOL, "top1_vs_plain": top1,
              "noise_1e-6_logit_rel": noise_rel, "profiles": profiles,
              "control_fault_logit_rel_vs_plain": control_rel,
              "main_path_launches": counts,
              "wkv_kernels_issued": self.wkv_row["kernels_issued"],
              "peak_gb": peak_gb})
        check(deterministic, "a second kernel forward differs")
        check(len(layer_errs) == RWKV_LAUNCHES,
              f"{len(layer_errs)} wkv calls in a forward")
        check(dtypes == {(torch.bfloat16, torch.float32, torch.float32)},
              f"the forward's wkv calls took (r, o, plain o) dtypes {dtypes}:"
              f" want bf16 r, k, v in place and fp32 o")
        check(layer_o <= RWKV_LAYER_RTOL and layer_state <= RWKV_LAYER_RTOL,
              f"a layer's wkv differs from the plain version on its inputs: "
              f"o {layer_o}, state {layer_state}")
        check(rel <= RWKV_LOGIT_RTOL,
              f"logits kernel vs plain wkv: {rel} of max |logit|")
        check(control_rel > RWKV_LOGIT_RTOL,
              f"the control fault moved the logits by only {control_rel}: "
              f"the {RWKV_LOGIT_RTOL} gate cannot see it")

    # -- phase 11 ------------------------------------------------------------
    def rwkv_generate(self) -> None:
        import numpy as np

        torch, WK = self.torch, self.WK
        from repro_torch.configs import get_config
        from repro_torch.models import rwkv6
        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import generate

        params = self.rwkv_params
        cfg = get_config(RWKV_ARCH).replace(max_seq=GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(2).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int64)).cuda()
        torch.cuda.reset_peak_memory_stats()
        self.reset_counts()
        t0 = time.perf_counter()
        res = generate(params, cfg, prompts, GEN_NEW)
        self.sync()
        gen_s = time.perf_counter() - t0
        gen_counts = self.counts()
        check(res.steps == GEN_NEW and res.tokens.shape
              == (GEN_BATCH, GEN_PROMPT + GEN_NEW), "generate's shape")
        check(bool((res.tokens[:, :GEN_PROMPT] == prompts).all()),
              "generate changed the prompt")
        check(gen_counts["wkv"] == RWKV_LAUNCHES,
              f"{gen_counts['wkv']} wkv launches in generate, want "
              f"{RWKV_LAUNCHES} (prefill) + 0 (decode)")
        n0 = WK.WKV_LAUNCHES
        t0 = time.perf_counter()
        pre, cache = T.prefill(params, cfg, prompts)
        self.sync()
        prefill_s = time.perf_counter() - t0
        prefill_launches = WK.WKV_LAUNCHES - n0
        nt = pre[:, -1:, :cfg.vocab_size].argmax(-1)
        check(torch.equal(nt, res.tokens[:, GEN_PROMPT:GEN_PROMPT + 1]),
              "a second prefill's first token is not generate's")
        n0 = WK.WKV_LAUNCHES
        dec, _ = T.decode_step(params, cfg, nt, cache)
        self.sync()
        decode_launches = WK.WKV_LAUNCHES - n0
        check(prefill_launches == RWKV_LAUNCHES and decode_launches == 0,
              f"{prefill_launches} wkv launches in prefill, "
              f"{decode_launches} in a decode step")
        decode_ms = (gen_s - prefill_s) / GEN_NEW * 1e3
        # prefill against forward: the same chunked path from the zero state
        fwd = T.forward(params, cfg, prompts)
        prefill_equal = torch.equal(pre, fwd)
        check(prefill_equal, "prefill logits differ from forward's")
        del fwd
        # the first decode step against forward over prompt + token (513
        # tokens: the scan path all the way)
        full = T.forward(params, cfg, torch.cat([prompts, nt], dim=1))[:, -1]
        dec_rel = float((dec[:, 0] - full).abs().max()) \
            / float(full.abs().max())
        profiles = {"decode_vs_forward": self._profile(dec[:, 0], full)}
        del full, dec
        # every layer's prefill time mix (the kernel) against the scan oracle
        # on the same inputs; the kernel's result goes on
        real = rwkv6.rwkv_mix_chunked
        layers = []

        def rel(a, b):
            return float((a.float() - b.float()).abs().max()) \
                / float(b.float().abs().max())

        def against_scan(p, c, x, xp, st, chunk=64):
            out, last, s_new = real(p, c, x, xp, st, chunk)
            s_out, s_last, s_st = rwkv6.rwkv_mix_scan(p, c, x, xp, st)
            layers.append((rel(out, s_out), rel(s_new, s_st),
                           torch.equal(last, s_last)))
            return out, last, s_new

        rwkv6.rwkv_mix_chunked = against_scan
        n0 = WK.WKV_LAUNCHES
        try:
            again, _ = T.prefill(params, cfg, prompts)
        finally:
            rwkv6.rwkv_mix_chunked = real
        check(WK.WKV_LAUNCHES - n0 == RWKV_LAUNCHES and torch.equal(again,
                                                                    pre),
              "a second prefill differs")
        del again
        mix_rel = max(x[0] for x in layers)
        state_rel = max(x[1] for x in layers)
        emit({"phase": "rwkv_generate", "card": self.card, "arch": RWKV_ARCH,
              "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new": GEN_NEW,
              "generate_s": gen_s, "prefill_s": prefill_s,
              "decode_ms_per_step": decode_ms,
              "tokens_per_s": GEN_BATCH * GEN_NEW / gen_s,
              "wkv_launches": {"generate": gen_counts["wkv"],
                               "prefill": prefill_launches,
                               "decode_step": decode_launches},
              "main_path_launches": gen_counts,
              "prefill_equals_forward": prefill_equal,
              "decode_vs_forward_rel": dec_rel,
              "layers_vs_scan": {"calls": len(layers), "out_rel": mix_rel,
                                 "wkv_state_rel": state_rel,
                                 "last_x_equal": all(x[2] for x in layers),
                                 "out_rtol": RWKV_MIX_RTOL,
                                 "state_rtol": RWKV_LAYER_RTOL},
              "decode_rtol": RWKV_DECODE_RTOL, "profiles": profiles,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "sample": res.tokens[0, GEN_PROMPT:GEN_PROMPT + 8].tolist()})
        check(dec_rel <= RWKV_DECODE_RTOL,
              f"decode_step vs forward: {dec_rel}")
        check(len(layers) == cfg.n_layers and all(x[2] for x in layers),
              "the scan oracle saw other layers or another last x")
        check(state_rel <= RWKV_LAYER_RTOL and mix_rel <= RWKV_MIX_RTOL,
              f"prefill vs the scan oracle per layer: state {state_rel}, "
              f"out {mix_rel}")
        del self.rwkv_params, params, cache, pre, res
        self._free()

        # the LM demo (a 64-aligned prompt, so its prefill runs the kernel)
        n0 = WK.WKV_LAUNCHES
        demo = self._demo(["--arch", RWKV_ARCH, "--batch", "4",
                           "--prompt-len", "64", "--max-new", "32"])
        check(WK.WKV_LAUNCHES - n0 == RWKV_LAUNCHES,
              f"{WK.WKV_LAUNCHES - n0} wkv launches in the LM demo")
        emit({"phase": "rwkv_demo", **demo,
              "wkv_launches": WK.WKV_LAUNCHES - n0})

    # -- the cross-attention LMs (vlm, audio) --------------------------------
    def _scoring(self, params, cfg, tokens, extra, want_launches: int,
                 what: str, routed: bool = False,
                 gate_top1: bool = True) -> dict:
        """forward and lm_loss with ``extra`` under pallas_mapped, pallas_bb
        and xla: ``want_launches`` sm90 tri_attn launches per kernel forward
        (none under xla), finite logits, kernel logits within FWD_LOGIT_RTOL
        of xla's max |logit| and mapped within it of BB, top-1 and CE against
        xla (TOP1_MIN, CE_RTOL).  Returns the phase's fields.

        ``routed`` (a MoE model): a rounding difference that moves a token's
        router logits past a tie sends it to other experts, and 48 layers
        carry such flips into most tokens, so the logits and top-1 say
        nothing about the kernel there: they are printed beside the count of
        (layer, token) routing decisions that differ from xla's and each
        forward's capacity drops, and not gated; CE stays a gate (its mean
        over 4096 positions stays within CE_RTOL at random weights).  The
        kernel is held layer by layer on each layer's own input instead
        (``_moe_layer_gates``).  ``gate_top1=False`` prints top-1 beside
        xla's top-2 margins instead of gating it (see ``hybrid_forward``)."""
        torch, AK = self.torch, self.AK
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        from repro_torch.train.train_step import lm_loss

        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1),
                 "extra": extra}
        rows, logits, routing = {}, {}, {}
        for impl in ("pallas_mapped", "pallas_bb", "xla"):
            c = cfg.replace(attn_impl=impl)
            n0 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
            t0 = time.perf_counter()
            with moe.record_routing() as routing[impl]:
                out = T.forward(params, c, tokens, extra)
                self.sync()
            fwd_s = time.perf_counter() - t0
            n1 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
            t0 = time.perf_counter()
            loss, metrics = lm_loss(params, c, batch)
            ce = float(metrics["ce"])
            loss_s = time.perf_counter() - t0
            n2 = AK.ATTN_LAUNCHES, AK.ATTN_SM90_LAUNCHES
            want = 0 if impl == "xla" else want_launches
            for kind, x in (("tri_attn", 0), ("sm90", 1)):
                check(n1[x] - n0[x] == want and n2[x] - n1[x] == want,
                      f"{what} {impl}: {n1[x] - n0[x]} and {n2[x] - n1[x]} "
                      f"{kind} launches per forward, want {want}")
            check(out.shape == (*tokens.shape, cfg.padded_vocab)
                  and out.dtype == torch.float32, f"{what} {impl}: shape")
            check(bool(torch.isfinite(out).all()) and math.isfinite(ce),
                  f"{what} {impl}: logits or loss not finite")
            logits[impl] = out
            rows[impl] = {"forward_s": fwd_s, "lm_loss_s": loss_s,
                          "loss": float(loss), "ce": ce,
                          "sm90_launches_forward": n1[1] - n0[1],
                          "launches_lm_loss": n2[0] - n1[0]}
        x = logits["xla"]
        scale = float(x.abs().max())
        rel = {name: float((logits[name] - x).abs().max()) / scale
               for name in ("pallas_mapped", "pallas_bb")}
        mapped_vs_bb = float((logits["pallas_mapped"] - logits["pallas_bb"])
                             .abs().max()) / scale
        top1 = float((logits["pallas_mapped"].argmax(-1) == x.argmax(-1))
                     .float().mean())
        # xla's margin between its two best logits, over max |logit|, and
        # the positions where the kernel's change there can reorder them
        top2 = x[..., :cfg.vocab_size].topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]) / scale
        moved = (logits["pallas_mapped"] - x).abs().amax(-1) / scale
        margins = {"p50": float(margin.median()),
                   "share_within_2x_change": float(
                       (margin <= 2 * moved).float().mean())}
        del top2, margin, moved
        ce_rel = abs(rows["pallas_mapped"]["ce"] - rows["xla"]["ce"]) \
            / abs(rows["xla"]["ce"])
        del logits, x
        if not routed:
            for name, r in rel.items():
                check(r <= FWD_LOGIT_RTOL,
                      f"{what}: logits {name} vs xla {r} of max |logit|")
            check(mapped_vs_bb <= FWD_LOGIT_RTOL,
                  f"{what}: logits mapped vs BB {mapped_vs_bb} of max "
                  f"|logit|")
            if gate_top1:
                check(top1 >= TOP1_MIN, f"{what}: top-1 kernel vs xla {top1}")
        check(ce_rel <= CE_RTOL, f"{what}: CE kernel vs xla relative "
              f"{ce_rel}")
        got = {"impls": rows, "logit_rel_vs_xla_by_impl": rel,
               "logit_rel_mapped_vs_bb": mapped_vs_bb,
               "logit_rtol": FWD_LOGIT_RTOL, "top1_vs_xla": top1,
               "top1_min": TOP1_MIN, "top1_gated": gate_top1 and not routed,
               "xla_top2_margin_rel": margins, "ce_rel_vs_xla": ce_rel,
               "ce_rtol": CE_RTOL, "max_abs_logit_xla": scale}
        if routed:
            n_dec = len(routing["xla"]) * tokens.numel()
            got["logits_and_top1_gated"] = False
            got["routing"] = {
                "decisions_per_forward": n_dec,
                "flips_vs_xla": {i: _flips(routing[i], routing["xla"])
                                 for i in ("pallas_mapped", "pallas_bb")},
                "flips_mapped_vs_bb": _flips(routing["pallas_mapped"],
                                             routing["pallas_bb"]),
                "drops_by_impl": {i: _drops(r) for i, r in routing.items()},
                "drops_by_layer_xla": [_drops([r]) for r in routing["xla"]],
                "assignments_per_forward": n_dec * cfg.moe_top_k}
        return got

    def _generate_held(self, params, cfg, prompts, extra, what: str) -> dict:
        """engine.generate with ``extra``, then a second prefill against a
        cache-less forward (xla) at the prompt positions, and the first
        decode step against a forward over prompt + token: LOGIT_RTOL,
        TOP1_MIN; no tri_attn launch (prefill and decode take the SDPA)."""
        torch, AK = self.torch, self.AK
        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import generate

        b, s = prompts.shape
        self.reset_counts()
        t0 = time.perf_counter()
        res = generate(params, cfg, prompts, GEN_NEW, extra=extra)
        self.sync()
        gen_s = time.perf_counter() - t0
        check(res.steps == GEN_NEW and res.tokens.shape == (b, s + GEN_NEW),
              f"{what}: generate's shape")
        check(bool((res.tokens[:, :s] == prompts).all()),
              f"{what}: generate changed the prompt")
        t0 = time.perf_counter()
        pre, cache = T.prefill(params, cfg, prompts, extra)
        self.sync()
        prefill_s = time.perf_counter() - t0
        fwd = T.forward(params, cfg, prompts, extra)
        pre_rel = float((pre - fwd).abs().max()) / float(fwd.abs().max())
        pre_top1 = float((pre.argmax(-1) == fwd.argmax(-1)).float().mean())
        check(pre_rel <= LOGIT_RTOL, f"{what}: prefill vs forward {pre_rel}")
        check(pre_top1 >= TOP1_MIN,
              f"{what}: prefill vs forward top-1 {pre_top1}")
        nt = pre[:, -1:, :cfg.vocab_size].argmax(-1)
        check(torch.equal(nt, res.tokens[:, s:s + 1]),
              f"{what}: a second prefill's first token is not generate's")
        del fwd, pre
        dec, _ = T.decode_step(params, cfg, nt, cache, extra)
        full = T.forward(params, cfg, torch.cat([prompts, nt], dim=1),
                         extra)[:, -1]
        dec_rel = float((dec[:, 0] - full).abs().max()) \
            / float(full.abs().max())
        check(dec_rel <= LOGIT_RTOL, f"{what}: decode_step vs forward "
              f"{dec_rel}")
        launches = AK.ATTN_LAUNCHES
        check(launches == 0, f"{what}: {launches} tri_attn launches in "
              f"generate")
        return {"batch": b, "prompt": s, "new": GEN_NEW,
                "max_seq": cfg.max_seq, "generate_s": gen_s,
                "prefill_s": prefill_s,
                "decode_ms_per_step": (gen_s - prefill_s) / GEN_NEW * 1e3,
                "tokens_per_s": b * GEN_NEW / gen_s,
                "prefill_vs_forward_rel": pre_rel,
                "prefill_vs_forward_top1": pre_top1,
                "decode_vs_forward_rel": dec_rel, "logit_rtol": LOGIT_RTOL,
                "decode_vs_forward": self._profile(dec[:, 0], full),
                "tri_attn_launches": launches, "cache": cache,
                "sample": res.tokens[0, s:s + 8].tolist()}

    def _demo(self, argv: list) -> dict:
        """The LM demo entry point, as a user runs it: its command, wall
        seconds and printed lines, held to have generated every step."""
        from repro_torch.launch import serve

        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            serve.main(argv)
        demo_s = time.perf_counter() - t0
        lines = out.getvalue().splitlines()
        batch, new = argv[argv.index("--batch") + 1], \
            argv[argv.index("--max-new") + 1]
        check(any(f"generated {new} steps x {batch} seqs" in ln
                  for ln in lines), f"the LM demo printed {lines}")
        return {"card": self.card,
                "command": "python -m repro_torch.launch.serve "
                + " ".join(argv), "seconds": demo_s, "stdout": lines}

    def _free(self) -> None:
        import gc

        gc.collect()
        self.torch.cuda.empty_cache()

    def _stub_states(self, b, t, d, seed):
        """Stub patch or frame embeddings (B, T, d) × 0.1, bf16."""
        torch = self.torch
        return (torch.randn((b, t, d), device="cuda",
                            generator=torch.Generator(device="cuda")
                            .manual_seed(seed)) * 0.1).to(torch.bfloat16)

    def _cross_layer_fp32(self, layer, cfg, x, states):
        """One vlm cross layer in fp32 on the same inputs: (tanh(gate) ·
        attention over ``states``, the layer's output)."""
        torch = self.torch
        F = torch.nn.functional
        from repro_torch.models.common import rms_norm, swiglu

        p = layer.attn
        b, s, d = x.shape
        t = states.shape[1]
        h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        xf, sf = x.float(), states.float()
        n1 = rms_norm(xf, layer.ln1.float())
        q = (n1 @ p.wq.float().reshape(d, h * hd)).view(b, s, h, hd)
        k = (sf @ p.wk.float().reshape(d, hk * hd)).view(b, t, hk, hd)
        v = (sf @ p.wv.float().reshape(d, hk * hd)).view(b, t, hk, hd)
        o = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            enable_gqa=True).transpose(1, 2).reshape(b, s, h * hd)
        branch = (o @ p.wo.float()) * torch.tanh(layer.xattn_gate.float())
        x1 = xf + branch
        m = layer.mlp
        out = x1 + swiglu(rms_norm(x1, layer.ln2.float()), m.gate.float(),
                          m.up.float(), m.down.float())
        return branch, out

    def _cross_layer_held(self, params, cfg, tokens, extra) -> dict:
        """Group 0's cross layer on its own inputs (the hidden state after
        the group's self layers in an xla forward, the vision states) in
        bf16 against ``_cross_layer_fp32``: the attention branch and the
        layer's output to CROSS_RTOL of their max; the fp32 layer over half
        the states (a control) must miss the branch's gate."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.models.attention import gqa_apply
        from repro_torch.models.common import rms_norm

        g0 = params.groups[0]
        with torch.inference_mode():
            x = T._embed(params, cfg, tokens)
            for lp in g0.self_layers:
                x, _ = T._layer_apply(lp, cfg, x)
            cross = g0.cross
            branch, _ = gqa_apply(cross.attn, cfg, rms_norm(x, cross.ln1),
                                  cross_kv=extra)
            branch = branch * torch.tanh(cross.xattn_gate).to(branch.dtype)
            out, _ = T._layer_apply(cross, cfg, x, cross_kv=extra)
            want_branch, want_out = self._cross_layer_fp32(cross, cfg, x,
                                                           extra)
            half, _ = self._cross_layer_fp32(cross, cfg, x,
                                             extra[:, :extra.shape[1] // 2])

        def rel(a, w):
            return float((a.float() - w).abs().max()) / float(w.abs().max())

        got = {"branch_rel": rel(branch, want_branch),
               "out_rel": rel(out, want_out),
               "control_half_states_branch_rel": rel(branch, half),
               "branch_max_abs": float(want_branch.abs().max()),
               "out_max_abs": float(want_out.abs().max()),
               "rtol": CROSS_RTOL}
        check(got["branch_rel"] <= CROSS_RTOL and got["out_rel"] <= CROSS_RTOL,
              f"cross layer vs fp32: {got}")
        check(got["control_half_states_branch_rel"] > CROSS_RTOL,
              f"the half-states control passed the cross gate: {got}")
        return got

    def vlm_forward(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params

        self._free()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(VLM_ARCH)
        t0 = time.perf_counter()
        self.vlm_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        params = self.vlm_params
        for g in params.groups:         # the reference's init gate is 0
            g.cross.xattn_gate.fill_(VLM_GATE)
        self.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(params)
        check(n_params == VLM_PARAMS, f"{VLM_ARCH}: {n_params} parameters")
        tokens = torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (1, VLM_SEQ), dtype=np.int64)).cuda()
        extra = self._stub_states(1, cfg.vision_seq, cfg.d_model, 4)
        T.forward(params, cfg, tokens[:, :256], extra)      # warm-up
        self.sync()
        self.reset_counts()
        held = self._scoring(params, cfg, tokens, extra, VLM_LAUNCHES,
                             VLM_ARCH)
        counts = self.counts()
        self._add_sm90("vlm_forward", counts)
        cross = self._cross_layer_held(params, cfg, tokens, extra)
        emit({"phase": "vlm_forward", "card": self.card, "arch": VLM_ARCH,
              "params": n_params, "dtype": cfg.dtype,
              "tokens": list(tokens.shape), "vision_states": list(extra.shape),
              "xattn_gate": VLM_GATE, "init_s": init_s, **held,
              "cross_layer_vs_fp32": cross, "main_path_launches": counts,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    def vlm_generate(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config

        params = self.vlm_params
        cfg = get_config(VLM_ARCH).replace(max_seq=GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(5).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int64)).cuda()
        extra = self._stub_states(GEN_BATCH, cfg.vision_seq, cfg.d_model, 6)
        got = self._generate_held(params, cfg, prompts, extra, VLM_ARCH)
        got.pop("cache")
        emit({"phase": "vlm_generate", "card": self.card, "arch": VLM_ARCH,
              "vision_states": list(extra.shape), **got,
              "note": "each decode step projects the 8 cross layers' k, v "
                      "from the vision states again, as the reference does",
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del self.vlm_params, params, extra
        self._free()
        emit({"phase": "vlm_demo", **self._demo(
            ["--arch", VLM_ARCH, "--batch", "4", "--prompt-len", "32",
             "--max-new", "32"])})
        self._free()

    def _add_path(self, kernel: str, path: str, n: int) -> None:
        """A main path's launches of ``kernel`` into the kernels line."""
        self.launches[kernel] = self.launches.get(kernel, 0) + n
        self.paths[kernel][path] = n

    def _add_sm90(self, path: str, counts: dict) -> None:
        """A main path's sm90 tri_attn launches into the kernels line."""
        self.launches["tri_attn_sm90"] = self.launches.get(
            "tri_attn_sm90", 0) + counts["tri_attn_sm90"]
        self.sm90_paths[path] = counts["tri_attn_sm90"]

    def _attn_shape_row(self, b, cfg, s, seed, what) -> dict:
        """tri_attn (sm90, bf16) at a model's shape: its error against
        causal_attention_ref and the medians of single calls, mapped and
        BB, beside the bound, the plain version's and
        scaled_dot_product_attention's (the yardstick only)."""
        torch, AK = self.torch, self.AK
        from repro_torch.kernels.tri_attn.ops import causal_attention
        from repro_torch.kernels.tri_attn.ref import causal_attention_ref

        h, hk, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        q, k, v = self._attn_inputs(b, h, hk, s, d, torch.bfloat16,
                                    torch.Generator(device="cuda")
                                    .manual_seed(seed))
        blk = cfg.attn_block
        check(AK.attention_route(q.dtype, blk, d) == "sm90",
              f"the {what} shape does not take the sm90 route")
        g = h // hk
        kr, vr = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
        o = causal_attention(q, k, v, blk, blk, "mapped")
        want = causal_attention_ref(q, kr, vr)
        err = float((o.float() - want.float()).abs().max())
        check(err < ATTN_TOL["bfloat16"],
              f"tri_attn at the {what} shape: vs ref {err}")
        sdpa = torch.nn.functional.scaled_dot_product_attention
        bound_ms, bound = self._attn_bound_ms(b, h, hk, s, d, 2)
        return {
            "shape": {"B": b, "H": h, "Hk": hk, "S": s, "D": d, "block": blk,
                      "dtype": "bfloat16"},
            "ms": self.time_ms(lambda: causal_attention(q, k, v, blk, blk,
                                                        "mapped")),
            "bb_ms": self.time_ms(lambda: causal_attention(
                q, k, v, blk, blk, "bounding_box")),
            "plain_ms": self.time_ms(lambda: causal_attention_ref(q, kr,
                                                                  vr)),
            "library_ms": self.time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                                    enable_gqa=g > 1)),
            "bound_ms": bound_ms, **bound, "max_abs_err": err}

    def whisper_forward(self) -> None:
        import numpy as np

        torch, AK = self.torch, self.AK
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params

        self._free()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(WHISPER_ARCH)
        t0 = time.perf_counter()
        self.whisper_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        params = self.whisper_params
        self.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(params)
        check(n_params == WHISPER_PARAMS,
              f"{WHISPER_ARCH}: {n_params} parameters")
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (WHISPER_BATCH, WHISPER_SEQ_PLAIN),
            dtype=np.int64)).cuda()
        tokens = toks[:, :WHISPER_SEQ]
        frames = self._stub_states(WHISPER_BATCH, cfg.encoder_seq,
                                   cfg.d_model, 8)
        T.forward(params, cfg, tokens[:, :128], frames)       # warm-up
        self.sync()
        self.reset_counts()
        held = self._scoring(params, cfg, tokens, frames, WHISPER_LAUNCHES,
                             WHISPER_ARCH)
        counts = self.counts()
        self._add_sm90("whisper_forward", counts)
        # at 448 tokens (448 % 128 != 0) the decoder takes the plain SDPA
        n0 = AK.ATTN_LAUNCHES
        plain448 = {impl: T.forward(params, cfg.replace(attn_impl=impl),
                                    toks, frames)
                    for impl in ("pallas_mapped", "xla")}
        self.sync()
        launches448 = AK.ATTN_LAUNCHES - n0
        check(launches448 == 0, f"{launches448} tri_attn launches at S "
              f"{WHISPER_SEQ_PLAIN}")
        check(torch.equal(plain448["pallas_mapped"], plain448["xla"]),
              f"at S {WHISPER_SEQ_PLAIN} pallas_mapped is not the xla path")
        del plain448
        # tri_attn at the decoder's shape: (B·H 128, S 384, D 64), bf16
        shape_row = self._attn_shape_row(WHISPER_BATCH, cfg, WHISPER_SEQ, 9,
                                         "whisper")
        self.attn_row["at_whisper_shape"] = shape_row
        emit({"phase": "whisper_forward", "card": self.card,
              "arch": WHISPER_ARCH, "params": n_params, "dtype": cfg.dtype,
              "tokens": list(tokens.shape), "frames": list(frames.shape),
              "init_s": init_s, **held,
              "plain_at_s": {"tokens": list(toks.shape),
                             "tri_attn_launches": launches448,
                             "equal_to_xla": True},
              "tri_attn_at_decoder_shape": shape_row,
              "main_path_launches": counts,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    def whisper_generate(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.attention import heads

        params = self.whisper_params
        cfg = get_config(WHISPER_ARCH).replace(
            max_seq=WHISPER_GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(10).integers(
            0, cfg.vocab_size, (GEN_BATCH, WHISPER_GEN_PROMPT),
            dtype=np.int64)).cuda()
        frames = self._stub_states(GEN_BATCH, cfg.encoder_seq, cfg.d_model,
                                   11)
        got = self._generate_held(params, cfg, prompts, frames, WHISPER_ARCH)
        cache = got.pop("cache")
        # decode reads the cross k/v that prefill projected once: equal to
        # a fresh projection of the encoder states, layer by layer
        with torch.inference_mode():
            enc = T._whisper_encode(params, cfg, frames)
            hk, hd = cfg.n_kv_heads, cfg.head_dim
            fresh = all(
                torch.equal(cache["cross"]["k"][i],
                            heads(enc, lp.xattn.wk, hk, hd))
                and torch.equal(cache["cross"]["v"][i],
                                heads(enc, lp.xattn.wv, hk, hd))
                for i, lp in enumerate(params.dec_layers))
        check(fresh, "the cached cross k/v differ from a fresh projection")
        emit({"phase": "whisper_generate", "card": self.card,
              "arch": WHISPER_ARCH, "frames": list(frames.shape), **got,
              "cross_cache": list(cache["cross"]["k"].shape),
              "cross_cache_equals_fresh_projection": fresh,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del self.whisper_params, params, cache, enc
        self._free()
        emit({"phase": "whisper_demo", **self._demo(
            ["--arch", WHISPER_ARCH, "--batch", "4", "--prompt-len",
             str(WHISPER_GEN_PROMPT), "--max-new", "32"])})
        self._free()

    # -- the engine backend and continuous batching --------------------------
    def _engine_entry_point(self, extra: list, domains: list,
                            want: dict) -> dict:
        """``python -m repro_torch.launch.serve --serve-maps --backend
        engine`` as a user runs it: the paper domains derived by
        SERVE_CLIENTS concurrent clients at one model and stage, every
        record deployable, ``key`` queries at MAX_POINTS bit-identical to
        the domain queries, /metrics' batching section, SIGINT and exit 0."""
        import threading

        from repro_torch.core.backends import MODEL_SPECS
        from repro_torch.serving import RemoteMappingService
        from repro_torch.serving.evaluate import MAX_POINTS

        mode = "threaded" if "--no-async" in extra else "async"
        work = ROOT / "build" / "engine_serve" / mode
        with self._serve_maps_process(extra, work, "engine") as (url, info):
            command = info["command"]
            derived, errors = {}, []
            gate = threading.Barrier(SERVE_CLIENTS)

            def one(i):
                try:
                    c = RemoteMappingService(url, timeout=600)
                    gate.wait()
                    for d in domains[i::SERVE_CLIENTS]:
                        t = time.perf_counter()
                        res = c.derive(d, ENGINE_MODEL, ENGINE_STAGE)
                        derived[d] = (res, time.perf_counter() - t)
                    c.close()
                except Exception as e:  # noqa: BLE001 — re-raised below
                    errors.append(repr(e))

            threads = [threading.Thread(target=one, args=(i,))
                       for i in range(SERVE_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            derive_s = time.perf_counter() - t0
            check(not errors, f"{command}: derives failed: {errors}")
            check(sorted(derived) == domains, f"{command}: derived "
                  f"{sorted(derived)}")
            check(all(r.compiled and r.artifact is not None
                      and r.artifact.deployable for r, _ in derived.values()),
                  f"{command}: an engine-derived record does not deploy")
            client = RemoteMappingService(url, timeout=300)
            t0 = time.perf_counter()
            got = client.evaluate_batch(
                [{"key": derived[d][0].cache_key, "n_points": MAX_POINTS}
                 for d in domains])
            key_s = time.perf_counter() - t0
            metrics = client.metrics()
            stats = metrics["batching"][ENGINE_MODEL]
            if mode == "async":
                check(stats.get("max_occupancy", 0) > 1,
                      f"{command}: continuous batching never held more "
                      f"than one request: {stats}")
            for d, r in zip(domains, got):
                check(r["coords"].dtype == want[d].dtype
                      and r["coords"].tobytes() == want[d].tobytes(),
                      f"{command}: key query for {d} differs from the "
                      f"domain query")
            client.close()
        power_w = MODEL_SPECS[ENGINE_MODEL]["power_w"]
        per_derive = {
            d: {"wall_s": wall, "inference_s": r.response.seconds,
                "tokens_out": r.response.tokens_out,
                "ms_per_decode_step_share":
                    r.response.seconds / r.response.tokens_out * 1e3,
                "joules_model_specs_power": r.response.joules,
                "cache_key": r.cache_key}
            for d, (r, wall) in sorted(derived.items())}
        return {**info, "derive_s": derive_s,
                "per_derive": per_derive,
                "model_specs_power_w": power_w, "batching": stats,
                "service": metrics["service"], "key_queries_s": key_s,
                "key_points": MAX_POINTS * len(domains),
                "evaluate": metrics.get("evaluate")}

    def engine_serve(self) -> None:
        """EngineBackend on the card with the yi-6b smoke config, as the
        reference's: generate_batch against singles, tokens and measured
        seconds; then ``--serve-maps --backend engine`` in both modes."""
        import shutil

        import numpy as np

        from repro_torch.core import paper_tables as pt
        from repro_torch.core.backends import (
            MODEL_SPECS, EngineBackend, build_prompt,
        )
        from repro_torch.core.compile_cache import CompileCache
        from repro_torch.serving.evaluate import MAX_POINTS, EvaluationService

        t_phase = time.perf_counter()
        shutil.rmtree(ROOT / "build" / "engine_serve", ignore_errors=True)
        domains = sorted(pt.ACCURACY)
        metas = [{"domain": d, "stage": ENGINE_STAGE} for d in domains]
        prompts = [build_prompt(self.DOMAINS[d], ENGINE_STAGE)
                   for d in domains]
        backend = EngineBackend(ENGINE_MODEL)
        self.reset_counts()
        t0 = time.perf_counter()
        params, cfg = backend._ensure_engine()
        self.sync()
        init_s = time.perf_counter() - t0
        check(params.embed.is_cuda, "EngineBackend's model is not on the card")
        backend.generate(prompts[0], meta=metas[0])          # warm-up
        batch = backend.generate_batch(prompts, metas)
        singles = [backend.generate(p, meta=m)
                   for p, m in zip(prompts, metas)]
        check([r.text for r in batch] == [r.text for r in singles],
              "generate_batch text differs from single generates")
        check(all(r.tokens_out == backend.max_new_tokens and r.seconds > 0
                  and r.joules > 0 for r in batch + singles),
              "an engine response without its decode steps or seconds")
        _, rows, steps, batch_s = backend.sample(prompts)
        single_rows = [backend.sample([p]) for p in prompts]
        check(all(np.array_equal(rows[i], s[1][0])
                  for i, s in enumerate(single_rows)),
              "the batch's sampled tokens differ from the singles'")
        counts = self.counts()
        check(all(n == 0 for n in counts.values()),
              f"the engine's smoke model launched kernels: {counts}")
        single_s = [s[3] for s in single_rows]
        emit({"phase": "engine_serve", "part": "backend", "card": self.card,
              "arch": backend.arch, "model": ENGINE_MODEL,
              "prompt_tokens": backend.prompt_tokens,
              "max_new_tokens": backend.max_new_tokens, "init_s": init_s,
              "batch": len(prompts), "batch_s": batch_s,
              "single_s": single_s,
              "decode_ms_per_step_single":
                  statistics.median(single_s) / steps * 1e3,
              "decode_ms_per_step_batch": batch_s / steps * 1e3,
              "joules_model_specs_power": [r.joules for r in singles],
              "model_specs_power_w": MODEL_SPECS[ENGINE_MODEL]["power_w"],
              "batch_text_equals_singles": True, "launches": counts})
        del backend, params
        self._free()

        ev = EvaluationService(compile_cache=CompileCache(max_entries=64))
        res, _ = ev.evaluate_batch([{"domain": d, "n_points": MAX_POINTS}
                                    for d in domains])
        want = {d: r["coords"] for d, r in zip(domains, res)}
        entry = [self._engine_entry_point(extra, domains, want)
                 for extra in ([], ["--no-async"])]
        emit({"phase": "engine_serve", "part": "entry_point",
              "card": self.card, "model": ENGINE_MODEL,
              "stage": ENGINE_STAGE, "domains": domains,
              "clients": SERVE_CLIENTS, "entry_point": entry,
              "phase_s": time.perf_counter() - t_phase})

    # -- the moe family ------------------------------------------------------
    def _attn_core_held(self, attn_p, cfg, n1, what, worst,
                        control: bool = False):
        """One causal attention on its own normed input ``n1``: the core's
        output under pallas_mapped and pallas_bb against xla's ``_sdpa`` on
        the same q, k, v, every element within ATTN_TOL, rows S/2 and on
        within LATE_ROW_RTOL of the row's max |o| (the ``attention``
        phase's gates), mapped within ATTN_TOL of BB; the worst values
        into ``worst``.  With ``control``, also the late-row error of the
        kernel's output with rows S/2 and on missing their first partial
        (a control that must miss that gate).  Returns (xla's branch
        output, the control's error or None)."""
        torch = self.torch
        from repro_torch.kernels.tri_attn import ops
        from repro_torch.models import attention as attn

        s = n1.shape[1]
        half = s // 2
        pos = torch.arange(s, device=n1.device)[None]
        keep = (lambda a, kw, out: (a[0], a[1], a[2], out))
        with _captured(ops, "causal_attention", keep) as calls:
            h = {impl: attn.gqa_apply(attn_p, cfg.replace(attn_impl=impl),
                                      n1)[0]
                 for impl in ("pallas_mapped", "pallas_bb")}
        h_xla = attn.gqa_apply(attn_p, cfg.replace(attn_impl="xla"), n1)[0]
        check(len(calls) == 2, f"{what}: {len(calls)} kernel calls for two "
              f"kernel attentions")
        q, k, v, _ = calls[0]
        want = attn._sdpa(*(t.transpose(1, 2) for t in (q, k, v)),
                          cfg.n_kv_heads, pos).transpose(1, 2).float()

        def gates(o):
            o = o.float()
            late = ((o[:, :, half:] - want[:, :, half:]).abs().amax(-1)
                    / want[:, :, half:].abs().amax(-1))
            return float((o - want).abs().max()), float(late.max())

        for (_, _, _, o), impl in zip(calls, h):
            err, late = gates(o)
            check(err < ATTN_TOL["bfloat16"] and late < LATE_ROW_RTOL,
                  f"{what} {impl}: attention vs xla {err} (late rows {late} "
                  f"of the row's max)")
            worst["attn_err"] = max(worst.get("attn_err", 0.0), err)
            worst["attn_late_rows_rel"] = max(
                worst.get("attn_late_rows_rel", 0.0), late)
            worst["attn_branch_rel_vs_xla"] = max(
                worst.get("attn_branch_rel_vs_xla", 0.0),
                _rel(h[impl], h_xla))
        mb = float((calls[0][3].float() - calls[1][3].float()).abs().max())
        check(mb < ATTN_TOL["bfloat16"], f"{what}: attention mapped vs BB "
              f"{mb}")
        worst["attn_mapped_vs_bb"] = max(worst.get("attn_mapped_vs_bb", 0.0),
                                         mb)
        ctrl = None
        if control:
            fault = _late_rows_drop_first_partial(
                ops.causal_attention, q, k, v, cfg.attn_block, "mapped",
                cfg.pallas_interpret)
            ctrl = gates(fault)[1]
            check(ctrl > LATE_ROW_RTOL, f"{what}: the missing-partial "
                  f"control passed the late-row gate ({ctrl})")
        return h_xla, ctrl

    def _moe_layer_gates(self, params, cfg, tokens) -> dict:
        """Each layer on its own input (the hidden state entering it in an
        xla forward).  (a) The attention core, ``_attn_core_held`` (its
        control on layer 0).  (b) The MoE branch in bf16 against the same
        layer with its expert and shared weights upcast to fp32, on the
        same input: equal routing, output within MOE_LAYER_RTOL; on the
        first and last layer the fp32 layer without top-k renormalisation
        and without its shared experts must miss that gate
        (``_moe_branch_held``)."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm

        last = cfg.n_layers - 1
        with _captured(T, "_layer_apply", lambda a, kw, out: a[2]) as inputs:
            T.forward(params, cfg.replace(attn_impl="xla"), tokens)
        check(len(inputs) == cfg.n_layers, f"{len(inputs)} layer inputs")
        worst = {"moe_rel_vs_fp32": 0.0}
        controls, drops = {}, 0
        with torch.inference_mode():
            for li, (lp, x) in enumerate(zip(params.layers, inputs)):
                h_xla, ctrl = self._attn_core_held(
                    lp.attn, cfg, rms_norm(x, lp.ln1), f"layer {li}", worst,
                    control=li == 0)
                if ctrl is not None:
                    controls["attn_late_rows_missing_first_partial"] = ctrl
                drops += self._moe_branch_held(
                    lp.moe, cfg, rms_norm(x + h_xla, lp.ln2), li,
                    li in (0, last), worst, controls)
                del h_xla
        del inputs
        return {"worst": worst, "controls": controls,
                "late_row_rtol": LATE_ROW_RTOL,
                "attn_tol": ATTN_TOL["bfloat16"],
                "moe_layer_rtol": MOE_LAYER_RTOL, "drops_xla_forward": drops,
                "layers": cfg.n_layers}

    def _moe_branch_held(self, m, cfg, inner, li, with_controls, worst,
                         controls) -> int:
        """One layer's MoE branch in bf16 on its normed input ``inner``
        against the same branch with its expert and shared weights upcast
        to fp32: equal routing, output within MOE_LAYER_RTOL (the worst into
        ``worst``).  ``with_controls``: the fp32 branch without top-k
        renormalisation and without its shared experts must miss that gate
        (into ``controls``).  Returns the bf16 branch's drops."""
        import types

        torch = self.torch
        from repro_torch.models import moe

        with moe.record_routing() as r16:
            out16 = moe.moe_apply(m, cfg, inner)
        up = types.SimpleNamespace
        p32 = up(router=m.router, gate=m.gate.float(), up=m.up.float(),
                 down=m.down.float(),
                 shared=up(gate=m.shared.gate.float(),
                           up=m.shared.up.float(),
                           down=m.shared.down.float()))
        with moe.record_routing() as r32:
            out32 = moe.moe_apply(p32, cfg, inner.float())
        check(not bool(_routing_diff(r16[0], r32[0]).any())
              and torch.equal(r16[0]["slot"], r32[0]["slot"]),
              f"layer {li}: bf16 and fp32 MoE route differently on the same "
              f"router input")
        rel = _rel(out16, out32)
        check(rel <= MOE_LAYER_RTOL, f"layer {li}: MoE bf16 vs fp32 {rel}")
        worst["moe_rel_vs_fp32"] = max(worst["moe_rel_vs_fp32"], rel)
        if with_controls:
            un = moe.moe_apply(p32, cfg.replace(moe_renormalize=False),
                               inner.float())
            p32.shared = None
            no_shared = moe.moe_apply(p32, cfg, inner.float())
            for name, c in (("moe_not_renormalised", _rel(out16, un)),
                            ("moe_no_shared_experts", _rel(out16, no_shared))):
                controls[f"layer{li}_{name}"] = c
                check(c > MOE_LAYER_RTOL,
                      f"the control layer{li}_{name} passed its gate ({c})")
        return _drops(r16)

    def _host_profile(self, fn) -> dict:
        """Host side of one ``fn()`` under torch.profiler (CPU activity):
        its wall ms to a synchronise (profiled), the aten ops dispatched,
        their self CPU time and the ops taking the most of it."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        self.sync()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages() if e.key.startswith("aten::")]
        top = sorted(ev, key=lambda e: e.self_cpu_time_total, reverse=True)
        return {"wall_ms": wall,
                "aten_calls": int(sum(e.count for e in ev)),
                "aten_self_cpu_ms": sum(e.self_cpu_time_total
                                        for e in ev) / 1e3,
                "top_self_cpu": [[e.key, e.count,
                                  e.self_cpu_time_total / 1e3]
                                 for e in top[:8]]}

    def _moe_experts_in_place(self, params, cfg) -> dict:
        """The expert products at the forward's capacity read the stored
        (d, E, f) / (f, E, d) weights in place (no copy in the trace of the
        call), and a whole ``moe_apply`` runs with CUDA's sync debug mode
        at "error": the dispatch never waits on the host."""
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.models import moe

        m = params.layers[0].moe
        cap = moe.capacity_for(MOE_SEQ, cfg)
        buf = torch.randn((cfg.n_experts, cap, cfg.d_model), device="cuda",
                          dtype=torch.bfloat16)
        with torch.inference_mode():
            moe._experts(m.gate, m.up, m.down, buf)
            self.sync()
            m0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                moe._experts(m.gate, m.up, m.down, buf)
                self.sync()
            peak = torch.cuda.max_memory_allocated() - m0
            ops_seen = sorted({e.key for e in prof.key_averages()})
            copies = [o for o in ops_seen if o in ("aten::copy_",
                                                   "aten::clone")]
            check(not copies, f"the expert products copy: {copies}")
            x = (torch.randn((1, MOE_SEQ, cfg.d_model), device="cuda")
                 ).to(torch.bfloat16)
            torch.cuda.set_sync_debug_mode("error")
            try:
                moe.moe_apply(m, cfg, x, with_aux=True)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            self.sync()
        weight_mb = m.gate.numel() * m.gate.element_size() / 1e6
        check(peak < weight_mb * 1e6,
              f"the expert products allocated {peak} bytes at their peak, "
              f"more than one {weight_mb} MB weight")
        return {"ops": ops_seen, "copies": copies, "buffer": list(buf.shape),
                "peak_extra_mb": peak / 1e6, "one_weight_mb": weight_mb,
                "moe_apply_under_sync_debug_error": True}

    def moe_forward(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params

        self._free()
        torch.cuda.reset_peak_memory_stats()
        t_phase = time.perf_counter()
        cfg = get_config(MOE_ARCH)
        t0 = time.perf_counter()
        self.moe_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        params = self.moe_params
        self.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(params)
        check(n_params == MOE_PARAMS, f"{MOE_ARCH}: {n_params} parameters")
        tokens = torch.from_numpy(np.random.default_rng(12).integers(
            0, cfg.vocab_size, (1, MOE_SEQ), dtype=np.int64)).cuda()
        T.forward(params, cfg, tokens[:, :256])      # warm-up
        self.sync()
        self.reset_counts()
        held = self._scoring(params, cfg, tokens, None, MOE_LAUNCHES,
                             MOE_ARCH, routed=True)
        counts = self.counts()
        self._add_sm90("moe_forward", counts)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        layers = self._moe_layer_gates(params, cfg, tokens)
        layers["seconds"] = time.perf_counter() - t0
        experts = self._moe_experts_in_place(params, cfg)
        shape_row = self._attn_shape_row(1, cfg, MOE_SEQ, 13, MOE_ARCH)
        self.attn_row["at_moonshot_shape"] = shape_row
        emit({"phase": "moe_forward", "card": self.card, "arch": MOE_ARCH,
              "params": n_params, "dtype": cfg.dtype,
              "tokens": list(tokens.shape), "init_s": init_s, **held,
              "layer_gates": layers, "expert_products": experts,
              "tri_attn_at_moonshot_shape": shape_row,
              "main_path_launches": counts, "peak_gb": peak_gb,
              "phase_s": time.perf_counter() - t_phase})

    def _moe_cache_gates(self, params, cfg, prompts) -> dict:
        """Prefill, then the first decode step, each layer held against the
        cache-less layer on the same inputs (the rows the pass handed that
        layer): the attention branch, every token, within MOE_LAYER_RTOL;
        the layer's output within it on every token whose routing equals
        the cache-less layer's (those that differ are counted).  The decode
        step's 4 tokens are held against the last of 4 x 513 at
        MOE_NO_DROP_CF, the normal factor's drops there printed.  A decode
        whose RoPE position is one short (layer 0) must miss the gate."""
        torch = self.torch
        from repro_torch.models import attention as attn
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm

        xcfg = cfg.replace(attn_impl="xla")
        ndcfg = xcfg.replace(capacity_factor=MOE_NO_DROP_CF)

        def traced(fn, *args):
            with _captured(T, "_layer_apply",
                           lambda a, kw, out: (a[2], out[0])) as lay, \
                    _captured(attn, "gqa_apply",
                              lambda a, kw, out: out[0]) as hs, \
                    moe.record_routing() as rec:
                out = fn(*args)
            return out, lay, hs, rec

        (pre, cache), lay_p, h_p, rec_p = traced(T.prefill, params, cfg,
                                                 prompts)
        nt = pre[:, -1:, :cfg.vocab_size].argmax(-1)
        (dec, _), lay_d, h_d, rec_d = traced(T.decode_step, params, cfg, nt,
                                             cache)
        b, s = prompts.shape
        worst = {"prefill_attn": 0.0, "prefill_layer": 0.0,
                 "decode_attn": 0.0, "decode_layer": 0.0}
        differing = {"prefill": 0, "decode": 0}
        normal_drops_full = 0
        with torch.inference_mode():
            for li, lp in enumerate(params.layers):
                x, y = lay_p[li][0], lay_d[li][0]
                # prefill: the same 2048 tokens, the same capacity
                with moe.record_routing() as r:
                    out = T._layer_apply(lp, xcfg, x)[0]
                h = attn.gqa_apply(lp.attn, xcfg, rms_norm(x, lp.ln1))[0]
                worst["prefill_attn"] = max(worst["prefill_attn"],
                                            _rel(h_p[li], h))
                same = ~_routing_diff(rec_p[li], r[0]).reshape(b, s)
                differing["prefill"] += int((~same).sum())
                d = (lay_p[li][1] - out).float().abs().amax(-1)
                if bool(same.any()):
                    worst["prefill_layer"] = max(
                        worst["prefill_layer"],
                        float(d[same].max()) / float(out.float().abs().max()))
                # decode: the new token against a cache-less pass over
                # prompt + token at a capacity that drops nothing
                xy = torch.cat([x, y], dim=1)
                with moe.record_routing() as r:
                    full = T._layer_apply(lp, ndcfg, xy)[0][:, -1:]
                h = attn.gqa_apply(lp.attn, xcfg,
                                   rms_norm(xy, lp.ln1))[0][:, -1:]
                worst["decode_attn"] = max(worst["decode_attn"],
                                           _rel(h_d[li], h))
                k = cfg.moe_top_k
                last = {key: r[0][key].reshape(b, s + 1, k)[:, -1]
                        for key in ("top_e", "keep")}
                same = ~_routing_diff(rec_d[li], last)
                differing["decode"] += int((~same).sum())
                d = (lay_d[li][1] - full).float().abs().amax(-1)[:, 0]
                if bool(same.any()):
                    worst["decode_layer"] = max(
                        worst["decode_layer"],
                        float(d[same].max()) / float(full.float().abs().max()))
                loads = torch.bincount(r[0]["top_e"].flatten(),
                                       minlength=cfg.n_experts)
                cap = moe.capacity_for(b * (s + 1), cfg)
                normal_drops_full += int((loads - cap).clamp(min=0).sum())
                if li == 0:
                    short = torch.full((b, 1), s - 1, device=y.device)
                    wrong = attn.gqa_apply(lp.attn, cfg, rms_norm(y, lp.ln1),
                                           positions=short,
                                           cache=cache["layers"][0])[0]
                    control = _rel(wrong, h)
        for name, w in worst.items():
            check(w <= MOE_LAYER_RTOL, f"{name} against the cache-less layer:"
                  f" {w}")
        check(control > MOE_LAYER_RTOL, f"the one-short RoPE control passed "
              f"the decode gate ({control})")
        return {"worst": worst, "rtol": MOE_LAYER_RTOL,
                "tokens_with_other_routing": differing,
                "decisions": {"prefill": b * s * cfg.n_layers,
                              "decode": b * cfg.n_layers},
                "drops": {"prefill": _drops(rec_p), "decode": _drops(rec_d),
                          "cache_less_4x513_normal_cf": normal_drops_full,
                          "cache_less_4x513_no_drop_cf": 0},
                "no_drop_capacity_factor": MOE_NO_DROP_CF,
                "control_rope_one_short_decode_attn": control}

    def moe_generate(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        from repro_torch.serving.engine import generate

        params = self.moe_params
        cfg = get_config(MOE_ARCH).replace(max_seq=GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(14).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int64)).cuda()
        b, s, n_l = GEN_BATCH, GEN_PROMPT, cfg.n_layers
        self.reset_counts()
        with moe.record_routing() as rec:
            t0 = time.perf_counter()
            res = generate(params, cfg, prompts, GEN_NEW)
            self.sync()
            gen_s = time.perf_counter() - t0
        check(res.steps == GEN_NEW and res.tokens.shape == (b, s + GEN_NEW),
              f"{MOE_ARCH}: generate's shape")
        check(bool((res.tokens[:, :s] == prompts).all()),
              f"{MOE_ARCH}: generate changed the prompt")
        check(len(rec) == n_l * (1 + GEN_NEW), f"{len(rec)} MoE calls")
        gen_drops = {"prefill": _drops(rec[:n_l]),
                     "decode_steps": _drops(rec[n_l:])}
        del rec
        t0 = time.perf_counter()
        with moe.record_routing() as rec_pre:
            pre, cache = T.prefill(params, cfg, prompts)
            self.sync()
        prefill_s = time.perf_counter() - t0
        nt = pre[:, -1:, :cfg.vocab_size].argmax(-1)
        check(torch.equal(nt, res.tokens[:, s:s + 1]),
              f"{MOE_ARCH}: a second prefill's first token is not generate's")
        dec, _ = T.decode_step(params, cfg, nt, cache)
        check(torch.equal(dec[:, :, :cfg.vocab_size].argmax(-1),
                          res.tokens[:, s + 1:s + 2]),
              f"{MOE_ARCH}: a second first decode step's token is not "
              f"generate's")
        decode_profile = self._host_profile(
            lambda: T.decode_step(params, cfg, nt, cache))
        # the whole model against forward: printed, not gated (routing
        # flips; see _scoring)
        with moe.record_routing() as rec_fwd:
            fwd = T.forward(params, cfg, prompts)
        whole = {"prefill_vs_forward_rel": _rel(pre, fwd),
                 "prefill_vs_forward_top1": float(
                     (pre.argmax(-1) == fwd.argmax(-1)).float().mean()),
                 "routing_flips_prefill_vs_forward": _flips(rec_pre, rec_fwd),
                 "decisions": b * s * n_l}
        del pre, fwd, rec_pre, rec_fwd
        with moe.record_routing() as rec_full:
            full = T.forward(params, cfg, torch.cat([prompts, nt], dim=1))
        whole["decode_vs_forward_rel"] = _rel(dec[:, 0], full[:, -1])
        whole["forward_4x513_drops"] = _drops(rec_full)
        del full, dec, cache, rec_full
        launches = self.AK.ATTN_LAUNCHES
        check(launches == 0, f"{MOE_ARCH}: {launches} tri_attn launches in "
              f"generate")
        t0 = time.perf_counter()
        layers = self._moe_cache_gates(params, cfg, prompts)
        layers["seconds"] = time.perf_counter() - t0
        emit({"phase": "moe_generate", "card": self.card, "arch": MOE_ARCH,
              "batch": b, "prompt": s, "new": GEN_NEW,
              "max_seq": cfg.max_seq, "generate_s": gen_s,
              "prefill_s": prefill_s,
              "decode_ms_per_step": (gen_s - prefill_s) / GEN_NEW * 1e3,
              "tokens_per_s": b * GEN_NEW / gen_s, "generate_drops": gen_drops,
              "whole_model_not_gated": whole, "layer_gates": layers,
              "decode_step_host_profile": decode_profile,
              "tri_attn_launches": launches,
              "sample": res.tokens[0, s:s + 8].tolist(),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del self.moe_params, params
        self._free()
        emit({"phase": "moe_demo", **self._demo(
            ["--arch", MOE_ARCH, "--batch", "4", "--prompt-len", "32",
             "--max-new", "32"])})
        self._free()

    # -- the hybrid family ---------------------------------------------------
    def _mamba_core_held(self, params, cfg, tokens) -> dict:
        """MAMBA_HELD_LAYERS' SSD on each layer's own inputs (its conv
        output and dt in an xla forward), chunked against the scan from a
        zero state: y and the final state within MAMBA_CORE_RTOL; the
        chunked form restarted at S/2 (a control) must miss it."""
        torch = self.torch
        from repro_torch.models import mamba2 as m2
        from repro_torch.models import transformer as T

        with _captured(m2, "mamba2_apply",
                       lambda a, kw, out: (a[0], a[2])) as calls:
            T.forward(params, cfg.replace(attn_impl="xla"), tokens)
        check(len(calls) == cfg.n_layers, f"{len(calls)} Mamba2 calls")
        rows = {}
        s = tokens.shape[1]
        h, n = cfg.mamba_heads, cfg.ssm_state
        with torch.inference_mode():
            for li in MAMBA_HELD_LAYERS:
                p, xn = calls[li]
                _, xbc, dt_raw = m2._split_proj(cfg, xn @ p.in_proj)
                xbc_act, _ = m2._causal_conv(xbc, p.conv_w, p.conv_b)
                st0 = torch.zeros((tokens.shape[0], h, cfg.mamba_d_inner // h,
                                   n), dtype=torch.float32,
                                  device=tokens.device)
                t0 = time.perf_counter()
                yc, sc = m2.mamba2_core_chunked(p, cfg, xbc_act, dt_raw, st0)
                self.sync()
                t1 = time.perf_counter()
                ys, ss = m2.mamba2_core_scan(p, cfg, xbc_act, dt_raw, st0)
                self.sync()
                t2 = time.perf_counter()
                y1, _ = m2.mamba2_core_chunked(p, cfg, xbc_act[:, :s // 2],
                                               dt_raw[:, :s // 2], st0)
                y2, _ = m2.mamba2_core_chunked(p, cfg, xbc_act[:, s // 2:],
                                               dt_raw[:, s // 2:], st0)
                row = {"y_rel": _rel(yc, ys), "state_rel": _rel(sc, ss),
                       "control_restart_at_half_y_rel":
                           _rel(torch.cat([y1, y2], dim=1), ys),
                       "chunked_s": t1 - t0, "scan_s": t2 - t1,
                       "y_max_abs": float(ys.abs().max())}
                check(row["y_rel"] <= MAMBA_CORE_RTOL
                      and row["state_rel"] <= MAMBA_CORE_RTOL,
                      f"layer {li}: chunked SSD vs scan {row}")
                check(row["control_restart_at_half_y_rel"] > MAMBA_CORE_RTOL,
                      f"layer {li}: the restart control passed {row}")
                rows[f"layer{li}"] = row
        del calls
        return {"rtol": MAMBA_CORE_RTOL, **rows}

    def _hybrid_firing_gates(self, params, cfg, tokens) -> dict:
        """Each firing of the shared block on its own input (the hidden
        state it got in an xla forward): its attention core through
        ``_attn_core_held``, the control on the first firing."""
        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm

        with _captured(T, "_layer_apply", lambda a, kw, out: a[2]) as inputs:
            T.forward(params, cfg.replace(attn_impl="xla"), tokens)
        check(len(inputs) == HYBRID_LAUNCHES, f"{len(inputs)} firings")
        worst, shared = {}, params.shared
        with torch.inference_mode():
            for i, x in enumerate(inputs):
                _, ctrl = self._attn_core_held(
                    shared.attn, cfg, rms_norm(x, shared.ln1), f"firing {i}",
                    worst, control=i == 0)
                if ctrl is not None:
                    control = ctrl
        del inputs
        return {"worst": worst, "firings": HYBRID_LAUNCHES,
                "control_late_rows_missing_first_partial": control,
                "late_row_rtol": LATE_ROW_RTOL,
                "attn_tol": ATTN_TOL["bfloat16"]}

    def hybrid_forward(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params

        self._free()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(HYBRID_ARCH)
        t0 = time.perf_counter()
        self.hybrid_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        params = self.hybrid_params
        self.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(params)
        check(n_params == HYBRID_PARAMS,
              f"{HYBRID_ARCH}: {n_params} parameters")
        tokens = torch.from_numpy(np.random.default_rng(15).integers(
            0, cfg.vocab_size, (1, HYBRID_SEQ), dtype=np.int64)).cuda()
        T.forward(params, cfg, tokens[:, :256])      # warm-up
        self.sync()
        self.reset_counts()
        held = self._scoring(params, cfg, tokens, None, HYBRID_LAUNCHES,
                             HYBRID_ARCH, gate_top1=False)
        counts = self.counts()
        self._add_sm90("hybrid_forward", counts)
        firings = self._hybrid_firing_gates(params, cfg, tokens)
        ssd = self._mamba_core_held(params, cfg, tokens)
        shape_row = self._attn_shape_row(1, cfg, HYBRID_SEQ, 16, HYBRID_ARCH)
        self.attn_row["at_zamba2_shape"] = shape_row
        emit({"phase": "hybrid_forward", "card": self.card,
              "arch": HYBRID_ARCH, "params": n_params, "dtype": cfg.dtype,
              "tokens": list(tokens.shape), "init_s": init_s, **held,
              "firing_gates": firings, "ssd_chunked_vs_scan": ssd,
              "tri_attn_at_zamba2_shape": shape_row,
              "main_path_launches": counts,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})

    def hybrid_generate(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T

        params = self.hybrid_params
        cfg = get_config(HYBRID_ARCH).replace(max_seq=GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(17).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int64)).cuda()
        got = self._generate_held(params, cfg, prompts, None, HYBRID_ARCH)
        cache = got.pop("cache")
        nt = torch.zeros((GEN_BATCH, 1), dtype=torch.int64, device="cuda")
        decode_profile = self._host_profile(
            lambda: T.decode_step(params, cfg, nt, cache))
        # one k/v per firing of the shared block, each its own
        shared = cache["shared"]
        n_inv = cfg.n_layers // cfg.hybrid_attn_every
        check(len(shared) == n_inv and cache["idx"] == GEN_PROMPT
              and all(c["idx"] == GEN_PROMPT for c in shared),
              f"{HYBRID_ARCH}: the shared block's caches")
        check(not any(torch.equal(shared[i]["k"], shared[j]["k"])
                      for i in range(n_inv) for j in range(i)),
              f"{HYBRID_ARCH}: two firings share their k")
        emit({"phase": "hybrid_generate", "card": self.card,
              "arch": HYBRID_ARCH, **got,
              "shared_block_caches": n_inv,
              "decode_step_host_profile": decode_profile,
              "mamba_state": list(cache["layers"][0]["state"].shape),
              "conv_tail": list(cache["layers"][0]["conv_tail"].shape),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        del self.hybrid_params, params, cache, shared
        self._free()
        emit({"phase": "hybrid_demo", **self._demo(
            ["--arch", HYBRID_ARCH, "--batch", "4", "--prompt-len", "64",
             "--max-new", "32"])})
        self._free()

    # -- MLA (deepseek-v2) ---------------------------------------------------
    def _mla_layer_held(self, a, cfg, n1, li, worst, controls):
        """One MLA layer's attention on its own normed input ``n1`` in bf16
        against the same layer with its weights upcast to fp32, within
        MLA_LAYER_RTOL; on layer 0 the fp32 layer with its k and v
        up-projections swapped must miss that gate.  Returns the bf16
        branch's output."""
        import types

        from repro_torch.models import attention as attn

        out16 = attn.mla_apply(a, cfg, n1)[0]
        a32 = types.SimpleNamespace(**{n: getattr(a, n).float()
                                       for n in attn.MLA_NAMES})
        rel = _rel(out16, attn.mla_apply(a32, cfg, n1.float())[0])
        check(rel <= MLA_LAYER_RTOL, f"layer {li}: MLA bf16 vs fp32 {rel}")
        worst["mla_rel_vs_fp32"] = max(worst["mla_rel_vs_fp32"], rel)
        if li == 0:
            a32.wuk, a32.wuv = a32.wuv, a32.wuk
            c = _rel(out16, attn.mla_apply(a32, cfg, n1.float())[0])
            controls["layer0_mla_wuk_wuv_swapped"] = c
            check(c > MLA_LAYER_RTOL, f"the control layer0_mla_wuk_wuv_"
                  f"swapped passed its gate ({c})")
        del a32
        return out16

    def mla_forward(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        from repro_torch.models.common import count_params, rms_norm
        from repro_torch.train.train_step import lm_loss

        self._free()
        torch.cuda.reset_peak_memory_stats()
        t_phase = time.perf_counter()
        full = get_config(MLA_ARCH)
        cfg = full.replace(n_layers=MLA_LAYERS)
        t0 = time.perf_counter()
        self.mla_params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        params = self.mla_params
        self.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(params)
        check(n_params == MLA_PARAMS, f"{MLA_ARCH} cut: {n_params} parameters")
        per_layer = count_params(params.layers[0])
        n_full = n_params + (full.n_layers - MLA_LAYERS) * per_layer
        check(n_full == MLA_FULL_PARAMS, f"{MLA_ARCH}: {n_full} parameters")
        tokens = torch.from_numpy(np.random.default_rng(18).integers(
            0, cfg.vocab_size, (1, MLA_SEQ), dtype=np.int64)).cuda()
        T.forward(params, cfg, tokens[:, :256])      # warm-up
        self.sync()
        self.reset_counts()
        fwd_s = []
        for _ in range(2):
            t0 = time.perf_counter()
            with moe.record_routing() as rec:
                logits = T.forward(params, cfg, tokens)
                self.sync()
            fwd_s.append(time.perf_counter() - t0)
        check(logits.shape == (1, MLA_SEQ, cfg.padded_vocab)
              and logits.dtype == torch.float32, f"{MLA_ARCH}: logits shape")
        check(bool(torch.isfinite(logits).all()),
              f"{MLA_ARCH}: logits not finite")
        check(self.AK.ATTN_LAUNCHES == 0, f"{MLA_ARCH}: MLA reached tri_attn")
        shown = {"max_abs": float(logits.abs().max()),
                 "mean": float(logits.mean()), "std": float(logits.std()),
                 "argmax_first8": logits[0, :8].argmax(-1).tolist()}
        del logits
        t0 = time.perf_counter()
        loss, metrics = lm_loss(params, cfg, {"tokens": tokens,
                                              "labels": tokens.roll(-1, 1)})
        ce, aux = float(metrics["ce"]), float(metrics["moe_aux"])
        loss_s = time.perf_counter() - t0
        check(math.isfinite(ce) and math.isfinite(float(loss)),
              f"{MLA_ARCH}: CE {ce}")
        peak_fwd = torch.cuda.max_memory_allocated() / 1e9
        # every layer on its own input (the hidden state entering it)
        t0 = time.perf_counter()
        with _captured(T, "_layer_apply", lambda a, kw, out: a[2]) as inputs:
            T.forward(params, cfg, tokens)
        check(len(inputs) == MLA_LAYERS, f"{len(inputs)} layer inputs")
        worst = {"mla_rel_vs_fp32": 0.0, "moe_rel_vs_fp32": 0.0}
        controls, drops = {}, 0
        with torch.inference_mode():
            for li, (lp, x) in enumerate(zip(params.layers, inputs)):
                h = self._mla_layer_held(lp.attn, cfg, rms_norm(x, lp.ln1),
                                         li, worst, controls)
                drops += self._moe_branch_held(
                    lp.moe, cfg, rms_norm(x + h, lp.ln2), li,
                    li in (0, MLA_LAYERS - 1), worst, controls)
                del h
        del inputs
        layers = {"worst": worst, "controls": controls,
                  "mla_layer_rtol": MLA_LAYER_RTOL,
                  "moe_layer_rtol": MOE_LAYER_RTOL, "drops": drops,
                  "seconds": time.perf_counter() - t0}
        emit({"phase": "mla_forward", "card": self.card, "arch": MLA_ARCH,
              "full_params": n_full, "layers": f"{MLA_LAYERS} of "
              f"{full.n_layers}", "params": n_params, "dtype": cfg.dtype,
              "tokens": list(tokens.shape), "init_s": init_s,
              "forward_s": fwd_s, "lm_loss_s": loss_s, "loss": float(loss),
              "ce": ce, "moe_aux": aux, "logits": shown,
              "drops_by_layer": [_drops([r]) for r in rec],
              "assignments_per_layer": MLA_SEQ * cfg.moe_top_k,
              "tri_attn_launches": self.AK.ATTN_LAUNCHES,
              "layer_gates": layers, "peak_gb_forward": peak_fwd,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "phase_s": time.perf_counter() - t_phase})

    def mla_generate(self) -> None:
        import numpy as np

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.models import attention as attn
        from repro_torch.models import moe
        from repro_torch.models import transformer as T
        from repro_torch.models.common import rms_norm
        from repro_torch.serving.engine import generate

        params = self.mla_params
        t_phase = time.perf_counter()
        cfg = get_config(MLA_ARCH).replace(n_layers=MLA_LAYERS,
                                           max_seq=GEN_PROMPT + GEN_NEW)
        prompts = torch.from_numpy(np.random.default_rng(19).integers(
            0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT), dtype=np.int64)).cuda()
        b, s, n_l = GEN_BATCH, GEN_PROMPT, cfg.n_layers
        self.reset_counts()
        with moe.record_routing() as rec:
            t0 = time.perf_counter()
            res = generate(params, cfg, prompts, GEN_NEW)
            self.sync()
            gen_s = time.perf_counter() - t0
        check(res.steps == GEN_NEW and res.tokens.shape == (b, s + GEN_NEW),
              f"{MLA_ARCH}: generate's shape")
        check(bool((res.tokens[:, :s] == prompts).all()),
              f"{MLA_ARCH}: generate changed the prompt")
        check(len(rec) == n_l * (1 + GEN_NEW), f"{len(rec)} MoE calls")
        gen_drops = {"prefill": _drops(rec[:n_l]),
                     "decode_steps": _drops(rec[n_l:])}
        del rec
        t0 = time.perf_counter()
        pre, cache = T.prefill(params, cfg, prompts)
        self.sync()
        prefill_s = time.perf_counter() - t0
        nt = pre[:, -1:, :cfg.vocab_size].argmax(-1)
        check(torch.equal(nt, res.tokens[:, s:s + 1]),
              f"{MLA_ARCH}: a second prefill's first token is not generate's")
        del pre
        lc0 = cache["layers"][0]
        check(set(lc0) == {"ckv", "krope", "idx"} and lc0["idx"] == s
              and lc0["ckv"].shape == (b, cfg.max_seq, cfg.kv_lora_rank)
              and lc0["ckv"].dtype == torch.bfloat16,
              f"{MLA_ARCH}: the MLA cache {[(k, getattr(v, 'shape', v)) for k, v in lc0.items()]}")
        per_layer = (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
        gqa_layer = 2 * cfg.n_heads * cfg.head_dim * 2
        decode_profile = self._host_profile(
            lambda: T.decode_step(params, cfg, nt, cache))
        # per layer on one cache: the prefill's layer inputs, then the
        # decode step's layer inputs and attention outputs (absorbed)
        with _captured(T, "_layer_apply", lambda a, kw, out: a[2]) as xs:
            _, cache = T.prefill(params, cfg, prompts)
        with _captured(T, "_layer_apply", lambda a, kw, out: a[2]) as ys, \
                _captured(attn, "mla_apply", lambda a, kw, out: out[0]) as hs:
            dec, _ = T.decode_step(params, cfg, nt, cache)
        check(len(xs) == len(ys) == len(hs) == n_l, "captured layers")
        check(bool(torch.isfinite(dec).all()), f"{MLA_ARCH}: decode logits")
        pos = torch.full((b, 1), s, dtype=torch.int64, device="cuda")
        never = cfg.replace(mla_absorb="never")
        worst = {"absorbed_vs_never": 0.0, "absorbed_vs_cache_less": 0.0,
                 "never_vs_cache_less": 0.0}
        with torch.inference_mode():
            for li, lp in enumerate(params.layers):
                y = rms_norm(ys[li], lp.ln1)
                h_never = attn.mla_apply(lp.attn, never, y, positions=pos,
                                         cache=cache["layers"][li])[0]
                xy = rms_norm(torch.cat([xs[li], ys[li]], dim=1), lp.ln1)
                h_full = attn.mla_apply(lp.attn, cfg, xy)[0][:, -1:]
                for name, got, want in (
                        ("absorbed_vs_never", hs[li], h_never),
                        ("absorbed_vs_cache_less", hs[li], h_full),
                        ("never_vs_cache_less", h_never, h_full)):
                    worst[name] = max(worst[name], _rel(got, want))
                if li == 0:
                    keep_full0 = h_full
            short = attn.mla_apply(params.layers[0].attn, cfg,
                                   rms_norm(ys[0], params.layers[0].ln1),
                                   positions=pos - 1,
                                   cache=cache["layers"][0])[0]
            control = _rel(short, keep_full0)
        for name, w in worst.items():
            check(w <= MLA_LAYER_RTOL, f"{MLA_ARCH} decode {name}: {w}")
        check(control > MLA_LAYER_RTOL, f"the one-short RoPE control passed "
              f"the decode gate ({control})")
        del xs, ys, hs, dec, cache
        weight_bytes = sum(p.numel() * p.element_size()
                           for p in params.parameters())
        launches = self.AK.ATTN_LAUNCHES
        check(launches == 0, f"{MLA_ARCH}: {launches} tri_attn launches")
        emit({"phase": "mla_generate", "card": self.card, "arch": MLA_ARCH,
              "layers": n_l, "batch": b, "prompt": s, "new": GEN_NEW,
              "max_seq": cfg.max_seq, "generate_s": gen_s,
              "prefill_s": prefill_s,
              "decode_ms_per_step": (gen_s - prefill_s) / GEN_NEW * 1e3,
              "tokens_per_s": b * GEN_NEW / gen_s,
              "decode_weight_read_bound_ms":
                  weight_bytes / HBM_BYTES_PER_S * 1e3,
              "weight_bytes": weight_bytes,
              "cache_bytes_per_token": {
                  "per_layer": per_layer, "these_layers": per_layer * n_l,
                  "all_60_layers": per_layer * 60,
                  "gqa_128_heads_per_layer": gqa_layer},
              "generate_drops": gen_drops, "layer_gates": {
                  "worst": worst, "rtol": MLA_LAYER_RTOL,
                  "control_rope_one_short": control},
              "decode_step_host_profile": decode_profile,
              "tri_attn_launches": launches,
              "sample": res.tokens[0, s:s + 8].tolist(),
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
              "phase_s": time.perf_counter() - t_phase})
        del self.mla_params, params
        self._free()

    # -- training (llama3.2-3b) ----------------------------------------------
    def _train_cfg(self, n_layers: int | None = None):
        from repro_torch.configs import get_config

        cfg = get_config(TRAIN_ARCH).replace(attn_impl="pallas_mapped",
                                             max_seq=TRAIN_SEQ)
        return cfg if n_layers is None else cfg.replace(n_layers=n_layers)

    def _train_params(self, cfg, seed: int = 0):
        from repro_torch.models import transformer as T

        return T.init_params(
            cfg, self.torch.Generator(device="cuda").manual_seed(seed), "cuda")

    def _train_batch(self, cfg, step: int, batch: int = TRAIN_BATCH) -> dict:
        from repro_torch.train.data import DataConfig, SyntheticLM

        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ, global_batch=batch))
        return {k: self.torch.from_numpy(v).cuda()
                for k, v in data.batch_at(step).items()}

    @staticmethod
    def _train_tcfg(microbatches: int = TRAIN_MICROBATCHES, lr: float = 3e-4):
        from repro_torch.train import optimizer as opt
        from repro_torch.train.train_step import TrainConfig

        return TrainConfig(optimizer=opt.OptimizerConfig(
            lr=lr, warmup_steps=2, total_steps=TRAIN_STEPS),
            microbatches=microbatches)

    def _train_bounds(self, cfg, params) -> dict:
        """The step's product bound, counted from the code: the layers'
        weight products (bf16; forward, its remat recompute, and dX, dW in
        the backward) and the kernel's causal forward (forward and
        recompute) at 989 TFLOP/s; the tied head's product (fp32 in
        ``_logits``; forward, dX, dW) and the plain attention backward
        (fp32 over the whole S x S: QK^T and PV again, then four products)
        at 67 TFLOP/s, as the code runs them, one after another."""
        n_tok = TRAIN_BATCH * TRAIN_SEQ
        b_mb = TRAIN_BATCH // TRAIN_MICROBATCHES
        s, h, d = TRAIN_SEQ, cfg.n_heads, cfg.head_dim
        l_ = cfg.n_layers
        p_layer = sum(p.numel() for p in params.layers[0].parameters()
                      if p.ndim >= 2)
        passes = TRAIN_MICROBATCHES * l_ * b_mb * h
        bf16 = {"layer_products": 2 * n_tok * l_ * p_layer * 4,
                "attention_forward_and_recompute":
                    passes * 2 * 4 * d * (s * (s + 1) // 2)}
        fp32 = {"head": 2 * n_tok * cfg.d_model * cfg.padded_vocab * 3,
                "attention_backward_plain": passes * 12 * s * s * d}
        t_bf16 = sum(bf16.values()) / BF16_FLOP_PER_S
        t_fp32 = sum(fp32.values()) / FP32_FLOP_PER_S
        return {"bf16_flop": bf16, "fp32_flop": fp32, "bf16_s": t_bf16,
                "fp32_s": t_fp32, "product_bound_s": t_bf16 + t_fp32}

    @contextlib.contextmanager
    def _timed_optimizer(self, keep_grads: bool = False):
        """Within the block each ``optimizer.apply_updates`` call is timed
        on the device (CUDA events around it, read after the step's sync)
        and, with ``keep_grads``, its gradient dict kept; yields (events,
        grads)."""
        from repro_torch.train import optimizer as opt

        real, events, grads = opt.apply_updates, [], []

        def timed(model, g, state, cfg):
            a = self.torch.cuda.Event(enable_timing=True)
            b = self.torch.cuda.Event(enable_timing=True)
            a.record()
            out = real(model, g, state, cfg)
            b.record()
            events.append((a, b))
            if keep_grads:
                grads.append(g)
            return out

        opt.apply_updates = timed
        try:
            yield events, grads
        finally:
            opt.apply_updates = real

    def _device_profile(self, fn) -> dict:
        """One ``fn()`` under torch.profiler with CUDA activity: the device
        time of every kernel summed, by class (``ta_sm90`` the tri_attn
        kernels; gemm / gemv the library's products; the rest), the
        kernels taking the most, and the device's idle share of the
        profiled wall time (the profiler's host cost included)."""
        from torch.profiler import ProfilerActivity, profile

        self.sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            self.sync()
            wall = (time.perf_counter() - t0) * 1e3
        ev = [e for e in prof.key_averages()
              if e.device_type.name == "CUDA" and e.self_device_time_total]
        classes = {"tri_attn": 0.0, "gemm": 0.0, "other": 0.0}
        for e in ev:
            name = e.key.lower()
            kind = ("tri_attn" if "ta_sm90" in name else
                    "gemm" if re.search(r"gemm|gemv|xmma|cutlass", name)
                    else "other")
            classes[kind] += e.self_device_time_total / 1e3
        device = sum(classes.values())
        top = sorted(ev, key=lambda e: e.self_device_time_total,
                     reverse=True)[:10]
        return {"wall_ms": wall, "device_ms": device,
                "idle_share": 1 - device / wall if device else None,
                "device_ms_by_class": classes,
                "top_kernels": [[e.key[:80], e.count,
                                 e.self_device_time_total / 1e3]
                                for e in top]}

    def _grads_rel(self, a: dict, b: dict) -> float:
        """max over tensors of max |a - b| / max |b| (fp32)."""
        return max(float((a[n].float() - b[n].float()).abs().max())
                   / max(float(b[n].float().abs().max()), 1e-30) for n in b)

    def _train_main(self, cfg) -> dict:
        """The main path: TRAIN_STEPS steps from seed-0 weights, preceded by
        the same first step under xla from the same weights and batch."""
        torch, AK = self.torch, self.AK
        from repro_torch.models.common import count_params
        from repro_torch.train import optimizer as opt
        from repro_torch.train.train_step import make_train_step

        t0 = time.perf_counter()
        params = self._train_params(cfg)
        self.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(params)
        check(n_params == TRAIN_PARAMS, f"{TRAIN_ARCH}: {n_params} parameters")
        batches = [self._train_batch(cfg, i) for i in range(TRAIN_STEPS)]
        tcfg = self._train_tcfg()
        # the same first step under xla, then the weights put back
        host = {n: p.detach().to("cpu", copy=True)
                for n, p in params.named_parameters()}
        state = opt.init_state(params)
        n0 = AK.ATTN_LAUNCHES
        t0 = time.perf_counter()
        xm = make_train_step(cfg.replace(attn_impl="xla"), tcfg)(
            params, state, batches[0])[2]
        self.sync()
        xla_s = time.perf_counter() - t0
        check(AK.ATTN_LAUNCHES == n0, "the xla step launched tri_attn")
        xm = {k: float(v) for k, v in xm.items()}
        del state
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(host[n])
        del host
        self._free()
        torch.cuda.reset_peak_memory_stats()
        step = make_train_step(cfg, tcfg)
        state = opt.init_state(params)
        rows, per_step = [], []
        with self._timed_optimizer() as (events, _):
            self.reset_counts()
            for i in range(TRAIN_STEPS):
                n1 = AK.ATTN_SM90_LAUNCHES
                t0 = time.perf_counter()
                params, state, m = step(params, state, batches[i])
                self.sync()
                rows.append({"step_s": time.perf_counter() - t0,
                             **{k: float(v) for k, v in m.items()}})
                per_step.append(AK.ATTN_SM90_LAUNCHES - n1)
            counts = self.counts()
        self._add_sm90("train", counts)
        peak = torch.cuda.max_memory_allocated() / 1e9
        opt_ms = [a.elapsed_time(b) for a, b in events]
        check(per_step == [TRAIN_LAUNCHES_PER_STEP] * TRAIN_STEPS
              and counts["tri_attn"] == counts["tri_attn_sm90"],
              f"{TRAIN_ARCH}: sm90 launches per step {per_step} (all "
              f"{counts}), want {TRAIN_LAUNCHES_PER_STEP}")
        check(all(math.isfinite(r[k]) for r in rows for k in r),
              f"{TRAIN_ARCH}: a metric is not finite: {rows}")
        check(int(state["step"]) == TRAIN_STEPS, "the optimizer's step")
        k0 = rows[0]
        vs_xla = {"loss_rel": abs(k0["loss"] - xm["loss"]) / abs(xm["loss"]),
                  "ce_rel": abs(k0["ce"] - xm["ce"]) / abs(xm["ce"]),
                  "grad_norm_rel": abs(k0["grad_norm"] - xm["grad_norm"])
                  / xm["grad_norm"], "xla": xm, "xla_step_s": xla_s,
                  "loss_rtol": CE_RTOL, "grad_norm_rtol": TRAIN_GNORM_RTOL}
        check(vs_xla["loss_rel"] <= CE_RTOL and vs_xla["ce_rel"] <= CE_RTOL,
              f"{TRAIN_ARCH}: step loss kernel vs xla {vs_xla}")
        check(vs_xla["grad_norm_rel"] <= TRAIN_GNORM_RTOL,
              f"{TRAIN_ARCH}: grad norm kernel vs xla {vs_xla}")
        check(k0["lr"] == xm["lr"], "lr kernel vs xla")
        profile = self._device_profile(
            lambda: step(params, state, batches[0]))
        opt_bytes = sum(p.numel() * (2 * p.element_size() + 4 + 16)
                        for p in params.parameters())
        step_s = statistics.median(r["step_s"] for r in rows[1:])
        bounds = self._train_bounds(cfg, params)
        del params, state, batches, events
        self._free()
        return {"params": n_params, "init_s": init_s, "steps": rows,
                "step_s_median_after_first": step_s,
                "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
                "sm90_launches_per_step": per_step, "main_path": counts,
                "peak_gb": peak, "optimizer_ms": opt_ms,
                "optimizer_bytes": opt_bytes,
                "optimizer_bound_ms": opt_bytes / HBM_BYTES_PER_S * 1e3,
                "step_bound": bounds, "kernel_vs_xla_first_step": vs_xla,
                "step_device_profile": profile}

    def _train_attention_grads(self) -> dict:
        """tri_attn's gradient at the training shape: the kernel's
        autograd node runs the plain vjp on its saved q, k, v, so dq, dk
        and dv equal the plain route's bit for bit; the plain vjp's time
        (its forward again and four products over S x S in fp32)."""
        torch = self.torch
        from repro_torch.kernels.tri_attn.ops import causal_attention
        from repro_torch.kernels.tri_attn.ref import causal_attention_ref

        cfg = self._train_cfg()
        h, hk, d, g_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
            cfg.n_heads // cfg.n_kv_heads
        gen = torch.Generator(device="cuda").manual_seed(21)
        q, k, v = (t.requires_grad_() for t in self._attn_inputs(
            1, h, hk, TRAIN_SEQ, d, torch.bfloat16, gen))
        g = torch.randn((1, h, TRAIN_SEQ, d), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        n0 = self.AK.ATTN_SM90_LAUNCHES
        o = causal_attention(q, k, v, cfg.attn_block, cfg.attn_block,
                             "mapped")
        check(self.AK.ATTN_SM90_LAUNCHES == n0 + 1, "one sm90 launch")
        got = torch.autograd.grad(o, (q, k, v), g)

        def plain():
            ref = causal_attention_ref(q, k.repeat_interleave(g_, 1),
                                       v.repeat_interleave(g_, 1))
            return torch.autograd.grad(ref, (q, k, v), g)

        want = plain()
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        check(all(same), f"tri_attn's dq, dk, dv differ from the plain "
              f"route's: {same}")
        return {"shape": {"B": 1, "H": h, "Hk": hk, "S": TRAIN_SEQ, "D": d,
                          "dtype": "bfloat16"},
                "bitwise_equal_dq_dk_dv": same,
                "plain_forward_and_backward_ms": self.time_ms(plain, reps=3),
                "plain_backward_flop": 12 * h * TRAIN_SEQ ** 2 * d}

    def _per_tensor_rel(self, a: dict, b: dict) -> dict:
        """{name: max |a - b| / max |b|} (fp32)."""
        return {n: float((a[n].float() - b[n].float()).abs().max())
                / max(float(b[n].float().abs().max()), 1e-30) for n in b}

    def _train_microbatches(self, params, cfg) -> dict:
        """``microbatches`` 2 against 1 on one batch from ``params``, and
        both against an fp32 witness: the same weights upcast to fp32
        through attn_impl xla (no kernel), the whole batch at once.  Gates:
        loss and grad norm of 1 against 2 (MB_LOSS_RTOL, MB_GNORM_RTOL); per
        tensor, the gradient each step hands the optimizer against the
        other's (MB_GRAD_RTOL) and against the witness's
        (WITNESS_GRAD_RTOL), each over its tensor's max |value|; the
        2-microbatch gradient exactly the fp32 mean of the halves' own.
        Control: the embedding gradient of the plain lookup
        (``table[tokens]``, whose backward adds a token's repeats in bf16)
        must miss the witness gate.  ``params`` end updated."""
        import copy

        torch = self.torch
        from repro_torch.models import transformer as T
        from repro_torch.train import optimizer as opt
        from repro_torch.train.train_step import lm_loss, make_train_step

        named = dict(params.named_parameters())
        batch = self._train_batch(cfg, 0)
        wit = copy.deepcopy(params).float()
        wnamed = dict(wit.named_parameters())
        loss, _ = lm_loss(wit, cfg.replace(dtype="float32", attn_impl="xla"),
                          batch)
        witness = dict(zip(wnamed, torch.autograd.grad(
            loss, list(wnamed.values()))))
        witness_loss = float(loss.detach())
        del wit, wnamed, loss
        self._free()
        rows = TRAIN_BATCH // TRAIN_MICROBATCHES
        halves = []
        for i in range(TRAIN_MICROBATCHES):
            loss, _ = lm_loss(params, cfg, {k: v[i * rows:(i + 1) * rows]
                                            for k, v in batch.items()})
            halves.append(torch.autograd.grad(loss, list(named.values())))
        mean = {n: (a.float() + b.float()) * 0.5
                for n, a, b in zip(named, *halves)}
        del halves, loss
        real = T._embed
        T._embed = lambda p, c, t: p.embed[t]
        try:
            loss, _ = lm_loss(params, cfg, batch)
            plain = torch.autograd.grad(loss, [params.embed])[0]
        finally:
            T._embed = real
        control = self._per_tensor_rel({"embed": plain},
                                       {"embed": witness["embed"]})["embed"]
        del plain, loss
        host = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
        out = {}
        for n in (1, 2):
            with torch.no_grad():
                for name, p in named.items():
                    p.copy_(host[name])
            with self._timed_optimizer(keep_grads=True) as (_, grads):
                m = make_train_step(cfg, self._train_tcfg(n))(
                    params, opt.init_state(params), batch)[2]
            out[n] = ({k: float(v) for k, v in m.items()}, grads[0])
        exact = all(torch.equal(out[2][1][n], mean[n]) for n in mean)
        rel = {"1_vs_2": self._per_tensor_rel(out[1][1], out[2][1]),
               "1_vs_witness": self._per_tensor_rel(out[1][1], witness),
               "2_vs_witness": self._per_tensor_rel(out[2][1], witness)}
        m1, m2 = out[1][0], out[2][0]
        loss_rel = abs(m2["loss"] - m1["loss"]) / abs(m1["loss"])
        gnorm_rel = abs(m2["grad_norm"] - m1["grad_norm"]) / m1["grad_norm"]
        dtypes = {n: sorted({str(g.dtype) for g in out[n][1].values()})
                  for n in out}
        del host, out, mean, witness
        self._free()
        check(exact, "microbatches 2: the optimizer's gradient is not the "
              "fp32 mean of the halves' own gradients")
        check(dtypes == {1: ["torch.bfloat16"], 2: ["torch.float32"]},
              f"gradient dtypes {dtypes}")
        check(loss_rel <= MB_LOSS_RTOL, f"microbatches 2 vs 1: loss {loss_rel}")
        check(gnorm_rel <= MB_GNORM_RTOL, f"microbatches 2 vs 1: grad norm "
              f"{gnorm_rel}")
        worst = {k: sorted(r.items(), key=lambda kv: kv[1], reverse=True)[:5]
                 for k, r in rel.items()}
        limits = {"1_vs_2": MB_GRAD_RTOL, "1_vs_witness": WITNESS_GRAD_RTOL,
                  "2_vs_witness": WITNESS_GRAD_RTOL}
        for k, lim in limits.items():
            check(worst[k][0][1] <= lim, f"microbatch gradients {k}: "
                  f"{worst[k]} over {lim}")
        check(control > WITNESS_GRAD_RTOL, f"the plain lookup's embedding "
              f"gradient passed the witness gate ({control})")
        return {"layers": cfg.n_layers, "fp32_mean_of_halves_bitwise": exact,
                "grad_dtypes": dtypes, "loss_rel": loss_rel,
                "grad_norm_rel": gnorm_rel, "loss_rtol": MB_LOSS_RTOL,
                "grad_norm_rtol": MB_GNORM_RTOL, "witness_loss": witness_loss,
                "loss_1": m1["loss"], "per_tensor_worst": worst,
                "per_tensor_embed": {k: r["embed"] for k, r in rel.items()},
                "per_tensor_rtol": limits,
                "control_plain_lookup_embed_vs_witness": control}

    def _train_remat(self, params, cfg) -> dict:
        """``remat_policy`` "full" against "none" on one batch from
        ``params``: loss and every gradient (REMAT_LOSS_RTOL,
        REMAT_GRAD_RTOL), sm90 launches (twice per layer under "full"),
        peak memory of each."""
        torch, AK = self.torch, self.AK
        from repro_torch.train.train_step import lm_loss

        named = dict(params.named_parameters())
        batch = self._train_batch(cfg, 1)
        out = {}
        for policy in ("full", "none"):
            self._free()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            n0 = AK.ATTN_SM90_LAUNCHES
            t0 = time.perf_counter()
            loss, _ = lm_loss(params, cfg.replace(remat_policy=policy), batch)
            grads = torch.autograd.grad(loss, list(named.values()))
            self.sync()
            out[policy] = {
                "loss": float(loss.detach()),
                "seconds": time.perf_counter() - t0,
                "sm90_launches": AK.ATTN_SM90_LAUNCHES - n0,
                "peak_extra_gb": (torch.cuda.max_memory_allocated() - base)
                / 1e9, "grads": dict(zip(named, grads))}
            del loss, grads
        loss_rel = abs(out["full"]["loss"] - out["none"]["loss"]) \
            / abs(out["none"]["loss"])
        grad_rel = self._grads_rel(out["full"]["grads"], out["none"]["grads"])
        bitwise = out["full"]["loss"] == out["none"]["loss"] and all(
            torch.equal(out["full"]["grads"][n], out["none"]["grads"][n])
            for n in named)
        check(loss_rel <= REMAT_LOSS_RTOL and grad_rel <= REMAT_GRAD_RTOL,
              f"remat full vs none: loss {loss_rel}, grads {grad_rel}")
        want = {"full": 2 * cfg.n_layers, "none": cfg.n_layers}
        check(all(out[k]["sm90_launches"] == want[k] for k in want),
              f"remat launches {[out[k]['sm90_launches'] for k in want]}")
        for k in out:
            del out[k]["grads"]
        del named
        self._free()
        return {"layers": cfg.n_layers, **out, "loss_rel": loss_rel,
                "grad_rel": grad_rel, "bitwise_equal": bitwise,
                "loss_rtol": REMAT_LOSS_RTOL, "grad_rtol": REMAT_GRAD_RTOL}

    def _train_gates(self, cfg) -> dict:
        """Remat, then microbatches, on one set of weights."""
        params = self._train_params(cfg)
        for p in params.parameters():
            p.requires_grad_(True)
        out = {"remat_full_vs_none": self._train_remat(params, cfg),
               "microbatches_2_vs_1": self._train_microbatches(params, cfg)}
        del params
        self._free()
        return out

    def _train_restart(self, cfg) -> dict:
        """At CKPT_LAYERS layers: 5 steps uninterrupted; 3 steps, ``save``,
        ``restore`` into weights of another seed, 2 more steps; and a
        ResilientLoop over 5 steps checkpointing every 3 with an
        InjectedFailure at step 4 (so one step is lost and replayed).  Both
        must end on the uninterrupted run's weights and optimizer state,
        bit for bit."""
        import shutil

        torch = self.torch
        from repro_torch.train import checkpoint as ckpt
        from repro_torch.train import optimizer as opt
        from repro_torch.train.fault_tolerance import (
            InjectedFailure, ResilientLoop,
        )
        from repro_torch.train.train_step import make_train_step

        root = ROOT / "build" / "train_ckpt"
        shutil.rmtree(root, ignore_errors=True)
        step = make_train_step(cfg, self._train_tcfg(1))
        batches = [self._train_batch(cfg, i, batch=1) for i in range(5)]

        def run(params, state, steps):
            for i in steps:
                params, state, _ = step(params, state, batches[i])
            return params, state

        def host(params, state):
            """(step, {name: tensor}) of the weights and both moments."""
            out = {f"params.{n}": p.detach().to("cpu", copy=True)
                   for n, p in params.named_parameters()}
            for part in ("m", "v"):
                out.update({f"{part}.{n}": t.to("cpu", copy=True)
                            for n, t in state[part].items()})
            return int(state["step"]), out

        def same(a, b) -> bool:
            return a[0] == b[0] and all(torch.equal(a[1][n], b[1][n])
                                        for n in a[1])

        p = self._train_params(cfg)
        want = host(*run(p, opt.init_state(p), range(5)))
        del p
        p = self._train_params(cfg)
        p, st = run(p, opt.init_state(p), range(3))
        t0 = time.perf_counter()
        ckpt.save(str(root / "saved"), 3, p, st)
        save_s = time.perf_counter() - t0
        npz_gb = (root / "saved" / "step_00000003" / "arrays_0.npz") \
            .stat().st_size / 1e9
        del p, st
        p = self._train_params(cfg, seed=1)
        st = opt.init_state(p)
        t0 = time.perf_counter()
        _, manifest = ckpt.restore(str(root / "saved"), 3,
                                   {"params": p, "opt_state": st})
        restore_s = time.perf_counter() - t0
        check(int(st["step"]) == 3 and manifest["dtypes"][
            "params/layers/attn/wq"] == "bfloat16", "the restored state")
        got_restore = host(*run(p, st, range(3, 5)))
        del p, st
        fails = {"armed": True}

        def hook(s):
            if s == 4 and fails["armed"]:
                fails["armed"] = False
                raise InjectedFailure("simulated host loss")

        p = self._train_params(cfg)
        loop = ResilientLoop(step_fn=step, batch_fn=lambda s: batches[s],
                             ckpt_dir=str(root / "loop"), ckpt_every=3,
                             keep=1, failure_hook=hook)
        p, st, info = loop.run(p, opt.init_state(p), 0, 5)
        got_loop = host(p, st)
        del p, st
        shutil.rmtree(root, ignore_errors=True)
        self._free()
        check(info["restores"] == 1 and info["final_step"] == 5,
              f"the loop: {info}")
        check(same(got_restore, want), "save, restore, 2 steps: not the "
              "uninterrupted run's weights and state")
        check(same(got_loop, want), "the restart loop: not the uninterrupted "
              "run's weights and state")
        return {"layers": cfg.n_layers, "save_s": save_s,
                "restore_s": restore_s, "npz_gb": npz_gb,
                "restore_then_steps_bitwise": True,
                "loop_restores": info["restores"], "loop_bitwise": True}

    def train(self) -> None:
        t_phase = time.perf_counter()
        self._free()
        cfg = self._train_cfg()
        main = self._train_main(cfg)
        grads = self._train_attention_grads()
        shape_row = self._attn_shape_row(1, cfg, TRAIN_SEQ, 22, TRAIN_ARCH)
        self.attn_row["at_llama_train_shape"] = shape_row
        gate_cfg = self._train_cfg(TRAIN_GATE_LAYERS)
        self.train_step_s = main["step_s_median_after_first"]
        emit({"phase": "train", "card": self.card, "arch": TRAIN_ARCH,
              "dtype": cfg.dtype, "attn_impl": cfg.attn_impl,
              "remat_policy": cfg.remat_policy, "batch": TRAIN_BATCH,
              "seq": TRAIN_SEQ, "microbatches": TRAIN_MICROBATCHES, **main,
              "attention_gradients": grads,
              "tri_attn_at_train_shape": shape_row,
              **self._train_gates(gate_cfg),
              "checkpoint_restart": self._train_restart(
                  self._train_cfg(CKPT_LAYERS)),
              "phase_s": time.perf_counter() - t_phase})

    def train_entry(self) -> None:
        """``python -m repro_torch.launch.train`` as a user runs it."""
        import os

        self._free()
        argv = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                TRAIN_ARCH, "--steps", "3", "--batch", str(TRAIN_BATCH),
                "--seq", str(TRAIN_SEQ), "--microbatches",
                str(TRAIN_MICROBATCHES), "--log-every", "1", "--ckpt-dir",
                str(ROOT / "build" / "train_entry")]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0, f"launch.train exited {proc.returncode}: "
              f"{proc.stderr.strip().splitlines()[-5:]}")
        check(any(f"params={TRAIN_PARAMS:,}" in ln for ln in lines)
              and any(ln.startswith("final metrics:") for ln in lines),
              f"launch.train printed {lines}")
        self.train_entry_final = _final_metrics(lines)
        emit({"phase": "train_entry", "card": self.card,
              "command": "python -m repro_torch.launch.train "
              + " ".join(argv[3:]), "rc": proc.returncode, "seconds": wall,
              "stdout": lines})

    def _sharded_step(self, cfg, mesh) -> dict:
        """The train phase's first step twice from seed-0 weights: on the
        single-device step, then, from the same weights put back and laid
        out on ``mesh``, on the sharded step (a split step: on one rank it
        gathers nothing and splits nothing) under the profiler (the main
        path's counts reset just before it); then one more sharded step,
        timed.  Each step's peak device memory is read from a reset; the
        embedding gradient of the first is kept on the host for the
        compressed all-reduce."""
        torch, AK = self.torch, self.AK
        from torch.distributed.tensor import DTensor
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.train import optimizer as opt
        from repro_torch.train import sharded
        from repro_torch.train.train_step import make_train_step

        tcfg = self._train_tcfg()
        batches = [self._train_batch(cfg, i) for i in range(2)]
        params = self._train_params(cfg)
        host = {n: p.detach().to("cpu", copy=True)
                for n, p in params.named_parameters()}
        state = opt.init_state(params)
        self.sync()
        torch.cuda.reset_peak_memory_stats()
        with self._timed_optimizer(keep_grads=True) as (_, grads):
            params, state, m1 = make_train_step(cfg, tcfg)(
                params, state, batches[0])
        self.sync()
        single_peak = torch.cuda.max_memory_allocated() / 1e9
        embed_grad = grads[0]["embed"].cpu()
        del grads
        single = {k: float(v) for k, v in m1.items()}
        want = {n: p.detach().to("cpu", copy=True)
                for n, p in params.named_parameters()}
        del state
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(host[n])
        del host
        self._free()
        torch.cuda.reset_peak_memory_stats()
        params, state = sharded.shard_(params, cfg, mesh)
        check(all(isinstance(p, DTensor) and p.device.type == "cuda"
                  for p in params.parameters())
              and all(isinstance(t, DTensor) and t.device.type == "cuda"
                      for part in ("m", "v") for t in state[part].values()),
              "the sharded state is not DTensors on the card")
        step = sharded.make_sharded_train_step(cfg, tcfg, mesh)
        self.sync()
        self.reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, state, m2 = step(params, state, batches[0])
            self.sync()
        counts = self.counts()
        traced = sum(e.count for e in prof.key_averages()
                     if e.device_type.name == "CUDA"
                     and "ta_sm90_kernel" in e.key)
        del prof
        self._add_sm90("sharded_train", counts)
        got = {k: float(v) for k, v in m2.items()}
        rel = {k: abs(got[k] - single[k]) / max(abs(single[k]), 1e-30)
               for k in single}
        param_rel, bitwise = 0.0, True
        for n, p in params.named_parameters():
            a = p.to_local().detach().cpu()
            if torch.equal(a, want[n]):
                continue
            bitwise = False
            b = want[n].float()
            param_rel = max(param_rel, float((a.float() - b).abs().max())
                            / max(float(b.abs().max()), 1e-30))
        del want
        check(counts["tri_attn_sm90"] == TRAIN_LAUNCHES_PER_STEP
              and counts["tri_attn"] == counts["tri_attn_sm90"]
              and traced == TRAIN_LAUNCHES_PER_STEP,
              f"sharded step: sm90 launches {counts}, traced {traced}, want "
              f"{TRAIN_LAUNCHES_PER_STEP}")
        check(all(r <= SHARDED_RTOL for r in rel.values())
              and param_rel <= SHARDED_RTOL,
              f"sharded step against the single-device step: metrics {rel},"
              f" parameters {param_rel}")
        t0 = time.perf_counter()
        params, state, m3 = step(params, state, batches[1])
        self.sync()
        step_s = time.perf_counter() - t0
        check(all(math.isfinite(float(v)) for v in m3.values())
              and int(state["step"]) == 2, f"the second sharded step: {m3}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(peak <= single_peak + SHARDED_PEAK_SLACK_GB,
              f"sharded step peak {peak:.2f} GB against the single-device "
              f"step's {single_peak:.2f} GB")
        del params, state, batches
        self._free()
        return {"single_device": single, "sharded": got, "metric_rel": rel,
                "param_rel_max": param_rel, "params_bitwise": bitwise,
                "rtol": SHARDED_RTOL, "main_path": counts,
                "sm90_kernels_traced": traced,
                "second_step_s": step_s,
                "train_phase_step_s": getattr(self, "train_step_s", None),
                "peak_gb": peak, "single_device_peak_gb": single_peak,
                "peak_over_single_device_gb": peak - single_peak,
                "embed_grad": embed_grad}

    def _compressed(self, g, group) -> dict:
        """compressed_psum_mean on one leaf over the 1-rank group against
        the formula in torch (quantize against the chunk's absmax / 127,
        round half to even, sum, dequantize over the rank count), timed."""
        torch = self.torch
        from repro_torch.distribution import compression as comp

        out = comp.compressed_psum_mean_leaf(g, group)
        flat = torch.nn.functional.pad(
            g.float().reshape(-1), (0, (-g.numel()) % comp.CHUNK)
        ).reshape(-1, comp.CHUNK)
        scale = flat.abs().amax(dim=1, keepdim=True) * (1.0 / 127.0)
        q = torch.round(flat / torch.clamp(scale, min=1e-12))
        want = (q * scale).reshape(-1)[:g.numel()].reshape(g.shape)
        err = float((out - want).abs().max())
        bound = comp.quantization_error_bound(g)
        vs_grad = float((out - g).abs().max())
        check(err == 0.0 and vs_grad <= bound * (1 + 1e-6),
              f"compressed_psum_mean: {err} from the formula, {vs_grad} from"
              f" the gradient (bound {bound})")
        ms = self.time_ms(lambda: comp.compressed_psum_mean_leaf(g, group))
        return {"leaf": "embed grad", "shape": list(g.shape),
                "dtype": str(g.dtype), "max_abs_err_vs_formula": err,
                "max_abs_err_vs_grad": vs_grad, "error_bound": bound,
                "ms": ms}

    def _sharded_entry(self) -> dict:
        """train_entry's command under torch.distributed.run, one process:
        the sharded step over a (1, 1) NCCL mesh."""
        import os

        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "1", "-m", "repro_torch.launch.train",
                "--arch", TRAIN_ARCH, "--steps", "3", "--batch",
                str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--microbatches",
                str(TRAIN_MICROBATCHES), "--log-every", "1", "--ckpt-dir",
                str(ROOT / "build" / "sharded_entry")]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.perf_counter()
        proc = subprocess.run(argv, env=env, cwd=ROOT, capture_output=True,
                              text=True, timeout=600)
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        check(proc.returncode == 0, f"torch.distributed.run launch.train "
              f"exited {proc.returncode}: "
              f"{proc.stderr.strip().splitlines()[-8:]}")
        check(any(f"params={TRAIN_PARAMS:,}" in ln
                  and "mesh={'data': 1, 'model': 1}" in ln for ln in lines),
              f"launch.train under torch.distributed.run printed {lines}")
        got, want = _final_metrics(lines), self.train_entry_final
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in want}
        check(set(got) == set(want)
              and all(r <= SHARDED_ENTRY_RTOL for r in rel.values()),
              f"sharded entry point against train_entry: {rel}")
        return {"command": "python -m torch.distributed.run "
                + " ".join(argv[3:]), "rc": proc.returncode,
                "seconds": wall, "final": got, "rel_to_train_entry": rel,
                "rtol": SHARDED_ENTRY_RTOL, "stdout": lines}

    @contextlib.contextmanager
    def _one_rank_mesh(self):
        """A 1-rank NCCL group on a TCPStore at 127.0.0.1 and
        make_local_mesh()'s (1, 1) mesh over it, for the block."""
        from datetime import timedelta

        import torch.distributed as dist

        from repro_torch.launch.mesh import make_local_mesh

        store = dist.TCPStore("127.0.0.1", 0, 1, True,
                              timeout=timedelta(seconds=120))
        dist.init_process_group("nccl", store=store, rank=0, world_size=1,
                                device_id=self.torch.device("cuda", 0))
        try:
            yield make_local_mesh()
        finally:
            dist.destroy_process_group()

    def sharded_train(self) -> None:
        """The sharded step on the card: in process over a 1-rank NCCL
        group, then the launcher under torch.distributed.run."""
        import torch.distributed as dist

        t_phase = time.perf_counter()
        self._free()
        with self._one_rank_mesh() as mesh:
            backend = dist.get_backend()
            main = self._sharded_step(self._train_cfg(), mesh)
            compressed = self._compressed(main.pop("embed_grad").cuda(),
                                          mesh.get_group("data"))
        self._free()
        emit({"phase": "sharded_train", "card": self.card, "arch": TRAIN_ARCH,
              "mesh": {"data": 1, "model": 1}, "backend": backend,
              "limit": "one card: every collective is a 1-rank NCCL "
              "collective; multi-rank numerics are held on the CPU "
              "(tests/test_torch_distributed.py)",
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "microbatches": TRAIN_MICROBATCHES, **main,
              "compressed_psum_mean": compressed,
              "entry_point": self._sharded_entry(),
              "phase_s": time.perf_counter() - t_phase})

    def sharded_rwkv(self) -> None:
        """rwkv6-3b's training step on the card, single-device and sharded
        over a 1-rank NCCL group from the same weights and batch: loss,
        grad norm and every parameter bitwise (or within 1e-6 relative);
        the wkv calls of the sharded step counted by the wrapper against
        the code's count (a call per layer in the forward and one in its
        remat recompute); a second sharded step timed, the peak memory; a
        third under the profiler, its calls by the wrapper and each of
        their three kernels in the trace."""
        torch, WK = self.torch, self.WK
        from torch.distributed.tensor import DTensor
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.configs import get_config
        from repro_torch.models import transformer as T
        from repro_torch.train import optimizer as opt
        from repro_torch.train import sharded
        from repro_torch.train.data import DataConfig, SyntheticLM
        from repro_torch.train.train_step import TrainConfig, make_train_step

        t_phase = time.perf_counter()
        self._free()
        cfg = get_config(RWKV_ARCH).replace(max_seq=RWKV_SEQ,
                                            n_layers=SHARDED_RWKV_LAYERS)
        check(cfg.remat and cfg.remat_policy == "full"
              and cfg.dtype == "bfloat16", f"{RWKV_ARCH}: {cfg.remat_policy}"
              f" {cfg.dtype}")
        tcfg = TrainConfig(optimizer=opt.OptimizerConfig(
            lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS),
            microbatches=1)
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=RWKV_SEQ,
                                      global_batch=SHARDED_RWKV_BATCH))
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in data.batch_at(i).items()} for i in range(2)]
        params = T.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
        host = {n: p.detach().to("cpu", copy=True)
                for n, p in params.named_parameters()}
        state = opt.init_state(params)
        self.sync()
        self.reset_counts()
        t0 = time.perf_counter()
        params, state, m1 = make_train_step(cfg, tcfg)(params, state,
                                                       batches[0])
        self.sync()
        single_s = time.perf_counter() - t0
        single_calls = self.counts()["wkv"]
        single = {k: float(v) for k, v in m1.items()}
        want = {n: p.detach().to("cpu", copy=True)
                for n, p in params.named_parameters()}
        del state
        with torch.no_grad():
            for n, p in params.named_parameters():
                p.copy_(host[n])
        del host
        self._free()
        with self._one_rank_mesh() as mesh:
            torch.cuda.reset_peak_memory_stats()
            params, state = sharded.shard_(params, cfg, mesh)
            check(all(isinstance(p, DTensor) for p in params.parameters()),
                  "the sharded weights are not DTensors")
            step = sharded.make_sharded_train_step(cfg, tcfg, mesh)
            self.sync()
            self.reset_counts()
            params, state, m2 = step(params, state, batches[0])
            self.sync()
            counts = self.counts()
            got = {k: float(v) for k, v in m2.items()}
            rel = {k: abs(got[k] - single[k]) / max(abs(single[k]), 1e-30)
                   for k in single}
            param_rel, bitwise = 0.0, True
            for n, p in params.named_parameters():
                a = p.to_local().detach().cpu()
                if torch.equal(a, want[n]):
                    continue
                bitwise = False
                b = want[n].float()
                param_rel = max(param_rel,
                                float((a.float() - b).abs().max())
                                / max(float(b.abs().max()), 1e-30))
            del want
            check(all(r <= SHARDED_RTOL for r in rel.values())
                  and param_rel <= SHARDED_RTOL,
                  f"sharded rwkv step against the single-device step: "
                  f"metrics {rel}, parameters {param_rel}")
            t0 = time.perf_counter()
            params, state, m3 = step(params, state, batches[1])
            self.sync()
            step_s = time.perf_counter() - t0
            check(all(math.isfinite(float(v)) for v in m3.values())
                  and int(state["step"]) == 2,
                  f"the second sharded rwkv step: {m3}")
            # the trace last: a profiled step slows the launches after it
            self.reset_counts()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                params, state, _ = step(params, state, batches[0])
                self.sync()
            profiled = self.counts()["wkv"], WK.WKV_KERNELS
            traced = {name: sum(e.count for e in prof.key_averages()
                                if e.device_type.name == "CUDA"
                                and name in e.key)
                      for name in WKV_KERNEL_NAMES}
            del prof
            calls = 2 * cfg.n_layers     # forward and remat recompute
            check(single_calls == calls and counts["wkv"] == calls
                  and profiled == (calls, 3 * calls)
                  and all(n == calls for n in traced.values())
                  and all(n == 0 for k, n in counts.items() if k != "wkv"),
                  f"wkv calls: single-device {single_calls}, sharded "
                  f"{counts}, profiled step {profiled} (calls, kernels), "
                  f"traced {traced}; want {calls} calls of 3 kernels")
            peak = torch.cuda.max_memory_allocated() / 1e9
            del params, state, batches
        self.launches["wkv"] = self.launches.get("wkv", 0) + counts["wkv"]
        self.wkv_paths["sharded_rwkv"] = counts["wkv"]
        self._free()
        emit({"phase": "sharded_rwkv", "card": self.card, "arch": RWKV_ARCH,
              "layers": cfg.n_layers,
              "cut": None if cfg.n_layers == RWKV_LAYERS
              else f"{cfg.n_layers} of {RWKV_LAYERS} layers",
              "mesh": {"data": 1, "model": 1},
              "batch": SHARDED_RWKV_BATCH, "seq": RWKV_SEQ,
              "microbatches": 1, "dtype": cfg.dtype,
              "remat": cfg.remat_policy, "single_device": single,
              "single_device_step_s": single_s, "sharded": got,
              "metric_rel": rel, "param_rel_max": param_rel,
              "params_bitwise": bitwise, "rtol": SHARDED_RTOL,
              "main_path": counts,
              "profiled_step_wkv_calls_kernels": list(profiled),
              "wkv_kernels_traced": traced, "wkv_calls_want": calls,
              "second_step_s": step_s, "peak_gb": peak,
              "phase_s": time.perf_counter() - t_phase})

    def _split_decode_case(self, name, arch, over, rows, t, nb) -> dict:
        """One attention layer of ``arch`` at full width, one new token
        against a cache of ``t`` positions filled from a seeded generator
        up to a position inside a middle block: the whole-cache path, then
        the cache cut into ``nb`` blocks, each attended as one rank of a
        split decode would attend it (``tp.seq_block`` and ``tp.seq_stack``
        stood in for by this block and a stack in this process), and the
        partials combined by the same ``combine_partials``."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.distribution import tensor_parallel as tp
        from repro_torch.models import attention as attn
        from repro_torch.models import transformer as T

        cfg = get_config(arch).replace(max_seq=t, **over)
        dtype, dev = T._dtype(cfg), torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(SPLIT_DECODE_SEED)
        mla = cfg.attention_type == "mla"
        if mla:
            layer = attn.mla_init(gen, cfg, dtype, dev)
            cache = attn.mla_cache_init(cfg, rows, t, dtype, dev)
            apply = attn.mla_apply
        else:
            layer = attn.gqa_init(gen, cfg, dtype, dev)
            cache = attn.gqa_cache_init(cfg, rows, t, dtype, dev)
            apply = attn.gqa_apply
        tl = t // nb
        pos = (nb // 2) * tl + tl // 2 + 3        # inside block nb // 2
        leaves = [k for k in cache if k != "idx"]
        for k in leaves:
            fill = cache[k][:, :pos]
            if fill.dtype == torch.int8:
                fill.copy_(torch.randint(-127, 128, fill.shape, device=dev,
                                         generator=gen, dtype=torch.int8))
            elif k.endswith("_scale"):
                fill.copy_(torch.rand(fill.shape, device=dev, generator=gen)
                           * 0.02 + 0.005)
            else:
                fill.copy_(torch.randn(fill.shape, device=dev, generator=gen,
                                       dtype=torch.float32))
        cache["idx"] = pos
        x = torch.randn((rows, 1, cfg.d_model), device=dev, generator=gen,
                        dtype=torch.float32).to(dtype)
        positions = torch.full((rows, 1), pos, dtype=torch.int64, device=dev)

        def copy():
            return {k: (v.clone() if k != "idx" else v)
                    for k, v in cache.items()}

        whole, blocked = copy(), copy()

        def block(b):
            return {k: (v[:, b * tl:(b + 1) * tl] if k != "idx" else v)
                    for k, v in blocked.items()}

        with torch.inference_mode():
            want, _ = apply(layer, cfg, x, positions=positions, cache=whole)
            whole_ms = self.time_ms(lambda: apply(
                layer, cfg, x, positions=positions, cache=whole))
        real = tp.seq_block, tp.seq_stack
        at, parts = [0], []

        def own(packed, blk):
            parts.append(packed)
            return packed[None]

        try:
            tp.seq_block = lambda n: tp.SeqBlock(at[0] * tl, tl, ())
            tp.seq_stack = own
            with torch.inference_mode():
                for b in range(nb):
                    at[0] = b
                    apply(layer, cfg, x, positions=positions, cache=block(b))
                changed = [b for b in range(nb) if any(
                    not torch.equal(blocked[k][:, b * tl:(b + 1) * tl],
                                    cache[k][:, b * tl:(b + 1) * tl])
                    for k in leaves)]
                landed = all(torch.equal(blocked[k], whole[k])
                             for k in leaves)
                stack = torch.stack(parts)
                tp.seq_stack = lambda packed, blk: stack
                at[0] = 0
                got, _ = apply(layer, cfg, x, positions=positions,
                               cache=block(0))
                # control: the block holding the new row normalised alone
                mid = stack[nb // 2][None]
                tp.seq_stack = lambda packed, blk: mid
                ctrl, _ = apply(layer, cfg, x, positions=positions,
                                cache=block(0))
                at[0] = nb // 2
                tp.seq_stack = lambda packed, blk: packed[None]
                block_ms = self.time_ms(lambda: apply(
                    layer, cfg, x, positions=positions,
                    cache=block(nb // 2)))
                combine_ms = self.time_ms(lambda: attn.combine_partials(
                    stack[..., 0], stack[..., 1], stack[..., 2:]))
        finally:
            tp.seq_block, tp.seq_stack = real
        rel, ctrl_rel = _rel(got, want), _rel(ctrl, want)
        check(changed == [nb // 2] and landed,
              f"split_decode {name}: the new row landed in blocks {changed}"
              f" (want [{nb // 2}]), bitwise as the whole cache's: {landed}")
        check(rel <= SPLIT_DECODE_RTOL, f"split_decode {name}: blocked "
              f"against whole {rel:.3e} > {SPLIT_DECODE_RTOL}")
        check(ctrl_rel > SPLIT_DECODE_RTOL, f"split_decode {name}: the "
              f"control (one block normalised alone) passed at "
              f"{ctrl_rel:.3e}")
        return {"case": name, "arch": arch, "overrides": over,
                "rows": rows, "cache_len": t, "blocks": nb,
                "block_len": tl, "position": pos,
                "cache_gb": sum(cache[k].numel() * cache[k].element_size()
                                for k in leaves) / 1e9,
                "rel_err_of_max": rel, "control_rel_err": ctrl_rel,
                "row_landed_in_block": changed, "row_bitwise": landed,
                "whole_ms": whole_ms, "block_ms": block_ms,
                "combine_ms": combine_ms}

    def split_decode(self) -> None:
        """Decode over a cache split along kv_seq, one layer at full width
        on the card (SPLIT_DECODE_CASES): the blocked path against the
        whole-cache path within SPLIT_DECODE_RTOL of max |out|, the new row
        in exactly one block, bitwise the whole cache's; the whole-cache
        call's time beside one block's call (one rank's attention, no
        collective) and the combine's, not gated.  The split across ranks
        is held on the CPU (tests/test_torch_distributed_decode.py)."""
        t_phase = time.perf_counter()
        self._free()
        cases = [self._split_decode_case(*c) for c in SPLIT_DECODE_CASES]
        self._free()
        emit({"phase": "split_decode", "card": self.card,
              "rtol": SPLIT_DECODE_RTOL, "cases": cases,
              "phase_s": time.perf_counter() - t_phase,
              "note": "ms: medians of single calls (CUDA events); a block "
                      "call is one rank's attention without its "
                      "all-gathers"})

    def train_probe(self) -> None:
        """Where the main path's loss goes over its TRAIN_STEPS steps, from
        the same seed-0 weights and batches each time: at full depth in bf16
        at each of PROBE_LRS; at TRAIN_GATE_LAYERS layers at 3e-4 in bf16
        (pallas_mapped) and in fp32 (the same weights upcast, xla).  Loss
        and grad norm a step; printed, not gated."""
        from repro_torch.train import optimizer as opt
        from repro_torch.train.train_step import make_train_step

        def steps(cfg, lr, fp32=False):
            params = self._train_params(cfg)
            if fp32:
                params = params.float()
                cfg = cfg.replace(dtype="float32", attn_impl="xla")
            step = make_train_step(cfg, self._train_tcfg(lr=lr))
            state, rows = opt.init_state(params), []
            for i in range(TRAIN_STEPS):
                params, state, m = step(params, state,
                                        self._train_batch(cfg, i))
                rows.append({k: float(m[k]) for k in ("loss", "grad_norm")})
            del params, state
            self._free()
            return rows

        t_phase = time.perf_counter()
        full, cut = self._train_cfg(), self._train_cfg(TRAIN_GATE_LAYERS)
        emit({"phase": "train_probe", "card": self.card, "arch": TRAIN_ARCH,
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "microbatches": TRAIN_MICROBATCHES, "warmup_steps": 2,
              "full_depth_bf16_by_lr": {str(lr): steps(full, lr)
                                        for lr in PROBE_LRS},
              "layers": TRAIN_GATE_LAYERS,
              "cut_bf16": steps(cut, 3e-4),
              "cut_fp32_xla": steps(cut, 3e-4, fp32=True),
              "phase_s": time.perf_counter() - t_phase})

    def kernels_line(self) -> None:
        """One row per kernel.  Map rows: launches are paper_scale's main
        path (one mapped launch per domain at N = 5e8, one membership launch
        per BB box), the serve phase's (every launch its frontends and its
        split sweep made) and the examples'; ms, plain_ms and bound_ms are
        per launch over paper_scale's calls.  tri_attn has a row per route:
        sm90 (the LM path, timed at the LM shape) and simt (the block-64
        forward and the examples, timed at the block-64 forward's shape).
        ``launches_by_path`` splits each row's launches by main path."""
        src = "src/repro_torch/kernels/domain_map/csrc/"
        replaces = {"map_kernel": "src/repro/kernels/domain_map/kernel.py:53",
                    "membership_kernel":
                        "src/repro/kernels/domain_map/kernel.py:65"}
        rows = [
            {"name": name, "route": "cuda", "source": f"{src}{name}.cu",
             "replaces": replaces[name],
             "launches": self.launches[name],
             "max_abs_err": self.max_err[name],
             "ms": t["ms"] / t["n"], "plain_ms": t["plain_ms"] / t["n"],
             "bound_ms": t["bytes"] / t["n"] / HBM_BYTES_PER_S * 1e3,
             "bound_by": "bytes", "library_ms": None,
             "per_launch_over": t["n"], "launches_by_path": self.paths[name]}
            for name, t in self.totals.items()]
        attn = "src/repro_torch/kernels/tri_attn/csrc/"
        rows.append({
            "name": "tri_attn", "route": "cuda", "attn_route": "sm90",
            "source": f"{attn}tri_attn_sm90.cuh",
            "replaces": "src/repro/kernels/tri_attn/kernel.py:54",
            "launches": self.launches["tri_attn_sm90"],
            "launches_by_path": self.sm90_paths, **self.attn_row})
        rows.append({
            "name": "tri_attn_simt", "route": "cuda", "attn_route": "simt",
            "source": f"{attn}tri_attn.cu",
            "replaces": "src/repro/kernels/tri_attn/kernel.py:54",
            "launches": self.launches["tri_attn_simt"],
            "launches_by_path": self.paths["tri_attn_simt"],
            **self.attn_simt_row})
        rows.append({
            "name": "wkv", "route": "cuda",
            "source": "src/repro_torch/kernels/wkv/csrc/wkv.cu",
            "replaces": "src/repro/kernels/wkv/kernel.py:25",
            "launches": self.launches["wkv"],
            "launches_by_path": self.wkv_paths, **self.wkv_row})
        for r in rows:
            check(r["launches"] > 0, f"{r['name']} was never launched on its"
                  f" main path")
        emit({"kernels": rows})


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # full fp32 products everywhere (the plain versions are the yardstick)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smoke = Smoke()
    kind = smoke.device()
    smoke.build()
    if "--index-widths" in sys.argv[1:]:
        smoke.index_widths()
        return 0
    if "--train-probe" in sys.argv[1:]:
        smoke.train_probe()
        return 0
    if "--sharded-train" in sys.argv[1:]:
        smoke.train_entry()
        smoke.sharded_train()
        smoke.sharded_rwkv()
        smoke.split_decode()
        return 0
    if "--sharded-sweep" in sys.argv[1:]:
        emit({"phase": "sharded_sweep", "card": smoke.card,
              **smoke.sharded_sweep()})
        return 0
    if "--dryrun-only" in sys.argv[1:]:
        smoke.dryrun_arch()
        return 0
    if "--examples-only" in sys.argv[1:]:
        smoke.examples()
        return 0
    smoke.kernels()
    smoke.paper_scale()
    smoke.evaluate()
    smoke.derive()
    smoke.serve()
    smoke.examples()
    smoke.attention()
    smoke.lm_forward()
    smoke.xla_mapped()
    smoke.trace_split()
    smoke.lm_generate()
    smoke.vlm_forward()
    smoke.vlm_generate()
    smoke.whisper_forward()
    smoke.whisper_generate()
    smoke.engine_serve()
    smoke.wkv()
    smoke.rwkv_forward()
    smoke.rwkv_generate()
    smoke.moe_forward()
    smoke.moe_generate()
    smoke.hybrid_forward()
    smoke.hybrid_generate()
    smoke.mla_forward()
    smoke.mla_generate()
    smoke.start_dryruns()
    smoke.train()
    smoke.train_entry()
    smoke.sharded_train()
    smoke.sharded_rwkv()
    smoke.split_decode()
    smoke.dryrun_arch()
    smoke.kernels_line()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
