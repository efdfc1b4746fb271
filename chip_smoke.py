#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the CUDA kernels from `src/repro_torch/kernels/csrc/` and log
     the registers, spills and shared memory of every instantiation of the
     kernels (the three flash kernels, the PIM MAC, the syndrome scan at
     each check tile, gf_matmul, fbp_cn at each field, and
     attend_protected's two kernels);
  2. hold every kernel against its plain PyTorch version on the card, at
     the main path's shapes, and time both: the integer kernels and FBP
     with exact equality (the scan also at the decoder's 256-word check
     and a ragged tail of it, a paged-store page, n = 40, C = 343 and p =
     5 and 7, and with FBP at a PIM serving projection's words at the
     prefill and at a decode step), `attend_protected` to a few bf16 ulps (rtol 2^-7, atol
     2^-10) and bitwise repeatable at the serving shape (paper-pim-2b heads,
     wl160_r08 pages, NP 32, hot page), hot-only (NP 0), with softcaps of
     50 and of 2 (one that bites on logits of about N(0, 1)), with
     per-slot sub-pages (S = B), at NP 1, at NP 40 (page ranges of
     unequal length), with rows that have no valid token in some ranges
     or in all (with and without the hot page), at NP 256 (4,096
     tokens), and at phase 16's decode reads at head dim 128 (olmoe's
     16/16 heads, jamba's 32/8); the PIM MAC also beside torch._int_mm
     (cuBLASLt s8 x s8 -> s32, its adc-0 function) and the W transpose a
     K-major operand would cost in the wrapper; gf_matmul at a 4096-word
     wl1024_r08 page and a wl160_r08 page freeze (and phase 16's olmoe
     and jamba page freezes, 6,144 and 3,072 words), beside torch.matmul
     fp32 and torch._int_mm; fbp_cn at dc 16 (p 3), p 5 and dc 26.
     Every kernel but the flash kernels also logs its device time from
     torch.profiler (from CUDA
     events around calls queued behind a sleep kernel where three
     profiled windows in a row recorded none), and all but the MAC their
     wrappers' host time a call;
  3. memory mode: a 64 MiB float32 tensor in a `ProtectedMemoryArray` on
     wl1024_r08 (writeback policy, unsharded on every host): write,
     inject uniform flips, read back exactly, inject again, scrub,
     re-scrub clean;
  4. PIM mode at the full width of the `paper-pim-2b` configuration
     (wl320_r08, n_iters 4, damping 0.3, row parallelism 64): the
     mlp_down (8192 -> 2048) and attn_o (2048 -> 2048) projections over 256
     token rows must come out of `protected_pim_matmul` with a lower
     integer error rate than the unprotected MAC;
  5. the decoder and the protected matmul on the card against their plain
     CPU run on a small input, exactly;
  6. one more corrected read of the memory-mode array under
     torch.profiler (device time by kernel, device idle share), and the
     scan over the whole store and the encode of its info words
     (491,641 x 819 x 205) against their plain versions, exactly, with
     their device times and bounds;
  7. a small protected-KV decode (reduced paper-pim-2b) on the card
     against the same model's plain CPU run, to a few bf16 ulps;
  8. protected KV-cache serving of `paper-pim-2b` at full width and full
     depth (24 layers, 1.56 B parameters from a seeded generator): 4
     requests of 512 prompt tokens through `prefill(...,
     protected_kv=ProtectedKVConfig("wl160_r08", page_tokens=16))`, then
     32 greedy `decode_step`s, run three times: clean; with
     `uniform_flip(3, 2e-5)` injected into every store right after
     prefill; and injected with `corrected=False`. The injected run must
     correct every flagged word and reproduce the clean run's tokens and
     logits exactly, and `attend_protected` must run once per layer per
     decode step in every run (the uncorrected run hands it the raw
     cells). Then one clean decode step under torch.profiler;
  9. flash prefill: phase 8's model and prompts through `prefill`, naive
     and with attn_impl="flash": flash_fwd once per layer (24), and the
     flash logits no farther than the naive ones from a prefill whose
     attention keeps its softmax in fp32; and the JAX package's own
     model-level check (reduced gemma2, flash within 0.05 of naive)
     through the kernels;
 10. reduced granite-3-2b (2 layers, d_model 128, seq 64, batch 4) under
     attn_impl="flash": 5 steps of `launch.train.run` on the card against
     the CPU from the same weights (losses within 1e-2 relative); a
     protected checkpoint of the card run, flips injected into it, an
     exact restore and a resumed run (gf_matmul, scan and FBP on the
     training path);
 11. granite-3-2b at full width and depth (40 layers, 2.53 B parameters,
     AdamW, remat, TokenPipeline at seq 4096 and batch 2) after phase 8's
     model is freed: the first batch's loss and grad norm naive against
     flash, 6 training steps (flash_fwd 80, flash_bwd_dq 40 and
     flash_bwd_dkv 40 launches per step), peak memory, one more step
     under torch.profiler (step time, busy share, each flash kernel's
     share of the busy time);
 12. PIM-protected serving, right after phase 9 on its model and prompts:
     for mlp_down and attn_o at the prefill's and a decode step's shapes,
     the MAC against its plain version and the whole protected matmul
     against the plain CPU run under the same output noise (exactly),
     then `encode_params_for_pim` on the card (layer 0's
     int8 cells exactly against the plain CPU encode of the same ternary
     weights) and prefill plus 16 greedy `decode_step`s with
     `pim_ctx=PIMContext(cfg.pim)` (mlp_down and attn_o on wl320_r08) and
     phase 8's protected KV cache, three times: fault-free; with PIM
     output errors at 2e-5 in mode "correct", which must give the
     fault-free tokens and logits bit for bit with no uncorrected word;
     and the same errors with protection off, whose logits must differ.
     Then one clean step under torch.profiler;
 14. the multi-tenant serving engine, right after phase 12 on phase 8's
     model: 8 tenants (prompts of 128, 256, 384 and 512 tokens, two of
     each, drawn with numpy from SEED) through a `ServingEngine` of 4
     slots (max_seq 544) over one shared wl160_r08 `ProtectedPagePool`
     (pages of 384 words, one slot's 16-token K or V page), 32 greedy
     tokens each, five runs: (a) clean; (b) tenant 0 alone, which must
     give (a)'s tokens for it; (c) `uniform_flip(3, 2e-5)` injected into
     the pool after step 8 with a 256-page scrub every 4 steps, which
     must give (a)'s tokens, with corrections on exactly the tenants that
     owned pages then, none left, and scrub repairs; (d) the pool cut to
     60% of (a)'s peak pages, which must preempt and still give (a)'s
     tokens, the pool drained at the end; (e) unprotected, tokens logged.
     In (a) one layer's fused read is held against its plain version at
     the run's ragged page counts and one step is profiled; in (c) a
     copy of 128 pool pages (every owner's) is scrubbed on the card and
     on the CPU, coalesced and page by page, with equal reports and
     pages (the checks' time and launches are not the runs'). It logs
     ms an engine step, decode tokens/s, TTFT by tenant, the pool's peak
     and the kernel launches a step;
 15. telemetry and the sanitizer, right after phase 14 on its model:
     runs (a)-(e) must have built no metric instrument and recorded no
     span; (f) run (c)'s configuration under `use_metrics`,
     `use_tracer(Tracer(torch_profiler=True))` and `use_estimator` (the
     scrub interval `adaptive_interval(4)`, sweeps prioritized), one step
     under torch.profiler: (a)'s tokens, (c)'s corrections, the
     `engine_steps`, `engine_tokens`, `pool_scrub_pages` and
     `pool_scrub_flagged` counters equal to the engine's reports, the
     `tenant_*` gauges of `publish_metrics` equal to `tenant_stats()`,
     one `engine.step` span a step, `engine.decode` at depth 1,
     `engine.scrub` exactly at the steps the schedule picked, and
     `engine.step`/`admit`/`decode`/`sample_sync` in the profile; it logs
     the schedule, each tenant's raw BER, stress and pressure, ms a step
     against (c)'s and the Chrome trace's events (written to a temporary
     directory); a 16 MiB float32 tensor in a wl1024_r08 writeback array
     with `uniform_flip(3, 1e-4)`, read once under a registry and an
     estimator: exact, the `mem_*` counters equal to the read's, the
     estimated raw BER within 5% of the share of changed cells; the
     sanitizer on CUDA tensors: an out-of-field symbol in a 4,096-word
     page given to the scan and to the encode's lhs, a NaN query, a NaN
     hot K row and a negative scale at the serving shape raise with the
     JAX package's text, a clean `attend_protected` gives the unsanitized
     bits, a decode of levels drifted below 0 passes, its host ms a call
     with the checks off and on, and 4 sanitized engine steps give (a)'s
     first tokens;
 16. the rest of the LM substrate, after phase 15's model is freed, each
     model freed before the next: (a) reduced olmoe, arctic, falcon-mamba,
     jamba, whisper and llama-3.2-vision with the same weights on the card
     and the CPU: logits within 2 bf16 ulps (a row beyond only where a
     router near-tie may have picked another expert, at most one in 16),
     MoE routing and dispatch exactly equal on the same router logits
     (and on logits with ties), prefill/decode consistency at the JAX
     test's tolerances, one training step with a finite loss; (b)
     olmoe-1b-7b at full width and depth (16 layers, 6.9 B seeded
     parameters): phase 8's three protected serving runs (4 x 512
     prompts, 32 steps, wl160_r08 pages of 16 tokens, D = 128): the
     injected run gives the clean tokens and logits bit for bit with no
     word left, `attend_protected` runs 16 times a step; the slots dropped
     at capacity each step, the MoE's share of a clean step (CUDA events
     around each MoE layer), peak memory; a flash prefill with every
     layer's flash attention within a few bf16 ulps of the fp32-softmax
     attention; (c) one 8-layer block of jamba-v0.1-52b at full width
     (13.3 B parameters; n_groups 4 -> 1): clean and injected runs, 16
     steps, the attention layer from protected pages and the seven mamba
     states dense; (d) whisper-small at full width and depth (12 + 12
     layers) over 1,500 seeded aux frames: prefill naive and flash by
     phase 9's criterion (flash_fwd once per encoder layer and twice per
     decoder layer, every one within a few bf16 ulps of the fp32-softmax
     attention, one-layer copies' logits within 0.04 of an fp32-softmax
     prefill, the full model's distances logged), then 16 greedy decode
     steps on dense caches holding the cross K/V;
 17. the PIM-protected training pass, after phase 15 frees its model:
     paper-pim-2b at full width and depth again (a fresh seeded model,
     not precoded, attn_impl="flash"), phase 8's prompts as tokens and
     their next tokens as labels, `loss_fn(..., pim_ctx=...).backward()`
     with mlp_down and attn_o on wl320_r08: (a) fault-free under remat
     "full"; (b) PIM output errors at 2e-5, which must flag words and,
     where every flagged word is corrected, give (a)'s loss and every
     gradient bit for bit (else a loss within 1e-3 relative, the words
     left logged); (c) (a) with remat off, which must give (a)'s loss,
     gradients and `stats()` exactly, each protected call counted once;
     (d) no `pim_ctx`, the dense pass. Every gradient finite; ms a pass
     (median of 3) of (a), (c) and (d), the kernels' launches a pass,
     peak memory and one profiled pass of (a) (busy share);
 13. the paper's BER campaign, `run_campaign(paper_schemes(wl1024_r08))`
     over nine raw BERs at the JAX bench's settings (NB-LDPC decoding on
     the card; first two draws' decode and residuals held against the
     CPU's exactly): the acceptance row must exist with NB-LDPC >= 10x,
     Hamming SECDED must improve > 50x at 1e-4 and < 3x at 1e-2, the
     modulo checksum 1x at 1e-3; wl1024_r088's conditional residuals for
     m = 1..12 are logged.

 18. the port's four examples (`scripts/quickstart_torch.py`,
     `memory_mode_torch.py`, `serve_protected_torch.py` and
     `train_small_torch.py --steps 20`), each in its own process on the
     card, started together: each must exit 0; their seconds are logged.
 19. the device mesh (`repro_torch.distributed.sharding`): every visible
     card when there are two or more, else four shards on the one card
     (a line names which, and the devices). (a) right after phase 15:
     phase 3's 64 MiB writeback array (same tensor, same flips) read and
     scrubbed with `use_sharded=True` over the mesh: the read-back, the
     flagged and corrected counts, the scrub's and the clean re-scan's
     equal to phase 3's unsharded run; one sharded scan adds one scan launch a shard
     and one one-iteration sharded decode one FBP and one scan launch a
     shard; (b) phase 14's run (c) with `ProtectedKVConfig(mesh=...)`
     (the engine's pool holds every 384-word page as row shards): every
     tenant's tokens and correction counts, the injected cells and the
     scrub reports equal to run (c)'s; (c) right after phase 16:
     olmoe-1b-7b (phase 16's seeded weights and prompts) served with
     `moe_impl="shard_ep"` under a (data 1, model S) mesh, prefill and 32
     greedy steps: each MoE layer's output at the prefill and at every
     step within four bf16 ulps of its largest (2^-5 of max |ref|) of the
     one-shard `sorted_ep` on the same input, with the same dropped
     slots; the tokens against phase 16's logged, then a run without the
     checks timed.
 20. data-parallel training (FSDP, `launch.train.run(mesh=...)` under
     `rules_for_cell`) on phase 19's devices, after phase 11: (a)
     granite-3-2b at full width and depth (flash, remat "full", AdamW,
     seq 4096), 2 rows a shard, 3 steps, held to the unsharded trainer on
     one card at microbatches = shards (run first from the same seeded
     weights, freed before the mesh run): each step's loss and grad norm
     within 1e-5 (step 0) and 1e-4 relative, the largest parameter
     difference and bitwise equality logged, flash_fwd twice and each
     backward kernel once per layer on every shard; ms a step, tokens/s,
     each card's peak memory and placed bytes; (b) `compressed_psum` over
     `data` on each shard's own gradient of (a)'s embedding, final norm
     and first and last layers, two rounds: every error within
     sum(scale_i) / (2n) plus fp32 rounding, the int8 and fp32 bytes;
     (c) phase 10's reduced granite over the mesh with an NB-LDPC
     protected checkpoint, storage faults injected, restored onto half
     the shards and onto no mesh bit for bit, one resumed step on each;
     (d) with four cards, olmoe-1b-7b at full width and depth over them,
     one row of 4,096 tokens a card, 3 steps: finite losses, each card
     at most 26% of the parameters and AdamW states (the states the
     trainer makes, placed and measured), drops at capacity and peak
     memory.
 21. tensor-parallel training (`launch.train.run(mesh=...)` over (data,
     model) meshes under `rules_for_cell`) on every card of a mesh, or
     its positions all on the one card: (a) granite-3-2b at full width
     and depth (flash, remat, AdamW, seq 4096; its vocabulary stays
     replicated), 2 rows a data shard, 3 steps on (1, 4) and on (2, 2),
     each held to the unsharded trainer on one card at microbatches =
     data shards (run first from the same seeded weights, freed before
     the mesh run): step 0's loss within 1e-3 and grad norm within 1e-2
     relative, later losses within 1e-2 (the naive-vs-flash training
     gates); every position's flash launches (forward and remat forward
     twice a layer, each backward kernel once) with Hq/M query heads and
     Hkv/M KV heads, each placed slice of a model-split leaf 1/(data x
     model) of it; the gaps, the largest parameter gap, ms a step,
     tokens/s, peak and placed bytes a card; (b) mistral-large-123b at
     full width (vocabulary split over `model`), 2 of its 88 groups,
     Adafactor, one row of 4,096, 3 steps on (1, 4) against the
     unsharded trainer at that depth under (a)'s gates; with four cards
     also 8 groups without a reference: each card placing 25% of every
     model-split leaf and peaking under its share of the parameters and
     gradients plus TP_ACTIVATION_GB, ms a step; (c) every config of
     `ARCH_IDS` reduced (flash; MoE, mamba, hybrid, encoder-decoder and
     cross), and olmoe-1b-7b, falcon-mamba-7b and whisper-small at full
     width with 2 groups (and 2 encoder groups), one step on (1, 4)
     against the unsharded step on the card under (a)'s step-0 gates,
     each attention layer's flash calls with its positions' heads.

The phases run in the order 1-9, 12, 14, 15, 19 (a, b), 17, 16, 19 (c),
13, 10, 11, 20, 21, 18 (phases 12, 14, 15 and 19 (b) need phase 8's model,
which is freed before phase 17). Phase 2
also holds flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain
versions (o to a few bf16 ulps, lse to rtol 1e-5, gradients
within 5e-3 of the largest, each gradient's error relative to its largest
logged) at the training and prefill shapes, a ragged
bidirectional case, a window of 256 and a softcap of 2, timed beside
torch's scaled_dot_product_attention under each of its flash,
memory-efficient and cuDNN backends that takes the case (the fastest is
the yardstick; the port never calls SDPA).

Kernel launch counts are reset just before each main path, memory and
PIM mode (phases 3-4), serving (phase 8), flash prefill (phase 9),
PIM-protected serving (phase 12, from the precode to the third run),
the engine (phase 14, its five runs less its two checks' launches),
telemetry (phase 15, run (f) and the memory-mode read), PIM training
(phase 17, its four runs), the substrate
(phase 16, each of (b)-(d) and (b)'s flash prefill),
the campaign (phase 13), training (phases 10-11), the mesh (phase 19,
(a)-(b) and (c) each), data-parallel training (phase 20) and
tensor-parallel training (phase 21), and read
just after it: every kernel must have run on its path. Each entry-point call of phases
3-4 (write, read, scrub, prepare_weights, each protected_pim_matmul) also
reports the launches it made itself, and phase 8 the launches of each
decode step. The last lines are the card's name and power limit, one JSON
object with each kernel's launches, error against its plain version and
times, and {"ok": true, "device": {...}}. Without a CUDA device, or
outside the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
MEMORY_MIB = 64          # size of the memory-mode tensor
TOKEN_ROWS = 256         # activation rows of the PIM-mode projections
SERVE_ARCH = "paper_pim"           # the serving phase's model (full size)
SERVE_BATCH = 4                    # requests served together
SERVE_PROMPT = 512                 # prompt tokens per request
SERVE_STEPS = 32                   # greedy decode steps
SERVE_FLIP = 2e-5                  # uniform_flip rate injected after prefill
PIM_STEPS = 16                     # greedy decode steps of each PIM run
PIM_FAULT_RATE = 2e-5              # PIM output errors of runs (b) and (c)
# wl320_r08 words of one protected projection of the PIM serving phase
# (2048 outputs a row: 8 words of 256 info and 64 check cells), at the
# prefill (4 x 512 rows) and at a decode step (4 rows)
PIM_PREFILL_WORDS = SERVE_BATCH * SERVE_PROMPT * 8
PIM_DECODE_WORDS = SERVE_BATCH * 8
PIM_CHECK_NOISE = 1e-3             # out_noise of the card-vs-CPU check
ENGINE_TENANTS = 8                 # phase 14's tenants
ENGINE_PROMPT_LENS = (128, 256, 384, 512)   # prompt tokens, cycled
ENGINE_NEW = 32                    # greedy tokens a tenant
ENGINE_SLOTS = 4                   # the engine's max_active
ENGINE_MAX_SEQ = 544               # the engine's max_seq (512 + 32)
ENGINE_PAGE_WORDS = 384            # wl160_r08 words of a (1, 16, 8, 64) page
ENGINE_FLIP = 2e-5                 # uniform_flip rate of run (c)
ENGINE_INJECT_STEP = 8             # run (c) injects after this step
ENGINE_SCRUB_EVERY = 4             # run (c)'s scrub cadence, in steps
ENGINE_SCRUB_PAGES = 256           # pages a scrub sweeps
ENGINE_PREEMPT_SHARE = 0.6         # run (d)'s pool, of (a)'s peak pages
ENGINE_CHECK_STEP = 20             # run (a) checks a fused read here
ENGINE_PROFILE_STEP = 24           # and profiles this step
SCRUB_CHECK_PAGES = 128            # pool pages scrubbed on card and CPU
ENGINE_MAX_STEPS = 1000            # an engine run longer than this fails
TELEMETRY_MIB = 16                 # phase 15's memory-mode tensor
TELEMETRY_FLIP = 1e-4              # uniform_flip rate injected into it
RAW_BER_RTOL = 0.05                # estimated raw BER against the share of
                                   # changed cells
SANITIZED_STEPS = 4                # engine steps run under the sanitizer
# the BER campaign: the JAX package's bench settings
# (benchmarks/bench_memory_mode.py)
CAMPAIGN_BERS = [3e-2, 2e-2, 1e-2, 5e-3, 2e-3, 1e-3, 3e-4, 1e-4, 1e-5]
CAMPAIGN_TRIALS, CAMPAIGN_HAMMING_TRIALS = 64, 4096
# attend_protected vs its plain version, and the card's small decode vs
# the CPU's: a few bf16 ulps (both round K/V and the logits to bf16 at the
# same places and sum in fp32 in their own orders)
ULP_RTOL, ULP_ATOL = 2 ** -7, 2 ** -10

# H100 SXM peaks (NVIDIA data sheet, dense): the bound_ms denominators
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
# bf16 dense tensor-core peak: products of bf16 inputs are exact in fp32,
# so it bounds the flash kernels' fp32-accumulated work on bf16 operands
BF16_OPS_PER_S = 989e12
# the flash kernels' backward against its plain version: within 5e-3 of
# the largest |gradient|, the JAX package's own bound for its kernel
# against its oracle (tests/test_flash_attention.py)
FLASH_BWD_BOUND = 5e-3
PREFILL_LOGITS_ATOL = 0.05     # flash vs naive, the JAX model-level bound
# one-layer full-width paper-pim-2b, flash prefill logits against an
# fp32-softmax prefill: one bf16 ulp of the largest logits (2^-5 at |logit|
# in [4, 8)) and a margin, under the 1.5-ulp gap of the naive prefill
# (0.047-0.055 on an H100; see PERF.md)
PREFILL_EXACT_ATOL = 0.04
TRAIN_ARCH = "granite_3_2b"    # the training phases' model
TRAIN_BATCH, TRAIN_SEQ = 2, 4096   # global batch (cut from 256), seq_len
TRAIN_STEPS = 6                # optimizer steps of the full-size run
SMALL_TRAIN_STEPS = 5          # phase 10's card-vs-CPU steps
PROFILE_ATTEMPTS = 3           # profiler windows tried before giving up
# phase 16: the rest of the LM substrate
SUBSTRATE_ARCHS = ("olmoe_1b_7b", "arctic_480b", "falcon_mamba_7b",
                   "jamba_v01_52b", "whisper_small", "llama32_vision_90b")
LOGITS_ULPS = 2 ** -5          # reduced card vs CPU logits: 2 bf16 ulps at
                               # |logit| in [2, 4)
MOE_ARCH = "olmoe_1b_7b"       # (b), full width and depth
MOE_PAGE_WORDS = 6144          # wl160_r08 words of a (4, 16, 16, 128) page
HYBRID_ARCH = "jamba_v01_52b"  # (c), one of its four 8-layer blocks
HYBRID_STEPS = 16
HYBRID_PAGE_WORDS = 3072       # wl160_r08 words of a (4, 16, 8, 128) page
ENCDEC_ARCH = "whisper_small"  # (d), full width and depth
WHISPER_PROMPT = 432           # + WHISPER_STEPS = 448, whisper's text context
WHISPER_STEPS = 16
# phase 17: the PIM-protected training pass of the serving model
PIM_TRAIN_REPS = 3             # timed passes of runs (a), (c) and (d)
PIM_TRAIN_LOSS_RTOL = 1e-3     # (b) against (a) where (b) leaves words
PIM_TRAIN_KERNELS = ("pim_mac", "gf_matmul", "scan_syndromes", "fbp_cn",
                     "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# phase 18: the port's examples (scripts/*_torch.py), all at once
EXAMPLES = (("quickstart", ()), ("memory_mode", ()),
            ("serve_protected", ()), ("train_small", ("--steps", "20")))
EXAMPLES_TIMEOUT = 300         # seconds an example may take
MESH_SHARDS_ONE_CARD = 4       # phase 19's shards when one card is visible
MOE_EP_SHARE = 2 ** -5         # phase 19 (c): four bf16 ulps of a layer's
                               # largest output
# phase 20: data-parallel training (FSDP) over mesh_devices()
FSDP_ROWS = TRAIN_BATCH        # (a) rows a shard: phase 11's load a card
FSDP_STEPS = 3
FSDP_RTOL0, FSDP_RTOL = 1e-5, 1e-4   # (a) step 0's, later steps' loss and
                                     # grad norm against the unsharded run
FSDP_MOE_ARCH = "olmoe_1b_7b"  # (d), on FSDP_MOE_CARDS cards
FSDP_MOE_CARDS = 4
FSDP_CARD_SHARE = 0.26         # (d) a card's share of the parameters and
                               # optimizer states at most
FSDP_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gf_matmul",
                "scan_syndromes", "fbp_cn")
# phase 21: tensor-parallel training over (data, model) meshes
TP_MESHES = ((1, 4), (2, 2))   # (a)'s meshes
TP_ROWS = 2                    # (a) rows a data shard
TP_STEPS = 3
TP_RTOL0_LOSS, TP_RTOL0_GNORM, TP_RTOL = 1e-3, 1e-2, 1e-2   # PERF.md §2
TP_BIG_ARCH = "mistral_large_123b"   # (b), full width
TP_BIG_GROUPS = 2              # (b) n_groups 88 -> 2 against the reference
TP_BIG_DEEP_GROUPS = 8         # (b) on four cards, no reference
TP_ACTIVATION_GB = 32          # (b) a card's peak over its share of the
                               # parameters and gradients, at most: the
                               # activations and Adafactor's float32
                               # temporaries of a card's largest stacked
                               # leaf (about six of 2.8 GB at 8 groups)
TP_FULL_ARCHS = ("olmoe_1b_7b", "falcon_mamba_7b", "whisper_small")
TP_FULL_GROUPS = 2             # (c) at full width: n_groups (and encoder
                               # groups) cut to 2
TP_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

REPLACES = {
    "gf_matmul": "src/repro/kernels/gf_matmul.py:51",
    "scan_syndromes": "src/repro/kernels/gf_matmul.py:98",
    "fbp_cn": "src/repro/kernels/fbp.py:89",
    "pim_mac": "src/repro/kernels/pim_mac.py:43",
    "attend_protected": "src/repro/kernels/paged_attention.py:122",
    "flash_fwd": "src/repro/kernels/flash_attention.py:116",
    "flash_bwd_dq": "src/repro/kernels/flash_attention.py:236",
    "flash_bwd_dkv": "src/repro/kernels/flash_attention.py:236",
}
SOURCES = {
    "gf_matmul": "src/repro_torch/kernels/csrc/gf_matmul.cu",
    "scan_syndromes": "src/repro_torch/kernels/csrc/gf_matmul.cu",
    "fbp_cn": "src/repro_torch/kernels/csrc/fbp.cu",
    "pim_mac": "src/repro_torch/kernels/csrc/pim_mac.cu",
    "attend_protected": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "flash_fwd": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_bwd_dq": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "flash_bwd_dkv": "src/repro_torch/kernels/csrc/flash_attention.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of one call of `fn`, from CUDA events around
    each of `reps` calls after a warm-up call."""
    import torch
    fn()
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


def profiled(fn, seen, *, cpu: bool = False, setup=None):
    """(profiler, wall us) of one `fn()` under torch.profiler (device
    activity, and host ops when `cpu`), after `setup()` where the call
    needs fresh state. On the card the profiler has at times recorded no
    device activity for a window (CUPTI's records lost): a window in
    which `seen(profiler)` is false is run again, setup included, up to
    PROFILE_ATTEMPTS times. None when every window came back empty."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        if seen(prof):
            return prof, wall_us
        log(f"  profiler: window {attempt} of {PROFILE_ATTEMPTS} recorded "
            f"none of the expected device activity")
    return None


def device_events(prof) -> list:
    """The profiler's device events (kernels, copies, sets), without the
    device-side ranges of `record_function` annotations (the spans of a
    `Tracer(torch_profiler=True)`), which cover kernels and would count
    their idle gaps as busy."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profiled_device(fn, *, cpu: bool = False, setup=None):
    """`profiled` for a window that must hold device events (None when
    none of its windows did)."""
    return profiled(fn, lambda prof: bool(device_events(prof)), cpu=cpu,
                    setup=setup)


def busy_report(got, wall_key: str, top: int) -> tuple[dict, dict]:
    """`profiled_device`'s window as report fields: its wall ms under
    `wall_key`, its device events, their sum and their union (busy) in
    ms, the idle share and the `top` kernels by device ms; and the device
    us by kernel name. Where no window held device events, the fields
    say so and hold no number."""
    if got is None:
        return {wall_key: None, "device_busy_ms": None,
                "profiler": "no device events in any window: not "
                            "measured"}, {}
    prof, wall_us = got
    events, by_kernel, busy_us = _device_busy(prof)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    fields = {wall_key: wall_us / 1e3, "device_events": events,
              "device_event_sum_ms": sum(by_kernel.values()) / 1e3,
              "device_busy_ms": busy_us / 1e3,
              "device_idle_share": 1.0 - busy_us / wall_us,
              "top_kernels_ms": {k[:60]: us / 1e3 for k, us in ranked}}
    return fields, by_kernel


def queued_ms(fn, reps: int) -> float:
    """Device time of one call of `fn` from CUDA events around `reps`
    calls queued behind a sleep kernel, so that the device runs them
    back to back and never waits for the host: every kernel of the call,
    and the device's gaps between launches (a microsecond or two each).
    The sleep grows until the start event is still pending when the last
    call has been queued."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 1 << 24                   # about 9 ms at 1.98 GHz
    for _ in range(4):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        queued = not a.query()
        b.synchronize()
        if queued:
            return a.elapsed_time(b) / reps
        cycles *= 4
    raise AssertionError("the calls could not be queued ahead of the "
                         "device")


def device_ms(fn, match: str, reps: int) -> float:
    """Device time of one call of `fn` in the kernels whose name holds
    `match`, from torch.profiler over `reps` calls after a warm-up call:
    the kernel alone, without the host time of its wrapper that
    `cuda_ms` includes when the kernel is shorter than the launch. Where
    every profiled window lacked the kernel (see `profiled`), the call's
    device time from `queued_ms`, logged as such."""
    fn()

    def calls():
        for _ in range(reps):
            fn()

    def us_of(prof) -> float:
        return sum(e.device_time_total for e in prof.key_averages()
                   if match in e.key)

    got = profiled(calls, us_of)
    if got is not None:
        return us_of(got[0]) / reps / 1e3
    ms = queued_ms(fn, reps)
    log(f"  device_ms: the profiler saw no {match} kernel; the call's "
        f"device time from queued CUDA events instead: {ms} ms")
    return ms


def host_ms(fn, calls: int) -> float:
    """Host time of one call of `fn`: the least, over five runs, of the
    wall time of `calls` back-to-back calls (launched, not waited for)
    over `calls`. The wrapper's Python and its launch; `cuda_ms` of a
    short kernel holds that, the launch's latency and the kernel."""
    import torch
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls)
        torch.cuda.synchronize()
    return best * 1e3


def launches_of(fn, per_call: dict, name: str):
    """Run `fn` and record, under `name`, the kernel launches it made:
    the change of every launch count across the call."""
    from repro_torch.kernels import build
    before = dict(build.LAUNCHES)
    out = fn()
    per_call[name] = {k: v - before.get(k, 0)
                      for k, v in build.LAUNCHES.items()
                      if v - before.get(k, 0)}
    return out


def _scan_smem(bn: int) -> int:
    """The scan kernel's dynamic shared memory at check tile bn (ScanCfg
    in csrc/gf_matmul.cu): a 1024-byte margin and NS stages of a 128 x
    128-byte word tile and a bn x 128-byte H tile, an mbarrier each."""
    stage = 128 * 128 + bn * 128
    ns = min(8, 220 * 1024 // stage)
    return 1024 + ns * stage + 8 * ns


def _gf_smem(bn: int) -> int:
    """The encode kernel's dynamic shared memory at column tile bn (GfOp
    in csrc/gf_matmul.cu): a 1024-byte margin, four 64 x 128-byte A
    tiles, and NS stages of a bn x 128-byte B tile and an mbarrier."""
    fixed, stage = 1024 + 4 * 64 * 128, bn * 128 + 8
    return fixed + min(8, (227 * 1024 - fixed) // stage) * stage


# dynamic shared memory of the wgmma kernels by template argument: a
# 1024-byte alignment margin and 64-row bf16 tiles of DM columns (fwd_smem,
# dq_smem and dkv_smem in csrc/flash_attention.cu; dq adds 3 mbarriers);
# for the PIM MAC (CLIP 0 or 1) six stages of a 128 x 128-byte X tile and
# W tile, two transposed W tiles and six mbarriers (SMEM in
# csrc/pim_mac.cu); for the scan by check tile (_scan_smem) and the
# encode by column tile (_gf_smem); fbp_cn's and the attend_protected
# kernels' depends on the call's shape (None here)
KERNEL_SMEM = {
    "flash_fwd": lambda dm: 1024 + 5 * 64 * dm * 2,
    "flash_bwd_dq": lambda dm: 1024 + 6 * 64 * dm * 2 + 3 * 8,
    "flash_bwd_dkv": lambda dm: 1024 + 6 * 64 * dm * 2 + 1024,
    "pim_mac": lambda clip: 1024 + 6 * 2 * 128 * 128 + 2 * 128 * 128 + 6 * 8,
    "scan_syndromes": _scan_smem, "gf_matmul": _gf_smem, "fbp_cn": None,
    "attend_split": None, "attend_combine": None}
# each source's kernels: the name, then its template arguments
KERNEL_ENTRIES = {
    "flash_attention.cu": r"(flash_fwd|flash_bwd_dq|flash_bwd_dkv)"
                          r"_kernelILi(\d+)E",
    "pim_mac.cu": r"(pim_mac)_kernelILb(\d)E",
    "gf_matmul.cu": r"(scan_syndromes|gf_matmul)_kernel(?:ILi(\d+)E)?",
    "fbp.cu": r"(fbp_cn)_kernelILi(\d+)E(?:Li(\d+)E)?",
    "paged_attention.cu": r"(attend_split|attend_combine)_kernel()E"}


def ptxas_report(logs: dict) -> dict:
    """Registers, spill bytes and shared memory of each instantiation of
    the port's kernels (all but the flash kernels' plain helpers), from
    nvcc's -Xptxas -v output (`logs`, empty when the library was not
    rebuilt by this process)."""
    out = {}
    for source, pattern in KERNEL_ENTRIES.items():
        entry = None
        for line in logs.get(source, "").splitlines():
            m = re.search(r"Compiling entry function '\S*?" + pattern, line)
            if m:
                name = m.group(1)
                args = [int(a) for a in m.groups()[1:] if a]
                entry = f"{name}<{','.join(map(str, args))}>" if args \
                    else name
                smem = KERNEL_SMEM[name]
                out[entry] = {"dynamic_smem_bytes": smem(*args)
                              if smem else None}
                continue
            if "Compiling entry function" in line:
                entry = None
            if entry is not None:
                _ptxas_counts(out[entry], line)
    return out


def _ptxas_counts(rec: dict, line: str) -> None:
    m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                  line)
    if m:
        rec["spill_store_bytes"] = int(m.group(1))
        rec["spill_load_bytes"] = int(m.group(2))
    m = re.search(r"Used (\d+) registers", line)
    if m:
        rec["registers"] = int(m.group(1))
    m = re.search(r"(\d+) bytes smem", line)
    if m:
        rec["static_smem_bytes"] = int(m.group(1))


def bound(nbytes: float, ops: float, peak_ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fbp_inputs(code, words: int, gen, device):
    """Contribution-space CN messages of `words` codewords of `code`:
    normalized random LLVs, with the max-plus identity in padded slots."""
    import torch
    from repro_torch.kernels.fbp import identity_msg
    c, dc, p = code.c, code.dc_max, code.p
    m = torch.randn((words, c, dc, p), generator=gen, device=device) * 4
    m = m - m.amax(dim=-1, keepdim=True)
    mask = code.tensor("cn_mask", device)[None, :, :, None]
    m = torch.where(mask, m, identity_msg((c, dc), p, device=device))
    return m.reshape(words * c, dc, p).contiguous()


# code, words: phase 2's encodes (gf_matmul)
GF_CASES = [("wl1024_r08", 4096), ("wl160_r08", 1536),
            ("wl160_r08", ENGINE_PAGE_WORDS), ("wl160_r08", MOE_PAGE_WORDS),
            ("wl160_r08", HYBRID_PAGE_WORDS)]
# code, words, share of words with one corrupted cell: phase 2's scans
SCAN_CASES = [("wl1024_r08", 4096, 0.1), ("wl1024_r08", 256, 0.1),
              ("wl1024_r08", 67, 0.1), ("wl160_r08", 1536, 0.01),
              ("wl40_r08", 4096, 0.1), ("wl512_r033", 1024, 0.1),
              ("wl160_r08_gf5", 1024, 0.1), ("wl160_r08_gf7", 1024, 0.1),
              ("wl320_r08", PIM_PREFILL_WORDS, 0.1),
              ("wl320_r08", PIM_DECODE_WORDS, 0.1),
              ("wl160_r08", ENGINE_PAGE_WORDS, 0.1),
              ("wl160_r08", MOE_PAGE_WORDS, 0.01),
              ("wl160_r08", HYBRID_PAGE_WORDS, 0.01)]
# code, words: phase 2's FBP updates (words x checks rows)
FBP_CASES = [("wl1024_r08", 256), ("wl160_r08_gf5", 256),
             ("wl1024_r088", 256), ("wl320_r08", PIM_PREFILL_WORDS),
             ("wl320_r08", PIM_DECODE_WORDS)]


def phase_kernels(device) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch
    from repro_torch.core import get_code, np_encode_words
    from repro_torch.kernels import build, fbp, gf_matmul, pim_mac
    gen = torch.Generator(device=device).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    rows = {}

    def record(name, out, ref, kernel, plain, library, nbytes, ops, peak,
               **extra):
        err = (out.to(torch.float64) - ref.to(torch.float64)).abs().max()
        err = float(err) if out.numel() else 0.0
        if not torch.equal(out, ref):
            raise AssertionError(f"{name}: kernel differs from its plain "
                                 f"version (max abs err {err})")
        b_ms, b_by = bound(nbytes, ops, peak)
        row = {"name": name, "max_abs_err": err,
               "ms": cuda_ms(kernel, 20), "plain_ms": cuda_ms(plain, 5),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms(library, 20) if library else None,
               **extra}
        rows.setdefault(name, []).append(row)
        log(f"  {name} {list(out.shape)}: exact, {json.dumps(row)}")

    # scan: stored words of each code the paths scan, some corrupted in one
    # cell, through the code's cached Hᵀ: a page of 4096 words of
    # wl1024_r08 (the first row), the decoder's check (256 words of hard
    # decisions) and a ragged 67-word tail of it, a paged-store page
    # (wl160_r08 at the serving page size), n = 40, C = 343, p = 5 and 7,
    # a PIM serving projection's words at the prefill and at a step, and
    # an engine slot's page (phase 14's corrected reads and pool scrub)
    for name, words, share in SCAN_CASES:
        c = get_code(name)
        u = rng.integers(0, c.p, (words, c.k))
        cw = np_encode_words(u, c)
        bad = rng.random(words) < share
        cols = rng.integers(0, c.n, words)
        cw[bad, cols[bad]] = (cw[bad, cols[bad]] + 1) % c.p
        y = torch.as_tensor(cw, dtype=torch.int8, device=device)
        ht = c.tensor("H.T", device, torch.int8)
        n0 = build.LAUNCHES["scan_syndromes"]
        flags = gf_matmul.scan_syndromes(y, ht, c.p)
        launches = build.LAUNCHES["scan_syndromes"] - n0
        if not torch.equal(flags.cpu(), torch.as_tensor(bad)):
            raise AssertionError(f"scan_syndromes {name} x {words}: flags "
                                 f"differ from the corrupted rows")
        M, K = y.shape
        C = ht.shape[1]
        tile, grid = gf_matmul.scan_plan(M, C, build.sm_count(device))
        extra = {}
        if name == "wl1024_r08" and words == 256:
            # each check tile at the decoder's check (C past a tile splits
            # over CTAs and zeroes the flags first)
            h8 = gf_matmul.kmajor_h(ht, c.p)
            extra["tile_device_ms"] = {t: device_ms(
                lambda t=t: gf_matmul.scan_launch(
                    y, h8, c.p, t, build.sm_count(device)),
                "scan_syndromes_kernel", 20) for t in gf_matmul.SCAN_TILES}
        record("scan_syndromes", flags,
               gf_matmul.scan_syndromes_plain(y, ht, c.p),
               lambda y=y, ht=ht, p=c.p: gf_matmul.scan_syndromes(y, ht, p),
               lambda y=y, ht=ht, p=c.p: gf_matmul.scan_syndromes_plain(
                   y, ht, p), None,
               M * K + K * C + M, 2 * M * K * C, INT8_OPS_PER_S, code=name,
               shape=[M, K, C], tile=tile, ctas=grid,
               launches_per_call=launches,
               device_ms=device_ms(
                   lambda y=y, ht=ht, p=c.p: gf_matmul.scan_syndromes(
                       y, ht, p), "scan_syndromes_kernel", 20),
               host_ms=host_ms(
                   lambda y=y, ht=ht, p=c.p: gf_matmul.scan_syndromes(
                       y, ht, p), 200), **extra)

    # encode: a page of 4096 words of wl1024_r08, (4096, 819) x (819, 205)
    # (the first row), a paged-store page freeze of wl160_r08 at the
    # serving page size, (1536, 128) x (128, 32), and an engine slot's
    # page freeze (phase 14), (384, 128) x (128, 32), through the code's
    # cached P; torch.matmul in fp32 is the yardstick, and torch._int_mm
    # on the operands zero-padded to K and N multiples of 8 is logged
    # beside it
    for name, words in GF_CASES:
        c = get_code(name)
        a = torch.as_tensor(rng.integers(0, c.p, (words, c.k)),
                            dtype=torch.int8, device=device)
        P = c.tensor("P", device, torch.int8)
        af, Pf = a.float(), P.float()
        M, K = a.shape
        N = P.shape[1]
        K8, N8 = -(-K // 8) * 8, -(-N // 8) * 8
        a8 = torch.nn.functional.pad(a, (0, K8 - K))
        P8 = torch.nn.functional.pad(P, (0, N8 - N, 0, K8 - K))
        if not torch.equal(torch._int_mm(a8, P8)[:, :N] % c.p,
                           gf_matmul.gf_matmul_plain(a, P, c.p)):
            raise AssertionError("torch._int_mm differs from the exact "
                                 "product")
        fn = lambda a=a, P=P, p=c.p: gf_matmul.gf_matmul(a, P, p)  # noqa: E731
        tile, grid = gf_matmul.gf_plan(M, N, build.sm_count(device))
        extra = {}
        if words == 4096:
            # each column tile at a 4096-word page (narrower tiles spread
            # its 32 row tiles over more CTAs)
            bk = gf_matmul.kmajor_h(P, c.p)
            extra["tile_device_ms"] = {t: device_ms(
                lambda t=t, a=a, bk=bk, p=c.p: gf_matmul.gf_launch(
                    a, bk, p, t, build.sm_count(device)),
                "gf_matmul_kernel", 20) for t in gf_matmul.GF_TILES}
        record("gf_matmul", gf_matmul.gf_matmul(a, P, c.p),
               gf_matmul.gf_matmul_plain(a, P, c.p), fn,
               lambda a=a, P=P, p=c.p: gf_matmul.gf_matmul_plain(a, P, p),
               lambda af=af, Pf=Pf: af @ Pf, M * K + K * N + 4 * M * N,
               2 * M * K * N, INT8_OPS_PER_S, code=name, shape=[M, K, N],
               tile=tile, ctas=grid,
               int_mm_ms=cuda_ms(lambda a8=a8, P8=P8: torch._int_mm(a8, P8),
                                 20),
               device_ms=device_ms(fn, "gf_matmul_kernel", 20),
               host_ms=host_ms(fn, 200), **extra)

    # FBP: one 256-word chunk of wl1024_r08 (p=3, dc 16; the first row),
    # of wl160_r08_gf5, and of wl1024_r088 (dc 26); a PIM serving
    # projection's words (wl320_r08, dc 15) at the prefill and at a step
    for name, words in FBP_CASES:
        c = get_code(name)
        m = fbp_inputs(c, words, gen, device)
        N, dc, p = m.shape
        ops = N * (3 * dc - 4) * 2 * p * p
        fn = lambda m=m, p=p: fbp.fbp_cn(m, p)  # noqa: E731
        record("fbp_cn", fbp.fbp_cn(m, p), fbp.fbp_cn_plain(m, p), fn,
               lambda m=m, p=p: fbp.fbp_cn_plain(m, p), None,
               2 * m.numel() * 4, ops, FP32_OPS_PER_S, code=name,
               shape=[N, dc, p], device_ms=device_ms(fn, "fbp_cn_kernel", 20),
               host_ms=host_ms(fn, 200))

    # PIM MAC: (256, 8192) x (8192, 2560), R=64, ideal and 6-level ADC
    x = torch.randint(-7, 8, (256, 8192), generator=gen, device=device,
                      dtype=torch.int8)
    w = torch.randint(-1, 2, (8192, 2560), generator=gen, device=device,
                      dtype=torch.int8)
    xf, wf = x.float(), w.float()
    B, K = x.shape
    N = w.shape[1]
    # second yardstick: cuBLASLt's s8 x s8 -> s32 product, the adc-0
    # function on the same int8 operands (held to the plain version too)
    if not torch.equal(torch._int_mm(x, w), pim_mac.pim_mac_plain(
            x, w, row_parallelism=64, adc_levels=0)):
        raise AssertionError("torch._int_mm differs from the exact MAC")
    yardsticks = {"int_mm_ms": cuda_ms(lambda: torch._int_mm(x, w), 20),
                  # what a K-major W made by the wrapper would add per call
                  "w_transpose_ms": cuda_ms(lambda: w.t().contiguous(), 20)}
    for adc in (0, 6):
        kw = dict(row_parallelism=64, adc_levels=adc)
        record("pim_mac", pim_mac.pim_mac(x, w, **kw),
               pim_mac.pim_mac_plain(x, w, **kw),
               lambda kw=kw: pim_mac.pim_mac(x, w, **kw),
               lambda kw=kw: pim_mac.pim_mac_plain(x, w, **kw),
               lambda: xf @ wf, B * K + K * N + 4 * B * N, 2 * B * K * N,
               INT8_OPS_PER_S, adc_levels=adc, **yardsticks,
               device_ms=device_ms(lambda kw=kw: pim_mac.pim_mac(x, w, **kw),
                                   "pim_mac_kernel", 20))
    return rows


def attend_operands(device, gen, *, B, Sq, Hq, Hkv, D, T, NP, S, code,
                    ragged=False):
    """attend_protected operands: NP page steps of S sub-pages each,
    quantized and encoded from random bf16 K/V on the card, full pages
    (or ragged valid counts with empty rows), a half-full hot page (or a
    ragged one) and a random query."""
    import torch
    from repro_torch.core import encode_words
    from repro_torch.memory import quantize_tensor, words_for_tensor
    page_shape = (B // S, T, Hkv, D)
    W = words_for_tensor(page_shape, code.p, code.k)
    pages = torch.zeros((2, NP, S, W, code.n), dtype=torch.int8,
                        device=device)
    scales = torch.zeros((2, NP, S), device=device)
    for c in range(2):
        for j in range(NP):
            for s in range(S):
                x = torch.randn(page_shape, generator=gen, device=device)
                words, meta = quantize_tensor(x.to(torch.bfloat16), code.p,
                                              code.k)
                pages[c, j, s] = encode_words(words, code)
                scales[c, j, s] = meta.scale
    kw = dict(generator=gen, device=device, dtype=torch.int32)
    if ragged:
        valid = torch.randint(0, T + 1, (NP, B), **kw)
        hot_valid = torch.randint(1, T + 1, (B,), **kw)
    else:
        valid = torch.full((NP, B), T, dtype=torch.int32, device=device)
        hot_valid = torch.full((B,), T // 2, dtype=torch.int32,
                               device=device)
    rnd = dict(generator=gen, device=device)
    q = torch.randn((B, Sq, Hq, D), **rnd).to(torch.bfloat16)
    hot_k = torch.randn((B, T, Hkv, D), **rnd).to(torch.bfloat16)
    hot_v = torch.randn((B, T, Hkv, D), **rnd).to(torch.bfloat16)
    args = (q, pages[0].contiguous(), pages[1].contiguous(),
            scales[0].contiguous(), scales[1].contiguous(), valid, hot_k,
            hot_v, hot_valid)
    return args, dict(p=code.p, k_info=code.k, page_shape=page_shape)


def attend_cost(args, kw) -> tuple[float, float]:
    """(bytes, flops) the fused read needs: each input read once (of the
    pages only the info digits that hold K/V), the output written once;
    QKᵀ and P·V at 2 flops per multiply-add."""
    from repro_torch.memory import digits_per_byte
    q, kp, _vp, ks, _vs, valid, hot_k, _hv, hot_valid = args
    B, Sq, Hq, D = q.shape
    NP = kp.shape[0]
    T = hot_k.shape[1]
    elems = hot_k.numel()                       # one page step's K (or V)
    steps = NP + (1 if kw["with_hot"] else 0)
    nbytes = (2 * NP * elems * digits_per_byte(kw["p"])
              + 2 * (ks.numel() * 4) + valid.numel() * 4
              + 2 * q.numel() * 2 + hot_valid.numel() * 4
              + (2 * 2 * elems if kw["with_hot"] else 0))
    flops = 4.0 * B * Sq * Hq * D * T * steps
    return nbytes, flops


def empty_rows(args, NP):
    """attend_protected operands whose row 0 has no valid token in its
    first half of pages, rows 1 and 2 none in any page, and row 2 none in
    the hot page either."""
    valid, hot_valid = args[5].clone(), args[8].clone()
    valid[:NP // 2, 0] = 0
    valid[:, 1:3] = 0
    hot_valid[2] = 0
    return (*args[:5], valid, *args[6:8], hot_valid)


def phase_attend(device) -> list:
    """attend_protected against its plain version at the serving shape,
    hot-only, with a softcap, with per-slot sub-pages, at one page, at a
    page count its ranges do not divide evenly, at a long context, and
    with rows that have no valid token in some ranges or in all; at phase
    14's per-slot read (ranges sized for the engine's max_seq); and at one
    request (B = 1, the single-sequence layer's read) over a short and a
    long context. Two calls on the same inputs bitwise equal."""
    import torch
    from repro_torch.core import get_code
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED)
    code = get_code("wl160_r08")
    serving = dict(B=4, Sq=1, Hq=32, Hkv=8, D=64, T=16, NP=32, S=1)
    uneven = {**serving, "NP": 40, "ragged": True}
    # label, shape, softcap, with_hot, rows without valid tokens
    cases = [("serving", serving, 0.0, True, False),
             ("hot_only", {**serving, "NP": 0}, 0.0, True, False),
             ("softcap50", serving, 50.0, True, False),
             ("softcap2", serving, 2.0, True, False),
             ("per_slot", {**serving, "S": 4, "ragged": True}, 0.0, True,
              False),
             ("np1", {**serving, "NP": 1}, 0.0, True, False),
             ("uneven_np40", uneven, 0.0, True, False),
             ("empty_rows", uneven, 0.0, True, True),
             ("empty_rows_no_hot", uneven, 0.0, False, True),
             ("long_np256", {**serving, "NP": 256}, 0.0, True, False),
             ("engine_per_slot", {**serving, "S": 4, "NP": 20,
                                  "ragged": True}, 0.0, True, False),
             ("single_np32", {**serving, "B": 1}, 0.0, True, False),
             ("single_np256", {**serving, "B": 1, "NP": 256}, 0.0, True,
              False),
             # phase 16's decode reads at D = 128: olmoe-1b-7b, jamba
             ("olmoe_d128", {**serving, "Hq": 16, "Hkv": 16, "D": 128},
              0.0, True, False),
             ("jamba_d128", {**serving, "D": 128}, 0.0, True, False)]
    # the engine sizes its ranges for max_seq's pages (BatchedPagedKV)
    ref_of = {"engine_per_slot": -(-ENGINE_MAX_SEQ // serving["T"])}
    rows = []
    for label, shape, softcap, with_hot, empty in cases:
        args, kw = attend_operands(device, gen, code=code, **shape)
        if empty:
            args = empty_rows(args, shape["NP"])
        ref = ref_of.get(label, 0)
        kw.update(softcap=softcap, with_hot=with_hot, ref_pages=ref)
        n0 = build.LAUNCHES["attend_protected"]
        got = pa.attend_protected(*args, **kw)
        again = pa.attend_protected(*args, **kw)
        launches = (build.LAUNCHES["attend_protected"] - n0) // 2
        torch.cuda.synchronize()
        want = pa.attend_protected_plain(*args, **kw)
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        if not torch.isfinite(got.float()).all() or bool(
                (diff > ULP_ATOL + ULP_RTOL * want.float().abs()).any()):
            raise AssertionError(f"attend_protected {label}: differs from "
                                 f"its plain version (max abs err {err})")
        if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
            raise AssertionError(f"attend_protected {label}: two calls "
                                 f"differ")
        nbytes, flops = attend_cost(args, kw)
        b_ms, b_by = bound(nbytes, flops, FP32_OPS_PER_S)
        B, Hkv = shape["B"], shape["Hkv"]
        row = {"name": "attend_protected", "case": label,
               "shape": {k: v for k, v in shape.items() if k != "ragged"},
               "softcap": softcap, "with_hot": with_hot, "ref_pages": ref,
               "pages_a_step_range_and_ranges": pa.attend_plan(
                   shape["NP"], B * Hkv, shape["T"], build.sm_count(device),
                   ref),
               "max_abs_err": err, "bitwise_repeatable": True,
               "launches_per_call": launches,
               "ms": cuda_ms(lambda: pa.attend_protected(*args, **kw), 20),
               "device_ms": device_ms(
                   lambda: pa.attend_protected(*args, **kw), "attend_", 20),
               "host_ms": host_ms(
                   lambda: pa.attend_protected(*args, **kw), 200),
               "plain_ms": cuda_ms(
                   lambda: pa.attend_protected_plain(*args, **kw), 5),
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "library_ms": None}
        rows.append(row)
        log(f"  attend_protected {label}: within rtol {ULP_RTOL}, atol "
            f"{ULP_ATOL}, {json.dumps(row)}")
    return rows


def phase_memory(device, per_call: dict) -> dict:
    """A MEMORY_MIB float32 tensor through a wl1024_r08 writeback array;
    each entry-point call's kernel launches go into `per_call`."""
    import numpy as np
    import torch
    from repro_torch.memory import ProtectedMemoryArray, uniform_flip
    gen = torch.Generator(device=device).manual_seed(SEED)
    t = torch.randn(MEMORY_MIB * 2 ** 18, generator=gen, device=device)
    expect = t.cpu().numpy()
    # unsharded on every host: phase 19 (a) holds the sharded run to it
    mem = ProtectedMemoryArray("wl1024_r08", controller="writeback",
                               device=device, key=SEED, use_sharded=False)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = launches_of(fn, per_call, name.removesuffix("_s"))
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    st = timed("write_s", lambda: mem.write("t", t))
    cells = st.enc.numel()
    changed = timed("inject_s", lambda: mem.inject(uniform_flip(3, 1e-4)))
    out = timed("read_s", lambda: mem.read("t"))
    if not np.array_equal(out.view(np.uint8), expect.view(np.uint8)):
        raise AssertionError("memory read-back differs from the written "
                             "bytes")
    s = mem.stats
    if s.detected <= 0 or s.uncorrectable != 0:
        raise AssertionError(f"read stats {s.correction_counts()}")
    changed2 = mem.inject(uniform_flip(3, 1e-4))
    rep = timed("scrub_s", lambda: mem.scrub())
    clean = timed("rescrub_s", lambda: mem.scrub())
    if rep["uncorrectable"] or clean["flagged"]:
        raise AssertionError(f"scrub left errors: {rep['uncorrectable']} "
                             f"uncorrectable, re-scan flagged "
                             f"{clean['flagged']}")
    res = {"words": st.enc.shape[0], "cells": cells,
           "cells_changed": changed, "read_flagged": s.detected,
           "read_corrected": s.corrected, "cells_changed_2": changed2,
           "scrub_flagged": rep["flagged"],
           "scrub_corrected": rep["corrected"],
           "rescrub_flagged": clean["flagged"], **times}
    log(f"  memory: {json.dumps(res)}")
    return res, mem


def _device_busy(prof) -> tuple[int, dict, float]:
    """(device events, device time by kernel name in us, busy us: the
    union of the device events' intervals)."""
    by_kernel: dict[str, float] = {}
    spans = []
    for e in device_events(prof):
        spans.append((e.time_range.start, e.time_range.end))
        by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy_us += end - max(start, reach)
            reach = end
    return len(spans), by_kernel, busy_us


def phase_profile(mem) -> dict:
    """Where a corrected read of the memory-mode array spends its time:
    a fresh injection, then one read under torch.profiler (device time by
    kernel, and the share of the read's wall time the device was busy),
    and the scan and encode kernels against their plain versions over the
    whole store.

    Busy time is the union of the intervals of the device's own events
    (kernels, copies, sets): the profiler also charges each kernel's time
    to the host op that launched it, so the host ops are left out."""
    import torch
    from repro_torch.kernels import gf_matmul
    from repro_torch.memory import uniform_flip
    res, _ = busy_report(profiled_device(
        lambda: mem.read("t"), cpu=True,
        setup=lambda: mem.inject(uniform_flip(3, 1e-4))),
        "read_wall_ms_profiled", 10)
    enc = mem.stored("t").enc
    code = mem.code
    ht = code.tensor("H.T", enc.device, torch.int8)
    if not torch.equal(gf_matmul.scan_syndromes(enc, ht, code.p),
                       gf_matmul.scan_syndromes_plain(enc, ht, code.p)):
        raise AssertionError("scan_syndromes over the whole store differs "
                             "from its plain version")
    res.update({
        "full_scan_words": enc.shape[0],
        "full_scan_ms": cuda_ms(
            lambda: gf_matmul.scan_syndromes(enc, ht, code.p), 5),
        "full_scan_device_ms": device_ms(
            lambda: gf_matmul.scan_syndromes(enc, ht, code.p),
            "scan_syndromes_kernel", 20),
        "full_scan_bound_ms": bound(
            enc.numel() + ht.numel() + enc.shape[0],
            2 * enc.numel() * ht.shape[1], INT8_OPS_PER_S)[0],
        "full_scan_plain_ms": cuda_ms(
            lambda: gf_matmul.scan_syndromes_plain(enc, ht, code.p), 3)})
    # the whole store's encode: its info words (M, k) times P
    info = enc[:, :code.k].contiguous()
    P = code.tensor("P", enc.device, torch.int8)
    if not torch.equal(gf_matmul.gf_matmul(info, P, code.p),
                       gf_matmul.gf_matmul_plain(info, P, code.p)):
        raise AssertionError("gf_matmul over the whole store differs from "
                             "its plain version")
    M, K = info.shape
    N = P.shape[1]
    res.update({
        "full_encode_shape": [M, K, N],
        "full_encode_ms": cuda_ms(
            lambda: gf_matmul.gf_matmul(info, P, code.p), 5),
        "full_encode_device_ms": device_ms(
            lambda: gf_matmul.gf_matmul(info, P, code.p),
            "gf_matmul_kernel", 20),
        "full_encode_bound_ms": bound(M * K + K * N + 4 * M * N,
                                      2 * M * K * N, INT8_OPS_PER_S)[0],
        "full_encode_plain_ms": cuda_ms(
            lambda: gf_matmul.gf_matmul_plain(info, P, code.p), 3)})
    del info
    log(f"  profile: {json.dumps(res)}")
    return res


def phase_pim(device, per_call: dict) -> dict:
    """paper-pim-2b's protected projections at full width; each
    entry-point call's kernel launches go into `per_call`."""
    import torch
    from repro_torch.core import (PIMConfig, ProtectionConfig, get_code,
                                  prepare_weights, protected_pim_matmul,
                                  strip_padding)
    code = get_code("wl320_r08")
    cfg = PIMConfig(row_parallelism=64, adc_levels=0,
                    output_error_rate=1e-3, p=code.p)
    on = ProtectionConfig(code_name="wl320_r08", mode="correct", n_iters=4,
                          damping=0.3)
    off = ProtectionConfig(code_name="wl320_r08", mode="off")
    gen = torch.Generator(device=device).manual_seed(SEED)
    res = {}
    for name, n_in, n_out in (("mlp_down", 8192, 2048),
                              ("attn_o", 2048, 2048)):
        W = torch.randint(-1, 2, (n_in, n_out), generator=gen, device=device,
                          dtype=torch.int8)
        x = torch.randint(-7, 8, (TOKEN_ROWS, n_in), generator=gen,
                          device=device, dtype=torch.int8)
        exact = (x.float() @ W.float()).to(torch.int32)   # exact: < 2^24
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        W_enc = launches_of(lambda: prepare_weights(W, code), per_call,
                            f"{name}.prepare_weights")
        noise_seed = SEED + n_in
        raw = launches_of(lambda: protected_pim_matmul(
            x, W_enc, code, off, cfg, generator=torch.Generator(
                device=device).manual_seed(noise_seed)),
            per_call, f"{name}.matmul_off")
        cor = launches_of(lambda: protected_pim_matmul(
            x, W_enc, code, on, cfg, generator=torch.Generator(
                device=device).manual_seed(noise_seed)),
            per_call, f"{name}.matmul_correct")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        raw_err = float((strip_padding(raw.y, n_out) != exact).float().mean())
        cor_err = float((strip_padding(cor.y, n_out) != exact).float().mean())
        if not cor_err < raw_err:
            raise AssertionError(f"{name}: error rate {cor_err} after "
                                 f"correction, {raw_err} before")
        res[name] = {"W_enc": list(W_enc.shape), "raw_error_rate": raw_err,
                     "corrected_error_rate": cor_err,
                     "detected_words": int(cor.detected.sum()),
                     "uncorrected_words": int(cor.uncorrected.sum()),
                     "seconds": dt}
        log(f"  pim {name}: {json.dumps(res[name])}")
    return res


def phase_small_reference(device) -> None:
    """The card's decoder and protected matmul against the plain CPU run
    of the same functions on a small input: exactly equal."""
    import numpy as np
    import torch
    from repro_torch.core import (PIMConfig, ProtectionConfig,
                                  decode_integers, get_code, np_encode_words,
                                  prepare_weights, protected_pim_matmul)
    rng = np.random.default_rng(SEED)
    code = get_code("wl160_r08")
    y = np_encode_words(rng.integers(0, code.p, (64, code.k)), code)
    hit = rng.random(y.shape) < 0.02
    y[hit] += rng.choice([-1, 1], hit.sum())
    kw = dict(n_iters=8, damping=0.3, early_exit=True)
    yc, rc = decode_integers(code, y, device="cpu", **kw)
    yg, rg = decode_integers(code, y, device=device, **kw)
    for a, b in zip((yc, *rc), (yg, *rg), strict=True):
        if not torch.equal(a, b.cpu()):
            raise AssertionError("decode on the card differs from the CPU")
    W = rng.integers(-1, 2, (512, 256))
    x = rng.integers(-7, 8, (16, 512))
    noise = (rng.random((16, 320)) < 0.01) * rng.choice([-1, 1], (16, 320))
    cfg = PIMConfig(row_parallelism=64, adc_levels=6)
    prot = ProtectionConfig(code_name="wl320_r08", n_iters=4, damping=0.3)
    code = get_code("wl320_r08")
    outs = []
    for dev in ("cpu", device):
        W_enc = prepare_weights(torch.as_tensor(W, dtype=torch.int8,
                                                device=dev), code)
        r = protected_pim_matmul(
            torch.as_tensor(x, dtype=torch.int8, device=dev), W_enc, code,
            prot, cfg, out_noise=torch.as_tensor(noise, device=dev))
        outs.append([t.cpu() for t in r])
    if not all(torch.equal(a, b) for a, b in zip(*outs, strict=True)):
        raise AssertionError("protected matmul on the card differs from "
                             "the CPU")
    log("  small inputs: card == CPU plain run (decode, protected matmul)")


def phase_small_serving(device) -> None:
    """A small protected-KV prefill and decode (reduced paper-pim-2b) on
    the card, through the kernels, against the same weights' plain CPU
    run, teacher-forced on the same tokens: logits (of magnitude 0.1 to
    1) within a few bf16 ulps, rtol 2^-7 and atol 2^-10 (each device
    rounds its bf16 matmuls in its own order; the kernel rounds K/V and
    the logits to bf16 where the plain version does)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import (ProtectedKVConfig, decode_step,
                                    init_params, prefill)
    cfg = get_config(SERVE_ARCH).reduced(n_groups=2, d_model=64, n_heads=4,
                                         n_kv_heads=2, d_ff=128)
    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=4)
    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)))
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (5, 2, 1)))
    outs = []
    for dev in ("cpu", device):
        params = init_params(cfg, SEED, device="cpu").to(dev)
        _, caches = prefill(params, cfg, prompt.to(dev), protected_kv=pkv)
        steps = []
        for i in range(toks.shape[0]):
            lg, caches = decode_step(params, cfg, caches, toks[i].to(dev),
                                     prompt.shape[1] + i)
            steps.append(lg.cpu())
        outs.append(torch.cat(steps, dim=1))
    diff = (outs[0] - outs[1]).abs()
    err = float(diff.max())
    if bool((diff > ULP_ATOL + ULP_RTOL * outs[0].abs()).any()):
        raise AssertionError(f"small protected decode: card differs from "
                             f"the CPU by {err}")
    log(f"  small protected decode: card == CPU plain run within rtol "
        f"{ULP_RTOL}, atol {ULP_ATOL} (max abs err {err})")


def _layer_corrections(caches) -> dict:
    out = {"detected": 0, "corrected": 0, "uncorrectable": 0}
    for layer in caches.layers.values():
        st = layer.stats()
        for k in out:
            out[k] += st[k]
    return out


def serve_once(params, cfg, prompts, pkv, *, inject: bool, pim_ctx=None,
               steps: int = SERVE_STEPS) -> dict:
    """prefill, optionally inject, then `steps` greedy decode steps, with
    `pim_ctx` protecting its projections where given. Returns tokens,
    every step's logits, times and per-step launches."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.memory import uniform_flip
    from repro_torch.models import decode_step, prefill
    B, S = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(params, cfg, prompts, protected_kv=pkv,
                             max_seq=S + steps, pim_ctx=pim_ctx)
    tok = logits[:, -1:].argmax(dim=-1)
    tok.cpu()                                  # the first token is out
    ttft = time.perf_counter() - t0
    changed = 0
    if inject:
        changed = caches.inject(uniform_flip(3, SERVE_FLIP), key=SEED)
    torch.cuda.synchronize()
    toks, step_logits, per_step = [tok], [], []
    t1 = time.perf_counter()
    for i in range(steps):
        before = dict(build.LAUNCHES)
        lg, caches = decode_step(params, cfg, caches, tok, S + i,
                                 pim_ctx=pim_ctx)
        per_step.append({k: v - before.get(k, 0)
                         for k, v in build.LAUNCHES.items()
                         if v - before.get(k, 0)})
        tok = lg[:, -1:].argmax(dim=-1)
        step_logits.append(lg)
        toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    logits_all = torch.cat(step_logits, dim=1)          # (B, steps, V)
    if logits_all.shape != (B, steps, cfg.vocab_size) or not bool(
            torch.isfinite(logits_all).all()):
        raise AssertionError(f"serving logits: shape "
                             f"{tuple(logits_all.shape)} or not finite")
    return {"caches": caches, "tokens": torch.cat(toks, dim=1).cpu(),
            "logits": logits_all, "ttft_s": ttft, "decode_s": decode_s,
            "cells_changed": changed, "per_step": per_step,
            "prefill_tokens_per_s": B * S / ttft,
            "decode_tokens_per_s": B * steps / decode_s,
            "ms_per_decode_step": decode_s / steps * 1e3}


def phase_serving(device) -> tuple[dict, dict, tuple]:
    """Protected KV-cache serving of paper-pim-2b at full width and depth.
    Returns (report, the kernel launches of its runs, (cfg, params,
    prompts) for the flash prefill of phase 9)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import ProtectedKVConfig, init_params
    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    n_params = sum(p.numel() for p in params.parameters())
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=16)
    n_layers = cfg.n_groups * len(cfg.group_spec)

    build.reset_launches()
    runs = {"clean": serve_once(params, cfg, prompts, pkv, inject=False),
            "injected": serve_once(params, cfg, prompts, pkv, inject=True),
            "uncorrected": serve_once(
                params, cfg, prompts,
                dataclasses.replace(pkv, corrected=False), inject=True)}
    launches = dict(build.LAUNCHES)

    clean, inj, raw = runs["clean"], runs["injected"], runs["uncorrected"]
    fixes = _layer_corrections(inj["caches"])
    stats = inj["caches"].stats()
    report = {"arch": cfg.name, "parameters": n_params,
              "layers": n_layers, "batch": SERVE_BATCH,
              "prompt_tokens": SERVE_PROMPT, "decode_steps": SERVE_STEPS,
              "code": pkv.code_name, "page_tokens": pkv.page_tokens,
              "init_s": init_s, "stored_pages_after_prefill":
                  2 * n_layers * (SERVE_PROMPT // pkv.page_tokens),
              "stored_cells": stats["stored_cells"],
              "injected_cells": inj["cells_changed"],
              "run2_corrections": fixes,
              "run2_flagged_after_serving": stats["flagged_words"]}
    for name, r in runs.items():
        steps = r["per_step"]
        report[name] = {
            k: r[k] for k in ("ttft_s", "decode_s", "prefill_tokens_per_s",
                              "decode_tokens_per_s", "ms_per_decode_step")}
        report[name]["launches_first_step"] = steps[0]
        report[name]["launches_per_step_mean"] = {
            k: sum(st.get(k, 0) for st in steps) / len(steps)
            for k in sorted({k for st in steps for k in st})}
    report["uncorrected_logit_drift"] = {
        "max_abs": float((raw["logits"] - clean["logits"]).abs().max()),
        "tokens_equal_share": float(
            (raw["tokens"] == clean["tokens"]).float().mean())}
    log(f"  serving: {json.dumps(report)}")

    _serving_checks(cfg.name, runs, n_layers, SERVE_STEPS)
    for name in ("clean", "injected", "uncorrected"):
        del runs[name]["caches"]
    report["profile_step"] = profile_decode_step(params, cfg, prompts, pkv)
    return report, launches, (cfg, params, prompts)


def profile_decode_step(params, cfg, prompts, pkv, pim_ctx=None) -> dict:
    """One clean decode step (after a prefill and one warm step) under
    torch.profiler: wall time, device busy time (the union of the device
    events' intervals), the top device kernels, and the host ops with the
    most self time (with their call counts)."""
    from repro_torch.models import decode_step, prefill
    S = prompts.shape[1]
    state = {}

    def setup():
        logits, caches = prefill(params, cfg, prompts, protected_kv=pkv,
                                 pim_ctx=pim_ctx)
        tok = logits[:, -1:].argmax(dim=-1)
        lg, state["caches"] = decode_step(params, cfg, caches, tok, S,
                                          pim_ctx=pim_ctx)
        state["tok"] = lg[:, -1:].argmax(dim=-1)

    got = profiled_device(
        lambda: decode_step(params, cfg, state["caches"], state["tok"],
                            S + 1, pim_ctx=pim_ctx), cpu=True, setup=setup)
    res, _ = busy_report(got, "step_wall_ms_profiled", 8)
    if got is not None:
        host = sorted(((e.key, e.self_cpu_time_total, e.count)
                       for e in got[0].key_averages()),
                      key=lambda r: -r[1])[:10]
        res["top_host_ops_self_ms_calls"] = {
            k[:60]: [us / 1e3, n] for k, us, n in host}
    return res


# ---------------------------------------------------------------------------
# PIM-protected serving and the BER campaign
# ---------------------------------------------------------------------------


def phase_pim_serving(device, cfg, params, prompts) -> tuple[dict, dict]:
    """paper-pim-2b served with its mlp_down and attn_o projections on the
    protected PIM path (`PIMContext(cfg.pim)`: wl320_r08, n_iters 4,
    damping 0.3, row parallelism 64) and the protected KV cache of phase
    8, on phase 8's model and prompts. First, for each target at the
    path's prefill and decode-step shapes: the MAC against its plain
    version, and the whole protected matmul on the card against the plain
    CPU run under the same output noise (PIM_CHECK_NOISE), exactly. Then,
    launch counts reset: `encode_params_for_pim` on the card, layer 0's cells
    against the plain CPU encode of the same ternary weights, and
    prefill plus PIM_STEPS greedy decode steps three times: (a)
    fault-free, (b) PIM output errors at PIM_FAULT_RATE corrected, (c)
    the same errors with protection off. (b) must give (a)'s tokens and
    logits bit for bit with no uncorrected word, (c)'s logits must
    differ. Returns (report, the launches of the precode and the three
    runs); one clean step is profiled after the count is read."""
    import dataclasses
    import torch
    from repro_torch.core import (PIMConfig, PIMContext, ProtectionConfig,
                                  prepare_weights, protected_pim_matmul,
                                  strip_padding)
    from repro_torch.kernels import build, pim_mac as mac
    from repro_torch.models import ProtectedKVConfig, encode_params_for_pim
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    B, S = prompts.shape
    n_layers = cfg.n_groups * len(cfg.group_spec)
    spec = cfg.pim
    code = PIMContext(spec).code
    n_enc = -(-cfg.d_model // code.k) * code.n     # output columns + checks

    # each protected projection at the path's prefill and decode-step
    # shapes, on seeded ternary weights: the MAC against its plain
    # version, then the whole protected matmul (MAC, check, decode) on the
    # card against the plain CPU run under the same output noise, exactly
    mac_checks, card_vs_cpu = {}, {}
    prot = ProtectionConfig(code_name=spec.code_name, mode="correct",
                            n_iters=spec.n_iters, damping=spec.damping)
    pim_cfg = PIMConfig(row_parallelism=spec.row_parallelism,
                        adc_levels=spec.adc_levels, p=code.p)
    kw = dict(row_parallelism=spec.row_parallelism,
              adc_levels=spec.adc_levels)

    def info(y):                          # the data cells of each word
        return y.reshape(y.shape[0], -1, code.n)[..., :code.k].reshape(
            y.shape[0], -1)[:, :cfg.d_model]

    blk = params.block(0, 0)
    for target, n_in in (("mlp_down", blk.mlp.w_down.shape[0]),
                         ("attn_o", blk.attn.wo.shape[0])):
        W = torch.randint(-1, 2, (n_in, cfg.d_model), generator=gen,
                          device=device, dtype=torch.int8)
        w = prepare_weights(W, code)
        x = torch.randint(-7, 8, (B * S, n_in), generator=gen,
                          device=device, dtype=torch.int8)
        hit = torch.rand((B * S, n_enc), generator=gen,
                         device=device) < PIM_CHECK_NOISE
        sign = torch.randint(0, 2, hit.shape, generator=gen, device=device)
        noise = (hit * (2 * sign - 1)).to(torch.int32)
        for rows in (B * S, B):           # the prefill's and a decode step's
            shape = f"{rows}x{n_in}x{n_enc}"
            got = mac.pim_mac(x[:rows], w, **kw)
            want = mac.pim_mac_plain(x[:rows], w, **kw)
            if not torch.equal(got, want):
                raise AssertionError(f"pim_mac at {shape} differs from its "
                                     f"plain version")
            mac_checks[shape] = {
                "max_abs_err": float((got - want).abs().max()),
                "device_ms": device_ms(
                    lambda r=rows, x=x, w=w: mac.pim_mac(x[:r], w, **kw),
                    "pim_mac", 20)}
            args = (code, prot, pim_cfg)
            res = protected_pim_matmul(x[:rows], w, *args,
                                       out_noise=noise[:rows])
            ref = protected_pim_matmul(x[:rows].cpu(), w.cpu(), *args,
                                       out_noise=noise[:rows].cpu())
            for part, a, b in zip(res._fields, res, ref, strict=True):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{target} protected matmul at "
                                         f"{shape}: {part} on the card "
                                         f"differs from the CPU")
            clean = info(want)            # the systematic code: x @ W
            card_vs_cpu[f"{target} {shape}"] = {
                "words": res.detected.numel(),
                "detected_words": int(res.detected.sum()),
                "uncorrected_words": int(res.uncorrected.sum()),
                "outputs_wrong_before": float(
                    (info(want + noise[:rows]) != clean).float().mean()),
                "outputs_wrong_after": float(
                    (strip_padding(res.y, cfg.d_model) != clean)
                    .float().mean())}
            if card_vs_cpu[f"{target} {shape}"]["detected_words"] == 0:
                raise AssertionError(f"{target} at {shape}: the check noise "
                                     f"flagged no word")
        del W, w, x, noise, hit, sign
    log(f"  pim_mac at the serving shapes (exact): {json.dumps(mac_checks)}")
    log(f"  protected matmul at the serving shapes, card == CPU under "
        f"{PIM_CHECK_NOISE} output noise: {json.dumps(card_vs_cpu)}")

    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=16)
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    encode_params_for_pim(params, cfg)
    torch.cuda.synchronize()
    precode_s = time.perf_counter() - t0
    precode_launches = dict(build.LAUNCHES)
    for module, name in ((blk.mlp, "w_down"), (blk.attn, "wo")):
        Wq, _ = PIMContext.ternarize(getattr(module, name))
        want = prepare_weights(Wq.to(torch.int8).cpu(), code)
        if not torch.equal(getattr(module, f"{name}_enc").cpu(), want):
            raise AssertionError(f"layer 0 {name}_enc differs from the "
                                 f"plain CPU encode")
    leaves = params.pim_leaves()
    enc_bytes = sum(t.numel() for k, ts in leaves.items()
                    if k.endswith("_enc") for t in ts)

    ctxs = {"clean": PIMContext(spec),
            "faulted": PIMContext(spec).with_faults(SEED, PIM_FAULT_RATE),
            "unprotected": PIMContext(dataclasses.replace(
                spec, mode="off")).with_faults(SEED, PIM_FAULT_RATE)}
    runs = {name: serve_once(params, cfg, prompts, pkv, inject=False,
                             pim_ctx=ctx, steps=PIM_STEPS)
            for name, ctx in ctxs.items()}
    launches = dict(build.LAUNCHES)

    report = {"arch": cfg.name, "layers": n_layers, "batch": B,
              "prompt_tokens": S, "decode_steps": PIM_STEPS,
              "pim_code": spec.code_name, "targets": list(spec.targets),
              "n_iters": spec.n_iters, "row_parallelism":
                  spec.row_parallelism, "kv_code": pkv.code_name,
              "fault_rate": PIM_FAULT_RATE, "precode_s": precode_s,
              "precode_launches": precode_launches,
              "encoded_int8_bytes": enc_bytes,
              "enc_shapes": {k: [len(ts), *ts[0].shape]
                             for k, ts in leaves.items()},
              "mac_checks": mac_checks}
    for name, r in runs.items():
        steps = r["per_step"]
        report[name] = {k: r[k] for k in (
            "ttft_s", "decode_s", "prefill_tokens_per_s",
            "decode_tokens_per_s", "ms_per_decode_step")}
        report[name]["pim"] = ctxs[name].stats()
        report[name]["launches_per_step_mean"] = {
            k: sum(st.get(k, 0) for st in steps) / len(steps)
            for k in sorted({k for st in steps for k in st})}
    clean, bad, off = runs["clean"], runs["faulted"], runs["unprotected"]
    report["unprotected_logit_drift"] = {
        "max_abs": float((off["logits"] - clean["logits"]).abs().max()),
        "tokens_equal_share": float(
            (off["tokens"] == clean["tokens"]).float().mean())}
    log(f"  pim serving: {json.dumps(report)}")

    fault_stats = report["faulted"]["pim"]
    if fault_stats["uncorrected_words"] != 0:
        raise AssertionError(f"faulted PIM run: uncorrected words "
                             f"{fault_stats}")
    if fault_stats["detected_words"] <= 0:
        raise AssertionError("faulted PIM run: no word was flagged")
    if not torch.equal(bad["tokens"], clean["tokens"]) or not torch.equal(
            bad["logits"], clean["logits"]):
        err = float((bad["logits"] - clean["logits"]).abs().max())
        raise AssertionError(f"faulted PIM run differs from the fault-free "
                             f"run (logits max abs {err})")
    if torch.equal(off["logits"], clean["logits"]):
        raise AssertionError("unprotected PIM run under faults equals the "
                             "fault-free run: the faults did not bite")
    for name, r in runs.items():
        counts = [st.get("attend_protected", 0) for st in r["per_step"]]
        if counts != [n_layers] * PIM_STEPS:
            raise AssertionError(f"{name} PIM run: attend_protected "
                                 f"launches per step {counts}")
        del r["caches"]
    report["profile_step"] = profile_decode_step(params, cfg, prompts, pkv,
                                                 PIMContext(spec))
    log(f"  pim serving, one clean step profiled: "
        f"{json.dumps(report['profile_step'])}")
    return report, launches


# ---------------------------------------------------------------------------
# the multi-tenant serving engine
# ---------------------------------------------------------------------------


def engine_prompts(cfg) -> list:
    """ENGINE_TENANTS prompts drawn with numpy from SEED, their lengths
    cycling through ENGINE_PROMPT_LENS (two tenants of each)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    return [rng.integers(0, cfg.vocab_size,
                         ENGINE_PROMPT_LENS[t % len(ENGINE_PROMPT_LENS)])
            for t in range(ENGINE_TENANTS)]


def check_pool_scrub(pool) -> dict:
    """Copies of SCRUB_CHECK_PAGES allocated pages of `pool`, taken at an
    even stride so that every owner has some, scrubbed on the card and on
    the CPU, coalesced and page by page: the four reports and the four
    sets of pages must be equal."""
    import torch
    allocated = pool.allocated()
    pids = allocated[::max(1, len(allocated) // SCRUB_CHECK_PAGES)][
        :SCRUB_CHECK_PAGES]
    now = max(pool.stamp(pid) for pid in pids)   # the engine's step
    reports, pages, secs = {}, {}, {}
    for dev in (pool.device, torch.device("cpu")):
        for coalesce in (True, False):
            copy = pool.copy(pids, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep = copy.scrub(now=now, coalesce=coalesce)
            torch.cuda.synchronize()
            key = f"{dev.type}_{'coalesced' if coalesce else 'per_page'}"
            secs[key] = time.perf_counter() - t0
            reports[key] = rep
            pages[key] = torch.stack([copy.page(p).cpu() for p in pids])
    first = next(iter(reports))
    for key, rep in reports.items():
        if rep != reports[first] or not torch.equal(pages[key],
                                                    pages[first]):
            raise AssertionError(f"pool scrub {key} differs from {first}: "
                                 f"{rep} against {reports[first]}")
    if reports[first]["flagged_words"] <= 0:
        raise AssertionError("pool scrub check: the copied pages hold no "
                             "flagged word")
    return {"pages": len(pids), "report": {
        k: v for k, v in reports[first].items() if k != "by_owner"},
        "owners": sorted(map(str, reports[first]["by_owner"])),
        "seconds": secs}


def check_fused_read(eng) -> dict:
    """One layer's fused `BatchedPagedKV.attend` on the card mid-run, at
    the run's ragged page counts, against `attend_protected_plain` on the
    same operands (phase 2's tolerance). Returns the check's fields and
    the kernel launches it made."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import paged_attention as pa
    layer = eng.caches.layers[(0, 0)]
    counts = sorted({len(m) for m, s in zip(layer.metas, eng.slots)
                     if s is not None})
    if len(counts) < 2:
        raise AssertionError(f"fused read check: page counts {counts} are "
                             f"not ragged")
    cfg = eng.cfg
    gen = torch.Generator(device=layer.device).manual_seed(SEED + 14)
    q = torch.randn((eng.max_active, 1, cfg.n_heads, cfg.head_dim),
                    generator=gen, device=layer.device).to(torch.bfloat16)
    before = dict(build.LAUNCHES)
    got = layer.attend(q)
    made = {k: v - before.get(k, 0) for k, v in build.LAUNCHES.items()
            if v - before.get(k, 0)}
    ops = layer.fused_inputs()
    want = pa.attend_protected_plain(
        q, *ops, layer.hot_k, layer.hot_v, layer._hot_len_dev,
        p=layer.code.p, k_info=layer.code.k, page_shape=layer.page_shape,
        with_hot=True)
    diff = (got.float() - want.float()).abs()
    if not torch.isfinite(got.float()).all() or bool(
            (diff > ULP_ATOL + ULP_RTOL * want.float().abs()).any()):
        raise AssertionError(f"engine fused read differs from its plain "
                             f"version (max abs {float(diff.max())})")
    return {"NP": int(ops[0].shape[0]), "slot_pages": counts,
            "max_abs_err": float(diff.max())}, made


def run_engine(params, cfg, prompts, *, tenants=None, protected=True,
               capacity=None, inject_at=None, scrub_every=0, check_at=None,
               profile_at=None, check_scrub=True, profile_cpu=False,
               setup=None, stop_after=None, mesh=None) -> dict:
    """Serve `prompts` (tenants `tenants`, all by default) through a
    `ServingEngine` at ENGINE_SLOTS slots and ENGINE_MAX_SEQ, ENGINE_NEW
    greedy tokens each. Options: the pool's capacity; `uniform_flip(3,
    ENGINE_FLIP)` injected after step `inject_at` (and, with
    `check_scrub`, a copy of the pool's pages scrubbed on the card and the
    CPU there); the scrub cadence; one layer's fused read checked before
    step `check_at`; step `profile_at` under torch.profiler (host ops too
    with `profile_cpu`, and the names of the `engine.*` ranges it saw
    kept); `setup(engine)` called before the first step; stop after
    `stop_after` steps; the default pool's pages sharded over `mesh`.
    Returns tokens, step reports and times, TTFT, launches by step, pool
    and scrub figures."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.memory import (ProtectedPagePool, uniform_flip,
                                    words_for_tensor)
    from repro_torch.models import ProtectedKVConfig
    from repro_torch.serving import ServingEngine
    pkv = ProtectedKVConfig("wl160_r08", page_tokens=16, n_iters=8,
                            mesh=mesh)
    kw = dict(max_active=ENGINE_SLOTS, max_seq=ENGINE_MAX_SEQ,
              protected=protected, scrub_every=scrub_every,
              scrub_max_pages=ENGINE_SCRUB_PAGES)
    if protected:
        kw["pkv"] = pkv
    if protected and capacity is not None:     # else the engine's default
        from repro_torch.core import get_code
        code = get_code(pkv.code_name)
        wpu = words_for_tensor((1, pkv.page_tokens, cfg.n_kv_heads,
                                cfg.head_dim), code.p, code.k)
        kw["pool"] = ProtectedPagePool(code, page_words=wpu,
                                       capacity_pages=capacity,
                                       n_iters=pkv.n_iters,
                                       damping=pkv.damping,
                                       device=params.device)
    eng = ServingEngine(params, cfg, **kw)
    if setup is not None:
        setup(eng)
    if protected and eng.pool.page_words != ENGINE_PAGE_WORDS:
        raise AssertionError(f"engine pages of {eng.pool.page_words} words,"
                             f" phase 2 checks {ENGINE_PAGE_WORDS}")
    scrub_s = []
    if protected and scrub_every:
        scrub = eng.pool.scrub

        def timed_scrub(**skw):
            t0 = time.perf_counter()
            rep = scrub(**skw)
            torch.cuda.synchronize()
            scrub_s.append(time.perf_counter() - t0)
            return rep
        eng.pool.scrub = timed_scrub
    tenants = list(range(len(prompts))) if tenants is None else tenants
    for t in tenants:
        eng.submit(t, prompts[t], max_new=ENGINE_NEW)
    out = {"steps": [], "reports": [], "launches": [], "first_token": {},
           "checks": {}}
    extra = {}                      # launches made by the checks
    torch.cuda.synchronize()
    t_run = time.perf_counter()
    while eng.waiting or any(s is not None for s in eng.slots):
        i = len(out["steps"])
        if i == stop_after:
            break
        if i > ENGINE_MAX_STEPS:
            raise AssertionError(f"engine run: not done after {i} steps: "
                                 f"{eng.stats()}")
        if i == check_at:
            t0 = time.perf_counter()
            out["checks"]["fused_read"], made = check_fused_read(eng)
            t_run += time.perf_counter() - t0      # not the run's time
            for k, v in made.items():
                extra[k] = extra.get(k, 0) + v
        before = dict(build.LAUNCHES)
        t0 = time.perf_counter()
        if i == profile_at:
            reps = []
            got = profiled_device(lambda: reps.append(eng.step()),
                                  cpu=profile_cpu)
            rep = reps[-1]
            fields, _ = busy_report(got, "step_wall_ms_profiled", 8)
            out["profile_step"] = {**fields, "steps_profiled": len(reps)}
            if got is not None:
                out["profile_names"] = sorted(
                    {e.key for e in got[0].key_averages()
                     if e.key.startswith("engine.")})
            out["steps"].extend([None] * (len(reps) - 1))
            out["reports"].extend(reps[:-1])
            dt = None
        else:
            rep = eng.step()
            dt = time.perf_counter() - t0
        done_at = time.perf_counter() - t_run
        out["steps"].append(dt and {"s": dt, "tokens": rep["tokens"]})
        out["reports"].append(rep)
        out["launches"].append({k: v - before.get(k, 0)
                                for k, v in build.LAUNCHES.items()
                                if v - before.get(k, 0)})
        for s in eng.sequences:
            if s.generated and s.tenant not in out["first_token"]:
                out["first_token"][s.tenant] = (len(out["steps"]), done_at)
        if inject_at is not None and len(out["steps"]) == inject_at:
            owners = sorted({eng.pool.owner(pid)
                             for pid in eng.pool.allocated()})
            out["inject"] = {
                "cells": eng.inject(uniform_flip(3, ENGINE_FLIP), SEED),
                "owners": owners, "pool_pages": eng.pool.n_allocated}
            if check_scrub:
                ex, t0 = dict(build.LAUNCHES), time.perf_counter()
                out["checks"]["pool_scrub"] = check_pool_scrub(eng.pool)
                t_run += time.perf_counter() - t0  # not the run's time
                for k, v in build.LAUNCHES.items():
                    extra[k] = extra.get(k, 0) + v - ex.get(k, 0)
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t_run
    out["check_launches"] = extra
    out["tokens"] = {s.tenant: list(s.generated) for s in eng.sequences}
    out["stats"] = eng.stats()
    out["tenant_stats"] = {t: eng.tenant_stats(t) for t in tenants}
    if protected:
        out["peak_pages"] = eng.pool.peak_allocated
        out["page_bytes"] = eng.pool.page_bytes
        out["capacity_pages"] = eng.pool.capacity_pages
        out["pool_allocated_at_end"] = eng.pool.n_allocated
        out["scrub_reports"] = eng.scrub_reports
        out["scrub_s"] = scrub_s
    return out


def engine_summary(r: dict) -> dict:
    """A run's logged figures: ms an engine step (median over the timed
    steps), aggregate decode tokens/s, TTFT by tenant (steps, s), the
    pool's peak, launches a step by kernel, and the scrub's time."""
    timed = [s for s in r["steps"] if s]
    step_s = sorted(s["s"] for s in timed)
    tokens = sum(s["tokens"] for s in timed)
    n = len(r["launches"])
    kernels = sorted({k for st in r["launches"] for k in st})
    out = {"steps": len(r["steps"]), "run_s": r["run_s"],
           "ms_per_step_median": 1e3 * step_s[len(step_s) // 2],
           "ms_per_step_max": 1e3 * step_s[-1],
           "decode_tokens_per_s": tokens / sum(step_s),
           "ttft": {str(t): {"steps": st, "s": s}
                    for t, (st, s) in sorted(r["first_token"].items())},
           "launches_per_step": {k: sum(st.get(k, 0)
                                        for st in r["launches"]) / n
                                 for k in kernels},
           "launches": {k: sum(st.get(k, 0) for st in r["launches"])
                        for k in kernels},
           "stats": r["stats"]}
    if "peak_pages" in r:
        out["peak_pages"] = r["peak_pages"]
        out["peak_bytes"] = r["peak_pages"] * r["page_bytes"]
        out["capacity_pages"] = r["capacity_pages"]
    if r.get("scrub_s"):
        out["scrub_ms_median"] = 1e3 * sorted(r["scrub_s"])[
            len(r["scrub_s"]) // 2]
        out["scrubs"] = len(r["scrub_s"])
    for key in ("profile_step", "inject", "checks"):
        if key in r:
            out[key] = r[key]
    return out


def check_injected_run(name: str, r: dict, want: dict) -> None:
    """An injected engine run must give the clean run's tokens, drain its
    pool, correct exactly the tenants that owned pages at the injection,
    leave no word uncorrected and repair something in its scrubs."""
    if r["tokens"] != want:
        raise AssertionError(f"{name} engine run: tokens differ from the "
                             f"clean run's")
    if r["pool_allocated_at_end"] != 0:
        raise AssertionError(f"{name} engine run: the pool did not drain")
    owners = set(r["inject"]["owners"])
    for t, st in r["tenant_stats"].items():
        if st["uncorrectable"] or st["scrub_flagged"] != st["scrub_repaired"]:
            raise AssertionError(f"{name} engine run: tenant {t} left "
                                 f"words uncorrected: {st}")
        if (st["detected"] > 0) != (t in owners) or st["corrected"] != \
                st["detected"]:
            raise AssertionError(f"{name} engine run: tenant {t}'s "
                                 f"corrections {st}, page owners at the "
                                 f"injection {sorted(owners)}")
    if sum(x["repaired_words"] for x in r["scrub_reports"]) <= 0:
        raise AssertionError(f"{name} engine run: the scrub repaired "
                             f"nothing")


def phase_engine(device, cfg, params) -> tuple[dict, dict, dict]:
    """The multi-tenant serving engine on phase 8's model: ENGINE_TENANTS
    tenants (prompts of ENGINE_PROMPT_LENS tokens, two of each) through
    ENGINE_SLOTS slots and one shared wl160_r08 page pool, ENGINE_NEW
    greedy tokens each, five runs: (a) clean; (b) tenant 0 alone, which
    must give (a)'s tokens for tenant 0; (c) `uniform_flip(3,
    ENGINE_FLIP)` injected after step ENGINE_INJECT_STEP with a scrub of
    ENGINE_SCRUB_PAGES pages every ENGINE_SCRUB_EVERY steps, which must
    give (a)'s tokens, corrections on exactly the tenants that owned pages
    then, none left, and scrub repairs; (d) the pool cut to
    ENGINE_PREEMPT_SHARE of (a)'s peak, which must preempt and give (a)'s
    tokens and drain the pool; (e) unprotected (`protected=False`),
    tokens logged. Mid-run checks: one layer's fused read against its
    plain version in (a), and a copy of the pool's pages scrubbed on the
    card and the CPU after (c)'s injection. Returns (report, the launches
    of the five runs less the checks', the runs)."""
    from repro_torch.kernels import build
    prompts = engine_prompts(cfg)
    build.reset_launches()
    runs = {"clean": run_engine(params, cfg, prompts,
                                check_at=ENGINE_CHECK_STEP,
                                profile_at=ENGINE_PROFILE_STEP)}
    runs["alone"] = run_engine(params, cfg, prompts, tenants=[0])
    runs["injected"] = run_engine(params, cfg, prompts,
                                  inject_at=ENGINE_INJECT_STEP,
                                  scrub_every=ENGINE_SCRUB_EVERY)
    peak = runs["clean"]["peak_pages"]
    runs["preempted"] = run_engine(
        params, cfg, prompts, capacity=int(ENGINE_PREEMPT_SHARE * peak))
    runs["unprotected"] = run_engine(params, cfg, prompts, protected=False)
    launches = dict(build.LAUNCHES)
    for r in runs.values():
        for k, v in r["check_launches"].items():
            launches[k] -= v

    report = {"arch": cfg.name, "tenants": ENGINE_TENANTS,
              "prompt_lens": [len(p) for p in prompts],
              "slots": ENGINE_SLOTS, "max_seq": ENGINE_MAX_SEQ,
              "new_tokens": ENGINE_NEW, "code": "wl160_r08",
              "page_tokens": 16, "launches": launches}
    for name, r in runs.items():
        report[name] = engine_summary(r)
    log(f"  engine: {json.dumps(report)}")

    clean, inj = runs["clean"], runs["injected"]
    want = clean["tokens"]
    if sorted(want) != list(range(ENGINE_TENANTS)) or any(
            len(v) != ENGINE_NEW for v in want.values()):
        raise AssertionError(f"clean engine run: tokens {want}")
    for name in ("clean", "preempted"):
        if runs[name]["pool_allocated_at_end"] != 0:
            raise AssertionError(f"{name} engine run: the pool did not "
                                 f"drain")
    if runs["alone"]["tokens"][0] != want[0]:
        raise AssertionError("tenant 0 alone: tokens differ from the "
                             "multi-tenant run's")
    if runs["preempted"]["tokens"] != want:
        raise AssertionError("preempted engine run: tokens differ from the "
                             "clean run's")
    check_injected_run("injected", inj, want)
    if runs["preempted"]["stats"]["preemptions"] < 1:
        raise AssertionError("preempted engine run: nothing was preempted")
    report["unprotected_tokens_equal_share"] = sum(
        a == b for t in want for a, b in zip(
            want[t], runs["unprotected"]["tokens"][t])) / (
        ENGINE_TENANTS * ENGINE_NEW)
    return report, launches, runs


# ---------------------------------------------------------------------------
# telemetry and the sanitizer
# ---------------------------------------------------------------------------


def scrub_span_steps(tracer) -> list:
    """The steps (an `engine.step` span's `step` arg) whose span holds an
    `engine.scrub` span: children close, and so are recorded, before
    their parent."""
    steps, pending = [], 0
    for e in tracer.spans():
        if e["name"] == "engine.scrub":
            pending += 1
        elif e["name"] == "engine.step":
            if pending:
                steps.append(e["args"]["step"])
            pending = 0
    return steps


def telemetry_engine(cfg, params, runs, report14) -> dict:
    """Run (f): run (c)'s configuration with the three pillars installed
    (a `Tracer(torch_profiler=True)`), one step under torch.profiler. It
    must give (a)'s tokens and (c)'s corrections; its counters, gauges and
    spans must agree with the engine's own reports and schedule."""
    import tempfile
    from repro_torch import obs
    prompts = engine_prompts(cfg)
    reg, est = obs.MetricsRegistry(), obs.ErrorRateEstimator()
    tr = obs.Tracer(torch_profiler=True)
    engines, schedule = [], []

    def setup(eng):
        engines.append(eng)
        due = eng._due_for_scrub

        def recorded():
            interval = obs.current_estimator().adaptive_interval(
                eng.scrub_every)
            hit = due()
            schedule.append({"step": eng._step_no - 1, "interval": interval,
                             "due": hit})
            return hit
        eng._due_for_scrub = recorded

    with obs.use_metrics(reg), obs.use_tracer(tr), obs.use_estimator(est):
        r = run_engine(params, cfg, prompts, inject_at=ENGINE_INJECT_STEP,
                       scrub_every=ENGINE_SCRUB_EVERY, check_scrub=False,
                       profile_at=ENGINE_PROFILE_STEP, profile_cpu=True,
                       setup=setup)
        eng = engines[0]
        eng.publish_metrics()
    want = runs["clean"]["tokens"]
    check_injected_run("telemetry", r, want)
    snap = reg.snapshot()

    def value(name, **labels):
        return obs.MetricsRegistry.value(snap, name, **labels)

    counted = {
        "engine_steps": (value("engine_steps", layer="engine"),
                         len(r["reports"])),
        "engine_tokens": (value("engine_tokens", layer="engine"),
                          sum(x["tokens"] for x in r["reports"])),
        "pool_scrub_pages": (value("pool_scrub_pages", layer="pool"),
                             sum(x["pages"] for x in r["scrub_reports"])),
        "pool_scrub_flagged": (value("pool_scrub_flagged", layer="pool"),
                               sum(x["flagged_words"]
                                   for x in r["scrub_reports"]))}
    for name, (got, ref) in counted.items():
        if got != ref:
            raise AssertionError(f"telemetry run: {name} counts {got}, the "
                                 f"engine's reports {ref}")
    for t, st in r["tenant_stats"].items():
        for k, v in st.items():
            got = value(f"tenant_{k}", layer="engine", tenant=str(t))
            if got != v:
                raise AssertionError(f"telemetry run: gauge tenant_{k} of "
                                     f"tenant {t} is {got}, tenant_stats "
                                     f"{v}")
    steps = tr.spans("engine.step")
    if len(steps) != len(r["reports"]):
        raise AssertionError(f"telemetry run: {len(steps)} engine.step "
                             f"spans for {len(r['reports'])} steps")
    bad = [e for e in tr.spans("engine.decode") if e["args"]["depth"] != 1]
    if bad or not tr.spans("engine.decode"):
        raise AssertionError(f"telemetry run: engine.decode spans not at "
                             f"depth 1: {bad[:2]}")
    picked = [x["step"] for x in schedule if x["due"]]
    reported = [x["step"] for x in r["reports"] if "scrubbed_pages" in x]
    spanned = scrub_span_steps(tr)
    if not picked or not picked == reported == spanned:
        raise AssertionError(f"telemetry run: scrubs at {spanned} (spans),"
                             f" {reported} (reports), the schedule picked "
                             f"{picked}")
    names = set(r.get("profile_names", ()))
    want_names = {"engine.step", "engine.admit", "engine.decode",
                  "engine.sample_sync"}
    if not want_names <= names:
        raise AssertionError(f"torch.profiler saw {sorted(names)}, not "
                             f"{sorted(want_names)}")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "engine_trace.json")
        doc = tr.to_chrome_trace(path)
        trace_bytes = os.path.getsize(path)
    ests = est.snapshot()
    summary = engine_summary(r)
    return {
        "steps": len(r["reports"]), "scrub_steps": picked,
        "scrub_intervals": sorted({x["interval"] for x in schedule}),
        "scrubs": len(picked),
        "scrubs_fixed_cadence_run_c": len(runs["injected"]["scrub_reports"]),
        "scrub_pages_swept": counted["pool_scrub_pages"][0],
        "scrub_flagged": counted["pool_scrub_flagged"][0],
        "tenants": {str(t): {
            "raw_ber": ests.get(str(t), {}).get("raw_ber"),
            "stress": ests.get(str(t), {}).get("stress"),
            "flag_rate": ests.get(str(t), {}).get("flag_rate"),
            "pressure": est.pressure(str(t)),
            "corrected": r["tenant_stats"][t]["corrected"]}
            for t in sorted(r["tenant_stats"])},
        "regions": sorted(ests), "hot_regions": est.hot_regions(3),
        "adaptive_interval_default_region": est.adaptive_interval(
            ENGINE_SCRUB_EVERY),
        "ms_per_step_median": summary["ms_per_step_median"],
        "ms_per_step_median_run_c": report14["injected"][
            "ms_per_step_median"],
        "ms_per_step_median_run_a": report14["clean"]["ms_per_step_median"],
        "run_s": r["run_s"], "profile_names": sorted(names),
        "profile_step": r.get("profile_step"),
        "chrome_trace_events": len(doc["traceEvents"]),
        "chrome_trace_dropped": doc["otherData"]["dropped_events"],
        "chrome_trace_bytes": trace_bytes,
        "metric_series": sum(len(v["series"]) for v in snap.values()),
        "inject": r["inject"]}


def telemetry_memory(device) -> dict:
    """A TELEMETRY_MIB float32 tensor in a wl1024_r08 writeback array,
    `uniform_flip(3, TELEMETRY_FLIP)` injected, one read under a registry
    and an estimator: the read must be exact, the counters must agree with
    the read, and the estimated raw BER must be within RAW_BER_RTOL of the
    share of cells the injection changed."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.memory import ProtectedMemoryArray, uniform_flip
    gen = torch.Generator(device=device).manual_seed(SEED + 15)
    t = torch.randn(TELEMETRY_MIB * 2 ** 18, generator=gen, device=device)
    expect = t.cpu().numpy()
    mem = ProtectedMemoryArray("wl1024_r08", controller="writeback",
                               device=device, key=SEED + 15,
                               use_sharded=False)
    st = mem.write("t", t)
    words, cells = int(st.enc.shape[0]), int(st.enc.numel())
    changed = mem.inject(uniform_flip(3, TELEMETRY_FLIP))
    reg, est = obs.MetricsRegistry(), obs.ErrorRateEstimator()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with obs.use_metrics(reg), obs.use_estimator(est):
        out = mem.read("t")
    read_s = time.perf_counter() - t0
    if not np.array_equal(out.view(np.uint8), expect.view(np.uint8)):
        raise AssertionError("telemetry memory read differs from the "
                             "written bytes")
    snap = reg.snapshot()
    lab = dict(layer="controller", policy="writeback", code="gf3n1024")
    got = {k: obs.MetricsRegistry.value(snap, f"mem_{k}", **lab) for k in (
        "words_read", "detected", "corrected", "uncorrectable")}
    s = mem.stats
    if got["words_read"] != words or got["detected"] != s.detected or \
            got["corrected"] != got["detected"] - got["uncorrectable"] or \
            got["corrected"] != s.corrected:
        raise AssertionError(f"telemetry memory counters {got}, the read "
                             f"{s.correction_counts()}, {words} words")
    share = changed / cells
    raw = est.region("").raw_ber()
    if raw is None or abs(raw / share - 1.0) > RAW_BER_RTOL:
        raise AssertionError(f"estimated raw BER {raw} against the "
                             f"injected share {share}")
    return {"mib": TELEMETRY_MIB, "words": words, "cells": cells,
            "cells_changed": changed, "changed_share": share,
            "raw_ber_estimate": raw, "raw_ber_rel_err": raw / share - 1.0,
            "flag_rate": est.region("").flag_rate,
            "stress": est.region("").stress, "counters": got,
            "read_s": read_s}


def expect_sanitizer_error(fn, message: str, exact: bool) -> str:
    """Run `fn`, which must raise `SanitizerError` whose text is `message`
    (or starts with it)."""
    from repro_torch.analysis import SanitizerError
    try:
        fn()
    except SanitizerError as e:
        text = str(e)
        if text == message or (not exact and text.startswith(message)):
            return text
        raise AssertionError(f"sanitizer said {text!r}, not {message!r}")
    raise AssertionError(f"no SanitizerError: {message!r}")


def telemetry_sanitizer(device, cfg, params, want) -> dict:
    """The sanitizer on CUDA tensors: an out-of-field symbol in a 4,096-word
    wl1024_r08 page (the scan's words, the encode's lhs), a NaN query, a
    NaN hot K row and a negative scale at the serving shape must raise
    with the JAX package's text; a clean `attend_protected` must give the
    unsanitized bits and a decode of levels drifted below 0 must pass;
    `attend_protected`'s host ms a call with the checks off and on; and
    SANITIZED_STEPS engine steps of run (a)'s schedule under the sanitizer
    must give (a)'s first tokens."""
    import torch
    from repro_torch.analysis import use_sanitizer
    from repro_torch.core import decode_integers, encode_words, get_code
    from repro_torch.kernels import gf_matmul as gm
    from repro_torch.kernels import paged_attention as pa
    gen = torch.Generator(device=device).manual_seed(SEED + 16)
    code = get_code("wl1024_r08")
    u = torch.randint(0, code.p, (4096, code.k), generator=gen,
                      device=device, dtype=torch.int8)
    y = encode_words(u, code)
    y[17, 5] = code.p
    ht = code.tensor("H.T", device, torch.int8)
    P = code.tensor("P", device, torch.int8)
    args, kw = attend_operands(device, gen, B=4, Sq=1, Hq=32, Hkv=8, D=64,
                               T=16, NP=32, S=1, code=get_code("wl160_r08"))
    q, kp, vp, ks, vs, valid, hk, hv, hval = args
    bad_q = q.clone()
    bad_q[1, 0, 3, 7] = float("nan")
    bad_k = hk.clone()
    bad_k[2, 0] = float("nan")
    plain_out = pa.attend_protected(*args, **kw)
    out = {}
    with use_sanitizer():
        out["scan"] = expect_sanitizer_error(
            lambda: gm.scan_syndromes(y, ht, code.p),
            "sanitizer[scan_syndromes words]: GF symbol outside [0, 3): "
            "min=0, max=3", exact=True)
        out["gf_matmul"] = expect_sanitizer_error(
            lambda: gm.gf_matmul(y[:, :code.k], P, code.p),
            "sanitizer[gf_matmul lhs]: GF symbol outside [0, 3): min=0, "
            "max=3", exact=True)
        out["query"] = expect_sanitizer_error(
            lambda: pa.attend_protected(bad_q, *args[1:], **kw),
            "sanitizer[attend_protected query]: non-finite value "
            "(nan_count=1, inf_count=0)", exact=True)
        out["hot_k"] = expect_sanitizer_error(
            lambda: pa.attend_protected(q, kp, vp, ks, vs, valid, bad_k,
                                        hv, hval, **kw),
            "sanitizer[attend_protected output]: non-finite value "
            "(nan_count=", exact=False)
        neg = ks.clone()
        neg[5, 0] = -neg[5, 0]
        out["scale"] = expect_sanitizer_error(
            lambda: pa.attend_protected(q, kp, vp, neg, vs, valid, hk, hv,
                                        hval, **kw),
            "sanitizer[attend_protected K scales]: quantization scale must "
            f"be finite and >= 0 (zero marks an empty/padded page): "
            f"min={float(neg.min())}", exact=True)
        clean = pa.attend_protected(*args, **kw)
        if not torch.equal(clean.view(torch.int16),
                           plain_out.view(torch.int16)):
            raise AssertionError("attend_protected under the sanitizer "
                                 "differs from the unsanitized call")
        # zero codewords whose level drifted below 0 in one cell of every
        # fifth word: the decoder's outputs are checked, its input is not
        drift = torch.zeros((64, 160), dtype=torch.int32, device=device)
        drift[::5, 3] = -1
        _y, res = decode_integers(get_code("wl160_r08"), drift, n_iters=8,
                                  early_exit=True)
        if bool(res.detect_fail.any()) or bool(res.symbols.any()):
            raise AssertionError("decode of drifted levels did not give "
                                 "the zero codewords")
    def call():
        return pa.attend_protected(*args, **kw)

    # host ms (back-to-back calls, not waited for) and ms a call (CUDA
    # events around each call: host, launch and device), phase 2's two
    # measures, with the checks off and on
    host = {"off": host_ms(call, 200), "call_ms_off": cuda_ms(call, 50)}
    with use_sanitizer():
        host["on"] = host_ms(call, 200)
        host["call_ms_on"] = cuda_ms(call, 50)
        r = run_engine(params, cfg, engine_prompts(cfg),
                       stop_after=SANITIZED_STEPS)
    for t, toks in r["tokens"].items():
        if toks != want[t][:len(toks)]:
            raise AssertionError(f"sanitized engine steps: tenant {t} "
                                 f"{toks} against (a)'s {want[t]}")
    return {"messages": out, "attend_host_ms": host,
            "sanitized_steps": len(r["reports"]),
            "sanitized_tokens": sum(len(v) for v in r["tokens"].values())}


def phase_telemetry(device, cfg, params, runs, report14,
                    instruments_before: int) -> tuple[dict, dict]:
    """Phase 15 on phase 8's model, right after phase 14: no instrument
    built and no event recorded by runs (a)-(e) (telemetry off), run (f)
    with the three pillars, the memory-mode estimator against a known
    injected rate, and the sanitizer on CUDA tensors. Returns (report, the
    kernel launches of run (f) and the memory-mode read)."""
    from repro_torch import obs
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    made = obs.instrument_count() - instruments_before
    if made or obs.current_tracer().events():
        raise AssertionError(f"telemetry off: runs (a)-(e) built {made} "
                             f"instruments")
    build.reset_launches()
    report = {"instruments_built_by_runs_a_to_e": made,
              "engine": telemetry_engine(cfg, params, runs, report14),
              "memory": telemetry_memory(device)}
    launches = dict(build.LAUNCHES)
    report["sanitizer"] = telemetry_sanitizer(device, cfg, params,
                                              runs["clean"]["tokens"])
    report["seconds"] = time.perf_counter() - t0
    log(f"  telemetry: {json.dumps(report)}")
    return report, launches


def phase_campaign(device) -> tuple[dict, dict]:
    """The paper's BER comparison on the card: `run_campaign` of
    `paper_schemes(wl1024_r08)` (NB-LDPC decoding on the card, Hamming
    SECDED, the modulo checksum, no code) over CAMPAIGN_BERS at the JAX
    package's bench settings. Checks: an acceptance row exists and
    NB-LDPC improves >= 10x there; Hamming improves > 50x at 1e-4 and
    < 3x at 1e-2; the detect-only checksum improves nothing at 1e-3.
    Before the campaign, one draw's decode and residuals on the card are
    held against the CPU's on the same words. Then, logged only: the conditional residuals of wl1024_r088 for m =
    1..12 (the abstract's "corrects up to 8-bit errors at rate > 88%").
    Returns (report, the campaign's launches)."""
    import torch
    from repro_torch.core import get_code
    from repro_torch.kernels import build
    from repro_torch.memory import (NBLDPCScheme,
                                    conditional_residual_profile,
                                    paper_schemes, run_campaign,
                                    select_acceptance_row)
    from repro_torch.core import decode_integers
    schemes = paper_schemes(get_code("wl1024_r08"), device=device)
    # one draw of CAMPAIGN_TRIALS words at an error count near the
    # acceptance row (1e-2 of 1024 cells) and one past the code's
    # strength (3e-2): the card's decode and residuals against the CPU's
    # on the same words, exactly
    nb = schemes[0]                       # decodes where its words lie
    card_vs_cpu = {}
    for m in (10, 31):
        cw, y = nb.draw(m, CAMPAIGN_TRIALS, SEED)
        card = decode_integers(nb.code, y, **nb._decode_kw)
        ref = decode_integers(nb.code, y.cpu(), **nb._decode_kw)
        for a, b in zip((card[0], *card[1]), (ref[0], *ref[1]),
                        strict=True):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"campaign decode at m={m}: the card "
                                     f"differs from the CPU")
        r_card = nb.residuals_of(cw, y)
        r_cpu = nb.residuals_of(cw.cpu(), y.cpu())
        if r_card != r_cpu:
            raise AssertionError(f"campaign residuals at m={m}: card "
                                 f"{r_card}, CPU {r_cpu}")
        card_vs_cpu[m] = r_card
    log(f"  campaign draws, card == CPU (r_word, r_info by m): "
        f"{json.dumps(card_vs_cpu)}")
    build.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run_campaign(schemes, CAMPAIGN_BERS, trials=CAMPAIGN_TRIALS,
                       hamming_trials=CAMPAIGN_HAMMING_TRIALS, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    rows = out["rows"]
    acc = select_acceptance_row(rows)
    t1 = time.perf_counter()
    prof = conditional_residual_profile(
        NBLDPCScheme(get_code("wl1024_r088"), device=device), max_errors=12,
        seed=SEED)
    report = {"code": "wl1024_r08", "raw_bers": CAMPAIGN_BERS,
              "trials": CAMPAIGN_TRIALS,
              "hamming_trials": CAMPAIGN_HAMMING_TRIALS,
              "seconds": seconds, "rows": rows, "acceptance_row": acc,
              "card_vs_cpu_residuals": card_vs_cpu,
              "max_errors": {k: len(p.r_word) - 1
                             for k, p in out["profiles"].items()},
              "wl1024_r088_residuals": {
                  "r_word": prof.r_word.tolist(),
                  "r_info": prof.r_info.tolist(),
                  "seconds": time.perf_counter() - t1}}
    for r in rows:
        log(f"  campaign row: {json.dumps(r)}")
    log(f"  campaign: acceptance row {json.dumps(acc)}, {seconds} s")
    log(f"  wl1024_r088 residuals by m: "
        f"{json.dumps(report['wl1024_r088_residuals'])}")

    by = {(r["scheme"], r["raw_ber"]): r["improvement"] for r in rows}
    if acc is None or not acc["nbldpc_improvement"] >= 10.0:
        raise AssertionError(f"campaign acceptance row {acc}: NB-LDPC "
                             f"under 10x where Hamming saturates")
    if not (by[("hamming_secded", 1e-4)] > 50
            and by[("hamming_secded", 1e-2)] < 3):
        raise AssertionError(f"Hamming SECDED improvements {by}")
    if abs(by[("modulo_parity", 1e-3)] - 1.0) > 1e-6:
        raise AssertionError(f"modulo parity improves "
                             f"{by[('modulo_parity', 1e-3)]} at 1e-3")
    return report, launches


# ---------------------------------------------------------------------------
# flash attention: kernels, prefill, training
# ---------------------------------------------------------------------------

# B, Sq, Skv, Hq, Hkv, D, causal, window, softcap: the training shape
# (granite-3-2b, seq 4096, batch 2), the prefill shape (paper-pim-2b, 4 x
# 512), a ragged bidirectional case, a sliding window, a softcap of 2
FLASH_CASES = [
    ("training", (2, 4096, 4096, 32, 8, 64, True, 0, 0.0)),
    ("prefill", (4, 512, 512, 32, 8, 64, True, 0, 0.0)),
    ("ragged_bidirectional", (1, 1000, 1200, 32, 8, 64, False, 0, 0.0)),
    ("window256", (2, 4096, 4096, 32, 8, 64, True, 256, 0.0)),
    ("softcap2", (2, 1024, 1024, 32, 8, 64, True, 0, 2.0)),
]


def flash_costs(case, n_visible: int) -> dict:
    """(bytes, flops) of each flash kernel on `case`: every input read
    once and every output written once; 2 flops per multiply-add over the
    (q, k) pairs the mask lets through (`n_visible` per head): the forward
    does QK^T and PV (4 per pair and head dim), dq recomputes QK^T and
    dO V^T and takes dS K (6), dk/dv recompute both and take P^T dO and
    dS^T Q (8)."""
    B, Sq, Skv, Hq, Hkv, D = case[:6]
    q_bytes, kv_bytes, row_bytes = B * Hq * Sq * D * 2, B * Hkv * Skv * D * 2, \
        B * Hq * Sq * 4
    pairs = B * Hq * D * n_visible
    return {"flash_fwd": (2 * q_bytes + 2 * kv_bytes + row_bytes, 4 * pairs),
            "flash_bwd_dq": (3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                             6 * pairs),
            "flash_bwd_dkv": (2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
                              8 * pairs)}


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_timings(q, k, v, do, case) -> dict:
    """One PyTorch call computing the same function, timed as a yardstick
    and never used by the port: scaled_dot_product_attention forward and
    its autograd backward (dq, dk and dv together), under each backend of
    SDPA_BACKENDS that takes the case; the fastest of each is kept, with
    its name. Empty under a softcap, which SDPA does not take."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels import flash_attention as fa
    B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
    if cap:
        return {}
    q4, do4 = q.view(B, Hq, Sq, D), do.view(B, Hq, Sq, D)
    k4, v4 = k.view(B, Hkv, Skv, D), v.view(B, Hkv, Skv, D)
    mask = fa.flash_mask(Sq, Skv, causal, window, q.device) if window \
        else None
    kw = dict(attn_mask=mask, is_causal=causal and not window,
              scale=1.0 / D ** 0.5, enable_gqa=True)
    times = {}
    for name in SDPA_BACKENDS:
        try:
            with sdpa_kernel([getattr(SDPBackend, name)]), \
                    warnings.catch_warnings():
                warnings.simplefilter("ignore")    # why a backend declines
                fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, **kw), 10)
                leaves = [t.detach().clone().requires_grad_()
                          for t in (q4, k4, v4)]
                out = F.scaled_dot_product_attention(*leaves, **kw)
            bwd_ms = cuda_ms(lambda: torch.autograd.grad(
                out, leaves, do4, retain_graph=True), 10)
        except RuntimeError as e:      # the backend does not take the case
            log(f"  sdpa {name}: {str(e).splitlines()[0][:100]}")
            continue
        times[name] = (fwd_ms, bwd_ms)
        del out, leaves
    if not times:
        return {}
    fwd = min(times, key=lambda n: times[n][0])
    bwd = min(times, key=lambda n: times[n][1])
    return {"fwd_ms": times[fwd][0], "fwd_backend": fwd,
            "bwd_ms": times[bwd][1], "bwd_backend": bwd,
            "all_ms": times}


def phase_flash(device) -> dict:
    """flash_fwd, flash_bwd_dq and flash_bwd_dkv against their plain
    versions at FLASH_CASES: o to a few bf16 ulps (rtol 2^-7, atol
    2^-10), lse to rtol 1e-5, the gradients within FLASH_BWD_BOUND of the
    largest |gradient|; each timed beside its plain version, its bound
    and the SDPA yardstick."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=device).manual_seed(SEED)
    rows: dict[str, list] = {}
    for label, case in FLASH_CASES:
        B, Sq, Skv, Hq, Hkv, D, causal, window, cap = case
        q, do = (torch.randn((B * Hq, Sq, D), generator=gen, device=device)
                 .to(torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B * Hkv, Skv, D), generator=gen, device=device)
                .to(torch.bfloat16) for _ in range(2))
        kw = dict(g=Hq // Hkv, scale=1.0 / D ** 0.5, causal=causal,
                  window=window, softcap=cap)
        o, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa.flash_delta(o, do)
        dq = fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        o_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
        dq_p = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, **kw)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, **kw)
        diff = (o.float() - o_p.float()).abs()
        if not torch.isfinite(o.float()).all() or bool(
                (diff > ULP_ATOL + ULP_RTOL * o_p.float().abs()).any()):
            raise AssertionError(f"flash_fwd {label}: o differs from its "
                                 f"plain version by {float(diff.max())}")
        # lse to rtol 1e-5; atol 1e-5 for the rows with few keys, whose
        # lse is a single score near 0 and carries its fp32 dot product's
        # rounding (about 1e-6 at D = 64) and no more
        lse_off = (lse - lse_p).abs() - 1e-5 * lse_p.abs()
        if bool((lse_off > 1e-5).any()):
            raise AssertionError(f"flash_fwd {label}: lse off by "
                                 f"{float(lse_off.max())} past rtol 1e-5")
        errs = {"flash_fwd": float(diff.max())}
        # the backward's errors, absolute and relative to the largest
        # |gradient| of the plain version (dk and dv each against its own)
        rel = {}
        for name, pairs in (("flash_bwd_dq", ((dq, dq_p),)),
                            ("flash_bwd_dkv", ((dk, dk_p), (dv, dv_p)))):
            err = rel[name] = 0.0
            for got, want in pairs:
                e = float((got.float() - want.float()).abs().max())
                scale = float(want.float().abs().max())
                if not torch.isfinite(got.float()).all() or \
                        e > FLASH_BWD_BOUND * scale:
                    raise AssertionError(f"{name} {label}: off by {e}, "
                                         f"bound {FLASH_BWD_BOUND * scale}")
                err = max(err, e)
                rel[name] = max(rel[name], e / scale if scale else 0.0)
            errs[name] = err
        del o_p, lse_p, dq_p, dk_p, dv_p
        n_vis = int(fa.flash_mask(Sq, Skv, causal, window, device).sum())
        costs = flash_costs(case, n_vis)
        big = B * Hq * Sq * Skv > 2 ** 28
        reps, plain_reps = (3, 2) if big else (10, 3)
        calls = {
            "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                          lambda: fa.flash_fwd_plain(q, k, v, **kw)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, **kw),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta,
                                              **kw)),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, **kw),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               **kw))}
        sdpa = sdpa_timings(q, k, v, do, case)
        log(f"  sdpa {label}: {json.dumps(sdpa)}")
        for name, (kernel, plain) in calls.items():
            nbytes, flops = costs[name]
            b_ms, b_by = bound(nbytes, flops, BF16_OPS_PER_S)
            ms = cuda_ms(kernel, reps)
            row = {"name": name, "case": label,
                   "shape": dict(zip(("B", "Sq", "Skv", "Hq", "Hkv", "D",
                                      "causal", "window", "softcap"), case)),
                   "max_abs_err": errs[name], "ms": ms,
                   "plain_ms": cuda_ms(plain, plain_reps),
                   "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": sdpa.get("fwd_ms" if name == "flash_fwd"
                                          else "bwd_ms"),
                   "library_backend": sdpa.get(
                       "fwd_backend" if name == "flash_fwd"
                       else "bwd_backend"),
                   "gflop": flops / 1e9, "tflop_per_s": flops / ms / 1e9}
            if name in rel:
                row["rel_err"] = rel[name]
            rows.setdefault(name, []).append(row)
            log(f"  {name} {label}: {json.dumps(row)}")
        del q, k, v, do, o, lse, delta, dq, dk, dv
        torch.cuda.empty_cache()
    return rows


def exact_attend(q, k, v, mask, softcap, **_kw):
    """Attention with the softmax and its weights kept in fp32 (scores
    from bf16 inputs, which fp32 holds exactly, times 1/sqrt(D), the
    softcap, the mask, then fp32 weights times fp32 V), rounded to q's
    dtype once at the end: the function both the naive path (which rounds
    the weights to bf16) and the flash kernels (fp32 throughout, another
    order of sums) approximate. Phase 9's reference only; the port never
    calls it."""
    import torch
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (1.0 / D ** 0.5)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    if mask is not None:
        s = torch.where(mask[:, :, None], s, -1e30)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def _checked_attend(attend, ratios):
    """`attend` (layers._attend) that also holds each flash call's output
    against `exact_attend` on the same inputs: it appends to `ratios` the
    largest |out - exact| / (ULP_ATOL + ULP_RTOL * |exact|) of the flash
    output and, as a control, of the naive attention on those inputs."""
    import torch

    def ratio(out, ref):
        return float(((out.float() - ref).abs() / (
            ULP_ATOL + ULP_RTOL * ref.abs())).max())

    def checked(q, k, v, mask, softcap, *, impl="naive", causal=True,
                window=0):
        out = attend(q, k, v, mask, softcap, impl=impl, causal=causal,
                     window=window)
        if impl == "flash" and q.shape[1] > 1:
            qpos = torch.arange(q.shape[1], device=q.device)[:, None]
            kpos = torch.arange(k.shape[1], device=q.device)[None, :]
            ok = (kpos <= qpos) | (not causal)
            if window:
                ok &= kpos > qpos - window
            mask = ok[None, None]
            ref = exact_attend(q, k, v, mask, softcap).float()
            ratios.append({"flash": ratio(out, ref), "naive": ratio(
                attend(q, k, v, mask, softcap), ref)})
        return out
    return checked


def phase_prefill(device, cfg, params, prompts) -> tuple[dict, dict]:
    """Flash prefill of full paper-pim-2b on the serving prompts: `prefill`
    naive and under attn_impl="flash" (flash_fwd once per layer), timed,
    then checked against attention that keeps its softmax in fp32
    (`exact_attend`):

    - every layer's flash attention output in the real prefill, and in a
      one-layer copy at full width on seeds SEED and SEED + 1, against
      `exact_attend` on the same q/k/v within ULP_RTOL/ULP_ATOL (the
      naive attention on those inputs, which rounds its weights to bf16,
      is reported beside it as the control);
    - the one-layer copies' logits within PREFILL_EXACT_ATOL of an
      `exact_attend` prefill (the naive ones reported beside them);
    - the 24-layer logits no farther from an `exact_attend` prefill than
      the naive ones. Over 24 random-weight layers any two roundings of
      attention drift apart (0.2 between naive and flash), so the JAX
      package's 0.05 flash-vs-naive bound holds at model level only on
      its own case: `forward` of reduced gemma2-27b (window, softcaps,
      GQA) on 2 x 64 tokens, flash within PREFILL_LOGITS_ATOL of naive.

    Returns (report, the launches of the timed prefills)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models import forward, init_params, prefill
    from repro_torch.nn import layers
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    n_layers = cfg.n_groups * len(cfg.group_spec)
    out, secs = {}, {}
    build.reset_launches()
    for name, c in (("naive", cfg), ("flash", flash_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = prefill(params, c, prompts)[0]
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        if name == "naive" and build.LAUNCHES["flash_fwd"]:
            raise AssertionError("the naive prefill launched flash_fwd")
    launches = dict(build.LAUNCHES)

    attend, ratios = layers._attend, []
    one = dataclasses.replace(cfg, n_groups=1)
    one_dist, one_naive = {}, {}
    try:
        with torch.no_grad():
            layers._attend = _checked_attend(attend, ratios)
            prefill(params, flash_cfg, prompts)
            layers._attend = exact_attend
            ref = prefill(params, cfg, prompts)[0]
            for seed in (SEED, SEED + 1):
                one_params = init_params(one, seed, device=device)
                layers._attend = _checked_attend(attend, ratios)
                got = prefill(one_params, dataclasses.replace(
                    one, attn_impl="flash"), prompts)[0]
                layers._attend = attend
                naive = prefill(one_params, one, prompts)[0]
                layers._attend = exact_attend
                exact = prefill(one_params, one, prompts)[0]
                one_dist[seed] = float((got - exact).abs().max())
                one_naive[seed] = float((naive - exact).abs().max())
                del one_params, got, naive, exact
    finally:
        layers._attend = attend
    dist = {name: float((out[name] - ref).abs().max()) for name in out}

    small = get_config("gemma2_27b").reduced()
    small_params = init_params(small, SEED, device=device)
    toks = torch.randint(0, small.vocab_size, (2, 64), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(SEED))
    with torch.no_grad():
        small_diff = float((forward(small_params, small, toks) - forward(
            small_params, dataclasses.replace(small, attn_impl="flash"),
            toks)).abs().max())
    layer_ratio = {k: [r[k] for r in ratios] for k in ("flash", "naive")}
    report = {"batch": tuple(prompts.shape)[0],
              "prompt_tokens": tuple(prompts.shape)[1],
              "naive_s": secs["naive"], "flash_s": secs["flash"],
              "max_abs_logit": float(out["naive"].abs().max()),
              "flash_vs_naive": float((out["flash"] - out["naive"])
                                      .abs().max()),
              "flash_vs_fp32_softmax": dist["flash"],
              "naive_vs_fp32_softmax": dist["naive"],
              "layer_ulp_ratio_flash_max": max(layer_ratio["flash"]),
              "layer_ulp_ratio_naive_min": min(layer_ratio["naive"]),
              "layer_ulp_ratio_naive_max": max(layer_ratio["naive"]),
              "one_layer_flash_vs_fp32_softmax": one_dist,
              "one_layer_naive_vs_fp32_softmax": one_naive,
              "argmax_agree_flash_naive": float(
                  (out["flash"].argmax(-1) == out["naive"].argmax(-1))
                  .float().mean()),
              "reduced_gemma2_flash_vs_naive": small_diff,
              "flash_fwd_launches": launches.get("flash_fwd", 0)}
    log(f"  prefill: {json.dumps(report)}")
    if launches.get("flash_fwd", 0) != n_layers:
        raise AssertionError(f"flash prefill launched flash_fwd "
                             f"{launches.get('flash_fwd', 0)} times, "
                             f"expected {n_layers}")
    if len(ratios) != n_layers + 2 or not max(layer_ratio["flash"]) <= 1:
        raise AssertionError(f"flash attention outputs of the prefill's "
                             f"layers are not within a few bf16 ulps of "
                             f"the fp32-softmax attention: {ratios}")
    if not max(one_dist.values()) <= PREFILL_EXACT_ATOL:
        raise AssertionError(f"one-layer flash prefill logits are "
                             f"{one_dist} from the fp32-softmax reference")
    if not torch.isfinite(out["flash"]).all() or not \
            dist["flash"] <= dist["naive"]:
        raise AssertionError(f"flash prefill logits are farther from the "
                             f"fp32-softmax reference ({dist['flash']}) "
                             f"than the naive ones ({dist['naive']})")
    if not small_diff < PREFILL_LOGITS_ATOL:
        raise AssertionError(f"reduced gemma2: flash differs from naive by "
                             f"{small_diff}")
    return report, launches


# ---------------------------------------------------------------------------
# phase 16: the rest of the LM substrate (MoE, mamba, encoder-decoder, cross)
# ---------------------------------------------------------------------------


def _moe_margins():
    """Wrap `nn.moe.topk_route` to record each token's gap between its
    K-th and (K+1)-th router logit, in bf16 ulps at the row's largest
    |logit|. Returns (the list it appends to, a function that undoes the
    wrap)."""
    import torch
    from repro_torch.nn import moe
    margins, route = [], moe.topk_route

    def recording(logits, k):
        if k < logits.shape[1]:
            top = torch.sort(logits, dim=-1, descending=True)[0]
            ulp = torch.finfo(torch.bfloat16).eps * logits.abs().amax(-1)
            margins.append(((top[:, k - 1] - top[:, k]) / ulp.clamp_min(
                torch.finfo(torch.bfloat16).tiny)).cpu())
        return route(logits, k)

    moe.topk_route = recording
    return margins, lambda: setattr(moe, "topk_route", route)


def _routing_card_vs_cpu(device, cfg, layer, x) -> dict:
    """The first MoE layer's routing of `x` on the card and on the CPU
    from the same float32 router logits (the card's), and from logits with
    constructed ties: top-k, gate weights, the sort, `keep` and the buffer
    rows equal exactly."""
    import torch
    from repro_torch.nn import moe
    logits = moe.router_logits(layer, x)
    T, E = logits.shape
    tied = torch.round(torch.randn((T, E), generator=torch.Generator(
        device=device).manual_seed(SEED), device=device) * 2) / 2
    tied[0] = 1.0
    out = {}
    for name, lg in (("router", logits), ("tied", tied)):
        cap = moe.capacity(T, cfg)
        got = moe.topk_route(lg, cfg.top_k)
        want = moe.topk_route(lg.cpu(), cfg.top_k)
        plan = moe.dispatch(got[0], E, cap)
        plan_cpu = moe.dispatch(want[0], E, cap)
        pairs = [(got[0], want[0]), (got[1], want[1])] + [
            (a, b) for a, b in zip(plan[:5], plan_cpu[:5], strict=True)]
        if not all(torch.equal(a.cpu(), b) for a, b in pairs):
            raise AssertionError(f"{cfg.name}: MoE routing or dispatch on "
                                 f"the card differs from the CPU's ({name} "
                                 f"logits)")
        out[name] = {"tokens": T, "capacity": cap,
                     "dropped": int((~plan.keep).sum())}
    return out


def phase_substrate_reduced(device) -> dict:
    """(a) each of SUBSTRATE_ARCHS at `.reduced()`, the same weights on the
    card and on the CPU: logits to LOGITS_ULPS (a row beyond it only where
    a router near-tie may have sent a token to another expert, at most one
    in 16), MoE routing exact on the same router logits, prefill/decode
    consistency at the JAX test's tolerances, and one training step on the
    card with a finite loss."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train
    from repro_torch.models import (decode_step, forward, init_params,
                                    prefill)
    report = {}
    for arch in SUBSTRATE_ARCHS:
        cfg = get_config(arch).reduced()
        cpu_model = init_params(cfg, SEED, device="cpu")
        model = copy.deepcopy(cpu_model).to(device)
        gen = torch.Generator().manual_seed(SEED)
        toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
        aux = (0.1 * torch.randn((2, cfg.n_aux_tokens, cfg.d_model),
                                 generator=gen) if cfg.aux_kind else None)
        dev_aux = aux.to(device) if aux is not None else None
        margins, undo = _moe_margins()
        try:
            with torch.no_grad():
                got = forward(model, cfg, toks.to(device), aux=dev_aux)
        finally:
            undo()
        with torch.no_grad():
            want = forward(cpu_model, cfg, toks, aux=aux)
        near_tie = torch.zeros(toks.numel(), dtype=torch.bool)
        for m in margins:
            near_tie |= m < 4
        row_err = (got.cpu() - want).abs().amax(-1).reshape(-1)
        off = row_err > LOGITS_ULPS
        if not torch.isfinite(got).all() or bool((off & ~near_tie).any()) \
                or int(off.sum()) > toks.numel() // 16:
            raise AssertionError(f"{arch} reduced: card logits differ from "
                                 f"the CPU's (rows {off.nonzero().tolist()}"
                                 f", near ties {near_tie.nonzero().tolist()}"
                                 f", max {float(row_err.max())})")
        rep = {"logits_max_abs_err": float(row_err.max()),
               "logits_max_abs_err_in_tolerance_rows":
                   float(row_err[~off].max()),
               "rows_beyond_tolerance_near_ties": int(off.sum())}
        for g, spec in enumerate(cfg.group_spec):
            if spec.moe:
                x = model.embed[toks.to(device)].to(torch.bfloat16)
                rep["routing"] = _routing_card_vs_cpu(
                    device, cfg, model.block(0, g).moe,
                    model.block(0, g).norm2(x).reshape(32, -1))
                break
        c = dataclasses.replace(cfg, moe_impl="dense") if cfg.n_experts \
            else cfg
        lgs, caches = prefill(model, c, toks.to(device), aux=dev_aux)
        lg2, _ = decode_step(model, c, caches, toks[:, -1:].to(device), 15,
                             aux=dev_aux)
        diff = float((lgs[:, -1] - lg2[:, 0]).abs().max())
        tol = 0.05 if any(s.kind == "mamba" for s in cfg.group_spec) \
            else 1e-3
        if not diff <= tol:
            raise AssertionError(f"{arch} reduced on the card: decode at "
                                 f"S-1 differs from the prefill by {diff}")
        rep["prefill_decode_diff"] = diff
        step, tx, _ = build_train(cfg, lr=1e-3)
        state = tx.init(model.leaves())
        batch = {"tokens": toks, "labels": toks}
        if aux is not None:
            batch["aux"] = aux
        state, metrics = step(model, state, batch)
        loss = float(metrics["loss"])
        if not 0 < loss < 20:
            raise AssertionError(f"{arch} reduced: training loss {loss}")
        rep["train_loss"] = loss
        rep["train_grad_norm"] = float(metrics["grad_norm"])
        report[arch] = rep
        log(f"  {arch} reduced, card against CPU: {json.dumps(rep)}")
        del model, cpu_model, state
    return report


def _moe_load():
    """Wrap `nn.moe.router_logits` and `nn.moe.dispatch` to keep, for each
    MoE layer's call (device scalars): the slots dropped at capacity, the
    largest expert's load, and the coherence of the router's input rows,
    |mean of the unit-length rows|^2 (1 when every token points one way,
    about 1/T for T independent ones). Returns (the list of (dropped,
    max load, coherence) rows, the undo)."""
    import torch
    from repro_torch.nn import moe
    rows, coherence = [], []
    router_logits, dispatch = moe.router_logits, moe.dispatch

    def logits(layer, x2d):
        u = x2d.float()
        u = u / u.norm(dim=-1, keepdim=True).clamp_min(1e-30)
        coherence.append(u.mean(dim=0).square().sum())
        return router_logits(layer, x2d)

    def counting(topi, n_experts, cap):
        plan = dispatch(topi, n_experts, cap)
        load = torch.bincount(topi.reshape(-1), minlength=n_experts)
        rows.append(torch.stack([(~plan.keep).sum().float(),
                                 load.max().float(), coherence[-1]]))
        return plan

    moe.router_logits, moe.dispatch = logits, counting

    def undo():
        moe.router_logits, moe.dispatch = router_logits, dispatch
    return rows, undo


def moe_step_share(params, cfg, prompts, pkv) -> dict:
    """One clean decode step (after a prefill and a warm step) with CUDA
    events around the step and around each MoE layer: the step's stream
    ms, the MoE layers' and their share (host gaps within a layer count
    as the layer's)."""
    import torch
    from repro_torch.models import decode_step, prefill
    from repro_torch.nn import moe
    S = prompts.shape[1]
    logits, caches = prefill(params, cfg, prompts, protected_kv=pkv)
    tok = logits[:, -1:].argmax(dim=-1)
    lg, caches = decode_step(params, cfg, caches, tok, S)
    tok = lg[:, -1:].argmax(dim=-1)
    events, apply = [], moe.moe_apply

    def timed(*args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = apply(*args, **kw)
        b.record()
        events.append((a, b))
        return out

    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    moe.moe_apply = timed
    try:
        torch.cuda.synchronize()
        t0.record()
        decode_step(params, cfg, caches, tok, S + 1)
        t1.record()
        torch.cuda.synchronize()
    finally:
        moe.moe_apply = apply
    step_ms = t0.elapsed_time(t1)
    moe_ms = sum(a.elapsed_time(b) for a, b in events)
    caches.free()
    return {"step_ms": step_ms, "moe_ms": moe_ms, "moe_layers": len(events),
            "moe_share": moe_ms / step_ms}


def _serving_checks(name, runs, n_attn: int, steps: int) -> dict:
    """Phase 8's checks on a protected serving model's runs: the injected
    run corrected words, left none, and gave the clean tokens and logits
    bit for bit; `attend_protected` ran once per attention layer per
    step in every run."""
    import torch
    clean, inj = runs["clean"], runs["injected"]
    fixes = _layer_corrections(inj["caches"])
    if fixes["corrected"] <= 0 or fixes["uncorrectable"] != 0:
        raise AssertionError(f"{name} injected run: corrections {fixes}")
    if not torch.equal(inj["tokens"], clean["tokens"]):
        raise AssertionError(f"{name} injected run: tokens differ from the "
                             "clean run's")
    if not torch.equal(inj["logits"], clean["logits"]):
        err = float((inj["logits"] - clean["logits"]).abs().max())
        raise AssertionError(f"{name} injected run: logits differ from the "
                             f"clean run's (max abs {err})")
    for run, r in runs.items():
        counts = [st.get("attend_protected", 0) for st in r["per_step"]]
        if counts != [n_attn] * steps:
            raise AssertionError(f"{name} {run} run: attend_protected "
                                 f"launches per decode step {counts}, "
                                 f"expected {n_attn} each")
    return fixes


def _page_words(caches) -> int:
    layer = next(iter(caches.layers.values()))
    return layer.k_store.page_words


def _serve_model(name, params, cfg, prompts, pkv, steps, runs_wanted,
                 page_words: int) -> tuple[dict, dict]:
    """Protected serving runs of one model (phase 8's `serve_once`), the
    clean one counting the MoE slots dropped at capacity each step and,
    for each MoE layer of the prefill, its drops, its largest expert's
    load and its router inputs' coherence (`_moe_load`).
    Returns (report, the runs' launches)."""
    import dataclasses
    import torch
    from repro_torch.kernels import build
    from repro_torch.nn import moe
    n_attn = sum(1 for s in cfg.group_spec if s.kind == "attn"
                 and not s.cross and not s.local_window) * cfg.n_groups
    n_moe = sum(1 for s in cfg.group_spec if s.moe) * cfg.n_groups
    build.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    counts, undo = _moe_load()
    try:
        runs = {"clean": serve_once(params, cfg, prompts, pkv, inject=False,
                                    steps=steps)}
    finally:
        undo()
    got_words = _page_words(runs["clean"]["caches"])
    if got_words != page_words:
        raise AssertionError(f"{name}: pages of {got_words} words; phase 2 "
                             f"checks {page_words}")
    runs["injected"] = serve_once(params, cfg, prompts, pkv, inject=True,
                                  steps=steps)
    if "uncorrected" in runs_wanted:
        runs["uncorrected"] = serve_once(
            params, cfg, prompts, dataclasses.replace(pkv, corrected=False),
            inject=True, steps=steps)
    launches = dict(build.LAUNCHES)
    loads = torch.stack(counts).cpu().tolist() if counts else []
    drops = [int(r[0]) for r in loads]
    fixes = _serving_checks(name, runs, n_attn, steps)
    report = {"layers": cfg.n_groups * len(cfg.group_spec),
              "attention_layers": n_attn, "moe_layers": n_moe,
              "tokens": runs["clean"]["tokens"].tolist(),
              "batch": prompts.shape[0], "prompt_tokens": prompts.shape[1],
              "decode_steps": steps, "page_words": page_words,
              "stored_cells": runs["injected"]["caches"].stats()[
                  "stored_cells"],
              "injected_cells": runs["injected"]["cells_changed"],
              "injected_corrections": fixes,
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
              "moe_dropped_slots_prefill": sum(drops[:n_moe]),
              "moe_dropped_slots_per_step": [
                  sum(drops[n_moe * (i + 1):n_moe * (i + 2)])
                  for i in range(steps)] if n_moe else []}
    if n_moe:
        T = prompts.shape[0] * prompts.shape[1]
        report["moe_prefill_per_layer"] = {
            "tokens": T, "capacity": moe.capacity(T, cfg),
            "mean_load": T * cfg.top_k / cfg.n_experts,
            "dropped": drops[:n_moe],
            "max_load": [int(r[1]) for r in loads[:n_moe]],
            "router_input_coherence": [r[2] for r in loads[:n_moe]]}
    for run, r in runs.items():
        report[run] = {k: r[k] for k in (
            "ttft_s", "decode_s", "prefill_tokens_per_s",
            "decode_tokens_per_s", "ms_per_decode_step")}
        report[run]["launches_per_step_mean"] = {
            k: sum(st.get(k, 0) for st in r["per_step"]) / steps
            for k in sorted({k for st in r["per_step"] for k in st})}
    if "uncorrected" in runs:
        report["uncorrected_logit_drift"] = float(
            (runs["uncorrected"]["logits"] - runs["clean"]["logits"]).abs()
            .max())
    for r in runs.values():
        r["caches"].free()
    return report, launches


def _flash_prefill_check(name, params, cfg, prompts, aux, n_flash: int,
                         one_layer: bool) -> tuple[dict, dict]:
    """Phase 9's criterion on one model: `prefill` naive and under
    attn_impl="flash" (flash_fwd `n_flash` times), every flash attention
    output within ULP_RTOL/ULP_ATOL of the fp32-softmax attention on the
    same q/k/v (`exact_attend`); with `one_layer`, also one-layer copies
    at full width (one decoder layer and one encoder layer, seeds SEED and
    SEED + 1) whose flash logits lie within PREFILL_EXACT_ATOL of an
    `exact_attend` prefill, and the full model's flash and naive logits'
    distances from an `exact_attend` prefill logged (over many random
    layers the two roundings drift apart, and which one ends closer is
    not a property of the kernel). Returns (report, the launches of the
    timed prefills)."""
    import dataclasses
    import torch
    from repro_torch.kernels import build
    from repro_torch.models import init_params, prefill
    from repro_torch.nn import layers
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    out, secs = {}, {}
    build.reset_launches()
    for run, c in (("naive", cfg), ("flash", flash_cfg)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[run] = prefill(params, c, prompts, aux=aux)[0]
        torch.cuda.synchronize()
        secs[run] = time.perf_counter() - t0
        if run == "naive" and build.LAUNCHES["flash_fwd"]:
            raise AssertionError(f"{name}: the naive prefill launched "
                                 "flash_fwd")
    launches = dict(build.LAUNCHES)
    attend, ratios = layers._attend, []
    one_dist, one_naive = {}, {}
    try:
        layers._attend = _checked_attend(attend, ratios)
        prefill(params, flash_cfg, prompts, aux=aux)
        n_checked = len(ratios)
        if one_layer:
            layers._attend = exact_attend
            ref = prefill(params, cfg, prompts, aux=aux)[0]
            one = dataclasses.replace(cfg, n_groups=1, encoder_groups=min(
                cfg.encoder_groups, 1))
            for seed in (SEED, SEED + 1):
                one_params = init_params(one, seed, device=prompts.device)
                layers._attend = _checked_attend(attend, ratios)
                got = prefill(one_params, dataclasses.replace(
                    one, attn_impl="flash"), prompts, aux=aux)[0]
                layers._attend = attend
                naive = prefill(one_params, one, prompts, aux=aux)[0]
                layers._attend = exact_attend
                exact = prefill(one_params, one, prompts, aux=aux)[0]
                one_dist[seed] = float((got - exact).abs().max())
                one_naive[seed] = float((naive - exact).abs().max())
                del one_params, got, naive, exact
    finally:
        layers._attend = attend
    flash_ratio = max(r["flash"] for r in ratios)
    report = {"naive_s": secs["naive"], "flash_s": secs["flash"],
              "flash_fwd_launches": launches.get("flash_fwd", 0),
              "max_abs_logit": float(out["naive"].abs().max()),
              "flash_vs_naive": float((out["flash"] - out["naive"]).abs()
                                      .max()),
              "layer_ulp_ratio_flash_max": flash_ratio,
              "layer_ulp_ratio_naive_max": max(r["naive"] for r in ratios),
              "argmax_agree_flash_naive": float(
                  (out["flash"].argmax(-1) == out["naive"].argmax(-1))
                  .float().mean())}
    if one_layer:
        report.update(
            flash_vs_fp32_softmax=float((out["flash"] - ref).abs().max()),
            naive_vs_fp32_softmax=float((out["naive"] - ref).abs().max()),
            one_layer_flash_vs_fp32_softmax=one_dist,
            one_layer_naive_vs_fp32_softmax=one_naive)
    if launches.get("flash_fwd", 0) != n_flash or n_checked != n_flash:
        raise AssertionError(f"{name} flash prefill: flash_fwd launched "
                             f"{launches.get('flash_fwd', 0)} times, "
                             f"{n_checked} checked, expected {n_flash}")
    if not flash_ratio <= 1 or not torch.isfinite(out["flash"]).all():
        raise AssertionError(f"{name} flash prefill: attention outputs not "
                             f"within a few bf16 ulps of the fp32-softmax "
                             f"attention ({flash_ratio})")
    if one_layer and not max(one_dist.values()) <= PREFILL_EXACT_ATOL:
        raise AssertionError(f"{name}: one-layer flash prefill logits are "
                             f"{one_dist} from the fp32-softmax reference")
    return report, launches


def phase_protected_model(device, cfg, steps: int, runs_wanted,
                          page_words: int, flash: bool) -> tuple[dict, dict]:
    """(b), (c): `cfg` at full width from a seeded generator on the card,
    served from protected pages (`_serve_model`: clean, injected and the
    `runs_wanted`) over 4 x 512 prompts for `steps` greedy steps, the MoE
    layers' share of a clean step, and with `flash` a flash prefill by
    the per-layer criterion. Returns (report, the runs' launches)."""
    import torch
    from repro_torch.models import ProtectedKVConfig, init_params
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=16)
    report, launches = _serve_model(cfg.name, params, cfg, prompts, pkv,
                                    steps, runs_wanted, page_words)
    report.update(arch=cfg.name, parameters=sum(
        p.numel() for p in params.parameters()), init_s=init_s)
    report["moe_step_share"] = moe_step_share(params, cfg, prompts, pkv)
    if flash:
        report["flash_prefill"], flash_launches = _flash_prefill_check(
            cfg.name, params, cfg, prompts, None,
            cfg.n_groups * len(cfg.group_spec), one_layer=False)
        for k, v in flash_launches.items():
            launches[k] = launches.get(k, 0) + v
    del params
    return report, launches


def phase_encdec(device) -> tuple[dict, dict]:
    """(d) whisper-small at full width and depth: 4 requests of
    WHISPER_PROMPT tokens over 1,500 seeded aux frames, prefill naive and
    flash (phase 9's criterion; flash_fwd once per encoder layer and twice
    per decoder layer), then WHISPER_STEPS greedy decode steps on dense
    caches holding the cross K/V."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decode_step, init_caches, init_params, \
        prefill
    cfg = get_config(ENCDEC_ARCH)
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, WHISPER_PROMPT),
                            generator=gen, device=device)
    aux = torch.randn((SERVE_BATCH, cfg.n_aux_tokens, cfg.d_model),
                      generator=gen, device=device)
    n_flash = cfg.encoder_groups + 2 * cfg.n_groups
    report, launches = _flash_prefill_check(
        cfg.name, params, cfg, prompts, aux, n_flash, one_layer=True)
    B, S = prompts.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, pre = prefill(params, cfg, prompts, aux=aux)
    caches = init_caches(cfg, B, S + WHISPER_STEPS, device=device)
    for pos, entry in pre.items():
        for name, val in entry.items():
            caches[pos][name][:, :, :val.shape[2]] = val
    tok = logits[:, -1:].argmax(dim=-1)
    tok.cpu()
    ttft = time.perf_counter() - t0
    toks, steps = [tok], []
    t1 = time.perf_counter()
    for i in range(WHISPER_STEPS):
        lg, caches = decode_step(params, cfg, caches, tok, S + i)
        tok = lg[:, -1:].argmax(dim=-1)
        toks.append(tok)
        steps.append(lg)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t1
    step_logits = torch.cat(steps, dim=1)
    if step_logits.shape != (B, WHISPER_STEPS, cfg.vocab_size) or not bool(
            torch.isfinite(step_logits).all()):
        raise AssertionError("whisper decode: logits of shape "
                             f"{tuple(step_logits.shape)} or not finite")
    # decode at the last prompt position on the prefill's own caches,
    # against the prefill's last logits (logged: the JAX test's 1e-3 is a
    # reduced model's bound)
    lg_last, _ = decode_step(params, cfg, pre, prompts[:, -1:], S - 1)
    consistency = float((lg_last[:, 0] - logits[:, -1]).abs().max())
    report.update(arch=cfg.name, parameters=sum(
        p.numel() for p in params.parameters()), batch=B, prompt_tokens=S,
        aux_frames=cfg.n_aux_tokens, decode_steps=WHISPER_STEPS,
        ttft_s=ttft, ms_per_decode_step=decode_s / WHISPER_STEPS * 1e3,
        decode_at_last_prompt_position_vs_prefill=consistency,
        decode_tokens_per_s=B * WHISPER_STEPS / decode_s,
        tokens=torch.cat(toks, dim=1)[0].tolist())
    del params
    return report, launches


def phase_substrate(device) -> tuple[dict, dict]:
    """Phase 16, (a)-(d), each model freed before the next. Returns
    (report, the kernel launches of (b)-(d))."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    smi = card_name()
    report = {"card": smi}

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    report["reduced"] = phase_substrate_reduced(device)
    free()
    # (b) olmoe-1b-7b at full width and depth, (c) one of jamba's four
    # 8-layer blocks at full width (the whole model does not fit a card)
    moe_rep, moe_launches = phase_protected_model(
        device, get_config(MOE_ARCH), SERVE_STEPS, ("uncorrected",),
        MOE_PAGE_WORDS, flash=True)
    log(f"  olmoe-1b-7b ({smi}): {json.dumps(moe_rep)}")
    free()
    hyb_rep, hyb_launches = phase_protected_model(
        device, dataclasses.replace(get_config(HYBRID_ARCH), n_groups=1),
        HYBRID_STEPS, (), HYBRID_PAGE_WORDS, flash=False)
    hyb_rep["reduced"] = {"n_groups": "4 -> 1"}
    log(f"  jamba-v0.1-52b, one block ({smi}): {json.dumps(hyb_rep)}")
    free()
    enc_rep, enc_launches = phase_encdec(device)
    log(f"  whisper-small ({smi}): {json.dumps(enc_rep)}")
    free()
    for name, launches in (("olmoe-1b-7b", moe_launches),
                           ("jamba-v0.1-52b", hyb_launches)):
        check_path(f"{name} protected serving", launches,
                   ("attend_protected", "gf_matmul", "scan_syndromes",
                    "fbp_cn"))
    check_path("whisper-small flash prefill", enc_launches, ("flash_fwd",))
    report.update(moe=moe_rep, hybrid=hyb_rep, encdec=enc_rep,
                  seconds=time.perf_counter() - t0)
    launches = {k: moe_launches.get(k, 0) + hyb_launches.get(k, 0)
                + enc_launches.get(k, 0)
                for k in set(moe_launches) | set(hyb_launches)
                | set(enc_launches)}
    return report, launches


def phase_small_training(device) -> dict:
    """Reduced granite-3-2b (2 layers, d_model 128, seq 64, batch 4; the
    shape of tests/test_system.py::test_training_learns) under
    attn_impl="flash": SMALL_TRAIN_STEPS steps of `launch.train.run` on
    the card and on the CPU from the same weights, losses within 1e-2
    relative step by step. The card run saves a protected checkpoint of
    its last step; flips injected into it are corrected on restore (the
    parameters come back bit for bit), and the run resumes from it."""
    import copy
    import dataclasses
    import tempfile
    import torch
    from repro_torch import checkpoint, optim
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.memory import uniform_flip
    from repro_torch.models import init_params
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(
        n_groups=2, d_model=128, n_heads=4, d_ff=512), attn_impl="flash")
    start = init_params(cfg, SEED, device="cpu")
    kw = dict(batch=4, seq=64, lr=5e-3, log=lambda m: None)
    with tempfile.TemporaryDirectory() as d:
        cpu = run(cfg, steps=SMALL_TRAIN_STEPS, params=copy.deepcopy(start),
                  device="cpu", ckpt_dir=os.path.join(d, "cpu"),
                  save_every=100, **kw)
        model = copy.deepcopy(start)
        ckpt_dir = os.path.join(d, "card")
        card = run(cfg, steps=SMALL_TRAIN_STEPS, params=model, device=device,
                   ckpt_dir=ckpt_dir, save_every=SMALL_TRAIN_STEPS - 1,
                   protect=True, **kw)
        rel = [abs(b["loss"] - a["loss"]) / abs(a["loss"])
               for a, b in zip(cpu, card, strict=True)]
        changed = checkpoint.inject_storage_faults(
            ckpt_dir, uniform_flip(3, 1e-4), key=SEED, device=device)
        template = {"params": model.leaves(),
                    "opt": optim.adamw(1.0).init(model.leaves())}
        restored, manifest = checkpoint.restore_checkpoint(
            ckpt_dir, template, device=device)
        exact = all(torch.equal(a, b) for k, ps in model.leaves().items()
                    for a, b in zip(ps, restored["params"][k], strict=True))
        del restored, template
        resumed = run(cfg, steps=SMALL_TRAIN_STEPS + 2,
                      params=copy.deepcopy(start), device=device,
                      ckpt_dir=ckpt_dir, save_every=100, protect=True, **kw)
    stats = manifest["correction_stats"]
    report = {"cpu_losses": [h["loss"] for h in cpu],
              "card_losses": [h["loss"] for h in card],
              "max_rel_loss_diff": max(rel), "injected_cells": changed,
              "restore_corrected": stats["corrected"],
              "restore_uncorrectable": stats["uncorrectable"],
              "restored_exactly": exact,
              "resumed_steps": [h["step"] for h in resumed],
              "resumed_losses": [h["loss"] for h in resumed],
              "card_launches_per_step": card[-1]["launches"]}
    log(f"  small training: {json.dumps(report)}")
    if not max(rel) <= 1e-2:
        raise AssertionError(f"card losses differ from the CPU's by "
                             f"{max(rel)} relative")
    if changed <= 0 or stats["corrected"] <= 0 or not exact:
        raise AssertionError(f"protected checkpoint: {changed} cells "
                             f"injected, {stats}, exact={exact}")
    if report["resumed_steps"] != [SMALL_TRAIN_STEPS - 1 + i
                                   for i in range(3)]:
        raise AssertionError(f"resumed steps {report['resumed_steps']}")
    for h in card + resumed:
        if not h["launches"].get("flash_bwd_dkv"):
            raise AssertionError(f"step {h['step']} on the card ran no "
                                 "flash backward")
    return report


def phase_full_training(device) -> dict:
    """granite-3-2b at full width and depth (2.53 B parameters, seeded
    random weights), AdamW, remat "full", the TokenPipeline at seq 4096
    and global batch 2. The first batch's loss and global grad norm,
    before any update, naive against flash (within 1e-3 and 1e-2
    relative); then TRAIN_STEPS steps of `launch.train.run` under
    attn_impl="flash" (no checkpoint written), each launching flash_fwd
    twice per layer (forward and remat) and each backward kernel once per
    layer; then one more step under torch.profiler."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.steps import build_train
    from repro_torch.launch.train import run
    from repro_torch.models import init_params, loss_fn
    cfg = get_config(TRAIN_ARCH)
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    n_layers = cfg.n_groups * len(cfg.group_spec)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    model = init_params(cfg, gen)
    torch.cuda.synchronize()
    report = {"arch": cfg.name, "layers": n_layers,
              "parameters": sum(p.numel() for p in model.parameters()),
              "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
              "init_s": time.perf_counter() - t0}
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED)
    first = next(TokenPipeline(dcfg))
    batch = {k: torch.as_tensor(v, device=device) for k, v in first.items()}
    check = {}
    for name, c in (("naive", cfg), ("flash", flash_cfg)):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = loss_fn(model, c, batch)
        loss.backward()
        gnorm = torch.sqrt(sum(p.grad.float().square().sum()
                               for p in model.parameters()))
        check[name] = {"loss": float(loss.detach()),
                       "grad_norm": float(gnorm),
                       "seconds": time.perf_counter() - t0}
    model.zero_grad(set_to_none=True)
    report["first_batch"] = check
    log(f"  first batch naive vs flash: {json.dumps(check)}")
    n, f = check["naive"], check["flash"]
    if not abs(f["loss"] - n["loss"]) <= 1e-3 * abs(n["loss"]) or not \
            abs(f["grad_norm"] - n["grad_norm"]) <= 1e-2 * n["grad_norm"]:
        raise AssertionError(f"first batch: flash {f} against naive {n}")

    with tempfile.TemporaryDirectory() as d:
        hist = run(flash_cfg, steps=TRAIN_STEPS,
                   batch=TRAIN_BATCH, seq=TRAIN_SEQ, seed=SEED,
                   save_every=TRAIN_STEPS + 1, log_every=1, ckpt_dir=d,
                   params=model, device=device, log=lambda m: log("  " + m))
    want = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
            "flash_bwd_dkv": n_layers}
    report["steps"] = [
        {"step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
         "ms": h["seconds"] * 1e3,
         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / h["seconds"],
         "launches": h["launches"]} for h in hist]
    for h in hist:
        got = {k: h["launches"].get(k, 0) for k in want}
        if got != want or not all(got.values()):
            raise AssertionError(f"step {h['step']}: flash launches {got}, "
                                 f"expected {want}")
        if not torch.isfinite(torch.tensor(h["loss"])):
            raise AssertionError(f"step {h['step']}: loss {h['loss']}")

    train_step, tx, _ = build_train(flash_cfg, lr=3e-3,
                                 total_steps=TRAIN_STEPS)
    opt = tx.init(model.leaves())
    extra = next(TokenPipeline(dcfg, step=TRAIN_STEPS))
    prof_step, by_kernel = busy_report(profiled_device(
        lambda: float(train_step(model, opt, extra)[1]["loss"]), cpu=True),
        "step_wall_ms_profiled", 10)
    del opt
    busy_ms = prof_step["device_busy_ms"]
    if busy_ms is not None:
        flash_ms = {name: sum(us for k, us in by_kernel.items()
                              if f"{name}_kernel" in k) / 1e3
                    for name in want}
        prof_step.update(
            device_busy_share=busy_ms / prof_step["step_wall_ms_profiled"],
            flash_kernels_ms=sum(flash_ms.values()),
            flash_share_of_busy=sum(flash_ms.values()) / busy_ms,
            flash_ms_by_kernel=flash_ms,
            flash_share_of_busy_by_kernel={k: ms / busy_ms
                                           for k, ms in flash_ms.items()})
    report["profile_step"] = prof_step
    step_ms = [r["ms"] for r in report["steps"][1:]] or \
        [r["ms"] for r in report["steps"]]
    log(f"  step ms {statistics.median(step_ms):.1f} (median after the "
        f"first), busy share "
        f"{prof_step.get('device_busy_share', 'not measured')}, flash "
        f"share of busy "
        f"{json.dumps(prof_step.get('flash_share_of_busy_by_kernel'))}")
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"  full training: {json.dumps(report)}")
    del model
    torch.cuda.empty_cache()
    return report


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def phase_pim_training(device, prompts) -> tuple[dict, dict]:
    """The training pass of paper-pim-2b at full width and depth (a fresh
    `init_params` from SEED, not precoded: every protected call ternarizes
    and encodes its weight) under attn_impl="flash", on phase 8's prompts
    as tokens with their next tokens as labels: `loss_fn(...,
    pim_ctx=...).backward()` through the mlp_down and attn_o projections
    of `cfg.pim` (wl320_r08). Runs: (a) `PIMContext(cfg.pim)`, remat
    "full"; (b) its `with_faults(SEED, PIM_FAULT_RATE)`, one pass; (c) (a)
    with remat off; (d) no `pim_ctx`, the dense pass. (a), (c) and (d)
    run PIM_TRAIN_REPS times (median ms a pass). Gates: (b) flags words,
    and gives (a)'s loss and every gradient bit for bit where it leaves
    none (else its loss within PIM_TRAIN_LOSS_RTOL of (a)'s, the words
    left logged); (c) gives (a)'s loss, gradients and `stats()` exactly,
    each protected call counted once; every gradient finite. Returns
    (report, the launches of the runs); one pass of (a) is profiled after
    the count is read."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import PIMContext
    from repro_torch.kernels import build
    from repro_torch.models import init_params, loss_fn
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(SERVE_ARCH), attn_impl="flash")
    assert cfg.remat and cfg.remat_policy == "full"
    n_layers = cfg.n_groups * len(cfg.group_spec)
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, torch.Generator(device=device).manual_seed(SEED))
    tokens = prompts
    labels = torch.full_like(tokens, -1)
    labels[:, :-1] = tokens[:, 1:]
    batch = {"tokens": tokens, "labels": labels}
    report = {"arch": cfg.name, "card": card_name(), "layers": n_layers,
              "parameters": sum(p.numel() for p in model.parameters()),
              "batch": tuple(tokens.shape), "code": cfg.pim.code_name,
              "fault_rate_b": PIM_FAULT_RATE}

    def one_pass(c, ctx):
        """(loss, ms, launches) of one loss_fn + backward."""
        model.zero_grad(set_to_none=True)
        before = dict(build.LAUNCHES)
        torch.cuda.synchronize()
        start = time.perf_counter()
        loss = loss_fn(model, c, batch, pim_ctx=ctx)
        loss.backward()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - start) * 1e3
        return loss.detach(), ms, {
            k: n - before.get(k, 0) for k, n in build.LAUNCHES.items()
            if n != before.get(k, 0)}

    def grads():
        return [p.grad.clone() for p in model.parameters()]

    def finite(name):
        bad = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()]
        if bad:
            raise AssertionError(f"PIM training ({name}): no or non-finite "
                                 f"gradient in {bad[:4]}")

    def run(name, c, make_ctx, reps):
        ms, ctx = [], None
        for _ in range(reps):
            ctx = make_ctx()
            loss, t, per_pass = one_pass(c, ctx)
            ms.append(t)
        finite(name)
        rec = {"loss": float(loss), "ms_per_pass": ms,
               "ms_median": statistics.median(ms),
               "launches_per_pass": per_pass}
        if ctx is not None:
            rec["stats"] = ctx.stats()
        report[name] = rec
        log(f"  ({name}) {json.dumps(rec)}")
        return loss, ctx

    base = PIMContext(cfg.pim)
    build.reset_launches()
    loss_a, ctx_a = run("a_pim_remat", cfg, lambda: PIMContext(cfg.pim),
                        PIM_TRAIN_REPS)
    grads_a = grads()
    loss_b, ctx_b = run("b_pim_faults", cfg,
                        lambda: base.with_faults(SEED, PIM_FAULT_RATE), 1)
    st_b = ctx_b.stats()
    if st_b["detected_words"] <= 0:
        raise AssertionError(f"PIM training (b): no word flagged: {st_b}")
    if st_b["uncorrected_words"] == 0:
        same = torch.equal(loss_b, loss_a) and all(
            torch.equal(p.grad, g)
            for p, g in zip(model.parameters(), grads_a, strict=True))
        if not same:
            raise AssertionError("PIM training (b): every flagged word "
                                 "corrected, but the loss or a gradient "
                                 "differs from (a)'s")
        report["b_pim_faults"]["bit_identical_to_a"] = True
    else:
        log(f"  (b) left {st_b['uncorrected_words']} words uncorrected")
        if not abs(float(loss_b) - float(loss_a)) <= \
                PIM_TRAIN_LOSS_RTOL * abs(float(loss_a)):
            raise AssertionError(f"PIM training (b): loss {float(loss_b)} "
                                 f"against (a)'s {float(loss_a)}")
    loss_c, ctx_c = run("c_pim_no_remat", dataclasses.replace(
        cfg, remat=False), lambda: PIMContext(cfg.pim), PIM_TRAIN_REPS)
    if not (torch.equal(loss_c, loss_a) and all(
            torch.equal(p.grad, g)
            for p, g in zip(model.parameters(), grads_a, strict=True))):
        raise AssertionError("PIM training (c): remat off differs from (a)")
    if ctx_c.stats() != ctx_a.stats() or \
            ctx_a.stats()["calls"] != 2 * n_layers:
        raise AssertionError(f"PIM training: stats (a) {ctx_a.stats()}, "
                             f"(c) {ctx_c.stats()}, expected "
                             f"{2 * n_layers} calls")
    del grads_a
    run("d_dense", cfg, lambda: None, PIM_TRAIN_REPS)
    launches = dict(build.LAUNCHES)

    prof, by_kernel = busy_report(profiled_device(
        lambda: one_pass(cfg, PIMContext(cfg.pim))), "pass_wall_ms_profiled",
        10)
    if prof["device_busy_ms"] is not None:
        prof["device_busy_share"] = (prof["device_busy_ms"]
                                     / prof["pass_wall_ms_profiled"])
    report["profile_pass_a"] = prof
    log(f"  profiled pass of (a): {json.dumps(prof)}")
    model.zero_grad(set_to_none=True)
    report["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    report["seconds"] = time.perf_counter() - t0
    log(f"  PIM training ({report['card']}): ms a pass (a) "
        f"{report['a_pim_remat']['ms_median']:.1f}, (c) "
        f"{report['c_pim_no_remat']['ms_median']:.1f}, (d) dense "
        f"{report['d_dense']['ms_median']:.1f}; busy share "
        f"{prof.get('device_busy_share', 'not measured')}; peak "
        f"{report['peak_memory_gb']:.1f} GB; {report['seconds']:.1f} s")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return report, launches


def phase_examples() -> dict:
    """The port's four examples (`scripts/*_torch.py`), each in its own
    process on the card, all started together: each must exit 0 (the
    quickstart and the memory-mode example also end with their "OK:"
    line). Returns each one's seconds and last line."""
    import tempfile
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    report, procs = {}, {}
    with tempfile.TemporaryDirectory() as d:
        try:
            for name, args in EXAMPLES:
                extra = ("--ckpt-dir", d) if name == "train_small" else ()
                out = open(os.path.join(d, f"{name}.log"), "w")
                procs[name] = (out, time.perf_counter(), subprocess.Popen(
                    [sys.executable, str(ROOT / "scripts" /
                                         f"{name}_torch.py"), *args, *extra],
                    cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT))
            running = dict(procs)
            while running:
                for name, (out, start, proc) in list(running.items()):
                    if proc.poll() is not None:
                        report[name] = {"rc": proc.returncode,
                                        "seconds": time.perf_counter()
                                        - start}
                        out.close()
                        del running[name]
                    elif time.perf_counter() - start > EXAMPLES_TIMEOUT:
                        raise AssertionError(f"example {name} ran past "
                                             f"{EXAMPLES_TIMEOUT} s")
                time.sleep(0.1)
        finally:
            for out, _start, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
                out.close()
        for name, _args in EXAMPLES:
            with open(os.path.join(d, f"{name}.log")) as f:
                text = f.read().strip().splitlines()
            report[name]["last_line"] = text[-1] if text else ""
            if report[name]["rc"] != 0:
                raise AssertionError(f"example {name} exited "
                                     f"{report[name]['rc']}:\n"
                                     + "\n".join(text[-20:]))
    for name in ("quickstart", "memory_mode"):
        if not report[name]["last_line"].startswith("OK:"):
            raise AssertionError(f"example {name}: {report[name]}")
    return report


# ---------------------------------------------------------------------------
# the device mesh
# ---------------------------------------------------------------------------


def mesh_devices() -> tuple[list, str]:
    """Phase 19's devices: every visible card when there are two or more,
    else MESH_SHARDS_ONE_CARD shards on the one card; and which it was."""
    import torch
    n = torch.cuda.device_count()
    if n >= 2:
        return ([torch.device("cuda", i) for i in range(n)],
                f"{n} cards, one shard each")
    return ([torch.device("cuda", 0)] * MESH_SHARDS_ONE_CARD,
            f"one card, {MESH_SHARDS_ONE_CARD} shards on it")


def mesh_memory(device, mesh, want: dict) -> dict:
    """(a) phase 3's array, tensor and flips, read and scrubbed over
    `mesh`; `want` is phase 3's report."""
    import numpy as np
    import torch
    from repro_torch.core import get_code
    from repro_torch.distributed import sharding
    from repro_torch.kernels import build
    from repro_torch.memory import ProtectedMemoryArray, uniform_flip
    gen = torch.Generator(device=device).manual_seed(SEED)
    t = torch.randn(MEMORY_MIB * 2 ** 18, generator=gen, device=device)
    expect = t.cpu().numpy()
    mem = ProtectedMemoryArray("wl1024_r08", controller="writeback",
                               device=device, key=SEED, use_sharded=True,
                               mesh=mesh)
    times = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t0
        return out

    st = timed("write_s", lambda: mem.write("t", t))
    changed = mem.inject(uniform_flip(3, 1e-4))
    before = dict(build.LAUNCHES)
    out = timed("read_s", lambda: mem.read("t"))
    read_launches = {k: v - before.get(k, 0)
                     for k, v in build.LAUNCHES.items()
                     if v - before.get(k, 0)}
    s = mem.stats
    changed2 = mem.inject(uniform_flip(3, 1e-4))
    rep = timed("scrub_s", lambda: mem.scrub())
    clean = timed("rescrub_s", lambda: mem.scrub())
    got = {"words": st.enc.shape[0], "cells_changed": changed,
           "read_flagged": s.detected, "read_corrected": s.corrected,
           "cells_changed_2": changed2, "scrub_flagged": rep["flagged"],
           "scrub_corrected": rep["corrected"],
           "rescrub_flagged": clean["flagged"]}
    if not np.array_equal(out.view(np.uint8), expect.view(np.uint8)):
        raise AssertionError("sharded memory read-back differs from the "
                             "written bytes")
    differ = {k: (v, want[k]) for k, v in got.items() if v != want[k]}
    if differ or s.uncorrectable or rep["uncorrectable"]:
        raise AssertionError(f"sharded memory run against phase 3's "
                             f"(got, want): {differ}, uncorrectable "
                             f"{s.uncorrectable} + {rep['uncorrectable']}")
    # one launch a shard: a sharded scan, and a one-iteration decode
    code = get_code("wl1024_r08")
    S = len(sharding.axis_devices(mesh))
    words = st.enc[:4 * S].to(torch.int32)
    before = dict(build.LAUNCHES)
    sharding.scan_syndromes_sharded(code, st.enc, mesh=mesh)
    sharding.decode_sharded(code, words, mesh=mesh, n_iters=1)
    torch.cuda.synchronize()
    made = {k: build.LAUNCHES[k] - before.get(k, 0)
            for k in ("scan_syndromes", "fbp_cn")}
    if made != {"scan_syndromes": 2 * S, "fbp_cn": S}:
        raise AssertionError(f"sharded scan + one-iteration decode over "
                             f"{S} shards launched {made}")
    del mem
    return {**got, **times, "read_launches": read_launches,
            "phase3_read_s": want["read_s"],
            "phase3_scrub_s": want["scrub_s"],
            "launches_one_scan_one_decode": made}


def mesh_engine(cfg, params, mesh, want: dict) -> dict:
    """(b) phase 14's run (c) with the pool's pages sharded over `mesh`;
    `want` is run (c)'s tokens, tenant stats, injection and scrubs."""
    r = run_engine(params, cfg, engine_prompts(cfg),
                   inject_at=ENGINE_INJECT_STEP,
                   scrub_every=ENGINE_SCRUB_EVERY, check_scrub=False,
                   mesh=mesh)
    check_injected_run("sharded", r, want["tokens"])
    if r["tenant_stats"] != want["tenant_stats"]:
        raise AssertionError(f"sharded engine run: tenant stats "
                             f"{r['tenant_stats']}, run (c) "
                             f"{want['tenant_stats']}")
    if r["inject"] != want["inject"] or \
            r["scrub_reports"] != want["scrub_reports"]:
        raise AssertionError("sharded engine run: injection or scrubs "
                             "differ from run (c)'s")
    out = engine_summary(r)
    out["tenant_stats"] = r["tenant_stats"]
    return out


def mesh_phase_ab(device, cfg, params, memory: dict, engine_c: dict
                  ) -> tuple[dict, dict, list]:
    """Phase 19 (a) and (b). Returns (report, launches, devices)."""
    import torch
    from repro_torch.distributed.sharding import Mesh
    from repro_torch.kernels import build
    devices, kind = mesh_devices()
    smi = card_name()
    log(f"  mesh: {kind}: {[str(d) for d in devices]} ({smi})")
    mesh = Mesh(devices, ("data",))
    build.reset_launches()
    t0 = time.perf_counter()
    report = {"card": smi, "mesh": kind,
              "devices": [str(d) for d in devices],
              "memory": mesh_memory(device, mesh, memory)}
    log(f"  (a) memory mode over the mesh ({smi}): "
        f"{json.dumps(report['memory'])}")
    report["engine"] = mesh_engine(cfg, params, mesh, engine_c)
    log(f"  (b) engine run (c) over the mesh ({smi}): "
        f"{json.dumps(report['engine'])}")
    torch.cuda.synchronize()
    report["seconds"] = time.perf_counter() - t0
    return report, dict(build.LAUNCHES), devices


def mesh_moe(device, devices, phase16: dict) -> tuple[dict, dict]:
    """(c) olmoe-1b-7b served expert-parallel over a (data 1, model S)
    mesh, each MoE layer gated against the one-shard sorted_ep; `phase16`
    is phase 16's olmoe report. Returns (report, launches)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Mesh, use_rules
    from repro_torch.kernels import build
    from repro_torch.models import ProtectedKVConfig, init_params
    from repro_torch.nn import moe, moe_shard
    smi = card_name()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(MOE_ARCH), moe_impl="shard_ep")
    gen = torch.Generator(device=device).manual_seed(SEED)
    params = init_params(cfg, gen)
    prompts = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, device=device)
    mesh = Mesh(np.array(devices, dtype=object).reshape(1, -1),
                ("data", "model"))
    pkv = ProtectedKVConfig(code_name="wl160_r08", page_tokens=16)
    rows, seen = [], []
    shard_apply, dispatch = moe_shard.moe_shard_apply, moe.dispatch

    def counting(topi, n_experts, cap):
        plan = dispatch(topi, n_experts, cap)
        seen.append((~plan.keep).sum())
        return plan

    def checked(layer, x, c):
        seen.clear()
        y = shard_apply(layer, x, c)
        ep_drops = sum(seen)
        seen.clear()
        ref = moe.moe_sorted_ep(layer, x.reshape(-1, x.shape[-1]), c)
        rows.append(torch.stack([
            (y.reshape(ref.shape).float() - ref.float()).abs().max(),
            ref.float().abs().max(), ep_drops.float(), seen[0].float()]))
        return y

    build.reset_launches()
    moe.dispatch, moe_shard.moe_shard_apply = counting, checked
    try:
        with use_rules(mesh):
            run = serve_once(params, cfg, prompts, pkv, inject=False,
                             steps=SERVE_STEPS)
    finally:
        moe.dispatch, moe_shard.moe_shard_apply = dispatch, shard_apply
    launches = dict(build.LAUNCHES)
    with use_rules(mesh):
        timed = serve_once(params, cfg, prompts, pkv, inject=False,
                           steps=SERVE_STEPS)
    got = torch.stack(rows).cpu().tolist()
    n_moe = cfg.n_groups * sum(1 for s in cfg.group_spec if s.moe)
    if len(got) != n_moe * (SERVE_STEPS + 1):
        raise AssertionError(f"olmoe shard_ep: {len(got)} MoE layer calls "
                             f"checked, expected {n_moe * (SERVE_STEPS + 1)}")
    share = max(e / m for e, m, _, _ in got)
    bad = [i for i, (e, m, a, b) in enumerate(got)
           if not e <= MOE_EP_SHARE * m or a != b]
    tokens = run["tokens"].tolist()
    equal = sum(a == b for r1, r2 in zip(tokens, phase16["tokens"])
                for a, b in zip(r1, r2)) / (len(tokens) * len(tokens[0]))
    report = {"card": smi, "arch": cfg.name, "mesh": dict(mesh.shape),
              "moe_layer_calls": len(got), "max_err_share": share,
              "bound_share": MOE_EP_SHARE,
              "dropped_prefill": sum(int(r[2]) for r in got[:n_moe]),
              "dropped_per_step_max": max(
                  sum(int(r[2]) for r in got[n_moe * (i + 1):
                                             n_moe * (i + 2)])
                  for i in range(SERVE_STEPS)),
              "tokens_equal_share_phase16": equal,
              "checked": {k: run[k] for k in ("ttft_s",
                                              "ms_per_decode_step")},
              "timed": {k: timed[k] for k in (
                  "ttft_s", "ms_per_decode_step", "decode_tokens_per_s")},
              "phase16_sorted_ep": {k: phase16["clean"][k] for k in (
                  "ttft_s", "ms_per_decode_step", "decode_tokens_per_s")},
              "seconds": time.perf_counter() - t0}
    for r in (run, timed):
        r["caches"].free()
    del params
    if bad:
        raise AssertionError(f"olmoe shard_ep: MoE layer calls {bad[:8]} "
                             f"beyond {MOE_EP_SHARE} of their largest "
                             f"output or with other drops: "
                             f"{[got[i] for i in bad[:8]]}")
    return report, launches


# ---------------------------------------------------------------------------
# phase 20: data-parallel training over a mesh (FSDP)
# ---------------------------------------------------------------------------


def fsdp_mesh(devices):
    """A (data, model 1) mesh, one data shard a device of `devices`."""
    import numpy as np
    from repro_torch.distributed.sharding import Mesh
    return Mesh(np.array([[d] for d in devices], dtype=object),
                ("data", "model"))


def fsdp_rules(mesh, cfg, arch: str, batch: int, seq: int) -> dict:
    """`rules_for_cell`'s rules of a train shape, as the JAX driver's."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.cells import rules_for_cell, settings_for
    shape = ShapeSpec("custom", seq, batch, "train")
    return rules_for_cell(mesh, cfg, shape, settings_for(arch, shape))


def placed_bytes(tree) -> tuple[dict, int]:
    """(bytes each device holds of the placed tensors in `tree`, a tree of
    dicts and lists, by device; bytes of those tensors whole)."""
    from repro_torch.distributed.sharding import Placed
    held: dict[str, int] = {}
    whole = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        elif isinstance(node, Placed):
            size = node.local.flat[0].element_size()
            whole += math.prod(node.shape) * size
            for t in node.distinct():
                held[str(t.device)] = held.get(str(t.device), 0) + \
                    t.numel() * size
    return held, whole


def state_bytes(cfg, mesh, rules, placed) -> tuple[dict, int]:
    """`placed_bytes` of the optimizer state `launch.train.run` trains
    `placed` with (its `tx.init` of the placed leaves, made here and
    freed)."""
    from repro_torch.launch.steps import build_train
    state = build_train(cfg, mesh=mesh, rules=rules)[1].init(
        placed.leaves())
    out = placed_bytes(state)
    del state
    return out


def fsdp_dense(device, devices) -> tuple[dict, object, dict]:
    """(a) granite-3-2b at full width and depth, flash, remat "full",
    AdamW, seq 4096: FSDP_STEPS steps of `launch.train.run` over the mesh
    (FSDP_ROWS rows a shard, `rules_for_cell`'s rules), held to the
    unsharded trainer on `device` at microbatches = shards (microbatch i
    is shard i's rows), run first from the same seeded weights and freed
    before the mesh run. Returns (report, the placed model, the batch
    after the last step)."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), attn_impl="flash")
    n = len(devices)
    mesh = fsdp_mesh(devices)
    batch = FSDP_ROWS * n
    rules = fsdp_rules(mesh, cfg, TRAIN_ARCH, batch, TRAIN_SEQ)
    n_layers = cfg.n_groups * len(cfg.group_spec)
    kw = dict(steps=FSDP_STEPS, batch=batch, seq=TRAIN_SEQ, seed=SEED,
              save_every=FSDP_STEPS + 1, log_every=1,
              log=lambda m: log("    " + m))
    report = {"arch": cfg.name, "layers": n_layers, "shards": n,
              "batch": batch, "seq": TRAIN_SEQ, "rules_fsdp": rules["fsdp"]}

    torch.cuda.reset_peak_memory_stats(device)
    ref_model = init_params(cfg, SEED, device=device)
    with tempfile.TemporaryDirectory() as d:
        ref = run(cfg, params=ref_model, device=device, microbatches=n,
                  ckpt_dir=d, **kw)
    report["reference_peak_gb"] = torch.cuda.max_memory_allocated(
        device) / 1e9
    want = {name: p.detach().cpu() for name, p in
            ref_model.named_parameters()}
    del ref_model
    gc.collect()
    torch.cuda.empty_cache()

    for dev in dict.fromkeys(devices):
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    placed = place_params(init_params(cfg, SEED, device=devices[0]),
                          param_shardings(cfg, mesh, rules))
    torch.cuda.synchronize()
    report["place_s"] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        hist = run(cfg, params=placed, mesh=mesh, rules=rules, ckpt_dir=d,
                   **kw)
    report["peak_gb_by_card"] = {
        str(dev): torch.cuda.max_memory_allocated(dev) / 1e9
        for dev in dict.fromkeys(devices)}
    report["param_bytes_by_card"] = placed_bytes(placed.placed)[0]
    report["state_bytes_by_card"] = state_bytes(cfg, mesh, rules, placed)[0]
    report["steps"] = [
        {"step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
         "reference_loss": r["loss"], "reference_grad_norm": r["grad_norm"],
         "ms": h["seconds"] * 1e3, "reference_ms": r["seconds"] * 1e3,
         "tokens_per_s": batch * TRAIN_SEQ / h["seconds"],
         "launches_by_shard": h["launches_by_shard"]}
        for h, r in zip(hist, ref, strict=True)]
    per_shard = {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers,
                 "flash_bwd_dkv": n_layers}
    for i, (h, r) in enumerate(zip(hist, ref, strict=True)):
        rtol = FSDP_RTOL0 if i == 0 else FSDP_RTOL
        for key in ("loss", "grad_norm"):
            if not abs(h[key] - r[key]) <= rtol * abs(r[key]):
                raise AssertionError(f"step {i}: mesh {key} {h[key]} "
                                     f"against the unsharded {r[key]}")
        for k, got in enumerate(h["launches_by_shard"]):
            got = {name: got.get(name, 0) for name in per_shard}
            if got != per_shard:
                raise AssertionError(f"step {i} shard {k}: flash launches "
                                     f"{got}, expected {per_shard}")
    largest, equal, total = 0.0, 0, 0
    for name, p in placed.placed.items():
        got = p.gather(devices[0]).detach().cpu()
        largest = max(largest, float((got - want[name]).abs().max()))
        equal += int((got == want[name]).sum())
        total += got.numel()
    report["param_max_abs_diff"] = largest
    report["params_bitwise_equal"] = equal == total
    report["params_equal_share"] = equal / total
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                      global_batch=batch, seed=SEED)
    return report, placed, next(TokenPipeline(dcfg, step=FSDP_STEPS))


def fsdp_psum(cfg, placed, batch) -> dict:
    """(b) `compressed_psum` over `data` on (a)'s real gradients: each
    shard's own gradient (its loss part's backward alone) of the
    embedding, the final norm and the first and last layers' tensors,
    two rounds, the second on the first round's residuals. Each leaf's
    error against the exact mean of (gradient + residual) must stay
    within sum(scale_i) / (2n) plus fp32 rounding."""
    import torch
    from repro_torch.distributed import compression
    from repro_torch.distributed.sharding import axis_devices
    from repro_torch.models import loss_fn
    mesh = placed.mesh
    devices = axis_devices(mesh, "data")
    n = len(devices)
    last = cfg.n_groups * len(cfg.group_spec) - 1
    names = [k for k in placed.placed if k in ("embed", "final_norm.scale")
             or k.startswith(("blocks.0.", f"blocks.{last}."))]
    rows = batch["tokens"].shape[0] // n
    count = max(int((batch["labels"] >= 0).sum()), 1)
    grads = {k: [] for k in names}
    for k, dev in enumerate(devices):
        placed.zero_grad()
        sb = {key: torch.as_tensor(v[k * rows:(k + 1) * rows], device=dev)
              for key, v in batch.items()}
        loss_fn(placed.skeleton, cfg, sb, weights=placed.weights(dev),
                count=count).backward()
        with torch.no_grad():
            # a replicated leaf's copy on another card took no gradient
            # from this shard
            for name in names:
                grads[name].append(placed.placed[name].map(
                    lambda t: torch.zeros_like(t) if t.grad is None
                    else t.grad).gather(dev))
    placed.zero_grad()
    worst, numel = 0.0, 0
    t0 = time.perf_counter()
    for name in names:
        xs = grads[name]
        numel += xs[0].numel()
        efs = [compression.init_ef(x) for x in xs]
        for _round in range(2):
            inputs = [x + ef.residual for x, ef in zip(xs, efs, strict=True)]
            outs, efs = compression.compressed_psum(xs, efs, mesh)
            exact = sum(x.double().to(devices[0]) for x in inputs) / n
            scales = [float(torch.clamp_min(x.abs().max(), 1e-12)) / 127
                      for x in inputs]
            bound = sum(scales) / (2 * n) + n * 2 ** -22 * 127 * max(scales)
            for out in outs:
                err = float((out.double().to(devices[0]) - exact).abs().max())
                worst = max(worst, err / bound)
                if not err <= bound:
                    raise AssertionError(f"compressed_psum {name}: error "
                                         f"{err} over the bound {bound}")
    torch.cuda.synchronize()
    pairs = n * (n - 1)
    crossing = sum(1 for i in range(n) for j in range(n)
                   if devices[i] != devices[j])
    return {"tensors": len(names), "elements": numel,
            "rounds": 2, "largest_error_over_bound": worst,
            "seconds": time.perf_counter() - t0,
            "int8_bytes_all_pairs": pairs * (numel + 4 * len(names)),
            "fp32_bytes_all_pairs": pairs * 4 * numel,
            "device_pairs_crossed": crossing,
            "int8_bytes_crossing_devices": crossing * (numel
                                                       + 4 * len(names))}


def leaf_arrays(tree, prefix: str = "") -> dict:
    """A tree of dicts and lists -> {path: numpy array of its leaf}, a
    placed leaf read whole."""
    import numpy as np
    import torch
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(leaf_arrays(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().cpu().numpy()}
    if hasattr(tree, "sharding"):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


def fsdp_elastic(device, devices) -> dict:
    """(c) phase 10's reduced granite over the mesh, 3 steps, an
    NB-LDPC-protected checkpoint at step 2, storage faults injected, then
    restored onto half the shards and onto no mesh: every leaf bit for
    bit (the restore also checks each leaf against the saved checksum),
    and one more step of a run resumed from it on each."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import checkpoint, optim
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import build_train
    from repro_torch.launch.train import run
    from repro_torch.memory import uniform_flip
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    cfg = dataclasses.replace(get_config(TRAIN_ARCH).reduced(
        n_groups=2, d_model=128, n_heads=4, d_ff=512), attn_impl="flash")
    n = len(devices)
    mesh, half = fsdp_mesh(devices), fsdp_mesh(devices[:n // 2])
    rules = fsdp_rules(mesh, cfg, TRAIN_ARCH, 4, 64)
    rules_half = fsdp_rules(half, cfg, TRAIN_ARCH, 4, 64)
    kw = dict(batch=4, seq=64, lr=5e-3, seed=SEED, protect=True,
              log=lambda m: None)
    placed = place_params(init_params(cfg, SEED, device=devices[0]),
                          param_shardings(cfg, mesh, rules))
    with tempfile.TemporaryDirectory() as d:
        ck = os.path.join(d, "mesh")
        hist = run(cfg, steps=3, params=placed, mesh=mesh, rules=rules,
                   ckpt_dir=ck, save_every=2, **kw)
        changed = checkpoint.inject_storage_faults(
            ck, uniform_flip(3, 1e-4), key=SEED, device=devices[0])
        (p_sh, o_sh, _), _ = build_train(cfg, mesh=half, rules=rules_half)[
            2](half, rules_half)
        leaves = placed.leaves()
        on_half, manifest = checkpoint.restore_checkpoint(
            ck, {"params": leaves, "opt": optim.adamw(1.0).init(leaves)},
            shardings={"params": p_sh, "opt": o_sh}, device=devices[0])
        whole = placed.gather(device).leaves()
        on_none, _ = checkpoint.restore_checkpoint(
            ck, {"params": whole, "opt": optim.adamw(1.0).init(whole)},
            device=device)
        got, ref = leaf_arrays(on_half), leaf_arrays(on_none)
        trained = leaf_arrays({"params": leaves})
        exact = got.keys() == ref.keys() and all(
            np.array_equal(v, ref[k]) and (k not in trained or
                                           np.array_equal(v, trained[k]))
            for k, v in got.items())
        if any(p.sharding.mesh is not half for ps in on_half[
                "params"].values() for p in ps):
            raise AssertionError("a leaf restored onto another mesh")
        del on_half, on_none, whole
        resumed = {}
        for name, m, r, dev in (("half", half, rules_half, None),
                                ("none", None, None, device)):
            rd = os.path.join(d, name)
            shutil.copytree(ck, rd)
            resumed[name] = run(cfg, steps=3, mesh=m, rules=r, device=dev,
                                ckpt_dir=rd, save_every=100, **kw)
    stats = manifest["correction_stats"]
    report = {"losses": [h["loss"] for h in hist], "injected_cells": changed,
              "restore_corrected": stats["corrected"],
              "restore_uncorrectable": stats["uncorrectable"],
              "restored_exactly": exact,
              "resumed": {k: [(h["step"], h["loss"]) for h in v]
                          for k, v in resumed.items()}}
    if changed <= 0 or stats["corrected"] <= 0 or not exact:
        raise AssertionError(f"elastic restore: {report}")
    for name, h in resumed.items():
        if [x["step"] for x in h] != [2] or not np.isfinite(h[0]["loss"]):
            raise AssertionError(f"resumed run ({name}): {h}")
    a, b = resumed["half"][0]["loss"], resumed["none"][0]["loss"]
    if not abs(a - b) <= FSDP_RTOL * abs(b):
        raise AssertionError(f"resumed losses: half mesh {a}, no mesh {b}")
    return report


def fsdp_moe(devices) -> dict:
    """(d) olmoe-1b-7b at full width and depth over FSDP_MOE_CARDS cards,
    AdamW, one row of TRAIN_SEQ tokens a card, FSDP_STEPS steps: finite
    losses, each card holding about a quarter of the parameters and of
    the AdamW states the trainer makes for them, the slots dropped at
    capacity a step and each card's peak memory."""
    import tempfile
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    cfg = get_config(FSDP_MOE_ARCH)
    cards = devices[:FSDP_MOE_CARDS]
    mesh = fsdp_mesh(cards)
    batch = len(cards)
    rules = fsdp_rules(mesh, cfg, FSDP_MOE_ARCH, batch, TRAIN_SEQ)
    for dev in cards:
        torch.cuda.reset_peak_memory_stats(dev)
    placed = place_params(init_params(cfg, SEED, device=cards[0]),
                          param_shardings(cfg, mesh, rules))
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        hist = run(cfg, steps=FSDP_STEPS, batch=batch, seq=TRAIN_SEQ,
                   seed=SEED, params=placed, mesh=mesh, rules=rules,
                   ckpt_dir=d, save_every=FSDP_STEPS + 1, log_every=1,
                   log=lambda m: log("    " + m))
    held, total = placed_bytes(placed.placed)
    state_held, state_total = state_bytes(cfg, mesh, rules, placed)
    report = {"arch": cfg.name, "cards": [str(c) for c in cards],
              "parameters": sum(math.prod(p.shape)
                                for p in placed.placed.values()),
              "param_bytes_total": total, "param_bytes_by_card": held,
              "state_bytes_total": state_total,
              "state_bytes_by_card": state_held,
              "peak_gb_by_card": {str(c): torch.cuda.max_memory_allocated(
                  c) / 1e9 for c in cards},
              "steps": [{"step": h["step"], "loss": h["loss"],
                         "grad_norm": h["grad_norm"],
                         "ms": h["seconds"] * 1e3,
                         "tokens_per_s": batch * TRAIN_SEQ / h["seconds"],
                         "moe_dropped": h["moe_dropped"]} for h in hist]}
    for h in hist:
        if not (torch.isfinite(torch.tensor(h["loss"])) and
                torch.isfinite(torch.tensor(h["grad_norm"]))):
            raise AssertionError(f"olmoe step {h['step']}: {h}")
    for card, b in held.items():
        b += state_held.get(card, 0)
        if not b <= FSDP_CARD_SHARE * (total + state_total):
            raise AssertionError(f"{card} holds {b} of {total + state_total}"
                                 " bytes of parameters and AdamW states")
    del placed
    return report


def phase_fsdp(device) -> tuple[dict, dict]:
    """Phase 20: (a)-(c) on mesh_devices()'s devices, (d) where
    FSDP_MOE_CARDS cards are visible. Returns (report, launches)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    devices, kind = mesh_devices()
    smi = card_name()
    log(f"  mesh: {kind}: {[str(d) for d in devices]} ({smi})")
    build.reset_launches()
    t0 = time.perf_counter()
    report = {"card": smi, "mesh": kind}
    report["dense"], placed, batch = fsdp_dense(device, devices)
    log(f"  (a) granite-3-2b FSDP ({smi}): {json.dumps(report['dense'])}")
    report["psum"] = fsdp_psum(get_config(TRAIN_ARCH), placed, batch)
    log(f"  (b) compressed_psum on (a)'s gradients ({smi}): "
        f"{json.dumps(report['psum'])}")
    del placed, batch
    gc.collect()
    torch.cuda.empty_cache()
    report["elastic"] = fsdp_elastic(device, devices)
    log(f"  (c) elastic restore ({smi}): {json.dumps(report['elastic'])}")
    if len(set(devices)) >= FSDP_MOE_CARDS:
        report["moe"] = fsdp_moe(devices)
        log(f"  (d) olmoe-1b-7b FSDP ({smi}): {json.dumps(report['moe'])}")
    else:
        log(f"  (d) olmoe-1b-7b FSDP needs {FSDP_MOE_CARDS} cards, "
            f"{len(set(devices))} visible: not run")
    gc.collect()
    torch.cuda.empty_cache()
    report["seconds"] = time.perf_counter() - t0
    return report, dict(build.LAUNCHES)


def tp_mesh(shape):
    """A (data, model) mesh of `shape`: position (k, j) on card k·model + j
    where that many cards are visible, else every position on card 0;
    and which it was."""
    import numpy as np
    import torch
    from repro_torch.distributed.sharding import Mesh
    n, (data, model) = torch.cuda.device_count(), shape
    if n >= data * model:
        devs = [[torch.device("cuda", k * model + j) for j in range(model)]
                for k in range(data)]
        kind = f"{data * model} cards"
    else:
        devs = [[torch.device("cuda", 0)] * model] * data
        kind = f"one card, {data * model} positions on it"
    return Mesh(np.array(devs, dtype=object), ("data", "model")), kind


def tp_checks(cfg, mesh, placed, hist, per_layer: int | None) -> dict:
    """Phase 21's structural gates on a tensor-parallel run: every placed
    slice of a leaf the rules split over `model` holds 1/(data x model)
    of it (the data shards' `fsdp` split too, where it divides), and
    each position's flash calls carry Hq/M query heads (all of them
    where `model` does not divide Hq) with `per_layer` launches of the
    forward (twice a layer: remat) and the backward kernels. Returns the
    flash launches and heads by position of the first step."""
    from repro_torch.distributed.sharding import model_dim
    data, M = mesh.devices.shape
    for name, p in placed.placed.items():
        if model_dim(p.sharding, p.ndim) is None:
            continue
        parts = math.prod(p.sharding.parts(p.ndim))
        whole = math.prod(p.shape)
        for t in p.distinct():
            if t.numel() * parts != whole:
                raise AssertionError(f"{name}: a slice of {t.numel()} of "
                                     f"{whole} over {parts} parts")
    hq = cfg.n_heads // M if cfg.n_heads % M == 0 else cfg.n_heads
    hkv = cfg.n_kv_heads // M if cfg.n_kv_heads % M == 0 else None
    first = hist[0]
    report = {"launches_by_position": first["launches_by_shard"],
              "heads_by_position": first["heads_by_shard"]}
    if per_layer is None:
        return report
    want = {"flash_fwd": 2 * per_layer, "flash_bwd_dq": per_layer,
            "flash_bwd_dkv": per_layer}
    for h in hist:
        for pos, (got, heads) in enumerate(zip(
                h["launches_by_shard"], h["heads_by_shard"], strict=True)):
            got = {k: got.get(k, 0) for k in want}
            if got != want:
                raise AssertionError(f"step {h['step']} position {pos}: "
                                     f"flash launches {got}, want {want}")
            if not heads or {x[1] for x in heads} != {hq} or (
                    hkv is not None and {x[2] for x in heads} != {hkv}):
                raise AssertionError(f"step {h['step']} position {pos}: "
                                     f"flash heads {heads}, want {hq} "
                                     f"query and {hkv} KV heads")
    return report


def tp_against_unsharded(cfg, arch: str, shape, *, rows: int, steps: int,
                         label: str) -> dict:
    """`steps` steps of `launch.train.run` over a (data, model) mesh of
    `shape` from seeded weights, held to the unsharded trainer on card 0
    at microbatches = data shards (run first, its parameters kept on the
    host, freed before the mesh run) under phase 21's gates."""
    import tempfile
    import torch
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    mesh, kind = tp_mesh(shape)
    data = shape[0]
    devices = list(dict.fromkeys(mesh.devices.flat))
    batch = rows * data
    rules = fsdp_rules(mesh, cfg, arch, batch, TRAIN_SEQ)
    n_attn = cfg.n_groups * sum(s.kind != "mamba" for s in cfg.group_spec)
    kw = dict(steps=steps, batch=batch, seq=TRAIN_SEQ, seed=SEED,
              save_every=steps + 1, log_every=1,
              log=lambda m: log(f"    {label}: " + m))
    report = {"arch": cfg.name, "mesh": list(shape), "where": kind,
              "batch": batch, "seq": TRAIN_SEQ,
              "rules": {k: rules[k] for k in ("heads", "kv_heads", "vocab",
                                              "d_ff", "fsdp")}}
    dev0 = devices[0]
    torch.cuda.reset_peak_memory_stats(dev0)
    ref_model = init_params(cfg, SEED, device=dev0)
    with tempfile.TemporaryDirectory() as d:
        ref = run(cfg, params=ref_model, device=dev0, microbatches=data,
                  ckpt_dir=d, **kw)
    report["reference_peak_gb"] = torch.cuda.max_memory_allocated(dev0) / 1e9
    want = {name: p.detach().cpu() for name, p in
            ref_model.named_parameters()}
    del ref_model
    gc.collect()
    torch.cuda.empty_cache()
    for dev in devices:
        torch.cuda.reset_peak_memory_stats(dev)
    placed = place_params(init_params(cfg, SEED, device=dev0),
                          param_shardings(cfg, mesh, rules))
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        hist = run(cfg, params=placed, mesh=mesh, rules=rules, ckpt_dir=d,
                   **kw)
    report["peak_gb_by_card"] = {
        str(dev): torch.cuda.max_memory_allocated(dev) / 1e9
        for dev in devices}
    report["param_bytes_by_card"] = placed_bytes(placed.placed)[0]
    report["steps"] = []
    for i, (h, r) in enumerate(zip(hist, ref, strict=True)):
        gaps = {k: abs(h[k] - r[k]) / abs(r[k]) for k in ("loss",
                                                           "grad_norm")}
        report["steps"].append({
            "step": h["step"], "loss": h["loss"], "grad_norm": h["grad_norm"],
            "reference_loss": r["loss"],
            "reference_grad_norm": r["grad_norm"],
            "loss_gap": gaps["loss"], "grad_norm_gap": gaps["grad_norm"],
            "ms": h["seconds"] * 1e3, "reference_ms": r["seconds"] * 1e3,
            "tokens_per_s": batch * TRAIN_SEQ / h["seconds"]})
        bounds = {"loss": TP_RTOL0_LOSS if i == 0 else TP_RTOL,
                  "grad_norm": TP_RTOL0_GNORM if i == 0 else None}
        for key, bound in bounds.items():
            if bound is not None and not gaps[key] <= bound:
                raise AssertionError(
                    f"{label} step {i}: {key} {h[key]} against the "
                    f"unsharded {r[key]} (gap {gaps[key]}, bound {bound})")
    report.update(tp_checks(cfg, mesh, placed, hist,
                            n_attn if cfg.attn_impl == "flash" else None))
    largest = 0.0
    for name, p in placed.placed.items():
        got = p.gather(dev0).detach().cpu()
        largest = max(largest, float((got - want[name]).abs().max()))
    report["param_max_abs_diff"] = largest
    del placed, want
    gc.collect()
    torch.cuda.empty_cache()
    return report


def tp_deep(cfg) -> dict:
    """(b) on four cards: `cfg` without a reference, one row, 3 steps on
    (1, 4): each card places 25% of every model-split leaf and peaks
    under its share of the parameters and gradients plus
    TP_ACTIVATION_GB."""
    import tempfile
    import torch
    from repro_torch.distributed.sharding import model_dim
    from repro_torch.launch.train import run
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    mesh, kind = tp_mesh((1, 4))
    devices = list(mesh.devices.flat)
    rules = fsdp_rules(mesh, cfg, TP_BIG_ARCH, 1, TRAIN_SEQ)
    placed = place_params(init_params(cfg, SEED, device=devices[0]),
                          param_shardings(cfg, mesh, rules))
    gc.collect()
    torch.cuda.empty_cache()
    for dev in devices:
        torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as d:
        hist = run(cfg, steps=TP_STEPS, batch=1, seq=TRAIN_SEQ, seed=SEED,
                   params=placed, mesh=mesh, rules=rules, ckpt_dir=d,
                   save_every=TP_STEPS + 1, log_every=1,
                   log=lambda m: log("    (b) deep: " + m))
    held, whole = placed_bytes(placed.placed)
    split_held: dict[str, int] = {}
    split_whole = 0
    for p in placed.placed.values():
        if model_dim(p.sharding, p.ndim) is None:
            continue
        size = p.local.flat[0].element_size()
        split_whole += math.prod(p.shape) * size
        for t in p.distinct():
            split_held[str(t.device)] = split_held.get(str(t.device), 0) \
                + t.numel() * size
    report = {"arch": cfg.name, "groups": cfg.n_groups, "where": kind,
              "param_bytes_total": whole, "param_bytes_by_card": held,
              "split_share_by_card": {c: b / split_whole
                                      for c, b in split_held.items()},
              "peak_gb_by_card": {str(c): torch.cuda.max_memory_allocated(
                  c) / 1e9 for c in devices},
              "steps": [{"step": h["step"], "loss": h["loss"],
                         "grad_norm": h["grad_norm"],
                         "ms": h["seconds"] * 1e3,
                         "tokens_per_s": TRAIN_SEQ / h["seconds"]}
                        for h in hist]}
    share_gb = 2 * whole / len(devices) / 1e9     # parameters + gradients
    for card, share in report["split_share_by_card"].items():
        if abs(share - 0.25) > 1e-9:
            raise AssertionError(f"{card} places {share} of the split leaves")
    for card, peak in report["peak_gb_by_card"].items():
        if not peak <= share_gb + TP_ACTIVATION_GB:
            raise AssertionError(f"{card} peaks at {peak} GB over its share "
                                 f"{share_gb} GB + {TP_ACTIVATION_GB} GB")
    for h in hist:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"(b) deep step {h['step']}: {h}")
    tp_checks(cfg, mesh, placed, hist, cfg.n_groups)
    del placed
    gc.collect()
    for dev in devices:
        with torch.cuda.device(dev):
            torch.cuda.empty_cache()
    return report


def tp_layer_kinds(device) -> dict:
    """(c) every config of ARCH_IDS reduced, and TP_FULL_ARCHS at full
    width with TP_FULL_GROUPS groups (flash), one step on (1, 4) from the
    unsharded trainer's weights against its step on the card."""
    import copy
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch.steps import build_train
    from repro_torch.models import init_params
    from repro_torch.models.lm import param_shardings, place_params
    mesh, kind = tp_mesh((1, 4))
    M = mesh.devices.shape[1]
    report = {"where": kind}
    cases = []
    for arch in ARCH_IDS:
        base = get_config(arch)
        cases.append((arch, dataclasses.replace(base.reduced(
            n_groups=2, d_model=256, n_heads=8, n_kv_heads=2,
            d_ff=512 if base.d_ff else 0), attn_impl="flash")))
    for arch in TP_FULL_ARCHS:
        base = get_config(arch)
        cases.append((f"{arch}_full", dataclasses.replace(
            base, n_groups=TP_FULL_GROUPS, attn_impl="flash",
            encoder_groups=min(base.encoder_groups, TP_FULL_GROUPS))))
    for key, cfg in cases:
        arch = key.removesuffix("_full")
        rng = np.random.default_rng(SEED)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 256)),
                 "labels": rng.integers(0, cfg.vocab_size, (2, 256))}
        if cfg.aux_kind:
            batch["aux"] = (0.1 * rng.normal(size=(
                2, cfg.n_aux_tokens, cfg.d_model))).astype(np.float32)
        start = init_params(cfg, SEED, device=device)
        step, tx, _ = build_train(cfg)
        ref_model = copy.deepcopy(start)
        _, want = step(ref_model, tx.init(ref_model.leaves()), batch)
        rules = fsdp_rules(mesh, cfg, arch, 2, 256)
        placed = place_params(start, param_shardings(cfg, mesh, rules))
        tstep, ttx, _ = build_train(cfg, mesh=mesh, rules=rules)
        _, got = tstep(placed, ttx.init(placed.leaves()), batch)
        gaps = {k: abs(float(got[k]) - float(want[k])) / abs(float(want[k]))
                for k in ("loss", "grad_norm")}
        attends = any(s.kind != "mamba" for s in cfg.group_spec)
        hist = [{"step": 0, "launches_by_shard": got["launches_by_shard"],
                 "heads_by_shard": got["heads_by_shard"]}]
        checks = tp_checks(cfg, mesh, placed, hist, None)
        heads = {x for hs in got["heads_by_shard"] for x in hs}
        hq = cfg.n_heads // M if cfg.n_heads % M == 0 else cfg.n_heads
        report[key] = {"d_model": cfg.d_model, "n_groups": cfg.n_groups,
                       "loss": float(got["loss"]),
                       "grad_norm": float(got["grad_norm"]),
                       "loss_gap": gaps["loss"],
                       "grad_norm_gap": gaps["grad_norm"],
                       "heads": sorted(heads),
                       "launches_position_0": checks[
                           "launches_by_position"][0]}
        if not (gaps["loss"] <= TP_RTOL0_LOSS
                and gaps["grad_norm"] <= TP_RTOL0_GNORM):
            raise AssertionError(f"(c) {key}: {report[key]}")
        if attends and (not heads or {x[1] for x in heads} != {hq}):
            raise AssertionError(f"(c) {key}: flash heads {sorted(heads)}, "
                                 f"want {hq} query heads")
        del start, ref_model, placed
        gc.collect()
        torch.cuda.empty_cache()
    return report


def phase_tp(device) -> tuple[dict, dict]:
    """Phase 21: (a)-(c); (b)'s deeper cut where four cards are visible.
    Returns (report, launches)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    smi = card_name()
    build.reset_launches()
    t0 = time.perf_counter()
    report = {"card": smi}
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), attn_impl="flash")
    for shape in TP_MESHES:
        key = f"dense_{shape[0]}x{shape[1]}"
        report[key] = tp_against_unsharded(
            cfg, TRAIN_ARCH, shape, rows=TP_ROWS, steps=TP_STEPS,
            label=f"(a) {shape}")
        log(f"  (a) granite-3-2b TP {shape} ({smi}): "
            f"{json.dumps(report[key])}")
    big = dataclasses.replace(get_config(TP_BIG_ARCH), attn_impl="flash",
                              n_groups=TP_BIG_GROUPS)
    report["big"] = tp_against_unsharded(big, TP_BIG_ARCH, (1, 4), rows=1,
                                         steps=TP_STEPS, label="(b)")
    log(f"  (b) mistral-large-123b, {TP_BIG_GROUPS} groups, TP (1, 4) "
        f"({smi}): {json.dumps(report['big'])}")
    if torch.cuda.device_count() >= 4:
        report["big_deep"] = tp_deep(dataclasses.replace(
            big, n_groups=TP_BIG_DEEP_GROUPS))
        log(f"  (b) mistral-large-123b, {TP_BIG_DEEP_GROUPS} groups, four "
            f"cards ({smi}): {json.dumps(report['big_deep'])}")
    else:
        log(f"  (b) {TP_BIG_DEEP_GROUPS} groups needs four cards, "
            f"{torch.cuda.device_count()} visible: not run")
    report["layer_kinds"] = tp_layer_kinds(device)
    log(f"  (c) every layer kind, TP (1, 4) ({smi}): "
        f"{json.dumps(report['layer_kinds'])}")
    report["seconds"] = time.perf_counter() - t0
    return report, dict(build.LAUNCHES)


def check_path(name: str, launches: dict, kernels) -> None:
    missing = [k for k in kernels if launches.get(k, 0) <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the {name} path: "
                             f"{missing}")


def main() -> int:
    # cuBLAS's documented setting for run-to-run reproducible results,
    # set before the first matmul: phase 8 compares two serving runs bit
    # for bit
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import KERNELS, build

    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    log("phase 1: build")
    build.library(verbose=True)
    log(f"  built in {build.build_seconds:.2f} s")
    log(f"  kernels' registers and spills: "
        f"{json.dumps(ptxas_report(build.build_logs))}")

    log("phase 2: kernels against their plain versions")
    rows = phase_kernels(device)
    rows["attend_protected"] = phase_attend(device)
    rows.update(phase_flash(device))

    log("phase 3-4: main path (memory mode, PIM mode)")
    build.reset_launches()
    per_call: dict[str, dict] = {}
    memory, mem = phase_memory(device, per_call)
    pim = phase_pim(device, per_call)
    codec_launches = dict(build.LAUNCHES)
    log(f"  launches on the main path: {codec_launches}")
    log(f"  launches per entry-point call: {json.dumps(per_call)}")
    check_path("memory/PIM", codec_launches,
               ("gf_matmul", "scan_syndromes", "fbp_cn", "pim_mac"))

    log("phase 5: small inputs against the CPU")
    phase_small_reference(device)

    log("phase 6: where a read's time goes")
    profile = phase_profile(mem)
    del mem

    log("phase 7: small protected decode against the CPU")
    phase_small_serving(device)

    log("phase 8: protected KV-cache serving, paper-pim-2b")
    serving, serve_launches, serve_model = phase_serving(device)
    log(f"  launches on the serving path: {serve_launches}")
    check_path("serving", serve_launches,
               ("attend_protected", "gf_matmul", "scan_syndromes", "fbp_cn"))

    log("phase 9: flash prefill, paper-pim-2b")
    prefill_report, prefill_launches = phase_prefill(device, *serve_model)
    log(f"  launches on the prefill path: {prefill_launches}")
    check_path("prefill", prefill_launches, ("flash_fwd",))

    log("phase 12: PIM-protected serving, paper-pim-2b")
    pim_serving, pim_launches = phase_pim_serving(device, *serve_model)
    log(f"  launches on the PIM serving path: {pim_launches}")
    check_path("PIM serving", pim_launches,
               ("pim_mac", "scan_syndromes", "fbp_cn", "gf_matmul",
                "attend_protected"))
    log("phase 14: multi-tenant serving engine, paper-pim-2b")
    from repro_torch import obs
    instruments = obs.instrument_count()
    engine, engine_launches, engine_runs = phase_engine(device,
                                                        *serve_model[:2])
    log(f"  launches on the engine path: {engine_launches}")
    check_path("engine", engine_launches,
               ("attend_protected", "gf_matmul", "scan_syndromes",
                "fbp_cn"))
    log("phase 15: telemetry and the sanitizer, paper-pim-2b")
    engine_c = {k: engine_runs["injected"][k] for k in (
        "tokens", "tenant_stats", "inject", "scrub_reports")}
    telemetry, telemetry_launches = phase_telemetry(
        device, *serve_model[:2], engine_runs, engine, instruments)
    del engine_runs
    log(f"  launches on the telemetry path: {telemetry_launches}")
    check_path("telemetry", telemetry_launches,
               ("attend_protected", "gf_matmul", "scan_syndromes",
                "fbp_cn"))
    log("phase 19 (a, b): the device mesh: memory mode, the engine")
    mesh_report, mesh_launches, mesh_devs = mesh_phase_ab(
        device, *serve_model[:2], memory, engine_c)
    del engine_c
    log(f"  launches on the mesh paths: {mesh_launches}")
    check_path("mesh (a, b)", mesh_launches,
               ("attend_protected", "gf_matmul", "scan_syndromes",
                "fbp_cn"))
    prompts = serve_model[2]
    del serve_model                    # free the serving model's 6.9 GB
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 17: PIM-protected training pass, paper-pim-2b")
    pim_training, pim_train_launches = phase_pim_training(device, prompts)
    del prompts
    log(f"  launches on the PIM training path: {pim_train_launches}")
    check_path("PIM training", pim_train_launches, PIM_TRAIN_KERNELS)

    log("phase 16: the rest of the LM substrate (MoE, mamba, "
        "encoder-decoder, cross)")
    substrate, substrate_launches = phase_substrate(device)
    log(f"  launches on the substrate paths: {substrate_launches}")
    log(f"  phase 16 took {substrate['seconds']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 19 (c): the device mesh: expert-parallel olmoe-1b-7b")
    mesh_report["moe"], mesh_moe_launches = mesh_moe(
        device, mesh_devs, substrate["moe"])
    log(f"  (c) olmoe-1b-7b shard_ep ({mesh_report['moe']['card']}): "
        f"{json.dumps(mesh_report['moe'])}")
    log(f"  launches on the expert-parallel path: {mesh_moe_launches}")
    check_path("mesh (c)", mesh_moe_launches,
               ("attend_protected", "gf_matmul", "scan_syndromes"))
    gc.collect()
    torch.cuda.empty_cache()

    log("phase 13: BER campaign, wl1024_r08")
    campaign, campaign_launches = phase_campaign(device)
    log(f"  launches on the campaign path: {campaign_launches}")
    check_path("campaign", campaign_launches,
               ("gf_matmul", "scan_syndromes", "fbp_cn"))

    log("phase 10: reduced training, card against CPU, protected "
        "checkpoint")
    build.reset_launches()
    small_training = phase_small_training(device)
    log("phase 11: full-size training, granite-3-2b")
    full_training = phase_full_training(device)
    train_launches = dict(build.LAUNCHES)
    log(f"  launches on the training path: {train_launches}")
    check_path("training", train_launches,
               ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "gf_matmul",
                "scan_syndromes", "fbp_cn"))
    log("phase 20: data-parallel training over a mesh (FSDP)")
    fsdp, fsdp_launches = phase_fsdp(device)
    log(f"  launches on the FSDP path: {fsdp_launches}")
    log(f"  phase 20 took {fsdp['seconds']:.1f} s")
    check_path("FSDP", fsdp_launches, FSDP_KERNELS)
    log("phase 21: tensor-parallel training over (data, model) meshes")
    tp, tp_launches = phase_tp(device)
    log(f"  launches on the tensor-parallel path: {tp_launches}")
    log(f"  phase 21 took {tp['seconds']:.1f} s")
    check_path("tensor-parallel", tp_launches, TP_KERNELS)
    log("phase 18: the port's examples")
    examples = phase_examples()
    log(f"  examples: {json.dumps(examples)}")
    launches = {k: sum(path.get(k, 0) for path in (
        codec_launches, serve_launches, prefill_launches, pim_launches,
        engine_launches, telemetry_launches, pim_train_launches,
        substrate_launches, campaign_launches, train_launches,
        mesh_launches, mesh_moe_launches, fsdp_launches, tp_launches))
        for k in KERNELS}

    # one row per kernel, at the shape its first check used (the main
    # path's: p=3 for FBP, the ideal ADC for the MAC, the serving shape
    # for attend_protected, the training shape for the flash kernels); the
    # other checked shapes are in the phase 2 log lines above
    kernels = [{"name": name, "route": "cuda", "source": SOURCES[name],
                "replaces": REPLACES[name], "launches": launches[name],
                **{k: rows[name][0][k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")}} for name in KERNELS]
    smi = card_name()
    log(json.dumps({"memory": memory, "pim": pim, "profile": profile,
                    "serving": serving, "prefill": prefill_report,
                    "pim_serving": pim_serving, "engine": engine,
                    "telemetry": telemetry, "pim_training": pim_training,
                    "substrate": substrate, "examples": examples,
                    "mesh": mesh_report, "fsdp": fsdp, "tp": tp,
                    "campaign": campaign,
                    "small_training": small_training,
                    "full_training": full_training,
                    "launches_per_call": per_call,
                    "launches_codec": codec_launches,
                    "launches_serving": serve_launches,
                    "launches_prefill": prefill_launches,
                    "launches_pim_serving": pim_launches,
                    "launches_engine": engine_launches,
                    "launches_telemetry": telemetry_launches,
                    "launches_pim_training": pim_train_launches,
                    "launches_substrate": substrate_launches,
                    "launches_campaign": campaign_launches,
                    "launches_training": train_launches,
                    "launches_mesh": mesh_launches,
                    "launches_mesh_moe": mesh_moe_launches,
                    "launches_fsdp": fsdp_launches,
                    "launches_tp": tp_launches,
                    "seconds": time.perf_counter() - t0}))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
