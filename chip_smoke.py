#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA
H100: builds the CUDA kernels, holds each against its plain PyTorch version,
times them, trains full-width GPT-2 small with DSM and AdamW local steps
through ``run_training``, checks the card against the CPU on nano, then
trains full-width GPT-2 small with every baseline of the paper's comparison
(and DSM with Sophia local steps and with the randomized sign) and holds
every algorithm and base optimizer on the card against the CPU on nano.
Then fault-tolerant DSM: full width under a seeded fault plan with guards,
a checkpoint and resume at full width held against uninterrupted runs, and
the fault plan, guards and a rollback on nano, card against CPU.  Last come
runs of one process per rank: four ranks sharing the card over gloo with
the ZeRO-sharded global step and with the replicated one, at full width,
held against the main path; one rank over NCCL; and four ranks under faults
and guards on nano, card against CPU and against the dense run, with a
checkpoint resumed by one process.  The observability layer rides along:
main_path's run again with a run directory, a metric flush every round, a
torch.profiler capture of one outer step and the host-sync sanitizer, held
bit for bit against main_path and read back (kernel launches, device busy
share and idle gaps from the trace); the ZeRO ranks write run directories
whose comm ledger must equal their counted collectives.  Last, the paper's
other GPT-2 sizes and serving: the AdamW kernel bit for bit past 2^31
elements, GPT-2 medium and large trained at full width (half their depth,
PAPER_SIZES) through both kernels, generate on the trained large model
held against its full
forward, and card vs CPU for serving (nano) and the dense GQA/MQA archs
(SMOKE).  Then sliding-window attention and MoE, with parameters in their
reference dtypes (one flat buffer and one kernel launch per dtype group):
both kernels bit for bit at every dtype group's shape of these paths,
Gemma-3 1B (whole depth, W=2, S=1024) and Granite MoE 3B at full width and
GRANITE_LAYERS layers (bf16 experts, f32 routers: two groups) trained
through both kernels with each group's launches counted and timed, each
served on its trained x0 (Gemma's 640-token prompts past its 512-token
window, 128 new tokens around the ring) and held against its full forward,
and card vs CPU for the three SMOKE configs and Granite's SMOKE with bf16
parameters, training and greedy tokens.  Then mixed-dtype models over
ranks, each dtype group sharded, scattered and gathered on its own: that
Granite run again as RANKS gloo ranks sharing the card with the ZeRO-sharded
global step, held bit for bit against it, both groups of x0 and m; Granite's
and RecurrentGemma's SMOKE with bf16 parameters (RecurrentGemma's one-row
f32 group kept whole on every rank) under faults and guards over RANKS
ranks with both flag sets, card against CPU and against the dense run,
with a checkpoint resumed by one process; and Granite's in the one-rank
NCCL run.  Then the encoder-decoder and the
VLM: both kernels bit for bit at Whisper's shapes, Whisper-large-v3 at
full width and ENCDEC_LAYERS of its 32 + 32 layers trained through
make_dsm_step on batch dicts of tokens and frames (W=2, S=448) and served
with its frames, LLaVA-NeXT-34B at full width and VLM_LAYERS layers served
after its 2,880 patches, each held against its full forward, and card vs
CPU for both SMOKE configs.  Then the recurrent mixers: both kernels bit
for bit at their shapes, RecurrentGemma-2B at full width and RG_LAYERS of
its 26 layers (RG-LRU and local attention, W=2, S=3072 past its 2048-token
window) and Mamba-2 780M at whole depth (SSD, W=2, S=2048) trained through
run_training and both kernels (bf16 blocks, f32 decay leaves: two groups),
each served from its recurrent state on its trained x0 and held against its
full forward, and card vs CPU for both SMOKE configs and RecurrentGemma's
SMOKE with bf16 parameters.  Then activation checkpointing: Mamba-2 at
REMAT_LAYERS layers with that run's settings through make_dsm_step, once
without remat and with loss_fn's remat=True under the "full" and the
"dots" policies, each held bit for bit against the run without it.
Last, every full-width run's measured peak beside the dry-run's reckoning
of it on meta tensors (repro_torch.launch.dryrun), within DRYRUN_RTOL.
Before that, the model axis (model_axis_full_width: Minitron-4B, GPT-2
small, Granite-MoE, LLaVA, Mamba-2, RecurrentGemma and Whisper over gloo
ranks sharing the card,
Megatron-split DSM steps held against the dense run, the MoE one made to
take the ranks' routes; Minitron-4B and Gemma-3 1B at S = 2,048 with
sequence parallelism, attn_seq_shard) and serving on the (data, model) grid in the same
start of the ranks (serve_model_axis_full_width: Minitron-4B at 8 layers
in bf16 over four model ranks and at 8 layers in f32, GPT-2 small over (2,
2), Granite-MoE, LLaVA, Mamba-2, RecurrentGemma and Whisper over four model
ranks; one prompt that does not split over data, its positions and its
global caches' slots over data: Gemma-3 1B at whole depth in f32 over (4,
1), Mamba-2 and RecurrentGemma over (2, 2); each held against the dense
model and its f32 logits; Minitron-4B from a 2,048-token prompt with
sequence parallelism over (1, 4) and over (2, 2), where each data rank's
chunk of the prompt is cut into the model ranks' blocks, its rank caches
the same bits as without it), and FSDP in
the same start (fsdp_full_width: GPT-2 small at 2 layers with each rank's
zero block gathered per layer over its zero group, against its dense run,
and again with x0 and m over zero only, the replicated global step on the
whole zero block, bit-equal to it; Minitron-4B at 2 layers over (worker 1,
zero 2, model 2) against the same grid without FSDP; GPT-2 small served
with the data entries cut, bit-equal to the replicated-data run).
Between the ranks phases and the GPT-2 sizes, the port's counterparts of
the reference's three examples run on the card (examples_card).
After the ranks phases, the collective audit (audit_card): every c10d op
of each outer-step variant recorded over RANKS gloo ranks and held against
the paper's one-round budget, a planted extra all-reduce caught.  Every
phase trains on the reference package's sources (training_corpus).
algorithms_full_width, resume_full_width, obs_full_width and the
full-width ranks phases run GPT-2 small at full width with its depth cut
to CUT_LAYERS layers; the other cuts made for the command's time target
are named beside their constants (PERF.md section 4).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and nvidia-smi; exits non-zero, printing no
result, without a card or without the repository's src/repro_torch.  Every
phase prints one JSON line; any failure raises.  The line before the last
lists every kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import math
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and f32
# FLOP/s outside the tensor cores (the optimizer kernels' arithmetic).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_GPT2_SMALL = 123_882_240      # gpt2_small.FULL parameters, vocab padded to 50,688
RAGGED = 1_000_003              # not a multiple of any vector width
MAIN = dict(n_workers=4, b_micro=4, seq=128, peak_lr=5e-3, global_lr=0.3)
MAIN_STEPS = 4
DSM_HP = dict(eta=MAIN["global_lr"], beta1=0.95, beta2=0.98, lam=0.1)
ADAMW_HP = dict(beta1=0.9, beta2=0.95, eps=1e-8, wd=0.1)
NANO_STEPS = 3
PROFILED_STEP = 2               # obs_full_width's profiled outer step (0-based)
NANO_RTOL = 1e-4                # card vs CPU loss history, see phase_card_vs_cpu
# Lion's sign(u) and Sophia's clip at +-1 step every coordinate by +-gamma on
# EVERY local step (AdamW only on its first ones), so a gradient within
# rounding of 0 flips a step on any of the 36 local steps; the card and the
# CPU then drift apart faster: 2.4e-5 to 1.01e-4 in two chip runs, and
# this bound is ten times the largest
SIGN_LIKE_RTOL = 1e-3
SIGN_LIKE_BASE_OPTS = ("lion", "sophia")
# cut from 3 for the command's time target (PERF.md section 4), in both
# algorithms phases alike
ALGO_STEPS = 2
# algorithms_full_width, resume_full_width, obs_full_width and the
# full-width ranks phases run gpt2_small at full width with its depth cut to
# this many layers, to keep the whole command inside its time target (PERF.md
# section 4); obs_full_width and the ranks are held against resume_full_width's
# uninterrupted run
CUT_LAYERS = 2
# the card-vs-CPU phases run their CPU side in worker processes, beside
# their card runs (which are timed by no one); nano's small ops gain more
# from processes than from threads
CPU_WORKERS = 3
CPU_WORKER_THREADS = 2
CPU_RUN_TIMEOUT_S = 900
# each baseline's global step size as benchmarks/tables.py runs it; the
# others take MAIN's global_lr
ALGO_GLOBAL_LR = {"slowmo": 1.0, "signed_slowmo": 0.005, "lookahead": 1.0,
                  "global_adamw": 1.0}
FULL_WIDTH_RUNS = [dict(algorithm=a) for a in (
    "slowmo", "signed_slowmo", "lookahead", "signed_lookahead", "global_adamw", "local_avg",
    "perstep", "mv_signsgd")] + [dict(algorithm="dsm", base_opt="sophia"),
                                 dict(algorithm="dsm", sign_mode="rand_pm")]
NANO_DETERMINISTIC_RUNS = [dict(algorithm=a) for a in (
    "dsm", "slowmo", "signed_slowmo", "lookahead", "signed_lookahead", "global_adamw",
    "local_avg", "perstep")] + [dict(algorithm="dsm", base_opt=b)
                                for b in ("sgd", "momentum", "lion", "sophia")]
# CPU and CUDA generators give different streams: these need only be finite
NANO_RANDOM_RUNS = [dict(algorithm="dsm", sign_mode="rand_pm"),
                    dict(algorithm="dsm", sign_mode="rand_zero"), dict(algorithm="mv_signsgd")]
# fault-tolerant DSM: per round, the dropped, stale and corrupt workers of
# the hand-built plan (W = 4): a clean round, each fault alone and together,
# all four dropped (the skip-round), and a clean round after it
FAULT_ROUNDS = [((), (), ()), ((1,), (), ()), ((), (2,), (3,)), ((0, 1, 2, 3), (), ()),
                ((0,), (), (1,)), ((), (), ())]
ALL_DROPPED = 3
RESUME_STEPS = 4
# every round after the first has a loss above 0.9 x the EMA of accepted
# losses (a margin of ~10%, never within rounding): the guard rejects it
SPIKE_FACTOR = 0.9
RANKS = 4                       # processes sharing the card over gloo, one worker each
ZERO_RTOL = 1e-4                # ranks vs the dense run, loss history (bit-equal expected)
NCCL_STEPS = 2
RANKS_TIMEOUT_S = 600
# audit_card: the collective audit's steps (W = RANKS, one worker per rank)
AUDIT_TAU = 2
AUDIT_BATCH = dict(b_micro=MAIN["b_micro"], seq=MAIN["seq"])
# the paper's other GPT-2 sizes at full width (vocab padded to 50,688):
# (arch, layers, N), the layers cut from 24 and 36 (whole depth, N
# 353,944,576 and 772,762,880) to half for the time target
PAPER_SIZES = (("gpt2_medium", 12, 202_925_056), ("gpt2_large", 18, 418_822_400))
PAPER_STEPS = 2                 # cut from 3 for the command's time target
# the AdamW kernel past 2^31 elements: two rows of 2^30 + RAGGED
PAST_2G_SHAPE = (2, 2 ** 30 + RAGGED)
INT32_EDGE = 2 ** 31
PAST_2G_CHUNK = 1 << 28         # elements per slice of the plain version's check
ARCH_SMOKES = ("gpt2_medium", "gpt2_large", "deepseek_67b", "granite_34b", "minitron_4b")
ARCH_STEPS = 2
ARCH_BATCH = dict(b_micro=2, seq=64)    # archs_card_vs_cpu's microbatch: the CPU side's cost
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 128, 32
# serve_full_width: decode logits against the full forward, bf16 through 36
# layers.  The two paths run the same ops at other shapes (one query row
# against a cache, or every row at once), so a GEMM may round a bf16
# activation one ulp (2^-8 relative) the other way; across the 72 residual
# adds that is ~sqrt(72) * 2^-9 ~ 1.7% of the final state typically and 14%
# at worst; the row prints the largest logit beside the error.  In a MoE
# model such an ulp can also move a token's k-th and (k+1)-th expert past
# each other, and then the two paths run other experts: the bound holds
# the rows whose experts agree at every MoE layer, the others are counted,
# and the f32 check (where the routes agree but at exact ties) covers
# every generated token
SERVE_ATOL = 0.25
# serve_vlm_full_width's bf16 bound: the rationale above at its worst, one
# bf16 ulp (2^-8) of the largest logit per residual add (two per layer).
# llava's random-weight blocks (gated SiLU, d_ff 20480, an untied head)
# reach 2.6% of their largest logit (0.47 on logits up to 18.2 on the
# H100, past SERVE_ATOL); a decoder LM of the same block shape and prompt
# length without patches shows the same gap (CPU, bf16, width 1024), so
# the gap is the blocks' bf16 noise, not the patch prefix; the f32 check
# (SERVE_F32_ATOL) holds the decode path itself
SERVE_ULP_PER_ADD = 2.0 ** -8
# serve_recurrent_full_width's bf16 bound for recurrentgemma: the same
# rounding model alone, one bf16 ulp (2^-8) of the largest logit per
# residual add, two adds per layer (its RG-LRU / local-attention mixer and
# its FFN), with no SERVE_ATOL floor: 2 * RG_LAYERS * 2^-8 = 2.34% of the
# largest logit.  The absolute SERVE_ATOL held logits of any size; this
# bound scales with them, as llava's does (0.7265 on the largest logit of
# 30.996, where the check read 0.1210; PERF.md section 6).  Its f32
# check stays SERVE_F32_ATOL (serve_check's per_add_bound="only")
# the same check with the trained x0 in f32 (activations f32, no TF32), over
# the first SERVE_F32_STEPS tokens: only the summation orders differ there
SERVE_F32_ATOL = 1e-3
SERVE_F32_STEPS = 8
# serve_check's bf16 check of a model whose bf16 noise passes the bounds
# above (mamba2, 48 layers): its bf16 model sits ~1 logit from its own f32
# model at every position, the full forward and the decode alike (CPU,
# random init, logits up to 8.8; on the card its trained x0's decode read
# 3.16 from its full forward on logits up to 12.5, PERF.md section 6).  Its
# decode is held against the f32 model's full forward instead: within
# SERVE_NOISE_FACTOR times the bf16 full forward's own largest distance to
# it over the steps (the CPU read 0.96 times at 48 layers, 1.18 at 3), and
# every token where the bf16 full forward's top-2 margin exceeds
# SERVE_NOISE_FACTOR times that step's distance equal to its argmax
SERVE_NOISE_FACTOR = 2.0
SERVE_CPU_ATOL = 1e-4           # serve_card_vs_cpu: nano f32 decode logits
# sliding-window attention (gemma3_1b) and MoE (granite_moe_3b_a800m)
# at full width.  Neither arch module has a PEAK_LR: MAIN's (the launcher's
# default) applies.  gemma3_1b.FULL whole depth at W=2 (W=4 would need ~75 GB
# of state), S=1024 so that its 512-token window binds; granite at full
# width and GRANITE_LAYERS of its 32 layers (3.30 B parameters fit at no W
# with AdamW; cut from 6 layers, then from 3 to 1 when
# model_axis_full_width came in, for the command's time target, where
# group_kernel_checks keeps the 6-layer groups: AdamW over (4, 680,283,648),
# past 2^31).  N per dtype group: the param dtype's, then f32.
GEMMA = dict(n_workers=2, b_micro=1, seq=1024)
GEMMA_N = (999_812_736,)
GRANITE_LAYERS = 1
GRANITE_N = (176_951_808, 61_440)
GRANITE_CHECK_LAYERS = 6
WINDOW_MOE_STEPS = 2            # cut from 3 for the command's time target
WINDOW_MOE_EVAL_BATCH = 4           # eval sequences: gemma's f32 logits take 1.07 GB per 1024
# batch, prompt (past the window: the ring wraps), new tokens (cut from 128)
SERVE_SWA = (4, 640, 32)
SERVE_MOE = (4, 128, 32)
WINDOW_MOE_SMOKES = ("gemma3_1b", "granite_moe_3b_a800m", "llama4_maverick_400b_a17b")
# mixed-dtype models over ranks: mixed_zero_full_width runs the granite path
# above as RANKS gloo ranks; mixed_ranks_card_vs_cpu runs these SMOKE
# configs with bf16 parameters (two dtype groups) at a microbatch and tau
# that keep the CPU side's ranks cheap
MIXED_RANKS_SMOKES = ("granite_moe_3b_a800m", "recurrentgemma_2b")
MIXED_RANKS_BATCH = dict(tau=2, b_micro=2, seq=64)     # tau cut from 4
# the replicated global step's flag set (device_parallel_local alone) runs
# on these only: recurrentgemma's was cut for the command's time target
MIXED_DP_SMOKES = ("granite_moe_3b_a800m",)
# the encoder-decoder and the VLM at full width.  whisper_large_v3.FULL
# (1,535,060,480 parameters) at ENCDEC_LAYERS of its 32 encoder and 32
# decoder layers (whole depth at W=2 would need ~78 GB), W=2, S=448 (the
# published decoder context), 1500 frames per sequence; N in one bf16
# group.  llava_next_34b.FULL at VLM_LAYERS of its 60 layers, served only
# (one layer's training state alone is ~78 GB at W=2), its 2,880 patches
# (anyres 5 x 576) before 128 text tokens.
ENCDEC = dict(n_workers=2, b_micro=1, seq=448)
ENCDEC_LAYERS = 8               # cut from 16 for the command's time target
ENCDEC_N = 433_902_080
ENCDEC_STEPS = 2                # cut from 3 for the command's time target
ENCDEC_EVAL_BATCH = 2
SERVE_ENCDEC = (4, 64, 32)      # batch, prompt, new tokens (cut from 64)
VLM_LAYERS = 4                  # cut from 8
VLM_N = 3_200_318_464
SERVE_VLM = (2, 128, 32)        # 32 new tokens < 2,880 patches: where the reference raises
ENCDEC_VLM_SMOKES = ("whisper_large_v3", "llava_next_34b")
# the recurrent mixers at full width.  recurrentgemma_2b.FULL (2,894,481,920
# parameters) at RG_LAYERS of its 26 layers, one (rglru, rglru, swa) group,
# W=2 (cut from 6 layers, ~60 GB, for the command's time target); S=3072 so
# that its 2048-token window binds.  mamba2_780m.FULL at
# whole depth (48 layers), W=2, S=2048 (Mamba-2's published training
# context; at 24 layers its bf16 decode sat 2.02 times its full forward's
# distance from its f32 model, past SERVE_NOISE_FACTOR, on the card, so its
# depth is not cut).  N per dtype group: the param dtype's, then f32 (lam;
# A_log, D, dt_bias).  Neither arch module has a PEAK_LR: MAIN's applies.
RG = dict(n_workers=2, b_micro=1, seq=3072)
RG_LAYERS = 3
RG_N = (912_304_640, 5_120)
MAMBA = dict(n_workers=2, b_micro=1, seq=2048)
MAMBA_N = (780_768_768, 6_912)
RECURRENT_STEPS = 2             # mamba2's, cut from 3 for the command's time target
# recurrentgemma kept 3 rounds while its bf16 decode-vs-full-forward check
# sat near SERVE_ATOL and moved with the corpus (src/**/*.py), 0.20-0.32
# after 2 rounds at 3 layers (PERF.md section 7); now held to its per-add
# bound (SERVE_ULP_PER_ADD), 0.1210 against 0.7265, it is cut to 2 for the
# command's time target
RG_STEPS = 2
RECURRENT_EVAL_BATCH = 2        # eval sequences: recurrentgemma's f32 logits, 2.1 GB per 2048
SERVE_RG = (4, 2560, 128)       # batch, prompt (past the window), new tokens
SERVE_MAMBA = (4, 512, 32)      # four 128-position SSD chunks; 32 new (cut from 128)
RECURRENT_SMOKES = ("mamba2_780m", "recurrentgemma_2b")
# activation checkpointing at full width: mamba2 with recurrent_full_width's
# settings at REMAT_LAYERS of its 48 layers through make_dsm_step with
# loss_fn(..., remat=True, remat_policy=p) for each p, REMAT_ROUNDS rounds,
# held bit for bit against the same rounds without remat (rounds cut from 3,
# then 2, and depth from 48, where it was held against recurrent_full_width's
# own run and took 71.2 s, its rounds 23.6 s under "full" and 33.5 s under
# "dots", then 12, 8 and 4, for the time target: PERF.md section 4)
REMAT_POLICIES = ("full", "dots")
REMAT_ROUNDS = 1
REMAT_LAYERS = 4
# dryrun_vs_card: every measured full-width peak within this share of the
# dry-run's reckoning (repro_torch.launch.dryrun, on meta tensors)
DRYRUN_RTOL = 0.20
# model_axis_full_width: the model axis (distributed.tensor_parallel) at
# full width, RANKS gloo ranks sharing the card, held against the dense run
# in this process.  (a) minitron_4b.FULL (d 3072, 24 heads, 8 KV heads,
# d_ff 9216, tied 256,000-row vocab) at MODEL_AXIS_LAYERS of its 32 layers
# (N = 896,541,696, the embedding 88% of it; cut for one card: the dense
# run's state alone is ~12 * W + 8 B per parameter) over (worker 1, zero 1,
# model 4): each rank holds both workers' quarter, 6 query heads, 2 KV heads,
# 64,000 vocab rows.  (b) gpt2_small.FULL at CUT_LAYERS layers over (worker
# 2, zero 1, model 2), W = 2: the reference's grid rule puts one worker on
# each worker row (W = 4 would need 4 rows), so each rank holds one worker's
# half, and the worker mean and the global step run over 2-rank subgroups.
# (d) granite_moe_3b_a800m.FULL at MOE_VLM_LAYERS of its 32 layers over
# (worker 1, zero 1, model 4), W = 2: its 40 experts' router on E (10 per
# rank), every expert's d_ff cut to 128 per rank, the (T K, d) partial
# outputs all-reduced before the combine; each MoE layer call's routes
# recorded on the ranks (torch_ranks.recorded_routes), the same on every
# rank of the group, and the dense run made to take them (forced_routes):
# held within model_axis_bounds at every round; the tokens whose own top-k
# the dense run would have taken otherwise counted per local step.  (Left
# to route freely, the two bf16 runs part after the first local step: 140
# of 2,048 token routes differed at step 0, 942-2,021 at every later step,
# and the losses 3.8% apart after two rounds; PERF.md section 6.)
# (e) llava_next_34b.FULL at VLM_AXIS_LAYERS of its 60 layers over (1, 1,
# 4), W = 1, B_micro 1, S 128 text tokens after its 2,880 random patches
# (f32, seeded), one round: patch_proj column-parallel (the (B, P, d / 4)
# prefix gathered), within model_axis_bounds (cut from 2 layers for the
# card: four ranks sharing it reckon 19.97 GB each at 2 layers, the global
# step's f32 temporaries 9.38 GB of it, and ran it out of memory; 14.67 GB
# each at 1 layer).  Over (1, 1, 4), W = 2: (g) mamba2_780m.FULL at
# MAMBA_AXIS_LAYERS of its 48 layers, 12 of its 48 heads per rank (in_proj
# and conv taken whole per layer and sliced: their placed blocks cut the z /
# x / B / C / dt segments); (h) recurrentgemma_2b.FULL at RG_LAYERS of its 26
# layers (one pattern repeat: rglru, rglru, swa), 640 RG-LRU channels and
# 1,920 of d_ff per rank, the swa layer's 10 heads over gathered leaves; (i)
# whisper_large_v3.FULL at ENCDEC_AXIS_LAYERS + ENCDEC_AXIS_LAYERS of its 32 +
# 32 layers, B_micro 2, 128 text tokens beside its 1,500 random frames (f32,
# seeded, whole on every rank), 5 heads per rank in the encoder, the decoder
# and the cross-attention.  All: tau 2 (cut from 4 for the time target:
# PERF.md section 4), S 128, B_micro 4 unless named,
# MODEL_AXIS_ROUNDS rounds unless named, constant gamma, eta, one start of
# the ranks; each case's global step bit-equal from the dense x_tau.  The
# bounds (PERF.md section 6, written before the first run):
# model_axis_bounds
# the depth cuts below (from 2, 2 and 2 + 2 layers) pay for the cases (o)
# and (d) of the randomized signs and the baselines (PERF.md section 4);
# MODEL_AXIS_LAYERS cuts (a), (m), (m') and FSDP (b) alike.  mamba2 stays at
# 4 layers: at 2, serving's (k) missed its bf16 noise gate at 2 of 32 steps
# (PERF.md section 6), as at 24 of its 48 layers before
MODEL_AXIS_LAYERS = 1           # cut from 2 for the time target
MODEL_AXIS_N = 896_541_696
MODEL_AXIS_ROUNDS = 1           # cut from 2 for the time target
MOE_VLM_LAYERS = 1              # cut from 2 for the time target
VLM_AXIS_LAYERS = 1
MAMBA_AXIS_LAYERS = 4
ENCDEC_AXIS_LAYERS = 1          # encoder and decoder layers each, cut from 2
MODEL_AXIS_CASES = (   # (arch, layers, W, model ranks, B_micro, rounds)
    ("minitron_4b", MODEL_AXIS_LAYERS, 2, 4, 4, MODEL_AXIS_ROUNDS),
    ("gpt2_small", CUT_LAYERS, 2, 2, 4, MODEL_AXIS_ROUNDS),
    ("granite_moe_3b_a800m", MOE_VLM_LAYERS, 2, 4, 4, MODEL_AXIS_ROUNDS),
    ("llava_next_34b", VLM_AXIS_LAYERS, 1, 4, 1, 1),
    ("mamba2_780m", MAMBA_AXIS_LAYERS, 2, 4, 4, MODEL_AXIS_ROUNDS),
    ("recurrentgemma_2b", RG_LAYERS, 2, 4, 4, MODEL_AXIS_ROUNDS),
    ("whisper_large_v3", ENCDEC_AXIS_LAYERS, 2, 4, 2, MODEL_AXIS_ROUNDS))
MODEL_AXIS = dict(tau=2, seq=128)
# (m), (n): sequence parallelism on the model axis (cfg.attn_seq_shard:
# each rank holds its (B, S / 4, d) block of the residual stream between
# blocks, the sequence gathered in front of each column-parallel product and
# reduce-scattered after each row-parallel one), in the same start of the
# ranks, each against its dense run from the same card draw, MODEL_AXIS'
# tau, B_micro SP_AXIS["b_micro"], S SP_AXIS["seq"] (four blocks of 512),
# one round, the same bounds and gates as (a)-(i).  (m) minitron_4b.FULL
# at MODEL_AXIS_LAYERS layers over (worker 1, zero 1, model 4), W = 2:
# Megatron-SP, attention by heads; (n) gemma3_1b.FULL at GEMMA_SP_LAYERS of
# its 26 layers (one repeat of its 5 swa : 1 attn pattern) over (1, 1, 4),
# W = 2, with the reference's TOPO.attn_tp = False: wq / wk / wv / wo whole
# on every rank (dryrun.ATTN_NAMES), the rank's 512 queries over every
# rank's keys and values (its one KV head), the 512-position window across
# the blocks' edges
SP_AXIS = dict(b_micro=1, seq=2048)
GEMMA_SP_LAYERS = 6
SP_AXIS_CASES = (      # (arch, layers, W, model ranks, TOPO.attn_tp)
    ("minitron_4b", MODEL_AXIS_LAYERS, 2, 4, True),
    ("gemma3_1b", GEMMA_SP_LAYERS, 2, 4, False))
MODEL_AXIS_GAMMA = 1e-3
MODEL_AXIS_ETA = MAIN["global_lr"]
# the rounding model: one bf16 ulp (2^-8) of the largest logit per
# row-parallel add (two per layer: attention's and the FFN's outputs, each
# M partial sums rounded to bf16 and their f32 sum rounded once more), f32
# logits and an exact vocab-parallel lookup; a loss moves by at most twice
# its logits' largest move
MODEL_AXIS_ULP = 2.0 ** -8
# serve_model_axis_full_width: serving on the (data, model) grid
# (mesh.serving_topology) at full width, in model_axis_full_width's start of
# RANKS gloo ranks sharing the card (tests/torch_ranks.serve_full_width_rank),
# each case against the dense model in this process from the same card draw
# and prompts.  (a) minitron_4b.FULL in bf16 at SERVE_MA_BF16_LAYERS of its
# 32 layers (cut from whole depth, 4,309,847,040 parameters and ~2.15 GB of
# blocks per rank, for the time target: 16.7 s of the ranks' start, where
# the gate decided 1 of its 64 tokens; PERF.md section 4) over (data 1,
# model 4): 6 query heads, 2 KV heads and 64,000 vocab rows per rank; (a')
# the same in f32 (params and activations) at SERVE_MA_F32_LAYERS
# of its 32 layers (cut: four ranks each drawing the dense f32 model at whole
# depth, ~17 GB and its f32 draw of the embedding, would not fit the card at
# once); (b) gpt2_small.FULL at whole depth over (data 2, model 2), two
# sequences per data row.  Each: SERVE_MA = (batch, prompt, new) corpus
# prompts, greedy.  Gates (PERF.md section 6, written before the first run):
# a bf16 case's logits at every step within SERVE_NOISE_FACTOR times the
# dense bf16 logits' distance from the dense f32 model's at that step (the
# training phase's depth-linear rounding bound, 2 * (2 * 32) * 2^-8 of the
# largest logit, is vacuous at 32 layers); (a') within SERVE_MA_F32_RTOL of
# the dense f32 model's largest |logit| at each step; every token, at every
# step, exactly the argmax (lowest id on ties) of the ranks' own assembled
# logits over the unpadded vocab (the vocab-parallel pick, with no noise
# margin); against the dense model, a token is decided where the dense
# logits' top-2 margin exceeds that step's gate, and is then the dense argmax
# (serve_check's noise_bound rule; twice the gap the gate admits between the
# two paths decided 0-1 of (a)'s 64 tokens at whole depth in bf16, PERF.md
# section 6); every rank of a model group returns the same tokens; each rank's peak
# within DRYRUN_RTOL of dryrun.reckon_serve's; its collectives
# serve_collectives' to the byte (the params resolved once per generate).
# (c) granite_moe_3b_a800m.FULL at MOE_VLM_LAYERS layers in bf16 over
# (data 1, model 4), SERVE_MA's prompts; (d) llava_next_34b.FULL at
# SERVE_MA_VLM_LAYERS layers over (1, 4), SERVE_VLM's 2 prompts after the config's
# 2,880 seeded random patches (f32), the same rule; over (1, 4) in bf16,
# the same rule: (e) mamba2_780m at MAMBA_AXIS_LAYERS layers and (f)
# recurrentgemma_2b at RG_LAYERS layers, SERVE_MA's prompts (each rank's
# cache its heads' or channels' state); (g) whisper_large_v3 at
# ENCDEC_AXIS_LAYERS + ENCDEC_AXIS_LAYERS layers, SERVE_ENCDEC's prompts
# after 1,500 seeded random frames (f32), SERVE_MA_ENCDEC_NEW new tokens.
# A batch that does not split over data (tensor_parallel.serve_split: each
# data row serves every sequence, the prefill over its chunk of the
# prompt's positions, a full-attention cache's slots in D blocks), one
# prompt, the same rule: (j) gemma3_1b.FULL at whole depth in f32 over
# (data 4, model 1), SERVE_SPLIT_GEMMA (4 chunks of 1,024 positions, its 4
# global layers' caches 4 blocks of 1,040 slots; f32, as (a'): in bf16 the
# dense model's bf16-vs-f32 distance, 1.1-2.1 logits per step at 262,144
# vocab rows, passed every top-2 margin, so the gate decided none of its 64
# tokens, PERF.md section 6); over (2, 2), SERVE_SPLIT's:
# (k) mamba2_780m at MAMBA_AXIS_LAYERS layers (two 256-position chunks, the
# SSD state carried across them) and (l) recurrentgemma_2b at RG_LAYERS
# layers (the RG-LRU's); every data rank's logits the same bits.  (m')
# minitron_4b at MODEL_AXIS_LAYERS layers with attn_seq_shard over (data 1,
# model 4), one SERVE_SP prompt: the prefill over each rank's 512-position
# block of it, the rank's cache (its KV heads over every position) the same
# bits as its prefill without the flag, then greedy decode as (a); (p) the
# same over (data 2, model 2): each data rank's 1,024-position chunk of the
# prompt, each model rank's 512-position block of that chunk, the rank's
# cache (its KV heads, its block of the cache's slots) the same bits as the
# same grid's prefill without the flag, the rest as (a)
SERVE_MA_BF16_LAYERS = 8        # cut from 32, then 16 (PERF.md section 4)
SERVE_MA_VLM_LAYERS = 2         # (d)'s, cut from VLM_LAYERS (4)
SERVE_MA_F32_LAYERS = 8
SERVE_MA = (4, 256, 16)
SERVE_MA_ENCDEC_NEW = 16
SERVE_SPLIT_GEMMA = (1, 4096, 64)
SERVE_SPLIT = (1, 512, 32)
SERVE_SP = (1, 2048, 16)
SERVE_MA_CASES = (   # (arch, layers (None: whole depth), dtype, model ranks, (B, prompt, new)
                     # [, config fields])
    ("minitron_4b", SERVE_MA_BF16_LAYERS, None, 4, SERVE_MA),
    ("minitron_4b", SERVE_MA_F32_LAYERS, "float32", 4, SERVE_MA),
    ("gpt2_small", None, None, 2, SERVE_MA),
    ("granite_moe_3b_a800m", MOE_VLM_LAYERS, None, 4, SERVE_MA),
    ("llava_next_34b", SERVE_MA_VLM_LAYERS, None, 4, SERVE_VLM),
    ("mamba2_780m", MAMBA_AXIS_LAYERS, None, 4, SERVE_MA),
    ("recurrentgemma_2b", RG_LAYERS, None, 4, SERVE_MA),
    ("whisper_large_v3", ENCDEC_AXIS_LAYERS, None, 4, SERVE_ENCDEC[:2] + (SERVE_MA_ENCDEC_NEW,)),
    ("gemma3_1b", None, "float32", 1, SERVE_SPLIT_GEMMA),
    ("mamba2_780m", MAMBA_AXIS_LAYERS, None, 2, SERVE_SPLIT),
    ("recurrentgemma_2b", RG_LAYERS, None, 2, SERVE_SPLIT),
    ("minitron_4b", MODEL_AXIS_LAYERS, None, 4, SERVE_SP, {"attn_seq_shard": True}),
    ("minitron_4b", MODEL_AXIS_LAYERS, None, 2, SERVE_SP, {"attn_seq_shard": True}))
SERVE_MA_F32_RTOL = 1e-3
# fsdp_full_width: FSDP over zero (mesh.topology(..., fsdp=True): each rank
# holds its zero block of its blocks, gathers each layer at use over its
# zero group and runs its B_micro / Z rows where they split) at full width,
# in model_axis_full_width's start of the RANKS gloo ranks sharing the card
# (tests/torch_ranks.fsdp_full_width_rank), MODEL_AXIS' tau and S,
# MODEL_AXIS_GAMMA, MODEL_AXIS_ETA, ZeRO, device-parallel local phase.
# (a) gpt2_small.FULL at CUT_LAYERS of its 12 layers (cut from whole depth
# for the time target: PERF.md section 4) over (worker 2, zero 2,
# model 1), W = 2, B_micro FSDP_B_MICRO (2 rows per zero rank),
# FSDP_ROUNDS rounds, held against its dense run here from the same card
# draw and batches within model_axis_bounds (PERF.md section 6, written
# before the first run: FSDP rounds no parameter that the dense run does not
# round, each gradient is summed over the zero ranks in f32 and rounded once,
# and AdamW's direction bound covers any gap of the gradients), the global
# step bit-equal from the dense x_tau on each rank's zero block.  (b)
# minitron_4b.FULL at MODEL_AXIS_LAYERS of its 32 layers over (worker 1,
# zero 2, model 2), W = 1, FSDP_B_ROUNDS round of FSDP_B_TAU local step
# (both cut for the time target: its tied 256,000-row table's f32
# gradient, reduce-scattered at each of its two uses, puts ~3.6 GB per local
# step and rank through gloo's host staging; 2 steps took 22.9 s per rank,
# PR 25 run A): B_micro 1 (whole over zero)
# bit-equal to the same grid without FSDP, and B_micro FSDP_B_MICRO within
# model_axis_bounds of the same grid without FSDP (its loss gap in units of
# the largest logit of the dense draw on the round's tokens, computed here:
# its one round starts from the draw).  (c) serve_model_axis_full_width's (b), gpt2_small over (data 2,
# model 2), with the data entries cut: logits and tokens bit-equal to that
# case's.  Per rank: its peak within DRYRUN_RTOL of the dry-run's reckoning
# (dryrun_vs_card), its state bytes the reckoning's, its collectives the
# reckoning's to the byte per group, one DSM and tau AdamW launches per
# round and dtype group
FSDP_A = ("gpt2_small", CUT_LAYERS, 2, 1)         # (arch, layers, W, model)
FSDP_B = ("minitron_4b", MODEL_AXIS_LAYERS, 1, 2)
FSDP_B_MICRO = 4
FSDP_ROUNDS = 1                 # (a)'s rounds, cut from 2 for the time target
FSDP_B_ROUNDS = 1
FSDP_B_TAU = 1
# (o) and (d): the randomized signs and the local-step baselines over the
# model axis and FSDP, in the same start of the ranks (each rank its own
# CUDA generator, seeded as the dense run's; tests/torch_ranks.
# algorithm_step), each one round on the same draw and batches as its grid's
# DSM case, held against its dense run here from that draw, those batches
# and that seed.  (o) on (b)'s grid, gpt2_small.FULL at CUT_LAYERS layers
# over (worker 2, zero 1, model 2), W = 2, MODEL_AXIS' tau: DSM with rand_pm
# (the ZeRO-sharded step over each rank's blocks) and global AdamW (eta
# MODEL_AXIS_ETA); (d) on FSDP (a)'s grid over (2, 2, 1): DSM with rand_zero
# and SlowMo (alpha ALGO_GLOBAL_LR's).  Gates (PERF.md section 6, written
# before the first run): the global step from the dense x_tau, x0 and m (a
# baseline's aux) on every rank's blocks (its ZeRO shard of them for DSM)
# bit for bit the dense step's, the randomized signs drawn through
# FlatLayout.dense_index; the round within algorithm_bounds
# (model_axis_bounds; SlowMo's x0 is its x_tau, so it carries x_tau's
# gap); each rank's collectives tensor_parallel.round_collectives' to the
# byte; tau AdamW launches per rank and dtype group and no DSM launch (the
# kernel computes the deterministic sign only)
# (e): x0 and m over zero only (the reference dry-run's
# --no-zero-global-buffers): FSDP (a)'s grid, draw and batches, one round
# with DSMConfig.zero_sharded off, in the same start of the ranks; each
# rank's zero block of x_tau, x0, m, the losses and the params bit for bit
# (a)'s, its worker peers' x0 and m the same bits (SHA-256 per rank), its
# collectives tensor_parallel.round_collectives(..., zero_sharded=False)'s
# and the dry-run's to the byte, one DSM launch per round and dtype group
# over the whole zero block (timed beside its bound), its peak within
# DRYRUN_RTOL of reckon_train(..., zero_global_buffers=False)
FSDP_E = {"zero_sharded": False}
ALGO_AXIS_CASES = (("o_rand_pm", {"sign_mode": "rand_pm", "seed": 29}),
                   ("o_global_adamw", {"method": "global_adamw", "eta": MODEL_AXIS_ETA}))
ALGO_FSDP_CASES = (("d_rand_zero", {"sign_mode": "rand_zero", "seed": 31}),
                   ("d_slowmo", {"method": "slowmo", "alpha": ALGO_GLOBAL_LR["slowmo"]}))


# examples_card: the port's counterparts of the reference's three examples
# (examples/torch_quickstart.py, torch_train_gpt2_dsm.py and
# torch_serve_model.py), each through its main on the card with
# EXAMPLE_STEPS outer steps (their defaults 30, 120 and 40 cut for the time
# target): every loss finite, each run's launches expected_launches' (DSM
# launches both kernels), each served completion the example's NEW_TOKENS
EXAMPLES = ("torch_quickstart", "torch_train_gpt2_dsm", "torch_serve_model")
EXAMPLE_STEPS = 2


# Every phase trains on the sources of the reference package, which stays as
# it is: the same bytes in every run, while the port's own sources (and, on
# them, every loss) would change with the port.
CORPUS_DIR = ROOT / "src" / "repro"


@functools.cache
def training_corpus():
    """The byte-level corpus of CORPUS_DIR's ``*.py`` files (one, shared by
    every phase: ``TextCorpus`` only reads its data)."""
    from repro_torch.data.pipeline import TextCorpus

    return TextCorpus(str(CORPUS_DIR), "**/*.py")


T0 = time.perf_counter()
# every full-width run's measured peak, for dryrun_vs_card: (run, bytes,
# cfg, repro_torch.launch.dryrun.reckon_train's keywords, bytes the script
# holds on the card beside the run, the reckoning's future in the CPU pool)
PEAKS = []
RECKON = {"pool": None}         # the CPU pool, once main has started it


def emit(obj) -> None:
    """One JSON line; a phase's line carries the seconds since the start."""
    if "phase" in obj:
        obj = {**obj, "at_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def expect_peak(name: str, peak: int, cfg, s, held: int = 0, **kw) -> None:
    """Record a full-width run's measured peak for dryrun_vs_card, with the
    settings the dry-run reckons it from: by default run_training's (its
    initial x0 kept beside the state, an eval of ``s.eval_batch``
    sequences); ``held``: the bytes of the tensors the script keeps on the
    card through the run (an earlier run's trained x0)."""
    kw = {"n_workers": s.n_workers, "tau": s.tau, "b_micro": s.b_micro, "seq": s.seq,
          "base_opt": s.base_opt, "eval_batch": s.eval_batch, **kw}
    pool = RECKON["pool"]
    PEAKS.append((name, peak, cfg, kw, held,
                  pool and pool.submit(reckon_peak, cfg, kw)))    # reckoned meanwhile


def card_bytes_of(x) -> int:
    from repro_torch.groups import parts

    return sum(t.numel() * t.element_size() for t in parts(x))


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_flops: float) -> tuple[float, str]:
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_flops / F32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def compare(torch, ours, theirs) -> float:
    """Max |difference| over the finite entries; raises unless NaN sits where
    NaN sits and every other entry has the same bit pattern (so +0 and -0
    differ).  Tolerance 0: kernel and plain version do the same IEEE f32
    operations in the same order (the kernels are built with --fmad=false
    and take the same f32 constants)."""
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    worst = 0.0
    for a, b in zip(ours, theirs):
        if a.dtype != b.dtype:
            raise AssertionError(f"dtypes differ: {a.dtype}, {b.dtype}")
        if not torch.equal(a.isnan(), b.isnan()):
            raise AssertionError("NaN positions differ")
        fin = ~b.isnan()
        err = (a.float()[fin] - b.float()[fin]).abs().max().item()
        if not torch.equal(a.view(as_int[a.dtype])[fin], b.view(as_int[b.dtype])[fin]):
            raise AssertionError(f"kernel differs from its plain version in its bits: "
                                 f"max |err| {err}")
        worst = max(worst, err)
    return worst


def dsm_inputs(torch, gen, n, dtype, at=(0,)):
    """x0, m, x_tau with u = -0, +0 and NaN planted at each offset of ``at``."""
    x0 = torch.randn(n, generator=gen, device="cuda").to(dtype)
    m = torch.randn(n, generator=gen, device="cuda")
    xt = (x0.float() - 0.01 * torch.randn(n, generator=gen, device="cuda")).to(dtype)
    for i in at:
        x0[i:i + 2] = -0.0
        xt[i] = 0.0                       # delta = -0 - +0 = -0 and m = -0: u = -0
        xt[i + 1] = -0.0                  # delta = -0 - -0 = +0: u = +0
        m[i:i + 2] = -0.0
        xt[i + 2] = float("nan")          # u = NaN: x and m become NaN
    return x0, m, xt


def same_bits(torch, a, b) -> bool:
    as_int = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return torch.equal(a.view(as_int[a.dtype]), b.view(as_int[b.dtype]))


def adamw_inputs(torch, gen, shape, dtype):
    p = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    m = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    v = 0.01 * torch.rand(shape, generator=gen, device="cuda")
    return p, g, m, v


def phase_checks(torch, K):
    """Each kernel against its plain version, bit for bit, at the main
    path's shapes: the DSM step over (N,) and over the ZeRO shard views that
    zero_full_width launches it on (an inner shard and the shorter last one,
    each a view at a 128-aligned offset; the rest of the buffer must stay as
    it was), AdamW over (W, N) and over one rank's (1, N) rows; and at a
    ragged size."""
    from repro_torch.distributed import zero
    from repro_torch.kernels.adamw_update import adamw_update_plain
    from repro_torch.kernels.dsm_update import dsm_update_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    shards = zero.shard_bounds(N_GPT2_SMALL, RANKS)
    cases = []
    for n in (N_GPT2_SMALL, RAGGED):
        for dtype in (torch.float32, torch.bfloat16):
            full = n == N_GPT2_SMALL
            views = [(None, 0, n)] + ([(r, *shards[r]) for r in (1, RANKS - 1)] if full else [])
            x0, m, xt = dsm_inputs(torch, gen, n, dtype, at=[a for _, a, _ in views])
            for rank, a, b in views:
                ka, kb = (x0.clone(), m.clone()), (x0.clone(), m.clone())
                K.dsm_update(ka[0][a:b], ka[1][a:b], xt[a:b], 0.02, **DSM_HP)
                dsm_update_plain(kb[0][a:b], kb[1][a:b], xt[a:b], 0.02, **DSM_HP)
                torch.cuda.synchronize()
                err = compare(torch, ka, kb)
                if not all(same_bits(torch, k[:a], o[:a]) and same_bits(torch, k[b:], o[b:])
                           for k, o in zip(ka, (x0, m))):
                    raise AssertionError(f"dsm_update on [{a}, {b}) of {n} wrote outside it")
                cases.append({"kernel": "dsm_update", "shape": [b - a], "dtype": str(dtype),
                              "zero_shard": None if rank is None else
                              {"rank": rank, "of": RANKS, "offset": a, "buffer": n},
                              "max_abs_err": err})
                del ka, kb
            del x0, m, xt
            for shape in ([(MAIN["n_workers"], n), (1, n)] if full else [(n,)]):
                p, g, mm, v = adamw_inputs(torch, gen, shape, dtype)
                for rd in (False, True):
                    ka = (p.clone(), mm.clone(), v.clone())
                    kb = (p.clone(), mm.clone(), v.clone())
                    K.adamw_update(ka[0], g, ka[1], ka[2], 1e-3, 11, round_direction=rd,
                                   **ADAMW_HP)
                    adamw_update_plain(kb[0], g, kb[1], kb[2], 1e-3, 11, round_direction=rd,
                                       **ADAMW_HP)
                    torch.cuda.synchronize()
                    cases.append({"kernel": "adamw_update", "shape": list(shape),
                                  "dtype": str(dtype), "round_direction": rd,
                                  "max_abs_err": compare(torch, ka, kb)})
                    del ka, kb
                del p, g, mm, v
            torch.cuda.empty_cache()
    emit({"phase": "kernel_checks", "tolerance": "bitwise (atol 0, rtol 0), NaN where NaN",
          "cases": cases})
    return {name: max(c["max_abs_err"] for c in cases if c["kernel"] == name)
            for name in ("dsm_update", "adamw_update")}


def phase_times(torch, K, smi):
    """Kernel, plain and library times at the main path's shapes and dtype,
    and the DSM kernel's on one rank's shard of zero_full_width."""
    from repro_torch.distributed import zero
    from repro_torch.kernels.adamw_update import adamw_update_plain
    from repro_torch.kernels.dsm_update import dsm_update_plain

    gen = torch.Generator(device="cuda").manual_seed(1)
    n, w = N_GPT2_SMALL, MAIN["n_workers"]
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        es = torch.empty((), dtype=dtype).element_size()
        x0, m, xt = dsm_inputs(torch, gen, n, dtype)
        dsm = {
            "ms": median_ms(torch, lambda: K.dsm_update(x0, m, xt, 0.02, **DSM_HP)),
            "plain_ms": median_ms(torch, lambda: dsm_update_plain(x0, m, xt, 0.02, **DSM_HP)),
            "library_ms": None,      # no single PyTorch call computes the DSM step
        }
        dsm["bound_ms"], dsm["bound_by"] = bound_ms(n * (3 * es + 2 * 4), n * 12)
        # the ZeRO call site: one rank's shard of RANKS, a view at a
        # 128-aligned offset (zero_full_width launches the kernel on these)
        a, b = zero.shard_bounds(n, RANKS)[1]
        views = (x0[a:b], m[a:b], xt[a:b])
        shard = {"elements": b - a,
                 "ms": median_ms(torch, lambda: K.dsm_update(*views, 0.02, **DSM_HP)),
                 "plain_ms": median_ms(torch, lambda: dsm_update_plain(*views, 0.02, **DSM_HP))}
        shard["bound_ms"], shard["bound_by"] = bound_ms((b - a) * (3 * es + 2 * 4), (b - a) * 12)
        dsm["zero_shard"] = shard
        del x0, m, xt, views
        p, g, mm, v = adamw_inputs(torch, gen, (w, n), dtype)
        adamw = {
            "ms": median_ms(torch, lambda: K.adamw_update(p, g, mm, v, 1e-3, 11, **ADAMW_HP)),
            "plain_ms": median_ms(torch, lambda: adamw_update_plain(p, g, mm, v, 1e-3, 11,
                                                                    **ADAMW_HP)),
        }
        adamw["bound_ms"], adamw["bound_by"] = bound_ms(w * n * (3 * es + 4 * 4), w * n * 16)
        # yardstick only, never called by the port: PyTorch's fused AdamW,
        # first on the kernel's own inputs (param-dtype p and g, f32
        # moments), then with the moments cast to the param dtype (bf16
        # moments move 8 fewer bytes per element than the port's f32 ones)
        steps = [torch.zeros((), dtype=torch.float32, device="cuda")]

        def fused(mm_l, v_l):
            return lambda: torch._fused_adamw_(
                [p], [g], [mm_l], [v_l], [], steps, lr=1e-3, beta1=0.9, beta2=0.95,
                weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False)

        try:
            adamw["library_ms"] = median_ms(torch, fused(mm, v))
            adamw["library_same_inputs"] = True
        except RuntimeError as e:   # the library's answer is the measurement
            adamw["library_ms"] = None
            adamw["library_same_inputs"] = f"refused: {str(e).splitlines()[0][:300]}"
        mm_l, v_l = mm.to(dtype), v.to(dtype)
        adamw["library_param_dtype_moments_ms"] = median_ms(torch, fused(mm_l, v_l))
        del p, g, mm, v, mm_l, v_l
        torch.cuda.empty_cache()
        out[str(dtype)] = {"dsm_update": dsm, "adamw_update": adamw}
    emit({"phase": "kernel_times", "gpu": smi, "reps": 25, "stat": "median, CUDA events",
          "shapes": {"dsm_update": [n], "adamw_update": [w, n]}, "times": out})
    return out[str(torch.bfloat16)]


def phase_main_path(torch, K, smi):
    from repro_torch.configs import gpt2_small
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings, run_training

    cfg = gpt2_small.FULL
    n_params = T.layout(cfg).numel
    if n_params != N_GPT2_SMALL:
        raise AssertionError(f"gpt2_small.FULL has {n_params} parameters")
    s = TrainSettings(tau=gpt2_small.TOPO.tau, steps=MAIN_STEPS, eval_every=MAIN_STEPS, **MAIN)
    # MarkovCorpus(50257) would need a ~160 GB table; the reference's sources
    # are a byte-level corpus (token ids < 256 of the 50,257-token vocab)
    corpus = training_corpus()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = run_training(cfg, s, corpus, device="cuda")
    launches = K.launch_counts()
    hist = res["history"]
    if not all(math.isfinite(x) for x in hist + [res["final_eval"]]):
        raise AssertionError(f"non-finite loss: {hist}, eval {res['final_eval']}")
    if not hist[-1] < hist[0]:
        raise AssertionError(f"train loss did not fall: {hist}")
    want = {"dsm_update": s.steps, "adamw_update": s.steps * s.tau}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, want {want}")
    step_ms = statistics.median(res["outer_step_s"][1:]) * 1e3
    tokens_per_step = s.n_workers * s.tau * s.b_micro * s.seq
    peak = torch.cuda.max_memory_allocated()
    emit({"phase": "main_path", "gpu": smi, "config": cfg.name, "n_params": n_params,
          "n_workers": s.n_workers, "tau": s.tau, "b_micro": s.b_micro, "seq": s.seq,
          "outer_steps": s.steps, "history": hist, "final_eval": res["final_eval"],
          "outer_step_ms": [t * 1e3 for t in res["outer_step_s"]],
          "outer_step_ms_median_after_first": step_ms,
          "tokens_per_s": tokens_per_step / (step_ms / 1e3),
          "max_memory_allocated_bytes": peak, "launches": launches})
    expect_peak("main_path", peak, cfg, s)
    return launches, {"outer_step_ms": step_ms, "max_memory_allocated_bytes": peak}


def phase_obs_full_width(torch, K, smi, dense):
    """resume_full_width's uninterrupted run again (gpt2_small at full width
    and CUT_LAYERS layers, W=4, tau=12, MAIN_STEPS outer steps, the main
    path's settings and corpus) with a run directory, a metric flush every
    round, a torch.profiler capture of outer step PROFILED_STEP and the
    sanitizer (no implicit host sync inside the step), in a temporary
    directory under build/.  History and final x0/m bit-equal to that run's
    (``dense``); MAIN_STEPS DSM and MAIN_STEPS * tau AdamW launches in the
    run, the post-run phase probe's apart; the run directory complete and
    summarized by ``python -m repro_torch.obs``; from the trace of the
    profiled step: tau AdamW and one DSM kernel launch, the device busy
    share, the top device operations and the longest idle gaps.  The
    median outer step leaves out the first and the profiled one.  Every
    number is printed before any check."""
    from repro_torch.configs import gpt2_small
    from repro_torch.obs.sinks import read_run
    from repro_torch.obs.tracing import profile_summary
    from repro_torch.train.trainer import TrainSettings, run_training

    cfg = gpt2_small_cut()
    corpus = training_corpus()
    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        s = TrainSettings(tau=gpt2_small.TOPO.tau, steps=MAIN_STEPS, eval_every=MAIN_STEPS,
                          run_dir=d, log_every=1,
                          profile_steps=f"{PROFILED_STEP}:{PROFILED_STEP}", sanitize=True,
                          **MAIN)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        res = run_training(cfg, s, corpus, device="cuda")
        probe = res["probe_launches"]
        launches = {k: n - probe[k] for k, n in K.launch_counts().items()}
        manifest, events, rows = read_run(d)
        summary = subprocess.run([sys.executable, "-m", "repro_torch.obs", "summarize", d],
                                 capture_output=True, text=True, timeout=120, cwd=ROOT,
                                 env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        traces = sorted((Path(d) / "profile").glob("*.json"))
        trace = profile_summary(str(traces[0])) if traces else None
        trace_bytes = os.path.getsize(traces[0]) if traces else None
    final = dense_final(torch, res)
    step_s, peak, phase_ms = res["outer_step_s"], res["peak_bytes"], res["phase_ms"]
    del res
    spans = [e for e in events if e["kind"] == "span"]
    ledger = next((e for e in events if e["kind"] == "comm_ledger"), None)
    memory = next((e["stats"] for e in events if e["kind"] == "device_memory"), None)
    failed = [e for e in events if e["kind"] == "profile_failed"]
    kernels = {name: sum(n for k, n in (trace or {}).get("kernel_launches", {}).items()
                         if f"{name}_kernel" in k) for name in ("adamw", "dsm")}
    step_ms = statistics.median(step_s[i] for i in range(1, MAIN_STEPS)
                                if i != PROFILED_STEP) * 1e3
    row = {"phase": "obs_full_width", "gpu": smi, "config": cfg.name,
           "settings": {"log_every": 1, "profile_steps": s.profile_steps, "sanitize": True},
           "history": final["history"], "dense_history": dense["history"],
           "bit_equal_to_dense": bit_equal(torch, final, dense),
           "max_gap": max_gap(torch, final, dense),
           "launches": launches, "probe_launches": probe,
           "scalars_steps": [r["step"] for r in rows], "scalars_loss": [r["loss"] for r in rows],
           "manifest": {k: manifest.get(k) for k in ("backend", "device_name", "device_count",
                                                     "torch_version", "cuda_version")},
           "event_kinds": sorted({e["kind"] for e in events}),
           "train_window_n": sum(e.get("n", 1) for e in spans if e["name"] == "train_window"),
           "probe_spans_s": {e["name"]: e["seconds"] for e in spans if e.get("probe")},
           "comm_ledger": ledger and {k: ledger[k] for k in ("degenerate_mesh", "observed",
                                                            "predicted")},
           "device_memory": memory, "profile_failed": failed,
           "summarize_rc": summary.returncode, "summarize": summary.stdout[-3000:],
           "phase_ms": phase_ms, "outer_step_ms": [t * 1e3 for t in step_s],
           "outer_step_ms_median_unprofiled": step_ms, "max_memory_allocated_bytes": peak,
           "profiled_step": PROFILED_STEP, "trace_bytes": trace_bytes, "trace_kernels": kernels,
           "trace": trace}
    emit(row)
    failures = []
    if not row["bit_equal_to_dense"]:
        failures.append(f"history / x0 / m differ from the dense run's by {row['max_gap']}")
    want = {"dsm_update": s.steps, "adamw_update": s.steps * s.tau}
    if launches != want:
        failures.append(f"launch counts {launches}, want {want}")
    # the probe: 1 warm-up + 3 timed local phases, 1 + 3 timed outer steps
    if probe != {"dsm_update": 4, "adamw_update": 8 * s.tau}:
        failures.append(f"probe launches {probe}")
    if row["scalars_steps"] != list(range(1, s.steps + 1)) or row["scalars_loss"] != final[
            "history"]:
        failures.append("scalars.csv does not hold the history")
    if row["manifest"]["device_name"] != torch.cuda.get_device_name(0):
        failures.append(f"manifest names {row['manifest']['device_name']}")
    need = {"comm_ledger", "eval", "span", "device_memory", "finished"}
    if not need <= set(row["event_kinds"]) or row["train_window_n"] != s.steps:
        failures.append(f"events {row['event_kinds']}, train windows {row['train_window_n']}")
    if set(row["probe_spans_s"]) != {"local_phase", "global_step"}:
        failures.append(f"probe spans {row['probe_spans_s']}")
    if not (ledger and ledger["degenerate_mesh"]):
        failures.append("no degenerate comm_ledger")
    if not memory or not all(v["peak_bytes_in_use"] > 0 for v in memory.values()):
        failures.append(f"device_memory {memory}")
    if summary.returncode != 0:
        failures.append(f"summarize exited {summary.returncode}: {summary.stderr[-500:]}")
    if failed or trace is None:
        failures.append(f"no trace: {failed}")
    elif kernels != {"adamw": s.tau, "dsm": 1} or trace["busy_share"] is None:
        failures.append(f"trace kernels {kernels}, busy share {trace['busy_share']}")
    if failures:
        raise AssertionError("obs_full_width: " + "; ".join(failures))
    return {k: launches[k] + probe[k] for k in want}


def cpu_run(cfg, s, params) -> dict:
    """``run_training(cfg, s, device="cpu", params=params)`` in a CPU worker
    process; its history, skipped rounds and rollbacks."""
    from repro_torch.train.trainer import run_training

    res = run_training(cfg, s, device="cpu", params=params)
    return {k: res[k] for k in ("history", "skipped_rounds", "rollbacks")}


def cpu_worker_init() -> None:
    """Each worker at its start: its torch threads, and the imports of
    cpu_run."""
    import torch

    import repro_torch.train.trainer  # noqa: F401

    torch.set_num_threads(CPU_WORKER_THREADS)


def shared(x0):
    """``x0`` (a tensor or the Groups of a mixed-dtype model) with its
    storage moved into shared memory now, in this thread.  Pickling a CPU
    tensor for another process moves its storage there in place, and a
    pool's feeder thread (or a second thread starting ranks) pickles while
    a card run of this thread reads the same tensor: without this, the
    read can meet the old buffer freed mid-copy."""
    from repro_torch.groups import parts

    for t in parts(x0):
        t.share_memory_()
    return x0


def cpu_worker():
    """CPU_WORKERS processes (spawned, all started now) for the card-vs-CPU
    phases' CPU runs; the caller shuts them down."""
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
        initializer=cpu_worker_init)
    for _ in range(CPU_WORKERS):     # one process per submit while none is idle
        pool.submit(int)
    return pool


def phase_card_vs_cpu(torch, pool):
    """Nano, same init and batches, kernels on the card vs plain versions on
    the CPU.  Bound NANO_RTOL on each outer step's train loss: the two
    devices sum in other orders, and sign() (and AdamW's sign-like first
    steps) can turn such ulps into steps of 2 * eta * gamma on a few
    coordinates per round."""
    from repro_torch.configs.nano import NANO
    from repro_torch.configs.gpt2_small import TOPO
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings, run_training

    s = TrainSettings(tau=TOPO.tau, steps=NANO_STEPS, eval_every=NANO_STEPS, **MAIN)
    x0 = shared(T.init_params(torch.Generator().manual_seed(0), NANO))
    cpu = pool.submit(cpu_run, NANO, s, x0)
    card = run_training(NANO, s, device="cuda", params=x0)
    cpu = cpu.result(timeout=CPU_RUN_TIMEOUT_S)
    rel = [abs(a - b) / abs(b) for a, b in zip(card["history"], cpu["history"])]
    emit({"phase": "card_vs_cpu", "config": NANO.name, "card": card["history"],
          "cpu": cpu["history"], "max_rel_diff": max(rel), "rtol": NANO_RTOL,
          "card_outer_step_ms": [t * 1e3 for t in card["outer_step_s"]]})
    if max(rel) > NANO_RTOL:
        raise AssertionError(f"card and CPU loss histories differ by {max(rel)}")


def gpt2_small_cut():
    """gpt2_small.FULL (width 768, vocab padded to 50,688, bf16) at CUT_LAYERS
    layers."""
    import dataclasses

    from repro_torch.configs import gpt2_small

    return dataclasses.replace(gpt2_small.FULL, name=f"gpt2_small_{CUT_LAYERS}l",
                               n_layers=CUT_LAYERS)


def algo_settings(TrainSettings, run: dict, tau: int):
    kw = {**MAIN, "global_lr": ALGO_GLOBAL_LR.get(run["algorithm"], MAIN["global_lr"]), **run}
    return TrainSettings(tau=tau, steps=ALGO_STEPS, eval_every=ALGO_STEPS, **kw)


def run_name(run: dict) -> str:
    return "+".join(str(v) for v in run.values())


def expected_launches(s, groups: int = 1) -> dict:
    """Per run: the DSM kernel once per outer step and dtype group for dsm
    (the deterministic sign, any base optimizer) and signed_lookahead; the
    AdamW kernel tau times per outer step and group for every algorithm with
    AdamW but mv_signsgd."""
    dsm = s.algorithm in ("dsm", "signed_lookahead") and s.sign_mode == "sign"
    adamw = s.base_opt == "adamw" and s.algorithm != "mv_signsgd"
    return {"dsm_update": s.steps * dsm * groups,
            "adamw_update": s.steps * s.tau * adamw * groups}


def check_launches(name, launches, want) -> None:
    if launches != want:
        raise AssertionError(f"{name}: launch counts {launches}, want {want}")


def phase_algorithms_full_width(torch, K, smi):
    """gpt2_small at full width and CUT_LAYERS layers, W=4, tau=12: every
    baseline, DSM with Sophia local steps and DSM with the randomized sign,
    ALGO_STEPS outer steps each."""
    from repro_torch.configs import gpt2_small
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings, run_training

    cfg = gpt2_small_cut()
    corpus = training_corpus()
    x0 = T.init_params(torch.Generator().manual_seed(0), cfg)
    total = dict.fromkeys(K.launch_counts(), 0)
    runs = []
    for run in FULL_WIDTH_RUNS:
        s = algo_settings(TrainSettings, run, gpt2_small.TOPO.tau)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        res = run_training(cfg, s, corpus, device="cuda", params=x0)
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        hist, final_eval, step_s = res["history"], res["final_eval"], res["outer_step_s"]
        del res
        if not all(math.isfinite(x) for x in hist + [final_eval]):
            raise AssertionError(f"{run_name(run)}: non-finite loss {hist}, eval {final_eval}")
        check_launches(run_name(run), launches, expected_launches(s))
        step_ms = statistics.median(step_s[1:]) * 1e3
        runs.append({"run": run_name(run), "global_lr": s.global_lr, "history": hist,
                     "final_eval": final_eval, "outer_step_ms": [t * 1e3 for t in step_s],
                     "outer_step_ms_median_after_first": step_ms,
                     "tokens_per_s": s.n_workers * s.tau * s.b_micro * s.seq / (step_ms / 1e3),
                     "max_memory_allocated_bytes": peak, "launches": launches})
        for k, n in launches.items():
            total[k] += n
    emit({"phase": "algorithms_full_width", "gpu": smi, "config": cfg.name,
          "n_params": T.layout(cfg).numel, "n_workers": MAIN["n_workers"],
          "tau": gpt2_small.TOPO.tau, "b_micro": MAIN["b_micro"], "seq": MAIN["seq"],
          "outer_steps": ALGO_STEPS, "runs": runs})
    return total


def phase_algorithms_card_vs_cpu(torch, K, pool):
    """Nano, the same init and batches on the card and the CPU, for every
    deterministic algorithm and DSM with each base optimizer: each train
    loss within NANO_RTOL (the reason is phase_card_vs_cpu's), or
    SIGN_LIKE_RTOL for the sign-like base optimizers.  The random
    paths only have to be finite: the two devices' generators differ.  Every
    line is printed before any bound is checked."""
    from repro_torch.configs.nano import NANO
    from repro_torch.configs.gpt2_small import TOPO
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings, run_training

    x0 = shared(T.init_params(torch.Generator().manual_seed(0), NANO))
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures = [], []
    runs = NANO_DETERMINISTIC_RUNS + NANO_RANDOM_RUNS
    cpu_runs = [pool.submit(cpu_run, NANO, algo_settings(TrainSettings, run, TOPO.tau), x0)
                for run in runs]
    for run, cpu in zip(runs, cpu_runs):
        s = algo_settings(TrainSettings, run, TOPO.tau)
        K.reset_launch_counts()
        card = run_training(NANO, s, device="cuda", params=x0)["history"]
        launches = K.launch_counts()
        cpu = cpu.result(timeout=CPU_RUN_TIMEOUT_S)["history"]
        check_launches(f"nano {run_name(run)}", launches, expected_launches(s))
        for k, n in launches.items():
            total[k] += n
        row = {"run": run_name(run), "card": card, "cpu": cpu, "launches": launches}
        if not all(math.isfinite(x) for x in card + cpu):
            failures.append(f"{run_name(run)}: non-finite loss")
        if run in NANO_DETERMINISTIC_RUNS:
            row["rtol"] = (SIGN_LIKE_RTOL if run.get("base_opt") in SIGN_LIKE_BASE_OPTS
                           else NANO_RTOL)
            row["max_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
            if row["max_rel_diff"] > row["rtol"]:
                failures.append(f"{run_name(run)}: card and CPU differ by {row['max_rel_diff']}")
        rows.append(row)
    emit({"phase": "algorithms_card_vs_cpu", "config": NANO.name, "outer_steps": ALGO_STEPS,
          "rtol": NANO_RTOL, "rtol_sign_like": SIGN_LIKE_RTOL, "runs": rows})
    if failures:
        raise AssertionError("; ".join(failures))
    return total


def fault_plan(FaultPlan, FaultSpec):
    """The hand-built plan of FAULT_ROUNDS for W = 4 workers."""
    plan = FaultPlan(MAIN["n_workers"], len(FAULT_ROUNDS), FaultSpec())
    for t, masks in enumerate(FAULT_ROUNDS):
        for arr, workers in zip((plan.drop, plan.stale, plan.corrupt), masks):
            arr[t, list(workers)] = True
    return plan


def bits(torch, t):
    return t.view({torch.float32: torch.int32, torch.bfloat16: torch.int16}[t.dtype])


def phase_robustness_full_width(torch, K, smi, main_cost):
    """gpt2_small at full width and CUT_LAYERS layers (whole depth until
    model_axis_full_width came in; cut for the command's time target),
    W=4, tau=12, DSM + AdamW under the hand-built fault
    plan with mask_nonfinite and guard_nonfinite.  After every round: every
    state tensor finite, the pack's survivor_frac the plan's; across the
    all-dropped round x0 and m byte-equal to copies on the card; one DSM
    launch per round (the skip-round included) and tau AdamW launches."""
    from repro_torch.configs import gpt2_small
    from repro_torch.obs.metrics import IDX
    from repro_torch.robustness.faults import FaultPlan, FaultSpec
    from repro_torch.robustness.guards import state_tensors
    from repro_torch.train.trainer import TrainSettings, run_training

    cfg = gpt2_small_cut()
    plan = fault_plan(FaultPlan, FaultSpec)
    s = TrainSettings(tau=gpt2_small.TOPO.tau, steps=len(FAULT_ROUNDS),
                      eval_every=len(FAULT_ROUNDS), faults=plan, mask_nonfinite=True,
                      guard_nonfinite=True, **MAIN)
    want_sf = [float((~plan.drop[t] & ~plan.corrupt[t]).mean()) for t in range(plan.steps)]
    rounds, kept = [], {}

    def on_round(t, state, metrics):
        finite = torch.stack([torch.isfinite(x).all() for x in state_tensors(state)]).all()
        row = {"t": t, "finite": bool(finite), "guard_ok": bool(metrics["guard_ok"]),
               "survivor_frac": metrics["pack"][IDX["survivor_frac"]].item()}
        if t == ALL_DROPPED:
            row["x0_m_unchanged"] = bool(torch.equal(bits(torch, state.x0), kept["x0"])
                                         and torch.equal(bits(torch, state.m), kept["m"]))
            kept.clear()
        if t + 1 == ALL_DROPPED:
            kept.update(x0=bits(torch, state.x0).clone(), m=bits(torch, state.m).clone())
        rounds.append(row)

    corpus = training_corpus()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    res = run_training(cfg, s, corpus, device="cuda", on_round=on_round)
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist, step_s = res["history"], res["outer_step_s"]
    step_ms = statistics.median(step_s[1:]) * 1e3
    layer_ms = fault_layer_ms(torch, res["state"], plan.round(2, res["state"].x0.device))
    emit({"phase": "robustness_full_width", "gpu": smi, "config": cfg.name,
          "n_workers": s.n_workers, "tau": s.tau, "outer_steps": s.steps,
          "fault_rounds": [{"drop": list(d), "stale": list(st), "corrupt": list(c)}
                           for d, st, c in FAULT_ROUNDS],
          "rounds": rounds, "history": hist, "final_eval": res["final_eval"],
          "skipped_rounds": res["skipped_rounds"],
          "outer_step_ms": [t * 1e3 for t in step_s],
          "outer_step_ms_median_after_first": step_ms,
          "main_path_outer_step_ms_median_after_first": main_cost["outer_step_ms"],
          "max_memory_allocated_bytes": peak,
          "main_path_max_memory_allocated_bytes": main_cost["max_memory_allocated_bytes"],
          "check_copies_bytes": 6 * n_params(cfg),   # on_round's bf16 x0 + f32 m
          "fault_layer_ms": layer_ms, "fault_layer_reps": 10, "launches": launches})
    del res
    failures = []
    if not all(math.isfinite(x) for x in hist):
        failures.append(f"non-finite loss {hist}")
    if not all(r["finite"] for r in rounds):
        failures.append("a state tensor went non-finite")
    if [r["survivor_frac"] for r in rounds] != want_sf:
        failures.append(f"survivor_frac {[r['survivor_frac'] for r in rounds]}, plan {want_sf}")
    if not rounds[ALL_DROPPED].get("x0_m_unchanged"):
        failures.append("x0 / m changed across the all-dropped round")
    check_launches("robustness_full_width", launches,
                   {"dsm_update": s.steps, "adamw_update": s.steps * s.tau})
    if failures:
        raise AssertionError("robustness_full_width: " + "; ".join(failures))
    return launches


def fault_layer_ms(torch, state, fr) -> dict:
    """CUDA-event times of the fault-tolerance layer alone, on the full-width
    state after the run (each leaves it as it is): the guard's snapshot,
    finiteness check and select around a step that does nothing; the
    survivor-aware mean (apply_faults, finite mask, masked mean) of the
    round ``fr`` beside the dense mean it replaces (``worker_mean``, as the
    paths run it, and one ``mean(dim=0)`` call over the rows for
    comparison); the skip-round's x0/m copies and select."""
    from repro_torch.core.dsm import masked_worker_mean, worker_finite_mask, worker_mean
    from repro_torch.robustness.faults import apply_faults
    from repro_torch.robustness.guards import init_guard, make_guarded_step

    dev = state.x0.device
    loss = torch.ones((), device=dev)
    guard = init_guard(dev)
    noop = make_guarded_step(lambda st, *a: (st, {"loss": loss}), nonfinite=True)

    def survivor_mean():
        contrib = apply_faults(state.params, state.x0, fr)
        w = fr.survivors.float() * worker_finite_mask(contrib).float()
        return masked_worker_mean(contrib, w)

    def skip_select():
        ok = torch.ones((), dtype=torch.bool, device=dev)
        for buf in (state.x0, state.m):
            torch.where(ok, buf, buf.clone(), out=buf)

    return {"guard": median_ms(torch, lambda: noop(state, guard), reps=10),
            "survivor_mean": median_ms(torch, survivor_mean, reps=10),
            "dense_mean": median_ms(torch, lambda: worker_mean(state.params), reps=10),
            "one_call_mean": median_ms(torch, lambda: state.params.mean(
                dim=0, dtype=torch.float32).to(state.params.dtype), reps=10),
            "skip_select": median_ms(torch, skip_select, reps=10)}


def n_params(cfg) -> int:
    from repro_torch.models import transformer as T

    return T.layout(cfg).numel


def group_list(x) -> list:
    """A run's final x0 or m as a list of each dtype group's tensor."""
    return list(x) if isinstance(x, (list, tuple)) else [x]


def max_gap(torch, a: dict, b: dict) -> dict:
    """Largest differences between two runs' histories and final x0 / m
    (over every dtype group)."""
    return {"history": max(abs(x - y) for x, y in zip(a["history"], b["history"])),
            **{k: max((p.float() - q.float()).abs().max().item()
                      for p, q in zip(group_list(a[k]), group_list(b[k]), strict=True))
               for k in ("x0", "m")}}


def bit_equal(torch, a: dict, b: dict) -> bool:
    """Equal histories, and x0 / m of every dtype group equal in their bits."""
    return a["history"] == b["history"] and all(
        torch.equal(bits(torch, p), bits(torch, q))
        for k in ("x0", "m") for p, q in zip(group_list(a[k]), group_list(b[k]), strict=True))


def rank_final(r) -> dict:
    """A rank's history and its gathered x0 / m, each a list of the dtype
    groups' tensors (``torch_ranks.flat_state`` names them ``x0`` for one
    group, ``x0.0``, ``x0.1`` for two)."""
    st = r["state"]
    return {"history": r["history"],
            **{k: [st[n] for n in sorted(st) if n.split(".")[0] == k] for k in ("x0", "m")}}


def dense_final(torch, res) -> dict:
    """run_training's history and final x0 / m on the host, per dtype group."""
    from repro_torch.groups import parts

    st = res["state"]
    return {"history": res["history"], "x0": [t.cpu() for t in parts(st.x0)],
            "m": [t.cpu() for t in parts(st.m)]}


def phase_resume_full_width(torch, K, smi):
    """gpt2_small at full width and CUT_LAYERS layers, DSM + AdamW, the main
    path's settings.  Repeat: two uninterrupted 4-step runs (default
    algorithms; obs_full_width repeats main_path itself at full depth), then
    two under torch.use_deterministic_algorithms(True, warn_only=True).
    Resume, in that mode: 2 steps with checkpoint_every=2, then resume=True
    to step 4, into a temporary directory that the phase removes.  If the
    two deterministic runs agree bit for bit, the resumed history and final
    x0 and m must too; else they must stay within the repeat gap.  Returns
    (launches, the first uninterrupted run's history and x0 / m on the
    host: what obs_full_width and the ranks phases are held against)."""
    from repro_torch.configs import gpt2_small
    from repro_torch.train.trainer import TrainSettings, run_training

    cfg = gpt2_small_cut()
    corpus = training_corpus()
    total = dict.fromkeys(K.launch_counts(), 0)

    def run(**kw):
        s = TrainSettings(tau=gpt2_small.TOPO.tau, eval_every=RESUME_STEPS,
                          **{"steps": RESUME_STEPS, **MAIN, **kw})
        torch.cuda.empty_cache()
        K.reset_launch_counts()
        res = run_training(cfg, s, corpus, device="cuda")
        steps_run = len(res["outer_step_s"])
        check_launches("resume_full_width", K.launch_counts(),
                       {"dsm_update": steps_run, "adamw_update": steps_run * s.tau})
        for k, n in K.launch_counts().items():
            total[k] += n
        out = {"history": res["history"], "x0": res["state"].x0.cpu(), "m": res["state"].m.cpu(),
               "checkpoint_s": res["checkpoint_s"], "restore_s": res["restore_s"],
               "steps_run": steps_run}
        del res
        return out

    default, default_b = run(), run()
    warn = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            det_a, det_b = run(), run()
            tmp_root = ROOT / "build"
            tmp_root.mkdir(exist_ok=True)
            with tempfile.TemporaryDirectory(dir=tmp_root) as d:
                first = run(steps=2, checkpoint_dir=d, checkpoint_every=2, checkpoint_keep=1)
                resumed = run(checkpoint_dir=d, checkpoint_every=2, checkpoint_keep=1,
                              resume=True)
                ck = os.path.join(d, "ckpt_%08d" % RESUME_STEPS)
                ck_bytes = os.path.getsize(ck + ".npz") + os.path.getsize(ck + ".json")
        finally:
            torch.use_deterministic_algorithms(False)
    warn = sorted({str(w.message).splitlines()[0][:200] for w in caught})
    repeat_default = bit_equal(torch, default, default_b)
    repeat_det = bit_equal(torch, det_a, det_b)
    gap = max_gap(torch, det_a, det_b)
    resume_gap = max_gap(torch, resumed, det_a)
    held = ("bit-exact" if repeat_det and bit_equal(torch, resumed, det_a) else
            "within the repeat gap" if not repeat_det and all(
                resume_gap[k] <= gap[k] for k in gap) else "failed")
    emit({"phase": "resume_full_width", "gpu": smi, "config": cfg.name,
          "outer_steps": RESUME_STEPS, "killed_at": 2,
          "default_repeat_bit_exact": repeat_default,
          "default_repeat_gap": max_gap(torch, default, default_b),
          "deterministic_repeat_bit_exact": repeat_det, "deterministic_repeat_gap": gap,
          "deterministic_warnings": warn, "resumed_gap": resume_gap, "resume": held,
          "history": det_a["history"], "resumed_history": resumed["history"],
          "resumed_steps_run": resumed["steps_run"],
          "checkpoint_bytes": ck_bytes,
          "checkpoint_save_s": first["checkpoint_s"] + resumed["checkpoint_s"],
          "restore_s": resumed["restore_s"]})
    if held == "failed":
        raise AssertionError(f"resume_full_width: resumed run differs by {resume_gap}, "
                             f"repeat gap {gap}")
    if resumed["steps_run"] != RESUME_STEPS - 2 or resumed["restore_s"] is None:
        raise AssertionError("resume_full_width: the resumed run did not start at step 2")
    return total, default


def phase_robustness_card_vs_cpu(torch, K, pool):
    """Nano, the hand-built fault plan and guards on the card and the CPU:
    (a) mask_nonfinite + guard_nonfinite; (b) the same plus SPIKE_FACTOR,
    which rejects every round after the first, with checkpoints every round,
    patience 2 and up to 4 rollbacks: each rollback replays one round from a
    checkpoint taken mid-streak, so the run ends.  Loss histories within
    NANO_RTOL, skipped rounds and rollbacks equal; every line is printed
    before any bound is checked."""
    from repro_torch.configs.gpt2_small import TOPO
    from repro_torch.configs.nano import NANO
    from repro_torch.models import transformer as T
    from repro_torch.robustness.faults import FaultPlan, FaultSpec
    from repro_torch.train.trainer import TrainSettings, run_training

    x0 = shared(T.init_params(torch.Generator().manual_seed(0), NANO))
    plan = fault_plan(FaultPlan, FaultSpec)
    total = dict.fromkeys(K.launch_counts(), 0)
    runs = {"faults+guards": {},
            "faults+guards+spike+rollback": dict(guard_spike_factor=SPIKE_FACTOR,
                                                 checkpoint_every=1, guard_patience=2,
                                                 guard_max_rollbacks=4)}
    rows, failures = [], []
    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:

        def settings(name, kw, side):
            ck = os.path.join(d, f"{name}_{side}")
            os.makedirs(ck)
            return TrainSettings(tau=TOPO.tau, steps=len(FAULT_ROUNDS),
                                 eval_every=len(FAULT_ROUNDS), faults=plan, mask_nonfinite=True,
                                 guard_nonfinite=True, checkpoint_dir=ck if kw else None,
                                 **MAIN, **kw)

        cpu_runs = {name: pool.submit(cpu_run, NANO, settings(name, kw, "cpu"), x0)
                    for name, kw in runs.items()}
        out = {}
        for name, kw in runs.items():
            s = settings(name, kw, "card")
            K.reset_launch_counts()
            res = run_training(NANO, s, device="cuda", params=x0)
            n_rounds = len(res["outer_step_s"])     # replayed rounds included
            check_launches(f"nano {name}", K.launch_counts(),
                           {"dsm_update": n_rounds, "adamw_update": n_rounds * s.tau})
            for k, n in K.launch_counts().items():
                total[k] += n
            out[name] = ({k: res[k] for k in ("history", "skipped_rounds", "rollbacks")},
                         cpu_runs[name].result(timeout=CPU_RUN_TIMEOUT_S))
    for name, kw in runs.items():
        card, cpu = out[name]
        rel = max(abs(a - b) / abs(b) for a, b in zip(card["history"], cpu["history"]))
        rows.append({"run": name, "card": card, "cpu": cpu, "max_rel_diff": rel,
                     "rtol": NANO_RTOL})
        if rel > NANO_RTOL or len(card["history"]) != len(cpu["history"]):
            failures.append(f"{name}: card and CPU differ by {rel}")
        if (card["skipped_rounds"], card["rollbacks"]) != (cpu["skipped_rounds"],
                                                           cpu["rollbacks"]):
            failures.append(f"{name}: skipped/rollbacks {card} vs {cpu}")
        if kw and not (card["skipped_rounds"] > 0 and card["rollbacks"] > 0):
            failures.append(f"{name}: the guard rejected nothing or never rolled back")
    emit({"phase": "robustness_card_vs_cpu", "config": NANO.name,
          "outer_steps": len(FAULT_ROUNDS), "spike_factor": SPIKE_FACTOR, "runs": rows})
    if failures:
        raise AssertionError("; ".join(failures))
    return total


def run_ranks(world, cfg, settings, device, params=None, corpus=None, fields=None,
              backend="gloo"):
    """Each rank's results of ``tests/torch_ranks.py::train_rank`` (one
    process per rank, in ``build/``); a child's failure raises here."""
    from repro_torch.distributed import spawn

    import torch_ranks

    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    res = spawn.run_ranks(torch_ranks.train_rank, world,
                          (cfg, settings, device, params, corpus, fields),
                          backend=backend, timeout_s=RANKS_TIMEOUT_S, group_timeout_s=120,
                          work_dir=str(tmp_root))
    return [[r[i] for r in res] for i in range(len(settings))]


def ranks_summary(ranks, steps) -> dict:
    """Per rank: launches, peak bytes, outer-step ms, collectives per round."""
    return {"launches": [r["launches"] for r in ranks],
            "peak_bytes": [r.get("peak_bytes") for r in ranks],
            "outer_step_ms": [[t * 1e3 for t in r["outer_step_s"]] for r in ranks],
            "outer_step_ms_median_after_first": [
                statistics.median(r["outer_step_s"][1:]) * 1e3 for r in ranks],
            "collective_ms_per_round": [
                sum(v["seconds"] for v in r["comm"].values()) / steps * 1e3 for r in ranks],
            "collective_bytes_per_round": [
                sum(v["bytes"] for v in r["comm"].values()) / steps for r in ranks],
            "collectives": [r["comm"] for r in ranks]}


def history_rel(a, b) -> float:
    return max(rel_per_round(a, b))


def rel_per_round(a, b) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


# the full-width ranks phases: each name's flags; the first also writes a
# run directory
RANKS_FULL_WIDTH = (("zero_full_width", dict(zero_sharded=True, device_parallel_local=True)),
                    ("device_parallel_full_width", dict(device_parallel_local=True)))


def phase_ranks_full_width(torch, K, smi, dense):
    """gpt2_small at full width and CUT_LAYERS layers, W=4, tau=12,
    MAIN_STEPS outer steps, the main path's init and data, as RANKS
    processes sharing the card over gloo (one worker each), once per flag
    set of RANKS_FULL_WIDTH, all in one start of the ranks: the ZeRO-sharded
    global step with the device-parallel local phase (zero_full_width),
    then the device-parallel local phase alone (device_parallel_full_width).
    The first gets a run directory (in build/) that rank 0 writes, and its
    comm ledger's observed bytes must equal each rank's CommStats bytes of
    one round.  Each flag set's loss history within ZERO_RTOL of the dense
    run's (``dense``, resume_full_width's uninterrupted run; bit-equal is
    expected: each rank runs its worker as the dense process does, and the
    scattered mean is the dense mean column for column); the largest x0/m
    gap printed either way.  Per rank: MAIN_STEPS DSM launches (over the
    rank's shard with zero_sharded, over N without) and MAIN_STEPS * tau
    AdamW launches over (1, N), peak memory, step time, collectives."""
    from repro_torch.configs import gpt2_small
    from repro_torch.distributed import zero
    from repro_torch.obs.sinks import read_run
    from repro_torch.train.trainer import TrainSettings

    cfg = gpt2_small_cut()
    corpus = training_corpus()
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        settings = [TrainSettings(tau=gpt2_small.TOPO.tau, steps=MAIN_STEPS,
                                  eval_every=MAIN_STEPS, run_dir=d if i == 0 else None,
                                  **MAIN, **flags)
                    for i, (_, flags) in enumerate(RANKS_FULL_WIDTH)]
        t0 = time.perf_counter()
        runs = run_ranks(RANKS, cfg, settings, "cuda", corpus=corpus, fields=("x0", "m"))
        wall = time.perf_counter() - t0
        events = read_run(d)[1]
    total = dict.fromkeys(K.launch_counts(), 0)
    failures = []
    n = n_params(cfg)
    for (name, flags), s, ranks in zip(RANKS_FULL_WIDTH, settings, runs):
        ledger = next((e for e in events if e["kind"] == "comm_ledger"),
                      None) if s.run_dir else None
        round_bytes = [sum(v["bytes"] for v in r["comm"].values()) / s.steps for r in ranks]
        final = rank_final(ranks[0])
        want = {"dsm_update": s.steps, "adamw_update": s.steps * s.tau}
        rel = history_rel(final["history"], dense["history"])
        emit({"phase": name, "gpu": smi, "config": cfg.name, "n_params": n, "ranks": RANKS,
              "backend": "gloo", "n_workers": s.n_workers, "tau": s.tau,
              "outer_steps": s.steps, "flags": flags, "dsm_elements_per_rank": (
                  [b - a for a, b in zero.shard_bounds(n, RANKS)] if s.zero_sharded
                  else [n] * RANKS),
              "history": final["history"], "dense_history": dense["history"],
              "max_rel_diff": rel, "rtol": ZERO_RTOL,
              "bit_equal_to_dense": bit_equal(torch, final, dense),
              "max_gap": max_gap(torch, final, dense), "final_eval": ranks[0]["final_eval"],
              "wall_s_all_flag_sets": wall, **ranks_summary(ranks, s.steps),
              "probe_launches": [r["probe_launches"] for r in ranks],
              "comm_ledger": ledger and {k: ledger[k] for k in ("observed", "predicted",
                                                                "ratio")}})
        if s.run_dir:
            observed = ledger and ledger["observed"]["reduce_bytes"] + ledger["observed"][
                "gather_bytes"]
            if not ledger or any(observed != b for b in round_bytes):
                failures.append(f"{name}: comm ledger {observed} bytes, CommStats "
                                f"{round_bytes} per round")
        if any(r["history"] != final["history"] for r in ranks):
            failures.append(f"{name}: the ranks' histories differ")
        if rel > ZERO_RTOL:
            failures.append(f"{name}: history differs from the dense run's by {rel}")
        for r, got in enumerate(r["launches"] for r in ranks):
            if got != want:
                failures.append(f"{name}: rank {r}: launch counts {got}, want {want}")
        for k in total:
            total[k] += sum(r["launches"][k] + (r["probe_launches"] or {}).get(k, 0)
                            for r in ranks)
    if failures:
        raise AssertionError("; ".join(failures))
    return total


def phase_zero_nccl_world1(torch, K):
    """Nano and granite_moe's SMOKE with bf16 parameters (two dtype groups),
    NCCL_STEPS outer steps each, one rank over NCCL (the only NCCL group one
    card allows) with both flags, both models in one start of the rank:
    each bit-equal to its dense run on the card, x0 and m of every group."""
    from repro_torch.configs.gpt2_small import TOPO
    from repro_torch.configs.nano import NANO
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings, run_training

    cfgs = [NANO, mixed_smokes()[0]]
    inits = [T.init_params(torch.Generator().manual_seed(0), cfg) for cfg in cfgs]
    kw = dict(tau=TOPO.tau, steps=NCCL_STEPS, eval_every=NCCL_STEPS, **MAIN)
    s = TrainSettings(zero_sharded=True, device_parallel_local=True, **kw)
    rank = run_ranks(1, cfgs, [s] * len(cfgs), "cuda", inits, backend="nccl")
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures = [], []
    for cfg, x0, (got,) in zip(cfgs, inits, rank):
        groups = T.layout(cfg).n_groups
        K.reset_launch_counts()
        dense = run_training(cfg, TrainSettings(**kw), device="cuda", params=x0)
        launches = K.launch_counts()
        ours, theirs = rank_final(got), dense_final(torch, dense)
        same = bit_equal(torch, ours, theirs)
        rows.append({"config": cfg.name, "groups": groups, "history": ours["history"],
                     "dense_history": dense["history"], "bit_equal_to_dense": same,
                     "max_gap": max_gap(torch, ours, theirs), "launches": got["launches"],
                     "collectives": got["comm"]})
        want = {"dsm_update": s.steps * groups, "adamw_update": s.steps * s.tau * groups}
        if not same or got["launches"] != want or launches != want:
            failures.append(f"{cfg.name}: bit-equal {same}, launches {got['launches']} / "
                            f"{launches}, want {want}")
        for k in total:
            total[k] += launches[k] + got["launches"][k]
    emit({"phase": "zero_nccl_world1", "backend": "nccl", "ranks": 1, "outer_steps": s.steps,
          "runs": rows})
    if failures:
        raise AssertionError("zero_nccl_world1: " + "; ".join(failures))
    return total


def phase_zero_card_vs_cpu(torch, K):
    """Nano, the hand-built fault plan with mask_nonfinite and guards, both
    flags, RANKS gloo ranks on the card, checkpointing every 2 rounds.  Held
    against the dense run on the card bit for bit, and against RANKS gloo
    ranks on the CPU within NANO_RTOL with equal skipped rounds.  The
    checkpoint at step 2 is then resumed by one process (world 4 -> 1) and
    must end bit-equal to the dense run too.  The card ranks write a run
    directory (rank 0); the resumed process appends to a copy of it, which
    must hold a ``resumed`` event and dedupe (the last row of each step) to
    the dense card run's history."""
    from repro_torch.configs.gpt2_small import TOPO
    from repro_torch.configs.nano import NANO
    from repro_torch.models import transformer as T
    from repro_torch.robustness.faults import FaultPlan, FaultSpec
    from repro_torch.train.trainer import TrainSettings, run_training
    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.obs.sinks import read_run
    from repro_torch.obs.summarize import _dedupe_by_step

    # shared now: a second thread pickles x0 for the CPU ranks while this
    # one's card runs read it
    x0 = shared(T.init_params(torch.Generator().manual_seed(0), NANO))
    plan = fault_plan(FaultPlan, FaultSpec)
    kw = dict(tau=TOPO.tau, steps=len(FAULT_ROUNDS), eval_every=len(FAULT_ROUNDS), faults=plan,
              mask_nonfinite=True, guard_nonfinite=True, **MAIN)
    both = dict(zero_sharded=True, device_parallel_local=True)
    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        ck = dict(checkpoint_every=2, checkpoint_keep=len(FAULT_ROUNDS))
        # the CPU ranks run beside the dense run and the card ranks, as
        # mixed_ranks_card_vs_cpu runs its own (cut from one after the other
        # for the time target: PERF.md section 4)
        with concurrent.futures.ThreadPoolExecutor(1) as side:
            cpu = side.submit(run_ranks, RANKS, NANO,
                              [TrainSettings(checkpoint_dir=f"{d}/cpu", **ck, **kw, **both)],
                              "cpu", x0)
            K.reset_launch_counts()
            dense = run_training(NANO, TrainSettings(**kw), device="cuda", params=x0)
            dense_launches = K.launch_counts()
            card = run_ranks(RANKS, NANO, [TrainSettings(checkpoint_dir=f"{d}/card", **ck, **kw,
                                                         run_dir=f"{d}/card_run", **both)],
                             "cuda", x0)[0]
            cpu = cpu.result(timeout=CPU_RUN_TIMEOUT_S)[0]
        os.makedirs(f"{d}/resume")
        for suffix in (".npz", ".json"):
            shutil.copy(CK.step_path(f"{d}/card", 2) + suffix, f"{d}/resume")
        shutil.copytree(f"{d}/card_run", f"{d}/resume_run")
        K.reset_launch_counts()
        resumed = run_training(NANO, TrainSettings(checkpoint_dir=f"{d}/resume", resume=True,
                                                   run_dir=f"{d}/resume_run", **ck, **kw, **both),
                               device="cuda", params=x0)
        probe = resumed["probe_launches"]
        resumed_launches = {k: n - probe[k] for k, n in K.launch_counts().items()}
        _, run_events, run_rows = read_run(f"{d}/resume_run")

    theirs = dense_final(torch, dense)
    ours, back = rank_final(card[0]), dense_final(torch, resumed)
    rel = history_rel(card[0]["history"], cpu[0]["history"])
    row = {"phase": "zero_card_vs_cpu", "config": NANO.name, "ranks": RANKS, "backend": "gloo",
           "outer_steps": len(FAULT_ROUNDS), "card": card[0]["history"],
           "cpu": cpu[0]["history"], "dense_card": dense["history"],
           "resumed_world1": resumed["history"], "max_rel_diff_card_cpu": rel,
           "rtol": NANO_RTOL, "bit_equal_to_dense": bit_equal(torch, ours, theirs),
           "resumed_bit_equal_to_dense": bit_equal(torch, back, theirs),
           "max_gap": max_gap(torch, ours, theirs),
           "skipped_rounds": [card[0]["skipped_rounds"], cpu[0]["skipped_rounds"],
                              dense["skipped_rounds"]],
           "launches": [r["launches"] for r in card], "resumed_launches": resumed_launches,
           "run_dir_rows": [r["step"] for r in run_rows],
           "run_dir_resumed": [e["step"] for e in run_events if e["kind"] == "resumed"],
           "run_dir_deduped_loss": [r["loss"] for r in _dedupe_by_step(run_rows)]}
    emit(row)
    failures = []
    if rel > NANO_RTOL:
        failures.append(f"card and CPU ranks differ by {rel}")
    if len(set(row["skipped_rounds"])) != 1:
        failures.append(f"skipped rounds {row['skipped_rounds']}")
    if not (row["bit_equal_to_dense"] and row["resumed_bit_equal_to_dense"]):
        failures.append("not bit-equal to the dense run on the card")
    if any(r["history"] != run[0]["history"] for run in (card, cpu) for r in run):
        failures.append("the ranks' histories differ")
    want = {"dsm_update": len(FAULT_ROUNDS), "adamw_update": len(FAULT_ROUNDS) * TOPO.tau}
    for got in [r["launches"] for r in card] + [dense_launches]:
        if got != want:
            failures.append(f"launch counts {got}, want {want}")
    # the resume from the step-2 checkpoint runs the last rounds only
    rest = len(FAULT_ROUNDS) - 2
    if resumed_launches != {"dsm_update": rest, "adamw_update": rest * TOPO.tau}:
        failures.append(f"resumed run: launch counts {resumed_launches}, want {rest} rounds")
    if (row["run_dir_resumed"] != [2] or len(row["run_dir_rows"]) != len(FAULT_ROUNDS) + rest
            or row["run_dir_deduped_loss"] != dense["history"]):
        failures.append("the resumed run directory does not dedupe to the dense history")
    if failures:
        raise AssertionError("zero_card_vs_cpu: " + "; ".join(failures))
    launch_sets = ([r["launches"] for r in card] + [r["probe_launches"] for r in card]
                   + [dense_launches, resumed_launches, probe])
    return {k: sum(ls[k] for ls in launch_sets) for k in want}


def phase_audit_card(torch, K, smi) -> dict:
    """The collective audit (``repro_torch.analysis.collective_audit.
    standard_audit`` with its self-test) on the card: RANKS gloo processes
    sharing it, one start of the ranks, first gpt2_small at full width and
    CUT_LAYERS layers, then granite's SMOKE with bf16 parameters (two dtype
    groups: the group-by-group ceilings), W = RANKS, tau AUDIT_TAU, one
    outer step per variant.  Gate: the dense, device-parallel, ZeRO and
    trainer steps pass their budgets, the bare local phase records no
    collective, ZeRO gathers, the planted all-reduce (straight through
    torch.distributed) fails on its op count and its bytes, the recorder
    agrees with CommStats per kind (a violation otherwise), every recorded
    step is bit-equal to the same step unrecorded (x0, m and the workers'
    params of every group), and each rank's recorded run launches the DSM
    kernel once and AdamW tau times per group (the local phase: AdamW
    only).  Prints each variant's counts, bytes and ceilings and its
    outer-step seconds recorded beside unrecorded (the dispatch mode's host
    cost).  Returns the recorded runs' launches over the ranks."""
    from repro_torch.analysis.collective_audit import standard_audit
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import TrainSettings

    cfgs = [gpt2_small_cut(), mixed_smokes()[0]]
    groups = {cfg.name: len(T.layout(cfg).group_numels) for cfg in cfgs}
    torch.cuda.empty_cache()
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    reports = standard_audit(n_workers=RANKS, tau=AUDIT_TAU, ranks=RANKS, device="cuda",
                             self_test=True, cfg=cfgs, timeout_s=RANKS_TIMEOUT_S,
                             work_dir=str(ROOT / "build"), **AUDIT_BATCH)
    wall = time.perf_counter() - t0
    total = dict.fromkeys(K.launch_counts(), 0)
    failures, rows = [], []
    for r in reports:
        j = r.to_json()
        planted = r.name.startswith("self_test")
        want = expected_launches(TrainSettings(steps=1, tau=AUDIT_TAU), groups[r.config])
        if r.name == "local_phase":
            want["dsm_update"] = 0
        rows.append({k: j[k] for k in ("config", "name", "phase", "passed", "counts",
                                       "reduce_bytes", "gather_bytes", "metric_ops",
                                       "outside_comm", "violations", "launches", "bit_equal",
                                       "plain_s", "recorded_s")}
                    | {"budget": {k: v for k, v in j["budget"].items() if k.startswith("max")},
                       "recorded_over_plain": [a / b for a, b in zip(j["recorded_s"],
                                                                     j["plain_s"])]})
        where = f"{r.config} {r.name}"
        if planted:
            caught = [v for v in r.violations if "exceed" in v]
            if not (any("reduction ops" in v for v in caught)
                    and any("payload" in v for v in caught)):
                failures.append(f"{where}: the planted all-reduce was not caught on both its "
                                f"op count and its bytes: {r.violations}")
            if any("CommStats" in v or "bits" in v for v in r.violations):
                failures.append(f"{where}: {r.violations}")
        elif not r.passed:
            failures.append(f"{where}: {r.violations}")
        if r.name == "local_phase" and r.counts:
            failures.append(f"{where}: collectives in the local phase {r.counts}")
        if r.name == "zero_sharded" and not r.counts.get("all-gather"):
            failures.append(f"{where}: no all-gather")
        for rank, got in enumerate(j["launches"]):
            if got != want:
                failures.append(f"{where}: rank {rank}: launch counts {got}, want {want}")
            for k in total:
                total[k] += got[k]
    emit({"phase": "audit_card", "gpu": smi, "ranks": RANKS, "backend": "gloo",
          "n_workers": RANKS, "tau": AUDIT_TAU, **AUDIT_BATCH,
          "configs": {cfg.name: {"n_params": n_params(cfg), "groups": groups[cfg.name],
                                 "layers": cfg.n_layers} for cfg in cfgs},
          "seconds": wall, "variants": rows})
    if failures:
        raise AssertionError("audit_card: " + "; ".join(failures))
    return total


def local_step_breakdown(torch, cfg, state, corpus, s) -> dict:
    """One local step on a trained state (every worker's forward and
    backward, one AdamW launch): its host-clock ms (synced), then the same
    step under torch.profiler: device busy ms and share, device operations,
    the top ones.  Changes the state; its launches are not the run's."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.core.base_opt import get_base_optimizer
    from repro_torch.core.dsm import make_local_phase
    from repro_torch.data.pipeline import dsm_batches
    from repro_torch.models import transformer as T
    from repro_torch.obs.tracing import profile_summary

    local = make_local_phase(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), get_base_optimizer("adamw"),
                             T.layout(cfg))
    raw = next(dsm_batches(corpus, s.n_workers, 1, 1, s.b_micro, s.seq, seed=s.seed))
    batch = {"tokens": torch.as_tensor(raw["tokens"], dtype=torch.long, device="cuda")}
    local(state, batch, 1e-5)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    local(state, batch, 1e-5)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as d:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("dsm_local_phase"):
                local(state, batch, 1e-5)
            torch.cuda.synchronize()
        prof.export_chrome_trace(f"{d}/local_step.json")
        summ = profile_summary(f"{d}/local_step.json", top=5, gaps=0)
    return {"host_ms": host_ms, "profiled_window_ms": summ.get("window_us", 0) / 1e3,
            "device_busy_ms": summ.get("busy_us", 0) / 1e3, "busy_share": summ["busy_share"],
            "device_events": summ["device_events"], "top_ops": summ.get("top_ops")}


def phase_paper_sizes_full_width(torch, K, smi):
    """gpt2_medium, then gpt2_large: widths as published, depth cut to
    PAPER_SIZES' layers, bf16 params, W=4, tau=TOPO.tau, B_micro=4, S=128, the
    config's paper PEAK_LR and the main path's other settings, PAPER_STEPS
    outer steps with an eval after each, through run_training and both
    kernels.  Per size: N equal to specs.param_count, PAPER_STEPS DSM and
    PAPER_STEPS * tau AdamW launches, finite losses, the last eval below the
    first, the peak (reset, cache emptied before each size) under the card's
    memory; each kernel timed at that N on the trained state's buffers
    beside its byte bound; one local step's host time and device busy time.
    Returns (launches, gpt2_large's trained x0)."""
    from repro_torch.configs import load_arch, specs
    from repro_torch.train.trainer import TrainSettings, run_training

    corpus = training_corpus()
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures, kept = [], [], None
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    for arch, layers, n_want in PAPER_SIZES:
        mod = load_arch(arch)
        cfg = depth_cut(arch, layers)
        n = specs.param_count(cfg)
        if n != n_want:
            raise AssertionError(f"{arch}: specs.param_count {n}, want {n_want}")
        s = TrainSettings(tau=mod.TOPO.tau, steps=PAPER_STEPS, eval_every=1,
                          **{**MAIN, "peak_lr": mod.PEAK_LR})
        kept = None                 # gpt2_medium's x0 goes before gpt2_large starts
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        res = run_training(cfg, s, corpus, device="cuda", params=card_init(torch, cfg))
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_peak(arch, peak, cfg, s)
        state = res.pop("state")
        hist, evals, step_s = res["history"], [e for _, e in res["eval_losses"]], res[
            "outer_step_s"]
        del res
        kept = state.x0.clone()     # the trained x0 (the timings below overwrite the state)
        w = s.n_workers
        p, g, mm, v = state.params, state.grads, state.base_state.m, state.base_state.v
        adamw = {"elements": w * n,
                 "ms": median_ms(torch, lambda: K.adamw_update(p, g, mm, v, 1e-5, 11,
                                                               **ADAMW_HP))}
        adamw["bound_ms"], adamw["bound_by"] = bound_ms(w * n * 22, w * n * 16)
        dsm = {"elements": n, "ms": median_ms(torch, lambda: K.dsm_update(
            state.x0, state.m, p[0], 1e-5, **DSM_HP))}
        dsm["bound_ms"], dsm["bound_by"] = bound_ms(n * 14, n * 12)
        breakdown = local_step_breakdown(torch, cfg, state, corpus, s)
        del state, p, g, mm, v
        step_ms = statistics.median(step_s[1:]) * 1e3
        tokens_per_step = s.n_workers * s.tau * s.b_micro * s.seq
        rows.append({"config": cfg.name, "n_params": n, "n_layers": cfg.n_layers,
                     "d_model": cfg.d_model, "padded_vocab": cfg.padded_vocab,
                     "param_dtype": cfg.param_dtype, "peak_lr": s.peak_lr,
                     "global_lr": s.global_lr, "history": hist, "evals": evals,
                     "outer_step_ms": [t * 1e3 for t in step_s],
                     "outer_step_ms_median_steps_2_3": step_ms,
                     "tokens_per_outer_step": tokens_per_step,
                     "tokens_per_s": tokens_per_step / (step_ms / 1e3),
                     "max_memory_allocated_bytes": peak, "launches": launches,
                     "adamw_update": adamw, "dsm_update": dsm, "local_step": breakdown})
        want = {"dsm_update": s.steps, "adamw_update": s.steps * s.tau}
        if launches != want:
            failures.append(f"{arch}: launch counts {launches}, want {want}")
        if not all(math.isfinite(x) for x in hist + evals):
            failures.append(f"{arch}: non-finite loss {hist}, evals {evals}")
        elif not evals[-1] < evals[0]:
            failures.append(f"{arch}: eval loss did not fall: {evals}")
        if not peak < card_bytes:
            failures.append(f"{arch}: peak {peak} B of the card's {card_bytes}")
        for k in total:
            total[k] += launches[k]
    emit({"phase": "paper_sizes_full_width", "gpu": smi, "n_workers": MAIN["n_workers"],
          "tau": s.tau, "b_micro": MAIN["b_micro"], "seq": MAIN["seq"],
          "outer_steps": PAPER_STEPS, "card_bytes": card_bytes, "sizes": rows})
    if failures:
        raise AssertionError("paper_sizes_full_width: " + "; ".join(failures))
    return total, kept


def adamw_vs_plain_chunked(torch, K, p, g, m, v) -> float:
    """The AdamW kernel over the whole (p, g, m, v) (the training path's
    rounding), then its plain version slice by slice on saved copies of p,
    m and v, so the check fits the card beside the buffers; the worst
    |error| (``compare`` raises on any bit that differs)."""
    from repro_torch.kernels.adamw_update import adamw_update_plain

    flat = [t.view(-1) for t in (p, g, m, v)]
    saved = [t.clone() for t in (flat[0], flat[2], flat[3])]
    K.adamw_update(p, g, m, v, 1e-3, 11, **ADAMW_HP)
    worst = 0.0
    for a in range(0, flat[0].numel(), PAST_2G_CHUNK):
        b = min(a + PAST_2G_CHUNK, flat[0].numel())
        ref = [t[a:b] for t in saved]
        adamw_update_plain(ref[0], flat[1][a:b], ref[1], ref[2], 1e-3, 11, **ADAMW_HP)
        worst = max(worst, compare(torch, [flat[0][a:b], flat[2][a:b], flat[3][a:b]], ref))
    return worst


def phase_kernels_past_2g(torch, K):
    """The AdamW kernel bit for bit against its plain version (bf16 params,
    f32 moments, the training path's rounding) on one (2, 2^30 + RAGGED)
    buffer, 2^31 + 2 * RAGGED elements: past the int32 range, with a vector
    tail of (2^30 + RAGGED) * 2 mod 8 elements.  Zeros, -0 and NaN are
    planted in g and p at offsets just below and above 2^31 (and the last
    element).  The plain version runs slice by slice on saved copies of the
    inputs, so the check fits the card; everything is freed after."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(2)
    p, g, m, v = adamw_inputs(torch, gen, PAST_2G_SHAPE, torch.bfloat16)
    n = p.numel()
    flat = [t.view(-1) for t in (p, g, m, v)]
    planted = [INT32_EDGE - 2, INT32_EDGE - 1, INT32_EDGE, INT32_EDGE + 1, n - 1]
    for off, (pv, gv) in zip(planted, ((-0.0, 0.0), (1.0, float("nan")), (0.0, -0.0),
                                       (-1.0, float("nan")), (0.5, 0.0))):
        flat[0][off], flat[1][off] = pv, gv
    worst = adamw_vs_plain_chunked(torch, K, p, g, m, v)
    at = {str(off): {"p": flat[0][off].item(), "m": flat[2][off].item(),
                     "v": flat[3][off].item()} for off in planted}
    # timed after the check, on the updated buffers (median of 5 launches)
    ms = median_ms(torch, lambda: K.adamw_update(p, g, m, v, 1e-3, 11, **ADAMW_HP), reps=5,
                   warmup=1)
    del p, g, m, v, flat
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    emit({"phase": "kernels_past_2g", "kernel": "adamw_update", "shape": list(PAST_2G_SHAPE),
          "elements": n, "past_int32_by": n - INT32_EDGE, "dtype": "torch.bfloat16",
          "round_direction": True, "tolerance": "bitwise (atol 0, rtol 0), NaN where NaN",
          "max_abs_err": worst, "ms": ms, "bound_ms": bound_ms(n * 22, n * 16)[0],
          "max_memory_allocated_bytes": peak, "planted": at})
    if not (math.isnan(at[str(INT32_EDGE + 1)]["p"]) and at[str(INT32_EDGE)]["p"] != 0.0):
        raise AssertionError(f"kernels_past_2g: planted values {at}")


def phase_archs_card_vs_cpu(torch, K, pool):
    """The SMOKE configs of ARCH_SMOKES (f32: GQA, MQA, gated SiLU, untied
    heads): card_vs_cpu_runs."""
    from repro_torch.configs import load_arch

    return card_vs_cpu_runs(torch, K, pool, "archs_card_vs_cpu",
                            [(load_arch(a).SMOKE, load_arch(a).TOPO) for a in ARCH_SMOKES])


def card_vs_cpu_runs(torch, K, pool, phase, configs, serve=False):
    """Each (cfg, TOPO) of ``configs``, the same init and batches on the card
    (kernels) and the CPU (plain versions): ARCH_STEPS DSM outer steps with
    TOPO.base_opt and TOPO.tau, microbatches of ARCH_BATCH, the main path's
    other settings.  Each train loss within NANO_RTOL; the launches of
    expected_launches per dtype group.  With ``serve``, generate's
    SERVE_NEW greedy tokens from the same init on both devices equal.
    Every line is printed before any bound is checked."""
    import numpy as np

    from repro_torch.groups import each
    from repro_torch.models import transformer as T
    from repro_torch.train.serve import generate
    from repro_torch.train.trainer import TrainSettings, run_training

    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures = [], []
    jobs = []
    for cfg, topo in configs:
        s = TrainSettings(tau=topo.tau, steps=ARCH_STEPS, eval_every=ARCH_STEPS,
                          base_opt=topo.base_opt, **{**MAIN, **ARCH_BATCH})
        x0 = shared(T.init_params(torch.Generator().manual_seed(0), cfg))
        jobs.append((cfg, s, x0, pool.submit(cpu_run, cfg, s, x0)))
    for cfg, s, x0, cpu in jobs:
        K.reset_launch_counts()
        card = run_training(cfg, s, device="cuda", params=x0)["history"]
        launches = K.launch_counts()
        cpu = cpu.result(timeout=CPU_RUN_TIMEOUT_S)["history"]
        rel = history_rel(card, cpu)
        groups = T.layout(cfg).n_groups
        row = {"config": cfg.name, "param_dtype": cfg.param_dtype, "groups": groups,
               "base_opt": s.base_opt, "tau": s.tau, "b_micro": s.b_micro, "seq": s.seq,
               "card": card, "cpu": cpu, "max_rel_diff": rel, "launches": launches,
               "launches_per_group": {k: n / groups for k, n in launches.items()}}
        want = expected_launches(s, groups)
        if launches != want:
            failures.append(f"{cfg.name}: launch counts {launches}, want {want}")
        if not rel <= NANO_RTOL:
            failures.append(f"{cfg.name}: card and CPU differ by {rel}")
        if serve:
            prompt = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size,
                                                                       (4, 24)))
            toks = {dev: generate(each(lambda t: t.to(dev), x0), cfg, prompt,
                                  max_new_tokens=SERVE_NEW, device=dev)[0].cpu()
                    for dev in ("cuda", "cpu")}
            row["generate_tokens_equal"] = torch.equal(toks["cuda"], toks["cpu"])
            if not row["generate_tokens_equal"]:
                failures.append(f"{cfg.name}: generate's tokens differ on card and CPU")
        rows.append(row)
        for k in total:
            total[k] += launches[k]
    emit({"phase": phase, "outer_steps": ARCH_STEPS, "rtol": NANO_RTOL, "runs": rows})
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    return total


class RouteLog:
    """While active, records the top-k experts (sorted) of the last position
    of every ``layers.moe_apply`` call, recomputed from the call's own
    inputs by the same f32 routing ops: per MoE layer, (B, K); with
    ``every_position``, those of every token, (B * S, K)."""

    def __init__(self, torch, every_position=False):
        self.torch, self.calls, self.every_position = torch, [], every_position

    def __enter__(self):
        from repro_torch.models import layers as L

        torch, orig = self.torch, L.moe_apply

        def recorded(p, x, cfg, **kw):
            xt = x.reshape(-1, x.shape[-1]).to(torch.float32)
            probs = torch.softmax(xt @ p["router"].to(torch.float32), dim=-1)
            top = torch.topk(probs, cfg.top_k, dim=-1).indices.sort(dim=-1).values
            self.calls.append(top if self.every_position
                              else top.reshape(x.shape[0], x.shape[1], -1)[:, -1])
            return orig(p, x, cfg, **kw)

        self.restore = lambda: setattr(L, "moe_apply", orig)
        L.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self.restore()

    def take(self) -> list:
        out, self.calls = self.calls, []
        return out


def forced_steps(torch, params, cfg, prompt, toks, extra=None):
    """Each generate step's logits along ``toks`` (B, new), as generate runs
    them (call under ``torch.no_grad``): prefill's, then decode_step fed
    ``toks[:, i - 1]`` on the spliced cache.  ``extra``: the batch's frames
    or patches; a VLM's patches come before the prompt, so its decode
    positions start after them."""
    from repro_torch.models import transformer as T
    from repro_torch.train.serve import _splice_cache

    extra = extra or {}
    B, S = prompt.shape
    n0 = S + (extra["patches"].shape[1] if "patches" in extra else 0)
    logits, small = T.prefill(params, {"tokens": prompt, **extra}, cfg, remat=False)
    cache = _splice_cache(T.init_cache(cfg, B, n0 + toks.shape[1], device=prompt.device),
                          small, cfg, n0)
    del small
    for i in range(toks.shape[1]):
        if i:
            logits, cache = T.decode_step(params, cache, toks[:, i - 1], n0 + i - 1, cfg)
        yield logits


def teacher_forced(torch, params, cfg, prompt, toks, extra=None):
    """Every decode step's logits (:func:`forced_steps`) beside a full
    forward over prompt + toks[:, :i] at its last position; rows of
    (decode, full) f32 logits and a (B,) bool: the row's experts equal in
    both at every MoE layer (all True without one).  A model with a
    recurrent layer takes one full forward over prompt + toks and reads
    each step's position from it (causal: a position sees nothing after
    it), its tokens padded on the right to a multiple of the SSD's
    128-position chunk where Mamba-2 needs one: one forward in place of one
    per step, at lengths the SSD accepts."""
    from repro_torch.models import transformer as T

    extra = extra or {}
    B = prompt.shape[0]
    recurrent = [k.split(":")[0] for k in cfg.pattern if k.split(":")[0] in T.RECURRENT]
    out = []
    with torch.no_grad(), RouteLog(torch) as log:
        decoded = []
        for i, logits in enumerate(forced_steps(torch, params, cfg, prompt, toks, extra)):
            if recurrent:
                decoded.append(logits.clone())
                continue
            dec_routes = log.take()
            seq = torch.cat([prompt, toks[:, :i]], dim=1)
            h = T.hidden_states(params, {"tokens": seq, **extra}, cfg, remat=False)[0][:, -1:]
            same = torch.ones(B, dtype=torch.bool, device=prompt.device)
            for a, b in zip(dec_routes, log.take(), strict=True):
                same &= (a == b).all(dim=-1)
            out.append((logits.clone(), T._logits(params, h, cfg)[:, 0], same))
        if recurrent:
            full = one_pass_logits(torch, params, cfg, prompt, toks, extra)
            every = torch.ones(B, dtype=torch.bool, device=prompt.device)
            out = [(dec, full[:, i], every) for i, dec in enumerate(decoded)]
    return out


def one_pass_logits(torch, params, cfg, prompt, toks, extra=None):
    """The full forward's f32 logits (B, new, padded vocab) at the positions
    that predict each of ``toks`` (B, new), from ONE forward over prompt +
    toks (causal: a position sees nothing after it); the tokens padded on
    the right to a multiple of the SSD's 128-position chunk where a Mamba-2
    layer needs one."""
    from repro_torch.models import transformer as T

    extra = extra or {}
    B, S = prompt.shape
    n0 = S + (extra["patches"].shape[1] if "patches" in extra else 0)
    seq = torch.cat([prompt, toks], dim=1)
    ssm = any(k.startswith("ssm:") for k in cfg.pattern)
    pad = (-seq.shape[1]) % 128 if ssm and seq.shape[1] > 128 else 0
    seq = torch.cat([seq, seq.new_zeros(B, pad)], dim=1)
    with torch.no_grad():
        h = T.hidden_states(params, {"tokens": seq, **extra}, cfg, remat=False)[0]
        return T._logits(params, h[:, n0 - 1:n0 - 1 + toks.shape[1]], cfg)


def routed_run(torch, cfg, settings, device, x0) -> tuple:
    """``run_training`` under :class:`RouteLog` (every position): its result
    and, per outer round, the sorted top-k experts of every token of every
    MoE layer call of the round, on the host (none without a MoE layer)."""
    from repro_torch.train.trainer import run_training

    rounds = []
    with RouteLog(torch, every_position=True) as log:
        res = run_training(cfg, settings, device=device, params=x0, on_round=lambda *_: (
            rounds.append([r.cpu() for r in log.take()])))
    return res, rounds


def other_routes(a: list, b: list) -> list:
    """Per outer round, the tokens whose top-k experts differ between two
    runs' :func:`routed_run` routes (the same calls in the same order)."""
    return [sum(int((x != y).any(dim=-1).sum()) for x, y in zip(ra, rb, strict=True))
            for ra, rb in zip(a, b, strict=True)]


def route_rtols(other: list) -> list:
    """Each outer round's card-vs-CPU loss bound: NANO_RTOL up to the first
    round whose MoE routes differ between the two devices, SIGN_LIKE_RTOL
    from it on (a token sent to another expert changes its loss and its
    gradient, and DSM's sign turns the moved coordinates into 2 * eta *
    gamma steps)."""
    first = next((t for t, n in enumerate(other) if n), len(other))
    return [NANO_RTOL if t < first else SIGN_LIKE_RTOL for t in range(len(other))]


def route_checked(rows, atol) -> dict:
    """Decode vs full forward: per step the largest |logit gap| over all
    rows and over the rows whose experts agree at every MoE layer; the rows
    whose routes differ and their largest gap; ``ok`` when every row of
    equal routes is within ``atol``."""
    every, same, flipped, flipped_err = [], [], 0, 0.0
    for dec, full, agree in rows:
        gap = (dec - full).abs().amax(dim=-1)
        every.append(gap.max().item())
        same.append(gap[agree].max().item() if agree.any() else 0.0)
        flipped += int((~agree).sum())
        if not agree.all():
            flipped_err = max(flipped_err, gap[~agree].max().item())
    return {"max_abs_err": max(every), "per_step_err": every,
            "same_routes_max_abs_err": max(same), "rows_other_routes": flipped,
            "other_routes_max_abs_err": flipped_err, "ok": max(same) <= atol}


def phase_serve_full_width(torch, smi, x0):
    """generate on gpt2_large's trained x0 (bf16, full width, PAPER_SIZES'
    layers): SERVE_BATCH prompts of SERVE_PROMPT corpus tokens, SERVE_NEW
    greedy tokens (serve_check)."""
    arch, layers, _ = PAPER_SIZES[1]
    serve_check(torch, smi, "serve_full_width", depth_cut(arch, layers), x0, SERVE_BATCH,
                SERVE_PROMPT, SERVE_NEW)


def serve_check(torch, smi, phase, cfg, x0, batch, prompt_len, new, extra=None,
                per_add_bound=False, noise_bound=False) -> None:
    """generate on the trained ``x0`` (cfg's flat buffers, bf16): ``batch``
    prompts of ``prompt_len`` corpus tokens, ``new`` greedy tokens (with
    ``extra``, the batch's frames or patches, as ``extra_batch``); prefill
    seconds, decode tokens/s and the peak.  Then, teacher-forced, each
    decode step's logits against the full forward within SERVE_ATOL (with
    ``per_add_bound``, within SERVE_ULP_PER_ADD of the largest logit per
    residual add where that is larger; with ``per_add_bound="only"``, that
    bound alone) on the rows whose experts agree
    (``route_checked``: every row of a dense model), and generate's token
    equal to the full forward's argmax wherever its top-2 margin exceeds
    that bound.  With ``noise_bound`` the bf16 decode is held instead
    against the f32 model's full forward (one pass, every step), within
    SERVE_NOISE_FACTOR times the bf16 full forward's own largest distance
    to it; a token is decided where the bf16 full forward's top-2 margin
    exceeds SERVE_NOISE_FACTOR times its distance at that step.  The same
    teacher-forced check with every leaf in f32 (activations f32), within
    SERVE_F32_ATOL, over the first SERVE_F32_STEPS tokens of a dense model
    and every token of a MoE one."""
    import dataclasses

    import numpy as np

    from repro_torch.models import transformer as T
    from repro_torch.train.serve import generate

    corpus = training_corpus()
    prompt = torch.as_tensor(corpus.sample(np.random.default_rng(7), batch, prompt_len),
                             dtype=torch.long, device="cuda")
    params = T.layout(cfg).views(x0)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    generate(params, cfg, prompt, max_new_tokens=2, extra_batch=extra, device="cuda")  # warm-up
    toks, stats = generate(params, cfg, prompt, max_new_tokens=new, extra_batch=extra,
                           device="cuda")
    peak = torch.cuda.max_memory_allocated()
    rows = teacher_forced(torch, params, cfg, prompt, toks, extra)
    top = max(full.abs().max().item() for _, full, _ in rows)
    per_add = 2 * cfg.n_layers * SERVE_ULP_PER_ADD * top
    atol = ((per_add if per_add_bound == "only" else max(SERVE_ATOL, per_add))
            if per_add_bound else SERVE_ATOL)
    bf16 = route_checked(rows, atol)
    cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
    params32 = {k: v.float() for k, v in params.items()}
    extra32 = {k: v.float() for k, v in extra.items()} if extra else None
    margins = [atol] * len(rows)
    noise = None
    if noise_bound:
        ref = one_pass_logits(torch, params32, cfg32, prompt, toks, extra32)
        full_err = [(full - ref[:, i]).abs().max().item() for i, (_, full, _) in enumerate(rows)]
        dec_err = [(dec - ref[:, i]).abs().max().item() for i, (dec, _, _) in enumerate(rows)]
        del ref
        margins = [SERVE_NOISE_FACTOR * e for e in full_err]
        noise = {"factor": SERVE_NOISE_FACTOR, "full_vs_f32_per_step": full_err,
                 "decode_vs_f32_per_step": dec_err,
                 "ratio": max(dec_err) / max(max(full_err), 1e-30),
                 "ok": max(dec_err) <= SERVE_NOISE_FACTOR * max(full_err)}
        bf16["ok"] = noise["ok"]
    decided, agree = 0, 0
    for i, (_, full, _) in enumerate(rows):
        lg = full[:, : cfg.vocab_size]
        top2 = torch.topk(lg, 2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > margins[i]
        decided += int(sure.sum())
        agree += int((sure & (lg.argmax(-1) == toks[:, i])).sum())
    del rows
    moe = any(k.endswith(":moe") for k in cfg.pattern)
    f32_steps = new if moe else SERVE_F32_STEPS
    rows = teacher_forced(torch, params32, cfg32, prompt, toks[:, :f32_steps], extra32)
    f32 = route_checked(rows, SERVE_F32_ATOL)
    del rows, params32
    row = {"phase": phase, "gpu": smi, "config": cfg.name, "n_layers": cfg.n_layers,
           "batch": batch, "prompt_tokens": prompt_len, "new_tokens": new,
           "extra_batch": {k: list(v.shape) for k, v in (extra or {}).items()},
           "prefill_s": stats["prefill_s"], "decode_s": stats["decode_s"],
           "decode_tok_per_s": stats["tok_per_s"], "max_memory_allocated_bytes": peak,
           "params_bytes": base, "atol": atol, "max_abs_logit": top,
           "decode_vs_full_max_abs_err": bf16["max_abs_err"], "bf16": bf16,
           "bf16_vs_f32_noise": noise, "tokens_decided": decided, "tokens_equal_where_decided": agree,
           "f32_atol": SERVE_F32_ATOL, "f32_steps": f32_steps,
           "f32_decode_vs_full_max_abs_err": f32["max_abs_err"], "f32": f32,
           "tokens": toks[0].tolist()}
    emit(row)
    if not (bf16["ok"] and agree == decided and decided > 0 and f32["ok"]):
        raise AssertionError(
            f"{phase}: decode vs full forward {bf16['same_routes_max_abs_err']} where the "
            f"routes agree (atol {atol}), bf16 against the f32 model {noise}, f32 "
            f"{f32['same_routes_max_abs_err']} (atol {SERVE_F32_ATOL}), {agree} of {decided} "
            "decided tokens equal")


def phase_serve_card_vs_cpu(torch):
    """Nano (f32), the same params and prompts: generate's greedy tokens
    equal on the card and the CPU, and every teacher-forced decode step's
    logits within SERVE_CPU_ATOL."""
    import numpy as np

    from repro_torch.configs.nano import NANO
    from repro_torch.models import transformer as T
    from repro_torch.train.serve import generate

    flat = T.init_params(torch.Generator().manual_seed(0), NANO)
    prompt = torch.as_tensor(np.random.default_rng(3).integers(0, NANO.vocab_size, (4, 24)))
    out = {}
    for dev in ("cuda", "cpu"):
        params = T.layout(NANO).views(flat.to(dev))
        toks, _ = generate(params, NANO, prompt, max_new_tokens=SERVE_NEW, device=dev)
        rows = teacher_forced(torch, params, NANO, prompt.to(dev), toks)
        out[dev] = (toks.cpu(), [d.cpu() for d, _, _ in rows])
    same = torch.equal(out["cuda"][0], out["cpu"][0])
    err = max((a - b).abs().max().item() for a, b in zip(out["cuda"][1], out["cpu"][1]))
    emit({"phase": "serve_card_vs_cpu", "config": NANO.name, "new_tokens": SERVE_NEW,
          "tokens_equal": same, "decode_logits_max_abs_diff": err, "atol": SERVE_CPU_ATOL})
    if not (same and err <= SERVE_CPU_ATOL):
        raise AssertionError(f"serve_card_vs_cpu: tokens equal {same}, logits differ by {err}")


def granite_cut(layers: int = GRANITE_LAYERS):
    """granite_moe_3b_a800m.FULL at full width and ``layers`` layers."""
    import dataclasses

    from repro_torch.configs import granite_moe_3b_a800m

    return dataclasses.replace(granite_moe_3b_a800m.FULL, n_layers=layers,
                               name=f"granite_moe_3b_a800m_{layers}l")


def window_moe_paths():
    """(cfg, settings, N per dtype group) of the sliding-window and MoE
    training paths."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.train.trainer import TrainSettings

    common = dict(tau=12, steps=WINDOW_MOE_STEPS, eval_every=1, eval_batch=WINDOW_MOE_EVAL_BATCH,
                  peak_lr=MAIN["peak_lr"], global_lr=MAIN["global_lr"])
    return [(gemma3_1b.FULL, TrainSettings(**common, **GEMMA), GEMMA_N),
            (granite_cut(), TrainSettings(**common, **{k: MAIN[k] for k in (
                "n_workers", "b_micro", "seq")}), GRANITE_N)]


def phase_group_kernel_checks(torch, K, phase="group_kernel_checks", paths=None):
    """Both kernels bit for bit against their plain versions at the shapes
    of ``paths`` ((cfg, settings) pairs; by default the sliding-window and
    MoE paths, granite at GRANITE_CHECK_LAYERS), group by group: the DSM step over each group's (n,), the
    AdamW step over each group's (W, n) (the plain version slice by slice
    where the buffers are large); random inputs, 0 / -0 / NaN planted in
    the DSM inputs."""
    from repro_torch.kernels.dsm_update import dsm_update_plain
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(4)
    cases = []
    default = [(granite_cut(GRANITE_CHECK_LAYERS) if cfg.n_experts else cfg, s)
               for cfg, s, _ in window_moe_paths()]
    for cfg, s in paths or default:
        lay = T.layout(cfg)
        for dtype, n in zip(lay.dtypes, lay.group_numels):
            torch.cuda.empty_cache()
            x0, m, xt = dsm_inputs(torch, gen, n, dtype)
            ka = (x0.clone(), m.clone())
            K.dsm_update(ka[0], ka[1], xt, 0.02, **DSM_HP)
            dsm_update_plain(x0, m, xt, 0.02, **DSM_HP)
            cases.append({"kernel": "dsm_update", "config": cfg.name, "shape": [n],
                          "dtype": str(dtype), "max_abs_err": compare(torch, ka, (x0, m))})
            del x0, m, xt, ka
            torch.cuda.empty_cache()
            p, g, mm, v = adamw_inputs(torch, gen, (s.n_workers, n), dtype)
            cases.append({"kernel": "adamw_update", "config": cfg.name,
                          "shape": [s.n_workers, n], "dtype": str(dtype),
                          "max_abs_err": adamw_vs_plain_chunked(torch, K, p, g, mm, v)})
            del p, g, mm, v
    torch.cuda.empty_cache()
    emit({"phase": phase, "tolerance": "bitwise (atol 0, rtol 0), NaN where NaN",
          "cases": cases})
    return {name: max(c["max_abs_err"] for c in cases if c["kernel"] == name)
            for name in ("dsm_update", "adamw_update")}


def phase_window_moe_full_width(torch, K, smi, phase="window_moe_full_width", paths=None,
                                keep=()):
    """Each (cfg, settings, N per dtype group[, initial params]) of
    ``paths`` through run_training and both kernels, an eval after each
    outer step; by
    default the sliding-window and MoE paths: gemma3_1b.FULL (whole depth,
    W=2, S=1024) and granite_moe_3b_a800m at full width and GRANITE_LAYERS
    layers (W=4, S=128), tau=12, WINDOW_MOE_STEPS outer steps.  Per path: N
    per dtype group as listed, one DSM launch per group per round and tau
    AdamW launches per group per round, finite losses, the last eval below
    the first, the peak under the card's memory; each kernel timed per
    group on the trained state's buffers beside its byte bound; one local
    step's host and device time.  Returns (launches, [(cfg, trained
    x0)], {name: history and x0 / m per group on the host} for the configs
    named in ``keep``)."""
    from repro_torch.groups import each, parts, pick
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import run_training

    corpus = training_corpus()
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures, trained, finals = [], [], [], {}
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    paths = paths or window_moe_paths()
    for cfg, s, n_want, *init in paths:
        lay = T.layout(cfg)
        if lay.group_numels != n_want:
            raise AssertionError(f"{cfg.name}: groups of {lay.group_numels}, want {n_want}")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        res = run_training(cfg, s, corpus, device="cuda", params=init[0] if init else None)
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        expect_peak(cfg.name, peak, cfg, s, held=sum(card_bytes_of(x) for _, x in trained))
        state = res.pop("state")
        hist, evals, step_s = res["history"], [e for _, e in res["eval_losses"]], res[
            "outer_step_s"]
        del res
        trained.append((cfg, each(torch.clone, state.x0)))
        if cfg.name in keep:
            finals[cfg.name] = dense_final(torch, {"history": hist, "state": state})
        kernels = []
        for i, (dtype, n) in enumerate(zip(lay.dtypes, lay.group_numels)):
            es, w = dtype.itemsize, s.n_workers
            p, g = pick(state.params, i), pick(state.grads, i)
            mm, v = pick(state.base_state.m, i), pick(state.base_state.v, i)
            row = {"dtype": str(dtype), "elements": n,
                   "adamw_ms": median_ms(torch, lambda: K.adamw_update(p, g, mm, v, 1e-5, 11,
                                                                       **ADAMW_HP)),
                   "dsm_ms": median_ms(torch, lambda: K.dsm_update(
                       pick(state.x0, i), pick(state.m, i), p[0], 1e-5, **DSM_HP))}
            row["adamw_bound_ms"] = bound_ms(w * n * (3 * es + 16), w * n * 16)[0]
            row["dsm_bound_ms"] = bound_ms(n * (3 * es + 8), n * 12)[0]
            kernels.append(row)
        breakdown = local_step_breakdown(torch, cfg, state, corpus, s)
        del state, p, g, mm, v
        step_ms = statistics.median(step_s[1:]) * 1e3
        tokens_per_step = s.n_workers * s.tau * s.b_micro * s.seq
        rows.append({"config": cfg.name, "n_params": lay.numel, "n_layers": cfg.n_layers,
                     "groups": [[str(d), n] for d, n in zip(lay.dtypes, lay.group_numels)],
                     "n_workers": s.n_workers, "tau": s.tau, "b_micro": s.b_micro,
                     "seq": s.seq, "peak_lr": s.peak_lr, "global_lr": s.global_lr,
                     "outer_steps": s.steps, "history": hist, "evals": evals,
                     "outer_step_ms": [t * 1e3 for t in step_s],
                     "outer_step_ms_median_after_first": step_ms,
                     "tokens_per_outer_step": tokens_per_step,
                     "tokens_per_s": tokens_per_step / (step_ms / 1e3),
                     "max_memory_allocated_bytes": peak, "launches": launches,
                     "launches_per_group": {k: n / lay.n_groups for k, n in launches.items()},
                     "kernels_per_group": kernels, "local_step": breakdown})
        want = expected_launches(s, lay.n_groups)
        if launches != want:
            failures.append(f"{cfg.name}: launch counts {launches}, want {want}")
        if not all(math.isfinite(x) for x in hist + evals):
            failures.append(f"{cfg.name}: non-finite loss {hist}, evals {evals}")
        elif not evals[-1] < evals[0]:
            failures.append(f"{cfg.name}: eval loss did not fall: {evals}")
        if not peak < card_bytes:
            failures.append(f"{cfg.name}: peak {peak} B of the card's {card_bytes}")
        if not all(t.dtype == d for t, d in zip(parts(trained[-1][1]), lay.dtypes)):
            failures.append(f"{cfg.name}: x0 groups of dtypes other than {lay.dtypes}")
        for k in total:
            total[k] += launches[k]
    emit({"phase": phase, "gpu": smi, "outer_steps": paths[0][1].steps,
          "card_bytes": card_bytes, "paths": rows})
    if failures:
        raise AssertionError(f"{phase}: " + "; ".join(failures))
    return total, trained, finals


def window_moe_phases(torch, K, smi, pool) -> tuple:
    """The phases of sliding-window attention and MoE, then those of
    mixed-dtype models over ranks (mixed_ranks_phases, which hold granite's
    run over ranks against its dense run here); returns (their runs'
    launches, the group kernel checks' worst errors)."""
    import dataclasses

    from repro_torch.configs import granite_moe_3b_a800m, load_arch

    errs = phase_group_kernel_checks(torch, K)
    paths = window_moe_paths()
    paths[0] = (*paths[0], card_init(torch, paths[0][0]))      # gemma3's init
    total, trained, finals = phase_window_moe_full_width(torch, K, smi, paths=paths,
                                                         keep=(granite_cut().name,))
    for (cfg, x0), (b, prompt, new), phase in zip(trained, (SERVE_SWA, SERVE_MOE),
                                                   ("serve_swa_full_width",
                                                    "serve_moe_full_width")):
        serve_check(torch, smi, phase, cfg, x0, b, prompt, new)
    del trained, x0
    torch.cuda.empty_cache()
    # granite's SMOKE with bf16 parameters (activations f32, as the SMOKE's):
    # two dtype groups, the routers f32
    bf16p = dataclasses.replace(granite_moe_3b_a800m.SMOKE, param_dtype="bfloat16",
                                name="granite_moe_smoke_bf16_params")
    configs = [(load_arch(a).SMOKE, load_arch(a).TOPO) for a in WINDOW_MOE_SMOKES]
    configs.append((bf16p, granite_moe_3b_a800m.TOPO))
    more = card_vs_cpu_runs(torch, K, pool, "window_moe_card_vs_cpu", configs, serve=True)
    total = {k: n + more[k] for k, n in total.items()}
    more = mixed_ranks_phases(torch, K, smi, finals[granite_cut().name])
    return {k: n + more[k] for k, n in total.items()}, errs


def mixed_smokes() -> list:
    """The SMOKE configs of MIXED_RANKS_SMOKES with bf16 parameters (f32
    activations, as the SMOKE's): two dtype groups each, granite's f32
    routers of 8 rows, recurrentgemma's f32 ``lam`` of one row (kept whole
    on every rank: ``zero.whole``)."""
    import dataclasses

    from repro_torch.configs import load_arch

    return [dataclasses.replace(load_arch(a).SMOKE, param_dtype="bfloat16",
                                name=f"{a}_smoke_bf16_params") for a in MIXED_RANKS_SMOKES]


def round_bytes_by_count(lay, world, tau) -> int:
    """One ZeRO round's bytes that a rank sends, counted from the layout: each
    dtype group's (1, chunk) rows to every owner and its chunk into the
    all-gather (a group kept whole gathers its mean's chunk instead), in the
    group's dtype; the (tau, 1) f32 losses; the seven f32 stat sums."""
    from repro_torch.distributed import zero
    from repro_torch.obs.metrics import N_STAT_SUMS

    chunks = [zero.chunk_size(n, world) * dt.itemsize
              for n, dt in zip(lay.group_numels, lay.dtypes)]
    return sum((world + 1) * c for c in chunks) + tau * 4 + N_STAT_SUMS * 4


def phase_mixed_zero_full_width(torch, K, smi, dense):
    """granite_moe at full width and GRANITE_LAYERS layers (bf16 blocks and
    f32 routers: two dtype groups) with window_moe_full_width's settings, as
    RANKS gloo processes sharing the card, one worker each, zero_sharded and
    device_parallel_local: each group scattered, sharded, updated and
    gathered on its own.  The history and x0 and m of both groups bit-equal
    to window_moe_full_width's granite run (``dense``: its history and x0 /
    m per group on the host), from the same init and corpus.  Per rank: one
    DSM launch per group and round, tau AdamW launches per group and round;
    DSM elements per group; peak bytes; outer-step ms; collective bytes and
    ms per round, the bytes equal to round_bytes_by_count.  No run
    directory: its post-run probe would clone the state (~7.5 GB more per
    rank, past the card at four ranks) and run 8 more rounds; the comm
    ledger is held against CommStats on two groups in
    mixed_ranks_card_vs_cpu.  The DSM kernel timed on one rank's shard of
    each group and the AdamW kernel on one rank's (1, n) row of each group,
    beside their byte bounds."""
    import dataclasses

    from repro_torch.distributed import mesh, zero
    from repro_torch.models import transformer as T

    cfg, s, n_want = window_moe_paths()[1]
    s = dataclasses.replace(s, zero_sharded=True, device_parallel_local=True)
    lay = T.layout(cfg)
    if lay.group_numels != n_want:
        raise AssertionError(f"{cfg.name}: groups of {lay.group_numels}, want {n_want}")
    corpus = training_corpus()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks(RANKS, cfg, [s], "cuda", corpus=corpus, fields=("x0", "m"))[0]
    wall = time.perf_counter() - t0
    ours = rank_final(ranks[0])
    same = bit_equal(torch, ours, dense)
    expect_peak(f"{cfg.name} rank 0 of {RANKS}", ranks[0]["peak_bytes"], cfg, s, world=RANKS)
    topos = [mesh.Topology(s.n_workers, RANKS, 1, r) for r in range(RANKS)]
    elements = [[b - a for a, b in (zero.my_bounds(n, t) for t in topos)]
                for n in lay.group_numels]
    per_round = round_bytes_by_count(lay, RANKS, s.tau)
    shard_kernels = []
    gen = torch.Generator(device="cuda").manual_seed(6)
    for dt, n, n_el in zip(lay.dtypes, lay.group_numels, (e[0] for e in elements)):
        x0 = torch.randn(n_el, generator=gen, device="cuda").to(dt)
        m = torch.randn(n_el, generator=gen, device="cuda")
        xt = (x0.float() - 0.01 * torch.randn(n_el, generator=gen, device="cuda")).to(dt)
        es = dt.itemsize
        row = {"dtype": str(dt), "shard_elements": n_el,
               "dsm_ms": median_ms(torch, lambda: K.dsm_update(x0, m, xt, 1e-5, **DSM_HP)),
               "dsm_bound_ms": bound_ms(n_el * (3 * es + 8), n_el * 12)[0]}
        del x0, m, xt
        # the rank's AdamW launch: its one worker's row of the whole group
        pp, g, mm, v = adamw_inputs(torch, gen, (1, n), dt)
        row["adamw_ms"] = median_ms(torch, lambda: K.adamw_update(pp, g, mm, v, 1e-5, 11,
                                                                  **ADAMW_HP))
        row["adamw_bound_ms"] = bound_ms(n * (3 * es + 16), n * 16)[0]
        shard_kernels.append(row)
        del pp, g, mm, v
    torch.cuda.empty_cache()
    want = {"dsm_update": s.steps * lay.n_groups, "adamw_update": s.steps * s.tau * lay.n_groups}
    summary = ranks_summary(ranks, s.steps)
    emit({"phase": "mixed_zero_full_width", "gpu": smi, "config": cfg.name,
          "groups": [[str(d), n] for d, n in zip(lay.dtypes, lay.group_numels)],
          "ranks": RANKS, "backend": "gloo", "n_workers": s.n_workers, "tau": s.tau,
          "b_micro": s.b_micro, "seq": s.seq, "outer_steps": s.steps,
          "dsm_elements_per_rank_and_group": elements, "history": ours["history"],
          "dense_history": dense["history"], "bit_equal_to_dense": same,
          "max_gap": max_gap(torch, ours, dense), "final_eval": ranks[0]["final_eval"],
          "wall_s": wall, "round_bytes_by_count": per_round, "card_bytes": card_bytes,
          "peak_bytes_sum": sum(r["peak_bytes"] for r in ranks),
          "dsm_shard_kernels": shard_kernels, **summary})
    failures = []
    if not same:
        failures.append("not bit-equal to window_moe_full_width's dense granite run")
    if any(r["history"] != ours["history"] for r in ranks):
        failures.append("the ranks' histories differ")
    for r, got in enumerate(r["launches"] for r in ranks):
        if got != want:
            failures.append(f"rank {r}: launch counts {got}, want {want}")
    if any(b != per_round for b in summary["collective_bytes_per_round"]):
        failures.append(f"collective bytes per round {summary['collective_bytes_per_round']}, "
                        f"counted {per_round}")
    for r in ranks:
        calls = {k: r["comm"][k]["calls"] for k in ("scatter_rows", "all_gather_shards")}
        if calls != dict.fromkeys(calls, s.steps * lay.n_groups):
            failures.append(f"scatter / all-gather calls {calls}, want one per group and round")
    if failures:
        raise AssertionError("mixed_zero_full_width: " + "; ".join(failures))
    return {k: sum(r["launches"][k] for r in ranks) for k in want}


def phase_mixed_ranks_card_vs_cpu(torch, K):
    """The SMOKE configs of mixed_smokes (two dtype groups; recurrentgemma's
    f32 group kept whole), the hand-built fault plan with mask_nonfinite and
    guards, MIXED_RANKS_BATCH, RANKS gloo ranks on the card and on the CPU
    under both flags (checkpoints every 2 rounds) and, for MIXED_DP_SMOKES,
    under device_parallel_local alone (the replicated global step), every
    run of one device in one start of the ranks, the CPU's beside the
    card's.  The card ranks held against the dense run on the card bit for
    bit (history, x0 and m of both groups), the CPU ranks against the dense
    run on the CPU (each CPU rank runs it whole, one torch thread as the
    ranks), the card against the CPU with equal skipped rounds and each
    round's loss within route_rtols: NANO_RTOL until the first round whose
    MoE routes differ between the card's and the CPU's dense runs (both
    traced by routed_run, the CPU's again in this process), SIGN_LIKE_RTOL
    from it on; the step-2 checkpoint of the card ranks is resumed by one
    process (world 4 -> 1) and must end bit-equal to the dense run too.
    Launches per rank: one DSM per group and round, tau AdamW per group and
    round.  A one-round ZeRO run of each model on the card writes a run
    directory whose comm ledger must equal rank 0's CommStats."""
    import concurrent.futures

    from repro_torch.checkpoint import checkpoint as CK
    from repro_torch.models import transformer as T
    from repro_torch.obs.sinks import read_run
    from repro_torch.robustness.faults import FaultPlan, FaultSpec
    from repro_torch.train.trainer import TrainSettings, run_training

    cfgs = mixed_smokes()
    inits = [shared(T.init_params(torch.Generator().manual_seed(0), cfg)) for cfg in cfgs]
    rounds = len(FAULT_ROUNDS)
    kw = dict(steps=rounds, eval_every=rounds, faults=fault_plan(FaultPlan, FaultSpec),
              mask_nonfinite=True, guard_nonfinite=True, **{**MAIN, **MIXED_RANKS_BATCH})
    flag_sets = {"zero+dp": dict(zero_sharded=True, device_parallel_local=True),
                 "dp": dict(device_parallel_local=True)}
    ck = dict(checkpoint_every=2, checkpoint_keep=rounds)
    tmp_root = ROOT / "build"
    tmp_root.mkdir(exist_ok=True)
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures = [], []
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        def settings(device, i, name, flags):
            extra = ck if name == "zero+dp" else {}
            ckpt = {"checkpoint_dir": f"{d}/{device}{i}"} if extra else {}
            return TrainSettings(**kw, **flags, **extra, **ckpt)

        runs = [(i, name) for i in range(len(cfgs)) for name in flag_sets
                if name == "zero+dp" or MIXED_RANKS_SMOKES[i] in MIXED_DP_SMOKES]
        run_cfgs, run_inits = [cfgs[i] for i, _ in runs], [inits[i] for i, _ in runs]
        with concurrent.futures.ThreadPoolExecutor(1) as side:
            cpu = side.submit(run_ranks, RANKS, run_cfgs + cfgs,
                              [settings("cpu", i, n, flag_sets[n]) for i, n in runs]
                              + [TrainSettings(**kw)] * len(cfgs), "cpu", run_inits + inits,
                              fields=("x0", "m"))
            ledger_runs = [TrainSettings(**{**kw, "steps": 1, "eval_every": 1, "faults": None},
                                         **flag_sets["zero+dp"], run_dir=f"{d}/run{i}")
                           for i in range(len(cfgs))]
            card = run_ranks(RANKS, run_cfgs + cfgs,
                             [settings("card", i, n, flag_sets[n]) for i, n in runs]
                             + ledger_runs, "cuda", run_inits + inits, fields=("x0", "m"))
            cpu = cpu.result(timeout=CPU_RUN_TIMEOUT_S)
        for i, (cfg, x0) in enumerate(zip(cfgs, inits)):
            groups = T.layout(cfg).n_groups
            want = {"dsm_update": rounds * groups,
                    "adamw_update": rounds * kw["tau"] * groups}
            K.reset_launch_counts()
            dense, card_routes = routed_run(torch, cfg, TrainSettings(**kw), "cuda", x0)
            dense_launches = K.launch_counts()
            theirs = dense_final(torch, dense)
            cpu_dense = rank_final(cpu[len(runs) + i][0])
            routes = {"other_routes_per_round": [0] * rounds}
            if any(card_routes):
                # the CPU ranks' dense run again, here on their one thread, for its routes
                threads = torch.get_num_threads()
                torch.set_num_threads(1)
                try:
                    traced, cpu_routes = routed_run(torch, cfg, TrainSettings(**kw), "cpu", x0)
                finally:
                    torch.set_num_threads(threads)
                routes = {"other_routes_per_round": other_routes(card_routes, cpu_routes),
                          "tokens_per_round": [sum(r.shape[0] for r in c) for c in card_routes],
                          "cpu_run_is_cpu_dense": bit_equal(torch, dense_final(torch, traced),
                                                            cpu_dense)}
                if not routes["cpu_run_is_cpu_dense"]:
                    failures.append(f"{cfg.name}: the routed CPU run is not the ranks' dense one")
            rtols = route_rtols(routes["other_routes_per_round"])
            os.makedirs(f"{d}/resume{i}")
            for suffix in (".npz", ".json"):
                shutil.copy(CK.step_path(f"{d}/card{i}", 2) + suffix, f"{d}/resume{i}")
            K.reset_launch_counts()
            resumed = run_training(cfg, TrainSettings(
                checkpoint_dir=f"{d}/resume{i}", resume=True, **ck, **kw,
                **flag_sets["zero+dp"]), device="cuda", params=x0)
            resumed_launches = K.launch_counts()
            back = dense_final(torch, resumed)
            row = {"config": cfg.name, "groups": groups, "dense_card": dense["history"],
                   "dense_cpu": cpu_dense["history"], "rtol_per_round": rtols, **routes,
                   "dense_rel_diff_card_cpu_per_round": rel_per_round(dense["history"],
                                                                     cpu_dense["history"]),
                   "resumed_world1": resumed["history"],
                   "resumed_bit_equal_to_dense": bit_equal(torch, back, theirs),
                   "resumed_launches": resumed_launches, "flag_sets": {}}
            for j, (_, name) in enumerate(runs):
                if runs[j][0] != i:
                    continue
                ours = rank_final(card[j][0])
                rel = rel_per_round(card[j][0]["history"], cpu[j][0]["history"])
                row["flag_sets"][name] = {
                    "card": card[j][0]["history"], "cpu": cpu[j][0]["history"],
                    "max_rel_diff_card_cpu": max(rel), "bit_equal_to_dense": bit_equal(
                        torch, ours, theirs), "max_gap": max_gap(torch, ours, theirs),
                    "cpu_bit_equal_to_cpu_dense": bit_equal(
                        torch, rank_final(cpu[j][0]), cpu_dense),
                    "skipped_rounds": [card[j][0]["skipped_rounds"],
                                       cpu[j][0]["skipped_rounds"], dense["skipped_rounds"]],
                    "launches": [r["launches"] for r in card[j]]}
                fs = row["flag_sets"][name]
                if any(r > tol for r, tol in zip(rel, rtols, strict=True)):
                    failures.append(f"{cfg.name} {name}: card and CPU differ by {rel} per "
                                    f"round, bounds {rtols}")
                if not fs["cpu_bit_equal_to_cpu_dense"]:
                    failures.append(f"{cfg.name} {name}: CPU ranks differ from the CPU dense run")
                if len(set(fs["skipped_rounds"])) != 1:
                    failures.append(f"{cfg.name} {name}: skipped rounds {fs['skipped_rounds']}")
                if not fs["bit_equal_to_dense"]:
                    failures.append(f"{cfg.name} {name}: not bit-equal to the dense card run")
                if any(r["history"] != run[0]["history"] for run in (card[j], cpu[j])
                       for r in run):
                    failures.append(f"{cfg.name} {name}: the ranks' histories differ")
                for got in fs["launches"]:
                    if got != want:
                        failures.append(f"{cfg.name} {name}: launch counts {got}, want {want}")
                for r in card[j]:
                    for k in total:
                        total[k] += r["launches"][k]
            led_ranks = card[len(runs) + i]
            _, events, _ = read_run(f"{d}/run{i}")
            ledger = next((e for e in events if e["kind"] == "comm_ledger"), None)
            comm = {k: {"calls": v["calls"], "bytes": v["bytes"]}
                    for k, v in led_ranks[0]["comm"].items()}
            row["comm_ledger"] = ledger and {k: ledger[k] for k in ("observed", "predicted")}
            row["comm_ledger_equals_comm_stats"] = bool(ledger) and ledger["observed"][
                "by_kind"] == comm
            rows.append(row)
            if not row["comm_ledger_equals_comm_stats"]:
                failures.append(f"{cfg.name}: comm ledger {ledger and ledger['observed']}, "
                                f"CommStats {comm}")
            if not row["resumed_bit_equal_to_dense"]:
                failures.append(f"{cfg.name}: the resumed run is not bit-equal to the dense one")
            rest = rounds - 2
            if resumed_launches != {"dsm_update": rest * groups,
                                    "adamw_update": rest * kw["tau"] * groups}:
                failures.append(f"{cfg.name}: resumed launch counts {resumed_launches}")
            if dense_launches != want:
                failures.append(f"{cfg.name}: dense launch counts {dense_launches}")
            for ls in [dense_launches, resumed_launches] + [
                    {k: r["launches"][k] + (r["probe_launches"] or {}).get(k, 0)
                     for k in total} for r in led_ranks]:
                for k in total:
                    total[k] += ls[k]
    emit({"phase": "mixed_ranks_card_vs_cpu", "ranks": RANKS, "backend": "gloo",
          "outer_steps": rounds, **MIXED_RANKS_BATCH, "runs": rows})
    if failures:
        raise AssertionError("mixed_ranks_card_vs_cpu: " + "; ".join(failures))
    return total


def mixed_ranks_phases(torch, K, smi, granite_dense) -> dict:
    """The phases of mixed-dtype models over ranks: mixed_zero_full_width
    (granite over RANKS ranks, held against ``granite_dense``, the dense
    run's history and x0 / m per group) and mixed_ranks_card_vs_cpu; returns
    their runs' launches."""
    total = phase_mixed_zero_full_width(torch, K, smi, granite_dense)
    more = phase_mixed_ranks_card_vs_cpu(torch, K)
    return {k: n + more[k] for k, n in total.items()}


def whisper_cut():
    """whisper_large_v3.FULL at full width and ENCDEC_LAYERS encoder and
    decoder layers."""
    import dataclasses

    from repro_torch.configs import whisper_large_v3

    return dataclasses.replace(whisper_large_v3.FULL, n_layers=ENCDEC_LAYERS,
                               enc_layers=ENCDEC_LAYERS,
                               name=f"whisper_large_v3_{ENCDEC_LAYERS}+{ENCDEC_LAYERS}l")


def llava_cut():
    """llava_next_34b.FULL at full width and VLM_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import llava_next_34b

    return dataclasses.replace(llava_next_34b.FULL, n_layers=VLM_LAYERS,
                               name=f"llava_next_34b_{VLM_LAYERS}l")


def encdec_settings():
    from repro_torch.train.trainer import TrainSettings

    return TrainSettings(tau=12, steps=ENCDEC_STEPS, peak_lr=MAIN["peak_lr"],
                         global_lr=MAIN["global_lr"], **ENCDEC)


def frames_of(torch, gen, cfg, lead):
    """Stub frame embeddings (lead..., enc_len, d_model), f32 on the card."""
    return torch.randn(lead + (cfg.enc_len, cfg.d_model), generator=gen, device="cuda")


def phase_encdec_full_width(torch, K, smi):
    """whisper_cut() trained through make_dsm_step on batch dicts (tokens of
    the src/**/*.py corpus, seeded random frames), AdamW local steps, W=2,
    tau=12, B_micro=1, S=448, ENCDEC_STEPS outer steps, the trainer's
    schedule at MAIN's rates; an eval on a fixed held-out batch (its own
    frames) after each.  N = ENCDEC_N, one DSM launch and tau AdamW
    launches per round, finite losses, the last eval below the first, the
    peak under the card's memory; each kernel timed on the trained state's
    buffers beside its byte bound.  Returns (launches, cfg, trained x0)."""
    from repro_torch.core import DSMConfig, dsm_init, get_base_optimizer, make_dsm_step
    from repro_torch.core.schedules import cosine_with_warmup
    from repro_torch.data.pipeline import dsm_batches, eval_batch
    from repro_torch.models import transformer as T

    cfg, s = whisper_cut(), encdec_settings()
    lay = T.layout(cfg)
    if lay.numel != ENCDEC_N or lay.n_groups != 1:
        raise AssertionError(f"{cfg.name}: N {lay.numel} in {lay.n_groups} groups, "
                             f"want {ENCDEC_N} in one")
    corpus = training_corpus()
    card_bytes = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = get_base_optimizer("adamw")
    step = make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base,
                         DSMConfig(tau=s.tau, global_lr=s.global_lr),
                         cosine_with_warmup(s.peak_lr, s.steps, warmup_steps=s.warmup), lay)
    state = dsm_init(T.init_params(torch.Generator(device="cuda").manual_seed(s.seed), cfg,
                                   device="cuda"), base, s.n_workers)
    gen = torch.Generator(device="cuda").manual_seed(1)
    ev = {"tokens": torch.as_tensor(eval_batch(corpus, ENCDEC_EVAL_BATCH, s.seq)["tokens"],
                                    dtype=torch.long, device="cuda"),
          "frames": frames_of(torch, gen, cfg, (ENCDEC_EVAL_BATCH,))}

    def eval_loss() -> float:
        with torch.no_grad():
            return float(T.loss_fn(lay.views(state.x0), ev, cfg, remat=False))

    batches = dsm_batches(corpus, s.n_workers, s.tau, 1, s.b_micro, s.seq, seed=s.seed)
    hist, evals, step_s = [], [eval_loss()], []
    K.reset_launch_counts()
    for _ in range(s.steps):
        batch = {"tokens": torch.as_tensor(next(batches)["tokens"], dtype=torch.long,
                                           device="cuda"),
                 "frames": frames_of(torch, gen, cfg, (s.n_workers, s.tau, 1, s.b_micro))}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        del batch
        hist.append(metrics["loss"].item())
        evals.append(eval_loss())
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    expect_peak(cfg.name, peak, cfg, s, keep_x0=False, eval_batch=ENCDEC_EVAL_BATCH)
    x0 = state.x0.clone()
    n, w, es = ENCDEC_N, s.n_workers, cfg.p_dtype.itemsize
    kernels = {
        "adamw_ms": median_ms(torch, lambda: K.adamw_update(
            state.params, state.grads, state.base_state.m, state.base_state.v, 1e-5, 11,
            **ADAMW_HP)),
        "adamw_bound_ms": bound_ms(w * n * (3 * es + 16), w * n * 16)[0],
        "dsm_ms": median_ms(torch, lambda: K.dsm_update(state.x0, state.m, state.params[0],
                                                        1e-5, **DSM_HP)),
        "dsm_bound_ms": bound_ms(n * (3 * es + 8), n * 12)[0]}
    del state
    torch.cuda.empty_cache()
    step_ms = statistics.median(step_s[1:]) * 1e3
    tokens_per_step = s.n_workers * s.tau * s.b_micro * s.seq
    emit({"phase": "encdec_full_width", "gpu": smi, "config": cfg.name, "n_params": n,
          "n_layers": cfg.n_layers, "enc_layers": cfg.enc_layers, "enc_len": cfg.enc_len,
          "n_workers": w, "tau": s.tau, "b_micro": s.b_micro, "seq": s.seq,
          "peak_lr": s.peak_lr, "global_lr": s.global_lr, "history": hist,
          "eval_before": evals[0], "evals": evals[1:],
          "outer_step_ms": [t * 1e3 for t in step_s],
          "outer_step_ms_median_after_first": step_ms,
          "tokens_per_outer_step": tokens_per_step,
          "tokens_per_s": tokens_per_step / (step_ms / 1e3),
          "max_memory_allocated_bytes": peak, "card_bytes": card_bytes, "launches": launches,
          "kernels": kernels})
    failures = []
    want = expected_launches(s)
    if launches != want:
        failures.append(f"launch counts {launches}, want {want}")
    if not all(math.isfinite(x) for x in hist + evals):
        failures.append(f"non-finite loss {hist}, evals {evals}")
    elif not evals[-1] < evals[1]:
        failures.append(f"eval loss did not fall: {evals[1:]}")
    if not peak < card_bytes:
        failures.append(f"peak {peak} B of the card's {card_bytes}")
    if failures:
        raise AssertionError("encdec_full_width: " + "; ".join(failures))
    return launches, cfg, x0


def phase_serve_vlm_full_width(torch, smi):
    """llava_cut() from init_params on the card (seeded): serve_check with
    SERVE_VLM's batch, prompt and new tokens after the config's 2,880
    seeded random patches (fewer new tokens than patches: the case where
    the reference's cache is too short), its bf16 bound per residual add
    (SERVE_ULP_PER_ADD)."""
    from repro_torch.models import transformer as T

    cfg = llava_cut()
    lay = T.layout(cfg)
    if lay.numel != VLM_N or lay.n_groups != 1:
        raise AssertionError(f"{cfg.name}: N {lay.numel} in {lay.n_groups} groups, "
                             f"want {VLM_N} in one")
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(3)
    x0 = T.init_params(gen, cfg, device="cuda")
    b, prompt, new = SERVE_VLM
    patches = torch.randn((b, cfg.n_patches, cfg.d_model), generator=gen, device="cuda")
    serve_check(torch, smi, "serve_vlm_full_width", cfg, x0, b, prompt, new,
                {"patches": patches}, per_add_bound=True)
    del x0, patches
    torch.cuda.empty_cache()


def smoke_batch(cfg, seed, lead, seq) -> dict:
    """The reference's smoke batch dict (numpy): f32 patches before seq -
    n_patches token ids (vlm), or f32 frames beside seq token ids (encdec)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_text = seq - cfg.n_patches if cfg.family == "vlm" else seq
    batch = {"tokens": rng.integers(0, cfg.vocab_size, lead + (n_text,))}
    key, length = ("patches", cfg.n_patches) if cfg.family == "vlm" else ("frames", cfg.enc_len)
    batch[key] = rng.standard_normal(lead + (length, cfg.d_model), dtype=np.float32)
    return batch


def encdec_vlm_smoke_run(arch: str, device: str) -> dict:
    """An arch's SMOKE (f32) on ``device``, the same init and batches on
    every device: the loss of a microbatch at x0, one DSM outer step (W=2,
    tau=2, AdamW, gamma 1e-3, eta 0.5) on a batch dict, the loss of that
    microbatch after it, and generate's SERVE_NEW greedy tokens."""
    import torch

    from repro_torch.configs import load_arch
    from repro_torch.core import DSMConfig, dsm_init, get_base_optimizer, make_dsm_step
    from repro_torch.core.schedules import constant
    from repro_torch.models import transformer as T
    from repro_torch.train.serve import generate
    from repro_torch.train.trainer import set_matmul_precision

    set_matmul_precision()
    cfg = load_arch(arch).SMOKE
    lay = T.layout(cfg)
    x0 = T.init_params(torch.Generator().manual_seed(0), cfg).to(device)
    batch = {k: torch.as_tensor(v).to(device)
             for k, v in smoke_batch(cfg, 1, (2, 2, 1, 2), 32).items()}
    micro = {k: v[0, 0, 0] for k, v in batch.items()}
    with torch.no_grad():
        before = T.loss_fn(lay.views(x0), micro, cfg, remat=False).item()
    base = get_base_optimizer("adamw")
    step = make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base,
                         DSMConfig(tau=2, global_lr=0.5), constant(1e-3), lay)
    state, metrics = step(dsm_init(x0, base, 2), batch)
    with torch.no_grad():
        after = T.loss_fn(lay.views(state.x0), micro, cfg, remat=False).item()
    prompt = {k: torch.as_tensor(v) for k, v in smoke_batch(cfg, 2, (4,), 24).items()}
    toks, _ = generate(x0, cfg, prompt.pop("tokens"), max_new_tokens=SERVE_NEW,
                       extra_batch=prompt, device=device)
    return {"losses": [before, metrics["loss"].item(), after], "tokens": toks.cpu()}


def phase_encdec_vlm_card_vs_cpu(torch, K, pool):
    """whisper and llava SMOKE (f32), encdec_vlm_smoke_run on the card and
    on the CPU (in the worker pool): each loss within NANO_RTOL, the greedy
    tokens equal, one DSM and tau AdamW launches per arch on the card."""
    cpu = {a: pool.submit(encdec_vlm_smoke_run, a, "cpu") for a in ENCDEC_VLM_SMOKES}
    rows, failures = [], []
    total = dict.fromkeys(K.launch_counts(), 0)
    for arch in ENCDEC_VLM_SMOKES:
        K.reset_launch_counts()
        card = encdec_vlm_smoke_run(arch, "cuda")
        launches = K.launch_counts()
        theirs = cpu[arch].result(timeout=CPU_RUN_TIMEOUT_S)
        rel = history_rel(card["losses"], theirs["losses"])
        same = torch.equal(card["tokens"], theirs["tokens"])
        rows.append({"arch": arch, "card": card["losses"], "cpu": theirs["losses"],
                     "max_rel_diff": rel, "generate_tokens_equal": same, "launches": launches})
        if not rel <= NANO_RTOL:
            failures.append(f"{arch}: card and CPU differ by {rel}")
        if not same:
            failures.append(f"{arch}: generate's tokens differ on card and CPU")
        if launches != {"dsm_update": 1, "adamw_update": 2}:
            failures.append(f"{arch}: launch counts {launches}")
        for k in total:
            total[k] += launches[k]
    emit({"phase": "encdec_vlm_card_vs_cpu", "rtol": NANO_RTOL,
          "losses": "x0 microbatch, outer step, after it", "runs": rows})
    if failures:
        raise AssertionError("encdec_vlm_card_vs_cpu: " + "; ".join(failures))
    return total


def encdec_vlm_phases(torch, K, smi, pool) -> tuple:
    """The phases of the encoder-decoder and the VLM; returns (their runs'
    launches, the kernel checks' worst errors at whisper's shapes)."""
    errs = phase_group_kernel_checks(torch, K, "encdec_kernel_checks",
                                     [(whisper_cut(), encdec_settings())])
    total, cfg, x0 = phase_encdec_full_width(torch, K, smi)
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, prompt, new = SERVE_ENCDEC
    frames = frames_of(torch, gen, cfg, (b,))
    serve_check(torch, smi, "serve_encdec_full_width", cfg, x0, b, prompt, new,
                {"frames": frames})
    del x0, frames
    torch.cuda.empty_cache()
    phase_serve_vlm_full_width(torch, smi)
    more = phase_encdec_vlm_card_vs_cpu(torch, K, pool)
    return {k: n + more[k] for k, n in total.items()}, errs


def recurrentgemma_cut():
    """recurrentgemma_2b.FULL at full width and RG_LAYERS layers."""
    import dataclasses

    from repro_torch.configs import recurrentgemma_2b

    return dataclasses.replace(recurrentgemma_2b.FULL, n_layers=RG_LAYERS,
                               name=f"recurrentgemma_2b_{RG_LAYERS}l")


def recurrent_paths(torch=None):
    """(cfg, settings, N per dtype group, initial params) of the recurrent
    training paths: :func:`card_init`'s, or None without ``torch``."""
    from repro_torch.configs import mamba2_780m
    from repro_torch.train.trainer import TrainSettings

    common = dict(tau=12, steps=RECURRENT_STEPS, eval_every=1,
                  eval_batch=RECURRENT_EVAL_BATCH, peak_lr=MAIN["peak_lr"],
                  global_lr=MAIN["global_lr"])
    paths = [(recurrentgemma_cut(), TrainSettings(**{**common, "steps": RG_STEPS}, **RG), RG_N),
             (mamba2_780m.FULL, TrainSettings(**common, **MAMBA), MAMBA_N)]
    return [(*p, card_init(torch, p[0]) if torch else None) for p in paths]


def card_init(torch, cfg):
    """``cfg``'s initial params, drawn on the card (seeded: a CPU generator
    takes seconds over a billion draws) and kept on the host, where
    run_training copies them from: the paper sizes' and the recurrent
    paths' runs start from them, and remat_full_width's from mamba2's."""
    from repro_torch.groups import each
    from repro_torch.models import transformer as T

    gen = torch.Generator(device="cuda").manual_seed(0)
    return each(lambda t: t.cpu(), T.init_params(gen, cfg, device="cuda"))


def phase_remat_full_width(torch, K, smi) -> dict:
    """mamba2_780m.FULL at full width and REMAT_LAYERS layers with
    recurrent_full_width's settings (W=2, B_micro=1, S=2048, tau=12, its
    schedule over RECURRENT_STEPS outer steps, its corpus and batches),
    initial params drawn on the card, once without remat and once per
    policy of REMAT_POLICIES, each through make_dsm_step
    (``trainer.build_algorithm``: the trainer's DSM config and schedule)
    with a loss closure that passes ``remat=True, remat_policy=policy``,
    the reference dry-run's call form; REMAT_ROUNDS rounds, no eval.  Each
    remat run's history and x0 and m (both dtype groups) bit for bit those
    of the run without remat, the largest gap printed either way.  Per run:
    the peak (reset, cache emptied) beside the dry-run's reckoning, each
    round's ms (the process has run the model: no warm-up is left in the
    first), one DSM launch per group and round and tau AdamW launches per
    group and round.  Returns the launches."""
    import dataclasses

    from repro_torch.data.pipeline import dsm_batches
    from repro_torch.groups import each, parts
    from repro_torch.models import transformer as T
    from repro_torch.train.trainer import build_algorithm

    s = recurrent_paths()[1][1]
    cfg = depth_cut("mamba2_780m", REMAT_LAYERS)
    params = card_init(torch, cfg)
    lay = T.layout(cfg)
    corpus = training_corpus()
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures, dense = [], [], None
    for policy in (None,) + REMAT_POLICIES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        init, step, _, _ = build_algorithm(
            lambda p, mb, policy=policy: T.loss_fn(p, mb, cfg, remat=policy is not None,
                                                   remat_policy=policy or "full"),
            s, lay)
        state = init(each(lambda t: t.to("cuda"), params), s.n_workers)
        rng = torch.Generator(device="cuda").manual_seed(s.seed)
        batches = dsm_batches(corpus, s.n_workers, s.tau, 1, s.b_micro, s.seq, seed=s.seed,
                              heterogeneous=s.heterogeneous)
        losses, step_s = [], []
        for _ in range(REMAT_ROUNDS):
            batch = {k: torch.as_tensor(v, dtype=torch.long if k == "tokens" else None).to(
                "cuda") for k, v in next(batches).items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch, rng, None)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(metrics["loss"])
        launches = K.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ours = {"history": [float(x) for x in losses],
                "x0": [t.cpu() for t in parts(state.x0)], "m": [t.cpu() for t in parts(state.m)]}
        del state, metrics, batch
        expect_peak(f"{cfg.name} remat {policy}", peak, cfg, s, keep_x0=False, eval_batch=0,
                    remat=policy is not None, remat_policy=policy or "full")
        dense = dense or ours
        same = bit_equal(torch, ours, dense)
        step_ms = statistics.median(step_s) * 1e3
        rows.append({"config": cfg.name, "remat_policy": policy, "n_layers": cfg.n_layers,
                     "rounds": REMAT_ROUNDS, "history": ours["history"],
                     "dense_history": dense["history"],
                     "bit_equal_to_no_remat": same, "max_gap": max_gap(torch, ours, dense),
                     "outer_step_ms": [t * 1e3 for t in step_s],
                     "outer_step_ms_median": step_ms,
                     "tokens_per_s": s.n_workers * s.tau * s.b_micro * s.seq / (step_ms / 1e3),
                     "max_memory_allocated_bytes": peak, "launches": launches})
        want = expected_launches(dataclasses.replace(s, steps=REMAT_ROUNDS), lay.n_groups)
        if launches != want:
            failures.append(f"{policy}: launch counts {launches}, want {want}")
        if policy and not same:
            failures.append(f"{policy}: not bit-equal to the run without remat: "
                            f"{rows[-1]['max_gap']}")
        for k in total:
            total[k] += launches[k]
    emit({"phase": "remat_full_width", "gpu": smi, "n_layers": cfg.n_layers,
          "n_workers": s.n_workers, "tau": s.tau, "b_micro": s.b_micro, "seq": s.seq,
          "rounds": REMAT_ROUNDS, "runs": rows})
    if failures:
        raise AssertionError("remat_full_width: " + "; ".join(failures))
    return total


def reckon_peak(cfg, kw: dict) -> dict:
    """The dry-run's reckoning of a run's bytes on meta tensors, in a CPU
    worker process: ``repro_torch.launch.dryrun.reckon_train``'s memory
    components."""
    from repro_torch.launch.dryrun import reckon_train

    return reckon_train(cfg, **kw)["memory"]


def adam_step_bound(t: int) -> float:
    """The largest |m_hat / sqrt(v_hat)| of AdamW's step t (1-indexed,
    ADAMW_HP's betas): Cauchy-Schwarz over the bias-corrected weights w_i
    of the first moment and u_i of the second, sqrt(sum w_i^2 / u_i)."""
    b1, b2 = ADAMW_HP["beta1"], ADAMW_HP["beta2"]
    w = [(1 - b1) * b1 ** (t - i) / (1 - b1 ** t) for i in range(1, t + 1)]
    u = [(1 - b2) * b2 ** (t - i) / (1 - b2 ** t) for i in range(1, t + 1)]
    return math.sqrt(sum(a * a / c for a, c in zip(w, u)))


def model_axis_bounds(n_layers: int, rounds: int, tau: int) -> list:
    """Per round, the model axis against the dense run (PERF.md section 6):
    ``loss``: a worker's round-mean loss within ``loss`` times the largest
    logit, 2 * (2 * n_layers) * MODEL_AXIS_ULP; ``x_tau`` and ``x0`` (after
    the round): (C, R), each element's gap within C + R * |x| (|x| the
    larger of the two runs'); ``x0_before``: the same for x0 before it.

    AdamW's direction (rounded to bf16, so within (1 + 2^-8) times
    adam_step_bound(t)) moves by at most twice that wherever the two runs'
    gradients differ (a sign flip at a near-zero gradient), so a
    local step moves a parameter's gap by at most that times gamma (its
    weight decay only shrinks the gap), and each bf16 rounding of a
    parameter in either run by half an ulp, 2^-8 |x| each: 2^-7 |x| per
    step and for the mean.  The global step moves x0 by eta * gamma *
    (sign(u) + lam * x0): a flipped sign moves the gap by 2 * eta * gamma,
    lam * eta * gamma scales the old gap, and the two runs' roundings of x0
    add 2^-7 |x|.  m = beta2 m + (1 - beta2) (x0 - x_tau) / gamma in f32:
    its gap is within beta2 times the old gap's bound plus (1 - beta2) /
    gamma times the bounds of x0's (before) and x_tau's gaps, plus f32
    rounding, 1e-6 |m| (:func:`phase_model_axis_full_width` evaluates it
    element by element)."""
    g, eta, lam = MODEL_AXIS_GAMMA, MODEL_AXIS_ETA, DSM_HP["lam"]
    rnd = 2 * MODEL_AXIS_ULP
    x0 = (0.0, 0.0)
    out = []
    for k in range(rounds):
        steps = range(k * tau + 1, (k + 1) * tau + 1)
        # the direction is rounded to bf16 before the update: (1 + 2^-8)
        xt = (x0[0] + 2 * g * (1 + MODEL_AXIS_ULP) * sum(adam_step_bound(t) for t in steps),
              x0[1] + (tau + 1) * rnd)
        after = (x0[0] * (1 + eta * g * lam) + 2 * eta * g, x0[1] + rnd)
        out.append({"loss": 2 * (2 * n_layers) * MODEL_AXIS_ULP, "x_tau": xt, "x0": after,
                    "x0_before": x0})
        x0 = after
    return out


def depth_cut(arch: str, layers: int):
    """``arch``'s FULL config at ``layers`` layers (an encdec model's
    encoder too): full width."""
    import dataclasses

    from repro_torch.configs import load_arch

    full = load_arch(arch).FULL
    if full.family == "encdec":
        return dataclasses.replace(full, n_layers=layers, enc_layers=layers,
                                   name=f"{arch}_{layers}+{layers}l")
    return dataclasses.replace(full, n_layers=layers, name=f"{arch}_{layers}l")


def model_axis_cfgs():
    """The model-axis cases: (cfg, W, M, B_micro, rounds, S, the leaves held
    whole on every rank) at MODEL_AXIS_CASES' depths, then SP_AXIS_CASES'
    with attn_seq_shard."""
    import dataclasses

    from repro_torch.launch.dryrun import ATTN_NAMES

    plain = [(depth_cut(arch, layers), n_workers, model, b_micro, rounds, MODEL_AXIS["seq"], ())
             for arch, layers, n_workers, model, b_micro, rounds in MODEL_AXIS_CASES]
    sp = []
    for arch, layers, n_workers, model, attn_tp in SP_AXIS_CASES:
        cut = depth_cut(arch, layers)
        cfg = dataclasses.replace(cut, attn_seq_shard=True,
                                  name=f"{cut.name}_sp{'' if attn_tp else '_attn_whole'}")
        sp.append((cfg, n_workers, model, SP_AXIS["b_micro"], 1, SP_AXIS["seq"],
                   () if attn_tp else ATTN_NAMES))
    return plain + sp


def largest_logit(torch, params, cfg, batch) -> float:
    """The largest |logit| of a microbatch (``tokens`` (B, S), or its dict
    with a VLM's ``patches``) under ``params``: the unit of the model
    axis's loss bound."""
    from repro_torch.models import transformer as T

    batch = batch if isinstance(batch, dict) else {"tokens": batch}
    with torch.no_grad():
        h, _, n_prefix = T.hidden_states(params, batch, cfg, remat=False)
        return T._logits(params, h[:, n_prefix:], cfg).abs().max().item()


class forced_routes:
    """While active, every ``layers.route`` call takes the next of
    ``routes`` ((T, K) experts, in the calls' order: another run's, from
    ``torch_ranks.recorded_routes``) with the call's own probabilities at
    them, and keeps the experts it would have taken itself (``own``)."""

    def __init__(self, routes: list):
        self.routes, self.own = list(routes), []

    def __enter__(self):
        from repro_torch.models import layers as L

        orig, todo = L.route, iter(self.routes)

        def route(probs, k):
            self.own.append(orig(probs, k)[1])
            idx = next(todo).to(probs.device)
            return probs.gather(-1, idx), idx

        self.restore = lambda: setattr(L, "route", orig)
        L.route = route
        return self

    def __exit__(self, *exc):
        self.restore()

    def other_per_step(self, tau: int) -> list:
        """Per local step, the tokens whose own top-k experts (as a set)
        differ from the ones taken; every call's route taken once."""
        if len(self.own) != len(self.routes):
            raise AssertionError(f"{len(self.own)} MoE calls took {len(self.routes)} routes")
        diff = [int((a.cpu().sort(dim=-1).values != b.sort(dim=-1).values).any(dim=-1).sum())
                for a, b in zip(self.own, self.routes)]
        n = len(diff) // tau
        return [sum(diff[t * n:(t + 1) * n]) for t in range(tau)]


def phase_model_axis_full_width(torch, K, smi, pool) -> tuple:
    """The model axis at full width (MODEL_AXIS_CASES): one start of RANKS
    gloo ranks sharing the card runs both cases through
    ``tests/torch_ranks.model_axis_rank`` (make_dsm_step over each rank's
    blocks, the ZeRO-sharded global step over its (worker, zero) ranks),
    each rank saving its blocks of x_tau, x0 and m after every round, and
    then serve_model_axis_full_width's serving cases (SERVE_MA_CASES); then
    each case's dense run in this process from the same draw and batches,
    round by round against the ranks': each worker's round-mean loss, the
    largest gaps of x_tau, x0 and m within model_axis_bounds, and the
    global step from the dense x_tau, x0 and m cut to each rank's blocks
    bit for bit the dense step's blocks (the DSM kernel).  Per rank: its
    peak beside the dry-run's reckoning of that grid (dryrun_vs_card), its
    collectives per name and group equal to the reckoning's to the byte, one
    DSM and tau AdamW launches per round, each outer step's host ms.  Then
    both kernels against their plain versions on rank 0's blocks of (a),
    bit for bit.  Returns the dense runs' and the ranks' launches, and the
    serving cases with the ranks' results for
    :func:`phase_serve_model_axis_full_width`."""
    import numpy as np

    from repro_torch.core import base_opt, schedules
    from repro_torch.core import dsm as D
    from repro_torch.distributed import mesh
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed import zero as Z
    from repro_torch.distributed.spawn import run_ranks
    from repro_torch.groups import each, parts
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T
    from repro_torch.obs import metrics as OM

    import torch_ranks

    cfgs = model_axis_cfgs()
    if T.layout(cfgs[0][0]).numel != MODEL_AXIS_N:
        raise AssertionError(f"{cfgs[0][0].name}: N {T.layout(cfgs[0][0]).numel}")
    corpus = training_corpus()
    rng = np.random.default_rng(11)
    tau = MODEL_AXIS["tau"]
    cases, reckoned = [], []
    for i, (cfg, W, M, bm, n_rounds, seq, rep) in enumerate(cfgs):
        batches = []
        for _ in range(n_rounds):
            batch = {"tokens": corpus.sample(rng, W * tau * bm, seq).reshape(
                W, tau, 1, bm, seq).astype(np.int64)}
            if cfg.family == "vlm":
                batch["patches"] = rng.standard_normal((W, tau, 1, bm, cfg.n_patches,
                                                        cfg.d_model), dtype=np.float32)
            elif cfg.family == "encdec":
                batch["frames"] = rng.standard_normal((W, tau, 1, bm, cfg.enc_len,
                                                       cfg.d_model), dtype=np.float32)
            batches.append(batch)
        cases.append((cfg, W, M, 7 + i, batches, MODEL_AXIS_GAMMA, MODEL_AXIS_ETA, rep))
        # every rank holds blocks of the same shapes: rank 0's reckoning (a
        # VLM's sequence is its patches and its text)
        n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
        kw = dict(n_workers=W, tau=tau, b_micro=bm, seq=seq + n_prefix, world=RANKS, model=M,
                  eval_batch=0, replicate_names=rep)
        reckoned.append((kw, pool.submit(reckon_comm, cfg, kw),
                         pool.submit(reckon_peak, cfg, kw)))
    # (o): the randomized signs and global AdamW on (b)'s grid, draw and batches
    b_case = next(c for c in cases if c[0].name == depth_cut("gpt2_small", CUT_LAYERS).name)
    algo_cases = [b_case[:7] + ((), algo) for _, algo in ALGO_AXIS_CASES]
    serving = serve_model_axis_cases(torch, pool)
    fsdp = fsdp_cases(pool, corpus)
    # (c): serving's (b), gpt2_small over (data 2, model 2), with the data entries cut
    plain_serve = next(i for i, (arch, *_) in enumerate(SERVE_MA_CASES) if arch == "gpt2_small")
    fsdp_serve = serving[plain_serve][0] + (True,)
    total = dict.fromkeys(K.launch_counts(), 0)
    work = ROOT / "build" / "model_axis"
    shutil.rmtree(work, ignore_errors=True)
    (work / "fsdp").mkdir(parents=True)
    torch.cuda.empty_cache()
    t0, wall0 = time.perf_counter(), time.time()
    both = run_ranks(torch_ranks.model_axis_serve_rank, RANKS,
                     (cases, str(work), [case for case, _ in serving] + [fsdp_serve],
                      fsdp["cases"] + fsdp["algo_cases"], algo_cases),
                     timeout_s=RANKS_TIMEOUT_S, work_dir=str(ROOT / "build"))
    ranks_s, wall1 = time.perf_counter() - t0, time.time()
    # where the ranks' start goes: to the rank function's entry, its
    # training, serving and FSDP cases, and from their end to the return here
    wall = [r["wall"] for r in both]
    ranks_split_s = {"enter": max(w[0] for w in wall) - wall0,
                     "train": max(w[1] - w[0] for w in wall),
                     "serve": max(w[2] - w[1] for w in wall),
                     "fsdp": max(w[3] - w[2] for w in wall),
                     "return": wall1 - max(w[3] for w in wall)}
    ranks = [r["train"] for r in both]
    served = (serving, [[r["serve"][i] for r in both] for i in range(len(serving))], ranks_s)
    fsdp.update(ranks=[r["fsdp"] for r in both], work=work / "fsdp", ranks_s=ranks_s,
                served=([r["serve"][len(serving)] for r in both],
                        [r["serve"][plain_serve] for r in both]),
                serve_case=fsdp_serve)
    rows, failures = [], []
    for i, (cfg, W, M, seed, batches, gamma, eta, rep) in enumerate(cases):
        per_rank = [r[i] for r in ranks]
        lay = T.layout(cfg)
        lays = [TP.rank_layout(cfg, M, m, replicate_names=rep) for m in range(M)]
        kw, comm_fut, peak_fut = reckoned[i]
        n_rounds = len(batches)
        comm_round, comm_kinds = comm_fut.result(timeout=CPU_RUN_TIMEOUT_S)
        want_comm = {k: {"calls": v["calls"] * n_rounds,
                         "bytes": v["bytes"] * n_rounds} for k, v in comm_round.items()}
        want_launch = {"dsm_update": n_rounds * lay.n_groups,
                       "adamw_update": n_rounds * tau * lay.n_groups}
        for r in per_rank:
            PEAKS.append((f"model_axis_{cfg.name}_rank{r['rank']}", r["peak_bytes"], cfg, kw,
                          0, peak_fut))
            if r["comm"] != want_comm:
                failures.append(f"{cfg.name} rank {r['rank']}: collectives {r['comm']}, "
                                f"reckoned {want_comm}")
            if r["launches"] != want_launch:
                failures.append(f"{cfg.name} rank {r['rank']}: launches {r['launches']}")
            total = {k: n + r["launches"][k] for k, n in total.items()}

        # the dense run, round by round against the ranks' saved blocks
        t_dense = time.perf_counter()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        x0 = T.init_params(torch.Generator("cuda").manual_seed(seed), cfg, device="cuda")
        base = base_opt.adamw()
        dcfg = D.DSMConfig(tau=tau, global_lr=eta)
        step = D.make_dsm_step(lambda p, mb, cfg=cfg: T.loss_fn(p, mb, cfg, remat=False),
                               base, dcfg, schedules.constant(gamma), lay)
        state = D.dsm_init(x0, base, W)
        del x0                          # the state holds its own copy
        seen = {}
        mean_fn, stats_fn = D.worker_mean, OM.loss_stats

        def mean(p):
            seen["x_tau"] = mean_fn(p)
            return seen["x_tau"]

        def loss_stats(losses):
            seen["losses"] = losses.detach().cpu()
            return stats_fn(losses)

        bounds = model_axis_bounds(cfg.n_layers, n_rounds, tau)
        D.worker_mean, OM.loss_stats = mean, loss_stats
        K.reset_launch_counts()
        rounds, m_prev = [], 0.0
        try:
            for k, raw in enumerate(batches):
                batch = {n: torch.from_numpy(v).to("cuda") for n, v in raw.items()}
                top = largest_logit(torch, lay.views(state.x0), cfg,
                                    {n: v[0, 0, 0] for n, v in batch.items()})
                before = (each(torch.clone, state.x0), each(torch.clone, state.m))
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                # the dense run takes the routes the ranks took (none without a MoE layer)
                with forced_routes(per_rank[0]["routes"][k]) as forced:
                    state, _ = step(state, batch)
                torch.cuda.synchronize()
                step_ms = (time.perf_counter() - t1) * 1e3
                other = forced.other_per_step(tau)
                del batch, forced
                launches = K.launch_counts()
                x_tau = seen.pop("x_tau")
                # the global step from the dense x_tau, x0 and m on each rank's blocks
                bit_equal = True
                for rl in lays:
                    xb, mb = C.shard_flat(before[0], lay, rl), C.shard_flat(before[1], lay, rl)
                    D.global_sign_momentum_step(xb, mb, C.shard_flat(x_tau, lay, rl), gamma,
                                                dcfg)
                    bit_equal &= all(same_bits(torch, p, q) for p, q in zip(
                        parts(xb) + parts(mb), parts(C.shard_flat(state.x0, lay, rl))
                        + parts(C.shard_flat(state.m, lay, rl))))
                    del xb, mb
                K.reset_launch_counts()
                before = before[0]          # m's copy is not needed past the bit check
                saved = [torch.load(work / f"{i}_{m}_{k}.pt", mmap=True, weights_only=False)
                         for m in range(M)]
                tp = {n: C.gather_flat([each(lambda t: t.to("cuda"), sv[n]) for sv in saved],
                                       lay, lays) for n in ("x_tau", "x0", "m")}
                del saved
                b = bounds[k]
                # every rank of the model group took the same routes
                same_routes = all(len(r["routes"][k]) == len(per_rank[0]["routes"][k]) and all(
                    torch.equal(x, y) for x, y in zip(r["routes"][k], per_rank[0]["routes"][k]))
                    for r in per_rank)
                dense_loss = seen["losses"].mean(0).tolist()
                tp_loss = [r["losses"][k].mean(0).tolist() for r in per_rank]
                loss_gap = max(abs(x - y) for t in tp_loss for x, y in zip(t, dense_loss))
                check, m_prev = torch_ranks.round_check(
                    tp, {"x_tau": x_tau, "x0": state.x0, "m": state.m}, before, b, gamma,
                    DSM_HP["beta2"], m_prev)
                ok = (loss_gap <= b["loss"] * top and check.pop("ok") and bit_equal
                      and same_routes)
                rounds.append({"round": k, "largest_logit": top,
                               "dense_loss_per_worker": dense_loss,
                               "model_axis_loss_per_worker_by_rank": tp_loss,
                               "loss_gap": loss_gap, "loss_bound": b["loss"] * top, **check,
                               "bound_C_R": {n: b[n] for n in ("x_tau", "x0", "x0_before")},
                               "tokens_routed_otherwise_by_dense_per_step": other,
                               "model_group_routes_agree": same_routes,
                               "global_step_bit_equal_from_dense_x_tau": bit_equal,
                               "dense_step_ms": step_ms,
                               "model_axis_step_ms_by_rank": [r["step_ms"][k]
                                                              for r in per_rank],
                               "ok": ok})
                if not ok:
                    failures.append(f"{cfg.name} round {k}: {rounds[-1]}")
                total = {n: c + launches[n] for n, c in total.items()}
                del tp, x_tau, before
        finally:
            D.worker_mean, OM.loss_stats = mean_fn, stats_fn
        peak = torch.cuda.max_memory_allocated()
        del state, step
        torch.cuda.empty_cache()
        # both kernels on rank 0's blocks, bit for bit and timed: DSM on its
        # ZeRO chunk over its (worker, zero) ranks, AdamW on its workers' rows
        worker, zero = mesh.grid(W, RANKS, M)
        chunks = [n if worker * zero == 1 else Z.chunk_size(n, worker * zero)
                  for n in lays[0].group_numels]
        checks = rank_kernel_times(torch, K, lays[0], chunks, W // worker)
        for c in checks:
            if c.get("max_abs_err", 0.0) != 0.0:
                failures.append(f"{cfg.name}: kernel on rank 0's blocks: {c}")
        rows.append({"config": cfg.name, "n_params": lay.numel, "n_workers": W,
                     "seq": batches[0]["tokens"].shape[-1],
                     "attn_seq_shard": cfg.attn_seq_shard, "leaves_whole": list(rep),
                     "dense_and_checks_s": time.perf_counter() - t_dense,
                     "case_s_by_rank": [r["case_s"] for r in per_rank],
                     "grid": {"worker": per_rank[0]["grid"][0], "zero": per_rank[0]["grid"][1],
                              "model": M},
                     "rank_block_numel": lays[0].numel, "dense_peak_bytes": peak,
                     "rank_peaks_bytes": [r["peak_bytes"] for r in per_rank],
                     "launches_by_rank": [r["launches"] for r in per_rank],
                     "collectives_by_rank": [r["comm"] for r in per_rank],
                     "collectives_reckoned_per_round": comm_round,
                     "collectives_by_kind_per_round": comm_kinds, "b_micro": kw["b_micro"],
                     "kernels_on_rank0_blocks": checks, "rounds": rounds})
    # (o), each against its dense run
    algo_rows = []
    for i, ((name, algo), (cfg, W, M, seed, batches, gamma, eta, *_)) in enumerate(
            zip(ALGO_AXIS_CASES, algo_cases)):
        worker, zero = mesh.grid(W, RANKS, M)
        lays = [TP.rank_layout(cfg, M, m) for m in range(M)]

        def saved(i=i, lays=lays, M=M):
            return lays, [torch.load(work / f"o{i}_{m}_0.pt", mmap=True, weights_only=False)
                          for m in range(M)]

        per_rank = [r["algorithms"][i] for r in both]
        row, bad, launches = check_algorithm_run(
            torch, K, dict(name=name, cfg=cfg, n_workers=W, seed=seed, batches=batches,
                           gamma=gamma, eta=eta, algo=algo, worker=worker, zero=zero),
            per_rank, saved, lambda r, cfg=cfg, M=M: TP.rank_layout(cfg, M, r["index"]))
        row["case_s_by_rank"] = [r["case_s"] for r in per_rank]
        algo_rows.append(row)
        failures += bad
        total = {n: c + launches[n] + sum(r["launches"][n] for r in per_rank)
                 for n, c in total.items()}
    for f in work.glob("*.pt"):
        f.unlink()
    emit({"phase": "model_axis_full_width", "gpu": smi, "ranks": RANKS,
          "backend": "gloo", "tau": tau, "gamma": MODEL_AXIS_GAMMA,
          "eta": MODEL_AXIS_ETA, "ranks_s": ranks_s, "ranks_split_s": ranks_split_s,
          "cases": rows, "algorithms": algo_rows})
    if failures:
        raise AssertionError(f"model_axis_full_width: {failures}")
    return total, served, fsdp


def fsdp_cfgs():
    """FSDP_A's and FSDP_B's configs (FSDP_B cut to its layers)."""
    import dataclasses

    from repro_torch.configs import load_arch

    out = []
    for arch, layers, n_workers, model in (FSDP_A, FSDP_B):
        cfg = load_arch(arch).FULL
        if layers:
            cfg = dataclasses.replace(cfg, n_layers=layers, name=f"{arch}_{layers}l")
        out.append((cfg, n_workers, model))
    return out


def fsdp_cases(pool, corpus) -> dict:
    """The FSDP runs of fsdp_full_width for tests/torch_ranks.
    fsdp_full_width_rank, with corpus batches (tau and S of MODEL_AXIS), and
    the dry-run's reckonings of each (its memory, its round's collectives,
    and the same grid's peak without FSDP) submitted to the CPU pool."""
    import numpy as np

    rng = np.random.default_rng(17)
    tau, seq = MODEL_AXIS["tau"], MODEL_AXIS["seq"]
    (cfg_a, w_a, m_a), (cfg_b, w_b, m_b) = fsdp_cfgs()

    def batches(n_workers, b_micro, rounds, tau=tau):
        return [{"tokens": corpus.sample(rng, n_workers * tau * b_micro, seq).reshape(
            n_workers, tau, 1, b_micro, seq).astype(np.int64)} for _ in range(rounds)]

    common = dict(gamma=MODEL_AXIS_GAMMA, eta=MODEL_AXIS_ETA)
    b_whole = batches(w_b, 1, FSDP_B_ROUNDS, FSDP_B_TAU)
    b_split = batches(w_b, FSDP_B_MICRO, FSDP_B_ROUNDS, FSDP_B_TAU)
    bounds = model_axis_bounds(cfg_b.n_layers, FSDP_B_ROUNDS, FSDP_B_TAU)
    cases = [
        dict(name="a", cfg=cfg_a, n_workers=w_a, model=m_a, fsdp=True, seed=41, save=True,
             keep=True, params=True, batches=batches(w_a, FSDP_B_MICRO, FSDP_ROUNDS),
             **common),
        dict(name="b_plain_whole", cfg=cfg_b, n_workers=w_b, model=m_b, fsdp=False, seed=43,
             keep=True, batches=b_whole, **common),
        dict(name="b_whole", cfg=cfg_b, n_workers=w_b, model=m_b, fsdp=True, seed=43,
             against=("b_plain_whole", None), batches=b_whole, **common),
        dict(name="b_plain", cfg=cfg_b, n_workers=w_b, model=m_b, fsdp=False, seed=43,
             keep=True, batches=b_split, **common),
        dict(name="b", cfg=cfg_b, n_workers=w_b, model=m_b, fsdp=True, seed=43,
             against=("b_plain", bounds), batches=b_split, **common)]
    # (e): x0 and m over zero only on (a)'s grid, draw and batches, held
    # against (a) bit for bit
    cases.insert(1, dict(cases[0], name="e", algo=FSDP_E, save=False, keep=False,
                         against=("a", None), digest=True))
    # (d): the randomized signs and SlowMo on (a)'s grid, draw and batches
    algo_cases = [dict(cases[0], name=name, algo=algo, keep=False, params=False)
                  for name, algo in ALGO_FSDP_CASES]
    reckoned = []
    for c in cases:
        lead = c["batches"][0]["tokens"].shape
        kw = dict(n_workers=c["n_workers"], tau=lead[1], b_micro=lead[3], seq=seq, world=RANKS,
                  model=c["model"], eval_batch=0, fsdp=c["fsdp"])
        if c.get("algo") == FSDP_E:
            kw["zero_global_buffers"] = False
        plain = dict(kw, fsdp=False)
        reckoned.append((kw, pool.submit(reckon_comm, c["cfg"], kw),
                         pool.submit(reckon_peak, c["cfg"], kw),
                         pool.submit(reckon_peak, c["cfg"], plain) if c["fsdp"] else None))
    return {"cases": cases, "algo_cases": algo_cases, "reckoned": reckoned}


def rank_kernel_times(torch, K, lay, dsm_ns: list, n_workers: int) -> list:
    """Both kernels on a model or FSDP rank's rows: bit for bit against
    their plain versions (model_axis_kernel_checks), and timed with theirs
    (CUDA events, median) beside the byte bound: the DSM step on the rank's
    chunk of each dtype group over its worker peers (``dsm_ns`` elements
    per group), AdamW on its (n_workers, N_rank) rows."""
    from repro_torch.kernels.adamw_update import adamw_update_plain
    from repro_torch.kernels.dsm_update import dsm_update_plain

    checks = model_axis_kernel_checks(torch, K, lay, n_workers)
    gen = torch.Generator(device="cuda").manual_seed(6)
    out = []
    for n, dt, dsm_n in zip(lay.group_numels, lay.dtypes, dsm_ns, strict=True):
        es = torch.empty((), dtype=dt).element_size()
        x0, m, xt = dsm_inputs(torch, gen, dsm_n, dt)
        row = {"kernel": "dsm_update", "shape": [dsm_n], "dtype": str(dt),
               "ms": median_ms(torch, lambda: K.dsm_update(x0, m, xt, 0.02, **DSM_HP)),
               "plain_ms": median_ms(torch, lambda: dsm_update_plain(x0, m, xt, 0.02,
                                                                     **DSM_HP))}
        row["bound_ms"], row["bound_by"] = bound_ms(dsm_n * (3 * es + 2 * 4), dsm_n * 12)
        out.append(row)
        del x0, m, xt
        p, g, mm, v = adamw_inputs(torch, gen, (n_workers, n), dt)
        row = {"kernel": "adamw_update", "shape": [n_workers, n], "dtype": str(dt),
               "ms": median_ms(torch, lambda: K.adamw_update(p, g, mm, v, 1e-3, 11,
                                                             **ADAMW_HP)),
               "plain_ms": median_ms(torch, lambda: adamw_update_plain(p, g, mm, v, 1e-3, 11,
                                                                       **ADAMW_HP))}
        row["bound_ms"], row["bound_by"] = bound_ms(n_workers * n * (3 * es + 4 * 4),
                                                    n_workers * n * 16)
        out.append(row)
        del p, g, mm, v
        torch.cuda.empty_cache()
    return checks + out


def algorithm_bounds(algo: dict, n_layers: int, tau: int) -> tuple:
    """One round's bounds of an (o) / (d) run against its dense run, and
    ``round_check``'s ``beta2`` for the buffer held beside x0 (one less the
    weight of the pseudo-gradient (x0 - x_tau) / gamma in it).  DSM with
    either randomized sign: model_axis_bounds' (a sign that differs between
    the runs moves x0 by at most 2 eta gamma, as the deterministic one's
    flip; m as DSM's).  Global AdamW: model_axis_bounds' too (its first
    direction m_hat / (sqrt(v_hat) + eps) lies within 1 of 0, so the runs'
    directions differ by at most 2; no weight decay), its m (1 - b1) g.
    SlowMo: its first round's x0 is x0 - alpha gamma u with u = (x0 -
    x_tau) / gamma, so x0's gap is alpha times x_tau's plus each run's bf16
    rounding of x0, and u's 1 / gamma times x_tau's (beta2 0)."""
    b = model_axis_bounds(n_layers, 1, tau)[0]
    method = algo.get("method")
    if method is None:
        return b, DSM_HP["beta2"]
    if method == "global_adamw":
        return b, 0.9
    if method == "slowmo":
        a = algo.get("alpha", 1.0)
        return dict(b, x0=(a * b["x_tau"][0], a * b["x_tau"][1] + 2 * MODEL_AXIS_ULP)), 0.0
    raise ValueError(f"no bounds for {method}")


def dense_elements(t, where) -> list:
    """Per group, the elements ``where`` (``FlatLayout.dense_index``) of a
    dense buffer ``t`` (a tensor or Groups), as new tensors."""
    from repro_torch.groups import parts

    return [p[w].clone() if isinstance(w, slice) else p.index_select(0, w)
            for p, (_, w) in zip(parts(t), where, strict=True)]


def check_algorithm_run(torch, K, run: dict, ranks: list, saved, rank_layout) -> tuple:
    """An (o) / (d) run (``run``: ``name``, ``cfg``, ``n_workers``, ``seed``,
    ``batches``, ``gamma``, ``eta``, ``algo``, the grid's ``worker`` and
    ``zero``) against its dense
    run here from the same card draw, batches and generator seed
    (tests/torch_ranks.algorithm_step with no topology): the global step
    from the dense x_tau, x0 and m (a baseline's aux) on each rank layout's
    elements bit for bit the dense step's (DSM: on each of its ZeRO shards,
    core.dsm.randomized_step through FlatLayout.dense_index, as the ranks
    run it; a baseline: its core.baselines.GLOBAL_UPDATES update); the round
    (``saved()``: (layouts, blocks) covering the dense buffers) within
    algorithm_bounds; each rank's loss within the loss bound; its
    collectives tensor_parallel.round_collectives' to the byte
    (``rank_layout(r)``: rank r's layout); tau AdamW launches per rank, run
    and dtype group and no DSM launch.  Returns (the phase line's row, the
    failures, the dense run's launches)."""
    from repro_torch.core import baselines as BL
    from repro_torch.core import dsm as D
    from repro_torch.core.base_opt import _buffers
    from repro_torch.distributed import mesh
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed import zero as Z
    from repro_torch.groups import Groups, each
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T

    import torch_ranks

    cfg, W, algo, gamma = run["cfg"], run["n_workers"], run["algo"], run["gamma"]
    method = algo.get("method")
    lead = run["batches"][0]["tokens"].shape          # (W, tau, 1, B_micro, S)
    tau = lead[1]
    lay = T.layout(cfg)
    failures = []
    want_launch = {"dsm_update": 0, "adamw_update": tau * lay.n_groups}
    for r in ranks:
        want = TP.round_collectives(cfg, rank_layout(r), W, run["worker"], run["zero"], tau,
                                    lead[3], lead[4], dsm=method is None)
        if r["comm"] != want:
            failures.append(f"{run['name']} rank {r['rank']}: collectives {r['comm']}, "
                            f"reckoned {want}")
        if r["launches"] != want_launch:
            failures.append(f"{run['name']} rank {r['rank']}: launches {r['launches']}")

    # the dense run, its worker mean kept
    t_dense = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x0 = T.init_params(torch.Generator("cuda").manual_seed(run["seed"]), cfg, device="cuda")
    init, step = torch_ranks.algorithm_step(cfg, algo, tau, gamma, run["eta"], lay)
    state = init(x0, W)
    del x0
    batch = {n: torch.from_numpy(v).to("cuda") for n, v in run["batches"][0].items()}
    top = largest_logit(torch, lay.views(state.x0), cfg, {n: v[0, 0, 0] for n, v in batch.items()})
    before = (each(torch.clone, state.x0), each(torch.clone, torch_ranks.momentum(state)))
    seen, means = {}, (D.worker_mean, BL.worker_mean)

    def mean(p):
        seen["x_tau"] = means[0](p)
        return seen["x_tau"]

    D.worker_mean = BL.worker_mean = mean
    K.reset_launch_counts()
    try:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t1) * 1e3
    finally:
        D.worker_mean, BL.worker_mean = means
    launches = K.launch_counts()
    if launches != want_launch:
        failures.append(f"{run['name']} dense run: launches {launches}")
    x_tau, dense_loss = seen.pop("x_tau"), metrics["loss"].item()
    dense_peak = torch.cuda.max_memory_allocated()
    del batch

    # the global step from the dense x_tau on every rank layout's elements
    bit_equal = True
    # the ranks the ZeRO shards lie over: under FSDP the worker peers
    dp = run["worker"] * (1 if rank_layout(ranks[0]).zero > 1 else run["zero"])
    for rl in {(r["index"], r["zero_index"]): rank_layout(r) for r in ranks}.values():
        if method is None:
            views = [mesh.Topology(W, dp, 1, i) for i in range(dp)]
            shards = [[Z.my_bounds(n, v) for n in rl.group_numels] for v in views]
        else:
            shards = [None]
        for chunks in shards:
            where = rl.dense_index(chunks, "cuda")
            xb, xt = dense_elements(before[0], where), dense_elements(x_tau, where)
            if method is None:
                mb = dense_elements(before[1], where)
                dcfg = D.DSMConfig(tau=tau, global_lr=run["eta"], sign_mode=algo["sign_mode"])
                D.randomized_step(Groups(xb), Groups(mb), Groups(xt), gamma, dcfg,
                                  torch.Generator("cuda").manual_seed(algo["seed"]), where)
                pairs = list(zip(xb + mb, dense_elements(state.x0, where)
                                 + dense_elements(state.m, where)))
            else:
                init_aux, update = BL.GLOBAL_UPDATES[method](
                    **{k: v for k, v in algo.items() if k != "method"})
                theirs = [dense_elements(b, where) for b in _buffers(state.aux)]
                pairs = list(zip(xb, dense_elements(state.x0, where)))
                for g, (x, t) in enumerate(zip(xb, xt)):
                    aux = init_aux(x)
                    update(x, aux, t, gamma, 0)
                    pairs += [(a, b[g]) for a, b in zip(_buffers(aux), theirs, strict=True)]
            bit_equal &= all(same_bits(torch, a, b) for a, b in pairs)
            del xb, xt, pairs
    if not bit_equal:
        failures.append(f"{run['name']}: the global step from the dense x_tau differs on a "
                        f"rank's elements")

    # the round against the ranks' blocks
    bound, beta2 = algorithm_bounds(algo, cfg.n_layers, tau)
    lays, blocks = saved()
    tp = {n: C.gather_flat([each(lambda t: t.to("cuda"), b[n]) for b in blocks], lay, lays)
          for n in ("x_tau", "x0", "m")}
    del blocks
    check, _ = torch_ranks.round_check(tp, {"x_tau": x_tau, "x0": state.x0,
                                            "m": torch_ranks.momentum(state)},
                                       before[0], bound, gamma, beta2, 0.0)
    loss_gap = max(abs(r["loss"][0] - dense_loss) for r in ranks)
    ok = check.pop("ok") and loss_gap <= bound["loss"] * top and bit_equal
    if not ok:
        failures.append(f"{run['name']}: round {check}, loss gap {loss_gap} over "
                        f"{bound['loss'] * top}")
    del tp, x_tau, before, state, step
    torch.cuda.empty_cache()
    row = {"case": run["name"], "config": cfg.name, "algorithm": algo, "n_workers": W,
           "grid": {"worker": run["worker"], "zero": run["zero"],
                    "model": rank_layout(ranks[0]).model},
           "tau": tau, "largest_logit": top, "loss_gap": loss_gap,
           "loss_bound": bound["loss"] * top, "dense_loss": dense_loss,
           "rank_loss_by_rank": [r["loss"][0] for r in ranks], **check,
           "bound_C_R": {n: bound[n] for n in ("x_tau", "x0", "x0_before")},
           "m_beta2": beta2, "global_step_bit_equal_from_dense_x_tau": bit_equal,
           "dense_step_ms": step_ms, "dense_peak_bytes": dense_peak,
           "rank_step_ms_by_rank": [r["step_ms"][0] for r in ranks],
           "rank_peaks_bytes": [r["peak_bytes"] for r in ranks],
           "launches_by_rank": [r["launches"] for r in ranks], "dense_launches": launches,
           "collectives_by_rank": [r["comm"] for r in ranks],
           "dense_and_checks_s": time.perf_counter() - t_dense, "ok": ok and not failures}
    return row, failures, launches


def phase_fsdp_full_width(torch, K, smi, fsdp) -> dict:
    """FSDP at full width (FSDP_A, FSDP_B and serving's (b) with the data
    entries cut), run in model_axis_full_width's start of the ranks: per case
    and rank its collectives against the dry-run's reckoning to the byte,
    its launches, its state bytes against the reckoning's, its peak beside
    the reckoning (dryrun_vs_card) and the same grid's without FSDP, its
    step ms; (a) against its dense run here round by round
    (model_axis_bounds, the global step bit for bit from the dense x_tau on
    each rank's zero block); (b) as its ranks held it (bit for bit, or
    within model_axis_bounds, its loss gap in units of the largest logit
    of the dense draw here); (c) bit for bit against serving's (b), its
    collectives serve_collectives' on the data-cut layout; then both
    kernels on (a)'s rank rows.  Returns the launches of the ranks' and the
    dense runs."""

    from repro_torch.core import base_opt, schedules
    from repro_torch.core import dsm as D
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed import zero as Z
    from repro_torch.distributed.comm import scaled_sum
    from repro_torch.groups import each, parts
    from repro_torch.models import convert as C
    from repro_torch.models import transformer as T
    from repro_torch.obs import metrics as OM

    import torch_ranks

    cases, ranks, work = fsdp["cases"], fsdp["ranks"], fsdp["work"]
    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures = [], []
    for i, case in enumerate(cases):
        per_rank = [r[i] for r in ranks]
        cfg, rounds = case["cfg"], len(case["batches"])
        kw, comm_fut, peak_fut, plain_fut = fsdp["reckoned"][i]
        tau = kw["tau"]
        comm_round, kinds = comm_fut.result(timeout=CPU_RUN_TIMEOUT_S)
        mem = peak_fut.result(timeout=CPU_RUN_TIMEOUT_S)
        want_comm = scaled_sum((rounds, comm_round))
        groups = TP.topology_layout(cfg, None).n_groups
        want_launch = {"dsm_update": rounds * groups, "adamw_update": rounds * tau * groups}
        for r in per_rank:
            PEAKS.append((f"fsdp_{case['name']}_{cfg.name}_rank{r['rank']}", r["peak_bytes"],
                          cfg, kw, r["held_bytes"], peak_fut))
            if r["comm"] != want_comm:
                failures.append(f"{case['name']} rank {r['rank']}: collectives {r['comm']}, "
                                f"reckoned {want_comm}")
            if r["launches"] != want_launch:
                failures.append(f"{case['name']} rank {r['rank']}: launches {r['launches']}")
            # the reckoning is rank 0's: its chunk of x0 and m is the first, a full one
            if r["rank"] == 0 and r["state_bytes"] != mem["state_bytes"]:
                failures.append(f"{case['name']} rank {r['rank']}: state {r['state_bytes']} B, "
                                f"reckoned {mem['state_bytes']} B")
            if not all(c["ok"] for c in r["rounds"]):
                failures.append(f"{case['name']} rank {r['rank']}: {r['rounds']}")
            total = {k: n + r["launches"][k] for k, n in total.items()}
        zero_only = zero_only_checks(case, per_rank, kw, failures)
        rows.append({"case": case["name"], "config": cfg.name, "fsdp": case["fsdp"],
                     "zero_sharded": (case.get("algo") or {}).get("zero_sharded", True),
                     **zero_only,
                     "n_workers": case["n_workers"], "grid": per_rank[0]["grid"],
                     "b_micro": kw["b_micro"], "rounds": rounds,
                     "rank_block_numel": per_rank[0]["block_numel"],
                     "rank_peaks_bytes": [r["peak_bytes"] for r in per_rank],
                     "held_bytes_by_rank": [r["held_bytes"] for r in per_rank],
                     "reckoned_peak_bytes": mem["peak_bytes"],
                     "reckoned_peak_bytes_without_fsdp":
                         plain_fut.result(timeout=CPU_RUN_TIMEOUT_S)["peak_bytes"]
                         if plain_fut else None,
                     "state_bytes_by_rank": [r["state_bytes"] for r in per_rank],
                     "reckoned_state_bytes": mem["state_bytes"],
                     "collectives_reckoned_per_round": comm_round,
                     "collectives_by_kind_per_round": kinds,
                     "collectives_by_rank": [r["comm"] for r in per_rank],
                     "launches_by_rank": [r["launches"] for r in per_rank],
                     "step_ms_by_rank": [r["step_ms"] for r in per_rank],
                     "run_s_by_rank": [r["run_s"] for r in per_rank],
                     "case_s_by_rank": [r["case_s"] for r in per_rank],
                     "held_against": case.get("against", (None,))[0],
                     "checks_by_rank": [r["rounds"] for r in per_rank]})

    # a case held within bounds ((b) at B_micro FSDP_B_MICRO): each rank's
    # loss gap within the round's loss bound times the largest logit, that
    # of the dense draw on the round's tokens (its one round starts there)
    for case, row in zip(cases, rows):
        bounds = case.get("against", (None, None))[1]
        if bounds is None:
            continue
        if len(case["batches"]) != 1:
            failures.append(f"{case['name']}: the loss bound's unit is the draw's, one round")
            continue
        cfg = case["cfg"]
        x = T.init_params(torch.Generator("cuda").manual_seed(case["seed"]), cfg, device="cuda")
        tokens = torch.from_numpy(case["batches"][0]["tokens"][0, 0, 0]).to("cuda")
        top = largest_logit(torch, T.layout(cfg).views(x), cfg, tokens)
        del x, tokens
        torch.cuda.empty_cache()
        row.update(largest_logit=top, loss_bound=bounds[0]["loss"] * top)
        for checks in row["checks_by_rank"]:
            if checks[0]["loss_gap"] > row["loss_bound"]:
                failures.append(f"{case['name']}: loss gap {checks[0]['loss_gap']} over "
                                f"{row['loss_bound']}")

    # (a): the dense run here, from the same draw and batches, round by round
    case = cases[0]
    tau = MODEL_AXIS["tau"]
    cfg, W = case["cfg"], case["n_workers"]
    lay = T.layout(cfg)
    lays = [TP.rank_layout(cfg, 1, 0, zero=2, zero_index=z) for z in range(2)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    x0 = T.init_params(torch.Generator("cuda").manual_seed(case["seed"]), cfg, device="cuda")
    base = base_opt.adamw()
    dcfg = D.DSMConfig(tau=tau, global_lr=case["eta"])
    step = D.make_dsm_step(lambda p, mb: T.loss_fn(p, mb, cfg, remat=False), base, dcfg,
                           schedules.constant(case["gamma"]), lay)
    state = D.dsm_init(x0, base, W)
    bounds = model_axis_bounds(cfg.n_layers, len(case["batches"]), tau)
    seen, dense_rounds, m_prev = {}, [], 0.0
    mean_fn, stats_fn = D.worker_mean, OM.loss_stats

    def mean(p):
        seen["x_tau"] = mean_fn(p)
        return seen["x_tau"]

    def loss_stats(losses):
        seen["losses"] = losses.detach().cpu()
        return stats_fn(losses)

    D.worker_mean, OM.loss_stats = mean, loss_stats
    K.reset_launch_counts()
    try:
        for k, raw in enumerate(case["batches"]):
            batch = {n: torch.from_numpy(v).to("cuda") for n, v in raw.items()}
            top = largest_logit(torch, lay.views(state.x0), cfg, batch["tokens"][0, 0, 0])
            before = (each(torch.clone, state.x0), each(torch.clone, state.m))
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            state, _ = step(state, batch)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t1) * 1e3
            total = {n: c + K.launch_counts()[n] for n, c in total.items()}
            x_tau = seen.pop("x_tau")
            saved = [torch.load(work / f"a_0_{z}_{k}.pt", mmap=True, weights_only=False)
                     for z in range(2)]
            tp = {n: C.gather_flat([each(lambda t: t.to("cuda"), sv[n]) for sv in saved],
                                   lay, lays) for n in ("x_tau", "x0", "m")}
            ours = [sv["losses"].mean(0).tolist() for sv in saved]
            del saved
            b = bounds[k]
            dense_loss = seen["losses"].mean(0).tolist()
            loss_gap = max(abs(x - y) for t in ours for x, y in zip(t, dense_loss))
            check, m_prev = torch_ranks.round_check(
                tp, {"x_tau": x_tau, "x0": state.x0, "m": state.m}, before[0], b,
                case["gamma"], DSM_HP["beta2"], m_prev)
            bit_equal = True
            for rl in lays:
                xb, mb = C.shard_flat(before[0], lay, rl), C.shard_flat(before[1], lay, rl)
                D.global_sign_momentum_step(xb, mb, C.shard_flat(x_tau, lay, rl),
                                            case["gamma"], dcfg)
                bit_equal &= all(same_bits(torch, p, q) for p, q in zip(
                    parts(xb) + parts(mb), parts(C.shard_flat(state.x0, lay, rl))
                    + parts(C.shard_flat(state.m, lay, rl))))
                del xb, mb
            K.reset_launch_counts()         # the checks' launches are no run's
            ok = check["ok"] and loss_gap <= b["loss"] * top and bit_equal
            dense_rounds.append({"round": k, "largest_logit": top, "loss_gap": loss_gap,
                                 "loss_bound": b["loss"] * top,
                                 "dense_loss_per_worker": dense_loss,
                                 "fsdp_loss_per_worker_by_zero_rank": ours, **check,
                                 "bound_C_R": {n: b[n] for n in ("x_tau", "x0", "x0_before")},
                                 "global_step_bit_equal_from_dense_x_tau": bit_equal,
                                 "dense_step_ms": step_ms, "ok": ok})
            if not ok:
                failures.append(f"a round {k}: {dense_rounds[-1]}")
            del tp, x_tau, before
    finally:
        D.worker_mean, OM.loss_stats = mean_fn, stats_fn
    dense_peak = torch.cuda.max_memory_allocated()
    del state, step, x0
    torch.cuda.empty_cache()

    # (d), each against its dense run
    algo_rows = []
    for j, run in enumerate(fsdp["algo_cases"]):
        per_rank = [r[len(cases) + j] for r in ranks]
        zl = [TP.rank_layout(run["cfg"], 1, 0, zero=2, zero_index=z) for z in range(2)]

        def saved(name=run["name"], zl=zl):
            return zl, [torch.load(work / f"{name}_0_{z}_0.pt", mmap=True, weights_only=False)
                        for z in range(2)]

        row, bad, launches = check_algorithm_run(
            torch, K, dict(run, worker=2, zero=2), per_rank, saved,
            lambda r, zl=zl: zl[r["zero_index"]])
        row["case_s_by_rank"] = [r["case_s"] for r in per_rank]
        algo_rows.append(row)
        failures += bad
        total = {n: c + launches[n] + sum(r["launches"][n] for r in per_rank)
                 for n, c in total.items()}

    # (c): serving with the data entries cut against serving's (b)
    served, plain = fsdp["served"]
    scfg, model, _, prompt, new, _, _ = fsdp["serve_case"]
    serve_rows = []
    for r, q in zip(served, plain):
        slay = TP.rank_layout(scfg, model, r["model_index"], zero=RANKS // model,
                              zero_index=r["data_index"], zero_axes=("data",))
        bm = r["rows"][1] - r["rows"][0]
        parts_ = [(1, TP.serve_collectives(scfg, slay, bm, prompt.shape[1], k)) for k in
                  ("serving_params", "prefill")]
        parts_ += [(new - 1, TP.serve_collectives(scfg, slay, bm, prompt.shape[1], "decode")),
                   (new, TP.serve_collectives(scfg, slay, bm, prompt.shape[1], "pick"))]
        if bm < prompt.shape[0]:
            parts_.append((1, {"all_gather@data": {"calls": 1, "bytes": bm * new * 8}}))
        want = scaled_sum(*parts_)
        same = torch.equal(r["tokens"], q["tokens"]) and len(r["logits"]) == len(q["logits"]) \
            and all(same_bits(torch, a, b) for a, b in zip(r["logits"], q["logits"]))
        serve_rows.append({"rank": r["rank"], "tokens_and_logits_bit_equal": same,
                           "params_bytes": r["params_bytes"],
                           "params_bytes_data_replicated": q["params_bytes"],
                           "peak_bytes": r["peak_bytes"], "peak_bytes_data_replicated":
                           q["peak_bytes"], "prefill_s": r["prefill_s"],
                           "tok_per_s": r["tok_per_s"], "tok_per_s_data_replicated":
                           q["tok_per_s"], "collectives": r["comm"], "reckoned": want})
        if not same or r["comm"] != want:
            failures.append(f"serving rank {r['rank']}: bit equal {same}, collectives "
                            f"{r['comm']}, reckoned {want}")

    # both kernels on (a)'s rank rows: its zero block, its chunk over its
    # peers; (e)'s DSM over the whole zero block
    worker = ranks[0][0]["grid"][0]
    kernels = rank_kernel_times(torch, K, lays[0], [Z.chunk_size(lays[0].numel, worker)],
                                W // worker)
    kernels += [dsm_time_row(torch, K, n, dt) for n, dt in zip(lays[0].group_numels,
                                                                lays[0].dtypes)]
    for c in kernels:
        if c.get("max_abs_err", 0.0) != 0.0:
            failures.append(f"kernel on the rank rows: {c}")
    shutil.rmtree(work, ignore_errors=True)
    emit({"phase": "fsdp_full_width", "gpu": smi, "ranks": RANKS, "backend": "gloo",
          "tau": {"a": tau, "b": FSDP_B_TAU}, "seq": MODEL_AXIS["seq"], "gamma": MODEL_AXIS_GAMMA,
          "eta": MODEL_AXIS_ETA, "ranks_s_with_model_axis_full_width": fsdp["ranks_s"],
          "cases": rows, "a_against_dense": dense_rounds, "a_dense_peak_bytes": dense_peak,
          "algorithms": algo_rows,
          "serving_data_cut": serve_rows, "kernels_on_rank_rows": kernels})
    if failures:
        raise AssertionError(f"fsdp_full_width: {failures}")
    return total


def zero_only_checks(case, per_rank, kw, failures) -> dict:
    """(e)'s checks beyond the other FSDP cases' (a case whose x0 and m lie
    over zero only, ``algo`` FSDP_E; else nothing): each rank's collectives
    ``tensor_parallel.round_collectives(..., zero_sharded=False)``'s to the
    byte, its worker peers' x0 and m the same bits every round (their
    SHA-256s), its x0 the whole zero block."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.comm import scaled_sum

    if case.get("algo") != FSDP_E:
        return {}
    cfg, rounds = case["cfg"], len(case["batches"])
    worker, zero, model = per_rank[0]["grid"]
    peers: dict = {}
    for r in per_rank:
        lay = TP.rank_layout(cfg, model, r["index"], zero=zero, zero_index=r["zero_index"])
        want = scaled_sum((rounds, TP.round_collectives(
            cfg, lay, case["n_workers"], worker, zero, kw["tau"], kw["b_micro"], kw["seq"],
            zero_sharded=False)))
        if r["comm"] != want:
            failures.append(f"{case['name']} rank {r['rank']}: collectives {r['comm']}, "
                            f"round_collectives {want}")
        peers.setdefault((r["zero_index"], r["index"]), []).append(r["digests"])
    alike = all(d == group[0] for group in peers.values() for d in group)
    if not alike or any(len(g) != worker for g in peers.values()):
        failures.append(f"{case['name']}: worker peers' x0 / m digests {peers}")
    return {"worker_peers_x0_m_bit_identical": alike,
            "x0_m_digests_by_zero_and_model_index": {f"{z}_{m}": g[0]
                                                     for (z, m), g in peers.items()}}


def dsm_time_row(torch, K, n: int, dt) -> dict:
    """The DSM kernel over ``n`` elements of ``dt`` (x0 in ``dt``, m f32):
    bit for bit against its plain version, timed with it (CUDA events,
    median) beside its byte bound."""
    from repro_torch.kernels.dsm_update import dsm_update_plain

    es = torch.empty((), dtype=dt).element_size()
    gen = torch.Generator(device="cuda").manual_seed(8)
    x0, m, xt = dsm_inputs(torch, gen, n, dt)
    ox, om = x0.clone(), m.clone()
    K.dsm_update(x0, m, xt, 0.02, **DSM_HP)
    dsm_update_plain(ox, om, xt, 0.02, **DSM_HP)
    err = compare(torch, (x0, m), (ox, om))
    row = {"kernel": "dsm_update", "shape": [n], "dtype": str(dt), "max_abs_err": err,
           "ms": median_ms(torch, lambda: K.dsm_update(x0, m, xt, 0.02, **DSM_HP)),
           "plain_ms": median_ms(torch, lambda: dsm_update_plain(x0, m, xt, 0.02, **DSM_HP))}
    row["bound_ms"], row["bound_by"] = bound_ms(n * (3 * es + 2 * 4), n * 12)
    del x0, m, xt, ox, om
    torch.cuda.empty_cache()
    return row


def serve_model_axis_cases(torch, pool) -> list:
    """SERVE_MA_CASES as ``((cfg, model ranks, seed, prompt, new, extra),
    the future of dryrun.reckon_serve's reckoning of a rank's generate)``:
    the prompts corpus tokens (CPU int64), a VLM's ``extra`` its seeded f32
    patches (CPU), the reckonings running in the CPU pool meanwhile."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import load_arch

    rng = np.random.default_rng(13)
    out = []
    for i, (arch, layers, dtype, model, (batch, prompt_len, new), *fields) in enumerate(
            SERVE_MA_CASES):
        cfg = depth_cut(arch, layers) if layers else load_arch(arch).FULL
        if dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype,
                                      name=f"{cfg.name}_{dtype}")
        if fields:
            cfg = dataclasses.replace(cfg, **fields[0],
                                      name=f"{cfg.name}_{'_'.join(sorted(fields[0]))}")
        prompt = torch.as_tensor(training_corpus().sample(rng, batch, prompt_len),
                                 dtype=torch.long)
        extra = {}
        if cfg.family == "vlm":
            extra["patches"] = torch.from_numpy(rng.standard_normal(
                (batch, cfg.n_patches, cfg.d_model), dtype=np.float32))
        elif cfg.family == "encdec":
            extra["frames"] = torch.from_numpy(rng.standard_normal(
                (batch, cfg.enc_len, cfg.d_model), dtype=np.float32))
        out.append(((cfg, model, 31 + i, prompt, new, extra),
                     pool.submit(reckon_serve_generate, cfg, batch, prompt_len,
                                 RANKS // model, model, new)))
    return out


def reckon_serve_generate(cfg, batch, prompt_len, data, model, new) -> dict:
    """dryrun.reckon_serve's reckoning of rank 0's generate, in a CPU worker
    process."""
    from repro_torch.launch.dryrun import reckon_serve

    return reckon_serve(cfg, "generate", batch, prompt_len, data=data, model=model, new=new)


def phase_serve_model_axis_full_width(torch, smi, served) -> None:
    """generate on the (data, model) grid at full width (SERVE_MA_CASES),
    served in model_axis_full_width's start of the ranks, each case held
    against the dense model drawn here from the same seed: the ranks'
    per-step logits (prefill's, then each decode step's; assembled over
    data rows and vocab blocks) against the dense f32 model's at every
    step (a bf16 case within SERVE_NOISE_FACTOR times the dense bf16
    model's distance from it; the f32 case within SERVE_MA_F32_RTOL of its
    largest |logit|), the dense model teacher-forced along the ranks'
    tokens; every token the argmax (lowest id on ties) of the ranks' own
    assembled logits over the unpadded vocab, at every step; every token
    whose dense top-2 margin exceeds its step's gate the dense argmax, at
    least one so decided; the model group's tokens alike; where the batch
    does not split over data (cases (j)-(l): the prompt's positions and the
    global caches' slots over data, ``tensor_parallel.serve_split``) every data rank's
    logits the same bits at every step; per rank its
    peak beside reckon_serve's reckoning plus the bytes it holds beside its
    blocks when the call starts (DRYRUN_RTOL), its collectives equal to
    serve_collectives' to the byte, its cache bytes beside the reference
    placement's; per rank and dense, prefill seconds and decode tokens/s
    (host clock after cuda.synchronize)."""
    import dataclasses

    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.distributed.comm import scaled_sum
    from repro_torch.launch.dryrun import cache_bytes, collectives
    from repro_torch.models import transformer as T
    from repro_torch.train.serve import generate
    from repro_torch.train.trainer import set_matmul_precision

    set_matmul_precision()
    serving, per_case, ranks_s = served
    rows, failures = [], []
    for ((cfg, M, seed, prompt, new, extra), fut), ranks in zip(serving, per_case):
        t_dense = time.perf_counter()
        B, S = prompt.shape
        D, V = RANKS // M, cfg.padded_vocab
        n0 = S + (cfg.n_patches if cfg.family == "vlm" else 0)     # the prefill's positions
        f32 = cfg.param_dtype == "float32"
        toks = ranks[0]["tokens"]
        agree = all(torch.equal(r["tokens"], toks) for r in ranks)
        # the ranks that serve the same rows at one model index (every data
        # rank where the batch does not split) hold the same logits' bits
        by_place: dict = {}
        for r in ranks:
            by_place.setdefault((r["rows"], r["model_index"]), []).append(r["logits"])
        data_alike = all(all(torch.equal(a, b) for a, b in zip(g[0], o))
                         for g in by_place.values() for o in g[1:])
        tp = [torch.full((B, V), float("nan")) for _ in range(new)]
        for r in ranks:
            n = r["logits"][0].shape[-1]
            cols = (slice(r["model_index"] * n, (r["model_index"] + 1) * n) if n < V
                    else slice(None))
            for i, lg in enumerate(r["logits"]):
                tp[i][slice(*r["rows"]), cols] = lg
        # the ranks' own pick, exactly: each token the argmax (lowest id on
        # ties) of the ranks' assembled logits over the unpadded vocab
        covered = not any(t.isnan().any() for t in tp)
        own_pick = covered and torch.equal(
            torch.stack([t[:, :cfg.vocab_size].argmax(-1) for t in tp], dim=1), toks)

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        x0 = T.init_params(torch.Generator("cuda").manual_seed(seed), cfg, device="cuda")
        params = T.layout(cfg).views(x0)
        pc, tc = prompt.to("cuda"), toks.to("cuda")
        ec = {k: v.to("cuda") for k, v in extra.items()} or None
        generate(params, cfg, pc[:, :8], 2, extra_batch=ec, device="cuda")       # warm-up
        dtoks, dstats = generate(params, cfg, pc, new, extra_batch=ec, device="cuda")
        with torch.no_grad():
            dense = list(forced_steps(torch, params, cfg, pc, tc, ec))
        tp_c = [t.to("cuda") for t in tp]
        if f32:
            gate = [SERVE_MA_F32_RTOL * d.abs().max().item() for d in dense]
            tp_err = [(a - d).abs().max().item() for a, d in zip(tp_c, dense)]
            dense_err = None
        else:
            cfg32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
            params32 = {k: v.float() for k, v in params.items()}
            ref = one_pass_logits(torch, params32, cfg32, pc, tc, ec)
            del params32
            dense_err = [(d - ref[:, i]).abs().max().item() for i, d in enumerate(dense)]
            tp_err = [(a - ref[:, i]).abs().max().item() for i, a in enumerate(tp_c)]
            del ref
            gate = [SERVE_NOISE_FACTOR * e for e in dense_err]
        decided = equal = 0
        margins = []
        for i, d in enumerate(dense):
            lg = d[:, :cfg.vocab_size]
            top2 = torch.topk(lg, 2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            margins.append(margin.tolist())
            sure = margin > gate[i]
            decided += int(sure.sum())
            equal += int((sure & (lg.argmax(-1) == tc[:, i])).sum())
        same_prefix = [int(torch.cumprod((dtoks.cpu() == toks).long(), dim=1)[b].sum())
                       for b in range(B)]
        dense_peak = torch.cuda.max_memory_allocated()
        del x0, params, dense, tp_c, pc, tc, dtoks, ec
        torch.cuda.empty_cache()

        rec = fut.result(timeout=CPU_RUN_TIMEOUT_S)
        lay0 = TP.rank_layout(cfg, M, 0)
        b = ranks[0]["rows"][1] - ranks[0]["rows"][0]
        chunk0, slots0 = TP.serve_split(B, n0, new, cfg, D, 0)
        layout_cache = cache_bytes(T.init_cache(cfg, b, n0 + new, device="meta", layout=lay0,
                                                slots=slots0))
        per_rank, comm_ok, peak_ok = [], True, True
        for r in ranks:
            lay = TP.rank_layout(cfg, M, r["model_index"])
            chunk, slots = TP.serve_split(B, n0, new, cfg, D, r["data_index"])
            parts_ = [(1, TP.serve_collectives(cfg, lay, b, n0, "serving_params")),
                      (1, TP.serve_collectives(cfg, lay, b, n0, "prefill", chunk=chunk)),
                      (new - 1, TP.serve_collectives(cfg, lay, b, n0, "decode", slots=slots)),
                      (new, TP.serve_collectives(cfg, lay, b, n0, "pick"))]
            if b < B:
                parts_.append((1, {"all_gather@data": {"calls": 1, "bytes": b * new * 8}}))
            want = scaled_sum(*parts_)
            # the reckoning of the call, plus what the rank holds beside its
            # blocks when it starts (the prompt, the cuBLAS workspace)
            ratio = (rec["memory"]["peak_bytes"] + r["held_bytes"]) / r["peak_bytes"]
            comm_ok &= r["comm"] == want == rec["comm"]
            peak_ok &= abs(ratio - 1) <= DRYRUN_RTOL
            per_rank.append({"rank": r["rank"], "data_index": r["data_index"],
                             "model_index": r["model_index"], "rows": r["rows"],
                             "prefill_s": r["prefill_s"], "decode_s": r["decode_s"],
                             "case_s": r["case_s"],
                             "decode_tok_per_s": r["tok_per_s"], "peak_bytes": r["peak_bytes"],
                             "params_bytes": r["params_bytes"], "held_bytes": r["held_bytes"],
                             "reckoned_over_measured_peak": ratio,
                             "collectives": r["comm"], "collectives_by_kind": collectives(
                                 r["comm"])})
        # with attn_seq_shard: each rank's cache the same bits as its
        # prefill's without the flag
        sp_cache = [r["sp_cache"] for r in ranks if "sp_cache" in r]
        sp_ok = all(c["bytes"] == c["bytes_without"] and c["bytes_differing"] == 0
                    for c in sp_cache)
        ok = (agree and own_pick and all(e <= g for e, g in zip(tp_err, gate)) and decided > 0
              and equal == decided and comm_ok and peak_ok and data_alike and sp_ok
              and rec["memory"]["cache_bytes_per_rank"] == layout_cache)
        rows.append({"config": cfg.name, "n_layers": cfg.n_layers, "param_dtype": cfg.param_dtype,
                     "grid": {"data": D, "model": M}, "n_params": T.layout(cfg).numel,
                     "seq_over_data": chunk0 is not None,
                     "cache_slots_over_data": slots0 is not None,
                     "data_ranks_logits_bit_equal": data_alike,
                     "attn_seq_shard": cfg.attn_seq_shard,
                     "sp_cache_by_rank": sp_cache or None,
                     "rank_block_numel": lay0.numel, "batch": B, "prompt_tokens": S,
                     "new_tokens": new, "model_group_tokens_agree": agree,
                     "tokens_are_argmax_of_ranks_logits": own_pick,
                     "per_step_gap": tp_err, "per_step_gate": gate,
                     "dense_bf16_vs_f32_per_step": dense_err,
                     "dense_top2_margin_per_step": margins,
                     "tokens_decided": decided, "tokens_equal_where_decided": equal,
                     "dense_generate_same_prefix_by_row": same_prefix,
                     "dense": {"prefill_s": dstats["prefill_s"], "decode_s": dstats["decode_s"],
                               "decode_tok_per_s": dstats["tok_per_s"],
                               "peak_bytes": dense_peak},
                     "ranks": per_rank, "reckoned_peak_bytes": rec["memory"]["peak_bytes"],
                     "cache_bytes_per_rank": {"layout": layout_cache,
                                              "reckoned": rec["memory"]["cache_bytes_per_rank"],
                                              "reference_placement": rec["memory"][
                                                  "cache_bytes_per_rank_reference_placement"]},
                     "collectives_reckoned": rec["comm"], "tokens": toks[0].tolist(),
                     "dense_and_checks_s": time.perf_counter() - t_dense, "ok": ok})
        if not ok:
            failures.append(rows[-1])
    emit({"phase": "serve_model_axis_full_width", "gpu": smi, "ranks": RANKS, "backend": "gloo",
          "factor": SERVE_NOISE_FACTOR, "f32_rtol": SERVE_MA_F32_RTOL,
          "ranks_s_with_model_axis_full_width": ranks_s, "cases": rows})
    if failures:
        raise AssertionError(f"serve_model_axis_full_width: {failures}")


def reckon_comm(cfg, kw: dict) -> tuple:
    """The dry-run's reckoning of one round's collectives of a rank (per
    CommStats name, and per kind), in a CPU worker process."""
    from repro_torch.launch.dryrun import collectives, reckon_train

    comm = reckon_train(cfg, **kw)["comm"]
    return comm, collectives(comm)


def model_axis_kernel_checks(torch, K, lay, n_workers) -> list:
    """Both kernels against their plain versions, bit for bit, on a model
    rank's blocks: the DSM step over its (N / M,) buffers (0 / -0 / NaN
    planted), AdamW over its (W, N / M) rows, both roundings."""
    from repro_torch.kernels.adamw_update import adamw_update_plain
    from repro_torch.kernels.dsm_update import dsm_update_plain

    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = []
    for n, dt in zip(lay.group_numels, lay.dtypes):
        x0, m, xt = dsm_inputs(torch, gen, n, dt)
        ka, kb = (x0.clone(), m.clone()), (x0.clone(), m.clone())
        K.dsm_update(ka[0], ka[1], xt, 0.02, **DSM_HP)
        dsm_update_plain(kb[0], kb[1], xt, 0.02, **DSM_HP)
        torch.cuda.synchronize()
        cases.append({"kernel": "dsm_update", "shape": [n], "dtype": str(dt),
                      "max_abs_err": compare(torch, ka, kb)})
        del x0, m, xt, ka, kb
        p, g, mm, v = adamw_inputs(torch, gen, (n_workers, n), dt)
        for rd in (False, True):
            ka, kb = (p.clone(), mm.clone(), v.clone()), (p.clone(), mm.clone(), v.clone())
            K.adamw_update(ka[0], g, ka[1], ka[2], 1e-3, 11, round_direction=rd, **ADAMW_HP)
            adamw_update_plain(kb[0], g, kb[1], kb[2], 1e-3, 11, round_direction=rd,
                               **ADAMW_HP)
            torch.cuda.synchronize()
            cases.append({"kernel": "adamw_update", "shape": [n_workers, n], "dtype": str(dt),
                          "round_direction": rd, "max_abs_err": compare(torch, ka, kb)})
            del ka, kb
        del p, g, mm, v
        torch.cuda.empty_cache()
    return cases


def example_module(name: str):
    """examples/<name>.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_runs(mod, name: str, steps: int) -> list:
    """The TrainSettings of each run_training call the example makes."""
    if name == "torch_quickstart":
        return list(mod.settings(steps).values())
    if name == "torch_train_gpt2_dsm":
        return [mod.build(mod.parse(["--steps", str(steps)]))[1]]
    return [mod.settings(steps)]


def phase_examples_card(torch, K, smi) -> dict:
    """EXAMPLES on the card (see EXAMPLE_STEPS): each main's results, its
    seconds (host clock after cuda.synchronize) and its launches; its
    printed lines kept apart, their tail in the phase line.  Returns the
    launches."""
    import contextlib
    import io

    total = dict.fromkeys(K.launch_counts(), 0)
    rows, failures = [], []
    for name in EXAMPLES:
        mod = example_module(name)
        want = dict.fromkeys(total, 0)
        for s in example_runs(mod, name, EXAMPLE_STEPS):
            want = {k: n + expected_launches(s)[k] for k, n in want.items()}
        printed = io.StringIO()
        K.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            out = mod.main(["--steps", str(EXAMPLE_STEPS)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = K.launch_counts()
        runs = out if name == "torch_quickstart" else {"run": out}
        losses = {k: r["history"] + [r["final_eval"]] for k, r in runs.items()}
        row = {"example": name, "seconds": seconds, "outer_steps": EXAMPLE_STEPS,
               "losses": losses, "launches": launches, "want_launches": want,
               "printed_tail": printed.getvalue().splitlines()[-4:]}
        if name == "torch_serve_model":
            row.update(completions=out["completions"], prefill_s=out["prefill_s"],
                       tok_per_s=out["tok_per_s"])
            if tuple(out["tokens"].shape) != (len(mod.PROMPTS), mod.NEW_TOKENS):
                failures.append(f"{name}: tokens {tuple(out['tokens'].shape)}")
        if not all(math.isfinite(x) for v in losses.values() for x in v):
            failures.append(f"{name}: losses {losses}")
        if launches != want or not (want["dsm_update"] and want["adamw_update"]):
            failures.append(f"{name}: launches {launches}, want {want}")
        rows.append(row)
        total = {k: n + launches[k] for k, n in total.items()}
    emit({"phase": "examples_card", "gpu": smi, "examples": rows})
    if failures:
        raise AssertionError(f"examples_card: {failures}")
    return total


def phase_dryrun_vs_card(pool, smi) -> None:
    """Every full-width run's measured peak (PEAKS: main_path, gpt2_medium
    and large, gemma3_1b, granite, whisper, recurrentgemma, mamba2 with
    and without remat, granite's rank 0 of RANKS) beside the dry-run's
    reckoning of the same run on meta tensors (in the CPU pool): the state
    with the round's batch, plus the largest of the local phase's, the
    global step's and the eval's high-water marks, plus what the script
    holds on the card beside the run; no fitted constant.  Each within
    DRYRUN_RTOL of its measured peak."""
    futures = [fut or pool.submit(reckon_peak, cfg, kw) for _, _, cfg, kw, _, fut in PEAKS]
    rows, failures = [], []
    for (name, peak, cfg, kw, held, _), fut in zip(PEAKS, futures):
        mem = fut.result(timeout=CPU_RUN_TIMEOUT_S)
        reckoned = mem["peak_bytes"] + held
        rows.append({"run": name, "measured_bytes": peak, "reckoned_bytes": reckoned,
                     "reckoned_over_measured": reckoned / peak,
                     "components": {**mem, "held_by_the_script": held},
                     "settings": {k: v for k, v in kw.items()}})
        if abs(reckoned / peak - 1) > DRYRUN_RTOL:
            failures.append(f"{name}: reckoned {reckoned} B, measured {peak} B")
    emit({"phase": "dryrun_vs_card", "gpu": smi, "rtol": DRYRUN_RTOL, "runs": rows})
    if failures or not rows:
        raise AssertionError(f"dryrun_vs_card: {failures or 'no run measured a peak'}")


def recurrent_phases(torch, K, smi, pool) -> tuple:
    """The phases of the recurrent mixers: both kernels bit for bit at each
    dtype group's shape of the two paths (recurrent_kernel_checks), both
    models trained through run_training (recurrent_full_width), each served
    on its trained x0 and held against its full forward
    (serve_recurrent_full_width: RecurrentGemma's prompt past its window,
    Mamba-2's four SSD chunks), and card vs CPU for both SMOKE configs and
    RecurrentGemma's SMOKE with bf16 parameters (recurrent_card_vs_cpu).
    Returns (their runs' launches, the kernel checks' worst errors)."""
    import dataclasses

    from repro_torch.configs import load_arch, recurrentgemma_2b

    paths = recurrent_paths(torch)
    errs = phase_group_kernel_checks(torch, K, "recurrent_kernel_checks",
                                     [(cfg, s) for cfg, s, *_ in paths])
    total, trained, _ = phase_window_moe_full_width(torch, K, smi, "recurrent_full_width",
                                                    paths)
    for (cfg, x0), (b, prompt, new) in zip(trained, (SERVE_RG, SERVE_MAMBA)):
        serve_check(torch, smi, "serve_recurrent_full_width", cfg, x0, b, prompt, new,
                    per_add_bound="only" if cfg.name.startswith("recurrentgemma") else False,
                    noise_bound=cfg.name.startswith("mamba2"))
    del trained, x0, paths
    torch.cuda.empty_cache()
    more = phase_remat_full_width(torch, K, smi)
    total = {k: n + more[k] for k, n in total.items()}
    # RecurrentGemma's SMOKE with bf16 parameters (activations f32, as the
    # SMOKE's): two dtype groups, lam f32
    bf16p = dataclasses.replace(recurrentgemma_2b.SMOKE, param_dtype="bfloat16",
                                name="recurrentgemma_smoke_bf16_params")
    configs = [(load_arch(a).SMOKE, load_arch(a).TOPO) for a in RECURRENT_SMOKES]
    configs.append((bf16p, recurrentgemma_2b.TOPO))
    more = card_vs_cpu_runs(torch, K, pool, "recurrent_card_vs_cpu", configs, serve=True)
    return {k: n + more[k] for k, n in total.items()}, errs


def slice_phases(torch, K, smi, pool) -> dict:
    """The phases of the paper's GPT-2 sizes, the arch registry and serving;
    returns their runs' launches.  serve_full_width serves the x0 that
    paper_sizes_full_width trained."""
    phase_kernels_past_2g(torch, K)
    total, x0_large = phase_paper_sizes_full_width(torch, K, smi)
    phase_serve_full_width(torch, smi, x0_large)
    del x0_large
    phase_serve_card_vs_cpu(torch)
    more = phase_archs_card_vs_cpu(torch, K, pool)
    return {k: n + more[k] for k, n in total.items()}


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke test needs the card")
    if not (ROOT / "src" / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests"))     # torch_ranks: what each rank process runs
    from repro_torch import kernels as K
    from repro_torch.kernels import _build

    smi = nvidia_smi()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "dir": str(_build.BUILD_DIR),
          "ptxas": {k: [ln.strip() for ln in v.splitlines() if "registers" in ln]
                    for k, v in logs.items()}})

    pool = RECKON["pool"] = cpu_worker()
    try:
        launches, errs, times = all_phases(torch, K, smi, pool)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    sources = {"dsm_update": ("src/repro_torch/kernels/csrc/dsm_update.cu",
                              "src/repro/kernels/dsm_update.py:30"),
               "adamw_update": ("src/repro_torch/kernels/csrc/adamw_update.cu",
                                "src/repro/kernels/adamw_update.py:24")}
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         **{k: times[name][k] for k in keys}}
        for name, (src, rep) in sources.items()]})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def all_phases(torch, K, smi, pool):
    """Every phase in order; returns (launches of the runs, the kernel
    checks' worst errors, the kernel times)."""
    errs = phase_checks(torch, K)
    times = phase_times(torch, K, smi)
    launches, main_cost = phase_main_path(torch, K, smi)
    phase_card_vs_cpu(torch, pool)
    counts = [phase_algorithms_full_width(torch, K, smi),
              phase_algorithms_card_vs_cpu(torch, K, pool),
              phase_robustness_full_width(torch, K, smi, main_cost)]
    more, dense_cut = phase_resume_full_width(torch, K, smi)
    counts += [more,
               phase_obs_full_width(torch, K, smi, dense_cut),
               phase_robustness_card_vs_cpu(torch, K, pool),
               phase_ranks_full_width(torch, K, smi, dense_cut),
               phase_zero_nccl_world1(torch, K),
               phase_zero_card_vs_cpu(torch, K),
               phase_audit_card(torch, K, smi),
               phase_examples_card(torch, K, smi),
               slice_phases(torch, K, smi, pool)]
    for phases in (window_moe_phases, encdec_vlm_phases, recurrent_phases):
        more, group_errs = phases(torch, K, smi, pool)
        counts.append(more)
        errs = {k: max(e, group_errs[k]) for k, e in errs.items()}
    for more in counts:
        launches = {k: n + more[k] for k, n in launches.items()}
    more, served, fsdp = phase_model_axis_full_width(torch, K, smi, pool)
    launches = {k: n + more[k] for k, n in launches.items()}
    phase_serve_model_axis_full_width(torch, smi, served)
    del served
    more = phase_fsdp_full_width(torch, K, smi, fsdp)
    launches = {k: n + more[k] for k, n in launches.items()}
    del fsdp
    phase_dryrun_vs_card(pool, smi)
    return launches, errs, times


if __name__ == "__main__":
    main()
