"""Drives the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases (each raises on failure; the script then exits non-zero and
prints no result line):

1. build the port's CUDA kernels from ``deepspeed_tpu_torch/csrc``;
2. hold each serving kernel against its plain PyTorch version on the
   card at the serving path's shapes (decode, a two-query chunk, a chunk
   that is no multiple of the query tile, a 512-token prefill chunk; fp32,
   bf16 and int8 pages; fp16 queries over fp16, bf16 and int8 pages at
   C = 1, 2 and 512; band attention for 8 and 1024 queries in fp32, bf16
   and fp16; and,
   untimed, head dim 128 with 48-token pages and head dim 64 with 5-token
   pages for decode, head dims 64 and 128 with 128- and 48-token pages for
   the band, there with queries at position 0, inside the first page and
   at a page's first and last tokens), and time kernel, plain version, one
   PyTorch library call computing the same attention (a yardstick only),
   and the least time the card could take (the bound); then show bit for
   bit that a query's output does not depend on the batch, the table
   width or the chunk around it (for the band: a query alone equals its
   row among 8 and among all the case's queries), and that a one-token
   prompt's prefill alone equals its row of a bucket-wide prefill chunk;
3. serve GPT-2 XL at full width and 24 of its 48 layers (random weights
   from seed 0, bf16) with the continuous-batching engine on the kernel
   backends, and show that both kernels launched;
4. at full width and 24 of 48 layers in fp32, hold every served request's
   greedy tokens
   against the one-shot ``generate()`` on the same backend;
5. hold the three flash-attention kernels (forward, dq, dk/dv/dbias)
   against their plain versions at the BERT-large training shapes (bf16
   and fp32, padded keys, causal, a block-16 sparse layout with an empty
   row, dropout 0.1 on the same Philox bits; head dims 128 and 32 and
   longer sequences in blocks of 64 and 32 once each; fp16 padded with
   dropout, causal, head dim 128 and S = 512 in blocks of 64), and time
   them as phase 2 does, with ``scaled_dot_product_attention`` and its
   backward as the yardsticks (dq + dk/dv beside the whole backward);
   then an fp16 backward with dO times a loss scale near fp16's range,
   where kernels and plain versions must overflow in the same grads;
6. train BERT-large at full width through ``initialize()`` (Adam, bf16,
   ZeRO 0, activation checkpointing "dots", micro-batch 64, seq 128,
   dropout 0.1) on one repeated random batch, show that all three flash
   kernels launched, that every loss is finite and that the loss falls,
   and profile one step (bf16 dq must run on the tensor-core kernel);
   then train it in fp16 with LAMB, gradient clipping, WarmupDecayLR and
   dynamic loss scaling over ``training_data=`` through ``train_batch()``:
   the fp16 kernels must launch 48/24/24 times a step, the loss fall and
   every step run at the schedule's LR (held on a skipped step);
7. at BERT-large width with 2 layers and dropout 0.1, in fp32, bf16 and
   fp16, hold the loss and every parameter's gradient on the kernels
   against the same model with the plain attention versions swapped in;
8. (``zero``) hold the host Adam of ZeRO-Offload (``csrc/cpu_adam.cpp``,
   built by g++) against its plain version bit for bit on this machine's
   CPU at BERT-large's 336,232,258 elements, and time it beside its plain
   version, ``torch._fused_adamw_`` and its bound (28 bytes an element
   at the fastest of four host memory streams); start NCCL at world 1
   and train phase 6's bf16 Adam BERT-large (3 of its 24 layers) 3 steps
   at ZeRO stages 0, 0 again, 1, 2 and 3 and ZeRO-2 + ``cpu_offload``
   sequential and
   streamed (4 buckets) under deterministic algorithms: each stage's
   losses and final masters must equal stage 0's, and streamed
   sequential's, bit for bit; then, under the default algorithms,
   stage 0, offload sequential and offload streamed at 6 of the 24
   layers, 3 warm-up and 10 timed steps each: the loss
   must fall, peak device memory under offload stay below stage 0's, and
   the flash kernels launch 12/6/6 times a step; last, report whether stage 0 run twice under the
   default algorithms agrees with itself, and which embedding-backward
   kernels each mode launches;
9. (``ckpt``) checkpoint and resume at BERT-large's width and 3 of its
   24 layers, phase 6's
   bf16 Adam, under deterministic algorithms, at ZeRO stage 0 (with the
   ``telemetry`` block armed), ZeRO-2 + ``cpu_offload`` streamed (4
   buckets) and ZeRO-3 through NCCL at world 1: train 3 steps, save, train
   3 more; a fresh engine from init seed 99 loads the tag and trains the
   same 3 steps, whose losses and final fp32 masters must equal the
   uninterrupted run's (``torch.equal``) while the flash kernels launch
   6/3/3 times a step; ``zero_to_fp32`` of the offload tag must equal
   the masters at the save; the stage-0 trace must hold
   ``train/checkpoint_save``, ``checkpoint/commit`` and the step spans
   (written to ``build/ckpt_trace.json``). Tags go to a temporary
   directory under ``build/``, one at a time; too little free space for
   2.5 tags fails the phase. Printed: each tag's bytes, save and load
   seconds and GB/s, the save's D2H, serialization, digest and write
   seconds, the free space and host RAM, and (report only) the bf16 step
   with telemetry armed and disarmed, in turns;
10. (``resil``) resilience at BERT-large's width and 2 of its 24 layers,
   phase 6's bf16 Adam at ZeRO 0 under deterministic algorithms, NCCL at
   world 1:
   a. in process: a clean run of 6 steps over 6 seeded batches, then the
      same with a ``resilience`` block (divergence check, 2 recoveries, a
      60 s step watchdog, so every step after the first runs on the
      watchdog's thread) and a NaN loss injected at step 4 after a save at
      step 2: one recovery, and the 6 losses and the final masters
      ``torch.equal`` to the clean run's; the flash kernels launch
      4/2/2 on every step that runs, the failing one and the replays
      included. Report only: under the default algorithms, two replays
      from the same loaded tag, and their masters' largest difference;
   b. through the launcher: ``python -m deepspeed_tpu_torch.launcher.runner
      --num_gpus 1 --max_restarts 1`` runs a worker that trains BERT-large's
      width at 2 of its 24 layers for 6 steps,
      saves every 2 (two tags kept) and resumes from the newest committed
      tag, once with a SIGKILL at step 4 and once with a SIGTERM at step 3
      (the emergency checkpoint), the two jobs side by side: each
      restarts once (the preempted one
      with no backoff), resumes at the step it stopped at, launches
      4/2/2 a step, and ends with masters whose SHA-256 equals an
      uninterrupted run's at the same depth, trained in process;
   c. a healthy ``comm.barrier(timeout_s=30)`` on the NCCL group's gloo
      twin, then a save whose commit barrier hangs (``hang_barrier``) with
      ``resilience.comm_timeout_s`` 2: ``CommTimeoutError`` within 2 s
      plus 1 s of slack.
   Tags go to a temporary directory under ``build/``; too little free
   space for three stage-0 tags fails the phase. Printed: recoveries,
   losses, launches a step, the save and recovery seconds, the restarts
   and exit classes, each worker's time to resume, each run's whole time,
   the barrier's seconds; the launcher's output goes to
   ``build/resil_{kill,preempt}.log``.

11. (``pld``) progressive layer drop at BERT-large through ``initialize()``
   (phase 6's bf16 Adam run with ``progressive_layer_drop`` theta 0.5,
   gamma 0.001): 10 steps, theta on its schedule step for step, the flash
   kernels 48/24/24 a step, the loss finite and falling, the step time
   against the same run without PLD and each layer's kept share; theta 1
   equal to PLD off bit for bit over 3 steps under deterministic
   algorithms; then ``BertForQuestionAnswering`` at BERT-large and S = 384
   fine-tuned 10 steps on seeded synthetic spans with DeepSpeedExamples
   BingBertSquad's settings (batch 24 as one micro-batch, Adam 3e-5, no
   weight decay, clipping 1.0, fp16 with dynamic loss scaling from 2^16):
   the fp16 flash routines 48/24/24 a step, the loss finite and falling;
12. (``serve6``) the serving features at GPT-2 XL width, 24 of its 48
   layers in fp32 (phase 3's engine,
   the prompts' lengths, the four of 300 tokens or more sharing their
   first 256 tokens, two waves): a. in fp32 with ``speculative_k`` 4,
   ``prefill_chunk_tokens`` 256 and the prefix cache, served tokens
   against ``generate()`` under phase 4's margin rule, then the same with
   every draft corrupted (nothing accepted), then int8 weights over an
   int8 pool against ``generate()`` on the same quantized model (token
   match at least 0.9, as the JAX package holds quantized KV); the decode
   and band kernels must launch inside the verify steps and the prefill
   chunks; c. the prefix cache's tiers in fp32: a live budget of one
   entry, one blob of host spill and a disk tier under ``build/``: a
   prompt extending an entry demoted to the disk is promoted and served
   as ``generate()`` serves it, a corrupted blob is dropped and the prompt
   prefilled, the ``host_mem_pressure`` arm climbs the guard to its top
   level; d. beam search, W = 1 equal to greedy ``generate()`` and W = 4
   timed; b. in bf16, timed at 6 of the 48 layers: k = 0, k = 4, chunks
   of 256 and the prefix cache, each pass's TTFT p50/p95, decode tokens/s, tokens a step,
   accept rate, prefix hit rate and reused tokens, and the kernels'
   launches; the int8 weights' bytes against bf16's. The phase-2 cases
   add the decode kernel at C = 5 (fp32, bf16, int8) and C = 256, the band
   kernel at N = 40 (8 lanes x 5) and 256, the verify rows against C = 1
   rows (``torch.equal``, required in fp32), and phase 5 the three flash
   kernels at S = 384, batch 24, in bf16 and fp16.

13. (``fleet``) the serving fleet at GPT-2 XL width and 6 of its 48
   layers: replica processes of
   the port (``python -m deepspeed_tpu_torch.inference.serving.replica``,
   phase 3's engine, weights from seed 0 on a CPU generator) behind a
   ``Router``, each with its engine endpoint armed: a. a prefill and a
   decode replica in fp32 with the KV handoff, served tokens against
   ``generate()`` under phase 4's margin rule, the hand-offs all
   completed, the parameters' SHA-256 of both replicas equal to the
   oracle's, and a ``FleetCollector`` over both endpoints (the decode and
   band kernels launched in the prefill replica, the decode kernel in the
   decode replica); b. a prefill and a decode replica in bf16, timed: per
   request the bytes handed off, the export, send and install ms against
   the prompt's re-prefill on the decode replica, TTFT p50 / p95 and the
   decode replica's tokens/s; c. SIGTERM to that decode replica with
   every lane decoding: its requests finish without a re-route, it exits
   ``EXIT_PREEMPTED``, and later requests go to the other replica; d. two
   mixed fp32 replicas, one killed by its ``kill_replica`` arm
   mid-decode: every request equal to ``generate()``, streamed without a
   duplicate or a lost token, the longest pause in a stream reported as
   the failover time. Replica specs and logs go to a temporary directory
   under ``build/``.

14. (``sparse``) block-sparse attention (``ops/sparse_attention``) on the
   flash kernels at block 16, BERT-large width (16 heads of 64): a.
   ``BertSparseSelfAttention`` at S = 1024, B = 2 on the five layouts
   (Dense, Fixed, Variable, BigBird, BSLongformer at their defaults) in
   fp32 and bf16 with padded keys, BigBird with mul-mode key padding and
   one fully padded sequence, and the unidirectional Fixed layout with a
   causal ``tril`` mask: the output and the gradients of the input and
   the three ``Linear``s through the kernels against the plain versions
   within phase 7's tolerances, one launch of each kernel a pass; b. the
   three kernels on Fixed and BigBird at S = 1024 (B = 8; against the
   plain versions, timed too) and S = 4096 (B = 2), bf16, timed as phase
   5 does beside SDPA with the layout as a mask, SDPA dense and the port's
   kernels on the dense layout at block 128; c. four encoder blocks
   around ``BertSparseSelfAttention`` trained 5 steps through
   ``initialize()`` with a ``sparse_attention`` section (BigBird, block
   16), bf16 Adam, ZeRO 0, S = 1024, B = 8: the engine's sparsity config
   equal to the section's, the loss finite and falling, 4/4/4 flash
   launches a step, the LUT built by the native host op, the step ms,
   peak memory and the host ms of the LUT cache; d. the native host ops
   against their plain versions on this machine's CPU: ``layout_to_lut``
   on BigBird at S = 4096 (equal), flatten / unflatten over BERT-large's
   parameters (a round trip bit for bit) and one LAMB step over its word
   embeddings (1e-6), each timed beside its plain version and its bound.

15. (``pipe``) pipeline parallelism at GPT-2 XL width (vocab 50304,
   hidden 1600, 25 heads of 64, S = 1024, micro-batches of 2 sequences)
   through ``initialize(model=build_gpt2_pipeline(...))``: first the three
   flash kernels at the pipeline's shapes (bf16 causal and non-causal with
   dropout 0.1, fp32 causal) against their plain versions, timed as phase
   5 does; a. in fp32 at 4 of the 48 blocks, 4 micro-batches, Adam, 3
   steps: 1 stage, 4 stages 1F1B (``parameters`` partition) and 2 stages
   x 2 chunks (interleaved) from the same seeds, losses and masters bit
   for bit under deterministic algorithms, the tied embedding and head
   equal after every step, the flash launches equal to the schedule's
   count; the 4-stage gradients on the kernels against the plain
   attention versions within phase 7's fp32 tolerance; c. that run's
   tag, consolidated by ``zero_to_fp32`` and converted by
   ``inference/convert.py``, greedy-decodes 16 tokens for 4 prompts on the
   decode and band kernels as the in-memory conversion does, and the tag
   loaded at 2 stages takes the 4-stage run's next step bit for bit; b.
   bf16 at 12 of the 48 blocks, 4 stages, 8 micro-batches, dropout 0.1, 2 warm-up
   and 5 timed steps: step ms, tokens/s, peak memory, each stage's device
   time, the bubble estimates, the loss finite and falling, the flash
   launches a step equal to the schedule's count, one profiled step. The
   tag goes to a temporary directory under ``build/``.
16. (``parallel``) tensor, sequence and expert parallelism and 1-bit Adam:
   2 or 4 rank processes on the one card (``torch.multiprocessing``, a
   ``TCPStore`` on localhost, a gloo group whose collectives stage CUDA
   tensors through host memory, so none of these times is NCCL's). The
   parent trains TP 1; a. TP 2 at BERT-large width, 4 of its 24 layers,
   fp32, dropout 0.1, deterministic algorithms, 3 Adam steps at lr 1e-4:
   losses 1e-5 relative, the first step's reduced gradients 1e-4 of each
   tensor's max, at most 1e-4 of the gathered master elements beyond 1e-5
   of TP 1's, one layer's dropout at each rank's head offset bit for bit
   TP 1's, the TP 2 gradients on the kernels against the plain versions
   (phase 7's fp32 tolerance), 4/4/4 flash launches a rank a step; b. TP
   2 x ZeRO-2 at data x model 2 x 2 (4 processes, dropout off) held to TP
   1 the same way, its tag read by ``zero_to_fp32`` and loaded at TP 1
   equal to the masters exactly, and TP 1's next step from it equal to TP
   2's. Each gradient and tag check also reads a planted fault (the model
   group's backward reduce skipped, the other data rank's half dropped, a
   tag of the initial weights, a load of nothing) and fails if that
   reading is within its bound; c. the bf16 kernels at (c)'s shapes at
   each rank's head offset against their plain versions and the 16-head
   call's bits, then TP 2, bf16, all 24 layers, dropout 0.1, 2 warm-up
   and 5 timed steps: step ms, samples/s, peak memory a rank, the loss
   finite and falling, the launches a step; d. ring and Ulysses at W = 2
   (16 heads of 64, S = 4096, B = 1, fp32 and bf16, causal and
   key-padded): forward and q, k, v gradients against the whole-sequence
   flash kernels (fp32 3e-5, bf16 2e-2 of the largest magnitude), each
   path's launches (the ring one a hop it does not skip), bf16 ms; e.
   expert parallelism at Switch-Base-8 widths against ``moe_ffn`` per
   rank (1e-4); f. 1-bit Adam at dp 2 (BERT-large width, 2 layers,
   embedding tables frozen): warm-up equal to dense Adam (1e-4), the
   compressed steps finite and below the first loss, the bytes a rank
   sends a step on each path.

17. (``serve_tp``) the serving engine on a tensor-parallel mesh
   (``serving.mesh_shape`` (1, 2)) at GPT-2 large's width (hidden 1280, 20
   heads of 64): two rank processes on the one card over gloo (phase 16's
   machinery), rank 0 submitting and planning every step, each rank
   holding its 10 heads of the layers and of the KV pool. a. fp32 at 6 of
   the 36 layers, phase 4's 8 prompts and 32 new tokens: served at TP 2
   against TP 1 served and against ``generate()`` under phase 4's margin
   rule, plain and with chunks of 256 and the prefix cache (its second
   pass hitting it); each rank's decode and band launches above 0 and
   alike on both ranks; a rank's pool half of TP 1's bytes; a planted
   fault (the row-parallel reduce skipped) must serve other tokens; a
   request whose deadline passes on rank 0's clock only (it jumps 600 s
   after step 3) retires on both ranks at one step; b. the decode kernel
   (C = 1, 5, 256) and the band kernel (N = 8, 40) at 10 heads against
   their plain versions, fp32 and bf16, timed as phase 2 does; c. bf16 at
   all 36 layers, one prompt's 4 tokens to warm up, then a timed pass:
   TTFT p50 / p95, decode
   tokens/s and step ms, host-staged collectives and bytes a step, peak
   memory a rank, the share of tokens equal to TP 1 bf16 (reported); d.
   GPT-2 XL's 25 heads at TP 2 raise the JAX engine's message.
   Phase 15 adds d: ZeRO and tensor parallelism under the pipeline at
   GPT-2 large's width (GPT-2 XL's 25 heads do not split in two), 2 of 36
   blocks as 2 stages, fp32 under deterministic algorithms: one process (the parent) against TP 2 (dropout 0.1) and
   data 2 x TP 2 with ZeRO-1 and ZeRO-2 (dropout 0), held as phase 16
   holds TP 1 (losses, first-step gradients, masters), each check beside
   its planted fault's reading; the ZeRO-1 tag read by ``zero_to_fp32``
   and loaded at one process equal to the masters exactly; then bf16 at
   12 blocks as 4 stages at TP 2, timed, the flash launches a step equal
   to the schedule's count. Phase 16 adds g: a ``MoELayer`` at
   Switch-Base-8 widths under ``initialize()`` at dp 2 with its experts
   split, against world 1 on the same global batch (no token dropped, no
   aux loss), beside a planted fault (the expert gradients averaged over
   the data group).

18. (``remat``) activation checkpointing and the monitors: a. at
   BERT-large width, 2 layers, fp32, dropout 0.1, deterministic
   algorithms, one step's reduced gradients through ``initialize()`` with
   no checkpointing, "nothing", "dots" and "offload_dots" (the config's
   ``cpu_checkpointing``), each pair ``torch.equal`` or within phase 7's
   1e-4 of each tensor's max, beside a planted fault (every host copy
   zeroed); a Megatron-style ``checkpointing.checkpoint()`` over one layer
   whose dropout seed ``get_cuda_rng_tracker().fork()`` gave, against the
   same call without checkpointing, beside a planted fault (the fork
   inside the region); b. phase 6's bf16 Adam BERT-large (24 layers, 64 x
   128), 3 warm-up and 5 timed steps under "dots" and "offload_dots":
   step ms, peak memory (the offload's must be lower), bytes copied D2H
   and H2D a step, the flash launches (48/24/24 a step), the loss finite
   and falling; c. at 2 layers in bf16 with ``tensorboard`` and
   ``csv_monitor`` (``steps_per_print`` 2), 4 steps whose non-flush steps
   run under ``torch.cuda.set_sync_debug_mode("error")``: the event file
   read back through ``monitor.read_events`` (both CRCs checked) at steps
   64, 128, 192, 256, 4 CSV rows a tag, the losses as returned; the same
   with ``wall_clock_breakdown`` records the microstep timers; step ms
   with the monitors armed and disarmed.
19. (``profile``) the FLOPS profiler and the sentinels: a. at BERT-large
   width, 2 layers, bf16, 64 x 128, the FLOPs of one forward and of one
   forward plus backward under ``FlopCounterMode`` with the flash kernels
   (each reports its plain version's count) equal, as integers, to the
   same counts with the plain versions swapped in, and the forward equal
   to its formula; b. phase 6's bf16 Adam run (24 layers, 64 x 128) with
   ``flops_profiler`` at step 3 against the same run unprofiled, 5 steps
   each through ``train_batch`` under deterministic algorithms: losses
   bit for bit, the report's head lines, the step's FLOPs, model TFLOP/s
   and MFU against 989, the profiled window's ms against every step's
   ms, the count pass's host ms; c. GPT-2 XL at 6 of 48 layers, bf16,
   phase 3's engine and traffic with ``jax_sentinels`` (a budget of 8,
   one prefill a prompt bucket; the transfer guard on): tokens equal to
   the unguarded engine's, each sentinel's program count, a second pass
   adding none, one sanctioned host read (``serving/step_read``) in a
   guarded steady-state decode step, a planted ``.item()`` in one
   raising, the host cost of recording programs and of the read
   (report only), and one decode step's FLOPs through ``get_model_profile`` on the
   decode and band kernels equal to their plain versions'; d. what
   ``set_sync_debug_mode("error")`` flags, call by call; bf16
   ``train_step`` at 2 layers under the guard with no sanctioned host
   read, then a planted sync;
   ZeRO-2 + offload streamed at 2 layers under the guard against
   unguarded (losses and masters bit for bit, NCCL at world 1); a planted
   sync on the main thread while a worker holds an offload window.

Every phase prints its seconds and the bytes it left allocated on the
card, before and after a garbage collection.

``--phases`` runs a subset (kernels, serve, oracle, flash, train, grad,
zero, ckpt, resil, pld, serve6, fleet, sparse, pipe, parallel, serve_tp,
remat, profile)
while a kernel is being worked on; such a run prints no result line.

The line before the last is the kernels' JSON, with the card's name and
power limit printed before it; the last line is the run's JSON result.
"""

import argparse
import gc
import hashlib
import json
import math
import os
import random
import re
import signal
import statistics
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12                  # H100 SXM
PEAK_OPS = {torch.float32: 67e12,          # fp32 outside the tensor cores
            torch.bfloat16: 989e12,        # bf16 tensor cores, dense
            torch.float16: 989e12}         # fp16 tensor cores, dense

B, NH, HD, PT, MP = 8, 25, 64, 128, 8      # GPT-2 XL serving shapes
W = 2 * PT                                  # band window (SPARSE_BAND + 1 pages)
PROMPT_LENS = (16, 40, 100, 200, 300, 480, 700, 900)
NEW_TOKENS = 32
# phases 3, 4 and 12 (its fp32 passes): GPT-2 XL's width at 24 of its 48
# layers since phase 17 joined the script (depth, not width, is cut so the
# whole script stays inside its time limit)
SERVE_LAYERS = 24
# (atol, rtol) of kernel vs plain version. fp32: the same math in another
# summation order. bf16: the plain version rounds QK to bf16 before the
# softmax (as the TPU kernel does), the kernel keeps it in fp32. int8: both
# sides do the same fp32 math on the same pages and scales, so they differ
# by at most one bf16 step of the rounded output (2**-7 relative).
TOL = {"fp32": (1e-5, 1e-5), "bf16": (2e-2, 2e-2), "int8": (1e-3, 2.0 ** -7),
       # fp16 queries (set before their first run): fp16 and bf16 pages as
       # bf16 above, but fp16 keeps 3 more bits of QK, so the scores move 8x
       # less: a quarter of bf16's tolerance. The band kernel rounds QK to fp16
       # as its plain version does; they differ by summation order and the
       # output's rounding. int8 pages: one fp16 step of the output (2**-10
       # relative) in place of bf16's.
       "fp16": (5e-3, 5e-3), "int8 fp16": (1e-3, 2.0 ** -10)}
SERVING_KERNELS = ("decode_attention", "sparse_attention")


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable, L2 flushed before each run
    (the serving step streams a layer's weights between two attention
    calls, so the kernel finds the cache cold). The card spins for about
    a millisecond before the first event, so the host has enqueued the
    callable's launches by the time the card reaches them and the events
    bracket device time, not the host's time to launch."""

    SPIN_CYCLES = 2_000_000

    def __init__(self):
        self._flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters=20, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self._flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(self.SPIN_CYCLES)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def _check(name, got, want, tol):
    torch.cuda.synchronize()
    atol, rtol = tol
    err = (got.float() - want.float()).abs()
    bad = err > atol + rtol * want.float().abs()
    if not torch.isfinite(got.float()).all() or bool(bad.any()):
        raise RuntimeError(f"{name}: kernel disagrees with its plain version "
                           f"(max abs err {float(err.max()):.3e}, atol {atol}, "
                           f"rtol {rtol})")
    return float(err.max()), float(want.float().abs().max())


def _bound(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _qname(kv, qname):
    """The query type of a case: named, or the pages' (bf16 for int8)."""
    return qname or ("fp32" if kv == "fp32" else "bf16")


def _label(C, kv, qname):
    """A decode case's name; fp16 queries are named, the others are not."""
    return f"C={C}{' q=fp16' if qname == 'fp16' else ''} pages={kv}"


def _tol(kv, qname=None):
    if qname == "fp16":
        return TOL["int8 fp16" if kv == "int8" else "fp16"]
    return TOL[kv]


def _decode_inputs(C, kv, shape, padded_query=False, qname=None):
    """Queries, a page pool, shuffled page tables and positions for one
    decode-kernel case; ``shape`` is (lanes, heads, head dim, page tokens,
    pages per lane); the queries are ``qname``'s type (see ``_qname``)."""
    B, NH, HD, PT, MP = shape
    gen = torch.Generator(device="cuda").manual_seed(1000 + C)
    qdt = FLASH_DTYPES[_qname(kv, qname)]
    P = B * MP + 1
    q = torch.randn(B, C, NH, HD, generator=gen, device="cuda").to(qdt)
    pk32 = torch.randn(P, NH, PT, HD, generator=gen, device="cuda")
    pv32 = torch.randn(P, NH, PT, HD, generator=gen, device="cuda")
    ks = vs = None
    if kv == "int8":
        # every (page, head) at its own magnitude, 0.1 to 10, so a kernel
        # that reads another page's or head's scale, or swaps the K and V
        # scales, lands far outside the tolerance
        pk32 = pk32 * 0.1 * 100.0 ** torch.rand(P, NH, 1, 1, generator=gen, device="cuda")
        pv32 = pv32 * 0.1 * 100.0 ** torch.rand(P, NH, 1, 1, generator=gen, device="cuda")
        ks = pk32.abs().amax(dim=(2, 3)) / 127.0
        vs = pv32.abs().amax(dim=(2, 3)) / 127.0
        pk = torch.round(pk32 / ks[:, :, None, None]).clamp(-127, 127).to(torch.int8)
        pv = torch.round(pv32 / vs[:, :, None, None]).clamp(-127, 127).to(torch.int8)
    else:
        pk, pv = pk32.to(FLASH_DTYPES[kv]), pv32.to(FLASH_DTYPES[kv])
    perm = torch.randperm(P - 1, generator=gen, device="cuda") + 1
    tables = perm.reshape(B, MP).to(torch.int32)
    if C == 1:     # decode: each lane at its own position
        qpos = torch.randint(0, MP * PT, (B, 1), generator=gen, device="cuda")
    elif C < 128:  # a short chunk somewhere in each lane's cache
        start = torch.randint(0, MP * PT - C, (B, 1), generator=gen, device="cuda")
        qpos = start + torch.arange(C, device="cuda")[None]
    else:          # a prefill chunk from position 0
        qpos = torch.arange(C, device="cuda").expand(B, C)
    qpos = qpos.to(torch.int32).contiguous()
    if padded_query:   # a query that sees no key: its output is 0
        qpos[0, 0] = -1
    return (q, pk, pv, tables, qpos, PT, qdt, ks, vs)


# shapes the serving path does not use but the kernel takes: head dim 128,
# pages that are no power of two (splits of several pages, a ragged last
# split and key block), tiny pages; (lanes, heads, head dim, page tokens, pages)
ODD_SHAPES = ((3, 4, 128, 48, 11), (2, 3, 64, 5, 60))


def decode_odd_case(C, kv, shape, qname=None):
    """Kernel against plain version, and the bitwise invariance, at a
    shape off the serving path (checked, not timed)."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(C, kv, shape, padded_query=C > 1, qname=qname)
    label = f"{_label(C, kv, qname)} shape={shape}"
    tol = _tol(kv, qname)
    err, _ = _check(f"decode_attention {label}", da._decode_attend_cuda(*args),
                    da._decode_attend_torch(*args), tol)
    return dict(case=label, max_abs_err=err, tol=tol,
                invariance=decode_invariance(args, label))


def decode_one_token_prefill(kv, shape, qname=None):
    """A one-token prompt in both callers' shapes: its prefill alone (C = 1,
    as ``generate()`` calls it) holds the plain version and equals, bit for
    bit, its row of the bucket-wide chunks that serving prefills it in."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(1, kv, shape, qname=qname)
    q, pk, pv, tables, qpos, pt, qdt, ks, vs = args
    qpos[0, 0] = 0                 # lane 0: the prompt's own position
    label = f"one-token prefill{' q=fp16' if qname == 'fp16' else ''} pages={kv} shape={shape}"
    tol = _tol(kv, qname)
    alone = da._decode_attend_cuda(*args, prefill=True)
    err, _ = _check(f"decode_attention {label}", alone,
                    da._decode_attend_torch(*args), tol)
    last = tables.shape[1] * pt - 1
    for wide in (8, 128):
        qw = torch.zeros(q.shape[0], wide, *q.shape[2:], dtype=q.dtype, device="cuda")
        qw[:, :1] = q
        qposw = (qpos + torch.arange(wide, device="cuda", dtype=torch.int32))
        qposw = qposw.clamp(max=last).contiguous()
        chunk = da._decode_attend_cuda(qw, pk, pv, tables, qposw, pt, qdt, ks, vs,
                                       prefill=True)
        if not torch.equal(chunk[:, :1], alone):
            raise RuntimeError(f"decode_attention {label}: the prefill alone differs "
                               f"from its row of a chunk of {wide}")
    torch.cuda.synchronize()
    return dict(case=label, max_abs_err=err, tol=tol, invariance=2)


def decode_case(timer, C, kv, qname=None):
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(C, kv, (B, NH, HD, PT, MP), qname=qname)
    q, pk, pv, tables, qpos, _, qdt, ks, vs = args
    label, tol = _label(C, kv, qname), _tol(kv, qname)
    got = da._decode_attend_cuda(*args)
    want = da._decode_attend_torch(*args)
    err, out_absmax = _check(f"decode_attention {label}", got, want, tol)
    ms = timer(lambda: da._decode_attend_cuda(*args))
    plain_ms = timer(lambda: da._decode_attend_torch(*args), iters=5, warmup=1)

    # yardstick: SDPA over each lane's gathered (dequantized) pages, same mask
    def lane_kv(pages, scale):
        x = pages.float() * scale[:, :, None, None] if scale is not None else pages
        g = x.to(qdt)[tables.long()].transpose(1, 2)           # [B, nh, mp, pt, hd]
        return g.reshape(B, NH, MP * PT, HD).contiguous()

    K, V = lane_kv(pk, ks), lane_kv(pv, vs)
    mask = (torch.arange(MP * PT, device="cuda")[None, None, None, :]
            <= qpos.long()[:, None, :, None])
    qt = q.transpose(1, 2).contiguous()
    library_ms = timer(lambda: F.scaled_dot_product_attention(qt, K, V, attn_mask=mask))

    # the work this run's data needs: a lane's K and V rows 0 .. its last
    # query's position, the table entries and int8 scales of those pages,
    # and one QK and one PV product per (query, visible key, head)
    lane_keys = (qpos.long().amax(dim=1) + 1).clamp(max=MP * PT)
    pages_read = int(((lane_keys + PT - 1) // PT).sum())
    nbytes = (q.numel() * q.element_size() * 2 + qpos.numel() * 4 + pages_read * 4
              + int(lane_keys.sum()) * 2 * NH * HD * pk.element_size()
              + (pages_read * 2 * NH * 4 if ks is not None else 0))
    pairs = int((qpos.long() + 1).clamp(max=MP * PT).sum())
    bound_ms, bound_by = _bound(nbytes, pairs * NH * 4 * HD, qdt)
    return dict(case=label, max_abs_err=err, out_absmax=out_absmax,
                tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                invariance=decode_invariance(args, label))


def decode_invariance(args, label):
    """Bit for bit: every lane's output among the 8 lanes and the pool-wide
    table equals its output alone (B = 1, a table of just the pages it
    sees), and a chunk's rows equal the same rows of a wider chunk padded
    with zero queries. Returns the number of comparisons made."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    q, pk, pv, tables, qpos, pt, qdt, ks, vs = args
    B, C, NH, HD = q.shape
    last = tables.shape[1] * pt - 1
    full = da._decode_attend_cuda(*args)
    checks = 0
    for b in range(B):
        pages = int(qpos[b].max()) // pt + 1
        alone = da._decode_attend_cuda(q[b:b + 1].contiguous(), pk, pv,
                                       tables[b:b + 1, :pages].contiguous(),
                                       qpos[b:b + 1].contiguous(), pt, qdt, ks, vs)
        if not torch.equal(alone[0], full[b]):
            raise RuntimeError(f"decode_attention {label}: lane {b} alone differs from "
                               f"lane {b} among {B} lanes")
        checks += 1
    if C > 1:
        wide = C + 24
        qw = torch.zeros(B, wide, NH, HD, dtype=q.dtype, device="cuda")
        qw[:, :C] = q
        extra = qpos[:, -1:] + 1 + torch.arange(wide - C, device="cuda", dtype=torch.int32)
        qposw = torch.cat([qpos, extra.clamp(max=last)], dim=1).contiguous()
        padded = da._decode_attend_cuda(qw, pk, pv, tables, qposw, pt, qdt, ks, vs)
        if not torch.equal(padded[:, :C], full):
            raise RuntimeError(f"decode_attention {label}: the chunk's rows differ inside "
                               f"a chunk of {wide}")
        checks += 1
    torch.cuda.synchronize()
    return checks


def _band_inputs(N, dtype_name, shape=None, positions=None, seed=None):
    """Queries, window and sink slices, positions and window bases for one
    band-kernel case; ``shape`` is (heads, head dim, page tokens), and
    ``positions`` (else random over 8 pages) the queries' positions."""
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    nh, hd, pt = shape or (NH, HD, PT)
    dt = FLASH_DTYPES[dtype_name]
    gen = torch.Generator(device="cuda").manual_seed(2000 + N if seed is None else seed)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)
    q, kw, vw = rnd(N, nh, hd), rnd(N, nh, 2 * pt, hd), rnd(N, nh, 2 * pt, hd)
    ksk, vsk = rnd(N, nh, pt, hd), rnd(N, nh, pt, hd)
    if positions is None:
        pos = torch.randint(0, MP * pt, (N,), generator=gen, device="cuda")
    else:
        pos = torch.tensor(positions, device="cuda")
    base = sa._window_base(pos, pt)
    return (q, kw, vw, ksk, vsk, pos.to(torch.int32), base.to(torch.int32), dt)


def band_invariance(args, label):
    """Bit for bit: each of the first 8 queries alone equals its row among
    the first 8 and among all N. Returns the number of comparisons."""
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    rows = lambda a, i, j: [t[i:j].contiguous() for t in a[:7]] + [a[7]]
    full = sa._band_attend_cuda(*args)
    eight = sa._band_attend_cuda(*rows(args, 0, 8))
    checks = 0
    for i in range(min(8, args[0].shape[0])):
        alone = sa._band_attend_cuda(*rows(args, i, i + 1))
        for other, n in ((eight, 8), (full, args[0].shape[0])):
            if not torch.equal(alone[0], other[i]):
                raise RuntimeError(f"sparse_attention {label}: query {i} alone differs "
                                   f"from its row among {n}")
            checks += 1
    torch.cuda.synchronize()
    return checks


# band shapes the serving path does not use but the kernel takes, each with
# queries at the edges of the mask: position 0, inside the first page
# (base 0: no sink), the first token of a page, the last token of a page;
# (heads, head dim, page tokens)
BAND_ODD_SHAPES = ((NH, HD, PT), (4, 128, PT), (3, 64, 48), (2, 128, 48))


def band_odd_case(dtype_name, shape):
    """Kernel against plain version, and the bitwise invariance, for
    queries at the mask's edges (checked, not timed)."""
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    pt = shape[2]
    positions = [0, 1, pt - 1, pt, pt + 1, 2 * pt, 2 * pt - 1, 3 * pt, 5 * pt,
                 MP * pt - 1, 7 * pt, 4 * pt + 3]
    args = _band_inputs(len(positions), dtype_name, shape, positions, seed=2500 + pt)
    label = f"{dtype_name} shape={shape} edges"
    err, _ = _check(f"sparse_attention {label}", sa._band_attend_cuda(*args),
                    sa._band_attend_torch(*args), TOL[dtype_name])
    return dict(case=label, max_abs_err=err, tol=TOL[dtype_name],
                invariance=band_invariance(args, label))


def band_case(timer, N, dtype_name):
    from deepspeed_tpu_torch.kernels import sparse_attention as sa

    args = _band_inputs(N, dtype_name)
    q, kw, vw, ksk, vsk, pos, base, dt = args
    got = sa._band_attend_cuda(*args)
    want = sa._band_attend_torch(*args)
    err, out_absmax = _check(f"sparse_attention N={N} {dtype_name}", got, want,
                             TOL[dtype_name])
    ms = timer(lambda: sa._band_attend_cuda(*args))
    plain_ms = timer(lambda: sa._band_attend_torch(*args), iters=5, warmup=1)

    K = torch.cat([ksk, kw], dim=2)
    V = torch.cat([vsk, vw], dim=2)
    valid = torch.cat([torch.arange(PT, device="cuda")[None] < base.long()[:, None],
                       base.long()[:, None] + torch.arange(W, device="cuda")[None]
                       <= pos.long()[:, None]], dim=1)
    mask = valid[:, None, None, :]
    q4 = q[:, :, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(q4, K, V, attn_mask=mask))

    keys = int(valid.sum())
    item = q.element_size()
    nbytes = (2 * q.numel() * item + 2 * pos.numel() * 4
              + keys * 2 * NH * HD * item)
    bound_ms, bound_by = _bound(nbytes, keys * NH * 4 * HD, dt)
    return dict(case=f"N={N} {dtype_name}", max_abs_err=err, out_absmax=out_absmax,
                tol=TOL[dtype_name],
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by,
                invariance=band_invariance(args, f"N={N} {dtype_name}") if N > 8 else 0)


def _prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(0, 50257, n).tolist() for n in PROMPT_LENS]


def _engine(model, cfg, kv):
    from deepspeed_tpu_torch import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.inference.serving.scheduler import default_buckets

    largest = default_buckets(cfg.max_position_embeddings - 1)[-1]
    scfg = ServingConfig(max_slots=B, max_seq_len=cfg.max_position_embeddings,
                         kv_cache_dtype=kv,
                         attention_impl={"default": "pallas_decode",
                                         largest: "pallas_sparse"})
    return ServingEngine(model, cfg, scfg, device="cuda")


def _drive(eng):
    """Submit the traffic to ``eng``, drain it, and return the outputs,
    each request's backend, and the pass's metrics."""
    from deepspeed_tpu_torch.inference.serving.metrics import ServingMetrics

    eng.metrics = ServingMetrics()
    futs = [eng.submit(p, max_new_tokens=NEW_TOKENS) for p in _prompts()]
    t0 = time.perf_counter()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = eng.metrics.snapshot()
    pass_ = dict(
        ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
        decode_tokens_per_s=snap["tokens_per_sec"],
        decode_step_ms=1e3 * snap["decode_time_s"] / max(snap["decode_steps"], 1),
        decode_steps=snap["decode_steps"], prefill_calls=snap["prefill_calls"],
        prefill_s=eng.metrics.prefill_time_s, wall_s=wall)
    outs = [f.result(timeout=0) for f in futs]
    impls = [eng._impl_for_len(len(p)) for p in _prompts()]
    return outs, impls, pass_


def _profiled(fn):
    """Run ``fn`` under the profiler: the window's host wall time, device
    time by kernel (names cut to 90 characters, times summed), the
    device's busy share of the wall time, and host self time by op."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    by_name, calls = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name[:90]
            by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
            calls[name] = calls.get(name, 0) + 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    host = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:10]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                busy_share=busy / wall_us if wall_us else None, kernels=len(by_name),
                top_ms={k: v / 1e3 for k, v in top},
                # the port's own kernels, whatever their rank
                own_ms={k: v / 1e3 for k, v in by_name.items() if "dstorch" in k},
                own_launches={k: v for k, v in calls.items() if "dstorch" in k},
                # host self time by op under the profiler (which inflates it)
                top_host_self_ms={a.key[:90]: a.self_cpu_time_total / 1e3 for a in host})


def _profile(eng):
    """Device time by kernel over one admission (all prefills) and over 8
    decode steps of the same traffic."""
    for p in _prompts():
        eng.submit(p, max_new_tokens=NEW_TOKENS)
    out = {}
    for window, steps in (("admission_step", 1), ("decode_8_steps", 8)):
        out[window] = _profiled(lambda: [eng.step() for _ in range(steps)])
    eng.drain()
    return out


def phase_serve():
    from deepspeed_tpu_torch import GPT2Config, init_gpt2, kernels

    cfg = GPT2Config.gpt2_xl(num_hidden_layers=SERVE_LAYERS)
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    eng = _engine(model, cfg, "bf16")
    _, _, cold = _drive(eng)        # first pass: one-time costs (cuBLAS, allocator)
    kernels.reset_launch_counts()
    outs, impls, warm = _drive(eng)  # the measured pass of the main path
    counts = kernels.launch_counts()
    for out in outs:
        if len(out) != NEW_TOKENS or not all(0 <= t < cfg.vocab_size for t in out):
            raise RuntimeError(f"bad served output {out}")
    counts = {k: counts[k] for k in SERVING_KERNELS}
    if min(counts.values()) <= 0:
        raise RuntimeError(f"a kernel of the path never launched: {counts}")
    res = dict(model=f"gpt2_xl bf16 (seed 0), {SERVE_LAYERS} of 48 layers, kv bf16, 8 slots, "
                     "max_seq_len 1024",
               prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS, impls=impls,
               **warm, cold_pass=cold, launches=counts,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    res["profile"] = _profile(eng)
    del eng, model
    torch.cuda.empty_cache()
    return res


def _margins(model, cfg, prompt, impl, n_new=NEW_TOKENS):
    """Greedy tokens and the top-2 logit margin at every step of the
    one-shot path (the same functions ``generate()`` runs)."""
    from deepspeed_tpu_torch.inference import generation as g

    nh = cfg.num_attention_heads
    step = {"pallas_decode": g._step_kernel,
            "pallas_sparse": g._step_window_kernel}[impl]
    ids = torch.tensor([prompt], device="cuda")
    S = ids.shape[1]
    toks, margins = [], []
    with torch.no_grad():
        caches, logits = g._forward_full(model, ids, S, cfg.num_hidden_layers, nh,
                                         cfg.hidden_size // nh, S + n_new,
                                         attn_impl=impl, page_tokens=PT)
        for pos in range(S, S + n_new):
            top = torch.topk(logits.float(), 2, dim=-1).values[0]
            margins.append(float(top[0] - top[1]))
            tok = torch.argmax(logits, dim=-1)
            toks.append(int(tok))
            logits = step(model, nh, caches, tok, torch.full((1,), pos, device="cuda"), PT)
    return toks, margins


def phase_oracle():
    from deepspeed_tpu_torch import GPT2Config, generate, init_gpt2

    cfg = GPT2Config.gpt2_xl(num_hidden_layers=SERVE_LAYERS)
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.float32)
    outs, impls, _ = _drive(_engine(model, cfg, "fp32"))
    rows = []
    for prompt, out, impl in zip(_prompts(), outs, impls):
        want = generate(model, cfg, [prompt], NEW_TOKENS, attn_impl=impl,
                        kv_page_tokens=PT, device="cuda")[0].tolist()
        row = dict(prompt_len=len(prompt), impl=impl, equal=out == want)
        if out != want:
            first = next(i for i, (a, b) in enumerate(zip(out, want)) if a != b)
            toks, margins = _margins(model, cfg, prompt, impl)
            if toks != want:
                raise RuntimeError("one-shot replay does not reproduce generate()")
            row.update(first_divergence=first, top2_margin=margins[first])
            if margins[first] >= 1e-3:
                raise RuntimeError(f"served tokens diverge from generate() at step "
                                   f"{first} with top-2 margin {margins[first]:.3e}: "
                                   f"{row}")
        rows.append(row)
    del model
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: the flash-attention kernels (phase 5), BERT-large through
# initialize() (phase 6), and the gradient oracle (phase 7)
# ---------------------------------------------------------------------------

FB, FH, FS, FD = 64, 16, 128, 64           # BERT-large training shapes (B, heads, S, D)
FLASH_SEED = 4321
# kernel vs plain version, relative to the compared tensor's largest
# magnitude (at least 1). fp32: the same fp32 math summed in another order.
# bf16: both round p and ds to bf16 at the same points, but a different
# summation order can flip a rounding, and outputs are rounded to bf16.
# fp16: the same, with three more bits of mantissa (8x finer steps), so a
# quarter of bf16's tolerance.
FLASH_TOL = {"fp32": 1e-5, "bf16": 2e-2, "fp16": 5e-3}
FLASH_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16, "fp16": torch.float16}
FLASH_KERNELS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
FLASH_MAIN_CASE = "bf16 padded dropout0.1"
FLASH_FP16_MAIN_CASE = "fp16 padded dropout0.1"
TRAIN_WARMUP, TRAIN_STEPS = 3, 10


def _check_rel(name, got, want, tol):
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    scale = max(1.0, float(want.float().abs().max()))
    if not torch.isfinite(got.float()).all() or err > tol * scale:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version (max abs err "
                           f"{err:.3e}, allowed {tol} x {scale:.3g})")
    return err


def _flash_work(lut, counts, qlut, qcounts, block, causal, elem, FD=FD, FB=FB, FS=FS, FH=FH):
    """Bytes and (query, key) pairs the three kernels need for these
    inputs: every visited query or key block read once (q, dO, lse and
    delta rows; k and v rows), outputs written once; a pair counts where
    its key block is on the query block's LUT row and, when causal,
    key <= query."""
    lut, counts = lut.cpu().numpy(), counts.cpu().numpy()
    qcounts = qcounts.cpu().numpy()
    pairs = 0
    for h in range(lut.shape[0]):
        for qi in range(lut.shape[1]):
            for kj in lut[h, qi, :counts[h, qi]]:
                if not causal or kj < qi:
                    pairs += block * block
                elif kj == qi:
                    pairs += block * (block + 1) // 2
    pairs *= FB
    q_rows = FB * int((counts > 0).sum()) * block
    k_rows = FB * int((qcounts > 0).sum()) * block
    all_rows = FB * FH * FS
    row = FD * elem
    bias = FB * FS * 4
    fwd = (q_rows + 2 * k_rows) * row + bias + all_rows * (row + 4)
    dq = (2 * q_rows) * row + q_rows * 8 + 2 * k_rows * row + bias + all_rows * row
    dkv = (2 * k_rows) * row + bias + 2 * q_rows * row + q_rows * 8 + all_rows * (2 * row + 4)
    return dict(fwd=(fwd, 4 * FD * pairs), dq=(dq, 6 * FD * pairs), dkv=(dkv, 8 * FD * pairs))


def flash_case(timer, label, dtype_name, *, causal=False, rate=0.0, padded=True,
               sparse=False, FD=FD, FB=FB, FS=FS, FH=FH, block=None, plain_iters=2):
    """Kernels 1-3 against their plain versions on one input set, each
    with its time, bound and SDPA yardstick; dq + dk/dv together beside
    SDPA's whole backward (PyTorch has no call that computes dq alone)."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    dt = FLASH_DTYPES[dtype_name]
    block = 16 if sparse else block or fa.DEFAULT_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(3000 + sum(map(ord, label)))
    q, k, v, do = (torch.randn(FB, FH, FS, FD, generator=gen, device="cuda").to(dt)
                   for _ in range(4))
    bias = torch.zeros(FB, FS, device="cuda")
    if padded:   # about a fifth of each row's keys padded away (key 0 kept)
        pad = torch.rand(FB, FS, generator=gen, device="cuda") < 0.2
        pad[:, 0] = False
        bias = torch.where(pad, -10000.0, 0.0)
    layout = None
    if sparse:
        nb = FS // block
        layout = (np.random.RandomState(5).rand(FH, nb, nb) < 0.5).astype(np.int64)
        layout[:, :, 0] = 1
        layout[0, 1, :] = 0          # head 0, query block 1 sees no key
    lut, counts, qlut, qcounts = fa._device_luts(layout, FH, FS, block, q.device)
    kw = dict(block=block, causal=causal, rate=rate, seed=FLASH_SEED)
    pkw = (block, causal, rate, FLASH_SEED)
    tol = FLASH_TOL[dtype_name]

    out, lse = fa.flash_fwd(q, k, v, bias, lut, counts, **kw)
    out_p, lse_p = fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)
    errs = dict(out=_check_rel(f"{label} out", out, out_p, tol),
                lse=_check_rel(f"{label} lse", lse, lse_p, FLASH_TOL["fp32"]))
    delta = (do.float() * out_p.float()).sum(-1).reshape(FB * FH, FS)
    bwd_in = (q, k, v, bias, do, lse_p, delta)
    dq = fa.flash_bwd_dq(*bwd_in, lut, counts, **kw)
    dq_p = fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw)
    errs["dq"] = _check_rel(f"{label} dq", dq, dq_p, tol)
    dkv = fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw)
    dkv_p = fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw)
    for name, got, want in zip(("dk", "dv", "db"), dkv, dkv_p):
        errs[name] = _check_rel(f"{label} {name}", got, want, tol)
    plain_absmax = {name: float(t.float().abs().max()) for name, t in
                    zip(("out", "lse", "dq", "dk", "dv", "db"), (out_p, lse_p, dq_p, *dkv_p))}
    if sparse and float(out[:, 0, block:2 * block].abs().max()) != 0.0:
        raise RuntimeError(f"{label}: the empty row's output is not 0")

    calls = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, bias, lut, counts, **kw),
                lambda: fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)),
        "dq": (lambda: fa.flash_bwd_dq(*bwd_in, lut, counts, **kw),
               lambda: fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw)),
        "dkv": (lambda: fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw),
                lambda: fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw)),
    }
    # yardstick: SDPA over the same keys (the layout and the causal mask as
    # an additive mask; its dropout draws other bits), and its backward
    mask = bias[:, None, None, :]
    if sparse:
        dense = fa._expand_layout_mask(layout, FS, block).to("cuda")
        mask = mask + torch.where(dense, 0.0, -10000.0)[None]
    if causal:
        tril = torch.ones(FS, FS, dtype=torch.bool, device="cuda").tril()
        mask = mask + torch.where(tril, 0.0, -10000.0)
    mask = mask.to(dt)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa = lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask, dropout_p=rate)
    lib_fwd = timer(sdpa)
    o_lib = sdpa()
    lib_bwd = timer(lambda: torch.autograd.grad(o_lib, leaves, do, retain_graph=True))
    work = _flash_work(lut, counts, qlut, qcounts, block, causal, q.element_size(), FD, FB, FS,
                       FH)
    res = {}
    for kind, (kern, plain) in calls.items():
        bound_ms, bound_by = _bound(*work[kind], dt)
        res[kind] = dict(ms=timer(kern), plain_ms=timer(plain, iters=plain_iters, warmup=1),
                         library_ms=lib_fwd if kind == "fwd" else lib_bwd,
                         bound_ms=bound_ms, bound_by=bound_by)
    backward = dict(dq_plus_dkv_ms=res["dq"]["ms"] + res["dkv"]["ms"], library_ms=lib_bwd)
    return dict(case=label, block=block, head_dim=FD, heads=FH, batch=FB, seq=FS, causal=causal,
                dropout=rate, tol=tol, max_abs_err=errs, plain_absmax=plain_absmax,
                kernels=res, backward=backward)


FP16_MAX = 65504.0
OVERFLOW_LOSS_SCALE = 2.0 ** 14   # the largest power of two that keeps |dO| <= 2 finite


def flash_overflow_case():
    """An fp16 backward with dO multiplied by a loss scale near fp16's range
    (|dO| <= 2 before the scale, q tripled so the softmax is sharp and ds
    is large): the kernels and their plain versions round ds and the grads
    to fp16 at the same points, so both must give inf in the same grads
    (the loss scaler's overflow verdict), and their finite elements must
    agree. The same inputs at scale 1 must stay finite on both sides."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    dt, block, rate = torch.float16, fa.DEFAULT_BLOCK, 0.1
    gen = torch.Generator(device="cuda").manual_seed(3999)
    q, k, v, do = (torch.randn(FB, FH, FS, FD, generator=gen, device="cuda")
                   for _ in range(4))
    q, k, v = (q * 3).to(dt), k.to(dt), v.to(dt)
    do = do.clamp(-2.0, 2.0)
    pad = torch.rand(FB, FS, generator=gen, device="cuda") < 0.2
    pad[:, 0] = False
    bias = torch.where(pad, -10000.0, 0.0)
    lut, counts, qlut, qcounts = fa._device_luts(None, FH, FS, block, q.device)
    kw = dict(block=block, causal=False, rate=rate, seed=FLASH_SEED)
    pkw = (block, False, rate, FLASH_SEED)
    out_p, lse_p = fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)
    tol = FLASH_TOL["fp16"]
    res = dict(case="fp16 padded dropout0.1 loss-scaled dO", loss_scale=OVERFLOW_LOSS_SCALE,
               tol=tol, verdicts={})
    for scale in (1.0, OVERFLOW_LOSS_SCALE):
        dos = (do * scale).to(dt)
        if not torch.isfinite(dos.float()).all():
            raise RuntimeError("the scaled dO itself is not finite in fp16")
        delta = (dos.float() * out_p.float()).sum(-1).reshape(FB * FH, FS)
        bwd_in = (q, k, v, bias, dos, lse_p, delta)
        got = (fa.flash_bwd_dq(*bwd_in, lut, counts, **kw),
               *fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw)[:2])
        want = (fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw),
                *fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw)[:2])
        torch.cuda.synchronize()
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            gf, wf = g.float(), w.float()
            g_ok, w_ok = torch.isfinite(gf), torch.isfinite(wf)
            verdict = (not bool(g_ok.all()), not bool(w_ok.all()))
            if verdict[0] != verdict[1]:
                raise RuntimeError(f"fp16 overflow at loss scale {scale}: {name} "
                                   f"non-finite {verdict[0]} in the kernel, {verdict[1]} "
                                   "in the plain version")
            both = g_ok & w_ok
            differ = int((g_ok != w_ok).sum())
            if differ > 1e-5 * g.numel():
                raise RuntimeError(f"fp16 overflow at loss scale {scale}: {name} is finite "
                                   f"at {differ} elements on one side only")
            err = float((gf - wf).abs()[both].max()) if bool(both.any()) else 0.0
            big = max(1.0, float(wf.abs()[both].max())) if bool(both.any()) else 1.0
            if err > tol * big:
                raise RuntimeError(f"fp16 overflow at loss scale {scale}: finite {name} "
                                   f"differs by {err:.3e} (allowed {tol} x {big:.3g})")
            res["verdicts"][f"{name} x{scale:g}"] = dict(
                overflow=verdict[0], nonfinite=int((~g_ok).sum()),
                nonfinite_plain=int((~w_ok).sum()), finiteness_differs=differ,
                max_abs_err=err, finite_absmax=big)
    if any(v["overflow"] for k_, v in res["verdicts"].items() if k_.endswith("x1")):
        raise RuntimeError(f"fp16 backward overflowed at loss scale 1: {res['verdicts']}")
    if not any(v["overflow"] for v in res["verdicts"].values()):
        raise RuntimeError("the loss-scaled fp16 backward overflowed nowhere: the case "
                           "shows nothing")
    return res


def _bert_batch(cfg, batch, seq, seed=0):
    """Random ids with 15 % MLM labels and NSP labels, as bench.py makes them."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch, seq))
    labels = np.where(rng.rand(batch, seq) < 0.15,
                      rng.randint(0, cfg.vocab_size, (batch, seq)), -1)
    nsp = rng.randint(0, 2, (batch,))
    as_t = lambda x: torch.as_tensor(x, dtype=torch.long, device="cuda")
    return (as_t(ids), as_t(np.zeros((batch, seq))), as_t(np.ones((batch, seq))),
            as_t(labels), as_t(nsp))


def phase_train():
    import deepspeed_tpu_torch as dt

    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda")
    ds_config = {"train_batch_size": FB, "train_micro_batch_size_per_gpu": FB,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                 "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
                 "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000}
    engine, _, _, _ = dt.initialize(model=model, config=ds_config)
    n_params = sum(p.numel() for p in engine.module.parameters())
    batch = _bert_batch(cfg, FB, FS)
    losses = []
    for _ in range(TRAIN_WARMUP):
        losses.append(float(engine.train_step([batch])))
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed = [engine.train_step([batch]) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    losses += [float(x) for x in timed]
    flash = {k: counts[k] for k in FLASH_KERNELS}
    if min(flash.values()) <= 0:
        raise RuntimeError(f"a flash kernel never launched on the training path: {flash}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the loss did not fall on a repeated batch: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profiled(lambda: engine.train_step([batch]))
    if not any("flash_bwd_dq_mma_kernel" in k for k in profile["own_ms"]):
        raise RuntimeError(f"bf16 dq did not run on the tensor cores: {profile['own_ms']}")
    res = dict(model="bert_large (seed 0), bf16 + fp32 masters, Adam lr 1e-4, ZeRO 0, "
                     "activation checkpointing 'dots', dropout 0.1/0.1",
               params=n_params, micro_batch=FB, seq=FS, warmup_steps=TRAIN_WARMUP,
               timed_steps=TRAIN_STEPS, step_ms=1e3 * wall / TRAIN_STEPS,
               samples_per_s=FB * TRAIN_STEPS / wall, losses=losses, peak_mem_gb=peak,
               launches=flash,
               launches_per_step={k: v / TRAIN_STEPS for k, v in flash.items()},
               profile_one_step=profile,
               # the profiler slows the host, so its window's busy share
               # understates the unprofiled step's
               busy_share_of_step=profile["device_busy_ms"] / (1e3 * wall / TRAIN_STEPS))
    del engine, model, timed
    torch.cuda.empty_cache()
    return res


# the fp16 run of phase 6: BERT-pretraining's LAMB recipe (the optimizer
# keys of DeepSpeedExamples' bing_bert LAMB config, seq 128) with a
# WarmupDecayLR schedule and dynamic loss scaling from 2**16
FP16_LAMB = {"type": "Lamb", "params": {"lr": 11e-3, "weight_decay": 0.01,
                                        "bias_correction": False, "max_coeff": 0.3,
                                        "min_coeff": 0.01}}
FP16_SCHEDULE = {"type": "WarmupDecayLR",
                 "params": {"warmup_min_lr": 0.0, "warmup_max_lr": 11e-3,
                            "warmup_num_steps": 10, "total_num_steps": 1000}}
FP16_KERNEL_NAMES = {"flash_attention_fwd": "flash_fwd_mma_kernel<__half",
                     "flash_attention_bwd_dq": "flash_bwd_dq_mma_kernel<__half",
                     "flash_attention_bwd_dkv": "flash_bwd_dkv_mma_kernel<__half"}
FLASH_PER_STEP = {"flash_attention_fwd": 48, "flash_attention_bwd_dq": 24,
                  "flash_attention_bwd_dkv": 24}   # 24 layers, recomputed forward


def _warmup_decay_lr(iteration, p):
    """WarmupDecayLR's LR at ``iteration``, written out (the schedule the
    engine must follow)."""
    warm = p["warmup_num_steps"]
    if iteration < warm:
        gamma = min(1.0, math.log(iteration + 1) / math.log(max(warm, 2)))
    else:
        gamma = max(0.0, (p["total_num_steps"] - iteration) / max(1.0, p["total_num_steps"] - warm))
    return p["warmup_min_lr"] + (p["warmup_max_lr"] - p["warmup_min_lr"]) * gamma


def phase_train_fp16():
    """BERT-large at full width in fp16 through ``initialize(training_data=)``
    and ``train_batch()``: LAMB on the fp32 masters, gradient clipping 1.0,
    WarmupDecayLR, dynamic loss scaling. Checks that the fp16 flash
    instantiations launch 48/24/24 times a step, that every loss is finite
    and the loss falls, and that each step runs at the schedule's LR, held
    on a skipped step."""
    import deepspeed_tpu_torch as dt

    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda")
    ds_config = {"train_batch_size": FB, "train_micro_batch_size_per_gpu": FB,
                 "gradient_accumulation_steps": 1, "optimizer": FP16_LAMB,
                 "scheduler": FP16_SCHEDULE, "gradient_clipping": 1.0,
                 "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 16},
                 "zero_optimization": {"stage": 0},
                 "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000}
    # 256 samples (one tuple of tensors each) made as phase 6's batch is
    cols = [t.cpu() for t in _bert_batch(cfg, 4 * FB, FS, seed=0)]
    data = [tuple(c[i] for c in cols) for i in range(4 * FB)]
    engine, _, loader, _ = dt.initialize(model=model, config=ds_config, training_data=data)
    if engine.module.bert.embeddings.word_embeddings.weight.dtype != torch.float16:
        raise RuntimeError("the fp16 engine's module is not in fp16")
    sched = FP16_SCHEDULE["params"]
    clean, steps, losses = 0, [], []

    def step():
        nonlocal clean
        lr = engine.get_lr()[0]
        want = _warmup_decay_lr(clean, sched)
        if abs(lr - want) > 1e-12 * max(1.0, want):
            raise RuntimeError(f"step {len(steps)}: LR {lr}, the schedule says {want}")
        skipped, scale = engine.skipped_steps, engine.loss_scale()
        loss = engine.train_batch()
        overflow = engine.skipped_steps > skipped
        if overflow and engine.get_lr()[0] != lr:
            raise RuntimeError(f"step {len(steps)}: a skipped step moved the LR")
        clean += not overflow
        steps.append(dict(loss=loss, lr=lr, loss_scale=scale, overflow=overflow))
        losses.append(loss)

    for _ in range(TRAIN_WARMUP):
        step()
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    flash = {k: counts[k] for k in FLASH_KERNELS}
    per_step = {k: v / TRAIN_STEPS for k, v in flash.items()}
    if per_step != FLASH_PER_STEP:
        raise RuntimeError(f"fp16 flash launches a step {per_step}, not {FLASH_PER_STEP}")
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite fp16 training loss: {steps}")
    if not losses[-1] < losses[0]:
        raise RuntimeError(f"the fp16 loss did not fall: {steps}")
    if engine.skipped_steps == len(steps):
        raise RuntimeError(f"every fp16 step overflowed: {steps}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    profile = _profiled(lambda: engine.train_batch())
    for kernel, name in FP16_KERNEL_NAMES.items():
        got = sum(n for k, n in profile["own_launches"].items() if name in k)
        if got != FLASH_PER_STEP[kernel]:
            raise RuntimeError(f"{name}> launched {got} times in the profiled fp16 step, "
                               f"not {FLASH_PER_STEP[kernel]}: {profile['own_launches']}")
    res = dict(model="bert_large (seed 0), fp16 + fp32 masters, LAMB " +
                     json.dumps(FP16_LAMB["params"]) + ", WarmupDecayLR " + json.dumps(sched) +
                     ", gradient clipping 1.0, dynamic loss scale from 2^16, ZeRO 0, "
                     "activation checkpointing 'dots', dropout 0.1/0.1, training_data= "
                     f"{len(data)} synthetic samples (seed 0) through train_batch()",
               micro_batch=FB, seq=FS, warmup_steps=TRAIN_WARMUP, timed_steps=TRAIN_STEPS,
               step_ms=1e3 * wall / TRAIN_STEPS, samples_per_s=FB * TRAIN_STEPS / wall,
               steps=steps, skipped_steps=engine.skipped_steps,
               final_loss_scale=engine.loss_scale(), peak_mem_gb=peak, launches=flash,
               launches_per_step=per_step, loader_batches=len(loader),
               profile_one_step=profile,
               busy_share_of_step=profile["device_busy_ms"] / (1e3 * wall / TRAIN_STEPS))
    del engine, model
    torch.cuda.empty_cache()
    return res


class _PlainAttention:
    """Swap the flash kernel wrappers for their plain versions while
    active (the grad oracle's reference run), all but those named in
    ``keep`` (a subset of ``FLASH_KERNELS``)."""

    NAMES = dict(zip(FLASH_KERNELS, ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")))

    def __init__(self, keep=()):
        self.keep = keep

    def __enter__(self):
        from deepspeed_tpu_torch.ops.transformer import attention as fa

        self.saved = {attr: getattr(fa, attr) for attr in self.NAMES.values()}
        for kernel, attr in self.NAMES.items():
            if kernel not in self.keep:
                fn = getattr(fa, f"_{attr}_torch")
                setattr(fa, attr, lambda *a, block, causal, rate=0.0, seed=0, rng=None,
                        fn=fn: fn(*a, block, causal, rate, seed, rng))
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.ops.transformer import attention as fa

        for attr, fn in self.saved.items():
            setattr(fa, attr, fn)


# phase 8: ZeRO and ZeRO-Offload at BERT-large width (the bf16 Adam run of
# phase 6 with only zero_optimization changed)
ZERO_STEPS = 3
# the bit-for-bit runs' depth (BERT-large's width): equality does not
# depend on depth, and the script must end inside its time limit (3 since
# phase 17 joined it, 6 before)
ZERO_EQUAL_LAYERS = 3
# the timed runs' depth: 12 since phase 16 joined the script, 6 since phase
# 17 did (depth, not width, is cut so the whole script stays inside its
# time limit)
ZERO_TIMED_LAYERS = 6
OFFLOAD_BUCKETS = 4                         # the streamed run; 1 is sequential
CPU_ADAM_N = 336_232_258                    # BERT-large's parameters
CPU_ADAM_BYTES = 28                         # read p, g, m, v; write p, m, v (fp32)
CPU_ADAM_HP = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01)


def _host_ms(fns, iters):
    """Median host time of each of ``fns`` (name -> a CPU computation) over
    ``iters`` rounds after one warm-up round. A round runs each once, in
    turn, so that a change in the host's load falls on all of them."""
    times = {k: [] for k in fns}
    for i in range(iters + 1):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            if i:
                times[k].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def cpu_adam_case():
    """The host Adam kernel against its plain version on this machine's
    CPU at BERT-large's element count: one AdamW step from the same
    state, bit for bit; then the plain version's time (one call), and,
    in turns over 5 rounds, the kernel's, the kernel built without
    ``-ffp-contract=off``, ``torch._fused_adamw_`` on the CPU and four
    memory streams over the same arrays: a copy, an add, a sum and the
    fused AdamW again, each with its writes counted twice (write-allocate).
    The bound: 28 bytes an element at the fastest stream's rate."""
    import ctypes

    from deepspeed_tpu_torch.kernels import build
    from deepspeed_tpu_torch.ops.adam.cpu_adam import DeepSpeedCPUAdam, cpu_adam_reference

    n, hp = CPU_ADAM_N, CPU_ADAM_HP
    gen = torch.Generator().manual_seed(7)
    p0 = torch.randn(n, generator=gen)
    grad = torch.randn(n, generator=gen) * 1e-2
    opt = DeepSpeedCPUAdam(lr=hp["lr"], betas=(hp["beta1"], hp["beta2"]), eps=hp["eps"],
                           weight_decay=hp["weight_decay"])
    master = p0.clone()
    opt.init_host(master)
    ref, m, v = p0.clone(), torch.zeros(n), torch.zeros(n)
    opt.step_host(master, grad)
    plain = dict(hp, adamw=True, bias_correction=True)
    cpu_adam_reference(ref, grad, m, v, step=1, **plain)
    st = opt._host_state
    err = max(float((master - ref).abs().max()), float((st.exp_avg - m).abs().max()),
              float((st.exp_avg_sq - v).abs().max()))
    if not (torch.equal(master, ref) and torch.equal(st.exp_avg, m)
            and torch.equal(st.exp_avg_sq, v)):
        raise RuntimeError(f"cpu_adam differs from its plain version (max |err| {err})")
    # one timed call: the checked call above warmed it (~9 s a call)
    t0 = time.perf_counter()
    cpu_adam_reference(ref, grad, m, v, step=2, **plain)
    plain_ms = (time.perf_counter() - t0) * 1e3
    lib_fast = build.load_host_library(tuple(f for f in build.HOST_FLAGS
                                             if f != "-ffp-contract=off"))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    dst = torch.empty_like(p0)
    fns = {"kernel": lambda: opt.step_host(master, grad),
           "contracted_build": lambda: lib_fast.ds_adam_step(
               ptr(ref), ptr(grad), ptr(m), ptr(v), n, hp["lr"], hp["beta1"], hp["beta2"],
               hp["eps"], hp["weight_decay"], 1, 1, 1),
           "copy": lambda: dst.copy_(p0), "add": lambda: torch.add(p0, grad, out=dst),
           "sum": lambda: p0.sum()}
    fused = lambda: torch._fused_adamw_(
        [p0], [grad], [m], [v], [], [torch.tensor(1.0)], lr=hp["lr"], beta1=hp["beta1"],
        beta2=hp["beta2"], weight_decay=hp["weight_decay"], eps=hp["eps"], amsgrad=False,
        maximize=False)
    try:
        fused()
    except (RuntimeError, NotImplementedError) as e:
        library_error = str(e)[:200]
    else:
        fns["fused_adamw"], library_error = fused, None
    ms = _host_ms(fns, 5)
    # the host's memory rate: the fastest stream over arrays of n fp32, each
    # counted by the bytes it moves: an array read once, an array written
    # twice (a store to a line not in the cache first reads it)
    stream_bytes = {"copy": 3 * n * 4, "add": 4 * n * 4, "sum": n * 4,
                    "fused_adamw": (4 + 2 * 3) * n * 4}
    rates = {k: b / (ms[k] / 1e3) for k, b in stream_bytes.items() if k in ms}
    rate_from = max(rates, key=rates.get)
    del dst, p0, grad, master, m, v, ref
    return dict(case=f"AdamW step of {n} fp32 elements", max_abs_err=err, ms=ms["kernel"],
                plain_ms=plain_ms, library_ms=ms.get("fused_adamw"),
                library_error=library_error, contracted_build_ms=ms["contracted_build"],
                host_bytes_per_s=rates[rate_from], host_rate_from=rate_from,
                host_stream_ms={k: ms[k] for k in rates}, host_stream_bytes_per_s=rates,
                bound_ms=CPU_ADAM_BYTES * n / rates[rate_from] * 1e3, bound_by="bytes",
                threads=torch.get_num_threads())


def _pinned_rates():
    """D2H and H2D between the card and pinned host memory, 1 GiB, device
    time by CUDA events, median of 5."""
    dev = torch.empty(2 ** 28, device="cuda")
    host = torch.empty(2 ** 28, pin_memory=True)
    rates = {}
    for name, (dst, src) in {"d2h": (host, dev), "h2d": (dev, host)}.items():
        times = []
        for _ in range(6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        rates[f"{name}_bytes_per_s"] = 2 ** 30 / (statistics.median(times[1:]) / 1e3)
    return rates


def _zero_engine(seed=0, extra=None, layers=None, **zero):
    """BERT-large bf16 Adam as phase 6 trains it, with ``zero`` (and the
    config sections in ``extra``), from init seed ``seed``; ``layers`` cuts
    the depth (the width stays BERT-large's)."""
    import deepspeed_tpu_torch as dt

    depth = {} if layers is None else {"num_hidden_layers": int(layers)}
    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots", **depth)
    model = dt.init_bert(cfg, seed=seed, device="cuda")
    ds_config = {"train_batch_size": FB, "train_micro_batch_size_per_gpu": FB,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                 "bf16": {"enabled": True}, "zero_optimization": zero,
                 "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000,
                 **(extra or {})}
    engine, _, _, _ = dt.initialize(model=model, config=ds_config)
    return engine, _bert_batch(cfg, FB, FS)


def _free(engine):
    close = getattr(engine.optimizer, "close", None)
    if close is not None:
        close()
    del engine
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def phase_zero():
    """Phase 8: the host Adam kernel against its plain version; under
    deterministic algorithms, 3 steps of ZeRO stages 1, 2 and 3 through
    NCCL at world 1 against stage 0 (and stage 0 against itself, the
    control), and of ZeRO-2 + cpu_offload streamed against sequential, bit
    for bit; then under the default algorithms stage 0, offload
    sequential and offload streamed, 3 warm-up and 10 timed steps each:
    losses finite and falling, peak device memory under offload below
    stage 0's, the flash kernels' and the host Adam's launches."""
    import tempfile

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.zero import mem_estimator

    res = {"cpu_adam": _report("cpu_adam_case", cpu_adam_case())}
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        try:
            res["backend"] = torch.distributed.get_backend()
            # bit-for-bit comparisons of whole runs: PyTorch's deterministic
            # algorithms (with cuBLAS's fixed workspaces, set in main)
            torch.use_deterministic_algorithms(True)
            try:
                res["bit_for_bit"] = _zero_equalities(failures)
            finally:
                torch.use_deterministic_algorithms(False)
            res["timed"] = _zero_timed(dt, failures)
            res["default_algorithms"] = _default_algorithms_probe()
        finally:
            torch.distributed.destroy_process_group()
    res["mem_estimate_gb"] = {
        name: {k: v / 2 ** 30 for k, v in mem_estimator.estimate_zero_model_states_mem_needs(
            CPU_ADAM_N, **kw).items() if k != "breakdown"}
        for name, kw in (("stage0", dict(stage=0)), ("stage2", dict(stage=2)),
                         ("offload_seq", dict(stage=2, cpu_offload=True)),
                         ("offload_stream", dict(stage=2, cpu_offload=True,
                                                 offload_stream_buckets=OFFLOAD_BUCKETS)))}
    res["pinned"] = _pinned_rates()
    res["failures"] = failures
    if failures:    # every check of the phase ran; any failure fails it
        print("zero", json.dumps(res), flush=True)
        raise RuntimeError("phase zero failed: " + "; ".join(failures))
    return res


OFFLOAD_SEQUENTIAL = dict(stage=2, cpu_offload=True, offload_stream_buckets=1)
OFFLOAD_STREAMED = dict(stage=2, cpu_offload=True, offload_stream_buckets=OFFLOAD_BUCKETS)


def _host_masters(engine):
    """A host copy of the engine's fp32 masters, by name."""
    return {k: v.to("cpu", copy=True) for k, v in engine.master_params().items()}


def _zero_equalities(failures):
    """ZERO_STEPS steps of each run from the same weights and batch; each
    run's losses and final fp32 masters against its reference's."""
    runs = {}
    for label, zero in (("stage0", dict(stage=0)), ("stage0_again", dict(stage=0)),
                        ("stage1", dict(stage=1)), ("stage2", dict(stage=2)),
                        ("stage3", dict(stage=3)), ("offload_sequential", OFFLOAD_SEQUENTIAL),
                        ("offload_streamed", OFFLOAD_STREAMED)):
        engine, batch = _zero_engine(layers=ZERO_EQUAL_LAYERS, **zero)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(engine.train_step([batch])) for _ in range(ZERO_STEPS)]
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs[label] = (losses, _host_masters(engine), peak)
        _free(engine)
    out = {}
    for label, against in (("stage0_again", "stage0"), ("stage1", "stage0"),
                           ("stage2", "stage0"), ("stage3", "stage0"),
                           ("offload_streamed", "offload_sequential")):
        (losses, master, peak), (want_losses, want_master, _) = runs[label], runs[against]
        diff = {k: float((master[k] - w).abs().max()) for k, w in want_master.items()
                if not torch.equal(master[k], w)}
        same = losses == want_losses and not diff
        worst = sorted(diff.items(), key=lambda kv: -kv[1])[:5]
        out[label] = dict(against=against, equal=same, losses=losses, peak_mem_gb=peak,
                          params_differing=len(diff), worst_param_diffs=worst)
        if not same:
            failures.append(f"{label} differs from {against}: losses {losses} against "
                            f"{want_losses}, {len(diff)} masters differ, {worst}")
    out["stage0"] = dict(losses=runs["stage0"][0], peak_mem_gb=runs["stage0"][2])
    return out


def _embedding_backward_kernels(engine, batch):
    """The CUDA kernels of one training step whose names mark the
    embedding tables' backward (``compute_grad_weight*``, ``sum_and_scatter``),
    with their launch counts."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        engine.train_step([batch])
        torch.cuda.synchronize()
    names = {}
    for e in prof.events():
        m = re.search(r"(compute_grad_weight\w*|sum_and_scatter|krn_partial_to_segment_idx)",
                      e.name)
        if e.device_type == torch.autograd.DeviceType.CUDA and m:
            names[m.group(1)] = names.get(m.group(1), 0) + 1
    return names


def _default_algorithms_probe():
    """Report only: why the bit-for-bit runs use deterministic algorithms.
    Stage 0 twice under the default algorithms (ZERO_STEPS steps each from
    the same weights and batch: do the runs agree?), and the embedding
    backward's kernels in a step under each mode."""
    runs, kernels = [], {}
    for _ in range(2):
        engine, batch = _zero_engine(layers=ZERO_EQUAL_LAYERS, stage=0)
        losses = [float(engine.train_step([batch])) for _ in range(ZERO_STEPS)]
        runs.append((losses, _host_masters(engine)))
        if len(runs) == 2:
            kernels["default"] = _embedding_backward_kernels(engine, batch)
            torch.use_deterministic_algorithms(True)
            try:
                kernels["deterministic"] = _embedding_backward_kernels(engine, batch)
            finally:
                torch.use_deterministic_algorithms(False)
        _free(engine)
    (la, ma), (lb, mb) = runs
    diff = {k: float((mb[k] - w).abs().max()) for k, w in ma.items() if not torch.equal(mb[k], w)}
    return dict(stage0_twice_equal=la == lb and not diff, losses=[la, lb],
                params_differing=sorted(diff.items(), key=lambda kv: -kv[1])[:5],
                embedding_backward_kernels=kernels)


def _zero_timed(dt, failures):
    """Stage 0, offload sequential and offload streamed under the default
    algorithms, in that order: TRAIN_WARMUP steps, then TRAIN_STEPS timed
    on the host clock (synchronized)."""
    out = {}
    for label, zero in (("stage0", dict(stage=0)), ("sequential", OFFLOAD_SEQUENTIAL),
                        ("streamed", OFFLOAD_STREAMED)):
        offload = zero.get("cpu_offload", False)
        engine, batch = _zero_engine(layers=ZERO_TIMED_LAYERS, **zero)
        losses = [float(engine.train_step([batch])) for _ in range(TRAIN_WARMUP)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt.kernels.reset_launch_counts()
        stats, timed = [], []
        t0 = time.perf_counter()
        for _ in range(TRAIN_STEPS):
            timed.append(engine.train_step([batch]))
            if offload:
                stats.append(dict(engine.optimizer.last_offload_stats))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, host_counts = dt.kernels.launch_counts(), dt.kernels.host_launch_counts()
        losses += [float(x) for x in timed]
        run = out[label] = dict(
            zero=zero, step_ms=1e3 * wall / TRAIN_STEPS, samples_per_s=FB * TRAIN_STEPS / wall,
            losses=losses, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
            launches={k: counts[k] for k in FLASH_KERNELS},
            cpu_adam_launches=host_counts["cpu_adam"])
        if offload:
            run.update(offload_stats_mean={k: statistics.mean(s[k] for s in stats)
                                           for k in stats[0]},
                       offload_stats_last=stats[-1])
        _free(engine)
        if run["launches"] != {k: v * ZERO_TIMED_LAYERS // 24 * TRAIN_STEPS
                               for k, v in FLASH_PER_STEP.items()}:
            failures.append(f"timed {label}: flash launches {run['launches']}")
        if offload and run["cpu_adam_launches"] <= 0:
            failures.append(f"offload {label}: the host Adam never launched")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            failures.append(f"timed {label}: losses {losses}")
        if offload and not run["peak_mem_gb"] < out["stage0"]["peak_mem_gb"]:
            failures.append(f"offload {label}: peak {run['peak_mem_gb']} GiB not below "
                            f"stage 0's {out['stage0']['peak_mem_gb']}")
    out["step_over_stage0"] = {k: out[k]["step_ms"] / out["stage0"]["step_ms"]
                               for k in ("sequential", "streamed")}
    return out


CKPT_STEPS = 3
# the runs' depth (BERT-large's width): 3 of 24 layers (6 before phase 17
# joined the script) keep the three tags and their saves and loads inside
# the script's time limit
CKPT_LAYERS = 3
CKPT_RUNS = (("stage0", dict(stage=0)), ("offload_streamed", OFFLOAD_STREAMED),
             ("stage3", dict(stage=3)))
CKPT_SPACE_FACTOR = 2.5        # free space needed, in tags of the largest size
CKPT_TRACE_NAMES = ("train/checkpoint_save", "checkpoint/commit", "train/fwd_bwd_opt_step")


class _CallTimes:
    """Wraps functions of the checkpoint path for the time of a ``with``:
    the seconds spent in each, summed by label (the save's D2H,
    serialization, digest and write with fsync). A recursive function
    (``_host_tree``) counts its outermost calls only."""

    def __init__(self, targets):
        self.targets = targets       # {label: (owner, attribute name)}
        self.seconds = {}

    def __enter__(self):
        self._saved = []
        depth = {}
        for label, (owner, name) in self.targets.items():
            fn = getattr(owner, name)
            self._saved.append((owner, name, fn))
            self.seconds[label] = 0.0
            depth[label] = 0

            def timed(*a, _fn=fn, _label=label, **kw):
                depth[_label] += 1
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    depth[_label] -= 1
                    if depth[_label] == 0:
                        self.seconds[_label] += time.perf_counter() - t0
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False


def _ckpt_call_targets():
    from deepspeed_tpu_torch.runtime import engine as eng_mod
    from deepspeed_tpu_torch.runtime.checkpoint import storage
    from deepspeed_tpu_torch.runtime.zero import sharded_optimizer as zero_mod

    return {"d2h_s": (eng_mod, "_host_tree"), "d2h_shard_s": (zero_mod, "_host_copy"),
            "serialize_s": (eng_mod, "_serialize"),
            "digest_s": (storage, "digests_of_bytes"),
            "write_fsync_s": (storage.CheckpointStorage, "atomic_write_bytes"),
            "read_s": (storage.CheckpointStorage, "read_bytes"),
            "deserialize_s": (eng_mod, "_deserialize")}


def _host_ram_gb():
    info = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            info[key] = int(val.split()[0]) * 1024 / 1e9
    return {"total_gb": info["MemTotal"], "available_gb": info["MemAvailable"]}


def _tag_bytes(tag_dir):
    return sum(os.path.getsize(os.path.join(tag_dir, n)) for n in os.listdir(tag_dir))


def _ckpt_run(label, zero, root, failures, dt):
    """CKPT_STEPS steps, a save, CKPT_STEPS more; then a fresh engine (init
    seed 99) loads the tag and trains the same steps. Returns the run's
    report; its checks append to ``failures``."""
    import shutil

    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    armed = label == "stage0"
    extra = {"telemetry": {"enabled": True, "trace_max_events": 1 << 16}} if armed else None
    engine, batch = _zero_engine(extra=extra, layers=CKPT_LAYERS, **zero)
    [engine.train_step([batch]) for _ in range(CKPT_STEPS)]
    torch.cuda.synchronize()
    with _CallTimes(_ckpt_call_targets()) as save_times:
        t0 = time.perf_counter()
        engine.save_checkpoint(root, tag=label)
        save_s = time.perf_counter() - t0
    at_save = _host_masters(engine) if zero.get("cpu_offload") else None
    want = [float(engine.train_step([batch])) for _ in range(CKPT_STEPS)]
    want_master = _host_masters(engine)
    _free(engine)
    tag_dir = os.path.join(root, label)
    nbytes = _tag_bytes(tag_dir)
    run = dict(zero=zero, tag_bytes=nbytes, save_s=save_s, save_gb_per_s=nbytes / save_s / 1e9,
               save_breakdown_s={k: v for k, v in save_times.seconds.items()
                                 if k not in ("read_s", "deserialize_s")},
               files={n: os.path.getsize(os.path.join(tag_dir, n))
                      for n in sorted(os.listdir(tag_dir))})
    if at_save is not None:
        t0 = time.perf_counter()
        sd = get_fp32_state_dict_from_zero_checkpoint(root, tag=label)
        run["zero_to_fp32_s"] = time.perf_counter() - t0
        differ = [k for k, v in at_save.items() if not torch.equal(sd[k], v)]
        run["zero_to_fp32_equal"] = not differ and list(sd) == list(at_save)
        if not run["zero_to_fp32_equal"]:
            failures.append(f"ckpt {label}: zero_to_fp32 differs from the masters at the "
                            f"save in {len(differ)} parameters, e.g. {differ[:3]}")
        del sd, at_save
    resumed, batch = _zero_engine(seed=99, layers=CKPT_LAYERS, **zero)
    torch.cuda.synchronize()
    with _CallTimes(_ckpt_call_targets()) as load_times:
        t0 = time.perf_counter()
        name, _ = resumed.load_checkpoint(root, tag=label)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    run.update(load_s=load_s, load_gb_per_s=nbytes / load_s / 1e9,
               load_breakdown_s={k: load_times.seconds[k] for k in
                                 ("read_s", "digest_s", "deserialize_s")})
    if name is None or resumed.global_steps != CKPT_STEPS:
        failures.append(f"ckpt {label}: load gave {name} at step {resumed.global_steps}")
    dt.kernels.reset_launch_counts()
    got = [float(resumed.train_step([batch])) for _ in range(CKPT_STEPS)]
    counts = dt.kernels.launch_counts()
    got_master = _host_masters(resumed)
    run["launches"] = {k: counts[k] for k in FLASH_KERNELS}
    diff = {k: float((got_master[k] - w).abs().max()) for k, w in want_master.items()
            if not torch.equal(got_master[k], w)}
    run.update(losses_uninterrupted=want, losses_resumed=got, equal=got == want and not diff,
               params_differing=len(diff),
               worst_param_diffs=sorted(diff.items(), key=lambda kv: -kv[1])[:5])
    if not run["equal"]:
        failures.append(f"ckpt {label}: the resumed run differs: losses {got} against "
                        f"{want}, {len(diff)} masters differ, {run['worst_param_diffs']}")
    if run["launches"] != {k: v * CKPT_LAYERS // 24 * CKPT_STEPS
                           for k, v in FLASH_PER_STEP.items()}:
        failures.append(f"ckpt {label}: flash launches {run['launches']} in "
                        f"{CKPT_STEPS} resumed steps")
    if armed:
        run["telemetry"] = _ckpt_trace(resumed, batch, failures, dt)
    _free(resumed)
    shutil.rmtree(tag_dir)       # one tag at a time
    return run


def _ckpt_trace(engine, batch, failures, dt):
    """The armed stage-0 run's trace: written to build/, each event name
    counted and the checkpoint and step spans checked; then the tracer is
    disarmed. Report only: the step with telemetry armed and disarmed, in
    turns under the default algorithms."""
    tracer = dt.telemetry.get_tracer()
    path = tracer.write(os.path.join("build", "ckpt_trace.json"))
    names = {}
    for e in tracer.events():
        names[e["name"]] = names.get(e["name"], 0) + 1
    missing = [n for n in CKPT_TRACE_NAMES if not names.get(n)]
    if missing:
        failures.append(f"ckpt stage0: the trace lacks {missing}: {names}")
    torch.use_deterministic_algorithms(False)
    steps = {"armed": [], "disarmed": []}
    try:
        for _ in range(2):
            for mode in ("disarmed", "armed"):
                dt.telemetry.configure(mode == "armed")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(CKPT_STEPS):
                    engine.train_step([batch])
                torch.cuda.synchronize()
                steps[mode].append(1e3 * (time.perf_counter() - t0) / CKPT_STEPS)
    finally:
        torch.use_deterministic_algorithms(True)
        dt.telemetry.configure(False)
        tracer.clear()
    return dict(trace_file=path, event_counts=names, step_ms=steps)


def phase_ckpt():
    """Phase 9: save and resume at BERT-large under deterministic
    algorithms, through NCCL at world 1 (see the module's docstring)."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch as dt

    with torch.device("meta"):
        n = sum(p.numel() for p in dt.BertForPreTraining(dt.BertConfig.bert_large(
            num_hidden_layers=CKPT_LAYERS)).parameters())
    res = {"card": card_info(), "host_ram": _host_ram_gb(), "params": n,
           "layers": CKPT_LAYERS,
           # module (fp32 masters) + Adam m and v; ZeRO adds the flat master
           "expected_tag_gb": {"stage0": 12 * n / 1e9, "zero": 16 * n / 1e9}}
    failures = []
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="ckpt_") as root:
        free = shutil.disk_usage(root).free
        res["free_gb"] = free / 1e9
        need = CKPT_SPACE_FACTOR * 16 * n
        if free < need:
            raise RuntimeError(f"phase ckpt: {free / 1e9:.1f} GB free under {root}, "
                               f"{CKPT_SPACE_FACTOR} x the largest tag "
                               f"({16 * n / 1e9:.2f} GB) needs {need / 1e9:.1f} GB")
        store = torch.distributed.FileStore(os.path.join(root, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        torch.use_deterministic_algorithms(True)
        try:
            res["runs"] = {}
            for label, zero in CKPT_RUNS:
                res["runs"][label] = _report("ckpt_run", dict(
                    label=label, card=res["card"],
                    **_ckpt_run(label, zero, root, failures, dt)))
                largest = max(r["tag_bytes"] for r in res["runs"].values())
                free = shutil.disk_usage(root).free
                if free < CKPT_SPACE_FACTOR * largest:
                    failures.append(f"ckpt: {free / 1e9:.1f} GB free after {label}, below "
                                    f"{CKPT_SPACE_FACTOR} x its {largest / 1e9:.2f} GB tag")
        finally:
            torch.use_deterministic_algorithms(False)
            torch.distributed.destroy_process_group()
    res["failures"] = failures
    if failures:    # every check of the phase ran; any failure fails it
        print("ckpt", json.dumps(res), flush=True)
        raise RuntimeError("phase ckpt failed: " + "; ".join(failures))
    return res


# ---------------------------------------------------------------------------
# phase 10: resilience, the launcher and the comm deadline at BERT-large
# ---------------------------------------------------------------------------

RESIL_STEPS = 6
RESIL_SAVE_AT = 2              # part a: the rollback target
RESIL_NAN_AT = 4               # part a: the step whose loss is NaN
RESIL_KILL_AT = 4              # part b: SIGKILL at this step boundary
RESIL_PREEMPT_AT = 3           # part b: SIGTERM at this step boundary
RESIL_DEADLINE_S = 2.0         # part c: resilience.comm_timeout_s
RESIL_SLACK_S = 1.0
RESIL_KEEP = 2                 # tags live on disk at once (checkpoint.keep_last_k)
# the phase trains BERT-large's width at a twelfth of its depth, in process
# and in part b's workers: rollback and the launcher's restart path do not
# depend on depth, and the script must end inside its time limit with
# phases 11-14 after it
RESIL_LAUNCH_LAYERS = 2
RESTART_LOG = re.compile(r"worker (\w+) \(exit (-?\d+)\); restart (\d+)/(\d+) in ([\d.]+)s")

# the launcher's worker: phase 6's bf16 Adam BERT-large under deterministic
# algorithms, a resilience block with one cluster fault arm, a save every 2
# steps (at most RESIL_KEEP tags kept); resumes from the newest committed tag.
# One JSON line an incarnation: its launches a step, its times, and at the
# end the masters' SHA-256.
RESIL_WORKER = '''\
import hashlib, json, os, sys, time
t_start = time.time()
sys.path.insert(0, os.environ["RESIL_REPO"])
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
import chip_smoke as cs
import deepspeed_tpu_torch as dt

ck, fault = os.environ["RESIL_CKPT"], os.environ["RESIL_FAULT"]
point, at = {"kill": ("kill_worker", cs.RESIL_KILL_AT),
             "preempt": ("preempt_signal", cs.RESIL_PREEMPT_AT)}[fault]
resilience = {"max_recoveries": 2, "recovery_backoff_s": 0, "preemption_save_dir": ck,
              "fault_injection": {point: {"at_step": at, "marker": os.environ["RESIL_MARKER"]}}}
engine, _ = cs._zero_engine(extra={"resilience": resilience,
                                   "checkpoint": {"keep_last_k": cs.RESIL_KEEP}},
                            layers=cs.RESIL_LAUNCH_LAYERS, stage=0)
cfg = engine.module.config
batches = [cs._bert_batch(cfg, cs.FB, cs.FS, seed=i) for i in range(cs.RESIL_STEPS)]
t_built = time.time()
name, _ = engine.load_checkpoint(ck)
torch.cuda.synchronize()
rec = dict(pid=os.getpid(), local_rank=os.environ.get("LOCAL_RANK"),
           world_size=os.environ.get("WORLD_SIZE"), resumed_from=name,
           start_step=engine.global_steps, build_s=t_built - t_start,
           load_s=time.time() - t_built, launches=[], losses=[], saves_s=[])
log = open(os.environ["RESIL_LOG"], "a")
while engine.global_steps < cs.RESIL_STEPS:
    dt.kernels.reset_launch_counts()
    rec["losses"].append(engine.train_batch(iter([batches[engine.global_steps]])))
    c = dt.kernels.launch_counts()
    rec["launches"].append([c[k] for k in cs.FLASH_KERNELS])
    if len(rec["losses"]) == 1:
        rec["resume_s"] = time.time() - t_start    # start to the first step done
    if engine.global_steps % 2 == 0:
        t0 = time.time()
        engine.save_checkpoint(ck)
        rec["saves_s"].append(time.time() - t0)
h = hashlib.sha256()
for k, v in engine.master_params().items():
    h.update(v.detach().cpu().numpy().tobytes())
rec.update(sha256=h.hexdigest(), end_step=engine.global_steps, wall_s=time.time() - t_start)
log.write(json.dumps(rec) + "\\n")
log.close()
'''


def _masters_sha256(masters):
    h = hashlib.sha256()
    for v in masters.values():
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def _resil_engine(resilience=None, layers=None):
    extra = {"checkpoint": {"keep_last_k": RESIL_KEEP}}
    if resilience is not None:
        extra["resilience"] = resilience
    engine, _ = _zero_engine(extra=extra, layers=layers, stage=0)
    cfg = engine.module.config
    return engine, [_bert_batch(cfg, FB, FS, seed=i) for i in range(RESIL_STEPS)]


def _counting_steps(engine, dt):
    """Wrap the engine's unsupervised step (what the supervisor runs,
    replays included) to record each call's flash launches."""
    calls = []
    raw = engine._train_batch_now

    def step(micro):
        before = dt.kernels.launch_counts()
        loss = raw(micro)
        after = dt.kernels.launch_counts()
        calls.append([after[k] - before[k] for k in FLASH_KERNELS])
        return loss

    engine._train_batch_now = step
    return calls


def _resil_rollback(root, dt, failures):
    """Part a: a clean run, then the same 6 steps with a NaN loss at step 4
    after a save at step 2 (step timeout 60 s, so the steps run on the
    watchdog's thread): one recovery, and losses and masters equal to the
    clean run's. Returns the report, the faulty engine (for parts a' and c)
    and the clean masters."""
    engine, batches = _resil_engine(layers=RESIL_LAUNCH_LAYERS)
    calls = _counting_steps(engine, dt)
    it = iter(batches)
    clean = [engine.train_batch(it) for _ in range(RESIL_STEPS)]
    clean_masters = _host_masters(engine)
    _free(engine)
    resilience = {"max_recoveries": 2, "recovery_backoff_s": 0, "divergence_check": True,
                  "step_timeout_s": 60.0, "comm_timeout_s": RESIL_DEADLINE_S,
                  "fault_injection": {"nan_loss": {"at_step": RESIL_NAN_AT}}}
    engine, batches = _resil_engine(resilience, layers=RESIL_LAUNCH_LAYERS)
    fcalls = _counting_steps(engine, dt)
    it, losses = iter(batches), []
    ckpt = os.path.join(root, "rollback")
    t_fault = None
    for _ in range(RESIL_STEPS):
        if engine.global_steps == RESIL_NAN_AT:
            t_fault = time.perf_counter()
        losses.append(engine.train_batch(it))
        if engine.global_steps == RESIL_NAN_AT + 1:
            recover_s = time.perf_counter() - t_fault   # the failing step, rollback, replay
        if engine.global_steps == RESIL_SAVE_AT:
            t0 = time.perf_counter()
            engine.save_checkpoint(ckpt)
            save_s = time.perf_counter() - t0
    masters = _host_masters(engine)
    diff = {k: float((masters[k] - v).abs().max()) for k, v in clean_masters.items()
            if not torch.equal(masters[k], v)}
    want = [FLASH_PER_STEP[k] * RESIL_LAUNCH_LAYERS // 24 for k in FLASH_KERNELS]
    res = dict(recoveries=engine.resilience.total_recoveries,
               quarantined=engine.resilience.quarantined_steps,
               losses=losses, losses_clean=clean, equal=losses == clean and not diff,
               params_differing=len(diff), save_s=save_s, recovery_s=recover_s,
               launches_per_call_clean=calls, launches_per_call=fcalls,
               steps_run=len(fcalls))
    if res["recoveries"] != 1:
        failures.append(f"resil a: {res['recoveries']} recoveries, expected 1")
    if not res["equal"]:
        failures.append(f"resil a: recovered run differs from the clean one: losses {losses} "
                        f"against {clean}, {len(diff)} masters differ")
    # 6 steps, the failing step once more, and the replay of steps 2..3
    if len(fcalls) != RESIL_STEPS + 1 + (RESIL_NAN_AT - RESIL_SAVE_AT) or \
            any(c != want for c in calls + fcalls):
        failures.append(f"resil a: flash launches a step {fcalls} (clean {calls}), "
                        f"expected {want} on each of "
                        f"{RESIL_STEPS + 1 + RESIL_NAN_AT - RESIL_SAVE_AT} calls")
    return res, engine, ckpt, clean_masters


def _resil_default_replay(engine, ckpt, dt):
    """Part a', report only: under the default algorithms, two replays of
    the steps after the step-2 tag from the same loaded state; their
    masters' largest difference is what a rollback's replay can drift by
    when the algorithms are not deterministic."""
    torch.use_deterministic_algorithms(False)
    try:
        batches = [_bert_batch(engine.module.config, FB, FS, seed=i) for i in range(RESIL_STEPS)]
        runs = []
        for _ in range(2):
            engine.load_checkpoint(ckpt, tag=f"global_step{RESIL_SAVE_AT}")
            for i in range(RESIL_SAVE_AT, RESIL_STEPS):
                type(engine)._train_batch_now(engine, [batches[i]])   # not the counting wrapper
            runs.append(_host_masters(engine))
    finally:
        torch.use_deterministic_algorithms(True)
    worst = max(float((runs[0][k] - v).abs().max()) for k, v in runs[1].items())
    differing = sum(not torch.equal(runs[0][k], v) for k, v in runs[1].items())
    return dict(max_abs_diff=worst, params_differing=differing, params=len(runs[0]))


def _resil_deadline(engine, root, failures):
    """Part c: a healthy control barrier over the NCCL group's gloo twin
    at world 1, then a save whose commit barrier hangs (hang_barrier arm):
    CommTimeoutError within the deadline plus the slack."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.runtime import engine as eng_mod

    t0 = time.perf_counter()
    comm.barrier("healthy", timeout_s=30)
    healthy_s = time.perf_counter() - t0
    engine.resilience.injector.arm_cluster("hang_barrier", seconds=30.0, times=1)
    raised = None
    with _CallTimes({"barrier_s": (eng_mod.DeepSpeedEngine, "_ckpt_commit_barrier")}) as t:
        t0 = time.perf_counter()
        try:
            engine.save_checkpoint(os.path.join(root, "deadline"))
        except comm.CommTimeoutError as e:
            raised = str(e)
        save_s = time.perf_counter() - t0
    res = dict(healthy_barrier_s=healthy_s, raised=raised, barrier_s=t.seconds["barrier_s"],
               save_s=save_s, deadline_s=RESIL_DEADLINE_S, slack_s=RESIL_SLACK_S,
               backend=torch.distributed.get_backend())
    if raised is None:
        failures.append("resil c: the hung commit barrier did not raise CommTimeoutError")
    elif not t.seconds["barrier_s"] < RESIL_DEADLINE_S + RESIL_SLACK_S:
        failures.append(f"resil c: CommTimeoutError after {t.seconds['barrier_s']:.2f} s, past "
                        f"{RESIL_DEADLINE_S} + {RESIL_SLACK_S} s")
    return res


def _resil_launch(fault, root, want_sha, failures):
    """Part b: the worker through the runner (one GPU), with a kill or a
    preemption at a step boundary; one restart, and the masters' SHA-256
    equal to the uninterrupted run's."""
    import shutil

    work = os.path.join(root, fault)
    os.makedirs(work)
    script = os.path.join(work, "worker.py")
    with open(script, "w") as f:
        f.write(RESIL_WORKER)
    env = dict(os.environ, RESIL_REPO=os.getcwd(), RESIL_FAULT=fault,
               RESIL_CKPT=os.path.join(work, "ckpt"), RESIL_MARKER=os.path.join(work, "fired"),
               RESIL_LOG=os.path.join(work, "incarnations.jsonl"))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
              "DSTPU_PREEMPTION", "DSTPU_HEARTBEAT_FILE"):
        env.pop(k, None)
    log_path = os.path.join("build", f"resil_{fault}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.run(
            # a hostfile that does not exist keeps the runner on this machine's
            # one-GPU path, whatever hostfile the machine holds at the default path
            [sys.executable, "-m", "deepspeed_tpu_torch.launcher.runner",
             "-H", os.path.join(work, "no_hostfile"), "--num_gpus", "1",
             "--max_restarts", "1", "--heartbeat_timeout_s", "600", script],
            env=env, stdout=log, stderr=subprocess.STDOUT, timeout=900)
    wall = time.perf_counter() - t0
    text = open(log_path).read()
    restarts = [dict(cls=m[0], exit=int(m[1]), restart=int(m[2]), delay_s=float(m[4]))
                for m in RESTART_LOG.findall(text)]
    with open(env["RESIL_LOG"]) as f:
        lives = [json.loads(line) for line in f]
    want_launches = [FLASH_PER_STEP[k] * RESIL_LAUNCH_LAYERS // 24 for k in FLASH_KERNELS]
    res = dict(rc=proc.returncode, wall_s=wall, restarts=restarts, log=log_path,
               incarnations=[{k: v for k, v in life.items() if k != "losses"}
                             for life in lives])
    expect = {"kill": ("crash", -9, RESIL_KILL_AT), "preempt": ("preempted", 99,
                                                                RESIL_PREEMPT_AT)}[fault]
    last = lives[-1] if lives else {}
    if proc.returncode != 0:
        failures.append(f"resil b {fault}: the runner exited {proc.returncode} ({log_path})")
    if len(restarts) != 1 or (restarts[0]["cls"], restarts[0]["exit"]) != expect[:2]:
        failures.append(f"resil b {fault}: restarts {restarts}, expected one {expect[:2]}")
    elif fault == "preempt" and restarts[0]["delay_s"] != 0.0:
        failures.append(f"resil b preempt: restarted after {restarts[0]['delay_s']} s of backoff")
    if len(lives) != 1 or last.get("start_step") != expect[2] or \
            last.get("resumed_from") is None:
        failures.append(f"resil b {fault}: the restarted worker resumed at "
                        f"{last.get('start_step')} from {last.get('resumed_from')} "
                        f"({len(lives)} finished incarnations), expected step {expect[2]}")
    if last.get("sha256") != want_sha:
        failures.append(f"resil b {fault}: masters' SHA-256 {last.get('sha256')} differs from "
                        f"the uninterrupted run's {want_sha}")
    if any(c != want_launches for life in lives for c in life["launches"]):
        failures.append(f"resil b {fault}: flash launches a step "
                        f"{[life['launches'] for life in lives]}")
    shutil.rmtree(work)
    return res


def phase_resil():
    """Phase 10 (see the module's docstring): at BERT-large, rollback in
    process, kill and preemption through the launcher, and the commit
    barrier's deadline, under deterministic algorithms."""
    import shutil
    import tempfile

    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch import comm

    res = {"card": card_info()}
    failures = []
    tag_bytes = 12 * CPU_ADAM_N      # stage 0: the fp32 masters, Adam's m and v
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="resil_") as root:
        free = shutil.disk_usage(root).free
        res["free_gb"] = free / 1e9
        if free < (RESIL_KEEP + 1) * tag_bytes:
            raise RuntimeError(f"phase resil: {free / 1e9:.1f} GB free under {root}; "
                               f"{RESIL_KEEP + 1} tags of {tag_bytes / 1e9:.2f} GB need more")
        store = torch.distributed.FileStore(os.path.join(root, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        torch.use_deterministic_algorithms(True)
        try:
            t0 = time.perf_counter()
            res["rollback"], engine, ckpt, clean_masters = _resil_rollback(root, dt, failures)
            res["rollback"]["s"] = time.perf_counter() - t0
            _report("resil_rollback", res["rollback"])
            res["default_algorithms_replay"] = _report(
                "resil_default_replay", _resil_default_replay(engine, ckpt, dt))
            t0 = time.perf_counter()
            res["deadline"] = _report("resil_deadline", _resil_deadline(engine, root, failures))
            res["deadline"]["s"] = time.perf_counter() - t0
            _free(engine)
            shutil.rmtree(ckpt, ignore_errors=True)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.distributed.destroy_process_group()
            comm.forget_timeout()
        # part a's clean run is the uninterrupted run the workers must end on
        res["uninterrupted_sha256"] = _masters_sha256(clean_masters)
        del clean_masters
        torch.cuda.empty_cache()
        # the two runner jobs share nothing but the card: they run side by
        # side (each worker's times are reported, not checked)
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(2) as pool:
            jobs = {fault: pool.submit(_resil_launch, fault, root,
                                       res["uninterrupted_sha256"], failures)
                    for fault in ("kill", "preempt")}
            res["launcher"] = {fault: _report("resil_launch", dict(
                fault=fault, layers=RESIL_LAUNCH_LAYERS, side_by_side=True,
                **job.result())) for fault, job in jobs.items()}
    res["failures"] = failures
    if failures:    # every check of the phase ran; any failure fails it
        print("resil", json.dumps(res), flush=True)
        raise RuntimeError("phase resil failed: " + "; ".join(failures))
    return res


# ---------------------------------------------------------------------------
# phase 11 (pld): progressive layer drop and the SQuAD head at BERT-large
# ---------------------------------------------------------------------------

PLD_STEPS = 10
PLD_SECTION = {"enabled": True, "theta": 0.5, "gamma": 0.001}   # the PLD paper's values
PLD_EQUAL_STEPS = 3
# DeepSpeedExamples BingBertSquad deepspeed_bsz24_config.json: batch 24, Adam
# lr 3e-5 without weight decay or bias correction, clipping 1.0, fp16 with
# dynamic loss scaling. Its 24 spread over 8 GPUs at 3 a GPU; here one card
# takes all 24 as one micro-batch. The scaler starts at 2**16 as phase 6's
# does (DeepSpeed's default 2**32 would skip the first 16 of the 10 steps).
QA_SEQ, QA_BATCH, QA_STEPS = 384, 24, 10
QA_CONFIG = {"train_batch_size": QA_BATCH, "train_micro_batch_size_per_gpu": QA_BATCH,
             "gradient_accumulation_steps": 1,
             "optimizer": {"type": "Adam", "params": {"lr": 3e-5, "weight_decay": 0.0,
                                                      "bias_correction": False}},
             "gradient_clipping": 1.0,
             "fp16": {"enabled": True, "loss_scale": 0, "initial_scale_power": 16},
             "activation_checkpointing": {"enabled": True}, "steps_per_print": 1000}


def _flash_per_step(counts, steps, label):
    per = {k: counts[k] / steps for k in FLASH_KERNELS}
    if per != FLASH_PER_STEP:
        raise RuntimeError(f"{label}: flash launches a step {per}, not {FLASH_PER_STEP}")
    return per


def _pld_run(extra, steps, batch, dt, record=None):
    """bf16 Adam BERT-large (phase 6's) with ``extra`` config sections:
    ``steps`` timed steps on ``batch``; theta checked against the schedule
    before every step. Returns the run's numbers and the engine."""
    engine, _ = _zero_engine(extra=extra, stage=0)
    pld = engine.progressive_layer_drop
    losses, thetas = [], []
    dt.kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(steps):
        if pld is not None:
            want = 1.0 if i == 0 else (1 - PLD_SECTION["theta"]) * math.exp(
                -PLD_SECTION["gamma"] * i) + PLD_SECTION["theta"]
            if abs(pld.get_theta() - want) > 1e-12:
                raise RuntimeError(f"step {i}: theta {pld.get_theta()}, schedule {want}")
            thetas.append(pld.get_theta())
        losses.append(engine.train_step([batch]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    return dict(step_ms=1e3 * wall / steps, losses=[float(x) for x in losses],
                thetas=thetas, launches={k: counts[k] for k in FLASH_KERNELS}), engine


def _qa_batch(cfg, seed=0):
    """Seeded synthetic SQuAD spans: ids, a question/context token-type split,
    padding in the tail of some rows, start <= end inside the context."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (QA_BATCH, QA_SEQ))
    qlen = rng.randint(16, 64, QA_BATCH)
    types = (np.arange(QA_SEQ)[None, :] >= qlen[:, None]).astype(np.int64)
    length = rng.randint(QA_SEQ // 2, QA_SEQ + 1, QA_BATCH)
    mask = (np.arange(QA_SEQ)[None, :] < length[:, None]).astype(np.int64)
    start = qlen + rng.randint(0, 64, QA_BATCH)
    end = np.minimum(start + rng.randint(0, 30, QA_BATCH), length - 1)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.long, device="cuda")
    return tuple(as_t(x) for x in (ids, types, mask, start, end))


def phase_pld():
    """Progressive layer drop at BERT-large through ``initialize()`` (phase 6's
    bf16 Adam run with a ``progressive_layer_drop`` block): theta on its
    schedule step for step, the flash kernels 48/24/24 a step, the loss
    finite and falling, the step time against PLD off and each layer's
    kept share; theta = 1 equal to PLD off bit for bit over 3 steps under
    deterministic algorithms; then ``BertForQuestionAnswering`` at BERT-large
    and S = 384 fine-tuned in fp16 with BingBertSquad's settings: the fp16
    flash routines 48/24/24 a step, the loss finite and falling."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models import bert as tbert

    cfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    batch = _bert_batch(cfg, FB, FS)
    res = dict(model="bert_large (seed 0), phase 6's bf16 Adam run", pld=PLD_SECTION,
               steps=PLD_STEPS)
    off, engine = _pld_run({}, PLD_STEPS, batch, dt)
    _free(engine)
    draws = []
    real = tbert.pld_coins

    def recording(L, theta, device, pld_seed=None, keep=None):
        draws.append((L, theta, pld_seed))
        return real(L, theta, device, pld_seed, keep)

    tbert.pld_coins = recording
    try:
        on, engine = _pld_run({"progressive_layer_drop": PLD_SECTION}, PLD_STEPS, batch, dt)
    finally:
        tbert.pld_coins = real
    _free(engine)
    kept = np.mean([real(L, th, "cpu", seed)[0].numpy() for L, th, seed in draws], axis=0)
    _flash_per_step(on["launches"], PLD_STEPS, "pld")
    if not all(np.isfinite(on["losses"])) or not on["losses"][-1] < on["losses"][0]:
        raise RuntimeError(f"pld: the loss is not finite and falling: {on['losses']}")
    res.update(pld_run=on, off_run=off, step_ms_pld=on["step_ms"], step_ms_off=off["step_ms"],
               kept_share_by_layer=[float(x) for x in kept], forwards_recorded=len(draws),
               launches_per_step={k: v / PLD_STEPS for k, v in on["launches"].items()})

    # theta = 1 against PLD off, bit for bit, deterministic algorithms
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for extra in ({}, {"progressive_layer_drop": dict(PLD_SECTION, theta=1.0)}):
            engine, _ = _zero_engine(extra=extra, stage=0)
            losses = [engine.train_step([batch]) for _ in range(PLD_EQUAL_STEPS)]
            runs.append((torch.stack(losses).cpu(), _host_masters(engine)))
            _free(engine)
    finally:
        torch.use_deterministic_algorithms(False)
    (l0, m0), (l1, m1) = runs
    equal = torch.equal(l0, l1) and m0.keys() == m1.keys() and all(
        torch.equal(m0[n], m1[n]) for n in m0)
    if not equal:
        raise RuntimeError(f"theta = 1 differs from PLD off: {l0.tolist()} {l1.tolist()}")
    res["theta1_equals_off"] = dict(steps=PLD_EQUAL_STEPS, equal=equal, losses=l0.tolist())

    # the SQuAD fine-tune
    qcfg = dt.BertConfig.bert_large(checkpoint_policy="dots")
    model = tbert.init_bert_qa(qcfg, seed=0, device="cuda")
    engine, _, _, _ = dt.initialize(model=model, config=QA_CONFIG)
    qbatch = _qa_batch(qcfg)
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [engine.train_step([qbatch]) for _ in range(QA_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    losses = [float(x) for x in losses]
    qa_per = _flash_per_step(counts, QA_STEPS, "qa")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"qa: the loss is not finite and falling: {losses}")
    profile = _profiled(lambda: engine.train_step([qbatch]))
    missing = [n for n in FP16_KERNEL_NAMES.values()
               if not any(n in k for k in profile["own_ms"])]
    if missing:
        raise RuntimeError(f"qa: the fp16 flash routines did not run: {missing}")
    res["qa"] = dict(model="BertForQuestionAnswering, bert_large (seed 0), fp16",
                     config=QA_CONFIG, seq=QA_SEQ, batch=QA_BATCH, steps=QA_STEPS,
                     step_ms=1e3 * wall / QA_STEPS, losses=losses,
                     skipped_steps=engine.skipped_steps, loss_scale=engine.loss_scale(),
                     peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                     launches={k: counts[k] for k in FLASH_KERNELS},
                     launches_per_step=qa_per, own_kernel_ms=profile["own_ms"])
    _free(engine)
    return res


# ---------------------------------------------------------------------------
# phase 12 (serve6): speculation, chunked prefill, the prefix cache and its
# tiers, int8 weights and beam search at GPT-2 XL width
# ---------------------------------------------------------------------------

SPEC_K, CHUNK, SHARED_PREFIX = 4, 256, 256
# the bf16 timed passes run GPT-2 XL's width at a quarter of its depth, so
# that the script ends inside its time limit with phase 13 after it; the
# oracles keep the whole depth (int8's token match depends on it)
SERVE6_TIMED_LAYERS = 6
# submitted in two waves, the second after the first has drained: the
# second wave's shared-prefix prompts hit the first's entries
WAVES = ((0, 1, 4, 6), (2, 3, 5, 7))
INT8_TOKEN_MATCH_THRESHOLD = 0.9      # the JAX package's, for quantized KV


def _serve6_prompts():
    """The phase-3 lengths; the four of 300 tokens or more share their
    first 256 tokens."""
    rng = np.random.RandomState(6)
    prefix = rng.randint(0, 50257, SHARED_PREFIX).tolist()
    out = []
    for n in PROMPT_LENS:
        p = rng.randint(0, 50257, n).tolist()
        if n >= 300:
            p[:SHARED_PREFIX] = prefix
        out.append(p)
    return out


def _engine6(model, cfg, kv, injector=None, **knobs):
    from deepspeed_tpu_torch import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.inference.serving.scheduler import default_buckets

    largest = default_buckets(cfg.max_position_embeddings - 1)[-1]
    scfg = ServingConfig(max_slots=B, max_seq_len=cfg.max_position_embeddings,
                         kv_cache_dtype=kv,
                         attention_impl={"default": "pallas_decode",
                                         largest: "pallas_sparse"}, **knobs)
    return ServingEngine(model, cfg, scfg, device="cuda", injector=injector)


def _drive6(eng, prompts):
    """The two waves through ``eng``: outputs, the pass's metrics, and the
    serving kernels' launches over the whole pass, inside the speculative
    verify steps and inside the prefill chunks (counts reset just before)."""
    from deepspeed_tpu_torch import kernels
    from deepspeed_tpu_torch.inference.serving.metrics import ServingMetrics

    eng.metrics = ServingMetrics()
    inside = {"verify": dict.fromkeys(SERVING_KERNELS, 0),
              "chunk": dict.fromkeys(SERVING_KERNELS, 0)}

    def counted(fn, key):
        def run(*a, **kw):
            before = kernels.launch_counts()
            out = fn(*a, **kw)
            after = kernels.launch_counts()
            for k in SERVING_KERNELS:
                inside[key][k] += after[k] - before[k]
            return out
        return run

    eng._spec_decode = counted(eng._spec_decode, "verify")
    eng._advance_chunk = counted(eng._advance_chunk, "chunk")
    kernels.reset_launch_counts()
    futs = [None] * len(prompts)
    t0 = time.perf_counter()
    for wave in WAVES:
        for i in wave:
            futs[i] = eng.submit(prompts[i], max_new_tokens=NEW_TOKENS)
        eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    del eng._spec_decode, eng._advance_chunk
    snap = eng.metrics.snapshot()
    outs = [f.result(timeout=0) for f in futs]
    for out in outs:
        if len(out) != NEW_TOKENS or not all(0 <= t < 50304 for t in out):
            raise RuntimeError(f"bad served output {out}")
    m = dict(ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
             decode_tokens_per_s=snap["tokens_per_sec"], decode_steps=snap["decode_steps"],
             tokens_per_step=snap["tokens_per_step"], accept_rate=snap["accept_rate"],
             tokens_per_lane_step=None, prefix_hit_rate=snap["prefix_hit_rate"],
             prefix_reused_tokens=snap["prefix_reused_tokens"],
             prefill_chunks=snap["prefill_chunks"], prefill_s=eng.metrics.prefill_time_s,
             wall_s=wall, launches={k: counts[k] for k in SERVING_KERNELS},
             launches_in_verify=inside["verify"], launches_in_chunks=inside["chunk"])
    if snap["draft_proposed"]:
        m["tokens_per_lane_step"] = 1 + snap["draft_accepted"] / (snap["draft_proposed"] / SPEC_K)
    return outs, m


def _impl6(cfg, prompt_len):
    """The backend ``_engine6`` gives a prompt: the band for the largest
    bucket, the decode kernel below it."""
    from deepspeed_tpu_torch.inference.serving.scheduler import bucket_for, default_buckets

    buckets = default_buckets(cfg.max_position_embeddings - 1)
    return ("pallas_sparse" if bucket_for(prompt_len, buckets) == buckets[-1]
            else "pallas_decode")


def _oracle6(model, cfg, prompts, outs, wants, label):
    """Served against ``generate()`` with phase 4's margin rule."""
    rows = []
    for prompt, out, want in zip(prompts, outs, wants):
        impl = _impl6(cfg, len(prompt))
        row = dict(prompt_len=len(prompt), impl=impl, equal=out == want)
        if out != want:
            first = next(i for i, (a, b) in enumerate(zip(out, want)) if a != b)
            toks, margins = _margins(model, cfg, prompt, impl, len(want))
            row.update(first_divergence=first, top2_margin=margins[first])
            if toks != want or margins[first] >= 1e-3:
                raise RuntimeError(f"{label}: served tokens diverge from generate() at "
                                   f"step {first}: {row}")
        rows.append(row)
    return rows


def _spec_knobs(**extra):
    return dict(speculative_k=SPEC_K, prefill_chunk_tokens=CHUNK, prefix_cache_mb=4096.0,
                **extra)


def _tiers(model, cfg):
    """A live budget that holds one entry, a host spill tier of one blob and
    a disk tier under build/: three 300-token prefixes evict each other
    down to the disk; a prompt extending the first is promoted from the
    disk; a corrupted blob falls through to a prefill; the host-memory
    guard climbs its levels under the host_mem_pressure arm."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch import generate
    from deepspeed_tpu_torch.inference.serving.fault_injection import ServingFaultInjector

    entry_mb = cfg.num_hidden_layers * 300 * cfg.hidden_size * 4 * 2 / 2**20   # fp32 k + v
    rng = np.random.RandomState(12)
    base = [rng.randint(0, 50257, 300).tolist() for _ in range(3)]
    longer = [p + rng.randint(0, 50257, 40).tolist() for p in base]
    os.makedirs("build", exist_ok=True)
    spill_dir = tempfile.mkdtemp(prefix="serve6_spill_", dir="build")
    fi = ServingFaultInjector()
    eng = _engine6(model, cfg, "fp32", injector=fi,
                   prefix_cache_mb=1.2 * entry_mb, prefix_spill_mb=1.2 * entry_mb,
                   prefix_spill_dir=spill_dir, host_mem_watermark_mb=float(1 << 20))
    takes = []
    store = eng.prefix_cache.spill
    real_take = store.take

    def timed_take(key):
        t0 = time.perf_counter()
        out = real_take(key)
        takes.append((time.perf_counter() - t0) * 1e3)
        return out

    store.take = timed_take

    def serve(p, n=8):
        t0 = eng.metrics.prefill_time_s
        f = eng.submit(p, max_new_tokens=n)
        eng.drain()
        return f.result(timeout=0), (eng.metrics.prefill_time_s - t0) * 1e3

    try:
        prefill_ms = [serve(p)[1] for p in base]              # A, B, C: A to the disk
        st = store.stats()
        if st["disk_entries"] < 1 or st["ram_entries"] < 1:
            raise RuntimeError(f"tiers: no demotion to both tiers: {st}")
        got, hit_prefill_ms = serve(longer[0])
        want = generate(model, cfg, [longer[0]], 8, attn_impl="pallas_decode",
                        kv_page_tokens=PT, device="cuda")[0].tolist()
        promoted = eng.prefix_cache.stats()["spill_promotions"]
        if promoted != 1:
            raise RuntimeError(f"tiers: the extended prompt was not promoted ({promoted})")
        rows = _oracle6(model, cfg, [longer[0]], [got], [want], "tiers promoted hit")
        # corrupt the most recent spill record (C's, demoted by the promotion)
        fi.arm_serving("corrupt_spill_entry", times=1)
        eng.step()
        got_c, _ = serve(longer[2])
        want_c = generate(model, cfg, [longer[2]], 8, attn_impl="pallas_decode",
                          kv_page_tokens=PT, device="cuda")[0].tolist()
        rows += _oracle6(model, cfg, [longer[2]], [got_c], [want_c], "tiers corrupt")
        dropped = store.stats()["corrupt_dropped"]
        if dropped < 1 or eng.metrics.spill_corrupt_total < 1:
            raise RuntimeError(f"tiers: the corrupted blob was not dropped ({dropped})")
        fi.arm_serving("host_mem_pressure", times=6)
        levels = []
        for _ in range(6):
            eng.step()
            levels.append(eng._mem_guard.level)
        if levels[-1] != 3 or eng.degrade_rung < 1:
            raise RuntimeError(f"tiers: the guard did not climb: {levels}")
        return dict(entry_mb=entry_mb, spill_stats=store.stats(),
                    demotions=store.demotions, disk_demotions=store.disk_demotions,
                    promotions=store.promotions, promote_ms=takes,
                    prefix_prefill_ms=prefill_ms, hit_prefill_ms=hit_prefill_ms,
                    corrupt_dropped=dropped, guard_levels=levels,
                    degrade_rung=eng.degrade_rung, oracle=rows,
                    memtier=eng.memtier_stats()["mem_guard"])
    finally:
        del eng
        shutil.rmtree(spill_dir, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_serve6():
    from deepspeed_tpu_torch import GPT2Config, generate, init_gpt2
    from deepspeed_tpu_torch.inference import quantization as tq
    from deepspeed_tpu_torch.inference.beam import beam_search
    from deepspeed_tpu_torch.inference.serving.fault_injection import ServingFaultInjector

    cfg = GPT2Config.gpt2_xl(num_hidden_layers=SERVE_LAYERS)
    prompts = _serve6_prompts()
    res = dict(model=f"gpt2_xl (seed 0), {SERVE_LAYERS} of 48 layers, 8 slots, max_seq_len "
                     "1024, 128-token pages",
               prompt_lens=list(PROMPT_LENS), shared_prefix=SHARED_PREFIX,
               waves=[list(w) for w in WAVES], k=SPEC_K, chunk=CHUNK)

    # a. fp32 oracle: k = 4, chunks of 256, the prefix cache; then a
    # corrupted drafter; then int8 weights over an int8 pool
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.float32)
    t0 = time.perf_counter()
    wants = [generate(model, cfg, [p], NEW_TOKENS, attn_impl=_impl6(cfg, len(p)),
                      kv_page_tokens=PT, device="cuda")[0].tolist() for p in prompts]
    res["generate_s"] = time.perf_counter() - t0
    eng = _engine6(model, cfg, "fp32", **_spec_knobs())
    outs, m = _drive6(eng, prompts)
    for key in ("launches_in_verify", "launches_in_chunks"):
        if not m[key] or min(m[key].values()) <= 0:
            raise RuntimeError(f"serve6: a serving kernel never launched ({key}): {m[key]}")
    res["fp32"] = dict(run=m, oracle=_oracle6(model, cfg, prompts, outs, wants,
                                              "fp32 k=4 chunks prefix"),
                       prefix=eng.prefix_stats())
    if res["fp32"]["prefix"]["hits"] < 2:
        raise RuntimeError(f"serve6: the shared prefixes did not hit: {res['fp32']['prefix']}")
    del eng
    fi = ServingFaultInjector({"corrupt_draft": {}})
    eng = _engine6(model, cfg, "fp32", injector=fi, **_spec_knobs())
    outs, m = _drive6(eng, prompts)
    res["fp32_corrupt_draft"] = dict(run=m, fired=fi.fired.get("corrupt_draft", 0),
                                     oracle=_oracle6(model, cfg, prompts, outs, wants,
                                                     "corrupt_draft"))
    if m["accept_rate"] != 0.0:
        raise RuntimeError(f"serve6: a corrupted draft was accepted: {m['accept_rate']}")
    del eng
    torch.cuda.empty_cache()
    qmodel = tq.quantize_for_decode(model)
    qwants = [generate(qmodel, cfg, [p], NEW_TOKENS, attn_impl=_impl6(cfg, len(p)),
                       kv_page_tokens=PT, device="cuda")[0].tolist() for p in prompts]
    eng = _engine6(qmodel, cfg, "int8", **_spec_knobs())
    outs, m = _drive6(eng, prompts)
    match = float(np.mean([np.mean([a == b for a, b in zip(o, w)])
                           for o, w in zip(outs, qwants)]))
    if match < INT8_TOKEN_MATCH_THRESHOLD:
        raise RuntimeError(f"serve6 int8: token match {match} < {INT8_TOKEN_MATCH_THRESHOLD}")
    res["int8_weights_int8_pool"] = dict(run=m, token_match=match,
                                         equal_requests=sum(o == w for o, w in
                                                            zip(outs, qwants)))
    int8_bytes = tq.quantized_bytes(qmodel)
    bf16_bytes = tq.quantized_bytes(model) // 2      # the fp32 model's bytes in bf16
    del eng, qmodel
    torch.cuda.empty_cache()

    # c. tiers (fp32), then d. beam search (fp32, dense)
    res["tiers"] = _tiers(model, cfg)
    prompt = prompts[2]
    greedy = generate(model, cfg, [prompt], NEW_TOKENS, device="cuda")[0].tolist()
    one, _ = beam_search(model, cfg, [prompt], NEW_TOKENS, num_beams=1, device="cuda")
    if one[0, 0].tolist() != greedy:
        raise RuntimeError("serve6: beam search with W = 1 differs from greedy generate()")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, scores = beam_search(model, cfg, [prompt], NEW_TOKENS, num_beams=4, device="cuda")
    torch.cuda.synchronize()
    res["beam"] = dict(prompt_len=len(prompt), new_tokens=NEW_TOKENS, width=4,
                       w1_equals_greedy=True, w4_s=time.perf_counter() - t0,
                       w4_scores=scores[0].tolist(),
                       w4_best_equals_greedy=toks[0, 0].tolist() == greedy)
    del model
    torch.cuda.empty_cache()

    # b. bf16, timed, in one call: k = 0; k = 4; chunks of 256; the prefix cache
    res["int8_weight_bytes"] = int8_bytes
    res["bf16_weight_bytes"] = bf16_bytes
    cfg = GPT2Config.gpt2_xl(num_hidden_layers=SERVE6_TIMED_LAYERS)
    res["timed_layers"] = SERVE6_TIMED_LAYERS
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    _drive6(_engine6(model, cfg, "bf16"), prompts)          # warm-up pass
    res["bf16"] = {}
    for label, knobs in (("k0", {}), ("k4", dict(speculative_k=SPEC_K)),
                         ("chunks256", dict(prefill_chunk_tokens=CHUNK)),
                         ("prefix", dict(prefix_cache_mb=4096.0))):
        eng = _engine6(model, cfg, "bf16", **knobs)
        _, m = _drive6(eng, prompts)
        res["bf16"][label] = m
        del eng
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()
    return res


def verify_rows_case(kv):
    """The decode kernel's rows at C = k+1 (a speculative verify, named a
    decode step) against the same queries one at a time at C = 1, at the
    serving shapes: ``torch.equal`` a row. fp32 queries run one routine at
    any C; bf16 ones run the vec routine at C = 1 and the mma routine at
    C >= 2, so their rows are reported, not required equal."""
    from deepspeed_tpu_torch.kernels import decode_attention as da

    args = _decode_inputs(SPEC_K + 1, kv, (B, NH, HD, PT, MP))
    q, pk, pv, tables, qpos, pt, qdt, ks, vs = args
    chunk = da._decode_attend_cuda(*args, prefill=False)
    equal = []
    for j in range(SPEC_K + 1):
        one = da._decode_attend_cuda(q[:, j:j + 1].contiguous(), pk, pv, tables,
                                     qpos[:, j:j + 1].contiguous(), pt, qdt, ks, vs,
                                     prefill=False)
        equal.append(bool(torch.equal(one[:, 0], chunk[:, j])))
    torch.cuda.synchronize()
    if kv == "fp32" and not all(equal):
        raise RuntimeError(f"decode_attention fp32: verify rows differ from C = 1 rows: {equal}")
    return dict(case=f"verify rows C={SPEC_K + 1} vs C=1 pages={kv}", rows_equal=equal)


# ---------------------------------------------------------------------------
# phase 13: the serving fleet (replica processes behind a router)
# ---------------------------------------------------------------------------

FLEET_DEVICE = "cuda"
FLEET_KILL_AT = 6                  # the doomed replica's busy step (mid-decode)
FLEET_FRAME_BYTES = 1 << 27        # a GPT-2 XL fp32 page pair is 78.6 MB
FLEET_READY_S = 300.0
FLEET_TIMEOUT_S = 300.0
# the replicas run GPT-2 XL's width at an eighth of its depth: routing,
# handoff, drain and failover do not depend on depth, a replica's start
# (its weights drawn on the CPU) does, and the script must end inside its
# time limit with phases 14 to 16 after it
FLEET_LAYERS = 6


def _fleet_model():
    """The replicas' model block: GPT-2 XL's width at ``FLEET_LAYERS``
    layers, dropout off."""
    return {"num_hidden_layers": FLEET_LAYERS}


def _fleet_spec(dtype, kv, fault=None):
    """A replica spec: phase 3's engine (8 slots, 128-token pages, the
    decode kernel below the largest bucket and the band kernel in it) on
    seeded random weights in ``dtype``, with the telemetry endpoint armed
    (its port comes from ``DSTPU_TELEMETRY_PORT``) and handoff frames big
    enough for a page pair."""
    from deepspeed_tpu_torch import GPT2Config
    from deepspeed_tpu_torch.inference.serving.scheduler import default_buckets

    spec = {"model": _fleet_model(), "seed": 0, "dtype": dtype, "device": FLEET_DEVICE}
    cfg = GPT2Config(**spec["model"])
    largest = default_buckets(cfg.max_position_embeddings - 1)[-1]
    serving = {"max_slots": B, "max_seq_len": cfg.max_position_embeddings,
               "kv_cache_dtype": kv, "kv_page_tokens": PT,
               "attention_impl": {"default": "pallas_decode", str(largest): "pallas_sparse"}}
    if fault:
        serving["fault_injection"] = fault
    spec["ds_config"] = {"train_batch_size": 1, "serving": serving,
                         "telemetry": {"enabled": True},
                         "fleet": {"drain_timeout_s": FLEET_TIMEOUT_S,
                                   "handoff": {"max_frame_bytes": FLEET_FRAME_BYTES,
                                               "attempt_timeout_s": 120.0}}}
    return spec


def _free_port():
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class _ReplicaProc:
    """``python -m deepspeed_tpu_torch.inference.serving.replica`` started
    with its own telemetry port, its output in a log file."""

    def __init__(self, root, name, spec, role):
        self.name, self.role = name, role
        self.tport = _free_port()
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        self.log = os.path.join(root, f"{name}.log")
        env = dict(os.environ, DSTPU_TELEMETRY_PORT=str(self.tport),
                   PYTHONPATH=os.getcwd() + os.pathsep + os.environ.get("PYTHONPATH", ""))
        with open(self.log, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "deepspeed_tpu_torch.inference.serving.replica",
                 "--config", path, "--port", "0", "--role", role],
                stdout=out, stderr=subprocess.STDOUT, env=env)
        self.port = None
        self.t_start = time.perf_counter()
        self.ready_s = None

    def lines(self):
        with open(self.log) as f:
            return f.read().splitlines()

    def wait_ready(self):
        deadline = time.monotonic() + FLEET_READY_S
        while time.monotonic() < deadline:
            for line in self.lines():
                if line.startswith('{"ready"'):
                    self.port = int(json.loads(line)["port"])
                    self.ready_s = time.perf_counter() - self.t_start
                    return self
            if self.proc.poll() is not None:
                raise RuntimeError(f"fleet: replica {self.name} exited {self.proc.returncode} "
                                   f"before ready: {self.lines()[-20:]}")
            time.sleep(0.1)
        raise RuntimeError(f"fleet: replica {self.name} not ready in {FLEET_READY_S} s")

    def endpoint(self):
        from deepspeed_tpu_torch.inference.serving.router import ReplicaEndpoint

        return ReplicaEndpoint(self.name, "127.0.0.1", self.port, role=self.role)

    @property
    def url(self):
        return f"http://127.0.0.1:{self.tport}"

    def stop(self, timeout_s=FLEET_TIMEOUT_S):
        """SIGTERM (the drain), then the exit code; SIGKILL past the deadline."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=60)
            raise RuntimeError(f"fleet: replica {self.name} did not exit on SIGTERM")


def _fleet_router(replicas):
    from deepspeed_tpu_torch.inference.serving.config import (
        FleetConfig,
        HandoffConfig,
        RolesConfig,
    )
    from deepspeed_tpu_torch.inference.serving.router import Router

    return Router([r.endpoint() for r in replicas], FleetConfig(
        enabled=True, retry_budget=3, retry_backoff_s=0.05,
        attempt_timeout_s=FLEET_TIMEOUT_S, health_ttl_s=0.25, affinity_prefix_tokens=0,
        roles=RolesConfig(enabled=True), handoff=HandoffConfig(enabled=True)))


def _fleet_pass(router, prompts, on_token=None):
    """Every prompt through the router at once. Per request: the tokens
    streamed (in order), the host time of each, TTFT from its submit, and
    the final output."""
    t0 = time.perf_counter()
    recs = [dict(prompt_len=len(p), stream=[], times=[]) for p in prompts]

    def cb(i):
        def fn(_key, tok):
            recs[i]["stream"].append(int(tok))
            recs[i]["times"].append(time.perf_counter())
            if on_token is not None:
                on_token(i, recs)
        return fn

    futs = []
    for i, p in enumerate(prompts):
        recs[i]["submit"] = time.perf_counter()
        futs.append(router.submit(p, max_new_tokens=NEW_TOKENS, timeout_s=FLEET_TIMEOUT_S,
                                  stream_cb=cb(i)))
    for rec, fut in zip(recs, futs):
        rec["out"] = list(fut.result(timeout=FLEET_TIMEOUT_S))
        if rec["stream"] != rec["out"]:
            raise RuntimeError(f"fleet: streamed tokens differ from the result (a duplicate "
                               f"or a lost token): {len(rec['stream'])} streamed, "
                               f"{len(rec['out'])} returned")
        rec["ttft_s"] = rec["times"][0] - rec["submit"]
    return recs, time.perf_counter() - t0


def _pct(xs, q):
    xs = sorted(xs)
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]


def _scrape(replicas):
    """A FleetCollector over the replicas' engine endpoints: each one's
    serving and kernels snapshots, its handoff log, and its parameters'
    SHA-256 (the replica's health doc)."""
    from deepspeed_tpu_torch.telemetry import FleetCollector

    coll = FleetCollector(timeout_s=30.0)
    for i, r in enumerate(replicas):
        coll.add_endpoint(i, r.url, role=r.role)
    summary = coll.scrape()
    if summary["down"]:
        raise RuntimeError(f"fleet: the collector found replicas down: {summary}")
    snaps = coll.fleet_snapshot()["ranks"]
    fleet = coll.fleet_metrics()
    out = {}
    for i, r in enumerate(replicas):
        snap = snaps[str(i)]["snapshot"]
        with urllib.request.urlopen(r.url + "/healthz", timeout=30) as resp:
            health = json.loads(resp.read())
        out[r.name] = dict(
            role=r.role, url=r.url, up=fleet.get(f"Fleet/rank{i}/up"),
            serving={k: snap["serving"].get(k) for k in (
                "requests_completed", "tokens_emitted", "decode_steps", "decode_time_s",
                "tokens_per_sec",
                "ttft_p50_s", "ttft_p95_s", "prefill_calls", "prefill_tokens",
                "handoff_exports", "handoff_installs", "handoff_dup_installs",
                "handoff_resumes", "handoff_reaped")},
            kernels={k: v["launches"] for k, v in snap["kernels"].items()},
            handoff=snap.get("handoff"),
            params_sha256=health["replica"]["params_sha256"])
    return out


def _check_launches(scraped, name, kernels):
    got = scraped[name]["kernels"]
    if FLEET_DEVICE == "cuda" and min(got[k] for k in kernels) <= 0:
        raise RuntimeError(f"fleet: {name} ({scraped[name]['role']}) never launched "
                           f"{kernels}: {got}")


def _reprefill_ms(replica, prompt):
    """A prompt's first token from the replica alone (a forced plain
    submit, as the router's degraded route sends it), client side: the
    re-prefill a decode replica would run without the handoff."""
    import socket
    import uuid

    from deepspeed_tpu_torch.inference.serving.router import read_line, send_line

    t0 = time.perf_counter()
    with socket.create_connection(("127.0.0.1", replica.port), timeout=FLEET_TIMEOUT_S) as s:
        send_line(s, {"op": "submit", "v": 1, "key": uuid.uuid4().hex, "prompt": prompt,
                      "max_new_tokens": 1, "force": True})
        stream = s.makefile("rb")
        first = None
        while True:
            doc = read_line(stream)
            if doc is None or "error" in doc or "rejected" in doc:
                raise RuntimeError(f"fleet: forced submit on {replica.name} failed: {doc}")
            if "t" in doc and first is None:
                first = time.perf_counter()
            if doc.get("done"):
                break
    return 1e3 * (first - t0)


def phase_fleet():
    """Phase 13, the serving fleet at GPT-2 XL width: replica processes of
    the port behind a ``Router``; disaggregated prefill/decode against
    ``generate()``, the handoff timed, a drain, a failover, and the
    collector over the replicas' engine endpoints. The fp32 and bf16
    prefill/decode pairs start together, and the failover's pair starts
    while the drain runs, so that fewer starts wait in turn."""
    import shutil
    import tempfile

    from deepspeed_tpu_torch import generate
    from deepspeed_tpu_torch.inference.serving.replica import build_model, params_sha256
    from deepspeed_tpu_torch.launcher.supervisor import EXIT_PREEMPTED

    os.makedirs("build", exist_ok=True)
    root = tempfile.mkdtemp(prefix="fleet_", dir="build")
    procs = []

    def spawn(name, spec, role):
        r = _ReplicaProc(root, name, spec, role)
        procs.append(r)
        return r

    def stop(*replicas):
        for r in replicas:
            rc = r.stop()
            if rc != EXIT_PREEMPTED:
                raise RuntimeError(f"fleet: {r.name} exited {rc} on SIGTERM, not "
                                   f"{EXIT_PREEMPTED}")

    prompts = _prompts()
    res = dict(model=f"gpt2_xl width, {FLEET_LAYERS} of 48 layers (seed 0 on a CPU "
                     "generator), 8 slots, max_seq_len 1024, "
                     "128-token pages, one H100 shared by the replicas",
               prompt_lens=list(PROMPT_LENS), new_tokens=NEW_TOKENS)
    if FLEET_DEVICE == "cuda":
        res["card_free_gb_at_start"] = torch.cuda.mem_get_info()[0] / 2 ** 30
    t_phase = time.perf_counter()
    try:
        pre, dec = (spawn("prefill_fp32", _fleet_spec("fp32", "fp32"), "prefill"),
                    spawn("decode_fp32", _fleet_spec("fp32", "fp32"), "decode"))
        pre16, dec16 = (spawn("prefill_bf16", _fleet_spec("bf16", "bf16"), "prefill"),
                        spawn("decode_bf16", _fleet_spec("bf16", "bf16"), "decode"))
        t0 = time.perf_counter()
        model, cfg = build_model(_fleet_spec("fp32", "fp32"), device=FLEET_DEVICE)
        oracle_sha = params_sha256(model)
        wants = [generate(model, cfg, [p], NEW_TOKENS, attn_impl=_impl6(cfg, len(p)),
                          kv_page_tokens=PT, device=FLEET_DEVICE)[0].tolist() for p in prompts]
        res["oracle_s"] = time.perf_counter() - t0

        # -- a. disaggregated prefill -> decode, fp32 weights and pool ----------
        for r in (pre, dec):
            r.wait_ready()
        router = _fleet_router([pre, dec])
        recs, wall = _fleet_pass(router, prompts)
        counters = router.counters()
        router.close()
        if counters["handoff_completed"] != len(prompts) or counters["handoff_failed"]:
            raise RuntimeError(f"fleet: not every request was handed off: {counters}")
        outs = [rec["out"] for rec in recs]
        scraped = _scrape([pre, dec])
        _check_launches(scraped, pre.name, SERVING_KERNELS)
        _check_launches(scraped, dec.name, ("decode_attention",))
        _check_hashes(scraped, oracle_sha)
        res["disagg_fp32"] = dict(
            wall_s=wall, router=counters, ready_s={r.name: r.ready_s for r in (pre, dec)},
            oracle=_oracle6(model, cfg, prompts, outs, wants, "fleet disagg fp32"),
            equal=sum(o == w for o, w in zip(outs, wants)), replicas=scraped,
            params_sha256=oracle_sha)
        stop(pre, dec)

        # -- b. the handoff timed, bf16 weights and pool -------------------------
        for r in (pre16, dec16):
            r.wait_ready()
        router = _fleet_router([pre16, dec16])
        _fleet_pass(router, prompts)                         # warm-up pass
        before = _scrape([pre16, dec16])
        recs, wall = _fleet_pass(router, prompts)
        after = _scrape([pre16, dec16])
        counters = router.counters()
        sent = {e["key"]: e for e in after[pre16.name]["handoff"]["sent"]}
        inst = {e["key"]: e for e in after[dec16.name]["handoff"]["installed"]}
        old = {e["key"] for e in before[pre16.name]["handoff"]["sent"]}
        rows = []
        for key in sorted(set(sent) - old, key=lambda k: sent[k]["prompt_len"]):
            s, i = sent[key], inst[key]
            rows.append(dict(prompt_len=s["prompt_len"], pages=s["pages"], bytes=s["bytes"],
                             export_ms=1e3 * s["export_s"], send_ms=1e3 * s["send_s"],
                             install_ms=1e3 * i["install_s"]))
        if len(rows) != len(prompts):
            raise RuntimeError(f"fleet: {len(rows)} handoffs logged for {len(prompts)} requests")
        for row in rows:
            row["reprefill_ms"] = _reprefill_ms(
                dec16, next(p for p in prompts if len(p) == row["prompt_len"]))
        d0, d1 = before[dec16.name]["serving"], after[dec16.name]["serving"]
        ttfts = [rec["ttft_s"] for rec in recs]
        _check_hashes(after, None)
        res["handoff_bf16"] = dict(
            wall_s=wall, router=counters, by_request=rows,
            ready_s={r.name: r.ready_s for r in (pre16, dec16)},
            ttft_p50_s=_pct(ttfts, 50), ttft_p95_s=_pct(ttfts, 95),
            # the decode replica's own clock: tokens over its decode steps' time
            decode_tokens_per_s=(d1["tokens_emitted"] - d0["tokens_emitted"])
            / (d1["decode_time_s"] - d0["decode_time_s"]),
            decode_steps=d1["decode_steps"] - d0["decode_steps"],
            bytes_total=sum(r["bytes"] for r in rows), replicas=after)

        # -- c. drain: SIGTERM the decode replica with every lane decoding, while
        # the failover's pair starts --------------------------------------------
        doomed = spawn("doomed_fp32", _fleet_spec(
            "fp32", "fp32", fault={"kill_replica": {"at_step": FLEET_KILL_AT}}), "mixed")
        safe = spawn("safe_fp32", _fleet_spec("fp32", "fp32"), "mixed")
        res["drain_bf16"] = _fleet_drain(router, pre16, dec16, prompts, recs, counters)
        router.close()
        stop(pre16)

        # -- d. failover: the kill arm ends one mixed replica mid-decode ---------
        for r in (doomed, safe):
            r.wait_ready()
        router = _fleet_router([doomed, safe])
        recs, wall = _fleet_pass(router, prompts)
        counters = router.counters()
        router.close()
        rc = doomed.proc.wait(timeout=60)
        if rc != -signal.SIGKILL:
            raise RuntimeError(f"fleet: the doomed replica exited {rc}, not by SIGKILL")
        if counters["retried"] < 1 or counters["poisoned"]:
            raise RuntimeError(f"fleet: no failover happened: {counters}")
        outs = [rec["out"] for rec in recs]
        gaps = [max(b - a for a, b in zip(rec["times"], rec["times"][1:])) for rec in recs]
        steps = sorted(b - a for rec in recs for a, b in zip(rec["times"], rec["times"][1:]))
        scraped = _scrape([safe])
        _check_launches(scraped, safe.name, SERVING_KERNELS)
        _check_hashes(scraped, oracle_sha)
        res["failover_fp32"] = dict(
            wall_s=wall, router=counters, doomed_exit=rc, kill_at_busy_step=FLEET_KILL_AT,
            ready_s={r.name: r.ready_s for r in (doomed, safe)},
            oracle=_oracle6(model, cfg, prompts, outs, wants, "fleet failover fp32"),
            equal=sum(o == w for o, w in zip(outs, wants)),
            # the longest pause in any request's stream (the failover: EOF,
            # re-route, re-prefill on the survivor, replay) against the
            # median gap between two tokens of a stream
            failover_s=max(gaps), max_gap_s_by_request=gaps,
            median_token_gap_s=steps[len(steps) // 2], replicas=scraped)
        del model
        torch.cuda.empty_cache()
        stop(safe)
    except BaseException:
        for r in procs:              # the replicas' own account of the failure
            print(f"--- {r.name} (exit {r.proc.poll()}):\n" + "\n".join(r.lines()[-30:]),
                  file=sys.stderr, flush=True)
        raise
    finally:
        for r in procs:
            if r.proc.poll() is None:
                r.proc.kill()
                r.proc.wait(timeout=60)
        shutil.rmtree(root, ignore_errors=True)
    res["phase_s"] = time.perf_counter() - t_phase
    return res


def _fleet_drain(router, pre, dec, prompts, timed, timed_counters):
    """SIGTERM to the decode replica once every request of a pass decodes
    there: each finishes without a re-route, the replica exits
    ``EXIT_PREEMPTED`` after a clean drain, and later requests go to the
    prefill replica (the router's degraded route)."""
    from deepspeed_tpu_torch.launcher.supervisor import EXIT_PREEMPTED

    decoding = threading.Event()

    def on_token(_i, recs):
        if all(len(r["stream"]) >= 2 for r in recs):
            decoding.set()

    box = {}
    worker = threading.Thread(target=lambda: box.update(
        zip(("recs", "wall"), _fleet_pass(router, prompts, on_token))), daemon=True)
    worker.start()
    if not decoding.wait(FLEET_TIMEOUT_S):
        raise RuntimeError("fleet: the drain pass never had every lane decoding")
    t_term = time.perf_counter()
    dec.proc.send_signal(signal.SIGTERM)
    worker.join(FLEET_TIMEOUT_S)
    if "recs" not in box:
        raise RuntimeError("fleet: the drain pass did not finish")
    rc = dec.proc.wait(timeout=FLEET_TIMEOUT_S)
    drain_s = time.perf_counter() - t_term
    drained = [json.loads(line) for line in dec.lines() if line.startswith('{"drained"')]
    if rc != EXIT_PREEMPTED or drained != [{"drained": True}]:
        raise RuntimeError(f"fleet: the drained replica exited {rc} ({drained}), not "
                           f"{EXIT_PREEMPTED} after a clean drain")
    counters = router.counters()
    if counters["retried"] != timed_counters["retried"] or counters["poisoned"]:
        raise RuntimeError(f"fleet: a request in flight on the drained replica was "
                           f"re-routed: {counters}")
    for rec in box["recs"]:
        if len(rec["out"]) != NEW_TOKENS:
            raise RuntimeError(f"fleet: a drained request ended short: {rec['prompt_len']}")
    before = _scrape([pre])[pre.name]["serving"]["tokens_emitted"]
    later = [router.submit(p, max_new_tokens=NEW_TOKENS).result(timeout=FLEET_TIMEOUT_S)
             for p in prompts[:2]]
    after = _scrape([pre])[pre.name]["serving"]["tokens_emitted"]
    if after - before != 2 * (NEW_TOKENS - 1) or any(len(x) != NEW_TOKENS for x in later):
        raise RuntimeError("fleet: requests after the drain did not go to the other replica")
    return dict(exit=rc, drain_s=drain_s, router=router.counters(),
                inflight_finished=len(box["recs"]),
                same_as_timed_pass=sum(a["out"] == b["out"] for a, b in zip(box["recs"], timed)),
                after_drain_served_by=pre.name)


def _check_hashes(scraped, want, wait_s=FLEET_TIMEOUT_S):
    """Every replica's parameters hash alike (and like ``want``, the
    oracle's, when given). A replica hashes its parameters on a thread of
    its own after it is ready: an absent hash is asked for again."""
    deadline = time.monotonic() + wait_s
    for name, rep in scraped.items():
        while rep["params_sha256"] is None and time.monotonic() < deadline:
            time.sleep(0.5)
            with urllib.request.urlopen(rep["url"] + "/healthz", timeout=30) as resp:
                rep["params_sha256"] = json.loads(resp.read())["replica"]["params_sha256"]
    shas = {rep["params_sha256"] for rep in scraped.values()} | ({want} if want else set())
    if len(shas) != 1 or None in shas:
        raise RuntimeError(f"fleet: parameter hashes differ: {shas}")


# ---------------------------------------------------------------------------
# phase 14 (``sparse``): block-sparse attention (ops/sparse_attention) on the
# flash kernels at block 16, training through initialize() with a
# sparse_attention section, and the native host ops
# ---------------------------------------------------------------------------

SPARSE_BLOCK = 16
SPARSE_HIDDEN, SPARSE_HEADS, SPARSE_D = 1024, 16, 64    # BERT-large width
SPARSE_MODES = ("dense", "fixed", "variable", "bigbird", "bslongformer")
# batch 2 (4 before phase 16 joined the script: the plain versions' time
# follows the batch, the checks do not)
SPARSE_PARITY_B, SPARSE_PARITY_S = 2, 1024
SPARSE_TIMED = ((1024, 8), (4096, 2))                   # (S, B) of part b
SPARSE_TIMED_MODES = ("fixed", "bigbird")
SPARSE_SECTION = {"mode": "bigbird", "block": SPARSE_BLOCK}
SPARSE_LAYERS, SPARSE_STEPS, SPARSE_TRAIN_B = 4, 5, 8
SPARSE_KINDS = dict(zip(("fwd", "dq", "dkv"), FLASH_KERNELS))


def _sparse_config(mode, **kw):
    """A sparsity config at its defaults, block 16, BERT-large's heads."""
    from deepspeed_tpu_torch.ops.sparse_attention import sparsity_config_from_dict

    return sparsity_config_from_dict(dict(mode=mode, block=SPARSE_BLOCK, **kw), SPARSE_HEADS)


def _layout_stats(layout):
    rows = layout.astype(bool).sum(-1)
    return dict(maxn=int(rows.max()), mean_row=float(rows.mean()),
                kept_share=float(layout.astype(bool).mean()))


def _sparse_attend(m, x, kp, causal):
    """``BertSparseSelfAttention.forward``, with the causal ``tril`` attention
    mask passed to its ``SparseSelfAttention`` when ``causal``."""
    if not causal:
        return m(x, attention_mask=kp)
    heads = m._transpose_for_scores
    tril = torch.ones(x.shape[1], x.shape[1]).tril()
    ctx = m.sparse_self_attention(heads(m.query(x)), heads(m.key(x)), heads(m.value(x)),
                                  key_padding_mask=kp, attn_mask=tril)
    B, H, S, D = ctx.shape
    return ctx.transpose(1, 2).reshape(B, S, H * D)


def sparse_parity_case(label, mode, dtype_name, kp_mode="add", causal=False, **cfg_kw):
    """Part a: ``BertSparseSelfAttention`` at BERT-large width, S = 1024,
    B = 2: the output and the gradients of the input and the three
    ``Linear``s through the kernels against the same module on the plain
    versions, within phase 7's tolerances (of each tensor's max)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.sparse_attention import BertSparseSelfAttention

    t0 = time.perf_counter()
    dtype, tol = FLASH_DTYPES[dtype_name], GRAD_TOL[dtype_name]
    B, S = SPARSE_PARITY_B, SPARSE_PARITY_S
    random.seed(0)
    torch.manual_seed(0)
    m = BertSparseSelfAttention(SPARSE_HIDDEN, SPARSE_HEADS, _sparse_config(mode, **cfg_kw),
                                device="cuda", dtype=dtype)
    m.sparse_self_attention.key_padding_mask_mode = kp_mode
    layout = m.sparse_self_attention.get_layout(S)
    gen = torch.Generator(device="cuda").manual_seed(5000 + sum(map(ord, label)))
    x = torch.randn(B, S, SPARSE_HIDDEN, generator=gen, device="cuda").to(dtype)
    g = torch.randn(B, S, SPARSE_HIDDEN, generator=gen, device="cuda")
    pad = torch.rand(B, S, generator=gen, device="cuda") < 0.2
    pad[:, 0] = False
    if kp_mode == "add":
        kp = torch.where(pad, -10000.0, 0.0)
    else:
        kp = (~pad).float()
        kp[1] = 0.0                     # sequence 1: every key padded away

    def run():
        m.zero_grad(set_to_none=True)
        leaf = x.detach().requires_grad_()
        out = _sparse_attend(m, leaf, kp, causal)
        (out.float() * g).sum().backward()
        grads = {"input": leaf.grad}
        grads.update((n, p.grad) for n, p in m.named_parameters())
        return out.detach(), grads

    before = dt.kernels.launch_counts()
    out, grads = run()
    after = dt.kernels.launch_counts()
    launched = {k: after[k] - before[k] for k in FLASH_KERNELS}
    if any(n != 1 for n in launched.values()):
        raise RuntimeError(f"{label}: flash launches {launched}, not one of each")
    kernel_s = time.perf_counter() - t0
    with _PlainAttention():
        out_p, grads_p = run()
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0 - kernel_s
    errs = {}
    for name, got, want in [("out", out, out_p)] + [(n, grads[n], grads_p[n]) for n in grads]:
        torch.cuda.synchronize()
        want = want.float()
        # the key bias's gradient is 0 in exact arithmetic (a row's softmax
        # does not move when all its scores shift by q.b), so both runs
        # hold rounding noise there: it is held to the key weight's scale
        scale = grads_p["key.weight"] if name == "key.bias" else want
        err = float((got.float() - want).abs().max()) / max(float(scale.abs().max()), 1e-30)
        if not torch.isfinite(got.float()).all() or not err <= tol:
            raise RuntimeError(f"{label}: {name} differs from the plain versions by {err:.3e} "
                               f"of its max (tolerance {tol})")
        errs[name] = err
    if kp_mode == "mul" and float(out[1].float().abs().max()) == 0.0:
        raise RuntimeError(f"{label}: the fully padded sequence's output is 0, not uniform")
    del m
    return dict(case=label, mode=mode, dtype=dtype_name, batch=B, seq=S, block=SPARSE_BLOCK,
                key_padding=kp_mode, causal=causal, tol=tol, rel_err=errs,
                worst_rel_err=max(errs.values()), layout=_layout_stats(layout),
                kernel_pass_s=kernel_s, plain_pass_s=plain_s)


def sparse_kernel_case(timer, mode, S, Bt):
    """Part b: kernels 1-3 on a default layout at block 16, bf16, padded
    keys: each kernel's time (median of 20, L2 flushed), its bound
    (``_flash_work``: the pairs its LUT visits), SDPA on the same function
    (the layout expanded to a mask with the key bias), SDPA dense without a
    mask and the port's kernels on the dense layout at block 128 (what
    sparsity must beat); at S = 1024 also against the plain versions, with
    their times."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    dtype, block, H, D = torch.bfloat16, SPARSE_BLOCK, SPARSE_HEADS, SPARSE_D
    label = f"bf16 {mode} block16 S={S} B={Bt}"
    random.seed(0)
    layout = _sparse_config(mode).make_layout(S)
    gen = torch.Generator(device="cuda").manual_seed(6000 + S + sum(map(ord, mode)))
    q, k, v, do = (torch.randn(Bt, H, S, D, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    pad = torch.rand(Bt, S, generator=gen, device="cuda") < 0.2
    pad[:, 0] = False
    bias = torch.where(pad, -10000.0, 0.0)
    lut, counts, qlut, qcounts = fa._device_luts(layout, H, S, block, q.device)
    kw = dict(block=block, causal=False)
    pkw = (block, False, 0.0, 0)
    plain = S == SPARSE_PARITY_S
    if plain:
        out_p, lse_p = fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)
    else:
        out_p, lse_p = fa.flash_fwd(q, k, v, bias, lut, counts, **kw)
    delta = (do.float() * out_p.float()).sum(-1).reshape(Bt * H, S)
    bwd_in = (q, k, v, bias, do, lse_p, delta)
    calls = {"fwd": (lambda: fa.flash_fwd(q, k, v, bias, lut, counts, **kw),
                     lambda: fa._flash_fwd_torch(q, k, v, bias, lut, counts, *pkw)),
             "dq": (lambda: fa.flash_bwd_dq(*bwd_in, lut, counts, **kw),
                    lambda: fa._flash_bwd_dq_torch(*bwd_in, lut, counts, *pkw)),
             "dkv": (lambda: fa.flash_bwd_dkv(*bwd_in, qlut, qcounts, **kw),
                     lambda: fa._flash_bwd_dkv_torch(*bwd_in, qlut, qcounts, *pkw))}
    errs = {}
    if plain:
        tol = FLASH_TOL["bf16"]
        out, lse = calls["fwd"][0]()
        errs.update(out=_check_rel(f"{label} out", out, out_p, tol),
                    lse=_check_rel(f"{label} lse", lse, lse_p, FLASH_TOL["fp32"]),
                    dq=_check_rel(f"{label} dq", calls["dq"][0](), calls["dq"][1](), tol))
        for name, got, want in zip(("dk", "dv", "db"), calls["dkv"][0](), calls["dkv"][1]()):
            errs[name] = _check_rel(f"{label} {name}", got, want, tol)
    # yardsticks: SDPA over the same keys, then dense SDPA and the port's
    # kernels on the dense layout at block 128
    dense_mask = fa._expand_layout_mask(layout, S, block).to("cuda")
    mask = (bias[:, None, None, :] + torch.where(dense_mask, 0.0, -10000.0)[None]).to(dtype)
    del dense_mask
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    sdpa = {"masked": lambda: F.scaled_dot_product_attention(*leaves, attn_mask=mask),
            "dense": lambda: F.scaled_dot_product_attention(*leaves)}
    lib = {}
    for name, fn in sdpa.items():
        lib[f"{name}_fwd"] = timer(fn)
        o = fn()
        lib[f"{name}_bwd"] = timer(lambda: torch.autograd.grad(o, leaves, do, retain_graph=True))
        del o
    del mask
    dl = fa._device_luts(None, H, S, fa.DEFAULT_BLOCK, q.device)
    dkw = dict(block=fa.DEFAULT_BLOCK, causal=False)
    out_d, lse_d = fa.flash_fwd(q, k, v, bias, dl[0], dl[1], **dkw)
    dense_in = (q, k, v, bias, do, lse_d, (do.float() * out_d.float()).sum(-1).reshape(Bt * H, S))
    dense128 = {"fwd": timer(lambda: fa.flash_fwd(q, k, v, bias, dl[0], dl[1], **dkw)),
                "dq": timer(lambda: fa.flash_bwd_dq(*dense_in, dl[0], dl[1], **dkw)),
                "dkv": timer(lambda: fa.flash_bwd_dkv(*dense_in, dl[2], dl[3], **dkw))}
    work = _flash_work(lut, counts, qlut, qcounts, block, False, q.element_size(), D, Bt, S)
    res = {}
    for kind, (kern, plain_fn) in calls.items():
        bound_ms, bound_by = _bound(*work[kind], dtype)
        side = "fwd" if kind == "fwd" else "bwd"
        res[kind] = dict(ms=timer(kern), bound_ms=bound_ms, bound_by=bound_by,
                         plain_ms=timer(plain_fn, iters=2, warmup=0) if plain else None,
                         library_ms=lib[f"masked_{side}"], sdpa_dense_ms=lib[f"dense_{side}"],
                         dense_block128_ms=dense128[kind])
    return dict(case=label, mode=mode, seq=S, batch=Bt, block=block, head_dim=D,
                layout=_layout_stats(layout), max_abs_err=errs, kernels=res,
                backward=dict(dq_plus_dkv_ms=res["dq"]["ms"] + res["dkv"]["ms"],
                              library_ms=lib["masked_bwd"], sdpa_dense_ms=lib["dense_bwd"],
                              dense_block128_ms=dense128["dq"] + dense128["dkv"]))


class _SparseEncoder(torch.nn.Module):
    """BERT encoder blocks (post-LN, GELU) around ``BertSparseSelfAttention``
    at BERT-large width; the loss is the mean squared error of the last
    block's output against a target."""

    def __init__(self, sparsity_config, layers):
        super().__init__()
        from deepspeed_tpu_torch.ops.sparse_attention import BertSparseSelfAttention

        H, nn = SPARSE_HIDDEN, torch.nn
        stack = lambda make: nn.ModuleList(make() for _ in range(layers))
        self.attn = stack(lambda: BertSparseSelfAttention(H, SPARSE_HEADS, sparsity_config,
                                                          device="cuda"))
        self.attn_out = stack(lambda: nn.Linear(H, H, device="cuda"))
        self.ln_attn = stack(lambda: nn.LayerNorm(H, device="cuda"))
        self.ff1 = stack(lambda: nn.Linear(H, 4 * H, device="cuda"))
        self.ff2 = stack(lambda: nn.Linear(4 * H, H, device="cuda"))
        self.ln_ffn = stack(lambda: nn.LayerNorm(H, device="cuda"))

    def forward(self, x, target, attention_mask):
        h = x
        for i in range(len(self.attn)):
            h = self.ln_attn[i](h + self.attn_out[i](self.attn[i](h, attention_mask)))
            h = self.ln_ffn[i](h + self.ff2[i](F.gelu(self.ff1[i](h))))
        return F.mse_loss(h.float(), target.float())


def sparse_train_case():
    """Part c: four encoder blocks around ``BertSparseSelfAttention`` from
    the config's ``sparse_attention`` section (BigBird, block 16) at
    BERT-large width, S = 1024, B = 8, bf16 Adam, ZeRO 0, through
    ``initialize()``: 5 steps on one batch; the loss finite and falling,
    4/4/4 flash launches a step, and the host time of the layers' LUT
    lookups; then the flash module's LUT cache hit (hashing the layout),
    which every call paid before ``SparseSelfAttention`` held its LUTs, at
    S = 1024 and 4096."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.sparse_attention import (BigBirdSparsityConfig,
                                                           SparseSelfAttention,
                                                           sparsity_config_from_dict)
    from deepspeed_tpu_torch.ops.transformer import attention as fa
    from deepspeed_tpu_torch.runtime.config import get_sparse_attention

    ds_config = {"train_batch_size": SPARSE_TRAIN_B,
                 "train_micro_batch_size_per_gpu": SPARSE_TRAIN_B,
                 "gradient_accumulation_steps": 1,
                 "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
                 "bf16": {"enabled": True}, "zero_optimization": {"stage": 0},
                 "sparse_attention": dict(SPARSE_SECTION), "steps_per_print": 1000}
    section = get_sparse_attention(ds_config)
    sparsity = sparsity_config_from_dict(section, SPARSE_HEADS)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() / 2**30      # what earlier phases still hold
    random.seed(0)
    torch.manual_seed(0)
    model = _SparseEncoder(sparsity, SPARSE_LAYERS)
    engine, _, _, _ = dt.initialize(model=model, config=ds_config)
    from_engine = engine.sparse_attention_sparsity_config(SPARSE_HEADS)
    if not (isinstance(from_engine, BigBirdSparsityConfig)
            and vars(from_engine) == vars(sparsity)
            and engine.sparse_attention_config() == section):
        raise RuntimeError(f"the engine's sparsity config {vars(from_engine)} is not the "
                           f"section's {section}")
    B, S = SPARSE_TRAIN_B, SPARSE_PARITY_S
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.randn(B, S, SPARSE_HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
    target = torch.randn(B, S, SPARSE_HIDDEN, generator=gen, device="cuda").to(torch.bfloat16)
    mask = torch.where(torch.rand(B, S, generator=gen, device="cuda") < 0.1, -10000.0, 0.0)
    lut_s = []
    orig = SparseSelfAttention.get_luts

    def timed_luts(*a, **kw):
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        lut_s.append(time.perf_counter() - t0)
        return out

    losses, step_ms, lut_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    SparseSelfAttention.get_luts = timed_luts
    try:
        for _ in range(SPARSE_STEPS):
            lut_s.clear()
            t0 = time.perf_counter()
            losses.append(float(engine.train_step([(x, target, mask)])))
            step_ms.append(1e3 * (time.perf_counter() - t0))
            lut_ms.append(1e3 * sum(lut_s))
    finally:
        SparseSelfAttention.get_luts = orig
    counts, host = dt.kernels.launch_counts(), dt.kernels.host_launch_counts()
    per_step = {k: counts[k] / SPARSE_STEPS for k in FLASH_KERNELS}
    if per_step != dict.fromkeys(FLASH_KERNELS, float(SPARSE_LAYERS)):
        raise RuntimeError(f"sparse training: flash launches a step {per_step}, not "
                           f"{SPARSE_LAYERS} of each")
    if host["host_layout_to_lut"] <= 0:
        raise RuntimeError("sparse training built no LUT through the native host op")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"sparse training: the loss is not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30 - held
    layouts = [_layout_stats(a.sparse_self_attention.get_layout(S)) for a in model.attn]
    del engine, model
    torch.cuda.empty_cache()
    # the flash module's LUT cache hit, which hashes the whole layout
    hit_ms = {}
    for seq in (S, 4 * S):
        random.seed(0)
        lay = _sparse_config("bigbird").make_layout(seq)
        hit = lambda: fa._device_luts(lay, SPARSE_HEADS, seq, SPARSE_BLOCK, torch.device("cuda"))
        hit()
        hit_ms[seq] = _host_ms({"hit": hit}, 20)["hit"]
    return dict(model=f"{SPARSE_LAYERS} encoder blocks around BertSparseSelfAttention, "
                      "BERT-large width, bf16 + fp32 masters, Adam lr 1e-4, ZeRO 0",
                section=section, sparsity=vars(sparsity), batch=B, seq=S,
                steps=SPARSE_STEPS, losses=losses, step_ms=step_ms,
                step_ms_after_first=statistics.median(step_ms[1:]), peak_mem_gb=peak,
                held_by_earlier_phases_gb=held,
                launches={k: counts[k] for k in FLASH_KERNELS}, launches_per_step=per_step,
                host_launches=host, lut_lookup_ms_per_step=lut_ms,
                device_luts_hit_ms=hit_ms, layouts=layouts)


def sparse_host_ops_case():
    """Part d: the native host ops against their plain versions on this
    machine's CPU: ``layout_to_lut`` on BigBird at S = 4096 and 16 heads
    (equal); flatten and unflatten over BERT-large's parameter list (a
    round trip equal bit for bit); one LAMB step over its largest tensor
    (the word embeddings, one trust-ratio group) within 1e-6 of its max.
    Times in turns (``_host_ms``); bounds at the rate of a copy stream
    (its write counted twice, as phase 8 does)."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops import host_ops

    random.seed(0)
    layout = _sparse_config("bigbird").make_layout(4 * SPARSE_PARITY_S)
    got, want = host_ops.layout_to_lut_host(layout), host_ops.layout_to_lut_reference(layout)
    if not all(np.array_equal(a, b) for a, b in zip(got, want)):
        raise RuntimeError("layout_to_lut differs from its plain version")
    cfg = dt.BertConfig.bert_large()
    with torch.device("meta"):
        shapes = [tuple(p.shape) for p in dt.BertForPreTraining(cfg).parameters()]
    gen = torch.Generator().manual_seed(11)
    tensors = [torch.randn(s, generator=gen) for s in shapes]
    n = sum(t.numel() for t in tensors)
    flat = host_ops.flatten_host(tensors)
    outs = host_ops.unflatten_host(flat, shapes)
    if not (torch.equal(flat, host_ops.flatten_reference(tensors))
            and all(torch.equal(a, b) for a, b in zip(outs, tensors))):
        raise RuntimeError("flatten / unflatten is no round trip bit for bit")
    big = max(tensors, key=torch.Tensor.numel)
    lamb_in = [big.clone(), big.mul(1e-2), torch.zeros_like(big), torch.zeros_like(big)]
    ref_in = [t.clone() for t in lamb_in]
    hp = dict(lr=1e-3, weight_decay=0.01)
    host_ops.lamb_step_host(*lamb_in, **hp)
    host_ops.lamb_step_reference(*ref_in, **hp)
    lamb_err = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(lamb_in, ref_in))
    if not lamb_err <= 1e-6:
        raise RuntimeError(f"lamb_step differs from its plain version by {lamb_err:.3e}")
    dst = torch.empty_like(flat)
    ms = _host_ms({
        "layout_to_lut": lambda: host_ops.layout_to_lut_host(layout),
        "layout_to_lut_plain": lambda: host_ops.layout_to_lut_reference(layout),
        "flatten": lambda: host_ops.flatten_host(tensors),
        "flatten_plain": lambda: host_ops.flatten_reference(tensors),
        "flatten_library": lambda: torch.cat([t.view(-1) for t in tensors]),
        "unflatten": lambda: host_ops.unflatten_host(flat, shapes),
        "unflatten_plain": lambda: host_ops.unflatten_reference(flat, shapes),
        "lamb_step": lambda: host_ops.lamb_step_host(*lamb_in, **hp),
        "lamb_step_plain": lambda: host_ops.lamb_step_reference(*ref_in, **hp),
        "copy": lambda: dst.copy_(flat)}, 3)
    rate = 3 * n * 4 / (ms["copy"] / 1e3)        # a read, a write counted twice
    lut_bytes = layout.size * 8 + got[0].nbytes + got[1].nbytes
    numel = big.numel()
    ops = {"host_layout_to_lut": (ms["layout_to_lut"], ms["layout_to_lut_plain"], None,
                                  lut_bytes, 0.0),
           "host_flatten": (ms["flatten"], ms["flatten_plain"], ms["flatten_library"],
                            8 * n, 0.0),
           "host_unflatten": (ms["unflatten"], ms["unflatten_plain"], None, 8 * n, 0.0),
           "host_lamb_step": (ms["lamb_step"], ms["lamb_step_plain"], None, 28 * numel,
                              lamb_err)}
    del tensors, flat, outs, dst, lamb_in, ref_in
    return dict(host_bytes_per_s=rate, threads=torch.get_num_threads(),
                layout="bigbird S=4096 16 heads", layout_stats=_layout_stats(layout),
                bert_large_params=n, lamb_elements=numel, ops={
                    name: dict(ms=t, plain_ms=p, library_ms=lib, bound_ms=b / rate * 1e3,
                               bound_by="bytes", max_abs_err=err)
                    for name, (t, p, lib, b, err) in ops.items()})


def phase_sparse(timer):
    """Phase 14; every case is printed as soon as it has passed."""
    parity = [_report("sparse_parity", sparse_parity_case(f"{d} {mode}", mode, d))
              for mode in SPARSE_MODES for d in ("fp32", "bf16")]
    parity += [_report("sparse_parity", sparse_parity_case(
        f"{d} bigbird mul-padding", "bigbird", d, kp_mode="mul")) for d in ("fp32", "bf16")]
    parity += [_report("sparse_parity", sparse_parity_case(
        f"{d} fixed unidirectional causal", "fixed", d, causal=True,
        attention="unidirectional")) for d in ("fp32", "bf16")]
    timed = [_report("sparse_kernel", sparse_kernel_case(timer, mode, S, Bt))
             for S, Bt in SPARSE_TIMED for mode in SPARSE_TIMED_MODES]
    train = _report("sparse_train", sparse_train_case())
    host = _report("sparse_host_ops", sparse_host_ops_case())
    return dict(parity=parity, timed=timed, train=train, host_ops=host)


# ---------------------------------------------------------------------------
# phase 15: pipeline parallelism (GPT-2 XL trained as a pipeline through
# initialize(model=build_gpt2_pipeline(...)))
# ---------------------------------------------------------------------------

PIPE_SEQ, PIPE_MICRO = 1024, 2             # GPT-2 XL's context; 2 sequences a micro-batch
PIPE_EQ_LAYERS, PIPE_EQ_MICRO_BATCHES, PIPE_EQ_STEPS = 4, 4, 3
PIPE_EQ_RUNS = (("1 stage", 1, 1), ("4 stages 1F1B", 4, 1), ("2 stages x 2 chunks", 2, 2))
# (b): 12 of 48 blocks since phase 16 joined the script (depth, not width,
# is cut so the whole script stays inside its time limit)
PIPE_LAYERS = 12
PIPE_STAGES, PIPE_MICRO_BATCHES = 4, 8
PIPE_WARMUP, PIPE_STEPS = 2, 5
PIPE_DROPOUT = 0.1
PIPE_PROMPT_LENS, PIPE_NEW_TOKENS = (16, 100, 300, 900), 16
PIPE_TOKENS = 8192                          # ids drawn below this: a skewed corpus the loss can learn


def _pipe_engine(layers, stages, dtype_name, micro_batches, chunks=1, dropout=0.0,
                 base_seed=1234):
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipeline

    cfg = dt.GPT2Config.gpt2_xl(num_hidden_layers=layers, hidden_dropout_prob=dropout,
                                attention_probs_dropout_prob=dropout)
    module = build_gpt2_pipeline(cfg, num_stages=stages, partition_method="parameters",
                                 base_seed=base_seed)
    ds = {"train_batch_size": PIPE_MICRO * micro_batches,
          "train_micro_batch_size_per_gpu": PIPE_MICRO,
          "gradient_accumulation_steps": micro_batches, "steps_per_print": 1000,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}}
    if dtype_name == "bf16":
        ds["bf16"] = {"enabled": True}
    if chunks > 1:
        ds["pipeline"] = {"num_model_chunks": chunks}
    engine, _, _, _ = dt.initialize(model=module, config_params=ds, device="cuda")
    return cfg, engine


def _pipe_batches(n, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = torch.as_tensor(rng.randint(0, PIPE_TOKENS, (PIPE_MICRO, PIPE_SEQ)),
                              device="cuda")
        out.append((ids, ids))
    return out


def _pipe_blocks(engine):
    """GPT-2 blocks per (virtual) stage."""
    from deepspeed_tpu_torch.models.gpt2_pipe import GPT2BlockPipe

    layers = engine.module.get_layers()
    return [sum(isinstance(layers[i], GPT2BlockPipe)
                for i in range(*engine.module.stage_layer_range(s)))
            for s in range(engine.num_stages)]


def _pipe_expected_launches(engine):
    """Flash launches of one step, reckoned from the schedule: every
    micro-batch runs each block's forward on a stage before the last (no
    grad), then its recompute and backward (dq, dk/dv); the last stage's
    forward is its backward pass's recompute."""
    blocks = _pipe_blocks(engine)
    M, last = engine.micro_batches, engine.num_stages - 1
    fwd = sum((1 if s == last else 2) * b for s, b in enumerate(blocks)) * M
    return {"flash_attention_fwd": fwd, "flash_attention_bwd_dq": sum(blocks) * M,
            "flash_attention_bwd_dkv": sum(blocks) * M}


def _tied_equal(engine):
    (_, owner), (_, user) = engine._tied["embed"]
    return all(torch.equal(a, b) for a, b in zip(engine._slot(engine._masters, owner),
                                                 engine._slot(engine._masters, user)))


def _pipe_barrier_grads(engine, data):
    """One step's schedule with the barrier's update swapped for a read of
    the gradients it would step on (averaged over the micro-batches, tied
    users summed into the owner), by parameter name, and its mean loss;
    nothing is stepped."""
    got = {}

    def read():
        denom = engine.scaler_state.cur_scale * float(engine.micro_batches)
        got.update({n: a / denom for names, acc in zip(engine._names, engine._acc)
                    for n, a in zip(names, acc)})
        for acc in engine._acc:
            torch._foreach_zero_(acc)

    engine._update = read
    try:
        engine._run_schedule([engine._split_batch(b) for b in data[:engine.micro_batches]])
    finally:
        del engine._update
    return got, float(torch.stack(engine._losses).mean())


def _pipe_equal(root):
    """(a) fp32 at 4 of 48 blocks: 1 stage, 4 stages 1F1B and 2 x 2
    interleaved from the same seeds on the same batches, bit for bit under
    deterministic algorithms (the accumulation order is the same: a
    stage's grads sum over micro-batches in order, tied users into the
    owner at the barrier, the norm over every tensor in layer order); the
    4-stage gradients on the kernels against the plain attention versions
    (phase 7's fp32 tolerance); then (c): the 4-stage run's tag, saved,
    consolidated by zero_to_fp32 and converted, decodes what the
    in-memory conversion decodes, and the tag loaded at 2 stages takes the
    4-stage run's next step bit for bit."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.inference.convert import lm_model_from_pipe_layers
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    data = _pipe_batches(PIPE_EQ_MICRO_BATCHES, seed=11)
    torch.use_deterministic_algorithms(True)
    try:
        runs, keep = {}, None
        for label, stages, chunks in PIPE_EQ_RUNS:
            cfg, engine = _pipe_engine(PIPE_EQ_LAYERS, stages, "fp32", PIPE_EQ_MICRO_BATCHES,
                                       chunks)
            losses, tied = [], []
            dt.kernels.reset_launch_counts()
            for _ in range(PIPE_EQ_STEPS):
                losses.append(engine.train_batch(iter(data)))
                tied.append(_tied_equal(engine))
            counts = dt.kernels.launch_counts()
            want = {k: v * PIPE_EQ_STEPS for k, v in _pipe_expected_launches(engine).items()}
            got = {k: counts[k] for k in FLASH_KERNELS}
            if got != want:
                raise RuntimeError(f"pipe (a) {label}: flash launches {got}, the schedule's {want}")
            if not all(tied):
                raise RuntimeError(f"pipe (a) {label}: tied embedding and head differ: {tied}")
            runs[label] = dict(losses=losses, parts=engine.module.parts, launches=got,
                               masters={n: m.clone() for n, m in engine.master_params().items()})
            if stages == PIPE_STAGES:
                keep = engine
            else:
                del engine
                gc.collect()
                torch.cuda.empty_cache()
        ref = runs[PIPE_EQ_RUNS[0][0]]
        equal = {}
        for label, run in runs.items():
            diff = max(float((run["masters"][n] - m).abs().max()) for n, m in ref["masters"].items())
            equal[label] = dict(losses=run["losses"], parts=run["parts"],
                                losses_equal=run["losses"] == ref["losses"],
                                masters_max_abs_diff=diff, launches=run["launches"])
            if run["losses"] != ref["losses"] or diff != 0.0:
                raise RuntimeError(f"pipe (a) {label} differs from 1 stage: {equal[label]}")
        del runs

        # the kernels against the plain attention versions, on the 4-stage
        # engine's current weights (the barrier's update is swapped out)
        dt.kernels.reset_launch_counts()
        grads, loss = _pipe_barrier_grads(keep, data)
        if min(dt.kernels.launch_counts()[k] for k in FLASH_KERNELS) <= 0:
            raise RuntimeError("pipe (a): the kernel gradient pass launched no flash kernel")
        with _PlainAttention():
            grads_p, loss_p = _pipe_barrier_grads(keep, data)
        tol = GRAD_TOL["fp32"]
        worst, worst_name = 0.0, None
        for n, g in grads.items():
            want = grads_p[n]
            err = float((g - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if err >= worst:
                worst, worst_name = err, n
        if not worst <= tol or abs(loss - loss_p) > tol * abs(loss_p):
            raise RuntimeError(f"pipe (a): kernel grads differ from the plain versions' by "
                               f"{worst:.3e} of the max ({worst_name}); loss {loss} vs {loss_p}")
        plain = dict(loss=loss, loss_plain=loss_p, worst_rel_grad_err=worst,
                     worst_param=worst_name, params=len(grads), tol=tol)

        # (c) train to serve, and the restage
        t0 = time.perf_counter()
        keep.save_checkpoint(root, tag="pipe4")
        save_s = time.perf_counter() - t0
        sd = get_fp32_state_dict_from_zero_checkpoint(root, "pipe4")
        served = lm_model_from_pipe_layers(sd["layers"], cfg, device="cuda")
        memory = lm_model_from_pipe_layers(keep._gather_layer_params(), cfg, device="cuda")
        for k, v in memory.state_dict().items():
            if not torch.equal(served.state_dict()[k], v):
                raise RuntimeError(f"pipe (c): the consolidated tag's {k} differs from the masters")
        rng = np.random.RandomState(5)
        prompts = [rng.randint(0, PIPE_TOKENS, n).tolist() for n in PIPE_PROMPT_LENS]
        dt.kernels.reset_launch_counts()
        tokens = {}
        for impl in ("pallas_decode", "pallas_sparse"):
            for prompt in prompts:
                got = dt.generate(served, cfg, [prompt], PIPE_NEW_TOKENS, attn_impl=impl,
                                  kv_page_tokens=PT, device="cuda")[0].tolist()
                want = dt.generate(memory, cfg, [prompt], PIPE_NEW_TOKENS, attn_impl=impl,
                                   kv_page_tokens=PT, device="cuda")[0].tolist()
                if got != want:
                    raise RuntimeError(f"pipe (c) {impl}, prompt {len(prompt)}: the tag's tokens "
                                       f"{got} differ from the in-memory conversion's {want}")
                tokens[f"{impl} {len(prompt)}"] = got
        serve_launches = {k: dt.kernels.launch_counts()[k] for k in SERVING_KERNELS}
        if min(serve_launches.values()) <= 0:
            raise RuntimeError(f"pipe (c): a serving kernel never launched: {serve_launches}")
        del served, memory

        _, restaged = _pipe_engine(PIPE_EQ_LAYERS, 2, "fp32", PIPE_EQ_MICRO_BATCHES, base_seed=99)
        t0 = time.perf_counter()
        restaged.load_checkpoint(root, tag="pipe4")
        load_s = time.perf_counter() - t0
        next_loss = keep.train_batch(iter(data))
        next_restaged = restaged.train_batch(iter(data))
        want_m, got_m = keep.master_params(), restaged.master_params()
        diff = max(float((got_m[n] - m).abs().max()) for n, m in want_m.items())
        if next_restaged != next_loss or diff != 0.0:
            raise RuntimeError(f"pipe (c): the tag loaded at 2 stages took another step "
                               f"({next_restaged} vs {next_loss}, masters {diff:.3e})")
        tag_bytes = sum(os.path.getsize(os.path.join(root, "pipe4", f))
                        for f in os.listdir(os.path.join(root, "pipe4")))
    finally:
        torch.use_deterministic_algorithms(False)
    del keep, restaged
    gc.collect()
    torch.cuda.empty_cache()
    return dict(model=f"gpt2_xl width, {PIPE_EQ_LAYERS} of 48 blocks, fp32, dropout 0, Adam 1e-4",
                micro_batches=PIPE_EQ_MICRO_BATCHES, micro_batch=PIPE_MICRO, seq=PIPE_SEQ,
                steps=PIPE_EQ_STEPS, runs=equal, kernels_vs_plain=plain,
                serve=dict(prompt_lens=list(PIPE_PROMPT_LENS), new_tokens=PIPE_NEW_TOKENS,
                           equal=True, launches=serve_launches, tokens=tokens),
                restage=dict(saved_stages=PIPE_STAGES, loaded_stages=2, loss=next_loss,
                             equal=True, tag_bytes=tag_bytes, save_s=save_s, load_s=load_s))


def _pipe_timed():
    """(b) GPT-2 XL at full width as 4 stages, 1F1B, bf16 with fp32
    masters, dropout 0.1: step ms, tokens/s, peak memory, per-stage
    device time, the bubble estimates, the flash launches a step against
    the schedule's count, and one profiled step."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.pipe.schedule import analytic_bubble_fraction

    cfg, engine = _pipe_engine(PIPE_LAYERS, PIPE_STAGES, "bf16", PIPE_MICRO_BATCHES,
                               dropout=PIPE_DROPOUT)
    n_params = sum(p.numel() for ps in engine._params for p in ps)
    data = _pipe_batches(PIPE_MICRO_BATCHES, seed=12)
    losses = [engine.train_batch(iter(data)) for _ in range(PIPE_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [engine.train_batch(iter(data)) for _ in range(PIPE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    got = {k: counts[k] / PIPE_STEPS for k in FLASH_KERNELS}
    want = _pipe_expected_launches(engine)
    if got != want:
        raise RuntimeError(f"pipe (b): flash launches a step {got}, the schedule's {want}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise RuntimeError(f"pipe (b): the loss is not finite and falling: {losses}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    # read before the profiled step below replaces the stage times
    stage_ms = engine.stage_time_ms()
    rank_ms = [1e3 * t for t in engine._rank_wall_s()]
    est_ms = 1e3 * engine._est_parallel_step_s()
    step_ms = 1e3 * wall / PIPE_STEPS
    tokens = PIPE_MICRO * PIPE_MICRO_BATCHES * PIPE_SEQ
    profile = _profiled(lambda: engine.train_batch(iter(data)))
    res = dict(model=f"gpt2_xl (seed 1234 a layer), {PIPE_LAYERS} blocks, bf16 + fp32 masters, "
                     f"Adam lr 1e-4, dropout {PIPE_DROPOUT}",
               params=n_params, stages=PIPE_STAGES, parts=engine.module.parts,
               blocks_per_stage=_pipe_blocks(engine), micro_batches=PIPE_MICRO_BATCHES,
               micro_batch=PIPE_MICRO, seq=PIPE_SEQ, warmup_steps=PIPE_WARMUP,
               timed_steps=PIPE_STEPS, step_ms=step_ms, tokens_per_s=tokens * PIPE_STEPS / wall,
               peak_mem_gb=peak, losses=losses,
               launches={k: counts[k] for k in FLASH_KERNELS}, launches_per_step=got,
               stage_ms=stage_ms, stage_ms_sum=sum(stage_ms),
               est_parallel_step_ms=est_ms,
               # the idle share that estimate implies (the bubble and the
               # stages' imbalance), beside the schedule's own
               est_parallel_idle=1.0 - sum(rank_ms) / (PIPE_STAGES * est_ms),
               simulated_bubble=engine._schedule_bubble_fraction(),
               analytic_bubble=analytic_bubble_fraction(PIPE_STAGES, PIPE_MICRO_BATCHES),
               profile_one_step=profile,
               busy_share_of_step=profile["device_busy_ms"] / step_ms)
    del engine, data
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_pipe(timer):
    """Phase 15; the kernels at the pipeline's shapes, then (a) and (c),
    then (b)."""
    import tempfile

    # the plain versions take ~0.3 s a call at this shape: 2 timed calls each
    shape = dict(FB=PIPE_MICRO, FH=NH, FS=PIPE_SEQ, FD=HD, padded=False, plain_iters=2)
    cases = [_report("pipe_flash_case", flash_case(timer, label, dtype, **kw, **shape))
             for label, dtype, kw in (
                 ("bf16 gpt2xl causal dropout0.1", "bf16", dict(causal=True, rate=PIPE_DROPOUT)),
                 ("bf16 gpt2xl non-causal dropout0.1", "bf16", dict(rate=PIPE_DROPOUT)),
                 ("fp32 gpt2xl causal", "fp32", dict(causal=True)))]
    ratio = cases[0]["kernels"]["fwd"]["ms"] / cases[1]["kernels"]["fwd"]["ms"]
    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir="build", prefix="pipe_") as root:
        equal = _report("pipe_equal", _pipe_equal(root))
    timed = _report("pipe_timed", _pipe_timed())
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.abspath("build"), prefix="pipe_tp_") as root:
        tp = _report("pipe_tp", _pipe_tp(root))
    return dict(cases=cases, causal_over_noncausal_fwd=ratio, equal=equal, timed=timed, tp=tp)


# ---------------------------------------------------------------------------
# phase 16: tensor, sequence and expert parallelism and 1-bit Adam, on the
# one card: 2 or 4 rank processes (torch.multiprocessing) meet at a
# TCPStore that the phase serves on localhost and talk over a gloo group,
# whose collectives move CUDA tensors through host memory (comm.HOST_STAGED
# counts them), so no time of this phase says anything of NCCL
# ---------------------------------------------------------------------------
PAR_DEVICE = "cuda"
PAR_LAYERS = 4                 # (a), (b): 4 of BERT-large's 24 layers
PAR_FULL_LAYERS = 24           # (c)
PAR_BATCH = 8                  # rows a step in (a), (b), (f)
PAR_C_BATCH = 16               # (c)
PAR_SEQ = 128
PAR_DROPOUT = 0.1
# (a), (b): BERT's own pretraining lr (Devlin et al. 2019), so that Adam
# moves every element by about 1e-4 a step, far above the bounds below
PAR_LR = 1e-4
PAR_STEPS = 3
PAR_C_WARM, PAR_C_TIMED = 2, 5
PAR_SP = dict(B=1, H=16, S=4096, D=64)   # (d)
PAR_SP_TOL = {"fp32": 3e-5, "bf16": 2e-2}
PAR_MOE = dict(d_model=768, d_ff=3072, experts=8, capacity_factor=1.25, tokens=4096)
PAR_MOE_TOL = 1e-4
PAR_ONEBIT_LAYERS, PAR_ONEBIT_FREEZE, PAR_ONEBIT_STEPS = 2, 8, 14
PAR_ONEBIT_LR = 2e-5
PAR_TIMEOUT_S = 600
# (a), (b): each check's bound. Losses relative; the first step's reduced
# gradients against TP 1's, relative to each tensor's largest (phase 7's
# fp32 tolerance); a tag's masters exactly. Adam moves an element whose
# gradient is within rounding of zero by about lr either way, so the
# masters after the steps are held by the share of elements that part from
# TP 1's by more than PAR_TOL
PAR_TOL = 1e-5
PAR_GRAD_TOL = 1e-4
PAR_FLIP_SHARE = 1e-4


def _par_batch(cfg, rows, seq, seed=0, labels=20):
    """``rows`` rows of random ids, each with ``labels`` MLM labels, so the
    mean of the data ranks' losses is the whole batch's loss."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (rows, seq))
    lab = np.full((rows, seq), -1)
    for r in range(rows):
        pos = rng.choice(seq, labels, replace=False)
        lab[r, pos] = rng.randint(0, cfg.vocab_size, labels)
    nsp = rng.randint(0, 2, (rows,))
    as_t = lambda x: torch.as_tensor(x, dtype=torch.long)
    return tuple(as_t(x) for x in (ids, np.zeros_like(ids), np.ones_like(ids), lab, nsp))


def _par_cfg(layers, dropout):
    import deepspeed_tpu_torch as dt

    return dt.BertConfig.bert_large(num_hidden_layers=layers, hidden_dropout_prob=dropout,
                                    attention_probs_dropout_prob=dropout)


def _par_engine(cfg, extra=None, dtype_cfg=None, lr=PAR_LR, params=None):
    import deepspeed_tpu_torch as dt

    ds = {"train_batch_size": PAR_BATCH, "gradient_accumulation_steps": 1,
          "optimizer": {"type": "Adam", "params": {"lr": lr}}, "steps_per_print": 1000}
    ds.update(dtype_cfg or {})
    ds.update(extra or {})
    model = dt.init_bert(cfg, seed=0, device=PAR_DEVICE)
    engine, _, _, _ = dt.initialize(model=model, config=ds, device=PAR_DEVICE,
                                    model_parameters=params(model) if params else None)
    return engine


def _par_rows(engine, batch):
    """This data rank's rows of ``batch``, on the device."""
    dp, r = engine.dp_world_size, engine.mesh.rank("data")
    n = batch[0].shape[0] // dp
    return tuple(t[r * n:(r + 1) * n].to(PAR_DEVICE) for t in batch)


def _par_train(engine, batch, steps):
    rows = _par_rows(engine, batch)
    return [float(engine.train_step([rows])) for _ in range(steps)]


def _par_host(named):
    return {k: _par_copy(v) for k, v in named.items()}


def _par_copy(t):
    """An fp32 host copy (never a view of ``t``, which the step changes in
    place)."""
    return t.detach().to("cpu", torch.float32, copy=True)


def _par_max_diff(masters, want):
    return max(float((masters[k].float().cpu() - want[k].float()).abs().max()) for k in want)


def _par_flips(masters, want):
    """(share of the elements beyond PAR_TOL, largest difference)."""
    beyond = sum(int(((masters[k].float().cpu() - v.float()).abs() > PAR_TOL).sum())
                 for k, v in want.items())
    return beyond / sum(v.numel() for v in want.values()), _par_max_diff(masters, want)


def _par_tap(engine, planted=None):
    """Keeps the first step's reduced gradients (``first``, on the host) and,
    where ``planted`` is given, what it returns just before that reduce."""
    keep = {}
    reduce = engine.allreduce_gradients

    def tap():
        first = "first" not in keep
        if first and planted is not None:
            keep["planted"] = [_par_copy(g) for g in planted()]
        grads = reduce()
        if first:
            keep["first"] = [_par_copy(g) for g in grads]
        return grads

    engine.allreduce_gradients = tap
    return keep


def _par_grad_err(engine, got, want):
    """Largest over the tensors of max |got - want| / max |want|: ``got``
    this rank's reduced gradients (its model shard's data part), ``want``
    TP 1's whole gradients by name, cut to the same part."""
    from deepspeed_tpu_torch.parallel.tp import local_part

    mesh = engine.mesh
    dims = getattr(engine._step_optimizer, "dims", None)
    worst = 0.0
    for i, (name, g) in enumerate(zip(engine._param_names, got)):
        w = want[name]
        if name in engine._tp_place:
            dim, sections = engine._tp_place[name]
            w = local_part(w, dim, mesh.rank("model"), engine.mp_world_size, sections)
        if dims is not None and dims[i] is not None and engine.dp_world_size > 1:
            w = local_part(w, dims[i], mesh.rank("data"), engine.dp_world_size)
        worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return worst


def _par_drop_other_half(engine):
    """A planted fault: the gradient each data rank would step from if the
    data group's reduce dropped the other ranks' part (its own part over
    dp)."""
    from deepspeed_tpu_torch.parallel.tp import local_part

    opt, dp, r = engine._step_optimizer, engine.dp_world_size, engine.mesh.rank("data")
    return [(a if d is None else local_part(a, d, r, dp)) / dp
            for a, d in zip(opt.acc_grads, opt.dims)]


class _NoModelReduce:
    """A planted fault: the backward of "copy to the model region" skips its
    all-reduce over the model group."""

    def __enter__(self):
        from deepspeed_tpu_torch.comm import comm as comm_mod

        self.saved = comm_mod._CopyToRegion.__dict__["backward"]
        comm_mod._CopyToRegion.backward = staticmethod(lambda ctx, g: (g, None))
        return self

    def __exit__(self, *exc):
        from deepspeed_tpu_torch.comm import comm as comm_mod

        comm_mod._CopyToRegion.backward = self.saved


def _par_launches(fn, steps):
    """Flash launches a step (this process) while ``fn`` runs."""
    import deepspeed_tpu_torch as dt

    dt.kernels.reset_launch_counts()
    out = fn()
    counts = dt.kernels.launch_counts()
    return out, {k: counts[k] / steps for k in FLASH_KERNELS}


_PAR_STORE = None      # a rank's client of the phase's TCPStore


def _par_store(port=0):
    """The phase's TCPStore on localhost: served on a free port when
    ``port`` is 0 (the parent), else a client of it (a rank)."""
    from datetime import timedelta

    return torch.distributed.TCPStore("127.0.0.1", port, is_master=port == 0,
                                      wait_for_workers=False,
                                      timeout=timedelta(seconds=PAR_TIMEOUT_S))


def _par_entry(rank, world, root, fn, port, gate):
    # the start-up (imports, the CUDA context, the BLAS library: seconds of
    # reads each) runs at once; the work waits for the parent's key
    # ``gate``, so a later world's start-up hides behind earlier work
    global _PAR_STORE
    stamps = {"entry": time.time()}
    import deepspeed_tpu_torch  # noqa: F401

    if PAR_DEVICE == "cuda":
        torch.cuda.set_device(0)
        torch.empty(1, device=PAR_DEVICE)
    stamps["cuda"] = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    x = torch.ones(8, 8, device=PAR_DEVICE)
    float((x @ x).sum())                       # loads the BLAS library now
    _PAR_STORE = _par_store(port)
    stamps["ready"] = time.time()
    _PAR_STORE.set(f"ready_w{world}_{rank}", "1")
    if gate is not None:
        _PAR_STORE.wait([gate])
    stamps["gate"] = time.time()
    torch.distributed.init_process_group(
        "gloo", store=torch.distributed.PrefixStore(f"w{world}", _PAR_STORE), rank=rank,
        world_size=world)
    stamps["group"] = time.time()
    try:
        out = fn(rank, world, root)
        stamps["work"] = time.time()
        out["stamps"] = stamps
        torch.save(out, os.path.join(root, f"w{world}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _par_start(world, fn, root, port, gate=None):
    import torch.multiprocessing as tmp

    return tmp.start_processes(_par_entry, args=(world, root, fn, port, gate), nprocs=world,
                               join=False, start_method="spawn")


def _par_join(ctx, world, root):
    deadline = time.monotonic() + PAR_TIMEOUT_S
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            raise RuntimeError(f"the world-{world} ranks did not finish in {PAR_TIMEOUT_S} s")
    return [torch.load(os.path.join(root, f"w{world}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _par_dropout_bits(rank, world):
    """One layer's attention at BERT-large's heads with dropout 0.1: this
    rank's 8 heads through the flash forward at its head offset equal,
    bit for bit, those heads of the whole layer's call (TP 1's bits)."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    g = torch.Generator(device=PAR_DEVICE).manual_seed(5)
    q, k, v = (torch.randn(PAR_BATCH, FH, PAR_SEQ, 64, generator=g, device=PAR_DEVICE)
               for _ in range(3))
    bias = torch.zeros(PAR_BATCH, PAR_SEQ, device=PAR_DEVICE)
    whole = fa.flash_attention(q, k, v, bias, dropout_rate=PAR_DROPOUT,
                               generator=torch.Generator().manual_seed(9))
    h = FH // world
    sl = slice(rank * h, (rank + 1) * h)
    part = fa.flash_attention(q[:, sl], k[:, sl], v[:, sl], bias, dropout_rate=PAR_DROPOUT,
                              generator=torch.Generator().manual_seed(9),
                              head_offset=rank * h, rng_heads=FH)
    return bool(torch.equal(part, whole[:, sl]))


def _par_offset_bf16(rank, world):
    """(c)'s attention alone: a rank's 8 of 16 heads in bf16 at B 16, S 128,
    dropout 0.1, at its head offset. Output and dq, dk, dv against the plain
    versions (phase 7's bf16 tolerance of each one's max), and the output
    bit for bit against those heads of the 16-head call."""
    from deepspeed_tpu_torch.ops.transformer import attention as fa

    g = torch.Generator(device=PAR_DEVICE).manual_seed(6)
    mk = lambda: torch.randn(PAR_C_BATCH, FH, PAR_SEQ, 64, generator=g,
                             device=PAR_DEVICE).to(torch.bfloat16)
    q, k, v, dout = mk(), mk(), mk(), mk()
    bias = torch.zeros(PAR_C_BATCH, PAR_SEQ, device=PAR_DEVICE)
    h = FH // world
    sl = slice(rank * h, (rank + 1) * h)
    whole = fa.flash_attention(q, k, v, bias, dropout_rate=PAR_DROPOUT,
                               generator=torch.Generator().manual_seed(9))

    def run():
        ins = [t[:, sl].detach().clone().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*ins, bias, dropout_rate=PAR_DROPOUT,
                                 generator=torch.Generator().manual_seed(9),
                                 head_offset=rank * h, rng_heads=FH)
        out.backward(dout[:, sl])
        return [out.detach()] + [t.grad for t in ins]

    got = run()
    with _PlainAttention():
        want = run()
    errs = [float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()), 1e-30)
            for a, b in zip(got, want)]
    bits = bool(torch.equal(got[0], whole[:, sl]))
    if max(errs) > GRAD_TOL["bf16"] or not bits:
        raise RuntimeError(f"bf16 flash at head offset {rank * h}: out/dq/dk/dv {errs} of the "
                           f"plain versions' max, bits equal to the 16-head call: {bits}")
    return dict(case=f"bf16 B{PAR_C_BATCH} H{h} of {FH} at offset {rank * h} S{PAR_SEQ} D64 "
                     f"dropout {PAR_DROPOUT}", rel_err_out_dq_dk_dv=errs,
                tol=GRAD_TOL["bf16"], bits_equal_16_head_call=bits)


def _par_grad_oracle(engine, batch):
    """The TP 2 model's gradients on the kernels against the plain attention
    versions (phase 7's fp32 tolerance), and the reading of a planted fault:
    the same gradients with the model group's backward all-reduce skipped."""
    rows = _par_rows(engine, batch)
    model = engine.module

    def run():
        model.zero_grad(set_to_none=True)
        loss = model(*rows, dropout_seed=77)
        loss.backward()
        return float(loss), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    def worst(a, b):
        return max(float((g - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30)
                   for n, g in a.items())

    loss, grads = run()
    with _PlainAttention():
        loss_p, grads_p = run()
    with _NoModelReduce():
        planted = worst(run()[1], grads)
    model.zero_grad(set_to_none=True)
    err = worst(grads, grads_p)
    if not err <= GRAD_TOL["fp32"] or abs(loss - loss_p) > GRAD_TOL["fp32"] * abs(loss_p):
        raise RuntimeError(f"TP 2 kernel grads differ from the plain run's by {err:.3e}")
    return dict(worst_rel_grad_err=err, loss=loss, loss_plain=loss_p, tol=GRAD_TOL["fp32"],
                planted_no_model_reduce=planted)


def _par_tp_equal(rank, world, root):
    """(a): TP 2, fp32, dropout 0.1, against the parent's TP 1."""
    cfg = _par_cfg(PAR_LAYERS, PAR_DROPOUT)
    batch = _par_batch(cfg, PAR_BATCH, PAR_SEQ)
    engine = _par_engine(cfg, {"tensor_parallel": {"size": world}})
    tap = _par_tap(engine)
    losses, per_step = _par_launches(lambda: _par_train(engine, batch, PAR_STEPS), PAR_STEPS)
    _PAR_STORE.wait(["tp1_dropout"])           # the parent's TP 1 runs beside (a)
    want = torch.load(os.path.join(root, "tp1_dropout.pt"))
    masters = engine.master_params()           # gathered over the model group
    flip_share, max_diff = _par_flips(masters, want["masters"])
    out = dict(losses=losses, launches_per_step=per_step, master_flip_share=flip_share,
               master_max_abs_diff=max_diff,
               grad_rel=_par_grad_err(engine, tap["first"], want["grads"]),
               grad_oracle=_par_grad_oracle(engine, batch),
               dropout_bits_equal=_par_dropout_bits(rank, world))
    del engine, masters
    return out


def _par_tp_timed(rank, world):
    """(c): TP 2, bf16, full depth, dropout 0.1, default algorithms."""
    torch.use_deterministic_algorithms(False)
    offset = _par_offset_bf16(rank, world)
    cfg = _par_cfg(PAR_FULL_LAYERS, PAR_DROPOUT)
    batch = _par_batch(cfg, PAR_C_BATCH, PAR_SEQ, seed=2)
    engine = _par_engine(cfg, {"tensor_parallel": {"size": world},
                               "train_batch_size": PAR_C_BATCH},
                         dtype_cfg={"bf16": {"enabled": True}}, lr=1e-4)
    losses = _par_train(engine, batch, PAR_C_WARM)
    from deepspeed_tpu_torch import comm

    staged0 = dict(comm.HOST_STAGED)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed, per_step = _par_launches(lambda: _par_train(engine, batch, PAR_C_TIMED),
                                    PAR_C_TIMED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    losses += timed
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise RuntimeError(f"TP 2 bf16 losses not finite or not falling: {losses}")
    staged = {k: (comm.HOST_STAGED[k] - staged0[k]) / PAR_C_TIMED for k in staged0}
    out = dict(losses=losses, step_ms=1e3 * wall / PAR_C_TIMED,
               samples_per_s=PAR_C_BATCH * PAR_C_TIMED / wall,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
               launches_per_step=per_step, host_staged_per_step=staged, offset_bf16=offset)
    del engine
    torch.use_deterministic_algorithms(True)
    return out


def _par_sp_want_launches(path, world, rank, causal):
    """Flash launches of one fwd + bwd: the ring runs each kernel once a
    hop it does not skip (a causal rank skips the later ranks' chunks),
    Ulysses and the whole sequence once."""
    n = (rank + 1 if causal else world) if path == "ring" else 1
    return {k: n for k in FLASH_KERNELS}


def _par_sp(rank, world):
    """(d): ring and Ulysses at W = 2 against one process's whole-sequence
    flash attention, forward and q, k, v gradients, with each path's
    launches; bf16 timed."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.ops.transformer.attention import flash_attention
    from deepspeed_tpu_torch.parallel.sequence import ring_attention
    from deepspeed_tpu_torch.parallel.ulysses import ulysses_attention

    group = torch.distributed.group.WORLD
    B, H, S, D = (PAR_SP[k] for k in "BHSD")
    res = []
    for dtype_name in ("fp32", "bf16"):
        dtype = FLASH_DTYPES[dtype_name]
        for case in ("causal", "padded"):
            g = torch.Generator(device=PAR_DEVICE).manual_seed(11)
            mk = lambda: (torch.randn(B, H, S, D, generator=g, device=PAR_DEVICE) * 0.5).to(dtype)
            q, k, v, dout = mk(), mk(), mk(), mk()
            bias = torch.zeros(B, S, device=PAR_DEVICE)
            if case == "padded":
                bias[:, -S // 8:] = -10000.0
            causal = case == "causal"

            def fwd_bwd(fn):
                ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
                out = fn(*ins)
                out.backward(dout)
                return out.detach(), [t.grad for t in ins]

            paths = {"whole": lambda a, b, c: flash_attention(a, b, c, bias, causal=causal),
                     "ring": lambda a, b, c: ring_attention(a, b, c, bias, group=group,
                                                            causal=causal),
                     "ulysses": lambda a, b, c: ulysses_attention(a, b, c, bias, group=group,
                                                                  causal=causal)}
            want_out, want_g = fwd_bwd(paths["whole"])
            row = dict(case=f"{dtype_name} {case} B{B} H{H} S{S} D{D} W{world}")
            for name in ("whole", "ring", "ulysses"):
                dt.kernels.reset_launch_counts()
                got_out, got_g = fwd_bwd(paths[name])
                launches = {k: dt.kernels.launch_counts()[k] for k in FLASH_KERNELS}
                want_launches = _par_sp_want_launches(name, world, rank, causal)
                if PAR_DEVICE == "cuda" and launches != want_launches:
                    raise RuntimeError(f"{row['case']} {name} launched {launches}, "
                                       f"want {want_launches}")
                errs = []
                for got, want in zip([got_out] + got_g, [want_out] + want_g):
                    got, want = got.float(), want.float()
                    if dtype_name == "fp32":   # JAX's assert_allclose(atol=rtol=3e-5)
                        bad = (got - want).abs() > PAR_SP_TOL["fp32"] * (1 + want.abs())
                        errs.append(float((got - want).abs().max()))
                        if bool(bad.any()):
                            raise RuntimeError(f"{row['case']} {name} beyond 3e-5: {errs[-1]}")
                    else:
                        err = float((got - want).abs().max()) / max(float(want.abs().max()),
                                                                   1e-30)
                        errs.append(err)
                        if err > PAR_SP_TOL["bf16"]:
                            raise RuntimeError(f"{row['case']} {name} beyond 2e-2: {err}")
                row[name] = dict(err_out_dq_dk_dv=errs, launches=launches)
                if dtype_name == "bf16":   # the dtype the main path trains in
                    torch.distributed.barrier()
                    row[name]["fwd_bwd_ms"] = _par_ms(lambda: fwd_bwd(paths[name]), warm=False)
            res.append(row)
    return res


def _par_ms(fn, iters=2, warm=True):
    """Host-clock ms a call of ``fn`` (synchronized), after one warm-up call
    unless the caller's own call just warmed it."""
    if warm:
        fn()
    torch.cuda.synchronize() if PAR_DEVICE == "cuda" else None
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize() if PAR_DEVICE == "cuda" else None
    return 1e3 * (time.perf_counter() - t0) / iters


def _par_moe(rank, world):
    """(e): expert_parallel_ffn at W = 2 against moe_ffn on this rank's
    tokens with every expert (the routing is per rank in both)."""
    from deepspeed_tpu_torch.parallel.expert import expert_parallel_ffn, moe_ffn

    m = PAR_MOE
    E, d, f, T = m["experts"], m["d_model"], m["d_ff"], m["tokens"]
    g = torch.Generator(device=PAR_DEVICE).manual_seed(3)
    params = {"router": torch.randn(d, E, generator=g, device=PAR_DEVICE) * 0.05,
              "w1": torch.randn(E, d, f, generator=g, device=PAR_DEVICE) * 0.02,
              "b1": torch.randn(E, f, generator=g, device=PAR_DEVICE) * 0.02,
              "w2": torch.randn(E, f, d, generator=g, device=PAR_DEVICE) * 0.02,
              "b2": torch.randn(E, d, generator=g, device=PAR_DEVICE) * 0.02}
    gx = torch.Generator(device=PAR_DEVICE).manual_seed(100 + rank)
    x = torch.randn(T, d, generator=gx, device=PAR_DEVICE)
    cap = max(4, int(np.ceil(m["capacity_factor"] * T / E)))
    n = E // world
    local = {k: (v if k == "router" else v[rank * n:(rank + 1) * n].contiguous())
             for k, v in params.items()}
    group = torch.distributed.group.WORLD
    with torch.no_grad():
        out, aux = expert_parallel_ffn(local, x, cap, group)
        want, want_aux = moe_ffn(params, x, cap)
        err = float((out - want).abs().max())
        if err > PAR_MOE_TOL:
            raise RuntimeError(f"expert parallelism differs from moe_ffn by {err}")
        ms = _par_ms(lambda: expert_parallel_ffn(local, x, cap, group))
    return dict(case=f"Switch-Base-8 widths d {d} f {f} E {E} cf {m['capacity_factor']} "
                     f"tokens/rank {T} capacity {cap}", max_abs_err=err, tol=PAR_MOE_TOL,
                aux=float(aux), aux_local=float(want_aux), ep_ms=ms)


def _par_onebit(rank, world):
    """(f): 1-bit Adam at dp 2, BERT-large width at 2 layers, fp32, dropout
    off, the embedding tables frozen: their sparse gradients leave rows of
    zero variance, which the frozen-variance step divides by, in JAX's
    algorithm as in the port's (tests/test_torch_onebit_adam.py)."""
    from deepspeed_tpu_torch.runtime.fp16.onebit_adam import compressed_bytes_per_step

    cfg = _par_cfg(PAR_ONEBIT_LAYERS, 0.0)
    batch = _par_batch(cfg, PAR_BATCH, PAR_SEQ, seed=4)
    dense = lambda model: [p for n, p in model.named_parameters()
                           if not (n.startswith("bert.embeddings.") and "LayerNorm" not in n)]
    runs = {}
    for name, opt in (("onebit", {"type": "OneBitAdam", "params": {
            "lr": PAR_ONEBIT_LR, "freeze_step": PAR_ONEBIT_FREEZE}}),
                      ("adam", {"type": "Adam", "params": {"lr": PAR_ONEBIT_LR}})):
        engine = _par_engine(cfg, {"optimizer": opt}, params=dense)
        steps = PAR_ONEBIT_STEPS if name == "onebit" else PAR_ONEBIT_FREEZE
        rows = _par_rows(engine, batch)
        losses, t = [], []
        for step in range(steps):
            torch.cuda.synchronize() if PAR_DEVICE == "cuda" else None
            t0 = time.perf_counter()
            losses.append(float(engine.train_step([rows])))
            t.append(1e3 * (time.perf_counter() - t0))
            if step + 1 == PAR_ONEBIT_FREEZE:
                warm = {k: v.detach().cpu().clone() for k, v in engine.master_params().items()}
        runs[name] = dict(losses=losses, warm=warm, step_ms=t, onebit=engine._onebit,
                          numel=sum(p.numel() for p in engine._params))
        del engine
    ob, ad = runs["onebit"], runs["adam"]
    if not ob["onebit"] or ad["onebit"]:
        raise RuntimeError("the 1-bit engine did not take the compressed path")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(ob["losses"], ad["losses"]))
    master_err = max(float(((ob["warm"][k] - v).abs() - 1e-4 * v.abs()).max())
                     for k, v in ad["warm"].items())
    if loss_err > 1e-4 or master_err > 1e-5:
        raise RuntimeError(f"1-bit warm-up differs from dense Adam: losses {loss_err}, "
                           f"masters {master_err}")
    # the whole batch's loss: the mean of the data ranks' (equal label counts)
    from deepspeed_tpu_torch import comm

    mean = comm.all_reduce(torch.tensor(ob["losses"], dtype=torch.float64),
                           torch.distributed.group.WORLD, comm.ReduceOp.AVG).tolist()
    comp = mean[PAR_ONEBIT_FREEZE:]
    if not (np.isfinite(comp).all() and comp[-1] < mean[0]):
        raise RuntimeError(f"1-bit compressed steps not finite or not below the first "
                           f"loss: {mean}")
    compressed, dense_b = compressed_bytes_per_step(ob["numel"], world)
    return dict(losses=ob["losses"], batch_losses=mean, adam_losses=ad["losses"],
                warmup_loss_rel_err=loss_err,
                warmup_master_excess=master_err, onebit_step_ms=ob["step_ms"],
                adam_step_ms=ad["step_ms"], numel=ob["numel"],
                bytes_sent_per_rank_step=dict(compressed=compressed, dense_allreduce=dense_b))




def _par_worker2(rank, world, root):
    out, secs = {}, {}
    for part, fn in (("a", lambda: _par_tp_equal(rank, world, root)),
                     ("c", lambda: _par_tp_timed(rank, world)),
                     ("d", lambda: _par_sp(rank, world)), ("e", lambda: _par_moe(rank, world)),
                     ("f", lambda: _par_onebit(rank, world)),
                     ("g", lambda: _par_moe_engine(rank, world))):
        t0 = time.perf_counter()
        out[part] = fn()
        gc.collect()
        torch.cuda.empty_cache() if PAR_DEVICE == "cuda" else None
        secs[part] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def _par_worker4(rank, world, root):
    """(b): TP 2 x ZeRO-2 at data x model = 2 x 2, fp32, dropout off."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    cfg = _par_cfg(PAR_LAYERS, 0.0)
    batch = _par_batch(cfg, PAR_BATCH, PAR_SEQ)
    marks = [time.perf_counter()]
    engine = _par_engine(cfg, {"tensor_parallel": {"size": 2}, "zero_optimization":
                               {"stage": 2}, "mesh": {"data_parallel_size": world // 2}})
    tap = _par_tap(engine, planted=lambda: _par_drop_other_half(engine))
    marks.append(time.perf_counter())
    losses = _par_train(engine, batch, PAR_STEPS)
    marks.append(time.perf_counter())
    masters = engine.master_params()
    want = torch.load(os.path.join(root, "tp1_nodrop.pt"))
    flip_share, max_diff = _par_flips(masters, want["masters"])
    out = dict(losses=losses, master_flip_share=flip_share, master_max_abs_diff=max_diff,
               grad_rel=_par_grad_err(engine, tap["first"], want["grads"]),
               planted_drop_other_half=_par_grad_err(engine, tap["planted"], want["grads"]),
               dp=engine.dp_world_size, mp=engine.mp_world_size)
    del want
    tag_dir = os.path.join(root, "tag")
    marks.append(time.perf_counter())
    engine.save_checkpoint(tag_dir, tag="t")
    marks.append(time.perf_counter())
    if rank == 0:
        sd = get_fp32_state_dict_from_zero_checkpoint(tag_dir, "t")
        out["zero_to_fp32_max_abs_diff"] = _par_max_diff(masters, sd)
    marks.append(time.perf_counter())
    out["next_loss"] = _par_train(engine, batch, 1)[0]
    nxt = engine.master_params()
    if rank == 0:
        torch.save(_par_host(nxt), os.path.join(root, "tp2_next.pt"))
    marks.append(time.perf_counter())
    out["seconds"] = dict(zip(("init", "steps", "checks", "save", "zero_to_fp32", "next"),
                              np.diff(marks).tolist()))
    del engine, masters, nxt
    return out


def _par_tp1(root, store, name, dropout):
    """TP 1 in this process: its losses, and on file its masters after the
    steps and its first step's gradients (then the key ``name`` in
    ``store``). Also returns the masters' largest move, the reading of a tag
    that held the initial weights."""
    cfg = _par_cfg(PAR_LAYERS, dropout)
    engine = _par_engine(cfg)
    init = _par_host(engine.master_params())
    tap = _par_tap(engine)
    losses = _par_train(engine, _par_batch(cfg, PAR_BATCH, PAR_SEQ), PAR_STEPS)
    masters = _par_host(engine.master_params())
    torch.save(dict(masters=masters, grads=dict(zip(engine._param_names, tap["first"]))),
               os.path.join(root, f"{name}.pt"))
    store.set(name, "1")
    moved = _par_max_diff(masters, init)
    del engine, tap, masters, init
    gc.collect()
    return losses, moved


def _par_tp1_load(root):
    """(b)'s tag at TP 1: the masters loaded (and, as the reading of a load
    that loads nothing, the fresh engine's) against the tag's, then the next
    step."""
    from deepspeed_tpu_torch.utils.zero_to_fp32 import get_fp32_state_dict_from_zero_checkpoint

    tag_dir = os.path.join(root, "tag")
    cfg = _par_cfg(PAR_LAYERS, 0.0)
    engine = _par_engine(cfg)
    tag = get_fp32_state_dict_from_zero_checkpoint(tag_dir, "t")
    fresh = _par_max_diff(engine.master_params(), tag)
    engine.load_checkpoint(tag_dir, tag="t")
    loaded = _par_max_diff(engine.master_params(), tag)
    loss = _par_train(engine, _par_batch(cfg, PAR_BATCH, PAR_SEQ), 1)[0]
    flips = _par_flips(engine.master_params(), torch.load(os.path.join(root, "tp2_next.pt")))
    del engine, tag
    return dict(loaded_abs=loaded, fresh_abs=fresh, next_loss=loss, next_flip_share=flips[0],
                next_max_abs_diff=flips[1])


def phase_parallel():
    """Phase 16; the parent runs TP 1 (and loads (b)'s tag at TP 1), the
    ranks run the rest."""
    import tempfile

    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.abspath("build"), prefix="parallel_") as root:
        # the world-2 ranks start (a) while this process runs TP 1; once
        # they are up, the world-4 ranks start up behind their work and wait
        # for "go4"
        t0, epoch = time.perf_counter(), time.time()
        store = _par_store()
        ctx2, ctx4 = _par_start(2, _par_worker2, root, store.port), None
        try:
            torch.use_deterministic_algorithms(True)
            ref, moved = {}, {}
            for name, dropout in (("tp1_dropout", PAR_DROPOUT), ("tp1_nodrop", 0.0)):
                ref[name], moved[name] = _par_tp1(root, store, name, dropout)
            torch.use_deterministic_algorithms(False)
            moe_ref = _par_moe_engine_run()            # (g) at world 1
            torch.cuda.empty_cache() if PAR_DEVICE == "cuda" else None
            stamps = {"tp1": time.time() - epoch}
            store.wait([f"ready_w2_{r}" for r in range(2)])
            ctx4 = _par_start(4, _par_worker4, root, store.port, gate="go4")
            stamps["w4_started"] = time.time() - epoch
            w2 = _par_join(ctx2, 2, root)
            w2_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            store.set("go4", "1")
            w4 = _par_join(ctx4, 4, root)
            w4_s = time.perf_counter() - t0
            stamps["w4"] = time.time() - epoch
        finally:
            for p in ctx2.processes + (ctx4.processes if ctx4 else []):
                if p.is_alive():
                    p.kill()
            del store
        torch.use_deterministic_algorithms(True)
        tp1_load = _par_tp1_load(root)
        torch.use_deterministic_algorithms(False)
    a = [r["a"] for r in w2]
    rel = lambda got, want: max(abs(g - w) / abs(w) for g, w in zip(got, want))
    # name: (the sound run's reading, its bound, a planted fault's reading
    # or None); ranks 0, 1 form data rank 0's model group, 2, 3 data rank 1's
    checks = {
        "a_loss_rel": (max(rel(r["losses"], ref["tp1_dropout"]) for r in a), PAR_TOL, None),
        "a_grad_rel": (max(r["grad_rel"] for r in a), PAR_GRAD_TOL,
                       max(r["grad_oracle"]["planted_no_model_reduce"] for r in a)),
        "a_master_flip_share": (max(r["master_flip_share"] for r in a), PAR_FLIP_SHARE, None),
        "b_loss_rel": (rel(np.mean([w4[0]["losses"], w4[2]["losses"]], axis=0),
                           ref["tp1_nodrop"]), PAR_TOL, None),
        "b_grad_rel": (max(r["grad_rel"] for r in w4), PAR_GRAD_TOL,
                       max(r["planted_drop_other_half"] for r in w4)),
        "b_master_flip_share": (max(r["master_flip_share"] for r in w4), PAR_FLIP_SHARE, None),
        "b_zero_to_fp32_abs": (w4[0]["zero_to_fp32_max_abs_diff"], 0.0, moved["tp1_nodrop"]),
        "b_tp1_loaded_abs": (tp1_load["loaded_abs"], 0.0, tp1_load["fresh_abs"]),
        "b_tp1_next_loss_rel": (abs(np.mean([w4[0]["next_loss"], w4[2]["next_loss"]])
                                    - tp1_load["next_loss"]) / abs(tp1_load["next_loss"]),
                                PAR_TOL, None),
        "b_tp1_next_flip_share": (tp1_load["next_flip_share"], PAR_FLIP_SHARE, None),
        "g_moe_loss_rel": (rel(np.mean([r["g"]["losses"] for r in w2], axis=0),
                               moe_ref["losses"]), PAR_TOL, None),
        "g_moe_master_flip_share": (_par_flips(w2[0]["g"]["masters"], moe_ref["masters"])[0],
                                    PAR_FLIP_SHARE,
                                    _par_flips(w2[0]["g"]["planted_masters"],
                                               moe_ref["masters"])[0]),
    }
    print("parallel_checks", json.dumps(dict(
        checks=checks, tp1_losses=ref, a_losses=[r["losses"] for r in a],
        b_losses=[r["losses"] for r in w4], b_next=[r["next_loss"] for r in w4],
        tp1_load=tp1_load)), flush=True)
    bad = {k: v for k, v in checks.items() if not v[0] <= v[1]}
    if bad:
        raise RuntimeError(f"TP 2 / TP x ZeRO-2 differ from TP 1 past the bounds "
                           f"(reading, bound, planted): {bad}")
    blind = {k: v for k, v in checks.items() if v[2] is not None and not v[2] > v[1]}
    if blind:
        raise RuntimeError(f"a planted fault would pass these checks (reading, bound, "
                           f"planted): {blind}")
    if not all(r["dropout_bits_equal"] for r in a):
        raise RuntimeError("TP 2's attention dropout did not draw TP 1's Philox bits")
    want_launch = {k: float(PAR_LAYERS) for k in FLASH_KERNELS}
    if PAR_DEVICE == "cuda" and any(r["launches_per_step"] != want_launch for r in a):
        raise RuntimeError(f"TP 2 flash launches a rank a step: "
                           f"{[r['launches_per_step'] for r in a]}, want {want_launch}")
    print("parallel: every collective of this phase ran over gloo, CUDA tensors staged "
          "through host memory; its times say nothing of NCCL", flush=True)
    return dict(
        note="gloo on one card: collectives stage CUDA tensors through host memory",
        checks={k: dict(reading=v[0], bound=v[1], planted=v[2]) for k, v in checks.items()},
        tp1_losses=ref, wall_s={"tp1_beside_w2": w2_s, "w4_after_its_start_up": w4_s},
        rank_seconds={"w2": [r["seconds"] for r in w2], "w4": [r["seconds"] for r in w4]},
        # each rank's start, start-up done, gate, group, work done: s after
        # the phase started its ranks
        parent_stamps=stamps, rank_stamps={w: [{k: v - epoch for k, v in r["stamps"].items()} for r in rs]
                     for w, rs in (("w2", w2), ("w4", w4))},
        a=dict(model=f"bert_large width, {PAR_LAYERS} layers, fp32, dropout {PAR_DROPOUT}, "
                     f"Adam lr {PAR_LR}, TP 2 vs TP 1, {PAR_STEPS} steps, B {PAR_BATCH}",
               ranks=a),
        b=dict(model=f"bert_large width, {PAR_LAYERS} layers, fp32, dropout 0, TP 2 x "
                     f"ZeRO-2 at data x model 2 x 2, Adam lr {PAR_LR}", ranks=w4,
               tp1_load=tp1_load),
        c=dict(model=f"bert_large, {PAR_FULL_LAYERS} layers, bf16, dropout {PAR_DROPOUT}, "
                     f"Adam lr 1e-4, TP 2, B {PAR_C_BATCH}, {PAR_C_WARM} warm-up + "
                     f"{PAR_C_TIMED} timed steps", ranks=[r["c"] for r in w2]),
        d=[r["d"] for r in w2], e=[r["e"] for r in w2], f=[r["f"] for r in w2],
        g=dict(model=f"Dense + MoELayer (Switch-Base-8 widths: {PAR_MOE['experts']} experts, "
                     f"d {PAR_MOE['d_model']}, f {PAR_MOE['d_ff']}, capacity factor "
                     f"{PAR_MOE['experts']}) + Dense, fp32, no aux loss, Adam "
                     f"lr {PAR_MOE_ENGINE['lr']}; dp 2 with the experts split against world 1",
               world1_losses=moe_ref["losses"], ranks_losses=[r["g"]["losses"] for r in w2],
               planted_losses=[r["g"]["planted_losses"] for r in w2],
               seconds=[r["g"]["seconds"] for r in w2]))


# ---------------------------------------------------------------------------
# phase 17: the serving engine on a tensor-parallel mesh (serving.mesh_shape
# (1, 2)): GPT-2 large, two rank processes on the one card over gloo (the
# phase-16 machinery), rank 0 planning every step; the decode and band
# kernels run over a rank's 10 of the 20 heads
# ---------------------------------------------------------------------------

TP_DEVICE = "cuda"
STP_LAYERS = 6                 # (a): 6 of GPT-2 large's 36 layers, fp32
STP_TIMED_LAYERS = 36          # (c): all 36, bf16
STP_HEADS = 10                 # a rank's heads at TP 2 (GPT-2 large: 20 of 64)
STP_PREFIX_MB = 512            # (a)'s prefix cache: every prompt of the pass fits
STP_DEADLINE = dict(prompts=3, new=12, timeout_s=60.0, jump_after=3, jump_s=600.0)
STP_MARGIN = 1e-3              # phase 4's rule: a divergence only at a near-tie


def _stp_engine(model, cfg, kv, tp, **knobs):
    """Phase 3's engine (8 slots, the paged-decode kernel, the band kernel for
    the largest bucket) at mesh (1, 2) when ``tp``."""
    from deepspeed_tpu_torch import ServingConfig, ServingEngine
    from deepspeed_tpu_torch.inference.serving.scheduler import default_buckets

    largest = default_buckets(cfg.max_position_embeddings - 1)[-1]
    scfg = ServingConfig(max_slots=B, max_seq_len=cfg.max_position_embeddings,
                         kv_cache_dtype=kv, mesh_shape=(1, 2) if tp else None,
                         attention_impl={"default": "pallas_decode", largest: "pallas_sparse"},
                         **knobs)
    return ServingEngine(model, cfg, scfg, device=TP_DEVICE)


def _stp_model(layers, dtype):
    import deepspeed_tpu_torch as dt

    cfg = dt.GPT2Config.gpt2_large(num_hidden_layers=layers)
    return cfg, dt.init_gpt2(cfg, seed=0, device=TP_DEVICE, dtype=dtype)


def _stp_serve(eng, passes=1, prompts=None, new=NEW_TOKENS, timeout_s=None, clock_jump=None,
               warmup=False):
    """Rank 0 submits ``prompts`` ``passes`` times (draining each pass) and
    closes the engine; another rank follows its plans. Returns rank 0's
    tokens (an error's name for a request that failed) and each pass's
    metrics, and every rank's (step, timed out, completed) after each step.
    ``clock_jump`` = (step, s) moves rank 0's clock ahead after that step;
    ``warmup`` first serves the shortest prompt 4 tokens (one-time costs),
    unreported."""
    from deepspeed_tpu_torch.inference.serving.metrics import ServingMetrics

    prompts = _prompts() if prompts is None else prompts
    steps, passes_out, toks = [], [], []
    real = time.monotonic
    offset = [0.0]
    if clock_jump is not None and eng._lead:
        time.monotonic = lambda: real() + offset[0]
    try:
        if not eng._lead:
            while eng.step() is not None:
                steps.append((eng._step_count, eng.scheduler.timed_out,
                              eng.scheduler.completed))
            return dict(steps=steps)
        if warmup:
            eng.submit(prompts[0], max_new_tokens=4)
            eng.drain()
        for _ in range(passes):
            eng.metrics = ServingMetrics()
            staged0 = dict(_comm_staged())
            futs = [eng.submit(p, max_new_tokens=new,
                               timeout_s=timeout_s if i == 1 else None)
                    for i, p in enumerate(prompts)]
            t0, s0 = time.perf_counter(), eng._step_count
            while eng.pending():
                eng.step()
                steps.append((eng._step_count, eng.scheduler.timed_out,
                              eng.scheduler.completed))
                if clock_jump is not None and eng._step_count == clock_jump[0]:
                    offset[0] = clock_jump[1]
            torch.cuda.synchronize() if TP_DEVICE == "cuda" else None
            wall = time.perf_counter() - t0
            snap = eng.metrics.snapshot()
            n_steps = eng._step_count - s0
            staged = {k: _comm_staged()[k] - staged0[k] for k in staged0}
            passes_out.append(dict(
                ttft_p50_s=snap["ttft_p50_s"], ttft_p95_s=snap["ttft_p95_s"],
                decode_tokens_per_s=snap["tokens_per_sec"],
                decode_step_ms=1e3 * snap["decode_time_s"] / max(snap["decode_steps"], 1),
                decode_steps=snap["decode_steps"], engine_steps=n_steps, wall_s=wall,
                host_staged_calls_per_step=staged["calls"] / max(n_steps, 1),
                host_staged_bytes_per_step=staged["bytes"] / max(n_steps, 1)))
            out = []
            for f in futs:
                try:
                    out.append(f.result(timeout=0))
                except Exception as exc:  # noqa: BLE001 (reported by name)
                    out.append(type(exc).__name__)
            toks.append(out)
    finally:
        time.monotonic = real
        if eng._lead:
            eng.close()
    return dict(tokens=toks, passes=passes_out, steps=steps)


def _comm_staged():
    from deepspeed_tpu_torch.comm import HOST_STAGED

    return HOST_STAGED


def _stp_run(cfg, model, kv, tp, passes=1, **knobs):
    """One engine's passes: rank 0's tokens and metrics, this rank's serving
    kernel launches (counts set to 0 just before), pool bytes and prefix
    stats."""
    import deepspeed_tpu_torch as dt

    eng = _stp_engine(model, cfg, kv, tp, **knobs)
    dt.kernels.reset_launch_counts()
    out = _stp_serve(eng, passes)
    counts = dt.kernels.launch_counts()
    out.update(launches={k: counts[k] for k in SERVING_KERNELS}, pool_bytes=eng.pool.nbytes(),
               pool_heads=eng.pool.n_heads, prefix=eng.prefix_stats(),
               impls=[eng._impl_for_len(len(p)) for p in _prompts()])
    del eng
    return out


def _stp_worker(rank, world, root):
    """A rank of phase 17: (a) fp32 at 6 layers, plain, chunked with the
    prefix cache (2 passes), a planted fault (the row-parallel reduce
    skipped) and rank 0's clock jumping past a deadline; (d) GPT-2 XL's 25
    heads; (c) bf16 at 36 layers, a short warm-up and a timed pass."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch import comm

    torch.use_deterministic_algorithms(False)
    out, secs = {}, {}
    t0 = time.perf_counter()
    cfg, model = _stp_model(STP_LAYERS, torch.float32)
    out["plain"] = _stp_run(cfg, model, "fp32", True)
    out["chunked_prefix"] = _stp_run(cfg, model, "fp32", True, passes=2,
                                     prefill_chunk_tokens=CHUNK, prefix_cache_mb=STP_PREFIX_MB)
    del model
    cfg, model = _stp_model(STP_LAYERS, torch.float32)
    saved = comm.reduce_from_model_region
    comm.reduce_from_model_region = lambda x, group: x     # planted: no row reduce
    try:
        out["planted_no_row_reduce"] = _stp_run(cfg, model, "fp32", True)
    finally:
        comm.reduce_from_model_region = saved
    del model
    cfg, model = _stp_model(STP_LAYERS, torch.float32)
    d = STP_DEADLINE
    eng = _stp_engine(model, cfg, "fp32", True)
    out["deadline"] = _stp_serve(eng, prompts=_prompts()[:d["prompts"]], new=d["new"],
                                 timeout_s=d["timeout_s"],
                                 clock_jump=(d["jump_after"], d["jump_s"]))
    del eng, model
    secs["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    xl = dt.GPT2Config.gpt2_xl(num_hidden_layers=1)
    try:
        _stp_engine(dt.init_gpt2(xl, seed=0, device=TP_DEVICE), xl, "bf16", True)
        out["xl_heads"] = None
    except ValueError as exc:
        out["xl_heads"] = str(exc)
    gc.collect()
    torch.cuda.empty_cache() if TP_DEVICE == "cuda" else None
    cfg, model = _stp_model(STP_TIMED_LAYERS, torch.bfloat16)
    eng = _stp_engine(model, cfg, "bf16", True)
    torch.cuda.reset_peak_memory_stats() if TP_DEVICE == "cuda" else None
    dt.kernels.reset_launch_counts()
    out["timed"] = _stp_serve(eng, warmup=True)
    counts = dt.kernels.launch_counts()
    out["timed"].update(
        launches={k: counts[k] for k in SERVING_KERNELS}, pool_bytes=eng.pool.nbytes(),
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 2**30 if TP_DEVICE == "cuda"
                     else None))
    del eng, model
    secs["c"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def _stp_tp1(root):
    """The parent's side of (a) and (c): TP 1 served, the oracles from
    ``generate()``, and TP 1's pool bytes."""
    import deepspeed_tpu_torch as dt

    torch.use_deterministic_algorithms(False)
    cfg, model = _stp_model(STP_LAYERS, torch.float32)
    res = dict(plain=_stp_run(cfg, model, "fp32", False),
               chunked_prefix=_stp_run(cfg, model, "fp32", False, passes=2,
                                       prefill_chunk_tokens=CHUNK,
                                       prefix_cache_mb=STP_PREFIX_MB))
    impls = res["plain"]["impls"]
    res["generate"] = [dt.generate(model, cfg, [p], NEW_TOKENS, attn_impl=impl,
                                   kv_page_tokens=PT, device=TP_DEVICE)[0].tolist()
                       for p, impl in zip(_prompts(), impls)]
    tcfg, tmodel = _stp_model(STP_TIMED_LAYERS, torch.bfloat16)
    res["timed"] = _stp_run(tcfg, tmodel, "bf16", False)
    del tmodel
    return res, cfg, model


def _stp_margin_check(model, cfg, label, got, want, impls):
    """Phase 4's rule: each request equal to ``want`` or diverging first at
    a step whose top-2 logit margin (one-shot path) is below STP_MARGIN."""
    rows = []
    for prompt, out, ref, impl in zip(_prompts(), got, want, impls):
        row = dict(prompt_len=len(prompt), impl=impl, equal=out == ref)
        if out != ref:
            if not isinstance(out, list) or len(out) != len(ref):
                raise RuntimeError(f"serve_tp {label}: request failed or short: {out}")
            first = next(i for i, (a, b) in enumerate(zip(out, ref)) if a != b)
            _, margins = _margins(model, cfg, prompt, impl)
            row.update(first_divergence=first, top2_margin=margins[first])
            if margins[first] >= STP_MARGIN:
                raise RuntimeError(f"serve_tp {label}: diverges at step {first} with "
                                   f"top-2 margin {margins[first]:.3e}: {row}")
        rows.append(row)
    return rows


def _stp_kernel_cases(timer):
    """(b): the decode and band kernels at a rank's 10 heads, the shapes of
    (a): decode C = 1, 5, 256, band N = 8, 40, fp32 and bf16."""
    global NH
    saved = NH
    NH = STP_HEADS
    try:
        decode = [_report("serve_tp_case", decode_case(timer, C, kv)) for C in (1, SPEC_K + 1,
                                                                                 CHUNK)
                  for kv in ("fp32", "bf16")]
        band = [_report("serve_tp_case", band_case(timer, N, dt)) for N in (8, B * (SPEC_K + 1))
                for dt in ("fp32", "bf16")]
    finally:
        NH = saved
    return dict(heads=STP_HEADS, decode=decode, band=band)


def phase_serve_tp(timer):
    """Phase 17: the ranks start up while the parent runs TP 1, the oracles
    and (b); then they run (a), (d) and (c)."""
    import tempfile

    import deepspeed_tpu_torch as dt

    os.makedirs("build", exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.abspath("build"), prefix="serve_tp_") as root:
        t0 = time.perf_counter()
        store = _par_store()
        ctx = _par_start(2, _stp_worker, root, store.port, gate="go_stp")
        try:
            tp1, cfg, model = _stp_tp1(root)
            kcases = _stp_kernel_cases(timer)
            parent_s = time.perf_counter() - t0
            gc.collect()
            torch.cuda.empty_cache() if TP_DEVICE == "cuda" else None
            t0 = time.perf_counter()
            store.set("go_stp", "1")
            ranks = _par_join(ctx, 2, root)
            ranks_s = time.perf_counter() - t0
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            del store
    r0, r1 = ranks
    impls = tp1["plain"]["impls"]
    checks = {}
    for name in ("plain", "chunked_prefix"):
        for i, toks in enumerate(r0[name]["tokens"]):
            checks[f"a_{name}_pass{i}_vs_generate"] = _stp_margin_check(
                model, cfg, f"{name} pass {i} vs generate()", toks, tp1["generate"], impls)
            checks[f"a_{name}_pass{i}_vs_tp1"] = _stp_margin_check(
                model, cfg, f"{name} pass {i} vs TP 1", toks, tp1[name]["tokens"][i], impls)
    del model
    gc.collect()
    failures = []
    for name in ("plain", "chunked_prefix", "timed"):
        la, lb = r0[name]["launches"], r1[name]["launches"]
        if TP_DEVICE == "cuda" and (min(la.values()) <= 0 or la != lb):
            failures.append(f"{name}: serving kernel launches rank 0 {la}, rank 1 {lb}")
    for name in ("plain", "timed"):
        if 2 * r0[name]["pool_bytes"] != tp1[name]["pool_bytes"]:
            failures.append(f"{name}: a rank's pool {r0[name]['pool_bytes']} B is not half of "
                            f"TP 1's {tp1[name]['pool_bytes']} B")
    if r0["plain"]["pool_heads"] != cfg.num_attention_heads // 2:
        failures.append(f"a rank's pool holds {r0['plain']['pool_heads']} heads")
    hits = r0["chunked_prefix"]["prefix"]["hits"]
    if hits < len(PROMPT_LENS) or r0["chunked_prefix"]["prefix"] != r1["chunked_prefix"]["prefix"]:
        failures.append(f"the second pass hit the prefix cache {hits} times, ranks "
                        f"{r0['chunked_prefix']['prefix']} / {r1['chunked_prefix']['prefix']}")
    sound = r0["plain"]["tokens"][0]
    planted = r0["planted_no_row_reduce"]["tokens"][0]
    planted_equal = sum(a == b for a, b in zip(planted, sound))
    if planted_equal == len(sound):
        failures.append("the planted fault (no row-parallel reduce) served the sound tokens")
    dl0, dl1 = r0["deadline"], r1["deadline"]
    timed_out_at = [s for s, t, _ in dl0["steps"] if t >= 1]
    if dl0["steps"] != dl1["steps"] or not timed_out_at or \
            dl0["tokens"][0][1] != "RequestTimeoutError":
        failures.append(f"the deadline on rank 0's clock: rank 0 {dl0['steps']} "
                        f"{dl0['tokens']}, rank 1 {dl1['steps']}")
    want_msg = (f"serving.mesh_shape model axis 2 must divide num_attention_heads="
                f"{dt.GPT2Config.gpt2_xl().num_attention_heads} (the KV pool shards heads)")
    if r0["xl_heads"] != want_msg or r1["xl_heads"] != want_msg:
        failures.append(f"GPT-2 XL at TP 2: {r0['xl_heads']!r}, want {want_msg!r}")
    for t in r0["timed"]["tokens"]:
        for out in t:
            if not isinstance(out, list) or len(out) != NEW_TOKENS:
                failures.append(f"timed pass: a bad output {out}")
    if failures:
        raise RuntimeError("serve_tp: " + "; ".join(failures))
    tp1_bf16 = tp1["timed"]["tokens"][0]
    timed = r0["timed"]["tokens"][0]
    same = sum(a == b for x, y in zip(timed, tp1_bf16) for a, b in zip(x, y))
    return dict(
        model=f"gpt2_large (hidden 1280, 20 heads of 64), seed 0; (a) {STP_LAYERS} of 36 "
              f"layers fp32, (c) {STP_TIMED_LAYERS} layers bf16; mesh (1, 2) as two gloo "
              "rank processes on the one card, 8 slots, max_seq_len 1024",
        note="gloo on one card: the row-parallel reduces and the token broadcasts stage "
             "CUDA tensors through host memory; no time here is NCCL's",
        checks=checks, kernels=kcases,
        launches=dict(plain=[r["plain"]["launches"] for r in ranks],
                      chunked_prefix=[r["chunked_prefix"]["launches"] for r in ranks],
                      timed=[r["timed"]["launches"] for r in ranks]),
        pool_bytes=dict(tp1=tp1["plain"]["pool_bytes"], rank=r0["plain"]["pool_bytes"],
                        tp1_bf16_36=tp1["timed"]["pool_bytes"],
                        rank_bf16_36=r0["timed"]["pool_bytes"]),
        prefix=r0["chunked_prefix"]["prefix"],
        planted_no_row_reduce_tokens_equal=f"{planted_equal}/{len(sound)}",
        deadline=dict(steps=dl0["steps"], timed_out_at_step=timed_out_at[0],
                      tokens=dl0["tokens"][0], **STP_DEADLINE),
        xl_heads=r0["xl_heads"],
        timed=dict(passes=r0["timed"]["passes"], tp1_pass=tp1["timed"]["passes"][0],
                   peak_mem_gb_per_rank=[r["timed"]["peak_mem_gb"] for r in ranks],
                   tokens_equal_tp1_bf16=same / (len(PROMPT_LENS) * NEW_TOKENS)),
        a_passes=dict(plain=r0["plain"]["passes"], chunked_prefix=r0["chunked_prefix"]["passes"],
                      tp1_plain=tp1["plain"]["passes"]),
        seconds=dict(parent=parent_s, ranks_after_gate=ranks_s, rank=[r["seconds"] for r in ranks]))


# -- phase 15 (d): ZeRO and tensor parallelism under the pipeline -----------
# GPT-2 large's width (GPT-2 XL's 25 heads do not split in two: the port's
# Megatron layers hold whole heads, and phase 17 d checks that refusal), 2
# of 36 blocks as 2 stages, fp32 under deterministic algorithms: one
# process (the parent) against TP 2 (2 rank processes, dropout 0.1) and
# data 2 x TP 2 with ZeRO-1 and ZeRO-2 (4 rank processes, dropout 0: a data
# rank's rows draw other dropout bits than the whole batch's); then bf16 at
# 12 blocks as 4 stages at TP 2, timed. The ranks talk over gloo on the one
# card (phase 16's machinery).

PTP_LAYERS, PTP_STAGES, PTP_MICRO_BATCHES, PTP_STEPS = 2, 2, 2, 2
PTP_TIMED_LAYERS, PTP_TIMED_STAGES = 12, 4
PTP_WARMUP, PTP_TIMED_STEPS = 1, 1          # a bf16 step takes 8-10 s over gloo
PTP_TIMED_MICRO_BATCHES = 4


def _ptp_engine(layers, stages, dtype_name, micro_batches, dropout, extra=None):
    """A GPT-2 XL pipeline through ``initialize()`` with ``extra`` config
    (the mesh, ZeRO), the micro-batch split over the data ranks."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.models.gpt2_pipe import build_gpt2_pipeline
    from deepspeed_tpu_torch.runtime.config_utils import resolve_tp_size

    extra = dict(extra or {})
    world = torch.distributed.get_world_size() if torch.distributed.is_initialized() else 1
    dp = world // resolve_tp_size(extra)
    cfg = dt.GPT2Config.gpt2_large(num_hidden_layers=layers, hidden_dropout_prob=dropout,
                                   attention_probs_dropout_prob=dropout)
    module = build_gpt2_pipeline(cfg, num_stages=stages, partition_method="parameters",
                                 base_seed=1234)
    ds = {"train_batch_size": PIPE_MICRO * micro_batches,
          "train_micro_batch_size_per_gpu": PIPE_MICRO // dp,
          "gradient_accumulation_steps": micro_batches, "steps_per_print": 1000,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-4}}, **extra}
    if dtype_name == "bf16":
        ds["bf16"] = {"enabled": True}
    engine, _, _, _ = dt.initialize(model=module, config_params=ds, device=TP_DEVICE)
    return engine


def _ptp_rows(engine, data):
    """This data rank's rows of every global micro-batch."""
    from deepspeed_tpu_torch.parallel.mesh import DATA_AXIS

    dp, r = engine.dp_world_size, engine.mesh.rank(DATA_AXIS)
    n = PIPE_MICRO // dp
    return [(x[r * n:(r + 1) * n].to(TP_DEVICE), y[r * n:(r + 1) * n].to(TP_DEVICE))
            for x, y in data]


def _ptp_tap(engine):
    """Keeps the first step's gradients as each rank steps them (per stage:
    the reduced accumulators, or under ZeRO the reduced parts), on the
    host; and, under ZeRO, the planted fault's: the part each data rank
    would step if the reduce dropped the other rank's half."""
    from deepspeed_tpu_torch.parallel.tp import local_part

    keep = {}
    update = engine._update
    zero = engine._zero

    def tap():
        if "first" not in keep:
            if zero is None:
                keep["first"] = [[_par_copy(a) for a in acc] for acc in engine._acc]
            else:
                keep["planted"] = [[] if z is None else [
                    _par_copy((a if d is None else local_part(a, d, z.dp_rank, z.dp)) / z.dp)
                    for a, d in zip(z.acc_grads, z.dims)] for z in zero]
                got = []
                for z in zero:
                    if z is None:
                        got.append(None)
                        continue
                    reduce = z.reduce_gradients

                    def once(reduce=reduce, slot=len(got)):
                        g = reduce()
                        keep.setdefault("first", [None] * len(zero))[slot] = \
                            [_par_copy(t) for t in g]
                        return g
                    z.reduce_gradients = once
                    got.append(reduce)
                update()
                for z, reduce in zip(zero, got):
                    if z is not None:
                        z.reduce_gradients = reduce
                keep["first"] = [[] if f is None else f for f in keep["first"]]
                return
        update()

    engine._update = tap
    return keep


def _ptp_grad_err(engine, got, want):
    """Largest over the tensors of max |got - want| / max |want|: ``got`` a
    rank's first-step gradients by stage, ``want`` the one-process run's
    whole ones by name, cut to the same model and data part."""
    from deepspeed_tpu_torch.parallel.tp import local_part

    worst = 0.0
    for s, grads in enumerate(got):
        for i, (name, g) in enumerate(zip(engine._names[s], grads)):
            w = engine._tp_part(want[name], s, i)
            if engine._zero is not None and engine._zero[s].dims[i] is not None:
                z = engine._zero[s]
                w = local_part(w, z.dims[i], z.dp_rank, z.dp)
            worst = max(worst, float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30))
    return worst


def _ptp_reference(root, name, dropout):
    """The one-process run (the parent): losses, whole masters after the
    steps, the first step's gradients, on file for the ranks; and the
    masters' largest move (a tag of the initial weights reads that)."""
    data = _pipe_batches(PTP_MICRO_BATCHES, seed=21)
    engine = _ptp_engine(PTP_LAYERS, PTP_STAGES, "fp32", PTP_MICRO_BATCHES, dropout)
    init = _par_host(engine.master_params())
    tap = _ptp_tap(engine)
    losses = [engine.train_batch(iter(_ptp_rows(engine, data))) for _ in range(PTP_STEPS)]
    masters = _par_host(engine.master_params())
    grads = {n: g for names, gs in zip(engine._names, tap["first"]) for n, g in zip(names, gs)}
    torch.save(dict(losses=losses, masters=masters, grads=grads),
               os.path.join(root, f"{name}.pt"))
    moved = _par_max_diff(masters, init)
    moved_share = _par_flips(init, masters)[0]
    del engine, tap, grads, init
    gc.collect()
    return dict(losses=losses, moved=moved, moved_share=moved_share)


def _ptp_equal_run(rank, root, label, want_name, extra, dropout, planted=None, tag=None):
    """One mesh run against the one-process run ``want_name``: its checks'
    readings (and their planted faults')."""
    import deepspeed_tpu_torch as dt

    data = _pipe_batches(PTP_MICRO_BATCHES, seed=21)
    engine = _ptp_engine(PTP_LAYERS, PTP_STAGES, "fp32", PTP_MICRO_BATCHES, dropout, extra)
    types = sorted({type(m).__name__ for layer in engine.module.get_layers()
                    if isinstance(layer, torch.nn.Module) for m in layer.modules()})
    out = dict(label=label, mp=engine.mp_world_size, dp=engine.dp_world_size,
               megatron_layers="ColumnParallelLinear" in types and "Linear" not in types)
    rows = _ptp_rows(engine, data)
    if planted is not None:                 # the fault's gradients, no step taken
        with planted():
            g, _ = _pipe_barrier_grads(engine, rows)
        out["planted_grad"] = {k: _par_copy(v) for k, v in g.items()}
        del g
    tap = _ptp_tap(engine)
    dt.kernels.reset_launch_counts()
    losses = [engine.train_batch(iter(rows)) for _ in range(PTP_STEPS)]
    counts = dt.kernels.launch_counts()
    _PAR_STORE.wait([want_name])              # the parent's run, beside the ranks'
    want = torch.load(os.path.join(root, f"{want_name}.pt"))
    scale = float(engine.micro_batches)
    first = [[t / scale for t in s] for s in tap["first"]]
    wgrads = {k: v / scale for k, v in want["grads"].items()}
    out.update(losses=losses, want_losses=want["losses"],
               grad_rel=_ptp_grad_err(engine, first, wgrads),
               launches={k: counts[k] for k in FLASH_KERNELS},
               want_launches={k: v * PTP_STEPS for k, v in
                              _pipe_expected_launches(engine).items()})
    if "planted_grad" in out:
        pg = out.pop("planted_grad")
        out["planted_grad_rel"] = _ptp_grad_err(
            engine, [[pg[n] for n in names] for names in engine._names], wgrads)
    elif "planted" in tap:
        out["planted_grad_rel"] = _ptp_grad_err(
            engine, [[t / scale for t in s] for s in tap["planted"]], wgrads)
    masters = engine.master_params()
    out["master_flip_share"], out["master_max_abs_diff"] = _par_flips(masters, want["masters"])
    if tag is not None:
        from deepspeed_tpu_torch.utils.zero_to_fp32 import (
            get_fp32_state_dict_from_zero_checkpoint,
        )
        engine.save_checkpoint(tag, tag="t")
        if rank == 0:
            layers = get_fp32_state_dict_from_zero_checkpoint(tag, "t")["layers"]
            sd = {f"layer_{i:02d}.{k}": v for i, layer in enumerate(layers) if layer
                  for k, v in layer.items()}
            out["zero_to_fp32_abs"] = _par_max_diff(masters, sd)
            torch.save(_par_host(masters), os.path.join(root, "ptp_tag_masters.pt"))
    del engine, masters, want
    gc.collect()
    torch.cuda.empty_cache() if TP_DEVICE == "cuda" else None
    return out


def _ptp_timed(rank):
    """bf16 at 12 blocks as 4 stages, TP 2, dropout 0.1: a warm-up and a
    timed step; step ms, tokens/s, peak memory a rank, the flash launches
    a step against the schedule's count."""
    import deepspeed_tpu_torch as dt

    data = _pipe_batches(PTP_TIMED_MICRO_BATCHES, seed=12)
    engine = _ptp_engine(PTP_TIMED_LAYERS, PTP_TIMED_STAGES, "bf16", PTP_TIMED_MICRO_BATCHES,
                         PIPE_DROPOUT, {"tensor_parallel": {"size": 2}})
    rows = _ptp_rows(engine, data)
    losses = [engine.train_batch(iter(rows)) for _ in range(PTP_WARMUP)]
    torch.cuda.synchronize() if TP_DEVICE == "cuda" else None
    torch.cuda.reset_peak_memory_stats() if TP_DEVICE == "cuda" else None
    staged0 = dict(_comm_staged())
    dt.kernels.reset_launch_counts()
    t0 = time.perf_counter()
    losses += [engine.train_batch(iter(rows)) for _ in range(PTP_TIMED_STEPS)]
    torch.cuda.synchronize() if TP_DEVICE == "cuda" else None
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    staged = {k: (_comm_staged()[k] - staged0[k]) / PTP_TIMED_STEPS for k in staged0}
    res = dict(model=f"gpt2_large, {PTP_TIMED_LAYERS} blocks, {PTP_TIMED_STAGES} stages, bf16 + "
                     f"fp32 masters, Adam lr 1e-4, dropout {PIPE_DROPOUT}, TP 2",
               micro_batches=PTP_TIMED_MICRO_BATCHES, micro_batch=PIPE_MICRO, seq=PIPE_SEQ,
               step_ms=1e3 * wall / PTP_TIMED_STEPS,
               tokens_per_s=PIPE_MICRO * PTP_TIMED_MICRO_BATCHES * PIPE_SEQ * PTP_TIMED_STEPS
               / wall,
               peak_mem_gb=(torch.cuda.max_memory_allocated() / 2**30
                            if TP_DEVICE == "cuda" else None),
               losses=losses, launches_per_step={k: counts[k] / PTP_TIMED_STEPS
                                                 for k in FLASH_KERNELS},
               want_per_step=_pipe_expected_launches(engine),
               host_staged_per_step=staged)
    del engine
    gc.collect()
    return res


def _ptp_worker2(rank, world, root):
    """TP 2 (dropout 0.1) against the one-process run beside the world-4
    ranks' work, then, once they are done, the bf16 timed run."""
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    eq = _ptp_equal_run(rank, root, "TP 2", "ptp_drop", {"tensor_parallel": {"size": 2}},
                        PIPE_DROPOUT, planted=_NoModelReduce)
    torch.use_deterministic_algorithms(False)
    _PAR_STORE.wait([f"ptp_w4_done_{r}" for r in range(4)])
    t1 = time.perf_counter()
    timed = _ptp_timed(rank)
    return dict(equal=eq, timed=timed,
                seconds=dict(equal=t1 - t0, timed=time.perf_counter() - t1))


def _ptp_worker4(rank, world, root):
    """data 2 x TP 2 with ZeRO-1 (its tag saved) and ZeRO-2, dropout 0."""
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    mesh = {"tensor_parallel": {"size": 2}, "mesh": {"data_parallel_size": 2}}
    out = dict(
        zero1=_ptp_equal_run(rank, root, "dp 2 x TP 2 ZeRO-1", "ptp_nodrop",
                             dict(mesh, zero_optimization={"stage": 1}), 0.0,
                             tag=os.path.join(root, "ptp_tag")),
        zero2=_ptp_equal_run(rank, root, "dp 2 x TP 2 ZeRO-2", "ptp_nodrop",
                             dict(mesh, zero_optimization={"stage": 2}), 0.0))
    out["seconds"] = time.perf_counter() - t0
    _PAR_STORE.set(f"ptp_w4_done_{rank}", "1")
    return out


def _ptp_tp1_load(root):
    """The ZeRO-1 tag at one process without ZeRO: the loaded masters (and a
    fresh engine's, the reading of a load of nothing) against the tag's."""
    engine = _ptp_engine(PTP_LAYERS, PTP_STAGES, "fp32", PTP_MICRO_BATCHES, 0.0)
    tag = torch.load(os.path.join(root, "ptp_tag_masters.pt"))
    fresh = _par_max_diff(engine.master_params(), tag)
    engine.load_checkpoint(os.path.join(root, "ptp_tag"), tag="t")
    loaded = _par_max_diff(engine.master_params(), tag)
    del engine, tag
    gc.collect()
    return dict(loaded_abs=loaded, fresh_abs=fresh)


def _pipe_tp(root):
    """(d): the world-2 and world-4 ranks start together and run their
    checks side by side while the parent runs the one-process references
    (each rank waits for its reference's key before it reads it); the
    world-2 ranks time bf16 once the world-4 ranks are done; the parent
    loads the ZeRO-1 tag at last."""
    t0 = time.perf_counter()
    store = _par_store()
    ctx2 = _par_start(2, _ptp_worker2, root, store.port)
    ctx4 = _par_start(4, _ptp_worker4, root, store.port)
    try:
        torch.use_deterministic_algorithms(True)
        ref = {}
        for name, dropout in (("ptp_drop", PIPE_DROPOUT), ("ptp_nodrop", 0.0)):
            ref[name] = _ptp_reference(root, name, dropout)
            store.set(name, "1")
        torch.use_deterministic_algorithms(False)
        gc.collect()
        torch.cuda.empty_cache() if TP_DEVICE == "cuda" else None
        w4 = _par_join(ctx4, 4, root)
        w2 = _par_join(ctx2, 2, root)
    finally:
        for p in ctx2.processes + ctx4.processes:
            if p.is_alive():
                p.kill()
        del store
    torch.use_deterministic_algorithms(True)
    load = _ptp_tp1_load(root)
    torch.use_deterministic_algorithms(False)
    rel = lambda got, want: max(abs(g - w) / abs(w) for g, w in zip(got, want))
    checks = {}
    runs = [("tp2", [r["equal"] for r in w2], "ptp_drop"),
            ("zero1", [r["zero1"] for r in w4], "ptp_nodrop"),
            ("zero2", [r["zero2"] for r in w4], "ptp_nodrop")]
    for key, ranks, ref_name in runs:
        want = ref[ref_name]["losses"]
        dp = ranks[0]["dp"]
        losses = np.mean([ranks[r]["losses"] for r in range(0, len(ranks), 2)], axis=0) \
            if dp > 1 else ranks[0]["losses"]
        # planted: the reference's losses one step late
        checks[f"{key}_loss_rel"] = (rel(losses, want), PAR_TOL, rel(want[1:], want[:-1]))
        checks[f"{key}_grad_rel"] = (max(r["grad_rel"] for r in ranks), PAR_GRAD_TOL,
                                     max(r["planted_grad_rel"] for r in ranks))
        # planted: the initial weights, read against the reference's masters
        checks[f"{key}_master_flip_share"] = (max(r["master_flip_share"] for r in ranks),
                                              PAR_FLIP_SHARE, ref[ref_name]["moved_share"])
    checks["zero1_zero_to_fp32_abs"] = (w4[0]["zero1"]["zero_to_fp32_abs"], 0.0,
                                        ref["ptp_nodrop"]["moved"])
    checks["zero1_tag_at_one_process_abs"] = (load["loaded_abs"], 0.0, load["fresh_abs"])
    print("pipe_tp_checks", json.dumps(checks), flush=True)
    failures = [f"{k}: {v}" for k, v in checks.items() if not v[0] <= v[1]]
    failures += [f"{k} is blind to its planted fault: {v}" for k, v in checks.items()
                 if v[2] is not None and not v[2] > v[1]]
    for key, ranks, _ in runs:
        for r in ranks:
            if not r["megatron_layers"]:
                failures.append(f"{key}: stage layers are not Megatron layers")
            if TP_DEVICE == "cuda" and r["launches"] != r["want_launches"]:
                failures.append(f"{key}: flash launches {r['launches']}, the schedule's "
                                f"{r['want_launches']}")
    timed = [r["timed"] for r in w2]
    for t in timed:
        if TP_DEVICE == "cuda" and t["launches_per_step"] != t["want_per_step"]:
            failures.append(f"timed: flash launches a step {t['launches_per_step']}, the "
                            f"schedule's {t['want_per_step']}")
        if not all(np.isfinite(t["losses"])):
            failures.append(f"timed: a loss is not finite: {t['losses']}")
    if failures:
        raise RuntimeError("pipe (d): " + "; ".join(failures))
    return dict(
        model=f"gpt2_large width, {PTP_LAYERS} of 36 blocks, {PTP_STAGES} stages, fp32, "
              f"{PTP_MICRO_BATCHES} micro-batches of {PIPE_MICRO}, Adam lr 1e-4, "
              f"{PTP_STEPS} steps; TP 2 at dropout {PIPE_DROPOUT}, dp 2 x TP 2 at dropout 0",
        note="gloo on one card: collectives stage CUDA tensors through host memory",
        checks={k: dict(reading=v[0], bound=v[1], planted=v[2]) for k, v in checks.items()},
        reference_losses={k: v["losses"] for k, v in ref.items()},
        losses={key: [r["losses"] for r in ranks] for key, ranks, _ in runs},
        launches={key: ranks[0]["launches"] for key, ranks, _ in runs},
        timed=timed, seconds=dict(w2=[r["seconds"] for r in w2],
                                  w4=[r["seconds"] for r in w4],
                                  phase=time.perf_counter() - t0))


# -- phase 16 (g): an expert-parallel MoELayer under initialize() -----------
PAR_MOE_ENGINE = dict(batch=8, seq=512, steps=3, lr=1e-4)


class _MoENet(torch.nn.Module):
    """Dense(d -> d), a Switch-Base-8-width MoELayer (8 experts, d 768, f
    3072) and Dense(d -> d), MSE; capacity 8 x the even share (no token
    drops on any rank) and no aux loss (a rank's aux averaged over the ranks
    is not the whole batch's). Weights from torch.manual_seed(0) on the CPU,
    alike in every process."""

    def __init__(self):
        from deepspeed_tpu_torch.parallel.expert import MoEConfig, MoELayer

        super().__init__()
        m = PAR_MOE
        torch.manual_seed(0)
        self.inp = torch.nn.Linear(m["d_model"], m["d_model"])
        self.moe = MoELayer(MoEConfig(num_experts=m["experts"], d_model=m["d_model"],
                                      d_ff=m["d_ff"], capacity_factor=float(m["experts"])))
        self.out = torch.nn.Linear(m["d_model"], m["d_model"])

    def forward(self, x, y):
        h, _ = self.moe(self.inp(x))
        return ((self.out(h) - y) ** 2).mean()


def _par_moe_engine_run(world=1, rank=0, planted=False):
    """3 Adam steps of ``_MoENet`` through ``initialize()`` on this rank's
    rows of one global batch, the experts split over the world when it has
    more than one rank. ``planted``: the expert gradients averaged over the
    data group like every other (the fault the engine must not make).
    Returns the losses and the whole masters on the host."""
    import deepspeed_tpu_torch as dt

    e = PAR_MOE_ENGINE
    g = torch.Generator().manual_seed(5)
    x = torch.randn(e["batch"], e["seq"], PAR_MOE["d_model"], generator=g)
    y = torch.randn(e["batch"], e["seq"], PAR_MOE["d_model"], generator=g)
    rows = e["batch"] // world
    model = _MoENet()
    if world > 1:
        model.moe.shard_experts(torch.distributed.group.WORLD)
    engine, _, _, _ = dt.initialize(model=model, config={
        "train_batch_size": e["batch"], "train_micro_batch_size_per_gpu": rows,
        "steps_per_print": 1000, "optimizer": {"type": "Adam", "params": {"lr": e["lr"]}}},
        device=PAR_DEVICE)
    if planted:
        engine._step_optimizer.experts = {}
    xs = x[rank * rows:(rank + 1) * rows].to(PAR_DEVICE)
    ys = y[rank * rows:(rank + 1) * rows].to(PAR_DEVICE)
    losses = []
    for _ in range(e["steps"]):
        loss = engine(xs, ys)
        engine.backward(loss)
        engine.step()
        losses.append(float(loss))
    if planted:           # whole masters need the expert group's gather back
        engine._step_optimizer.experts = {
            i: model.moe.group for i, n in enumerate(engine._param_names)
            if n.startswith("moe.") and n != "moe.router"}
    masters = _par_host(engine.master_params())
    del engine, model
    gc.collect()
    return dict(losses=losses, masters=masters)


def _par_moe_engine(rank, world):
    """(g) at dp 2: the sound run and the planted one."""
    t0 = time.perf_counter()
    sound = _par_moe_engine_run(world, rank)
    planted = _par_moe_engine_run(world, rank, planted=True)
    return dict(losses=sound["losses"], masters=sound["masters"] if rank == 0 else None,
                planted_losses=planted["losses"],
                planted_masters=planted["masters"] if rank == 0 else None,
                seconds=time.perf_counter() - t0)


# -- phase 18 (remat): activation checkpointing and the monitors ------------
REMAT_BITS_LAYERS, REMAT_BITS_BATCH = 2, 8
REMAT_WARMUP, REMAT_STEPS = 3, 5
REMAT_MON_LAYERS, REMAT_MON_STEPS, REMAT_MON_TIMED = 2, 4, 10
REMAT_SETTINGS = ("none", "nothing", "dots", "offload_dots")


def _remat_engine(setting, layers, dtype_name, batch, extra=None, seed=0):
    """BERT-large at ``layers`` of its 24 layers through ``initialize()``:
    activation checkpointing off ("none"), or on with the model's
    ``checkpoint_policy`` "nothing" / "dots", or "dots" switched to
    "offload_dots" by the config's ``cpu_checkpointing``."""
    import deepspeed_tpu_torch as dt

    policy = "dots" if setting == "offload_dots" else \
        ("nothing" if setting == "none" else setting)
    cfg = dt.BertConfig.bert_large(num_hidden_layers=layers, checkpoint_policy=policy)
    model = dt.init_bert(cfg, seed=seed, device="cuda")
    ds = {"train_batch_size": batch, "train_micro_batch_size_per_gpu": batch,
          "gradient_accumulation_steps": 1,
          "optimizer": {"type": "Adam", "params": {"lr": 1e-4}},
          "zero_optimization": {"stage": 0}, "steps_per_print": 1000}
    if dtype_name == "bf16":
        ds["bf16"] = {"enabled": True}
    if setting != "none":
        ds["activation_checkpointing"] = {"enabled": True,
                                          "cpu_checkpointing": setting == "offload_dots"}
    ds.update(extra or {})
    engine, _, _, _ = dt.initialize(model=model, config=ds)
    if cfg.checkpoint_activations != (setting != "none") or \
            (setting != "none" and cfg.checkpoint_policy != setting):
        raise RuntimeError(f"{setting}: the engine left the model at checkpoint_activations="
                           f"{cfg.checkpoint_activations}, policy {cfg.checkpoint_policy}")
    return engine, cfg


def _rel_diff(got, want):
    """(the largest |got - want| over each tensor's largest |want|, all
    tensors equal bit for bit)."""
    worst, equal = 0.0, True
    for g, w in zip(got, want):
        equal = equal and torch.equal(g, w)
        worst = max(worst, float((g.float() - w.float()).abs().max())
                    / max(float(w.float().abs().max()), 1e-30))
    return worst, equal


def _remat_bits():
    """(a): one step's reduced gradients at BERT-large width, 2 layers,
    fp32, dropout 0.1, deterministic algorithms, under the four settings,
    each from the same weights and dropout seed; the planted faults (a
    zeroed host copy, a fork inside the checkpointed region) must read
    above the bound."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ckpt

    torch.use_deterministic_algorithms(True)
    try:
        grads = {}
        cfg = None
        for setting in REMAT_SETTINGS + ("planted_zeroed_host_copy",):
            planted = setting.startswith("planted")
            engine, cfg = _remat_engine("offload_dots" if planted else setting,
                                        REMAT_BITS_LAYERS, "fp32", REMAT_BITS_BATCH)
            batch = _bert_batch(cfg, REMAT_BITS_BATCH, FS, seed=2)
            real = ckpt._to_host
            if planted:
                def zeroed(t):
                    host, done, device = real(t)
                    if done is not None:
                        torch.cuda.current_stream(device).wait_event(done)
                    return torch.zeros_like(host), done, device
                ckpt._to_host = zeroed
            ckpt.reset_offload_stats()
            try:
                loss = engine(*batch)
                engine.backward(loss)
            finally:
                ckpt._to_host = real
            torch.cuda.synchronize()
            grads[setting] = dict(loss=loss.detach().clone(), stats=ckpt.offload_stats(),
                                  grads=[g.detach().clone() for g in
                                         engine.allreduce_gradients()])
            if setting == "none":
                layer = engine.module.bert.encoder.layers[0]
            del engine
        want = grads["none"]
        checks = {}
        for setting in REMAT_SETTINGS[1:]:
            rel, equal = _rel_diff(grads[setting]["grads"], want["grads"])
            checks[f"{setting}_vs_none_grad_rel"] = dict(
                reading=rel, equal=equal, bound=GRAD_TOL["fp32"],
                loss_equal=torch.equal(grads[setting]["loss"], want["loss"]))
        planted_rel, _ = _rel_diff(grads["planted_zeroed_host_copy"]["grads"], want["grads"])
        checks["offload_dots_vs_none_grad_rel"]["planted"] = planted_rel
        rel, equal = _rel_diff(grads["offload_dots"]["grads"], grads["dots"]["grads"])
        checks["offload_dots_vs_dots_grad_rel"] = dict(reading=rel, equal=equal,
                                                       bound=GRAD_TOL["fp32"],
                                                       planted=planted_rel)
        stats = grads["offload_dots"]["stats"]
        # a Megatron-style call: checkpoint() over one layer whose dropout
        # seed the tracker forked before the call, against the same call
        # without checkpointing; planted: the fork inside the region
        tracker = ckpt.get_cuda_rng_tracker()
        ckpt.model_parallel_cuda_manual_seed(1234)
        gen = torch.Generator(device="cuda").manual_seed(9)
        h0 = torch.randn(REMAT_BITS_BATCH, FS, cfg.hidden_size, device="cuda", generator=gen)
        r = torch.randn(h0.shape, device="cuda", generator=gen)
        mask = torch.zeros(REMAT_BITS_BATCH, 1, 1, FS, device="cuda")
        start = tracker.get_states()

        def layer_grads(how, cpu):
            ckpt.configure(None, checkpoint_in_cpu=cpu)
            tracker.set_states(start)
            layer.zero_grad(set_to_none=True)
            h = h0.clone().requires_grad_()
            if how == "plain":
                out = layer(h, mask, False, tracker.fork())
            elif how == "checkpoint":
                out = ckpt.checkpoint(layer, h, mask, False, tracker.fork())
            else:
                out = ckpt.checkpoint(lambda x: layer(x, mask, False, tracker.fork()), h)
            (out * r).sum().backward()
            return [h.grad] + [p.grad.clone() for p in layer.parameters()]

        for cpu in (False, True):
            ref = layer_grads("plain", cpu)
            rel, equal = _rel_diff(layer_grads("checkpoint", cpu), ref)
            planted, _ = _rel_diff(layer_grads("planted", cpu), ref)
            checks[f"megatron_checkpoint{'_cpu' if cpu else ''}_grad_rel"] = dict(
                reading=rel, equal=equal, bound=GRAD_TOL["fp32"], planted=planted)
        ckpt.configure(None, checkpoint_in_cpu=False)
    finally:
        torch.use_deterministic_algorithms(False)
    print("remat_checks", json.dumps(checks), flush=True)
    failures = [f"{k}: {v}" for k, v in checks.items()
                if not (v["equal"] or v["reading"] <= v["bound"])]
    failures += [f"{k} is blind to its planted fault: {v}" for k, v in checks.items()
                 if "planted" in v and not v["planted"] > v["bound"]]
    if stats["saved"] != 4 * REMAT_BITS_LAYERS or stats["restored"] != stats["saved"]:
        failures.append(f"offload_dots saved / restored {stats} matmul outputs, not "
                        f"{4 * REMAT_BITS_LAYERS}")
    if failures:
        raise RuntimeError("remat (a): " + "; ".join(failures))
    return dict(model=f"bert_large width, {REMAT_BITS_LAYERS} layers, fp32, dropout 0.1, "
                      f"batch {REMAT_BITS_BATCH} x {FS}, deterministic algorithms",
                checks=checks, offload_stats=stats,
                losses={k: float(v["loss"]) for k, v in grads.items()})


def _remat_cost(setting):
    """(b): phase 6's bf16 Adam BERT-large (24 layers, 64 x 128) under
    ``setting``: step ms, peak memory, the offload's bytes and the flash
    launches a step, the losses."""
    import deepspeed_tpu_torch as dt
    from deepspeed_tpu_torch.runtime.activation_checkpointing import checkpointing as ckpt

    engine, cfg = _remat_engine(setting, 24, "bf16", FB)
    batch = _bert_batch(cfg, FB, FS)
    losses = [float(engine.train_step([batch])) for _ in range(REMAT_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dt.kernels.reset_launch_counts()
    ckpt.reset_offload_stats()
    t0 = time.perf_counter()
    timed = [engine.train_step([batch]) for _ in range(REMAT_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dt.kernels.launch_counts()
    stats = ckpt.offload_stats()
    peak = torch.cuda.max_memory_allocated()
    losses += [float(x) for x in timed]
    # report only, one more step through the three-call API: the peak up to
    # the forward's end, and how long the side stream's D2H copies run past
    # the forward's last kernel
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss = engine(*batch)
    torch.cuda.current_stream().synchronize()
    t_fwd = time.perf_counter()
    copies = ckpt._COPY_STREAMS.get(torch.cuda.current_device())
    if copies is not None:
        copies.synchronize()
    backlog_ms = 1e3 * (time.perf_counter() - t_fwd)
    fwd_peak = torch.cuda.max_memory_allocated()
    engine.backward(loss)
    engine.step()
    del engine, timed, loss
    gc.collect()
    torch.cuda.empty_cache()
    return dict(step_ms=1e3 * wall / REMAT_STEPS, peak_mem_bytes=peak, peak_mem_gb=peak / 2**30,
                forward_peak_gb=fwd_peak / 2**30, d2h_backlog_after_forward_ms=backlog_ms,
                d2h_bytes_per_step=stats["d2h_bytes"] / REMAT_STEPS,
                h2d_bytes_per_step=stats["h2d_bytes"] / REMAT_STEPS,
                saved_per_step=stats["saved"] / REMAT_STEPS,
                launches={k: counts[k] for k in FLASH_KERNELS},
                launches_per_step={k: counts[k] / REMAT_STEPS for k in FLASH_KERNELS},
                losses=losses)


def _pinned_copy_gbps(nbytes=1 << 30):
    """(b), report only: the rate of one pinned D2H and one H2D copy of
    ``nbytes`` on this machine (CUDA events, median of 3)."""
    dev = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    out = {}
    for name, dst, src in (("d2h", host, dev), ("h2d", dev, host)):
        times = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            dst.copy_(src, non_blocking=True)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = nbytes / (statistics.median(times) * 1e-3) / 1e9
    del dev, host
    return out


def _remat_monitors(root):
    """(c): 2-layer bf16 BERT-large width with tensorboard + csv_monitor
    (steps_per_print 2): 4 steps, the first and third under
    ``set_sync_debug_mode("error")``, the files read back; the same with
    ``wall_clock_breakdown``; step ms with the monitors armed and disarmed
    (flushes included), each after 2 warm-up steps."""
    from deepspeed_tpu_torch.monitor import read_events

    def monitors(out, **kw):
        return dict({"steps_per_print": 2,
                     "tensorboard": {"enabled": True, "output_path": out, "job_name": "job"},
                     "csv_monitor": {"enabled": True, "output_path": out, "job_name": "job"}},
                    **kw)

    def timed(extra):
        engine, cfg = _remat_engine("dots", REMAT_MON_LAYERS, "bf16", FB, extra)
        batch = _bert_batch(cfg, FB, FS)
        for _ in range(2):
            engine.train_step([batch])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(REMAT_MON_TIMED):
            engine.train_step([batch])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / REMAT_MON_TIMED
        engine.close()
        return ms

    step_ms = {"disarmed": timed({}), "armed": timed(monitors(os.path.join(root, "timed")))}
    step_ms["disarmed_again"] = timed({})

    def checked(out, **kw):
        engine, cfg = _remat_engine("dots", REMAT_MON_LAYERS, "bf16", FB, monitors(out, **kw))
        batch = _bert_batch(cfg, FB, FS)
        losses = []
        for step in range(1, REMAT_MON_STEPS + 1):
            flush = step % 2 == 0
            if not flush:
                torch.cuda.set_sync_debug_mode("error")
            try:
                losses.append(engine.train_step([batch]))
            finally:
                torch.cuda.set_sync_debug_mode(0)
        engine.close()
        files = [os.path.join(out, "job", f) for f in os.listdir(os.path.join(out, "job"))]
        events = {}
        for path in (f for f in files if "tfevents" in f):
            for _, step, tag, value in read_events(path):
                events.setdefault(tag, []).append((step, value))
        csv_rows = {os.path.basename(f)[:-4]: open(f).read().strip().splitlines()[1:]
                    for f in files if f.endswith(".csv")}
        return events, csv_rows, [float(x) for x in losses]

    events, csv_rows, losses = checked(os.path.join(root, "mon"))
    want_steps = [FB * k for k in range(1, REMAT_MON_STEPS + 1)]
    failures = []
    for tag in ("Train/Samples/train_loss", "Train/Samples/lr"):
        if [s for s, _ in events.get(tag, [])] != want_steps:
            failures.append(f"{tag} steps {[s for s, _ in events.get(tag, [])]}")
    if not np.allclose([v for _, v in events["Train/Samples/train_loss"]], losses, rtol=1e-6):
        failures.append(f"train_loss {events['Train/Samples/train_loss']} against {losses}")
    if set(csv_rows) != {t.replace("/", "_") for t in events} or \
            any(len(rows) != REMAT_MON_STEPS for rows in csv_rows.values()):
        failures.append(f"csv rows {{k: len(v) for k, v in csv_rows.items()}}")
    bd_events, _, _ = checked(os.path.join(root, "breakdown"), wall_clock_breakdown=True)
    for tag in ("Train/Samples/forward_microstep", "Train/Samples/backward_microstep"):
        got = bd_events.get(tag, [])
        if [s for s, _ in got] != want_steps or not all(v > 0 for _, v in got):
            failures.append(f"breakdown {tag}: {got}")
    if failures:
        raise RuntimeError("remat (c): " + "; ".join(failures))
    return dict(tags=sorted(events), steps=want_steps, csv_rows_per_tag=REMAT_MON_STEPS,
                losses=losses, breakdown_ms={t: [v for _, v in bd_events[t]] for t in bd_events
                                             if "microstep" in t},
                step_ms=step_ms, layers=REMAT_MON_LAYERS, timed_steps=REMAT_MON_TIMED,
                sync_debug="error on the non-flush steps 1 and 3")


def phase_remat():
    """Phase 18: (a) bits, (b) cost of offload_dots against dots at
    BERT-large, (c) the monitors."""
    import tempfile

    t0 = time.perf_counter()
    bits = _remat_bits()
    t1 = time.perf_counter()
    cost = {s: _remat_cost(s) for s in ("dots", "offload_dots")}
    pinned = _pinned_copy_gbps()
    t2 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir="build", prefix="remat_") as root:
        mon = _remat_monitors(root)
    t3 = time.perf_counter()
    failures = []
    for s, run in cost.items():
        if run["launches_per_step"] != {k: float(v) for k, v in FLASH_PER_STEP.items()}:
            failures.append(f"{s}: flash launches a step {run['launches_per_step']}")
        if not all(np.isfinite(run["losses"])) or not run["losses"][-1] < run["losses"][0]:
            failures.append(f"{s}: losses {run['losses']}")
    off, dots = cost["offload_dots"], cost["dots"]
    if not off["peak_mem_bytes"] < dots["peak_mem_bytes"]:
        failures.append(f"offload peak {off['peak_mem_gb']:.3f} GiB not below dots' "
                        f"{dots['peak_mem_gb']:.3f}")
    if off["saved_per_step"] != 4 * 24 or dots["saved_per_step"] != 0:
        failures.append(f"matmul outputs offloaded a step: offload {off['saved_per_step']}, "
                        f"dots {dots['saved_per_step']}")
    if failures:
        raise RuntimeError("remat (b): " + "; ".join(failures))
    return dict(bits=bits, cost=cost, monitors=mon, pinned_copy_gbps=pinned,
                peak_saved_gb=(dots["peak_mem_bytes"] - off["peak_mem_bytes"]) / 2**30,
                offload_step_ms_added=off["step_ms"] - dots["step_ms"],
                seconds=dict(a=t1 - t0, b=t2 - t1, c=t3 - t2))


# phase 19: the FLOPS profiler and the sentinels
PROFILE_STEP = 3          # the profiled step of (b), as global_steps counts it
PROFILE_STEPS = 5
SENTINEL_LAYERS = 6       # GPT-2 XL depth of (c), phase 12 bf16's
SENTINEL_BUDGET = 8       # programs a class may run: one prefill a prompt bucket


def _bert_counts(model, batch, seed):
    """(forward FLOPs, forward + backward FLOPs) of one microbatch under the
    counting mode."""
    from deepspeed_tpu_torch.profiling.flops_profiler import FlopsProfiler

    prof = FlopsProfiler()
    fwd = prof.analyze(lambda: model(*batch, dropout_seed=seed))
    both = prof.count_step(lambda: model(*batch, dropout_seed=seed),
                           lambda loss: loss.backward(), params=model)
    model.zero_grad(set_to_none=True)
    return fwd, both


def _bert_formula(cfg, tokens, seq, layers):
    """The forward's matmul FLOPs from the shapes: a layer's four projections
    (24 T h^2) and its attention's two products (4 T S h), the pooler, the
    MLM transform and its decoder over every token, the NSP head."""
    h, v, b = cfg.hidden_size, cfg.vocab_size, tokens // seq
    return (layers * (24 * tokens * h * h + 4 * tokens * seq * h)
            + 2 * b * h * h + 2 * tokens * h * h + 2 * tokens * h * v + 2 * b * h * 2)


def _profile_counts():
    """(a) the kernels' FLOP counts against their plain versions', at
    BERT-large width, 2 layers, bf16, 64 x 128."""
    import deepspeed_tpu_torch as dt

    cfg = dt.BertConfig.bert_large(num_hidden_layers=2)
    model = dt.init_bert(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    batch = _bert_batch(cfg, FB, FS, seed=2)
    before = dt.kernels.launch_counts()
    kern = _bert_counts(model, batch, 11)
    after = dt.kernels.launch_counts()
    with _PlainAttention():
        plain = _bert_counts(model, batch, 11)
    launched = {k: after[k] - before[k] for k in FLASH_KERNELS}
    del model
    torch.cuda.empty_cache()
    return dict(model="bert_large width, 2 layers, bf16, 64 x 128, dropout 0.1",
                fwd=kern[0], fwd_bwd=kern[1], plain_fwd=plain[0], plain_fwd_bwd=plain[1],
                fwd_formula=_bert_formula(cfg, FB * FS, FS, 2),
                launches=launched)


def _profile_engine():
    """(b) phase 6's bf16 Adam run with the FLOPS profiler at step 3 against
    the same run unprofiled, 5 steps each through ``train_batch``, under
    deterministic algorithms: the losses bit for bit; the report, FLOPs,
    model TFLOP/s and MFU; the profiled window against the other steps."""
    out = {}
    torch.use_deterministic_algorithms(True)
    try:
        for name, extra in (("plain", None), ("profiled", {"flops_profiler": {
                "enabled": True, "profile_step": PROFILE_STEP, "detailed": False}})):
            engine, batch = _zero_engine(extra=extra, stage=0)
            losses, step_ms = [], []
            for _ in range(PROFILE_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses.append(engine.train_batch(iter([batch])))
                step_ms.append(1e3 * (time.perf_counter() - t0))
            out[name] = dict(losses=losses, step_ms=step_ms,
                             fused=engine._can_fuse_train_step())
            if extra is not None:
                prof = dict(engine.last_profile)
                head = [ln for ln in prof.pop("report").splitlines()
                        if ln.startswith(("Profile step", "Params", "FLOPs", "MACs",
                                          "Step latency", "Achieved", "Top "))]
                out[name].update(profile=prof, report_head=head,
                                 window_ms=1e3 * prof["duration_s"],
                                 count_pass_host_ms=1e3 * prof["count_s"])
            _free(engine)
    finally:
        torch.use_deterministic_algorithms(False)
    # the step as phase 6 runs it, under the default algorithms: profiled at
    # its second step
    engine, batch = _zero_engine(extra={"flops_profiler": {
        "enabled": True, "profile_step": 1, "detailed": False}}, stage=0)
    for _ in range(2):
        engine.train_batch(iter([batch]))
    prof = dict(engine.last_profile)
    prof.pop("report")
    out["default_algorithms"] = dict(profile=prof, window_ms=1e3 * prof["duration_s"])
    _free(engine)
    return out


def _serve_sentinels():
    """(c) GPT-2 XL at 6 of 48 layers, bf16, phase 3's traffic, with the
    sentinels armed and the transfer guard on, against the same engine
    unguarded; the program counts, a second pass, a planted sync."""
    from deepspeed_tpu_torch import GPT2Config, ServingConfig, ServingEngine, init_gpt2
    from deepspeed_tpu_torch import kernels
    from deepspeed_tpu_torch.inference.serving import engine as serving
    from deepspeed_tpu_torch.inference.serving.scheduler import default_buckets
    from deepspeed_tpu_torch.profiling import sentinels
    from deepspeed_tpu_torch.profiling.config import DeepSpeedSentinelConfig
    from deepspeed_tpu_torch.profiling.flops_profiler import get_model_profile

    cfg = GPT2Config.gpt2_xl(num_hidden_layers=SENTINEL_LAYERS)
    model = init_gpt2(cfg, seed=0, device="cuda", dtype=torch.bfloat16)
    largest = default_buckets(cfg.max_position_embeddings - 1)[-1]
    scfg = ServingConfig(max_slots=B, max_seq_len=cfg.max_position_embeddings,
                         kv_cache_dtype="bf16",
                         attention_impl={"default": "pallas_decode", largest: "pallas_sparse"})
    block = {"jax_sentinels": {"enabled": True, "compile_budget": SENTINEL_BUDGET,
                               "transfer_guard": True}}
    guarded = ServingEngine(model, cfg, scfg, device="cuda",
                            sentinel_config=DeepSpeedSentinelConfig(block))

    def programs():
        """Per class: the programs new since the sentinel was armed (an
        earlier phase at the same shapes leaves none new) and the class's
        programs in the process."""
        sents = {name: getattr(guarded, name) for name in
                 ("decode_sentinel", "decode_window_sentinel", "decode_kernel_sentinel")}
        sents.update({f"prefill {impl}": s for impl, s in guarded.prefill_sentinels.items()})
        return {name: dict(new=s.compiles, total=s._cache_size())
                for name, s in sents.items() if s is not None}

    kernels.reset_launch_counts()
    outs, impls, first = _drive(guarded)
    launches = {k: kernels.launch_counts()[k] for k in SERVING_KERNELS}
    after_first = programs()
    outs2, _, second = _drive(guarded)
    after_second = programs()
    plain = ServingEngine(model, cfg, scfg, device="cuda")
    want, _, _ = _drive(plain)
    del plain
    # the sanctioned host reads of one guarded steady-state decode step
    # (the guard cannot see an event wait: the count pins the reads)
    for p in _prompts()[:2]:
        guarded.submit(p, max_new_tokens=NEW_TOKENS)
    for _ in range(16):
        stats = guarded.step()
        if stats["decoded"] == 2 and not (stats["admitted"] or stats["prefill_chunks"]):
            break
    sentinels.reset_transfer_counts()
    stats = guarded.step()
    step_reads = dict(decoded=stats["decoded"], transfers=sentinels.transfer_counts())
    # a planted sync inside the guarded region: a decode step whose
    # attention reads a device value on the host
    real = kernels.decode_attend

    def planted(q, *a, **kw):
        q.float().sum().item()
        return real(q, *a, **kw)

    serving.kernels.decode_attend = planted
    try:
        guarded.step()
        planted_raised = None
    except RuntimeError as e:
        planted_raised = str(e).splitlines()[0]
    finally:
        serving.kernels.decode_attend = real
    guarded.drain()
    # rows 4 and 5 of the kernel table: a decode step's FLOPs through
    # get_model_profile, on the kernels and on their plain versions
    pool = guarded.pool
    tables = torch.as_tensor(pool.page_tables, dtype=torch.int32, device="cuda")
    tokens = torch.zeros(B, dtype=torch.long, device="cuda")
    positions = torch.full((B,), 700, dtype=torch.long, device="cuda")
    active = torch.ones(B, dtype=torch.bool, device="cuda")
    nh, qmode, dtype = guarded.local_heads, guarded._qmode, pool.compute_dtype
    step_flops = {}
    for name, step in (("decode_attention", serving._decode_step_kernel),
                       ("sparse_attention", serving._decode_step_window)):
        run = lambda: step(model, pool, tables, tokens, positions, active, nh, qmode, dtype)
        kern = get_model_profile(run, print_profile=False, as_string=False)[0]
        real_band = kernels.band_attend
        kernels.decode_attend = lambda q, pk, pv, t, qp, *, page_tokens, dtype, k_scale=None, \
            v_scale=None, prefill=False: kernels.decode_attention._decode_attend_torch(
                q.contiguous(), pk, pv, t.to(torch.int32).contiguous(),
                qp.to(torch.int32).contiguous(), page_tokens, dtype, k_scale, v_scale)
        kernels.band_attend = lambda q, kw, vw, ks, vs, pos, base, *, dtype: \
            kernels.sparse_attention._band_attend_torch(
                q.contiguous(), kw, vw, ks, vs, pos.to(torch.int32), base.to(torch.int32), dtype)
        try:
            plain_flops = get_model_profile(run, print_profile=False, as_string=False)[0]
        finally:
            kernels.decode_attend, kernels.band_attend = real, real_band
        step_flops[name] = dict(kernels=kern, plain=plain_flops)
    record_us = _program_record_us(
        (model, pool, tables, tokens, positions, active, nh, qmode, dtype))
    read_us = _step_read_us(tokens)
    del guarded, model
    torch.cuda.empty_cache()
    return dict(model=f"gpt2_xl bf16 (seed 0), {SENTINEL_LAYERS} of 48 layers, kv bf16, "
                      f"{B} slots", budget=SENTINEL_BUDGET, impls=impls,
                tokens_equal=outs == want, second_pass_equal=outs2 == want,
                programs_first_pass=after_first, programs_second_pass=after_second,
                launches=launches, planted_sync_raised=planted_raised,
                decode_step_reads=step_reads, program_record_us=record_us,
                step_read_us=read_us,
                decode_step_flops=step_flops,
                decode_step_ms=dict(first=first["decode_step_ms"],
                                    second=second["decode_step_ms"]))


def _program_record_us(args, calls=2000):
    """Host microseconds that ``records_programs`` adds to one call of a
    decode step, with the step's own arguments: a recorded no-op of the
    step's signature against the same no-op unrecorded."""
    from deepspeed_tpu_torch.profiling.sentinels import records_programs

    def step(model, pool, page_tables, tokens, positions, active, n_heads, qmode, dtype):
        return None

    recorded = records_programs(step)
    times = []
    for fn in (step, recorded, step, recorded):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(*args)
        times.append(time.perf_counter() - t0)
    return 1e6 * (times[1] + times[3] - times[0] - times[2]) / (2 * calls)


def _step_read_us(tokens, calls=500):
    """Host microseconds of a decode step's token read, behind one small
    kernel each time: the sanctioned ``device_get`` against the blocking
    ``.cpu()`` it replaced."""
    from deepspeed_tpu_torch.profiling.sentinels import device_get
    from deepspeed_tpu_torch.inference.serving.engine import _STEP_READ

    reads = {"device_get": lambda t: device_get(t, _STEP_READ), "cpu": lambda t: t.cpu()}
    times = dict.fromkeys(reads, 0.0)
    for _ in range(2):
        for name, read in reads.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                read(tokens + 1)
            times[name] += time.perf_counter() - t0
    return {name: 1e6 * t / (2 * calls) for name, t in times.items()}


def _sync_flags():
    """What ``set_sync_debug_mode("error")`` flags on this card, a call
    at a time (the transfer guard's windows are designed from it)."""
    x = torch.randn(1 << 16, device="cuda")
    pinned = torch.empty(1 << 16, pin_memory=True)
    pageable = torch.empty(1 << 16)
    ev = torch.cuda.Event()
    ev.record()
    calls = {
        "pinned D2H non_blocking": lambda: pinned.copy_(x, non_blocking=True),
        "pageable D2H non_blocking": lambda: pageable.copy_(x, non_blocking=True),
        "pinned H2D non_blocking": lambda: x.copy_(pinned, non_blocking=True),
        "pageable H2D blocking": lambda: x.copy_(pageable),
        "Event.synchronize": lambda: ev.synchronize(),
        "Event.query": lambda: ev.query(),
        "Stream.wait_event": lambda: torch.cuda.current_stream().wait_event(ev),
        "Stream.synchronize": lambda: torch.cuda.current_stream().synchronize(),
        "torch.cuda.synchronize": lambda: torch.cuda.synchronize(),
        ".item()": lambda: x[0].item(),
        ".cpu()": lambda: x[:4].cpu(),
        "nonzero": lambda: (x > 0).nonzero(),
    }
    flags = {}
    for name, fn in calls.items():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
            flags[name] = "passes"
        except RuntimeError:
            flags[name] = "raises"
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return flags


def _train_sentinels():
    """(d) bf16 train_step at 2 layers under the guard, then a planted sync;
    ZeRO-2 + offload streamed at 2 layers under the guard against
    unguarded (masters bit for bit, deterministic algorithms); a planted
    sync on the main thread while an offload worker holds its window."""
    import tempfile
    import threading

    from deepspeed_tpu_torch.profiling import allowed_transfer, sentinels, transfer_free
    from deepspeed_tpu_torch.runtime.zero.sharded_optimizer import OFFLOAD_D2H

    guard = {"jax_sentinels": {"enabled": True, "transfer_guard": True}}
    res = {"sync_flags": _sync_flags()}
    engine, batch = _zero_engine(extra=guard, layers=2, stage=0)
    losses = [engine.train_step([batch]) for _ in range(3)]
    # bf16 makes no sanctioned read either: the guard cannot see an event
    # wait, so the count pins it
    sentinels.reset_transfer_counts()
    engine.train_step([batch])
    res["train_step_transfers"] = sentinels.transfer_counts()
    losses = [float(x) for x in losses]
    hook = engine.module.bert.pooler.register_forward_hook(
        lambda m, i, o: o.float().sum().item())
    try:
        engine.train_step([batch])
        res["train_step_planted"] = None
    except RuntimeError as e:
        res["train_step_planted"] = str(e).splitlines()[0]
    finally:
        hook.remove()
    res["train_step_losses"] = losses
    res["train_step_programs"] = engine._train_step_sentinel.compiles
    _free(engine)
    zero = dict(stage=2, cpu_offload=True, offload_stream_buckets=OFFLOAD_BUCKETS)
    masters = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = torch.distributed.FileStore(os.path.join(tmp, "store"), 1)
        torch.distributed.init_process_group("nccl", store=store, rank=0, world_size=1)
        torch.use_deterministic_algorithms(True)
        try:
            for name, extra in (("plain", None), ("guarded", guard)):
                engine, batch = _zero_engine(extra=extra, layers=2, **zero)
                res[f"offload_{name}_losses"] = [float(engine.train_step([batch]))
                                                 for _ in range(3)]
                masters[name] = engine.master_params()
                _free(engine)
        finally:
            torch.use_deterministic_algorithms(False)
            torch.distributed.destroy_process_group()
    res["offload_masters_equal"] = all(torch.equal(a, b) for a, b in
                                       zip(masters["plain"].values(),
                                           masters["guarded"].values()))
    # the mode is one setting for the process: a worker's window must not
    # let the main thread's implicit sync through
    held, release = threading.Event(), threading.Event()

    def worker():
        with allowed_transfer(OFFLOAD_D2H):
            held.set()
            release.wait(30)

    t = threading.Thread(target=worker)
    t.start()
    held.wait(30)
    x = torch.ones(4, device="cuda")
    try:
        with transfer_free():
            x.sum().item()
        res["main_thread_planted"] = None
    except RuntimeError as e:
        res["main_thread_planted"] = str(e).splitlines()[0]
    finally:
        release.set()
        t.join()
    return res


def phase_profile():
    """Phase 19: (a) the kernels' FLOP counts, (b) the profiler in the
    training engine, (c) the sentinels in serving, (d) in training."""
    stamps = [time.perf_counter()]
    counts = _profile_counts()
    stamps.append(time.perf_counter())
    engine = _profile_engine()
    stamps.append(time.perf_counter())
    serve = _serve_sentinels()
    stamps.append(time.perf_counter())
    train = _train_sentinels()
    stamps.append(time.perf_counter())
    failures = []
    if (counts["fwd"], counts["fwd_bwd"]) != (counts["plain_fwd"], counts["plain_fwd_bwd"]):
        failures.append(f"(a) kernel counts {counts['fwd']}/{counts['fwd_bwd']} != plain "
                        f"{counts['plain_fwd']}/{counts['plain_fwd_bwd']}")
    if counts["fwd"] != counts["fwd_formula"]:
        failures.append(f"(a) forward {counts['fwd']} != formula {counts['fwd_formula']}")
    if min(counts["launches"].values()) <= 0:
        failures.append(f"(a) a flash kernel did not launch in the count: {counts['launches']}")
    prof = engine["profiled"]
    if prof["losses"] != engine["plain"]["losses"]:
        failures.append(f"(b) profiled losses {prof['losses']} != {engine['plain']['losses']}")
    if prof["fused"] or not engine["plain"]["fused"]:
        failures.append("(b) train_step fused with an armed profiler")
    if not (prof["profile"]["flops"] > 0 and prof["profile"]["model_tflops"]
            and prof["profile"]["mfu"]):
        failures.append(f"(b) no model TFLOP/s or MFU: {prof['profile']}")
    if not prof["report_head"]:
        failures.append("(b) no report printed")
    if not (serve["tokens_equal"] and serve["second_pass_equal"]):
        failures.append("(c) guarded tokens differ from the unguarded run's")
    if serve["programs_first_pass"] != serve["programs_second_pass"]:
        failures.append(f"(c) the second pass added programs: {serve['programs_first_pass']} "
                        f"-> {serve['programs_second_pass']}")
    ran = {"decode_kernel_sentinel", "decode_window_sentinel", "prefill pallas_decode",
           "prefill pallas_sparse"}
    if any(serve["programs_first_pass"][name]["total"] < 1 for name in ran):
        failures.append(f"(c) a class that ran recorded no program: "
                        f"{serve['programs_first_pass']}")
    if min(serve["launches"].values()) <= 0:
        failures.append(f"(c) a serving kernel did not launch: {serve['launches']}")
    if not serve["planted_sync_raised"]:
        failures.append("(c) the planted sync in a guarded decode step did not raise")
    if serve["decode_step_reads"] != dict(decoded=2, transfers={"serving/step_read": 1}):
        failures.append(f"(c) a guarded decode step's reads: {serve['decode_step_reads']}, "
                        "want one serving/step_read")
    for name, f in serve["decode_step_flops"].items():
        if f["kernels"] != f["plain"] or f["kernels"] <= 0:
            failures.append(f"(c) {name} decode step FLOPs {f}")
    if not all(np.isfinite(train["train_step_losses"])):
        failures.append(f"(d) guarded train_step losses {train['train_step_losses']}")
    if train["train_step_transfers"]:
        failures.append(f"(d) guarded bf16 train_step read {train['train_step_transfers']}")
    for key in ("train_step_planted", "main_thread_planted"):
        if not train[key]:
            failures.append(f"(d) {key}: the planted sync did not raise")
    if not train["offload_masters_equal"] or \
            train["offload_plain_losses"] != train["offload_guarded_losses"]:
        failures.append("(d) guarded offload differs from unguarded")
    res = dict(counts=counts, engine=engine, serve=serve, train=train, failures=failures,
               seconds=dict(zip("abcd", np.diff(stamps).tolist())))
    if failures:
        _report("profile_failed", res)
        raise RuntimeError("profile: " + "; ".join(failures))
    return res


PHASES = ("kernels", "serve", "oracle", "flash", "train", "grad", "zero", "ckpt", "resil",
          "pld", "serve6", "fleet", "sparse", "pipe", "parallel", "serve_tp",
          "remat", "profile")


def _report(tag, result):
    print(tag, json.dumps(result), flush=True)
    return result


def _phase(name, fn, *args):
    # an earlier phase's engines may sit in reference cycles that hold
    # device memory until the collector runs: start each phase from a card
    # the script has emptied
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    result = fn(*args)
    seconds = time.perf_counter() - t0
    # what the phase left allocated on the card (its result included), and
    # what a collection frees of it: memory that outlives its phase shows
    # here, and in a later phase's peaks
    left = torch.cuda.memory_allocated()
    gc.collect()
    print(f"phase {name}: {seconds:.1f} s", flush=True)
    print(f"phase {name}: memory_allocated {left} bytes at its end, "
          f"{torch.cuda.memory_allocated()} after gc.collect()", flush=True)
    return result


def phase_kernels(timer):
    """Phase 2; every case is printed as soon as it has passed."""
    serving = (B, NH, HD, PT, MP)
    decode_cases = [_report("case", decode_case(timer, C, kv)) for C in (1, 2, 40, 512)
                    for kv in ("fp32", "bf16", "int8")]
    # fp16 queries over fp16, bf16 and int8 pages (decode_attention_fp16.cu)
    decode_cases += [_report("case", decode_case(timer, C, kv, "fp16")) for C in (1, 2, 512)
                     for kv in ("fp16", "bf16", "int8")]
    band_cases = [_report("case", band_case(timer, N, dt)) for N in (8, 8 * PT)
                  for dt in ("fp32", "bf16", "fp16")]
    band_cases += [_report("case", band_odd_case(dt, shape)) for shape in BAND_ODD_SHAPES
                   for dt in ("fp32", "bf16", "fp16")]
    odd_cases = [_report("case", decode_odd_case(C, kv, shape)) for shape in ODD_SHAPES
                 for C in (1, 5, 70) for kv in ("fp32", "bf16", "int8")]
    odd_cases += [_report("case", decode_odd_case(C, kv, shape, "fp16")) for shape in ODD_SHAPES
                  for C in (1, 70) for kv in ("fp16", "bf16", "int8")]
    odd_cases += [_report("case", decode_one_token_prefill(kv, shape, q))
                  for shape in (serving,) + ODD_SHAPES for q in (None, "fp16")
                  for kv in ("bf16", "int8")]
    # the serving features' shapes: a speculative verify at C = k+1 = 5 (and,
    # in the band, 8 lanes x 5 queries) and a 256-token prefill chunk
    decode_cases += [_report("case", decode_case(timer, SPEC_K + 1, kv))
                     for kv in ("fp32", "bf16", "int8")]
    decode_cases += [_report("case", decode_case(timer, CHUNK, "bf16"))]
    band_cases += [_report("case", band_case(timer, N, dt)) for N in (B * (SPEC_K + 1), CHUNK)
                   for dt in ("bf16", "fp32")]
    odd_cases += [_report("case", verify_rows_case(kv)) for kv in ("fp32", "bf16", "int8")]
    return decode_cases, band_cases, odd_cases


def phase_flash(timer):
    """Phase 5; every case is printed as soon as it has passed."""
    cases = (
        dict(label="bf16 padded", dtype_name="bf16"),
        dict(label="fp32 padded", dtype_name="fp32"),
        dict(label="bf16 causal", dtype_name="bf16", causal=True, padded=False),
        dict(label="bf16 block16 sparse empty-row", dtype_name="bf16", sparse=True),
        dict(label=FLASH_MAIN_CASE, dtype_name="bf16", rate=0.1),
        dict(label="fp32 causal dropout0.1", dtype_name="fp32", causal=True, rate=0.1),
        # the tile code differs by head dim
        dict(label="bf16 D128 causal dropout0.1", dtype_name="bf16", causal=True, rate=0.1,
             FD=128),
        dict(label="bf16 D32 padded", dtype_name="bf16", FD=32),
        # several LUT blocks a row or column: the forward's and dq's K/V ring
        # runs with both stages, dk/dv walks several query blocks
        dict(label="bf16 S512 block64 causal dropout0.1", dtype_name="bf16", causal=True,
             rate=0.1, FB=8, FS=512, block=64),
        dict(label="bf16 S256 block32 padded", dtype_name="bf16", FB=8, FS=256, block=32),
        # fp16, the loss-scaled training path's routines
        dict(label=FLASH_FP16_MAIN_CASE, dtype_name="fp16", rate=0.1),
        dict(label="fp16 causal", dtype_name="fp16", causal=True, padded=False),
        dict(label="fp16 D128 causal dropout0.1", dtype_name="fp16", causal=True, rate=0.1,
             FD=128),
        dict(label="fp16 S512 block64 causal dropout0.1", dtype_name="fp16", causal=True,
             rate=0.1, FB=8, FS=512, block=64),
        # the SQuAD fine-tune's shape (phase 11): three key blocks a row
        dict(label="bf16 S384 B24 padded dropout0.1", dtype_name="bf16", rate=0.1,
             FB=QA_BATCH, FS=QA_SEQ),
        dict(label="fp16 S384 B24 padded dropout0.1", dtype_name="fp16", rate=0.1,
             FB=QA_BATCH, FS=QA_SEQ),
    )
    results = [_report("flash_case", flash_case(timer, **c)) for c in cases]
    return results, _report("flash_overflow", flash_overflow_case())


# loss and each gradient, kernels against plain versions, relative to the
# gradient's largest magnitude (the loss: to itself). fp32: the same fp32
# math summed in another order, the same masks. bf16: both sides round p,
# ds and the attention outputs to bf16, but in another summation order, so
# an element can land one bf16 step (2^-8 of it) apart, and such flips
# carry through two layers of bf16 GEMMs and layer norms; 2e-2 is five bf16
# steps of the largest magnitude, FLASH_TOL's bound for one kernel.
# fp16: the same flips at fp16's finer steps; 1e-2, half of bf16's, set
# before the first fp16 run.
GRAD_TOL = {"fp32": 1e-4, "bf16": 2e-2, "fp16": 1e-2}


def phase_grad_oracle(dtype_name):
    """BERT-large width, 2 layers, dropout 0.1, activation checkpointing
    "dots", weights in ``dtype_name``: loss and every grad on the kernels
    against the plain attention versions, at the same dropout seed (the
    same Philox masks and the same hidden-dropout generators)."""
    import deepspeed_tpu_torch as dt

    dtype = FLASH_DTYPES[dtype_name]
    tol = GRAD_TOL[dtype_name]
    cfg = dt.BertConfig.bert_large(num_hidden_layers=2, checkpoint_activations=True,
                                   checkpoint_policy="dots")
    model = dt.init_bert(cfg, seed=0, device="cuda", dtype=dtype)
    batch = _bert_batch(cfg, 8, FS, seed=1)

    def run():
        model.zero_grad(set_to_none=True)
        loss = model(*batch, dropout_seed=77)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    before = dt.kernels.launch_counts()
    loss, grads = run()
    after = dt.kernels.launch_counts()
    if any(after[k] <= before[k] for k in FLASH_KERNELS):
        raise RuntimeError("the kernel run of the grad oracle launched no flash kernel")
    with _PlainAttention():
        loss_p, grads_p = run()

    def held(label, loss, grads):
        """The worst gradient error of a run against the plain run, and its
        parameter; raises past the tolerance."""
        worst, worst_name = 0.0, None
        for name, g in grads.items():
            want = grads_p[name].float()
            err = float((g.float() - want).abs().max()) / max(float(want.abs().max()), 1e-30)
            if err >= worst:
                worst, worst_name = err, name
            if not err <= tol:
                raise RuntimeError(f"{dtype_name} {label}: grad of {name} differs from the "
                                   f"plain run by {err:.3e} of its max (tolerance {tol})")
        if abs(loss - loss_p) > tol * abs(loss_p):
            raise RuntimeError(f"{dtype_name} {label}: loss {loss} differs from the plain "
                               f"run's {loss_p}")
        return worst, worst_name

    worst, worst_name = held("kernels", loss, grads)
    # each kernel alone among plain versions: which one moves the gradients
    by_kernel = {}
    for kernel in FLASH_KERNELS:
        with _PlainAttention(keep=(kernel,)):
            loss_k, grads_k = run()
        by_kernel[kernel] = dict(zip(("worst_rel_grad_err", "worst_param"),
                                     held(f"{kernel} alone", loss_k, grads_k)),
                                 loss=loss_k)
    del model
    torch.cuda.empty_cache()
    return dict(model=f"bert_large width, 2 layers, {dtype_name}, dropout 0.1, remat dots",
                batch=8, seq=FS, loss=loss, loss_plain=loss_p, params=len(grads),
                worst_rel_grad_err=worst, worst_param=worst_name, tol=tol,
                one_kernel_alone=by_kernel)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the results here (JSON)")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %(default)s; a subset prints no result")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"--phases takes {PHASES}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # read by cuBLAS when its first handle is made: fixed workspaces, so that
    # phase 8's runs under deterministic algorithms are reproducible
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from deepspeed_tpu_torch.kernels import build, registry

    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.build_seconds if build.build_seconds is not None else 'cached'})",
          flush=True)

    timer = Timer()
    if "kernels" in phases:
        decode_cases, band_cases, odd_cases = _phase("kernels", phase_kernels, timer)
    if "serve" in phases:
        served = _report("serve", _phase("serve", phase_serve))
    if "oracle" in phases:
        oracle = _report("oracle", _phase("oracle", phase_oracle))
    if "flash" in phases:
        flash_cases, flash_overflow = _phase("flash", phase_flash, timer)
    if "train" in phases:
        trained = _report("train", _phase("train", phase_train))
        trained_fp16 = _report("train_fp16", _phase("train fp16", phase_train_fp16))
    if "grad" in phases:
        grad_oracle = [_report("grad_oracle", _phase(f"grad {d}", phase_grad_oracle, d))
                       for d in ("fp32", "bf16", "fp16")]
    if "zero" in phases:
        zero = _report("zero", _phase("zero", phase_zero))
    if "ckpt" in phases:
        ckpt = _report("ckpt", _phase("ckpt", phase_ckpt))
    if "resil" in phases:
        resil = _report("resil", _phase("resil", phase_resil))
    if "pld" in phases:
        pld = _report("pld", _phase("pld", phase_pld))
    if "serve6" in phases:
        serve6 = _report("serve6", _phase("serve6", phase_serve6))
    if "fleet" in phases:
        fleet = _report("fleet", _phase("fleet", phase_fleet))
    if "sparse" in phases:
        sparse = _phase("sparse", phase_sparse, timer)
    if "pipe" in phases:
        pipe = _phase("pipe", phase_pipe, timer)
    if "parallel" in phases:
        parallel = _report("parallel", _phase("parallel", phase_parallel))
    if "serve_tp" in phases:
        serve_tp = _report("serve_tp", _phase("serve_tp", phase_serve_tp, timer))
    if "remat" in phases:
        remat = _report("remat", _phase("remat", phase_remat))
    if "profile" in phases:
        profile = _report("profile", _phase("profile", phase_profile))
    if phases != set(PHASES):
        print(card_info())
        print(f"partial run ({sorted(phases)}): no result line")
        return 0

    entries = []
    for name, cases, main_case, fp16_case in (
            ("decode_attention", decode_cases, "C=1 pages=bf16", "C=1 q=fp16 pages=fp16"),
            ("sparse_attention", band_cases, "N=8 bf16", "N=8 fp16")):
        rep = next(c for c in cases if c["case"] == main_case)
        rep16 = next(c for c in cases if c["case"] == fp16_case)
        source, replaces = registry.KERNEL_SOURCES[name]
        entries.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=served["launches"][name],
            # phase 12's fp32 pass: the launches inside its speculative
            # verify steps and inside its prefill chunks
            serve6_launches={k: serve6["fp32"]["run"][k][name] for k in
                             ("launches", "launches_in_verify", "launches_in_chunks")},
            # phase 13: the launches inside each replica process of the
            # disaggregated fp32 pass, read from its engine endpoint
            fleet_launches={r: v["kernels"][name] for r, v in
                            fleet["disagg_fp32"]["replicas"].items()},
            # phase 15 c: generate() on the model converted from a pipeline tag
            pipe_launches=pipe["equal"]["serve"]["launches"][name],
            # phase 17: each rank's launches over its 10 heads at TP 2, fp32
            # (a plain pass) and bf16 (the warm-up and the timed pass)
            serve_tp_launches_per_rank={
                f"fp32_{STP_LAYERS}_layers": [r[name] for r in serve_tp["launches"]["plain"]],
                f"bf16_{STP_TIMED_LAYERS}_layers":
                    [r[name] for r in serve_tp["launches"]["timed"]]},
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=rep["ms"], plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=rep["bound_by"], library_ms=rep["library_ms"],
            main_case=main_case,
            # the fp16 routines (serving runs bf16, so they have no launches
            # on the main path)
            fp16=dict(source=source.replace(".cu", "_fp16.cu"), **{
                k: rep16[k] for k in ("case", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}),
            cases=cases + (odd_cases if name == "decode_attention" else [])))
    outputs = {"fwd": ("out", "lse"), "dq": ("dq",), "dkv": ("dk", "dv", "db")}
    # the bf16 / fp32 routines (their launches from the bf16 Adam run), then
    # the fp16 instantiations (their launches from the fp16 LAMB run)
    for suffix, main_case, run, dtypes in (
            ("", FLASH_MAIN_CASE, trained, ("bf16", "fp32")),
            ("_fp16", FLASH_FP16_MAIN_CASE, trained_fp16, ("fp16",))):
        rep = next(c for c in flash_cases if c["case"] == main_case)
        cases = [c for c in flash_cases if c["case"].split()[0] in dtypes]
        for name, kind in zip(FLASH_KERNELS, ("fwd", "dq", "dkv")):
            source, replaces = registry.KERNEL_SOURCES[name]
            if suffix:
                source = source.replace(".cu", "_fp16.cu")
            # phase 11: the bf16 PLD run's launches, the fp16 SQuAD fine-tune's
            slice_launches = (dict(qa_launches=pld["qa"]["launches"][name]) if suffix
                              else dict(pld_launches=pld["pld_run"]["launches"][name]))
            if not suffix:     # phase 15: the GPT-2 XL pipeline's timed steps
                slice_launches["pipe_launches"] = pipe["timed"]["launches"][name]
                # phase 16: a rank's launches a step at tensor_parallel 2
                # (its 8 of 16 heads), fp32 at 4 layers and bf16 at 24
                slice_launches["parallel_launches_per_rank_step"] = dict(
                    fp32_4_layers=parallel["a"]["ranks"][0]["launches_per_step"][name],
                    bf16_24_layers=parallel["c"]["ranks"][0]["launches_per_step"][name])
                # phase 15 (d): a rank's launches under the pipeline at TP 2 (the
                # fp32 run's steps, and a bf16 step)
                slice_launches["pipe_tp_launches_per_rank"] = {
                    f"fp32_{PTP_LAYERS}_blocks_{PTP_STEPS}_steps":
                        pipe["tp"]["launches"]["tp2"][name],
                    f"bf16_{PTP_TIMED_LAYERS}_blocks_per_step":
                        pipe["tp"]["timed"][0]["launches_per_step"][name]}
                # phase 18 (b): the offload_dots run's timed steps (24 layers,
                # the recompute's forward included)
                slice_launches["remat_launches"] = \
                    remat["cost"]["offload_dots"]["launches"][name]
            entries.append(dict(
                name=name + suffix, route="cuda", source=source, replaces=replaces,
                launches=run["launches"][name], **slice_launches,
                max_abs_err=max(c["max_abs_err"][o] for c in cases for o in outputs[kind]),
                **rep["kernels"][kind], main_case=main_case,
                library_call=("scaled_dot_product_attention" if kind == "fwd" else
                              "scaled_dot_product_attention backward (dq, dk, dv together)"),
                cases=[dict(case=c["case"], max_abs_err=c["max_abs_err"], **c["kernels"][kind])
                       for c in cases]))
            if kind == "dq":   # the two backward kernels against SDPA's whole backward
                entries[-1]["backward_by_case"] = [dict(case=c["case"], **c["backward"])
                                                   for c in cases]
            if not suffix:     # phase 14: block 16 on Fixed and BigBird layouts
                entries[-1]["sparse"] = dict(
                    launches=sparse["train"]["launches"][name],
                    parity_worst_rel_err={c["case"]: c["worst_rel_err"]
                                          for c in sparse["parity"]},
                    cases=[dict(case=c["case"], layout=c["layout"],
                                max_abs_err=c["max_abs_err"], **c["kernels"][kind])
                           for c in sparse["timed"]])
            if not suffix:     # phase 16: ring and Ulysses at W = 2 (a rank's launches
                               # of one fwd + bwd, errors, bf16 fwd + bwd ms)
                entries[-1]["parallel_sp_cases"] = [
                    {k: v for k, v in c.items()} for c in parallel["d"][0]]
                # (c)'s shapes in bf16 at each rank's head offset
                entries[-1]["parallel_offset_bf16"] = [r["offset_bf16"]
                                                       for r in parallel["c"]["ranks"]]
            if not suffix:     # phase 15: the pipeline's shapes (causal, S 1024, 25 heads)
                entries[-1]["pipe_cases"] = [
                    dict(case=c["case"], max_abs_err=c["max_abs_err"], **c["kernels"][kind])
                    for c in pipe["cases"]]
            if suffix and kind != "fwd":
                entries[-1]["loss_scaled_overflow"] = flash_overflow["verdicts"]
    case = zero["cpu_adam"]
    source, replaces = registry.HOST_KERNEL_SOURCES["cpu_adam"]
    entries.append(dict(
        name="cpu_adam", route="cpp", source=source, replaces=replaces,
        launches=zero["timed"]["streamed"]["cpu_adam_launches"],
        max_abs_err=case["max_abs_err"], ms=case["ms"], plain_ms=case["plain_ms"],
        bound_ms=case["bound_ms"], bound_by=case["bound_by"], library_ms=case["library_ms"],
        device="host CPU (g++ -O3 -march=native -fopenmp, OpenMP threads)",
        main_case=case["case"],
        library_call="torch._fused_adamw_ on the CPU",
        contracted_build_ms=case["contracted_build_ms"]))
    # phase 14: the host ops of csrc/host_ops.cpp; only the layout's LUT is on
    # its main path (built at the first step's forward of each layer)
    host_ops = sparse["host_ops"]
    for name, op in host_ops["ops"].items():
        source, replaces = registry.HOST_KERNEL_SOURCES[name]
        entries.append(dict(
            name=name, route="cpp", source=source, replaces=replaces,
            launches=sparse["train"]["host_launches"][name], **op,
            device="host CPU (g++ -O3 -march=native -fopenmp, OpenMP threads)",
            main_case=host_ops["layout"] if name == "host_layout_to_lut" else
            f"BERT-large's {host_ops['bert_large_params']} parameters" if "flatten" in name
            else f"{host_ops['lamb_elements']} elements (the word embeddings)",
            library_call="torch.cat" if name == "host_flatten" else None))
    card = card_info()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, kernels=entries, serve=served, oracle=oracle,
                           flash_cases=flash_cases, flash_overflow=flash_overflow,
                           train=trained, train_fp16=trained_fp16,
                           grad_oracle=grad_oracle, zero=zero, ckpt=ckpt, resil=resil,
                           pld=pld, serve6=serve6, fleet=fleet, sparse=sparse, pipe=pipe,
                           parallel=parallel, serve_tp=serve_tp, remat=remat,
                           profile=profile, torch=torch.__version__,
                           cuda=torch.version.cuda), f,
                      indent=1)
    print(card)                  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
