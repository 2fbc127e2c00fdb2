#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py            # Wisconsin at 5,000,000 rows; the
                                     # model UDF over 32,768 x 128 tokens;
                                     # qwen3-1.7b serving 8 x (4,096 + 64),
                                     # training on 4 x 2,048 tokens,
                                     # training through launch/train.py with
                                     # checkpoints, failures and a resume,
                                     # serving and training on a
                                     # data 2 x model 2 mesh of the card,
                                     # and the dry-run's cost model held
                                     # on the card against meta; the
                                     # model, engine, live and durable
                                     # paths on ranks; and TP over model
                                     # for rwkv, zamba2, whisper and llava

Phases (any mismatch raises; nothing is caught):
  1. header — the card's name and power limit; build the CUDA kernels from
     ``src/repro_torch/kernels/csrc`` (build time is set-up);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths launch, plus block-id lists, -1-padded per-shard
     id lists through the ops (pads mid-list and trailing, pads only),
     filter_count on a column list, with n_valid < n, on a stacked matrix
     at n % 4 != 0 (4-byte loads) and at 17 columns (past the pointer
     struct), with listed tiles wholly past n_valid, block_topk and the
     merge kernel with ties at k = 8, 16 and 17 (the rounds kernel), fewer
     live rows than k, n % 4 != 0, offset views and scores rising with the
     row,
     segment_agg at an n that is not a multiple of 4, off 16-byte alignment
     and with G x C past shared memory, deliberate ties, duplicate-heavy
     join keys, one join run longer than any shared-memory window, join
     prefixes stopping inside runs, and for the attention kernels (unit-scale
     inputs, a tolerance per row, planted faults refused) the reference's
     sweep shapes (bf16 flash on the model path's strided (B,S,H,D) views
     and on contiguous inputs, D 16-128), GQA at S=1024, a ragged S, B*H
     past 65,535, the serving prefill (B 8, H 16, KV 8, S 4,096, D 128,
     bf16 causal, strided), and decode lengths 0, 1, each side of a slice edge, S,
     and every length = S, also on the serving path's layout (the
     (B,KV,S,D) views of a (B,S,KV,D) cache layer) at the serve shape;
     and the flash backward (B7, ``flash_attention_bwd``) on the
     reference's sweep (D 16-128, float32 and bf16, causal and not), GQA
     at S=1024, ragged S on strided views, the bf16 kernels' tile edges
     (S = 129 and 2,047 at D 128, G = 8 at S 1,024) and the training shape
     (B 4, H 16, KV 8, S 2,048, D 128, bf16 causal, strided): dq, dk and
     dv each within BWD_TOL of its scale, two planted faults refused (dk
     and dv without one q head of the group, dq doubled), two launches
     equal bit for bit; after the build, the HGMMA and UTMALDG
     instructions ``cuobjdump -sass`` finds in the bf16 B7 kernels (both
     must be there: the kernels reached wgmma and TMA);
  3. the first slice: the paper's 12 Wisconsin expressions through AFrame →
     Session(mode="kernel"), 3 rounds of randomized literals, held against
     the port's gspmd mode and a numpy oracle (dtypes included), plus two
     clustered ``unique2`` range queries that run the block-skipping paths;
     every relational kernel's launch counter must have moved in this phase;
  4. the second slice: the paper's model-UDF pipeline (Figs. 4-6) with
     paper-lm at full width (attn_impl="flash") registered as a sentiment
     UDF over a 32,768-row token column, in kernel mode: head, count of one
     class, persist + group-by. Held against the direct application of the
     model, numpy, and the port's blocked attention (the reference's
     default); flash_mha_fwd must launch 8 layers x 16 microbatches per
     full pass, segment_agg on the group-by;
  5. timings — per expression and per UDF query: host-clock wall time and
     the device time of a torch.profiler trace (the device-busy share);
     rows/s and tokens/s of the UDF count, and its device time per kernel;
     per kernel, the device time of the kernel alone (by name in a profiler
     trace) and of a one-call PyTorch yardstick where one exists (every
     kernel of it in the same kind of trace), each checked by CUDA events
     over back-to-back calls, beside the CUDA-event time of one call of its
     plain version, and the bytes / operations bound (the relational
     kernels on copies of their operands in turn, so that their reads come
     from device memory and not from the L2); segment_agg also at the e8
     shape (G = 20, max), merge_join_count also on the duplicate-heavy
     keys, block_topk also on unique2 (scores rising with the row), flash
     also on contiguous inputs, decode at phase 2's shape with every
     length = S and at the mixed lengths (bound on the slots they walk;
     the decode row of the ``kernels`` line is phase 10's); and the device
     time by kernel of one run of e3, e9 and e11;
  6. the live-ingestion slice: the phase-3 table as a closed dataset
     clustered by unique2 with onePercent indexed, a group-by view, and
     eight batches of 250,000 rows (push, upsert, push, delete, push,
     upsert, push, delete; one flush each, compaction deferred: nine
     components). tests/test_lsm.py's query suite and expressions 3, 4, 8
     and 11 through a kernel-mode session, a gspmd reader session over the
     same catalog and a numpy newest-wins oracle, before and after the
     compaction; a filter_count launch per component holding matter and a
     segment_agg launch per component; the view against a recompute and
     numpy; filter_count with the matter column against its plain
     version, and every segment_agg (per component, with -1 group ids, and
     on the view's deltas), block_topk + topk_merge (the union stream) and
     merge_join_count (a union on the left) call the phase made, recorded
     as the path made it and held against the plain version on the same
     inputs; the time of each flush,
     of the compaction, and of each query (wall, median of 7; device) over
     nine components and over one, each line naming the card;
  7. the string fast path, windows and dialects. Over phase 6's nine
     components and again after its compaction: string4 ==, IN and the
     group count through the kernel session, the gspmd reader and the
     newest-wins oracle. Then phase 3's table in a kernel and a gspmd
     session: string4 == each of its values and an absent one, IN with
     two members and an absent one and with one and an absent one, the
     group-by (count, sum of four, max of onePercent) and the group count,
     stringu1 == (no dictionary lane), row_number by (ten, unique1), rank by
     two, cumsum(four) by (ten, unique2), moving_avg(four, 10) by unique2 —
     kernel == gspmd == numpy bit for bit — and one plan's Postgres text
     against the reference's; the largest deviation of cumsum(unique1)
     from a float64 oracle (printed, not gated). Every filter_count and
     segment_agg call of the phase is recorded and held against its plain
     version; both kernels must launch, counted apart from phase 6's. The
     two kernel shapes the phase adds (filter_count on the dictionary lane,
     segment_agg at G = 4) are timed as phase 5's rows, and each query's
     wall, device and busy share printed.
  8. durability. In a fresh temporary directory (its free space printed,
     removed at the end): phase 6's scenario through
     ``Session(mode="kernel", storage=dir)`` — the 5M-row table clustered
     by unique2 with onePercent indexed, Dim, the view, LIVE_MIX's eight
     batches (one flush each: nine components), then an upsert and a delete
     acked and left in the WAL — closed and reopened with ``Session.open``:
     lazily (the WAL tail replays into a tenth component), lazily again (the
     first query pays the soft-state rebuild), eagerly, compacted
     (``feed.compact()`` writes the new base and unlinks the dead segments)
     and opened once more. Each state runs tests/test_lsm.py's suite, e3,
     e4, e8, e9, e11, e12, string4 == and the string4 group count through
     the kernel session and a gspmd reader against the newest-wins oracle,
     with point lookups (upserted, deleted, absent) and the view against a
     recompute after the first open; every mounted column and rebuilt index
     payload must be a CUDA tensor, filter_count, segment_agg, block_topk +
     topk_merge and merge_join_count must launch (counted apart from phases
     3-7), and every call recorded is held against its plain version. The
     crash matrix: for each of IO_FAULT_POINTS, and for torn-write once
     more on its second arrival (a torn run segment), a store over a
     1,000,000-row base (CRASH_ROWS, cut for the script's time limit) and
     LIVE_MIX's first four batches (cut from eight: two flushed, two in the
     WAL) crashes once, is reopened and must equal a memory-only session
     that applied exactly the acked batches, bit for bit, with no duplicate
     key, and run e3 and e4 through the kernels. Printed beside the card:
     each batch's ack (WAL append + fsync) and WAL bytes, each flush with its
     segment write beside phase 6's, the compaction with its segment write
     and GC, each open (host clock and ``recovery_report``) and the segment
     bytes it read, the first query after a lazy open and its second run,
     the segment bytes written, and e3 / e4 wall and device time over ten
     components and over one.
  9. the multi-device engine: ``Session(mesh=make_local_mesh(8))``, eight
     row shards of 625,000 rows (153 zone blocks each) on the one card, in
     shard_map and kernel mode. The 12 expressions over ROUNDS rounds,
     each == numpy == the meshless kernel session, then clustered unique2
     ranges that must skip blocks on every shard's own grid (the explain
     text's per-shard note printed). Launch counts are zeroed before each
     mode and read after it: shard_map launches no kernel, kernel mode
     launches filter_count, segment_agg, block_topk + topk_merge and
     merge_join_count once per shard (printed per expression), and every
     launch it made is held against its plain version. A 1,000,008-row
     mesh session (125,001 rows a shard: views at 16-byte phases 0, 4, 8
     and 12) runs e3, e4, e9, e12 and ranges inside one shard (block rows
     of -1 only on the other seven), each launch held against its plain
     version. Phase 6's scenario at 1,000,000 base rows with an upsert and
     a delete batch runs on the mesh through a durable kernel session and
     a gspmd reader against the oracle, one point lookup searches one
     shard window per component, and ``Session.open`` remounts the store
     onto the mesh. Last, e3, e4, e9 and e12 at S = 1, 2, 4, 8 (wall and
     device time beside the card): the cost of distribution on one card.
 10. serving: qwen3-1.7b at its published config (28 layers, d 2048, 16 / 8
     heads of 128, vocab 151,936, qk-norm; seeded float32 weights, 8.1 GB)
     serves 8 requests of 4,096 prompt tokens + 64 new tokens (a 3.8 GB
     bf16 cache) through ``registry.get_api`` and ``models/steps.py`` as
     ``launch/serve.py`` drives them. Under attn_impl="flash" the launch
     counts are zeroed just before ``serve.generate`` and read just after:
     exactly 28 flash_mha_fwd for the prefill and 28 flash_decode per
     decode step, and every flash_decode call is held at once against its
     plain version on the same strided cache views. Against blocked (the
     reference's default), teacher-forced on blocked's greedy tokens: the
     logits at every step within SERVE_TOL (a planted wrong q head must
     exceed it), greedy tokens equal except where blocked's top-2 margin is
     within it; prefill(n) + decode(1) == prefill(n + 1); the "dus" cache
     write == "onehot" bit for bit. Timed, flash and blocked: prefill wall
     and device ms, decode ms per step (median, p90), tok/s, one step's
     device time by kind (flash_decode, GEMMs, copies and casts, the rest)
     and the busy share; flash_decode alone at the serve shape (the
     ``kernels`` line's decode row). Then deepseek-moe-16b and
     llava-next-mistral-7b (cut to 4 layers), zamba2-1.2b, rwkv6-1.6b and
     whisper-base at their published widths: 2 x 512 prompt tokens + 16
     decode steps, prefill(n) + decode(1) == prefill(n + 1), finite
     logits, and the flash_mha_fwd / flash_decode launches each family's
     attention layers make.
 11. training: qwen3-1.7b at its published config (2.03B float32
     parameters; with gradients and AdamW's m and v 32.5 GB) takes
     TRAIN_STEPS train steps through ``steps.init_train_state`` and
     ``steps.make_train_step`` (attn_impl="flash", remat on, AdamW) on one
     seeded batch of 4 x 2,048 tokens: launch counts zeroed just before
     the steps and read just after, 2 x 28 flash_mha_fwd (the forward and
     remat's recomputation) and 28 flash_attention_bwd a step; the loss
     finite and falling. Its first step is held against the same step on
     the blocked path (plain autograd, the reference's default) from the
     same weights — loss, grad norm, every parameter's gradient and every
     layer's dq / dk / dv within TRAIN_TOL (the weight update printed) —
     each of its 28 flash_attention_bwd calls against the plain version on
     the inputs the step gave it, and a fault planted in the backward
     kernel (dq doubled; one q head dropped) must move the step past those
     limits. Printed beside the card: each step's wall, the median after
     the first, tokens/s, peak memory over the steps after the first
     (which carry no checks), one step's device time by kind
     (flash_attention_bwd, flash_mha_fwd, GEMMs, the optimizer, copies and
     casts, the rest) and the busy share; B7 alone at the training shape
     (the ``kernels`` line's row). Then one train step of
     deepseek-moe-16b and llava-next-mistral-7b (cut to 4 layers),
     zamba2-1.2b, rwkv6-1.6b and whisper-base at their published widths on
     2 x 512 tokens: a finite loss, gradients and updated weights.
 12. the training runtime: qwen3-1.7b at its published widths, its depth
     cut to RUNTIME_MAX_LAYERS for the script's time limit, and further
     if the checkpoints' disk (RUNTIME_KEEP + 1 train states of 24.4 GB at
     full depth: the kept ones and the one being written) or the host's
     memory (two snapshots) forces it, the cut and its reason printed, trained through ``launch/train.run`` with a flash
     config: RUNTIME_STEPS steps of 4 x 2,048 tokens, a checkpoint every
     RUNTIME_CKPT_EVERY steps into a fresh temporary directory (removed at
     the end), a node failure at step 2 and a straggler at 5. Launch counts
     zeroed just before the run and read just after: 2 x L flash_mha_fwd
     and L flash_attention_bwd for every step run; the first step's B7
     calls held against plain. Checked: the events equal the schedule, the
     rollbacks land on steps 0 and 3 (the straggler's waits for step 3's
     async save), the log's steps are 0, 1, 0, 1, 2, 3, 4, 3, 4, 5, the
     loss finite and falling, each re-run step's loss equal to its first
     run's (bit for bit, else within RUNTIME_TOL, printed which); a second
     ``run(..., resume=True)`` starts at step 6 and holds every parameter,
     m, v and the step bit-equal to the first run's. Planted: a writer that
     swaps two layers' blocks must fail that check, and a flipped byte in a
     leaf file must make the restore raise "crc". Printed beside the card:
     the checkpoint's bytes, one save's synchronous snapshot and
     background write, each restore's seconds and GB/s, each step's wall
     (marking those a background write overlapped), the loop's wall and
     its share of checkpoint work.
 13. the model mesh on one card (``make_local_mesh`` + ``sharding_ctx``,
     every shard on the card). (a) qwen3-1.7b at its published config
     serves 4 x (2,048 + 16) tokens on a data 2 x model 2 mesh: the flash
     prefill equal to the meshless one bit for bit, then 16 decode steps
     with ``decode_cache_update="shardmap"`` (each model rank owns half the
     cache's rows) against the meshless one-hot decode, teacher-forced on
     the same tokens: each shardmap call of the first step against the
     one-hot body on the same inputs (bf16 row tolerance, the cache
     written bit-equal), the logits and the cache at every step within
     SERVE_TOL, argmax equal where the one-hot top-2 margin exceeds it; a
     merge without model rank 1 must fail both. (b) its
     data-parallel train step on 4 x 2,048 tokens (flash, remat) against
     the meshless step from the same weights and batch: loss within 5e-3,
     grad norm and every parameter's gradient within MESH_GRAD_TOL; a merge
     that drops shard 1 or sums for a mean must fail that; launch counts
     zeroed just before the meshed step and read just after (2 x 28
     flash_mha_fwd and 28 flash_attention_bwd per data shard), every B7
     call of one meshed step against plain. (d) ``compressed_psum`` over
     the step's two shard gradient trees: every leaf within max|t| / 127
     of the exact mean, layer 0's leaves equal on the CPU bit for bit.
     (c) deepseek-moe-16b (4 layers) expert-parallel on data 2 x model 4
     (16 experts a rank): its prefill of 4 x 512 against the meshless path
     on each data shard's rows, tokens whose experts flip counted, the
     requests that keep theirs and a run forced onto the meshless experts
     held to FAMILY_TOL, and that forced run without one rank's partials
     must fail it. Printed beside the card: prefill and decode ms of
     both (a) runs, both (b) step walls and the meshed step's peak memory.
 14. the dry-run and its cost model (``launch/dryrun.py``,
     ``launch/hlocost.py``). (b) The cost model over one real
     step on the card and the same step on meta, each on a mesh of one
     chip: phase 11's train step (flash, remat; B5 and B7 launched) and
     phase 10's flash decode step (B6 launched), launch counts zeroed just
     before the counted step and read just after. flops, bytes, each
     kernel's count and charge and the collectives must be equal, and the
     meta run with the step's B7 (or B6) charge dropped must differ.
     Printed beside the card: the step's device time (one profiled
     step), compute_s and memory_s, model flops over device time at
     989e12 flop/s, and the meta peak of live bytes beside
     ``torch.cuda.max_memory_allocated``. (a) Eight low-priority
     processes on the host, started after phase 13's last timing and
     running beside 14(b) alone: qwen3-1.7b x train_4k (depth cut to 7
     layers), deepseek-moe-16b x train_4k (depth cut to 2 layers),
     qwen3-1.7b x decode_32k under attn_impl=flash (B6 charged) and
     zamba2-1.2b x long_500k, at published width on the meta device, each
     on the pod (256) and multi-pod (512) mesh: every record ``ok``, its
     roofline terms (H100 data-sheet model terms, not measurements) and
     its meta run's seconds printed.
 15. the model mesh across processes (``launch/mesh.init_rank_mesh``,
     ``models/sharding.place_params``). (a) A one-rank NCCL group (a
     FileStore rendezvous in a temporary directory): qwen3-1.7b at its
     published config, its weights placed, one train step (flash,
     remat) through the rank path held to TRAIN_TOL against the meshless
     step from the same weights and batch (two of its B7 calls against
     plain), two timed steps of each path, each with nothing of the
     other on the card; then a flash prefill of 4 x 2,048 on the rank
     mesh and 16 teacher-forced decode steps of the shardmap decode and
     of the flash decode (B6) there, each within SERVE_TOL of the
     meshless one-hot decode (argmax equal where the one-hot top-2
     margin exceeds it). B5, B6 and B7 launch on local tensors; their
     counts, zeroed before each part and read after it, join the
     ``kernels`` line (path "rank"). (b) Two spawned gloo ranks sharing
     the card: all-reduce, all-gather, reduce-scatter and all-to-all over
     CUDA tensors; where all four carry, data 2 x model 1 at 2 layers
     against the meshless step, else the error text is printed and (b)
     left out. Printed beside the card: both step walls and peaks, the
     three decodes' ms a step.
 16. the DataFrame engine across processes (``Session`` on a RankMesh,
     each rank holding only its row shard). (a) A one-rank NCCL group:
     the 12 expressions at 5,000,000 rows, x ROUNDS in kernel mode and
     once in shard_map mode, equal numpy and the meshless kernel
     session, dtypes included; the kernel run's launches (filter_count, segment_agg,
     block_topk and its merge, merge_join_count), zeroed before it and
     read after it, join the ``kernels`` line (path "rank_engine"), each
     held against its plain version on its recorded inputs. (b) Four
     spawned gloo ranks sharing the card, 1,250,000 rows each: each
     rank's bytes on the card after registering beside the meshless
     session's, its answers equal (a)'s, and each expression's wall
     (median of 7) beside the one-process 4-shard mesh's and phase 9's
     8-shard one: the cost of distribution on one card, not a speed-up.

 17. the live engine across processes (feeds, upserts and deletes, LSM
     runs, the compaction, the view and persist on a RankMesh, each rank
     holding only its own rows of every component). (a) Phase 6's
     scenario (the 5,000,000-row table clustered by unique2 with
     onePercent indexed, Dim, the group-by view, LIVE_MIX's eight
     250,000-row batches, one flush each: nine components; a persist;
     then the full compaction) through a meshless kernel session and
     through a kernel session on a one-rank NCCL group: over nine
     components and after the compaction tests/test_lsm.py's suite, e3,
     e4, e8, e9, e11 and e12, point lookups (upserted, deleted, pushed,
     absent) and the view (== its recompute) equal between the two,
     dtypes included, and the suite equals phase 6's numpy oracle; the
     persisted answers equal. The rank run's launches (filter_count,
     segment_agg, block_topk and its merge, merge_join_count), zeroed
     before it and read after it, join the ``kernels`` line (path
     "rank_live"), each held against its plain version on its recorded
     inputs. (b) Four spawned gloo ranks sharing the card run the same
     scenario beside (a) (started with the phase, joined after (a): the
     script's time limit), 1,250,000 base rows each: each rank's bytes after the
     flushes and after the compaction beside the meshless session's, its
     peak during the compaction, its answers equal (a)'s, each component
     ceil(rows / 4) rows of CUDA tensors, each flush's wall and the
     compaction's beside (a)'s and phase 6's.

 18. the durable store across processes (``Session(storage=)``,
     ``Session.open`` and the lazy rebuild on a RankMesh: one store in the
     format a meshless session writes, the writer rank's I/O voted on by
     every rank). (a) Phase 8's scenario (the 5,000,000-row base, Dim,
     LIVE_MIX's eight batches, one flush each, DURABLE_TAIL acked into the
     WAL; a lazy open that replays the tail, the compaction, a lazy open
     again), the store in /dev/shm, through a meshless kernel session and
     through a kernel session on a one-rank NCCL group: after each open
     DURABLE_QUERIES and point lookups equal between the two, dtypes
     included, and DURABLE_QUERIES equal phase 8's numpy oracle. The rank
     run's launches (filter_count, segment_agg, block_topk and its merge,
     merge_join_count), zeroed before it and read after it, join the
     ``kernels`` line (path "rank_durable"), each held against its plain
     version on its recorded inputs. Each ack, each flush with its
     gathered segment write, each open's wall and ``recovery_report``,
     the card bytes after each lazy open and the peak during it are
     printed beside the meshless session's. (b) Four spawned gloo ranks
     sharing the card, started with the phase and joined after (a), run
     the crash matrix over IO_FAULT_POINTS at phase 8's cut (CRASH_ROWS
     rows, four batches, two flushed): each crash reopened on the ranks
     equals a memory-only rank session of exactly the acked batches and
     numpy, each component ceil(rows / 4) rows a rank; the store they
     left opens without a mesh on the card with the same rows, and no
     rank's peak during its open reaches that open's bytes, nor its
     transient beyond its shards a whole component's.

 19. tensor parallelism over model for rwkv, the hybrid, whisper and vlm
     (every weight the reference's rule table splits over model, split).
     zamba2-1.2b at its published width and depth (38 layers, d 2048, 64
     SSD heads, 32 attention heads), rwkv6-1.6b, whisper-base and
     llava-next-mistral-7b at their published widths (depths in
     RANK_TP_FAMILIES) each serve FAMILY_BATCH x FAMILY_PROMPT + FAMILY_STEPS
     decode steps meshless on the card (flash), then on two spawned gloo
     ranks sharing the card, data 1 x model 2, from the same seeded
     weights placed, teacher-forced on the meshless greedy tokens: the
     logits of every call within ``tp_limit`` (FAMILY_TOL, or twice the
     meshless run's own distance from a float32-compute run, where
     larger), argmax equal where the meshless top-2 margin exceeds it,
     each rank's parameter bytes below the meshless bytes; every
     flash_mha_fwd and flash_decode call held against its plain version.
     Then one train step of each family at RANK_TP_LAYERS layers (flash,
     remat, float32 compute) on the ranks against the meshless step from
     the same weights (TRAIN_TOL), every flash_attention_bwd call against
     plain. B5, B6 and B7, counted on
     each rank from just before its path to just after it, join the
     ``kernels`` line (path "rank_tp"; each must launch), and are timed
     at the per-rank shapes they ran at (RANK_TP_ROWS).

``python3 chip_smoke.py --rank-engine`` runs phase 16 alone; under
``torchrun --nproc-per-node 4`` (one rank a card, NCCL) the same flag runs
16(b)'s body once, each rank's answers held against numpy and a meshless
session on its own card. ``--rank-live`` does the same for phase 17
(under ``torchrun``: 17(b)'s scenario on one rank a card, every rank's
answers held against the numpy oracle on rank 0), and ``--rank-durable``
for phase 18 (under ``torchrun``: 18(b)'s crash matrix on one rank a card,
the store on the one host, every rank's reopened rows held against numpy),
and ``--rank-tp`` for phase 19 (under ``torchrun --nproc-per-node 4``: data
1 x model 4 over NCCL, one rank a card, each rank's families held to the
meshless runs it makes first on its own card).

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA card, or
without the rest of the repository beside it, the script exits non-zero
before printing any result.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100 SXM's data-sheet peaks: HBM3 bytes/s, float32 flop/s outside
    # the tensor cores, dense bf16 flop/s on them (one source with the
    # dry-run's hardware model)
    from repro_torch.launch.dryrun import FP32_FLOPS as FP32_OPS_PER_S
    from repro_torch.launch.dryrun import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.dryrun import PEAK_FLOPS as BF16_OPS_PER_S
except ImportError as e:   # the script alone, without the port beside it
    sys.exit(f"chip_smoke: the port is not beside this script ({e})")
ROUNDS = 3
ROWS = 5_000_000            # the paper's XL size (src/repro/data/wisconsin.py)
RELATIONAL = ("filter_count", "segment_agg", "block_topk", "topk_merge",
              "merge_join_count")
UDF_ROWS = 32_768           # tweets in demo.Tweets
UDF_SEQ = 128               # tokens per tweet: the usual cap for sentence
                            # classification
UDF_MICROBATCH = 2_048      # rows per model call
UDF_LAYERS = 8              # paper-lm (src/repro_torch/configs/paper_lm.py)
# Flash (the CUDA kernel) vs blocked (the plain path) logits of the 3
# classes differ by bf16 rounding in other places — up to a few 1e-2 over
# 8 layers; a row whose top-2 margin is within this may flip its argmax.
MARGIN = 0.1
DECODE_SHAPE = (32, 8, 4096, 64)   # B, H, S, D of the flash_decode checks
BREAKDOWN = ("3_filter_count", "9_sort_head", "11_range_count")
TRACE_TRIES = 6             # profiler traces taken before a kernel's absence fails
# flash_attention_bwd vs its plain version, each gradient's max abs error
# over its own largest |value|: float32 sums the same float32 terms in
# another order (up to 3.3e-6 measured); bf16 meets the second products
# with p and ds rounded to bf16 (up to 0.76% measured; NVIDIA H100 80GB
# HBM3, 700 W). A dropped head or a doubled dq is off by 34% to 100%.
BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BWD_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dq_wgmma_kernel",
               "flash_bwd_dkdv_wgmma_kernel")
BWD_F32_KERNELS = ("flash_bwd_delta_kernel", "flash_bwd_dq_f32_kernel",
                   "flash_bwd_dkdv_f32_kernel")   # the float32 route


def sass_counts(lib_path, kernels: tuple[str, ...]) -> dict:
    """HGMMA and UTMALDG instructions (wgmma, TMA loads) in the SASS of
    each named kernel of the built library, all its template instances
    summed, by ``cuobjdump -sass`` beside the nvcc that built it."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {k: {"HGMMA": 0, "UTMALDG": 0} for k in kernels}
    name = None
    for line in sass.splitlines():
        if "Function : " in line:
            name = next((k for k in kernels if k in line), None)
        elif name is not None:
            for op in ("HGMMA", "UTMALDG"):
                counts[name][op] += op in line
    return counts


def nvidia_smi(every: bool = False) -> str:
    """The first card's name and power limit (every card's, one a line,
    when ``every``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return "\n".join(lines) if every else lines[0]


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = FP32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn`` over ``iters`` back-to-back calls: the
    larger of the host's issue time and the device's time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


_START = time.perf_counter()


def phase_header(text: str, flush: bool = True) -> None:
    """A phase's header line, with the seconds since the script started
    (each phase's share of the script's time limit)."""
    print(f"{text} [{time.perf_counter() - _START:.1f} s in]", flush=flush)


def host_ms(fn, reps: int = 7) -> float:
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(fn, iters: int) -> list[tuple[str, float, int]]:
    """(name, device µs, records) of every CUDA kernel and copy in a
    torch.profiler trace of ``iters`` calls of ``fn``, after one call in the
    profiler's warm-up step. The trace may miss records: on the H100 one of
    20 calls of a kernel held 15-18 of them, so a per-call time is taken
    per record, and a sum of records is a lower bound. The schedule's
    ``ProfilerStep`` annotation carries the device time of everything in
    its step and is left out."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        prof.step()
    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]


def _per_call_ms(fn, kernels: tuple[str, ...] | None = None,
                 iters: int = 20) -> tuple[float, int, dict]:
    """Device ms per call of ``fn`` from a profiler trace of ``iters``
    calls, the fewest records any kernel held, and (given ``kernels``) the
    ms of each named kernel. Each kernel or copy
    (given ``kernels``, those whose name holds one of them) adds the mean of
    its records times its launches per call, its records ÷ ``iters`` rounded
    up: the trace may miss records but adds none, so a kernel launched once
    per call counts once however many records the trace lost. A trace on
    the H100 has held no record at all of a named kernel, three traces in
    a row once, so a trace that lacks one is taken again; raises if the
    last of ``TRACE_TRIES`` still lacks it."""
    for _ in range(TRACE_TRIES):
        rows = _profile(fn, iters)
        missing = [name for name in kernels or ()
                   if not any(name in key for key, _, _ in rows)]
        if not missing:
            break
    else:
        raise AssertionError(f"no {missing} in {TRACE_TRIES} profiler traces")
    def per_call(rows):
        return sum(us / n * math.ceil(n / iters) for _, us, n in rows) / 1e3

    parts = {name: per_call([r for r in rows if name in r[0]])
             for name in kernels or ()}
    if kernels is not None:
        rows = [r for r in rows if any(name in r[0] for name in kernels)]
    return per_call(rows), min((n for _, _, n in rows), default=0), parts


def device_ms(fn) -> float | None:
    """Device time of one call of ``fn``: every kernel and copy in its
    profiler trace (a lower bound where the trace misses records). Host
    issue time and idle gaps are not in it. None when the trace holds no
    such event."""
    ms = _per_call_ms(fn, None, 1)[0]
    return ms if ms > 0 else None


def single_call_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of one call of ``fn`` with the stream idle
    before and after it (launch latency included)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def smi_clocks() -> str:
    """The card's SM clock (now / max), power draw and temperature."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,"
                          "power.draw,temperature.gpu", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def same(got, want, label: str) -> None:
    """Equal values and dtypes (dict results), or equal Python scalars."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: columns {sorted(got)} != {sorted(want)}")
        for k in want:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            if a.dtype != b.dtype:
                raise AssertionError(f"{label}:{k} dtype {a.dtype} != {b.dtype}")
            np.testing.assert_array_equal(a, b, err_msg=f"{label}:{k}")
    elif type(got) is not type(want) or got != want:
        raise AssertionError(f"{label}: {got!r} != {want!r}")


# -- the paper's 12 expressions (literals drawn from rng) ---------------------

def _e3(df, x):
    return len(df[(df["ten"] == x) & (df["twentyPercent"] == x % 5)
                  & (df["two"] == x % 2)])


def _e11(df, a, b):
    return len(df[(df["onePercent"] >= min(a, b)) & (df["onePercent"] <= max(a, b))])


EXPRESSIONS = {
    "1_count": lambda df, dr, rng: len(df),
    "2_project_head": lambda df, dr, rng: df[["two", "four"]].head(),
    "3_filter_count": lambda df, dr, rng: _e3(df, int(rng.integers(10))),
    "4_group_count": lambda df, dr, rng: df.groupby("oddOnePercent").agg("count"),
    "5_map_head": lambda df, dr, rng: df["stringu1"].map(str.upper).head(),
    "6_max": lambda df, dr, rng: df["unique1"].max(),
    "7_min": lambda df, dr, rng: df["unique1"].min(),
    "8_group_max": lambda df, dr, rng: df.groupby("twenty")["four"].agg("max"),
    "9_sort_head": lambda df, dr, rng: df.sort_values("unique1", ascending=False).head(),
    "10_select_head": lambda df, dr, rng: df[df["ten"] == int(rng.integers(10))].head(),
    "11_range_count": lambda df, dr, rng: _e11(df, int(rng.integers(100)),
                                               int(rng.integers(100))),
    "12_join_count": lambda df, dr, rng: len(df.merge(dr, left_on="unique1",
                                                      right_on="unique1")),
}


def _groups(keys: np.ndarray, vals: np.ndarray | None, op: str) -> tuple:
    k, inv, counts = np.unique(keys, return_inverse=True, return_counts=True)
    if op == "count":
        return k, counts.astype(np.int32)
    out = np.full(len(k), np.iinfo(vals.dtype).min, vals.dtype)
    np.maximum.at(out, inv, vals)
    return k, out


def oracle(raw: dict, name: str, rng):
    """numpy answers in the engine's result form (as the benchmark's
    NumpyEager variant computes them, benchmarks/wisconsin_bench.py)."""
    if name == "1_count":
        return len(raw["unique1"])
    if name == "2_project_head":
        return {k: raw[k][:5] for k in ("two", "four")}
    if name == "3_filter_count":
        x = int(rng.integers(10))
        return int(((raw["ten"] == x) & (raw["twentyPercent"] == x % 5)
                    & (raw["two"] == x % 2)).sum())
    if name == "4_group_count":
        k, c = _groups(raw["oddOnePercent"], None, "count")
        return {"oddOnePercent": k, "count": c}
    if name == "5_map_head":
        col = raw["stringu1"][:5]
        return {"stringu1": np.where((col >= 97) & (col <= 122), col - 32, col)
                .astype(np.uint8)}
    if name == "6_max":
        return int(raw["unique1"].max())
    if name == "7_min":
        return int(raw["unique1"].min())
    if name == "8_group_max":
        k, m = _groups(raw["twenty"], raw["four"], "max")
        return {"twenty": k, "max_four": m}
    if name == "9_sort_head":
        order = np.argsort(-raw["unique1"].astype(np.int64), kind="stable")[:5]
        return {k: v[order] for k, v in raw.items()}
    if name == "10_select_head":
        rows = np.nonzero(raw["ten"] == int(rng.integers(10)))[0][:5]
        return {k: v[rows] for k, v in raw.items()}
    if name == "11_range_count":
        a, b = int(rng.integers(100)), int(rng.integers(100))
        lo, hi = min(a, b), max(a, b)
        return int(((raw["onePercent"] >= lo) & (raw["onePercent"] <= hi)).sum())
    if name == "12_join_count":
        r = np.sort(raw["unique1"])
        lk = raw["unique1"]
        return int((np.searchsorted(r, lk, "right") - np.searchsorted(r, lk, "left")).sum())
    raise KeyError(name)


_ORACLE_ROUNDS: dict = {}


# the expressions whose answers depend on the literals a round draws
DRAWN = ("3_filter_count", "10_select_head", "11_range_count")


def oracle_round(raw: dict, name: str, r: int):
    """``oracle`` with round ``r``'s literals (``default_rng(100 + r)``,
    as every phase draws them), computed once per table (and, for an
    expression without literals, once for every round) and kept: phases
    3, 9 and 16 hold their answers to the same numpy ones."""
    key = (id(raw), name, r if name in DRAWN else None)
    if key not in _ORACLE_ROUNDS:
        _ORACLE_ROUNDS[key] = oracle(raw, name, np.random.default_rng(100 + r))
    return _ORACLE_ROUNDS[key]


# -- phase 2: kernels against their plain versions ------------------------------

def check_kernels(raw: dict, dev) -> dict:
    """Every kernel vs its plain version on the card; returns per-kernel
    inputs at the main-path shape plus the largest error seen."""
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import ops
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    t = {k: torch.from_numpy(v).to(dev) for k, v in raw.items() if v.ndim == 1}
    n = len(raw["unique1"])
    rng = np.random.default_rng(7)
    cases: dict = {}

    def exact(label, got, want):
        g, w = got.cpu().numpy(), want.cpu().numpy()
        if g.dtype != w.dtype or not np.array_equal(g, w):
            raise AssertionError(f"{label}: kernel {g} != plain {w}")
        print(f"  {label}: exact", flush=True)

    # filter_count: expression 3 (3 columns) stacked and as the compiler
    # passes it (a column list), expression 11 (1 column), n_valid < n, a
    # clustered unique2 range with its surviving block list, a stacked
    # matrix whose rows sit at other 16-byte phases (n % 4 != 0: 4-byte
    # loads), and 17 columns (past the pointer struct) as a list (the
    # wrapper stacks it) and as a matrix
    e3_cols = [t["ten"], t["twentyPercent"], t["two"]]
    mat3 = torch.stack(e3_cols)
    b3 = torch.tensor([[4, 4], [4, 4], [0, 0]], dtype=torch.int32, device=dev)
    exact("filter_count e3 stacked", fc.filter_count(mat3, b3, n),
          fc.filter_count_plain(mat3, b3, n))
    exact("filter_count e3 column list", fc.filter_count(e3_cols, b3, n),
          fc.filter_count_plain(mat3, b3, n))
    exact("filter_count e3 column list, n_valid < n",
          fc.filter_count(e3_cols, b3, n - 12_345),
          fc.filter_count_plain(mat3, b3, n - 12_345))
    mat1 = t["onePercent"][None].contiguous()
    b1 = torch.tensor([[17, 58]], dtype=torch.int32, device=dev)
    exact("filter_count e11", fc.filter_count([t["onePercent"]], b1, n),
          fc.filter_count_plain(mat1, b1, n))
    lo2, hi2 = n // 3, n // 3 + min(50_000, n // 10)
    ids = tuple(range(lo2 // fc.BLOCK, hi2 // fc.BLOCK + 1))
    mat2 = t["unique2"][None].contiguous()
    b2 = torch.tensor([[lo2, hi2]], dtype=torch.int32, device=dev)
    exact("filter_count block_ids", fc.filter_count(mat2, b2, n, block_ids=ids),
          fc.filter_count_plain(mat2, b2, n, block_ids=ids))
    ragged = mat3[:, :n - 3].contiguous()
    if all(ragged[i].data_ptr() % 16 == 0 for i in range(3)):
        raise AssertionError("the ragged matrix's rows must sit at other phases")
    exact(f"filter_count stacked ({3}, {n - 3}) (4-byte loads)",
          fc.filter_count(ragged, b3, n - 3), fc.filter_count_plain(ragged, b3, n - 3))
    names17 = ["two", "four", "ten", "twenty", "onePercent", "tenPercent",
               "twentyPercent", "fiftyPercent", "evenOnePercent",
               "oddOnePercent", "unique1", "unique2", "unique3", "two",
               "four", "ten", "twenty"]
    cols17 = [t[c].to(torch.int32) for c in names17]
    b17 = torch.tensor([[0, 1], [0, 3], [0, 8], [0, 18], [0, 98], [0, 9],
                        [0, 4], [0, 1], [0, 198], [1, 199], [0, n], [0, n],
                        [0, n], [0, 1], [0, 3], [1, 8], [0, 18]],
                       dtype=torch.int32, device=dev)
    for label, cols in (("list", cols17), ("matrix", torch.stack(cols17))):
        exact(f"filter_count k = 17 (past the pointer cap), {label}",
              fc.filter_count(cols, b17, n - 5), fc.filter_count_plain(cols, b17, n - 5))
    # listed tiles that lie wholly past n_valid (n_valid % 4 != 0) count
    # nothing: every row passes, so a row counted twice shows (16-byte path,
    # a column list and a matrix)
    pass_all = [t["unique2"], t["two"]]
    b_all = torch.tensor([[0, n], [0, 1]], dtype=torch.int32, device=dev)
    last = (n - 1) // fc.BLOCK
    for label, cols in (("list", pass_all), ("matrix", torch.stack(pass_all))):
        for nv in (5, n - 4097):
            for ids in ((0, 3, last - 1, last), (last,)):
                exact(f"filter_count {label}, n_valid {nv}, block_ids {ids}",
                      fc.filter_count(cols, b_all, nv, block_ids=ids),
                      fc.filter_count_plain(cols, b_all, nv, block_ids=ids))
            arr = torch.tensor([3, -1, last, 0, -1], dtype=torch.int32, device=dev)
            exact(f"filter_count {label}, n_valid {nv}, block_ids_arr past it",
                  fc.filter_count(cols, b_all, nv, block_ids_arr=arr),
                  fc.filter_count_plain(cols, b_all, nv, block_ids_arr=arr))
    cases["filter_count"] = dict(args=(e3_cols, b3, n), k=3, n=n)

    # segment_agg: expression 4 (count over 199 groups), expression 8 (count
    # and max over 20 groups), block ids, and non-integer data
    gid4 = (t["oddOnePercent"] - 1).to(torch.int32)
    ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
    exact("segment_agg e4 sum", sa.segment_agg(ones, gid4, 199, n),
          sa.segment_agg_plain(ones, gid4, 199, n))
    gid8 = t["twenty"].to(torch.int32)
    four = t["four"].to(torch.float32)[:, None].contiguous()
    exact("segment_agg e8 max", sa.segment_agg(four, gid8, 20, n, op="max"),
          sa.segment_agg_plain(four, gid8, 20, n, op="max"))
    exact("segment_agg min", sa.segment_agg(four, gid8, 20, n - 999, op="min"),
          sa.segment_agg_plain(four, gid8, 20, n - 999, op="min"))
    multi = torch.stack([torch.ones(n, device=dev), t["four"].float(),
                         t["twenty"].float()], dim=1)
    gid10 = torch.where(t["unique2"] % 7 == 0, -1, t["ten"]).to(torch.int32)
    sids = ops._expand_block_ids(ids, ops.ZONE_BLOCK_ROWS, sa.BLOCK, n)
    exact("segment_agg multi-column, dead rows, block_ids",
          sa.segment_agg(multi, gid10, 10, n, block_ids=sids),
          sa.segment_agg_plain(multi, gid10, 10, n, block_ids=sids))
    normal = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32)).to(dev)
    got = sa.segment_agg(normal, gid4, 199, n)
    want = sa.segment_agg_plain(normal, gid4, 199, n)
    # float32 sums in two orders: within 1e-5 of each group's sum of |x|
    sum_abs = sa.segment_agg_plain(normal.abs(), gid4, 199, n)
    sa_err = float((got - want).abs().max())
    if not bool(((got - want).abs() <= 1e-5 * sum_abs + 1e-3).all()):
        raise AssertionError(f"segment_agg normal data: max abs err {sa_err}")
    print(f"  segment_agg normal data: max abs err {sa_err} "
          f"(tolerance 1e-5 * group sum|x| + 1e-3)", flush=True)
    # the ragged tail (n not a multiple of 4), operands off 16-byte
    # alignment (4-byte loads), G x C past a copy per lane (a copy per warp)
    # and past shared memory (the global path)
    m = n - 3
    exact(f"segment_agg n={m}, max", sa.segment_agg(four[:m], gid8[:m], 20, m, op="max"),
          sa.segment_agg_plain(four[:m], gid8[:m], 20, m, op="max"))
    exact("segment_agg off 16-byte alignment",
          sa.segment_agg(ones[1:], gid4[1:], 199, n - 1),
          sa.segment_agg_plain(ones[1:], gid4[1:], 199, n - 1))
    for G, where in ((1_000, "a copy per warp"), (100_000, "past shared memory")):
        gid_g = (t["unique1"] % G).to(torch.int32)
        for op in ("sum", "max"):
            exact(f"segment_agg G={G:,} x C=3 ({where}), {op}",
                  sa.segment_agg(multi, gid_g, G, n, op=op),
                  sa.segment_agg_plain(multi, gid_g, G, n, op=op))
    # -1-padded per-shard id lists through the ops (their only entry point
    # until the multi-device layer): pads mid-list and trailing, pads only
    pads = torch.full((3,), -1, dtype=torch.int32, device=dev)
    farr = torch.tensor([ids[0], -1, *ids[1:], -1, -1], dtype=torch.int32, device=dev)
    sarr = torch.tensor([sids[0], -1, *sids[1:], -1, -1], dtype=torch.int32, device=dev)
    for label, fa_, sa_ in (("pads mid-list and trailing", farr, sarr),
                            ("pads only", pads, pads)):
        exact(f"ops.filter_count block_ids_arr, {label}",
              ops.filter_count(mat2, b2, n, block_ids_arr=fa_),
              fc.filter_count_plain(mat2, b2, n, block_ids_arr=fa_))
        for op in ("sum", "max", "min"):
            exact(f"ops.segment_agg block_ids_arr, {label}, {op}",
                  ops.segment_agg(multi, gid10, 10, n - 5, op, block_ids_arr=sa_),
                  sa.segment_agg_plain(multi, gid10, 10, n - 5, op,
                                       block_ids_arr=sa_))
    cases["segment_agg"] = dict(args=(ones, gid4, 199, n), op="sum")
    cases["segment_agg_e8"] = dict(args=(four, gid8, 20, n), op="max")

    # block_topk: expression 9 (unique1, all live), deliberate ties with a
    # random mask at k = 8, a block with fewer than k live rows, k = 16 (the
    # largest register list) and 17 (the rounds kernel), n % 4 != 0 (a
    # ragged last tile), and scores and mask from offset views (off 16 and
    # 4 bytes: 4-byte and 1-byte loads)
    s9 = t["unique1"].to(torch.float32)
    live = torch.ones(n, dtype=torch.bool, device=dev)
    sparse = torch.zeros(n, dtype=torch.bool, device=dev)
    sparse[::5000] = True
    ties = t["ten"].to(torch.float32)
    tmask = torch.from_numpy(rng.random(n) > 0.3).to(dev)
    for label, args in [("e9", (s9, live, n, 5)),
                        ("ties, k = 8", (ties, tmask, n - 77, 8)),
                        ("<k live rows", (s9, sparse, n, 5)),
                        ("ties, k = 16", (ties, tmask, n, 16)),
                        ("ties, k = 17 (rounds kernel)", (ties, tmask, n - 9, 17)),
                        (f"n = {n - 3}", (s9[:n - 3], tmask[:n - 3], n - 3, 5)),
                        ("offset views", (ties[1:], tmask[1:], n - 1, 8)),
                        ("scores rising with the row (unique2)",
                         (t["unique2"].to(torch.float32), live, n, 5))]:
        v, i = tk.block_topk(*args)
        pv, pi = tk.block_topk_plain(*args)
        exact(f"block_topk {label} values", v, pv)
        exact(f"block_topk {label} indices", i, pi)
        # the merge: ties across tiles
        mv, mi = tk.merge_candidates(v, i)
        pmv, pmi = tk.merge_candidates_plain(v, i)
        exact(f"topk_merge {label} values", mv, pmv)
        exact(f"topk_merge {label} indices", mi, pmi)
    cases["block_topk"] = dict(args=(s9, live, n, 5), n=n, k=5)
    cases["block_topk_rising"] = dict(
        args=(t["unique2"].to(torch.float32), live, n, 5), n=n, k=5)

    # merge_join_count: expression 12 (unique keys; each side sorted into a
    # buffer of its own, as the compiler does) and duplicate-heavy keys
    ls = ops.sort_join_keys(t["unique1"], live)
    rs = ops.sort_join_keys(t["unique1"], live)
    nl = live.sum(dtype=torch.int32)
    exact("merge_join_count e12", mj.merge_join_count(ls, rs, nl, nl),
          mj.merge_join_count_plain(ls, rs, nl, nl))
    dup = ops.sort_join_keys(t["unique1"] % 50_000, live)
    dmask = torch.from_numpy(rng.random(n) > 0.5).to(dev)
    dup_r = ops.sort_join_keys(t["unique2"] % 40_000, dmask)
    nr = dmask.sum(dtype=torch.int32)
    exact("merge_join_count duplicates", mj.merge_join_count(dup, dup_r, nl, nr),
          mj.merge_join_count_plain(dup, dup_r, nl, nr))
    # one run longer than any shared-memory window (7e10 pairs: the int32
    # result wraps, as the plain version's int32 sum does), and prefixes
    # that stop inside runs and inside a left tile
    eq = torch.full((1_000_000,), 5, dtype=torch.int32, device=dev)
    exact("merge_join_count all keys equal", mj.merge_join_count(eq, eq[:70_000], 1_000_000, 70_000),
          mj.merge_join_count_plain(eq, eq[:70_000], 1_000_000, 70_000))
    runs = torch.sort(t["unique1"] % 300).values.to(torch.int32)
    cut_l, cut_r = n - 12_345, n // 5 + 3
    if cut_l % mj.tile() == 0 or runs[cut_l - 1] != runs[cut_l] \
            or runs[cut_r - 1] != runs[cut_r]:
        raise AssertionError("the prefixes must stop inside runs and a tile")
    exact("merge_join_count prefixes cutting runs",
          mj.merge_join_count(runs, runs, cut_l, cut_r),
          mj.merge_join_count_plain(runs, runs, cut_l, cut_r))
    cases["merge_join_count"] = dict(args=(ls, rs, nl, nl), n=n)
    cases["merge_join_dup"] = dict(args=(dup, dup_r, nl, nr), n=n)
    torch.cuda.synchronize()
    return cases


# -- phase 3: the slice ----------------------------------------------------------

def run_slice(table, raw: dict, dev) -> dict:
    import torch

    from repro_torch.core import physical as PH
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build

    catalog = Catalog()
    sessions = {m: Session(mode=m, device=dev, catalog=catalog)
                for m in ("kernel", "gspmd")}
    t0 = time.perf_counter()
    for name in ("data", "data_r"):
        sessions["kernel"].create_dataset(name, table, dataverse="bench")
    torch.cuda.synchronize()
    print(f"  datasets placed on {dev} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    def frames(m):
        s = sessions[m]
        return AFrame("bench", "data", session=s), AFrame("bench", "data_r", session=s)

    _build.reset_launches()
    physical, per_expr = {}, {}
    for name, fn in EXPRESSIONS.items():
        before = dict(_build.LAUNCHES)
        for r in range(ROUNDS):
            want = oracle_round(raw, name, r)
            for m in ("kernel", "gspmd"):
                got = fn(*frames(m), np.random.default_rng(100 + r))
                same(got, want, f"{name}[{m}] round {r}")
        physical[name] = type(sessions["kernel"].last_physical).__name__
        per_expr[name] = {k: (v - before[k]) // ROUNDS
                          for k, v in _build.LAUNCHES.items() if v > before[k]}
        print(f"  {name}: kernel == gspmd == numpy over {ROUNDS} rounds "
              f"({physical[name]}; kernel launches per run {per_expr[name]})",
              flush=True)

    # clustered unique2 ranges: the block-skipping kernel grids
    n = len(raw["unique2"])
    for r in range(ROUNDS):
        rng = np.random.default_rng(200 + r)
        width = min(300_000, n // 10)
        a = int(rng.integers(n - width))
        b = a + int(rng.integers(1, width))
        sel = (raw["unique2"] >= a) & (raw["unique2"] <= b)
        k_ten, c_ten = _groups(raw["ten"][sel], None, "count")
        plans = {}
        for m in ("kernel", "gspmd"):
            df, _ = frames(m)
            rows = df[(df["unique2"] >= a) & (df["unique2"] <= b)]
            same(len(rows), int(sel.sum()), f"unique2 range count[{m}] {r}")
            plans[m] = [sessions[m].last_physical]
            same(rows.groupby("ten").agg("count"), {"ten": k_ten, "count": c_ten},
                 f"unique2 range group count[{m}] {r}")
            plans[m].append(sessions[m].last_physical)
        cnt_plan, grp_plan = plans["kernel"]
        if not (isinstance(cnt_plan, PH.KernelRangeCount) and cnt_plan.block_ids
                and isinstance(grp_plan, PH.KernelSegmentAgg)
                and grp_plan.comp_blocks[0] is not None):
            raise AssertionError("clustered ranges did not take the block-skipping "
                                 "kernel paths")
    print(f"  unique2 ranges: block-skipping filter_count and segment_agg "
          f"({cnt_plan.blocks_scanned}/{cnt_plan.blocks_total} blocks in the "
          f"last round)", flush=True)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
    print(f"  kernel launches on the main path: {launches}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    def runner(fn, m):
        return lambda: fn(*frames(m), np.random.default_rng(1))

    # every wall time first: a profiler session left behind must not slow
    # the host clock runs
    times = {name: {m: {"wall_ms": host_ms(runner(fn, m))}
                    for m in ("kernel", "gspmd")}
             for name, fn in EXPRESSIONS.items()}
    for name, fn in EXPRESSIONS.items():
        for m, t in times[name].items():
            t["device_ms"] = device_ms(runner(fn, m))
            t["busy"] = None if t["device_ms"] is None \
                else t["device_ms"] / t["wall_ms"]
    return {"launches": launches, "per_expr": per_expr, "physical": physical,
            "expr_ms": times,
            "breakdowns": expr_breakdowns(lambda: frames("kernel"))}


# -- phase 2 (attention): the model zoo's kernels against their plain versions --

def check_attention_kernels(dev) -> dict:
    """flash_mha_fwd and flash_decode vs their plain versions on the card:
    at the model-UDF path's shape, the reference's sweep shapes, GQA at
    S=1024, a ragged S, and decode at B=32, S=4096 with lengths 0, 1, S.
    Returns the main-shape inputs and the largest error seen per kernel."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(8)
    tol = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
    errs = {"flash_mha_fwd": 0.0, "flash_decode": 0.0}

    # unit-variance inputs, as the projections give after RMS norm: the
    # scores (std 1 after the 1/sqrt(D) scale) then matter to the output
    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def row_close(got, want, t) -> bool:
        """|got - want| <= t * (|want| + the row's largest |want|): an
        attention output is a weighted mean of V, its scale falls with the
        length, so each row is held to its own."""
        g, w = got.float(), want.float()
        bound = t * (w.abs() + w.abs().amax(dim=-1, keepdim=True))
        return bool(torch.isfinite(g).all()) and bool(((g - w).abs() <= bound).all())

    def close(name, label, got, want, t, plain):
        """Kernel vs plain within ``t``; and the same check must refuse the
        plain version run on planted faults — q taken from the neighbouring
        head, and q = 0 (scores skipped) — or it could not see such a
        kernel fault."""
        err = float((got.float() - want.float()).abs().max())
        if not row_close(got, want, t):
            raise AssertionError(f"{name} {label}: kernel vs plain max abs err "
                                 f"{err} beyond {t} x row scale")
        for fault, bad in (("wrong q head", plain(lambda q: q.roll(1, dims=1))),
                           ("q = 0", plain(torch.zeros_like))):
            if row_close(bad, want, t):
                raise AssertionError(f"{name} {label}: the check passes a planted "
                                     f"fault ({fault})")
        errs[name] = max(errs[name], err)
        print(f"  {name} {label}: max abs err {err:.3g} (tolerance {t} x row "
              f"scale; planted faults refused)", flush=True)

    def flash(label, B, H, KV, S, D, dtype, causal, strided=False):
        if strided:  # the model path's layout: (B,H,S,D) views of (B,S,H,D)
            q = rand((B, S, H, D), dtype).transpose(1, 2)
            k, v = (rand((B, S, KV, D), dtype).transpose(1, 2) for _ in range(2))
        else:
            q = rand((B, H, S, D), dtype)
            k, v = rand((B, KV, S, D), dtype), rand((B, KV, S, D), dtype)
        out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
        pout, plse = fa.flash_mha_fwd_plain(q, k, v, causal=causal)
        close("flash_mha_fwd", f"{label} out", out, pout, tol[dtype],
              lambda f: fa.flash_mha_fwd_plain(f(q), k, v, causal=causal)[0])
        err = float((lse - plse).abs().max())
        if not bool(torch.isclose(lse, plse, rtol=tol[dtype], atol=tol[dtype]).all()):
            raise AssertionError(f"flash_mha_fwd {label} lse: max abs err {err}")
        errs["flash_mha_fwd"] = max(errs["flash_mha_fwd"], err)
        return q, k, v

    # the model-UDF path: one call per layer and microbatch, on the layout
    # attention_core hands over, then on contiguous inputs
    main = flash(f"main path ({UDF_MICROBATCH}, 8, {UDF_SEQ}, 64) bf16 causal, "
                 "strided (B,S,H,D) views", UDF_MICROBATCH, 8, 8, UDF_SEQ, 64,
                 torch.bfloat16, True, strided=True)
    contiguous = flash(f"main shape ({UDF_MICROBATCH}, 8, {UDF_SEQ}, 64) bf16 "
                       "causal, contiguous", UDF_MICROBATCH, 8, 8, UDF_SEQ, 64,
                       torch.bfloat16, True)
    for B, H, KV, S, D in [(1, 2, 2, 128, 16), (2, 4, 2, 256, 32),
                           (1, 8, 1, 64, 64), (2, 4, 2, 192, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                flash(f"sweep ({B},{H},{KV},{S},{D}) {str(dtype)[6:]} "
                      f"causal={causal}", B, H, KV, S, D, dtype, causal)
        flash(f"sweep ({B},{H},{KV},{S},{D}) bf16 causal, strided", B, H, KV,
              S, D, torch.bfloat16, True, strided=True)
    flash("GQA S=1024 bf16 causal", 4, 8, 2, 1024, 64, torch.bfloat16, True)
    flash("GQA S=1024 D=128 f32", 2, 8, 2, 1024, 128, torch.float32, False)
    flash("ragged S=1000 bf16 causal, strided", 3, 8, 8, 1000, 64,
          torch.bfloat16, True, strided=True)
    flash("ragged S=77 D=128 bf16, strided", 2, 4, 2, 77, 128, torch.bfloat16,
          False, strided=True)
    flash("ragged S=77 f32", 2, 4, 2, 77, 32, torch.float32, False)
    flash("B*H = 65,600 (past one grid dimension), strided", 8200, 8, 8, 16,
          16, torch.bfloat16, True, strided=True)
    # the serving path's prefill (phase 10): qwen3-1.7b's heads at the serve
    # prompt, on the layout attention_core hands over
    flash(f"serve prefill ({SERVE_BATCH}, 16, 8, {SERVE_PROMPT}, 128) bf16 "
          "causal, strided (B,S,H,D) views", SERVE_BATCH, 16, 8, SERVE_PROMPT,
          128, torch.bfloat16, True, strided=True)

    B, H, S, D = DECODE_SHAPE
    decode = {}
    for KV in (8, 2):
        split = da.split_size(B, KV, S)
        for dtype in (torch.bfloat16, torch.float32):
            q = rand((B, H, D), dtype)
            k, v = rand((B, KV, S, D), dtype), rand((B, KV, S, D), dtype)
            mixed = torch.randint(2, S, (B,), generator=gen, device=dev,
                                  dtype=torch.int32)
            edges = [0, 1, split - 1, split, split + 1, S - 1, S, 2 * split + 1]
            mixed[:len(edges)] = torch.tensor(edges, dtype=torch.int32, device=dev)
            full = torch.full((B,), S, dtype=torch.int32, device=dev)
            for label, lens in (("0/1/slice edges/S/random", mixed),
                                ("all S", full)):
                got = da.flash_decode(q, k, v, lens)
                close("flash_decode", f"(B={B}, H={H}, KV={KV}, S={S}, D={D}) "
                      f"{str(dtype)[6:]}, slices of {split}, lengths {label}",
                      got, da.flash_decode_plain(q, k, v, lens), tol[dtype],
                      lambda f, lens=lens: da.flash_decode_plain(f(q), k, v, lens))
            if KV == 8 and dtype == torch.bfloat16:
                decode = {"flash_decode": (q, k, v, full),
                          "flash_decode_mixed": (q, k, v, mixed)}

    # the serving path's layout (ROADMAP C4): k, v the (B,KV,S,D) views of a
    # layer's (B,S,KV,D) cache, q the (B,H,D) view of (B,1,H,D), at the
    # serve shape
    B, H, KV, D = SERVE_BATCH, 16, 8, 128
    S = SERVE_PROMPT + SERVE_NEW
    split = da.split_size(B, KV, S)
    for dtype in (torch.bfloat16, torch.float32):
        cache = rand((2, B, S, KV, D), dtype)
        k, v = cache[0].transpose(1, 2), cache[1].transpose(1, 2)
        q = rand((B, 1, H, D), dtype)[:, 0]
        lens = torch.tensor([0, 1, split - 1, split, split + 1, SERVE_PROMPT,
                             S - 1, S], dtype=torch.int32, device=dev)
        want = da.flash_decode_plain(q, k, v, lens)
        close("flash_decode", f"serve shape (B={B}, H={H}, KV={KV}, S={S}, "
              f"D={D}) {str(dtype)[6:]}, strided (B,S,KV,D) cache views, "
              f"lengths 0/1/slice edges/{SERVE_PROMPT}/S", da.flash_decode(q, k, v, lens),
              want, tol[dtype],
              lambda f, q=q, k=k, v=v, lens=lens: da.flash_decode_plain(f(q), k, v, lens))
    torch.cuda.synchronize()
    return {"flash_mha_fwd": main, "flash_mha_fwd_contiguous": contiguous,
            **decode, "errs": errs}


def check_flash_backward(dev) -> dict:
    """flash_attention_bwd (B7) against its plain version on the card:
    the reference's sweep shapes (D 16-128, float32 and bf16, causal and
    not), GQA at S=1024, ragged S on strided (B,S,H,D) views, the bf16
    kernels' tile edges (128-row blocks, 64-row streamed tiles: S = 129
    and 2,047 at D 128; G = 8 heads a KV head at S 1,024), and the
    training shape (B 4, H 16, KV 8, S 2,048, D 128, bf16 causal, strided).
    Unit-scale inputs; each of dq, dk, dv within BWD_TOL x its own largest
    |value|; the same check must refuse the plain version run with two
    planted faults (dk and dv without the terms of one q head of its
    group, and dq at twice its scale), and a second launch must give the
    same bits (no atomics). Returns the training shape's operands and the
    largest error relative to scale."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(21)
    worst = 0.0

    def rand(shape, dtype, strided):
        if strided:  # (B,H,S,D) views of (B,S,H,D), as attention_core hands over
            b, h, s, d = shape
            return torch.randn((b, s, h, d), generator=gen, device=dev) \
                .to(dtype).transpose(1, 2)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def rel_errs(got, want):
        return [float((g.float() - w.float()).abs().max())
                / float(w.float().abs().max()) for g, w in zip(got, want)]

    def case(label, B, H, KV, S, D, dtype, causal, strided=False):
        nonlocal worst
        q, do = rand((B, H, S, D), dtype, strided), rand((B, H, S, D), dtype, strided)
        k, v = rand((B, KV, S, D), dtype, strided), rand((B, KV, S, D), dtype, strided)
        out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        again = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=causal)
        tol = BWD_TOL[str(dtype)[6:]]
        errs = rel_errs(got, want)
        if not all(torch.isfinite(g).all() for g in got) or max(errs) > tol:
            raise AssertionError(f"flash_attention_bwd {label}: dq, dk, dv "
                                 f"errors {errs} x scale beyond {tol}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd {label}: two launches differ")
        dropped = do.clone()
        dropped[:, H // KV - 1] = 0  # the group's last head: gone from dk, dv
        bad = fa.flash_attention_bwd_plain(q, k, v, out, lse, dropped,
                                           causal=causal)
        faults = {"dk, dv without one head of the group": max(rel_errs(bad[1:], want[1:])),
                  "dq at twice its scale": rel_errs([2 * want[0]], want[:1])[0]}
        if min(faults.values()) <= tol:
            raise AssertionError(f"flash_attention_bwd {label}: the check passes "
                                 f"a planted fault: {faults}")
        worst = max(worst, *errs)
        print(f"  flash_attention_bwd {label}: dq, dk, dv max abs err "
              + ", ".join(f"{e:.3g}" for e in errs) + f" x scale (tolerance {tol}; "
              "planted faults " + ", ".join(f"{e:.3g}" for e in faults.values())
              + "; repeat bit-equal)", flush=True)
        return q, k, v, out, lse, do

    for B, H, KV, S, D in [(1, 2, 2, 128, 16), (2, 4, 2, 256, 32),
                           (1, 8, 1, 64, 64), (2, 4, 2, 192, 128)]:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                case(f"sweep ({B},{H},{KV},{S},{D}) {str(dtype)[6:]} "
                     f"causal={causal}", B, H, KV, S, D, dtype, causal)
    case("GQA S=1024 bf16 causal", 2, 8, 2, 1024, 64, torch.bfloat16, True)
    case("GQA S=1024 D=128 f32", 2, 8, 2, 1024, 128, torch.float32, False)
    case("ragged S=1000 bf16 causal, strided", 3, 8, 8, 1000, 64,
         torch.bfloat16, True, strided=True)
    case("ragged S=77 D=128 bf16, strided", 2, 4, 2, 77, 128, torch.bfloat16,
         False, strided=True)
    case("ragged S=77 f32 causal", 2, 4, 2, 77, 32, torch.float32, True)
    case("tile edge S=129 D=128 bf16 causal, strided", 2, 4, 2, 129, 128,
         torch.bfloat16, True, strided=True)
    case("tile edge S=2047 D=128 bf16 causal, strided", 1, 16, 8, 2047, 128,
         torch.bfloat16, True, strided=True)
    case("G=8 (H 8, KV 1) S=1024 D=128 bf16 causal, strided", 2, 8, 1, 1024,
         128, torch.bfloat16, True, strided=True)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    train = case(f"training shape ({B}, 16, 8, {S}, 128) bf16 causal, strided "
                 "(B,S,H,D) views", B, 16, 8, S, 128, torch.bfloat16, True,
                 strided=True)
    torch.cuda.synchronize()
    return {"flash_attention_bwd": train, "err": worst}


# -- phase 4: the model-UDF slice ----------------------------------------------------

def _persist_groupby(df):
    neg = df[df["sentiment"] == 0][["id", "hour", "sentiment"]]
    saved = neg.persist("negTweets")
    return saved, saved.groupby("hour").agg("count")


def run_udf_slice(dev, seed: int) -> dict:
    """The paper's Figs. 4-6 on the port: paper-lm at full width with
    flash attention, registered as a 3-class sentiment UDF, applied inside
    kernel-mode queries over demo.Tweets."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import physical as PH
    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session
    from repro_torch.engine.table import Table
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as ttf
    from repro_torch.udf import model_udf

    cfg = dataclasses.replace(get_config("paper-lm"), attn_impl="flash")
    if cfg.n_layers != UDF_LAYERS:
        raise AssertionError(f"paper-lm has {cfg.n_layers} layers")
    t0 = time.perf_counter()
    model = ttf.init_lm(cfg, torch.Generator(device=dev).manual_seed(seed))
    rng = np.random.default_rng(seed)
    cols = {"id": np.arange(UDF_ROWS, dtype=np.int32),
            "text_tokens": rng.integers(0, cfg.vocab, (UDF_ROWS, UDF_SEQ),
                                        dtype=np.int32),
            "hour": rng.integers(0, 24, UDF_ROWS, dtype=np.int32)}
    model_udf.clear_registry()
    model_udf.register_model("sentiment", model, cfg, classes=3,
                             microbatch=UDF_MICROBATCH)
    sess = Session(mode="kernel", device=dev)
    sess.create_dataset("Tweets", Table(cols), dataverse="demo")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  paper-lm ({n_params:,} parameters, attn_impl=flash) and "
          f"{UDF_ROWS} x {UDF_SEQ} tokens on {dev} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def frame():
        df = AFrame("demo", "Tweets", session=sess)
        df["sentiment"] = df["text_tokens"].map("sentiment")
        return df

    def count_negative():
        df = frame()
        return len(df[df["sentiment"] == 0])

    queries = {"1_map_head": lambda: frame().head(5),
               "2_count_negative": count_negative,
               "3_persist_groupby": lambda: _persist_groupby(frame())}

    passes = UDF_LAYERS * -(-UDF_ROWS // UDF_MICROBATCH)
    _build.reset_launches()
    head = queries["1_map_head"]()
    opt = sess.last_optimized
    flash_q1 = _build.LAUNCHES["flash_mha_fwd"]
    n_neg = queries["2_count_negative"]()
    flash_q2 = _build.LAUNCHES["flash_mha_fwd"] - flash_q1
    seg_before = _build.LAUNCHES["segment_agg"]
    saved, by_hour = queries["3_persist_groupby"]()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    grp_plan = sess.last_physical
    print(f"  kernel launches on the model-UDF path: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    if not (isinstance(opt, P.Project) and isinstance(opt.children[0], P.Limit)):
        raise AssertionError("head(5) did not put the model above the limit")
    if flash_q1 != UDF_LAYERS or flash_q2 != passes:
        raise AssertionError(f"flash_mha_fwd launches: head {flash_q1} (want "
                             f"{UDF_LAYERS}), full pass {flash_q2} (want {passes})")
    if launches["segment_agg"] == seg_before or not isinstance(
            grp_plan, PH.KernelSegmentAgg):
        raise AssertionError("the group-by on the persisted set did not run "
                             "segment_agg")

    # checks, outside the counted run
    tokens = sess.catalog.get("demo", "Tweets").table.columns["text_tokens"]
    direct = model_udf.get_udf("sentiment")(tokens).cpu().numpy()
    same({"sentiment": head["sentiment"]}, {"sentiment": direct[:5]},
         "head(5) predictions")
    if not np.all((direct >= 0) & (direct < 3)):
        raise AssertionError("predictions outside [0, 3)")
    same(n_neg, int((direct == 0).sum()), "count of sentiment == 0")
    got = saved.collect()
    same(got, {"id": np.nonzero(direct == 0)[0].astype(np.int32),
               "hour": cols["hour"][direct == 0],
               "sentiment": np.zeros(n_neg, np.int32)}, "persisted negTweets")
    k, c = np.unique(cols["hour"][direct == 0], return_counts=True)
    same(by_hour, {"hour": k.astype(np.int32), "count": c.astype(np.int32)},
         "group-by count of negTweets")
    print(f"  {n_neg} of {UDF_ROWS} rows predicted class 0; persisted count, "
          f"ids and per-hour counts equal the direct application and numpy",
          flush=True)

    # flash (CUDA kernel) vs blocked (the plain path, the reference's default)
    blocked = dataclasses.replace(cfg, attn_impl="blocked")
    with torch.no_grad():
        logits = torch.cat([
            ttf.lm_prefill(model, {"tokens": tokens[s:s + UDF_MICROBATCH]},
                           blocked, cache=False)[1][:, -1, :3]
            for s in range(0, UDF_ROWS, UDF_MICROBATCH)]).cpu().numpy()
    if not np.isfinite(logits).all():
        raise AssertionError("blocked-attention logits not finite")
    top = np.sort(logits, axis=1)
    margin = top[:, 2] - top[:, 1]
    pred_blocked = logits.argmax(axis=1).astype(np.int32)
    differ = direct != pred_blocked
    near = margin <= MARGIN
    if np.any(differ & ~near):
        raise AssertionError(f"flash vs blocked: {int((differ & ~near).sum())} "
                             f"rows differ with a margin above {MARGIN}")
    print(f"  flash vs blocked attention: {int(differ.sum())} of {UDF_ROWS} "
          f"predictions differ, all among the {int(near.sum())} rows whose "
          f"top-2 margin is within {MARGIN}", flush=True)
    return {"queries": queries, "launches": launches, "n_neg": n_neg,
            "flash_per_pass": flash_q2, "rows_near_margin": int(near.sum()),
            "rows_differ": int(differ.sum())}


# -- phase 6: live ingestion (LSM runs, upserts and deletes, a view) -----------

LIVE_BATCH = 250_000        # rows per batch, one flush each
# a fixed order of 4 pushes, 2 upserts and 2 deletes, so that each mutation
# kind lands twice behind fresh matter (none of benchmarks/ingest_bench.py's
# MUTATION_WORKLOADS: those draw 1/0/0, 0.4/0.6/0 or 0.4/0.2/0.4 by seed)
LIVE_MIX = ("push", "upsert", "push", "delete", "push", "upsert", "push",
            "delete")
LIVE_DIM_ROWS = 500         # the Dim table of tests/test_lsm.py
LIVE_BREAKDOWN = ("3_filter_count", "group_mix")  # device time by kernel


class LiveOracle:
    """Newest-wins numpy oracle of the fed dataset: its visible rows in the
    engine's stream order (component by component, each clustered by
    unique2; one unique2 order after a compaction)."""

    def __init__(self, raw: dict):
        self.cols = {k: v.copy() for k, v in raw.items()}

    def _keep(self, mask):
        self.cols = {k: v[mask] for k, v in self.cols.items()}

    def apply(self, kind: str, batch):
        if kind == "delete":
            self._keep(~np.isin(self.cols["unique2"], batch))
            return
        if kind == "upsert":
            self._keep(~np.isin(self.cols["unique2"], batch["unique2"]))
        order = np.argsort(batch["unique2"], kind="stable")  # the run's order
        self.cols = {k: np.concatenate([v, batch[k][order]])
                     for k, v in self.cols.items()}

    def compact(self):
        self._keep(np.argsort(self.cols["unique2"], kind="stable"))


def _live_groups(keys, vals=None, op="count", out_dtype=None):
    k, inv, n = np.unique(keys, return_inverse=True, return_counts=True)
    if op == "count":
        return k, n.astype(np.int32)
    if op == "sum":
        return k, np.bincount(inv, weights=vals, minlength=len(k)).astype(vals.dtype)
    if op == "mean":
        s = np.bincount(inv, weights=vals, minlength=len(k))
        return k, s.astype(np.float32) / n.astype(np.float32)
    fill = np.iinfo(vals.dtype).min if op == "max" else np.iinfo(vals.dtype).max
    out = np.full(len(k), fill, vals.dtype)
    (np.maximum if op == "max" else np.minimum).at(out, inv, vals)
    return k, out


LIVE_QUERIES = {  # tests/test_lsm.py's _query_suite, then e3, e4, e8, e11
    "len": lambda df, dim: len(df),
    "filter_count": lambda df, dim: len(df[(df["ten"] == 3) & (df["two"] == 1)]),
    "indexed_range": lambda df, dim: len(df[(df["onePercent"] >= 10)
                                            & (df["onePercent"] <= 30)]),
    "group_count": lambda df, dim: df.groupby("ten").agg("count"),
    "group_mix": lambda df, dim: df.groupby("twenty").agg(
        {"four": "sum", "ten": "mean", "two": "max", "onePercent": "min"}),
    "scalar_max": lambda df, dim: df["unique2"].max(),
    "scalar_min": lambda df, dim: df["unique1"].min(),
    "scalar_sum": lambda df, dim: df["four"].sum(),
    "sort_head": lambda df, dim: df.sort_values("unique1", ascending=False).head(7),
    "head": lambda df, dim: df.head(5),
    "join_count": lambda df, dim: len(df.merge(dim, left_on="unique1",
                                               right_on="unique1")),
    "project_head": lambda df, dim: df[["two", "four", "stringu1"]].head(4),
    "3_filter_count": lambda df, dim: _e3(df, 3),
    "4_group_count": lambda df, dim: df.groupby("oddOnePercent").agg("count"),
    "8_group_max": lambda df, dim: df.groupby("twenty")["four"].agg("max"),
    "11_range_count": lambda df, dim: _e11(df, 17, 62),
}


def live_oracle(c: dict, dim_unique1: np.ndarray) -> dict:
    """numpy answers of LIVE_QUERIES in the engine's result form."""
    def group(key, spec):
        out = {}
        for col, op in spec:
            k, v = _live_groups(c[key], None if col is None else c[col], op)
            out[key] = k
            out["count" if col is None else f"{op}_{col}"] = v
        return out

    top = np.argsort(-c["unique1"].astype(np.int64), kind="stable")[:7]
    return {
        "len": len(c["unique2"]),
        "filter_count": int(((c["ten"] == 3) & (c["two"] == 1)).sum()),
        "indexed_range": int(((c["onePercent"] >= 10) & (c["onePercent"] <= 30)).sum()),
        "group_count": group("ten", [(None, "count")]),
        "group_mix": group("twenty", [("four", "sum"), ("ten", "mean"),
                                      ("two", "max"), ("onePercent", "min")]),
        "scalar_max": int(c["unique2"].max()),
        "scalar_min": int(c["unique1"].min()),
        "scalar_sum": int(c["four"].sum()),
        "sort_head": {k: v[top] for k, v in c.items()},
        "head": {k: v[:5] for k, v in c.items()},
        "join_count": int(np.isin(c["unique1"], dim_unique1).sum()),
        "project_head": {k: c[k][:4] for k in ("two", "four", "stringu1")},
        "3_filter_count": int(((c["ten"] == 3) & (c["twentyPercent"] == 3)
                               & (c["two"] == 1)).sum()),
        "4_group_count": group("oddOnePercent", [(None, "count")]),
        "8_group_max": group("twenty", [("four", "max")]),
        "11_range_count": int(((c["onePercent"] >= 17) & (c["onePercent"] <= 62)).sum()),
    }


def _live_batch(kind: str, i: int, rng, oracle: LiveOracle, next_key: int):
    """One batch of the mix: pushes are fresh Wisconsin rows keyed past
    every earlier key; upserts and deletes draw LIVE_BATCH distinct keys
    from the visible ones."""
    from repro_torch.data import wisconsin

    if kind == "delete":
        return np.sort(rng.choice(oracle.cols["unique2"], LIVE_BATCH,
                                  replace=False)).astype(np.int32)
    rows = {k: v.numpy() for k, v in
            wisconsin.generate(LIVE_BATCH, seed=100 + i).columns.items()}
    if kind == "push":
        rows["unique2"] = (rows["unique2"] + next_key).astype(np.int32)
    else:
        rows["unique2"] = rng.choice(oracle.cols["unique2"], LIVE_BATCH,
                                     replace=False).astype(np.int32)
    return rows


def _flush_seconds() -> float:
    from repro_torch.runtime import telemetry as tel

    key = tel.series_key("ingest.flush_seconds", {"dataset": "live.Live"})
    h = tel.snapshot(include_spans=False)["histograms"].get(key)
    return 0.0 if h is None else h["sum"]


def check_matter_column(run, base, shadow_of) -> None:
    """filter_count against its plain version on the card in the shape the
    compiler passes: predicate columns plus the matter column (valid ∧ not
    shadowed) of a delete run (anti rows after the matter prefix, block
    padding) and of the shadowed base, at n_valid = n, the matter + anti
    prefix and one not a multiple of 4."""
    import torch

    from repro_torch.core.compiler import _shadowed
    from repro_torch.kernels import filter_count as fc

    for comp in (run, base):
        t = comp.table.columns
        n = int(t["ten"].shape[0])
        matter = t["__valid__"] if "__valid__" in t \
            else torch.ones(n, dtype=torch.bool, device=t["ten"].device)
        sources = shadow_of(comp)
        if sources:
            tables = {f"anti:live.{s.name}": s.anti_keys_arr for s in sources}
            matter = matter & ~_shadowed(
                tables, t["unique2"], [("live", s.name) for s in sources])
        cols = [t["ten"], t["two"], matter.to(torch.int32)]
        bounds = torch.tensor([[3, 3], [1, 1], [1, 1]], dtype=torch.int32,
                              device=cols[0].device)
        prefix = (comp.live_rows or n) + comp.anti_rows
        for n_valid in sorted({n, prefix, prefix - 1, n - 3}):
            got = fc.filter_count(cols, bounds, n_valid)
            want = fc.filter_count_plain(cols, bounds, n_valid)
            same(int(got), int(want), f"filter_count matter column "
                 f"{comp.name} n_valid={n_valid}")
        print(f"  filter_count with the matter column == plain on {comp.name} "
              f"({n} rows, {comp.anti_rows} anti rows after the matter prefix, "
              f"n_valid {sorted({n, prefix, prefix - 1, n - 3})})", flush=True)


@contextlib.contextmanager
def recording(calls: list):
    """Record every call the path makes of filter_count, segment_agg, the
    top-k (block_topk and its merge) and merge_join_count — its inputs and
    the wrapper's output, by reference — so that the plain versions can be
    held against them afterwards on the very same card tensors. Adds no
    launch."""
    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    held = [(fc, "filter_count"), (sa, "segment_agg"), (tk, "topk_merge"),
            (mj, "merge_join_count")]
    orig = [getattr(mod, name) for mod, name in held]

    def wrap(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            calls.append((name, args, kw, out))
            return out
        return rec

    for (mod, name), fn in zip(held, orig):
        setattr(mod, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(held, orig):
            setattr(mod, name, fn)


def check_recorded(calls: list, state: str, need: tuple) -> None:
    """Each recorded wrapper output against its plain version on the same
    inputs, exact (values and dtypes): filter_count, segment_agg,
    block_topk (called again on the recorded scores and mask) and its
    merge, merge_join_count. Fails if a kernel of ``need`` was never
    called."""
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    def exact(label, got, want):
        if got.dtype != want.dtype or not torch.equal(got, want):
            bad = (got != want).sum().item() if got.shape == want.shape else "shape"
            raise AssertionError(f"{label} {state}: wrapper != plain "
                                 f"({got.dtype} vs {want.dtype}, {bad} differ)")

    shapes: dict[str, set] = {}
    rows: list = []  # segment_agg's (n, rows with gid -1)
    for i, (name, args, kw, out) in enumerate(calls):
        label = f"{name} call {i}"
        if name == "filter_count":
            cols, bounds, n_valid = args
            exact(label, out, fc.filter_count_plain(cols, bounds, n_valid, **kw))
            ids, arr = kw.get("block_ids"), kw.get("block_ids_arr")
            blocks = "all" if ids is None else len(ids)
            if arr is not None:
                blocks = f"row of {arr.shape[0]}, {int((arr >= 0).sum())} live"
            shapes.setdefault(name, set()).add(
                f"k={len(cols)} n={fc.num_rows(cols):,} blocks {blocks}")
        elif name == "segment_agg":
            values, gids, g, n_valid = args
            exact(label, out, sa.segment_agg_plain(values, gids, g, n_valid, **kw))
            shapes.setdefault(name, set()).add(
                f"{kw.get('op', 'sum')} G={g} C={values.shape[1]}")
            rows.append((int(values.shape[0]), int((gids < 0).sum())))
        elif name == "topk_merge":
            scores, mask, n_valid, k = args
            bv, bi = tk.block_topk(scores, mask, n_valid, k)
            pv, pi = tk.block_topk_plain(scores, mask, n_valid, k)
            exact(label + " block_topk values", bv, pv)
            exact(label + " block_topk indices", bi, pi)
            mv, mi = tk.merge_candidates_plain(pv, pi)
            exact(label + " merge values", out[0], mv)
            exact(label + " merge indices", out[1], mi)
            shapes.setdefault(name, set()).add(
                f"n={scores.shape[0]:,} live={int(mask.sum()):,} k={k}")
        else:
            lk, rk, nl, nr = args
            exact(label, out, mj.merge_join_count_plain(lk, rk, nl, nr))
            shapes.setdefault(name, set()).add(
                f"left {lk.shape[0]:,} (valid {int(nl):,}) right "
                f"{rk.shape[0]:,} (valid {int(nr):,})")
    missing = [k for k in need if k not in shapes]
    if missing:
        raise AssertionError(f"{state}: the path never called {missing}")
    for name, s in shapes.items():
        extra = "" if name != "segment_agg" else \
            (f"; n {min(r[0] for r in rows):,} to {max(r[0] for r in rows):,},"
             f" gid -1 on {sum(r[1] for r in rows):,} of "
             f"{sum(r[0] for r in rows):,} rows")
        print(f"  {name} == plain {state}, {sum(c[0] == name for c in calls)} "
              f"call(s): {'; '.join(sorted(s))}{extra}", flush=True)


def ingest(feed, oracle: LiveOracle, rng, card: str, after=None) -> list:
    """The eight batches of LIVE_MIX, one flush each; the wall time of each
    batch and the flush's own share of it. ``after(i)`` runs after batch i,
    outside the times."""
    import torch

    next_key, flushes = ROWS, []
    for i, kind in enumerate(LIVE_MIX):
        batch = _live_batch(kind, i, rng, oracle, next_key)
        if kind == "push":
            next_key += LIVE_BATCH
        f0 = _flush_seconds()
        t0 = time.perf_counter()
        getattr(feed, kind)(batch)
        feed.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        oracle.apply(kind, batch)
        flushes.append({"kind": kind, "wall_s": wall,
                        "flush_s": _flush_seconds() - f0})
        print(f"  [{card}] batch {i + 1} ({kind}, {LIVE_BATCH} rows): "
              f"{wall:.3f} s, of which the flush {flushes[-1]['flush_s']:.3f} s",
              flush=True)
        if after is not None:
            after(i)
    return flushes


def run_live(table, raw: dict, dev, seed: int, card: str,
             strings_hook=None) -> dict:
    """Phase 6: the live-ingestion slice on the card. The phase-3 table
    (closed, clustered by unique2, onePercent indexed) takes eight batches
    of LIVE_BATCH rows in LIVE_MIX order, one flush each, under a deferred
    compaction policy (nine components), with a group-by view registered
    before the first batch. The query suite runs through a kernel-mode
    session, a gspmd reader session over the same catalog and the numpy
    oracle, before and after the compaction; all three agree bit for bit.
    ``strings_hook(state, kern, gspmd, oracle)`` (phase 7's live part) runs
    over nine components and after the compaction; its launches are its
    own."""
    import torch

    from repro_torch.core import physical as PH
    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build

    rng = np.random.default_rng(seed)
    kern = Session(mode="kernel", device=dev)
    gspmd = Session(mode="gspmd", device=dev, catalog=kern.catalog)
    t0 = time.perf_counter()
    kern.create_dataset("Live", table, dataverse="live", closed=True,
                        primary="unique2", indexes=["onePercent"])
    dim = wisconsin.generate(LIVE_DIM_ROWS, seed=7)
    kern.create_dataset("Dim", dim, dataverse="live")
    torch.cuda.synchronize()
    print(f"  [{card}] Live ({ROWS} rows, primary unique2, index onePercent) "
          f"and Dim placed in {time.perf_counter() - t0:.3f} s", flush=True)
    dim_u1 = dim.columns["unique1"].numpy()
    view_plan = P.GroupAgg(P.Scan("Live", "live"), ["ten"], [
        P.AggSpec("count", "count", None), P.AggSpec("sum_four", "sum", "four"),
        P.AggSpec("max_onePercent", "max", "onePercent")])
    view = kern.create_view("by_ten", view_plan)
    feed = Feed(kern, "Live", "live", flush_rows=LIVE_BATCH,
                policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
    oracle = LiveOracle(raw)

    def frames(sess):
        return (AFrame("live", "Live", session=sess),
                AFrame("live", "Dim", session=sess))

    def join_over_union(i):
        """The join count with the union of base and runs on the left, after
        the third batch (base, push, upsert, push): each component then
        holds matter, so the key bounds of every leaf prove int32 safety and
        the planner takes merge_join_count. A delete-only run has no key
        bounds, and from the first delete on the planner (as the reference's
        does) takes the generic join until the compaction."""
        if i != 2:
            return
        want = live_oracle(oracle.cols, dim_u1)["join_count"]
        for m, sess in (("gspmd", gspmd), ("kernel", kern)):
            before = _build.LAUNCHES["merge_join_count"]
            got = LIVE_QUERIES["join_count"](*frames(sess))
            torch.cuda.synchronize()
            same(got, want, f"live join_count[{m}] over 4 components")
        plan = kern.last_physical
        if not (isinstance(plan, PH.JoinCountOp) and plan.kernel
                and isinstance(plan.children[0], PH.PrunedUnionRuns)) \
                or _build.LAUNCHES["merge_join_count"] != before + 1:
            raise AssertionError(f"join count over 4 components: "
                                 f"{PH.format_plan(plan)}")
        print(f"  join count over 4 components (a union on the left): "
              f"kernel == gspmd == numpy, one merge_join_count launch",
              flush=True)

    _build.reset_launches()
    ingest_calls: list = []
    with recording(ingest_calls):
        flushes = ingest(feed, oracle, rng, card, after=join_over_union)
    comps = kern.catalog.components("live", "Live")
    if len(comps) != 1 + len(LIVE_MIX) or feed.stats["compactions"]:
        raise AssertionError(f"expected {1 + len(LIVE_MIX)} components, got "
                             f"{len(comps)} ({feed.stats})")

    def suite(state):
        want = live_oracle(oracle.cols, dim_u1)
        got = {}
        for name, fn in LIVE_QUERIES.items():
            for m, sess in (("kernel", kern), ("gspmd", gspmd)):
                got[m] = fn(*frames(sess))
                same(got[m], want[name], f"live {name}[{m}] {state}")
        return want

    def launches_per_component(state, comps):
        """The fused range count launches filter_count once per component
        holding matter (a delete-only run has no matter, so no bounds prove
        the int32 cast: it takes the mask path, as the reference plans it);
        the group count launches segment_agg once per component."""
        df, _ = frames(kern)
        matter = sum(1 for c in comps if c.live_rows is None or c.live_rows)
        for query, kernel, want in (
                (lambda: len(df[(df["ten"] == 3) & (df["two"] == 1)]),
                 "filter_count", matter),
                (lambda: df.groupby("ten").agg("count"), "segment_agg",
                 len(comps))):
            before = _build.LAUNCHES[kernel]
            query()
            torch.cuda.synchronize()
            got = _build.LAUNCHES[kernel] - before
            if got != want:
                raise AssertionError(f"{kernel}: {got} launches over "
                                     f"{len(comps)} component(s) {state}, "
                                     f"expected {want}")
        plan = kern.last_physical
        if not isinstance(plan, PH.KernelSegmentAgg) \
                or len(plan.children) != len(comps):
            raise AssertionError(f"group count {state}: {type(plan).__name__}")
        print(f"  {state}: filter_count launched once per component with "
              f"matter ({matter} of {len(comps)}), segment_agg once per "
              f"component ({len(comps)})", flush=True)

    def check_view(state):
        same(kern.read_view("by_ten"), kern.execute(view_plan),
             f"view vs recompute {state}")
        c = oracle.cols
        k, n = _live_groups(c["ten"])
        same(kern.read_view("by_ten"),
             {"ten": k, "count": n,
              "sum_four": _live_groups(c["ten"], c["four"], "sum")[1],
              "max_onePercent": _live_groups(c["ten"], c["onePercent"], "max")[1]},
             f"view vs numpy {state}")

    excluded = dict.fromkeys(_build.LAUNCHES, 0)  # comparisons and timings

    def excluding(fn, *args):
        held = dict(_build.LAUNCHES)
        out = fn(*args)
        torch.cuda.synchronize()
        for k, v in _build.LAUNCHES.items():
            excluded[k] += v - held[k]
        return out

    suite_calls: list = []
    with recording(suite_calls):
        before = suite("over 9 components")
    launches_per_component("over 9 components", comps)
    check_view("over 9 components")

    def shadow_of(comp):
        return [r for r in comps[comps.index(comp) + 1:] if r.anti_rows]
    excluding(check_matter_column, comps[2], comps[0], shadow_of)
    excluding(check_recorded, ingest_calls,
              "in the ingest (view deltas, join over 4 components)",
              ("segment_agg", "merge_join_count"))
    excluding(check_recorded, suite_calls, "over 9 components",
              ("filter_count", "segment_agg", "topk_merge"))
    del ingest_calls[:], suite_calls[:]
    hooked = {}
    if strings_hook is not None:
        hooked["uncompacted"] = strings_hook("over 9 components", kern, gspmd,
                                             oracle)

    def time_queries():
        out = {}
        for name, fn in LIVE_QUERIES.items():
            out[name] = {m: {"wall_ms": host_ms(lambda: fn(*frames(s)))}
                         for m, s in (("kernel", kern), ("gspmd", gspmd))}
        for name, fn in LIVE_QUERIES.items():
            t = out[name]["kernel"]
            t["device_ms"] = device_ms(lambda: fn(*frames(kern)))
            t["busy"] = None if t["device_ms"] is None \
                else t["device_ms"] / t["wall_ms"]
        return out

    def breakdowns():
        return {name: device_breakdown(
                    lambda fn=LIVE_QUERIES[name]: fn(*frames(kern)), top=8)
                for name in LIVE_BREAKDOWN}

    times = {"uncompacted": excluding(time_queries)}
    bds = {"uncompacted": excluding(breakdowns)}
    t0 = time.perf_counter()
    feed.compact()
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    oracle.compact()
    print(f"  [{card}] compaction of {len(comps)} components into "
          f"{len(oracle.cols['unique2'])} rows: {compact_s:.3f} s", flush=True)
    with recording(suite_calls):
        after = suite("after compaction")
    excluding(check_recorded, suite_calls, "after compaction",
              ("filter_count", "segment_agg", "topk_merge",
               "merge_join_count"))
    del suite_calls[:]
    for name in before:
        # head / project_head read the first rows of the stream, whose order
        # the compaction changes (upserted rows move from their run to their
        # key's place): each state is held to the oracle above instead
        if name not in ("head", "project_head"):
            same(after[name], before[name], f"live {name} across compaction")
    launches_per_component("after compaction",
                           kern.catalog.components("live", "Live"))
    check_view("after compaction")
    if view.stats["kernel_batches"] < 1:
        raise AssertionError(f"the view's deltas never reached segment_agg: "
                             f"{view.stats}")
    print(f"  view by_ten == recompute == numpy; {view.stats}", flush=True)
    if strings_hook is not None:
        hooked["compacted"] = strings_hook("after compaction", kern, gspmd,
                                           oracle)
    times["compacted"] = excluding(time_queries)
    bds["compacted"] = excluding(breakdowns)
    launches = {k: _build.LAUNCHES[k] - excluded[k] for k in RELATIONAL}
    print(f"  kernel launches in the live phase: {launches}", flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched in the live phase: {missing}")
    for state, qs in times.items():
        for name, t in qs.items():
            k, g = t["kernel"], t["gspmd"]
            dev_s = "device not measured" if k["device_ms"] is None else \
                f"device {k['device_ms']:.3f} ms, busy {k['busy']:.0%}"
            print(f"  [{card}] {state:11s} {name:15s} kernel {k['wall_ms']:8.3f} ms "
                  f"({dev_s})   gspmd {g['wall_ms']:8.3f} ms", flush=True)
    for state, per in bds.items():
        print(f"  {state}:", flush=True)
        print_breakdowns(per)
    return {"flushes": flushes, "compact_s": compact_s, "queries": times,
            "breakdowns": bds,
            "launches": launches, "components": len(comps),
            "rows_visible": len(oracle.cols["unique2"]),
            "view_stats": dict(view.stats), "strings": hooked}


# -- phase 7: the string fast path, windows and dialects -----------------------

STR4 = ("AAAAxxxx", "HHHHxxxx", "OOOOxxxx", "VVVVxxxx")  # string4's values
ABSENT = "QQQQnope"
# device time by kernel of these closed queries (the slowest of each kind)
STRING_BREAKDOWN = ("string4 IN 2 + absent", "string4 group-by", "rank by two")
# The reference's rendering (repro.core.dialect.render(plan, "postgres")) of
# STRING_PLAN below over dataset W of dataverse strings.
PG_TEXT = ("SELECT t.string4, COUNT(*) AS count, SUM(t.four) AS sum_four FROM "
           "(SELECT t.* FROM (SELECT t.* FROM strings.w t) t WHERE "
           "(t.ten >= 3 AND t.two = 1)) t GROUP BY t.string4;")


def _string_group(df):
    """string4 group-by with count, sum of four and max of onePercent."""
    from repro_torch.core import plan as P

    return df._session.execute(P.GroupAgg(df._plan, ["string4"], [
        P.AggSpec("count", "count", None), P.AggSpec("sum_four", "sum", "four"),
        P.AggSpec("max_onePercent", "max", "onePercent")]))


def string_plan(df):
    """The plan phase 7 renders in Postgres (PG_TEXT)."""
    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame

    sub = df[(df["ten"] >= 3) & (df["two"] == 1)]
    return AFrame(df._dataverse, session=df._session, plan=P.GroupAgg(
        sub._plan, ["string4"], [P.AggSpec("count", "count", None),
                                 P.AggSpec("sum_four", "sum", "four")]))


def wisconsin_stringu1(raw: dict) -> str:
    """The stringu1 value phase 7 looks up (a third of the way in: one
    row's, so present)."""
    from repro_torch.engine.table import decode_strings

    i = len(raw["stringu1"]) // 3
    return decode_strings(raw["stringu1"][i:i + 1])[0]


def _encoded(value: str) -> np.ndarray:
    from repro_torch.engine.table import encode_strings

    return encode_strings([value]).numpy()[0]


def string_queries(stringu1: str) -> dict:
    """Phase 7's string queries: == on each string4 value and an absent one,
    IN with two members and an absent one (the planner costs three
    launches above one mask scan) and with one member and an absent one
    (two filter_count launches), the group-by with count, sum of four and
    max of onePercent, the group count, and == on stringu1 (no dictionary
    lane: the prefix lane prunes)."""
    q = {f"string4 == {v}": (lambda v: lambda df: len(df[df["string4"] == v]))(v)
         for v in STR4 + (ABSENT,)}
    q["string4 IN 2 + absent"] = lambda df: len(
        df[df["string4"].isin([STR4[0], STR4[2], ABSENT])])
    q["string4 IN 1 + absent"] = lambda df: len(
        df[df["string4"].isin([STR4[3], ABSENT])])
    q["string4 group-by"] = _string_group
    q["string4 group count"] = lambda df: df.groupby("string4").agg("count")
    q["stringu1 =="] = lambda df: len(df[df["stringu1"] == stringu1])
    return q


def _string_groups(s: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """np.unique(s, axis=0, return_inverse=True) of (n, 16) uint8 rows in
    byte order, through each half as a big-endian uint64 (seconds, not the
    better part of a minute, at 5M rows)."""
    halves = np.ascontiguousarray(s).view(">u8")
    ids = []
    for h in (halves[:, 0], halves[:, 1]):
        uniq, inv = np.unique(h, return_inverse=True)
        ids.append((len(uniq), inv.reshape(-1)))
    (_, hi), (n_lo, lo) = ids
    first, inv = np.unique(hi.astype(np.int64) * n_lo + lo, return_inverse=True)
    rows = np.empty(len(first), np.int64)
    rows[inv.reshape(-1)] = np.arange(len(s))
    return s[rows], inv.reshape(-1)


def string_oracle(c: dict, stringu1: str) -> dict:
    """numpy answers of ``string_queries`` over the columns ``c``."""
    s4 = c["string4"]

    def eq(col, v):
        return int((c[col] == _encoded(v)).all(axis=1).sum())

    keys, inv = _string_groups(s4)
    sums = np.bincount(inv, weights=c["four"], minlength=len(keys))
    mx = np.full(len(keys), np.iinfo(np.int32).min, np.int32)
    np.maximum.at(mx, inv, c["onePercent"])
    out = {f"string4 == {v}": eq("string4", v) for v in STR4 + (ABSENT,)}
    out["string4 IN 2 + absent"] = eq("string4", STR4[0]) + eq("string4", STR4[2])
    out["string4 IN 1 + absent"] = eq("string4", STR4[3])
    counts = np.bincount(inv, minlength=len(keys)).astype(np.int32)
    out["string4 group-by"] = {"string4": keys, "count": counts,
                               "sum_four": sums.astype(np.int32),
                               "max_onePercent": mx}
    out["string4 group count"] = {"string4": keys, "count": counts}
    out["stringu1 =="] = eq("stringu1", stringu1)
    return out


def _sorted_segments(keys: tuple) -> tuple:
    """(order, position, partition start per sorted row) of a stable
    lexicographic sort by ``keys`` (last key primary, as np.lexsort)."""
    order = np.lexsort(keys)
    n = len(order)
    part = keys[-1][order] if len(keys) > 1 else np.zeros(n, np.int8)
    starts = np.r_[True, part[1:] != part[:-1]]
    pos = np.arange(n)
    return order, pos, np.maximum.accumulate(np.where(starts, pos, 0))


def window_queries() -> dict:
    """Phase 7's windows, each over the narrow projection it reads."""
    def w(cols, **kw):
        return lambda df: df[cols].window(**kw)
    return {
        "row_number by ten, unique1": lambda df: w(
            ["unique1", "ten"], order_by="unique1",
            partition_by="ten")(df).row_number("rn").collect(),
        "rank by two": lambda df: w(["two"], order_by="two")(df)
        .rank("r").collect(),
        "cumsum four by ten, unique2": lambda df: w(
            ["unique2", "ten", "four"], order_by="unique2",
            partition_by="ten")(df).cumsum("four").collect(),
        "moving_avg four 10 by unique2": lambda df: w(
            ["unique2", "four"], order_by="unique2")(df)
        .moving_avg("four", 10).collect(),
    }


def window_oracle(c: dict) -> dict:
    """numpy answers of ``window_queries``, in storage order: int32 ranks,
    float32 sums and averages (exact: every prefix sum of four is an
    integer below 2^24)."""
    n = len(c["unique2"])
    out = {}
    order, pos, start = _sorted_segments((c["unique1"], c["ten"]))
    rn = np.empty(n, np.int32)
    rn[order] = pos - start + 1
    out["row_number by ten, unique1"] = {"unique1": c["unique1"],
                                         "ten": c["ten"], "rn": rn}
    zeros = int((c["two"] == 0).sum())
    out["rank by two"] = {"two": c["two"], "r": np.where(
        c["two"] == 0, 1, zeros + 1).astype(np.int32)}
    order, pos, start = _sorted_segments((c["unique2"], c["ten"]))
    v = c["four"][order].astype(np.int64)
    cs = np.cumsum(v)
    cum = np.empty(n, np.float32)
    cum[order] = cs - (cs - v)[start]
    out["cumsum four by ten, unique2"] = {"unique2": c["unique2"],
                                          "ten": c["ten"], "four": c["four"],
                                          "cumsum_four": cum}
    order, pos, _ = _sorted_segments((c["unique2"],))
    cs = np.r_[0, np.cumsum(c["four"][order].astype(np.int64))]
    lo = np.maximum(pos - 9, 0)
    avg = np.empty(n, np.float32)
    avg[order] = (cs[pos + 1] - cs[lo]).astype(np.float32) \
        / (pos - lo + 1).astype(np.float32)
    out["moving_avg four 10 by unique2"] = {"unique2": c["unique2"],
                                            "four": c["four"],
                                            "mavg10_four": avg}
    return out


def cumsum_f32_deviation(df, c: dict) -> tuple[float, float]:
    """Largest |cumsum(unique1) by (ten, unique2) − float64 oracle|, and the
    largest such deviation relative to the value: float32 prefix sums past
    2^24 round in any implementation. Printed, not gated."""
    got = df[["unique2", "ten", "unique1"]].window(
        order_by="unique2", partition_by="ten").cumsum("unique1").collect()
    order, _, start = _sorted_segments((c["unique2"], c["ten"]))
    v = c["unique1"][order].astype(np.float64)
    cs = np.cumsum(v)
    want = np.empty(len(v))
    want[order] = cs - (cs - v)[start]
    dev = np.abs(got["cumsum_unique1"].astype(np.float64) - want)
    return float(dev.max()), float((dev / np.maximum(want, 1)).max())


@contextlib.contextmanager
def own_launches(counts: dict):
    """Every launch count set to 0 for the block and read into ``counts``
    at its end; the counts held before (phase 6's) are put back."""
    import torch

    from repro_torch.kernels import _build

    held = dict(_build.LAUNCHES)
    _build.reset_launches()
    try:
        yield counts
        torch.cuda.synchronize()
        counts.update(_build.LAUNCHES)
    finally:
        _build.LAUNCHES.update(held)


def _moved(counts: dict, where: str) -> dict:
    """filter_count's and segment_agg's launches, failing unless both moved."""
    out = {k: counts[k] for k in ("filter_count", "segment_agg")}
    missing = [k for k, v in out.items() if v == 0]
    if missing:
        raise AssertionError(f"phase 7 {where}: {missing} never launched")
    return out


def _query_times(queries: dict, frames, card: str, state: str) -> dict:
    """Wall (median of 7) in both modes, device and busy in kernel mode."""
    times = {name: {m: {"wall_ms": host_ms(lambda: fn(frames(m)))}
                    for m in ("kernel", "gspmd")}
             for name, fn in queries.items()}
    for name, fn in queries.items():
        t = times[name]["kernel"]
        t["device_ms"] = device_ms(lambda: fn(frames("kernel")))
        t["busy"] = None if t["device_ms"] is None \
            else t["device_ms"] / t["wall_ms"]
        dev_s = "device not measured" if t["device_ms"] is None else \
            f"device {t['device_ms']:.3f} ms, busy {t['busy']:.0%}"
        print(f"  [{card}] {state:17s} {name:30s} kernel {t['wall_ms']:8.3f} ms "
              f"({dev_s})   gspmd {times[name]['gspmd']['wall_ms']:8.3f} ms",
              flush=True)
    return times


def live_strings_hook(card: str, stringu1: str):
    """Phase 7's live part, run by phase 6 over its nine components and
    after its compaction: the string queries through the kernel and gspmd
    sessions against the newest-wins oracle, every filter_count and
    segment_agg call recorded and held against its plain version, the
    launches counted apart from phase 6's."""
    from repro_torch.core.frame import AFrame

    queries = {k: v for k, v in string_queries(stringu1).items()
               if k in ("string4 == HHHHxxxx", "string4 IN 2 + absent",
                        "string4 IN 1 + absent", "string4 group count")}

    def hook(state, kern, gspmd, oracle):
        sessions = {"kernel": kern, "gspmd": gspmd}

        def frames(m):
            return AFrame("live", "Live", session=sessions[m])

        want = string_oracle(oracle.cols, stringu1)
        calls: list = []
        with own_launches({}) as counts, recording(calls):
            for name, fn in queries.items():
                for m in ("kernel", "gspmd"):
                    same(fn(frames(m)), want[name],
                         f"phase 7 live {name}[{m}] {state}")
                print(f"  phase 7 live {state}: {name}: kernel == gspmd == "
                      f"numpy ({type(kern.last_physical).__name__})", flush=True)
        launches = _moved(counts, f"live {state}")
        print(f"  phase 7 live {state}: launches {launches}", flush=True)
        with own_launches({}):  # comparisons and timings launch apart
            check_recorded(calls, f"phase 7 live {state}",
                           ("filter_count", "segment_agg"))
            del calls[:]
            times = _query_times(queries, frames, card, f"live {state}")
        return {"launches": launches, "queries": times}
    return hook


def run_strings_windows(table, raw: dict, dev, card: str,
                        stringu1: str) -> dict:
    """Phase 7's closed part: the phase-3 table (5M rows, clustered by
    unique2) in a kernel and a gspmd session; string ==, IN and group-by,
    stringu1 ==, four windows, each kernel == gspmd == numpy bit for bit
    (dtypes included); one plan's Postgres text against the reference's.
    Returns the launches, the times and the closed dataset's lane and four
    column for the kernel rows."""
    from repro_torch.core import physical as PH
    from repro_torch.core.catalog import Catalog
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session

    catalog = Catalog()
    sessions = {m: Session(mode=m, device=dev, catalog=catalog)
                for m in ("kernel", "gspmd")}
    sessions["kernel"].create_dataset("W", table, dataverse="strings")

    def frames(m):
        return AFrame("strings", "W", session=sessions[m])

    queries = {**string_queries(stringu1), **window_queries()}
    want = {**string_oracle(raw, stringu1), **window_oracle(raw)}
    calls: list = []
    plans = {}
    with own_launches({}) as counts, recording(calls):
        for name, fn in queries.items():
            for m in ("kernel", "gspmd"):
                same(fn(frames(m)), want[name], f"phase 7 {name}[{m}]")
            plans[name] = sessions["kernel"].last_physical
            print(f"  {name}: kernel == gspmd == numpy "
                  f"({type(plans[name]).__name__})", flush=True)
    launches = _moved(counts, "closed")
    print(f"  kernel launches of the closed queries: {launches}", flush=True)
    eq = plans["string4 == HHHHxxxx"]
    if not (isinstance(eq, PH.KernelRangeCount)
            and eq.cols == ("__dict_string4",)):
        raise AssertionError(f"string4 == did not take the dictionary lane: "
                             f"{PH.format_plan(eq)}")
    grp = plans["string4 group-by"]
    if not (isinstance(grp, PH.KernelSegmentAgg) and grp.key_values == STR4):
        raise AssertionError(f"string4 group-by: {PH.format_plan(grp)}")
    shapes = {}
    for name, args, kw, out in calls:
        if name in ("filter_count", "segment_agg"):
            key = (name, len(args[0]) if name == "filter_count"
                   else (kw.get("op", "sum"), int(args[0].shape[1])))
            shapes[key] = shapes.get(key, 0) + 1
    pg = string_plan(frames("kernel")).query_in("postgres")
    if pg != PG_TEXT:
        raise AssertionError(f"Postgres text {pg!r} != the reference's")
    print(f"  query_in('postgres') == the reference's: {pg}", flush=True)
    with own_launches({}):  # comparisons and timings launch apart
        check_recorded(calls, "phase 7 closed", ("filter_count", "segment_agg"))
        del calls[:]
        dev_abs, dev_rel = cumsum_f32_deviation(frames("kernel"), raw)
        print(f"  cumsum(unique1) by (ten, unique2) vs a float64 oracle: "
              f"largest deviation {dev_abs:.1f} ({dev_rel:.2e} of the value; "
              f"float32 prefix sums pass 2^24; not gated)", flush=True)
        times = _query_times(queries, frames, card, "closed")
        bds = {name: device_breakdown(
                   lambda fn=queries[name]: fn(frames("kernel")), top=8)
               for name in STRING_BREAKDOWN}
    print_breakdowns(bds)
    cols = catalog.get("strings", "W").table.columns
    return {"launches": launches, "shape_launches": shapes, "queries": times,
            "breakdowns": bds,
            "cumsum_unique1_deviation": {"abs": dev_abs, "rel": dev_rel},
            "lane": cols["__dict_string4"], "four": cols["four"]}


def time_string_kernels(closed: dict) -> list[dict]:
    """The two shapes phase 7 gives the relational kernels, timed as phase
    5's rows: filter_count on the 5M-row ``__dict_string4`` lane (k = 1,
    string4 == 'HHHHxxxx'), and segment_agg with G = 4 over 5M rows (the
    group-by's sum family: a count column and four)."""
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import segment_agg as sa

    lane, four = closed["lane"], closed["four"]
    n = int(lane.shape[0])
    shapes = closed["shape_launches"]
    bounds = torch.tensor([[1, 1]], dtype=torch.int32, device=lane.device)
    args = ([lane], bounds, n)
    err = float((fc.filter_count(*args) - fc.filter_count_plain(*args)).abs())
    nbytes = n * 4 + 8 + 4
    rows = [_timed("filter_count", "filter_count_kernel",
                   rotating(fc.filter_count, args, nbytes),
                   rotating(fc.filter_count_plain, args, nbytes), None,
                   nbytes, 2 * n, err, shapes.get(("filter_count", 1), 0),
                   f"dict lane ({n},) int32, k=1 (phase 7: string4 ==)")]
    vals = torch.stack([torch.ones(n, device=lane.device),
                        four.to(torch.float32)], dim=1)
    args = (vals, lane, len(STR4), n)
    err = float((sa.segment_agg(*args) - sa.segment_agg_plain(*args)).abs().max())
    nbytes = n * 2 * 4 + n * 4 + len(STR4) * 2 * 4

    def library(vals, gl):
        return torch.zeros((len(STR4), 2), device=vals.device) \
            .index_add_(0, gl, vals)
    rows.append(_timed(
        "segment_agg", SEGMENT_AGG_KERNELS, rotating(sa.segment_agg, args, nbytes),
        rotating(sa.segment_agg_plain, args, nbytes),
        rotating(library, (vals, lane.long()), nbytes), nbytes, 2 * n, err,
        shapes.get(("segment_agg", ("sum", 2)), 0),
        f"values ({n}, 2) f32, G={len(STR4)}, sum (phase 7: string4 "
        f"group-by, count + four)"))
    return rows


# -- phase 8: durability on the card -------------------------------------------

DURABLE_TAIL = ("upsert", "delete")  # acked after the eight, left in the WAL
CRASH_BATCHES = 4    # the crash matrix's cut: LIVE_MIX's first four batches,
CRASH_FLUSHED = 2    # the first two flushed, the last two the WAL tail
CRASH_ROWS = 1_000_000   # the crash matrix's base, cut from ROWS for the
                         # script's time limit (at ROWS phase 8 took 162 s
                         # on an H100 80GB HBM3, 700 W)
# tests/test_lsm.py's suite and e3, e4, e8, e11 (LIVE_QUERIES), e9 and e12
DURABLE_QUERIES = dict(LIVE_QUERIES, **{
    "9_sort_head": lambda df, dim: df.sort_values("unique1", ascending=False).head(),
    "12_join_count": lambda df, dim: len(df.merge(df, left_on="unique1",
                                                  right_on="unique1")),
})
DURABLE_TIMED = ("3_filter_count", "4_group_count")
DURABLE_STRINGS = ("string4 == HHHHxxxx", "string4 group count")


def durable_oracle(c: dict, dim_unique1: np.ndarray) -> dict:
    """numpy answers of DURABLE_QUERIES, the two string queries included."""
    out = live_oracle(c, dim_unique1)
    top = np.argsort(-c["unique1"].astype(np.int64), kind="stable")[:5]
    out["9_sort_head"] = {k: v[top] for k, v in c.items()}
    _, n = np.unique(c["unique1"], return_counts=True)
    out["12_join_count"] = int((n.astype(np.int64) ** 2).sum())
    keys, inv = _string_groups(c["string4"])
    out["string4 == HHHHxxxx"] = int((c["string4"] == _encoded("HHHHxxxx"))
                                     .all(axis=1).sum())
    out["string4 group count"] = {
        "string4": keys,
        "count": np.bincount(inv, minlength=len(keys)).astype(np.int32)}
    return out


def _by_key(cols: dict) -> dict:
    order = np.argsort(cols["unique2"], kind="stable")
    return {k: v[order] for k, v in cols.items()}


def _seg_bytes(sess, comps) -> int:
    """Bytes of the segment files behind ``comps`` (what an open read)."""
    root = sess.storage.root / "data" / "live" / "Live" / "seg"
    return sum((root / c.seg_name).stat().st_size for c in comps)


def _on_device(comps, dev, soft: bool) -> None:
    """Every mounted column — and with ``soft`` every index payload and
    anti-key array — lies on ``dev`` (the card)."""
    def off(t):
        return t is None or t.device != dev

    for c in comps:
        bad = [k for k, t in c.table.columns.items() if off(t)]
        if soft:
            bad += [f"{key}.{f}" for key, ix in c.indexes.items()
                    for f in ("sorted_keys", "row_ids", "zone_min", "zone_max")
                    if off(getattr(ix, f))]
            if c.anti_rows and off(c.anti_keys_arr):
                bad.append("anti_keys_arr")
        if bad:
            raise AssertionError(f"{c.name}: not on {dev}: {bad}")


def run_durable(table, raw: dict, dev, seed: int, card: str,
                live_flushes: list) -> dict:
    """Phase 8: durable storage on the card. Phase 6's scenario at full
    scale through ``Session(mode="kernel", storage=dir)`` — the 5M-row base,
    Dim, the view, LIVE_MIX's eight batches (one flush each, compaction
    deferred: nine components) and two more acked batches left in the WAL
    — then ``close`` and ``Session.open``: lazily (the WAL tail replays
    into a tenth component), lazily again, eagerly, compacted, and opened
    once more; every state held to the newest-wins oracle through a kernel
    and a gspmd session. Then the crash matrix: a crash at each of
    ``IO_FAULT_POINTS`` (and a torn run segment) over a CRASH_ROWS-row base
    and LIVE_MIX's first four batches (cut from ROWS rows and eight
    batches; two flushed, two in the WAL), reopened and held to a
    memory-only session that applied exactly the acked batches. Runs in a
    fresh temporary directory, removed at the end."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.runtime import telemetry as tel
    from repro_torch.runtime.fault import IO_FAULT_POINTS, FaultPlan, StorageFault

    # (label, point, arrival): each I/O point on its first arrival, and
    # torn-write on its second too: the first is batch 0's WAL append, the
    # second batch 0's run-segment write, so a torn segment is recovered
    crash_cases = tuple((p, p, 0) for p in IO_FAULT_POINTS) + (
        ("torn-write@1", "torn-write", 1),)

    root = Path(tempfile.mkdtemp(prefix="chip_smoke_durable_"))
    print(f"  store under {root}; {shutil.disk_usage(root).free:,} bytes free",
          flush=True)
    dim = wisconsin.generate(LIVE_DIM_ROWS, seed=7)
    dim_u1 = dim.columns["unique1"].numpy()
    view_plan = P.GroupAgg(P.Scan("Live", "live"), ["ten"], [
        P.AggSpec("count", "count", None), P.AggSpec("sum_four", "sum", "four"),
        P.AggSpec("max_onePercent", "max", "onePercent")])
    policy = lsm.CompactionPolicy(size_ratio=10.0, max_runs=64)
    seg_written = lambda: tel.counter_value("storage.segment_bytes_written_total")
    excluded = dict.fromkeys(_build.LAUNCHES, 0)  # comparisons and timings
    out: dict = {"acks": [], "flushes": [], "opens": {}, "queries": {},
                 "crash": {}}

    def excluding(fn, *args):
        held = dict(_build.LAUNCHES)
        got = fn(*args)
        torch.cuda.synchronize()
        for k, v in _build.LAUNCHES.items():
            excluded[k] = excluded.get(k, 0) + v - held.get(k, 0)
        return got

    def frames(sess):
        return (AFrame("live", "Live", session=sess),
                AFrame("live", "Dim", session=sess))

    def suite(kern, state, oracle):
        """DURABLE_QUERIES and the two string queries through the kernel
        session and a gspmd reader over its catalog, against the oracle;
        every kernel call recorded and held against its plain version."""
        gspmd = Session(mode="gspmd", device=dev, catalog=kern.catalog)
        want = durable_oracle(oracle.cols, dim_u1)
        s4 = string_queries("")
        calls: list = []
        with recording(calls):
            for m, sess in (("kernel", kern), ("gspmd", gspmd)):
                for name, fn in DURABLE_QUERIES.items():
                    same(fn(*frames(sess)), want[name], f"durable {name}[{m}] {state}")
                for name in DURABLE_STRINGS:
                    same(s4[name](frames(sess)[0]), want[name],
                         f"durable {name}[{m}] {state}")
            torch.cuda.synchronize()
        need = ("filter_count", "segment_agg", "topk_merge") + (
            ("merge_join_count",) if "compact" in state else ())
        excluding(check_recorded, calls, f"durable {state}", need)
        print(f"  {state}: {len(DURABLE_QUERIES) + len(DURABLE_STRINGS)} "
              f"queries kernel == gspmd == numpy", flush=True)

    def lookups(kern, oracle, upserted, deleted):
        c = oracle.cols
        i = np.nonzero(c["unique2"] == upserted)[0]
        same(kern.point_lookup("live", "Live", int(upserted)),
             {k: v[i] for k, v in c.items()}, "durable lookup upserted")
        for key in (int(deleted), -1):
            if kern.point_lookup("live", "Live", key) is not None:
                raise AssertionError(f"durable lookup {key}: not None")

    def view_check(kern, oracle, state):
        kern.create_view("by_ten", view_plan)
        same(kern.read_view("by_ten"), kern.execute(view_plan),
             f"durable view vs recompute {state}")
        c = oracle.cols
        k, n = _live_groups(c["ten"])
        same(kern.read_view("by_ten"),
             {"ten": k, "count": n,
              "sum_four": _live_groups(c["ten"], c["four"], "sum")[1],
              "max_onePercent": _live_groups(c["ten"], c["onePercent"], "max")[1]},
             f"durable view vs numpy {state}")

    def reopen(d, state, lazy=True):
        t0 = time.perf_counter()
        sess = Session.open(str(d), lazy=lazy, mode="kernel", device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sess.recovery_report
        comps = sess.catalog.components("live", "Live")
        mounted = rep["datasets"]["live.Live"]["components"]
        row = {"wall_s": wall, "report_s": rep["seconds"],
               "replayed": rep["wal_replayed_batches"],
               "components": len(comps),
               "read_bytes": _seg_bytes(sess, comps[:mounted])}
        _on_device(comps, dev, soft=not lazy)
        print(f"  [{card}] open {state} (lazy={lazy}): {wall:.3f} s host clock, "
              f"{rep['seconds']:.3f} s recovery_report, {row['read_bytes']:,} "
              f"segment bytes read, {row['replayed']} WAL batch(es) replayed, "
              f"{len(comps)} components", flush=True)
        out["opens"][state] = row
        return sess, comps

    def time_queries(kern, state):
        row = {}
        for name in DURABLE_TIMED:
            fn = LIVE_QUERIES[name]
            wall = host_ms(lambda: fn(*frames(kern)))
            dev_ms = device_ms(lambda: fn(*frames(kern)))
            row[name] = {"wall_ms": wall, "device_ms": dev_ms}
            dev_s = "device not measured" if dev_ms is None else \
                f"device {dev_ms:.3f} ms, busy {dev_ms / wall:.0%}"
            print(f"  [{card}] {state:28s} {name:15s} kernel {wall:8.3f} ms "
                  f"({dev_s})", flush=True)
        out["queries"][state] = row

    try:
        with own_launches({}) as counts:
            # -- 1. the round trip at full scale ----------------------------
            d = root / "live"
            w0 = seg_written()
            kern = Session(mode="kernel", device=dev, storage=str(d))
            t0 = time.perf_counter()
            kern.create_dataset("Live", table, dataverse="live", closed=True,
                                primary="unique2", indexes=["onePercent"])
            kern.create_dataset("Dim", dim, dataverse="live")
            torch.cuda.synchronize()
            out["create_s"] = time.perf_counter() - t0
            print(f"  [{card}] Live ({ROWS} rows) and Dim placed and written "
                  f"in {out['create_s']:.3f} s ({seg_written() - w0:,} segment "
                  f"bytes)", flush=True)
            kern.create_view("by_ten", view_plan)
            feed = Feed(kern, "Live", "live", flush_rows=10**9, policy=policy)
            wal = d / "data" / "live" / "Live" / "wal.log"
            oracle = LiveOracle(raw)
            rng = np.random.default_rng(seed)
            next_key = ROWS
            tail = {}
            for i, kind in enumerate(LIVE_MIX + DURABLE_TAIL):
                batch = _live_batch(kind, i, rng, oracle, next_key)
                if kind == "push":
                    next_key += LIVE_BATCH
                size = wal.stat().st_size if wal.exists() else 0
                t0 = time.perf_counter()
                getattr(feed, kind)(batch)
                ack = time.perf_counter() - t0
                oracle.apply(kind, batch)
                out["acks"].append({"kind": kind, "ack_s": ack,
                                    "wal_bytes": wal.stat().st_size - size})
                if i >= len(LIVE_MIX):
                    tail[kind] = batch
                    continue
                w, f0 = seg_written(), _flush_seconds()
                t0 = time.perf_counter()
                feed.flush()
                torch.cuda.synchronize()
                out["flushes"].append({"kind": kind,
                                       "wall_s": time.perf_counter() - t0,
                                       "flush_s": _flush_seconds() - f0,
                                       "segment_bytes": seg_written() - w})
            out["written_bytes"] = seg_written() - w0
            if len(kern.catalog.components("live", "Live")) != 1 + len(LIVE_MIX):
                raise AssertionError("phase 8: expected nine components")
            kern.close()
            del kern, feed
            # point lookups: a key of the tail's upsert still visible, a key
            # of its delete
            ups = tail["upsert"]["unique2"]
            upserted = ups[np.isin(ups, oracle.cols["unique2"])][0]
            deleted = tail["delete"][0]
            for i, (a, f) in enumerate(zip(out["acks"], out["flushes"] + [None] * 2)):
                flush = "left in the WAL" if f is None else (
                    f"flush {f['wall_s']:.3f} s host clock, {f['flush_s']:.3f} s "
                    f"ingest.flush_seconds with {f['segment_bytes']:,} segment "
                    f"bytes (phase 6, no store: {live_flushes[i]['flush_s']:.3f} s)")
                print(f"  [{card}] batch {i + 1} ({a['kind']}): ack (WAL append "
                      f"+ fsync) {a['ack_s'] * 1e3:.1f} ms for {a['wal_bytes']:,} "
                      f"WAL bytes; {flush}", flush=True)

            # -- lazy open: the WAL tail replays into a tenth component -----
            re, comps = reopen(d, "with the WAL tail")
            if out["opens"]["with the WAL tail"]["replayed"] != len(DURABLE_TAIL) \
                    or len(comps) != 2 + len(LIVE_MIX):
                raise AssertionError(f"phase 8: {re.recovery_report}")
            suite(re, "reopened, 10 components", oracle)
            _on_device(comps, dev, soft=True)
            lookups(re, oracle, upserted, deleted)
            calls = []
            with recording(calls):
                view_check(re, oracle, "reopened")
            excluding(check_recorded, calls, "durable view seed", ())
            re.close()

            # -- lazy open again: the first query pays the rebuild ----------
            re, comps = reopen(d, "lazy")
            if not re.catalog.stale:
                raise AssertionError("phase 8: a lazy open rebuilt eagerly")
            fn = LIVE_QUERIES["3_filter_count"]
            firsts = []
            for _ in range(2):
                t0 = time.perf_counter()
                fn(*frames(re))
                torch.cuda.synchronize()
                firsts.append(time.perf_counter() - t0)
            out["first_query_s"], out["second_query_s"] = firsts
            print(f"  [{card}] e3 right after the lazy open (rebuilds the soft "
                  f"state of {len(comps)} components): {firsts[0]:.3f} s; "
                  f"again: {firsts[1] * 1e3:.3f} ms", flush=True)
            _on_device(comps, dev, soft=True)
            suite(re, "reopened lazily", oracle)
            re.close()

            # -- eager open, the compaction, and a last open ----------------
            re, comps = reopen(d, "eager", lazy=False)
            suite(re, "reopened eagerly", oracle)
            excluding(time_queries, re, f"reopened, {len(comps)} components")
            w = seg_written()
            t0 = time.perf_counter()
            Feed(re, "Live", "live", flush_rows=10**9, policy=policy).compact()
            torch.cuda.synchronize()
            out["compact_s"] = time.perf_counter() - t0
            out["compact_bytes"] = seg_written() - w
            oracle.compact()
            seg_dir = d / "data" / "live" / "Live" / "seg"
            segs = sorted(p.name for p in seg_dir.iterdir())
            print(f"  [{card}] compaction of {len(comps)} components with its "
                  f"segment write and GC: {out['compact_s']:.3f} s, "
                  f"{out['compact_bytes']:,} segment bytes; on disk after: "
                  f"{segs}", flush=True)
            suite(re, "compacted", oracle)
            excluding(time_queries, re, "compacted, 1 component")
            re.close()
            re, comps = reopen(d, "after the compaction")
            suite(re, "reopened after the compaction", oracle)
            re.close()
            # the open's republish aged the pre-compaction generations out
            print(f"  segments on disk after that open: "
                  f"{sorted(p.name for p in seg_dir.iterdir())}", flush=True)

            # -- 3. the crash matrix ------------------------------------------
            crash_table = wisconsin.generate(CRASH_ROWS, seed=seed)
            crash_raw = {k: v.numpy() for k, v in crash_table.columns.items()}
            gen = LiveOracle(crash_raw)
            rng = np.random.default_rng(seed + 1)
            batches, next_key = [], CRASH_ROWS
            for i, kind in enumerate(LIVE_MIX[:CRASH_BATCHES]):
                batches.append((kind, _live_batch(kind, i, rng, gen, next_key)))
                gen.apply(*batches[-1])
                next_key += LIVE_BATCH if kind == "push" else 0
            memory: dict = {}

            def acked_rows(n):
                """A memory-only session that applied the first n batches
                (one flush), its visible rows by key; numpy agrees."""
                if n not in memory:
                    sess = Session(mode="kernel", device=dev)
                    sess.create_dataset("Live", crash_table, dataverse="live",
                                        closed=True, primary="unique2",
                                        indexes=["onePercent"])
                    f = Feed(sess, "Live", "live", flush_rows=10**9, policy=policy)
                    want = LiveOracle(crash_raw)
                    for kind, batch in batches[:n]:
                        getattr(f, kind)(batch)
                        want.apply(kind, batch)
                    f.flush()
                    memory[n] = (_by_key(AFrame("live", "Live", session=sess)
                                         .collect()), want)
                    same(memory[n][0], _by_key(want.cols),
                         f"memory-only session after {n} batches vs numpy")
                    del sess, f
                return memory[n]

            for label, point, arrival in crash_cases:
                dp = root / f"crash-{label}"
                sess = Session(mode="kernel", device=dev, storage=str(dp))
                sess.create_dataset("Live", crash_table, dataverse="live",
                                    closed=True, primary="unique2",
                                    indexes=["onePercent"])
                # armed after the initial commit
                sess.fault_plan = FaultPlan.once(point, arrival)
                f = Feed(sess, "Live", "live", flush_rows=10**9, policy=policy)
                acked, crashed = 0, False
                try:
                    for i, (kind, batch) in enumerate(batches):
                        getattr(f, kind)(batch)
                        acked += 1
                        if i < CRASH_FLUSHED:
                            f.flush()
                except StorageFault:
                    crashed = True
                sess.close()
                del sess, f
                gc.collect()
                if point == "mid-replay":
                    try:
                        Session.open(str(dp), mode="kernel", device=dev,
                                     fault_plan=FaultPlan.once(point))
                    except StorageFault:
                        crashed = True
                    else:
                        raise AssertionError("mid-replay: no crash")
                if not crashed:
                    raise AssertionError(f"{label}: the fault never fired")
                t0 = time.perf_counter()
                re = Session.open(str(dp), mode="kernel", device=dev)
                open_s = time.perf_counter() - t0
                comps = re.catalog.components("live", "Live")
                _on_device(comps, dev, soft=False)
                got = _by_key(AFrame("live", "Live", session=re).collect())
                rows, want = acked_rows(acked)
                same(got, rows, f"crash at {label}: recovered vs memory-only")
                if len(np.unique(got["unique2"])) != len(got["unique2"]):
                    raise AssertionError(f"crash at {label}: duplicate keys")
                held = dict(_build.LAUNCHES)
                w = live_oracle(want.cols, dim_u1)
                calls: list = []
                with recording(calls):
                    for name in ("3_filter_count", "4_group_count"):
                        same(LIVE_QUERIES[name](
                            AFrame("live", "Live", session=re), None),
                             w[name], f"crash at {label}: {name}")
                    torch.cuda.synchronize()
                moved = {k: _build.LAUNCHES[k] - held[k]
                         for k in ("filter_count", "segment_agg")}
                excluding(check_recorded, calls, f"durable crash at {label}",
                          ("filter_count", "segment_agg"))
                if not all(moved.values()):
                    raise AssertionError(f"crash at {label}: e3/e4 launched {moved}")
                out["crash"][label] = {
                    "acked": acked, "components": len(comps),
                    "replayed": re.recovery_report["wal_replayed_batches"],
                    "rows": len(got["unique2"]), "open_s": open_s}
                print(f"  [{card}] crash at {label}: {acked} batch(es) acked, "
                      f"reopened in {open_s:.3f} s with {len(comps)} components "
                      f"({out['crash'][label]['replayed']} replayed), "
                      f"{len(got['unique2']):,} rows == memory-only == numpy, "
                      f"no duplicate key; e3/e4 through the kernels {moved}",
                      flush=True)
                re.close()
                shutil.rmtree(dp)
            memory.clear()
        launches = {k: counts[k] - excluded.get(k, 0) for k in RELATIONAL}
        print(f"  kernel launches in the durable phase: {launches}", flush=True)
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched in phase 8: {missing}")
        out["launches"] = launches
        total = out["written_bytes"] + out["compact_bytes"]
        print(f"  [{card}] segment bytes written: {total:,} (round trip "
              f"{out['written_bytes']:,}, compaction {out['compact_bytes']:,}); "
              f"WAL bytes appended: {sum(a['wal_bytes'] for a in out['acks']):,}",
              flush=True)
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


# -- phase 9: the multi-device engine, a mesh of row shards on the card --------

MESH_SHARDS = 8             # the reference tests' mesh (tests/test_distributed.py)
SHARD_SWEEP = (1, 2, 4, 8)  # the distribution cost on one card (Table VII's axis)
SHARD_TIMED = ("3_filter_count", "4_group_count", "9_sort_head", "12_join_count")
UNALIGNED_ROWS = 1_000_008  # 125,001 rows a shard: views at 16-byte phases 0/4/8/12
MESH_LIVE_ROWS = 1_000_000  # phase 6's scenario at a smaller depth
MESH_LIVE_MIX = ("upsert", "delete")
MESH_KERNELS = ("filter_count", "segment_agg", "topk_merge", "merge_join_count")


def _shard_note(sess, plan) -> str:
    """The per-shard zone-map note of ``plan``'s explain text."""
    text = sess.explain(plan)
    notes = [ln.strip() for ln in text.splitlines() if "shards, per-shard" in ln]
    if not notes:
        raise AssertionError(f"no per-shard note in:\n{text}")
    return notes[0]


def _mesh_ranges(sess, raw: dict, rounds: int, label: str) -> str:
    """Clustered unique2 range counts and group counts through ``sess`` (a
    mesh session): numpy answers, and the count must skip blocks on every
    shard's own grid. Returns the last round's per-shard explain note."""
    from repro_torch.core import plan as P
    from repro_torch.core.frame import AFrame

    n = len(raw["unique2"])
    width = min(300_000, n // 10)
    df = AFrame("bench", "data", session=sess)
    note = ""
    for r in range(rounds):
        rng = np.random.default_rng(200 + r)
        a = int(rng.integers(n - width))
        b = a + int(rng.integers(1, width))
        sel = (raw["unique2"] >= a) & (raw["unique2"] <= b)
        rows = df[(df["unique2"] >= a) & (df["unique2"] <= b)]
        same(len(rows), int(sel.sum()), f"{label} unique2 range count {r}")
        rep = sess.last_prune_report
        if rep["shards"] != MESH_SHARDS or rep["blocks_skipped"] <= 0:
            raise AssertionError(f"{label}: the range skipped no block per "
                                 f"shard: {rep}")
        k_ten, c_ten = _groups(raw["ten"][sel], None, "count")
        same(rows.groupby("ten").agg("count"), {"ten": k_ten, "count": c_ten},
             f"{label} unique2 range group count {r}")
        note = _shard_note(sess, P.Agg(rows._plan,
                                       [P.AggSpec("count", "count", None)]))
    return note


def _mesh_sessions(table, mesh, modes=("shard_map", "kernel")) -> dict:
    from repro_torch.engine.session import Session

    out = {}
    for m in modes:
        sess = Session(mode=m, mesh=mesh)
        for name in ("data", "data_r"):
            sess.create_dataset(name, table, dataverse="bench")
        out[m] = sess
    return out


def _frames(sess):
    from repro_torch.core.frame import AFrame

    return AFrame("bench", "data", session=sess), AFrame("bench", "data_r", session=sess)


def check_unaligned_shards(dev, seed: int) -> None:
    """The per-shard launches on shard views at every 16-byte phase and on
    a per-shard block matrix with all -1 rows: an 8-shard kernel session
    over UNALIGNED_ROWS rows runs e3, e4, e9, e12 and clustered ranges inside one
    shard (count and group count); every launch it made is recorded and
    held against its plain version."""
    from repro_torch.core import physical as PH
    from repro_torch.data import wisconsin
    from repro_torch.engine import distributed as D
    from repro_torch.launch.mesh import make_local_mesh

    t = wisconsin.generate(UNALIGNED_ROWS, seed=seed + 1)
    raw = {k: v.numpy() for k, v in t.columns.items()}
    mesh = make_local_mesh(MESH_SHARDS, device=dev)
    sess = _mesh_sessions(t, mesh, ("kernel",))["kernel"]
    col = sess.catalog.get("bench", "data").table.columns["ten"]
    phases = sorted({v.data_ptr() % 16 for v in D.shard_views(col, MESH_SHARDS)})
    if phases != [0, 4, 8, 12]:
        raise AssertionError(f"shard views at 16-byte phases {phases}")
    calls: list = []
    df, dr = _frames(sess)
    rps = UNALIGNED_ROWS // MESH_SHARDS
    with recording(calls):
        for name in ("3_filter_count", "4_group_count", "9_sort_head",
                     "12_join_count"):
            same(EXPRESSIONS[name](df, dr, np.random.default_rng(5)),
                 oracle(raw, name, np.random.default_rng(5)),
                 f"phase 9 unaligned {name}")
        # a range inside shard 3: the other seven rows of the block matrix
        # are all -1
        a = 3 * rps + rps // 8
        b = a + rps // 4
        sel = (raw["unique2"] >= a) & (raw["unique2"] <= b)
        rows = df[(df["unique2"] >= a) & (df["unique2"] <= b)]
        same(len(rows), int(sel.sum()), "phase 9 unaligned range count")
        krc = sess.last_physical
        k_ten, c_ten = _groups(raw["ten"][sel], None, "count")
        same(rows.groupby("ten").agg("count"), {"ten": k_ten, "count": c_ten},
             "phase 9 unaligned range group count")
    if not isinstance(krc, PH.KernelRangeCount) or krc.n_shards != MESH_SHARDS:
        raise AssertionError(f"phase 9: the range took {type(krc).__name__}")
    empty = [kw["block_ids_arr"] for name, _, kw, _ in calls
             if kw.get("block_ids_arr") is not None
             and bool((kw["block_ids_arr"] < 0).all())]
    if not empty:
        raise AssertionError("phase 9: no launch took an all -1 block row")
    check_recorded(calls, "phase 9 unaligned shards", MESH_KERNELS)
    print(f"  {UNALIGNED_ROWS:,} rows on {MESH_SHARDS} shards ({rps:,} rows a "
          f"shard, views at 16-byte phases {phases}): {len(calls)} per-shard "
          f"launches == plain, {len(empty)} of them on an all -1 block row",
          flush=True)


def run_mesh_live(dev, seed: int, card: str) -> dict:
    """Phase 6's scenario on the 8-shard mesh at a smaller depth, durable:
    MESH_LIVE_ROWS base rows (clustered by unique2, onePercent indexed) and
    the MESH_LIVE_MIX batches, one flush each, through a kernel session
    with a store; LIVE_QUERIES through it and a gspmd reader on the same
    mesh against the newest-wins oracle; one point lookup routed to one
    shard; then the store reopened onto the mesh and the suite again."""
    import shutil
    import tempfile

    import torch

    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(MESH_SHARDS, device=dev)
    rng = np.random.default_rng(seed)
    base = wisconsin.generate(MESH_LIVE_ROWS, seed=seed)
    dim = wisconsin.generate(LIVE_DIM_ROWS, seed=7)
    dim_u1 = dim.columns["unique1"].numpy()
    oracle_ = LiveOracle({k: v.numpy() for k, v in base.columns.items()})
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    out: dict = {"flush_s": []}

    def suite(kern, state):
        readers = {"kernel": kern,
                   "gspmd": Session(mode="gspmd", mesh=mesh, catalog=kern.catalog)}
        want = live_oracle(oracle_.cols, dim_u1)
        for m, sess in readers.items():
            df = AFrame("live", "Live", session=sess)
            dm = AFrame("live", "Dim", session=sess)
            for name, fn in LIVE_QUERIES.items():
                same(fn(df, dm), want[name], f"phase 9 live {name}[{m}] {state}")
        print(f"  [{card}] mesh live {state}: {len(LIVE_QUERIES)} queries, "
              f"kernel == gspmd == numpy over "
              f"{len(kern.catalog.components('live', 'Live'))} components",
              flush=True)

    try:
        kern = Session(mode="kernel", mesh=mesh, storage=str(root))
        kern.create_dataset("Live", base, dataverse="live", primary="unique2",
                            indexes=["onePercent"])
        kern.create_dataset("Dim", dim, dataverse="live")
        feed = Feed(kern, "Live", "live", flush_rows=10**9,
                    policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
        next_key = MESH_LIVE_ROWS
        for i, kind in enumerate(MESH_LIVE_MIX):
            batch = _live_batch(kind, i, rng, oracle_, next_key)
            t0 = time.perf_counter()
            if kind == "delete":
                feed.delete(batch)
            else:
                getattr(feed, kind)(batch)
            feed.flush()
            torch.cuda.synchronize()
            out["flush_s"].append(time.perf_counter() - t0)
            oracle_.apply(kind, batch)
            print(f"  [{card}] mesh live batch {i} ({kind}, {LIVE_BATCH:,} "
                  f"keys) acked and flushed in {out['flush_s'][-1]:.3f} s",
                  flush=True)
        suite(kern, "after the batches")
        df = AFrame("live", "Live", session=kern)
        key = int(oracle_.cols["unique2"][len(oracle_.cols["unique2"]) // 3])
        row = df.get(key)
        ph = kern.last_physical
        if row is None or int(row["unique2"][0]) != key or ph.shards != MESH_SHARDS:
            raise AssertionError(f"phase 9 point lookup of {key}: {row}")
        out["lookup"] = {"key": key, "probed": ph.probed,
                         "shard_probes": ph.shard_probes}
        if ph.shard_probes != ph.probed:
            raise AssertionError(f"phase 9: the lookup searched {ph.shard_probes} "
                                 f"shard windows over {ph.probed} component(s)")
        print(f"  point lookup {key}: {ph.label()}", flush=True)
        kern.close()
        t0 = time.perf_counter()
        re = Session.open(str(root), mode="kernel", mesh=mesh)
        out["open_s"] = time.perf_counter() - t0
        comps = re.catalog.components("live", "Live")
        if any(c.table.num_rows % MESH_SHARDS or c.table.device != mesh.device
               for c in comps):
            raise AssertionError("phase 9: a reopened component is not sharded "
                                 f"on {mesh.device}")
        print(f"  [{card}] Session.open onto the mesh in {out['open_s']:.3f} s "
              f"({len(comps)} components)", flush=True)
        suite(re, "after Session.open")
        re.close()
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def time_shard_sweep(table, dev, card: str) -> dict:
    """e3, e4, e9 and e12 in kernel mode at S = 1, 2, 4, 8 shards of the
    one card: wall (median of 7, result on the host) and device time per
    call (a profiler trace of 20 calls) — the cost of distribution, not a
    speedup."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh

    out: dict = {}
    for s in SHARD_SWEEP:
        sess = _mesh_sessions(table, make_local_mesh(s, device=dev),
                              ("kernel",))["kernel"]
        out[s] = {}
        for name in SHARD_TIMED:
            fn = EXPRESSIONS[name]

            def run(fn=fn):
                return fn(*_frames(sess), np.random.default_rng(1))

            wall = host_ms(run)
            # a 20-call trace: one call's records can all be lost
            dev_ms = _per_call_ms(run, None, 20)[0] or None
            out[s][name] = {"wall_ms": wall, "device_ms": dev_ms}
            shown = "not measured" if dev_ms is None else f"{dev_ms:.3f} ms"
            print(f"  [{card}] S={s} {name:16s} wall {wall:8.3f} ms, device "
                  f"{shown}", flush=True)
        del sess
        torch.cuda.empty_cache()
    return out


def run_mesh(table, raw: dict, dev, seed: int, card: str) -> dict:
    """Phase 9: the 12 expressions on an 8-shard mesh of the card in
    shard_map and kernel mode (each == numpy == the meshless kernel
    session), per-shard launches counted and every one held against its
    plain version, the block-skipping ranges per shard; then the unaligned
    shard views, the live scenario on the mesh and the shard sweep."""
    import torch

    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    flat = Session(mode="kernel", device=dev)
    for name in ("data", "data_r"):
        flat.create_dataset(name, table, dataverse="bench")
    # the meshless answers first: their launches are not the mesh path's
    want = {(name, r): fn(*_frames(flat), np.random.default_rng(100 + r))
            for name, fn in EXPRESSIONS.items() for r in range(ROUNDS)}
    del flat
    mesh = make_local_mesh(MESH_SHARDS, device=dev)
    t0 = time.perf_counter()
    sessions = _mesh_sessions(table, mesh)
    torch.cuda.synchronize()
    print(f"  two {MESH_SHARDS}-shard sessions ({ROWS // MESH_SHARDS:,} rows, "
          f"{-(-(ROWS // MESH_SHARDS) // 4096)} zone blocks a shard) placed in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out: dict = {"per_expr": {}, "notes": {}}
    for m, sess in sessions.items():
        calls: list = []
        per_expr = out["per_expr"][m] = {}
        _build.reset_launches()
        with recording(calls):
            for name, fn in EXPRESSIONS.items():
                before = dict(_build.LAUNCHES)
                for r in range(ROUNDS):
                    got = fn(*_frames(sess), np.random.default_rng(100 + r))
                    same(got, oracle_round(raw, name, r),
                         f"phase 9 {name}[{m}] round {r}")
                    same(got, want[(name, r)], f"phase 9 {name}[{m}] vs meshless")
                per_expr[name] = {k: (v - before[k]) // ROUNDS
                                  for k, v in _build.LAUNCHES.items()
                                  if v > before[k]}
                print(f"  {name}[{m}]: mesh == meshless == numpy over {ROUNDS} "
                      f"rounds ({type(sess.last_physical).__name__}; launches "
                      f"per run {per_expr[name]})", flush=True)
            out["notes"][m] = _mesh_ranges(sess, raw, ROUNDS, f"phase 9 [{m}]")
        torch.cuda.synchronize()
        launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
        print(f"  [{m}] unique2 range: {out['notes'][m]}", flush=True)
        print(f"  [{m}] kernel launches on the mesh path: {launches}", flush=True)
        if m == "shard_map":
            if any(launches.values()):
                raise AssertionError(f"shard_map launched kernels: {launches}")
            continue
        out["launches"] = launches
        missing = [k for k, v in launches.items() if v == 0]
        if missing:
            raise AssertionError(f"kernels never launched on the mesh: {missing}")
        check_recorded(calls, f"phase 9 ({MESH_SHARDS} shards)", MESH_KERNELS)
    del sessions
    torch.cuda.empty_cache()
    check_unaligned_shards(dev, seed)
    out["live"] = run_mesh_live(dev, seed, card)
    out["sweep"] = time_shard_sweep(table, dev, card)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  [{card}] phase 9 in {out['seconds']:.1f} s", flush=True)
    return out


# -- phase 10: serving (prefill + KV-cache decode) ------------------------------

SERVE_ARCH = "qwen3-1.7b"   # the slice's first model path, at its published width
SERVE_BATCH = 8             # requests
SERVE_PROMPT = 4_096        # prompt tokens a request
SERVE_NEW = 64              # new tokens a request: the prefill's + 63 decode steps
SERVE_LAYERS = 28
# Flash (the CUDA kernels) vs blocked (the einsum path, the reference's
# default) logits at one step, teacher-forced on the same tokens: bf16
# rounds at other places in the two paths (the tensor-core P.V of
# flash_mha_fwd, float32 P in flash_decode, bf16 P in the einsum), which
# compounds over 28 layers: on an H100 (700 W) the largest difference over
# 64 steps was 0.125, and a planted fault (q from the neighbouring head in
# every layer's flash_decode), which the phase checks against it, 3.6.
SERVE_TOL = 0.25
SERVE_CHECK_STEPS = 4       # decode steps of the onehot == dus check
FAMILY_CELLS = (("deepseek-moe-16b", 4), ("llava-next-mistral-7b", 4),
                ("zamba2-1.2b", None), ("rwkv6-1.6b", None),
                ("whisper-base", None))
FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS = 2, 512, 16
# prefill(n) + decode(1) vs prefill(n + 1) in bf16, as SERVE_TOL: on an
# H100 0.02 (whisper-base) to 0.14 (zamba2-1.2b's 38 layers)
FAMILY_TOL = 0.25
STEP_KERNELS = (("flash_decode", ("flash_decode",)),
                ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
                ("copy / cast", ("copy", "Copy")))


def _path_stats() -> dict:
    return {name: {"calls": 0, "bad": 0, "max_abs_err": 0.0, "strided": 0}
            for name in ("flash_mha_fwd", "flash_decode")}


@contextlib.contextmanager
def checking_path(stats: dict):
    """Every ``flash_mha_fwd`` and ``flash_decode`` call the path makes is
    held at once against its plain version on the same (strided) inputs —
    at once, since the next step writes into the cache those views read —
    with phase 2's row-scaled bf16 tolerance (and lse within 2e-2); the
    prefill's plain version runs a batch row at a time to bound its float32
    scores. The verdicts stay on the card until the block ends. Adds no
    launch. ``stats`` is ``_path_stats()``."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    fwd, dec = fa.flash_mha_fwd, da.flash_decode
    dev_stats: dict = {"flash_mha_fwd": [], "flash_decode": []}

    def verdict(name, out, want, extra_bad=None):
        want = want.float()
        err = (out.float() - want).abs()
        bound = 2e-2 * (want.abs() + want.abs().amax(dim=-1, keepdim=True))
        bad = (err > bound).any()
        if extra_bad is not None:
            bad = bad | extra_bad
        dev_stats[name].append(torch.stack([bad.float(), err.max()]))

    def checked_fwd(q, k, v, *, causal=True, **kw):
        out, lse = fwd(q, k, v, causal=causal, **kw)
        parts = [fa.flash_mha_fwd_plain(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                        causal=causal) for b in range(q.shape[0])]
        want = torch.cat([p[0] for p in parts])
        plse = torch.cat([p[1] for p in parts])
        verdict("flash_mha_fwd", out, want,
                ~torch.isclose(lse, plse, rtol=2e-2, atol=2e-2).all())
        stats["flash_mha_fwd"]["strided"] += int(not q.is_contiguous())
        return out, lse

    def checked_dec(q, k, v, lengths):
        out = dec(q, k, v, lengths)
        verdict("flash_decode", out, da.flash_decode_plain(q, k, v, lengths))
        stats["flash_decode"]["strided"] += int(not k.is_contiguous())
        return out

    fa.flash_mha_fwd, da.flash_decode = checked_fwd, checked_dec
    try:
        yield stats
    finally:
        fa.flash_mha_fwd, da.flash_decode = fwd, dec
    for name, rows in dev_stats.items():
        if rows:
            s = torch.stack(rows).cpu()
            stats[name]["calls"] += len(rows)
            stats[name]["bad"] += int(s[:, 0].sum())
            stats[name]["max_abs_err"] = max(stats[name]["max_abs_err"],
                                             float(s[:, 1].max()))


@contextlib.contextmanager
def planted(module, name: str):
    """``module.name`` run on q taken from the neighbouring head: the fault
    the flash-vs-blocked tolerance must see."""
    real = getattr(module, name)
    setattr(module, name, lambda q, *a, **kw: real(q.roll(1, dims=1), *a, **kw))
    try:
        yield
    finally:
        setattr(module, name, real)


def check_published(cfg) -> None:
    got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head,
           cfg.d_ff, cfg.vocab, cfg.qk_norm)
    if got != (SERVE_LAYERS, 2048, 16, 8, 128, 6144, 151_936, True):
        raise AssertionError(f"{SERVE_ARCH} is not its published config: {got}")


def _serve_cfg(arch: str, impl: str, layers=None):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    if layers is not None and layers != cfg.n_layers:
        print(f"  {arch} reduced: n_layers {cfg.n_layers} → {layers}", flush=True)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    return dataclasses.replace(cfg, attn_impl=impl)


def _logits_run(cfg, model, batch, max_len: int, steps: int, forced=None):
    """``registry`` prefill, then ``steps`` decode steps, greedy or fed the
    (steps, B) ``forced`` tokens. Returns the (steps + 1, B, V) float32
    last logits, the (steps + 1, B) greedy tokens and the cache."""
    import torch

    from repro_torch.models import registry

    api = registry.get_api(cfg)
    with torch.no_grad():
        cache, lg = api.prefill(model, batch, cfg, max_len)
        logits = [lg[:, -1]]
        for t in range(steps):
            tok = logits[-1].argmax(-1) if forced is None else forced[t]
            cache, lg = api.decode(model, cache, tok.to(torch.int32)[:, None], cfg)
            logits.append(lg[:, -1])
    logits = torch.stack(logits)
    return logits, logits.argmax(-1), cache


def _step_ms(cfg, model, cache, first, steps: int) -> list:
    """CUDA-event time of each of ``steps`` greedy decode steps through
    ``steps.make_decode_step``, one sync at the end (a step's time is the
    device's, idle gaps included)."""
    import torch

    from repro_torch.models import steps as st

    decode = st.make_decode_step(cfg)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    tok = first
    ev[0].record()
    for i in range(steps):
        cache, tok = decode(model, cache, tok)
        ev[i + 1].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(steps)]


def _p(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q))


def _by_kind(rows, table) -> dict:
    """Device ms of (name, ms, records) ``rows`` summed by the first kind
    of ``table`` ((kind, name patterns), ...) a name matches, the rest
    under "other"."""
    kinds = {name: 0.0 for name, _ in table}
    kinds["other"] = 0.0
    for key, ms, _ in rows:
        kinds[next((name for name, pats in table
                    if any(p in key for p in pats)), "other")] += ms
    return kinds


def _step_breakdown(fn) -> dict:
    """One profiled decode step's device ms by kind (flash_decode, GEMMs,
    copies and casts, the rest: the cache write's products and sums and
    the other elementwise work) and the top kernels by name."""
    rows = device_breakdown(fn, top=1000)
    kinds = _by_kind(rows, STEP_KERNELS)
    return {"by_kind": kinds, "total": sum(kinds.values()), "top": rows[:12]}


def run_serving(dev, seed: int, card: str) -> dict:
    """Phase 10: qwen3-1.7b at its published config serving SERVE_BATCH
    requests of SERVE_PROMPT + SERVE_NEW tokens through ``registry`` and
    ``steps`` as ``launch/serve.py`` drives them, under flash (the path)
    and blocked (the reference's default); then the other families at
    their published widths."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg = _serve_cfg(SERVE_ARCH, "flash")
    check_published(cfg)
    blocked = _serve_cfg(SERVE_ARCH, "blocked")
    api = registry.get_api(cfg)
    B, P, NEW = SERVE_BATCH, SERVE_PROMPT, SERVE_NEW
    t0 = time.perf_counter()
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    batch = serve.make_batch(cfg, B, P, np.random.default_rng(seed), dev)
    max_len = registry.prefill_cache_len(cfg, P) + NEW
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    cache_gb = 2 * cfg.n_layers * B * max_len * cfg.n_kv_heads * cfg.d_head * 2 / 1e9
    print(f"  {SERVE_ARCH}: {n_params:,} parameters (float32, "
          f"{n_params * 4 / 1e9:.2f} GB), {B} requests x ({P} + {NEW}) tokens, "
          f"cache {cache_gb:.2f} GB bf16 (max_len {max_len}); set up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # the reference's default path, greedy: its tokens and top-2 margins
    b_logits, b_tokens, _ = _logits_run(blocked, model, batch, max_len, NEW - 1)
    top2 = b_logits.topk(2, dim=-1).values
    margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    if not bool(torch.isfinite(b_logits).all()):
        raise AssertionError("blocked logits not finite")

    # the main path: serve.generate under flash, launch counts zeroed just
    # before and read just after, every flash_mha_fwd and flash_decode call
    # held against plain
    stats = _path_stats()
    _build.reset_launches()
    with checking_path(stats):
        out = serve.generate(cfg, model, batch, NEW)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    want = {"flash_mha_fwd": SERVE_LAYERS, "flash_decode": SERVE_LAYERS * (NEW - 1)}
    if {k: launches[k] for k in want} != want:
        raise AssertionError(f"serve launches {launches}, want {want}")
    for name, n in want.items():
        st = stats[name]
        if st["bad"] or st["calls"] != n or st["strided"] != n:
            raise AssertionError(f"{name} on the path vs plain: {stats}")
    pre, dec = stats["flash_mha_fwd"], stats["flash_decode"]
    print(f"  main path (serve.generate, flash): launches "
          f"{ {k: v for k, v in launches.items() if v} } = {SERVE_LAYERS} "
          f"flash_mha_fwd for the prefill, {SERVE_LAYERS} flash_decode per "
          f"decode step; {pre['calls']} flash_mha_fwd calls on the strided "
          f"(B,H,S,hd) views of the projections ({B}, 16, 8, {P}, 128 causal) "
          f"== plain (max abs err {pre['max_abs_err']:.3g}), {dec['calls']} "
          f"flash_decode calls, each on the strided (B,KV,S,hd) views of its "
          f"layer's cache, == plain (max abs err {dec['max_abs_err']:.3g}); "
          f"tolerance 2e-2 x row scale", flush=True)
    f_free = out["tokens"].cpu().numpy()

    # flash teacher-forced on the blocked tokens: logits step by step, and
    # the launches of each decode step
    _build.reset_launches()
    f_logits, f_tokens, _ = _logits_run(cfg, model, batch, max_len, NEW - 1,
                                        forced=b_tokens[:-1])
    torch.cuda.synchronize()
    if _build.LAUNCHES["flash_decode"] != SERVE_LAYERS * (NEW - 1):
        raise AssertionError(f"teacher-forced run: {_build.LAUNCHES}")
    diff = (f_logits - b_logits).abs().amax(dim=(1, 2)).cpu().numpy()
    if not bool(torch.isfinite(f_logits).all()) or diff.max() > SERVE_TOL:
        raise AssertionError(f"flash vs blocked logits: max abs diff per step "
                             f"{diff.tolist()} beyond {SERVE_TOL}")
    differ = (f_tokens != b_tokens).cpu().numpy()
    near = margins <= SERVE_TOL
    if np.any(differ & ~near):
        raise AssertionError(f"flash vs blocked: {int((differ & ~near).sum())} "
                             f"greedy tokens differ with a margin above {SERVE_TOL}")
    # the planted faults: q from the neighbouring head in every
    # flash_mha_fwd of the prefill, and in every flash_decode of one step,
    # must each move the logits beyond the tolerance
    with torch.no_grad():
        with planted(fa, "flash_mha_fwd"):
            _, bad = api.prefill(model, batch, cfg, max_len)
        planted_pre = float((bad[:, -1] - b_logits[0]).abs().max())
        c, _ = api.prefill(model, batch, cfg, max_len)
        with planted(da, "flash_decode"):
            _, bad = api.decode(model, c, b_tokens[0].to(torch.int32)[:, None], cfg)
        del c
    planted_dec = float((bad[:, -1] - b_logits[1]).abs().max())
    if min(planted_pre, planted_dec) <= SERVE_TOL:
        raise AssertionError(f"a planted fault moved the logits by {planted_pre} "
                             f"(prefill) / {planted_dec} (decode), within the "
                             f"tolerance {SERVE_TOL}")
    free_same = int((f_free == b_tokens.T.cpu().numpy()).all(axis=0).cumprod().sum())
    print(f"  flash vs blocked, teacher-forced on blocked's tokens: max abs "
          f"logit diff {diff.max():.4f} over {NEW} steps (median "
          f"{np.median(diff):.4f}; tolerance {SERVE_TOL}; a planted wrong q "
          f"head moves them {planted_pre:.3f} in flash_mha_fwd, "
          f"{planted_dec:.3f} in flash_decode); {int(differ.sum())} of "
          f"{differ.size} greedy tokens differ, all within the top-2 margin "
          f"{SERVE_TOL} ({int(near.sum())} such); free-running flash equals "
          f"blocked for the first {free_same} tokens of every request",
          flush=True)

    # prefill(n) + decode(1) == prefill(n + 1), and onehot == dus, on flash
    with torch.no_grad():
        part = dict(batch, tokens=batch["tokens"][:, :P - 1])
        c, _ = api.prefill(model, part, cfg, max_len)
        _, lg = api.decode(model, c, batch["tokens"][:, P - 1:P], cfg)
        consist = float((lg[:, -1] - f_logits[0]).abs().max())
        del c
        if consist > SERVE_TOL:
            raise AssertionError(f"prefill({P - 1}) + decode(1) vs prefill({P}): "
                                 f"{consist}")
        c1, _ = api.prefill(model, batch, cfg, max_len)
        c2 = {k: v.clone() for k, v in c1.items()}
        dus = dataclasses.replace(cfg, decode_cache_update="dus")
        for t in range(SERVE_CHECK_STEPS):
            tok = b_tokens[t].to(torch.int32)[:, None]
            c1, l1 = api.decode(model, c1, tok, cfg)
            c2, l2 = api.decode(model, c2, tok, dus)
            if not torch.equal(l1, l2):
                raise AssertionError(f"onehot vs dus logits differ at step {t}")
        if not (torch.equal(c1["k"], c2["k"]) and torch.equal(c1["v"], c2["v"])):
            raise AssertionError("onehot vs dus caches differ")
        del c1, c2
    torch.cuda.empty_cache()
    print(f"  prefill({P - 1}) + decode(1) vs prefill({P}) on flash: max abs "
          f"logit diff {consist:.4f} (tolerance {SERVE_TOL}); decode_cache_update "
          f"'dus' == 'onehot' bit for bit over {SERVE_CHECK_STEPS} steps "
          f"(logits and the whole cache)", flush=True)

    timing = {}
    for label, c in (("flash", cfg), ("blocked", blocked)):
        serve.generate(c, model, batch, 4)  # warm
        g = serve.generate(c, model, batch, NEW)
        with torch.no_grad():
            pre = lambda c=c: api.prefill(model, batch, c, max_len)
            cache, lg = pre()
            first = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            ms = _step_ms(c, model, cache, first, NEW - 1)
            prefill_dev = device_ms(pre)
            cache, _ = pre()
            step = lambda: api.decode(model, cache, first, c)
            bd = _step_breakdown(step)
            del cache
        torch.cuda.empty_cache()
        parts = step_parts(model, c, api, batch, max_len) if label == "flash" else {}
        dec_s = g["decode_s"]
        t = {"prefill_wall_ms": g["prefill_s"] * 1e3,
             "prefill_device_ms": prefill_dev,
             "decode_wall_ms": dec_s * 1e3,
             "decode_ms_per_step_median": _p(ms, 50),
             "decode_ms_per_step_p90": _p(ms, 90),
             "decode_tok_per_s": B * (NEW - 1) / dec_s,
             "prefill_tok_per_s": B * P / g["prefill_s"],
             "step_device_ms": bd["total"],
             "busy": bd["total"] / (dec_s * 1e3 / (NEW - 1)),
             "step_by_kind_ms": bd["by_kind"], "step_top": bd["top"],
             **parts}
        timing[label] = t
        print(f"  {label:7s} [{card}] prefill {B}x{P}: wall {t['prefill_wall_ms']:.1f} "
              f"ms, device {prefill_dev:.1f} ms ({t['prefill_tok_per_s']:.0f} "
              f"tok/s); decode {NEW - 1} steps: {t['decode_wall_ms']:.1f} ms, "
              f"per step median {t['decode_ms_per_step_median']:.3f} ms, p90 "
              f"{t['decode_ms_per_step_p90']:.3f} ms, {t['decode_tok_per_s']:.0f} "
              f"tok/s, one step's device time {bd['total']:.3f} ms (busy "
              f"{t['busy']:.0%})", flush=True)
        print(f"    one decode step's device ms by kind: " + ", ".join(
            f"{k} {v:.3f}" for k, v in bd["by_kind"].items()), flush=True)
        for key, kms, n in bd["top"]:
            print(f"      {kms:9.4f} ms {n:5d} records  {key}", flush=True)
        if parts:
            print(f"    a step's parts alone (CUDA events, 20 calls): the "
                  f"one-hot cache write of the {cfg.n_layers} layers "
                  f"{parts['cache_write_onehot_ms']:.3f} ms (the 'dus' slice "
                  f"write {parts['cache_write_dus_ms']:.3f} ms); the float32 -> "
                  f"bf16 casts of every weight matrix "
                  f"{parts['weight_casts_ms']:.3f} ms", flush=True)

    # row 6'': flash_decode alone at the serve shape, on the strided views
    # of a layer of the cache as the path hands them over
    with torch.no_grad():
        cache, _ = api.prefill(model, batch, cfg, max_len)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, cfg.n_heads, cfg.d_head), generator=gen,
                    device=dev).to(torch.bfloat16)
    k, v = cache["k"][0].transpose(1, 2), cache["v"][0].transpose(1, 2)
    lens = torch.full((B,), P, dtype=torch.int32, device=dev)
    row = time_serve_decode((q, k, v, lens), dec["max_abs_err"],
                            launches["flash_decode"])
    del cache, model, b_logits, f_logits
    torch.cuda.empty_cache()
    print_kernel_row(row)

    families = {}
    for arch, layers in FAMILY_CELLS:
        families[arch] = run_family(arch, layers, dev, seed, card)
    return {"arch": SERVE_ARCH, "batch": B, "prompt": P, "new_tokens": NEW,
            "max_len": max_len, "launches": launches,
            "recorded": stats, "flash_vs_blocked_max_diff": float(diff.max()),
            "planted_fault_diff": {"flash_mha_fwd": planted_pre,
                                   "flash_decode": planted_dec},
            "tokens_differ": int(differ.sum()),
            "consistency_diff": consist, "timing": timing, "row": row,
            "families": families}


def step_parts(model, cfg, api, batch, max_len: int) -> dict:
    """Two parts of a decode step timed alone on a fresh prefill cache: the
    cache write of every layer (one-hot, and the "dus" slice write beside
    it) and the per-call float32 -> bf16 casts of every weight matrix."""
    import torch

    from repro_torch.models import attention as attn

    with torch.no_grad():
        cache, _ = api.prefill(model, batch, cfg, max_len)
    B = batch["tokens"].shape[0]
    new = torch.zeros((B, 1, cfg.n_kv_heads, cfg.d_head), dtype=torch.bfloat16,
                      device=cache["k"].device)

    def write(upd):
        for i in range(cache["k"].shape[0]):
            upd(cache["k"][i], cache["v"][i], new, new, cache["pos"])

    mats = [p for p in model.parameters() if p.dim() >= 2]
    out = {"cache_write_onehot_ms": cuda_ms(lambda: write(attn.update_cache_layer)),
           "cache_write_dus_ms": cuda_ms(lambda: write(attn.update_cache_layer_dus)),
           "weight_casts_ms": cuda_ms(lambda: [p.to(torch.bfloat16) for p in mats])}
    del cache
    return out


def time_serve_decode(case, err: float, launches: int) -> dict:
    """Row 6'': flash_decode at the serve shape. Bound: the kernel's
    ``flash_decode_cost`` (the valid slots' K and V bytes, q and out once
    over HBM_BYTES_PER_S); library: masked SDPA over the same views
    (GQA)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da

    q, k, v, lens = case
    B, H, D = q.shape
    KV, S = k.shape[1], k.shape[2]
    work = da.flash_decode_cost(q, k, lens)
    mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None]
    row = _timed("flash_decode", ("flash_decode_split_kernel",
                                  "flash_decode_merge_kernel"),
                 lambda: da.flash_decode(q, k, v, lens),
                 lambda: da.flash_decode_plain(q, k, v, lens),
                 lambda: F.scaled_dot_product_attention(
                     q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
                 work["bytes"], work["flops"], err, launches,
                 f"serve shape: q ({B}, {H}, {D}), cache views ({B}, {KV}, {S}, "
                 f"{D}) bf16 of (B,S,KV,D) memory, every length {int(lens[0])}, "
                 f"slices of {da.split_size(B, KV, S)}", ops_per_s=BF16_OPS_PER_S)
    return row


@contextlib.contextmanager
def routing(record: list, forced=None):
    """Wraps ``moe._top_k``: each MoE layer's (T, top_k) expert ids are
    appended to ``record`` in call order; with ``forced`` (such a list),
    each call takes the next ids in it instead of its own top-k, with its
    own probabilities there as gates."""
    from repro_torch.models import moe

    top_k = moe._top_k

    def recorded(probs, k):
        if forced is None:
            vals, idx = top_k(probs, k)
        else:
            idx = forced[len(record)]
            vals = probs.gather(-1, idx)
        record.append(idx)
        return vals, idx

    moe._top_k = recorded
    try:
        yield record
    finally:
        moe._top_k = top_k


def forced_routing(full: list, B: int, P: int) -> dict:
    """prefill(P)'s expert ids per layer, cut to what prefill(P - 1) and
    the decode step of token P - 1 route."""
    by = [r.reshape(B, P, -1) for r in full]
    return {"full": full,
            "part": [r[:, :P - 1].reshape(B * (P - 1), -1) for r in by],
            "dec": [r[:, P - 1] for r in by]}


def routing_flips(recs: dict, B: int, P: int) -> dict:
    """Tokens whose expert set in some MoE layer differs between prefill(P)
    and prefill(P - 1) + decode(1): in all, per request, and the requests
    whose decoded token is among them."""
    import torch

    flip = torch.zeros((B, P), dtype=torch.bool, device=recs["full"][0].device)
    for f, p, d in zip(recs["full"], recs["part"], recs["dec"]):
        f = f.reshape(B, P, -1).sort(dim=-1).values
        flip[:, :P - 1] |= (f[:, :P - 1] != p.reshape(B, P - 1, -1)
                            .sort(dim=-1).values).any(dim=-1)
        flip[:, P - 1] |= (f[:, P - 1] != d.sort(dim=-1).values).any(dim=-1)
    per = flip.sum(dim=1).tolist()
    return {"tokens": int(flip.sum()), "per_request": per,
            "decoded": [b for b in range(B) if bool(flip[b, P - 1])]}


def run_family(arch: str, layers, dev, seed: int, card: str) -> dict:
    """One family at its published widths (depth cut where ``layers`` is
    given): prefill FAMILY_BATCH x FAMILY_PROMPT, prefill(n) + decode(1)
    against prefill(n + 1), then serve.generate with FAMILY_STEPS decode
    steps, its launches counted."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg = _serve_cfg(arch, "flash", layers)
    api = registry.get_api(cfg)
    t0 = time.perf_counter()
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    B, P, n = FAMILY_BATCH, FAMILY_PROMPT, FAMILY_STEPS
    batch = serve.make_batch(cfg, B, P, np.random.default_rng(seed), dev)
    max_len = registry.prefill_cache_len(cfg, P) + n + 1
    # MoE drops the choices past an expert's capacity, and which it drops
    # depends on the batch (1,024 tokens in a prefill, 2 in a decode step),
    # so the consistency check runs dropless (capacity_factor E / top_k:
    # every expert's capacity holds every token), as the reference's own
    # consistency tests do at capacity_factor 8; serving below keeps the
    # published 1.25
    same = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))

    part = dict(batch, tokens=batch["tokens"][:, :P - 1])

    def consistency(forced=None):
        """prefill(P) against prefill(P - 1) + decode(1): the last logits,
        their largest difference per request, and each run's routing."""
        recs = {"full": [], "part": [], "dec": []}
        with torch.no_grad():
            with routing(recs["full"], forced and forced["full"]):
                _, full = api.prefill(model, batch, same, max_len)
            with routing(recs["part"], forced and forced["part"]):
                c, _ = api.prefill(model, part, same, max_len)
            with routing(recs["dec"], forced and forced["dec"]):
                _, dec = api.decode(model, c, batch["tokens"][:, P - 1:P], same)
        gap = (full[:, -1].float() - dec[:, -1].float()).abs().amax(dim=-1)
        return full, dec, gap, recs

    full, dec, gap, recs = consistency()
    if not (bool(torch.isfinite(full).all()) and bool(torch.isfinite(dec).all())):
        raise AssertionError(f"{arch}: logits not finite")
    d = float(gap.max())
    routed = None
    if cfg.moe is not None:
        # With 64 experts some router top-k sit within bf16 noise of the
        # next choice, and the noise differs between a prefill and a decode
        # step, so a token may take other experts in the two runs: a jump
        # no tolerance on logits bounds. Counted per token (prefix and
        # decoded token, every MoE layer); a request whose tokens all keep
        # their experts is held to FAMILY_TOL, and so is every request when
        # prefill(P - 1) and the decode step are made to take prefill(P)'s
        # experts (each its own gates there). With the routers zeroed every
        # token takes experts 0..top_k-1 in both runs: held as well.
        flips = routing_flips(recs, B, P)
        agree = [b for b in range(B) if not flips["per_request"][b]]
        if any(float(gap[b]) > FAMILY_TOL for b in agree):
            raise AssertionError(f"{arch}: requests {agree} keep their experts, "
                                 f"yet differ by {gap.tolist()}")
        _, _, fgap, _ = consistency(forced_routing(recs["full"], B, P))
        held = [blk.moe.router.detach().clone() for blk, moe in model.blocks() if moe]
        with torch.no_grad():
            for blk, moe in model.blocks():
                if moe:
                    blk.moe.router.zero_()
            _, _, zgap, _ = consistency()
            for (blk, _), r in zip([b for b in model.blocks() if b[1]], held):
                blk.moe.router.copy_(r)
        routed = {"seeded": gap.tolist(), "flipped_tokens": flips["tokens"],
                  "flipped_per_request": flips["per_request"],
                  "decoded_token_flipped": flips["decoded"],
                  "forced": fgap.tolist(), "zeroed": zgap.tolist()}
        d = max(float(fgap.max()), float(zgap.max()),
                max((float(gap[b]) for b in agree), default=0.0))
        print(f"  {arch} routing, prefill({P}) vs prefill({P - 1}) + decode(1), "
              f"dropless: {flips['tokens']} of {B * P} tokens take other experts "
              f"in some MoE layer (per request {flips['per_request']}; the "
              f"decoded token in requests {flips['decoded']}); last-logit gap "
              f"per request with the seeded routers {[round(x, 4) for x in gap.tolist()]}, "
              f"with every run on prefill({P})'s experts "
              f"{[round(x, 4) for x in fgap.tolist()]}, routers zeroed "
              f"{[round(x, 4) for x in zgap.tolist()]} (tolerance {FAMILY_TOL} "
              f"on the forced, zeroed and agreeing runs)", flush=True)
    if d > FAMILY_TOL:
        raise AssertionError(f"{arch}: prefill({P - 1}) + decode(1) vs "
                             f"prefill({P}) {d} beyond {FAMILY_TOL}")
    attn_layers = {"dense": cfg.n_layers, "moe": cfg.n_layers, "vlm": cfg.n_layers,
                   "encdec": cfg.n_layers, "hybrid": 0, "rwkv": 0}[cfg.family]
    want_pre = {"encdec": cfg.enc_layers + cfg.n_layers, "rwkv": 0,
                "hybrid": -(-cfg.n_layers // max(cfg.attn_every, 1))}.get(
                    cfg.family, cfg.n_layers)
    serve.generate(cfg, model, batch, 2)  # warm
    _build.reset_launches()
    g = serve.generate(cfg, model, batch, n + 1)
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    want = {"flash_mha_fwd": want_pre, "flash_decode": attn_layers * n}
    if {k: _build.LAUNCHES[k] for k in want} != want:
        raise AssertionError(f"{arch}: launches {launches}, want {want}")
    n_params = sum(p.numel() for p in model.parameters())
    del model
    torch.cuda.empty_cache()
    out = {"layers": cfg.n_layers, "params": n_params, "consistency_diff": d,
           "consistency_diff_routed": routed,
           "launches": launches, "prefill_ms": g["prefill_s"] * 1e3,
           "decode_ms_per_step": g["decode_s"] * 1e3 / n,
           "decode_tok_per_s": B * n / g["decode_s"],
           "seconds": time.perf_counter() - t0}
    print(f"  {arch} ({cfg.family}, {cfg.n_layers} layers, {n_params:,} "
          f"parameters) [{card}]: prefill {B}x{P} {out['prefill_ms']:.1f} ms, "
          f"decode {out['decode_ms_per_step']:.2f} ms/step "
          f"({out['decode_tok_per_s']:.0f} tok/s); prefill({P - 1}) + "
          f"decode(1) vs prefill({P}) {d:.4f} (tolerance {FAMILY_TOL}"
          + ("" if routed is None else ", the largest of the held MoE runs")
          + f"); launches {launches}", flush=True)
    return out


# -- phase 11: training --------------------------------------------------------

TRAIN_ARCH = "qwen3-1.7b"   # the slice's first training path, at its published width
TRAIN_BATCH = 4             # sequences a step
TRAIN_SEQ = 2_048           # tokens a sequence: 8,192 a step
TRAIN_STEPS = 5             # the main path's steps, on one repeated batch
TRAIN_OPT = dict(lr=3e-4, warmup_steps=0, total_steps=1_000)
# Flash (flash_mha_fwd + flash_attention_bwd) vs blocked (plain autograd,
# the reference's default) after one step from the same weights: bf16
# rounds at other places in the two attention paths (P.V and ds.K on the
# tensor cores in bf16, the einsum in float32 then bf16), which compounds
# over 28 layers. The gate holds the loss, the global grad norm, every
# parameter's gradient before the clip and dq / dk / dv at every layer
# (each by its relative L2 difference, the worst leaf or layer and
# tensor); PERF.md gives each limit
# beside its reading on the card and the planted faults' readings. The
# relative L2 of the weight update is printed, not held: AdamW's first
# step is about sign(g) x lr, so every element whose gradient is rounding
# noise moves a full step either way.
TRAIN_TOL = {"loss": 1e-3,          # relative
             "grad_norm": 1e-2,     # relative
             "grads": 0.1,          # worst leaf: |g_flash - g_blocked| / |g_blocked|
             "dqkv": 0.1}           # worst layer and tensor, the same ratio
FAMILY_TRAIN_SEQ = 512      # tokens a sequence of the other families' step (x FAMILY_BATCH)
TRAIN_KINDS = (("flash_attention_bwd", ("flash_bwd_",)),
               ("flash_mha_fwd", ("flash_fwd_",)),
               ("GEMM", ("gemm", "nvjet", "cutlass", "xmma", "sm90_", "cublas")),
               ("copy / cast", ("copy", "Copy")))


@contextlib.contextmanager
def captured_qkv_grads(n_layers: int, out: dict, ref: dict | None = None):
    """The gradients of every layer's q, k and v projections (the
    (B,S,H,D) tensors ``attention_core`` takes, after qk-norm and rope):
    dq, dk and dv of its attention, whichever path computes them. A tensor
    hook on the forward's own tensors (the first ``n_layers`` calls of a
    step; remat's recomputations come later) fires as the backward passes
    them. Without ``ref`` each gradient is kept on the card under
    ``out[(layer, name)]``; with it (a dict so filled) ``out`` gets the
    gradient's relative L2 difference from ``ref``'s, a 0-d tensor on the
    card. Adds no launch."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models import transformer

    real = attn.attention_core
    calls = [0]

    def keep(key, g):
        g = g.detach()
        if ref is None:
            out[key] = g.clone()
        else:
            want = ref[key].float()
            out[key] = torch.linalg.vector_norm(g.float() - want) \
                / torch.linalg.vector_norm(want).clamp_min(1e-30)

    def core(q, k, v, *a, **kw):
        if calls[0] < n_layers:
            for name, t in (("dq", q), ("dk", k), ("dv", v)):
                t.register_hook(lambda g, key=(calls[0], name): keep(key, g))
        calls[0] += 1
        return real(q, k, v, *a, **kw)

    transformer.attention_core = core
    try:
        yield out
    finally:
        transformer.attention_core = real


@contextlib.contextmanager
def captured_grads(model, out: dict, ref: dict | None = None,
                   update: bool = True, noise: tuple = ()):
    """Every parameter's gradient as the train step hands it to
    ``adamw_update`` (before the clip; on a mesh, the merged one). Without
    ``ref`` each is kept on the card under ``out[name]``; with it
    ``out[name]`` is the relative L2 difference from ``ref[name]``, a 0-d
    tensor on the card (for a name in ``noise``, a leaf whose exact
    gradient is zero, the L2 difference itself). Without ``update`` the
    step leaves the weights and the AdamW state as they were and reports
    the gradients' global norm (on a rank mesh over every rank's blocks,
    as the update's clip reads it)."""
    import torch

    from repro_torch.models import optim, sharding, steps

    real = steps.adamw_update

    def update_fn(*a, **kw):
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.grad is None:
                    continue
                if ref is None:
                    out[name] = p.grad.detach().clone()
                else:
                    want = ref[name]
                    out[name] = torch.linalg.vector_norm(p.grad - want)
                    if name not in noise:
                        out[name] /= torch.linalg.vector_norm(want).clamp_min(1e-30)
            if not update:
                ctx = sharding.current_ctx()
                where = sharding.spread(model) if ctx is not None and ctx.ranked \
                    else {}   # a placed model's blocks: each counted once
                spreads = [where[n] for n, _ in model.named_parameters()] \
                    if where else None
                return {"grad_norm": optim.global_norm(
                            [p.grad for p in model.parameters()], spreads),
                        "lr": torch.full((), float("nan"))}
        return real(*a, **kw)

    steps.adamw_update = update_fn
    try:
        yield out
    finally:
        steps.adamw_update = real


@contextlib.contextmanager
def checking_bwd(stats: dict, limit: int | None = None):
    """Every ``flash_attention_bwd`` call the step makes (the first
    ``limit`` where given) is held at once against
    ``flash_attention_bwd_plain`` on the same q, k, v, out, lse and dO (the
    strided views, remat's recomputed lse, dO as the chunked CE's backward
    hands it): each of dq, dk and dv within BWD_TOL["bfloat16"] of its own
    largest |value|, as phase 2. The verdicts stay on the card until the
    block ends; ``stats`` gets "calls", "bad" and "max_err" (relative to
    scale). Adds no launch."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    real = fa.flash_attention_bwd
    rows = []

    def checked(q, k, v, out, lse, do, **kw):
        got = real(q, k, v, out, lse, do, **kw)
        if limit is not None and len(rows) >= limit:
            return got
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        errs = torch.stack([(g.float() - w.float()).abs().max()
                            / w.float().abs().max() for g, w in zip(got, want)])
        rows.append(errs.max())
        return got

    fa.flash_attention_bwd = checked
    try:
        yield stats
    finally:
        fa.flash_attention_bwd = real
    errs = torch.stack(rows).cpu() if rows else torch.zeros(0)
    stats["calls"] = len(rows)
    stats["bad"] = int((errs > BWD_TOL["bfloat16"]).sum())
    stats["max_err"] = float(errs.max()) if rows else float("nan")


def _worst(diffs: dict) -> tuple:
    """The largest of a dict of 0-d tensors on the card: (key, value)."""
    import torch

    keys = list(diffs)
    vals = torch.stack([diffs[k].float() for k in keys]).cpu()
    i = int(vals.argmax())
    return keys[i], float(vals[i])


@contextlib.contextmanager
def planted_bwd(fault: str):
    """``flash_attention_bwd`` with a planted fault, as phase 2's: ``"scale"``
    returns dq at twice its value; ``"head"`` drops the group's last q head
    from the cotangent (its terms vanish from dk and dv, and its dq)."""
    from repro_torch.kernels import flash_attention as fa

    real = fa.flash_attention_bwd

    def bad(q, k, v, out, lse, do, **kw):
        if fault == "head":
            do = do.clone()
            do[:, q.shape[1] // k.shape[1] - 1] = 0
        dq, dk, dv = real(q, k, v, out, lse, do, **kw)
        return (2 * dq if fault == "scale" else dq), dk, dv

    fa.flash_attention_bwd = bad
    try:
        yield
    finally:
        fa.flash_attention_bwd = real


def _train_breakdown(fn) -> dict:
    """One profiled train step's device ms by kind: the kernels by name
    (TRAIN_KINDS), the optimizer as the device time of the kernels
    ``adamw_update`` launched (a ``record_function`` range around it; its
    kernels are elementwise and foreach ones, taken out of "other"), the
    rest under "other"; and the top kernels by name. A trace that holds no
    kernel record is taken again, up to ``TRACE_TRIES`` times."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.models import steps

    real = steps.adamw_update

    def ranged(*a, **kw):
        with record_function("adamw_update"):
            return real(*a, **kw)

    steps.adamw_update = ranged
    try:
        for _ in range(TRACE_TRIES):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         acc_events=True) as prof:
                fn()
                torch.cuda.synchronize()
            events = prof.key_averages()
            # the range itself also shows as a device-side record spanning
            # its kernels (gaps included): not a kernel, left out
            rows = sorted([(e.key, e.self_device_time_total / 1e3, e.count)
                           for e in events
                           if e.device_type == torch.autograd.DeviceType.CUDA
                           and e.self_device_time_total > 0
                           and e.key != "adamw_update"], key=lambda r: -r[1])
            if rows:
                break
    finally:
        steps.adamw_update = real
    opt_ms = sum(e.device_time_total for e in events if e.key == "adamw_update"
                 and e.device_type == torch.autograd.DeviceType.CPU) / 1e3
    kinds = _by_kind(rows, TRAIN_KINDS)
    kinds["optimizer"] = opt_ms
    kinds["other"] -= opt_ms
    return {"by_kind": kinds, "total": sum(kinds.values()),
            "top": [[k[:200], ms, n] for k, ms, n in rows[:12]]}


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def run_training(dev, seed: int, card: str, bwd_case: dict) -> dict:
    """Phase 11: qwen3-1.7b at its published config takes train steps
    through ``steps.init_train_state`` / ``steps.make_train_step``
    (attn_impl="flash", remat on, AdamW) on one seeded batch of
    TRAIN_BATCH x TRAIN_SEQ tokens; then one step of each other family
    at phase 10's cut depths. Returns the phase's numbers and B7's row of
    the ``kernels`` line."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import optim, steps

    cfg = _serve_cfg(TRAIN_ARCH, "flash")
    check_published(cfg)
    if not cfg.remat:
        raise AssertionError(f"{TRAIN_ARCH}: remat is off")
    blocked = _serve_cfg(TRAIN_ARCH, "blocked")
    B, S, L = TRAIN_BATCH, TRAIN_SEQ, cfg.n_layers
    t0 = time.perf_counter()
    model, state = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed))
    params = list(model.parameters())
    w0 = [p.detach().to("cpu", copy=True) for p in params]
    batch = serve.make_batch(cfg, B, S, np.random.default_rng(seed), dev)
    n_params = sum(p.numel() for p in params)
    opt_cfg = optim.OptimConfig(**TRAIN_OPT)
    print(f"  {TRAIN_ARCH}: {n_params:,} float32 parameters ({n_params * 4 / 1e9:.2f} "
          f"GB; with grads and AdamW m, v {n_params * 16 / 1e9:.2f} GB), "
          f"batch {B} x {S} tokens, remat on, loss_chunk {cfg.loss_chunk}, "
          f"{opt_cfg}; set up in {time.perf_counter() - t0:.2f} s", flush=True)

    def reset():
        with torch.no_grad():
            for p, w in zip(params, w0):
                p.copy_(w)
            for mom in (state["m"], state["v"]):
                for t in mom.values():
                    t.zero_()
            state["step"].zero_()

    # blocked (the reference's default path, plain autograd) from W0: its
    # gradients and every layer's dq / dk / dv stay on the card as the
    # reference the flash steps are held to
    step_b = steps.make_train_step(blocked, opt_cfg)
    qkv_b: dict = {}
    grads_b: dict = {}
    with captured_qkv_grads(L, qkv_b), captured_grads(model, grads_b):
        _, _, met_b = step_b(model, state, batch)
    w1_b = [p.detach().to("cpu", copy=True) for p in params]
    met_b = {k: float(v) for k, v in met_b.items()}

    def against_blocked(met: dict, qkv: dict, grads: dict) -> dict:
        """One flash step's distances from blocked's, each a TRAIN_TOL key
        (the worst leaf and layer named beside), and the update's."""
        qkv_at, qkv_v = _worst(qkv)
        leaf, grads_v = _worst(grads)
        return {"loss": _rel(met["loss"], met_b["loss"]),
                "grad_norm": _rel(met["grad_norm"], met_b["grad_norm"]),
                "grads": grads_v, "dqkv": qkv_v,
                "update": _update_rel(params, w0, w1_b),
                "worst_leaf": leaf, "worst_qkv": f"layer {qkv_at[0]} {qkv_at[1]}"}

    # a planted fault in the backward kernel, each from W0
    step_f = steps.make_train_step(cfg, opt_cfg)
    moved = {}
    for fault in ("scale", "head"):
        reset()
        qkv, grads = {}, {}
        with planted_bwd(fault), captured_qkv_grads(L, qkv, qkv_b), \
                captured_grads(model, grads, grads_b):
            _, _, m = step_f(model, state, batch)
        moved[fault] = against_blocked({k: float(v) for k, v in m.items()},
                                       qkv, grads)
    reset()

    # the main path: TRAIN_STEPS flash steps from W0, launch counts zeroed
    # just before and read just after; step 1 is held against blocked's,
    # and each of its flash_attention_bwd calls against the plain version
    torch.cuda.synchronize()
    qkv_f: dict = {}
    grads_f: dict = {}
    bwd_stats: dict = {}
    losses, walls, per_step = [], [], []
    _build.reset_launches()
    for i in range(TRAIN_STEPS):
        before = dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        with contextlib.ExitStack() as held:
            if i == 0:
                held.enter_context(captured_qkv_grads(L, qkv_f, qkv_b))
                held.enter_context(captured_grads(model, grads_f, grads_b))
                held.enter_context(checking_bwd(bwd_stats))
            _, _, m = step_f(model, state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
        per_step.append({k: _build.LAUNCHES[k] - before[k]
                         for k in ("flash_mha_fwd", "flash_attention_bwd")})
        m = {k: float(v) for k, v in m.items()}
        losses.append(m["loss"])
        if i == 0:
            met_f = m
            diffs = against_blocked(m, qkv_f, grads_f)
            # the references go before the peak is taken over the steps
            # that carry no checks
            del qkv_b, grads_b, qkv_f, grads_f
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {"flash_mha_fwd": 2 * L, "flash_attention_bwd": L}
    if any(s != want for s in per_step):
        raise AssertionError(f"train launches per step {per_step}, want {want}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"train losses {losses}: not finite and falling")
    print(f"  step 1's {bwd_stats['calls']} flash_attention_bwd calls (the "
          f"step's own q, k, v, out, lse, dO) == plain: worst dq / dk / dv "
          f"max abs err {bwd_stats['max_err']:.3e} x scale (tolerance "
          f"{BWD_TOL['bfloat16']}), {bwd_stats['bad']} beyond", flush=True)
    if bwd_stats["calls"] != L or bwd_stats["bad"]:
        raise AssertionError(f"step 1's flash_attention_bwd vs plain: {bwd_stats}, "
                             f"want {L} calls, none beyond {BWD_TOL['bfloat16']}")

    def show(d: dict) -> str:
        return (f"loss {d['loss']:.2e}, grad norm {d['grad_norm']:.2e}, "
                f"grads {d['grads']:.3e} (worst leaf {d['worst_leaf']}), dq / dk "
                f"/ dv {d['dqkv']:.3e} ({d['worst_qkv']}), update {d['update']:.3e}")
    print(f"  step 1 flash vs blocked from the same weights: loss "
          f"{met_f['loss']:.5f} / {met_b['loss']:.5f}, grad norm "
          f"{met_f['grad_norm']:.5f} / {met_b['grad_norm']:.5f}; " + show(diffs)
          + f" (limits {TRAIN_TOL}; the update printed only)", flush=True)
    for f, mv in moved.items():
        print(f"  planted fault in flash_attention_bwd ({f}), vs blocked: "
              + show(mv) + " (must pass a limit)", flush=True)
    if any(diffs[k] > TRAIN_TOL[k] for k in TRAIN_TOL):
        raise AssertionError(f"flash vs blocked step: {diffs} beyond {TRAIN_TOL}")
    for f, mv in moved.items():
        if all(mv[k] <= TRAIN_TOL[k] for k in TRAIN_TOL):
            raise AssertionError(f"a planted fault ({f}) moved the step by {mv}, "
                                 f"within {TRAIN_TOL}")
    tok_s = B * S / statistics.median(walls[1:])
    print(f"  main path ({TRAIN_STEPS} train steps, flash): launches per step "
          f"{per_step[0]} = 2 x {L} flash_mha_fwd (forward + remat) and {L} "
          f"flash_attention_bwd; total { {k: v for k, v in launches.items() if v} }",
          flush=True)
    print(f"  losses {[round(x, 4) for x in losses]} (falling); step wall "
          f"[{card}] {[round(w * 1e3, 1) for w in walls]} ms, median after the "
          f"first {statistics.median(walls[1:]) * 1e3:.1f} ms, {tok_s:.0f} tokens/s; "
          f"peak memory {peak_gb:.2f} GB (max_memory_allocated)", flush=True)
    # one more step, profiled: device time by kind
    bd = _train_breakdown(lambda: step_f(model, state, batch))
    step_ms = statistics.median(walls[1:]) * 1e3
    print(f"  one step's device time [{card}]: {bd['total']:.1f} ms of "
          f"{step_ms:.1f} ms wall (busy {bd['total'] / step_ms:.0%}); by kind: "
          + ", ".join(f"{k} {v:.2f}" for k, v in bd["by_kind"].items()), flush=True)
    for key, kms, n in bd["top"]:
        print(f"      {kms:9.3f} ms {n:5d} records  {key}", flush=True)
    del model, state, params, w0, w1_b
    torch.cuda.empty_cache()

    row = time_flash_backward(bwd_case, launches["flash_attention_bwd"])
    print_kernel_row(row)

    families = {}
    for arch, layers in FAMILY_CELLS:
        families[arch] = train_family(arch, layers, dev, seed, card)
    return {"arch": TRAIN_ARCH, "batch": B, "seq": S, "steps": TRAIN_STEPS,
            "optim": TRAIN_OPT, "losses": losses, "step_wall_ms": [w * 1e3 for w in walls],
            "step_ms_median": step_ms, "tokens_per_s": tok_s,
            "peak_memory_gb": peak_gb, "launches": launches,
            "launches_per_step": per_step[0], "flash_vs_blocked": diffs,
            "bwd_vs_plain": bwd_stats, "planted": moved, "breakdown": bd,
            "row": row, "families": families}


def _update_rel(params, w0, w1_ref) -> float:
    """|(W - W0) - (W1_ref - W0)| / |W1_ref - W0| over every weight (L2),
    W the parameters now on the card; W0 and W1_ref host copies."""
    import torch

    num = den = 0.0
    with torch.no_grad():
        for p, a, b in zip(params, w0, w1_ref):
            ref = (b - a).to(p.device)
            num += float((p - a.to(p.device) - ref).square().sum())
            den += float(ref.square().sum())
    return math.sqrt(num / max(den, 1e-30))


def time_flash_backward(case: dict, launches: int) -> dict:
    """B7's row of the ``kernels`` line at the training shape (phase 2's
    operands): the kernel alone (its three kernels' records), its plain
    version, and the library call: the backward of SDPA (GQA, causal) on
    contiguous copies, ``torch.autograd.grad`` of an output it computed
    once. Bound: ``flash_attention_bwd_cost``, the larger of 2.5 x the
    causal forward's operations at the bf16 tensor-core rate and the bytes
    of q, k, v, out, dO, lse read once and dq, dk, dv written once."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    q, k, v, out, lse, do = case["flash_attention_bwd"]
    B, H, S, D = q.shape
    KV = k.shape[1]
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    del got, want
    qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (q, k, v))
    ref_out = F.scaled_dot_product_attention(qc, kc, vc, is_causal=True,
                                             enable_gqa=True)
    doc = do.contiguous()
    work = fa.flash_attention_bwd_cost(q, k, causal=True)
    row = _timed("flash_attention_bwd", BWD_KERNELS,
                 lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                      causal=True),
                 lambda: torch.autograd.grad(ref_out, (qc, kc, vc), doc,
                                             retain_graph=True),
                 work["bytes"], work["flops"], err, launches,
                 f"training shape: q, out, dO ({B}, {H}, {S}, {D}), k, v ({B}, "
                 f"{KV}, {S}, {D}) bf16 causal, (B,H,S,D) views of (B,S,H,D)",
                 ops_per_s=BF16_OPS_PER_S)
    del ref_out, qc, kc, vc
    return row


def train_family(arch: str, layers, dev, seed: int, card: str) -> dict:
    """One train step of ``arch`` at its published widths (depth cut where
    ``layers`` is given) on FAMILY_BATCH x FAMILY_TRAIN_SEQ tokens: a
    finite loss, a finite grad norm (every gradient finite) and finite
    updated weights, through the MoE dispatch, the SSD scan, WKV6 and the
    cross-attention on the card. The model, its gradients and its AdamW
    state are freed before the next family."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import optim, steps

    cfg = _serve_cfg(arch, "flash", layers)
    t0 = time.perf_counter()
    model, state = steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(seed))
    batch = serve.make_batch(cfg, FAMILY_BATCH, FAMILY_TRAIN_SEQ,
                             np.random.default_rng(seed), dev)
    step = steps.make_train_step(cfg, optim.OptimConfig(**TRAIN_OPT))
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t1 = time.perf_counter()
    _, _, m = step(model, state, batch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    m = {k: float(v) for k, v in m.items()}
    finite = all(bool(torch.isfinite(p).all()) for p in model.parameters())
    if not (finite and math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])):
        raise AssertionError(f"{arch} train step: {m}, weights finite {finite}")
    launches = {k: v for k, v in _build.LAUNCHES.items() if v}
    n = sum(p.numel() for p in model.parameters())
    out = {"layers": cfg.n_layers, "params": n, "loss": m["loss"],
           "grad_norm": m["grad_norm"], "step_ms": wall * 1e3,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "launches": launches, "setup_s": t1 - t0}
    del model, state
    torch.cuda.empty_cache()
    print(f"  {arch} ({cfg.n_layers} layers, {n:,} parameters) [{card}]: one "
          f"train step on {FAMILY_BATCH} x {FAMILY_TRAIN_SEQ} tokens, loss "
          f"{m['loss']:.4f}, grad norm {m['grad_norm']:.4f} (finite, weights "
          f"finite), {wall * 1e3:.1f} ms, peak {out['peak_memory_gb']:.1f} GB; "
          f"launches {launches}", flush=True)
    return out


# -- phase 12: the training runtime (checkpoints, failures, rollback, resume) --

RUNTIME_STEPS = 6           # launch/train.py's steps in phase 12
RUNTIME_CKPT_EVERY = 3      # a checkpoint at steps 0, 3, 6 (and the final one)
RUNTIME_SCHEDULE = {2: "node", 5: "straggler"}
RUNTIME_LOG_STEPS = [0, 1, 0, 1, 2, 3, 4, 3, 4, 5]   # the schedule's replays
RUNTIME_KEEP = 3            # launch/train.py's CheckpointManager(keep=3)
RUNTIME_DISK_MARGIN = 2e9   # bytes of the checkpoints' disk left free
RUNTIME_MEM_MARGIN = 12e9   # host bytes left beside the snapshots (and a
                            # RAM-backed checkpoint directory)
# The card's machine ends a run that has written 45 GiB (48.3 GB) to its
# disk, deleted files included; phase 12 writes 6 train states (run 1's
# saves at steps 0, 3, 6 and the final one, the resume's two), 8.1 GB each
# at one layer of qwen3-1.7b's widths. So its checkpoints go to a
# RAM-backed directory (RUNTIME_SHM) where there is one; on a disk they
# may take RUNTIME_DISK_WRITES in all, the earlier phases' writes beside.
# phase 12's depth is also cut for the script's time limit: at 15 layers
# it took 174.2 s on an H100 80GB HBM3 (700 W) whose host ran the script
# 1,226 s
RUNTIME_MAX_LAYERS = 2
RUNTIME_SHM = "/dev/shm"
RUNTIME_SAVES = 6
RUNTIME_DISK_WRITES = 30e9
# A re-run step's loss against its first run's: the same restored state,
# batch and kernels. Bit-equal is expected (B7 repeats bit-equal); where
# it is not, the losses must agree within this (relative) and the cause
# goes into PERF.md.
RUNTIME_TOL = 1e-4


def _mem_available() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def state_bytes(cfg) -> int:
    """A train state's bytes: float32 parameters, AdamW's m and v, the
    int32 step."""
    return 12 * cfg.n_params() + 4


def _is_tmpfs(path: str) -> bool:
    """Whether ``path`` lies on a RAM-backed (tmpfs) mount."""
    import os

    path = os.path.realpath(path)
    best, kind = "", ""
    with open("/proc/mounts") as f:
        for line in f:
            point, fstype = line.split()[1:3]
            inside = path == point or path.startswith(point.rstrip("/") + "/")
            if inside and len(point) > len(best):
                best, kind = point, fstype
    return kind == "tmpfs"


def runtime_depth(cfg, free: int, mem: int, in_memory: bool) -> tuple[int, str]:
    """The largest depth up to the published one and RUNTIME_MAX_LAYERS at
    which phase 12 fits.
    Its directory holds RUNTIME_KEEP checkpoints and the one being written
    beside them (RUNTIME_DISK_MARGIN to spare). The host holds two
    snapshots (a save copies before it waits for the write in flight); in
    a RAM-backed directory the states on it count too, and the most at
    once is RUNTIME_KEEP + 2 (the kept ones, the one being written and a
    snapshot; or one fewer on it beside two snapshots), with
    RUNTIME_MEM_MARGIN to spare. On a disk, the run's RUNTIME_SAVES saves
    stay within RUNTIME_DISK_WRITES. Returns (layers, the needs at the
    published depth)."""
    import dataclasses

    def needs(layers: int) -> tuple[float, float, float]:
        b = state_bytes(dataclasses.replace(cfg, n_layers=layers))
        return ((RUNTIME_KEEP + 1) * b + RUNTIME_DISK_MARGIN,
                ((RUNTIME_KEEP + 2) if in_memory else 2) * b + RUNTIME_MEM_MARGIN,
                0 if in_memory else RUNTIME_SAVES * b)

    def fits(layers: int) -> bool:
        space, host, writes = needs(layers)
        return space <= free and host <= mem and writes <= RUNTIME_DISK_WRITES

    layers = min(cfg.n_layers, RUNTIME_MAX_LAYERS)
    while layers > 0 and not fits(layers):
        layers -= 1
    space, host, writes = needs(cfg.n_layers)
    why = (f"{cfg.n_layers} layers need {space:,.0f} bytes in the checkpoint "
           f"directory ({RUNTIME_KEEP + 1} train states of {state_bytes(cfg):,}: "
           f"{RUNTIME_KEEP} kept and one being written, + margin) and "
           f"{host:,.0f} host bytes ("
           + (f"{RUNTIME_KEEP + 2} states: the RAM-backed directory's and a "
              "snapshot" if in_memory else "two snapshots")
           + f", + margin){'' if in_memory else f', and {writes:,.0f} bytes of disk writes (limit {RUNTIME_DISK_WRITES:,.0f})'}; "
           f"there are {free:,} and {mem:,}; and the script's time limit "
           f"caps it at {RUNTIME_MAX_LAYERS}")
    if layers == 0:
        raise AssertionError(f"phase 12: no depth fits: {why}")
    return layers, why


def _union_s(spans: list) -> float:
    """Seconds covered by a list of spans (overlaps counted once)."""
    total, end = 0.0, -math.inf
    for s in sorted(spans, key=lambda s: s["t0"]):
        if s["t1"] > end:
            total += s["t1"] - max(s["t0"], end)
            end = s["t1"]
    return total


def _equal_state(a, b) -> tuple[int, int]:
    """(tensors that differ, tensors compared) over two (model, AdamW
    state) pairs: every parameter, m, v and the step, bit for bit."""
    import torch

    (ma, oa), (mb, ob) = a, b
    pairs = [(p, q) for (_, p), (_, q) in zip(ma.named_parameters(),
                                              mb.named_parameters())]
    pairs += [(oa[k][n], ob[k][n]) for k in ("m", "v") for n in oa[k]]
    pairs.append((oa["step"], ob["step"]))
    differ = sum(not torch.equal(x, y) for x, y in pairs)
    return differ, len(pairs)


@contextlib.contextmanager
def swapped_blocks():
    """``load_train_state``'s in-place writer with a planted fault: every
    stacked leaf's blocks 0 and 1 land in each other's layer."""
    from repro_torch.models import convert

    real = convert._scatter

    def swapped(names, src, values, where):
        if names.ndim == 1 and len(names) > 1:
            names = names.copy()
            names[[0, 1]] = names[[1, 0]]
        real(names, src, values, where)

    convert._scatter = swapped
    try:
        yield
    finally:
        convert._scatter = real


def run_runtime(dev, card: str) -> dict:
    """Phase 12: qwen3-1.7b at its published widths (depth cut only where
    the disk or the host's memory forces it) trained through
    ``launch/train.run`` with a flash config, 4 x 2,048 tokens a step,
    RUNTIME_STEPS steps, a checkpoint every RUNTIME_CKPT_EVERY, a node
    failure and a straggler; then resumed from the last checkpoint; then
    two planted faults. Returns the phase's numbers and launches."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    import os

    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.models import steps
    from repro_torch.runtime.fault import FailureInjector


    cfg = _serve_cfg(TRAIN_ARCH, "flash")
    check_published(cfg)
    shm = RUNTIME_SHM if os.path.isdir(RUNTIME_SHM) and _is_tmpfs(RUNTIME_SHM) \
        else None
    ckdir = tempfile.mkdtemp(prefix="repro_torch_ckpt_", dir=shm)
    try:
        in_memory = _is_tmpfs(ckdir)
        free, mem = shutil.disk_usage(ckdir).free, _mem_available()
        disk_free = shutil.disk_usage(tempfile.gettempdir()).free
        print(f"  checkpoints in a fresh directory, {ckdir} "
              f"({'RAM-backed' if in_memory else 'on disk'}): {free:,} bytes "
              f"free there; the disk of {tempfile.gettempdir()}: {disk_free:,} "
              f"bytes free; host MemAvailable {mem:,} bytes", flush=True)
        layers, why = runtime_depth(cfg, free, mem, in_memory)
        if layers != cfg.n_layers:
            print(f"  {TRAIN_ARCH} reduced: n_layers {cfg.n_layers} → {layers}, "
                  f"because {why}", flush=True)
            cfg = dataclasses.replace(cfg, n_layers=layers)
        L = cfg.n_layers

        # the main path: launch/train.run, launch counts zeroed just before
        # and read just after; the first step's B7 calls held against plain
        bwd: dict = {}
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        with checking_bwd(bwd, limit=L):
            first = train.run(cfg, RUNTIME_STEPS, TRAIN_BATCH, TRAIN_SEQ, ckdir,
                              RUNTIME_CKPT_EVERY,
                              injector=FailureInjector(dict(RUNTIME_SCHEDULE)),
                              device=dev)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES[k] for k in ("flash_mha_fwd",
                                                    "flash_attention_bwd")}
        loop, ckpt, log = first["loop"], first["ckpt"], first["log"]
        steps_run = len(log)
        losses = [l for _, l in log]
        want_events = [(2, "NodeFailure: injected node failure at step 2"),
                       (5, "Straggler: injected straggler at step 5")]
        if first["events"] != want_events:
            raise AssertionError(f"phase 12 events {first['events']}")
        if [s for s, _ in log] != RUNTIME_LOG_STEPS:
            raise AssertionError(f"phase 12 log steps {[s for s, _ in log]}")
        rolled = [s["step"] for s in loop.spans if s["span"] == "rollback"]
        if rolled != [0, 3]:
            raise AssertionError(f"phase 12 rolled back to {rolled}, want [0, 3]")
        # the loss falls: step 0's batch scored by the trained model against
        # the first step's loss on it (the initial weights). The launcher's
        # OptimConfig(total_steps=6) keeps the reference's 100 warmup steps,
        # so the lr stays under 2e-5 and each step's loss on a fresh random
        # batch moves within the batches' spread
        batch0 = next(train.data_factory(cfg, TRAIN_BATCH, TRAIN_SEQ, dev)(0))
        trained0 = float(steps.make_eval_step(cfg)(first["model"], batch0)["loss"])
        del batch0
        if not all(math.isfinite(x) for x in losses + [trained0]) \
                or not trained0 < losses[0]:
            raise AssertionError(f"phase 12 losses {losses}, step 0's batch after "
                                 f"the run {trained0}: not finite and falling")
        want_launches = {"flash_mha_fwd": steps_run * 2 * L,
                         "flash_attention_bwd": steps_run * L}
        if launches != want_launches:
            raise AssertionError(f"phase 12 launches {launches}, want {want_launches}")
        if bwd["calls"] != L or bwd["bad"]:
            raise AssertionError(f"phase 12 first step's B7 vs plain: {bwd}")
        # a re-run step against its first run (log entries: 0,1 again at
        # 2,3; 3,4 again at 7,8)
        reruns = [(0, 2), (1, 3), (5, 7), (6, 8)]
        rel = [abs(losses[a] - losses[b]) / abs(losses[a]) for a, b in reruns]
        bit_equal = all(losses[a] == losses[b] for a, b in reruns)
        if max(rel) > RUNTIME_TOL:
            raise AssertionError(f"phase 12 re-run losses {losses}: {rel}")

        # resume: a new run restores the last checkpoint in place and runs
        # no step; its model and state equal the first run's bit for bit
        _build.reset_launches()
        second = train.run(cfg, RUNTIME_STEPS, TRAIN_BATCH, TRAIN_SEQ, ckdir,
                           RUNTIME_CKPT_EVERY, resume=True, device=dev)
        torch.cuda.synchronize()
        if second["start"] != RUNTIME_STEPS or second["log"] \
                or any(_build.LAUNCHES.values()):
            raise AssertionError(f"phase 12 resume: start {second['start']}, log "
                                 f"{second['log']}, launches {dict(_build.LAUNCHES)}")
        a = (first["model"], first["opt_state"])
        b = (second["model"], second["opt_state"])
        differ, n_tensors = _equal_state(a, b)
        if differ:
            raise AssertionError(f"phase 12 resume: {differ} of {n_tensors} tensors "
                                 "differ from the first run's")

        # planted faults: a writer that swaps two layers' blocks; a flipped
        # byte in a leaf file
        state = train.ModelState(cfg)
        with swapped_blocks():
            state.restore(second["ckpt"], *b)
        swapped, _ = _equal_state(a, b)
        if not swapped:
            raise AssertionError("phase 12: a restore that swaps layers 0 and 1 "
                                 "passed the bit-equality check")
        leaf = Path(ckdir) / f"step_{RUNTIME_STEPS}" / "leaf_0.npy"
        ckpt_bytes = sum(p.stat().st_size for p in leaf.parent.iterdir())
        with open(leaf, "r+b") as f:
            f.seek(-1, 2)
            byte = f.read(1)
            f.seek(-1, 2)
            f.write(bytes([byte[0] ^ 0x01]))
        try:
            state.restore(second["ckpt"], *b)
        except IOError as e:
            if "crc" not in str(e):
                raise
            crc_error = str(e)
        else:
            raise AssertionError("phase 12: a flipped byte restored without a crc error")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)

    # the numbers: the loop's and the checkpoint manager's spans
    spans = loop.spans + ckpt.spans
    t_start = min(s["t0"] for s in spans)
    loop_s = max(s["t1"] for s in spans) - t_start
    writes = [s for s in ckpt.spans if s["span"] == "write"]
    background = [s for s in writes if s["background"]]
    main_ckpt = [s for s in loop.spans if s["span"] in ("snapshot", "rollback")] \
        + [s for s in ckpt.spans if s["span"] in ("copy", "wait")] \
        + [s for s in writes if not s["background"]]
    ckpt_share = _union_s(main_ckpt) / loop_s
    step_rows = []
    for s in loop.spans:
        if s["span"] != "step" or not s["ok"]:
            continue
        over = any(w["t0"] < s["t1"] and s["t0"] < w["t1"] for w in background)
        step_rows.append({"step": s["step"], "ms": (s["t1"] - s["t0"]) * 1e3,
                          "overlaps_write": over})
    save3 = next(s for s in loop.spans if s["span"] == "snapshot" and s["step"] == 3)
    write3 = next(s for s in writes if s["step"] == 3)
    reads = [s for s in ckpt.spans if s["span"] == "read"]
    rollbacks = [s for s in loop.spans if s["span"] == "rollback"]
    out = {"layers": L, "free_bytes": free, "disk_free_bytes": disk_free,
           "in_memory": in_memory, "mem_available_bytes": mem,
           "state_bytes": write3["bytes"], "checkpoint_bytes": ckpt_bytes,
           "snapshot_s": save3["t1"] - save3["t0"],
           "write_s": write3["t1"] - write3["t0"],
           "restore_s": [r["t1"] - r["t0"] for r in reads],
           "restore_gb_s": [r["bytes"] / (r["t1"] - r["t0"]) / 1e9 for r in reads],
           "rollback_s": [r["t1"] - r["t0"] for r in rollbacks],
           "steps": step_rows, "loop_s": loop_s, "run_s": run_s,
           "ckpt_share": ckpt_share, "losses": losses, "batch0_after": trained0,
           "rerun_rel": rel,
           "rerun_bit_equal": bit_equal, "events": first["events"],
           "launches": launches, "bwd_vs_plain": bwd, "resume_tensors": n_tensors,
           "planted_swap_tensors": swapped, "planted_crc": crc_error}
    print(f"  [{card}] launch/train.run: {TRAIN_ARCH} ({L} layers), "
          f"{RUNTIME_STEPS} steps of {TRAIN_BATCH} x {TRAIN_SEQ}, checkpoint "
          f"every {RUNTIME_CKPT_EVERY}, injected {RUNTIME_SCHEDULE}: events "
          f"{first['events']}; rolled back to steps {rolled}; log steps "
          f"{[s for s, _ in log]}", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}; step 0's batch "
          f"{losses[0]:.5f} before the run, {trained0:.5f} after (finite, "
          f"falling); re-run "
          f"steps' losses {'bit-equal' if bit_equal else 'NOT bit-equal'} to their "
          f"first runs (worst relative {max(rel):.2e}, limit {RUNTIME_TOL})", flush=True)
    print(f"  main path launches {launches} = {steps_run} steps run x (2 x {L}, "
          f"{L}); the first step's {bwd['calls']} flash_attention_bwd calls == "
          f"plain: worst {bwd['max_err']:.3e} x scale (tolerance "
          f"{BWD_TOL['bfloat16']})", flush=True)
    print(f"  resume: a new run restored step {second['start']} in place and ran "
          f"no step; {n_tensors} tensors (parameters, m, v, step) bit-equal to the "
          f"first run's. Planted: a writer swapping layers 0 and 1 left {swapped} "
          f"tensors unequal (caught); a flipped byte in leaf_0.npy raised "
          f"{crc_error!r}", flush=True)
    print(f"  [{card}] checkpoint of step {RUNTIME_STEPS}: {ckpt_bytes:,} bytes "
          f"({write3['bytes']:,} of arrays); one save (step 3): snapshot "
          f"{out['snapshot_s']:.2f} s on the loop's thread, then the background "
          f"write {out['write_s']:.2f} s (CRC + np.save + rename, "
          f"{write3['bytes'] / out['write_s'] / 1e9:.2f} GB/s)", flush=True)
    print(f"  [{card}] restores: "
          + ", ".join(f"read {r:.2f} s ({g:.2f} GB/s)" for r, g in
                      zip(out["restore_s"], out["restore_gb_s"]))
          + "; rollbacks with the in-place write: "
          + ", ".join(f"{r:.2f} s" for r in out["rollback_s"]), flush=True)
    over = [r["ms"] for r in step_rows if r["overlaps_write"]]
    alone = [r["ms"] for r in step_rows if not r["overlaps_write"]]
    print(f"  [{card}] step walls (ms; * = a background write ran during it): "
          + ", ".join(f"{r['step']}:{r['ms']:.1f}{'*' if r['overlaps_write'] else ''}"
                      for r in step_rows)
          + f"; median with a write {statistics.median(over) if over else float('nan'):.1f}"
          f", without {statistics.median(alone) if alone else float('nan'):.1f}",
          flush=True)
    print(f"  [{card}] the loop: {loop_s:.2f} s, {ckpt_share:.0%} of it checkpoint "
          f"work on the loop's thread (snapshots, waits, synchronous writes, "
          f"rollbacks); run() with set-up {run_s:.2f} s", flush=True)
    del first, second, a, b
    torch.cuda.empty_cache()
    return out


# -- phase 13: the model mesh on one card -----------------------------------------

MESH_ARCH = "qwen3-1.7b"    # the serve and train paths' model, at its published width
MESH_DATA, MESH_MODEL = 2, 2
MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_NEW = 4, 2_048, 16
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 4, 2_048
# The shardmap decode against the one-hot one. The reference's test holds
# them to 8e-2 on the logits and 0.06 on the cache at its reduced width
# (tests/test_distributed.py:216-218; tests/test_torch_mesh_models.py holds
# the port there). At 28 layers and d 2,048 in bf16 the two read 0.09-0.11
# apart on an H100 (700 W), with one shardmap layer within bf16 rounding of
# the one-hot layer on the same inputs: the shardmap body rounds each
# rank's partial P.V to bf16 before the float32 merge and divides after
# it, the one-hot body rounds once after normalising, and 28 layers
# compound the difference, as flash against blocked does in phase 10. So
# each shardmap call of the first step is held to its one-hot twin on the
# same inputs (phase 2's bf16 row tolerance, the cache written bit-equal),
# and the 16 steps end to end to phase 10's SERVE_TOL; a merge that drops
# model rank 1 must fail both.
MESH_LOSS_TOL = 5e-3        # the DP step's loss (tests/test_distributed.py:142)
# The data-parallel step against the meshless one from the same weights and
# batch: each shard's rows go through the same kernels (B5 / B7 work per
# (batch, head) tile, so a row's attention is bit-equal either way), but
# the GEMMs run at half the rows (cuBLAS may tile and split K otherwise,
# rounding bf16 activations apart) and a weight gradient sums its tokens
# in two halves; 28 layers compound it. The CPU tests read 2e-2 at most
# at the reduced width in bf16; a dropped shard or a sum for a mean moves
# a leaf by 0.5-1.0.
MESH_GRAD_TOL = {"grad_norm": 1e-2,   # relative
                 "grads": 2e-2}       # worst leaf's relative L2
MESH_MOE = ("deepseek-moe-16b", 4)    # phase 10's depth
MESH_MOE_DATA, MESH_MOE_MODEL = 2, 4  # 16 of 64 experts a rank
MESH_MOE_BATCH, MESH_MOE_SEQ = 4, 512
MESH_CPU_LEAVES = "layers.0."         # (d)'s leaves also reduced on the CPU


@contextlib.contextmanager
def checking_smap(stats: dict, limit: int):
    """Counts every shardmap decode call in ``stats["calls"]``, and holds
    the first ``limit`` against the one-hot body on the same inputs: the
    layer's cache written by ``update_cache_layer`` on copies, then
    ``cache_attention``; the output within phase 2's bf16 row tolerance
    (2e-2 x (|want| + the row's largest |want|)) and the cache written
    bit-equal. Verdicts stay on the card until the block ends."""
    import torch

    from repro_torch.models import attention as attn

    real = attn._decode_attention_smap
    rows = []

    def checked(q, k_new, v_new, ck, cv, pos, cfg, ctx):
        stats["calls"] += 1
        if len(rows) >= limit:
            return real(q, k_new, v_new, ck, cv, pos, cfg, ctx)
        wk, wv = ck.clone(), cv.clone()
        attn.update_cache_layer(wk, wv, k_new, v_new, pos)
        want = attn.cache_attention(q, wk, wv, pos.reshape(1), cfg).float()
        out = real(q, k_new, v_new, ck, cv, pos, cfg, ctx)
        got = out.reshape(want.shape).float()
        err = (got - want).abs()
        bound = 2e-2 * (want.abs() + want.abs().amax(dim=-1, keepdim=True))
        rows.append(torch.stack([(err > bound).any().float(), err.max(),
                                 (torch.equal(wk, ck) and torch.equal(wv, cv))
                                 * torch.ones((), device=err.device)]))
        return out

    attn._decode_attention_smap = checked
    try:
        yield stats
    finally:
        attn._decode_attention_smap = real
    r = torch.stack(rows).cpu() if rows else torch.zeros((0, 3))
    stats.update(checked=len(rows), bad=int(r[:, 0].sum()),
                 max_err=float(r[:, 1].max()) if rows else float("nan"),
                 cache_equal=bool(r[:, 2].all()))


@contextlib.contextmanager
def planted_smap_merge():
    """The shardmap decode's merge over the model ranks (``pmax`` and the
    two ``psum``s) taking rank 0's partials only: the context rank 1 owns
    drops out."""
    import types

    from repro_torch.engine import distributed
    from repro_torch.models import attention as attn

    attn.D = types.SimpleNamespace(psum=lambda parts: distributed.psum(parts[:1]),
                                   pmax=lambda parts: distributed.pmax(parts[:1]))
    try:
        yield
    finally:
        attn.D = distributed


@contextlib.contextmanager
def planted_rank_merge(ranks: int):
    """The expert-parallel MoE's ``psum`` over its ``ranks`` model ranks
    without the last rank's partial output."""
    import types

    from repro_torch.engine import distributed
    from repro_torch.models import moe

    moe.D = types.SimpleNamespace(
        psum=lambda parts: distributed.psum(parts[:-1] if len(parts) == ranks
                                            else parts),
        pmean=distributed.pmean)
    try:
        yield
    finally:
        moe.D = distributed


@contextlib.contextmanager
def merged_with(fn):
    """``steps.merge_grads`` replaced by ``fn(real, parts, weights)``."""
    from repro_torch.models import steps

    real = steps.merge_grads
    steps.merge_grads = lambda parts, weights: fn(real, parts, weights)
    try:
        yield
    finally:
        steps.merge_grads = real


def check_compressed(parts: list, names: list) -> dict:
    """(d): ``compressed_psum`` over the data shards' gradient trees, leaf
    by leaf on the card (zero error state): each leaf's mean within
    max|t| / 127 of the exact mean, and the leaves under MESH_CPU_LEAVES
    reduced again on the CPU, bit for bit."""
    import torch

    from repro_torch.runtime import compress

    ratios, cpu = [], {"leaves": 0, "elements": 0, "unequal": 0}
    for j, name in enumerate(names):
        gs = [{"g": part[j]} for part in parts]
        errs = [{"g": torch.zeros_like(part[j])} for part in parts]
        mean, _ = compress.compressed_psum(gs, errs)
        exact = sum(p[j] for p in parts) / len(parts)
        scale = max(float(p[j].abs().max()) for p in parts) / 127.0
        ratios.append(float((mean["g"] - exact).abs().max()) / max(scale, 1e-30))
        if name.startswith(MESH_CPU_LEAVES) or name == "final_norm":
            host, _ = compress.compressed_psum(
                [{"g": g["g"].cpu()} for g in gs], [{"g": e["g"].cpu()} for e in errs])
            got = mean["g"].cpu()
            cpu["leaves"] += 1
            cpu["elements"] += got.numel()
            cpu["unequal"] += int((got.view(torch.int32)
                                   != host["g"].view(torch.int32)).sum())
    return {"leaves": len(ratios), "worst_err_over_scale": max(ratios), "cpu": cpu}


def run_mesh_models(dev, seed: int, card: str) -> dict:
    """Phase 13: the model paths on a data x model mesh of the card
    (``launch/mesh.make_local_mesh`` + ``models/sharding.sharding_ctx``):
    (a) qwen3-1.7b served with the shardmap decode against the meshless
    one-hot decode, (b) its data-parallel train step against the meshless
    step, (c) deepseek-moe-16b's expert-parallel prefill against the
    meshless path, (d) ``compressed_psum`` over (b)'s shards' gradients.
    Returns the phase's numbers and its B5 / B7 launches."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import optim, registry, steps
    from repro_torch.models.sharding import sharding_ctx

    t_phase = time.perf_counter()
    mesh = make_local_mesh(MESH_DATA, MESH_MODEL, device=dev)
    launches = {"flash_mha_fwd": 0, "flash_attention_bwd": 0}

    def counted(fn):
        """``fn()`` with the launch counts zeroed before and read after:
        the main path's own launches, added to ``launches``."""
        _build.reset_launches()
        out = fn()
        for k in launches:
            launches[k] += _build.LAUNCHES[k]
        return out

    # -- (a) serve ---------------------------------------------------------------
    cfg = _serve_cfg(MESH_ARCH, "flash")
    check_published(cfg)
    onehot = dataclasses.replace(cfg, attn_impl="blocked", decode_cache_update="onehot")
    smap = dataclasses.replace(cfg, decode_cache_update="shardmap")
    api = registry.get_api(cfg)
    B, P, NEW = MESH_SERVE_BATCH, MESH_SERVE_PROMPT, MESH_SERVE_NEW
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    batch = serve.make_batch(cfg, B, P, np.random.default_rng(seed), dev)
    max_len = P + NEW
    if max_len % MESH_MODEL:
        raise AssertionError(f"cache length {max_len} does not split over "
                             f"{MESH_MODEL} model ranks")

    def prefill(ctx):
        with torch.no_grad(), ctx:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, lg = api.prefill(model, batch, cfg, max_len)
            torch.cuda.synchronize()
        return cache, lg[:, -1].float(), (time.perf_counter() - t0) * 1e3

    cache1, first1, pre1_ms = prefill(contextlib.nullcontext())
    cache2, first2, pre2_ms = counted(lambda: prefill(sharding_ctx(mesh)))
    if not (torch.equal(cache1["k"], cache2["k"]) and torch.equal(first1, first2)):
        raise AssertionError("the meshed prefill differs from the meshless one")
    del cache2
    cache2 = {k: v.clone() for k, v in cache1.items()}
    cache_p = {k: v.clone() for k, v in cache1.items()}
    forced = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (NEW, B, 1)).astype(np.int32)).to(dev)

    def decode(run_cfg, cache, ctx, steps_=NEW):
        logits = []
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(steps_ + 1)]
        with torch.no_grad(), ctx:
            ev[0].record()
            for t in range(steps_):
                cache, lg = api.decode(model, cache, forced[t], run_cfg)
                logits.append(lg[:, -1].float())
                ev[t + 1].record()
            torch.cuda.synchronize()
        return torch.stack(logits), cache, [ev[i].elapsed_time(ev[i + 1])
                                            for i in range(steps_)]

    lg1, cache1, dec1 = decode(onehot, cache1, contextlib.nullcontext())
    smap_stats = {"calls": 0}
    with checking_smap(smap_stats, cfg.n_layers):
        lg2, cache2, dec2 = decode(smap, cache2, sharding_ctx(mesh))
    if smap_stats["calls"] != NEW * cfg.n_layers:
        raise AssertionError(f"shardmap decode ran {smap_stats['calls']} times, "
                             f"want {NEW} x {cfg.n_layers}")
    planted_stats = {"calls": 0}
    with planted_smap_merge(), checking_smap(planted_stats, cfg.n_layers):
        lg_p, _, _ = decode(smap, cache_p, sharding_ctx(mesh), 1)
    del cache_p
    gap = (lg1 - lg2).abs().amax(dim=(1, 2)).cpu()          # per step
    top2 = lg1.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > SERVE_TOL        # (steps, B)
    argmax_bad = int(((lg1.argmax(-1) != lg2.argmax(-1)) & sure).sum())
    k_gap = float((cache1["k"].float() - cache2["k"].float()).abs().max())
    k0_equal = torch.equal(cache1["k"][0], cache2["k"][0])
    pos_ok = int(cache2["pos"]) == P + NEW
    p_gap = float((lg_p[0] - lg1[0]).abs().max())
    serve_out = {"batch": B, "prompt": P, "new": NEW,
                 "prefill_ms": {"meshless": pre1_ms, "mesh": pre2_ms},
                 "decode_ms_per_step": {"meshless_onehot": statistics.median(dec1),
                                        "mesh_shardmap": statistics.median(dec2)},
                 "max_logit_diff_per_step": gap.tolist(),
                 "argmax_differs_beyond_margin": argmax_bad,
                 "argmax_equal_all": bool((lg1.argmax(-1) == lg2.argmax(-1)).all()),
                 "cache_k_diff": k_gap, "cache_layer0_equal": k0_equal,
                 "layer_check": smap_stats, "planted": {"layer_check": planted_stats,
                                                        "logit_diff": p_gap}}
    print(f"  (a) serve {MESH_ARCH}, {B} x ({P} + {NEW}) tokens on a data "
          f"{MESH_DATA} x model {MESH_MODEL} mesh, flash prefill (== the meshless "
          f"one bit for bit), decode_cache_update=shardmap against the meshless "
          f"one-hot decode, teacher-forced on the same tokens", flush=True)
    print(f"  (a) step 1's {smap_stats['checked']} shardmap calls against the one-hot "
          f"body on the same q, k, v and cache: worst |diff| {smap_stats['max_err']:.3e} "
          f"(bf16 row tolerance), {smap_stats['bad']} beyond, caches written "
          f"{'bit-equal' if smap_stats['cache_equal'] else 'UNEQUAL'}; planted merge "
          f"without model rank 1: {planted_stats['bad']} of {planted_stats['checked']} "
          f"layers beyond, logits {p_gap:.3f} apart (must pass {SERVE_TOL})", flush=True)
    print(f"  (a) end to end: max |logit diff| per step "
          f"{[round(x, 4) for x in gap.tolist()]} (limit {SERVE_TOL}; the reference "
          f"test's 8e-2 is its reduced width's), argmax "
          f"{'equal' if serve_out['argmax_equal_all'] else 'differs'} at every step, "
          f"{argmax_bad} differing where the one-hot top-2 margin exceeds {SERVE_TOL}; "
          f"cache k within {k_gap:.4f} (layer 0 {'bit-equal' if k0_equal else 'UNEQUAL'};"
          f" limit {SERVE_TOL})", flush=True)
    print(f"  (a) [{card}] prefill {pre1_ms:.1f} ms meshless, {pre2_ms:.1f} ms "
          f"meshed; decode ms per step (median of {NEW}, CUDA events): one-hot "
          f"meshless {statistics.median(dec1):.2f}, shardmap meshed "
          f"{statistics.median(dec2):.2f}", flush=True)
    if smap_stats["bad"] or not smap_stats["cache_equal"] \
            or smap_stats["checked"] != cfg.n_layers or float(gap.max()) > SERVE_TOL \
            or argmax_bad or k_gap > SERVE_TOL or not k0_equal or not pos_ok:
        raise AssertionError(f"shardmap decode vs one-hot: {serve_out}")
    if not planted_stats["bad"] or p_gap <= SERVE_TOL:
        raise AssertionError(f"the planted shardmap merge passed: {serve_out}")
    del cache1, cache2, lg1, lg2, lg_p
    torch.cuda.empty_cache()

    # -- (b) train, (d) compressed_psum --------------------------------------------
    state = optim.init_opt_state(model)
    Bt, St = MESH_TRAIN_BATCH, MESH_TRAIN_SEQ
    tbatch = serve.make_batch(cfg, Bt, St, np.random.default_rng(seed), dev)
    opt_cfg = optim.OptimConfig(**TRAIN_OPT)
    step = steps.make_train_step(cfg, opt_cfg)
    L = cfg.n_layers
    # the meshless step's gradients: the reference the meshed steps are held to
    grads_ref: dict = {}
    with captured_grads(model, grads_ref, update=False):
        _, _, m_ref = step(model, state, tbatch)
    m_ref = {k: float(v) for k, v in m_ref.items() if k != "lr"}

    def meshed(ref_diffs: dict, update: bool):
        with sharding_ctx(mesh), captured_grads(model, ref_diffs, grads_ref, update):
            _, _, m = step(model, state, tbatch)
        return {k: float(v) for k, v in m.items()}

    def against(m: dict, diffs: dict) -> dict:
        leaf, worst = _worst(diffs)
        return {"loss": abs(m["loss"] - m_ref["loss"]),
                "grad_norm": _rel(m["grad_norm"], m_ref["grad_norm"]),
                "grads": worst, "worst_leaf": leaf}

    planted = {}
    for fault, fn in (("drop shard 1", lambda real, p, w: real(p[:1], w[:1])),
                      ("sum, not mean", lambda real, p, w: real(p, [1.0] * len(p)))):
        diffs: dict = {}
        with merged_with(fn):
            planted[fault] = against(meshed(diffs, update=False), diffs)
    # (d): the shards' gradient trees as the step merges them, and every
    # flash_attention_bwd call of the step against its plain version
    comp: dict = {}
    names = [n for n, _ in model.named_parameters()]
    bwd_stats: dict = {}

    def with_compressed(real, parts, weights):
        comp.update(check_compressed(parts, names))
        return real(parts, weights)

    diffs_d: dict = {}
    t0 = time.perf_counter()
    with merged_with(with_compressed), checking_bwd(bwd_stats):
        meshed(diffs_d, update=False)
    comp["seconds"] = time.perf_counter() - t0
    # the main path: one meshed step with its update
    diffs: dict = {}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m_mesh = counted(lambda: meshed(diffs, update=True))
    torch.cuda.synchronize()
    wall_mesh = (time.perf_counter() - t0) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_launches = dict(launches)
    dp = against(m_mesh, diffs)
    # a meshless step with its update, for its wall
    t0 = time.perf_counter()
    step(model, state, tbatch)
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) * 1e3
    want = {"flash_mha_fwd": 2 * L * MESH_DATA, "flash_attention_bwd": L * MESH_DATA}
    got = {k: step_launches[k] - (L if k == "flash_mha_fwd" else 0) for k in want}
    print(f"  (b) train {MESH_ARCH}, {Bt} x {St} tokens (flash, remat, loss_chunk "
          f"{cfg.loss_chunk}), data-parallel over {MESH_DATA} shards of {Bt // MESH_DATA} "
          f"rows, against the meshless step from the same weights and batch: loss "
          f"{m_mesh['loss']:.5f} / {m_ref['loss']:.5f} (|diff| {dp['loss']:.2e}, "
          f"limit {MESH_LOSS_TOL}), grad norm {m_mesh['grad_norm']:.5f} / "
          f"{m_ref['grad_norm']:.5f} (relative {dp['grad_norm']:.2e}, limit "
          f"{MESH_GRAD_TOL['grad_norm']}), worst leaf's gradient {dp['grads']:.3e} "
          f"relative L2 ({dp['worst_leaf']}; limit {MESH_GRAD_TOL['grads']})", flush=True)
    for f, mv in planted.items():
        print(f"  (b) planted merge fault ({f}): loss |diff| {mv['loss']:.2e}, grad "
              f"norm {mv['grad_norm']:.2e}, worst leaf {mv['grads']:.3e} "
              f"({mv['worst_leaf']}) (must pass a limit)", flush=True)
    print(f"  (b) main path launches (the meshed step; the meshed prefill adds {L} "
          f"flash_mha_fwd): flash_mha_fwd {got['flash_mha_fwd']} = "
          f"{got['flash_mha_fwd'] // MESH_DATA} per shard x {MESH_DATA}, "
          f"flash_attention_bwd {got['flash_attention_bwd']} = "
          f"{got['flash_attention_bwd'] // MESH_DATA} per shard x {MESH_DATA}; "
          f"(d)'s step's {bwd_stats['calls']} flash_attention_bwd calls == plain: "
          f"worst {bwd_stats['max_err']:.3e} x scale (tolerance {BWD_TOL['bfloat16']}), "
          f"{bwd_stats['bad']} beyond", flush=True)
    print(f"  (b) [{card}] step wall: meshed {wall_mesh:.1f} ms, meshless "
          f"{wall_plain:.1f} ms ({wall_mesh / wall_plain:.2f}x); peak memory of "
          f"the meshed step {peak_gb:.2f} GB (max_memory_allocated)", flush=True)
    print(f"  (d) compressed_psum over the {MESH_DATA} shards' gradient trees, "
          f"{comp['leaves']} leaves on the card: worst |mean - exact mean| "
          f"{comp['worst_err_over_scale']:.3f} x max|t|/127 (limit 1); "
          f"{comp['cpu']['leaves']} leaves ({comp['cpu']['elements']:,} elements) "
          f"again on the CPU: {comp['cpu']['unequal']} elements unequal (bit for "
          f"bit); {comp['seconds']:.1f} s with its step", flush=True)
    if got != want:
        raise AssertionError(f"meshed step launches {got}, want {want}")
    if dp["loss"] > MESH_LOSS_TOL or dp["grad_norm"] > MESH_GRAD_TOL["grad_norm"] \
            or dp["grads"] > MESH_GRAD_TOL["grads"]:
        raise AssertionError(f"data-parallel step vs meshless: {dp}")
    for f, mv in planted.items():
        if mv["grads"] <= MESH_GRAD_TOL["grads"]:
            raise AssertionError(f"a planted merge fault ({f}) passed: {mv}")
    if comp["worst_err_over_scale"] > 1.0 or comp["cpu"]["unequal"] \
            or not comp["cpu"]["leaves"]:
        raise AssertionError(f"compressed_psum: {comp}")
    if bwd_stats["calls"] != L * MESH_DATA or bwd_stats["bad"]:
        raise AssertionError(f"meshed flash_attention_bwd vs plain: {bwd_stats}")
    if not math.isfinite(m_mesh["loss"]):
        raise AssertionError("meshed loss not finite")
    del model, state, grads_ref, diffs, diffs_d
    torch.cuda.empty_cache()

    # -- (c) expert-parallel MoE ---------------------------------------------------
    arch, layers = MESH_MOE
    mcfg = _serve_cfg(arch, "flash", layers)
    mapi = registry.get_api(mcfg)
    mmesh = make_local_mesh(MESH_MOE_DATA, MESH_MOE_MODEL, device=dev)
    e_local = mcfg.moe.num_experts // MESH_MOE_MODEL
    mmodel = mapi.init(mcfg, torch.Generator(device=dev).manual_seed(seed))
    Bm, Sm = MESH_MOE_BATCH, MESH_MOE_SEQ
    mbatch = serve.make_batch(mcfg, Bm, Sm, np.random.default_rng(seed), dev)
    rows = Bm // MESH_MOE_DATA
    n_moe = sum(1 for _, m in mmodel.blocks() if m)

    def moe_prefill(b, ctx, forced=None):
        recs: list = []
        with torch.no_grad(), ctx, routing(recs, forced):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, lg = mapi.prefill(mmodel, b, mcfg, Sm)
            torch.cuda.synchronize()
        return lg[:, -1].float(), cache["k"], recs, (time.perf_counter() - t0) * 1e3

    # the meshless path on each data shard's rows: its block's capacity and
    # its rank order within an expert are what each EP block computes
    blocks = [{k: v[i * rows:(i + 1) * rows] for k, v in mbatch.items()}
              for i in range(MESH_MOE_DATA)]
    plain = [moe_prefill(b, contextlib.nullcontext()) for b in blocks]
    ranks = []
    real_dispatch = moe_mod._dispatch
    moe_mod._dispatch = lambda *a, **kw: ranks.append(kw["rank"]) or real_dispatch(*a, **kw)
    try:
        lg_ep, k_ep, rec_ep, ep_ms = moe_prefill(mbatch, sharding_ctx(mmesh))
    finally:
        moe_mod._dispatch = real_dispatch
    if ranks != list(range(MESH_MOE_MODEL)) * (MESH_MOE_DATA * n_moe):
        raise AssertionError(f"EP ranks {ranks}")
    lg_plain = torch.cat([p[0] for p in plain])
    k_plain = torch.cat([p[1] for p in plain], dim=1)
    plain_ms = sum(p[3] for p in plain)
    # EP records each layer's blocks in turn; the meshless runs a block's layers
    flip = torch.zeros((Bm, Sm), dtype=torch.bool, device=dev)
    forced_ep = []
    for layer in range(n_moe):
        for i in range(MESH_MOE_DATA):
            want_idx = plain[i][2][layer]
            got_idx = rec_ep[layer * MESH_MOE_DATA + i]
            forced_ep.append(want_idx)
            f = (want_idx.sort(dim=-1).values != got_idx.sort(dim=-1).values).any(-1)
            flip[i * rows:(i + 1) * rows] |= f.reshape(rows, Sm)
    per_req = flip.sum(dim=1).tolist()
    gap = (lg_ep - lg_plain).abs().amax(dim=-1).cpu()
    k_gap = (k_ep.float() - k_plain.float()).abs().amax(dim=(0, 2, 3, 4)).cpu()
    agree = [b for b in range(Bm) if not per_req[b]]
    lg_f, k_f, _, _ = moe_prefill(mbatch, sharding_ctx(mmesh), forced_ep)
    fgap = (lg_f - lg_plain).abs().amax(dim=-1).cpu()
    fk = float((k_f.float() - k_plain.float()).abs().max())
    with planted_rank_merge(MESH_MOE_MODEL):
        lg_p, _, _, _ = moe_prefill(mbatch, sharding_ctx(mmesh), forced_ep)
    pgap = float((lg_p - lg_plain).abs().max())
    moe_out = {"arch": arch, "layers": layers, "mesh": [MESH_MOE_DATA, MESH_MOE_MODEL],
               "experts_per_rank": e_local, "batch": Bm, "seq": Sm,
               "flipped_tokens": int(flip.sum()), "flipped_per_request": per_req,
               "last_logit_gap": gap.tolist(), "forced_gap": fgap.tolist(),
               "cache_k_gap": k_gap.tolist(), "forced_cache_k_gap": fk,
               "planted_gap": pgap,
               "ep_prefill_ms": ep_ms, "meshless_prefill_ms": plain_ms}
    print(f"  (c) {arch} ({layers} layers; {mcfg.moe.num_experts} experts, top-"
          f"{mcfg.moe.top_k}, {mcfg.moe.num_shared} shared, capacity factor "
          f"{mcfg.moe.capacity_factor}) prefill {Bm} x {Sm} on a data "
          f"{MESH_MOE_DATA} x model {MESH_MOE_MODEL} mesh ({e_local} experts a "
          f"rank, {n_moe} MoE layers x {MESH_MOE_DATA} blocks x {MESH_MOE_MODEL} "
          f"ranks dispatched) against the meshless path on each data shard's "
          f"{rows} rows: {int(flip.sum())} of {Bm * Sm} tokens take other experts "
          f"in some layer (per request {per_req}); last-logit gap per request "
          f"{[round(x, 4) for x in gap.tolist()]}, cache k per request "
          f"{[round(x, 4) for x in k_gap.tolist()]}; with the EP run on the "
          f"meshless experts {[round(x, 4) for x in fgap.tolist()]}, cache k "
          f"{fk:.4f} (tolerance {FAMILY_TOL} on logits and on the cache, as "
          f"phase 10's families, for the forced run and "
          f"the requests {agree} whose tokens keep their experts); planted, the "
          f"forced run without model rank {MESH_MOE_MODEL - 1}'s partials: logits "
          f"{pgap:.3f} apart (must pass {FAMILY_TOL})", flush=True)
    print(f"  (c) [{card}] prefill: EP {ep_ms:.1f} ms, meshless {plain_ms:.1f} ms "
          f"(its {MESH_MOE_DATA} blocks)", flush=True)
    if any(float(gap[b]) > FAMILY_TOL or float(k_gap[b]) > FAMILY_TOL
           for b in agree) or float(fgap.max()) > FAMILY_TOL \
            or fk > FAMILY_TOL or not bool(torch.isfinite(lg_ep).all()):
        raise AssertionError(f"EP prefill vs meshless: {moe_out}")
    if pgap <= FAMILY_TOL:
        raise AssertionError(f"the planted EP merge passed: {moe_out}")
    del mmodel, plain
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"  [{card}] phase 13 in {seconds:.1f} s; B5 / B7 launches on its main "
          f"path {launches}", flush=True)
    return {"serve": serve_out,
            "train": {"batch": Bt, "seq": St, "loss": m_mesh["loss"],
                      "loss_meshless": m_ref["loss"], "vs_meshless": dp,
                      "planted": planted, "step_wall_ms": {"mesh": wall_mesh,
                                                           "meshless": wall_plain},
                      "peak_memory_gb": peak_gb, "launches": got,
                      "bwd_vs_plain": bwd_stats},
            "compressed_psum": comp, "moe": moe_out, "launches": launches,
            "seconds": seconds}


# -- phase 14: the dry-run, and its cost model held on the card ------------------

# (arch, shape, --set overrides) of the dry-run cells phase 14(a) runs on
# "meta" at published width, each on both pod meshes. The train cells'
# depth is cut, to fit the script's time limit: a meta op costs ~100 us
# of Python (PyTorch's meta kernels), and on the H100 machine's host
# qwen3-1.7b's 28 layers took 84 s (pod) and 171 s (multi-pod), and
# deepseek-moe-16b's 4 layers 56 s and 105 s (every expert rank of every
# data shard runs in turn). qwen3-1.7b keeps 2 of 28 layers (7 ran
# 36.2 s on the multi-pod mesh), deepseek-moe-16b 2 (1 dense, 1 MoE:
# expert-parallel on the model axis; 29.6 s)
DRYRUN_CELLS = (("qwen3-1.7b", "train_4k", ("n_layers=2",)),
                ("deepseek-moe-16b", "train_4k", ("n_layers=2",)),
                ("qwen3-1.7b", "decode_32k", ("attn_impl=flash",)),
                ("zamba2-1.2b", "long_500k", ()))
DRYRUN_WAIT_S = 180         # the longest phase 14 waits for a cell still running
COST_KEYS = ("flops", "matmul_flops", "bytes", "kernels", "collectives")


def start_dryruns(out_dir: Path) -> list:
    """Phase 14(a)'s cells, one process per (cell, mesh), all at once on
    the host's cores at the lowest priority. They start after phase 13's
    last timing and run beside 14(b) alone, whose one timing is the
    device time in a profiler trace (host gaps are not in it)."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    procs = []
    for arch, shape, sets in DRYRUN_CELLS:
        for mesh in ("pod", "multipod"):
            cmd = ["nice", "-n", "19", sys.executable, "-m",
                   "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
                   "--mesh", mesh, "--out", str(out_dir)]
            cmd += [a for s in sets for a in ("--set", s)]
            procs.append(((arch, shape, mesh, sets), subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env, cwd=ROOT)))
    return procs


def finish_dryruns(procs: list, out_dir: Path, card: str) -> list:
    """Phase 14(a): each cell's record on both meshes, its roofline terms
    and the seconds of its meta run. A cell that failed, or whose record
    is not ``ok`` on 256 / 512 chips, raises; the flash decode cell must
    charge flash_decode (B6) once per layer."""
    from repro_torch.launch.dryrun import NET_BW, summary

    t0 = time.perf_counter()
    recs = []
    for (arch, shape, mesh, sets), p in procs:
        try:
            _, err = p.communicate(
                timeout=max(DRYRUN_WAIT_S - (time.perf_counter() - t0), 1))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"phase 14: the dry-run of {arch} x {shape} "
                                 f"on {mesh} ran past {DRYRUN_WAIT_S} s") from None
        if p.returncode:
            raise AssertionError(f"phase 14: the dry-run of {arch} x {shape} on "
                                 f"{mesh} failed:\n{err[-3000:]}")
        rec = json.loads((out_dir / mesh / f"{arch}__{shape}.json").read_text())
        if rec["status"] != "ok" or rec["chips"] != (512 if mesh == "multipod" else 256):
            raise AssertionError(f"phase 14: {rec}")
        if "attn_impl=flash" in sets and "flash_decode" not in rec["kernels"]:
            raise AssertionError(f"phase 14: {arch} x {shape} {sets} charged no "
                                 f"flash_decode: {rec['kernels']}")
        r = rec["roofline"]
        print(f"  (a) [{card}] {summary(rec)} {' '.join(sets)}", flush=True)
        coll = rec["collectives"]
        print(f"      compute_s {r['compute_s']:.6g}, memory_s {r['memory_s']:.6g}, "
              f"collective_s {r['collective_s']:.6g} (the mesh mean; a device "
              f"in every call {coll['wire_bytes_per_device'] / NET_BW:.6g}) (H100 "
              f"data-sheet model, not a measurement); {coll['by_kind']}; "
              f"kernels {rec['kernels'] or 'none'}", flush=True)
        recs.append({k: rec[k] for k in ("arch", "shape", "mesh", "chips", "lower_s",
                                          "hlo_model", "collectives", "kernels",
                                          "roofline", "memory_analysis")}
                    | {"overrides": list(sets)})
    return recs


def cost_diffs(card: dict, meta: dict) -> list:
    """The cost-model keys on which a card run and a meta run differ."""
    return [k for k in COST_KEYS if card[k] != meta[k]]


@contextlib.contextmanager
def dropped_charge(name: str):
    """The cost model with kernel ``name``'s charges dropped: the planted
    fault the card-vs-meta check must see."""
    from repro_torch.launch import hlocost

    real = hlocost.CostModel.kernel
    hlocost.CostModel.kernel = lambda self, n, cost, out: \
        None if n == name else real(self, n, cost, out)
    try:
        yield
    finally:
        hlocost.CostModel.kernel = real


def run_cost_model(dev, seed: int, card: str) -> dict:
    """Phase 14(b): the cost model over one real step on the card and over
    the same step on "meta", both on a mesh of one chip: qwen3-1.7b at its
    published config, phase 11's train step (flash, remat; B5 and B7
    launched) and phase 10's flash decode step (B6 launched). flops,
    bytes, every kernel's count and charge and the collectives must be
    equal, and a meta run with B7's (and B6's) charge dropped must differ.
    Printed beside the card: the step's device time, compute_s and
    memory_s at the H100's data-sheet peaks, model flops over device time
    at 989e12 flop/s, and the meta run's peak of live bytes beside
    ``torch.cuda.max_memory_allocated``. Returns the numbers and the
    kernels' launches on these steps."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import hlocost, serve
    from repro_torch.launch.dryrun import HBM_BW, PEAK_FLOPS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import optim, registry, steps
    from repro_torch.models.sharding import sharding_ctx

    t_phase = time.perf_counter()
    launches = {"flash_mha_fwd": 0, "flash_attention_bwd": 0, "flash_decode": 0}
    out = {}

    def measured(label, step, args, meta_args, model_flops, planted):
        """Device time of one uncounted step, then the counted step on the
        card (launch counts zeroed before and read after), the same step
        on meta, and the planted fault."""
        with sharding_ctx(make_local_mesh(1, 1, device=dev)):
            ms = device_ms(lambda: step(*args))
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _build.reset_launches()
            got, _ = hlocost.analyze(step, *args, device=dev)
            torch.cuda.synchronize()
            for k in launches:
                launches[k] += _build.LAUNCHES[k]
            peak = torch.cuda.max_memory_allocated() - base
        with sharding_ctx(make_local_mesh(1, 1, device="meta")):
            meta, _ = hlocost.analyze(step, *meta_args(), device="meta")
            with dropped_charge(planted):
                bad, _ = hlocost.analyze(step, *meta_args(), device="meta")
        diffs = cost_diffs(got, meta)
        if diffs:
            raise AssertionError(f"phase 14 {label}: card and meta differ on {diffs}:"
                                 f"\n card {got}\n meta {meta}")
        if not cost_diffs(got, bad):
            raise AssertionError(f"phase 14 {label}: the meta run without "
                                 f"{planted}'s charge passed")
        compute_s, memory_s = got["flops"] / PEAK_FLOPS, got["bytes"] / HBM_BW
        mfu = None if ms is None else model_flops / (ms / 1e3 * PEAK_FLOPS)
        print(f"  (b) [{card}] {label}: card == meta: flops {got['flops']:.6e} "
              f"(matmul {got['matmul_flops']:.6e}), bytes {got['bytes']:.6e}, "
              f"collectives {got['collectives']['by_kind'] or 'none'}", flush=True)
        for name, k in got["kernels"].items():
            print(f"      {name}: {k['count']} calls, {k['flops']:.6e} flops, "
                  f"{k['bytes']:.6e} bytes", flush=True)
        dev_s = "not measured" if ms is None else f"{ms:.3f} ms"
        print(f"      device time {dev_s} beside compute_s {compute_s * 1e3:.3f} ms "
              f"and memory_s {memory_s * 1e3:.3f} ms (data-sheet model); model "
              f"flops {model_flops:.6e} / (device time x 989e12) = "
              f"{'not measured' if mfu is None else f'{mfu:.4f}'}; meta peak of "
              f"live bytes {meta['peak_bytes'] / 1e9:.3f} GB, "
              f"torch.cuda.max_memory_allocated over the step {peak / 1e9:.3f} GB; "
              f"planted ({planted}'s charge dropped) differs on "
              f"{cost_diffs(got, bad)}", flush=True)
        out[label] = {"cost": got, "device_ms": ms, "compute_s": compute_s,
                      "memory_s": memory_s, "model_flops": model_flops,
                      "model_flops_per_device_s": mfu,
                      "meta_peak_bytes": meta["peak_bytes"],
                      "cuda_peak_bytes": peak, "planted_diffs": cost_diffs(got, bad)}

    cfg = _serve_cfg(TRAIN_ARCH, "flash")
    check_published(cfg)
    B, S = TRAIN_BATCH, TRAIN_SEQ
    gen = torch.Generator(device=dev).manual_seed(seed)
    model, state = steps.init_train_state(cfg, gen)
    batch = serve.make_batch(cfg, B, S, np.random.default_rng(seed), dev)
    step = steps.make_train_step(cfg, optim.OptimConfig(**TRAIN_OPT))

    def meta_train():
        m, st = steps.init_train_state(cfg, registry._MetaGenerator())
        return m, st, registry.batch_specs(cfg, B, S)

    measured(f"train step {B} x {S}", step, (model, state, batch), meta_train,
             6 * cfg.n_params() * B * S, "flash_attention_bwd")
    del model, state, batch
    torch.cuda.empty_cache()

    scfg = _serve_cfg(SERVE_ARCH, "flash")
    api = registry.get_api(scfg)
    max_len = registry.prefill_cache_len(scfg, SERVE_PROMPT) + SERVE_NEW
    model = api.init(scfg, torch.Generator(device=dev).manual_seed(seed))
    batch = serve.make_batch(scfg, SERVE_BATCH, SERVE_PROMPT,
                             np.random.default_rng(seed), dev)
    cache, tok = steps.make_prefill_step(scfg, api, max_len=max_len)(model, batch)
    decode = steps.make_decode_step(scfg, api)

    def meta_decode():
        toks, c = registry.decode_specs(scfg, SERVE_BATCH, max_len)
        return api.init(scfg, registry._MetaGenerator()), c, toks["tokens"]

    measured(f"decode step {SERVE_BATCH} x ({SERVE_PROMPT} + {SERVE_NEW})", decode,
             (model, cache, tok), meta_decode, 2 * scfg.n_params() * SERVE_BATCH,
             "flash_decode")
    del model, cache, batch
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    print(f"  [{card}] phase 14(b) in {seconds:.1f} s; launches on its steps "
          f"{launches}", flush=True)
    return {"steps": out, "launches": launches, "seconds": seconds}


# -- phase 15: the model mesh across processes (torch.distributed ranks) --------

RANK_ARCH = "qwen3-1.7b"    # the train and serve paths' model, at its published width
RANK_BATCH, RANK_SEQ = 4, 2_048           # phase 11's train batch
RANK_SERVE_BATCH, RANK_PROMPT, RANK_NEW = 4, 2_048, 16   # phase 13's serve cell
RANK_STEPS = 3              # steps of each path: one held, two timed
RANK_B_LAYERS = 2           # 15(b)'s depth: two processes share the card
RANK_B_TIMEOUT = 240        # s: 15(b)'s two processes, their start included
RANK_COLLECTIVES = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all")


def _file_init(tmp: str) -> str:
    """A ``FileStore`` rendezvous in ``tmp``: no port to find free."""
    return "file://" + os.path.join(tmp, "store")


def _gloo_cuda_probe(rank: int, world: int, init: str, out: str) -> None:
    """One of two gloo ranks on the one card: each collective the rank path
    needs, over CUDA tensors, against its value computed by hand; the
    verdicts (or the error text) to ``out``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    want = {"all_reduce": sum(torch.arange(8.0) + 10 * r for r in range(world)),
            "all_gather": torch.cat([torch.arange(8.0) + 10 * r
                                     for r in range(world)]),
            "reduce_scatter": sum(torch.arange(8.0) + 10 * r for r in range(world)
                                  ).chunk(world)[rank],
            "all_to_all": torch.cat([(torch.arange(8.0) + 10 * r).chunk(world)[rank]
                                     for r in range(world)])}
    verdicts = {}
    for name in RANK_COLLECTIVES:
        try:
            if name == "all_reduce":
                got = x.clone()
                dist.all_reduce(got)
            elif name == "all_gather":
                got = x.new_empty(8 * world)
                dist.all_gather_into_tensor(got, x)
            elif name == "reduce_scatter":
                got = x.new_empty(8 // world)
                dist.reduce_scatter_tensor(got, x)
            else:
                got = torch.empty_like(x)
                dist.all_to_all_single(got, x)
            torch.cuda.synchronize()
            ok = torch.equal(got.cpu(), want[name])
            verdicts[name] = "ok" if ok else f"wrong values {got.cpu().tolist()}"
        except Exception as e:  # recorded: the probe's finding
            verdicts[name] = f"{type(e).__name__}: {e}"[:400]
    dist.destroy_process_group()
    Path(out, f"probe{rank}.json").write_text(json.dumps(verdicts))


def _rank_15b(rank: int, world: int, init: str, out: str) -> None:
    """15(b)'s rank: qwen3-1.7b at its published width, RANK_B_LAYERS
    layers, data 2 x model 1 over gloo on the one card; its placed train
    step against the meshless one it also runs (same seed and batch)."""
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh
    from repro_torch.models import optim, registry, steps
    from repro_torch.models.sharding import (local_slice, place_params,
                                             placements, sharding_ctx)

    mesh = init_rank_mesh(world, 1, None, rank=rank, world_size=world,
                          local_rank=0, init_method=init, backend="gloo")
    try:
        dev = mesh.device
        cfg = dataclasses.replace(_serve_cfg(RANK_ARCH, "flash"),
                                  n_layers=RANK_B_LAYERS)
        batch = serve.make_batch(cfg, RANK_BATCH, RANK_SEQ // 4,
                                 np.random.default_rng(7), dev)
        step = steps.make_train_step(cfg, optim.OptimConfig(**TRAIN_OPT))
        model = registry.get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(7))
        ref: dict = {}
        with captured_grads(model, ref, update=False):
            _, _, m_ref = step(model, None, batch)
        place_params(model, cfg, mesh)
        pls = placements(model)
        ref = {n: local_slice(g, pls[n].spec, mesh) for n, g in ref.items()}
        diffs: dict = {}
        _build.reset_launches()
        with sharding_ctx(mesh), captured_grads(model, diffs, ref, update=False):
            _, _, m = step(model, None, batch)
        torch.cuda.synchronize()
        leaf, worst = _worst(diffs)
        Path(out, f"rank{rank}.json").write_text(json.dumps({
            "loss": float(m["loss"]), "loss_ref": float(m_ref["loss"]),
            "grads": worst, "worst_leaf": leaf,
            "launches": {k: _build.LAUNCHES[k] for k in
                         ("flash_mha_fwd", "flash_attention_bwd")}}))
    finally:
        close_rank_mesh()


def _spawn_ranks(fn, n: int, tmp: str, timeout: float, *args) -> None:
    """``fn(rank, n, init, tmp, *args)`` in ``n`` spawned processes, joined
    within ``timeout`` (killed after it); a rank's failure raises here."""
    _join_ranks(_start_ranks(fn, n, tmp, *args), fn, timeout)


def _start_ranks(fn, n: int, tmp: str, *args):
    """``fn(rank, n, init, tmp, *args)`` started in ``n`` spawned processes;
    ``_join_ranks`` waits for them."""
    import torch.multiprocessing as mp

    return mp.spawn(fn, args=(n, _file_init(tmp), tmp, *args), nprocs=n,
                    join=False)


def _join_ranks(ctx, fn, timeout: float) -> None:
    """Join the processes of ``_start_ranks`` within ``timeout`` (killed
    after it); a rank's failure raises here."""
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: not done after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)


def run_rank_mesh(dev, seed: int, card: str) -> dict:
    """Phase 15: the model mesh across ``torch.distributed`` ranks.
    (a) A one-rank NCCL group (a FileStore rendezvous): qwen3-1.7b at its
    published config, its weights placed (``sharding.place_params``), one
    train step (flash, remat) through the rank path held to TRAIN_TOL
    against the meshless step from the same weights and batch, and two
    timed steps of each; then a prefill on the rank mesh and RANK_NEW
    teacher-forced decode steps of the shardmap decode and of the flash
    decode (B6) on it, each held to SERVE_TOL against the meshless one-hot
    decode. (b) Whether two gloo ranks that share the card carry the
    collectives the path needs over CUDA tensors; where they do, a
    data 2 x model 1 step at RANK_B_LAYERS layers against the meshless
    one. Returns the numbers and the B5 / B6 / B7 launches of (a)'s
    rank path."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    t_phase = time.perf_counter()
    out: dict = {}
    launches = {"flash_mha_fwd": 0, "flash_attention_bwd": 0, "flash_decode": 0}

    def counted(fn):
        _build.reset_launches()
        r = fn()
        for k in launches:
            launches[k] += _build.LAUNCHES[k]
        return r

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        mesh = init_rank_mesh(1, 1, None, rank=0, world_size=1, local_rank=0,
                              init_method=_file_init(tmp))
        try:
            out["a"] = _rank_15a(mesh, dev, seed, card, counted)
        finally:
            close_rank_mesh()
        out["b"] = _rank_15b_run(card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  [{card}] phase 15 in {out['seconds']:.1f} s", flush=True)
    return out


def _rank_15a(mesh, dev, seed: int, card: str, counted) -> dict:
    """15(a) on ``mesh`` (one rank); ``counted(fn)`` runs the rank path's
    parts, adding their launches to the phase's."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import optim, registry, steps
    from repro_torch.models.sharding import place_params, sharding_ctx

    cfg = _serve_cfg(RANK_ARCH, "flash")
    check_published(cfg)
    L = cfg.n_layers
    api = registry.get_api(cfg)
    batch = serve.make_batch(cfg, RANK_BATCH, RANK_SEQ, np.random.default_rng(seed), dev)
    opt_cfg = optim.OptimConfig(**TRAIN_OPT)
    step = steps.make_train_step(cfg, opt_cfg)

    def timed_steps(model, state, ctx) -> tuple[list, float]:
        walls = []
        for i in range(RANK_STEPS - 1):
            torch.cuda.synchronize()
            if i == RANK_STEPS - 2:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with ctx():
                _, _, m = step(model, state, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            if not math.isfinite(float(m["loss"])):
                raise AssertionError(f"phase 15: non-finite loss {m}")
        return walls, torch.cuda.max_memory_allocated() / 1e9

    # the meshless step's gradients: the reference (its walls come last,
    # each path timed with nothing of the other on the card)
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    ref: dict = {}
    with captured_grads(model, ref, update=False):
        _, _, m_ref = step(model, None, batch)
    m_ref = {k: float(v) for k, v in m_ref.items() if k != "lr"}
    del model
    torch.cuda.empty_cache()

    # the rank path from the same weights: placed, one held step, two timed
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    place_params(model, cfg, mesh)
    state = optim.init_opt_state(model)
    diffs: dict = {}
    bwd_stats: dict = {}

    def held():
        with sharding_ctx(mesh), checking_bwd(bwd_stats, limit=2), \
                captured_grads(model, diffs, ref, update=False):
            _, _, m = step(model, state, batch)
        return {k: float(v) for k, v in m.items() if k != "lr"}

    m_rank = counted(held)
    del ref
    torch.cuda.empty_cache()
    walls_rank, peak_rank = counted(lambda: timed_steps(
        model, state, lambda: sharding_ctx(mesh)))
    del state
    for p in model.parameters():
        p.grad = None
    torch.cuda.empty_cache()
    serve_out = _rank_serve(model, cfg, api, mesh, dev, seed, card, counted)
    del model
    torch.cuda.empty_cache()
    model = api.init(cfg, torch.Generator(device=dev).manual_seed(seed))
    state = optim.init_opt_state(model)
    walls_plain, peak_plain = timed_steps(model, state, contextlib.nullcontext)
    del model, state
    torch.cuda.empty_cache()
    leaf, worst = _worst(diffs)
    train = {"loss": _rel(m_rank["loss"], m_ref["loss"]),
             "grad_norm": _rel(m_rank["grad_norm"], m_ref["grad_norm"]),
             "grads": worst, "worst_leaf": leaf,
             "walls_ms": {"meshless": walls_plain, "rank": walls_rank},
             "peak_gb": {"meshless": peak_plain, "rank": peak_rank},
             "bwd_vs_plain": bwd_stats}
    print(f"  (a) train {RANK_ARCH} ({L} layers, {RANK_BATCH} x {RANK_SEQ} tokens, "
          f"flash, remat) on a one-rank {mesh.backend} mesh, weights placed: loss "
          f"{m_rank['loss']:.5f} / meshless {m_ref['loss']:.5f} (relative "
          f"{train['loss']:.2e}, limit {TRAIN_TOL['loss']}), grad norm relative "
          f"{train['grad_norm']:.2e} (limit {TRAIN_TOL['grad_norm']}), worst leaf "
          f"{worst:.3e} ({leaf}; limit {TRAIN_TOL['grads']}); "
          f"{bwd_stats['calls']} of its flash_attention_bwd calls == plain, worst "
          f"{bwd_stats['max_err']:.3e} x scale, {bwd_stats['bad']} beyond", flush=True)
    print(f"  (a) [{card}] step wall ms: meshless {[round(w, 1) for w in walls_plain]}, "
          f"rank path {[round(w, 1) for w in walls_rank]}; peak memory "
          f"(max_memory_allocated, the last step) meshless {peak_plain:.2f} GB, "
          f"rank path {peak_rank:.2f} GB", flush=True)
    if any(train[k] > TRAIN_TOL[k] for k in ("loss", "grad_norm", "grads")) \
            or bwd_stats["bad"] or bwd_stats["calls"] != 2:
        raise AssertionError(f"phase 15 (a) rank step vs meshless: {train}")
    return {"layers": L, "train": train, "serve": serve_out,
            "backend": mesh.backend}


def _rank_serve(model, cfg, api, mesh, dev, seed: int, card: str, counted) -> dict:
    """15(a)'s serving on the rank mesh with the placed ``model``: the
    prefill (B5), then the shardmap decode and the flash decode (B6), each
    against the meshless one-hot decode from the same cache."""
    import dataclasses

    import torch

    from repro_torch.launch import serve
    from repro_torch.models.sharding import sharding_ctx

    B, P, NEW = RANK_SERVE_BATCH, RANK_PROMPT, RANK_NEW
    onehot = dataclasses.replace(cfg, attn_impl="blocked", decode_cache_update="onehot")
    smap = dataclasses.replace(cfg, decode_cache_update="shardmap")
    flash = dataclasses.replace(cfg, decode_cache_update="dus")
    sbatch = serve.make_batch(cfg, B, P, np.random.default_rng(seed), dev)
    forced = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (NEW, B, 1)).astype(np.int32)).to(dev)

    def prefill():
        with torch.no_grad(), sharding_ctx(mesh):
            return api.prefill(model, sbatch, cfg, P + NEW)[0]

    cache = counted(prefill)

    def decode(run_cfg, ctx):
        c = {k: v.clone() for k, v in cache.items()}
        logits = []
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(NEW + 1)]
        with torch.no_grad(), ctx():
            ev[0].record()
            for t in range(NEW):
                c, lg = api.decode(model, c, forced[t], run_cfg)
                logits.append(lg[:, -1].float())
                ev[t + 1].record()
            torch.cuda.synchronize()
        return torch.stack(logits), [ev[i].elapsed_time(ev[i + 1]) for i in range(NEW)]

    lg_ref, ms_ref = decode(onehot, contextlib.nullcontext)
    lg_smap, ms_smap = counted(lambda: decode(smap, lambda: sharding_ctx(mesh)))
    lg_flash, ms_flash = counted(lambda: decode(flash, lambda: sharding_ctx(mesh)))
    top2 = lg_ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > SERVE_TOL
    serve_out = {}
    for name, lg, ms in (("shardmap", lg_smap, ms_smap), ("flash", lg_flash, ms_flash)):
        gap = float((lg - lg_ref).abs().max())
        bad = int(((lg.argmax(-1) != lg_ref.argmax(-1)) & sure).sum())
        serve_out[name] = {"max_logit_diff": gap, "argmax_differs_beyond_margin": bad,
                           "decode_ms_median": statistics.median(ms)}
        if not math.isfinite(gap) or gap > SERVE_TOL or bad:
            raise AssertionError(f"phase 15 (a) {name} decode on the rank mesh "
                                 f"vs one-hot: {serve_out[name]}")
    serve_out["onehot_meshless_ms_median"] = statistics.median(ms_ref)
    print(f"  (a) serve {B} x ({P} + {NEW}) on the rank mesh (flash prefill), "
          f"teacher-forced, against the meshless one-hot decode: shardmap max "
          f"|logit diff| {serve_out['shardmap']['max_logit_diff']:.4f}, flash decode "
          f"{serve_out['flash']['max_logit_diff']:.4f} (limit {SERVE_TOL}; argmax "
          f"differing beyond the margin: {serve_out['shardmap']['argmax_differs_beyond_margin']}"
          f", {serve_out['flash']['argmax_differs_beyond_margin']}); [{card}] decode ms "
          f"a step (median of {NEW}, CUDA events): one-hot meshless "
          f"{serve_out['onehot_meshless_ms_median']:.2f}, shardmap rank "
          f"{serve_out['shardmap']['decode_ms_median']:.2f}, flash rank "
          f"{serve_out['flash']['decode_ms_median']:.2f}", flush=True)
    return serve_out


def _rank_15b_run(card: str, tmp: str) -> dict:
    """15(b): the gloo probe over CUDA tensors; the data 2 x model 1 step
    where every collective passed."""
    probe_dir = tempfile.mkdtemp(dir=tmp)
    _spawn_ranks(_gloo_cuda_probe, 2, probe_dir, RANK_B_TIMEOUT)
    verdicts = [json.loads(Path(probe_dir, f"probe{r}.json").read_text())
                for r in range(2)]
    carried = all(v[c] == "ok" for v in verdicts for c in RANK_COLLECTIVES)
    print(f"  (b) two gloo ranks on the one card, CUDA tensors: "
          + "; ".join(f"{c} {verdicts[0][c]}" + ("" if verdicts[1][c] == verdicts[0][c]
                                                 else f" / rank 1 {verdicts[1][c]}")
                      for c in RANK_COLLECTIVES), flush=True)
    out = {"probe": verdicts, "carried": carried}
    if not carried:
        print("  (b) left out: gloo does not carry every collective the rank "
              "path needs over CUDA tensors (the probe's text above)", flush=True)
        return out
    run_dir = tempfile.mkdtemp(dir=tmp)
    t0 = time.perf_counter()
    _spawn_ranks(_rank_15b, 2, run_dir, RANK_B_TIMEOUT)
    ranks = [json.loads(Path(run_dir, f"rank{r}.json").read_text()) for r in range(2)]
    out.update(ranks=ranks, seconds=time.perf_counter() - t0)
    print(f"  (b) [{card}] data 2 x model 1 over gloo on the one card, "
          f"{RANK_ARCH} at {RANK_B_LAYERS} layers, {RANK_BATCH} x {RANK_SEQ // 4} "
          f"tokens: " + "; ".join(
              f"rank {r}: loss {x['loss']:.5f} / meshless {x['loss_ref']:.5f}, worst "
              f"leaf {x['grads']:.3e} ({x['worst_leaf']}), launches {x['launches']}"
              for r, x in enumerate(ranks)) + f" ({out['seconds']:.1f} s)", flush=True)
    for x in ranks:
        if _rel(x["loss"], x["loss_ref"]) > TRAIN_TOL["loss"] \
                or x["grads"] > TRAIN_TOL["grads"] or not all(x["launches"].values()):
            raise AssertionError(f"phase 15 (b): {ranks}")
    return out


# -- phase 16: the DataFrame engine across processes (torch.distributed ranks) --

RANK_ENGINE_MODES = {"kernel": ROUNDS, "shard_map": 1}   # rounds of the 12
RANK_ENGINE_RANKS = 4       # 16(b): gloo ranks sharing the card
RANK_ENGINE_TIMEOUT = 300   # s: 16(b)'s four processes, their start included
RANK_ENGINE_SHARDS = 4      # the one-process mesh 16(b)'s walls are set beside
RANK_ENGINE_KERNELS = ("filter_count", "segment_agg", "block_topk",
                       "merge_join_count")


def _answer(v):
    """One answer in a JSON-ready form that keeps its dtypes."""
    if isinstance(v, dict):
        return {k: [np.asarray(x).tolist(), str(np.asarray(x).dtype)]
                for k, x in v.items()}
    return [v.item() if isinstance(v, np.generic) else v, type(v).__name__]


def _engine_answers(sess, rounds: int) -> dict:
    return {f"{name}:{r}": _answer(fn(*_frames(sess), np.random.default_rng(100 + r)))
            for name, fn in EXPRESSIONS.items() for r in range(rounds)}


def _engine_walls(sess) -> dict:
    """Each expression's wall (median of 7 host-clock runs, result on the
    host), literals of one draw."""
    return {name: host_ms(lambda fn=fn: fn(*_frames(sess), np.random.default_rng(1)))
            for name, fn in EXPRESSIONS.items()}


def _rank_16b(rank: int, world: int, init: str, out: str, seed: int) -> None:
    """16(b)'s rank: one of RANK_ENGINE_RANKS gloo ranks on the one card,
    a kernel session over its own ROWS / world rows of each table; its
    answers, launches, memory and walls to ``out``."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    torch.cuda.set_device(0)
    mesh = init_rank_mesh(world, 1, None, rank=rank, world_size=world,
                          local_rank=0, init_method=init, backend="gloo")
    try:
        Path(out, f"rank{rank}.json").write_text(json.dumps(
            _rank_engine_body(mesh, wisconsin.generate(ROWS, seed=seed))))
    finally:
        close_rank_mesh()


def _rank_engine_body(mesh, table) -> dict:
    """A kernel session on ``mesh`` (a RankMesh) over the two datasets of
    the 12 expressions: the rows and bytes this process holds after
    registering, its answers and launches over ROUNDS, its walls."""
    import torch

    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    sess = _mesh_sessions(table, mesh, ("kernel",))["kernel"]
    torch.cuda.synchronize()
    placed_s = time.perf_counter() - t0
    held_bytes = torch.cuda.memory_allocated()
    rows = sess.catalog.get("bench", "data").table.columns["unique1"].shape[0]
    _build.reset_launches()
    answers = _engine_answers(sess, ROUNDS)
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
    return {"rank": mesh.rank, "rows": rows, "held_bytes": held_bytes,
            "placed_s": placed_s, "answers": answers, "launches": launches,
            "walls_ms": _engine_walls(sess)}


def run_rank_engine(table, raw: dict, dev, seed: int, card: str,
                    sweep: dict | None) -> dict:
    """Phase 16: the DataFrame engine on a mesh of ``torch.distributed``
    ranks, each rank holding only its row shard of every table.
    (a) A one-rank NCCL group (a FileStore rendezvous): a Session on it
    over the ROWS-row tables in kernel and shard_map mode; the 12
    expressions (RANK_ENGINE_MODES' rounds) equal numpy and the meshless
    kernel session, dtypes included; every kernel launch of the kernel run is recorded and
    held against its plain version; the launches are the
    ``rank_engine`` path's. (b) RANK_ENGINE_RANKS gloo ranks sharing the
    card, ROWS / RANK_ENGINE_RANKS rows each: their memory after
    registering beside the meshless session's, their answers against (a)'s,
    each expression's wall beside the one-process RANK_ENGINE_SHARDS-shard
    mesh's and phase 9's 8-shard one (``sweep``) — the cost of
    distribution on one card, not a speed-up."""
    import torch

    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import (close_rank_mesh, init_rank_mesh,
                                         make_local_mesh)

    t_phase = time.perf_counter()
    out: dict = {}
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    flat = Session(mode="kernel", device=dev)
    for name in ("data", "data_r"):
        flat.create_dataset(name, table, dataverse="bench")
    torch.cuda.synchronize()
    out["meshless_bytes"] = torch.cuda.memory_allocated() - base
    want = _engine_answers(flat, ROUNDS)
    del flat
    local = _mesh_sessions(table, make_local_mesh(RANK_ENGINE_SHARDS, device=dev),
                           ("kernel",))["kernel"]
    out["mesh_walls_ms"] = _engine_walls(local)
    del local
    torch.cuda.empty_cache()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rank_engine_")
    try:
        mesh = init_rank_mesh(1, 1, None, rank=0, world_size=1, local_rank=0,
                              init_method=_file_init(tmp))
        try:
            for m, rounds in RANK_ENGINE_MODES.items():
                sess = _mesh_sessions(table, mesh, (m,))[m]
                calls: list = []
                _build.reset_launches()
                with recording(calls):
                    got = _engine_answers(sess, rounds)
                torch.cuda.synchronize()
                launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
                for key, g in got.items():
                    name, r = key.split(":")
                    if g != want[key]:
                        raise AssertionError(f"phase 16 (a) {key}[{m}]: rank "
                                             f"mesh {g} != meshless {want[key]}")
                    if g != _answer(oracle_round(raw, name, int(r))):
                        raise AssertionError(f"phase 16 (a) {key}[{m}]: {g} != "
                                             "numpy")
                print(f"  (a) [{m}] one-rank nccl group, {ROWS:,} rows: 12 "
                      f"expressions x {rounds} == meshless == numpy, dtypes "
                      f"included; launches {launches}", flush=True)
                if m == "shard_map":
                    if any(launches.values()):
                        raise AssertionError(f"phase 16 (a): shard_map launched "
                                             f"kernels: {launches}")
                    continue
                out["launches"] = launches
                missing = [k for k in RANK_ENGINE_KERNELS if not launches[k]]
                if missing:
                    raise AssertionError(f"phase 16 (a): {missing} never launched "
                                         "on the rank engine path")
                check_recorded(calls, "phase 16 (a) (one rank)", MESH_KERNELS)
                del sess, calls
        finally:
            close_rank_mesh()
        torch.cuda.empty_cache()
        run_dir = tempfile.mkdtemp(dir=tmp)
        t0 = time.perf_counter()
        _spawn_ranks(_rank_16b, RANK_ENGINE_RANKS, run_dir, RANK_ENGINE_TIMEOUT,
                     seed)
        ranks = [json.loads(Path(run_dir, f"rank{r}.json").read_text())
                 for r in range(RANK_ENGINE_RANKS)]
        out["b_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rps = -(-ROWS // RANK_ENGINE_RANKS)
    for x in ranks:
        if x["rows"] != rps:
            raise AssertionError(f"phase 16 (b): rank {x['rank']} holds "
                                 f"{x['rows']} rows, not {rps}")
        bad = [k for k, v in x["answers"].items() if v != want[k]]
        if bad:
            raise AssertionError(f"phase 16 (b): rank {x['rank']} differs from "
                                 f"(a) on {bad}")
        if not all(x["launches"][k] for k in RANK_ENGINE_KERNELS):
            raise AssertionError(f"phase 16 (b): rank {x['rank']} launches "
                                 f"{x['launches']}")
        print(f"  (b) [{card}] rank {x['rank']}: {x['rows']:,} rows of each "
              f"column, {x['held_bytes'] / 2**30:.3f} GiB allocated after "
              f"registering (meshless session: {out['meshless_bytes'] / 2**30:.3f}"
              f" GiB), placed in {x['placed_s']:.2f} s; 12 expressions x "
              f"{ROUNDS} == (a); launches {x['launches']}", flush=True)
    walls = {name: statistics.median(x["walls_ms"][name] for x in ranks)
             for name in EXPRESSIONS}
    s8 = (sweep or {}).get(MESH_SHARDS, {})
    for name in EXPRESSIONS:
        p9 = s8.get(name, {}).get("wall_ms")
        print(f"  (b) [{card}] {name:16s} {RANK_ENGINE_RANKS} gloo ranks "
              f"{walls[name]:9.3f} ms   one process, {RANK_ENGINE_SHARDS} shards "
              f"{out['mesh_walls_ms'][name]:9.3f} ms   phase 9, {MESH_SHARDS} "
              f"shards " + ("not measured" if p9 is None else f"{p9:9.3f} ms"),
              flush=True)
    print("  (b) walls: median of 7 host-clock runs per rank, the ranks' median; "
          "the cost of distribution on one card (four processes share it, gloo "
          "stages every collective through the host), not a speed-up", flush=True)
    out["ranks"] = [{k: v for k, v in x.items() if k != "answers"} for x in ranks]
    out["rank_walls_ms"] = walls
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  [{card}] phase 16 in {out['seconds']:.1f} s", flush=True)
    return out


def rank_engine_main(seed: int) -> int:
    """``--rank-engine``: phase 16 alone, its kernels built first. Under
    ``torchrun`` (``WORLD_SIZE`` above 1) it runs 16(b)'s body instead on
    one rank a card over NCCL: each rank's answers against numpy and a
    meshless kernel session on its own card; rank 0 prints the summary."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    _build.lib()
    card = nvidia_smi()
    table = wisconsin.generate(ROWS, seed=seed)
    raw = {k: v.numpy() for k, v in table.columns.items()}
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        dev = torch.device("cuda", 0)
        out = run_rank_engine(table, raw, dev, seed, card, None)
        print(json.dumps({"rank_engine": out}))
        return 0
    from repro_torch.engine.session import Session
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    mesh = init_rank_mesh(world, 1, None)
    try:
        x = _rank_engine_body(mesh, table)   # alone on the card: its bytes
        flat = Session(mode="kernel", device=mesh.device)
        for name in ("data", "data_r"):
            flat.create_dataset(name, table, dataverse="bench")
        want = _engine_answers(flat, ROUNDS)
        bad = [k for k, v in x["answers"].items() if v != want[k]]
        for k, v in x["answers"].items():
            name, r = k.split(":")
            if v != _answer(oracle_round(raw, name, int(r))):
                bad.append(f"{k} vs numpy")
        if bad or x["rows"] != -(-ROWS // world) \
                or not all(x["launches"][k] for k in RANK_ENGINE_KERNELS):
            raise AssertionError(f"rank {mesh.rank}: {bad}, rows {x['rows']}, "
                                 f"launches {x['launches']}")
        every = [None] * world
        torch.distributed.all_gather_object(
            every, {k: v for k, v in x.items() if k != "answers"})
        if mesh.rank == 0:
            for y in every:
                print(f"  [{torch.cuda.get_device_name(y['rank'] % torch.cuda.device_count())}"
                      f"] rank {y['rank']}: {y['rows']:,} rows, "
                      f"{y['held_bytes'] / 2**30:.3f} GiB after registering, "
                      f"launches {y['launches']}", flush=True)
            walls = {n: statistics.median(y["walls_ms"][n] for y in every)
                     for n in EXPRESSIONS}
            for n, w in walls.items():
                print(f"  {n:16s} {world} nccl ranks, one a card {w:9.3f} ms",
                      flush=True)
            print(nvidia_smi(every=True))
            print(json.dumps({"rank_engine_nccl": {
                "world": world, "answers_equal": True, "ranks": every,
                "walls_ms": walls}}))
    finally:
        close_rank_mesh()
    return 0


RANK_LIVE_RANKS = 4         # 17(b): gloo ranks sharing the card
RANK_LIVE_TIMEOUT = 420     # s: 17(b)'s four processes, their start included
RANK_LIVE_QUERIES = DURABLE_QUERIES   # tests/test_lsm.py's suite, e3, e4, e8, e9, e11, e12
RANK_LIVE_KERNELS = ("filter_count", "segment_agg", "block_topk",
                     "merge_join_count")
RANK_LIVE_VIEW = "by_ten"


def _view_plan():
    from repro_torch.core import plan as P

    return P.GroupAgg(P.Scan("Live", "live"), ["ten"], [
        P.AggSpec("count", "count", None), P.AggSpec("sum_four", "sum", "four"),
        P.AggSpec("max_onePercent", "max", "onePercent")])


def _live_state(sess, keys: list) -> dict:
    """One state of the live scenario on ``sess``: RANK_LIVE_QUERIES'
    answers, point lookups of ``keys``, and the view against its
    recompute (raises if they differ)."""
    from repro_torch.core.frame import AFrame

    df, dim = AFrame("live", "Live", session=sess), AFrame("live", "Dim", session=sess)
    out = {name: _answer(fn(df, dim)) for name, fn in RANK_LIVE_QUERIES.items()}
    for k in keys:
        row = df.get(int(k))
        out[f"get {k}"] = None if row is None else _answer(row)
    view = sess.read_view(RANK_LIVE_VIEW)
    same(view, sess.execute(_view_plan()), "phase 17: the view vs its recompute")
    out["view"] = _answer(view)
    return out


def _persisted(sess) -> dict:
    """``persist`` of a filter over the nine components, then queries over
    the new dataset."""
    from repro_torch.core.frame import AFrame

    df = AFrame("live", "Live", session=sess)
    p = df[(df["ten"] == 3) & (df["two"] == 1)].persist("P3", dataverse="live")
    return {"len": len(p), "group": _answer(p.groupby("twenty").agg("count")),
            "max": _answer(p["unique1"].max()),
            "rows": _answer(p.sort_values("unique2").head(6))}


def _component_rows(sess) -> list:
    """Each component's rows this process holds of each column, and their
    devices."""
    return [{"name": c.name, "global_rows": c.table.global_rows,
             "held": sorted({int(v.shape[0]) for v in c.table.columns.values()}),
             "devices": sorted({str(v.device) for v in c.table.columns.values()})}
            for c in sess.catalog.components("live", "Live")]


def live_scenario(sess, table, seed: int, oracle_states: list | None = None) -> dict:
    """Phase 6's scenario on ``sess`` (meshless, or a rank mesh): the table
    closed, clustered by unique2, onePercent indexed, Dim, the group-by
    view, LIVE_MIX's eight batches (one flush each, compaction deferred:
    nine components), a persist, then the full compaction. Returns each
    state's answers (``_live_state``), the persisted answers, the walls,
    the bytes allocated after the flushes and after the compaction, the
    peak during the compaction and the components' rows.
    ``oracle_states`` gets the numpy oracle's columns of each state."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed

    import gc

    rng = np.random.default_rng(seed)
    gc.collect()   # earlier phases' garbage, freed mid-scenario, would skew the bytes
    torch.cuda.synchronize()
    base_bytes = torch.cuda.memory_allocated()
    sess.create_dataset("Live", table, dataverse="live", closed=True,
                        primary="unique2", indexes=["onePercent"])
    sess.create_dataset("Dim", wisconsin.generate(LIVE_DIM_ROWS, seed=7),
                        dataverse="live")
    sess.create_view(RANK_LIVE_VIEW, _view_plan())
    feed = Feed(sess, "Live", "live", flush_rows=LIVE_BATCH,
                policy=lsm.CompactionPolicy(size_ratio=10.0, max_runs=64))
    oracle = LiveOracle({k: v.numpy() for k, v in table.columns.items()})
    next_key, walls, keys = ROWS, [], [3, ROWS + 7, -5]
    for i, kind in enumerate(LIVE_MIX):
        batch = _live_batch(kind, i, rng, oracle, next_key)
        if kind == "push":
            next_key += LIVE_BATCH
        keys.append(int((batch if kind == "delete" else batch["unique2"])[0]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        getattr(feed, kind)(batch)
        feed.flush()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        oracle.apply(kind, batch)
        if i == 2:   # base and three runs with matter: the kernel join
            joined = _union_join(sess)
    out = {"flush_s": walls, "join4": joined, "components": len(sess.catalog.components("live", "Live")),
           "bytes_flushed": torch.cuda.memory_allocated() - base_bytes,
           "rows_flushed": _component_rows(sess), "keys": keys}
    if oracle_states is not None:
        oracle_states.append(dict(oracle.cols))
    out["nine"] = _live_state(sess, keys)
    out["persist"] = _persisted(sess)
    sess.catalog.drop("live", "P3")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feed.compact()
    torch.cuda.synchronize()
    out["compact_s"] = time.perf_counter() - t0
    out["peak_compaction"] = torch.cuda.max_memory_allocated() - base_bytes
    out["bytes_compacted"] = torch.cuda.memory_allocated() - base_bytes
    out["rows_compacted"] = _component_rows(sess)
    oracle.compact()
    if oracle_states is not None:
        oracle_states.append(dict(oracle.cols))
    out["one"] = _live_state(sess, keys)
    return out


def _rank_17b(rank: int, world: int, init: str, out: str, seed: int) -> None:
    """17(b)'s rank: one of RANK_LIVE_RANKS gloo ranks on the one card,
    phase 6's scenario on a kernel session holding its own rows of every
    component; what it saw to ``out``."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.engine.session import Session
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    torch.cuda.set_device(0)
    mesh = init_rank_mesh(world, 1, None, rank=rank, world_size=world,
                          local_rank=0, init_method=init, backend="gloo")
    try:
        got = live_scenario(Session(mode="kernel", mesh=mesh),
                            wisconsin.generate(ROWS, seed=seed), seed)
        got["rank"] = mesh.rank
        Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    finally:
        close_rank_mesh()


def _answers(x: dict) -> dict:
    return {k: x[k] for k in ("nine", "one", "persist", "join4")}


def _union_join(sess) -> int:
    """The join count with base ∪ three runs on the left, each holding
    matter (as phase 6's ``join_over_union``): the planner takes
    merge_join_count over the union stream."""
    from repro_torch.core import physical as PH
    from repro_torch.core.frame import AFrame

    n = LIVE_QUERIES["join_count"](AFrame("live", "Live", session=sess),
                                   AFrame("live", "Dim", session=sess))
    plan = sess.last_physical
    if not (isinstance(plan, PH.JoinCountOp) and plan.kernel
            and isinstance(plan.children[0], PH.PrunedUnionRuns)):
        raise AssertionError(f"phase 17: the join over 4 components: "
                             f"{PH.format_plan(plan)}")
    return n


def run_rank_live(table, raw: dict, dev, seed: int, card: str,
                  phase6: dict | None) -> dict:
    """Phase 17: the live engine across processes, each rank holding only
    its own rows of every component. (a) A meshless kernel session, then a
    kernel session on a one-rank NCCL group, run phase 6's scenario
    (``live_scenario``); over nine components and after the compaction
    the rank session's answers, point lookups and view equal the meshless
    session's (dtypes included) and RANK_LIVE_QUERIES' equal phase 6's
    numpy oracle; its persisted answers equal the meshless ones. Its
    launches (zeroed before it, read after it) are the ``rank_live``
    path's; every call is recorded and held against its plain version.
    (b) RANK_LIVE_RANKS gloo ranks sharing the card run the scenario: each
    rank's bytes after the flushes and the compaction beside the
    meshless session's, its peak in the compaction, its answers against
    (a)'s, its flush and compaction walls beside (a)'s and phase 6's.
    (b)'s processes start with the phase and run beside (a)."""
    import torch

    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    t_phase = time.perf_counter()
    out: dict = {}
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rank_live_")
    # (b)'s processes start first and run beside (a): the phase's time is
    # the longer of the two, not their sum (the script's time limit)
    run_dir = tempfile.mkdtemp(dir=tmp)
    ranks_b = _start_ranks(_rank_17b, RANK_LIVE_RANKS, run_dir, seed)
    try:
        states: list = []
        t0 = time.perf_counter()
        flat = live_scenario(Session(mode="kernel", device=dev), table, seed,
                             states)
        out["a_meshless_s"] = time.perf_counter() - t0
        dim_u1 = raw_dim_unique1()
        for state, cols in zip(("nine", "one"), states):
            want = durable_oracle(cols, dim_u1)
            for name in RANK_LIVE_QUERIES:
                if flat[state][name] != _answer(want[name]):
                    raise AssertionError(f"phase 17 (a) meshless {name} "
                                         f"{state} != numpy")
        del states
        torch.cuda.empty_cache()
        mesh = init_rank_mesh(1, 1, None, rank=0, world_size=1, local_rank=0,
                              init_method=_file_init(tmp))
        try:
            calls: list = []
            t0 = time.perf_counter()
            _build.reset_launches()
            with recording(calls):
                got = live_scenario(Session(mode="kernel", mesh=mesh), table, seed)
            torch.cuda.synchronize()
            out["a_rank_s"] = time.perf_counter() - t0
            launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
        finally:
            close_rank_mesh()
        bad = [k for k, v in _answers(got).items() if v != _answers(flat)[k]]
        if bad:
            for k in bad:
                diff = [q for q in got[k] if got[k][q] != flat[k][q]] \
                    if isinstance(got[k], dict) else k
                print(f"  phase 17 (a): {k} differs on {diff}", flush=True)
            raise AssertionError(f"phase 17 (a): the one-rank session differs "
                                 f"from the meshless one on {bad}")
        for rows in (got["rows_flushed"], got["rows_compacted"]):
            for c in rows:
                if c["devices"] != [str(dev)] or c["held"] != [c["global_rows"]]:
                    raise AssertionError(f"phase 17 (a): {c}")
        missing = [k for k in RANK_LIVE_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"phase 17 (a): {missing} never launched on "
                                 "the rank live path")
        out["launches"] = launches
        print(f"  (a) one-rank nccl group, {ROWS:,} rows + {len(LIVE_MIX)} "
              f"batches ({got['components']} components), then the compaction: "
              f"{len(RANK_LIVE_QUERIES)} queries, {len(got['keys'])} point "
              f"lookups and the view == meshless (dtypes included) == numpy; "
              f"persist == meshless; launches {launches}", flush=True)
        check_recorded(calls, "phase 17 (a) (one rank)", MESH_KERNELS)
        del calls
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _join_ranks(ranks_b, _rank_17b,
                    max(RANK_LIVE_TIMEOUT - (t0 - t_phase), 1.0))
        ranks = [json.loads(Path(run_dir, f"rank{r}.json").read_text())
                 for r in range(RANK_LIVE_RANKS)]
        out["b_wait_s"] = time.perf_counter() - t0
    finally:
        for p in ranks_b.processes:   # (a) failed: (b) is not waited for
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
    p6 = (phase6 or {}).get("flushes")
    for x in ranks:
        bad = [k for k, v in _answers(x).items() if v != _answers(got)[k]]
        if bad:
            raise AssertionError(f"phase 17 (b): rank {x['rank']} differs from "
                                 f"(a) on {bad}")
        for rows in (x["rows_flushed"], x["rows_compacted"]):
            for c in rows:
                rps = -(-c["global_rows"] // RANK_LIVE_RANKS)
                if c["held"] != [rps] or c["devices"] != [str(dev)]:
                    raise AssertionError(f"phase 17 (b) rank {x['rank']}: {c}")
        print(f"  (b) [{card}] rank {x['rank']}: {x['bytes_flushed'] / 2**30:.3f} "
              f"GiB after the flushes (meshless {flat['bytes_flushed'] / 2**30:.3f}),"
              f" {x['bytes_compacted'] / 2**30:.3f} GiB after the compaction "
              f"(meshless {flat['bytes_compacted'] / 2**30:.3f}), peak in the "
              f"compaction {x['peak_compaction'] / 2**30:.3f} GiB (meshless "
              f"{flat['peak_compaction'] / 2**30:.3f}); answers == (a); each "
              f"component's ceil(rows / {RANK_LIVE_RANKS}) rows on {dev}",
              flush=True)
    for i, kind in enumerate(LIVE_MIX):
        b = statistics.median(x["flush_s"][i] for x in ranks)
        p = "not measured" if not p6 else f"{p6[i]['wall_s']:.3f} s"
        print(f"  [{card}] batch {i + 1} ({kind}): {RANK_LIVE_RANKS} gloo ranks "
              f"{b:.3f} s   one nccl rank {got['flush_s'][i]:.3f} s   meshless "
              f"{flat['flush_s'][i]:.3f} s   phase 6 {p}", flush=True)
    b = statistics.median(x["compact_s"] for x in ranks)
    p = "not measured" if not phase6 else f"{phase6['compact_s']:.3f} s"
    print(f"  [{card}] compaction: {RANK_LIVE_RANKS} gloo ranks {b:.3f} s   one "
          f"nccl rank {got['compact_s']:.3f} s   meshless {flat['compact_s']:.3f} s"
          f"   phase 6 {p}", flush=True)
    print("  (b) walls: host clock per rank, the ranks' median; the cost of "
          "distribution on one card (four processes share it, gloo stages "
          "every collective through the host), not a speed-up; (a) and (b) "
          "run side by side, so each wall here shares the card and the host "
          "with the other part's work", flush=True)
    keep = ("flush_s", "compact_s", "bytes_flushed", "bytes_compacted",
            "peak_compaction", "components")
    out["meshless"] = {k: flat[k] for k in keep}
    out["one_rank"] = {k: got[k] for k in keep}
    out["ranks"] = [dict({k: x[k] for k in keep}, rank=x["rank"]) for x in ranks]
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  [{card}] phase 17 in {out['seconds']:.1f} s: (a) the meshless "
          f"scenario {out['a_meshless_s']:.1f} s, the one-rank one "
          f"{out['a_rank_s']:.1f} s; (b), started with (a), done "
          f"{out['b_wait_s']:.1f} s after it", flush=True)
    return out


def raw_dim_unique1() -> np.ndarray:
    from repro_torch.data import wisconsin

    return wisconsin.generate(LIVE_DIM_ROWS, seed=7).columns["unique1"].numpy()


def rank_live_main(seed: int) -> int:
    """``--rank-live``: phase 17 alone, its kernels built first. Under
    ``torchrun`` (``WORLD_SIZE`` above 1) it runs 17(b)'s scenario instead
    on one rank a card over NCCL: every rank's answers against numpy on
    rank 0; rank 0 prints the summary."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    _build.lib()
    card = nvidia_smi()
    table = wisconsin.generate(ROWS, seed=seed)
    raw = {k: v.numpy() for k, v in table.columns.items()}
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        out = run_rank_live(table, raw, torch.device("cuda", 0), seed, card, None)
        print(json.dumps({"rank_live": out}))
        return 0
    from repro_torch.engine.session import Session
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    mesh = init_rank_mesh(world, 1, None)
    try:
        states: list = []
        x = live_scenario(Session(mode="kernel", mesh=mesh), table, seed,
                          states if mesh.rank == 0 else None)
        every = [None] * world
        torch.distributed.all_gather_object(every, x)
        if mesh.rank == 0:
            dim_u1 = raw_dim_unique1()
            for state, cols in zip(("nine", "one"), states):
                want = durable_oracle(cols, dim_u1)
                for y in every:
                    bad = [n for n in RANK_LIVE_QUERIES
                           if y[state][n] != _answer(want[n])]
                    if bad or _answers(y) != _answers(every[0]):
                        raise AssertionError(f"{state}: {bad}")
            for r, y in enumerate(every):
                print(f"  [{torch.cuda.get_device_name(r % torch.cuda.device_count())}]"
                      f" rank {r}: {y['bytes_flushed'] / 2**30:.3f} GiB after the "
                      f"flushes, {y['bytes_compacted'] / 2**30:.3f} after the "
                      f"compaction, peak {y['peak_compaction'] / 2**30:.3f}; "
                      f"flushes {[round(s, 3) for s in y['flush_s']]} s, compaction "
                      f"{y['compact_s']:.3f} s", flush=True)
            print(nvidia_smi(every=True))
            print(json.dumps({"rank_live_nccl": {
                "world": world, "answers_equal_numpy": True,
                "ranks": [{k: y[k] for k in ("flush_s", "compact_s",
                                             "bytes_flushed", "bytes_compacted",
                                             "peak_compaction")}
                          for y in every]}}))
    finally:
        close_rank_mesh()
    return 0


# -- phase 18: the durable store across processes (torch.distributed ranks) ----

RANK_DURABLE_RANKS = 4      # 18(b): gloo ranks sharing the card
RANK_DURABLE_TIMEOUT = 420  # s: 18(b)'s four processes, their start included
RANK_DURABLE_KERNELS = ("filter_count", "segment_agg", "topk_merge",
                        "merge_join_count")
RANK_DURABLE_CHECKED = ("3_filter_count", "4_group_count")   # 18(b)'s reopens
SHM = "/dev/shm"


def _store_dir(prefix: str) -> str:
    """A fresh directory for the phase's stores: in RAM (``/dev/shm``)
    where there is one, so the phase times the store's work rather than
    the machine's disk."""
    return tempfile.mkdtemp(prefix=prefix,
                            dir=SHM if os.path.isdir(SHM) else None)


def _durable_state(sess, keys: list) -> dict:
    """DURABLE_QUERIES' answers on ``sess`` and point lookups of ``keys``."""
    from repro_torch.core.frame import AFrame

    df, dim = AFrame("live", "Live", session=sess), AFrame("live", "Dim", session=sess)
    out = {name: _answer(fn(df, dim)) for name, fn in DURABLE_QUERIES.items()}
    for k in keys:
        row = df.get(int(k))
        out[f"get {k}"] = None if row is None else _answer(row)
    return out


def _held(sess, dev, shards: int) -> list:
    """Each component's rows this process holds of each column (all on
    ``dev``), failing where a column holds more than ceil(rows /
    ``shards``)."""
    out = []
    for c in sess.catalog.components("live", "Live"):
        held = sorted({int(v.shape[0]) for v in c.table.columns.values()})
        devs = sorted({str(v.device) for v in c.table.columns.values()})
        if held != [-(-c.table.global_rows // shards)] or devs != [str(dev)]:
            raise AssertionError(f"phase 18: {c.name} holds {held} rows on "
                                 f"{devs} of {c.table.global_rows}")
        out.append(held[0])
    return out


def _timed_open(open_fn) -> tuple:
    """``open_fn()`` with its wall, the card bytes it left and its peak
    (both above what was allocated before it)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sess = open_fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sess, {"open_s": wall, "report_s": sess.recovery_report["seconds"],
                  "replayed": sess.recovery_report["wal_replayed_batches"],
                  "fallbacks": sum(d["manifest_fallbacks"] for d in
                                   sess.recovery_report["datasets"].values()),
                  "bytes": torch.cuda.memory_allocated() - base,
                  "peak": torch.cuda.max_memory_allocated() - base}


def durable_scenario(make, reopen, dev, shards: int, table, seed: int,
                     oracle_states: list | None = None) -> dict:
    """Phase 8's scenario through ``make(storage=...)`` (a meshless kernel
    session, or one on a rank mesh): the table closed, clustered by
    unique2, onePercent indexed, Dim, LIVE_MIX's eight batches (one flush
    each), DURABLE_TAIL acked into the WAL, the close; a lazy open (the
    tail replays into a tenth component) and its answers; the compaction,
    the close, a lazy open and its answers. ``reopen(d)`` opens the store
    lazily on the same mesh. Returns the answers, each ack's and flush's
    wall with the segment bytes the flush wrote, each open's wall, report,
    card bytes and peak. ``oracle_states`` gets the numpy oracle's columns
    of each open's state."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.runtime import telemetry as tel

    d = Path(_store_dir("chip_smoke_rank_durable_"))
    seg = lambda: tel.counter_value("storage.segment_bytes_written_total") or 0
    policy = lsm.CompactionPolicy(size_ratio=10.0, max_runs=64)
    try:
        sess = make(storage=str(d))
        w0 = seg()
        t0 = time.perf_counter()
        sess.create_dataset("Live", table, dataverse="live", closed=True,
                            primary="unique2", indexes=["onePercent"])
        sess.create_dataset("Dim", wisconsin.generate(LIVE_DIM_ROWS, seed=7),
                            dataverse="live")
        torch.cuda.synchronize()
        out = {"create_s": time.perf_counter() - t0, "create_bytes": seg() - w0,
               "acks": [], "flushes": [], "opens": []}
        feed = Feed(sess, "Live", "live", flush_rows=10**9, policy=policy)
        oracle = LiveOracle({k: v.numpy() for k, v in table.columns.items()})
        rng = np.random.default_rng(seed)
        next_key, keys = ROWS, [3, ROWS + 7, -5]
        for i, kind in enumerate(LIVE_MIX + DURABLE_TAIL):
            batch = _live_batch(kind, i, rng, oracle, next_key)
            if kind == "push":
                next_key += LIVE_BATCH
            keys.append(int((batch if kind == "delete" else batch["unique2"])[0]))
            t0 = time.perf_counter()
            getattr(feed, kind)(batch)
            out["acks"].append(time.perf_counter() - t0)
            oracle.apply(kind, batch)
            if i < len(LIVE_MIX):
                w = seg()
                t0 = time.perf_counter()
                feed.flush()
                torch.cuda.synchronize()
                out["flushes"].append({"wall_s": time.perf_counter() - t0,
                                       "segment_bytes": seg() - w})
        sess.close()
        del sess, feed
        out["keys"] = keys
        for state in ("ten", "compacted"):
            re, row = _timed_open(lambda: reopen(d))
            row["held"] = _held(re, dev, shards)
            if oracle_states is not None:
                oracle_states.append(dict(oracle.cols))
            out[state] = _durable_state(re, keys)
            out["opens"].append(row)
            if state == "ten":
                w = seg()
                t0 = time.perf_counter()
                Feed(re, "Live", "live", flush_rows=10**9, policy=policy).compact()
                torch.cuda.synchronize()
                out["compact_s"] = time.perf_counter() - t0
                out["compact_bytes"] = seg() - w
                oracle.compact()
            re.close()
            del re
        out["components"] = [o["held"] for o in out["opens"]]
        return out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _crash_batches(seed: int, raw: dict) -> list:
    """Phase 8's crash batches: LIVE_MIX's first CRASH_BATCHES over the
    CRASH_ROWS-row base."""
    gen = LiveOracle(raw)
    rng = np.random.default_rng(seed + 1)
    batches, next_key = [], CRASH_ROWS
    for i, kind in enumerate(LIVE_MIX[:CRASH_BATCHES]):
        batches.append((kind, _live_batch(kind, i, rng, gen, next_key)))
        gen.apply(*batches[-1])
        next_key += LIVE_BATCH if kind == "push" else 0
    return batches


def _digest(cols: dict) -> str:
    """A hash of a table's visible rows (clustered by unique2): every
    column's dtype, shape and bytes."""
    import hashlib

    h = hashlib.sha256()
    for k in sorted(cols):
        v = np.ascontiguousarray(cols[k])
        h.update(f"{k}:{v.dtype.str}:{v.shape}".encode())
        h.update(v.tobytes())
    return h.hexdigest()


def rank_crash_matrix(mesh, dev, seed: int, root: Path) -> dict:
    """18(b)'s body on ``mesh`` (the ranks share ``root``): for each of
    IO_FAULT_POINTS, the CRASH_ROWS-row base stored, the fault armed on
    every rank (the writer's I/O fires it; every rank raises at the same
    call), phase 8's four batches (two flushed) until it fires, the close,
    and a lazy reopen (after a reopen that mid-replay kills): the visible
    rows equal a memory-only session on the ranks of exactly the acked
    batches, and e3 / e4 equal numpy. Each reopen's wall, report, card
    bytes and peak. The stores stay in ``root`` (the parent opens one
    without a mesh)."""
    import gc

    import torch

    from repro_torch.core.frame import AFrame
    from repro_torch.data import wisconsin
    from repro_torch.engine import lsm
    from repro_torch.engine.ingest import Feed
    from repro_torch.engine.session import Session
    from repro_torch.runtime.fault import IO_FAULT_POINTS, FaultPlan, StorageFault

    table = wisconsin.generate(CRASH_ROWS, seed=seed)
    raw = {k: v.numpy() for k, v in table.columns.items()}
    batches = _crash_batches(seed, raw)
    policy = lsm.CompactionPolicy(size_ratio=10.0, max_runs=64)
    shards = mesh.extent(("data",))
    memory: dict = {}

    def create(sess):
        sess.create_dataset("Live", table, dataverse="live", closed=True,
                            primary="unique2", indexes=["onePercent"])

    def acked_rows(n: int) -> str:
        """A memory-only session on the ranks that applied the first n
        batches (one flush): its rows' digest; numpy agrees."""
        if n not in memory:
            sess = Session(mode="kernel", mesh=mesh)
            create(sess)
            f = Feed(sess, "Live", "live", flush_rows=10**9, policy=policy)
            want = LiveOracle(raw)
            for kind, batch in batches[:n]:
                getattr(f, kind)(batch)
                want.apply(kind, batch)
            f.flush()
            got = _by_key(AFrame("live", "Live", session=sess).collect())
            if _digest(got) != _digest(_by_key(want.cols)):
                raise AssertionError(f"phase 18 (b): the memory-only session "
                                     f"of {n} batches != numpy")
            memory[n] = (_digest(got), want)
            del sess, f
            gc.collect()
        return memory[n]

    out = {"rank": mesh.rank, "crash": {}}
    for point in IO_FAULT_POINTS:
        d = root / f"crash-{point}"
        sess = Session(mode="kernel", mesh=mesh, storage=str(d))
        create(sess)
        sess.fault_plan = FaultPlan.once(point)
        f = Feed(sess, "Live", "live", flush_rows=10**9, policy=policy)
        acked, crashed, acks = 0, False, []
        try:
            for i, (kind, batch) in enumerate(batches):
                t0 = time.perf_counter()
                getattr(f, kind)(batch)
                acks.append(time.perf_counter() - t0)
                acked += 1
                if i < CRASH_FLUSHED:
                    f.flush()
        except StorageFault:
            crashed = True
        sess.close()
        del sess, f
        if point == "mid-replay":
            try:
                Session.open(str(d), mode="kernel", mesh=mesh,
                             fault_plan=FaultPlan.once(point))
            except StorageFault:
                crashed = True
            else:
                raise AssertionError("phase 18 (b): mid-replay never fired")
        if not crashed:
            raise AssertionError(f"phase 18 (b): {point} never fired")
        re, row = _timed_open(lambda: Session.open(str(d), mode="kernel",
                                                   mesh=mesh))
        row["held"] = _held(re, dev, shards)
        got = _by_key(AFrame("live", "Live", session=re).collect())
        digest, want = acked_rows(acked)
        if _digest(got) != digest:
            raise AssertionError(f"phase 18 (b) crash at {point}: the reopened "
                                 f"rows != the memory-only session's")
        w = live_oracle(want.cols, raw_dim_unique1())
        df = AFrame("live", "Live", session=re)
        for name in RANK_DURABLE_CHECKED:
            if _answer(LIVE_QUERIES[name](df, None)) != _answer(w[name]):
                raise AssertionError(f"phase 18 (b) crash at {point}: {name}")
        row.update(acked=acked, acks=acks, digest=digest,
                   rows=len(got["unique2"]))
        out["crash"][point] = row
        re.close()
        del re
    return out


def _rank_18b(rank: int, world: int, init: str, out: str, seed: int,
              root: str) -> None:
    """18(b)'s rank: one of RANK_DURABLE_RANKS gloo ranks on the one card,
    ``rank_crash_matrix`` over the store directory ``root`` they share;
    what it saw to ``out``."""
    import torch

    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    torch.cuda.set_device(0)
    mesh = init_rank_mesh(world, 1, None, rank=rank, world_size=world,
                          local_rank=0, init_method=init, backend="gloo")
    try:
        got = rank_crash_matrix(mesh, torch.device("cuda", 0), seed, Path(root))
        Path(out, f"rank{rank}.json").write_text(json.dumps(got))
    finally:
        close_rank_mesh()


def _durable_answers(x: dict) -> dict:
    return {k: x[k] for k in ("ten", "compacted")}


def run_rank_durable(table, raw: dict, dev, seed: int, card: str,
                     durable: dict | None) -> dict:
    """Phase 18: the durable store across processes, one store the ranks
    share in the format a meshless session writes. (a) A meshless kernel
    session, then a kernel session on a one-rank NCCL group, run phase 8's
    scenario with the store in RAM (``durable_scenario``); after each lazy
    open (the WAL tail replayed; the compaction's) the rank session's
    answers and point lookups equal the meshless session's, dtypes
    included, and DURABLE_QUERIES' equal the numpy oracle. Its launches
    (zeroed before it, read after it) are the ``rank_durable`` path's;
    every call is recorded and held against its plain version. (b)
    RANK_DURABLE_RANKS gloo ranks sharing the card run the crash matrix
    (``rank_crash_matrix``), started with the phase and joined after (a);
    the store they left after the mid-replay crash then opens without a
    mesh on the card with the same rows, its bytes and peak beside each
    rank's. Cut for the script's time limit: (b)'s crash matrix runs at
    phase 8's cut (CRASH_ROWS rows, four batches)."""
    import torch

    from repro_torch.core.catalog import component_nbytes
    from repro_torch.core.frame import AFrame
    from repro_torch.engine.session import Session
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    t_phase = time.perf_counter()
    out: dict = {}
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rank_durable_")
    stores = _store_dir("chip_smoke_rank_durable_b_")
    run_dir = tempfile.mkdtemp(dir=tmp)
    ranks_b = _start_ranks(_rank_18b, RANK_DURABLE_RANKS, run_dir, seed, stores)
    try:
        states: list = []
        t0 = time.perf_counter()
        flat = durable_scenario(
            lambda **kw: Session(mode="kernel", device=dev, **kw),
            lambda d: Session.open(str(d), lazy=True, mode="kernel", device=dev),
            dev, 1, table, seed, states)
        out["a_meshless_s"] = time.perf_counter() - t0
        dim_u1 = raw_dim_unique1()
        for state, cols in zip(("ten", "compacted"), states):
            want = durable_oracle(cols, dim_u1)
            bad = [n for n in DURABLE_QUERIES
                   if flat[state][n] != _answer(want[n])]
            if bad:
                raise AssertionError(f"phase 18 (a) meshless {state}: {bad} "
                                     "!= numpy")
        del states
        torch.cuda.empty_cache()
        mesh = init_rank_mesh(1, 1, None, rank=0, world_size=1, local_rank=0,
                              init_method=_file_init(tmp))
        try:
            calls: list = []
            t0 = time.perf_counter()
            _build.reset_launches()
            with recording(calls):
                got = durable_scenario(
                    lambda **kw: Session(mode="kernel", mesh=mesh, **kw),
                    lambda d: Session.open(str(d), lazy=True, mode="kernel",
                                           mesh=mesh),
                    dev, 1, table, seed)
            torch.cuda.synchronize()
            out["a_rank_s"] = time.perf_counter() - t0
            launches = {k: _build.LAUNCHES[k] for k in RELATIONAL}
        finally:
            close_rank_mesh()
        bad = [k for k, v in _durable_answers(got).items()
               if v != _durable_answers(flat)[k]]
        if bad:
            for k in bad:
                diff = [q for q in got[k] if got[k][q] != flat[k][q]]
                print(f"  phase 18 (a): {k} differs on {diff}", flush=True)
            raise AssertionError(f"phase 18 (a): the one-rank session differs "
                                 f"from the meshless one on {bad}")
        missing = [k for k in RANK_DURABLE_KERNELS if not launches[k]]
        if missing:
            raise AssertionError(f"phase 18 (a): {missing} never launched on "
                                 "the rank durable path")
        out["launches"] = launches
        print(f"  (a) one-rank nccl group, {ROWS:,} rows + {len(LIVE_MIX)} "
              f"batches + {len(DURABLE_TAIL)} in the WAL, the store in "
              f"{SHM if os.path.isdir(SHM) else tempfile.gettempdir()}: after "
              f"the lazy open ({len(got['components'][0])} components) and "
              f"after the compaction, {len(DURABLE_QUERIES)} queries and "
              f"{len(got['keys'])} point lookups == meshless (dtypes "
              f"included) == numpy; launches {launches}", flush=True)
        check_recorded(calls, "phase 18 (a) (one rank)", RANK_DURABLE_KERNELS)
        del calls
        torch.cuda.empty_cache()
        p8 = (durable or {}).get("acks") or []
        for i, kind in enumerate(LIVE_MIX + DURABLE_TAIL):
            p = "not measured" if i >= len(p8) else f"{p8[i]['ack_s'] * 1e3:.1f} ms"
            flush = "left in the WAL" if i >= len(LIVE_MIX) else (
                f"flush with its gathered segment write {got['flushes'][i]['wall_s']:.3f}"
                f" s ({got['flushes'][i]['segment_bytes']:,} bytes), meshless "
                f"{flat['flushes'][i]['wall_s']:.3f} s")
            print(f"  [{card}] batch {i + 1} ({kind}): ack one nccl rank "
                  f"{got['acks'][i] * 1e3:.1f} ms, meshless "
                  f"{flat['acks'][i] * 1e3:.1f} ms, phase 8 {p}; {flush}",
                  flush=True)
        print(f"  [{card}] create (the base's segment gathered and written): "
              f"one nccl rank {got['create_s']:.3f} s, meshless "
              f"{flat['create_s']:.3f} s ({got['create_bytes']:,} segment "
              f"bytes); compaction one nccl rank {got['compact_s']:.3f} s, "
              f"meshless {flat['compact_s']:.3f} s", flush=True)
        for i, state in enumerate(("with the WAL tail", "after the compaction")):
            g, f = got["opens"][i], flat["opens"][i]
            print(f"  [{card}] lazy open {state}: one nccl rank {g['open_s']:.3f} s "
                  f"(recovery_report {g['report_s']:.3f} s, {g['replayed']} "
                  f"replayed, {g['fallbacks']} fallbacks), {g['bytes']:,} card "
                  f"bytes after, peak {g['peak']:,}; meshless {f['open_s']:.3f} s "
                  f"({f['report_s']:.3f} s), {f['bytes']:,} bytes, peak "
                  f"{f['peak']:,}", flush=True)
        t0 = time.perf_counter()
        _join_ranks(ranks_b, _rank_18b,
                    max(RANK_DURABLE_TIMEOUT - (t0 - t_phase), 1.0))
        ranks = [json.loads(Path(run_dir, f"rank{r}.json").read_text())
                 for r in range(RANK_DURABLE_RANKS)]
        out["b_wait_s"] = time.perf_counter() - t0
        # the store the ranks left after the mid-replay crash (replayed at
        # their reopen), opened without a mesh on the card
        re, flat_open = _timed_open(lambda: Session.open(
            str(Path(stores) / "crash-mid-replay"), mode="kernel", device=dev))
        largest = max(component_nbytes(c)
                      for c in re.catalog.components("live", "Live"))
        digest = _digest(_by_key(AFrame("live", "Live", session=re).collect()))
        re.close()
        del re
    finally:
        for p in ranks_b.processes:   # (a) failed: (b) is not waited for
            if p.is_alive():
                p.kill()
            p.join(5)
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(stores, ignore_errors=True)
    for point in ranks[0]["crash"]:
        cases = [x["crash"][point] for x in ranks]
        if len({c["digest"] for c in cases}) != 1 or \
                len({c["acked"] for c in cases}) != 1:
            raise AssertionError(f"phase 18 (b) {point}: the ranks differ")
        c = cases[0]
        print(f"  (b) [{card}] crash at {point}: {c['acked']} batch(es) acked "
              f"on every rank; reopened on {RANK_DURABLE_RANKS} gloo ranks in "
              f"{statistics.median(x['open_s'] for x in cases):.3f} s (median; "
              f"recovery_report {statistics.median(x['report_s'] for x in cases):.3f}"
              f" s, {c['replayed']} replayed), {c['rows']:,} rows == the "
              f"memory-only rank session == numpy ({', '.join(RANK_DURABLE_CHECKED)}); "
              f"each component {c['held']} rows a rank", flush=True)
    mid = [x["crash"]["mid-replay"] for x in ranks]
    if digest != mid[0]["digest"]:
        raise AssertionError("phase 18 (b): the rank-written store opened "
                             "without a mesh differs from the ranks' reopen")
    for x, c in zip(ranks, mid):
        print(f"  (b) [{card}] rank {x['rank']}: {c['bytes']:,} card bytes after "
              f"the lazy reopen, peak during it {c['peak']:,}; acks "
              f"{[round(a * 1e3, 1) for a in c['acks']]} ms", flush=True)
    print(f"  (b) [{card}] the rank-written store opened without a mesh: "
          f"{flat_open['open_s']:.3f} s, {flat_open['bytes']:,} card bytes "
          f"(its largest component {largest:,}), peak {flat_open['peak']:,}; "
          f"rows == the ranks'", flush=True)
    # a rank holds a quarter of each component (``_held``); beyond that, its
    # transients during the open (the replay's run, its gathered segment
    # write in half-shard chunks) stay under one whole component
    over = [x["rank"] for x, c in zip(ranks, mid)
            if c["peak"] >= flat_open["bytes"] or c["peak"] - c["bytes"] >= largest]
    if over:
        raise AssertionError(f"phase 18 (b): ranks {over} held a whole "
                             "component's bytes beyond their shards during "
                             "the open")
    keep = ("acks", "flushes", "opens", "create_s", "compact_s")
    out["meshless"] = {k: flat[k] for k in keep}
    out["one_rank"] = {k: got[k] for k in keep}
    out["ranks"] = ranks
    out["flat_open"] = dict(flat_open, largest_component=largest)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"  [{card}] phase 18 in {out['seconds']:.1f} s: (a) the meshless "
          f"scenario {out['a_meshless_s']:.1f} s, the one-rank one "
          f"{out['a_rank_s']:.1f} s; (b), started with (a), done "
          f"{out['b_wait_s']:.1f} s after it", flush=True)
    return out


def rank_durable_main(seed: int) -> int:
    """``--rank-durable``: phase 18 alone, its kernels built first. Under
    ``torchrun`` (``WORLD_SIZE`` above 1) it runs 18(b)'s crash matrix
    instead on one rank a card over NCCL, the store on the one host:
    every rank's reopened rows equal its memory-only session's and numpy;
    rank 0 prints the summary."""
    import torch

    from repro_torch.data import wisconsin
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    _build.lib()
    card = nvidia_smi()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        table = wisconsin.generate(ROWS, seed=seed)
        raw = {k: v.numpy() for k, v in table.columns.items()}
        out = run_rank_durable(table, raw, torch.device("cuda", 0), seed,
                               card, None)
        print(json.dumps({"rank_durable": out}))
        return 0
    from repro_torch.launch.mesh import (broadcast_object, close_rank_mesh,
                                         init_rank_mesh)

    mesh = init_rank_mesh(world, 1, None)
    root = broadcast_object(mesh, _store_dir("chip_smoke_rank_durable_nccl_")
                            if mesh.rank == 0 else None)
    try:
        x = rank_crash_matrix(mesh, mesh.device, seed, Path(root))
        every = [None] * world
        torch.distributed.all_gather_object(every, x)
        if mesh.rank == 0:
            for point in every[0]["crash"]:
                cases = [y["crash"][point] for y in every]
                if len({c["digest"] for c in cases}) != 1:
                    raise AssertionError(f"{point}: the ranks differ")
                print(f"  crash at {point}: {cases[0]['acked']} acked, "
                      f"{cases[0]['rows']:,} rows on every rank == memory-only "
                      f"== numpy; reopen {[round(c['open_s'], 3) for c in cases]}"
                      f" s, card bytes {[c['bytes'] for c in cases]}, peak "
                      f"{[c['peak'] for c in cases]}", flush=True)
            print(nvidia_smi(every=True))
            print(json.dumps({"rank_durable_nccl": {
                "world": world, "answers_equal_numpy": True,
                "ranks": [y["crash"] for y in every]}}))
        torch.distributed.barrier()
    finally:
        if mesh.rank == 0:
            shutil.rmtree(root, ignore_errors=True)
        close_rank_mesh()
    return 0


# -- phase 19: tensor parallelism over model for rwkv, the hybrid, whisper, vlm --

# (arch, depth): every family at its published width and depth but
# llava-next-mistral-7b, cut to phase 10's 4 of 32 layers (two ranks each
# build the whole seeded model before placing it: 28 GB in float32 at 32)
RANK_TP_FAMILIES = (("zamba2-1.2b", None), ("rwkv6-1.6b", None),
                    ("whisper-base", None), ("llava-next-mistral-7b", 4))
RANK_TP_MODEL = 2           # 19: two gloo ranks sharing the card, data 1 x model 2
RANK_TP_LAYERS = 2          # the train steps' depth
RANK_TP_TIMEOUT = 900       # s: 19's two processes, their start included
RANK_TP_KERNELS = ("flash_mha_fwd", "flash_decode", "flash_attention_bwd")
# the per-rank shape each kernel's timing row takes: (family, kernel, dtype;
# None: the dtype the path launched it in). The train steps run B7 in
# float32 (``_tp_train``); its row at the same shape in bf16 is the
# training path's dtype.
RANK_TP_ROWS = (("zamba2-1.2b", "flash_mha_fwd", None),
                ("llava-next-mistral-7b", "flash_decode", None),
                ("llava-next-mistral-7b", "flash_attention_bwd", None),
                ("llava-next-mistral-7b", "flash_attention_bwd", "torch.bfloat16"))


def _param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


@contextlib.contextmanager
def recording_shapes(shapes: dict, tag: str):
    """The operand shapes of the first call of each attention kernel
    (``flash_mha_fwd``: q, k, causal; ``flash_decode``: q, the cache view,
    its longest length; ``flash_attention_bwd``: q, k, causal), with q's
    dtype, under ``shapes[tag]``."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    got = shapes.setdefault(tag, {})
    real = {"fwd": fa.flash_mha_fwd, "dec": da.flash_decode,
            "bwd": fa.flash_attention_bwd}

    def fwd(q, k, v, *a, **kw):
        got.setdefault("flash_mha_fwd", [list(q.shape), list(k.shape),
                                         kw.get("causal", True), str(q.dtype)])
        return real["fwd"](q, k, v, *a, **kw)

    def dec(q, k, v, lengths):
        got.setdefault("flash_decode", [list(q.shape), list(k.shape),
                                        int(lengths.max()), str(q.dtype)])
        return real["dec"](q, k, v, lengths)

    def bwd(q, k, v, *a, **kw):
        got.setdefault("flash_attention_bwd", [list(q.shape), list(k.shape),
                                               kw.get("causal", True),
                                               str(q.dtype)])
        return real["bwd"](q, k, v, *a, **kw)

    fa.flash_mha_fwd, da.flash_decode, fa.flash_attention_bwd = fwd, dec, bwd
    try:
        yield got
    finally:
        fa.flash_mha_fwd, da.flash_decode = real["fwd"], real["dec"]
        fa.flash_attention_bwd = real["bwd"]


def _tp_reference(arch: str, layers, dev, seed: int) -> dict:
    """The meshless serving run phase 19 holds the ranks to: FAMILY_BATCH x
    FAMILY_PROMPT tokens prefilled, then FAMILY_STEPS greedy decode steps
    (flash), from the seeded weights on ``dev``: the last logits of every
    call, the greedy tokens, the parameter bytes and the wall; and the
    largest difference of those logits from the same run in float32
    compute teacher-forced on its tokens (``f32_gap``: how far bf16
    rounding alone moves them)."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import registry

    cfg = _serve_cfg(arch, "flash", layers)
    model = registry.get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(seed))
    batch = serve.make_batch(cfg, FAMILY_BATCH, FAMILY_PROMPT,
                             np.random.default_rng(seed), dev)
    max_len = registry.prefill_cache_len(cfg, FAMILY_PROMPT) + FAMILY_STEPS + 1
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, toks, _ = _logits_run(cfg, model, batch, max_len, FAMILY_STEPS)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    with float32_compute():
        lg32, _, _ = _logits_run(cfg, model, batch, max_len, FAMILY_STEPS,
                                 toks[:FAMILY_STEPS])
    out = {"logits": logits.float().cpu(), "tokens": toks.cpu(),
           "bytes": _param_bytes(model), "wall_s": wall,
           "f32_gap": float((logits.float() - lg32.float()).abs().max())}
    del model, lg32
    torch.cuda.empty_cache()
    return out


def _tp_serve(mesh, arch: str, layers, seed: int, ref: dict, stats: dict,
              shapes: dict) -> dict:
    """One family served on the rank mesh from the seeded weights, placed:
    the prefill and FAMILY_STEPS decode steps teacher-forced on the
    meshless run's greedy tokens, every flash call held against its plain
    version (``checking_path``); the logits' largest difference from the
    meshless ones over every call (held to :func:`tp_limit`), argmax
    counted where the meshless top-2 margin exceeds that limit. Launches
    counted from just before the run to just after it."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.models.sharding import place_params, sharding_ctx

    dev = mesh.device
    cfg = _serve_cfg(arch, "flash", layers)
    model = registry.get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(seed))
    whole = _param_bytes(model)
    place_params(model, cfg, mesh)
    torch.cuda.empty_cache()
    held = _param_bytes(model)
    batch = serve.make_batch(cfg, FAMILY_BATCH, FAMILY_PROMPT,
                             np.random.default_rng(seed), dev)
    max_len = registry.prefill_cache_len(cfg, FAMILY_PROMPT) + FAMILY_STEPS + 1
    forced = ref["tokens"][:FAMILY_STEPS].to(dev)
    torch.cuda.synchronize(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    with sharding_ctx(mesh), checking_path(stats), recording_shapes(shapes, arch):
        logits, _, _ = _logits_run(cfg, model, batch, max_len, FAMILY_STEPS, forced)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    launches = {k: _build.LAUNCHES[k] for k in RANK_TP_KERNELS}
    want = ref["logits"].to(dev)
    gap = float((logits.float() - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > tp_limit(ref)
    bad = int(((logits.argmax(-1) != want.argmax(-1)) & sure).sum())
    del model, logits
    torch.cuda.empty_cache()
    return {"layers": cfg.n_layers, "whole_bytes": whole, "rank_bytes": held,
            "max_logit_diff": gap, "argmax_differs_beyond_margin": bad,
            "finite": math.isfinite(gap), "wall_s": wall, "launches": launches}


@contextlib.contextmanager
def float32_compute():
    """The models compute in float32 inside the block (``layers.COMPUTE_DTYPE``;
    whisper's encoder stays bf16, as in the reference)."""
    import torch

    from repro_torch.models import layers

    prev = layers.COMPUTE_DTYPE
    layers.COMPUTE_DTYPE = torch.float32
    try:
        yield
    finally:
        layers.COMPUTE_DTYPE = prev


def _tp_train(mesh, arch: str, seed: int, stats: dict, shapes: dict) -> dict:
    """One train step of ``arch`` at its published width, RANK_TP_LAYERS
    layers, FAMILY_BATCH x FAMILY_TRAIN_SEQ tokens (flash, remat), in
    float32 compute: the meshless step's gradients first, then the same
    weights placed and the step on the rank mesh, held to TRAIN_TOL (loss,
    grad norm, every gradient block). Float32, so that the check sees the
    split itself: in bf16 the two steps round every activation at other
    places, and a leaf whose gradient is a sum that mostly cancels (a q
    or k bias, or a head that attends almost uniformly) moves by tens of
    percent of itself (0.2 on the reduced whisper, CPU rehearsal) with
    nothing wrong. Whisper's key biases, whose exact gradient is zero (a
    bias on every key moves a row's scores alike), are rounding noise in
    both steps: their difference is held against the global gradient norm
    (TRAIN_TOL["grad_norm"]). Every B7 call against its plain version
    (``checking_bwd``)."""
    with float32_compute():
        return _tp_train_step(mesh, arch, seed, stats, shapes)


def _tp_train_step(mesh, arch: str, seed: int, stats: dict, shapes: dict) -> dict:
    import dataclasses

    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.models import optim, registry, steps
    from repro_torch.models.sharding import (local_slice, place_params,
                                             placements, sharding_ctx)

    dev = mesh.device
    cfg = dataclasses.replace(_serve_cfg(arch, "flash"), n_layers=RANK_TP_LAYERS)
    batch = serve.make_batch(cfg, FAMILY_BATCH, FAMILY_TRAIN_SEQ,
                             np.random.default_rng(seed), dev)
    step = steps.make_train_step(cfg, optim.OptimConfig(**TRAIN_OPT))
    model = registry.get_api(cfg).init(cfg, torch.Generator(device=dev).manual_seed(seed))
    ref: dict = {}
    with captured_grads(model, ref, update=False):
        _, _, m_ref = step(model, None, batch)
    place_params(model, cfg, mesh)
    pls = placements(model)
    ref = {n: local_slice(g, pls[n].spec, mesh) for n, g in ref.items()}
    noise = tuple(n for n in ref if n.endswith(".bk"))
    diffs: dict = {}
    _build.reset_launches()
    with sharding_ctx(mesh), checking_bwd(stats), recording_shapes(shapes, arch), \
            captured_grads(model, diffs, ref, update=False, noise=noise):
        _, _, m = step(model, None, batch)
    torch.cuda.synchronize(dev)
    launches = {k: _build.LAUNCHES[k] for k in RANK_TP_KERNELS}
    norm = float(m_ref["grad_norm"])
    loud = {n: d for n, d in diffs.items() if n not in noise}
    leaf, worst = _worst(loud)
    quiet = max((float(diffs[n]) / norm for n in noise), default=0.0)
    out = {"loss": _rel(float(m["loss"]), float(m_ref["loss"])),
           "grad_norm": _rel(float(m["grad_norm"]), norm),
           "grads": worst, "worst_leaf": leaf, "key_bias_noise": quiet,
           "launches": launches}
    del model, ref, diffs
    torch.cuda.empty_cache()
    out["ok"] = all(out[k] <= TRAIN_TOL[k] for k in ("loss", "grad_norm", "grads")) \
        and quiet <= TRAIN_TOL["grad_norm"]
    return out


def _rank_tp_body(mesh, seed: int, refs: dict) -> dict:
    """Phase 19 on ``mesh`` (this rank's part): each family of
    RANK_TP_FAMILIES served against ``refs[arch]`` (the meshless run),
    then each family's train step; the launches of B5, B6 and B7 summed
    over the parts, each call's verdict against its plain version, and
    the per-rank shapes of each kernel's first call."""
    stats, bwd, shapes = _path_stats(), {}, {}
    serve_out, train_out = {}, {}
    for arch, layers in RANK_TP_FAMILIES:
        serve_out[arch] = _tp_serve(mesh, arch, layers, seed, refs[arch], stats,
                                    shapes)
    for arch, _ in RANK_TP_FAMILIES:
        bwd_arch: dict = {}
        train_out[arch] = _tp_train(mesh, arch, seed, bwd_arch, shapes)
        bwd[arch] = bwd_arch
    launches = {k: sum(x["launches"][k] for x in (*serve_out.values(),
                                                  *train_out.values()))
                for k in RANK_TP_KERNELS}
    bwd_all = {"calls": sum(b["calls"] for b in bwd.values()),
               "bad": sum(b["bad"] for b in bwd.values()),
               "max_err": max((b["max_err"] for b in bwd.values() if b["calls"]),
                              default=float("nan"))}
    return {"rank": mesh.rank, "coords": dict(mesh.coords), "serve": serve_out,
            "train": train_out, "launches": launches, "path": stats,
            "bwd": bwd_all, "shapes": shapes}


def _rank_19(rank: int, world: int, init: str, out: str, seed: int) -> None:
    """19's rank: data 1 x model ``world`` over gloo on the one card,
    :func:`_rank_tp_body` against the parent's meshless runs in ``out``."""
    import torch

    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    mesh = init_rank_mesh(1, world, None, rank=rank, world_size=world,
                          local_rank=0, init_method=init, backend="gloo")
    try:
        refs = torch.load(Path(out, "refs.pt"), weights_only=False)
        x = _rank_tp_body(mesh, seed, refs)
        Path(out, f"rank{rank}.json").write_text(json.dumps(x))
    finally:
        close_rank_mesh()


def tp_limit(ref: dict) -> float:
    """Phase 19's bound on a family's logits against the meshless run:
    FAMILY_TOL, or where larger twice the meshless run's own distance from
    float32 compute (``f32_gap``). A rank's partial sums over model round
    to bf16 before they meet, so the split is another bf16 order of the
    same sums: each bf16 run lies about ``f32_gap`` from the float32 one,
    so the two lie within twice that of each other (rwkv6's 24 layers:
    a gap of 0.9473, the split 0.8887 from meshless, four cards, NVIDIA
    H100 80GB HBM3, 700 W)."""
    return max(FAMILY_TOL, 2 * ref["f32_gap"])


def _check_rank_tp(ranks: list, refs: dict, card: str) -> None:
    """Print phase 19's ranks against the meshless runs; then raise where
    a family's logits, argmax or bytes missed, a train step missed
    TRAIN_TOL, a flash call disagreed with its plain version, or a kernel
    never launched."""
    M = len(ranks)
    bad = []
    for arch, _ in RANK_TP_FAMILIES:
        xs = [x["serve"][arch] for x in ranks]
        ref, limit = refs[arch], tp_limit(refs[arch])
        print(f"  {arch} ({xs[0]['layers']} layers, published width) on data 1 x "
              f"model {M}, {FAMILY_BATCH} x {FAMILY_PROMPT} + {FAMILY_STEPS} decode "
              f"steps, teacher-forced: max |logit diff| vs meshless "
              f"{[round(x['max_logit_diff'], 4) for x in xs]} (limit {limit:.4f}: "
              f"FAMILY_TOL {FAMILY_TOL}, or twice meshless bf16 vs float32 "
              f"{ref['f32_gap']:.4f}), argmax differing beyond the margin "
              f"{[x['argmax_differs_beyond_margin'] for x in xs]}; [{card}] "
              f"parameter bytes a rank {[x['rank_bytes'] for x in xs]} against "
              f"{ref['bytes']} meshless; wall {[round(x['wall_s'], 2) for x in xs]} "
              f"s against {ref['wall_s']:.2f} meshless; launches "
              f"{[x['launches'] for x in xs]}", flush=True)
        for x in xs:
            if not x["finite"] or x["max_logit_diff"] > limit \
                    or x["argmax_differs_beyond_margin"] \
                    or x["rank_bytes"] >= ref["bytes"] \
                    or x["whole_bytes"] != ref["bytes"]:
                bad.append(f"{arch} served on the rank mesh: {x}")
    for arch, _ in RANK_TP_FAMILIES:
        xs = [x["train"][arch] for x in ranks]
        print(f"  {arch} train step ({RANK_TP_LAYERS} layers, {FAMILY_BATCH} x "
              f"{FAMILY_TRAIN_SEQ} tokens, flash, remat, float32 compute) on data "
              f"1 x model {M} vs meshless: loss {[f'{x['loss']:.2e}' for x in xs]}, "
              f"grad norm {[f'{x['grad_norm']:.2e}' for x in xs]}, worst leaf "
              f"{[(x['worst_leaf'], f'{x['grads']:.2e}') for x in xs]}"
              + (f", key-bias noise / grad norm "
                 f"{[f'{x['key_bias_noise']:.2e}' for x in xs]}"
                 if any(x["key_bias_noise"] for x in xs) else "")
              + f" (limits {TRAIN_TOL}); launches {[x['launches'] for x in xs]}",
              flush=True)
        bad += [f"{arch}'s train step on the rank mesh: {x}" for x in xs if not x["ok"]]
    for x in ranks:
        p, b = x["path"], x["bwd"]
        print(f"  rank {x['rank']}: flash_mha_fwd {p['flash_mha_fwd']['calls']} "
              f"calls == plain ({p['flash_mha_fwd']['bad']} beyond, max |err| "
              f"{p['flash_mha_fwd']['max_abs_err']:.3e}), flash_decode "
              f"{p['flash_decode']['calls']} ({p['flash_decode']['bad']} beyond, "
              f"{p['flash_decode']['max_abs_err']:.3e}), flash_attention_bwd "
              f"{b['calls']} ({b['bad']} beyond, worst {b['max_err']:.3e} x "
              f"scale); per-rank shapes {x['shapes']}", flush=True)
        if p["flash_mha_fwd"]["bad"] or p["flash_decode"]["bad"] or b["bad"] \
                or not p["flash_mha_fwd"]["calls"] or not p["flash_decode"]["calls"] \
                or not b["calls"]:
            bad.append(f"rank {x['rank']}: kernels vs plain {p}, {b}")
        bad += [f"{k} never launched on rank {x['rank']}'s path"
                for k in RANK_TP_KERNELS if not x["launches"][k]]
    if bad:
        raise AssertionError("phase 19: " + "; ".join(bad))


def time_rank_tp_kernels(shapes: dict, launches: dict, dev) -> list[dict]:
    """B5, B6 and B7 at the per-rank shapes phase 19 launched them at
    (RANK_TP_ROWS: in the dtype the path used, and B7 in bf16 too), on
    seeded operands laid out as the path lays them
    (the (B,H,S,D) views of (B,S,H,D) projections; the decode cache's
    (B,KV,S,D) views with every length the run's last), each timed as
    phase 5's rows: the kernel alone, its plain version, SDPA, the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for arch, name, as_dtype in RANK_TP_ROWS:
        qs, ks, extra, dtype = shapes[arch][name]
        dtype = as_dtype or dtype
        dt = getattr(torch, dtype.removeprefix("torch."))
        rate = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S

        def views(B, H, S, D):   # (B,H,S,D) views of a (B,S,H,D) tensor
            return torch.randn((B, S, H, D), generator=g, device=dev,
                               dtype=dt).transpose(1, 2)

        if name == "flash_decode":
            (B, H, D), (_, KV, S, _) = qs, ks
            q = torch.randn((B, H, D), generator=g, device=dev, dtype=dt)
            k, v = views(B, KV, S, D), views(B, KV, S, D)
            lens = torch.full((B,), extra, dtype=torch.int32, device=dev)
            mask = (torch.arange(S, device=dev)[None, :] < lens[:, None])[:, None, None]
            work = da.flash_decode_cost(q, k, lens)
            err = float((da.flash_decode(q, k, v, lens).float()
                         - da.flash_decode_plain(q, k, v, lens).float()).abs().max())
            row = _timed(name, ("flash_decode_split_kernel", "flash_decode_merge_kernel"),
                         lambda: da.flash_decode(q, k, v, lens),
                         lambda: da.flash_decode_plain(q, k, v, lens),
                         lambda: F.scaled_dot_product_attention(
                             q[:, :, None], k, v, attn_mask=mask, enable_gqa=True),
                         work["bytes"], work["flops"], err, launches[name],
                         f"{arch} per rank: q ({B}, {H}, {D}), cache ({B}, {KV}, "
                         f"{S}, {D}) {dtype}, every length {extra}",
                         ops_per_s=rate)
        else:
            (B, H, S, D), (_, KV, _, _) = qs, ks
            causal = bool(extra)
            q, k, v = views(B, H, S, D), views(B, KV, S, D), views(B, KV, S, D)
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            if name == "flash_mha_fwd":
                work = fa.flash_mha_fwd_cost(q, k, causal=causal)
                err = float((fa.flash_mha_fwd(q, k, v, causal=causal)[0].float()
                             - fa.flash_mha_fwd_plain(q, k, v, causal=causal)[0]
                             .float()).abs().max())
                row = _timed(name, "flash_fwd_bf16_kernel" if dt == torch.bfloat16
                             else "flash_fwd_kernel",
                             lambda: fa.flash_mha_fwd(q, k, v, causal=causal),
                             lambda: fa.flash_mha_fwd_plain(q, k, v, causal=causal),
                             lambda: F.scaled_dot_product_attention(
                                 qc, kc, vc, is_causal=causal, enable_gqa=True),
                             work["bytes"], work["flops"], err, launches[name],
                             f"{arch} per rank: q ({B}, {H}, {S}, {D}), k, v ({B}, "
                             f"{KV}, {S}, {D}) {dtype}, causal {causal}, (B,H,S,D) "
                             "views of (B,S,H,D)", ops_per_s=rate)
            else:
                out, lse = fa.flash_mha_fwd(q, k, v, causal=causal)
                do = views(B, H, S, D)
                got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
                want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do,
                                                    causal=causal)
                err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(got, want))
                del got, want
                qg, kg, vg = (t.requires_grad_(True) for t in (qc, kc, vc))
                ref_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                         enable_gqa=True)
                doc = do.contiguous()
                work = fa.flash_attention_bwd_cost(q, k, causal=causal)
                row = _timed(name, BWD_KERNELS if dt == torch.bfloat16
                             else BWD_F32_KERNELS,
                             lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                            causal=causal),
                             lambda: fa.flash_attention_bwd_plain(q, k, v, out, lse,
                                                                  do, causal=causal),
                             lambda: torch.autograd.grad(ref_out, (qg, kg, vg), doc,
                                                         retain_graph=True),
                             work["bytes"], work["flops"], err, launches[name],
                             f"{arch} per rank: q, out, dO ({B}, {H}, {S}, {D}), "
                             f"k, v ({B}, {KV}, {S}, {D}) {dtype}, causal {causal}, "
                             "(B,H,S,D) views of (B,S,H,D)", ops_per_s=rate)
                del ref_out
        rows.append(row)
    torch.cuda.empty_cache()
    return rows


def run_rank_tp(dev, seed: int, card: str) -> dict:
    """Phase 19: tensor parallelism over model for rwkv, the hybrid,
    whisper and vlm. The meshless serving runs on the card first
    (:func:`_tp_reference`), then RANK_TP_MODEL spawned gloo ranks sharing
    the card (data 1 x model RANK_TP_MODEL) run :func:`_rank_tp_body`
    against them; B5, B6 and B7 are then timed at the per-rank shapes the
    ranks launched them at. Returns the numbers, the per-rank rows and the
    launches summed over the ranks."""
    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rank_tp_")
    try:
        refs = {arch: _tp_reference(arch, layers, dev, seed)
                for arch, layers in RANK_TP_FAMILIES}
        torch.save(refs, Path(tmp, "refs.pt"))
        t0 = time.perf_counter()
        _spawn_ranks(_rank_19, RANK_TP_MODEL, tmp, RANK_TP_TIMEOUT, seed)
        ranks_s = time.perf_counter() - t0
        ranks = [json.loads(Path(tmp, f"rank{r}.json").read_text())
                 for r in range(RANK_TP_MODEL)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _check_rank_tp(ranks, refs, card)
    launches = {k: sum(x["launches"][k] for x in ranks) for k in RANK_TP_KERNELS}
    rows = time_rank_tp_kernels(ranks[0]["shapes"], launches, dev)
    out = {"ranks": ranks, "launches": launches, "rows": rows,
           "meshless": {a: {"bytes": r["bytes"], "wall_s": r["wall_s"]}
                        for a, r in refs.items()},
           "ranks_s": ranks_s, "seconds": time.perf_counter() - t_phase}
    print(f"  [{card}] phase 19 in {out['seconds']:.1f} s (the ranks "
          f"{ranks_s:.1f} s); launches on path rank_tp, both ranks: {launches}",
          flush=True)
    return out


def rank_tp_main(seed: int) -> int:
    """``--rank-tp``: phase 19 alone, its kernels built first, its kernel
    rows printed. Under ``torchrun`` (``WORLD_SIZE`` above 1) it runs
    :func:`_rank_tp_body` instead on data 1 x model WORLD_SIZE over NCCL,
    one rank a card, each rank holding its families to the meshless runs
    it makes first on its own card; rank 0 prints the summary."""
    import torch

    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    _build.lib()
    card = nvidia_smi()
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        out = run_rank_tp(torch.device("cuda", 0), seed, card)
        for row in out["rows"]:
            print_kernel_row(row)
        print(json.dumps({"rank_tp": out}))
        return 0
    from repro_torch.launch.mesh import close_rank_mesh, init_rank_mesh

    mesh = init_rank_mesh(1, world, None)
    try:
        refs = {arch: _tp_reference(arch, layers, mesh.device, seed)
                for arch, layers in RANK_TP_FAMILIES}
        x = _rank_tp_body(mesh, seed, refs)
        every = [None] * world
        torch.distributed.all_gather_object(every, x)
        if mesh.rank == 0:
            _check_rank_tp(every, refs, card)
            print(nvidia_smi(every=True))
            print(json.dumps({"rank_tp_nccl": {
                "world": world, "ranks": every,
                "meshless": {a: {"bytes": r["bytes"], "wall_s": r["wall_s"]}
                             for a, r in refs.items()}}}))
        torch.distributed.barrier()
    finally:
        close_rank_mesh()
    return 0


def device_breakdown(fn, top: int = 12) -> list:
    """Device time (ms) and records of one profiled call of ``fn`` per
    kernel name, the ``top`` largest (names cut to 200 characters, enough to
    show the functor of PyTorch's generic elementwise kernels). A trace that
    holds no record at all is taken again, up to ``TRACE_TRIES`` times."""
    for _ in range(TRACE_TRIES):
        rows = sorted(_profile(fn, 1), key=lambda r: -r[1])
        if rows:
            break
    return [[key[:200], us / 1e3, n] for key, us, n in rows[:top]]


def expr_breakdowns(frame) -> dict:
    """``device_breakdown`` of one kernel-mode run of each of ``BREAKDOWN``
    (e3, e9, e11: the expressions over filter_count and block_topk), on the
    frames ``frame()`` gives."""
    return {name: device_breakdown(
                lambda fn=EXPRESSIONS[name]: fn(*frame(), np.random.default_rng(1)))
            for name in BREAKDOWN}


def print_breakdowns(bds: dict) -> None:
    for name, rows in bds.items():
        print(f"  {name} device time by kernel (largest first):", flush=True)
        for key, ms, n in rows:
            print(f"    {ms:9.4f} ms {n:5d} records  {key}", flush=True)


def time_udf(queries: dict) -> dict:
    times = {name: {"wall_ms": host_ms(fn)} for name, fn in queries.items()}
    for name, fn in queries.items():
        t = times[name]
        t["device_ms"] = device_ms(fn)
        t["busy"] = None if t["device_ms"] is None else t["device_ms"] / t["wall_ms"]
    q2 = times["2_count_negative"]
    wall_s = q2["wall_ms"] / 1e3
    q2["rows_per_s"] = UDF_ROWS / wall_s
    q2["tokens_per_s"] = UDF_ROWS * UDF_SEQ / wall_s
    q2["breakdown"] = device_breakdown(queries["2_count_negative"])
    return times


def time_attention(cases: dict, launches: dict) -> tuple[dict, list[dict]]:
    """flash_mha_fwd's row of the ``kernels`` line (the model-UDF path's
    strided layout, with its time on contiguous inputs beside it) and two
    decode rows at phase 2's shape: every length = S, and the mixed
    lengths (bound on the slots those lengths walk). The bounds are the
    kernel modules' ``flash_mha_fwd_cost`` and ``flash_decode_cost``. The decode row of the
    ``kernels`` line is phase 10's, at the serve shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa

    out = []
    q, k, v = cases["flash_mha_fwd"]
    qc, kc, vc = cases["flash_mha_fwd_contiguous"]
    B, H, S, D = q.shape
    work = fa.flash_mha_fwd_cost(q, k, causal=True)
    flash_row = _timed("flash_mha_fwd", "flash_fwd_bf16_kernel",
                       lambda: fa.flash_mha_fwd(q, k, v, causal=True),
                       lambda: fa.flash_mha_fwd_plain(q, k, v, causal=True),
                       lambda: F.scaled_dot_product_attention(qc, kc, vc,
                                                              is_causal=True),
                       work["bytes"], work["flops"],
                       cases["errs"]["flash_mha_fwd"], launches["flash_mha_fwd"],
                       f"q, k, v ({B}, {H}, {S}, {D}) bf16 causal, (B,H,S,D) "
                       "views of (B,S,H,D)", ops_per_s=BF16_OPS_PER_S)
    flash_row["contiguous_ms"], _, _ = _per_call_ms(
        lambda: fa.flash_mha_fwd(qc, kc, vc, causal=True),
        ("flash_fwd_bf16_kernel",), 20)
    out.append(flash_row)

    def decode_row(name, case):
        q, k, v, lens = case
        B, H, D = q.shape
        KV, S = k.shape[1], k.shape[2]
        mask = (torch.arange(S, device=q.device)[None, :] < lens[:, None])[:, None, None]
        work = da.flash_decode_cost(q, k, lens)
        row = _timed(name, ("flash_decode_split_kernel", "flash_decode_merge_kernel"),
                     lambda: da.flash_decode(q, k, v, lens),
                     lambda: da.flash_decode_plain(q, k, v, lens),
                     lambda: F.scaled_dot_product_attention(
                         q[:, :, None], k, v, attn_mask=mask),
                     work["bytes"], work["flops"], cases["errs"]["flash_decode"],
                     launches["flash_decode"],
                     f"q ({B}, {H}, {D}), cache ({B}, {KV}, {S}, {D}) bf16, "
                     f"{work['walked']} of {B * S} slots walked, slices of "
                     f"{da.split_size(B, KV, S)}", ops_per_s=BF16_OPS_PER_S)
        return row

    return out[0], [decode_row("flash_decode", cases["flash_decode"]),
                    decode_row("flash_decode", cases["flash_decode_mixed"])]


# -- phase 5: kernel timings --------------------------------------------------------

def _library_ms(fn) -> float:
    """Device ms per call of a library yardstick (every kernel and copy of
    it); a trace that holds none of its records (seen on the H100: one read
    0) is taken again, up to ``TRACE_TRIES`` times."""
    for _ in range(TRACE_TRIES):
        ms = _per_call_ms(fn)[0]
        if ms > 0:
            return ms
    raise AssertionError(f"no device record of the library call in "
                         f"{TRACE_TRIES} traces")


def _timed(name: str, kernel: str | tuple[str, ...], wrapper, plain, library,
           nbytes: float, ops: float, err: float, launches: int, shape: str,
           ops_per_s: float = FP32_OPS_PER_S) -> dict:
    """One entry of the ``kernels`` line. ``ms`` is the device time of the
    kernel alone: the mean of its records (by name) in a profiler trace of
    20 wrapper calls, ``kernel_records`` of them (the trace may miss some);
    where one call launches several kernels (a tuple of names), the sum of
    their means. ``library_ms`` is measured the same way: every kernel and
    copy of 20 library calls in one trace, each its mean per record times
    its launches per call. ``event_ms`` and ``library_event_ms`` check the
    two: CUDA events over 20 back-to-back calls, host issue included.
    ``plain_ms`` is the CUDA-event time of one call of the plain version on
    an idle stream (median of 5; launch latency included). ``parts_ms``,
    where one call launches several kernels: each one's share of ``ms``."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    ms, n_records, parts = _per_call_ms(wrapper, names, 20)
    bms, by = bound_ms(nbytes, ops, ops_per_s)
    return dict(name=name, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{SOURCES[name]}",
                replaces=REPLACES[name], launches=launches, max_abs_err=err,
                ms=ms, plain_ms=single_call_ms(plain),
                bound_ms=bms, bound_by=by,
                library_ms=None if library is None else _library_ms(library),
                event_ms=cuda_ms(wrapper),
                library_event_ms=None if library is None else cuda_ms(library),
                kernel_records=n_records, shape=shape,
                **({"parts_ms": parts} if len(names) > 1 else {}))


SOURCES = {"filter_count": "filter_count.cu", "segment_agg": "segment_agg.cu",
           "block_topk": "topk_mask.cu", "topk_merge": "topk_mask.cu",
           "merge_join_count": "merge_join.cu",
           "flash_mha_fwd": "flash_attention.cu",
           "flash_decode": "decode_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
REPLACES = {"filter_count": "src/repro/kernels/filter_count.py:97",
            "segment_agg": "src/repro/kernels/segment_agg.py:103",
            "block_topk": "src/repro/kernels/topk_mask.py:39",
            # the merge after the TPU kernel: topk_merge's jax.lax.top_k
            "topk_merge": "src/repro/kernels/topk_mask.py:73",
            "merge_join_count": "src/repro/kernels/merge_join.py:46",
            "flash_mha_fwd": "src/repro/kernels/flash_attention.py:73",
            "flash_decode": "src/repro/kernels/decode_attention.py:61",
            # not Pallas: the jnp custom_vjp backward of flash_mha_fwd
            "flash_attention_bwd": "src/repro/kernels/ops.py:297"}


SEGMENT_AGG_KERNELS = ("segment_agg_partial_kernel", "segment_agg_merge_kernel")
MERGE_JOIN_KERNELS = ("merge_join_window_kernel", "merge_join_kernel")


def rotating(fn, args: tuple, nbytes: float):
    """A call of ``fn`` on copies of ``args`` in turn: enough copies that
    the others move at least twice the card's L2 between two calls on one,
    so that each call reads its operands from device memory, as the main
    path does its fresh columns, and not from the L2 the last call left."""
    import itertools

    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 << 20)
    copies = 1 + math.ceil(2 * l2 / nbytes)

    def copy(a):  # a tensor, or a list of tensors (filter_count's columns)
        if isinstance(a, torch.Tensor):
            return a.clone()
        return [c.clone() for c in a] if isinstance(a, list) else a
    sets = [args] + [tuple(copy(a) for a in args) for _ in range(copies - 1)]
    turn = itertools.cycle(sets)
    return lambda: fn(*next(turn))


def time_kernels(cases: dict, launches: dict) -> tuple[list[dict], list[dict]]:
    """The four relational rows of the ``kernels`` line and, for the other
    line, segment_agg at the e8 shape (G = 20, max: the most lanes per
    group) and merge_join_count on the duplicate-heavy keys. Kernel, plain
    version and library call each rotate over copies of their operands
    (``rotating``): their working sets (25-60 MB) would otherwise sit in
    the H100's 50 MB L2 from one timed call to the next."""
    import torch

    from repro_torch.kernels import filter_count as fc
    from repro_torch.kernels import merge_join as mj
    from repro_torch.kernels import segment_agg as sa
    from repro_torch.kernels import topk_mask as tk

    out = []
    c = cases["filter_count"]
    args, k, n = c["args"], c["k"], c["n"]
    err = float((fc.filter_count(*args) - fc.filter_count_plain(*args)).abs())
    nbytes = k * n * 4 + k * 8 + 4
    out.append(_timed("filter_count", "filter_count_kernel",
                      rotating(fc.filter_count, args, nbytes),
                      rotating(fc.filter_count_plain, args, nbytes), None,
                      nbytes, 2 * k * n, err,
                      launches["filter_count"],
                      f"cols {k} x ({n},) int32 (a column list, e3)"))

    def segment_row(case, label):
        args, op = case["args"], case["op"]
        vals, gids, G, n = args
        got = sa.segment_agg(*args, op=op)
        err = float((got - sa.segment_agg_plain(*args, op=op)).abs().max())
        if op == "sum":
            def library(vals, gl):
                return torch.zeros((G, 1), device=vals.device).index_add_(0, gl, vals)
        else:
            def library(vals, gl):
                return torch.full((G, 1), -math.inf, device=vals.device) \
                    .scatter_reduce_(0, gl[:, None], vals, "amax")
        nbytes = n * 4 * 2 + G * 4
        return _timed("segment_agg", SEGMENT_AGG_KERNELS,
                      rotating(lambda *a: sa.segment_agg(*a, op=op), args, nbytes),
                      rotating(lambda *a: sa.segment_agg_plain(*a, op=op), args,
                               nbytes),
                      rotating(library, (vals, gids.long()), nbytes),
                      nbytes, n, err, launches["segment_agg"],
                      f"values ({n}, 1) f32, G={G}, {op} ({label})")

    out.append(segment_row(cases["segment_agg"], "e4"))
    variants = [segment_row(cases["segment_agg_e8"], "e8")]

    def topk_row(case, label):
        targs = case["args"]
        s, live, n, k = targs
        nb = -(-n // tk.BLOCK)
        v, i = tk.block_topk(*targs)
        pv, pi = tk.block_topk_plain(*targs)
        err = max(float((v - pv).abs().max()), float((i - pi).abs().max()))
        padded = torch.nn.functional.pad(s, (0, nb * tk.BLOCK - n),
                                         value=float("-inf")).view(nb, tk.BLOCK)
        nbytes = n * 5 + nb * k * 8
        return _timed("block_topk", "block_topk_kernel",
                      rotating(tk.block_topk, targs, nbytes),
                      rotating(tk.block_topk_plain, targs, nbytes),
                      rotating(lambda p: torch.topk(p, k, dim=1), (padded,),
                               nbytes),
                      nbytes, n, err, launches["block_topk"],
                      f"scores ({n},) f32, k={k} ({label})"), (v, i, s, nb, k)

    row, (v, i, s, nb, k) = topk_row(cases["block_topk"], "e9: unique1")
    out.append(row)
    variants.append(topk_row(cases["block_topk_rising"],
                             "unique2: rising with the row")[0])
    # the merge, on the candidates e9's block kernel gives (48 KB: they stay
    # in the L2, as on the main path, where the merge reads them right
    # after the block kernel wrote them); library: one torch.topk of the
    # same candidates (the same function, tie order aside).
    # ``scores_topk_ms``: one torch.topk of the 5M scores, the whole
    # selection in one call
    mv, mi = tk.merge_candidates(v, i)
    pmv, pmi = tk.merge_candidates_plain(v, i)
    err = max(float((mv - pmv).abs().max()), float((mi - pmi).abs().max()))
    flat = v.reshape(-1)
    row = _timed("topk_merge", "topk_merge_kernel",
                 lambda: tk.merge_candidates(v, i),
                 lambda: tk.merge_candidates_plain(v, i),
                 lambda: torch.topk(flat, k),
                 nb * k * 8 + k * 8, nb * k, err, launches["topk_merge"],
                 f"candidates ({nb}, {k}) f32 + int32, k={k}")
    row["scores_topk_ms"] = _library_ms(
        rotating(lambda s: torch.topk(s, k), (s,), n * 4))
    out.append(row)

    def join_row(case, label):
        args, n = case["args"], case["n"]
        err = float((mj.merge_join_count(*args)
                     - mj.merge_join_count_plain(*args)).abs())
        keys = int(args[2]) + int(args[3])  # the valid prefixes, read once
        nbytes = keys * 4 + 8 + 4
        return _timed("merge_join_count", MERGE_JOIN_KERNELS,
                      rotating(mj.merge_join_count, args, nbytes),
                      rotating(mj.merge_join_count_plain, args, nbytes), None,
                      nbytes, keys, err,
                      launches["merge_join_count"],
                      f"keys ({n},) + ({n},) int32, prefixes {int(args[2])} + "
                      f"{int(args[3])}, {label}")

    out.append(join_row(cases["merge_join_count"], "unique (e12)"))
    variants.append(join_row(cases["merge_join_dup"], "duplicate-heavy"))
    return out, variants


def print_kernel_row(k: dict) -> None:
    lib = "none" if k["library_ms"] is None else \
        f"{k['library_ms']:.4f} ms (events {k['library_event_ms']:.4f} ms)"
    print(f"  {k['name']:17s} kernel {k['ms']:.4f} ms "
          f"({k['kernel_records']} records / 20 calls)  "
          f"events {k['event_ms']:.4f} ms  "
          f"plain {k['plain_ms']:.4f} ms  bound {k['bound_ms']:.4f} ms "
          f"({k['bound_by']})  library {lib}  launches {k['launches']}  "
          f"[{k['shape']}]", flush=True)
    if "parts_ms" in k:
        print("    of which " + ", ".join(
            f"{n} {t:.4f} ms" for n, t in k["parts_ms"].items()), flush=True)
    if "scores_topk_ms" in k:
        print(f"    torch.topk of the {ROWS} scores {k['scores_topk_ms']:.4f} ms",
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--rank-engine", action="store_true",
                    help="phase 16 alone (under torchrun: 16(b)'s body on "
                         "one rank a card over NCCL)")
    ap.add_argument("--rank-live", action="store_true",
                    help="phase 17 alone (under torchrun: 17(b)'s scenario "
                         "on one rank a card over NCCL)")
    ap.add_argument("--rank-durable", action="store_true",
                    help="phase 18 alone (under torchrun: 18(b)'s crash "
                         "matrix on one rank a card over NCCL)")
    ap.add_argument("--rank-tp", action="store_true",
                    help="phase 19 alone (under torchrun: data 1 x model "
                         "WORLD_SIZE over NCCL, one rank a card)")
    args = ap.parse_args(argv)
    if args.rank_engine:
        return rank_engine_main(args.seed)
    if args.rank_live:
        return rank_live_main(args.seed)
    if args.rank_durable:
        return rank_durable_main(args.seed)
    if args.rank_tp:
        return rank_tp_main(args.seed)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from repro_torch.data import wisconsin
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = nvidia_smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    phase_header("phase 1: build", flush=True)
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    build_s = time.perf_counter() - t0
    print(f"  {lib_path.relative_to(ROOT)} in {build_s:.1f} s", flush=True)
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or line.startswith("==") \
                or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)
    sass = sass_counts(lib_path, BWD_KERNELS[1:])
    print("  cuobjdump -sass, the bf16 B7 kernels: " + "; ".join(
        f"{k} {c['HGMMA']} HGMMA, {c['UTMALDG']} UTMALDG"
        for k, c in sass.items()), flush=True)
    if not all(c["HGMMA"] and c["UTMALDG"] for c in sass.values()):
        raise AssertionError(f"the bf16 B7 kernels lack wgmma or TMA: {sass}")

    t0 = time.perf_counter()
    table = wisconsin.generate(ROWS, seed=args.seed)
    raw = {k: v.numpy() for k, v in table.columns.items()}
    print(f"  generated {ROWS} rows in {time.perf_counter() - t0:.2f} s",
          flush=True)

    phase_header("phase 2: kernels vs plain versions on the card", flush=True)
    cases = check_kernels(raw, dev)
    attn_cases = check_attention_kernels(dev)
    bwd_cases = check_flash_backward(dev)

    phase_header(f"phase 3: the 12 Wisconsin expressions at {ROWS} rows", flush=True)
    res = run_slice(table, raw, dev)

    phase_header(f"phase 4: the model-UDF pipeline, paper-lm over {UDF_ROWS} x "
          f"{UDF_SEQ} tokens", flush=True)
    udf = run_udf_slice(dev, args.seed)

    phase_header("phase 5: timings", flush=True)
    print(f"  card clocks.sm, max, power, temperature: {smi_clocks()}",
          flush=True)
    def fmt(t):
        dev = "not measured" if t["device_ms"] is None else \
            f"device {t['device_ms']:.3f} ms, busy {t['busy']:.0%}"
        return f"{t['wall_ms']:8.3f} ms ({dev})"
    for name, t in res["expr_ms"].items():
        print(f"  {name:16s} kernel {fmt(t['kernel'])}   gspmd {fmt(t['gspmd'])}",
              flush=True)
    udf_ms = time_udf(udf["queries"])
    for name, t in udf_ms.items():
        rate = "" if "rows_per_s" not in t else \
            f"  {t['rows_per_s']:.0f} rows/s, {t['tokens_per_s']:.0f} tokens/s"
        print(f"  udf {name:18s} {fmt(t)}{rate}", flush=True)
    print("  udf 2_count_negative device time by kernel (largest first):",
          flush=True)
    for key, ms, n in udf_ms["2_count_negative"]["breakdown"]:
        print(f"    {ms:9.1f} ms {n:5d} records  {key}", flush=True)
    print("  (wall: median of 7 host-clock runs, result on the host; device: "
          "one profiled run)", flush=True)
    print_breakdowns(res["breakdowns"])
    # the decode rows' launches are phase 10's (the serving path): they are
    # printed once that phase has run
    flash_row, decode_rows = time_attention(
        attn_cases, {"flash_mha_fwd": udf["launches"]["flash_mha_fwd"],
                     "flash_decode": 0})
    relational, variants = time_kernels(cases, res["launches"])
    kernels = relational + [flash_row]
    for k in kernels + variants:
        print_kernel_row(k)
    print(f"  flash_mha_fwd on contiguous (B,H,S,D) inputs: kernel "
          f"{flash_row['contiguous_ms']:.4f} ms (the library call above runs "
          "on these)", flush=True)
    print("  (kernel, library: device time per call, the mean of each "
          "kernel's records in a profiler trace of 20 calls times its "
          "launches per call; events: CUDA events over 20 back-to-back "
          "calls, host issue included; plain: CUDA events around one call on "
          "an idle stream, median of 5)", flush=True)
    if not all(math.isfinite(k["ms"]) for k in kernels + decode_rows):
        raise AssertionError("non-finite kernel time")

    phase_header(f"phase 6: live ingestion — {ROWS} rows, then {len(LIVE_MIX)} "
          f"batches of {LIVE_BATCH} ({', '.join(LIVE_MIX)}), a view, the "
          f"compaction", flush=True)
    stringu1 = wisconsin_stringu1(raw)
    live = run_live(table, raw, dev, args.seed, card,
                    strings_hook=live_strings_hook(card, stringu1))

    phase_header(f"phase 7: the string fast path, windows and dialects at {ROWS} "
          f"rows (the live part ran above, over phase 6's components)",
          flush=True)
    closed = run_strings_windows(table, raw, dev, card, stringu1)
    string_rows = time_string_kernels(closed)
    for k in string_rows:
        print_kernel_row(k)
    variants += string_rows
    strings = {"closed": {k: closed[k] for k in
                          ("launches", "queries", "breakdowns",
                           "cumsum_unique1_deviation")},
               "live": live.pop("strings")}
    phase_header(f"phase 8: durability — Session(storage=dir) at {ROWS} rows + "
          f"{len(LIVE_MIX) + len(DURABLE_TAIL)} batches, Session.open lazy and "
          f"eager, the compaction, and the crash matrix over "
          f"{CRASH_BATCHES} batches", flush=True)
    durable = run_durable(table, raw, dev, args.seed, card, live["flushes"])
    phase_header(f"phase 9: the multi-device engine — the 12 expressions on a "
          f"{MESH_SHARDS}-shard mesh of the card (shard_map and kernel), "
          f"unaligned shard views, the live scenario on the mesh at "
          f"{MESH_LIVE_ROWS} rows, S = {', '.join(map(str, SHARD_SWEEP))}",
          flush=True)
    mesh = run_mesh(table, raw, dev, args.seed, card)
    for k in kernels:
        if k["name"] in mesh["launches"]:
            k["launches_mesh"] = mesh["launches"][k["name"]]
    phase_header(f"phase 10: serving — {SERVE_ARCH} at its published config, "
          f"{SERVE_BATCH} requests x ({SERVE_PROMPT} + {SERVE_NEW}) tokens, "
          f"flash and blocked; then {', '.join(a for a, _ in FAMILY_CELLS)} "
          f"at {FAMILY_BATCH} x {FAMILY_PROMPT} + {FAMILY_STEPS} steps", flush=True)
    t0 = time.perf_counter()
    serving = run_serving(dev, args.seed, card)
    serving["seconds"] = time.perf_counter() - t0
    # the main path's launches: the model UDF's and the serving path's
    serve_launches = serving["launches"]
    flash_row["launches_by_path"] = {"udf": flash_row["launches"],
                                     "serve": serve_launches["flash_mha_fwd"]}
    flash_row["launches"] += serve_launches["flash_mha_fwd"]
    flash_row["max_abs_err"] = max(flash_row["max_abs_err"],
                                   serving["recorded"]["flash_mha_fwd"]["max_abs_err"])
    for k in decode_rows:
        k["launches"] = serve_launches["flash_decode"]
        print_kernel_row(k)
    kernels.append(serving.pop("row"))
    variants += decode_rows
    phase_header(f"phase 11: training — {TRAIN_ARCH} at its published config, "
          f"{TRAIN_STEPS} train steps on {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"(flash, remat, AdamW), against blocked; then one step of "
          f"{', '.join(a for a, _ in FAMILY_CELLS)} at {FAMILY_BATCH} x "
          f"{FAMILY_TRAIN_SEQ}", flush=True)
    t0 = time.perf_counter()
    training = run_training(dev, args.seed, card, bwd_cases)
    training["seconds"] = time.perf_counter() - t0
    bwd_row = training.pop("row")
    bwd_row["max_abs_err_rel"] = bwd_cases["err"]
    kernels.append(bwd_row)
    torch.cuda.empty_cache()
    phase_header(f"phase 12: the training runtime — {TRAIN_ARCH} through "
          f"launch/train.run (flash), {RUNTIME_STEPS} steps of {TRAIN_BATCH} x "
          f"{TRAIN_SEQ} tokens, checkpoints every {RUNTIME_CKPT_EVERY}, injected "
          f"{RUNTIME_SCHEDULE}, then a resume and two planted faults", flush=True)
    t0 = time.perf_counter()
    runtime = run_runtime(dev, card)
    runtime["seconds"] = time.perf_counter() - t0
    print(f"  [{card}] phase 12 in {runtime['seconds']:.1f} s", flush=True)
    # the main path's launches: each path's, counted apart
    flash_row["launches_by_path"]["runtime"] = runtime["launches"]["flash_mha_fwd"]
    flash_row["launches"] += runtime["launches"]["flash_mha_fwd"]
    bwd_row["launches_by_path"] = {"training": bwd_row["launches"],
                                   "runtime": runtime["launches"]["flash_attention_bwd"]}
    bwd_row["launches"] += runtime["launches"]["flash_attention_bwd"]
    torch.cuda.empty_cache()
    phase_header(f"phase 13: the model mesh on one card — {MESH_ARCH} served "
          f"({MESH_SERVE_BATCH} x ({MESH_SERVE_PROMPT} + {MESH_SERVE_NEW}), "
          f"shardmap decode) and trained ({MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}, "
          f"data-parallel) on a data {MESH_DATA} x model {MESH_MODEL} mesh, "
          f"{MESH_MOE[0]} expert-parallel on {MESH_MOE_DATA} x {MESH_MOE_MODEL}, "
          f"compressed_psum over the data shards' gradients", flush=True)
    mesh_models = run_mesh_models(dev, args.seed, card)
    for row, name in ((flash_row, "flash_mha_fwd"), (bwd_row, "flash_attention_bwd")):
        row["launches_by_path"]["mesh"] = mesh_models["launches"][name]
        row["launches"] += mesh_models["launches"][name]
    torch.cuda.empty_cache()
    phase_header(f"phase 14: the dry-run — {len(DRYRUN_CELLS)} cells at published width "
          f"on both pod meshes of the meta device; the cost model over "
          f"{TRAIN_ARCH}'s train step and flash decode step on the card and on "
          f"meta", flush=True)
    t0 = time.perf_counter()
    # phase 14(a)'s meta runs, after phase 13's last timing, beside 14(b)
    dry_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    dryruns = start_dryruns(dry_dir)

    def stop_dryruns():
        for _, p in dryruns:
            if p.poll() is None:
                p.kill()
            p.wait()
        shutil.rmtree(dry_dir, ignore_errors=True)
    atexit.register(stop_dryruns)
    print(f"  started {len(dryruns)} dry-run processes (phase 14(a))", flush=True)
    cost = run_cost_model(dev, args.seed, card)
    cost["dryrun"] = finish_dryruns(dryruns, dry_dir, card)
    cost["seconds"] = time.perf_counter() - t0
    print(f"  [{card}] phase 14 in {cost['seconds']:.1f} s", flush=True)
    decode_row = next(k for k in kernels if k["name"] == "flash_decode")
    for row, name in ((flash_row, "flash_mha_fwd"), (bwd_row, "flash_attention_bwd"),
                      (decode_row, "flash_decode")):
        row.setdefault("launches_by_path", {"serve": row["launches"]})
        row["launches_by_path"]["cost"] = cost["launches"][name]
        row["launches"] += cost["launches"][name]
    torch.cuda.empty_cache()
    phase_header(f"phase 15: the model mesh across processes — {RANK_ARCH} at its "
          f"published config on a one-rank nccl group, weights placed: a train "
          f"step against the meshless one, the shardmap and flash decodes against "
          f"the one-hot one; gloo ranks sharing the card", flush=True)
    ranks = run_rank_mesh(dev, args.seed, card)
    for row, name in ((flash_row, "flash_mha_fwd"), (bwd_row, "flash_attention_bwd"),
                      (decode_row, "flash_decode")):
        row["launches_by_path"]["rank"] = ranks["launches"][name]
        row["launches"] += ranks["launches"][name]
        if not ranks["launches"][name]:
            raise AssertionError(f"phase 15: {name} never launched on the rank path")
    torch.cuda.empty_cache()
    phase_header(f"phase 16: the DataFrame engine across processes — a Session on a "
          f"one-rank nccl group at {ROWS} rows (kernel and shard_map), then "
          f"{RANK_ENGINE_RANKS} gloo ranks sharing the card, each holding "
          f"{-(-ROWS // RANK_ENGINE_RANKS):,} rows", flush=True)
    rank_engine = run_rank_engine(table, raw, dev, args.seed, card,
                                  mesh["sweep"])
    for row in kernels:
        if row["name"] in RELATIONAL:
            n = rank_engine["launches"][row["name"]]
            row.setdefault("launches_by_path", {"slice": row["launches"]})
            row["launches_by_path"]["rank_engine"] = n
            row["launches"] += n
    for name in RANK_ENGINE_KERNELS:
        if not rank_engine["launches"][name]:
            raise AssertionError(f"phase 16: {name} never launched on the "
                                 "rank engine path")
    torch.cuda.empty_cache()
    phase_header(f"phase 17: the live engine across processes — phase 6's "
          f"scenario ({ROWS} rows, {len(LIVE_MIX)} batches, a view, persist, "
          f"the compaction) on a one-rank nccl group against a meshless "
          f"session, then {RANK_LIVE_RANKS} gloo ranks sharing the card",
          flush=True)
    rank_live = run_rank_live(table, raw, dev, args.seed, card, live)
    for row in kernels:
        if row["name"] in RELATIONAL:
            n = rank_live["launches"][row["name"]]
            row["launches_by_path"]["rank_live"] = n
            row["launches"] += n
    torch.cuda.empty_cache()
    phase_header(f"phase 18: the durable store across processes — phase 8's "
          f"scenario ({ROWS} rows, {len(LIVE_MIX)} batches, "
          f"{len(DURABLE_TAIL)} in the WAL, lazy opens, the compaction) on a "
          f"one-rank nccl group against a meshless session, then the crash "
          f"matrix on {RANK_DURABLE_RANKS} gloo ranks sharing the card",
          flush=True)
    rank_durable = run_rank_durable(table, raw, dev, args.seed, card, durable)
    for row in kernels:
        if row["name"] in RELATIONAL:
            n = rank_durable["launches"][row["name"]]
            row["launches_by_path"]["rank_durable"] = n
            row["launches"] += n
    torch.cuda.empty_cache()
    phase_header(f"phase 19: tensor parallelism over model — "
          f"{', '.join(a for a, _ in RANK_TP_FAMILIES)} at their published widths "
          f"on {RANK_TP_MODEL} gloo ranks sharing the card (data 1 x model "
          f"{RANK_TP_MODEL}), served and trained against meshless runs",
          flush=True)
    rank_tp = run_rank_tp(dev, args.seed, card)
    for row, name in ((flash_row, "flash_mha_fwd"), (bwd_row, "flash_attention_bwd"),
                      (decode_row, "flash_decode")):
        row["launches_by_path"]["rank_tp"] = rank_tp["launches"][name]
        row["launches"] += rank_tp["launches"][name]
    for row in rank_tp["rows"]:
        print_kernel_row(row)
    variants += rank_tp["rows"]
    print(json.dumps({"expressions": res["expr_ms"], "launches_per_run":
                      res["per_expr"], "rows": ROWS, "card": card,
                      "build_s": build_s,
                      "udf": {"queries": udf_ms, "rows": UDF_ROWS,
                              "seq": UDF_SEQ, "microbatch": UDF_MICROBATCH,
                              "n_negative": udf["n_neg"],
                              "flash_launches_per_pass": udf["flash_per_pass"],
                              "rows_within_margin": udf["rows_near_margin"],
                              "rows_flash_vs_blocked_differ": udf["rows_differ"]},
                      "serving": serving, "training": training,
                      "runtime": runtime, "mesh_models": mesh_models,
                      "cost_model": cost, "rank_mesh": ranks,
                      "rank_engine": rank_engine, "rank_live": rank_live,
                      "rank_durable": rank_durable, "rank_tp": rank_tp,
                      "relational_variants": variants,
                      "breakdowns": res["breakdowns"], "live": live,
                      "strings": strings, "durable": durable,
                      "mesh": {"shards": MESH_SHARDS,
                               "launches": mesh["launches"],
                               "launches_per_run": mesh["per_expr"],
                               "notes": mesh["notes"], "live": mesh["live"],
                               "sweep": mesh["sweep"],
                               "seconds": mesh["seconds"]}}))
    print(json.dumps({"kernels": [{k: v for k, v in d.items() if k != "shape"}
                                  for d in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
