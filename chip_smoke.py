#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port, `bflc_demo_tpu_torch`.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports no JAX and nothing of the JAX package.  Phases, one JSON line
each, with `t`, the seconds since the script started; any failure raises
and exits non-zero, and every failing gate first prints one line
`{"phase": "gate_failed", "leg", "gate", "value", "bar"}`.  Every fleet
leg with an accuracy bar prints an `accuracy` line: each evaluation, the
first at the bar and the evaluations to spare after it.

1. build   — compile every kernel from the sources in this checkout
             (one nvcc per source, started together) and, beside them,
             the native ledger (one g++);
2. device  — the card's name and power limit, as nvidia-smi reports them;
   native_ledger — a config-5 chain (50 rounds) applied op by op into
             fresh native and python ledgers: µs an applied op of each,
             heads, state bytes and digests held equal, `auto` native;
3. compare — each kernel against its plain PyTorch version on the same
             card tensors, float32 and bfloat16, at the transformer's
             training and scoring shapes, at a multi-tile shape (S = 256)
             with ragged padding and one fully masked 64-key tile, at
             a batch of 32 and at the mesh round's stacked shapes
             (320 and 6400 rows) — between them the 1-, 2- and 4-warp
             blocks of the forward, dK/dV and dQ kernels;
4. timing  — each kernel, its plain version and one PyTorch call as the
             yardstick (the forward: scaled_dot_product_attention; the
             dK/dV + dQ pair: SDPA's backward, which computes all three),
             at the training shape, and the forward also at the
             committee's score shape (B = 160), and all three at the mesh
             round's shapes (training 320, scoring 6400, sponsor 800);
             device time per call from CUDA-graph replays between CUDA
             events (warmup, then the median of several repeats), beside
             the bound, its share and TFLOP/s;
5. slice   — the config-5 federated round on the host runtime, full width,
             5 rounds (the preset's own count) on `cuda`, with the launch
             counts reset just before and read just after; then the
             final model's logits on the card against the CPU path on a
             small input; and the decisions of the model after round 2
             (from a second, 2-round run) and of the final one
             (accuracies of the sponsor's test set and of every client's
             shard) against the CPU path's on the same params;
   mesh    — the same preset on the mesh runtime (one device round per
             protocol round: 20 clients in lockstep, one stacked scoring
             pass, payload ids by the fingerprint kernel), 5 rounds, launch
             counts reset just before and read just after and held to
             K1 24, K2 20, K3 20 and fingerprint 2 a round; the decisions
             of its final model against the CPU path's; then config 1 —
             the CLI's default — for 10 rounds on the mesh runtime and 10
             on the host runtime (round times of both), its final model
             against the CPU path; every in-process leg's ledger held to
             the backend the reference runs there (native);
   dispatch — configs 1 and 5 on the mesh runtime, 10 rounds in
             dispatches of 5 (`rounds_per_dispatch`: the uploader draw,
             the election and the sponsor's evaluation on the card) with
             the card's sync debugging at "error" inside each dispatch,
             launch counts reset just before and read just after and
             held to 10 times the mesh round's, the ledger's audit of
             every round; config 1's final model against the CPU path
             and its bar, config 5's sponsor decisions against the CPU
             path's; then one config-5 round under ring scoring (launches
             K1 22, K2 20, K3 20, B6 2), the dense matrix's committee x
             uploader entries within one example of the committee path's
             on the same params and deltas with the same selection, and
             K1 at the ring's shape (64000, 64, 4, 32) against its plain
             version and timed beside SDPA and its bound;
   knobs   — the model and training knobs on the mesh runtime
             (`knobs_phase`), each between a reset and a read of the
             launch counts: `bf16_config5`, config 5 with
             `make_transformer_classifier(dtype=torch.bfloat16)` (float32
             params, bfloat16 compute), 10 rounds, and `moe_config5`,
             config 5 with a 4-expert MoE MLP (float32; its parameter
             count held to the reference layout's 1,326,594), 10 rounds:
             each held to the mesh round's launches, every K1-K3 launch
             at the leg's dtype at the training, score and sponsor
             batches (K1) and the training batch (K2, K3), and each such
             (kernel, shape) held once against its plain version on the
             inputs of the path's last launch there; the final
             model's decisions against the CPU path's (the dtype's TOL);
             warm round seconds, peak memory and the accuracy (no bar);
             then `optim_checkpoint_config1`, config 1 with momentum SGD
             (lr 0.001, momentum 0.9), 5 rounds checkpointed through the
             preset, the CLI's `--checkpoint-dir D --checkpoint-every 5`
             in this process (its line, its checkpoint at its head), the
             checkpoint loaded (head verified) and 5 rounds resumed to
             epoch 10 with their own checkpoint, a tampered copy refused,
             B6 2 a round; the bfloat16 timing rows of K1 (training,
             score and sponsor batches) and K2/K3 (training batch) run in
             phase 4 beside SDPA in bfloat16;
   presets — configs 0, 2, 3 and 4 (`PRESET_RUNS`), each run between a
             reset and a read of the launch counts (fingerprint 2 a mesh
             round, nothing else) and held to the reference tests' bar:
             config 0 at its preset on the mesh and host runtimes, 3
             rounds, the ledger's size; config 2 on the mesh runtime at
             the heavy test's geometry (n_data 2400, 20 clients,
             Dirichlet 0.5), 12 rounds, best accuracy above 0.5; config 3
             with active participation at the heavy test's geometry (30
             clients, committee 3, 5 uploaders, n_data 3000), 8 rounds,
             above 0.4, and at the full preset (100 clients, n_data
             20000), 2 rounds, the ledger's size; config 4 at the full
             preset (ResNet-18, CIFAR-100 shapes, 32 clients, active,
             client_chunk 4, remat), 2 rounds, the ledger's size.  Round
             times, accuracies, launches and peak device memory per run,
             beside the card's name and power limit; then the trained
             config-2 model's logits and decisions on the card against
             the CPU path's on all of config 2's rows;
   secure  — the secure rounds and the HMAC keyring (`secure_phase`),
             each leg between a reset and a read of the launch counts:
             `secure_config4`, config 4 at the full preset with
             `secure=True` (32 X25519 wallets, masked merges on B7,
             attestation on) through the CLI's entry point in this
             process (`main(["--config", "config4", "--secure",
             "--rounds", "2"])`: exit 0, its JSON's rounds and ledger
             size), from `mesh_config4`'s seed — its first round's
             committee, uploaders and selection equal `mesh_config4`'s
             (later rounds printed, with the first that differs: a
             decision may flip on the fixed point's rounding), its
             ledger's size that run's, its final parameters within
             SECURE_C4_PARAM_TOL of that run's, B6 2 and B7 1 (one
             launch over the 62 leaves) a round; every merge within the
             fixed point's bound of the plain weighted mean of the same
             deltas; on the last round's
             B7 inputs the sum over the slots of every leaf's masked
             words equals the sum of the unmasked fixed-point words bit
             for bit, B7's words equal its plain version's on every leaf
             under 1 M elements and on the last 1 M of each larger one,
             and no slot's masked word equals its unmasked one on more
             than SECURE_BLIND_SHARE of a leaf; each round's pair-seed
             seconds; B7 timed at the round's one launch and at the
             largest leaf's one-leaf launch beside the bound (integer
             operations, each pair's mask once, against bytes), the
             floors its SASS implies and the plain version, and its
             SASS counted by pipe on a line of its own;
             `secure_dispatch_config5`, config 5 with 20 DH wallets at
             `rounds_per_dispatch` 5, 10 rounds — the same gates against
             `dispatch_config5` (parameters within SECURE_C5_PARAM_TOL),
             K1-K3, B6 and B7 held to the mesh round's counts plus B7's
             one launch over the 30 leaves a round, B7 timed at its
             shape;
             `keyring_threaded_config5`, the threaded runtime at config 5
             with an HMAC `KeyRing`, 3 rounds — every client op on the
             chain authenticated, a forged tag, a replayed tag, a
             client's tag on another's address and a forged registration
             refused, K1-K3 launched (the full script runs this leg in
             a child process, `--keyring-leg`, beside `executor_config5`,
             whose round waits on its members most of the time; its line
             is printed again by this process);
   fingerprint — the fingerprint kernel against its plain version on the
             card, bit for bit (float32, bfloat16, float16, int8, bool and
             int32 leaves, a ragged leaf, config 5's 20 stacked deltas, a
             config-1 model, and the active slots' deltas of configs 3
             and 4 — 14 FEMNIST CNNs and 16 ResNet-18s, whose plain chain
             runs on CPU copies of the same values); its time at config
             5's 20 deltas, one config-5 model and the config-3 and
             config-4 deltas beside the bytes bound and the chain bound
             (the measured latency of one dependent multiply-xor times
             the steps of a lane's chain);
6. compare — the ring's carry kernel (`flash_carry`) against its plain
             version over two chained hops, float32 and bfloat16, at
             S = 256 (ragged keys, one fully masked 64-key tile) and at
             the sp training shard (folded batch 32, S = 1024);
7. timing  — `flash_carry` and its plain version at that shard; beside
             it, on the same (4, 8192, 4, 32) sequence, the 8-hop ring
             forward, the flash forward unsharded (a timing row of its
             own) and PyTorch's SDPA; and on that sequence the dK/dV and
             dQ kernels, their plain versions and the pair beside SDPA's
             backward (the sp path's dense oracle runs them there);
8. sp      — the sequence-parallel transformer at config 5's width on
             the folded axis (8 shards), launch counts reset just before
             and read just after: 3 SGD steps at seq 8192 (batch 4) and a
             forward at seq 32768 (batch 2); then the 32k logits against
             the dense forward (flash forward kernel) and the first 8k
             step against one dense SGD step (flash kernels forward and
             backward);
9. merge   — the certified merge engine (`meshagg`), kernel B5: B5
             against its plain version and the numpy spec (REDUCTION
             SPEC v2's host leg), byte for byte, on every corner case of
             the CPU tests (blocks 1, 2, 5, 8, 64) and at the merge
             geometries (config 5's and config 4's writer merges, the
             reference benchmark's full drains of 64, 256 and 1024
             deltas; blocks 1 and 8); then, between a reset and a read of
             the launch counts, the engine's `aggregate_rows` once per
             geometry and block count (one launch per block per call; its
             bytes against the host leg's) and
             `python -m bflc_demo_tpu_torch.meshagg.check --device cuda`
             in-process; then B5's time per call beside its bytes bound,
             its chain bound (N times one slot's dependent step, timed
             by a one-thread chain kernel), its plain version and
             `c @ mat` (one PyTorch call for the same weighted sum, not
             bit-exact), and `aggregate_rows` end to end with its
             host-to-device staging.

10. processes — the process fleet on the card (`client/process_runtime`:
             a writer process with the socket ledger, client processes
             over the wire frames, replica processes, this process as
             the sponsor; every role on `cuda`), each writer merging
             through B5 (`BFLC_MESH_AGG_MIN=1`: the engine's mesh leg
             every round, after its self-check) and every process tracing
             (`BFLC_PROC_TRACE=1`), launch counts reset just before each
             run and read from every role just after: the reference's own
             process test (tests/test_netledger.py:29-31, :319-331: 6
             clients, committee 2, 3 admitted, top-2, lr 0.05, batch 16,
             250-row occupancy shards, 3 replicas, 4 rounds, best above
             0.85); config 1 at its preset (20 clients) through
             `python -m bflc_demo_tpu_torch --config config1 --runtime
             processes` as a subprocess, 10 rounds, at config 1's bar
             (started with the executor's CLI line before the process
             test, the three fleets side by side);
             config 5 at full width, 9 rounds, best 0.9, K1-K3 launched
             in the clients; and the crash case (:333-357: clients 0 and
             5 die at epoch 1), `recovered_clients == [0, 5]`.  Each run
             holds every replica at the writer's head, the writer's engine
             on the mesh leg with its self-check passed and B5 launched
             past the self-check's launches; it prints the round times
             from `epoch_times` and from the writer's commit record
             (`merge_log`), each merge's seconds, the spawn time, the
             boot steps of the writer and the clients (`boot`), the
             seconds to the end of each step after the rounds
             (`phase_s`), the writer's phase split
             (`aggregate_s`, `aggregate.engine_s`, signature checks) and
             the clients' (train, score, signing), beside the card's name
             and power limit.  Then writer failover: (a) in threads, a
             writer and a standby on `cuda` at config 5's protocol and
             width (P = 535,298, 10 admitted deltas, quorum-ack 1), the
             writer closed after the uploads, the scores committing on
             the promoted standby through B5: its model bytes against
             the CPU host leg's over the same signed script, its B5
             launches (at least 1), the promotion's and the first
             merge's seconds and each upload's reply seconds with and
             without the standby; (b) the reference's process drill
             (tests/test_failover.py:293-315: 1,500 rows, 1 standby, the
             primary SIGKILLed at epoch 2 of 4, 1 replica; best above
             the process test's 0.85, where the reference asks 0.80); (c)
             config 5 at full width with 2 standbys, quorum-ack 1 and the
             kill at epoch 2, 9 rounds, best 0.9, K1-K3 in the clients.  Each drill holds the replica at the promoted
             writer's head and every merge after the kill to B5, and
             prints the kill's epoch, the promotion's seconds, the
             failover gap (SIGKILL to the promoted writer's first
             commit), that merge's seconds and the warm ones, the rounds
             before and after the kill, the primary's quorum waits, the
             standby's mirror work, both writers' send bytes and seconds
             and where the clients' reads were served; B5's launches by
             writer role ride the `kernels` line (`launches_by_role`).
             Then BFT commit certificates (`comm/bft.py`, 4 validator
             processes re-executing and co-signing every op, the writers
             merging at the genome's block count): (d) `bft_drill`, the
             drill of (b) with reduce_blocks 2 — the promoted standby
             certifies its fence op; (e) `bft_config5`, config 5 at full
             width with reduce_blocks 8, 9 rounds, best 0.9.  Each holds
             `certified_size == log_size`, every writer's B5 launches past
             its self-check to B a merge (role `bft_writer`), and every
             validator process to no torch import (so no CUDA context),
             and prints the spawn seconds (the validators' apart), the
             round times, the writer's certify seconds a round (batched
             and single-op) and the ops it certified a round, the warm
             merge's milliseconds and the clients' K1-K3 a round.
             Then TLS and certified snapshots: (f) `tls_snapshot_config5`,
             config 5 over TLS with 4 validators at 8 blocks, a standby,
             a certified snapshot every 2 rounds and the primary
             SIGKILLed after epoch 4 of 9 — best 0.9,
             `certified_size == log_size`, the final writer's log base
             above 0, the promoted standby GC'd before it promoted and
             merges on B5 from its compacted ledger, every artifact
             verifies under the validators' keys, both WALs start with
             BFLCWAL2 and the promoted writer's replays to the final
             head, a plaintext client is refused; it prints the TLS
             handshakes and `wire.*` a round beside `bft_config5`'s, the
             snapshot ops, GC'd ops and the artifacts' bytes and write
             seconds; (g) `snapshot_rejoin` (`eval/snapshot_drill.py`):
             a SIGKILLed standby and an empty validator rejoin past the
             GC base by state-sync, the standby promotes and merges the
             next round on B5 with the CPU leg's bytes, the validators
             at its head, a forged offer refused.
             Then async FedBuff: (h) `async_config5`, config 5 at full
             width with `async_buffer` 10, `max_staleness` 20, a
             committee reseat every 2nd drain, 4 validators at 8 blocks,
             a standby, a replica, a snapshot every 2 epochs and the
             primary SIGKILLed after epoch 3 of 14 (`async_phase`: its
             gates, and an `async` line with the drains' depths and
             staleness, the aupload replies by status, the certify
             seconds an epoch, the warm drain's milliseconds beside B5's
             own at that geometry, the failover gap and the leg's
             seconds).
             Then the upload codecs, every client with error feedback
             (`codecs_phase`): (i) `sparse_config5`, `bft_config5`'s
             fleet with top-k at density 0.01 in i8 and a standby, 9
             rounds — every op certified with no `SPARSE` refusal, B5 8 a
             merge on the decoded rows, K1-K3 in the clients by the
             arithmetic, the writer's ingress a round at least 3x below
             `bft_config5`'s in the same script, best 0.9; (j)
             `sketch_async_drill`, the reference process test's geometry
             async (K 3) with the count-sketch at density 0.5 in f16, 4
             validators at 2 blocks, 6 epochs — every drain on B5 (2 a
             drain), the replica at the head, no accuracy bar
             (SKETCH_MIN_BEST: no density below 1 clears the drills' 0.85
             run after run; its accuracy is printed).
             Each prints a `codecs` line: the clients' encode ms an
             upload, the writer's admission decode ms a blob, the blob
             bytes an upload beside the dense blob's, `wire.*` a round
             beside `bft_config5`'s, the warm merges beside B5's ms at the
             leg's geometry (its share) and the leg's seconds.
             Then hierarchical cells (`hier_phase`, every partial and root
             merge on B5): (k) `hier_config5`, config 5 at full width in
             4 cells of 5 through the preset's entry point (the CLI's
             `--cells 4 --bft-validators 4 --delta-dtype i8
             --delta-density 0.01 --delta-codec topk --error-feedback`),
             14 root rounds — every root op certified, at most 2 x
             (cells + 1) root ops a round and none from a member, B5 1 a
             partial in every cell and 1 a root merge, K1 in the
             aggregators (their score of the root's candidates) and
             K1-K3 in the members, the root's ingress a round at least 3x
             below a dense partial's bytes, no validator refusal and no
             BAD_ARG reply to a bridge, best 0.9; (l) `hier_rehome_drill`,
             6 clients in 3 cells with 4 validators, cell 1's aggregator
             SIGKILLed at root epoch 1, 8 rounds — the same root gates,
             its two members exit 0 through the sibling, best above 0.85.
             Each prints a `hier` line: the root's ops and `wire.*` a
             round, each cell's partials (ms, B5's engine ms, bytes, its
             K1, the bridge's replies by status), the root's merges.
             Then the validator re-derivation plane: (n)
             `rederive_config5`, config 5 at full width with 4 validator
             processes armed `--rederive shard` at 8 blocks, top-k in i8
             with error feedback on a closed compression loop from
             density 0.1 (`adapt_every` 2, floor 0.01) and a replica —
             the rounds and the bar, no `REDERIVE` or `SPARSE` refusal
             and no skip, every validator re-deriving every commit with
             torch imported and B5 launched (role `validator`), genome
             ops on the chain with every validator's and the replica's
             knobs at the writer's, the density moved; a `rederive` line
             with each validator's re-derivations, seconds and B5.
   rederive_drill — (m), after phase 9, in this process on the card: a
             writer and 4 validators armed `shard` on `cuda` in threads
             at config 5's protocol and width: an honest commit every
             validator re-derives (B5 at least once each; its hash the
             legacy pin's), each validator's shard on the card byte for
             byte the plain version's on a CPU copy and the committed
             leaves, a lie at one leaf refused on a sync commit and on an
             async drain with one colluding validator, a NaN delta
             refused, withheld evidence a counted skip that certifies;
             B5's time at one shard's geometry and the full model's
             (timing rows `rederive_shard`, `rederive_full`) beside the
             bound, the plain version and `c @ mat`.

Then the `kernels` line and, last, {"ok": true, "device": {...}}.
Without a card, or without the package beside it, it exits non-zero and
prints no result.

    python3 chip_smoke.py --backward-timing DIR

runs only the dK/dV and dQ timing rows (phase 4's and phase 7's) for the
package of the checkout at DIR — another version's, unpacked beside this
one, so that two versions are timed on one card in one call.

    python3 chip_smoke.py --keyring-leg

runs only `keyring_threaded_config5` on kernels already built (the full
script's child beside `executor_config5`).

    python3 chip_smoke.py --merge-timing DIR

runs only B5's timing rows (phase 9's: every merge geometry at blocks 1
and 8, beside the bytes bound, the chain bound where DIR's package has
the chain kernel, and `c @ mat`) for the package of the checkout at DIR,
the same way.

    python3 chip_smoke.py --processes

runs only the build and phase 10, the process fleet and its failover
runs.

    python3 chip_smoke.py --snapshots

runs only the build, the BFT legs (d, e) and the TLS and snapshot legs
(f, g).

    python3 chip_smoke.py --async

runs only the build and the async FedBuff leg (h).

    python3 chip_smoke.py --codecs

runs only the build, `bft_config5` (the dense twin) and the codec legs
(i, j).

    python3 chip_smoke.py --hier

runs only the build and the hier legs (k, l).

    python3 chip_smoke.py --rederive

runs only the build and the rederive legs (m, n).

    python3 chip_smoke.py --dispatch

runs only the build, the native ledger's line and the dispatch phase.

    python3 chip_smoke.py --knobs

runs only the build, the bfloat16 timing rows and the knob legs.

    python3 chip_smoke.py --secure

runs only the build, the plain legs the secure legs are held against
(`mesh_config4`, `dispatch_config5`) and the secure phase.

Every fleet leg's line names its final writer's ledger backend
(`writer_backend`), held to the one the reference runs at that leg's
configuration (`reference_backend`).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import statistics
import struct
import subprocess
import sys
import threading
import time

import numpy as np

T0 = time.perf_counter()

# the card's published peaks (NVIDIA H100 SXM data sheet; dense rates).
# float32 products at float32's accuracy have two routes: the CUDA cores
# (67 TFLOP/s) or 3xTF32 on the tensor cores (three TF32 products each,
# 495 / 3 = 165 TFLOP/s; TF32 alone is not float32-accurate).  The bound
# names the faster; rows keep the CUDA-core bound beside it.
HBM_BYTES_PER_S = 3.35e12
F32_CUDA_CORE_OPS = 67e12
PEAK_OPS = {"float32": max(F32_CUDA_CORE_OPS, 495e12 / 3),
            "bfloat16": 989e12}

TRAIN_SHAPE = (16, 64, 4, 32)        # config-5 trainer batch: B, S, H, D
SCORE_SHAPE = (160, 64, 4, 32)       # config-5 committee scoring batch
MULTI_SHAPE = (4, 256, 4, 32)        # several 64-tiles each way
PAIR_SHAPE = (32, 64, 4, 32)         # the forward's two-warp blocks
MESH_TRAIN_SHAPE = (320, 64, 4, 32)  # mesh round: 20 clients x batch 16
MESH_SCORE_SHAPE = (6400, 64, 4, 32)  # 4 scorers x 10 candidates x 160 rows
SPONSOR_SHAPE = (800, 64, 4, 32)     # the sponsor's test set
AGG_SCORE_SHAPE = (128, 64, 4, 32)   # a cell aggregator's root score
ATTEST_SCORE_SHAPE = (1600, 64, 4, 32)  # a member's re-score: 10 x 160
# every kernel's block geometry follows the shape (launch_warps): on an
# H100 the training batch and MULTI_SHAPE take one-warp blocks, PAIR_SHAPE
# two and the score (and sponsor) batch four, for the forward, dK/dV and
# dQ alike (S_kv = S_q); the compare phase covers each
DENSE_SHAPES = (TRAIN_SHAPE, MULTI_SHAPE, PAIR_SHAPE, SCORE_SHAPE,
                MESH_TRAIN_SHAPE, MESH_SCORE_SHAPE, AGG_SCORE_SHAPE,
                ATTEST_SCORE_SHAPE)
BIG_FEW = dict(calls=5, replays=2, repeats=5)   # device_ms at 6400 rows
# attention inputs of this many elements a tensor and more are drawn on
# the card (the sponsor's 800 rows and up): a numpy draw of config 5's
# score batch takes 2-5 s a tensor set
DEVICE_DRAW_ELEMENTS = 1 << 22
SHARD_SHAPE = (32, 1024, 4, 32)      # sp training shard: 8 shards x B 4
RING_SHAPE = (4, 8192, 4, 32)        # the same sequence, unsharded
RING_FEW = dict(calls=2, replays=2, repeats=3)   # device_ms at RING_SHAPE
TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # x max(1, max|plain|)
# config 5's preset runs 5 rounds (eval/configs.py), from the reference's
# initial model (`init_params(0)` draws jax.random's values).  On the CPU
# its best over 5 rounds is 0.9862 on the mesh runtime (the reference's
# own trajectory) and 0.9987 on the host runtime; the 0.9 limit stands.
# See PERF.md section 2.
ROUNDS = 5
MIN_BEST_ACC = 0.9
# config 5's synchronous process fleets (plain, failover, BFT, TLS,
# sparse) run 9 rounds against the same limit.  The host run's own
# trajectory swings round to round (0.66, 0.99, 0.55, 0.63, 0.9975), and
# a fleet admits the first uploads to arrive, so its rounds differ run to
# run: over 7 rounds the fleets first reached 0.9 at evaluations 1-5 in
# earlier card runs, so 7 left as few as two evaluations after the
# first at the bar; 9 leave four.  See PERF.md sections 6-7.
FLEET_C5_ROUNDS = 9
SP_RUNS = {"train": dict(seq_len=8192, n_sp=8, batch=4, steps=3, lr=0.05),
           "forward": dict(seq_len=32768, n_sp=8, batch=2, steps=0)}
# the sp logits vs the dense forward: the reference's own 8k oracle bound
# moved onto the card (tests/test_long_context.py:90-101), loosened for
# the card's summation orders
SP_LOGITS_TOL = dict(rtol=1e-4, atol=1e-5)
# one sp step vs one dense step: new params within the reference's own
# 4k-step bound (tests/test_long_context.py:186-187); the gradients they
# imply, (old - new) / lr, within 1e-3 of each leaf's largest dense
# gradient — both sides are float32 and differ only in summation order
# (ring hops vs flash tiles, 8192-long reductions; 3.5e-5 measured on an
# H100), while a wrong assembly (a gradient missing a shard, or n_sp
# times too large) is off by O(1)
SP_STEP_TOL = dict(rtol=5e-4, atol=5e-5)
SP_GRAD_TOL = 1e-3
# the mesh round's launches per round on config 5 (depth 2): 10 minibatch
# steps of all 20 clients, each a forward (K1) and backward (K2, K3) per
# layer; one scoring pass of 40 models (K1 per layer); the sponsor's eval
# (K1 per layer); the ids of the 20 deltas and of the new model
MESH_PER_ROUND = {"flash_fwd": 24, "flash_dkdv": 20, "flash_dq": 20,
                  "flash_carry": 0, "fingerprint": 2, "certified_reduce": 0}
CONFIG1_ROUNDS = 10          # the CLI's default run
CONFIG1_MIN_BEST = {"csv": 0.90, "synthetic": 0.85}  # tests/test_e2e.py
# the presets phase: (path, config, rounds, bar, arguments), each at the
# reference's own bar (tests/test_configs.py): configs 0 at the preset on
# both runtimes; 2 and 3 at the heavy tests' geometries (:192-213); 3 and
# 4 at the full preset
CONFIG2_HEAVY_N_DATA = 2400
PRESET_RUNS = (
    ("mesh_config0", "config0", 3, ("log", 4, 2, 2), dict(runtime="mesh")),
    ("host_config0", "config0", 3, ("log", 4, 2, 2), dict(runtime="host")),
    ("mesh_config2", "config2", 12, ("best", 0.5),
     dict(n_data=CONFIG2_HEAVY_N_DATA)),
    ("mesh_config3_heavy", "config3", 8, ("best", 0.4),
     dict(n_data=3000, cfg=dict(client_num=30, comm_count=3,
                                aggregate_count=3, needed_update_count=5,
                                learning_rate=0.05, batch_size=20,
                                local_epochs=4))),
    ("mesh_config3", "config3", 2, ("log", 100, 10, 4), dict()),
    ("mesh_config4", "config4", 2, ("log", 32, 12, 4), dict()),
)
# fingerprint compare cases whose plain chain runs on CPU copies
FP_PLAIN_ON_CPU = ("config3_deltas", "config4_deltas")
# the fingerprint's operations are a 32-bit multiply and xor per word on
# the CUDA cores; 67e12 (their float32 rate) is an upper bound on that
INT_OPS = F32_CUDA_CORE_OPS

KERNELS = {
    "flash_fwd": "bflc_demo_tpu/ops/pallas_attention.py:42",
    "flash_dkdv": "bflc_demo_tpu/ops/pallas_attention.py:153",
    "flash_dq": "bflc_demo_tpu/ops/pallas_attention.py:196",
    "flash_carry": "bflc_demo_tpu/ops/pallas_attention.py:300",
    "fingerprint": "bflc_demo_tpu/ops/fingerprint.py:62",
    "certified_reduce": "bflc_demo_tpu/meshagg/engine.py:260",
    "secure_mask": "bflc_demo_tpu/parallel/secure.py:235",
}
DENSE_KERNELS = ("flash_fwd", "flash_dkdv", "flash_dq")
SOURCES = {name: "bflc_demo_tpu_torch/ops/csrc/flash_attention.cu"
           for name in KERNELS}
SOURCES["fingerprint"] = "bflc_demo_tpu_torch/ops/csrc/fingerprint.cu"
SOURCES["certified_reduce"] = \
    "bflc_demo_tpu_torch/ops/csrc/certified_reduce.cu"
SOURCES["secure_mask"] = "bflc_demo_tpu_torch/ops/csrc/secure_mask.cu"
# B5 at each merge geometry (meshagg/check.py GEOMETRIES): blocks 1 (spec
# v1) and 8, one launch per block; the timing row of the kernels line is
# config 5's writer merge at one block
MERGE_BLOCKS = (1, 8)
MERGE_MAIN = "config5_merge"
# the processes phase: every writer merges on B5 (the engine's mesh leg
# at every batch) and every process traces its phases
FLEET_ENV = {"BFLC_MESH_AGG_MIN": "1", "BFLC_PROC_TRACE": "1"}
# the reference's own process test (tests/test_netledger.py:29-31,
# :319-357): its protocol, 250-row occupancy shards, 500 test rows
FLEET_PROTO = dict(client_num=6, comm_count=2, aggregate_count=2,
                   needed_update_count=3, learning_rate=0.05, batch_size=16)
FLEET_SHARD, FLEET_ROUNDS, FLEET_REPLICAS, FLEET_MIN_BEST = 250, 4, 3, 0.85
FLEET_CRASH = {0: 1, 5: 1}
FLEET_TIMEOUT_S = 300.0
# the failover runs: the reference's process drill (tests/test_failover.py
# :293-315: the fleet's protocol, 1,500 occupancy rows, 1 standby, the
# primary SIGKILLed at epoch 2 of 4, 1 replica, best above 0.80), and
# config 5 at full width with 2 standbys and quorum-ack 1
FAILOVER_ROWS, FAILOVER_ROUNDS = 1500, 4
# the reference's drill asks for 0.80; the card's drills hold the process
# test's 0.85, which every recorded card run cleared (best 0.866-0.878)
FAILOVER_MIN_BEST = FLEET_MIN_BEST
FAILOVER_DRILL = dict(standbys=1, kill_writer_at_epoch=2, replicas=1,
                      stall_timeout_s=20.0)
CONFIG5_FAILOVER = dict(standbys=2, quorum=1, kill_writer_at_epoch=2,
                        replicas=1)
CONFIG5_PROTO = dict(client_num=20, comm_count=4, aggregate_count=6,
                     needed_update_count=10, learning_rate=0.05,
                     batch_size=16, local_epochs=1)
CONFIG5_ARCH = dict(vocab_size=1000, seq_len=64, num_classes=2, dim=128,
                    depth=2, heads=4)
# the BFT runs: the reference's 4-validator geometry (f = 1), the drill at
# two blocks and config 5 at eight, over the config-5 fleets' 9 rounds
BFT_VALIDATORS = 4
BFT_DRILL_BLOCKS, BFT_CONFIG5_BLOCKS = 2, 8
# the merge legs of the engine's kernel route: "blocked" is B5 at two
# blocks or more
B5_LEGS = ("mesh", "blocked")
CONFIG5_PARAMS = 535_298
# TLS and certified snapshots: config 5 over TLS with the BFT
# run's validators and blocks, one standby (the CLI line `--standbys 1`;
# quorum-ack would need a second, the reference's Q + 1 rule, and
# `failover_config5` holds quorum-ack on the card already), a certified
# snapshot every 2 rounds, the primary SIGKILLed after epoch 4 of 9,
# artifacts and WALs under WORK_DIR (inside the checkout, gitignored);
# then the snapshot rejoin drill (`eval/snapshot_drill.py`)
TLS_SNAPSHOT = dict(bft_validators=BFT_VALIDATORS, standbys=1,
                    kill_writer_at_epoch=4, snapshot_interval=2,
                    replicas=1)
TLS_SNAPSHOT_EPOCHS = [2, 4, 6, 8]   # the snapshot ops' epochs in 9 rounds
# async FedBuff (`async_config5`): config 5 at full width with the
# reference's async headline buffer (K = 10, max staleness 20), a
# committee reseat every 2nd drain, the BFT run's 4 validators at 8
# blocks, a standby, a replica, a snapshot every 2 epochs and the primary
# SIGKILLed after epoch 3 of 14, plaintext.  The stall timeout outlasts
# every gap of the run, so no recovery drain of k < K enters the chain.
# 14 epochs: drains land ~1 s apart and the sponsor evaluates the model
# it finds when it polls (the reference's loop), so it saw 3-5 of 7
# epochs and first reached 0.9 at epochs 2-7 in earlier card runs; 14
# leave evaluations to spare after epoch 7 (PERF.md section 6)
ASYNC_EPOCHS = 14
ASYNC_SNAPSHOT_EPOCHS = [2, 4, 6]
ASYNC_PROTO = dict(async_buffer=10, max_staleness=20, async_reseat_every=2,
                   reduce_blocks=BFT_CONFIG5_BLOCKS)
ASYNC_FLEET = dict(bft_validators=BFT_VALIDATORS, standbys=1, replicas=1,
                   snapshot_interval=2, kill_writer_at_epoch=3,
                   stall_timeout_s=30.0)
# the upload codecs: (i) `sparse_config5`, `bft_config5`'s fleet (4
# validators at 8 blocks) with the reference's sparse headline codec —
# top-k at density 0.01 with i8 values — the clients' error feedback and
# a standby (without quorum-ack, which needs a second standby by the
# reference's Q + 1 rule), 9 rounds; its writer's ingress a round at
# least 3x below `bft_config5`'s (the reference's sparse-fleet ratio,
# tests/test_sparse.py:481-530) and its best at least SPARSE_MIN_BEST;
# (j) `sketch_async_drill`, the reference process test's geometry async
# (K 3, max staleness 20) with the count-sketch at density 0.5 in f16
# and error feedback, 4 validators at 2 blocks, 6 epochs
CODEC_ENV = {"BFLC_ERROR_FEEDBACK": "1"}
SPARSE_PROTO = dict(delta_density=0.01, delta_codec="topk",
                    delta_dtype="i8", reduce_blocks=BFT_CONFIG5_BLOCKS)
SPARSE_FLEET = dict(bft_validators=BFT_VALIDATORS, standbys=1, replicas=1)
SPARSE_INGRESS_RATIO = 3.0
SKETCH_PROTO = dict(async_buffer=3, max_staleness=20,
                    reduce_blocks=BFT_DRILL_BLOCKS, delta_density=0.5,
                    delta_codec="sketch", delta_dtype="f16")
SKETCH_FLEET = dict(bft_validators=BFT_VALIDATORS, replicas=1,
                    stall_timeout_s=30.0)
SKETCH_EPOCHS = 6
# the bars, from the CPU trajectories of both packages at these settings
# (`tests/codec_trajectory.py`; PERF.md section 6): config 5 at density
# 0.01 passed 0.9 by round 1 in both (best 0.99625 port, 0.9975
# reference), so the config-5 fleets' bar holds (above the reference's
# sparse-fleet bar of 0.5).  The sketch drill holds no accuracy bar
# (None): its softmax regression has a 10-entry weight leaf and a
# 2-entry bias, which no density below 1 sketches without losing what
# the model learns.  At 0.1 (one bucket a leaf) both packages stay at the
# test set's majority rate, 0.768; from 0.5 to 0.6 the best of 8 async
# epochs lies at 0.84-0.878 (the dense drill's own ceiling is ~0.88),
# so FLEET_MIN_BEST fails one run in five; at 0.7-0.9 it swings between
# the two constant predictors.  The leg is held on its bytes, drains and
# certificates, and prints its accuracy
SPARSE_MIN_BEST = MIN_BEST_ACC
SKETCH_MIN_BEST = None
# hierarchical cells (`hier/`): (k) `hier_config5`, the command
# `python -m bflc_demo_tpu_torch --config config5 --runtime processes
# --cells 4 --bft-validators 4 --delta-dtype i8 --delta-density 0.01
# --delta-codec topk --error-feedback` with the preset's protocol
# (CONFIG5_PROTO) — 20 members in 4 cells of 5 (each cell: committee 2,
# 3 admitted, 3 merged; the root: 2 cells on the committee, 2 partials
# merged, f32 over the sparse bridge), 4 validators at the root, 14
# rounds; (l) `hier_rehome_drill`, the reference
# process test's protocol on 1,500 occupancy rows, 6 clients in 3 cells,
# dense, 4 validators, cell 1's aggregator SIGKILLed at root epoch 1
# (cell stall 3 s, root stall 5 s, the reference's drill), 8 rounds.
# The bars, from the CPU trajectories of both packages at these
# settings (`tests/hier_trajectory.py`, PERF.md section 6): config 5
# holds MIN_BEST_ACC, over 14 rounds, since at the sync fleets' 9 a run
# of each package first reached 0.9 at its last evaluation (a cell
# merges every admitted delta, the root both partials: no selection
# damps a round's swing); the drill holds FLEET_MIN_BEST (above) over 8
# rounds, since at 5 a run of each package first passed 0.85 at its
# last evaluation or never (best 0.848-0.852).  A root round is the trainer
# cells' uploads, the committee cells' scores and the commit: at most
# 2 x (cells + 1) root ops
HIER_CELLS, HIER_C5_ROUNDS = 4, 14
HIER_PROTO = dict(delta_density=0.01, delta_codec="topk", delta_dtype="i8")
HIER_MIN_BEST = MIN_BEST_ACC
HIER_INGRESS_RATIO = 3.0
HIER_DRILL_CELLS, HIER_DRILL_ROUNDS = 3, 8
HIER_DRILL = dict(bft_validators=BFT_VALIDATORS, kill_cell_at_epoch={1: 1},
                  stall_timeout_s=3.0, root_stall_timeout_s=5.0)
HIER_DRILL_MIN_BEST = FLEET_MIN_BEST
# the validator re-derivation plane: (m) `rederive_drill`, in this
# process on the card (config 5's protocol and width, 4 validators armed
# `shard` on `cuda`); (n) `rederive_config5`, config 5's fleet at full
# width with 4 validators armed `shard` at 8 blocks, a sparse genome
# (top-k in i8 with error feedback) whose closed loop starts at density
# 0.1 (the reference drill's cap) and may step down every 2 rounds to
# 0.01, one replica.  Rounds and bar from the CPU trajectories of both
# packages (`tests/rederive_trajectory.py`, PERF.md section 6)
REDERIVE_VALIDATORS = BFT_VALIDATORS
REDERIVE_PROTO = dict(delta_density=0.1, delta_codec="topk",
                      delta_dtype="i8", reduce_blocks=BFT_CONFIG5_BLOCKS,
                      adapt_every=2, density_floor=0.01)
REDERIVE_FLEET = dict(bft_validators=BFT_VALIDATORS, rederive="shard",
                      replicas=1)
REDERIVE_C5_ROUNDS = 9
REDERIVE_MIN_BEST = MIN_BEST_ACC
# the drill's certification budgets: an honest config-5 commit (each
# validator fetches the selected deltas and re-derives: 3.3 s on the
# card with a cold connection, chip run 1) certifies well inside the
# first; a refused one (a lie, a NaN) gives up after the second
REDERIVE_DRILL_TIMEOUT_S, REDERIVE_LIE_TIMEOUT_S = 10.0, 3.0
# the mesh executor: (o) `executor_config5`, config 5 at full width
# through the preset's entry point on runtime="executor" over TLS (20
# thin client processes that stage their shards once, the executor
# process running every round as one program, each committee member
# re-scoring the K candidates on its own shard and signing its row),
# EXECUTOR_C5_ROUNDS rounds, from the CPU trajectories of both packages
# (`tests/executor_trajectory.py`, PERF.md section 6); (p)
# `executor_attest_drill`, executors in threads of this process on the
# card at the reference test's 6-client protocol (FLEET_PROTO,
# tests/test_mesh_executor.py:17-19): the stage refusals, an honest
# attested round, a tampering executor (its members refuse within
# EXECUTOR_TAMPER_TIMEOUT_S), then the in-process mesh runtime at config
# 5 with wallets, EXECUTOR_MESH_ROUNDS rounds; and the CLI line, config
# 1 on the executor runtime for EXECUTOR_CLI_ROUNDS rounds
EXECUTOR_C5_ROUNDS = 10
EXECUTOR_MIN_BEST = MIN_BEST_ACC
EXECUTOR_TAMPER_TIMEOUT_S = 3.0
EXECUTOR_MESH_ROUNDS = 2
EXECUTOR_CLI_ROUNDS = 3
EXECUTOR_MASTER_SEED = b"attest-master-0001"    # the reference test's
# config 5's launches a training (10 minibatches of 16 of a 160-row
# shard, a forward and a backward per layer, depth 2) and a forward's
# (a scored entry, a sponsor evaluation)
ASYNC_K_TRAIN, ASYNC_K1_FORWARD = 20, 2
# the executor's launches a round: the mesh round's without the
# sponsor's evaluation, which runs in the sponsor's process
EXECUTOR_PER_ROUND = dict(MESH_PER_ROUND, flash_fwd=MESH_PER_ROUND[
    "flash_fwd"] - ASYNC_K1_FORWARD)
B5_SELFCHECK_LAUNCHES = 6            # the engine's self-check: 1 + 5 blocks
# the multi-round dispatch (`--dispatch`): configs 1 and 5 on the mesh
# runtime, 10 rounds in dispatches of 5 (the uploader draw, the election
# and the sponsor's evaluation on the card, no host sync inside a
# dispatch), each dispatch's launches R times the round's; and one config-5
# round under ring scoring, every client scoring every candidate: K1 at
# 20 scorers x 20 candidates x 160 rows
DISPATCH_ROUNDS, DISPATCH_R = 10, 5
RING_SCORE_SHAPE = (64000, 64, 4, 32)
# the ring round's launches: the mesh round's without the sponsor's
# evaluation (the one-round program does not evaluate)
RING_PER_ROUND = EXECUTOR_PER_ROUND
# config 1's dispatch bar: on the CPU both packages' trajectories at
# R = 5 over seeds 0-4 (`tests/test_torch_dispatch.py::
# test_config1_dispatch_bar_has_evaluations_to_spare`, equal bit for
# bit) first reach 0.85 at evaluation 2 of 10, 7 evaluations to spare
# (PERF.md section 6), so the bar is held
DISPATCH_C1_MIN_BEST = CONFIG1_MIN_BEST
# one example of a scorer's 160-row shard: the most the ring's entries
# may differ from the committee's on the card (K1 at another batch)
RING_ENTRY_TOL = 1.0 / 160
# the native ledger's timing: a config-5 chain of this many rounds,
# applied into fresh ledgers of both backends
LEDGER_CHAIN_ROUNDS = 50
# the model and training knobs (`knobs_phase`): config 5 on the mesh
# runtime in bfloat16 and with a 4-expert MoE MLP, KNOB_ROUNDS each, every
# round the mesh round's launches (MESH_PER_ROUND); config 1 with momentum
# SGD, OPTIM_ROUNDS rounds checkpointed, the CLI's checkpoint line, then
# OPTIM_ROUNDS rounds resumed from the checkpoint.  No accuracy bar: no
# CPU trajectory over seeds backs one for these legs (printed, as
# dispatch_config5's)
KNOB_ROUNDS = 10
MOE_EXPERTS = 4
# the reference's MoE layout at config 5's width (embed 1024 x 128, pos
# 64 x 128, two blocks of 593,408, ln_f, head)
MOE_PARAMS = 1_326_594
OPTIM_ROUNDS = 5
OPTIM_LR, OPTIM_MOMENTUM = 0.001, 0.9
# (kernel, shapes) each leg's path must launch: K1 at the training,
# committee-score and sponsor batches, K2 and K3 at the training batch
KNOB_SHAPES = {"flash_fwd": {MESH_TRAIN_SHAPE, MESH_SCORE_SHAPE,
                             SPONSOR_SHAPE},
               "flash_dkdv": {MESH_TRAIN_SHAPE},
               "flash_dq": {MESH_TRAIN_SHAPE}}
# the secure legs: config 4's secure variant at mesh_config4's rounds and
# seed, the secure dispatch at dispatch_config5's, the keyring leg
SECURE_C4_ROUNDS = 2
SECURE_C5_WALLET_SEED = b"secure-dispatch-config5-0001"
KEYRING_ROUNDS = 3
KEYRING_MASTER_SEED = b"keyring-threaded-master-0001"
# B7 against its plain version on the card: whole leaves below this many
# elements, the last this many of a larger leaf (a numpy-sized draw of
# the whole model costs seconds)
SECURE_WINDOW = 1 << 20
# the share of a slot's elements whose masked word may equal its unmasked
# one: by chance 2**-32 (2.3e-10); 1e-6 allows 11 of config 4's 11.2 M
SECURE_BLIND_SHARE = 1e-6
# the secure runs' final parameters against the plain runs' (max |diff|):
# 5x the largest gap `tests/secure_pair.py` measured between the same
# pair of runs (PERF.md section 6): config 4 0.00456 on the card (both
# rounds' decisions equal); config 5 0.0212 on the card, 0.0137 on the
# CPU.  The fixed point's rounding moves the model by up to S x 2**-17 x
# lr a round, and once a decision flips on it (config 5 at R = 5: round
# 5 of 10, on the card and the CPU alike) the two trajectories part
SECURE_C4_PARAM_TOL = 5 * 0.00456
SECURE_C5_PARAM_TOL = 5 * 0.0212
# B7's integer operations a pair's mask word: Threefry-2x32's two
# initial adds, 20 rounds of add, funnel shift and xor, 5 key injections
# of two adds, the final xor, and the add into a slot's sum
B7_OPS_PER_MASK = 2 + 20 * 3 + 5 * 2 + 1 + 1
# B7's LOP3 instructions a mask word in its SASS: a Threefry round's xor
# (20) and the final x0 ^ x1; the rotates are funnel shifts (SHF)
B7_LOP3_PER_MASK = 21
# B7's launches a secure round: one over every leaf
B7_PER_ROUND = 1
SECURE_C5_PER_ROUND = dict(MESH_PER_ROUND, secure_mask=B7_PER_ROUND)
# the most 32-bit integer operations the card issues: one instruction a
# lane a clock on all 128 lanes of an SM (4 warp instructions a clock,
# the SM's issue limit), half the float32 rate's 67e12 (an FMA counts 2).
# Not the INT32 pipe's 64 lanes alone: ptxas moves adds onto the FMA
# pipe (IMAD), and B7 ran below that pipe's count on an H100 (PERF.md
# section 6)
INT_ISSUE_OPS = F32_CUDA_CORE_OPS / 2
WORK_DIR = os.path.join("build", "chip_smoke")
FLEET_MASTER_SEED = b"process-federation-master-0001"   # the fleet's default


def reset_counts() -> None:
    """Every kernel's launch count to 0 (just before a path runs)."""
    from bflc_demo_tpu_torch.ops import (certified_reduce, fingerprint,
                                         flash_attention, secure_mask)
    for module in (flash_attention, fingerprint, certified_reduce,
                   secure_mask):
        module.reset_launches()


def read_counts() -> dict:
    """Every kernel's launches since the last `reset_counts`."""
    from bflc_demo_tpu_torch.ops import launch_counts
    return launch_counts()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields and `t`, the seconds since
    the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t": time.perf_counter() - T0}), flush=True)


def gate_failed(leg: str, gate: str, value, bar, detail: str = ""):
    """Print a failing gate's line, `{"phase": "gate_failed", "leg",
    "gate", "value", "bar"}`, and return the error its caller raises."""
    print(json.dumps({"phase": "gate_failed", "leg": leg, "gate": gate,
                      "value": value, "bar": bar}, default=str), flush=True)
    return RuntimeError(f"{leg}: {gate} {value!r}, bar {bar!r}"
                        + (f" ({detail})" if detail else ""))


def hold(leg: str, gate: str, ok: bool, value, bar,
         detail: str = "") -> None:
    """Raise the failing gate's error, its line printed first."""
    if not ok:
        raise gate_failed(leg, gate, value, bar, detail)


def reference_backend(cfg, compacts: bool = False) -> str:
    """The ledger the reference's `make_ledger(backend="auto")` gives a
    writer at this configuration (`bflc_demo_tpu/ledger/__init__.py:
    40-63`, a snapshotting writer or standby `comm/ledger_service.py:
    360-371`, `comm/failover.py:362-369`): the native one unless the
    config is asynchronous, blocked or adaptive or the writer compacts."""
    if compacts or cfg.async_buffer > 0 or cfg.reduce_blocks > 1 \
            or cfg.adapt_every > 0:
        return "python"
    return "native"


def hold_backend(leg: str, got, want: str = "native") -> None:
    """A leg's ledger is the one the reference runs there: a leg that
    asked for `auto` and got `python` where the reference runs native
    fails."""
    hold(leg, "ledger backend", got == want, got, want)


PR_SET_CHILD_SUBREAPER = 36          # <linux/prctl.h>


def adopt_orphans() -> None:
    """Make this process the subreaper of everything it starts: a
    process whose parent exits first (a child of the CLI leg's fleet)
    re-parents here, not to init, so `stop_processes` still sees it."""
    import ctypes
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        raise gate_failed("exit", "prctl(PR_SET_CHILD_SUBREAPER)",
                          ctypes.get_errno(), 0)


def running_children() -> list:
    """[pid, state, command] of each process whose parent is this one,
    zombies aside (/proc)."""
    out = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        state, ppid = stat[stat.rindex(")") + 2:].split()[:2]
        if int(ppid) == os.getpid() and state not in "ZX":
            out.append([int(name), state, cmd.strip()[:200]])
    return out


def stop_processes() -> list:
    """Stop what this run started and left.  The port's fleets stop
    their children and forkserver (`children.stop_children`); whatever
    still runs under this process after that is SIGKILLed and waited
    for, with its own children, which re-parent here.  Every zombie
    child is reaped.  Returns the processes that were still running."""
    mod = sys.modules.get("bflc_demo_tpu_torch.client.children")
    if mod is not None:
        mod.stop_children()
    left = []
    for _ in range(10):
        found = running_children()
        if not found:
            break
        left += found
        for pid, _, _ in found:
            try:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
            except (ProcessLookupError, ChildProcessError):
                pass
    while True:
        try:
            if os.waitpid(-1, os.WNOHANG)[0] == 0:
                break
        except ChildProcessError:
            break
    return left


def hold_no_processes_left(leg: str) -> None:
    """Stop what the run left, print the count, and fail if there was
    any: a fleet must stop every process it starts."""
    t0 = time.perf_counter()
    left = stop_processes()
    emit("processes", leg=leg, left=left,
         stop_s=time.perf_counter() - t0)
    hold(leg, "processes left running", not left, left, [])


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def attention_inputs(torch, shape, dtype, device, seed):
    """q/k/v/dO from a numpy seed; key mask with ragged lengths like the
    data's (at least half the sequence), and for S > 64 one fully masked
    64-key tile in batch row 0.  From DEVICE_DRAW_ELEMENTS elements a
    tensor up, q/k/v/dO are drawn on the card instead
    (`device_attention_inputs`: numpy takes seconds a draw there)."""
    if int(np.prod(shape)) >= DEVICE_DRAW_ELEMENTS:
        q, k, v, g, mask = device_attention_inputs(torch, shape, device,
                                                   seed)
        return (q.to(dtype), k.to(dtype), v.to(dtype), g.to(dtype), mask)
    b, s, _, _ = shape
    rng = np.random.default_rng(seed)
    q, k, v, g = (torch.as_tensor(rng.standard_normal(shape)
                                  .astype(np.float32)).to(device, dtype)
                  for _ in range(4))
    lengths = rng.integers(s // 2, s + 1, b)
    mask = np.arange(s)[None, :] < lengths[:, None]
    if s > 64:
        mask[0, 64:128] = False
    return q, k, v, g, torch.as_tensor(mask).to(device)


def device_attention_inputs(torch, shape, device, seed):
    """`attention_inputs` with q/k/v/dO drawn on the card by a seeded
    torch generator (at the ring's 64000 rows a numpy draw takes tens of
    seconds); the key mask as there."""
    b, s, _, _ = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device=device)
                  for _ in range(4))
    rng = np.random.default_rng(seed)
    mask = np.arange(s)[None, :] < rng.integers(s // 2, s + 1, b)[:, None]
    if s > 64:
        mask[0, 64:128] = False
    return q, k, v, g, torch.as_tensor(mask).to(device)


def kernel_warps(torch, fa, name, shape) -> int:
    """Warps a block that kernel `name` runs at `shape` (S_kv = S_q)."""
    return fa.launch_warps(name, shape, shape[1],
                           torch.cuda.get_device_properties(0)
                           .multi_processor_count)


def compare_phase(torch, fa, device) -> dict:
    """Max abs error of each kernel vs plain on identical inputs, at
    shapes that reach each kernel's block geometries; the float32 errors
    at the training shape go into the kernels line."""
    for name in DENSE_KERNELS:
        warps = {kernel_warps(torch, fa, name, shape)
                 for shape in DENSE_SHAPES}
        if warps != {1, 2, 4}:
            raise gate_failed("compare", f"{name} block warps",
                              sorted(warps), [1, 2, 4])
    train_err = {}
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in DENSE_SHAPES:
            q, k, v, g, mask = attention_inputs(torch, shape, dtype,
                                                device, seed=1)
            out, lse = fa.flash_fwd(q, k, v, mask)
            delta = fa.attention_delta(g, out)
            dk, dv = fa.flash_dkdv(q, k, v, mask, g, lse, delta)
            got = {"flash_fwd": (out, lse), "flash_dkdv": (dk, dv),
                   "flash_dq": (fa.flash_dq(q, k, v, mask, g, lse, delta),)}
            # the plain backward takes the kernel forward's out/lse, so
            # each backward kernel is held against plain on equal inputs
            want = {"flash_fwd": fa.flash_fwd_plain(q, k, v, mask),
                    "flash_dkdv": fa.flash_dkdv_plain(q, k, v, mask, g, lse,
                                                      delta),
                    "flash_dq": (fa.flash_dq_plain(q, k, v, mask, g, lse,
                                                   delta),)}
            torch.cuda.synchronize()
            for name in DENSE_KERNELS:
                err = scale = 0.0
                for a, b in zip(got[name], want[name]):
                    a, b = a.float(), b.float()
                    if not torch.isfinite(a).all():
                        raise gate_failed("compare", f"{name} finite",
                                          False, True, str(shape))
                    err = max(err, float((a - b).abs().max()))
                    scale = max(scale, float(b.abs().max()))
                tol = TOL[dtype_name] * max(1.0, scale)
                emit("compare", kernel=name, dtype=dtype_name,
                     shape=list(shape),
                     warps=kernel_warps(torch, fa, name, shape),
                     max_abs_err=err, tol=tol, ok=err <= tol)
                if err > tol:
                    raise gate_failed("compare", f"{name} {dtype_name} "
                                      f"{list(shape)} max_abs_err", err, tol)
                if dtype_name == "float32" and shape == TRAIN_SHAPE:
                    train_err[name] = err
    return train_err


def carry_err(torch, got, want) -> tuple:
    """(max abs err, scale) over acc, m and l.  m is NEG_INF (-1e30)
    exactly where no key was valid yet, in both versions alike, so those
    entries are left out of the scale (they would make it 1e30)."""
    err = scale = 0.0
    for a, b in zip(got, want):
        if not torch.isfinite(a).all():
            raise gate_failed("compare", "flash_carry finite", False, True)
        err = max(err, float((a - b).abs().max()))
        scale = max(scale, float(b[b > -1e29].abs().max()))
    return err, scale


def zero_carry(torch, fa, shape, device) -> tuple:
    """The ring's initial (acc, m, l) for q of `shape` (B, S, H, D)."""
    b, s, h, d = shape
    return (torch.zeros((b * h, s, d), device=device),
            torch.full((b * h, 1, s), fa.NEG_INF, device=device),
            torch.zeros((b * h, 1, s), device=device))


def carry_compare_phase(torch, fa, device) -> float:
    """flash_carry vs flash_carry_plain over two chained hops: hop 2
    resumes from the kernel's hop-1 carry on both sides, and its keys are
    all PAD for the last batch row.  Returns the largest float32 error at
    the sp training shard."""
    shard_err = 0.0
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for shape in (MULTI_SHAPE, SHARD_SHAPE):
            q, k1, v1, _, m1 = attention_inputs(torch, shape, dtype, device,
                                                seed=3)
            _, k2, v2, _, m2 = attention_inputs(torch, shape, dtype, device,
                                                seed=4)
            m2[-1] = False
            carry = zero_carry(torch, fa, shape, device)
            for hop, (kb, vb, mb) in enumerate(((k1, v1, m1), (k2, v2, m2))):
                got = fa.flash_carry(q, kb, vb, mb, *carry)
                want = fa.flash_carry_plain(q, kb, vb, mb, *carry)
                torch.cuda.synchronize()
                err, scale = carry_err(torch, got, want)
                tol = TOL[dtype_name] * max(1.0, scale)
                emit("compare", kernel="flash_carry", dtype=dtype_name,
                     shape=list(shape),
                     warps=kernel_warps(torch, fa, "flash_carry", shape),
                     hop=hop + 1, max_abs_err=err, tol=tol, ok=err <= tol)
                if err > tol:
                    raise gate_failed("compare", f"flash_carry {dtype_name} "
                                      f"{list(shape)} hop {hop + 1} "
                                      f"max_abs_err", err, tol)
                if dtype_name == "float32" and shape == SHARD_SHAPE:
                    shard_err = max(shard_err, err)
                carry = got
            del q, k1, v1, k2, v2, got, want, carry
    return shard_err


def device_ms(torch, fn, calls: int = 20, replays: int = 3,
              repeats: int = 5, stream=None) -> float:
    """Median device time of one `fn()` call: `calls` calls captured in a
    CUDA graph (no host launch overhead) on `stream` (default: the
    graph's own), replayed between CUDA events.  The defaults (20 calls,
    3 replays, 5 repeats) keep the timing phases short enough for the
    full script's time limit (PERF.md section 6)."""
    for _ in range(3):
        fn()                        # warm up: build, autotune, allocate
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / (replays * calls))
    return statistics.median(times)


def work(shape, mask, dtype_name: str, name: str) -> tuple:
    """(bytes, operations) of this call: each input read once and each
    output written once; the products over the keys this mask lets
    through."""
    b, s, h, d = shape
    esize = 4 if dtype_name == "float32" else 2
    tensor = b * s * h * d * esize
    rows = b * h * s * 4                     # one f32 per (b, h, q row)
    valid_keys = int(mask.sum())             # summed over the batch
    pairs = h * s * valid_keys               # (q row, valid key) per head
    carry = b * h * s * d * 4 + 2 * rows     # acc, m, l
    moved = {"flash_fwd": 4 * tensor + rows + b * s,      # q k v | out lse
             "flash_dkdv": 6 * tensor + 2 * rows + b * s,  # q k v dO | dk dv
             "flash_dq": 5 * tensor + 2 * rows + b * s,
             "flash_carry": 3 * tensor + 2 * carry + b * s,  # q k v c | c
             }[name]
    ops = {"flash_fwd": 4, "flash_dkdv": 8, "flash_dq": 6,
           "flash_carry": 4}[name] * pairs * d
    return moved, ops


def bound(shape, mask, dtype_name: str, name: str,
          peak_ops: float = None) -> tuple:
    """Least time (ms) the card needs for this call's work: bytes over
    HBM bandwidth vs. the products over the dtype's peak."""
    moved, ops = work(shape, mask, dtype_name, name)
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (peak_ops or PEAK_OPS[dtype_name]) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def timing_row(shape, mask, dtype_name: str, name: str, ms: float,
               plain_ms, library_ms) -> dict:
    """A kernel's timing beside its bound: share_of_bound = bound / time,
    and the TFLOP/s its products reach; float32 rows also carry the bound
    on the CUDA cores alone (the route of the first forward body)."""
    bound_ms, bound_by = bound(shape, mask, dtype_name, name)
    row = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms,
           "tflops": work(shape, mask, dtype_name, name)[1] / ms / 1e9}
    if dtype_name == "float32":
        row["bound_ms_cuda_cores"] = bound(shape, mask, dtype_name, name,
                                           F32_CUDA_CORE_OPS)[0]
    return row


def sdpa_inputs(q, k, v, mask):
    """SDPA's (B, H, S, D) layout and a key mask broadcast over rows."""
    return tuple(t.transpose(1, 2).contiguous() for t in (q, k, v)) + (
        mask[:, None, None, :],)


def sdpa_backward_ms(torch, q, k, v, g, mask, **few) -> float:
    """Device time of SDPA's backward, which computes dQ, dK and dV in
    one call, on these inputs.  The forward's graph is kept for the
    replays; autograd runs a backward on its forward's stream, so the
    forward runs on the stream that the replays are captured on."""
    import torch.nn.functional as F
    qt, kt, vt, attn_mask = sdpa_inputs(q, k, v, mask)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (qt, kt, vt))
    gt = g.transpose(1, 2).contiguous()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out = F.scaled_dot_product_attention(qg, kg, vg, attn_mask=attn_mask)
    torch.cuda.current_stream().wait_stream(side)
    return device_ms(torch, lambda: torch.autograd.grad(
        out, (qg, kg, vg), gt, retain_graph=True), stream=side, **few)


def backward_timing(torch, fa, device, shape, seed,
                    dtype_name: str = "float32", **few) -> dict:
    """The dK/dV and dQ kernels at `shape` (float32, or `dtype_name`),
    each beside its plain version, and the pair beside SDPA's backward
    in the same dtype.  No one PyTorch call computes dK/dV or dQ alone:
    those rows have no library time, and the pair's row (a line of its
    own, and `pair` on both rows) holds SDPA's backward."""
    q, k, v, g, mask = attention_inputs(torch, shape,
                                        getattr(torch, dtype_name), device,
                                        seed)
    out, lse = fa.flash_fwd(q, k, v, mask)
    args = (q, k, v, mask, g, lse, fa.attention_delta(g, out))
    rows = {}
    for name in ("flash_dkdv", "flash_dq"):
        kernel, plain = getattr(fa, name), getattr(fa, name + "_plain")
        row = timing_row(shape, mask, dtype_name, name,
                         device_ms(torch, lambda: kernel(*args), **few),
                         device_ms(torch, lambda: plain(*args), **few), None)
        row["library"] = None
        emit("timing", kernel=name, shape=list(shape), dtype=dtype_name,
             **row)
        rows[name] = row
    pair = {"kernels": list(rows),
            "ms": sum(row["ms"] for row in rows.values()),
            "plain_ms": sum(row["plain_ms"] for row in rows.values()),
            "library_ms": sdpa_backward_ms(torch, q, k, v, g, mask, **few),
            "library": "scaled_dot_product_attention backward (dQ, dK and "
                       "dV in one call)"}
    emit("timing", kernel="flash_dkdv+flash_dq", shape=list(shape),
         dtype=dtype_name, **pair)
    for row in rows.values():
        row["pair"] = pair
    return rows


def forward_timing(torch, fa, device, shape, seed, card: str = None,
                   inputs=None, dtype_name: str = "float32",
                   **few) -> dict:
    """The forward kernel at `shape` (float32, or `dtype_name`) beside its
    plain version and SDPA in the same dtype (the row names the card
    when `card` is given), on `inputs` (q, k, v, dO, mask) where
    given."""
    import torch.nn.functional as F
    q, k, v, _, mask = inputs or attention_inputs(
        torch, shape, getattr(torch, dtype_name), device, seed)
    qt, kt, vt, attn_mask = sdpa_inputs(q, k, v, mask)
    row = timing_row(
        shape, mask, dtype_name, "flash_fwd",
        device_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), **few),
        device_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, mask), **few),
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask), **few))
    row["library"] = "scaled_dot_product_attention"
    if card is not None:
        row["nvidia_smi"] = card
    emit("timing", kernel="flash_fwd", shape=list(shape), dtype=dtype_name,
         **row)
    return row


def timing_phase(torch, fa, device, card: str) -> dict:
    result = {"flash_fwd": forward_timing(torch, fa, device, TRAIN_SHAPE,
                                          seed=2)}
    result.update(backward_timing(torch, fa, device, TRAIN_SHAPE, seed=2))
    for row in result.values():
        row["at"] = {}
    # the forward at the host round's score batch and the mesh round's
    # shapes (eval only, no backward, at the score and sponsor shapes),
    # a cell's root score and an executor member's re-score
    for name, shape, few in (("score", SCORE_SHAPE, {}),
                             ("mesh_train", MESH_TRAIN_SHAPE, {}),
                             ("mesh_score", MESH_SCORE_SHAPE, BIG_FEW),
                             ("sponsor", SPONSOR_SHAPE, {}),
                             ("agg_score", AGG_SCORE_SHAPE, {}),
                             ("attest_score", ATTEST_SCORE_SHAPE, {})):
        row = forward_timing(torch, fa, device, shape, seed=8, card=card,
                             **few)
        result["flash_fwd"]["at"][name] = dict(row, shape=list(shape))
    for name, row in backward_timing(torch, fa, device, MESH_TRAIN_SHAPE,
                                     seed=8).items():
        result[name]["at"]["mesh_train"] = dict(row,
                                                shape=list(MESH_TRAIN_SHAPE))
    bf16_timing_rows(torch, fa, device, card, result)
    return result


def bf16_timing_rows(torch, fa, device, card: str, result: dict) -> None:
    """The bfloat16 rows of `bf16_config5`'s path: K1 at its training,
    score and sponsor shapes, K2 and K3 at its training shape, each beside
    its plain version and SDPA in bfloat16, under "at" in `result`."""
    for name, shape, few in (("bf16_mesh_train", MESH_TRAIN_SHAPE, {}),
                             ("bf16_mesh_score", MESH_SCORE_SHAPE, BIG_FEW),
                             ("bf16_sponsor", SPONSOR_SHAPE, {})):
        row = forward_timing(torch, fa, device, shape, seed=8, card=card,
                             dtype_name="bfloat16", **few)
        result["flash_fwd"]["at"][name] = dict(row, shape=list(shape),
                                               dtype="bfloat16")
    for name, row in backward_timing(torch, fa, device, MESH_TRAIN_SHAPE,
                                     seed=8, dtype_name="bfloat16").items():
        result[name]["at"]["bf16_mesh_train"] = dict(
            row, shape=list(MESH_TRAIN_SHAPE), dtype="bfloat16",
            nvidia_smi=card)


def carry_timing_phase(torch, fa, device) -> tuple:
    """flash_carry at the sp training shard; then the ring as a whole
    beside the unsharded flash forward and SDPA on the same sequence.
    Returns the timing rows of flash_carry and of the unsharded
    forward."""
    import torch.nn.functional as F
    from bflc_demo_tpu_torch.parallel import FoldedAxis
    from bflc_demo_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v, _, mask = attention_inputs(torch, SHARD_SHAPE, torch.float32,
                                        device, seed=5)
    carry = zero_carry(torch, fa, SHARD_SHAPE, device)
    few = dict(calls=5, replays=2, repeats=5)
    row = timing_row(
        SHARD_SHAPE, mask, "float32", "flash_carry",
        device_ms(torch, lambda: fa.flash_carry(q, k, v, mask, *carry),
                  **few),
        device_ms(torch, lambda: fa.flash_carry_plain(q, k, v, mask,
                                                      *carry), **few),
        None)                      # no PyTorch call returns the raw carry
    emit("timing", kernel="flash_carry", shape=list(SHARD_SHAPE),
         dtype="float32", **row)
    del q, k, v, mask, carry

    b, s, h, d = RING_SHAPE
    n = SHARD_SHAPE[0] // b
    q, k, v, _, mask = attention_inputs(torch, RING_SHAPE, torch.float32,
                                        device, seed=6)

    def fold(t):
        return t.reshape(b, n, s // n, *t.shape[2:]).transpose(0, 1) \
            .reshape(n * b, s // n, *t.shape[2:]).contiguous()
    fq, fk, fv, fm = (fold(t) for t in (q, k, v, mask))
    axis = FoldedAxis(n, b, device)
    qt, kt, vt, attn_mask = sdpa_inputs(q, k, v, mask)
    ring = ring_attention(fq, fk, fv, fm, axis, impl="pallas")
    dense, _ = fa.flash_fwd(q, k, v, mask)
    err = float((fold(dense) - ring).abs().max())
    fwd_row = timing_row(
        RING_SHAPE, mask, "float32", "flash_fwd",
        device_ms(torch, lambda: fa.flash_fwd(q, k, v, mask), **RING_FEW),
        device_ms(torch, lambda: fa.flash_fwd_plain(q, k, v, mask),
                  **RING_FEW),
        device_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=attn_mask), **RING_FEW))
    emit("timing", kernel="flash_fwd", shape=list(RING_SHAPE),
         dtype="float32", **fwd_row)
    emit("ring_timing", shape=list(RING_SHAPE), n_sp=n, dtype="float32",
         ring_ms=device_ms(torch, lambda: ring_attention(
             fq, fk, fv, fm, axis, impl="pallas"), **RING_FEW),
         flash_fwd_ms=fwd_row["ms"], sdpa_ms=fwd_row["library_ms"],
         ring_vs_flash_fwd_max_abs_err=err)
    if err > TOL["float32"]:
        raise gate_failed("ring_timing", "ring vs flash forward max_abs_err",
                          err, TOL["float32"])
    return row, dict(fwd_row, shape=list(RING_SHAPE))


def sp_slice_phase(torch, fa, device) -> int:
    """The sp path's runs between a reset and a read of the launch
    counts; then the card's oracles for them.  Returns flash_carry's
    launches."""
    from bflc_demo_tpu_torch.core.losses import softmax_cross_entropy
    from bflc_demo_tpu_torch.eval.long_context import long_context_sp

    reset_counts()
    runs = {name: long_context_sp(**kw, device=device)
            for name, kw in SP_RUNS.items()}
    torch.cuda.synchronize()
    launches = read_counts()

    for name, res in runs.items():
        kw = SP_RUNS[name]
        expected = kw["n_sp"] * res.model.cfg.depth * res.forwards
        emit("sp_slice", run=name, seq_len=kw["seq_len"], n_sp=kw["n_sp"],
             batch=kw["batch"], losses=res.losses, step_s=res.step_s,
             forward_s=res.forward_s, forwards=res.forwards,
             launches=res.launches, expected_carry_launches=expected,
             peak_mem_gib=res.peak_mem_bytes / 2**30,
             logits=res.logits.tolist())
        leg = f"sp_{name}"
        hold(leg, "finite loss and logits",
             bool(np.isfinite(res.losses).all()
                  and torch.isfinite(res.logits).all()), False, True)
        hold(leg, "flash_carry launches",
             res.launches["flash_carry"] == expected,
             res.launches["flash_carry"], expected)
        hold(leg, "dense kernel launches",
             not any(res.launches[k] for k in DENSE_KERNELS),
             {k: res.launches[k] for k in DENSE_KERNELS}, 0)
    total = sum(r.launches["flash_carry"] for r in runs.values())
    if launches["flash_carry"] != total:
        raise gate_failed("sp", "flash_carry launches counted",
                          launches["flash_carry"], total)

    # 32k: the sp logits vs the dense forward on the unsharded sequence
    fwd = runs["forward"]
    with torch.no_grad():
        dense = fwd.model.apply(fwd.params[-1], fwd.tokens)
    err = (fwd.logits - dense).abs()
    limit = SP_LOGITS_TOL["atol"] + SP_LOGITS_TOL["rtol"] * dense.abs()
    emit("sp_check", run="forward", check="sp logits vs dense forward",
         max_abs_err=float(err.max()), ok=bool((err <= limit).all()),
         max_err_over_limit=float((err / limit).max()), **SP_LOGITS_TOL)
    if not (err <= limit).all():
        raise gate_failed("sp_forward", "logits vs dense err over limit",
                          float((err / limit).max()), 1.0)

    # 8k: the first sp step vs one dense SGD step from the same params
    tr = runs["train"]
    lr = SP_RUNS["train"]["lr"]
    before, after = tr.params[0], tr.params[1]
    work = {k: p.clone().requires_grad_(True) for k, p in before.items()}
    loss = softmax_cross_entropy(tr.model.apply(work, tr.tokens), tr.labels)
    grads = torch.autograd.grad(loss, list(work.values()))
    param_err = grad_err = 0.0
    bad = []
    for (key, p), g in zip(before.items(), grads):
        want = p - lr * g
        diff = (after[key] - want).abs()
        implied = (p - after[key]) / lr
        rel = float((implied - g).abs().max()) / max(float(g.abs().max()),
                                                     1e-12)
        param_err = max(param_err, float(diff.max()))
        grad_err = max(grad_err, rel)
        if (diff > SP_STEP_TOL["atol"] + SP_STEP_TOL["rtol"]
                * want.abs()).any() or rel > SP_GRAD_TOL:
            bad.append(key)
    body_moved = float((after["['blocks'][0]['w1']"]
                        - before["['blocks'][0]['w1']"]).abs().max())
    emit("sp_check", run="train", check="sp step vs dense step",
         dense_loss=float(loss.detach()), sp_loss=tr.losses[0],
         max_abs_param_err=param_err, max_rel_grad_err=grad_err,
         body_moved=body_moved, ok=not bad, **SP_STEP_TOL,
         grad_tol=SP_GRAD_TOL)
    leg = "sp_train"
    hold(leg, "leaves off the dense step", not bad, bad, [])
    hold(leg, "body moved", body_moved > 0, body_moved, 0.0)
    return launches["flash_carry"]


def slice_phase(torch, fa, device) -> dict:
    """Config 5 on the host runtime; returns its launches and round
    times."""
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    from bflc_demo_tpu_torch.models.transformer import \
        make_transformer_classifier
    from bflc_demo_tpu_torch.data.synthetic import \
        synthetic_text_classification

    reset_counts()
    res = config5_transformer_sst2(rounds=ROUNDS, runtime="host",
                                   device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    best = res.best_accuracy()
    emit("slice", config="config5", runtime="host", rounds=ROUNDS,
         accuracy=[a for _, a in res.accuracy_history],
         global_loss=[l for _, l in res.loss_history],
         round_s=res.round_times_s, wall_s=res.wall_time_s,
         best_acc=best, ledger_log_head=res.ledger_log_head.hex(),
         ledger_log_size=res.ledger_log_size,
         ledger_verified=res.ledger.verify_log(), launches=launches,
         ledger_backend=res.ledger.backend)
    leg = "host_config5"
    hold(leg, "rounds", res.rounds_completed == ROUNDS,
         res.rounds_completed, ROUNDS)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold_backend(leg, res.ledger.backend)
    hold(leg, "kernels never launched",
         all(launches.get(n, 0) > 0 for n in DENSE_KERNELS),
         [n for n in DENSE_KERNELS if launches.get(n, 0) <= 0], [])
    hold(leg, "best accuracy", best >= MIN_BEST_ACC, best, MIN_BEST_ACC)

    # the final model on the card (kernels) vs the CPU path (plain
    # versions) on 32 test rows: same logits within float32 tolerance
    params = res.final_params
    if not all(torch.isfinite(p).all() for p in params.values()):
        raise gate_failed("host_config5", "finite params", False, True)
    x, _ = synthetic_text_classification(64, seq_len=64, vocab_size=1000,
                                         seed=7)
    tokens = torch.as_tensor(x[:32], dtype=torch.long)
    model = make_transformer_classifier()
    on_card = model.to(device).apply(params, tokens.to(device)).cpu()
    on_cpu = model.cpu().apply({k: p.cpu() for k, p in params.items()},
                               tokens)
    err = float((on_card - on_cpu).abs().max())
    emit("slice_check", logits_shape=list(on_card.shape),
         max_abs_err_vs_cpu=err, tol=1e-4)
    if on_card.shape != (32, 2) or err > 1e-4:
        raise gate_failed("host_config5", "logits vs CPU max_abs_err", err,
                          1e-4, f"shape {list(on_card.shape)}")
    # decisions: the model after round 2 (accuracy ~0.8: rows on both
    # sides of the boundary; the initial model's zero head decides none)
    # and the final one
    early = config5_transformer_sst2(rounds=2, runtime="host",
                                     device="cuda")
    decision_check(torch, early.final_params, device, "round 2",
                   early.final_accuracy)
    decision_check(torch, params, device, "final", res.final_accuracy)
    return {"launches": launches, "round_s": res.round_times_s}


def mesh_slice_phase(torch, fa, fp, device) -> dict:
    """Config 5 on the mesh runtime between a reset and a read of the
    launch counts; then its final model's decisions on the card against
    the CPU path's.  Returns the launches and the round times."""
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    res = config5_transformer_sst2(rounds=ROUNDS, runtime="mesh",
                                   device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    expected = {k: MESH_PER_ROUND.get(k, 0) * ROUNDS for k in launches}
    best = res.best_accuracy()
    emit("mesh_slice", config="config5", runtime="mesh", rounds=ROUNDS,
         accuracy=[a for _, a in res.accuracy_history],
         global_loss=[l for _, l in res.loss_history],
         round_s=res.round_times_s, wall_s=res.wall_time_s, best_acc=best,
         ledger_log_head=res.ledger_log_head.hex(),
         ledger_log_size=res.ledger_log_size,
         ledger_verified=res.ledger.verify_log(), n_devices=res.n_devices,
         launches=launches, expected_launches=expected, peak_mem_bytes=peak,
         ledger_backend=res.ledger.backend)
    leg = "mesh_config5"
    hold(leg, "rounds", res.rounds_completed == ROUNDS,
         res.rounds_completed, ROUNDS)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold_backend(leg, res.ledger.backend)
    hold(leg, "launches", launches == expected, launches, expected)
    hold(leg, "best accuracy", best >= MIN_BEST_ACC, best, MIN_BEST_ACC)
    decision_check(torch, res.final_params, device, "mesh final",
                   res.final_accuracy)
    return {"launches": launches, "round_s": res.round_times_s}


def config1_phase(torch, fa, fp, device) -> dict:
    """The CLI's default run — config 1 on the mesh runtime, 10 rounds —
    between a reset and a read of the launch counts; the same 10 rounds
    on the host runtime; the mesh run's final model on the card against
    the CPU path on the sponsor's test set."""
    from bflc_demo_tpu_torch.data.occupancy import occupancy_source
    from bflc_demo_tpu_torch.eval.configs import config1_occupancy

    reset_counts()
    mesh = config1_occupancy(rounds=CONFIG1_ROUNDS, runtime="mesh",
                             device="cuda")
    torch.cuda.synchronize()
    launches = read_counts()
    host = config1_occupancy(rounds=CONFIG1_ROUNDS, runtime="host",
                             device="cuda")
    source = occupancy_source()
    bar = CONFIG1_MIN_BEST[source]
    want_size = 20 + CONFIG1_ROUNDS * 15       # tests/test_e2e.py:46
    emit("mesh_slice", config="config1", data=source, rounds=CONFIG1_ROUNDS,
         accuracy=[a for _, a in mesh.accuracy_history],
         host_accuracy=[a for _, a in host.accuracy_history],
         round_s=mesh.round_times_s, host_round_s=host.round_times_s,
         best_acc=mesh.best_accuracy(), host_best_acc=host.best_accuracy(),
         min_best_acc=bar, ledger_log_head=mesh.ledger_log_head.hex(),
         ledger_log_size=mesh.ledger_log_size,
         host_ledger_log_size=host.ledger_log_size,
         ledger_verified=mesh.ledger.verify_log(), launches=launches,
         ledger_backend=mesh.ledger.backend,
         host_ledger_backend=host.ledger.backend)
    leg = "mesh_config1"
    for name, res in (("mesh", mesh), ("host", host)):
        hold_backend(f"{leg} {name}", res.ledger.backend)
        hold(leg, f"{name} ledger ops", res.ledger_log_size == want_size,
             res.ledger_log_size, want_size)
        hold(leg, f"{name} chain verified", res.ledger.verify_log(), False,
             True)
    hold(leg, "best accuracy", mesh.best_accuracy() >= bar,
         mesh.best_accuracy(), bar)
    want = {k: 0 for k in launches}
    want["fingerprint"] = MESH_PER_ROUND["fingerprint"] * CONFIG1_ROUNDS
    hold(leg, "launches", launches == want, launches, want)
    config1_card_check(torch, device, mesh, leg)
    return {"launches": launches, "round_s": mesh.round_times_s,
            "host_round_s": host.round_times_s}


def config1_card_check(torch, device, res, leg: str) -> None:
    """A config-1 run's final model on the card vs on the CPU: logits
    within float32 rounding of the raw-scale features, the same
    decisions but for rows whose two logits are within that tolerance of
    each other, and the recorded sponsor accuracy re-evaluated."""
    from bflc_demo_tpu_torch.core.losses import accuracy
    from bflc_demo_tpu_torch.data.occupancy import load_occupancy
    from bflc_demo_tpu_torch.models import make_softmax_regression
    _, _, xte, yte = load_occupancy()
    model = make_softmax_regression()
    x = torch.as_tensor(xte)
    on_card = model.to(device).apply(res.final_params, x.to(device)).cpu()
    on_cpu = model.cpu().apply({k: p.cpu() for k, p in
                                res.final_params.items()}, x)
    tol = 1e-5 * max(1.0, float(on_cpu.abs().max()))
    err = float((on_card - on_cpu).abs().max())
    gap = (on_cpu[:, 0] - on_cpu[:, 1]).abs()
    flips = on_card.argmax(-1) != on_cpu.argmax(-1)
    acc_card = float(accuracy(on_card, torch.nn.functional.one_hot(
        torch.as_tensor(yte).long(), 2).float()))
    emit("mesh_check", config="config1", leg=leg, max_abs_err_vs_cpu=err,
         tol=tol, ties_flipped=int(flips.sum()), sponsor_acc_card=acc_card,
         sponsor_acc_recorded=res.final_accuracy)
    hold(leg, "logits vs CPU max_abs_err", err <= tol, err, tol)
    hold(leg, "decisions flipped", not (flips & (gap > 2 * tol)).any(),
         int((flips & (gap > 2 * tol)).sum()), 0)
    hold(leg, "sponsor accuracy re-evaluated",
         acc_card == res.final_accuracy, acc_card, res.final_accuracy)


def preset_run(torch, name: str, label: str, rounds: int, bar, **kw):
    """One preset run between a reset and a read of the launch counts,
    with its bar: `bar` = ("best", x) for best accuracy above x, or
    ("log", clients, uploads, scores) for the ledger's size after
    `rounds` rounds (tests/test_configs.py:22-26).  Emits the run;
    returns (result, launches, peak bytes)."""
    from bflc_demo_tpu_torch.eval.configs import CONFIGS
    from bflc_demo_tpu_torch.protocol import ProtocolConfig

    args = dict(kw, cfg=ProtocolConfig(**kw["cfg"])) if "cfg" in kw else kw
    torch.cuda.reset_peak_memory_stats()
    tap = DecisionTap()
    try:
        reset_counts()
        res = CONFIGS[name].build(rounds=rounds, device="cuda", **args)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        tap.undo()
    if label in PLAIN_KEPT:
        PLAIN_RUNS[label] = (tap.rounds, res.final_params,
                             res.ledger_log_size)
    peak = torch.cuda.max_memory_allocated()
    runtime = kw.get("runtime", "mesh")
    acc = [a for _, a in res.accuracy_history]
    emit("preset", path=label, config=name, runtime=runtime, rounds=rounds,
         geometry={k: v for k, v in kw.items() if k != "runtime"},
         accuracy=acc, best_acc=res.best_accuracy(),
         round_s=res.round_times_s, wall_s=res.wall_time_s,
         ledger_log_size=res.ledger_log_size,
         ledger_verified=res.ledger.verify_log(), launches=launches,
         peak_mem_bytes=peak, ledger_backend=res.ledger.backend)
    leg = label
    hold(leg, "rounds", res.rounds_completed == rounds,
         res.rounds_completed, rounds)
    hold_backend(leg, res.ledger.backend)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold(leg, "finite accuracies", bool(all(np.isfinite(acc))), acc, True)
    if bar[0] == "best":
        hold(leg, "best accuracy above", res.best_accuracy() > bar[1],
             res.best_accuracy(), bar[1])
    if bar[0] == "log":
        want = bar[1] + rounds * (bar[2] + bar[3] + 1)
        hold(leg, "ledger ops", res.ledger_log_size == want,
             res.ledger_log_size, want)
    want = {k: 0 for k in launches}
    if runtime == "mesh":
        want["fingerprint"] = MESH_PER_ROUND["fingerprint"] * rounds
    hold(leg, "launches", launches == want, launches, want)
    return res, launches, peak


def presets_phase(torch, device, card: str) -> dict:
    """Configs 0, 2, 3 and 4 on the card (PRESET_RUNS), each run between
    a reset and a read of the launch counts and held to the reference
    tests' bar; then the trained config-2 model's decisions on the card
    against the CPU path's.  Returns {path: launches}."""
    from bflc_demo_tpu_torch.eval.configs import config2_data
    from bflc_demo_tpu_torch.models import make_lenet5

    paths, times, peaks, results = {}, {}, {}, {}
    for label, name, rounds, bar, kw in PRESET_RUNS:
        res, paths[label], peaks[label] = preset_run(
            torch, name, label, rounds, bar, **kw)
        times[label] = res.round_times_s
        results[label] = res
    emit("preset_round_times", nvidia_smi=card, round_s=times,
         warm_round_s={k: v[1:] for k, v in times.items()},
         peak_mem_bytes=peaks,
         fingerprint_launches={k: v["fingerprint"] for k, v in paths.items()})
    c2 = results["mesh_config2"]
    decision_check(torch, c2.final_params, device, "config 2 (LeNet-5)",
                   c2.final_accuracy, model=make_lenet5,
                   data=config2_data(n_data=CONFIG2_HEAVY_N_DATA),
                   rel_tol=True)
    return paths


def fingerprint_trees(torch, device) -> dict:
    """The compare cases, as CPU tensors: every leaf dtype of the mesh
    path and more, stacked over 3 slices, with a ragged leaf (11 words);
    config 5's 20 stacked deltas; one config-1 model; the 14 active
    slots' deltas of config 3 and the 16 of config 4 (its 62 leaves in
    `tree_leaves` order, 718 MB)."""
    from bflc_demo_tpu_torch.models import (canonical_params,
                                            make_femnist_cnn, make_resnet18,
                                            make_softmax_regression,
                                            make_transformer_classifier)
    gen = torch.Generator().manual_seed(9)
    mixed = {
        "['f32']": torch.randn((3, 7, 5), generator=gen),
        "['bf16']": torch.randn((3, 13), generator=gen).to(torch.bfloat16),
        "['f16']": torch.randn((3, 4, 3), generator=gen).to(torch.float16),
        "['i8']": torch.randint(-128, 128, (3, 9), generator=gen,
                                dtype=torch.int8),
        "['bool']": torch.rand((3, 6), generator=gen) < 0.5,
        "['i32']": torch.randint(-2**31, 2**31 - 1, (3, 3, 3),
                                 generator=gen, dtype=torch.int32),
        "['ragged']": torch.randn((3, 11), generator=gen)}
    deltas = {k: torch.randn((20,) + tuple(v.shape), generator=gen)
              for k, v in make_transformer_classifier().init_params(0)
              .items()}
    config1 = {k: torch.randn((1,) + tuple(v.shape), generator=gen)
               for k, v in make_softmax_regression().init_params(0).items()}
    trees = {"mixed_dtypes": mixed, "config5_deltas": deltas,
             "config1_model": config1}
    # the active slots' deltas of configs 3 and 4 (K + C = 14 and 16):
    # the FEMNIST CNN's 8 leaves and ResNet-18's 62
    for name, make, slots in (("config3_deltas", make_femnist_cnn, 14),
                              ("config4_deltas", make_resnet18, 16)):
        trees[name] = {k: torch.randn((slots,) + tuple(v.shape),
                                      generator=gen)
                       for k, v in canonical_params(make()).items()}
    return trees


def fingerprint_compare_phase(torch, fp, device) -> tuple:
    """The kernel against the plain version on the same card tensors,
    bit for bit.  Returns the card trees for the timing phase and the
    largest difference measured."""
    trees, worst = {}, 0
    for name, cpu_tree in fingerprint_trees(torch, device).items():
        tree = {k: v.to(device) for k, v in cpu_tree.items()}
        got = fp.fingerprint_stacked(tree)
        # the plain chain at the config-3/4 trees (0.8-1.4 M rows) on the
        # card's copies, one launch a row, would take minutes: there it
        # runs on the same values on the CPU
        want = fp.fingerprint_plain(
            cpu_tree if name in FP_PLAIN_ON_CPU else tree).to(device)
        del cpu_tree
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        emit("compare", kernel="fingerprint", case=name,
             slices=int(got.shape[0]),
             leaves={k: [str(v.dtype).replace("torch.", "")]
                     + list(v.shape[1:]) for k, v in tree.items()},
             max_abs_err=err, ok=err == 0)
        if err:
            raise gate_failed("fingerprint", f"{name} max_abs_err", err, 0)
        trees[name] = tree
        worst = max(worst, err)
    return trees, worst


def event_ms(torch, fn) -> float:
    """One call of `fn` between CUDA events (for the plain fingerprint,
    tens of thousands of launches a call, too many to capture)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop)


def fingerprint_timing_phase(torch, fp, device, trees) -> dict:
    """The kernel at config 5's 20 deltas and at one model, beside both
    bounds: bytes (each input read once, the ids written once) and the
    chain (one lane's dependent multiply-xor steps times the latency of
    one step, measured by a one-thread chain kernel)."""
    step_ms, step_cycles = fp.fnv_chain_latency(1 << 22, device)
    deltas = trees["config5_deltas"]
    rows = {}
    for name, tree in (("config5_deltas", deltas),
                       ("config5_model", {k: v[:1].contiguous()
                                          for k, v in deltas.items()}),
                       ("config3_deltas", trees["config3_deltas"]),
                       ("config4_deltas", trees["config4_deltas"])):
        plan = fp.KernelPlan(tree)
        ms = device_ms(torch, plan.launch, calls=10, replays=3, repeats=5)
        plain_ms = (None if name in FP_PLAIN_ON_CPU else
                    event_ms(torch, lambda: fp.fingerprint_plain(tree)))
        slices = plan.batch
        moved = sum(t.numel() * t.element_size() for t in tree.values()) \
            + slices * fp.LANES * 8
        words = sum(fp._leaf_words(t, slices) for t in tree.values()) \
            * slices
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * words / INT_OPS * 1e3
        steps = fp.chain_steps(tree)
        chain_ms = steps * step_ms
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "library": None, "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "chain_bound_ms": chain_ms, "chain_steps": steps,
               "chain_step_ns": step_ms * 1e6,
               "chain_step_cycles": step_cycles, "slices": slices,
               "bytes": moved}
        row["share_of_bound"] = row["bound_ms"] / ms
        # the chain is the floor no schedule beats
        row["share_of_chain_bound"] = chain_ms / ms
        emit("timing", kernel="fingerprint", case=name, **row)
        rows[name] = row
    main = rows["config5_deltas"]
    main["at"] = {name: rows[name] for name in
                  ("config5_model", "config3_deltas", "config4_deltas")}
    return main


def _b5_hold(torch, cr, spec, m, c, g, want, blocks: int, label: str):
    """B5 and its plain version over every spec-v2 block of the card
    matrix `m`, each against the host leg's row `want`, byte for byte."""
    bounds = spec.block_bounds(m.shape[1], blocks)
    for fn in (cr.certified_reduce, cr.certified_reduce_plain):
        got = torch.cat([fn(m[:, lo:hi], c, g) for lo, hi in bounds])
        got = got.cpu().numpy()
        if got.tobytes() != want.tobytes():
            bad = np.flatnonzero(got.view(np.uint32) != want.view(np.uint32))
            raise gate_failed(
                "merge", f"{fn.__name__} {label} {blocks} blocks elements "
                f"off the spec's bytes", int(bad.size), 0,
                f"{fn.__name__} {label}, {blocks} blocks: {bad.size} "
                f"elements differ from the spec's bytes, first at "
                f"{int(bad[0])}: {hex(int(got.view(np.uint32)[bad[0]]))} "
                f"vs {hex(int(want.view(np.uint32)[bad[0]]))}")


def _b5_card(torch, spec, mat, w, wsum, device):
    """The card tensors of one merge: the (N, P) matrix, coefficients and
    gates."""
    return (torch.from_numpy(np.ascontiguousarray(mat)).to(device),
            torch.from_numpy(spec.merge_coefficients(w, wsum)).to(device),
            torch.from_numpy(np.asarray(w, np.float32) > 0.0).to(device))


def merge_compare_phase(torch, cr, device) -> dict:
    """B5 against its plain version and the numpy spec, byte for byte:
    every corner case of the CPU tests at blocks 1, 2, 5, 8 and 64, and
    every merge geometry at blocks 1 and 8.  Returns the geometries'
    cases for the path and timing phases."""
    from bflc_demo_tpu_torch.meshagg import check, spec
    from bflc_demo_tpu_torch.meshagg.engine import flatten_delta

    with np.errstate(all="ignore"):
        for name, (flats, w) in check.corner_cases().items():
            keys = sorted(flats[0])
            wsum = max(float(w.sum()), 1e-12)
            want = flatten_delta(spec.host_weighted_sum(keys, flats, w,
                                                        wsum), keys)
            mat = np.stack([flatten_delta(f, keys) for f in flats])
            m, c, g = _b5_card(torch, spec, mat, w, wsum, device)
            blocks = sorted({min(b, mat.shape[1])
                             for b in check.CORNER_BLOCKS})
            for b in blocks:
                _b5_hold(torch, cr, spec, m, c, g, want, b, name)
            emit("compare", kernel="certified_reduce", case=name,
                 n=int(mat.shape[0]), p=int(mat.shape[1]), blocks=blocks,
                 nonfinite=int((~np.isfinite(want)).sum()),
                 max_abs_err=0.0, ok=True)
        cases = {}
        for name in check.GEOMETRIES:
            g_, rows, weights, selected, lr = check.geometry_case(name)
            w = spec.merge_weight_vector(weights, selected, len(rows))
            wsum = max(float(w.sum()), 1e-12)
            want = spec.host_weighted_sum(
                ["x"], [{"x": r} for r in rows], w, wsum)["x"]
            m, c, g = _b5_card(torch, spec, np.stack(rows), w, wsum,
                               device)
            for b in MERGE_BLOCKS:
                _b5_hold(torch, cr, spec, m, c, g, want, b, name)
            emit("compare", kernel="certified_reduce", case=name,
                 n=len(rows), selected=len(selected), p=int(rows[0].size),
                 blocks=list(MERGE_BLOCKS), max_abs_err=0.0, ok=True)
            cases[name] = (g_, rows, weights, selected, lr)
            del m, c, g
    return cases


def merge_path_phase(torch, cr, device, cases) -> dict:
    """The engine's writer merge (`aggregate_rows`, the mesh leg) once at
    every geometry and block count, between a reset and a read of the
    launch counts — one launch per block per call — each result's bytes
    against the host leg's; then the differential checker on the card,
    counted the same way.  Returns B5's launches by path."""
    from bflc_demo_tpu_torch.meshagg import check
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
    from bflc_demo_tpu_torch.utils.serialization import hash_pytree

    engine = MeshAggEngine(device=device)
    engine.run_selfcheck()              # raises on the card if it fails
    reset_counts()
    got = {(name, b): engine.aggregate_rows(*case, force_leg="mesh",
                                            blocks=b)
           for name, case in cases.items() for b in MERGE_BLOCKS}
    torch.cuda.synchronize()
    merge = read_counts()
    expected = {k: 0 for k in merge}
    expected["certified_reduce"] = len(cases) * sum(MERGE_BLOCKS)
    same = {}
    with np.errstate(all="ignore"):
        for name, case in cases.items():
            want = hash_pytree(engine.aggregate_rows(*case,
                                                     force_leg="host"))
            for b in MERGE_BLOCKS:
                same[f"{name}/{b}"] = hash_pytree(got[(name, b)]) == want
    emit("merge_path", calls=len(got), launches=merge,
         expected_launches=expected, hashes_equal_host_leg=same,
         engine=engine.report())
    leg = "merge_path"
    hold(leg, "launches", merge == expected, merge, expected)
    hold(leg, "hashes equal the host leg's", all(same.values()), same, True)
    reset_counts()
    rc = check.main(["--device", "cuda"])
    checker = read_counts()
    emit("merge_check", rc=rc, launches=checker)
    others = {k: v for k, v in checker.items() if k != "certified_reduce"}
    leg = "meshagg_check"
    hold(leg, "exit code", rc == 0, rc, 0)
    hold(leg, "B5 launches", checker["certified_reduce"] > 0,
         checker["certified_reduce"], 1)
    hold(leg, "other launches", not any(others.values()), others, 0)
    return {"meshagg_merge": merge, "meshagg_check": checker}


def b5_route_pair(torch, cr, device, m, c, g, bounds, few) -> dict:
    """The routes B5 takes over the blocks `bounds` of `m` ("columns a
    CTA/floats a copy"; 0 is the column kernel) and, where a strip takes
    16-byte copies, the same strips timed with 4-byte copies
    (`vec1_ms`), where the package at hand has both."""
    if not hasattr(cr, "aligned16"):
        return {}
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    shapes = [cr.launch_shape(m.shape[0], hi - lo,
                              cr.aligned16(m[:, lo:hi]), sms)
              for lo, hi in bounds]
    out = {"routes": sorted({f"{cols}/{vec}" for cols, vec in shapes})}
    if any(vec == 4 for _, vec in shapes):
        out["vec1_ms"] = device_ms(torch, lambda: [
            cr._launch(m[:, lo:hi], c, g, cols, 1)
            for (lo, hi), (cols, _) in zip(bounds, shapes)], **few)
    return out


def merge_timing_rows(torch, cr, device, cases, full: bool = True) -> dict:
    """B5 at every geometry and block count (one launch per block) beside
    its bytes bound (N·P·4 read, P·4 written, the coefficients and
    gates), its chain bound (N slots times one slot's dependent step,
    measured by a one-thread chain kernel, where the package has one)
    and `c @ mat`; with `full`, also its plain version and the engine's
    `aggregate_rows` end to end on the host clock (stack, host-to-device
    copy, launches, copy back, the host's model update), median of 3."""
    from bflc_demo_tpu_torch.meshagg import spec
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine

    step_ms = step_cycles = None
    if hasattr(cr, "chain_latency"):
        step_ms, step_cycles = cr.chain_latency(1 << 22, device)
    if full:
        engine = MeshAggEngine(device=device)
        engine.run_selfcheck()
    rows_out = {}
    few = dict(calls=20, replays=3, repeats=5)
    for name, (g_, rows, weights, selected, lr) in cases.items():
        w = spec.merge_weight_vector(weights, selected, len(rows))
        wsum = max(float(w.sum()), 1e-12)
        m, c, g = _b5_card(torch, spec, np.stack(rows), w, wsum, device)
        n, p = m.shape
        moved = n * p * 4 + p * 4 + n * 5
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        t_ops = 2 * n * p / F32_CUDA_CORE_OPS * 1e3
        chain_ms = None if step_ms is None else n * step_ms
        library_ms = device_ms(torch, lambda: c @ m, **few)
        for b in MERGE_BLOCKS:
            bounds = spec.block_bounds(p, b)
            ms = device_ms(torch, lambda: [cr.certified_reduce(
                m[:, lo:hi], c, g) for lo, hi in bounds], **few)
            row = {"ms": ms, "library_ms": library_ms,
                   **b5_route_pair(torch, cr, device, m, c, g, bounds,
                                   few),
                   "library": "torch.matmul(c, mat) (c @ mat; not "
                              "bit-exact: another order, FMA)",
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops else
                   "operations", "share_of_bound": max(t_bytes, t_ops) / ms,
                   "chain_bound_ms": chain_ms, "chain_step_ns":
                   None if step_ms is None else step_ms * 1e6,
                   "chain_step_cycles": step_cycles,
                   "share_of_larger_bound": None if chain_ms is None else
                   max(t_bytes, t_ops, chain_ms) / ms,
                   "bytes": moved, "n": n, "p": p, "blocks": b,
                   "launches_per_call": len(bounds)}
            if full:
                row["plain_ms"] = event_ms(torch, lambda: [
                    cr.certified_reduce_plain(m[:, lo:hi], c, g)
                    for lo, hi in bounds])
                e2e = []
                for _ in range(4):
                    t0 = time.perf_counter()
                    engine.aggregate_rows(g_, rows, weights, selected, lr,
                                          force_leg="mesh", blocks=b)
                    e2e.append(time.perf_counter() - t0)
                row["aggregate_rows_s"] = statistics.median(e2e[1:])
                row["aggregate_rows_first_s"] = e2e[0]
            emit("timing", kernel="certified_reduce", case=name, **row)
            rows_out[(name, b)] = row
        del m, c, g
    return rows_out


def merge_timing_phase(torch, cr, device, cases) -> dict:
    """The timing row of the kernels line: config 5's writer merge at one
    block, with every other geometry and block count under "at"."""
    rows_out = merge_timing_rows(torch, cr, device, cases)
    main = dict(rows_out[(MERGE_MAIN, 1)])
    main["at"] = {f"{name}/{b}": row for (name, b), row in rows_out.items()
                  if (name, b) != (MERGE_MAIN, 1)}
    return main


def decision_check(torch, params, device, model_name: str,
                   recorded: float = None, model=None, data=None,
                   rel_tol: bool = False, tol_factor: float = 1e-4) -> None:
    """A model's decisions on the card (the sponsor's and the committee's
    batch shapes) against the CPU path's on the same params: logits
    within TOL on every row, and the accuracies — the sponsor's and the
    score op of every client's shard — equal, but for a row whose two
    top CPU logits are within 2 TOL of each other (a tie inside the
    tolerance).  By default config 5's transformer on config 5's data,
    TOL 1e-4; else `model` (a factory) on `data` = (shards, test set),
    with TOL = 1e-4 * max(1, max |CPU logit|) where `rel_tol` (float32
    convolutions summed in other orders, cuDNN against the CPU's), and
    `tol_factor` in place of 1e-4 (bfloat16's TOL for a bfloat16 model).
    `recorded`: the sponsor accuracy the run recorded for these params,
    which the card's must equal."""
    from bflc_demo_tpu_torch.client.runtime import feature_tensor
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.models.transformer import \
        make_transformer_classifier

    shards, test_set = data or config5_data()
    model = model or make_transformer_classifier
    sets = {"sponsor": test_set,
            **{f"client{i}": shard for i, shard in enumerate(shards)}}
    cpu_params = {k: p.cpu() for k, p in params.items()}
    card_model = model().to(device)
    cpu_model = model()
    logits = {}
    with torch.no_grad():
        for name, (x, _) in sets.items():
            feats = feature_tensor(x, "cpu")
            logits[name] = (card_model.apply(params, feats.to(device)).cpu(),
                            cpu_model.apply(cpu_params, feats))
    scale = max(float(c.abs().max()) for _, c in logits.values())
    tol = tol_factor * max(1.0, scale) if rel_tol else tol_factor
    acc, err, ties = {}, 0.0, 0
    for name, (on_card, on_cpu) in logits.items():
        labels = torch.as_tensor(sets[name][1]).long()
        err = max(err, float((on_card - on_cpu).abs().max()))
        flips = on_card.argmax(-1) != on_cpu.argmax(-1)
        top2 = on_cpu.topk(2, dim=-1).values
        ties += int((flips & (top2[:, 0] - top2[:, 1] <= 2 * tol)).sum())
        if (flips & (top2[:, 0] - top2[:, 1] > 2 * tol)).any():
            raise gate_failed(f"decisions {model_name}", f"{name} rows "
                              f"decided otherwise than on the CPU",
                              int((flips & (top2[:, 0] - top2[:, 1]
                                            > 2 * tol)).sum()), 0)
        acc[name] = [float((m.argmax(-1) == labels).float().mean())
                     for m in (on_card, on_cpu)]
    emit("decision_check", model=model_name, sets=len(sets),
         rows=sum(len(y) for _, y in sets.values()),
         max_abs_err_vs_cpu=err, tol=tol, max_abs_logit=scale,
         ties_flipped=ties,
         sponsor_acc_card=acc["sponsor"][0], sponsor_acc_cpu=acc["sponsor"][1],
         sponsor_acc_recorded=recorded,
         score_ops_card=[acc[f"client{i}"][0] for i in range(len(shards))],
         score_ops_equal=all(a == b for a, b in acc.values()))
    leg = f"decisions {model_name}"
    hold(leg, "logits vs CPU max_abs_err", err <= tol, err, tol)
    hold(leg, "sponsor accuracy re-evaluated",
         recorded is None or abs(acc["sponsor"][0] - recorded) <= 1e-6,
         acc["sponsor"][0], recorded)


class fleet_env:
    """FLEET_ENV (and `extra`) in os.environ while a fleet spawns (its
    children inherit it), restored after."""

    def __init__(self, extra=None):
        self.env = dict(FLEET_ENV, **(extra or {}))

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def round_seconds(epoch_times) -> list:
    """Seconds a round between successive sponsor-observed commits (the
    sponsor polls every 0.2 s and can see several commits at once: a gap
    spanning k rounds counts k times at 1/k)."""
    out = []
    for (e0, t0), (e1, t1) in zip(epoch_times, epoch_times[1:]):
        out += [(t1 - t0) / (e1 - e0)] * (e1 - e0)
    return out


def fleet_account(label: str, card: str, kernel_launches: dict,
                  engine: dict, perf: dict, epoch_times, spawn_s: float,
                  merges: list, accuracy, replicas_ok: bool,
                  primary: dict = None, **extra) -> tuple:
    """Emit one fleet run's account and hold the merge to B5; return the
    main path's launches (every role's, the self-checks' B5 launches
    taken out: they compare B5 with the host leg) and its B5 launches by
    writer role.  `primary` is a failover drill's primary writer's
    `kernels` reply from just before its kill: `kernel_launches`'
    "writer" is then the promoted one."""
    writer = kernel_launches.get("writer", {})
    check = (engine or {}).get("selfcheck_launches", 0)
    roles = dict(kernel_launches)
    checks = check
    if primary is not None:
        roles["primary"] = primary["launches"]
        checks += primary["engine"].get("selfcheck_launches", 0)
    total = {}
    for counts in roles.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    total["certified_reduce"] = total.get("certified_reduce", 0) - checks
    clients = {}
    for r, counts in roles.items():
        if r.startswith("client-"):
            for k, v in counts.items():
                clients[k] = clients.get(k, 0) + v
    costs = (perf or {}).get("costs", {})
    rounds = len(merges)
    commit_t = [m["t"] for m in merges]
    b5 = writer.get("certified_reduce", 0) - check
    by_role = {"promoted_writer" if primary is not None else "writer": b5}
    if primary is not None:
        by_role["writer"] = (primary["launches"].get("certified_reduce", 0)
                             - primary["engine"].get("selfcheck_launches",
                                                     0))
    emit("processes", path=label, nvidia_smi=card, accuracy=accuracy,
         spawn_s=spawn_s, epoch_times=epoch_times,
         sponsor_round_s=round_seconds(epoch_times),
         # the writer's clock: round r's seconds from commit r-1 to r
         writer_round_s=[b - a for a, b in zip(commit_t, commit_t[1:])],
         merge_s=[m["merge_s"] for m in merges],
         merge_legs=[m["leg"] for m in merges],
         replicas_at_writer_head=replicas_ok,
         writer_perf=costs, writer_engine=engine,
         launches=total, client_launches=clients,
         writer_launches=writer, selfcheck_b5_launches=check,
         b5_by_role=by_role,
         per_round={k: v / max(rounds, 1) for k, v in clients.items()},
         **extra)
    leg = label
    hold(leg, "replicas at the writer head", replicas_ok, replicas_ok, True)
    hold(leg, "engine leg", (engine or {}).get("last_leg") in B5_LEGS,
         (engine or {}).get("last_leg"), list(B5_LEGS))
    hold(leg, "engine self-check", (engine or {}).get("selfcheck") == "ok",
         (engine or {}).get("selfcheck"), "ok")
    hold(leg, "writer B5 launches past the self-check", b5 > 0, b5, 1)
    return total, by_role


def failover_account(res) -> dict:
    """A drill's failover numbers: the kill, the promoted writer's start
    and first commit after it, rounds before and after it, the quorum
    waits and the standby's mirror work, and where the reads went."""
    fo = dict(res.failover)
    primary_info = fo.pop("primary_info") or {}
    fo.pop("primary_kernels", None)
    after = [m for m in res.writer_merges if m["mono"] > fo["kill_mono"]]
    reads = {}
    for counts in res.client_reads.values():
        for k, n in counts.items():
            reads[k] = reads.get(k, 0) + n
    primary_costs = (primary_info.get("perf") or {}).get("costs", {})
    promoted_costs = ((res.final_info or {}).get("perf") or {}).get(
        "costs", {})
    return dict(fo, rounds_before_kill=primary_info.get("rounds_completed"),
        rounds_after_kill=len(after),
        quorum_wait_s=primary_costs.get("quorum.wait_s"),
        quorum_waits=primary_costs.get("quorum.waits"),
        primary_bytes_out=primary_costs.get("wire.bytes_out"),
        primary_send_s=primary_costs.get("wire.send_s"),
        promoted_bytes_out=promoted_costs.get("wire.bytes_out"),
        promoted_send_s=promoted_costs.get("wire.send_s"),
        standby_costs={k: v for k, v in promoted_costs.items()
                       if k.startswith("standby.")},
        client_reads=reads)


def boot_account(res) -> dict:
    """The fleet's boot steps from the children's tracers (`boot.*_s`,
    seconds from each step's start to its end): the writer's, and each
    step's median and largest over the clients."""
    clients = [((perf or {}).get("costs") or {})
               for perf in res.client_perf.values()]
    steps = sorted({k for c in clients for k in c if k.startswith("boot.")})
    return {"writer": {k: v for k, v in _costs(res.final_info).items()
                       if k.startswith("boot.")},
            "clients": {k: [statistics.median(c.get(k, 0.0)
                                              for c in clients),
                            max(c.get(k, 0.0) for c in clients)]
                        for k in steps}}


def fleet_run(torch, label: str, card: str, run, env=None,
              backend: str = "native") -> tuple:
    """`run()` between a reset and a read of the launch counts, with the
    fleet's environment (and `env`), its final writer's ledger held to
    `backend` (`reference_backend` of the leg's configuration); returns
    (result, main-path launches, B5 by writer role)."""
    reset_counts()
    with fleet_env(env):
        res = run()
    torch.cuda.synchronize()
    hold_backend(label, res.writer_backend, backend)
    ok = bool(res.replica_reports) and all(
        r["ok"] and r["head"] == res.ledger_log_head
        for r in res.replica_reports)
    extra = {}
    primary = None
    if res.failover is not None:
        extra["failover"] = failover_account(res)
        primary = res.failover.get("primary_kernels")
    total, by_role = fleet_account(
        label, card, res.kernel_launches, res.writer_engine,
        (res.final_info or {}).get("perf"), res.epoch_times, res.spawn_s,
        res.writer_merges, [a for _, a in res.accuracy_history], ok,
        primary=primary, client_perf=res.client_perf,
        wall_s=res.wall_time_s, ed25519_backend=res.ed25519_backend,
        writer_backend=res.writer_backend,
        ledger_log_size=res.ledger_log_size,
        recovered_clients=res.recovered_clients, phase_s=res.phase_s,
        boot=boot_account(res), **extra)
    return res, total, by_role


def _signed_script(cfg, wallets, init_blob: bytes, deltas, device: str,
                   standby: bool):
    """Round 0 of a signed config-5 script against a writer on `device`
    (threads): every client registers, the first `needed_update_count`
    trainers upload `deltas`, the committee scores.  With `standby` a
    standby on the same device follows it with quorum-ack 1 and the
    writer is closed after the uploads: the standby promotes and the
    scores commit on it.  Returns (model blob, the committing server,
    each upload's reply seconds, close-to-promoted seconds)."""
    import hashlib
    import struct
    import threading

    from bflc_demo_tpu_torch.comm.failover import FailoverClient, Standby
    from bflc_demo_tpu_torch.comm.identity import Wallet, _op_bytes
    from bflc_demo_tpu_torch.comm.ledger_service import LedgerServer
    from bflc_demo_tpu_torch.comm.wire import blob_bytes

    def sign(w, kind, epoch, payload):
        return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()

    sbw = Wallet.from_seed(b"chip-failover-standby-1")
    keys = {1: sbw.public_bytes}
    srv = LedgerServer(cfg, init_blob, stall_timeout_s=300.0, device=device,
                       standby_keys=keys, quorum=1 if standby else 0,
                       quorum_timeout_s=120.0)
    srv.start()
    eps = [(srv.host, srv.port)]
    sb = None
    if standby:
        sb = Standby(cfg, [(srv.host, srv.port), ("127.0.0.1", 0)], 1,
                     stall_timeout_s=300.0, wallet=sbw, standby_keys=keys,
                     device=device)
        sb.endpoints[1] = (sb.host, sb.port)
        eps.append((sb.host, sb.port))
        threading.Thread(target=sb.run, daemon=True).start()
    client = FailoverClient(eps, timeout_s=300.0, standby_keys=keys)
    try:
        deadline = time.monotonic() + 60
        while standby and not any(srv._sub_eligible.values()):
            if time.monotonic() > deadline:
                raise gate_failed("failover_merge", "standby subscribed",
                                  False, True)
            time.sleep(0.05)
        for w in wallets:
            r = client.request("register", addr=w.address,
                               pubkey=w.public_bytes.hex(),
                               tag=sign(w, "register", 0, b""))
            if not r["ok"]:
                raise gate_failed("failover_merge", "register", r, "ok")
        committee = set(client.request("committee")["committee"])
        trainers = [w for w in wallets if w.address not in committee]
        upload_s = []
        for i, w in enumerate(trainers[: cfg.needed_update_count]):
            blob = deltas[i]
            digest = hashlib.sha256(blob).digest()
            payload = digest + struct.pack("<qd", 100 + i, 1.0)
            t0 = time.perf_counter()
            r = client.request("upload", addr=w.address, blob=blob,
                               hash=digest.hex(), n=100 + i, cost=1.0,
                               epoch=0, tag=sign(w, "upload", 0, payload))
            upload_s.append(time.perf_counter() - t0)
            if not r["ok"]:
                raise gate_failed("failover_merge", "upload", r, "ok")
        promote_s = None
        if sb is not None:
            # quorum 1: every acknowledged upload is on the standby
            t0 = time.perf_counter()
            srv.close()
            if not sb.promoted.wait(timeout=120):
                raise gate_failed("failover_merge", "promoted", False,
                                  True)
            promote_s = time.perf_counter() - t0
        n = cfg.needed_update_count
        for j, w in enumerate([w for w in wallets
                               if w.address in committee]):
            scores = [0.5 + 0.01 * ((j + u) % 7) for u in range(n)]
            r = client.request(
                "scores", addr=w.address, epoch=0, scores=scores,
                tag=sign(w, "scores", 0, struct.pack(f"<{n}d", *scores)))
            if not r["ok"]:
                raise gate_failed("failover_merge", "scores", r, "ok")
        r = client.request("model")
        if r.get("epoch") != 1:
            raise gate_failed("failover_merge", "committed epoch",
                              r.get("epoch"), 1)
        return (blob_bytes(r["blob"]), sb.server if sb else srv, upload_s,
                promote_s)
    finally:
        client.close()
        if sb is not None:
            sb.stop()
        srv.close()


def failover_merge_phase(torch, card: str) -> tuple:
    """B5 on a promoted writer, in threads on the card: a writer and a
    standby on `cuda`, config 5's protocol and width (P = 535,298, 10
    admitted deltas), the writer closed after the uploads, the scores
    committing on the promoted standby through the engine's mesh leg
    (`BFLC_MESH_AGG_MIN=1`).  Its model bytes must equal the CPU host
    leg's over the same signed script.  Returns (launches, B5 launches
    of the promoted writer)."""
    from bflc_demo_tpu_torch.comm.identity import provision_wallets
    from bflc_demo_tpu_torch.meshagg.engine import ENGINE
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    from bflc_demo_tpu_torch.utils.serialization import (pack_entries,
                                                         pack_pytree,
                                                         unpack_pytree)

    cfg = ProtocolConfig(**CONFIG5_PROTO)
    model = make_transformer_classifier(**CONFIG5_ARCH)
    init = pack_pytree(model.init_params(0, "cpu"))
    flat = unpack_pytree(init)
    n_params = sum(int(a.size) for a in flat.values())
    if n_params != CONFIG5_PARAMS:
        raise gate_failed("failover_merge", "params", n_params,
                          CONFIG5_PARAMS)
    rng = np.random.default_rng(5)
    deltas = [pack_entries({k: (rng.standard_normal(a.shape) * 0.01).astype(
        np.float32) for k, a in flat.items()})
        for _ in range(cfg.needed_update_count)]
    wallets, _ = provision_wallets(cfg.client_num, b"chip-failover-merge-1")
    # the CPU host leg (10 deltas, below the default min batch of 16)
    want, cpu_srv, cpu_upload_s, _ = _signed_script(
        cfg, wallets, init, deltas, "cpu", standby=False)
    if cpu_srv.engine.last_leg != "host":
        raise gate_failed("failover_merge", "CPU leg",
                          cpu_srv.engine.last_leg, "host")
    check_before = ENGINE.report()["selfcheck"]
    reset_counts()
    with fleet_env():
        got, promoted, upload_s, promote_s = _signed_script(
            cfg, wallets, init, deltas, "cuda", standby=True)
    torch.cuda.synchronize()
    counts = read_counts()
    check = (ENGINE.selfcheck_launches if check_before == "untested"
             else 0)
    counts["certified_reduce"] -= check
    b5 = counts["certified_reduce"]
    merge = promoted.merge_log[0]
    emit("failover_merge", nvidia_smi=card, params=n_params,
         deltas=len(deltas), bytes_equal_host_leg=got == want,
         leg=merge["leg"], promote_s=promote_s, first_merge_s=merge["merge_s"],
         engine_selfcheck_before=check_before, selfcheck_b5_launches=check,
         b5_launches=b5, upload_s_quorum1=upload_s,
         upload_s_cpu_no_standby=cpu_upload_s, launches=counts,
         writer_backend=promoted.ledger.backend)
    leg = "failover_merge"
    hold_backend(leg, promoted.ledger.backend)
    hold(leg, "bytes equal the host leg's", got == want, got == want, True)
    hold(leg, "merge leg", merge["leg"] == "mesh", merge["leg"], "mesh")
    hold(leg, "B5 launches", b5 >= 1, b5, 1)
    hold(leg, "generation", promoted.ledger.generation == 1,
         promoted.ledger.generation, 1)
    return counts, b5


def accuracy_gate(leg: str, res, bar: float,
                  above: bool = False) -> None:
    """Hold a fleet's best accuracy to `bar` (strictly above it where the
    reference's test says "above") and print its `accuracy` line: every
    evaluation, the first at the bar and the evaluations to spare after
    it (the margin the bar rests on)."""
    history = [a for _, a in res.accuracy_history]
    hit = [i for i, a in enumerate(history)
           if (a > bar if above else a >= bar)]
    emit("accuracy", leg=leg, history=history,
         epochs=[e for e, _ in res.accuracy_history], bar=bar,
         evaluations=len(history), first_at_bar=hit[0] if hit else None,
         spare=len(history) - 1 - hit[0] if hit else None)
    hold(leg, "best accuracy" + (" above" if above else ""), bool(hit),
         res.best_accuracy(), bar)


def config5_check(label, res, rounds):
    """A config-5 fleet run finished its rounds over the bar, its clients
    launching K1-K3."""
    clients = {}
    for role, counts in res.kernel_launches.items():
        if role.startswith("client-"):
            for k in DENSE_KERNELS:
                clients[k] = clients.get(k, 0) + counts.get(k, 0)
    leg = label
    hold(leg, "rounds", res.rounds_completed == rounds,
         res.rounds_completed, rounds)
    accuracy_gate(leg, res, MIN_BEST_ACC)
    hold(leg, "client K1-K3 launches",
         all(clients.get(k, 0) > 0 for k in DENSE_KERNELS), clients, 1)


def processes_phase(torch, card: str, keyring: bool = False) -> tuple:
    """The process fleet on the card: the reference's process test, config
    1 through the CLI, config 5 at full width, the crash case, B5 on a
    promoted writer in threads, the reference's failover drill and
    config 5's failover with quorum-ack; with `keyring`,
    `keyring_threaded_config5` in a child process beside the executor's
    config-5 leg.  Returns ({path: launches}, {writer role: B5
    launches})."""
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
    from bflc_demo_tpu_torch.data.occupancy import occupancy_source
    from bflc_demo_tpu_torch.eval.configs import (config5_data,
                                                  config5_transformer_sst2)
    from bflc_demo_tpu_torch.protocol import ProtocolConfig

    xtr, ytr, xte, yte = load_occupancy()
    n = FLEET_PROTO["client_num"] * FLEET_SHARD
    shards = iid_shards(xtr[:n], ytr[:n], FLEET_PROTO["client_num"])
    cfg = ProtocolConfig(**FLEET_PROTO)
    paths, roles = {}, {}

    def note(path, launches_roles):
        paths[path], by_role = launches_roles
        for role, v in by_role.items():
            roles[role] = roles.get(role, 0) + v

    def reference_test(**kw):
        return run_federated_processes(
            "make_softmax_regression", shards, (xte[:500], yte[:500]), cfg,
            device="cuda", timeout_s=FLEET_TIMEOUT_S, **kw)

    # config 1 at its preset through the CLI, as a user runs it, beside
    # the executor's CLI line (two light config-1 fleets at once), both
    # started before the reference's process test, which runs beside them
    executor_cli = executor_cli_start()
    config1_cli = config1_cli_start()
    res, *out = fleet_run(
        torch, "processes_reference", card,
        lambda: reference_test(rounds=FLEET_ROUNDS, stall_timeout_s=20.0,
                               replicas=FLEET_REPLICAS),
        backend=reference_backend(cfg))
    note("processes_reference", out)
    leg = "processes_reference"
    hold(leg, "replicas", len(res.replica_reports) == FLEET_REPLICAS,
         len(res.replica_reports), FLEET_REPLICAS)
    accuracy_gate(leg, res, FLEET_MIN_BEST, above=True)

    proc, t0, base = config1_cli
    try:
        proc.wait(timeout=FLEET_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(base + ".out") as f_out, open(base + ".err") as f_err:
        stdout, stderr = f_out.read(), f_err.read()
    if proc.returncode != 0:
        raise gate_failed("processes_config1", "CLI exit code",
                          proc.returncode, 0, stderr[-4000:])
    cli = json.loads(stdout.strip().splitlines()[-1])
    fleet = cli["fleet"]
    bar = CONFIG1_MIN_BEST[occupancy_source()]
    note("processes_config1", fleet_account(
        "processes_config1", card, fleet["kernel_launches"],
        fleet["writer_engine"], fleet["perf"], fleet["epoch_times"],
        fleet["spawn_s"], fleet["writer_merges"], None,
        fleet["replica_head_ok"], ed25519_backend=fleet["ed25519_backend"],
        writer_backend=fleet["writer_backend"],
        cli_wall_s=time.perf_counter() - t0, best_acc=cli["best_acc"],
        ledger_log_size=cli["ledger_log_size"], bar=bar))
    leg = "processes_config1"
    hold_backend(leg, fleet["writer_backend"])
    hold(leg, "rounds", cli["rounds"] == CONFIG1_ROUNDS, cli["rounds"],
         CONFIG1_ROUNDS)
    hold(leg, "best accuracy", cli["best_acc"] >= bar, cli["best_acc"], bar)
    executor_cli_phase(card, note, executor_cli)

    res, *out = fleet_run(
        torch, "processes_config5", card,
        lambda: config5_transformer_sst2(rounds=FLEET_C5_ROUNDS,
                                         runtime="processes",
                                         device="cuda"),
        backend=reference_backend(ProtocolConfig(**CONFIG5_PROTO)))
    note("processes_config5", out)
    config5_check("processes_config5", res, FLEET_C5_ROUNDS)

    res, *out = fleet_run(
        torch, "processes_crash", card,
        lambda: reference_test(rounds=3, crash_at=FLEET_CRASH,
                               stall_timeout_s=4.0),
        backend=reference_backend(cfg))
    note("processes_crash", out)
    if sorted(res.recovered_clients) != sorted(FLEET_CRASH):
        raise gate_failed("processes_crash", "recovered clients",
                          sorted(res.recovered_clients), sorted(FLEET_CRASH))

    counts, b5 = failover_merge_phase(torch, card)
    paths["failover_merge"] = counts
    roles["promoted_writer"] = roles.get("promoted_writer", 0) + b5

    drill_shards = iid_shards(xtr[:FAILOVER_ROWS], ytr[:FAILOVER_ROWS],
                              FLEET_PROTO["client_num"])
    res, *out = fleet_run(
        torch, "failover_drill", card,
        lambda: run_federated_processes(
            "make_softmax_regression", drill_shards, (xte[:500], yte[:500]),
            cfg, rounds=FAILOVER_ROUNDS, device="cuda",
            timeout_s=FLEET_TIMEOUT_S, **FAILOVER_DRILL),
        backend=reference_backend(cfg))
    note("failover_drill", out)
    failover_check("failover_drill", res, FAILOVER_ROUNDS,
                   FAILOVER_MIN_BEST)

    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    res, *out = fleet_run(
        torch, "failover_config5", card,
        lambda: run_federated_processes(
            "make_transformer_classifier", c5_shards, c5_test,
            ProtocolConfig(**CONFIG5_PROTO), rounds=FLEET_C5_ROUNDS,
            factory_kw=CONFIG5_ARCH, device="cuda",
            timeout_s=FLEET_TIMEOUT_S, **CONFIG5_FAILOVER),
        backend=reference_backend(ProtocolConfig(**CONFIG5_PROTO)))
    note("failover_config5", out)
    config5_check("failover_config5", res, FLEET_C5_ROUNDS)
    failover_check("failover_config5", res, FLEET_C5_ROUNDS, MIN_BEST_ACC)

    bft5 = bft_phase(torch, card, note, drill_shards, (xte[:500], yte[:500]),
                     c5_shards, c5_test)
    snapshot_phase(torch, card, note, c5_shards, c5_test, bft5)
    async_phase(torch, card, note, c5_shards, c5_test)
    codecs_phase(torch, card, note, c5_shards, c5_test, drill_shards,
                 (xte[:500], yte[:500]), bft5)
    hier_phase(torch, card, note, c5_shards, c5_test, drill_shards,
               (xte[:500], yte[:500]))
    rederive_config5_phase(torch, card, note, c5_shards, c5_test)
    child = keyring_child_start() if keyring else None
    executor_phase(torch, card, note, cli=False)
    if child:
        note("keyring_threaded_config5", (keyring_child_finish(child), {}))
    return paths, roles


def _spliced(primary: list, final: list, start: int) -> list:
    """Records of one chain keyed by position `i`: the primary writer's
    below `start` (where the promoted writer's chain record begins), the
    promoted writer's from there (the primary may hold an uncertified
    tail the promoted chain replaced)."""
    return sorted([r for r in primary or [] if r["i"] < start]
                  + list(final or []), key=lambda r: r["i"])


def b5_merge_ms(torch, n: int, p: int, blocks: int) -> float:
    """B5's device ms for one merge of `n` rows of `p` float32 at
    `blocks` blocks (one launch a block), on seeded rows."""
    from bflc_demo_tpu_torch.meshagg import spec
    from bflc_demo_tpu_torch.ops import certified_reduce as cr
    rng = np.random.default_rng(13)
    rows = rng.standard_normal((n, p)).astype(np.float32)
    w = spec.merge_weight_vector([1.0] * n, list(range(min(6, n))), n)
    m_, c_, g_ = _b5_card(torch, spec, rows, w, float(w.sum()), "cuda")
    bounds = spec.block_bounds(p, blocks)
    return device_ms(torch, lambda: [cr.certified_reduce(
        m_[:, lo:hi], c_, g_) for lo, hi in bounds],
        calls=20, replays=3, repeats=5)


def async_phase(torch, card: str, note, c5_shards, c5_test) -> None:
    """(h) `async_config5`: config 5's async FedBuff fleet (`ASYNC_PROTO`,
    `ASYNC_FLEET`) between a reset and a read of the launch counts.
    Holds: every op certified and the replica at the final head; no
    opcode 2/3/4 on the chain; every opcode-12 op drains k = 10 with the
    BLK1 claim B = 8, the even drains (2, 4, 6, ...) seated and the odd
    ones not; B5 8 a drain on both writers past 6 at each self-check, the
    promoted writer's first drain on B5; K2 == K3 == 20 a training, K1
    20 a training + 2 a scored entry in the clients and 2 an evaluation
    in the sponsor; snapshot ops at every even epoch (2, 4, 6, ...); the
    promoted standby GC'd behind a snapshot whose state carries the async
    and acommit tails before it promoted; best >= 0.9 over 14 epochs.
    Prints one `async` line."""
    import shutil

    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.ledger.snapshot import (decode_state,
                                                     list_snapshot_files,
                                                     read_snapshot_file)
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    work = os.path.join(WORK_DIR, "async")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = ProtocolConfig(**CONFIG5_PROTO, **ASYNC_PROTO)
    t0 = time.perf_counter()
    res, total, by_role = fleet_run(
        torch, "async_config5", card,
        lambda: run_federated_processes(
            "make_transformer_classifier", c5_shards, c5_test, cfg,
            rounds=ASYNC_EPOCHS, factory_kw=CONFIG5_ARCH, device="cuda",
            timeout_s=FLEET_TIMEOUT_S,
            snapshot_dir=os.path.join(work, "snaps"), **ASYNC_FLEET),
        backend=reference_backend(cfg, compacts=bool(
            ASYNC_FLEET.get("snapshot_interval"))))
    leg_s = time.perf_counter() - t0
    bft_account("async_config5", card, res, BFT_CONFIG5_BLOCKS)
    note("async_config5", (total, by_role))

    fo = res.failover or {}
    primary_k = fo.get("primary_kernels") or {}
    primary_chain = primary_k.get("chain") or {"from": 0, "opcodes": []}
    chain = res.writer_chain or {"from": 0, "opcodes": []}
    start = chain["from"]
    codes = primary_chain["opcodes"][:start - primary_chain["from"]] + \
        chain["opcodes"]
    opcodes = {c: codes.count(c) for c in sorted(set(codes) - {None})}
    drains = _spliced(primary_chain.get("acommits"), chain.get("acommits"),
                      start)
    seated = [d for d, r in enumerate(drains, 1) if r["seats"] is not None]
    merges = {m["epoch"]: m for m in (primary_k.get("merges") or [])}
    merges.update({m["epoch"]: m for m in res.writer_merges})
    merges = [merges[e] for e in sorted(merges)]
    snaps = _spliced(primary_k.get("snapshots"), res.writer_snapshots, start)
    after = [m for m in res.writer_merges
             if m.get("mono", 0) > fo.get("kill_mono", float("inf"))]
    engines = {"writer": primary_k.get("engine") or {},
               "promoted_writer": res.writer_engine or {}}

    clients = {k: 0 for k in DENSE_KERNELS}
    for role, counts in res.kernel_launches.items():
        if role.startswith("client-"):
            for k in DENSE_KERNELS:
                clients[k] += counts.get(k, 0)
    trainings = sum(c["trainings"] for c in res.client_counts.values())
    scored = sum(c["scored"] for c in res.client_counts.values())
    replies = {"aupload": {}, "ascores": {}}
    for c in res.client_counts.values():
        for kind, by_status in replies.items():
            for status, n in c[kind].items():
                by_status[status] = by_status.get(status, 0) + n
    evaluations = len(res.accuracy_history)
    sponsor_k1 = res.kernel_launches.get("sponsor", {}).get("flash_fwd", 0)
    want = {"flash_dkdv": ASYNC_K_TRAIN * trainings,
            "flash_dq": ASYNC_K_TRAIN * trainings,
            "flash_fwd": ASYNC_K_TRAIN * trainings
            + ASYNC_K1_FORWARD * scored}

    artifacts = list_snapshot_files(os.path.join(work, "snaps",
                                                 "standby-1"))
    tails = None
    if artifacts:
        st = decode_state(read_snapshot_file(artifacts[-1])["state"])
        tails = {"async_buffer": len(st["async"][1]) if st["async"]
                 else None, "async_acommits": st["async_acommits"]}
    events = res.standby_events.get("standby-1", [])
    kinds = [next(iter(e)) for e in events]

    # warm drains (each writer's first is its cold one) beside B5's own
    # time at the drain's geometry, timed here after the launch counts
    # were read
    warm = [m for m in merges
            if m is not merges[0] and (not after or m is not after[0])]
    b5_ms = b5_merge_ms(torch, 10, CONFIG5_PARAMS, BFT_CONFIG5_BLOCKS)
    warm_ms = [m["merge_s"] * 1e3 for m in warm]
    t_first = merges[0]["mono"] if merges else 0.0
    costs = {}
    for info in (fo.get("primary_info"), res.final_info):
        for k, v in _costs(info).items():
            costs[k] = costs.get(k, 0) + v
    emit("async", path="async_config5", nvidia_smi=card,
         spawn_s=res.spawn_s, validator_spawn_s=res.validator_spawn_s,
         leg_s=leg_s, wall_s=res.wall_time_s,
         epoch_times_writer=[[m["epoch"], m["mono"] - t_first]
                             for m in merges],
         epoch_times_sponsor=res.epoch_times,
         drains=[{"epoch": m["epoch"], "depth": m.get("drained"),
                  "staleness": {str(s): m.get("staleness", []).count(s)
                                for s in sorted(set(m.get("staleness",
                                                          [])))}}
                 for m in merges],
         chain_drains=drains, seated_drains=seated, opcodes=opcodes,
         chain_ops=len(codes),
         chain_from=[primary_chain["from"], start],
         replies=replies, trainings=trainings,
         scored_entries=scored, sponsor_evaluations=evaluations,
         client_launches=clients, sponsor_k1=sponsor_k1,
         expected_client_launches=want,
         certify_s_per_epoch=costs.get("bft.certify_s", 0.0)
         / max(len(drains), 1),
         warm_drain_ms=warm_ms,
         warm_drain_engine_ms=[m.get("engine_s", 0) * 1e3 for m in warm],
         b5_ms_per_drain=b5_ms,
         b5_share_of_warm_drain=(b5_ms / statistics.median(warm_ms)
                                 if warm_ms else None),
         failover_gap_s=fo.get("gap_s"), promote_s=fo.get("promote_s"),
         killed_at_epoch=fo.get("killed_at_epoch"), settle=fo.get("settle"),
         first_drain_after_kill=after[:1],
         promoted_start=res.writer_start, standby_events=events,
         standby_snapshot_tails=tails,
         snapshot_epochs=[r["epoch"] for r in snaps],
         b5_selfcheck={k: e.get("selfcheck_launches")
                       for k, e in engines.items()},
         certified_size=res.certified_size, log_size=res.ledger_log_size,
         accuracy=[a for _, a in res.accuracy_history],
         best=res.best_accuracy())

    leg = "async_config5"
    hold(leg, "epochs", res.rounds_completed >= ASYNC_EPOCHS,
         res.rounds_completed, ASYNC_EPOCHS)
    accuracy_gate(leg, res, MIN_BEST_ACC)
    # the chain may grow past the final `info` by a late client op
    hold(leg, "chain records cover every op",
         primary_chain["from"] == 0
         and len(codes) >= res.ledger_log_size
         and start <= len(primary_chain["opcodes"])
         and None not in codes,
         [primary_chain["from"], len(primary_chain["opcodes"]), start,
          len(codes)], [0, "-", "-", res.ledger_log_size])
    hold(leg, "opcodes on the chain",
         not {2, 3, 4} & set(opcodes) and {10, 12} <= set(opcodes),
         opcodes, "10 and 12, no 2/3/4")
    hold(leg, "drains", len(drains) >= ASYNC_EPOCHS and not any(
  r["k"] != cfg.async_buffer or r["blocks"] != BFT_CONFIG5_BLOCKS
  or (r["seats"] is not None and len(r["seats"]) != cfg.comm_count)
  for r in drains), drains,
  f">= {ASYNC_EPOCHS}, k {cfg.async_buffer}, B {BFT_CONFIG5_BLOCKS}")
    hold(leg, "seated drains",
         seated == [d for d in range(1, len(drains) + 1)
                    if d % 2 == 0], seated, "even")
    hold(leg, "B5 self-checks", all(
  e.get("selfcheck_launches") == B5_SELFCHECK_LAUNCHES
  for e in engines.values()),
  {k: e.get("selfcheck_launches") for k, e in engines.items()},
  B5_SELFCHECK_LAUNCHES)
    hold(leg, "failover generation", fo.get("gen") == 1, fo.get("gen"), 1)
    hold(leg, "first drain after the kill on B5",
         bool(after) and after[0]["leg"] in B5_LEGS,
         after[0]["leg"] if after else None, list(B5_LEGS))
    hold(leg, "client launches", {k: clients[k] for k in want} == want,
         clients, want)
    hold(leg, "sponsor K1 launches",
         sponsor_k1 == ASYNC_K1_FORWARD * evaluations, sponsor_k1,
         ASYNC_K1_FORWARD * evaluations)
    even = list(range(2, res.rounds_completed + 1, 2))
    epochs = [r["epoch"] for r in snaps]
    hold(leg, "snapshot epochs", set(ASYNC_SNAPSHOT_EPOCHS) <= set(epochs)
         <= set(even), epochs, ASYNC_SNAPSHOT_EPOCHS)
    hold(leg, "promoted standby GC'd before it promoted",
         "gc" in kinds and "promoted" in kinds
         and kinds.index("gc") < kinds.index("promoted")
         and (res.writer_start or {}).get("log_base", 0) > 0, kinds,
         ["gc", "promoted"])
    hold(leg, "standby snapshot tails",
         bool(tails) and tails["async_buffer"] is not None
         and tails["async_acommits"] is not None, tails,
         "async and acommit tails")


def codec_numbers(res, rounds: int) -> dict:
    """A codec leg's encode and decode costs and bytes: the clients'
    encode ms an upload, the writer's admission decode ms a blob, the
    blob bytes an upload, the writer's `wire.*` a round, and each
    validator refusal by status."""
    enc_s = enc_n = 0.0
    for perf in res.client_perf.values():
        costs = (perf or {}).get("costs", {})
        enc_s += costs.get("client.encode_s", 0.0)
        enc_n += costs.get("client.encode_n", 0.0)
    writer = _costs(res.final_info)
    counts = res.client_counts.values()
    uploads = sum(c["trainings"] for c in counts)
    return dict(
        encode_ms_per_upload=1e3 * enc_s / max(enc_n, 1),
        uploads_encoded=enc_n,
        decode_ms_per_blob=1e3 * writer.get("admit.decode_s", 0.0)
        / max(writer.get("admit.decode_n", 0.0), 1),
        blobs_decoded=writer.get("admit.decode_n", 0.0),
        blob_bytes_per_upload=sum(c["blob_bytes"] for c in counts)
        / max(uploads, 1),
        wire_per_round=_per_round(writer, "wire.", rounds),
        refusals={k: v for k, v in writer.items()
                  if k.startswith("bft.refused.")})


def codecs_phase(torch, card: str, note, c5_shards, c5_test, drill_shards,
                 drill_test, bft5) -> None:
    """The upload codecs on the card, every client with error feedback:
    (i) `sparse_config5` (`SPARSE_PROTO`, `SPARSE_FLEET`), config 5 at
    full width; (j) `sketch_async_drill` (`SKETCH_PROTO`,
    `SKETCH_FLEET`).  Holds: every op certified with no `SPARSE`
    refusal, B5 at B launches a merge or a drain on the decoded rows
    (blocks 8 and 2), the replica at the writer's head, K1-K3 in config
    5's clients by the arithmetic (20 a training; K1 also 2 a scored
    candidate, and 2 an evaluation in the sponsor), `sparse_config5`'s
    writer ingress a round at least `SPARSE_INGRESS_RATIO` below
    `bft5`'s (`bft_config5`, the dense twin, in the same script), and
    each leg's best at its bar.  Prints one `codecs` line a leg: the
    encode ms an upload, the admission decode ms a blob, B5's share of a
    warm merge, `wire.*` a round beside `bft_config5`'s and the blob
    bytes an upload beside the dense blob's."""
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                            make_transformer_classifier)
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    from bflc_demo_tpu_torch.utils.serialization import pack_pytree
    bft5_rounds = max(len(bft5.writer_merges), 1)
    bft5_wire = _per_round(_costs(bft5.final_info), "wire.", bft5_rounds)
    legs = (
        ("sparse_config5", "make_transformer_classifier", c5_shards,
         c5_test, ProtocolConfig(**CONFIG5_PROTO, **SPARSE_PROTO),
         FLEET_C5_ROUNDS, dict(factory_kw=CONFIG5_ARCH, **SPARSE_FLEET),
         SPARSE_MIN_BEST,
         make_transformer_classifier(**CONFIG5_ARCH).init_params(0, "cpu")),
        ("sketch_async_drill", "make_softmax_regression", drill_shards,
         drill_test, ProtocolConfig(**FLEET_PROTO, **SKETCH_PROTO),
         SKETCH_EPOCHS, SKETCH_FLEET, SKETCH_MIN_BEST,
         make_softmax_regression().init_params(0, "cpu")))
    for label, model, shards, test, cfg, rounds, fleet, bar, init in legs:
        dense = len(pack_pytree(init))
        params = sum(int(v.numel()) for v in init.values())
        t0 = time.perf_counter()
        res, total, _ = fleet_run(
            torch, label, card,
            lambda: run_federated_processes(
                model, shards, test, cfg, rounds=rounds, device="cuda",
                timeout_s=FLEET_TIMEOUT_S, **fleet), env=CODEC_ENV,
            backend=reference_backend(cfg))
        leg_s = time.perf_counter() - t0
        note(label, (total, bft_account(label, card, res,
                                        cfg.reduce_blocks)))
        merges = res.writer_merges
        nums = codec_numbers(res, len(merges))
        warm_ms = [m["merge_s"] * 1e3 for m in merges[1:]]
        # B5 at the leg's merge (10 admitted) or drain (K = 3) geometry
        b5_ms = b5_merge_ms(torch, cfg.async_buffer or
                            cfg.needed_update_count, params,
                            cfg.reduce_blocks)
        clients = {k: 0 for k in DENSE_KERNELS}
        for role, counts in res.kernel_launches.items():
            if role.startswith("client-"):
                for k in DENSE_KERNELS:
                    clients[k] += counts.get(k, 0)
        trainings = sum(c["trainings"] for c in res.client_counts.values())
        scored = sum(c["scored"] for c in res.client_counts.values())
        evaluations = len(res.accuracy_history)
        sponsor_k1 = res.kernel_launches.get("sponsor", {}).get(
            "flash_fwd", 0)
        k_per = ASYNC_K_TRAIN if label == "sparse_config5" else 0
        want = {"flash_dkdv": k_per * trainings,
                "flash_dq": k_per * trainings,
                "flash_fwd": k_per * trainings
                + (ASYNC_K1_FORWARD * scored if k_per else 0)}
        replies = {}
        for c in res.client_counts.values():
            for status, n in c["aupload"].items():
                replies[status] = replies.get(status, 0) + n
        # the dense twin's wire: config 5's leg only
        twin = bft5_wire if label == "sparse_config5" else None
        ingress = nums["wire_per_round"].get("wire.bytes_in", 0.0)
        ratio = (twin.get("wire.bytes_in", 0.0) / ingress
                 if twin and ingress else None)
        emit("codecs", path=label, nvidia_smi=card,
             delta_dtype=cfg.delta_dtype, delta_density=cfg.delta_density,
             delta_codec=cfg.delta_codec, spawn_s=res.spawn_s,
             validator_spawn_s=res.validator_spawn_s, leg_s=leg_s,
             rounds=res.rounds_completed, **nums,
             dense_blob_bytes=dense,
             blob_share_of_dense=nums["blob_bytes_per_upload"] / dense,
             bft_config5_wire_per_round=twin,
             ingress_ratio_vs_bft_config5=ratio,
             merge_legs=[m["leg"] for m in merges],
             warm_merge_ms=warm_ms, b5_ms_per_merge=b5_ms,
             b5_share_of_warm_merge=(b5_ms / statistics.median(warm_ms)
                                     if warm_ms else None),
             trainings=trainings, scored_entries=scored,
             client_launches=clients, expected_client_launches=want,
             sponsor_k1=sponsor_k1, aupload_replies=replies,
             certified_size=res.certified_size,
             log_size=res.ledger_log_size,
             accuracy=[a for _, a in res.accuracy_history],
             best=res.best_accuracy(), bar=bar)
        leg = label
        hold(leg, "rounds", res.rounds_completed >= rounds,
             res.rounds_completed, rounds)
        if bar is None:
            emit("accuracy", leg=label,
                 history=[a for _, a in res.accuracy_history], bar=None)
        else:
            accuracy_gate(leg, res, bar)
        hold(leg, "SPARSE refusals",
             not nums["refusals"].get("bft.refused.SPARSE"),
             nums["refusals"].get("bft.refused.SPARSE", 0), 0)
        hold(leg, "blobs decoded", nums["blobs_decoded"] > 0,
             nums["blobs_decoded"], 1)
        hold(leg, "merge legs", all(m["leg"] in B5_LEGS for m in merges),
             [m["leg"] for m in merges], list(B5_LEGS))
        hold(leg, "client launches", clients == want, clients, want)
        hold(leg, "sponsor K1 launches", sponsor_k1 == (
      ASYNC_K1_FORWARD * evaluations if k_per else 0), sponsor_k1,
      ASYNC_K1_FORWARD * evaluations if k_per else 0)
        if label == "sparse_config5":
            hold(leg, "writer ingress below bft_config5's", bool(
          ratio and ratio >= SPARSE_INGRESS_RATIO), ratio,
          SPARSE_INGRESS_RATIO)
        hold(leg, "aupload replies", not set(replies) - {
      "OK", "DUPLICATE", "CAP_REACHED", "WRONG_EPOCH"}, replies,
      ["OK", "DUPLICATE", "CAP_REACHED", "WRONG_EPOCH"])


def hier_account(label: str, card: str, res, leg_s: float,
                 dense_partial: int) -> tuple:
    """Emit a hier fleet's `hier` line and hold what every hier leg
    holds: every root op certified, at most 2 x (cells + 1) root ops a
    round and none sent by a member, every live cell's partials on B5
    (its launches past the self-check at the genome's blocks a partial)
    and every root merge at its blocks (`bft_account`), no validator
    refusal, no BAD_ARG reply to a bridge.  Returns (main-path launches,
    B5 by role: `cell` and `bft_writer`)."""
    plan = res.cell_plan
    rounds = max(res.rounds_completed, 1)
    blocks = (res.writer_merges or [{}])[-1].get("blocks", 1)
    by_role = bft_account(label, card, res, blocks)
    cells = {}
    for c, merges in sorted(res.cell_merges.items()):
        launches = res.kernel_launches.get(f"cell-{c}", {})
        check = res.cell_engines[c].get("selfcheck_launches", 0)
        cells[c] = {"b5": launches.get("certified_reduce", 0) - check,
                    "selfcheck": check, "k1": launches.get("flash_fwd", 0),
                    "partials": len(merges),
                    "legs": sorted({m["leg"] for m in merges}),
                    "blocks": sorted({m["blocks"] for m in merges}),
                    "merge_ms": [m["merge_s"] * 1e3 for m in merges],
                    "engine_ms": [m["engine_s"] * 1e3 for m in merges],
                    "blob_bytes": [m["blob_bytes"] for m in merges],
                    "bridge": res.cell_bridge.get(c, {})}
    by_role["cell"] = sum(c["b5"] for c in cells.values())
    total = {}
    for counts in res.kernel_launches.values():
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    total["certified_reduce"] = total.get("certified_reduce", 0) - (
        (res.writer_engine or {}).get("selfcheck_launches", 0)
        + sum(c["selfcheck"] for c in cells.values()))
    members = set(res.member_addresses)
    senders = {o["sender"] for o in res.root_ops if o["sender"]}
    registers = sum(o["op"] == "register" for o in res.root_ops)
    ops_per_round = (len(res.root_ops) - registers) / rounds
    costs = _costs(res.final_info)
    wire = _per_round(costs, "wire.", rounds)
    ingress = wire.get("wire.bytes_in", 0.0)
    refusals = {k: v for k, v in costs.items()
                if k.startswith("bft.refused.")}
    bad_arg = {c: v["bridge"] for c, v in cells.items()
               if any("BAD_ARG" in r for r in v["bridge"].values())}
    warm = [ms for c in cells.values() for ms in c["merge_ms"][1:]]
    hold_backend(label, res.writer_backend)
    emit("hier", path=label, nvidia_smi=card, cells=plan.n_cells,
         writer_backend=res.writer_backend,
         members=[list(m) for m in plan.members],
         killed_cells=res.killed_cells,
         client_exitcodes=res.client_exitcodes, spawn_s=res.spawn_s,
         validator_spawn_s=res.validator_spawn_s, leg_s=leg_s,
         rounds=res.rounds_completed, round_s=round_seconds(res.epoch_times),
         root_ops_per_round=ops_per_round, root_log_size=res.ledger_log_size,
         root_wire_per_round=wire, dense_partial_bytes=dense_partial,
         ingress_ratio_vs_dense_partial=(dense_partial / ingress
                                         if ingress else None),
         root_merge_ms=[m["merge_s"] * 1e3 for m in res.writer_merges],
         cells_detail=cells, cell_warm_merge_ms=warm,
         cell_warm_merge_ms_median=(statistics.median(warm) if warm
                                    else None),
         refusals=refusals, b5_by_role=by_role, phase_s=res.phase_s,
         accuracy=[a for _, a in res.accuracy_history])
    leg = label
    hold(leg, "root ops a round", ops_per_round <= 2 * (plan.n_cells + 1),
         ops_per_round, 2 * (plan.n_cells + 1))
    hold(leg, "member addresses known", len(members) == plan.n_clients,
         len(members), plan.n_clients)
    hold(leg, "member addresses among the root's senders",
         not senders & members, sorted(senders & members), [])
    bad = {c: v for c, v in cells.items()
           if v["b5"] != v["partials"] * max(v["blocks"] or [1])
           or not v["partials"] or not set(v["legs"]) <= set(B5_LEGS)}
    hold(leg, "cell B5 launches a partial", not bad, bad,
         "the genome's blocks a cell round on " + "/".join(B5_LEGS))
    hold(leg, "validator refusals", not refusals, refusals, {})
    hold(leg, "BAD_ARG replies to a bridge", not bad_arg, bad_arg, {})
    return total, by_role


def hier_phase(torch, card: str, note, c5_shards, c5_test, drill_shards,
               drill_test) -> None:
    """(k) `hier_config5` and (l) `hier_rehome_drill` (the constants
    above), each between a reset and a read of the launch counts, every
    process under FLEET_ENV (B5 on every partial and root merge), the
    config-5 members with error feedback; each held by `hier_account`
    and `hier_leg_check`."""
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    from bflc_demo_tpu_torch.hier.partial import partial_blob
    from bflc_demo_tpu_torch.hier.runtime import run_federated_hier
    from bflc_demo_tpu_torch.models import (make_softmax_regression,
                                            make_transformer_classifier)
    from bflc_demo_tpu_torch.protocol import ProtocolConfig

    def dense_partial(model) -> int:
        init = {k: v.numpy() for k, v in model.init_params(0, "cpu").items()}
        return len(partial_blob(init, 0, 1, b"\0" * 32))

    legs = (
        ("hier_config5", lambda: config5_transformer_sst2(
            rounds=HIER_C5_ROUNDS, runtime="processes", device="cuda",
            cells=HIER_CELLS, bft_validators=BFT_VALIDATORS,
            cfg=ProtocolConfig(**CONFIG5_PROTO, **HIER_PROTO)),
         dense_partial(make_transformer_classifier(**CONFIG5_ARCH)),
         HIER_C5_ROUNDS),
        ("hier_rehome_drill", lambda: run_federated_hier(
            "make_softmax_regression", drill_shards, drill_test,
            ProtocolConfig(**FLEET_PROTO), rounds=HIER_DRILL_ROUNDS,
            cells=HIER_DRILL_CELLS, device="cuda",
            timeout_s=FLEET_TIMEOUT_S, **HIER_DRILL),
         dense_partial(make_softmax_regression()), HIER_DRILL_ROUNDS))
    for label, run, dense, rounds in legs:
        reset_counts()
        t0 = time.perf_counter()
        with fleet_env(CODEC_ENV if label == "hier_config5" else None):
            res = run()
        torch.cuda.synchronize()
        leg_s = time.perf_counter() - t0
        total, by_role = hier_account(label, card, res, leg_s, dense)
        note(label, (total, by_role))
        hier_leg_check(label, res, dense, rounds)


def hier_leg_check(leg: str, res, dense_partial: int, rounds: int) -> None:
    """A hier leg's own gates: its rounds; for `hier_config5` the best
    at HIER_MIN_BEST, the root's ingress a round at least
    HIER_INGRESS_RATIO below a dense partial's bytes, K1 in the
    aggregators and K1-K3 in the members; for the drill the best above
    HIER_DRILL_MIN_BEST, cell 1 killed and its members' exit 0."""
    hold(leg, "rounds", res.rounds_completed >= rounds,
         res.rounds_completed, rounds)
    if leg == "hier_config5":
        accuracy_gate(leg, res, HIER_MIN_BEST)
        ingress = _per_round(_costs(res.final_info), "wire.",
                             res.rounds_completed).get("wire.bytes_in")
        ratio = dense_partial / ingress if ingress else None
        hold(leg, "root ingress a round below a dense partial's bytes",
             bool(ratio) and ratio >= HIER_INGRESS_RATIO, ratio,
             HIER_INGRESS_RATIO)
        k1 = {c: res.kernel_launches.get(f"cell-{c}", {}).get(
            "flash_fwd", 0) for c in res.cell_merges}
        hold(leg, "aggregator K1 launches", sum(k1.values()) > 0, k1, 1)
        members = {k: sum(v.get(k, 0) for r, v in
                          res.kernel_launches.items()
                          if r.startswith("client-"))
                   for k in DENSE_KERNELS}
        hold(leg, "member K1-K3 launches",
             all(v > 0 for v in members.values()), members, 1)
        return
    accuracy_gate(leg, res, HIER_DRILL_MIN_BEST, above=True)
    orphans = {i: res.client_exitcodes[i] for c in res.killed_cells
               for i in res.cell_plan.members[c]}
    hold(leg, "killed cells", res.killed_cells == [1], res.killed_cells,
         [1])
    hold(leg, "orphaned members' exit codes",
         bool(orphans) and all(v == 0 for v in orphans.values()), orphans,
         0)


def bft_phase(torch, card: str, note, drill_shards, drill_test, c5_shards,
              c5_test):
    """BFT commit certificates: the drill and config 5, every op co-signed
    by 4 validator processes, the writers merging at B blocks; `note`
    records each run's launches and B5 by writer role.  Returns the
    config-5 run's result (its wire numbers are the plaintext twin of
    the TLS leg's)."""
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    cfg = ProtocolConfig(**FLEET_PROTO, reduce_blocks=BFT_DRILL_BLOCKS)
    res, total, _ = fleet_run(
        torch, "bft_drill", card,
        lambda: run_federated_processes(
            "make_softmax_regression", drill_shards, drill_test, cfg,
            rounds=FAILOVER_ROUNDS, device="cuda",
            timeout_s=FLEET_TIMEOUT_S, bft_validators=BFT_VALIDATORS,
            **FAILOVER_DRILL), backend=reference_backend(cfg))
    note("bft_drill", (total, bft_account("bft_drill", card, res,
                                          BFT_DRILL_BLOCKS)))
    leg = "bft_drill"
    hold(leg, "rounds", res.rounds_completed >= FAILOVER_ROUNDS,
         res.rounds_completed, FAILOVER_ROUNDS)
    accuracy_gate(leg, res, FAILOVER_MIN_BEST)
    hold(leg, "failover generation", (res.failover or {}).get("gen") == 1,
         (res.failover or {}).get("gen"), 1)

    return bft_config5_run(torch, card, note, c5_shards, c5_test)


def bft_config5_run(torch, card: str, note, c5_shards, c5_test):
    """(e) `bft_config5`: config 5 at full width, 4 validators at 8
    blocks, 9 rounds; returns its result (the dense, plaintext twin of
    the TLS and the sparse legs)."""
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    cfg = ProtocolConfig(**CONFIG5_PROTO, reduce_blocks=BFT_CONFIG5_BLOCKS)
    res, total, _ = fleet_run(
        torch, "bft_config5", card,
        lambda: run_federated_processes(
            "make_transformer_classifier", c5_shards, c5_test, cfg,
            rounds=FLEET_C5_ROUNDS, factory_kw=CONFIG5_ARCH,
            device="cuda", timeout_s=FLEET_TIMEOUT_S,
            bft_validators=BFT_VALIDATORS), backend=reference_backend(cfg))
    note("bft_config5", (total, bft_account("bft_config5", card, res,
                                            BFT_CONFIG5_BLOCKS)))
    config5_check("bft_config5", res, FLEET_C5_ROUNDS)
    return res


def _costs(info) -> dict:
    return ((info or {}).get("perf") or {}).get("costs", {})


def _per_round(costs: dict, prefix: str, rounds: int) -> dict:
    return {k: v / max(rounds, 1) for k, v in sorted(costs.items())
            if k.startswith(prefix)}


def snapshot_artifacts(root: str, keys: dict, quorum: int) -> dict:
    """Every artifact under `root`/<role>/ read back and held to
    `verify_snapshot_meta` under the validators' keys: {role: [(file,
    bytes, reason)]}, reason '' when installable."""
    from bflc_demo_tpu_torch.ledger.snapshot import (list_snapshot_files,
                                                     read_snapshot_file,
                                                     verify_snapshot_meta)
    out = {}
    for role in sorted(os.listdir(root)):
        out[role] = []
        for path in list_snapshot_files(os.path.join(root, role)):
            try:
                why = verify_snapshot_meta(read_snapshot_file(path),
                                           bft_quorum=quorum, bft_keys=keys)
            except ValueError as e:
                why = f"unreadable: {e}"
            out[role].append((os.path.basename(path),
                              os.path.getsize(path), why))
    return out


def wal_account(path: str, cfg) -> dict:
    """A journal's magic and what replaying it into a fresh python
    ledger gives (a compacted BFLCWAL2 journal: the native ledger reads
    BFLCWAL1 only)."""
    from bflc_demo_tpu_torch.ledger import make_ledger
    with open(path, "rb") as f:
        magic = f.read(8).decode()
    led = make_ledger(cfg, backend="python")
    led.replay_wal(path)
    return {"magic": magic, "log_size": led.log_size(),
            "log_base": led.log_base, "log_head": led.log_head().hex(),
            "bytes": os.path.getsize(path)}


def snapshot_phase(torch, card: str, note, c5_shards, c5_test,
                   bft5) -> None:
    """TLS and certified snapshots on the card: (f) `tls_snapshot_config5`,
    config 5 at full width over TLS with 4 validators at 8 blocks, a
    standby, a snapshot every 2 rounds and the primary SIGKILLed after
    epoch 4; (g) `snapshot_rejoin`, the drill of
    `eval/snapshot_drill.py`.  `bft5` is `bft_config5`'s result, the
    plaintext twin whose wire numbers the TLS leg's print beside."""
    import shutil

    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.comm.bft import provision_validators
    from bflc_demo_tpu_torch.protocol import ProtocolConfig, bft_quorum
    work = os.path.join(WORK_DIR, "tls_snapshot")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cfg = ProtocolConfig(**CONFIG5_PROTO, reduce_blocks=BFT_CONFIG5_BLOCKS)
    wal = os.path.join(work, "writer.wal")
    res, total, _ = fleet_run(
        torch, "tls_snapshot_config5", card,
        lambda: run_federated_processes(
            "make_transformer_classifier", c5_shards, c5_test, cfg,
            rounds=FLEET_C5_ROUNDS, factory_kw=CONFIG5_ARCH, device="cuda",
            timeout_s=FLEET_TIMEOUT_S, tls_dir=os.path.join(work, "certs"),
            snapshot_dir=os.path.join(work, "snaps"), wal_path=wal,
            **TLS_SNAPSHOT),
        backend=reference_backend(cfg, compacts=True))
    note("tls_snapshot_config5", (total, bft_account(
        "tls_snapshot_config5", card, res, BFT_CONFIG5_BLOCKS)))
    config5_check("tls_snapshot_config5", res, FLEET_C5_ROUNDS)
    fo = res.failover or {}
    primary_k = fo.get("primary_kernels") or {}
    primary_info = fo.get("primary_info") or {}
    snaps = (primary_k.get("snapshots") or []) + res.writer_snapshots
    rounds = len(res.writer_merges) + len(primary_k.get("merges") or [])
    writer_costs = {}
    for costs in (_costs(primary_info), _costs(res.final_info)):
        for k, v in costs.items():
            writer_costs[k] = writer_costs.get(k, 0) + v
    client_hs = sum(((perf or {}).get("costs") or {}).get(
        "tls.handshakes", 0) for perf in res.client_perf.values())
    _, keys = provision_validators(BFT_VALIDATORS, FLEET_MASTER_SEED)
    artifacts = snapshot_artifacts(os.path.join(work, "snaps"), keys,
                                   bft_quorum(BFT_VALIDATORS))
    promoted = f"standby-{res.final_info.get('writer_index')}"
    wals = {"writer": wal_account(wal, cfg),
            promoted: wal_account(f"{wal}.{promoted}", cfg)}
    events = res.standby_events.get(promoted, [])
    kinds = [next(iter(e)) for e in events]
    after = [m for m in res.writer_merges
             if m.get("mono", 0) > fo.get("kill_mono", float("inf"))]
    bft5_rounds = max(len(bft5.writer_merges), 1)
    emit("tls_snapshot", path="tls_snapshot_config5", nvidia_smi=card,
         spawn_s=res.spawn_s, validator_spawn_s=res.validator_spawn_s,
         round_s=round_seconds(res.epoch_times),
         failover_gap_s=fo.get("gap_s"), promote_s=fo.get("promote_s"),
         rounds=rounds,
         tls_handshakes_per_round={
             "writers": writer_costs.get("tls.handshakes", 0) / rounds,
             "clients": client_hs / rounds},
         tls_handshake_s=writer_costs.get("tls.handshake_s"),
         wire_per_round={"tls": _per_round(writer_costs, "wire.", rounds),
                         "bft_config5_plaintext": _per_round(
                             _costs(bft5.final_info), "wire.",
                             bft5_rounds)},
         certify_per_round=_per_round(writer_costs, "bft.certify", rounds),
         snapshot_ops=snaps, snapshot_epochs=[r["epoch"] for r in snaps],
         gc_ops=sum(r.get("gc_dropped", 0) for r in snaps),
         artifacts=artifacts, wals=wals, standby_events=events,
         final_log_base=res.final_info.get("log_base"),
         certified_size=res.certified_size, log_size=res.ledger_log_size,
         first_merge_after_kill=after[:1],
         plaintext_refused=res.plaintext_refused)
    leg = "tls_snapshot_config5"
    hold(leg, "snapshot epochs",
         [r["epoch"] for r in snaps] == TLS_SNAPSHOT_EPOCHS,
         [r["epoch"] for r in snaps], TLS_SNAPSHOT_EPOCHS)
    hold(leg, "final writer log base", res.final_info.get("log_base", 0) > 0,
         res.final_info.get("log_base", 0), 1)
    hold(leg, "promoted standby GC'd before it promoted",
         "gc" in kinds and "promoted" in kinds
         and kinds.index("gc") < kinds.index("promoted")
         and events[kinds.index("promoted")]["promoted"]["log_base"]
         > 0, events, ["gc", "promoted with a log base"])
    hold(leg, "promoted writer's first merge on B5 from its GC'd ledger",
         bool(after) and after[0]["leg"] in B5_LEGS
         and after[0]["log_base"] > 0, after[:1],
         f"leg in {list(B5_LEGS)}, log_base > 0")
    files = [f for rows in artifacts.values() for f in rows]
    hold(leg, "artifacts verify", bool(files) and not any(
  why for _, _, why in files), artifacts, "every artifact verifies")
    w = wals[promoted]
    hold(leg, "WALs", wals["writer"]["magic"] == "BFLCWAL2"
         and w["magic"] == "BFLCWAL2"
         and (w["log_size"], w["log_head"]) == (res.ledger_log_size,
                                                res.ledger_log_head),
         wals, "BFLCWAL2, the promoted one at the final head")
    hold(leg, "plaintext refused", res.plaintext_refused is True,
         res.plaintext_refused, True)

    from bflc_demo_tpu_torch.eval.snapshot_drill import run_snapshot_rejoin
    from bflc_demo_tpu_torch.meshagg.engine import ENGINE
    work = os.path.join(WORK_DIR, "snapshot_rejoin")
    shutil.rmtree(work, ignore_errors=True)
    checks0 = ENGINE.selfcheck_launches
    reset_counts()
    with fleet_env():
        acc = run_snapshot_rejoin("cuda", work)
    torch.cuda.synchronize()
    here = read_counts()
    checks = ENGINE.selfcheck_launches - checks0
    promoted = acc["promoted_launches"]
    b5 = {"writer": here["certified_reduce"] - checks,
          "promoted_writer": promoted.get("certified_reduce", 0)
          - acc["promoted_engine"].get("selfcheck_launches", 0)}
    launches = dict(here)
    launches["certified_reduce"] = sum(b5.values())
    emit("snapshot_rejoin", nvidia_smi=card,
         state_sync_s=acc["state_sync_s"],
         validator_install_s=[r["seconds"]
                              for r in acc["validator_installs"]],
         promote_s=acc["promote_s"],
         validator_spawn_s=acc["validator_spawn_s"],
         kernel_launches_by_role={"writer": here, "promoted_writer":
                                  promoted},
         b5_by_role=b5, selfcheck_b5_launches={
             "writer": checks, "promoted_writer":
             acc["promoted_engine"].get("selfcheck_launches", 0)},
         promoted_merges=acc["promoted_merges"],
         promoted_info=acc["promoted_info"],
         validator_heads=acc["validator_heads"],
         model_bytes_equal_plain=acc["model_bytes_equal_plain"],
         writer_snapshots=acc["writer_snapshots"],
         writer_wal=acc["writer_wal_replayed"],
         forged_offer_refused=acc["forged_offer_refused"])
    leg = "snapshot_rejoin"
    hold(leg, "promoted writer B5 launches", b5["promoted_writer"] > 0,
         b5["promoted_writer"], 1)
    hold(leg, "promoted writer's merge leg",
         acc["promoted_merges"][0]["leg"] in B5_LEGS,
         acc["promoted_merges"][0]["leg"], list(B5_LEGS))
    note("snapshot_rejoin", (launches, {"promoted_writer":
                                        b5["promoted_writer"],
                                        "writer": b5["writer"]}))


def bft_account(label: str, card: str, res, blocks: int,
                armed: bool = False) -> dict:
    """Emit a BFT run's account and hold it: every op certified, every
    writer's B5 launches past its self-check equal to `blocks` a merge,
    no validator process with torch (hence no CUDA context) — or, with
    `armed` (the rederive plane), every validator with torch.  Returns
    the run's B5 launches by writer role: {"bft_writer": n}."""
    writers = [("final", res.kernel_launches.get("writer", {}),
                res.writer_engine or {}, res.writer_merges)]
    primary = (res.failover or {}).get("primary_kernels")
    if primary is not None:
        writers.append(("primary", primary["launches"], primary["engine"],
                        primary["merges"]))
    b5 = {}
    for name, launches, engine, merges in writers:
        b5[name] = {"launches": launches.get("certified_reduce", 0)
                    - engine.get("selfcheck_launches", 0),
                    "selfcheck": engine.get("selfcheck_launches", 0),
                    "merges": len(merges),
                    "blocks": sorted({m.get("blocks") for m in merges})}
    costs = ((res.final_info or {}).get("perf") or {}).get("costs", {})
    rounds = max(len(res.writer_merges), 1)
    per_round = {k: costs.get(k, 0) / rounds for k in (
        "bft.certify_s", "bft.certify_batch_s", "bft.certify_single_s",
        "bft.certify_batched_ops", "bft.certify_single_ops")}
    merge_ms = [m["merge_s"] * 1e3 for m in res.writer_merges]
    emit("bft", path=label, nvidia_smi=card, blocks=blocks,
         validators=BFT_VALIDATORS, spawn_s=res.spawn_s,
         validator_spawn_s=res.validator_spawn_s,
         round_s=round_seconds(res.epoch_times),
         certified_size=res.certified_size, log_size=res.ledger_log_size,
         writer_certify_per_round=per_round,
         writer_certify_totals={k: v for k, v in costs.items()
                                if k.startswith("bft.")},
         merge_ms=merge_ms, warm_merge_ms=merge_ms[1:], b5_writers=b5,
         validator_reports=res.validator_reports,
         accuracy=[a for _, a in res.accuracy_history])
    bad = {name: w for name, w in b5.items()
           if w["launches"] != blocks * w["merges"]
           or w["blocks"] not in ([blocks], [])}
    held = [r for r in res.validator_reports.values()
            if (r["torch_imported"] or r["cuda_initialized"]) != armed]
    leg = label
    hold(leg, "certified ops", res.certified_size == res.ledger_log_size,
         res.certified_size, res.ledger_log_size)
    hold(leg, "B5 launches a merge by writer", not bad, b5,
         f"{blocks} a merge at blocks {blocks}")
    hold(leg, "validators with torch" if armed else
         "validators without torch", not held, len(held), 0)
    hold(leg, "validators", len(res.validator_reports) == BFT_VALIDATORS,
         len(res.validator_reports), BFT_VALIDATORS)
    return {"bft_writer": sum(w["launches"] for w in b5.values())}


def failover_check(label: str, res, rounds: int, bar: float) -> None:
    """A drill promoted a standby that committed the rounds after the
    kill on B5, the replica reached its head, and accuracy holds."""
    fo = res.failover or {}
    after = [m for m in res.writer_merges
             if m.get("mono", 0) > fo.get("kill_mono", float("inf"))]
    leg = label
    hold(leg, "rounds", res.rounds_completed >= rounds,
         res.rounds_completed, rounds)
    accuracy_gate(leg, res, bar, above=True)
    hold(leg, "failover generation", fo.get("gen") == 1, fo.get("gen"), 1)
    hold(leg, "merges after the kill on B5", bool(after) and all(
  m["leg"] in B5_LEGS for m in after), [m["leg"] for m in after],
  list(B5_LEGS))
    hold(leg, "replica at the promoted writer's head",
         res.replica_report["head"] == res.ledger_log_head,
         res.replica_report["head"], res.ledger_log_head)


# ------------------------------------------------ the rederive plane (m, n)
def _counted_engine(device: str):
    """A merge engine of its own whose `launched` counts its B5 launches
    on the path (its self-check runs first, before any is counted)."""
    from bflc_demo_tpu_torch.meshagg.engine import MeshAggEngine
    engine = MeshAggEngine(device)
    engine.run_selfcheck()
    engine.launched = 0
    inner = engine._launch

    def launch(*args, **kw):
        engine.launched += 1
        return inner(*args, **kw)

    engine._launch = launch
    return engine


class _DrillFleet:
    """A writer and `len(modes)` validators in this process's threads on
    the card.  Each armed validator re-derives on an engine of its own
    (`_counted_engine`): in one process the validators would otherwise
    share the writer's `ENGINE`, and their B5 launches could not be told
    apart."""

    def __init__(self, cfg, init: bytes, modes, seed: bytes,
                 bft_timeout_s: float = REDERIVE_DRILL_TIMEOUT_S):
        from bflc_demo_tpu_torch.comm import bft
        from bflc_demo_tpu_torch.comm.identity import provision_wallets
        from bflc_demo_tpu_torch.comm.ledger_service import (
            CoordinatorClient, LedgerServer)
        vwallets, keys = bft.provision_validators(len(modes), seed)
        self.nodes = []
        for i, w in enumerate(vwallets):
            node = bft.ValidatorNode(cfg, w, i, validator_keys=keys,
                                     initial_model_blob=init,
                                     rederive=modes[i], device="cuda")
            if node._rederiver is not None:
                node._rederiver.engine = _counted_engine("cuda")
            node.start()
            self.nodes.append(node)
        self.server = LedgerServer(
            cfg, init, bft_validators=[(v.host, v.port) for v in self.nodes],
            bft_keys=keys, bft_timeout_s=bft_timeout_s,
            stall_timeout_s=600.0, device="cuda")
        hold_backend("rederive_drill", self.server.ledger.backend,
                     reference_backend(cfg))
        self.server.start()
        self.client = CoordinatorClient(self.server.host, self.server.port,
                                        timeout_s=300.0)
        self.wallets, _ = provision_wallets(cfg.client_num, seed + b"-c")
        for w in self.wallets:
            r = self.request("register", addr=w.address,
                             pubkey=w.public_bytes.hex(),
                             tag=self.sign(w, "register", 0, b""))
            hold("rederive_drill", "register", r["ok"], r, "ok")

    def request(self, method, **fields):
        return self.client.request(method, **fields)

    @staticmethod
    def sign(w, kind, epoch, payload):
        from bflc_demo_tpu_torch.comm.identity import _op_bytes
        return w.sign(_op_bytes(kind, w.address, epoch, payload)).hex()

    def sync_round(self, epoch: int, deltas, scores):
        """One signed round: the first len(deltas) trainers upload, each
        committee member sends `scores`; the last scores reply (it
        carries the commit's certification)."""
        import hashlib
        import struct
        committee = set(self.request("committee")["committee"])
        trainers = [w for w in self.wallets if w.address not in committee]
        for i, w in enumerate(trainers[:len(deltas)]):
            d = hashlib.sha256(deltas[i]).digest()
            payload = d + struct.pack("<qd", 100 + i, 1.0)
            r = self.request("upload", addr=w.address, blob=deltas[i],
                             hash=d.hex(), n=100 + i, cost=1.0, epoch=epoch,
                             tag=self.sign(w, "upload", epoch, payload))
            hold("rederive_drill", "upload", r["ok"], r, "ok")
        last = None
        for w in (w for w in self.wallets if w.address in committee):
            last = self.request(
                "scores", addr=w.address, epoch=epoch, scores=scores,
                tag=self.sign(w, "scores", epoch, struct.pack(
                    f"<{len(scores)}d", *scores)))
        return last

    def async_round(self, deltas):
        """len(deltas) auploads at base 0: the last one drains."""
        import hashlib
        import struct
        last = None
        for i, blob in enumerate(deltas):
            w = self.wallets[i]
            d = hashlib.sha256(blob).digest()
            payload = d + struct.pack("<qd", 100 + i, 1.0)
            last = self.request("aupload", addr=w.address, blob=blob,
                                hash=d.hex(), n=100 + i, cost=1.0,
                                base_epoch=0,
                                tag=self.sign(w, "aupload", 0, payload))
        return last

    def armed(self):
        return [v._rederiver for v in self.nodes
                if v._rederiver is not None]

    def close(self):
        self.client.close()
        self.server.close()
        for v in self.nodes:
            v.close()


def rederive_drill_phase(torch, cr, card: str) -> tuple:
    """(m) `rederive_drill`, in this process on the card: a writer and 4
    validators armed `shard` on `cuda` in threads, config 5's protocol
    (10 admitted of 20 clients, top-6) and width (P = 535,298) at 8
    blocks, every merge on B5 (`BFLC_MESH_AGG_MIN=1`), between a reset
    and a read of the launch counts.  Holds: an honest commit certifies,
    every validator re-derived it with B5 launched at least once, its
    hash equals the legacy pin's; each validator's shard re-derived on
    the card equals, byte for byte, the plain version's on a CPU copy
    and the committed leaves (these comparisons' launches do not count);
    a writer lying at one leaf is refused on a sync commit and on an
    async drain with one colluding validator; a NaN delta is refused;
    withheld evidence is a counted skip that certifies.  Times B5 at one
    shard's geometry and at the full model's beside the bound, the plain
    version and `c @ mat`.  Returns (launches, the validators' B5
    launches, the timing rows)."""
    import dataclasses
    import hashlib
    from unittest import mock

    import bflc_demo_tpu_torch.comm.ledger_service as ls
    from bflc_demo_tpu_torch.ledger import clone_prefix
    from bflc_demo_tpu_torch.meshagg.engine import ENGINE, MeshAggEngine
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    from bflc_demo_tpu_torch.rederive.core import derive_leaves
    from bflc_demo_tpu_torch.rederive.shards import leaf_shard
    from bflc_demo_tpu_torch.utils.serialization import (pack_entries,
                                                         pack_pytree,
                                                         unpack_pytree)
    leg = "rederive_drill"
    t_leg = time.perf_counter()
    cfg = ProtocolConfig(**CONFIG5_PROTO, reduce_blocks=BFT_CONFIG5_BLOCKS)
    n_up = cfg.needed_update_count
    init = pack_pytree(make_transformer_classifier(
        **CONFIG5_ARCH).init_params(0, "cpu"))
    flat = unpack_pytree(init)
    keys = sorted(flat)
    p_full = sum(int(a.size) for a in flat.values())
    hold(leg, "params", p_full == CONFIG5_PARAMS, p_full, CONFIG5_PARAMS)
    rng = np.random.default_rng(23)

    def delta_blob(nan: bool = False) -> bytes:
        d = {k: (rng.standard_normal(a.shape) * 0.01).astype(np.float32)
             for k, a in flat.items()}
        if nan:
            d[keys[0]].flat[0] = np.float32("nan")
        return pack_entries(d)

    def corrupt(entries):
        e = dict(entries)
        a = np.array(e[keys[0]], np.float32).copy()
        a.flat[0] += np.float32(0.25)
        e[keys[0]] = a
        return pack_entries(e)

    honest = [delta_blob() for _ in range(n_up)]
    scores = [0.9 - 0.01 * u for u in range(n_up)]     # slots 0-5 win
    shards = {v: leaf_shard(keys, v, REDERIVE_VALIDATORS, 0)
              for v in range(REDERIVE_VALIDATORS)}
    out = {"validators": REDERIVE_VALIDATORS,
           "shard_p": {v: sum(int(flat[k].size) for k in s)
                       for v, s in shards.items()}}
    b5 = {}
    writer_check = ENGINE.report()["selfcheck"] == "untested"
    reset_counts()
    compare_launches = 0

    def closed(name, fleet):
        """Close a drill fleet, recording its validators' B5 launches
        on the path (their engines' self-checks are comparisons)."""
        nonlocal compare_launches
        b5[name] = [r.engine.launched for r in fleet.armed()]
        compare_launches += sum(r.engine.selfcheck_launches
                                for r in fleet.armed())
        fleet.close()
    with fleet_env({"BFLC_REDERIVE": "shard"}):
        # an honest commit, then a NaN delta, on one armed fleet
        fleet = _DrillFleet(cfg, init, ["shard"] * REDERIVE_VALIDATORS,
                            b"chip-rederive-honest")
        try:
            t0 = time.perf_counter()
            last = fleet.sync_round(0, honest, scores)
            out["honest_commit_s"] = time.perf_counter() - t0
            hold(leg, "honest commit certified", last["ok"], last, "ok")
            armed_hash = fleet.request("model", meta=1)["hash"]
            stats = [dict(r.stats) for r in fleet.armed()]
            b5["honest"] = [r.engine.launched for r in fleet.armed()]
            hold(leg, "every validator re-derived the commit",
                 all(s["ok"] == 1 and not s["skipped"] and not s["refused"]
                     for s in stats), stats, "ok 1, no skip or refusal")
            hold(leg, "B5 launches a commit in every validator",
                 all(n >= 1 for n in b5["honest"]), b5["honest"], 1)
            honest_b5 = b5.pop("honest")
            out["derive_s"] = [s["derive_s"] for s in stats]
            out["fetch_s"] = [s["fetch_s"] for s in stats]
            # the inputs as the validators read them: the writer's chain
            # before its commit op, replayed
            writer = fleet.server.ledger
            pos = next(j for j in range(writer.log_size())
                       if writer.log_op(j)[0] == 4)
            pre = clone_prefix(writer, pos, cfg)
            sel = list(pre.pending().selected)
            ups = pre.query_all_updates()
            by_hash = {hashlib.sha256(b).digest(): b for b in honest}
            flats = [unpack_pytree(by_hash[u.payload_hash])
                     if i in sel else None for i, u in enumerate(ups)]
            weights = [u.n_samples for u in ups]
            committed = unpack_pytree(fleet.request("model")["blob"])
            before = read_counts()["certified_reduce"]
            card_engine = MeshAggEngine("cuda")
            cpu_engine = MeshAggEngine("cpu")
            same = {}
            for v, mine in shards.items():
                got = derive_leaves(flat, flats, weights, sel,
                                    cfg.learning_rate, mine,
                                    blocks=BFT_CONFIG5_BLOCKS,
                                    engine=card_engine)
                want = derive_leaves(flat, flats, weights, sel,
                                     cfg.learning_rate, mine,
                                     blocks=BFT_CONFIG5_BLOCKS,
                                     engine=cpu_engine)
                same[v] = all(got[k].tobytes() == want[k].tobytes()
                              == committed[k].tobytes() for k in mine)
            compare_launches += read_counts()["certified_reduce"] - before
            out["shard_bytes_equal_plain_and_committed"] = same
            hold(leg, "shards equal the plain version's and the committed "
                 "leaves", all(same.values()), same, True)
            hold(leg, "plain comparison on the kernel leg",
                 cpu_engine.calls.get("blocked", 0) ==
                 REDERIVE_VALIDATORS, cpu_engine.calls, "blocked")
            # a NaN delta that wins its round: refused (its certification
            # gives up after the lies' budget)
            fleet.server._bft.timeout_s = REDERIVE_LIE_TIMEOUT_S
            nan = [delta_blob(nan=(i == 0)) for i in range(n_up)]
            last = fleet.sync_round(1, nan, scores)
            nan_stats = [dict(r.stats) for r in fleet.armed()]
            out["nan"] = {"status": last.get("status"),
                          "refusals": [s["refusals"] for s in nan_stats]}
            hold(leg, "NaN delta refused", last.get("status") ==
                 "CERT_TIMEOUT", last.get("status"), "CERT_TIMEOUT")
            n_nan = sum(s["refusals"].get("nonfinite", 0)
                        for s in nan_stats)
            hold(leg, "nonfinite refusals", n_nan >= 2, n_nan, 2)
        finally:
            closed("honest_and_nan", fleet)
        # a lie at one leaf, one validator colluding: sync and async
        for kind, c in (("sync", cfg),
                        ("async", dataclasses.replace(
                            cfg, async_buffer=n_up,
                            max_staleness=5).validate())):
            fleet = _DrillFleet(c, init, ["off"] + ["shard"] * (
                REDERIVE_VALIDATORS - 1), b"chip-rederive-lie-" +
                kind.encode(), bft_timeout_s=REDERIVE_LIE_TIMEOUT_S)
            try:
                with mock.patch.object(ls, "pack_entries", corrupt):
                    last = (fleet.sync_round(0, honest, scores)
                            if kind == "sync" else fleet.async_round(honest))
                st = [dict(r.stats) for r in fleet.armed()]
                out[f"lie_{kind}"] = {
                    "status": last.get("status"),
                    "refusals": [s["refusals"] for s in st]}
                refused = sum(s["refused"] for s in st)
                hold(leg, f"{kind} lie refused", last.get("status") ==
                     "CERT_TIMEOUT", last.get("status"), "CERT_TIMEOUT")
                hold(leg, f"{kind} lie's refusals", refused >= 2, refused, 2)
            finally:
                closed(f"lie_{kind}", fleet)
    # the legacy pin's hash, and withheld evidence (the writer disarmed)
    with fleet_env({"BFLC_REDERIVE_LEGACY": "1"}):
        fleet = _DrillFleet(cfg, init, ["shard"] * REDERIVE_VALIDATORS,
                            b"chip-rederive-honest")
        try:
            hold(leg, "legacy commit", fleet.sync_round(
                0, honest, scores)["ok"], False, True)
            legacy_hash = fleet.request("model", meta=1)["hash"]
            hold(leg, "legacy pin disarms the validators",
                 not fleet.armed(), len(fleet.armed()), 0)
        finally:
            closed("legacy", fleet)
    out["hash_armed_equals_legacy"] = armed_hash == legacy_hash
    hold(leg, "armed hash equals the legacy pin's",
         armed_hash == legacy_hash, armed_hash, legacy_hash)
    with fleet_env():
        fleet = _DrillFleet(cfg, init, ["shard"] * REDERIVE_VALIDATORS,
                            b"chip-rederive-skip")
        try:
            last = fleet.sync_round(0, honest, scores)
            st = [dict(r.stats) for r in fleet.armed()]
            out["withheld"] = {"ok": last["ok"],
                               "skips": [s["skips"] for s in st]}
            hold(leg, "withheld evidence certifies", last["ok"], last, "ok")
            hold(leg, "withheld evidence is a counted skip",
                 all(s["skipped"] == 1 and not s["refused"] for s in st),
                 [s["skips"] for s in st], "1 skip each")
        finally:
            closed("withheld", fleet)
    torch.cuda.synchronize()
    counts = read_counts()
    if writer_check:
        compare_launches += ENGINE.selfcheck_launches
    counts["certified_reduce"] -= compare_launches
    validator_b5 = sum(sum(v) for v in b5.values())
    # B5 at validator 0's shard and at the full model (an escalation or
    # `full` mode), 10 rows, blocks 1 and 8 (the genome's)
    cases = {}
    for name, p in (("rederive_shard", out["shard_p"][0]),
                    ("rederive_full", p_full)):
        g = np.random.default_rng(29)
        cases[name] = ({"x": np.zeros(p, np.float32)},
                       [g.standard_normal(p, dtype=np.float32)
                        * np.float32(0.01) for _ in range(n_up)],
                       [100.0 + i for i in range(n_up)], list(range(6)),
                       cfg.learning_rate)
    timed = merge_timing_rows(torch, cr, "cuda", cases)
    rows = {name[len("rederive_"):]: timed[(name, BFT_CONFIG5_BLOCKS)]
            for name in cases}
    emit("rederive", path=leg, nvidia_smi=card, leg_s=time.perf_counter()
         - t_leg, b5_by_validator=b5, b5_honest_commit=honest_b5,
         validator_b5=validator_b5,
         launches=counts, compare_launches=compare_launches, **out)
    return counts, validator_b5, rows


def rederive_config5_phase(torch, card: str, note, c5_shards,
                           c5_test) -> None:
    """(n) `rederive_config5`: config 5 at full width (`CONFIG5_PROTO`,
    `REDERIVE_PROTO`: top-k from density REDERIVE_PROTO's, i8, 8 blocks,
    the closed loop every 2 rounds down to 0.01) with 4 validators armed
    `shard` (`REDERIVE_FLEET`), error feedback, REDERIVE_C5_ROUNDS
    rounds.  Holds: the rounds; the bar; no `REDERIVE` or `SPARSE`
    refusal and no skip; every validator re-derived every commit and
    imported torch; genome ops on the chain, every validator's and the
    replica's knobs equal to the writer's; the density moved; B5
    launched in every validator (role `validator`, past its
    self-check)."""
    from bflc_demo_tpu_torch.client.process_runtime import \
        run_federated_processes
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    label = "rederive_config5"
    cfg = ProtocolConfig(**CONFIG5_PROTO, **REDERIVE_PROTO)
    t0 = time.perf_counter()
    res, total, _ = fleet_run(
        torch, label, card,
        lambda: run_federated_processes(
            "make_transformer_classifier", c5_shards, c5_test, cfg,
            rounds=REDERIVE_C5_ROUNDS, factory_kw=CONFIG5_ARCH,
            device="cuda", timeout_s=FLEET_TIMEOUT_S, **REDERIVE_FLEET),
        env=CODEC_ENV, backend=reference_backend(cfg))
    total, by_role = rederive_account(label, card, res, total,
                                      time.perf_counter() - t0)
    note(label, (total, by_role))


def rederive_account(label: str, card: str, res, total: dict,
                     leg_s: float) -> tuple:
    """Emit `rederive_config5`'s `bft` and `rederive` lines and hold
    its gates (`rederive_config5_phase`; torch in every validator is
    `bft_account`'s); returns (main-path launches,
    the validators' self-checks taken out; B5 by role: `bft_writer`
    and `validator`)."""
    by_role = bft_account(label, card, res, REDERIVE_PROTO["reduce_blocks"],
                          armed=True)
    reports = res.validator_reports
    commits = len(res.writer_merges)
    val = {}
    for role, rep in sorted(reports.items()):
        st = rep.get("rederive") or {}
        launches = res.kernel_launches.get(role, {})
        check = (rep.get("engine") or {}).get("selfcheck_launches", 0)
        val[role] = {"ok": st.get("ok"), "refused": st.get("refused"),
                     "skipped": st.get("skipped"),
                     "escalated": st.get("escalated"),
                     "leaves": st.get("leaves"),
                     "derive_s": st.get("derive_s"),
                     "fetch_s": st.get("fetch_s"),
                     "seconds": st.get("seconds"),
                     "b5": launches.get("certified_reduce", 0) - check,
                     "selfcheck": check, "genome": rep.get("genome"),
                     "torch_imported": rep.get("torch_imported"),
                     "spawn_cuda": rep.get("cuda_initialized")}
    by_role["validator"] = sum(v["b5"] for v in val.values())
    total = dict(total, certified_reduce=total.get("certified_reduce", 0)
                 - sum(v["selfcheck"] for v in val.values()))
    info = res.final_info or {}
    writer_knobs = {"eff_density": info.get("eff_density"),
                    "eff_staleness": info.get("eff_staleness"),
                    "genome_epoch": info.get("genome_epoch")}
    replica = res.replica_report or {}
    replica_knobs = {"eff_density": replica.get("eff_density"),
                     "eff_staleness": replica.get("eff_staleness"),
                     "genome_epoch": (-1 if replica.get("genome_epoch")
                                      is None
                                      else replica.get("genome_epoch"))}
    densities = [g["new_density"] for g in res.writer_genomes]
    costs = _costs(res.final_info)
    refusals = {k: v for k, v in costs.items()
                if k.startswith("bft.refused.")}
    nums = codec_numbers(res, max(commits, 1))
    emit("rederive", path=label, nvidia_smi=card, leg_s=leg_s,
         rounds=res.rounds_completed, commits=commits,
         validators=val, writer_genomes=res.writer_genomes,
         writer_knobs=writer_knobs, replica_knobs=replica_knobs,
         refusals=refusals, b5_by_role=by_role,
         warm_merge_ms=[m["merge_s"] * 1e3 for m in res.writer_merges[1:]],
         blob_bytes_per_upload=nums["blob_bytes_per_upload"],
         encode_ms_per_upload=nums["encode_ms_per_upload"],
         spawn_s=res.spawn_s, validator_spawn_s=res.validator_spawn_s,
         accuracy=[a for _, a in res.accuracy_history])
    leg = label
    hold(leg, "rounds", res.rounds_completed >= REDERIVE_C5_ROUNDS,
         res.rounds_completed, REDERIVE_C5_ROUNDS)
    accuracy_gate(leg, res, REDERIVE_MIN_BEST)
    hold(leg, "REDERIVE and SPARSE refusals", not any(
        k in refusals for k in ("bft.refused.REDERIVE",
                                "bft.refused.SPARSE")), refusals, {})
    hold(leg, "validators", len(val) == REDERIVE_VALIDATORS, len(val),
         REDERIVE_VALIDATORS)
    bad = {r: v for r, v in val.items()
           if (v["ok"] or 0) < commits or v["refused"] or v["skipped"]}
    hold(leg, "every validator re-derived every commit", not bad, bad,
         f"ok >= {commits}, no refusal, no skip")
    hold(leg, "B5 launches in every validator",
         all(v["b5"] > 0 for v in val.values()),
         {r: v["b5"] for r, v in val.items()}, 1)
    hold(leg, "genome ops on the chain", bool(res.writer_genomes),
         len(res.writer_genomes), 1)
    knobs = {r: v["genome"] for r, v in val.items()}
    hold(leg, "validators' knobs equal the writer's",
         all(k == writer_knobs for k in knobs.values()), knobs,
         writer_knobs)
    hold(leg, "replica's knobs equal the writer's",
         replica_knobs == writer_knobs, replica_knobs, writer_knobs)
    hold(leg, "density moved", any(
        d != REDERIVE_PROTO["delta_density"] for d in densities),
        densities, f"!= {REDERIVE_PROTO['delta_density']}")
    return total, by_role


# ------------------------------------------------------ the mesh executor
def executor_log_size(cfg: dict, rounds: int) -> int:
    """The executor ledger's ops after `rounds` rounds: the registrations
    and, a round, K uploads, C score rows and the commit
    (tests/test_mesh_executor.py:38-41)."""
    return cfg["client_num"] + rounds * (
        cfg["needed_update_count"] + cfg["comm_count"] + 1)


def executor_account(label: str, card: str, res, cfg: dict, rounds: int,
                     leg_s: float) -> dict:
    """Emit an executor fleet's `executor` line and hold its gates: the
    rounds (the executor's own count too, so no runner error), the
    ledger's size by the arithmetic, K1-K3 and B6 in role `executor` at
    the mesh round's counts less the sponsor's evaluation
    (EXECUTOR_PER_ROUND), C attestations a round, K1 in every member's
    process at one stacked forward an attestation, K1 in every thin
    client and the sponsor at one forward an evaluation, every thin
    client exited 0, and the best at EXECUTOR_MIN_BEST.  Returns the
    main path's launches, every role's."""
    rec = res.executor or {}
    execu = res.kernel_launches.get("executor", {})
    thin = {r: v for r, v in res.kernel_launches.items()
            if r.startswith("thin-")}
    counts = res.client_counts
    sponsor = res.kernel_launches.get("sponsor", {})
    total = {}
    for launches in res.kernel_launches.values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    thin_total = {k: sum(v.get(k, 0) for v in thin.values())
                  for k in DENSE_KERNELS}
    attested = {r: c["attested"] for r, c in counts.items()}
    rounds_log = rec.get("rounds") or []
    hold_backend(label, res.writer_backend)
    emit("executor", path=label, nvidia_smi=card, leg_s=leg_s,
         writer_backend=res.writer_backend,
         spawn_s=res.spawn_s, stage_s=res.stage_s,
         rounds=res.rounds_completed,
         round_s=[r["round_s"] for r in rounds_log],
         device_round_s=[r["device_s"] for r in rounds_log],
         attest_wait_s=[r["attest_s"] for r in rounds_log],
         evidence_bytes=[r["evidence_bytes"] for r in rounds_log],
         sponsor_round_s=round_seconds(res.epoch_times),
         launches_by_role={"executor": execu, "thin": thin_total,
                           "sponsor": sponsor},
         attested=attested,
         evaluations={r: c["evaluations"] for r, c in counts.items()},
         ledger_log_size=res.ledger_log_size,
         client_exitcodes=res.client_exitcodes,
         accuracy=[a for _, a in res.accuracy_history])
    leg = label
    hold(leg, "rounds", res.rounds_completed >= rounds,
         res.rounds_completed, rounds)
    hold(leg, "executor rounds done", rec.get("rounds_done") == rounds,
         rec.get("rounds_done"), rounds)
    want = executor_log_size(cfg, res.rounds_completed)
    hold(leg, "ledger log size", res.ledger_log_size == want,
         res.ledger_log_size, want)
    want = {k: v * res.rounds_completed
            for k, v in EXECUTOR_PER_ROUND.items()}
    got = {k: execu.get(k, 0) for k in want}
    hold(leg, "executor launches at the mesh round's counts", got == want,
         got, want)
    want = cfg["comm_count"] * res.rounds_completed
    hold(leg, "attestations", sum(attested.values()) == want,
         sum(attested.values()), want)
    bad = {r: c for r, c in counts.items()
           if c["attest_launches"].get("flash_fwd", 0)
           != ASYNC_K1_FORWARD * c["attested"]}
    hold(leg, "member K1 a re-score", not bad, bad,
         f"{ASYNC_K1_FORWARD} an attestation")
    bad = {r: v.get("flash_fwd", 0) for r, v in thin.items()
           if not counts[r]["evaluations"] or v.get("flash_fwd", 0)
           != ASYNC_K1_FORWARD * (counts[r]["evaluations"]
                                  + counts[r]["attested"])}
    hold(leg, "thin client K1", len(thin) == cfg["client_num"]
         and not bad, bad, f"{ASYNC_K1_FORWARD} an evaluation")
    want = ASYNC_K1_FORWARD * len(res.accuracy_history)
    hold(leg, "sponsor K1", want and sponsor.get("flash_fwd") == want,
         sponsor.get("flash_fwd"), want)
    hold(leg, "thin clients' exit codes",
         res.client_exitcodes == [0] * cfg["client_num"],
         res.client_exitcodes, 0)
    accuracy_gate(leg, res, EXECUTOR_MIN_BEST)
    return total


def executor_config5_phase(torch, card: str, note) -> None:
    """(o) `executor_config5` (the constants above), between a reset and
    a read of the launch counts: held by `executor_account`, and no
    process of the fleet left."""
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    label = "executor_config5"
    reset_counts()
    t0 = time.perf_counter()
    res = config5_transformer_sst2(
        rounds=EXECUTOR_C5_ROUNDS, runtime="executor", device="cuda",
        tls_dir=os.path.join(WORK_DIR, "executor_tls"))
    torch.cuda.synchronize()
    total = executor_account(label, card, res, CONFIG5_PROTO,
                             EXECUTOR_C5_ROUNDS, time.perf_counter() - t0)
    # the fleet's children still alive (the forkserver, which lives until
    # the script's end, aside)
    import multiprocessing
    left = [p.pid for p in multiprocessing.active_children()]
    hold(label, "fleet processes left", not left, left, [])
    note(label, (total, {}))


def config1_cli_start() -> tuple:
    """Start config 1's CLI line, `python -m bflc_demo_tpu_torch --config
    config1 --runtime processes --rounds CONFIG1_ROUNDS` with FLEET_ENV,
    its output to files under WORK_DIR: (the process, its start, the
    output's path)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    base = os.path.join(WORK_DIR, "config1_cli")
    with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bflc_demo_tpu_torch", "--config",
             "config1", "--runtime", "processes", "--rounds",
             str(CONFIG1_ROUNDS)], stdout=out, stderr=err,
            env=dict(os.environ, **FLEET_ENV),
            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter(), base


def executor_cli_start() -> tuple:
    """Start the CLI line, `python -m bflc_demo_tpu_torch --config config1
    --runtime executor --rounds EXECUTOR_CLI_ROUNDS` as a user runs it,
    its output to files under WORK_DIR (no pipe to fill while it runs
    beside another leg): (the process, its start, the output's path)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    base = os.path.join(WORK_DIR, "executor_cli")
    with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "bflc_demo_tpu_torch", "--config",
             "config1", "--runtime", "executor", "--rounds",
             str(EXECUTOR_CLI_ROUNDS)], stdout=out, stderr=err,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    return proc, time.perf_counter(), base


def executor_cli_phase(card: str, note, started: tuple = None) -> None:
    """The CLI line (`executor_cli_start`, started here unless `started`
    is given): exit 0, its rounds and its ledger's size."""
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    label = "executor_config1_cli"
    proc, t0, base = started or executor_cli_start()
    try:
        proc.wait(timeout=FLEET_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(base + ".out") as out, open(base + ".err") as err:
        stdout, stderr = out.read(), err.read()
    if proc.returncode != 0:
        raise gate_failed(label, "CLI exit code", proc.returncode, 0,
                          stderr[-4000:])
    cli = json.loads(stdout.strip().splitlines()[-1])
    ex = cli["executor"]
    total = {}
    for launches in ex["kernel_launches"].values():
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    cfg = dataclasses.asdict(ProtocolConfig())
    emit("executor", path=label, nvidia_smi=card,
         cli_wall_s=time.perf_counter() - t0, spawn_s=ex["spawn_s"],
         stage_s=ex["stage_s"],
         round_s=[r["round_s"] for r in ex["rounds"] or []],
         attest_wait_s=[r["attest_s"] for r in ex["rounds"] or []],
         attested={r: c["attested"]
                   for r, c in ex["client_counts"].items()},
         best_acc=cli["best_acc"], ledger_log_size=cli["ledger_log_size"],
         writer_backend=ex["writer_backend"])
    hold_backend(label, ex["writer_backend"])
    hold(label, "rounds", cli["rounds"] == EXECUTOR_CLI_ROUNDS,
         cli["rounds"], EXECUTOR_CLI_ROUNDS)
    want = executor_log_size(cfg, EXECUTOR_CLI_ROUNDS)
    hold(label, "ledger log size", cli["ledger_log_size"] == want,
         cli["ledger_log_size"], want)
    note(label, (total, {}))


def _staged_executor(cls, cfg, timeout_s: float):
    """An executor of class `cls` on the card in threads, attesting, with
    the reference test's 6 wallets registered and their ragged seeded
    shards staged (tests/test_mesh_executor.py:65-100): (server, client,
    wallets, shards)."""
    import hashlib

    from bflc_demo_tpu_torch.comm.identity import (_op_bytes,
                                                   provision_wallets)
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    from bflc_demo_tpu_torch.utils.serialization import pack_entries
    wallets, directory = provision_wallets(cfg.client_num,
                                           EXECUTOR_MASTER_SEED)
    srv = cls(cfg, "make_softmax_regression", rounds=1, attest_scores=True,
              attest_timeout_s=timeout_s, directory=directory,
              stall_timeout_s=600.0, device="cuda")
    srv.start()
    rng = np.random.default_rng(7)
    shards = {}
    c = CoordinatorClient(srv.host, srv.port, timeout_s=30.0)
    for i, w in enumerate(wallets):
        size = 40 if i == 0 else 32         # ragged: cyclic padding
        shards[w.address] = (
            rng.standard_normal((size, 5)).astype(np.float32),
            rng.integers(0, 2, (size,)).astype(np.int32))
        c.request("register", addr=w.address, pubkey=w.public_bytes.hex(),
                  tag=w.sign(_op_bytes("register", w.address, 0,
                                       b"")).hex())
    for w in wallets:
        x, y = shards[w.address]
        xb, yb = pack_entries({"x": x}), pack_entries({"y": y})
        payload = hashlib.sha256(xb).digest() + hashlib.sha256(yb).digest()
        c.request("stage", addr=w.address, x=xb, y=yb,
                  tag=w.sign(_op_bytes("stage", w.address, 0,
                                       payload)).hex())
    return srv, c, wallets, shards


def _drive_attestations(c, wallets, shards, cfg, deadline_s: float) -> dict:
    """Each wallet, as a committee member, re-scores and attests every
    round pending for it (its own shard, the batched evidence fetch)
    until the executor finished its round or failed: the attestations
    made, the refusals (rows that did not match) and the last
    `progress`."""
    from bflc_demo_tpu_torch.client.process_runtime import attest_score_row
    from bflc_demo_tpu_torch.comm.dataplane import ReadRouter
    from bflc_demo_tpu_torch.models import make_softmax_regression
    model = make_softmax_regression().to("cuda")
    template = model.init_params(0, "cuda")
    router = ReadRouter(c)
    out = {"attested": 0, "refused": 0, "refusals": []}
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        pr = c.request("progress")
        if pr.get("error") or pr["rounds_done"] >= 1:
            break
        for w in wallets:
            pa = c.request("round_pending", addr=w.address)
            if pa.get("epoch") is None:
                continue
            x, y = shards[w.address]
            try:
                out["attested"] += bool(attest_score_row(
                    c, w, model, template, cfg, x, y, pa, router=router))
            except RuntimeError as exc:
                out["refused"] += 1
                out["refusals"].append(str(exc)[:200])
        time.sleep(0.05)
    out["progress"] = c.request("progress")
    out["epoch"] = c.request("info")["epoch"]
    return out


def executor_attest_drill_phase(torch, card: str) -> dict:
    """(p) `executor_attest_drill`, in this process on the card, between
    a reset and a read of the launch counts: executors in threads at the
    reference test's protocol (FLEET_PROTO) — a mismatched and an
    undecodable shard refused BAD_ARG and a good one staged with no
    round run; an honest round whose C members each re-score and sign
    (`attest_log` holds C signatures, one round done); a tampering
    executor that perturbs one member's row, which that member refuses
    ("does not match"), so `progress` names the members that "did not
    attest" and epoch 0 stays uncommitted; then the mesh runtime at
    config 5 with wallets, C signatures a round.  Returns the launch
    counts."""
    from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
    from bflc_demo_tpu_torch.comm.executor_service import MeshExecutorServer
    from bflc_demo_tpu_torch.comm.identity import provision_wallets
    from bflc_demo_tpu_torch.comm.ledger_service import CoordinatorClient
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    from bflc_demo_tpu_torch.utils.serialization import pack_entries

    class TamperingExecutor(MeshExecutorServer):
        def _collect_attestations(self, epoch, addrs, uploader_ids,
                                  committee_ids, delta_fps, score_rows,
                                  cand_deltas, s_pad):
            rows = np.array(score_rows, copy=True)
            rows[committee_ids[0], uploader_ids[0]] += 0.25
            super()._collect_attestations(
                epoch, addrs, uploader_ids, committee_ids, delta_fps, rows,
                cand_deltas, s_pad)

    leg = "executor_attest_drill"
    cfg = ProtocolConfig(**FLEET_PROTO)
    c_count = cfg.comm_count
    reset_counts()
    t0 = time.perf_counter()
    srv = MeshExecutorServer(cfg, "make_softmax_regression", rounds=1,
                             require_auth=False, stall_timeout_s=600.0,
                             device="cuda")
    srv.start()
    try:
        c = CoordinatorClient(srv.host, srv.port)
        addr = "0x" + "0" * 40
        xb = pack_entries({"x": np.zeros((10, 5), np.float32)})
        stage = {
            "mismatched": c.request("stage", addr=addr, x=xb,
                                    y=pack_entries({"y": np.zeros(
                                        (9,), np.int32)})),
            "undecodable": c.request("stage", addr=addr, x="zz", y="zz"),
            "good": c.request("stage", addr=addr, x=xb,
                              y=pack_entries({"y": np.zeros(
                                  (10,), np.int32)}))}
        stage_progress = c.request("progress")
        c.close()
    finally:
        srv.close()
    stage_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    srv, c, wallets, shards = _staged_executor(MeshExecutorServer, cfg,
                                               30.0)
    try:
        honest = _drive_attestations(c, wallets, shards, cfg, 60.0)
        honest_log = {e: len(v) for e, v in srv.attest_log.items()}
        honest_rounds = list(srv.round_log)
    finally:
        c.close()
        srv.close()
    honest_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    srv, c, wallets, shards = _staged_executor(
        TamperingExecutor, cfg, EXECUTOR_TAMPER_TIMEOUT_S)
    try:
        tamper = _drive_attestations(c, wallets, shards, cfg,
                                     EXECUTOR_TAMPER_TIMEOUT_S + 30.0)
    finally:
        c.close()
        srv.close()
    tamper_s = time.perf_counter() - t1

    t1 = time.perf_counter()
    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    c5_wallets, _ = provision_wallets(CONFIG5_PROTO["client_num"],
                                      EXECUTOR_MASTER_SEED)
    mesh = run_federated_mesh(
        make_transformer_classifier(**CONFIG5_ARCH), c5_shards, c5_test,
        ProtocolConfig(**CONFIG5_PROTO), rounds=EXECUTOR_MESH_ROUNDS,
        attest_wallets=c5_wallets, device="cuda")
    torch.cuda.synchronize()
    mesh_log = {e: len(v) for e, v in (mesh.attest_log or {}).items()}
    mesh_s = time.perf_counter() - t1
    counts = read_counts()
    emit(leg, nvidia_smi=card,
         stage={k: v.get("status", "OK" if v.get("ok") else None)
                for k, v in stage.items()},
         stage_s=stage_s, honest_attest_log=honest_log,
         honest_rounds=honest_rounds, honest_s=honest_s,
         tamper_refused=tamper["refused"],
         tamper_refusals=tamper["refusals"][:2],
         tamper_error=tamper["progress"].get("error"), tamper_s=tamper_s,
         mesh_attest_log=mesh_log, mesh_round_s=mesh.round_times_s,
         mesh_s=mesh_s, launches=counts,
         mesh_ledger_backend=mesh.ledger.backend)
    hold_backend(leg, mesh.ledger.backend)
    hold(leg, "mismatched shard refused",
         stage["mismatched"].get("status") == "BAD_ARG",
         stage["mismatched"].get("status"), "BAD_ARG")
    hold(leg, "undecodable shard refused",
         stage["undecodable"].get("status") == "BAD_ARG",
         stage["undecodable"].get("status"), "BAD_ARG")
    hold(leg, "good shard staged", stage["good"].get("staged") == 1,
         stage["good"].get("staged"), 1)
    hold(leg, "no round before every client staged",
         stage_progress["rounds_done"] == 0, stage_progress["rounds_done"],
         0)
    hold(leg, "honest round attested",
         honest["attested"] == c_count and honest_log == {0: c_count},
         [honest["attested"], honest_log], [c_count, {0: c_count}])
    hold(leg, "honest round done", honest["progress"]["rounds_done"] == 1,
         honest["progress"], 1)
    hold(leg, "tampered row refused", tamper["refused"] >= 1 and all(
        "does not match" in r for r in tamper["refusals"]),
         tamper["refusals"][:2], "does not match")
    err = tamper["progress"].get("error") or ""
    hold(leg, "the tampered round did not attest", "did not attest" in err,
         err, "did not attest")
    hold(leg, "nothing committed after the tampered round",
         tamper["progress"]["rounds_done"] == 0 and tamper["epoch"] == 0,
         [tamper["progress"]["rounds_done"], tamper["epoch"]], [0, 0])
    want = {e: CONFIG5_PROTO["comm_count"]
            for e in range(EXECUTOR_MESH_ROUNDS)}
    hold(leg, "mesh runtime signatures a round", mesh_log == want,
         mesh_log, want)
    return counts


def executor_phase(torch, card: str, note, cli: bool = True) -> None:
    """The mesh executor's legs: (p) the drill, (o) config 5 and, unless
    `cli` is False (the full script runs it beside `processes_config1`),
    the CLI line."""
    note("executor_attest_drill",
         (executor_attest_drill_phase(torch, card), {}))
    executor_config5_phase(torch, card, note)
    if cli:
        executor_cli_phase(card, note)


class KernelTap:
    """Keeps the inputs of the last launch at each (kernel, dtype, shape)
    a path makes, so that each can be held against its plain version
    after the path's run (those launches are not the path's).  The last,
    not the first: the first training step's gradients are all zero (the
    head starts at zero), so the first K2/K3 launch proves nothing.  It
    wraps the three dense wrappers of the flash module and keeps
    references (no copy: nothing writes an activation in place); the
    wrappers themselves, and so the launch counts, are unchanged."""

    def __init__(self, fa):
        self.fa, self.last = fa, {}
        self.real = {name: getattr(fa, name) for name in DENSE_KERNELS}
        for name in DENSE_KERNELS:
            setattr(fa, name, self._wrap(name))

    def _wrap(self, name):
        real = self.real[name]

        def call(q, *rest):
            if q.is_cuda:
                key = (name, str(q.dtype).replace("torch.", ""),
                       tuple(q.shape))
                self.last[key] = tuple(t.detach() for t in (q,) + rest)
            return real(q, *rest)
        return call

    def undo(self) -> None:
        for name, fn in self.real.items():
            setattr(self.fa, name, fn)

    def hold(self, torch, leg: str) -> dict:
        """Each recorded launch again, kernel against plain on its inputs:
        {kernel: {dtype: [shape, ...]}}; raises on an error above TOL."""
        fa, seen = self.fa, {}
        for (name, dtype, shape), args in sorted(self.last.items()):
            got = getattr(fa, name)(*args)
            want = getattr(fa, name + "_plain")(*args)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = scale = 0.0
            for a, b in zip(got, want):
                a, b = a.float(), b.float()
                if not torch.isfinite(a).all():
                    raise gate_failed(leg, f"{name} {dtype} {list(shape)} "
                                      f"finite", False, True)
                err = max(err, float((a - b).abs().max()))
                scale = max(scale, float(b.abs().max()))
            tol = TOL[dtype] * max(1.0, scale)
            emit("compare", kernel=name, dtype=dtype, shape=list(shape),
                 leg=leg, on="the path's last launch at this shape",
                 max_abs_err=err, max_abs_plain=scale, tol=tol,
                 ok=err <= tol)
            hold(leg, f"{name} {dtype} {list(shape)} max_abs_err",
                 err <= tol, err, tol)
            hold(leg, f"{name} {dtype} {list(shape)} inputs not all zero",
                 scale > 0.0, scale, "> 0")
            seen.setdefault(name, {}).setdefault(dtype, []).append(
                list(shape))
        self.last.clear()
        return seen


def knob_config5_leg(torch, fa, device, card: str, leg: str, dtype,
                     moe_experts: int) -> dict:
    """Config 5 on the mesh runtime (`run_federated_mesh`, the CLI's
    default) with `make_transformer_classifier(dtype=..., moe_experts=
    ...)`, KNOB_ROUNDS rounds between a reset and a read of the launch
    counts, held to MESH_PER_ROUND a round; every launch of K1-K3 on the
    path at the leg's dtype and at KNOB_SHAPES, each (kernel, shape) held
    once against its plain version on the inputs of the path's last
    launch there (`KernelTap`); the
    parameters float32; the final model's decisions on the sponsor's
    rows against the CPU path's (TOL of the dtype).  Returns the
    launches."""
    from bflc_demo_tpu_torch.client.mesh_runtime import run_federated_mesh
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.protocol import ProtocolConfig

    dtype_name = str(dtype).replace("torch.", "")
    shards, test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])

    def make():
        return make_transformer_classifier(**CONFIG5_ARCH, dtype=dtype,
                                           moe_experts=moe_experts)
    model = make()
    n_params = sum(p.numel() for p in model.parameters())
    tap = KernelTap(fa)
    torch.cuda.reset_peak_memory_stats()
    try:
        reset_counts()
        t0 = time.perf_counter()
        res = run_federated_mesh(model, shards, test,
                                 ProtocolConfig(**CONFIG5_PROTO),
                                 rounds=KNOB_ROUNDS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        tap.undo()
    peak = torch.cuda.max_memory_allocated()
    want = {k: MESH_PER_ROUND.get(k, 0) * KNOB_ROUNDS for k in launches}
    acc = [a for _, a in res.accuracy_history]
    seen = tap.hold(torch, leg)
    times = res.round_times_s
    emit("knob", path=leg, nvidia_smi=card, dtype=dtype_name,
         moe_experts=moe_experts, rounds=KNOB_ROUNDS, accuracy=acc,
         best_acc=res.best_accuracy(), round_s=times,
         warm_round_s=statistics.median(times[1:]), wall_s=wall,
         peak_mem_bytes=peak, params=n_params,
         param_dtypes=sorted({str(v.dtype) for v in
                              res.final_params.values()}),
         launches=launches, expected_launches=want, held=seen,
         ledger_log_size=res.ledger_log_size,
         ledger_log_head=res.ledger_log_head.hex(),
         ledger_backend=res.ledger.backend)
    hold(leg, "rounds", res.rounds_completed == KNOB_ROUNDS,
         res.rounds_completed, KNOB_ROUNDS)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold_backend(leg, res.ledger.backend)
    hold(leg, "launches", launches == want, launches, want)
    hold(leg, "finite accuracies", bool(all(np.isfinite(acc))), acc, True)
    hold(leg, "float32 parameters", all(
        v.dtype == torch.float32 for v in res.final_params.values()),
        sorted({str(v.dtype) for v in res.final_params.values()}),
        ["torch.float32"])
    want_seen = {name: {dtype_name: sorted(map(list, shapes))}
                 for name, shapes in KNOB_SHAPES.items()}
    got_seen = {name: {d: sorted(v) for d, v in by.items()}
                for name, by in seen.items()}
    hold(leg, "kernel launches by dtype and shape", got_seen == want_seen,
         got_seen, want_seen)
    if moe_experts:
        hold(leg, "parameters", n_params == MOE_PARAMS, n_params, MOE_PARAMS)
    emit("accuracy", leg=leg, history=acc, bar=None,
         best=res.best_accuracy())
    decision_check(torch, res.final_params, device, f"{leg} final",
                   res.final_accuracy, model=make, data=([], test),
                   tol_factor=TOL[dtype_name])
    return launches


def optim_checkpoint_leg(torch, device, card: str) -> dict:
    """Config 1 with a local optimizer, checkpointed and resumed:
    OPTIM_ROUNDS mesh rounds with `sgd(OPTIM_LR, momentum=OPTIM_MOMENTUM)`
    through the preset (`config1_occupancy`) with `checkpoint_dir` and
    `checkpoint_every` OPTIM_ROUNDS; the CLI's own line in this process
    (`--rounds OPTIM_ROUNDS --checkpoint-dir D --checkpoint-every
    OPTIM_ROUNDS`: its checkpoint line, its checkpoint at the JSON's
    head); `load_checkpoint` of the optimizer run's directory (the head
    verified on load) and OPTIM_ROUNDS rounds resumed from it with the
    optimizer, which checkpoint again; that checkpoint at epoch 2 x
    OPTIM_ROUNDS with the resumed run's head; a tampered copy refused;
    the momentum run's model unlike plain SGD's; the final model on the
    card against the CPU path.  The launch counts are reset before the
    first run and read after the resumed one (B6 2 a round of the three
    runs).  Returns the launches."""
    import contextlib
    import io
    import shutil

    from bflc_demo_tpu_torch.__main__ import main as cli_main
    from bflc_demo_tpu_torch.core import optim
    from bflc_demo_tpu_torch.eval.configs import config1_occupancy
    from bflc_demo_tpu_torch.models import make_softmax_regression
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    from bflc_demo_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                      restore_params_like)
    leg = "optim_checkpoint_config1"
    cfg = ProtocolConfig()
    root = os.path.join(WORK_DIR, "checkpoints")
    shutil.rmtree(root, ignore_errors=True)
    run_dir, cli_dir = (os.path.join(root, n) for n in ("optim", "cli"))

    def sgd():
        return optim.sgd(OPTIM_LR, momentum=OPTIM_MOMENTUM)
    reset_counts()
    t0 = time.perf_counter()
    first = config1_occupancy(rounds=OPTIM_ROUNDS, runtime="mesh",
                              device="cuda", local_optimizer=sgd(),
                              checkpoint_dir=run_dir,
                              checkpoint_every=OPTIM_ROUNDS)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(["--rounds", str(OPTIM_ROUNDS), "--checkpoint-dir",
                       cli_dir, "--checkpoint-every", str(OPTIM_ROUNDS)])
    cli_s = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    hold(leg, "CLI exit code", rc == 0, rc, 0)
    cli = json.loads(lines[-1])
    want_line = f"checkpoint (model + ledger oplog) -> {cli_dir}"
    hold(leg, "CLI checkpoint line", lines[-2] == want_line, lines[-2],
         want_line)
    cli_flat, cli_ledger, cli_meta = load_checkpoint(cli_dir, cfg)
    hold(leg, "CLI checkpoint head", cli_ledger.log_head().hex()
         == cli["ledger_log_head"], cli_ledger.log_head().hex(),
         cli["ledger_log_head"])
    hold(leg, "CLI checkpoint epoch", cli_meta["epoch"] == OPTIM_ROUNDS,
         cli_meta["epoch"], OPTIM_ROUNDS)
    t0 = time.perf_counter()
    flat, ledger, meta = load_checkpoint(run_dir, cfg)
    load_s = time.perf_counter() - t0
    hold(leg, "checkpoint epoch", meta["epoch"] == ledger.epoch
         == OPTIM_ROUNDS, [meta["epoch"], ledger.epoch], OPTIM_ROUNDS)
    hold(leg, "checkpoint head", ledger.log_head()
         == first.ledger_log_head, ledger.log_head().hex(),
         first.ledger_log_head.hex())
    hold_backend(leg, ledger.backend)
    moved = float(max((first.final_params[k].cpu()
                       - torch.as_tensor(np.array(cli_flat[k]))).abs().max()
                      for k in first.final_params))
    hold(leg, "momentum changed the model", moved > 0.0, moved, "> 0")
    model = make_softmax_regression()
    params = restore_params_like(model.init_params(0, device), flat)
    t0 = time.perf_counter()
    resumed = config1_occupancy(rounds=OPTIM_ROUNDS, runtime="mesh",
                                device="cuda", seed=1,
                                local_optimizer=sgd(),
                                initial_params=params, resume_ledger=ledger,
                                checkpoint_dir=run_dir,
                                checkpoint_every=OPTIM_ROUNDS)
    torch.cuda.synchronize()
    resumed_s = time.perf_counter() - t0
    launches = read_counts()
    total = 2 * OPTIM_ROUNDS + OPTIM_ROUNDS          # + the CLI's rounds
    want = {k: 0 for k in launches}
    want["fingerprint"] = MESH_PER_ROUND["fingerprint"] * total
    _, end_ledger, end_meta = load_checkpoint(run_dir, cfg)
    tampered = os.path.join(root, "tampered")
    shutil.copytree(run_dir, tampered)
    path = os.path.join(tampered, "ledger.oplog")
    blob = bytearray(open(path, "rb").read())
    blob[40] ^= 0xFF                  # a byte inside the first op
    with open(path, "wb") as f:
        f.write(bytes(blob))
    try:
        load_checkpoint(tampered, cfg)
        refused = None
    except ValueError as exc:
        refused = str(exc)
    acc = [a for _, a in first.accuracy_history + resumed.accuracy_history]
    end = 2 * OPTIM_ROUNDS
    want_size = 20 + end * 15
    emit("knob", path=leg, nvidia_smi=card, optimizer=dict(
        name="sgd", learning_rate=OPTIM_LR, momentum=OPTIM_MOMENTUM),
         rounds=[OPTIM_ROUNDS, OPTIM_ROUNDS], accuracy=acc,
         best_acc=max(acc), round_s=first.round_times_s
         + resumed.round_times_s, first_s=first_s, cli_s=cli_s,
         load_s=load_s, resumed_s=resumed_s,
         checkpoint_bytes={f: os.path.getsize(os.path.join(run_dir, f))
                           for f in sorted(os.listdir(run_dir))},
         cli_best_acc=cli["best_acc"], momentum_vs_plain_max_diff=moved,
         resumed_epoch=resumed.ledger.epoch,
         resumed_log_size=resumed.ledger_log_size,
         end_checkpoint_epoch=end_meta["epoch"], tampered_refused=refused,
         launches=launches, expected_launches=want,
         ledger_backend=resumed.ledger.backend)
    hold(leg, "resumed epoch", resumed.ledger.epoch == end,
         resumed.ledger.epoch, end)
    hold(leg, "resumed ledger ops", resumed.ledger_log_size == want_size,
         resumed.ledger_log_size, want_size)
    hold(leg, "resumed chain verified", resumed.ledger.verify_log(), False,
         True)
    hold(leg, "end checkpoint", end_meta["epoch"] == end_ledger.epoch == end
         and end_ledger.log_head() == resumed.ledger_log_head,
         [end_meta["epoch"], end_ledger.log_head().hex()],
         [end, resumed.ledger_log_head.hex()])
    hold(leg, "tampered checkpoint refused", refused is not None, refused,
         "ValueError")
    hold(leg, "launches", launches == want, launches, want)
    hold(leg, "finite accuracies", bool(all(np.isfinite(acc))), acc, True)
    emit("accuracy", leg=leg, history=acc, bar=None, best=max(acc))
    config1_card_check(torch, device, resumed, leg)
    return launches


def knobs_phase(torch, fa, device, card: str) -> dict:
    """The three knob legs: `bf16_config5`, `moe_config5` and
    `optim_checkpoint_config1`.  Returns {path: launches}."""
    t0 = time.perf_counter()
    paths = {"bf16_config5": knob_config5_leg(
        torch, fa, device, card, "bf16_config5", torch.bfloat16, 0)}
    paths["moe_config5"] = knob_config5_leg(
        torch, fa, device, card, "moe_config5", torch.float32, MOE_EXPERTS)
    paths["optim_checkpoint_config1"] = optim_checkpoint_leg(torch, device,
                                                             card)
    emit("knobs", nvidia_smi=card, seconds=time.perf_counter() - t0)
    return paths


def native_ledger_phase(card: str) -> dict:
    """The native C++ ledger (built in the build phase, beside nvcc):
    a config-5 chain of LEDGER_CHAIN_ROUNDS rounds written through the
    python ledger, then applied op by op into fresh ledgers of both
    backends (the replica's path): the µs an applied op of each, best of
    3, with the heads, state bytes and digests held equal, and `auto` at
    config 5 held to native."""
    from bflc_demo_tpu_torch.ledger import bindings, make_ledger
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    cfg = ProtocolConfig(**CONFIG5_PROTO)
    src = make_ledger(cfg, backend="python")
    addrs = [f"0x{i:040x}" for i in range(cfg.client_num)]
    for a in addrs:
        src.register_node(a)
    rng = np.random.default_rng(0)
    for ep in range(LEDGER_CHAIN_ROUNDS):
        comm = src.committee()
        trainers = [a for a in addrs if a not in comm]
        for j in sorted(rng.permutation(len(trainers))
                        [:cfg.needed_update_count]):
            src.upload_local_update(trainers[j], rng.bytes(32),
                                    int(rng.integers(100, 200)),
                                    float(rng.random()), ep)
        for c in comm:
            src.upload_scores(c, ep, rng.random(
                cfg.needed_update_count).astype(np.float32).tolist())
        src.commit_model(rng.bytes(32), ep)
    ops = [src.log_op(i) for i in range(src.log_size())]
    us, leds = {}, {}
    for backend in ("native", "python"):
        best = None
        for _ in range(3):
            led = make_ledger(cfg, backend=backend)
            t0 = time.perf_counter()
            for op in ops:
                led.apply_op(op)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        us[backend] = best / len(ops) * 1e6
        leds[backend] = led
    nat, py = leds["native"], leds["python"]
    auto = make_ledger(cfg).backend
    emit("native_ledger", nvidia_smi=card, build_s=_BUILD.get("ledger_s"),
         library=str(bindings.library_path()), ops=len(ops),
         rounds=LEDGER_CHAIN_ROUNDS, us_per_op=us,
         python_over_native=us["python"] / us["native"],
         head_equal=nat.log_head() == py.log_head() == src.log_head(),
         state_equal=nat.encode_state() == py.encode_state(),
         digest_equal=nat.state_digest() == py.state_digest(),
         auto_backend=auto)
    leg = "native_ledger"
    hold(leg, "ops applied", nat.log_size() == py.log_size() == len(ops),
         nat.log_size(), len(ops))
    hold(leg, "head", nat.log_head() == py.log_head() == src.log_head(),
         nat.log_head().hex(), src.log_head().hex())
    hold(leg, "state bytes", nat.encode_state() == py.encode_state(),
         False, True)
    hold(leg, "state digest", nat.state_digest() == py.state_digest(),
         nat.state_digest().hex(), py.state_digest().hex())
    hold_backend(leg, auto)
    return us


def strict_dispatches(torch):
    """Make the mesh runtime's multi-round programs run with the card's
    sync debugging at "error": any operation that waits on the card
    inside a dispatch (`.item()`, a boolean-mask gather, a blocking copy)
    raises.  The dispatch's one copy to the host comes after.  Returns
    the undo."""
    from bflc_demo_tpu_torch.client import mesh_runtime
    real = mesh_runtime.make_multi_round_program

    def strict(*a, **kw):
        program = real(*a, **kw)

        def run(*args):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return program(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run
    mesh_runtime.make_multi_round_program = strict
    return lambda: setattr(mesh_runtime, "make_multi_round_program", real)


def dispatch_run(torch, leg: str, build, per_round: dict, **kw) -> tuple:
    """A preset on the mesh runtime (with `kw`), DISPATCH_ROUNDS rounds in
    dispatches of DISPATCH_R under `strict_dispatches`, between a reset
    and a read of the launch counts held to `per_round` a round: the
    ledger's audit of every round (a divergence raises), its chain and
    backend; each round's decision recorded (`DecisionTap`, its copies
    after each dispatch).  Returns (result, launches)."""
    undo = strict_dispatches(torch)
    tap = DecisionTap()
    try:
        reset_counts()
        res = build(rounds=DISPATCH_ROUNDS, runtime="mesh", device="cuda",
                    rounds_per_dispatch=DISPATCH_R, **kw)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        tap.undo()
        undo()
    if leg in PLAIN_KEPT:
        PLAIN_RUNS[leg] = (tap.rounds, res.final_params,
                           res.ledger_log_size)
    res.decisions = tap.rounds
    want = {k: per_round.get(k, 0) * DISPATCH_ROUNDS for k in launches}
    times = res.round_times_s
    emit("dispatch", path=leg, rounds=DISPATCH_ROUNDS, r=DISPATCH_R,
         accuracy=[a for _, a in res.accuracy_history],
         round_s=times, first_dispatch_round_s=times[0],
         warm_round_s=times[-1], wall_s=res.wall_time_s,
         ledger_log_size=res.ledger_log_size,
         ledger_log_head=res.ledger_log_head.hex(),
         ledger_backend=res.ledger.backend, launches=launches,
         expected_launches=want)
    hold(leg, "rounds", res.rounds_completed == DISPATCH_ROUNDS,
         res.rounds_completed, DISPATCH_ROUNDS)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold_backend(leg, res.ledger.backend)
    hold(leg, "launches", launches == want, launches, want)
    return res, launches


def ring_phase(torch, fa, device, card: str) -> tuple:
    """One config-5 round under ring scoring on the card between a reset
    and a read of the launch counts (RING_PER_ROUND); then, on one set of
    params and deltas, the ring's (N, N) matrix against the committee
    path's: the committee x uploader entries within one example, the
    same selection; then K1 at the ring's shape against its plain
    version and timed beside SDPA and its bound.  Returns (launches, K1's
    error, K1's timing row)."""
    from bflc_demo_tpu_torch.client.runtime import feature_tensor
    from bflc_demo_tpu_torch.client.staging import stage_padded_arrays
    from bflc_demo_tpu_torch.core.aggregate import decide
    from bflc_demo_tpu_torch.core.local_train import (sgd_stacked,
                                                      wire_deltas)
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.parallel import fedavg
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    cfg = ProtocolConfig(**CONFIG5_PROTO)
    n, c, k = cfg.client_num, cfg.comm_count, cfg.needed_update_count
    shards, _ = config5_data(0, 4000, n)
    xs_np, ys_np, ns_np = stage_padded_arrays(
        [x for x, _ in shards], [y for _, y in shards], 2)
    xs, ys = feature_tensor(xs_np, device), torch.as_tensor(ys_np).to(device)
    ns = torch.as_tensor(ns_np, dtype=torch.int32).to(device)
    model = make_transformer_classifier(**CONFIG5_ARCH).to(device)
    params = model.init_params(0, device)
    rng = np.random.default_rng(0)
    comm = np.zeros(n, bool)
    comm[:c] = True
    up = np.zeros(n, bool)
    up[c + rng.permutation(n - c)[:k]] = True
    leg = "ring_config5"
    kw = dict(client_num=n, lr=cfg.learning_rate, batch_size=cfg.batch_size,
              local_epochs=cfg.local_epochs,
              aggregate_count=cfg.aggregate_count, comm_count=c,
              needed_update_count=k)
    ring_round = fedavg.make_sharded_protocol_round(model, scoring="ring",
                                                    **kw)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    res = ring_round(params, xs, ys, ns, up, comm)
    torch.cuda.synchronize()
    round_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {name: RING_PER_ROUND.get(name, 0) for name in launches}
    # the two schedules on one set of params and deltas
    trained, costs = sgd_stacked(model, params, xs, ys, lr=cfg.learning_rate,
                                 batch_size=cfg.batch_size)
    deltas = wire_deltas(params, trained, cfg.learning_rate)
    comm_t, up_t = torch.as_tensor(comm).to(device), \
        torch.as_tensor(up).to(device)
    with torch.no_grad():
        ring = fedavg.ring_score_matrix(model, params, deltas,
                                        cfg.learning_rate, xs, ys)
        committee = fedavg.committee_score_matrix(
            model, params, deltas, cfg.learning_rate, xs, ys, comm_t, up_t,
            c, k)
    region = np.ix_(comm, up)
    ring_np, comm_np = ring.cpu().numpy(), committee.cpu().numpy()
    diff = float(np.abs(ring_np[region] - comm_np[region]).max())
    sel_ring = decide(ring, comm_t, up_t, costs, cfg.aggregate_count)[2]
    sel_comm = decide(committee, comm_t, up_t, costs,
                      cfg.aggregate_count)[2]
    emit("ring", path=leg, nvidia_smi=card, round_s=round_s,
         peak_mem_bytes=peak, scores=list(ring_np.shape),
         launches=launches, expected_launches=want,
         max_entry_diff_vs_committee=diff, tol=RING_ENTRY_TOL,
         selected=np.flatnonzero(res.selected.cpu().numpy()).tolist(),
         selection_equal=bool((sel_ring == sel_comm).all()))
    hold(leg, "launches", launches == want, launches, want)
    hold(leg, "dense matrix", ring_np.shape == (n, n)
         and bool(np.isfinite(ring_np).all()), list(ring_np.shape), [n, n])
    hold(leg, "entries vs committee", diff <= RING_ENTRY_TOL + 1e-6, diff,
         RING_ENTRY_TOL)
    hold(leg, "selection vs committee", bool((sel_ring == sel_comm).all()),
         np.flatnonzero(sel_ring.cpu().numpy()).tolist(),
         np.flatnonzero(sel_comm.cpu().numpy()).tolist())
    hold(leg, "selected", int(res.selected.sum()) == cfg.aggregate_count,
         int(res.selected.sum()), cfg.aggregate_count)
    del res, trained, deltas, ring, committee
    # K1 at the ring's shape: against its plain version, then timed
    inputs = device_attention_inputs(torch, RING_SCORE_SHAPE, device, 9)
    q, kk, v, _, mask = inputs
    got, lse = fa.flash_fwd(q, kk, v, mask)
    plain, plain_lse = fa.flash_fwd_plain(q, kk, v, mask)
    err = max(float((got - plain).abs().max()),
              float((lse - plain_lse).abs().max()))
    tol = TOL["float32"] * max(1.0, float(plain.abs().max()),
                               float(plain_lse.abs().max()))
    emit("compare", kernel="flash_fwd", dtype="float32",
         shape=list(RING_SCORE_SHAPE), max_abs_err=err, tol=tol,
         ok=err <= tol)
    hold(leg, "K1 at the ring shape max_abs_err", err <= tol, err, tol)
    del got, lse, plain, plain_lse
    row = forward_timing(torch, fa, device, RING_SCORE_SHAPE, seed=9,
                         card=card, inputs=inputs, **RING_FEW)
    del inputs, q, kk, v, mask
    torch.cuda.empty_cache()
    return launches, err, dict(row, shape=list(RING_SCORE_SHAPE))


def dispatch_phase(torch, fa, device, card: str) -> tuple:
    """Configs 1 and 5 at R = 5 (`dispatch_run`) and the ring round
    (`ring_phase`): config 1's final model against the CPU path and its
    accuracy bar, config 5's final model's decisions on the sponsor's
    rows against the CPU path's.  Returns ({path: launches}, K1's error
    and timing row at the ring's shape, {config: round seconds})."""
    from bflc_demo_tpu_torch.data.occupancy import occupancy_source
    from bflc_demo_tpu_torch.eval.configs import (config1_occupancy,
                                                  config5_data,
                                                  config5_transformer_sst2)
    leg = "dispatch_config1"
    c1, c1_launches = dispatch_run(torch, leg, config1_occupancy,
                                   {"fingerprint":
                                    MESH_PER_ROUND["fingerprint"]})
    accuracy_gate(leg, c1, DISPATCH_C1_MIN_BEST[occupancy_source()])
    config1_card_check(torch, device, c1, leg)
    leg = "dispatch_config5"
    c5, c5_launches = dispatch_run(torch, leg, config5_transformer_sst2,
                                   MESH_PER_ROUND)
    # printed without a bar: config 5's accuracy at R = 5 on the card has
    # no CPU trajectory over seeds to rest a bar on
    emit("accuracy", leg=leg, history=[a for _, a in c5.accuracy_history],
         bar=None, best=c5.best_accuracy())
    _, test = config5_data()
    decision_check(torch, c5.final_params, device, "dispatch final",
                   c5.final_accuracy, data=([], test))
    ring_launches, err, row = ring_phase(torch, fa, device, card)
    return ({"dispatch_config1": c1_launches,
             "dispatch_config5": c5_launches,
             "ring_config5": ring_launches}, err, row,
            {"config1": c1.round_times_s, "config5": c5.round_times_s})


# the plain runs the secure legs are held against: label -> (decisions
# a round, final params, ledger size)
PLAIN_KEPT = ("mesh_config4", "dispatch_config5")
PLAIN_RUNS: dict = {}
# B7's SASS counts, measured once a run (`b7_sass`)
_SASS: dict = {}


class DecisionTap:
    """Records each mesh round's decision as the runtime audits it:
    (uploaders, committee, selected), client ids ascending — the
    one-round path through `audit_round`, a dispatch from its program's
    masks, copied after the dispatch returns (outside its strict sync
    mode).  Install it after `strict_dispatches`, undo it before."""

    def __init__(self):
        from bflc_demo_tpu_torch.client import mesh_runtime
        self.mr, self.rounds = mesh_runtime, []
        self.real = (mesh_runtime.audit_round,
                     mesh_runtime.make_multi_round_program)
        mesh_runtime.audit_round = self._audit
        mesh_runtime.make_multi_round_program = self._program

    def _audit(self, *args):
        uploader_ids, committee_ids, up_slots = args[3], args[4], args[5]
        client_of = dict(zip(up_slots, uploader_ids))
        self.rounds.append((sorted(uploader_ids), sorted(committee_ids),
                            sorted(client_of[int(s)] for s in args[11])))
        return self.real[0](*args)

    def _program(self, *a, **kw):
        program = self.real[1](*a, **kw)

        def run(*args):
            res = program(*args)
            up, comm, sel = (m.cpu().numpy() for m in (
                res.uploader_masks, res.committee_masks, res.selected))
            for r in range(up.shape[0]):
                self.rounds.append(tuple(np.flatnonzero(m[r]).tolist()
                                         for m in (up, comm, sel)))
            return res
        return run

    def undo(self) -> None:
        self.mr.audit_round, self.mr.make_multi_round_program = self.real


class B7Tap:
    """Keeps the inputs and words of every B7 round a path makes (one
    launch a round over every leaf, `masked_encode_leaves`), by
    reference: nothing writes a round's deltas or words after the merge
    reads them.  `rounds` holds each round's (leaves, wn, packed keys,
    clip, words, views); `calls` every round's leaves and `last` the
    last round's, by leaf index, each as (deltas, wn, the leaf's packed
    (S(S-1)/2, 2) keys, clip, words)."""

    def __init__(self):
        from bflc_demo_tpu_torch.ops import secure_mask
        self.sm, self.rounds = secure_mask, []
        self.real = secure_mask.masked_encode_leaves
        secure_mask.masked_encode_leaves = self._call

    def _call(self, leaves, wn, keys, clip):
        words, views = self.real(leaves, wn, keys, clip)
        if words.is_cuda:
            self.rounds.append((leaves, wn, keys, clip, words, views))
        return words, views

    def _leaves(self, round_: tuple) -> list:
        leaves, wn, keys, clip, _, views = round_
        return [(d, wn, k, clip, v) for d, k, v in zip(leaves, keys, views)]

    @property
    def calls(self) -> list:
        return [leaf for r in self.rounds for leaf in self._leaves(r)]

    @property
    def last(self) -> dict:
        return dict(enumerate(self._leaves(self.rounds[-1])))

    def undo(self) -> None:
        self.sm.masked_encode_leaves = self.real


def b7_merge_hold(torch, leg: str, tap: B7Tap) -> dict:
    """Every round's masked merge against the plain weighted mean of the
    same deltas (float64 on the card), leaf by leaf: the difference
    within the fixed point's own error, S x 2**-17 (each slot's rounding
    to 2**-16) plus the float32 roundings of the products and the sum
    (2**-23 of their magnitudes).  Returns the worst share of that bound
    and the largest difference."""
    sm = tap.sm
    worst, largest = 0.0, 0.0
    for deltas, wn, _, clip, words in tap.calls:
        x = torch.nan_to_num(deltas.double(), nan=0.0, posinf=clip,
                             neginf=-clip).clamp(-clip, clip)
        x = (x * wn.double()[:, None]).clamp(-clip, clip)
        exact = x.sum(0)
        diff = (sm.unmask_sum(words).double() - exact).abs()
        bound = deltas.shape[0] * 2.0 ** -17 + 2.0 ** -23 * (
            x.abs().sum(0) + exact.abs())
        worst = max(worst, float((diff / bound).max()))
        largest = max(largest, float(diff.max()))
    hold(leg, "masked merge vs plain mean, every round", worst <= 1.0,
         worst, 1.0)
    return {"merges_held": len(tap.calls),
            "max_merge_diff_vs_plain_mean": largest,
            "max_share_of_fixed_point_bound": worst}


def first_divergence(got: list, want: list):
    """The index of the first round whose decision differs, or None."""
    for r, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return r
    return None if len(got) == len(want) else min(len(got), len(want))


def pair_seed_timer():
    """Time each `derive_pair_seeds` call the mesh runtime makes: (the
    list of seconds, the undo)."""
    from bflc_demo_tpu_torch.client import mesh_runtime
    real, seconds = mesh_runtime.derive_pair_seeds, []

    def timed(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)
    mesh_runtime.derive_pair_seeds = timed
    return seconds, lambda: setattr(mesh_runtime, "derive_pair_seeds", real)


def b7_hold(torch, leg: str, tap: B7Tap) -> dict:
    """On the last round's B7 launches of a path: the sum over the slots
    of every leaf's masked words against the sum of the unmasked
    fixed-point words, bit for bit; the kernel's words against the plain
    version's on every leaf under SECURE_WINDOW elements and on the last
    SECURE_WINDOW of each larger one, bit for bit; each slot's share of
    masked words equal to its unmasked one.  Returns the line's fields
    (and the plain version's seconds)."""
    sm = tap.sm
    worst_share, plain_s, compared, mismatched = 0.0, 0.0, 0, 0
    for idx in sorted(tap.last):
        deltas, wn, keys, clip, words = tap.last[idx]
        q = sm.encode_plain(deltas, wn, clip)
        want = q.sum(0) & sm.MASK
        got = words.to(torch.int64).sum(0) & sm.MASK
        hold(leg, f"leaf {idx} sum over slots vs unmasked",
             bool(torch.equal(got, want)),
             int((got != want).sum()), 0)
        equal = (words.to(torch.int64) & sm.MASK) == q
        share = float(equal.sum(1).max()) / deltas.shape[1]
        worst_share = max(worst_share, share)
        hold(leg, f"leaf {idx} slot words blinded",
             share <= SECURE_BLIND_SHARE, share, SECURE_BLIND_SHARE)
        n = deltas.shape[1]
        start = max(0, n - SECURE_WINDOW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = sm.masked_encode_plain(deltas[:, start:], wn, keys, clip,
                                       offset=start)
        torch.cuda.synchronize()
        plain_s += time.perf_counter() - t0
        bad = int((plain != words[:, start:]).sum())
        compared += plain.numel()
        mismatched += bad
        hold(leg, f"leaf {idx} B7 vs plain words", bad == 0, bad, 0)
        del plain, q, want, got, equal
    return {"leaves": len(tap.last), "words_compared": compared,
            "words_mismatched": mismatched,
            "max_share_equal_unmasked": worst_share,
            "plain_compare_s": plain_s}


def b7_work(slots: int, elements: int) -> tuple:
    """(integer operations, bytes) of B7 over `elements` of a leaf at
    `slots` slots: each pair's mask once, each delta read and each word
    written once (the keys and weights are bytes to spare)."""
    pairs = slots * (slots - 1) // 2
    return (pairs * elements * B7_OPS_PER_MASK,
            slots * elements * (4 + 4))


def b7_mask_words_a_pass(loop: dict, per: int) -> int:
    """The mask words one pass of B7's pair loop draws, from its SASS
    counts `loop` (`eval/sass.py:counts`): its LOP3s over
    B7_LOP3_PER_MASK, which must be a whole multiple of the `per`
    elements a thread (more when ptxas unrolls the loop), else the gate
    fails."""
    lop3 = sum(n for op, n in loop["opcodes"].items()
               if op.split(".")[0] == "LOP3")
    ok = lop3 > 0 and lop3 % (B7_LOP3_PER_MASK * per) == 0
    hold("secure", "B7 pair loop's LOP3s a whole number of passes", ok,
         lop3, f"a multiple of {B7_LOP3_PER_MASK} x {per}")
    return lop3 // B7_LOP3_PER_MASK


def b7_sass(sm) -> dict:
    """B7's SASS by pipe (`eval/sass.py`: the whole kernel and its pair
    loop), per mask word (the loop's counts over the words a pass draws,
    `b7_mask_words_a_pass`), printed on a line of its own the first
    time."""
    if "secure_mask" not in _SASS:
        from bflc_demo_tpu_torch.eval import sass
        from bflc_demo_tpu_torch.ops.build import library_path
        found = sass.pipe_counts(str(library_path("secure_mask")),
                                 "secure_mask_kernel", "LOP3")
        per = sm.elements_a_thread()
        words = b7_mask_words_a_pass(found["loop"], per)
        found["elements_a_thread"] = per
        found["mask_words_a_pass"] = words
        found["per_mask_word"] = {k: found["loop"][k] / words for k in
                                  ("total", "alu", "fma", "mio", "other")}
        emit("sass", **found)
        _SASS["secure_mask"] = found
    return _SASS["secure_mask"]


def b7_timing(torch, tap: B7Tap, case: str, card: str) -> dict:
    """B7 over the last round (its one launch over every leaf, into a
    fresh output) and at its largest leaf (a one-leaf launch), each
    timed from CUDA-graph replays beside its bound (operations over
    INT_ISSUE_OPS against bytes over HBM_BYTES_PER_S) and the floors its
    pair loop's SASS implies (the INT pipe's and the FMA pipe's
    instructions a mask word, each pipe 64 lanes an SM a clock), and the
    plain version's one call between CUDA events."""
    sm = tap.sm
    leaves, wn, keys, clip, _, _ = tap.rounds[-1]
    full = tap.last
    big = max(full, key=lambda i: leaves[i].shape[1])
    per_word = b7_sass(sm)["per_mask_word"]
    rows = {}
    for name, idx in ((case, sorted(full)), (f"{case}_largest_leaf", [big])):
        plan = sm.RoundPlan([leaves[i] for i in idx], wn, keys[idx], clip)
        out = torch.empty((plan.slots, plan.total), dtype=torch.int32,
                          device=leaves[0].device)
        ms = device_ms(torch, lambda plan=plan, out=out: plan.launch(out),
                       calls=3, replays=2, repeats=3)
        plain_ms = event_ms(torch, lambda idx=idx: [
            sm.masked_encode_plain(*full[i][:4]) for i in idx])
        slots, elements = plan.slots, plan.total
        ops, moved = b7_work(slots, elements)
        t_ops = ops / INT_ISSUE_OPS * 1e3
        t_bytes = moved / HBM_BYTES_PER_S * 1e3
        words = slots * (slots - 1) // 2 * elements
        row = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
               "library": None, "bound_ms": max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops >= t_bytes else "bytes",
               "ops": ops, "bytes": moved, "slots": slots,
               "elements": elements, "leaves": len(idx),
               "launches_a_call": 1,
               "int_pipe_floor_ms": words * per_word["alu"]
               / (INT_ISSUE_OPS / 2) * 1e3,
               "fma_pipe_floor_ms": words * per_word["fma"]
               / (INT_ISSUE_OPS / 2) * 1e3,
               "shape": [slots, elements] if len(idx) == 1 else None,
               "nvidia_smi": card}
        row["share_of_bound"] = row["bound_ms"] / ms
        emit("timing", kernel="secure_mask", case=name, **row)
        rows[name] = row
    main = rows[case]
    main["at"] = {f"{case}_largest_leaf": rows[f"{case}_largest_leaf"]}
    return main


def secure_c4_launches(launches: dict) -> dict:
    """`secure_config4`'s launches: B6 2 and B7 1 (one launch over the
    62 leaves) a round, nothing else."""
    want = {k: 0 for k in launches}
    want["fingerprint"] = MESH_PER_ROUND["fingerprint"] * SECURE_C4_ROUNDS
    want["secure_mask"] = B7_PER_ROUND * SECURE_C4_ROUNDS
    return want


def max_param_diff(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def secure_config4_leg(torch, card: str) -> tuple:
    """Config 4 at the full preset with `secure=True` on the mesh runtime
    through the CLI's own entry point, in this process: `main(["--config",
    "config4", "--secure", "--rounds", SECURE_C4_ROUNDS])` (exit 0, its
    JSON), between a reset and a read of the launch counts, held against
    `mesh_config4` (its decisions, ledger size and final params), B7 on
    its last round's inputs (`b7_hold`) and timed.  Returns (launches,
    B7's timing row)."""
    import contextlib
    import io
    from bflc_demo_tpu_torch import __main__ as cli
    from bflc_demo_tpu_torch.eval import configs
    leg = "secure_config4"
    decisions, plain_params, log_size = PLAIN_RUNS["mesh_config4"]
    torch.cuda.reset_peak_memory_stats()
    seeds_s, undo_seeds = pair_seed_timer()
    tap, b7 = DecisionTap(), B7Tap()
    runs, real_run = [], configs.run_federated_mesh

    def kept(*a, **kw):
        runs.append(real_run(*a, **kw))
        return runs[-1]
    configs.run_federated_mesh = kept
    out = io.StringIO()
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--config", "config4", "--secure", "--rounds",
                           str(SECURE_C4_ROUNDS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
    finally:
        configs.run_federated_mesh = real_run
        b7.undo()
        tap.undo()
        undo_seeds()
    hold(leg, "CLI exit code", rc == 0, rc, 0)
    printed = json.loads(out.getvalue().strip().splitlines()[-1])
    res = runs[0]
    peak = torch.cuda.max_memory_allocated()
    want = secure_c4_launches(launches)
    diff = max_param_diff(res.final_params, plain_params)
    acc = [a for _, a in res.accuracy_history]
    merged = b7_merge_hold(torch, leg, b7)
    held = b7_hold(torch, leg, b7)
    diverged = first_divergence(tap.rounds, decisions)
    emit("secure", path=leg, nvidia_smi=card, rounds=SECURE_C4_ROUNDS,
         round_s=res.round_times_s, derive_pair_seeds_s=seeds_s,
         wall_s=wall, peak_mem_bytes=peak, accuracy=acc,
         launches=launches, expected_launches=want, decisions=tap.rounds,
         plain_decisions=decisions, first_divergent_round=diverged,
         max_param_diff_vs_plain=diff, param_tol=SECURE_C4_PARAM_TOL,
         attested_epochs=sorted(res.attest_log or {}),
         ledger_log_size=res.ledger_log_size,
         ledger_backend=res.ledger.backend, cli_json=printed, **merged,
         **held)
    hold(leg, "rounds", res.rounds_completed == SECURE_C4_ROUNDS,
         res.rounds_completed, SECURE_C4_ROUNDS)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold_backend(leg, res.ledger.backend)
    hold(leg, "launches", launches == want, launches, want)
    # the first round starts from the same model: the same decision; a
    # later one may flip on the fixed point's rounding (printed)
    hold(leg, "first round's decision vs mesh_config4",
         tap.rounds[:1] == decisions[:1], tap.rounds[:1], decisions[:1])
    hold(leg, "ledger log size", res.ledger_log_size == log_size
         and printed["ledger_log_size"] == log_size,
         [res.ledger_log_size, printed["ledger_log_size"]], log_size)
    hold(leg, "CLI rounds", printed["rounds"] == SECURE_C4_ROUNDS,
         printed["rounds"], SECURE_C4_ROUNDS)
    hold(leg, "params vs mesh_config4", diff <= SECURE_C4_PARAM_TOL, diff,
         SECURE_C4_PARAM_TOL)
    hold(leg, "finite accuracies", bool(all(np.isfinite(acc))), acc, True)
    hold(leg, "attested rounds",
         sorted(res.attest_log or {}) == list(range(SECURE_C4_ROUNDS)),
         sorted(res.attest_log or {}), list(range(SECURE_C4_ROUNDS)))
    row = b7_timing(torch, b7, "config4_round", card)
    del b7, res
    torch.cuda.empty_cache()
    return launches, row


def secure_dispatch_config5_leg(torch, card: str) -> tuple:
    """Config 5 with 20 DH wallets at `rounds_per_dispatch` DISPATCH_R,
    DISPATCH_ROUNDS rounds (`dispatch_run`): decisions round for round
    equal `dispatch_config5`'s, final params within SECURE_C5_PARAM_TOL,
    launches the mesh round's plus B7 one a round; B7 on the last
    round's inputs (`b7_hold`) and timed.  Returns (launches, B7's
    timing row)."""
    from bflc_demo_tpu_torch.comm.identity import provision_wallets
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    leg = "secure_dispatch_config5"
    decisions, plain_params, log_size = PLAIN_RUNS["dispatch_config5"]
    wallets, _ = provision_wallets(CONFIG5_PROTO["client_num"],
                                   SECURE_C5_WALLET_SEED)
    seeds_s, undo_seeds = pair_seed_timer()
    b7 = B7Tap()
    try:
        res, launches = dispatch_run(
            torch, leg, config5_transformer_sst2, SECURE_C5_PER_ROUND,
            secure_aggregation=True, secure_wallets=wallets)
    finally:
        b7.undo()
        undo_seeds()
    diff = max_param_diff(res.final_params, plain_params)
    merged = b7_merge_hold(torch, leg, b7)
    held = b7_hold(torch, leg, b7)
    diverged = first_divergence(res.decisions, decisions)
    emit("secure", path=leg, nvidia_smi=card, rounds=DISPATCH_ROUNDS,
         r=DISPATCH_R, round_s=res.round_times_s,
         derive_pair_seeds_s=seeds_s,
         accuracy=[a for _, a in res.accuracy_history],
         launches=launches, max_param_diff_vs_plain=diff,
         param_tol=SECURE_C5_PARAM_TOL, decisions=res.decisions,
         plain_decisions=decisions, first_divergent_round=diverged,
         **merged, **held)
    hold(leg, "first round's decision vs dispatch_config5",
         res.decisions[:1] == decisions[:1], res.decisions[:1],
         decisions[:1])
    hold(leg, "ledger log size", res.ledger_log_size == log_size,
         res.ledger_log_size, log_size)
    hold(leg, "params vs dispatch_config5", diff <= SECURE_C5_PARAM_TOL,
         diff, SECURE_C5_PARAM_TOL)
    hold(leg, "attested rounds",
         sorted(res.attest_log or {}) == list(range(DISPATCH_ROUNDS)),
         sorted(res.attest_log or {}), list(range(DISPATCH_ROUNDS)))
    row = b7_timing(torch, b7, "config5_round", card)
    del b7, res
    torch.cuda.empty_cache()
    return launches, row


class CountingKeyRing:
    """A `KeyRing` that counts the tags it verified, by op kind, and keeps
    each verified upload's signed bytes and tag by (sender, epoch,
    payload hash), to replay."""

    def __init__(self, master: bytes):
        from bflc_demo_tpu_torch.comm.identity import KeyRing
        self.ring, self.verified, self.refused = KeyRing(master), {}, 0
        self.uploads = {}
        self.lock = threading.Lock()

    def mac(self, address: str, op_bytes: bytes) -> bytes:
        return self.ring.mac(address, op_bytes)

    def verify(self, address: str, op_bytes: bytes, tag: bytes) -> bool:
        ok = self.ring.verify(address, op_bytes, tag)
        (kind_len,) = struct.unpack_from("<q", op_bytes, 0)
        kind = op_bytes[8:8 + kind_len].decode()
        with self.lock:
            if ok:
                self.verified[kind] = self.verified.get(kind, 0) + 1
                if kind == "upload":
                    sender, payload, _, _, epoch = upload_args(op_bytes)
                    self.uploads[(sender, epoch, payload.hex())] = (
                        op_bytes, tag)
            else:
                self.refused += 1
        return ok


def upload_args(op_bytes: bytes) -> tuple:
    """(sender, payload hash, n_samples, avg_cost, epoch) of a signed
    upload's bytes (`comm.identity._op_bytes`)."""
    off = 8 + struct.unpack_from("<q", op_bytes, 0)[0]
    (n,) = struct.unpack_from("<q", op_bytes, off)
    sender = op_bytes[off + 8:off + 8 + n].decode()
    off += 8 + n
    (epoch,) = struct.unpack_from("<q", op_bytes, off)
    body = op_bytes[off + 16:]
    n_samples, cost = struct.unpack_from("<qd", body, 32)
    return sender, body[:32], n_samples, cost, epoch


def keyring_threaded_leg(torch, card: str) -> dict:
    """The threaded runtime at config 5 on the card with an HMAC keyring,
    KEYRING_ROUNDS rounds between a reset and a read of the launch
    counts: every client op on the chain authenticated (a verified tag
    for each register, upload and scores op), then at the live ledger a
    forged tag, a replayed tag and a client's tag for another's address
    refused.  Returns the launches."""
    from bflc_demo_tpu_torch.client.threaded import ThreadedFederation
    from bflc_demo_tpu_torch.comm.identity import (KeyRing, sign_register,
                                                   sign_upload)
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.ledger.base import decode_op
    from bflc_demo_tpu_torch.models import make_transformer_classifier
    from bflc_demo_tpu_torch.protocol import ProtocolConfig
    leg = "keyring_threaded_config5"
    shards, test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    ring = CountingKeyRing(KEYRING_MASTER_SEED)
    fed = ThreadedFederation(make_transformer_classifier(**CONFIG5_ARCH),
                             shards, test, ProtocolConfig(**CONFIG5_PROTO),
                             keyring=ring, device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    res = fed.run(rounds=KEYRING_ROUNDS, timeout_s=FLEET_TIMEOUT_S)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    led = fed.ledger
    kinds = {"register": 0, "upload": 0, "scores": 0}
    for i in range(led.log_size()):
        op = decode_op(led.log_op(i))
        if op["op"] in kinds:
            kinds[op["op"]] += 1
        if op["op"] == "upload":
            last = (op["sender"], op["epoch"], op["payload_hash"])
    verified, refused_in_run = dict(ring.verified), ring.refused
    # the impostors, at the live ledger: a forged tag on a trainer's
    # upload, the run's last verified upload replayed, a client's tag on
    # another's address, a forged registration
    size = led.log_size()
    epoch = led.epoch
    committee = set(led.committee())
    trainer, other = [n.address for n in fed.nodes
                      if n.address not in committee][:2]
    body = (b"\x07" * 32, 100, 1.0, epoch)
    impostor = KeyRing(b"an-impostor-master-seed-0001")
    # the chain's last upload, as its client signed it
    replay_bytes, replay_tag = ring.uploads[last]
    probes = {
        "forged_tag": led.upload_local_update(
            trainer, *body, sign_upload(impostor, trainer, *body)),
        "replayed_tag": led.upload_local_update(
            *upload_args(replay_bytes), replay_tag),
        "signed_for_another_address": led.upload_local_update(
            trainer, *body, sign_upload(ring, other, *body)),
        "forged_register": led.register_node(
            "0x" + "ab" * 20, sign_register(impostor, "0x" + "ab" * 20))}
    acc = [a for _, a in res.accuracy_history]
    emit("keyring", path=leg, nvidia_smi=card, rounds=res.rounds_completed,
         wall_s=wall, accuracy=acc, ops_on_chain=kinds,
         tags_verified=verified, tags_refused_in_run=refused_in_run,
         refusals={k: st.name for k, st in probes.items()},
         replayed_epoch=upload_args(replay_bytes)[4], epoch=epoch,
         launches=launches, recoveries=fed.recoveries,
         client_errors=fed.client_errors,
         ledger_log_size=res.ledger_log_size)
    hold(leg, "rounds", res.rounds_completed == KEYRING_ROUNDS,
         res.rounds_completed, KEYRING_ROUNDS)
    hold(leg, "chain verified", res.ledger.verify_log(), False, True)
    hold(leg, "client ops authenticated",
         all(verified.get(k, 0) >= v for k, v in kinds.items())
         and kinds["upload"] > 0 and kinds["scores"] > 0, verified, kinds)
    hold(leg, "no tag refused in the run", refused_in_run == 0,
         refused_in_run, 0)
    # a replay at the tag's own epoch is a DUPLICATE; past it the epoch
    # guard refuses it (WRONG_EPOCH): either way it is not taken
    for name, bar in (("forged_tag", ("BAD_ARG",)),
                      ("replayed_tag", ("DUPLICATE", "WRONG_EPOCH")),
                      ("signed_for_another_address", ("BAD_ARG",)),
                      ("forged_register", ("BAD_ARG",))):
        hold(leg, f"impostor {name} refused", probes[name].name in bar,
             probes[name].name, list(bar))
    hold(leg, "impostors added no op", led.log_size() == size,
         led.log_size(), size)
    hold(leg, "no client errors", not fed.client_errors, fed.client_errors,
         [])
    hold(leg, "finite accuracies", bool(all(np.isfinite(acc))), acc, True)
    for name in DENSE_KERNELS:
        hold(leg, f"{name} launched", launches[name] > 0, launches[name],
             "> 0")
    return launches


def secure_phase(torch, card: str, keyring: bool = True) -> tuple:
    """The secure legs after the presets (`secure_config4` through the
    CLI's entry point, `secure_dispatch_config5` and, with `keyring`,
    `keyring_threaded_config5`).  Returns ({path: launches}, B7's error,
    B7's timing row)."""
    from bflc_demo_tpu_torch.ops import secure_mask
    secure_mask.reset_launches()
    c4, row = secure_config4_leg(torch, card)
    c5, row5 = secure_dispatch_config5_leg(torch, card)
    row["at"].update({"config5_round": row5, **row5.pop("at")})
    PLAIN_RUNS.clear()
    paths = {"secure_config4": c4, "secure_dispatch_config5": c5}
    if keyring:
        paths["keyring_threaded_config5"] = keyring_threaded_leg(torch, card)
    return paths, 0, row


def keyring_child_start() -> tuple:
    """Start `keyring_threaded_config5` in a child process (`python3
    chip_smoke.py --keyring-leg`, on the kernels this run built), its
    output to files under WORK_DIR: (the process, its start, the
    output's path)."""
    os.makedirs(WORK_DIR, exist_ok=True)
    base = os.path.join(WORK_DIR, "keyring_leg")
    here = os.path.abspath(__file__)
    with open(base + ".out", "w") as out, open(base + ".err", "w") as err:
        proc = subprocess.Popen([sys.executable, here, "--keyring-leg"],
                                stdout=out, stderr=err,
                                cwd=os.path.dirname(here))
    return proc, time.perf_counter(), base


def keyring_child_finish(started: tuple) -> dict:
    """Wait for the child of `keyring_child_start`, print its leg's line
    again (its gate's line too, if one failed there) and return the
    leg's launches; fail unless it exited 0 with that line."""
    leg = "keyring_threaded_config5"
    proc, t0, base = started
    try:
        proc.wait(timeout=FLEET_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(base + ".out") as out, open(base + ".err") as err:
        stdout, stderr = out.read(), err.read()
    lines = [json.loads(x) for x in stdout.splitlines()
             if x.startswith("{")]
    for rec in lines:
        if rec["phase"] == "gate_failed":
            print(json.dumps(rec), flush=True)
    found = [rec for rec in lines if rec["phase"] == "keyring"]
    if proc.returncode != 0 or not found:
        raise gate_failed(leg, "child exit code", proc.returncode, 0,
                          stderr[-4000:])
    rec = {k: v for k, v in found[0].items() if k not in ("phase", "t")}
    emit("keyring", **rec, child_t=found[0]["t"],
         child_wall_s=time.perf_counter() - t0)
    return rec["launches"]


def keyring_leg_main() -> int:
    """Only `keyring_threaded_config5`, on kernels already built."""
    port = load_port()
    if port is None:
        return 1
    torch = port[0]
    card = card_line()
    print(card, flush=True)
    keyring_threaded_leg(torch, card)
    return 0


def secure_main() -> int:
    """Only the build, the plain legs the secure legs are held against
    and the secure phase."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, device = port
    from bflc_demo_tpu_torch.eval.configs import config5_transformer_sst2
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    label, name, rounds, bar, kw = PRESET_RUNS[-1]
    preset_run(torch, name, label, rounds, bar, **kw)
    dispatch_run(torch, "dispatch_config5", config5_transformer_sst2,
                 MESH_PER_ROUND)
    paths, err, row = secure_phase(torch, card)
    emit("secure_launches", nvidia_smi=card, launches=paths,
         secure_mask={**row, "max_abs_err": err})
    return 0


def load_port(root: str = None):
    """(torch, the flash-attention module, the build module, the card) of
    the package beside this script, or of the checkout at `root`; None
    without a card or a package."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return None
    if root is not None:
        sys.path.insert(0, os.path.abspath(root))
    try:
        from bflc_demo_tpu_torch.device import resolve_device
        from bflc_demo_tpu_torch.ops import build
        from bflc_demo_tpu_torch.ops import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository "
              f"({exc})", file=sys.stderr)
        return None
    return torch, fa, build, resolve_device("cuda")   # also turns TF32 off


_BUILD: dict = {}


def start_build() -> None:
    """Start compiling every kernel in a thread (one `nvcc` a source or
    part, all at once) before torch is imported and the card is
    initialised, which then overlap the compiles; `finish_build` waits.
    Without the package beside this script nothing starts."""
    try:
        from bflc_demo_tpu_torch.ledger import bindings
        from bflc_demo_tpu_torch.ops import build
    except ImportError:
        return

    def run():
        try:
            _BUILD["built"] = build.build_all()
        except Exception as exc:        # noqa: BLE001 — raised by finish
            _BUILD["error"] = exc

    def run_ledger():
        # the native ledger (g++, one process) beside the nvcc parts
        try:
            _BUILD["ledger_s"] = bindings.build_library()["seconds"]
        except Exception as exc:        # noqa: BLE001 — raised by finish
            _BUILD["error"] = exc

    _BUILD["t0"] = time.perf_counter()
    _BUILD["thread"] = threading.Thread(target=run, daemon=True)
    _BUILD["ledger"] = threading.Thread(target=run_ledger, daemon=True)
    _BUILD["thread"].start()
    _BUILD["ledger"].start()


def finish_build(build) -> dict:
    """`build_all`'s result for the build `start_build` started (its
    failure raised here), or for one run now; `_BUILD["seconds"]` is its
    wall time from its start."""
    thread = _BUILD.get("thread")
    if thread is None:
        from bflc_demo_tpu_torch.ledger import bindings
        _BUILD["t0"] = time.perf_counter()
        _BUILD["built"] = build.build_all()
        _BUILD["ledger_s"] = bindings.build_library()["seconds"]
    else:
        thread.join()
        _BUILD["ledger"].join()
        if "error" in _BUILD:
            raise _BUILD["error"]
    _BUILD["seconds"] = time.perf_counter() - _BUILD["t0"]
    return _BUILD["built"]


def build_fields(built: dict) -> dict:
    """The build line's seconds, each library's parts' seconds and the
    native ledger's."""
    return {"seconds": _BUILD["seconds"],
            "parts_s": {n: b["parts_s"] for n, b in built.items()},
            "native_ledger_s": _BUILD.get("ledger_s")}


def backward_timing_main(root: str) -> int:
    """Only the dK/dV and dQ timing rows, at the training and the ring
    shapes, for the package of the checkout at `root`."""
    port = load_port(root)
    if port is None:
        return 1
    torch, fa, _, device = port
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         package=os.path.dirname(os.path.dirname(fa.__file__)))
    backward_timing(torch, fa, device, TRAIN_SHAPE, seed=2)
    backward_timing(torch, fa, device, RING_SHAPE, seed=6, **RING_FEW)
    return 0


def merge_timing_main(root: str) -> int:
    """Only B5's timing rows, at every merge geometry and block count,
    for the package of the checkout at `root`."""
    port = load_port(root)
    if port is None:
        return 1
    torch, fa, _, device = port
    from bflc_demo_tpu_torch.meshagg import check
    from bflc_demo_tpu_torch.ops import certified_reduce as cr
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         package=os.path.dirname(os.path.dirname(fa.__file__)))
    cases = {name: check.geometry_case(name) for name in check.GEOMETRIES}
    merge_timing_rows(torch, cr, device, cases, full=False)
    return 0


def snapshots_main() -> int:
    """Only the build and the TLS and snapshot legs (with `bft_config5`,
    their plaintext twin)."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
    from bflc_demo_tpu_torch.eval.configs import config5_data
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    paths, roles = {}, {}

    def note(path, launches_roles):
        paths[path], by_role = launches_roles
        for role, v in by_role.items():
            roles[role] = roles.get(role, 0) + v

    xtr, ytr, xte, yte = load_occupancy()
    drill_shards = iid_shards(xtr[:FAILOVER_ROWS], ytr[:FAILOVER_ROWS],
                              FLEET_PROTO["client_num"])
    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    bft5 = bft_phase(torch, card, note, drill_shards, (xte[:500], yte[:500]),
                     c5_shards, c5_test)
    snapshot_phase(torch, card, note, c5_shards, c5_test, bft5)
    emit("fleet", paths=paths, b5_by_role=roles,
         seconds=time.perf_counter() - t0)
    return 0


def async_main() -> int:
    """Only the build and the async FedBuff leg (h)."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    from bflc_demo_tpu_torch.eval.configs import config5_data
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    paths, roles = {}, {}

    def note(path, launches_roles):
        paths[path], by_role = launches_roles
        for role, v in by_role.items():
            roles[role] = roles.get(role, 0) + v

    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    async_phase(torch, card, note, c5_shards, c5_test)
    emit("fleet", paths=paths, b5_by_role=roles,
         seconds=time.perf_counter() - t0)
    return 0


def codecs_main() -> int:
    """Only the build, `bft_config5` (the dense twin) and the codec legs
    (i, j)."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
    from bflc_demo_tpu_torch.eval.configs import config5_data
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    paths, roles = {}, {}

    def note(path, launches_roles):
        paths[path], by_role = launches_roles
        for role, v in by_role.items():
            roles[role] = roles.get(role, 0) + v

    xtr, ytr, xte, yte = load_occupancy()
    drill_shards = iid_shards(xtr[:FAILOVER_ROWS], ytr[:FAILOVER_ROWS],
                              FLEET_PROTO["client_num"])
    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    bft5 = bft_config5_run(torch, card, note, c5_shards, c5_test)
    codecs_phase(torch, card, note, c5_shards, c5_test, drill_shards,
                 (xte[:500], yte[:500]), bft5)
    emit("fleet", paths=paths, b5_by_role=roles,
         seconds=time.perf_counter() - t0)
    return 0


def hier_main() -> int:
    """Only the build and the hier legs (k, l)."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    from bflc_demo_tpu_torch.data import iid_shards, load_occupancy
    from bflc_demo_tpu_torch.eval.configs import config5_data
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    paths, roles = {}, {}

    def note(path, launches_roles):
        paths[path], by_role = launches_roles
        for role, v in by_role.items():
            roles[role] = roles.get(role, 0) + v

    xtr, ytr, xte, yte = load_occupancy()
    drill_shards = iid_shards(xtr[:FAILOVER_ROWS], ytr[:FAILOVER_ROWS],
                              FLEET_PROTO["client_num"])
    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    hier_phase(torch, card, note, c5_shards, c5_test, drill_shards,
               (xte[:500], yte[:500]))
    emit("fleet", paths=paths, b5_by_role=roles,
         seconds=time.perf_counter() - t0)
    return 0


def rederive_main() -> int:
    """Only the build and the rederive legs (m, n)."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    from bflc_demo_tpu_torch.eval.configs import config5_data
    from bflc_demo_tpu_torch.ops import certified_reduce as cr
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    counts, validator_b5, _ = rederive_drill_phase(torch, cr, card)
    paths, roles = {"rederive_drill": counts}, {"validator": validator_b5}

    def note(path, launches_roles):
        paths[path], by_role = launches_roles
        for role, v in by_role.items():
            roles[role] = roles.get(role, 0) + v

    c5_shards, c5_test = config5_data(0, 4000, CONFIG5_PROTO["client_num"])
    rederive_config5_phase(torch, card, note, c5_shards, c5_test)
    emit("fleet", paths=paths, b5_by_role=roles,
         seconds=time.perf_counter() - t0)
    return 0


def executor_main() -> int:
    """Only the build and the executor legs (o, p) with the CLI line."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    forward_timing(torch, port[1], port[3], ATTEST_SCORE_SHAPE, seed=8,
                   card=card)
    paths = {}

    def note(path, launches_roles):
        paths[path] = launches_roles[0]

    executor_phase(torch, card, note)
    emit("fleet", paths=paths, seconds=time.perf_counter() - t0)
    return 0


def dispatch_main() -> int:
    """Only the build, the native ledger's line and the dispatch phase
    (configs 1 and 5 at R = 5, the ring round, K1 at the ring's shape)."""
    port = load_port()
    if port is None:
        return 1
    torch, fa, build, device = port
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    native_ledger_phase(card)
    paths, _, _, dispatched = dispatch_phase(torch, fa, device, card)
    emit("round_times", nvidia_smi=card, mesh_dispatch=dispatched,
         launches=paths)
    return 0


def knobs_main() -> int:
    """Only the build, the bfloat16 timing rows and the knob legs."""
    port = load_port()
    if port is None:
        return 1
    torch, fa, build, device = port
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    rows = {name: {"at": {}} for name in DENSE_KERNELS}
    bf16_timing_rows(torch, fa, device, card, rows)
    paths = knobs_phase(torch, fa, device, card)
    emit("knob_launches", nvidia_smi=card, launches=paths)
    return 0


def processes_main() -> int:
    """Only the build and the processes phase."""
    port = load_port()
    if port is None:
        return 1
    torch, _, build, _ = port
    t0 = time.perf_counter()
    emit("build", **build_fields(finish_build(build)))
    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0))
    paths, roles = processes_phase(torch, card)
    emit("fleet", paths=paths, b5_by_role=roles)
    return 0


def main() -> int:
    port = load_port()
    if port is None:
        return 1
    torch, fa, build, device = port
    from bflc_demo_tpu_torch.ops import certified_reduce as cr
    from bflc_demo_tpu_torch.ops import fingerprint as fp

    t0 = time.perf_counter()
    built = finish_build(build)
    logs = "".join(b["log"] for b in built.values())
    emit("build", **build_fields(built),
         libraries={n: b["path"] for n, b in built.items()},
         kernels_compiled=len(re.findall(r"Compiling entry", logs)),
         max_registers=max(map(int, re.findall(r"Used (\d+) registers",
                                               logs)), default=None),
         spill_bytes=sum(map(int, re.findall(r"(\d+) bytes spill", logs))))

    card = card_line()
    print(card, flush=True)
    emit("device", nvidia_smi=card, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    native_ledger_phase(card)

    errors = compare_phase(torch, fa, device)
    timings = timing_phase(torch, fa, device, card)
    # each path between a reset and a read of the launch counts
    host5 = slice_phase(torch, fa, device)
    mesh5 = mesh_slice_phase(torch, fa, fp, device)
    mesh1 = config1_phase(torch, fa, fp, device)
    dispatch_paths, ring_err, ring_row, dispatched = dispatch_phase(
        torch, fa, device, card)
    timings["flash_fwd"]["at"]["ring_score"] = dict(ring_row,
                                                    max_abs_err=ring_err)
    knob_paths = knobs_phase(torch, fa, device, card)
    emit("round_times", nvidia_smi=card,
         config5={"host": host5["round_s"], "mesh": mesh5["round_s"],
                  "mesh_dispatch": dispatched["config5"]},
         config1={"host": mesh1["host_round_s"], "mesh": mesh1["round_s"],
                  "mesh_dispatch": dispatched["config1"]})
    presets = presets_phase(torch, device, card)
    secure_paths, errors["secure_mask"], timings["secure_mask"] = \
        secure_phase(torch, card, keyring=False)
    trees, errors["fingerprint"] = fingerprint_compare_phase(torch, fp,
                                                             device)
    timings["fingerprint"] = fingerprint_timing_phase(torch, fp, device,
                                                      trees)
    del trees
    errors["flash_carry"] = carry_compare_phase(torch, fa, device)
    timings["flash_carry"], timings["flash_fwd"]["at"]["ring"] = \
        carry_timing_phase(torch, fa, device)
    ring = backward_timing(torch, fa, device, RING_SHAPE, seed=6, **RING_FEW)
    for name, row in ring.items():
        timings[name]["at"]["ring"] = dict(row, shape=list(RING_SHAPE))
    cases = merge_compare_phase(torch, cr, device)
    errors["certified_reduce"] = 0.0
    merge_paths = merge_path_phase(torch, cr, device, cases)
    timings["certified_reduce"] = merge_timing_phase(torch, cr, device,
                                                     cases)
    del cases
    drill, drill_b5, drill_rows = rederive_drill_phase(torch, cr, card)
    for name, row in drill_rows.items():
        timings["certified_reduce"]["at"][f"rederive_{name}"] = row
    fleet, roles = processes_phase(torch, card, keyring=True)
    roles["validator"] = roles.get("validator", 0) + drill_b5
    paths = {"host_config5": host5["launches"],
             "mesh_config5": mesh5["launches"],
             "mesh_config1": mesh1["launches"],
             **dispatch_paths, **knob_paths,
             **presets, **secure_paths,
             "sp": {"flash_carry": sp_slice_phase(torch, fa, device)},
             **merge_paths, "rederive_drill": drill, **fleet}
    by_path = {name: {path: counts.get(name, 0)
                      for path, counts in paths.items()}
               for name in KERNELS}
    hold_no_processes_left("exit")
    emit("done", seconds=time.perf_counter() - t0)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": KERNELS[name], "launches": sum(by_path[name].values()),
         "launches_by_path": by_path[name], "max_abs_err": errors[name],
         **({"launches_by_role": roles} if name == "certified_reduce"
            else {}),
         **timings[name]}
        for name in KERNELS]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def dispatch(argv) -> int:
    if len(argv) == 2 and argv[0] == "--backward-timing":
        return backward_timing_main(argv[1])
    if len(argv) == 2 and argv[0] == "--merge-timing":
        return merge_timing_main(argv[1])
    if argv == ["--keyring-leg"]:
        return keyring_leg_main()
    modes = {"--processes": processes_main, "--snapshots": snapshots_main,
             "--async": async_main, "--codecs": codecs_main,
             "--hier": hier_main, "--rederive": rederive_main,
             "--executor": executor_main, "--dispatch": dispatch_main,
             "--knobs": knobs_main, "--secure": secure_main}
    if len(argv) == 1 and argv[0] in modes:
        start_build()
        rc = modes[argv[0]]()
        if rc == 0:
            hold_no_processes_left(argv[0])
        return rc
    if argv:
        print("usage: chip_smoke.py [--backward-timing DIR | "
              "--merge-timing DIR | --keyring-leg | --processes | "
              "--snapshots | --async | --codecs | --hier | --rederive | "
              "--executor | --dispatch | --knobs | --secure]",
              file=sys.stderr)
        return 2
    start_build()
    return main()


if __name__ == "__main__":
    try:
        adopt_orphans()
        sys.exit(dispatch(sys.argv[1:]))
    except Exception as exc:
        # what stopped the run (a gate, a fleet that timed out, a child
        # that failed) on the standard output too; the traceback follows
        # on the standard error
        emit("failed", error=f"{type(exc).__name__}: {exc}"[:4000])
        raise
    finally:
        # a failed run, too, leaves no process behind
        stop_processes()
