#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with one CUDA card, nvcc
and PyTorch built for CUDA.  The script:

1. prints the card's name and power limit;
2. builds the kernels K1-K27 from `consensus_specs_tpu_torch/csrc/` (one
   nvcc per source, all started together) into the git-ignored
   `consensus_specs_tpu_torch/_build/`;
3. runs each kernel and its plain PyTorch version on the card, on the
   same seeded inputs at the main path's shapes, requires bit equality
   (the arithmetic is exact integer, so the tolerance is zero) and times
   both;
4. runs the full-rebuild epoch step (sweep, balances root, registry
   root) at 2**20 validators with mainnet phase0 constants through
   `make_epoch_step`, requires its four outputs to equal the plain
   step's, requires every kernel's launch count from that one run to be
   > 0, and times it;
5. runs the incremental epoch step of `bench.py`'s epoch worker at 2**20
   validators with a 1% dirty set through `IncrementalEpochStep` (masked
   sweep, dirty balance chunks, dirty record roots, dirty-path re-hash of
   the persisted balances and registry forests, both in one K4 launch),
   requires both roots to equal the full rebuild's and every output and
   forest layer to equal the plain incremental step's, requires the
   launch count of every kernel of that step to be > 0 and prints them,
   and times it and its stages; K1 is also held on the edge registry
   (`convert.edge_registry`: effective balances 0, 1, incr - 1 and
   2**64 - 1, delays 0, 1 and 2**64 - 1, one active validator, slashings
   that make the adjustment the whole active balance), K4 on both forests
   in one launch, duplicates, unsorted indices, an all-dirty forest,
   depths 0 and 1, and two forests against two launches;
6. emits 1024 SSZ proofs from the balances forest and verifies each
   against the list root;
7. BLS, slices 3 and 4: holds K7 (`bls_field_ops`) canonically equal to
   the plain field and tower ops on 1024 random elements and on edge
   values; builds `bench_bls.py`'s config #2 inputs (128 statements, each
   the aggregate of 64 keys) from a seed; runs `batch_verify` at B = 128
   with host hashing (K8 -> K9 -> K10) and with device hashing, its
   default (K11 -> K8 -> K9 -> K10), requires each kernel launched once,
   all 128 device hashes equal to the port oracle's, and every output
   canonically equal to the plain version's on the card (K11 also at 1
   and 129 messages, row by row against the plain rows; K8 also on an
   edge batch of 37 lanes: the scalars 0, 1, 2, 3 and 2^128 - 1, T = -Q
   and T = Q on a G1 point of order 3, pad lanes); settles the
   same statements once more through the `DeferredBatch` facade;
   requires, through both routes, a batch with one signature by a wrong
   key rejected and a batch with one-sided infinity rejected (through
   `pairing_check_device`); times both routes in turns (host prep apart,
   the device time of each kernel), with verifies per second and each
   kernel's int32-issue bound;
8. config #3 (`bench_bls.py`'s one 512-key sync-committee statement):
   `pairing_check_device` through K12 -> K10, K12 held against its plain
   version, cold and warm times; the facade's eager
   `FastAggregateVerify` over the 512 wire keys, `Verify` and
   `AggregateVerify`, accept and reject, on the card;
9. the G1 MSM on `bench_bls.py`'s probe at 16, 512 (Pippenger, K13) and
   4096 points (double-and-add, K14), each kernel held against its plain
   version and the result against the oracle's `g1.msm`, each chain's
   floor (its pass rounds times a round's product latency), and the
   facade's `multi_exp` routing at 15 and 16 points;
10. slice 5, the scalar field: K15 (`fr_field_ops`) canonically equal to
   the plain Fr ops on 1024 random elements and 0, 1, r - 1, and its
   batch inverse (the recovery's, one launch) at 1, 2, 8, 8192 (also
   with a zero element) and 65539 elements (runs of several a thread),
   against its plain product tree and the ints' inverses; the Fr
   product's latency on one thread;
11. config #5, Deneb `verify_blob_kzg_proof_batch` over `bench.py`
   worker_kzg's 6 blobs: commitments (K14 at 4096 points) and proofs
   (K16 + K14) made on the card, one commitment held against the host
   oracle; the batch accepted through K16 per blob and K12 -> K10, each
   blob's y equal to the host loop's, K16 equal to its plain version
   (also with z on the domain, the zero polynomial, and a cell's coset
   of 64 at a random z and on it),
   swapped proofs and a wrong blob rejected; cold and warm times with
   the host and device split;
12. PeerDAS `verify_cell_proof_batch` on `bench.py` worker_das's 128 x 8
   closed-form matrix (1024 cells): accepted through K17, K14 (LL, RLP),
   K13 (RL) and K12 -> K10, K17 equal to its plain version and the host
   fold (and to its plain version at B = 16 and 128 and at B = 1024
   with every input r - 1), a tampered cell rejected, a 16-cell sub-batch equal on the host
   route and isolated by `verify_and_isolate`, `evaluate_cells_at` (K16)
   equal to the host route; the stage split;
13. fulu `compute_cells` of `bench.py`'s closed-form degree-65 blob
   through K18 (n = 4096 inverse, n = 8192 forward): its 128 cells equal
   to the closed form and the host FFT route, K18 equal to its plain
   version at both sizes; then K18 against its plain version at every
   path shape ((1, 8192) both ways, (2, 8192), (1, 4096) inverse, (64,
   128)) and at the tile's edges (n = 2, T, 2T);
14. slice 6, the G1 FFT: K19 (`g1_fft`) against its plain version at the
   FK20 setup shape (64, 128) forward on the trusted setup's residue
   vectors and at (1, 128) inverse (which must come back to the setup
   points), at n = 8 against the naive evaluation and the round trip;
   K18 at batch 64, n = 128 and K20 (`fk20_hext`) at (64, 128) on the
   setup tables and a dense blob's digits against their plain versions;
   K19 at n = 8 and 16 with masked lanes and rows at infinity, its n = 8
   round trip (the addition's doubling branch) and K20 at 8 x 16 with a
   doubled bucket, a point beside its negative and a masked infinity
   against their plain versions; K19's plain versions (the setup's in
   blocks of rows) and the edges' are computed on the CPU by worker
   processes at a low priority while nvcc builds and the card runs the
   earlier phases; one pass round's product
   latency (`kernels.g1_product_chain`) and each chain's floor (its pass
   rounds times that latency);
15. fulu `compute_cells_and_kzg_proofs` by FK20 on the closed-form
   degree-65 blob (K18, K15, K20, K19 x 2): cells and proofs equal to
   the closed form, the cold call (the setup tables built by one K19)
   and the warm median with the device split; on `bench.py` worker_kzg's
   dense blob 0, all 128 cells and proofs accepted by
   `verify_cell_proof_batch` as one batch, a swapped proof rejected,
   columns 0 and 77 equal to `cell_proof_for_column` (K14 at 4032);
16. `recover_cells_and_kzg_proofs` from the 64 even cells of both blobs
   (the decode on K18 and K15, the re-evaluation, the FK20 re-prove):
   byte-equal to the closed form and the producer's output, at most 7 K15
   launches, cold and warm times with the split; 63 cells and a duplicate
   index rejected;
17. slice 7, fork choice: K21 (`fc_apply`), K22 (`fc_refresh`) and K23
   (`fc_head`) against their plain versions at the mainnet shape (1024
   blocks, 2**20 validators, batches of 16384) on seeded inputs with a
   repeated validator, padded rows, equivocators, the boost and a head
   decided by root words at the 2**31 boundary, K21 also over 8
   batches back to back with its winner table all -1 after each, K22
   also against `index_add_`; K23 also on every case of
   `synthetic.head_inputs` (a
   linear chain, a chain over the rung, a heavier branch without a
   viable leaf, ties in the low word of the last pair) at NB = 64, 1024
   and 16384 (its global-scratch route), its rounds and the empty
   barrier phase's cost beside its time; then three paths through `ProtoArrayStore` on the card
   (`bench.py:897 worker_forkchoice`'s 256 x 16384 and 1024 x 262144
   with batches of 1024, and 1024 x 2**20 with batches of 16384), each 8
   batches followed by `get_head`, the head, accepted count and live
   weights after every batch equal to a plain store's on the card; apply
   and head times with the host parse and each kernel's device time;
18. slice 8, the sharded paths, on virtual meshes that list the card D
   times (the counterpart of the JAX tests' forced host devices): the
   edge cases first, K24 (`epoch_sweep_sharded`, the sweep's three
   phases per shard) at 2**14 validators over 4 shards with proposers in
   other shards, negative and out of range, each phase against its plain
   version and the sweep against K1, and with every attester's proposer
   among 32 validators at D = 2, 4 and 8 against K1 and the plain sharded
   sweep; K25 (`rlc_miller_shard`) and K26
   (`rlc_shard_combine`) on 16 statements over 4 shards, two of them
   padding only, then K26 on two equal partials, K26's f equal to the
   unsharded K9 f; K27 (`g1_shard_fold`) on (P, P, infinity, Q); the
   per-lane Miller body at its edge shapes, each against its plain
   version: K9 at 1, 2, 31, 33 and 129 lanes with dead lanes of each
   kind and at 4 lanes with every signature at infinity, K25 on one
   lane, K26 at D = 1 and on two equal partials (D = 2); K13 at c = 4,
   6, 8, K14 at 1024 and 4096 lanes and K27 at D = 1-4 on their edge
   inputs (`msm_edge_inputs`; K13's plain versions on the CPU by a
   worker process), each against its plain version; then
   K24 at the main path's shape (2**20 validators over 4 shards), each
   phase and the whole sweep against the plain sharded sweep; the full
   step at 2**20
   validators over 2, 4 and 8 shards through `make_sharded_epoch_step`,
   every output and every root replica equal to `make_epoch_step`'s,
   timed beside it with each phase's device time; a `ShardedMerkleForest`
   of the 2**20 balances over 4 shards with bench's 1% dirty update, its
   root equal to the single forest's and 1024 proofs verified; config
   #2's 128 statements through `batch_verify_sharded` over 4 shards,
   accepted, its f equal to the unsharded host-hashed batch's, a wrong
   key rejected, timed against that batch, with K25 on that batch's
   shard of 32 lanes and K26 on its 4 partials against their plain
   versions; `g1_multi_exp_sharded` at
   4096 points over 4 shards against the oracle and
   `g1_multi_exp_device`; the DAS verify with its MSMs over 2 shards;
   and, on a machine with two cards or more, the step, forest, batch and
   MSM once more over real cards (`device_ids`);
19. prints each phase's seconds, one JSON line of the kernels held, then,
   last, the result line `{"ok": true, "device": {...}}`.

Every phase is fatal: any failure raises and the script exits non-zero
without a result line.  It exits non-zero at once when no CUDA device is
available.  It imports nothing of JAX or of `consensus_specs_tpu`.
"""

from __future__ import annotations

import collections
import functools
import json
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np

N_VALIDATORS = 2**20
SEED = 0
SCALARS = (100, 2, 32_000_000_000)   # __graft_entry__.entry()'s: epoch 100
INCR_SCALARS = (100_000, 2, 32_000_000_000)   # bench.py worker_epoch's
N_PROOFS = 1024
# the device kernels of each counted wrapper, by the profiler's names
PROFILED_KERNELS = {
    "epoch_sweep": ("sweep_totals_kernel", "sweep_shares_kernel",
                    "sweep_apply_kernel"),
    "sha256_64B": ("sha256_64B_kernel", "sha256_u64_leaves_kernel"),
    "update_level": ("forest_update_kernel",),
    "balance_chunks": ("balance_chunks_kernel",),
    "records_root_gather": ("records_root_kernel",),
}
SLEEP_CYCLES = 2_000_000             # about 1 ms at the H100's clocks
HBM_BYTES_PER_S = 3.35e12            # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64              # ALU (or FMA-heavy) lanes an SM a clock
# BLS, slice 3: bench_bls.py's config #2 (128 aggregate attestations of
# 64-strong committees, its seed base 1000), the RLC coefficients from
# random.Random(BLS_RNG_SEED)
BLS_TASKS = 128
BLS_COMMITTEE = 64
BLS_SEED_BASE = 1000
BLS_RNG_SEED = 0
BLS_TIMED = 3
BLS_TIMED_HOST = 1     # the host-hashing route: 98% host, 7.6 s a turn
BLS_FIELD_N = 1024
# slice 4: config #3 (bench_bls.py's one 512-member sync-committee
# statement, seed base 2000) and the MSM probe sizes
SYNC_COMMITTEE = 512
SYNC_SEED_BASE = 2000
MSM_SIZES = (16, 512, 4096)
# K13's edge shapes (c, n points) and K14's (lanes): `msm_edge_inputs`
MSM_EDGE_PIP = ((4, 16), (6, 64), (8, 64), (4, 8))
MSM_EDGE_DA = (1024, 4096)
# slice 5: config #5 (bench.py:1112 worker_kzg's 6 blobs), the PeerDAS
# 128 x 8 sampling matrix (bench.py:626 worker_das, seed 20250), a
# 16-cell sub-batch of it with cell 5 tampered, and K15's elements
KZG_BLOBS = 6
KZG_TIMED = 5
DAS_BLOBS = 8
DAS_COLUMNS = 128
DAS_TIMED = 2
DAS_SUB = 16
DAS_BAD = 5
FR_FIELD_N = 1024
# K15's batch inverse: (n, a zero element); past 256 blocks of 256
# threads (n = 65539) a thread takes a run of elements; the recovery's
# n = 8192 is the one timed.  K18's shapes held against
# the plain version (batch, n, inverse): the paths' (the recovery's
# decode and re-evaluation, compute_cells, FK20's rows) and the tile's
# edges at T = FFT_TILE; the Fr product latency probe's chain
FR_BATCH_INV = ((1, False), (2, False), (8, False), (8192, True),
                (8192, False), (65539, False))
K18_SHAPES = ((1, 8192, False), (1, 8192, True), (2, 8192, False),
              (1, 4096, True), (64, 128, False), (1, 2, False),
              (1, "T", False), (1, "2T", True), (3, "2T", False))
FR_CHAIN_PROBE = 4096
# slice 6: the producer's and the recovery's warm repeats
DAS_PRODUCER_TIMED = 3
DAS_RECOVER_TIMED = 3
# K19's edge transforms (n, batch, inverse), beside the main path's (1,
# 128) and (64, 128); K20's edge shape (residues, positions); the
# products of the latency probe's chain
G1FFT_EDGE = ((8, 3, False), (16, 1, False), (16, 3, True))
FK20_EDGE = (8, 16)
# the rows of the setup's (64, 128) plain K19 forward a worker computes
# (one torch thread each: two threads a worker ran 2.5x slower than one
# beside nvcc), and the workers' nice increment (below nvcc and the card's
# phases)
G1_PLAIN_ROWS = 16
G1_PLAIN_NICE = 10
G1_CHAIN_PROBE = 4096
# slice 7, fork choice: (path, blocks, validators, batch): bench.py:897
# worker_forkchoice's default CST_FC_MATRIX with its batches of 1024, then
# the mainnet width (1024 unfinalized blocks, 2**20 validators, batches of
# 16384: the top rungs of FC_VALIDATOR_STEPS and FC_BATCH_STEPS)
FC_PATHS = (("forkchoice_256x16384", 256, 16384, 1024),
            ("forkchoice_1024x262144", 1024, 262144, 1024),
            ("forkchoice_mainnet", 1024, 2**20, 16384))
FC_BATCHES = 8
FC_HEAD_RUNGS = (64, 1024, 16384)    # K23's checks: the ladder's rungs
FC_PROBE_PHASES = 1000               # the empty barrier probe's phases
# slice 8, the sharded paths on virtual meshes of the card (its device
# listed D times, as the JAX tests force D host devices): K24 at 2**14
# validators over 4 shards; K25 and K26 on 16 statements over 4 shards
# (two of them padding only); the full step at 2**20 over 2, 4 and 8
# shards; the sharded forest, config #2's batch and the 4096-point MSM
# over 4; the DAS verify's MSMs over 2, on 2 columns x 8 blobs
SHARD_K24_N = 2**14
SHARD_D = 4
# K24's and K1's proposer shares on 32 rows (`convert.hot_proposers`)
HOT_PROPOSERS = 32
SHARD_WIDTHS = (2, 4, 8)
SHARD_BLS_CHECK = 16
SHARD_MSM = 4096
SHARD_DAS_COLUMNS = 2
SHARD_TIMED = 3
# the Miller body's and K11's edge shapes, beside the main path's
RLC_EDGE_B = (1, 2, 31, 33, 129)
# K12's (live lanes, bucket) and K10's values beside the main path's
PAIRING_EDGE = ((1, 8), (5, 8), (6, 8), (8, 8), (32, 32))
# K8's edge batch: an odd width, its edge scalars on the first lanes
K8_EDGE_B = 37
K8_EDGE_SCALARS = (0, 1, 2, 3, 2**128 - 1)
# an Fr Montgomery product over 8 32-bit words: 2 x 64 multiply-adds of
# two 32-bit instructions each; an inversion by r - 2 is 254 squarings
# and 163 products
OPS_PER_FR_MONT = 2 * 64 * 2
FR_INV_PRODUCTS = 254 + 163
# a Montgomery product over 12 32-bit words is 2 x 144 32x32->64
# multiply-adds, each at least two 32-bit integer instructions (the low
# and the high half); the carries and the final subtraction are not
# counted, so the bound is a floor
OPS_PER_MONT = 2 * 144 * 2
# SASS opcodes that issue to the FMA pipe's heavy half on the H100 (16
# lanes a scheduler, as the ALU pipe has), and the prefixes of those that
# are no part of a message's arithmetic: memory, control, barriers,
# special registers and the uniform datapath (a pipe of its own)
SASS_FMA_HEAVY = ("IMAD", "IMUL")
# sm_90's VIADD, whose pipe NVIDIA does not document: counted at the issue
# rate only, so that the floor holds on either pipe
SASS_EITHER_PIPE = ("VIADD",)
SASS_NOT_ARITH = ("LD", "ST", "ATOM", "RED", "BRA", "EXIT", "BSSY", "BSYNC",
                  "BAR", "WARPSYNC", "S2R", "S2UR", "CS2R", "NOP", "CALL",
                  "RET", "U")
# a SASS instruction line: its address, a predicate, the opcode
SASS_LINE = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_opcodes(lib: str, kernel: str) -> dict:
    """{opcode: count} over the SASS text of the kernel whose name holds
    `kernel` in the built library `lib` (`cuobjdump -sass`), the opcode
    cut at its first '.'."""
    from pathlib import Path

    from consensus_specs_tpu_torch import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(_build._target(lib))],
                          check=True, capture_output=True, text=True,
                          timeout=120).stdout
    for part in text.split("Function : ")[1:]:
        if kernel in part.split("\n", 1)[0]:
            return dict(collections.Counter(SASS_LINE.findall(part)))
    raise RuntimeError(f"no kernel {kernel!r} in the SASS of {lib}")


@functools.cache
def sha_message_mix() -> dict:
    """One 64-byte SHA-256 message's arithmetic instructions by pipe, from
    the SASS of K2's `sha256_64B_kernel` (one message a thread, straight
    line: its text is what a thread runs, a few address instructions
    included): "fma" the FMA-heavy pipe's (IMAD, IMUL), "either" those
    of SASS_EITHER_PIPE, "alu" the rest (LOP3, IADD3, SHF, ...), which the
    ALU pipe runs (Nsight Compute's pipe definitions: the ALU pipe takes
    the logic, bit-manipulation and integer instructions but IMAD and
    IMUL)."""
    ops = sass_opcodes("sha256", "sha256_64B_kernel")
    fma = sum(c for op, c in ops.items() if op in SASS_FMA_HEAVY)
    either = sum(c for op, c in ops.items() if op in SASS_EITHER_PIPE)
    alu = sum(c for op, c in ops.items()
              if op not in SASS_FMA_HEAVY + SASS_EITHER_PIPE
              and not op.startswith(SASS_NOT_ARITH))
    return {"alu": alu, "fma": fma, "either": either, "opcodes": ops}


def ops_per_message() -> float:
    """A message's floor in 32-bit lane-clocks at INT32_LANES_PER_SM a
    clock: the ALU pipe's instructions and the FMA-heavy pipe's each at
    64 lanes an SM a clock, and all of them at the issue rate of 128 (four
    schedulers, a warp-instruction a clock each), the largest of the
    three.  hash_to_g2's xmd is 9 of these a message (`h2c_work`)."""
    mix = sha_message_mix()
    return max(mix["alu"], mix["fma"],
               (mix["alu"] + mix["fma"] + mix["either"]) / 2)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back runs, after one
    warm-up run, from CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int, setup=None) -> float:
    """Mean device time of one call of `fn`, from CUDA events around each
    call.  A sleep kernel queued before each call keeps the device busy
    while the host enqueues it, so the host's time between launches is
    not counted (it is for `cuda_ms`, which a small kernel's wrapper
    overhead then dominates).  `setup`, where given, runs before each
    call, outside the events (to restore what `fn` updates in place)."""
    import torch

    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def max_abs_err(got, want) -> int:
    import torch

    if not isinstance(got, (tuple, list)):
        got, want = [got], [want]
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs "
                                 f"{w.shape} {w.dtype}")
        if not torch.equal(g, w):
            d = (g.to(torch.float64) - w.to(torch.float64)).abs().max()
            err = max(err, int(d.item()) or 1)
    return err


def require_equal(name: str, got, want) -> int:
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{name}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


# Plain references that `precompute_plain` computed on the card while nvcc
# built the kernels (which they do not need): key -> (inputs, value, ms);
# the keys whose stored value a check took, its time taken beside nvcc
PLAIN = {}
PLAIN_OVERLAPPED = set()


def _flat(xs):
    for x in xs:
        if isinstance(x, (tuple, list)):
            yield from _flat(x)
        else:
            yield x


def plain_ref(key, fn, *inputs):
    """(fn(), its ms): the value `precompute_plain` stored under `key` if
    its inputs equal `inputs`, else fn() timed now on the card."""
    import torch

    ref = PLAIN.pop(key, None)
    if ref is not None:
        a, b = list(_flat(ref[0])), list(_flat(inputs))
        if len(a) == len(b) and all(x.shape == y.shape and torch.equal(x, y)
                                    for x, y in zip(a, b)):
            PLAIN_OVERLAPPED.add(key)
            return ref[1], ref[2]
        print(f"plain reference {key}: inputs differ, computed again")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def plain_note(key) -> dict:
    """The record's `plain_note` where its plain time is the one that
    `precompute_plain` took while nvcc ran (host cores shared)."""
    if key in PLAIN_OVERLAPPED:
        return {"plain_note": "timed while nvcc built the kernels"}
    return {}


def bound(messages: int, nbytes: int, int32_ops_per_s: float):
    """(ms, "operations" or "bytes"): the larger of `messages` 64-byte
    SHA-256 messages at the int32 rate and `nbytes` at the memory rate."""
    ops_ms = messages * ops_per_message() / int32_ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def read_launches(label: str) -> dict:
    """The launch counts since the last reset, printed; the nonzero ones."""
    from consensus_specs_tpu_torch import _build

    counts = {k: v for k, v in _build.launches.items() if v}
    print(f"{label} launches: {json.dumps(counts)}")
    return counts


# device operations per call of the last `profile_device_ms`, by name
PROFILE_COUNTS = {}


def profile_device_ms(fn, reps: int):
    """Device time per call of every kernel, memcpy and memset that `fn`
    runs, from torch.profiler (CUPTI): {name: ms per call}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    per = {}
    PROFILE_COUNTS.clear()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:80] if name[:1] != "(" else name[:80]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us()
            PROFILE_COUNTS[name] = PROFILE_COUNTS.get(name, 0) + 1 / reps
    return {k: v / reps / 1e3 for k, v in
            sorted(per.items(), key=lambda kv: -kv[1])}


def try_profile(label: str, fn, reps: int):
    """`profile_device_ms(fn, reps)`, or None where the profiler itself
    fails (no CUPTI), printed under `label`.  A failure of `fn`, or of
    the kernels it launches, is raised."""
    import torch

    failed = []

    def call():
        try:
            fn()
            torch.cuda.synchronize()
        except BaseException as exc:
            failed.append(exc)
            raise

    try:
        return profile_device_ms(call, reps)
    except Exception as exc:
        if failed:
            raise failed[0]
        print(f"{label}: not measured ({type(exc).__name__}: {exc})")
        return None


def profiler_sees(name: str, fn) -> None:
    """Print what torch.profiler records on the device for one call of
    `fn`."""
    label = f"torch.profiler, one {name} call"
    per = try_profile(label, fn, 1)
    if per is not None:
        print(f"{label}: " + (json.dumps({k: round(v, 6) for k, v in
                                         per.items()}) if per
                              else "no device activity recorded"))


def forest_messages(idx, capacity: int) -> int:
    """Messages a forest update hashes at least: the distinct dirty
    parents on each sparse level, every node of the dense tail."""
    import torch

    depth, rung, total = capacity.bit_length() - 1, idx.shape[0], 0
    for lvl in range(depth):
        size = 1 << (depth - lvl - 1)
        parents = idx[idx < capacity] >> (lvl + 1)
        total += size if size <= rung else int(torch.unique(parents).numel())
    return total


class IncrementalInputs:
    """The inputs of `bench.py` worker_epoch's step: the registry, bench's
    leaf words and 1% dirty set (`convert.incremental_step_inputs`), its
    scalars, and the padded dirty chunk and validator indices."""

    def __init__(self, n, reg, dev):
        import torch

        from consensus_specs_tpu_torch import convert as C
        from consensus_specs_tpu_torch.parallel import EpochScalars
        from consensus_specs_tpu_torch.parallel import incremental as I

        self.n, self.reg, self.dev = n, reg, dev
        pk, cred, self.dirty = C.incremental_step_inputs(n)
        self.leaves = C.leaves_to_torch(pk, cred, dev)
        self.sc = EpochScalars(*INCR_SCALARS)
        self.chunk_idx = I.pad_dirty_idx(
            I.dirty_chunks_from_validators(self.dirty), n // 4).to(dev)
        self.validator_idx = I.pad_dirty_idx(self.dirty, n).to(dev)
        self.live_chunks = int((self.chunk_idx < n // 4).sum())
        self.depths = ((n // 4).bit_length() - 1, n.bit_length() - 1)
        self.proof_idx = torch.from_numpy(np.random.RandomState(SEED).choice(
            n // 4, N_PROOFS, replace=False)).to(dev)
        print(f"incremental inputs: {len(self.dirty)} dirty validators, "
              f"{self.live_chunks} dirty balance chunks, rungs "
              f"{self.chunk_idx.shape[0]} and {self.validator_idx.shape[0]}; "
              f"messages one step must hash: balances forest "
              f"{forest_messages(self.chunk_idx, n // 4)}, registry forest "
              f"{forest_messages(self.validator_idx, n)}, records gather "
              f"{7 * self.validator_idx.shape[0]}")

    def record_args(self, effective_balance):
        r = self.reg
        return (self.leaves, effective_balance, r.slashed,
                r.activation_eligibility_epoch, r.activation_epoch,
                r.exit_epoch, r.withdrawable_epoch)


def check_incremental_kernels(inp, new_bal, new_eff, record_roots, kernels,
                              record, int32_ops_per_s):
    """K4, K5, K6 and K3's gather mode against their plain versions at the
    incremental path's shapes (rung 16384 at depths 18 and 20), with the
    edge batches; each timed beside its plain version and its bound.  K4
    also on both forests in one launch, on duplicates, unsorted indices,
    an all-dirty forest, depths 0 and 1, and two forests against two
    launches."""
    import torch

    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch.parallel import incremental as I
    from consensus_specs_tpu_torch.parallel import merkle as M

    dev, n = inp.dev, inp.n
    rng = np.random.RandomState(SEED + 11)

    def rand_words(m):
        return C.from_numpy_u32(rng.randint(0, 2**32, (m, 8), dtype=np.uint64)
                                .astype(np.uint32), dev)

    # -- K4: each forest's whole dirty-path update, and both in one launch -
    def equal_dups(words, idx):
        """Duplicate indices carry equal words (the update's contract)."""
        first = {}
        for k, v in enumerate(idx.tolist()):
            words[k] = words[first.setdefault(v, k)]
        return words

    db, dr = inp.depths            # 18 and 20 at 2**20 validators
    forests, plains, err4 = {}, {}, 0
    bal_chunks = I.gather_balance_chunks(new_bal, torch.arange(n // 4,
                                                               device=dev))
    for d, leaves_d, idx in ((db, bal_chunks, inp.chunk_idx),
                             (dr, record_roots, inp.validator_idx)):
        got = I.build_layers(leaves_d, d)
        want = I.build_layers(leaves_d, d, plain=True)
        require_equal(f"forest build d={d}", list(got), list(want))
        words = rand_words(idx.shape[0])
        I.update_dirty(got, idx, words, d)
        I.update_dirty(want, idx, words, d, plain=True)
        err4 = max(err4, require_equal(
            f"update_dirty d={d} rung={idx.shape[0]}", list(got), list(want)))
        forests[d], plains[d] = got, want
    # both forests in one launch, on new words: the plain updates' layers
    both = [(forests[db], inp.chunk_idx, rand_words(inp.chunk_idx.shape[0]),
             db), (forests[dr], inp.validator_idx,
                   rand_words(inp.validator_idx.shape[0]), dr)]
    I.update_forests(both)
    for lay, idx, words, d in both:
        I.update_dirty(plains[d], idx, words, d, plain=True)
    err4 = max(err4, require_equal(
        "update_forests (both forests)", list(forests[db]) + list(forests[dr]),
        list(plains[db]) + list(plains[dr])))
    edge_sets = {"sibling pairs": [0, 1, 2, 3, 6, 7, n // 2, n // 2 + 1,
                                   n - 2, n - 1],
                 "all sentinels": [],
                 "duplicates": [5, 5, 5, 9, n - 1, n - 1],
                 "unsorted": [n - 1, 3, n // 2, 0, 77, 3]}
    for label, dirty in edge_sets.items():
        idx = I.pad_dirty_idx(torch.tensor(dirty, dtype=torch.int64),
                              n).to(dev)
        words = equal_dups(rand_words(idx.shape[0]), idx)
        want = [lay.clone() for lay in forests[dr]]
        I.update_dirty(forests[dr], idx, words, dr)
        I.update_dirty(want, idx, words, dr, plain=True)
        err4 = max(err4, require_equal(f"update_dirty ({label})",
                                       list(forests[dr]), want))
    # small forests: every leaf dirty at depth 10 (all levels dense),
    # depths 0 and 1; then a two-forest launch against two one-forest ones
    small = {}
    for label, d, dirty in (("all dirty d=10", 10, list(range(1024))),
                            ("d=0", 0, [0]), ("d=1", 1, [1, 1]),
                            ("d=1 both leaves", 1, [0, 1]),
                            ("d=12 rung 1024", 12, list(range(7, 4096, 13)))):
        idx = I.pad_dirty_idx(torch.tensor(dirty, dtype=torch.int64),
                              1 << d).to(dev)
        words = equal_dups(rand_words(idx.shape[0]), idx)
        got = I.build_layers(rand_words(1 << d), d)
        want = [lay.clone() for lay in got]
        small[label] = ([lay.clone() for lay in got], idx, words, d)
        I.update_dirty(got, idx, words, d)
        I.update_dirty(want, idx, words, d, plain=True)
        err4 = max(err4, require_equal(f"update_dirty ({label})", list(got),
                                       want))
    pair = [small["all dirty d=10"], small["d=12 rung 1024"]]
    singles = [([lay.clone() for lay in lay_], idx, w, d)
               for lay_, idx, w, d in pair]
    I.update_forests(pair)
    for st in singles:
        I.update_dirty(*st)
    err4 = max(err4, require_equal(
        "update_forests (two forests against two launches)",
        [t for st in pair for t in st[0]],
        [t for st in singles for t in st[0]]))

    cidx, vidx = inp.chunk_idx, inp.validator_idx
    msgs = {db: forest_messages(cidx, 1 << db),
            dr: forest_messages(vidx, 1 << dr)}
    live = {db: inp.live_chunks, dr: len(inp.dirty)}

    def k4_bytes(d, idx):
        """Each message's 64 bytes read and 32 written, the indices and
        leaf words read, the live leaves written."""
        return msgs[d] * 96 + idx.numel() * 40 + live[d] * 32

    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    clock_hz = int32_ops_per_s / (n_sm * INT32_LANES_PER_SM)
    plan = I.forest_plan([db, dr], [cidx.numel(), vidx.numel()],
                         I._co_resident(dev.index or 0))
    fb, fr = forests[db], forests[dr]
    bw, rw = both[0][2], both[1][2]
    pb, pr = plains[db], plains[dr]
    record("update_level", "consensus_specs_tpu_torch/csrc/incremental.cu",
           "consensus_specs_tpu/parallel/incremental.py:122", err4,
           device_ms(lambda: I.update_forests(both), 50),
           # one timed call: the plain update of both forests is 2.5 s
           cuda_ms(lambda: (I.update_dirty(pb, cidx, bw, db, plain=True),
                            I.update_dirty(pr, vidx, rw, dr, plain=True)), 1),
           *bound(msgs[db] + msgs[dr], k4_bytes(db, cidx) + k4_bytes(dr, vidx),
                  int32_ops_per_s),
           shape=f"both forests of the incremental step in one launch: "
           f"depths {db} and {dr}, rungs {cidx.numel()} and {vidx.numel()}, "
           f"{msgs[db]} and {msgs[dr]} messages; plan {tuple(plan)}",
           # one message a level, one instruction a cycle: the levels'
           # dependent chain
           chain_floor_ms=max(db, dr) * sum(
               sha_message_mix()[k] for k in ("alu", "fma", "either"))
           / clock_hz * 1e3,
           balances_ms=device_ms(lambda: I.update_dirty(fb, cidx, bw, db), 50),
           registry_ms=device_ms(lambda: I.update_dirty(fr, vidx, rw, dr), 50),
           balances_bound_ms=bound(msgs[db], k4_bytes(db, cidx),
                                   int32_ops_per_s)[0],
           registry_bound_ms=bound(msgs[dr], k4_bytes(dr, vidx),
                                   int32_ops_per_s)[0])

    # -- K5: dirty chunks at rung 16384, chunks past N, a ragged list -----
    cidx = inp.chunk_idx
    err5 = require_equal("balance_chunks",
                         I.gather_balance_chunks(new_bal, cidx),
                         I.gather_balance_chunks(new_bal, cidx, plain=True))
    past = torch.tensor([0, n // 4 - 1, n // 4, n // 4 + 7, 1 << 40, -1],
                        dtype=torch.int64, device=dev)
    ragged = new_bal[:n - 3]
    got = I.gather_balance_chunks(ragged, past)
    err5 = max(err5, require_equal(
        "balance_chunks(past N)", got,
        I.gather_balance_chunks(ragged, past, plain=True)))
    if got[2:].any() or not got[1, :2].any() or got[1, 2:].any():
        raise AssertionError("balance_chunks: values past N are not zero")
    k5_bound, k5_by = bound(0, cidx.numel() * 40 + inp.live_chunks * 32,
                            int32_ops_per_s)
    record("balance_chunks", "consensus_specs_tpu_torch/csrc/incremental.cu",
           "consensus_specs_tpu/parallel/incremental.py:755", err5,
           device_ms(lambda: I.gather_balance_chunks(new_bal, cidx), 50),
           cuda_ms(lambda: I.gather_balance_chunks(new_bal, cidx,
                                                   plain=True), 5),
           k5_bound, k5_by, shape=f"rung {cidx.numel()}, "
           f"{inp.live_chunks} live chunks of 2**20 balances")

    # -- K6: 1024 proof paths at depths 18 and 20, and depth 0 ------------
    pidx = inp.proof_idx
    odd = torch.tensor([0, 1, n - 1, n, 1 << 40, -1], dtype=torch.int64,
                       device=dev)
    one = I.build_layers(rand_words(1), 0)
    err6 = 0
    for label, layers, d, idx in ((f"d={db}", forests[db], db, pidx),
                                  (f"d={dr}", forests[dr], dr, pidx),
                                  (f"d={dr} odd", forests[dr], dr, odd),
                                  ("d=0", one, 0, odd)):
        got = I.gather_proof_paths(layers, idx, d)
        if got[1].shape != (idx.numel(), d, 8):
            raise AssertionError(f"proof_paths {label}: shape "
                                 f"{tuple(got[1].shape)}")
        err6 = max(err6, require_equal(
            f"proof_paths {label}", list(got),
            list(I.gather_proof_paths(layers, idx, d, plain=True))))
    fb = forests[db]
    record("proof_paths", "consensus_specs_tpu_torch/csrc/incremental.cu",
           "consensus_specs_tpu/parallel/incremental.py:196", err6,
           device_ms(lambda: I.gather_proof_paths(fb, pidx, db), 50),
           cuda_ms(lambda: I.gather_proof_paths(fb, pidx, db, plain=True),
                   5),
           *bound(0, pidx.numel() * (8 + (db + 1) * 64), int32_ops_per_s),
           shape=f"{pidx.numel()} paths of the depth-{db} balances forest")

    # -- K3 in gather mode: the dirty record roots at rung 16384, and the
    # block tree's edges: one record, a block and one past it, repeated
    # indices, indices past N (clamped) and pad rows (length < M) ---------
    args = inp.record_args(new_eff)
    err3 = require_equal(
        "records_root gather", M.validator_records_root_kernel(
            *args, index=vidx),
        M.validator_records_root_plain(*args, index=vidx))
    err3 = max(err3, require_equal(
        "records_root gather(odd)",
        M.validator_records_root_kernel(*args, index=odd),
        M.validator_records_root_plain(*args, index=odd)))
    for m, length in ((1, None), (5, None), (32, None), (33, None),
                      (128, None), (129, None), (200, None), (200, 150),
                      (33, 31)):
        idx = rng.randint(0, n, m)
        idx[::7] = idx[0]
        idx[1::11] = n + 5
        idx[m - 1:] = -1
        idx = torch.from_numpy(idx).to(dev)
        err3 = max(err3, require_equal(
            f"records_root gather(M={m}, length={length})",
            M.validator_records_root_kernel(*args, length=length, index=idx),
            M.validator_records_root_plain(*args, length=length, index=idx)))
    m = vidx.numel()
    gather = (lambda: M.validator_records_root_kernel(*args, index=vidx))
    # cold: a 64 MB write ahead of each call evicts the fields from L2, as
    # K1's sweep does in the step
    scrub = torch.empty(2**26, dtype=torch.uint8, device=dev)
    cold_ms = device_ms(gather, 20, setup=scrub.zero_)
    del scrub
    record("records_root_gather",
           "consensus_specs_tpu_torch/csrc/records_root.cu",
           "bench.py:260", err3, device_ms(gather, 50),
           cuda_ms(lambda: M.validator_records_root_plain(*args, index=vidx),
                   3),
           *bound(7 * m, m * (8 + 105 + 32), int32_ops_per_s),
           cold_ms=cold_ms, shape=f"rung {m} of 2**20 validators")


def incremental_path(inp, params):
    """The incremental step at 2**20 validators through
    `IncrementalEpochStep`, checked against the full rebuild and the
    plain step, timed; then the proof phase.  Returns the launch counts
    of one step and of the proof phase."""
    import torch

    from consensus_specs_tpu_torch import IncrementalEpochStep
    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch.parallel import epoch as E
    from consensus_specs_tpu_torch.parallel import incremental as I
    from consensus_specs_tpu_torch.parallel import merkle as M

    dev, n, reg = inp.dev, inp.n, inp.reg
    args = (params, reg, inp.sc, inp.leaves, inp.dirty)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = IncrementalEpochStep(*args, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    plain = IncrementalEpochStep(*args, device=dev, plain=True)

    def layers(s):
        return (list(s.balances_forest.layers)
                + list(s.registry_forest.layers))

    require_equal("forest builds", layers(step), layers(plain))
    _build.reset_launches()
    out = step()
    torch.cuda.synchronize()
    counts = read_launches("incremental step")
    print(f"incremental step: {sum(counts.values())} counted launches "
          f"({', '.join(f'{k} {v}' for k, v in counts.items())})")
    # K2 is not on the step: K4 re-hashes the dense tail too
    for name in ("epoch_sweep", "update_level", "balance_chunks",
                 "records_root_gather"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"the incremental step never launched "
                                 f"{name}")
    want = plain()
    require_equal("incremental step", list(out), list(want))
    require_equal("forest layers after a step", layers(step), layers(plain))
    bal, eff, bal_root, reg_root = out
    # bench.py parity_check: the roots of the full rebuild of slice 1
    full_bal = M.balances_list_root(bal, n).cpu()
    full_reg = M.validator_registry_root(
        M.validator_records_root(*inp.record_args(eff)), n).cpu()
    if not (torch.equal(bal_root, full_bal) and
            torch.equal(reg_root, full_reg)):
        raise AssertionError("incremental roots differ from the full "
                             "rebuild")
    print("incremental balances_root: "
          + step.balances_forest.root_bytes().hex())
    print("incremental registry_root: "
          + step.registry_forest.root_bytes().hex())
    print("incremental roots equal the full rebuild and the plain step")

    step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(9):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    plain_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        plain()
        torch.cuda.synchronize()
        plain_walls.append((time.perf_counter() - t0) * 1e3)
    bal_leaves = I.dirty_balance_leaves(bal, inp.chunk_idx)
    rec = M.validator_records_root(*inp.record_args(eff),
                                   index=inp.validator_idx)

    def masked_sweep():
        b, e = E.epoch_sweep(reg, inp.sc, params)
        return (torch.where(step.mask, b, reg.balance),
                torch.where(step.mask, e, reg.effective_balance))

    parts = {
        "masked_sweep_K1": cuda_ms(masked_sweep, 20),
        "balance_chunks_K5": cuda_ms(
            lambda: I.dirty_balance_leaves(bal, inp.chunk_idx), 20),
        "records_gather_K3": cuda_ms(
            lambda: M.validator_records_root(*inp.record_args(eff),
                                             index=inp.validator_idx), 20),
        "balances_update_K4": cuda_ms(
            lambda: step.balances_forest.update(inp.chunk_idx, bal_leaves),
            20),
        "registry_update_K4": cuda_ms(
            lambda: step.registry_forest.update(inp.validator_idx, rec), 20),
        "both_updates_K4": cuda_ms(
            lambda: I.update_many([
                (step.balances_forest, inp.chunk_idx, bal_leaves),
                (step.registry_forest, inp.validator_idx, rec)]), 20),
    }
    t0 = time.perf_counter()
    for _ in range(20):
        I.roots_bytes((step.balances_forest, step.registry_forest))
    parts["roots_host_tail_host_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    print(f"incremental step: n={n} dirty={len(inp.dirty)} "
          f"median_ms={statistics.median(walls):.4f} "
          f"min_ms={min(walls):.4f} max_ms={max(walls):.4f} "
          f"plain_median_ms={statistics.median(plain_walls):.4f} "
          f"peak_mem_bytes={peak} forest_build_ms={build_ms:.4f}")
    print("incremental stages (device ms, CUDA events; roots: host ms): "
          + json.dumps({k: round(v, 6) for k, v in parts.items()}))
    per = try_profile("incremental step device ms by kernel", step, 3) or {}
    if per:
        busy = sum(per.values())
        print("incremental step device ms per step by kernel "
              "(torch.profiler): " + json.dumps(
                  {k: round(v, 6) for k, v in per.items()}))
        print(f"incremental step device busy ms={busy:.6f} "
              f"(share of the median step: "
              f"{busy / statistics.median(walls):.4f}); K4 per step ms="
              f"{per.get('forest_update_kernel', 0.0):.6f}; device "
              f"operations per step: {round(sum(PROFILE_COUNTS.values()))} "
              + json.dumps({k: round(v, 3)
                            for k, v in PROFILE_COUNTS.items()}))

    # -- proofs from the balances forest ----------------------------------
    indices = inp.proof_idx.tolist()
    _build.reset_launches()
    t0 = time.perf_counter()
    proofs = I.emit_proofs(step.balances_forest, indices)
    proof_ms = (time.perf_counter() - t0) * 1e3
    proof_counts = read_launches("proofs")
    if proof_counts.get("proof_paths", 0) <= 0:
        raise AssertionError("emit_proofs never launched proof_paths")
    root = step.balances_forest.root_bytes()
    bad = [p.index for p in proofs if not I.verify_proof(p, root)]
    if len(proofs) != N_PROOFS or bad:
        raise AssertionError(f"proofs: {len(bad)} of {len(proofs)} fail")
    if proofs != I.emit_proofs(plain.balances_forest, indices):
        raise AssertionError("proofs differ from the plain forest's")
    print(f"proofs: {len(proofs)} of {N_PROOFS} verified against the "
          f"balances root (depth {proofs[0].depth}); emit_ms={proof_ms:.4f}")
    return counts, proof_counts, per


# --- slice 3: BLS --------------------------------------------------------------


@functools.lru_cache(maxsize=4)
def bls_tasks(n_tasks: int, keys_per_task: int, seed_base: int):
    """`bench_bls.py:67 _build_tasks`'s recipe, copied: statement t signs
    the 32-byte message seed_base + t with the aggregate secret key of
    its committee, sum_i (seed_base + t * keys + i + 1), so each is one
    scalar multiplication per side and identical in shape to a real
    aggregate.  Returns (agg_pk, msg, sig) oracle points and their wire
    bytes."""
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs
    from consensus_specs_tpu_torch.ops.bls.curve import g1, g2
    from consensus_specs_tpu_torch.ops.bls.hash_to_curve import (DST_G2,
                                                                 hash_to_g2)

    tasks, raw = [], []
    for t in range(n_tasks):
        msg = (seed_base + t).to_bytes(32, "little")
        h = hash_to_g2(msg, DST_G2)
        agg_sk = sum(seed_base + t * keys_per_task + i + 1
                     for i in range(keys_per_task))
        pk = g1.mul(cs.G1_GEN, agg_sk)
        sig = g2.mul(h, agg_sk)
        tasks.append((pk, msg, sig))
        raw.append((cs.g1_to_bytes(pk), msg, cs.g2_to_bytes(sig)))
    return tasks, raw


def bls_products(r_bits, n_live: int) -> dict:
    """Montgomery products each BLS kernel must do for this batch, from
    the algorithm and this run's data (the live lanes' scalar bits; the
    pad lanes and masked lanes need none).  K8 (r PK and r S by
    double-and-add from r's top set bit, then PK to affine): a doubling
    (dbl-2009-l, 2 products and 5 squares) 7 on G1, 16 on G2 (Fq2: a
    product 3, a square 2); an addition of the affine base (madd-2007-bl,
    7 products and 4 squares) 11 on G1, 29 on G2; an inversion by p - 2
    (380 squares and popcount - 1 products) and 4 products to affine;
    `rlc_scalar_mul_jax_formula` counts the JAX chain's work (every bit
    doubled, general additions of 16 and 43).  A Miller doubling step
    41 and addition step 73 per lane, an Fq12 product 54 and square 36;
    K10's chain (`final_exp_products`)."""
    from consensus_specs_tpu_torch.ops.bls.fields import BLS_X, Q

    inv = (Q - 2).bit_length() - 1 + bin(Q - 2).count("1") - 1
    live_bits = r_bits[:n_live]
    nbits = live_bits.shape[1]
    set_bits = live_bits.sum(axis=1)
    nonzero = set_bits > 0
    top = np.argmax(live_bits != 0, axis=1)   # MSB first
    dbls = int((nbits - 1 - top)[nonzero].sum())
    adds = int(set_bits[nonzero].sum() - nonzero.sum())
    k8 = dbls * (7 + 16) + adds * (11 + 29) + int(nonzero.sum()) * (inv + 4)
    k8_jax = (n_live * nbits * (7 + 16)
              + (int(set_bits.sum()) - n_live) * (16 + 43)
              + n_live * (inv + 4))
    x_bits = abs(BLS_X).bit_length() - 1
    x_adds = bin(abs(BLS_X)).count("1") - 1
    lanes = n_live + 1
    k9 = ((n_live - 1) * 43 + inv + 2 + 4 * 3 + 2
          + lanes * (x_bits * 41 + x_adds * 73)
          + (x_bits + x_adds) * (lanes - 1) * 54
          + x_bits * 36 + (x_bits + x_adds) * 54)
    return {"rlc_scalar_mul": k8, "rlc_scalar_mul_jax_formula": k8_jax,
            "rlc_miller_product": k9,
            "final_exp_is_one": final_exp_products()}


def final_exp_products() -> int:
    """Montgomery products of K10's chain (`csrc/bls_rlc.cu`): the Fq12
    inverse (24 Fq2 products of a0^2, a1^2, a0 / n, a1 / n, 12 of the
    Fq6 inverse, the norm's 2 squares and 2 products, the windowed
    inversion of p - 2), 9 dense Fq12 products (54), the Frobenius maps
    (6 Fq2 products per power), 5 powers by |x| from g on its top bit
    (a cyclotomic square 18 per lower bit, a product per set one) and
    the cyclotomic square of m."""
    from consensus_specs_tpu_torch.ops.bls.fields import BLS_X, Q
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    x_bits = abs(BLS_X).bit_length() - 1
    x_adds = bin(abs(BLS_X)).count("1") - 1
    inv = (24 + 12) * 3 + 4 + window_chain_products(
        K.window_digits(Q - 2, K.H2C_EXP_WINDOW))
    frob = (2 + 1 + 2) * 6 * 3
    pow_x = x_bits * 18 + x_adds * 54
    return inv + 9 * 54 + frob + 5 * pow_x + 18


def check_bls_field_kernels(dev, record, int32_ops_per_s):
    """K7 against the plain field and tower ops on BLS_FIELD_N random
    canonical elements (plus edge values: 0, 1, p - 1, p, inverses of
    0) and on signed-lazy limbs for `fq_canon`; every op of K7 and the
    Frobenius powers 1, 2, 6."""
    import random

    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    r = random.Random(SEED + 3)

    def rand(*shape):
        n = int(np.prod(shape))
        return torch.from_numpy(np.stack(
            [F.to_mont(r.randrange(Q)) for _ in range(n)]).reshape(
                shape + (33,))).to(dev)

    n = BLS_FIELD_N
    edge = torch.from_numpy(np.stack(
        [np.zeros(33, np.int32), F.ONE_MONT, F.int_to_limbs(1),
         F.to_mont(Q - 1), F.P_LIMBS])).to(dev)
    a1, b1 = torch.cat([rand(n), edge]), torch.cat([rand(n), edge.flip(0)])
    a2, b2 = rand(n, 2), rand(n, 2)
    a2[0] = 0
    a12, b12 = rand(n, 2, 3, 2), rand(n, 2, 3, 2)
    a12[0] = 0
    lazy = torch.from_numpy(np.random.RandomState(SEED).randint(
        -2**13, 2**13, (n, 33)).astype(np.int32)).to(dev)
    cases = [("fq_mul", a1, b1, 0), ("fq_add", a1, b1, 0),
             ("fq_sub", a1, b1, 0), ("fq_inv", a1, None, 0),
             ("fq_canon", lazy, None, 0), ("fq2_mul", a2, b2, 0),
             ("fq2_inv", a2, None, 0), ("fq12_mul", a12, b12, 0),
             ("fq12_sqr", a12, None, 0), ("fq12_inv", a12, None, 0),
             ("fq12_frobenius", a12, None, 1),
             ("fq12_frobenius", a12, None, 2),
             ("fq12_frobenius", a12, None, 6)]
    _build.reset_launches()
    err = 0
    for op, a, b, k in cases:
        err = max(err, require_equal(
            f"bls_field_ops {op}({k})", K.field_op(op, a, b, k),
            K.field_op(op, a, b, k, plain=True)))
    if not K.field_op("fq_inv", edge[:1])[0].eq(0).all():
        raise AssertionError("bls_field_ops: inv(0) is not 0")
    counts = read_launches("bls field checks")
    print(f"bls field checks: {len(cases)} ops on {n} elements each "
          f"(fq_mul, fq_add, fq_sub and fq_inv also on 0, 1, 1/R, p - 1, "
          f"p): equal")
    record("bls_field_ops", "consensus_specs_tpu_torch/csrc/bls_rlc.cu",
           "consensus_specs_tpu/ops/bls_batch/tower.py:224", err,
           device_ms(lambda: K.field_op("fq12_mul", a12, b12), 5),
           cuda_ms(lambda: K.field_op("fq12_mul", a12, b12, plain=True), 1),
           n * 54 * OPS_PER_MONT / int32_ops_per_s * 1e3, "operations",
           shape=f"fq12_mul over {n} elements (the op timed); not on the "
           "main path", replaces_also=[
               "consensus_specs_tpu/ops/bls_batch/fq.py:119",
               "consensus_specs_tpu/ops/bls_batch/tower.py:96",
               "consensus_specs_tpu/ops/bls_batch/tower.py:258",
               "consensus_specs_tpu/ops/bls_batch/tower.py:292"])
    return counts


def _canon_equal(name, got, plain):
    """A kernel output against the canonical plain one (flags as they
    are)."""
    import torch

    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    if plain.dtype == torch.bool:
        return require_equal(name, got, plain)
    return require_equal(name, got, F.fq_canon(plain))


def k8_edge_lanes(seed: int, dev):
    """K8's inputs for one batch of K8_EDGE_B lanes from seeded points:
    the scalars K8_EDGE_SCALARS on the first lanes, then 3 and 5 on the
    G1 point (0, 2) of order 3 (T = -Q meets the addition and gives
    infinity; T = Q takes its doubling branch), seeded 128-bit scalars on
    the rest; pad lanes (mask False) in the middle and at the end."""
    import random

    import torch

    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    r = random.Random(seed)
    n = K8_EDGE_B
    scalars = list(K8_EDGE_SCALARS) + [3, 5]
    o3 = len(scalars) - 2
    scalars += [r.getrandbits(128) for _ in range(n - len(scalars))]
    pk = [curve.g1.mul(curve.G1_GEN, r.randrange(1, 2**64))
          for _ in range(n)]
    sig = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64))
           for _ in range(n)]
    pk_x, pk_y = BC.g1_affine_to_limbs(pk)
    pk_x[o3:o3 + 2], pk_y[o3:o3 + 2] = F.to_mont(0), F.to_mont(2)
    sig_x, sig_y = BC.g2_affine_to_limbs(sig)
    mask = np.ones(n, bool)
    mask[[n // 2, n - 1]] = False
    arrays = (pk_x, pk_y, sig_x, sig_y, BC.scalars_to_bits(scalars, 128),
              mask)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def k8_against_plain(label, key, got, args) -> int:
    """K8's four outputs `got` on `args` against its plain version on the
    card (the reference `precompute_plain` stored under `key` where its
    inputs are equal); returns the max abs error."""
    from consensus_specs_tpu_torch.ops import bls_batch as B

    want, _ = plain_ref(key, lambda: B.rlc_scalar_mul_plain(*args), *args)
    return max(*(_canon_equal(f"{label} {name}", got[i], want[i])
                 for i, name in enumerate(("apx", "apy", "a_inf"))),
               *(_canon_equal(f"{label} r_sig[{i}]", got[3][i], want[3][i])
                 for i in range(3)))


def check_k8_edges(dev) -> int:
    """K8 on its edge batch (`k8_edge_lanes`) against its plain version
    on the card, every output; returns the max abs error."""
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    args = k8_edge_lanes(SEED + 50, dev)
    got = K.rlc_scalar_mul_kernel(*args)
    err = k8_against_plain("K8 edges", "k8_edge", got, args)
    o3 = len(K8_EDGE_SCALARS)
    if got[2][:o3 + 2].tolist() != [True] + [False] * (o3 - 1) + [True, False]:
        raise AssertionError(f"K8 edges: a_inf {got[2][:o3 + 2].tolist()}")
    print(f"K8 edge batch, B={K8_EDGE_B}: scalars "
          f"{[hex(v) for v in K8_EDGE_SCALARS]}, 3 and 5 on a point of "
          f"order 3, pad lanes at {K8_EDGE_B // 2} and {K8_EDGE_B - 1}: "
          f"equal to the plain version on the card")
    return err


@functools.lru_cache(maxsize=1)
def msm_probe():
    """`bench_bls.py:143`'s probe: points (3i + 2) G1, scalars 5^(i+1)
    mod r, for i < max(MSM_SIZES)."""
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs
    from consensus_specs_tpu_torch.ops.bls.curve import R, g1

    n = max(MSM_SIZES)
    return ([g1.mul(cs.G1_GEN, 3 * i + 2) for i in range(n)],
            [pow(5, i + 1, R) for i in range(n)])


def msm_calls(n: int, dev):
    """(name, algo, c, arrays, tensors, kernel call, plain call) of the
    MSM of the probe's first n points."""
    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    pts, ks = msm_probe()
    algo, c, arrays = B.msm_inputs(pts[:n], ks[:n])
    t = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    if algo == "pippenger":
        return ("msm_pippenger", algo, c, arrays, t,
                lambda: K.msm_pippenger_kernel(*t, c),
                lambda: B.msm_pippenger(*t, c, plain=True))
    return ("msm_double_add", algo, c, arrays, t,
            lambda: K.msm_double_add_kernel(*t),
            lambda: B.msm_double_add(*t, plain=True))


def k8_shard_inputs(n_tasks: int, dev):
    """K8's inputs on each of SHARD_D shards of config #2's first
    `n_tasks` statements, as the sharded batch splits them."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B

    tasks, _ = bls_tasks(n_tasks, BLS_COMMITTEE, BLS_SEED_BASE)
    per = B._bucket(-(-len(tasks) // SHARD_D))
    arrays, _ = B._prepare_rlc_inputs(tasks, random.Random(BLS_RNG_SEED),
                                      False, dev, lanes=SHARD_D * per)
    shards = []
    for sh in range(SHARD_D):
        t = [B._to(a[sh * per:(sh + 1) * per], dev) for a in arrays]
        shards.append((*t[:4], t[6], t[7]))
    return shards


def precompute_plain(dev) -> None:
    """Fill PLAIN with the BLS and MSM phases' slowest plain references,
    which need no kernel, on the card while nvcc builds the kernels: K8
    in one call (the plain version works lane by lane) on config #2's
    B = 128 lanes, K8's edge lanes, the sharded batch's shards and the
    sharded check's shards; K9 and K10 on its canonical outputs, K11 on
    the batch's message words, and the MSMs at MSM_SIZES.  Each check
    takes its reference only where its own inputs are equal
    (`plain_ref`)."""
    import random

    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    tasks, _ = bls_tasks(BLS_TASKS, BLS_COMMITTEE, BLS_SEED_BASE)
    arrays, _ = B._prepare_rlc_inputs(tasks, random.Random(BLS_RNG_SEED),
                                      False, dev)
    pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = (
        B._to(a, dev) for a in arrays)
    groups = {"k8": (pk_x, pk_y, sig_x, sig_y, r_bits, mask),
              "k8_edge": k8_edge_lanes(SEED + 50, dev)}
    for tag, n_tasks in (("shard", BLS_TASKS), ("check", SHARD_BLS_CHECK)):
        for sh, t in enumerate(k8_shard_inputs(n_tasks, dev)):
            groups[f"k8_{tag}{sh}"] = t
    p8, ms = timed(lambda: B.rlc_scalar_mul_plain(
        *(torch.cat(c) for c in zip(*groups.values()))))
    at = 0
    for key, t in groups.items():
        sl = slice(at, at + t[0].shape[0])
        at = sl.stop
        PLAIN[key] = (t, (p8[0][sl], p8[1][sl], p8[2][sl],
                          tuple(c[sl] for c in p8[3])), ms)
    n = BLS_TASKS
    k9_in = (F.fq_canon(p8[0][:n]), F.fq_canon(p8[1][:n]), p8[2][:n],
             tuple(F.fq_canon(c[:n]) for c in p8[3]), h_x, h_y,
             torch.ones_like(mask), mask)
    (f9, s9), ms = timed(lambda: B.rlc_miller_product(*k9_in, plain=True))
    PLAIN["k9"] = (k9_in, (f9, s9), ms)
    f = F.fq_canon(f9)
    PLAIN["k10"] = ((f,),) + timed(lambda: B.final_exp_is_one(f, plain=True))
    arrays, _ = B._prepare_rlc_inputs(tasks, random.Random(BLS_RNG_SEED),
                                      True, dev)
    words = B._to(arrays[4], dev)
    PLAIN["k11"] = ((words,),) + timed(
        lambda: B.hash_to_g2_affine(words, plain=True))
    for n in MSM_SIZES:
        *_, t, _, plain = msm_calls(n, dev)
        PLAIN[f"msm_{n}"] = (t,) + timed(plain)
    for key, val in msm_edge_inputs().items():
        if key[0] == "double_add":
            t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in val)
            PLAIN[f"msm_edge_{key[1]}"] = (t,) + timed(
                lambda: B.msm_double_add_plain(*t))


def bls_path(dev, record, int32_ops_per_s):
    """The RLC batch verify at B = 128 on config #2's statements: the
    main path through K8 -> K9 -> K10, each output held against the
    plain stage on the card, the facade, the rejections, the timings.
    Returns the launch counts of the batch and of the facade's batch."""
    import random

    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls as BLS
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs
    from consensus_specs_tpu_torch.ops.bls import curve as curve
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    t0 = time.perf_counter()
    tasks, raw = bls_tasks(BLS_TASKS, BLS_COMMITTEE, BLS_SEED_BASE)
    print(f"bls inputs: {len(tasks)} statements of {BLS_COMMITTEE}-key "
          f"aggregates (bench_bls config #2, seed base {BLS_SEED_BASE}), "
          f"built in {time.perf_counter() - t0:.3f} s")

    # -- the host-hash route: one batch through K8 -> K9 -> K10 -----------
    torch.cuda.synchronize()
    _build.reset_launches()
    trace = {}
    ok = B.batch_verify(tasks, rng=random.Random(BLS_RNG_SEED), device=dev,
                        device_h2c=False, trace=trace)
    torch.cuda.synchronize()
    counts = read_launches("bls batch (host hashing)")
    for name in ("rlc_scalar_mul", "rlc_miller_product", "final_exp_is_one"):
        if counts.get(name, 0) != 1:
            raise AssertionError(f"the BLS batch launched {name} "
                                 f"{counts.get(name, 0)} times, not once")
    if ok is not True:
        raise AssertionError("the valid config #2 batch was rejected")
    inputs = trace["inputs"]
    pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = inputs
    if tuple(pk_x.shape) != (BLS_TASKS, 33) or not bool(mask.all()):
        raise AssertionError(f"bls batch shape {tuple(pk_x.shape)}")
    h_ok = torch.ones_like(mask)

    # -- the device-hash route (slice 4, the default): K11 -> K8 -> K9 -> K10
    torch.cuda.synchronize()
    _build.reset_launches()
    h2c_trace = {}
    ok = B.batch_verify(tasks, rng=random.Random(BLS_RNG_SEED), device=dev,
                        trace=h2c_trace)
    torch.cuda.synchronize()
    h2c_counts = read_launches("bls batch (device hashing)")
    for name in ("hash_to_g2", "rlc_scalar_mul", "rlc_miller_product",
                 "final_exp_is_one"):
        if h2c_counts.get(name, 0) != 1:
            raise AssertionError(f"the device-hashed BLS batch launched "
                                 f"{name} {h2c_counts.get(name, 0)} times")
    if ok is not True:
        raise AssertionError("the valid device-hashed batch was rejected")
    words = h2c_trace["inputs"][4]
    if tuple(words.shape) != (BLS_TASKS, 8):
        raise AssertionError(f"message words {tuple(words.shape)}")
    # all 128 device hashes equal the oracle's (the host-hash arrays)
    err11 = max(require_equal("hash_to_g2 x vs the oracle",
                              h2c_trace["h_x"], h_x),
                require_equal("hash_to_g2 y vs the oracle",
                              h2c_trace["h_y"], h_y),
                require_equal("hash_to_g2 ok", h2c_trace["h_ok"], h_ok))
    for part in ("miller", "final_exp", "ok"):
        require_equal(f"device-hashed batch {part}", h2c_trace[part],
                      trace[part])
    print(f"bls device hashing: all {BLS_TASKS} K11 hashes equal the port "
          f"oracle's hash_to_g2; the batch's Miller product, final "
          f"exponentiation and verdict equal the host-hash route's")

    # -- each kernel's output against its plain stage on the card ---------
    plain_ms = {}
    p8, plain_ms["rlc_scalar_mul"] = plain_ref(
        "k8", lambda: B.rlc_scalar_mul(pk_x, pk_y, sig_x, sig_y, r_bits,
                                       mask, plain=True),
        pk_x, pk_y, sig_x, sig_y, r_bits, mask)
    err8 = max(_canon_equal("rlc_scalar_mul apx", trace["apx"], p8[0]),
               _canon_equal("rlc_scalar_mul apy", trace["apy"], p8[1]),
               _canon_equal("rlc_scalar_mul a_inf", trace["a_inf"], p8[2]),
               *(_canon_equal(f"rlc_scalar_mul r_sig[{i}]",
                              trace["r_sig"][i], p8[3][i])
                 for i in range(3)),
               check_k8_edges(dev))
    # the stored reference ran with other lanes beside nvcc: K8's plain
    # time is that of B = 128 alone, after the build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone = B.rlc_scalar_mul(pk_x, pk_y, sig_x, sig_y, r_bits, mask,
                             plain=True)
    torch.cuda.synchronize()
    plain_ms["rlc_scalar_mul"] = (time.perf_counter() - t0) * 1e3
    for i, pair in enumerate(zip(_flat(alone), _flat(p8))):
        require_equal(f"K8 plain at B={BLS_TASKS} alone [{i}]", *(
            x if x.dtype == torch.bool else F.fq_canon(x) for x in pair))
    k9_in = (trace["apx"], trace["apy"], trace["a_inf"], trace["r_sig"], h_x,
             h_y, h_ok, mask)
    (f9, s9), plain_ms["rlc_miller_product"] = plain_ref(
        "k9", lambda: B.rlc_miller_product(*k9_in, plain=True), *k9_in)
    err9 = max(_canon_equal("G2 sum x", trace["sum_sig"][0], s9[0]),
               _canon_equal("G2 sum y", trace["sum_sig"][1], s9[1]),
               _canon_equal("G2 sum inf", trace["sum_sig"][2], s9[2]),
               _canon_equal("Miller product", trace["miller"], f9))
    (fe, ok10), plain_ms["final_exp_is_one"] = plain_ref(
        "k10", lambda: B.final_exp_is_one(trace["miller"], plain=True),
        trace["miller"])
    err10 = max(_canon_equal("final exponentiation", trace["final_exp"], fe),
                _canon_equal("verdict", trace["ok"], ok10))
    print("bls kernels equal their plain stages on the card: r·PK affine "
          "and flags, the signature lanes, the G2 sum, the Miller product, "
          "the final exponentiation, the verdict; plain ms "
          + json.dumps({k: round(v, 3) for k, v in plain_ms.items()}))

    # -- the facade: the same statements recorded and settled -------------
    # the facade's default backend ("torch") settles on the card
    if BLS.backend_name() != "torch":
        raise AssertionError("the BLS facade does not default to the card")
    with BLS.deferred_batch_verification() as batch:
        for pk_b, msg, sig_b in raw:
            if not BLS.FastAggregateVerify([pk_b], msg, sig_b):
                raise AssertionError("a valid statement failed parsing")
    _build.reset_launches()
    settled = batch.verify(rng=random.Random(BLS_RNG_SEED))
    torch.cuda.synchronize()
    facade_counts = read_launches("bls deferred batch")
    if settled is not True or not all(h.result() for h in batch.handles):
        raise AssertionError("the DeferredBatch facade rejected the batch")
    print(f"bls DeferredBatch: {len(batch.tasks)} recorded statements "
          f"settled True in one batch")

    # -- rejections, through both routes ---------------------------------
    wrong = list(tasks)
    pk, msg, _ = wrong[7]
    wrong[7] = (pk, msg, curve.g2.mul(tasks[7][2], 2))
    one_sided = [tasks[0], (tasks[1][0], tasks[1][1], curve.g2.infinity())]
    oracle = all(cs._pairing_check(cs.fast_aggregate_pairs(t))
                 for t in one_sided)
    if oracle is not False:
        raise AssertionError("one-sided infinity: the oracle accepted")
    wrong_trace = {}
    for h2c in (False, True):
        if B.batch_verify(wrong, rng=random.Random(BLS_RNG_SEED + 1),
                          device=dev, device_h2c=h2c,
                          trace=None if h2c else wrong_trace) is not False:
            raise AssertionError(f"a batch with a wrong signature was "
                                 f"accepted (device_h2c={h2c})")
        _build.reset_launches()
        got = B.batch_verify(one_sided, rng=random.Random(BLS_RNG_SEED),
                             device=dev, device_h2c=h2c)
        if got is not oracle or not _build.launches["precomp_miller_product"]:
            raise AssertionError(f"one-sided infinity: {got} against the "
                                 f"host oracle's {oracle}, or not through "
                                 f"pairing_check_device")
    print("bls rejections, host and device hashing: a wrong signature at "
          "slot 7 rejected; one-sided infinity rejected through "
          "pairing_check_device (K12 -> K10), as the host oracle")

    # -- timings: both routes, in turns ------------------------------------
    def run(h2c):
        return B.batch_verify(tasks, rng=random.Random(BLS_RNG_SEED),
                              device=dev, device_h2c=h2c)

    run(True)
    run(False)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    walls = {True: [], False: []}
    preps = {True: [], False: []}
    for i in range(BLS_TIMED):
        for h2c in (True, False)[:1 + (i < BLS_TIMED_HOST)]:
            # host prep alone, then the whole entry point
            t0 = time.perf_counter()
            B._prepare_rlc_inputs(tasks, random.Random(BLS_RNG_SEED), h2c)
            preps[h2c].append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            if run(h2c) is not True:
                raise AssertionError("the timed batch was rejected")
            torch.cuda.synchronize()
            walls[h2c].append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) - base
    dev_ms = {
        "hash_to_g2": device_ms(lambda: K.hash_to_g2_kernel(words), 5),
        "rlc_scalar_mul": device_ms(lambda: K.rlc_scalar_mul_kernel(
            pk_x, pk_y, sig_x, sig_y, r_bits, mask), 5),
        "rlc_miller_product": device_ms(lambda: K.rlc_miller_product_kernel(
            trace["apx"], trace["apy"], trace["a_inf"], trace["r_sig"], h_x,
            h_y, h_ok, mask), 5),
        "final_exp_is_one": device_ms(
            lambda: K.final_exp_is_one_kernel(trace["miller"]), 5),
    }
    for h2c, label in ((True, "device hashing"), (False, "host hashing")):
        ks = [k for k in dev_ms if h2c or k != "hash_to_g2"]
        device_total = sum(dev_ms[k] for k in ks)
        wall = statistics.median(walls[h2c])
        prep = statistics.median(preps[h2c])
        print(f"bls batch ({label}): B={BLS_TASKS} median_ms={wall:.4f} "
              f"min_ms={min(walls[h2c]):.4f} max_ms={max(walls[h2c]):.4f} "
              f"host_prep_median_ms={prep:.4f} (min "
              f"{min(preps[h2c]):.4f} max {max(preps[h2c]):.4f}) "
              f"device_ms={device_total:.6f} (CUDA events: "
              + ", ".join(f"{k} {dev_ms[k]:.6f}" for k in ks)
              + f") device_share={device_total / wall:.4f} "
              f"launches_per_batch={len(ks)}")
        print(f"bls verifies per second ({label}): "
              f"{BLS_TASKS / wall * 1e3:.3f} (batch wall), "
              f"{BLS_TASKS / device_total * 1e3:.3f} (device time)")
    print(f"bls batches' peak device memory: {peak} bytes; plain K8-K10 "
          f"stages on the card {sum(plain_ms.values()):.3f} ms")

    # K11 against its plain version on the card, at B = 128
    p11, plain_ms["hash_to_g2"] = plain_ref(
        "k11", lambda: B.hash_to_g2_affine(words, plain=True), words)
    err11 = max(err11, *(_canon_equal(f"hash_to_g2[{i}]",
                                      (h2c_trace["h_x"], h2c_trace["h_y"],
                                       h2c_trace["h_ok"])[i], p11[i])
                         for i in range(3)))
    # K11 at B = 1 and B + 1 (the batch's messages, then the first once
    # more), row by row against those plain rows
    for idx in ([0], list(range(BLS_TASKS)) + [0]):
        got = K.hash_to_g2_kernel(words[idx].contiguous())
        err11 = max(err11, *(_canon_equal(
            f"hash_to_g2 B={len(idx)} [{i}]", got[i], p11[i][idx])
            for i in range(3)))
    print(f"bls K11 equals its plain version on the card at B={BLS_TASKS} "
          f"(plain {plain_ms['hash_to_g2']:.3f} ms), and row by row at "
          f"B=1 and B={BLS_TASKS + 1}")
    profiler_sees("hash_to_g2", lambda: K.hash_to_g2_kernel(words))
    msgs = [t[1] for t in tasks]
    products, sha_ops = h2c_work(msgs)
    record("hash_to_g2", "consensus_specs_tpu_torch/csrc/bls_h2c.cu",
           "consensus_specs_tpu/ops/bls_batch/h2c_jax.py:295", err11,
           dev_ms["hash_to_g2"], plain_ms["hash_to_g2"],
           (products * OPS_PER_MONT + sha_ops) / int32_ops_per_s * 1e3,
           "operations", montgomery_products=products,
           sha256_lane_clocks=sha_ops, **plain_note("k11"),
           shape=f"B={BLS_TASKS} 32-byte messages, {2 * BLS_TASKS} field "
           "elements mapped", replaces_also=[
               "consensus_specs_tpu/ops/bls_batch/h2c_jax.py:126",
               "consensus_specs_tpu/ops/bls_batch/h2c_jax.py:183",
               "consensus_specs_tpu/ops/bls_batch/h2c_jax.py:198",
               "consensus_specs_tpu/ops/bls_batch/h2c_jax.py:261",
               "consensus_specs_tpu/ops/bls_batch/curve_jax.py:168",
               "consensus_specs_tpu/ops/bls_batch/__init__.py:328"])

    products = bls_products(r_bits.cpu().numpy(), BLS_TASKS)
    sources = {"rlc_scalar_mul": "consensus_specs_tpu/ops/bls_batch/"
               "curve_jax.py:147",
               "rlc_miller_product": "consensus_specs_tpu/ops/bls_batch/"
               "pairing_jax.py:133",
               "final_exp_is_one": "consensus_specs_tpu/ops/bls_batch/"
               "pairing_jax.py:297"}
    jax_k8 = products.pop("rlc_scalar_mul_jax_formula")
    extra = {"rlc_scalar_mul": dict(
        jax_formula_products=jax_k8,
        jax_formula_bound_ms=jax_k8 * OPS_PER_MONT / int32_ops_per_s * 1e3),
        "rlc_miller_product": plain_note("k9"),
        "final_exp_is_one": plain_note("k10")}
    for name, err in (("rlc_scalar_mul", err8), ("rlc_miller_product", err9),
                      ("final_exp_is_one", err10)):
        record(name, "consensus_specs_tpu_torch/csrc/bls_rlc.cu",
               sources[name], err, dev_ms[name], plain_ms[name],
               products[name] * OPS_PER_MONT / int32_ops_per_s * 1e3,
               "operations", montgomery_products=products[name],
               shape=f"B={BLS_TASKS} statements, {BLS_TASKS + 1} pairing "
               "lanes", **extra[name])
    return counts, h2c_counts, facade_counts, wrong_trace["miller"]


# --- slice 4: device hashing, the precomputed-line check, the G1 MSM ---------

def _inv_products() -> int:
    """Montgomery products of one Fermat inversion as the kernels run it:
    a square per bit of p - 2's 384-bit word span, a product per set bit."""
    from consensus_specs_tpu_torch.ops.bls.fields import Q

    return 384 + bin(Q - 2).count("1")


def window_chain_products(digits) -> int:
    """Montgomery products of `bls_h2c.cu`'s fp_pow_window over these
    sliding-window digits: the table of 16 odd powers, a square per digit
    after the first nonzero one, a product per later nonzero digit."""
    k0 = next(i for i, d in enumerate(digits) if d)
    return 16 + (len(digits) - 1 - k0) + sum(1 for d in digits[k0 + 1:] if d)


def h2c_work(msgs):
    """(Montgomery products, SHA-256 lane-clocks) that hash_to_g2 needs
    for these messages, replaying K11's branches on the host (which
    x-candidate of the SVDW map is tried, which square-root candidates),
    each fixed chain counted the cheaper of two ways: binary
    square-and-multiply, or K11's windows (an exponent by sliding windows
    over 16 odd powers; a square root as t t^((p - 3) / 4), whose second
    factor is also +- the root's inverse; a norm that is not a square
    ends its candidate; the cofactor by signed windows over q .. 15q).
    expand_message_xmd once per message: b0's first block is the zero
    pad, whose compression from the IV is a constant; its second block
    holds the message (a compression with its schedule) and its third
    is template only (a constant schedule, folded); each of the 8 b_i
    is one block with its schedule and one template block, so 9
    `ops_per_message()`.  Then 3 products per 512-bit draw, the map's fixed
    part, 5 per g(x) and each square-root candidate, sgn0 twice; the
    cofactor clearing (the u0 + u1 addition, then H2 q) and the affine
    conversion.  Fq2: a product 3, a square 2; G2 doubling 16, addition
    43."""
    from consensus_specs_tpu_torch.ops.bls.curve import H2
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls.hash_to_curve import (
        DST_G2, _SVDW_G2, hash_to_field_fq2)
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    inv = min(_inv_products(), window_chain_products(
        K.window_digits(Q - 2, K.H2C_EXP_WINDOW)))
    # t^((p + 1) / 4): binary, or t t^((p - 3) / 4)
    pow14 = min(384 + bin((Q + 1) // 4).count("1"), 1 + window_chain_products(
        K.window_digits((Q - 3) // 4, K.H2C_EXP_WINDOW)))
    # a candidate root's 1 / (2c): an inversion, or (c s = +-1) one product
    inv_c = min(inv, 1)
    fp2_inv = 2 + inv + 2
    e14 = (Q + 1) // 4

    def is_root(r0, r1, x, y):
        return ((r0 * r0 - r1 * r1) % Q, 2 * r0 * r1 % Q) == (x, y)

    def sqrt_cost(a, last):
        """(products, is_square) of the kernel's fp2_sqrt on a."""
        x, y = a.c0 % Q, a.c1 % Q
        if y == 0:
            r = pow(x, e14, Q)
            if is_root(r, 0, x, y):
                return pow14 + 2, True
            return 2 * (pow14 + 2), is_root(0, pow(-x % Q, e14, Q), x, y)
        nrm = (x * x + y * y) % Q
        n = pow(nrm, e14, Q)
        cost = 2 + pow14
        if not last and n * n % Q != nrm:
            return cost + 1, False
        for t in ((x + n) % Q, (x - n) % Q):
            c = pow(t * pow(2, -1, Q) % Q, e14, Q)
            w = y * pow(2 * c, -1, Q) if c else 0
            cost += 1 + pow14 + inv_c + 1 + 2
            if is_root(c, w, x, y):
                return cost, True
        return cost, False

    h2_digits = K.signed_window_digits(H2, K.H2C_H2_WINDOW)
    cofactor = min((H2.bit_length() - 1) * 16
                   + (bin(H2).count("1") - 1) * 43,
                   16 + 7 * 43 + (len(h2_digits) - 1) * 16
                   + (sum(1 for d in h2_digits if d) - 1) * 43)
    sv = _SVDW_G2
    products = sha = 0
    for m in msgs:
        sha += 9 * ops_per_message()
        for u in hash_to_field_fq2(m, 2, DST_G2):
            products += 2 * 3 + 27 + fp2_inv + 4
            tv1 = u.square() * sv.c1
            tv2, tv1 = tv1 + sv.F.from_int(1), sv.F.from_int(1) - tv1
            tv3 = tv1 * tv2
            tv3 = tv3 if tv3.is_zero() else tv3.inv()
            tv4 = u * tv1 * (tv3 * sv.c3)
            t = (tv2.square() * tv3).square()
            for k, x in enumerate((sv.c2 - tv4, sv.c2 + tv4,
                                   t * sv.c4 + sv.Z)):
                cost, square = sqrt_cost(sv.g(x), k == 2)
                products += 5 + cost
                if square:
                    break
        products += 43 + cofactor
        products += fp2_inv + 2 + 9
    return products, sha


def precomp_products(n_live: int) -> int:
    """K12's Montgomery products for n_live live lanes: per Miller step a
    line per live lane (2 Fq2-by-Fp and 2 Fq2 products, 10), the product
    of the live lines (54 each), the fold (54) and on doubling steps the
    square (36)."""
    from consensus_specs_tpu_torch.ops.bls.fields import BLS_X

    x_bits = abs(BLS_X).bit_length() - 1
    x_adds = bin(abs(BLS_X)).count("1") - 1
    per_step = n_live * 10 + (n_live - 1) * 54 + 54
    return (x_bits + x_adds) * per_step + x_bits * 36


def pippenger_products(digits, c: int) -> int:
    """K13's Montgomery products for these digits (live lanes only): G1
    doubling 7 and addition 16, an addition with an empty bucket or an
    infinite running sum free, as the kernel's early returns make it."""
    add, dbl = 16, 7
    total = 0
    res_inf = True
    for w in range(digits.shape[1]):
        col = digits[:, w]
        occ = np.bincount(col[col > 0], minlength=1 << c)
        total += add * int(np.maximum(occ[1:] - 1, 0).sum())
        running = acc = False               # non-infinite yet?
        for k in range((1 << c) - 1, 0, -1):
            if occ[k]:
                total += add if running else 0
                running = True
            if running:
                total += add if acc else 0
                acc = True
        if not res_inf:
            total += c * dbl
        if acc:
            total += 0 if res_inf else add
            res_inf = False
    return total


def double_add_products(bits) -> int:
    """K14's Montgomery products for these live lanes' 255 scalar bits:
    255 doublings each, an addition per set bit after the first, then the
    tree's additions of the live lanes."""
    return (bits.shape[0] * bits.shape[1] * 7
            + (int(bits.sum()) - bits.shape[0]) * 16
            + (bits.shape[0] - 1) * 16)


def msm_window_groups(c: int) -> int:
    """K13's groups a window block (`bls_msm.cu` `window_groups`): a group
    a bucket, in whole warps of 8, at most 64."""
    return min(64, max(1, -(-((1 << c) - 1) // 8)) * 8)


def pippenger_chain_rounds(digits, c: int) -> int:
    """K13's chain in pass rounds for these digits (B, W) (a doubling 3,
    an addition 5, each one product deep): the longest window's bucket
    pass (a warp's groups step through their points together, 5 a step
    where one of them adds into a bucket that holds a point) and its
    suffix sum (5 a step where running or acc, a step behind, adds two
    finite points), then the combine (c doublings and an addition a
    window once the sum is finite)."""
    n_groups = msm_window_groups(c)
    nb = 1 << c
    worst = 0
    finite = []
    for w in range(digits.shape[1]):
        queues = [[] for _ in range(n_groups)]
        seen = set()
        for d in digits[:, w].tolist():
            if d:
                queues[(d - 1) % n_groups].append(d in seen)
                seen.add(d)
        bucket = 0
        for g0 in range(0, n_groups, 8):
            warp = queues[g0:g0 + 8]
            steps = max(len(q) for q in warp)
            bucket = max(bucket, sum(
                5 if any(s < len(q) and q[s] for q in warp) else 0
                for s in range(steps)))
        suffix, run, acc, prev = 0, False, False, False
        for s in range(nb):
            k = nb - 1 - s
            full = (k >= 1 and run and k in seen) or (s >= 1 and acc and prev)
            suffix += 5 if full else 0
            acc = acc or (s >= 1 and prev)
            prev = run = run or (k >= 1 and k in seen)
        worst = max(worst, bucket + suffix)
        finite.append(bool(seen))
    comb, res = 0, False
    for f in finite:
        comb += (3 * c if res else 0) + (5 if res and f else 0)
        res = res or f
    return worst + comb


def double_add_chain_rounds(bits, mask=None) -> int:
    """K14's chain in pass rounds for these lanes' bits (B, nbits): the
    longest warp's (8 lanes; after the first leading set bit among its
    live lanes, a doubling a bit and an addition where a lane past its
    leading bit has the bit set), then 5 a level of the tree."""
    live = np.ones(len(bits), bool) if mask is None else np.asarray(mask)
    worst = 0
    for w0 in range(0, len(bits), 8):
        rows = bits[w0:w0 + 8][live[w0:w0 + 8]]
        leads = [int(np.flatnonzero(r)[0]) for r in rows if r.any()]
        if not leads:
            continue
        rounds = 0
        for j in range(min(leads) + 1, bits.shape[1]):
            rounds += 3 + (5 if any(j > ld and row[j] for ld, row in
                                    zip(leads, rows[rows.any(1)]))
                           else 0)
        worst = max(worst, rounds)
    return worst + 5 * (len(bits).bit_length() - 1)


def sync_task():
    """BASELINE config #3, `bench_bls.py:67 _build_tasks(1, 512,
    seed_base=2000)`'s recipe (copied in `bls_tasks`), and the wire
    bytes of its 512 member keys and their aggregate signature."""
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs

    (task,), _ = bls_tasks(1, SYNC_COMMITTEE, SYNC_SEED_BASE)
    sks = [SYNC_SEED_BASE + i + 1 for i in range(SYNC_COMMITTEE)]
    pks = [cs.SkToPk(sk) for sk in sks]
    return task, pks, cs.Sign(sum(sks), task[1])


def pairing_check_path(dev, record, int32_ops_per_s):
    """Config #3: `pairing_check_device` on the 512-key statement's two
    pairs at bucket 8 through K12 -> K10 (the main path), K12 held
    against its plain version, cold and warm times; then the facade's
    eager `FastAggregateVerify` on the 512 wire keys, `Verify` and
    `AggregateVerify`, accept and reject, on the card."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls as BLS
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs
    from consensus_specs_tpu_torch.ops.bls.curve import g1, g2
    from consensus_specs_tpu_torch.ops.bls.hash_to_curve import (DST_G2,
                                                                 hash_to_g2)
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    t0 = time.perf_counter()
    (pk, msg, sig), pks, agg_sig = sync_task()
    pairs = [(pk, hash_to_g2(msg, DST_G2)), (g1.neg(cs.G1_GEN), sig)]
    print(f"bls config #3 inputs: one {SYNC_COMMITTEE}-key statement (seed "
          f"base {SYNC_SEED_BASE}) and its {SYNC_COMMITTEE} wire keys, built "
          f"in {time.perf_counter() - t0:.3f} s")

    # -- the main path: the cold call (the line precompute) ---------------
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ok = B.pairing_check_device(pairs, device=dev)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches("pairing check")
    for name in ("precomp_miller_product", "final_exp_is_one"):
        if counts.get(name, 0) != 1:
            raise AssertionError(f"pairing_check_device launched {name} "
                                 f"{counts.get(name, 0)} times, not once")
    if ok is not True:
        raise AssertionError("config #3's valid statement was rejected")
    bad = [pairs[0], (g1.neg(cs.G1_GEN), g2.mul(sig, 2))]
    if B.pairing_check_device(bad, device=dev) is not False:
        raise AssertionError("config #3 with a wrong signature was accepted")

    # -- K12 against its plain version; K10 gives the verdict --------------
    xp, yp, lines, mask = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                           for a in B.pairing_check_inputs(pairs))
    f12 = K.precomp_miller_product_kernel(xp, yp, lines, mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p12 = B.precomp_miller_product(xp, yp, lines, mask, plain=True)
    torch.cuda.synchronize()
    plain12 = (time.perf_counter() - t0) * 1e3
    err12 = _canon_equal("precomp_miller_product", f12, p12)
    if not bool(B.final_exp_is_one(f12)[1].item()):
        raise AssertionError("K10 rejected K12's product")

    warm = []
    for _ in range(BLS_TIMED):
        t0 = time.perf_counter()
        if B.pairing_check_device(pairs, device=dev) is not True:
            raise AssertionError("the timed pairing check was rejected")
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    k12_ms = device_ms(lambda: K.precomp_miller_product_kernel(
        xp, yp, lines, mask), 5)
    k10_ms = device_ms(lambda: K.final_exp_is_one_kernel(f12), 5)
    print(f"bls pairing check (config #3, bucket {xp.shape[0]}, 2 live "
          f"pairs): cold_ms={cold_ms:.4f} (line precompute and first call) "
          f"warm median_ms={statistics.median(warm):.4f} "
          f"min_ms={min(warm):.4f} max_ms={max(warm):.4f} device_ms="
          f"{k12_ms + k10_ms:.6f} (CUDA events: precomp_miller_product "
          f"{k12_ms:.6f}, final_exp_is_one {k10_ms:.6f}); K12 equals its "
          f"plain version (plain {plain12:.3f} ms); a wrong signature "
          f"rejected")
    profiler_sees("precomp_miller_product",
                  lambda: K.precomp_miller_product_kernel(xp, yp, lines, mask))
    products = precomp_products(2)
    record("precomp_miller_product",
           "consensus_specs_tpu_torch/csrc/bls_pairing.cu",
           "consensus_specs_tpu/ops/bls_batch/pairing_jax.py:234", err12,
           k12_ms, plain12, products * OPS_PER_MONT / int32_ops_per_s * 1e3,
           "operations", montgomery_products=products,
           shape=f"bucket {xp.shape[0]}, 2 live pairs (config #3)",
           replaces_also=[
               "consensus_specs_tpu/ops/bls_batch/__init__.py:221"])

    # -- the facade's eager calls on the card -------------------------------
    if BLS.backend_name() != "torch":
        raise AssertionError("the BLS facade does not default to the card")
    _build.reset_launches()
    t0 = time.perf_counter()
    if BLS.FastAggregateVerify(pks, msg, agg_sig) is not True:
        raise AssertionError("FastAggregateVerify rejected config #3")
    fav_ms = (time.perf_counter() - t0) * 1e3
    facade_counts = read_launches("facade FastAggregateVerify")
    if facade_counts.get("precomp_miller_product", 0) != 1:
        raise AssertionError("FastAggregateVerify did not run on the card")
    if BLS.FastAggregateVerify(pks, b"\x01" * 32, agg_sig) is not False:
        raise AssertionError("FastAggregateVerify accepted a wrong message")
    one_sig = cs.Sign(SYNC_SEED_BASE + 1, msg)
    two = [msg, b"\x02" * 32]
    two_sig = cs.Aggregate([one_sig, cs.Sign(SYNC_SEED_BASE + 2, two[1])])
    checks = [(BLS.Verify(pks[0], msg, one_sig), True),
              (BLS.Verify(pks[1], msg, one_sig), False),
              (BLS.AggregateVerify(pks[:2], two, two_sig), True),
              (BLS.AggregateVerify(pks[:2], two[::-1], two_sig), False)]
    if [got for got, _ in checks] != [want for _, want in checks]:
        raise AssertionError(f"facade eager calls: {checks}")
    print(f"bls facade on the card: FastAggregateVerify over "
          f"{SYNC_COMMITTEE} wire keys accepted (wall_ms={fav_ms:.4f}, "
          f"parsing and aggregation on the host) and a wrong message "
          f"rejected; Verify and AggregateVerify accept and reject")
    return counts, facade_counts


def check_pairing_edge_shapes(dev, rejected_f):
    """K12 and K10 at the shapes and values the paths give their group
    code beside the main path's (config #3's bucket 8 with 2 live lanes,
    config #2's f), each against its plain version on the card: K12 at
    PAIRING_EDGE (live lanes, bucket) from seeded pairs; K10 at f = 1,
    f = 0, a random Fq12 and the rejected config #2 batch's f (verdict
    false), their plain version in one batched call.  Returns the max
    abs errors (K12, K10)."""
    import random

    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.bls_batch import pairing as pj
    from consensus_specs_tpu_torch.ops.bls_batch import tower as tw

    t0 = time.perf_counter()
    err12 = 0
    for n_live, bucket in PAIRING_EDGE:
        r = random.Random(SEED + 50 + n_live)
        pairs = [(curve.g1.mul(curve.G1_GEN, r.randrange(1, 2**64)),
                  curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64)))
                 for _ in range(n_live)]
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in B.pairing_check_inputs(pairs)]
        if args[0].shape[0] != bucket:
            raise AssertionError(f"K12: {n_live} live pairs padded to "
                                 f"{args[0].shape[0]}, not {bucket}")
        err12 = max(err12, _canon_equal(
            f"K12 at bucket {bucket}, {n_live} live",
            K.precomp_miller_product_kernel(*args),
            B.precomp_miller_product(*args, plain=True)))
    r = random.Random(SEED + 49)
    rand = np.stack([F.to_mont(r.randrange(Q)) for _ in range(12)])
    fs = torch.stack([F.const(tw.FQ12_ONE_L, dev),
                      torch.zeros((2, 3, 2, 33), dtype=torch.int32,
                                  device=dev),
                      torch.from_numpy(rand.reshape(2, 3, 2, 33)).to(dev),
                      rejected_f])
    got = [K.final_exp_is_one_kernel(f.contiguous()) for f in fs]
    want = pj.final_exponentiate(fs)
    err10 = max(_canon_equal(f"K10 at f[{i}]", fe, w)
                for i, ((fe, _), w) in enumerate(zip(got, want)))
    verdicts = [bool(ok.item()) for _, ok in got]
    if verdicts != [True, False, False, False]:
        raise AssertionError(f"K10 verdicts at f = 1, 0, random, the "
                             f"rejected batch: {verdicts}")
    print(f"pairing edge shapes: K12 at (live lanes, bucket) "
          f"{list(PAIRING_EDGE)} and K10 at f = 1, 0, a random Fq12 and "
          f"the rejected config #2 batch's f (verdicts {verdicts}) equal "
          f"to their plain versions on the card "
          f"({time.perf_counter() - t0:.3f} s)")
    return err12, err10


def msm_path(dev, record, int32_ops_per_s):
    """`g1_multi_exp_device` on bench_bls's probe (`bench_bls.py:143`:
    points (3i + 2) G1, scalars 5^(i+1) mod r) at 16 (B = 32, c = 6,
    Pippenger: the facade's threshold), 512 (B = 512, c = 8, the top
    Pippenger rung) and 4096 points (double-and-add: Deneb's
    blob_to_kzg_commitment width).  Each call is a main path; each
    kernel is held against its plain version, and the results against
    the oracle's `g1.msm`; then `multi_exp`'s routing at 15 and 16."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls as BLS
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls.curve import g1

    t0 = time.perf_counter()
    pts, ks = msm_probe()
    print(f"msm inputs: {len(pts)} points built in "
          f"{time.perf_counter() - t0:.3f} s")
    path_counts, errs, times, notes = {}, {}, {}, {}
    n_thr, n_pip, n_da = MSM_SIZES
    for n in MSM_SIZES:
        p, k = pts[:n], ks[:n]
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        got = B.g1_multi_exp_device(p, k, device=dev)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = read_launches(f"msm n={n}")
        name, algo, c, arrays, t, kern, plain = msm_calls(n, dev)
        if counts.get(name, 0) != 1:
            raise AssertionError(f"msm n={n} launched {name} "
                                 f"{counts.get(name, 0)} times")
        path_counts[f"msm_{n}"] = counts
        out = kern()
        want, plain_ms = plain_ref(f"msm_{n}", plain, *t)
        err = max(_canon_equal(f"{name} n={n}[{i}]", out[i], want[i])
                  for i in range(3))
        t0 = time.perf_counter()
        oracle = g1.msm(p, k)
        oracle_s = time.perf_counter() - t0
        if not g1.eq_points(got, oracle):
            raise AssertionError(f"msm n={n} differs from the oracle's")
        kms = device_ms(kern, 5)
        if n != n_thr:
            profiler_sees(name, kern)
        if algo == "pippenger":
            live = arrays[2][:n]
            products = pippenger_products(live, c)
            rounds = pippenger_chain_rounds(arrays[2], c)
        else:
            products = double_add_products(arrays[2][:n])
            rounds = double_add_chain_rounds(arrays[2], arrays[3])
        print(f"msm n={n}: {algo} B={arrays[0].shape[0]}"
              + (f" c={c}" if c else "") + f" call_ms={wall:.4f} "
              f"kernel_ms={kms:.6f} plain_ms={plain_ms:.3f} "
              f"products={products} chain_rounds={rounds}; equals its "
              f"plain version and the oracle's g1.msm (host oracle "
              f"{oracle_s * 1e3:.1f} ms)")
        errs.setdefault(name, 0)
        errs[name] = max(errs[name], err)
        times[n] = (name, kms, plain_ms, products, arrays[0].shape[0], c,
                    rounds)
        notes[n] = plain_note(f"msm_{n}")

    # the chains' floor: their pass rounds times one product's latency
    lat_us = g1_product_latency_us(dev)
    print(f"msm chains: a pass round's product {lat_us:.4f} us; floors "
          + ", ".join(f"n={n} {t[6]} rounds {t[6] * lat_us / 1e3:.4f} ms"
                      for n, t in times.items()))

    for name, n, src in (("msm_pippenger", n_pip, "consensus_specs_tpu/ops/"
                          "bls_batch/curve_jax.py:188"),
                         ("msm_double_add", n_da, "consensus_specs_tpu/ops/"
                          "bls_batch/__init__.py:347")):
        _, kms, plain_ms, products, b, c, rounds = times[n]
        extra = dict(product_latency_us=lat_us, chain_rounds=rounds,
                     chain_floor_ms=rounds * lat_us / 1e3)
        if name == "msm_pippenger":
            _, k16, p16, prod16, b16, c16, r16 = times[n_thr]
            extra.update(threshold_ms=k16, threshold_plain_ms=p16,
                         threshold_bound_ms=prod16 * OPS_PER_MONT
                         / int32_ops_per_s * 1e3,
                         threshold_chain_floor_ms=r16 * lat_us / 1e3,
                         threshold_shape=f"n={n_thr}, B={b16}, c={c16}",
                         replaces_also=["consensus_specs_tpu/ops/bls_batch/"
                                        "__init__.py:367"])
        record(name, "consensus_specs_tpu_torch/csrc/bls_msm.cu", src,
               errs[name], kms, plain_ms,
               products * OPS_PER_MONT / int32_ops_per_s * 1e3, "operations",
               montgomery_products=products,
               shape=f"n={n} points, B={b}" + (f", c={c}" if c else ""),
               **notes[n], **extra)

    # -- the facade's multi_exp routes G1 batches of 16 or more -------------
    for n, routed in ((15, 0), (16, 1)):
        _build.reset_launches()
        got = BLS.multi_exp([(1, q) for q in pts[:n]], ks[:n])
        if _build.launches["msm_pippenger"] != routed:
            raise AssertionError(f"multi_exp at {n} points: "
                                 f"{_build.launches['msm_pippenger']} launches")
        if not g1.eq_points(got[1], g1.msm(pts[:n], ks[:n])):
            raise AssertionError(f"multi_exp at {n} points: wrong point")
    print("msm facade: multi_exp keeps 15 points on the host and sends 16 "
          "to the card")
    return path_counts


# --- slice 5: the scalar field, config #5, PeerDAS verify, compute_cells -----

def batch_inv_products(n: int) -> int:
    """Fr products that n inverses need: Montgomery's batch inversion, n - 1
    prefix products, one inversion and 2 (n - 1) products back."""
    return 3 * (n - 1) + FR_INV_PRODUCTS


def fr_bound(products: int, nbytes: int, int32_ops_per_s: float):
    """(ms, "operations" or "bytes"): the larger of `products` Fr
    Montgomery products at the int32 rate and `nbytes` at the memory
    rate."""
    ops_ms = products * OPS_PER_FR_MONT / int32_ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def kernel_device_ms(fn, wrappers) -> dict:
    """Run `fn` once with each kernel wrapper in `wrappers` ((module,
    attribute) pairs) wrapped in CUDA events, a sleep kernel queued ahead
    of each as in `device_ms`: {attribute: summed device ms of its
    launches in that run}."""
    import torch

    events = {name: [] for _, name in wrappers}
    saved = [(mod, name, getattr(mod, name)) for mod, name in wrappers]

    def timed(name, inner):
        def call(*args, **kw):
            torch.cuda._sleep(SLEEP_CYCLES)   # as device_ms: no host gap
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = inner(*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return call

    try:
        for mod, name, inner in saved:
            setattr(mod, name, timed(name, inner))
        fn()
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    torch.cuda.synchronize()
    return {name: sum(s.elapsed_time(e) for s, e in evs)
            for name, evs in events.items()}


def _bls_wrappers():
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    return [(FK, "barycentric_kernel"), (FK, "coset_interpolate_kernel"),
            (FK, "fft_kernel"), (K, "msm_pippenger_kernel"),
            (K, "msm_double_add_kernel"),
            (K, "precomp_miller_product_kernel"),
            (K, "final_exp_is_one_kernel")]


def check_fr_field_kernels(dev, record, int32_ops_per_s):
    """K15 against the plain Fr ops on FR_FIELD_N random canonical
    elements plus the edge values 0, 1, r - 1 (and on signed-lazy limbs
    for `canon`); inv(0) = 0 and every product against Python ints; the
    batch inverse at FR_BATCH_INV's sizes and zeros against its
    plain version and the ints' inverses; the Fr product's latency; the
    times of `inv` and of the recovery's batch inverse."""
    import random

    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    R = FB.R_MODULUS
    r = random.Random(SEED + 5)
    n = FR_FIELD_N
    edge = [0, 1, R - 1]
    xs = [r.randrange(R) for _ in range(n)] + edge
    ys = [r.randrange(R) for _ in range(n)] + edge[::-1]
    a = torch.from_numpy(FB.FR.to_mont_batch(xs)).to(dev)
    b = torch.from_numpy(FB.FR.to_mont_batch(ys)).to(dev)
    lazy = torch.from_numpy(np.random.RandomState(SEED + 5).randint(
        -2**13, 2**13, (n, 33)).astype(np.int32)).to(dev)
    cases = [("mul", a, b, 0), ("add", a, b, 0), ("sub", a, b, 0),
             ("inv", a, None, 0), ("pow", a, None, 4096),
             ("pow", a, None, R - 2), ("canon", lazy, None, 0)]
    _build.reset_launches()
    err = 0
    for op, x, y, e in cases:
        err = max(err, require_equal(
            f"fr_field_ops {op}({e})", FB.field_op(op, x, y, e),
            FB.field_op(op, x, y, e, plain=True)))
    if FB.from_limbs(FB.field_op("inv", a)[n:]) != [0, 1, R - 1]:
        raise AssertionError("fr_field_ops: inv of 0, 1, r - 1")
    if FB.from_limbs(FB.field_op("mul", a, b)) != [
            x * y % R for x, y in zip(xs, ys)]:
        raise AssertionError("fr_field_ops: products differ from ints")
    # the batch inverse (the recovery's, one launch) at its edges: one
    # element, two, runs of several elements, a zero element (every
    # output 0) (the plain tree takes seconds at 8192: timed)
    bi = {}
    for m, zero in FR_BATCH_INV:
        vals = [r.randrange(1, R) for _ in range(m)]
        if zero:
            vals[m // 3] = 0
        x = torch.from_numpy(FB.FR.to_mont_batch(vals)).to(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = FB.batch_inverse(x, plain=True)
        torch.cuda.synchronize()
        want = [0] * m if zero else [pow(v, R - 2, R) for v in vals]
        bi[(m, zero)] = (x, (time.perf_counter() - t0) * 1e3)
        got = FK.batch_inverse_kernel(x)
        err = max(err, require_equal(f"fr_batch_inverse n={m}"
                                     f"{' with a zero' if zero else ''}",
                                     got, plain))
        if FB.from_limbs(got) != want:
            raise AssertionError(f"fr_batch_inverse n={m}: not the inverses")
    counts = read_launches("fr field checks")
    print(f"fr field checks: {len(cases)} ops on {n} elements and 0, 1, "
          f"r - 1 each, the batch inverse at (n, zero) {FR_BATCH_INV}:"
          f" equal to the plain versions")
    lat_us = FR_PROBE["latency_us"] = fr_product_latency_us(dev)
    x, bi_plain = bi[(8192, False)]
    bi_ms = device_ms(lambda: FB.batch_inverse(x), 5)
    bi_bound, _ = fr_bound(batch_inv_products(8192), 2 * 8192 * 132,
                           int32_ops_per_s)
    inv1_ms = device_ms(lambda: FB.field_op("inv", a[:1]), 5)
    bi_chain = batch_inverse_chain_products(8192)
    print(f"fr product latency (one thread, a chain of {FR_CHAIN_PROBE}): "
          f"{lat_us:.4f} us; K15 inv of one element {inv1_ms:.6f} ms; batch "
          f"inverse n=8192 {bi_ms:.6f} ms (plain {bi_plain:.3f} ms, bound "
          f"{bi_bound:.6f} ms, chain floor {bi_chain} products + one "
          f"inversion: {bi_chain * lat_us / 1e3 + inv1_ms:.6f} ms)")
    products = batch_inv_products(n + 3)
    record("fr_field_ops", "consensus_specs_tpu_torch/csrc/fr_batch.cu",
           "consensus_specs_tpu/ops/fr_batch.py:48", err,
           device_ms(lambda: FB.field_op("inv", a), 5),
           cuda_ms(lambda: FB.field_op("inv", a, plain=True), 1),
           *fr_bound(products, 2 * (n + 3) * 132, int32_ops_per_s),
           montgomery_products=products,
           shape=f"inv over {n + 3} elements (the op timed); on the "
           "producer's path (FK20's scalars, mul) and the recovery's (the "
           "decode's products and its batch inverse)",
           product_latency_us=lat_us, inv_1_ms=inv1_ms,
           batch_inverse_ms=bi_ms, batch_inverse_plain_ms=bi_plain,
           batch_inverse_bound_ms=bi_bound,
           batch_inverse_chain_floor_ms=bi_chain * lat_us / 1e3 + inv1_ms,
           batch_inverse_shape="n=8192 (the recovery's), one launch",
           replaces_also=[
               "consensus_specs_tpu/ops/fr_batch.py:123",
               "consensus_specs_tpu/ops/fr_batch.py:146",
               "consensus_specs_tpu/ops/fr_batch.py:163",
               "consensus_specs_tpu/ops/fr_batch.py:182",
               "consensus_specs_tpu/das/recover.py:110"])
    return counts


# the Fr product latency, measured once by `check_fr_field_kernels`
FR_PROBE = {}


def fr_product_latency_us(dev) -> float:
    """The Fr product's latency on one thread, in us: FR_CHAIN_PROBE
    dependent products (`kernels.fr_product_chain`), less the empty
    chain's launch; the chain's value held against the host's a^(2^n)."""
    import torch

    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    a = torch.from_numpy(FB.FR.to_mont(7)).to(dev)
    got = FB.from_limbs(FK.fr_product_chain(a, FR_CHAIN_PROBE))
    if got != [pow(7, 2**FR_CHAIN_PROBE, FB.R_MODULUS)]:
        raise AssertionError("fr_product_chain: wrong value")
    full = device_ms(lambda: FK.fr_product_chain(a, FR_CHAIN_PROBE), 5)
    empty = device_ms(lambda: FK.fr_product_chain(a, 0), 5)
    return (full - empty) / FR_CHAIN_PROBE * 1e3


def batch_inverse_chain_products(n: int) -> int:
    """K15's batch inverse's chain in Fr products beside its one
    inversion, at one element a thread: the load (1 product for canonical
    limbs), a block's heap up and down (8 levels each at 256 threads),
    block 0's heap over the blocks up and down, the store (1)."""
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    blocks = min(256, -(-n // FK.INV_BLOCK))
    return (1 + 2 * (FK.INV_BLOCK.bit_length() - 1)
            + 2 * (blocks - 1).bit_length() + 1)


def k18_chain_products(n: int) -> int:
    """K18's chain in Fr products: the load (1 for canonical limbs), a
    product a stage, the scale and store (1)."""
    return 1 + (n.bit_length() - 1) + 1


def check_k18_shapes(dev) -> dict:
    """K18 against its plain version on the card at every shape of
    K18_SHAPES (seeded rows over the order-n roots of unity); the max abs
    error.  (Its CUDA launches a call are counted by
    `compare_kernels.py --group fr`.)"""
    import random

    import torch

    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    R = FB.R_MODULUS
    T = FK.FFT_TILE
    rng = random.Random(SEED + 18)
    err, shapes = 0, []
    for batch, n, inverse in K18_SHAPES:
        n = {"T": T, "2T": 2 * T}.get(n, n)
        g = pow(7, (R - 1) // n, R)
        roots = [pow(g, i, R) for i in range(n)]
        rows = [[rng.randrange(R) for _ in range(n)] for _ in range(batch)]
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in FB.fft_inputs(rows, roots, inverse))
        label = f"({batch}, {n}){' inverse' if inverse else ''}"
        err = max(err, require_equal(f"fr_fft {label}", FB.fft(*args),
                                     FB.FR.canon(FB.fft(*args, plain=True))))
        shapes.append(label)
    print(f"K18 at {', '.join(shapes)} (T = {T}): equal to the plain "
          f"version")
    return err


def check_k16_edges(dev, poly, roots) -> int:
    """K16 against its plain version on the card at its edges: z on the
    blob domain (`poly` over `roots`, W = 4096) and the zero polynomial
    there, both 0; then the coset width of `das.verify.evaluate_cells_at`
    (W = 64, shift h_k of cell 5): a random z and z on the coset, 0.
    Returns the max abs error and K16's device ms at W = 64, random z."""
    import random

    import torch

    from consensus_specs_tpu_torch.das import ciphersuite as DC
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    r = random.Random(SEED + 51)
    cell = 5
    coset, shift = list(DC.coset_points(cell)), DC.coset_shift(cell)
    cell_poly = [r.randrange(FB.R_MODULUS) for _ in coset]
    cases = (("z on the domain", poly, roots, roots[7], 1, True),
             ("zero polynomial", [0] * len(roots), roots,
              r.randrange(FB.R_MODULUS), 1, True),
             ("coset, random z", cell_poly, coset,
              r.randrange(FB.R_MODULUS), shift, False),
             ("coset, z on it", cell_poly, coset, coset[3], shift, True))
    err = 0
    for label, p, dom, z, h, zero in cases:
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in FB.barycentric_inputs(p, dom, z, h))
        got = FB.barycentric(*args)
        err = max(err, require_equal(f"fr_barycentric ({label})", got,
                                     FB.FR.canon(FB.barycentric(
                                         *args, plain=True))))
        if zero != (FB.from_limbs(got)[0] == 0):
            raise AssertionError(f"fr_barycentric ({label}): "
                                 f"{FB.from_limbs(got)[0]}")
        if label == "coset, random z":
            w64_ms = device_ms(lambda: FB.barycentric(*args), 5)
    print(f"K16 edges: z on the W={len(roots)} domain and the zero "
          f"polynomial give 0; the W={len(coset)} coset of cell {cell} at "
          f"a random z and on the coset: equal to the plain version")
    return err, w64_ms


def kzg_path(dev, record, int32_ops_per_s):
    """Config #5, Deneb `verify_blob_kzg_proof_batch` over `bench.py:1112
    worker_kzg`'s 6 blobs: the setup on the card (commitments by K14 at
    4096 points, proofs by K16 + K14), one commitment against the host
    oracle, the main path (K16 per blob, then K12 -> K10), each blob's y
    against the host field loop, K16 against its plain version once,
    swapped proofs and a wrong blob rejected, the cold and warm times
    with the host and device split."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.models.deneb import \
        polynomial_commitments as P
    from consensus_specs_tpu_torch.ops import bls as BLS
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    if BLS.backend_name() != "torch" or BLS._device != "cuda":
        raise AssertionError("the BLS facade does not default to the card")
    t0 = time.perf_counter()
    blobs = CV.kzg_blobs(KZG_BLOBS)
    print(f"kzg inputs: {len(blobs)} blobs of {P.FIELD_ELEMENTS_PER_BLOB} "
          f"field elements (bench.py worker_kzg's recipe), built in "
          f"{time.perf_counter() - t0:.3f} s")

    # -- setup on the card ---------------------------------------------------
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    commitments = [P.blob_to_kzg_commitment(b) for b in blobs]
    t_com = time.perf_counter() - t0
    t0 = time.perf_counter()
    proofs = [P.compute_blob_kzg_proof(b, c)
              for b, c in zip(blobs, commitments)]
    t_proof = time.perf_counter() - t0
    setup_counts = read_launches("kzg setup")
    if (setup_counts.get("msm_double_add", 0) != 2 * len(blobs)
            or setup_counts.get("fr_barycentric", 0) != len(blobs)):
        raise AssertionError("the KZG setup did not run on the card")
    BLS.use_backend("py")
    try:
        t0 = time.perf_counter()
        oracle = P.blob_to_kzg_commitment(blobs[0])
        oracle_s = time.perf_counter() - t0
    finally:
        BLS.use_backend("torch")
    if bytes(oracle) != bytes(commitments[0]):
        raise AssertionError("commitment 0 differs from the host oracle's")
    print(f"kzg setup on the card: {len(blobs)} commitments in {t_com:.3f} "
          f"s (K14 at 4096 points), {len(blobs)} proofs in {t_proof:.3f} s "
          f"(K16 + K14); commitment 0 equals the host oracle's "
          f"multi_exp ({oracle_s:.3f} s)")

    # -- the main path ---------------------------------------------------------
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    ok = P.verify_blob_kzg_proof_batch(blobs, commitments, proofs)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches("kzg verify")
    for name, want in (("fr_barycentric", len(blobs)),
                       ("precomp_miller_product", 1),
                       ("final_exp_is_one", 1)):
        if counts.get(name, 0) != want:
            raise AssertionError(f"verify_blob_kzg_proof_batch launched "
                                 f"{name} {counts.get(name, 0)} times")
    if ok is not True:
        raise AssertionError("config #5's valid batch was rejected")
    if P.verify_blob_kzg_proof_batch(blobs, commitments,
                                     proofs[1:] + proofs[:1]) is not False:
        raise AssertionError("config #5 with swapped proofs was accepted")
    if P.verify_blob_kzg_proof_batch([blobs[1]] + blobs[1:], commitments,
                                     proofs) is not False:
        raise AssertionError("config #5 with a wrong blob was accepted")

    # -- each y: K16 against the host field loop; the plain K16 once -----------
    roots = [int(r) for r in P.bit_reversal_permutation(
        P.compute_roots_of_unity(P.FIELD_ELEMENTS_PER_BLOB))]
    for i, (blob, com) in enumerate(zip(blobs, commitments)):
        poly = P.blob_to_polynomial(blob)
        z = P.compute_challenge(blob, com)
        y = FB.barycentric_eval([int(v) for v in poly], roots, int(z),
                                device=dev)
        BLS.use_backend("py")
        try:
            y_host = P.evaluate_polynomial_in_evaluation_form(poly, z)
        finally:
            BLS.use_backend("torch")
        if y != int(y_host):
            raise AssertionError(f"blob {i}: K16's y differs from the host "
                                 "loop's")
        if i == 0:
            args = tuple(torch.from_numpy(a).to(dev)
                         for a in FB.barycentric_inputs(
                             [int(v) for v in poly], roots, int(z)))
    k16 = FB.barycentric(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p16 = FB.barycentric(*args, plain=True)
    torch.cuda.synchronize()
    plain16 = (time.perf_counter() - t0) * 1e3
    err16, k16_w64_ms = check_k16_edges(dev, [int(v) for v in poly], roots)
    err16 = max(err16, require_equal("fr_barycentric", k16,
                                     FB.FR.canon(p16)))

    warm = []
    for _ in range(KZG_TIMED):
        t0 = time.perf_counter()
        if P.verify_blob_kzg_proof_batch(blobs, commitments,
                                         proofs) is not True:
            raise AssertionError("the timed KZG batch was rejected")
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    per = kernel_device_ms(lambda: P.verify_blob_kzg_proof_batch(
        blobs, commitments, proofs), _bls_wrappers())
    device_total = sum(per.values())
    k16_ms = device_ms(lambda: FB.barycentric(*args), 5)
    wall = statistics.median(warm)
    print(f"kzg verify_blob_kzg_proof_batch (config #5, {len(blobs)} "
          f"blobs): cold_ms={cold_ms:.4f} warm median_ms={wall:.4f} "
          f"min_ms={min(warm):.4f} max_ms={max(warm):.4f} "
          f"device_ms={device_total:.6f} (CUDA events around each launch "
          f"in one call: " + ", ".join(f"{k} {v:.6f}" for k, v in
                                       per.items() if v)
          + f") host_ms={wall - device_total:.4f} device_share="
          f"{device_total / wall:.4f} verifies_per_s="
          f"{len(blobs) / wall * 1e3:.3f}; K16 per call {k16_ms:.6f} ms "
          f"(plain {plain16:.3f} ms; {k16_w64_ms:.6f} ms at the W=64 "
          f"coset width, 2 blocks against 128); each y equals the host loop's; "
          f"swapped proofs and a wrong blob rejected")
    width = P.FIELD_ELEMENTS_PER_BLOB
    # f_i x_i, the W inverses of z - x_i, the W terms, z^W by squarings and
    # the two scale products
    products = (2 * width + batch_inv_products(width)
                + width.bit_length() - 1 + 2)
    record("fr_barycentric", "consensus_specs_tpu_torch/csrc/fr_batch.cu",
           "consensus_specs_tpu/ops/fr_batch.py:220", err16, k16_ms, plain16,
           *fr_bound(products, (2 * width + 4) * 132, int32_ops_per_s),
           montgomery_products=products, w64_ms=k16_w64_ms,
           shape=f"W={width}, one blob of config #5",
           replaces_also=["consensus_specs_tpu/ops/fr_batch.py:303",
                          "consensus_specs_tpu/models/deneb/"
                          "polynomial_commitments.py:224"])
    return counts, setup_counts


def das_path(dev, record, int32_ops_per_s):
    """PeerDAS `verify_cell_proof_batch` on `bench.py:626 worker_das`'s
    128 x 8 closed-form matrix (1024 cells, rung 1024): the main path
    (K17, K14 for the LL and RLP MSMs, K13 for the RL MSM, K12 -> K10),
    K17 against its plain version and the host fold, a tampered cell
    rejected, a 16-cell sub-batch on the host route and isolated,
    `evaluate_cells_at` against the host route, the stage split."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import das as D
    from consensus_specs_tpu_torch.das import ciphersuite as cs
    from consensus_specs_tpu_torch.das import verify as V
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    t0 = time.perf_counter()
    com, idx, cells, proofs = cs.closed_form_matrix(
        DAS_BLOBS, columns=range(DAS_COLUMNS))
    n = len(idx)
    print(f"das inputs: {DAS_COLUMNS} x {DAS_BLOBS} closed-form matrix "
          f"({n} cells, seed 20250), built in "
          f"{time.perf_counter() - t0:.3f} s")

    torch.cuda.synchronize()
    _build.reset_launches()
    trace = {}
    t0 = time.perf_counter()
    ok = D.verify_cell_proof_batch(com, idx, cells, proofs, trace=trace)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches("das verify")
    for name in ("fr_coset_interpolate", "precomp_miller_product",
                 "final_exp_is_one"):
        if counts.get(name, 0) != 1:
            raise AssertionError(f"the DAS verify launched {name} "
                                 f"{counts.get(name, 0)} times")
    if counts.get("msm_double_add", 0) + counts.get("msm_pippenger", 0) != 3:
        raise AssertionError("the DAS verify did not run its three MSMs")
    if ok is not True:
        raise AssertionError("the valid DAS matrix was rejected")

    # -- K17 against its plain version and the host fold -----------------------
    batch = trace["batch"]
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in FB.coset_interpolate_inputs(
                     batch.evals, cs.coset_idft_matrix(),
                     V._rli_weight_rows(batch)))
    k17 = FB.coset_interpolate(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p17 = FB.coset_interpolate(*args, plain=True)
    torch.cuda.synchronize()
    plain17 = (time.perf_counter() - t0) * 1e3
    err17 = require_equal("fr_coset_interpolate", k17, FB.FR.canon(p17))
    t0 = time.perf_counter()
    host = V._host_rli_coeffs(batch)
    host_fold_s = time.perf_counter() - t0
    if FB.from_limbs(k17) != host or trace["rli"] != host:
        raise AssertionError("K17's coefficients differ from the host fold")
    k17_rungs, err17 = check_k17_rungs(dev, err17)

    # -- rejection, the host route and isolation on a sub-batch ---------------
    bad = list(cells)
    bad[DAS_BAD] = bad[DAS_BAD][:-32] + int.to_bytes(7, 32, "big")
    if D.verify_cell_proof_batch(com, idx, bad, proofs) is not False:
        raise AssertionError("a DAS matrix with a tampered cell was accepted")
    s = slice(0, DAS_SUB)
    for cl, want in ((cells, True), (bad, False)):
        sub = (com[s], idx[s], cl[s], proofs[s])
        if (D.verify_cell_proof_batch(*sub, device=False) is not want
                or D.verify_cell_proof_batch(*sub) is not want):
            raise AssertionError(f"the {DAS_SUB}-cell sub-batch: routes "
                                 "disagree")
    t0 = time.perf_counter()
    flags = D.verify_and_isolate(com[s], idx[s], bad[s], proofs[s])
    isolate_s = time.perf_counter() - t0
    if flags != (False, [k != DAS_BAD for k in range(DAS_SUB)]):
        raise AssertionError(f"verify_and_isolate: {flags}")
    z = 0xFEEDFACE
    if D.evaluate_cells_at(cells[s], idx[s], z) != D.evaluate_cells_at(
            cells[s], idx[s], z, device=False):
        raise AssertionError("evaluate_cells_at: K16 differs from the host")

    walls, stages = [], []
    for _ in range(DAS_TIMED):
        tr = {}
        t0 = time.perf_counter()
        if D.verify_cell_proof_batch(com, idx, cells, proofs,
                                     trace=tr) is not True:
            raise AssertionError("the timed DAS batch was rejected")
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        stages.append(tr["seconds"])
    per = kernel_device_ms(lambda: D.verify_cell_proof_batch(
        com, idx, cells, proofs), _bls_wrappers())
    device_total = sum(per.values())
    k17_ms = device_ms(lambda: FB.coset_interpolate(*args), 5)
    wall = statistics.median(walls)
    split = {k: statistics.median(st[k] for st in stages) * 1e3
             for k in stages[0]}
    print(f"das verify_cell_proof_batch ({n} cells, rung "
          f"{args[0].shape[0]}): first_ms={first_ms:.4f} median_ms="
          f"{wall:.4f} min_ms={min(walls):.4f} max_ms={max(walls):.4f} "
          f"stages_median_ms " + json.dumps({k: round(v, 4) for k, v in
                                              split.items()})
          + f" device_ms={device_total:.6f} (CUDA events around each launch "
          f"in one call: " + ", ".join(f"{k} {v:.6f}" for k, v in
                                       per.items() if v)
          + f") host_ms={wall - device_total:.4f} cells_per_s="
          f"{n / wall * 1e3:.3f}; K17 equals its plain version (plain "
          f"{plain17:.3f} ms) and the host fold ({host_fold_s:.3f} s); a "
          f"tampered cell rejected; {DAS_SUB}-cell sub-batch equal on the "
          f"host route, verify_and_isolate flags cell {DAS_BAD} "
          f"({isolate_s:.3f} s); evaluate_cells_at on {DAS_SUB} cells "
          f"equals the host route")
    rung = args[0].shape[0]
    products = rung * 64 * 64 + rung * 64
    nbytes = (2 * rung * 64 + 64 * 64 + 64) * 132
    ops = k17_ops(rung, 64)
    ops_ms = ops / int32_ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    record("fr_coset_interpolate",
           "consensus_specs_tpu_torch/csrc/fr_batch.cu",
           "consensus_specs_tpu/ops/fr_batch.py:315", err17, k17_ms, plain17,
           max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms
           else "bytes", int32_ops=ops,
           montgomery_bound_ms=fr_bound(products, nbytes,
                                        int32_ops_per_s)[0],
           montgomery_products=products,
           shape=f"{n} cells at rung {rung}, width 64",
           replaces_also=["consensus_specs_tpu/ops/fr_batch.py:396"],
           **k17_rungs)
    return counts


def k17_ops(B: int, W: int) -> int:
    """int32 instructions of K17's design: the raw products of its sums,
    B W^2 of them at 64 word products of 2 instructions (the low and the
    high multiply-add), and for each (b, j) one reduction (about 80 word
    products: the top word's fold, twice, and a Montgomery reduction) and
    the weight's Montgomery product."""
    return B * W * W * 64 * 2 + B * W * (80 * 2 + OPS_PER_FR_MONT)


def check_k17_rungs(dev, err: int):
    """K17 against its plain version at the DAS ladder's other rungs (B =
    16, 128: 32 and 128 fold blocks) on seeded rows, and at B = 1024 with
    every input r - 1, as a field element and as limbs of value r - 1 (the
    fold's largest lazy sums).  Returns ({"ms_16": .., "ms_128": ..},
    the largest error)."""
    import torch

    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    rng = np.random.RandomState(SEED + 17)

    def rows(m):
        return [[int.from_bytes(rng.bytes(32), "little") % R
                 for _ in range(64)] for _ in range(m)]

    out = {}
    for b in (16, 128):
        a = tuple(torch.from_numpy(t).to(dev) for t in
                  FB.coset_interpolate_inputs(rows(b), rows(64), rows(b)))
        err = max(err, require_equal(
            f"fr_coset_interpolate B={b}", FB.coset_interpolate(*a),
            FB.FR.canon(FB.coset_interpolate(*a, plain=True))))
        out[f"ms_{b}"] = device_ms(lambda a=a: FB.coset_interpolate(*a), 20)
    raw = torch.tensor([((R - 1) >> (12 * k)) & 0xFFF for k in range(33)],
                       dtype=torch.int32)
    for label, one in (("r - 1", torch.from_numpy(FB.FR.to_mont_batch(
            [R - 1]))[0]), ("limbs of value r - 1", raw)):
        ev = one.expand(1024, 64, 33).contiguous().to(dev)
        m = one.expand(64, 64, 33).contiguous().to(dev)
        err = max(err, require_equal(
            f"fr_coset_interpolate every input {label}",
            FB.coset_interpolate(ev, m, ev.clone()),
            FB.FR.canon(FB.coset_interpolate(ev, m, ev.clone(), plain=True))))
    print(f"fr_coset_interpolate at B = 16 and 128 ({out}) and at B = 1024 "
          f"with every input r - 1: equal to the plain version")
    return out, err


def compute_cells_path(dev, record, int32_ops_per_s):
    """Fulu `compute_cells` of `bench.py:771-794`'s closed-form degree-65
    blob: the main path (K18 at n = 4096 inverse, then n = 8192 forward),
    its 128 cells against the closed form and the host FFT route, K18
    against its plain version at both sizes, the times."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch import das as D
    from consensus_specs_tpu_torch.das import ciphersuite as cs
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    blob, cells, _, _ = CV.closed_form_blob()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = D.compute_cells(blob)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches("compute_cells")
    if counts.get("fr_fft", 0) != 2:
        raise AssertionError("compute_cells did not run K18 twice")
    if got != cells:
        raise AssertionError("compute_cells differs from the closed form")
    t0 = time.perf_counter()
    if D.compute_cells(blob, device=False) != got:
        raise AssertionError("compute_cells differs from the host route")
    host_ms = (time.perf_counter() - t0) * 1e3
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        D.compute_cells(blob)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)

    m = cs.FIELD_ELEMENTS_PER_BLOB
    evals = DC.blob_to_poly_ints(blob)
    brp = [evals[cs.reverse_bits(i, m)] for i in range(m)]
    coeffs = DC.poly_coefficients(blob)
    sizes = {}
    err = 0
    for label, rows, roots, inverse in (
            ("inverse", [brp], cs.roots_of_unity(m), True),
            ("forward", [list(coeffs) + [0] * m], cs.roots_of_unity(2 * m),
             False)):
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in FB.fft_inputs(rows, roots, inverse))
        k18 = FB.fft(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p18 = FB.fft(*args, plain=True)
        torch.cuda.synchronize()
        plain = (time.perf_counter() - t0) * 1e3
        err = max(err, require_equal(f"fr_fft {label} n={len(roots)}", k18,
                                     FB.FR.canon(p18)))
        # the butterflies read the first n/2 roots; only the inverse scales
        nn = len(roots)
        products = nn // 2 * (nn.bit_length() - 1) + (nn if inverse else 0)
        nbytes = (2 * nn + nn // 2 + (1 if inverse else 0)) * 132
        sizes[label] = (nn, device_ms(lambda: FB.fft(*args), 5), plain,
                        products, fr_bound(products, nbytes, int32_ops_per_s))
    print(f"compute_cells (closed-form degree-65 blob): first_ms="
          f"{first_ms:.4f} median_ms={statistics.median(walls):.4f} "
          f"min_ms={min(walls):.4f} max_ms={max(walls):.4f} host FFT route "
          f"{host_ms:.4f} ms; 128 cells equal the closed form and the host "
          f"route; K18 " + ", ".join(
              f"n={nn} {label} {kms:.6f} ms (plain {pms:.3f} ms)"
              for label, (nn, kms, pms, _, _) in sizes.items())
          + " equal to the plain version")
    nn, kms, pms, products, (bms, by) = sizes["forward"]
    inn, ikms, ipms, iproducts, (ibms, _) = sizes["inverse"]
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    lat_ms = FR_PROBE["latency_us"] / 1e3
    record("fr_fft", "consensus_specs_tpu_torch/csrc/fr_batch.cu",
           "consensus_specs_tpu/ops/fr_batch.py:417", err, kms, pms, bms, by,
           montgomery_products=products,
           shape=f"n={nn} forward, batch 1 (compute_cells' extension)",
           tile=FK.FFT_TILE, chain_floor_ms=k18_chain_products(nn) * lat_ms,
           inverse_ms=ikms, inverse_plain_ms=ipms, inverse_bound_ms=ibms,
           inverse_chain_floor_ms=k18_chain_products(inn) * lat_ms,
           inverse_shape=f"n={inn} inverse, batch 1",
           replaces_also=["consensus_specs_tpu/ops/fr_batch.py:515",
                          "consensus_specs_tpu/das/compute.py:122"])
    return counts


# --- slice 6: the G1 FFT, FK20, the PeerDAS producer and recovery ------------

def _same_points(name, got, plain) -> int:
    """A K19/K20 output against the plain version's: canonical coordinates
    equal where Z != 0, the Z = 0 flag equal elsewhere (masked lanes carry
    stale x and y)."""
    import torch

    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    gx, gy, gz = got
    px, py, pz = (F.fq_canon(c) for c in plain)
    inf = (pz == 0).all(-1)
    require_equal(f"{name} (Z = 0 lanes)", (gz == 0).all(-1), inf)
    live = ~inf
    return max(require_equal(f"{name} ({c})", g[live], p[live])
               for c, g, p in (("x", gx, px), ("y", gy, py), ("z", gz, pz)))


def g1fft_products(n: int, batch: int, inverse: bool) -> int:
    """K19's Montgomery products for one (batch, n) transform, counted
    from what the twiddles need: per butterfly lane with twiddle k > 1,
    the 14 table entries (7 doublings of 7 products, 7 additions of 16),
    bit_length(k) - 4 doublings past the leading window and an addition
    per nonzero window after it; the two butterfly additions; for the
    inverse, the scale by 1/n (bit_length - 1 doublings, popcount - 1
    additions) on every point."""
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    dbl, add = 7, 16
    _, _, digits = G._stage_plan(n, inverse)
    total = 0
    for row in digits.reshape(-1, digits.shape[-1]):
        nz = np.flatnonzero(row).tolist()
        if nz and not (len(nz) == 1 and row[nz[0]] == 1
                       and nz[0] == len(row) - 1):
            total += 7 * dbl + 7 * add
            total += 4 * (len(row) - 1 - nz[0]) * dbl + (len(nz) - 1) * add
        total += 2 * add
    total *= batch
    if inverse:
        inv_n = pow(n, G.R_MODULUS - 2, G.R_MODULUS)
        total += batch * n * ((inv_n.bit_length() - 1) * dbl
                              + (bin(inv_n).count("1") - 1) * add)
    return total


def hext_products(digits) -> int:
    """K20's Montgomery products for these digits (R, width, 64): each
    position's window-4 Pippenger, counted as K13's
    (`pippenger_products`)."""
    return sum(pippenger_products(digits[:, j, :], 4)
               for j in range(digits.shape[1]))


def g1fft_chain_rounds(n: int, inverse: bool) -> int:
    """K19's chain in pass rounds (a doubling 3, an addition 5: each one
    product deep): in each butterfly round the longest lane's (the table
    up to its top digit, 4 doublings and an addition of each nonzero
    digit after its first one, the butterfly's two additions), summed
    over the rounds; for the inverse, the 1/n scale's (a doubling a bit
    after the leading one, an addition a set bit)."""
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    total = 0
    for rnd in G._stage_plan(n, inverse)[2]:
        worst = 0
        for row in rnd:
            lane = 10
            nz = np.flatnonzero(row)
            if len(nz):
                lane += sum(3 if d % 2 == 0 else 5
                            for d in range(2, int(row.max()) + 1))
                after = row[nz[0] + 1:]
                lane += 12 * len(after) + 5 * int(np.count_nonzero(after))
            worst = max(worst, lane)
        total += worst
    if inverse:
        bits = G._inv_bits(n)
        total += 3 * (len(bits) - 1) + 5 * (int(bits.sum()) - 1)
    return total


def hext_chain_rounds(digits) -> int:
    """K20's chain in pass rounds for these digits (R, width, 64), the
    longest position's: its longest window's bucket pass (5 a row added
    into a bucket that holds a point already), its longest suffix sum (5
    an addition of two finite sums), the combine (4 doublings and an
    addition a window after the first window with a nonzero digit)."""
    worst = 0
    for j in range(digits.shape[1]):
        bucket = suffix = comb = 0
        first = None
        for w in range(digits.shape[2]):
            col = digits[:, j, w]
            nz = col[col != 0].tolist()
            have = set(nz)
            bucket = max(bucket, 5 * (len(nz) - len(have)))
            run = acc = False
            rounds = 0
            for k in range(15, 0, -1):
                rounds += 5 if run and k in have else 0
                run = run or k in have
                rounds += 5 if acc and run else 0
                acc = acc or run
            suffix = max(suffix, rounds)
            if first is not None:
                comb += 12 + (5 if nz else 0)
            elif nz:
                first = w
        worst = max(worst, bucket + suffix + comb)
    return worst


def g1_product_latency_us(dev) -> float:
    """One pass round's product on the card, in us: K19's and K20's
    product call (an operand pick, the Fp product, its store to shared
    memory) timed over a chain of G1_CHAIN_PROBE dependent products on
    one thread, less the empty chain's launch; the chain's value held
    against the host's a^(2^n)."""
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    a = F.const(F.to_mont(7), dev)
    got = F.from_mont(K.g1_product_chain(a, G1_CHAIN_PROBE).cpu().numpy())
    if got != pow(7, 2**G1_CHAIN_PROBE, Q):
        raise AssertionError("g1_product_chain: wrong value")
    full = device_ms(lambda: K.g1_product_chain(a, G1_CHAIN_PROBE), 5)
    empty = device_ms(lambda: K.g1_product_chain(a, 0), 5)
    return (full - empty) / G1_CHAIN_PROBE * 1e3


def g1fft_edge_inputs() -> dict:
    """K19's and K20's edge inputs, numpy, made on the host.  For each
    (n, batch, inverse) of G1FFT_EDGE, rows of multiples of G1 in
    bit-reversed order: row 0 ends in two infinities; row 1 has two
    masked lanes (Z = 0 under a point's X and Y, as `das/compute.py`
    masks the proofs' lanes); row 2 is masked whole.  For K20 at
    FK20_EDGE, seeded points and scalars with an infinity under a point's
    X and Y, a position of zero scalars, a point added twice into the
    same buckets (the doubling branch) and a point beside its negative
    with equal scalars."""
    import random

    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G
    from consensus_specs_tpu_torch.ops.bls_batch.curve import \
        scalars_to_digits

    out = {}
    for n, batch, inverse in G1FFT_EDGE:
        coords, rows = [], []
        for b in range(batch):
            row = [Cv.g1.mul(Cv.G1_GEN, 3 + 7 * b + i) for i in range(n - 2)]
            row += [Cv.g1.infinity()] * 2
            xyz = G.points_to_limbs(row)
            masked = {1: (1, n - 3), 2: range(n)}.get(b, ())
            for k in masked:
                xyz[2][k] = 0
                row[k] = Cv.g1.infinity()
            coords.append(xyz)
            rows.append(row)
        perm = list(G._bitrev_perm(n))
        x, y, z = (np.stack([c[i] for c in coords])[:, perm] for i in range(3))
        out[("fft", n, batch, inverse)] = (x, y, z, rows)
    rng = random.Random(SEED + 13)
    n_res, width = FK20_EDGE
    pts = [[Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, 2**32))
            for _ in range(width)] for _ in range(n_res)]
    scalars = [[rng.randrange(G.R_MODULUS) for _ in range(width)]
               for _ in range(n_res)]
    pts[5][2], scalars[5][2] = pts[2][2], scalars[2][2]
    pts[6][3], scalars[6][3] = Cv.g1.neg(pts[1][3]), scalars[1][3]
    for c in range(n_res):
        scalars[c][4] = 0
    x, y, z = (np.stack([[F.to_mont(p[i]) for p in row] for row in pts])
               for i in range(3))
    z[3, 1] = 0
    pts[3][1] = Cv.g1.infinity()
    digits = scalars_to_digits([v for row in scalars for v in row], 255,
                               4).reshape(n_res, width, 64)
    out["hext"] = (x, y, z, digits, pts, scalars)
    return out


def g1fft_edge_plain() -> dict:
    """The plain versions on the CPU, one torch thread, on
    `g1fft_edge_inputs`: each edge transform, the inverse of the n = 8
    forward output (the round trip, whose last round meets u - t = 2u),
    K20; canonical numpy coordinates.  `main` runs it in a worker
    process beside the card's phases."""
    import torch

    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    out = {}
    for key, val in g1fft_edge_inputs().items():
        t = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in val[:3])
        if key == "hext":
            p = G.hext(*t, torch.from_numpy(val[3]), plain=True)
        else:
            p = G.fft(*t, inverse=key[3], plain=True)
        out[key] = tuple(F.fq_canon(c).numpy() for c in p)
        if key[0] == "fft" and key[1] == 8:
            perm = torch.tensor(G._bitrev_perm(8))
            back = G.fft(*(F.fq_canon(c)[:, perm].contiguous() for c in p),
                         inverse=not key[3], plain=True)
            out[("round_trip", 8)] = tuple(F.fq_canon(c).numpy()
                                           for c in back)
    return out


def msm_edge_inputs() -> dict:
    """K13's and K14's edge inputs, numpy, from the MSM probe's points
    (`msm_probe`).  K13 at each (c, n) of MSM_EDGE_PIP, (x, y, digits,
    points): point 1 repeats point 0, point 2 is its negative, point 4
    the negative of point 3; window 0 all zero digits; every point in the
    top bucket of window 1 (one bucket's chain n long, through P + P and
    Q - Q); points 0-2 alone in bucket 3 of window 2 (P then P doubles,
    then -P); points 3-5 in bucket 5 of window 3 (Q then -Q gives
    infinity, point 5 brings it back); the last two points zero digits;
    at n = 8, four pairs P, -P with equal digits (the sum at infinity).
    K14 at each n of MSM_EDGE_DA, (x, y, bits, mask): the probe's
    scalars but the G1 point (0, 2) of order 3 with scalars 3 (T = -Q
    gives infinity) and 5 (T = Q doubles), scalars 1, r - 1, 2^254 and a
    zero scalar on a live lane, lanes 2 and 2 + n/2 equal and 3 and 3 +
    n/2 opposite (the tree's first level meets P + P and P - P), masked
    lanes in the middle and at the end."""
    import random

    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    pts, ks = msm_probe()
    out = {}
    for c, n in MSM_EDGE_PIP:
        r = random.Random(SEED + 60 + c)
        nb, W = 1 << c, -(-255 // c)
        if n == 8:
            p = [Cv.g1.neg(pts[i // 2]) if i % 2 else pts[i // 2]
                 for i in range(n)]
            digits = np.repeat(BC.scalars_to_digits(ks[:n // 2], 255, c), 2,
                               0)
        else:
            p = list(pts[:n])
            p[1], p[2], p[4] = p[0], Cv.g1.neg(p[0]), Cv.g1.neg(p[3])
            digits = np.array([[r.randrange(nb) for _ in range(W)]
                               for _ in range(n)], np.int32)
            digits[:, 0] = 0
            digits[:, 1] = nb - 1
            digits[3:, 2][digits[3:, 2] == 3] = 2
            digits[:3, 2] = 3
            digits[:3, 3][digits[:3, 3] == 5] = 6
            digits[3:6, 3] = 5
            digits[-2:] = 0
        x, y = BC.g1_affine_to_limbs(p)
        out[("pippenger", c, n)] = (x, y, digits, p)
    for n in MSM_EDGE_DA:
        h = n // 2
        k = list(ks[:n])
        k[:6] = [3, 5, 1, Cv.R - 1, 2**254, 0]
        x, y = BC.g1_affine_to_limbs(pts[:n])
        x[:2], y[:2] = F.to_mont(0), F.to_mont(2)
        for i in (2, 3):
            x[i + h], y[i + h], k[i + h] = x[i], y[i], 1
        mask = np.ones(n, bool)
        mask[[h, n - 1]] = False
        out[("double_add", n)] = (x, y, BC.scalars_to_bits(k, 255), mask)
    return out


def msm_edge_plain() -> dict:
    """K13's plain version on the CPU, one torch thread, on
    `msm_edge_inputs`' Pippenger shapes: canonical numpy coordinates.
    `main` runs it in a worker process beside the card's phases."""
    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    out = {}
    for key, val in msm_edge_inputs().items():
        if key[0] == "pippenger":
            t = tuple(torch.from_numpy(np.ascontiguousarray(a))
                      for a in val[:3])
            out[key] = tuple(F.fq_canon(c).numpy()
                             for c in B.msm_pippenger_plain(*t, key[1]))
    return out


def check_msm_edges(dev) -> tuple:
    """K13 at MSM_EDGE_PIP, K14 at MSM_EDGE_DA and K27 at D = 1-4 on
    their edge inputs, against the plain versions by `_same_points`
    (K13's from EDGE's worker on the CPU, K14's from `precompute_plain`
    on the card, K27's here); K13's points against the oracle's g1.msm of
    its digits' scalars.  Returns the three kernels' max abs errors."""
    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    inputs = msm_edge_inputs()
    t0 = time.perf_counter()
    plain = EDGE["msm_edge"].get(timeout=900)
    wait = time.perf_counter() - t0
    err13 = err14 = 0
    for key, val in inputs.items():
        t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in val[:4 if key[0] == "double_add" else 3])
        if key[0] == "pippenger":
            c = key[1]
            got = K.msm_pippenger_kernel(*t, c)
            want = tuple(torch.from_numpy(a).to(dev) for a in plain[key])
            err13 = max(err13, _same_points(f"msm_pippenger edge {key[1:]}",
                                            got, want))
            W = val[2].shape[1]
            scalars = [sum(int(d) << (c * (W - 1 - w))
                           for w, d in enumerate(row)) for row in val[2]]
            if not Cv.g1.eq_points(BC.g1_limbs_to_oracle(got),
                                   Cv.g1.msm(val[3], scalars)):
                raise AssertionError(f"msm_pippenger edge {key[1:]}: not "
                                     "the oracle's g1.msm")
        else:
            got = K.msm_double_add_kernel(*t)
            want, _ = plain_ref(f"msm_edge_{key[1]}",
                                lambda: B.msm_double_add_plain(*t), *t)
            err14 = max(err14, _same_points(f"msm_double_add edge {key[1]}",
                                            got, want))
    pts = [Cv.g1.mul(Cv.G1_GEN, 5 + i) for i in range(2)]
    pts.append(Cv.g1.neg(pts[0]))
    x, y = BC.g1_affine_to_limbs(pts)
    one = np.broadcast_to(F.ONE_MONT, x.shape[1:]).astype(np.int32)
    err27 = 0
    for rows in ([0], [0, 0], [0, 2], [None, 1], [1, 0, 0], [0, 0, None, 1],
                 [2, None, 0, 2], [None, None, None, None]):
        X, Y, Z = (torch.from_numpy(np.stack(a)).to(dev) for a in (
            [x[i or 0] for i in rows], [y[i or 0] for i in rows],
            [one if i is not None else 0 * one for i in rows]))
        err27 = max(err27, _same_points(
            f"g1_shard_fold edge {rows}", K.g1_shard_fold_kernel(X, Y, Z),
            B.g1_shard_fold_plain(X, Y, Z)))
    shapes = [k[1:] for k in inputs if k[0] == "pippenger"]
    print(f"msm edges: K13 at (c, n) {shapes} (a window of zero digits, "
          f"one bucket's chain n "
          f"long, P + P, Q - Q at infinity and back, zero scalars, a sum at "
          f"infinity) equal to the plain versions (on the CPU beside the "
          f"card's phases; {wait:.3f} s waited for them) and to g1.msm; K14 "
          f"at {list(MSM_EDGE_DA)} lanes (the order-3 point with 3 and 5, "
          f"scalars 1, r - 1, 2^254, 0, masked lanes, P + P and P - P in "
          f"the tree) and K27 at D = 1-4 (equal, opposite and infinite "
          f"partials) equal to the plain versions")
    return err13, err14, err27


def g1fft_setup_inputs(start: int, stop: int) -> tuple:
    """K19's main-path input: rows start .. stop - 1 of the L x K trusted
    setup residue vectors, padded to N with infinities, in bit-reversed
    order; numpy (x, y, z), each (stop - start, N, 33)."""
    from consensus_specs_tpu_torch.das import ciphersuite as cs
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    L, KK, N = DC.L, DC.K, DC.N_EXT
    limbs = [G.points_to_limbs([cs.setup_g1_point(c + L * v)
                                for v in range(KK)], pad_to=N)
             for c in range(start, stop)]
    perm = list(G._bitrev_perm(N))
    return tuple(np.ascontiguousarray(np.stack([lb[i] for lb in limbs])[
        :, perm]) for i in range(3))


def _plain_worker_init() -> None:
    """A plain-reference worker runs below nvcc and the card's phases, on
    one torch thread."""
    import os

    import torch

    os.nice(G1_PLAIN_NICE)
    torch.set_num_threads(1)


def _timed_plain(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def g1fft_plain_rows(start: int) -> tuple:
    """The plain K19 forward on G1_PLAIN_ROWS rows of the setup residue
    vectors from `start` (the transform works row by row, so these rows
    of the (L, N) plain output): (canonical numpy (x, y, z), ms) on the
    CPU.  `main` runs it in a worker process."""
    import torch

    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    x, y, z = (torch.from_numpy(a) for a in
               g1fft_setup_inputs(start, min(start + G1_PLAIN_ROWS, DC.L)))
    p, ms = _timed_plain(lambda: G.fft(x, y, z, plain=True))
    return tuple(F.fq_canon(c).numpy() for c in p), ms


def g1fft_plain_inverse() -> tuple:
    """The plain K19 at (1, N) inverse on the first setup table row (the
    plain (1, N) forward of the first residue vector, canonical, in
    bit-reversed order) on the CPU: (inputs, out, ms), canonical numpy.
    `main` runs it in a worker process."""
    import torch

    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    x, y, z = (torch.from_numpy(a) for a in g1fft_setup_inputs(0, 1))
    row = G.fft(x, y, z, plain=True)
    perm = torch.tensor(G._bitrev_perm(x.shape[1]))
    args = tuple(F.fq_canon(c)[:, perm].contiguous() for c in row)
    p, ms = _timed_plain(lambda: G.fft(*args, inverse=True, plain=True))
    return (tuple(c.numpy() for c in args),
            tuple(F.fq_canon(c).numpy() for c in p), ms)


# the worker processes of the G1 FFT phase's plain versions, started once
# the port imports: the pool and each task's pending result
EDGE = {}


def check_g1fft_edges(dev) -> tuple:
    """K19 and K20 on `g1fft_edge_inputs`, against the plain versions
    (from EDGE's worker) by `_same_points`: each edge transform; the
    inverse of K19's n = 8 forward output (the doubling branch), whose
    points must come back to the rows; K20, whose points must equal the
    oracle's per-position `g1.msm`."""
    import torch

    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    inputs = g1fft_edge_inputs()
    t0 = time.perf_counter()
    plain = EDGE["edge"].get(timeout=900)
    wait = time.perf_counter() - t0
    err19 = 0
    for key, val in inputs.items():
        if key == "hext":
            continue
        _, n, batch, inverse = key
        args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                     for a in val[:3])
        got = G.fft(*args, inverse=inverse)
        want = tuple(torch.from_numpy(a).to(dev) for a in plain[key])
        err19 = max(err19, _same_points(f"g1_fft edge {key[1:]}", got, want))
        if n != 8:
            continue
        perm = torch.tensor(G._bitrev_perm(n), device=dev)
        back = G.fft(*(c[:, perm].contiguous() for c in got),
                     inverse=not inverse)
        want = tuple(torch.from_numpy(a).to(dev)
                     for a in plain[("round_trip", 8)])
        err19 = max(err19, _same_points("g1_fft edge round trip (n = 8)",
                                        back, want))
        pts = G.limbs_to_oracle_list(back)
        for b, row in enumerate(val[3]):
            for i, pt in enumerate(row):
                if not Cv.g1.eq_points(pts[n * b + i], pt):
                    raise AssertionError(f"g1_fft edge round trip: row {b} "
                                         f"lane {i} differs")
    x, y, z, digits, pts, scalars = inputs["hext"]
    got = G.hext(*(torch.from_numpy(a).to(dev) for a in (x, y, z, digits)))
    want = tuple(torch.from_numpy(a).to(dev) for a in plain["hext"])
    err20 = _same_points(f"fk20_hext edge {FK20_EDGE}", got, want)
    out = G.limbs_to_oracle_list(got)
    for j in range(FK20_EDGE[1]):
        msm = Cv.g1.msm([row[j] for row in pts], [row[j] for row in scalars])
        if not Cv.g1.eq_points(out[j], msm):
            raise AssertionError(f"fk20_hext edge: position {j} differs "
                                 "from g1.msm")
    print(f"g1 fft edges: K19 at {[k[1:] for k in inputs if k != 'hext']} "
          f"(masked lanes, infinities, a row at infinity) and the n = 8 "
          f"round trip, K20 at {FK20_EDGE} (a stale infinity, zero "
          f"scalars, a doubled bucket, a point and its negative) equal to "
          f"the plain versions (computed on the CPU beside the card's "
          f"phases; {wait:.3f} s waited for them), the round trip to its "
          f"rows, K20 to g1.msm")
    return err19, err20


def check_g1fft_kernels(dev, record, int32_ops_per_s):
    """K19 against its plain version on the card at the setup shape (64,
    128), forward, on the trusted setup's residue vectors, and at (1,
    128) inverse on the first transformed row (which must come back to
    the setup points); at n = 8 against the naive per-point evaluation
    and the round trip.  K20 against its plain version at (64, 128) on
    the setup tables and the dense blob's digits, K18 at batch 64, n =
    128 against its plain version on the way.  Then the edge shapes
    (`check_g1fft_edges`) and the chains' floors."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.das import ciphersuite as cs
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.bls.curve import g1
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G
    from consensus_specs_tpu_torch.ops.bls_batch.curve import \
        scalars_to_digits

    L, KK, N = DC.L, DC.K, DC.N_EXT
    t0 = time.perf_counter()
    fwd_args = tuple(torch.from_numpy(a).to(dev)
                     for a in g1fft_setup_inputs(0, L))
    print(f"g1 fft inputs: the {L} x {KK} setup residue vectors padded to "
          f"{N}, parsed in {time.perf_counter() - t0:.3f} s")
    perm = torch.tensor(G._bitrev_perm(N), device=dev)
    _build.reset_launches()
    k19 = G.fft(*fwd_args)
    torch.cuda.synchronize()
    if _build.launches["g1_fft"] != 1:
        raise AssertionError("K19 did not launch")
    # K19's plain versions at n = N, from the workers that `main` started;
    # the setup's plain ms is the sum of its row blocks' ms
    t0 = time.perf_counter()
    blocks = [EDGE[("rows", r)].get(timeout=900)
              for r in range(0, L, G1_PLAIN_ROWS)]
    worker_in, p19i, plain_inv = EDGE["inverse"].get(timeout=900)
    wait = time.perf_counter() - t0
    plain_fwd = sum(ms for _, ms in blocks)
    err = _same_points(f"g1_fft ({L}, {N}) forward", k19, tuple(
        torch.from_numpy(np.concatenate([b[0][i] for b in blocks])).to(dev)
        for i in range(3)))
    fwd_ms = device_ms(lambda: G.fft(*fwd_args), 3)

    inv_args = tuple(c[:1][:, perm].contiguous() for c in k19)
    k19i = G.fft(*inv_args, inverse=True)
    torch.cuda.synchronize()
    if not all(torch.equal(a, torch.from_numpy(b).to(dev))
               for a, b in zip(inv_args, worker_in)):
        raise AssertionError("g1_fft: the inverse's input differs from the "
                             "plain forward's first row")
    err = max(err, _same_points(f"g1_fft (1, {N}) inverse", k19i,
                                tuple(torch.from_numpy(c).to(dev)
                                      for c in p19i)))
    back = G.limbs_to_oracle_list(k19i)
    for v in range(N):
        want = (cs.setup_g1_point(L * v) if v < KK else g1.infinity())
        if not g1.eq_points(back[v], want):
            raise AssertionError(f"g1_fft: the round trip of residue 0 "
                                 f"differs at {v}")
    inv_ms = device_ms(lambda: G.fft(*inv_args, inverse=True), 3)
    one_fwd = tuple(c[:1].contiguous() for c in fwd_args)
    one_ms = device_ms(lambda: G.fft(*one_fwd), 3)

    # n = 8: the naive evaluation and the round trip, through the kernel
    row = [g1.mul(cs.setup_g1_point(0), 3 + i) for i in range(6)]
    row += [g1.infinity()] * 2
    out = G.g1_fft(row, device=dev)
    dom = G.fft_domain(8)
    for i in range(8):
        want = g1.infinity()
        for j, pt in enumerate(row):
            want = g1.add(want, g1.mul(pt, dom[(i * j) % 8]))
        if not g1.eq_points(out[i], want):
            raise AssertionError(f"g1_fft n=8: output {i} differs from the "
                                 "naive evaluation")
    back8 = G.g1_fft(out, inverse=True, device=dev)
    if not all(g1.eq_points(a, b) for a, b in zip(back8, row)):
        raise AssertionError("g1_fft n=8: ifft(fft(x)) != x")

    # -- K20 on the setup tables and the dense blob's digits; K18 at 64 x 128
    tables = k19
    blob = CV.kzg_blobs(1)[0]
    coeffs = DC._coeff_limbs(DC.poly_coefficients(blob, device=dev), dev)
    padded = torch.cat([coeffs, torch.zeros_like(coeffs[:1])])
    rows = padded[DC._fk20_row_index(L, KK, N, DC.M, dev)]
    brp, roots, scale = DC._domain_consts(N, False, dev)
    k18_args = (rows[:, brp].contiguous(), roots, scale)
    k18 = FB.fft(*k18_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p18 = FB.fft(*k18_args, plain=True)
    torch.cuda.synchronize()
    plain18 = (time.perf_counter() - t0) * 1e3
    require_equal(f"fr_fft ({L}, {N})", k18, FB.FR.canon(p18))
    k18_ms = device_ms(lambda: FB.fft(*k18_args), 5)
    raw_one = torch.from_numpy(FB.FR.int_to_limbs(1)).to(dev)
    digits = G.limb_digits(FB.field_op(
        "mul", k18, raw_one.expand(k18.shape).contiguous()))
    host_digits = scalars_to_digits(FB.from_limbs(k18), 255, 4)
    if not np.array_equal(digits.cpu().numpy().reshape(-1, 64), host_digits):
        raise AssertionError("the device digits differ from the host's")
    k20 = G.hext(*tables, digits)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p20 = G.hext(*tables, digits, plain=True)
    torch.cuda.synchronize()
    plain20 = (time.perf_counter() - t0) * 1e3
    err20 = _same_points(f"fk20_hext ({L}, {N})", k20, p20)
    k20_ms = device_ms(lambda: G.hext(*tables, digits), 3)

    fwd_products = g1fft_products(N, L, False)
    inv_products = g1fft_products(N, 1, True)
    one_products = g1fft_products(N, 1, False)
    h_products = hext_products(digits.cpu().numpy())
    to_ms = OPS_PER_MONT / int32_ops_per_s * 1e3
    err_edge19, err_edge20 = check_g1fft_edges(dev)
    err, err20 = max(err, err_edge19), max(err20, err_edge20)
    # the chains' floor: their pass rounds times one product's latency
    lat_us = g1_product_latency_us(dev)
    inv_rounds = g1fft_chain_rounds(N, True)
    fwd_rounds = g1fft_chain_rounds(N, False)
    h_rounds = hext_chain_rounds(digits.cpu().numpy())
    print(f"g1 fft chains: a pass round's product {lat_us:.4f} us on the "
          f"card; pass rounds K19 (1, {N}) inverse {inv_rounds}, forward "
          f"{fwd_rounds} (and a row of ({L}, {N})), K20 {h_rounds}: chain "
          f"floors {inv_rounds * lat_us / 1e3:.4f} / "
          f"{fwd_rounds * lat_us / 1e3:.4f} / {h_rounds * lat_us / 1e3:.4f}"
          f" ms")
    print(f"g1 fft kernels: K19 ({L}, {N}) forward {fwd_ms:.6f} ms (plain "
          f"{plain_fwd:.3f} ms), (1, {N}) inverse {inv_ms:.6f} ms (plain "
          f"{plain_inv:.3f} ms, round trip to the setup points), (1, {N}) "
          f"forward {one_ms:.6f} ms; n=8 equal to the naive evaluation and "
          f"round-trips; K18 ({L}, {N}) {k18_ms:.6f} ms (plain "
          f"{plain18:.3f} ms); K20 ({L}, {N}) {k20_ms:.6f} ms (plain "
          f"{plain20:.3f} ms); products: K19 {fwd_products} / "
          f"{inv_products} / {one_products}, K20 {h_products}; all equal "
          f"to the plain versions (K19's on the CPU in worker processes, "
          f"{wait:.3f} s waited for them; K20's on the card)")
    cpu_note = ("the plain version on the CPU, in worker processes at a low "
                "priority beside nvcc and the card's phases; the setup's in "
                f"blocks of {G1_PLAIN_ROWS} rows, its ms their sum")
    record("g1_fft", "consensus_specs_tpu_torch/csrc/g1_fft.cu",
           "consensus_specs_tpu/ops/bls_batch/g1fft_jax.py:161", err,
           inv_ms, plain_inv, inv_products * to_ms, "operations",
           montgomery_products=inv_products,
           shape=f"(1, {N}) inverse, the FK20 chain's first G1 transform",
           forward_ms=one_ms, forward_bound_ms=one_products * to_ms,
           forward_shape=f"(1, {N}) forward",
           setup_ms=fwd_ms, setup_plain_ms=plain_fwd,
           setup_bound_ms=fwd_products * to_ms,
           setup_shape=f"({L}, {N}) forward, the setup tables (once)",
           plain_note=cpu_note,
           product_latency_us=lat_us, chain_rounds=inv_rounds,
           chain_floor_ms=inv_rounds * lat_us / 1e3,
           forward_chain_rounds=fwd_rounds,
           forward_chain_floor_ms=fwd_rounds * lat_us / 1e3,
           replaces_also=["consensus_specs_tpu/ops/bls_batch/"
                          "g1fft_jax.py:130",
                          "consensus_specs_tpu/ops/bls_batch/"
                          "g1fft_jax.py:257"])
    record("fk20_hext", "consensus_specs_tpu_torch/csrc/g1_fft.cu",
           "consensus_specs_tpu/ops/bls_batch/g1fft_jax.py:202", err20,
           k20_ms, plain20, h_products * to_ms, "operations",
           montgomery_products=h_products,
           shape=f"({L} residues, {N} positions), the dense blob's digits",
           product_latency_us=lat_us, chain_rounds=h_rounds,
           chain_floor_ms=h_rounds * lat_us / 1e3,
           replaces_also=["consensus_specs_tpu/ops/bls_batch/"
                          "g1fft_jax.py:314"])
    return {"fr_fft_64x128": (k18_ms, plain18)}


def _fk20_wrappers():
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    return [(FK, "fft_kernel"), (FK, "field_op_kernel"),
            (K, "g1_fft_kernel"), (K, "fk20_hext_kernel")]


def producer_path(dev):
    """`compute_cells_and_kzg_proofs` (FK20) on `bench.py:787-797`'s
    closed-form degree-65 blob: the cold call (the setup tables built
    first) and the median of DAS_PRODUCER_TIMED warm calls, the split
    into setup, K18, K15, K20, K19 and host, cells and proofs equal to
    the closed form.  Then the dense blob 0 of `bench.py` worker_kzg: all
    128 cells and proofs accepted by `verify_cell_proof_batch` as one
    batch, the proofs of columns 0 and 77 equal to
    `cell_proof_for_column` (K14 at 4032 points), one swapped proof
    rejected."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch import das as D
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.models.deneb import \
        polynomial_commitments as P

    blob, cells, proofs, _ = CV.closed_form_blob()
    DC._fk20_setup_tables.cache_clear()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = D.compute_cells_and_kzg_proofs(blob)
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    cold_counts = read_launches("das producer (cold)")
    if got != (cells, proofs):
        raise AssertionError("the producer's cells or proofs differ from "
                             "the closed form")
    DC._fk20_setup_tables.cache_clear()
    t0 = time.perf_counter()
    DC._fk20_setup_tables(dev)
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3

    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    if D.compute_cells_and_kzg_proofs(blob) != (cells, proofs):
        raise AssertionError("the warm producer call differs")
    torch.cuda.synchronize()
    main_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches("das producer")
    for name, want in (("fk20_hext", 1), ("g1_fft", 2)):
        if counts.get(name, 0) != want:
            raise AssertionError(f"the producer launched {name} "
                                 f"{counts.get(name, 0)} times")
    warm = [main_ms]
    for _ in range(DAS_PRODUCER_TIMED - 1):
        t0 = time.perf_counter()
        D.compute_cells_and_kzg_proofs(blob)
        torch.cuda.synchronize()
        warm.append((time.perf_counter() - t0) * 1e3)
    per = kernel_device_ms(lambda: D.compute_cells_and_kzg_proofs(blob),
                           _fk20_wrappers())
    device_total = sum(per.values())
    wall = statistics.median(warm)
    print(f"das producer compute_cells_and_kzg_proofs (closed-form "
          f"degree-65 blob, FK20): cold_ms={cold_ms:.4f} (setup tables "
          f"{setup_ms:.4f} ms) warm median_ms={wall:.4f} min_ms="
          f"{min(warm):.4f} max_ms={max(warm):.4f} device_ms="
          f"{device_total:.6f} (CUDA events around each launch in one "
          f"call: " + ", ".join(f"{k} {v:.6f}" for k, v in per.items())
          + f") host_ms={wall - device_total:.4f} proofs_per_s="
          f"{128 / wall * 1e3:.3f}; cells and proofs equal the closed form")

    # -- the dense blob: verify, the column route, a swapped proof -------------
    dense = CV.kzg_blobs(1)[0]
    t0 = time.perf_counter()
    d_cells, d_proofs = D.compute_cells_and_kzg_proofs(dense)
    torch.cuda.synchronize()
    dense_ms = (time.perf_counter() - t0) * 1e3
    com = bytes(P.blob_to_kzg_commitment(dense))
    idx = list(range(128))
    t0 = time.perf_counter()
    if D.verify_cell_proof_batch([com] * 128, idx, d_cells,
                                 d_proofs) is not True:
        raise AssertionError("the dense blob's cells and proofs were "
                             "rejected")
    verify_s = time.perf_counter() - t0
    swapped = list(d_proofs)
    swapped[0], swapped[1] = swapped[1], swapped[0]
    if D.verify_cell_proof_batch([com] * 128, idx, d_cells,
                                 swapped) is not False:
        raise AssertionError("a swapped proof was accepted")
    for k in (0, 77):
        if D.cell_proof_for_column(dense, k) != d_proofs[k]:
            raise AssertionError(f"the dense blob's proof {k} differs from "
                                 "cell_proof_for_column's")
    print(f"das producer (dense blob 0 of worker_kzg): {dense_ms:.4f} ms; "
          f"128 cells and proofs accepted by verify_cell_proof_batch in one "
          f"batch ({verify_s:.3f} s), a swapped proof rejected; columns 0 "
          f"and 77 equal cell_proof_for_column (K14 at 4032 points)")
    return counts, cold_counts, (dense, d_cells, d_proofs)


def recovery_path(dense):
    """`recover_cells_and_kzg_proofs` from the 64 even cells (the worst
    recoverable case, as `bench.py:834`) of the closed-form and the dense
    blob: cells and proofs equal to the closed form and the producer's,
    cold and warm times with the split into decode, re-evaluation and
    re-prove; 63 cells and a duplicate index rejected."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch import das as D

    blob, cells, proofs, _ = CV.closed_form_blob()
    _, d_cells, d_proofs = dense
    keep = list(range(0, 128, 2))
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    got = D.recover_cells_and_kzg_proofs(keep, [cells[k] for k in keep])
    torch.cuda.synchronize()
    cold_ms = (time.perf_counter() - t0) * 1e3
    counts = read_launches("das recovery")
    if got != (cells, proofs):
        raise AssertionError("recovery of the closed-form blob differs")
    for name in ("fr_fft", "fr_field_ops", "fk20_hext", "g1_fft"):
        if not counts.get(name):
            raise AssertionError(f"the recovery never launched {name}")
    if counts["fr_field_ops"] > 7:     # 5 decode products, the batch
        raise AssertionError(           # inverse, FK20's scalars
            f"the recovery launched K15 {counts['fr_field_ops']} times")
    walls, splits = [], []
    for _ in range(DAS_RECOVER_TIMED):
        tr = {}
        t0 = time.perf_counter()
        got = D.recover_cells_and_kzg_proofs(
            keep, [d_cells[k] for k in keep], trace=tr)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        splits.append(tr["seconds"])
        if got != (d_cells, d_proofs):
            raise AssertionError("recovery of the dense blob differs from "
                                 "the producer's output")
    for bad_idx in (keep[:63], keep[:1] + keep[:63]):
        try:
            D.recover_cells_and_kzg_proofs(bad_idx,
                                           [cells[k] for k in bad_idx])
        except AssertionError:
            continue
        raise AssertionError(f"recovery accepted {len(bad_idx)} cells with "
                             f"{len(set(bad_idx))} distinct indices")
    split = {k: statistics.median(s[k] for s in splits) * 1e3
             for k in splits[0]}
    print(f"das recovery recover_cells_and_kzg_proofs (64 even cells): "
          f"cold_ms={cold_ms:.4f} warm median_ms={statistics.median(walls):.4f}"
          f" min_ms={min(walls):.4f} max_ms={max(walls):.4f} split_median_ms "
          + json.dumps({k: round(v, 4) for k, v in split.items()})
          + "; both blobs equal to the closed form and the producer's "
          "output; 63 cells and a duplicate index rejected")
    return counts


def _fc_tensors(x: dict, dev) -> dict:
    import torch

    return {k: (torch.from_numpy(np.array(v, copy=True)).to(dev)
                if isinstance(v, np.ndarray) else v) for k, v in x.items()}


def check_fc_kernels(dev, record):
    """K21-K23 (`csrc/forkchoice.cu`) against their plain versions on the
    card at the mainnet shape (FC_MAINNET: 1024 blocks, 2**20
    validators, batches of 16384) on `forkchoice.synthetic.kernel_inputs`
    from SEED: a validator repeated over ten rows at one epoch (the first
    must win), 1/8 padded rows, equivocators, the boost, and a head
    decided by root words at the 2**31 boundary.  Zero tolerance outside
    the dummy slots.  Times each kernel, its plain version and, for K22,
    `index_add_`; each bound in bytes from this run's data."""
    import torch

    from consensus_specs_tpu_torch.forkchoice import kernels as FK
    from consensus_specs_tpu_torch.forkchoice import synthetic as FS

    _, nb, nv, b = FC_PATHS[-1]
    x = FS.kernel_inputs(nb, nv, b, seed=SEED)
    names = ("val_idx", "att_epoch", "att_block", "lm_epoch", "lm_block",
             "balance", "can_update", "node_weight")
    k, p, orig = (_fc_tensors(x, dev) for _ in range(3))
    acc = FK.fc_apply_kernel(*(k[n] for n in names))
    want = FK.fc_apply_plain(*(p[n] for n in names))
    err = require_equal("fc_apply", [acc, k["lm_epoch"][:nv],
                                     k["lm_block"][:nv],
                                     k["node_weight"][:nb]],
                        [want, p["lm_epoch"][:nv], p["lm_block"][:nv],
                         p["node_weight"][:nb]])
    if not bool(acc[0]) or bool(acc[1:10].any()) \
            or bool(acc[b - b // 8:].any()):
        raise AssertionError("fc_apply: the earliest row did not win alone, "
                             "or a padded row was accepted")
    if bool((acc & ~k["can_update"][k["val_idx"].long()]).any()):
        raise AssertionError("fc_apply: an equivocator's row was accepted")
    # FC_BATCHES batches back to back (`synthetic.apply_batches`: repeated
    # validators, winners rejected as older or as equivocators, padded
    # rows), the winner table all -1 after each
    xb, batches = FS.apply_batches(nb, nv, b, FC_BATCHES, seed=SEED)
    kb, pb = (_fc_tensors(xb, dev) for _ in range(2))
    table = FK.winner_table(dev, nv + 1)
    for rows in batches:
        rows = [torch.from_numpy(r).to(dev) for r in rows]
        got = FK.fc_apply_kernel(*rows, *(kb[n] for n in names[3:]))
        want_b = FK.fc_apply_plain(*rows, *(pb[n] for n in names[3:]))
        err = max(err, require_equal(
            "fc_apply (batches back to back)",
            [got, kb["lm_epoch"][:nv], kb["lm_block"][:nv],
             kb["node_weight"][:nb]],
            [want_b, pb["lm_epoch"][:nv], pb["lm_block"][:nv],
             pb["node_weight"][:nb]]))
        if not bool((table == -1).all()):
            raise AssertionError("fc_apply: the winner table is not all -1 "
                                 "after a batch")
    print(f"fc_apply: {FC_BATCHES} batches back to back equal to the plain "
          f"version, the winner table all -1 after each")

    def restore():
        for n in ("lm_epoch", "lm_block", "node_weight"):
            k[n].copy_(orig[n])

    apply_ms = device_ms(lambda: FK.fc_apply_kernel(*(k[n] for n in names)),
                         20, setup=restore)
    apply_plain = device_ms(
        lambda: FK.fc_apply_plain(*(k[n] for n in names)), 5, setup=restore)
    # the floor: an empty cooperative launch of K21's grid with its barrier
    floor_ms = device_ms(lambda: FK.fc_grid_barrier_probe(b, 1, dev), 20)
    live = x["att_epoch"] >= 0
    acc_np = acc.cpu().numpy()
    touched = np.unique(np.concatenate([
        x["lm_block"][x["val_idx"][acc_np]], x["att_block"][acc_np]]))
    k21_bytes = (b * (4 + 8 + 4 + 1)
                 + np.unique(x["val_idx"][live]).size * (8 + 4 + 8 + 1)
                 + int(acc_np.sum()) * (8 + 4)
                 + int((touched >= 0).sum()) * 8 * 2)
    record("fc_apply", "consensus_specs_tpu_torch/csrc/forkchoice.cu",
           "consensus_specs_tpu/forkchoice/kernels.py:75", err, apply_ms,
           apply_plain, k21_bytes / HBM_BYTES_PER_S * 1e3, "bytes",
           bound_bytes=int(k21_bytes), accepted=int(acc_np.sum()),
           launch_floor_ms=floor_ms,
           shape=f"B={b}, V={nv}, NB={nb}")

    lm_b, bal = orig["lm_block"], orig["balance"]
    ref = FK.fc_refresh_kernel(lm_b, bal, nb)
    err = require_equal("fc_refresh", ref[:nb],
                        FK.fc_refresh_plain(lm_b, bal, nb)[:nb])
    err = max(err, require_equal("fc_refresh(table)", ref[:nb],
                                 orig["node_weight"][:nb]))
    has = lm_b >= 0
    tgt = torch.where(has, lm_b.long(), nb)
    val = torch.where(has, bal, 0)
    lib = torch.zeros(nb + 1, dtype=torch.int64, device=dev).index_add_(
        0, tgt, val)
    err = max(err, require_equal("index_add_", ref[:nb], lib[:nb]))
    # the tables K22 meets: none voted (the paths' rebuild), half voted,
    # every vote on one block with balances that carry out of the low word
    # and wrap the high one; NB up to the shared-memory route's top and
    # past it (the global route); each twice in a row on one stream, the
    # accumulator zero after each call
    rng = np.random.RandomState(SEED + 22)
    edge = np.array([2**32 - 1, 2**32, 2**63 - 1, -2**63, -1, 3], np.int64)
    tables, edge_ms = {}, {}
    for nb_t in (64, nb, 16384, 32768):
        half = np.full(nv + 1, -1, np.int32)
        on = rng.rand(nv) < 0.5
        half[:nv][on] = rng.randint(0, nb_t, int(on.sum()))
        one = np.full(nv + 1, -1, np.int32)
        one[:nv] = 3
        for case, lm_np, bal_np in (
                ("empty", np.full(nv + 1, -1, np.int32), x["balance"]),
                ("half", half, x["balance"]),
                ("one", one, rng.choice(edge, nv + 1))):
            lm_t = torch.from_numpy(lm_np).to(dev)
            bal_t = torch.from_numpy(np.array(bal_np, np.int64)).to(dev)
            tables[nb_t, case] = (lm_t, bal_t)
            want = FK.fc_refresh_plain(lm_t, bal_t, nb_t)
            lib_t = torch.zeros(nb_t + 1, dtype=torch.int64,
                                device=dev).index_add_(
                0, torch.where(lm_t >= 0, lm_t.long(), nb_t),
                torch.where(lm_t >= 0, bal_t, 0))
            outs = []
            for rep in range(2):
                outs.append(FK.fc_refresh_kernel(lm_t, bal_t, nb_t))
                err = max(err, require_equal(
                    f"fc_refresh({case}, NB={nb_t}, call {rep})", outs[-1],
                    want))
                err = max(err, require_equal(
                    f"index_add_({case}, NB={nb_t})", outs[-1], lib_t))
                if bool(FK.refresh_accumulator(dev, nb_t + 1).any()):
                    raise AssertionError(f"fc_refresh({case}, NB={nb_t}): "
                                         "the next accumulator is not zero")
            # the second call left the first one's output alone
            err = max(err, require_equal(
                f"fc_refresh({case}, NB={nb_t}, call 0 after call 1)",
                outs[0], want))
    for (nb_t, case) in ((nb, "empty"), (nb, "one"), (16384, "half"),
                         (32768, "half")):
        lm_t, bal_t = tables[nb_t, case]
        edge_ms[f"{case}_nb{nb_t}_ms"] = device_ms(
            lambda: FK.fc_refresh_kernel(lm_t, bal_t, nb_t), 20)
    shared = [t for t in (64, nb, 16384, 32768)
              if FK._lib().fc_refresh_shared_bytes(t)]
    print(f"fc_refresh: empty, half-voted and one-block tables at NB = 64, "
          f"{nb}, 16384, 32768 (the shared route at NB = {shared}), twice "
          f"each, equal to the plain version and index_add_; "
          + ", ".join(f"{k} {v:.6f}" for k, v in edge_ms.items()))
    # the bytes this table needs: every lm_block, the balances of the rows
    # with a vote, the output
    k22_bytes = (nv + 1) * 4 + int((lm_b >= 0).sum()) * 8 + (nb + 1) * 8
    # the floor: the bytes, and one launch (an empty launch of K23's block)
    empty_launch_ms = device_ms(lambda: FK.fc_barrier_probe(0, dev), 20)
    record("fc_refresh", "consensus_specs_tpu_torch/csrc/forkchoice.cu",
           "consensus_specs_tpu/forkchoice/kernels.py:130", err,
           device_ms(lambda: FK.fc_refresh_kernel(lm_b, bal, nb), 50),
           device_ms(lambda: FK.fc_refresh_plain(lm_b, bal, nb), 10),
           k22_bytes / HBM_BYTES_PER_S * 1e3, "bytes",
           bound_bytes=int(k22_bytes), launch_floor_ms=empty_launch_ms,
           **edge_ms, shape=f"V={nv}, NB={nb}")
    library_ms = device_ms(
        lambda: torch.zeros(nb + 1, dtype=torch.int64,
                            device=dev).index_add_(0, tgt, val), 50)

    heads, err = [], 0
    zero = torch.zeros_like(orig["node_weight"])
    for w, bi, ba in ((orig["node_weight"], nb, 0),
                      (orig["node_weight"], x["boost_idx"], x["boost_amt"]),
                      (zero, nb, 0)):
        args = (orig["parent"], w, bi, ba, orig["real"],
                orig["block_epoch"], orig["je"], orig["uje"],
                orig["fin_ok"], orig["limbs"], x["sj"], x["sf"], x["cur"],
                x["justified_idx"])
        got = FK.fc_head_kernel(*args)
        err = max(err, require_equal("fc_head", got, FK.fc_head_plain(*args)))
        heads.append(int(got))
    if heads[2] != 4:
        raise AssertionError(f"fc_head: the root-word tie-break gave block "
                             f"{heads[2]}, not 4")
    case_ms = {}
    for nb_h in FC_HEAD_RUNGS:
        for case in FS.HEAD_CASES:
            h = _fc_tensors(FS.head_inputs(nb_h, case, seed=SEED), dev)
            hargs = tuple(h.values())
            got = FK.fc_head_kernel(*hargs)
            err = max(err, require_equal(f"fc_head {case} NB={nb_h}", got,
                                         FK.fc_head_plain(*hargs)))
            got = int(got)
            if (case in ("roots", "words") and got != 4) or (
                    case == "non_viable" and got in (1, 3, 4)):
                raise AssertionError(f"fc_head: case {case} at NB={nb_h} "
                                     f"gave block {got}")
            if (nb_h, case) in ((16384, "tree"), (1024, "full_chain")):
                case_ms[f"ms_{case}_{nb_h}"] = device_ms(
                    lambda a=hargs: FK.fc_head_kernel(*a), 20)
    args = (orig["parent"], orig["node_weight"], x["boost_idx"],
            x["boost_amt"], orig["real"], orig["block_epoch"], orig["je"],
            orig["uje"], orig["fin_ok"], orig["limbs"], x["sj"], x["sf"],
            x["cur"], x["justified_idx"])
    stats = torch.zeros(3, dtype=torch.int32, device=dev)
    FK.fc_head_kernel(*args, stats=stats)
    sums, ties, doubling = stats.tolist()
    phases = 2 + sums + 2 * ties + doubling
    probe = {n: device_ms(lambda n=n: FK.fc_barrier_probe(n, dev), 20)
             for n in (0, FC_PROBE_PHASES)}
    phase_us = (probe[FC_PROBE_PHASES] - probe[0]) / FC_PROBE_PHASES * 1e3
    k23_bytes = (nb + 1) * (4 + 8 + 1 + 3 * 8 + 1 + 8 * 8) + 4
    head_ms = device_ms(lambda: FK.fc_head_kernel(*args), 50)
    print(f"fc_head: NB={nb} {head_ms:.6f} ms, rounds (sums, tie-break, "
          f"doubling) {stats.tolist()}, {phases} dependent phases; an empty "
          f"barrier phase of its block {phase_us:.4f} us; "
          + ", ".join(f"{k} {v:.6f}" for k, v in case_ms.items())
          + f"; every head case equal to the plain version at NB in "
          f"{FC_HEAD_RUNGS}")
    record("fc_head", "consensus_specs_tpu_torch/csrc/forkchoice.cu",
           "consensus_specs_tpu/forkchoice/kernels.py:148", err, head_ms,
           device_ms(lambda: FK.fc_head_plain(*args), 10),
           k23_bytes / HBM_BYTES_PER_S * 1e3, "bytes",
           bound_bytes=int(k23_bytes), shape=f"NB={nb}", heads=heads,
           rounds=stats.tolist(), phases=phases,
           barrier_phase_us=phase_us,
           phase_floor_ms=phases * phase_us * 1e-3, **case_ms)
    return library_ms


def _fc_wrappers():
    from consensus_specs_tpu_torch.forkchoice import kernels as FK

    return [(FK, "fc_apply_kernel"), (FK, "fc_refresh_kernel"),
            (FK, "fc_head_kernel")]


def forkchoice_path(dev, name, n_blocks, n_validators, batch):
    """One fork-choice path through `ProtoArrayStore` on the card:
    `forkchoice.synthetic`'s seeded tree and attestation stream (the
    workload of `bench.py:897 worker_forkchoice`), FC_BATCHES batches,
    each applied and followed by `get_head`.  After every batch the head,
    the accepted count and the live weights must equal those of a second
    store built the same way that runs the plain versions on the card.
    Times each apply and each head poll (host clock, synchronised), the
    host parse of a batch apart, and, on a third store, each kernel's
    device time (CUDA events around each launch)."""
    import itertools

    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.forkchoice import synthetic as FS

    card, roots = FS.synthetic_store(n_blocks, n_validators, device=dev)
    plain, _ = FS.synthetic_store(n_blocks, n_validators, device=dev,
                                  plain=True)
    batches = list(itertools.islice(FS.attestation_stream(
        roots, n_validators, batch, seed=29), FC_BATCHES))
    torch.cuda.synchronize()
    _build.reset_launches()
    applies, polls, accepted = [], [], 0
    for bt in batches:
        t0 = time.perf_counter()
        n_card = card.apply_attestations(*bt)
        t1 = time.perf_counter()
        head = card.get_head()
        t2 = time.perf_counter()
        applies.append((t1 - t0) * 1e3)
        polls.append((t2 - t1) * 1e3)
        if n_card != plain.apply_attestations(*bt) \
                or head != plain.get_head() \
                or not np.array_equal(card.node_weights_device(),
                                      plain.node_weights_device()):
            raise AssertionError(f"{name}: the card store differs from the "
                                 "plain store")
        accepted += n_card
    counts = read_launches(name)
    if (counts.get("fc_apply"), counts.get("fc_head"),
            counts.get("fc_refresh")) != (FC_BATCHES, FC_BATCHES, 1):
        raise AssertionError(f"{name}: unexpected launches {counts}")
    parse = []
    for bt in batches:
        t0 = time.perf_counter()
        card._parse_batch(*bt)
        parse.append((time.perf_counter() - t0) * 1e3)
    timed, _ = FS.synthetic_store(n_blocks, n_validators, device=dev)

    def run():
        for bt in batches:
            timed.apply_attestations(*bt)
            timed.get_head()

    per = kernel_device_ms(run, _fc_wrappers())
    apply_ms, head_ms = statistics.median(applies), statistics.median(polls)
    print(f"{name} ({n_blocks} blocks x {n_validators} validators, "
          f"batches of {batch}, {FC_BATCHES} batches, {accepted} accepted): "
          f"apply median_ms={apply_ms:.4f} (min {min(applies):.4f}, max "
          f"{max(applies):.4f}; host parse median_ms="
          f"{statistics.median(parse):.4f}; K21 device_ms per batch="
          f"{per['fc_apply_kernel'] / FC_BATCHES:.6f}) head median_ms="
          f"{head_ms:.4f} (min {min(polls):.4f}, max {max(polls):.4f}; K23 "
          f"device_ms per poll={per['fc_head_kernel'] / FC_BATCHES:.6f}) "
          f"heads_per_s={1e3 / head_ms:.1f}; K22 device_ms (one rebuild)="
          f"{per['fc_refresh_kernel']:.6f}; head, accepted counts and "
          f"weights equal the plain store's after every batch")
    return counts


# --- slice 8: the sharded step, forest, batch and MSM ------------------------

def _virtual_mesh(dev, d: int):
    from consensus_specs_tpu_torch import parallel as P

    return P.make_mesh(devices=[dev] * d)


def _shard_step_inputs(mesh, reg, leaves):
    from consensus_specs_tpu_torch import parallel as P

    placed = P.shard_tree(mesh, {"pubkey_root": leaves.pubkey_root,
                                 "credentials": leaves.credentials})
    return (P.shard_registry(mesh, reg), [p["pubkey_root"] for p in placed],
            [p["credentials"] for p in placed])


def rlc_shard_products(n_live: int) -> int:
    """Montgomery products K25 must do on a shard of `n_live` live lanes:
    K9's lanes and fold without the shared lane, its sum kept Jacobian
    (`bls_products`' counts)."""
    from consensus_specs_tpu_torch.ops.bls.fields import BLS_X

    x_bits = abs(BLS_X).bit_length() - 1
    x_adds = bin(abs(BLS_X)).count("1") - 1
    lanes = max(n_live, 1)
    return (max(n_live - 1, 0) * 43
            + n_live * (x_bits * 41 + x_adds * 73)
            + (x_bits + x_adds) * (lanes - 1) * 54
            + x_bits * 36 + (x_bits + x_adds) * 54)


def combine_products(d: int) -> int:
    """K26's Montgomery products over d partials: d - 1 G2 additions, the
    affine conversion, one lane's Miller loop, d - 1 Fq12 products for
    the partials and one for the lane."""
    from consensus_specs_tpu_torch.ops.bls.fields import BLS_X, Q

    inv = (Q - 2).bit_length() - 1 + bin(Q - 2).count("1") - 1
    x_bits = abs(BLS_X).bit_length() - 1
    x_adds = bin(abs(BLS_X)).count("1") - 1
    return ((d - 1) * 43 + inv + 2 + 4 * 3 + 2
            + x_bits * (41 + 36 + 54) + x_adds * (73 + 54) + d * 54)


def check_sharded_kernels(dev, record, int32_ops_per_s):
    """The edge cases: K24 (the sweep's three phases on each shard) at
    SHARD_K24_N validators over SHARD_D shards with proposers in other
    shards, negative and out of range; K25 and K26 on SHARD_BLS_CHECK
    statements over SHARD_D shards (two of them padding only), then K26
    on two equal partials; K27 on an infinite and two equal partials;
    each against its plain version on the card.  K27's shape is the main
    path's (SHARD_D partials) and it is recorded here; K24, K25 and K26
    are checked and recorded again at the main path's shapes
    (`check_sweep_sharded_main`, `sharded_bls_path`).  Returns the max
    abs errors of K24, K25 and K26 here."""
    import random

    import torch

    from consensus_specs_tpu_torch import MAINNET, _build
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as curve
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.parallel import collectives as CO
    from consensus_specs_tpu_torch.parallel import epoch as E

    # -- K24: proposers in other shards, negative, at and past n D ----------
    n, d = SHARD_K24_N, SHARD_D
    reg_np = C.synthetic_registry(n, seed=SEED + 8)
    prop = reg_np["proposer_index"]
    prop[::5] = (np.arange(0, n, 5) + n // 2) % n
    prop[1::11] = -1
    prop[2::13] = -(n // d) - 3
    prop[3::17] = n
    prop[4::19] = -n - 1
    reg_np["exit_epoch"][::101] = 99
    reg_np["slashed"][::997] = True
    reg_np["withdrawable_epoch"][::997] = (
        100 + MAINNET.epochs_per_slashings_vector // 2)
    reg = C.registry_to_torch(reg_np, dev)
    mesh = _virtual_mesh(dev, d)
    regs = P.shard_registry(mesh, reg)
    err = 0
    for scal in (SCALARS, (100, 10, 10**13), (0, 0, 0)):
        sc = P.EpochScalars(*scal)
        err = max(err, check_sweep_phases(regs, sc, MAINNET, n, ""))
        bal, eff = E.epoch_sweep_sharded(regs, sc, MAINNET)
        err = max(err, require_equal(
            f"epoch_sweep_sharded{scal} against K1",
            [torch.cat(bal), torch.cat(eff)],
            list(E.epoch_sweep_kernel(reg, sc, MAINNET))))
    # every attester's proposer among HOT_PROPOSERS validators, at D = 2,
    # 4 and 8: the sweep against the plain sharded sweep and K1
    reg_np["proposer_index"] = C.hot_proposers(n, HOT_PROPOSERS, SEED)
    hot = C.registry_to_torch(reg_np, dev)
    sc = P.EpochScalars(*SCALARS)
    want = list(E.epoch_sweep_kernel(hot, sc, MAINNET))
    for w in SHARD_WIDTHS:
        hregs = P.shard_registry(_virtual_mesh(dev, w), hot)
        got = E.epoch_sweep_sharded(hregs, sc, MAINNET)
        plain = E.epoch_sweep_sharded(hregs, sc, MAINNET, plain=True)
        err = max(err, require_equal(
            f"epoch_sweep_sharded(hot proposers, D={w}) against K1",
            [torch.cat(got[0]), torch.cat(got[1])], want))
        err = max(err, require_equal(
            f"epoch_sweep_sharded(hot proposers, D={w}) against plain",
            [torch.cat(got[0]), torch.cat(got[1])],
            [torch.cat(plain[0]), torch.cat(plain[1])]))
    err24 = err
    print(f"K24 epoch_sweep_sharded at n={n}, D={d}: every phase equal to "
          f"its plain version on every shard, the sweep equal to K1 "
          f"(3 scalar sets); on {HOT_PROPOSERS} hot proposers at D in "
          f"{SHARD_WIDTHS} equal to K1 and the plain sharded sweep")

    # -- K25, K26: 16 statements over 4 shards, shards 2 and 3 padding ------
    tasks, _ = bls_tasks(SHARD_BLS_CHECK, BLS_COMMITTEE, BLS_SEED_BASE)
    per = B._bucket(-(-len(tasks) // d))
    arrays, n_live = B._prepare_rlc_inputs(
        tasks, random.Random(BLS_RNG_SEED), False, dev, lanes=d * per)
    fs, sums, err25, err8 = [], [], 0, 0
    for sh in range(d):
        t = [B._to(a[sh * per:(sh + 1) * per], dev) for a in arrays]
        pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = t
        k8_in = (pk_x, pk_y, sig_x, sig_y, r_bits, mask)
        apx, apy, a_inf, r_sig = K.rlc_scalar_mul_kernel(*k8_in)
        err8 = max(err8, k8_against_plain(
            f"K8 check shard {sh}", f"k8_check{sh}",
            (apx, apy, a_inf, r_sig), k8_in))
        args = (apx, apy, a_inf, r_sig, h_x, h_y, torch.ones_like(mask), mask)
        f, total = K.rlc_miller_shard_kernel(*args)
        if sh in (0, d - 1):                  # a live shard, a padding one
            pf, ptotal = B.rlc_miller_shard_plain(*args)
            err25 = max(err25, _canon_equal("rlc_miller_shard f", f, pf))
            for g, w in zip(total, ptotal):
                err25 = max(err25, _canon_equal("rlc_miller_shard sum", g, w))
        fs.append(f)
        sums.append(total)
    g_sums = tuple(CO.gather([s[k] for s in sums], dev) for k in range(3))
    g_fs = CO.gather(fs, dev)
    err26 = 0
    cases = (("padding shards", g_sums, g_fs),
             ("equal partials", tuple(torch.stack([c[0], c[0], c[1], c[2]])
                                      for c in g_sums),
              torch.stack([g_fs[0], g_fs[0], g_fs[1], g_fs[2]])))
    for label, gs, gf in cases:
        f26, s26 = K.rlc_shard_combine_kernel(gs, gf)
        pf, ps = B.rlc_shard_combine_plain(gs, gf)
        err26 = max(err26, _canon_equal(f"rlc_shard_combine f ({label})",
                                        f26, pf))
        for g, w in zip(s26, ps):
            err26 = max(err26, _canon_equal(
                f"rlc_shard_combine sum ({label})", g, w))
        if label == "padding shards":
            combined = f26
    # the combined f against the unsharded batch's K9 f, same scalars
    arrays1, _ = B._prepare_rlc_inputs(tasks, random.Random(BLS_RNG_SEED),
                                       False, dev)
    t = [B._to(a, dev) for a in arrays1]
    apx, apy, a_inf, r_sig = K.rlc_scalar_mul_kernel(*t[:4], t[6], t[7])
    f9, _ = K.rlc_miller_product_kernel(apx, apy, a_inf, r_sig, t[4], t[5],
                                        torch.ones_like(t[7]), t[7])
    require_equal("K26 f against the unsharded K9 f", combined, f9)
    print(f"K8, K25 rlc_miller_shard and K26 rlc_shard_combine on "
          f"{len(tasks)} statements over {d} shards of {per} lanes: equal "
          f"to their plain versions (K8 on every shard) (a live and a padding shard; padding "
          f"shards and equal partials); K26's f equals the unsharded K9 f")

    # -- K27: partials P, P, infinity, Q ------------------------------------
    pts = [curve.g1.mul(curve.G1_GEN, 7 + 3 * i) for i in range(2)]
    x, y = BC.g1_affine_to_limbs(pts)
    z = np.broadcast_to(F.ONE_MONT, x.shape).astype(np.int32)
    rows = [0, 0, None, 1]
    X = torch.from_numpy(np.stack([x[r if r is not None else 0]
                                   for r in rows])).to(dev)
    Y = torch.from_numpy(np.stack([y[r if r is not None else 0]
                                   for r in rows])).to(dev)
    Z = torch.from_numpy(np.stack([z[0] if r is not None else 0 * z[0]
                                   for r in rows])).to(dev)
    got = K.g1_shard_fold_kernel(X, Y, Z)
    want = B.g1_shard_fold_plain(X, Y, Z)
    err27 = max(_canon_equal("g1_shard_fold", g, w)
                for g, w in zip(got, want))
    expect = curve.g1.add(curve.g1.add(pts[0], pts[0]), pts[1])
    if not curve.g1.eq_points(BC.g1_limbs_to_oracle(got), expect):
        raise AssertionError("g1_shard_fold: not 2P + Q")
    k27_ms = device_ms(lambda: K.g1_shard_fold_kernel(X, Y, Z), 20)
    k27_plain = cuda_ms(lambda: B.g1_shard_fold_plain(X, Y, Z), 3)
    p27 = (d - 1) * 16
    record("g1_shard_fold", "consensus_specs_tpu_torch/csrc/bls_msm.cu",
           "consensus_specs_tpu/ops/bls_batch/__init__.py:484", err27,
           k27_ms, k27_plain, p27 * OPS_PER_MONT / int32_ops_per_s * 1e3,
           "operations", montgomery_products=p27,
           shape=f"D={d} partials (P, P, infinity, Q)")
    print("K27 g1_shard_fold on (P, P, infinity, Q): equal to its plain "
          "version and to 2P + Q")
    _build.reset_launches()
    return err24, err25, err26, err8


def rlc_edge_lanes(n: int, seed: int, dev, sig_inf: bool = False):
    """K9's and K25's inputs for n lanes from seeded scalars, as K8
    leaves them: r PK affine, the signature rows Jacobian (Z != 1), H
    affine; lane 1 masked (its signature row at infinity), lane 2 with
    r PK at infinity (limbs 0), lane 3 with H at infinity (h_ok False,
    limbs 0), where n reaches them; every signature row at infinity with
    `sig_inf` (the shared lane dead)."""
    import random

    import torch

    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import tower as tw

    r = random.Random(seed)
    pk = [curve.g1.mul(curve.G1_GEN, r.randrange(1, 2**64))
          for _ in range(n)]
    h = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64)) for _ in range(n)]
    sig = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64))
           for _ in range(n)]
    mask, a_inf, h_ok = np.ones(n, bool), np.zeros(n, bool), np.ones(n, bool)
    mask[1:2] = False
    a_inf[2:3] = True
    h_ok[3:4] = False
    sig = [curve.g2.infinity() if sig_inf or not m else s
           for s, m in zip(sig, mask)]
    apx, apy = BC.g1_affine_to_limbs(pk)
    hx, hy = BC.g2_affine_to_limbs(h)
    apx[a_inf] = apy[a_inf] = 0
    hx[~h_ok] = hy[~h_ok] = 0
    rows = tuple(np.stack([tw.fq2_from_oracle(s[c]) for s in sig])
                 for c in range(3))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(apx), t(apy), t(a_inf), tuple(map(t, rows)), t(hx), t(hy),
            t(h_ok), t(mask))


def check_rlc_edge_shapes(dev) -> int:
    """The per-lane Miller body's instances at edge shapes beside the
    main path's, each against its plain version on the card: K9 at
    RLC_EDGE_B lanes with dead lanes of each kind and at 4 lanes with
    every signature at infinity; K25 on one lane; K26 at D = 1 and on
    two equal partials.  (K9 at 128, K25 at 32 lanes
    and on padding shards, K26 at D = 4 with equal partials and K11 at
    1, 128 and 129 messages are held in `bls_path`,
    `check_sharded_kernels` and `sharded_bls_path`.)  Returns the max
    abs error."""
    import random

    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.bls_batch import tower as tw

    err, t0 = 0, time.perf_counter()
    for n, sig_inf in [(b, False) for b in RLC_EDGE_B] + [(4, True)]:
        args = rlc_edge_lanes(n, SEED + 40 + n, dev, sig_inf)
        f, s = K.rlc_miller_product_kernel(*args)
        pf, ps = B.rlc_miller_product_plain(*args)
        err = max(err, _canon_equal(f"K9 f at B={n}", f, pf),
                  *(_canon_equal(f"K9 sum at B={n}", g, w)
                    for g, w in zip(s, ps)))
        if bool(s[2].item()) != sig_inf:
            raise AssertionError(f"K9 at B={n}: s_inf {bool(s[2].item())}")
    args = rlc_edge_lanes(1, SEED + 39, dev)
    f, total = K.rlc_miller_shard_kernel(*args)
    pf, ptotal = B.rlc_miller_shard_plain(*args)
    err = max(err, _canon_equal("K25 f on one lane", f, pf),
              *(_canon_equal("K25 sum on one lane", g, w)
                for g, w in zip(total, ptotal)))
    r = random.Random(SEED + 38)
    pts = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64))
           for _ in range(2)]
    fs = torch.from_numpy(np.stack([F.to_mont(r.randrange(Q))
                                    for _ in range(24)]).reshape(
        2, 2, 3, 2, 33)).to(dev)
    cases = [("D=1", pts[:1], fs[:1]),
             ("D=2, equal partials", [pts[0]] * 2, fs[[0, 0]])]
    for label, p, f_parts in cases:
        sums = tuple(torch.from_numpy(np.stack(
            [tw.fq2_from_oracle(q[c]) for q in p])).to(dev)
            for c in range(3))
        f, s = K.rlc_shard_combine_kernel(sums, f_parts.contiguous())
        pf, ps = B.rlc_shard_combine_plain(sums, f_parts)
        err = max(err, _canon_equal(f"K26 f ({label})", f, pf),
                  *(_canon_equal(f"K26 sum ({label})", g, w)
                    for g, w in zip(s, ps)))
    print(f"rlc edge shapes: K9 at B={list(RLC_EDGE_B)} with dead lanes of "
          f"each kind and at B=4 with every signature at infinity, K25 on "
          f"one lane, K26 at D=1 and on two equal partials (D=2): equal "
          f"to their plain versions on the card "
          f"({time.perf_counter() - t0:.3f} s)")
    return err


def check_sweep_phases(regs, sc, params, n_global: int, label: str) -> int:
    """K24's three phases on every shard of `regs` against their plain
    versions, each on the same inputs: (a)'s sums and zeroed
    accumulators, (b)'s totals and accumulators (the kernel's all-reduced
    sums into both), (c)'s outputs (the plain totals and reduced slices
    into both).  Returns the max abs error."""
    from consensus_specs_tpu_torch.parallel import collectives as CO
    from consensus_specs_tpu_torch.parallel import epoch as E

    err = 0
    parts = [E.sweep_totals_kernel(r, sc, n_global) for r in regs]
    for r, part in zip(regs, parts):
        err = max(err, require_equal(f"epoch_sweep_sharded totals{label}",
                                     list(part),
                                     list(E.sweep_totals_plain(r, sc,
                                                               n_global))))
    sums = CO.all_reduce_sum([s for s, _ in parts])
    p_accs = [a.clone() for _, a in parts]
    p_totals = []
    for r, s, (_, a), pa in zip(regs, sums, parts, p_accs):
        got = E.sweep_shares_kernel(r, sc, params, s, a)
        p_totals.append(E.sweep_shares_plain(r, sc, params, s, pa))
        err = max(err, require_equal(f"epoch_sweep_sharded shares{label}",
                                     [got, a], [p_totals[-1], pa]))
    for r, t, got in zip(regs, p_totals, CO.reduce_scatter_sum(p_accs)):
        err = max(err, require_equal(
            f"epoch_sweep_sharded apply{label}",
            list(E.sweep_apply_kernel(r, sc, params, t, got)),
            list(E.sweep_apply_plain(r, sc, params, t, got))))
    return err


def check_sweep_sharded_main(dev, reg, sc, params, record, err_edges):
    """K24 at the main path's shape: the step's registry over SHARD_D
    shards, each phase on each shard against its plain version
    (`check_sweep_phases`), then the whole sharded sweep against the
    plain sharded sweep; timed there and recorded with the edge cases'
    error."""
    import torch

    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.parallel import epoch as E

    n, d = reg.balance.shape[0], SHARD_D
    regs = P.shard_registry(_virtual_mesh(dev, d), reg)
    err = max(err_edges, check_sweep_phases(regs, sc, params, n, " (main)"))
    kb, ke = E.epoch_sweep_sharded(regs, sc, params)
    pb, pe = E.epoch_sweep_sharded(regs, sc, params, plain=True)
    err = max(err, require_equal(
        "epoch_sweep_sharded (main) against the plain sharded sweep",
        [torch.cat(kb), torch.cat(ke)], [torch.cat(pb), torch.cat(pe)]))
    k24_ms = device_ms(lambda: E.epoch_sweep_sharded(regs, sc, params), 20)
    k24_kernel_ms = sum(kernel_device_ms(
        lambda: E.epoch_sweep_sharded(regs, sc, params),
        [(E, "sweep_totals_kernel"), (E, "sweep_shares_kernel"),
         (E, "sweep_apply_kernel")]).values())
    k24_plain = cuda_ms(
        lambda: E.epoch_sweep_sharded(regs, sc, params, plain=True), 2)
    # the function's bytes (each input read once, each output written
    # once) and the accumulators the sharded form must zero; the design's
    # passes move 28 + 14 + 76 bytes a row besides
    k24_bytes = n * (5 * 8 + 8 + 4 + 4 * 1 + 2 * 8) + 8 * n * d
    k24_moved = n * (28 + 14 + 76) + 8 * n * d
    print(f"K24 epoch_sweep_sharded at the main path's shape, n={n} over "
          f"D={d} shards: every phase equal to its plain version on every "
          f"shard, the sweep equal to the plain sharded sweep; "
          f"{k24_ms:.6f} ms device (collectives included), its kernels "
          f"{k24_kernel_ms:.6f} ms, the plain sharded sweep "
          f"{k24_plain:.6f} ms")
    record("epoch_sweep_sharded",
           "consensus_specs_tpu_torch/csrc/epoch_sweep.cu",
           "consensus_specs_tpu/parallel/partition.py:248", err,
           k24_kernel_ms, k24_plain, k24_bytes / HBM_BYTES_PER_S * 1e3,
           "bytes", sweep_with_collectives_ms=k24_ms,
           moved_bytes_ms=k24_moved / HBM_BYTES_PER_S * 1e3,
           shape=f"n={n} over D={d} shards (3 launches a shard, no memset)",
           replaces_also=["consensus_specs_tpu/parallel/epoch.py:111",
                          "consensus_specs_tpu/parallel/epoch.py:190",
                          "consensus_specs_tpu/parallel/merkle.py:117"])


def sharded_step_path(dev, reg, leaves, sc, params, want, n):
    """The full step over virtual meshes of SHARD_WIDTHS shards: every
    shard's outputs and every replica of both roots equal to the
    unsharded step's `want`; the launch counts of the SHARD_D run; the
    step's time beside the unsharded one and each phase's device time."""
    import torch

    from consensus_specs_tpu_torch import _build, make_epoch_step
    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.parallel import epoch as E
    from consensus_specs_tpu_torch.parallel import merkle as M

    single = make_epoch_step(params, device=dev)
    counts = None
    for d in SHARD_WIDTHS:
        mesh = _virtual_mesh(dev, d)
        regs, pks, creds = _shard_step_inputs(mesh, reg, leaves)
        step = P.make_sharded_epoch_step(mesh, params)
        torch.cuda.synchronize()
        _build.reset_launches()
        out = step(regs, sc, n, pks, creds)
        torch.cuda.synchronize()
        got = read_launches(f"sharded step D={d}")
        if d == SHARD_D:
            counts = got
        for name in ("epoch_sweep_sharded", "sha256_64B", "records_root"):
            if got.get(name, 0) <= 0:
                raise AssertionError(f"the sharded step never launched {name}")
        require_equal(f"sharded step D={d} balances",
                      [torch.cat(out[0]), torch.cat(out[1])], list(want[:2]))
        for r in out[2]:
            require_equal(f"sharded step D={d} balances root", r, want[2])
        for r in out[3]:
            require_equal(f"sharded step D={d} registry root", r, want[3])
        walls, single_walls = [], []
        for _ in range(SHARD_TIMED):
            for fn, acc in ((lambda: step(regs, sc, n, pks, creds), walls),
                            (lambda: single(reg, sc, n, leaves),
                             single_walls)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                acc.append((time.perf_counter() - t0) * 1e3)
        recs = [P.validator_records_root(
            P.ValidatorLeaves(pk, cr), e, r.slashed,
            r.activation_eligibility_epoch, r.activation_epoch, r.exit_epoch,
            r.withdrawable_epoch, M.shard_length(n, i, n // d))
            for i, (pk, cr, e, r) in enumerate(zip(pks, creds, out[1], regs))]
        parts = {
            "sweep_K24": cuda_ms(
                lambda: E.epoch_sweep_sharded(regs, sc, params), 10),
            "balances_root_K2": cuda_ms(
                lambda: P.balances_list_root_sharded(out[0], n), 10),
            "records_K3": cuda_ms(lambda: [P.validator_records_root(
                P.ValidatorLeaves(pk, cr), e, r.slashed,
                r.activation_eligibility_epoch, r.activation_epoch,
                r.exit_epoch, r.withdrawable_epoch)
                for pk, cr, e, r in zip(pks, creds, out[1], regs)], 10),
            "registry_root_K2": cuda_ms(
                lambda: P.validator_registry_root_sharded(recs, n), 10),
        }
        print(f"sharded step: n={n} D={d} median_ms="
              f"{statistics.median(walls):.4f} min_ms={min(walls):.4f} "
              f"max_ms={max(walls):.4f} unsharded_median_ms="
              f"{statistics.median(single_walls):.4f} (in turns, host "
              f"clock); phases (device ms, CUDA events): "
              + json.dumps({k: round(v, 6) for k, v in parts.items()}))
    return counts


def sharded_forest_path(dev, balances, n):
    """A `ShardedMerkleForest` of the n balances over SHARD_D shards: its
    root equal to the single forest's, a 1% dirty update (bench.py
    worker_epoch's dirty set) applied to both, roots equal and equal to a
    rebuild, N_PROOFS proofs across the shards verified."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch import parallel as P

    _, _, dirty = C.incremental_step_inputs(n)
    dirty_t = torch.from_numpy(dirty).to(dev)
    bal2 = balances.clone()
    bal2[dirty_t] += 1_000_000_007
    chunks = P.dirty_chunks_from_validators(dirty).to(dev)
    words = P.dirty_balance_leaves(bal2, chunks)
    forest = P.sharded_balances_forest(balances, n,
                                       devices=[dev] * SHARD_D)
    single = P.balances_forest(balances, n, device=dev)
    if forest.root_bytes() != single.root_bytes():
        raise AssertionError("sharded forest: root differs from the forest's")
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    forest.update(chunks, words)
    root = forest.root_bytes()
    update_ms = (time.perf_counter() - t0) * 1e3
    rng = np.random.RandomState(SEED + 9)
    idx = sorted(set(rng.randint(0, forest.n_chunks, N_PROOFS).tolist()))
    proofs = forest.emit_proofs(idx)
    torch.cuda.synchronize()
    counts = read_launches("sharded forest")
    # the update's dense tail is K4's: K2 builds the shards only
    for name in ("update_level", "proof_paths"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"the sharded forest never launched {name}")
    single.update(chunks, words)
    if root != single.root_bytes() or root != P.balances_forest(
            bal2, n, device=dev).root_bytes():
        raise AssertionError("sharded forest: root after the update differs")
    if not all(P.verify_proof(p, root) for p in proofs):
        raise AssertionError("sharded forest: a proof does not verify")
    walls = []
    for _ in range(SHARD_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forest.update(chunks, words)
        forest.root_bytes()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"sharded forest: n={n} balances over {SHARD_D} shards "
          f"({forest.n_chunks} chunks, local depth {forest.local_depth}); "
          f"{len(dirty)} dirty validators ({chunks.shape[0]} chunks): root "
          f"equal to the single forest's and a rebuild; {len(proofs)} proofs "
          f"verified; update+root first_ms={update_ms:.4f} median_ms="
          f"{statistics.median(walls):.4f}")
    return counts


def sharded_bls_path(dev, record, int32_ops_per_s, err25, err26):
    """`batch_verify_sharded` on config #2's statements over SHARD_D
    shards (host hashing): accepted, its K26 f equal to the unsharded
    host-hashed batch's K9 f under the same scalars (one unsharded run,
    timed), a wrong key rejected; SHARD_TIMED timed runs and one with
    each kernel's device time.  K25 and K26 at this path's shapes: every
    shard's K25 equal to the batch's partials, shard 0 against the plain
    K25, K26 on the batch's gathered partials equal to the batch's f and
    to the plain K26; both timed there and recorded with the edge
    cases' errors `err25`, `err26`."""
    import random

    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as curve
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    tasks, _ = bls_tasks(BLS_TASKS, BLS_COMMITTEE, BLS_SEED_BASE)
    devices = [dev] * SHARD_D

    def sharded(trace=None, t=tasks):
        return B.batch_verify_sharded(t, rng=random.Random(BLS_RNG_SEED),
                                      devices=devices, trace=trace)

    def unsharded(trace=None):
        return B.batch_verify(tasks, rng=random.Random(BLS_RNG_SEED),
                              device=dev, device_h2c=False, trace=trace)

    def timed(fn, acc, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        acc.append((time.perf_counter() - t0) * 1e3)
        return out

    walls, single_walls, tr, tr1 = [], [], {}, {}
    _build.reset_launches()
    ok = timed(sharded, walls, tr)
    counts = read_launches("sharded bls batch")
    for name in ("rlc_scalar_mul", "rlc_miller_shard", "rlc_shard_combine",
                 "final_exp_is_one"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"the sharded batch never launched {name}")
    if ok is not True:
        raise AssertionError("the sharded batch rejected config #2")
    # K25 and K26 at this path's shapes, on this batch's inputs
    per = B._bucket(-(-len(tasks) // SHARD_D))
    arrays, _ = B._prepare_rlc_inputs(tasks, random.Random(BLS_RNG_SEED),
                                      False, dev, lanes=SHARD_D * per)
    err8 = 0
    for sh in range(SHARD_D):
        t = [B._to(a[sh * per:(sh + 1) * per], dev) for a in arrays]
        pk_x, pk_y, sig_x, sig_y, h_x, h_y, r_bits, mask = t
        k8_in = (pk_x, pk_y, sig_x, sig_y, r_bits, mask)
        apx, apy, a_inf, r_sig = K.rlc_scalar_mul_kernel(*k8_in)
        err8 = max(err8, k8_against_plain(
            f"K8 shard {sh}", f"k8_shard{sh}", (apx, apy, a_inf, r_sig),
            k8_in))
        args = (apx, apy, a_inf, r_sig, h_x, h_y, torch.ones_like(mask), mask)
        f, total = K.rlc_miller_shard_kernel(*args)
        _canon_equal(f"K25 shard {sh} against the batch's partial f", f,
                     tr["partial_f"][sh])
        for k in range(3):
            _canon_equal(f"K25 shard {sh} against the batch's partial sum",
                         total[k], tr["partial_sums"][k][sh])
        if sh == 0:
            shard0, f0, total0 = args, f, total
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf, ptotal = B.rlc_miller_shard_plain(*shard0)
    torch.cuda.synchronize()
    k25_plain = (time.perf_counter() - t0) * 1e3
    err25 = max(err25, _canon_equal("rlc_miller_shard f (config #2)", f0,
                                    pf))
    for g, w in zip(total0, ptotal):
        err25 = max(err25, _canon_equal("rlc_miller_shard sum (config #2)",
                                        g, w))
    k25_ms = device_ms(lambda: K.rlc_miller_shard_kernel(*shard0), 3)
    gs, gf = tr["partial_sums"], tr["partial_f"]
    f26, s26 = K.rlc_shard_combine_kernel(gs, gf)
    _canon_equal("K26 against the batch's f", f26, tr["miller"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pf, ps = B.rlc_shard_combine_plain(gs, gf)
    torch.cuda.synchronize()
    k26_plain = (time.perf_counter() - t0) * 1e3
    err26 = max(err26, _canon_equal("rlc_shard_combine f (config #2)", f26,
                                    pf))
    for g, w in zip(s26, ps):
        err26 = max(err26, _canon_equal("rlc_shard_combine sum (config #2)",
                                        g, w))
    k26_ms = device_ms(lambda: K.rlc_shard_combine_kernel(gs, gf), 3)
    live0 = int(arrays[7][:per].sum())
    p25, p26 = rlc_shard_products(live0), combine_products(SHARD_D)
    print(f"K8 on each of the {SHARD_D} shards of this batch ({per} lanes) "
          f"equal to its plain version; K25 on shard 0 ({live0} live) "
          f"equal to its plain version, every shard's K25 equal to the "
          f"batch's partials; K26 on the batch's {SHARD_D} partials equal to its "
          f"plain version and to the batch's f")
    record("rlc_miller_shard", "consensus_specs_tpu_torch/csrc/bls_shard.cu",
           "consensus_specs_tpu/ops/bls_batch/__init__.py:711", err25,
           k25_ms, k25_plain, p25 * OPS_PER_MONT / int32_ops_per_s * 1e3,
           "operations", montgomery_products=p25,
           shape=f"shard 0 of config #2 over D={SHARD_D}: {per} lanes, "
                 f"{live0} live")
    record("rlc_shard_combine",
           "consensus_specs_tpu_torch/csrc/bls_shard.cu",
           "consensus_specs_tpu/ops/bls_batch/__init__.py:711", err26,
           k26_ms, k26_plain, p26 * OPS_PER_MONT / int32_ops_per_s * 1e3,
           "operations", montgomery_products=p26,
           shape=f"config #2's D={SHARD_D} partials")

    if timed(unsharded, single_walls, tr1) is not True:
        raise AssertionError("the unsharded host-hashed batch rejected")
    require_equal("sharded batch f against the unsharded K9 f",
                  F.fq_canon(tr["miller"]), F.fq_canon(tr1["miller"]))
    bad = list(tasks)
    pk, msg, sig = bad[len(bad) // 3]
    bad[len(bad) // 3] = (curve.g1.add(pk, curve.G1_GEN), msg, sig)
    if sharded(t=bad) is not False:
        raise AssertionError("the sharded batch accepted a wrong key")
    for _ in range(SHARD_TIMED - 1):
        timed(sharded, walls)
    per = kernel_device_ms(sharded, [
        (K, "rlc_scalar_mul_kernel"), (K, "rlc_miller_shard_kernel"),
        (K, "rlc_shard_combine_kernel"), (K, "final_exp_is_one_kernel")])
    device = sum(per.values())
    wall = statistics.median(walls)
    print(f"sharded bls batch: {len(tasks)} statements over {SHARD_D} shards "
          f"(host hashing): accepted, f equal to the unsharded K9 f, a wrong "
          f"key rejected; first_ms={walls[0]:.4f} median_ms={wall:.4f} "
          f"min_ms={min(walls):.4f} max_ms={max(walls):.4f} "
          f"unsharded_ms={single_walls[0]:.4f} (one run, between the first "
          f"two sharded; the bls batch phase's host-hashing median is the "
          f"unsharded median); device_ms={device:.6f} ("
          + ", ".join(f"{k} {v:.6f}" for k, v in per.items())
          + f") host_ms={wall - device:.4f}")
    return counts, err8


def sharded_msm_path(dev):
    """`g1_multi_exp_sharded` on bench_bls's probe at SHARD_MSM points over
    SHARD_D shards (K13 per shard, K27): equal to the oracle's `g1.msm`
    and to `g1_multi_exp_device`; timed beside it."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs
    from consensus_specs_tpu_torch.ops.bls.curve import R, g1

    pts = [g1.mul(cs.G1_GEN, 3 * i + 2) for i in range(SHARD_MSM)]
    ks = [pow(5, i + 1, R) for i in range(SHARD_MSM)]
    want = g1.msm(pts, ks)
    devices = [dev] * SHARD_D

    def timed(fn, acc):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        acc.append((time.perf_counter() - t0) * 1e3)
        return out

    def sharded():
        return B.g1_multi_exp_sharded(pts, ks, devices=devices)

    def unsharded():
        return B.g1_multi_exp_device(pts, ks, device=dev)

    walls, single_walls = [], []
    _build.reset_launches()
    got = timed(sharded, walls)
    counts = read_launches("sharded msm")
    for name in ("msm_pippenger", "g1_shard_fold"):
        if counts.get(name, 0) <= 0:
            raise AssertionError(f"the sharded MSM never launched {name}")
    single = timed(unsharded, single_walls)
    if not (g1.eq_points(got, want) and g1.eq_points(single, want)):
        raise AssertionError("the sharded MSM differs from the oracle")
    for _ in range(SHARD_TIMED - 1):
        timed(unsharded, single_walls)
        timed(sharded, walls)
    print(f"sharded msm: n={SHARD_MSM} over {SHARD_D} shards (per shard "
          f"{B._bucket(SHARD_MSM // SHARD_D)}, c="
          f"{B._msm_window(B._bucket(SHARD_MSM // SHARD_D))}): equal to the "
          f"oracle and g1_multi_exp_device; median_ms="
          f"{statistics.median(walls):.4f} unsharded_median_ms="
          f"{statistics.median(single_walls):.4f} (in turns)")
    return counts


def sharded_das_path(dev):
    """The DAS verify with its MSMs over a 2-shard mesh, on the
    closed-form matrix's first SHARD_DAS_COLUMNS columns: accepted, and
    rejected with a tampered cell."""
    import torch

    from consensus_specs_tpu_torch import _build
    from consensus_specs_tpu_torch import das as D
    from consensus_specs_tpu_torch.das import ciphersuite as cs

    com, idx, cells, proofs = cs.closed_form_matrix(
        DAS_BLOBS, columns=range(SHARD_DAS_COLUMNS))
    devices = [dev] * 2
    torch.cuda.synchronize()
    _build.reset_launches()
    ok = D.verify_cell_proof_batch(com, idx, cells, proofs, device=dev,
                                   devices=devices)
    torch.cuda.synchronize()
    counts = read_launches("sharded das verify")
    if ok is not True or counts.get("g1_shard_fold", 0) <= 0:
        raise AssertionError("the DAS verify over 2 shards failed")
    bad = list(cells)
    bad[3] = bytes(bad[3][:-1]) + bytes([bad[3][-1] ^ 1])
    if D.verify_cell_proof_batch(com, idx, bad, proofs, device=dev,
                                 devices=devices) is not False:
        raise AssertionError("the DAS verify over 2 shards accepted a "
                             "tampered cell")
    print(f"sharded das verify: {len(idx)} cells, MSMs over 2 shards: "
          f"accepted; a tampered cell rejected")
    return counts


def real_cards_path(reg, leaves, sc, params, want, n):
    """Steps 2-5 of slice 8 once more over real cards, when there are at
    least two: the step, the forest, the batch and the MSM on
    `device_ids` over a power of two of them."""
    import random

    import torch

    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs
    from consensus_specs_tpu_torch.ops.bls.curve import R, g1

    count = torch.cuda.device_count()
    if count < 2:
        print(f"real cards: {count} card, so only virtual meshes ran")
        return
    ids = tuple(range(P.mesh_rung(count)))
    mesh = P.build_mesh(device_ids=ids, require_pow2=True)
    regs, pks, creds = _shard_step_inputs(mesh, reg, leaves)
    out = P.make_sharded_epoch_step(mesh, params)(regs, sc, n, pks, creds)
    require_equal("real-card step", [torch.cat([o.cpu() for o in out[0]]),
                                     torch.cat([o.cpu() for o in out[1]])],
                  [w.cpu() for w in want[:2]])
    for k in (2, 3):
        for r in out[k]:
            require_equal("real-card step root", r.cpu(), want[k].cpu())
    forest = P.sharded_balances_forest(want[0], n, device_ids=ids)
    if forest.root_bytes() != P.balances_forest(
            want[0], n, device=want[0].device).root_bytes():
        raise AssertionError("real-card forest: root differs")
    tasks, _ = bls_tasks(SHARD_BLS_CHECK, BLS_COMMITTEE, BLS_SEED_BASE)
    if B.batch_verify_sharded(tasks, rng=random.Random(BLS_RNG_SEED),
                              device_ids=ids) is not True:
        raise AssertionError("real-card batch rejected")
    pts = [g1.mul(cs.G1_GEN, 3 * i + 2) for i in range(64)]
    ks = [pow(5, i + 1, R) for i in range(64)]
    if not g1.eq_points(B.g1_multi_exp_sharded(pts, ks, device_ids=ids),
                        g1.msm(pts, ks)):
        raise AssertionError("real-card MSM differs")
    print(f"real cards: step, forest, batch and MSM over device_ids={ids}: "
          f"equal")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1

    from consensus_specs_tpu_torch import MAINNET, _build, make_epoch_step
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch.ops import sha256 as S
    from consensus_specs_tpu_torch.parallel import EpochScalars
    from consensus_specs_tpu_torch.parallel import epoch as E
    from consensus_specs_tpu_torch.parallel import merkle as M

    dev = torch.device("cuda:0")
    card = smi("name,power.limit")
    print(f"card: {card}")
    # the G1 FFT phase's plain K19 (and the edges' K20) run on the CPU, in
    # worker processes below nvcc and the card's phases
    import multiprocessing

    from consensus_specs_tpu_torch.das import compute as DC

    tasks = {("rows", r): (g1fft_plain_rows, (r,))
             for r in range(0, DC.L, G1_PLAIN_ROWS)}
    tasks["inverse"] = (g1fft_plain_inverse, ())
    tasks["edge"] = (g1fft_edge_plain, ())
    tasks["msm_edge"] = (msm_edge_plain, ())
    EDGE["pool"] = multiprocessing.get_context("spawn").Pool(
        len(tasks), initializer=_plain_worker_init)
    for key, (fn, args) in tasks.items():
        EDGE[key] = EDGE["pool"].apply_async(fn, args)
    max_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_ops_per_s = n_sm * INT32_LANES_PER_SM * max_clock_hz
    print(f"sms: {n_sm}  max_sm_clock_mhz: {max_clock_hz / 1e6:.0f}  "
          f"int32_ops_per_s: {int32_ops_per_s:.4g}")

    t_phase = [time.perf_counter()]

    def phase(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - t_phase[0]:.3f} s")
        t_phase[0] = now

    # -- build: one nvcc per source, all started together; every timed
    #    phase runs after the last of them has finished ------------------
    t_build = time.perf_counter()

    def finish_build(names, built):
        print(f"build {list(names)}: {time.perf_counter() - t_build:.3f} s "
              f"{json.dumps({k: round(v, 3) for k, v in built.items()})}")
        for name in names:
            log = (_build.BUILD_DIR / f"{name}.log")
            if log.exists():
                for line in log.read_text().splitlines():
                    if ("registers" in line or "spill" in line
                            or "entry function" in line):
                        print(f"ptxas {name}: {line.strip()}")
        for name in names:
            _build.load(name)

    names = tuple(_build.SOURCES)
    built, failed = {}, []

    def run_build():
        try:
            built.update(_build.build(names))
        except BaseException as e:  # re-raised below
            failed.append(e)

    builder = threading.Thread(target=run_build)
    builder.start()
    try:
        t0 = time.perf_counter()
        precompute_plain(dev)
        print(f"plain references {sorted(PLAIN)} computed on the card "
              f"while nvcc ran: {time.perf_counter() - t0:.3f} s")
    finally:
        builder.join()
    if failed:
        raise failed[0]
    finish_build(names, built)
    mix = sha_message_mix()
    print(f"sha256 message (SASS of sha256_64B_kernel): alu {mix['alu']} "
          f"fma {mix['fma']} either {mix['either']}: {ops_per_message()} "
          f"lane-clocks; opcodes "
          f"{json.dumps(mix['opcodes'], sort_keys=True)}")
    phase("build")

    # -- inputs: the flagship's synthetic mainnet registry, from SEED -----
    n = N_VALIDATORS
    reg_np = C.synthetic_registry(n, seed=SEED)
    reg = C.registry_to_torch(reg_np, dev)
    leaves = C.leaves_to_torch(*C.synthetic_leaf_words(n), dev)
    sc = EpochScalars(*SCALARS)
    params = MAINNET
    torch.cuda.synchronize()

    kernels = {}

    def record(name, source, replaces, err, ms, plain_ms, bound_ms,
               bound_by, **extra):
        kernels[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None, **extra)

    # -- K1: the sweep at N = 2**20 ----------------------------------------
    k1 = E.epoch_sweep_kernel(reg, sc, params)
    p1 = E.epoch_sweep_plain(reg, sc, params)
    err = require_equal("epoch_sweep", k1, p1)
    # the other branches, on a copy with finite exits, slashing hits,
    # late activations and proposer indices outside [0, N)
    odd = dict(reg_np)
    odd["exit_epoch"] = odd["exit_epoch"].copy()
    odd["exit_epoch"][::101] = 99
    odd["exit_epoch"][1::101] = 100
    odd["activation_epoch"] = odd["activation_epoch"].copy()
    odd["activation_epoch"][2::101] = 103
    odd["slashed"] = odd["slashed"].copy()
    odd["slashed"][::997] = True
    odd["withdrawable_epoch"] = odd["withdrawable_epoch"].copy()
    odd["withdrawable_epoch"][::997] = 100 + params.epochs_per_slashings_vector // 2
    odd["proposer_index"] = odd["proposer_index"].copy()
    odd["proposer_index"][::4099] = n + 17
    odd["proposer_index"][1::4099] = -3
    odd_reg = C.registry_to_torch(odd, dev)
    for scal in (SCALARS, (100, 10, 10**13), (0, 0, 0), (1, 0, 5 * 10**11)):
        s2 = EpochScalars(*scal)
        err = max(err, require_equal(
            f"epoch_sweep{scal}", E.epoch_sweep_kernel(odd_reg, s2, params),
            E.epoch_sweep_plain(odd_reg, s2, params)))
    # the edges of the exact divisions and the saturations: effective
    # balances 0, 1, incr - 1, 2**64 - 1, delays 0, 1, 2**64 - 1, one
    # active validator, slashings that make adj the whole active balance
    for single in (False, True):
        edge = C.registry_to_torch(C.edge_registry(n, single_active=single),
                                   dev)
        for scal in (SCALARS, (100, 2, 2**63), (100, 9, 2**64 - 1),
                     (0, 0, 0)):
            s2 = EpochScalars(*scal)
            err = max(err, require_equal(
                f"epoch_sweep(edge registry, single_active={single}, {scal})",
                E.epoch_sweep_kernel(edge, s2, params),
                E.epoch_sweep_plain(edge, s2, params)))
        del edge
    k1_bytes = n * (5 * 8 + 8 + 4 + 4 * 1 + 2 * 8)
    record("epoch_sweep", "consensus_specs_tpu_torch/csrc/epoch_sweep.cu",
           "consensus_specs_tpu/parallel/epoch.py:140", err,
           device_ms(lambda: E.epoch_sweep_kernel(reg, sc, params), 50),
           cuda_ms(lambda: E.epoch_sweep_plain(reg, sc, params), 5),
           k1_bytes / HBM_BYTES_PER_S * 1e3, "bytes",
           # its three passes' traffic: 36 + 14 + 76 bytes a validator
           moved_bytes_ms=n * 126 / HBM_BYTES_PER_S * 1e3)
    new_bal, new_eff = k1

    # -- K3: the record roots at N = 2**20 ---------------------------------
    rec_args = (leaves, new_eff, reg.slashed, reg.activation_eligibility_epoch,
                reg.activation_epoch, reg.exit_epoch, reg.withdrawable_epoch,
                n)
    k3 = M.validator_records_root_kernel(*rec_args)
    p3 = M.validator_records_root_plain(*rec_args)
    err = require_equal("records_root", k3, p3)
    short = rec_args[:-1] + (n - 12345,)      # pad rows masked in the pass
    err = max(err, require_equal(
        "records_root(length<N)", M.validator_records_root_kernel(*short),
        M.validator_records_root_plain(*short)))
    k3_ops = 7 * n * ops_per_message()
    k3_bytes = n * (32 + 32 + 8 + 1 + 4 * 8 + 32)
    k3_bound = max(k3_ops / int32_ops_per_s, k3_bytes / HBM_BYTES_PER_S)
    record("records_root", "consensus_specs_tpu_torch/csrc/records_root.cu",
           "consensus_specs_tpu/parallel/merkle.py:157", err,
           device_ms(lambda: M.validator_records_root_kernel(*rec_args), 20),
           cuda_ms(lambda: M.validator_records_root_plain(*rec_args), 2),
           k3_bound * 1e3, "operations")

    # -- K2: a 2**17-message level of the registry tree, leaf mode over
    #    the 2**20 new balances, and a one-message ladder step ------------
    msgs = n // 8                               # 2**17 at N = 2**20
    level = k3[: 2 * msgs].reshape(msgs, 16)
    err = require_equal("sha256_64B", S.sha256_64B_words_kernel(level),
                        S.sha256_64B_words_plain(level))
    one = level[:1].clone()
    err = max(err, require_equal("sha256_64B(N=1)",
                                 S.sha256_64B_words_kernel(one),
                                 S.sha256_64B_words_plain(one)))
    err = max(err, require_equal(
        "sha256_u64_leaves", S.sha256_u64_leaves_kernel(new_bal),
        M.hash_u64_leaves(new_bal, plain=True)))
    odd_vals = new_bal[: msgs + 3].clone()      # a ragged tail, zero-padded
    err = max(err, require_equal(
        "sha256_u64_leaves(ragged)", S.sha256_u64_leaves_kernel(odd_vals),
        M.hash_u64_leaves(odd_vals, plain=True)))
    k2_bound = max(msgs * ops_per_message() / int32_ops_per_s,
                   msgs * 96 / HBM_BYTES_PER_S)
    leaf_msgs = n // 8
    leaf_bound = max(leaf_msgs * ops_per_message() / int32_ops_per_s,
                     (n * 8 + leaf_msgs * 32) / HBM_BYTES_PER_S)
    record("sha256_64B", "consensus_specs_tpu_torch/csrc/sha256.cu",
           "consensus_specs_tpu/ops/sha256_jax.py:100", err,
           device_ms(lambda: S.sha256_64B_words_kernel(level), 50),
           cuda_ms(lambda: S.sha256_64B_words_plain(level), 3),
           k2_bound * 1e3, "operations",
           messages=msgs,
           leaf_mode_ms=device_ms(
               lambda: S.sha256_u64_leaves_kernel(new_bal), 50),
           leaf_mode_plain_ms=cuda_ms(
               lambda: M.hash_u64_leaves(new_bal, plain=True), 3),
           leaf_mode_bound_ms=leaf_bound * 1e3)

    # -- the main path: one epoch step at 2**20 validators ----------------
    step = make_epoch_step(params, device=dev)
    plain_step = make_epoch_step(params, device=dev, plain=True)
    torch.cuda.synchronize()
    _build.reset_launches()
    out = step(reg, sc, n, leaves)
    torch.cuda.synchronize()
    full_counts = read_launches("full step")
    for name in ("epoch_sweep", "sha256_64B", "records_root"):
        if full_counts.get(name, 0) <= 0:
            raise AssertionError(f"the full step never launched {name}")
    want = plain_step(reg, sc, n, leaves)
    require_equal("epoch step", list(out), list(want))
    new_bal, new_eff, bal_root, reg_root = out
    if new_bal.shape != (n,) or bal_root.shape != (8,) or \
            reg_root.shape != (8,):
        raise AssertionError("epoch step: unexpected output shapes")
    print("balances_root: " + C.words_to_numpy(bal_root).astype(">u4")
          .tobytes().hex())
    print("registry_root: " + C.words_to_numpy(reg_root).astype(">u4")
          .tobytes().hex())

    # step time: host clock around a synchronised step, median of 9
    step(reg, sc, n, leaves)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    walls = []
    for _ in range(9):
        t0 = time.perf_counter()
        step(reg, sc, n, leaves)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    plain_walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        plain_step(reg, sc, n, leaves)
        torch.cuda.synchronize()
        plain_walls.append((time.perf_counter() - t0) * 1e3)
    # device time of each stage of the step, from CUDA events
    parts = {
        "sweep_K1": cuda_ms(lambda: E.epoch_sweep(reg, sc, params), 20),
        "balances_root_K2": cuda_ms(
            lambda: M.balances_list_root(new_bal, n), 20),
        "records_K3": cuda_ms(
            lambda: M.validator_records_root(*rec_args), 20),
        "registry_root_K2": cuda_ms(
            lambda: M.validator_registry_root(k3, n), 20),
    }
    print(f"step: n={n} median_ms={statistics.median(walls):.4f} "
          f"min_ms={min(walls):.4f} max_ms={max(walls):.4f} "
          f"plain_median_ms={statistics.median(plain_walls):.4f} "
          f"peak_mem_bytes={peak}")
    print("step stages (device ms, CUDA events): "
          + json.dumps({k: round(v, 6) for k, v in parts.items()}))

    phase("slice 1 kernels and full step")

    # -- slice 2: the incremental step of bench.py's epoch worker ----------
    incr_inputs = IncrementalInputs(n, reg, dev)
    check_incremental_kernels(incr_inputs, new_bal, new_eff, k3, kernels,
                              record, int32_ops_per_s)
    incr_counts, proof_counts, step_device = incremental_path(incr_inputs,
                                                              params)
    for name, names in PROFILED_KERNELS.items():
        if step_device:
            kernels[name]["step_device_ms"] = sum(step_device.get(k, 0.0)
                                                  for k in names)

    phase("incremental step and proofs")

    # -- slices 3 and 4: the RLC batch verify, both routes -----------------
    field_counts = check_bls_field_kernels(dev, record, int32_ops_per_s)
    phase("bls field checks")
    bls_counts, h2c_counts, facade_counts, rejected_f = bls_path(
        dev, record, int32_ops_per_s)
    phase("bls batch (config #2)")
    # -- slice 4: config #3's pairing check and the facade; the MSM -------
    check_counts, fav_counts = pairing_check_path(dev, record,
                                                  int32_ops_per_s)
    phase("pairing check (config #3)")
    err12, err10 = check_pairing_edge_shapes(dev, rejected_f)
    for name, err in (("precomp_miller_product", err12),
                      ("final_exp_is_one", err10)):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    phase("pairing edge shapes")
    msm_counts = msm_path(dev, record, int32_ops_per_s)
    phase("msm")
    # -- slice 5: the scalar field, config #5, PeerDAS, compute_cells -------
    fr_counts = check_fr_field_kernels(dev, record, int32_ops_per_s)
    phase("fr field checks")
    kzg_counts, kzg_setup_counts = kzg_path(dev, record, int32_ops_per_s)
    phase("kzg (config #5)")
    das_counts = das_path(dev, record, int32_ops_per_s)
    phase("das verify")
    cells_counts = compute_cells_path(dev, record, int32_ops_per_s)
    phase("compute_cells")
    kernels["fr_fft"]["max_abs_err"] = max(kernels["fr_fft"]["max_abs_err"],
                                           check_k18_shapes(dev))
    phase("fr fft shapes")
    # -- slice 6: the G1 FFT and FK20, the PeerDAS producer and recovery -----
    k18_fk20 = check_g1fft_kernels(dev, record, int32_ops_per_s)
    phase("g1 fft kernels")
    producer_counts, producer_cold_counts, dense = producer_path(dev)
    phase("das producer")
    recovery_counts = recovery_path(dense)
    phase("das recovery")
    # -- slice 7: fork choice, K21-K23 -------------------------------------
    fc_library_ms = check_fc_kernels(dev, record)
    kernels["fc_refresh"]["library_ms"] = fc_library_ms
    phase("fork choice kernels")
    fc_counts = {name: forkchoice_path(dev, name, *shape)
                 for name, *shape in FC_PATHS}
    phase("fork choice paths")
    # -- slice 8: the sharded paths, K24-K27 -------------------------------
    err24, err25, err26, err8 = check_sharded_kernels(dev, record,
                                                      int32_ops_per_s)
    check_sweep_sharded_main(dev, reg, sc, params, record, err24)
    phase("sharded kernels")
    err_edges = check_rlc_edge_shapes(dev)
    kernels["rlc_miller_product"]["max_abs_err"] = max(
        kernels["rlc_miller_product"]["max_abs_err"], err_edges)
    err25, err26 = max(err25, err_edges), max(err26, err_edges)
    phase("rlc edge shapes")
    for name, err in zip(("msm_pippenger", "msm_double_add", "g1_shard_fold"),
                         check_msm_edges(dev)):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], err)
    phase("msm edges")
    step_want = step(reg, sc, n, leaves)
    sharded_counts = sharded_step_path(dev, reg, leaves, sc, params,
                                       step_want, n)
    phase("sharded step")
    forest_counts = sharded_forest_path(dev, step_want[0], n)
    phase("sharded forest")
    bls_sharded_counts, err8_shards = sharded_bls_path(
        dev, record, int32_ops_per_s, err25, err26)
    kernels["rlc_scalar_mul"]["max_abs_err"] = max(
        kernels["rlc_scalar_mul"]["max_abs_err"], err8, err8_shards)
    phase("sharded bls batch")
    msm_sharded_counts = sharded_msm_path(dev)
    phase("sharded msm")
    das_sharded_counts = sharded_das_path(dev)
    phase("sharded das verify")
    real_cards_path(reg, leaves, sc, params, step_want, n)
    phase("real cards")
    k18_ms, k18_plain = k18_fk20["fr_fft_64x128"]
    k18_products = 64 * (128 // 2) * 7
    k18_bms, _ = fr_bound(k18_products, (2 * 64 * 128 + 64 + 1) * 132,
                          int32_ops_per_s)
    kernels["fr_fft"].update(fk20_ms=k18_ms, fk20_plain_ms=k18_plain,
                             fk20_bound_ms=k18_bms,
                             fk20_chain_floor_ms=k18_chain_products(128)
                             * FR_PROBE["latency_us"] / 1e3,
                             fk20_shape="batch 64, n=128 forward (FK20)")

    paths = {"full_step": full_counts, "incremental_step": incr_counts,
             "proofs": proof_counts, "bls_batch_h2c": h2c_counts,
             "bls_batch": bls_counts, "bls_deferred_batch": facade_counts,
             "pairing_check": check_counts,
             "facade_fast_aggregate_verify": fav_counts, **msm_counts,
             "kzg_setup": kzg_setup_counts, "kzg_verify": kzg_counts,
             "das_verify": das_counts, "compute_cells": cells_counts,
             "das_producer": producer_counts,
             "das_producer_cold": producer_cold_counts,
             "das_recovery": recovery_counts, **fc_counts,
             "sharded_step": sharded_counts, "sharded_forest": forest_counts,
             "bls_batch_sharded": bls_sharded_counts,
             "msm_sharded": msm_sharded_counts,
             "das_verify_sharded": das_sharded_counts}
    # K7 holds the Fq layer (rows 7-8) and runs on no path; K15 holds the
    # Fr layer (row 14) and runs on the producer's and the recovery's paths
    field_checks = {"bls_field_ops": field_counts, "fr_field_ops": fr_counts}
    main_path = ("incremental_step", "full_step", "bls_batch_h2c",
                 "pairing_check", f"msm_{MSM_SIZES[1]}", f"msm_{MSM_SIZES[2]}",
                 "proofs", "kzg_verify", "das_verify", "compute_cells",
                 "das_producer", "das_recovery", "forkchoice_mainnet",
                 "sharded_step", "sharded_forest", "bls_batch_sharded",
                 "msm_sharded")
    for k in kernels.values():
        name = k["name"]
        by = {p: c[name] for p, c in paths.items() if c.get(name)}
        if name in field_checks:
            by["field_checks"] = field_checks[name][name]
        if not by:
            raise AssertionError(f"no path launched kernel {name}")
        k["launches_by_path"] = by
        k["launches"] = next((by[p] for p in main_path if by.get(p)), 0)
        if not k["launches"] and name != "bls_field_ops":
            raise AssertionError(f"no main path launched kernel {name}")

    for k in kernels.values():
        print(f"kernel {k['name']}: launches={k['launches']} "
              f"max_abs_err={k['max_abs_err']} kernel_ms={k['ms']:.6f} "
              f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
              f"({k['bound_by']}) library_ms="
              + ("null" if k["library_ms"] is None
                 else f"{k['library_ms']:.6f}"))
    print("kernels: " + json.dumps(list(kernels)))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    finally:
        if "pool" in EDGE:
            EDGE["pool"].terminate()
            EDGE["pool"].join()
    sys.exit(rc)
