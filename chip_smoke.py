#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository, on a machine with one CUDA card, nvcc
and PyTorch built for CUDA.  The script:

1. prints the card's name and power limit;
2. builds the kernels K1-K6 from `consensus_specs_tpu_torch/csrc/` (one
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
   the persisted balances and registry forests), requires both roots to
   equal the full rebuild's and every output and forest layer to equal
   the plain incremental step's, requires the launch count of every
   kernel of that step to be > 0, and times it and its stages;
6. emits 1024 SSZ proofs from the balances forest and verifies each
   against the list root;
7. prints one JSON line per the kernels held, then, last, the result
   line `{"ok": true, "device": {...}}`.

Every phase is fatal: any failure raises and the script exits non-zero
without a result line.  It exits non-zero at once when no CUDA device is
available.  It imports nothing of JAX or of `consensus_specs_tpu`.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

N_VALIDATORS = 2**20
SEED = 0
SCALARS = (100, 2, 32_000_000_000)   # __graft_entry__.entry()'s: epoch 100
INCR_SCALARS = (100_000, 2, 32_000_000_000)   # bench.py worker_epoch's
N_PROOFS = 1024
# the device kernels of each counted wrapper, by the profiler's names
PROFILED_KERNELS = {
    "epoch_sweep": ("totals_kernel", "deltas_kernel", "apply_kernel"),
    "sha256_64B": ("sha256_64B_kernel", "sha256_u64_leaves_kernel"),
    "update_level": ("update_level_kernel", "leaf_scatter_kernel"),
    "balance_chunks": ("balance_chunks_kernel",),
    "records_root_gather": ("records_root_kernel",),
}
SLEEP_CYCLES = 2_000_000             # about 1 ms at the H100's clocks
HBM_BYTES_PER_S = 3.35e12            # H100 SXM (NVIDIA data sheet)
INT32_LANES_PER_SM = 64              # 32-bit integer results per SM per clock
# 32-bit integer instructions of one 64-byte message (two compressions):
# a round is 14 (three funnel-shift rotations and one three-input logic op
# for each of the two Sigmas, one logic op each for Ch and Maj, four adds);
# a schedule word is 10; the padding block's schedule is constant and
# folded away; 8 adds end each compression.
OPS_PER_MESSAGE = (64 * 14 + 48 * 10 + 8) + (64 * 14 + 8)


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


def device_ms(fn, reps: int) -> float:
    """Mean device time of one call of `fn`, from CUDA events around each
    call.  A sleep kernel queued before each call keeps the device busy
    while the host enqueues it, so the host's time between launches is
    not counted (it is for `cuda_ms`, which a small kernel's wrapper
    overhead then dominates)."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
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


def bound(messages: int, nbytes: int, int32_ops_per_s: float):
    """(ms, "operations" or "bytes"): the larger of `messages` 64-byte
    SHA-256 messages at the int32 rate and `nbytes` at the memory rate."""
    ops_ms = messages * OPS_PER_MESSAGE / int32_ops_per_s * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                              "bytes")


def read_launches(label: str) -> dict:
    """The launch counts since the last reset, printed; the nonzero ones."""
    from consensus_specs_tpu_torch import _build

    counts = {k: v for k, v in _build.launches.items() if v}
    print(f"{label} launches: {json.dumps(counts)}")
    return counts


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
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.replace("(anonymous namespace)::", "")
            name = name.split("(")[0][:80] if name[:1] != "(" else name[:80]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us()
    return {k: v / reps / 1e3 for k, v in
            sorted(per.items(), key=lambda kv: -kv[1])}


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
    edge batches; each timed beside its plain version and its bound."""
    import torch

    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch.parallel import incremental as I
    from consensus_specs_tpu_torch.parallel import merkle as M

    dev, n = inp.dev, inp.n
    rng = np.random.RandomState(SEED + 11)

    def rand_words(m):
        return C.from_numpy_u32(rng.randint(0, 2**32, (m, 8), dtype=np.uint64)
                                .astype(np.uint32), dev)

    # -- K4 (and K2 writing into the forest's levels) ----------------------
    db, dr = inp.depths            # 18 and 20 at 2**20 validators
    forests, err4 = {}, 0
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
        forests[d] = got
    edge_sets = {"sibling pairs": [0, 1, 2, 3, 6, 7, n // 2, n // 2 + 1,
                                   n - 2, n - 1],
                 "all sentinels": []}
    for label, dirty in edge_sets.items():
        idx = I.pad_dirty_idx(torch.tensor(dirty, dtype=torch.int64),
                              n).to(dev)
        words = rand_words(idx.shape[0])
        want = [lay.clone() for lay in forests[dr]]
        I.update_dirty(forests[dr], idx, words, dr)
        I.update_dirty(want, idx, words, dr, plain=True)
        err4 = max(err4, require_equal(f"update_dirty ({label})",
                                       list(forests[dr]), want))
    lay, vidx = forests[dr], inp.validator_idx
    parents = int(torch.unique(vidx[vidx < n] >> 1).numel())
    k4_bound, k4_by = bound(parents, vidx.numel() * 8 + parents * 96,
                            int32_ops_per_s)
    leaf_words = rand_words(vidx.shape[0])
    record("update_level", "consensus_specs_tpu_torch/csrc/incremental.cu",
           "consensus_specs_tpu/parallel/incremental.py:122", err4,
           device_ms(lambda: I.update_level(lay[0], lay[1], vidx, 1), 50),
           cuda_ms(lambda: I.update_level(lay[0], lay[1], vidx, 1,
                                          plain=True), 3),
           k4_bound, k4_by, shape="the bottom sparse level of the registry "
           f"forest: rung {vidx.numel()}, {parents} parents of "
           f"{lay[1].shape[0]}",
           leaf_scatter_ms=device_ms(
               lambda: I.scatter_leaves(lay[0], vidx, leaf_words), 50),
           leaf_scatter_plain_ms=cuda_ms(
               lambda: I.scatter_leaves(lay[0], vidx, leaf_words,
                                        plain=True), 3),
           leaf_scatter_bound_ms=bound(
               0, vidx.numel() * 8 + len(inp.dirty) * 64,
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

    # -- K3 in gather mode: the dirty record roots at rung 16384 ----------
    args = inp.record_args(new_eff)
    err3 = require_equal(
        "records_root gather", M.validator_records_root_kernel(
            *args, index=vidx),
        M.validator_records_root_plain(*args, index=vidx))
    err3 = max(err3, require_equal(
        "records_root gather(odd)",
        M.validator_records_root_kernel(*args, index=odd),
        M.validator_records_root_plain(*args, index=odd)))
    m = vidx.numel()
    record("records_root_gather",
           "consensus_specs_tpu_torch/csrc/records_root.cu",
           "bench.py:260", err3,
           device_ms(lambda: M.validator_records_root_kernel(*args,
                                                             index=vidx), 50),
           cuda_ms(lambda: M.validator_records_root_plain(*args, index=vidx),
                   3),
           *bound(7 * m, m * (8 + 105 + 32), int32_ops_per_s),
           shape=f"rung {m} of 2**20 validators")


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
    for name in ("epoch_sweep", "sha256_64B", "update_level",
                 "balance_chunks", "records_root_gather"):
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
        "balances_update_K4_K2": cuda_ms(
            lambda: step.balances_forest.update(inp.chunk_idx, bal_leaves),
            20),
        "registry_update_K4_K2": cuda_ms(
            lambda: step.registry_forest.update(inp.validator_idx, rec), 20),
    }
    t0 = time.perf_counter()
    for _ in range(20):
        step.balances_forest.root_bytes()
        step.registry_forest.root_bytes()
    parts["roots_host_tail_host_ms"] = (time.perf_counter() - t0) * 1e3 / 20
    print(f"incremental step: n={n} dirty={len(inp.dirty)} "
          f"median_ms={statistics.median(walls):.4f} "
          f"min_ms={min(walls):.4f} max_ms={max(walls):.4f} "
          f"plain_median_ms={statistics.median(plain_walls):.4f} "
          f"peak_mem_bytes={peak} forest_build_ms={build_ms:.4f}")
    print("incremental stages (device ms, CUDA events; roots: host ms): "
          + json.dumps({k: round(v, 6) for k, v in parts.items()}))
    per = {}
    try:
        per = profile_device_ms(step, 3)
        busy = sum(per.values())
        print("incremental step device ms per step by kernel "
              "(torch.profiler): " + json.dumps(
                  {k: round(v, 6) for k, v in per.items()}))
        print(f"incremental step device busy ms={busy:.6f} "
              f"(share of the median step: "
              f"{busy / statistics.median(walls):.4f}); K2 per step ms="
              f"{per.get('sha256_64B_kernel', 0.0):.6f}")
    except Exception as exc:   # a measurement only: report and go on
        print(f"incremental step device ms by kernel: not measured "
              f"({type(exc).__name__}: {exc})")

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
    max_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    int32_ops_per_s = n_sm * INT32_LANES_PER_SM * max_clock_hz
    print(f"sms: {n_sm}  max_sm_clock_mhz: {max_clock_hz / 1e6:.0f}  "
          f"int32_ops_per_s: {int32_ops_per_s:.4g}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.3f} s "
          f"{json.dumps({k: round(v, 3) for k, v in built.items()})}")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if ("registers" in line or "spill" in line
                        or "entry function" in line):
                    print(f"ptxas {name}: {line.strip()}")
    for name in _build.SOURCES:
        _build.load(name)

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
    k1_bytes = n * (5 * 8 + 8 + 4 + 4 * 1 + 2 * 8)
    record("epoch_sweep", "consensus_specs_tpu_torch/csrc/epoch_sweep.cu",
           "consensus_specs_tpu/parallel/epoch.py:140", err,
           device_ms(lambda: E.epoch_sweep_kernel(reg, sc, params), 50),
           cuda_ms(lambda: E.epoch_sweep_plain(reg, sc, params), 5),
           k1_bytes / HBM_BYTES_PER_S * 1e3, "bytes")
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
    k3_ops = 7 * n * OPS_PER_MESSAGE
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
    k2_bound = max(msgs * OPS_PER_MESSAGE / int32_ops_per_s,
                   msgs * 96 / HBM_BYTES_PER_S)
    leaf_msgs = n // 8
    leaf_bound = max(leaf_msgs * OPS_PER_MESSAGE / int32_ops_per_s,
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

    paths = {"full_step": full_counts, "incremental_step": incr_counts,
             "proofs": proof_counts}
    for k in kernels.values():
        by = {p: c[k["name"]] for p, c in paths.items() if c.get(k["name"])}
        if not by:
            raise AssertionError(f"no path launched kernel {k['name']}")
        k["launches_by_path"] = by
        k["launches"] = (by.get("incremental_step") or by.get("full_step")
                         or by["proofs"])

    for k in kernels.values():
        print(f"kernel {k['name']}: launches={k['launches']} "
              f"max_abs_err={k['max_abs_err']} kernel_ms={k['ms']:.6f} "
              f"plain_ms={k['plain_ms']:.6f} bound_ms={k['bound_ms']:.6f} "
              f"({k['bound_by']}) library_ms=null")
    print("kernels: " + json.dumps(list(kernels)))
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
