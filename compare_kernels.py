#!/usr/bin/env python3
"""Time the BLS kernels of config #2's batch, K16, the epoch step's
kernels, the PeerDAS kernels and the fork-choice kernels on one CUDA
card for one checkout of the port, so that two commits compare on one
card:

    python3 compare_kernels.py [--root DIR] [--label NAME] [--group G]

It imports `consensus_specs_tpu_torch` from DIR (default: this script's
directory), builds that checkout's libraries of the group (`bls`, `epoch`,
`fr`, `g1fft`, `msm`, `fc` or `all`, the default: `bls`, `epoch` and
`g1fft`) with its own `_build`, and times, by CUDA events
around each call with a sleep kernel ahead (`chip_smoke.py`'s `device_ms`,
whose helpers and inputs it uses), in the `bls` group:

- K11, K8, K9 and K10 on `bench_bls.py` config #2 (128 statements of
  64-key aggregates, B = 128) as `batch_verify` hashes them on the card,
  and their sum, the device-hashing batch's device time;
- K12 on the first statement's pairing check (bucket 8, 2 live lanes);
- K8 and K25 on shard 0 of the batch over 4 shards (32 lanes) and K26
  on the sharded batch's 4 partials;
- K16 on `chip_smoke.py`'s config #5 blob 0 at W = 4096, at its
  challenge (the commitment by K14 on the card);
- K7 (`fq12_mul`) and K15 (an inversion) on 1024 random elements;
- the `msm` group's calls: K13 and K14 on `chip_smoke.py`'s MSM probe
  at its MSM_SIZES, K13 on shard 0 of the probe's 512 points over 4
  shards (128 points, c = 6) and K27 on the 4 partials;

and in the `epoch` group, on `chip_smoke.py`'s 2**20-validator registry
and `bench.py`'s 1% dirty set, through functions both checkouts have:

- K1 (`epoch_sweep_kernel`);
- K3's gather mode at the step's rung of 16384, warm and cold (a 64 MB
  write ahead of each call), and K3's full mode at 2**20 as a control;
- each persisted forest's dirty-path update (`MerkleForest.update`: the
  balances forest, depth 18, and the registry forest, depth 20, at rung
  16384) and both one after the other;
- K24: the whole sharded sweep over 4 shards (CUDA events around the
  sweep, and around each of its kernel wrappers' calls in it, summed),
  the same on a registry whose attesters name 32 proposers with K1 on
  it, and the three passes on shard 0, the sums all-reduced and the
  shares reduce-scattered as the sharded sweep does;
- the K24 prelude probe's cycles (`epoch.prelude_probe`);
- the incremental step (`IncrementalEpochStep`): its device busy time
  (torch.profiler, the sum over its device operations) and its wall
  (host clock, median of 9);

and in the `fr` group (it builds `fr_batch` and `g1_fft`), on seeded
inputs and `convert.closed_form_blob()`'s:

- K18 at (1, 8192) forward (`compute_cells`' extension), (1, 4096)
  inverse (its coefficients), (2, 8192) forward (the recovery's coset
  step) and (64, 128) (FK20's rows);
- K15's `inv` at 1,027 elements and at one, its `mul` at 8,192;
- `das.recover._batch_inverse_limbs` at 8,192 (the parent's product tree
  of K15 launches, the change's one launch);
- the decode `_recover_coefficient_limbs` from 64 cells, whole (its host
  work included), and its split by step on the host clock;
- the walls of the calls K18 and K15 sit in on the producer's path, on
  the host clock: FK20's `_fk20_proofs_device`, `compute_cells` and the
  producer `compute_cells_and_kzg_proofs` on that blob;
- K17 on 16, 128 and 1024 cells of width 64 (the DAS ladder's rungs);
- K16 at W = 4096, as a control;
- each call's CUDA launches and copies and their device time
  (torch.profiler, one call), and,
  where the checkout has it (`kernels.fr_product_chain`), the Fr
  product's latency on one thread, in us;

and in the `fc` group (it builds `forkchoice`), on
`forkchoice.synthetic.kernel_inputs` from `chip_smoke.py`'s SEED:

- K23 on the seeded tree at NB = 1024 and 16384 (the large-rung route)
  and on a linear chain of the live blocks at 1024, 50 calls each;
- K21 on the mainnet batch (B = 16384, V = 2**20, NB = 1024) and at B =
  1024 on the same tables, its tables restored before each call (its
  digest covers the accept mask and the tables it updates), the empty
  cooperative launch of its grid with 0 and 1 barriers
  (`fc_grid_barrier_probe`);
- K22 on that batch's table (7/16 voted), on the paths' table (no
  vote), with every vote on one block, and on tables voted the same way
  at NB = 16384 and 32768;
- each call's CUDA launches (torch.profiler, one call; also in the
  `epoch` group);

and in the `g1fft` group, on `chip_smoke.py`'s inputs:

- K19 at (64, 128) forward on the trusted setup's residue vectors (the
  FK20 setup tables), at (1, 128) forward on the first of them, and at
  (1, 128) inverse on the first table row;
- K20 at (64 residues, 128 positions) on those tables and the window
  digits of `convert.kzg_blobs(1)[0]`'s circulant rows, and K18 on
  those rows;
- one `_fk20_proofs_device` call on that blob (its host compression
  included: CUDA events around a call that syncs);
- in every group but `epoch`, where the checkout has it
  (`kernels.g1_product_chain`), one pass round's product latency, in us.

Its K13, K14, K19, K20 and K27 digests cover the coordinates of the
finite points and the Z = 0 flags (a point at infinity's X and Y are
read by nobody); the producer's, its proof bytes.

It prints, last, one JSON line: the label, the card's name and power
limit, each kernel's mean device ms, and a SHA-256 of each kernel's
outputs (copied to the CPU) that two checkouts' runs must share.  Run
parent, change, change, parent on one card in one session: two
sessions may land on two cards.  It exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import random
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPS = 5
SHARDS = 4
SOURCES = {"bls": ("bls_rlc", "bls_h2c", "bls_shard", "bls_pairing",
                   "bls_msm", "fr_batch", "g1_fft"),
           "epoch": ("epoch_sweep", "sha256", "records_root", "incremental"),
           "fr": ("fr_batch", "g1_fft"),
           "g1fft": ("g1_fft", "fr_batch"),
           "msm": ("bls_msm", "g1_fft"),
           "fc": ("forkchoice",)}
SHARDS_K24 = 4
# a call's set-up, run before it outside the timed events
SETUPS = {}
# a call's digest, where it is not `_digest` of its outputs
DIGESTS = {}
# a call's timed repetitions, where not REPS (the fork-choice kernels
# take microseconds)
REPS_FOR = {}
FC_REPS = 50


def _helpers():
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if isinstance(t, (tuple, list)):
            h.update(_digest(*t).encode())
        else:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def epoch_calls(cs, dev) -> tuple:
    """The epoch group's calls {name: fn} and the digests of what the
    in-place updates leave behind (the forests' layers), taken after the
    calls have run."""
    import statistics

    import torch

    from consensus_specs_tpu_torch import MAINNET, IncrementalEpochStep
    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.parallel import EpochScalars
    from consensus_specs_tpu_torch.parallel import collectives as CO
    from consensus_specs_tpu_torch.parallel import epoch as E
    from consensus_specs_tpu_torch.parallel import incremental as I
    from consensus_specs_tpu_torch.parallel import merkle as M

    n = cs.N_VALIDATORS
    reg = CV.registry_to_torch(CV.synthetic_registry(n, seed=cs.SEED), dev)
    sc = EpochScalars(*cs.SCALARS)
    calls = {"epoch_sweep": lambda: E.epoch_sweep_kernel(reg, sc, MAINNET)}

    inp = cs.IncrementalInputs(n, reg, dev)
    step = IncrementalEpochStep(MAINNET, reg, inp.sc, inp.leaves, inp.dirty,
                                device=dev)
    bal, eff, _, _ = step()
    bal_leaves = I.dirty_balance_leaves(bal, inp.chunk_idx)
    rec = M.validator_records_root(*inp.record_args(eff),
                                   index=inp.validator_idx)
    fb, fr = step.balances_forest, step.registry_forest

    def update(*forests):
        """The forests' updates one after the other; their layers after."""
        for f in forests:
            f.update(*((inp.chunk_idx, bal_leaves) if f is fb
                       else (inp.validator_idx, rec)))
        return [lay for f in forests for lay in f.layers]

    calls["forest_balances_update"] = lambda: update(fb)
    calls["forest_registry_update"] = lambda: update(fr)
    calls["forests_both_updates"] = lambda: update(fb, fr)

    m = n // SHARDS_K24
    shards = [E.RegistryArrays(*(f[d * m:(d + 1) * m].clone() for f in reg))
              for d in range(SHARDS_K24)]
    calls["epoch_sweep_sharded_d4"] = lambda: E.epoch_sweep_sharded(
        shards, sc, MAINNET)
    sharded = {"epoch_sweep_sharded_d4": shards}
    if hasattr(CV, "hot_proposers"):
        # every attester's proposer among 32 validators, as in a mainnet
        # epoch
        reg_np = CV.synthetic_registry(n, seed=cs.SEED)
        reg_np["proposer_index"] = CV.hot_proposers(n, cs.HOT_PROPOSERS,
                                                    cs.SEED)
        hot = CV.registry_to_torch(reg_np, dev)
        sharded["epoch_sweep_sharded_d4_hot32"] = [
            E.RegistryArrays(*(f[d * m:(d + 1) * m].clone() for f in hot))
            for d in range(SHARDS_K24)]
        calls["epoch_sweep_hot32"] = lambda: E.epoch_sweep_kernel(hot, sc,
                                                                  MAINNET)
        calls["epoch_sweep_sharded_d4_hot32"] = lambda: E.epoch_sweep_sharded(
            sharded["epoch_sweep_sharded_d4_hot32"], sc, MAINNET)
    if hasattr(E, "sweep_shares_kernel"):
        # the three passes of shard 0, the collectives' outputs as inputs
        r0 = shards[0]
        parts = [E.sweep_totals_kernel(r, sc, n) for r in shards]
        sums = CO.all_reduce_sum([s for s, _ in parts])
        totals = [E.sweep_shares_kernel(r, sc, MAINNET, s, a)
                  for r, s, (_, a) in zip(shards, sums, parts)]
        got = CO.reduce_scatter_sum([a for _, a in parts])
        acc0 = parts[0][1]
        calls["k24_a_totals"] = lambda: E.sweep_totals_kernel(r0, sc, n)
        calls["k24_b_shares"] = lambda: (E.sweep_shares_kernel(
            r0, sc, MAINNET, sums[0], acc0), acc0)
        # (b) adds into its accumulator: zero it before each call, outside
        # the timed events
        SETUPS["k24_b_shares"] = acc0.zero_
        calls["k24_c_apply"] = lambda: E.sweep_apply_kernel(
            r0, sc, MAINNET, totals[0], got[0])
    # K3's gather mode at the step's rung (16384 of 2**20), warm and cold
    # (a 64 MB write ahead of each call evicts its fields from L2, as K1's
    # sweep does in the step), and K3's full mode at 2**20 as a control
    rec_args = inp.record_args(eff)
    gather = (lambda: M.validator_records_root_kernel(
        *rec_args, index=inp.validator_idx))
    calls["records_root_gather"] = gather
    calls["records_root_gather_cold"] = gather
    scrub = torch.empty(2**26, dtype=torch.uint8, device=dev)
    SETUPS["records_root_gather_cold"] = scrub.zero_
    REPS_FOR["records_root_gather"] = 50
    REPS_FOR["records_root_gather_cold"] = 20
    calls["records_root_full"] = lambda: M.validator_records_root_kernel(
        *rec_args)
    calls["incremental_step"] = step

    def after(ms: dict) -> dict:
        """The step's device busy time and wall; digests of the forests'
        layers after every update above."""
        per = cs.try_profile("incremental step", step, 3) or {}
        ms["incremental_step_device_busy"] = sum(per.values())
        step()
        torch.cuda.synchronize()
        walls = []
        for _ in range(9):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        ms["incremental_step_wall_median"] = statistics.median(walls)
        # K24's own device time in a whole sharded sweep: CUDA events
        # around each of its 12 wrapper calls (`chip_smoke.py`'s record),
        # the mean of REPS sweeps
        wrappers = [(E, w) for w in ("sweep_totals_kernel",
                                     "sweep_deltas_kernel",
                                     "sweep_shares_kernel",
                                     "sweep_apply_kernel") if hasattr(E, w)]
        for name, regs in sharded.items():
            ms[f"{name}_kernels"] = statistics.mean(
                sum(cs.kernel_device_ms(
                    lambda r=regs: E.epoch_sweep_sharded(r, sc, MAINNET),
                    wrappers).values()) for _ in range(REPS))
        if hasattr(E, "prelude_probe"):
            total = int(E.sweep_totals_plain(reg, sc, n)[0][0])
            cyc = [E.prelude_probe(total, sc, MAINNET, dev) for _ in range(3)]
            print("K24 prelude probe (clock64 cycles of one warp, 3 runs: "
                  "(b)'s square root and magic, the parent's per-block (b) "
                  "and (c) derivations, (b)'s last block): "
                  + json.dumps(cyc))
            for k, name in enumerate(("k24_prelude_b", "parent_prelude_b",
                                      "parent_prelude_c", "k24_last_block")):
                ms[f"{name}_cycles"] = cyc[-1][k]
        return {"forest_layers": _digest(list(fb.layers) + list(fr.layers))}

    return calls, after


def _points_digest(p) -> str:
    """The Z = 0 flags and the coordinates of the finite points."""
    import torch

    inf = (p[2] == 0).all(-1, keepdim=True)
    return _digest(inf, *(torch.where(inf, torch.zeros_like(c), c)
                          for c in p))


def g1fft_calls(cs, dev) -> dict:
    """The g1fft group's calls {name: fn}: K19 at the setup shape and at
    the producer's two (1, 128) transforms, K20 on the setup tables, one
    FK20 producer call."""
    import numpy as np
    import torch

    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.das import ciphersuite as dcs
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    L, KK, N = DC.L, DC.K, DC.N_EXT
    limbs = [G.points_to_limbs([dcs.setup_g1_point(c + L * v)
                                for v in range(KK)], pad_to=N)
             for c in range(L)]
    perm = torch.tensor(G._bitrev_perm(N), device=dev)
    fwd = tuple(torch.from_numpy(np.stack([lb[i] for lb in limbs])).to(dev)
                [:, perm].contiguous() for i in range(3))
    tables = G.fft(*fwd)
    one = tuple(c[:1].contiguous() for c in fwd)
    inv = tuple(c[:1][:, perm].contiguous() for c in tables)
    blob = CV.kzg_blobs(1)[0]
    coeffs = DC.poly_coefficients(blob, device=dev)
    f = DC._coeff_limbs(coeffs, dev)
    rows = torch.cat([f, torch.zeros_like(f[:1])])[
        DC._fk20_row_index(L, KK, N, DC.M, dev)]
    sfft = DC.domain_fft(rows)
    raw_one = torch.from_numpy(FB.FR.int_to_limbs(1)).to(dev)
    digits = G.limb_digits(FB.field_op(
        "mul", sfft, raw_one.expand(sfft.shape).contiguous()))
    calls = {
        "g1_fft_64x128_forward": lambda: G.fft(*fwd),
        "g1_fft_1x128_forward": lambda: G.fft(*one),
        "g1_fft_1x128_inverse": lambda: G.fft(*inv, inverse=True),
        "fk20_hext_64x128": lambda: G.hext(*tables, digits),
    }
    for name in calls:
        DIGESTS[name] = _points_digest
    calls["fr_fft_64x128"] = lambda: DC.domain_fft(rows)
    calls["fk20_proofs_blob0"] = lambda: DC._fk20_proofs_device(coeffs,
                                                                device=dev)
    DIGESTS["fk20_proofs_blob0"] = lambda proofs: hashlib.sha256(
        b"".join(proofs)).hexdigest()[:16]
    return calls


def fr_calls(cs, dev) -> dict:
    """The fr group's calls {name: fn}: K18 at the paths' shapes, K15,
    the recovery's batch inverse and decode, K16 and K17 as controls."""
    import random

    import torch

    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.das import ciphersuite as dcs
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.das import recover as RC
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    rng = random.Random(cs.SEED + 15)

    def on(arrays):
        return tuple(torch.from_numpy(a).to(dev) for a in arrays)

    blob, cells, _, _ = CV.closed_form_blob()
    m = dcs.FIELD_ELEMENTS_PER_BLOB
    evals = DC.blob_to_poly_ints(blob)
    brp = [evals[dcs.reverse_bits(i, m)] for i in range(m)]
    coeffs = DC.poly_coefficients(blob, device="cpu")
    ffts = {
        "1x8192_forward": on(FB.fft_inputs([list(coeffs) + [0] * m],
                                           dcs.roots_of_unity(2 * m))),
        "1x4096_inverse": on(FB.fft_inputs([brp], dcs.roots_of_unity(m),
                                           True)),
        "2x8192_forward": on(FB.fft_inputs(
            [[rng.randrange(R) for _ in range(2 * m)] for _ in range(2)],
            dcs.roots_of_unity(2 * m))),
    }
    f = DC._coeff_limbs(coeffs, dev)
    rows = torch.cat([f, torch.zeros_like(f[:1])])[
        DC._fk20_row_index(DC.L, DC.K, DC.N_EXT, DC.M, dev)]
    perm, roots128, one = DC._domain_consts(DC.N_EXT, False, dev)
    ffts["64x128_forward"] = (rows[:, perm].contiguous(), roots128, one)
    calls = {f"fr_fft_{k}": (lambda a=a: FB.fft(*a)) for k, a in ffts.items()}

    def limbs(vals):
        return torch.from_numpy(FB.FR.to_mont_batch(vals)).to(dev)

    inv_in = limbs([rng.randrange(R) for _ in range(1027)])
    calls["fr_field_ops_inv_1027"] = lambda: FB.field_op("inv", inv_in)
    calls["fr_field_ops_inv_1"] = lambda: FB.field_op("inv", inv_in[:1])
    mul_a, mul_b = (limbs([rng.randrange(R) for _ in range(2 * m)])
                    for _ in range(2))
    calls["fr_field_ops_mul_8192"] = lambda: FB.field_op("mul", mul_a, mul_b)
    bi_in = limbs([rng.randrange(1, R) for _ in range(2 * m)])
    calls["batch_inverse_8192"] = lambda: RC._batch_inverse_limbs(bi_in)
    keep = list(range(0, 128, 2))
    dec_rows = RC._cell_rows([cells[k] for k in keep])
    calls["recover_decode_64_cells"] = (
        lambda: RC._recover_coefficient_limbs(keep, dec_rows, dev))

    W = m
    g = pow(7, (R - 1) // W, R)
    domain = [pow(g, i, R) for i in range(W)]
    args16 = on(FB.barycentric_inputs([rng.randrange(R) for _ in range(W)],
                                      domain, rng.randrange(R)))
    calls["fr_barycentric_4096"] = lambda: FB.barycentric(*args16)
    Wd = 64
    for B in (16, 128, 1024):
        args17 = on(FB.coset_interpolate_inputs(
            [[rng.randrange(R) for _ in range(Wd)] for _ in range(B)],
            [[rng.randrange(R) for _ in range(Wd)] for _ in range(Wd)],
            [[rng.randrange(R) for _ in range(Wd)] for _ in range(B)]))
        calls[f"fr_coset_interpolate_{B}"] = (
            lambda a=args17: FB.coset_interpolate(*a))
    return calls


def fc_calls(cs, dev) -> dict:
    """The fc group's calls {name: fn}: K23 on `kernel_inputs`' tree (SEED,
    no boost) at NB = 1024 and 16384 and on the linear chain at 1024
    (`synthetic.head_inputs`' "tree" and "chain"); K21 and K22, as
    controls, on
    `check_fc_kernels`' batch (B = 16384, V = 2**20, NB = 1024), K21's
    tables restored before each call."""
    import numpy as np
    import torch

    from consensus_specs_tpu_torch.forkchoice import kernels as FK
    from consensus_specs_tpu_torch.forkchoice import synthetic as FS

    def on(x):
        return {k: (torch.from_numpy(np.array(v, copy=True)).to(dev)
                    if isinstance(v, np.ndarray) else v) for k, v in x.items()}

    def head(nb, chain):
        # `synthetic.head_inputs`' "tree" and "chain" cases, from the
        # `kernel_inputs` both checkouts have
        x = FS.kernel_inputs(nb, 256, 64, seed=cs.SEED)
        x["boost_idx"], x["boost_amt"] = nb, 0
        if chain:
            live = nb - nb // 8
            x["parent"][1:live] = np.arange(live - 1, dtype=np.int32)
            x["fin_ok"] = x["real"].copy()
            x["je"] = np.where(x["real"], x["sj"], 0)
            x["uje"] = x["je"].copy()
        return tuple(on(x)[n] for n in (
            "parent", "node_weight", "boost_idx", "boost_amt", "real",
            "block_epoch", "je", "uje", "fin_ok", "limbs", "sj", "sf", "cur",
            "justified_idx"))

    calls = {}
    for nb, case in ((1024, "tree"), (16384, "tree"), (1024, "chain")):
        args = head(nb, case == "chain")
        name = f"fc_head_{case}_{nb}"
        calls[name] = lambda a=args: FK.fc_head_kernel(*a)
        REPS_FOR[name] = FC_REPS
    _, nb, nv, b = cs.FC_PATHS[-1]
    x = FS.kernel_inputs(nb, nv, b, seed=cs.SEED)
    k, orig = on(x), on(x)
    names = ("val_idx", "att_epoch", "att_block", "lm_epoch", "lm_block",
             "balance", "can_update", "node_weight")

    def restore():
        for n in ("lm_epoch", "lm_block", "node_weight"):
            k[n].copy_(orig[n])

    calls["fc_apply"] = lambda: FK.fc_apply_kernel(*(k[n] for n in names))
    SETUPS["fc_apply"] = restore
    # B = 1024 (a path's batch of 1024 messages) on the same tables
    x1 = FS.kernel_inputs(nb, nv, 1024, seed=cs.SEED)
    k1, orig1 = on(x1), on(x1)

    def restore1():
        for n in ("lm_epoch", "lm_block", "node_weight"):
            k1[n].copy_(orig1[n])

    calls["fc_apply_1024"] = lambda: FK.fc_apply_kernel(
        *(k1[n] for n in names))
    SETUPS["fc_apply_1024"] = restore1
    if hasattr(FK, "fc_grid_barrier_probe"):
        for rows in (b, 1024):
            for syncs in (0, 1):
                name = f"fc_grid_barrier_probe_{rows}_{syncs}"
                calls[name] = (lambda r=rows, y=syncs:
                               FK.fc_grid_barrier_probe(r, y, dev))
                REPS_FOR[name] = FC_REPS
    for name in ("fc_apply", "fc_apply_1024"):
        tabs = k if name == "fc_apply" else k1
        DIGESTS[name] = lambda acc, t=tabs: _digest(
            acc, *(t[n][:-1] for n in ("lm_epoch", "lm_block")),
            t["node_weight"][:-1])
    # K22 on that batch's table (7/16 of the registry voted), on the paths'
    # table (no vote: a store's first rebuild), with every vote on one
    # block, and on tables of NB = 16384 and 32768 voted as that batch's
    calls["fc_refresh"] = lambda: FK.fc_refresh_kernel(
        orig["lm_block"], orig["balance"], nb)
    empty = torch.full_like(orig["lm_block"], -1)
    calls["fc_refresh_empty"] = lambda: FK.fc_refresh_kernel(
        empty, orig["balance"], nb)
    one = torch.full_like(orig["lm_block"], 3)
    one[-1] = -1
    calls["fc_refresh_one_slot"] = lambda: FK.fc_refresh_kernel(
        one, orig["balance"], nb)
    refresh = ["fc_refresh", "fc_refresh_empty", "fc_refresh_one_slot"]
    for big_nb in (16384, 32768):
        big = on(FS.kernel_inputs(big_nb, nv, 1024, seed=cs.SEED))
        refresh.append(f"fc_refresh_{big_nb}")
        calls[refresh[-1]] = (lambda t=big, m=big_nb: FK.fc_refresh_kernel(
            t["lm_block"], t["balance"], m))
    for name in ("fc_apply", "fc_apply_1024", *refresh):
        REPS_FOR[name] = FC_REPS
    return calls


def cuda_launches(cs, fn) -> dict:
    """{"kernels": n, "copies": n, "device_ms": t}: the CUDA kernels and
    the memcpy and memset operations that one call of `fn` runs, and
    their summed device time, from torch.profiler; None where the
    profiler records nothing."""
    per = cs.try_profile("launch count", fn, 1)
    if not per:
        return None
    copies = sum(c for k, c in cs.PROFILE_COUNTS.items()
                 if k.startswith(("Memcpy", "Memset")))
    return {"kernels": round(sum(cs.PROFILE_COUNTS.values()) - copies),
            "copies": round(copies), "device_ms": sum(per.values())}


def decode_split(dev) -> dict:
    """The recovery's decode from 64 cells on the host clock, median of 5
    (after one warm call): its wall and each step's, every step ended by
    a synchronize (the steps' own time; the host's conversions of the
    cells into limbs, `_limbs`, vary most)."""
    import statistics

    import torch

    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.das import recover as RC

    _, cells, _, _ = CV.closed_form_blob()
    keep = list(range(0, 128, 2))
    rows = RC._cell_rows([cells[k] for k in keep])
    acc, saved = {}, []
    for mod, name in ((RC, "_limbs"), (RC, "construct_vanishing_poly"),
                      (DC, "domain_fft"), (RC, "_mul"),
                      (RC, "_batch_inverse_limbs")):
        inner = getattr(mod, name)
        saved.append((mod, name, inner))

        def timed(*a, _inner=inner, _name=name, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _inner(*a, **k)
            torch.cuda.synchronize()
            acc[_name] = acc.get(_name, 0.0) + time.perf_counter() - t0
            return out
        setattr(mod, name, timed)
    runs = []
    try:
        for i in range(6):
            acc.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            RC._recover_coefficient_limbs(keep, rows, dev)
            torch.cuda.synchronize()
            if i:
                runs.append(dict(acc, wall=time.perf_counter() - t0))
    finally:
        for mod, name, inner in saved:
            setattr(mod, name, inner)
    return {k: statistics.median(r[k] for r in runs) * 1e3 for k in runs[0]}


def producer_walls(dev) -> dict:
    """The walls of FK20's `_fk20_proofs_device`, `compute_cells` and the
    producer `compute_cells_and_kzg_proofs` on `closed_form_blob()`, on
    the host clock around a synchronized call, after one warm call:
    {name: [median, min, max]} ms over 9 calls (5 for the producer)."""
    import statistics

    import torch

    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch import das as D
    from consensus_specs_tpu_torch.das import compute as DC

    blob = CV.closed_form_blob()[0]
    coeffs = DC.poly_coefficients(blob, device=dev)

    def wall(fn, k):
        fn()
        out = []
        for _ in range(k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return [statistics.median(out), min(out), max(out)]

    return {"fk20": wall(lambda: DC._fk20_proofs_device(coeffs, device=dev),
                         9),
            "compute_cells": wall(lambda: D.compute_cells(blob), 9),
            "producer": wall(lambda: D.compute_cells_and_kzg_proofs(blob), 5)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    ap.add_argument("--group", choices=("bls", "epoch", "fr", "g1fft",
                                        "msm", "fc", "all"),
                    default="all")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = _helpers()

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    from consensus_specs_tpu_torch import _build

    if root not in Path(_build.__file__).resolve().parents:
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    groups = (("bls", "epoch", "g1fft") if args.group == "all"
              else (args.group,))
    t0 = time.perf_counter()
    _build.build(tuple(dict.fromkeys(n for g in groups for n in SOURCES[g])))
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
    calls, after = {}, None
    if "bls" in groups:
        calls.update(bls_calls(cs, dev))
    if "epoch" in groups:
        epoch, after = epoch_calls(cs, dev)
        calls.update(epoch)
    if "g1fft" in groups:
        calls.update(g1fft_calls(cs, dev))
    if "msm" in groups:
        calls.update(msm_group_calls(cs, dev))
    if "fr" in groups:
        calls.update(fr_calls(cs, dev))
    if "fc" in groups:
        calls.update(fc_calls(cs, dev))

    ms, digests, launches = {}, {}, {}
    for name, fn in calls.items():
        setup = SETUPS.get(name)
        if setup:
            setup()
        digests[name] = DIGESTS.get(name, _digest)(fn())
        ms[name] = cs.device_ms(fn, REPS_FOR.get(name, REPS), setup)
        if any(g in groups for g in ("fr", "fc", "epoch")):
            if setup:
                setup()
            launches[name] = cuda_launches(cs, fn)
    if any(g in groups for g in ("bls", "g1fft", "msm")):
        from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

        if hasattr(K, "g1_product_chain"):
            ms["g1_product_latency_us"] = cs.g1_product_latency_us(dev)
    split = walls = None
    if "fr" in groups:
        from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

        if hasattr(FK, "fr_product_chain"):
            ms["fr_product_latency_us"] = cs.fr_product_latency_us(dev)
        split = decode_split(dev)
        print("decode split (host clock, median of 5, ms; the batch "
              "inverse's products inside `_mul` on the parent): "
              + json.dumps({k: round(v, 4) for k, v in split.items()}))
        walls = producer_walls(dev)
        print("producer path walls (host clock, ms, [median, min, max]): "
              + json.dumps(walls))
    if after:
        digests.update(after(ms))
    batch = None
    if "bls" in groups:
        batch = sum(ms[k] for k in ("hash_to_g2", "rlc_scalar_mul",
                                    "rlc_miller_product", "final_exp_is_one"))
    card = cs.smi("name,power.limit")
    print(f"{args.label or root.name}: {card}; build {build_s:.1f} s "
          f"({', '.join(groups)}); "
          + ", ".join(f"{k} {v:.6f}" + ("" if k.endswith("_us") else " ms")
                      for k, v in ms.items())
          + ("" if batch is None
             else f"; config #2 device-hashing batch {batch:.6f} ms"))
    if launches:
        print("cuda launches a call: " + json.dumps(launches))
    print(json.dumps({"label": args.label, "root": str(root), "card": card,
                      "ms": ms, "batch_device_ms": batch,
                      "digests": digests, "cuda_launches": launches,
                      "decode_split_ms": split, "walls_ms": walls}))
    return 0


def bls_calls(cs, dev) -> dict:
    """The BLS group's calls {name: fn}: config #2's kernels, K12, the
    sharded batch's K8, K25 and K26, K16."""
    import torch

    from consensus_specs_tpu_torch import convert as CV
    from consensus_specs_tpu_torch.models.deneb import \
        polynomial_commitments as P
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as suite
    from consensus_specs_tpu_torch.ops.bls.curve import g1
    from consensus_specs_tpu_torch.ops.bls.hash_to_curve import (DST_G2,
                                                                 hash_to_g2)
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    import numpy as np

    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as Fq

    tasks, _ = cs.bls_tasks(cs.BLS_TASKS, cs.BLS_COMMITTEE, cs.BLS_SEED_BASE)

    tr = {}
    if B.batch_verify(tasks, rng=random.Random(cs.BLS_RNG_SEED), device=dev,
                      trace=tr) is not True:
        raise AssertionError("config #2 rejected")
    pk_x, pk_y, sig_x, sig_y, words, r_bits, mask = tr["inputs"]
    h_x, h_y, h_ok = tr["h_x"], tr["h_y"], tr["h_ok"]
    k9_args = (tr["apx"], tr["apy"], tr["a_inf"], tr["r_sig"], h_x, h_y,
               h_ok, mask)
    calls = {
        "hash_to_g2": lambda: K.hash_to_g2_kernel(words),
        "rlc_scalar_mul": lambda: K.rlc_scalar_mul_kernel(
            pk_x, pk_y, sig_x, sig_y, r_bits, mask),
        "rlc_miller_product": lambda: K.rlc_miller_product_kernel(*k9_args),
        "final_exp_is_one": lambda: K.final_exp_is_one_kernel(tr["miller"]),
    }

    pk, msg, sig = tasks[0]
    pairs = [(pk, hash_to_g2(msg, DST_G2)), (g1.neg(suite.G1_GEN), sig)]
    xp, yp, lines, lmask = (torch.from_numpy(a.copy()).to(dev)
                            for a in B.pairing_check_inputs(pairs))
    calls["precomp_miller_product"] = (
        lambda: K.precomp_miller_product_kernel(xp, yp, lines, lmask))

    per = B._bucket(-(-len(tasks) // SHARDS))
    arrays, _ = B._prepare_rlc_inputs(tasks, random.Random(cs.BLS_RNG_SEED),
                                      False, dev, lanes=SHARDS * per)
    t = [B._to(a[:per], dev) for a in arrays]
    apx, apy, a_inf, r_sig = K.rlc_scalar_mul_kernel(*t[:4], t[6], t[7])
    k25_args = (apx, apy, a_inf, r_sig, t[4], t[5], torch.ones_like(t[7]),
                t[7])
    sharded = {}
    if B.batch_verify_sharded(tasks, rng=random.Random(cs.BLS_RNG_SEED),
                              devices=[dev] * SHARDS,
                              trace=sharded) is not True:
        raise AssertionError("the sharded batch rejected config #2")
    calls["rlc_scalar_mul_shard"] = lambda: K.rlc_scalar_mul_kernel(
        *t[:4], t[6], t[7])
    calls["rlc_miller_shard"] = lambda: K.rlc_miller_shard_kernel(*k25_args)
    calls["rlc_shard_combine"] = lambda: K.rlc_shard_combine_kernel(
        sharded["partial_sums"], sharded["partial_f"])

    blob = CV.kzg_blobs(cs.KZG_BLOBS)[0]
    roots = [int(r) for r in P.bit_reversal_permutation(
        P.compute_roots_of_unity(P.FIELD_ELEMENTS_PER_BLOB))]
    z = P.compute_challenge(blob, P.blob_to_kzg_commitment(blob))
    args16 = tuple(torch.from_numpy(a).to(dev) for a in FB.barycentric_inputs(
        [int(v) for v in P.blob_to_polynomial(blob)], roots, int(z)))
    calls["fr_barycentric"] = lambda: FB.barycentric(*args16)

    # the field layer and the MSMs: K7 and K15 on `chip_smoke.py`'s 1024
    # random elements, K13 and K14 on its MSM probe
    r = random.Random(cs.SEED + 3)
    fq12 = [torch.from_numpy(np.stack(
        [Fq.to_mont(r.randrange(Q)) for _ in range(1024 * 12)]).reshape(
            1024, 2, 3, 2, 33)).to(dev) for _ in range(2)]
    calls["bls_field_ops_fq12_mul"] = lambda: K.field_op("fq12_mul", *fq12)
    fr = torch.from_numpy(FB.FR.to_mont_batch(
        [r.randrange(FB.R_MODULUS) for _ in range(1024)])).to(dev)
    calls["fr_field_ops_inv"] = lambda: FB.field_op("inv", fr)
    calls.update(msm_group_calls(cs, dev))
    return calls


def msm_group_calls(cs, dev) -> dict:
    """The msm group's calls {name: fn}: K13 and K14 on `chip_smoke.py`'s
    MSM probe at its MSM_SIZES; K13 on shard 0 of the probe's 512 points
    over SHARDS shards (the sharded MSM's per-shard call) and K27 on the
    SHARDS partials."""
    import numpy as np
    import torch

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    calls = {}
    for n in cs.MSM_SIZES:
        name, *_, kernel, _ = cs.msm_calls(n, dev)
        calls[f"{name}_{n}"] = kernel
    pts, ks = cs.msm_probe()
    n = 512
    per = B._bucket(-(-n // SHARDS))
    c = B._msm_window(per)
    x, y = B.C.g1_affine_to_limbs(pts[:n])
    digits = B.C.scalars_to_digits(ks[:n], B.SCALAR_BITS, c)
    shards = [tuple(torch.from_numpy(np.ascontiguousarray(
        a[s * per:(s + 1) * per])).to(dev) for a in (x, y, digits))
        for s in range(SHARDS)]
    calls[f"msm_pippenger_shard_{per}"] = (
        lambda: K.msm_pippenger_kernel(*shards[0], c))
    partials = [K.msm_pippenger_kernel(*t, c) for t in shards]
    folded = [torch.stack([p[k] for p in partials]) for k in range(3)]
    calls[f"g1_shard_fold_{SHARDS}"] = (
        lambda: K.g1_shard_fold_kernel(*folded))
    for name in calls:
        DIGESTS[name] = _points_digest
    return calls


if __name__ == "__main__":
    sys.exit(main())
