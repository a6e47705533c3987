#!/usr/bin/env python3
"""Time the BLS kernels of config #2's batch, and K16, on one CUDA card for
one checkout of the port, so that two commits compare on one card:

    python3 compare_kernels.py [--root DIR] [--label NAME]

It imports `consensus_specs_tpu_torch` from DIR (default: this script's
directory), builds that checkout's BLS and Fr libraries with its own `_build`,
and times, by CUDA events around each call with a sleep kernel ahead
(`chip_smoke.py`'s `device_ms`, whose helpers and inputs it uses):

- K11, K8, K9 and K10 on `bench_bls.py` config #2 (128 statements of
  64-key aggregates, B = 128) as `batch_verify` hashes them on the card,
  and their sum, the device-hashing batch's device time;
- K12 on the first statement's pairing check (bucket 8, 2 live lanes);
- K8 and K25 on shard 0 of the batch over 4 shards (32 lanes) and K26
  on the sharded batch's 4 partials;
- K16 on `chip_smoke.py`'s config #5 blob 0 at W = 4096, at its
  challenge (the commitment by K14 on the card).

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
SOURCES = ("bls_rlc", "bls_h2c", "bls_shard", "bls_pairing", "bls_msm",
           "fr_batch")


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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    cs = _helpers()

    import torch

    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device", file=sys.stderr)
        return 1
    from consensus_specs_tpu_torch import _build
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

    if root not in Path(_build.__file__).resolve().parents:
        raise RuntimeError(f"imported {_build.__file__}, not from {root}")
    t0 = time.perf_counter()
    _build.build(SOURCES)
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda:0")
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

    ms, digests = {}, {}
    for name, fn in calls.items():
        digests[name] = _digest(fn())
        ms[name] = cs.device_ms(fn, REPS)
    batch = sum(ms[k] for k in ("hash_to_g2", "rlc_scalar_mul",
                                "rlc_miller_product", "final_exp_is_one"))
    card = cs.smi("name,power.limit")
    print(f"{args.label or root.name}: {card}; build {build_s:.1f} s; "
          + ", ".join(f"{k} {v:.6f} ms" for k, v in ms.items())
          + f"; config #2 device-hashing batch {batch:.6f} ms")
    print(json.dumps({"label": args.label, "root": str(root), "card": card,
                      "ms": ms, "batch_device_ms": batch,
                      "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
