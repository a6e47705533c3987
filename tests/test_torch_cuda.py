"""The port's CUDA kernels K1-K27 (and K3's gather mode) against their
plain PyTorch versions on the card, bit for bit (the BLS kernels at
canonical values), at small shapes.  Every test here needs an NVIDIA
GPU and nvcc; without a card they skip.  On the card, where JAX is not
installed and so the suite's conftest cannot load:

    python -m pytest tests/test_torch_cuda.py -q -s --noconftest

The fork-choice store and config #1 tests also use the JAX package's
spec builder and test helpers, which load no JAX but need PyYAML; they
skip where it is missing.  With `-s`, config #1 prints its seconds per
block.
"""

import numpy as np
import pytest
import torch

from consensus_specs_tpu_torch import (MAINNET, IncrementalEpochStep, _build,
                                       make_epoch_step)
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.ops import sha256 as S
from consensus_specs_tpu_torch.parallel import EpochScalars
from consensus_specs_tpu_torch.parallel import epoch as E
from consensus_specs_tpu_torch.parallel import incremental as I
from consensus_specs_tpu_torch.parallel import merkle as M

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _registry(dev, n, seed=0):
    reg = C.synthetic_registry(n, seed)
    reg["proposer_index"][::7] = n + 3
    reg["proposer_index"][1::7] = -1
    reg["exit_epoch"][::5] = 100
    reg["slashed"][::9] = True
    reg["withdrawable_epoch"][::9] = 100 + MAINNET.epochs_per_slashings_vector // 2
    return C.registry_to_torch(reg, dev)


@pytest.mark.parametrize("scalars", [(100, 2, 32 * 10**9), (100, 9, 10**12),
                                     (0, 0, 0)])
def test_epoch_sweep_kernel(dev, scalars):
    reg = _registry(dev, 1000)
    sc = EpochScalars(*scalars)
    before = _build.launches["epoch_sweep"]
    got = E.epoch_sweep_kernel(reg, sc, MAINNET)
    want = E.epoch_sweep_plain(reg, sc, MAINNET)
    torch.cuda.synchronize()
    assert _build.launches["epoch_sweep"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [1, 7, 1000])
def test_sha256_kernel(dev, n):
    rng = np.random.RandomState(n)
    w = rng.randint(0, 2**32, (n, 16), dtype=np.uint64).astype(np.uint32)
    blocks = C.from_numpy_u32(w, dev)
    assert torch.equal(S.sha256_64B_words_kernel(blocks),
                       S.sha256_64B_words_plain(blocks))


@pytest.mark.parametrize("n", [8, 13, 4096])
def test_sha256_leaf_mode_kernel(dev, n):
    v = C.from_numpy_u64(np.arange(n, dtype=np.uint64) * 0x9E3779B97F4A7C15
                         % np.uint64(2**64 - 59), dev)
    assert torch.equal(S.sha256_u64_leaves_kernel(v),
                       M.hash_u64_leaves(v, plain=True))


@pytest.mark.parametrize("length", [None, 1000, 700])
def test_records_root_kernel(dev, length):
    n = 1024
    reg = _registry(dev, n, seed=1)
    leaves = C.leaves_to_torch(*C.synthetic_leaf_words(n), dev)
    args = (leaves, reg.effective_balance, reg.slashed,
            reg.activation_eligibility_epoch, reg.activation_epoch,
            reg.exit_epoch, reg.withdrawable_epoch, length)
    assert torch.equal(M.validator_records_root_kernel(*args),
                       M.validator_records_root_plain(*args))


def test_epoch_step_on_the_card(dev):
    n = 1024
    reg = _registry(dev, n, seed=2)
    leaves = C.leaves_to_torch(*C.synthetic_leaf_words(n), dev)
    sc = EpochScalars(100, 2, 32 * 10**9)
    _build.reset_launches()
    got = make_epoch_step(MAINNET, device=dev)(reg, sc, 1000, leaves)
    assert all(_build.launches[k] > 0
               for k in ("epoch_sweep", "sha256_64B", "records_root"))
    want = make_epoch_step(MAINNET, device=dev, plain=True)(
        reg, sc, 1000, leaves)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _words(dev, n, seed):
    rng = np.random.RandomState(seed)
    return C.from_numpy_u32(
        rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32), dev)


def _idx(dev, values):
    return torch.tensor(values, dtype=torch.int64, device=dev)


@pytest.mark.parametrize("depth,dirty", [
    (10, [0, 1, 2, 3, 700, 1023, 511, 512]),    # sibling pairs, 3 sparse levels
    (10, []),                                   # all sentinels
    (12, list(range(0, 4096, 61))),             # rung 1024 > 64 dirty
])
def test_update_dirty_kernel(dev, depth, dirty):
    cap = 1 << depth
    leaves = _words(dev, cap, depth)
    idx = I.pad_dirty_idx(_idx(dev, dirty), cap)
    new = _words(dev, idx.shape[0], depth + 1)
    got = I.build_layers(leaves, depth)
    want = I.build_layers(leaves, depth, plain=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    before = _build.launches["update_level"]
    I.update_dirty(got, idx, new, depth)
    I.update_dirty(want, idx, new, depth, plain=True)
    torch.cuda.synchronize()
    assert _build.launches["update_level"] > before
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("single_active", [False, True])
@pytest.mark.parametrize("scalars", [(100, 2, 32 * 10**9), (100, 2, 2**63),
                                     (100, 9, 2**64 - 1), (0, 0, 0)])
def test_epoch_sweep_kernel_edge_registry(dev, single_active, scalars):
    """K1's exact divisions and saturations at their edges: effective
    balances 0, 1, incr - 1, 2**64 - 1, delays 0, 1, 2**64 - 1, one active
    validator, a slashing adjustment equal to the active balance."""
    reg = C.registry_to_torch(C.edge_registry(4099,
                                              single_active=single_active),
                              dev)
    sc = EpochScalars(*scalars)
    got = E.epoch_sweep_kernel(reg, sc, MAINNET)
    want = E.epoch_sweep_plain(reg, sc, MAINNET)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _equal_dups(words, idx):
    first = {}
    for k, v in enumerate(idx.tolist()):
        words[k] = words[first.setdefault(v, k)]
    return words


@pytest.mark.parametrize("depth,dirty", [
    (0, [0]),                                   # one leaf, no level
    (1, [1, 1]),                                # one level, duplicates
    (10, list(range(1024))),                    # every level dense
    (10, [5, 5, 5, 9, 1023, 1023]),             # duplicates, equal words
    (12, [4095, 3, 2048, 0, 77, 3]),            # unsorted
    (12, list(range(1000, 1300))),              # one long run, rung 1024
])
def test_forest_update_kernel_edges(dev, depth, dirty):
    cap = 1 << depth
    idx = I.pad_dirty_idx(_idx(dev, dirty), cap)
    new = _equal_dups(_words(dev, idx.shape[0], depth + 2), idx)
    got = I.build_layers(_words(dev, cap, depth), depth)
    want = [lay.clone() for lay in got]
    before = _build.launches["update_level"]
    I.update_dirty(got, idx, new, depth)
    I.update_dirty(want, idx, new, depth, plain=True)
    torch.cuda.synchronize()
    assert _build.launches["update_level"] == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_forest_update_two_forests_in_one_launch(dev):
    stacks, singles, plains = [], [], []
    for depth, dirty in ((12, list(range(7, 4096, 13))), (9, [3, 4, 100])):
        cap = 1 << depth
        idx = I.pad_dirty_idx(_idx(dev, dirty), cap)
        layers = I.build_layers(_words(dev, cap, depth), depth)
        words = _words(dev, idx.shape[0], depth + 3)
        stacks.append((layers, idx, words, depth))
        singles.append(([lay.clone() for lay in layers], idx, words, depth))
        plains.append(([lay.clone() for lay in layers], idx, words, depth))
    before = _build.launches["update_level"]
    I.update_forests(stacks)
    assert _build.launches["update_level"] == before + 1
    for st in singles:
        I.update_dirty(*st)
    for st in plains:
        I.update_dirty(*st, plain=True)
    torch.cuda.synchronize()
    for a, b, c in zip(stacks, singles, plains):
        assert all(torch.equal(x, y) and torch.equal(x, z)
                   for x, y, z in zip(a[0], b[0], c[0]))


def test_balance_chunks_kernel(dev):
    n = 4099
    v = C.from_numpy_u64(np.arange(n, dtype=np.uint64) * 0x9E3779B97F4A7C15,
                         dev)
    idx = _idx(dev, [0, 3, 1024, 1025, 1 << 18, -1, 7])
    assert torch.equal(I.gather_balance_chunks(v, idx),
                       I.gather_balance_chunks(v, idx, plain=True))
    f = I.balances_forest(v, n, limit_depth=12, device=dev)
    g = I.balances_forest(v, n, limit_depth=12, device=dev, plain=True)
    assert f.root_bytes() == g.root_bytes()


@pytest.mark.parametrize("n_chunks", [1, 1000])
def test_proof_paths_kernel(dev, n_chunks):
    f = I.MerkleForest(_words(dev, n_chunks, 5), 20, n_chunks, device=dev)
    d = f.data_depth
    idx = _idx(dev, [0, 1, n_chunks - 1, 1 << 20, 513 % n_chunks])
    got = I.gather_proof_paths(f.layers, idx, d)
    want = I.gather_proof_paths(f.layers, idx, d, plain=True)
    assert got[1].shape == (5, d, 8)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    root = f.root_bytes()
    assert all(I.verify_proof(p, root)
               for p in f.emit_proofs([0, n_chunks - 1]))


@pytest.mark.parametrize("m,length", [(5, None), (1, None), (32, None),
                                      (33, None), (128, None), (129, None),
                                      (200, None), (200, 150), (33, 31),
                                      (16384, None)])
def test_records_root_gather_kernel(dev, m, length):
    """K3's gather mode (a block tree of records) against the plain
    version: one record, a block and one past it, repeated indices,
    indices past N and negative ones (clamped), pad rows (length < M),
    and the incremental step's rung of 16384."""
    n = 1024
    reg = _registry(dev, n, seed=3)
    leaves = C.leaves_to_torch(*C.synthetic_leaf_words(n), dev)
    if m == 5:
        idx = I.pad_dirty_idx(_idx(dev, [5, 1023, 0, 77, 77]), n)
    else:
        g = torch.Generator().manual_seed(m)
        idx = torch.randint(0, n, (m,), generator=g)
        idx[::7] = int(idx[0])
        idx[1::11] = n + 5
        idx[m - 1:] = -1
        idx = idx.to(dev)
    args = (leaves, reg.effective_balance, reg.slashed,
            reg.activation_eligibility_epoch, reg.activation_epoch,
            reg.exit_epoch, reg.withdrawable_epoch, length)
    before = _build.launches["records_root_gather"]
    got = M.validator_records_root_kernel(*args, index=idx)
    assert _build.launches["records_root_gather"] == before + 1
    assert torch.equal(got, M.validator_records_root_plain(*args, index=idx))


_BLS_KERNELS = ("bls_field_ops", "rlc_scalar_mul", "rlc_miller_product",
                "final_exp_is_one", "hash_to_g2", "precomp_miller_product",
                "msm_pippenger", "msm_double_add")
_FR_KERNELS = ("fr_field_ops", "fr_barycentric", "fr_coset_interpolate",
               "fr_fft")
_G1FFT_KERNELS = ("g1_fft", "fk20_hext")
_FC_KERNELS = ("fc_apply", "fc_refresh", "fc_head")
_SHARD_KERNELS = ("epoch_sweep_sharded", "rlc_miller_shard",
                  "rlc_shard_combine", "g1_shard_fold")


def test_incremental_step_on_the_card(dev):
    n = 4096
    reg = _registry(dev, n, seed=4)
    pk, cred, dirty = C.incremental_step_inputs(n)
    leaves = C.leaves_to_torch(pk, cred, dev)
    sc = EpochScalars(100_000, 2, 32 * 10**9)
    _build.reset_launches()
    got = IncrementalEpochStep(MAINNET, reg, sc, leaves, dirty, device=dev)()
    assert all(v > 0 for k, v in _build.launches.items()
               if k != "proof_paths"
               and k not in _BLS_KERNELS + _FR_KERNELS + _G1FFT_KERNELS
               + _FC_KERNELS + _SHARD_KERNELS)
    want = IncrementalEpochStep(MAINNET, reg, sc, leaves, dirty, device=dev,
                                plain=True)()
    assert all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))


# --- slice 3: the BLS kernels K7-K10 ---------------------------------------------


def _bls_rand(dev, shape, seed):
    import random

    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    r = random.Random(seed)
    n = int(np.prod(shape))
    return torch.from_numpy(np.stack([F.to_mont(r.randrange(Q))
                                      for _ in range(n)]).reshape(
        tuple(shape) + (33,))).to(dev)


@pytest.mark.parametrize("op,k", [
    ("fq_mul", 0), ("fq_inv", 0), ("fq_canon", 0), ("fq2_mul", 0),
    ("fq2_inv", 0), ("fq12_mul", 0), ("fq12_sqr", 0), ("fq12_inv", 0),
    ("fq12_frobenius", 1), ("fq12_frobenius", 2), ("fq12_frobenius", 6),
    ("fq_add", 0), ("fq_sub", 0)])
def test_bls_field_ops_kernel(dev, op, k):
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    dims = K.FIELD_OPS[op][1]
    shape = {1: (64,), 2: (64, 2), 4: (16, 2, 3, 2)}[dims]
    a, b = _bls_rand(dev, shape, 1), _bls_rand(dev, shape, 2)
    a[0] = 0                                   # inv(0) = 0, products by 0
    if op == "fq_canon":                       # signed-lazy limbs
        a = torch.from_numpy(np.random.RandomState(3).randint(
            -2**13, 2**13, (64, 33)).astype(np.int32)).to(dev)
    before = _build.launches["bls_field_ops"]
    got = K.field_op(op, a, b, k)
    torch.cuda.synchronize()
    assert _build.launches["bls_field_ops"] == before + 1
    assert torch.equal(got, K.field_op(op, a, b, k, plain=True))



def _edge_word_pairs(m: int, R: int, seed: int) -> list:
    """(a, b) pairs of a field's kernel words (x R mod m) on the edges of
    the carry chains and the product: a + b = m, m - 1, m + 1 and
    2m - 2; a < b, a = b, 0 and m - 1; the words of -1 twice, whose
    product is (m - 1)^2 as field elements; and random pairs."""
    import random

    r = random.Random(seed)
    h, neg_one = m // 2, m - R % m
    pairs = [(1, m - 1), (h, m - h), (m - 2, 1), (m - 1, 2), (m - 1, m - 1),
             (0, 0), (1, 2), (5, 5), (h, h + 1), (h + 1, h), (0, m - 1),
             (m - 1, 0), (0, 1), (neg_one, neg_one)]
    return pairs + [(r.randrange(m), r.randrange(m)) for _ in range(18)]


@pytest.mark.parametrize("field", ["fp", "fr"])
@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_field_chains_against_python_ints(dev, field, op):
    """`csrc/mont.cuh`'s addition and subtraction (one PTX carry chain
    each) and column product, through K7 (Fp) and K15 (Fr), at the
    words of `_edge_word_pairs`, against Python ints."""
    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    if field == "fp":
        m, R = Q, K.R_KERNEL
    else:
        m, R = FB.R_MODULUS, 1 << 256
    inv_r = pow(R, -1, m)
    pairs = _edge_word_pairs(m, R, 7)
    xs = [a * inv_r % m for a, _ in pairs]
    ys = [b * inv_r % m for _, b in pairs]
    if field == "fp":
        a, b = (torch.from_numpy(np.stack([F.to_mont(v) for v in vs])).to(dev)
                for vs in (xs, ys))
        got = [F.from_mont(row)
               for row in K.field_op(f"fq_{op}", a, b).cpu().numpy()]
    else:
        a, b = (torch.from_numpy(FB.FR.to_mont_batch(vs)).to(dev)
                for vs in (xs, ys))
        got = FB.from_limbs(FB.field_op(op, a, b))
    want = {"add": [(x + y) % m for x, y in zip(xs, ys)],
            "sub": [(x - y) % m for x, y in zip(xs, ys)],
            "mul": [x * y % m for x, y in zip(xs, ys)]}[op]
    assert got == want


def test_g1_product_chain_against_python_ints(dev):
    """The g1_fft library's one product call (K19's and K20's), a^(2^n),
    at -1, at the words m - 1 and 1, at 0 and at random values, against
    Python ints."""
    import random

    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    inv_r = pow(K.R_KERNEL, -1, Q)
    r = random.Random(8)
    xs = [Q - 1, (Q - 1) * inv_r % Q, inv_r, 0, 1]
    xs += [r.randrange(Q) for _ in range(3)]
    for x in xs:
        for n in (1, 3):
            got = K.g1_product_chain(torch.from_numpy(F.to_mont(x)).to(dev),
                                     n)
            assert F.from_mont(got.cpu().numpy()) == pow(x, 2**n, Q), (x, n)


def _bls_tasks(n, forge=None):
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs

    out = []
    for t in range(n):
        sk = 1000 + t
        msg = (77 + t).to_bytes(32, "little")
        out.append(cs.parse_fast_aggregate_task(
            [cs.SkToPk(sk)], msg, cs.Sign(sk + (t == forge), msg)))
    return out


def test_rlc_kernels_against_plain_at_bucket_8(dev):
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    _build.reset_launches()
    trace = {}
    assert B.batch_verify(_bls_tasks(2), rng=random.Random(5), device=dev,
                          device_h2c=False, trace=trace) is True
    assert [_build.launches[k] for k in (
        "rlc_scalar_mul", "rlc_miller_product", "final_exp_is_one")] == [1] * 3
    plain = {}
    B._rlc_pairing_core(*trace["inputs"][:6], torch.ones_like(
        trace["inputs"][7]), trace["inputs"][6], trace["inputs"][7],
        plain=True, trace=plain)

    def canon(x):
        if isinstance(x, tuple):
            return tuple(canon(v) for v in x)
        return x if x.dtype == torch.bool else F.fq_canon(x)

    for part in ("apx", "apy", "a_inf", "r_sig", "sum_sig", "miller",
                 "final_exp", "ok"):
        got, want = trace[part], canon(plain[part])
        if isinstance(got, tuple):
            assert all(torch.equal(g, w) for g, w in zip(got, want)), part
        else:
            assert torch.equal(got, want), part
    assert trace["a_inf"].tolist() == [False] * 2 + [True] * 6


def test_batch_verify_runs_on_the_card_by_default(dev):
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve

    _build.reset_launches()
    assert B.batch_verify(_bls_tasks(3), rng=random.Random(1)) is True
    assert _build.launches["final_exp_is_one"] == 1
    assert _build.launches["hash_to_g2"] == 1        # hashed on the card
    assert B.batch_verify(_bls_tasks(3, forge=2), rng=random.Random(1)) \
        is False
    tasks = _bls_tasks(2)
    tasks[1] = (tasks[1][0], tasks[1][1], curve.g2.infinity())
    _build.reset_launches()
    assert B.batch_verify(tasks, rng=random.Random(1)) is False
    assert B.batch_verify(tasks, device_h2c=True) is False
    assert _build.launches["precomp_miller_product"] >= 2


def test_deferred_batch_settles_on_the_card(dev):
    import random

    from consensus_specs_tpu_torch.ops import bls as BLS
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs

    assert BLS.backend_name() == "torch"            # the default
    with BLS.deferred_batch_verification() as batch:
        for t in range(2):
            msg = (5 + t).to_bytes(32, "little")
            assert BLS.FastAggregateVerify([cs.SkToPk(9 + t)], msg,
                                           cs.Sign(9 + t, msg))
    _build.reset_launches()
    assert batch.verify(rng=random.Random(2)) is True
    assert _build.launches["final_exp_is_one"] == 1
    assert [h.result() for h in batch.handles] == [True, True]


def _canon(x):
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    if isinstance(x, tuple):
        return tuple(_canon(v) for v in x)
    return x if x.dtype == torch.bool else F.fq_canon(x)


def _all_equal(got, want):
    return all(torch.equal(g, w) for g, w in zip(got, _canon(want)))


def test_hash_to_g2_kernel(dev):
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls.hash_to_curve import (DST_G2,
                                                                 hash_to_g2)
    from consensus_specs_tpu_torch.ops.bls_batch import h2c
    from consensus_specs_tpu_torch.ops.bls_batch import tower as T

    rng = random.Random(4)
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(3)]
    msgs.append(b"\x00" * 32)
    words = torch.from_numpy(h2c.msgs_to_words(msgs).view(np.int32)).to(dev)
    before = _build.launches["hash_to_g2"]
    got = B.hash_to_g2_affine(words)
    torch.cuda.synchronize()
    assert _build.launches["hash_to_g2"] == before + 1
    assert _all_equal(got, B.hash_to_g2_affine(words, plain=True))
    for i, m in enumerate(msgs):
        x, y = curve.g2.to_affine(hash_to_g2(m, DST_G2))
        assert (T.fq2_to_oracle(got[0][i]), T.fq2_to_oracle(got[1][i])) == \
            (x, y)


def test_precomp_miller_product_kernel(dev):
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as C

    p = C.g1.mul(C.G1_GEN, 1337)
    for k2 in (97531, 97532):
        pairs = [(p, C.g2.mul(C.G2_GEN, 97531)),
                 (C.g1.mul(C.g1.neg(p), k2), C.G2_GEN)]
        args = [torch.from_numpy(a).to(dev)
                for a in B.pairing_check_inputs(pairs)]
        before = _build.launches["precomp_miller_product"]
        got = B.precomp_miller_product(*args)
        torch.cuda.synchronize()
        assert _build.launches["precomp_miller_product"] == before + 1
        assert torch.equal(got, _canon(B.precomp_miller_product(
            *args, plain=True)))
        assert B.pairing_check_device(pairs) is (k2 == 97531)


@pytest.mark.parametrize("n_live,bucket", [(1, 8), (2, 8), (5, 8), (6, 8),
                                           (8, 8), (32, 32)])
def test_precomp_miller_product_edge_shapes(dev, n_live, bucket):
    """K12 (the lines at P, one group of 6 threads per live lane over
    blocks of 5 lanes, the fold) at bucket 8 with 1, 2, 5, 6 and 8 live
    lanes and at bucket 32 with 32: equal to its plain version, one
    count a call."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as C
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    r = random.Random(90 + n_live)
    pairs = [(C.g1.mul(C.G1_GEN, r.randrange(1, 2**64)),
              C.g2.mul(C.G2_GEN, r.randrange(1, 2**64)))
             for _ in range(n_live)]
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in B.pairing_check_inputs(pairs)]
    assert args[0].shape[0] == bucket
    before = _build.launches["precomp_miller_product"]
    got = K.precomp_miller_product_kernel(*args)
    torch.cuda.synchronize()
    assert _build.launches["precomp_miller_product"] == before + 1
    assert torch.equal(got, _canon(B.precomp_miller_product(*args,
                                                            plain=True)))


def test_final_exp_is_one_edge_inputs(dev):
    """K10 (one group of 18 threads: the windowed inversion, cyclotomic
    squares) at f = 1, f = 0, a random Fq12, an accepted batch's Miller
    value and a rejected one's: equal to its plain version, the verdicts
    true, false, false, true, false."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.bls_batch import pairing as P
    from consensus_specs_tpu_torch.ops.bls_batch import tower as T

    r = random.Random(17)
    rand = np.stack([F.to_mont(r.randrange(Q)) for _ in range(12)])
    fs = [F.const(T.FQ12_ONE_L, dev), torch.zeros((2, 3, 2, 33),
                                                 dtype=torch.int32,
                                                 device=dev),
          torch.from_numpy(rand.reshape(2, 3, 2, 33)).to(dev)]
    for forge in (None, 1):
        trace = {}
        B.batch_verify(_bls_tasks(3, forge), rng=random.Random(3),
                       device=dev, device_h2c=False, trace=trace)
        fs.append(trace["miller"])
    before = _build.launches["final_exp_is_one"]
    got = [K.final_exp_is_one_kernel(f.contiguous()) for f in fs]
    torch.cuda.synchronize()
    assert _build.launches["final_exp_is_one"] == before + len(fs)
    want = F.fq_canon(P.final_exponentiate(torch.stack(fs)))
    for (fe, ok), w in zip(got, want):
        assert torch.equal(fe, w)
        assert bool(ok.item()) == bool(T.fq12_is_one(w))
    assert [bool(ok.item()) for _, ok in got] == [True, False, False, True,
                                                  False]


@pytest.mark.parametrize("n,algo", [(8, "pippenger"), (16, "pippenger"),
                                    (128, "pippenger"), (8, "double-add"),
                                    (40, "double-add")])
def test_msm_kernels(dev, n, algo):
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as C

    pts = [C.g1.mul(C.G1_GEN, 3 * i + 2) for i in range(n)]
    ks = [pow(5, i + 1, C.R) for i in range(n)]
    ks[1] = 0
    pts[2] = C.g1.infinity()
    _, c, arrays = B.msm_inputs(pts, ks, algo)
    t = tuple(torch.from_numpy(a).to(dev) for a in arrays)
    name = "msm_pippenger" if algo == "pippenger" else "msm_double_add"
    before = _build.launches[name]
    if algo == "pippenger":
        got = B.msm_pippenger(*t, c)
        want = B.msm_pippenger(*t, c, plain=True)
    else:
        got = B.msm_double_add(*t)
        want = B.msm_double_add(*t, plain=True)
    torch.cuda.synchronize()
    assert _build.launches[name] == before + 1
    assert _all_equal(got, want)
    assert C.g1.eq_points(B.g1_multi_exp_device(pts, ks, algo=algo),
                          C.g1.msm(pts, ks))


def _msm_edge_digits(c, n, seed):
    """K13's edge inputs at window c over n points (limbs x, y and digits
    (n, W)): seeded multiples of G1 where point 1 repeats point 0, point 2
    is its negative and point 4 the negative of point 3; window 0 all zero
    digits; every point in the top bucket of window 1 (one chain n long,
    through P + P and Q - Q); points 0-2 alone in bucket 3 of window 2 (P
    then P doubles, then -P); points 3-5 in bucket 5 of window 3 (Q then
    -Q gives infinity, point 5 brings the bucket back); the last two
    points all zero digits.  Returns (pts, x, y, digits)."""
    import random

    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC

    r = random.Random(seed)
    nb, W = 1 << c, -(-255 // c)
    mults = [r.randrange(1, 2**64) for _ in range(n)]
    mults[1], mults[2] = mults[0], Cv.R - mults[0]
    mults[4] = Cv.R - mults[3]
    pts = [Cv.g1.mul(Cv.G1_GEN, m) for m in mults]
    x, y = BC.g1_affine_to_limbs(pts)
    digits = np.array([[r.randrange(nb) for _ in range(W)]
                       for _ in range(n)], np.int32)
    digits[:, 0] = 0
    digits[:, 1] = nb - 1
    digits[3:, 2][digits[3:, 2] == 3] = 2
    digits[:3, 2] = 3
    digits[:3, 3][digits[:3, 3] == 5] = 6
    digits[3:6, 3] = 5
    digits[-2:] = 0
    return pts, x, y, digits


@pytest.mark.parametrize("c,n", [(4, 16), (6, 64), (8, 256), (4, 8)])
def test_msm_pippenger_edges(dev, c, n):
    """K13 at c = 4, 6, 8 on `_msm_edge_digits` against its plain version
    (flags where Z = 0) and the oracle's g1.msm of the digits' scalars;
    (4, 8): four pairs P, -P with equal digits, whose sum is infinity."""
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC

    if n == 8:
        pts = [Cv.g1.mul(Cv.G1_GEN, 7 + i // 2) for i in range(n)]
        pts = [p if i % 2 == 0 else Cv.g1.neg(p) for i, p in enumerate(pts)]
        x, y = BC.g1_affine_to_limbs(pts)
        digits = np.repeat(BC.scalars_to_digits(
            [3 ** (i + 40) % Cv.R for i in range(n // 2)], 255, c), 2, 0)
    else:
        pts, x, y, digits = _msm_edge_digits(c, n, seed=c)
    t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in (x, y, digits))
    got = B.msm_pippenger(*t, c)
    assert _same_points(got, B.msm_pippenger(*t, c, plain=True))
    W = digits.shape[1]
    ks = [sum(int(d) << (c * (W - 1 - w)) for w, d in enumerate(row))
          for row in digits]
    want = Cv.g1.msm(pts, ks)
    assert Cv.g1.eq_points(B.C.g1_limbs_to_oracle(got), want)
    assert Cv.g1.is_inf(want) == (n == 8)


def _double_add_edges(n, seed):
    """K14's edge inputs over n lanes (x, y, bits, mask): seeded points
    and 255-bit scalars; the G1 point (0, 2) of order 3 with scalars 3
    (T = -Q gives infinity) and 5 (T = Q doubles); scalars 1, r - 1 and
    2^254; a zero scalar on a live lane; lanes 2 and 2 + n/2 equal (the
    tree's first level meets P + P), lanes 3 and 3 + n/2 opposite (P +
    (-P)); masked lanes in the middle and at the end."""
    import random

    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    r = random.Random(seed)
    h = n // 2
    pts = [Cv.g1.mul(Cv.G1_GEN, r.randrange(1, 2**64)) for _ in range(n)]
    ks = [r.randrange(Cv.R) for _ in range(n)]
    ks[:6] = [3, 5, 1, Cv.R - 1, 2**254, 0]
    pts[2 + h], ks[2 + h] = pts[2], 1
    pts[3 + h], ks[3 + h] = pts[3], 1
    x, y = BC.g1_affine_to_limbs(pts)
    x[:2], y[:2] = F.to_mont(0), F.to_mont(2)
    mask = np.ones(n, bool)
    mask[[h, n - 1]] = False
    return x, y, BC.scalars_to_bits(ks, 255), mask


@pytest.mark.parametrize("n", [16, 64])
def test_msm_double_add_edges(dev, n):
    """K14 on `_double_add_edges` against its plain version (flags where
    Z = 0)."""
    from consensus_specs_tpu_torch.ops import bls_batch as B

    t = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
              for a in _double_add_edges(n, seed=n))
    got = B.msm_double_add(*t)
    assert _same_points(got, B.msm_double_add(*t, plain=True))


def test_facade_eager_calls_and_multi_exp_on_the_card(dev):
    from consensus_specs_tpu_torch.ops import bls as BLS
    from consensus_specs_tpu_torch.ops.bls import ciphersuite as cs

    assert BLS.backend_name() == "torch"
    msg = b"\x07" * 32
    pks = [cs.SkToPk(sk) for sk in (3, 4)]
    sig = cs.Aggregate([cs.Sign(sk, msg) for sk in (3, 4)])
    _build.reset_launches()
    assert BLS.FastAggregateVerify(pks, msg, sig) is True
    assert BLS.FastAggregateVerify(pks, b"\x08" * 32, sig) is False
    assert BLS.Verify(pks[0], msg, cs.Sign(3, msg)) is True
    assert BLS.AggregateVerify(pks, [msg, msg], sig) is True
    assert _build.launches["precomp_miller_product"] == 4
    pts = [(1, cs.G1_GEN)] * 16
    got = BLS.multi_exp(pts, list(range(1, 17)))
    assert _build.launches["msm_pippenger"] == 1
    assert BLS.eq(got, BLS.multiply(BLS.G1(), sum(range(1, 17))))


# --- slice 5: the scalar field, KZG and DAS (K15-K18) ------------------------


def _fr_rand(dev, n, seed):
    import random

    from consensus_specs_tpu_torch.ops import fr_batch as FB

    r = random.Random(seed)
    xs = [0, 1, FB.R_MODULUS - 1] + [r.randrange(FB.R_MODULUS)
                                     for _ in range(n - 3)]
    return torch.from_numpy(FB.FR.to_mont_batch(xs)).to(dev)


@pytest.mark.parametrize("op", ["mul", "add", "sub", "inv", "pow", "canon"])
def test_fr_field_ops_kernel(dev, op):
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    a, b = _fr_rand(dev, 64, 1), _fr_rand(dev, 64, 2).flip(0)
    if op == "canon":                          # signed-lazy limbs
        a = torch.from_numpy(np.random.RandomState(4).randint(
            -2**13, 2**13, (64, 33)).astype(np.int32)).to(dev)
    two = op in ("mul", "add", "sub")
    before = _build.launches["fr_field_ops"]
    got = FB.field_op(op, a, b if two else None, 4096)
    torch.cuda.synchronize()
    assert _build.launches["fr_field_ops"] == before + 1
    assert torch.equal(got, FB.field_op(op, a, b if two else None, 4096,
                                        plain=True))


@pytest.mark.parametrize("width,shift", [(64, 1), (64, 5), (4096, 1)])
def test_fr_barycentric_kernel(dev, width, shift):
    import random

    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    g = pow(7, (R - 1) // width, R)
    domain = [shift * pow(g, i, R) % R for i in range(width)]
    rng = random.Random(width + shift)
    poly = [rng.randrange(R) for _ in range(width)]
    z = rng.randrange(R)
    args = tuple(torch.from_numpy(a).to(dev) for a in FB.barycentric_inputs(
        poly, domain, z, shift))
    before = _build.launches["fr_barycentric"]
    got = FB.barycentric(*args)
    torch.cuda.synchronize()
    assert _build.launches["fr_barycentric"] == before + 1
    if width <= 64:
        assert torch.equal(got, FB.FR.canon(FB.barycentric(*args,
                                                           plain=True)))
    want = FB.barycentric_eval(poly, domain, z, shift, device="cpu") \
        if width <= 64 else None
    got_int = FB.barycentric_eval(poly, domain, z, shift, device=dev)
    assert want is None or got_int == want
    assert FB.from_limbs(got) == [got_int]


@pytest.mark.parametrize("n_cells", [3, 130])
def test_fr_coset_interpolate_kernel(dev, n_cells):
    import random

    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    rng = random.Random(n_cells)
    ev = [[rng.randrange(R) for _ in range(64)] for _ in range(n_cells)]
    wt = [[rng.randrange(R) for _ in range(64)] for _ in range(n_cells)]
    m = [[rng.randrange(R) for _ in range(64)] for _ in range(64)]
    args = tuple(torch.from_numpy(a).to(dev) for a in
                 FB.coset_interpolate_inputs(ev, m, wt))
    before = _build.launches["fr_coset_interpolate"]
    got = FB.coset_interpolate(*args)
    torch.cuda.synchronize()
    assert _build.launches["fr_coset_interpolate"] == before + 1
    assert torch.equal(got, FB.FR.canon(FB.coset_interpolate(*args,
                                                              plain=True)))
    want = [sum(w[j] * sum(e[i] * m[i][j] for i in range(64))
                for e, w in zip(ev, wt)) % R for j in range(64)]
    assert FB.from_limbs(got) == want


@pytest.mark.parametrize("n_cells", [16, 128, 1024])
def test_fr_coset_interpolate_rungs(dev, n_cells):
    """K17 at the DAS ladder's rungs (its tiles: 32 fold blocks at 16, 128
    at 128 and 1024) against its plain version."""
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    rng = np.random.RandomState(n_cells)
    rows = lambda n: [[int.from_bytes(rng.bytes(32), "little") % R
                       for _ in range(64)] for _ in range(n)]
    args = tuple(torch.from_numpy(a).to(dev) for a in
                 FB.coset_interpolate_inputs(rows(n_cells), rows(64),
                                             rows(n_cells)))
    before = _build.launches["fr_coset_interpolate"]
    got = FB.coset_interpolate(*args)
    torch.cuda.synchronize()
    assert _build.launches["fr_coset_interpolate"] == before + 1
    assert torch.equal(got, FB.FR.canon(FB.coset_interpolate(*args,
                                                              plain=True)))


@pytest.mark.parametrize("packed", [False, True])
def test_fr_coset_interpolate_worst_case(dev, packed):
    """K17's lazy sums at their largest: every input r - 1 at B = 1024,
    as a field element, and as limbs whose value is r - 1 (the largest
    value the fold multiplies)."""
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    if packed:
        one = torch.tensor([((R - 1) >> (12 * k)) & 0xFFF for k in range(33)],
                           dtype=torch.int32)
    else:
        one = torch.from_numpy(FB.FR.to_mont_batch([R - 1]))[0]
    ev = one.expand(1024, 64, 33).contiguous().to(dev)
    m = one.expand(64, 64, 33).contiguous().to(dev)
    got = FB.coset_interpolate(ev, m, ev.clone())
    assert torch.equal(got, FB.FR.canon(FB.coset_interpolate(
        ev, m, ev.clone(), plain=True)))


@pytest.mark.parametrize("n,batch,inverse", [(8, 2, False), (128, 2, True),
                                             (4096, 1, True),
                                             (8192, 1, False)])
def test_fr_fft_kernel(dev, n, batch, inverse):
    import random

    from consensus_specs_tpu_torch.das import compute as DC
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    g = pow(7, (R - 1) // n, R)
    roots = [pow(g, i, R) for i in range(n)]
    rng = random.Random(n)
    rows = [[rng.randrange(R) for _ in range(n)] for _ in range(batch)]
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in FB.fft_inputs(rows, roots, inverse))
    before = _build.launches["fr_fft"]
    got = FB.fft(*args)
    torch.cuda.synchronize()
    assert _build.launches["fr_fft"] == before + 1
    assert torch.equal(got, FB.FR.canon(FB.fft(*args, plain=True)))
    host = DC._ifft if inverse else DC._fft
    assert FB.fr_fft(rows, roots, inverse, device=dev) == \
        [host(r, roots) for r in rows]


@pytest.mark.parametrize("batch,n,inverse", [
    (1, 8192, False), (1, 8192, True), (2, 8192, False), (1, 4096, True),
    (64, 128, False), (1, 2, False), (1, "T", False), (1, "2T", True),
    (3, "2T", False), (1, "max", False)])
def test_fr_fft_kernel_shapes(dev, batch, n, inverse):
    """K18 against its plain version at the paths' shapes, the tile's
    edges (n = 2, T, 2T at T = `FFT_TILE`) and the largest n it takes."""
    import random

    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    T = FK.FFT_TILE
    n = {"T": T, "2T": 2 * T, "max": T * FK.FFT_CLASS_MAX}.get(n, n)
    R = FB.R_MODULUS
    g = pow(7, (R - 1) // n, R)
    roots = [pow(g, i, R) for i in range(n)]
    rng = random.Random(n + batch)
    rows = [[rng.randrange(R) for _ in range(n)] for _ in range(batch)]
    args = tuple(torch.from_numpy(a).to(dev)
                 for a in FB.fft_inputs(rows, roots, inverse))
    before = _build.launches["fr_fft"]
    got = FK.fft_kernel(*args)
    torch.cuda.synchronize()
    assert _build.launches["fr_fft"] == before + 1
    assert torch.equal(got, FB.FR.canon(FB.fft(*args, plain=True)))


def test_fr_inv_edges(dev):
    """K15's `inv` (the binary inversion) on 0, 1, r - 1 and 2."""
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R = FB.R_MODULUS
    x = torch.from_numpy(FB.FR.to_mont_batch([0, 1, R - 1, 2])).to(dev)
    got = FB.field_op("inv", x)
    assert torch.equal(got, FB.field_op("inv", x, plain=True))
    assert FB.from_limbs(got) == [0, 1, R - 1, pow(2, R - 2, R)]


@pytest.mark.parametrize("n,zero", [(1, False), (2, False), (8, False),
                                    (1027, False), (8192, False),
                                    (8192, True), (65539, False),
                                    (65539, True)])
def test_fr_batch_inverse_kernel(dev, n, zero):
    """K15's batch inverse in one launch against its plain product tree
    and the ints' inverses; a zero element makes every output 0.  Past
    256 blocks of 256 threads (n = 65539) each thread takes a run."""
    import random

    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    R = FB.R_MODULUS
    rng = random.Random(n)
    vals = [rng.randrange(1, R) for _ in range(n)]
    if zero:
        vals[n // 2] = 0
    x = torch.from_numpy(FB.FR.to_mont_batch(vals)).to(dev)
    before = _build.launches["fr_field_ops"]
    got = FK.batch_inverse_kernel(x)
    torch.cuda.synchronize()
    assert _build.launches["fr_field_ops"] == before + 1
    assert torch.equal(got, FB.batch_inverse(x, plain=True))
    assert FB.from_limbs(got) == ([0] * n if zero
                                  else [pow(v, R - 2, R) for v in vals])


def test_recovery_decode_launches(dev):
    """The recovery's decode on the card: 6 K15 launches (5 products and
    the batch inverse) and 4 K18, its coefficients equal to the plain
    decode's."""
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch.das import recover as RC
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    _, cells, _, _ = C.closed_form_blob()
    keep = list(range(0, 128, 2))
    rows = RC._cell_rows([cells[k] for k in keep])
    _build.reset_launches()
    got = RC._recover_coefficient_limbs(keep, rows, dev)
    torch.cuda.synchronize()
    assert _build.launches["fr_field_ops"] == 6
    assert _build.launches["fr_fft"] == 4
    want = RC._recover_coefficient_limbs(keep, rows, torch.device("cpu"))
    assert torch.equal(got.cpu(), FB.FR.canon(want))


def test_fr_product_chain(dev):
    """The latency probe: a^(2^n) by n dependent products."""
    from consensus_specs_tpu_torch.ops import fr_batch as FB
    from consensus_specs_tpu_torch.ops.fr_batch import kernels as FK

    a = torch.from_numpy(FB.FR.to_mont(7)).to(dev)
    for n in (0, 1, 100):
        assert FB.from_limbs(FK.fr_product_chain(a, n)) == \
            [pow(7, 2**n, FB.R_MODULUS)]


def test_kzg_das_and_cells_on_the_card(dev):
    """The three slice-5 paths at small size through the facade's default
    device: a Deneb KZG verify (K16, K12 -> K10), a DAS batch verify
    (K17, K13, K12 -> K10) and its isolation, `evaluate_cells_at` (K16)
    and `compute_cells` (K18)."""
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch import das as D
    from consensus_specs_tpu_torch.models.deneb import \
        polynomial_commitments as P
    from consensus_specs_tpu_torch.ops.bls import curve as Cv

    R = P.BLS_MODULUS
    roots = [int(r) for r in P.bit_reversal_permutation(
        P.compute_roots_of_unity(P.FIELD_ELEMENTS_PER_BLOB))]
    blob = b"".join(int.to_bytes((5 * x + 7) % R, 32, "big") for x in roots)
    s0, s1 = (Cv.g1_from_bytes(P.KZG_SETUP_G1_MONOMIAL[i]) for i in (0, 1))
    com = Cv.g1_to_bytes(Cv.g1.add(Cv.g1.mul(s1, 5), Cv.g1.mul(s0, 7)))
    proof = Cv.g1_to_bytes(Cv.g1.mul(s0, 5))
    _build.reset_launches()
    assert P.verify_blob_kzg_proof_batch([blob], [com], [proof]) is True
    assert _build.launches["fr_barycentric"] == 1
    assert P.verify_blob_kzg_proof_batch([blob], [com],
                                         [Cv.g1_to_bytes(s0)]) is False

    com_b, idx, cells, proofs = D.closed_form_matrix(2, columns=[0, 3, 64,
                                                                 127])
    _build.reset_launches()
    assert D.verify_cell_proof_batch(com_b, idx, cells, proofs) is True
    assert _build.launches["fr_coset_interpolate"] == 1
    assert _build.launches["msm_pippenger"] == 3
    bad = list(cells)
    bad[2] = bad[2][:-32] + int.to_bytes(7, 32, "big")
    assert D.verify_and_isolate(com_b, idx, bad, proofs) == \
        (False, [k != 2 for k in range(8)])
    z = 0xFEEDFACE
    assert D.evaluate_cells_at(cells[:2], idx[:2], z) == \
        D.evaluate_cells_at(cells[:2], idx[:2], z, device=False)
    blob, true_cells, _, _ = C.closed_form_blob()
    _build.reset_launches()
    assert D.compute_cells(blob) == true_cells
    assert _build.launches["fr_fft"] == 2


# --- slice 6: K19 and K20, the PeerDAS producer and recovery ---------------------


def _same_points(got, plain):
    """K19/K20 output against the plain version's: canonical coordinates
    equal where Z != 0, the Z = 0 flag equal elsewhere."""
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F

    gx, gy, gz = got
    px, py, pz = (F.fq_canon(c) for c in plain)
    inf = (pz == 0).all(-1)
    assert torch.equal((gz == 0).all(-1), inf)
    live = ~inf
    return all(torch.equal(g[live], p[live])
               for g, p in ((gx, px), (gy, py), (gz, pz)))


@pytest.mark.parametrize("n,batch,inverse", [(8, 2, False), (8, 2, True),
                                             (16, 3, True), (8, 1, False),
                                             (16, 1, False), (16, 3, False),
                                             (8, 3, True)])
def test_g1_fft_kernel(dev, n, batch, inverse):
    """K19 against its plain version, the naive evaluation and the round
    trip (held against the plain version too: at n = 8 its last round
    meets u - t = 2u, the addition's doubling branch), on rows ending in
    two infinities; row 1 has two masked lanes (Z = 0 under a point's X
    and Y) and row 2 is masked whole."""
    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G

    rows, limbs = [], []
    for b in range(batch):
        row = [Cv.g1.mul(Cv.G1_GEN, 3 + 7 * b + i) for i in range(n - 2)]
        row += [Cv.g1.infinity()] * 2
        lb = G.points_to_limbs(row)
        for k in {1: (1, n - 3), 2: range(n)}.get(b, ()):
            lb[2][k] = 0
            row[k] = Cv.g1.infinity()
        rows.append(row)
        limbs.append(lb)
    x, y, z = (torch.from_numpy(np.stack([lb[i] for lb in limbs])).to(dev)
               for i in range(3))
    perm = torch.tensor(G._bitrev_perm(n), device=dev)
    args = tuple(c[:, perm] for c in (x, y, z))
    before = _build.launches["g1_fft"]
    got = G.fft(*args, inverse=inverse)
    torch.cuda.synchronize()
    assert _build.launches["g1_fft"] == before + 1
    assert _same_points(got, G.fft(*args, inverse=inverse, plain=True))
    # against the naive evaluation, and the round trip
    out = G.limbs_to_oracle_list(got)
    dom = G.fft_domain(n)
    if inverse:
        dom = [dom[0]] + list(dom[:0:-1])
    inv_n = pow(n, G.R_MODULUS - 2, G.R_MODULUS) if inverse else 1
    for b, row in enumerate(rows):
        for i in range(n):
            want = Cv.g1.infinity()
            for j, pt in enumerate(row):
                want = Cv.g1.add(want, Cv.g1.mul(
                    pt, dom[(i * j) % n] * inv_n % G.R_MODULUS))
            assert Cv.g1.eq_points(out[n * b + i], want), (b, i)
    back_args = tuple(c[:, perm].contiguous() for c in got)
    back_k = G.fft(*back_args, inverse=not inverse)
    assert _same_points(back_k, G.fft(*back_args, inverse=not inverse,
                                      plain=True))
    back = G.limbs_to_oracle_list(back_k)
    for b, row in enumerate(rows):
        for i, pt in enumerate(row):
            assert Cv.g1.eq_points(back[n * b + i], pt)


def test_fk20_hext_kernel(dev):
    import random

    from consensus_specs_tpu_torch.ops.bls import curve as Cv
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import g1fft as G
    from consensus_specs_tpu_torch.ops.bls_batch.curve import \
        scalars_to_digits

    rng = random.Random(6)
    n_res, width = 8, 16
    pts = [[Cv.g1.double(Cv.g1.mul(Cv.G1_GEN, rng.randrange(1, 999)))
            for _ in range(width)] for _ in range(n_res)]
    pts[3][4] = Cv.g1.infinity()
    scalars = [[rng.randrange(G.R_MODULUS) for _ in range(width)]
               for _ in range(n_res)]
    scalars[1][2] = 0
    # a point added twice into the same buckets (the doubling branch), a
    # point beside its negative with equal scalars, a position of zero
    # scalars, an infinity under a point's X and Y (masked, as the
    # producer masks lanes)
    pts[5][6], scalars[5][6] = pts[2][6], scalars[2][6]
    pts[6][7], scalars[6][7] = Cv.g1.neg(pts[1][7]), scalars[1][7]
    for row in scalars:
        row[9] = 0
    x, y, z = (torch.from_numpy(np.stack([[F.to_mont(p[i]) for p in row]
                                          for row in pts])).to(dev)
               for i in range(3))
    z[4, 10] = 0
    pts[4][10] = Cv.g1.infinity()
    digits = torch.from_numpy(scalars_to_digits(
        [s for row in scalars for s in row], 255, 4).reshape(
            n_res, width, 64)).to(dev)
    before = _build.launches["fk20_hext"]
    got = G.hext(x, y, z, digits)
    torch.cuda.synchronize()
    assert _build.launches["fk20_hext"] == before + 1
    assert _same_points(got, G.hext(x, y, z, digits, plain=True))
    out = G.limbs_to_oracle_list(got)
    for j in range(width):
        want = Cv.g1.msm([pts[c][j] for c in range(n_res)],
                         [scalars[c][j] for c in range(n_res)])
        assert Cv.g1.eq_points(out[j], want), j


def test_producer_and_recovery_on_the_card(dev):
    """Slice 6 through the facade's default device: the closed-form
    blob's cells and proofs by FK20 (K18, K15, K20, K19), one column by
    `cell_proof_for_column`, the recovery from the 64 even cells, and a
    rejected recovery."""
    from consensus_specs_tpu_torch import convert as C
    from consensus_specs_tpu_torch import das as D

    blob, cells, proofs, _ = C.closed_form_blob()
    _build.reset_launches()
    got = D.compute_cells_and_kzg_proofs(blob)
    assert got == (cells, proofs)
    assert _build.launches["fk20_hext"] == 1
    assert _build.launches["g1_fft"] >= 2
    assert D.cell_proof_for_column(blob, 77) == proofs[77]
    keep = list(range(0, 128, 2))
    _build.reset_launches()
    assert D.recover_cells_and_kzg_proofs(
        keep, [cells[k] for k in keep]) == (cells, proofs)
    assert _build.launches["g1_fft"] == 2
    with pytest.raises(AssertionError):
        D.recover_cells_and_kzg_proofs(keep[:63], [cells[k]
                                                   for k in keep[:63]])


# --- slice 7: fork choice (K21-K23) and config #1 -----------------------------


def _fc_tensors(x, dev):
    return {k: (torch.from_numpy(np.array(v, copy=True)).to(dev)
                if isinstance(v, np.ndarray) else v) for k, v in x.items()}


_FC_APPLY = ("val_idx", "att_epoch", "att_block", "lm_epoch", "lm_block",
             "balance", "can_update", "node_weight")


@pytest.mark.parametrize("nb_pad,v_pad,batch", [(64, 256, 64),
                                                (1024, 4096, 1024)])
def test_fc_kernels(dev, nb_pad, v_pad, batch):
    """K21-K23 against their plain versions: repeated validators at one
    epoch, padded rows, equivocators, the boost, and heads decided by
    root words at the 2**31 boundary (every comparison leaves out the
    dummy slot)."""
    from consensus_specs_tpu_torch.forkchoice import kernels as FK
    from consensus_specs_tpu_torch.forkchoice import synthetic as FS

    for seed in range(2):
        x = FS.kernel_inputs(nb_pad, v_pad, batch, seed=seed)
        k, p = _fc_tensors(x, dev), _fc_tensors(x, dev)
        before = dict(_build.launches)
        acc = FK.fc_apply(*(k[n] for n in _FC_APPLY))
        want = FK.fc_apply_plain(*(p[n] for n in _FC_APPLY))
        torch.cuda.synchronize()
        assert torch.equal(acc, want) and bool(acc[0]) and \
            not acc[1:10].any()
        assert torch.equal(k["lm_epoch"][:v_pad], p["lm_epoch"][:v_pad])
        assert torch.equal(k["lm_block"][:v_pad], p["lm_block"][:v_pad])
        assert torch.equal(k["node_weight"][:nb_pad],
                           p["node_weight"][:nb_pad])
        ref = FK.fc_refresh(k["lm_block"], k["balance"], nb_pad)
        assert torch.equal(ref[:nb_pad], FK.fc_refresh_plain(
            p["lm_block"], p["balance"], nb_pad)[:nb_pad])
        assert torch.equal(ref[:nb_pad], k["node_weight"][:nb_pad])
        zero = torch.zeros_like(k["node_weight"])
        for w, bi, ba in ((k["node_weight"], nb_pad, 0),
                          (k["node_weight"], x["boost_idx"], x["boost_amt"]),
                          (zero, nb_pad, 0)):
            args = (k["parent"], w, bi, ba, k["real"], k["block_epoch"],
                    k["je"], k["uje"], k["fin_ok"], k["limbs"], x["sj"],
                    x["sf"], x["cur"], x["justified_idx"])
            head = int(FK.fc_head(*args))
            assert head == int(FK.fc_head_plain(*args))
        assert head == 4
        for name, n in (("fc_apply", 1), ("fc_refresh", 1), ("fc_head", 3)):
            assert _build.launches[name] == before[name] + n


@pytest.mark.parametrize("nb_pad,v_pad,batch", [(64, 256, 64),
                                                (1024, 4096, 1024),
                                                (1024, 2**20, 16384)])
def test_fc_apply_back_to_back_batches(dev, nb_pad, v_pad, batch):
    """K21 over 8 batches in a row (`synthetic.apply_batches`: repeated
    validators, winners rejected as older or as equivocators, padded
    rows) against `fc_apply_plain`, the winner table all -1 after each
    batch."""
    from consensus_specs_tpu_torch.forkchoice import kernels as FK
    from consensus_specs_tpu_torch.forkchoice import synthetic as FS

    x, batches = FS.apply_batches(nb_pad, v_pad, batch, 8, seed=2)
    k, p = (_fc_tensors(x, dev) for _ in range(2))
    table = FK.winner_table(dev, v_pad + 1)
    for val_idx, att_epoch, att_block in batches:
        rows = [torch.from_numpy(a).to(dev)
                for a in (val_idx, att_epoch, att_block)]
        before = _build.launches["fc_apply"]
        acc = FK.fc_apply(*rows, *(k[n] for n in _FC_APPLY[3:]))
        want = FK.fc_apply_plain(*rows, *(p[n] for n in _FC_APPLY[3:]))
        torch.cuda.synchronize()
        assert _build.launches["fc_apply"] == before + 1
        assert torch.equal(acc, want)
        assert torch.equal(k["lm_epoch"][:v_pad], p["lm_epoch"][:v_pad])
        assert torch.equal(k["lm_block"][:v_pad], p["lm_block"][:v_pad])
        assert torch.equal(k["node_weight"][:nb_pad],
                           p["node_weight"][:nb_pad])
        assert bool((table == -1).all())
    assert FK.winner_table(dev, v_pad + 1) is table


@pytest.mark.parametrize("nb_pad", [64, 1024, 16384, 32768])
@pytest.mark.parametrize("case", ["empty", "half", "one"])
def test_fc_refresh_tables(dev, nb_pad, case):
    """K22 against `fc_refresh_plain` and `index_add_` at 2**20
    validators: no vote (the paths' rebuild), half voted, every vote on
    one block with balances that carry out of the low word and wrap the
    high one; NB on the shared-memory route and past it (32768).  Twice in
    a row on one stream: the accumulator the next call takes is zero after
    each call, and the second call leaves the first one's output alone."""
    from consensus_specs_tpu_torch.forkchoice import kernels as FK

    v = 2**20
    rng = np.random.RandomState(nb_pad)
    lm = np.full(v + 1, -1, np.int32)
    bal = rng.randint(0, 2**36, v + 1).astype(np.int64)
    if case == "half":
        on = rng.rand(v) < 0.5
        lm[:v][on] = rng.randint(0, nb_pad, int(on.sum()))
    elif case == "one":
        lm[:v] = 3
        bal = rng.choice(np.array([2**32 - 1, 2**32, 2**63 - 1, -2**63, -1,
                                   3], np.int64), v + 1)
    lm_t, bal_t = torch.from_numpy(lm).to(dev), torch.from_numpy(bal).to(dev)
    want = FK.fc_refresh_plain(lm_t, bal_t, nb_pad)
    lib = torch.zeros(nb_pad + 1, dtype=torch.int64, device=dev).index_add_(
        0, torch.where(lm_t >= 0, lm_t.long(), nb_pad),
        torch.where(lm_t >= 0, bal_t, 0))
    assert torch.equal(want, lib)
    outs = []
    for _ in range(2):
        before = _build.launches["fc_refresh"]
        outs.append(FK.fc_refresh(lm_t, bal_t, nb_pad))
        assert _build.launches["fc_refresh"] == before + 1
        assert torch.equal(outs[-1], want)
        assert not FK.refresh_accumulator(dev, nb_pad + 1).any()
    assert torch.equal(outs[0], want)
    assert outs[0].data_ptr() != outs[1].data_ptr()
    assert bool(FK._lib().fc_refresh_shared_bytes(nb_pad)) == (nb_pad < 32768)


@pytest.mark.parametrize("nb_pad", [64, 1024, 16384])
def test_fc_head_cases(dev, nb_pad):
    """K23 against its plain version on every case of
    `synthetic.head_inputs` (the tree with and without the boost, the
    root words alone, a linear chain, a heavier branch without a viable
    leaf, ties broken in the low word of the last pair) at the ladder's
    three rungs; 16384 is the global-scratch route."""
    from consensus_specs_tpu_torch.forkchoice import kernels as FK
    from consensus_specs_tpu_torch.forkchoice import synthetic as FS

    before = _build.launches["fc_head"]
    for case in FS.HEAD_CASES:
        args = tuple(_fc_tensors(FS.head_inputs(nb_pad, case), dev).values())
        got = int(FK.fc_head(*args))
        assert got == int(FK.fc_head_plain(*args)), case
        if case in ("roots", "words"):
            assert got == 4
        if case == "non_viable":
            assert got not in (1, 3, 4)
    assert _build.launches["fc_head"] == before + len(FS.HEAD_CASES)


def test_fc_store_on_the_card_equals_the_spec_oracle(dev):
    """Three randomized stores (the JAX suite's generator, on the port's
    store) on the card: heads equal to the phase0 spec's `get_head`
    through `consensus_specs_tpu.forkchoice.oracle` (which loads no JAX),
    weights to the host mirror's."""
    pytest.importorskip("yaml")
    from consensus_specs_tpu.forkchoice import oracle as jax_oracle
    from consensus_specs_tpu_torch.forkchoice import ProtoArrayStore

    for seed in range(3):
        rng = np.random.RandomState(seed)
        anchor = bytes([seed % 256]) + b"\x00" * 31
        st = ProtoArrayStore(anchor, 0, slots_per_epoch=8, preset="minimal",
                             device=dev)
        roots = [anchor]
        for i in range(1, 18):
            parent = roots[rng.randint(0, i)]
            slot = st.slots[st.root_index[parent]] + 1 + rng.randint(0, 2)
            root = bytes(rng.randint(0, 256, 32, dtype=np.uint8))
            st.add_block(root, parent, slot, 0, 0)
            roots.append(root)
        eb = np.full(40, 32 * 10**9, dtype=np.int64)
        eb[rng.randint(0, 40, 4)] = 31 * 10**9
        active = np.ones(40, bool)
        active[rng.randint(0, 40, 2)] = False
        st.set_validators(eb, active=active)
        st.set_current_epoch(max(st.slots) // 8 + 1)
        _build.reset_launches()
        for _ in range(3):
            k = rng.randint(1, 24)
            st.apply_attestations(
                rng.randint(0, 40, k).tolist(), rng.randint(0, 4, k).tolist(),
                [roots[rng.randint(0, 18)] for _ in range(k)])
        if seed % 2:
            st.set_proposer_boost(roots[rng.randint(1, 18)])
        head = st.get_head()
        assert _build.launches["fc_apply"] == 3
        assert _build.launches["fc_refresh"] == 1
        assert _build.launches["fc_head"] == 1
        assert head == jax_oracle.spec_get_head(st)
        assert (st.node_weights_device() == st.node_weights_host()).all()


def test_config1_state_transition_on_the_card(dev, monkeypatch):
    """Config #1, `bench.py:1172 worker_spec`'s loop: minimal phase0, 64
    validators, signatures on, each block built and signed on the host
    and imported through the port's `state_transition_batched` with the
    facade on the card (the RANDAO and proposer checks through K12 ->
    K10); seconds per block, cold and the median of 3 warm, then the same
    signed blocks replayed through the spec's own `state_transition` on
    the JAX package's host oracle, to the same state root."""
    import statistics
    import time

    pytest.importorskip("yaml")
    from consensus_specs_tpu.models.builder import build_spec
    from consensus_specs_tpu.ops import bls as jax_bls
    from consensus_specs_tpu.testlib.helpers.block import (
        build_empty_block_for_next_slot, sign_block)
    from consensus_specs_tpu.testlib.helpers.genesis import \
        create_genesis_state
    from consensus_specs_tpu_torch import executor
    from consensus_specs_tpu_torch.ops import bls as port_bls

    monkeypatch.setattr(jax_bls, "bls_active", True)
    monkeypatch.setattr(port_bls, "bls_active", True)
    monkeypatch.setattr(port_bls, "_backend_name", "torch")
    monkeypatch.setattr(port_bls, "_device", str(dev))
    spec = build_spec("phase0", "minimal")
    balance = int(spec.MAX_EFFECTIVE_BALANCE)
    genesis = create_genesis_state(spec, [balance] * 64, balance)

    def transition_one(st):
        block = build_empty_block_for_next_slot(spec, st)
        shadow = st.copy()
        executor.state_transition_batched(
            spec, shadow, spec.SignedBeaconBlock(message=block),
            validate_result=False)
        block.state_root = spec.hash_tree_root(shadow)
        signed = sign_block(spec, st.copy(), block)
        executor.state_transition_batched(spec, st, signed)
        return signed

    st = genesis.copy()
    _build.reset_launches()
    walls, blocks = [], []
    for _ in range(4):
        t0 = time.perf_counter()
        blocks.append(transition_one(st))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    # three eager checks a block: the shadow's RANDAO, then the proposer
    # signature and the RANDAO of the import
    assert _build.launches["precomp_miller_product"] == 12
    assert _build.launches["final_exp_is_one"] == 12
    replay = genesis.copy()
    t0 = time.perf_counter()
    for signed in blocks:
        spec.state_transition(replay, signed)
    oracle_s = (time.perf_counter() - t0) / len(blocks)
    assert spec.hash_tree_root(replay) == spec.hash_tree_root(st)
    assert spec.bls is jax_bls
    print(f"config #1 (minimal phase0, 64 validators, signatures on) on "
          f"{torch.cuda.get_device_name(dev)}: cold_s_per_block="
          f"{walls[0]:.4f} warm_median_s_per_block="
          f"{statistics.median(walls[1:]):.4f} (min {min(walls[1:]):.4f}, "
          f"max {max(walls[1:]):.4f}); the spec's state_transition on the "
          f"host oracle, same blocks: {oracle_s:.4f} s per block")


# --- slice 8: K24-K27 and the sharded paths on virtual meshes of the card ----


@pytest.mark.parametrize("scalars", [(100, 2, 32 * 10**9), (100, 9, 10**12),
                                     (0, 0, 0)])
def test_epoch_sweep_sharded_kernel(dev, scalars):
    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.parallel import collectives as CO

    n, d = 1024, 4
    reg = _registry(dev, n)
    mesh = P.make_mesh(devices=[dev] * d)
    regs = P.shard_registry(mesh, reg)
    sc = EpochScalars(*scalars)
    parts = [E.sweep_totals_kernel(r, sc, n) for r in regs]
    for r, (s, a) in zip(regs, parts):
        ws, wa = E.sweep_totals_plain(r, sc, n)
        assert torch.equal(s, ws) and torch.equal(a, wa)
    sums = CO.all_reduce_sum([s for s, _ in parts])
    p_accs = [torch.zeros(n, dtype=torch.int64, device=dev) for _ in regs]
    for r, s, (_, a), pa in zip(regs, sums, parts, p_accs):
        got = E.sweep_shares_kernel(r, sc, MAINNET, s, a)
        want = E.sweep_shares_plain(r, sc, MAINNET, s, pa)
        assert torch.equal(got, want) and torch.equal(a, pa)
        recv = pa[:n // d]
        got = E.sweep_apply_kernel(r, sc, MAINNET, want, recv)
        want = E.sweep_apply_plain(r, sc, MAINNET, want, recv)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    _build.reset_launches()
    bal, eff = E.epoch_sweep_sharded(regs, sc, MAINNET)
    torch.cuda.synchronize()
    assert _build.launches["epoch_sweep_sharded"] == 3 * d
    want = E.epoch_sweep_kernel(reg, sc, MAINNET)
    assert torch.equal(torch.cat(bal), want[0])
    assert torch.equal(torch.cat(eff), want[1])


@pytest.mark.parametrize("d", [1, 2, 4, 8])
def test_epoch_sweep_sharded_hot_proposers(dev, d):
    """K24 where every attester's proposer is one of 32 validators (a
    mainnet epoch's two epochs of slots): the shares' atomics pile onto 32
    rows.  Equal to the plain sharded sweep and to K1, with the scratch
    left zero after each launch (two calls in a row agree)."""
    from consensus_specs_tpu_torch import parallel as P

    n = 4096
    reg_np = C.synthetic_registry(n, 3)
    reg_np["proposer_index"] = C.hot_proposers(n, 32, seed=4)
    reg = C.registry_to_torch(reg_np, dev)
    regs = P.shard_registry(P.make_mesh(devices=[dev] * d), reg)
    sc = EpochScalars(100, 2, 32 * 10**9)
    want = E.epoch_sweep_kernel(reg, sc, MAINNET)
    plain = E.epoch_sweep_sharded(regs, sc, MAINNET, plain=True)
    for _ in range(2):
        bal, eff = E.epoch_sweep_sharded(regs, sc, MAINNET)
        assert torch.equal(torch.cat(bal), want[0])
        assert torch.equal(torch.cat(eff), want[1])
        assert torch.equal(torch.cat(bal), torch.cat(plain[0]))
    torch.cuda.synchronize()
    assert all(not t.any() for t in E._SCRATCH.values())


def _shard_partials(dev, tasks, d):
    """Each shard's K8 -> K25 outputs and its K25 inputs, over d shards."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    per = B._bucket(-(-len(tasks) // d))
    arrays, _ = B._prepare_rlc_inputs(tasks, random.Random(5), False, dev,
                                      lanes=d * per)
    out = []
    for sh in range(d):
        t = [B._to(a[sh * per:(sh + 1) * per], dev) for a in arrays]
        apx, apy, a_inf, r_sig = K.rlc_scalar_mul_kernel(*t[:4], t[6], t[7])
        args = (apx, apy, a_inf, r_sig, t[4], t[5], torch.ones_like(t[7]),
                t[7])
        out.append((args, K.rlc_miller_shard_kernel(*args)))
    return out


def test_rlc_shard_kernels_against_plain(dev):
    """K25 on a live and a padding shard, K26 on the gathered partials
    (two padding shards) and on two equal partials, against the plain
    versions; K26's f equal to the unsharded K9's."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.parallel import collectives as CO

    tasks = _bls_tasks(10)
    shards = _shard_partials(dev, tasks, 4)        # 4 x 8 lanes: 2 padding
    for sh in (0, 3):
        args, (f, total) = shards[sh]
        pf, ptotal = B.rlc_miller_shard_plain(*args)
        assert torch.equal(f, _canon(pf)) and _all_equal(total, ptotal)
    sums = tuple(CO.gather([s[1][1][k] for s in shards], dev)
                 for k in range(3))
    fs = CO.gather([s[1][0] for s in shards], dev)
    f26, s26 = K.rlc_shard_combine_kernel(sums, fs)
    pf, ps = B.rlc_shard_combine_plain(sums, fs)
    assert torch.equal(f26, _canon(pf)) and _all_equal(s26, ps)
    eq_sums = tuple(torch.stack([c[0], c[0], c[1], c[2]]) for c in sums)
    eq_fs = torch.stack([fs[0], fs[0], fs[1], fs[2]])
    got, gs = K.rlc_shard_combine_kernel(eq_sums, eq_fs)
    pf, ps = B.rlc_shard_combine_plain(eq_sums, eq_fs)
    assert torch.equal(got, _canon(pf)) and _all_equal(gs, ps)
    single = {}
    assert B.batch_verify(tasks, rng=random.Random(5), device=dev,
                          device_h2c=False, trace=single)
    assert torch.equal(f26, single["miller"])


def _edge_lanes(dev, n, seed, sig_inf=False, dead=True):
    """K9's and K25's inputs for n lanes, as K8 leaves them: r PK affine,
    the signature rows Jacobian, H affine; with `dead`, lane 1 masked (its
    signature row at infinity), lane 2 with r PK at infinity, lane 3 with
    H at infinity, where n reaches them; every lane masked with `dead`
    "all"; every signature row at infinity with `sig_inf`."""
    import random

    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import tower as T

    r = random.Random(seed)
    pk = [curve.g1.mul(curve.G1_GEN, r.randrange(1, 2**64))
          for _ in range(n)]
    h = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64)) for _ in range(n)]
    sig = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64))
           for _ in range(n)]
    mask, a_inf, h_ok = np.ones(n, bool), np.zeros(n, bool), np.ones(n, bool)
    if dead == "all":
        mask[:] = False
    elif dead:
        mask[1:2] = False
        a_inf[2:3] = True
        h_ok[3:4] = False
    sig = [curve.g2.infinity() if sig_inf or not m else s
           for s, m in zip(sig, mask)]
    apx, apy = BC.g1_affine_to_limbs(pk)
    hx, hy = BC.g2_affine_to_limbs(h)
    apx[a_inf] = apy[a_inf] = 0
    hx[~h_ok] = hy[~h_ok] = 0
    rows = tuple(np.stack([T.fq2_from_oracle(s[c]) for s in sig])
                 for c in range(3))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return (t(apx), t(apy), t(a_inf), tuple(map(t, rows)), t(hx), t(hy),
            t(h_ok), t(mask))


@pytest.mark.parametrize("n,sig_inf", [(1, False), (2, False), (31, False),
                                       (33, False), (128, False),
                                       (129, False), (4, True)])
def test_rlc_miller_product_edge_shapes(dev, n, sig_inf):
    """K9 (one group of threads per lane, the lanes over many blocks, then
    the fold) at lane counts around its blocks of 5 lanes and the path's
    128, with dead lanes of each kind, and with every signature at
    infinity (the shared lane dead): equal to its plain version."""
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    args = _edge_lanes(dev, n, 60 + n, sig_inf)
    before = _build.launches["rlc_miller_product"]
    f, s = K.rlc_miller_product_kernel(*args)
    assert _build.launches["rlc_miller_product"] == before + 1
    pf, ps = B.rlc_miller_product_plain(*args)
    assert torch.equal(f, _canon(pf)) and _all_equal(s, ps)
    assert bool(s[2].item()) == sig_inf


def test_rlc_scalar_mul_edge_lanes(dev):
    """K8 (a group of threads per lane on the group point passes) on one
    batch of 37 lanes: the scalars 0, 1, 2, 3 and 2^128 - 1, then 3 and 5
    on the G1 point (0, 2) of order 3 (the addition meets T = -Q and
    T = Q), seeded scalars on the rest, pad lanes in the middle and at
    the end: every output equal to its plain version."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    r, n = random.Random(11), 37
    scalars = [0, 1, 2, 3, 2**128 - 1, 3, 5]
    scalars += [r.getrandbits(128) for _ in range(n - len(scalars))]
    pk_x, pk_y = BC.g1_affine_to_limbs(
        [curve.g1.mul(curve.G1_GEN, r.randrange(1, 2**64)) for _ in range(n)])
    pk_x[5:7], pk_y[5:7] = F.to_mont(0), F.to_mont(2)
    sig_x, sig_y = BC.g2_affine_to_limbs(
        [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64)) for _ in range(n)])
    mask = np.ones(n, bool)
    mask[[n // 2, n - 1]] = False
    args = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        pk_x, pk_y, sig_x, sig_y, BC.scalars_to_bits(scalars, 128), mask))
    before = _build.launches["rlc_scalar_mul"]
    apx, apy, a_inf, r_sig = K.rlc_scalar_mul_kernel(*args)
    assert _build.launches["rlc_scalar_mul"] == before + 1
    want = B.rlc_scalar_mul_plain(*args)
    assert _all_equal((apx, apy, a_inf), want[:3])
    assert _all_equal(r_sig, want[3])
    assert a_inf[:7].tolist() == [True] + [False] * 4 + [True, False]


@pytest.mark.parametrize("case", ["z_on_domain", "zero_polynomial",
                                  "coset", "z_on_coset"])
def test_fr_barycentric_edges(dev, case):
    """K16 (binary inversions of z - x_i) at its edges: z on the W = 4096
    domain and the zero polynomial give 0; the coset width of
    `evaluate_cells_at` (W = 64, shift h_5) at a random z and at z on the
    coset (0): equal to its plain version."""
    import random

    from consensus_specs_tpu_torch.das import ciphersuite as DC
    from consensus_specs_tpu_torch.ops import fr_batch as FB

    R, rng = FB.R_MODULUS, random.Random(case)
    if case.startswith("z") and "domain" in case or case == "zero_polynomial":
        g = pow(7, (R - 1) // 4096, R)
        domain, shift = [pow(g, i, R) for i in range(4096)], 1
    else:
        domain, shift = list(DC.coset_points(5)), DC.coset_shift(5)
    poly = [0 if case == "zero_polynomial" else rng.randrange(R)
            for _ in domain]
    z = domain[9] if case.startswith("z_on") else rng.randrange(R)
    args = tuple(torch.from_numpy(a).to(dev) for a in FB.barycentric_inputs(
        poly, domain, z, shift))
    got = FB.barycentric(*args)
    assert torch.equal(got, FB.FR.canon(FB.barycentric(*args, plain=True)))
    assert (FB.from_limbs(got)[0] == 0) == (case != "coset")


@pytest.mark.parametrize("n,dead", [(1, False), (32, True), (8, "all")])
def test_rlc_miller_shard_edge_shapes(dev, n, dead):
    """K25 on one lane, on a shard of 32 lanes with dead lanes of each
    kind, and on an empty shard (every lane padding): equal to its plain
    version."""
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.bls_batch import tower as T

    args = _edge_lanes(dev, n, 70 + n, dead=dead)
    f, total = K.rlc_miller_shard_kernel(*args)
    pf, ptotal = B.rlc_miller_shard_plain(*args)
    assert torch.equal(f, _canon(pf)) and _all_equal(total, ptotal)
    if dead == "all":
        assert bool(T.fq12_is_one(f)) and not bool(T.fq2_is_zero(total[0]))


@pytest.mark.parametrize("d,equal", [(1, False), (2, False), (2, True),
                                     (4, False), (4, True)])
def test_rlc_shard_combine_edge_shapes(dev, d, equal):
    """K26 over D partials (the shared lane through the same per-lane
    code as K9's lanes, then the fold with the partials), with equal
    partials (the tree sum's doubling branch): equal to its plain
    version."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls.fields import Q
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K
    from consensus_specs_tpu_torch.ops.bls_batch import tower as T

    r = random.Random(80 + d)
    pts = [curve.g2.mul(curve.G2_GEN, r.randrange(1, 2**64))
           for _ in range(d)]
    fs = [np.stack([F.to_mont(r.randrange(Q)) for _ in range(12)]).reshape(
        2, 3, 2, 33) for _ in range(d)]
    if equal:
        pts[1], fs[1] = pts[0], fs[0]
    sums = tuple(torch.from_numpy(np.stack([T.fq2_from_oracle(p[c])
                                            for p in pts])).to(dev)
                 for c in range(3))
    fs = torch.from_numpy(np.stack(fs)).to(dev)
    f, s = K.rlc_shard_combine_kernel(sums, fs)
    pf, ps = B.rlc_shard_combine_plain(sums, fs)
    assert torch.equal(f, _canon(pf)) and _all_equal(s, ps)


def test_hash_to_g2_kernel_edge_shapes(dev):
    """K11 (a group of 4 threads per message in the clearing, 8 messages
    a block) at B = 1, 128 and 129: equal to its plain version at 1 and
    129, and its first 128 rows at 128."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls_batch import h2c

    rng = random.Random(12)
    msgs = [bytes(rng.randrange(256) for _ in range(32)) for _ in range(129)]
    words = torch.from_numpy(h2c.msgs_to_words(msgs).view(np.int32)).to(dev)
    want = _canon(B.hash_to_g2_affine(words, plain=True))
    for n in (129, 128):
        got = B.hash_to_g2_affine(words[:n].contiguous())
        assert all(torch.equal(g, w[:n]) for g, w in zip(got, want)), n
    got = B.hash_to_g2_affine(words[:1].contiguous())
    assert _all_equal(got, B.hash_to_g2_affine(words[:1], plain=True))


@pytest.mark.parametrize("device_h2c", [True, False])
def test_batch_verify_accepts_and_rejects_on_both_routes(dev, device_h2c):
    """True statements accepted, a tampered signature rejected, with the
    messages hashed on the card (K11 -> K8 -> K9 -> K10) and on the host
    (K8 -> K9 -> K10); the two routes' Miller products equal."""
    import random

    from consensus_specs_tpu_torch.ops import bls_batch as B

    traces = []
    for forge in (None, 3):
        tr = {}
        _build.reset_launches()
        got = B.batch_verify(_bls_tasks(6, forge=forge), rng=random.Random(3),
                             device=dev, device_h2c=device_h2c, trace=tr)
        assert got is (forge is None)
        assert _build.launches["hash_to_g2"] == int(device_h2c)
        assert _build.launches["rlc_miller_product"] == 1
        traces.append(tr)
    other = {}
    B.batch_verify(_bls_tasks(6), rng=random.Random(3), device=dev,
                   device_h2c=not device_h2c, trace=other)
    assert torch.equal(traces[0]["miller"], other["miller"])


def test_g1_shard_fold_kernel(dev):
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve
    from consensus_specs_tpu_torch.ops.bls_batch import curve as BC
    from consensus_specs_tpu_torch.ops.bls_batch import fq as F
    from consensus_specs_tpu_torch.ops.bls_batch import kernels as K

    pts = [curve.g1.mul(curve.G1_GEN, 5 + i) for i in range(2)]
    pts.append(curve.g1.neg(pts[0]))
    x, y = BC.g1_affine_to_limbs(pts)
    one = np.broadcast_to(F.ONE_MONT, x.shape[1:]).astype(np.int32)
    for rows in ([0, 0, None, 1], [None, None, None], [1, 0, 0], [0],
                 [1, 1], [0, 2], [2, None, 0, 2], [None]):
        X = torch.from_numpy(np.stack([x[r or 0] for r in rows])).to(dev)
        Y = torch.from_numpy(np.stack([y[r or 0] for r in rows])).to(dev)
        Z = torch.from_numpy(np.stack([one if r is not None else 0 * one
                                       for r in rows])).to(dev)
        got = K.g1_shard_fold_kernel(X, Y, Z)
        assert _all_equal(got, B.g1_shard_fold_plain(X, Y, Z))


def test_sharded_paths_on_a_virtual_mesh(dev):
    """The sharded step, forest, batch and MSM over cuda:0 listed 4 times,
    against the unsharded paths."""
    import random

    from consensus_specs_tpu_torch import parallel as P
    from consensus_specs_tpu_torch.ops import bls_batch as B
    from consensus_specs_tpu_torch.ops.bls import curve

    n, d = 4096, 4
    reg = _registry(dev, n)
    pk, cred = C.synthetic_leaf_words(n)
    leaves = C.leaves_to_torch(pk, cred, dev)
    sc = EpochScalars(100, 2, 32 * 10**9)
    want = make_epoch_step(MAINNET, device=dev)(reg, sc, n - 999, leaves)
    mesh = P.make_mesh(devices=[dev] * d)
    placed = P.shard_tree(mesh, {"pubkey_root": leaves.pubkey_root,
                                 "credentials": leaves.credentials})
    _build.reset_launches()
    out = P.make_sharded_epoch_step(mesh, MAINNET)(
        P.shard_registry(mesh, reg), sc, n - 999,
        [p["pubkey_root"] for p in placed], [p["credentials"] for p in placed])
    torch.cuda.synchronize()
    assert _build.launches["epoch_sweep_sharded"] == 3 * d
    assert torch.equal(torch.cat(out[0]), want[0])
    assert torch.equal(torch.cat(out[1]), want[1])
    assert all(torch.equal(r, want[2]) for r in out[2])
    assert all(torch.equal(r, want[3]) for r in out[3])

    forest = P.sharded_balances_forest(want[0], n, devices=[dev] * d)
    single = P.balances_forest(want[0], n, device=dev)
    assert forest.root_bytes() == single.root_bytes()
    idx = torch.tensor([0, 5, 300, 1023], device=dev)
    words = I.gather_balance_chunks(want[0] + 1, idx)
    forest.update(idx, words)
    single.update(idx, words)
    root = forest.root_bytes()
    assert root == single.root_bytes()
    assert all(P.verify_proof(p, root)
               for p in forest.emit_proofs([0, 255, 256, 1023]))

    _build.reset_launches()
    tasks = _bls_tasks(10)
    assert B.batch_verify_sharded(tasks, rng=random.Random(1),
                                  devices=[dev] * d) is True
    assert _build.launches["rlc_miller_shard"] == d
    assert _build.launches["rlc_shard_combine"] == 1
    assert B.batch_verify_sharded(_bls_tasks(10, forge=9),
                                  rng=random.Random(1),
                                  devices=[dev] * d) is False

    pts = [curve.g1.mul(curve.G1_GEN, 3 * i + 2) for i in range(40)]
    ks = [pow(5, i + 1, curve.R) for i in range(40)]
    got = B.g1_multi_exp_sharded(pts + pts[:8], ks + ks[:8],
                                 devices=[dev] * d)
    assert curve.g1.eq_points(got, curve.g1.msm(pts + pts[:8],
                                                ks + ks[:8]))
    assert _build.launches["g1_shard_fold"] == 1
