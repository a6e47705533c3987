"""The port's CUDA kernels K1-K18 (and K3's gather mode) against their
plain PyTorch versions on the card, bit for bit (the BLS kernels at
canonical values), at small shapes.  Every test here needs an NVIDIA
GPU and nvcc; without a card they skip.  On the card, where JAX is not
installed and so the suite's conftest cannot load:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
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


def test_records_root_gather_kernel(dev):
    n = 1024
    reg = _registry(dev, n, seed=3)
    leaves = C.leaves_to_torch(*C.synthetic_leaf_words(n), dev)
    idx = I.pad_dirty_idx(_idx(dev, [5, 1023, 0, 77, 77]), n)
    args = (leaves, reg.effective_balance, reg.slashed,
            reg.activation_eligibility_epoch, reg.activation_epoch,
            reg.exit_epoch, reg.withdrawable_epoch)
    before = _build.launches["records_root_gather"]
    got = M.validator_records_root_kernel(*args, index=idx)
    assert _build.launches["records_root_gather"] == before + 1
    assert torch.equal(got, M.validator_records_root_plain(*args, index=idx))


_BLS_KERNELS = ("bls_field_ops", "rlc_scalar_mul", "rlc_miller_product",
                "final_exp_is_one", "hash_to_g2", "precomp_miller_product",
                "msm_pippenger", "msm_double_add")
_FR_KERNELS = ("fr_field_ops", "fr_barycentric", "fr_coset_interpolate",
               "fr_fft")


def test_incremental_step_on_the_card(dev):
    n = 4096
    reg = _registry(dev, n, seed=4)
    pk, cred, dirty = C.incremental_step_inputs(n)
    leaves = C.leaves_to_torch(pk, cred, dev)
    sc = EpochScalars(100_000, 2, 32 * 10**9)
    _build.reset_launches()
    got = IncrementalEpochStep(MAINNET, reg, sc, leaves, dirty, device=dev)()
    assert all(v > 0 for k, v in _build.launches.items()
               if k != "proof_paths" and k not in _BLS_KERNELS + _FR_KERNELS)
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
    ("fq12_frobenius", 1), ("fq12_frobenius", 2), ("fq12_frobenius", 6)])
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


@pytest.mark.parametrize("n,algo", [(8, "pippenger"), (16, "pippenger"),
                                    (8, "double-add"), (40, "double-add")])
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
