"""The port's CUDA kernels K1-K6 (and K3's gather mode) against their
plain PyTorch versions on the card, bit for bit, at small shapes.  Every test here needs an NVIDIA
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


def test_incremental_step_on_the_card(dev):
    n = 4096
    reg = _registry(dev, n, seed=4)
    pk, cred, dirty = C.incremental_step_inputs(n)
    leaves = C.leaves_to_torch(pk, cred, dev)
    sc = EpochScalars(100_000, 2, 32 * 10**9)
    _build.reset_launches()
    got = IncrementalEpochStep(MAINNET, reg, sc, leaves, dirty, device=dev)()
    assert all(v > 0 for k, v in _build.launches.items() if k != "proof_paths")
    want = IncrementalEpochStep(MAINNET, reg, sc, leaves, dirty, device=dev,
                                plain=True)()
    assert all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want))
