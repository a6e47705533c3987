"""The schedule of the redesigned K3 (`records_root_kernel`, its gather
mode first) against the JAX package, on the CPU, tolerance zero.

The kernel (`csrc/records_root.cu`) hashes the record roots as a tree in
blocks of kRecords records and kThreads = 4 kRecords threads:

- level 0, every thread t: leaf pair t % 4 of record t / 4 (the pubkey
  root and the credentials; effective balance and slashed; the two
  activation epochs; exit and withdrawable), read through the clamped
  index, its digest into shared slot t (kSlot words a slot);
- a barrier; level 1, threads t < 2 kRecords (the block's first half):
  the node pair of slots 2t and 2t + 1 into level-1 slot t;
- a barrier; level 2, threads t < kRecords (the first quarter): record
  t's root from level-1 slots 2t and 2t + 1, or zero chunks for a pad row
  (row >= length).

`_replay` runs that schedule on numpy with the port's plain SHA-256, the
shared slots laid out as the kernel lays them, and holds the output to
JAX's `validator_records_root` on rows gathered as `bench.py:260
dirty_record_roots` gathers them (indices clamped to N - 1) and to the
port's `validator_records_root_plain`.  The kernel itself is held against
the plain version on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`); the source's launcher signature and the constants the
replay reads are checked here."""

import re
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.parallel import merkle as JM
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.ops.sha256 import sha256_64B_words_plain
from consensus_specs_tpu_torch.parallel import merkle as M

SOURCE = Path(M.__file__).resolve().parents[1] / "csrc" / "records_root.cu"
FIELDS = ("effective_balance", "slashed", "activation_eligibility_epoch",
          "activation_epoch", "exit_epoch", "withdrawable_epoch")
N = 300


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _constant(name: str) -> int:
    text = SOURCE.read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = ([^;]+);", text))
    expr = consts[name]
    for k, v in consts.items():
        expr = re.sub(rf"\b{k}\b", f"({v})", expr)
    return int(eval(expr, {}))


RECORDS, THREADS, SLOT = (_constant("kRecords"), _constant("kThreads"),
                          _constant("kSlot"))


def _bswap(x):
    x = np.asarray(x, dtype=np.uint32)
    return x.byteswap()


def _u64_leaf(v):
    """put_u64_leaf: a uint64 alone in its chunk, 8 big-endian words."""
    v = np.asarray(v, dtype=np.uint64)
    w = np.zeros(v.shape + (8,), dtype=np.uint32)
    w[..., 0] = _bswap((v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    w[..., 1] = _bswap((v >> np.uint64(32)).astype(np.uint32))
    return w


def _sha(blocks):
    """SHA-256 of (K, 16) uint32 message words by the port's plain
    version -> (K, 8) uint32."""
    if not len(blocks):
        return np.zeros((0, 8), dtype=np.uint32)
    t = torch.from_numpy(np.ascontiguousarray(blocks).view(np.int32))
    return sha256_64B_words_plain(t).numpy().view(np.uint32)


def _replay(reg, pk, cred, index, length=None):
    """K3's schedule: (M, 8) uint32 roots, and for each level the threads
    (block, t) that hashed; `index` None is full mode (row i, M = N)."""
    m = N if index is None else index.shape[0]
    live = m if length is None else min(length, m)
    n_blocks = -(-m // RECORDS)
    level0 = np.zeros((n_blocks, THREADS * SLOT), dtype=np.uint32)
    level1 = np.zeros((n_blocks, 2 * RECORDS * SLOT), dtype=np.uint32)
    out = np.zeros((m, 8), dtype=np.uint32)
    hashed = {0: [], 1: [], 2: []}

    def row(blk, rec):
        return blk * RECORDS + rec

    # level 0
    msgs = []
    for blk in range(n_blocks):
        for t in range(THREADS):
            i = row(blk, t // 4)
            if i >= live:
                continue
            x = i if index is None else int(index[i]) & (2**64 - 1)
            r = x if x < N else N - 1
            k = t % 4
            if k == 0:
                w = np.concatenate([pk[r], cred[r]])
            else:
                a, b = {1: ("effective_balance", "slashed"),
                        2: ("activation_eligibility_epoch",
                            "activation_epoch"),
                        3: ("exit_epoch", "withdrawable_epoch")}[k]
                w = np.concatenate([_u64_leaf(reg[a][r]),
                                    _u64_leaf(np.uint64(reg[b][r]))])
            msgs.append(w)
            hashed[0].append((blk, t))
    for (blk, t), h in zip(hashed[0], _sha(np.array(msgs).reshape(-1, 16))):
        level0[blk, t * SLOT:t * SLOT + 8] = h
    # -- __syncthreads --; level 1
    msgs = []
    for blk in range(n_blocks):
        for t in range(2 * RECORDS):
            if row(blk, t // 2) >= live:
                continue
            s0, s1 = 2 * t * SLOT, (2 * t + 1) * SLOT
            msgs.append(np.concatenate([level0[blk, s0:s0 + 8],
                                        level0[blk, s1:s1 + 8]]))
            hashed[1].append((blk, t))
    for (blk, t), h in zip(hashed[1], _sha(np.array(msgs).reshape(-1, 16))):
        level1[blk, t * SLOT:t * SLOT + 8] = h
    # -- __syncthreads --; level 2 (pad rows stay zero)
    msgs = []
    for blk in range(n_blocks):
        for t in range(RECORDS):
            if row(blk, t) >= live:
                continue
            s0, s1 = 2 * t * SLOT, (2 * t + 1) * SLOT
            msgs.append(np.concatenate([level1[blk, s0:s0 + 8],
                                        level1[blk, s1:s1 + 8]]))
            hashed[2].append((blk, t))
    for (blk, t), h in zip(hashed[2], _sha(np.array(msgs).reshape(-1, 16))):
        out[row(blk, t)] = h
    return out, hashed


_jax_records_root = jax.jit(lambda pk, cred, *f: JM.validator_records_root(
    JM.ValidatorLeaves(pk, cred), *f))


def _registry():
    reg = C.synthetic_registry(N, seed=5)
    reg["exit_epoch"][::5] = 77
    reg["slashed"][::9] = True
    reg["activation_eligibility_epoch"][::3] = 2**64 - 1
    pk, cred = C.synthetic_leaf_words(N)
    return reg, pk, cred


def _index(m: int) -> np.ndarray:
    """m indices with repeats, indices past N and a negative one (both
    clamped to N - 1 as unsigned)."""
    rng = np.random.RandomState(m)
    idx = rng.randint(0, N, m).astype(np.int64)
    idx[::7] = idx[0]
    idx[1::11] = N + 5
    idx[m - 1:] = -1
    if m > 3:
        idx[3] = N - 1
    return idx


@pytest.mark.parametrize("m,length", [(1, None), (5, None), (32, None),
                                      (33, None), (128, None), (129, None),
                                      (200, None), (200, 150), (33, 31),
                                      (5, 0)])
def test_block_tree_matches_jax(m, length):
    reg, pk, cred = _registry()
    idx = _index(m)
    got, hashed = _replay(reg, pk, cred, idx, length)
    live = m if length is None else min(length, m)
    # bench.py:260: gather through min(idx, N - 1) on unsigned indices
    safe = np.where((idx < 0) | (idx >= N), N - 1, idx)
    want = np.zeros((m, 8), dtype=np.uint32)
    if live:
        j = np.asarray(_jax_records_root(
            pk[safe], cred[safe], *(reg[f][safe] for f in FIELDS)))
        want[:live] = j[:live]
    np.testing.assert_array_equal(got, want)
    plain = M.validator_records_root_plain(
        C.leaves_to_torch(pk, cred, "cpu"),
        *(getattr(C.registry_to_torch(reg, "cpu"), f) for f in FIELDS),
        length=length, index=torch.from_numpy(idx))
    np.testing.assert_array_equal(got, plain.numpy().view(np.uint32))
    assert [len(hashed[k]) for k in range(3)] == [4 * live, 2 * live, live]


@pytest.mark.parametrize("length", [None, 250])
def test_full_mode_matches_jax(length):
    """Full mode (no index): row i's record, rows past `length` zero."""
    reg, pk, cred = _registry()
    got, _ = _replay(reg, pk, cred, None, length)
    want = np.asarray(_jax_records_root(pk, cred, *(reg[f] for f in FIELDS)))
    if length is not None:
        want = want.copy()
        want[length:] = 0
    np.testing.assert_array_equal(got, want)


def test_levels_run_on_their_warps_with_no_idle_lane():
    """A full block hashes on every lane at level 0, on every lane of its
    first half at level 1 and of its first quarter at level 2; no other
    warp issues, and each level's warps reach all four schedulers (warp
    index mod 4)."""
    reg, pk, cred = _registry()
    _, hashed = _replay(reg, pk, cred, _index(2 * RECORDS))
    for level, lanes in ((0, THREADS), (1, 2 * RECORDS), (2, RECORDS)):
        for blk in range(2):
            ts = sorted(t for b, t in hashed[level] if b == blk)
            assert ts == list(range(lanes))
            warps = {t // 32 for t in ts}
            assert warps == set(range(lanes // 32))
            assert {w % 4 for w in warps} == {0, 1, 2, 3}
    assert THREADS == 4 * RECORDS


def test_shared_slots_fall_in_distinct_banks():
    """The 8 words of 32 consecutive threads' level-0 digests fall in 32
    distinct banks (a slot of kSlot words, kSlot odd)."""
    for j in range(8):
        assert len({(t * SLOT + j) % 32 for t in range(32)}) == 32


def test_launcher_signature_matches_the_source(monkeypatch):
    text = SOURCE.read_text()
    m = re.search(r'extern "C" int records_root_launch\(([^)]*)\)', text)
    n_params = len([a for a in m.group(1).split(",") if a.strip()])
    fake = types.SimpleNamespace(records_root_launch=types.SimpleNamespace())
    monkeypatch.setattr(M._build, "load", lambda name: fake)
    lib = M._lib.__wrapped__()
    assert len(lib.records_root_launch.argtypes) == n_params
    assert text.count("__global__") == 1
