"""The schedule of the redesigned K22 (`fc_refresh`) against the JAX
package, on the CPU, tolerance zero.

The kernel (`csrc/forkchoice.cu`) is one launch with no memset: a grid of
at most one block a multiprocessor, kRefreshThreads threads a block, each
thread striding over the validators kRefreshUnroll rows a pass.  A thread
sums its consecutive rows on one block slot in a register and adds each
run's sum v once:

- shared route, while (NB + 1) 8 bytes fit a block's shared memory:
  into the block's histogram of two 32-bit words a slot, v's low word
  into lo by atomicAdd, v's high word plus the carry out of lo (old + low
  word wrapped) into hi; then each nonzero slot (hi << 32 | lo) once into
  the output by a 64-bit atomic add;
- global route (NB past that): each run straight into the output.

The output (NB + 1 slots) is zero on entry: the launch before zeroed it,
and each launch's threads zero the next launch's output, a slot a thread
a stride, so that no block waits for another.

`_replay` runs that schedule on Python integers, each block's atomics in
a random order and the blocks in a random order, over a sequence of
calls, each on the output the call before zeroed, and holds each output
to JAX's `_refresh_kernel` and the port's `fc_refresh_plain`, and the
next call's output to all zero after each call: balances of 2**32 - 1, 2**32, near 2**63 and
negative, thousands of validators on one slot (lo carries many times, hi
wraps), tables with no vote, half voted and all on one block, at NB = 64,
1024 and 32768 (the global route).  The kernel itself is held against
the plain version and `index_add_` on the card (`tests/test_torch_cuda.py`,
`chip_smoke.py`); the source's launcher signatures and the constants the
replay reads are checked here."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.forkchoice import kernels as JK
from consensus_specs_tpu_torch.forkchoice import kernels as K

SOURCE = Path(K.__file__).resolve().parents[1] / "csrc" / "forkchoice.cu"
MASK32, MASK64 = 2**32 - 1, 2**64 - 1


def _constant(name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    return int(m.group(1))


THREADS, UNROLL = _constant("kRefreshThreads"), _constant("kRefreshUnroll")
MAX_SHARED = _constant("kMaxShared")


def _shared_route(nb_pad: int) -> bool:
    """fc_refresh_shared_bytes: the histogram fits a block's shared
    memory."""
    return 8 * (nb_pad + 1) <= MAX_SHARED


def _thread_runs(lm_block, balance, nb_pad, lane, stride, unroll):
    """The (slot, v) adds of one thread: its rows in pass order, a run of
    rows on one slot summed in a register mod 2**64, zero sums dropped."""
    n = lm_block.shape[0]
    adds, cur, total = [], -1, 0
    for i0 in range(lane, n, unroll * stride):
        for u in range(unroll):
            i = i0 + u * stride
            if i >= n:
                continue
            b = int(lm_block[i])
            if b < 0 or b > nb_pad:
                continue
            if b != cur:
                if total:
                    adds.append((cur, total))
                cur, total = b, 0
            total = (total + int(balance[i])) & MASK64
    if total:
        adds.append((cur, total))
    return adds


def _replay(lm_block, balance, nb_pad, acc, rng, threads=THREADS,
            unroll=UNROLL, sms=132):
    """One launch of K22's schedule adding into `acc` (a list of NB + 1
    Python ints, zero on entry).  Returns the output as int64 and the next
    launch's accumulator (uninitialised words, as `torch.empty` gives,
    zeroed by this launch's threads)."""
    n, slots = lm_block.shape[0], nb_pad + 1
    grid = max(1, min(sms, -(-n // (threads * unroll))))
    stride = grid * threads
    shared = _shared_route(nb_pad)
    nxt = [int(x) for x in rng.randint(1, 2**31, slots)]
    for blk in rng.permutation(grid):
        for t in range(threads):
            nxt[blk * threads + t::stride] = [0] * len(
                nxt[blk * threads + t::stride])
        adds = [a for t in range(threads) for a in _thread_runs(
            lm_block, balance, nb_pad, blk * threads + t, stride, unroll)]
        order = rng.permutation(len(adds))
        if shared:
            lo, hi = [0] * slots, [0] * slots
            for k in order:
                s, v = adds[k]
                a, h = v & MASK32, v >> 32
                if a:
                    old = lo[s]
                    lo[s] = (old + a) & MASK32
                    h += (old + a) & MASK32 < old        # the carry out
                if h & MASK32:
                    hi[s] = (hi[s] + h) & MASK32
            # -- __syncthreads --; the block's flush
            for s in range(slots):
                v = (hi[s] << 32) | lo[s]
                if v:
                    acc[s] = (acc[s] + v) & MASK64
        else:
            for k in order:
                s, v = adds[k]
                acc[s] = (acc[s] + v) & MASK64
    out = np.array([x - 2**64 if x >= 2**63 else x for x in acc],
                   dtype=np.int64)
    return out, nxt


def _table(case, v, nb_pad, rng):
    """(lm_block (V + 1,) int32, balance (V + 1,) int64); slot V is the
    padding validator with no vote."""
    lm = np.full(v + 1, -1, np.int32)
    edge = np.array([2**32 - 1, 2**32, 2**63 - 1, 2**63 - 2**31, -2**63,
                     -1, -(2**32), 7], np.int64)
    bal = rng.choice(edge, v + 1)
    if case == "half":
        on = rng.rand(v) < 0.5
        lm[:v][on] = rng.randint(0, nb_pad, int(on.sum()))
        bal[rng.rand(v + 1) < 0.5] = 32 * 10**9
    elif case == "one":
        lm[:v] = min(3, nb_pad - 1)
    return lm, bal


@pytest.mark.parametrize("nb_pad", [64, 1024, 32768])
@pytest.mark.parametrize("shape", [(THREADS, UNROLL, 132), (32, 4, 3)],
                         ids=["source", "small-grid"])
def test_one_launch_schedule_matches_jax(nb_pad, shape):
    threads, unroll, sms = shape
    rng = np.random.RandomState(nb_pad + threads)
    v = 4096 if threads == THREADS else 3000
    acc = [0] * (nb_pad + 1)
    for case in ("empty", "half", "one", "half"):
        lm, bal = _table(case, v, nb_pad, rng)
        got, acc = _replay(lm, bal, nb_pad, acc, rng, threads, unroll, sms)
        assert not any(acc), "the next call's accumulator is not zero"
        want = np.asarray(JK._refresh_kernel(v + 1, nb_pad)(lm, bal))
        np.testing.assert_array_equal(got, want)
        plain = K.fc_refresh_plain(torch.from_numpy(lm),
                                   torch.from_numpy(bal), nb_pad)
        np.testing.assert_array_equal(got, plain.numpy())


def test_one_slot_carries_and_wraps():
    """Thousands of validators on one slot: the low word carries into the
    high word many times and the high word wraps, as the int64 sum wraps
    mod 2**64 in JAX."""
    v, nb_pad = 6000, 64
    rng = np.random.RandomState(1)
    lm, bal = _table("one", v, nb_pad, rng)
    total = sum(int(x) for x in bal[:v]) & MASK64
    carries = sum(int(x) & MASK32 for x in bal[:v]) >> 32
    his = sum((int(x) & MASK64) >> 32 for x in bal[:v])
    assert carries > 1000 and his + carries > 2**32
    got, _ = _replay(lm, bal, nb_pad, [0] * (nb_pad + 1), rng, 32, 4, 3)
    assert int(got[3]) & MASK64 == total
    want = np.asarray(JK._refresh_kernel(v + 1, nb_pad)(lm, bal))
    np.testing.assert_array_equal(got, want)


def test_routes_by_rung():
    """The shared histogram takes the ladder's rungs up to 16384; 32768
    and up take the global route."""
    assert [_shared_route(nb) for nb in (64, 1024, 16384, 32768, 65536)] == \
        [True, True, True, False, False]


def _launcher_params(text: str, name: str) -> int:
    m = re.search(r'extern "C" \w+(?: \w+)? ' + name + r"\(([^)]*)\)", text)
    assert m, name
    return len([a for a in m.group(1).split(",") if a.strip()])


class _FakeLib:
    """Records the attributes `_lib` sets on each function."""

    def __init__(self):
        self.fns = {}

    def __getattr__(self, name):
        return self.fns.setdefault(name, types.SimpleNamespace())


def test_launcher_signatures_match_the_source(monkeypatch):
    text = SOURCE.read_text()
    fake = _FakeLib()
    monkeypatch.setattr(K._build, "load", lambda name: fake)
    K._lib.__wrapped__()
    for name in ("fc_refresh_launch", "fc_refresh_shared_bytes",
                 "fc_head_scratch_bytes"):
        assert len(fake.fns[name].argtypes) == _launcher_params(text, name)
    assert "cudaMemsetAsync" not in text


def test_accumulator_is_kept_per_device_and_size(monkeypatch):
    """The wrapper's accumulator: NB + 1 zero words, made once per (device,
    stream, NB + 1) and handed back on later calls (on the CPU with the
    stream stubbed); a launch puts the next one in its place."""
    monkeypatch.setattr(K, "_REFRESH_ACCS", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=1))
    t = K.refresh_accumulator("cpu", 65)
    assert t.dtype == torch.int64 and t.shape == (65,) and not t.any()
    assert K.refresh_accumulator("cpu", 65) is t
    assert K.refresh_accumulator("cpu", 1025) is not t
