"""The schedules of the redesigned kernels K18 (`fr_fft`) and K15's batch
inverse (`fr_batch_inverse`) against the JAX package, on the CPU,
tolerance zero (exact arithmetic mod r on Python ints).

- (a) K18's schedule, replayed: the tile launch (tiles of T contiguous
  elements of a bit-reversed row, each running the stages h < T with the
  twiddles tw[j] = roots[j n / T], stage h's twiddle i at tw[i T / (2h)]),
  then, for n > T, the class launch (residue class c mod T, its n / T
  elements c + T q, stage h' = h / T pairing q and q + h' with twiddle
  roots[(c + T i') (n / T) / (2h')], i' = q mod h'), then the scale.  It
  equals JAX's `fr_fft` and the port's `fft_plain` at n = 2, 4, 16 and
  256 with T < n, T = n and T > n, forward and inverse, batch 1, 2 and 3;
  and the host FFT route at n = 8192 with the card's T.
- (b) The batch inverse's schedule, replayed: blocks of B threads, thread
  gt of GT = blocks B taking the run j = gt + k GT; its prefix products;
  each block's heap over its threads' run products; block 0's heap over
  the block products, one inversion of its root and the walk down; each
  block's walk down; the runs walked back.  It equals JAX's host
  `das/recover.py:110 _batch_inverse` and the port's plain
  `_batch_inverse_limbs`, limb for limb, at n = 1, 2, 8, 1024 and 8192
  with runs of 1 and 8, and with a zero element (every output 0).

The kernels themselves are held against the plain versions on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`); `kernels.py`'s constants
are held against the CUDA source's here."""

import functools
import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.das import recover as Jrecover
from consensus_specs_tpu.ops import fr_batch as J
from consensus_specs_tpu_torch.das import compute as Tcompute
from consensus_specs_tpu_torch.das import recover as Trecover
from consensus_specs_tpu_torch.ops import fr_batch as T
from consensus_specs_tpu_torch.ops.fr_batch import kernels as K

R = J.R_MODULUS
SOURCE = (Path(T.__file__).resolve().parents[2] / "csrc" / "fr_batch.cu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _roots(n):
    g = pow(7, (R - 1) // n, R)
    return [pow(g, i, R) for i in range(n)]


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert m, name
    return int(m.group(1))


def test_kernel_constants_match_the_source():
    assert K.FFT_TILE == _constant("kFftTile")
    assert K.FFT_CLASS_MAX == (_constant("kFftClass")
                               * _constant("kFftClassPer"))
    assert K.INV_BLOCK == _constant("kInvBlock")


# --- (a) K18 -------------------------------------------------------------------


def _host_side(rows, roots, inverse):
    """`fft_inputs` on ints: bit-reversed rows, the (reversed) roots, the
    scale."""
    n = len(roots)
    if inverse:
        roots = [roots[0]] + roots[:0:-1]
    perm = T._bitrev_perm(n)
    return ([[row[j] for j in perm] for row in rows], roots,
            pow(n, R - 2, R) if inverse else 1)


def _stages(s, tw_of, count):
    """Radix-2 DIT stages h = 1 .. count/2 over s in place, stage h's
    butterfly b pairing e = 2b - i and e + h, i = b mod h, its twiddle
    tw_of(h, i)."""
    h = 1
    while h < count:
        for b in range(count // 2):
            i = b & (h - 1)
            e = 2 * b - i
            u, v = s[e], s[e + h] * tw_of(h, i) % R
            s[e], s[e + h] = (u + v) % R, (u - v) % R
        h *= 2


def fft_schedule(rows_brp, roots, scale, tile):
    """K18's two launches on ints: natural-order rows times `scale`."""
    n = len(roots)
    t = min(tile, n)
    m = n // t
    out = []
    for row in rows_brp:
        x = list(row)
        tw = [roots[j * m] for j in range(t // 2)]      # roots[j n / T]
        for t0 in range(0, n, t):
            s = x[t0:t0 + t]
            _stages(s, lambda h, i: tw[i * (t // 2 // h)], t)
            x[t0:t0 + t] = s
        for c in range(t if m > 1 else 0):
            s = [x[c + t * q] for q in range(m)]
            _stages(s, lambda h, i: roots[(c + t * i) * (m // 2 // h)], m)
            for q in range(m):
                x[c + t * q] = s[q]
        out.append([v * scale % R for v in x])
    return out


@functools.lru_cache(maxsize=None)
def _fft_case(n, batch, inverse):
    """Seeded rows, JAX's `fr_fft` and the port's `fft_plain` on them."""
    rng = random.Random(n * 10 + batch + 100 * inverse)
    roots = _roots(n)
    rows = [[rng.randrange(R) for _ in range(n)] for _ in range(batch)]
    jax_out = J.fr_fft(rows, roots, inverse=inverse)
    arrays = T.fft_inputs(rows, roots, inverse)
    limbs = T.fft_plain(*(torch.from_numpy(a) for a in arrays))
    plain = T.from_limbs(limbs)
    return rows, roots, jax_out, [plain[i * n:(i + 1) * n]
                                  for i in range(batch)]


@pytest.mark.parametrize("n,batch", [(2, 1), (4, 2), (16, 3), (256, 2)])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("tile_of_n", ["below", "equal", "above"])
def test_fft_schedule_equals_jax_and_the_plain_version(n, batch, inverse,
                                                       tile_of_n):
    tile = {"below": max(2, n // 4), "equal": n, "above": 2 * n}[tile_of_n]
    rows, roots, jax_out, plain = _fft_case(n, batch, inverse)
    got = fft_schedule(*_host_side(rows, roots, inverse), tile)
    assert got == jax_out
    assert got == plain


@pytest.mark.parametrize("inverse", [False, True])
def test_fft_schedule_at_8192_with_the_cards_tile(inverse):
    n = 8192
    rng = random.Random(8192 + inverse)
    roots = _roots(n)
    rows = [[rng.randrange(R) for _ in range(n)]]
    got = fft_schedule(*_host_side(rows, roots, inverse), K.FFT_TILE)
    host = Tcompute._ifft if inverse else Tcompute._fft
    assert got == [host(rows[0], roots)]


# --- (b) K15's batch inverse -----------------------------------------------------


def _heap_up(leaves_vals):
    leaves = len(leaves_vals)
    tr = [None] * leaves + list(leaves_vals)
    m = leaves // 2
    while m > 0:
        for t in range(m):
            tr[m + t] = tr[2 * (m + t)] * tr[2 * (m + t) + 1] % R
        m //= 2
    return tr


def _heap_down(tr, leaves):
    """tr[1] holds the root's inverse; every node's inverse, a level at a
    time from the level above's (written after the whole level reads)."""
    m = 2
    while m <= leaves:
        level = [tr[(m + t) // 2] * tr[(m + t) ^ 1] % R for t in range(m)]
        tr[m:2 * m] = level
        m *= 2


def batch_inverse_schedule(vals, block, blocks):
    """The cooperative launch of `fr_batch_inverse` on ints: `blocks`
    blocks of `block` threads (a power of two)."""
    n = len(vals)
    gt_all = block * blocks
    run = -(-n // gt_all)
    acc, pre = [1] * gt_all, {}
    for gt in range(gt_all):
        for k in range(run):
            j = gt + k * gt_all
            if j >= n:
                break
            acc[gt] = vals[j] if k == 0 else acc[gt] * vals[j] % R
            pre[j] = acc[gt]
    heaps = [_heap_up(acc[b * block:(b + 1) * block]) for b in range(blocks)]
    leaves = 1 << (blocks - 1).bit_length()
    top = _heap_up([h[1] for h in heaps] + [1] * (leaves - blocks))
    top[1] = pow(top[1], R - 2, R)            # 0 -> 0, as the binary inverse
    _heap_down(top, leaves)
    out = [None] * n
    for b, tr in enumerate(heaps):
        tr[1] = top[leaves + b]
        _heap_down(tr, block)
        for t in range(block):
            gt = b * block + t
            inv = tr[block + t]
            for k in range(run - 1, -1, -1):
                j = gt + k * gt_all
                if j >= n:
                    continue
                if k > 0:
                    out[j] = inv * pre[j - gt_all] % R
                    inv = inv * vals[j] % R
                else:
                    out[j] = inv
    return out, run


# (n, block, blocks, run): runs of 1 and of 8; the card's block of 256
# threads with its default blocks (one element a thread, 5 blocks at 1027)
INV_CASES = [(1, 1, 1, 1), (2, 2, 1, 1), (8, 8, 1, 1), (8, 1, 1, 8),
             (1024, 256, 4, 1), (1024, 32, 4, 8), (1027, 256, 5, 1),
             (8192, 256, 32, 1), (8192, 256, 4, 8)]


@pytest.mark.parametrize("n,block,blocks,run", INV_CASES)
@pytest.mark.parametrize("zero", [False, True])
def test_batch_inverse_schedule_equals_jax_and_the_plain_version(
        n, block, blocks, run, zero):
    rng = random.Random(n + block + blocks)
    vals = [rng.randrange(1, R) for _ in range(n)]
    if zero:
        vals[(2 * n) // 3] = 0
    got, got_run = batch_inverse_schedule(vals, block, blocks)
    assert got_run == run
    want = Jrecover._batch_inverse(vals)
    assert got == want
    assert got == ([0] * n if zero else [pow(v, R - 2, R) for v in vals])
    x = torch.from_numpy(T.FR.to_mont_batch(vals))
    plain = Trecover._batch_inverse_limbs(x)
    assert np.array_equal(plain.numpy(), T.FR.to_mont_batch(got))
