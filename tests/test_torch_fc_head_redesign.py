"""The schedule of the redesigned K23 (`fc_head`) against the JAX package,
on the CPU, tolerance zero.

The kernel (`csrc/forkchoice.cu`) is one block over the rung's slots,
its phases apart by barriers; `_replay` runs the same phases on numpy
arrays, one array operation a phase:

- the subtree sums and the viability: rounds of pointer jumping, each
  adding s_r into s_(r+1) at the slot and at its pointer's (never into
  the dummy slot), ORing v the same way, p_(r+1) = p_r[p_r]; the rounds
  end once every pointer is the dummy slot, or after log2(NB);
- the tie-break of each parent's viable children: round 0 on the subtree
  sum plus one as an unsigned key (a sum below -1 never survives), rounds
  1-4 on the root words packed two at a time, big-endian, into unsigned
  64-bit keys; each survivor writes itself as its parent's best child;
  the rounds end once no parent has two survivors;
- best-child doubling until every new pointer is a fixpoint of the old.

It equals JAX's `_head_kernel` and the port's `fc_head_plain` on every
case of `synthetic.head_inputs` at rungs 64, 1024 and 16384 (the tree
with and without the boost, the root words alone, a linear chain, a
chain over the whole rung, a heavier branch without a viable leaf, ties
broken only in the low word of the last pair among words of 2**31 - 1,
2**31 and 2**32 - 1), and the early exits cut the rounds the way the
kernel's design counts on.  The kernel itself is held against the plain
version on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`);
`kernels.py`'s constants are held against the CUDA source here."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.forkchoice import kernels as JK
from consensus_specs_tpu_torch.forkchoice import kernels as K
from consensus_specs_tpu_torch.forkchoice import synthetic as FS

SOURCE = Path(K.__file__).resolve().parents[1] / "csrc" / "forkchoice.cu"


def test_kernel_constants_match_the_source():
    text = SOURCE.read_text()
    m = re.search(r"#define FC_HEAD_THREADS (\d+)", text)
    assert m and int(m.group(1)) == K.HEAD_THREADS


def _replay(h: dict):
    """K23's phases on numpy: (head, rounds) with rounds = (sum rounds,
    tie-break rounds, doubling rounds)."""
    parent = h["parent"].astype(np.int64)
    n = parent.shape[0]
    nb_pad = n - 1
    rounds = K.head_rounds(nb_pad)
    real = h["real"]
    idx = np.arange(n)
    w = h["node_weight"].astype(np.uint64)
    w[h["boost_idx"]] += np.uint64(h["boost_amt"] % 2 ** 64)
    s = np.where(real, w, np.uint64(0))
    vs = np.where(h["block_epoch"] < h["cur"], h["uje"], h["je"])
    vs_ok = (h["sj"] == 0) | (vs == h["sj"]) | (vs + 2 >= h["cur"])
    v = vs_ok & ((h["sf"] == 0) | h["fin_ok"]) & real
    has_child = np.zeros(n, bool)
    has_child[parent[real]] = True
    v = v & ~has_child
    p = parent.copy()
    r = 0
    while True:
        s_nxt, v_nxt = s.copy(), v.copy()
        live = p != nb_pad
        np.add.at(s_nxt, p[live], s[live])
        v_nxt[p[live & v]] = True
        s, v, p = s_nxt, v_nxt, p[p]
        r += 1
        if not (p != nb_pad).any() or r == rounds:
            break
    sum_rounds = r

    s_signed = s.view(np.int64)
    cand = real & v & (parent < nb_pad) & (s_signed >= -1)
    bc = idx.copy()
    keys = [s + np.uint64(1)] + [
        (h["limbs"][:, 2 * k - 2].astype(np.uint64) << np.uint64(32))
        | h["limbs"][:, 2 * k - 1].astype(np.uint64) for k in range(1, 5)]
    for k, key in enumerate(keys):
        mx = np.zeros(n, np.uint64)
        np.maximum.at(mx, parent[cand], key[cand])
        cand = cand & (key == mx[parent])
        cnt = np.bincount(parent[cand], minlength=n)
        bc[parent[cand]] = idx[cand]
        if not (cnt > 1).any():
            break
    tie_rounds = k + 1

    q = 0
    for q in range(1, rounds + 1):
        x = bc[bc]
        more = (bc[x] != x).any()
        bc = x
        if not more:
            break
    return int(bc[h["justified_idx"]]), (sum_rounds, tie_rounds, q)


def _jax_head(h):
    import jax.numpy as jnp

    nb_pad = h["parent"].shape[0] - 1
    return int(JK._head_kernel(nb_pad)(
        jnp.asarray(h["parent"]), jnp.asarray(h["node_weight"]),
        jnp.int32(h["boost_idx"]), jnp.int64(h["boost_amt"]),
        jnp.asarray(h["real"]), jnp.zeros(nb_pad + 1, dtype=jnp.int64),
        jnp.asarray(h["block_epoch"]), jnp.asarray(h["je"]),
        jnp.asarray(h["uje"]), jnp.asarray(h["fin_ok"]),
        jnp.asarray(h["limbs"].astype(np.uint32)), jnp.int64(h["sj"]),
        jnp.int64(h["sf"]), jnp.int64(h["cur"]),
        jnp.int32(h["justified_idx"])))


def _plain_head(h):
    args = [torch.from_numpy(np.array(v)) if isinstance(v, np.ndarray)
            else v for v in h.values()]
    return int(K.fc_head_plain(*args))


@pytest.mark.parametrize("nb_pad", [64, 1024, 16384])
@pytest.mark.parametrize("case", FS.HEAD_CASES)
def test_schedule_equals_jax_and_the_plain_version(nb_pad, case):
    h = FS.head_inputs(nb_pad, case)
    head, (sums, ties, doubling) = _replay(h)
    assert head == _plain_head(h) == _jax_head(h)
    rounds = K.head_rounds(nb_pad)
    assert 1 <= sums <= rounds and 1 <= ties <= 5 and doubling <= rounds
    if case in ("roots", "words"):
        assert head == 4
    if case == "words":
        assert ties == 5          # the decision in the last round
    if case == "non_viable":
        assert head not in (1, 3, 4)
    if case == "full_chain":
        assert head == nb_pad - 1 and sums == rounds


@pytest.mark.parametrize("nb_pad", [1024, 16384])
def test_early_exits_halve_the_rounds_on_the_seeded_tree(nb_pad):
    """On `kernel_inputs`' random tree (depth about 20 at 1024) the
    early exits run at most half of JAX's 2 log2(NB) pointer-jumping
    rounds, and the tie-break stops after three of its five rounds (its
    one deep tie, blocks 3 and 4, ends in the second word pair)."""
    _, (sums, ties, doubling) = _replay(FS.head_inputs(nb_pad, "tree"))
    assert sums + doubling <= K.head_rounds(nb_pad)
    assert ties <= 3


def test_signed_words_would_misorder_the_tie():
    """The packed keys must compare unsigned: a pair whose high word is
    2**31 or more is negative as a signed 64-bit key.  With block 3's
    last pair (2**31, 2**31 - 1) against block 4's (2**31 - 1, 0), a
    signed compare would pick block 4; the replay's unsigned keys pick
    block 3, as the plain version (and JAX's zero-extended words) do."""
    h = FS.head_inputs(64, "words")
    key3 = (int(h["limbs"][3, 6]) << 32) | int(h["limbs"][3, 7])
    key4 = (int(h["limbs"][4, 6]) << 32) | int(h["limbs"][4, 7])
    assert key4 > key3 >= 2 ** 63
    h["limbs"][4, 6], h["limbs"][4, 7] = 2 ** 31 - 1, 0
    key4 = (int(h["limbs"][4, 6]) << 32) | int(h["limbs"][4, 7])
    assert key3 - 2 ** 64 < key4 < key3     # signed, then unsigned
    assert _replay(h)[0] == _plain_head(h) == 3
