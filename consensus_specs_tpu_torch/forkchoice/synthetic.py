"""Synthetic fork-choice workloads (counterpart of
`consensus_specs_tpu.forkchoice.synthetic`): the same seeded draws, so
both packages build byte-identical trees and attestation streams.

A seeded random block tree, an all-active 32 ETH validator set, and an
attestation stream whose target epochs climb one per batch, so latest
messages keep being accepted.
"""

from __future__ import annotations

import numpy as np

from .store import ProtoArrayStore


def synthetic_store(n_blocks: int, n_validators: int, seed: int = 29,
                    slots_per_epoch: int = 32, preset: str = "mainnet",
                    device="cuda", plain: bool = False):
    """(store, roots): every non-anchor block's parent drawn uniformly
    among its predecessors, child slot = parent slot + 1, over an
    all-active 32 ETH validator set, the clock one epoch past the newest
    block.  ``device`` and ``plain`` go to the store."""
    rng = np.random.RandomState(seed)
    anchor = b"\x41" + b"\x00" * 31
    store = ProtoArrayStore(anchor, 0, slots_per_epoch=slots_per_epoch,
                            preset=preset, device=device, plain=plain)
    roots = [anchor]
    for i in range(1, n_blocks):
        parent = roots[rng.randint(0, i)]
        slot = store.slots[store.root_index[parent]] + 1
        root = bytes(rng.randint(0, 256, 32, dtype=np.uint8))
        store.add_block(root, parent, slot, 0, 0)
        roots.append(root)
    store.set_validators(np.full(n_validators, 32 * 10 ** 9,
                                 dtype=np.int64))
    store.set_current_epoch(max(store.slots) // slots_per_epoch + 1)
    return store, roots


def attestation_stream(roots, n_validators: int, batch: int,
                       seed: int = 29):
    """Endless (validator_indices, target_epochs, block_roots) batches:
    uniform validators and vote blocks, epochs climbing one per batch."""
    rng = np.random.RandomState(seed + 1)
    epoch = 1
    while True:
        idx = rng.randint(0, n_validators, batch)
        blk = [roots[rng.randint(0, len(roots))] for _ in range(batch)]
        yield (idx.tolist(), [epoch] * batch, blk)
        epoch += 1


def kernel_inputs(nb_pad: int, v_pad: int, batch: int, seed: int = 0):
    """Seeded numpy inputs of K21-K23 at one rung of each ladder, with the
    cases the kernels must get right: 7/8 of each rung live (the rest
    padded), one validator repeated over many rows at one epoch (the
    earliest row wins), stale epochs, equivocators (can_update False),
    inactive balances, a viability mix (stale voting sources, blocks off
    the finalized chain) and two pairs of sibling blocks whose root words
    tie up to a word that is 2**31 in one and 2**31 - 1 in the other.

    Returns a dict: the apply batch (val_idx, att_epoch, att_block), the
    tables (lm_epoch, lm_block, balance, can_update, node_weight, which is
    consistent with them), the tree (parent, real, block_epoch, je, uje,
    fin_ok, limbs as int64 zero-extended words) and the head's scalars
    (boost_idx, boost_amt, sj, sf, cur, justified_idx).  With the weights
    and the boost set to zero, the head is decided by the root words alone:
    block 1 over block 2 on the first word, then block 4 over block 3 on
    the fourth."""
    rng = np.random.RandomState(seed)
    nb, nv = nb_pad - nb_pad // 8, v_pad - v_pad // 8
    b_live = batch - batch // 8

    parent = np.full(nb_pad + 1, nb_pad, dtype=np.int32)
    # the anchor's children are 1 and 2, block 1's are the leaves 3 and 4,
    # every later block hangs below 2
    parent[5:nb] = [rng.randint(4, i) for i in range(5, nb)]
    parent[parent == 4] = 2
    parent[1:3], parent[3:5] = 0, 1
    real = np.zeros(nb_pad + 1, dtype=bool)
    real[:nb] = True
    limbs = np.zeros((nb_pad + 1, 8), dtype=np.int64)
    limbs[:nb] = rng.randint(0, 2 ** 32, (nb, 8), dtype=np.int64)
    limbs[1, 0], limbs[2, 0] = 2 ** 31, 2 ** 31 - 1
    limbs[4, :3] = limbs[3, :3]
    limbs[3, 3], limbs[4, 3] = 2 ** 31 - 1, 2 ** 31
    cur, sj, sf = 10, 8, 1
    block_epoch = np.zeros(nb_pad + 1, dtype=np.int64)
    block_epoch[:nb] = rng.randint(cur - 3, cur + 1, nb)
    je = np.zeros(nb_pad + 1, dtype=np.int64)
    je[:nb] = rng.randint(5, 10, nb)
    uje = np.zeros(nb_pad + 1, dtype=np.int64)
    uje[:nb] = rng.randint(5, 10, nb)
    fin_ok = np.zeros(nb_pad + 1, dtype=bool)
    fin_ok[:nb] = rng.rand(nb) < 0.9
    fin_ok[:5] = True
    je[:5] = uje[:5] = sj

    lm_epoch = np.full(v_pad + 1, -1, dtype=np.int64)
    lm_block = np.full(v_pad + 1, -1, dtype=np.int32)
    voted = rng.rand(nv) < 0.5
    lm_epoch[:nv][voted] = rng.randint(0, 6, int(voted.sum()))
    lm_block[:nv][voted] = rng.randint(0, nb, int(voted.sum()))
    balance = np.zeros(v_pad + 1, dtype=np.int64)
    balance[:nv] = rng.choice([0, 31 * 10 ** 9, 32 * 10 ** 9], nv,
                              p=[0.05, 0.15, 0.8])
    can_update = np.zeros(v_pad + 1, dtype=bool)
    can_update[:nv] = rng.rand(nv) >= 0.03
    lm_epoch[5], lm_block[5], can_update[5] = 3, 1, True
    node_weight = np.zeros(nb_pad + 1, dtype=np.int64)
    has = lm_block >= 0
    np.add.at(node_weight, lm_block[has], balance[has])

    val_idx = np.full(batch, v_pad, dtype=np.int32)
    att_epoch = np.full(batch, -1, dtype=np.int64)
    att_block = np.full(batch, nb_pad, dtype=np.int32)
    val_idx[:b_live] = rng.randint(0, nv, b_live)
    att_epoch[:b_live] = rng.randint(0, 9, b_live)
    att_block[:b_live] = rng.randint(0, nb, b_live)
    rep = min(10, b_live)
    val_idx[:rep] = 5
    att_epoch[:rep] = 7

    return dict(
        val_idx=val_idx, att_epoch=att_epoch, att_block=att_block,
        lm_epoch=lm_epoch, lm_block=lm_block, balance=balance,
        can_update=can_update, node_weight=node_weight, parent=parent,
        real=real, block_epoch=block_epoch, je=je, uje=uje, fin_ok=fin_ok,
        limbs=limbs, boost_idx=int(rng.randint(1, nb)),
        boost_amt=40 * 32 * 10 ** 9, sj=sj, sf=sf, cur=cur, justified_idx=0)


def apply_batches(nb_pad: int, v_pad: int, batch: int, n_batches: int,
                  seed: int = 0):
    """`kernel_inputs`' tables and `n_batches` apply batches to fold into
    them one after another, the first `kernel_inputs`' own.  Each later
    batch k has 1/8 padded rows, validators repeated among its random
    rows, epochs in [k, 9 + k) (some above the table's, some below),
    validator 5 on ten rows at epoch 2 (its table entry is 7 once the first
    batch is folded: the winner is rejected as older), and an equivocator
    (can_update False) on four rows at epoch 50 + k.  Returns (the
    `kernel_inputs` dict, [(val_idx, att_epoch, att_block), ...])."""
    x = kernel_inputs(nb_pad, v_pad, batch, seed=seed)
    rng = np.random.RandomState(seed + 1)
    nb, nv = nb_pad - nb_pad // 8, v_pad - v_pad // 8
    b_live = batch - batch // 8
    equivocator = int(np.flatnonzero(~x["can_update"][:nv])[0])
    batches = [(x["val_idx"], x["att_epoch"], x["att_block"])]
    for k in range(1, n_batches):
        val_idx = np.full(batch, v_pad, dtype=np.int32)
        att_epoch = np.full(batch, -1, dtype=np.int64)
        att_block = np.full(batch, nb_pad, dtype=np.int32)
        val_idx[:b_live] = rng.randint(0, nv, b_live)
        att_epoch[:b_live] = rng.randint(k, 9 + k, b_live)
        att_block[:b_live] = rng.randint(0, nb, b_live)
        rep = min(10, b_live)
        val_idx[:rep], att_epoch[:rep] = 5, 2
        val_idx[rep:rep + 4], att_epoch[rep:rep + 4] = equivocator, 50 + k
        batches.append((val_idx, att_epoch, att_block))
    return x, batches


HEAD_CASES = ("tree", "boost", "roots", "chain", "full_chain", "non_viable",
              "words")


def head_inputs(nb_pad: int, case: str, seed: int = 0) -> dict:
    """K23's inputs for one named case on `kernel_inputs`' tree: the
    dict `fc_head`'s arguments are taken from, in its order under the
    keys parent, node_weight, boost_idx, boost_amt, real, block_epoch,
    je, uje, fin_ok, limbs, sj, sf, cur, justified_idx.

    tree    the seeded tree and its weights, no boost;
    boost   the same with the proposer boost;
    roots   zero weights: the head decided by the root words (block 1
            over 2 on a first word of 2**31 against 2**31 - 1, block 4
            over 3 on the fourth);
    chain   every live block the child of the one before, all viable and
            weighted;
    full_chain  the same over every row of the rung but the dummy slot:
            a chain of NB blocks, whose pointers need all log2(NB)
            rounds;
    non_viable  the anchor's child 1 carries the heaviest subtree, but
            none of its leaves is viable: the head lies below block 2;
    words   zero weights, blocks 3 and 4 (block 1's children) equal in
            all their words but the last, words of 2**31 - 1, 2**31 and
            2**32 - 1 among them; block 4 wins on the low word of the
            last pair (2**31 against 2**31 - 1), and so every tie-break
            round runs."""
    x = kernel_inputs(nb_pad, 256, 64, seed=seed)
    keys = ("parent", "node_weight", "boost_idx", "boost_amt", "real",
            "block_epoch", "je", "uje", "fin_ok", "limbs", "sj", "sf",
            "cur", "justified_idx")
    h = {k: x[k] for k in keys}
    h["boost_idx"], h["boost_amt"] = nb_pad, 0
    nb = nb_pad - nb_pad // 8
    if case == "boost":
        h["boost_idx"], h["boost_amt"] = x["boost_idx"], x["boost_amt"]
    elif case in ("roots", "words"):
        h["node_weight"] = np.zeros_like(x["node_weight"])
        if case == "words":
            row = np.array([2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1, 0, 7,
                            2 ** 32 - 1, 2 ** 31, 2 ** 31 - 1])
            h["limbs"] = x["limbs"].copy()
            h["limbs"][3] = h["limbs"][4] = row
            h["limbs"][4, 7] = 2 ** 31
    elif case in ("chain", "full_chain"):
        if case == "full_chain":
            nb = nb_pad
            h["real"] = np.arange(nb_pad + 1) < nb_pad
            h["node_weight"] = np.where(
                h["real"], np.arange(nb_pad + 1) % 97 * 10 ** 9, 0)
        h["parent"] = x["parent"].copy()
        h["parent"][1:nb] = np.arange(nb - 1, dtype=np.int32)
        h["fin_ok"] = h["real"].copy()
        h["je"] = np.where(h["real"], x["sj"], 0)
        h["uje"] = h["je"].copy()
    elif case == "non_viable":
        h["node_weight"] = x["node_weight"].copy()
        h["node_weight"][3] = 10 ** 15
        h["fin_ok"] = x["fin_ok"].copy()
        h["fin_ok"][3:5] = False
    elif case != "tree":
        raise ValueError(f"unknown head case {case!r}")
    return h
