"""The fork-choice kernels K21-K23 (`csrc/forkchoice.cu`) and their plain
PyTorch versions (counterpart of `consensus_specs_tpu.forkchoice.kernels`).

LMD-GHOST is segment-shaped integer work over flat arrays:

apply (K21, JAX `_apply_kernel`)
    a batch of latest-message candidates (validator, target epoch, block
    index) folds into the latest-message table and the per-block weights:
    each validator's in-batch winner is the row with the largest key
    ``epoch * B + (B - 1 - pos)`` (highest epoch, earliest arrival on
    ties: the spec's sequential ``update_latest_messages``), the winner
    is accepted when its epoch is strictly greater than the table's and
    the validator is not an equivocator, and the weight deltas (-balance
    at the old vote block, +balance at the new one) land as one
    scatter-add.  The strictly-greater rule makes a repeated batch a
    no-op.
refresh (K22, JAX `_refresh_kernel`)
    node_weight[b] = the sum of the balances of the validators whose
    latest message is b.
head (K23, JAX `_head_kernel`)
    subtree weights by log2(rung) rounds of pointer jumping on the
    parent array (``s += scatter(s -> 2^k-th ancestor)``), leaf viability
    ORed up by the same doubling with max, the best child of each parent
    by a masked segment-argmax over (subtree weight, the 8 big-endian
    root words), and the head as the fixpoint of doubling on best_child
    from the justified block.  The kernel ends each doubling once it has
    reached its fixpoint and takes the root words two at a time as one
    unsigned key: the same head.

Unlike JAX's functional kernels, `fc_apply` updates the latest-message
table and the weights in place and returns the accept mask (the store
owns those tensors; a copy per batch would move the whole table).

Every array keeps JAX's one extra dummy slot (index == rung) that the
masked rows address.  What lands there is unspecified (XLA, CUDA and
`index_put_` all leave the order of colliding writes open) and no live
chain reads it, so comparisons leave it out.  Root limbs travel as int64
zero-extended from the uint32 words, so the tie-break orders words of
2**31 and above as JAX's ``astype(int64)`` does.

`fc_apply`, `fc_refresh` and `fc_head` run the plain version for CPU
tensors and launch the kernel for CUDA tensors; a failed build or launch
raises, with no fallback.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build

# batch-shape ladders (JAX `kernels.py:54-56`): blocks, validators,
# attestation batches
FC_BLOCK_STEPS = (64, 1024, 16384)
FC_VALIDATOR_STEPS = (256, 4096, 65536, 1048576)
FC_BATCH_STEPS = (64, 1024, 16384)

# K23's block (`FC_HEAD_THREADS`)
HEAD_THREADS = 512


def fc_rung(n: int, steps=FC_BLOCK_STEPS) -> int:
    """Padded shape for n live rows on the given ladder: the first step
    at or above the next power of two, or that power past the top."""
    b = 1 if n <= 1 else 1 << (n - 1).bit_length()
    for step in steps:
        if b <= step:
            return step
    return b


def head_rounds(nb_pad: int) -> int:
    """Pointer-jumping rounds for a rung: 2**rounds jumps cover any chain
    of at most nb_pad live blocks."""
    return max(int(nb_pad).bit_length() - 1, 1)


# --- the plain versions ------------------------------------------------------


def fc_apply_plain(val_idx, att_epoch, att_block, lm_epoch, lm_block,
                   balance, can_update, node_weight):
    """K21's plain version: folds the padded batch (val_idx (B,) int32,
    att_epoch (B,) int64, att_block (B,) int32; padded rows v_pad, -1,
    nb_pad) into lm_epoch (V+1,) int64, lm_block (V+1,) int32 and
    node_weight (NB+1,) int64 in place, given balance (V+1,) int64 and
    can_update (V+1,) bool.  Returns the accept mask (B,) bool."""
    batch = val_idx.shape[0]
    v_pad = lm_epoch.shape[0] - 1
    nb_pad = node_weight.shape[0] - 1
    vi = val_idx.long()
    pos = torch.arange(batch, dtype=torch.int64, device=vi.device)
    key = att_epoch * batch + (batch - 1 - pos)
    best = torch.full((v_pad + 1,), -1, dtype=torch.int64, device=vi.device)
    best.scatter_reduce_(0, vi, key, "amax")
    accept = ((best[vi] == key) & (att_epoch >= 0)
              & (att_epoch > lm_epoch[vi]) & can_update[vi])
    bal = balance[vi]
    old_block = lm_block[vi].long()
    sub_tgt = torch.where(accept & (old_block >= 0), old_block, nb_pad)
    add_tgt = torch.where(accept, att_block.long(), nb_pad)
    tgt = torch.where(accept, vi, v_pad)
    lm_epoch.index_put_((tgt,), att_epoch)
    lm_block.index_put_((tgt,), att_block)
    node_weight.index_add_(0, sub_tgt, -bal)
    node_weight.index_add_(0, add_tgt, bal)
    node_weight[nb_pad] = 0
    return accept


def fc_refresh_plain(lm_block, balance, nb_pad: int):
    """K22's plain version: (NB+1,) int64 weights, node_weight[b] = the
    balances of the validators whose lm_block is b."""
    has = lm_block >= 0
    tgt = torch.where(has, lm_block.long(), nb_pad)
    val = torch.where(has, balance, 0)
    out = torch.zeros(nb_pad + 1, dtype=torch.int64, device=balance.device)
    return out.index_add_(0, tgt, val)


def fc_head_plain(parent, node_weight, boost_idx: int, boost_amt: int, real,
                  block_epoch, je, uje, fin_ok, limbs, sj: int, sf: int,
                  cur: int, justified_idx: int):
    """K23's plain version over one padded rung (every array NB+1 long:
    parent int32 with the anchor and padded rows at NB, node_weight,
    block_epoch, je, uje int64, real and fin_ok bool, limbs (NB+1, 8)
    int64 zero-extended root words).  Returns the head's index, a 0-d
    int32 tensor."""
    nb_pad = parent.shape[0] - 1
    rounds = head_rounds(nb_pad)
    par = parent.long()
    w = node_weight.clone()
    w[boost_idx] += boost_amt
    w = torch.where(real, w, 0)

    s, ptr = w, par
    for _ in range(rounds):
        s = s.index_add(0, ptr, s)
        s[nb_pad] = 0
        ptr = ptr[ptr]

    vs = torch.where(block_epoch < cur, uje, je)
    vs_ok = (vs == sj) | (vs + 2 >= cur) | (sj == 0)
    f_ok = fin_ok | (sf == 0)
    has_child = torch.zeros(nb_pad + 1, dtype=torch.int32,
                            device=parent.device)
    has_child.scatter_reduce_(0, par, real.int(), "amax")
    vsub = (vs_ok & f_ok & real & (has_child == 0)).int()
    ptr = par
    for _ in range(rounds):
        vsub = vsub.scatter_reduce(0, ptr, vsub, "amax")
        ptr = ptr[ptr]

    cand = real & (vsub > 0) & (par < nb_pad)
    for key in [s] + [limbs[:, j] for j in range(8)]:
        mx = torch.full((nb_pad + 1,), -1, dtype=torch.int64,
                        device=parent.device)
        mx.scatter_reduce_(0, torch.where(cand, par, nb_pad), key, "amax")
        cand = cand & (key == mx[par])

    idx = torch.arange(nb_pad + 1, dtype=torch.int64, device=parent.device)
    bc = idx.index_put((torch.where(cand, par, nb_pad),), idx)
    for _ in range(rounds):
        bc = bc[bc]
    return bc[justified_idx].int()


# --- the kernels -------------------------------------------------------------


_p, _i32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIGNATURES = {
    "fc_apply_launch": [_p] * 10 + [_i32, _i32, _p],
    "fc_refresh_launch": [_p, _p, _i64, _i32, _p, _p],
    "fc_head_launch": ([_p, _p, _i32, _i64, _p, _p, _p, _p, _p, _p,
                        _i64, _i64, _i64, _i32, _i32, _i32, _p, _p, _p, _p]),
    "fc_barrier_probe_launch": [_i32, _p, _p],
}


@functools.cache
def _lib():
    lib = _build.load("forkchoice")
    for f, args in _SIGNATURES.items():
        getattr(lib, f).argtypes = args
        getattr(lib, f).restype = _i32
    lib.fc_head_scratch_bytes.argtypes = [_i32]
    lib.fc_head_scratch_bytes.restype = _i64
    return lib


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def fc_apply_kernel(val_idx, att_epoch, att_block, lm_epoch, lm_block,
                    balance, can_update, node_weight):
    """K21 on the card: `fc_apply_plain`'s function, three launches (reset
    the winner keys of the batch's validators, the scatter-max, the
    per-row accept with the table writes and the weight atomics) counted
    as one call."""
    b = val_idx.shape[0]
    v1, nb1 = lm_epoch.shape[0], node_weight.shape[0]
    for name, t, dtype, shape in (
            ("val_idx", val_idx, torch.int32, (b,)),
            ("att_epoch", att_epoch, torch.int64, (b,)),
            ("att_block", att_block, torch.int32, (b,)),
            ("lm_epoch", lm_epoch, torch.int64, (v1,)),
            ("lm_block", lm_block, torch.int32, (v1,)),
            ("balance", balance, torch.int64, (v1,)),
            ("can_update", can_update, torch.bool, (v1,)),
            ("node_weight", node_weight, torch.int64, (nb1,))):
        _check(f"fc_apply {name}", t, dtype, shape)
    best = torch.empty(v1, dtype=torch.int64, device=val_idx.device)
    accept = torch.empty(b, dtype=torch.bool, device=val_idx.device)
    args = (val_idx, att_epoch, att_block, lm_epoch, lm_block, balance,
            can_update, node_weight, best, accept)
    _build.require_cuda("fc_apply", *args)
    if b:
        _build.check(_lib().fc_apply_launch(
            *(t.data_ptr() for t in args), b, nb1 - 1,
            _build.stream_ptr(val_idx)), "fc_apply")
        _build.launches["fc_apply"] += 1
    return accept


def fc_refresh_kernel(lm_block, balance, nb_pad: int):
    """K22 on the card: `fc_refresh_plain`'s function, one thread per
    validator and an int64 atomic add into NB+1 slots."""
    v1 = lm_block.shape[0]
    _check("fc_refresh lm_block", lm_block, torch.int32, (v1,))
    _check("fc_refresh balance", balance, torch.int64, (v1,))
    out = torch.empty(nb_pad + 1, dtype=torch.int64, device=balance.device)
    _build.require_cuda("fc_refresh", lm_block, balance, out)
    _build.check(_lib().fc_refresh_launch(
        lm_block.data_ptr(), balance.data_ptr(), v1, nb_pad, out.data_ptr(),
        _build.stream_ptr(balance)), "fc_refresh")
    _build.launches["fc_refresh"] += 1
    return out


def fc_head_kernel(parent, node_weight, boost_idx: int, boost_amt: int, real,
                   block_epoch, je, uje, fin_ok, limbs, sj: int, sf: int,
                   cur: int, justified_idx: int, stats=None):
    """K23 on the card: `fc_head_plain`'s function in one block of
    HEAD_THREADS threads, its phases apart by barriers, the rung's arrays
    in shared memory where they fit and in a scratch tensor past that
    (rungs of 8192 and up).  As the store makes
    them, the root words lie in [0, 2**32) and the dummy slot is a padded
    row (its own parent, not live); the kernel counts on both.  Where `stats` (an int32 (3,)
    tensor on the card) is given, the kernel writes the rounds its sums,
    its tie-break and its doubling ran."""
    n1 = parent.shape[0]
    nb_pad = n1 - 1
    for name, t, dtype, shape in (
            ("parent", parent, torch.int32, (n1,)),
            ("node_weight", node_weight, torch.int64, (n1,)),
            ("real", real, torch.bool, (n1,)),
            ("block_epoch", block_epoch, torch.int64, (n1,)),
            ("je", je, torch.int64, (n1,)),
            ("uje", uje, torch.int64, (n1,)),
            ("fin_ok", fin_ok, torch.bool, (n1,)),
            ("limbs", limbs, torch.int64, (n1, 8))):
        _check(f"fc_head {name}", t, dtype, shape)
    if not (0 <= boost_idx <= nb_pad and 0 <= justified_idx < nb_pad):
        raise ValueError("fc_head: boost or justified index out of range")
    args = (parent, node_weight, real, block_epoch, je, uje, fin_ok, limbs)
    _build.require_cuda("fc_head", *args)
    lib = _lib()
    nbytes = lib.fc_head_scratch_bytes(n1)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=parent.device)
               if nbytes else None)
    out = torch.empty((), dtype=torch.int32, device=parent.device)
    _build.check(lib.fc_head_launch(
        parent.data_ptr(), node_weight.data_ptr(), boost_idx, boost_amt,
        *(t.data_ptr() for t in args[2:]), sj, sf, cur, justified_idx,
        nb_pad, head_rounds(nb_pad),
        None if scratch is None else scratch.data_ptr(), out.data_ptr(),
        None if stats is None else stats.data_ptr(),
        _build.stream_ptr(parent)), "fc_head")
    _build.launches["fc_head"] += 1
    return out


def fc_barrier_probe(n: int, device) -> torch.Tensor:
    """A probe, on no path: n empty barrier phases of K23's block in one
    launch; the time over n is one dependent phase's floor.  Not counted
    in `launches`."""
    out = torch.empty((), dtype=torch.int32, device=device)
    _build.require_cuda("fc_barrier_probe", out)
    _build.check(_lib().fc_barrier_probe_launch(
        int(n), out.data_ptr(), _build.stream_ptr(out)), "fc_barrier_probe")
    return out


def _on_cpu(t) -> bool:
    return t.device.type == "cpu"


def fc_apply(*args):
    """K21 for CUDA tensors, its plain version for CPU tensors."""
    return (fc_apply_plain if _on_cpu(args[0]) else fc_apply_kernel)(*args)


def fc_refresh(lm_block, balance, nb_pad: int):
    """K22 for CUDA tensors, its plain version for CPU tensors."""
    fn = fc_refresh_plain if _on_cpu(lm_block) else fc_refresh_kernel
    return fn(lm_block, balance, nb_pad)


def fc_head(*args):
    """K23 for CUDA tensors, its plain version for CPU tensors."""
    return (fc_head_plain if _on_cpu(args[0]) else fc_head_kernel)(*args)
