"""The proto-array fork-choice store: flat device tensors and a numpy host
mirror (counterpart of `consensus_specs_tpu.forkchoice.store`).

``ProtoArrayStore`` keeps the LMD-GHOST state a client updates per
attestation, laid out as the Lighthouse proto-array:

per-block arrays, in insertion order (a parent's index is below its
children's, which the head kernel's pointer jumping relies on): parent
index, slot, block epoch, justified epoch (the block state's),
unrealized justified epoch, the 8 big-endian root words (the tie-break
key) and the host-kept finalized-descent flag;

per-validator arrays: the latest-message table (target epoch, vote block
index), the weight-eligible balances and the can-update mask
(equivocators freeze);

and the per-block vote weights that the apply fold keeps.

Two routes, one state:

device  ``apply_attestations`` and ``get_head`` run K21 and K23
        (`forkchoice.kernels`) on the store's device, K22 on every
        rebuild of the device arrays; on a CPU device they run the plain
        versions.
host    ``apply_attestations_host`` folds into the host mirror only;
        ``get_head_host(spec)`` runs the phase0 spec's ``get_head`` over a
        Store synthesized from the mirror (`forkchoice.oracle`).

The host mirror plus the queue of pending batches always equals the
device arrays (``_fold_host`` is the kernel rule in numpy), so the store
rebuilds its device state from the mirror whenever it is stale: after a
rung regrowth, a validator rebind or a host apply.

This store is synchronous.  The JAX store's async facades
(``apply_attestations_async``, ``get_head_async`` and their
``DeviceFuture``s), its telemetry spans, fault-injection points and
cost-model captures are left for the port's service slice.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import resolve_device
from .kernels import (FC_BATCH_STEPS, FC_BLOCK_STEPS, FC_VALIDATOR_STEPS,
                      fc_apply, fc_apply_plain, fc_head, fc_head_plain,
                      fc_refresh, fc_refresh_plain, fc_rung)


def _root_limbs(root: bytes) -> np.ndarray:
    """32-byte root -> 8 big-endian u32 words (a compare over the words is
    the bytes compare over the root)."""
    return np.frombuffer(root, dtype=">u4").astype(np.uint32)


class ProtoArrayStore:
    """See the module docstring.  ``preset`` names the spec namespace of
    the host oracle route; ``device`` is where the device arrays live
    (CUDA unless asked), and ``plain=True`` runs the kernels' plain
    versions there instead of K21-K23."""

    def __init__(self, anchor_root: bytes, anchor_slot: int = 0, *,
                 justified_epoch: int = 0, finalized_epoch: int = 0,
                 slots_per_epoch: int = 32, proposer_boost_pct: int = 40,
                 effective_balance_increment: int = 10 ** 9,
                 preset: str = "mainnet", device="cuda", plain: bool = False):
        anchor_root = bytes(anchor_root)
        assert len(anchor_root) == 32
        self.device = resolve_device(device)
        self.plain = bool(plain)
        self.slots_per_epoch = int(slots_per_epoch)
        self.proposer_boost_pct = int(proposer_boost_pct)
        self.effective_balance_increment = int(effective_balance_increment)
        self.preset = preset

        # per-block host state
        self.roots: list[bytes] = [anchor_root]
        self.root_index: dict[bytes, int] = {anchor_root: 0}
        self.parent: list[int] = [-1]
        self.slots: list[int] = [int(anchor_slot)]
        self.je: list[int] = [int(justified_epoch)]
        self.uje: list[int] = [int(justified_epoch)]

        # checkpoints and clock
        self.justified_epoch = int(justified_epoch)
        self.justified_root = anchor_root
        self.finalized_epoch = int(finalized_epoch)
        self.finalized_root = anchor_root
        self.current_epoch = int(anchor_slot) // self.slots_per_epoch
        self.proposer_boost_root: bytes | None = None

        # per-validator host state (empty until set_validators)
        self._eb = np.zeros(0, dtype=np.int64)
        self._active = np.zeros(0, dtype=bool)
        self._slashed = np.zeros(0, dtype=bool)
        self._equiv = np.zeros(0, dtype=bool)
        self._lm_epoch = np.zeros(0, dtype=np.int64)
        self._lm_block = np.zeros(0, dtype=np.int32)

        # batches applied on the device, not yet folded into the mirror
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []

        self._fin_ok = [True]
        self._recompute_finalized_ok()

        self._dev = None        # validator and weight tensors (None: stale)
        self._blk_dev = None    # per-block tensors

    # --- host-side structure ------------------------------------------------

    @property
    def n_blocks(self) -> int:
        return len(self.roots)

    @property
    def n_validators(self) -> int:
        return int(self._eb.shape[0])

    def add_block(self, root: bytes, parent_root: bytes, slot: int,
                  justified_epoch: int,
                  unrealized_justified_epoch: int | None = None) -> int:
        """Append one block after its parent (the on_block order); returns
        its index."""
        root = bytes(root)
        parent_root = bytes(parent_root)
        assert root not in self.root_index, "duplicate block root"
        pidx = self.root_index[parent_root]
        slot = int(slot)
        assert slot > self.slots[pidx], "child slot must exceed its parent's"
        idx = len(self.roots)
        old_rung = fc_rung(idx, FC_BLOCK_STEPS)
        self.roots.append(root)
        self.root_index[root] = idx
        self.parent.append(pidx)
        self.slots.append(slot)
        self.je.append(int(justified_epoch))
        self.uje.append(int(justified_epoch
                            if unrealized_justified_epoch is None
                            else unrealized_justified_epoch))
        self._fin_ok.append(self._fin_ok_for(idx))
        self._blk_dev = None
        if fc_rung(idx + 1, FC_BLOCK_STEPS) != old_rung:
            self._dev = None    # the weights re-pad: rebuild from the mirror
        return idx

    def set_validators(self, effective_balances, active=None, slashed=None,
                       equivocating=None) -> None:
        """(Re)bind the validator set: effective balances in Gwei and the
        active, slashed and equivocating masks.  Latest messages survive
        up to min(old, new) validators."""
        eb = np.asarray(effective_balances, dtype=np.int64)
        n = int(eb.shape[0])

        def mask(m, default):
            if m is None:
                return np.full(n, default, dtype=bool)
            m = np.asarray(m, dtype=bool)
            assert m.shape == (n,)
            return m.copy()

        self._sync_pending()
        keep = min(n, self.n_validators)
        lm_e = np.full(n, -1, dtype=np.int64)
        lm_b = np.full(n, -1, dtype=np.int32)
        lm_e[:keep] = self._lm_epoch[:keep]
        lm_b[:keep] = self._lm_block[:keep]
        self._eb = eb.copy()
        self._active = mask(active, True)
        self._slashed = mask(slashed, False)
        self._equiv = mask(equivocating, False)
        self._lm_epoch = lm_e
        self._lm_block = lm_b
        self._dev = None

    def mark_equivocators(self, indices) -> None:
        """Freeze the given validators' latest messages and remove their
        weight (on_attester_slashing)."""
        self._sync_pending()
        idx = np.asarray(list(indices), dtype=np.int64)
        if idx.size:
            self._equiv[idx] = True
            self._dev = None

    def set_checkpoints(self, justified_epoch: int, justified_root: bytes,
                        finalized_epoch: int, finalized_root: bytes) -> None:
        self.justified_epoch = int(justified_epoch)
        self.justified_root = bytes(justified_root)
        self.finalized_epoch = int(finalized_epoch)
        self.finalized_root = bytes(finalized_root)
        self._recompute_finalized_ok()
        self._blk_dev = None

    def set_current_epoch(self, epoch: int) -> None:
        self.current_epoch = int(epoch)

    def set_proposer_boost(self, root: bytes | None) -> None:
        self.proposer_boost_root = bytes(root) if root else None

    def proposer_score(self) -> int:
        """The spec's get_proposer_score: (total active balance, floored at
        EFFECTIVE_BALANCE_INCREMENT, / SLOTS_PER_EPOCH) * boost% / 100."""
        total = int(self._eb[self._active].sum())
        total = max(self.effective_balance_increment, total)
        return (total // self.slots_per_epoch
                * self.proposer_boost_pct) // 100

    # --- finalized descent ------------------------------------------------------

    def _fin_ok_for(self, idx: int) -> bool:
        """get_checkpoint_block(root, finalized_epoch) == finalized_root:
        the ancestor at the finalized boundary slot is the finalized
        block."""
        fin_idx = self.root_index.get(self.finalized_root)
        if fin_idx is None:
            return False
        fin_slot = self.finalized_epoch * self.slots_per_epoch
        j = idx
        while self.slots[j] > fin_slot:
            j = self.parent[j]
            if j < 0:
                return False
        return j == fin_idx

    def _recompute_finalized_ok(self) -> None:
        fin_idx = self.root_index.get(self.finalized_root)
        fin_slot = self.finalized_epoch * self.slots_per_epoch
        out = [False] * len(self.roots)
        anc = [0] * len(self.roots)
        for i in range(len(self.roots)):
            if self.slots[i] <= fin_slot or self.parent[i] < 0:
                anc[i] = i
            else:
                anc[i] = anc[self.parent[i]]
            out[i] = fin_idx is not None and anc[i] == fin_idx
        self._fin_ok = out

    # --- the host mirror (the kernel rule in numpy) -------------------------

    def _weight_balance(self) -> np.ndarray:
        """Weight-eligible balance: active, unslashed, not equivocating."""
        return np.where(self._active & ~self._slashed & ~self._equiv,
                        self._eb, 0).astype(np.int64)

    def _fold_host(self, idx: np.ndarray, ep: np.ndarray,
                   blk: np.ndarray) -> int:
        """Fold one batch into the mirror by K21's rule; returns the
        accepted count."""
        b = int(idx.shape[0])
        if b == 0:
            return 0
        pos = np.arange(b, dtype=np.int64)
        key = ep * b + (b - 1 - pos)
        best = np.full(self.n_validators, -1, dtype=np.int64)
        np.maximum.at(best, idx, key)
        accept = ((best[idx] == key) & (ep > self._lm_epoch[idx])
                  & ~self._equiv[idx])
        self._lm_epoch[idx[accept]] = ep[accept]
        self._lm_block[idx[accept]] = blk[accept]
        return int(np.count_nonzero(accept))

    def _sync_pending(self) -> None:
        pending, self._pending = self._pending, []
        for idx, ep, blk in pending:
            self._fold_host(idx, ep, blk)

    def node_weights_host(self) -> np.ndarray:
        """Per-block vote weights recomputed from the mirror (K22's rule)."""
        self._sync_pending()
        w = np.zeros(self.n_blocks, dtype=np.int64)
        has = self._lm_block >= 0
        np.add.at(w, self._lm_block[has], self._weight_balance()[has])
        return w

    def node_weights_device(self) -> np.ndarray:
        """The live part of the device weight array, on the host."""
        self._ensure_device()
        return self._dev["weight"][: self.n_blocks].cpu().numpy()

    def fingerprint(self) -> bytes:
        """Digest of the whole host state, byte for byte the JAX store's
        (`consensus_specs_tpu/forkchoice/store.py` ``fingerprint``), so
        equal digests mean equal stores across the two packages."""
        self._sync_pending()
        h = hashlib.sha256()
        h.update(b"".join(self.roots))
        h.update(np.asarray(self.parent, dtype=np.int64).tobytes())
        h.update(np.asarray(self.slots, dtype=np.int64).tobytes())
        h.update(np.asarray(self.je, dtype=np.int64).tobytes())
        h.update(np.asarray(self.uje, dtype=np.int64).tobytes())
        h.update(np.asarray(self._fin_ok, dtype=bool).tobytes())
        for arr in (self._eb, self._active, self._slashed, self._equiv,
                    self._lm_epoch, self._lm_block):
            h.update(arr.tobytes())
        h.update(repr((self.justified_epoch, self.justified_root,
                       self.finalized_epoch, self.finalized_root,
                       self.current_epoch, self.proposer_boost_root,
                       self.slots_per_epoch, self.proposer_boost_pct,
                       self.effective_balance_increment,
                       self.preset)).encode())
        return h.digest()

    # --- device state ------------------------------------------------------------

    def _v_pad(self) -> int:
        return fc_rung(self.n_validators, FC_VALIDATOR_STEPS)

    def _nb_pad(self) -> int:
        return fc_rung(self.n_blocks, FC_BLOCK_STEPS)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _ensure_device(self) -> None:
        """(Re)build the validator and weight tensors from the mirror when
        stale; the weights come from K22."""
        if self._dev is not None:
            return
        self._sync_pending()
        v_pad, nb_pad = self._v_pad(), self._nb_pad()
        n = self.n_validators
        lm_e = np.full(v_pad + 1, -1, dtype=np.int64)
        lm_b = np.full(v_pad + 1, -1, dtype=np.int32)
        bal = np.zeros(v_pad + 1, dtype=np.int64)
        can = np.zeros(v_pad + 1, dtype=bool)
        lm_e[:n] = self._lm_epoch
        lm_b[:n] = self._lm_block
        bal[:n] = self._weight_balance()
        can[:n] = ~self._equiv
        d_lm_b, d_bal = self._tensor(lm_b), self._tensor(bal)
        refresh = fc_refresh_plain if self.plain else fc_refresh
        self._dev = {
            "lm_epoch": self._tensor(lm_e), "lm_block": d_lm_b,
            "balance": d_bal, "can_update": self._tensor(can),
            "weight": refresh(d_lm_b, d_bal, nb_pad),
            "v_pad": v_pad, "nb_pad": nb_pad,
        }

    def _ensure_block_device(self) -> None:
        if self._blk_dev is not None \
                and self._blk_dev["nb_pad"] == self._nb_pad():
            return
        nb_pad = self._nb_pad()
        n = self.n_blocks
        parent = np.full(nb_pad + 1, nb_pad, dtype=np.int32)
        par = np.asarray(self.parent, dtype=np.int32)
        parent[:n] = np.where(par >= 0, par, nb_pad)
        real = np.zeros(nb_pad + 1, dtype=bool)
        real[:n] = True
        bep = np.zeros(nb_pad + 1, dtype=np.int64)
        bep[:n] = np.asarray(self.slots, dtype=np.int64) // self.slots_per_epoch
        je = np.zeros(nb_pad + 1, dtype=np.int64)
        je[:n] = self.je
        uje = np.zeros(nb_pad + 1, dtype=np.int64)
        uje[:n] = self.uje
        fin = np.zeros(nb_pad + 1, dtype=bool)
        fin[:n] = self._fin_ok
        # int64 zero-extended from the u32 words (the tie-break's order)
        limbs = np.zeros((nb_pad + 1, 8), dtype=np.int64)
        limbs[:n] = np.stack([_root_limbs(r) for r in self.roots])
        self._blk_dev = {
            "parent": self._tensor(parent), "real": self._tensor(real),
            "block_epoch": self._tensor(bep), "je": self._tensor(je),
            "uje": self._tensor(uje), "fin_ok": self._tensor(fin),
            "limbs": self._tensor(limbs), "nb_pad": nb_pad,
        }

    # --- the device route ------------------------------------------------------------

    def _parse_batch(self, validator_indices, target_epochs, block_roots):
        """(idx int32, ep int64, blk int32) of one batch; unknown roots and
        out-of-range validators raise."""
        idx = np.asarray(list(validator_indices), dtype=np.int32)
        ep = np.asarray(list(target_epochs), dtype=np.int64)
        assert idx.shape == ep.shape and idx.ndim == 1
        assert idx.size == len(block_roots)
        if idx.size and (idx.min() < 0 or idx.max() >= self.n_validators):
            raise KeyError("attesting validator index out of range")
        assert not idx.size or ep.min() >= 0, "negative target epoch"
        blk = np.asarray([self.root_index[bytes(r)] for r in block_roots],
                         dtype=np.int32)
        return idx, ep, blk

    def apply_attestations(self, validator_indices, target_epochs,
                           block_roots) -> int:
        """One batch of latest-message updates and weight deltas on the
        device (K21); returns the number of accepted updates."""
        idx, ep, blk = self._parse_batch(validator_indices, target_epochs,
                                         block_roots)
        self._ensure_device()
        b_live = int(idx.size)
        rung = fc_rung(b_live, FC_BATCH_STEPS)
        v_pad, nb_pad = self._dev["v_pad"], self._dev["nb_pad"]
        pad = rung - b_live
        d_idx = self._tensor(np.concatenate(
            [idx, np.full(pad, v_pad, dtype=np.int32)]))
        d_ep = self._tensor(np.concatenate(
            [ep, np.full(pad, -1, dtype=np.int64)]))
        d_blk = self._tensor(np.concatenate(
            [blk, np.full(pad, nb_pad, dtype=np.int32)]))
        d = self._dev
        accept = (fc_apply_plain if self.plain else fc_apply)(
            d_idx, d_ep, d_blk, d["lm_epoch"], d["lm_block"], d["balance"],
            d["can_update"], d["weight"])
        # the mirror catches up lazily through the pending queue
        self._pending.append((idx, ep, blk))
        return int(accept[:b_live].sum())

    def get_head(self) -> bytes:
        """The LMD-GHOST head over the viable tree (K23); its root."""
        if self.justified_root not in self.root_index:
            raise KeyError("justified root not in the store")
        self._ensure_block_device()
        nb_pad = self._blk_dev["nb_pad"]
        if self._dev is not None and self._dev["nb_pad"] != nb_pad:
            self._dev = None
        self._ensure_device()
        boost_idx, boost_amt = nb_pad, 0
        if self.proposer_boost_root is not None \
                and self.proposer_boost_root in self.root_index:
            boost_idx = self.root_index[self.proposer_boost_root]
            boost_amt = self.proposer_score()
        bd = self._blk_dev
        head = (fc_head_plain if self.plain else fc_head)(
            bd["parent"], self._dev["weight"], boost_idx, boost_amt,
            bd["real"], bd["block_epoch"], bd["je"], bd["uje"], bd["fin_ok"],
            bd["limbs"], self.justified_epoch, self.finalized_epoch,
            self.current_epoch, self.root_index[self.justified_root])
        return self.roots[int(head)]

    # --- the host (spec-oracle) route ----------------------------------------------

    def apply_attestations_host(self, validator_indices, target_epochs,
                                block_roots) -> int:
        """Fold a batch into the host mirror only (K21's rule) and mark the
        device arrays stale, so the next device call rebuilds them."""
        idx, ep, blk = self._parse_batch(validator_indices, target_epochs,
                                         block_roots)
        self._sync_pending()
        accepted = self._fold_host(idx, ep, blk)
        self._dev = None
        return accepted

    def get_head_host(self, spec) -> bytes:
        """The head by the phase0 spec's ``get_head`` over a Store
        synthesized from the mirror; ``spec`` is a built phase0 spec of
        the store's preset (`forkchoice.oracle`)."""
        from . import oracle

        return oracle.spec_get_head(self, spec)
