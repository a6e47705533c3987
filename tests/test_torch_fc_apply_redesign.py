"""The schedule of the redesigned K21 (`fc_apply`) against the JAX package,
on the CPU, tolerance zero.

The kernel (`csrc/forkchoice.cu`) is one cooperative launch over the
batch's rows with one grid barrier, on a winner-key table that the
wrapper keeps per device (all -1 between launches):

- step 1, every row: best[v] = max(best[v], epoch * B + (B - 1 - row));
- the grid barrier;
- step 2, every row in whatever order the card runs them: the winner
  (epoch >= 0 and its key read back from best[v]) writes -1 back; a row
  is accepted when it won, its epoch is above the table's and the
  validator can update; an accepted row writes the table and moves its
  balance between the blocks' weights.

`_replay` runs that schedule on numpy, step 2's rows in a random order
(so that losers read the slot before and after the winner resets it),
over a sequence of batches (`synthetic.apply_batches`: repeated
validators, winners rejected as older or as equivocators, padded rows)
at B = 64 and 1024, and holds each batch's accept mask, the table and
the weights to JAX's `_apply_kernel` and the port's `fc_apply_plain`,
and the winner table to all -1 after every batch.  The kernel itself
is held against the plain version on the card
(`tests/test_torch_cuda.py`, `chip_smoke.py`); the source's launcher
signatures are held against `kernels.py` here."""

import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from consensus_specs_tpu.forkchoice import kernels as JK
from consensus_specs_tpu_torch.forkchoice import kernels as K
from consensus_specs_tpu_torch.forkchoice import synthetic as FS

SOURCE = Path(K.__file__).resolve().parents[1] / "csrc" / "forkchoice.cu"
TABLES = ("lm_epoch", "lm_block", "node_weight")


def _replay(batch, tab, best, rng):
    """K21's schedule on one batch: tab's tables updated in place, best
    the winner table; returns (accept, winners rejected as older, winners
    rejected by can_update)."""
    val_idx, att_epoch, att_block = batch
    b = val_idx.shape[0]
    nb_pad = tab["node_weight"].shape[0] - 1
    key = att_epoch * b + (b - 1 - np.arange(b, dtype=np.int64))
    np.maximum.at(best, val_idx, key)
    # -- the grid barrier --
    accept = np.zeros(b, dtype=bool)
    older = frozen = 0
    tab["node_weight"][nb_pad] = 0
    for i in rng.permutation(b):
        v, ep = val_idx[i], att_epoch[i]
        ok = ep >= 0 and best[v] == key[i]
        if ok:
            best[v] = -1
        if ok and ep <= tab["lm_epoch"][v]:
            older += 1
        elif ok and not tab["can_update"][v]:
            frozen += 1
        ok = ok and ep > tab["lm_epoch"][v] and tab["can_update"][v]
        accept[i] = ok
        if not ok:
            continue
        old, bal = tab["lm_block"][v], tab["balance"][v]
        tab["lm_epoch"][v] = ep
        tab["lm_block"][v] = att_block[i]
        if bal:
            if old >= 0:
                tab["node_weight"][old] -= bal
            tab["node_weight"][att_block[i]] += bal
    return accept, older, frozen


def _fold(nb_pad, v_pad, batch, n_batches):
    x, batches = FS.apply_batches(nb_pad, v_pad, batch, n_batches, seed=7)
    names = ("lm_epoch", "lm_block", "balance", "can_update", "node_weight")
    tab = {k: x[k].copy() for k in names}
    plain = {k: torch.from_numpy(x[k].copy()) for k in names}
    jax_tab = {k: x[k].copy() for k in TABLES}
    best = np.full(v_pad + 1, -1, dtype=np.int64)
    rng = np.random.RandomState(11)
    older = frozen = 0
    for val_idx, att_epoch, att_block in batches:
        acc, o, f = _replay((val_idx, att_epoch, att_block), tab, best, rng)
        older, frozen = older + o, frozen + f
        assert (best == -1).all()
        j_e, j_b, j_w, j_acc = JK._apply_kernel(batch, v_pad, nb_pad)(
            val_idx, att_epoch, att_block, jax_tab["lm_epoch"],
            jax_tab["lm_block"], x["balance"], x["can_update"],
            jax_tab["node_weight"])
        jax_tab = {"lm_epoch": np.asarray(j_e), "lm_block": np.asarray(j_b),
                   "node_weight": np.asarray(j_w)}
        p_acc = K.fc_apply_plain(
            torch.from_numpy(val_idx), torch.from_numpy(att_epoch),
            torch.from_numpy(att_block), plain["lm_epoch"],
            plain["lm_block"], plain["balance"], plain["can_update"],
            plain["node_weight"])
        np.testing.assert_array_equal(acc, np.asarray(j_acc))
        np.testing.assert_array_equal(acc, p_acc.numpy())
        # the dummy slots' contents are unspecified: compare the live rows
        for k, live in (("lm_epoch", v_pad), ("lm_block", v_pad),
                        ("node_weight", nb_pad)):
            np.testing.assert_array_equal(tab[k][:live], jax_tab[k][:live])
            np.testing.assert_array_equal(tab[k][:live],
                                          plain[k].numpy()[:live])
        assert tab["node_weight"][nb_pad] == jax_tab["node_weight"][nb_pad]
    return older, frozen


@pytest.mark.parametrize("shape", [(64, 256, 64), (1024, 4096, 1024)],
                         ids=["B64", "B1024"])
def test_one_launch_schedule_matches_jax(shape):
    nb_pad, v_pad, batch = shape
    older, frozen = _fold(nb_pad, v_pad, batch, 8)
    # the batches reach both rejections of a winner
    assert older > 0 and frozen > 0


def test_batches_reach_the_cases():
    x, batches = FS.apply_batches(64, 256, 64, 3, seed=7)
    for val_idx, att_epoch, _ in batches:
        live = att_epoch >= 0
        assert (~live).sum() == 64 // 8
        assert (val_idx[~live] == 256).all()
        assert np.unique(val_idx[live]).size < live.sum()   # repeats
        assert (~x["can_update"][val_idx[live]]).any()      # equivocators


def test_padded_rows_leave_the_table_at_minus_one():
    """A padded row's key is negative (-1 at row 0), so step 1 leaves its
    slot at -1, and the epoch test rejects it before it reads."""
    b = 64
    best = np.full(257, -1, dtype=np.int64)
    val_idx = np.full(b, 256, dtype=np.int32)
    att_epoch = np.full(b, -1, dtype=np.int64)
    tab = {"lm_epoch": np.full(257, -1, dtype=np.int64),
           "lm_block": np.full(257, -1, dtype=np.int32),
           "balance": np.zeros(257, dtype=np.int64),
           "can_update": np.ones(257, dtype=bool),
           "node_weight": np.zeros(65, dtype=np.int64)}
    acc, _, _ = _replay((val_idx, att_epoch, np.full(b, 64, np.int32)), tab,
                        best, np.random.RandomState(0))
    assert not acc.any() and (best == -1).all()


def _launcher_params(text: str, name: str) -> int:
    m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", text)
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
    for name in ("fc_apply_launch", "fc_grid_barrier_probe_launch",
                 "fc_refresh_launch", "fc_head_launch",
                 "fc_barrier_probe_launch"):
        assert len(fake.fns[name].argtypes) == _launcher_params(text, name)
    assert "cudaLaunchCooperativeKernel" in text


def test_winner_table_is_kept_per_device_and_size(monkeypatch):
    """The wrapper's table: filled with -1 once per (device, stream, V +
    1) and handed back on later calls (on the CPU with the stream
    stubbed)."""
    monkeypatch.setattr(K, "_WINNER_TABLES", {})
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=1))
    t = K.winner_table("cpu", 9)
    assert t.dtype == torch.int64 and (t == -1).all() and t.shape == (9,)
    assert K.winner_table("cpu", 9) is t
    assert K.winner_table("cpu", 17) is not t
