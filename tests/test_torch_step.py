"""The port's whole epoch step against the JAX sweep and both roots at the
full SSZ limit depths, on a 2**10 synthetic registry; the device rules of
its entry points; the package's import hygiene; and `chip_smoke.py`'s
refusal to run without a card."""

import importlib
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from consensus_specs_tpu.models.builder import build_spec
from consensus_specs_tpu.parallel import (EpochParams, EpochScalars,
                                          balances_list_root, epoch_sweep)
from consensus_specs_tpu.parallel import merkle as JM
from consensus_specs_tpu.utils import jaxtools
import consensus_specs_tpu_torch as T
from consensus_specs_tpu_torch import _build
from consensus_specs_tpu_torch import convert as C
from consensus_specs_tpu_torch.parallel import merkle as M

REPO = Path(__file__).resolve().parents[1]
N = 2**10


@pytest.fixture(scope="module")
def case():
    """The flagship entry's inputs at 2**10 and the JAX step's outputs:
    sweep, balances root, record roots and registry root."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jaxtools, "enable_compile_cache", lambda *a, **k: None)
    try:
        graft = importlib.import_module("__graft_entry__")
    finally:
        mp.undo()
    params = EpochParams.from_spec(build_spec("phase0", "mainnet"))
    reg = graft._synthetic_registry(N)
    sc = EpochScalars(current_epoch=np.uint64(100),
                      finality_delay=np.uint64(2),
                      slashings_sum=np.uint64(32_000_000_000))
    length = N - 24                        # pad rows in both lists
    pk, cred = C.synthetic_leaf_words(N)

    @jax.jit
    def jax_step(reg, sc, length, pk, cred):
        new_bal, new_eff = epoch_sweep(reg, sc, params)
        bal_root = balances_list_root(new_bal, length)
        rec = JM.validator_records_root(
            JM.ValidatorLeaves(pk, cred), new_eff, reg.slashed,
            reg.activation_eligibility_epoch, reg.activation_epoch,
            reg.exit_epoch, reg.withdrawable_epoch)
        return (new_bal, new_eff, bal_root,
                JM.validator_registry_root(rec, length), rec)

    want = [np.asarray(x) for x in jax_step(reg, sc, np.uint64(length),
                                            pk, cred)]
    ported = (C.registry_to_torch(reg, "cpu"), C.scalars_to_torch(sc),
              length, C.leaves_to_torch(pk, cred, "cpu"))
    return params, ported, want


def test_epoch_step_matches_jax(case):
    params, (reg, sc, length, leaves), want = case
    step = T.make_epoch_step(T.params_from_jax(params._asdict()),
                             device="cpu")
    new_bal, new_eff, bal_root, reg_root = step(reg, sc, length, leaves)
    np.testing.assert_array_equal(C.u64_to_numpy(new_bal), want[0])
    np.testing.assert_array_equal(C.u64_to_numpy(new_eff), want[1])
    np.testing.assert_array_equal(C.words_to_numpy(bal_root), want[2])
    np.testing.assert_array_equal(C.words_to_numpy(reg_root), want[3])


def test_step_modules_match_jax_at_full_depth(case):
    """Each module of the step on the JAX step's own intermediates."""
    _, (reg, sc, length, leaves), want = case
    new_bal = C.from_numpy_u64(want[0], "cpu")
    new_eff = C.from_numpy_u64(want[1], "cpu")
    np.testing.assert_array_equal(
        C.words_to_numpy(M.balances_list_root(new_bal, length)), want[2])
    rec = M.validator_records_root(
        leaves, new_eff, reg.slashed, reg.activation_eligibility_epoch,
        reg.activation_epoch, reg.exit_epoch, reg.withdrawable_epoch)
    np.testing.assert_array_equal(C.words_to_numpy(rec), want[4])
    np.testing.assert_array_equal(
        C.words_to_numpy(M.validator_registry_root(rec, length)), want[3])


def test_plain_step_equals_default_step_on_cpu(case):
    params, (reg, sc, length, leaves), _ = case
    p = T.params_from_jax(params._asdict())
    before = dict(_build.launches)
    a = T.make_epoch_step(p, device="cpu")(reg, sc, length, leaves)
    b = T.make_epoch_step(p, device="cpu", plain=True)(reg, sc, length,
                                                       leaves)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert _build.launches == before       # the CPU launches no kernel


def test_default_device_is_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_epoch_step(T.MAINNET)
    with pytest.raises(RuntimeError, match="CUDA"):
        C.registry_to_torch(C.synthetic_registry(8))
    with pytest.raises(RuntimeError, match="CUDA"):
        T.resolve_device()


def test_step_refuses_tensors_on_another_device(case):
    params, (reg, sc, length, leaves), _ = case
    step = T.make_epoch_step(T.MAINNET, device="cpu")
    meta = reg._replace(balance=torch.empty(N, dtype=torch.int64,
                                            device="meta"))
    with pytest.raises(ValueError, match="meta"):
        step(meta, sc, length, leaves)


def test_convert_round_trips():
    reg = C.synthetic_registry(64, seed=3)
    t = C.registry_to_torch(reg, "cpu")
    assert t.balance.dtype == torch.int64 and t.slashed.dtype == torch.bool
    assert t.proposer_index.dtype == torch.int32
    for f in ("balance", "exit_epoch", "inclusion_delay"):
        assert (C.u64_to_numpy(getattr(t, f)) == reg[f]).all()
    pk, cred = C.synthetic_leaf_words(64)
    leaves = C.leaves_to_torch(pk, cred, "cpu")
    assert (C.words_to_numpy(leaves.credentials) == cred).all()
    sc = C.scalars_to_torch((np.uint64(2**64 - 1), np.uint64(0), 7))
    assert sc == (2**64 - 1, 0, 7)


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+consensus_specs_tpu\b(?!_)"
    r"|from\s+consensus_specs_tpu\b(?!_))", re.M)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "consensus_specs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 9
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(REPO)} imports {hits}"


def test_port_modules_import_without_jax():
    """Importing the port loads no module of JAX or of the JAX package
    (counted against what the interpreter had loaded before)."""
    code = ("import sys; before = set(sys.modules); "
            "import consensus_specs_tpu_torch, "
            "consensus_specs_tpu_torch.convert, "
            "consensus_specs_tpu_torch.parallel.incremental, "
            "consensus_specs_tpu_torch.ops.bls, "
            "consensus_specs_tpu_torch.ops.bls_batch, "
            "consensus_specs_tpu_torch.ops.fr_batch, "
            "consensus_specs_tpu_torch.models.deneb.polynomial_commitments, "
            "consensus_specs_tpu_torch.das; "
            "bad = [m for m in set(sys.modules) - before if m == 'jax' "
            "or m.startswith('jax.') or m == 'consensus_specs_tpu' "
            "or m.startswith('consensus_specs_tpu.')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
