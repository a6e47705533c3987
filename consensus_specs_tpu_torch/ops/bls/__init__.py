"""BLS facade of the port (counterpart of `consensus_specs_tpu.ops.bls`).

A module-global backend, the `bls_active` kill-switch returning stub
values, the scheme functions, and the deferred batch that the block path
records its FastAggregateVerify statements into.

Backends:
- "torch" (the default): the card.  `DeferredBatch.verify` settles
           every recorded statement in one RLC batch through
           `ops.bls_batch.batch_verify` (K8 -> K9 -> K10).  The eager
           `Verify`, `AggregateVerify`, `FastAggregateVerify` and
           `pairing_check` need the precomputed-line pairing check, which
           is not ported yet: under "torch" they raise
           `NotImplementedError` (slice 4) and do not fall back to the
           host oracle.
- "py":    the port's own pure-Python oracle (`fields`, `curve`,
           `pairing`, `hash_to_curve`, `ciphersuite` here), chosen only
           with `use_backend("py")`.

Accept/reject semantics are the oracle's: the same host-side parsing and
subgroup checks, and the same product-of-pairings predicate.
"""

from __future__ import annotations

from . import ciphersuite as _py

bls_active = True
_backend_name = "torch"

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48
G1_POINT_AT_INFINITY = _py.G1_POINT_AT_INFINITY
G2_POINT_AT_INFINITY = _py.G2_POINT_AT_INFINITY

_SLICE_4 = ("the eager pairing check on the card is not ported yet (it "
            "comes with slice 4 of the port); record the statement in a "
            "deferred batch, or use the 'py' backend")


def use_backend(name: str) -> None:
    global _backend_name
    assert name in ("py", "torch"), name
    _backend_name = name


def backend_name() -> str:
    return _backend_name


def _eager(fn, *args):
    if _backend_name == "torch":
        raise NotImplementedError(f"{fn.__name__}: {_SLICE_4}")
    return fn(*args)


# --- scheme functions, honoring the kill-switch -----------------------------


def Sign(privkey, message):
    if not bls_active:
        return STUB_SIGNATURE
    return _py.Sign(int(privkey), bytes(message))


def Verify(pubkey, message, signature):
    if not bls_active:
        return True
    return _eager(_py.Verify, bytes(pubkey), bytes(message),
                  bytes(signature))


def Aggregate(signatures):
    if not bls_active:
        return STUB_SIGNATURE
    return _py.Aggregate([bytes(s) for s in signatures])


def AggregateVerify(pubkeys, messages, signature):
    if not bls_active:
        return True
    return _eager(_py.AggregateVerify, [bytes(p) for p in pubkeys],
                  [bytes(m) for m in messages], bytes(signature))


def FastAggregateVerify(pubkeys, message, signature):
    if not bls_active:
        return True
    if _deferred is not None:
        return _deferred.record([bytes(p) for p in pubkeys],
                                bytes(message), bytes(signature))
    return _eager(_py.FastAggregateVerify, [bytes(p) for p in pubkeys],
                  bytes(message), bytes(signature))


def AggregatePKs(pubkeys):
    if not bls_active:
        return STUB_PUBKEY
    return _py.AggregatePKs([bytes(p) for p in pubkeys])


def SkToPk(privkey):
    if not bls_active:
        return STUB_PUBKEY
    return _py.SkToPk(int(privkey))


def KeyValidate(pubkey):
    if not bls_active:
        return True
    return _py.KeyValidate(bytes(pubkey))


def pairing_check(values):
    if not bls_active:
        return True
    return _eager(_py.pairing_check, values)


# --- deferred batch verification --------------------------------------------


class Handle:
    """The settled-or-pending verdict of one recorded statement: settled
    when its batch settles (`result()` settles the batch first if
    needed)."""

    def __init__(self, waiter=None):
        self._waiter = waiter
        self._done = False
        self._value = None
        self._exc: BaseException | None = None

    @classmethod
    def settled(cls, value) -> "Handle":
        h = cls()
        h.set_result(value)
        return h

    def set_result(self, value) -> None:
        self._done, self._value = True, value

    def set_exception(self, exc: BaseException) -> None:
        self._done, self._exc = True, exc

    def done(self) -> bool:
        return self._done

    def result(self):
        if not self._done and self._waiter is not None:
            self._waiter(self)
        if not self._done:
            raise RuntimeError("handle not settled")
        if self._exc is not None:
            raise self._exc
        return self._value


class DeferredBatch:
    """Recorded FastAggregateVerify statements awaiting one batch check.

    Every `record()` validates its inputs eagerly and appends a `Handle`
    to `self.handles`, settled with the batch verdict (or its exception)
    when the batch settles.  Settlement is once-only: `verify()` caches
    its outcome, and recording after it is a `RuntimeError`."""

    def __init__(self):
        self.tasks = []      # (g1_pk_jacobian, message, g2_sig_jacobian)
        self.failed = False  # an input failed eager validation
        self.handles = []    # one Handle per record() call
        self._pending = []   # handles awaiting the batch verdict
        self._settled = False
        self._result: bool | None = None
        self._exc: BaseException | None = None

    def record(self, pubkeys, message, signature) -> bool:
        if self._settled:
            raise RuntimeError(
                "deferred batch already settled — record() after "
                "verify() would never be checked")
        task = _py.parse_fast_aggregate_task(pubkeys, message, signature)
        if task is None:
            self.failed = True
            self.handles.append(Handle.settled(False))
            return False
        self.tasks.append(task)
        handle = Handle(waiter=lambda h: self.verify())
        self.handles.append(handle)
        self._pending.append(handle)
        return True

    def _settle_handles(self, ok, exc: BaseException | None = None) -> None:
        pending, self._pending = self._pending, []
        for handle in pending:
            if exc is not None:
                handle.set_exception(exc)
            else:
                handle.set_result(bool(ok))

    def verify(self, device=None, rng=None) -> bool:
        """Settle every recorded statement.  `device` None follows the
        backend ("torch": one RLC batch on CUDA through
        `ops.bls_batch.batch_verify`; "py": the host oracle per
        statement); True is CUDA, False the host oracle, and a torch
        device or its name runs the RLC batch there.  The first call
        settles and caches; later calls replay the verdict or re-raise
        the exception."""
        if self._settled:
            if self._exc is not None:
                raise self._exc
            return self._result
        self._settled = True
        if self.failed:
            self._result = False
            self._settle_handles(False)
            return False
        if not self.tasks:
            self._result = True
            return True
        if device is None:
            device = _backend_name == "torch"
        try:
            if device is False:
                ok = all(_py._pairing_check(_py.fast_aggregate_pairs(t))
                         for t in self.tasks)
            else:
                from ..bls_batch import batch_verify

                ok = batch_verify(self.tasks, rng=rng,
                                  device="cuda" if device is True else device)
        except BaseException as exc:
            self._exc = exc
            self._settle_handles(None, exc)
            raise
        self._result = ok
        self._settle_handles(ok)
        return ok


_deferred: DeferredBatch | None = None


class deferred_batch_verification:
    """Context manager handing out the recording handle."""

    def __enter__(self) -> DeferredBatch:
        global _deferred
        assert _deferred is None, "deferred batch already active"
        _deferred = DeferredBatch()
        return _deferred

    def __exit__(self, *exc) -> None:
        global _deferred
        _deferred = None
