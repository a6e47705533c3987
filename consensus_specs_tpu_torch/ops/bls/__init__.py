"""BLS facade of the port (counterpart of `consensus_specs_tpu.ops.bls`).

A module-global backend, the `bls_active` kill-switch returning stub
values, the scheme functions, the deferred batch that the block path
records its FastAggregateVerify statements into, and the point API.

Backends:
- "torch" (the default): the card.  `Verify`, `AggregateVerify`,
           `FastAggregateVerify` and `pairing_check` parse on the host and
           check their pairings with `ops.bls_batch.pairing_check_device`
           (K12 -> K10); `DeferredBatch.verify` settles every recorded
           statement in one RLC batch through `ops.bls_batch.batch_verify`
           (K11 -> K8 -> K9 -> K10); `multi_exp` sends G1 batches of
           `_MSM_DEVICE_MIN` or more points to
           `ops.bls_batch.g1_multi_exp_device` (K13 or K14), all on
           `_device`, CUDA.
- "py":    the port's own pure-Python oracle (`fields`, `curve`,
           `pairing`, `hash_to_curve`, `ciphersuite` here), chosen only
           with `use_backend("py")`.

Accept/reject semantics are the oracle's: the same host-side parsing and
subgroup checks, and the same product-of-pairings predicate.
"""

from __future__ import annotations

from . import ciphersuite as _py
from . import curve as _curve
from . import hash_to_curve as _h2c
from .fields import R as _R

bls_active = True
_backend_name = "torch"
_device = "cuda"   # where the "torch" routes run

STUB_SIGNATURE = b"\x11" * 96
STUB_PUBKEY = b"\x22" * 48
G1_POINT_AT_INFINITY = _py.G1_POINT_AT_INFINITY
G2_POINT_AT_INFINITY = _py.G2_POINT_AT_INFINITY


def use_backend(name: str) -> None:
    global _backend_name
    assert name in ("py", "torch"), name
    _backend_name = name


def backend_name() -> str:
    return _backend_name


# --- the eager checks on the device (JAX `ops/bls/__init__.py:38-81`) --------


def _device_pairing_check(pairs) -> bool:
    from ..bls_batch import pairing_check_device

    return pairing_check_device(pairs, device=_device)


def _verify_torch(pubkey, message, signature):
    try:
        pk = _py._pk_to_point(pubkey)
        sig = _py._sig_to_point(signature)
    except ValueError:
        return False
    h = _h2c.hash_to_g2(message, _h2c.DST_G2)
    return _device_pairing_check(
        [(pk, h), (_curve.g1.neg(_curve.G1_GEN), sig)])


def _aggregate_verify_torch(pubkeys, messages, signature):
    if len(pubkeys) == 0 or len(pubkeys) != len(messages):
        return False
    try:
        sig = _py._sig_to_point(signature)
        pks = [_py._pk_to_point(pk) for pk in pubkeys]
    except ValueError:
        return False
    pairs = [(pk, _h2c.hash_to_g2(msg, _h2c.DST_G2))
             for pk, msg in zip(pks, messages)]
    pairs.append((_curve.g1.neg(_curve.G1_GEN), sig))
    return _device_pairing_check(pairs)


def _fast_aggregate_verify_torch(pubkeys, message, signature):
    if len(pubkeys) == 0:
        return False
    try:
        sig = _py._sig_to_point(signature)
        agg = _curve.g1.infinity()
        for pk in pubkeys:
            agg = _curve.g1.add(agg, _py._pk_to_point(pk))
    except ValueError:
        return False
    h = _h2c.hash_to_g2(message, _h2c.DST_G2)
    return _device_pairing_check(
        [(agg, h), (_curve.g1.neg(_curve.G1_GEN), sig)])


def _eager(torch_fn, py_fn, *args):
    return (torch_fn if _backend_name == "torch" else py_fn)(*args)


# --- scheme functions, honoring the kill-switch -----------------------------


def Sign(privkey, message):
    if not bls_active:
        return STUB_SIGNATURE
    return _py.Sign(int(privkey), bytes(message))


def Verify(pubkey, message, signature):
    if not bls_active:
        return True
    return _eager(_verify_torch, _py.Verify, bytes(pubkey), bytes(message),
                  bytes(signature))


def Aggregate(signatures):
    if not bls_active:
        return STUB_SIGNATURE
    return _py.Aggregate([bytes(s) for s in signatures])


def AggregateVerify(pubkeys, messages, signature):
    if not bls_active:
        return True
    return _eager(_aggregate_verify_torch, _py.AggregateVerify,
                  [bytes(p) for p in pubkeys],
                  [bytes(m) for m in messages], bytes(signature))


def FastAggregateVerify(pubkeys, message, signature):
    if not bls_active:
        return True
    if _deferred is not None:
        return _deferred.record([bytes(p) for p in pubkeys],
                                bytes(message), bytes(signature))
    return _eager(_fast_aggregate_verify_torch, _py.FastAggregateVerify,
                  [bytes(p) for p in pubkeys],
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
    if _backend_name == "torch":
        pairs = []
        for (tag1, p), (tag2, q) in values:
            assert tag1 == 1 and tag2 == 2
            pairs.append((p, q))
        return _device_pairing_check(pairs)
    return _py.pairing_check(values)


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


# --- point API (always active; KZG needs real math even with sigs off) ------

add = _py.add
multiply = _py.multiply
neg = _py.neg
eq = _py.eq
Z1 = _py.Z1
Z2 = _py.Z2
G1 = _py.G1
G2 = _py.G2
G1_to_bytes48 = _py.G1_to_bytes48
G2_to_bytes96 = _py.G2_to_bytes96
bytes48_to_G1 = _py.bytes48_to_G1
bytes96_to_G2 = _py.bytes96_to_G2

# G1 batches below this size stay on the host (JAX `ops/bls/__init__.py:301`)
_MSM_DEVICE_MIN = 16


def multi_exp(points, integers):
    """MSM of (group_tag, point) pairs; under "torch", G1 batches of
    `_MSM_DEVICE_MIN` or more points run on the device
    (`ops.bls_batch.g1_multi_exp_device`), the rest on the host oracle."""
    is_g1 = bool(points) and points[0][0] == 1
    if (_backend_name == "torch" and len(points) >= _MSM_DEVICE_MIN
            and is_g1):
        from ..bls_batch import g1_multi_exp_device

        return (1, g1_multi_exp_device([p for _, p in points],
                                       [int(i) for i in integers],
                                       device=_device))
    return _py.multi_exp(points, integers)


class Scalar(int):
    """BLS12-381 scalar-field element (mod r), the arithmetic the KZG
    library runs on (JAX `ops/bls/__init__.py:343`; Deneb's
    `BLSFieldElement` subclasses it)."""

    _R = _R

    def __new__(cls, value=0):
        return super().__new__(cls, int(value) % cls._R)

    def __add__(self, other):
        return type(self)((int(self) + int(other)) % self._R)

    __radd__ = __add__

    def __sub__(self, other):
        return type(self)((int(self) - int(other)) % self._R)

    def __rsub__(self, other):
        return type(self)((int(other) - int(self)) % self._R)

    def __mul__(self, other):
        return type(self)((int(self) * int(other)) % self._R)

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(-int(self) % self._R)

    def __truediv__(self, other):
        return self * type(self)(int(other)).inverse()

    def __rtruediv__(self, other):
        return type(self)(int(other)) / self

    def inverse(self):
        return type(self)(pow(int(self), -1, self._R))

    def pow(self, exp):
        return type(self)(pow(int(self), int(exp), self._R))
