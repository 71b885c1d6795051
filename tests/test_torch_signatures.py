"""The port's copy of protocol/signatures.py against the JAX package's: the
min-pk and min-sig schemes and the pairing context give the same keys,
signatures, aggregates, bytes and verdicts on the JAX package's own cases
(keys from keygen, accepted and rejected messages and keys, duplicate
messages, proofs of possession).
"""

import pytest

from msm_blst_tpu.protocol import signatures as jsig
from msm_blst_tpu_torch.protocol import MinPk, MinSig, PairingContext, keygen
from msm_blst_tpu_torch.protocol import signatures as sig_mod

SKS = [keygen(bytes([i]) * 32) for i in range(1, 4)]
MSGS = [b"msg-one", b"msg-two", b"msg-three"]


def _both(scheme, method, *args, **kw):
    """(port, JAX) results of one scheme method on the same arguments."""
    return (getattr(scheme, method)(*args, **kw),
            getattr(getattr(jsig, scheme.__name__), method)(*args, **kw))


def _same(scheme, method, *args, **kw):
    got, want = _both(scheme, method, *args, **kw)
    assert got == want, method
    return got


def test_dsts():
    for name in ("DST_MINPK_SIG", "DST_MINPK_POP_SIG", "DST_MINPK_POP",
                 "DST_MINSIG_SIG", "DST_MINSIG_POP_SIG", "DST_MINSIG_POP"):
        assert getattr(sig_mod, name) == getattr(jsig, name)


def test_minpk_sign_verify():
    sk = SKS[0]
    pk = _same(MinPk, "sk_to_pk", sk)
    sig = _same(MinPk, "sign", sk, b"hello world")
    assert _same(MinPk, "verify", pk, sig, b"hello world")
    assert not _same(MinPk, "verify", pk, sig, b"hello w0rld")
    other = MinPk.sk_to_pk(SKS[1])
    assert not _same(MinPk, "verify", other, sig, b"hello world")


def test_minpk_aggregate_verify():
    pks = [MinPk.sk_to_pk(s) for s in SKS]
    sigs = [MinPk.sign(s, m) for s, m in zip(SKS, MSGS)]
    agg = _same(MinPk, "aggregate", sigs)
    assert _same(MinPk, "aggregate_pks", pks) == MinPk.sk_to_pk(sum(SKS))
    assert _same(MinPk, "aggregate_verify", pks, MSGS, agg)
    assert not _same(MinPk, "aggregate_verify", pks, [b"a", b"b", b"c"], agg)
    assert not _same(MinPk, "aggregate_verify", pks, [b"dup", b"dup", b"x"],
                     agg, require_unique_msgs=True)


def test_minpk_fast_aggregate_and_pop():
    pks = [MinPk.sk_to_pk(s) for s in SKS]
    sigs = [MinPk.sign(s, b"same message") for s in SKS]
    assert _same(MinPk, "fast_aggregate_verify", pks, b"same message",
                 MinPk.aggregate(sigs))
    proof = _same(MinPk, "pop_prove", SKS[0])
    assert _same(MinPk, "pop_verify", pks[0], proof)
    assert not _same(MinPk, "pop_verify", pks[1], proof)


def test_minsig_sign_verify_aggregate():
    pks = [_same(MinSig, "sk_to_pk", s) for s in SKS]
    sig = _same(MinSig, "sign", SKS[0], b"hello")
    assert _same(MinSig, "verify", pks[0], sig, b"hello")
    assert not _same(MinSig, "verify", pks[0], sig, b"h3llo")
    sigs = [MinSig.sign(s, m) for s, m in zip(SKS, MSGS)]
    agg = _same(MinSig, "aggregate", sigs)
    assert _same(MinSig, "aggregate_verify", pks, MSGS, agg)


def test_pairing_context():
    ctx, jctx = PairingContext(), jsig.PairingContext()
    for s, m in zip(SKS, MSGS):
        pk, sig = MinPk.sk_to_pk(s), MinPk.sign(s, m)
        ctx.aggregate(pk, sig, m)
        jctx.aggregate(pk, sig, m)
    assert ctx.finalverify() and jctx.finalverify()
    for c in (ctx, jctx):
        with pytest.raises(ValueError):
            c.aggregate(MinPk.sk_to_pk(SKS[0]), None, MSGS[0])
    assert not PairingContext().finalverify()


def test_serialization_roundtrip():
    sk = SKS[0]
    pk, sig = MinPk.sk_to_pk(sk), MinPk.sign(sk, b"bytes api")
    pk_b = _same(MinPk, "pk_to_bytes", pk)
    sig_b = _same(MinPk, "sig_to_bytes", sig)
    assert _same(MinPk, "pk_from_bytes", pk_b) == pk
    assert _same(MinPk, "sig_from_bytes", sig_b) == sig
    pk2, sig2 = MinSig.sk_to_pk(sk), MinSig.sign(sk, b"bytes api")
    assert _same(MinSig, "pk_from_bytes", _same(MinSig, "pk_to_bytes",
                                                pk2)) == pk2
    assert _same(MinSig, "sig_from_bytes", _same(MinSig, "sig_to_bytes",
                                                 sig2)) == sig2
