"""BLS signatures over BLS12-381: min-pk and min-sig variants.

Copy of msm_blst_tpu/protocol/signatures.py for the port. Capability twin
of blst's signature stack:
  * core sign/verify           — blst's src/aggregate.c, src/e1.c/e2.c
  * aggregation contexts       — blst_pairing_* (src/aggregate.c:1-673)
  * message-uniqueness check   — src/rb_tree.c (here: a host set)
  * min-pk / min-sig clients   — src/client_min_pk.c, src/client_min_sig.c

Keys are ints (secret) / affine int tuples (public); byte-level APIs use the
ZCash serialization from curves/serialize.py. Verification uses the batched
Miller loop + single final exponentiation, same shape as blst's pairing
aggregation contexts.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Tuple

from ..constants import R_ORDER
from ..curves import serialize as ser
from ..refimpl.curve import G1_REF, G2_REF
from ..refimpl.field import Fp, Fp2
from . import hash_to_curve as h2c
from .glv import in_g1, in_g2
from .pairing import Fp12, final_exp, miller_loop, miller_loop_n

# ciphersuite DSTs (draft-irtf-cfrg-bls-signature-05)
DST_MINPK_SIG = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"
DST_MINPK_POP_SIG = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
DST_MINPK_POP = b"BLS_POP_BLS12381G2_XMD:SHA-256_SSWU_RO_POP_"
DST_MINSIG_SIG = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"
DST_MINSIG_POP_SIG = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_POP_"
DST_MINSIG_POP = b"BLS_POP_BLS12381G1_XMD:SHA-256_SSWU_RO_POP_"


def _g1_aff(pt_ints):
    return (Fp(pt_ints[0]), Fp(pt_ints[1]))


def _g2_aff(pt_ints):
    return (Fp2(*pt_ints[0]), Fp2(*pt_ints[1]))


def _g1_ints(aff):
    return (aff[0].v, aff[1].v)


def _g2_ints(aff):
    return ((aff[0].c0.v, aff[0].c1.v), (aff[1].c0.v, aff[1].c1.v))


def sk_to_pk_g1(sk: int):
    """Public key in G1 (min-pk scheme). Affine int pair."""
    return G1_REF.affine_mult(sk % R_ORDER, G1_REF.gen_affine)


def sk_to_pk_g2(sk: int):
    """Public key in G2 (min-sig scheme)."""
    return G2_REF.affine_mult(sk % R_ORDER, G2_REF.gen_affine)


def _neg_g1(aff):
    if G1_REF.affine_is_inf(aff):
        return aff
    return (aff[0], -aff[1])


# ---------------------------------------------------------------------------
# min-pk: public keys in G1 (48 B), signatures in G2 (96 B)
# ---------------------------------------------------------------------------


class MinPk:
    """The min-pk scheme (eth2 flavour): pk in G1, sig in G2."""

    DST = DST_MINPK_POP_SIG

    @staticmethod
    def sk_to_pk(sk: int):
        p = sk_to_pk_g1(sk)
        return _g1_ints(p)

    @staticmethod
    def sign(sk: int, msg: bytes, dst: bytes = DST_MINPK_POP_SIG):
        h = h2c.hash_to_g2(msg, dst)
        q = G2_REF.affine_mult(sk % R_ORDER, _g2_aff(h))
        return _g2_ints(q)

    @staticmethod
    def verify(pk, sig, msg: bytes, dst: bytes = DST_MINPK_POP_SIG,
               check_groups: bool = True) -> bool:
        """e(pk, H(msg)) == e(G1, sig)  <=>  e(-G1, sig) e(pk, H(msg)) == 1."""
        pk_a, sig_a = _g1_aff(pk), _g2_aff(sig)
        if check_groups and not (in_g1(pk_a) and in_g2(sig_a)):
            return False
        if G1_REF.affine_is_inf(pk_a):
            return False
        h = _g2_aff(h2c.hash_to_g2(msg, dst))
        f = miller_loop_n(
            [(_neg_g1(G1_REF.gen_affine), sig_a), (pk_a, h)]
        )
        return final_exp(f).is_one()

    @staticmethod
    def aggregate(sigs: Sequence, check_groups: bool = True):
        """Sum of G2 signature points (blst_pairing_aggregate analog)."""
        acc = G2_REF.jac_inf()
        for s in sigs:
            s_a = _g2_aff(s)
            if check_groups and not in_g2(s_a):
                raise ValueError("signature not in G2")
            acc = G2_REF.jac_add(acc, G2_REF.from_affine(s_a))
        return _g2_ints(G2_REF.to_affine(acc))

    @staticmethod
    def aggregate_pks(pks: Sequence):
        acc = G1_REF.jac_inf()
        for p in pks:
            acc = G1_REF.jac_add(acc, G1_REF.from_affine(_g1_aff(p)))
        return _g1_ints(G1_REF.to_affine(acc))

    @staticmethod
    def aggregate_verify(pks: Sequence, msgs: Sequence[bytes], sig,
                         dst: bytes = DST_MINPK_POP_SIG,
                         require_unique_msgs: bool = True) -> bool:
        """prod_i e(pk_i, H(m_i)) == e(G1, sig). Message uniqueness enforced
        like the reference's rb-tree (src/rb_tree.c) unless disabled."""
        if len(pks) != len(msgs) or not pks:
            return False
        if require_unique_msgs and len(set(msgs)) != len(msgs):
            return False
        sig_a = _g2_aff(sig)
        if not in_g2(sig_a):
            return False
        pairs = [(_neg_g1(G1_REF.gen_affine), sig_a)]
        for pk, msg in zip(pks, msgs):
            pk_a = _g1_aff(pk)
            if not in_g1(pk_a) or G1_REF.affine_is_inf(pk_a):
                return False
            pairs.append((pk_a, _g2_aff(h2c.hash_to_g2(msg, dst))))
        return final_exp(miller_loop_n(pairs)).is_one()

    @staticmethod
    def fast_aggregate_verify(pks: Sequence, msg: bytes, sig,
                              dst: bytes = DST_MINPK_POP_SIG) -> bool:
        """All signers sign the same message; pks must be PoP-certified."""
        if not pks:
            return False
        apk = MinPk.aggregate_pks(pks)
        return MinPk.verify(apk, sig, msg, dst, check_groups=True)

    # ---- proof of possession ------------------------------------------
    @staticmethod
    def pop_prove(sk: int):
        pk_bytes = ser.g1_compress(MinPk.sk_to_pk(sk))
        h = h2c.hash_to_g2(pk_bytes, DST_MINPK_POP)
        return _g2_ints(G2_REF.affine_mult(sk % R_ORDER, _g2_aff(h)))

    @staticmethod
    def pop_verify(pk, proof) -> bool:
        pk_bytes = ser.g1_compress(pk)
        pk_a, pr_a = _g1_aff(pk), _g2_aff(proof)
        if not (in_g1(pk_a) and in_g2(pr_a)) or G1_REF.affine_is_inf(pk_a):
            return False
        h = _g2_aff(h2c.hash_to_g2(pk_bytes, DST_MINPK_POP))
        f = miller_loop_n([(_neg_g1(G1_REF.gen_affine), pr_a), (pk_a, h)])
        return final_exp(f).is_one()

    # ---- byte-level API -------------------------------------------------
    @staticmethod
    def pk_to_bytes(pk) -> bytes:
        return ser.g1_compress(pk)

    @staticmethod
    def pk_from_bytes(b: bytes):
        return ser.g1_uncompress(b)

    @staticmethod
    def sig_to_bytes(sig) -> bytes:
        return ser.g2_compress(sig)

    @staticmethod
    def sig_from_bytes(b: bytes):
        return ser.g2_uncompress(b)


# ---------------------------------------------------------------------------
# min-sig: public keys in G2 (96 B), signatures in G1 (48 B)
# ---------------------------------------------------------------------------


class MinSig:
    """The min-sig scheme: pk in G2, sig in G1."""

    DST = DST_MINSIG_POP_SIG

    @staticmethod
    def sk_to_pk(sk: int):
        return _g2_ints(sk_to_pk_g2(sk))

    @staticmethod
    def sign(sk: int, msg: bytes, dst: bytes = DST_MINSIG_POP_SIG):
        h = h2c.hash_to_g1(msg, dst)
        q = G1_REF.affine_mult(sk % R_ORDER, _g1_aff(h))
        return _g1_ints(q)

    @staticmethod
    def verify(pk, sig, msg: bytes, dst: bytes = DST_MINSIG_POP_SIG,
               check_groups: bool = True) -> bool:
        """e(H(msg), pk) == e(sig, G2)  <=>  e(-sig, G2) e(H, pk) == 1."""
        pk_a, sig_a = _g2_aff(pk), _g1_aff(sig)
        if check_groups and not (in_g2(pk_a) and in_g1(sig_a)):
            return False
        if G2_REF.affine_is_inf(pk_a):
            return False
        h = _g1_aff(h2c.hash_to_g1(msg, dst))
        f = miller_loop_n(
            [(_neg_g1(sig_a), G2_REF.gen_affine), (h, pk_a)]
        )
        return final_exp(f).is_one()

    @staticmethod
    def aggregate(sigs: Sequence, check_groups: bool = True):
        acc = G1_REF.jac_inf()
        for s in sigs:
            s_a = _g1_aff(s)
            if check_groups and not in_g1(s_a):
                raise ValueError("signature not in G1")
            acc = G1_REF.jac_add(acc, G1_REF.from_affine(s_a))
        return _g1_ints(G1_REF.to_affine(acc))

    @staticmethod
    def aggregate_verify(pks: Sequence, msgs: Sequence[bytes], sig,
                         dst: bytes = DST_MINSIG_POP_SIG,
                         require_unique_msgs: bool = True) -> bool:
        if len(pks) != len(msgs) or not pks:
            return False
        if require_unique_msgs and len(set(msgs)) != len(msgs):
            return False
        sig_a = _g1_aff(sig)
        if not in_g1(sig_a):
            return False
        pairs = [(_neg_g1(sig_a), G2_REF.gen_affine)]
        for pk, msg in zip(pks, msgs):
            pk_a = _g2_aff(pk)
            if not in_g2(pk_a) or G2_REF.affine_is_inf(pk_a):
                return False
            pairs.append((_g1_aff(h2c.hash_to_g1(msg, dst)), pk_a))
        return final_exp(miller_loop_n(pairs)).is_one()

    @staticmethod
    def pk_to_bytes(pk) -> bytes:
        return ser.g2_compress(pk)

    @staticmethod
    def pk_from_bytes(b: bytes):
        return ser.g2_uncompress(b)

    @staticmethod
    def sig_to_bytes(sig) -> bytes:
        return ser.g1_compress(sig)

    @staticmethod
    def sig_from_bytes(b: bytes):
        return ser.g1_uncompress(b)


# ---------------------------------------------------------------------------
# incremental pairing context (blst_pairing_* twin)
# ---------------------------------------------------------------------------


@dataclass
class PairingContext:
    """Accumulates (pk, msg, sig) triples and verifies with one final exp —
    the shape of blst_pairing_init/aggregate/commit/finalverify."""

    min_pk: bool = True
    dst: bytes = DST_MINPK_POP_SIG
    check_unique: bool = True
    _msgs: set = field(default_factory=set)
    _gtf: Fp12 = field(default_factory=Fp12.one)
    _sig_acc: Optional[object] = None  # jacobian accumulated signature

    def aggregate(self, pk, sig, msg: bytes) -> None:
        """Add one (pk, msg) pair, optionally folding sig into the context."""
        if self.check_unique:
            if msg in self._msgs:
                raise ValueError("duplicate message in aggregation context")
            self._msgs.add(msg)
        if self.min_pk:
            pk_a = _g1_aff(pk)
            if not in_g1(pk_a):
                raise ValueError("pk not in G1")
            h = _g2_aff(h2c.hash_to_g2(msg, self.dst))
            self._gtf = self._gtf * miller_loop(pk_a, h)
            if sig is not None:
                s = _g2_aff(sig)
                if not in_g2(s):
                    raise ValueError("sig not in G2")
                cur = self._sig_acc or G2_REF.jac_inf()
                self._sig_acc = G2_REF.jac_add(cur, G2_REF.from_affine(s))
        else:
            pk_a = _g2_aff(pk)
            if not in_g2(pk_a):
                raise ValueError("pk not in G2")
            h = _g1_aff(h2c.hash_to_g1(msg, self.dst))
            self._gtf = self._gtf * miller_loop(h, pk_a)
            if sig is not None:
                s = _g1_aff(sig)
                if not in_g1(s):
                    raise ValueError("sig not in G1")
                cur = self._sig_acc or G1_REF.jac_inf()
                self._sig_acc = G1_REF.jac_add(cur, G1_REF.from_affine(s))

    def finalverify(self, sig=None) -> bool:
        """Verify against `sig` (or the accumulated signatures)."""
        if sig is not None:
            sig_a = _g2_aff(sig) if self.min_pk else _g1_aff(sig)
        elif self._sig_acc is not None:
            curve = G2_REF if self.min_pk else G1_REF
            sig_a = curve.to_affine(self._sig_acc)
        else:
            return False
        if self.min_pk:
            f = self._gtf * miller_loop(_neg_g1(G1_REF.gen_affine), sig_a)
        else:
            f = self._gtf * miller_loop(_neg_g1(sig_a), G2_REF.gen_affine)
        return final_exp(f).is_one()
