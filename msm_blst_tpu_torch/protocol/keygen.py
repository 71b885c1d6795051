"""BLS key generation: HKDF-SHA256 KeyGen + EIP-2333 hierarchical derivation.

Copy of msm_blst_tpu/protocol/keygen.py for the port. Capability twin of
blst's src/keygen.c:18-319 (blst_keygen,
blst_derive_master_eip2333, blst_derive_child_eip2333 and the v3/v4.5/v5
draft variants). Pure host-side bytes work (hashlib/hmac).
"""

from __future__ import annotations

import hashlib
import hmac

from ..constants import R_ORDER

_SALT0 = b"BLS-SIG-KEYGEN-SALT-"


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """draft-irtf-cfrg-bls-signature-05 KeyGen (blst_keygen twin).

    Iterates salt = H(salt) until SK != 0; requires len(ikm) >= 32.
    """
    if len(ikm) < 32:
        raise ValueError("IKM must be at least 32 bytes")
    salt = _SALT0
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R_ORDER
    return sk


def keygen_v3(ikm: bytes, key_info: bytes = b"") -> int:
    """draft v3 variant: fixed salt, no retry loop salt-rehash on first pass
    (blst_keygen_v3 twin)."""
    if len(ikm) < 32:
        raise ValueError("IKM must be at least 32 bytes")
    salt = _SALT0
    sk = 0
    while sk == 0:
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R_ORDER
        salt = hashlib.sha256(salt).digest()
    return sk


# ---------------------------------------------------------------------------
# EIP-2333 hierarchical key derivation
# ---------------------------------------------------------------------------


def _hkdf_mod_r(ikm: bytes, key_info: bytes = b"") -> int:
    salt = _SALT0
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + (48).to_bytes(2, "big"), 48)
        sk = int.from_bytes(okm, "big") % R_ORDER
    return sk


def _ikm_to_lamport_sk(ikm: bytes, salt: bytes):
    prk = _hkdf_extract(salt, ikm)
    okm = _hkdf_expand(prk, b"", 255 * 32)
    return [okm[i * 32 : (i + 1) * 32] for i in range(255)]


def _parent_sk_to_lamport_pk(parent_sk: int, index: int) -> bytes:
    salt = index.to_bytes(4, "big")
    ikm = parent_sk.to_bytes(32, "big")
    lamport_0 = _ikm_to_lamport_sk(ikm, salt)
    not_ikm = bytes(b ^ 0xFF for b in ikm)
    lamport_1 = _ikm_to_lamport_sk(not_ikm, salt)
    lamport_pk = b"".join(
        hashlib.sha256(x).digest() for x in lamport_0 + lamport_1
    )
    return hashlib.sha256(lamport_pk).digest()


def derive_master_eip2333(seed: bytes) -> int:
    """blst_derive_master_eip2333 twin. Requires len(seed) >= 32."""
    if len(seed) < 32:
        raise ValueError("seed must be at least 32 bytes")
    return _hkdf_mod_r(seed)


def derive_child_eip2333(parent_sk: int, index: int) -> int:
    """blst_derive_child_eip2333 twin."""
    return _hkdf_mod_r(_parent_sk_to_lamport_pk(parent_sk, index))


def derive_path_eip2333(seed: bytes, path) -> int:
    sk = derive_master_eip2333(seed)
    for idx in path:
        sk = derive_child_eip2333(sk, idx)
    return sk
