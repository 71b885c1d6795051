"""Protocol layer: pairing, hash-to-curve, keygen, BLS signatures, GLV/GLS.

Port of msm_blst_tpu/protocol, exporting the same names. The host stack
(tower, pairing, hash_to_curve, keygen, glv, signatures) is a copy of the
JAX package's pure-Python modules; device_map.py runs the batched SSWU maps
on the card (K1 and K2).
"""

from .tower import Fp6, Fp12  # noqa: F401
from .pairing import (  # noqa: F401
    miller_loop,
    miller_loop_n,
    final_exp,
    pairing,
    multi_pairing,
    pairing_check,
)
from .hash_to_curve import (  # noqa: F401
    expand_message_xmd,
    hash_to_field_fp,
    hash_to_field_fp2,
    hash_to_g1,
    hash_to_g2,
    encode_to_g1,
    encode_to_g2,
    psi,
)
from .keygen import (  # noqa: F401
    keygen,
    keygen_v3,
    derive_master_eip2333,
    derive_child_eip2333,
    derive_path_eip2333,
)
from .glv import (  # noqa: F401
    BETA,
    LAMBDA,
    glv_decompose,
    gls_decompose,
    mult_glv_g1,
    mult_gls_g2,
    in_g1,
    in_g2,
    phi,
)
from .signatures import MinPk, MinSig, PairingContext  # noqa: F401
