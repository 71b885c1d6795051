"""K6's dataflow (csrc/sos.cuh) rehearsed on the CPU, word for word.

A numpy twin runs the kernel's warp body with the kernel's own lane and
index maps: lane l = 4g + t multiplies slot u = t of quad g (group element
16 (u >> 1) + 8 (u & 1) + g), T through the warp's rows (lane t of quad g
reads words 3t.. of the rows 4g + u), the B registers as Toeplitz windows
of the 72-word table of P' and p, each
mma decoded from and encoded into the 32 lanes' fragment registers by the
PTX layouts of m16n8k32 and m16n8k16, tile by tile, and the position sums
resolved into words in the kernel's shuffle order (the quad's three carry
rounds, the low half's carry from lane 3, the conditional subtraction's
looked-ahead borrows). A shuffle is a gather along the lane axis.

The twin equals the plain version (`sos.sos_stage_plain`) at every stage
and JAX's `_mont_mul_body_sos` (jitted, as tests/test_torch_sos.py runs it)
on random operands from a numpy seed and on edge operands: 0, 1, p - 1,
R mod p, a pair whose product is 0 mod R (so m = 0), on batches that are
not a multiple of a warp's group. Its B registers, read back through the
mma's layout, are the byte Toeplitz of `sos.kernel_consts`. No tolerance:
every stage is the canonical words of an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msm_blst_tpu.constants import P
from msm_blst_tpu.fields import pallas_mont as pm
from msm_blst_tpu.fields.limb import FP as JFP
from msm_blst_tpu_torch.convert import fp_from_jax, fp_to_jax
from msm_blst_tpu_torch.fields import FP, sos
from msm_blst_tpu_torch.fields.limb import array_to_ints, ints_to_array

R = 1 << 384
M32 = 0xFFFFFFFF
LANE = np.arange(32)
G_OF, T_OF = LANE >> 2, LANE & 3
BELOW = (LANE & ~3) | ((T_OF + 3) & 3)  # the lane below in the quad


def elem_of(g, u):
    return 16 * (u >> 1) + 8 * (u & 1) + g


def words(x: int, n: int) -> list:
    return [(x >> (32 * i)) & M32 for i in range(n)]


# ---- the table and the B registers (sos.cuh fill_table, lane_consts) ------

PPRIME = (-pow(P, -1, R)) % R


def table() -> list:
    """72 words: P' then p, words -12 .. 23 each."""
    return ([0] * 12 + words(PPRIME, 12) + [0] * 12
            + [0] * 12 + words(P, 12) + [0] * 12)


def window(tab: list, off: int, x: int) -> int:
    k, e = x >> 2, x & 3
    lo, hi = tab[off + 12 + k - 1], tab[off + 12 + k]
    s = 8 * (3 - e)
    v = hi if s == 0 else ((hi << s) | (lo >> (32 - s))) & M32
    return int.from_bytes(v.to_bytes(4, "little")[::-1], "little")


def lane_consts() -> dict:
    """Each lane's 23 B registers and p's words of its block, uint64[32, .]."""
    tab = table()
    g1, g2, e, pw = [], [], [], []
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        x1 = 12 * ((g >> 1) - t) + (g & 1)
        g1.append([window(tab, 0, x1 + 2 * y) for y in range(-4, 6)])
        g2.append([window(tab, 36, 48 + x1 + 2 * y) for y in range(-4, 6)])
        e.append([window(tab, 36, 46 + (g & 1) - 12 * t - 4 * z) if g >= 6
                  else 0 for z in range(3)])
        pw.append(tab[36 + 12 + 3 * t: 36 + 12 + 3 * t + 3])
    return {k: np.array(v, dtype=np.uint64)
            for k, v in (("g1", g1), ("g2", g2), ("e", e), ("pw", pw))}


# ---- the warp's collective operations --------------------------------------

def shfl(v, src):
    """v[G, 32, ...] -> each lane's value of lane src[lane]."""
    return v[:, src]


def _bytes(w, q):
    return (w >> np.uint64(8 * q)) & np.uint64(0xFF)


# A (16 x K, row major) of m16n8k32 / m16n8k16 and B (K x 8): the lane and
# register of each byte, by the PTX ISA's fragment layouts
def _a_map(k_depth):
    r, k = np.meshgrid(np.arange(16), np.arange(k_depth), indexing="ij")
    lane = 4 * (r & 7) + ((k & 15) >> 2)
    reg = (r >= 8).astype(int) + (2 * (k >= 16) if k_depth == 32 else 0)
    return lane, reg, k & 3


def _b_map(k_depth):
    k, n = np.meshgrid(np.arange(k_depth), np.arange(8), indexing="ij")
    return 4 * n + ((k & 15) >> 2), (k >= 16).astype(int), k & 3


MAPS = {32: (_a_map(32), _b_map(32)), 16: (_a_map(16), _b_map(16))}


def mma(d, a, b, k_depth):
    """d[G, 32, 4] += A B: a[G, 32, 4 or 2], b[G or 1, 32, 2 or 1] the
    lanes' fragment registers."""
    (al, ar, aq), (bl, br, bq) = MAPS[k_depth]
    A = _bytes(a[:, al, ar], aq[None]).astype(np.int64)   # [G, 16, K]
    B = _bytes(b[:, bl, br], bq[None]).astype(np.int64)   # [G, K, 8]
    D = A @ B                                              # [G, 16, 8]
    i = np.arange(4)
    rows = G_OF[:, None] + 8 * (i[None] >> 1)
    cols = 2 * T_OF[:, None] + (i[None] & 1)
    return d + D[:, rows, cols]


def matrix_of_b(b, k_depth) -> np.ndarray:
    """The K x 8 matrix the lanes' B registers b[32, .] hold."""
    _, (bl, br, bq) = MAPS[k_depth]
    return _bytes(b[bl, br], bq).astype(np.int64)


# ---- the warp body (sos.cuh group) ------------------------------------------

def mul_wide(x, y):
    """[G, 32, 12] x2 -> T [G, 32, 24], schoolbook with 64-bit partials."""
    t = np.zeros(x.shape[:2] + (24,), dtype=np.uint64)
    for i in range(12):
        c = np.zeros(x.shape[:2], dtype=np.uint64)
        for j in range(12):
            p = x[..., j] * y[..., i]  # < 2^64
            lo = (p & np.uint64(M32)) + t[..., i + j] + c
            t[..., i + j] = lo & np.uint64(M32)
            c = (p >> np.uint64(32)) + (lo >> np.uint64(32))
        t[..., i + 12] = c
    return t


def stage_t(T):
    """T [G, 32, 24] through the warp's rows: lane t of quad g reads words
    3t + c (tl[c]) and 12 + 3t + c (th[c]) of the rows 4g + u, u < 4, each
    [G, 32, 4]."""
    rows = 4 * G_OF[:, None] + np.arange(4)[None]           # [32, 4]
    tl = [T[:, rows, (3 * T_OF + c)[:, None]] for c in range(3)]
    th = [T[:, rows, (12 + 3 * T_OF + c)[:, None]] for c in range(3)]
    return tl, th


def block_words(acc, add):
    """acc[j] [G, 32, 2] the lane's two sums of tile j for one slot, add
    [G, 32, 3] -> the block's words [G, 32, 4] (the last its carry out)."""
    s = np.zeros(add.shape[:2], dtype=np.uint64)
    out = []
    for c in range(3):
        l0 = acc[2 * c][..., 0] + (acc[2 * c][..., 1] << np.uint64(8))
        l1 = acc[2 * c + 1][..., 0] + (acc[2 * c + 1][..., 1] << np.uint64(8))
        s = s + l0 + (l1 << np.uint64(16)) + add[..., c]
        out.append(s & np.uint64(M32))
        s = s >> np.uint64(32)
    return np.stack(out + [s], axis=-1)


def add_in(b, cin):
    s = cin.copy()
    r = []
    for c in range(3):
        s = s + b[..., c]
        r.append(s & np.uint64(M32))
        s = s >> np.uint64(32)
    return np.stack(r, axis=-1), s


def quad_carry(b, cin):
    """The quad's three carry rounds: a block passes on one more carry than
    b[..., 3] iff its two top words are all ones and b0 + cin overflows."""
    first = (T_OF == 0)[None, :]
    ones = (b[..., 1] & b[..., 2]) == M32
    for _ in range(3):
        out = b[..., 3] + (ones & (cin > (~b[..., 0] & np.uint64(M32))))
        cin = np.where(first, cin, shfl(out, BELOW))
    return add_in(b, cin)[0]


def quad_csub(r, pw):
    s = np.zeros(r.shape[:2], dtype=np.int64)
    borrow = np.zeros(r.shape[:2], dtype=np.int64)
    d = []
    ri = r.astype(np.int64)
    for c in range(3):
        s = ri[..., c] - pw[None, :, c].astype(np.int64) - borrow
        borrow = (s < 0).astype(np.int64)
        d.append(s & M32)
    eq = np.all(r == pw[None], axis=-1).astype(np.int64)
    bits = (borrow << T_OF[None]) | (eq << (T_OF[None] + 8))
    bits |= shfl(bits, LANE ^ 1)
    bits |= shfl(bits, LANE ^ 2)
    G, Pm = (bits & 0xF) << 1, (bits >> 8) & 0xF
    lookahead = G | ((G + Pm) ^ G ^ Pm)
    ge = ((lookahead >> 4) & 1) == 0
    bin_ = (lookahead >> T_OF[None]) & 1
    out = []
    for c in range(3):
        s = d[c] - bin_
        bin_ = (s < 0).astype(np.int64)
        out.append(np.where(ge, s & M32, ri[..., c]))
    return np.stack(out, axis=-1).astype(np.uint64)


def twin(a: np.ndarray, b: np.ndarray, stage: str) -> np.ndarray:
    """K6's stage on uint32[12, n] word batches, lane by lane."""
    n = a.shape[1]
    groups = -(-n // 32)
    idx = np.arange(groups)[:, None] * 32 + elem_of(G_OF, T_OF)[None]
    valid = idx < n
    col = np.minimum(idx, n - 1)
    x = np.where(valid[..., None], a.T[col], 0).astype(np.uint64)
    y = np.where(valid[..., None], b.T[col], 0).astype(np.uint64)
    out = np.zeros((12, groups * 32), dtype=np.uint64)
    T = mul_wide(x, y)
    if stage == "prod":
        out[:, idx.ravel()] = T[..., :12].reshape(-1, 12).T
        return out[:, :n].astype(np.uint32)

    def store(v):  # v[c][G, 32, 4 slots]: word 3t + c of slot u's element
        for u in range(4):
            e = np.arange(groups)[:, None] * 32 + elem_of(G_OF, u)[None]
            for c in range(3):
                out[3 * T_OF[None] + c, e] = v[c][..., u]
        return out[:, :n].astype(np.uint32)

    tl, th = stage_t(T)
    if stage == "bytes":
        return store(tl)
    k = lane_consts()

    def product(opd, bregs):
        """acc[mt][j] [G, 32, 4] for the tiles' B registers bregs(j) ->
        (b32 [32, 2], b16 [32])."""
        acc = []
        for mt in range(2):
            a32 = np.stack([opd[0][..., 2 * mt], opd[0][..., 2 * mt + 1],
                            opd[1][..., 2 * mt], opd[1][..., 2 * mt + 1]], -1)
            a16 = np.stack([opd[2][..., 2 * mt], opd[2][..., 2 * mt + 1]], -1)
            row = []
            for b32, b16 in bregs:
                d = np.zeros(x.shape[:2] + (4,), dtype=np.int64)
                d = mma(d, a32, b32[None], 32)
                d = mma(d, a16, b16[None, :, None], 16)
                row.append(d.astype(np.uint64))
            acc.append(row)
        return acc

    def tiles(gk):
        return [(np.stack([k[gk][:, j + 4], k[gk][:, j + 2]], -1), k[gk][:, j])
                for j in range(6)]

    acc = product(tl, tiles("g1"))
    zero = np.zeros(x.shape[:2] + (3,), dtype=np.uint64)
    m = [np.zeros(x.shape[:2] + (4,), dtype=np.uint64) for _ in range(3)]
    for u in range(4):
        sums = [acc[u >> 1][j][..., 2 * (u & 1): 2 * (u & 1) + 2]
                for j in range(6)]
        r = quad_carry(block_words(sums, zero),
                       np.zeros(x.shape[:2], np.uint64))
        for c in range(3):
            m[c][..., u] = r[..., c]
    if stage == "mm1":
        return store(m)

    carry_tile = [(np.stack([k["e"][:, 0], k["e"][:, 1]], -1), k["e"][:, 2])]
    acc = product(m, tiles("g2") + carry_tile)
    res = [np.zeros(x.shape[:2] + (4,), dtype=np.uint64) for _ in range(3)]
    for u in range(4):
        sums = [acc[u >> 1][j][..., 2 * (u & 1): 2 * (u & 1) + 2]
                for j in range(6)]
        tw = np.stack([th[c][..., u] for c in range(3)], -1)
        blk = block_words(sums, tw)
        s = acc[u >> 1][6][..., 2 * (u & 1): 2 * (u & 1) + 2]
        top = ((tl[2][..., u] >> np.uint64(16)) + s[..., 0]
               + (s[..., 1] << np.uint64(8)))
        got = shfl((top + np.uint64(0xFFFF)) >> np.uint64(16), (LANE & ~3) | 3)
        cin = np.where((T_OF == 0)[None], got, np.uint64(0))
        f = quad_csub(quad_carry(blk, cin), k["pw"])
        for c in range(3):
            res[c][..., u] = f[..., c]
    return store(res)


# ---- the tests --------------------------------------------------------------

def _operands(n: int, seed: int):
    rng = np.random.default_rng(seed)
    xs = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    ys = [int.from_bytes(rng.bytes(48), "little") % P for _ in range(n)]
    # edge pairs: 0, 1, p - 1, R mod p, and 2^192 * 2^192 = 0 mod R
    edges = [(0, ys[0]), (xs[1], 0), (1, P - 1), (P - 1, P - 1),
             (R % P, R % P), (1 << 192, 1 << 192), (P - 1, 1), (R % P, 1)]
    for i, (x, y) in enumerate(edges):
        xs[i], ys[i] = x, y
    return xs, ys


@pytest.fixture(scope="module")
def batch():
    """(xs, ys) ints and their int32[12, 301] word batches: 301 is not a
    multiple of a warp's 32 elements."""
    xs, ys = _operands(301, 13)
    return xs, ys, torch.as_tensor(ints_to_array(xs, 12)), torch.as_tensor(
        ints_to_array(ys, 12))


@pytest.mark.parametrize("stage", sos.STAGES)
def test_twin_matches_plain(batch, stage):
    _, _, a, b = batch
    got = twin(a.numpy().view(np.uint32), b.numpy().view(np.uint32), stage)
    want = sos.sos_stage_plain(a, b, FP, stage).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_twin_full_matches_jax_body(batch):
    """The twin's Montgomery product equals a jit of JAX's
    _mont_mul_body_sos on the same residues (Montgomery words in, out)."""
    xs, ys, _, _ = batch
    ja, jb = JFP.from_ints(xs), JFP.from_ints(ys)
    c = pm.build_sos_consts(24, P)
    not_p = np.array([((R - P) >> (16 * i)) & 0xFFFF for i in range(24)],
                     np.uint32).reshape(24, 1)
    body = jax.jit(lambda u, v: pm._mont_mul_body_sos(
        u, v, 24, *(jnp.asarray(c[k]).astype(jnp.bfloat16)
                    for k in pm.SOS_CONST_NAMES), jnp.asarray(not_p)))
    want = np.asarray(body(ja, jb))
    cpu = torch.device("cpu")
    ta = fp_from_jax(np.asarray(ja), cpu).numpy().view(np.uint32)
    tb = fp_from_jax(np.asarray(jb), cpu).numpy().view(np.uint32)
    got = twin(ta, tb, "full")
    assert np.array_equal(fp_to_jax(torch.as_tensor(got.view(np.int32))), want)


def test_twin_edges(batch):
    """The edge pairs by their integers: m = 0 where T = 0 mod R, and the
    full stage is x y R^-1 mod p."""
    xs, ys, a, b = batch
    an, bn = a.numpy().view(np.uint32), b.numpy().view(np.uint32)
    m = array_to_ints(twin(an, bn, "mm1").view(np.int32))
    full = array_to_ints(twin(an, bn, "full").view(np.int32))
    r_inv = pow(R, -1, P)
    assert m[5] == 0 and xs[5] * ys[5] % R == 0
    assert all(m[i] == xs[i] * ys[i] * PPRIME % R for i in range(16))
    assert full == [x * y * r_inv % P for x, y in zip(xs, ys)]


@pytest.mark.parametrize("n", [1, 33, 64])
def test_twin_batch_edges(n):
    """One element, one past a group, two whole groups."""
    xs, ys = _operands(max(n, 8), 21)
    a = ints_to_array(xs[:n], 12).view(np.uint32)
    b = ints_to_array(ys[:n], 12).view(np.uint32)
    want = sos.sos_stage_plain(torch.as_tensor(a.view(np.int32)),
                               torch.as_tensor(b.view(np.int32)), FP, "full")
    assert np.array_equal(twin(a, b, "full"), want.numpy().view(np.uint32))


def test_register_toeplitz_is_kernel_consts():
    """Every B fragment the kernel builds in registers, read back through
    the mma's layout with the kernel's k and column maps, is the byte
    Toeplitz of sos.kernel_consts: rows 0..47 (m = T P' mod R) against the
    m tiles, rows 48..143 (m p) against the high tiles and the carry tile's
    columns 6 and 7 (positions 46, 47)."""
    dense = sos.kernel_consts(P).astype(np.int64)
    k = lane_consts()
    # k byte of a k32 step (z = 0: bytes 4t'.., 1: 16 + 4t'..) or of the k16
    # step (z = 2) -> the A element's byte 12 t' + 4 z + q
    k32 = [12 * (kk % 16 // 4) + 4 * (kk // 16) + kk % 4 for kk in range(32)]
    k16 = [12 * (kk // 4) + 8 + kk % 4 for kk in range(16)]
    for j in range(6):
        cols = [12 * (c >> 1) + 2 * j + (c & 1) for c in range(8)]
        for gk, base in (("g1", 0), ("g2", 48)):
            b32 = np.stack([k[gk][:, j + 4], k[gk][:, j + 2]], -1)
            b16 = k[gk][:, j][:, None]
            rows = [base + c for c in cols] if base == 0 else \
                [48 + 48 + c for c in cols]
            want32 = dense[np.ix_(rows, k32)].T
            want16 = dense[np.ix_(rows, k16)].T
            assert np.array_equal(matrix_of_b(b32, 32), want32), (gk, j)
            assert np.array_equal(matrix_of_b(b16, 16), want16), (gk, j)
    e32 = np.stack([k["e"][:, 0], k["e"][:, 1]], -1)
    got32, got16 = matrix_of_b(e32, 32), matrix_of_b(k["e"][:, 2:3], 16)
    assert not got32[:, :6].any() and not got16[:, :6].any()
    rows = [48 + 46, 48 + 47]  # m p's positions 46 and 47
    assert np.array_equal(got32[:, 6:], dense[np.ix_(rows, k32)].T)
    assert np.array_equal(got16[:, 6:], dense[np.ix_(rows, k16)].T)


def test_quad_carry_passes_carries_through_all_ones_blocks():
    """The carry rounds equal the exact sum of the quad's four blocks
    (b_t 2^(96t) + b3_t 2^(96(t+1)), lane 0's carry in at the bottom) on
    blocks whose two top words are all ones and whose low word is at or
    near all ones, where a carry in crosses a whole block: random data
    never makes them."""
    rng = np.random.default_rng(17)
    G = 64
    b = rng.integers(0, 1 << 32, size=(G, 32, 4), dtype=np.uint64)
    b[..., 3] %= 1 << 17
    mode = rng.integers(0, 4, size=(G, 32))
    b[..., 1] = np.where(mode >= 1, M32, b[..., 1])
    b[..., 2] = np.where(mode >= 1, M32, b[..., 2])
    b[..., 0] = np.where(mode == 2, M32 - rng.integers(0, 4, size=(G, 32)),
                         b[..., 0])
    b[..., 0] = np.where(mode == 3, M32, b[..., 0])
    cin = np.where(T_OF[None] == 0, rng.integers(0, 1 << 17, size=(G, 32)),
                   0).astype(np.uint64)
    got = quad_carry(b, cin)
    for gi in range(G):
        for q in range(8):
            lanes = range(4 * q, 4 * q + 4)
            total = int(cin[gi, 4 * q]) + sum(
                (int(b[gi, l, 0]) + (int(b[gi, l, 1]) << 32)
                 + (int(b[gi, l, 2]) << 64) + (int(b[gi, l, 3]) << 96))
                << (96 * t) for t, l in enumerate(lanes))
            for t, l in enumerate(lanes):
                want = [(total >> (96 * t + 32 * c)) & M32 for c in range(3)]
                assert [int(v) for v in got[gi, l]] == want
