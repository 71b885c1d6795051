"""Chunked scan primitives for expensive commutative monoids.

Port of msm_blst_tpu/utils/scans.py with the same chunking, so a scan here
associates its terms exactly as the JAX one does: reshape the stream into
(n_chunks, chunk) rows, advance all chunks one column at a time at full
width, then recurse over the chunk tails and combine.

A tree is a tensor or a NamedTuple of tensors (a point batch), batch last.
`combine` must be associative and commutative, and tolerate zero padding in
lanes that are sliced away (true for field products and for point adds,
where all-zero is infinity).
"""

from __future__ import annotations

import torch

DEFAULT_CHUNK = 256
TARGET_LANES = 8192


def pick_chunk(n: int, chunk: int = DEFAULT_CHUNK) -> int:
    """Columns per chunk (as the JAX package): terminal sizes take one
    narrow level, big streams ~TARGET_LANES lanes per step, mid sizes
    ~cbrt(n) columns."""
    if n <= 16:
        return n
    if n >= 8 * TARGET_LANES:
        return max(32, min(chunk, -(-n // TARGET_LANES)))
    return max(16, min(chunk, int(round(n ** (1 / 3))) + 1))


def tree_map(fn, *trees):
    if isinstance(trees[0], tuple):
        return type(trees[0])(*(fn(*xs) for xs in zip(*trees)))
    return fn(*trees)


def _last_dim(tree) -> int:
    x = tree[0] if isinstance(tree, tuple) else tree
    return x.shape[-1]


def pad_last(x: torch.Tensor, pad: int) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def _columns(tree, n: int, c: int):
    """(..., n) -> (c, ..., n_ch) contiguous columns, padded with zeros;
    column j holds stream elements k*c + j."""
    n_ch = -(-n // c)

    def cols(x):
        x = pad_last(x, n_ch * c - n)
        return x.reshape(x.shape[:-1] + (n_ch, c)).movedim(-1, 0).contiguous()

    return tree_map(cols, tree), n_ch


def _col(tree, j: int):
    return tree_map(lambda x: x[j], tree)


def prefix_scan(combine, tree, chunk: int = DEFAULT_CHUNK):
    """Inclusive prefix scan along the last axis, full width."""
    N = _last_dim(tree)
    if N == 1:
        return tree
    c = pick_chunk(N, chunk)
    cols, n_ch = _columns(tree, N, c)
    acc = _col(cols, 0)
    outs = [acc]
    for j in range(1, c):
        acc = combine(acc, _col(cols, j))
        outs.append(acc)
    tails = acc
    # (..., n_ch) per column -> (..., n_ch, c) -> stream index k*c + j
    stream = tree_map(
        lambda *xs: torch.stack(xs, dim=-1).reshape(xs[0].shape[:-1] + (-1,)),
        *outs)
    if n_ch > 1:
        tails_scan = prefix_scan(combine, tails, chunk)
        # chunk k >= 1 gets the inclusive prefix of the chunks before it
        carry = tree_map(lambda x: x[..., :-1].repeat_interleave(c, dim=-1),
                         tails_scan)
        head = tree_map(lambda x: x[..., :c], stream)
        rest = tree_map(lambda x: x[..., c:], stream)
        combined = combine(carry, rest)
        stream = tree_map(lambda h, r: torch.cat([h, r], dim=-1), head,
                          combined)
    return tree_map(lambda x: x[..., :N], stream)


def suffix_scan(combine, tree, chunk: int = DEFAULT_CHUNK):
    """Inclusive suffix scan along the last axis (flip, prefix, flip)."""
    flip = lambda x: torch.flip(x, dims=(-1,))  # noqa: E731
    return tree_map(flip, prefix_scan(combine, tree_map(flip, tree), chunk))
