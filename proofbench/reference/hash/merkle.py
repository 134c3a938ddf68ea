"""The reference's Merkle trees with caps: one device, every level kept.

Leaves are the columns of a (L, N) row matrix, digested with
`poseidon.tree_digest` in domain blocks of at most LEAF_BLOCK_ELEMS input
elements (the digest of a column does not depend on the blocking);
interior nodes are `two_to_one` of siblings 0::2 and 1::2; the tree stops
at `cap_height`, whose 2^cap_height digests are the commitment.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import poseidon

LEAF_BLOCK_ELEMS = 1 << 25


class MerkleTree(NamedTuple):
    levels: List[torch.Tensor]  # levels[0] = leaf digests (4, N) ... levels[-1] = cap
    cap: torch.Tensor
    cap_height: int


def build(rows: torch.Tensor, cap_height: int) -> MerkleTree:
    n = rows.shape[1]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    assert 0 <= cap_height <= n.bit_length() - 1
    block = max(1, LEAF_BLOCK_ELEMS // max(rows.shape[0], 1))
    digests = torch.cat([poseidon.tree_digest(rows[:, s : s + block])
                         for s in range(0, n, block)], dim=1)
    levels = [digests]
    while digests.shape[1] > 1 << cap_height:
        digests = poseidon.two_to_one(digests[:, 0::2], digests[:, 1::2])
        levels.append(digests)
    return MerkleTree(levels, digests, cap_height)


def open_path(tree: MerkleTree, index: torch.Tensor) -> torch.Tensor:
    """Sibling digests from leaf to cap: (path_len, 4, Q) for a (Q,) index."""
    idx = torch.as_tensor(index, device=tree.cap.device)
    sibs = []
    for level in tree.levels[:-1]:
        sibs.append(level[:, idx ^ 1])
        idx = idx >> 1
    return torch.stack(sibs).reshape((len(sibs), 4) + tuple(idx.shape))
