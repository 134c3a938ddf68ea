"""Merkle trees with caps, built level by level.

Counterpart: ethproof_tpu/hash/merkle.py:101-145. Leaves are the columns
of a (L, N) row matrix, digested with `poseidon.tree_digest`; interior
nodes are `two_to_one`; the tree stops at `cap_height`, whose 2^cap_height
digests are the commitment. All levels are kept, so query paths are
gathers.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import poseidon

# Leaves are digested in domain blocks of at most this many input elements
# (the counterpart's `_LEAF_BLOCK_ELEMS`, merkle.py:62): the permutation's
# temporaries then scale with the block, not with the whole matrix.
LEAF_BLOCK_ELEMS = 1 << 25


class MerkleTree(NamedTuple):
    """levels[0] = leaf digests (4, N) ... levels[-1] = cap (4, 2^cap_height)."""

    levels: List[torch.Tensor]
    cap_height: int

    @property
    def cap(self) -> torch.Tensor:
        return self.levels[-1]

    @property
    def num_leaves(self) -> int:
        return self.levels[0].shape[1]


def build(rows: torch.Tensor, cap_height: int) -> MerkleTree:
    """Build a cap-truncated Merkle tree over N = rows.shape[1] leaves."""
    n = rows.shape[1]
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    depth = n.bit_length() - 1
    assert 0 <= cap_height <= depth
    block = max(1, LEAF_BLOCK_ELEMS // max(rows.shape[0], 1))
    digests = torch.cat([poseidon.tree_digest(rows[:, s : s + block])
                         for s in range(0, n, block)], dim=1)
    levels = [digests]
    for _ in range(depth - cap_height):
        digests = poseidon.two_to_one(digests[:, 0::2], digests[:, 1::2])
        levels.append(digests)
    return MerkleTree(levels, cap_height)


def open_path(tree: MerkleTree, index: torch.Tensor) -> torch.Tensor:
    """Sibling digests from leaf to cap: (path_len, 4) for a 0-d index,
    (path_len, 4, Q) for a (Q,) index tensor."""
    idx = torch.as_tensor(index, device=tree.cap.device)
    sibs = []
    for level in tree.levels[:-1]:
        sibs.append(level[:, idx ^ 1])
        idx = idx >> 1
    return torch.stack(sibs)


def verify_path(leaf_digest: torch.Tensor, index, path: torch.Tensor,
                cap: torch.Tensor) -> torch.Tensor:
    """Check leaf -> cap against a path; bool tensor over the batch shape.

    leaf_digest: (4, ...); path: (path_len, 4, ...); cap: (4, 2^cap_height)."""
    idx = torch.as_tensor(index, device=cap.device)
    current = leaf_digest
    for i in range(path.shape[0]):
        sib = path[i]
        is_right = (idx & 1).bool()
        left = torch.where(is_right, sib, current)
        right = torch.where(is_right, current, sib)
        current = poseidon.two_to_one(left, right)
        idx = idx >> 1
    return (current == cap[:, idx]).all(dim=0)
