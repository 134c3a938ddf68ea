"""Merkle trees with caps, built level by level.

Counterpart: ethproof_tpu/hash/merkle.py:101-145. Leaves are the columns
of a (L, N) row matrix, digested with `poseidon.tree_digest`; interior
nodes are `two_to_one` of siblings, a level at a time
(`poseidon.merkle_level`, one kernel launch on a card); the tree stops at
`cap_height`, whose 2^cap_height digests are the commitment. All levels
are kept, so query paths are gathers. On a mesh (`build_blocks`) the
leaves lie in contiguous domain blocks on several devices, each block a
whole subtree built where it lies; the counterpart leaves that split to
XLA's partitioner.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from . import poseidon

# Leaves are digested in domain blocks of at most this many input elements
# (the counterpart's `_LEAF_BLOCK_ELEMS`, merkle.py:62): the plain
# permutation's temporaries, and on a card the first level's digests, then
# scale with the block, not with the whole matrix.
LEAF_BLOCK_ELEMS = 1 << 25


class MerkleTree(NamedTuple):
    """A tree over the leaves of one or more contiguous domain blocks.

    blocks[d][l] = level l of block d's subtree on block d's device
    (level 0 = its leaf digests (4, N / w)); `top` = the levels above the
    blocks, built on the leader (the first block's device); `cap` = the
    last level, (4, 2^cap_height) on the leader. One block is the plain
    tree: its levels reach the cap and `top` is empty."""

    blocks: List[List[torch.Tensor]]
    top: List[torch.Tensor]
    cap: torch.Tensor
    cap_height: int

    @property
    def levels(self) -> List[torch.Tensor]:
        """levels[0] = leaf digests (4, N) ... levels[-1] = cap, each
        level of several blocks joined on the leader."""
        if len(self.blocks) == 1:
            return self.blocks[0] + self.top
        dev = self.cap.device
        split = [torch.cat([b[lv].to(dev) for b in self.blocks], dim=1)
                 for lv in range(len(self.blocks[0]))]
        return split + self.top

    @property
    def num_leaves(self) -> int:
        return sum(b[0].shape[1] for b in self.blocks)


def _subtree(rows: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Leaf digests of `rows` (L, N), then `levels` levels of two_to_one."""
    n = rows.shape[1]
    block = max(1, LEAF_BLOCK_ELEMS // max(rows.shape[0], 1))
    digests = torch.cat([poseidon.tree_digest(rows[:, s : s + block])
                         for s in range(0, n, block)], dim=1)
    out = [digests]
    for _ in range(levels):
        digests = poseidon.merkle_level(digests)
        out.append(digests)
    return out


def build(rows: torch.Tensor, cap_height: int) -> MerkleTree:
    """Build a cap-truncated Merkle tree over N = rows.shape[1] leaves."""
    return build_blocks([rows], cap_height)


def build_blocks(blocks: List[torch.Tensor], cap_height: int) -> MerkleTree:
    """The tree over the leaves of w contiguous domain blocks (w a power of
    two, equal blocks, each on its device), equal to `build` of the joined
    rows level for level. Siblings are 0::2 / 1::2, so a block is a whole
    subtree: each device builds its own down to its share of the cap
    (2^cap_height >= w), or to its root, the w roots then meeting on the
    leader, which builds the levels above them (2^cap_height < w)."""
    w = len(blocks)
    span = blocks[0].shape[1]
    n = w * span
    assert w & (w - 1) == 0 and all(b.shape[1] == span for b in blocks)
    assert n & (n - 1) == 0, "leaf count must be a power of two"
    depth = n.bit_length() - 1
    assert 0 <= cap_height <= depth
    block_depth = span.bit_length() - 1
    stop = max(cap_height - (w.bit_length() - 1), 0)  # log2 of a block's top level
    subtrees = [_subtree(b, block_depth - stop) for b in blocks]
    leader = blocks[0].device
    roots = subtrees[0][-1] if w == 1 else torch.cat([t[-1].to(leader) for t in subtrees], dim=1)
    top = []
    digests = roots
    while digests.shape[1] > 1 << cap_height:
        digests = poseidon.merkle_level(digests)
        top.append(digests)
    return MerkleTree(subtrees, top, digests, cap_height)


def take(blocks: List[torch.Tensor], idx: torch.Tensor, device) -> torch.Tensor:
    """Columns `idx` (global, (Q,)) of the (k, N) matrix held as w equal
    contiguous column blocks -> (k, Q) on `device`."""
    if len(blocks) == 1:
        return blocks[0][:, idx.to(blocks[0].device)].to(device)
    span = blocks[0].shape[1]
    idx = idx.to(device)
    out = torch.empty((blocks[0].shape[0], idx.shape[0]), dtype=blocks[0].dtype, device=device)
    owner = idx // span
    for d, blk in enumerate(blocks):
        sel = (owner == d).nonzero().flatten()
        if sel.numel():
            local = (idx[sel] % span).to(blk.device)
            out[:, sel] = blk[:, local].to(device)
    return out


def open_path(tree: MerkleTree, index: torch.Tensor) -> torch.Tensor:
    """Sibling digests from leaf to cap: (path_len, 4) for a 0-d index,
    (path_len, 4, Q) for a (Q,) index tensor. Each level's siblings are
    read from the block that holds them."""
    dev = tree.cap.device
    idx = torch.as_tensor(index, device=dev)
    flat = idx.reshape(-1)
    sibs = []
    for lv in range(len(tree.blocks[0]) - (0 if tree.top else 1)):
        sibs.append(take([b[lv] for b in tree.blocks], flat ^ 1, dev))
        flat = flat >> 1
    for level in tree.top[:-1]:
        sibs.append(level[:, flat ^ 1])
        flat = flat >> 1
    return torch.stack(sibs).reshape((len(sibs), 4) + tuple(idx.shape))


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
