"""In-circuit MPT witness binding: the kernel verifies the state-root
transition itself.

Counterpart: ethproof_tpu/evm/binding.py:1 (a copy).

Reference equivalent: evm_arithmetization's kernel MPT routines — the asm
kernel walks/updates tries in kernel memory, hashing nodes through the
KeccakSponge CTL so the STARK's public values include the real
state_root_before/after (reference ops/src/lib.rs:52 public values; MPT
asm [dep: from knowledge; pin Cargo.lock:1675]). This
module is the TPU-native re-design: instead of an interpreter loop, a
STRAIGHT-LINE program (shape fixed by `KernelShape`) verifies, per
account update, a root→leaf path pair:

  - every path node is keccak-hashed by the sponge (OP_HASH_START /
    OP_DIGEST CTLs pin message region, extent and digest);
  - each parent is RLP-parsed (full tiling: branch = exactly 17 items
    each 0x80 | 0xa0+32B; extension = hexprefix(flag<2) + 0xa0+32B) and
    the traversed child's 32-byte hash window is located;
  - containment: extract(parent, window) == digest(child), pre and post;
  - transition: parent_post == parent_pre OUTSIDE the window (word-level
    equality + boundary-byte masks), so the post trie is the pre trie
    with exactly this path rewritten;
  - the leaf parses as an account (nonce, balance, storage_root,
    code_hash); nonce/balance bind to PI words per role, storage_root/
    code_hash/key-suffix must be preserved;
  - level-0 digests bind to the state-root PI words; multiple account
    updates chain through witnessed intermediate roots.

The full RLP tiling is load-bearing: without it a prover knowing keccak
preimages embedded in the state (contract code, storage nodes) could
detour the containment chain through them. Tiling pins every path node
to be a genuine branch/extension (RLP is a prefix code, so a byte string
tiles in exactly one way), which confines the chain to state-trie nodes.

Scope (documented, enforced by `walk_path` raising Unsupported, with
host-side `check_trie_binding` as the fallback): same-shape updates only
(all touched accounts exist pre-state; tx does not restructure the
trie), no embedded (<32B) path nodes (impossible for account paths on
mainnet), path depth <= shape.levels, node size <= shape capacity.
Account IDENTITY (path == keccak(address) nibbles) remains host-checked
via derive_pi_words until address hashing moves in-circuit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from ..hash.keccak import keccak256
from ..tables.keccak_sponge import RATE_BYTES
from ..trie.nibbles import Nibbles
from ..trie.trie import Branch, Extension, Hash, Leaf, PartialTrie, _node_rlp_encoded
from ..witness.mpt import decode_account, encode_account
from .kasm import KAsm, le_word


class Unsupported(Exception):
    """Witness shape outside the in-circuit binding's envelope — the
    caller falls back to host-side binding (check_trie_binding)."""


@dataclass(frozen=True)
class KernelShape:
    """Static parameters of the binding program (part of the proof
    statement; the verifier rebuilds the same program from them)."""

    levels: int = 10  # max path depth including the leaf
    node_words: int = 20  # words per node region (20 = 4 rate blocks, 532B)

    @property
    def max_node_bytes(self) -> int:
        full, tail = divmod(self.node_words, 5)
        return full * RATE_BYTES + min(tail * 32, RATE_BYTES)

    @property
    def max_blocks(self) -> int:
        return (self.node_words + 4) // 5


PRODUCTION_SHAPE = KernelShape(levels=10, node_words=20)


# -- witness side --------------------------------------------------------------


@dataclass
class PathInfo:
    nodes: List[bytes]  # RLP of hashed nodes, root -> leaf
    is_branch: List[bool]  # per interior level
    idxs: List[int]  # branch child nibble per interior level (0 for ext)


def walk_path(trie: PartialTrie, key: Nibbles) -> PathInfo:
    nodes: List[bytes] = []
    is_branch: List[bool] = []
    idxs: List[int] = []
    node, k = trie.root, key
    while True:
        if isinstance(node, Hash):
            raise Unsupported("path crosses an unresolved Hash node")
        enc = _node_rlp_encoded(node)
        if len(enc) < 32:
            raise Unsupported("embedded (<32B) node on account path")
        nodes.append(enc)
        if isinstance(node, Leaf):
            if node.key != k:
                raise Unsupported("key not present (leaf mismatch)")
            return PathInfo(nodes, is_branch, idxs)
        if isinstance(node, Extension):
            if not k.starts_with(node.key):
                raise Unsupported("key not present (extension diverges)")
            is_branch.append(False)
            idxs.append(0)
            k = k[len(node.key) :]
            node = node.child
        elif isinstance(node, Branch):
            if len(k) == 0:
                raise Unsupported("key exhausted at a branch")
            is_branch.append(True)
            idxs.append(k[0])
            node = node.children[k[0]]
            k = k[1:]
        else:
            raise Unsupported("key not present (empty)")


@dataclass
class UpdateWitness:
    pre: PathInfo
    post: PathInfo
    root_pre: bytes
    root_post: bytes


@dataclass
class PiBinding:
    """How one account update's leaf fields bind to CPU public inputs.
    None = the field must instead be PRESERVED across the update.
    sroot_pre_pi/sroot_post_pi (contract calls): the storage root is NOT
    preserved — it must equal these PI words instead, which the storage
    chain (emit_slot_chain) separately proves to connect the changed
    slots to the account."""

    bal_pre_pi: int
    bal_post_pi: int
    nonce_pre_pi: Optional[int] = None
    nonce_post_pi: Optional[int] = None
    sroot_pre_pi: Optional[int] = None
    sroot_post_pi: Optional[int] = None


def build_update_witness(
    trie: PartialTrie,
    key: Nibbles,
    nonce: int,
    balance: int,
    shape: KernelShape,
    storage_root: Optional[bytes] = None,
) -> Tuple[UpdateWitness, PartialTrie]:
    """Witness for one account's (nonce, balance[, storage_root]) update;
    returns the post trie for chaining. Raises Unsupported outside the
    envelope."""
    pre = walk_path(trie, key)
    raw = trie.get(key)
    if raw is None:
        raise Unsupported("account does not exist pre-state")
    acc = decode_account(raw)
    acc["nonce"], acc["balance"] = nonce, balance
    if storage_root is not None:
        acc["storage_root"] = storage_root
    post_trie = trie.copy()
    post_trie.insert(key, encode_account(acc))
    post = walk_path(post_trie, key)
    _check_same_shape(pre, post, shape)
    return (
        UpdateWitness(
            pre=pre, post=post, root_pre=trie.hash(), root_post=post_trie.hash()
        ),
        post_trie,
    )


def encode_slot_value(v: int) -> bytes:
    """Storage-trie leaf value: RLP(minimal big-endian uint)."""
    from ..trie import rlp

    return rlp.encode(rlp.int_to_bytes(v))


def _check_same_shape(pre: PathInfo, post: PathInfo, shape: KernelShape) -> None:
    if len(pre.nodes) != len(post.nodes) or pre.is_branch != post.is_branch:
        raise Unsupported("update restructures the trie")
    if pre.idxs != post.idxs:
        raise Unsupported("update changes the traversal path")
    if len(pre.nodes) > shape.levels:
        raise Unsupported(f"path depth {len(pre.nodes)} > {shape.levels}")
    for n in pre.nodes + post.nodes:
        if len(n) > shape.max_node_bytes:
            raise Unsupported(f"node of {len(n)}B exceeds shape capacity")


def build_slot_update_witness(
    strie: PartialTrie, key: Nibbles, new_value: int, shape: KernelShape
) -> Tuple[UpdateWitness, PartialTrie]:
    """Witness for one storage-slot value update; returns the post trie
    for chaining. Raises Unsupported outside the envelope (absent slot,
    deletion — both restructure the trie)."""
    if strie.get(key) is None:
        raise Unsupported("slot does not exist pre-state")
    if new_value == 0:
        raise Unsupported("slot deletion restructures the trie")
    pre = walk_path(strie, key)
    post_trie = strie.copy()
    post_trie.insert(key, encode_slot_value(new_value))
    post = walk_path(post_trie, key)
    _check_same_shape(pre, post, shape)
    return (
        UpdateWitness(
            pre=pre, post=post, root_pre=strie.hash(), root_post=post_trie.hash()
        ),
        post_trie,
    )


@dataclass
class BindingWitness:
    """Per-tx witness for the binding section: one UpdateWitness per
    distinct touched account, in sequential application order."""

    updates: List[UpdateWitness]


def build_binding_witness(
    state: PartialTrie,
    finals: List[Tuple[Nibbles, int, int]],  # (key, nonce_post, balance_post)
    shape: KernelShape,
) -> BindingWitness:
    """Walk + apply each account update in order. Raises Unsupported when
    any update falls outside the in-circuit envelope."""
    updates: List[UpdateWitness] = []
    trie = state
    for key, nonce, balance in finals:
        uw, trie = build_update_witness(trie, key, nonce, balance, shape)
        updates.append(uw)
    return BindingWitness(updates=updates)


# -- kernel side ----------------------------------------------------------------


def _blocks(data: bytes) -> int:
    return len(data) // RATE_BYTES + 1


@dataclass
class _LeafFields:
    nonce: int
    bal: int
    sroot: int
    chash: int
    hp_x: int  # first 32 hexprefix-item bytes (LE) for key-suffix compare
    hp_total: int  # hexprefix item size incl. its header byte
    hp_b32: int
    hp_b33: int
    hdr: int


@dataclass
class _SlotFields:
    val: int  # the slot's uint256 value
    hp_x: int
    hp_total: int
    hp_b32: int
    hp_b33: int
    hdr: int


class BindingEmitter:
    """Emits the binding section of a kernel program. One instance per
    program build (concrete for the prover, program-only for the
    verifier)."""

    def __init__(self, k: KAsm, shape: KernelShape):
        self.k = k
        self.shape = shape
        # dedicated leaf-gather regions (2 streams), allocated per update
        self._c: Dict[int, int] = {}

    # small helpers -----------------------------------------------------------

    def c(self, v: int) -> int:
        return self.k.const(v)

    def _list_header(self, base: int, L: int, gate: int):
        """Parse an RLP list header at offset 0 -> (payload, hdr_len,
        is_f9). Gated assert: it IS a list and header+payload == L."""
        k = self.k
        b0 = k.byte_at(base, self.c(0))
        is_f8 = k.eq(b0, self.c(0xF8))
        is_f9 = k.eq(b0, self.c(0xF9))
        b1 = k.byte_at(base, self.c(1))
        b2 = k.byte_at(base, self.c(2))
        long2 = k.add(k.mul(b1, self.c(256)), b2)
        payload = k.select(
            is_f9, long2, k.select(is_f8, b1, k.sub(b0, self.c(0xC0)))
        )
        hdr = k.add(self.c(1), k.add(is_f8, k.mul(self.c(2), is_f9)))
        k.gassert0(gate, k.sub(self.c(1), k.lt(self.c(0xBF), b0)))  # >= 0xc0
        k.gassert_eq(gate, k.add(hdr, payload), L)
        return payload, hdr, is_f9

    def _string_item(self, base: int, off: int):
        """Parse a short-string RLP item header at `off` ->
        (size incl. header, content_off, content_len, header_byte,
        is_single). Sound for items < 56 bytes (hexprefix, ints)."""
        k = self.k
        hb = k.byte_at(base, off)
        single = k.lt(hb, self.c(0x80))
        clen = k.select(single, self.c(1), k.sub(hb, self.c(0x80)))
        coff = k.select(single, off, k.add(off, self.c(1)))
        total = k.select(single, self.c(1), k.add(self.c(1), clen))
        return total, coff, clen, hb, single

    def hash_node(self, base: int, data: Callable[[], bytes]):
        """Stage + hash one node region -> (digest_reg, len_reg,
        blocks_reg). Works for inactive slots (empty message)."""
        k = self.k
        k.stage_bytes(base, data, self.shape.node_words)
        blocks = k.wit(lambda: _blocks(data()))
        d = k.keccak_region(
            base, ts=k.auto_ts(), blocks=None, msg_fn=data, blocks_reg=blocks
        )
        L = k.message_len(blocks, k.last_lenf)
        return d, L, blocks

    # interior level -----------------------------------------------------------

    def interior(
        self,
        pre: int,
        post: int,
        L_pre: int,
        L_post: int,
        gate: int,
        is_branch: int,
        idx: int,
        child_d_pre: int,
        child_d_post: int,
    ) -> None:
        """Constrain one parent level: parse pre, locate the child window,
        check containment of both child digests, and pre/post equality
        outside the window."""
        k = self.k
        one = self.c(1)
        _payload, hdr, _f9 = self._list_header(pre, L_pre, gate)

        # -- branch tiling: 17 items, each 0x80 or 0xa0+32B ------------------
        gb = k.mul(gate, is_branch)
        o = hdr
        child_off_b = self.c(0)
        child_empty = self.c(0)
        k.gassert0(gb, k.sub(one, k.lt(idx, self.c(16))))
        for item in range(17):
            hb = k.byte_at(pre, o)
            e = k.eq(hb, self.c(0x80))
            k.gassert0(
                gb, k.mul(k.sub(hb, self.c(0x80)), k.sub(hb, self.c(0xA0)))
            )
            if item < 16:
                hit = k.eq(self.c(item), idx)
                child_off_b = k.add(child_off_b, k.mul(hit, o))
                child_empty = k.add(child_empty, k.mul(hit, e))
            else:
                k.gassert_eq(gb, e, one)  # state-trie branch value is empty
            o = k.add(o, k.select(e, one, self.c(33)))
        k.gassert_eq(gb, o, L_pre)
        k.gassert0(gb, child_empty)

        # -- extension: hexprefix(flag<2) + 0xa0+32B --------------------------
        ge = k.mul(gate, k.sub(one, is_branch))
        t1, c1off, c1len, hb1, single1 = self._string_item(pre, hdr)
        fb = k.byte_at(pre, c1off)
        k.gassert0(ge, k.sub(k.lt(k.div(fb, self.c(16)), self.c(2)), one))
        k.gassert0(ge, k.sub(k.lt(self.c(0), t1), one))  # nonempty prefix
        k.gassert0(ge, k.sub(k.lt(c1len, self.c(34)), one))
        o2 = k.add(hdr, t1)
        k.gassert_eq(ge, k.byte_at(pre, o2), self.c(0xA0))
        k.gassert_eq(ge, k.add(o2, self.c(33)), L_pre)

        win = k.add(k.select(is_branch, child_off_b, o2), one)

        # -- containment ------------------------------------------------------
        x_pre, ints = self._extract_ex(pre, win)
        k.gassert_eq(gate, x_pre, child_d_pre)
        x_post, ints_p = self._extract_ex(post, win)
        k.gassert_eq(gate, x_post, child_d_post)

        # -- transition: post == pre outside [win, win+32) --------------------
        k.gassert_eq(gate, L_pre, L_post)
        W0, k0, c0, c1c, c2c = ints["w"], ints["k0"], ints["c0"], ints["c1"], ints["c2"]
        for w in range(self.shape.node_words):
            cw = self.c(w)
            below = k.lt(cw, W0)
            above = k.lt(k.add(W0, self.c(2)), cw)
            outside = k.mul(k.sub(one, below), k.sub(one, above))
            pre_w = k.read(pre + w)
            post_w = k.read(post + w)
            k.gassert0(
                gate, k.mul(k.sub(one, outside), k.sub(pre_w, post_w))
            )
        # boundary bytes of the up-to-3 window words
        c8 = self.c(8)
        for (wp, wq), (kk, cc) in zip(
            zip(ints["words"], ints_p["words"]),
            ((k0, c0), (self.c(0), c1c), (self.c(0), c2c)),
        ):
            # low kk bytes equal
            mask = k.shl(one, k.mul(c8, kk))
            k.gassert_eq(gate, k.mod(wp, mask), k.mod(wq, mask))
            # bytes >= kk + cc equal
            sh = k.mul(c8, k.add(kk, cc))
            k.gassert_eq(gate, k.shr(wp, sh), k.shr(wq, sh))

    def _extract_ex(self, base: int, off: int):
        """extract(base, off, 32) + internals for the transition checks."""
        k = self.k
        c8, one = self.c(8), self.c(1)
        w0, k0, u0 = k._word_of(off)
        addr0 = k.add(self.c(base), w0)
        words = [k.loadw(addr0), k.loadw(k.add(addr0, one)), k.loadw(k.add(addr0, self.c(2)))]
        c32v, c8v = self.c(32), self.c(8)
        cap0 = k.select(k.eq(u0, self.c(4)), c8v, c32v)
        cap1 = k.select(k.eq(u0, self.c(3)), c8v, c32v)
        nb = c32v
        avail0 = k.sub(cap0, k0)
        c0 = k.select(k.lt(avail0, nb), avail0, nb)
        rem = k.sub(nb, c0)
        c1 = k.select(k.lt(cap1, rem), cap1, rem)
        c2 = k.sub(rem, c1)

        def piece(word, k_reg, c_reg):
            sh = k.shr(word, k.mul(c8, k_reg)) if k_reg is not None else word
            full = k.eq(c_reg, c32v)
            m = k.mod(sh, k.shl(one, k.mul(c8, c_reg)))
            return k.select(full, sh, m)

        p0 = piece(words[0], k0, c0)
        p1 = piece(words[1], None, c1)
        p2 = piece(words[2], None, c2)
        out = k.add(p0, k.shl(p1, k.mul(c8, c0)))
        out = k.add(out, k.shl(p2, k.mul(c8, k.add(c0, c1))))
        return out, {"w": w0, "k0": k0, "c0": c0, "c1": c1, "c2": c2, "words": words}

    # leaf ------------------------------------------------------------------

    def leaf(self, base: int, L: int, gate: int) -> _LeafFields:
        """Parse an account leaf (gated): outer 2-list [hexprefix,
        value-string], inner 4-list [nonce, balance, 0xa0+sroot,
        0xa0+chash], full tiling. Returns field registers."""
        k = self.k
        one = self.c(1)
        _payload, hdr, is_f9 = self._list_header(base, L, gate)
        # canonical: an account leaf's payload is 58..~150 bytes -> 0xf8
        k.gassert0(gate, is_f9)
        t1, c1off, c1len, hb1, single1 = self._string_item(base, hdr)
        fb = k.byte_at(base, c1off)
        flag = k.div(fb, self.c(16))
        k.gassert0(gate, k.sub(k.lt(one, flag), one))  # flag in {2,3}
        k.gassert0(gate, k.sub(k.lt(flag, self.c(4)), one))
        k.gassert0(gate, k.sub(k.lt(c1len, self.c(34)), one))
        # canonical single-byte string must use the single-byte form
        k.gassert0(
            k.mul(k.mul(gate, k.sub(one, single1)), k.eq(c1len, one)),
            k.sub(k.lt(self.c(0x7F), fb), one),
        )
        hp_x = k.extract(base, hdr, 32)
        hp_b32 = k.byte_at(base, k.add(hdr, self.c(32)))
        hp_b33 = k.byte_at(base, k.add(hdr, self.c(33)))
        v_off = k.add(hdr, t1)
        vb = k.byte_at(base, v_off)
        k.gassert_eq(gate, vb, self.c(0xB8))  # account rlp is 56..255 bytes
        vlen = k.byte_at(base, k.add(v_off, one))
        k.gassert_eq(gate, k.add(k.add(v_off, self.c(2)), vlen), L)
        a = k.add(v_off, self.c(2))
        k.gassert_eq(gate, k.byte_at(base, a), self.c(0xF8))
        apay = k.byte_at(base, k.add(a, one))
        k.gassert_eq(gate, k.add(apay, self.c(2)), vlen)
        p = k.add(a, self.c(2))
        nonce, p = self._int_item(base, p, 8, gate)
        bal, p = self._int_item(base, p, 32, gate)
        k.gassert_eq(gate, k.byte_at(base, p), self.c(0xA0))
        sroot = k.extract(base, k.add(p, one), 32)
        p = k.add(p, self.c(33))
        k.gassert_eq(gate, k.byte_at(base, p), self.c(0xA0))
        chash = k.extract(base, k.add(p, one), 32)
        p = k.add(p, self.c(33))
        k.gassert_eq(gate, p, L)
        return _LeafFields(
            nonce=nonce, bal=bal, sroot=sroot, chash=chash,
            hp_x=hp_x, hp_total=t1, hp_b32=hp_b32, hp_b33=hp_b33, hdr=hdr,
        )

    def leaf_slot(self, base: int, L: int, gate: int) -> "_SlotFields":
        """Parse a STORAGE-trie leaf (gated): outer 2-list [hexprefix,
        value-string] where the value string's content is itself
        RLP(uint256). Returns (value, key-suffix fields)."""
        k = self.k
        one = self.c(1)
        _payload, hdr, is_f9 = self._list_header(base, L, gate)
        # slot leaves are < 256 bytes (33B suffix + 34B value)
        k.gassert0(gate, is_f9)
        t1, c1off, c1len, hb1, single1 = self._string_item(base, hdr)
        fb = k.byte_at(base, c1off)
        flag = k.div(fb, self.c(16))
        k.gassert0(gate, k.sub(k.lt(one, flag), one))  # flag in {2,3}
        k.gassert0(gate, k.sub(k.lt(flag, self.c(4)), one))
        k.gassert0(gate, k.sub(k.lt(c1len, self.c(34)), one))
        k.gassert0(
            k.mul(k.mul(gate, k.sub(one, single1)), k.eq(c1len, one)),
            k.sub(k.lt(self.c(0x7F), fb), one),
        )
        hp_x = k.extract(base, hdr, 32)
        hp_b32 = k.byte_at(base, k.add(hdr, self.c(32)))
        hp_b33 = k.byte_at(base, k.add(hdr, self.c(33)))
        v_off = k.add(hdr, t1)
        t2, c2off, c2len, hb2, single2 = self._string_item(base, v_off)
        k.gassert0(gate, k.sub(k.lt(c2len, self.c(34)), one))
        k.gassert0(
            k.mul(k.mul(gate, k.sub(one, single2)), k.eq(c2len, one)),
            k.sub(k.lt(self.c(0x7F), hb2), one),
        )
        # the string's content is RLP(uint256); it must tile exactly
        val, p_end = self._int_item(base, c2off, 32, gate)
        k.gassert_eq(gate, p_end, k.add(c2off, c2len))
        k.gassert_eq(gate, k.add(v_off, t2), L)
        return _SlotFields(
            val=val, hp_x=hp_x, hp_total=t1, hp_b32=hp_b32, hp_b33=hp_b33,
            hdr=hdr,
        )

    def _int_item(self, base: int, off: int, max_len: int, gate: int):
        """RLP unsigned integer item -> (value_reg, next_off). Canonical:
        single byte < 0x80 encodes itself; otherwise 0x80+len with no
        leading zero and len >= 2 implied minimal (len==1 content must be
        >= 0x80)."""
        k = self.k
        one = self.c(1)
        total, coff, clen, hb, single = self._string_item(base, off)
        k.gassert0(gate, k.sub(k.lt(clen, self.c(max_len + 1)), one))
        raw = k.extract(base, coff, max_len)
        multi = k.sub(one, single)
        b_first = k.byte_at(base, coff)
        # no leading zero; len-1 long form must not encode < 0x80
        g_multi = k.mul(gate, multi)
        nz = k.lt(self.c(0), clen)
        k.gassert0(k.mul(g_multi, nz), k.sub(k.lt(self.c(0), b_first), one))
        is_len1 = k.eq(clen, one)
        k.gassert0(
            k.mul(g_multi, is_len1), k.sub(k.lt(self.c(0x7F), b_first), one)
        )
        val_multi = k.be_value(raw, clen, max_len)
        val = k.select(single, hb, k.mul(multi, val_multi))
        return val, k.add(off, total)

    # one account update --------------------------------------------------------

    def _path_pair(
        self,
        uw: Optional[UpdateWitness],
        root_in: int,
        root_out: int,
    ):
        """Shared path-pair machinery: hash every level, bind the roots,
        constrain the interiors, and gather the leaf level into dedicated
        regions. -> (leaf_pre_base, leaf_post_base, Lf_pre, Lf_post)."""
        k, shape = self.k, self.shape
        one, L = self.c(1), self.shape.levels
        NW = shape.node_words
        pre_bases = [k.alloc_region(NW) for _ in range(L)]
        post_bases = [k.alloc_region(NW) for _ in range(L)]
        leaf_pre = k.alloc_region(NW)
        leaf_post = k.alloc_region(NW)

        def nbytes(which: str, i: int) -> Callable[[], bytes]:
            def fn() -> bytes:
                path = uw.pre if which == "pre" else uw.post
                return path.nodes[i] if i < len(path.nodes) else b""

            return fn

        active = [
            k.wit_bool(lambda i=i: 1 if i < len(uw.pre.nodes) else 0)
            for i in range(L)
        ]
        k.assert_eq(active[0], one)
        for i in range(1, L):
            k.assert0(k.mul(active[i], k.sub(one, active[i - 1])))

        d_pre, d_post, L_pre, L_post = [], [], [], []
        for i in range(L):
            d, ln, _b = self.hash_node(pre_bases[i], nbytes("pre", i))
            d_pre.append(d)
            L_pre.append(ln)
            d, ln, _b = self.hash_node(post_bases[i], nbytes("post", i))
            d_post.append(d)
            L_post.append(ln)

        k.assert_eq(d_pre[0], root_in)
        k.assert_eq(d_post[0], root_out)

        for i in range(L - 1):
            gate = active[i + 1]
            is_b = k.wit_bool(
                lambda i=i: 1
                if i < len(uw.pre.is_branch) and uw.pre.is_branch[i]
                else 0
            )
            idx = k.wit(
                lambda i=i: uw.pre.idxs[i] if i < len(uw.pre.idxs) else 0
            )
            self.interior(
                pre_bases[i], post_bases[i], L_pre[i], L_post[i],
                gate, is_b, idx, d_pre[i + 1], d_post[i + 1],
            )

        # leaf_at: one-hot by construction (active monotone, active[0]=1)
        leaf_at = [
            k.mul(active[i], k.sub(one, active[i + 1])) if i < L - 1 else active[i]
            for i in range(L)
        ]
        Lf_pre = self.gather_leaf(pre_bases, leaf_at, L_pre, leaf_pre)
        Lf_post = self.gather_leaf(post_bases, leaf_at, L_post, leaf_post)
        return leaf_pre, leaf_post, Lf_pre, Lf_post

    def _same_suffix(self, f_pre, f_post) -> None:
        """Key-suffix preservation: hexprefix items byte-identical."""
        k = self.k
        one = self.c(1)
        k.assert_eq(f_pre.hp_total, f_post.hp_total)
        k.assert_eq(f_pre.hdr, f_post.hdr)
        m = k.select(k.lt(self.c(32), f_pre.hp_total), self.c(32), f_pre.hp_total)
        mask = k.shl(one, k.mul(self.c(8), m))
        is32 = k.eq(m, self.c(32))
        cmp = k.select(
            is32,
            k.sub(f_pre.hp_x, f_post.hp_x),
            k.sub(k.mod(f_pre.hp_x, mask), k.mod(f_post.hp_x, mask)),
        )
        k.assert0(cmp)
        k.gassert_eq(
            k.lt(self.c(32), f_pre.hp_total), f_pre.hp_b32, f_post.hp_b32
        )
        k.gassert_eq(
            k.lt(self.c(33), f_pre.hp_total), f_pre.hp_b33, f_post.hp_b33
        )

    def update(
        self,
        uw: Optional[UpdateWitness],
        root_in: int,
        root_out: int,
        pib: PiBinding,
        pi_words: Optional[List[int]],
    ) -> None:
        """Emit the full path-pair verification for one account update.
        `uw`/`pi_words` are None in program-only (verifier) mode."""
        k = self.k
        one = self.c(1)
        leaf_pre, leaf_post, Lf_pre, Lf_post = self._path_pair(
            uw, root_in, root_out
        )
        f_pre = self.leaf(leaf_pre, Lf_pre, one)
        f_post = self.leaf(leaf_post, Lf_post, one)

        # preserved fields (storage root handled by the PI binding below)
        k.assert_eq(f_pre.chash, f_post.chash)
        self._same_suffix(f_pre, f_post)

        # PI / preservation binding of nonce, balance, storage root
        def pi(word: int) -> int:
            return k.load_pi(
                word, pi_words[word] if pi_words is not None else None
            )

        if pib.nonce_pre_pi is None:
            k.assert_eq(f_pre.nonce, f_post.nonce)
        else:
            k.assert_eq(f_pre.nonce, pi(pib.nonce_pre_pi))
            k.assert_eq(f_post.nonce, pi(pib.nonce_post_pi))
        k.assert_eq(f_pre.bal, pi(pib.bal_pre_pi))
        k.assert_eq(f_post.bal, pi(pib.bal_post_pi))
        if pib.sroot_pre_pi is None:
            k.assert_eq(f_pre.sroot, f_post.sroot)
        else:
            k.assert_eq(f_pre.sroot, pi(pib.sroot_pre_pi))
            k.assert_eq(f_post.sroot, pi(pib.sroot_post_pi))

    def slot_update(
        self,
        uw: Optional[UpdateWitness],
        root_in: int,
        root_out: int,
        vpre_pi: int,
        vpost_pi: int,
        pi_words: Optional[List[int]],
    ) -> None:
        """Emit one STORAGE-slot update: path pair in the storage trie
        with slot-leaf parsing, value pre/post bound to PI words.

        Same envelope tier as accounts: the path's identity (nibbles ==
        keccak(slot key)) stays host-checked; the slot must exist in both
        tries with the same shape (no insert/delete restructuring —
        zeroing a slot deletes its leaf and falls back to host binding).
        """
        k = self.k
        one = self.c(1)
        leaf_pre, leaf_post, Lf_pre, Lf_post = self._path_pair(
            uw, root_in, root_out
        )
        f_pre = self.leaf_slot(leaf_pre, Lf_pre, one)
        f_post = self.leaf_slot(leaf_post, Lf_post, one)
        self._same_suffix(f_pre, f_post)

        def pi(word: int) -> int:
            return k.load_pi(
                word, pi_words[word] if pi_words is not None else None
            )

        k.assert_eq(f_pre.val, pi(vpre_pi))
        k.assert_eq(f_post.val, pi(vpost_pi))

    # leaf gather -------------------------------------------------------------

    def gather_leaf(
        self,
        bases: List[int],
        leaf_at: List[int],
        L_by_level: List[int],
        dst: int,
    ) -> int:
        """Copy the (witness-depth) leaf level's words into a dedicated
        static region so the leaf parse runs ONCE per stream; returns the
        leaf's length register. leaf_at: one-hot-by-construction gates."""
        k = self.k
        src = self.c(0)
        L = self.c(0)
        for i, b in enumerate(bases):
            src = k.add(src, k.mul(leaf_at[i], self.c(b)))
            L = k.add(L, k.mul(leaf_at[i], L_by_level[i]))
        for w in range(self.shape.node_words):
            v = k.loadw(k.add(src, self.c(w)))
            k.copy_to(v, dst + w)
        return L


def region_words_needed(shape: KernelShape, n_updates: int) -> int:
    return n_updates * shape.node_words * (2 * shape.levels + 2)


def emit_binding(
    k: KAsm,
    shape: KernelShape,
    pi_bindings: List[PiBinding],
    root_pre_pi: int,
    root_post_pi: int,
    bw: Optional[BindingWitness],
    pi_words: Optional[List[int]],
) -> None:
    """Emit the whole binding section: len(pi_bindings) sequential account
    updates chained root_pre -> ... -> root_post (state-root PI words,
    LE-packed 32-byte roots)."""
    em = BindingEmitter(k, shape)
    n = len(pi_bindings)
    if bw is not None:
        assert len(bw.updates) == n, "witness/binding role count mismatch"
    root_in = k.load_pi(
        root_pre_pi, pi_words[root_pre_pi] if pi_words is not None else None
    )
    root_out_final = k.load_pi(
        root_post_pi, pi_words[root_post_pi] if pi_words is not None else None
    )
    for u, pib in enumerate(pi_bindings):
        last = u == n - 1
        if last:
            root_out = root_out_final
        else:
            root_out = k.wit(
                lambda u=u: le_word(bw.updates[u].root_post)
            )
        em.update(
            bw.updates[u] if bw is not None else None,
            root_in,
            root_out,
            pib,
            pi_words,
        )
        root_in = root_out
