"""FRI verifier — host-side, exact python-int arithmetic.

Counterpart: ethproof_tpu/fri/verify.py:1 (a copy, on the port's own host
Poseidon and proof dataclasses).

Reference equivalent: plonky2 `fri::verifier`. Verification is O(num_queries * log n)
scalar work — pointer-light host code, deliberately independent of the
device kernels it checks (different arithmetic substrate: python bigints
vs int64-tensor limb math), so it doubles as an end-to-end oracle for tests.

Returns the per-query round-0 openings so the STARK layer can cross-check
the committed codeword against recomputed constraint combinations.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..gf import field_host as fh
from ..hash import poseidon
from .challenger import Challenger
from .config import FriConfig
from .prove import FriProof, pow_response

P = fh.P
W = 7  # extension x^2 = 7
_INV2 = fh.inv(2)

Ext = Tuple[int, int]


def ext_add(x: Ext, y: Ext) -> Ext:
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def ext_sub(x: Ext, y: Ext) -> Ext:
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def ext_mul(x: Ext, y: Ext) -> Ext:
    return (
        (x[0] * y[0] + W * x[1] * y[1]) % P,
        (x[0] * y[1] + x[1] * y[0]) % P,
    )


def ext_scale(x: Ext, s: int) -> Ext:
    return (x[0] * s % P, x[1] * s % P)


def _verify_merkle(
    leaf_elems: List[int],
    index: int,
    path: np.ndarray,
    cap: np.ndarray,
    expected_path_len: "int | None" = None,
    digest: "List[int] | None" = None,
) -> bool:
    """Structural violations (wrong cap/path shape, index out of range)
    return False rather than raising — adversarial proofs must never
    crash the verifier. `digest`, when given, is the leaf's digest
    (`tree_digest` of `leaf_elems`) computed by the caller."""
    cap = np.asarray(cap)
    if cap.ndim != 2 or cap.shape[0] != 4 or cap.shape[1] == 0:
        return False
    cap_w = int(cap.shape[1])
    if cap_w & (cap_w - 1):
        return False
    path = np.asarray(path)
    if path.ndim != 2 or path.shape[1] != 4:
        return False
    if expected_path_len is not None and path.shape[0] != expected_path_len:
        return False
    if not 0 <= index < (cap_w << int(path.shape[0])):
        return False
    if digest is None:
        digest = poseidon.tree_digest_host(leaf_elems)
    idx = index
    for lvl in range(path.shape[0]):
        sib = [int(v) for v in path[lvl]]
        if idx & 1:
            digest = poseidon.two_to_one_host(sib, digest)
        else:
            digest = poseidon.two_to_one_host(digest, sib)
        idx >>= 1
    return digest == [int(v) for v in cap[:, idx]]


def fri_verify(
    proof: FriProof,
    config: FriConfig,
    challenger: Challenger,
) -> Tuple[bool, List[Tuple[int, Ext]]]:
    """-> (ok, [(index_0, opened c_0 value)] per query).

    `challenger` must be in the same state the prover's was when fri_prove
    began (i.e. after all prior STARK observations).
    """
    degree_bits = proof.degree_bits
    arities = config.reduction_arity_bits(degree_bits)
    if len(proof.commit_caps) != len(arities) or len(proof.query_rounds) != len(arities):
        return False, []

    # --- replay transcript ---
    betas: List[Ext] = []
    for cap in proof.commit_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())
    for c in proof.final_poly:
        challenger.observe_extension((int(c[0]), int(c[1])))
    pow_challenge = challenger.get_challenge()
    resp = pow_response(pow_challenge, proof.pow_witness)
    if config.proof_of_work_bits and resp >= 1 << (64 - config.proof_of_work_bits):
        return False, []
    challenger.observe_element(resp)
    lde_bits = degree_bits + config.rate_bits
    lde_size = 1 << lde_bits
    indices = [challenger.get_challenge() % lde_size for _ in range(config.num_query_rounds)]

    expected_final_len = 1 << max(degree_bits - sum(arities), 0)
    if proof.final_poly.shape[0] != expected_final_len:
        return False, []

    first_openings: List[Tuple[int, Ext]] = []
    for q, i0 in enumerate(indices):
        idx = i0
        log_m = lde_bits
        shift = config.coset_shift
        prev_fold: Ext | None = None
        for r, a_bits in enumerate(arities):
            arity = 1 << a_bits
            m = 1 << log_m
            leaves = m // arity
            j = idx % leaves
            qr = proof.query_rounds[r]
            if qr.leaf_values.ndim != 3 or qr.leaf_values.shape[1:] != (arity, 2):
                return False, []
            if qr.leaf_values.shape[0] <= q or qr.merkle_paths.shape[0] <= q:
                return False, []
            vals = qr.leaf_values[q]  # (arity, 2)
            w = [(int(vals[k, 0]), int(vals[k, 1])) for k in range(arity)]
            # leaf row layout: [a_0, b_0, a_1, b_1, ...]
            leaf_elems = [x for v in w for x in v]
            exp_len = max(leaves.bit_length() - 1 - config.cap_height, 0)
            if not _verify_merkle(
                leaf_elems, j, qr.merkle_paths[q], proof.commit_caps[r], exp_len
            ):
                return False, []
            # cross-round consistency: this leaf must contain the previous fold
            k_here = idx // leaves
            if r == 0:
                first_openings.append((i0, w[k_here]))
            elif w[k_here] != prev_fold:
                return False, []
            # fold a_bits radix-2 steps within the coset
            beta = betas[r]
            g = fh.primitive_root_of_unity(log_m)
            s, gg, A = shift, g, arity
            cur = w
            while A > 1:
                half = A // 2
                nxt = []
                for k in range(half):
                    i_k = j + k * leaves
                    x = s * pow(gg, i_k, P) % P
                    e = ext_add(cur[k], cur[k + half])
                    d = ext_sub(cur[k], cur[k + half])
                    o = ext_scale(d, fh.inv(x))
                    f = ext_add(e, ext_mul(beta, o))
                    nxt.append(ext_scale(f, _INV2))
                cur = nxt
                beta = ext_mul(beta, beta)
                s = s * s % P
                gg = gg * gg % P
                A = half
            prev_fold = cur[0]
            idx = j
            log_m -= a_bits
            for _ in range(a_bits):
                shift = shift * shift % P
        # final polynomial evaluation at the surviving index
        g_fin = fh.primitive_root_of_unity(log_m)
        x = shift * pow(g_fin, idx, P) % P
        acc: Ext = (0, 0)
        for c in reversed(proof.final_poly):
            acc = ext_add(ext_mul(acc, (x, 0)), (int(c[0]), int(c[1])))
        if not arities:
            # no folding round (degree_bits <= final_poly_bits): the final
            # polynomial is the whole codeword's, and its value at the query
            # is what the caller checks against the oracles' openings (the
            # counterpart compares it with an absent fold and rejects every
            # such proof)
            first_openings.append((i0, acc))
        elif acc != prev_fold:
            return False, []
    return True, first_openings
