"""[The benchmark's frozen copy of ethproof_tpu_torch/fri/prove.py.]

FRI prover: commit/fold on the device, transcript on the host.

Counterpart: ethproof_tpu/fri/prove.py:45-247 (`FriProof`, `_leaf_rows`,
`_fold_step`, `_pow_hashes`, `grind_pow`, `fri_prove`).

The codeword is a GF2 of int64 tensors in natural domain order (index i
<-> point s * g^i). A commit round with arity A = 2^a builds one Merkle
tree whose leaf j packs the fold coset {j + k * (m/A)}; folding is `a`
radix-2 steps. The proof-of-work grind sweeps candidate witnesses in
batches and returns the smallest that meets the difficulty, whatever the
batch, so proofs match the counterpart's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..gf import extension as gf2
from ..gf import field as gfp
from ..gf import field_host as fh
from ..gf.extension import GF2
from ..hash import merkle, poseidon
from ..poly import transform as four_step
from ..poly import ntt as nttm
from .challenger import Challenger
from .config import FriConfig

_INV2 = fh.inv(2)


@dataclass
class FriQueryRound:
    """Per-commit-round openings for all queries, batched over queries."""

    leaf_values: np.ndarray  # (num_q, arity, 2) u64 — ext elements per coset
    merkle_paths: np.ndarray  # (num_q, path_len, 4) u64


@dataclass
class FriProof:
    commit_caps: List[np.ndarray]  # per round: (4, 2^cap_height) u64
    query_rounds: List[FriQueryRound]
    final_poly: np.ndarray  # (final_len, 2) u64 extension coefficients
    pow_witness: int
    degree_bits: int
    # the sampled codeword indices, so the STARK layer opens its own oracles
    # at the same points (not part of the transcript)
    query_indices: np.ndarray | None = None


def _leaf_rows(code: GF2, arity: int) -> torch.Tensor:
    """Codeword (m,) ext -> Merkle rows (2*arity, m/arity), row layout
    [a_0, b_0, a_1, b_1, ...] for coset members k = 0..arity-1."""
    m = code.a.shape[-1]
    leaves = m // arity
    a = code.a.reshape(arity, leaves)
    b = code.b.reshape(arity, leaves)
    return torch.stack([a, b], dim=1).reshape(2 * arity, leaves)


def _fold_step(code: GF2, beta: GF2, xinv: torch.Tensor) -> GF2:
    """One radix-2 FRI fold m -> m/2 (natural order kept):
    f'(x^2) = (f(x) + f(-x))/2 + beta * (f(x) - f(-x)) / (2x), where point i
    pairs with i + m/2 and xinv[i] = (s g^i)^-1."""
    half = code.a.shape[-1] // 2
    lo_part, hi_part = code[:half], code[half:]
    e = gf2.add(lo_part, hi_part)
    o = gf2.mul_base(gf2.sub(lo_part, hi_part), xinv)
    folded = gf2.add(e, gf2.mul(beta, o))
    inv2 = gfp.full((), _INV2, code.a.device)
    return gf2.mul_base(folded, inv2)


def _half_domain_inverses(shift: int, log_m: int, device) -> torch.Tensor:
    """xinv[i] = (shift * g^i)^-1 for i < 2^(log_m-1)."""
    g_inv = fh.inv(fh.primitive_root_of_unity(log_m))
    return gfp.mul_const(nttm.powers(g_inv, 1 << (log_m - 1), device), fh.inv(shift))


def _pow_hashes(challenge: int, candidates: torch.Tensor) -> torch.Tensor:
    """hash(challenge, w)[0] for a batch of candidate witnesses."""
    ch = gfp.full(candidates.shape, challenge, candidates.device)
    return poseidon.hash_n_to_m_no_pad(torch.stack([ch, candidates]), 1)[0]


def grind_pow(challenge: int, pow_bits: int, batch: int | None = None, device=None) -> int:
    """Smallest w with hash(challenge, w)[0] < 2^(64 - pow_bits)."""
    if pow_bits == 0:
        return 0
    dev = resolve_device(device)
    if batch is None:
        batch = min(1 << (pow_bits + 2), 1 << 15)
    threshold = 1 << (64 - pow_bits)
    base = 0
    while True:
        cand = torch.arange(base, base + batch, dtype=torch.int64, device=dev)
        h = gfp.to_u64(_pow_hashes(challenge, cand))
        ok = np.nonzero(h < np.uint64(threshold))[0]
        if ok.size:
            return base + int(ok[0])
        base += batch


def pow_response(challenge: int, witness: int) -> int:
    return poseidon.hash_n_to_m_no_pad_host([challenge, witness], 1)[0]


def fri_prove(codeword: GF2, degree_bits: int, config: FriConfig,
              challenger: Challenger) -> FriProof:
    """Prove `codeword` (length 2^(degree_bits + rate_bits), natural order
    over the coset shift*H) is the evaluation of a degree < 2^degree_bits
    poly. Runs on the codeword's device."""
    dev = codeword.a.device
    m = codeword.a.shape[-1]
    assert m == 1 << (degree_bits + config.rate_bits)
    arities = config.reduction_arity_bits(degree_bits)
    shift = config.coset_shift
    log_m = degree_bits + config.rate_bits

    caps: List[np.ndarray] = []
    trees = []
    codes = [codeword]
    code = codeword
    for a_bits in arities:
        tree = merkle.build(_leaf_rows(code, 1 << a_bits), config.cap_height)
        trees.append(tree)
        cap = gfp.to_u64(tree.cap)
        caps.append(cap)
        challenger.observe_cap(cap)
        b0, b1 = challenger.get_extension_challenge()
        beta = GF2(gfp.full((), b0, dev), gfp.full((), b1, dev))
        for _ in range(a_bits):
            code = _fold_step(code, beta, _half_domain_inverses(shift, log_m, dev))
            beta = gf2.mul(beta, beta)
            shift = shift * shift % fh.P
            log_m -= 1
        codes.append(code)

    # final polynomial: coset iNTT, keep the low-degree coefficients
    final_len = 1 << (log_m - config.rate_bits)
    coeffs = four_step.best_coset_intt(torch.stack([code.a, code.b]), shift)
    fp = np.ascontiguousarray(gfp.to_u64(coeffs[:, :final_len]).T)
    for c in fp:
        challenger.observe_extension((int(c[0]), int(c[1])))

    pow_challenge = challenger.get_challenge()
    pow_witness = grind_pow(pow_challenge, config.proof_of_work_bits, device=dev)
    challenger.observe_element(pow_response(pow_challenge, pow_witness))

    lde_size = 1 << (degree_bits + config.rate_bits)
    indices = np.array(
        [challenger.get_challenge() % lde_size for _ in range(config.num_query_rounds)],
        dtype=np.int64,
    )

    query_rounds: List[FriQueryRound] = []
    idx = indices
    for r, a_bits in enumerate(arities):
        arity = 1 << a_bits
        leaves = codes[r].a.shape[-1] // arity
        j = idx % leaves
        jj = torch.from_numpy(j).to(dev)
        vals = gfp.to_u64(_leaf_rows(codes[r], arity)[:, jj])  # (2A, num_q)
        leaf_values = np.ascontiguousarray(vals.T).reshape(len(indices), arity, 2)
        paths = np.ascontiguousarray(
            np.transpose(gfp.to_u64(merkle.open_path(trees[r], jj)), (2, 0, 1)))
        query_rounds.append(FriQueryRound(leaf_values, paths))
        idx = j

    return FriProof(
        commit_caps=caps,
        query_rounds=query_rounds,
        final_poly=fp,
        pow_witness=pow_witness,
        degree_bits=degree_bits,
        query_indices=indices,
    )
