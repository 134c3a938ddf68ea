"""Compile the STARK verifier into a verifier-machine circuit.

Counterpart: ethproof_tpu/recursion/verifier_circuit.py:1 (a copy). The
child's vkey comes from the port's `stark.prove.fixed_cap`, which commits
on a device: `add_stark_verify` and `compile_stark_verifier` take
`device` (None: the CUDA card) for it.

Reference equivalent: plonky2's recursive verifier circuits — the shrink /
root / aggregation / block ladder built by `AllRecursiveCircuits`
(common/src/prover_state/circuit.rs:200-206, executed via
generate_*_proof at ops/src/lib.rs:52-101). The TPU
re-design compiles `stark.verify`'s exact checks into the uniform-row
machine (recursion/machine.py):

- transcript replay: an in-circuit Poseidon duplex challenger whose
  buffer mechanics are compile-time (only the permutations cost rows);
- constraint identity at zeta: the child's OWN `Stark.eval` is traced
  with `CircuitExtOps`, so there is no hand-maintained in-circuit copy
  of any table's constraints;
- FRI: per-query Merkle openings (dynamic index bits via hints +
  bool/canonicity constraints), arity folds with witnessed inverses,
  PoW grind check, final-poly evaluation.

Proof data enters as external witness wires allocated in one
deterministic emission order; `VerifierCompiler.stream` replays the same
order against a concrete proof at fill time, so the circuit and its
witness can never drift apart.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

from ..fri.config import StarkConfig
from ..gf import field_host as fh
from ..hash import constants as C
from ..stark.stark import (
    Stark,
    lookup_aux_count,
)
from .circuit import CBuilder, Circuit, Ext, Wire
from .ops_circuit import CircuitExtOps

P = fh.P
_INV2 = fh.inv(2)


# -- compiler: external-input bookkeeping ------------------------------------


class VerifierCompiler:
    """CBuilder + an ordered accessor list for external witness wires.

    Every proof element the circuit consumes is allocated through `inp`,
    recording `fn(fill_ctx) -> int` at the same position the wire takes
    in the witness stream (circuit.interpret consumes unhinted G_WIT
    gates in emission order)."""

    def __init__(self, b: Optional[CBuilder] = None):
        self.b = b or CBuilder()
        self.accessors: List[Callable] = []

    def inp(self, fn: Callable, label: str = "") -> Wire:
        w = self.b.wit(label)
        self.accessors.append(fn)
        return w

    def inp_ext(self, fn: Callable, label: str = "") -> Ext:
        return (
            self.inp(lambda ctx, f=fn: f(ctx)[0], label + ".a"),
            self.inp(lambda ctx, f=fn: f(ctx)[1], label + ".b"),
        )

    def inp_cap(self, fn: Callable, cap_height: int, label: str = "") -> List[List[Wire]]:
        """Merkle cap as 2^cap_height digests of 4 wires. fn(ctx) -> (4, w)
        u64 array."""
        out = []
        for i in range(1 << cap_height):
            out.append(
                [
                    self.inp(
                        lambda ctx, f=fn, r=r, i=i: int(f(ctx)[r, i]),
                        f"{label}[{i}][{r}]",
                    )
                    for r in range(4)
                ]
            )
        return out

    def stream(self, ctx) -> List[int]:
        """The external witness stream for `circuit.interpret`."""
        return [int(f(ctx)) % P for f in self.accessors]


# -- in-circuit challenger ---------------------------------------------------


class CircuitChallenger:
    """Wire-level mirror of fri/challenger.py (Poseidon duplex sponge).

    Buffer counts are static, so only the duplex permutations emit rows;
    all bookkeeping happens at compile time."""

    RATE = 8
    WIDTH = C.WIDTH

    def __init__(self, b: CBuilder):
        self.b = b
        zero = b.const(0)
        self.state: List[Wire] = [zero] * self.WIDTH
        self.input_buffer: List[Wire] = []
        self.output_buffer: List[Wire] = []

    def observe(self, w: Wire) -> None:
        self.output_buffer.clear()
        self.input_buffer.append(w)
        if len(self.input_buffer) == self.RATE:
            self._duplex()

    def observe_many(self, ws: Sequence[Wire]) -> None:
        for w in ws:
            self.observe(w)

    def observe_ext(self, e: Ext) -> None:
        self.observe(e[0])
        self.observe(e[1])

    def observe_cap(self, cap: List[List[Wire]]) -> None:
        for digest in cap:
            self.observe_many(digest)

    def get_challenge(self) -> Wire:
        if self.input_buffer or not self.output_buffer:
            self._duplex()
        return self.output_buffer.pop()

    def get_ext(self) -> Ext:
        return (self.get_challenge(), self.get_challenge())

    def _duplex(self) -> None:
        st = list(self.state)
        for i, w in enumerate(self.input_buffer):
            st[i] = w
        self.input_buffer.clear()
        st = self.b.poseidon(st, label="duplex")
        self.state = st
        self.output_buffer = list(st[: self.RATE])


# -- hash / merkle gadgets ---------------------------------------------------


def two_to_one(b: CBuilder, left: List[Wire], right: List[Wire]) -> List[Wire]:
    zero = b.const(0)
    return b.poseidon(list(left) + list(right) + [zero] * 4)[:4]


def tree_digest(b: CBuilder, elems: List[Wire]) -> List[Wire]:
    """Wire mirror of poseidon.tree_digest_host (balanced two_to_one tree
    over 4-element groups)."""
    zero = b.const(0)
    if len(elems) <= 4:
        return list(elems) + [zero] * (4 - len(elems))
    k = (len(elems) + 3) // 4
    xs = list(elems) + [zero] * (4 * k - len(elems))
    ds = [xs[4 * i : 4 * i + 4] for i in range(k)]
    while len(ds) > 1:
        half = len(ds) // 2
        nxt = [two_to_one(b, ds[i], ds[half + i]) for i in range(half)]
        if len(ds) & 1:
            nxt.append(ds[-1])
        ds = nxt
    return ds[0]


def sponge_hash(b: CBuilder, elems: List[Wire], m: int = 4) -> List[Wire]:
    """Wire mirror of poseidon.hash_n_to_m_no_pad_host (rate-8 absorb)."""
    zero = b.const(0)
    state = [zero] * 12
    for start in range(0, len(elems), 8):
        chunk = elems[start : start + 8]
        state = list(chunk) + state[len(chunk) :]
        state = b.poseidon(state, "sponge")
    return state[:m]


def mux(b: CBuilder, values: List[Wire], bits: List[Wire]) -> Wire:
    """values[idx] for idx given little-endian by `bits` (len 2^len(bits))."""
    cur = list(values)
    for bit in bits:
        cur = [b.select(bit, cur[2 * i + 1], cur[2 * i]) for i in range(len(cur) // 2)]
    assert len(cur) == 1
    return cur[0]


def mux_vec(b: CBuilder, rows: List[List[Wire]], bits: List[Wire]) -> List[Wire]:
    return [mux(b, [r[i] for r in rows], bits) for i in range(len(rows[0]))]


def mux_ext(b: CBuilder, values: List[Ext], bits: List[Wire]) -> Ext:
    r = mux_vec(b, [[v[0], v[1]] for v in values], bits)
    return (r[0], r[1])


def merkle_assert(
    b: CBuilder,
    leaf_elems: List[Wire],
    idx_bits: List[Wire],
    path: List[List[Wire]],
    cap: List[List[Wire]],
    label: str = "merkle",
) -> None:
    """Constrain a Merkle opening: leaf at dynamic index -> cap entry.

    idx_bits: little-endian; len == len(path) + cap_height. Mirrors
    fri/verify._verify_merkle's walk."""
    digest = tree_digest(b, leaf_elems)
    for lvl, sib in enumerate(path):
        bit = idx_bits[lvl]  # 1 => current node is the right child
        left = [b.select(bit, sib[i], digest[i]) for i in range(4)]
        right = [b.select(bit, digest[i], sib[i]) for i in range(4)]
        digest = two_to_one(b, left, right)
    cap_bits = idx_bits[len(path) :]
    entry = mux_vec(b, cap, cap_bits)
    for i in range(4):
        b.assert_eq(digest[i], entry[i], label=f"{label}.cap[{i}]")


def pow_from_bits(b: CBuilder, base: int, bits: List[Wire]) -> Wire:
    """base^idx for dynamic idx (little-endian bits), base a constant."""
    one = b.const(1)
    acc = one
    cur = base % P
    for bit in bits:
        acc = b.mul(acc, b.select(bit, b.const(cur), one))
        cur = cur * cur % P
    return acc


# -- ext helpers on wires ----------------------------------------------------


def ext_pow2k(b: CBuilder, x: Ext, k: int) -> Ext:
    for _ in range(k):
        x = b.ext_mul(x, x)
    return x


def ext_horner(b: CBuilder, coeffs: List[Ext], x: Ext) -> Ext:
    acc = b.ext_const((0, 0))
    for c in reversed(coeffs):
        acc = b.ext_add(b.ext_mul(acc, x), c)
    return acc


def base_to_ext(b: CBuilder, w: Wire) -> Ext:
    return (w, b.const(0))


# -- the compiled verifier ---------------------------------------------------


@dataclass
class StarkVerifyWires:
    """Wires of interest produced by add_stark_verify."""

    ctl_totals: List[Wire]  # base-field total wires (for multi cross-check)


def add_stark_verify(
    vc: VerifierCompiler,
    stark: Stark,
    log_n: int,
    config: StarkConfig,
    ch: CircuitChallenger,
    pis: List[Wire],
    proof_of: Callable,
    ctl_specs_with_challenges: Optional[List[Tuple]] = None,
    fixed_cap: Optional[List[List[Wire]]] = None,
    trace_cap: Optional[List[List[Wire]]] = None,
    device=None,
) -> StarkVerifyWires:
    """Emit gates that verify one StarkProof of `stark` at degree 2^log_n.

    proof_of(fill_ctx) -> the StarkProof (identity for standalone proofs,
    a table selector for multi-proofs). `pis` are the public-input wires
    (caller-supplied — typically themselves witnessed and then bound to
    the outer statement). ctl_specs_with_challenges: list of (spec,
    beta_ext, gamma_ext) with challenge wires drawn by the caller
    (mirrors multi.py's _instances_for_table ordering).

    fixed_cap: the child's vkey as wires — constants for a fixed child
    circuit, or caller-routed wires for vkey-as-public-input (cyclic)
    schemes. None => computed as constants from the stark itself, committed
    on `device` (None: the CUDA card).
    """
    b = vc.b
    fri_cfg = config.fri_config
    n = 1 << log_n
    rate_bits = fri_cfg.rate_bits
    lde_bits = log_n + rate_bits
    shift = fri_cfg.coset_shift
    cols = stark.num_columns
    nc = config.num_challenges
    spec_ch = ctl_specs_with_challenges or []
    k_ctl = len(spec_ch)
    chunks = stark.quotient_chunks(bool(spec_ch))
    zero = b.const(0)

    def pf(f):  # lift a StarkProof accessor to a fill-ctx accessor
        return lambda ctx, f=f: f(proof_of(ctx))

    # --- transcript replay ---
    ch.observe_many(pis)
    ch.observe(b.const(log_n))
    if stark.num_fixed_columns:
        if fixed_cap is None:
            from ..stark.prove import fixed_cap as _fixed_cap

            vk = _fixed_cap(stark, n, config, device)
            fixed_cap = [
                [b.const(int(vk[r, i])) for r in range(4)]
                for i in range(vk.shape[1])
            ]
        ch.observe_cap(fixed_cap)
    if trace_cap is None:
        # multi-proof pre-phases allocate + pass the cap wires themselves
        trace_cap = vc.inp_cap(
            pf(lambda p: p.trace_cap), fri_cfg.cap_height, "trace_cap"
        )
    ch.observe_cap(trace_cap)

    lookup_alphas: List[Wire] = []
    if stark.lookups:
        lookup_alphas = [ch.get_challenge() for _ in range(nc)]
    aux_challenges = [ch.get_challenge() for _ in range(stark.num_aux_challenges(nc))]
    k_lookup = sum(lookup_aux_count(s) for s in stark.lookups) * nc
    k_custom = stark.num_custom_aux(nc)
    k_aux = k_ctl + k_lookup + k_custom
    k_fixed = stark.num_fixed_columns

    ctl_totals: List[Wire] = []
    if k_aux:
        aux_cap = vc.inp_cap(pf(lambda p: p.aux_cap), fri_cfg.cap_height, "aux_cap")
        ch.observe_cap(aux_cap)
        if spec_ch:
            ctl_totals = [
                vc.inp(pf(lambda p, k=k: int(p.ctl_totals[k])), f"ctl_total[{k}]")
                for k in range(k_ctl)
            ]
            ch.observe_many(ctl_totals)
    alphas = [ch.get_challenge() for _ in range(nc)]
    quotient_cap = vc.inp_cap(pf(lambda p: p.quotient_cap), fri_cfg.cap_height, "q_cap")
    ch.observe_cap(quotient_cap)
    zeta = ch.get_ext()

    # openings (allocation + observation order == StarkOpenings.transcript_elements)
    def open_arr(name: str, count: int) -> List[Ext]:
        return [
            vc.inp_ext(
                pf(lambda p, name=name, i=i: [
                    int(v) for v in getattr(p.openings, name)[i]
                ]),
                f"{name}[{i}]",
            )
            for i in range(count)
        ]

    trace_z = open_arr("trace_at_zeta", cols)
    trace_gz = open_arr("trace_at_gzeta", cols)
    fixed_z = open_arr("fixed_at_zeta", k_fixed)
    fixed_gz = open_arr("fixed_at_gzeta", k_fixed)
    aux_z = open_arr("aux_at_zeta", k_aux)
    aux_gz = open_arr("aux_at_gzeta", k_aux)
    quot_z = open_arr("quotient_at_zeta", nc * chunks)
    for grp in (trace_z, trace_gz, fixed_z, fixed_gz, aux_z, aux_gz, quot_z):
        for e in grp:
            ch.observe_ext(e)
    fri_alpha = ch.get_ext()

    # --- constraint identity at zeta ---
    ops = CircuitExtOps(b)
    one_ext = b.ext_const((1, 0))
    zeta_n = ext_pow2k(b, zeta, log_n)
    zh = b.ext_sub(zeta_n, one_ext)
    g_h = fh.primitive_root_of_unity(log_n)
    g_last = fh.inv(g_h)
    n_inv = fh.inv(n)
    z_last = b.ext_sub(zeta, b.ext_const((g_last, 0)))
    l_first = b.ext_mulc(
        n_inv, b.ext_mul(zh, b.ext_inverse(b.ext_sub(zeta, one_ext), "l_first"))
    )
    l_last = b.ext_mulc(
        g_last * n_inv % P, b.ext_mul(zh, b.ext_inverse(z_last, "l_last"))
    )
    alphas_ext = [base_to_ext(b, a) for a in alphas]
    pis_ext = [base_to_ext(b, w) for w in pis]
    # replay the recorded constraint program (stark/ir.py) on wire pairs
    # — the identical expression the prover swept and the host verifier
    # replays, now compiled into gates with record-time CSE
    from ..stark.ir import replay_accs

    accs = replay_accs(
        stark, tuple(spec for (spec, _b, _g) in spec_ch), ops, nc,
        local=trace_z, nxt=trace_gz, fixed_l=fixed_z, fixed_n=fixed_gz,
        aux_l=aux_z, aux_n=aux_gz, pis=pis_ext,
        alphas=alphas_ext,
        lookup_alphas=[base_to_ext(b, a) for a in lookup_alphas],
        aux_challenges=[base_to_ext(b, c) for c in aux_challenges],
        betas=[beta for (_s, beta, _g) in spec_ch],
        gammas=[gamma for (_s, _b2, gamma) in spec_ch],
        totals=[base_to_ext(b, t) for t in ctl_totals],
        z_last=z_last, l_first=l_first, l_last=l_last,
    )
    for ai in range(nc):
        q_acc = b.ext_const((0, 0))
        zpow = one_ext
        for c in range(chunks):
            q_acc = b.ext_add(q_acc, b.ext_mul(zpow, quot_z[ai * chunks + c]))
            zpow = b.ext_mul(zpow, zeta_n)
        b.ext_assert_eq(
            accs[ai], b.ext_mul(zh, q_acc), f"quotient-identity[{ai}]"
        )

    # --- FRI transcript ---
    arities = fri_cfg.reduction_arity_bits(log_n)
    fri_caps: List[List[List[Wire]]] = []
    betas: List[Ext] = []
    for r in range(len(arities)):
        cap = vc.inp_cap(
            pf(lambda p, r=r: p.fri_proof.commit_caps[r]),
            fri_cfg.cap_height,
            f"fri_cap[{r}]",
        )
        ch.observe_cap(cap)
        fri_caps.append(cap)
        betas.append(ch.get_ext())
    final_len = 1 << max(log_n - sum(arities), 0)
    final_poly = [
        vc.inp_ext(
            pf(lambda p, i=i: [int(v) for v in p.fri_proof.final_poly[i]]),
            f"final[{i}]",
        )
        for i in range(final_len)
    ]
    for e in final_poly:
        ch.observe_ext(e)
    pow_challenge = ch.get_challenge()
    pow_witness = vc.inp(pf(lambda p: p.fri_proof.pow_witness), "pow_witness")
    resp = b.poseidon([pow_challenge, pow_witness] + [zero] * 10, "grind")[0]
    if fri_cfg.proof_of_work_bits:
        rbits = b.decompose_bits(resp, 64)
        for i in range(64 - fri_cfg.proof_of_work_bits, 64):
            b.assert_zero(rbits[i], f"pow-bit{i}")
    ch.observe(resp)
    all_idx_bits: List[List[Wire]] = []
    for q in range(fri_cfg.num_query_rounds):
        chq = ch.get_challenge()
        qbits = b.decompose_bits(chq, 64)
        all_idx_bits.append(qbits[:lde_bits])

    # --- DEEP y0/y1 (query-independent) ---
    open0 = trace_z + fixed_z + aux_z + quot_z
    open1 = trace_gz + fixed_gz + aux_gz
    K, L = len(open0), len(open1)
    a_pows: List[Ext] = [one_ext]
    for _ in range(K + L - 1):
        a_pows.append(b.ext_mul(a_pows[-1], fri_alpha))
    y0 = b.ext_const((0, 0))
    for wgt, y in zip(a_pows[:K], open0):
        y0 = b.ext_add(y0, b.ext_mul(wgt, y))
    y1 = b.ext_const((0, 0))
    for wgt, y in zip(a_pows[K:], open1):
        y1 = b.ext_add(y1, b.ext_mul(wgt, y))
    gzeta = (b.mulc(g_h, zeta[0]), b.mulc(g_h, zeta[1]))
    w_root = fh.primitive_root_of_unity(lde_bits)
    path_len = max(lde_bits - fri_cfg.cap_height, 0)

    # --- per-query checks ---
    for q in range(fri_cfg.num_query_rounds):
        bits = all_idx_bits[q]

        def leaf(name: str, count: int) -> List[Wire]:
            return [
                vc.inp(
                    pf(
                        lambda p, name=name, q=q, i=i: int(
                            getattr(p, name).values[q][i]
                        )
                    ),
                    f"{name}[{q}][{i}]",
                )
                for i in range(count)
            ]

        def opath(name: str) -> List[List[Wire]]:
            return [
                [
                    vc.inp(
                        pf(
                            lambda p, name=name, q=q, l=l, r=r: int(
                                getattr(p, name).paths[q][l][r]
                            )
                        ),
                        f"{name}.path[{q}][{l}][{r}]",
                    )
                    for r in range(4)
                ]
                for l in range(path_len)
            ]

        t_leaf = leaf("trace_query_openings", cols)
        merkle_assert(b, t_leaf, bits, opath("trace_query_openings"), trace_cap, "t")
        f_leaf: List[Wire] = []
        if k_fixed:
            f_leaf = leaf("fixed_query_openings", k_fixed)
            merkle_assert(
                b, f_leaf, bits, opath("fixed_query_openings"), fixed_cap, "f"
            )
        a_leaf: List[Wire] = []
        if k_aux:
            a_leaf = leaf("aux_query_openings", k_aux)
            merkle_assert(b, a_leaf, bits, opath("aux_query_openings"), aux_cap, "a")
        q_leaf = leaf("quotient_query_openings", nc * chunks)
        merkle_assert(
            b, q_leaf, bits, opath("quotient_query_openings"), quotient_cap, "q"
        )

        x = b.mulc(shift, pow_from_bits(b, w_root, bits))
        b0 = b.ext_const((0, 0))
        for wgt, v in zip(a_pows[:K], t_leaf + f_leaf + a_leaf + q_leaf):
            b0 = b.ext_add(b0, b.ext_scale(wgt, v))
        b1 = b.ext_const((0, 0))
        for wgt, v in zip(a_pows[K:], t_leaf + f_leaf + a_leaf):
            b1 = b.ext_add(b1, b.ext_scale(wgt, v))
        x_ext = base_to_ext(b, x)
        c0 = b.ext_mul(
            b.ext_sub(b0, y0), b.ext_inverse(b.ext_sub(x_ext, zeta), "deep0")
        )
        c1 = b.ext_mul(
            b.ext_sub(b1, y1), b.ext_inverse(b.ext_sub(x_ext, gzeta), "deep1")
        )
        comp = b.ext_add(c0, c1)

        # FRI rounds (mirror fri/verify.py's per-query loop)
        cur_bits = bits
        log_m = lde_bits
        s_host = shift
        prev = comp
        for r, a_bits in enumerate(arities):
            arity = 1 << a_bits
            leaves_bits = log_m - a_bits
            j_bits = cur_bits[:leaves_bits]
            k_bits = cur_bits[leaves_bits:]
            lv = [
                vc.inp_ext(
                    pf(
                        lambda p, r=r, q=q, k=k: [
                            int(v) for v in p.fri_proof.query_rounds[r].leaf_values[q][k]
                        ]
                    ),
                    f"fri[{r}][{q}][{k}]",
                )
                for k in range(arity)
            ]
            leaf_elems = [x for v in lv for x in v]
            fr_path_len = max(leaves_bits - fri_cfg.cap_height, 0)
            fr_path = [
                [
                    vc.inp(
                        pf(
                            lambda p, r=r, q=q, l=l, c4=c4: int(
                                p.fri_proof.query_rounds[r].merkle_paths[q][l][c4]
                            )
                        ),
                        f"fri.path[{r}][{q}][{l}][{c4}]",
                    )
                    for c4 in range(4)
                ]
                for l in range(fr_path_len)
            ]
            # pad the cap-select bits with constant zeros at tiny sizes
            sel_bits = j_bits[fr_path_len:]
            sel_bits = sel_bits + [zero] * (fri_cfg.cap_height - len(sel_bits))
            merkle_assert(
                b, leaf_elems, j_bits[:fr_path_len] + sel_bits, fr_path,
                fri_caps[r], f"fri[{r}]",
            )
            opened = mux_ext(b, lv, k_bits)
            b.ext_assert_eq(opened, prev, f"fri-chain[{r}]")
            # fold a_bits radix-2 steps
            beta = betas[r]
            gg = fh.primitive_root_of_unity(log_m)
            sl = s_host
            cur = lv
            A = arity
            while A > 1:
                half = A // 2
                gj = pow_from_bits(b, gg, j_bits)
                nxt = []
                for k in range(half):
                    cgk = pow(gg, k << leaves_bits, P)
                    xk = b.mulc(sl * cgk % P, gj)
                    inv_xk = b.inverse(xk, "fold-inv")
                    e = b.ext_add(cur[k], cur[k + half])
                    d = b.ext_sub(cur[k], cur[k + half])
                    o_ = b.ext_scale(d, inv_xk)
                    f_ = b.ext_add(e, b.ext_mul(beta, o_))
                    nxt.append(b.ext_mulc(_INV2, f_))
                cur = nxt
                beta = b.ext_mul(beta, beta)
                sl = sl * sl % P
                gg = gg * gg % P
                A = half
            prev = cur[0]
            cur_bits = j_bits
            log_m = leaves_bits
            s_host = sl
        g_fin = fh.primitive_root_of_unity(log_m)
        xf = b.mulc(s_host, pow_from_bits(b, g_fin, cur_bits))
        acc = ext_horner(b, final_poly, base_to_ext(b, xf))
        b.ext_assert_eq(acc, prev, "final-poly")

    return StarkVerifyWires(ctl_totals=ctl_totals)


# -- standalone wrap circuit --------------------------------------------------


@dataclass
class CompiledVerifier:
    """A machine circuit that verifies one StarkProof and re-exposes the
    child's public inputs as its own (the shrink/wrap step)."""

    circuit: Circuit
    vc: VerifierCompiler
    child_pi_wires: List[Wire]

    def witness(self, proof) -> List[int]:
        return self.vc.stream(proof)


def compile_stark_verifier(
    stark: Stark, log_n: int, config: StarkConfig, device=None
) -> CompiledVerifier:
    """Circuit verifying one standalone StarkProof (no CTLs). The child's
    public inputs are witnessed, transcript-bound, and re-exposed as this
    circuit's public inputs — so a wrap proof certifies the same
    statement at a size independent of the child's. `device` (None: the
    CUDA card) commits the child's vkey, for a child with fixed columns."""
    vc = VerifierCompiler()
    b = vc.b
    ch = CircuitChallenger(b)
    pis = [
        vc.inp(lambda p, k=k: int(p.public_inputs[k]) % P, f"child_pi[{k}]")
        for k in range(stark.num_public_inputs)
    ]
    add_stark_verify(vc, stark, log_n, config, ch, pis, proof_of=lambda p: p, device=device)
    for k, w in enumerate(pis):
        b.expose(w, k, f"pi[{k}]")
    return CompiledVerifier(circuit=b.build(), vc=vc, child_pi_wires=pis)
