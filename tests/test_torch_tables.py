"""The transfer's tables and their cross-table wiring: the port vs the JAX package.

For the CPU, Arithmetic, Logic and BytePacking tables: the port's trace
generator equals the JAX one on the same seeded requests. For those and the
Keccak and KeccakSponge tables, the port's constraint sweep
(`stark.prove._sweep`, the direct evaluation of the table's `eval` plus its
CTL and logUp constraints) equals the JAX
direct-evaluation sweep (`_sweep_jit(..., use_jit=False)`,
ethproof_tpu/stark/prove.py:735) on the same seeded LDE columns at 2^4-2^5
rows. The CTL instances and labels of `stark.multi._instances_for_table`
equal the JAX ones for every table of the five-table wiring and of the
seven-table wiring of a kernel that hashes (the bound transfer kernel).
Exact u64 equality throughout.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ethproof_tpu.evm import binding as jbd
from ethproof_tpu.evm import transfer as jtr
from ethproof_tpu.gf import field as jgf
from ethproof_tpu.stark import multi as jmulti
from ethproof_tpu.stark import prove as jprove
from ethproof_tpu.tables import all as jall
from ethproof_tpu.tables import arithmetic as jar
from ethproof_tpu.tables import bytepacking as jbp
from ethproof_tpu.tables import cpu as jcpu
from ethproof_tpu.tables import keccak as jkc
from ethproof_tpu.tables import keccak_sponge as jks
from ethproof_tpu.tables import logic as jlg
from ethproof_tpu_torch.evm import binding as tbd
from ethproof_tpu_torch.evm import transfer as ttr
from ethproof_tpu_torch.gf import field as tgf
from ethproof_tpu_torch.stark import multi as tmulti
from ethproof_tpu_torch.stark import prove as tprove
from ethproof_tpu_torch.tables import all as tall
from ethproof_tpu_torch.tables import arithmetic as tar
from ethproof_tpu_torch.tables import bytepacking as tbp
from ethproof_tpu_torch.tables import cpu as tcpu
from ethproof_tpu_torch.tables import keccak as tkc
from ethproof_tpu_torch.tables import keccak_sponge as tks
from ethproof_tpu_torch.tables import logic as tlg
from ethproof_tpu_torch.witness import synthetic
from test_transfer_e2e import make_transfer_witness

# one intra-op thread: the suite runs several pytest workers on few cores
torch.set_num_threads(1)

P = jgf.P
RATE_BITS = 2
SHIFT = 7
NUM_CHALLENGES = 2
# table index in tables.all order
TABLES = {"cpu": 0, "arithmetic": 1, "logic": 2, "bytepacking": 3, "keccak": 5,
          "keccak_sponge": 6}
SEVEN = ("keccak", "keccak_sponge")  # their CTLs come from the seven-table wiring


def _kernels():
    """(JAX kasm, port kasm, pi words) of the CPU-tier transfer."""
    j_pi, s, r, m = jtr.derive_pi_words(make_transfer_witness())
    t_pi = ttr.derive_pi_words(synthetic.small_transfer())[0]
    assert t_pi == j_pi
    overlap = jtr.overlap_pattern(s, r, m)
    return jtr.build_kernel(overlap, None, j_pi), ttr.build_kernel(overlap, None, t_pi), j_pi


def _bound_cpus():
    """(JAX, port) CpuStark of the CPU-tier transfer's kernel with the
    binding section (levels 3, 10 words per node): a kernel that hashes."""
    j_pi, s, r, m = jtr.derive_pi_words(make_transfer_witness())
    overlap = jtr.overlap_pattern(s, r, m)
    return (jcpu.CpuStark(jtr.build_kernel(overlap, jbd.KernelShape(3, 10)).prog,
                          jtr.NUM_PI_WORDS),
            tcpu.CpuStark(ttr.build_kernel(overlap, tbd.KernelShape(3, 10)).prog,
                          ttr.NUM_PI_WORDS))


def _starks(name):
    if name == "cpu":
        j_k, t_k, _ = _kernels()
        return (jcpu.CpuStark(j_k.prog, jtr.NUM_PI_WORDS),
                tcpu.CpuStark(t_k.prog, ttr.NUM_PI_WORDS))
    mod = {"arithmetic": (jar, tar, "ArithmeticStark"), "logic": (jlg, tlg, "LogicStark"),
           "bytepacking": (jbp, tbp, "BytePackingStark"), "keccak": (jkc, tkc, "KeccakStark"),
           "keccak_sponge": (jks, tks, "KeccakSpongeStark")}[name]
    return getattr(mod[0], mod[2])(), getattr(mod[1], mod[2])()


def _word(rng, bits=256):
    return int.from_bytes(rng.bytes(bits // 8), "little")


def _mem_ops(ops):
    return [(op.key, op.is_read, op.value) for op in ops]


# -- trace generators --------------------------------------------------------------


def test_cpu_trace_equals_reference():
    j_k, t_k, pi = _kernels()
    assert [dataclasses.astuple(i) for i in t_k.prog] == [dataclasses.astuple(i) for i in j_k.prog]
    assert t_k.witness == j_k.witness
    want = jcpu.execute(j_k.prog, pi, 32, witness=j_k.witness)
    got = tcpu.execute(t_k.prog, pi, 32, witness=t_k.witness)
    np.testing.assert_array_equal(got.trace, want.trace)
    assert _mem_ops(got.mem_ops) == _mem_ops(want.mem_ops)
    assert got.arith_requests == want.arith_requests
    assert got.logic_requests == want.logic_requests
    assert tcpu.pi_limbs(pi) == jcpu.pi_limbs(pi)
    np.testing.assert_array_equal(
        tcpu.CpuStark(t_k.prog, ttr.NUM_PI_WORDS).fixed_columns(32),
        jcpu.CpuStark(j_k.prog, jtr.NUM_PI_WORDS).fixed_columns(32))


def test_arithmetic_trace_equals_reference():
    """Three seeded full-width requests of every op, at the production
    table height 2^16 (the 16-bit range table needs it for 256-bit values)."""
    rng = np.random.default_rng(11)
    reqs = []
    for op in jar.ALL_OPS:
        for _ in range(3):
            a, b = _word(rng), _word(rng)
            if op in (jar.OP_SHR, jar.OP_SHL, jar.OP_SAR):
                b = int(rng.integers(0, 300))
            elif op in (jar.OP_BYTE, jar.OP_SEXT):
                b = int(rng.integers(0, 40))
            elif op in (jar.OP_DIV, jar.OP_MOD):
                b = _word(rng, 128)
            reqs.append((op, a, b, _word(rng, 200)) if op in (jar.OP_ADDMOD, jar.OP_MULMOD)
                        else (op, a, b))
    reqs.append((jar.OP_DIV, _word(rng), 0))  # EVM: x / 0 = 0
    want, want_res = jar.generate_trace(reqs, 1 << 16)
    got, got_res = tar.generate_trace(reqs, 1 << 16)
    assert got_res == want_res
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tar.ArithmeticStark().fixed_columns(1 << 16),
                                  jar.ArithmeticStark().fixed_columns(1 << 16))


def test_logic_trace_equals_reference():
    rng = np.random.default_rng(12)
    reqs = [(op, _word(rng), _word(rng)) for op in (jlg.OP_AND, jlg.OP_OR, jlg.OP_XOR)
            for _ in range(4)]
    want, want_res = jlg.generate_trace(reqs, 16)
    got, got_res = tlg.generate_trace(reqs, 16)
    assert got_res == want_res
    np.testing.assert_array_equal(got, want)


def test_bytepacking_trace_equals_reference():
    rng = np.random.default_rng(13)
    specs = [(int(rng.integers(0, 2)), int(rng.integers(0, 4)), int(rng.integers(0, 8)),
              int(rng.integers(0, 1 << 20)), int(rng.integers(0, 1 << 20)),
              rng.bytes(int(rng.integers(1, 33)))) for _ in range(10)]
    want, want_ops = jbp.generate_trace([jbp.PackRequest(*s) for s in specs], 256)
    got, got_ops = tbp.generate_trace([tbp.PackRequest(*s) for s in specs], 256)
    np.testing.assert_array_equal(got, want)
    assert _mem_ops(got_ops) == _mem_ops(want_ops)
    np.testing.assert_array_equal(tbp.BytePackingStark().fixed_columns(256),
                                  jbp.BytePackingStark().fixed_columns(256))


# -- CTL wiring ----------------------------------------------------------------------


def _ctls():
    j_k, t_k, _ = _kernels()
    j_cpu = jcpu.CpuStark(j_k.prog, jtr.NUM_PI_WORDS)
    t_cpu = tcpu.CpuStark(t_k.prog, ttr.NUM_PI_WORDS)
    return jall.build_ctls(j_cpu, with_keccak=False), tall.build_ctls(t_cpu, with_keccak=False)


def test_ctl_instances_and_labels_equal_reference():
    j_ctls, t_ctls = _ctls()
    assert repr(t_ctls) == repr(j_ctls)
    rng = np.random.default_rng(14)
    challenges = [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
                  for _ in range(NUM_CHALLENGES)]
    for t in range(5):
        want_inst, want_labels = jmulti._instances_for_table(t, j_ctls, challenges)
        got_inst, got_labels = tmulti._instances_for_table(t, t_ctls, challenges)
        assert got_labels == want_labels
        assert repr(got_inst) == repr(want_inst)
        assert got_inst, f"table {t} takes part in no CTL"


def _ctls7():
    j_cpu, t_cpu = _bound_cpus()
    assert j_cpu.uses_sponge and t_cpu.uses_sponge
    return jall.build_ctls(j_cpu, with_keccak=True), tall.build_ctls(t_cpu, with_keccak=True)


def test_build_ctls_with_keccak_names_the_next_slice():
    """The seven-table wiring of a kernel that hashes: CTLs, instances and
    labels of every table equal the reference's."""
    j_ctls, t_ctls = _ctls7()
    assert len(t_ctls) == 7
    assert repr(t_ctls) == repr(j_ctls)
    rng = np.random.default_rng(15)
    challenges = [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
                  for _ in range(NUM_CHALLENGES)]
    for t in range(7):
        want_inst, want_labels = jmulti._instances_for_table(t, j_ctls, challenges)
        got_inst, got_labels = tmulti._instances_for_table(t, t_ctls, challenges)
        assert got_labels == want_labels
        assert repr(got_inst) == repr(want_inst)
        assert got_inst, f"table {t} takes part in no CTL"


# -- constraint sweep ----------------------------------------------------------------


def _reference_sweep(stark, trace, fixed, aux, instances, totals, lookup_alphas, pis,
                     alphas, log_n):
    def words(vals):
        return jgf.from_u64(np.asarray([int(v) % P for v in vals], dtype=np.uint64))

    sweep = jprove._sweep_jit(
        stark, tuple(i.spec for i in instances), log_n, RATE_BITS, SHIFT, NUM_CHALLENGES,
        len(instances), len(lookup_alphas), fixed is not None, aux is not None, use_jit=False)
    lo, hi = sweep(
        jgf.from_u64(trace), None if fixed is None else jgf.from_u64(fixed),
        None if aux is None else jgf.from_u64(aux),
        words(alphas), words(pis), words(lookup_alphas or [0]), words([0]),
        words([i.beta for i in instances] or [0]), words([i.gamma for i in instances] or [0]),
        words(totals or [0]))
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


@pytest.mark.parametrize("name", TABLES)
def test_quotient_sweep_equals_reference(monkeypatch, name):
    """Seeded LDE columns (trace, fixed and aux), the table's CTL instances
    from the five-table wiring (the seven-table one for the Keccak pair),
    seeded challenges, CTL totals and public inputs: both sweeps give the
    same accumulators, bit for bit."""
    monkeypatch.setattr(jgf, "_inv_jit", jgf._inv_impl)
    j_stark, t_stark = _starks(name)
    t = TABLES[name]
    log_n = 5 if name == "cpu" else 4
    m = 1 << (log_n + RATE_BITS)
    rng = np.random.default_rng(20 + t)

    def rand(*shape):
        return rng.integers(0, P, size=shape, dtype=np.uint64)

    challenges = [tuple(int(v) for v in rand(2)) for _ in range(NUM_CHALLENGES)]
    j_ctls, t_ctls = _ctls7() if name in SEVEN else _ctls()
    j_inst, _ = jmulti._instances_for_table(t, j_ctls, challenges)
    t_inst, _ = tmulti._instances_for_table(t, t_ctls, challenges)
    lookup_alphas = [int(v) for v in rand(NUM_CHALLENGES)] if t_stark.lookups else []
    n_aux = len(t_inst) + sum(
        (len(s.looking_cols) + 2) * len(lookup_alphas) for s in t_stark.lookups)
    trace = rand(t_stark.num_columns, m)
    fixed = rand(t_stark.num_fixed_columns, m) if t_stark.num_fixed_columns else None
    aux = rand(n_aux, m) if n_aux else None
    totals = [int(v) for v in rand(len(t_inst))]
    pis = [int(v) for v in rand(t_stark.num_public_inputs)]
    alphas = [int(v) for v in rand(NUM_CHALLENGES)]

    want = _reference_sweep(j_stark, trace, fixed, aux, j_inst, totals, lookup_alphas, pis,
                            alphas, log_n)

    def dev(x):  # one domain block: the prover's layout without a mesh
        return None if x is None else [tgf.from_u64(x, "cpu")]

    (got,) = tprove._sweep(t_stark, dev(trace), dev(fixed), dev(aux), t_inst, totals,
                           lookup_alphas, pis, alphas, log_n, RATE_BITS, SHIFT)
    assert len(got) == NUM_CHALLENGES
    np.testing.assert_array_equal(np.stack([tgf.to_u64(a) for a in got]), want)
