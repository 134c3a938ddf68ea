"""Leader-compatible CLI: `rpc`, `prove`, `verify` and `worker`.

Counterpart: ethproof_tpu/cli.py:1, with the same subcommands and flags
and one more, `--device {cuda,cpu}` (default cuda) on `prove`, `verify`
and `worker`: the device the proofs are made or checked on. Without a CUDA
card a command exits non-zero unless it is given `--device cpu`.

  python -m ethproof_tpu_torch.cli rpc -u <url> -t <tx-hash> [--request-miner-from-clique]
  python -m ethproof_tpu_torch.cli prove -i <witness.json> [--runtime {in-memory,distributed}]
      [--num-workers N] [--recursion [--block-wrap]] [--persistence {none,disk}]
      [--<table>-circuit-size A..B] [--device {cuda,cpu}] > proof.json
  python -m ethproof_tpu_torch.cli verify -i <proof.json> [--device {cuda,cpu}]
  python -m ethproof_tpu_torch.cli worker [--leader host:port] [--device {cuda,cpu}]

The witness JSON flows rpc -> file -> prove, the proof JSON to stdout.
Circuit sizes resolve CLI flag -> env var -> default; a `.env` file in the
working directory sets env vars that are not already set.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _load_dotenv() -> None:
    path = os.path.join(os.getcwd(), ".env")
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, _, v = line.partition("=")
            os.environ.setdefault(k.strip(), v.strip())


def _add_circuit_flags(p: argparse.ArgumentParser) -> None:
    from .runtime.prover_state import ENV_KEYS

    for name in ENV_KEYS:
        p.add_argument(
            f"--{name.replace('_', '-')}-circuit-size",
            metavar="A..B",
            help=f"degree-bit range (env {ENV_KEYS[name]})",
        )
    p.add_argument(
        "--persistence",
        choices=["none", "disk"],
        default="disk",
        help="circuit/vkey artifact persistence (default disk)",
    )


def _add_device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="where proofs are made or checked (default cuda: the CUDA card; "
        "cpu runs the plain PyTorch path)",
    )


def _resolve_config(args):
    from .runtime.parsing import parse_range
    from .runtime.prover_state import ENV_KEYS, CircuitConfig

    cfg = CircuitConfig.from_env()
    ranges = dict(cfg.ranges)
    for name in ENV_KEYS:
        flag = getattr(args, f"{name}_circuit_size", None)
        if flag:
            ranges[name] = parse_range(flag)
    return CircuitConfig(ranges)


def cmd_rpc(args) -> int:
    from .runtime.tracing import init_tracing
    from .witness.gather import RpcClient, gather_witness
    from .witness.types import witness_to_json

    init_tracing()
    client = RpcClient(args.rpc_url)
    ir = gather_witness(args.transaction_hash, client, clique=args.request_miner_from_clique)
    json.dump(witness_to_json(ir), sys.stdout)
    return 0


def _parse_addr(s: str) -> tuple:
    host, _, port = s.rpartition(":")
    return (host or "0.0.0.0", int(port))


def cmd_prove(args) -> int:
    from .fri.config import standard_fast_config
    from .runtime import serde
    from .runtime.prover_state import set_prover_state_from_config
    from .runtime.scheduler import Runtime, prove_block
    from .runtime.tracing import init_tracing
    from .witness.types import witness_from_json

    init_tracing()
    config = _resolve_config(args)
    set_prover_state_from_config(config, persistence=args.persistence)
    with open(args.input_witness) as f:
        ir = witness_from_json(json.load(f))

    if args.runtime == "distributed":
        from .runtime.distributed import DistributedRuntime

        runtime = DistributedRuntime(listen=_parse_addr(args.listen))
        print(
            f"leader: listening on {runtime.address}, waiting for "
            f"{args.num_workers} worker(s)",
            file=sys.stderr,
        )
        runtime.wait_for_workers(args.num_workers)
    else:
        runtime = Runtime(num_workers=args.num_workers)
    binding_shape = None
    if args.recursion:
        # succinct mode fixes the transfer kernels' in-circuit MPT
        # binding program: the root circuit variants embed it
        from .evm.binding import PRODUCTION_SHAPE

        binding_shape = PRODUCTION_SHAPE
    try:
        bp = prove_block(
            ir,
            standard_fast_config(),
            # CircuitConfig -> per-block degree fit within the ranges
            sizes=config,
            runtime=runtime,
            recursion=args.recursion,
            binding_shape=binding_shape,
            block_wrap=args.block_wrap,
            device=args.device,
        )
    finally:
        runtime.close()
    json.dump(serde.block_proof_to_json(bp), sys.stdout)
    return 0


def cmd_verify(args) -> int:
    from .fri.config import standard_fast_config
    from .runtime import serde
    from .runtime.ops import verify_block
    from .runtime.tracing import init_tracing

    init_tracing()
    with open(args.input_proof) as f:
        bp = serde.block_proof_from_json(json.load(f))
    config = standard_fast_config()
    recursion = None
    if bp.succinct is not None and bp.succinct.sizes is not None:
        # rebuild the recursion ladder's vkeys from the proof-declared
        # leaf circuit identity (sizes, binding shape, leaf variants)
        from .recursion.state import recursion_state

        recursion = recursion_state(
            bp.succinct.sizes, config,
            binding_shape=bp.succinct.binding_shape,
            evm_shapes=bp.succinct.evm_shapes,
            wd_counts=bp.succinct.wd_counts,
            device=args.device,
        )
    ok = verify_block(bp, config, recursion=recursion, device=args.device)
    print("valid" if ok else "INVALID", file=sys.stderr)
    return 0 if ok else 1


def cmd_worker(args) -> int:
    """Worker daemon: dial the leader and execute registry ops on
    `--device` until it hangs up (the prover state is built at startup
    from the same flag/env config as the leader's)."""
    from .runtime.distributed import worker_main_loop
    from .runtime.prover_state import set_prover_state_from_config
    from .runtime.tracing import init_tracing

    init_tracing(pretty=True)
    config = _resolve_config(args)
    set_prover_state_from_config(config, persistence=args.persistence)
    return worker_main_loop(
        _parse_addr(args.leader), reconnect=args.reconnect, device=args.device
    )


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="ethproof_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    rpc = sub.add_parser("rpc", help="generate a witness from a JSON-RPC node")
    rpc.add_argument("-u", "--rpc-url", required=True)
    rpc.add_argument("-t", "--transaction-hash", required=True)
    rpc.add_argument("--request-miner-from-clique", action="store_true")
    rpc.set_defaults(fn=cmd_rpc)

    prove = sub.add_parser("prove", help="prove a witness file")
    prove.add_argument("-i", "--input-witness", required=True)
    prove.add_argument(
        "--runtime",
        choices=["in-memory", "distributed"],
        default="in-memory",
        help="in-memory: threads in-process; distributed: dispatch to a "
        "worker fleet over TCP",
    )
    prove.add_argument(
        "--listen",
        default="0.0.0.0:9041",
        help="distributed runtime: leader listen address (host:port)",
    )
    prove.add_argument(
        "--num-workers",
        type=int,
        default=1,
        help="in-memory: thread count; distributed: workers to wait for",
    )
    prove.add_argument(
        "--recursion",
        action="store_true",
        help="succinct constant-size block proof via the recursion ladder "
        "(transfer state binding proved in-circuit; contract-call storage "
        "binding is still host-checked in this mode)",
    )
    prove.add_argument(
        "--block-wrap",
        action="store_true",
        dest="block_wrap",
        help="with --recursion: chain this block to its parent IN-CIRCUIT "
        "via the block wrap circuits",
    )
    _add_circuit_flags(prove)
    _add_device_flag(prove)
    prove.set_defaults(fn=cmd_prove)

    verify = sub.add_parser("verify", help="verify a proof file")
    verify.add_argument("-i", "--input-proof", required=True)
    _add_device_flag(verify)
    verify.set_defaults(fn=cmd_verify)

    worker = sub.add_parser(
        "worker", help="worker daemon: execute proving ops for a leader"
    )
    worker.add_argument(
        "--leader",
        default=os.environ.get("ETHPROOF_LEADER", "127.0.0.1:9041"),
        help="leader address host:port (env ETHPROOF_LEADER)",
    )
    worker.add_argument(
        "--reconnect", type=int, default=5,
        help="connection attempts before giving up (a service manager restarts us)",
    )
    _add_circuit_flags(worker)
    _add_device_flag(worker)
    worker.set_defaults(fn=cmd_worker)
    return parser


def main(argv=None) -> int:
    _load_dotenv()
    args = build_parser().parse_args(argv)
    if getattr(args, "device", None) is not None:
        from . import resolve_device

        try:
            resolve_device(args.device)
        except RuntimeError as e:
            print(f"ethproof_tpu_torch: {e} (--device cpu)", file=sys.stderr)
            return 2
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
