"""Device meshes and sharded proving steps.

Counterpart: ethproof_tpu/parallel/mesh.py:1 (`make_mesh`, `default_mesh`,
`reset_default_mesh`, `mesh_width`, `shard_gf`, `pad_cols`,
`trace_commit_sharded`, `constraint_sweep_sharded`).

A single-controller mesh, as the counterpart's is: one process places
blocks of one array on several devices and launches every device's work
itself. The transcript stays on the host, so there is one challenger and
no rank logic. The mesh is a (tx, col) grid of indexed devices:

- `col`: trace columns are independent through the iNTT and coset LDE, so
  each device transforms its own column block (`shard(a, mesh, 0)`). The
  LDE is then resharded to the DOMAIN axis: Merkle leaves and the
  constraint sweep are row-wise in the domain, so each device hashes its
  contiguous domain block (a whole subtree, since the width is a power of
  two) and sweeps it with a halo of next rows from the following block.
  Only the levels above the blocks, the caps, the openings' (cols, 2)
  sums and the DEEP codeword's one extension column meet on the leader,
  the mesh's first device.
- `tx`: independent transactions committed side by side
  (`trace_commit_sharded`); the prover uses the first row of the grid.

A device may repeat: `make_mesh(devices=["cpu"] * 8)` is the CPU tier's
virtual mesh (the counterpart's `xla_force_host_platform_device_count`),
`["cuda:0"] * 4` a virtual mesh on one card. The bits of every commit and
proof are the same on every mesh, since field arithmetic is exact.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..gf import field as gfp
from ..hash import merkle
from ..poly import four_step

def _normalise(device) -> torch.device:
    """An indexed device: `cuda` means the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """A (tx, col) grid of indexed devices; `devices[0, 0]` is the leader."""

    axis_names = ("tx", "col")

    def __init__(self, devices: Sequence[Sequence]):
        grid = [[_normalise(d) for d in row] for row in devices]
        if not grid or not grid[0] or any(len(row) != len(grid[0]) for row in grid):
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        kinds = {d.type for row in grid for d in row}
        if len(kinds) != 1:
            raise ValueError(f"a mesh holds one device type, got {sorted(kinds)}")
        width = len(grid[0])
        if width & (width - 1):
            raise ValueError(f"the col width must be a power of two, got {width}: domain blocks "
                             "must be whole Merkle subtrees")
        self.devices = np.empty((len(grid), width), dtype=object)
        for i, row in enumerate(grid):
            for j, d in enumerate(row):
                self.devices[i, j] = d

    @property
    def shape(self) -> dict:
        return {"tx": self.devices.shape[0], "col": self.devices.shape[1]}

    @property
    def leader(self) -> torch.device:
        return self.devices[0, 0]

    def col_devices(self, row: int = 0) -> List[torch.device]:
        return list(self.devices[row])

    def key(self) -> tuple:
        """Hashable identity (cache keys)."""
        return tuple(tuple(str(d) for d in row) for row in self.devices)


def make_mesh(n_devices: Optional[int] = None, tx: int = 1, devices=None) -> Mesh:
    """A ('tx', 'col') mesh over the first `n_devices` of `devices` (None:
    every CUDA card); tx divides the device count and the col width is a
    power of two. `devices` may repeat a device (a virtual mesh)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA card; pass devices=[...] to name them")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    n = n_devices or len(devices)
    if not 1 <= n <= len(devices):
        raise ValueError(f"make_mesh: {n} devices asked, {len(devices)} given")
    if n % tx:
        raise ValueError(f"make_mesh: tx={tx} does not divide {n} devices")
    w = n // tx
    return Mesh([devices[i * w:(i + 1) * w] for i in range(tx)])


_DEFAULT_MESH = "unset"


def default_mesh() -> Optional[Mesh]:
    """The production mesh, built once per process: every CUDA card of the
    host when it has more than one, so `cli prove` and fleet workers shard
    every commit with no flag. ETHPROOF_MESH=off disables it, =N caps the
    'col' width; the width is rounded down to a power of two. One card,
    or none, gives None: a CPU proof never gets a default mesh."""
    global _DEFAULT_MESH
    if _DEFAULT_MESH != "unset":
        return _DEFAULT_MESH
    mode = os.environ.get("ETHPROOF_MESH", "auto")
    if mode == "off":
        _DEFAULT_MESH = None
        return None
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if mode not in ("auto", ""):
        n = min(n, int(mode))
    if n > 1:
        _DEFAULT_MESH = make_mesh(1 << (n.bit_length() - 1))
    else:
        _DEFAULT_MESH = None
    return _DEFAULT_MESH


def reset_default_mesh() -> None:
    """Testing hook: the next `default_mesh()` reads the environment again."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = "unset"


def resolve_mesh(mesh, device: torch.device) -> Optional[Mesh]:
    """The mesh a prover on `device` runs on: None takes `default_mesh()`
    where its leader is `device` (a CUDA proof on a multi-card host),
    False forces one device; a given mesh must be led by `device`."""
    if mesh is False:
        return None
    if mesh is None:
        if device.type != "cuda":
            return None
        m = default_mesh()
        return m if m is not None and m.leader == _normalise(device) else None
    if mesh.leader != _normalise(device):
        raise ValueError(f"the mesh's leader {mesh.leader} is not the prover's device {device}")
    return mesh


def mesh_width(mesh: Mesh) -> int:
    return mesh.shape["col"]


def pad_cols(a: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad axis 0 up to a multiple (equal column blocks)."""
    pad = (-a.shape[0]) % multiple
    if pad == 0:
        return a
    return torch.cat([a, gfp.zeros((pad,) + tuple(a.shape[1:]), a.device)])


def shard(a: torch.Tensor, mesh: Mesh, axis: int, row: int = 0) -> List[torch.Tensor]:
    """Equal blocks of `a` along `axis`, block i on the mesh's col device i."""
    devs = mesh.col_devices(row)
    if a.shape[axis] % len(devs):
        raise ValueError(f"shard: axis {axis} of {tuple(a.shape)} does not split {len(devs)} ways")
    return [blk.to(d) for blk, d in zip(torch.chunk(a, len(devs), dim=axis), devs)]


def gather(blocks: List[torch.Tensor], axis: int, device) -> torch.Tensor:
    """The blocks joined along `axis` on `device` (one block there: itself)."""
    if len(blocks) == 1 and blocks[0].device == torch.device(device):
        return blocks[0]
    return torch.cat([b.to(device) for b in blocks], dim=axis)


def commit_blocks(col_blocks: List[torch.Tensor], cols: int, rate_bits: int, shift: int,
                  cap_height: int, from_coeffs: bool = False):
    """The sharded commit: equal column blocks (the last may end in zero
    padding), each on its device, of a `cols`-column trace (of its
    coefficients with `from_coeffs`) -> (coefficient blocks without the
    padding, LDE domain blocks, Merkle tree).

    Each device runs the iNTT and coset LDE of its columns (its own
    `base_dft` launches); every block's LDE is then scattered into the
    domain blocks and freed before the next block's is made, so beside the
    domain-sharded LDE only one column block's LDE is alive at a time."""
    def coefficients(blk):
        return blk if from_coeffs else four_step.best_intt(blk)

    devs = [b.device for b in col_blocks]
    if len(col_blocks) == 1:
        coeffs = coefficients(col_blocks[0])[:cols]
        lde = four_step.best_coset_lde(coeffs, rate_bits, shift)
        return [coeffs], [lde], merkle.build(lde, cap_height)
    w = len(col_blocks)
    per, n = col_blocks[0].shape
    m = n << rate_bits
    if m % w:
        raise ValueError(f"a {m}-point domain does not split into {w} blocks")
    span = m // w
    dom = [torch.empty((cols, span), dtype=torch.int64, device=d) for d in devs]
    coeffs = []
    for i, blk in enumerate(col_blocks):
        real = max(0, min(per, cols - i * per))
        if real == 0:  # padding only
            coeffs.append(blk[:0])
            continue
        c = coefficients(blk)[:real]
        coeffs.append(c)
        lde = four_step.best_coset_lde(c, rate_bits, shift)
        for j in range(w):
            dom[j][i * per:i * per + real].copy_(lde[:, j * span:(j + 1) * span])
        del lde
    return coeffs, dom, merkle.build_blocks(dom, cap_height)


def trace_commit_sharded(mesh: Mesh, cols: int, n: int, rate_bits: int = 2,
                         cap_height: int = 2, shift: int = 7):
    """A column-sharded trace commit of a tx batch on `mesh`.

    Returns (fn, shard_fn): shard_fn places a (tx, cols, n) u64 trace on
    the mesh (tx row t's columns over that row's col devices, zero-padded
    to the width); fn(placed) -> the (tx, 4, 2^cap_height) caps on the
    leader."""
    w = mesh_width(mesh)

    def shard_fn(trace: np.ndarray) -> List[List[torch.Tensor]]:
        if trace.shape[1:] != (cols, n):
            raise ValueError(f"shard_fn: a trace of shape {trace.shape}, not (tx, {cols}, {n})")
        return [shard(pad_cols(gfp.from_u64(t, "cpu"), w), mesh, 0, row)
                for row, t in enumerate(trace)]

    def commit(placed: List[List[torch.Tensor]]) -> torch.Tensor:
        caps = [commit_blocks(blocks, cols, rate_bits, shift, cap_height)[2].cap
                for blocks in placed]
        return torch.stack([c.to(mesh.leader) for c in caps])

    return commit, shard_fn


def constraint_sweep_sharded(mesh: Mesh):
    """Column-sharded elementwise sweep: sweep(lde (cols, n), w (cols,)) ->
    sum_c w_c * lde_c, (n,) on the leader. Each device folds its column
    block; the partial sums meet on the leader."""
    width = mesh_width(mesh)

    def sweep(lde: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        blocks = shard(pad_cols(lde, width), mesh, 0)
        weights = shard(pad_cols(w[:, None], width), mesh, 0)
        parts = [gfp.sum_dim(gfp.mul(b, wb), 0).to(mesh.leader)
                 for b, wb in zip(blocks, weights)]
        return gfp.sum_dim(torch.stack(parts), 0)

    return sweep
