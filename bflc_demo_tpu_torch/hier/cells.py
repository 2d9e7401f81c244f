"""Deterministic cell topology: who belongs to which cell, and the
protocol geometry each tier runs.

Copy of `bflc_demo_tpu/hier/cells.py` (`CellPlan`, `plan_cells`,
`cell_seed`, `cell_protocol`, `root_protocol`), the imports aside.
Dropped: `cell_protocol` does not zero `adapt_every` — the port's
`ProtocolConfig` has no closed compression loop to switch off (ROADMAP
A9 item 9), so the cell genome is otherwise the reference's.

Cohorting is a pure function of (n_clients, n_cells): contiguous blocks,
remainder spread one-per-cell from the front.  Every party — driver,
aggregators, root registry, validators — derives the same plan from the
same two integers, so membership needs no negotiation and the root's
per-cell client-count bound (`partial.check_cell_upload_op`) is checkable
from configuration alone.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Tuple

from bflc_demo_tpu_torch.protocol.constants import ProtocolConfig


@dataclasses.dataclass(frozen=True)
class CellPlan:
    """The cell cohorting: members[c] = sorted client indices of cell c."""

    n_clients: int
    members: Tuple[Tuple[int, ...], ...]

    @property
    def n_cells(self) -> int:
        return len(self.members)

    def cell_of(self, client_index: int) -> int:
        for c, m in enumerate(self.members):
            if client_index in m:
                return c
        raise IndexError(f"client {client_index} not in any cell")

    def sibling_of(self, cell_index: int) -> int:
        """The re-home target when a cell aggregator dies: the next cell
        in ring order (deterministic, never the cell itself)."""
        if self.n_cells < 2:
            raise ValueError("no sibling in a single-cell plan")
        return (cell_index + 1) % self.n_cells


def plan_cells(n_clients: int, cells: int = 0,
               cell_size: int = 0) -> CellPlan:
    """Deterministic cohorting from exactly one of --cells / --cell-size
    (both is allowed when consistent).  Contiguous blocks: cell c takes
    the next `size` client indices, with the remainder spread one extra
    member per cell from cell 0 — so any two parties that agree on
    (n_clients, n_cells) agree on every membership.
    """
    if n_clients < 2:
        raise ValueError(f"hier federation needs >= 2 clients, got "
                         f"{n_clients}")
    if cell_size:
        # the cell count cell_size implies; when --cells is also given
        # the two must AGREE — silently dropping one knob would run a
        # topology the operator never asked for
        implied = (n_clients + cell_size - 1) // cell_size
        if cells and cells != implied:
            raise ValueError(
                f"cells={cells} disagrees with cell_size={cell_size}: "
                f"{n_clients} clients at <= {cell_size} per cell means "
                f"{implied} cells (pass one, or a consistent pair)")
        cells = implied
    elif not cells:
        raise ValueError("pass cells=N and/or cell_size=M")
    if not 2 <= cells <= n_clients // 2:
        raise ValueError(
            f"cells={cells} out of range: need 2 <= cells <= "
            f"n_clients//2 ({n_clients // 2}) so every cell has >= 2 "
            f"members and the root tier has a committee")
    base, extra = divmod(n_clients, cells)
    members = []
    start = 0
    for c in range(cells):
        size = base + (1 if c < extra else 0)
        members.append(tuple(range(start, start + size)))
        start += size
    return CellPlan(n_clients=n_clients, members=tuple(members))


def cell_seed(master_seed: bytes, cell_index: int) -> bytes:
    """The cell aggregator's deterministic wallet seed — same derivation
    convention as the standby/validator fleets (process_runtime), so only
    PUBLIC keys ever need distributing."""
    return master_seed + b"|cell-aggregator|" + struct.pack("<q",
                                                            cell_index)


def cell_protocol(cfg: ProtocolConfig, n_members: int) -> ProtocolConfig:
    """The cell-tier protocol genome: the SAME committee-consensus round,
    scaled to the cell's membership.  Derived deterministically from the
    global config so every aggregator (and any auditor) agrees:
    committee <= half the cell, admission cap fills the trainer
    population, top-k bounded by the cap."""
    if n_members < 2:
        raise ValueError(f"a cell needs >= 2 members, got {n_members}")
    comm = max(1, min(cfg.comm_count, n_members // 2, n_members - 1))
    needed = max(1, min(cfg.needed_update_count, n_members - comm))
    agg = max(1, min(cfg.aggregate_count, needed))
    return dataclasses.replace(
        cfg, client_num=n_members, comm_count=comm,
        needed_update_count=needed, aggregate_count=agg).validate()


def root_protocol(cfg: ProtocolConfig, n_cells: int) -> ProtocolConfig:
    """The root-tier protocol genome: the same round one level up, with
    cells as the clients.  Per round, `comm` cells form the root
    committee (they score candidate partials instead of uploading —
    exactly the trainer/committee split of the base protocol) and up to
    n_cells - comm cell partials merge.  Partials are always plain f32
    (the aggregator dequantizes member deltas before summing), so the
    root genome pins delta_dtype='f32' regardless of the cell tier's
    upload encoding.  delta_density is NOT pinned: a density-armed
    fleet re-sparsifies each cell partial for the bridge hop
    (hier.partial.partial_blob), and the root admits it through the
    same densify inverse as any upload."""
    if n_cells < 2:
        raise ValueError(f"the root tier needs >= 2 cells, got {n_cells}")
    comm = max(1, min(cfg.comm_count, n_cells // 2, n_cells - 1))
    needed = n_cells - comm
    agg = max(1, min(cfg.aggregate_count, needed))
    return dataclasses.replace(
        cfg, client_num=n_cells, comm_count=comm,
        needed_update_count=needed, aggregate_count=agg,
        delta_dtype="f32").validate()
