"""Hierarchical cell federation: two-tier committee consensus.

Port of `bflc_demo_tpu/hier/` with the same exports.  One writer
admitting, scoring and certifying every client upload caps the fleet at
tens of clients; this package is the tier of intermediate aggregators
that lets the root see O(cells), not O(clients), built by running the
existing protocol twice:

- clients are deterministically cohorted into cells (`cells.py`); each
  cell aggregator (`aggregator.py`) is a full `comm.ledger_service.
  LedgerServer` over its members — admission gas, Ed25519 tags,
  committee scoring and stall recovery all reuse unchanged at cell
  scope;
- when a cell's round fires, the aggregator computes ONE deterministic
  partial (`partial.py`: sample-weighted FedAvg of the cell-selected
  deltas in sorted-address order, through the certified merge engine —
  kernel B5 on the card) and submits it to the root ledger as a standard
  signed `upload` op, the reserved `#cellmeta` evidence entry inside the
  payload hash;
- the root BFT-certifies O(cells) ops a round through the unchanged
  `comm.bft` machinery, each validator holding the cell registry, and
  merges the partials (B5 on the card);
- the global model flows back down through the read path: each
  aggregator is a consumer of the root's read set and the serving
  replica of its own members.

`runtime.run_federated_hier` is the OS-process deployment driver; it is
not re-exported here (it imports the fleet), as in the reference.
"""

from bflc_demo_tpu_torch.hier.cells import (CellPlan, cell_protocol,
                                            cell_seed, plan_cells,
                                            root_protocol)
from bflc_demo_tpu_torch.hier.partial import (CELLMETA_KEY,
                                              cell_evidence_digest,
                                              cell_partial,
                                              check_cell_upload_op,
                                              pack_cellmeta, partial_blob,
                                              split_cellmeta,
                                              unpack_cellmeta)

__all__ = [
    "CellPlan", "plan_cells", "cell_seed", "cell_protocol",
    "root_protocol", "CELLMETA_KEY", "cell_partial",
    "cell_evidence_digest", "pack_cellmeta", "unpack_cellmeta",
    "split_cellmeta", "partial_blob", "check_cell_upload_op",
]
