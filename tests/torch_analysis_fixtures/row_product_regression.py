"""A bug the port once had: a shard_map rank's graph neighbor sum took its
(1, V) adjacency row against the gathered rows, a product that sums in
another order than the single-host (V, V) one.  Fixed by padding the row
into a zero (V, V) matrix, with an attestation.  Linted as
core/dtsvm_dist.py, where ``nbr_reduce`` is a per-iteration root."""
import torch

from repro_torch.dist import collectives


def _nbr_reduce_for(adj_row, group=None):
    def nbr_reduce(arr):
        rows = collectives.all_gather(arr, -3, group=group)
        return torch.einsum("vu,...utd->...vtd", adj_row, rows)
    return nbr_reduce
