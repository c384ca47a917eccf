"""Graph containers, the Fiedler front end and rounding; the package
exports the names of mac_tpu.utils."""

from mac_tpu_torch.utils.conversions import mac_to_nx, nx_to_mac
from mac_tpu_torch.utils.graphs import (
    Edge,
    arrays_to_edges,
    edges_to_arrays,
    get_edge_selection_as_binary_mask,
    get_incidence_vector,
    select_edges,
    set_incidence_vector_for_edge_inplace,
    weight_graph_lap_from_edge_list,
    weight_graph_lap_from_edges,
    weight_reduced_graph_lap_from_edge_list,
)

__all__ = [
    "Edge",
    "edges_to_arrays",
    "arrays_to_edges",
    "weight_graph_lap_from_edge_list",
    "weight_reduced_graph_lap_from_edge_list",
    "weight_graph_lap_from_edges",
    "select_edges",
    "get_incidence_vector",
    "set_incidence_vector_for_edge_inplace",
    "get_edge_selection_as_binary_mask",
    "nx_to_mac",
    "mac_to_nx",
]
