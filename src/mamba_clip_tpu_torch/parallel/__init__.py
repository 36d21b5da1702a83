"""The data axis across processes: ranks, the mesh and its collectives."""
