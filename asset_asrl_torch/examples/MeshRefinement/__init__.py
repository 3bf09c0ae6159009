"""Adaptive-mesh variants of the examples (`examples/MeshRefinement/`)."""
