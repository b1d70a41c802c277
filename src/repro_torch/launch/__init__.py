"""Meshes of ranks (``launch.mesh``) for the port's multi-rank paths."""
