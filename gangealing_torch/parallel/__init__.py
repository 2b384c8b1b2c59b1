"""The port's multi-process runtime: see parallel/mesh.py."""
