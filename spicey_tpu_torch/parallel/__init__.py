"""Multi-device placement of the batched sweeps (parallel/mesh.py)."""
