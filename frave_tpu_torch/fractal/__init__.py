"""Torch executor for the host-planned lattice-grid transforms."""
