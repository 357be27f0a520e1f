"""Codec drivers and the device pipeline (every mode, same-shape batches)."""
