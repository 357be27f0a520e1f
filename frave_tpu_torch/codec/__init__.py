"""Codec drivers and the device pipeline (grid mode, one image)."""
