"""Context-table pipeline on the device (twin of the host tables)."""
