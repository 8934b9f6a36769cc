"""Host-side structures and the device engine."""
