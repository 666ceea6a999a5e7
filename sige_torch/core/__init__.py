"""Host-side planning primitives (numpy only)."""
