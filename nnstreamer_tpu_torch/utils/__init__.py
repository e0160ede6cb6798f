"""Small shared helpers (device resolution)."""
