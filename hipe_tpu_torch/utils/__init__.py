"""Host-side helpers: image layouts and deterministic test images."""
