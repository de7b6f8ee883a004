"""Checkpoint reading (the reference's on-disk layout)."""
