"""Checkpoints in the reference's on-disk layout: atomic saves, a background writer, restore."""
