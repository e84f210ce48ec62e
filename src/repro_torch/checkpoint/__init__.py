"""Checkpointing: atomic, manifest-verified, async (``ckpt``)."""
