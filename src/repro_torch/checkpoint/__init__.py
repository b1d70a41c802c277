"""Checkpoints in the reference's ``.npz`` format (the port of
``repro.checkpoint``)."""
