"""Optimizers of the LM substrate (the port of ``repro.optim``)."""
