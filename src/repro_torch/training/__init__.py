"""The LM substrate's train step (the port of ``repro.training``)."""
