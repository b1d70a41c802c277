"""Logical-axis sharding of the LM substrate over a ``DeviceMesh``
(``rules``: logical axes -> mesh axes -> DTensor placements; ``place``:
a model's parameters, a batch and caches as DTensors)."""
