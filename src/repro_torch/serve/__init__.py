"""Serving subsystem of the port: packed artifacts and the Predictor.

    from repro_torch import serve

    packed = serve.pack(clf)                    # binary SVC
    serve.save("model.npz", packed)             # schema v1, readable by repro
    pred = serve.Predictor(serve.load("model.npz"), engine="pallas")
    pred.predict(Z)
"""
from repro_torch.serve.artifact import (PackedModel,  # noqa: F401
                                        SCHEMA_NAME, SCHEMA_VERSION_CLASSIC,
                                        SCHEMA_VERSIONS, TaskBucket, load,
                                        pack, save)
from repro_torch.serve.predictor import Predictor, serving_config  # noqa: F401
