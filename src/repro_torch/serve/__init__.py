"""Serving subsystem of the port: packed artifacts and the Predictor.

    from repro_torch import serve

    packed = serve.pack(clf)                    # binary SVC or SVR
    serve.save("model.npz", packed)             # schema v1 / v2, as repro
    pred = serve.Predictor(serve.load("model.npz"), engine="pallas")
    pred.predict(Z)
"""
from repro_torch.serve.artifact import (LowRankMap,  # noqa: F401
                                        PackedModel, SCHEMA_NAME,
                                        SCHEMA_VERSION,
                                        SCHEMA_VERSION_CLASSIC,
                                        SCHEMA_VERSIONS, TaskBucket, load,
                                        pack, save)
from repro_torch.serve.predictor import Predictor, serving_config  # noqa: F401
