"""Serving subsystem of the port: packed artifacts, the batched
Predictor, the model registry and the dynamic-batching service.

    from repro_torch import serve

    packed = serve.pack(clf, sv_dtype="bf16")   # quantized SV bank
    serve.save("model.npz", packed)             # schema v1 / v2 / v3
    pred = serve.Predictor(serve.load("model.npz"), engine="pallas")
    pred.predict(Z)

    reg = serve.ModelRegistry(max_resident=4, engine="pallas")
    svc = serve.ServingService(reg, window_ms=2.0)   # open-loop traffic
    svc.submit(z, model="name").result()        # dynamic-batched future

See ``serve.artifact`` for the schema (v1 / v2 / v3 and quantization),
``serve.predictor`` for residency and the batch ladder,
``serve.registry`` for LRU residency and ``serve.service`` for the
batching window.
"""
from repro_torch.serve.artifact import (LowRankMap,  # noqa: F401
                                        PackedModel, SCHEMA_NAME,
                                        SCHEMA_VERSION,
                                        SCHEMA_VERSION_CLASSIC,
                                        SCHEMA_VERSION_QUANT,
                                        SCHEMA_VERSIONS, SV_DTYPES,
                                        TaskBucket, load, pack, quantize,
                                        save)
from repro_torch.serve.predictor import Predictor, serving_config  # noqa: F401
from repro_torch.serve.registry import ModelRegistry  # noqa: F401
from repro_torch.serve.service import ServingService  # noqa: F401
