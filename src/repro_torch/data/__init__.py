"""numpy data helpers of the port (copies; no jax, no ``repro``)."""
from repro_torch.data.iris import load_iris
from repro_torch.data.pipeline import normalize, train_test_split
from repro_torch.data.synth import (load_breast_cancer_like,
                                    load_pavia_like, make_blobs,
                                    make_synth_regression)

__all__ = ["load_iris", "load_breast_cancer_like", "load_pavia_like",
           "make_blobs", "make_synth_regression", "normalize",
           "train_test_split"]
