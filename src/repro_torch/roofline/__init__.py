"""Roofline pricing of the port's kernels on the H100 (``collect``) and
the launch-plan tuner's command line (``svm_tune``)."""
