"""SVM core of the port: kernels, engines, the SMO solver, ``SVC``."""
