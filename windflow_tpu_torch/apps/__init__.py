"""Applications of the port, copies of the JAX package's (the reference's
src/ application suites): spatial_test (apps/spatial.py), the Yahoo
Streaming Benchmark (apps/ysb.py), pipe_test_gpu (apps/pipe.py) and the
host micro-pipeline (apps/micro.py)."""
