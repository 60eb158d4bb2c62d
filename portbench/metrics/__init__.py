"""Per-layer metric readers, one module a metric named as in
``BENCHMARK.json``: ``read(run)`` returns the metric's value from the
run's fits, trace and histogram shapes, or None when it finds nothing to
read (the harness then leaves the metric out)."""
import re

#: cuBLAS' dense products (the linear solvers' matrix-vector and
#: matrix-matrix kernels)
BLAS = re.compile(r"gemv|gemm", re.IGNORECASE)
#: the hand-written histogram kernel's passes
HIST = re.compile(r"tree_hist")
#: device events that move or set memory and run no kernel
MOVES = re.compile(r"Memcpy|Memset")


def per_fit(run, total: float) -> float:
    return total / len(run["fits"])
