"""Device seconds a fit spends in cuBLAS' dense products (kernels named
gemv or gemm) in the traced window, in a cell whose only such products
are the linear solvers' passes over the design matrix (the linear mix:
``gemvx`` and the ``xmma_gemm`` of the Gram products). Where the tree
engine runs, its leaf sums' one-hot products are gemm kernels too, so
the metric lists no cell with a tree family. None where none ran."""
from . import BLAS, per_fit


def read(run):
    t = run["trace"].device_time(lambda n: bool(BLAS.search(n)))
    return per_fit(run, t) if t > 0 else None
