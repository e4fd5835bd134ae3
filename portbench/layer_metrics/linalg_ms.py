"""Device ms of the dense linear algebra (cuSOLVER and cuBLAS: the
Cholesky factorizations, the triangular solves, the inverse of the
adjoint, matrix products) in the profiled steps, per the step's ``norm``
(1,000 points of a request, one build, one call).  A kernel counts when
its name matches one of ``PATTERNS``; the rest of the device time shows
in the run's ``breakdown``."""

import re

DEVICE_EVENTS_ONLY = True

PATTERNS = re.compile(
    r"potrf|potri|potrs|trtri|lauum|trsm|trsv|trmm|syrk|herk|gemm|gemv|"
    r"getrf|cusolver|cublas|xmma|cutlass|magma|lapack|chol|dot_kernel|"
    r"nrm2|axpy|scal_kernel|ger_kernel|symm|syr2k",
    re.IGNORECASE)


def read(ctx):
    norm = sum(r["norm"] for r in ctx.traced)
    events = [(n, a, b) for n, a, b in ctx.trace.in_steps()
              if PATTERNS.search(n) and not n.startswith("Memcpy")]
    if not events or norm <= 0:
        return None
    return sum(b - a for _, a, b in events) / 1e3 / norm
