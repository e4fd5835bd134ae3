"""Composable Gaussian observation-noise function (NumPy).

Port of ``gpyreg_tpu/noise_functions.py``: three independently
toggleable noise features summed into the total variance —

- constant noise ``exp(2*hyp)`` (1 hyp),
- user-provided variance ``s2``, optionally scaled by ``exp(hyp)``
  (0 or 1 hyp),
- rectified-linear output-dependent noise ``w^2 * max(0, y_thresh - y)^2``
  (2 hyps).

``compute`` returns a scalar when the noise is input/output independent,
else (N, 1).  The ``parameters`` flag vector (reference
noise_functions.py:26-41) and the hyperparameter names and order are the
cross-package ABI.  The device path uses ``core/model.noise_variance``.
The recommended bounds that ``GP.fit`` reads (``get_bounds_info`` and each
feature's ``bounds_rows``, :38-50, :71-75, :93-111, :158-179) are numpy on
the host.
"""

import numpy as np

from .covariance_functions import _validate_hyp


class _ConstantNoise:
    """Homoskedastic variance exp(2*h). One hyp: ``noise_log_scale``."""

    n_hyp = 1
    pointwise = False  # contribution independent of X, y
    info = [("noise_log_scale", 1)]

    @staticmethod
    def bounds_rows(D, y, tol):
        height = np.max(y) - np.min(y)
        return [
            # (LB, UB, PLB, PUB, x0)
            (
                np.log(tol),
                np.log(height),
                0.5 * np.log(tol),
                np.log(np.std(y, ddof=1)),
                np.log(1e-3),
            )
        ]

    @staticmethod
    def term(h, X, y, s2, grad):
        v = np.exp(2 * h[0])
        return v, ([2 * v] if grad else None)


class _UserProvidedNoise:
    """Adds the user-supplied variance s2, optionally scaled by a
    fitted multiplier exp(h) (``noise_provided_log_multiplier``)."""

    pointwise = True  # s2 may vary per point

    def __init__(self, scaled):
        self.scaled = scaled
        self.n_hyp = 1 if scaled else 0
        self.info = (
            [("noise_provided_log_multiplier", 1)] if scaled else []
        )

    @staticmethod
    def bounds_rows(D, y, tol):
        return [
            (np.log(1e-3), np.log(1e3), np.log(0.5), np.log(2), np.log(1))
        ]

    def term(self, h, X, y, s2, grad):
        s2 = 0 if s2 is None else s2
        if not self.scaled:
            return s2, ([] if grad else None)
        scaled = np.exp(h[0]) * s2
        return scaled, ([scaled] if grad else None)


class _RectifiedOutputNoise:
    """Heteroskedastic w^2 * max(0, y_thresh - y)^2 below a fitted
    output threshold. Two hyps: threshold (linear) and log-weight."""

    n_hyp = 2
    pointwise = True
    info = [("noise_rectified_log_multiplier", 2)]

    @staticmethod
    def bounds_rows(D, y, tol):
        min_y, max_y = np.min(y), np.max(y)
        return [
            (
                min_y,
                max_y,
                min_y,
                np.maximum(max_y - 5 * D, min_y),
                np.maximum(max_y - 10 * D, min_y),
            ),
            (
                np.log(1e-3),
                np.log(0.1),
                np.log(0.01),
                np.log(0.1),
                np.log(0.1),
            ),
        ]

    @staticmethod
    def term(h, X, y, s2, grad):
        if y is None:
            # No targets available: the feature contributes nothing.
            return 0.0, ([0.0, 0.0] if grad else None)
        y_thresh, w2 = h[0], np.exp(2 * h[1])
        zz = np.maximum(0, y_thresh - y)
        d_thresh = 2 * w2 * (y_thresh - y) * (zz > 0) if grad else None
        return w2 * zz**2, ([d_thresh, 2 * w2 * zz**2] if grad else None)


class GaussianNoise:
    """Gaussian noise function with composable features."""

    def __init__(
        self,
        constant_add: bool = False,
        user_provided_add: bool = False,
        scale_user_provided: bool = False,
        rectified_linear_output_dependent_add: bool = False,
    ):
        # Flag encoding matches reference noise_functions.py:26-41
        # (parameters[1] == 2 means "scaled user-provided").
        self.parameters = np.zeros((3,))
        self._features = []
        if constant_add:
            self.parameters[0] = 1
            self._features.append(_ConstantNoise())
        if user_provided_add:
            self.parameters[1] = 1 + bool(scale_user_provided)
            self._features.append(
                _UserProvidedNoise(scaled=bool(scale_user_provided))
            )
        if rectified_linear_output_dependent_add:
            self.parameters[2] = 1
            self._features.append(_RectifiedOutputNoise())

    def hyperparameter_count(self):
        return sum(f.n_hyp for f in self._features)

    def hyperparameter_info(self):
        return [row for f in self._features for row in f.info]

    def get_bounds_info(self, X: np.ndarray, y: np.ndarray):
        """Recommended bounds (reference noise_functions.py:82-177)."""
        _, D = X.shape
        if np.size(y) <= 1:
            y = np.array([0, 1])

        rows = [
            row
            for f in self._features
            for row in (f.bounds_rows(D, y, 1e-6) if f.n_hyp else [])
        ]
        if rows:
            LB, UB, PLB, PUB, x0 = (
                np.array(col, dtype=float) for col in zip(*rows)
            )
        else:
            LB, UB, PLB, PUB, x0 = (np.zeros((0,)) for _ in range(5))

        i_nan = np.isnan(x0)
        x0[i_nan] = 0.5 * (PLB[i_nan] + PUB[i_nan])

        return {"LB": LB, "PLB": PLB, "PUB": PUB, "UB": UB, "x0": x0}

    def compute(
        self,
        hyp: np.ndarray,
        X: np.ndarray,
        y: np.ndarray,
        s2: np.ndarray = None,
        compute_grad: bool = False,
    ):
        """Noise variance at the given points, optionally with the
        hyperparameter gradient (reference noise_functions.py:179-283).
        Without a constant-noise feature the total is floored at the
        float64 spacing (reference noise_functions.py:251)."""
        N, _ = X.shape
        noise_N = self.hyperparameter_count()
        hyp = np.asarray(hyp)

        _validate_hyp(hyp, noise_N, kind="noise")

        grad_rows = N if any(f.pointwise for f in self._features) else 1
        dsn2 = np.zeros((grad_rows, noise_N)) if compute_grad else None

        sn2 = 0.0 if self.parameters[0] == 1 else np.spacing(1.0)
        i = 0
        for f in self._features:
            term, grad_cols = f.term(
                hyp[i : i + f.n_hyp], X, y, s2, compute_grad
            )
            sn2 = sn2 + term
            if compute_grad:
                for j, col in enumerate(grad_cols):
                    dsn2[:, i + j : i + j + 1] += np.reshape(col, (-1, 1))
            i += f.n_hyp

        if compute_grad:
            return sn2, dsn2
        return sn2
