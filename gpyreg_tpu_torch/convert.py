"""Build a port GP from plain arrays: the state that carries a GP across
packages.

A GP's hyperparameter samples and data are its weights.
:func:`gp_from_arrays` takes them as numpy arrays, with the metadata of
``gpyreg_tpu.GP.save`` (``gpyreg_tpu/gp.py:2528-2542``, the ``meta_*``
keys without their prefix), and rebuilds the posterior on ``device``.
The bounds, the prior table and ``no_prior`` come across too, so that
``log_posterior`` gives the numbers of the GP they came from.
``GP.load`` reads a ``.npz`` written by either package through it.
"""

import numpy as np

from . import covariance_functions as cf
from . import isotropic_covariance_functions as icf
from . import mean_functions as mf
from . import noise_functions as nf
from .gp import GP

_MEANS = {
    "zero": mf.ZeroMean,
    "const": mf.ConstantMean,
    "negquad": mf.NegativeQuadratic,
    "linear": mf.LinearMean,
    "quad": mf.QuadraticMean,
    "posquad": mf.PositiveQuadratic,
    "se_mean": mf.SquaredExponentialMean,
    "negse_mean": mf.NegativeSquaredExponentialMean,
}


def covariance_from_kind(kind: str):
    """The covariance object for a kernel kind (``gpyreg_tpu/gp.py:2571-2582``)."""
    iso = kind.endswith("_iso")
    base = kind[:-4] if iso else kind
    if base == "se":
        return icf.SquaredExponentialIsotropic() if iso else cf.SquaredExponential()
    if base in ("m1", "m3", "m5"):
        deg = int(base[1])
        return icf.MaternIsotropic(deg) if iso else cf.Matern(deg)
    if base == "rq" and not iso:
        return cf.RationalQuadraticARD()
    raise ValueError(f"Unknown covariance kind {kind}")


def mean_from_kind(kind: str):
    if kind not in _MEANS:
        raise ValueError(f"Unknown mean kind {kind}")
    return _MEANS[kind]()


def noise_from_parameters(p):
    """The noise object for a ``GaussianNoise.parameters`` flag vector."""
    p = np.asarray(p)
    return nf.GaussianNoise(
        constant_add=bool(p[0] == 1),
        user_provided_add=bool(p[1] >= 1),
        scale_user_provided=bool(p[1] == 2),
        rectified_linear_output_dependent_add=bool(p[2] == 1),
    )


def gp_from_arrays(meta, X, y, s2, hyp, device=None, compute_posterior=True,
                   bounds=None, hyper_priors=None):
    """A port GP from numpy arrays, on ``device`` (the card by default).

    ``meta`` holds ``D``, ``cov_kind``, ``mean_kind``,
    ``noise_parameters`` and ``dtype``, and optionally ``fast_predict``,
    ``pallas_predict`` and ``no_prior`` (-1 for None, as ``save``
    writes it).  ``X`` (N, D), ``y`` (N, 1) and ``s2`` (N, 1) may be
    None; ``hyp`` (S, hyp_N) or None.  ``bounds`` is a pair of (hyp_N,)
    arrays (lower, upper) and ``hyper_priors`` the prior table (keys mu,
    sigma, df, a, b, each (hyp_N,)); the normalization constants are
    recomputed from them, as ``gpyreg_tpu.GP.load`` does.  With data and
    ``hyp`` the posterior of every sample is built unless
    ``compute_posterior`` is False.
    """
    gp = GP(
        D=int(meta["D"]),
        covariance=covariance_from_kind(str(meta["cov_kind"])),
        mean=mean_from_kind(str(meta["mean_kind"])),
        noise=noise_from_parameters(meta["noise_parameters"]),
        dtype=np.dtype(str(meta["dtype"])),
        fast_predict=bool(int(meta.get("fast_predict", 0))),
        pallas_predict=bool(int(meta.get("pallas_predict", 0))),
        device=device,
    )
    for name, v in (("X", X), ("y", y), ("s2", s2)):
        if v is not None:
            setattr(gp, name, np.array(v, dtype=np.float64))
    if bounds is not None:
        gp.lower_bounds, gp.upper_bounds = (
            np.array(b, dtype=np.float64) for b in bounds
        )
    if hyper_priors is not None:
        gp.hyper_priors = {
            k: np.array(v, dtype=np.float64) for k, v in hyper_priors.items()
        }
    if "no_prior" in meta:
        no_prior = int(meta["no_prior"])
        gp.no_prior = None if no_prior == -1 else bool(no_prior)
    if gp.no_prior is not None:
        gp._GP__recompute_normalization_constants()
    gp._invalidate()
    if hyp is not None:
        gp.update(
            hyp=np.asarray(hyp, dtype=np.float64),
            compute_posterior=compute_posterior
            and X is not None
            and y is not None,
        )
    return gp
