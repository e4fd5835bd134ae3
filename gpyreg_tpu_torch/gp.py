"""The GP model object: the serving and likelihood shell over the
PyTorch core.

Port of the serving and likelihood parts of ``gpyreg_tpu/gp.py``.  The
public surface mirrors the reference ``GP`` class
(gaussian_process.py:24-2565): the constructor, the hyperparameter naming
ABI, bounds and priors with their normalization constants (:758-981),
``update``, ``predict``, ``log_likelihood`` / ``log_posterior`` with
their gradients and the reference-private shims ``_GP__compute_nlZ`` /
``_GP__compute_log_priors`` (:1763-1825), the objective
``_objective`` / ``_objective_batch`` (:467-516), ``save``/``load`` and
the ``Posterior`` field semantics, so PyVBMC-style consumers read the
same fields.  Tensors live on the GP's ``device``, the card unless the
caller asks for the CPU; the test points are served in chunks.  A
float32 GP on a CUDA device builds every self- and cross-covariance with
the hand-written kernel tile, and takes the gradient of its
self-covariance with the hand-written gradient tile (``ops/kernels.py``
dispatches).

Left out, with the JAX package's lines:

- until later slices: ``fit``, ``_f32_noise_floor`` and the samplers
  (:1359-1757, the fit slice), the rank-1 branch of ``update``
  (:1075-1212, with ``core/rank1.py``; a single new point is a full
  rebuild here), ``predict_full``, ``quad``, ``random_function``,
  ``predict_quantile`` and ``plot`` (:2120-2162, :2295-2510,
  :2660-3049), output warping and the CG / matrix-free posteriors
  (:1300-1391, ``predict``'s outwarp branches :2205-2259), the mesh tier
  (``mesh``, :312-323, :1981-2012), the recommended bounds and
  ``get_priors`` (:808-874), and ``__repr__``/``__str__`` (:681-731);
- for good, being TPU-only: ``mxu_predict`` (:301-311, :527-538),
  ``pad_bucket`` shape bucketing (:288-296, :392-461; it exists to reuse
  compiled XLA programs), the stacked-factor cache ``_stack_cache`` and
  the live-GP HBM pre-flight (:169-237, :350-375, :518-551), and the
  compile log (:1392-1400).
"""

import numpy as np
import scipy as sp
import torch

from ._config import LCHOL_THRESHOLD
from .core.model import ModelSpec
from .core.nlml import get_fns, posterior_factors, value_and_grad
from .core.priors import build_prior_pack, log_prior
from .f_min_fill import smoothbox_cdf, smoothbox_student_t_cdf
from .ops.linalg import neg_inverse_from_chol
from .serving import (
    _post_small,
    _scaled_upper_batch,
    _sw_batch,
    predict_chunked,
    prior_branch,
)

_TORCH_DTYPES = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
}

# Host-memory budget for one batch of posterior factorizations when the
# GP lives on the CPU (gpyreg_tpu/gp.py:647 uses the same 8 GiB).
_CPU_POSTERIOR_BUDGET = 8 * 2**30

# Each (N, chunk) temporary of the predictive chunk loop (the
# cross-covariance, the scaled right-hand side and the solve's result) is
# held to 2**28 elements, 1 GiB in float32: three of them are 3 GiB of an
# 80 GB card.  At N = 16384, 8 samples, 100k test points on an NVIDIA
# H100 80GB HBM3 at a 700.00 W power limit, chunks of 4096 / 8192 / 16384
# points served 17.1k / 17.8k / 18.0k points/s (the chunk sweep of
# tools/profile_torch_slice.py): the triangular solve, which takes over
# 90% of the time, runs faster the wider its right-hand side.
_PREDICT_CHUNK_ELEMS = 2**28


def resolve_device(device=None):
    """``device`` as a ``torch.device``; None means the card.  There is no
    fallback: without CUDA, the default raises and the caller passes
    ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "gpyreg_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the CPU."
        )
    return torch.device("cuda")


class Posterior:
    """Per-hyperparameter-sample posterior factors.

    Field semantics identical to reference gaussian_process.py:2568-2587:
    alpha = (K + sn2_mult*Sigma)^-1 (y - m); sW = 1/sqrt(min(sn2)*sn2_mult);
    L is the upper Cholesky factor of the scaled matrix when L_chol, else
    the explicit negative inverse.  The factors are tensors on the GP's
    device.
    """

    __slots__ = ("hyp", "alpha", "sW", "L", "sn2_mult", "L_chol")

    def __init__(self, hyp, alpha, sW, L, sn2_mult, Lchol):
        self.hyp = hyp
        self.alpha = alpha
        self.sW = sW
        self.L = L
        self.sn2_mult = sn2_mult
        self.L_chol = Lchol


class GP:
    """A single exact Gaussian Process (see module docstring).

    Parameters
    ----------
    D : int
        Input dimension.
    covariance, mean, noise : objects from
        :mod:`gpyreg_tpu_torch.covariance_functions`,
        :mod:`gpyreg_tpu_torch.mean_functions`,
        :mod:`gpyreg_tpu_torch.noise_functions`.
    dtype : numpy float64 (default) or float32
        Device computation type; host state stays float64.
    fast_predict : bool
        Store every posterior in the explicit-inverse parametrization
        (the reference's low-noise branch, gaussian_process.py:2440-2448):
        predictions become matrix products instead of triangular solves.
    pallas_predict : bool
        Accepted for the JAX package's API and stored; it changes no
        route.  A float32 GP on a CUDA device always builds its
        covariances with the kernel tile (``ops/tile_kernels.py``); on
        the CPU, and in float64, the plain composition serves.
    device : torch.device or str
        Where the factors live and the work runs: the CUDA card by
        default (raising when there is none), ``"cpu"`` on request.
    """

    def __init__(
        self,
        D: int,
        covariance: object,
        mean: object,
        noise: object,
        dtype=None,
        fast_predict: bool = False,
        pallas_predict: bool = False,
        device=None,
    ):
        self.D = D
        self.covariance = covariance
        self.mean = mean
        self.noise = noise
        self.fast_predict = bool(fast_predict)
        self.pallas_predict = bool(pallas_predict)
        self.dtype = np.dtype(dtype if dtype is not None else np.float64)
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(f"dtype must be float64 or float32, got {dtype}")
        self.device = resolve_device(device)
        self.s2 = None
        self.X = None
        self.y = None
        self.posteriors = None
        self.no_prior = None
        self.normalization_constants = None
        self._ctx = None
        self._fit_ctx = None
        self.set_bounds()
        self.set_priors()
        # Scratch dict used by PyVBMC (reference gaussian_process.py:61-62).
        self.temporary_data = {}

    # ------------------------------------------------------------------
    # Device plumbing
    # ------------------------------------------------------------------

    @property
    def _tdtype(self):
        return _TORCH_DTYPES[self.dtype]

    def _spec(self) -> ModelSpec:
        p = self.noise.parameters
        return ModelSpec(
            D=self.D,
            cov=self.covariance._kind,
            mean=self.mean._kind,
            noise_constant=bool(p[0] == 1),
            noise_user=int(p[1]),
            noise_rectified=bool(p[2] == 1),
        )

    def _invalidate(self):
        self._ctx = None
        self._fit_ctx = None

    def _tensor(self, a):
        return torch.as_tensor(
            np.asarray(a, dtype=self.dtype), device=self.device
        )

    def _data(self):
        """(X, y, s2) as tensors on the device, built once per data set."""
        if self._ctx is None:
            self._ctx = tuple(
                None if a is None else self._tensor(a)
                for a in (self.X, self.y, self.s2)
            )
        return self._ctx

    def _device(self):
        """(spec, fns, obj_args, pack), built once per data set, bounds and
        priors (``gpyreg_tpu/gp.py:392-461``).  ``obj_args`` are the
        arguments after ``hyp`` of every function in ``fns``: the data
        tensors on the device, then the prior pack unless ``no_prior``;
        None without data."""
        if self._fit_ctx is None:
            spec = self._spec()
            has_s2 = self.s2 is not None
            has_prior = not self.no_prior
            fns = get_fns(spec, has_s2, has_prior)
            pack = None
            if has_prior:
                pack = build_prior_pack(
                    self.hyper_priors,
                    self.lower_bounds,
                    self.upper_bounds,
                    log_norm=float(np.sum(np.log(self.normalization_constants))),
                    device=self.device,
                )
            args = None
            if self.X is not None and self.y is not None:
                X, y, s2 = self._data()
                args = (X, y) + ((s2,) if has_s2 else ())
                if pack is not None:
                    args = args + (pack,)
            self._fit_ctx = (spec, fns, args, pack)
        return self._fit_ctx

    def _obj_args(self):
        _, fns, args, _ = self._device()
        return fns, args

    def _objective(self, hyp, grad=False, swap_sign=False):
        """Scalar objective nlZ - log_prior (prior included unless
        no_prior), mirroring __gp_obj_fun (gaussian_process.py:1540)."""
        fns, args = self._obj_args()
        h = np.asarray(hyp, dtype=np.float64)
        if grad:
            v, g = fns["obj_grad"](h, *args)
            v, g = float(v), g.cpu().numpy()
            return (-v, -g) if swap_sign else (v, g)
        v = float(fns["obj"](h, *args))
        return -v if swap_sign else v

    def _objective_batch(self, hyps):
        """Objective values over (B, hyp_N) candidates
        (``gpyreg_tpu/gp.py:481-516``).  The lanes run one at a time, so
        one lane's (N, N) buffers are live at once and the JAX package's
        chunk budget, which bounds a vmapped program's workspace, has
        nothing to bound."""
        fns, args = self._obj_args()
        v = fns["obj_batch"](np.asarray(hyps, dtype=np.float64), *args)
        return v.cpu().numpy().astype(np.float64)

    def _posterior_batch_size(self, N, remaining):
        """Samples factorized together: the working set of one sample is
        about three (N, N) matrices (the kernel, its factor and the
        solver's workspace or the explicit inverse)."""
        per_sample = 3 * N * N * self.dtype.itemsize
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
            budget = int(0.8 * free)
        else:
            budget = _CPU_POSTERIOR_BUDGET
        return int(max(1, min(remaining, budget // max(1, per_sample))))

    def _finalize_posteriors(self, hyp_arr, alphas, Ls, mults, sn2mins):
        """Turn raw batched factors (alpha, chol(G), mult, sn2_min;
        leading sample axis) into Posterior objects.  One device-to-host
        copy for the per-sample scalars; the parametrization split
        (reference gaussian_process.py:2404) is decided on the host."""
        mults_h, sn2mins_h, bad = _post_small(alphas, mults, sn2mins)
        if np.any(bad > 0):
            raise np.linalg.LinAlgError(
                "Singular matrix for L Cholesky decomposition"
            )
        flags = (sn2mins_h >= LCHOL_THRESHOLD) & (not self.fast_predict)
        sWs = _sw_batch(Ls, sn2mins_h, mults_h)

        S = hyp_arr.shape[0]
        L_stored = [None] * S
        for flag in (True, False):
            idx = np.nonzero(flags == flag)[0]
            if idx.size == 0:
                continue
            sub = Ls if idx.size == S else Ls[torch.as_tensor(idx)]
            if flag:
                out = _scaled_upper_batch(sub, sn2mins_h[idx] * mults_h[idx])
            else:
                out = neg_inverse_from_chol(sub)
            for j, s in enumerate(idx):
                L_stored[s] = out[j]
        return [
            Posterior(
                np.asarray(hyp_arr[s], dtype=np.float64).copy(),
                alphas[s],
                sWs[s],
                L_stored[s],
                float(mults_h[s]),
                bool(flags[s]),
            )
            for s in range(S)
        ]

    def _compute_posteriors(self, hyp_arr):
        """Posterior factors for all samples, in batches sized to the
        memory the device has free."""
        spec = self._spec()
        X, y, s2 = self._data()
        hyp_arr = np.asarray(hyp_arr, dtype=np.float64)
        S, N = hyp_arr.shape[0], X.shape[0]
        posts = []
        start = 0
        with torch.no_grad():
            while start < S:
                stop = start + self._posterior_batch_size(N, S - start)
                alphas, Ls, mults, sn2mins = posterior_factors(
                    spec, hyp_arr[start:stop], X, y, s2
                )
                posts.extend(
                    self._finalize_posteriors(
                        hyp_arr[start:stop], alphas, Ls, mults, sn2mins
                    )
                )
                del alphas, Ls
                start = stop
        return posts

    # ------------------------------------------------------------------
    # Bounds, priors and hyperparameter access
    # ------------------------------------------------------------------

    def _hyper_info(self):
        return (
            self.covariance.hyperparameter_info(self.D)
            + self.noise.hyperparameter_info()
            + self.mean.hyperparameter_info(self.D)
        )

    def _hyp_counts(self):
        cov_N = self.covariance.hyperparameter_count(self.D)
        mean_N = self.mean.hyperparameter_count(self.D)
        noise_N = self.noise.hyperparameter_count()
        return cov_N, noise_N, mean_N

    def _hyp_N(self):
        return sum(self._hyp_counts())

    def set_bounds(self, bounds: dict = None):
        """Set hyperparameter lower/upper bounds from a dict of
        ``name -> (lb, ub)`` (``None`` entry or argument = unset/NaN)."""
        hyp_N = self._hyp_N()
        lower_bounds = np.full((hyp_N,), np.nan)
        upper_bounds = np.full((hyp_N,), np.nan)
        lower = 0
        for name, count in self._hyper_info():
            if bounds is None:
                vals = None
            elif name not in bounds:
                raise ValueError("Missing hyperparameter " + name)
            else:
                vals = bounds[name]
            if vals is not None:
                lower_bounds[lower : lower + count] = vals[0]
                upper_bounds[lower : lower + count] = vals[1]
            lower += count
        self.lower_bounds = lower_bounds
        self.upper_bounds = upper_bounds
        self._invalidate()
        if self.no_prior is not None:
            self.__recompute_normalization_constants()

    def get_bounds(self):
        """Current bounds as a dict of ``name -> (lb, ub)``."""
        return self.bounds_to_dict(self.lower_bounds, self.upper_bounds)

    def bounds_to_dict(self, lower_bounds, upper_bounds):
        """Convert bound arrays to the named-dict form."""
        out = {}
        lower = 0
        for name, count in self._hyper_info():
            idx = range(lower, lower + count)
            out[name] = (lower_bounds[idx], upper_bounds[idx])
            lower += count
        return out

    def set_priors(self, priors: dict = None):
        """Store hyperpriors from a dict of ``name -> (type, params)``;
        types gaussian, student_t, smoothbox, smoothbox_student_t
        (reference gaussian_process.py:418-514).  Recomputes the
        truncation constants at the current bounds."""
        hyp_N = self._hyp_N()
        table = {k: np.full((hyp_N,), np.nan) for k in ("mu", "sigma", "df", "a", "b")}
        fields = {
            "gaussian": ("mu", "sigma"),
            "student_t": ("mu", "sigma", "df"),
            "smoothbox": ("a", "b", "sigma"),
            "smoothbox_student_t": ("a", "b", "sigma", "df"),
        }
        non_trivial = False
        lower = 0
        for name, count in self._hyper_info():
            vals = None
            if priors is not None:
                if name not in priors:
                    raise ValueError("Missing hyperparameter " + name)
                vals = priors[name]
            if vals is not None:
                non_trivial = True
                prior_type, params = vals
                if prior_type not in fields:
                    raise ValueError("Unknown hyperprior type " + prior_type)
                i = range(lower, lower + count)
                for key, v in zip(fields[prior_type], params):
                    table[key][i] = v
                if "df" not in fields[prior_type]:
                    table["df"][i] = 0
            lower += count
        self.hyper_priors = table
        self.no_prior = not non_trivial
        self._invalidate()
        self.__recompute_normalization_constants()

    def __recompute_normalization_constants(self):
        """Truncation normalization of bounded priors via CDFs at the
        bounds (``gpyreg_tpu/gp.py:940-981``, reference
        gaussian_process.py:1234-1273)."""
        lb, ub = self.lower_bounds, self.upper_bounds
        table = self.hyper_priors
        mu, df = table["mu"], table["df"]
        sigma = np.abs(table["sigma"])
        a, b = table["a"], table["b"]

        # Mass is needed where the dimension is not pinned, a bound is
        # finite and a proper prior is attached.
        needs_mass = (
            (lb != ub)
            & (np.isfinite(lb) | np.isfinite(ub))
            & (np.isfinite(mu) | np.isfinite(sigma))
        )
        boxed = np.isfinite(a) & np.isfinite(b)
        heavy = np.isfinite(df) & (df != 0)

        z = np.ones(lb.shape)
        for i in np.flatnonzero(needs_mass):
            if boxed[i] and heavy[i]:
                edges = [
                    smoothbox_student_t_cdf(v, df[i], sigma[i], a[i], b[i])
                    for v in (ub[i], lb[i])
                ]
            elif boxed[i]:
                edges = [
                    smoothbox_cdf(v, sigma[i], a[i], b[i])
                    for v in (ub[i], lb[i])
                ]
            elif heavy[i]:
                rv = sp.stats.t(df[i], loc=mu[i], scale=sigma[i])
                edges = [rv.cdf(ub[i]), rv.cdf(lb[i])]
            else:
                rv = sp.stats.norm(loc=mu[i], scale=sigma[i])
                edges = [rv.cdf(ub[i]), rv.cdf(lb[i])]
            z[i] = edges[0] - edges[1]

        self.normalization_constants = z
        self._invalidate()

    def get_hyperparameters(self, as_array: bool = False):
        """Hyperparameters as (hyp_samples, hyp_N) array or list of
        name->value dicts; NaN-filled if none set yet."""
        if self.posteriors is None:
            hyp = np.full((1, self._hyp_N()), np.nan)
        else:
            hyp = np.stack([p.hyp.copy() for p in self.posteriors])
        return hyp if as_array else self.hyperparameters_to_dict(hyp)

    def set_hyperparameters(self, hyp_new, compute_posterior: bool = True):
        """Replace hyperparameters (array or dict form)."""
        if isinstance(hyp_new, np.ndarray):
            hyp_new = np.atleast_2d(hyp_new)
            if hyp_new.shape[1] != self._hyp_N():
                raise ValueError(
                    "Input hyperparameter array is the wrong shape!"
                )
        else:
            hyp_new = self.hyperparameters_from_dict(hyp_new)
        self.update(hyp=hyp_new, compute_posterior=compute_posterior)

    def hyperparameters_to_dict(self, hyp_arr):
        """(hyp_samples, hyp_N) array -> list of name->values dicts."""
        hyp_arr = np.atleast_2d(hyp_arr)
        if hyp_arr.shape[1] != self._hyp_N():
            raise ValueError("Input hyperparameter array is the wrong shape!")
        out = []
        for row in hyp_arr:
            d, i = {}, 0
            for name, count in self._hyper_info():
                d[name] = row[i : i + count].copy()
                i += count
            out.append(d)
        return out

    def hyperparameters_from_dict(self, hyp_dict_list):
        """List of name->values dicts -> (hyp_samples, hyp_N) array."""
        if isinstance(hyp_dict_list, dict):
            hyp_dict_list = [hyp_dict_list]
        out = np.zeros((len(hyp_dict_list), self._hyp_N()))
        for k, d in enumerate(hyp_dict_list):
            j = 0
            for name, count in self._hyper_info():
                out[k, j : j + count] = d[name]
                j += count
        return out

    # ------------------------------------------------------------------
    # Data updates
    # ------------------------------------------------------------------

    def update(
        self,
        X_new: np.ndarray = None,
        y_new: np.ndarray = None,
        s2_new: np.ndarray = None,
        hyp: np.ndarray = None,
        compute_posterior: bool = True,
    ):
        """Add data and/or replace hyperparameters, then rebuild every
        sample's posterior (reference gaussian_process.py:691-884, full
        rebuild; the rank-1 branch arrives with ``core/rank1.py``)."""
        X_new, y_new, s2_new = self._convert_shapes(X_new, y_new, s2_new)
        for name, new in (("X", X_new), ("y", y_new), ("s2", s2_new)):
            if new is not None:
                old = getattr(self, name)
                setattr(
                    self,
                    name,
                    new.copy() if old is None else np.concatenate((old, new)),
                )
        self._invalidate()

        if hyp is None:
            hyp = self.get_hyperparameters(as_array=True)
        hyp = np.atleast_2d(np.asarray(hyp, dtype=np.float64)).copy()
        if compute_posterior and self.X is not None and self.y is not None:
            # Release the old factors first: at N = 16384 a set of eight
            # samples holds 8.6 GB of the device in float32.
            self.posteriors = None
            self.posteriors = np.array(
                self._compute_posteriors(hyp), dtype=object
            )
        else:
            self.posteriors = np.array(
                [Posterior(h, None, None, None, None, None) for h in hyp],
                dtype=object,
            )

    def clean(self):
        """Drop reconstructible posterior factors and temporary data;
        rebuild with ``update(compute_posterior=True)``."""
        self.temporary_data = {}
        if self.posteriors is not None:
            for p in self.posteriors:
                p.alpha = p.sW = p.L = p.sn2_mult = p.L_chol = None

    # ------------------------------------------------------------------
    # Likelihood / posterior evaluations
    # ------------------------------------------------------------------

    def log_likelihood(self, hyp, compute_grad: bool = False):
        """(Positive) log marginal likelihood at ``hyp`` (array or dict),
        optionally with its gradient (``gpyreg_tpu/gp.py:1763-1774``)."""
        if isinstance(hyp, dict):
            hyp = self.hyperparameters_from_dict(hyp)
        hyp = np.asarray(hyp, dtype=np.float64).reshape(-1)
        fns, args = self._obj_args()
        if compute_grad:
            v, g = fns["nlz_grad"](hyp, *args)
            return -float(v), -g.cpu().numpy()
        return -float(fns["nlz"](hyp, *args))

    def log_posterior(self, hyp, compute_grad: bool = False):
        """(Positive) unnormalized log posterior, the log likelihood plus
        the log prior (``gpyreg_tpu/gp.py:1776-1786``)."""
        if isinstance(hyp, dict):
            hyp = self.hyperparameters_from_dict(hyp)
        hyp = np.asarray(hyp, dtype=np.float64).reshape(-1)
        if self.no_prior:
            return self.log_likelihood(hyp, compute_grad)
        if compute_grad:
            v, g = self._objective(hyp, grad=True)
            return -v, -g
        return -self._objective(hyp)

    # The reference's own tests reach its name-mangled internals
    # (``gpyreg_tpu/gp.py:1788-1825``); the same names, with the same
    # sign conventions, let that code run against the port.

    def __compute_nlZ(self, hyp, compute_grad, compute_prior):
        """Negative log marginal likelihood (minus log prior when
        ``compute_prior``); reference gaussian_process.py:1520-1538."""
        out = (
            self.log_posterior(hyp, compute_grad)
            if compute_prior
            else self.log_likelihood(hyp, compute_grad)
        )
        if compute_grad:
            return -out[0], -np.asarray(out[1])
        return -out

    def __compute_log_priors(self, hyp, compute_grad):
        """Log hyperprior (and gradient); reference
        gaussian_process.py:1275-1466."""
        hyp = np.asarray(hyp, dtype=np.float64).reshape(-1)
        pack = self._device()[3]
        if pack is None:
            if compute_grad:
                return 0.0, np.zeros(hyp.shape)
            return 0.0
        h = torch.as_tensor(hyp, device=self.device)
        if compute_grad:
            v, g = value_and_grad(lambda t: log_prior(pack, t), h, h)
            return float(v), g.cpu().numpy()
        return float(log_prior(pack, h))

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------

    def _predict_chunk(self, N, M):
        return int(max(1, min(M, _PREDICT_CHUNK_ELEMS // max(1, N))))

    def _group_predict(self, x_star):
        """Per-sample predictive mean and variance, (M, s_N) each, with
        one device-to-host copy at the end."""
        spec = self._spec()
        S = self.posteriors.size
        xs = self._tensor(x_star)
        M = xs.shape[0]
        out = torch.empty((2, S, M), dtype=self._tdtype, device=self.device)
        with torch.no_grad():
            if self.y is None:
                for s, p in enumerate(self.posteriors):
                    out[0, s], out[1, s] = prior_branch(spec, p.hyp, xs)
            else:
                X, _, _ = self._data()
                chunk = self._predict_chunk(X.shape[0], M)
                for s, p in enumerate(self.posteriors):
                    out[0, s], out[1, s] = predict_chunked(
                        spec, bool(p.L_chol), p.hyp, p.alpha, p.L, p.sW,
                        X, None, xs, chunk,
                    )
        packed = out.cpu().numpy().astype(np.float64)
        return packed[0].T.copy(), packed[1].T.copy()

    def predict(
        self,
        x_star: np.ndarray,
        y_star: np.ndarray = None,
        s2_star: np.ndarray = None,
        add_noise: bool = False,
        separate_samples: bool = False,
        return_lpd: bool = False,
    ):
        """Posterior mean and variance at ``x_star``; samples are either
        returned separately (M, s_N) or reduced as a Gaussian mixture
        (reference gaussian_process.py:1793-1811)."""
        x_star, y_star, s2_star = self._convert_shapes(
            x_star, y_star, s2_star
        )
        s_N = self.posteriors.size
        cov_N, noise_N, _ = self._hyp_counts()
        if return_lpd and y_star is None:
            raise ValueError(
                "Cannot calculate log predictive density without y_star."
            )

        mu, s2 = self._group_predict(x_star)
        s2 = np.maximum(s2, 0)  # clamp numerical negatives

        if return_lpd or add_noise:
            y_s2 = np.zeros_like(s2)
            for s, p in enumerate(self.posteriors):
                sn2_mult = 1 if p.sn2_mult is None else p.sn2_mult
                sn2_star = self.noise.compute(
                    p.hyp[cov_N : cov_N + noise_N], x_star, y_star, s2_star
                )
                y_s2[:, s : s + 1] = s2[:, s : s + 1] + np.reshape(
                    sn2_star * sn2_mult * np.ones((x_star.shape[0], 1)),
                    (-1, 1),
                )
        if return_lpd and separate_samples:
            lpd = -0.5 * (y_star - mu) ** 2 / y_s2 - 0.5 * np.log(
                2 * np.pi * y_s2
            )
        if add_noise:
            s2 = y_s2

        if not separate_samples:
            if s_N > 1:
                mu_bar = np.reshape(np.sum(mu, 1), (-1, 1)) / s_N
                v = np.sum((mu - mu_bar) ** 2, 1) / (s_N - 1)
                s2 = np.reshape(np.sum(s2, 1) / s_N + v, (-1, 1))
                mu = mu_bar
            else:
                v = 0
                mu = np.reshape(mu, (-1, 1))
                s2 = np.reshape(s2, (-1, 1))
            if return_lpd and add_noise:
                lpd = -0.5 * (y_star - mu) ** 2 / s2 - 0.5 * np.log(
                    2 * np.pi * s2
                )
            elif return_lpd:
                y_s2 = np.reshape(np.sum(y_s2, 1) / s_N + v, (-1, 1))
                lpd = -0.5 * (y_star - mu) ** 2 / y_s2 - 0.5 * np.log(
                    2 * np.pi * y_s2
                )

        if return_lpd:
            return mu, s2, lpd
        return mu, s2

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def save(self, path):
        """Serialize the GP to an ``.npz`` file with the keys of
        ``gpyreg_tpu.GP.save``: data, bounds, priors and hyperparameter
        samples; the O(N^2) factors are rebuilt on load."""
        if self.mean._kind.startswith("custom:"):
            raise ValueError(
                "GPs with a CustomMean cannot be serialized: the user "
                "callable is not representable in the .npz metadata."
            )
        meta = {
            "D": self.D,
            "cov_kind": self.covariance._kind,
            "mean_kind": self.mean._kind,
            "noise_parameters": np.asarray(self.noise.parameters),
            "dtype": str(self.dtype),
            "no_prior": -1 if self.no_prior is None else int(self.no_prior),
            "outwarp_kind": "",
            "fast_predict": int(self.fast_predict),
            "infer_method": 0,
        }
        arrays = {f"meta_{k}": v for k, v in meta.items()}
        for name in ("X", "y", "s2"):
            v = getattr(self, name)
            if v is not None:
                arrays[name] = v
        arrays["lower_bounds"] = self.lower_bounds
        arrays["upper_bounds"] = self.upper_bounds
        for k, v in self.hyper_priors.items():
            arrays[f"prior_{k}"] = v
        if self.posteriors is not None:
            arrays["hyp"] = self.get_hyperparameters(as_array=True)
            arrays["has_factors"] = np.asarray(
                self.posteriors[0].alpha is not None
            )
        np.savez_compressed(path, **arrays)

    @classmethod
    def load(cls, path, device=None):
        """Reconstruct a GP saved by ``gpyreg_tpu.GP.save`` or
        :meth:`save`, on ``device`` (the card by default), with its
        bounds, prior table and normalization constants; posterior
        factors are recomputed."""
        from .convert import gp_from_arrays

        with np.load(path, allow_pickle=False) as z:
            if "meta_outwarp_kind" in z and str(z["meta_outwarp_kind"]):
                raise NotImplementedError(
                    "Output warping is not ported yet (outwarp_functions)."
                )
            if "meta_infer_method" in z and int(z["meta_infer_method"]):
                raise NotImplementedError(
                    "Matrix-free (CG) posteriors are not ported yet."
                )
            meta = {
                k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")
            }
            arrays = {k: z[k] if k in z else None for k in ("X", "y", "s2", "hyp")}
            has_factors = bool(z["has_factors"]) if "has_factors" in z else False
            bounds = (z["lower_bounds"], z["upper_bounds"])
            priors = {
                k[len("prior_"):]: z[k] for k in z.files if k.startswith("prior_")
            }
        return gp_from_arrays(
            meta, arrays["X"], arrays["y"], arrays["s2"], arrays["hyp"],
            device=device, compute_posterior=has_factors, bounds=bounds,
            hyper_priors=priors,
        )

    # ------------------------------------------------------------------
    # Shapes
    # ------------------------------------------------------------------

    def _convert_shapes(self, X, y, s2):
        """Normalize user inputs to the canonical (N, D) / (N, 1)
        layouts (reference gaussian_process.py:2523-2565: a 1-D X is a
        single point, y/s2 columns follow X's row count, a scalar s2
        broadcasts)."""
        if X is None and y is None and s2 is None:
            return None, None, None
        if X is None:
            if not hasattr(self.X, "shape"):
                raise AttributeError(
                    f"self.X is not a numpy array, self.X = {self.X}"
                )
            N = self.X.shape[0]
        else:
            X = np.atleast_2d(np.asarray(X))
            if X.ndim > 2:
                raise ValueError("X need to be an array of shape (N, D)")
            N = X.shape[0]
            if X.shape[1] != self.D:
                raise ValueError(
                    f"The dimension of input data {X.shape[1]} "
                    f"doesn't match GP's input dimension {self.D}."
                )
        if y is not None:
            y = np.asarray(y).reshape(N, 1)
        if isinstance(s2, (float, int)):
            s2 = np.full((N, 1), float(s2))
        elif isinstance(s2, np.ndarray):
            s2 = s2.reshape(N, 1)
        elif s2 is not None:
            raise TypeError(
                "s2 type need to be Union[np.ndarray, float, int, None]."
            )
        return X, y, s2
