"""The GP model object: the serving, likelihood and fitting shell over
the PyTorch core.

Port of the serving, likelihood and fitting parts of
``gpyreg_tpu/gp.py``.  The public surface mirrors the reference ``GP``
class (gaussian_process.py:24-2565): the constructor, the hyperparameter
naming ABI, bounds (with the recommended ones) and priors with their
normalization constants (:758-981), ``update``, ``predict``,
``log_likelihood`` / ``log_posterior`` with their gradients and the
reference-private shims ``_GP__compute_nlZ`` /
``_GP__compute_log_priors`` (:1763-1825), the objective
``_objective`` / ``_objective_batch`` (:467-516), ``fit`` (:1402-1757:
design, start selection, multistart MAP through
``inference/fit_phases.py``, the hyperposterior sampling phase and the
slicelite warm refit through ``inference/sampling.py``) with
``_f32_noise_floor`` (:1355-1390), ``sample`` with
``_mixture_mean_variance_fn`` and ``_require_factors`` (:2736-2783,
:2828-2890, :1300-1310), ``save``/``load`` and the ``Posterior`` field
semantics, so PyVBMC-style consumers read the same fields.  Tensors live
on the GP's ``device``, the card unless the caller asks for the CPU; the
test points are served in chunks.  A float32 GP on a CUDA device builds
every self- and cross-covariance with the hand-written kernel tile, and
takes the gradient of its self-covariance with the hand-written gradient
tile (``ops/kernels.py`` dispatches).

The rest of serving (``gpyreg_tpu/gp.py:1075-1236``, :2120-2162,
:2295-2510, :2660-2826, :2896-3047, :681-731): the rank-1 branch of
``update`` (``core/rank1.py``), ``predict_full``, ``quad``,
``random_function``, ``predict_quantile``, ``fmin``, ``plot`` and
``__repr__``/``__str__``.

Output warping (``outwarp``, :261-275, :743-765, :831-835, ``fit``'s
``outwarp_fun`` :1550-1558, ``predict``'s branches :2205-2275,
``predict_quantile``'s :2693-2731, the refusals of ``predict_full`` and
``quad`` :2129, :2310, no rank-1 update :1090) and the matrix-free tier
(``Posterior.matrix_free``, ``fit``'s ``method="cg"`` and ``"auto"``
through ``inference/cg_fit.py`` :1612-1630, ``update``'s matrix-free
branch :1238-1262, ``_require_factors`` and ``_cg_serve`` :1299-1343,
``save``/``load``'s ``infer_method`` :2541, :2634-2652).  One departure:
``fit`` refuses output warping together with the CG method (a
``ValueError`` before any state changes), where the JAX package fits the
unwarped ``y`` and serves it as if it were warped (``ops/iterative.py:
435-444`` never warps, ``gp.py:2240-2259`` back-transforms).

The mesh (``mesh``, :312-323; ``parallel/mesh.py``): ``predict`` shards
the test points (:1981-2012) and ``quad`` the measures (:2355-2377)
over it, one sample's factors replicated on each shard's device; ``fit``
shards the design rows and the restart lanes
(``inference/map_optimize.py``) and the chains of ``n_chains`` and of
the slicelite refit (``inference/device_slice.py``).  ``update``,
``predict_full``, ``random_function`` and the rest run on the GP's
device, as in JAX.

Left out, with the JAX package's lines, for good, being TPU-only:
``mxu_predict`` (:301-311, :527-538) and its composition with the mesh
(``mxu_mesh``, :1994-1997),
``pad_bucket`` shape bucketing (:288-296, :392-461; it exists to reuse
compiled XLA programs, so the rank-1 update grows each factor by one
row and column instead of writing into padding, and needs no
bucket-full rule, :1104-1107), the stacked-factor cache
``_stack_cache`` and the live-GP HBM pre-flight with ``fit``'s warning
and ``_device_factor_bytes`` (:169-237, :350-375, :518-551,
:1521-1542), and the compile log and ``fit_timings``' ``n_compiles`` /
``compile_s`` (:1392-1400).  ``fit``'s ``trace_dir`` (:1505-1509, a hook
into the JAX profiler) runs the fit under ``torch.profiler`` instead, and
the layers record their spans there (``tracing.py``).
"""

import warnings
from textwrap import indent

import numpy as np
import scipy as sp
import torch

from . import covariance_functions as _cov_mod
from . import mean_functions as _mean_mod
from ._config import LCHOL_THRESHOLD, resolve_device
from .core import rank1 as _rank1
from .core.model import ModelSpec
from .core.nlml import get_fns, posterior_factors, value_and_grad
from .core.priors import build_prior_pack, log_prior
from .f_min_fill import smoothbox_cdf, smoothbox_student_t_cdf
from .formatting import full_repr
from .inference import device_slice as _device_slice
from .inference import fit_phases as _fit_phases
from .inference import map_optimize as _map_optimize
from .inference import sampling as _sampling
from .ops.linalg import neg_inverse_from_chol
from .parallel.mesh import make_mesh
from .tracing import Timings, phase, profile, span
from .serving import (
    _post_small,
    _scaled_upper_batch,
    _sw_batch,
    chol_branch,
    chol_branch_full,
    inv_branch,
    inv_branch_full,
    mean_branch,
    predict_chunked,
    predict_sharded,
    prior_branch,
    prior_branch_full,
    quad_moments,
    quad_sharded,
    random_draw,
    random_prior_draw,
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


class Posterior:
    """Per-hyperparameter-sample posterior factors.

    Field semantics identical to reference gaussian_process.py:2568-2587:
    alpha = (K + sn2_mult*Sigma)^-1 (y - m); sW = 1/sqrt(min(sn2)*sn2_mult);
    L is the upper Cholesky factor of the scaled matrix when L_chol, else
    the explicit negative inverse.  The factors are tensors on the GP's
    device.  Assigning ``alpha``, ``sW`` or ``L`` stores the value as
    given and marks the field as the caller's (``gpyreg_tpu/gp.py:
    135-140``): a rank-1 ``update`` then rebuilds the posteriors instead
    of extending a factor it did not build.
    """

    __slots__ = ("hyp", "sn2_mult", "L_chol", "matrix_free", "n_real",
                 "_alpha", "_sW", "_L", "_direct")

    def __init__(self, hyp, alpha, sW, L, sn2_mult, Lchol,
                 matrix_free=False):
        self.hyp = hyp
        self._alpha = alpha
        self._sW = sW
        self._L = L
        self.sn2_mult = sn2_mult
        self.L_chol = Lchol
        # matrix_free: no stored O(N^2) factor; predictions run through
        # the CG tier (ops/iterative.py), and ``_alpha`` caches the padded
        # CG weight vector after the first predict, whose first ``n_real``
        # rows ``alpha`` shows (gpyreg_tpu/gp.py:114-135).
        self.matrix_free = matrix_free
        self.n_real = None
        self._direct = set()

    def _set(self, name, v):
        setattr(self, "_" + name, v)
        self._direct.add(name)

    @property
    def alpha(self):
        a = self._alpha
        if a is None or self.n_real is None or "alpha" in self._direct:
            return a
        return a[: self.n_real]

    @alpha.setter
    def alpha(self, v):
        self._set("alpha", v)

    @property
    def sW(self):
        return self._sW

    @sW.setter
    def sW(self, v):
        self._set("sW", v)

    @property
    def L(self):
        return self._L

    @L.setter
    def L(self, v):
        self._set("L", v)


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
    outwarp : object from :mod:`gpyreg_tpu_torch.outwarp_functions`
        Optional output warping; its hyperparameters come after the
        mean's in the flat vector.
    device : torch.device or str
        Where the factors live and the work runs: the CUDA card by
        default (raising when there is none), ``"cpu"`` on request.
    mesh : :class:`gpyreg_tpu_torch.parallel.mesh.Mesh` or int
        Shards ``predict``, ``quad`` and ``fit``'s design, restarts and
        chains over the mesh's devices (see the module docstring); an int
        builds ``make_mesh(mesh)`` on the GP's device type.  None: the
        GP's device alone.
    """

    def __init__(
        self,
        D: int,
        covariance: object,
        mean: object,
        noise: object,
        dtype=None,
        outwarp: object = None,
        fast_predict: bool = False,
        pallas_predict: bool = False,
        device=None,
        mesh=None,
    ):
        self.D = D
        self.covariance = covariance
        self.mean = mean
        self.noise = noise
        self.outwarp = outwarp
        self.fast_predict = bool(fast_predict)
        self.pallas_predict = bool(pallas_predict)
        self.dtype = np.dtype(dtype if dtype is not None else np.float64)
        if self.dtype not in _TORCH_DTYPES:
            raise ValueError(f"dtype must be float64 or float32, got {dtype}")
        self.device = resolve_device(device)
        if isinstance(mesh, int):
            mesh = make_mesh(mesh, device=self.device.type)
        self.mesh = mesh
        self.s2 = None
        self.X = None
        self.y = None
        self.posteriors = None
        self.no_prior = None
        self.normalization_constants = None
        self._ctx = None
        self._fit_ctx = None
        # "exact" (Cholesky factors) or "cg" (the matrix-free tier, set by
        # fit(options={"method": "cg"})), with the CG serving options.
        self._infer_method = "exact"
        self._cg_options = {}
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
            outwarp=None if self.outwarp is None else self.outwarp._kind,
        )

    def _invalidate(self):
        self._ctx = None
        self._fit_ctx = None

    def _tensor(self, a):
        return torch.as_tensor(
            np.asarray(a, dtype=self.dtype), device=self.device
        )

    def _data(self):
        """(X, y, s2) as tensors on the device, built once per data set;
        each array's copy is the sync span ``gpyreg.sync.data``."""
        if self._ctx is None:
            ctx = [None] * 3
            for i, a in enumerate((self.X, self.y, self.s2)):
                if a is not None:
                    with span("gpyreg.sync.data"):
                        ctx[i] = self._tensor(a)
            self._ctx = tuple(ctx)
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
            with span("gpyreg.sync.objective"):
                v, g = float(v), g.cpu().numpy()
            return (-v, -g) if swap_sign else (v, g)
        v = fns["obj"](h, *args)
        with span("gpyreg.sync.objective"):
            v = float(v)
        return -v if swap_sign else v

    def _objective_batch(self, hyps):
        """Objective values over (B, hyp_N) candidates
        (``gpyreg_tpu/gp.py:481-516``).  The lanes run one at a time, so
        one lane's (N, N) buffers are live at once and the JAX package's
        chunk budget, which bounds a vmapped program's workspace, has
        nothing to bound."""
        fns, args = self._obj_args()
        v = fns["obj_batch"](np.asarray(hyps, dtype=np.float64), *args)
        with span("gpyreg.sync.objective_batch"):
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
                with span("gpyreg.posterior.batch"):
                    alphas, Ls, mults, sn2mins = posterior_factors(
                        spec, hyp_arr[start:stop], X, y, s2
                    )
                    with span("gpyreg.posterior.finalize"):
                        posts.extend(self._finalize_posteriors(
                            hyp_arr[start:stop], alphas, Ls, mults, sn2mins
                        ))
                    del alphas, Ls
                start = stop
        return posts

    # ------------------------------------------------------------------
    # Representation
    # ------------------------------------------------------------------

    def __repr__(self):
        """Every attribute, the model's first (``gpyreg_tpu/gp.py:
        681-698``); the cached device tensors are left out."""
        return full_repr(
            self,
            "GP",
            order=[
                "D",
                "covariance",
                "mean",
                "noise",
                "X",
                "y",
                "s2",
                "lower_bounds",
                "upper_bounds",
                "posteriors",
            ],
            exclude=["_ctx", "_fit_ctx"],
        )

    def __str__(self):
        """A summary of the model (``gpyreg_tpu/gp.py:700-731``)."""
        def n_params(k):
            return f"{k} parameter" + ("" if k == 1 else "s")

        cov_name = type(self.covariance).__name__
        if cov_name == "Matern":
            cov_name += f"(degree={self.covariance.degree})\n"
        p0, p1, p2 = self.noise.parameters[:3]
        noise_flags = [
            flag
            for cond, flag in [
                (p0 == 1, "constant_add=True"),
                (p1 == 1, "user_provided_add=True"),
                (p1 == 2, "scale_user_provided=True"),
                (p2 == 1, "rectified_linear_output_dependent_add=True"),
            ]
            if cond
        ]
        noise_name = type(self.noise).__name__
        if noise_flags:
            noise_name += "(" + ", ".join(noise_flags) + ")"
        cov_N, noise_N, mean_N = self._hyp_counts()
        s_N = 0 if self.posteriors is None else np.size(self.posteriors)
        lines = [
            f"Dimension: {self.D}",
            f"Covariance function: {cov_name}, {n_params(cov_N)}",
            f"Mean function: {type(self.mean).__name__}, {n_params(mean_N)}",
            f"Noise function: {noise_name}, {n_params(noise_N)}",
            "Hyperparameter priors: " + ("none" if self.no_prior else "present"),
            f"Hyperparameter samples: {s_N}",
        ]
        return "GP:\n" + indent("\n".join(lines), "    ")

    # ------------------------------------------------------------------
    # Bounds, priors and hyperparameter access
    # ------------------------------------------------------------------

    def _hyper_info(self):
        info = (
            self.covariance.hyperparameter_info(self.D)
            + self.noise.hyperparameter_info()
            + self.mean.hyperparameter_info(self.D)
        )
        if self.outwarp is not None:
            info = info + self.outwarp.hyperparameter_info()
        return info

    def _hyp_counts(self):
        cov_N = self.covariance.hyperparameter_count(self.D)
        mean_N = self.mean.hyperparameter_count(self.D)
        noise_N = self.noise.hyperparameter_count()
        return cov_N, noise_N, mean_N

    def _outwarp_N(self):
        return 0 if self.outwarp is None else self.outwarp.hyperparameter_count()

    def _hyp_N(self):
        return sum(self._hyp_counts()) + self._outwarp_N()

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

    def get_recommended_bounds(self, lower_bounds=None, upper_bounds=None):
        """Recommended bounds dict; NaN entries in provided arrays are
        filled with data-driven recommendations (reference
        gaussian_process.py:260-359)."""
        if self.X is None or self.y is None:
            raise ValueError("GP does not have X or y set!")

        def resolve(arg, current):
            if isinstance(arg, (list, tuple, np.ndarray)):
                return np.array(arg, dtype=np.float64)
            if arg == "current":
                return current.copy()
            if arg is None or arg == "recommended":
                return np.full_like(current, np.nan)
            raise ValueError(
                "`lower_bounds` should be 'recommended'/`None`, "
                "'current', or an array."
            )

        lb = resolve(lower_bounds, self.lower_bounds)
        ub = resolve(upper_bounds, self.upper_bounds)

        # One recommended-bounds table for the whole flat hyp vector, in
        # canonical cov | noise | mean | outwarp order; NaN user entries
        # pick up the recommendation elementwise.
        modules = [self.covariance, self.noise, self.mean]
        if self.outwarp is not None:
            modules.append(self.outwarp)
        infos = [m.get_bounds_info(self.X, self.y) for m in modules]
        rec_lb = np.concatenate([info["LB"] for info in infos])
        rec_ub = np.concatenate([info["UB"] for info in infos])

        lb = np.where(np.isnan(lb), rec_lb, lb)
        ub = np.where(np.isnan(ub), rec_ub, ub)
        return self.bounds_to_dict(lb, np.maximum(lb, ub))

    def get_priors(self):
        """Current hyperpriors as a dict of
        ``name -> (type, params) | None``."""
        def decode(mu, sigma, df, a, b):
            """Classify one hyperparameter group's rows of the prior table
            back into the named family; None when they encode no (usable)
            prior."""
            light_tails = np.all(df == 0) or np.all(df == np.inf)
            heavy_tails = np.all(df > 0)
            if all(np.isfinite(v).all() for v in (a, b, sigma)):
                if light_tails:
                    return ("smoothbox", (a, b, sigma))
                if heavy_tails:
                    return ("smoothbox_student_t", (a, b, sigma, df))
            elif np.isfinite(mu).all() and np.isfinite(sigma).all():
                if light_tails:
                    return ("gaussian", (mu, sigma))
                if heavy_tails:
                    return ("student_t", (mu, sigma, df))
            return None

        table = self.hyper_priors
        out = {}
        pos = 0
        for name, count in self._hyper_info():
            rows = [
                table[k][pos : pos + count].copy()
                for k in ("mu", "sigma", "df", "a", "b")
            ]
            out[name] = decode(*rows)
            pos += count
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
        """Add data and/or replace hyperparameters, then bring every
        sample's posterior up to date (reference gaussian_process.py:
        691-884, ``gpyreg_tpu/gp.py:1053-1275``).

        A single new point (with ``y_new``, without ``s2_new``) on
        posteriors this GP built extends each sample's factors in O(N^2)
        (``core/rank1.py``; ``hyp`` is then ignored, as in the JAX
        package).  A sample whose update is numerically unstable warns and
        is rebuilt alone.  Anything else, posteriors holding a factor the
        caller assigned, and an output-warped GP rebuild every sample.  A
        GP fitted with ``method="cg"`` stores matrix-free posteriors
        instead: no factor is built, and the CG weight vector is solved at
        the first predict (``gpyreg_tpu/gp.py:1238-1262``)."""
        X_new, y_new, s2_new = self._convert_shapes(X_new, y_new, s2_new)
        N_old = None if self.X is None else self.X.shape[0]
        rank_one = (
            X_new is not None
            and y_new is not None
            and compute_posterior
            and self.X is not None
            and self.y is not None
            and X_new.shape[0] == 1
            and y_new.shape[0] == 1
            and s2_new is None
            and self.outwarp is None
            and self.posteriors is not None
            and self._rank_one_ready(N_old)
        )
        unstable = []
        if rank_one:
            with span("gpyreg.update.rank1"):
                unstable = self._rank_one_update(X_new, y_new)

        for name, new in (("X", X_new), ("y", y_new), ("s2", s2_new)):
            if new is not None:
                old = getattr(self, name)
                setattr(
                    self,
                    name,
                    new.copy() if old is None else np.concatenate((old, new)),
                )
        self._invalidate()

        if rank_one:
            if unstable:
                with span("gpyreg.update.full"):
                    fixed = self._compute_posteriors(
                        np.stack([self.posteriors[s].hyp for s in unstable])
                    )
                for p, s in zip(fixed, unstable):
                    self.posteriors[s] = p
            return

        if hyp is None:
            hyp = self.get_hyperparameters(as_array=True)
        hyp = np.atleast_2d(np.asarray(hyp, dtype=np.float64)).copy()
        if compute_posterior and self.X is not None and self.y is not None:
            # Release the old factors first: at N = 16384 a set of eight
            # samples holds 8.6 GB of the device in float32.
            self.posteriors = None
            if self._infer_method == "cg":
                posts = [Posterior(h, None, None, None, 1, None,
                                   matrix_free=True) for h in hyp]
            else:
                with span("gpyreg.update.full"):
                    posts = self._compute_posteriors(hyp)
            self.posteriors = np.array(posts, dtype=object)
        else:
            self.posteriors = np.array(
                [Posterior(h, None, None, None, None, None) for h in hyp],
                dtype=object,
            )

    def _rank_one_ready(self, N_old):
        """The JAX package's rank-1 eligibility of the posteriors
        (``gpyreg_tpu/gp.py:1081-1101``) without its padding rules: every
        sample holds factors this GP built (none assigned by the caller),
        of the old size, in the GP's dtype and on its device."""
        shapes = {"alpha": (N_old, 1), "sW": (N_old, 1), "L": (N_old, N_old)}
        dev = self.device
        for p in self.posteriors:
            if p._direct or p.L_chol is None or p.sn2_mult is None:
                return False
            for name, shape in shapes.items():
                v = getattr(p, name)
                if not (
                    isinstance(v, torch.Tensor)
                    and tuple(v.shape) == shape
                    and v.dtype == self._tdtype
                    and v.device.type == dev.type
                    and dev.index in (None, v.device.index)
                ):
                    return False
        return True

    def _rank_one_update(self, X_new, y_new):
        """Extend each sample's factors by the point (X_new, y_new), one
        sample at a time, so that the device holds the set plus one grown
        factor.  Each sample takes its own parametrization's update.
        Returns the indices of the samples whose update was unstable
        (``ok`` False): their factors are left as they were, and the
        caller rebuilds them on the grown data.

        If a sample's update raises (say, out of device memory), the
        samples already grown lose their factors, as after ``clean()``,
        and the error propagates with the data unchanged: no posterior is
        left a size apart from the data, and the next ``update`` rebuilds
        every sample.  Keeping the old factors to restore instead would
        double the peak (8.6 GB more at N = 16384, 8 samples)."""
        spec = self._spec()
        X, _, _ = self._data()
        cov_N, noise_N, _ = self._hyp_counts()
        x_new = self._tensor(X_new)
        y_t = self._tensor(y_new[0, 0])
        unstable, grown = [], []
        try:
            with torch.no_grad():
                for i, p in enumerate(self.posteriors):
                    sn2 = self.noise.compute(
                        p.hyp[cov_N : cov_N + noise_N], X_new, y_new, 0
                    )
                    sn2_eff = self._tensor(
                        float(np.ravel(sn2)[0]) * p.sn2_mult
                    )
                    fn = _rank1.chol_one if p.L_chol else _rank1.inv_one
                    with span("gpyreg.rank1.sample"):
                        L, alpha, sW, ok = fn(
                            spec, p.hyp, p.alpha, p.L, p.sW, X, x_new, y_t,
                            sn2_eff,
                        )
                        with span("gpyreg.sync.rank1_ok"):
                            ok = bool(ok)
                    if not ok:
                        unstable.append(i)
                        warnings.warn(
                            "Rank-one posterior update unstable for "
                            + f"posterior {i}. Reverting to full update.",
                            stacklevel=3,
                        )
                        continue
                    p._L, p._alpha, p._sW = L, alpha, sW
                    grown.append(p)
        except BaseException:
            for p in grown:
                p.alpha = p.sW = p.L = None
            raise
        return unstable

    def clean(self):
        """Drop reconstructible posterior factors and temporary data;
        rebuild with ``update(compute_posterior=True)``."""
        self.temporary_data = {}
        if self.posteriors is not None:
            for p in self.posteriors:
                p.alpha = p.sW = p.L = p.sn2_mult = p.L_chol = None

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    # float32 fits only: below sn2 ~ C*N*eps32*var(y) the kernel's
    # condition number exceeds 1/eps32, the float32 Cholesky cannot
    # factorize K and the jitter escalation silently acts as an unreported
    # extra noise term, so the fitted noise hyperparameter no longer means
    # what it says (its float64 NLML can be off by O(1) nats a point).
    # The floor makes the fitted hyperparameters dtype-honest.  The
    # reference has no analog (float64 only, LB = log(1e-6):
    # noise_functions.py:107).
    _F32_NOISE_FLOOR_C = 4.0
    _F32_NOISE_FLOOR_MIN_N = 4096

    def _f32_noise_floor(self, LB, UB, cov_N, options):
        """Return ``LB`` with the constant-noise lower bound raised to the
        float32 conditioning floor (no-op for float64, small N, noise
        functions without a constant term, or
        ``options={'f32_noise_floor': False}``).  Only the fit-local bounds
        change; ``self.lower_bounds`` and the reference bounds ABI are
        untouched."""
        mode = options.get("f32_noise_floor", "auto")
        if mode is False or mode is None:
            return LB
        if self.dtype != np.float32 or self.noise.parameters[0] != 1:
            return LB
        N = 0 if self.X is None else self.X.shape[0]
        if mode == "auto" and N < self._F32_NOISE_FLOOR_MIN_N:
            return LB
        var_y = float(np.var(self.y)) if self.y is not None else 0.0
        if not np.isfinite(var_y) or var_y <= 0 or N == 0:
            return LB
        if isinstance(mode, (int, float)) and not isinstance(mode, bool):
            floor = float(mode)  # explicit log-sigma floor
        else:
            floor = 0.5 * np.log(
                self._F32_NOISE_FLOOR_C
                * N
                * float(np.finfo(np.float32).eps)
                * var_y
            )
        i_sn = cov_N
        if floor <= LB[i_sn]:
            return LB
        LB = np.array(LB, copy=True)
        LB[i_sn] = min(floor, UB[i_sn])
        return LB

    def _fit_setup(self, X, y, s2, hyp0, options, outwarp_fun, df_base,
                   lower_bounds, upper_bounds):
        """The set-up of :meth:`fit` before its design: the data, the
        output warp, the bounds and the starting hyperparameters.  Returns
        (LB, UB, PLB, PUB, hyp0)."""
        X, y, s2 = self._convert_shapes(X, y, s2)
        if X is not None:
            self.X = X
        if y is not None:
            self.y = y
        if s2 is not None:
            self.s2 = s2
        self._invalidate()

        if outwarp_fun is not None and outwarp_fun is not self.outwarp:
            self.outwarp = outwarp_fun
            self.posteriors = None
            # set_bounds recomputes no normalization until set_priors has
            # sized the prior table to the new layout.
            self.no_prior = None
            self.set_bounds()
            self.set_priors()

        cov_N, noise_N, _ = self._hyp_counts()

        cov_info = self.covariance.get_bounds_info(self.X, self.y)
        mean_info = self.mean.get_bounds_info(self.X, self.y)
        noise_info = self.noise.get_bounds_info(self.X, self.y)

        self.hyper_priors["df"][np.isnan(self.hyper_priors["df"])] = df_base

        use_current_bounds = (
            isinstance(lower_bounds, str)
            and lower_bounds == "current"
            and isinstance(upper_bounds, str)
            and upper_bounds == "current"
        )
        if use_current_bounds and (
            np.any(np.isnan(self.lower_bounds))
            or np.any(np.isnan(self.upper_bounds))
        ):
            self.set_bounds(
                self.get_recommended_bounds(
                    self.lower_bounds, self.upper_bounds
                )
            )
        else:
            self.set_bounds(
                self.get_recommended_bounds(lower_bounds, upper_bounds)
            )

        LB = self.lower_bounds
        UB = self.upper_bounds
        LB = self._f32_noise_floor(LB, UB, cov_N, options)

        plb_parts = [cov_info["PLB"], noise_info["PLB"], mean_info["PLB"]]
        pub_parts = [cov_info["PUB"], noise_info["PUB"], mean_info["PUB"]]
        if self.outwarp is not None:
            ow_info = self.outwarp.get_bounds_info(self.X, self.y)
            plb_parts.append(ow_info["PLB"])
            pub_parts.append(ow_info["PUB"])
        PLB = np.concatenate(plb_parts)
        PUB = np.concatenate(pub_parts)
        PLB = np.minimum(np.maximum(PLB, LB), UB)
        PUB = np.maximum(np.minimum(PUB, UB), LB)

        if hyp0 is None:
            if self.posteriors is not None:
                hyp0 = self.get_hyperparameters(as_array=True)
            else:
                hyp0 = np.reshape(
                    np.minimum(np.maximum((PLB + PUB) / 2, LB), UB), (1, -1)
                )
        elif isinstance(hyp0, dict):
            hyp0 = self.hyperparameters_from_dict(hyp0)
        return LB, UB, PLB, PUB, hyp0

    def fit(
        self,
        X: np.ndarray = None,
        y: np.ndarray = None,
        s2: np.ndarray = None,
        hyp0=None,
        options: dict = None,
    ):
        """Train hyperparameters: space-filling design (ranked on the
        device) -> multistart MAP -> sampled hyperposterior ->
        refreshed posteriors.  Options and defaults mirror reference
        gaussian_process.py:910-1232 (``opts_N`` 3, ``init_N`` 1024,
        ``init_method`` "sobol", ``df_base`` 7, ``tol_opt`` 1e-5,
        ``tol_opt_mcmc`` 1e-3 for a MAP that starts a sampler,
        ``n_samples`` 10, ``thin`` 5, ``burn`` thin * n_samples,
        ``widths`` None, ``lower_bounds`` / ``upper_bounds`` "current"),
        plus the JAX package's:

        - ``optimizer_backend``: 'device' (default; hand-written L-BFGS
          over the device objective, ``inference/map_optimize.py``) or
          'scipy' (sequential L-BFGS-B restarts, matching the reference's
          optimizer exactly).
        - ``design_subset``: rank the design on an evenly-strided subset
          of that many data rows (off by default).
        - ``f32_noise_floor``: 'auto' (default) raises the fit-local
          lower bound of the constant-noise hyperparameter to the float32
          conditioning floor ``0.5*log(C*N*eps32*var(y))`` for float32
          fits at N >= 4096; ``True`` forces it at any N, ``False``
          disables, a number pins an explicit log-sigma floor.
        - ``sampler``: 'slicesample' (default, coordinate-wise slice),
          'slicelite' (the same chain, plus the warm-refit shortcut: when
          the previous samples' importance-weight ESS fraction under the
          new data exceeds ``ess_thresh`` (0.5), design and MAP are
          skipped and each previous sample is refreshed with a few
          no-adapt sweeps, gplite_train.m:178-197, 359-390; the previous
          log posteriors come from ``hyp0_logp`` (alias ``log_P``) or
          from this object's last fit), 'covsample' (random-direction
          slice, gplite_train.m:392-407), or 'laplace' (MAP only,
          whatever ``n_samples``; the JAX package documents it so and
          rejects it as an unknown sampler when ``n_samples > 0``),
          'mala' (Metropolis-adjusted Langevin, gplite_train.m:409-431;
          ``n_samples``, ``thin`` and ``burn`` are scaled by the number
          of hyperparameters), 'hmc' (leapfrog HMC, :433-447) or
          'eissample' (ensemble slice sampling, 2 (hyp_N + 1) walkers
          from a jittered cloud around the MAP).  MALA and HMC call the
          log posterior's value and gradient at every step, so on a
          float32 card GP each launches the gradient tile.
        - ``step_size``: the initial step size of 'mala' (default
          2.4 / sqrt(hyp_N)) and 'hmc' (default 0.01), adapted during
          burn-in; ``hmc_steps`` (10): the leapfrog steps of an HMC
          proposal.
        - ``sampler_backend``: 'device' (default; the chain of
          ``inference/device_slice.py``, each density on the GP's
          device) or 'host' (the parity ``SliceSampler`` driven by
          numpy's global stream).  'mala', 'hmc' and 'eissample'
          ignore it and ``n_chains``.
        - ``n_chains``: this many independent chains, run one after the
          other, with the cross-chain split R-hat;
          ``chain_start_jitter`` (0.1) overdisperses the starts of the
          chains after the first by that fraction of the widths;
          ``chain_thin`` (1) keeps every k-th sweep inside each chain;
          ``chain_group`` is accepted and changes nothing.
        - ``sample_width_base`` (default True): the MAP-phase widths act
          as a geometric floor on the end-of-burn 5*std width rule
          (reference slice_sample.py:535-543); False lets the rule stand
          alone.  Also ``step_out``, ``sampler_diagnostics`` and
          ``display``.

        - ``outwarp_fun``: attach an output warp at fit time (the MATLAB
          oracle's OutwarpFun, gplite_train.m:39); the hyperparameter
          layout changes, so bounds and priors reset and stale posteriors
          are dropped.
        - ``method``: 'exact' (default), 'cg' (the matrix-free tier,
          ``inference/cg_fit.py``: a small design ranked at CG tolerance
          1e-3, ``fit_cg``'s L-BFGS-B over the stochastic CG+SLQ NLML,
          matrix-free posteriors; options ``cg_row_chunk`` (1024),
          ``cg_max_iter`` (500), ``cg_tol`` (1e-5), ``cg_n_probes`` (8),
          ``cg_n_lanczos`` (32), ``cg_max_opt_iter`` (100),
          ``cg_warm_start`` (True), ``cg_init_N`` (16), ``cg_seed`` (0),
          ``cg_predict_tol`` (1e-6), ``cg_test_chunk`` (1024),
          ``cg_precond_rank`` (0), and for the fixed-probe chain, which
          runs only when ``n_samples`` is given, ``cg_sample_tol``,
          ``cg_sample_max_iter``, ``cg_sample_max_shrink``,
          ``cg_sample_driver``) or 'auto' (CG above ``cg_threshold_n``,
          32768 rows).  Output warping with the CG method raises
          ``ValueError`` before any state changes: the JAX package's CG
          objective never warps ``y``.

        - ``trace_dir``: run the fit under ``torch.profiler`` (the host,
          and the card's kernels on a CUDA GP) and write its trace into
          this directory, as the JAX package writes its profile there;
          the phases are the spans ``gpyreg.fit.design``, ``.optimize``,
          ``.sample`` and ``.posterior``, the port's layers inside them.

        ``fit_timings`` holds the host-clock seconds of the phases, each
        starting where the last ended, so that they add up to the fit's
        time, as in the JAX package: ``design_s``
        (the set-up, building and ranking the design), ``optimize_s``
        (the restarts; in a slicelite warm refit, the set-up and the ESS
        check, with ``design_s`` 0), ``sample_s`` when it samples and
        ``posterior_s``; ``fit_report`` holds every restart's result
        (``"restarts"``) and the best objective value of the design
        (``"design_best"``, None unless the fused path ranked one).

        Returns (hyp array, optimize_result, sampling_result): the
        sampler's result dict (``samples`` before thinning, ``f_vals``,
        ``log_priors``, ``exit_flag``, ``R``, ``eff_N``; for the slice
        samplers ``n_evals``, and on the device backend also ``n_sweeps``,
        the sweeps run, per chain for chains as ``n_evals``; for 'mala'
        and 'hmc' ``accept_rate``), None for a MAP fit.  The kept samples
        are every ``thin``-th of ``samples``, with ``thin`` as the sampler
        scaled it.
        """
        if options is None:
            options = {}
        if options.get("trace_dir", None):
            rest = {k: v for k, v in options.items() if k != "trace_dir"}
            with profile(options["trace_dir"], self.device):
                return self.fit(X, y, s2, hyp0, rest)
        opts_N = options.get("opts_N", 3)
        init_N = options.get("init_N", 2**10)
        init_method = options.get("init_method", "sobol")
        df_base = options.get("df_base", 7)
        thin = options.get("thin", 5)
        widths = options.get("widths", None)
        tol_opt = options.get("tol_opt", 1e-5)
        tol_opt_mcmc = options.get("tol_opt_mcmc", 1e-3)
        sampler_name = options.get("sampler", "slicesample")
        s_N = options.get("n_samples", 10)
        burn_in = options.get("burn", thin * s_N)
        lower_bounds = options.get("lower_bounds", "current")
        upper_bounds = options.get("upper_bounds", "current")

        method = options.get("method", "exact")
        if method == "auto":
            N_data = X.shape[0] if X is not None else (
                0 if self.X is None else self.X.shape[0]
            )
            method = "cg" if N_data > options.get(
                "cg_threshold_n", 32768
            ) else "exact"
        if method not in ("exact", "cg"):
            raise ValueError(f"Unknown fit method {method!r}")
        outwarp_fun = options.get("outwarp_fun", None)
        if method == "cg" and (outwarp_fun or self.outwarp) is not None:
            # The JAX package's CG objective never warps y
            # (gpyreg_tpu/ops/iterative.py:435-444) while its predict
            # back-transforms (gpyreg_tpu/gp.py:2240-2259): the warp
            # hyperparameters get a zero gradient and the GP serves the
            # unwarped fit as if it were warped.
            raise ValueError(
                "Output warping is not supported by the matrix-free "
                "(method='cg') fit; use method='exact'."
            )
        sampling = s_N > 0 and sampler_name != "laplace"
        if sampling:
            # The JAX package validates the name after the MAP
            # (gpyreg_tpu/gp.py:1709-1717); here before any state changes.
            if sampler_name not in (
                "slicesample", "slicelite", "covsample", "eissample",
                "mala", "hmc",
            ):
                raise ValueError("Unknown sampler!")

        self.fit_timings = timings = Timings()

        with phase(timings, "design_s"):
            LB, UB, PLB, PUB, hyp0 = self._fit_setup(
                X, y, s2, hyp0, options, outwarp_fun, df_base, lower_bounds,
                upper_bounds)
            cov_N, noise_N, _ = self._hyp_counts()

        if method == "cg":
            from .inference import cg_fit as _cg_fit

            return _cg_fit.fit_cg_path(
                self, hyp0, LB, UB, PLB, PUB, options, tol_opt, s_N
            )
        self._infer_method = "exact"

        # --- slicelite warm-refit shortcut (gplite_train.m:178-197) ---
        # When the previous hyperposterior samples still cover the new
        # posterior well, skip the design and MAP and refresh each
        # previous sample with a few no-adapt slice sweeps.
        # The set-up and the check count as the refit's optimize_s, or
        # toward design_s when the full fit follows.
        if sampler_name == "slicelite" and s_N > 0:
            with phase(timings, "optimize_s"):
                warm = _sampling.slicelite_ess(self, hyp0, options, thin)
            if warm is None:
                timings["design_s"] += timings.pop("optimize_s")
            else:
                timings.update(design_s=0.0, optimize_s=timings["design_s"]
                               + timings["optimize_s"])
                self.fit_report = {"restarts": [], "design_best": None}
                return _sampling.slicelite_warm_refit(
                    self, warm, s_N, LB, UB, PLB, PUB, widths, options,
                )

        tol = tol_opt_mcmc if sampling else tol_opt

        ## Space-filling design + multistart MAP (inference/fit_phases).
        (
            hyp, nll, opt_results, opts_N, widths_default, X0, y0,
        ) = _fit_phases.design_and_map(
            self,
            hyp0,
            LB,
            UB,
            PLB,
            PUB,
            options,
            opts_N,
            init_N,
            init_method,
            tol,
            cov_N,
            noise_N,
        )

        self.fit_report = {
            "restarts": list(opt_results),
            "design_best": None if y0 is None else float(y0[0]),
        }

        if opts_N > 0:
            optimize_result = opt_results[np.argmin(nll)]
            hyp_start = hyp[np.argmin(nll), :].copy()
            f_start = float(np.min(nll))
        else:
            optimize_result = None
            hyp_start = hyp[0, :].copy()
            f_start = None

        if not sampling:
            hyp_start = np.reshape(hyp_start, (1, -1))
            with phase(timings, "posterior_s"):
                self.update(hyp=hyp_start)
            return hyp_start, optimize_result, None

        ## Sampling of the hyperposterior (inference/sampling.py).
        if widths is None:
            widths = widths_default
        else:
            widths = np.minimum(widths, widths_default)
        with phase(timings, "sample_s"):
            sampling_result, thin = _sampling.run_sampling(
                self,
                sampler_name=sampler_name,
                options=options,
                s_N=s_N,
                thin=thin,
                burn_in=burn_in,
                widths=widths,
                hyp_start=hyp_start,
                f_start=f_start,
                # Candidate pool for the non-finite-start fallback: the
                # fused path's sorted design with its values.
                cand=X0 if X0 is not None else hyp,
                cand_vals=y0 if X0 is not None else None,
                LB=LB,
                UB=UB,
            )
        hyp = sampling_result["samples"][thin - 1 :: thin, :]
        with phase(timings, "posterior_s"):
            _sampling.store_warm_state(self, hyp, sampling_result, thin,
                                       widths)
            self.update(hyp=hyp)
        return hyp, optimize_result, sampling_result

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
            with span("gpyreg.sync.log_likelihood"):
                return -float(v), -g.cpu().numpy()
        v = fns["nlz"](hyp, *args)
        with span("gpyreg.sync.log_likelihood"):
            return -float(v)

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
            with span("gpyreg.sync.log_prior"):
                return float(v), g.cpu().numpy()
        v = log_prior(pack, h)
        with span("gpyreg.sync.log_prior"):
            return float(v)

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------

    def _predict_chunk(self, N, M):
        return int(max(1, min(M, _PREDICT_CHUNK_ELEMS // max(1, N))))

    def _matrix_free(self):
        return self.posteriors is not None and any(
            p.matrix_free for p in self.posteriors)

    def _group_predict(self, x_star):
        """Per-sample predictive mean and variance, (M, s_N) each, with
        one device-to-host copy at the end; matrix-free posteriors go
        through :meth:`_cg_serve`, and with a mesh each sample's test
        points are sharded over it (``serving.predict_sharded``).  Under
        output warping these are the moments in the warped space."""
        if self._matrix_free():
            return self._cg_serve(x_star)
        spec = self._spec()
        S = self.posteriors.size
        with span("gpyreg.sync.points"):
            xs = self._tensor(x_star)
        M = xs.shape[0]
        out = torch.empty((2, S, M), dtype=self._tdtype, device=self.device)
        with torch.no_grad():
            if self.y is None:
                for s, p in enumerate(self.posteriors):
                    out[0, s], out[1, s] = prior_branch(spec, p.hyp, xs)
            else:
                X, _, _ = self._data()
                # A shard's points, with a mesh.
                M_dev = M if self.mesh is None else -(-M // self.mesh.size)
                chunk = self._predict_chunk(X.shape[0], M_dev)
                for s, p in enumerate(self.posteriors):
                    args = (spec, bool(p.L_chol), p.hyp, p.alpha, p.L, p.sW,
                            X, None, xs, chunk)
                    with span("gpyreg.predict.sample"):
                        out[0, s], out[1, s] = (
                            predict_chunked(*args) if self.mesh is None
                            else predict_sharded(*args, self.mesh))
        with span("gpyreg.sync.predict"):
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
        (reference gaussian_process.py:1793-1811).

        Under output warping (``gpyreg_tpu/gp.py:2205-2275``) each
        sample's latent mean is inverse-warped and its variances divided
        by the squared warp slope there (gplite_pred.m:113-130; with
        ``add_noise`` the mean stays in the warped space, as in the
        oracle), and ``return_lpd`` is the density of the original
        observation by change of variables, the mixture's exact
        log-mean-density."""
        with span("gpyreg.predict"):
            x_star, y_star, s2_star = self._convert_shapes(
                x_star, y_star, s2_star
            )
            if return_lpd and y_star is None:
                raise ValueError(
                    "Cannot calculate log predictive density without y_star."
                )
            mu, s2 = self._group_predict(x_star)
            with span("gpyreg.predict.mixture"):
                return self._predict_mixture(
                    mu, s2, x_star, y_star, s2_star, add_noise,
                    separate_samples, return_lpd)

    def _predict_mixture(self, mu, s2, x_star, y_star, s2_star, add_noise,
                         separate_samples, return_lpd):
        """:meth:`predict` on the host after the pull: the per-sample
        moments (M, s_N) clamped, noised, inverse-warped and, unless
        ``separate_samples``, reduced to the mixture."""
        s_N = self.posteriors.size
        cov_N, noise_N, _ = self._hyp_counts()
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
        ow_N = self._outwarp_N()
        if return_lpd and self.outwarp is not None:
            lpd_s = np.zeros((x_star.shape[0], s_N))
            for s, p in enumerate(self.posteriors):
                yw, dw = self.outwarp.compute(
                    p.hyp[-ow_N:], y_star, compute_grad=True
                )
                v = y_s2[:, s : s + 1]
                lpd_s[:, s : s + 1] = (
                    -0.5 * (yw - mu[:, s : s + 1]) ** 2 / v
                    - 0.5 * np.log(2 * np.pi * v)
                    + np.log(np.abs(dw))
                )
            if separate_samples:
                lpd = lpd_s
            else:
                lpd = np.reshape(
                    sp.special.logsumexp(lpd_s, axis=1) - np.log(s_N), (-1, 1)
                )
        elif return_lpd and separate_samples:
            lpd = -0.5 * (y_star - mu) ** 2 / y_s2 - 0.5 * np.log(
                2 * np.pi * y_s2
            )

        if self.outwarp is not None:
            for s, p in enumerate(self.posteriors):
                hyp_ow = p.hyp[-ow_N:]
                fmu = self.outwarp.compute(hyp_ow, mu[:, s : s + 1],
                                           inverse=True)
                _, dwarp = self.outwarp.compute(hyp_ow, fmu, compute_grad=True)
                s2[:, s : s + 1] = s2[:, s : s + 1] / dwarp**2
                if add_noise:
                    y_s2[:, s : s + 1] = y_s2[:, s : s + 1] / dwarp**2
                else:
                    mu[:, s : s + 1] = fmu

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
            if return_lpd and self.outwarp is not None:
                pass  # already the mixture's exact density (above)
            elif return_lpd and add_noise:
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

    def _group_predict_full(self, x_star):
        """Per-sample predictive mean (M, s_N) and full covariance
        (s_N, M, M), with one device-to-host copy of each at the end."""
        spec = self._spec()
        S = self.posteriors.size
        xs = self._tensor(x_star)
        M = xs.shape[0]
        mu = torch.empty((S, M), dtype=self._tdtype, device=self.device)
        cov = torch.empty((S, M, M), dtype=self._tdtype, device=self.device)
        with torch.no_grad():
            if self.y is None:
                for s, p in enumerate(self.posteriors):
                    mu[s], cov[s] = prior_branch_full(spec, p.hyp, xs)
            else:
                X, _, _ = self._data()
                for s, p in enumerate(self.posteriors):
                    branch = chol_branch_full if p.L_chol else inv_branch_full
                    mu[s], cov[s] = branch(
                        spec, p.hyp, p.alpha, p.L, p.sW, X, None, xs
                    )
        return (mu.cpu().numpy().astype(np.float64).T.copy(),
                cov.cpu().numpy().astype(np.float64))

    def predict_full(
        self,
        x_star: np.ndarray,
        y_star: np.ndarray = None,
        s2_star: np.ndarray = None,
        add_noise: bool = False,
    ):
        """Posterior mean and full covariance per hyperparameter sample:
        mu (M, s_N), cov (M, M, s_N) (``gpyreg_tpu/gp.py:2120-2162``).
        The observation noise of ``add_noise`` goes on the diagonal only,
        the JAX package's correction of the reference, which spreads a
        heteroskedastic (M, 1) noise over every column
        (gaussian_process.py:1659)."""
        if self.outwarp is not None:
            raise ValueError(
                "Full-covariance prediction is unsupported with output "
                "warping."
            )
        if self._matrix_free():
            raise ValueError(
                "Full-covariance prediction is unsupported with "
                "matrix-free (method='cg') posteriors."
            )
        x_star, y_star, s2_star = self._convert_shapes(
            x_star, y_star, s2_star
        )
        cov_N, noise_N, _ = self._hyp_counts()
        N_star = x_star.shape[0]

        mu, cov = self._group_predict_full(x_star)

        if add_noise:
            for s, p in enumerate(self.posteriors):
                sn2_mult = 1 if p.sn2_mult is None else p.sn2_mult
                sn2_star = self.noise.compute(
                    p.hyp[cov_N : cov_N + noise_N], x_star, y_star, s2_star
                )
                sn2_diag = np.broadcast_to(np.ravel(sn2_star), (N_star,))
                cov[s, :, :] += np.diag(sn2_diag * sn2_mult)

        return mu, cov.transpose(1, 2, 0)

    # ------------------------------------------------------------------
    # Bayesian quadrature
    # ------------------------------------------------------------------

    def quad(
        self,
        mu,
        sigma,
        compute_var: bool = False,
        separate_samples: bool = False,
    ):
        """Closed-form integral of the GP against Gaussian measures
        N(mu, sigma^2), squared exponential kernel only
        (``gpyreg_tpu/gp.py:2295-2449``, reference gaussian_process.py:
        1818-1981), with zero, constant or negative-quadratic means.
        ``mu`` is (M, D) or one value, ``sigma`` (M, D), (1, D) or one
        value.  Each sample integrates on the GP's device in its own
        parametrization (``serving.quad_moments``), with a mesh its
        measures sharded over it (``serving.quad_sharded``).

        Returns F (M, 1), or (M, s_N) with ``separate_samples``, and with
        ``compute_var`` also its variance, the mixture's across samples
        unless ``separate_samples``."""
        if not isinstance(self.covariance, _cov_mod.SquaredExponential):
            raise ValueError(
                "Bayesian quadrature only supports the squared exponential "
                "kernel."
            )
        if self.outwarp is not None:
            raise ValueError(
                "Bayesian quadrature is unsupported with output warping."
            )
        self._require_factors("Bayesian quadrature")
        if not isinstance(
            self.mean,
            (
                _mean_mod.ZeroMean,
                _mean_mod.ConstantMean,
                _mean_mod.NegativeQuadratic,
            ),
        ):
            raise ValueError(
                "Bayesian quadrature supports zero, constant, and "
                "negative-quadratic mean functions only."
            )

        D = self.D
        N_s = np.size(self.posteriors)
        if np.size(mu) == 1:
            mu = np.tile(mu, (1, D))
        mu = np.atleast_2d(np.asarray(mu, dtype=np.float64))
        N_star = mu.shape[0]
        if np.size(sigma) == 1:
            sigma = np.tile(sigma, (1, D))
        sigma = np.atleast_2d(np.asarray(sigma, dtype=np.float64))

        spec = self._spec()
        X, _, _ = self._data()
        mu_t, sigma_t = self._tensor(mu), self._tensor(sigma)
        # The measures go in chunks whose (chunk, N, D) difference
        # temporary stays within the predictive chunk's budget.
        chunk = int(max(1, _PREDICT_CHUNK_ELEMS // max(1, X.shape[0] * D)))
        out = torch.empty((2 if compute_var else 1, N_s, N_star),
                          dtype=self._tdtype, device=self.device)
        with torch.no_grad():
            for s, p in enumerate(self.posteriors):
                args = (spec, bool(p.L_chol), p.hyp, p.alpha, p.L, p.sn2_mult,
                        X, mu_t, sigma_t, chunk, compute_var)
                F_s, J_s = (quad_moments(*args) if self.mesh is None
                            else quad_sharded(*args, self.mesh))
                out[0, s] = F_s
                if compute_var:
                    out[1, s] = J_s
        packed = out.cpu().numpy().astype(np.float64)
        F = packed[0].T.copy()
        if compute_var:
            F_var = packed[1].T.copy()

        if N_s > 1 and not separate_samples:
            F_bar = np.reshape(np.sum(F, 1), (-1, 1)) / N_s
            if compute_var:
                Fss_var = np.sum((F - F_bar) ** 2, 1) / (N_s - 1)
                F_var = np.reshape(np.sum(F_var, 1) / N_s + Fss_var, (-1, 1))
            F = F_bar

        if compute_var:
            return F, F_var
        return F

    # ------------------------------------------------------------------
    # Random function draws
    # ------------------------------------------------------------------

    def random_function(self, X_star: np.ndarray, add_noise: bool = False):
        """Draw one random function from the GP at ``X_star`` (N_star, D)
        (``gpyreg_tpu/gp.py:2451-2510``, reference gaussian_process.py:
        2241-2329): one posterior sample chosen uniformly, the predictive
        covariance factored by ``ops.linalg.robust_cholesky``.  The
        randomness is numpy's global stream, in the JAX package's order:
        ``np.random.randint`` for the sample, then
        ``np.random.standard_normal((N_star, 1))``, then with
        ``add_noise`` the noise's normal draw.  Returns (N_star, 1) in the
        GP's dtype, float64 with ``add_noise``."""
        N_star = X_star.shape[0]
        N_s = np.size(self.posteriors)
        cov_N, noise_N, _ = self._hyp_counts()
        if self.y is not None:
            self._require_factors("random_function")

        s = np.random.randint(0, N_s)
        p = self.posteriors[s]
        hyp = p.hyp
        zr = np.random.standard_normal((N_star, 1)).astype(self.dtype)

        spec = self._spec()
        xs, z = self._tensor(X_star), self._tensor(zr)
        with torch.no_grad():
            if self.y is None:
                f = random_prior_draw(spec, hyp, xs, z)
            else:
                X, _, _ = self._data()
                f = random_draw(spec, bool(p.L_chol), hyp, p.alpha, p.L,
                                p.sW, X, xs, z)
        f_star = f.cpu().numpy()

        if add_noise:
            sn2 = self.noise.compute(
                hyp[cov_N : cov_N + noise_N], X_star, None, None
            )
            sn2_mult = 1 if p.sn2_mult is None else p.sn2_mult
            return f_star + np.sqrt(
                sn2 * sn2_mult
            ) * np.random.standard_normal(size=f_star.shape)
        return f_star

    def predict_quantile(
        self,
        q,
        x_star: np.ndarray,
        y_star: np.ndarray = None,
        s2_star: np.ndarray = None,
        observed: bool = True,
        nx: int = 10,
    ):
        """Quantiles of the mixture predictive distribution
        (``gpyreg_tpu/gp.py:2660-2734``, matlab/gplite/gplite_qpred.m:
        1-49): each sample's Gaussian predictive is discretized on an
        ``nx``-point norminv grid, and the quantiles ``q`` are taken over
        the pooled grid.  ``observed`` gives quantiles of the observations
        (with noise), else of the latent function.  Under output warping
        the grid is built in the warped space and inverse-warped once a
        sample (gplite_qpred.m:40-46, ``gpyreg_tpu/gp.py:2693-2731``).

        Returns (M, len(q)), or (M,) for a scalar ``q``."""
        x_star, y_star, s2_star = self._convert_shapes(
            x_star, y_star, s2_star
        )
        xx = sp.stats.norm.ppf(np.linspace(0.5 / nx, 1 - 0.5 / nx, nx))
        if self.outwarp is None:
            mu, s2 = self.predict(
                x_star, y_star, s2_star, add_noise=observed,
                separate_samples=True,
            )
        else:
            mu, s2 = self._group_predict(x_star)
            s2 = np.maximum(s2, 0)
            if observed:
                cov_N, noise_N, _ = self._hyp_counts()
                for s, p in enumerate(self.posteriors):
                    sn2_star = self.noise.compute(
                        p.hyp[cov_N : cov_N + noise_N], x_star, y_star,
                        s2_star,
                    )
                    mult = 1 if p.sn2_mult is None else p.sn2_mult
                    s2[:, s : s + 1] = s2[:, s : s + 1] + np.reshape(
                        sn2_star * mult * np.ones((x_star.shape[0], 1)),
                        (-1, 1),
                    )
        grid = mu[:, :, None] + np.sqrt(np.maximum(s2, 0))[:, :, None] * xx
        if self.outwarp is not None:
            ow_N = self._outwarp_N()
            for s, p in enumerate(self.posteriors):
                grid[:, s, :] = self.outwarp.compute(
                    p.hyp[-ow_N:], grid[:, s, :], inverse=True
                )
        grid = grid.reshape(x_star.shape[0], -1)
        out = np.quantile(grid, np.atleast_1d(q), axis=1).T
        return out[:, 0] if np.isscalar(q) else out

    # ------------------------------------------------------------------
    # Sampling the surrogate
    # ------------------------------------------------------------------

    def _require_factors(self, what: str):
        """Raise for operations that need explicit posterior factors: when
        the posteriors are matrix-free (``gpyreg_tpu/gp.py:1300-1310``),
        and when the factors are absent (after ``clean()`` or
        ``update(compute_posterior=False)``)."""
        if self._matrix_free():
            raise ValueError(
                f"{what} requires explicit posterior factors; the "
                'stored posteriors are matrix-free (fit method="cg"). '
                'Refit with the default method="exact" to use it.'
            )
        if self.posteriors is None or any(
            p.alpha is None for p in self.posteriors
        ):
            raise ValueError(
                f"{what} requires the posterior factors; rebuild them with "
                "update(compute_posterior=True)."
            )

    def _cg_serve(self, x_star):
        """Matrix-free predictive mean and variance per posterior sample,
        (M, s_N) each (``gpyreg_tpu/gp.py:1312-1343``).  Each posterior's
        padded CG weight vector is solved at its first predict and kept on
        it, on the device.  ``cg_report`` keeps each sample's solve record
        (iterations and relative residuals, ``ops.iterative.cg_predict``'s
        info without the weights); a solve that stopped at ``max_iter``
        warns, where the JAX package says nothing."""
        from .ops import iterative as _iterative

        spec = self._spec()
        M, S = x_star.shape[0], self.posteriors.size
        mu, s2 = np.zeros((M, S)), np.zeros((M, S))
        X, y, s2_obs = self._data()
        xs = self._tensor(x_star)
        max_iter = self._cg_options.get("max_iter", 1000)
        self.cg_report = []
        for idx, p in enumerate(self.posteriors):
            mu_s, var_s, info = _iterative.cg_predict(
                spec, self._tensor(p.hyp), X, y, s2_obs, xs,
                compute_var=True, alpha0=p._alpha, **self._cg_options,
            )
            if p._alpha is None:
                p._alpha, p.n_real = info["alpha"], X.shape[0]
            report = {k: v for k, v in info.items() if k != "alpha"}
            self.cg_report.append(report)
            if max(report.get("alpha_iters", 0),
                   report.get("var_iters", 0)) >= max_iter:
                warnings.warn(
                    f"CG for posterior {idx} stopped at max_iter={max_iter} "
                    f"before its tolerance: {report}", stacklevel=3)
            mu[:, idx] = mu_s.ravel()
            s2[:, idx] = var_s.ravel()
        return mu, s2

    def _mixture_mean_variance_fn(self, compute_var: bool = True,
                                  differentiable: bool = False):
        """(x (D,) -> (mu, s2)) mixture predictive over the current
        posteriors (``gpyreg_tpu/gp.py:2736-2783``), as 0-d tensors on the
        device; ``x`` is a tensor, cast to the GP's dtype and device.  Each
        call builds K(X, x) of every sample with the kernel tile (a float32
        GP on the card).  Without ``compute_var`` s2 is None and no
        triangular solve runs.  ``differentiable`` (the mean alone) builds
        K(X, x) with the plain composition instead
        (``ops.kernels.kernel_matrix_plain``), so that autograd
        differentiates mu in ``x``: the cross-covariance tile has no
        gradient."""
        if differentiable and compute_var:
            raise ValueError("differentiable serves the mean alone; pass "
                             "compute_var=False")
        self._require_factors("fmin/sample surrogate optimization")
        spec = self._spec()
        X, _, _ = self._data()
        posts = list(self.posteriors)
        s_N = len(posts)
        # Each sample's hyperparameters on the device once, not a copy a
        # density.
        hyps = [self._tensor(p.hyp) for p in posts]

        def mu_s2(x):
            xs = torch.reshape(x, (1, -1)).to(dtype=X.dtype, device=X.device)
            mus, s2s = [], []
            for p, h in zip(posts, hyps):
                if not compute_var:
                    mus.append(mean_branch(spec, h, p.alpha, X, None, xs,
                                           differentiable))
                    continue
                branch = chol_branch if p.L_chol else inv_branch
                m, v = branch(spec, h, p.alpha, p.L, p.sW, X, None, xs)
                mus.append(m)
                s2s.append(v)
            mu_all = torch.cat(mus)
            mu_bar = torch.mean(mu_all)
            if not compute_var:
                return mu_bar, None
            s2_all = torch.clamp(torch.cat(s2s), min=0.0)
            if s_N > 1:
                v = torch.sum((mu_all - mu_bar) ** 2) / (s_N - 1)
            else:
                v = 0.0
            return mu_bar, torch.mean(s2_all) + v

        return mu_s2

    def fmin(self, x0=None, max_flag: bool = False, n_starts: int = 3):
        """Global minimum (or maximum) of the GP's mixture posterior mean
        (``gpyreg_tpu/gp.py:2785-2826``, matlab/gplite/gplite_fmin.m:
        1-75): multistart bounded L-BFGS
        (``inference.map_optimize.multistart_map``) inside
        [min(X) - 10 diam, max(X) + 10 diam], from ``x0``, the best
        training point and random points of the better half of the data
        (``np.random.permutation``, as in the JAX package).  The
        objective differentiates the mean in the test point, so it builds
        K(X, x) with the plain composition, never the kernel tile.

        Returns (x (D,), fval)."""
        X, y = self.X, self.y
        diam = np.max(X, axis=0) - np.min(X, axis=0)
        LB = np.min(X, axis=0) - 10 * diam
        UB = np.max(X, axis=0) + 10 * diam

        order = np.argsort(y.ravel())
        if max_flag:
            order = order[::-1]
        starts = [] if x0 is None else [np.atleast_2d(x0)]
        starts.append(X[order[:1], :])
        rest = X[order[1:], :]
        n_hpd = int(np.ceil(rest.shape[0] * 0.5))
        need = max(n_starts, len(starts)) - len(starts)
        if need > 0 and n_hpd > 0:
            idx = np.random.permutation(n_hpd)[: min(need, n_hpd)]
            starts.append(rest[idx, :])
        starts = np.concatenate(starts, axis=0)

        mu_s2 = self._mixture_mean_variance_fn(compute_var=False,
                                               differentiable=True)
        sign = -1.0 if max_flag else 1.0

        def obj(x):
            return sign * mu_s2(x)[0]

        xs, fs, _ = _map_optimize.multistart_map(
            obj, starts, LB, UB, tol=1e-8, device=self.device
        )
        best = int(np.argmin(fs))
        return xs[best], float(fs[best] * sign)

    def sample(
        self,
        n_samples: int,
        x0=None,
        log_prior=None,
        beta: float = 0.0,
        var_thresh: float = np.inf,
        bounds=None,
        key=None,
    ):
        """Draw samples from the density exp(GP posterior mean) by slice
        sampling on the surrogate surface (``gpyreg_tpu/gp.py:2828-2890``;
        matlab/gplite/gplite_sample.m:1-119, slicesample branch).

        The target is the mixture predictive mean, optionally penalized by
        the predictive uncertainty (``beta`` * sqrt(s2) lower confidence
        and the VarThresh clamp of log_gpfun, gplite_sample.m:108-118); the
        variance is computed only when ``beta != 0`` or ``var_thresh`` is
        finite.  ``log_prior``, a function of x as a float64 CPU tensor
        (D,), is added to the target.  ``key`` is a stream
        (``inference.device_slice.make_stream``) or an integer seed; None
        draws the seed from numpy's global stream.  Each density is one
        mixture evaluation on the GP's device.

        Returns an (n_samples, D) array.
        """
        X, y = self.X, self.y
        widths = np.std(X, axis=0, ddof=0)
        if bounds is None:
            diam = np.max(X, axis=0) - np.min(X, axis=0)
            LB = np.min(X, axis=0) - 10 * diam
            UB = np.max(X, axis=0) + 10 * diam
        else:
            LB, UB = np.asarray(bounds[0]), np.asarray(bounds[1])

        if x0 is None:
            x0 = X[int(np.argmax(y.ravel())), :]
        x0 = np.minimum(np.maximum(np.ravel(x0), LB), UB)

        use_s2 = bool(np.isfinite(var_thresh) or beta != 0)
        mu_s2 = self._mixture_mean_variance_fn(compute_var=use_s2)

        def log_f(x):
            mu, s2 = mu_s2(x)
            if use_s2:
                mu = torch.where(s2 >= var_thresh, mu - (s2 - var_thresh), mu)
                mu = mu - beta * torch.sqrt(s2)
            mu = float(mu)
            if log_prior is not None:
                mu = mu + float(log_prior(x))
            return mu

        if key is None:
            key = int(np.random.randint(0, 2**31 - 1))
        with torch.no_grad():
            res, _ = _device_slice.sample(
                log_f,
                x0,
                key,
                widths=widths,
                LB=LB,
                UB=UB,
                n_samples=n_samples,
                burn=int(np.ceil(n_samples / 10)),
            )
        return res["samples"]

    # ------------------------------------------------------------------
    # Plotting
    # ------------------------------------------------------------------

    def _plot_line_inputs(self, dim, lo, hi, n, anchor):
        """Grid along one input dimension with the others held at the
        anchor point; returns (ticks (n,), points (n, D))."""
        ticks = np.linspace(lo, hi, n)
        if self.D == 1:
            return ticks, ticks[:, None]
        base = anchor if anchor is not None else np.zeros(self.D)
        pts = np.broadcast_to(base, (n, self.D)).copy()
        pts[:, dim] = ticks
        return ticks, pts

    def plot(
        self,
        x0: np.ndarray = None,
        lb: np.ndarray = None,
        ub: np.ndarray = None,
        delta_y: float = None,
        max_min_flag: bool = True,
    ):
        """D x D panel plot of the GP posterior (``gpyreg_tpu/gp.py:
        2896-3047``, the visual contract of reference gaussian_process.py:
        1985-2215): the diagonal shows 1-D predictive profiles (mean +/-
        1.96 SD) along each dimension through ``x0``; above the diagonal,
        predictive-mean contours for each input pair; below, predictive
        SD contours.  ``delta_y`` zooms each axis to the region where the
        mean stays within ``delta_y`` of its value at ``x0``.  Every
        prediction goes through :meth:`predict`.  matplotlib is imported
        here, not with the package."""
        import matplotlib.pyplot as plt

        D = self.D
        if lb is not None or ub is not None:
            delta_y = None

        # Default plot ranges: data box widened by the RMS-averaged
        # posterior lengthscale per dimension.
        ell2 = np.stack(
            [np.exp(2.0 * p.hyp[:D]) for p in self.posteriors], axis=0
        )
        reach = np.sqrt(np.mean(ell2, axis=0))
        if self.X is not None:
            lo = np.min(self.X, axis=0) - reach
            hi = np.max(self.X, axis=0) + reach
        else:
            lo, hi = -reach, reach
        if lb is not None:
            lo = np.asarray(lb, dtype=np.float64).copy()
        if ub is not None:
            hi = np.asarray(ub, dtype=np.float64).copy()

        if x0 is None and self.X is not None and self.y is not None:
            pick = np.argmax if max_min_flag else np.argmin
            x0 = self.X[pick(self.y.ravel())]

        fig, axes = plt.subplots(
            D,
            D,
            squeeze=False,
            gridspec_kw={"wspace": 0.28, "hspace": 0.28},
        )
        n_line = 1000
        n_grid = 100

        # Diagonal: 1-D profiles (with optional delta_y auto-zoom).
        for i in range(D):
            ax = axes[i][i]
            ticks, pts = self._plot_line_inputs(i, lo[i], hi[i], n_line, x0)
            fmu, fs2 = self.predict(pts, add_noise=False)
            if delta_y is not None and x0 is not None:
                mu0, _ = self.predict(np.atleast_2d(x0), add_noise=False)
                near = np.abs(fmu.ravel() - mu0.ravel()[0]) < delta_y
                step = ticks[1] - ticks[0]
                if near.any():
                    sel = np.nonzero(near)[0]
                    lo[i] = ticks[sel[0]] - 0.5 * step
                    hi[i] = ticks[sel[-1]] + 0.5 * step
                else:
                    lo[i] = x0[i] - 0.5 * step
                    hi[i] = x0[i] + 0.5 * step
                ticks, pts = self._plot_line_inputs(
                    i, lo[i], hi[i], n_line, x0
                )
                fmu, fs2 = self.predict(pts, add_noise=False)
            band = 1.96 * np.sqrt(fs2.ravel())
            ax.plot(ticks, fmu.ravel(), color="k", linewidth=1)
            for sign in (-1.0, 1.0):
                ax.plot(
                    ticks,
                    fmu.ravel() + sign * band,
                    color=(0.8, 0.8, 0.8),
                    linewidth=1,
                )
            ax.set_xlim(lo[i], hi[i])
            ax.spines["top"].set_visible(False)
            ax.spines["right"].set_visible(False)
            if x0 is not None:
                ax.axvline(x0[i], color="k", linewidth=1)
            if D == 1:
                ax.set_xlabel("x")
                ax.set_ylabel("y")
                if self.X is not None and self.y is not None:
                    ax.scatter(self.X, self.y, color="blue")

        # Off-diagonal pairs: mean contours above, SD contours below.
        for i in range(D):
            for j in range(i):
                gx = np.linspace(lo[j], hi[j], n_grid)
                gy = np.linspace(lo[i], hi[i], n_grid)
                GX, GY = np.meshgrid(gx, gy)
                base = x0 if x0 is not None else np.zeros(D)
                pts = np.broadcast_to(base, (n_grid * n_grid, D)).copy()
                pts[:, j] = GX.ravel()
                pts[:, i] = GY.ravel()
                fmu, fs2 = self.predict(pts, add_noise=False)

                panels = (
                    (axes[i][j], np.sqrt(fs2)),  # lower: SD
                    (axes[j][i], fmu),  # upper: mean
                )
                for k, (ax, field) in enumerate(panels):
                    Z = field.reshape(n_grid, n_grid)
                    if k == 0:
                        ax.contour(GX, GY, Z)
                        xlim, ylim = (lo[j], hi[j]), (lo[i], hi[i])
                        sx, sy, cx, cy = j, i, None, None
                        if x0 is not None:
                            cx, cy = x0[j], x0[i]
                    else:
                        ax.contour(GY.T, GX.T, Z.T)
                        xlim, ylim = (lo[i], hi[i]), (lo[j], hi[j])
                        sx, sy = i, j
                        cx = cy = None
                        if x0 is not None:
                            cx, cy = x0[i], x0[j]
                    ax.set_xlim(*xlim)
                    ax.set_ylim(*ylim)
                    ax.spines["top"].set_visible(False)
                    ax.spines["right"].set_visible(False)
                    if self.X is not None:
                        ax.scatter(
                            self.X[:, sx], self.X[:, sy], color="blue", s=10
                        )
                    if cx is not None:
                        ax.axvline(cx, color="k", linewidth=1)
                        ax.axhline(cy, color="k", linewidth=1)

        # Edge labels.
        if D > 1:
            for i in range(D):
                axes[i][0].set_ylabel(rf"$x_{i + 1}$")
                axes[D - 1][i].set_xlabel(rf"$x_{i + 1}$")

        plt.show()
        return fig

    # ------------------------------------------------------------------
    # Serialization
    # ------------------------------------------------------------------

    def save(self, path):
        """Serialize the GP to an ``.npz`` file with the keys of
        ``gpyreg_tpu.GP.save``: data, bounds, priors and hyperparameter
        samples; the O(N^2) factors are rebuilt on load.  A GP fitted with
        ``method="cg"`` also stores its CG serving options as
        ``meta_cg_<option>``, which the JAX package's ``load`` ignores (it
        serves a reloaded CG GP at ``cg_predict``'s defaults); the port's
        ``load`` restores them, so a reloaded GP predicts as the saved one
        did."""
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
            "outwarp_kind": "" if self.outwarp is None else self.outwarp._kind,
            "fast_predict": int(self.fast_predict),
            "infer_method": int(self._infer_method == "cg"),
        }
        if self._infer_method == "cg":
            meta.update({f"cg_{k}": v for k, v in self._cg_options.items()})
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
        bounds, prior table, normalization constants and output warp;
        posterior factors are recomputed.  A GP fitted with
        ``method="cg"`` gets matrix-free posteriors back whatever
        ``has_factors`` says: a rebuild never factorizes its N x N
        matrix (``gpyreg_tpu/gp.py:2634-2652``)."""
        from .convert import gp_from_arrays

        with np.load(path, allow_pickle=False) as z:
            meta = {
                k[len("meta_"):]: z[k] for k in z.files if k.startswith("meta_")
            }
            arrays = {k: z[k] if k in z else None for k in ("X", "y", "s2", "hyp")}
            has_factors = bool(z["has_factors"]) if "has_factors" in z else False
            bounds = (z["lower_bounds"], z["upper_bounds"])
            priors = {
                k[len("prior_"):]: z[k] for k in z.files if k.startswith("prior_")
            }
        cg = "infer_method" in meta and bool(int(meta["infer_method"]))
        return gp_from_arrays(
            meta, arrays["X"], arrays["y"], arrays["s2"], arrays["hyp"],
            device=device, compute_posterior=has_factors or cg,
            bounds=bounds, hyper_priors=priors,
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
