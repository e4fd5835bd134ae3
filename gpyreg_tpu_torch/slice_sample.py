"""Host coordinate-wise slice sampler with bounds, adaptive widths and
convergence diagnostics.

A copy of the whole of ``gpyreg_tpu/slice_sample.py:1-526`` (numpy only):
``SliceSampler`` with ``width_base``, step-out, the Metropolis step and
the diagnostics, ``gelman_rubin`` and ``effective_n``.  Behavioral parity
with the reference sampler (reference slice_sample.py:119-836: same
constructor/options surface, result dict, exit flags, burn-in
width-adaptation rules and diagnostics thresholds).  This is the
``sampler_backend='host'`` path of ``GP.fit``, driving arbitrary Python
log densities through numpy's global stream, so the same
``np.random.seed`` gives this sampler and the JAX package's the same
chain.  The default path is :mod:`.inference.device_slice`, which shares
the diagnostics helpers below.
"""

import logging
import math

import numpy as np

_TRACE_FMT = " %7.0f     %8.0f    %12.6g    %26s"


class SliceSampler:
    """Coordinate-wise slice sampler (interface contract of reference
    slice_sample.py:9-117; see Neal 2003 for the algorithm).

    Parameters
    ----------
    log_f : callable
        Log target density (up to a constant); may return per-datapoint
        values, which are summed.
    x0 : ndarray, shape (D,)
        Starting point, inside the domain.
    widths : scalar or ndarray, optional
        Typical slice widths per dimension; adapted during burn-in.
    LB, UB : scalar or ndarray, optional
        Domain bounds; LB[i] == UB[i] pins dimension i.
    options : dict, optional
        step_out (False), display ('full'), log_prior (None),
        adaptive (True), diagnostics (True), metropolis_pdf /
        metropolis_rnd (None; both spellings 'metopolis_rnd' and
        'metropolis_rnd' are accepted — the former is the reference's
        option key, slice_sample.py:214).
    """

    def __init__(
        self,
        log_f,
        x0: np.ndarray,
        widths=None,
        LB=None,
        UB=None,
        options: dict = None,
    ):
        x0 = np.asarray(x0, dtype=np.float64)
        if x0.ndim > 1:
            raise ValueError(
                "The initial point x0 needs to be a scalar or a 1D array"
            )
        self.x0 = x0.ravel().copy()
        D = self.x0.size
        self.log_f = log_f

        def as_bound(v, fill):
            if v is None:
                return np.full(D, fill, dtype=np.float64)
            v = np.asarray(v, dtype=np.float64)
            return np.full(D, v.item()) if v.size == 1 else v.copy()

        self.LB = as_bound(LB, -np.inf)
        self.UB = as_bound(UB, np.inf)
        if self.LB.shape != self.x0.shape or self.UB.shape != self.x0.shape:
            raise ValueError(
                "LB and UB need to be None, scalars, or 1D arrays of "
                "the same size as X0."
            )
        if np.any(self.UB < self.LB):
            raise ValueError(
                "All upper bounds UB need to be equal or greater than "
                "lower bounds LB."
            )
        # One ulp outside the closed box: bracket endpoints may sit here
        # so boundary values remain proposable.
        self.LB_out = np.nextafter(self.LB, -np.inf)
        self.UB_out = np.nextafter(self.UB, np.inf)

        if widths is None:
            self.base_widths = None
            self.widths = (self.UB - self.LB) / 2
        else:
            if np.iscomplexobj(np.asarray(widths)):
                # Match the reference's validation message for non-real
                # widths (slice_sample.py:152-156).
                raise ValueError(
                    "The widths vector needs to be all positive real "
                    "numbers."
                )
            self.widths = as_bound(widths, np.nan)
            self.base_widths = self.widths.copy()
        self.widths = np.where(np.isinf(self.widths), 10.0, self.widths)
        self.widths = np.where(self.LB == self.UB, 1.0, self.widths)

        if not (
            np.all(np.isfinite(self.widths)) and np.all(self.widths > 0)
        ):
            raise ValueError(
                "The widths vector needs to be all positive real numbers."
            )
        if np.any(self.x0 < self.LB) or np.any(self.x0 > self.UB):
            raise ValueError(
                "The initial starting point X0 is outside the bounds."
            )

        opts = options or {}
        if not opts.get("width_base", True):
            # Drop the end-of-burn geometric width floor (reference
            # slice_sample.py:535-543): the 5*std rule alone sets the
            # post-burn widths.  See device_slice.sample(width_base=...)
            # for the measured large-N rationale.
            self.base_widths = None
        self.step_out = opts.get("step_out", False)
        self.display = opts.get("display", "full")
        self.adaptive = opts.get("adaptive", True)
        self.log_prior = opts.get("log_prior", None)
        self.diagnostics = opts.get("diagnostics", True)
        self.metropolis_pdf = opts.get("metropolis_pdf", None)
        self.metropolis_rnd = opts.get(
            "metropolis_rnd", opts.get("metopolis_rnd", None)
        )

        self.func_count = 0
        self.logger = logging.getLogger("SliceSampler")
        if not self.logger.handlers:
            self.logger.addHandler(logging.StreamHandler())
        level = {"off": logging.WARNING, "summary": logging.INFO}.get(
            self.display, logging.DEBUG
        )
        self.logger.setLevel(level)

    # ------------------------------------------------------------------
    # Density evaluation
    # ------------------------------------------------------------------

    def _density(self, x):
        """(log_Px, f_val, log_prior) at x, with the bound mask, prior
        screening and NaN -> -inf handling of reference
        slice_sample.py:649-683."""
        if np.any(x < self.LB) or np.any(x > self.UB):
            return -np.inf, None, None

        lp = 0
        if self.log_prior is not None:
            lp = self.log_prior(x)
            if np.isnan(lp):
                self.logger.warning(
                    "Prior density function returned NaN. "
                    "Trying to continue."
                )
                return -np.inf, None, lp
            if not np.isfinite(lp):
                return -np.inf, None, lp

        f_val = np.asarray(self.log_f(x))
        self.func_count += 1
        if np.any(np.isnan(f_val)):
            self.logger.warning(
                "Target density function returned NaN. Trying to continue."
            )
            return -np.inf, f_val, lp
        return np.sum(f_val) + lp, f_val, lp

    # ------------------------------------------------------------------
    # Per-coordinate slice kernel
    # ------------------------------------------------------------------

    def _sample_coordinate(self, dd, xx, log_Px):
        """Slice-sample coordinate ``dd`` of ``xx`` in place.

        Returns (log_Px, f_val, log_prior, n_shrink)."""
        width = self.widths[dd]
        here = xx[dd]

        # Slice level, then a randomly positioned bracket of one width,
        # clipped to just outside the bounds.
        log_level = log_Px + np.log(np.random.rand())
        offset = np.random.rand()
        left = max(here - offset * width, self.LB_out[dd])
        right = min(here + (1 - offset) * width, self.UB_out[dd])

        probe = xx  # evaluated in place through self._density

        if self.step_out:
            steps = 0
            for edge, sign in ((left, -1.0), (right, 1.0)):
                while True:
                    probe[dd] = edge
                    if self._density(probe)[0] <= log_level:
                        break
                    edge += sign * width
                    steps += 1
                if sign < 0:
                    left = edge
                else:
                    right = edge
            if steps >= 10:
                self.logger.debug(
                    _TRACE_FMT,
                    0,
                    self.func_count,
                    log_Px,
                    f"step-out dim {dd} ({steps} steps)",
                )

        # Shrinkage: propose uniformly in the bracket, pulling in the
        # rejected side, until a point clears the level.
        n_shrink = 0
        while True:
            n_shrink += 1
            proposal = left + np.random.rand() * (right - left)
            probe[dd] = proposal
            log_Px, f_val, lp = self._density(probe)
            if log_Px > log_level:
                break
            if proposal > here:
                right = proposal
            elif proposal < here:
                left = proposal
            else:
                self.logger.warning(
                    "WARNING: Shrunk to current position and still "
                    " not acceptable!"
                )
                break
        # probe is xx: the accepted proposal is already written back.
        return log_Px, f_val, lp, n_shrink

    def _adapt_width(self, dd, n_shrink):
        """In-burn-in width tuning (reference slice_sample.py:461-478):
        shrink-heavy coordinates tighten by 1.1x, shrink-free ones widen
        by 1.2x, within [spacing, UB - LB]."""
        span = self.UB[dd] - self.LB[dd]
        if n_shrink > 3:
            floor = np.spacing(span) if np.isfinite(span) else np.spacing(1)
            self.widths[dd] = max(self.widths[dd] / 1.1, abs(floor))
        elif n_shrink < 2:
            self.widths[dd] = min(self.widths[dd] * 1.2, span)

    def _metropolis_step(self, xx, log_Px, f_val, lp):
        """Independence-Metropolis move from the user proposal
        (reference slice_sample.py:685-699)."""
        candidate = self.metropolis_rnd()
        cand_logp, cand_f, cand_lp = self._density(candidate)
        ratio = np.exp(cand_logp - log_Px) * (
            self.metropolis_pdf(xx) / self.metropolis_pdf(candidate)
        )
        if np.random.rand() < ratio:
            return candidate, cand_logp, cand_f, cand_lp
        return xx, log_Px, f_val, lp

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------

    def sample(self, N: int, thin: int = 1, burn: int = None):
        """Draw N (thinned) samples, after ``burn`` burn-in sweeps.

        Returns the reference's result dict: samples, f_vals, exit_flag,
        log_priors, R, eff_N (reference slice_sample.py:232-602).
        Repeated calls continue the chain (burn defaults to 0 then).
        """
        xx = self.x0
        D = xx.size
        fresh = self.func_count == 0
        if burn is None:
            burn = round(N / 3) if fresh else 0
        if not np.isscalar(thin) or thin <= 0:
            raise ValueError(
                "The thinning factor option needs to be a positive integer."
            )
        if not np.isscalar(burn) or burn < 0:
            raise ValueError(
                "The burn-in samples option needs to be a non-negative "
                "integer."
            )
        if burn == 0 and fresh and self.adaptive and self.base_widths is None:
            self.logger.warning(
                "WIDTHS not specified and adaptation is ON, but burn-in is "
                "set to 0. Attempting to use default values for WIDTHS."
            )

        log_Px, f_val, lp = self._density(xx)
        if not np.isfinite(log_Px):
            raise ValueError(
                "The initial starting point X0 needs to evaluate to a "
                "real number (not Inf or NaN)."
            )

        n_sweeps = burn + N + (N - 1) * (thin - 1)
        samples = np.zeros((N, D))
        f_vals = np.zeros((N, np.size(f_val)))
        log_priors = np.zeros(N)
        burn_window = []  # second half of burn-in, for the 5*std rule
        use_metropolis = (
            self.metropolis_pdf is not None
            and self.metropolis_rnd is not None
        )

        self.logger.debug(
            " Iteration     f-count       log p(x)                   Action"
        )
        order = np.arange(D)
        free = self.LB != self.UB
        for sweep in range(n_sweeps):
            adapting = self.adaptive and sweep < burn
            if sweep == burn:
                self.logger.debug(
                    _TRACE_FMT,
                    1,
                    self.func_count,
                    log_Px,
                    "start recording",
                )

            if use_metropolis:
                xx, log_Px, f_val, lp = self._metropolis_step(
                    xx, log_Px, f_val, lp
                )

            np.random.shuffle(order)
            for dd in order:
                if not free[dd]:
                    continue
                log_Px, f_val, lp, n_shrink = self._sample_coordinate(
                    dd, xx, log_Px
                )
                if adapting:
                    self._adapt_width(dd, n_shrink)
                if n_shrink >= 10:
                    self.logger.debug(
                        _TRACE_FMT,
                        sweep - burn + 1,
                        self.func_count,
                        log_Px,
                        f"shrink dim {dd} ({n_shrink} steps)",
                    )

            if use_metropolis:
                xx, log_Px, f_val, lp = self._metropolis_step(
                    xx, log_Px, f_val, lp
                )

            # End-of-burn-in width re-estimate from the posterior spread
            # (reference slice_sample.py:513-543).
            if sweep >= burn / 2 and sweep < burn:
                burn_window.append(xx.copy())
                if sweep == burn - 1 and self.adaptive:
                    trail = np.stack(burn_window)
                    spread = np.fmin(
                        5.0 * trail.std(axis=0),
                        self.UB_out - self.LB_out,
                    )
                    if self.base_widths is not None:
                        spread = np.fmax(
                            spread, np.sqrt(spread * self.base_widths)
                        )
                    self.widths = np.where(
                        np.isfinite(spread) & (spread > 0),
                        spread,
                        self.widths,
                    )

            past_burn = sweep - burn
            recorded = past_burn >= 0 and past_burn % thin == 0
            if recorded:
                k = past_burn // thin
                samples[k] = xx
                f_vals[k] = f_val
                log_priors[k] = lp
            action = (
                "burn" if past_burn < 0 else "record" if recorded else "thin"
            )
            self.logger.debug(
                _TRACE_FMT, past_burn + 1, self.func_count, log_Px, action
            )

        self.x0 = xx  # chain state for continuation calls
        self.logger.info("\nSampling terminated: ")
        self.logger.info(
            " * %d samples obtained after a burn-in period of %d samples",
            N,
            burn,
        )
        tail = "for a total of %d function evaluations."
        if thin > 1:
            tail = f"   and keeping 1 sample every {thin}, " + tail
        else:
            tail = "   " + tail
        self.logger.info(tail, self.func_count)

        exit_flag, R, eff = 0, None, None
        if self.diagnostics:
            exit_flag, R, eff = self._diagnose(samples)

        return {
            "samples": samples,
            "exit_flag": exit_flag,
            "f_vals": f_vals,
            "log_priors": log_priors,
            "R": R,
            "eff_N": eff,
        }

    def _diagnose(self, samples: np.ndarray):
        """Split-chain R-hat and effective-N with the reference's
        thresholds and exit flags (slice_sample.py:604-647)."""
        N = samples.shape[0]
        half = math.floor(N / 2)
        split = np.stack([samples[:half], samples[half : 2 * half]])
        R = gelman_rubin(split)
        eff = effective_n(split)

        exit_flag = 0
        if np.any(R > 1.5):
            exit_flag = -3
            self.logger.info(
                " * Detected lack of convergence! (max R = %.2f >> 1, "
                "mean R = %.2f)",
                np.max(R),
                np.mean(R),
            )
        elif np.any(R > 1.1):
            exit_flag = -2
            self.logger.info(
                " * Detected probable lack of convergence! "
                "(max R = %.2f > 1, mean R = %.2f)",
                np.max(R),
                np.mean(R),
            )
        if np.any(eff < N / 10.0):
            self.logger.info(
                " * Low number of effective samples! (min eff_N = %.1f, "
                "mean eff_N = %.1f, requested N = %d)",
                np.min(eff),
                np.mean(eff),
                N,
            )
            if exit_flag == 0:
                exit_flag = -1
        if exit_flag == 0:
            exit_flag = 1
            self.logger.info(
                " * No violations of convergence have been detected "
                "(this does NOT guarantee convergence)"
            )
        if exit_flag in (-2, -3):
            self.logger.info(
                " * Try sampling for longer, by increasing N  or the "
                "thinning factor"
            )
        elif exit_flag == -1:
            self.logger.info(
                " * Try increasing thinning factor to obtain more "
                "uncorrelated samples"
            )
        return exit_flag, R, eff


# ----------------------------------------------------------------------
# Convergence diagnostics (shared with the device sampler)
# ----------------------------------------------------------------------


def gelman_rubin(chains, return_var=False):
    """Potential scale reduction factor.

    ``chains`` is (m, n) for one parameter or (m, n, k) for k parameters
    (vectorized over the trailing axis; semantics of reference
    slice_sample.py:701-773).  With ``return_var`` returns the pooled
    posterior-variance estimate instead of R-hat.
    """
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim < 2 or chains.shape[0] < 2:
        raise ValueError(
            "Gelman-Rubin diagnostic requires multiple chains of the "
            "same length."
        )
    m, n = chains.shape[:2]
    chain_means = chains.mean(axis=1)  # (m, ...)
    B_over_n = chain_means.var(axis=0, ddof=1)  # between-chain
    W = chains.var(axis=1, ddof=1).mean(axis=0)  # within-chain
    s2 = W * (n - 1) / n + B_over_n
    if return_var:
        return s2
    return np.sqrt(s2 / W)


def effective_n(chains):
    """Effective sample size from the initial-positive-sequence
    variogram autocorrelation estimate (semantics of reference
    slice_sample.py:775-836), vectorized per parameter."""
    chains = np.asarray(chains, dtype=np.float64)
    if chains.ndim < 2 or chains.shape[0] < 2:
        raise ValueError(
            "Calculation of effective sample size requires multiple "
            "chains of the same length."
        )
    if chains.ndim == 3:
        return np.array(
            [effective_n(chains[:, :, k]) for k in range(chains.shape[2])]
        )

    m, n = chains.shape
    s2 = gelman_rubin(chains, return_var=True)
    # Vectorized variogram per lag; truncate the autocorrelation sum at
    # the first odd lag whose consecutive pair turns negative (Geyer
    # initial-positive-sequence rule, as in the reference: the negative
    # pair itself is excluded from the sum).
    rho = np.ones(n)
    stop = n
    for t in range(1, n):
        diffs = chains[:, t:] - chains[:, :-t]
        gamma_t = np.sum(diffs**2) / (m * (n - t))
        rho[t] = 1.0 - gamma_t / (2.0 * s2)
        if t % 2 == 1 and rho[t - 1] + rho[t] < 0:
            stop = t + 1
            break
    return m * n / (-1 + 2 * rho[: stop - 2].sum())
