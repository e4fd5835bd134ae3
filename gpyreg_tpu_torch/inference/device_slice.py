"""Coordinate-wise and random-direction slice sampling of a density that
lives on the device, with the chain driven from the host.

Port of ``gpyreg_tpu/inference/device_slice.py``: ``SliceState``
(:42-48), ``_masked_log_f`` (:51-66), ``diagnose`` (:69-118), the
coordinate move with step-out, the shrink cap and the cap-exit contract
(``_dim_body_factory``, :121-262), the burn-in width rule, ``_sweep``
(:265-290), the random-direction move ``_rd_sweep`` (:293-398),
``_make_sweeps`` and ``_burn_half`` (:401-429), ``_run_chain``
(:615-703), ``sample`` (:1172-1426) and ``sample_chains`` (:1429-1591).

The JAX chain is one XLA program (a ``while_loop`` per shrinkage loop
inside a ``scan`` over sweeps).  Here the position, the widths and the
random stream stay on the host in float64, and each density is one call
of ``log_f`` whose value is pulled as a Python float: each proposal's
accept test needs it before the next proposal is drawn, and at the sizes
the GP samples (a Cholesky of N >= 4096 a density) a host round trip is
small against one density.  ``x`` is handed to ``log_f`` as a float64
CPU tensor; the GP's functions cast it to their own dtype and device.
A proposal outside ``[LB, UB]`` is -inf without a call of ``log_f``.

The random stream.  The JAX chain is a function of a random key; this
one is a function of a stream object whose methods follow the JAX key
tree (:meth:`TorchStream.permutation` at each sweep, then per coordinate
:meth:`TorchStream.coordinate` giving the level uniform floored at
``tiny``, the bracket position and one uniform per proposal; per
random-direction move :meth:`TorchStream.direction`; :meth:`split` for
chains).  The other chains of the port draw from the same stream object:
a MALA step's normal and acceptance uniform
(:meth:`TorchStream.langevin`), an HMC iteration's momentum, step jitter
and acceptance uniform (:meth:`TorchStream.hamiltonian`), and the
ensemble's fill, iterations and half moves (:meth:`TorchStream.fill`,
:meth:`TorchStream.ensemble_iteration`, :meth:`TorchStream.half_move`,
whose walker moves are those of a coordinate).  :func:`make_stream`
builds the default one from an integer seed; a test replaces it with a
replay of the JAX key tree, which makes the port's chains equal the JAX
package's proposal by proposal.

``n_evals`` counts every call of ``log_f`` (the initial density, each
step-out probe and each shrinkage proposal that lies in bounds): the
reference's ``funccount`` (reference slice_sample.py:157), which the
JAX package's comments cite (:788, :1422) while its segmented drivers
count shrinkage proposals only.  ``sample`` returns it in its result
dict and ``sample_chains`` per chain beside its samples, where the JAX
package passes it as a function attribute (:1564, :1590).

The end-of-burn 5*std rule is computed with rounded products.  Where
the window has no spread (one sweep, e.g. ``GP.sample`` with fewer than
21 samples, whose burn-in is 2) the estimate is exactly 0 and the old
width is kept, as the JAX code reads (:671-674); XLA fuses the variance
into a fused multiply-add whose rounding residue can be positive, and
then sets a width of about 1e-4 that all but freezes the coordinate
(``tests/test_torch_device_slice.py`` pins the difference).

Left out, with the JAX package's lines:

- for good, being TPU-only: ``_draw_perm``, ``_move_chunk`` and
  ``_run_chain_moveseg`` (:432-614), and the segmented drivers
  ``_chain_init`` ... ``_run_chains_segmented`` (:706-1169), which bound
  the device time of one dispatch under the TPU runtime's watchdog.
  ``sample`` and ``sample_chains`` accept ``seg_sweeps`` and
  ``seg_moves`` and ignore them: the host-driven chain has no dispatch to
  bound, and its law and stream are those of the monolithic chain.

``sample_chains``' ``mesh`` (:1442, :1457-1461, :1474-1484, :1515-1526;
``parallel/mesh.py``) pads the chain count to the mesh and splits the
stream into the padded count, as JAX splits its key, so a padded run
draws JAX's padded chains; chain b runs on shard b // ceil(B / shards)
with the density's arguments on that shard's device, and the padded
chains, which JAX drops, are not run.  The chains still run one after
the other.
"""

import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from ..slice_sample import effective_n, gelman_rubin

_logger = logging.getLogger("DeviceSliceSampler")

_TINY = float(np.finfo(np.float64).tiny)
_EPS = float(np.finfo(np.float64).eps)
# Safety cap of the step-out walk; -inf outside the bounds ends it first.
_MAX_STEP_OUT = 1024


class TorchStream:
    """The default random stream of a chain: draws from a CPU
    ``torch.Generator`` seeded by an integer.  The methods follow the
    JAX key tree of a chain (see the module docstring); a coordinate,
    direction, half-ensemble or walker move draws from the same
    generator, so this object is its own move stream."""

    def __init__(self, seed: int):
        self.gen = torch.Generator().manual_seed(int(seed))

    def _uniform(self):
        return float(torch.rand((), generator=self.gen, dtype=torch.float64))

    def permutation(self, D: int) -> np.ndarray:
        """A new sweep's scan order."""
        return torch.randperm(D, generator=self.gen).numpy()

    def coordinate(self):
        """The stream of one coordinate move (drawn for fixed dimensions
        too, which use none of it)."""
        return self

    def direction(self, D: int):
        """(standard normal direction (D,), the stream of the move)."""
        u = torch.randn((D,), generator=self.gen, dtype=torch.float64)
        return u.numpy(), self

    def level(self) -> float:
        """The slice level's uniform, floored at the smallest normal."""
        return max(self._uniform(), _TINY)

    def position(self) -> float:
        """Where the bracket lies around the current point."""
        return self._uniform()

    def proposal(self) -> float:
        return self._uniform()

    def split(self, B: int):
        """One independent stream per chain."""
        seeds = torch.randint(0, 2**62, (B,), generator=self.gen)
        return [TorchStream(int(s)) for s in seeds]

    def _normal(self, shape) -> np.ndarray:
        return torch.randn(shape, generator=self.gen, dtype=torch.float64).numpy()

    def langevin(self, D: int):
        """A MALA step's draws: (the proposal's standard normal (D,), the
        acceptance uniform floored at the smallest normal)."""
        return self._normal((D,)), self.level()

    def hamiltonian(self, D: int):
        """An HMC iteration's draws: (the momentum's standard normal (D,),
        the step jitter in [0.9, 1.1), the acceptance uniform floored at
        the smallest normal)."""
        return self._normal((D,)), 0.9 + 0.2 * self._uniform(), self.level()

    def fill(self, need: int, D: int) -> np.ndarray:
        """Standard normals (need, D) that jitter an ensemble's missing
        walkers (drawn for need = 0 too, which uses none of it)."""
        return self._normal((need, D))

    def ensemble_iteration(self):
        """The streams of an ensemble iteration's two half moves."""
        return self, self

    def half_move(self, n: int, H: int):
        """A half move of n walkers against H frozen ones: (first frozen
        walker (n,) in [0, H), offset to the second (n,) in [1, H), the
        move stream of each walker)."""
        i1 = torch.randint(0, H, (n,), generator=self.gen).numpy()
        off = torch.randint(1, H, (n,), generator=self.gen).numpy()
        return i1, off, [self] * n


def make_stream(seed: int):
    """The stream of a chain seeded by ``seed``: every chain of the port
    is built through this factory, where the JAX package builds a random
    key from the same integer."""
    return TorchStream(seed)


def _as_stream(key):
    return make_stream(int(key)) if isinstance(key, (int, np.integer)) else key


class SliceState(NamedTuple):
    """Chain state, resumable across sample() calls.  ``stream`` takes
    the place of the JAX package's ``key``; it is the chain's own stream
    object, advanced by the chain."""

    x: np.ndarray  # (D,) current position
    log_Px: float  # current log density
    widths: np.ndarray  # (D,) current slice widths
    stream: object


class _masked_log_f:
    """``log_f`` with the bound mask, the optional additive log prior and
    NaN -> -inf (reference slice_sample.py:649-683: out of bounds, a NaN
    target or a non-finite prior all give -inf): a function of a float64
    numpy ``x`` returning a float, which counts its calls of ``log_f`` in
    ``n_evals``."""

    def __init__(self, log_f, LB, UB, f_args=(), log_prior=None):
        self.log_f, self.LB, self.UB = log_f, LB, UB
        self.f_args, self.log_prior = f_args, log_prior
        self.n_evals = 0

    def __call__(self, x):
        if not np.all((x >= self.LB) & (x <= self.UB)):
            return -math.inf
        xt = torch.tensor(x, dtype=torch.float64)
        self.n_evals += 1
        v = float(self.log_f(xt, *self.f_args))
        if math.isnan(v):
            v = -math.inf
        if self.log_prior is not None:
            p = float(self.log_prior(xt))
            v = v + p if math.isfinite(p) else -math.inf
            if math.isnan(v):
                v = -math.inf
        return v


def diagnose(samples: np.ndarray):
    """Split-chain convergence diagnostics of a single chain.

    Host post-processing of the chain output, with the reference
    sampler's split-R-hat / effective-N semantics and exit flags
    (reference slice_sample.py:604-647): the chain is halved into two
    pseudo-chains; flags: 1 converged, -3 max R > 1.5, -2 max R > 1.1,
    -1 low effective N (< N/10), 0 unknown.  Returns
    ``(exit_flag, R (D,), eff_N (D,))``.
    """
    N = samples.shape[0]
    half = math.floor(N / 2)
    if half < 2:
        return 0, None, None
    split = np.array([samples[0:half, :], samples[half : 2 * half, :]])
    R = gelman_rubin(split)
    eff_N = effective_n(split)

    exit_flag = 0
    if np.any(R > 1.5):
        _logger.info(
            " * Detected lack of convergence! (max R = %.2f >> 1, "
            "mean R = %.2f)",
            np.max(R),
            np.mean(R),
        )
        exit_flag = -3
    elif np.any(R > 1.1):
        _logger.info(
            " * Detected probable lack of convergence! (max R = %.2f > 1"
            ", mean R = %.2f)",
            np.max(R),
            np.mean(R),
        )
        exit_flag = -2
    if np.any(eff_N < N / 10.0):
        _logger.info(
            " * Low number of effective samples! (min eff_N = %.1f, "
            "mean eff_N = %.1f, requested N = %d)",
            np.min(eff_N),
            np.mean(eff_N),
            N,
        )
        if exit_flag == 0:
            exit_flag = -1
    if exit_flag == 0:
        exit_flag = 1
    return exit_flag, R, eff_N


def _coordinate_move(logpdf, x, log_Px, dd, width, mv, LB_out, UB_out,
                     max_shrink, step_out):
    """Slice-sample coordinate ``dd`` of ``x`` in place (``do_dim`` of
    :121-217).  Returns (log density at the new x, proposals made)."""
    here = x[dd]
    log_uprime = log_Px + math.log(mv.level())
    rr = mv.position()
    x_l = max(here - rr * width, LB_out[dd])
    x_r = min(here + (1.0 - rr) * width, UB_out[dd])
    probe = x.copy()

    if step_out:
        # Stepping-out (reference slice_sample.py:408-417): widen each
        # side by `width` while the density there clears the level.
        for sign in (-1.0, 1.0):
            edge = x_l if sign < 0 else x_r
            steps = 0
            while True:
                probe[dd] = edge
                if not (logpdf(probe) > log_uprime and steps < _MAX_STEP_OUT):
                    break
                edge += sign * width
                steps += 1
            if sign < 0:
                x_l = edge
            else:
                x_r = edge

    xp, log_Pp = here, log_Px
    shrink, done = 0, False
    while not done and shrink < max_shrink:
        xp = mv.proposal() * (x_r - x_l) + x_l
        probe[dd] = xp
        log_Pp = logpdf(probe)
        accept = log_Pp > log_uprime
        # Shrink the side the rejected proposal fell on.
        if not accept and xp > here:
            x_r = xp
        if not accept and xp < here:
            x_l = xp
        shrink += 1
        done = accept or xp == here
    if not done:
        # Cap exit: the last proposal was rejected, so keep the current
        # point and its density (the reference's unbounded loop can only
        # exit accepted, slice_sample.py:437).
        xp, log_Pp = here, log_Px
    x[dd] = xp
    return log_Pp, shrink


def _adapt_width(w, shrink, delta):
    """In-burn-in width rule (reference slice_sample.py:461-478):
    shrink > 3 -> w / 1.1 down to an eps-scaled floor, shrink < 2 ->
    w * 1.2 up to the bound span ``delta``."""
    if shrink > 3:
        floor = _EPS * max(abs(delta), 1.0) if math.isfinite(delta) else _EPS
        return max(w / 1.1, floor)
    if shrink < 2:
        return min(w * 1.2, delta)
    return w


def _sweep(logpdf, LB, UB, LB_out, UB_out, fixed, max_shrink, adapt,
           step_out=False):
    """One full coordinate sweep in a random scan order.  Returns a
    function (x, log_Px, widths, stream) -> log_Px that moves ``x`` and,
    iff ``adapt``, tunes ``widths``, both in place."""
    D = LB.shape[0]

    def sweep(x, log_Px, widths, stream):
        for dd in stream.permutation(D):
            mv = stream.coordinate()
            if fixed[dd]:
                continue
            log_Px, shrink = _coordinate_move(
                logpdf, x, log_Px, dd, widths[dd], mv, LB_out, UB_out,
                max_shrink, step_out,
            )
            if adapt:
                widths[dd] = _adapt_width(widths[dd], shrink, UB[dd] - LB[dd])
        return log_Px

    return sweep


def _rd_sweep(logpdf, LB, UB, fixed, max_shrink):
    """One random-direction slice move (the MATLAB oracle's 'covsample'
    operator: gplite_train.m:392-407 runs eissample_lite with W=1
    walker, whose default transition is transSliceSampleRD,
    eissample_lite.m:938-980 -> slicesample1 :997-1230).

    Direction: ``u ~ N(0, I)`` normalized, scaled per dimension by the
    current widths (``wvec = u .* widths``).  Bracket: length 1 in wvec
    units placed uniformly around x, clipped to the bounds along the
    direction at both ends.  Shrinkage only; the collapse tolerance is
    exact equality.  Rejection at the shrink cap keeps the current point.
    Widths are never adapted inside the move.  Same contract as
    :func:`_sweep`.
    """
    D = LB.shape[0]

    def sweep(x, log_Px, widths, stream):
        u, mv = stream.direction(D)
        u = np.where(fixed, 0.0, u)
        nrm = np.sqrt(np.sum(u * u))
        u = u / (nrm if nrm > 0 else 1.0)
        wvec = u * widths

        log_uprime = log_Px + math.log(mv.level())

        # Bracket [x_l, x_l + wsize*wvec] with x at offset rr (in wvec
        # units); clip both ends to the bounds along the direction.
        rr = mv.position()
        wsize = 1.0
        x_l = x - rr * wvec
        x_r = x + (wsize - rr) * wvec
        absw = np.abs(wvec)
        moving = absw > 0
        safe = np.where(moving, absw, 1.0)

        def shift(end):
            viol = np.maximum(LB - end, 0.0) + np.maximum(end - UB, 0.0)
            return float(np.max(np.where(moving, viol / safe, 0.0), initial=0.0))

        shift_l, shift_r = shift(x_l), shift(x_r)
        x_l = x_l + wvec * shift_l
        # Exact arithmetic keeps 0 <= rr <= wsize (the bracket always
        # contains x, which is in bounds); clamp against float error.
        wsize = max(wsize - shift_l - shift_r, 0.0)
        rr = min(max(rr - shift_l, 0.0), wsize)

        x_fin, log_fin = x, log_Px
        shrink, done = 0, False
        while not done and shrink < max_shrink:
            rr2 = mv.proposal() * wsize
            xnew = x_l + rr2 * wvec
            log_Pnew = logpdf(xnew)
            accept = log_Pnew > log_uprime
            # Bracket collapsed onto the current point (oracle
            # eissample_lite.m:1210-1216 with tolr ~ 0).
            stuck = rr2 == rr or bool(np.all(xnew == x))
            if not (accept or stuck):
                if rr2 > rr:
                    wsize = rr2
                elif rr2 < rr:
                    wsize = wsize - rr2
                    x_l = xnew
                    rr = rr - rr2
            if accept:
                x_fin, log_fin = xnew, log_Pnew
            shrink += 1
            done = accept or stuck
        x[:] = x_fin
        return log_fin

    return sweep


def _make_sweeps(move, logpdf, LB, UB, LB_out, UB_out, fixed, max_shrink,
                 step_out):
    """(sweep_adapt, sweep_fixed) for a move kind: 'cw' (coordinate-wise,
    reference slice_sample.py) or 'rd' (random-direction, oracle
    covsample, which has no in-sweep width adaptation)."""
    if move == "rd":
        sweep = _rd_sweep(logpdf, LB, UB, fixed, max_shrink)
        return sweep, sweep
    return tuple(
        _sweep(logpdf, LB, UB, LB_out, UB_out, fixed, max_shrink,
               adapt=adapt, step_out=step_out)
        for adapt in (True, False)
    )


def _burn_half(move, burn):
    """First sweep index of the width-adaptation moment window: the RD
    move uses the full burn window (eissample_lite.m:512 std(warmup) with
    WarmUpStages=1), the CW sampler the second half (reference
    slice_sample.py:513-543)."""
    return 0 if move == "rd" else burn // 2


def _run_chain(log_f, state, LB, UB, LB_out, UB_out, base_widths, n_samples,
               thin, burn, adaptive, max_shrink, f_args=(), step_out=False,
               log_prior=None, move="cw"):
    """The whole chain: burn-in (with width adaptation), the end-of-burn
    5*std width rule, then ``n_samples`` kept sweeps ``thin`` apart.
    Returns (final state, init_log_Px, samples (n, D), full log densities
    (n,), log priors (n,), n_evals, n_sweeps), ``n_sweeps`` the sweeps run,
    burn-in included."""
    fixed = LB == UB
    logpdf = _masked_log_f(log_f, LB, UB, f_args, log_prior)
    x = np.array(state.x, dtype=np.float64)
    widths = np.array(state.widths, dtype=np.float64)
    stream = state.stream
    log_Px = logpdf(x)
    init_log_Px = log_Px

    sweep_adapt, sweep_fixed = _make_sweeps(
        move, logpdf, LB, UB, LB_out, UB_out, fixed, max_shrink, step_out
    )

    # --- burn-in phase (optional width adaptation) ---
    if burn > 0:
        half = _burn_half(move, burn)
        s_sum = np.zeros_like(x)
        s_sq = np.zeros_like(x)
        for i in range(burn):
            log_Px = (sweep_adapt if adaptive else sweep_fixed)(
                x, log_Px, widths, stream
            )
            if i >= half:
                s_sum = s_sum + x
                s_sq = s_sq + x**2
        if adaptive:
            # End-of-burn-in 5*std rule (reference slice_sample.py:513-543).
            n_st = burn - half
            var = np.maximum(s_sq / n_st - (s_sum / n_st) ** 2, 0.0)
            new_widths = np.minimum(5.0 * np.sqrt(var), UB_out - LB_out)
            if base_widths is not None:
                new_widths = np.maximum(
                    new_widths, np.sqrt(new_widths * base_widths)
                )
            # Keep old widths where the estimate degenerated to zero.
            widths = np.where(new_widths > 0, new_widths, widths)

    # --- sampling phase (no adaptation; detailed balance holds) ---
    eff_N = n_samples + (n_samples - 1) * (thin - 1)
    xs = np.empty((eff_N, x.size))
    log_Pxs = np.empty((eff_N,))
    for i in range(eff_N):
        log_Px = sweep_fixed(x, log_Px, widths, stream)
        xs[i] = x
        log_Pxs[i] = log_Px
    samples = xs[::thin][:n_samples]
    log_Ps = log_Pxs[::thin][:n_samples]
    if log_prior is not None:
        lp = np.array([float(log_prior(torch.tensor(s))) for s in samples])
    else:
        lp = np.zeros_like(log_Ps)
    state = SliceState(x=x, log_Px=log_Px, widths=widths, stream=stream)
    return state, init_log_Px, samples, log_Ps, lp, logpdf.n_evals, burn + eff_N


def _expand(v, default, D):
    if v is None:
        return np.full((D,), default, dtype=np.float64)
    return np.broadcast_to(np.asarray(v, dtype=np.float64).ravel(), (D,)).copy()


def _start_widths(widths, LB, UB, width_base):
    """(widths, base_widths) at the start of a chain: half the bound span
    unless given, 10 where that is infinite, 1 on fixed dimensions; the
    given widths are also the end-of-burn floor when ``width_base``."""
    D = LB.shape[0]
    base_widths = None
    if widths is None:
        w = (UB - LB) / 2.0
    else:
        w = _expand(widths, np.nan, D)
        if width_base:
            base_widths = w
    w = np.where(np.isinf(w), 10.0, w)
    w = np.where(LB == UB, 1.0, w)
    return w, base_widths


def sample(
    log_f,
    x0,
    key,
    widths=None,
    LB=None,
    UB=None,
    n_samples: int = 100,
    thin: int = 1,
    burn: int = None,
    adaptive: bool = True,
    max_shrink: int = 256,
    state: SliceState = None,
    f_args=(),
    step_out: bool = False,
    log_prior=None,
    diagnostics: bool = True,
    display: str = "off",
    seg_sweeps: int = None,
    seg_moves: int = None,
    move: str = "cw",
    width_base: bool = True,
):
    """Draw ``n_samples`` (thinned) samples from ``log_f``.

    Parameters mirror :class:`gpyreg_tpu_torch.slice_sample.SliceSampler`
    / ``sample`` (reference slice_sample.py:119-230, :232).  ``log_f`` is
    called as ``log_f(x, *f_args)`` with ``x`` a float64 CPU tensor (D,)
    and returns a scalar (a tensor on any device, or a float) log
    density; ``log_prior`` (if given) a function of the same ``x`` whose
    additive values are reported separately in ``log_priors`` (reference
    :219-230).  ``key`` is a stream (:func:`make_stream`) or an integer
    seed.  ``step_out`` enables the stepping-out bracket walk (reference
    :408-417).  With ``diagnostics`` (default True, like the reference
    sampler), the result carries split-R-hat / effective-N and the
    reference's exit flags {1, 0, -1, -2, -3}; ``display`` in {'off',
    'summary', 'full'} maps to WARNING/INFO/DEBUG on the
    'DeviceSliceSampler' logger.

    Returns ``(result_dict, final_state)``; pass ``state=final_state`` to
    continue the chain (its stream continues with it).  The result has
    ``samples``, ``f_vals`` (n, 1, the prior excluded), ``log_priors``,
    ``exit_flag``, ``R``, ``eff_N``, ``n_evals``, the count of calls of
    ``log_f`` (module docstring), and ``n_sweeps``, the sweeps run.

    ``move`` selects the transition operator: 'cw' (default) is the
    reference's coordinate-wise sweep; 'rd' is one random-direction
    slice move per sweep (the MATLAB oracle's 'covsample' sampler,
    :func:`_rd_sweep`), which does not support ``step_out``.

    ``width_base`` (default True, the reference's behavior): caller-
    supplied ``widths`` also act as the end-of-burn adaptation floor,
    ``max(5*std, sqrt(5*std * widths))`` (reference
    slice_sample.py:535-543).  ``width_base=False`` keeps the caller
    widths for the burn-in and lets the 5*std rule stand alone after it.

    ``seg_sweeps`` and ``seg_moves`` are accepted for the JAX package's
    signature and ignored (module docstring).
    """
    del seg_sweeps, seg_moves
    if move not in ("cw", "rd"):
        raise ValueError("move must be 'cw' or 'rd'.")
    if move == "rd" and step_out:
        raise ValueError(
            "step_out is not supported by the random-direction move."
        )
    if display == "full":
        _logger.setLevel(logging.DEBUG)
    elif display in ("summary", "on"):
        _logger.setLevel(logging.INFO)
    else:
        _logger.setLevel(logging.WARNING)
    x0 = np.asarray(x0, dtype=np.float64).ravel()
    D = x0.shape[0]
    LB = _expand(LB, -np.inf, D)
    UB = _expand(UB, np.inf, D)

    if np.any(x0 < LB) or np.any(x0 > UB):
        raise ValueError(
            "The initial starting point X0 is outside the bounds."
        )

    w, base_widths = _start_widths(widths, LB, UB, width_base)
    if np.any(w <= 0) or np.any(~np.isfinite(w)):
        raise ValueError(
            "The widths vector needs to be all positive real numbers."
        )

    if burn is None:
        burn = round(n_samples / 3) if state is None else 0
    if thin <= 0:
        raise ValueError(
            "The thinning factor option needs to be a positive integer."
        )
    if burn < 0:
        raise ValueError(
            "The burn-in samples option needs to be a non-negative integer."
        )

    if state is None:
        state = SliceState(x=x0, log_Px=0.0, widths=w, stream=_as_stream(key))

    LB_out = np.nextafter(LB, -np.inf)
    UB_out = np.nextafter(UB, np.inf)
    (state, init_log_Px, samples, log_Ps, log_priors, n_evals,
     n_sweeps) = _run_chain(
        log_f, state, LB, UB, LB_out, UB_out, base_widths, int(n_samples),
        int(thin), int(burn), bool(adaptive), int(max_shrink), f_args,
        bool(step_out), log_prior, str(move),
    )
    if not math.isfinite(init_log_Px):
        raise ValueError(
            "The initial starting point X0 needs to evaluate to a real "
            "number (not Inf or NaN)."
        )
    # The chain carries the full density; the reported values exclude
    # the prior (reference result contract).
    f_vals = (log_Ps - log_priors)[:, None]

    _logger.info("\nSampling terminated:")
    _logger.info(
        " * %d samples obtained after a burn-in period of %d samples",
        samples.shape[0],
        burn,
    )

    exit_flag, R, eff_N = 0, None, None
    if diagnostics:
        exit_flag, R, eff_N = diagnose(samples)
        if exit_flag in (-2, -3):
            _logger.info(
                " * Try sampling for longer, by increasing N or the "
                "thinning factor"
            )
        elif exit_flag == -1:
            _logger.info(
                " * Try increasing thinning factor to obtain more "
                "uncorrelated samples"
            )

    result = {
        "samples": samples,
        "f_vals": f_vals,
        "log_priors": log_priors,
        "exit_flag": exit_flag,
        "R": R,
        "eff_N": eff_N,
        "n_evals": int(n_evals),
        "n_sweeps": int(n_sweeps),
    }
    return result, state


def sample_chains(
    log_f,
    x0s,
    key,
    widths=None,
    LB=None,
    UB=None,
    n_samples: int = 100,
    thin: int = 1,
    burn: int = None,
    adaptive: bool = True,
    max_shrink: int = 256,
    f_args=(),
    mesh=None,
    seg_sweeps: int = None,
    move: str = "cw",
    width_base: bool = True,
):
    """Run B independent chains, one per row of ``x0s`` (B, D), one after
    the other, each on its own stream of ``key.split(B)`` (``key`` a
    stream or an integer seed), as the JAX package's vmapped chains each
    take one key of ``split(key, B)``.  With ``mesh`` (a
    ``parallel.mesh.Mesh``) B is padded to the mesh, the stream split
    into the padded count, and each chain runs with ``f_args`` on its
    shard's device (module docstring).

    Returns ``(samples (B, n, D), f_vals (B, n), n_evals (B,), n_sweeps
    (B,))``: the JAX package returns the first two and passes the
    per-chain density count as a function attribute.  ``f_vals`` are the chains' full log
    densities.  ``width_base=False`` drops the end-of-burn geometric
    width floor (see :func:`sample`); ``seg_sweeps`` is ignored (module
    docstring).
    """
    del seg_sweeps
    x0s = np.asarray(x0s, dtype=np.float64)
    B, D = x0s.shape
    LB = _expand(LB, -np.inf, D)
    UB = _expand(UB, np.inf, D)
    w, base_widths = _start_widths(widths, LB, UB, width_base)
    if burn is None:
        burn = round(n_samples / 3)
    LB_out = np.nextafter(LB, -np.inf)
    UB_out = np.nextafter(UB, np.inf)

    samples = np.empty((B, n_samples, D))
    f_vals = np.empty((B, n_samples))
    n_evals = np.empty((B,), dtype=np.int64)
    n_sweeps = np.empty((B,), dtype=np.int64)
    # Chain b runs on shard b // per with that shard's arguments.
    if mesh is None:
        per, shard_args = max(B, 1), [f_args]
    else:
        per, shard_args = -(-B // mesh.size), mesh.replicate(tuple(f_args))
    streams = _as_stream(key).split(per * len(shard_args) if B else 0)
    for b in range(B):
        state = SliceState(x=x0s[b], log_Px=0.0, widths=w, stream=streams[b])
        _, _, samples[b], f_vals[b], _, n_evals[b], n_sweeps[b] = _run_chain(
            log_f, state, LB, UB, LB_out, UB_out, base_widths,
            int(n_samples), int(thin), int(burn), bool(adaptive),
            int(max_shrink), shard_args[b // per], False, None, str(move),
        )
    return samples, f_vals, n_evals, n_sweeps
