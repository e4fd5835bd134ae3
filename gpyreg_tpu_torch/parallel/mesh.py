"""The device mesh and the batch-, test-point- and row-sharded paths.

Port of ``gpyreg_tpu/parallel/mesh.py``: ``make_mesh`` (:33-38),
``sharded_nlml_grad`` (:41-83), ``sharded_predict`` (:85-150),
``sharded_cg_weights`` (:151-262) and ``sharded_sample_chains``
(:265-312).

One process drives every shard.  The JAX package is single-controller:
``GP(..., mesh=8)`` runs in one Python process and ``shard_map`` runs each
device's body.  Here a :class:`Mesh` is an ordered tuple of
``torch.device``\\ s, and each shard's work is issued on its device's
current stream from the same Python loop: a tensor of shard ``i`` lives on
``mesh.devices[i]``, and a block moves with ``.to(device)``, a peer copy
on a host with several cards.  Shards may share a device: a mesh of 8
shards on the CPU is the counterpart of the JAX tests' 8 virtual host
devices, and 4 shards on one card run the sharded algorithms through the
real kernels where the host has one card.  ``torch.distributed`` is not
used: it needs one process a rank and a launcher, which changes the
public call, and NCCL refuses two ranks on one card.

JAX's collectives become copies, written once here: :func:`all_gather`
concatenates the shards on one device in shard order, :func:`psum` sums
them there in shard order.  Neither reads a value on the host.  Every
block that moves between two shards goes through :func:`move`, which
counts a copy between two distinct devices in ``PEER_COPIES`` (a peer
copy over NVLink on a host with several cards).  Work
that does not depend on the host (the CG matvec, the sharded predict and
quadrature, ``dist_exact``) is issued for every shard before anything is
pulled, so shards on distinct cards overlap; and since a copy between
devices runs on its source's stream, behind the work already issued
there, each path issues its copies before the work that follows them.  The host-driven loops (the
L-BFGS lanes of ``map_optimize.design_optimize``, the slice chains of
``device_slice.sample_chains``, the lanes here) run shard by shard, each
with its tensors on its shard's device.

Padding.  A count not divisible by the mesh size is padded as in JAX
(batch rows with repeats of the last, CG rows with an inert masked zero
subsystem) and the padding is dropped; where a padded entry's result is
dropped unread (a lane of :func:`sharded_nlml_grad`, a test point), it is
not computed at all.

Left out, being TPU-only: the ``lru_cache``\\ d jitted ``shard_map``
programs (:41-62, :85-126, :151-225) and their
``NamedSharding`` layouts; eager PyTorch compiles nothing.
"""

import numpy as np
import torch

from .._config import resolve_device
from ..core.model import ModelSpec, mean_value, noise_variance
from ..core.nlml import get_fns
from ..ops import iterative as _iterative


class Mesh:
    """An ordered tuple of devices, one a shard; shards may share a
    device.  The counterpart of the JAX package's 1-D device mesh over
    axis 'batch'."""

    def __init__(self, devices):
        devices = tuple(torch.device(d) for d in devices)
        if not devices:
            raise ValueError("A mesh needs at least one device")
        self.devices = devices

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"

    def slices(self, n):
        """Shard i's rows [start, stop) of n rows padded to the mesh:
        ceil(n / size) rows a shard, the last shards' rows past n left
        out (so a slice may be empty)."""
        per = -(-int(n) // self.size)
        return [(min(i * per, n), min((i + 1) * per, n))
                for i in range(self.size)]

    def replicate(self, obj, source=None):
        """``obj`` (a tensor, or a tuple, list or named tuple of them;
        anything else passes through) on each shard's device: one copy a
        distinct device, none where it already lies.  ``source`` is the
        device of the shard that holds ``obj`` (:func:`move`)."""
        copies = {}
        out = []
        for dev in self.devices:
            if dev not in copies:
                copies[dev] = _to(obj, dev, source)
            out.append(copies[dev])
        return out


def _to(obj, device, source=None):
    if isinstance(obj, torch.Tensor):
        return move(obj, device, source)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to(o, device, source) for o in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to(o, device, source) for o in obj)
    return obj


# Copies between two distinct devices of a mesh since the last
# reset_peer_copies(): how many, and their bytes.
PEER_COPIES = {"copies": 0, "bytes": 0}


def reset_peer_copies():
    for k in PEER_COPIES:
        PEER_COPIES[k] = 0


def move(t, device, source=None):
    """``t`` on ``device``.  ``source`` is the device of the shard that
    holds ``t``, ``t.device`` when None.  A copy between two distinct
    devices of one type, each with an index, is a peer copy: it adds one
    to ``PEER_COPIES["copies"]`` and its bytes to ``["bytes"]``, decided on
    the host from the devices alone, and is made from a contiguous block,
    so that on the cards it is one memcpy (PyTorch copies a strided block
    between cards by a kernel instead).  The host (``cpu``, no index) is
    no peer: a copy from it to a card is not counted.  A mesh's shards
    name their devices, so ``make_mesh(devices=[cpu:0, ..., cpu:3])``
    stands for four distinct devices on the CPU, where every tensor reads
    ``cpu``: there a copy is counted where its caller names the shard's
    device as ``source``."""
    device = torch.device(device)
    source = t.device if source is None else torch.device(source)
    if (source == device or source.type != device.type
            or source.index is None or device.index is None):
        return t.to(device)
    PEER_COPIES["copies"] += 1
    PEER_COPIES["bytes"] += t.numel() * t.element_size()
    return t.contiguous().to(device)


def make_mesh(n_devices: int = None, device=None, devices=None) -> Mesh:
    """A mesh over ``devices`` when given (repeats allowed); else over the
    first ``n_devices`` CUDA cards (every card when None; a request for
    more cards than exist gets the cards that exist, as JAX's
    ``devs[:n_devices]``); with ``device="cpu"``, ``n_devices`` shards on
    the CPU (one when None).  Without a card and without ``device="cpu"``
    it raises, as ``_config.resolve_device`` does."""
    if devices is not None:
        return Mesh(devices)
    if device is not None and torch.device(device).type == "cpu":
        return Mesh([torch.device("cpu")] * (1 if n_devices is None
                                             else int(n_devices)))
    resolve_device(device)
    count = torch.cuda.device_count()
    n = count if n_devices is None else min(int(n_devices), count)
    return Mesh([torch.device("cuda", i) for i in range(n)])


def all_gather(parts, device):
    """The shards' blocks concatenated on ``device`` in shard order
    (``lax.all_gather(..., tiled=True)``)."""
    return torch.cat([move(p, device) for p in parts])


def psum(parts, device):
    """The shards' partial results summed on ``device`` in shard order
    (``lax.psum``)."""
    total = move(parts[0], device)
    for p in parts[1:]:
        total = total + move(p, device)
    return total


def _tensor(a):
    return a if isinstance(a, torch.Tensor) else torch.tensor(np.asarray(a))


def _pad_rows(A, Np, fill=None):
    """``A`` padded to Np rows with repeats of its last row, or of
    ``fill``."""
    if A.shape[0] == Np:
        return A
    row = A[-1:] if fill is None else torch.full_like(A[-1:], fill)
    return torch.cat([A, row.expand(Np - A.shape[0], -1)])


def sharded_nlml_grad(spec: ModelSpec, mesh: Mesh, hyp_batch, X, y):
    """NLML and its gradient for a batch of hyperparameter vectors, the
    lanes sharded over the mesh: the batch is padded to the mesh with
    repeats of its last row, shard i evaluates its lanes with
    ``core.nlml.get_fns(...)["nlz_grad"]`` on its device (on a float32
    card, the kernel tile and the gradient tile for each lane), and the
    padding lanes, whose results JAX drops, are not evaluated.  ``X`` and
    ``y`` set the dtype.  Returns (values (B,), gradients (B, hyp_N)) on
    the first shard's device."""
    hyp_batch = np.atleast_2d(np.asarray(hyp_batch, dtype=np.float64))
    nlz_grad = get_fns(spec, False, False)["nlz_grad"]
    args = mesh.replicate((_tensor(X), _tensor(y)))
    vals, grads = [], []
    for (a, b), (Xd, yd) in zip(mesh.slices(hyp_batch.shape[0]), args):
        if a < b:
            v, g = nlz_grad(hyp_batch[a:b], Xd, yd)
            vals.append(v)
            grads.append(g)
    home = mesh.devices[0]
    return all_gather(vals, home), all_gather(grads, home)


def sharded_predict(spec: ModelSpec, mesh: Mesh, hyp, alpha, L_upper, sW, X,
                    xs, n_real=None):
    """Predictive mean and variance of one sample stored in the Cholesky
    parametrization (``L_upper``), the test points sharded over the mesh
    and the factors replicated (``serving.predict_sharded``); ``n_real``
    marks the real rows of padded factors (None: all).  Returns (mu, s2)
    (M,) on ``xs``' device."""
    from ..serving import predict_sharded

    xs = _tensor(xs)
    with torch.no_grad():
        return predict_sharded(spec, True, hyp, _tensor(alpha),
                               _tensor(L_upper), _tensor(sW), _tensor(X),
                               n_real, xs, xs.shape[0], mesh)


# Rows of a shard's panel K(X_rows, X) in the sharded CG matvec, the
# height of ``fit(method="auto")``'s panels (``cg_row_chunk``).
_ROW_CHUNK = 2048


class _RowOperator:
    """V -> mask * ((K + diag(sn2)) V) with the rows of K sharded: shard i
    holds its rows of X, sn2 and the mask, and a replica of X."""

    def __init__(self, spec, mesh, hyp_cov, Xp, sn2, mask):
        self.spec, self.mesh = spec, mesh
        self.slices = mesh.slices(Xp.shape[0])
        self.hyp_cov, self.X = zip(*mesh.replicate((hyp_cov, Xp)))
        self.rows = [(Xp[a:b].to(d), sn2[a:b, None].to(d), mask[a:b, None].to(d))
                     for d, (a, b) in zip(mesh.devices, self.slices)]

    def __call__(self, V):
        """Each shard builds its rows' panels K(X_rows, X) against V on
        its device, and the rows are gathered onto V's device.  Every copy
        of V is issued before any panel: a copy between devices runs on
        its source's stream, behind whatever that device was given
        before."""
        full = self.mesh.replicate(V)
        out = []
        for i, (V_full, (a, b)) in enumerate(zip(full, self.slices)):
            X_rows, sn2_rows, m_rows = self.rows[i]
            KV = _iterative._panel_matvec(self.spec, self.hyp_cov[i], X_rows,
                                          V_full, None, _ROW_CHUNK,
                                          Z=self.X[i])
            out.append(m_rows * (KV + sn2_rows * V_full[a:b]))
        return all_gather(out, V.device)


def sharded_cg_weights(spec: ModelSpec, mesh: Mesh, hyp, X, y, s2=None,
                       tol: float = 1e-6, max_iter: int = 500):
    """alpha = (K + sn2 I)^{-1} (y - m) by ``ops.iterative._cg`` with the
    training rows sharded over the mesh, K never materialized: each
    matvec, shard i builds its rows' panels (``_ROW_CHUNK`` rows at a
    time, ``ops.iterative._panel_matvec``: the kernel tile on a float32
    card) against the search direction.  N not divisible by the mesh size
    is padded with an inert masked zero subsystem (the rows repeat the
    last, y 0, s2 1, the right-hand side and every matvec masked to 0
    there).  ``X`` sets the dtype; the CG vectors live on the first
    shard's device.  Returns (alpha (N, nrhs) there, per-column relative
    residual, iterations)."""
    home = mesh.devices[0]
    X = _tensor(X).to(home)
    dtype = X.dtype
    y = _tensor(y).to(home, dtype)
    N = X.shape[0]
    Np = -(-N // mesh.size) * mesh.size
    X, y = _pad_rows(X, Np), _pad_rows(y, Np, 0.0)
    if s2 is not None:
        s2 = _pad_rows(_tensor(s2).to(home, dtype), Np, 1.0)
    h = torch.as_tensor(np.asarray(hyp, dtype=np.float64)).to(home, dtype)
    hyp_cov, hyp_noise, hyp_mean = spec.split_hyp(h)
    sn2 = torch.broadcast_to(
        torch.reshape(noise_variance(spec, hyp_noise, y, s2, dtype), (-1,)),
        (Np,))
    mask = (torch.arange(Np, device=home) < N).to(dtype)
    r = mask[:, None] * (y - mean_value(spec, hyp_mean, X)[:, None])
    op = _RowOperator(spec, mesh, hyp_cov, X, sn2, mask)
    with torch.no_grad():
        alpha, res, iters = _iterative._cg(op, r, float(tol), int(max_iter))
    return alpha[:N], res, iters


def sharded_sample_chains(spec: ModelSpec, mesh: Mesh, x0s, key, X, y,
                          widths=None, LB=None, UB=None, n_samples: int = 100,
                          thin: int = 1, burn: int = None):
    """Independent slice-sampling chains of the GP log marginal
    likelihood, one per row of ``x0s``, sharded over the mesh: shard i
    runs its chains with the data on its device
    (``device_slice.sample_chains(..., mesh=mesh)``, which pads the chain
    count to the mesh and splits ``key`` into the padded count).  Returns
    that function's (samples (B, n_samples, D), f_vals (B, n_samples),
    n_evals (B,), n_sweeps (B,))."""
    from ..inference import device_slice

    log_f = get_fns(spec, False, False)["log_post_raw"]
    return device_slice.sample_chains(
        log_f, np.asarray(x0s, dtype=np.float64), key, widths=widths, LB=LB,
        UB=UB, n_samples=n_samples, thin=thin, burn=burn,
        f_args=(_tensor(X), _tensor(y)), mesh=mesh,
    )
