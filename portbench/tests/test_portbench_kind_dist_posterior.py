"""The faults of the ``dist_posterior`` kind: with the timed path broken
underneath, a small run of each of its cells (four shards on the CPU) is
not ``correct``."""

import pytest

from gpyreg_tpu_torch.parallel import dist_exact
from portbench import harness
from portbench.tests import tiny


def _wrap_fit(monkeypatch, change):
    orig = dist_exact.dist_exact_fit

    def broken(*args, **kwargs):
        return change(orig(*args, **kwargs))

    monkeypatch.setattr(dist_exact, "dist_exact_fit", broken)


def _stale_build(monkeypatch):
    """A build that returns the previous vector's posterior."""
    held = []

    def previous(post):
        held.append(post)
        del held[:-2]
        return held[0]

    _wrap_fit(monkeypatch, previous)


def _scaled_alpha(monkeypatch):
    """An answer altered where it is produced: every alpha 1% off."""
    def scaled(post):
        post.alphas = [a * 1.01 for a in post.alphas]
        return post

    _wrap_fit(monkeypatch, scaled)


def _shift_nlml(monkeypatch):
    """An answer altered where it is produced: every NLML 1% off."""
    def shifted(post):
        post.nlml = post.nlml * 1.01
        return post

    _wrap_fit(monkeypatch, shifted)


def _last_card_unfactored(monkeypatch):
    """The last card's rows left out of the factor: the panel loop runs
    over the other shards, the last slab keeps its rows of B."""
    orig = dist_exact._cholesky

    def broken(slabs, devices, b):
        return orig(slabs[:-1], devices[:-1], b) + [slabs[-1]]

    monkeypatch.setattr(dist_exact, "_cholesky", broken)


FAULTS = [_stale_build, _scaled_alpha, _shift_nlml, _last_card_unfactored]
CASES = [(n, f) for n in tiny.CELLS
         if harness.Cell(tiny.ROOT, n).traffic["kind"] == "dist_posterior"
         for f in FAULTS]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in CASES])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, checks, _ = tiny.run(name)
    assert not result["correct"], checks
