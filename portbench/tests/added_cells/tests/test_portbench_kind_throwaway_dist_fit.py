"""The faults of the ``throwaway_dist_fit`` kind, which a copy of the
benchmark gains with that kind: with the timed path broken underneath,
a small run of each of its cells is not ``correct``."""

import pytest

from gpyreg_tpu_torch.parallel import dist_exact
from portbench import harness
from portbench.tests import tiny


def _shift_nlml(monkeypatch):
    """An answer altered where it is produced: every NLML 1% off."""
    orig = dist_exact.dist_exact_fit

    def broken(*args, **kwargs):
        post = orig(*args, **kwargs)
        post.nlml = post.nlml * 1.01
        return post

    monkeypatch.setattr(dist_exact, "dist_exact_fit", broken)


def _no_exchange(monkeypatch):
    """The exchange between cards left out: each sum over the shards
    takes the first shard's part alone."""
    monkeypatch.setattr(dist_exact, "psum", lambda parts, device:
                        parts[0].to(device))


FAULTS = [_shift_nlml, _no_exchange]
CASES = [(n, f) for n in tiny.CELLS
         if harness.Cell(tiny.ROOT, n).traffic["kind"] == "throwaway_dist_fit"
         for f in FAULTS]


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in CASES])
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, checks, _ = tiny.run(name)
    assert not result["correct"], checks
