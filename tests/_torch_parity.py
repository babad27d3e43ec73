"""The tolerance rule the port's parity tests hold ``repro_torch`` to.

Inputs are made with numpy from a seed and go through both packages on the
CPU. Each test first asserts that no float64 score lies within ``GAP`` of
the threshold (so a last-bit difference between XLA's and PyTorch's
products cannot move a pair across ``t``). Then counts and match sets must
be exactly equal, values equal within ``VAL_TOL`` (f32 rounding of
differently ordered sums), and, where order is compared, the ids equal
position by position under (value desc, id asc).
"""

from __future__ import annotations

import numpy as np

GAP = 1e-5
VAL_TOL = 1e-6


def host(a) -> np.ndarray:
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def triple(m):
    """``(values, indices, counts)`` of a ``Matches`` from either package."""
    return host(m.values), host(m.indices), host(m.counts).reshape(-1)


def assert_clear_of_threshold(Q, C, t, *, exclude_self=False):
    """No float64 score of ``Q·Cᵀ`` within ``GAP`` of ``t``."""
    S = np.asarray(Q, np.float64) @ np.asarray(C, np.float64).T
    if exclude_self:
        np.fill_diagonal(S, np.inf)
    gap = float(np.abs(S - t).min())
    assert gap > GAP, f"a score lies {gap:.2e} from t={t}: pick another input"


def assert_key_order(m):
    """Each row: real entries first, by value desc then id asc."""
    v, i, _ = triple(m)
    real = i >= 0
    assert not (~real[:, :-1] & real[:, 1:]).any(), "empty slot before a real one"
    a, b = v[:, :-1], v[:, 1:]
    both = real[:, :-1] & real[:, 1:]
    ok = (a > b) | ((a == b) & (i[:, :-1] < i[:, 1:]))
    assert (ok | ~both).all(), "row not ordered by (value desc, id asc)"


def assert_same_matches(got, ref, *, order=True):
    gv, gi, gc = triple(got)
    rv, ri, rc = triple(ref)
    assert gv.shape == rv.shape and gi.shape == ri.shape
    np.testing.assert_array_equal(gc, rc)
    np.testing.assert_array_equal(np.sort(gi, axis=1), np.sort(ri, axis=1))
    np.testing.assert_allclose(np.sort(gv, axis=1), np.sort(rv, axis=1), atol=VAL_TOL)
    if order:
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gv, rv, atol=VAL_TOL)
    assert_key_order(got)
