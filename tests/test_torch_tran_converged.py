"""The port's transient with ``nr="converged"`` against the JAX package.

The same decks, integrations and tolerances as ``test_torch_tran.py``
(which holds the reference Newton loop), with Newton iterated to
|dx| <= tol * (1 + |x|) in both packages. A file of its own so the test
runner can spread the two over workers.
"""

import pytest

from tests.test_torch_tran import DECKS, _close, _jax, _port


@pytest.mark.parametrize("deck", sorted(DECKS))
@pytest.mark.parametrize("integration", ["be", "trap", "gear2"])
def test_converged_newton_matches_jax(deck, integration):
    net, tol = DECKS[deck]
    want = _jax(net, integration=integration, nr="converged")
    got = _port(net, integration=integration, nr="converged")
    _close(got, want, *(tol or ()))
