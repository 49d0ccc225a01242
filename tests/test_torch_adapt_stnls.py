"""The port's adaptation path end to end on the ``stnls`` loss
(``WrapDnlsLoss`` over ``DnlsLoss``'s non-local search), against the JAX
package's, on the CPU, held as ``tests/test_torch_adapt.py`` holds ``f2f``,
``f2f_plus`` and ``sup`` (its docstring says how): a file of its own, since
the JAX wrapper runs eagerly and compiles the search's scans anew each
window."""

import pytest

pytest.importorskip("torch")

from test_torch_adapt import clip, net, one_torch_thread, run_end_to_end  # noqa: E402,F401


@pytest.mark.parametrize("train_bn", [False, True])
def test_get_loss_fxn_end_to_end(net, clip, train_bn):
    run_end_to_end(net, clip, "stnls", train_bn)
