"""The multibranch model against the JAX package (the helpers and the tiny model of
tests/test_torch_dual.py): the forward of both branches and the league decoder
under the "both" (parallel), "acoustic" (serial, with PAE adapters) and
"textual" collaboration schedules, within 1e-5 of each tensor's largest
magnitude; ``join_speech_and_text_loss`` and every gradient against
``jax.value_and_grad``; the beam generator raises as JAX's fails.
"""

import pytest

from tests.test_torch_dual import check_forward, check_join_loss
import tests.test_torch_env  # noqa: F401  (the port tests' CPU settings)


@pytest.mark.parametrize("case", ["multibranch", "multibranch_acoustic", "multibranch_textual"])
def test_forward_matches_jax(case):
    check_forward(case)


def test_join_loss_and_grads_match_jax():
    check_join_loss("multibranch")
